#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

  python3 chip_smoke.py [--phases device,build,kernels,lm_kernels,dp_paper,ofl,bp_means,fig3,retrieval,serve,invariants,cluster,ha,lm_serve,train,moe,serve_clusters,curation,examples,hybrid,xlstm,frontends,dryrun,mesh,lm_mesh]

Run from the root of a checkout on a machine with a CUDA card.  It builds
the hand-written kernels from `src/repro_torch/kernels/csrc/` with nvcc
(one process per source, in parallel), holds each against its plain
PyTorch version on the card, runs the OCC DP-means pass of the paper's §4
experiment, OCC OFL online over the same data, OCC BP-means at the paper's
width, the paper's Figure 3 counts (held to the JAX package's, run for
run) and the repository's largest state (a 110k-center retrieval
index) through the port's public entry points, serves that index (flat
and multi-probe top-k, score) through the port's serving plane, checks
the port's bitwise invariants on the card, runs the paper's multi-process
OCC cluster (4 propose worker processes, followers, a worker death) and
its crash-recoverable variant (a master killed and a follower promoted,
the promoted master's WAL recovered) on the card against the fused
single-process pass, serves the language model qwen3-4b (prefill and
the slot engine's decode) at full width and depth, and trains granite-3-2b
at full width and 16 of its 40 layers (three AdamW steps of 4 x 4096
tokens through the rmsnorm and swiglu kernels' forward and backward), and
runs the Mixture-of-Experts model olmoe-1b-7b: its router and five
dispatch impls at full width, served at full width and depth (a 4 x 4096
prefill and the slot engine's decode, the swiglu kernel on every layer's
expert-grouped tensor) and trained at full width and 2 of its 16 layers,
and phi3.5-moe at full width and 2 layers.  Then the system's
remaining entry points: the train-while-serve pipeline (two tenants'
trainer threads, sixteen client threads behind a coalescing router, a QoS
A/B of priority lanes against FIFO, every response audited), OCC data
curation of 2,048 sequences embedded by granite-3-2b at full width and
depth, and each of the port's examples.  Then the recurrent families:
the hybrid zamba2-7b (Mamba2 blocks and a shared attention block, flash
at head dim 112) and xlstm-1.3b (mLSTM and sLSTM blocks), each at full
width in f32 against the plain versions, served at full width and depth
(a 4 x 4096 prefill and the slot engine's decode over recurrent state)
and trained at full width and cut depth.  Last, the frontend families:
internvl2-2b (a patch-embedding prefix before the tokens) and
seamless-m4t-medium (an encoder over audio frames, a decoder with
cross-attention), each at full width in f32 against the plain versions,
served at full width and depth (a 4 x 4096 prefill, decode steps from
its caches and the slot engine) and trained at full width.  Then the
roofline and the dry run (`repro_torch.roofline`, `launch/dryrun.py`)
against three cells the card runs: granite-3-2b's train step, qwen3-4b's
prefill and its decode_step, each planned on the meta device first; no
time may fall below its roofline bound, and the dry run's argument bytes
must equal the card's.  Last, the paper's path on a mesh: four ranks
(processes) share the one card under gloo, each proposing its quarter of
every epoch with the nearest-center kernel; DP-means, OFL and BP-means
on every rank equal the one-process run bit for bit, mesh serving equals
the meshless service (a k = 100 top-k query, the top-k kernel's wide
route, among its requests), the compressed psum runs on the card's
tensors, and a checkpoint of a (2, 2) mesh restores onto (1, 2).  Then
the language model's mesh: four ranks share the card on a (data 2,
model 2) mesh; qwen3-4b served at full width and depth (the slot engine in
decode modes "tp" and "cp", and a prefill through the flash kernel on each
rank's heads) and granite-3-2b's tensor- and data-parallel train step at
full width, the MoE family with its experts split over the model axis
(olmoe-1b-7b served at full depth and trained, phi3.5-moe prefilled and
trained, the swiglu kernels on each rank's experts), and the hybrid
family with zamba2-7b's Mamba2 heads and its shared attention block split
over the model axis (served at full depth, prefilled and trained at 12
layers, the flash kernel on 16 heads of 112 a rank), each held to one
process's run on the card.
`--phases serve` or `examples` alone trains the
retrieval index first; `--phases cluster`, `ha`, `serve_clusters`,
`curation`, `hybrid`, `xlstm`, `frontends`, `dryrun`, `mesh` or `lm_mesh`
alone builds the kernels first.

Every phase prints one JSON line.  The line before the last lists each
kernel with its launches on the main path, its error against the plain
version and its times; the last line is
`{"ok": true, "device": {...}}`.  Any failed check, build or launch exits
non-zero before that line.  Without a CUDA device, or run from a directory
without the repository's `src/`, it exits 1 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ALL_PHASES = ("device", "build", "kernels", "lm_kernels", "dp_paper", "ofl",
              "bp_means", "fig3", "retrieval", "serve", "invariants",
              "cluster", "ha", "lm_serve", "train", "moe", "serve_clusters",
              "curation", "examples", "hybrid", "xlstm", "frontends", "dryrun",
              "mesh", "lm_mesh")
KERNELS = ("dpmeans_assign", "topk_stream", "topk_multiprobe_stream",
           "flash_attention", "rmsnorm", "swiglu", "rmsnorm_bwd", "swiglu_bwd")
SOURCES = ("dpmeans_assign", "topk_stream", "flash_attention", "rmsnorm",
           "swiglu")     # csrc/<name>.cu

# NVIDIA H100 SXM data sheet, dense: f32 outside the tensor cores, bf16 on
# the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# The paper's §4 clustering data (benchmarks/fig4_scaling.py), cut from
# 2^20 points when the frontends phase came in (at 2^20 pass 1's serial
# accept scan took 85-115 s and the phase about 137 s on an H100 80GB HBM3
# at 700 W), and to 2^18 when the dryrun phase came in (at 2^19 pass 1
# took 54.6-71.6 s and the phase 71.2-92.0 s on the same card).  2^18 is
# the floor: below it the serial validator no longer runs at a scale near
# the paper's, so a new phase takes its time from elsewhere.
DP_N = 2**18
# OFL over it opens tens of thousands of facilities: the pool's capacity.
OFL_K_MAX = 131_072
# OFL streams the first OFL_N of those points (2^20 until the hybrid and
# xlstm phases came in: 105 s of the script; 2^19, 56 s of its stream on an
# H100 80GB HBM3 at 700 W, until the frontends phase came in).  2^18 is
# the floor, as DP_N's is.
OFL_N = 2**18
# The paper's §4 feature data for BP-means.
BP_N = 2**18
# The multi-process cluster over the paper's §4 data, cut from 2^20 points
# for time (16 epochs of Pb = 2048 over 4 worker processes; 2^17 points
# until the hybrid and xlstm phases came in, 2^16 until the dryrun phase
# came in: the phase 73.5-77.5 s on an H100 80GB HBM3 at 700 W; 2^15
# until the lm_mesh phase's hybrid parts came in); its chaos run and the
# HA run take 2^15 points (16 epochs), the telemetry check's six fused
# passes 2^14 (8 epochs).
CLUSTER_N = 2**14
CLUSTER_SMALL_N = 2**15
TELEMETRY_N = 2**14
# The reference's limit on telemetry's cost (benchmarks/occ_engine.py,
# OBS_OVERHEAD_LIMIT_PCT): the post-pass export's host time against the
# pass's.
OBS_OVERHEAD_LIMIT_PCT = 2.0
# Points behind the OFL and BP-means invariants on the card (cut from 8,192
# and 4,096 to bring the ofl, bp_means and fig3 phases nearer 150 s).
OFL_INV_N = 4096
BP_INV_N = 2048
# Points behind the DP-means invariants on the card (cut from 65,536 to
# bring the whole script nearer 800 s once the train phase came in).
DP_INV_N = 32_768
# Distances agree to this fraction of ||x||^2 + ||c||^2: the scale of the
# expanded form's cancellation (the kernel and torch.matmul sum D products
# in different orders).
REL_TOL = 1e-5
# Requests of each kind behind the serve phase's latency percentiles.
LAT_REQUESTS = 2048
# Language-model kernels against their plain versions on the card: f32
# outputs within these multiples of max(1, max |plain|) (flash: the 2e-5
# of an f32 attention output; rmsnorm, swiglu: a few f32 ulps, both sum or
# divide in another order; rmsnorm's backward 1e-5: two row sums and a
# difference of two terms for dx, and dw sums 16,384 rows in another
# order), 16-bit outputs within one ulp of their type (bf16 or f16) at the
# output's largest magnitude (both round nearly the same f32 value once).
LM_TOL_F32 = {"flash_attention": 2e-5, "rmsnorm": 1e-6, "swiglu": 1e-6,
              "rmsnorm_bwd": 1e-5, "swiglu_bwd": 1e-6}
# Full-width f32 qwen3-4b (2 layers): prefill logits with the kernels and
# with the plain versions agree within this multiple of max(1, max |logit|).
LOGIT_TOL = 1e-4
# Full-depth bf16 qwen3-4b (36 layers): last-token logits of two routes
# through the same weights (kernels against plain versions; decode_step
# after a prefill against one longer prefill) agree within this fraction of
# max |logit|.  Each route rounds every layer's activations to bf16 (8
# bits) at other points, and the residual stream carries those roundings
# through all 36 layers; a wrong layer, stride or cache position moves the
# logits by their own scale.
BF16_LOGIT_TOL = 0.05
# The full-depth engine run: 8 requests of prompt SERVE_PROMPT on 4 slots,
# each to this many new tokens, so that the decode-tick percentiles rest
# on 64 ticks (cut from 256 new tokens when the moe phase came in, from
# 128 when the hybrid and xlstm phases came in, with the prompt from 64:
# the engine prefills a prompt token by token, and from 64 when the mesh
# phase came in: each decode call is dispatched from the host; the prompt
# from 32 to 16 when the lm_mesh phase came in, and to 4 when its hybrid
# parts came in, the ticks kept).
SERVE_MAX_NEW = 32
SERVE_PROMPT = 4
# The train-while-serve pipeline: points streamed per tenant (the paper's
# Pb = 2048, 32 epochs each) and the QoS A/B tenant's stream.
SC_N = 2**16
SC_QOS_N = 2**14
# OCC data curation at granite-3-2b: 128 batches of 16 sequences of 256
# tokens (2,048 sequences, 0.52M tokens), clustered with Pb 256 into a
# pool of 512.
CUR_BATCHES = 128
CUR_BATCH = 16
CUR_SEQ = 256
CUR_PB = 256
CUR_K_MAX = 512
# Training granite-3-2b at full width and TRAIN_LAYERS of its 40 layers
# (cut from full depth when the hybrid and xlstm phases came in; at 20
# layers the phase took 54 s on an H100 80GB HBM3 at 700 W):
# SHAPES["train_4k"]'s sequence, its global batch of 256 cut to 4 for one
# card; three steps, the first two held against a run on the plain
# versions from the same state (cut from six and three when the moe phase
# came in, and from four when the lm_mesh phase's MoE parts came in).
TRAIN_LAYERS = 16
TRAIN_BATCH = 4
TRAIN_SEQ = 4096
TRAIN_STEPS = 3      # cut from 4 when the lm_mesh phase's MoE parts came in
TRAIN_PLAIN_STEPS = 2
# bf16 at 16 layers: loss and grad norm of the kernels' run against the
# plain versions' within these fractions.  The two runs round the
# activations and the gradients to bf16 at other points (the kernels round
# each rmsnorm and swiglu output and gradient once from f32; autograd of the
# plain versions rounds where its ops do), and the AdamW steps carry the
# differences into the next steps' weights; a wrong gradient moves the grad
# norm by its own scale.
TRAIN_LOSS_TOL = 0.01
TRAIN_GNORM_TOL = 0.02
# f32 at 2 layers: loss relative, and each gradient's max abs difference
# against its own max abs.
TRAIN_F32_LOSS_RTOL = 1e-5
TRAIN_F32_GRAD_TOL = 1e-4
# The moe phase: olmoe-1b-7b (16 layers, d 2048, 16/16 heads of 128, 64
# experts top-8, d_ff 1024, vocab 50304).  Its full-width f32 check runs
# MOE_F32_LAYERS layers on a 1 x MOE_F32_SEQ prefill; the five impls are
# held to `dense` at capacity factor MOE_ORACLE_CF (no drops: C = S) within
# MOE_IMPL_TOL * max(1, max |dense|), the bar of the JAX package's own
# test of its impls (`tests/test_models_smoke.py`: 1e-4), since they sum
# the same products in other orders and routes; routing decisions that
# differ between the kernels' and the plain route must lie within
# MOE_TIE_MARGIN of a tie in the plain route's probabilities.
MOE_F32_LAYERS = 2
MOE_F32_SEQ = 512
MOE_ORACLE_CF = 8.0
MOE_IMPL_TOL = 1e-4
MOE_TIE_MARGIN = 1e-6
# Full depth, bf16: a MOE_PREFILL_BATCH x TRAIN_SEQ (4 x 4096) prefill,
# then 4 requests of prompt MOE_SERVE_PROMPT and MOE_SERVE_MAX_NEW new
# tokens on 4 slots (the prompt cut from 64 to 16 when the lm_mesh phase's
# MoE parts came in, to 4 when its hybrid parts came in: the engine
# prefills token by token, one decode call a prompt token).  Last-token logits of two routes
# (kernels against plain versions; decode_step after a prefill against one
# longer prefill) agree within this fraction of max |logit|: the bf16
# roundings of BF16_LOGIT_TOL's reasoning over 16 layers (qwen3-4b's bar of
# 0.05 covers 36), plus the routing: a token whose k-th and (k+1)-th
# experts lie within bf16 noise of each other takes another expert in the
# other route, which moves that token's FFN output by up to its gate weight
# (about 1/8 of the layer's FFN output at top-8), and through attention the
# later tokens' outputs a little.  Decode against prefill runs at capacity
# factor MOE_ORACLE_CF: at the config's 1.25 a 65-token prefill (C 11)
# drops tokens that decode (one token, C 1) never drops, by the
# reference's design.
MOE_BF16_LOGIT_TOL = 0.1
MOE_PREFILL_BATCH = 4
MOE_SERVE_PROMPT = 4
MOE_SERVE_MAX_NEW = 16     # cut from 64 (hybrid phase), 32 (mesh phase)
# Training olmoe at full width and MOE_TRAIN_LAYERS of its 16 layers (its
# 12 bytes a parameter at full depth, 83 GB, exceed the card; cut from 8
# to 4 when the hybrid and xlstm phases came in): bf16,
# remat "full", chunked attention, as the config sets them; MOE_TRAIN_STEPS
# AdamW steps of MOE_TRAIN_BATCH x TRAIN_SEQ tokens, the first
# MOE_TRAIN_PLAIN_STEPS against the plain versions.  The batch is cut from
# 4 to 2: at 4 the predicted peak (42.8 GB of state, 29 GB saved by one
# layer's recompute of the capacity dispatch, whose k-loop keeps eight
# (4, 4096, 64, 640) f32 one-hots, and its backward's transients) passes
# 75 GB.
MOE_TRAIN_LAYERS = 2      # cut from 4 when the lm_mesh MoE parts came in
MOE_TRAIN_BATCH = 2
MOE_TRAIN_STEPS = 3      # cut from 4 when the lm_mesh MoE parts came in
MOE_TRAIN_PLAIN_STEPS = 2
# The recurrent families (the hybrid and xlstm phases), widths never cut:
# zamba2-7b (81 layers: 13 x (6 Mamba2 layers + the shared attention and
# MLP block) + 3 Mamba2 layers; d 3584, 32/32 heads of 112, d_ff 14336,
# vocab 32000; Mamba2 d_inner 7168, 112 heads of 64, state 64, conv 4;
# chunk 256) and xlstm-1.3b (48 layers: 6 x (7 mLSTM + 1 sLSTM); d 2048, 4
# heads of 512, d_ff 0, vocab 50304).  (a) Full width, f32, REC_F32_LAYERS
# layers (zamba2: one segment of six Mamba2 layers and one use of the
# shared block; xlstm: seven mLSTM and one sLSTM), a 1 x REC_F32_SEQ
# prefill (two chunks of 256): logits with the kernels against the plain
# versions within LOGIT_TOL, then the loss and every gradient in f32.
REC_F32_LAYERS = {"hybrid": 6, "xlstm": 8}
REC_F32_SEQ = 512
# Then decode_step after prefill(64) against prefill(65), in f32, within
# LOGIT_TOL's reasoning at the reference's own bar for it (2e-3 of
# max(1, max |logit|), `tests/test_models_smoke.py`): the chunked and the
# recurrent forms sum in other orders.
REC_F32_DECODE_TOL = 2e-3
# The f32 gradients with the kernels against the plain versions, each
# within this fraction of its largest magnitude (TRAIN_F32_GRAD_TOL is
# 1e-4).  The two routes differ only in the rmsnorm kernels' summation
# order (and zamba2's attention), a few f32 ulps, and these blocks amplify
# that on the way back.  zamba2: its Mamba2 scans (exp and cumsum chains,
# gated norms); on the CPU the JAX package's own gradients of reduced
# zamba2-7b move by 7.7e-5 of a leaf's largest magnitude between chunks of
# 16 and 64, the same function summed in another order
# (`tests/test_torch_ssm.py`).  xlstm: the mLSTM divides by max(|n.q|,
# exp(-m)), where n.q sums 512 terms of either sign, so its gradient with
# respect to q carries 1 / (n.q)^2: the first layer's wq moved by 1.9e-4
# of its largest magnitude (on an H100 80GB HBM3 at 700 W).
REC_F32_GRAD_TOL = {"hybrid": 1e-3, "xlstm": 1e-3}
# (b) Full depth, bf16, flash attention: a 4 x TRAIN_SEQ prefill, then 4
# requests of prompt REC_SERVE_PROMPT and REC_SERVE_MAX_NEW new tokens on
# 4 slots (both cut from 64 when the frontends phase came in, the new
# tokens to 16 when the mesh phase came in, the prompt to 16 when the
# lm_mesh phase came in and to 4 when its hybrid parts came in, which
# serve zamba2-7b too: the engine dispatches each decode call from the
# host, 45-102 ms a call).
# Last-token logits of two routes (kernels against plain versions;
# decode_step after a prefill against one longer prefill) agree within
# the larger of REC_BF16_LOGIT_TOL of max |logit| and the reference's own
# bf16 error there: the same logits' distance from an f32 run of the
# plain versions on the same weights (widened, exact), measured in the
# same call.  At random init neither family's bf16 arithmetic holds at
# depth: a difference of one bf16 ulp in a norm's output grows through
# each segment, to the logits' own scale (last-token logits of 4 x 4096,
# kernels against plain: zamba2 4.37 at a scale of 4.44, the plain bf16
# route against f32 5.18; xlstm 4.69 at 4.81, against 5.01, on an H100
# 80GB HBM3 at 700 W), so no fixed fraction of the logits separates a
# wrong kernel from the reference's own rounding.  Where the bf16 run
# holds, the fixed bars do: qwen3-4b's 0.05 (BF16_LOGIT_TOL's reasoning)
# for xlstm, f32 inside every block, whose routes differ in rmsnorm's
# rounding; 0.1 for zamba2, whose routes also differ in the 13 uses of the
# shared attention (flash rounds P to bf16).  The kernels' own bars are
# (a)'s f32 ones and `lm_kernels`'.
REC_BF16_LOGIT_TOL = {"hybrid": 0.1, "xlstm": BF16_LOGIT_TOL}
# At full depth the three runs are about equally far apart (kernels vs
# plain 0.84 and 0.94 of plain vs f32 at the logits, on the same card),
# so the bar is REC_FLOOR_MUL times the floor, for another input's spread;
# it says only that the kernels add no error beyond the order of the
# reference's own bf16 error.  The tight bf16 bar is where the bf16 run
# still holds: the residual stream after the first segment (zamba2's six
# Mamba2 layers, xlstm's seven mLSTM layers), the two routes within
# REC_SEG0_TOL relative L2 (zamba2 0.69 % and xlstm 1.67 %, against 8.2 %
# and 15 % for plain bf16 vs f32, on the same card).
REC_FLOOR_MUL = 1.5
REC_SEG0_TOL = 0.05
# Those two routes and the f32 run take a REC_COMPARE (B, S) batch, not the
# timed 4 x 4096 prefill: three more full-depth prefills of that size cost
# 21 s in xlstm, whose sLSTM steps the host dispatches one by one.
REC_COMPARE = (2, 1024)
# xlstm's profiled prefill: 4 x this many tokens (its 4 x 4096 prefill
# takes 8.8 s under the profiler, an eighth of them the same work; 1024
# until the mesh phase came in).
REC_PROFILE_XLSTM = 512
REC_SERVE_PROMPT = 4
REC_SERVE_MAX_NEW = 16
# (c) Training at full width: zamba2 at REC_TRAIN_LAYERS layers (12 bytes
# a parameter: 81 GB at 81 layers; 12 layers are two segments of six and
# two uses of the shared block, 16.4 GB), xlstm at 8 (one segment of each
# kind); bf16, remat "full", chunked attention, chunk 256, as the configs
# set them: REC_TRAIN_STEPS AdamW steps of REC_TRAIN_BATCH x seq tokens,
# the first REC_TRAIN_PLAIN_STEPS against the plain versions, held to
# TRAIN_LOSS_TOL and TRAIN_GNORM_TOL.  xlstm's sequence is cut to
# REC_TRAIN_SEQ["xlstm"]: autograd records its sLSTM's loop of one step a
# token, about 30 ops a step, twice (remat), and differentiates it, all
# dispatched from the host (a step of 4 x 2048 took 6.2 s, 91 % of it
# idle; 4 x 1024 4.4 s, 92 % idle; on an H100 80GB HBM3 at 700 W).  Cut
# from 1024 to 512 (two chunks of 256) when the mesh phase came in;
# REC_TRAIN_STEPS from 4 to 3 when the lm_mesh phase's MoE parts came in.
# zamba2's sequence stays 4096: at 4 x 2048 its grad norm at step 2 was
# 2.0 % from the plain run's (100.21 against 102.27), past TRAIN_GNORM_TOL
# (on an H100 80GB HBM3 at 700 W).
REC_TRAIN_LAYERS = {"hybrid": 12, "xlstm": 8}
REC_TRAIN_BATCH = 4
REC_TRAIN_SEQ = {"hybrid": 4096, "xlstm": 512}
REC_TRAIN_STEPS = 3
REC_TRAIN_PLAIN_STEPS = 2
# The grad norm's bar against the plain run: TRAIN_GNORM_TOL, but 0.1 for
# xlstm.  Its mLSTM's gradients carry 1 / (n.q)^2 (REC_F32_GRAD_TOL's
# comment), so in bf16 the two routes' one-ulp differences in the norms
# move the grad norm by percents, more once an AdamW step has carried them
# into the weights: 1.2 % and 1.4 % at steps 1 and 2 of 4 x 2048, 5.0 %
# at step 2 of 4 x 1024, the loss within 2.3e-4 throughout, on an H100
# 80GB HBM3 at 700 W; at random init its grad norm is 70.
REC_TRAIN_GNORM_TOL = {"hybrid": TRAIN_GNORM_TOL, "xlstm": 0.1}
# The frontend families (the frontends phase), widths never cut:
# internvl2-2b (vlm: 24 layers, d 2048, 16/8 heads of 128, d_ff 8192,
# vocab 92553; a 256-patch prefix of 1024-wide stub embeddings) and
# seamless-m4t-medium (audio: 12 encoder layers over 1024 frames of 160,
# 12 decoder layers with cross-attention; d 1024, 16/16 heads of 64, d_ff
# 4096, vocab 256206).  (a) Full width, f32, 2 layers (seamless: 2 encoder
# and 2 decoder layers): a 1 x FE_F32_SEQ-position prefill carrying a
# frontend batch (internvl2: 256 patches and 256 tokens), the kernels
# against the plain versions within LOGIT_TOL; decode_step after a
# prefill against the longer prefill within REC_F32_DECODE_TOL; the loss
# within TRAIN_F32_LOSS_RTOL and every gradient (the frontend's, the
# encoder's and the cross-attention's among them) within
# TRAIN_F32_GRAD_TOL of its largest magnitude.
FE_F32_SEQ = 512
# (b) Full width and depth, bf16, flash attention: a 4 x TRAIN_SEQ-position
# prefill (internvl2: 256 patches + 3840 tokens; seamless: 4096 tokens over
# 1024 frames); FE_TICKS decode steps from its caches (the cross keys and
# values static); the kernels against the plain versions and the plain
# versions in f32 on an FE_COMPARE (B, positions) batch, held as
# `_rec_agree` holds them (BF16_LOGIT_TOL, or REC_FLOOR_MUL times the bf16
# run's own distance from f32); a ServeEngine run of 4 requests of prompt
# FE_SERVE_PROMPT and FE_SERVE_MAX_NEW new tokens on 4 slots (the new
# tokens cut from 32 when the mesh phase came in, the prompt from 32 to 16
# when the lm_mesh phase came in and to 4 when its hybrid parts came in).
FE_TICKS = 32
FE_COMPARE = (2, 1024)
FE_SERVE_PROMPT = 4
FE_SERVE_MAX_NEW = 16
# (c) Training at full width: internvl2 at FE_TRAIN_LAYERS of its 24
# layers, seamless at its full 12 + 12; bf16, remat "full", chunked
# attention, 4 x TRAIN_SEQ positions, FE_TRAIN_STEPS AdamW steps, the first
# FE_TRAIN_PLAIN_STEPS against the plain versions within TRAIN_LOSS_TOL and
# TRAIN_GNORM_TOL.
FE_TRAIN_LAYERS = {"internvl2-2b": 8, "seamless-m4t-medium": 12}
FE_TRAIN_STEPS = 3       # cut from 4 when the lm_mesh MoE parts came in
FE_TRAIN_PLAIN_STEPS = 2
# The dryrun phase: the roofline and the meta-device dry run held against
# three cells on the card, bf16, full width: (a) the train phase's
# granite-3-2b step (TRAIN_LAYERS layers, TRAIN_BATCH x TRAIN_SEQ, remat
# "full"; p50 of steps 3-4); (b) a qwen3-4b prefill at full depth,
# DRYRUN_BATCH x TRAIN_SEQ, flash; (c) its decode_step, DRYRUN_BATCH rows
# against a TRAIN_SEQ-position cache, p50 of DRYRUN_DECODE_STEPS after two
# warm-up steps.
DRYRUN_BATCH = 4
DRYRUN_DECODE_STEPS = 16
# The mesh phase: MESH_RANKS ranks share the one card.  The paper's setting
# over MESH_DP_N points of its data (cut from 2^20 as dp_paper's is, and
# further to fit the phase in about 45 s: four ranks re-execute the
# validator side by side), OFL over the first MESH_OFL_N of them into a
# pool of MESH_OFL_K_MAX slots, BP-means over MESH_BP_N feature points, the
# invariants over the first MESH_INV_N, MESH_REQUESTS requests of each
# kind.  A rank still running after MESH_TIMEOUT_S is killed (its
# collectives time out after as long).
MESH_RANKS = 4
MESH_DP_N = 2**15
MESH_OFL_N = 2**14
MESH_OFL_K_MAX = 16384
MESH_BP_N = 2**13
MESH_INV_N = 4096
MESH_REQUESTS = 256
MESH_TIMEOUT_S = 300
# The lm_mesh phase: the language model's mesh, LM_MESH_RANKS ranks sharing
# the card on a (data 2, model 2) mesh.  qwen3-4b served at full width and
# depth in bf16 (and at full width and LM_MESH_F32_LAYERS layers in f32, for
# greedy tokens identical to one process): a ServeEngine of LM_MESH_SLOTS
# slots runs LM_MESH_REQUESTS requests of LM_MESH_PROMPT prompt tokens and
# LM_MESH_NEW new ones in decode modes "tp" and "cp" (the engine prefills
# token by token: each request costs prompt + new decode calls; in f32,
# LM_MESH_F32_SERVE = (requests, prompt, new)), and a prefill of
# LM_MESH_PREFILL_B x LM_MESH_PREFILL_S.  The decode calls are host-bound
# on the mesh (a call 336 ms in "tp" and 588 ms in "cp" against 62 ms in
# one process, on an H100 80GB HBM3 at 700 W: 75 and 183 gloo collectives
# a call, through the host, from four processes time-slicing the card), so
# the engine runs were cut from 4 requests of prompt 16 (72 calls a mode,
# the phase 140 s) to 2 of prompt 8 (24 calls, 88 s alone, 82.5 s in a
# full run of 980 s), then to prompt 4 and 8 new (16 calls) and, when the
# MoE parts came in, to 4 new (12 calls; the MoE engine keeps 8), and when
# the hybrid parts came in to prompt 2 (8 calls; f32 (2, 2, 4), 12 calls
# down to 8).  granite-3-2b trained at
# full width and LM_MESH_TRAIN_LAYERS of its 40 layers, bf16,
# LM_MESH_TRAIN_BATCH x LM_MESH_TRAIN_SEQ, LM_MESH_TRAIN_STEPS steps, and one
# error-feedback step on (pod 2, model 2); and in f32 at full width and
# LM_MESH_F32_LAYERS layers, held to one process's loss and grad norm
# within LM_MESH_F32_RTOL.  bf16 results are held to one process's within
# LM_MESH_SPREAD_X times the spread between one process's kernels and its
# plain versions on the same inputs.  The multiple is 16, not 4 (the first
# run on an H100 80GB HBM3 at 700 W: the grad norm 9.4 x the spread): the
# plain versions re-round only each block's norms and swiglu, while the
# mesh re-rounds every tensor-parallel product (two bf16 partial sums, added
# in f32) and each data rank's gradients; in f32 the mesh equals one process
# to LM_MESH_F32_RTOL.
LM_MESH_RANKS = 4
LM_MESH_F32_LAYERS = 2
LM_MESH_SLOTS = 4
LM_MESH_REQUESTS = 2
LM_MESH_PROMPT = 2
LM_MESH_NEW = 4              # cut from 8 when the MoE parts came in
LM_MESH_F32_SERVE = (2, 2, 4)
LM_MESH_CACHE = 64
LM_MESH_PREFILL_B = 2
LM_MESH_PREFILL_S = 512
LM_MESH_TRAIN_LAYERS = 8
LM_MESH_TRAIN_BATCH = 4
LM_MESH_TRAIN_SEQ = 1024
LM_MESH_TRAIN_STEPS = 2      # cut from 3 when the MoE parts came in
LM_MESH_SPREAD_X = 16.0
LM_MESH_F32_RTOL = 1e-5
LM_MESH_TIMEOUT_S = 300
# The lm_mesh phase's MoE parts, in the same spawn and on the same (data 2,
# model 2) mesh, the experts split over model (olmoe-1b-7b's 64 experts 32
# a rank, phi3.5-moe's 16 experts 8 a rank): olmoe-1b-7b at full width and
# LM_MESH_F32_LAYERS layers in f32 (a LM_MESH_PREFILL_B x LM_MESH_PREFILL_S
# prefill whose logits stay within LM_MESH_F32_RTOL of max(1, max |logit|)
# of one process's, its routing held by the moe phase's tie rule
# (MOE_TIE_MARGIN) with equal drops, the five impls on layer 0's weights
# at the config's capacity factor each held to the same impl in one
# process at that bar, and the engine's greedy tokens (LM_MESH_F32_SERVE)
# in "tp" and "cp" identical to one process's); at full width and depth
# in bf16, served in "tp" (the engine's LM_MESH_REQUESTS requests of
# LM_MESH_PROMPT + LM_MESH_MOE_NEW tokens) and a prefill, held to one
# process's by the spread rule (LM_MESH_SPREAD_X); trained at full width
# and LM_MESH_MOE_LAYERS layers in bf16 (LM_MESH_MOE_TRAIN_BATCH x
# LM_MESH_TRAIN_SEQ, LM_MESH_MOE_TRAIN_STEPS steps) by the spread rule and
# one f32 step by LM_MESH_F32_RTOL; phi3.5-moe at full width and
# LM_MESH_MOE_LAYERS layers in bf16, a prefill and one train step of
# LM_MESH_PREFILL_B x LM_MESH_PREFILL_S, each by the spread rule.
LM_MESH_MOE_NEW = 8
LM_MESH_MOE_LAYERS = 2
LM_MESH_MOE_TRAIN_BATCH = 2
LM_MESH_MOE_TRAIN_STEPS = 2
LM_MESH_MOE_IMPLS = ("capacity", "gather", "hybrid", "dense", "ragged")
# The lm_mesh phase's hybrid parts, in the same spawn and on the same
# (data 2, model 2) mesh: zamba2-7b's 112 Mamba2 heads 56 a rank and its
# shared attention and MLP block's 32 heads of 112 and d_ff 14336 split
# in two.  At full width and LM_MESH_HYB_LAYERS layers (two segments of six
# Mamba2 layers, two uses of the shared block) in f32: a LM_MESH_PREFILL_B
# x LM_MESH_PREFILL_S prefill, the engine's greedy tokens (LM_MESH_F32_SERVE)
# in "tp" and "cp" identical to one process's, and one train step
# (LM_MESH_HYB_TRAIN_BATCH x LM_MESH_TRAIN_SEQ).  The f32 prefill's logits,
# and the step's loss and grad norm, are held to one process's within the
# larger of LM_MESH_F32_RTOL (relative; of max(1, max |logit|) for the
# logits) and the spread rule on one process's f32 kernels-against-plain
# spread: the Mamba2 blocks amplify f32 rounding, so the mesh's other
# summation orders (each tensor-parallel product's, cuBLAS's choice of
# algorithm for a rank's half of a product) moved the logits by 2.1e-4 of
# their largest and the grad norm by 1.07e-4 (relative) at 12 layers (on
# an H100 80GB HBM3 at 700 W: 4.1x and 1.8x one process's own
# kernels-against-plain spread; `tests/test_torch_lm_mesh.py` holds the
# same blocks to one process on the CPU at a reduced size); at full width
# and depth in bf16, served in "tp" (the engine's LM_MESH_REQUESTS requests of
# LM_MESH_PROMPT + LM_MESH_NEW tokens) and a prefill, held to one
# process's by the spread rule (LM_MESH_SPREAD_X); trained at
# LM_MESH_HYB_LAYERS layers in bf16 (LM_MESH_HYB_TRAIN_BATCH x
# LM_MESH_TRAIN_SEQ, LM_MESH_TRAIN_STEPS steps) by the spread rule.
LM_MESH_HYB_LAYERS = 12
LM_MESH_HYB_TRAIN_BATCH = 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class CheckFailed(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    bad = [p for p in phases if p not in ALL_PHASES]
    if bad:
        ap.error(f"unknown phases {bad}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no port package under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    smoke = Smoke(torch, args.seed)
    for p in phases:
        t0 = time.perf_counter()
        getattr(smoke, p)()
        smoke.phase_seconds[p] = time.perf_counter() - t0
    emit({"phase": "summary", "phase_seconds": smoke.phase_seconds})
    if smoke.card:
        print(smoke.card, flush=True)    # nvidia-smi's name and power limit
    emit({"kernels": smoke.kernel_rows()})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _queued_ms(torch, fn, reps: int = 5, launches: int = 20,
               sleep_cycles: int = 50_000_000) -> tuple[float, bool]:
    """Device time of one call: CUDA events around `launches` back-to-back
    calls queued behind a device-side sleep (50M cycles is about 25 ms), so
    the host's launch overhead does not open gaps between them; median over
    `reps` runs.  Also returns whether the host had queued every call
    before the sleep ended in every run (else gaps may be counted)."""
    fn()
    times = []
    ahead = True
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(sleep_cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        ahead &= not a.query()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times), ahead


def _graph_ms(torch, fn) -> tuple[float, bool]:
    """`_queued_ms` of one call of `fn` captured in a CUDA graph: a call of
    tens of small launches (the plain versions) costs the host a single
    replay, so the host's launch path cannot open gaps between its
    kernels.  Capture fails if `fn` synchronises with the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _queued_ms(torch, graph.replay)


def _median_ms(torch, fn, warmup: int = 10, iters: int = 50) -> float:
    """Median of `iters` single-launch times from CUDA events (includes the
    host's launch overhead when it exceeds the device time)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class Smoke:
    def __init__(self, torch, seed: int):
        self.torch = torch
        self.seed = seed
        self.dev = torch.device("cuda", 0)
        self.phase_seconds: dict[str, float] = {}
        self.max_abs_err = {name: 0.0 for name in KERNELS}
        self.timings: list[dict] = []
        self.main_launches: dict[str, int | None] = dict.fromkeys(KERNELS)
        self.retrieval_launches: int | None = None
        self.ofl_launches: int | None = None
        self.fig3_launches: int | None = None
        self.cluster_launches: dict | None = None   # master and workers
        self.ha_launches: dict | None = None
        self.lm_launches: dict[str, dict] = {}   # prefill / serve counts
        # launches of the later paths, by path: {kernel: count}
        self.path_launches: dict[str, dict[str, int]] = {}
        self.retrieval_built = None   # build_index's (x, store, s, engine)
        self.dp_x = None
        self.index = None          # (chunks numpy, trained pool)
        self.card = ""             # nvidia-smi name and power limit

    # ------------------------------------------------------------ device
    def device(self):
        torch = self.torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
        print(line, flush=True)
        self.card = line
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        check(not torch.backends.cuda.matmul.allow_tf32
              and not torch.backends.cudnn.allow_tf32, "TF32 is off")
        check(torch.get_float32_matmul_precision() == "highest",
              "f32 matmul precision is 'highest'")
        emit({"phase": "device", "nvidia_smi": line,
              "name": torch.cuda.get_device_name(0),
              "capability": list(torch.cuda.get_device_capability(0)),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "python": sys.version.split()[0], "tf32": False})

    # ------------------------------------------------------------- build
    def build(self):
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        paths = _build.build_all(SOURCES)
        for name in SOURCES:
            _build.load(name)
        seconds = time.perf_counter() - t0
        emit({"phase": "build", "seconds": seconds,
              "nvcc": _build.nvcc_path(), "flags": list(_build.NVCC_FLAGS),
              "sources": {name: {
                  "library": str(paths[name]),
                  "seconds": _build.BUILD_LOG.get(name, {}).get("seconds"),
                  "ptxas": _build.BUILD_LOG.get(name, {}).get("ptxas", "")}
                  for name in SOURCES}})

    # ----------------------------------------------------------- kernels
    def _inputs(self, n, k, d, count, holes=False, dup=False, seed=0,
                unaligned=False):
        """Random x and centers, the mask (False at and past the count,
        with random holes if asked), the count on the device.  `dup`: every
        center appears twice, at i and i + k/2.  `unaligned`: centers and
        mask start 4 bytes and 1 byte past a 16-byte boundary."""
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)
        x = torch.randn((n, d), generator=g, device=self.dev)
        if unaligned:
            c = torch.randn((k * d + 1,), generator=g,
                            device=self.dev)[1:].view(k, d)
        else:
            c = torch.randn((k, d), generator=g, device=self.dev)
        if dup:
            # every center appears twice at (i, i + k/2): ties everywhere
            c[k // 2:] = c[:k - k // 2]
        mask = torch.arange(k, device=self.dev) < count
        if holes:
            mask &= torch.rand((k,), generator=g, device=self.dev) > 0.3
        if unaligned:
            buf = torch.zeros((k + 1,), dtype=torch.bool, device=self.dev)
            buf[1:] = mask
            mask = buf[1:]
        cnt = torch.full((1,), count, dtype=torch.int32, device=self.dev)
        return x, c, mask, cnt

    def _compare(self, name, x, c, mask, cnt):
        """Kernel vs plain version on the card; returns the kernel output."""
        torch = self.torch
        from repro_torch.kernels.dpmeans_assign import dpmeans_assign
        from repro_torch.kernels.ref import assign_ref
        d2k, ik = dpmeans_assign(x, c, mask, cnt)
        torch.cuda.synchronize()
        m = mask & (torch.arange(c.shape[0], device=self.dev) < cnt)
        # 16-bit inputs widened to f32, exactly as the kernel widens them
        x, c = x.float(), c.float()
        d2p, ip = assign_ref(x, c, m)
        valid = torch.isfinite(d2p)
        check(torch.equal(torch.isfinite(d2k), valid), f"{name}: inf pattern")
        check(torch.equal(ik[~valid], torch.full_like(ik[~valid], -1)),
              f"{name}: -1 where no valid center")
        x2 = (x * x).sum(-1)
        c2 = (c * c).sum(-1)
        scale = x2 + c2[ip.clamp_min(0).long()]
        err = (d2k - d2p).abs()
        err = torch.where(valid, err, torch.zeros_like(err))
        check(bool((err <= REL_TOL * scale + 1e-30).all()),
              f"{name}: d2 within {REL_TOL}*(|x|^2+|c|^2), worst "
              f"{float(err.max())}")
        # A row may differ in index only where the plain version's two
        # smallest distances lie within the tolerance (a near tie).
        mism = (ik != ip) & valid
        n_near = 0
        if c.shape[0] >= 2 and bool(valid.any()):
            from repro_torch.core.objective import sq_dists
            dm = torch.where(m[None, :], sq_dists(x, c), torch.inf)
            two = torch.topk(dm, 2, dim=1, largest=False).values
            near = (two[:, 1] - two[:, 0]) <= REL_TOL * scale
            near &= valid
            n_near = int(near.sum())
            check(not bool((mism & ~near).any()),
                  f"{name}: {int((mism & ~near).sum())} index mismatches "
                  "outside near ties")
        else:
            check(not bool(mism.any()), f"{name}: index mismatch")
        self.max_abs_err["dpmeans_assign"] = max(
            self.max_abs_err["dpmeans_assign"],
            float(err.max()) if err.numel() else 0.0)
        emit({"phase": "kernels", "case": name, "n": x.shape[0],
              "k": c.shape[0], "d": x.shape[1], "count": int(cnt),
              "max_abs_err": float(err.max()) if err.numel() else 0.0,
              "index_mismatches": int(mism.sum()), "near_tie_rows": n_near})
        return d2k, ik

    def _time(self, name, x, c, mask, cnt, sibling=False, generic=False):
        """`dpmeans_assign` at one shape.  With `sibling`, `topk_stream` at
        k = 1 on the same inputs is timed beside it: the port's own kernel
        for the same function (no PyTorch call computes it).  With
        `generic`, the generic kernel (`dpmeans_assign._generic`) too, as
        `generic_ms`: the kernel that took wide widths before the wide
        tile, on the same inputs in the same run."""
        torch = self.torch
        from repro_torch.kernels.dpmeans_assign import (
            _generic, dpmeans_assign, n_split, tile_kernel)
        from repro_torch.kernels.ref import assign_ref
        from repro_torch.kernels.topk_stream import topk_stream
        m = mask & (torch.arange(c.shape[0], device=self.dev) < cnt)
        n, d = x.shape
        active = min(int(cnt), c.shape[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        meta = {}
        if generic:
            meta["generic_ms"] = _queued_ms(
                torch, lambda: _generic(x, c, mask, cnt))[0]
        self._time_kernel(
            "dpmeans_assign", name,
            lambda: dpmeans_assign(x, c, mask, cnt),
            lambda: assign_ref(x, c, m),
            flops=2.0 * n * active * d,
            nbytes=4.0 * (n * d + active * d + 2 * n + 1) + active,
            sibling=(lambda: topk_stream(x, c, mask, cnt, 1)) if sibling
            else None,
            n=n, k=c.shape[0], d=d, count=int(cnt),
            n_split=n_split(n, c.shape[0], d, sms),
            tile_kernel=tile_kernel(d), **meta)

    def _time_kernel(self, kernel_name, shape, kernel, plain, *, flops,
                     nbytes, peak_flops=PEAK_F32_FLOPS, library=None,
                     sibling=None, **meta):
        """Device time of a kernel and of its plain version at one shape,
        beside the bound: the larger of its operations at `peak_flops` (the
        peak for the inputs' type: f32 outside the tensor cores unless
        given) and its bytes (each input read once, each output written
        once) at the memory rate.  The plain version is timed as a CUDA
        graph replay, so its time is the card's, not its host launch
        path's.  `library` is the one PyTorch call that computes the same
        function, where there is one (library_ms is None otherwise); it is
        timed like the kernel, and so is `sibling` (sibling_ms), another of
        the port's kernels that computes the same function."""
        torch = self.torch
        k_ms, k_ahead = _queued_ms(torch, kernel)
        p_ms, p_ahead = _graph_ms(torch, plain)
        lib_ms = None if library is None else _queued_ms(torch, library)[0]
        if sibling is not None:
            meta["sibling_ms"] = _queued_ms(torch, sibling)[0]
        t_ops = flops / peak_flops * 1e3
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        row = {"kernel": kernel_name, "shape": shape, **meta,
               "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "peak_flops": peak_flops,
               "flops": flops, "bytes": nbytes, "library_ms": lib_ms,
               "queued_ahead": k_ahead, "plain_queued_ahead": p_ahead,
               "plain_timing": "cuda graph replay",
               "single_launch_ms": _median_ms(torch, kernel),
               "plain_single_call_ms": _median_ms(torch, plain)}
        self.timings.append(row)
        emit({"phase": "kernels", "timing": row})

    def kernels(self):
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.kernels.dpmeans_assign import dpmeans_assign
        cases = [
            ("paper", dict(n=2048, k=512, d=16, count=37)),
            # a cluster worker's propose: its 512-point shard of the epoch
            ("cluster_shard", dict(n=512, k=512, d=16, count=37)),
            # OFL's propose: an epoch of the paper's data against the
            # 131,072-slot pool, at the count its stream ends with
            ("ofl", dict(n=2048, k=131072, d=16, count=100_790)),
            ("retrieval", dict(n=256, k=131072, d=16, count=110000)),
            ("score", dict(n=64, k=131072, d=16, count=110000)),
            ("routing", dict(n=110000, k=512, d=16, count=512)),
            ("one_row", dict(n=1, k=131072, d=16, count=5)),
            # the center range split over blocks: one live center; fewer
            # live tiles than splits (idle splits); exact ties across
            # splits; holes at the full capacity
            ("score_count1", dict(n=64, k=131072, d=16, count=1)),
            ("idle_splits", dict(n=64, k=131072, d=16, count=5000)),
            ("duplicates_131072", dict(n=64, k=131072, d=16, count=131072,
                                       dup=True)),
            ("holes_131072", dict(n=256, k=131072, d=16, count=110000,
                                  holes=True)),
            ("unaligned", dict(n=100, k=3000, d=16, count=2900, holes=True,
                               unaligned=True)),
            ("d100_holes", dict(n=1000, k=1000, d=100, count=1000, holes=True)),
            ("d768_holes", dict(n=1000, k=1000, d=768, count=1000, holes=True)),
            ("count0", dict(n=300, k=256, d=16, count=0)),
            ("duplicates", dict(n=513, k=200, d=16, count=200, dup=True)),
            ("ragged", dict(n=77, k=129, d=33, count=100, holes=True)),
        ]
        outs = {}
        for i, (name, kw) in enumerate(cases):
            inp = self._inputs(seed=self.seed + i, **kw)
            outs[name] = (inp, self._compare(name, *inp))
        # duplicates: the lower index must win every exact tie
        for name in ("duplicates", "duplicates_131072"):
            (_, c, _, _), (_, ik) = outs[name]
            check(bool((ik < c.shape[0] - c.shape[0] // 2).all()),
                  f"{name}: lowest index wins")
        _, (_, i1) = outs["score_count1"]
        check(bool((i1 == 0).all()), "score_count1: the one live center")
        # count 0: everything (inf, -1)
        _, (d2z, iz) = outs["count0"]
        check(bool(torch.isinf(d2z).all()) and bool((iz == -1).all()),
              "count0: (inf, -1)")
        # Row independence: each row alone, and the batch reversed, give the
        # same bits as the batch (at the retrieval shape a row alone runs
        # with 256 splits, the batch with 66; at OFL's, the batch with 9).
        for name in ("paper", "retrieval", "ofl"):
            (x, c, mask, cnt), (d2b, ib) = outs[name]
            alone = [dpmeans_assign(x[r:r + 1].contiguous(), c, mask, cnt)
                     for r in range(x.shape[0])]
            d2a = torch.cat([a[0] for a in alone])
            ia = torch.cat([a[1] for a in alone])
            rev = torch.flip(x, [0]).contiguous()
            d2r, ir = dpmeans_assign(rev, c, mask, cnt)
            check(torch.equal(d2a, d2b) and torch.equal(ia, ib),
                  f"{name} row independence: rows alone == batch, bitwise")
            check(torch.equal(torch.flip(d2r, [0]), d2b)
                  and torch.equal(torch.flip(ir, [0]), ib),
                  f"{name} row independence: reversed batch == batch, "
                  "bitwise")
        # A cluster worker's shard propose is the slice of the master-width
        # propose, bitwise (the multi-process audit rests on it).
        (x, c, mask, cnt), (d2b, ib) = outs["paper"]
        for w in range(4):
            d2s, i_s = dpmeans_assign(x[w * 512:(w + 1) * 512], c, mask, cnt)
            check(torch.equal(d2s, d2b[w * 512:(w + 1) * 512])
                  and torch.equal(i_s, ib[w * 512:(w + 1) * 512]),
                  f"paper: shard {w} of 4 == its slice of the epoch, bitwise")
        # topk_stream at k = 1 is the same kernel: bitwise at the main
        # path's shapes
        from repro_torch.kernels.topk_stream import topk_stream
        for name in ("score", "retrieval", "routing"):
            (x, c, mask, cnt), (d2b, ib) = outs[name]
            d2t, it = topk_stream(x, c, mask, cnt, 1)
            check(torch.equal(d2t[:, 0], d2b) and torch.equal(it[:, 0], ib),
                  f"{name}: topk_stream k=1 == dpmeans_assign, bitwise")
        self._assign_lowp()
        self._assign_wide()
        # What the wrapper refuses.
        x, c, mask, cnt = outs["retrieval"][0]
        for what, call in (
                ("f64 input", lambda: dpmeans_assign(x.double(), c, mask, cnt)),
                ("f16 x with f32 centers",
                 lambda: dpmeans_assign(x.half(), c, mask, cnt)),
                ("int64 count", lambda: dpmeans_assign(x, c, mask, cnt.long())),
                ("cpu tensor on the cuda backend",
                 lambda: ops.assign(x.cpu(), c.cpu(), backend="cuda"))):
            try:
                call()
            except (TypeError, ValueError):
                continue
            raise CheckFailed(f"{what} must raise")
        emit({"phase": "kernels", "row_independence": True, "raises": True,
              "top1_eq_assign_main_shapes": True,
              "max_abs_err": self.max_abs_err["dpmeans_assign"],
              "ptxas": self._ptxas_checked("dpmeans_assign")})
        self._time("paper", *outs["paper"][0])
        self._time("cluster_shard", *outs["cluster_shard"][0])
        self._time("ofl", *outs["ofl"][0])
        self._time("retrieval", *outs["retrieval"][0], sibling=True)
        self._time("score", *outs["score"][0], sibling=True)
        self._time("routing", *outs["routing"][0], sibling=True)
        # the wide tile at curation's shape beside the generic one, and the
        # generic tile at the D = 8 of the examples and serve_clusters
        self._time("wide", *self._inputs(256, 512, 2048, count=512,
                                         seed=self.seed + 70), generic=True)
        self._time("d8", *self._inputs(256, 512, 8, count=512,
                                       seed=self.seed + 71))
        self._topk_kernels()
        self._multiprobe_kernels()

    def _assign_lowp(self):
        """dpmeans_assign on float16 and bfloat16 inputs (the kernel widens
        to f32 inside) against `ref.pairwise_argmin_ref`, which widens the
        same tensors: the fast width, a generic width and an unaligned
        view.  d2 within 5e-3 (the reference's f16 bar; both sum f32
        products, in other orders), ids equal but where the plain
        version's two smallest distances lie within REL_TOL of the scale
        (a near tie)."""
        torch = self.torch
        from repro_torch.kernels.dpmeans_assign import dpmeans_assign
        from repro_torch.kernels.ref import pairwise_argmin_ref
        g = torch.Generator(device=self.dev).manual_seed(self.seed + 50)
        for dt in (torch.float16, torch.bfloat16):
            for name, n, k, d, unaligned in (("fast", 256, 3000, 16, False),
                                             ("generic", 200, 500, 40, False),
                                             ("unaligned", 100, 3000, 16,
                                              True)):
                x = torch.randn((n, d), generator=g, device=self.dev).to(dt)
                flat = torch.randn((k * d + 1,), generator=g,
                                   device=self.dev).to(dt)
                c = flat[1:].view(k, d) if unaligned else \
                    flat[:k * d].view(k, d)
                mask = torch.rand((k,), generator=g, device=self.dev) > 0.3
                cnt = torch.full((1,), k, dtype=torch.int32, device=self.dev)
                check((c.data_ptr() % 16 != 0) == unaligned,
                      f"assign {dt} {name}: the view's alignment")
                d2k, ik = dpmeans_assign(x, c, mask, cnt)
                d2p, ip = pairwise_argmin_ref(x, c, mask)
                torch.cuda.synchronize()
                err = float((d2k - d2p).abs().max())
                check(err <= 5e-3, f"assign {dt} {name}: d2 within 5e-3, "
                      f"worst {err}")
                xf, cf = x.float(), c.float()
                dm = torch.clamp_min((xf * xf).sum(-1, keepdim=True)
                                     + (cf * cf).sum(-1)[None, :]
                                     - 2.0 * xf @ cf.T, 0.0)
                dm = torch.where(mask[None, :], dm, torch.inf)
                two = torch.topk(dm, 2, dim=1, largest=False).values
                scale = (xf * xf).sum(-1) + (cf * cf).sum(-1)[ip.long()]
                near = (two[:, 1] - two[:, 0]) <= REL_TOL * scale
                mism = ik != ip
                check(not bool((mism & ~near).any()),
                      f"assign {dt} {name}: {int((mism & ~near).sum())} id "
                      "mismatches outside near ties")
                self.max_abs_err["dpmeans_assign"] = max(
                    self.max_abs_err["dpmeans_assign"], err)
                emit({"phase": "kernels", "kernel": "dpmeans_assign",
                      "case": f"{str(dt).replace('torch.', '')} {name}",
                      "n": n, "k": k, "d": d, "max_abs_err": err,
                      "index_mismatches": int(mism.sum()),
                      "near_tie_rows": int(near.sum())})

    def _assign_wide(self):
        """The wide tile (D >= 64, a multiple of 8) against the plain
        version (`_compare`) and, bit for bit, against the generic tile
        (`dpmeans_assign._generic`, the same pair definition): D 64, 768,
        2048 and 4096 at rows 1, 63, 256 and 2048 over 512 slots (count
        500: a ragged last tile, with holes); at each D count 0, count 1,
        duplicated centers (the lower id must win), f16 and bf16; at 1000
        (a last chunk of the row shorter than the ring's) f32 and f16; and
        at 768 centers and x that do not start on 16 bytes (plain loads,
        not cp.async).  At D = 2048: each row alone and the batch reversed
        give the batch's bits, and the result equals the first column of
        `topk_stream` at k = 8 (its generic tile, untouched) and at k = 1
        bit for bit."""
        torch = self.torch
        from repro_torch.kernels.dpmeans_assign import (
            _generic, dpmeans_assign, tile_kernel)
        from repro_torch.kernels.topk_stream import topk_stream
        cases = 0

        def same_as_generic(name, x, c, mask, cnt, got):
            want = _generic(x, c, mask, cnt)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                               want[1]),
                  f"{name}: wide tile == generic tile, bitwise")

        for i, d in enumerate((64, 768, 2048, 4096)):
            check(tile_kernel(d) == "wide", f"D {d} takes the wide tile")
            for n in (1, 63, 256, 2048):
                name = f"wide d{d} n{n}"
                inp = self._inputs(n, 512, d, count=500, holes=True,
                                   seed=self.seed + 400 + 10 * i + n % 7)
                same_as_generic(name, *inp, self._compare(name, *inp))
                cases += 1
            for tag, kw in (("count0", dict(count=0)),
                            ("count1", dict(count=1)),
                            ("duplicates", dict(count=512, dup=True))):
                name = f"wide d{d} {tag}"
                inp = self._inputs(256, 512, d, seed=self.seed + 440 + i,
                                   **kw)
                got = self._compare(name, *inp)
                same_as_generic(name, *inp, got)
                cases += 1
                if tag == "count0":
                    check(bool(torch.isinf(got[0]).all())
                          and bool((got[1] == -1).all()), f"{name}: (inf, -1)")
                elif tag == "count1":
                    check(bool((got[1] == 0).all()), f"{name}: slot 0")
                else:
                    check(bool((got[1] < 256).all()),
                          f"{name}: lowest index wins")
            for dt in (torch.float16, torch.bfloat16):
                x, c, mask, cnt = self._inputs(256, 512, d, count=500,
                                               holes=True,
                                               seed=self.seed + 450 + i)
                x, c = x.to(dt), c.to(dt)
                name = f"wide d{d} {str(dt).replace('torch.', '')}"
                same_as_generic(name, x, c, mask, cnt,
                                self._compare(name, x, c, mask, cnt))
                cases += 1
        # D = 1000: a last chunk shorter than the ring's (zero-filled)
        for dt in (torch.float32, torch.float16):
            x, c, mask, cnt = self._inputs(256, 512, 1000, count=500,
                                           holes=True, seed=self.seed + 455)
            x, c = x.to(dt), c.to(dt)
            name = f"wide d1000 {str(dt).replace('torch.', '')}"
            same_as_generic(name, x, c, mask, cnt,
                            self._compare(name, x, c, mask, cnt))
            cases += 1
        # x and centers one element past a 16-byte boundary
        x, c, mask, cnt = self._inputs(100, 512, 768, count=500, holes=True,
                                       unaligned=True, seed=self.seed + 460)
        x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(100, 768)
        check(x.data_ptr() % 16 != 0 and c.data_ptr() % 16 != 0,
              "wide unaligned: the views' alignment")
        same_as_generic("wide unaligned", x, c, mask, cnt,
                        self._compare("wide unaligned", x, c, mask, cnt))
        # D = 2048: row independence, and topk_stream's first column
        x, c, mask, cnt = self._inputs(256, 512, 2048, count=500, holes=True,
                                       seed=self.seed + 470)
        d2b, ib = dpmeans_assign(x, c, mask, cnt)
        alone = [dpmeans_assign(x[r:r + 1].contiguous(), c, mask, cnt)
                 for r in range(x.shape[0])]
        check(torch.equal(torch.cat([a[0] for a in alone]), d2b)
              and torch.equal(torch.cat([a[1] for a in alone]), ib),
              "wide d2048 row independence: rows alone == batch, bitwise")
        d2r, ir = dpmeans_assign(torch.flip(x, [0]).contiguous(), c, mask, cnt)
        check(torch.equal(torch.flip(d2r, [0]), d2b)
              and torch.equal(torch.flip(ir, [0]), ib),
              "wide d2048 row independence: reversed batch == batch, bitwise")
        for kk in (8, 1):
            d2t, it = topk_stream(x, c, mask, cnt, kk)
            check(torch.equal(d2t[:, 0], d2b) and torch.equal(it[:, 0], ib),
                  f"wide d2048: topk_stream k={kk} first column == "
                  "dpmeans_assign, bitwise")
        emit({"phase": "kernels", "kernel": "dpmeans_assign", "tile": "wide",
              "cases": cases + 1, "equal_to_generic_bitwise": True,
              "row_independent": True, "topk8_first_column_bitwise": True,
              "max_abs_err": self.max_abs_err["dpmeans_assign"]})

    def _ptxas_checked(self, name: str) -> list[dict]:
        """ptxas's registers and spills for every kernel of the `name`
        library (from the build log); fails on a spill."""
        from repro_torch.kernels import _build
        _build.build(name)
        log = _build.BUILD_LOG.get(name, {}).get("ptxas", "")
        if not log:
            return [{"ptxas": "not reported: the library was built by an "
                              "earlier run"}]
        rows = _ptxas_summary(log)
        check(bool(rows) and all("registers" in r for r in rows),
              f"{name}: ptxas reported every kernel")
        check(all(r.get("spill_stores", 0) == 0 and r.get("spill_loads", 0) == 0
                  for r in rows), f"{name}: no spills ({rows})")
        return rows

    # ------------------------------------------------------ top-k kernels
    def _topk_agree(self, kernel, name, x, table, d2k, ik, d2p, ip):
        """Tie-aware comparison of a top-k kernel with its plain version on
        the same inputs.  `table` holds the center of every id.  The
        exhausted slots, (inf, -1), must match exactly; d2 agrees within
        REL_TOL * (|x|^2 + |c|^2); an id may differ from the plain
        version's only where the kernel's pick, scored by the plain
        formula, lies within that tolerance of the plain d2 at that rank
        (a near tie); the valid ids of a row are distinct."""
        torch = self.torch
        torch.cuda.synchronize()
        fin_k, fin_p = torch.isfinite(d2k), torch.isfinite(d2p)
        check(torch.equal(fin_k, fin_p), f"{name}: inf pattern")
        check(torch.equal(ik == -1, ~fin_k) and torch.equal(ip == -1, ~fin_p),
              f"{name}: -1 exactly in the exhausted slots")
        x2 = (x * x).sum(-1)[:, None]
        ck = table[ik.clamp_min(0).long()]
        cp = table[ip.clamp_min(0).long()]
        c2k, c2p = (ck * ck).sum(-1), (cp * cp).sum(-1)
        tol = REL_TOL * (x2 + torch.maximum(c2k, c2p)) + 1e-30
        err = torch.where(fin_p, (d2k - d2p).abs(), torch.zeros_like(d2p))
        check(bool((err <= tol).all()),
              f"{name}: d2 within {REL_TOL}*(|x|^2+|c|^2), worst "
              f"{float(err.max())}")
        picked = torch.clamp_min(x2 + c2k - 2.0 * (x[:, None, :] * ck).sum(-1),
                                 0.0)
        mism = (ik != ip) & fin_p
        near = (picked - d2p).abs() <= tol
        check(not bool((mism & ~near).any()),
              f"{name}: {int((mism & ~near).sum())} id mismatches outside "
              "near ties")
        kk = ik.shape[1]
        pad = -2 - torch.arange(kk, device=ik.device)[None, :]
        srt = torch.sort(torch.where(fin_k, ik.long(), pad), dim=1).values
        check(kk < 2 or bool((srt[:, 1:] != srt[:, :-1]).all()),
              f"{name}: distinct ids per row")
        e = float(err.max()) if err.numel() else 0.0
        self.max_abs_err[kernel] = max(self.max_abs_err[kernel], e)
        emit({"phase": "kernels", "kernel": kernel, "case": name,
              "rows": x.shape[0], "k": kk, "max_abs_err": e,
              "id_mismatches": int(mism.sum())})

    def _topk_kernels(self):
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.kernels.dpmeans_assign import dpmeans_assign
        from repro_torch.kernels.topk_stream import topk_stream
        cases = [
            ("serve_flat", dict(n=64, k=131072, d=16, count=110000), 8),
            ("routing", dict(n=64, k=512, d=16, count=512), 4),
            ("split_rows", dict(n=300, k=4096, d=16, count=3000), 8),
            ("k1", dict(n=100, k=300, d=16, count=211), 1),
            ("k_gt_count", dict(n=37, k=300, d=19, count=5), 8),
            ("count0", dict(n=20, k=37, d=6, count=0), 3),
            ("ragged", dict(n=17, k=20, d=5, count=13), 4),
            ("count_eq_capacity", dict(n=33, k=130, d=8, count=130), 5),
            ("holes_d100", dict(n=200, k=1000, d=100, count=1000,
                                holes=True), 16),
            ("duplicates", dict(n=65, k=200, d=16, count=200, dup=True), 8),
            ("k20_holes", dict(n=70, k=2000, d=40, count=1500, holes=True),
             20),
            ("k64", dict(n=70, k=2000, d=32, count=1500), 64),
            ("nan_tail", dict(n=50, k=256, d=16, count=100), 8),
            # every k bucket on the fast tile with a split merge
            ("k2", dict(n=100, k=4096, d=16, count=4000), 2),
            ("k16", dict(n=100, k=4096, d=16, count=4000, holes=True), 16),
            ("k32", dict(n=100, k=4096, d=16, count=4000), 32),
            ("k64_fast", dict(n=100, k=4096, d=16, count=4000), 64),
            ("unaligned", dict(n=100, k=3000, d=16, count=2900, holes=True,
                               unaligned=True), 8),
            # distances that fall with the center index: each half tile
            # beats every list built before it, the most insertions
            ("falling", dict(n=64, k=4096, d=16, count=4096), 8),
            # k > 64, the wide route: at the serving shape (lists in
            # shared memory, five splits), a pool smaller than k, and a
            # list past shared memory (4,096 keys in global scratch) over
            # fourteen splits
            ("k65", dict(n=64, k=131072, d=16, count=110000), 65),
            ("k100", dict(n=64, k=131072, d=16, count=110000), 100),
            ("k256", dict(n=64, k=131072, d=16, count=110000), 256),
            ("k100_gt_pool", dict(n=37, k=64, d=19, count=60, holes=True),
             100),
            ("k3000_global", dict(n=20, k=131072, d=16, count=110000,
                                  holes=True), 3000),
        ]
        outs = {}
        for i, (name, kw, k) in enumerate(cases):
            x, c, mask, cnt = self._inputs(seed=self.seed + 100 + i, **kw)
            if name == "nan_tail":
                c[kw["count"]:] = torch.nan
            if name == "falling":
                x *= 0.01
                u = torch.nn.functional.normalize(c[:1], dim=1)
                c.copy_(u * torch.linspace(2.0, 1.0, kw["k"],
                                           device=self.dev)[:, None])
            d2k, ik = topk_stream(x, c, mask, cnt, k)
            d2p, ip = ops.serve_topk(x, c, k, mask=mask, count=cnt,
                                     backend="plain")
            self._topk_agree("topk_stream", name, x, c, d2k, ik, d2p, ip)
            outs[name] = ((x, c, mask, cnt), (d2k, ik))
        # column 0 is the nearest-center kernel, bit for bit
        for name in ("serve_flat", "holes_d100", "duplicates", "count0"):
            (x, c, mask, cnt), (d2k, ik) = outs[name]
            d2a, ia = dpmeans_assign(x, c, mask, cnt)
            check(torch.equal(d2k[:, 0], d2a) and torch.equal(ik[:, 0], ia),
                  f"{name}: top-1 column == dpmeans_assign, bitwise")
        # exact ties: ascending ids; count 0: all (inf, -1)
        (_, c, _, _), (d2k, ik) = outs["duplicates"]
        tie = d2k[:, 1:] == d2k[:, :-1]
        check(bool((~tie | (ik[:, 1:] > ik[:, :-1])).all()),
              "duplicates: ascending ids within exact ties")
        _, (d2z, iz) = outs["count0"]
        check(bool(torch.isinf(d2z).all()) and bool((iz == -1).all()),
              "count0: (inf, -1)")
        # a row's answer does not depend on its batch, the split count or
        # the k bucket
        (x, c, mask, cnt), (d2b, ib) = outs["split_rows"]
        alone = [topk_stream(x[r:r + 1].contiguous(), c, mask, cnt, 8)
                 for r in range(x.shape[0])]
        rev = topk_stream(torch.flip(x, [0]).contiguous(), c, mask, cnt, 8)
        three = topk_stream(x, c, mask, cnt, 3)
        check(torch.equal(torch.cat([a[0] for a in alone]), d2b)
              and torch.equal(torch.cat([a[1] for a in alone]), ib),
              "topk row independence: rows alone == batch, bitwise")
        check(torch.equal(torch.flip(rev[0], [0]), d2b)
              and torch.equal(torch.flip(rev[1], [0]), ib),
              "topk row independence: reversed batch == batch, bitwise")
        check(torch.equal(three[0], d2b[:, :3])
              and torch.equal(three[1], ib[:, :3]),
              "topk k=3 == first 3 columns of k=8, bitwise")
        # the wide route: rows alone == batch; its first 64 columns are the
        # register-list kernel's k = 64, bit for bit (the same distances
        # and the same selection order)
        (xw, cw, mw, nw), (d2w, iw) = outs["k100"]
        alone = [topk_stream(xw[r:r + 1].contiguous(), cw, mw, nw, 100)
                 for r in range(0, xw.shape[0], 7)]
        check(torch.equal(torch.cat([a[0] for a in alone]), d2w[::7])
              and torch.equal(torch.cat([a[1] for a in alone]), iw[::7]),
              "wide topk row independence: rows alone == batch, bitwise")
        d64, i64 = topk_stream(xw, cw, mw, nw, 64)
        check(torch.equal(d64, d2w[:, :64]) and torch.equal(i64, iw[:, :64]),
              "wide topk k=100: first 64 columns == k=64 kernel, bitwise")
        d65, i65 = topk_stream(xw, cw, mw, nw, 65)
        check(torch.equal(d65, d2w[:, :65]) and torch.equal(i65, iw[:, :65]),
              "wide topk k=65 == first 65 columns of k=100, bitwise")
        _, (d2g, ig) = outs["k100_gt_pool"]
        check(bool(torch.isinf(d2g[:, 64:]).all())
              and bool((ig[:, 64:] == -1).all()),
              "wide topk: columns past the pool are (inf, -1)")
        for what, call in (
                ("k = 0", lambda: topk_stream(x, c, mask, cnt, 0)),
                ("f64 input", lambda: topk_stream(x.double(), c, mask, cnt,
                                                  4)),
                ("cpu tensor on the cuda backend",
                 lambda: ops.serve_topk(x.cpu(), c.cpu(), 4,
                                        backend="cuda"))):
            try:
                call()
            except (TypeError, ValueError):
                continue
            raise CheckFailed(f"topk: {what} must raise")
        (_, c, _, _), (_, ik) = outs["falling"]
        check(bool((ik == torch.arange(c.shape[0] - 1, c.shape[0] - 9, -1,
                                       device=self.dev)[None, :]).all()),
              "falling: the last 8 centers, nearest first")
        emit({"phase": "kernels", "kernel": "topk_stream",
              "top1_eq_assign": True, "row_independence": True,
              "raises": True, "max_abs_err": self.max_abs_err["topk_stream"],
              "ptxas": self._ptxas_checked("topk_stream")})
        for shape, k in (("serve_flat", 8), ("routing", 4), ("k100", 100)):
            (x, c, mask, cnt), _ = outs[shape]
            n, d = x.shape
            active = min(int(cnt), c.shape[0])
            self._time_kernel(
                "topk_stream", shape,
                lambda: topk_stream(x, c, mask, cnt, k),
                lambda: ops.serve_topk(x, c, k, mask=mask, count=cnt,
                                       backend="plain"),
                flops=2.0 * n * active * d,
                nbytes=4.0 * (n * d + active * d + 1 + 2 * n * k) + active,
                n=n, k=c.shape[0], d=d, count=active, topk=k)

    def _multiprobe_kernels(self):
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.kernels.topk_stream import (
            topk_multiprobe_stream, topk_stream,
        )
        from repro_torch.serving.snapshot import build_hier
        x, c, mask, cnt = self._inputs(n=70, k=4096, d=16, count=3000,
                                       seed=self.seed + 200)
        h = build_hier(c, mask, 3000)
        b, u = x.shape[0], h.n_cells
        dev = self.dev
        # every cell, every member: the flat kernel, bit for bit
        cells = torch.arange(u, dtype=torch.int32, device=dev)
        member = torch.ones((b, u), dtype=torch.bool, device=dev)
        uc = torch.full((1,), u, dtype=torch.int32, device=dev)
        d2m, im = topk_multiprobe_stream(x, h.fine, h.fine_ids, h.fine_mask,
                                         cells, member, uc, 8)
        d2f, if_ = topk_stream(x, c, mask, cnt, 8)
        check(torch.equal(d2m, d2f) and torch.equal(im, if_),
              "multiprobe over every cell == flat top-k, bitwise")
        # the wide route (k > 64) too: every cell == flat, bit for bit
        d2mw, imw = topk_multiprobe_stream(x, h.fine, h.fine_ids,
                                           h.fine_mask, cells, member, uc, 100)
        d2fw, ifw = topk_stream(x, c, mask, cnt, 100)
        check(torch.equal(d2mw, d2fw) and torch.equal(imw, ifw),
              "multiprobe k=100 over every cell == flat top-k, bitwise")
        d2pw, ipw = ops.serve_topk_multiprobe(
            x, h.fine, h.fine_ids, h.fine_mask, cells, member, 100,
            backend="plain")
        self._topk_agree("topk_multiprobe_stream", "mp_full_k100", x, c,
                         d2mw, imw, d2pw, ipw)
        d2p, ip = ops.serve_topk_multiprobe(
            x, h.fine, h.fine_ids, h.fine_mask, cells, member, 8,
            backend="plain")
        self._topk_agree("topk_multiprobe_stream", "mp_full", x, c, d2m, im,
                         d2p, ip)
        # a partial union: u_count < U, a -1 inside the counted ranks, a
        # query with no member cell, random membership
        g = torch.Generator(device=dev).manual_seed(self.seed + 201)
        probed = torch.sort(torch.randperm(u, generator=g, device=dev)[:5]
                            ).values.to(torch.int32)
        cells = torch.full((u,), -1, dtype=torch.int32, device=dev)
        cells[:3] = probed[:3]
        member = torch.zeros((b, u), dtype=torch.bool, device=dev)
        member[:, :4] = torch.rand((b, 4), generator=g, device=dev) > 0.3
        member[:, 3] = False
        member[0] = False
        member[1, :4] = True   # one query a member of every counted rank
        uc = torch.full((1,), 4, dtype=torch.int32, device=dev)
        for k in (1, 8, 64, 100):
            d2m, im = topk_multiprobe_stream(
                x, h.fine, h.fine_ids, h.fine_mask, cells, member, uc, k)
            d2p, ip = ops.serve_topk_multiprobe(
                x, h.fine, h.fine_ids, h.fine_mask, cells, member, k,
                backend="plain")
            self._topk_agree("topk_multiprobe_stream", f"mp_partial_k{k}",
                             x, c, d2m, im, d2p, ip)
            check(bool(torch.isinf(d2m[0]).all()) and bool((im[0] == -1).all()),
                  "multiprobe: a query with no member cell is (inf, -1)")
        # ranks at or past u_count are skipped even when listed
        cells2 = cells.clone()
        cells2[3:5] = probed[3:5]
        member2 = member.clone()
        member2[:, 3:5] = True
        d2s, is_ = topk_multiprobe_stream(x, h.fine, h.fine_ids, h.fine_mask,
                                          cells2, member2, uc[:1] * 0 + 3, 8)
        d2t, it = topk_multiprobe_stream(x, h.fine, h.fine_ids, h.fine_mask,
                                         cells, member, uc[:1] * 0 + 3, 8)
        check(torch.equal(d2s, d2t) and torch.equal(is_, it),
              "multiprobe: ranks past u_count are not read")
        emit({"phase": "kernels", "kernel": "topk_multiprobe_stream",
              "full_union_eq_flat": True, "n_cells": u,
              "shard_cap": h.shard_cap,
              "max_abs_err": self.max_abs_err["topk_multiprobe_stream"]})

    # ---------------------------------------------------------- dp_paper
    def _dp_data(self):
        if self.dp_x is None:
            from repro_torch.data import dp_stick_breaking_data
            t0 = time.perf_counter()
            x, z, _ = dp_stick_breaking_data(DP_N, dim=16, seed=self.seed)
            self.dp_x = x
            emit({"phase": "data", "n": DP_N,
                  "true_k": int(z.max()) + 1,
                  "seconds": time.perf_counter() - t0})
        return self.dp_x

    def dp_paper(self):
        torch = self.torch
        from repro_torch.core import DPMeansTransaction, OCCEngine
        from repro_torch.kernels import ops
        x_np = self._dp_data()
        x = torch.as_tensor(x_np, device=self.dev)
        txn = DPMeansTransaction(lam=4.0, k_max=512)
        eng = OCCEngine(txn, pb=2048, validate_cap="adaptive", device="cuda")
        torch.cuda.synchronize()
        # --- the main path: counts from 0 just before, read just after ---
        ops.reset_launch_counts()
        passes = []
        pool = None
        stats, count0 = [], []
        for p in range(2):
            count0.append(0 if pool is None else int(pool.count))
            e0 = eng.n_epochs_dispatched
            t0 = time.perf_counter()
            res = eng.run(x, pool=pool)
            torch.cuda.synchronize()
            t_pass = time.perf_counter() - t0
            t0 = time.perf_counter()
            pool = eng.refine(res.pool, x, res.assign)
            torch.cuda.synchronize()
            t_refine = time.perf_counter() - t0
            stats.append(res.stats)
            passes.append({
                "pass": p + 1, "seconds": t_pass, "refine_seconds": t_refine,
                "epochs": int(res.stats.proposed.shape[0]),
                "epochs_dispatched": eng.n_epochs_dispatched - e0,
                "K": int(res.pool.count),
                "proposed": int(res.stats.proposed.sum()),
                "accepted": int(res.stats.accepted.sum()),
                "caps": sorted({int(c) for c in res.stats.cap.tolist()}),
                "overflow": bool(res.pool.overflow)})
        launches = ops.ASSIGN_LAUNCHES
        # -----------------------------------------------------------------
        self.main_launches["dpmeans_assign"] = launches
        j = float(txn.objective(x, res.assign, pool))
        k = int(res.pool.count)
        check(launches == eng.n_epochs_dispatched,
              f"dp_paper: {launches} kernel launches for "
              f"{eng.n_epochs_dispatched} epochs dispatched")
        check(launches > 0, "dp_paper: the pass went through the kernel")
        check(not any(p["overflow"] for p in passes), "dp_paper: no overflow")
        check(1 <= k < 512, f"dp_paper: 1 <= K={k} < 512")
        check(bool(torch.isfinite(pool.centers).all()) and j == j,
              "dp_paper: finite centers and objective")
        for p, st, c0 in zip(passes, stats, count0):
            p["kernel_replayed"] = self._replay_kernel(
                x, 2048, pool, c0, st.accepted, p["seconds"])
        share = self._kernel_share(lambda: eng.run(x, pool=pool),
                                   passes[-1]["seconds"])
        emit({"phase": "dp_paper", "n": x.shape[0], "d": x.shape[1],
              "lam": 4.0, "k_max": 512, "pb": 2048,
              "validate_cap": "adaptive", "K": k, "J": j,
              "passes": passes, "assign_launches": launches,
              "n_dispatches": eng.n_dispatches,
              "n_cap_retries": eng.n_cap_retries, **share})

    def _kernel_share(self, run, pass_s: float) -> dict:
        """Device time by kernel over `run()`, one more warm pass like the
        last one, from torch.profiler (after the main path's counts were
        read).  The profiler slows the host several times over, so shares
        are taken against `pass_s`, the same pass's unprofiled wall time.
        It records device activity only: the host's events would add
        nothing to the device totals and triple the trace's processing."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tot = kern = 0.0
        n_kern = 0
        for key, dt, count in _device_events(prof):
            tot += dt
            if "dpmeans_assign" in key:
                kern += dt
                n_kern += count
        if tot <= 0:
            return {"profiled_pass": "not measured (no device events)"}
        return {"profiled_pass": {
            "profiled_wall_s": wall, "unprofiled_pass_s": pass_s,
            "device_busy_s": tot / 1e6,
            "kernel_device_s": kern / 1e6, "kernel_calls": n_kern,
            "kernel_share_of_pass": kern / 1e6 / pass_s,
            "kernel_share_of_device": kern / tot,
            "device_idle_share": max(0.0, 1 - tot / 1e6 / pass_s)}}

    def _replay_kernel(self, x, pb, pool, count0, accepted, pass_s) -> dict:
        """Device seconds of a pass's propose launches, replayed after the
        pass (its launch counts already read): one launch per epoch on that
        epoch's pb rows, zero-padded as the engine pads them, with the pool
        count the epoch saw (`count0` plus the accepts of the epochs
        before).  The kernel's work depends only on the rows and that count,
        so this is the pass's kernel time, queued back to back behind a
        device sleep, without the host's gaps."""
        torch = self.torch
        from repro_torch.kernels.dpmeans_assign import dpmeans_assign
        t = accepted.shape[0]
        xs = torch.zeros((t * pb, x.shape[1]), dtype=x.dtype, device=self.dev)
        xs[:x.shape[0]] = x
        xs = xs.reshape(t, pb, x.shape[1])
        acc = accepted.to(torch.int64)
        counts = (count0 + torch.cumsum(acc, 0) - acc).clamp_max(
            pool.centers.shape[0]).to(torch.int32).reshape(t, 1).contiguous()
        c, m = pool.centers, pool.mask

        def replay():
            for e in range(t):
                dpmeans_assign(xs[e], c, m, counts[e])
        ms, ahead = _queued_ms(torch, replay, reps=3, launches=1,
                               sleep_cycles=1_000_000_000)
        return {"launches": t, "kernel_device_s": ms / 1e3,
                "kernel_share_of_pass": ms / 1e3 / pass_s,
                "first_count": int(counts[0]), "last_count": int(counts[-1]),
                "queued_ahead": ahead}

    # --------------------------------------------------------------- ofl
    def ofl(self):
        """OCC OFL online over the paper's data, its first OFL_N points:
        `partial_fit` in 16 batches and a `flush`, adaptive cap, the propose
        phase on `dpmeans_assign`; then the port's OFL invariants on the
        card over the first `OFL_INV_N` points."""
        torch = self.torch
        from repro_torch.core import OCCEngine, OFLTransaction
        from repro_torch.kernels import ops
        x = torch.as_tensor(self._dp_data()[:OFL_N], device=self.dev)
        key = (0, self.seed)
        eng = OCCEngine(OFLTransaction(4.0, OFL_K_MAX, key), pb=2048,
                        validate_cap="adaptive", device="cuda")
        batch = x.shape[0] // 16
        torch.cuda.synchronize()
        # --- the main path: counts from 0 just before, read just after ---
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        calls = []
        for b in range(16):
            tb = time.perf_counter()
            eng.partial_fit(x[b * batch:(b + 1) * batch])
            torch.cuda.synchronize()
            calls.append(time.perf_counter() - tb)
        flushed = eng.flush()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.ASSIGN_LAUNCHES
        # -----------------------------------------------------------------
        self.ofl_launches = launches
        pool, st = eng.pool, eng.stats
        k = int(pool.count)
        check(launches == eng.n_epochs_dispatched and launches > 0,
              f"ofl: {launches} kernel launches for "
              f"{eng.n_epochs_dispatched} epochs dispatched")
        check(eng.n_processed == x.shape[0] and flushed is None,
              "ofl: every point committed")
        check(not bool(pool.overflow), f"ofl: no overflow at K_max "
              f"{OFL_K_MAX} (K={k})")
        check(1 <= k < OFL_K_MAX and bool(torch.isfinite(pool.centers).all()),
              "ofl: 1 <= K < K_max, finite centers")
        line = {"phase": "ofl", "n": x.shape[0], "d": x.shape[1], "lam": 4.0,
                "k_max": OFL_K_MAX, "pb": 2048, "key": list(key),
                "validate_cap": "adaptive", "batches": 16, "K": k,
                "proposed": int(st.proposed.sum()),
                "accepted": int(st.accepted.sum()),
                "epochs": eng.epochs_done,
                "epochs_dispatched": eng.n_epochs_dispatched,
                "caps": sorted({int(c) for c in st.cap.tolist()}),
                "cap_history": eng.cap_history,
                "n_cap_retries": eng.n_cap_retries, "seconds": seconds,
                "call_seconds": calls, "assign_launches": launches,
                "kernel_replayed": self._replay_kernel(
                    x, 2048, pool, 0, st.accepted, seconds)}
        # the kernel against its plain version at the propose shape, on the
        # stream's last epoch and the trained pool
        self._compare("ofl_trained_pool", x[-2048:], pool.centers, pool.mask,
                      pool.count)
        line["invariants"] = inv = self._ofl_invariants(x[:OFL_INV_N], pool)
        emit(line)
        for name in ("stream_eq_oneshot", "adaptive_eq_full",
                     "logdepth_eq_serial", "occ_eq_serial_ofl",
                     "plain_eq_kernel"):
            check(inv[name], f"ofl: {name}")

    def _ofl_invariants(self, x, warm_pool) -> dict:
        """The port's OFL invariants on the card, bitwise: a stream cut at
        ragged points equals the one-shot run, the adaptive cap equals the
        full cap (two passes from the trained pool, where the cap shrinks),
        the log-depth scan equals the serial one, the OCC run equals
        serial OFL along its epoch-index order (K and centers), and the run
        equals the same run with propose on the plain version (assignments,
        sends, pool and counts)."""
        torch = self.torch
        import numpy as np
        from repro_torch.core import (
            OCCEngine, OFLTransaction, point_uniforms, serial_ofl,
        )
        from repro_torch.core.occ import nearest_center
        from repro_torch.core.ofl import _send_prob

        class PlainOFL(OFLTransaction):
            """The same transaction with propose on the plain version."""
            def propose(self, pool, x_e, u_e):
                d2, idx = nearest_center(pool, x_e, backend="plain")
                return (u_e < _send_prob(d2, self.lam), x_e, (u_e, d2, idx),
                        idx)
        n, key = x.shape[0], (0, self.seed)
        t0 = time.perf_counter()
        secs = {}

        def engine(txn_cls=OFLTransaction, **kw):
            return OCCEngine(txn_cls(4.0, OFL_K_MAX, key), 2048,
                             device="cuda", **kw)
        one = engine().run(x)
        es = engine()
        cuts = (0, 100, 137, 412, 2049, 3001, n)
        parts = [es.partial_fit(x[a:b]) for a, b in zip(cuts, cuts[1:])]
        parts = [p for p in parts + [es.flush()] if p is not None]
        out = {"n": n, "stream_eq_oneshot": bool(
            all(torch.equal(torch.cat([getattr(p, f) for p in parts]),
                            getattr(one, f))
                for f in ("assign", "send", "epoch_of"))
            and _same(es.pool, one.pool)
            and torch.equal(es.stats.proposed, one.stats.proposed))}
        runs = {}
        for name, kw in (("full", {}),
                         ("adaptive", {"validate_cap": "adaptive"})):
            eng = engine(**kw)
            r1 = eng.run(x, pool=warm_pool)
            runs[name] = (r1, eng.run(x, pool=r1.pool), eng)
        out["adaptive_caps"] = runs["adaptive"][2].cap_history
        out["adaptive_eq_full"] = bool(
            runs["adaptive"][2].cap_history[-1] is not None
            and all(_same(a, b) for a, b in
                    zip(runs["full"][:2], runs["adaptive"][:2])))
        secs["stream_and_caps"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        out["logdepth_eq_serial"] = _same(
            one, engine(scan_mode="logdepth").run(x))
        secs["logdepth"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        plain = engine(PlainOFL).run(x)
        out["plain_eq_kernel"] = _same(plain, one)
        out["plain_vs_kernel"] = {
            "K_kernel": int(one.pool.count), "K_plain": int(plain.pool.count),
            "assign_mismatches": int((plain.assign != one.assign).sum()),
            "send_mismatches": int((plain.send != one.send).sum())}
        secs["plain"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        order = torch.as_tensor(np.lexsort((np.arange(n),
                                            one.epoch_of.cpu().numpy())),
                                device=self.dev)
        u = point_uniforms(key, n, device="cuda")
        spool, _ = serial_ofl(x[order], u[order], 4.0, OFL_K_MAX,
                              device="cuda")
        k = int(one.pool.count)
        out["K"] = k
        out["occ_eq_serial_ofl"] = bool(
            int(spool.count) == k
            and torch.equal(spool.centers[:k], one.pool.centers[:k]))
        secs["serial_ofl"] = time.perf_counter() - t1
        out["seconds"] = time.perf_counter() - t0
        out["part_seconds"] = secs
        return out

    # ---------------------------------------------------------- bp_means
    def bp_means(self):
        """OCC BP-means at the paper's width: pass, refine, pass over
        `bp_stick_breaking_data(2**18)` (D = 16, λ = 4, K_max = 512,
        Pb = 2048, adaptive cap), with TF32 off; the Gram-carry scan's
        launches a step; the device's idle share over a warm pass; then the
        port's BP invariants on the card over `BP_INV_N` points."""
        torch = self.torch
        from repro_torch.core import BPMeansTransaction, OCCEngine
        from repro_torch.data import bp_stick_breaking_data
        check(not torch.backends.cuda.matmul.allow_tf32,
              "bp_means: TF32 is off")
        x_np, z_true, _ = bp_stick_breaking_data(BP_N, seed=self.seed)
        x = torch.as_tensor(x_np, device=self.dev)
        txn = BPMeansTransaction(4.0, 512)
        eng = OCCEngine(txn, pb=2048, validate_cap="adaptive", device="cuda")
        z = txn.make_state(x)
        pool = None
        passes = []
        torch.cuda.synchronize()
        for p in range(2):
            e0 = eng.n_epochs_dispatched
            t0 = time.perf_counter()
            res = eng.run(x, pool=pool, state=z)
            torch.cuda.synchronize()
            t_pass = time.perf_counter() - t0
            t0 = time.perf_counter()
            pool = eng.refine(res.pool, x, res.assign)
            torch.cuda.synchronize()
            t_refine = time.perf_counter() - t0
            z = res.assign
            passes.append({
                "pass": p + 1, "seconds": t_pass, "refine_seconds": t_refine,
                "epochs": int(res.stats.proposed.shape[0]),
                "epochs_dispatched": eng.n_epochs_dispatched - e0,
                "K": int(res.pool.count),
                "proposed": int(res.stats.proposed.sum()),
                "accepted": int(res.stats.accepted.sum()),
                "caps": sorted({int(c) for c in res.stats.cap.tolist()}),
                "overflow": bool(res.pool.overflow)})
        k = int(pool.count)
        obj = float(txn.objective(x, z, pool))
        check(not any(p["overflow"] for p in passes), "bp_means: no overflow")
        check(2 <= k < 512, f"bp_means: 2 <= K={k} < 512")
        check(bool(torch.isfinite(pool.centers[:k]).all())
              and math.isfinite(obj), "bp_means: finite features and "
              "objective")
        check(not torch.backends.cuda.matmul.allow_tf32,
              "bp_means: TF32 stayed off")
        line = {"phase": "bp_means", "n": x.shape[0], "d": x.shape[1],
                "lam": 4.0, "k_max": 512, "pb": 2048,
                "validate_cap": "adaptive", "true_features": int(
                    z_true.shape[1]), "K": k, "objective": obj,
                "passes": passes, "n_dispatches": eng.n_dispatches,
                "n_cap_retries": eng.n_cap_retries, "tf32": False,
                "gram_scan": self._gram_scan_launches(x, txn)}
        # the idle share over the first 16 epochs of a warm pass like the
        # last one (every epoch of it does the same work)
        xw, zw = x[:16 * 2048], z[:16 * 2048]
        eng.run(xw, pool=pool, state=zw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run(xw, pool=pool, state=zw)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        line["profiled_epochs"] = 16
        line.update(self._kernel_share(
            lambda: eng.run(xw, pool=pool, state=zw), warm_s))
        line["invariants"] = inv = self._bp_invariants(x[:BP_INV_N])
        emit(line)
        for name in ("gram_eq_refit_reference", "occ_eq_serial_pass",
                     "stream_eq_oneshot"):
            check(inv[name], f"bp_means: {name}")

    def _gram_scan_launches(self, x, txn) -> dict:
        """The Gram-carry validator on the first epoch of a cold pass (the
        epoch with the most proposals), under torch.profiler: device
        kernels and copies per scan step, against its design (a step's
        verdict and its copy to the host, 9 for each refit against a
        feature accepted before it this epoch (cuBLAS's dot is two
        kernels), 2 an append); the rest is the epoch's fixed work.  Host
        syncs are the profile's device-to-host copies, beside the design's
        one a sent step and one an epoch."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.core.occ import precomputed_gather_validate
        x_e = x[:2048]
        pool = txn.init_pool(x_e)
        send, payload, aux, _ = txn.propose(pool, x_e, txn.make_state(x_e))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        precomputed_gather_validate(pool, send, payload, aux,
                                    txn.precompute_accept, txn.accept_pre)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, slots, _, _ = precomputed_gather_validate(
                pool, send, payload, aux, txn.precompute_accept,
                txn.accept_pre)
            torch.cuda.synchronize()
        events = _device_events(prof)
        kernels = sum(c for _, _, c in events)
        # Each read of a device value on the host (`bool()`, `.tolist()`,
        # `nonzero`'s size) is a synchronous device-to-host copy.
        syncs = sum(c for name, _, c in events if "DtoH" in name)
        acc = (slots[send] >= 0).to(torch.int64)
        steps = int(send.sum())
        fits = int((torch.cumsum(acc, 0) - acc).sum())
        return {"epoch": 0, "steps": steps, "accepted": int(acc.sum()),
                "refits": fits, "seconds": wall, "device_kernels": kernels,
                "kernels_per_step": kernels / max(steps, 1),
                "design_kernels": 2 * steps + 9 * fits + 2 * int(acc.sum()),
                "host_syncs": syncs, "design_host_syncs": steps + 1}

    def _bp_invariants(self, x) -> dict:
        """The port's BP invariants on the card: the Gram scan's decisions
        equal the D-dimensional refit reference's (features within 1e-4 of
        the largest), the OCC pass equals the serial pass along its Thm-3.1
        permutation (assignments and K; features within 1e-4 after a
        re-estimate), and a stream with init_mean equals the one-shot run
        bit for bit."""
        torch = self.torch
        from repro_torch.core import (
            BPMeansTransaction, OCCEngine, serial_bp_means_pass,
            thm31_permutation,
        )
        from repro_torch.core._reference import reference_pass
        from repro_torch.core.bp_means import _reestimate
        n, pb, k_max = x.shape[0], 256, 512
        txn = BPMeansTransaction(4.0, k_max)
        t0 = time.perf_counter()
        secs = {}
        pool0, z0 = txn.init_pool(x[:pb]), txn.make_state(x)
        fast = OCCEngine(txn, pb, device="cuda").run(x, pool=pool0, state=z0)
        rp, ra, rs, rst = reference_pass(txn, pool0, x, state=z0, pb=pb)
        scale = max(1.0, float(rp.centers.abs().max()))
        feat_err = float((fast.pool.centers - rp.centers).abs().max())
        out = {"n": n, "pb": pb, "K": int(fast.pool.count),
               "refit_feature_max_abs_err": feat_err}
        out["gram_eq_refit_reference"] = bool(
            torch.equal(fast.assign, ra) and torch.equal(fast.send, rs)
            and torch.equal(fast.stats.proposed, rst.proposed)
            and torch.equal(fast.stats.accepted, rst.accepted)
            and all(torch.equal(getattr(fast.pool, f), getattr(rp, f))
                    for f in ("mask", "count", "overflow"))
            and feat_err <= 1e-4 * scale)
        secs["refit_reference"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        perm = torch.as_tensor(thm31_permutation(fast, n), device=self.dev)
        spool, sz = serial_bp_means_pass(x[perm], 4.0, k_max, pool=pool0,
                                         z=z0, device="cuda")
        k = int(fast.pool.count)
        spool = _reestimate(x[perm], sz, spool)
        fpool = _reestimate(x, fast.assign, fast.pool)
        ser_err = float((spool.centers[:k] - fpool.centers[:k]).abs().max())
        out["serial_feature_max_abs_err"] = ser_err
        out["occ_eq_serial_pass"] = bool(
            int(spool.count) == k and torch.equal(sz, fast.assign[perm])
            and ser_err <= 1e-4)
        secs["serial_pass"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        one = OCCEngine(txn, pb, device="cuda").run(x)
        es = OCCEngine(txn, pb, device="cuda")
        cuts = (0, 1, 100, 1000, 1537, n)
        parts = [es.partial_fit(x[a:b]) for a, b in zip(cuts, cuts[1:])]
        parts = [p for p in parts + [es.flush()] if p is not None]
        out["stream_eq_oneshot"] = bool(
            all(torch.equal(torch.cat([getattr(p, f) for p in parts]),
                            getattr(one, f))
                for f in ("assign", "send", "epoch_of"))
            and _same(es.pool, one.pool))
        secs["stream"] = time.perf_counter() - t1
        out["seconds"] = time.perf_counter() - t0
        out["part_seconds"] = secs
        return out

    # -------------------------------------------------------------- fig3
    def fig3(self):
        """The paper's Figure 3 on the card: the runs of
        `benchmarks/fig3_rejections.run` for repeats 0-2, each run's
        proposed and accepted totals equal to the JAX package's.  The grid,
        each run's settings (entry point, data, λ, k_max, OFL's key) and the
        counts come from the golden file, made on the CPU from the JAX
        package by `tests/test_torch_fig3.py`, which also holds its grid and
        settings to the benchmark."""
        from repro_torch.kernels import ops
        root = os.path.dirname(os.path.abspath(__file__))
        with open(os.path.join(root, "tests", "golden",
                               "torch_fig3_counts.json")) as f:
            golden = json.load(f)
        grid, repeats = golden["grid"], golden["repeats"]
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        cells, bad, epochs = [], [], 0
        for algo in grid["algos"]:
            for pb in grid["pbs"]:
                for n in grid["ns"]:
                    want = golden["runs"][f"{algo}/pb{pb}/n{n}"]
                    got = [_fig3_run(s, pb, n) for s in want["settings"]]
                    if want["settings"][0]["entry"] != "occ_bp_means":
                        epochs += len(repeats) * math.ceil(n / pb)
                    rej = [p - a for p, a in got]
                    mean = sum(rej) / len(rej)
                    cells.append({"algo": algo, "pb": pb, "n": n,
                                  "rejections": rej, "mean": mean,
                                  "le_pb": mean <= pb})
                    for i, (s, (p, a)) in enumerate(zip(want["settings"],
                                                        got)):
                        if [p, a] != [want["proposed"][i],
                                      want["accepted"][i]]:
                            bad.append({"algo": algo, "pb": pb, "n": n,
                                        "repeat": repeats[i], "settings": s,
                                        "port": [p, a],
                                        "jax": [want["proposed"][i],
                                                want["accepted"][i]]})
        launches = ops.ASSIGN_LAUNCHES
        self.fig3_launches = launches
        seconds = time.perf_counter() - t0
        for b in bad[:10]:
            b["min_margin"] = _fig3_margin(b["settings"], b["pb"], b["n"])
        emit({"phase": "fig3", "grid": grid, "repeats": repeats,
              "reduced": f"repeats {repeats[0]}-{repeats[-1]} of the "
                         f"benchmark's {golden['benchmark_repeats']}",
              "runs": len(cells) * len(repeats), "mismatches": bad,
              "cells": cells, "assign_launches": launches,
              "seconds": seconds})
        check(not bad, f"fig3: {len(bad)} runs differ from the JAX package's "
              "counts")
        check(launches == epochs, f"fig3: {launches} kernel launches for "
              f"{epochs} DP-means and OFL epochs")

    # --------------------------------------------------------- retrieval
    def retrieval(self):
        """The retrieval index of `examples/retrieval_index.py`, trained by
        the port's copy of it (`repro_torch.examples.retrieval_index.
        build_index`): 110,000 chunks into a hierarchical store that
        publishes after the stream and after its flush."""
        torch = self.torch
        from repro_torch.examples import retrieval_index
        from repro_torch.kernels import ops
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        built = retrieval_index.build_index(quiet=True, device="cuda")
        launches = ops.ASSIGN_LAUNCHES
        x, store, seconds, eng = built
        self.retrieval_launches = launches
        self.retrieval_built = built
        k = int(eng.pool.count)
        self.index = (x, eng.pool)
        xt = torch.as_tensor(x, device=self.dev)
        check(x.shape == (110_000, 16), "retrieval: 110,000 chunks of 16")
        check(k >= 100_000, f"retrieval: K={k} >= 100000")
        check(not bool(eng.pool.overflow), "retrieval: no overflow")
        # one launch an epoch, and one routing launch (build_hier) a
        # published version
        check(launches == eng.n_epochs_dispatched + len(store)
              and launches > len(store) > 0,
              f"retrieval: {launches} launches for "
              f"{eng.n_epochs_dispatched} epochs and {len(store)} versions")
        replayed = self._replay_kernel(xt, 256, eng.pool, 0,
                                       eng.stats.accepted, seconds)
        emit({"phase": "retrieval", "n": x.shape[0], "d": 16, "lam": 0.05,
              "k_max": 131_072, "pb": 256, "K": k,
              "epochs": eng.epochs_done, "seconds": seconds,
              "versions": len(store), "assign_launches": launches,
              "n_dispatches": eng.n_dispatches,
              "kernel_replayed": replayed})

    # ------------------------------------------------------------- serve
    def serve(self):
        """Serve the retrieval index through the port's serving plane: the
        hierarchical and delta stores, flat top-k, multi-probe top-k
        (p = 4) and score in 64-row microbatches, then the bitwise
        contracts and the comparison with the plain-version service."""
        torch = self.torch
        import threading
        import numpy as np
        from repro_torch.kernels import ops
        from repro_torch.serving import (
            ClusterService, Query, ServeConfig, SnapshotStore,
        )
        from repro_torch.serving import cluster_service as cs
        from repro_torch.serving.snapshot import next_bucket
        if self.index is None:
            self.retrieval()
        chunks, pool = self.index
        bucket, topk, probes = 64, 8, 4
        # --- publication: eager and delta stores, hierarchical layout ----
        t0 = time.perf_counter()
        store = SnapshotStore(hier=True)
        snap = store.publish_pool(pool)
        torch.cuda.synchronize()
        t_eager = time.perf_counter() - t0
        t0 = time.perf_counter()
        store_d = SnapshotStore(delta=True, hier=True)
        store_d.publish_pool(pool)
        dsnap = store_d.latest()
        torch.cuda.synchronize()
        t_delta = time.perf_counter() - t0
        h, hd = snap.hier, dsnap.hier
        check(snap.count >= 100_000 and h.n_cells == 512,
              f"serve: K={snap.count}, {h.n_cells} cells")
        check((dsnap.count, dsnap.capacity, hd.n_cells, hd.shard_cap)
              == (snap.count, snap.capacity, h.n_cells, h.shard_cap)
              and all(torch.equal(a, b) for a, b in (
                  (dsnap.centers, snap.centers), (dsnap.mask, snap.mask),
                  (hd.coarse, h.coarse), (hd.fine, h.fine),
                  (hd.fine_ids, h.fine_ids), (hd.fine_mask, h.fine_mask))),
              "serve: delta-materialized version == eager, hier included, "
              "bitwise")
        self._check_routing(snap)
        # --- queries: perturbed chunks (examples/retrieval_index.py) -----
        q = _perturbed(np, chunks, 256, seed=42)
        qt = torch.as_tensor(q, device=self.dev)
        batches = [q[lo:lo + bucket] for lo in range(0, q.shape[0], bucket)]

        def services(backend):
            """Flat top-k, multi-probe top-k and score, one service each
            so that each audit log holds one kind."""
            cfg = ServeConfig(max_bucket=bucket, backend=backend,
                              audit_log=True)
            return (ClusterService(store, cfg),
                    ClusterService(store, cfg.replace(
                        probes=probes, recall_audit_every=1)),
                    ClusterService(store, cfg))
        warm_flat, warm_mp, warm_score = services("auto")
        warm_flat.topk(batches[0], k=topk)
        warm_mp.topk(batches[0], k=topk)
        warm_score.score(batches[0])
        flat, mp, scorer = services("auto")
        torch.cuda.synchronize()
        # --- the main path: counts from 0 just before, read just after ---
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        r_flat = [flat.topk(b, k=topk) for b in batches]
        r_mp = [mp.topk(b, k=topk) for b in batches]
        r_score = [scorer.score(b) for b in batches]
        seconds = time.perf_counter() - t0
        launches = {"topk_stream": ops.TOPK_LAUNCHES,
                    "topk_multiprobe_stream": ops.TOPK_MP_LAUNCHES,
                    "dpmeans_assign": ops.ASSIGN_LAUNCHES}
        # -----------------------------------------------------------------
        self.main_launches["topk_stream"] = launches["topk_stream"]
        self.main_launches["topk_multiprobe_stream"] = \
            launches["topk_multiprobe_stream"]
        n_b = len(batches)
        mm, mf, ms = mp.metrics(), flat.metrics(), scorer.metrics()
        check(mm["n_topk_multiprobe"] == n_b and mm["topk_recall_audits"] == n_b,
              "serve: every p=4 dispatch went multi-probe and was audited")
        # flat dispatches + (routing + recall audit) per multi-probe one
        check(launches["topk_stream"] == n_b + 2 * n_b,
              f"serve: {launches['topk_stream']} topk_stream launches for "
              f"{n_b} flat and {n_b} multi-probe dispatches")
        check(launches["topk_multiprobe_stream"] == n_b,
              "serve: one topk_multiprobe_stream launch per multi-probe "
              "dispatch")
        check(launches["dpmeans_assign"] == n_b,
              "serve: one dpmeans_assign launch per score dispatch")
        lab_f = np.concatenate([r.labels for r in r_flat])
        sc_f = np.concatenate([r.scores for r in r_flat])
        lab_m = np.concatenate([r.labels for r in r_mp])
        lab_s = np.concatenate([r.labels for r in r_score])
        sc_s = np.concatenate([r.scores for r in r_score])
        check(lab_f.shape == (256, topk) and np.isfinite(sc_f).all()
              and (lab_f >= 0).all() and (lab_f < snap.count).all(),
              "serve: finite (256, 8) answers with valid ids")
        hits = sum(len(set(a) & set(e)) for a, e in zip(lab_m, lab_f))
        res = {"K": snap.count, "capacity": snap.capacity,
               "n_cells": h.n_cells, "shard_cap": h.shard_cap,
               "publish_eager_s": t_eager, "publish_delta_s": t_delta,
               "queries": int(q.shape[0]), "bucket": bucket, "k": topk,
               "probes": probes, "seconds": seconds, "launches": launches,
               f"recall@{topk}_p{probes}_gauge": mm["topk_recall"],
               f"recall@{topk}_p{probes}_all_queries": hits / lab_f.size,
               "shards_probed": mm["topk_shards_probed"],
               "shards_probed_per_dispatch": mm["topk_shards_probed"] / n_b,
               "flat_dispatches": mf["n_dispatches"],
               "score_dispatches": ms["n_dispatches"]}
        # --- bitwise contracts -------------------------------------------
        # (1) top-1 == score
        res["top1_eq_score"] = bool(np.array_equal(lab_f[:, 0], lab_s)
                                    and np.array_equal(sc_f[:, 0], sc_s))
        # (2) multi-probe over the full union == flat (the service routes
        # p >= n_cells to the flat step, so through the ops directly)
        u = h.n_cells
        full = torch.arange(u, dtype=torch.int32, device=self.dev)
        every = torch.ones((bucket, u), dtype=torch.bool, device=self.dev)
        same = True
        for lo in range(0, q.shape[0], bucket):
            xb = qt[lo:lo + bucket].contiguous()
            a = ops.serve_topk_multiprobe(xb, h.fine, h.fine_ids, h.fine_mask,
                                          full, every, topk, u_count=u)
            b = ops.serve_topk(xb, snap.centers, topk, mask=snap.mask,
                               count=snap.count)
            same &= torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        res["full_union_eq_flat"] = bool(same)
        # (3) every DispatchRecord replays to its response
        replay = True
        for svc, resps in ((flat, r_flat), (mp, r_mp), (scorer, r_score)):
            for rec, r in zip(svc.audit[-len(resps):], resps):
                xp = torch.as_tensor(rec.x, device=self.dev)
                if rec.probes:
                    d2, idx, _ = cs._mp_topk_step(
                        h.coarse, h.coarse_mask, h.fine, h.fine_ids,
                        h.fine_mask, xp, rec.n_valid, k=rec.k, p=rec.probes,
                        u_cap=min(u, next_bucket(rec.bucket * rec.probes,
                                                 1)),
                        backend="auto")
                elif rec.kind == "topk":
                    d2, idx = cs._topk_step(snap.centers, snap.mask,
                                            snap.count, xp, rec.n_valid,
                                            k=rec.k, backend="auto")
                else:
                    d2, idx = cs._assign_step(snap.centers, snap.mask,
                                              snap.count, xp, rec.n_valid,
                                              backend="auto")
                n = rec.n_valid
                replay &= (rec.version == r.version
                           and np.array_equal(idx[:n].cpu().numpy(), r.labels)
                           and np.array_equal(d2[:n].cpu().numpy(), r.scores))
        res["audit_replay"] = bool(replay)
        # (4) each request of a coalesced burst == its solo answer
        co = ClusterService(store, ServeConfig(
            max_bucket=bucket, coalesce=True, coalesce_bucket=bucket,
            coalesce_delay_ms=50.0))
        spans = [(0, 13), (13, 40), (40, 41), (41, 64)]
        got: dict = {}

        def client(i, lo, hi, kind):
            got[(i, kind)] = co.submit(
                Query(q[lo:hi], kind=kind, k=topk if kind == "topk" else 0))
        try:
            for kind in ("topk", "score"):
                ts = [threading.Thread(target=client, args=(i, lo, hi, kind))
                      for i, (lo, hi) in enumerate(spans)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join()
        finally:
            co.close()
        burst = len(got) == 2 * len(spans)
        for (i, kind), r in got.items():
            lo, hi = spans[i]
            solo = (flat.topk(q[lo:hi], k=topk) if kind == "topk"
                    else flat.score(q[lo:hi]))
            burst &= (r.version == solo.version
                      and np.array_equal(r.labels, solo.labels)
                      and np.array_equal(r.scores, solo.scores))
        res["coalesced_eq_solo"] = bool(burst)
        res["coalesced_groups"] = co.n_groups
        # (5) a stream restored from a published snapshot == uninterrupted
        res["restore_eq_uninterrupted"] = self._restore_check()
        # --- against the plain-version services on the card --------------
        pflat, pmp, pscore = services("plain")

        def dv(a):
            return torch.as_tensor(a, device=self.dev)
        for r, b in zip(r_flat, batches):
            pr = pflat.topk(b, k=topk)
            self._topk_agree("topk_stream", "serve_flat_vs_plain", dv(b),
                             snap.centers, dv(r.scores), dv(r.labels),
                             dv(pr.scores), dv(pr.labels))
        score_mism = 0
        for r, b in zip(r_score, batches):
            pr = pscore.score(b)
            score_mism += int((r.labels != pr.labels).sum())
            self._topk_agree("dpmeans_assign", "serve_score_vs_plain", dv(b),
                             snap.centers, dv(r.scores)[:, None],
                             dv(r.labels)[:, None], dv(pr.scores)[:, None],
                             dv(pr.labels)[:, None])
        routing_differs = 0
        for r, b in zip(r_mp, batches):
            xb = dv(b)
            ck = ops.serve_topk(xb, h.coarse, probes, mask=h.coarse_mask)[1]
            cp = ops.serve_topk(xb, h.coarse, probes, mask=h.coarse_mask,
                                backend="plain")[1]
            if not torch.equal(ck, cp):
                # a routing near tie changes the union: the routing itself
                # is held to the tie-aware rule instead
                routing_differs += 1
                self._topk_agree(
                    "topk_stream", "serve_routing_vs_plain", xb, h.coarse,
                    *ops.serve_topk(xb, h.coarse, probes, mask=h.coarse_mask),
                    *ops.serve_topk(xb, h.coarse, probes, mask=h.coarse_mask,
                                    backend="plain"))
                continue
            pr = pmp.topk(b, k=topk)
            self._topk_agree("topk_multiprobe_stream", "serve_mp_vs_plain",
                             xb, snap.centers, dv(r.scores), dv(r.labels),
                             dv(pr.scores), dv(pr.labels))
        res["plain_service"] = {"score_label_mismatches": score_mism,
                                "microbatches_with_routing_near_ties":
                                    routing_differs}
        res["latency"] = self._latency(store, chunks, bucket, topk, probes)
        self._time_multiprobe(qt[:bucket].contiguous(), h, probes, topk)
        # the wide route (k > 64) at the same microbatch
        self._time_multiprobe(qt[:bucket].contiguous(), h, probes, 100,
                              shape="serve_multiprobe_k100")
        self._time("serve_score", qt[:bucket].contiguous(), snap.centers,
                   snap.mask, torch.full((1,), snap.count, dtype=torch.int32,
                                         device=self.dev), sibling=True)
        emit({"phase": "serve", **res})
        for key in ("top1_eq_score", "full_union_eq_flat", "audit_replay",
                    "coalesced_eq_solo", "restore_eq_uninterrupted"):
            check(res[key], f"serve: {key}")

    def _check_routing(self, snap):
        """`build_hier`'s routing launch at its real shape (every center
        against the 512 coarse centers): the kernel against the plain
        version by the tie-aware rule, and the index's cells against the
        kernel's labels, so a wrong routing cannot hide behind the
        full-union == flat check (which holds for any partition)."""
        torch = self.torch
        h = snap.hier
        cn = snap.centers[:snap.count].contiguous()
        ones = torch.ones((h.n_cells,), dtype=torch.bool, device=self.dev)
        cnt = torch.full((1,), h.n_cells, dtype=torch.int32, device=self.dev)
        _, label = self._compare("serve_hier_routing", cn, h.coarse, ones, cnt)
        ids = h.fine_ids.long()
        cell = torch.arange(h.n_cells, device=self.dev)[:, None].expand_as(ids)
        cell_of = torch.full((snap.count,), -1, dtype=torch.long,
                             device=self.dev)
        cell_of[ids[h.fine_mask]] = cell[h.fine_mask]
        check(torch.equal(cell_of, label.long()),
              "serve: every center sits in the cell of its kernel label")
        self._time("serve_hier_routing", cn, h.coarse, ones, cnt)

    def _latency(self, store, chunks, bucket, topk, probes) -> dict:
        """Request latency over LAT_REQUESTS fresh perturbed-chunk requests
        of each kind, configured as the retrieval example serves (no audit
        log; the multi-probe service audits recall at every dispatch), the
        kinds interleaved so that drift of the shared host touches all
        three alike.  p50 / p99 from each service's own request
        histogram (exact percentiles below its 8,192-sample limit)."""
        import numpy as np
        from repro_torch.serving import ClusterService, ServeConfig
        q = _perturbed(np, chunks, LAT_REQUESTS * bucket, seed=43)
        cfg = ServeConfig(max_bucket=bucket)
        flat = ClusterService(store, cfg)
        mp = ClusterService(store, cfg.replace(probes=probes,
                                               recall_audit_every=1))
        score = ClusterService(store, cfg)
        t0 = time.perf_counter()
        for lo in range(0, q.shape[0], bucket):
            b = q[lo:lo + bucket]
            flat.topk(b, k=topk)
            mp.topk(b, k=topk)
            score.score(b)
        out = {"requests_per_kind": LAT_REQUESTS, "rows": bucket,
               "seconds": time.perf_counter() - t0}
        for name, svc in (("flat", flat), ("multiprobe", mp),
                          ("score", score)):
            m = svc.metrics()
            check(m["n_dispatches"] == LAT_REQUESTS,
                  f"serve latency: {m['n_dispatches']} {name} dispatches")
            out[f"{name}_p50_ms"] = m["request_p50_ms"]
            out[f"{name}_p99_ms"] = m["request_p99_ms"]
        return out

    def _time_multiprobe(self, xb, h, probes, topk,
                         shape="serve_multiprobe"):
        """The multi-probe kernel at the serving shape: one 64-query
        microbatch, p probes, over the union the index gives it.  The bound
        counts what these inputs need: 2 D operations for each member pair
        (query, valid row of a shard it probes), and one read of x, of the
        probed shards' valid rows and ids and of their masks, plus the
        outputs.  The kernel's own count of the distances it formed (its
        `_stats` hook) must equal the member pairs."""
        torch = self.torch
        from repro_torch.kernels.ref import topk_multiprobe_ref
        from repro_torch.kernels.topk_stream import topk_multiprobe_stream
        from repro_torch.serving import cluster_service as cs
        from repro_torch.serving.snapshot import next_bucket
        b, d = xb.shape
        u_cap = min(h.n_cells, next_bucket(b * probes, 1))
        union, member, n_probed = cs._probe_union(
            h.coarse, h.coarse_mask, xb, b, p=probes, u_cap=u_cap,
            backend="auto")
        uc = n_probed.reshape(1)
        used = int(uc)
        probed = union[:used].long()
        valid = h.fine_mask[probed.clamp_min(0)] & (probed >= 0)[:, None]
        rows = int(valid.sum())
        member_rows = int((member[:, :used].long()
                           * valid.sum(1)[None, :]).sum())
        stats = torch.zeros((2,), dtype=torch.int64, device=self.dev)
        topk_multiprobe_stream(xb, h.fine, h.fine_ids, h.fine_mask, union,
                               member, uc, topk, _stats=stats)
        torch.cuda.synchronize()
        formed = int(stats[0])
        check(formed == member_rows,
              f"multiprobe: the kernel formed {formed} distances for "
              f"{member_rows} member pairs")
        self._time_kernel(
            "topk_multiprobe_stream", shape,
            lambda: topk_multiprobe_stream(xb, h.fine, h.fine_ids,
                                           h.fine_mask, union, member, uc,
                                           topk),
            lambda: topk_multiprobe_ref(xb, h.fine, h.fine_ids, h.fine_mask,
                                        union, member, topk),
            flops=2.0 * d * member_rows,
            nbytes=(4.0 * (b * d + rows * d + rows + 2 * b * topk)
                    + used * h.shard_cap),
            n=b, d=d, probes=probes, u_count=used, u_cap=u_cap,
            candidate_rows=rows, member_pairs=member_rows,
            distances_formed=formed, pair_lists=int(stats[1]),
            shard_cap=h.shard_cap, topk=topk)

    def _restore_check(self) -> bool:
        """On the invariants data (its first 16,384 points, split in two):
        a stream restored from the snapshot published after the first half
        ends bit-identical to the uninterrupted stream."""
        torch = self.torch
        from repro_torch.core import DPMeansTransaction, OCCEngine
        from repro_torch.serving import SnapshotStore
        x = torch.as_tensor(self._dp_data()[:16384], device=self.dev)
        lam, k_max, pb = 4.0, 512, 2048
        store = SnapshotStore()
        eng_a = OCCEngine(DPMeansTransaction(lam, k_max), pb,
                          validate_cap="adaptive", device="cuda",
                          publish=store.publish_pass)
        eng_a.partial_fit(x[:8192])
        snap = store.latest()
        eng_a.partial_fit(x[8192:])
        eng_a.flush()
        eng_b = OCCEngine(DPMeansTransaction(lam, k_max), pb,
                          validate_cap="adaptive", device="cuda")
        eng_b.restore(snap, k_max=k_max)
        warm = eng_b._cap_est == snap.cap_est
        eng_b.partial_fit(x[8192:])
        eng_b.flush()
        return bool(warm and eng_b.n_seen == eng_a.n_seen
                    and eng_b.epochs_done == eng_a.epochs_done
                    and all(torch.equal(a, b) for a, b in
                            zip(eng_a.pool, eng_b.pool)))

    # -------------------------------------------------------- invariants
    def invariants(self):
        torch = self.torch
        from repro_torch.core import (
            DPMeansTransaction, OCCEngine, occ_dp_means,
            serial_dp_means_pass, thm31_permutation,
        )
        from repro_torch.core.dp_means import _lam2
        from repro_torch.core.occ import nearest_center

        class PlainDPMeans(DPMeansTransaction):
            """The same transaction with propose on the plain version."""
            def propose(self, pool, x_e, state_e):
                d2, idx = nearest_center(pool, x_e, backend="plain")
                return d2 > _lam2(self.lam, d2.dtype), x_e, (d2, idx), idx
        x_np = self._dp_data()[:DP_INV_N]
        x = torch.as_tensor(x_np, device=self.dev)
        lam, k_max, pb = 4.0, 512, 2048

        def two_passes(txn_cls=DPMeansTransaction, **kw):
            txn = txn_cls(lam, k_max)
            eng = OCCEngine(txn, pb, device="cuda", **kw)
            r1 = eng.run(x)
            pool = eng.refine(r1.pool, x, r1.assign)
            r2 = eng.run(x, pool=pool)
            pool2 = eng.refine(r2.pool, x, r2.assign)
            return (r1, r2, pool2), eng

        t0 = time.perf_counter()
        full, _ = two_passes()
        again, _ = two_passes()
        adaptive, eng_a = two_passes(validate_cap="adaptive")
        logd, _ = two_passes(scan_mode="logdepth")
        res = {"determinism": _same(full, again),
               "adaptive_eq_full": _same(full, adaptive),
               "logdepth_eq_serial": _same(full, logd),
               "adaptive_caps": eng_a.cap_history,
               "adaptive_retries": eng_a.n_cap_retries}
        # stream in ragged pieces + flush == one-shot first pass
        eng_s = OCCEngine(DPMeansTransaction(lam, k_max), pb, device="cuda")
        parts = [eng_s.partial_fit(x[a:b]) for a, b in
                 ((0, 1000), (1000, 7501), (7501, 11945),
                  (11945, DP_INV_N))]
        parts.append(eng_s.flush())
        parts = [p for p in parts if p is not None]
        r1 = full[0]
        res["stream_eq_oneshot"] = (
            torch.equal(torch.cat([p.assign for p in parts]), r1.assign)
            and torch.equal(torch.cat([p.send for p in parts]), r1.send)
            and torch.equal(torch.cat([p.epoch_of for p in parts]), r1.epoch_of)
            and _same(eng_s.pool, r1.pool)
            and torch.equal(eng_s.stats.proposed, r1.stats.proposed)
            and torch.equal(eng_s.stats.accepted, r1.stats.accepted))
        # Thm 3.1: the OCC pass equals the serial pass along its permutation
        x4 = x[:4096].contiguous()
        occ = occ_dp_means(x4, lam, pb=256, k_max=k_max, device="cuda")
        eng4 = OCCEngine(DPMeansTransaction(lam, k_max), 256, device="cuda")
        r4 = eng4.run(x4)
        pt = torch.as_tensor(thm31_permutation(r4, 4096), device=self.dev)
        spool, sz = serial_dp_means_pass(x4[pt], lam, k_max, device="cuda")
        res["thm31_serial_eq_occ"] = (
            torch.equal(sz, r4.assign[pt]) and _same(spool, r4.pool)
            and torch.equal(occ.z, r4.assign))
        # the CUDA-backed pass vs the same pass on the plain version
        plain, _ = two_passes(PlainDPMeans)
        p1 = plain[0]
        k_eq = int(p1.pool.count) == int(r1.pool.count)
        lab = (p1.assign != r1.assign)
        res["plain_vs_cuda"] = {
            "K_cuda": int(r1.pool.count), "K_plain": int(p1.pool.count),
            "label_mismatches": int(lab.sum()),
            "center_max_abs_diff": float(
                (p1.pool.centers - r1.pool.centers).abs().max()),
            "pass2_label_mismatches": int((plain[1].assign
                                           != full[1].assign).sum())}
        if bool(lab.any()):
            res["plain_vs_cuda"]["diagnosis"] = self._diagnose(
                x, r1, p1, lam)
        res["seconds"] = time.perf_counter() - t0
        emit({"phase": "invariants", "n": x.shape[0], **res})
        for key in ("determinism", "adaptive_eq_full", "logdepth_eq_serial",
                    "stream_eq_oneshot", "thm31_serial_eq_occ"):
            check(res[key], f"invariants: {key}")
        check(k_eq and not bool(lab.any())
              and res["plain_vs_cuda"]["pass2_label_mismatches"] == 0,
              "invariants: CUDA-backed pass == plain pass (K and labels, "
              "both passes)")

    # ----------------------------------------------------------- cluster
    def _ensure_built(self):
        if "build" not in self.phase_seconds:
            self.build()
            self.phase_seconds["build"] = 0.0

    def cluster(self):
        """The paper's P-machine OCC as real processes on the card
        (`launch/occ_cluster.run_cluster`): 4 propose workers, each running
        `dpmeans_assign` on its 512-point shard of every 2048-point epoch,
        a serializing master, a follower from the start and a late joiner,
        audited field by field against the fused `OCCEngine.run`; then a
        worker killed at epoch 4 (audited against the same masking in one
        process), then the telemetry check."""
        from repro_torch.kernels import ops
        from repro_torch.launch.occ_cluster import ClusterConfig, run_cluster
        self._ensure_built()
        base = dict(dim=16, lam=4.0, k_max=512, pb=2048, n_workers=4,
                    n_followers=1, validate_cap=None, seed=self.seed,
                    quiet=True, device="cuda")
        # --- the main path: counts from 0 just before, read just after ---
        ops.reset_launch_counts()
        try:
            with tempfile.TemporaryDirectory() as tmp:
                rec = run_cluster(ClusterConfig(
                    n=CLUSTER_N, trace_out=os.path.join(tmp, "master.json"),
                    **base))
        except AssertionError as e:
            raise CheckFailed(f"cluster: audit failed: {e}")
        master = ops.ASSIGN_LAUNCHES
        # -----------------------------------------------------------------
        workers = [r["assign_launches"] for r in rec["worker_reports"]]
        epochs = rec["epochs"]
        self.cluster_launches = {"master": master, "workers": workers,
                                 "total": master + sum(workers)}
        check(rec["device"].startswith("cuda"), "cluster: ran on the card")
        check(all(rec["bit_identical"].values()),
              f"cluster: bit-identical audit {rec['bit_identical']}")
        check(master == epochs and workers == [epochs] * 4,
              f"cluster: dpmeans_assign launches master {master}, workers "
              f"{workers} for {epochs} epochs")
        split = rec["master_span_s"]
        emit({"phase": "cluster", "n": CLUSTER_N, "pb": 2048, "k_max": 512,
              "lam": 4.0, "workers": 4, "epochs": epochs,
              "K": rec["k_final"], "versions": rec["versions_published"],
              "wall_s": rec["wall_s"], "setup_s": rec["setup_s"],
              "pass_s": rec["pass_s"], "teardown_s": rec["teardown_s"],
              "fused_pass_s": rec["ref_pass_s"],
              "master_wait_proposals_s": split["engine.propose"],
              "master_validate_s": split["engine.validate"],
              "master_validate_share": split["engine.validate"]
              / max(rec["pass_s"], 1e-9),
              "worker_propose_ms": [r["propose_ms"]
                                    for r in rec["worker_reports"]],
              "worker_propose_ms_p50": [r["propose_ms_p50"]
                                        for r in rec["worker_reports"]],
              "assign_launches": self.cluster_launches,
              "delta_bytes_per_publish": rec["delta_bytes_per_publish"],
              "ack_p50_ms": rec["ack_p50_ms"], "ack_p99_ms": rec["ack_p99_ms"],
              "n_acks": rec["n_acks"], "bootstraps": rec["n_bootstraps"],
              "followers": rec["followers"],
              "follower_digests_match": rec["follower_digests_match"],
              "late_joiners_bootstrapped": rec["late_joiners_bootstrapped"],
              "bit_identical": all(rec["bit_identical"].values()),
              "straggler_events": len(rec["straggler_events"])})
        try:
            # no late joiner here: the run above has one, and its start-up
            # would outlast this 16-epoch pass
            chaos = run_cluster(ClusterConfig(
                n=CLUSTER_SMALL_N, die_worker=1, die_epoch=4,
                late_follower=False, **base))
        except AssertionError as e:
            raise CheckFailed(f"cluster chaos: audit failed: {e}")
        check(chaos["worker_deaths"] == {1: 4},
              f"cluster chaos: deaths {chaos['worker_deaths']}")
        emit({"phase": "cluster_chaos", "n": CLUSTER_SMALL_N,
              "epochs": chaos["epochs"], "K": chaos["k_final"],
              "worker_deaths": chaos["worker_deaths"],
              "worker_exitcodes": chaos["worker_exitcodes"],
              "bit_identical_to_masked_reference":
                  all(chaos["bit_identical"].values()),
              "follower_digests_match": chaos["follower_digests_match"],
              "wall_s": chaos["wall_s"], "setup_s": chaos["setup_s"],
              "pass_s": chaos["pass_s"], "teardown_s": chaos["teardown_s"]})
        self._telemetry_check()

    def _telemetry_check(self):
        """The fused pass with and without `obs` (a registry and a tracer):
        equal outputs and `dpmeans_assign` launches; `_export_pass`'s host
        time against the pass's (it is timed after a synchronize, so the
        wait for the pass's tail is not counted as export); the wall
        difference over three alternating pairs, printed, not gated."""
        torch = self.torch
        from repro_torch.core import DPMeansTransaction, OCCEngine
        from repro_torch.data import dp_stick_breaking_data
        from repro_torch.kernels import ops
        from repro_torch.obs import Obs, Tracer
        x = torch.as_tensor(dp_stick_breaking_data(
            TELEMETRY_N, dim=16, seed=self.seed)[0], device=self.dev)
        txn = DPMeansTransaction(4.0, 512)

        def one(with_obs):
            obs = Obs(tracer=Tracer("chip_smoke")) if with_obs else None
            eng = OCCEngine(txn, pb=2048, obs=obs, device="cuda")
            export = []
            if with_obs:
                real = eng._export_pass

                def timed(res, t0):
                    torch.cuda.synchronize()
                    a = time.perf_counter()
                    real(res, t0)
                    export.append(time.perf_counter() - a)
                eng._export_pass = timed
            torch.cuda.synchronize()
            l0 = ops.ASSIGN_LAUNCHES
            t0 = time.perf_counter()
            res = eng.run(x)
            torch.cuda.synchronize()
            return (res, time.perf_counter() - t0, ops.ASSIGN_LAUNCHES - l0,
                    export)
        runs = [one(w) for _ in range(3) for w in (False, True)]
        off, on = runs[0::2], runs[1::2]
        same = all(_same(a[0], b[0]) and torch.equal(a[0].stats.cap,
                                                     b[0].stats.cap)
                   for a, b in zip(off, on))
        launches = [r[2] for r in runs]
        shares = [100 * r[3][0] / r[1] for r in on]
        emit({"phase": "telemetry", "n": TELEMETRY_N,
              "outputs_equal": same, "assign_launches": launches,
              "pass_s_without_obs": [r[1] for r in off],
              "pass_s_with_obs": [r[1] for r in on],
              "export_s": [r[3][0] for r in on],
              "export_pct_of_pass": shares,
              "limit_pct": OBS_OVERHEAD_LIMIT_PCT,
              "with_minus_without_s": [b[1] - a[1] for a, b in zip(off, on)]})
        check(same, "telemetry: outputs equal with and without obs")
        check(len(set(launches)) == 1 and launches[0] > 0,
              f"telemetry: dpmeans_assign launches {launches}")
        check(max(shares) < OBS_OVERHEAD_LIMIT_PCT,
              f"telemetry: export takes {max(shares):.3f} % of a pass")

    # ---------------------------------------------------------------- ha
    def ha(self):
        """Crash-recoverable OCC on the card (`launch/ha_cluster`): 3 nodes,
        2 workers, the term-1 master killed right after version 8 is
        replicated; one promotion, resume at epoch 8, every epoch digest,
        stats triple, the final store and the follower equal to the
        uninterrupted single-process pass, and the promoted master's WAL
        recovered to the final store's digest."""
        from repro_torch.kernels import ops
        from repro_torch.launch.ha_cluster import HAConfig, run_ha_cluster
        self._ensure_built()
        # --- the main path: counts from 0 just before, read just after ---
        ops.reset_launch_counts()
        try:
            with tempfile.TemporaryDirectory() as wal_dir:
                rec = run_ha_cluster(HAConfig(
                    n=CLUSTER_SMALL_N, dim=16, lam=4.0, k_max=512, pb=2048,
                    n_workers=2, n_nodes=3, kill_master_after_version=8,
                    wal_dir=wal_dir, seed=self.seed, quiet=True,
                    device="cuda"))
        except AssertionError as e:
            raise CheckFailed(f"ha: audit failed: {e}")
        driver = ops.ASSIGN_LAUNCHES
        # -----------------------------------------------------------------
        workers = [r["assign_launches"]
                   for r in rec["final_term_worker_reports"]]
        self.ha_launches = {"driver": driver, "workers": workers,
                            "total": driver + sum(workers)}
        emit({"phase": "ha", "n": CLUSTER_SMALL_N, "pb": 2048, "nodes": 3,
              "workers": 2, "epochs": rec["epochs"], "K": rec["k_final"],
              "promotions": rec["promotions"], "terms": rec["terms"],
              "resume_epoch": rec["resume_epoch"],
              "master_node_final": rec["master_node_final"],
              "epoch_digests_match": rec["epoch_digests_match"],
              "epoch_stats_match": rec["epoch_stats_match"],
              "final_digest_match": rec["final_digest_match"],
              "follower_digests_match": rec["follower_digests_match"],
              "wal_recovered_digest_match": rec["wal_digest_match"],
              "wal_recover_s": rec["wal_recover_s"],
              "assign_launches": self.ha_launches,
              "final_term_ack_p50_ms": rec["final_term_metrics"]["ack_p50_ms"],
              "final_term_ack_p99_ms": rec["final_term_metrics"]["ack_p99_ms"],
              "wall_s": rec["wall_s"]})
        check(rec["promotions"] == 1 and rec["terms"] == [1, 2]
              and rec["resume_epoch"] == 8, "ha: one promotion, resume at 8")
        check(rec["epoch_digests_match"] and rec["epoch_stats_match"]
              and rec["final_digest_match"]
              and all(rec["follower_digests_match"]), "ha: digests match")
        check(rec["wal_digest_match"] is True,
              "ha: the WAL recovers the final store")
        check(driver == rec["epochs"]
              and workers == [rec["epochs"]] * 2,
              f"ha: dpmeans_assign launches driver {driver}, workers "
              f"{workers}")

    def _diagnose(self, x, rc, rp, lam):
        """For label mismatches, how close each point's distance came to λ²
        or to its second-nearest center (a near tie)."""
        torch = self.torch
        from repro_torch.core.objective import sq_dists
        idx = torch.nonzero(rc.assign != rp.assign).flatten()[:20]
        out = []
        for i in idx.tolist():
            dm = sq_dists(x[i:i + 1], rc.pool.centers)[0]
            dm = torch.where(rc.pool.mask, dm, torch.inf)
            two = torch.topk(dm, min(2, dm.numel()), largest=False).values
            out.append({"i": i, "cuda": int(rc.assign[i]),
                        "plain": int(rp.assign[i]),
                        "d2_two_nearest": [float(v) for v in two],
                        "lam2": lam * lam})
        return out

    # -------------------------------------------------- language model
    def _lm_agree(self, kernel, case, got, want, quiet=False):
        """A language-model kernel's output against its plain version's on
        the same inputs: f32 within LM_TOL_F32 * max(1, max |plain|), bf16
        within one bf16 ulp at max |plain|.  Returns (err, tol); `quiet`
        leaves the JSON line to the caller."""
        torch = self.torch
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{kernel} {case}: shape and dtype")
        check(bool(torch.isfinite(got).all()), f"{kernel} {case}: finite")
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        if got.dtype == torch.float32:
            tol = LM_TOL_F32[kernel] * max(1.0, scale)
        else:   # one ulp: 7 mantissa bits in bf16, 10 in f16
            bits = 10 if got.dtype == torch.float16 else 7
            tol = 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - bits)
        check(err <= tol, f"{kernel} {case}: max abs err {err} > {tol}")
        self.max_abs_err[kernel] = max(self.max_abs_err[kernel], err)
        if not quiet:
            emit({"phase": "lm_kernels", "kernel": kernel, "case": case,
                  "dtype": str(got.dtype).replace("torch.", ""),
                  "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30),
                  "tol": tol})
        return err, tol

    def lm_kernels(self):
        """flash_attention, rmsnorm and swiglu against their plain versions
        (f32 and bf16; GQA groups 1/4/8, causal and not, S = 128, 4096 and
        100), the bf16 tensor-core flash kernel over every head dim (the
        sweep of `_flash_sweep`), both rmsnorm kernels at the dense widths,
        the compiled code (ptxas registers and spills; HGMMA and UTMALDG in
        the flash library's SASS), what their wrappers refuse, and their
        times at the qwen3-4b serving shapes beside the bound, the plain
        version and the library call (with the SDPA backend named)."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        from repro_torch.kernels.flash_attention import flash_attention
        from repro_torch.kernels.rmsnorm import rmsnorm
        from repro_torch.kernels.swiglu import swiglu
        g = torch.Generator(device=self.dev).manual_seed(self.seed + 300)
        f32, bf16 = torch.float32, torch.bfloat16

        def randn(shape, dt, mul=1.0):
            return (torch.randn(shape, generator=g, device=self.dev)
                    * mul).to(dt)
        with torch.inference_mode():
            for dt in (f32, bf16):
                tag = "f32" if dt == f32 else "bf16"
                for group in (1, 4, 8):
                    for b, s in ((2, 128), (1, 4096), (3, 100)):
                        q = randn((b, 8, s, 128), dt)
                        k = randn((b, 8 // group, s, 128), dt)
                        v = randn((b, 8 // group, s, 128), dt)
                        for causal in (True, False):
                            self._lm_agree(
                                "flash_attention",
                                f"{tag} g{group} S{s} causal={causal}",
                                flash_attention(q, k, v, causal=causal),
                                ref.flash_attention_ref(q, k, v, causal))
                # (B, S, H, Dh) projections read in place through
                # transposed views, Dh 64, an explicit scale
                q = randn((2, 256, 4, 64), dt).transpose(1, 2)
                k = randn((2, 256, 2, 64), dt).transpose(1, 2)
                v = randn((2, 256, 2, 64), dt).transpose(1, 2)
                self._lm_agree("flash_attention", f"{tag} strided Dh64",
                               flash_attention(q, k, v, scale=0.2),
                               ref.flash_attention_ref(q, k, v, scale=0.2))
                # zamba2-7b's Dh 112 (the tensor-core kernel runs the
                # Dh-128 tile on TMA's zero fill), its (B, S, H, Dh) views
                for causal in (True, False):
                    q, k, v = (randn((2, 384, 8, 112), dt).transpose(1, 2)
                               for _ in range(3))
                    self._lm_agree("flash_attention",
                                   f"{tag} Dh112 S384 causal={causal}",
                                   flash_attention(q, k, v, causal=causal),
                                   ref.flash_attention_ref(q, k, v, causal))
                for shape in ((16384, 2560), (4, 2560), (2, 3, 2560),
                              (16384, 3584), (16384, 1024), (4, 1024),
                              (7, 33)):
                    x, w = randn(shape, dt), randn(shape[-1:], dt)
                    self._lm_agree("rmsnorm", f"{tag} {shape}",
                                   rmsnorm(x, w, 1e-6),
                                   ref.rmsnorm_ref(x, w, 1e-6))
                for shape in ((16384, 9728), (4, 9728), (16384, 14336),
                              (5, 17)):
                    a, u = randn(shape, dt, 3.0), randn(shape, dt)
                    self._lm_agree("swiglu", f"{tag} {shape}", swiglu(a, u),
                                   ref.swiglu_ref(a, u))
                flat = randn((1001,), dt, 3.0)
                a, u = flat[1:], randn((1000,), dt)    # a misaligned view
                self._lm_agree("swiglu", f"{tag} misaligned", swiglu(a, u),
                               ref.swiglu_ref(a, u))
        # What the wrappers refuse (outside inference mode, so that a
        # tensor needing a gradient is seen as one).
        q = randn((1, 8, 128, 128), bf16)
        k = randn((1, 2, 128, 128), bf16)
        x, w = randn((4, 2560), bf16), randn((2560,), bf16)
        wg = w.clone().requires_grad_(True)
        for what, call, exc in (
                ("H % Hkv", lambda: flash_attention(q[:, :7], k, k),
                 ValueError),
                ("S=200", lambda: flash_attention(
                    randn((1, 8, 200, 128), bf16),
                    randn((1, 2, 200, 128), bf16),
                    randn((1, 2, 200, 128), bf16)), ValueError),
                ("Dh=48", lambda: flash_attention(q[..., :48].contiguous(),
                                                  k[..., :48].contiguous(),
                                                  k[..., :48].contiguous()),
                 ValueError),
                ("swiglu f16", lambda: swiglu(x.half(), x.half()), TypeError),
                ("flash_attention f16",
                 lambda: flash_attention(q.half(), k.half(), k.half()),
                 TypeError),
                ("mixed dtypes", lambda: swiglu(x, x.float()), TypeError),
                ("weight shape", lambda: rmsnorm(x, w[:7]), ValueError),
                ("shape mismatch", lambda: swiglu(x, x[:3]), ValueError),
                ("needs a gradient", lambda: rmsnorm(x, wg), RuntimeError),
                ("cpu tensor on the cuda backend",
                 lambda: ops.swiglu(x.cpu(), x.cpu(), backend="cuda"),
                 ValueError)):
            try:
                call()
            except exc:
                continue
            raise CheckFailed(f"lm_kernels: {what} must raise {exc.__name__}")
        emit({"phase": "lm_kernels", "raises": True,
              "max_abs_err": {n: self.max_abs_err[n] for n in
                              ("flash_attention", "rmsnorm", "swiglu")}})
        self._rmsnorm_f16()
        self._flash_sweep(randn)
        self._rmsnorm_kernels(randn)
        self._compiled_code()
        self._time_lm_kernels(randn)
        self._bwd_kernels()

    def _rmsnorm_f16(self):
        """rmsnorm on float16 against its plain version: within 1e-2 (the
        reference's f16 bar) at dense widths (16384, 2560 and 16384, 1024,
        the one-read kernel), at decode (4, 2560) and at a width of the
        two-pass kernel (7, 33).  Weights near 1, as a trained norm's are, keep the outputs
        below 8, where one f16 ulp is under the bar."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.rmsnorm import rmsnorm_launch
        g = torch.Generator(device=self.dev).manual_seed(self.seed + 310)
        with torch.inference_mode():
            for shape in ((16384, 2560), (4, 2560), (16384, 1024), (7, 33)):
                x = torch.randn(shape, generator=g, device=self.dev).half()
                w = (0.5 + torch.rand(shape[-1:], generator=g,
                                      device=self.dev)).half()
                got, packs = rmsnorm_launch(x, w, 1e-6)
                want = ref.rmsnorm_ref(x, w, 1e-6)
                torch.cuda.synchronize()
                check(got.dtype == torch.float16
                      and bool(torch.isfinite(got).all()),
                      f"rmsnorm f16 {shape}: finite f16")
                err = float((got.float() - want.float()).abs().max())
                check(err <= 1e-2, f"rmsnorm f16 {shape}: max abs err {err}"
                      " > 1e-2")
                self.max_abs_err["rmsnorm"] = max(
                    self.max_abs_err["rmsnorm"], err)
                emit({"phase": "lm_kernels", "kernel": "rmsnorm",
                      "case": f"f16 {shape}", "packs": packs,
                      "max_abs_err": err, "tol": 1e-2})

    def _flash_sweep(self, randn):
        """The bf16 tensor-core flash kernel against its plain version, each
        case within one bf16 ulp at the output's largest magnitude: every
        Dh of HEAD_DIMS, causal and full, GQA groups 1, 2 and 4, S = 16, 48,
        128 and 384 (below, at and over one 128-row tile), contiguous
        inputs and transposed (B, S, H, Dh) views; then S = 4096 at Dh 128.
        One line per Dh with its worst case."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.flash_attention import HEAD_DIMS, flash_attention
        bf16 = torch.bfloat16

        def case(dh, causal, group, s, layout, b=2, h=4, tight=False):
            hkv = h // group
            if layout == "contiguous":
                q, k, v = (randn((b, h, s, dh), bf16),
                           randn((b, hkv, s, dh), bf16),
                           randn((b, hkv, s, dh), bf16))
            else:
                q, k, v = (randn((b, s, h, dh), bf16).transpose(1, 2),
                           randn((b, s, hkv, dh), bf16).transpose(1, 2),
                           randn((b, s, hkv, dh), bf16).transpose(1, 2))
            name = f"bf16 Dh{dh} S{s} g{group} causal={causal} {layout}"
            got = flash_attention(q, k, v, causal)
            want = ref.flash_attention_ref(q, k, v, causal)
            err, tol = self._lm_agree("flash_attention", name, got, want,
                                      quiet=True)
            if tight:
                tights.append(self._flash_tight(name, q, k, v, causal, got,
                                                want))
            return err / tol, name

        with torch.inference_mode():
            n = 0
            for dh in HEAD_DIMS:
                worst = (0.0, "")
                for causal in (True, False):
                    for group in (1, 2, 4):
                        for s in (16, 48, 128, 384):
                            for layout in ("contiguous", "transposed"):
                                worst = max(worst, case(dh, causal, group, s,
                                                        layout))
                                n += 1
                emit({"phase": "lm_kernels", "kernel": "flash_attention",
                      "sweep_dh": dh, "cases": 48,
                      "worst_err_over_tol": worst[0], "worst_case": worst[1]})
            worst = (0.0, "")
            tights = []
            for causal in (True, False):
                for group in (1, 2, 4):
                    for layout in ("contiguous", "transposed"):
                        worst = max(worst, case(128, causal, group, 4096,
                                                layout, b=1, h=8, tight=True))
                        n += 1
            emit({"phase": "lm_kernels", "kernel": "flash_attention",
                  "sweep_dh": 128, "s": 4096, "cases": 12,
                  "worst_err_over_tol": worst[0], "worst_case": worst[1],
                  "sweep_cases": n,
                  "worst_row_err_over_row_ulp": max(
                      t["row_err_over_row_ulp"] for t in tights),
                  "worst_rel_err_over_control": max(
                      t["rel_err"] / t["control_rel_err"] for t in tights),
                  "tight": tights})

    def _flash_tight(self, case, q, k, v, causal, got, want) -> dict:
        """Two readings of bf16 flash at long S, beside `_lm_agree`'s bar
        (one bf16 ulp at the whole output's largest magnitude), which at
        S = 4096 causal is about as large as the late rows' values: those
        rows average thousands of keys.  Each must hold:
          * every output row within one bf16 ulp at that row's own largest
            |plain| value;
          * the relative error ||got - plain|| / ||plain|| at most twice a
            control's: the plain version with P rounded to bf16 before P·V
            (the kernel's one arithmetic difference), whose error is what
            that rounding alone costs."""
        torch = self.torch
        w = want.float()
        d = got.float() - w
        row_max = w.abs().amax(-1)
        row_ulp = torch.exp2(torch.floor(torch.log2(
            row_max.clamp_min(1e-30))) - 7)
        row_ratio = float((d.abs().amax(-1) / row_ulp).max())
        del d
        rel = float(torch.linalg.vector_norm(got.float() - w)
                    / torch.linalg.vector_norm(w))
        ctrl = _flash_bf16_p(torch, q, k, v, causal)
        rel_c = float(torch.linalg.vector_norm(ctrl.float() - w)
                      / torch.linalg.vector_norm(w))
        del ctrl, w
        check(row_ratio <= 1.0,
              f"flash_attention {case}: a row is {row_ratio} of one bf16 ulp "
              "at its own largest value")
        check(rel <= 2.0 * rel_c,
              f"flash_attention {case}: relative error {rel} > twice the "
              f"bf16-P control's {rel_c}")
        return {"case": case, "row_err_over_row_ulp": row_ratio,
                "rel_err": rel, "control_rel_err": rel_c}

    def _rmsnorm_kernels(self, randn):
        """Both rmsnorm kernels against the plain version at the dense
        widths the one-read kernel is compiled for and at one it is not
        (1000), f32 and bf16, 333 rows, with the kernel each launch reports
        it ran; then both kernels timed at every dense width, (16384, D)
        and (4, D), where the wrapper's choice is read against the faster.
        The two-pass kernel is reached at the dense widths through the
        wrapper's private hook `_two_pass`."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.rmsnorm import (
            ONE_READ_WIDTHS, _two_pass, one_read_packs, rmsnorm_launch)
        with torch.inference_mode():
            for dt in (torch.float32, torch.bfloat16):
                tag = "f32" if dt == torch.float32 else "bf16"
                for d in ONE_READ_WIDTHS + (1000,):
                    x, w = randn((333, d), dt), randn((d,), dt)
                    want = ref.rmsnorm_ref(x, w, 1e-6)
                    out, packs = rmsnorm_launch(x, w, 1e-6)
                    check(packs == one_read_packs(d, x.element_size(), True),
                          f"rmsnorm: width {d} {tag} launched the kernel of "
                          f"{packs} packs a lane")
                    kind = f"one-read ({packs} packs a lane)" if packs \
                        else "two-pass"
                    self._lm_agree("rmsnorm", f"{tag} (333, {d}) {kind}",
                                   out, want)
                    if packs:
                        self._lm_agree("rmsnorm",
                                       f"{tag} (333, {d}) two-pass",
                                       _two_pass(x, w, 1e-6), want)
            rows = []
            for dt in (torch.float32, torch.bfloat16):
                for d in ONE_READ_WIDTHS:
                    for n in (16384, 4):
                        x, w = randn((n, d), dt), randn((d,), dt)
                        chosen = rmsnorm_launch(x, w, 1e-6)[1]
                        one = _queued_ms(torch, lambda: rmsnorm_launch(
                            x, w, 1e-6))[0]
                        two = _queued_ms(torch, lambda: _two_pass(
                            x, w, 1e-6))[0]
                        rows.append({
                            "dtype": str(dt).replace("torch.", ""),
                            "x": [n, d], "chosen": "one-read" if chosen
                            else "two-pass", "one_read_ms": one,
                            "two_pass_ms": two,
                            "bound_ms": x.element_size() * (2 * x.numel() + d)
                            / PEAK_HBM_BYTES * 1e3})
        emit({"phase": "lm_kernels", "kernel": "rmsnorm",
              "one_read_vs_two_pass": rows})

    def _compiled_code(self):
        """ptxas's registers and spills for every kernel of the flash and
        rmsnorm libraries (from the build log; a spill in rmsnorm's fails
        the phase), and the flash library's SASS: the tensor-core kernel
        must contain wgmma (HGMMA) and TMA loads (UTMALDG), else the phase
        fails."""
        from repro_torch.kernels import _build
        paths = _build.build_all(["flash_attention", "rmsnorm"])
        res = {"flash_attention": _ptxas_summary(
            _build.BUILD_LOG.get("flash_attention", {}).get("ptxas", "")),
            # rmsnorm's kernels (the one-read backward's 64 registers among
            # them) must not spill
            "rmsnorm": self._ptxas_checked("rmsnorm")}
        cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()),
                                 "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass",
                               str(paths["flash_attention"])],
                              capture_output=True, text=True, timeout=300)
        check(sass.returncode == 0,
              f"cuobjdump -sass failed: {sass.stderr.strip()[:500]}")
        counts = {op: sass.stdout.count(op) for op in ("HGMMA", "UTMALDG")}
        check(all(counts.values()),
              f"flash_attention SASS lacks wgmma or TMA loads: {counts}")
        emit({"phase": "lm_kernels", "ptxas": res, "flash_sass": counts})

    def _time_lm_kernels(self, randn):
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import ref
        from repro_torch.kernels.flash_attention import flash_attention
        from repro_torch.kernels.rmsnorm import _two_pass, rmsnorm
        from repro_torch.kernels.swiglu import swiglu
        bf16 = torch.bfloat16
        with torch.inference_mode():
            b, h, hkv, s, dh = 4, 32, 8, 4096, 128
            # (B, H, S, Dh) views of (B, S, H, Dh) projections, as
            # attention_train passes them, checked at this shape first
            q = randn((b, s, h, dh), bf16).transpose(1, 2)
            k = randn((b, s, hkv, dh), bf16).transpose(1, 2)
            v = randn((b, s, hkv, dh), bf16).transpose(1, 2)
            want = ref.flash_attention_ref(q, k, v)
            got = flash_attention(q, k, v)
            case = (f"bf16 prefill {list(q.shape)} / {list(k.shape)} "
                    "transposed views")
            self._lm_agree("flash_attention", case, got, want)
            emit({"phase": "lm_kernels", "kernel": "flash_attention",
                  **self._flash_tight(case, q, k, v, True, got, want)})
            del want, got
            torch.cuda.empty_cache()
            flops = 2.0 * s * s * dh * b * h     # both products, causal half
            self._time_kernel(
                "flash_attention", "prefill",
                lambda: flash_attention(q, k, v),
                lambda: ref.flash_attention_ref(q, k, v),
                flops=flops, nbytes=2.0 * (2 * q.numel() + 2 * k.numel()),
                peak_flops=PEAK_BF16_FLOPS,
                library=lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True),
                q=list(q.shape), kv=list(k.shape), dtype="bfloat16",
                causal=True, bound_ms_f32_cores=flops / PEAK_F32_FLOPS * 1e3,
                kernel_design="wgmma + TMA (bf16 tensor cores)",
                sdpa=self._sdpa_backends(q, k, v))
            del q, k, v
            torch.cuda.empty_cache()
            for shape, rows in (("prefill", 16384), ("decode", 4)):
                x, w = randn((rows, 2560), bf16), randn((2560,), bf16)
                for tag, two_pass in (("", False), (" two-pass", True)):
                    self._time_kernel(
                        "rmsnorm", shape + tag,
                        (lambda: _two_pass(x, w, 1e-6)) if two_pass
                        else (lambda: rmsnorm(x, w, 1e-6)),
                        lambda: ref.rmsnorm_ref(x, w, 1e-6),
                        flops=4.0 * x.numel(),
                        nbytes=2.0 * (2 * x.numel() + w.numel()),
                        library=lambda: F.rms_norm(x, (2560,), w, 1e-6),
                        x=list(x.shape), dtype="bfloat16",
                        kernel_design="two passes" if two_pass
                        else "one read")
                a, u = randn((rows, 9728), bf16, 3.0), randn((rows, 9728), bf16)
                self._time_kernel(
                    "swiglu", shape, lambda: swiglu(a, u),
                    lambda: ref.swiglu_ref(a, u), flops=5.0 * a.numel(),
                    nbytes=2.0 * 3 * a.numel(), gate=list(a.shape),
                    dtype="bfloat16")
            del x, w, a, u
            torch.cuda.empty_cache()
            # zamba2-7b's prefill shapes: its shared attention (4, 32/32,
            # 4096, 112), its d_model 3584 and its d_ff 14336
            b, h, s, dh = 4, 32, 4096, 112
            q, k, v = (randn((b, s, h, dh), bf16).transpose(1, 2)
                       for _ in range(3))
            case = f"bf16 zamba2 prefill {list(q.shape)} transposed views"
            got, want = flash_attention(q, k, v), ref.flash_attention_ref(
                q, k, v)
            self._lm_agree("flash_attention", case, got, want)
            emit({"phase": "lm_kernels", "kernel": "flash_attention",
                  **self._flash_tight(case, q, k, v, True, got, want)})
            del got, want
            torch.cuda.empty_cache()
            flops = 2.0 * s * s * dh * b * h     # both products, causal half
            self._time_kernel(
                "flash_attention", "zamba2_prefill",
                lambda: flash_attention(q, k, v),
                lambda: ref.flash_attention_ref(q, k, v),
                flops=flops, nbytes=2.0 * 4 * q.numel(),
                peak_flops=PEAK_BF16_FLOPS,
                library=lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True),
                q=list(q.shape), kv=list(k.shape), dtype="bfloat16",
                causal=True, sdpa=self._sdpa_backends(q, k, v),
                kernel_design="the Dh-128 tile on TMA's zero fill (P V "
                              "n128: 14 % more tensor-core work)")
            del q, k, v
            torch.cuda.empty_cache()
            x, w = randn((16384, 3584), bf16), randn((3584,), bf16)
            self._time_kernel(
                "rmsnorm", "zamba2_prefill", lambda: rmsnorm(x, w, 1e-6),
                lambda: ref.rmsnorm_ref(x, w, 1e-6), flops=4.0 * x.numel(),
                nbytes=2.0 * (2 * x.numel() + w.numel()),
                library=lambda: F.rms_norm(x, (3584,), w, 1e-6),
                x=list(x.shape), dtype="bfloat16", kernel_design="one read")
            a, u = randn((16384, 14336), bf16, 3.0), randn((16384, 14336),
                                                         bf16)
            self._time_kernel(
                "swiglu", "zamba2_prefill", lambda: swiglu(a, u),
                lambda: ref.swiglu_ref(a, u), flops=5.0 * a.numel(),
                nbytes=2.0 * 3 * a.numel(), gate=list(a.shape),
                dtype="bfloat16")
            del x, w, a, u
            torch.cuda.empty_cache()

    def _sdpa_backends(self, q, k, v) -> dict:
        """The SDPA yardstick named: the backend PyTorch's dispatcher picks
        for the default call (`torch._fused_sdp_choice`, whose time is
        `library_ms`), and the call's time under `sdpa_kernel` for each
        backend that takes these inputs."""
        torch = self.torch
        import torch.nn.functional as F
        from torch.nn.attention import SDPBackend, sdpa_kernel

        def call():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
        choice = SDPBackend(int(torch._fused_sdp_choice(
            q, k, v, is_causal=True, enable_gqa=True)))
        names = {SDPBackend.CUDNN_ATTENTION: "cudnn",
                 SDPBackend.FLASH_ATTENTION: "flash",
                 SDPBackend.EFFICIENT_ATTENTION: "efficient",
                 SDPBackend.MATH: "math"}
        res = {"default_backend": names.get(choice, choice.name)}
        for name, be in (("cudnn", SDPBackend.CUDNN_ATTENTION),
                         ("flash", SDPBackend.FLASH_ATTENTION),
                         ("efficient", SDPBackend.EFFICIENT_ATTENTION)):
            try:
                with sdpa_kernel(be):
                    res[f"{name}_ms"] = _queued_ms(torch, call)[0]
            except RuntimeError as e:
                res[f"{name}_ms"] = None
                res[f"{name}_unavailable"] = str(e).splitlines()[0][:200]
        return res

    def _bwd_kernels(self):
        """The backward kernels of the training path against their plain
        versions (`ref.rmsnorm_bwd_ref`, `ref.swiglu_bwd_ref`): rmsnorm's
        in f32, bf16 and f16 at every width of its one-read kernel
        (granite-3-2b's, qwen3-4b's, zamba2-7b's and seamless's training
        widths among
        them, and fewer rows than its grid's blocks), at decode rows, at a
        3-d batch, at widths off the pack (33, 1000) and on a misaligned
        view (the two-sweep kernel), and at the dense widths the two-sweep
        kernel too (`rmsnorm._two_sweep`); swiglu's in f32 and bf16 at
        both models' d_ff, at decode rows, odd sizes and a misaligned view.
        Then two calls give the same bits, each row's dx (at d 2048 and
        3584; and each element's swiglu gradient) does not depend on the
        other rows, what the wrappers refuse, and their times at the
        training shapes beside the bound, the plain version, the two-sweep
        kernel and, for rmsnorm, `torch.autograd.grad` through
        `F.rms_norm`."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import ref
        from repro_torch.kernels.rmsnorm import (
            ONE_READ_WIDTHS, _two_sweep, bwd_one_read_threads, rmsnorm_bwd)
        from repro_torch.kernels.swiglu import swiglu_bwd
        g = torch.Generator(device=self.dev).manual_seed(self.seed + 320)
        f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
        tags = {f32: "f32", bf16: "bf16", f16: "f16"}

        def randn(shape, dt, mul=1.0):
            return (torch.randn(shape, generator=g, device=self.dev)
                    * mul).to(dt)
        for dt in (f32, bf16, f16):
            for shape in ((16384, 2048), (16384, 2560), (16384, 3584),
                          (16384, 1024), (263, 1024), (263, 3072),
                          (1000, 4096), (100, 3584), (4, 2560), (2, 3, 2048),
                          (7, 33), (333, 1000)):
                x, dy = randn(shape, dt), randn(shape, dt)
                w = randn(shape[-1:], dt)
                dx, dw = rmsnorm_bwd(x, w, dy, 1e-6)
                px, pw = ref.rmsnorm_bwd_ref(x, w, dy, 1e-6)
                kind = "one read" if bwd_one_read_threads(
                    shape[-1], True) else "two sweeps"
                check(bool(bwd_one_read_threads(shape[-1], True))
                      == (shape[-1] in ONE_READ_WIDTHS),
                      f"rmsnorm_bwd: width {shape[-1]} takes the {kind}")
                self._lm_agree("rmsnorm_bwd", f"{tags[dt]} {shape} dx "
                               f"{kind}", dx, px)
                self._lm_agree("rmsnorm_bwd", f"{tags[dt]} {shape} dw "
                               f"{kind}", dw, pw)
                if shape[-1] in ONE_READ_WIDTHS and shape[0] in (263, 1000):
                    tx, tw = _two_sweep(x, w, dy, 1e-6)
                    self._lm_agree("rmsnorm_bwd", f"{tags[dt]} {shape} dx "
                                   "two sweeps", tx, px)
                    self._lm_agree("rmsnorm_bwd", f"{tags[dt]} {shape} dw "
                                   "two sweeps", tw, pw)
            # a view one element past a 16-byte boundary: two sweeps
            flat = randn((2 * 2048 + 1,), dt)
            x, dy = flat[1:].view(2, 2048), randn((2, 2048), dt)
            w = randn((2048,), dt)
            check(x.data_ptr() % 16 != 0, "rmsnorm_bwd: the view's alignment")
            dx, dw = rmsnorm_bwd(x, w, dy, 1e-6)
            px, pw = ref.rmsnorm_bwd_ref(x, w, dy, 1e-6)
            self._lm_agree("rmsnorm_bwd", f"{tags[dt]} misaligned dx", dx, px)
            self._lm_agree("rmsnorm_bwd", f"{tags[dt]} misaligned dw", dw, pw)
        for dt in (f32, bf16):
            for shape in ((16384, 8192), (16384, 9728), (16384, 14336),
                          (4, 9728), (5, 17)):
                a, u, dy = randn(shape, dt, 3.0), randn(shape, dt), \
                    randn(shape, dt)
                dg, du = swiglu_bwd(a, u, dy)
                pg, pu = ref.swiglu_bwd_ref(a, u, dy)
                self._lm_agree("swiglu_bwd", f"{tags[dt]} {shape} dgate", dg,
                               pg)
                self._lm_agree("swiglu_bwd", f"{tags[dt]} {shape} dup", du, pu)
            flat = randn((1001,), dt, 3.0)
            a, u, dy = flat[1:], randn((1000,), dt), randn((1000,), dt)
            dg, du = swiglu_bwd(a, u, dy)
            pg, pu = ref.swiglu_bwd_ref(a, u, dy)
            self._lm_agree("swiglu_bwd", f"{tags[dt]} misaligned dgate", dg, pg)
            self._lm_agree("swiglu_bwd", f"{tags[dt]} misaligned dup", du, pu)
        # two calls, the same bits; a row alone, the same bits
        x, w, dy = randn((16384, 2048), bf16), randn((2048,), bf16), \
            randn((16384, 2048), bf16)
        a, u, dz = randn((16384, 8192), bf16, 3.0), randn((16384, 8192), bf16), \
            randn((16384, 8192), bf16)
        dx, dw = rmsnorm_bwd(x, w, dy)
        dx2, dw2 = rmsnorm_bwd(x, w, dy)
        dg, du = swiglu_bwd(a, u, dz)
        dg2, du2 = swiglu_bwd(a, u, dz)
        check(torch.equal(dx, dx2) and torch.equal(dw, dw2)
              and torch.equal(dg, dg2) and torch.equal(du, du2),
              "backward kernels: two calls give the same bits")
        for r in (0, 5000, 16383):
            dxr, _ = rmsnorm_bwd(x[r:r + 1], w, dy[r:r + 1])
            dgr, dur = swiglu_bwd(a[r:r + 1], u[r:r + 1], dz[r:r + 1])
            check(torch.equal(dxr[0], dx[r]) and torch.equal(dgr[0], dg[r])
                  and torch.equal(dur[0], du[r]),
                  f"backward kernels: row {r} alone gives other bits")
        del dx2, dw2, dg2, du2
        # zamba2-7b's width: repeat, rows alone and a slice of the batch
        x3, w3, dy3 = randn((16384, 3584), bf16), randn((3584,), bf16), \
            randn((16384, 3584), bf16)
        dx3, dw3 = rmsnorm_bwd(x3, w3, dy3)
        dx4, dw4 = rmsnorm_bwd(x3, w3, dy3)
        check(torch.equal(dx3, dx4) and torch.equal(dw3, dw4),
              "rmsnorm_bwd d 3584: two calls give the same bits")
        for r in (0, 7777, 16383):
            check(torch.equal(rmsnorm_bwd(x3[r:r + 1], w3, dy3[r:r + 1])[0][0],
                              dx3[r]),
                  f"rmsnorm_bwd d 3584: row {r} alone gives other bits")
        check(torch.equal(rmsnorm_bwd(x3[100:400], w3, dy3[100:400])[0],
                          dx3[100:400]),
              "rmsnorm_bwd d 3584: rows 100-399 alone give other bits")
        del x3, w3, dy3, dx3, dw3, dx4, dw4
        wg = w.clone().requires_grad_(True)
        for what, call, exc in (
                ("swiglu_bwd f16", lambda: swiglu_bwd(
                    x.half(), x.half(), x.half()), TypeError),
                ("dy shape", lambda: rmsnorm_bwd(x, w, dy[:7]), ValueError),
                ("dy dtype", lambda: rmsnorm_bwd(x, w, dy.float()),
                 TypeError),
                ("swiglu_bwd shapes", lambda: swiglu_bwd(a, u, dz[:3]),
                 ValueError),
                ("needs a gradient", lambda: rmsnorm_bwd(x, wg, dy),
                 RuntimeError)):
            try:
                call()
            except exc:
                continue
            raise CheckFailed(f"backward kernels: {what} must raise "
                              f"{exc.__name__}")
        emit({"phase": "lm_kernels", "backward": True, "bitwise_repeat": True,
              "row_independent": True, "raises": True,
              "max_abs_err": {n: self.max_abs_err[n]
                              for n in ("rmsnorm_bwd", "swiglu_bwd")}})
        del x, w, dy, a, u, dz, dx, dw, dg, du
        torch.cuda.empty_cache()
        # times: granite-3-2b's training shape is the main one
        for dt in (bf16, f32, f16):
            # zamba2-7b's d_model 3584 in bf16
            for d in (2048, 2560) + ((3584,) if dt == bf16 else ()):
                check(bwd_one_read_threads(d, True) == d // 8,
                      f"rmsnorm_bwd: (16384, {d}) takes the one-read kernel")
                x, dy = randn((16384, d), dt), randn((16384, d), dt)
                w = randn((d,), dt)
                xg = x.clone().requires_grad_(True)
                wg = w.clone().requires_grad_(True)
                main = dt == bf16 and d == 2048
                self._time_kernel(
                    "rmsnorm_bwd",
                    "train" if main else f"(16384, {d}) {tags[dt]}",
                    lambda: rmsnorm_bwd(x, w, dy, 1e-6),
                    lambda: ref.rmsnorm_bwd_ref(x, w, dy, 1e-6),
                    flops=12.0 * x.numel(),
                    nbytes=x.element_size() * (3.0 * x.numel() + 2 * d),
                    library=lambda: torch.autograd.grad(
                        F.rms_norm(xg, (d,), wg, 1e-6), (xg, wg), dy),
                    x=[16384, d], dtype=str(dt).replace("torch.", ""),
                    library_call="torch.autograd.grad through F.rms_norm "
                                 "(its forward included)",
                    kernel_design="one read",
                    two_sweep_ms=_queued_ms(
                        torch, lambda: _two_sweep(x, w, dy, 1e-6))[0])
                del x, dy, w, xg, wg
        for dt in (bf16, f32):
            # zamba2-7b's d_ff 14336 in bf16
            for dff in (8192, 9728) + ((14336,) if dt == bf16 else ()):
                a, u, dy = (randn((16384, dff), dt, 3.0),
                            randn((16384, dff), dt), randn((16384, dff), dt))
                main = dt == bf16 and dff == 8192
                self._time_kernel(
                    "swiglu_bwd",
                    "train" if main else f"(16384, {dff}) {tags[dt]}",
                    lambda: swiglu_bwd(a, u, dy),
                    lambda: ref.swiglu_bwd_ref(a, u, dy),
                    flops=12.0 * a.numel(),
                    nbytes=a.element_size() * 5.0 * a.numel(),
                    gate=[16384, dff], dtype=str(dt).replace("torch.", ""))
                del a, u, dy
                torch.cuda.empty_cache()

    def _lm_counts(self):
        from repro_torch.kernels import ops
        return {"flash_attention": ops.FLASH_LAUNCHES,
                "rmsnorm": ops.RMSNORM_LAUNCHES,
                "rmsnorm_one_read": ops.RMSNORM_ONE_READ_LAUNCHES,
                "swiglu": ops.SWIGLU_LAUNCHES}

    def _train_counts(self):
        """The forward and backward kernels' launches of the training path
        (rmsnorm by kernel: one read or two passes)."""
        from repro_torch.kernels import ops
        return {"rmsnorm": ops.RMSNORM_LAUNCHES,
                "rmsnorm_one_read": ops.RMSNORM_ONE_READ_LAUNCHES,
                "swiglu": ops.SWIGLU_LAUNCHES,
                "rmsnorm_bwd": ops.RMSNORM_BWD_LAUNCHES,
                "swiglu_bwd": ops.SWIGLU_BWD_LAUNCHES,
                "flash_attention": ops.FLASH_LAUNCHES}

    def lm_serve(self):
        """qwen3-4b served by the port: at full width and 2 layers in f32,
        the kernels against the plain versions (prefill logits, and greedy
        tokens of a ServeEngine run); at full width and depth in bf16,
        prefill (B 4, S 4096) and a ServeEngine run (8 requests, prompt
        SERVE_PROMPT, SERVE_MAX_NEW new tokens each, 4 slots, cache 1024)
        with exact launch counts, their times and the device's idle share
        over a warm decode step; then its last-token logits against the plain versions'
        and decode_step's against prefill's."""
        torch = self.torch
        import numpy as np
        from repro_torch.configs import get_arch
        from repro_torch.kernels import ops
        from repro_torch.models import build_model
        from repro_torch.serving.engine import Request, ServeEngine
        base = get_arch("qwen3-4b")
        vocab = base.vocab
        rng = np.random.default_rng(self.seed)
        gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        res = {}
        # --- 1. full width, 2 layers, f32: kernels against plain --------
        cfg2 = base.replace(n_layers=2, dtype="float32", attn_impl="flash")
        km = build_model(cfg2, device=self.dev).init(gen)
        pm = build_model(cfg2.replace(attn_impl="chunked"), device=self.dev,
                         backend="plain")
        pm.load_state_dict(km.state_dict())
        toks = rng.integers(0, vocab, (2, 256))
        ops.reset_launch_counts()
        lk, _ = km.prefill({"tokens": toks})
        counts = self._lm_counts()
        lp, _ = pm.prefill({"tokens": toks})
        check(self._lm_counts() == counts == {
            "flash_attention": 2, "rmsnorm": 5, "rmsnorm_one_read": 5,
            "swiglu": 2},
            f"lm_serve f32: launches {counts} for a 2-layer prefill, none "
            "for the plain one")
        err = float((lk - lp).abs().max())
        tol = LOGIT_TOL * max(1.0, float(lp.abs().max()))
        check(bool(torch.isfinite(lk).all()) and lk.shape == (2, vocab)
              and err <= tol,
              f"lm_serve f32: prefill logits kernels vs plain {err} > {tol}")
        prompts = [rng.integers(0, vocab, 12) for _ in range(6)]
        outs = []
        for model in (km, pm):
            eng = ServeEngine(model, n_slots=2, cache_len=64)
            ops.reset_launch_counts()
            done = eng.run([Request(uid=i, prompt=p, max_new=8)
                            for i, p in enumerate(prompts)])
            outs.append([(r.uid, r.out) for r in done])
            if model is km:
                n = eng.n_decode_calls
                check(self._lm_counts() == {"flash_attention": 0,
                                            "rmsnorm": 5 * n,
                                            "rmsnorm_one_read": 5 * n,
                                            "swiglu": 2 * n},
                      f"lm_serve f32: decode launches {self._lm_counts()} "
                      f"for {n} decode steps")
        check(outs[0] == outs[1] and len(outs[0]) == 6
              and all(len(o) == 8 for _, o in outs[0]),
              "lm_serve f32: greedy tokens with kernels == plain")
        res["f32_2_layers"] = {"prefill_logit_max_abs_err": err, "tol": tol,
                               "tokens_identical": True,
                               "requests": 6, "slots": 2}
        del km, pm, lk, lp
        torch.cuda.empty_cache()
        # --- 2. full width and depth, bf16 -------------------------------
        cfg = base.replace(attn_impl="flash")
        t0 = time.perf_counter()
        model = build_model(cfg, device=self.dev).init(gen)
        torch.cuda.synchronize()
        res["init_s"] = time.perf_counter() - t0
        res["params"] = model.param_count()
        toks = rng.integers(0, vocab, (4, 4096))
        torch.cuda.reset_peak_memory_stats()
        # the main path, prefill: counts from 0 just before, read just after
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, caches = model.prefill({"tokens": toks})
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        pre = self._lm_counts()
        check(pre == {"flash_attention": 36, "rmsnorm": 73,
                      "rmsnorm_one_read": 73, "swiglu": 36},
              f"lm_serve: prefill launches {pre} (36/73/36 expected, every "
              "rmsnorm on the one-read kernel)")
        check(logits.shape == (4, vocab) and bool(torch.isfinite(logits).all())
              and len(caches["seg_00"]) == 36
              and caches["seg_00"][0]["k"].shape == (4, 4096, 8, 128),
              "lm_serve: prefill logits finite, caches (4, 4096, 8, 128) x 36")
        del caches
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            again, caches = model.prefill({"tokens": toks})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del caches
        prefill_s = statistics.median(times)
        res["prefill"] = {"batch": 4, "seq": 4096, "first_call_s": first_s,
                          "seconds": times, "median_s": prefill_s,
                          "tokens_per_s": 4 * 4096 / prefill_s,
                          "launches": pre,
                          "repeat_bitwise": bool(torch.equal(again, logits)),
                          "peak_memory_gb":
                              torch.cuda.max_memory_allocated() / 1e9}
        self.lm_launches["prefill"] = pre
        # the main path, serving: counts from 0 just before, read just after
        eng = ServeEngine(model, n_slots=4, cache_len=1024)
        reqs = [Request(uid=i, prompt=rng.integers(0, vocab, SERVE_PROMPT),
                        max_new=SERVE_MAX_NEW) for i in range(8)]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        served = self._lm_counts()
        n = eng.n_decode_calls
        check(served == {"flash_attention": 0, "rmsnorm": 73 * n,
                         "rmsnorm_one_read": 73 * n, "swiglu": 36 * n},
              f"lm_serve: engine launches {served} for {n} decode steps "
              "(73/36 per step expected, every rmsnorm on the one-read "
              "kernel)")
        check(len(done) == 8
              and all(len(r.out) == SERVE_MAX_NEW for r in done)
              and all(0 <= t < vocab for r in done for t in r.out),
              f"lm_serve: 8 requests of {SERVE_MAX_NEW} tokens in the "
              "vocabulary")
        self.lm_launches["serve"] = served
        steps = eng.step_seconds
        new = sum(len(r.out) for r in done)
        res["serve"] = {
            "requests": 8, "prompt": SERVE_PROMPT, "max_new": SERVE_MAX_NEW,
            "slots": 4,
            "cache_len": 1024, "seconds": run_s, "decode_calls": n,
            "ticks": len(steps), "new_tokens": new,
            "decode_steps_per_s": len(steps) / sum(steps),
            "new_tokens_per_s_ticks": new / sum(steps),
            "new_tokens_per_s_run": new / run_s,
            "step_p50_ms": float(np.percentile(steps, 50)) * 1e3,
            "step_p99_ms": float(np.percentile(steps, 99)) * 1e3,
            "launches": served}
        res["decode_idle"] = self._decode_idle(model, eng, steps)
        # The decode path against prefill at full depth (bf16, checked):
        # prefill(64) + decode(token 64) against prefill(65).
        short = rng.integers(0, vocab, (1, 65))
        _, c64 = model.prefill({"tokens": short[:, :64]})
        l65, _ = model.prefill({"tokens": short})
        pad = {seg: [{k: torch.cat([c[k], torch.zeros_like(c[k][:, :1])], 1)
                      for k in c} for c in layers]
               for seg, layers in c64.items()}
        ld, _ = model.decode_step(pad, short[:, 64:65],
                                  np.full((1,), 64, np.int64))
        res["decode_vs_prefill_bf16"] = self._bf16_logits_agree(
            "decode_step after prefill(64) vs prefill(65)", ld, l65)
        # The kernels against the plain versions at full depth, bf16.
        pm = build_model(cfg.replace(attn_impl="chunked"), device=self.dev,
                         backend="plain")
        pm.load_state_dict(model.state_dict())
        toks = rng.integers(0, vocab, (2, 512))
        lk, _ = model.prefill({"tokens": toks})
        lp, _ = pm.prefill({"tokens": toks})
        res["kernels_vs_plain_bf16"] = self._bf16_logits_agree(
            "prefill (2, 512), kernels vs plain", lk, lp)
        del pm
        torch.cuda.empty_cache()
        emit({"phase": "lm_serve", "arch": "qwen3-4b", "card": self.card,
              **res})

    def _bf16_logits_agree(self, case, got, want,
                           tol_frac: float = BF16_LOGIT_TOL) -> dict:
        """Full-depth bf16 logits of two routes agree within `tol_frac` of
        max |want|."""
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        tol = tol_frac * scale
        check(got.shape == want.shape and bool(self.torch.isfinite(got).all())
              and err <= tol,
              f"bf16 {case}: max abs diff {err} > {tol}")
        return {"case": case, "max_abs_diff": err, "logit_scale": scale,
                "tol": tol, "argmax_equal_rows": int(
                    (got.argmax(-1) == want.argmax(-1)).sum()),
                "rows": int(got.shape[0])}

    def _decode_idle(self, model, eng, steps) -> dict:
        """Device busy and idle share over one warm decode step (4 slots),
        from torch.profiler, against the step's unprofiled p50 (the
        profiler slows the host)."""
        torch = self.torch
        import numpy as np
        from torch.profiler import ProfilerActivity, profile
        tok = np.zeros((eng.n_slots, 1), np.int64)
        pos = np.full((eng.n_slots,), 100, np.int64)
        model.decode_step(eng.caches, tok, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.decode_step(eng.caches, tok, pos)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        events = _device_events(prof)
        busy = sum(dt for _, dt, _ in events)
        n_kernels = sum(count for _, _, count in events)
        if busy <= 0:
            return {"idle": "not measured (no device events)"}
        p50 = float(np.percentile(steps, 50))
        return {"device_busy_ms": busy / 1e3, "device_kernels": n_kernels,
                "profiled_wall_ms": wall * 1e3, "unprofiled_step_p50_ms":
                    p50 * 1e3,
                "device_idle_share": max(0.0, 1 - busy / 1e6 / p50)}

    # ------------------------------------------------------------- train
    def train(self):
        """granite-3-2b trained by the port at full width and TRAIN_LAYERS
        of its 40 layers (d 2048, 32/8 heads of 64, d_ff 8192, vocab 49155,
        tied embeddings; bf16, remat "full", chunked attention): TRAIN_STEPS
        `make_train_step` steps of TRAIN_BATCH x TRAIN_SEQ tokens from
        `TokenPipeline` with exact launch counts for a step, every loss
        finite, the first TRAIN_PLAIN_STEPS steps' loss and grad norm
        against a run on the plain versions from the same state, step time,
        tokens/s, peak memory and the model-FLOP share.  Then at full width
        and 2 layers: the loss and every gradient in f32 against the plain
        versions, and in bf16 two three-step runs from one state bitwise
        equal, and a
        `CheckpointManager` save after step 2, restore and step 3 equal to
        the straight run bitwise.  No plain backward runs."""
        from repro_torch.configs import TrainConfig, get_arch
        from repro_torch.data.tokens import TokenPipeline
        self._ensure_built()
        cfg = get_arch("granite-3-2b")
        check(cfg.n_layers == 40 and cfg.d_model == 2048 and cfg.d_ff == 8192
              and cfg.dtype == "bfloat16" and cfg.remat == "full"
              and cfg.attn_impl == "chunked" and cfg.tie_embeddings,
              "train: granite-3-2b's configuration")
        cfg = cfg.replace(n_layers=TRAIN_LAYERS)
        tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                           total_steps=TRAIN_STEPS)
        pipe = TokenPipeline(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                             seed=self.seed)
        n, tokens = cfg.n_layers, TRAIN_BATCH * TRAIN_SEQ
        # per step with remat "full": each block's two norms and its swiglu
        # run again in the backward's recompute
        per_step = {"rmsnorm": 4 * n + 1, "rmsnorm_one_read": 4 * n + 1,
                    "swiglu": 2 * n, "rmsnorm_bwd": 2 * n + 1,
                    "swiglu_bwd": n, "flash_attention": 0}
        with self._no_plain_backward("train"):
            res = self._train_full(cfg, tcfg, pipe, per_step, tokens)
            res["f32_2_layers"] = self._train_f32(cfg, pipe)
            res["determinism_2_layers"] = self._train_determinism(
                cfg, tcfg, pipe)
        emit({"phase": "train", "arch": "granite-3-2b", "card": self.card,
              **res})

    @contextlib.contextmanager
    def _no_plain_backward(self, phase: str):
        """Fails the phase if a plain backward version (`ref.rmsnorm_bwd_ref`,
        `ref.swiglu_bwd_ref`) runs inside: on the card every backward is the
        kernel's."""
        from repro_torch.kernels import ref
        plain_bwd = []
        saved = (ref.rmsnorm_bwd_ref, ref.swiglu_bwd_ref)

        def guard(fn):
            def counted(*a, **kw):
                plain_bwd.append(fn.__name__)
                return fn(*a, **kw)
            return counted
        ref.rmsnorm_bwd_ref, ref.swiglu_bwd_ref = map(guard, saved)
        try:
            yield
        finally:
            ref.rmsnorm_bwd_ref, ref.swiglu_bwd_ref = saved
        check(not plain_bwd, f"{phase}: plain backward versions ran on the "
              f"card: {sorted(set(plain_bwd))}")

    def _train_full(self, cfg, tcfg, pipe, per_step, tokens) -> dict:
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.kernels import ops
        from repro_torch.models import build_model
        from repro_torch.training import make_train_step, train_state_init
        seed = self.seed + 500
        t0 = time.perf_counter()
        model = build_model(cfg, device=self.dev).init(
            torch.Generator(device=self.dev).manual_seed(seed))
        params = {k: p.detach() for k, p in model.named_parameters()}
        probe = {k: params[k][:4].clone() for k in ("tok_embed",
                                                    "segments.seg_00.0.wq")}
        n_params = sum(p.numel() for p in params.values())
        state = train_state_init(params, tcfg)
        step = make_train_step(model, tcfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        # the main path: counts from 0 just before, read just after
        ops.reset_launch_counts()
        mets, times, first, breakdown = [], [], None, None
        for s in range(TRAIN_STEPS):
            # step 2 under the profiler (device activity only), so that
            # the p50 over steps 3 on is of unprofiled steps
            prof = profile(activities=[ProfilerActivity.CUDA]) \
                if s == 1 else contextlib.nullcontext()
            t0 = time.perf_counter()
            with prof:
                state, m = step(state, pipe.batch_at(s))
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            mets.append({k: float(v) for k, v in m.items()})
            if first is None:
                first = self._train_counts()
            if s == 1:
                breakdown = self._step_breakdown(prof, times[-1])
        counts = self._train_counts()
        # ----------------------------------------------------------------
        peak = torch.cuda.max_memory_allocated()
        check(first == per_step,
              f"train: launches of one step {first}, expected {per_step}")
        check(counts == {k: TRAIN_STEPS * v for k, v in per_step.items()},
              f"train: launches of {TRAIN_STEPS} steps {counts}")
        check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                  for m in mets) and [int(m["step"]) for m in mets]
              == list(range(1, TRAIN_STEPS + 1)),
              f"train: losses and grad norms finite, steps counted: {mets}")
        self.path_launches["train"] = {k: v for k, v in counts.items()
                                       if k != "rmsnorm_one_read"}
        # The plain versions from the same state: the same weights drawn
        # again from the seed (checked), zero moments, step 0.
        del state
        torch.cuda.empty_cache()
        model.init(torch.Generator(device=self.dev).manual_seed(seed))
        check(all(torch.equal(params[k][:4], v) for k, v in probe.items()),
              "train: the weights drawn again from the seed are the same")
        state = train_state_init(params, tcfg)
        plain = make_train_step(build_model(cfg, device="meta",
                                            backend="plain"), tcfg)
        ops.reset_launch_counts()
        pmets, ptimes = [], []
        for s in range(TRAIN_PLAIN_STEPS):
            t0 = time.perf_counter()
            state, m = plain(state, pipe.batch_at(s))
            torch.cuda.synchronize()
            ptimes.append(time.perf_counter() - t0)
            pmets.append({k: float(v) for k, v in m.items()})
        check(all(v == 0 for v in self._train_counts().values()),
              "train: the plain run launched a kernel")
        agree = []
        for i, (k, p) in enumerate(zip(mets, pmets)):
            dl = abs(k["loss"] - p["loss"]) / abs(p["loss"])
            dg = abs(k["grad_norm"] - p["grad_norm"]) / p["grad_norm"]
            check(dl <= TRAIN_LOSS_TOL and dg <= TRAIN_GNORM_TOL
                  and k["lr"] == p["lr"],
                  f"train: step {i + 1} kernels {k} against plain {p}")
            agree.append({"step": i + 1, "loss_rel": dl, "grad_norm_rel": dg})
        del state, params, model, step, plain
        torch.cuda.empty_cache()
        steady = times[2:]
        p50 = statistics.median(steady)
        b, s_ = TRAIN_BATCH, TRAIN_SEQ
        return {
            "layers": cfg.n_layers, "d_model": cfg.d_model, "dtype": cfg.dtype,
            "remat": cfg.remat, "attn_impl": cfg.attn_impl,
            "batch": b, "seq": s_, "steps": TRAIN_STEPS, "params": n_params,
            "init_s": init_s, "step_seconds": times,
            f"step_p50_s_steps_3_to_{TRAIN_STEPS}": p50,
            "tokens_per_s": tokens / p50,
            "peak_memory_gb": peak / 1e9,
            "flops": self._flop_shares(cfg, b, s_, n_params, p50),
            "profiled_step": breakdown,
            "metrics": mets, "launches_one_step": first,
            "launches": counts, "plain_metrics": pmets,
            "plain_step_seconds": ptimes, "kernels_vs_plain": agree,
            "tol": {"loss": TRAIN_LOSS_TOL, "grad_norm": TRAIN_GNORM_TOL}}

    def _flop_shares(self, cfg, batch: int, seq: int, n_params: int,
                     step_s: float) -> dict:
        """A train step's FLOPs of `batch` x `seq` tokens by
        `repro_torch.roofline`, each as a share of 989 TFLOP/s at `step_s`:
        `model_flops`, 6 N_active B S (the reference's convention), and
        `analytic_flops`' step_total (every matrix product of the blocks
        and the head, the causal attention's half, x4 with remat "full")."""
        from repro_torch import roofline
        from repro_torch.configs import ShapeConfig
        from repro_torch.models.transformer import segments_for
        shape = ShapeConfig("step", seq, batch, "train")
        n_active = roofline.active_params(cfg, n_params)
        counts = {
            "model_flops": ("roofline.model_flops: 6 N_active B S",
                            roofline.model_flops(cfg, shape, n_params,
                                                 n_active)),
            "analytic_flops": (
                "roofline.analytic_flops step_total: matmuls + causal "
                "attention, x4 with remat full",
                roofline.analytic_flops(cfg, shape,
                                        segments_for(cfg))["step_total"])}
        out = {"active_params": n_active}
        for name, (formula, flops) in counts.items():
            out[name] = {"formula": formula, "per_step": flops,
                         "share_of_989_tflops":
                             flops / step_s / PEAK_BF16_FLOPS}
        return out

    def _step_breakdown(self, prof, wall_s: float) -> dict:
        """Device time of a profiled train step (or prefill) by kind of
        work: the port's kernels, the matrix products (cuBLAS / CUTLASS
        GEMMs) and the rest
        (PyTorch's elementwise, softmax, reduction and copy kernels), the
        twelve largest kernels by name, and the device's idle share of the
        step's wall time."""
        events = _device_events(prof)
        busy = sum(dt for _, dt, _ in events)
        if busy <= 0:
            return {"idle": "not measured (no device events)"}
        ours = ("rmsnorm", "swiglu", "flash")
        gemm = ("gemm", "xmma", "cutlass", "sm90_", "sm80_", "Kernel2")
        kinds = {"port_kernels": 0.0, "matmuls": 0.0, "other": 0.0}
        for name, dt, _ in events:
            if any(k in name for k in ours):
                kinds["port_kernels"] += dt
            elif any(k in name for k in gemm):
                kinds["matmuls"] += dt
            else:
                kinds["other"] += dt
        top = sorted(events, key=lambda e: -e[1])[:12]
        return {"wall_s": wall_s, "device_busy_s": busy / 1e6,
                "device_idle_share": max(0.0, 1 - busy / 1e6 / wall_s),
                "kernels": sum(c for _, _, c in events),
                "by_kind_s": {k: v / 1e6 for k, v in kinds.items()},
                "top": [{"name": n[:120], "s": dt / 1e6, "count": c}
                        for n, dt, c in top]}

    def _train_f32(self, cfg, pipe) -> dict:
        """Full width, 2 layers, f32: the loss and every gradient with the
        kernels against the plain versions, on the same weights and batch."""
        torch = self.torch
        from repro_torch.models import build_model
        from repro_torch.training import loss_and_grads
        t0 = time.perf_counter()
        cfg2 = cfg.replace(n_layers=2, dtype="float32")
        model = build_model(cfg2, device=self.dev).init(
            torch.Generator(device=self.dev).manual_seed(self.seed + 501))
        params = {k: p.detach() for k, p in model.named_parameters()}
        batch = pipe.batch_at(0)
        lk, gk = loss_and_grads(model, params, batch)
        lp, gp = loss_and_grads(
            build_model(cfg2, device="meta", backend="plain"), params, batch)
        loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
        worst, worst_name = 0.0, ""
        for k in gp:
            scale = float(gp[k].abs().max())
            r = float((gk[k] - gp[k]).abs().max()) / max(scale, 1e-30)
            if r > worst:
                worst, worst_name = r, k
        check(math.isfinite(float(lk)) and loss_rel <= TRAIN_F32_LOSS_RTOL
              and worst <= TRAIN_F32_GRAD_TOL,
              f"train f32: loss rel {loss_rel}, worst gradient {worst_name} "
              f"{worst} of its max abs")
        del model, params, gk, gp
        torch.cuda.empty_cache()
        return {"seconds": time.perf_counter() - t0,
                "loss": float(lk), "loss_rel": loss_rel,
                "worst_grad_err_over_max": worst, "worst_grad": worst_name,
                "tol": {"loss_rel": TRAIN_F32_LOSS_RTOL,
                        "grad": TRAIN_F32_GRAD_TOL}}

    def _train_determinism(self, cfg, tcfg, pipe) -> dict:
        """Full width, 2 layers, bf16: two three-step runs from one state
        give the same bits, and so does a run saved by `CheckpointManager`
        after step 2, restored and stepped once."""
        torch = self.torch
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.convert import (
            train_state_from_numpy, train_state_to_numpy,
        )
        from repro_torch.models import build_model
        from repro_torch.training import make_train_step, train_state_init
        t0 = time.perf_counter()
        cfg2 = cfg.replace(n_layers=2)
        model = build_model(cfg2, device=self.dev).init(
            torch.Generator(device=self.dev).manual_seed(self.seed + 502))
        init = {k: p.detach().clone() for k, p in model.named_parameters()}
        step = make_train_step(model, tcfg)

        def fresh():
            return train_state_init({k: t.clone() for k, t in init.items()},
                                    tcfg)

        def run(state, s0, s1):
            mets = []
            for s in range(s0, s1):
                state, m = step(state, pipe.batch_at(s))
                mets.append({k: float(v) for k, v in m.items()})
            return state, mets

        def same(a, b):
            return (torch.equal(a.opt.step, b.opt.step)
                    and all(torch.equal(a.params[k], b.params[k])
                            for k in a.params)
                    and all(torch.equal(a.opt.mu[k], b.opt.mu[k])
                            and torch.equal(a.opt.nu[k], b.opt.nu[k])
                            for k in a.opt.mu))
        a, ma = run(fresh(), 0, 3)
        b, mb = run(fresh(), 0, 3)
        check(ma == mb and same(a, b),
              "train bf16: two runs from one state differ")
        c, _ = run(fresh(), 0, 2)
        t_ckpt = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            mgr = CheckpointManager(tmp)
            saved = train_state_to_numpy(c)
            mgr.save(2, saved)
            del c
            at, tree = mgr.restore(saved, device="cpu")   # its names only
        c = train_state_from_numpy(tree, cfg2, device=self.dev)
        t_ckpt = time.perf_counter() - t_ckpt
        c, mc = run(c, 2, 3)
        check(at == 2 and mc == ma[2:] and same(a, c),
              "train bf16: save after step 2, restore, step 3 differs from "
              "the straight run")
        del a, b, c, model, init
        torch.cuda.empty_cache()
        return {"seconds": time.perf_counter() - t0,
                "checkpoint_save_restore_s": t_ckpt, "steps": 3,
                "bitwise_repeat": True, "bitwise_resume": True,
                "metrics": ma}

    # --------------------------------------------------------------- moe
    def _moe_counts(self):
        """The language-model kernels' launches, rmsnorm's two kernels
        together."""
        counts = self._train_counts()
        del counts["rmsnorm_one_read"]
        return counts

    def moe(self):
        """The Mixture-of-Experts family on the card (`models/moe.py`):
        olmoe-1b-7b (16 layers, d 2048, 64 experts top-8, d_ff 1024; the
        capacity impl at factor 1.25, as its config sets them) at full
        width, 2 layers, f32, with the kernels against the plain versions
        (logits, every layer's routing and drops) and its five dispatch
        impls against `dense`; served at full width and depth in bf16 (a
        4 x 4096 prefill with flash attention, the slot engine's decode,
        both with exact launch counts, and their logits against the plain
        versions' and against decode_step); trained at full width and
        MOE_TRAIN_LAYERS layers (MOE_TRAIN_STEPS AdamW steps held to a run
        on the plain versions, and full-width f32 gradients); phi3.5-moe
        (16 experts top-2, GQA 32/8, d_ff 6400) at full width and 2 layers;
        and the swiglu and flash kernels timed at the MoE shapes.  The
        launches of the served and trained runs (and phi3.5-moe's prefill)
        count as the path's."""
        from repro_torch.configs import get_arch
        self._ensure_built()
        base = get_arch("olmoe-1b-7b")
        check(base.n_layers == 16 and base.d_model == 2048
              and base.n_heads == base.n_kv_heads == 16 and base.hd == 128
              and base.d_ff == 1024 and base.vocab == 50304
              and base.moe.n_experts == 64 and base.moe.top_k == 8
              and base.moe.capacity_factor == 1.25
              and base.moe.impl == "capacity" and base.dtype == "bfloat16"
              and base.remat == "full" and base.attn_impl == "chunked",
              "moe: olmoe-1b-7b's configuration")
        launches = dict.fromkeys(("flash_attention", "rmsnorm", "swiglu",
                                  "rmsnorm_bwd", "swiglu_bwd"), 0)
        res = {}
        t0 = time.perf_counter()
        res["f32_2_layers"] = self._moe_f32(base)
        res["f32_2_layers"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["serve"] = self._moe_serve(base, launches)
        res["serve"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with self._no_plain_backward("moe"):
            res["train"] = self._moe_train(base, launches)
        res["train"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["phi3_5_moe_2_layers"] = self._moe_phi(launches)
        res["phi3_5_moe_2_layers"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._moe_kernel_times()
        res["kernel_times_s"] = time.perf_counter() - t0
        res["launches"] = launches
        self.path_launches["moe"] = launches
        emit({"phase": "moe", "arch": "olmoe-1b-7b", "card": self.card,
              **res})

    def _routing_agree(self, case, cfg, rk, rp, s: int) -> dict:
        """Every layer's routing of two routes through the same weights
        (`_Routing` records, in layer order): tokens whose ordered top-k
        ids differ, each within MOE_TIE_MARGIN of a tie in the second
        route's probabilities where they were recorded, and the tokens
        each route drops at the config's capacity."""
        from repro_torch.models import moe
        torch = self.torch
        check(len(rk.calls) == len(rp.calls) == cfg.n_layers,
              f"moe {case}: {len(rk.calls)} / {len(rp.calls)} router calls "
              f"for {cfg.n_layers} layers")
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        cap = moe.capacity(cfg, s)
        out = {"case": case, "capacity": cap, "flips": [], "drops": [],
               "plain_drops": [], "flip_margin_max": 0.0,
               "nearest_tie": None}
        for a, b in zip(rk.calls, rp.calls):
            differ = (a["top_i"] != b["top_i"]).any(-1)
            out["flips"].append(int(differ.sum()))
            if "probs" in b:
                top = torch.sort(b["probs"], -1, descending=True).values
                kk = min(k, e - 1)    # the gaps that order and pick the k
                gaps = (top[..., :kk] - top[..., 1:kk + 1]).amin(-1)
                nearest = float(gaps.min())
                out["nearest_tie"] = nearest if out["nearest_tie"] is None \
                    else min(out["nearest_tie"], nearest)
                if bool(differ.any()):
                    worst = float(gaps[differ].max())
                    out["flip_margin_max"] = max(out["flip_margin_max"],
                                                 worst)
            for key, rec in (("drops", a), ("plain_drops", b)):
                hit = moe._capacity_slots(rec["top_p"], rec["top_i"], e,
                                          cap)[1]
                out[key].append(int(rec["top_i"].numel() - hit.sum()))
        return out

    def _moe_f32(self, base) -> dict:
        """Full width, MOE_F32_LAYERS layers, f32: a 1 x MOE_F32_SEQ prefill
        through the kernels against one through the plain versions (logits
        within LOGIT_TOL; routing equal, or different only within
        MOE_TIE_MARGIN of a tie; drops at the config's factor equal), then
        the five impls on one layer's weights at capacity factor
        MOE_ORACLE_CF against `dense`, each a swiglu launch."""
        torch = self.torch
        import dataclasses
        import numpy as np
        from repro_torch.kernels import ops
        from repro_torch.models import build_model, moe
        cfg = base.replace(n_layers=MOE_F32_LAYERS, dtype="float32",
                           attn_impl="flash")
        gen = torch.Generator(device=self.dev).manual_seed(self.seed + 600)
        model = build_model(cfg, device=self.dev).init(gen)
        toks = np.random.default_rng(self.seed + 600).integers(
            0, cfg.vocab, (1, MOE_F32_SEQ))
        with _Routing(torch, probs=True) as rk:
            ops.reset_launch_counts()
            lk, _ = model.prefill({"tokens": toks})
            counts = self._moe_counts()
        model.backend, model.cfg = "plain", cfg.replace(attn_impl="chunked")
        with _Routing(torch, probs=True) as rp:
            lp, _ = model.prefill({"tokens": toks})
        model.backend, model.cfg = "auto", cfg
        n = cfg.n_layers
        check(self._moe_counts() == counts == {
            "flash_attention": n, "rmsnorm": 2 * n + 1, "swiglu": n,
            "rmsnorm_bwd": 0, "swiglu_bwd": 0},
            f"moe f32: launches {counts} for a {n}-layer prefill, none for "
            "the plain one")
        err = float((lk - lp).abs().max())
        tol = LOGIT_TOL * max(1.0, float(lp.abs().max()))
        check(bool(torch.isfinite(lk).all()) and lk.shape == (1, cfg.vocab)
              and err <= tol,
              f"moe f32: prefill logits kernels vs plain {err} > {tol}")
        routing = self._routing_agree("f32 prefill, kernels vs plain", cfg,
                                      rk, rp, MOE_F32_SEQ)
        emit({"phase": "moe", "routing": routing})
        check(routing["flip_margin_max"] < MOE_TIE_MARGIN,
              f"moe f32: routing differs beyond a tie: {routing}")
        check(routing["drops"] == routing["plain_drops"],
              f"moe f32: drops differ between the routes: {routing}")
        # the five impls on layer 0's weights, no drops, against dense
        p0 = {name: t.detach() for name, t in
              model.segments["seg_00"][0].items()}
        x = torch.randn((1, MOE_F32_SEQ, cfg.d_model), generator=gen,
                        device=self.dev)
        outs, impl_launches = {}, {}
        with torch.inference_mode():
            for impl in ("dense", "capacity", "gather", "ragged", "hybrid"):
                c = cfg.replace(moe=dataclasses.replace(
                    cfg.moe, impl=impl, capacity_factor=MOE_ORACLE_CF))
                ops.reset_launch_counts()
                outs[impl] = moe.moe_apply(p0, x, c)
                impl_launches[impl] = ops.SWIGLU_LAUNCHES
        dense = outs["dense"]
        itol = MOE_IMPL_TOL * max(1.0, float(dense.abs().max()))
        impl_err = {impl: float((o - dense).abs().max())
                    for impl, o in outs.items()}
        check(all(v == 1 for v in impl_launches.values())
              and all(v <= itol for v in impl_err.values())
              and all(bool(torch.isfinite(o).all()) for o in outs.values()),
              f"moe f32: impls against dense {impl_err} (tol {itol}), "
              f"swiglu launches {impl_launches}")
        del model, outs, dense, x, p0
        torch.cuda.empty_cache()
        return {"layers": n, "seq": MOE_F32_SEQ,
                "prefill_logit_max_abs_err": err, "tol": tol,
                "launches": counts, "routing": routing,
                "impls_vs_dense": {"capacity_factor": MOE_ORACLE_CF,
                                   "max_abs_err": impl_err, "tol": itol,
                                   "swiglu_launches": impl_launches}}

    def _moe_serve(self, base, launches) -> dict:
        """Full width and depth, bf16, random weights from the seed: the
        parameter count and the f32 routers; a 4 x 4096 prefill with flash
        (exact launches, caches, seconds, tokens/s); its last-token logits
        against the plain versions' and the routing flips between them; a
        ServeEngine run of 4 requests (prompt MOE_SERVE_PROMPT,
        MOE_SERVE_MAX_NEW new tokens, 4 slots) with exact launches, step
        p50 / p99, the idle share of a warm step and the peak memory;
        decode_step against a longer prefill at capacity factor
        MOE_ORACLE_CF."""
        torch = self.torch
        import dataclasses
        import numpy as np
        from repro_torch.kernels import ops
        from repro_torch.models import build_model
        from repro_torch.serving.engine import Request, ServeEngine
        from torch.profiler import ProfilerActivity, profile
        cfg = base.replace(attn_impl="flash")
        vocab, n = cfg.vocab, cfg.n_layers
        rng = np.random.default_rng(self.seed + 610)
        t0 = time.perf_counter()
        model = build_model(cfg, device=self.dev).init(
            torch.Generator(device=self.dev).manual_seed(self.seed + 610))
        torch.cuda.synchronize()
        res = {"init_s": time.perf_counter() - t0,
               "params": model.param_count()}
        f32 = [name for name, p in model.named_parameters()
               if p.dtype == torch.float32]
        check(res["params"] == 6_919_096_320 and len(f32) == n
              and all(name.endswith(".router") for name in f32)
              and model.dtype == torch.bfloat16,
              f"moe: {res['params']} parameters, f32 {f32}")
        toks = rng.integers(0, vocab, (MOE_PREFILL_BATCH, TRAIN_SEQ))
        torch.cuda.reset_peak_memory_stats()
        # the main path, prefill: counts from 0 just before, read just after
        with _Routing(torch) as rk:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            logits, caches = model.prefill({"tokens": toks})
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            pre = self._moe_counts()
        check(pre == {"flash_attention": n, "rmsnorm": 2 * n + 1,
                      "swiglu": n, "rmsnorm_bwd": 0, "swiglu_bwd": 0},
              f"moe: prefill launches {pre} (16/33/16 expected)")
        check(logits.shape == (MOE_PREFILL_BATCH, vocab) and bool(torch.isfinite(logits).all())
              and len(caches["seg_00"]) == n
              and all(c[key].shape == (MOE_PREFILL_BATCH, TRAIN_SEQ,
                                       cfg.n_kv_heads, cfg.hd)
                      and c[key].dtype == torch.bfloat16
                      for c in caches["seg_00"] for key in ("k", "v")),
              "moe: prefill logits finite, caches (4, 4096, 16, 128) x 16")
        del caches
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            again, caches = model.prefill({"tokens": toks})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del caches
        prefill_s = statistics.median(times)
        # one more under the profiler (device activity only)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, caches = model.prefill({"tokens": toks})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        del caches
        res["profiled_prefill"] = self._step_breakdown(prof, wall)
        res["prefill"] = {
            "batch": MOE_PREFILL_BATCH, "seq": TRAIN_SEQ,
            "first_call_s": first_s,
            "seconds": times, "median_s": prefill_s,
            "tokens_per_s": MOE_PREFILL_BATCH * TRAIN_SEQ / prefill_s,
            "launches": pre,
            "repeat_bitwise": bool(torch.equal(again, logits)),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        for key in launches:
            launches[key] += pre[key]
        # the kernels against the plain versions at full depth
        model.backend, model.cfg = "plain", cfg.replace(attn_impl="chunked")
        with _Routing(torch) as rp:
            lp, caches = model.prefill({"tokens": toks})
        del caches
        model.backend, model.cfg = "auto", cfg
        res["kernels_vs_plain_bf16"] = self._bf16_logits_agree(
            "moe prefill (4, 4096), kernels vs plain", logits, lp,
            MOE_BF16_LOGIT_TOL)
        res["routing"] = self._routing_agree(
            "bf16 prefill (4, 4096), kernels vs plain", cfg, rk, rp,
            TRAIN_SEQ)
        emit({"phase": "moe", "routing": res["routing"]})
        del rk, rp, lp, again
        torch.cuda.empty_cache()
        # the main path, serving: counts from 0 just before, read just after
        eng = ServeEngine(model, n_slots=4, cache_len=256)
        reqs = [Request(uid=i, prompt=rng.integers(0, vocab,
                                                    MOE_SERVE_PROMPT),
                        max_new=MOE_SERVE_MAX_NEW) for i in range(4)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        served = self._moe_counts()
        calls = eng.n_decode_calls
        check(served == {"flash_attention": 0, "rmsnorm": (2 * n + 1) * calls,
                         "swiglu": n * calls, "rmsnorm_bwd": 0,
                         "swiglu_bwd": 0},
              f"moe: engine launches {served} for {calls} decode steps "
              "(33/16 per step expected)")
        check(len(done) == 4
              and all(len(r.out) == MOE_SERVE_MAX_NEW for r in done)
              and all(0 <= t < vocab for r in done for t in r.out),
              f"moe: 4 requests of {MOE_SERVE_MAX_NEW} tokens in the "
              "vocabulary")
        for key in launches:
            launches[key] += served[key]
        steps = eng.step_seconds
        res["serve"] = {
            "requests": 4, "prompt": MOE_SERVE_PROMPT,
            "max_new": MOE_SERVE_MAX_NEW,
            "slots": 4, "cache_len": 256, "seconds": run_s,
            "decode_calls": calls, "ticks": len(steps),
            "step_p50_ms": float(np.percentile(steps, 50)) * 1e3,
            "step_p99_ms": float(np.percentile(steps, 99)) * 1e3,
            "new_tokens_per_s_run": sum(len(r.out) for r in done) / run_s,
            "launches": served,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        res["decode_idle"] = self._decode_idle(model, eng, steps)
        del eng
        # decode_step after prefill(64) against prefill(65), no drops
        model.cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_ORACLE_CF))
        short = rng.integers(0, vocab, (1, 65))
        _, c64 = model.prefill({"tokens": short[:, :64]})
        l65, _ = model.prefill({"tokens": short})
        pad = {seg: [{k: torch.cat([c[k], torch.zeros_like(c[k][:, :1])], 1)
                      for k in c} for c in layers]
               for seg, layers in c64.items()}
        ld, _ = model.decode_step(pad, short[:, 64:65],
                                  np.full((1,), 64, np.int64))
        model.cfg = cfg
        res["decode_vs_prefill_bf16"] = self._bf16_logits_agree(
            "moe decode_step after prefill(64) vs prefill(65), capacity "
            f"factor {MOE_ORACLE_CF}", ld, l65, MOE_BF16_LOGIT_TOL)
        del model, c64, pad
        torch.cuda.empty_cache()
        return res

    def _moe_train(self, base, launches) -> dict:
        """olmoe at full width and MOE_TRAIN_LAYERS layers, bf16, remat
        "full", chunked attention: MOE_TRAIN_STEPS steps of MOE_TRAIN_BATCH
        x TRAIN_SEQ tokens with exact launch counts a step, the first
        MOE_TRAIN_PLAIN_STEPS against the plain versions from the same
        state; step p50, tokens/s, peak memory and the model-FLOP share
        with the active parameters.  Then full width, 2 layers, f32: the
        loss and every gradient against the plain versions."""
        torch = self.torch
        from repro_torch.configs import TrainConfig
        from repro_torch.data.tokens import TokenPipeline
        from repro_torch.kernels import ops
        from repro_torch.models import build_model
        from repro_torch.training import make_train_step, train_state_init
        from torch.profiler import ProfilerActivity, profile
        cfg = base.replace(n_layers=MOE_TRAIN_LAYERS)
        n, b, s = cfg.n_layers, MOE_TRAIN_BATCH, TRAIN_SEQ
        tokens = b * s
        tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                           total_steps=MOE_TRAIN_STEPS)
        pipe = TokenPipeline(cfg.vocab, b, s, seed=self.seed)
        # per step with remat "full": each block's two norms and its swiglu
        # run again in the backward's recompute
        per_step = {"flash_attention": 0, "rmsnorm": 4 * n + 1,
                    "swiglu": 2 * n, "rmsnorm_bwd": 2 * n + 1,
                    "swiglu_bwd": n}
        seed = self.seed + 620
        t0 = time.perf_counter()
        model = build_model(cfg, device=self.dev).init(
            torch.Generator(device=self.dev).manual_seed(seed))
        params = {k: p.detach() for k, p in model.named_parameters()}
        probe = {k: params[k][:2].clone() for k in (
            "tok_embed", "segments.seg_00.0.we_g",
            "segments.seg_00.0.router")}
        n_params = sum(p.numel() for p in params.values())
        check(n_params == 1_045_178_368,
              f"moe train: {n_params} parameters at {n} layers")
        state = train_state_init(params, tcfg)
        step = make_train_step(model, tcfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        # the main path: counts from 0 just before, read just after
        ops.reset_launch_counts()
        mets, times, first, breakdown = [], [], None, None
        for i in range(MOE_TRAIN_STEPS):
            # step 2 under the profiler (device activity only), so that
            # the p50 over steps 3 on is of unprofiled steps
            prof = profile(activities=[ProfilerActivity.CUDA]) \
                if i == 1 else contextlib.nullcontext()
            t0 = time.perf_counter()
            with prof:
                state, m = step(state, pipe.batch_at(i))
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            mets.append({k: float(v) for k, v in m.items()})
            if first is None:
                first = self._moe_counts()
            if i == 1:
                breakdown = self._step_breakdown(prof, times[-1])
        counts = self._moe_counts()
        peak = torch.cuda.max_memory_allocated()
        check(first == per_step,
              f"moe train: launches of one step {first}, expected {per_step}")
        check(counts == {k: MOE_TRAIN_STEPS * v for k, v in per_step.items()},
              f"moe train: launches of {MOE_TRAIN_STEPS} steps {counts}")
        check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                  for m in mets) and [int(m["step"]) for m in mets]
              == list(range(1, MOE_TRAIN_STEPS + 1)),
              f"moe train: losses and grad norms finite, steps counted: "
              f"{mets}")
        for key in launches:
            launches[key] += counts[key]
        # the plain versions from the same state
        del state
        torch.cuda.empty_cache()
        model.init(torch.Generator(device=self.dev).manual_seed(seed))
        check(all(torch.equal(params[k][:2], v) for k, v in probe.items()),
              "moe train: the weights drawn again from the seed are the same")
        state = train_state_init(params, tcfg)
        plain = make_train_step(build_model(cfg, device="meta",
                                            backend="plain"), tcfg)
        ops.reset_launch_counts()
        pmets, ptimes = [], []
        for i in range(MOE_TRAIN_PLAIN_STEPS):
            t0 = time.perf_counter()
            state, m = plain(state, pipe.batch_at(i))
            torch.cuda.synchronize()
            ptimes.append(time.perf_counter() - t0)
            pmets.append({k: float(v) for k, v in m.items()})
        check(all(v == 0 for v in self._moe_counts().values()),
              "moe train: the plain run launched a kernel")
        agree = []
        for i, (k, p) in enumerate(zip(mets, pmets)):
            dl = abs(k["loss"] - p["loss"]) / abs(p["loss"])
            dg = abs(k["grad_norm"] - p["grad_norm"]) / p["grad_norm"]
            check(dl <= TRAIN_LOSS_TOL and dg <= TRAIN_GNORM_TOL
                  and k["lr"] == p["lr"],
                  f"moe train: step {i + 1} kernels {k} against plain {p}")
            agree.append({"step": i + 1, "loss_rel": dl, "grad_norm_rel": dg})
        del state, params, model, step, plain
        torch.cuda.empty_cache()
        p50 = statistics.median(times[2:])
        flops = self._flop_shares(cfg, b, s, n_params, p50)
        res = {
            "layers": n, "d_model": cfg.d_model, "dtype": cfg.dtype,
            "remat": cfg.remat, "attn_impl": cfg.attn_impl,
            "moe_impl": cfg.moe.impl, "batch": b, "seq": s,
            "steps": MOE_TRAIN_STEPS, "params": n_params,
            "active_params": flops["active_params"], "init_s": init_s,
            "step_seconds": times,
            f"step_p50_s_steps_3_to_{MOE_TRAIN_STEPS}": p50,
            "tokens_per_s": tokens / p50, "peak_memory_gb": peak / 1e9,
            "flops": flops, "profiled_step": breakdown,
            "metrics": mets, "launches_one_step": first, "launches": counts,
            "plain_metrics": pmets, "plain_step_seconds": ptimes,
            "kernels_vs_plain": agree,
            "tol": {"loss": TRAIN_LOSS_TOL, "grad_norm": TRAIN_GNORM_TOL}}
        res["f32_2_layers"] = self._moe_train_f32(base, pipe)
        return res

    def _moe_train_f32(self, base, pipe) -> dict:
        """Full width, 2 layers, f32: the loss and every gradient with the
        kernels against the plain versions on one 1 x MOE_F32_SEQ batch,
        with the routing flips of the two runs' router calls."""
        torch = self.torch
        from repro_torch.data.tokens import TokenPipeline
        from repro_torch.models import build_model
        from repro_torch.training import loss_and_grads
        cfg2 = base.replace(n_layers=2, dtype="float32")
        model = build_model(cfg2, device=self.dev).init(
            torch.Generator(device=self.dev).manual_seed(self.seed + 621))
        params = {k: p.detach() for k, p in model.named_parameters()}
        batch = TokenPipeline(cfg2.vocab, 1, MOE_F32_SEQ,
                              seed=self.seed).batch_at(0)
        with _Routing(torch) as rk:
            lk, gk = loss_and_grads(model, params, batch)
        with _Routing(torch) as rp:
            lp, gp = loss_and_grads(
                build_model(cfg2, device="meta", backend="plain"), params,
                batch)
        flips = [int((a["top_i"] != c["top_i"]).any(-1).sum())
                 for a, c in zip(rk.calls, rp.calls)]
        loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
        worst, worst_name = 0.0, ""
        for k in gp:
            scale = float(gp[k].abs().max())
            r = float((gk[k] - gp[k]).abs().max()) / max(scale, 1e-30)
            if r > worst:
                worst, worst_name = r, k
        check(math.isfinite(float(lk)) and loss_rel <= TRAIN_F32_LOSS_RTOL
              and worst <= TRAIN_F32_GRAD_TOL,
              f"moe train f32: loss rel {loss_rel}, worst gradient "
              f"{worst_name} {worst} of its max abs; routing flips {flips}")
        del model, params, gk, gp
        torch.cuda.empty_cache()
        return {"batch": 1, "seq": MOE_F32_SEQ, "loss": float(lk),
                "loss_rel": loss_rel, "worst_grad_err_over_max": worst,
                "worst_grad": worst_name, "router_calls": len(flips),
                "routing_flips": flips,
                "tol": {"loss_rel": TRAIN_F32_LOSS_RTOL,
                        "grad": TRAIN_F32_GRAD_TOL}}

    def _moe_phi(self, launches) -> dict:
        """phi3.5-moe-42b-a6.6b at full width and 2 layers, bf16: a 1 x 4096
        prefill through the kernels (exact launches) against the plain
        versions, with the routing flips between them."""
        torch = self.torch
        import numpy as np
        from repro_torch.configs import get_arch
        from repro_torch.kernels import ops
        from repro_torch.models import build_model
        cfg = get_arch("phi3.5-moe-42b-a6.6b").replace(n_layers=2,
                                                       attn_impl="flash")
        check(cfg.d_model == 4096 and cfg.n_heads == 32
              and cfg.n_kv_heads == 8 and cfg.d_ff == 6400
              and cfg.moe.n_experts == 16 and cfg.moe.top_k == 2
              and cfg.dtype == "bfloat16", "moe: phi3.5-moe's configuration")
        t0 = time.perf_counter()
        model = build_model(cfg, device=self.dev).init(
            torch.Generator(device=self.dev).manual_seed(self.seed + 630))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        toks = np.random.default_rng(self.seed + 630).integers(
            0, cfg.vocab, (1, TRAIN_SEQ))
        with _Routing(torch) as rk:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            lk, caches = model.prefill({"tokens": toks})
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            counts = self._moe_counts()
        check(counts == {"flash_attention": 2, "rmsnorm": 5, "swiglu": 2,
                         "rmsnorm_bwd": 0, "swiglu_bwd": 0}
              and caches["seg_00"][0]["k"].shape == (1, TRAIN_SEQ, 8, 128),
              f"moe phi3.5: prefill launches {counts}")
        for key in launches:
            launches[key] += counts[key]
        del caches
        model.backend, model.cfg = "plain", cfg.replace(attn_impl="chunked")
        with _Routing(torch) as rp:
            lp, _ = model.prefill({"tokens": toks})
        res = {"layers": 2, "seq": TRAIN_SEQ, "init_s": init_s,
               "prefill_first_call_s": prefill_s,
               "params": model.param_count(), "launches": counts,
               "kernels_vs_plain_bf16": self._bf16_logits_agree(
                   "phi3.5-moe prefill (1, 4096), kernels vs plain", lk, lp,
                   MOE_BF16_LOGIT_TOL),
               "routing": self._routing_agree(
                   "phi3.5-moe bf16 prefill, kernels vs plain", cfg, rk, rp,
                   TRAIN_SEQ)}
        del model, rk, rp
        torch.cuda.empty_cache()
        return res

    def _moe_kernel_times(self):
        """swiglu and swiglu_bwd on olmoe's expert-grouped prefill tensor
        (4, 64, 640, 1024) bf16, and flash_attention at its prefill
        (4, 16/16, 4096, 128) bf16, each against its plain version and
        timed beside the bound (and, for flash, SDPA)."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import ref
        from repro_torch.kernels.flash_attention import flash_attention
        from repro_torch.kernels.swiglu import swiglu, swiglu_bwd
        g = torch.Generator(device=self.dev).manual_seed(self.seed + 640)
        bf16 = torch.bfloat16

        def randn(shape, mul=1.0):
            return (torch.randn(shape, generator=g, device=self.dev)
                    * mul).to(bf16)
        with torch.inference_mode():
            shape = (4, 64, 640, 1024)
            a, u, dy = randn(shape, 3.0), randn(shape), randn(shape)
            self._lm_agree("swiglu", f"moe {list(shape)} bf16", swiglu(a, u),
                           ref.swiglu_ref(a, u))
            dg, du = swiglu_bwd(a, u, dy)
            pg, pu = ref.swiglu_bwd_ref(a, u, dy)
            self._lm_agree("swiglu_bwd", f"moe {list(shape)} bf16 dgate", dg,
                           pg)
            self._lm_agree("swiglu_bwd", f"moe {list(shape)} bf16 dup", du, pu)
            del dg, du, pg, pu
            self._time_kernel(
                "swiglu", "moe_prefill", lambda: swiglu(a, u),
                lambda: ref.swiglu_ref(a, u), flops=5.0 * a.numel(),
                nbytes=2.0 * 3 * a.numel(), gate=list(shape),
                dtype="bfloat16")
            self._time_kernel(
                "swiglu_bwd", "moe_train", lambda: swiglu_bwd(a, u, dy),
                lambda: ref.swiglu_bwd_ref(a, u, dy),
                flops=12.0 * a.numel(), nbytes=2.0 * 5 * a.numel(),
                gate=list(shape), dtype="bfloat16")
            del a, u, dy
            b, h, s, dh = 4, 16, 4096, 128
            q, k, v = (randn((b, s, h, dh)).transpose(1, 2)
                       for _ in range(3))
            self._lm_agree("flash_attention",
                           f"moe prefill {list(q.shape)} bf16 views",
                           flash_attention(q, k, v),
                           ref.flash_attention_ref(q, k, v))
            torch.cuda.empty_cache()
            flops = 2.0 * s * s * dh * b * h     # both products, causal half
            self._time_kernel(
                "flash_attention", "moe_prefill",
                lambda: flash_attention(q, k, v),
                lambda: ref.flash_attention_ref(q, k, v),
                flops=flops, nbytes=2.0 * 4 * q.numel(),
                peak_flops=PEAK_BF16_FLOPS,
                library=lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True),
                q=list(q.shape), kv=list(k.shape), dtype="bfloat16",
                causal=True, sdpa=self._sdpa_backends(q, k, v))
            del q, k, v
        torch.cuda.empty_cache()

    # ---------------------------------------------------- serve_clusters
    def serve_clusters(self):
        """The train-while-serve pipeline (`launch/serve_clusters.run_demo`)
        on the card: 2 tenants, each a trainer thread streaming 65,536
        points through `partial_fit` (Pb 2048, batches of 5,000, adaptive
        cap, delta store with an eager shadow), 16 client threads behind a
        coalescing router, then the QoS A/B (priority lanes against FIFO)
        with a live trainer.  `run_demo` audits every response itself
        (zero stale reads by replay, serve == train against the plain
        version request by request, delta == eager, stream == one-shot,
        coalesced fill above solo, lanes' interactive p99 below FIFO's,
        shedding in the priority arm only); an audit that fails fails the
        phase."""
        from repro_torch.kernels import ops
        from repro_torch.launch.serve_clusters import (
            ServeDemoConfig, run_demo,
        )
        self._ensure_built()
        cfg = ServeDemoConfig(
            n=SC_N, dim=16, n_models=2, lam=4.0, k_max=512, pb=2048,
            train_batch=5000, min_queries=10_000, max_request=32,
            n_clients=16, coalesce_bucket=64, coalesce_delay_ms=10.0,
            min_versions=3, qos_n=SC_QOS_N, qos_interactive_clients=6,
            qos_analytics_clients=2, qos_interactive_requests=120,
            qos_analytics_requests=25, qos_analytics_rows=24,
            qos_interactive_deadline_ms=10.0,
            qos_analytics_deadline_ms=250.0, qos_shed_depth=48,
            seed=self.seed, quiet=True, device="cuda")
        self.torch.cuda.synchronize()
        # --- the main path: counts from 0 just before, read just after ---
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            rec = run_demo(cfg)
        except AssertionError as e:
            raise CheckFailed(f"serve_clusters: audit failed: {e}")
        seconds = time.perf_counter() - t0
        launches = {"dpmeans_assign": ops.ASSIGN_LAUNCHES,
                    "topk_stream": ops.TOPK_LAUNCHES,
                    "dpmeans_assign_by_tile": dict(ops.ASSIGN_TILE_LAUNCHES)}
        # -----------------------------------------------------------------
        self.path_launches["serve_clusters"] = launches
        q, f = rec["qos_ab"]["qos"], rec["qos_ab"]["fifo"]
        check(rec["device"].startswith("cuda"), "serve_clusters: on the card")
        check(launches["dpmeans_assign"] > 0 and launches["topk_stream"] > 0,
              f"serve_clusters: kernels launched {launches}")
        check(rec["zero_stale_reads"] and rec["serve_train_parity"]
              and rec["n_queries"] >= 10_000
              and min(rec["n_versions_observed"].values()) >= 3
              and q["n_shed"] > 0 and f["n_shed"] == 0
              and q["interactive_p99_ms"] < f["interactive_p99_ms"],
              "serve_clusters: the record agrees with the audits")
        emit({"phase": "serve_clusters", "card": self.card,
              "n_per_tenant": SC_N, "tenants": 2, "pb": 2048,
              "train_batch": 5000, "k_max": 512, "seconds": seconds,
              "K": rec["k_final"],
              "versions_published": rec["n_versions_published"],
              "versions_observed": rec["n_versions_observed"],
              "trainer_s": rec["trainer_s"],
              "serve_wall_s": rec["serve_wall_s"], "audit_s": rec["audit_s"],
              "qos_s": rec["qos_s"], "rows": rec["n_queries"],
              "requests": rec["n_requests"],
              "microbatches": rec["n_microbatches"],
              "dispatches_replayed": rec["n_replayed"],
              "qps": rec["qps"], "p50_ms": rec["p50_latency_ms"],
              "p99_ms": rec["p99_latency_ms"],
              "fill_coalesced": rec["bucket_fill_coalesced"],
              "fill_solo": rec["bucket_fill_solo"],
              "requests_per_group": rec["requests_per_group"],
              "zero_stale_reads": rec["zero_stale_reads"],
              "serve_train_parity": rec["serve_train_parity"],
              "delta_eq_eager": rec["delta_eq_eager"],
              "stream_eq_oneshot": rec["stream_eq_oneshot"],
              "qos": {arm: {key: rec["qos_ab"][arm][key] for key in (
                  "interactive_p50_ms", "interactive_p99_ms", "n_shed",
                  "n_degraded_replayed", "n_replayed", "n_interactive",
                  "n_analytics", "versions_published", "wall_s")}
                  for arm in ("qos", "fifo")},
              "interactive_p99_speedup":
                  rec["qos_ab"]["interactive_p99_speedup"],
              "launches": launches})

    # ---------------------------------------------------------- curation
    def curation(self):
        """OCC data curation (`examples/data_curation.py`) at granite-3-2b's
        full width and depth in bf16, random weights: 2,048 sequences of
        256 tokens from `TokenPipeline` (128 batches of 16; every 16th
        batch replaced by 16 copies of its first sequence), embedded by
        `embed_sequences` (flash, rmsnorm, swiglu at (16, 32/8, 256, 64),
        (4096, 2048), (4096, 8192)) and clustered by `curate` (OCC
        DP-means, `dpmeans_assign` at D = 2048).  Checked: each batch of
        copies has equal embeddings and one cluster, duplicates are found
        and down-weighted, the first batch's embeddings through the plain
        versions agree (the first two batches), and the labels equal a
        curate run with propose on the plain version on the same
        embeddings.  Then the new shapes of
        the four kernels against their plain versions, and their times."""
        torch = self.torch
        import numpy as np
        from repro_torch.configs import get_arch
        from repro_torch.data.curation import curate, embed_sequences
        from repro_torch.data.tokens import TokenPipeline
        from repro_torch.kernels import ops
        from repro_torch.models import build_model
        self._ensure_built()
        cfg = get_arch("granite-3-2b").replace(attn_impl="flash")
        gen = torch.Generator(device=self.dev).manual_seed(self.seed + 19)
        model = build_model(cfg, device=self.dev).init(gen)
        pipe = TokenPipeline(cfg.vocab, global_batch=CUR_BATCH,
                             seq_len=CUR_SEQ, seed=0)
        batches = [pipe.batch_at(s) for s in range(CUR_BATCHES)]
        dup_batches = list(range(0, CUR_BATCHES, 16))
        for s in dup_batches:
            batches[s] = dict(batches[s])
            batches[s]["tokens"] = np.tile(batches[s]["tokens"][:1],
                                           (CUR_BATCH, 1))
        torch.cuda.synchronize()
        # --- the main path: counts from 0 just before, read just after ---
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        embeds = embed_sequences(model, batches)
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        med = float(torch.median(torch.linalg.vector_norm(
            embeds - embeds.mean(0), dim=1)))
        lam = 0.5 * med
        t0 = time.perf_counter()
        rep = curate(embeds, lam=lam, pb=CUR_PB, k_max=CUR_K_MAX)
        curate_s = time.perf_counter() - t0
        counts = {"dpmeans_assign": ops.ASSIGN_LAUNCHES, **self._lm_counts(),
                  "dpmeans_assign_by_tile": dict(ops.ASSIGN_TILE_LAUNCHES)}
        # -----------------------------------------------------------------
        self.path_launches["curation"] = counts
        n_seq = CUR_BATCHES * CUR_BATCH
        layers = cfg.n_layers
        epochs = int(rep.result.stats.proposed.shape[0])
        check(counts["flash_attention"] == layers * CUR_BATCHES
              and counts["swiglu"] == layers * CUR_BATCHES
              and counts["rmsnorm"] == counts["rmsnorm_one_read"]
              == 2 * layers * CUR_BATCHES
              and counts["dpmeans_assign"] == epochs > 0
              and counts["dpmeans_assign_by_tile"]["wide"] == epochs,
              f"curation: launches {counts} for {CUR_BATCHES} forwards of "
              f"{layers} layers and {epochs} epochs (every propose on the "
              "wide tile)")
        check(tuple(embeds.shape) == (n_seq, cfg.d_model)
              and embeds.dtype == torch.float32
              and bool(torch.isfinite(embeds).all()),
              f"curation: embeddings {tuple(embeds.shape)} finite f32")
        z = rep.result.z.cpu().numpy()
        for s in dup_batches:
            rows = slice(s * CUR_BATCH, (s + 1) * CUR_BATCH)
            e = embeds[rows]
            check(bool((e == e[:1]).all()) and len(set(z[rows])) == 1,
                  f"curation: batch {s} of copies: equal embeddings and "
                  "one cluster")
        w = rep.keep_weight
        check(rep.dup_fraction > 0 and bool((w <= 1.0).all())
              and 1 <= rep.n_clusters <= CUR_K_MAX,
              f"curation: K={rep.n_clusters}, dup_fraction "
              f"{rep.dup_fraction}, weights <= 1")
        # the first two batches (the first is one sequence's copies)
        # through the plain versions, the same weights
        pm = build_model(cfg.replace(attn_impl="chunked"), device=self.dev,
                         backend="plain")
        pm.load_state_dict(model.state_dict())
        plain_first = embed_sequences(pm, batches[:2])
        del pm
        torch.cuda.empty_cache()
        first = embeds[:2 * CUR_BATCH]
        err = float((first - plain_first).abs().max())
        scale = float(plain_first.abs().max())
        check(err <= BF16_LOGIT_TOL * scale,
              f"curation: embeddings kernels vs plain {err} > "
              f"{BF16_LOGIT_TOL} x {scale}")
        # the same clustering with propose on the plain version
        plain_rep, t_plain = self._curate_plain(embeds, lam)
        zp = plain_rep.result.z.cpu().numpy()
        ties = self._curation_ties(embeds, rep, plain_rep)
        check(plain_rep.n_clusters == rep.n_clusters
              and all(t["tie"] for t in ties),
              f"curation: K {rep.n_clusters} vs plain propose "
              f"{plain_rep.n_clusters}; rows that differ {ties[:8]}")
        emit({"phase": "curation", "card": self.card, "arch": "granite-3-2b",
              "dtype": "bfloat16", "layers": layers, "sequences": n_seq,
              "seq_len": CUR_SEQ, "tokens": n_seq * CUR_SEQ,
              "forward_s": forward_s,
              "tokens_per_s": n_seq * CUR_SEQ / forward_s,
              "lam": lam, "pb": CUR_PB, "k_max": CUR_K_MAX,
              "K": rep.n_clusters, "overflow": bool(rep.result.pool.overflow),
              "epochs": epochs, "curate_s": curate_s,
              "curate_plain_propose_s": t_plain,
              "dup_fraction": rep.dup_fraction,
              "downweighted": int((w < 1).sum()),
              "dup_batches": dup_batches,
              "embed_plain_max_abs_err": err, "embed_scale": scale,
              "labels_differ": int((z != zp).sum()), "tie_rows": ties,
              "launches": counts})
        self._curation_kernels(embeds, rep)

    def _curate_plain(self, embeds, lam):
        """`curate` on the same embeddings with propose on the plain
        version (the kernel's comparison run; it launches nothing)."""
        from repro_torch.core import dp_means
        from repro_torch.core.occ import nearest_center
        from repro_torch.data.curation import curate

        class PlainDP(dp_means.DPMeansTransaction):
            def propose(self, pool, x_e, state_e):
                d2, idx = nearest_center(pool, x_e, backend="plain")
                return (d2 > dp_means._lam2(self.lam, d2.dtype), x_e,
                        (d2, idx), idx)
        real = dp_means.DPMeansTransaction
        dp_means.DPMeansTransaction = PlainDP
        try:
            t0 = time.perf_counter()
            rep = curate(embeds, lam=lam, pb=CUR_PB, k_max=CUR_K_MAX)
            return rep, time.perf_counter() - t0
        finally:
            dp_means.DPMeansTransaction = real

    def _curation_ties(self, embeds, rep, plain_rep) -> list[dict]:
        """Each row whose label differs between the kernel's run and the
        plain run: its squared distances (f64) to its center in each run,
        and whether they agree within REL_TOL of ||x||^2 + ||c||^2 (a tie
        the two summation orders break differently)."""
        torch = self.torch
        zk, zp = rep.result.z, plain_rep.result.z
        rows = torch.nonzero(zk != zp).flatten().tolist()
        out = []
        for r in rows:
            x = embeds[r].double()
            ck = rep.result.pool.centers[int(zk[r])].double()
            cp = plain_rep.result.pool.centers[int(zp[r])].double()
            dk, dp = float(((x - ck) ** 2).sum()), float(((x - cp) ** 2).sum())
            scale = float((x * x).sum()) + max(float((ck * ck).sum()),
                                               float((cp * cp).sum()))
            out.append({"row": r, "z": int(zk[r]), "z_plain": int(zp[r]),
                        "d2": dk, "d2_plain": dp,
                        "tie": abs(dk - dp) <= REL_TOL * scale})
        return out

    def _curation_kernels(self, embeds, rep):
        """The four kernels at curation's shapes against their plain
        versions (dpmeans_assign on the real embeddings and pool at
        D = 2048, the wide tile, and on random inputs there; each also bit
        for bit against the generic tile and `topk_stream`'s first column
        at k = 8), and their times: dpmeans_assign (256, 512, 2048) f32
        beside the generic tile, flash (16, 32/8,
        256, 64) bf16 causal against SDPA, rmsnorm (4096, 2048) bf16
        against `F.rms_norm`, swiglu (4096, 8192) bf16."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import ref
        from repro_torch.kernels.flash_attention import flash_attention
        from repro_torch.kernels.rmsnorm import rmsnorm
        from repro_torch.kernels.swiglu import swiglu
        from repro_torch.kernels.dpmeans_assign import _generic
        from repro_torch.kernels.topk_stream import topk_stream
        pool = rep.result.pool
        cnt = pool.count.reshape(1).to(torch.int32)
        xe = embeds[:CUR_PB].contiguous()
        xl = embeds[-CUR_PB:].contiguous()
        x, c, mask, rcnt = self._inputs(CUR_PB, CUR_K_MAX, 2048,
                                        count=int(pool.count), seed=19)
        for name, args in (
                ("curation_propose", (xe, pool.centers, pool.mask, cnt)),
                ("curation_propose_last_epoch",
                 (xl, pool.centers, pool.mask, cnt)),
                ("d2048_random", (x, c, mask, rcnt))):
            d2k, ik = self._compare(name, *args)
            # the wide tile: the generic tile's bits, and topk_stream's
            # first column at k = 8 (its generic tile)
            d2g, ig = _generic(*args)
            d2t, it = topk_stream(*args, 8)
            check(torch.equal(d2k, d2g) and torch.equal(ik, ig),
                  f"{name}: wide tile == generic tile, bitwise")
            check(torch.equal(d2k, d2t[:, 0]) and torch.equal(ik, it[:, 0]),
                  f"{name}: topk_stream k=8 first column == dpmeans_assign, "
                  "bitwise")
        self._time("curation", xe, pool.centers, pool.mask, cnt,
                   generic=True)
        g = torch.Generator(device=self.dev).manual_seed(self.seed + 1900)
        bf16 = torch.bfloat16

        def randn(shape, mul=1.0):
            return (torch.randn(shape, generator=g, device=self.dev)
                    * mul).to(bf16)
        b, s, h, hkv, dh, d, dff = (CUR_BATCH, CUR_SEQ, 32, 8, 64, 2048,
                                    8192)
        with torch.inference_mode():
            q = randn((b, s, h, dh)).transpose(1, 2)
            k = randn((b, s, hkv, dh)).transpose(1, 2)
            v = randn((b, s, hkv, dh)).transpose(1, 2)
            case = f"bf16 curation {list(q.shape)} / {list(k.shape)}"
            got, want = flash_attention(q, k, v), ref.flash_attention_ref(
                q, k, v)
            self._lm_agree("flash_attention", case, got, want)
            del got, want
            flops = 2.0 * s * s * dh * b * h
            self._time_kernel(
                "flash_attention", "curation",
                lambda: flash_attention(q, k, v),
                lambda: ref.flash_attention_ref(q, k, v),
                flops=flops, nbytes=2.0 * (2 * q.numel() + 2 * k.numel()),
                peak_flops=PEAK_BF16_FLOPS,
                library=lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True),
                q=list(q.shape), kv=list(k.shape), dtype="bfloat16",
                causal=True, sdpa=self._sdpa_backends(q, k, v))
            x, w = randn((b * s, d)), randn((d,))
            self._lm_agree("rmsnorm", f"bf16 curation {(b * s, d)}",
                           rmsnorm(x, w, 1e-6), ref.rmsnorm_ref(x, w, 1e-6))
            self._time_kernel(
                "rmsnorm", "curation", lambda: rmsnorm(x, w, 1e-6),
                lambda: ref.rmsnorm_ref(x, w, 1e-6),
                flops=4.0 * x.numel(),
                nbytes=2.0 * (2 * x.numel() + w.numel()),
                library=lambda: F.rms_norm(x, (d,), w, 1e-6),
                x=list(x.shape), dtype="bfloat16")
            a, u = randn((b * s, dff), 3.0), randn((b * s, dff))
            self._lm_agree("swiglu", f"bf16 curation {(b * s, dff)}",
                           swiglu(a, u), ref.swiglu_ref(a, u))
            self._time_kernel(
                "swiglu", "curation", lambda: swiglu(a, u),
                lambda: ref.swiglu_ref(a, u), flops=5.0 * a.numel(),
                nbytes=2.0 * 3 * a.numel(), gate=list(a.shape),
                dtype="bfloat16")

    # ---------------------------------------------------------- examples
    def examples(self):
        """Each ported example (`repro_torch.examples.*`) at its own sizes on
        the card: quickstart, streaming_clusters and crash_recovery (their
        integers equal to the same example's run on the CPU),
        observability with its multi-process act (`--ha`), retrieval_index
        over the index the retrieval phase trained, serve_lm, data_curation
        and train_lm (its loss falls)."""
        from repro_torch.examples import (
            crash_recovery, data_curation, observability, quickstart,
            retrieval_index, serve_lm, streaming_clusters, train_lm,
        )
        from repro_torch.kernels import ops
        self._ensure_built()
        if getattr(self, "retrieval_built", None) is None:
            self.retrieval()
        res, secs = {}, {}
        self.torch.cuda.synchronize()
        # --- the main path: counts from 0 just before, read just after ---
        ops.reset_launch_counts()
        with tempfile.TemporaryDirectory() as tmp:
            for name, call in (
                    ("quickstart", lambda: quickstart.main([])),
                    ("streaming_clusters",
                     lambda: streaming_clusters.main([])),
                    ("crash_recovery", lambda: crash_recovery.main([])),
                    ("observability", lambda: observability.main(
                        ["--ha", "--out-dir", tmp])),
                    ("retrieval_index", lambda: retrieval_index.main(
                        ["--quiet"], index=self.retrieval_built)),
                    ("serve_lm", lambda: serve_lm.main([])),
                    ("data_curation", lambda: data_curation.main([])),
                    ("train_lm", lambda: _losses_of(train_lm.main, []))):
                t0 = time.perf_counter()
                try:
                    res[name] = call()
                except AssertionError as e:
                    raise CheckFailed(f"examples {name}: {e}")
                self.torch.cuda.synchronize()
                secs[name] = time.perf_counter() - t0
        counts = {"dpmeans_assign": ops.ASSIGN_LAUNCHES,
                  "topk_stream": ops.TOPK_LAUNCHES,
                  "topk_multiprobe_stream": ops.TOPK_MP_LAUNCHES,
                  **self._lm_counts(),
                  "rmsnorm_bwd": ops.RMSNORM_BWD_LAUNCHES,
                  "swiglu_bwd": ops.SWIGLU_BWD_LAUNCHES,
                  "dpmeans_assign_by_tile": dict(ops.ASSIGN_TILE_LAUNCHES)}
        # -----------------------------------------------------------------
        self.path_launches["examples"] = counts
        # (the examples' language models take chunked attention, as the
        # JAX package's do: no flash launch here)
        check(all(counts[k] > 0 for k in KERNELS if k != "flash_attention"),
              f"examples: kernels launched {counts}")
        cpu = {"quickstart": quickstart.main(["--device", "cpu"]),
               "streaming_clusters": streaming_clusters.main(
                   ["--device", "cpu"]),
               "crash_recovery": crash_recovery.main(["--device", "cpu"])}
        for name, want in cpu.items():
            got = {k: v for k, v in res[name].items() if k != "J"}
            want = {k: v for k, v in want.items() if k != "J"}
            check(got == want, f"examples {name}: the card {got} != the "
                  f"CPU {want}")
        q, st, cr = (res["quickstart"], res["streaming_clusters"],
                     res["crash_recovery"])
        obs, ret = res["observability"], res["retrieval_index"]
        lm, dc, tr = res["serve_lm"], res["data_curation"], res["train_lm"]
        check(q["K"] == q["K_serial"] and st["ofl_stream_eq_oneshot"]
              and cr["identical"] and obs["ha"]["promotions"] == 1
              and ret["sweep"]["p_all"]["exact_vs_flat"]
              and ret["k_centers"] >= 100_000
              and lm["requests"] == 6 and lm["new_tokens"] == 48
              and dc["dup_fraction"] > 0
              and math.isfinite(tr["final_loss"])
              and tr["final_loss"] < tr["first_loss"] - 0.1,
              f"examples: outputs (train_lm losses {tr})")
        emit({"phase": "examples", "card": self.card, "seconds": secs,
              "launches": counts,
              "quickstart": q, "streaming_clusters": {
                  "K_dp": st["K_dp"], "K_ofl": st["K_ofl"],
                  "ofl_stream_eq_oneshot": st["ofl_stream_eq_oneshot"]},
              "crash_recovery": cr, "observability": obs,
              "retrieval_index": {k: ret[k] for k in (
                  "k_centers", "n_cells", "shard_cap", "n_queries",
                  "sweep")},
              "serve_lm": {"requests": lm["requests"],
                           "new_tokens": lm["new_tokens"]},
              "data_curation": {k: v for k, v in dc.items() if k != "z"},
              "train_lm": tr,
              "card_eq_cpu": sorted(cpu)})

    # ------------------------------------------------- recurrent families
    def hybrid(self):
        """The hybrid family on the card (`models/ssm.py`, the shared block
        of `models/model.py`): zamba2-7b at full width, f32, 6 layers with
        the kernels against the plain versions (logits of a 1 x 512
        prefill, two chunks of 256, with flash at Dh 112; then the loss and
        every gradient); at full width and depth in bf16 (a 4 x 4096
        prefill with flash, 13 / 108 / 13 launches; its logits against the
        plain versions'; decode_step against a longer prefill; a
        ServeEngine run); trained at full width and REC_TRAIN_LAYERS
        layers.  The launches of the served and trained runs count as the
        path's."""
        from repro_torch.configs import get_arch
        self._ensure_built()
        base = get_arch("zamba2-7b")
        check(base.n_layers == 81 and base.d_model == 3584
              and base.n_heads == base.n_kv_heads == 32 and base.hd == 112
              and base.d_ff == 14336 and base.vocab == 32000
              and base.ssm_state == 64 and base.ssm_head_dim == 64
              and base.ssm_expand == 2 and base.conv_width == 4
              and base.attn_every == 6 and base.ssm_chunk == 256
              and not base.tie_embeddings and base.dtype == "bfloat16"
              and base.remat == "full" and base.attn_impl == "chunked",
              "hybrid: zamba2-7b's configuration")
        check(self._per_call(base) == ({"flash_attention": 13,
                                        "rmsnorm": 108, "swiglu": 13},
                                       {"flash_attention": 0,
                                        "rmsnorm": 108, "swiglu": 13}),
              "hybrid: 13 flash, 108 rmsnorm, 13 swiglu a prefill")
        self._recurrent("hybrid", base, 6_750_498_384, self.seed + 700)

    def xlstm(self):
        """The xLSTM family on the card (`models/xlstm.py`): xlstm-1.3b at
        full width, f32, 8 layers (7 mLSTM, 1 sLSTM) with the kernels
        against the plain versions (logits, then the loss and every
        gradient); at full width and depth in bf16 (a 4 x 4096 prefill,
        49 rmsnorm launches; its logits against the plain versions';
        decode_step against a longer prefill; a ServeEngine run); trained
        at full width and 8 layers.  Its sLSTM runs one step a token from
        the host: the prefill's 6 sLSTM layers are 24,576 steps."""
        from repro_torch.configs import get_arch
        self._ensure_built()
        base = get_arch("xlstm-1.3b")
        check(base.n_layers == 48 and base.d_model == 2048
              and base.n_heads == 4 and base.hd == 512 and base.d_ff == 0
              and base.vocab == 50304 and base.slstm_every == 8
              and base.ssm_chunk == 256 and base.dtype == "bfloat16"
              and base.remat == "full", "xlstm: xlstm-1.3b's configuration")
        check(self._per_call(base)[0] == {"flash_attention": 0,
                                          "rmsnorm": 49, "swiglu": 0},
              "xlstm: 49 rmsnorm a prefill")
        self._recurrent("xlstm", base, 1_175_840_768, self.seed + 800)

    def _per_call(self, cfg) -> tuple[dict, dict]:
        """The language-model kernels' launches of one prefill (flash
        attention) and of one decode_step, from the segments: a norm a
        recurrent block, two (and a swiglu) an attention block with an MLP,
        three a decoder block (its cross-attention's norm), and the final
        norm.  A prefill also norms the frontend's projection (fe_norm) and
        runs the encoder: two norms and a swiglu a layer (its attention
        plain torch), and its final norm."""
        from repro_torch.models.transformer import segments_for
        norms = attn = 0
        for kind, count, _ in segments_for(cfg):
            if kind in ("mamba", "mlstm", "slstm"):
                norms += count
            else:
                attn += count
                norms += count * ((2 if cfg.d_ff else 1)
                                  + (kind == "dec_attn_mlp"))
        ffn = attn if cfg.d_ff else 0
        enc = cfg.enc_layers
        return ({"flash_attention": attn,
                 "rmsnorm": norms + 1 + bool(cfg.frontend)
                 + (2 * enc + 1 if enc else 0),
                 "swiglu": ffn + enc},
                {"flash_attention": 0, "rmsnorm": norms + 1, "swiglu": ffn})

    def _recurrent(self, phase, base, n_params, seed):
        launches = dict.fromkeys(("flash_attention", "rmsnorm", "swiglu",
                                  "rmsnorm_bwd", "swiglu_bwd"), 0)
        res = {}
        t0 = time.perf_counter()
        res["f32"] = self._rec_f32(phase, base, seed + 1)
        res["f32"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["serve"] = self._rec_serve(phase, base, n_params, launches,
                                       seed + 2)
        res["serve"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with self._no_plain_backward(phase):
            res["train"] = self._rec_train(phase, base, launches, seed + 3)
        res["train"]["seconds"] = time.perf_counter() - t0
        res["launches"] = launches
        self.path_launches[phase] = launches
        emit({"phase": phase, "arch": base.name, "card": self.card, **res})

    def _rec_f32(self, phase, base, seed) -> dict:
        """Full width, REC_F32_LAYERS layers, f32: a 1 x REC_F32_SEQ
        prefill with the kernels (exact launches; flash for the attention)
        against the plain versions (chunked attention), within LOGIT_TOL;
        then the loss and every gradient of one batch of that shape
        against the plain versions'."""
        torch = self.torch
        import numpy as np
        from repro_torch.data.tokens import TokenPipeline
        from repro_torch.kernels import ops
        from repro_torch.models import build_model
        from repro_torch.training import loss_and_grads
        cfg = base.replace(n_layers=REC_F32_LAYERS[phase], dtype="float32",
                           attn_impl="flash")
        model = build_model(cfg, device=self.dev).init(
            torch.Generator(device=self.dev).manual_seed(seed))
        toks = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                     (1, REC_F32_SEQ))
        ops.reset_launch_counts()
        lk, _ = model.prefill({"tokens": toks})
        counts = self._moe_counts()
        want = dict(self._per_call(cfg)[0], rmsnorm_bwd=0, swiglu_bwd=0)
        model.backend, model.cfg = "plain", cfg.replace(attn_impl="chunked")
        lp, _ = model.prefill({"tokens": toks})
        check(counts == want and self._moe_counts() == counts,
              f"{phase} f32: prefill launches {counts}, expected {want}, "
              "none for the plain one")
        err = float((lk - lp).abs().max())
        tol = LOGIT_TOL * max(1.0, float(lp.abs().max()))
        check(bool(torch.isfinite(lk).all()) and lk.shape == (1, cfg.vocab)
              and err <= tol,
              f"{phase} f32: prefill logits kernels vs plain {err} > {tol}")
        model.backend, model.cfg = "auto", cfg
        ld, l65 = self._decode_vs_prefill(model, toks[:, :65])
        derr = float((ld - l65).abs().max())
        dtol = REC_F32_DECODE_TOL * max(1.0, float(l65.abs().max()))
        check(derr <= dtol, f"{phase} f32: decode_step after prefill(64) vs "
              f"prefill(65) {derr} > {dtol}")
        # the loss and every gradient (chunked attention, as training runs)
        model.backend, model.cfg = "auto", cfg.replace(attn_impl="chunked")
        params = {k: p.detach() for k, p in model.named_parameters()}
        batch = TokenPipeline(cfg.vocab, 1, REC_F32_SEQ,
                              seed=seed).batch_at(0)
        gl, gk = loss_and_grads(model, params, batch)
        pl, gp = loss_and_grads(
            build_model(model.cfg, device="meta", backend="plain"), params,
            batch)
        loss_rel = abs(float(gl) - float(pl)) / abs(float(pl))
        worst, worst_name = 0.0, ""
        for k in gp:
            scale = float(gp[k].abs().max())
            r = float((gk[k] - gp[k]).abs().max()) / max(scale, 1e-30)
            check(bool(torch.isfinite(gk[k]).all()),
                  f"{phase} f32: gradient {k} not finite")
            if r > worst:
                worst, worst_name = r, k
        check(math.isfinite(float(gl)) and loss_rel <= TRAIN_F32_LOSS_RTOL
              and worst <= REC_F32_GRAD_TOL[phase],
              f"{phase} f32: loss rel {loss_rel}, worst gradient "
              f"{worst_name} {worst} of its max abs")
        del model, params, gk, gp
        torch.cuda.empty_cache()
        return {"layers": cfg.n_layers, "seq": REC_F32_SEQ,
                "launches": counts, "prefill_logit_max_abs_err": err,
                "tol": tol, "decode_vs_prefill_max_abs_err": derr,
                "decode_tol": dtol, "loss": float(gl), "loss_rel": loss_rel,
                "worst_grad_err_over_max": worst, "worst_grad": worst_name,
                "grad_tol": {"loss_rel": TRAIN_F32_LOSS_RTOL,
                             "grad": REC_F32_GRAD_TOL[phase]}}

    def _rec_serve(self, phase, base, n_params, launches, seed) -> dict:
        """Full width and depth, bf16, flash attention, random weights from
        the seed: a 4 x TRAIN_SEQ prefill (exact launches, caches, seconds,
        tokens/s, a profiled repeat); its last-token logits against the
        plain versions'; a ServeEngine run of 4 requests (prompt
        REC_SERVE_PROMPT, REC_SERVE_MAX_NEW new tokens, 4 slots) with
        exact launches, step
        p50 / p99, the idle share of a warm step and the peak memory;
        decode_step after prefill(64) against prefill(65)."""
        torch = self.torch
        import numpy as np
        from repro_torch.kernels import ops
        from repro_torch.models import build_model
        from repro_torch.models.transformer import segments_for
        from repro_torch.serving.engine import Request, ServeEngine
        from torch.profiler import ProfilerActivity, profile
        cfg = base.replace(attn_impl="flash")
        vocab = cfg.vocab
        per_prefill, per_step = self._per_call(cfg)
        zero_bwd = {"rmsnorm_bwd": 0, "swiglu_bwd": 0}
        rng = np.random.default_rng(seed)
        t0 = time.perf_counter()
        model = build_model(cfg, device=self.dev).init(
            torch.Generator(device=self.dev).manual_seed(seed))
        torch.cuda.synchronize()
        res = {"init_s": time.perf_counter() - t0,
               "params": model.param_count()}
        f32 = {name.rsplit(".", 1)[-1] for name, p in
               model.named_parameters() if p.dtype == torch.float32}
        check(res["params"] == n_params and model.dtype == torch.bfloat16
              and f32 == ({"a_log", "dt_bias", "d_skip"}
                          if phase == "hybrid" else set()),
              f"{phase}: {res['params']} parameters, f32 leaves {f32}")
        b, s = 4, TRAIN_SEQ
        toks = rng.integers(0, vocab, (b, s))
        torch.cuda.reset_peak_memory_stats()
        # the main path, prefill: counts from 0 just before, read just after
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, caches = model.prefill({"tokens": toks})
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        pre = self._moe_counts()
        one_read = ops.RMSNORM_ONE_READ_LAUNCHES
        check(pre == dict(per_prefill, **zero_bwd)
              and one_read == pre["rmsnorm"],
              f"{phase}: prefill launches {pre} ({one_read} rmsnorm on the "
              f"one-read kernel), expected {per_prefill}, all one-read")
        segs = segments_for(cfg)
        check(logits.shape == (b, vocab) and bool(torch.isfinite(logits).all())
              and sorted(caches) == [f"seg_{i:02d}" for i in range(len(segs))]
              and all(len(caches[f"seg_{i:02d}"]) == count
                      for i, (_, count, _) in enumerate(segs)),
              f"{phase}: prefill logits finite, a cache a layer")
        shapes = {f"{kind}.{k}": list(v.shape) for (kind, _, _), key in
                  zip(segs, sorted(caches))
                  for k, v in caches[key][0].items()}
        del caches
        t0 = time.perf_counter()
        again, caches = model.prefill({"tokens": toks})
        torch.cuda.synchronize()
        repeat_s = time.perf_counter() - t0
        del caches
        # one more under the profiler (device activity only); xlstm's on
        # REC_PROFILE_XLSTM tokens a row, its sLSTM's steps being the same
        # work a token at any length
        ptoks = toks[:, :REC_PROFILE_XLSTM] if phase == "xlstm" else toks
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, caches = model.prefill({"tokens": ptoks})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        del caches
        res["profiled_prefill"] = dict(self._step_breakdown(prof, wall),
                                       tokens=list(ptoks.shape))
        del prof
        res["prefill"] = {
            "batch": b, "seq": s, "first_call_s": first_s,
            "repeat_s": repeat_s, "tokens_per_s": b * s / repeat_s,
            "launches": pre, "rmsnorm_one_read": one_read,
            "cache_shapes": shapes,
            "repeat_bitwise": bool(torch.equal(again, logits)),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        for key in launches:
            launches[key] += pre[key]
        # the kernels against the plain versions at full depth, and the
        # residual stream after the first segment
        ctoks = rng.integers(0, vocab, REC_COMPARE)
        lk, caches = model.prefill({"tokens": ctoks})
        hk = self._first_segment(model, ctoks)
        del caches, again
        model.backend, model.cfg = "plain", cfg.replace(attn_impl="chunked")
        t0 = time.perf_counter()
        lp, caches = model.prefill({"tokens": ctoks})
        torch.cuda.synchronize()
        res["plain_prefill_s"] = time.perf_counter() - t0
        hp = self._first_segment(model, ctoks)
        del caches
        model.backend, model.cfg = "auto", cfg
        torch.cuda.empty_cache()
        # the main path, serving: counts from 0 just before, read just after
        eng = ServeEngine(model, n_slots=4, cache_len=256)
        reqs = [Request(uid=i, prompt=rng.integers(0, vocab,
                                                   REC_SERVE_PROMPT),
                        max_new=REC_SERVE_MAX_NEW) for i in range(4)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        served = self._moe_counts()
        calls = eng.n_decode_calls
        check(served == dict({k: v * calls for k, v in per_step.items()},
                             **zero_bwd),
              f"{phase}: engine launches {served} for {calls} decode steps "
              f"({per_step} a step expected)")
        check(len(done) == 4
              and all(len(r.out) == REC_SERVE_MAX_NEW for r in done)
              and all(0 <= t < vocab for r in done for t in r.out),
              f"{phase}: 4 requests of {REC_SERVE_MAX_NEW} tokens in the "
              "vocabulary")
        for key in launches:
            launches[key] += served[key]
        steps = eng.step_seconds
        res["serve"] = {
            "requests": 4, "prompt": REC_SERVE_PROMPT,
            "max_new": REC_SERVE_MAX_NEW,
            "slots": 4, "cache_len": 256, "seconds": run_s,
            "decode_calls": calls, "ticks": len(steps),
            "step_p50_ms": float(np.percentile(steps, 50)) * 1e3,
            "step_p99_ms": float(np.percentile(steps, 99)) * 1e3,
            "new_tokens_per_s_run": sum(len(r.out) for r in done) / run_s,
            "launches": served,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        res["decode_idle"] = self._decode_idle(model, eng, steps)
        del eng
        short = rng.integers(0, vocab, (1, 65))
        ld, l65 = self._decode_vs_prefill(model, short)
        # the reference's own bf16 error: the plain versions in f32 on the
        # same weights, widened (REC_BF16_LOGIT_TOL's comment); the bf16
        # model goes first, to leave the f32 prefill its memory
        m32 = build_model(cfg.replace(dtype="float32", attn_impl="chunked"),
                          device=self.dev, backend="plain")
        own = dict(model.named_parameters())
        with torch.no_grad():
            for name, p32 in m32.named_parameters():
                p32.copy_(own[name])
        del own, model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        lf, caches = m32.prefill({"tokens": ctoks})
        torch.cuda.synchronize()
        res["f32_plain_prefill_s"] = time.perf_counter() - t0
        del caches
        lf65, _ = m32.prefill({"tokens": short})
        hf = self._first_segment(m32, ctoks)
        del m32
        torch.cuda.empty_cache()
        seg = float((hk - hp).norm() / hp.norm())
        res["first_segment_bf16"] = {
            "layers": segments_for(cfg)[0][1], "tokens": list(REC_COMPARE),
            "kernels_vs_plain_rel_l2": seg,
            "plain_vs_f32_rel_l2": float((hp - hf).norm() / hf.norm()),
            "kernels_vs_f32_rel_l2": float((hk - hf).norm() / hf.norm()),
            "tol": REC_SEG0_TOL}
        check(seg <= REC_SEG0_TOL,
              f"{phase}: the residual stream after the first segment, "
              f"kernels vs plain, relative L2 {seg} > {REC_SEG0_TOL}")
        del hk, hp, hf
        tol = REC_BF16_LOGIT_TOL[phase]
        res["kernels_vs_plain_bf16"] = self._rec_agree(
            f"{phase} prefill {REC_COMPARE}, kernels vs plain", lk, lp, lf,
            tol)
        res["decode_vs_prefill_bf16"] = self._rec_agree(
            f"{phase} decode_step after prefill(64) vs prefill(65)", ld, l65,
            lf65, tol)
        return res

    def _decode_vs_prefill(self, model, short):
        """(logits of decode_step after prefill(short[:, :64]), logits of
        prefill(short)), short (1, 65): the prefill's keys and values get
        room for one more position; recurrent state is taken as it is."""
        torch = self.torch
        import numpy as np
        _, c64 = model.prefill({"tokens": short[:, :64]})
        l65, _ = model.prefill({"tokens": short})
        pad = {seg: [{k: torch.cat([t, torch.zeros_like(t[:, :1])], 1)
                      if k in ("k", "v") else t for k, t in c.items()}
                     for c in layers] for seg, layers in c64.items()}
        ld, _ = model.decode_step(pad, short[:, 64:65],
                                  np.full((1,), 64, np.int64))
        return ld, l65

    def _first_segment(self, model, toks):
        """The residual stream (f32 copy) after the model's first segment
        on `toks`, as its prefill computes it."""
        from repro_torch.models.transformer import (
            run_stack_train, segments_for)
        kind, count, shared = segments_for(model.cfg)[0]
        with self.torch.inference_mode():
            x, _ = model._embed({"tokens": toks})
            x, _ = run_stack_train(model._layers(0, shared, count), x,
                                   model.cfg, kind,
                                   model._positions(x.shape[1]),
                                   backend=model.backend)
        return x.float()

    def _rec_agree(self, case, got, want, want_f32, tol_frac) -> dict:
        """Full-depth bf16 logits of two routes within the larger of
        tol_frac of max |want| and REC_FLOOR_MUL times want's own distance
        from the f32 run (`want_f32`): REC_BF16_LOGIT_TOL's comment."""
        scale = float(want.abs().max())
        floor = float((want - want_f32).abs().max())
        res = self._bf16_logits_agree(
            case, got, want, max(tol_frac, REC_FLOOR_MUL * floor / scale))
        res.update(bf16_vs_f32_max_abs_diff=floor, fixed_tol_frac=tol_frac,
                   got_vs_f32_max_abs_diff=float(
                       (got - want_f32).abs().max()))
        return res

    def _rec_train(self, phase, base, launches, seed) -> dict:
        """Full width, REC_TRAIN_LAYERS layers, bf16, remat "full", chunked
        attention: REC_TRAIN_STEPS steps of REC_TRAIN_BATCH x seq tokens
        with exact launch counts a step, the first REC_TRAIN_PLAIN_STEPS
        against the plain versions from the same state; step p50, tokens/s,
        peak memory, a profiled step."""
        torch = self.torch
        from repro_torch.configs import TrainConfig
        from repro_torch.data.tokens import TokenPipeline
        from repro_torch.kernels import ops
        from repro_torch.models import build_model
        from repro_torch.training import make_train_step, train_state_init
        from torch.profiler import ProfilerActivity, profile
        cfg = base.replace(n_layers=REC_TRAIN_LAYERS[phase])
        b, s = REC_TRAIN_BATCH, REC_TRAIN_SEQ[phase]
        tokens = b * s
        tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                           total_steps=REC_TRAIN_STEPS)
        pipe = TokenPipeline(cfg.vocab, b, s, seed=self.seed)
        # per step with remat "full": each block's norms and swiglu run
        # again in the backward's recompute; one backward each
        fwd = self._per_call(cfg)[1]
        blocks = fwd["rmsnorm"] - 1
        per_step = {"flash_attention": 0, "rmsnorm": 2 * blocks + 1,
                    "swiglu": 2 * fwd["swiglu"], "rmsnorm_bwd": blocks + 1,
                    "swiglu_bwd": fwd["swiglu"]}
        t0 = time.perf_counter()
        model = build_model(cfg, device=self.dev).init(
            torch.Generator(device=self.dev).manual_seed(seed))
        params = {k: p.detach() for k, p in model.named_parameters()}
        first_w = next(k for k in params if k.startswith(
            "segments.seg_00.0.") and params[k].dim() == 2)
        probe = {k: params[k][:2].clone() for k in ("tok_embed", first_w)}
        n_params = sum(p.numel() for p in params.values())
        state = train_state_init(params, tcfg)
        step = make_train_step(model, tcfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        # the main path: counts from 0 just before, read just after
        ops.reset_launch_counts()
        mets, times, first, breakdown = [], [], None, None
        for i in range(REC_TRAIN_STEPS):
            # step 2 under the profiler (device activity only)
            prof = profile(activities=[ProfilerActivity.CUDA]) \
                if i == 1 else contextlib.nullcontext()
            t0 = time.perf_counter()
            with prof:
                state, m = step(state, pipe.batch_at(i))
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            mets.append({k: float(v) for k, v in m.items()})
            if first is None:
                first = self._moe_counts()
            if i == 1:
                breakdown = self._step_breakdown(prof, times[-1])
                del prof
        counts = self._moe_counts()
        peak = torch.cuda.max_memory_allocated()
        check(first == per_step,
              f"{phase} train: launches of one step {first}, expected "
              f"{per_step}")
        check(counts == {k: REC_TRAIN_STEPS * v
                         for k, v in per_step.items()},
              f"{phase} train: launches of {REC_TRAIN_STEPS} steps {counts}")
        check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                  for m in mets) and [int(m["step"]) for m in mets]
              == list(range(1, REC_TRAIN_STEPS + 1)),
              f"{phase} train: losses and grad norms finite, steps counted: "
              f"{mets}")
        for key in launches:
            launches[key] += counts[key]
        # the plain versions from the same state
        del state
        torch.cuda.empty_cache()
        model.init(torch.Generator(device=self.dev).manual_seed(seed))
        check(all(torch.equal(params[k][:2], v) for k, v in probe.items()),
              f"{phase} train: the weights drawn again from the seed are the "
              "same")
        state = train_state_init(params, tcfg)
        plain = make_train_step(build_model(cfg, device="meta",
                                            backend="plain"), tcfg)
        ops.reset_launch_counts()
        pmets, ptimes = [], []
        for i in range(REC_TRAIN_PLAIN_STEPS):
            t0 = time.perf_counter()
            state, m = plain(state, pipe.batch_at(i))
            torch.cuda.synchronize()
            ptimes.append(time.perf_counter() - t0)
            pmets.append({k: float(v) for k, v in m.items()})
        check(all(v == 0 for v in self._moe_counts().values()),
              f"{phase} train: the plain run launched a kernel")
        agree = []
        for i, (k, p) in enumerate(zip(mets, pmets)):
            dl = abs(k["loss"] - p["loss"]) / abs(p["loss"])
            dg = abs(k["grad_norm"] - p["grad_norm"]) / p["grad_norm"]
            check(dl <= TRAIN_LOSS_TOL and dg <= REC_TRAIN_GNORM_TOL[phase]
                  and k["lr"] == p["lr"],
                  f"{phase} train: step {i + 1} kernels {k} against plain "
                  f"{p}")
            agree.append({"step": i + 1, "loss_rel": dl, "grad_norm_rel": dg})
        del state, params, model, step, plain
        torch.cuda.empty_cache()
        p50 = statistics.median(times[2:])
        return {
            "layers": cfg.n_layers, "d_model": cfg.d_model, "dtype": cfg.dtype,
            "remat": cfg.remat, "attn_impl": cfg.attn_impl,
            "ssm_chunk": cfg.ssm_chunk, "batch": b, "seq": s,
            "steps": REC_TRAIN_STEPS, "params": n_params, "init_s": init_s,
            "step_seconds": times,
            f"step_p50_s_steps_3_to_{REC_TRAIN_STEPS}": p50,
            "tokens_per_s": tokens / p50, "peak_memory_gb": peak / 1e9,
            "flops": self._flop_shares(cfg, b, s, n_params, p50),
            "profiled_step": breakdown,
            "metrics": mets, "launches_one_step": first, "launches": counts,
            "plain_metrics": pmets, "plain_step_seconds": ptimes,
            "kernels_vs_plain": agree,
            "tol": {"loss": TRAIN_LOSS_TOL,
                    "grad_norm": REC_TRAIN_GNORM_TOL[phase]}}

    # --------------------------------------------------------- frontends
    def frontends(self):
        """The frontend families on the card (`models/frontend.py`, the
        encoder-decoder's blocks and cross-attention): internvl2-2b (a
        256-patch prefix; flash at group 2) and seamless-m4t-medium (a
        12-layer encoder over 1024 frames, a 12-layer decoder with
        cross-attention; rmsnorm at d 1024), each at full width in f32
        against the plain versions (2 layers: prefill logits, decode_step
        after a prefill, the loss and every gradient), at full width and
        depth in bf16 (a 4 x 4096 prefill with exact launches, FE_TICKS
        decode steps from its caches, its logits against the plain
        versions', a ServeEngine run, the parameter count) and trained at
        full width (internvl2 at FE_TRAIN_LAYERS layers).  Then the
        kernels timed at the shapes these models give them.  The launches
        of the served and trained runs count as the path's."""
        from repro_torch.configs import get_arch
        self._ensure_built()
        vlm, ed = get_arch("internvl2-2b"), get_arch("seamless-m4t-medium")
        check(vlm.family == "vlm" and vlm.n_layers == 24
              and vlm.d_model == 2048 and vlm.n_heads == 16
              and vlm.n_kv_heads == 8 and vlm.hd == 128 and vlm.d_ff == 8192
              and vlm.vocab == 92553 and vlm.frontend_len == 256
              and vlm.frontend_dim == 1024 and not vlm.is_encdec
              and vlm.dtype == "bfloat16" and vlm.remat == "full"
              and vlm.attn_chunk == 512, "frontends: internvl2-2b's "
              "configuration")
        check(ed.family == "audio" and ed.n_layers == 12
              and ed.enc_layers == 12 and ed.d_model == 1024
              and ed.n_heads == ed.n_kv_heads == 16 and ed.hd == 64
              and ed.d_ff == 4096 and ed.vocab == 256206
              and ed.frontend_len == 1024 and ed.frontend_dim == 160
              and ed.dtype == "bfloat16" and ed.remat == "full",
              "frontends: seamless-m4t-medium's configuration")
        check(self._per_call(vlm) == (
            {"flash_attention": 24, "rmsnorm": 50, "swiglu": 24},
            {"flash_attention": 0, "rmsnorm": 49, "swiglu": 24}),
            "frontends: internvl2-2b's 24 / 50 / 24 launches a prefill")
        check(self._per_call(ed) == (
            {"flash_attention": 12, "rmsnorm": 63, "swiglu": 24},
            {"flash_attention": 0, "rmsnorm": 37, "swiglu": 12}),
            "frontends: seamless's 12 / 63 / 24 launches a prefill")
        launches = dict.fromkeys(("flash_attention", "rmsnorm", "swiglu",
                                  "rmsnorm_bwd", "swiglu_bwd"), 0)
        res = {}
        for i, (base, n_params) in enumerate(((vlm, 1_895_440_384),
                                              (ed, 978_971_648))):
            seed = self.seed + 900 + 50 * i
            r = res[base.name] = {}
            for part, run in (
                    ("f32", lambda: self._fe_f32(base, seed + 1)),
                    ("serve", lambda: self._fe_serve(base, n_params,
                                                     launches, seed + 2)),
                    ("train", lambda: self._fe_train(base, launches,
                                                     seed + 3))):
                t0 = time.perf_counter()
                with self._no_plain_backward("frontends"):
                    r[part] = run()
                r[part]["seconds"] = time.perf_counter() - t0
                self.torch.cuda.empty_cache()
        t0 = time.perf_counter()
        self._fe_kernel_times()
        res["kernel_times_seconds"] = time.perf_counter() - t0
        res["launches"] = launches
        self.path_launches["frontends"] = launches
        emit({"phase": "frontends", "card": self.card, **res})

    def _fe_batch(self, cfg, b: int, positions: int, rng) -> dict:
        """tokens, next-token labels and stub frontend embeddings (b, F,
        frontend_dim) f32 from `rng`, for `positions` positions of the
        decoder: F patches and positions - F tokens for the vision prefix,
        positions tokens for the encoder-decoder."""
        import numpy as np
        n_prefix = 0 if cfg.is_encdec else cfg.frontend_len
        toks = rng.integers(0, cfg.vocab, (b, positions - n_prefix + 1))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                "frontend": rng.normal(size=(
                    b, cfg.frontend_len, cfg.frontend_dim)).astype(
                        np.float32)}

    def _fe_decode_vs_prefill(self, model, batch):
        """(logits of decode_step after the prefill of batch's tokens but
        the last, logits of the prefill of all of them): the caches get room
        for one more position, decode runs at n_prefix + S.  With the
        vision prefix the longer prefill runs the chunked attention (F + S
        + 1 positions are no multiple of 128, which flash needs)."""
        torch = self.torch
        import numpy as np
        cfg = model.cfg
        n_prefix = 0 if cfg.is_encdec else cfg.frontend_len
        s = batch["tokens"].shape[1] - 1
        _, c = model.prefill(dict(batch, tokens=batch["tokens"][:, :s]))
        if n_prefix:
            model.cfg = cfg.replace(attn_impl="chunked")
        longer, _ = model.prefill(batch)
        model.cfg = cfg
        pad = {seg: [{k: torch.cat([t, torch.zeros_like(t[:, :1])], 1)
                      if k in ("k", "v") else t for k, t in layer.items()}
                     for layer in layers] for seg, layers in c.items()}
        ld, _ = model.decode_step(pad, batch["tokens"][:, s:],
                                  np.full((len(batch["tokens"]),),
                                          n_prefix + s, np.int64))
        return ld, longer

    def _fe_f32(self, base, seed) -> dict:
        """Full width, 2 layers (and 2 encoder layers), f32: the kernels
        (exact launches; flash for the causal self-attention) against the
        plain versions on a 1 x FE_F32_SEQ-position prefill with a frontend
        batch; decode_step after a prefill against the longer prefill; the
        loss and every gradient against the plain versions'."""
        torch = self.torch
        import numpy as np
        from repro_torch.kernels import ops
        from repro_torch.models import build_model
        from repro_torch.training import loss_and_grads
        cfg = base.replace(n_layers=2, enc_layers=min(base.enc_layers, 2),
                           dtype="float32", attn_impl="flash")
        rng = np.random.default_rng(seed)
        model = build_model(cfg, device=self.dev).init(
            torch.Generator(device=self.dev).manual_seed(seed))
        batch = self._fe_batch(cfg, 1, FE_F32_SEQ, rng)
        ops.reset_launch_counts()
        lk, _ = model.prefill(batch)
        counts = self._moe_counts()
        want = dict(self._per_call(cfg)[0], rmsnorm_bwd=0, swiglu_bwd=0)
        model.backend, model.cfg = "plain", cfg.replace(attn_impl="chunked")
        lp, _ = model.prefill(batch)
        check(counts == want and self._moe_counts() == counts,
              f"{base.name} f32: prefill launches {counts}, expected {want}, "
              "none for the plain one")
        err = float((lk - lp).abs().max())
        tol = LOGIT_TOL * max(1.0, float(lp.abs().max()))
        check(bool(torch.isfinite(lk).all()) and lk.shape == (1, cfg.vocab)
              and err <= tol,
              f"{base.name} f32: prefill logits kernels vs plain {err} > "
              f"{tol}")
        model.backend, model.cfg = "auto", cfg
        # 64 tokens, or the vision prefix's 256 patches and 128 tokens
        short = self._fe_batch(cfg, 1, (64 if cfg.is_encdec else 384) + 1,
                               rng)
        ld, longer = self._fe_decode_vs_prefill(model, short)
        derr = float((ld - longer).abs().max())
        dtol = REC_F32_DECODE_TOL * max(1.0, float(longer.abs().max()))
        check(derr <= dtol, f"{base.name} f32: decode_step after a prefill "
              f"vs the longer prefill {derr} > {dtol}")
        # the loss and every gradient (chunked attention, as training runs)
        model.cfg = cfg.replace(attn_impl="chunked")
        params = {k: p.detach() for k, p in model.named_parameters()}
        gl, gk = loss_and_grads(model, params, batch)
        pl, gp = loss_and_grads(
            build_model(model.cfg, device="meta", backend="plain"), params,
            batch)
        loss_rel = abs(float(gl) - float(pl)) / abs(float(pl))
        worst, worst_name = 0.0, ""
        for k in gp:
            scale = float(gp[k].abs().max())
            r = float((gk[k] - gp[k]).abs().max()) / max(scale, 1e-30)
            check(bool(torch.isfinite(gk[k]).all()),
                  f"{base.name} f32: gradient {k} not finite")
            if r > worst:
                worst, worst_name = r, k
        need = {"frontend.fe_w1", "frontend.fe_w2", "frontend.fe_norm"}
        if cfg.is_encdec:
            need |= {"encoder.norm", "encoder.segments.0.wq",
                     "segments.seg_00.0.cross_wq", "segments.seg_00.0.norm_x"}
        check(need <= set(gp) and math.isfinite(float(gl))
              and loss_rel <= TRAIN_F32_LOSS_RTOL
              and worst <= TRAIN_F32_GRAD_TOL,
              f"{base.name} f32: loss rel {loss_rel}, worst gradient "
              f"{worst_name} {worst} of its max abs")
        del model, params, gk, gp
        return {"layers": cfg.n_layers, "enc_layers": cfg.enc_layers,
                "positions": FE_F32_SEQ, "launches": counts,
                "prefill_logit_max_abs_err": err, "tol": tol,
                "decode_vs_prefill_max_abs_err": derr, "decode_tol": dtol,
                "loss": float(gl), "loss_rel": loss_rel,
                "worst_grad_err_over_max": worst, "worst_grad": worst_name,
                "grad_tol": {"loss_rel": TRAIN_F32_LOSS_RTOL,
                             "grad": TRAIN_F32_GRAD_TOL}}

    def _fe_serve(self, base, n_params, launches, seed) -> dict:
        """Full width and depth, bf16, flash attention, random weights from
        the seed: the parameter count; a 4 x TRAIN_SEQ-position prefill
        (exact launches, caches, seconds, tokens/s); FE_TICKS decode steps
        from its caches (exact launches, p50 / p99, a warm step's idle
        share); its logits against the plain versions' on an FE_COMPARE
        batch; a ServeEngine run; decode_step after a prefill against the
        longer prefill."""
        torch = self.torch
        import types
        import numpy as np
        from repro_torch.kernels import ops
        from repro_torch.kernels.rmsnorm import one_read_packs
        from repro_torch.models import build_model
        from repro_torch.serving.engine import Request, ServeEngine
        cfg = base.replace(attn_impl="flash")
        vocab, name = cfg.vocab, base.name
        per_prefill, per_step = self._per_call(cfg)
        zero_bwd = {"rmsnorm_bwd": 0, "swiglu_bwd": 0}
        rng = np.random.default_rng(seed)
        t0 = time.perf_counter()
        model = build_model(cfg, device=self.dev).init(
            torch.Generator(device=self.dev).manual_seed(seed))
        torch.cuda.synchronize()
        res = {"init_s": time.perf_counter() - t0,
               "params": model.param_count()}
        check(res["params"] == n_params and model.dtype == torch.bfloat16
              and all(p.dtype == torch.bfloat16 for p in model.parameters()),
              f"{name}: {res['params']} parameters, all bf16")
        b, s = 4, TRAIN_SEQ
        n_prefix = 0 if cfg.is_encdec else cfg.frontend_len
        batch = self._fe_batch(cfg, b, s, rng)
        torch.cuda.reset_peak_memory_stats()
        # the main path, prefill: counts from 0 just before, read just after
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, caches = model.prefill(batch)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        pre = self._moe_counts()
        one_read = ops.RMSNORM_ONE_READ_LAUNCHES
        want_one_read = pre["rmsnorm"] if one_read_packs(
            cfg.d_model, 2, True) else 0
        check(pre == dict(per_prefill, **zero_bwd)
              and one_read == want_one_read,
              f"{name}: prefill launches {pre} ({one_read} rmsnorm on the "
              f"one-read kernel), expected {per_prefill}")
        kv = (b, s, cfg.n_kv_heads, cfg.hd)
        shapes = {k: tuple(t.shape) for k, t in caches["seg_00"][0].items()}
        want_shapes = {"k": kv, "v": kv}
        if cfg.is_encdec:
            want_shapes.update(ck=(b, cfg.frontend_len) + kv[2:],
                               cv=(b, cfg.frontend_len) + kv[2:])
        check(logits.shape == (b, vocab) and bool(torch.isfinite(logits).all())
              and list(caches) == ["seg_00"]
              and len(caches["seg_00"]) == cfg.n_layers
              and shapes == want_shapes,
              f"{name}: prefill logits finite, caches {shapes}")
        for key in launches:
            launches[key] += pre[key]
        del caches
        t0 = time.perf_counter()
        again, caches = model.prefill(batch)
        torch.cuda.synchronize()
        repeat_s = time.perf_counter() - t0
        res["prefill"] = {
            "batch": b, "positions": s, "prefix": n_prefix,
            "tokens": s - n_prefix, "frames": cfg.frontend_len,
            "first_call_s": first_s, "repeat_s": repeat_s,
            "positions_per_s": b * s / repeat_s, "launches": pre,
            "rmsnorm_one_read": one_read,
            "cache_shapes": {k: list(v) for k, v in shapes.items()},
            "repeat_bitwise": bool(torch.equal(again, logits)),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        # FE_TICKS decode steps from the prefill's caches (the cross keys
        # and values static): counts from 0 just before, read just after
        caches = {seg: [{k: torch.cat([t, torch.zeros_like(t[:, :FE_TICKS])],
                                      1) if k in ("k", "v") else t
                         for k, t in layer.items()} for layer in layers]
                  for seg, layers in caches.items()}
        tok = again.argmax(-1).reshape(b, 1).cpu().numpy()
        del again, logits
        ops.reset_launch_counts()
        ticks = []
        for i in range(FE_TICKS):
            t0 = time.perf_counter()
            lt, caches = model.decode_step(
                caches, tok, np.full((b,), s + i, np.int64))
            tok = lt.argmax(-1).reshape(b, 1).cpu().numpy()
            ticks.append(time.perf_counter() - t0)
        stepped = self._moe_counts()
        check(stepped == dict({k: v * FE_TICKS for k, v in per_step.items()},
                              **zero_bwd)
              and bool(torch.isfinite(lt).all()),
              f"{name}: {FE_TICKS} decode steps launched {stepped} "
              f"({per_step} a step expected)")
        for key in launches:
            launches[key] += stepped[key]
        res["decode_from_prefill"] = {
            "steps": FE_TICKS, "batch": b, "first_position": s,
            "step_p50_ms": float(np.percentile(ticks, 50)) * 1e3,
            "step_p99_ms": float(np.percentile(ticks, 99)) * 1e3,
            "launches": stepped,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        res["decode_idle"] = self._decode_idle(
            model, types.SimpleNamespace(n_slots=b, caches=caches), ticks)
        del caches, lt
        torch.cuda.empty_cache()
        # the kernels against the plain versions on a shorter batch
        cbatch = self._fe_batch(cfg, *FE_COMPARE, rng)
        lk, _ = model.prefill(cbatch)
        model.backend, model.cfg = "plain", cfg.replace(attn_impl="chunked")
        t0 = time.perf_counter()
        lp, _ = model.prefill(cbatch)
        torch.cuda.synchronize()
        res["plain_prefill_s"] = time.perf_counter() - t0
        model.backend, model.cfg = "auto", cfg
        torch.cuda.empty_cache()
        # the main path, serving: counts from 0 just before, read just after
        eng = ServeEngine(model, n_slots=4, cache_len=128)
        reqs = [Request(uid=i, prompt=rng.integers(0, vocab, FE_SERVE_PROMPT),
                        max_new=FE_SERVE_MAX_NEW) for i in range(4)]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        served = self._moe_counts()
        calls = eng.n_decode_calls
        check(served == dict({k: v * calls for k, v in per_step.items()},
                             **zero_bwd),
              f"{name}: engine launches {served} for {calls} decode steps")
        check(len(done) == 4
              and all(len(r.out) == FE_SERVE_MAX_NEW for r in done)
              and all(0 <= t < vocab for r in done for t in r.out),
              f"{name}: 4 requests of {FE_SERVE_MAX_NEW} tokens in the "
              "vocabulary")
        for key in launches:
            launches[key] += served[key]
        steps = eng.step_seconds
        res["serve"] = {
            "requests": 4, "prompt": FE_SERVE_PROMPT,
            "max_new": FE_SERVE_MAX_NEW, "slots": 4, "cache_len": 128,
            "seconds": run_s, "decode_calls": calls, "ticks": len(steps),
            "step_p50_ms": float(np.percentile(steps, 50)) * 1e3,
            "step_p99_ms": float(np.percentile(steps, 99)) * 1e3,
            "launches": served}
        del eng
        short = self._fe_batch(cfg, 1, (64 if cfg.is_encdec else 384) + 1,
                               rng)
        ld, longer = self._fe_decode_vs_prefill(model, short)
        # the reference's own bf16 error: the plain versions in f32 on the
        # same weights, widened; the bf16 model goes first
        m32 = build_model(cfg.replace(dtype="float32", attn_impl="chunked"),
                          device=self.dev, backend="plain")
        own = dict(model.named_parameters())
        with torch.no_grad():
            for pname, p32 in m32.named_parameters():
                p32.copy_(own[pname])
        del own, model
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        lf, _ = m32.prefill(cbatch)
        torch.cuda.synchronize()
        res["f32_plain_prefill_s"] = time.perf_counter() - t0
        lflong, _ = m32.prefill(short)
        del m32
        torch.cuda.empty_cache()
        res["kernels_vs_plain_bf16"] = self._rec_agree(
            f"{name} prefill {FE_COMPARE}, kernels vs plain", lk, lp, lf,
            BF16_LOGIT_TOL)
        res["decode_vs_prefill_bf16"] = self._rec_agree(
            f"{name} decode_step after a prefill vs the longer prefill", ld,
            longer, lflong, BF16_LOGIT_TOL)
        return res

    def _fe_train(self, base, launches, seed) -> dict:
        """Full width, FE_TRAIN_LAYERS layers (seamless: 12 + 12), bf16,
        remat "full", chunked attention: FE_TRAIN_STEPS steps of 4 x
        TRAIN_SEQ positions (each step's frontend batch drawn as
        `launch/train.py` draws it) with exact launches a step, the first
        FE_TRAIN_PLAIN_STEPS against the plain versions from the same
        state; step p50, peak memory, the model-FLOP share."""
        torch = self.torch
        import numpy as np
        from repro_torch.configs import TrainConfig
        from repro_torch.data.tokens import TokenPipeline
        from repro_torch.kernels import ops
        from repro_torch.models import build_model
        from repro_torch.training import make_train_step, train_state_init
        cfg = base.replace(n_layers=FE_TRAIN_LAYERS[base.name])
        b, n_prefix = 4, 0 if cfg.is_encdec else cfg.frontend_len
        s = TRAIN_SEQ - n_prefix          # tokens a row
        f = cfg.frontend_len
        tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                           total_steps=FE_TRAIN_STEPS)
        pipe = TokenPipeline(cfg.vocab, b, s, seed=seed)

        def batch_at(i):
            rows = np.random.default_rng([seed, i])
            return dict(pipe.batch_at(i), frontend=rows.normal(
                size=(b, f, cfg.frontend_dim)).astype(np.float32))
        # per step with remat "full": each block's norms and swiglu run
        # again in the backward's recompute; fe_norm, the encoder's norm
        # and the final norm once; one backward each
        fwd = self._per_call(cfg)[0]
        enc = cfg.enc_layers
        block_norms = fwd["rmsnorm"] - 1 - 1 - (1 if enc else 0)
        others = fwd["rmsnorm"] - block_norms
        per_step = {"flash_attention": 0,
                    "rmsnorm": 2 * block_norms + others,
                    "swiglu": 2 * fwd["swiglu"],
                    "rmsnorm_bwd": fwd["rmsnorm"],
                    "swiglu_bwd": fwd["swiglu"]}
        t0 = time.perf_counter()
        model = build_model(cfg, device=self.dev).init(
            torch.Generator(device=self.dev).manual_seed(seed))
        params = {k: p.detach() for k, p in model.named_parameters()}
        probe = {k: params[k][:2].clone() for k in
                 ("tok_embed", "segments.seg_00.0.wq", "frontend.fe_w1")}
        n_params = sum(p.numel() for p in params.values())
        state = train_state_init(params, tcfg)
        step = make_train_step(model, tcfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        # the main path: counts from 0 just before, read just after
        ops.reset_launch_counts()
        mets, times, first = [], [], None
        for i in range(FE_TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch_at(i))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            mets.append({k: float(v) for k, v in m.items()})
            if first is None:
                first = self._moe_counts()
        counts = self._moe_counts()
        peak = torch.cuda.max_memory_allocated()
        check(first == per_step, f"{base.name} train: launches of one step "
              f"{first}, expected {per_step}")
        check(counts == {k: FE_TRAIN_STEPS * v for k, v in per_step.items()},
              f"{base.name} train: launches of {FE_TRAIN_STEPS} steps "
              f"{counts}")
        check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                  for m in mets) and [int(m["step"]) for m in mets]
              == list(range(1, FE_TRAIN_STEPS + 1)),
              f"{base.name} train: losses and grad norms finite, steps "
              f"counted: {mets}")
        for key in launches:
            launches[key] += counts[key]
        # the plain versions from the same state
        del state
        torch.cuda.empty_cache()
        model.init(torch.Generator(device=self.dev).manual_seed(seed))
        check(all(torch.equal(params[k][:2], v) for k, v in probe.items()),
              f"{base.name} train: the weights drawn again from the seed "
              "are the same")
        state = train_state_init(params, tcfg)
        plain = make_train_step(build_model(cfg, device="meta",
                                            backend="plain"), tcfg)
        ops.reset_launch_counts()
        pmets, ptimes = [], []
        for i in range(FE_TRAIN_PLAIN_STEPS):
            t0 = time.perf_counter()
            state, m = plain(state, batch_at(i))
            torch.cuda.synchronize()
            ptimes.append(time.perf_counter() - t0)
            pmets.append({k: float(v) for k, v in m.items()})
        check(all(v == 0 for v in self._moe_counts().values()),
              f"{base.name} train: the plain run launched a kernel")
        agree = []
        for i, (k, p) in enumerate(zip(mets, pmets)):
            dl = abs(k["loss"] - p["loss"]) / abs(p["loss"])
            dg = abs(k["grad_norm"] - p["grad_norm"]) / p["grad_norm"]
            check(dl <= TRAIN_LOSS_TOL and dg <= TRAIN_GNORM_TOL
                  and k["lr"] == p["lr"],
                  f"{base.name} train: step {i + 1} kernels {k} against "
                  f"plain {p}")
            agree.append({"step": i + 1, "loss_rel": dl, "grad_norm_rel": dg})
        del state, params, model, step, plain
        torch.cuda.empty_cache()
        p50 = statistics.median(times[2:])
        pos = n_prefix + s
        return {
            "layers": cfg.n_layers, "enc_layers": enc, "d_model": cfg.d_model,
            "dtype": cfg.dtype, "remat": cfg.remat,
            "attn_impl": cfg.attn_impl, "batch": b, "positions": pos,
            "tokens": s, "frames": f, "steps": FE_TRAIN_STEPS,
            "params": n_params, "init_s": init_s, "step_seconds": times,
            f"step_p50_s_steps_3_to_{FE_TRAIN_STEPS}": p50,
            "positions_per_s": b * pos / p50, "peak_memory_gb": peak / 1e9,
            # the reference's count is over the S tokens a row: the vision
            # prefix's F positions are not in it
            "flops": self._flop_shares(cfg, b, s, n_params, p50),
            "metrics": mets, "launches_one_step": first, "launches": counts,
            "plain_metrics": pmets, "plain_step_seconds": ptimes,
            "kernels_vs_plain": agree,
            "tol": {"loss": TRAIN_LOSS_TOL, "grad_norm": TRAIN_GNORM_TOL}}

    def _fe_kernel_times(self):
        """The kernels at the shapes the frontend families give them, bf16,
        each checked against its plain version first: flash at internvl2's
        (4, 16/8, 4096, 128) (group 2) and seamless's (4, 16/16, 4096, 64)
        beside SDPA; rmsnorm at (16384, 1024) beside its two-pass kernel and
        its backward beside the two-sweep kernel; swiglu at seamless's
        (16384, 4096)."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import ref
        from repro_torch.kernels.flash_attention import flash_attention
        from repro_torch.kernels.rmsnorm import (
            _two_pass, _two_sweep, one_read_packs, rmsnorm, rmsnorm_bwd)
        from repro_torch.kernels.swiglu import swiglu
        g = torch.Generator(device=self.dev).manual_seed(self.seed + 990)
        bf16 = torch.bfloat16

        def randn(shape, mul=1.0):
            return (torch.randn(shape, generator=g, device=self.dev)
                    * mul).to(bf16)
        with torch.inference_mode():
            for shape, (b, h, hkv, s, dh) in (
                    ("internvl2_prefill", (4, 16, 8, 4096, 128)),
                    ("seamless_prefill", (4, 16, 16, 4096, 64))):
                q = randn((b, s, h, dh)).transpose(1, 2)
                k, v = (randn((b, s, hkv, dh)).transpose(1, 2)
                        for _ in range(2))
                case = f"bf16 {shape} {list(q.shape)} / {list(k.shape)}"
                got, want = flash_attention(q, k, v), \
                    ref.flash_attention_ref(q, k, v)
                self._lm_agree("flash_attention", case, got, want)
                emit({"phase": "frontends", "kernel": "flash_attention",
                      **self._flash_tight(case, q, k, v, True, got, want)})
                del got, want
                torch.cuda.empty_cache()
                flops = 2.0 * s * s * dh * b * h   # both products, causal half
                self._time_kernel(
                    "flash_attention", shape,
                    lambda: flash_attention(q, k, v),
                    lambda: ref.flash_attention_ref(q, k, v),
                    flops=flops,
                    nbytes=2.0 * (2 * q.numel() + 2 * k.numel()),
                    peak_flops=PEAK_BF16_FLOPS,
                    library=lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True),
                    q=list(q.shape), kv=list(k.shape), dtype="bfloat16",
                    causal=True, group=h // hkv,
                    sdpa=self._sdpa_backends(q, k, v))
                del q, k, v
                torch.cuda.empty_cache()
        # rmsnorm at seamless's d 1024 (outside inference mode: the library
        # call of the backward differentiates F.rms_norm)
        d = 1024
        x, w, dy = randn((16384, d)), randn((d,)), randn((16384, d))
        xg = x.clone().requires_grad_(True)
        wg = w.clone().requires_grad_(True)
        self._lm_agree("rmsnorm", "bf16 (16384, 1024) seamless",
                       rmsnorm(x, w, 1e-6), ref.rmsnorm_ref(x, w, 1e-6))
        for got, want in zip(rmsnorm_bwd(x, w, dy, 1e-6),
                             ref.rmsnorm_bwd_ref(x, w, dy, 1e-6)):
            self._lm_agree("rmsnorm_bwd", "bf16 (16384, 1024) seamless",
                           got, want)
        kind = "one read" if one_read_packs(d, 2, True) else "two passes"
        self._time_kernel(
            "rmsnorm", "seamless_prefill", lambda: rmsnorm(x, w, 1e-6),
            lambda: ref.rmsnorm_ref(x, w, 1e-6), flops=4.0 * x.numel(),
            nbytes=2.0 * (2 * x.numel() + d),
            library=lambda: F.rms_norm(x, (d,), w, 1e-6),
            x=[16384, d], dtype="bfloat16", kernel_design=kind,
            two_pass_ms=_queued_ms(torch, lambda: _two_pass(
                x, w, 1e-6))[0])
        self._time_kernel(
            "rmsnorm_bwd", "seamless_train",
            lambda: rmsnorm_bwd(x, w, dy, 1e-6),
            lambda: ref.rmsnorm_bwd_ref(x, w, dy, 1e-6),
            flops=12.0 * x.numel(), nbytes=2.0 * (3.0 * x.numel() + 2 * d),
            library=lambda: torch.autograd.grad(
                F.rms_norm(xg, (d,), wg, 1e-6), (xg, wg), dy),
            x=[16384, d], dtype="bfloat16",
            library_call="torch.autograd.grad through F.rms_norm (its "
                         "forward included)", kernel_design=kind,
            two_sweep_ms=_queued_ms(torch, lambda: _two_sweep(
                x, w, dy, 1e-6))[0])
        del x, w, dy, xg, wg
        with torch.inference_mode():
            a, u = randn((16384, 4096), 3.0), randn((16384, 4096))
            self._lm_agree("swiglu", "bf16 (16384, 4096) seamless",
                           swiglu(a, u), ref.swiglu_ref(a, u))
            self._time_kernel(
                "swiglu", "seamless_prefill", lambda: swiglu(a, u),
                lambda: ref.swiglu_ref(a, u), flops=5.0 * a.numel(),
                nbytes=2.0 * 3 * a.numel(), gate=list(a.shape),
                dtype="bfloat16")
            del a, u
        torch.cuda.empty_cache()

    # ------------------------------------------------------------ dryrun
    def dryrun(self):
        """The roofline (`repro_torch.roofline`) and the dry run
        (`launch/dryrun.run_cell` on the meta device) held against three
        cells the card runs at full width in bf16 with the kernels: (a) the
        train phase's granite-3-2b step, (b) a qwen3-4b prefill at full
        depth, (c) its decode_step (DRYRUN_BATCH's comment).  Each cell
        runs on meta at the same config and shape first, then on the card;
        its time on the card must not be below the roofline's bound, the
        dry run's argument bytes must equal the bytes of the tensors the
        card holds for the same arguments, and its kernels must have
        launched as often as the path runs them.  Also prints the card's
        memory as `torch.cuda` reports it, the dry run's `fits` reference."""
        torch = self.torch
        import numpy as np
        from repro_torch import roofline
        from repro_torch.configs import ShapeConfig, TrainConfig, get_arch
        from repro_torch.data.tokens import TokenPipeline
        from repro_torch.kernels import ops
        from repro_torch.launch import dryrun
        from repro_torch.models import build_model
        from repro_torch.training import make_train_step, train_state_init
        self._ensure_built()
        name = torch.cuda.get_device_name(0)
        total = torch.cuda.get_device_properties(0).total_memory
        print(f"dryrun: {name} total_memory {total} bytes", flush=True)
        check(name != roofline.CARD_NAME or total == roofline.HBM_BYTES,
              f"dryrun: {name} reports {total} bytes, roofline.HBM_BYTES "
              f"{roofline.HBM_BYTES}")
        check(roofline.HW["peak_flops"] == PEAK_BF16_FLOPS
              and roofline.HW["peak_flops_f32"] == PEAK_F32_FLOPS
              and roofline.HW["hbm_bw"] == PEAK_HBM_BYTES,
              "dryrun: roofline.HW holds the data sheet's rates")
        seq, rows = TRAIN_SEQ, DRYRUN_BATCH
        rng = np.random.default_rng(self.seed + 900)
        cells = []

        def nbytes(tensors):
            return sum(t.numel() * t.element_size() for t in tensors)

        # --- (a) granite-3-2b train step ---------------------------------
        n = TRAIN_LAYERS
        shape = ShapeConfig(f"train_{seq}_b{TRAIN_BATCH}", seq, TRAIN_BATCH,
                            "train")
        rec = dryrun.run_cell("granite-3-2b", shape, variant={"n_layers": n})
        cfg = get_arch("granite-3-2b").replace(n_layers=n)
        tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                           total_steps=TRAIN_STEPS)
        pipe = TokenPipeline(cfg.vocab, TRAIN_BATCH, seq, seed=self.seed)
        model = build_model(cfg, device=self.dev).init(
            torch.Generator(device=self.dev).manual_seed(self.seed + 900))
        state = train_state_init(
            {k: p.detach() for k, p in model.named_parameters()}, tcfg)
        step = make_train_step(model, tcfg)
        batches = [{k: torch.as_tensor(v, dtype=torch.int32, device=self.dev)
                    for k, v in pipe.batch_at(i).items()}
                   for i in range(TRAIN_STEPS)]
        card_args = [nbytes([*state.params.values(), *state.opt.mu.values(),
                             *state.opt.nu.values(), state.opt.step]),
                     nbytes(batches[0].values())]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the main path: counts from 0 just before, read just after
        ops.reset_launch_counts()
        times, losses = [], []
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batches[i])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        counts = self._moe_counts()
        check(counts == {"rmsnorm": TRAIN_STEPS * (4 * n + 1),
                         "swiglu": TRAIN_STEPS * 2 * n,
                         "rmsnorm_bwd": TRAIN_STEPS * (2 * n + 1),
                         "swiglu_bwd": TRAIN_STEPS * n,
                         "flash_attention": 0},
              f"dryrun (a): launches {counts} for {TRAIN_STEPS} steps")
        check(all(map(math.isfinite, losses)), f"dryrun (a): losses {losses}")
        cells.append(self._dryrun_cell(
            "a: granite-3-2b train step", rec, statistics.median(times[2:]),
            card_args, torch.cuda.max_memory_allocated(), counts,
            step_seconds=times, losses=losses))
        del state, step, model, batches, m
        torch.cuda.empty_cache()

        # --- (b) qwen3-4b prefill, full depth ----------------------------
        base = get_arch("qwen3-4b")
        variant = {"attn_impl": "flash"}
        cfg = base.replace(**variant)
        shape = ShapeConfig(f"prefill_{seq}_b{rows}", seq, rows, "prefill")
        rec = dryrun.run_cell("qwen3-4b", shape, variant=variant)
        model = build_model(cfg, device=self.dev).init(
            torch.Generator(device=self.dev).manual_seed(self.seed + 901))
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (rows, seq)),
                               dtype=torch.int32, device=self.dev)
        param_bytes = nbytes(model.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        times, caches = [], None
        for _ in range(4):         # the first call warms up, not timed
            del caches
            t0 = time.perf_counter()
            logits, caches = model.prefill({"tokens": toks})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts_b = self._moe_counts()
        L = cfg.n_layers
        check(counts_b == {"flash_attention": 4 * L, "rmsnorm": 4 * (2 * L + 1),
                           "swiglu": 4 * L, "rmsnorm_bwd": 0,
                           "swiglu_bwd": 0},
              f"dryrun (b): launches {counts_b} for 4 prefills")
        check(logits.shape == (rows, cfg.vocab)
              and bool(torch.isfinite(logits).all()),
              "dryrun (b): prefill logits finite, (rows, vocab)")
        cells.append(self._dryrun_cell(
            "b: qwen3-4b prefill", rec, statistics.median(times[1:]),
            [param_bytes, nbytes([toks])], torch.cuda.max_memory_allocated(),
            counts_b, seconds=times))

        # --- (c) qwen3-4b decode_step ------------------------------------
        shape = ShapeConfig(f"decode_{seq}_b{rows}", seq, rows, "decode")
        rec = dryrun.run_cell("qwen3-4b", shape, variant=variant)
        # the engine's caches (`init_cache`), holding the prefill's keys
        # and values; each row decodes its next token at the last position
        cache = model.init_cache(rows, seq)
        with torch.inference_mode():
            for mine, theirs in zip(
                    [c for layers in cache.values() for c in layers],
                    [c for layers in caches.values() for c in layers]):
                for k in mine:
                    mine[k].copy_(theirs[k])
        del caches, mine, theirs
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        pos = torch.full((rows,), seq - 1, dtype=torch.int32, device=self.dev)
        card_args = [param_bytes,
                     nbytes([t for layers in cache.values() for c in layers
                             for t in c.values()]),
                     nbytes([tok]), nbytes([pos])]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        times = []
        for _ in range(2 + DRYRUN_DECODE_STEPS):
            t0 = time.perf_counter()
            out, cache = model.decode_step(cache, tok, pos)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts_c = self._moe_counts()
        calls = 2 + DRYRUN_DECODE_STEPS
        check(counts_c == {"flash_attention": 0,
                           "rmsnorm": calls * (2 * L + 1),
                           "swiglu": calls * L, "rmsnorm_bwd": 0,
                           "swiglu_bwd": 0},
              f"dryrun (c): launches {counts_c} for {calls} decode steps")
        check(out.shape == (rows, cfg.vocab)
              and bool(torch.isfinite(out).all()),
              "dryrun (c): decode logits finite, (rows, vocab)")
        cells.append(self._dryrun_cell(
            "c: qwen3-4b decode_step", rec,
            statistics.median(times[2:]), card_args,
            torch.cuda.max_memory_allocated(), counts_c, seconds=times))
        del model, cache, logits, out
        torch.cuda.empty_cache()
        self.path_launches["dryrun"] = {
            k: counts[k] + counts_b[k] + counts_c[k] for k in counts}
        emit({"phase": "dryrun", "card": self.card, "device_name": name,
              "total_memory": total, "hw": roofline.HW,
              "launches": self.path_launches["dryrun"],
              "bound_over_measured": {c["cell"]: c["bound_over_measured"]
                                      for c in cells}})

    def _dryrun_cell(self, cell, rec, measured_s, card_args, card_peak,
                     launches, **extra) -> dict:
        """One cell's line: the dry run's analytic FLOPs and bytes, its
        roofline terms at the H100's constants and bound against the time
        on the card, its meta FLOP count, and its argument and peak bytes
        beside the card's; fails if the time is below the bound or the
        argument bytes differ."""
        terms, mem, cost = rec["roofline"], rec["memory"], rec["cost"]
        bound = max(terms["compute_s"], terms["memory_s"],
                    terms["collective_s"])
        line = {
            "phase": "dryrun", "cell": cell, "card": self.card,
            "shape": rec["shape"], "variant": rec["variant"],
            "analytic_flops": cost["flops_per_dev"],
            "analytic_bytes": cost["bytes_per_dev"],
            "compute_s": terms["compute_s"], "memory_s": terms["memory_s"],
            "dominant": terms["dominant"], "bound_s": bound,
            "measured_s": measured_s, "bound_over_measured": bound / measured_s,
            "meta_flops": cost["meta_flops"],
            "argument_bytes": mem["argument_bytes"],
            "argument_bytes_each": mem["argument_bytes_each"],
            "card_argument_bytes_each": card_args,
            "peak_bytes": mem["peak_bytes"], "fits": mem["fits"],
            "card_max_memory_allocated": card_peak,
            "peak_counted_on": rec["meta"]["counted_on"],
            "dryrun_run_s": rec["timings"]["run_s"], "launches": launches,
            **extra}
        emit(line)
        check(rec["status"] == "ok" and rec["n_chips"] == 1,
              f"dryrun {cell}: record {rec['status']}")
        check(bound / measured_s <= 1.0,
              f"dryrun {cell}: measured {measured_s} s is below the "
              f"roofline bound {bound} s")
        check(mem["argument_bytes_each"] == card_args,
              f"dryrun {cell}: argument bytes {mem['argument_bytes_each']} "
              f"on meta, {card_args} on the card")
        return line

    # -------------------------------------------------------------- mesh
    def mesh(self):
        """The paper's path on a mesh: MESH_RANKS spawned ranks share the
        one card under gloo (NCCL refuses two ranks on one device), each
        proposing its contiguous quarter of every epoch with
        `dpmeans_assign` on the card, the proposals all-gathered and the
        validator re-executed on every rank.  DP-means, OFL and BP-means
        (`_mesh_paths`) on every rank equal the one-process run here on
        the card bit for bit; the mesh invariants hold; mesh serving of
        the published DP-means snapshot equals the meshless service
        response for response (and a k = 100 top-k query from the OFL
        snapshot, the kernel's wide route); the compressed psum over a
        (4,) "pod" mesh on the card's tensors is within the reference's
        bound of the exact sum and equals the same ranks' result on the
        host's tensors; a checkpoint of a (2, 2) mesh restores onto the
        (1, 2) mesh two failures leave.  The parent builds the kernels and
        runs the one-process references alone first; the ranks only load
        the libraries.  A rank that fails fails the phase."""
        import multiprocessing
        import pickle
        import socket
        from repro_torch.serving import SnapshotStore
        self._ensure_built()
        ctx = multiprocessing.get_context("spawn")
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        go = ctx.Event()
        with tempfile.TemporaryDirectory() as out_dir:
            # the ranks import while the one-process references run; they
            # create their CUDA contexts after `go`
            procs = [ctx.Process(target=_mesh_rank,
                                 args=(r, MESH_RANKS, port, out_dir,
                                       self.seed, go), daemon=True)
                     for r in range(MESH_RANKS)]
            for p in procs:
                p.start()
            one, one_s, x = _mesh_paths(None, "cuda", self.seed)
            store = SnapshotStore(device="cuda")
            store.publish_pool(one["dp_means"].pool)
            one_serve = _mesh_serve(store, x, None)
            go.set()
            t0 = time.perf_counter()
            deadline = time.monotonic() + MESH_TIMEOUT_S
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            codes = [p.exitcode for p in procs]
            check(not hung and codes == [0] * MESH_RANKS,
                  f"mesh: rank exit codes {codes}, still running {hung}")
            ranks = []
            for r in range(MESH_RANKS):
                with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
                    ranks.append(pickle.load(f))
        ranks_s = time.perf_counter() - t0
        want = {k: _host(v) for k, v in one.items()}
        for r in ranks:
            for name in want:
                check(_host_equal(r["results"][name], want[name]),
                      f"mesh: rank {r['rank']}'s {name} == one process, "
                      "bitwise")
            for key, ok in r["invariants"].items():
                check(ok, f"mesh: rank {r['rank']} {key}")
            check(r["serve_eq_meshless"],
                  f"mesh: rank {r['rank']}'s mesh serving == meshless")
            check(r["topk100"]["eq_meshless"]
                  and r["topk100"]["shape"] == [64, 100]
                  and r["topk100"]["capacity"] > 64,
                  f"mesh: rank {r['rank']}'s k = 100 query, wide route")
            check(r["launches"]["dpmeans_assign"] > 0
                  and r["launches"]["topk_stream"] > 0
                  and r["dp_assign_launches"] == r["proposes"] > 0,
                  f"mesh: rank {r['rank']} launched both kernels "
                  f"({r['launches']}, DP-means {r['dp_assign_launches']} "
                  f"for {r['proposes']} proposes)")
        g = ranks[0]["psum"]["g_all"]
        exact = g.sum(0)
        bound = 4 * (float(abs(g).max()) / 127) + 1e-6
        for r in ranks:
            card, host = r["psum"]["cuda"], r["psum"]["cpu"]
            check(_host_equal(list(card), list(host))
                  and _host_equal(card[0], ranks[0]["psum"]["cuda"][0]),
                  f"mesh: rank {r['rank']}'s compressed psum, card == host "
                  "and every rank alike")
            check(float(abs(card[0] - exact).max()) <= bound,
                  "mesh: compressed psum within the reference's bound")
        el = [r["elastic"] for r in ranks]
        check([e["in_new_mesh"] for e in el] == [True, True, False, False]
              and all(e["plan"] == {"data": 1, "model": 2} for e in el)
              and all(e["equal"] and e["step"] == 3
                      and e["local_shape"] == [64, 16] for e in el[:2]),
              f"mesh: elastic restore (2, 2) -> (1, 2): {el}")
        self.path_launches["mesh"] = {
            k: sum(r["launches"][k] for r in ranks)
            for k in ("dpmeans_assign", "topk_stream")}
        emit({"phase": "mesh", "ranks": MESH_RANKS,
              "backend": ranks[0]["backend"],
              "collectives_on_card_tensors": ranks[0]["collectives"],
              "n": {"dp_means": MESH_DP_N, "ofl": MESH_OFL_N,
                    "bp_means": MESH_BP_N, "invariants": MESH_INV_N},
              "K": {k: int(v["pool"]["count"]) for k, v in want.items()},
              "one_process_seconds": one_s,
              "ranks_wall_s": ranks_s,
              "per_rank": [{
                  "rank": r["rank"], "seconds": r["seconds"],
                  "dp_propose_ms": r["propose_ms"],
                  "dp_proposes": r["proposes"],
                  "dp_gather_ms": r["gather_ms"],
                  "dp_gathers": r["gathers"],
                  "dp_assign_launches": r["dp_assign_launches"],
                  "launches": r["launches"], "serve": r["serve"],
                  "marks_s": r["marks_s"],
                  "topk100": r["topk100"]} for r in ranks],
              "one_process_serve": {k: one_serve[k] for k in (
                  "seconds", "request_p50_ms", "request_p99_ms")},
              "invariants": ranks[0]["invariants"],
              "elastic": el, "launches": self.path_launches["mesh"],
              "card": self.card})

    def lm_mesh(self):
        """The language model's mesh: LM_MESH_RANKS spawned ranks share the
        card under gloo on a (data 2, model 2) mesh (`_lm_mesh_paths`):
        qwen3-4b at full width, in f32 at LM_MESH_F32_LAYERS layers (the
        slot engine's greedy tokens in modes "tp" and "cp" identical to one
        process's) and in bf16 at full depth (the engine in both modes, a
        prefill whose logits stay within LM_MESH_SPREAD_X times one
        process's kernels-against-plain spread), and granite-3-2b's train
        step at full width (loss and grad norm per step within the same
        multiple of their spread), one error-feedback step on (pod 2,
        model 2).  Then the MoE parts on the same mesh, the experts split
        over model (`_lm_mesh_moe_paths`: olmoe-1b-7b in f32 at 2 layers,
        served at full depth in bf16 and trained at 2 layers; phi3.5-moe
        at 2 layers prefilled and trained), and the hybrid parts, the
        Mamba2 heads and the shared block split over model
        (`_lm_mesh_hybrid_paths`: zamba2-7b in f32 at 12 layers prefilled,
        served and stepped; served and prefilled at full depth in bf16;
        trained at 12 layers).  Every rank launches the
        flash, rmsnorm, swiglu and both backward kernels on the main path,
        runs no plain backward, and gets the same results.  The parent
        builds the kernels and runs the one-process references (and their
        plain versions) alone first; a rank that fails fails the phase."""
        import multiprocessing
        import pickle
        import socket
        import numpy as np
        torch = self.torch
        self._ensure_built()
        ctx = multiprocessing.get_context("spawn")
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        go = ctx.Event()
        with tempfile.TemporaryDirectory() as out_dir:
            procs = [ctx.Process(target=_lm_mesh_rank,
                                 args=(r, LM_MESH_RANKS, port, out_dir,
                                       self.seed, go), daemon=True)
                     for r in range(LM_MESH_RANKS)]
            for p in procs:
                p.start()
            one = _lm_mesh_paths(None, None, self.dev, self.seed, plain=True)
            torch.cuda.empty_cache()
            go.set()
            t0 = time.perf_counter()
            deadline = time.monotonic() + LM_MESH_TIMEOUT_S
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            codes = [p.exitcode for p in procs]
            check(not hung and codes == [0] * LM_MESH_RANKS,
                  f"lm_mesh: rank exit codes {codes}, still running {hung}")
            ranks = []
            for r in range(LM_MESH_RANKS):
                with open(os.path.join(out_dir, f"{r}.pkl"), "rb") as f:
                    ranks.append(pickle.load(f))
        ranks_s = time.perf_counter() - t0
        line = _lm_mesh_report(one, ranks, ranks_s, self.card,
                               self._routing_agree)
        self.path_launches["lm_mesh"] = line["launches"]
        emit(line)
        check(not line["failed"], f"lm_mesh: {line['failed']}")

    def kernel_rows(self) -> list[dict]:
        """One row per kernel: launches on its main path, largest error
        against its plain version, and its times at the shape its main
        path gives it (dpmeans_assign: the paper's propose shape; top-k:
        the serving microbatch; the language-model kernels: qwen3-4b's
        prefill; their backward kernels: granite-3-2b's training step),
        with every timed shape under "shapes".  The language
        model's launches are those of its prefill plus its engine run."""
        rows = []
        main_shape = {"dpmeans_assign": "paper", "topk_stream": "serve_flat",
                      "topk_multiprobe_stream": "serve_multiprobe",
                      "flash_attention": "prefill", "rmsnorm": "prefill",
                      "swiglu": "prefill", "rmsnorm_bwd": "train",
                      "swiglu_bwd": "train"}
        sources = {"dpmeans_assign": ("dpmeans_assign.cu",
                                      "src/repro/kernels/dpmeans_assign.py:86"),
                   "topk_stream": ("topk_stream.cu",
                                   "src/repro/kernels/topk_stream.py:123"),
                   "topk_multiprobe_stream": (
                       "topk_stream.cu",
                       "src/repro/kernels/topk_stream.py:295"),
                   "flash_attention": (
                       "flash_attention.cu",
                       "src/repro/kernels/flash_attention.py:72"),
                   "rmsnorm": ("rmsnorm.cu", "src/repro/kernels/rmsnorm.py:25"),
                   "swiglu": ("swiglu.cu", "src/repro/kernels/swiglu.py:24"),
                   # the backward of the same TPU kernel, which has no VJP
                   # (the JAX package differentiates its plain version)
                   "rmsnorm_bwd": ("rmsnorm.cu",
                                   "src/repro/kernels/rmsnorm.py:25"),
                   "swiglu_bwd": ("swiglu.cu",
                                  "src/repro/kernels/swiglu.py:24")}
        for name in KERNELS:
            src, replaces = sources[name]
            launches = self.main_launches.get(name)
            if name in ("flash_attention", "rmsnorm", "swiglu") \
                    and self.lm_launches:
                launches = sum(c[name] for c in self.lm_launches.values())
            row = {"name": name, "route": "cuda", "card": self.card,
                   "source": f"src/repro_torch/kernels/csrc/{src}",
                   "replaces": replaces, "launches": launches,
                   "max_abs_err": self.max_abs_err[name]}
            if name == "dpmeans_assign":
                # the cluster phases' launches: their master (or driver)
                # process and every worker process
                row["launches_dp_paper"] = launches
                for extra in (self.cluster_launches, self.ha_launches):
                    if extra is not None:
                        row["launches"] = (row["launches"] or 0) \
                            + extra["total"]
                row["launches_cluster"] = self.cluster_launches
                row["launches_ha"] = self.ha_launches
                row["launches_retrieval"] = self.retrieval_launches
                row["launches_ofl"] = self.ofl_launches
                row["launches_fig3"] = self.fig3_launches
                # by the kernel the width chose, on the paths that run
                # more than D = 16 (every other path runs the fast tile)
                row["launches_by_tile"] = {
                    path: counts["dpmeans_assign_by_tile"]
                    for path, counts in self.path_launches.items()
                    if "dpmeans_assign_by_tile" in counts}
            if name.endswith("_bwd"):
                row["backward_of"] = replaces
            if name in ("flash_attention", "rmsnorm", "swiglu"):
                row["launches_by_path"] = {
                    path: c[name] for path, c in self.lm_launches.items()}
            if name == "rmsnorm" and self.lm_launches:
                row["launches_one_read"] = sum(
                    c["rmsnorm_one_read"] for c in self.lm_launches.values())
            # the train-while-serve, curation and examples paths
            for path, counts in self.path_launches.items():
                row[f"launches_{path}"] = counts.get(name, 0)
                row["launches"] = (row["launches"] or 0) \
                    + counts.get(name, 0)
            shapes = [t for t in self.timings if t["kernel"] == name]
            main = next((t for t in shapes
                         if t["shape"] == main_shape[name]), None)
            for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms"):
                row[key] = None if main is None else main[key]
            if main is not None and "sdpa" in main:
                row["library_backend"] = main["sdpa"]["default_backend"]
            row["shapes"] = shapes
            rows.append(row)
        return rows


def _losses_of(main, argv) -> dict:
    """Run a training example's `main(argv)` with its output captured:
    the first printed step loss and the final loss it returns."""
    import io
    import re
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        final = main(argv)
    losses = [float(v) for v in re.findall(r"^step +\d+ loss +([\d.]+)",
                                           buf.getvalue(), re.M)]
    check(bool(losses), f"no step losses printed: {buf.getvalue()[-500:]}")
    return {"first_loss": losses[0], "final_loss": float(final),
            "printed_steps": len(losses)}


def _same(a, b) -> bool:
    """Two result trees hold equal tensors: results, pools and the sent /
    accepted counts, not the caps, which differ by design between cap
    settings."""
    import torch
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(u, v)
                                      for u, v in zip(la, lb))


def _fig3_x(s: dict, n: int):
    """A Figure 3 run's data, from its settings in the golden file."""
    from repro_torch import data
    return getattr(data, s["data"])(n, seed=s["seed"])[0]


def _fig3_run(s: dict, pb: int, n: int):
    """(proposed, accepted) totals of one Figure 3 run on the card, through
    the entry point its settings name; OFL's key is the raw key data (0, r)
    of `jax.random.key(r)`."""
    from repro_torch import core
    kw = ({"key": tuple(s["key"])} if s["key"] is not None
          else {"max_iters": 1})
    res = getattr(core, s["entry"])(_fig3_x(s, n), s["lam"], pb=pb,
                                    k_max=s["k_max"], device="cuda", **kw)
    return int(res.stats.proposed.sum()), int(res.stats.accepted.sum())


def _fig3_margin(s: dict, pb: int, n: int) -> float:
    """The smallest decision margin of one Figure 3 run, over its propose
    and validator decisions: |d²/λ² − u| (OFL), |d² − λ²| (DP-means),
    |‖r‖² − λ²| (BP-means).  The run is repeated with a transaction that
    records them."""
    import torch
    from repro_torch.core import (
        BPMeansTransaction, DPMeansTransaction, OCCEngine, OFLTransaction,
    )
    from repro_torch.core.dp_means import _lam2
    algo = {"occ_ofl": "ofl", "occ_bp_means": "bpmeans"}.get(
        s["entry"], "dpmeans")
    lam2 = _lam2(s["lam"], torch.float32)
    margins = []

    def record(v, u=None):
        m = (v / lam2 - u) if u is not None else (v - lam2)
        margins.append(float(m.abs().min()))
    base = {"ofl": OFLTransaction, "bpmeans": BPMeansTransaction}.get(
        algo, DPMeansTransaction)

    class Recording(base):
        def propose(self, pool, x_e, state_e):
            out = base.propose(self, pool, x_e, state_e)
            if algo == "ofl":
                record(out[2][1], out[2][0])
            elif algo == "bpmeans":
                record(torch.sum(out[1] * out[1], dim=-1))
            else:
                record(out[2][0])
            return out

        def accept_pre(self, v, aux_j):
            record(v, aux_j if algo == "ofl" else None)
            return base.accept_pre(self, v, aux_j)
    txn = Recording(s["lam"], s["k_max"], tuple(s["key"])) \
        if algo == "ofl" else Recording(s["lam"], s["k_max"])
    OCCEngine(txn, pb, device="cuda").run(_fig3_x(s, n))
    return min(margins)


def _flash_bf16_p(torch, q, k, v, causal: bool):
    """The plain flash version with P rounded to bf16 before P·V, one batch
    row at a time: the row max and l from f32 logits, p = exp(s - max)
    rounded to bf16, out = (p @ v) / l in f32, cast to q's dtype."""
    b, h, s, dh = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    for i in range(b):
        g = h // k.shape[1]
        kq = torch.repeat_interleave(k[i:i + 1], g, dim=1).float()
        vq = torch.repeat_interleave(v[i:i + 1], g, dim=1).float()
        logits = torch.einsum("bhqd,bhkd->bhqk", q[i:i + 1].float(),
                              kq) * dh ** -0.5
        if causal:
            pos = torch.arange(s, device=q.device)
            logits = logits.masked_fill(pos[None, :] > pos[:, None],
                                        -torch.inf)
        p = torch.exp(logits - logits.amax(-1, keepdim=True))
        del logits
        l = p.sum(-1, keepdim=True)
        o = torch.einsum("bhqk,bhkd->bhqd",
                         p.to(torch.bfloat16).float(), vq) / l
        out[i:i + 1] = o.to(q.dtype)
        del p, o
    return out


def _ptxas_summary(log: str) -> list[dict]:
    """Registers, spill bytes and shared memory of each kernel entry in
    `nvcc -Xptxas -v` output, with the names demangled where c++filt is
    found."""
    import re
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(m.group(1)) if m else 0
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            r["kernel"] for r in rows), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                r["kernel"] = n.replace("(anonymous namespace)::", "") \
                    .split("(")[0].removeprefix("void ")
    except OSError:
        pass
    return rows


class _Routing:
    """While active, records every call of the port's MoE router
    (`models.moe._router`) in order: its (top_p, top_i) and, with `probs`,
    the full softmax of its input."""

    def __init__(self, torch, probs: bool = False):
        self.torch, self.probs, self.calls = torch, probs, []

    def __enter__(self):
        from repro_torch.models import moe
        self.module, self.router = moe, moe._router

        def recorded(p, x, cfg):
            top_p, top_i = self.router(p, x, cfg)
            rec = {"top_p": top_p.detach(), "top_i": top_i.detach()}
            if self.probs:
                rec["probs"] = self.torch.softmax(
                    x.detach().float() @ p["router"].detach(), dim=-1)
            self.calls.append(rec)
            return top_p, top_i
        moe._router = recorded
        return self

    def __exit__(self, *exc):
        self.module._router = self.router
        return False


def _device_events(prof) -> list[tuple[str, float, int]]:
    """(name, device microseconds, count) of each kind of work the device
    ran in a profile: its kernels and copies only, summed by name from the
    profiler's raw events (the host-side event that launched a kernel
    reports the same device time, so summing over every event would count
    each kernel twice).  The raw events are read directly:
    `key_averages()` builds a Python object an event, about 150 µs each,
    which over an xlstm prefill's 625,000 kernels took 97 s."""
    from torch.autograd import DeviceType
    sums: dict[str, list] = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA or ev.duration_ns() <= 0:
            continue
        acc = sums.setdefault(ev.name(), [0.0, 0])
        acc[0] += ev.duration_ns() / 1e3
        acc[1] += 1
    return [(name, us, count) for name, (us, count) in sums.items()]


def _perturbed(np, chunks, n: int, seed: int):
    """n queries near random chunks, as `examples/retrieval_index.py` makes
    them: a query lands near its source chunk, not on it."""
    rng = np.random.default_rng(seed)
    base = chunks[rng.integers(0, chunks.shape[0], size=n)]
    return base + 0.02 * rng.normal(size=base.shape).astype(np.float32)


def _leaves(tree):
    """The tensors of a result tree, leaving out `OCCStats.cap`."""
    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple) and getattr(tree, "_fields", None) == (
            "proposed", "accepted", "cap"):
        return [tree.proposed, tree.accepted]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return []



# ------------------------------------------------------------------- mesh
def _host(tree):
    """A result tree on the host: NamedTuples as dicts of numpy arrays
    (`OCCStats.cap` left out, as `_same` leaves it), other values kept."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and getattr(tree, "_fields", None) == (
            "proposed", "accepted", "cap"):
        return {"proposed": _host(tree.proposed),
                "accepted": _host(tree.accepted)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _host(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (tuple, list)):
        return [_host(t) for t in tree]
    return tree


def _host_equal(a, b) -> bool:
    """Two `_host` trees are equal, arrays bit for bit."""
    import numpy as np
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(_host_equal(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_host_equal(u, v) for u, v in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape
                and np.array_equal(a.reshape(-1).view(np.uint8),
                                   b.reshape(-1).view(np.uint8)))
    return a == b


def _mesh_sync(dev_type: str) -> None:
    import torch
    if dev_type == "cuda":
        torch.cuda.synchronize()


def _mesh_paths(mesh, dev_type: str, seed: int, dp_hooks=None):
    """The paper's three algorithms at the mesh phase's sizes, on `mesh`
    (None: one process): DP-means (lambda 4, K_max 512, Pb 2048, two
    passes) over MESH_DP_N points, OFL over the first MESH_OFL_N, BP-means
    over MESH_BP_N feature points.  `dp_hooks` (start, stop) bracket the
    DP-means pass.  Returns (results, seconds of each, the data)."""
    from repro_torch.core import occ_bp_means, occ_dp_means, occ_ofl
    from repro_torch.data import (
        bp_stick_breaking_data, dp_stick_breaking_data,
    )
    x = dp_stick_breaking_data(MESH_DP_N, dim=16, seed=seed)[0]
    xb = bp_stick_breaking_data(MESH_BP_N, seed=seed)[0]
    kw = dict(device=dev_type, mesh=mesh)
    res, secs = {}, {}
    runs = (
        ("dp_means", lambda: occ_dp_means(x, 4.0, pb=2048, k_max=512,
                                          max_iters=2, **kw)),
        ("ofl", lambda: occ_ofl(x[:MESH_OFL_N], 4.0, 2048, key=(0, seed),
                                k_max=MESH_OFL_K_MAX, **kw)),
        ("bp_means", lambda: occ_bp_means(xb, 4.0, 2048, k_max=512,
                                          max_iters=2, **kw)))
    for name, run in runs:
        if name == "dp_means" and dp_hooks:
            dp_hooks[0]()
        _mesh_sync(dev_type)
        t0 = time.perf_counter()
        res[name] = run()
        _mesh_sync(dev_type)
        secs[name] = time.perf_counter() - t0
        if name == "dp_means" and dp_hooks:
            dp_hooks[1]()
    return res, secs, x


def _mesh_serve(store, x, mesh) -> dict:
    """MESH_REQUESTS requests each of a 64-row score and a 64-row top-k
    (k 8), interleaved, through a `ClusterService` on `mesh` (None: one
    process).  Returns the answers and the request p50 / p99."""
    from repro_torch.serving import ClusterService
    svc = ClusterService(store, mesh=mesh)
    answers = []
    t0 = time.perf_counter()
    for i in range(MESH_REQUESTS):
        q = x[(64 * i) % x.shape[0]:][:64]
        for r in (svc.score(q), svc.topk(q, k=8)):
            answers.append((r.version, r.labels, r.scores))
    m = svc.metrics()
    return {"answers": answers, "seconds": time.perf_counter() - t0,
            "request_p50_ms": m["request_p50_ms"],
            "request_p99_ms": m["request_p99_ms"]}


def _mesh_invariants(x, mesh, dev_type: str) -> dict:
    """On the mesh, over the first MESH_INV_N points: the adaptive cap ==
    full cap, the log-depth scan == serial, a `partial_fit` stream == the
    one-shot pass."""
    from repro_torch.core import DPMeansTransaction, OCCEngine, occ_dp_means
    xi = x[:MESH_INV_N]
    kw = dict(device=dev_type, mesh=mesh)
    out = {}
    full = occ_dp_means(xi, 4.0, pb=2048, k_max=512, max_iters=2, **kw)
    adap = occ_dp_means(xi, 4.0, pb=2048, k_max=512, max_iters=2,
                        validate_cap="adaptive", **kw)
    out["adaptive_eq_full"] = _same(adap, full)
    ser = occ_dp_means(xi, 4.0, pb=2048, k_max=512, **kw)
    logd = occ_dp_means(xi, 4.0, pb=2048, k_max=512, scan_mode="logdepth",
                        **kw)
    out["logdepth_eq_serial"] = _same(logd, ser)
    one = OCCEngine(DPMeansTransaction(4.0, 512), 2048, **kw).run(xi)
    eng = OCCEngine(DPMeansTransaction(4.0, 512), 2048, **kw)
    cuts = (0, 1000, 1037, 3000, MESH_INV_N)
    parts = [eng.partial_fit(xi[a:b]) for a, b in zip(cuts, cuts[1:])]
    tail = eng.flush()
    parts += [tail] if tail is not None else []
    import torch
    out["stream_eq_oneshot"] = (
        _same(eng.pool, one.pool)
        and torch.equal(torch.cat([p.assign for p in parts]), one.assign))
    return out


def _mesh_rank(rank: int, world: int, port: int, out_dir: str, seed: int,
               go, dev_type: str = "cuda") -> None:
    """One rank of the mesh phase: the three algorithms on a (world,)
    "data" mesh with the propose and gather of the DP-means pass timed,
    the invariants, mesh serving (and the k = 100 query), the compressed
    psum on a (world,) "pod" mesh on the card's and the host's tensors,
    and the elastic restore (2, 2) -> (1, 2).  Writes its results to
    out_dir/<rank>.pkl.  It imports, then waits for `go` before it touches
    the card (the parent's one-process runs take the card alone while the
    ranks import).  A fault prints the rank's Python stack."""
    import faulthandler
    import pickle
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import DPMeansTransaction
    from repro_torch.distributed import shardings
    from repro_torch.distributed.elastic import (
        build_mesh_from_plan, plan_shrunk_mesh,
    )
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import compat_mesh, init_ranks
    from repro_torch.optim.compression import (
        compressed_psum_with_feedback, ef_init,
    )
    from repro_torch.serving import ClusterService, SnapshotStore
    faulthandler.enable()
    if not go.wait(MESH_TIMEOUT_S):
        raise RuntimeError("mesh: the parent never started the ranks")
    t_go = time.perf_counter()
    backend = init_ranks(rank, world, f"tcp://localhost:{port}", dev_type,
                         timeout_s=MESH_TIMEOUT_S)
    mesh = compat_mesh((world,), ("data",), dev_type)
    out = {"rank": rank, "backend": backend}
    marks = {"setup": time.perf_counter() - t_go}

    # The DP-means pass's propose (CUDA events) and gather (host clock
    # between synchronisations) on this rank.
    events, gathers = [], []
    propose0, gather0 = DPMeansTransaction.propose, shardings.gather_rows

    def timed_propose(txn, pool, x_e, state_e):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        got = propose0(txn, pool, x_e, state_e)
        b.record()
        events.append((a, b))
        return got

    def timed_gather(tree, shard):
        _mesh_sync(dev_type)
        t0 = time.perf_counter()
        got = gather0(tree, shard)
        _mesh_sync(dev_type)
        gathers.append(time.perf_counter() - t0)
        return got

    def start():
        if dev_type == "cuda":
            DPMeansTransaction.propose = timed_propose
        shardings.gather_rows = timed_gather
        ops.reset_launch_counts()

    def stop():
        out["dp_assign_launches"] = ops.ASSIGN_LAUNCHES
        DPMeansTransaction.propose = propose0
        shardings.gather_rows = gather0

    # --- the main path: counts from 0 just before, read just after ------
    ops.reset_launch_counts()
    res, secs, x = _mesh_paths(mesh, dev_type, seed, (start, stop))
    store = SnapshotStore(device=dev_type)
    store.publish_pool(res["dp_means"].pool)
    served = _mesh_serve(store, x, mesh)
    ofl_store = SnapshotStore(device=dev_type)
    ofl_store.publish_pool(res["ofl"].pool)
    q100 = [ClusterService(ofl_store, mesh=mesh).topk(x[:64], k=100)]
    out["launches"] = {"dpmeans_assign": ops.ASSIGN_LAUNCHES,
                       "topk_stream": ops.TOPK_LAUNCHES}
    # ---------------------------------------------------------------------
    q100.append(ClusterService(ofl_store).topk(x[:64], k=100))
    _mesh_sync(dev_type)
    out["propose_ms"] = sum(a.elapsed_time(b) for a, b in events)
    out["proposes"] = len(events)
    out["gather_ms"] = 1e3 * sum(gathers)
    out["gathers"] = len(gathers)
    out["seconds"] = secs
    out["results"] = {k: _host(v) for k, v in res.items()}
    marks["paths_and_serving"] = time.perf_counter() - t_go
    plain = _mesh_serve(store, x, None)
    out["serve"] = {k: served[k] for k in ("seconds", "request_p50_ms",
                                           "request_p99_ms")}
    out["serve_eq_meshless"] = _host_equal(_host(served["answers"]),
                                           _host(plain["answers"]))
    out["topk100"] = {
        "capacity": ofl_store.latest().capacity,
        "shape": list(q100[0].labels.shape),
        "eq_meshless": _host_equal(
            _host([q100[0].labels, q100[0].scores, q100[0].version]),
            _host([q100[1].labels, q100[1].scores, q100[1].version]))}
    marks["meshless_serving"] = time.perf_counter() - t_go
    out["invariants"] = _mesh_invariants(x, mesh, dev_type)
    marks["invariants"] = time.perf_counter() - t_go

    # The compressed psum over a (world,) "pod" mesh: on the card's
    # tensors, and on the host's over the same ranks.
    g_all = np.random.default_rng(seed + 1).normal(
        size=(world, 4096)).astype(np.float32)
    g_all[2 % world, 5] = 7.5
    psum = {}
    for kind in (dev_type, "cpu"):
        pod = compat_mesh((world,), ("pod",), kind)
        grads = {"w": torch.from_numpy(g_all[rank].copy()).to(kind)}
        with shardings.shard_ctx(pod):
            got, ef = compressed_psum_with_feedback(grads, ef_init(grads),
                                                    "pod")
        psum[kind] = (got["w"].cpu().numpy(), ef.residual["w"].cpu().numpy())
    out["psum"] = {"g_all": g_all, **psum}
    marks["psum"] = time.perf_counter() - t_go

    # The elastic restore: a checkpoint of a (2, 2) mesh restored onto the
    # (1, 2) mesh that two failures leave.
    mesh22 = compat_mesh((2, 2), ("data", "model"), dev_type)
    w = torch.arange(64 * 32, dtype=torch.float32, device=dev_type
                     ).reshape(64, 32)
    sh = shardings.Sharding(mesh22, ("data", "model"))
    mgr = CheckpointManager(os.path.join(out_dir, "ckpt"))
    mgr.save(3, {"w": distribute_tensor(w, mesh22, shardings.placements(sh))})
    plan = plan_shrunk_mesh(mesh22, n_failed=2)
    new = build_mesh_from_plan(plan, device_type=dev_type)
    out["elastic"] = {"plan": plan.new_shape, "in_new_mesh": new is not None}
    if new is not None:
        step, back = mgr.restore(
            {"w": w}, shardings={"w": shardings.Sharding(new, ("data",
                                                               "model"))},
            device=dev_type)
        out["elastic"].update(
            step=step,
            equal=bool(torch.equal(shardings.full_tensor(back["w"]), w)),
            local_shape=list(back["w"].to_local().shape))
    marks["elastic"] = time.perf_counter() - t_go
    out["marks_s"] = marks
    out["collectives"] = [
        "all_gather (list form: the engine's and serving's gathers)",
        "all_reduce max and sum (the compressed psum)",
        "scatter (distribute_tensor)",
        "all_gather (list form: shardings.full_tensor of a DTensor)",
        "barrier"]
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# --------------------------------------------------------------- lm_mesh
def _lm_mesh_model(cfg, mesh, dev, seed: int, zero3: bool = True,
                   backend: str = "auto"):
    import torch
    from repro_torch.distributed.shardings import shard_ctx
    from repro_torch.models import build_model
    with shard_ctx(mesh, zero3=zero3):
        return build_model(cfg, device=dev, backend=backend, mesh=mesh).init(
            torch.Generator(device=dev).manual_seed(seed))


def _lm_mesh_engine(model, mode: str, seed: int, calls=None,
                    sizes=(LM_MESH_REQUESTS, LM_MESH_PROMPT, LM_MESH_NEW)
                    ) -> dict:
    """`sizes` = (requests, prompt, new tokens) through a ServeEngine in
    decode mode `mode`: greedy tokens, wall seconds, tick seconds, decode
    calls and (with `calls`, the collective counter) collectives a decode
    call."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import Request, ServeEngine
    n, prompt, new = sizes
    rng = np.random.default_rng(seed)
    eng = ServeEngine(model, n_slots=LM_MESH_SLOTS, cache_len=LM_MESH_CACHE,
                      decode_mode=mode)
    reqs = [Request(uid=i, prompt=rng.integers(0, model.cfg.vocab, prompt),
                    max_new=new) for i in range(n)]
    before = dict(calls) if calls is not None else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    out = {"tokens": sorted((r.uid, list(r.out)) for r in done),
           "seconds": time.perf_counter() - t0, "tick_s": eng.step_seconds,
           "decode_calls": eng.n_decode_calls}
    if calls is not None:
        out["collectives"] = {k: (calls[k] - before.get(k, 0))
                              / eng.n_decode_calls for k in calls}
    return out


def _lm_mesh_train(model, tcfg, pipe, steps: int, calls=None) -> dict:
    """`steps` train steps: (loss, grad norm) a step, step seconds, peak
    bytes, each leaf's gradient norm at the first step and (with `calls`)
    collectives a step."""
    import torch
    import torch.distributed as dist
    from repro_torch.training import make_train_step, train_state_init
    from repro_torch.training import step as step_mod
    state = train_state_init({n: p.detach() for n, p in
                              model.named_parameters()}, tcfg)
    step = make_train_step(model, tcfg)
    leaf_norms = {}
    update = step_mod.adamw_update

    def recorded(params, grads, *a, **kw):
        if not leaf_norms:
            names = sorted(grads)
            sq = torch.stack([torch.sum(torch.square(
                grads[n].to(torch.float32))) for n in names])
            mp = model.mp
            if mp is not None:     # each block once, summed over the mesh
                coord = mp.mesh.get_coordinate()
                keep = torch.tensor([float(all(
                    c == 0 for c, p in zip(coord, state.params[n].placements)
                    if p.is_replicate())) for n in names], device=sq.device)
                sq = sq * keep
                for md in range(mp.mesh.ndim):
                    dist.all_reduce(sq, group=mp.mesh.get_group(md))
            leaf_norms.update(zip(names, torch.sqrt(sq).tolist()))
        return update(params, grads, *a, **kw)
    step_mod.adamw_update = recorded
    torch.cuda.reset_peak_memory_stats()
    mets, secs = [], []
    before = None
    for i in range(steps):
        if i == 1 and calls is not None:    # after the recorded first step
            before = dict(calls)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, pipe.batch_at(i))
        mets.append([float(met["loss"]), float(met["grad_norm"])])
        secs.append(time.perf_counter() - t0)
    step_mod.adamw_update = update
    out = {"metrics": mets, "step_s": secs, "leaf_norms": leaf_norms,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    if before is not None:
        out["collectives"] = {k: (calls[k] - before.get(k, 0)) / (steps - 1)
                              for k in calls}
    return out


def _leaf_norm_diffs(one: dict, mesh: dict, top: int = 8) -> list:
    """The leaves whose first-step gradient norms differ most (relative)
    between one process and the mesh: (name, one's, the mesh's)."""
    rel = sorted(one, key=lambda n: -abs(mesh[n] - one[n])
                 / max(abs(one[n]), 1e-30))
    return [(n, one[n], mesh[n]) for n in rel[:top]]


def _lm_mesh_paths(mesh, pod, dev, seed: int, plain: bool = False,
                   calls=None, marks=None) -> dict:
    """The lm_mesh phase's workloads on `mesh` (data 2, model 2) and, for
    the error-feedback step, `pod` (pod 2, model 2); both None: one
    process.  `plain`: also one process's plain versions on the same
    inputs (the prefill's logits, the train steps)."""
    import numpy as np
    import torch
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data.tokens import TokenPipeline
    base = get_arch("qwen3-4b").replace(attn_impl="flash")
    res = {}

    def mark(name):
        if marks is not None:
            torch.cuda.synchronize()
            marks[name] = time.perf_counter()
    # f32, full width, LM_MESH_F32_LAYERS layers: greedy tokens
    m32 = _lm_mesh_model(base.replace(n_layers=LM_MESH_F32_LAYERS,
                                      dtype="float32"), mesh, dev, seed + 700,
                         zero3=False)
    res["f32"] = {mode: _lm_mesh_engine(m32, mode, seed,
                                        sizes=LM_MESH_F32_SERVE)["tokens"]
                  for mode in ("tp", "cp")}
    del m32
    torch.cuda.empty_cache()
    mark("f32_serve")
    # bf16, full width and depth: the engine in both modes, a prefill
    torch.cuda.reset_peak_memory_stats()
    mq = _lm_mesh_model(base, mesh, dev, seed + 701, zero3=False)
    res["serve"] = {mode: _lm_mesh_engine(mq, mode, seed, calls)
                    for mode in ("tp", "cp")}
    toks = np.random.default_rng(seed + 1).integers(
        0, base.vocab, (LM_MESH_PREFILL_B, LM_MESH_PREFILL_S))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = mq.prefill({"tokens": toks})
    torch.cuda.synchronize()
    res["prefill"] = {"logits": logits.cpu().numpy(),
                      "seconds": time.perf_counter() - t0}
    del caches
    if plain:
        mq.backend = "plain"
        res["prefill_plain_logits"] = mq.prefill({"tokens": toks})[0] \
            .cpu().numpy()
    res["serve_peak_bytes"] = torch.cuda.max_memory_allocated()
    del mq
    torch.cuda.empty_cache()
    mark("bf16_serve")
    # granite-3-2b's train steps, then one error-feedback step
    cfg = get_arch("granite-3-2b").replace(n_layers=LM_MESH_TRAIN_LAYERS)
    pipe = TokenPipeline(cfg.vocab, LM_MESH_TRAIN_BATCH, LM_MESH_TRAIN_SEQ,
                         seed=seed)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                       total_steps=LM_MESH_TRAIN_STEPS)
    res["train_f32"] = _lm_mesh_train(
        _lm_mesh_model(cfg.replace(n_layers=LM_MESH_F32_LAYERS,
                                   dtype="float32"), mesh, dev, seed + 703),
        tcfg, pipe, 2)
    torch.cuda.empty_cache()
    res["train"] = _lm_mesh_train(_lm_mesh_model(cfg, mesh, dev, seed + 702),
                                  tcfg, pipe, LM_MESH_TRAIN_STEPS, calls)
    torch.cuda.empty_cache()
    if plain:
        res["train_plain"] = _lm_mesh_train(
            _lm_mesh_model(cfg, mesh, dev, seed + 702, backend="plain"),
            tcfg, pipe, LM_MESH_TRAIN_STEPS)
        torch.cuda.empty_cache()
    mark("train")
    res["ef"] = _lm_mesh_train(
        _lm_mesh_model(cfg, pod, dev, seed + 702),
        TrainConfig(learning_rate=3e-4, warmup_steps=2,
                    total_steps=LM_MESH_TRAIN_STEPS, compress_cross_pod=True),
        pipe, 1)
    torch.cuda.empty_cache()
    mark("ef")
    res["moe"] = _lm_mesh_moe_paths(mesh, dev, seed, plain, calls, marks)
    res["hybrid"] = _lm_mesh_hybrid_paths(mesh, dev, seed, plain, calls,
                                          marks)
    return res


def _lm_launches() -> dict:
    """The language-model kernels' launch counts so far."""
    from repro_torch.kernels import ops
    return {"flash_attention": ops.FLASH_LAUNCHES,
            "rmsnorm": ops.RMSNORM_LAUNCHES, "swiglu": ops.SWIGLU_LAUNCHES,
            "rmsnorm_bwd": ops.RMSNORM_BWD_LAUNCHES,
            "swiglu_bwd": ops.SWIGLU_BWD_LAUNCHES}


class _Parts:
    """The lm_mesh phase's parts, one after another: each part's launches,
    seconds and peak memory go into `res[name]` with the part's own
    results, and `marks[prefix + name]` gets the time at its end."""

    def __init__(self, res: dict, marks, prefix: str):
        import torch
        self.torch, self.res, self.marks, self.prefix = torch, res, marks, \
            prefix

    def begin(self):
        self.torch.cuda.synchronize()
        self.torch.cuda.reset_peak_memory_stats()
        return _lm_launches(), time.perf_counter()

    def end(self, name: str, part: dict, began) -> None:
        torch = self.torch
        torch.cuda.synchronize()
        now = _lm_launches()
        part["launches"] = {k: now[k] - began[0][k] for k in now}
        part["seconds"] = time.perf_counter() - began[1]
        part["peak_bytes"] = torch.cuda.max_memory_allocated()
        self.res[name] = part
        torch.cuda.empty_cache()
        if self.marks is not None:
            self.marks[self.prefix + name] = time.perf_counter()


def _lm_mesh_hybrid_paths(mesh, dev, seed: int, plain: bool = False,
                          calls=None, marks=None) -> dict:
    """The lm_mesh phase's hybrid parts (LM_MESH_HYB_LAYERS' note) on
    `mesh` (data 2, model 2), or in one process (None); `plain`: also one
    process's plain versions (the prefills and train steps, f32 and
    bf16).  Each
    part records its launches, seconds and peak memory; the bf16 engine
    run also its launches a decode call."""
    import numpy as np
    import torch
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data.tokens import TokenPipeline
    b, s = LM_MESH_PREFILL_B, LM_MESH_PREFILL_S
    res = {}
    parts = _Parts(res, marks, "hybrid_")

    def prefill(model, toks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill({"tokens": toks})
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        del caches
        return {"logits": logits.cpu(), "seconds": secs}

    base = get_arch("zamba2-7b")
    toks = np.random.default_rng(seed + 740).integers(0, base.vocab, (b, s))
    cfg = base.replace(n_layers=LM_MESH_HYB_LAYERS)
    pipe = TokenPipeline(cfg.vocab, LM_MESH_HYB_TRAIN_BATCH,
                         LM_MESH_TRAIN_SEQ, seed=seed)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                       total_steps=LM_MESH_TRAIN_STEPS)
    # f32, full width, 12 layers: a prefill, greedy tokens in both modes,
    # one train step
    began = parts.begin()
    m = _lm_mesh_model(cfg.replace(dtype="float32", attn_impl="flash"), mesh,
                       dev, seed + 740, zero3=False)
    part = {"prefill": prefill(m, toks), "tokens": {
        mode: _lm_mesh_engine(m, mode, seed, sizes=LM_MESH_F32_SERVE)[
            "tokens"] for mode in ("tp", "cp")}}
    if plain:
        m.backend = "plain"
        part["prefill_plain"] = prefill(m, toks)
    del m
    parts.end("f32", part, began)
    began = parts.begin()
    # ZeRO-3 off: no gathers of the f32 weights over data before the step
    # (the bf16 steps below keep ZeRO-3)
    parts.end("train_f32", _lm_mesh_train(_lm_mesh_model(
        cfg.replace(dtype="float32"), mesh, dev, seed + 741, zero3=False),
        tcfg, pipe, 1), began)
    if plain:
        res["train_f32_plain"] = _lm_mesh_train(_lm_mesh_model(
            cfg.replace(dtype="float32"), mesh, dev, seed + 741, zero3=False,
            backend="plain"), tcfg, pipe, 1)
        torch.cuda.empty_cache()
    # bf16, full width and depth: the engine in "tp", a prefill
    began = parts.begin()
    m = _lm_mesh_model(base.replace(attn_impl="flash"), mesh, dev,
                       seed + 742, zero3=False)
    before = _lm_launches()
    part = {"serve": _lm_mesh_engine(m, "tp", seed, calls)}
    now = _lm_launches()
    part["serve"]["launches_per_call"] = {
        k: (now[k] - before[k]) / part["serve"]["decode_calls"] for k in now}
    part["prefill"] = prefill(m, toks)
    if plain:
        m.backend = "plain"
        part["prefill_plain"] = prefill(m, toks)
    del m
    parts.end("serve", part, began)
    # bf16 train steps at 12 layers
    began = parts.begin()
    parts.end("train", _lm_mesh_train(_lm_mesh_model(cfg, mesh, dev,
                                                     seed + 743),
                                      tcfg, pipe, LM_MESH_TRAIN_STEPS, calls),
              began)
    if plain:
        res["train_plain"] = _lm_mesh_train(
            _lm_mesh_model(cfg, mesh, dev, seed + 743, backend="plain"),
            tcfg, pipe, LM_MESH_TRAIN_STEPS)
        torch.cuda.empty_cache()
    return res


def _lm_mesh_moe_paths(mesh, dev, seed: int, plain: bool = False,
                       calls=None, marks=None) -> dict:
    """The lm_mesh phase's MoE parts (LM_MESH_MOE_LAYERS' note) on `mesh`
    (data 2, model 2), or in one process (None); `plain`: also one
    process's plain versions (the bf16 prefills and train steps).  Each
    part records its launches, seconds and peak memory; prefills record
    every layer's routing of this rank's rows (CPU tensors)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import TrainConfig, get_arch
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import local_weights
    b, s = LM_MESH_PREFILL_B, LM_MESH_PREFILL_S
    res = {}
    parts = _Parts(res, marks, "moe_")
    begin, end = parts.begin, parts.end

    def prefill(model, toks, probs=False):
        with _Routing(torch, probs=probs) as rec:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = model.prefill({"tokens": toks})
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        del caches
        return {"logits": logits.cpu(), "seconds": secs,
                "rows": (0, b) if model.mp is None else model.mp.rows(b),
                "routing": [{k: v.cpu() for k, v in c.items()}
                            for c in rec.calls]}

    base = get_arch("olmoe-1b-7b")
    toks = np.random.default_rng(seed + 720).integers(0, base.vocab, (b, s))
    # f32, full width, 2 layers: prefill and routing, the five impls on
    # layer 0's weights, greedy tokens in both decode modes
    began = begin()
    cfg = base.replace(n_layers=LM_MESH_F32_LAYERS, dtype="float32",
                       attn_impl="flash")
    m = _lm_mesh_model(cfg, mesh, dev, seed + 720, zero3=False)
    part = {"prefill": prefill(m, toks, probs=mesh is None), "impls": {}}
    p0 = local_weights({n: t.detach() for n, t in
                        m.segments["seg_00"][0].items()}, m.mp)
    x = torch.randn((1, s, cfg.d_model), device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed + 721))
    with torch.inference_mode():
        for impl in LM_MESH_MOE_IMPLS:
            c = cfg.replace(moe=dataclasses.replace(cfg.moe, impl=impl))
            part["impls"][impl] = moe_mod.moe_apply(p0, x, c, mp=m.mp).cpu()
    part["tokens"] = {mode: _lm_mesh_engine(
        m, mode, seed, sizes=LM_MESH_F32_SERVE)["tokens"]
        for mode in ("tp", "cp")}
    del m, p0, x
    end("f32", part, began)
    # bf16, full width and depth: the engine in "tp", a prefill
    began = begin()
    m = _lm_mesh_model(base.replace(attn_impl="flash"), mesh, dev,
                       seed + 722, zero3=False)
    part = {"serve": _lm_mesh_engine(
        m, "tp", seed, calls,
        sizes=(LM_MESH_REQUESTS, LM_MESH_PROMPT, LM_MESH_MOE_NEW)),
            "prefill": prefill(m, toks)}
    if plain:
        m.backend = "plain"
        part["prefill_plain"] = prefill(m, toks)
    del m
    end("serve", part, began)
    # bf16 train steps at 2 layers, then one f32 step
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2,
                       total_steps=LM_MESH_MOE_TRAIN_STEPS)
    cfg = base.replace(n_layers=LM_MESH_MOE_LAYERS)
    pipe = TokenPipeline(cfg.vocab, LM_MESH_MOE_TRAIN_BATCH,
                         LM_MESH_TRAIN_SEQ, seed=seed)
    began = begin()
    end("train", _lm_mesh_train(_lm_mesh_model(cfg, mesh, dev, seed + 723),
                                tcfg, pipe, LM_MESH_MOE_TRAIN_STEPS, calls),
        began)
    if plain:
        res["train_plain"] = _lm_mesh_train(
            _lm_mesh_model(cfg, mesh, dev, seed + 723, backend="plain"),
            tcfg, pipe, LM_MESH_MOE_TRAIN_STEPS)
        torch.cuda.empty_cache()
    began = begin()
    end("train_f32", _lm_mesh_train(_lm_mesh_model(
        cfg.replace(dtype="float32"), mesh, dev, seed + 723), tcfg, pipe, 1),
        began)
    # phi3.5-moe at full width and 2 layers: a prefill, one train step
    pcfg = get_arch("phi3.5-moe-42b-a6.6b").replace(
        n_layers=LM_MESH_MOE_LAYERS)
    ptoks = np.random.default_rng(seed + 724).integers(0, pcfg.vocab, (b, s))
    began = begin()
    m = _lm_mesh_model(pcfg.replace(attn_impl="flash"), mesh, dev,
                       seed + 724, zero3=False)
    part = {"prefill": prefill(m, ptoks)}
    if plain:
        m.backend = "plain"
        part["prefill_plain"] = prefill(m, ptoks)
    del m
    end("phi_prefill", part, began)
    ppipe = TokenPipeline(pcfg.vocab, b, s, seed=seed)
    began = begin()
    end("phi_train", _lm_mesh_train(
        _lm_mesh_model(pcfg, mesh, dev, seed + 725), tcfg, ppipe, 1), began)
    if plain:
        res["phi_train_plain"] = _lm_mesh_train(
            _lm_mesh_model(pcfg, mesh, dev, seed + 725, backend="plain"),
            tcfg, ppipe, 1)
        torch.cuda.empty_cache()
    return res


def _lm_mesh_moe_report(one: dict, ranks: list, verify,
                        routing_agree) -> dict:
    """The MoE parts of the lm_mesh line: one process's results (`one`)
    against each rank's, by the bars of LM_MESH_MOE_LAYERS' note; a check
    that fails goes to `verify`."""
    import numpy as np
    from types import SimpleNamespace
    from repro_torch.configs import get_arch

    def arr(t):
        return np.asarray(t, dtype=np.float64)

    def err(a, b):
        return float(np.max(np.abs(arr(a) - arr(b))))

    def routes(calls, rows=None):
        lo, hi = rows or (None, None)
        return SimpleNamespace(calls=[{k: v[lo:hi] for k, v in c.items()}
                                      for c in calls])
    base = get_arch("olmoe-1b-7b")
    s = LM_MESH_PREFILL_S
    checks, routing = {}, {}
    # f32, 2 layers
    o = one["f32"]
    scale = max(1.0, float(np.abs(arr(o["prefill"]["logits"])).max()))
    bar = LM_MESH_F32_RTOL * scale
    checks["f32_bar"] = bar
    verify(o["tokens"]["tp"] == o["tokens"]["cp"],
           "lm_mesh moe: one process's f32 tokens, cp == tp")
    for r in ranks:
        got, name = r["paths"]["moe"], f"lm_mesh moe: rank {r['rank']}"
        e = err(got["f32"]["prefill"]["logits"], o["prefill"]["logits"])
        checks.setdefault("f32_prefill_logit_err", []).append(e)
        verify(e <= bar, f"{name}'s f32 prefill logits {e} > {bar}")
        ra = routing_agree(
            f"lm_mesh f32 prefill, rank {r['rank']} vs one process",
            base.replace(n_layers=LM_MESH_F32_LAYERS),
            routes(got["f32"]["prefill"]["routing"]),
            routes(o["prefill"]["routing"], got["f32"]["prefill"]["rows"]),
            s)
        routing.setdefault("f32", []).append(ra)
        verify(ra["flip_margin_max"] < MOE_TIE_MARGIN
               and ra["drops"] == ra["plain_drops"],
               f"{name}'s f32 routing beyond a tie or drops differ: {ra}")
        for impl, want in o["impls"].items():
            ibar = LM_MESH_F32_RTOL * max(1.0, float(np.abs(arr(want)).max()))
            e = err(got["f32"]["impls"][impl], want)
            checks.setdefault("f32_impl_err", {}).setdefault(
                impl, []).append(e)
            verify(e <= ibar, f"{name}'s f32 {impl} {e} > {ibar}")
        for mode in ("tp", "cp"):
            verify(got["f32"]["tokens"][mode] == o["tokens"]["tp"],
                   f"{name}'s f32 {mode} tokens == one process's")
    # bf16, full depth: the prefill by the spread rule, routing flips
    o = one["serve"]
    spread = err(o["prefill"]["logits"], o["prefill_plain"]["logits"])
    checks["serve_logit_spread"] = spread
    r0 = ranks[0]["paths"]["moe"]
    for r in ranks:
        got, name = r["paths"]["moe"], f"lm_mesh moe: rank {r['rank']}"
        e = err(got["serve"]["prefill"]["logits"], o["prefill"]["logits"])
        checks.setdefault("serve_prefill_logit_err", []).append(e)
        verify(e <= LM_MESH_SPREAD_X * spread,
               f"{name}'s bf16 prefill logits {e} over {LM_MESH_SPREAD_X} x "
               f"the plain spread {spread}")
        ra = routing_agree(
            f"lm_mesh bf16 prefill, rank {r['rank']} vs one process", base,
            routes(got["serve"]["prefill"]["routing"]),
            routes(o["prefill"]["routing"], got["serve"]["prefill"]["rows"]),
            s)
        routing.setdefault("bf16_flips_per_layer", []).append(ra["flips"])
        verify(got["serve"]["serve"]["tokens"]
               == r0["serve"]["serve"]["tokens"]
               and np.array_equal(arr(got["serve"]["prefill"]["logits"]),
                                  arr(r0["serve"]["prefill"]["logits"]))
               and got["train"]["metrics"] == r0["train"]["metrics"]
               and got["phi_train"]["metrics"] == r0["phi_train"]["metrics"],
               f"{name}'s MoE results == rank 0's")
    routing["bf16_one_process_kernels_vs_plain_flips_per_layer"] = \
        routing_agree("lm_mesh bf16 prefill, one process, kernels vs plain",
                      base, routes(o["prefill"]["routing"]),
                      routes(o["prefill_plain"]["routing"]), s)["flips"]
    checks["bf16_tokens_same_as_one_process"] = sum(
        a == b for a, b in zip(r0["serve"]["serve"]["tokens"],
                               o["serve"]["tokens"]))
    # phi3.5-moe's prefill by the spread rule
    o = one["phi_prefill"]
    spread = err(o["prefill"]["logits"], o["prefill_plain"]["logits"])
    e = err(r0["phi_prefill"]["prefill"]["logits"], o["prefill"]["logits"])
    checks["phi_prefill_logit_spread_err"] = [spread, e]
    verify(e <= LM_MESH_SPREAD_X * spread,
           f"lm_mesh moe: phi3.5-moe prefill logits {e} over "
           f"{LM_MESH_SPREAD_X} x the plain spread {spread}")
    # the train steps by the spread rule, f32 by the relative bar
    for key, plain in (("train", "train_plain"),
                       ("phi_train", "phi_train_plain")):
        om, pm = np.asarray(one[key]["metrics"]), \
            np.asarray(one[plain]["metrics"])
        mm = np.asarray(r0[key]["metrics"])
        for i, what in enumerate(("loss", "grad_norm")):
            sp = float(np.max(np.abs(om[:, i] - pm[:, i])))
            e = float(np.max(np.abs(mm[:, i] - om[:, i])))
            checks[f"{key}_{what}_spread_err"] = [sp, e]
            verify(e <= LM_MESH_SPREAD_X * sp,
                   f"lm_mesh moe: {key} {what} {e} over {LM_MESH_SPREAD_X} "
                   f"x the plain spread {sp}")
    f1 = np.asarray(one["train_f32"]["metrics"])
    fm = np.asarray(r0["train_f32"]["metrics"])
    checks["train_f32_rel_err_loss_gnorm"] = [
        float(np.max(np.abs(fm[:, i] - f1[:, i]) / np.abs(f1[:, i])))
        for i in range(2)]
    verify(max(checks["train_f32_rel_err_loss_gnorm"]) <= LM_MESH_F32_RTOL,
           f"lm_mesh moe: f32 loss and grad norm relative errors "
           f"{checks['train_f32_rel_err_loss_gnorm']} over "
           f"{LM_MESH_F32_RTOL}")
    # every rank launched its kernels on every part of the path
    need = {"f32": ("swiglu", "rmsnorm", "flash_attention"),
            "serve": ("swiglu", "rmsnorm", "flash_attention"),
            "train": ("swiglu", "swiglu_bwd", "rmsnorm", "rmsnorm_bwd"),
            "train_f32": ("swiglu", "swiglu_bwd"),
            "phi_prefill": ("swiglu", "flash_attention"),
            "phi_train": ("swiglu", "swiglu_bwd")}
    for r in ranks:
        for part, kernels in need.items():
            got = r["paths"]["moe"][part]["launches"]
            verify(all(got[k] > 0 for k in kernels),
                   f"lm_mesh moe: rank {r['rank']}'s {part} launched "
                   f"{kernels}: {got}")

    def row(res):
        serve = res["serve"]["serve"]
        return {
            "ms_per_decode_call_tp": 1e3 * serve["seconds"]
            / serve["decode_calls"],
            "decode_calls": serve["decode_calls"],
            "collectives_per_decode_call": serve.get("collectives"),
            "prefill_s": {k: res[k]["prefill"]["seconds"]
                          for k in ("f32", "serve", "phi_prefill")},
            "train_step_s": {k: res[k]["step_s"]
                             for k in ("train", "train_f32", "phi_train")},
            "train_collectives_per_step": res["train"].get("collectives"),
            "peak_gb": {k: res[k]["peak_bytes"] / 1e9 for k in (
                "f32", "serve", "train", "train_f32", "phi_prefill",
                "phi_train")},
            "launches": {k: res[k]["launches"] for k in (
                "f32", "serve", "train", "train_f32", "phi_prefill",
                "phi_train")},
            "seconds": {k: res[k]["seconds"] for k in (
                "f32", "serve", "train", "train_f32", "phi_prefill",
                "phi_train")}}
    return {"checks": checks, "routing": routing,
            "one_process": row(one),
            "per_rank": [{"rank": r["rank"], **row(r["paths"]["moe"])}
                         for r in ranks],
            "train_metrics": {k: {"one_process": one[k]["metrics"],
                                  "mesh": r0[k]["metrics"]}
                              for k in ("train", "train_f32", "phi_train")},
            "experts_a_rank": {"olmoe-1b-7b": 32, "phi3.5-moe": 8}}


def _lm_mesh_hybrid_report(one: dict, ranks: list, verify) -> dict:
    """The hybrid parts of the lm_mesh line: one process's results (`one`)
    against each rank's, by the bars of LM_MESH_HYB_LAYERS' note; a check
    that fails goes to `verify`."""
    import numpy as np

    def arr(t):
        return np.asarray(t, dtype=np.float64)

    def err(a, b):
        return float(np.max(np.abs(arr(a) - arr(b))))
    checks = {}
    o = one["f32"]
    spread = err(o["prefill"]["logits"], o["prefill_plain"]["logits"])
    bar = max(LM_MESH_F32_RTOL * max(1.0, float(np.abs(arr(
        o["prefill"]["logits"])).max())), LM_MESH_SPREAD_X * spread)
    checks["f32_prefill_spread_bar"] = [spread, bar]
    verify(o["tokens"]["tp"] == o["tokens"]["cp"],
           "lm_mesh hybrid: one process's f32 tokens, cp == tp")
    r0 = ranks[0]["paths"]["hybrid"]
    for r in ranks:
        got, name = r["paths"]["hybrid"], f"lm_mesh hybrid: rank {r['rank']}"
        e = err(got["f32"]["prefill"]["logits"], o["prefill"]["logits"])
        checks.setdefault("f32_prefill_logit_err", []).append(e)
        verify(e <= bar, f"{name}'s f32 prefill logits {e} > {bar}")
        for mode in ("tp", "cp"):
            verify(got["f32"]["tokens"][mode] == o["tokens"]["tp"],
                   f"{name}'s f32 {mode} tokens == one process's")
        verify(got["serve"]["serve"]["tokens"]
               == r0["serve"]["serve"]["tokens"]
               and np.array_equal(arr(got["serve"]["prefill"]["logits"]),
                                  arr(r0["serve"]["prefill"]["logits"]))
               and got["train"]["metrics"] == r0["train"]["metrics"]
               and got["train_f32"]["metrics"] == r0["train_f32"]["metrics"],
               f"{name}'s hybrid results == rank 0's")
    o = one["serve"]
    spread = err(o["prefill"]["logits"], o["prefill_plain"]["logits"])
    e = err(r0["serve"]["prefill"]["logits"], o["prefill"]["logits"])
    checks["bf16_prefill_logit_spread_err"] = [spread, e]
    verify(e <= LM_MESH_SPREAD_X * spread,
           f"lm_mesh hybrid: bf16 prefill logits {e} over "
           f"{LM_MESH_SPREAD_X} x the plain spread {spread}")
    checks["bf16_tokens_same_as_one_process"] = sum(
        a == b for a, b in zip(r0["serve"]["serve"]["tokens"],
                               o["serve"]["tokens"]))
    om, pm = np.asarray(one["train"]["metrics"]), \
        np.asarray(one["train_plain"]["metrics"])
    mm = np.asarray(r0["train"]["metrics"])
    for i, what in enumerate(("loss", "grad_norm")):
        sp = float(np.max(np.abs(om[:, i] - pm[:, i])))
        e = float(np.max(np.abs(mm[:, i] - om[:, i])))
        checks[f"train_{what}_spread_err"] = [sp, e]
        verify(e <= LM_MESH_SPREAD_X * sp,
               f"lm_mesh hybrid: train {what} {e} over {LM_MESH_SPREAD_X} "
               f"x the plain spread {sp}")
    f1 = np.asarray(one["train_f32"]["metrics"])
    fp = np.asarray(one["train_f32_plain"]["metrics"])
    fm = np.asarray(r0["train_f32"]["metrics"])
    for i, what in enumerate(("loss", "grad_norm")):
        sp = float(np.max(np.abs(f1[:, i] - fp[:, i])))
        e = float(np.max(np.abs(fm[:, i] - f1[:, i])))
        bar = max(LM_MESH_F32_RTOL * float(np.max(np.abs(f1[:, i]))),
                  LM_MESH_SPREAD_X * sp)
        checks[f"train_f32_{what}_spread_err_bar"] = [sp, e, bar]
        verify(e <= bar, f"lm_mesh hybrid: f32 train {what} {e} over "
               f"{bar} (the larger of {LM_MESH_F32_RTOL} relative and "
               f"{LM_MESH_SPREAD_X} x the plain spread {sp})")
    # every rank launched its kernels on every part of the path
    need = {"f32": ("rmsnorm", "flash_attention", "swiglu"),
            "serve": ("rmsnorm", "flash_attention", "swiglu"),
            "train": ("rmsnorm", "rmsnorm_bwd", "swiglu", "swiglu_bwd"),
            "train_f32": ("swiglu", "swiglu_bwd")}
    for r in ranks:
        for part, kernels in need.items():
            got = r["paths"]["hybrid"][part]["launches"]
            verify(all(got[k] > 0 for k in kernels),
                   f"lm_mesh hybrid: rank {r['rank']}'s {part} launched "
                   f"{kernels}: {got}")
    parts = ("f32", "train_f32", "serve", "train")

    def row(res):
        serve = res["serve"]["serve"]
        return {
            "ms_per_decode_call_tp": 1e3 * serve["seconds"]
            / serve["decode_calls"],
            "decode_calls": serve["decode_calls"],
            "collectives_per_decode_call": serve.get("collectives"),
            "launches_per_decode_call": serve["launches_per_call"],
            "prefill_s": {k: res[k]["prefill"]["seconds"]
                          for k in ("f32", "serve")},
            "train_step_s": {k: res[k]["step_s"]
                             for k in ("train", "train_f32")},
            "train_collectives_per_step": res["train"].get("collectives"),
            "peak_gb": {k: res[k]["peak_bytes"] / 1e9 for k in parts},
            "launches": {k: res[k]["launches"] for k in parts},
            "seconds": {k: res[k]["seconds"] for k in parts}}
    return {"checks": checks, "one_process": row(one),
            "per_rank": [{"rank": r["rank"], **row(r["paths"]["hybrid"])}
                         for r in ranks],
            "train_metrics": {k: {"one_process": one[k]["metrics"],
                                  "plain": one[f"{k}_plain"]["metrics"],
                                  "mesh": r0[k]["metrics"]}
                              for k in ("train", "train_f32")},
            "heads_a_rank": {"mamba2": 56, "shared_attention": 16}}


def _lm_mesh_report(one: dict, ranks: list, ranks_s: float,
                    card: str, routing_agree) -> dict:
    """The lm_mesh phase's line from one process's results (`one`) and
    each rank's: its checks, times and counts, and under "failed" every
    check that failed (the phase fails after printing it)."""
    import numpy as np

    def spread(a, b):
        return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
    failed = []

    def verify(cond, what):
        if not cond:
            failed.append(what)
    r0 = ranks[0]["paths"]
    verify(one["f32"]["tp"] == one["f32"]["cp"],
           "lm_mesh: one process's f32 tokens, cp == tp")
    logit_spread = spread(one["prefill"]["logits"],
                          one["prefill_plain_logits"])
    tm = np.asarray(one["train"]["metrics"])
    tp_ = np.asarray(one["train_plain"]["metrics"])
    train_spread = [spread(tm[:, i], tp_[:, i]) for i in range(2)]
    checks = {"logit_spread": logit_spread,
              "train_spread_loss_gnorm": train_spread}
    for r in ranks:
        got = r["paths"]
        for mode in ("tp", "cp"):
            verify(got["f32"][mode] == one["f32"]["tp"],
                   f"lm_mesh: rank {r['rank']}'s f32 {mode} tokens == "
                   "one process's")
            verify(got["serve"][mode]["tokens"]
                   == r0["serve"][mode]["tokens"],
                   f"lm_mesh: rank {r['rank']}'s bf16 {mode} tokens == "
                   "rank 0's")
        verify(np.array_equal(got["prefill"]["logits"],
                              r0["prefill"]["logits"])
               and got["train"]["metrics"] == r0["train"]["metrics"]
               and got["ef"]["metrics"] == r0["ef"]["metrics"],
               f"lm_mesh: rank {r['rank']}'s results == rank 0's")
        for k in ("flash_attention", "rmsnorm", "swiglu", "rmsnorm_bwd",
                  "swiglu_bwd"):
            verify(r["launches"][k] > 0,
                   f"lm_mesh: rank {r['rank']} launched {k}: "
                   f"{r['launches']}")
        verify(not r["plain_backward"],
               f"lm_mesh: rank {r['rank']} ran plain backward versions "
               f"{r['plain_backward']}")
        verify(r["swiglu_4864_err"] <= r["swiglu_4864_ulp"],
               f"lm_mesh: rank {r['rank']}'s swiglu at (512, 4864) "
               f"within one bf16 ulp: {r['swiglu_4864_err']}")
    err = spread(r0["prefill"]["logits"], one["prefill"]["logits"])
    checks["prefill_logit_err"] = err
    verify(err <= LM_MESH_SPREAD_X * logit_spread,
           f"lm_mesh: bf16 prefill logits {err} from one process's, "
           f"over {LM_MESH_SPREAD_X} x the plain spread {logit_spread}")
    mm = np.asarray(r0["train"]["metrics"])
    ef1, efm = np.asarray(one["ef"]["metrics"]), \
        np.asarray(r0["ef"]["metrics"])
    checks["train_err_loss_gnorm"] = [spread(mm[:, i], tm[:, i])
                                      for i in range(2)]
    checks["ef_err_loss_gnorm"] = [spread(efm[:, i], ef1[:, i])
                                   for i in range(2)]
    for what in ("train_err_loss_gnorm", "ef_err_loss_gnorm"):
        for i, name in enumerate(("loss", "grad_norm")):
            verify(checks[what][i] <= LM_MESH_SPREAD_X * train_spread[i],
                   f"lm_mesh: {what} {name} {checks[what][i]} over "
                   f"{LM_MESH_SPREAD_X} x the plain spread "
                   f"{train_spread[i]}")
    f1 = np.asarray(one["train_f32"]["metrics"])
    fm = np.asarray(r0["train_f32"]["metrics"])
    checks["train_f32_rel_err_loss_gnorm"] = [
        float(np.max(np.abs(fm[:, i] - f1[:, i]) / np.abs(f1[:, i])))
        for i in range(2)]
    verify(max(checks["train_f32_rel_err_loss_gnorm"]) <= LM_MESH_F32_RTOL,
           f"lm_mesh: f32 loss and grad norm relative errors "
           f"{checks['train_f32_rel_err_loss_gnorm']} over "
           f"{LM_MESH_F32_RTOL}")
    bf16_same = {mode: sum(a == b for a, b in zip(
        r0["serve"][mode]["tokens"], one["serve"][mode]["tokens"]))
        for mode in ("tp", "cp")}
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ("flash_attention", "rmsnorm", "swiglu",
                          "rmsnorm_bwd", "swiglu_bwd")}

    def serve_row(res):
        return {mode: {
            "seconds": res["serve"][mode]["seconds"],
            "decode_calls": res["serve"][mode]["decode_calls"],
            "ms_per_decode_call": 1e3 * res["serve"][mode]["seconds"]
            / res["serve"][mode]["decode_calls"],
            "tick_p50_ms": 1e3 * float(np.percentile(
                res["serve"][mode]["tick_s"], 50)),
            "tick_p99_ms": 1e3 * float(np.percentile(
                res["serve"][mode]["tick_s"], 99)),
            "collectives_per_decode_call":
                res["serve"][mode].get("collectives")}
            for mode in ("tp", "cp")}

    def times(res):
        return {"serve": serve_row(res),
                "prefill_s": res["prefill"]["seconds"],
                "train_step_s": res["train"]["step_s"],
                "ef_step_s": res["ef"]["step_s"],
                "train_collectives_per_step":
                    res["train"].get("collectives"),
                "serve_peak_gb": res["serve_peak_bytes"] / 1e9,
                "train_peak_gb": res["train"]["peak_bytes"] / 1e9}
    moe = _lm_mesh_moe_report(one["moe"], ranks, verify, routing_agree)
    hybrid = _lm_mesh_hybrid_report(one["hybrid"], ranks, verify)
    return {"phase": "lm_mesh", "ranks": LM_MESH_RANKS,
            "mesh": {"serve_and_train": {"data": 2, "model": 2},
                     "error_feedback": {"pod": 2, "model": 2}},
            "backend": ranks[0]["backend"], "card": card,
            "checks": checks, "bf16_tokens_same_as_one_process": bf16_same,
            "f32_tokens": one["f32"]["tp"],
            "one_process": times(one),
            "per_rank": [{"rank": r["rank"], **times(r["paths"]),
                          "launches": r["launches"],
                          "marks_s": r["marks_s"]} for r in ranks],
            "train_metrics": {"one_process": one["train"]["metrics"],
                              "plain": one["train_plain"]["metrics"],
                              "mesh": r0["train"]["metrics"],
                              "ef_one_process": one["ef"]["metrics"],
                              "ef_mesh": r0["ef"]["metrics"],
                              "f32_one_process": one["train_f32"]["metrics"],
                              "f32_mesh": r0["train_f32"]["metrics"]},
            "collectives": ranks[0]["collectives"],
            "grad_norms_step0_top": _leaf_norm_diffs(
                one["train"]["leaf_norms"], r0["train"]["leaf_norms"]),
            "moe": moe, "hybrid": hybrid, "ranks_wall_s": ranks_s,
            "launches": launches,
            "failed": failed}


def _count_collectives() -> dict:
    """Count this process's collectives by name from here on (wrapping
    `torch.distributed`'s functions, which the port calls through the
    module): all_reduce by op, all_gather, barrier."""
    import torch.distributed as dist
    calls: dict = {}
    for name in ("all_reduce", "all_gather", "barrier", "broadcast"):
        fn = getattr(dist, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            key = _name
            if _name == "all_reduce":
                op = kw.get("op", a[1] if len(a) > 1 else dist.ReduceOp.SUM)
                key = f"all_reduce_{str(op).split('.')[-1].lower()}"
            calls[key] = calls.get(key, 0) + 1
            return _fn(*a, **kw)
        setattr(dist, name, counted)
    return calls


def _lm_mesh_rank(rank: int, world: int, port: int, out_dir: str, seed: int,
                  go) -> None:
    """One rank of the lm_mesh phase: `_lm_mesh_paths` (its MoE and hybrid
    parts included) on a (data 2, model 2) mesh and a (pod 2, model 2) mesh of
    the `world` ranks sharing the card, with its kernel launches counted
    from 0 just before and read just after, its collectives counted, and
    any plain backward version recorded; then a check of the swiglu
    kernel at qwen3-4b's per-rank width (512, 4864).  Writes its results
    to out_dir/<rank>.pkl.  It imports, then waits for `go` before it
    touches the card."""
    import faulthandler
    import pickle
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import compat_mesh, init_ranks
    faulthandler.enable()
    if not go.wait(LM_MESH_TIMEOUT_S):
        raise RuntimeError("lm_mesh: the parent never started the ranks")
    t_go = time.perf_counter()
    backend = init_ranks(rank, world, f"tcp://localhost:{port}", "cuda",
                         timeout_s=LM_MESH_TIMEOUT_S)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = compat_mesh((2, 2), ("data", "model"))
    pod = compat_mesh((2, 2), ("pod", "model"))
    out = {"rank": rank, "backend": backend}
    plain_bwd = []
    saved = (ref.rmsnorm_bwd_ref, ref.swiglu_bwd_ref)

    def guard(fn):
        def counted(*a, **kw):
            plain_bwd.append(fn.__name__)
            return fn(*a, **kw)
        return counted
    ref.rmsnorm_bwd_ref, ref.swiglu_bwd_ref = map(guard, saved)
    calls = _count_collectives()
    marks = {"setup": time.perf_counter()}
    # --- the main path: counts from 0 just before, read just after ------
    ops.reset_launch_counts()
    out["paths"] = _lm_mesh_paths(mesh, pod, dev, seed, calls=calls,
                                  marks=marks)
    out["launches"] = {"flash_attention": ops.FLASH_LAUNCHES,
                       "rmsnorm": ops.RMSNORM_LAUNCHES,
                       "swiglu": ops.SWIGLU_LAUNCHES,
                       "rmsnorm_bwd": ops.RMSNORM_BWD_LAUNCHES,
                       "swiglu_bwd": ops.SWIGLU_BWD_LAUNCHES}
    # ---------------------------------------------------------------------
    ref.rmsnorm_bwd_ref, ref.swiglu_bwd_ref = saved
    out["plain_backward"] = sorted(set(plain_bwd))
    out["marks_s"] = {k: v - t_go for k, v in marks.items()}
    out["collectives"] = {
        "all_reduce SUM (f32) over model": "wo / wd / out_w partial sums "
        "and each MoE layer's output, its experts' share "
        "(reduce_from_model), copy_to_model's backward, the Mamba2 gated "
        "norm's sum of squares both ways (sum_over_model), CP decode's sum "
        "and weighted values, the vocabulary's sums of exponentials and "
        "gold logits",
        "all_reduce MAX over model": "CP decode's max, the loss's max",
        "all_gather (list form) over model": "logits over the vocabulary, "
        "CP decode's q / k / v heads, the Mamba2 input projection's "
        "columns (its backward an all-reduce SUM)",
        "all_gather (list form) over data": "logit rows; ZeRO-3 gathers of "
        "each parameter (bf16 as 16-bit words)",
        "all_reduce SUM over each data axis": "the train step's loss and "
        "gradients, one f32 buffer",
        "all_reduce MAX / SUM over each mesh axis": "error feedback's amax, "
        "the global norm",
        "counted": dict(calls)}
    g = torch.randn(512, 4864, device=dev).to(torch.bfloat16)
    u = torch.randn(512, 4864, device=dev).to(torch.bfloat16)
    got = ops.swiglu(g, u).float()
    want = ref.swiglu_ref(g, u).float()
    out["swiglu_4864_err"] = float((got - want).abs().max())
    out["swiglu_4864_ulp"] = float(want.abs().max()) * 2.0 ** -7
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()

if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        sys.exit(2)
