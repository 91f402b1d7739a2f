#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

  python3 chip_smoke.py [--phases device,build,kernels,lm_kernels,dp_paper,ofl,bp_means,fig3,retrieval,serve,invariants,cluster,ha,lm_serve]

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
single-process pass, and serves the language model qwen3-4b (prefill and
the slot engine's decode) at full width and depth.  `--phases serve` alone
trains the retrieval index first; `--phases cluster` or `ha` alone builds
the kernels first.

Every phase prints one JSON line.  The line before the last lists each
kernel with its launches on the main path, its error against the plain
version and its times; the last line is
`{"ok": true, "device": {...}}`.  Any failed check, build or launch exits
non-zero before that line.  Without a CUDA device, or run from a directory
without the repository's `src/`, it exits 1 and prints no result.
"""
from __future__ import annotations

import argparse
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
              "cluster", "ha", "lm_serve")
KERNELS = ("dpmeans_assign", "topk_stream", "topk_multiprobe_stream",
           "flash_attention", "rmsnorm", "swiglu")
SOURCES = ("dpmeans_assign", "topk_stream", "flash_attention", "rmsnorm",
           "swiglu")     # csrc/<name>.cu

# NVIDIA H100 SXM data sheet, dense: f32 outside the tensor cores, bf16 on
# the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# The paper's §4 clustering data (benchmarks/fig4_scaling.py).
DP_N = 2**20
# OFL over it opens tens of thousands of facilities: the pool's capacity.
OFL_K_MAX = 131_072
# The paper's §4 feature data for BP-means.
BP_N = 2**18
# The multi-process cluster over the paper's §4 data, cut from 2^20 points
# for time (64 epochs of Pb = 2048 over 4 worker processes); its chaos run
# and the HA run take 2^15 points (16 epochs), the telemetry check's six
# fused passes 2^14 (8 epochs).
CLUSTER_N = 2**17
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
# Distances agree to this fraction of ||x||^2 + ||c||^2: the scale of the
# expanded form's cancellation (the kernel and torch.matmul sum D products
# in different orders).
REL_TOL = 1e-5
# Requests of each kind behind the serve phase's latency percentiles.
LAT_REQUESTS = 2048
# Language-model kernels against their plain versions on the card: f32
# outputs within these multiples of max(1, max |plain|) (flash: the 2e-5
# of an f32 attention output; rmsnorm, swiglu: a few f32 ulps, both sum or
# divide in another order), bf16 outputs within one bf16 ulp at the
# output's largest magnitude (both round the same f32 value once).
LM_TOL_F32 = {"flash_attention": 2e-5, "rmsnorm": 1e-6, "swiglu": 1e-6}
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
# The full-depth engine run: 8 requests of prompt 64 on 4 slots, each to
# this many new tokens, so that the decode-tick percentiles rest on 512
# ticks.
SERVE_MAX_NEW = 256


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

    def _time(self, name, x, c, mask, cnt, sibling=False):
        """`dpmeans_assign` at one shape.  With `sibling`, `topk_stream` at
        k = 1 on the same inputs is timed beside it: the port's own kernel
        for the same function (no PyTorch call computes it)."""
        torch = self.torch
        from repro_torch.kernels.dpmeans_assign import dpmeans_assign, n_split
        from repro_torch.kernels.ref import assign_ref
        from repro_torch.kernels.topk_stream import topk_stream
        m = mask & (torch.arange(c.shape[0], device=self.dev) < cnt)
        n, d = x.shape
        active = min(int(cnt), c.shape[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        self._time_kernel(
            "dpmeans_assign", name,
            lambda: dpmeans_assign(x, c, mask, cnt),
            lambda: assign_ref(x, c, m),
            flops=2.0 * n * active * d,
            nbytes=4.0 * (n * d + active * d + 2 * n + 1) + active,
            sibling=(lambda: topk_stream(x, c, mask, cnt, 1)) if sibling
            else None,
            n=n, k=c.shape[0], d=d, count=int(cnt),
            n_split=n_split(n, c.shape[0], d, sms))

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
        for what, call in (
                ("k > 64", lambda: topk_stream(x, c, mask, cnt, 65)),
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
        for shape, k in (("serve_flat", 8), ("routing", 4)):
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
        for k in (1, 8, 64):
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
        """OCC OFL online over the paper's data: `partial_fit` in 16
        batches of 65,536 points and a `flush`, adaptive cap, the propose
        phase on `dpmeans_assign`; then the port's OFL invariants on the
        card over the first `OFL_INV_N` points."""
        torch = self.torch
        from repro_torch.core import OCCEngine, OFLTransaction
        from repro_torch.kernels import ops
        x = torch.as_tensor(self._dp_data(), device=self.dev)
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
        torch = self.torch
        import numpy as np
        from repro_torch.core import DPMeansTransaction, OCCEngine
        from repro_torch.kernels import ops
        rng = np.random.default_rng(self.seed)
        x = rng.normal(size=(110_000, 16)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        eng = OCCEngine(DPMeansTransaction(0.05, k_max=131_072), pb=256,
                        validate_cap="adaptive", device="cuda")
        xt = torch.as_tensor(x, device=self.dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        eng.partial_fit(xt)
        eng.flush()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ops.ASSIGN_LAUNCHES
        self.retrieval_launches = launches
        k = int(eng.pool.count)
        self.index = (x, eng.pool)
        check(k >= 100_000, f"retrieval: K={k} >= 100000")
        check(not bool(eng.pool.overflow), "retrieval: no overflow")
        check(launches == eng.n_epochs_dispatched and launches > 0,
              "retrieval: one kernel launch per epoch")
        replayed = self._replay_kernel(xt, 256, eng.pool, 0,
                                       eng.stats.accepted, seconds)
        emit({"phase": "retrieval", "n": x.shape[0], "d": 16, "lam": 0.05,
              "k_max": 131_072, "pb": 256, "K": k,
              "epochs": eng.epochs_done, "seconds": seconds,
              "assign_launches": launches,
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

    def _time_multiprobe(self, xb, h, probes, topk):
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
            "topk_multiprobe_stream", "serve_multiprobe",
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
        x_np = self._dp_data()[:65536]
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
                 ((0, 1000), (1000, 30001), (30001, 47777), (47777, 65536))]
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
        else:
            tol = 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)
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
                for shape in ((16384, 2560), (4, 2560), (2, 3, 2560),
                              (7, 33)):
                    x, w = randn(shape, dt), randn(shape[-1:], dt)
                    self._lm_agree("rmsnorm", f"{tag} {shape}",
                                   rmsnorm(x, w, 1e-6),
                                   ref.rmsnorm_ref(x, w, 1e-6))
                for shape in ((16384, 9728), (4, 9728), (5, 17)):
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

    def _rmsnorm_f16(self):
        """rmsnorm on float16 against its plain version: within 1e-2 (the
        reference's f16 bar) at a dense width (16384, 2560, the one-read
        kernel), at decode (4, 2560) and at a width of the two-pass kernel
        (7, 33).  Weights near 1, as a trained norm's are, keep the outputs
        below 8, where one f16 ulp is under the bar."""
        torch = self.torch
        from repro_torch.kernels import ref
        from repro_torch.kernels.rmsnorm import rmsnorm_launch
        g = torch.Generator(device=self.dev).manual_seed(self.seed + 310)
        with torch.inference_mode():
            for shape in ((16384, 2560), (4, 2560), (7, 33)):
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
        Dh of HEAD_DIMS, causal and full, GQA groups 1 and 4, S = 16, 48,
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
                    for group in (1, 4):
                        for s in (16, 48, 128, 384):
                            for layout in ("contiguous", "transposed"):
                                worst = max(worst, case(dh, causal, group, s,
                                                        layout))
                                n += 1
                emit({"phase": "lm_kernels", "kernel": "flash_attention",
                      "sweep_dh": dh, "cases": 32,
                      "worst_err_over_tol": worst[0], "worst_case": worst[1]})
            worst = (0.0, "")
            tights = []
            for causal in (True, False):
                for group in (1, 4):
                    for layout in ("contiguous", "transposed"):
                        worst = max(worst, case(128, causal, group, 4096,
                                                layout, b=1, h=8, tight=True))
                        n += 1
            emit({"phase": "lm_kernels", "kernel": "flash_attention",
                  "sweep_dh": 128, "s": 4096, "cases": 8,
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
        rmsnorm libraries (from the build log), and the flash library's
        SASS: the tensor-core kernel must contain wgmma (HGMMA) and TMA
        loads (UTMALDG), else the phase fails."""
        from repro_torch.kernels import _build
        paths = _build.build_all(["flash_attention", "rmsnorm"])
        res = {}
        for name in ("flash_attention", "rmsnorm"):
            res[name] = _ptxas_summary(
                _build.BUILD_LOG.get(name, {}).get("ptxas", ""))
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

    def _lm_counts(self):
        from repro_torch.kernels import ops
        return {"flash_attention": ops.FLASH_LAUNCHES,
                "rmsnorm": ops.RMSNORM_LAUNCHES,
                "rmsnorm_one_read": ops.RMSNORM_ONE_READ_LAUNCHES,
                "swiglu": ops.SWIGLU_LAUNCHES}

    def lm_serve(self):
        """qwen3-4b served by the port: at full width and 2 layers in f32,
        the kernels against the plain versions (prefill logits, and greedy
        tokens of a ServeEngine run); at full width and depth in bf16,
        prefill (B 4, S 4096) and a ServeEngine run (8 requests, prompt 64,
        SERVE_MAX_NEW new tokens each, 4 slots, cache 1024) with exact
        launch counts, their times and the device's idle share over a warm
        decode step; then its last-token logits against the plain versions'
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
        reqs = [Request(uid=i, prompt=rng.integers(0, vocab, 64),
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
            "requests": 8, "prompt": 64, "max_new": SERVE_MAX_NEW, "slots": 4,
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

    def _bf16_logits_agree(self, case, got, want) -> dict:
        """Full-depth bf16 logits of two routes agree within BF16_LOGIT_TOL
        of max |want|."""
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        tol = BF16_LOGIT_TOL * scale
        check(got.shape == want.shape and bool(self.torch.isfinite(got).all())
              and err <= tol,
              f"lm_serve bf16 {case}: max abs diff {err} > {tol}")
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

    def kernel_rows(self) -> list[dict]:
        """One row per kernel: launches on its main path, largest error
        against its plain version, and its times at the shape its main
        path gives it (dpmeans_assign: the paper's propose shape; top-k:
        the serving microbatch; the language-model kernels: qwen3-4b's
        prefill), with every timed shape under "shapes".  The language
        model's launches are those of its prefill plus its engine run."""
        rows = []
        main_shape = {"dpmeans_assign": "paper", "topk_stream": "serve_flat",
                      "topk_multiprobe_stream": "serve_multiprobe",
                      "flash_attention": "prefill", "rmsnorm": "prefill",
                      "swiglu": "prefill"}
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
                   "swiglu": ("swiglu.cu", "src/repro/kernels/swiglu.py:24")}
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
            if name in ("flash_attention", "rmsnorm", "swiglu"):
                row["launches_by_path"] = {
                    path: c[name] for path, c in self.lm_launches.items()}
            if name == "rmsnorm" and self.lm_launches:
                row["launches_one_read"] = sum(
                    c["rmsnorm_one_read"] for c in self.lm_launches.values())
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


def _device_events(prof) -> list[tuple[str, float, int]]:
    """(name, device microseconds, count) of each kind of work the device
    ran in a profile: its kernels and copies only.  The host-side event
    that launched a kernel reports the same device time as the kernel, so
    summing over every event would count each kernel twice."""
    from torch.autograd import DeviceType
    out = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0)) or 0.0
        if dt > 0:
            out.append((ev.key, dt, ev.count))
    return out


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


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        sys.exit(2)
