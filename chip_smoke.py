#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

  python3 chip_smoke.py [--phases device,build,kernels,dp_paper,retrieval,serve,invariants]

Run from the root of a checkout on a machine with a CUDA card.  It builds
the hand-written kernels from `src/repro_torch/kernels/csrc/` with nvcc
(one process per source, in parallel), holds each against its plain
PyTorch version on the card, runs the OCC DP-means pass of the paper's §4
experiment and the repository's largest state (a 110k-center retrieval
index) through the port's public entry points, serves that index (flat
and multi-probe top-k, score) through the port's serving plane, and checks
the port's bitwise invariants on the card.  `--phases serve` alone trains
the retrieval index first.

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
import os
import statistics
import subprocess
import sys
import time

ALL_PHASES = ("device", "build", "kernels", "dp_paper", "retrieval", "serve",
              "invariants")
KERNELS = ("dpmeans_assign", "topk_stream", "topk_multiprobe_stream")
SOURCES = ("dpmeans_assign", "topk_stream")     # csrc/<name>.cu

# NVIDIA H100 SXM data sheet, dense: f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# The paper's §4 clustering data (benchmarks/fig4_scaling.py).
DP_N = 2**20
# Distances agree to this fraction of ||x||^2 + ||c||^2: the scale of the
# expanded form's cancellation (the kernel and torch.matmul sum D products
# in different orders).
REL_TOL = 1e-5
# Requests of each kind behind the serve phase's latency percentiles.
LAT_REQUESTS = 2048


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
    def _inputs(self, n, k, d, count, holes=False, dup=False, seed=0):
        torch = self.torch
        g = torch.Generator(device=self.dev).manual_seed(seed)
        x = torch.randn((n, d), generator=g, device=self.dev)
        c = torch.randn((k, d), generator=g, device=self.dev)
        if dup:
            # every center appears twice at (i, i + k/2): ties everywhere
            c[k // 2:] = c[:k - k // 2]
        mask = torch.arange(k, device=self.dev) < count
        if holes:
            mask &= torch.rand((k,), generator=g, device=self.dev) > 0.3
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

    def _time(self, name, x, c, mask, cnt):
        torch = self.torch
        from repro_torch.kernels.dpmeans_assign import dpmeans_assign
        from repro_torch.kernels.ref import assign_ref
        m = mask & (torch.arange(c.shape[0], device=self.dev) < cnt)
        n, d = x.shape
        active = min(int(cnt), c.shape[0])
        self._time_kernel(
            "dpmeans_assign", name,
            lambda: dpmeans_assign(x, c, mask, cnt),
            lambda: assign_ref(x, c, m),
            flops=2.0 * n * active * d,
            nbytes=4.0 * (n * d + active * d + 2 * n + 1) + active,
            n=n, k=c.shape[0], d=d, count=int(cnt))

    def _time_kernel(self, kernel_name, shape, kernel, plain, *, flops,
                     nbytes, **meta):
        """Device time of a kernel and of its plain version at one shape,
        beside the bound: the larger of its operations at the f32 peak and
        its bytes (each input read once, each output written once) at the
        memory rate.  The plain version is timed as a CUDA graph replay, so
        its time is the card's, not its host launch path's.  No single
        PyTorch call computes these functions, so library_ms is None."""
        torch = self.torch
        k_ms, k_ahead = _queued_ms(torch, kernel)
        p_ms, p_ahead = _graph_ms(torch, plain)
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        row = {"kernel": kernel_name, "shape": shape, **meta,
               "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "flops": flops, "bytes": nbytes, "library_ms": None,
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
            ("retrieval", dict(n=256, k=131072, d=16, count=110000)),
            ("one_row", dict(n=1, k=131072, d=16, count=5)),
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
        (_, c, _, _), (_, ik) = outs["duplicates"]
        check(bool((ik < c.shape[0] - c.shape[0] // 2).all()),
              "duplicates: lowest index wins")
        # count 0: everything (inf, -1)
        _, (d2z, iz) = outs["count0"]
        check(bool(torch.isinf(d2z).all()) and bool((iz == -1).all()),
              "count0: (inf, -1)")
        # Row independence: each row alone, and the batch reversed, give the
        # same bits as the batch.
        (x, c, mask, cnt), (d2b, ib) = outs["paper"]
        alone = [dpmeans_assign(x[r:r + 1].contiguous(), c, mask, cnt)
                 for r in range(x.shape[0])]
        d2a = torch.cat([a[0] for a in alone])
        ia = torch.cat([a[1] for a in alone])
        rev = torch.flip(x, [0]).contiguous()
        d2r, ir = dpmeans_assign(rev, c, mask, cnt)
        check(torch.equal(d2a, d2b) and torch.equal(ia, ib),
              "row independence: rows alone == batch, bitwise")
        check(torch.equal(torch.flip(d2r, [0]), d2b)
              and torch.equal(torch.flip(ir, [0]), ib),
              "row independence: reversed batch == batch, bitwise")
        # What the wrapper refuses.
        for what, call in (
                ("f64 input", lambda: dpmeans_assign(x.double(), c, mask, cnt)),
                ("int64 count", lambda: dpmeans_assign(x, c, mask, cnt.long())),
                ("cpu tensor on the cuda backend",
                 lambda: ops.assign(x.cpu(), c.cpu(), backend="cuda"))):
            try:
                call()
            except (TypeError, ValueError):
                continue
            raise CheckFailed(f"{what} must raise")
        emit({"phase": "kernels", "row_independence": True, "raises": True,
              "max_abs_err": self.max_abs_err["dpmeans_assign"]})
        self._time("paper", *outs["paper"][0])
        self._time("retrieval", *outs["retrieval"][0])
        self._topk_kernels()
        self._multiprobe_kernels()

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
        ]
        outs = {}
        for i, (name, kw, k) in enumerate(cases):
            x, c, mask, cnt = self._inputs(seed=self.seed + 100 + i, **kw)
            if name == "nan_tail":
                c[kw["count"]:] = torch.nan
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
        emit({"phase": "kernels", "kernel": "topk_stream",
              "top1_eq_assign": True, "row_independence": True,
              "raises": True, "max_abs_err": self.max_abs_err["topk_stream"]})
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
        share = self._kernel_share(eng, x, pool, passes[-1]["seconds"])
        emit({"phase": "dp_paper", "n": x.shape[0], "d": x.shape[1],
              "lam": 4.0, "k_max": 512, "pb": 2048,
              "validate_cap": "adaptive", "K": k, "J": j,
              "passes": passes, "assign_launches": launches,
              "n_dispatches": eng.n_dispatches,
              "n_cap_retries": eng.n_cap_retries, **share})

    def _kernel_share(self, eng, x, pool, pass_s: float) -> dict:
        """Device time by kernel over one more warm pass like the last one,
        from torch.profiler (after the main path's counts were read).  The
        profiler slows the host several times over, so shares are taken
        against `pass_s`, the same pass's unprofiled wall time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.run(x, pool=pool)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tot = kern = 0.0
        n_kern = 0
        for ev in prof.key_averages():
            dt = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0)) or 0.0
            if dt <= 0:
                continue
            tot += dt
            if "dpmeans_assign" in ev.key:
                kern += dt
                n_kern += ev.count
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
                                         device=self.dev))
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
        microbatch, p probes, over the union the index gives it."""
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
        rows = int(h.fine_mask[union[:used].long()].sum())
        self._time_kernel(
            "topk_multiprobe_stream", "serve_multiprobe",
            lambda: topk_multiprobe_stream(xb, h.fine, h.fine_ids,
                                           h.fine_mask, union, member, uc,
                                           topk),
            lambda: topk_multiprobe_ref(xb, h.fine, h.fine_ids, h.fine_mask,
                                        union, member, topk),
            flops=2.0 * b * rows * d,
            nbytes=(4.0 * (b * d + rows * d + rows + used + 1
                           + 2 * b * topk) + rows + b * used),
            n=b, d=d, probes=probes, u_count=used, u_cap=u_cap,
            candidate_rows=rows, shard_cap=h.shard_cap, topk=topk)

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

        def same(a, b):
            # results, pools and the sent / accepted counts; not the caps,
            # which differ by design between cap settings
            la, lb = _leaves(a), _leaves(b)
            return len(la) == len(lb) and all(
                torch.equal(u, v) for u, v in zip(la, lb))

        t0 = time.perf_counter()
        full, _ = two_passes()
        again, _ = two_passes()
        adaptive, eng_a = two_passes(validate_cap="adaptive")
        logd, _ = two_passes(scan_mode="logdepth")
        res = {"determinism": same(full, again),
               "adaptive_eq_full": same(full, adaptive),
               "logdepth_eq_serial": same(full, logd),
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
            and same(eng_s.pool, r1.pool)
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
            torch.equal(sz, r4.assign[pt]) and same(spool, r4.pool)
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

    def kernel_rows(self) -> list[dict]:
        """One row per kernel: launches on its main path, largest error
        against its plain version, and its times at the shape its main
        path gives it (dpmeans_assign: the paper's propose shape; top-k:
        the serving microbatch), with every timed shape under "shapes"."""
        rows = []
        main_shape = {"dpmeans_assign": "paper", "topk_stream": "serve_flat",
                      "topk_multiprobe_stream": "serve_multiprobe"}
        sources = {"dpmeans_assign": ("dpmeans_assign.cu",
                                      "src/repro/kernels/dpmeans_assign.py:86"),
                   "topk_stream": ("topk_stream.cu",
                                   "src/repro/kernels/topk_stream.py:123"),
                   "topk_multiprobe_stream": (
                       "topk_stream.cu",
                       "src/repro/kernels/topk_stream.py:295")}
        for name in KERNELS:
            src, replaces = sources[name]
            row = {"name": name, "route": "cuda", "card": self.card,
                   "source": f"src/repro_torch/kernels/csrc/{src}",
                   "replaces": replaces,
                   "launches": self.main_launches[name],
                   "max_abs_err": self.max_abs_err[name]}
            if name == "dpmeans_assign":
                row["launches_retrieval"] = self.retrieval_launches
            shapes = [t for t in self.timings if t["kernel"] == name]
            main = next((t for t in shapes
                         if t["shape"] == main_shape[name]), None)
            for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms"):
                row[key] = None if main is None else main[key]
            row["shapes"] = shapes
            rows.append(row)
        return rows


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
