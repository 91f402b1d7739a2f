#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

  python3 chip_smoke.py [--phases device,build,kernels,dp_paper,retrieval,invariants]

Run from the root of a checkout on a machine with a CUDA card.  It builds
the hand-written kernel from `src/repro_torch/kernels/csrc/` with nvcc,
holds it against its plain PyTorch version on the card, runs the OCC
DP-means pass of the paper's §4 experiment and the repository's largest
state (a 110k-center retrieval index) through the port's public entry
points, and checks the port's bitwise invariants on the card.

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

ALL_PHASES = ("device", "build", "kernels", "dp_paper", "retrieval",
              "invariants")

# NVIDIA H100 SXM data sheet, dense: f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# The paper's §4 clustering data (benchmarks/fig4_scaling.py).
DP_N = 2**20
# Distances agree to this fraction of ||x||^2 + ||c||^2: the scale of the
# expanded form's cancellation (the kernel and torch.matmul sum D products
# in different orders).
REL_TOL = 1e-5


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
        self.max_abs_err = 0.0
        self.timings: list[dict] = []
        self.main_launches: int | None = None
        self.retrieval_launches: int | None = None
        self.dp_x = None

    # ------------------------------------------------------------ device
    def device(self):
        torch = self.torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
        print(line, flush=True)
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
        path = _build.build("dpmeans_assign")
        _build.load("dpmeans_assign")
        seconds = time.perf_counter() - t0
        log = _build.BUILD_LOG.get("dpmeans_assign", {})
        emit({"phase": "build", "seconds": seconds, "library": str(path),
              "nvcc": _build.nvcc_path(), "flags": list(_build.NVCC_FLAGS),
              "ptxas": log.get("ptxas", "")})

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
        self.max_abs_err = max(self.max_abs_err, float(err.max()) if
                               err.numel() else 0.0)
        emit({"phase": "kernels", "case": name, "n": x.shape[0],
              "k": c.shape[0], "d": x.shape[1], "count": int(cnt),
              "max_abs_err": float(err.max()) if err.numel() else 0.0,
              "index_mismatches": int(mism.sum()), "near_tie_rows": n_near})
        return d2k, ik

    def _time(self, name, x, c, mask, cnt):
        torch = self.torch
        from repro_torch.kernels.dpmeans_assign import dpmeans_assign
        from repro_torch.kernels.ref import assign_ref
        kernel = lambda: dpmeans_assign(x, c, mask, cnt)
        m = mask & (torch.arange(c.shape[0], device=self.dev) < cnt)
        plain = lambda: assign_ref(x, c, m)
        (k_ms, k_ahead), (p_ms, p_ahead) = (_queued_ms(torch, kernel),
                                            _queued_ms(torch, plain))
        n, d = x.shape
        active = min(int(cnt), c.shape[0])
        flops = 2.0 * n * active * d
        nbytes = 4.0 * (n * d + active * d + 2 * n + 1) + active
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        row = {"shape": name, "n": n, "k": c.shape[0], "d": d,
               "count": int(cnt), "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "flops": flops, "bytes": nbytes, "library_ms": None,
               "queued_ahead": k_ahead and p_ahead,
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
              "max_abs_err": self.max_abs_err})
        self._time("paper", *outs["paper"][0])
        self._time("retrieval", *outs["retrieval"][0])

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
        self.main_launches = launches
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
        row = {"name": "dpmeans_assign", "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/dpmeans_assign.cu",
               "replaces": "src/repro/kernels/dpmeans_assign.py:86",
               "launches": self.main_launches,
               "launches_retrieval": self.retrieval_launches,
               "max_abs_err": self.max_abs_err}
        paper = next((t for t in self.timings if t["shape"] == "paper"), None)
        for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms"):
            row[key] = None if paper is None else paper[key]
        row["shapes"] = self.timings
        return [row]


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
