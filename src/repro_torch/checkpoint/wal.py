"""Durable write-ahead log for the delta publication stream (§14).

The port's copy of `repro/checkpoint/wal.py`: the same segment records
(wire frames + crc32) and checkpoint images, so a log written by either
package is recovered by the other.  Recovered and shadow stores live on
the device the caller gives (the card unless the caller asks for the CPU).

`DeltaWAL` sits on a store's `wire` seam — the same seam the socket
transport uses — and makes the `CenterDelta` stream the durable source of
truth:

  * every published delta is appended to the current WAL segment as an
    encoded DELTA frame (`protocol.delta_frame` — the SAME bytes that go
    on the socket, so the one codec and its golden fixture also pin the
    on-disk format) plus a crc32 trailer over the frame bytes, flushed
    (+ fsync by default) before `send` returns: a delta the trainer
    believes published survives a crash, and a record that only LOOKS
    complete (torn payload later overwritten by unrelated bytes) is
    caught by the checksum, not replayed as corrupt state;
  * every `checkpoint_every` versions the WAL's internal shadow store is
    checkpointed through `CheckpointManager` (atomic tmp+rename, keep-k
    GC) as a full-prefix rebase image, and the log rotates to a fresh
    segment — replay work after a crash is bounded by one interval;
  * `recover()` rebuilds a store bit-identically: restore the newest
    checkpoint as a rebase delta, then replay segment frames with newer
    versions, in order, through the ordinary `apply_delta` path.  A torn
    tail — a partial frame from a crash mid-append — is detected by the
    frame header/length check and cleanly ends replay (the torn delta was
    never acknowledged, so losing it is correct).

`WireTee` fans one store's publishes to several wires (e.g. a
`ReplicationServer` for followers AND a `DeltaWAL` for durability) — the
wire seam is duck-typed on `send`, so any combination composes.

Resume is then `OCCEngine.restore(store.latest(), k_max=...)` plus
re-feeding the points after `n_seen` — bit-identical to the uninterrupted
run (pinned in tests/test_torch_checkpoint.py).
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.protocol import (
    DELTA, MAGIC, PROTOCOL_VERSION, decode_frame, delta_frame, frame_delta)
from repro_torch.obs import Obs
from repro_torch.obs.metrics import now as _now
from repro_torch.serving.snapshot import CenterDelta, SnapshotStore

__all__ = ["DeltaWAL", "WireTee", "recover_wal"]

_HEADER = struct.Struct("!4sBBI")


class WireTee:
    """Fan one publish stream out to several wires, in order."""

    def __init__(self, *wires: Any):
        self.wires = tuple(wires)

    def send(self, delta: CenterDelta) -> None:
        for w in self.wires:
            w.send(delta)

    def close(self) -> None:
        for w in self.wires:
            close = getattr(w, "close", None)
            if close is not None:
                close()


class DeltaWAL:
    """Append-only delta log + periodic full checkpoints in `directory`.

    Layout:
      directory/ckpt/step_XXXXXXXX/   CheckpointManager images (rows +
                                      delta metadata in `extra`)
      directory/seg_XXXXXXXX.log      frame log; the suffix is the
                                      checkpoint version the segment
                                      starts after (first = 0)

    `fsync=False` trades durability-to-media for speed (data still
    reaches the OS on every append) — the recovery *logic* is identical,
    so tests and benchmarks may disable it.
    """

    def __init__(self, directory: str, model: str | None = None,
                 checkpoint_every: int = 8, keep: int = 3,
                 fsync: bool = True, shadow_capacity: int = 4,
                 obs: Obs | None = None,
                 device: str | torch.device = "cuda"):
        self.dir = directory
        self.model = model
        self.checkpoint_every = checkpoint_every
        self.fsync = fsync
        self.obs = obs if obs is not None else Obs()
        m = self.obs.metrics
        self._c_appended = m.counter("wal_appends")
        self._c_bytes = m.counter("wal_bytes_appended")
        self._c_checkpoints = m.counter("wal_checkpoints")
        self._c_rotations = m.counter("wal_segment_rotations")
        self._h_append = m.histogram("wal_append_s")
        self._h_fsync = m.histogram("wal_fsync_s")
        os.makedirs(directory, exist_ok=True)
        self.ckpt = CheckpointManager(os.path.join(directory, "ckpt"),
                                      keep=keep)
        # the shadow folds every delta so a checkpoint is always one
        # bootstrap_delta away — same trick as the ReplicationServer
        self._shadow = SnapshotStore(capacity=shadow_capacity, delta=True,
                                     model=model, device=device)
        steps = self.ckpt.all_steps()
        self._seg_base = steps[-1] if steps else 0
        self._seg = open(self._seg_path(self._seg_base), "ab")

    def _seg_path(self, base: int) -> str:
        return os.path.join(self.dir, f"seg_{base:08d}.log")

    # ------------------------------------------------------------- the wire

    @property
    def n_appended(self) -> int:
        return int(self._c_appended.value)

    @property
    def n_checkpoints(self) -> int:
        return int(self._c_checkpoints.value)

    @property
    def bytes_appended(self) -> int:
        return int(self._c_bytes.value)

    def send(self, delta: CenterDelta) -> None:
        t0 = _now()
        with self.obs.span("wal.append", cat="wal", version=delta.version):
            if delta.model != self.model:
                raise ValueError(f"WAL for {self.model!r} got a delta for "
                                 f"{delta.model!r}")
            self._shadow.apply_delta(delta)
            frame = delta_frame(delta)
            record = frame + struct.pack("!I", zlib.crc32(frame))
            self._seg.write(record)
            self._seg.flush()
            if self.fsync:
                tf = _now()
                os.fsync(self._seg.fileno())
                self._h_fsync.observe(_now() - tf)
            self._c_appended.inc()
            self._c_bytes.inc(len(record))
        self._h_append.observe(_now() - t0)
        if (self.checkpoint_every
                and delta.version % self.checkpoint_every == 0):
            self._checkpoint(delta.version)

    def _checkpoint(self, version: int) -> None:
        boot = self._shadow.bootstrap_delta()
        meta = dict(model=boot.model, version=boot.version, count=boot.count,
                    capacity=boot.capacity, n_seen=boot.n_seen,
                    epochs=boot.epochs, overflow=bool(boot.overflow),
                    objective=boot.objective, cap_est=boot.cap_est,
                    cap_trace=None if boot.cap_trace is None
                    else list(boot.cap_trace))
        with self.obs.span("wal.checkpoint", cat="wal", version=version):
            self.ckpt.save(version, {"rows": np.asarray(boot.rows)},
                           extra=meta)
            self._c_checkpoints.inc()
            # rotate: later frames land in a fresh segment keyed to this
            # image
            self._seg.close()
            self._seg = open(self._seg_path(version), "ab")
            self._seg_base = version
            self._c_rotations.inc()
            self._gc_segments()

    def _gc_segments(self) -> None:
        """Segments entirely covered by the oldest KEPT checkpoint are
        dead: every frame in seg_B holds versions <= some later kept
        image whenever B < oldest kept step."""
        steps = self.ckpt.all_steps()
        if not steps:
            return
        oldest = steps[0]
        for base in self.segment_bases():
            if base < oldest and base != self._seg_base:
                try:
                    os.remove(self._seg_path(base))
                except OSError:
                    pass

    def segment_bases(self) -> list[int]:
        return _segment_bases(self.dir)

    def sync(self) -> None:
        self._seg.flush()
        os.fsync(self._seg.fileno())

    def close(self) -> None:
        try:
            self._seg.flush()
            self._seg.close()
        except OSError:
            pass


def _segment_bases(directory: str) -> list[int]:
    out = []
    for fn in os.listdir(directory):
        if fn.startswith("seg_") and fn.endswith(".log"):
            try:
                out.append(int(fn[4:-4]))
            except ValueError:
                pass
    return sorted(out)


def _iter_segment_frames(path: str):
    """Decoded (meta, arrays) for each complete DELTA record in a segment.
    A torn tail — header, payload or crc trailer cut short by a crash
    mid-append, a header that does not parse, or a crc mismatch (a torn
    payload later padded by unrelated bytes) — ends iteration cleanly at
    the last intact record."""
    with open(path, "rb") as f:
        buf = f.read()
    off = 0
    while off + _HEADER.size <= len(buf):
        magic, ver, ftype, plen = _HEADER.unpack_from(buf, off)
        if magic != MAGIC or ver != PROTOCOL_VERSION:
            return              # torn/corrupt header: stop at last good frame
        end = off + _HEADER.size + plen
        if end + 4 > len(buf):
            return              # torn payload or missing crc trailer
        frame = buf[off:end]
        (crc,) = struct.unpack_from("!I", buf, end)
        if crc != zlib.crc32(frame):
            return              # payload bytes are not what was appended
        ft, meta, arrays = decode_frame(frame)
        if ft == DELTA:
            yield meta, arrays
        off = end + 4


def recover_wal(directory: str, model: str | None = None,
                capacity: int = 16, obs: Obs | None = None,
                device: str | torch.device = "cuda"
                ) -> tuple[SnapshotStore, dict]:
    """Rebuild a delta store from a `DeltaWAL` directory.

    Newest checkpoint image (if any) applies first as a rebase delta, then
    every logged frame with a newer version replays through `apply_delta`
    in version order.  Returns (store, info) where info reports
    `ckpt_version` (0 = no checkpoint), `n_replayed`, and `n_skipped`
    (frames already covered by the checkpoint).  The store lives on
    `device`."""
    obs = obs if obs is not None else Obs()
    t0 = _now()
    store = SnapshotStore(capacity=capacity, delta=True, model=model,
                          device=device)
    ckpt = CheckpointManager(os.path.join(directory, "ckpt"))
    step = ckpt.latest_step()
    if step is not None:
        manifest = ckpt.manifest(step)
        _, tree = ckpt.restore({"rows": np.zeros(0)}, step=step,
                               device="cpu")
        extra = manifest["extra"]
        ct = extra.get("cap_trace")
        rows = tree["rows"].numpy().astype(np.float32, copy=False)
        boot = CenterDelta(
            model=extra["model"], version=extra["version"], start=0,
            rows=rows, count=extra["count"], capacity=extra["capacity"],
            rebase=True, n_seen=extra["n_seen"], epochs=extra["epochs"],
            overflow=bool(extra["overflow"]), objective=extra["objective"],
            cap_est=extra["cap_est"],
            cap_trace=None if ct is None else tuple(ct))
        store.apply_delta(boot)
    n_replayed = n_skipped = 0
    for base in _segment_bases(directory):
        for meta, arrays in _iter_segment_frames(
                os.path.join(directory, f"seg_{base:08d}.log")):
            delta = frame_delta(meta, arrays)
            latest = store.latest_meta()
            if latest is not None and delta.version <= latest.version:
                n_skipped += 1
                continue
            store.apply_delta(delta)
            n_replayed += 1
    dur = _now() - t0
    obs.metrics.histogram("wal_recover_s").observe(dur)
    obs.metrics.counter("wal_frames_replayed").inc(n_replayed)
    if obs.tracer is not None:
        obs.tracer.complete("wal.recover", t0 * 1e6, dur * 1e6, cat="wal",
                            args=dict(ckpt_version=step or 0,
                                      n_replayed=n_replayed,
                                      n_skipped=n_skipped))
    return store, dict(ckpt_version=step or 0, n_replayed=n_replayed,
                       n_skipped=n_skipped)
