"""The OCC wire protocol: length-prefixed frames over a byte stream (§13).

The port's copy of `repro/distributed/protocol.py`, byte for byte the same
format (`tests/golden/transport_frames.bin` pins both).  Frames take numpy
arrays: a tensor crosses this seam as `.cpu().numpy()`.

One frame format carries BOTH planes of the multi-process system:

  replication plane (master → follower, follower → master):
    HELLO     follower/worker introduces itself (role, model, have_version)
    SNAPSHOT  full-prefix bootstrap: a rebase `CenterDelta` spanning
              [0, count) — a late joiner applies it through the SAME
              `SnapshotStore.apply_delta` path as any other delta and is
              then bit-identical to the primary (bootstrap state machine,
              DESIGN.md §13)
    DELTA     one publish: the `CenterDelta` tuple, rows as raw f32 bytes
    ACK       follower has durably applied `version` (per-follower ack;
              the server's commit watermark is the min over followers)
    FIN       orderly shutdown (reason string)

  training plane (master ↔ worker, §13 worker/master epoch protocol):
    STEP      master starts epoch e: workers propose on their shard
    PROPOSE   worker w's proposal block for epoch e — the flattened leaves
              of `txn.propose` on its shard, concatenated master-side in
              worker order (== global index order)

  control plane (crash recovery / promotion, §14):
    CTRL      one coordinator/HA control message: an `op` string plus
              op-specific scalar fields (who-is-master, orphaned-watermark
              reports, PROMOTE/FOLLOW directives, per-epoch output digests)

Term fencing (§14): HELLO, STEP, DELTA and SNAPSHOT frames carry the
sender's `term` — the promotion epoch, bumped by every master handover.  A
receiver that has seen term t rejects frames with term < t, so a zombie
master that missed its own demotion cannot corrupt workers or followers;
a server receiving a HELLO with a NEWER term than its own knows it is the
zombie and must fence itself off.

Framing: a fixed 10-byte header `!4sBBI` (magic, protocol version, frame
type, payload length) followed by the payload: `!I` metadata length, the
metadata as canonical JSON (sorted keys, no whitespace — byte-stable so
the golden fixture test can pin the format), then each declared array's
raw C-order bytes in declaration order.  Every multi-byte integer on the
wire is big-endian; array bytes are little-endian (numpy '<' dtypes are
declared explicitly in the metadata).  Non-finite floats are not
representable in JSON and are encoded as null (None).

The codec is pure bytes↔values — no sockets in this module — so the
golden wire-format tests pin it without any I/O.
"""
from __future__ import annotations

import json
import math
import socket
import struct

import numpy as np

from repro_torch.serving.snapshot import CenterDelta

__all__ = [
    "HELLO", "SNAPSHOT", "DELTA", "ACK", "FIN", "STEP", "PROPOSE", "CTRL",
    "FRAME_NAMES", "PROTOCOL_VERSION", "encode_frame", "decode_frame",
    "read_frame", "write_frame", "delta_frame", "frame_delta", "hello_frame",
    "ack_frame", "fin_frame", "step_frame", "propose_frame", "ctrl_frame",
]

MAGIC = b"OCC1"
# v2: HELLO/STEP/DELTA/SNAPSHOT carry `term` (promotion fencing, §14) and
# the CTRL frame type joins the family.  Golden fixture regenerated.
PROTOCOL_VERSION = 2
_HEADER = struct.Struct("!4sBBI")   # magic, proto version, frame type, len

HELLO, SNAPSHOT, DELTA, ACK, FIN, STEP, PROPOSE, CTRL = range(1, 9)
FRAME_NAMES = {HELLO: "HELLO", SNAPSHOT: "SNAPSHOT", DELTA: "DELTA",
               ACK: "ACK", FIN: "FIN", STEP: "STEP", PROPOSE: "PROPOSE",
               CTRL: "CTRL"}


def _canonical_json(meta: dict) -> bytes:
    return json.dumps(meta, sort_keys=True, separators=(",", ":"),
                      allow_nan=False).encode("utf-8")


def _json_scalar(v):
    """JSON-safe scalar: numpy scalars → Python, non-finite floats → None."""
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, (float, np.floating)):
        v = float(v)
        return v if math.isfinite(v) else None
    return v


def encode_frame(ftype: int, meta: dict | None = None,
                 arrays: list[tuple[str, np.ndarray]] | None = None) -> bytes:
    """One frame as bytes.  `arrays` is an ordered list of (name, ndarray);
    their dtype/shape specs land in the metadata under "__arrays__" and the
    raw C-order bytes follow the JSON in declaration order."""
    meta = {k: _json_scalar(v) for k, v in (meta or {}).items()}
    blobs = []
    specs = []
    for name, a in (arrays or []):
        a = np.ascontiguousarray(a)
        # pin byte order explicitly: '<' dtypes decode identically anywhere
        dt = a.dtype.newbyteorder("<")
        specs.append([name, dt.str, list(a.shape)])
        blobs.append(a.astype(dt, copy=False).tobytes())
    meta["__arrays__"] = specs
    mj = _canonical_json(meta)
    payload = struct.pack("!I", len(mj)) + mj + b"".join(blobs)
    return _HEADER.pack(MAGIC, PROTOCOL_VERSION, ftype, len(payload)) + payload


def decode_frame(buf: bytes) -> tuple[int, dict, dict[str, np.ndarray]]:
    """Inverse of `encode_frame`: (frame type, metadata, arrays by name).
    Decoded arrays own their memory (safe to hold past the buffer)."""
    magic, ver, ftype, plen = _HEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise ValueError(f"bad frame magic {magic!r}")
    if ver != PROTOCOL_VERSION:
        raise ValueError(f"unsupported protocol version {ver}")
    if len(buf) < _HEADER.size + plen:
        raise ValueError("truncated frame")
    off = _HEADER.size
    (mlen,) = struct.unpack_from("!I", buf, off)
    off += 4
    meta = json.loads(bytes(buf[off:off + mlen]).decode("utf-8"))
    off += mlen
    arrays: dict[str, np.ndarray] = {}
    for name, dtstr, shape in meta.pop("__arrays__", []):
        dt = np.dtype(dtstr)
        nbytes = dt.itemsize * int(np.prod(shape, dtype=np.int64))
        a = np.frombuffer(buf, dt, count=int(np.prod(shape, dtype=np.int64)),
                          offset=off).reshape(shape).copy()
        arrays[name] = a
        off += nbytes
    return ftype, meta, arrays


# --------------------------------------------------------------- socket I/O

def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    """n bytes or None on clean EOF; raises on mid-frame EOF."""
    chunks = []
    got = 0
    while got < n:
        b = sock.recv(n - got)
        if not b:
            if got == 0:
                return None
            raise ConnectionError("EOF mid-frame")
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


def read_frame(sock: socket.socket
               ) -> tuple[int, dict, dict[str, np.ndarray]] | None:
    """Read one length-prefixed frame; None on clean EOF (peer closed)."""
    head = _recv_exact(sock, _HEADER.size)
    if head is None:
        return None
    magic, ver, ftype, plen = _HEADER.unpack(head)
    if magic != MAGIC:
        raise ValueError(f"bad frame magic {magic!r}")
    payload = _recv_exact(sock, plen)
    if payload is None:
        raise ConnectionError("EOF mid-frame")
    return decode_frame(head + payload)


def write_frame(sock: socket.socket, frame: bytes) -> None:
    sock.sendall(frame)


# ------------------------------------------------------------ frame builders

def delta_frame(delta: CenterDelta, ftype: int = DELTA,
                term: int = 0) -> bytes:
    """A `CenterDelta` on the wire (DELTA, or SNAPSHOT for the full-prefix
    rebase bootstrap — same layout, different frame type).  `term` is the
    sender's promotion term (§14 fencing); 0 = single-master deployment."""
    meta = dict(model=delta.model, version=delta.version, start=delta.start,
                count=delta.count, capacity=delta.capacity,
                rebase=bool(delta.rebase), n_seen=delta.n_seen,
                epochs=delta.epochs, overflow=bool(delta.overflow),
                objective=delta.objective, cap_est=delta.cap_est,
                cap_trace=None if delta.cap_trace is None
                else list(delta.cap_trace), term=term)
    return encode_frame(ftype, meta, [("rows", np.asarray(delta.rows))])


def frame_delta(meta: dict, arrays: dict[str, np.ndarray]) -> CenterDelta:
    """Reconstruct the `CenterDelta` from a decoded DELTA/SNAPSHOT frame."""
    ct = meta.get("cap_trace")
    return CenterDelta(
        model=meta["model"], version=meta["version"], start=meta["start"],
        rows=arrays["rows"], count=meta["count"], capacity=meta["capacity"],
        rebase=bool(meta["rebase"]), n_seen=meta.get("n_seen", 0),
        epochs=meta.get("epochs", 0), overflow=bool(meta.get("overflow")),
        objective=meta.get("objective"), cap_est=meta.get("cap_est"),
        cap_trace=None if ct is None else tuple(ct))


def hello_frame(role: str, model: str | None = None, have_version: int = 0,
                worker: int = -1, term: int = 0) -> bytes:
    return encode_frame(HELLO, dict(role=role, model=model,
                                    have_version=have_version, worker=worker,
                                    term=term))


def ack_frame(model: str | None, version: int) -> bytes:
    return encode_frame(ACK, dict(model=model, version=version))


def fin_frame(reason: str = "") -> bytes:
    return encode_frame(FIN, dict(reason=reason))


def step_frame(epoch: int, count: int, term: int = 0) -> bytes:
    """Master → worker: start epoch `epoch`; `count` echoes the pool
    watermark so the worker can assert its replica is in sync; `term` is
    the sender's promotion term — a worker that has already answered a
    term-t master must reject STEPs from any term < t (§14)."""
    return encode_frame(STEP, dict(epoch=epoch, count=count, term=term))


def ctrl_frame(op: str, **fields) -> bytes:
    """One control-plane message (§14): an `op` string plus op-specific
    JSON-scalar fields.  The HA coordinator and its nodes speak only CTRL
    frames — who-is-master queries, orphaned-watermark reports, the
    PROMOTE/FOLLOW directives, per-epoch output digests, done/ready acks —
    so the control protocol shares the one framed codec (and its golden
    fixture) with the data planes."""
    return encode_frame(CTRL, dict(op=op, **fields))


def propose_frame(epoch: int, worker: int,
                  leaves: list[np.ndarray]) -> bytes:
    """Worker → master: the flattened `txn.propose` output leaves for this
    worker's shard of epoch `epoch`.  Leaf order is JAX's tree-flatten
    order (`core.occ.tree_leaves` in the port) — both sides derive the
    structure from the same transaction, so it never travels on the
    wire."""
    arrays = [(f"leaf{i}", np.asarray(a)) for i, a in enumerate(leaves)]
    return encode_frame(PROPOSE, dict(epoch=epoch, worker=worker,
                                      n_leaves=len(leaves)), arrays)
