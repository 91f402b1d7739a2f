"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/*.cu` file exposes a plain C interface and is compiled on first
use into its own shared library under `build/repro_torch/` at the repository
root (listed in .gitignore), named by the hash of its source and of the
shared headers (`csrc/*.cuh`), so an edited source is rebuilt and an
unchanged one is loaded as it is.  No PyTorch
headers are compiled: a build takes seconds, not minutes.

Building, loading and binding hold one process-wide lock, so threads that
reach a library's first use together (a trainer, a client and an admission
queue of one service) build it once and bind each entry point once; a
build's temporary file is named by process and thread.

Nothing here runs at import time, so the CPU tests import every module of
the port without nvcc or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "nvcc_path", "build",
           "build_all", "load", "function"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], object] = {}
_LOCK = threading.RLock()   # guards builds, _LIBS and _FUNCS
BUILD_LOG: dict[str, dict] = {}   # per source: seconds, ptxas output, path


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, else from PATH, else the toolkit's default
    install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _library(name: str) -> tuple[Path, Path]:
    """(source, library path) for `csrc/<name>.cu`.  The library is named
    by the hash of the source, of every header in `csrc/` and of the
    flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names) -> dict[str, Path]:
    """Compile every `csrc/<name>.cu` of `names` that has no library for
    its exact source yet, one nvcc process per source, all started
    together; returns the library paths.  Raises if any build fails."""
    with _LOCK:
        return _build_all_locked(names)


def _build_all_locked(names) -> dict[str, Path]:
    paths, running = {}, []
    for name in names:
        src, out = _library(name)
        paths[name] = out
        if out.exists():
            BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": "",
                                        "path": str(out)})
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(
            f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((name, src, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, src, out, tmp, proc, t0 in running:
        _, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src.name} "
                          f"(exit {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, out)
        BUILD_LOG[name] = {"seconds": seconds, "ptxas": err.strip(),
                           "path": str(out)}
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless a library for this exact source
    exists; returns the library path.  Raises on a failed build."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
        return lib


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """The C entry point `symbol` of `csrc/<name>.cu`, typed with
    `argtypes` and `restype` once, on first use, under the lock."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        with _LOCK:
            fn = _FUNCS.get((name, symbol))
            if fn is None:
                fn = getattr(load(name), symbol)
                fn.argtypes = argtypes
                fn.restype = restype
                _FUNCS[(name, symbol)] = fn
    return fn
