"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/*.cu` file exposes a plain C interface and is compiled on first
use into its own shared library under `build/repro_torch/` at the repository
root (listed in .gitignore), named by the hash of its source, so an edited
source is rebuilt and an unchanged one is loaded as it is.  No PyTorch
headers are compiled: a build takes seconds, not minutes.

Nothing here runs at import time, so the CPU tests import every module of
the port without nvcc or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "nvcc_path", "build", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}   # per source: seconds, ptxas output, path


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, else from PATH, else the toolkit's default
    install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless a library for this exact source
    exists; returns the library path.  Raises on a failed build."""
    src = CSRC / f"{name}.cu"
    text = src.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
    if out.exists():
        BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": "", "path": str(out)})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[name] = {"seconds": seconds, "ptxas": proc.stderr.strip(),
                       "path": str(out)}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib
