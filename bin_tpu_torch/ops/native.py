"""Build and load the port's CUDA kernels (``bin_tpu_torch/csrc/*.cu``).

One ``nvcc`` call compiles every source into one shared library with a
plain C interface (no PyTorch headers), which ``ctypes`` loads.  The build
runs at first use, into ``build/torch_kernels/<hash>/`` beside the package,
keyed by a hash of the sources and the flags, so a second run reuses it.
Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["build", "library", "stream", "check"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC"]
_LIB_NAME = "libbtt_kernels.so"

_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (CUDA_HOME or nvcc on PATH)")


def build() -> dict:
    """Compile the kernels unless a build of these sources exists.

    Returns {"path", "cached", "seconds"}."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / _LIB_NAME
    if lib.exists():
        return {"path": str(lib), "cached": True, "seconds": 0.0}
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build under a temporary name, then rename: a build cut short never
    # leaves a library that a later run would take for finished
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *_FLAGS, "-o", tmp, *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return {"path": str(lib), "cached": False,
            "seconds": time.perf_counter() - t0}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        lib = ctypes.CDLL(build()["path"])
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.btt_lstm_gates.argtypes = [vp, i32, vp, vp, vp, i64, i32,
                                       ctypes.c_float, i32, i32, vp]
        lib.btt_lstm_gates.restype = i32
        lib.btt_lstm_gates_bwd.argtypes = [vp, i32, vp, vp, vp, vp, vp, i64,
                                           i32, ctypes.c_float, i32, i32, vp]
        lib.btt_lstm_gates_bwd.restype = i32
        lib.btt_s2d_pack.argtypes = [vp, vp, i64, i32, i64, i32, i32, i32,
                                     i32, vp]
        lib.btt_s2d_pack.restype = i32
        lib.btt_quantize_act.argtypes = [vp, i32, vp, vp, i64, vp]
        lib.btt_quantize_act.restype = i32
        lib.btt_int8_conv.argtypes = ([vp] * 8 + [i32] * 11
                                      + [ctypes.c_float, vp])
        lib.btt_int8_conv.restype = i32
        _lib = lib
    return _lib


def stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the C functions take it."""
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a cudaError_t other than 0."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
