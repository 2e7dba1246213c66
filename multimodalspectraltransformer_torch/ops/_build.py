"""Build and load the port's CUDA kernels: one plain ``nvcc`` call, ``ctypes``.

At first use every ``csrc/*.cu`` is compiled in ONE ``nvcc`` invocation into
one shared library with a plain C interface under the package's git-ignored
``build/`` directory::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/libmmtkernels.so csrc/*.cu

No PyTorch header is included, so the build takes seconds. The library is
rebuilt only when a source is newer than it. Every pointer and the stream
cross the boundary as ``c_void_p``; every C launcher returns
``cudaGetLastError()`` and ``check`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libmmtkernels.so")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signature of each launcher: (argtypes), all returning cudaError_t as int
SIGNATURES = {
    # q, kv, out, B, H, T, Dh, pos, is_bf16, stream
    "mmt_decode_attention": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # cost, total, rounds (or null), B, N, n_phases, iters_per_phase, eps_final,
    # scale_factor, variant, stream
    "mmt_auction": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P],
    # q, kv, bias, out, B, H, K, M, Dh, n_live, group, is_bf16, stream
    "mmt_beam_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # grad, sorted_ids, order, out, n, num_weights, dim, dtype, stream
    "mmt_embedding_grad": [_P, _P, _P, _P, _L, _I, _I, _I, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def build(force: bool = False, verbose: bool = False) -> str:
    """Compile ``csrc/*.cu`` into ``LIB_PATH`` unless it is newer than every
    source. Returns the library path."""
    srcs = sources()
    fresh = os.path.exists(LIB_PATH) and all(
        os.path.getmtime(LIB_PATH) >= os.path.getmtime(s) for s in srcs
    )
    if fresh and not force:
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-o", tmp, *srcs]
    if verbose:
        cmd.insert(1, "--ptxas-options=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    if verbose and proc.stderr:
        print(proc.stderr, flush=True)
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
