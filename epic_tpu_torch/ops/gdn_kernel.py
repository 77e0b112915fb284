"""Fused GDN / inverse GDN: the CUDA kernel ``csrc/gdn.cu`` and its plain
PyTorch version.

``gdn(x, gamma, beta, inverse)`` computes, over the last axis of x,
``y = x * rsqrt(x^2 @ gamma + beta)`` (GDN) or ``x * sqrt(...)`` (inverse):
for a tensor on the CPU with ``gdn_plain``; for a CUDA tensor with the
hand-written kernel (tensor cores, mma.sync 3xTF32), or it raises. The
kernel is compiled by ``nvcc`` from the repository's source at first use
into ``epic_tpu_torch/_build/`` and bound with ctypes once; a launch costs
no more host work than the checks, the output allocation and the ctypes
call. ``gdn.launches`` counts kernel launches by kind, under a lock: the
sweep pipeline launches from several threads at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "gdn.cu")
_BUILD_DIR = os.path.join(_PKG, "_build")
MAX_CHANNELS = 192  # csrc/gdn.cu keeps gamma and two x tiles in shared memory
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


def gdn_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              inverse: bool = False) -> torch.Tensor:
    """norm[..., i] = beta[i] + sum_j x[..., j]^2 gamma[j, i] (einsum form)."""
    norm = torch.einsum("...j,ji->...i", x * x, gamma) + beta
    return x * torch.sqrt(norm) if inverse else x * torch.rsqrt(norm)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build_library() -> str:
    """Compile ``csrc/gdn.cu`` for sm_90a unless it is built; returns the
    shared library's path (keyed by a hash of the source)."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(_BUILD_DIR, f"libepic_gdn_{digest}.so")
    if not os.path.exists(path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", SOURCE, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
        with open(os.path.join(_BUILD_DIR, "gdn_ptxas.txt"), "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, path)
    return path


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(build_library())
                lib.epic_gdn_forward.restype = ctypes.c_int
                lib.epic_gdn_forward.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p]
                _LIB = lib
    return _LIB


def gdn(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
        inverse: bool = False) -> torch.Tensor:
    """GDN over the last axis of x ([..., C] float32, contiguous,
    1 <= C <= MAX_CHANNELS on a CUDA device)."""
    dev = x.device
    if dev.type == "cpu":
        return gdn_plain(x, gamma, beta, inverse)
    if dev.type != "cuda":
        raise ValueError(f"gdn: unsupported device {dev}")
    c = x.shape[-1]
    f32 = torch.float32
    if not (x.dtype is f32 and gamma.dtype is f32 and beta.dtype is f32
            and gamma.device == dev and beta.device == dev
            and x.is_contiguous() and gamma.is_contiguous()
            and beta.is_contiguous()):
        raise ValueError(f"gdn: x, gamma and beta must be contiguous "
                         f"float32 tensors on {dev}")
    if (gamma.shape != (c, c) or beta.shape != (c,)
            or not 0 < c <= MAX_CHANNELS):
        raise ValueError(f"gdn: bad shapes x {tuple(x.shape)}, gamma "
                         f"{tuple(gamma.shape)}, beta {tuple(beta.shape)} "
                         f"(1 <= C <= {MAX_CHANNELS})")
    index = dev.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return gdn(x, gamma, beta, inverse)
    lib = _library()
    y = torch.empty_like(x)
    # the raw handle of PyTorch's current stream (what
    # torch.cuda.current_stream().cuda_stream gives, without building a
    # Stream object on every call)
    rc = lib.epic_gdn_forward(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                              y.data_ptr(), x.numel() // c, c, int(inverse),
                              torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"gdn kernel launch failed: CUDA error {rc}")
    gdn.launches.add("igdn" if inverse else "gdn")
    return y


class LaunchCounts(dict):
    """Kernel launches by kind; ``add`` increments under a lock, so
    launches from concurrent threads are all counted."""

    def __init__(self, *kinds: str):
        super().__init__((k, 0) for k in kinds)
        self._lock = threading.Lock()

    def add(self, kind: str) -> None:
        with self._lock:
            self[kind] += 1


gdn.launches = LaunchCounts("gdn", "igdn")
