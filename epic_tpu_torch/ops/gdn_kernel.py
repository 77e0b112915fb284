"""Fused GDN / inverse GDN: the CUDA kernels ``csrc/gdn.cu`` (forward) and
``csrc/gdn_bwd.cu`` (backward), their plain PyTorch versions, and the
autograd function that joins them.

``gdn(x, gamma, beta, inverse)`` computes, over the last axis of x,
``y = x * rsqrt(x^2 @ gamma + beta)`` (GDN) or ``x * sqrt(...)`` (inverse),
in float32 for float32 or bf16 x, and returns y in x's type: for a tensor
on the CPU with ``gdn_plain``; for a CUDA tensor with the hand-written
kernel (wgmma 3xTF32, TMA, bf16 read and written as it is), or it raises.
``gdn_backward(x, gamma, beta, g, inverse)`` gives (dx, dgamma, dbeta) in
closed form, dx in x's type (float32 or bf16, g of the same type),
computed in float32: on the CPU with ``gdn_backward_plain`` on the widened
inputs; on a CUDA tensor the backward kernel writes dx and each cluster's
partial sums of dgamma and dbeta, and ``gdn_backward_reduce`` (a second,
small kernel) sums them in a fixed order. ``gdn_differentiable`` is ``gdn``
with that backward attached (a ``torch.autograd.Function``); where no
gradient is asked for it is ``gdn`` itself, with nothing saved.

Each kernel is compiled by ``nvcc`` from the repository's source (and the
helpers both share, ``csrc/gdn_common.cuh``) at first use into
``epic_tpu_torch/_build/`` and bound with ctypes once; a launch costs no
more host work than the checks, the output allocation and the ctypes call.
``gdn.launches``, ``gdn_backward.launches`` and
``gdn_backward_reduce.launches`` count kernel launches by kind, under a
lock: the sweep pipeline launches from several threads at once.
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
BACKWARD_SOURCE = os.path.join(_PKG, "csrc", "gdn_bwd.cu")
HEADER = os.path.join(_PKG, "csrc", "gdn_common.cuh")  # both sources' helpers
_BUILD_DIR = os.path.join(_PKG, "_build")
MAX_CHANNELS = 192  # the kernels keep gamma in shared memory
_LOCK = threading.Lock()
_LIBS: dict = {}   # source -> ctypes library
_FNS: dict = {}    # entry point -> bound function
_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_FWD_ARGS = [_PTR, _PTR, _PTR, _PTR, _I64, _INT, _INT, _PTR]
# the C entry points: their source and argument types
_ENTRY = {
    "epic_gdn_forward": (SOURCE, _FWD_ARGS),
    "epic_gdn_forward_bf16": (SOURCE, _FWD_ARGS),
    # x, gamma, beta, g, dx, u (or null), partials, their floats, rows, C,
    # inverse, bf16, the partials' count (out), stream
    "epic_gdn_backward": (BACKWARD_SOURCE,
                          [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I64,
                           _I64, _INT, _INT, _INT,
                           ctypes.POINTER(ctypes.c_int), _PTR]),
    # partials, their count, C, inverse, dgamma, dbeta, stream
    "epic_gdn_backward_reduce": (BACKWARD_SOURCE,
                                 [_PTR, _INT, _INT, _INT, _PTR, _PTR, _PTR]),
    # bf16, inverse
    "epic_gdn_backward_clusters": (BACKWARD_SOURCE, [_INT, _INT]),
}
# the forward kernel's entry point for each type of x (and y)
_FORWARD = {torch.float32: "epic_gdn_forward",
            torch.bfloat16: "epic_gdn_forward_bf16"}
_TYPES = tuple(_FORWARD)  # x (and g, dx) of both kernels
# the backward kernel's partial sums, one per cluster of 4 blocks: dgamma's
# MAX_CHANNELS rows, then dbeta, each MAX_CHANNELS wide
PART_ROWS = MAX_CHANNELS + 1
PART_FLOATS = PART_ROWS * MAX_CHANNELS
_CLUSTER = 4
_SMS: dict = {}    # device index -> SM count


def gdn_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              inverse: bool = False) -> torch.Tensor:
    """norm[..., i] = beta[i] + sum_j x[..., j]^2 gamma[j, i] (einsum form),
    in float32 whatever x's type; y in x's type."""
    xf = x.float()
    norm = torch.einsum("...j,ji->...i", xf * xf, gamma) + beta
    y = xf * torch.sqrt(norm) if inverse else xf * torch.rsqrt(norm)
    return y.to(x.dtype)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def gdn_backward_rows_plain(x: torch.Tensor, gamma: torch.Tensor,
                            beta: torch.Tensor, g: torch.Tensor,
                            inverse: bool = False):
    """What the backward kernel computes, over rows [R, C] of x and the
    incoming gradient g: (dx, u). With n = x^2 @ gamma + beta:
    GDN:  u = g x n^-3/2, dx = g n^-1/2 - x (u @ gamma^T);
    IGDN: u = g x n^-1/2, dx = g n^1/2 + x (u @ gamma^T)."""
    n = (x * x) @ gamma + beta
    if inverse:
        sqrt_n = torch.sqrt(n)
        u = g * x / sqrt_n
        return g * sqrt_n + x * (u @ gamma.T), u
    inv_sqrt = torch.rsqrt(n)
    u = g * x * inv_sqrt ** 3
    return g * inv_sqrt - x * (u @ gamma.T), u


def gdn_backward_plain(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, g: torch.Tensor,
                       inverse: bool = False):
    """The closed-form vector-Jacobian product of ``gdn_plain`` for the
    incoming gradient g (the JAX package's ``pallas_gdn._bwd``): dx and u
    as ``gdn_backward_rows_plain``, dgamma = -/+ 1/2 (x^2)^T @ u, dbeta =
    -/+ 1/2 sum u. Returns (dx, dgamma, dbeta)."""
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    dx, u = gdn_backward_rows_plain(x2, gamma, beta, g.reshape(-1, c),
                                    inverse)
    return (dx.reshape(x.shape),) + _weight_grads(x2, u, inverse)


def _weight_grads(x2: torch.Tensor, u: torch.Tensor, inverse: bool):
    """dgamma = -/+ 1/2 (x^2)^T @ u and dbeta = -/+ 1/2 sum u, over [R, C]
    rows."""
    s = 0.5 if inverse else -0.5
    return s * ((x2 * x2).T @ u), s * u.sum(dim=0)


def build_library(source: str = SOURCE) -> str:
    """Compile one of the kernels' sources for sm_90a unless it is built;
    returns the shared library's path (keyed by a hash of the source and
    of the header it includes)."""
    h = hashlib.sha256()
    for path in (source, HEADER):
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    path = os.path.join(_BUILD_DIR, f"libepic_{stem}_{digest}.so")
    if not os.path.exists(path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", source, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
        with open(os.path.join(_BUILD_DIR, f"{stem}_ptxas.txt"), "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, path)
    return path


def _entry(name: str):
    """A bound C entry point (its source's library built once)."""
    fn = _FNS.get(name)
    if fn is None:
        with _LOCK:
            fn = _FNS.get(name)
            if fn is None:
                source, argtypes = _ENTRY[name]
                lib = _LIBS.get(source)
                if lib is None:
                    lib = _LIBS[source] = ctypes.CDLL(build_library(source))
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
                _FNS[name] = fn
    return fn


def _check(name: str, x: torch.Tensor, gamma: torch.Tensor,
           beta: torch.Tensor, *others: torch.Tensor) -> None:
    """Raise unless x (and ``others``, of x's shape and type) is a
    contiguous float32 or bf16 tensor, gamma and beta contiguous float32,
    all on x's CUDA device, with 1 <= C <= MAX_CHANNELS."""
    dev, c, f32 = x.device, x.shape[-1], torch.float32
    if not (x.dtype in _TYPES
            and all(t.dtype is x.dtype for t in others)
            and gamma.dtype is f32 and beta.dtype is f32
            and all(t.device == dev and t.is_contiguous()
                    for t in (x, gamma, beta) + others)):
        raise ValueError(f"{name}: x must be contiguous float32 or bf16 "
                         f"(the others of its type), gamma and beta "
                         f"contiguous float32, all on {dev}")
    if (gamma.shape != (c, c) or beta.shape != (c,)
            or any(t.shape != x.shape for t in others)
            or not 0 < c <= MAX_CHANNELS):
        raise ValueError(f"{name}: bad shapes x {tuple(x.shape)}, gamma "
                         f"{tuple(gamma.shape)}, beta {tuple(beta.shape)} "
                         f"(1 <= C <= {MAX_CHANNELS})")


def gdn(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
        inverse: bool = False) -> torch.Tensor:
    """GDN over the last axis of x ([..., C] float32 or bf16, contiguous,
    1 <= C <= MAX_CHANNELS on a CUDA device; gamma, beta float32), computed
    in float32; y in x's type."""
    dev = x.device
    if dev.type == "cpu":
        return gdn_plain(x, gamma, beta, inverse)
    if dev.type != "cuda":
        raise ValueError(f"gdn: unsupported device {dev}")
    _check("gdn", x, gamma, beta)
    index = dev.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return gdn(x, gamma, beta, inverse)
    c = x.shape[-1]
    y = torch.empty_like(x)
    # the raw handle of PyTorch's current stream (what
    # torch.cuda.current_stream().cuda_stream gives, without building a
    # Stream object on every call)
    rc = _entry(_FORWARD[x.dtype])(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        x.numel() // c, c, int(inverse),
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


def _part_capacity(index: int) -> int:
    """Floats of the partials buffer a backward launch on device `index`
    may fill: one partial per cluster, at most SMs / 4 clusters."""
    sms = _SMS.get(index)
    if sms is None:
        sms = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return (sms // _CLUSTER) * PART_FLOATS


def _backward_launch(x, gamma, beta, g, inverse: bool, want_u: bool):
    """One launch of the backward kernel on x's (current) CUDA device:
    (dx in x's type, u float32 or None, the partials buffer, their
    count)."""
    _check("gdn_backward", x, gamma, beta, g)
    index = x.device.index
    c = x.shape[-1]
    dx = torch.empty_like(x)
    u = torch.empty(x.shape, dtype=torch.float32, device=x.device) \
        if want_u else None
    cap = _part_capacity(index)
    part = torch.empty(cap, dtype=torch.float32, device=x.device)
    parts = ctypes.c_int(0)
    rc = _entry("epic_gdn_backward")(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), g.data_ptr(),
        dx.data_ptr(), u.data_ptr() if want_u else None, part.data_ptr(),
        cap, x.numel() // c, c, int(inverse),
        int(x.dtype is torch.bfloat16), ctypes.byref(parts),
        torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"gdn backward kernel launch failed: CUDA error "
                           f"{rc}")
    gdn_backward.launches.add("igdn" if inverse else "gdn")
    return dx, u, part, parts.value


def gdn_backward_rows(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, g: torch.Tensor,
                      inverse: bool = False):
    """The backward kernel over the last axis of x and g (contiguous
    float32 or bf16, of one type, on a CUDA device, 1 <= C <= MAX_CHANNELS):
    (dx in x's type, u float32) as ``gdn_backward_rows_plain`` on the
    widened inputs, each of x's shape. One launch."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"gdn_backward_rows: unsupported device {dev}")
    index = dev.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return gdn_backward_rows(x, gamma, beta, g, inverse)
    dx, u, _, _ = _backward_launch(x, gamma, beta, g, inverse, True)
    return dx, u


def gdn_backward_reduce_plain(part: torch.Tensor, parts: int, c: int,
                              inverse: bool = False):
    """What ``gdn_backward_reduce`` computes: (dgamma [c, c], dbeta [c]) =
    -/+ 1/2 the sum of the first `parts` partials ([PART_ROWS,
    MAX_CHANNELS] each, flat in `part`)."""
    p = part[:parts * PART_FLOATS].view(parts, PART_ROWS, MAX_CHANNELS)
    s = 0.5 if inverse else -0.5
    return (s * p[:, :c, :c].sum(dim=0),
            s * p[:, MAX_CHANNELS, :c].sum(dim=0))


def gdn_backward_reduce(part: torch.Tensor, parts: int, c: int,
                        inverse: bool = False):
    """(dgamma, dbeta) from the backward kernel's partials: the second
    kernel of ``csrc/gdn_bwd.cu``, which adds them in cluster order; for a
    tensor on the CPU ``gdn_backward_reduce_plain``. One launch."""
    dev = part.device
    if dev.type == "cpu":
        return gdn_backward_reduce_plain(part, parts, c, inverse)
    if (dev.type != "cuda" or part.dtype is not torch.float32
            or not part.is_contiguous() or part.dim() != 1
            or not 0 < c <= MAX_CHANNELS
            or not 0 <= parts * PART_FLOATS <= part.numel()):
        raise ValueError(f"gdn_backward_reduce: bad partials "
                         f"{part.dtype} {tuple(part.shape)} on {dev} for "
                         f"{parts} partials, C = {c}")
    index = dev.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return gdn_backward_reduce(part, parts, c, inverse)
    dgamma = torch.empty((c, c), dtype=torch.float32, device=dev)
    dbeta = torch.empty((c,), dtype=torch.float32, device=dev)
    rc = _entry("epic_gdn_backward_reduce")(
        part.data_ptr(), parts, c, int(inverse), dgamma.data_ptr(),
        dbeta.data_ptr(), torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"gdn backward reduction launch failed: CUDA "
                           f"error {rc}")
    gdn_backward_reduce.launches.add("igdn" if inverse else "gdn")
    return dgamma, dbeta


gdn_backward_reduce.launches = LaunchCounts("gdn", "igdn")


def gdn_backward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 g: torch.Tensor, inverse: bool = False):
    """(dx, dgamma, dbeta) of ``gdn`` for the incoming gradient g (x's shape
    and type, float32 or bf16), computed in float32, dx in x's type: on the
    CPU ``gdn_backward_plain`` on the widened inputs; on a CUDA device the
    backward kernel (dx and the partials; ``gdn_backward.launches``) and
    ``gdn_backward_reduce`` (``gdn_backward_reduce.launches``)."""
    dev = x.device
    if dev.type == "cpu":
        dx, dgamma, dbeta = gdn_backward_plain(x.float(), gamma, beta,
                                               g.float(), inverse)
        return dx.to(x.dtype), dgamma, dbeta
    if dev.type != "cuda":
        raise ValueError(f"gdn_backward: unsupported device {dev}")
    index = dev.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return gdn_backward(x, gamma, beta, g, inverse)
    dx, _, part, parts = _backward_launch(x, gamma, beta, g, inverse, False)
    return (dx,) + gdn_backward_reduce(part, parts, x.shape[-1], inverse)


gdn_backward.launches = LaunchCounts("gdn", "igdn")


def backward_clusters(dtype: torch.dtype, inverse: bool = False) -> int:
    """Clusters of 4 blocks that a backward launch of this variant runs on
    the current device (the partials of a launch over at least that many
    64-row tiles); 0 before the variant's first launch there."""
    return _entry("epic_gdn_backward_clusters")(
        int(dtype is torch.bfloat16), int(inverse))


class _GDNFunction(torch.autograd.Function):
    """``gdn`` forward, ``gdn_backward`` backward (the JAX package's
    ``gdn_pallas`` custom_vjp). x is saved in its own type and the backward
    takes x and g as they are (bf16 is widened exactly inside, dx rounded
    once to x's type), so the gradients are bitwise those of the same step
    run on x.float()."""

    @staticmethod
    def forward(ctx, x, gamma, beta, inverse):
        ctx.inverse = inverse
        ctx.save_for_backward(x, gamma, beta)
        return gdn(x, gamma, beta, inverse)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        dx, dgamma, dbeta = gdn_backward(x, gamma, beta, g.contiguous(),
                                         ctx.inverse)
        return dx, dgamma, dbeta, None


def gdn_differentiable(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor,
                       inverse: bool = False) -> torch.Tensor:
    """``gdn`` with its closed-form backward attached when a gradient is
    asked for (grad mode on and an input that requires it); otherwise
    ``gdn`` itself: the same kernel and launches, nothing saved."""
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _GDNFunction.apply(x, gamma, beta, inverse)
    return gdn(x, gamma, beta, inverse)
