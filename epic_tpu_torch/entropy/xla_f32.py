"""The entropy bottleneck's pmf grid in float32, rounded as the JAX
package's CPU program rounds it, in numpy alone.

The JAX package builds the z coder's CDF tables with
``EntropyBottleneck.pmf_grid`` applied eagerly: every jnp operation is its
own XLA CPU program. This module repeats those programs operation by
operation. It follows what jaxlib 0.9.0 compiles for an x86-64 host with
FMA: the LLVM IR of each program (``XLA_FLAGS=--xla_dump_to=DIR``, the
``*.ir-with-opt.ll`` files) for the operations and their order, and the
machine code (the dump's ``*.o`` files) for which multiply-add pairs the
backend fuses:

- ``softplus`` is ``max(x, 0) + log1p(exp(-|x|))`` (NaN passed through);
  ``sigmoid`` is ``1 / (exp(-x) + 1)``, exp's last multiply fused with the
  add;
- ``exp``, ``log`` and ``log1p`` (through ``log`` from 0.4142 on) and
  ``tanh`` are XLA's own polynomial and rational approximations, with their
  constants, clamps and small-argument branches, written out below in the
  IR's order;
- the IR holds plain float32 multiplies and adds, but the backend fuses
  every multiply whose one use is an add or a subtract into an FMA; ``_fma``
  rounds such a pair once, exactly;
- the einsum over the 3-wide filters is ``fma(a2, b2, fma(a1, b1, a0 b0))``
  but for a few remainder columns of the one-output layer (``_contract``);
  with one filter it is a plain product;
- XLA runs its CPU programs with denormals flushed (FTZ and DAZ): every
  arithmetic operation here flushes its inputs and its result, while a
  select passes a value through unchanged, as in XLA.

Only correctly rounded float32 and float64 arithmetic, floor, comparisons
and bit casts are used, no transcendental of numpy, so the result is the
same on any host. Held bitwise to the JAX package by
``tests/test_torch_entropy.py``.
"""

from __future__ import annotations

import struct

import numpy as np

_F32 = np.float32
_TINY = _F32(2.0 ** -126)


def _c(bits: int) -> np.float32:
    """A float32 constant from the double bit pattern LLVM prints for it."""
    return _F32(struct.unpack("<d", struct.pack("<Q", bits))[0])


def _flush(v):
    v = np.asarray(v, _F32)
    return np.where(np.abs(v) < _TINY, np.copysign(_F32(0), v), v)


def _add(a, b):
    return _flush(_flush(a) + _flush(b))


def _sub(a, b):
    return _flush(_flush(a) - _flush(b))


def _mul(a, b):
    return _flush(_flush(a) * _flush(b))


def _div(a, b):
    return _flush(_flush(a) / _flush(b))


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the fused multiply-add that the
    backend forms from a multiply whose one use is an add). The product of
    two float32 values is exact in float64; the float64 sum's own rounding
    error (TwoSum) breaks the one case where rounding it again to float32
    would round twice: a float64 sum that lies exactly halfway between two
    float32 values."""
    a, b, c = (_flush(v).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(_F32)
    d = s - r.astype(np.float64)
    nxt = np.nextafter(r, np.where(d > 0, _F32(np.inf), _F32(-np.inf)))
    tie = (d != 0) & (2 * d == nxt.astype(np.float64) - r) & (err != 0)
    r = np.where(tie & ((err > 0) == (d > 0)), nxt, r)
    return _flush(r)


def _horner(x, coeffs, start):
    """start, then p = fma(p, x, c) for each c."""
    p = start
    for c in coeffs:
        p = _fma(p, x, c)
    return p


# exp: clamp, n = floor(x log2(e) + 1/2) in [-127, 127], Cody-Waite reduction
# by ln 2 in two parts, a degree-7 polynomial; exp(x) = y * 2^n, returned as
# (y, 2^n) since the caller's next add may fuse with that multiply
_EXP_LO, _EXP_HI = _c(0xC055F33340000000), _c(0x4056333340000000)
_LOG2E = _c(0x3FF7154760000000)
_LN2_HI, _LN2_LO = _c(0x3FE6300000000000), _c(0xBF2BD01060000000)
_EXP_P = (_c(0x3F2A0D2CE0000000), _c(0x3F56E879C0000000),
          _c(0x3F81112100000000), _c(0x3FA5553820000000),
          _c(0x3FC5555540000000), _F32(0.5))


def _exp_parts(x):
    x = np.asarray(x, _F32)
    x = np.where(x < _EXP_LO, _EXP_LO, x)
    x = np.where(x > _EXP_HI, _EXP_HI, x)
    n = np.floor(_fma(x, _LOG2E, _F32(0.5)))
    n = np.where(n < _F32(-127), _F32(-127), n)
    n = np.where(n > _F32(127), _F32(127), n)
    r = _fma(-n, _LN2_HI, x)
    r = _fma(-n, _LN2_LO, r)
    p = _horner(r, _EXP_P[2:], _fma(r, _EXP_P[0], _EXP_P[1]))
    y = _add(_fma(p, _mul(r, r), r), _F32(1))
    scale = ((n.astype(np.int32) + 127) << 23).astype(np.int32).view(_F32)
    return y, scale


def exp(x):
    return _mul(*_exp_parts(x))


# log: frexp to m in [0.5, 1), m < sqrt(1/2) folded to [sqrt(1/2), sqrt(2)),
# three interleaved polynomials in x = m - 1, then e ln 2 in two parts
_SQRT_HALF = _c(0x3FE6A09E60000000)
_LOG_A = (_c(0x3FB2043760000000), _c(0xBFBD7A3700000000),
          _c(0x3FBDE4A340000000))
_LOG_B = (_c(0xBFBFCBA9E0000000), _c(0x3FC23D37E0000000),
          _c(0xBFC555CA00000000))
_LOG_C = (_c(0x3FC999D580000000), _c(0xBFCFFFFF80000000),
          _c(0x3FD5555540000000))


def log(v):
    v = np.asarray(v, _F32)
    le0, ne0, neinf = ~(v > 0), v != 0, v != np.inf
    bits = np.where(v > _TINY, v, _TINY).view(np.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).astype(np.int32).view(_F32)
    e = _add(((bits >> 23) - 127).astype(_F32), _F32(1))
    lt = m < _SQRT_HALF
    e = _sub(e, np.where(lt, _F32(1), _F32(0)))
    x = _add(_add(m, _F32(-1)), np.where(lt, m, _F32(0)))
    x2 = _mul(x, x)
    x3 = _mul(x2, x)
    ya, yb, yc = (_fma(_fma(x, k[0], k[1]), x, k[2])
                  for k in (_LOG_A, _LOG_B, _LOG_C))
    y = _fma(ya, x3, yb)
    y = _fma(y, x3, yc)
    y = _fma(y, x3, _mul(e, _LN2_LO))
    x = _fma(-x2, _F32(0.5), x)
    res = _fma(e, _LN2_HI, _add(x, y)).view(np.int32)
    special = np.where(ne0, np.where(neinf, 0, 0x7F800000),
                       np.int32(-8388608)).astype(np.int32)
    res = np.where(le0, np.int32(-1), res)
    res = np.where(ne0 & neinf, res, 0).astype(np.int32)
    return (special | res).view(_F32)


# log1p: below 0.4142 in magnitude, x - x^2/2 + x^3 P(x) / Q(x); else log(1 + x)
_LOG1P_SMALL = _c(0x3FDA8279A0000000)
_LOG1P_Q = (_c(0x402E2035A0000000), _c(0x4054C30B60000000),
            _c(0x406BB865A0000000), _c(0x4073519460000000),
            _c(0x406B0DB140000000), _c(0x404E0F3040000000))
_LOG1P_P = (_c(0x3FDFE818A0000000), _c(0x401A509F40000000),
            _c(0x403DE97380000000), _c(0x404E798EC0000000),
            _c(0x404C8E75A0000000), _c(0x40340A2020000000))
_LOG1P_P0 = _c(0x3F07BC0960000000)


def log1p(x):
    x = np.asarray(x, _F32)
    big = log(_add(x, _F32(1)))
    x2 = _mul(x, x)
    zero = _mul(x, _F32(0))
    q = _horner(x, _LOG1P_Q, _add(zero, _F32(1)))
    p = _horner(x, _LOG1P_P, _add(zero, _LOG1P_P0))
    t = _mul(_mul(x, x2), _div(p, q))
    small = _add(x, _fma(x2, _F32(-0.5), t))
    return np.where(np.abs(x) < _LOG1P_SMALL, small, big)


# tanh: Eigen's rational form, x itself below 0.0004, +-1 from 20 on
_TANH_SMALL, _TANH_CLAMP = _c(0x3F3A36E2E0000000), _c(0x401FFEC880000000)
_TANH_P = (_c(0xBCB3E4B800000000), _c(0x3D4C266FC0000000),
           _c(0xBDD7A6FFE0000000), _c(0x3E6B800820000000),
           _c(0x3EEF286940000000), _c(0x3F44E1BDA0000000),
           _c(0x3F740B3B80000000))
_TANH_Q = (_c(0x3EB41A7B00000000), _c(0x3F1F12BAC0000000),
           _c(0x3F629540A0000000), _c(0x3F740B3BA0000000))


def tanh(x):
    x = np.asarray(x, _F32)
    c = np.where(x < -_TANH_CLAMP, -_TANH_CLAMP, x)
    c = np.where(c > _TANH_CLAMP, _TANH_CLAMP, c)
    c2 = _mul(c, c)
    p = _mul(c, _horner(c2, _TANH_P[2:],
                        _fma(c2, _TANH_P[0], _TANH_P[1])))
    q = _horner(c2, _TANH_Q[2:], _fma(c2, _TANH_Q[0], _TANH_Q[1]))
    r = np.where(np.abs(x) < _TANH_SMALL, x, _div(p, q))
    return np.where(np.abs(x) >= _F32(20), np.copysign(_F32(1), x), r)


def softplus(x):
    x = np.asarray(x, _F32)
    y = _add(np.maximum(x, _F32(0)), log1p(exp(-np.abs(x))))
    return np.where(np.isnan(x), x, y)


def sigmoid(x):
    """1 / (exp(-x) + 1), exp's last multiply fused with the add."""
    y, scale = _exp_parts(-np.asarray(x, _F32))
    return _div(_F32(1), _fma(y, scale, _F32(1)))


def _plain_columns(channels: int, out: int, n: int):
    """The columns that XLA's matrix-vector kernel (one output, ``out ==
    1``) sums with separate multiplies and adds: it fuses them in its 8-wide
    tiles and in most remainders, but not in a remainder of one column, nor
    in the first column when n == 2 (measured on jaxlib 0.9.0 for 2 to 320
    channels and n up to 129; every other column, and every column of the
    3-output layers, is fused)."""
    if out != 1 or channels < 2:
        return []
    if n % 8 == 1:
        return [n - 1]
    return [0] if n == 2 else []


def _contract(m, logits):
    """einsum "cof,cfn->con", summed over f in order from 0:
    acc = fma(m_f, logits_f, acc)."""
    acc = _F32(0)
    for f in range(m.shape[2]):
        acc = _fma(m[:, :, f:f + 1], logits[:, f:f + 1, :], acc)
    for col in _plain_columns(m.shape[0], m.shape[1], logits.shape[2]):
        s = _F32(0)
        for f in range(m.shape[2]):
            s = _add(s, _mul(m[:, :, f], logits[:, f, col, None]))
        acc[:, :, col] = s
    return acc


def logits_cumulative(params: dict, inputs: np.ndarray) -> np.ndarray:
    """``EntropyBottleneck._logits_cumulative`` on inputs [C, 1, N]: per
    layer, the einsum "cof,cfn->con" with softplus(matrix_i), + bias_i,
    then + tanh(factor_i) * tanh(logits) (all but the last layer)."""
    logits = np.asarray(inputs, _F32)
    n_layers = sum(1 for k in params if k.startswith("matrix_"))
    for i in range(n_layers):
        m = softplus(params[f"matrix_{i}"])  # [C, out, in]
        if m.shape[2] == 1:
            logits = _mul(m, logits)  # [C, out, 1] * [C, 1, N]
        else:
            logits = _contract(m, logits)
        logits = _add(logits, params[f"bias_{i}"])
        if i < n_layers - 1:
            logits = _add(logits, _mul(tanh(params[f"factor_{i}"]),
                                       tanh(logits)))
    return logits


def pmf_grid(params: dict, pmf_start: np.ndarray, max_length: int):
    """``EntropyBottleneck.pmf_grid``: the pmf [C, max_length] of the
    integer grid pmf_start + 0 .. max_length - 1, and the tail mass [C]
    (the cumulative below the first bin plus the one above the last)."""
    with np.errstate(all="ignore"):  # overflow to inf as in XLA
        samples = _add(np.arange(max_length, dtype=_F32)[None, None, :],
                       np.asarray(pmf_start, _F32)[:, None, None])
        lower = logits_cumulative(params, _sub(samples, _F32(0.5)))
        upper = logits_cumulative(params, _add(samples, _F32(0.5)))
        sign = -np.sign(_add(lower, upper))
        pmf = np.abs(_sub(sigmoid(_mul(sign, upper)),
                          sigmoid(_mul(sign, lower))))
        tail = _add(sigmoid(lower[:, 0, 0]), sigmoid(-upper[:, 0, -1]))
    return pmf[:, 0, :], tail
