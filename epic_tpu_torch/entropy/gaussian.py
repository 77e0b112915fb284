"""Conditional Gaussian entropy model: likelihoods, CDF-table indexes and
the quantized CDF tables of the host coder.

Scales are clamped from below at 0.11 and bucketed into a 64-entry
log-spaced table in [0.11, 256]; each bucket has its own quantized CDF.
Those default tables are part of the stream format and ship as data, equal
to the JAX package's (``gaussian_cdf_tables.npz``).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from .coder import RansCoder, pmf_to_quantized_cdf_batch
from .ops import lower_bound, uniform_noise

SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64
_TAIL_MASS = 1e-9
_TABLES_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "gaussian_cdf_tables.npz")


def get_scale_table(minimum: float = SCALES_MIN, maximum: float = SCALES_MAX,
                    levels: int = SCALES_LEVELS) -> np.ndarray:
    """64 log-spaced scales in [0.11, 256] (float32)."""
    return np.exp(np.linspace(math.log(minimum), math.log(maximum), levels,
                              dtype=np.float64)).astype(np.float32)


def standardized_cumulative(x: torch.Tensor) -> torch.Tensor:
    """Phi(x) through erfc, stable in the upper tail."""
    return 0.5 * torch.special.erfc(-(2 ** -0.5) * x)


def gaussian_likelihood(inputs, scales, means=None,
                        scale_bound: float = SCALES_MIN,
                        likelihood_bound: float = 1e-9):
    """P(integer bin of inputs - means) under N(0, scales^2)."""
    values = inputs - means if means is not None else inputs
    scales = lower_bound(scales, scale_bound)
    values = torch.abs(values)
    upper = standardized_cumulative((0.5 - values) / scales)
    lower = standardized_cumulative((-0.5 - values) / scales)
    likelihood = upper - lower
    if likelihood_bound > 0:
        likelihood = lower_bound(likelihood, likelihood_bound)
    return likelihood


def gaussian_noise_quantize(inputs: torch.Tensor,
                            generator: torch.Generator,
                            mask=None) -> torch.Tensor:
    """Training's stand-in for rounding: inputs + U(-0.5, 0.5) noise drawn
    from ``generator``; where ``mask`` is 0 the noise is zeroed (elements
    that are not transmitted)."""
    noise = uniform_noise(inputs, generator)
    if mask is not None:
        noise = noise * mask
    return inputs + noise


def build_indexes(scales: torch.Tensor, scale_table,
                  scale_bound: float = SCALES_MIN) -> torch.Tensor:
    """Bucket of each scale: the count of table entries (but the last) that
    lie strictly below it, i.e. the smallest entry >= scale. int32."""
    scales = torch.clamp(scales, min=scale_bound)
    table = torch.as_tensor(scale_table, dtype=scales.dtype,
                            device=scales.device)
    return torch.bucketize(scales, table[:-1].contiguous()).to(torch.int32)


@dataclass
class CdfTables:
    """The (quantized_cdf, cdf_length, offset) triple the host coder reads."""

    quantized_cdf: np.ndarray  # int32 [num_tables, max_len]
    cdf_length: np.ndarray     # int32 [num_tables]
    offset: np.ndarray         # int32 [num_tables]


def quantize_pmf_rows(pmf: np.ndarray, tail: np.ndarray,
                      pmf_length: np.ndarray, precision: int = 16
                      ) -> np.ndarray:
    """Row i: pmf_length[i] symbols plus one tail slot, quantized together
    into one integer CDF."""
    m, max_length = pmf.shape
    padded = np.zeros((m, max_length + 1), dtype=np.float32)
    for i in range(m):
        n = int(pmf_length[i])
        padded[i, :n] = pmf[i, :n]
        padded[i, n] = tail[i]
    return pmf_to_quantized_cdf_batch(padded, pmf_length + 1, precision)


def gaussian_pmf(scale_table: np.ndarray, pmf_center: np.ndarray,
                 max_length: int):
    """Per-bucket pmf over [-center, center] and its two-sided tail mass,
    in float32 on the host."""
    samples = torch.abs(torch.arange(max_length, dtype=torch.int32)[None, :]
                        - torch.as_tensor(pmf_center)[:, None]).float()
    s = torch.as_tensor(scale_table, dtype=torch.float32)[:, None]
    upper = standardized_cumulative((0.5 - samples) / s)
    lower = standardized_cumulative((-0.5 - samples) / s)
    return (upper - lower).numpy(), (2.0 * lower[:, 0]).numpy()


def default_cdf_tables() -> CdfTables:
    """The stream format's tables (64 scales of ``get_scale_table()``, tail
    mass 1e-9, precision 16), read from ``gaussian_cdf_tables.npz``: the JAX
    package's tables, written by ``tests/gen_torch_cdf_tables.py``."""
    with np.load(_TABLES_FILE) as f:
        flat, lengths, offset, width = (f["quantized_cdf"], f["cdf_length"],
                                        f["offset"], int(f["table_width"]))
    cdf = np.zeros((len(lengths), width), np.int32)
    for i, row in enumerate(np.split(flat, np.cumsum(lengths)[:-1])):
        cdf[i, :len(row)] = row
    return CdfTables(quantized_cdf=cdf, cdf_length=lengths.astype(np.int32),
                     offset=offset.astype(np.int32))


def build_gaussian_cdf_tables(scale_table=None, tail_mass: float = _TAIL_MASS,
                              precision: int = 16) -> CdfTables:
    """Quantized CDF tables for every scale bucket.

    With the default scale table, tail mass and precision these are the
    stream format's tables, equal to the JAX package's
    (``default_cdf_tables``).
    Other arguments compute the tables here with torch's float32 erfc; such
    tables are not bit-compatible with the JAX package's, whose XLA erfc
    rounds differently in the last bit and moves some entries by one count.
    """
    from scipy.stats import norm

    if scale_table is None:
        scale_table = get_scale_table()
    scale_table = np.asarray(scale_table, dtype=np.float32)
    if (tail_mass == _TAIL_MASS and precision == 16
            and np.array_equal(scale_table, get_scale_table())):
        return default_cdf_tables()
    multiplier = -float(norm.ppf(tail_mass / 2))
    pmf_center = np.ceil(scale_table * multiplier).astype(np.int32)
    pmf_length = 2 * pmf_center + 1
    pmf, tail = gaussian_pmf(scale_table, pmf_center, int(pmf_length.max()))
    cdf = quantize_pmf_rows(pmf, tail, pmf_length, precision)
    return CdfTables(quantized_cdf=cdf.astype(np.int32),
                     cdf_length=(pmf_length + 2).astype(np.int32),
                     offset=(-pmf_center).astype(np.int32))


def gaussian_coder(scale_table=None, nthreads: int | None = None) -> RansCoder:
    t = build_gaussian_cdf_tables(scale_table)
    return RansCoder(t.quantized_cdf, t.cdf_length, t.offset,
                     nthreads=nthreads)
