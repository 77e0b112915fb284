"""Microbenchmark of the native rANS coder on realistic Gaussian tables, as
the JAX package's ``tools/bench_rans.py`` runs it, on the port's coder
(``entropy/coder.py`` over ``native/epic_rans.cpp``).

Measures encode/decode symbols/s of one batched call (16 messages) with
the same table geometry the codec uses (64 Gaussian scale tables + escape
slot) and a symbol distribution drawn from those scales. The call spreads
its messages over the coder's host threads (``RansCoder.nthreads``: the
core count, at most 16). numpy and the native library only (no torch
device work); runs in seconds.

Usage: python -m epic_tpu_torch.tools.bench_rans [n_symbols]
"""

from __future__ import annotations

import sys
import time
from math import erf, sqrt

import numpy as np

from ..entropy.coder import RansCoder, pmf_to_quantized_cdf_batch


def gaussian_tables(num_scales=64, smin=0.11, smax=256.0, tail=1e-9):
    """(cdfs, cdf lengths, offsets, scales) of ``num_scales`` discretised
    Gaussians over +-4 sigma, each with one tail / escape slot quantized
    with its symbols (the layout of ``entropy/gaussian.py``)."""
    scales = np.exp(np.linspace(np.log(smin), np.log(smax), num_scales))
    lmax = 0
    pmfs, lengths, offsets = [], [], []

    def cdf(x, s):
        return 0.5 * (1 + erf(x / (s * sqrt(2.0))))

    for s in scales:
        t = max(1, int(np.ceil(4 * s)))  # +-4 sigma support
        xs = np.arange(-t, t + 1)
        p = np.array([cdf(x + 0.5, s) - cdf(x - 0.5, s) for x in xs])
        p = np.maximum(p, tail)
        tm = max(2 * cdf(-t - 0.5, s), tail)
        row = np.concatenate([p / (p.sum() + tm) * (1 - tm), [tm]])
        pmfs.append(row)
        lengths.append(len(xs))
        offsets.append(-t)
        lmax = max(lmax, len(xs))
    pm = np.zeros((num_scales, lmax + 1), np.float32)
    for i, p in enumerate(pmfs):
        pm[i, :len(p)] = p
    lengths = np.asarray(lengths, np.int32)
    cdfs = pmf_to_quantized_cdf_batch(pm, lengths + 1)
    return (cdfs, lengths + 2, np.asarray(offsets, np.int32),
            np.asarray(scales))


def run(n=4_000_000):
    """Encode and decode n symbols in 16 messages; returns {"n", "enc_msym_s",
    "dec_msym_s", "bits_per_sym", "lut", "threads"} after checking the
    round trip."""
    cdfs, cdf_lengths, offsets, scales = gaussian_tables()
    rng = np.random.default_rng(0)
    # scale-index distribution like a trained codec: mostly small scales
    idx = np.clip(rng.geometric(0.15, n) - 1, 0, 63).astype(np.int32)
    sym = np.round(rng.normal(0, scales[idx])).astype(np.int32)

    coder = RansCoder(cdfs, cdf_lengths, offsets)
    nmsg = 16
    lens = [n // nmsg] * nmsg
    lens[-1] += n - sum(lens)

    t0 = time.perf_counter()
    blobs = coder.encode_batch(sym, idx, lens)
    t_enc = time.perf_counter() - t0
    nbytes = sum(len(b) for b in blobs)
    t0 = time.perf_counter()
    out = coder.decode_batch(blobs, idx, lens)
    t_dec = time.perf_counter() - t0
    assert np.array_equal(out, sym)
    return {"n": n, "enc_msym_s": n / t_enc / 1e6,
            "dec_msym_s": n / t_dec / 1e6, "bits_per_sym": nbytes * 8 / n,
            "lut": getattr(coder, "_lut", None) is not None,
            "threads": coder.nthreads}


def main(n=4_000_000):
    r = run(n)
    print(f"n={n} enc {r['enc_msym_s']:.2f} Msym/s  dec "
          f"{r['dec_msym_s']:.2f} Msym/s  ({r['bits_per_sym']:.3f} bits/sym, "
          f"lut={'yes' if r['lut'] else 'no'})")
    return r


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4_000_000)
