"""Write the JAX package's z CDF tables for two entropy bottlenecks at 192
channels, with the arrays they come from, into
``tests/fixtures/z_tables_jax.npz``.

The cases: the port's constructor weights (what ``init_weights`` keeps,
so the tiny models and chip_smoke.py's random-weight flagship) and a
seeded numpy draw of every array, with nonzero ``factor_*`` so that tanh
is exercised. Both have pmf grids 21 wide. chip_smoke.py holds the port's
tables, computed on the GPU machine's host (which has no JAX), equal to
these bit for bit; ``tests/test_torch_entropy.py`` holds this file equal
to what the JAX package computes from its arrays. The arrays are stored so
that the check does not rest on another torch version drawing the
constructor's biases alike. Run from the repository's root:

    JAX_PLATFORMS=cpu python tests/gen_torch_z_tables.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "fixtures", "z_tables_jax.npz")
CHANNELS = 192
TABLE_FIELDS = ("quantized_cdf", "cdf_length", "offset")


def constructor_arrays(channels: int = CHANNELS) -> dict:
    """The port's ``EntropyBottleneck(channels)`` arrays, as numpy."""
    sys.path.insert(0, ROOT)
    from epic_tpu_torch.entropy.bottleneck import EntropyBottleneck

    return {k: v.detach().numpy().copy()
            for k, v in EntropyBottleneck(channels).state_dict().items()}


def seeded_arrays(channels: int = CHANNELS, seed: int = 12) -> dict:
    """Every array of the bottleneck drawn with numpy: matrices, biases and
    factors N(0, 1); medians U(-0.5, 0.5) with the outer quantiles 9.25 to
    9.75 away (so the pmf grid is 21 wide, as the constructor's)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, v in constructor_arrays(channels).items():
        if name == "quantiles":
            med = rng.uniform(-0.5, 0.5, channels)
            lo = med - rng.uniform(9.25, 9.75, channels)
            hi = med + rng.uniform(9.25, 9.75, channels)
            out[name] = np.stack([lo, med, hi], -1)[:, None, :]
        else:
            out[name] = rng.normal(0.0, 1.0, v.shape)
        out[name] = out[name].astype(np.float32)
    return out


def jax_tables(arrays: dict) -> dict:
    """The JAX package's z tables and medians from the bottleneck's arrays."""
    sys.path.insert(0, ROOT)
    import jax.numpy as jnp
    from epic_tpu.entropy import bottleneck as jbottleneck

    c = arrays["quantiles"].shape[0]
    tables, medians = jbottleneck.build_bottleneck_cdf_tables(
        jbottleneck.EntropyBottleneck(c),
        {"params": {k: jnp.asarray(v) for k, v in arrays.items()}})
    out = {f: np.asarray(getattr(tables, f), np.int32) for f in TABLE_FIELDS}
    out["medians"] = np.asarray(medians, np.float32)
    return out


def cases() -> dict:
    return {"constructor": constructor_arrays(), "seeded": seeded_arrays()}


if __name__ == "__main__":
    blob = {}
    for case, arrays in cases().items():
        for k, v in arrays.items():
            blob[f"{case}/arrays/{k}"] = v
        for k, v in jax_tables(arrays).items():
            blob[f"{case}/tables/{k}"] = v
    np.savez_compressed(OUT, **blob)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
