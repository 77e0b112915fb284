"""Write the port's default Gaussian CDF tables from the JAX package's.

The default tables (the 64 scales of ``get_scale_table()``, tail mass 1e-9,
precision 16) are a constant of the stream format. The port ships them as
data, ``epic_tpu_torch/entropy/gaussian_cdf_tables.npz``, because its own
float32 erfc differs from XLA's in the last bit here and there, and that
moves some CDF entries by one count. The rows are stored ragged and
concatenated (``cdf_length[i]`` entries for table i; ``table_width`` is
the zero-padded width of the coder's table array). Run from the
repository's root:

    JAX_PLATFORMS=cpu python tests/gen_torch_cdf_tables.py

``tests/test_torch_entropy.py`` holds the committed file equal to what this
writes.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "epic_tpu_torch", "entropy",
                   "gaussian_cdf_tables.npz")


def reference_arrays() -> dict:
    sys.path.insert(0, ROOT)
    from epic_tpu.entropy import gaussian as jgaussian

    t = jgaussian.build_gaussian_cdf_tables(jgaussian.get_scale_table())
    rows = [t.quantized_cdf[i, :n] for i, n in enumerate(t.cdf_length)]
    return dict(quantized_cdf=np.concatenate(rows).astype(np.int32),
                table_width=np.int32(t.quantized_cdf.shape[1]),
                cdf_length=t.cdf_length.astype(np.int32),
                offset=t.offset.astype(np.int32))


if __name__ == "__main__":
    np.savez_compressed(OUT, **reference_arrays())
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
