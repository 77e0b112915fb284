"""epic_tpu_torch: the PyTorch + CUDA port of epic_tpu (progressive image
compression with variance-aware masking) for NVIDIA Hopper.

It imports neither JAX nor the JAX package. Public tensors are NHWC, as in
the JAX package. Entry points run on the GPU unless given ``device="cpu"``.
"""

from .codec import (DEFAULT_Q_LIST, PICCodec, SweepPipeline, dump_bitstreams,
                    load_bitstreams, progressive_decode,
                    progressive_decode_all, progressive_encode,
                    progressive_encode_finish, progressive_encode_start,
                    run_sweeps)
from .convert import from_jax_params, load_checkpoint
from .models import VarianceMaskingPIC, VarianceMaskingPICREM, get_model

__all__ = ["DEFAULT_Q_LIST", "PICCodec", "SweepPipeline", "VarianceMaskingPIC",
           "VarianceMaskingPICREM", "dump_bitstreams", "from_jax_params",
           "get_model", "load_bitstreams", "load_checkpoint",
           "progressive_decode", "progressive_decode_all",
           "progressive_encode", "progressive_encode_finish",
           "progressive_encode_start", "run_sweeps"]
