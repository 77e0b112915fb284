"""Models of the port, by the JAX package's registry names:

"cnn" — WACNN: the single-quality channel-autoregressive model (single
        branches, division (m, m), no progressive stage).
"pic" — VarianceMaskingPIC: the paper's progressive model.
"rem" — VarianceMaskingPICREM: PIC + Rate Enhancement Modules.
"""

from __future__ import annotations

from typing import Any

from .cnn import WACNN
from .pic import VarianceMaskingPIC
from .rem import VarianceMaskingPICREM


MODELS = {"cnn": WACNN, "pic": VarianceMaskingPIC,
          "rem": VarianceMaskingPICREM}


def get_model(name: str, **config: Any):
    """Build a model by registry name from its config."""
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: {list(MODELS)}")
    return MODELS[name](**config)


__all__ = ["MODELS", "VarianceMaskingPIC", "VarianceMaskingPICREM", "WACNN",
           "get_model"]
