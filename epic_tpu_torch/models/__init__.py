"""Models of the port, by the JAX package's registry names:

"pic" — VarianceMaskingPIC: the paper's progressive model.
"rem" — VarianceMaskingPICREM: PIC + Rate Enhancement Modules.
"cnn" (WACNN) is not ported yet.
"""

from __future__ import annotations

from typing import Any

from .pic import VarianceMaskingPIC
from .rem import VarianceMaskingPICREM

MODELS = {"pic": VarianceMaskingPIC, "rem": VarianceMaskingPICREM}


def get_model(name: str, **config: Any):
    """Build a model by registry name from its config."""
    if name == "cnn":
        raise NotImplementedError(
            "the WACNN 'cnn' model is not ported yet (ROADMAP A-4)")
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: {list(MODELS)}")
    return MODELS[name](**config)


__all__ = ["MODELS", "VarianceMaskingPIC", "VarianceMaskingPICREM",
           "get_model"]
