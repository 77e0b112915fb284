"""Published Kodak rate-distortion anchor curves for the comparison plots:
the paper model's curve and the two competitor curves the reference plots
against, stored in ``anchors.json`` (the JAX package's data, copied)."""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, List


@lru_cache(maxsize=1)
def load_anchors() -> Dict[str, Dict[str, List[float]]]:
    path = os.path.join(os.path.dirname(__file__), "anchors.json")
    with open(path) as f:
        return json.load(f)


def anchor(name: str):
    """-> (bpp list, psnr list). Names: reference_pic, tri_planet_23,
    tri_planet_22, train_fallback_base."""
    a = load_anchors()[name]
    return a["bpp"], a["psnr"]
