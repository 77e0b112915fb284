"""The port's main-path workload, shared by chip_smoke.py and
``tools/profile_sweep.py`` so the two drive the same thing: the flagship
``rem`` configuration (``artifacts/ckpt_r5_flagship/config.json``: N=192,
M=640, division (320, 640), dim_chunk 32, support 5, ParamNet widths
224-176-128-64, check levels (0.25, 0.75), mu_std, "middle" REMs, bf16
compute) with random weights from a seed, a seeded synthetic 768x512
image, batch 1, ``progressive_encode`` with ``DEFAULT_Q_LIST`` and
``rems=True``, then ``progressive_decode`` of levels 0..15 with one cache
and the encoder's checkpoint latents, then ``progressive_decode_all`` of
the same stream, as the JAX package's ``bench.py`` runs it."""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from ..codec import (PICCodec, progressive_decode, progressive_decode_all,
                     progressive_encode)
from ..models import get_model
from ..utils.synthetic import synthetic_image

H, W = 512, 768
PIC = dict(n=192, m=640, division=(320, 640), dim_chunk=32,
           support_progressive_slices=5,
           param_net_widths=(224, 176, 128, 64), compute_dtype="bfloat16")
FLAGSHIP = dict(PIC, check_levels=(0.25, 0.75), mu_std=True,
                rem_dimension="middle")


def full_width_codec(seed: int = 0, device=None,
                     name: str = "rem") -> PICCodec:
    """The full-width model (the flagship ``rem`` configuration, or its
    ``pic`` half without REMs) in bf16, weights from ``seed``."""
    config = FLAGSHIP if name == "rem" else PIC
    return PICCodec(get_model(name, **config).init_weights(seed),
                    device=device)


def images() -> Tuple[np.ndarray, np.ndarray]:
    """(image, warm-up image): the synthetic H x W image and its mirror, so
    a warm-up run codes other data than the measured one."""
    x = synthetic_image(H, W)
    return x, np.ascontiguousarray(x[:, :, ::-1])


def decode_levels(codec: PICCodec, bitstreams: Dict[str, Any],
                  timing: Optional[Dict[str, float]] = None,
                  rems: bool = False, y_checkpoints=None
                  ) -> Iterator[Tuple[int, Dict[str, Any]]]:
    """Decode levels 0..Q one after another with one cache; yields (level,
    the ``progressive_decode`` result)."""
    cache: Dict[str, Any] = {}
    for lvl in range(len(bitstreams["q_list"]) + 1):
        yield lvl, progressive_decode(codec, bitstreams, lvl, cache, rems,
                                      y_checkpoints, timing)


def sweep(codec: PICCodec, x, timing: Optional[Dict[str, Dict]] = None
          ) -> Dict[str, Any]:
    """The main path once: encode (REMs on for a ``rem`` model), decode of
    levels 0..Q, decode of all levels at once. ``timing`` gets one timing
    dict per stage ("encode", "decode", "decode_all"). Returns the stream,
    the encoder's state and the decoded x_hat of both decoders."""
    timing = timing if timing is not None else {}
    for k in ("encode", "decode", "decode_all"):
        timing.setdefault(k, {})
    rems = hasattr(codec.model, "check_levels")
    state: Dict[str, Any] = {}
    bs, bits = progressive_encode(codec, x, rems=rems,
                                  timing=timing["encode"], state=state)
    ckpts = state["auto_ckpts"]
    levels = [out["x_hat"] for _, out in decode_levels(
        codec, bs, timing["decode"], rems, ckpts)]
    out_all = progressive_decode_all(codec, bs, rems, ckpts,
                                     timing["decode_all"])
    return {"bitstreams": bs, "bits": bits, "state": state,
            "levels": levels, "x_hat_all": out_all["x_hat"]}
