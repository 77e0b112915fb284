"""Rate-distortion evaluation with the real codec: rANS encode and decode,
bits counted from the lengths of the coded strings, as the JAX package's
``training/evaluate.py``.

- ``rd_sweep``: per image one progressive encode and one
  ``progressive_decode_all``; per level the cumulative bpp, PSNR and
  MS-SSIM (dB), averaged over the images.
- ``compress_with_ac``: per image and quality a random-access ``compress``
  and ``decompress``; per quality bpp, PSNR, MS-SSIM (dB) and decode time.

MS-SSIM is reported only for images of at least 176 x 176 pixels (0
otherwise). Images are NHWC (or HWC) float arrays in [0, 1], unpadded.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..codec.pic_codec import PICCodec
from ..codec.progressive import (DEFAULT_Q_LIST, progressive_decode_all,
                                 progressive_encode)
from ..utils.metrics import compute_msssim, compute_psnr, msssim_db
from ..utils.padding import pad_image, unpad_image


def _stream_bits(out: Dict[str, Any]) -> float:
    y_strings, z_strings = out["strings"]
    return (sum(len(s) for sl in y_strings for s in sl)
            + sum(len(s) for s in z_strings)) * 8.0


def _prepare(codec: PICCodec, img):
    """-> (x [B,H,W,3] on the codec's device, padded x, unpad, pixels)."""
    x = codec.as_input(img)
    if x.dim() == 3:
        x = x[None]
    xp, unpad = pad_image(x)
    return x, xp, unpad, x.shape[0] * x.shape[1] * x.shape[2]


def extract_checkpoints(codec: PICCodec, xp, check_levels):
    """The checkpoint latents of x at ``check_levels``, each conditioned on
    the one before (``PICCodec.extract_checkpoint``)."""
    out, prev = [], None
    for cl in check_levels:
        prev = codec.extract_checkpoint(xp, cl, checkpoint_rep=prev)
        out.append(prev)
    return out


def _msssim_db(x, x_hat) -> float:
    if x.shape[1] >= 176 and x.shape[2] >= 176:
        return msssim_db(compute_msssim(x, x_hat))
    return 0.0


def rd_sweep(codec: PICCodec, images: Sequence[np.ndarray],
             q_list: Sequence[float] = tuple(DEFAULT_Q_LIST),
             check_levels: Optional[Sequence[float]] = None
             ) -> Dict[str, Any]:
    """The whole progressive RD curve of each image from one encode and one
    decode of every level. Returns {"q_list": [0] + q_list, "bpp", "psnr",
    "ms_ssim_db" (per level, averaged over the images), "decode_all_time"
    (seconds per image of ``progressive_decode_all``)}."""
    nl = len(q_list) + 1
    bpp, psnr, mssim = np.zeros(nl), np.zeros(nl), np.zeros(nl)
    dec_time, count = 0.0, 0
    for img in images:
        x, xp, unpad, npix = _prepare(codec, img)
        ckpts = (extract_checkpoints(codec, xp, check_levels)
                 if check_levels else None)
        bs, bits = progressive_encode(codec, xp, q_list, rems=bool(ckpts),
                                      y_checkpoints=ckpts)
        t = time.perf_counter()
        out = progressive_decode_all(codec, bs, rems=bool(ckpts),
                                     y_checkpoints=ckpts)
        dec_time += time.perf_counter() - t
        for j in range(nl):
            cum = bits[0] + bits[1] + sum(bits[2][:j])
            x_hat = unpad_image(out["x_hat"][j], unpad)
            bpp[j] += cum / npix
            psnr[j] += compute_psnr(x, x_hat)
            mssim[j] += _msssim_db(x, x_hat)
        count += 1
    count = max(count, 1)
    return {"q_list": [0] + list(q_list), "bpp": (bpp / count).tolist(),
            "psnr": (psnr / count).tolist(),
            "ms_ssim_db": (mssim / count).tolist(),
            "decode_all_time": dec_time / count}


def compress_with_ac(codec: PICCodec, images: Sequence[np.ndarray],
                     pr_list: Sequence[float] = (0, 0.5, 1, 2, 5, 10),
                     check_levels: Optional[Sequence[float]] = None
                     ) -> Dict[str, Any]:
    """Random-access coding at each quality of ``pr_list``; with
    ``check_levels`` (a ``rem`` model) each quality above the first check
    level is conditioned on the checkpoint latent that brackets it from
    below. Returns per quality {"pr_list", "bpp", "psnr", "ms_ssim_db",
    "decode_time"}, averaged over the images."""
    nl = len(pr_list)
    bpp, psnr, mssim, dec_time = (np.zeros(nl) for _ in range(4))
    count = 0
    for img in images:
        x, xp, unpad, npix = _prepare(codec, img)
        ckpts = (extract_checkpoints(codec, xp, check_levels)
                 if check_levels else None)
        for k, q in enumerate(pr_list):
            ck = None
            if ckpts is not None and q > check_levels[0]:
                ck = ckpts[max(j for j, cl in enumerate(check_levels)
                               if q > cl)]
            out = codec.compress(xp, quality=q, checkpoint_rep=ck)
            t = time.perf_counter()
            dec = codec.decompress(out, checkpoint_rep=ck)
            codec.synchronize()
            dec_time[k] += time.perf_counter() - t
            x_hat = unpad_image(dec["x_hat"], unpad)
            bpp[k] += _stream_bits(out) / npix
            psnr[k] += compute_psnr(x, x_hat)
            mssim[k] += _msssim_db(x, x_hat)
        count += 1
    count = max(count, 1)
    return {"pr_list": list(pr_list), "bpp": (bpp / count).tolist(),
            "psnr": (psnr / count).tolist(),
            "ms_ssim_db": (mssim / count).tolist(),
            "decode_time": (dec_time / count).tolist()}
