"""Evaluate a trained WACNN checkpoint with the port through the real
buffered codec, as the JAX package's ``tools/eval_cnn.py`` does.

WACNN (``cnn``) is the single-quality baseline that the reference trains
first: one RD point, one buffered rANS stream per image. This reports that
point on held-out content: real (string-length) bpp through
``PICCodec.compress(quality=0, buffered=True)``, PSNR / MS-SSIM of the
decoded reconstruction, and the estimated-vs-real bpp gap. The model runs
in bfloat16, as the JAX tool runs it. Same options (plus ``--images`` and
``--device``), printed lines and JSON keys.

Crops: from the teaser figure as ``tools/eval_checkpoint.py`` takes them
when that file exists (not in this repository), else 256x256 tiles of every
image in ``--images DIR`` (JPEG, PNG, BMP or Netpbm).

Usage: python -m epic_tpu_torch.tools.eval_cnn CKPT_DIR [--images DIR]
    [--out results.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("ckpt")
    p.add_argument("--which", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--regions", nargs="+", default=["val", "d0"])
    p.add_argument("--images", default=None,
                   help="a directory of images whose 256x256 tiles are the "
                        "crops when the teaser image is absent")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from ..codec import PICCodec
    from ..convert import load_checkpoint
    from ..utils.metrics import ms_ssim
    from .eval_checkpoint import est_bits_levels, group_crops, pick_which

    which = pick_which(args.ckpt, args.which)
    model, cfg, step = load_checkpoint(
        args.ckpt, which, config_overrides={"compute_dtype": "bfloat16"})
    if cfg.get("model") != "cnn":
        raise SystemExit(f"not a WACNN checkpoint: {cfg}")
    codec = PICCodec(model, device=args.device)
    model = codec.model

    groups = {}
    for name in args.regions:
        crops = group_crops(name, args.images)
        x = codec.as_input(np.stack(crops))
        npix = x.shape[0] * x.shape[1] * x.shape[2]
        out = codec.compress(x, quality=0, buffered=True)
        y_strings, z_strings = out["strings"]
        bits = (sum(len(s) for sl in y_strings for s in sl)
                + sum(len(s) for s in z_strings)) * 8.0
        dec = codec.decompress(out)
        x_hat = dec["x_hat"].float()
        mse = float(torch.mean((x_hat - x) ** 2))
        msssim = float(ms_ssim(x_hat, x))
        est = est_bits_levels(model, x, [0.0])[0]
        real_bpp = bits / npix
        groups[name] = {
            "n_crops": len(crops),
            "bpp": round(real_bpp, 4),
            "est_bpp": round(est / npix, 4),
            "gap_pct": round(abs(bits - est) / max(est, 1e-9) * 100, 2),
            "psnr": round(-10 * np.log10(max(mse, 1e-12)), 2),
            "msssim_db": round(-10 * np.log10(max(1 - msssim, 1e-12)), 2),
            "streams_per_image": len(y_strings[0]) // x.shape[0]
            if y_strings and y_strings[0] else None,
        }
        print(f"# {name}: {groups[name]}", flush=True)

    res = {"checkpoint": f"{args.ckpt}/{which}@{step}",
           "model": {k: cfg.get(k) for k in ("model", "n", "m")},
           "buffered_single_stream": True,
           "groups": groups}
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
