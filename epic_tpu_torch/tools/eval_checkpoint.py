"""Evaluate a trained checkpoint with the port, as the JAX package's
``tools/eval_checkpoint.py`` does: held-out RD curve, estimated-vs-real bpp
gap, RD monotonicity (the round-2 credibility criteria: top-quality bpp < 2
and PSNR > 28 on held-out crops, est-vs-real bpp gap < 5% under trained
statistics, monotone RD across all levels), the per-shell table and, for a
``rem`` checkpoint, the chained-REM ladder and the per-quality REM savings.
Same options (plus ``--device``), printed lines and JSON keys.

Crops: as the JAX tool takes them, from the teaser figure
(``data/device_bank.TEASER_PATH``: the validation strip of its main photo
for "val", whole regions such as "d0" tiled), when that file exists. It is
not in this repository; where it is absent, every group takes 256x256 tiles
of every image in ``--images DIR`` instead (file-name order, read by
``data/images.read_image``: JPEG, PNG, BMP or Netpbm). The "photo768" group
needs the teaser.

Usage: python -m epic_tpu_torch.tools.eval_checkpoint CKPT_DIR
    [--images DIR] [--out results.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

Q_LIST = [0.01, 0.05, 0.1, 0.25, 0.5, 0.6, 0.7, 0.8, 0.9, 1, 2, 3, 4,
          4.5, 10]

# every rANS message ends with an 8-byte final-state flush
# (native/epic_rans.cpp)
FLUSH_BYTES = 8


def image_tiles(directory: str, patch: int = 256):
    """float32 [patch, patch, 3] tiles in [0, 1], row-major, of every image
    file in ``directory`` in file-name order; an image smaller than a patch
    gives none."""
    from ..data.datasets import _list_images
    from ..data.images import read_image

    crops = []
    for path in _list_images(directory):
        im = read_image(path)
        h, w = im.shape[:2]
        for oy in range(0, h - patch + 1, patch):
            for ox in range(0, w - patch + 1, patch):
                crops.append(im[oy:oy + patch, ox:ox + patch]
                             .astype(np.float32) / np.float32(255.0))
    if not crops:
        raise ValueError(f"no image under {directory} holds a {patch}px "
                         f"tile")
    return crops


def heldout_crops(patch=256):
    """256x256 crops strictly inside the teaser's validation strip (never
    seen in training)."""
    from ..data.device_bank import build_crop_bank, load_teaser_images

    images, has_val = load_teaser_images()
    cb = build_crop_bank(images, has_val, patch=patch)
    crops = []
    for k in range(cb.num_images):
        if cb.val_x0[k] < 0:
            continue
        h, w = cb.hw[k]
        x0 = int(cb.val_x0[k])
        if w - x0 < patch:
            continue
        for oy in range(0, int(h) - patch + 1, patch):
            crops.append(cb.bank[k, oy:oy + patch, x0:x0 + patch]
                         .astype(np.float32) / 255.0)
    return crops


def region_crops(region: str, patch=256):
    """256x256 crops tiling one whole teaser region (e.g. 'd0', a
    photograph held out of training entirely)."""
    from ..data.device_bank import (TEASER_PATH, TEASER_REGIONS,
                                    resize_lanczos)
    from ..data.images import read_image

    im = read_image(TEASER_PATH)
    y0, y1, x0, x1 = TEASER_REGIONS[region]
    reg = im[y0:y1, x0:x1]
    h, w = reg.shape[:2]
    crops = []
    for oy in range(0, h - patch + 1, patch):
        for ox in range(0, w - patch + 1, patch):
            crops.append(reg[oy:oy + patch, ox:ox + patch]
                         .astype(np.float32) / 255.0)
    if not crops:  # region smaller than the patch: upscale once
        crops.append(resize_lanczos(reg, patch, patch).astype(np.float32)
                     / 255.0)
    return crops


def photo768_crops():
    """768x512 photographic crops of the teaser (3 crops of its main photo
    + the held-out d0 panel scaled to 768x512), as ``bench.photo_images``
    cuts them (crops 0, 3, 5 and 6 of its seven)."""
    from ..data.device_bank import (TEASER_PATH, TEASER_REGIONS,
                                    resize_lanczos)
    from ..data.images import read_image

    im = read_image(TEASER_PATH)
    y0, y1, x0, x1 = TEASER_REGIONS["main"]
    main = im[y0:y1, x0:x1]
    h, w = main.shape[:2]
    pool = [main[oy:oy + 512, ox:ox + 768] for oy in (0, h - 512)
            for ox in (0, (w - 768) // 2, w - 768)]
    dy0, dy1, dx0, dx1 = TEASER_REGIONS["d0"]
    pool.append(resize_lanczos(im[dy0:dy1, dx0:dx1], 768, 512))
    return [pool[i].astype(np.float32) / 255.0 for i in (0, 3, 5, 6)]


def group_crops(name: str, images, patch: int = 256):
    """The crops of one ``--regions`` group: from the teaser when it
    exists, else tiles of ``images``."""
    from ..data.device_bank import TEASER_PATH

    if os.path.exists(TEASER_PATH):
        return (heldout_crops(patch) if name == "val"
                else photo768_crops() if name == "photo768"
                else region_crops(name, patch))
    if name == "photo768":
        raise FileNotFoundError(f"the photo768 group needs the teaser image "
                                f"({TEASER_PATH})")
    if images is None:
        raise FileNotFoundError(f"teaser image not found ({TEASER_PATH}): "
                                f"pass --images DIR")
    return image_tiles(images, patch)


def pick_which(ckpt: str, which):
    """``which``, else "best" when the directory has one (npz or Orbax),
    else "last"."""
    from ..convert import checkpoint_source

    return which or ("best" if checkpoint_source(ckpt, "best")[0]
                     else "last")


def est_bits_levels(model, x: torch.Tensor, qualities) -> list:
    """Bits of the plain forward's likelihoods at each of ``qualities`` (0
    first), from one multi-quality forward: the front, hyperprior and
    entropy-parameter chains run once instead of once per quality (the JAX
    tool runs ``forward_single_quality`` per quality), and each level's
    likelihoods are that forward's (equal within 1e-7 relative)."""
    with torch.no_grad():
        o = model.multi_quality(x, list(qualities), training=False)
        lik = o["likelihoods"]
        z = float((-torch.log2(lik["z"].float())).sum())
        levels = [lik["y"]] + list(lik.get("y_prog", ()))
        return [float((-torch.log2(y.float())).sum()) + z for y in levels]


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("ckpt")
    p.add_argument("--which", default=None, help="best|last (auto)")
    p.add_argument("--out", default=None)
    p.add_argument("--compute_dtype", default="bfloat16")
    p.add_argument("--regions", nargs="+", default=["val"],
                   help="crop groups: 'val' (training-photo val strip) "
                        "and/or teaser region names like 'd0' (held-out "
                        "photograph)")
    p.add_argument("--images", default=None,
                   help="a directory of images whose 256x256 tiles are the "
                        "crops when the teaser image is absent")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from ..codec import (PICCodec, progressive_decode_all,
                         progressive_encode, progressive_encode_start)
    from ..convert import load_checkpoint
    from ..utils.metrics import per_level_msssim

    which = pick_which(args.ckpt, args.which)
    model, cfg, step = load_checkpoint(
        args.ckpt, which, config_overrides={
            "compute_dtype": args.compute_dtype})
    print(f"# ckpt {args.ckpt}/{which} step {step} model {cfg.get('model')} "
          f"N={cfg.get('n')} M={cfg.get('m')}", flush=True)
    codec = PICCodec(model, device=args.device)
    model = codec.model

    def plain_est_bpp(crops):
        """The plain forward's estimated bpp at level 0 and each quality
        (the ``rems`` group shares its crops' values)."""
        x = codec.as_input(np.stack(crops))
        npix = x.shape[0] * x.shape[1] * x.shape[2]
        return np.asarray(est_bits_levels(model, x, [0.0] + list(Q_LIST))
                          ) / npix

    def eval_group(crops, est_bpp, rems=False):
        x = codec.as_input(np.stack(crops))
        x_np = np.stack(crops)
        npix = x.shape[0] * x.shape[1] * x.shape[2]

        # real codec: one progressive encode, all levels decoded; with
        # rems the chained REM checkpoints refine the coding params
        ckpts = None
        if rems:
            ckpts, prev = [], None
            for cl in model.check_levels:
                prev = codec.extract_checkpoint(x, cl, checkpoint_rep=prev)
                ckpts.append(prev)
        bs, bits = progressive_encode(codec, x, Q_LIST, rems=rems,
                                      y_checkpoints=ckpts)
        out = progressive_decode_all(codec, bs, rems=rems,
                                     y_checkpoints=ckpts)
        x_hat_t = out["x_hat"].float()  # [1+Q, B, H, W, 3]
        x_hat = x_hat_t.cpu().numpy()
        real_bpp = np.cumsum([bits[0] + bits[1]] + list(bits[2])) / npix

        # the single-stream layout pays two flushes per image (z + y) at
        # every level
        n_msgs = len(bs["z"]) + len(bs["y"])
        flush_bits = np.full(len(real_bpp), n_msgs * FLUSH_BYTES * 8.0)
        adj_bpp = real_bpp - flush_bits / npix
        mse = ((x_hat - x_np[None]) ** 2).mean(axis=(1, 2, 3, 4))
        psnr = -10 * np.log10(np.maximum(mse, 1e-12))
        msssim = per_level_msssim(x_hat_t, x.float()).cpu().numpy()
        msssim_db = -10.0 * np.log10(np.maximum(1.0 - msssim, 1e-12))


        gap_pct = np.abs(real_bpp - est_bpp) / np.maximum(est_bpp,
                                                          1e-9) * 100
        gap_adj_pct = np.abs(adj_bpp - est_bpp) / np.maximum(est_bpp,
                                                             1e-9) * 100

        # 0.05 dB tolerance: at q=10 the mask admits the lowest-std
        # elements, whose rounding noise can exceed the predicted-mean error
        mono_psnr = bool(np.all(np.diff(psnr) >= -0.05))
        mono_bpp = bool(np.all(np.diff(real_bpp) >= 0))
        return {
            **({"est_note": "est uses the plain (non-REM) forward"}
               if rems else {}),
            "n_crops": len(crops),
            "real_bpp": [round(float(b), 4) for b in real_bpp],
            "est_bpp": [round(float(b), 4) for b in est_bpp],
            "gap_pct": [round(float(g), 2) for g in gap_pct],
            "max_gap_pct": round(float(gap_pct.max()), 2),
            "flush_overhead_bpp": round(float(flush_bits[-1]) / npix, 4),
            "gap_excl_flush_pct": [round(float(g), 2)
                                   for g in gap_adj_pct],
            "max_gap_excl_flush_pct": round(float(gap_adj_pct.max()), 2),
            "psnr": [round(float(p_), 2) for p_ in psnr],
            "msssim_db": [round(float(m_), 2) for m_ in msssim_db],
            "monotone_psnr": mono_psnr,
            "monotone_bpp": mono_bpp,
            "criteria": {
                "top_bpp_lt_2": bool(real_bpp[-1] < 2.0),
                "psnr_gt_28": bool(psnr[-1] > 28.0),
                "gap_lt_5pct": bool(gap_adj_pct.max() < 5.0),
                "monotone": mono_psnr and mono_bpp,
            },
        }

    def rem_per_quality(crops, qualities=(1.0, 2.0, 4.0, 10.0)):
        """Per-quality real-codec RD, plain vs REM-refined coding params:
        for q > check_levels[0] the bank refines (mu, scale) from the
        decoded checkpoint latent."""
        x = codec.as_input(np.stack(crops[:4]))
        npix = x.shape[0] * x.shape[1] * x.shape[2]

        def nbits(out):
            y_strings, z_strings = out["strings"]
            return (sum(len(s) for sl in y_strings for s in sl)
                    + sum(len(s) for s in z_strings)) * 8.0

        ck, cks = None, []
        for cl in model.check_levels:
            ck = codec.extract_checkpoint(x, float(cl), checkpoint_rep=ck)
            cks.append(ck)
        rows = []
        for q in qualities:
            if q <= model.check_levels[0]:
                continue
            o_plain = codec.compress(x, float(q))
            o_rem = codec.compress(x, float(q), checkpoint_rep=cks[-1])
            d_plain = codec.decompress(o_plain)
            d_rem = codec.decompress(o_rem, checkpoint_rep=cks[-1])
            mse_p = float(torch.mean((d_plain["x_hat"].float() - x) ** 2))
            mse_r = float(torch.mean((d_rem["x_hat"].float() - x) ** 2))
            bpp_p, bpp_r = nbits(o_plain) / npix, nbits(o_rem) / npix
            rows.append({
                "q": q,
                "bpp": round(bpp_p, 4), "bpp_rem": round(bpp_r, 4),
                "psnr": round(-10 * np.log10(max(mse_p, 1e-12)), 2),
                "psnr_rem": round(-10 * np.log10(max(mse_r, 1e-12)), 2),
                "rate_saving_pct": round((bpp_p - bpp_r) / bpp_p * 100, 2),
            })
        return rows

    def shell_table(crops, group):
        """Per-shell table: for every quality shell j the rate / quality
        increments of the decoded ladder and what the shell codes (element
        count, share of nonzero symbols, mean |symbol|, mean predicted
        sigma of its elements)."""
        x = codec.as_input(np.stack(crops[:4]))
        st = progressive_encode_start(codec, x, Q_LIST)
        sym = st["psym"].cpu().numpy()
        sid = st["sid"].cpu().numpy()
        scale = st["scale_s"].float().cpu().numpy()
        g = group
        rows = []
        for j, q in enumerate(Q_LIST):
            m = sid == j
            cnt = int(m.sum())
            s_j = sym[m]
            d_bpp = g["real_bpp"][j + 1] - g["real_bpp"][j]
            d_psnr = g["psnr"][j + 1] - g["psnr"][j]
            rows.append({
                "q": q, "elems": cnt,
                "d_bpp": round(float(d_bpp), 5),
                "d_psnr": round(float(d_psnr), 3),
                "db_per_bpp": round(float(d_psnr / d_bpp), 2)
                if d_bpp > 1e-9 else None,
                "nonzero_frac": round(float((s_j != 0).mean()), 4)
                if cnt else 0.0,
                "mean_abs_sym": round(float(np.abs(s_j).mean()), 4)
                if cnt else 0.0,
                "mean_sigma": round(float(scale[m].mean()), 4)
                if cnt else 0.0,
            })
        never = int((sid >= len(Q_LIST)).sum())
        return {"per_shell": rows, "never_coded_elems": never,
                "total_elems": int(sid.size)}

    groups = {}
    is_rem = hasattr(model, "check_levels") and cfg.get("model") == "rem"
    for name in args.regions:
        crops = group_crops(name, args.images)
        print(f"# group {name}: {len(crops)} 256x256 crops", flush=True)
        est = plain_est_bpp(crops)
        groups[name] = eval_group(crops, est)
        groups[name]["shells"] = shell_table(crops, groups[name])
        if is_rem:
            # the ladder through the chained-REM coding path
            groups[name + "_rem"] = eval_group(crops, est, rems=True)
            # per-quality REM rate savings
            groups[name]["rem_per_quality"] = rem_per_quality(crops)

    first = groups[args.regions[0]]
    res = {
        "checkpoint": f"{args.ckpt}/{which}@{step}",
        "model": {k: cfg.get(k) for k in
                  ("model", "n", "m", "division", "dim_chunk")},
        "levels": [0.0] + list(Q_LIST),
        "n_heldout_crops": first["n_crops"],
        **{k: v for k, v in first.items() if k != "n_crops"},
        "groups": groups,
    }
    if len(args.regions) > 1 and "d0" in groups:
        # train-content vs unseen-photograph delta
        res["d0_vs_val_psnr_delta_top"] = round(
            groups["d0"]["psnr"][-1] - first["psnr"][-1], 2)
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
