"""Demo: code one image file and report rate and quality, as the JAX
package's ``cli/demo.py`` (flags: ``utils.parser.parse_demo_args``, plus
``--device``; the GPU unless ``--device cpu``).

- WACNN (``cnn``): one buffered y stream and one z stream per image.
- ``--fast_encdec``: random-access coding at each ``--q_levs`` quality
  (``training.evaluate.compress_with_ac``).
- otherwise one progressive bitstream (written to ``save_path/bits.epic``),
  then the requested levels decoded one after another with one cache: per
  level bpp, PSNR and decode time; ``--save_recon`` writes each level's
  PNG.

    python -m epic_tpu_torch.cli.demo --checkpoint CKPT --path_image IMG.png
"""

from __future__ import annotations

import os
import sys
import time


def main(argv=None):
    from ..codec import (PICCodec, dump_bitstreams, progressive_decode,
                         progressive_encode)
    from ..data.images import load_image
    from ..data.png import to_uint8, write_png
    from ..training.evaluate import compress_with_ac, extract_checkpoints
    from ..utils.metrics import compute_psnr
    from ..utils.padding import pad_image, unpad_image
    from ..utils.parser import parse_demo_args
    from .codec import build_model

    args = parse_demo_args(argv)
    if not os.path.isfile(args.path_image):
        raise SystemExit(f"image not found: {args.path_image}")
    model = build_model(args.checkpoint, args.tiny, args.model)
    codec = PICCodec(model, device=args.device)
    img = load_image(args.path_image)
    x = codec.as_input(img)[None]
    xp, unpad = pad_image(x)
    npix = x.shape[1] * x.shape[2]

    check_levels = (list(model.check_levels)
                    if args.rems and hasattr(model, "check_levels") else None)

    if not model.progressive:
        # WACNN: single-quality buffered coding, one y and one z stream
        t0 = time.time()
        out = codec.compress(xp, quality=0, buffered=True)
        enc_s = time.time() - t0
        t0 = time.time()
        dec = codec.decompress(out)
        codec.synchronize()
        dec_s = time.time() - t0
        x_hat = unpad_image(dec["x_hat"], unpad)
        y_strings, z_strings = out["strings"]
        bits = (sum(len(s) for sl in y_strings for s in sl)
                + sum(len(s) for s in z_strings)) * 8.0
        psnr = compute_psnr(x, x_hat)
        print(f"wacnn: bpp={bits / npix:.4f} psnr={psnr:.2f} "
              f"enc={enc_s * 1000:.0f}ms dec={dec_s * 1000:.0f}ms")
        return [{"q_ind": 0, "bpp": bits / npix, "psnr": psnr,
                 "time": dec_s}]

    if args.fast_encdec:
        res = compress_with_ac(codec, [img], pr_list=args.q_levs,
                               check_levels=check_levels)
        for q, b, p, t in zip(res["pr_list"], res["bpp"], res["psnr"],
                              res["decode_time"]):
            print(f"q={q:<6} bpp={b:.4f} psnr={p:.2f} "
                  f"dec={t * 1000:.0f}ms")
        return res

    y_checkpoints = (extract_checkpoints(codec, xp, check_levels)
                     if check_levels else None)
    t0 = time.time()
    bs, bits = progressive_encode(codec, xp, args.q_levs,
                                  rems=bool(y_checkpoints),
                                  y_checkpoints=y_checkpoints)
    print(f"encoded in {time.time() - t0:.2f}s | z {bits[0] / npix:.4f} bpp, "
          f"base {bits[1] / npix:.4f} bpp, shells "
          f"{[round(b / npix, 4) for b in bits[2]]}")
    os.makedirs(args.save_path, exist_ok=True)
    blob = dump_bitstreams(bs)
    path = os.path.join(args.save_path, "bits.epic")
    with open(path, "wb") as f:
        f.write(blob)
    print(f"container: {len(blob)} bytes -> {path}")

    levels = args.requested_levels or list(range(len(args.q_levs) + 1))
    cache, results = {}, []
    for q_ind in levels:
        t0 = time.time()
        out = progressive_decode(codec, bs, q_ind, cache,
                                 rems=bool(y_checkpoints),
                                 y_checkpoints=y_checkpoints)
        dec_s = time.time() - t0
        x_hat = unpad_image(out["x_hat"], unpad)
        psnr = compute_psnr(x, x_hat)
        if args.save_recon:
            write_png(os.path.join(args.save_path,
                                   f"recon_level{q_ind:02d}.png"),
                      to_uint8(x_hat[0].float().cpu().numpy()))
        cum_bits = bits[0] + bits[1] + sum(bits[2][:q_ind])
        label = "base" if q_ind == 0 else f"q={args.q_levs[q_ind - 1]}"
        print(f"level {q_ind:>2} ({label:<8}) bpp={cum_bits / npix:.4f} "
              f"psnr={psnr:.2f} dec={dec_s * 1000:.0f}ms")
        results.append({"q_ind": q_ind, "bpp": cum_bits / npix,
                        "psnr": psnr, "time": dec_s})
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
