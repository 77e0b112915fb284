"""File codec: an image file into a standalone ``.epic`` container, and the
container back into an image file at any progressive level. Flags and
container layout are the JAX package's ``cli/codec.py``'s, plus
``--device`` (the GPU unless ``--device cpu``); images are read by
``data/images.py`` (JPEG, PNG, BMP, Netpbm, chosen by their first bytes)
and written as PNG by ``data/png.py``.

- A progressive model (``pic``, ``rem``) is coded once into the
  single-bitstream layout with ``--q_levs``. A ``rem`` model's file also
  carries its check-level streams (real transmitted bits), and
  ``decompress`` rebuilds the checkpoint latents from them alone.
- WACNN (``cnn``) is coded as one buffered stream per image, wrapped in
  the container's ``ckpt_streams[0]`` with ``meta.single``.

Usage:
  python -m epic_tpu_torch.cli.codec compress IMG.png OUT.epic \\
      --checkpoint CKPT
  python -m epic_tpu_torch.cli.codec decompress OUT.epic RECON.png \\
      --checkpoint CKPT [--level K]
  python -m epic_tpu_torch.cli.codec info OUT.epic

``--tiny`` builds the small test configuration with the port's
``init_weights(0)`` (not the JAX package's flax init, so a tiny file is
read across packages only through a shared checkpoint directory).
"""

from __future__ import annotations

import argparse
import sys
import time

Q_LEVS = [0.01, 0.05, 0.1, 0.25, 0.5, 0.6, 0.7, 0.8, 0.9, 1, 2, 3, 4, 4.5,
          10]
TINY = dict(n=16, m=32, division=(16, 32), dim_chunk=8,
            param_net_widths=(24, 16))


def parse_args(argv=None):
    p = argparse.ArgumentParser("epic_tpu_torch file codec")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress", help="image file -> .epic container")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("--checkpoint", default="none")
    c.add_argument("--model", default="rem", choices=["pic", "rem", "cnn"])
    c.add_argument("--tiny", action="store_true", default=False,
                   help="small random-init model (pipeline test)")
    c.add_argument("--q_levs", type=float, nargs="+", default=Q_LEVS)
    c.add_argument("--no_rems", action="store_true", default=False,
                   help="skip REM refinement even if the model has banks")
    c.add_argument("--device", default=None, help="cuda (default) or cpu")

    d = sub.add_parser("decompress", help=".epic container -> image file")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--checkpoint", default="none")
    d.add_argument("--model", default="rem", choices=["pic", "rem", "cnn"])
    d.add_argument("--tiny", action="store_true", default=False)
    d.add_argument("--level", type=int, default=-1,
                   help="progressive level (0=base, default=max)")
    d.add_argument("--device", default=None, help="cuda (default) or cpu")

    i = sub.add_parser("info", help="print container layout/sizes")
    i.add_argument("input")
    return p.parse_args(argv)


def build_model(checkpoint: str, tiny: bool, name: str):
    """The model of ``--checkpoint`` or, with ``--tiny``, the tiny
    configuration of ``name`` with ``init_weights(0)``."""
    from ..convert import load_checkpoint
    from ..models import get_model

    if checkpoint != "none":
        return load_checkpoint(checkpoint)[0]
    if tiny:
        cfg = dict(TINY)
        if name == "rem":
            cfg.update(check_levels=(0.5, 2.0), rem_dimension="middle")
        return get_model(name, **cfg).init_weights(0)
    raise SystemExit("need --checkpoint or --tiny")


def _build_codec(args):
    from ..codec import PICCodec

    return PICCodec(build_model(args.checkpoint, args.tiny, args.model),
                    device=args.device)


def decode_checkpoints(codec, ckpt_streams):
    """The REM checkpoint latents rebuilt on the receiver's side from the
    embedded check-level streams, each conditioned on the one before."""
    y_checkpoints, prev = [], None
    for st in ckpt_streams:
        st = dict(st, shape=tuple(st["shape"]))
        prev = codec.decompress(st, checkpoint_rep=prev)["y_hat"]
        y_checkpoints.append(prev)
    return y_checkpoints


def _stream_record(out, quality: float):
    return {"strings": out["strings"], "shape": list(out["shape"]),
            "quality": quality, "buffered": bool(out.get("buffered")),
            "io_chain": bool(out.get("io_chain"))}


def cmd_compress(args):
    from ..codec import dump_bitstreams, progressive_encode
    from ..data.images import load_image
    from ..utils.padding import pad_image

    codec = _build_codec(args)
    model = codec.model
    x = codec.as_input(load_image(args.input))[None]
    h, w = int(x.shape[1]), int(x.shape[2])
    xp, _ = pad_image(x)

    t0 = time.time()
    if not model.progressive:
        # WACNN: one buffered stream, in the container's aux slot
        out = codec.compress(xp, quality=0, buffered=True)
        bs = {"q_list": [], "shape": tuple(out["shape"]), "z": [],
              "base": [], "progressive": [], "layout": "messages",
              "ckpt_streams": [_stream_record(out, 0.0)],
              "meta": {"orig_size": [h, w], "single": True}}
    else:
        check_levels = (list(getattr(model, "check_levels", ()) or ())
                        if not args.no_rems else [])
        ckpt_streams, y_checkpoints, prev = [], [], None
        for cl in check_levels:
            out = codec.compress(xp, quality=float(cl), return_latents=True,
                                 checkpoint_rep=prev)
            ckpt_streams.append(_stream_record(out, float(cl)))
            prev = out["y_hat"] if float(cl) > 0 else out["y_hat_base"]
            y_checkpoints.append(prev)
        bs, bits = progressive_encode(codec, xp, args.q_levs,
                                      rems=bool(y_checkpoints),
                                      y_checkpoints=y_checkpoints or None)
        bs["ckpt_streams"] = ckpt_streams
        bs["meta"] = {"orig_size": [h, w],
                      "check_levels": [float(c) for c in check_levels],
                      "rems": bool(y_checkpoints),
                      "bits": [float(bits[0]), float(bits[1]),
                               [float(b) for b in bits[2]]]}
    blob = dump_bitstreams(bs)
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"{args.input} [{h}x{w}] -> {args.output}: {len(blob)} bytes "
          f"({len(blob) * 8.0 / (h * w):.4f} bpp file, incl. container "
          f"header) in {time.time() - t0:.2f}s")
    return len(blob)


def cmd_decompress(args):
    from ..codec import load_bitstreams, progressive_decode
    from ..data.png import to_uint8, write_png
    from ..utils.padding import compute_padding, unpad_image

    codec = _build_codec(args)
    with open(args.input, "rb") as f:
        bs = load_bitstreams(f.read())
    meta = bs.get("meta") or {}
    h, w = meta.get("orig_size", (None, None))

    t0 = time.time()
    if meta.get("single"):
        st = dict(bs["ckpt_streams"][0])
        st["shape"] = tuple(st["shape"])
        x_hat = codec.decompress(st)["x_hat"]
    else:
        rems = bool(meta.get("rems"))
        y_checkpoints = (decode_checkpoints(codec, bs["ckpt_streams"])
                         if rems else None)
        nl = len(bs["q_list"])
        level = args.level if args.level >= 0 else nl
        if level > nl:
            raise SystemExit(f"level {level} > max {nl}")
        x_hat = progressive_decode(codec, bs, level, cache={}, rems=rems,
                                   y_checkpoints=y_checkpoints)["x_hat"]
    if h is not None:
        _, unpad = compute_padding(int(h), int(w))
        x_hat = unpad_image(x_hat, unpad)
    arr = to_uint8(x_hat[0].float().cpu().numpy())
    write_png(args.output, arr)
    print(f"{args.input} -> {args.output} "
          f"[{arr.shape[0]}x{arr.shape[1]}] in {time.time() - t0:.2f}s")
    return arr


def cmd_info(args):
    import numpy as np

    from ..codec import load_bitstreams

    with open(args.input, "rb") as f:
        data = f.read()
    bs = load_bitstreams(data)
    meta = bs.get("meta") or {}
    print(f"{args.input}: {len(data)} bytes, layout={bs['layout']}, "
          f"levels={len(bs['q_list'])}, z_shape={bs['shape']}, "
          f"meta={meta}")
    if bs.get("layout") == "stream" and "prefix" in bs:
        pfx = np.asarray(bs["prefix"])
        for b in range(pfx.shape[0]):
            print(f"  img {b}: per-level y-prefix bytes {pfx[b].tolist()}")
    return bs


def main(argv=None):
    args = parse_args(argv)
    if args.cmd == "compress":
        return cmd_compress(args)
    if args.cmd == "decompress":
        return cmd_decompress(args)
    return cmd_info(args)


if __name__ == "__main__":
    main(sys.argv[1:])
