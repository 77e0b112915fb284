"""Command-line arguments of the demo (``cli.demo``), flag for flag as the
JAX package's ``utils.parser.parse_demo_args``, plus ``--device``."""

from __future__ import annotations

import argparse


def parse_demo_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("epic_tpu_torch demo")
    p.add_argument("--checkpoint", default="none")
    p.add_argument("--model", default="pic", choices=["pic", "rem", "cnn"])
    p.add_argument("--rems", action="store_true", default=False)
    p.add_argument("--fast_encdec", action="store_true", default=False)
    p.add_argument("--path_image", required=True)
    p.add_argument("--q_levs", type=float, nargs="+",
                   default=[0.01, 0.05, 0.1, 0.25, 0.5, 0.6, 0.7, 0.8, 0.9,
                            1, 2, 3, 4, 4.5, 10])
    p.add_argument("--requested_levels", type=int, nargs="+", default=None)
    p.add_argument("--save_path", default="./demo_out")
    p.add_argument("--save_recon", action="store_true", default=False,
                   help="write per-level reconstruction PNGs to save_path")
    # tiny-model knob for running without a trained checkpoint
    p.add_argument("--tiny", action="store_true", default=False)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)
