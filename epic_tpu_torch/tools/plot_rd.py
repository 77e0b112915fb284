"""Overlay a checkpoint's rate-distortion curve on the published anchor
curves. Input: an evaluation JSON with ``checkpoint`` and either
``real_bpp`` / ``psnr`` lists or ``groups`` of them (the format of
``artifacts/*/eval_heldout.json``).

    python -m epic_tpu_torch.tools.plot_rd EVAL_JSON [--out rd.png]

Prints the plot's path, or "matplotlib unavailable".
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("eval_json")
    p.add_argument("--out", default="rd.png")
    args = p.parse_args(argv)

    from ..utils.plot import plot_rate_distortion

    with open(args.eval_json) as f:
        ev = json.load(f)

    results = {}
    groups = ev.get("groups") or {"heldout": ev}
    for name, g in groups.items():
        label = f"epic_tpu_torch {ev['checkpoint'].split('/')[-2]} ({name})"
        results[label] = {"bpp": g["real_bpp"], "psnr": g["psnr"]}
    out = plot_rate_distortion(
        results, args.out,
        title="epic_tpu_torch (held-out) vs published Kodak anchors")
    print(out or "matplotlib unavailable")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
