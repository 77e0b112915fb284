"""Convert a checkpoint directory (``config.json`` + ``last.npz`` /
``best.npz``, e.g. one ``cli.train`` wrote in float32, or the Orbax
``last/`` / ``best/`` of the JAX trainer) into the compact
committed-artifact format: ``config.json`` + ``last.npz`` in bfloat16, the
stacked heads' dead rows zeroed, compressed (``training.checkpoint.
save_artifact``). Prints one JSON line: src, out, step, size_mb. Runs on
the host alone (numpy and torch on the CPU).

    python -m epic_tpu_torch.tools.make_artifact SRC_DIR DST_DIR [--which best]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--which", default=None,
                   help="best | last (default: best when the source has "
                        "one, as best.npz or an Orbax best/)")
    args = p.parse_args(argv)

    from ..convert import checkpoint_source, load_checkpoint
    from ..training.checkpoint import save_artifact

    which = args.which or ("best" if checkpoint_source(args.src, "best")[0]
                           else "last")
    model, config, step = load_checkpoint(args.src, which)
    out = save_artifact(args.dst, model, config, step)
    rec = {"src": f"{args.src}/{which}", "out": out, "step": step,
           "size_mb": round(os.path.getsize(out) / 1e6, 1)}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])
