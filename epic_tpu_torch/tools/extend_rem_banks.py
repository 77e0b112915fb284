"""Extend a trained REM checkpoint to more check levels, as the JAX
package's ``tools/extend_rem_banks.py`` does, on the port's checkpoints.

REM bank j covers the quality bracket (c_j, c_{j+1}], so a trained bank is
re-indexed to whichever new bank has the same lower bracket edge; a new
edge gets a fresh bank. The fresh bank is the port's own draw (the
``StackedConv.init_`` of that one bank from a ``torch.Generator`` seeded
``seed + j``), which cannot equal the JAX tool's flax draw. The result is
a resumable ``rems``-stage checkpoint (``save_checkpoint``, step 0, in the
npz layout both packages read) with ``progress.json`` ``{"stage": "rems",
"next_step": 1, ...}`` beside it, from which ``cli.train_device``
resumes: only the fresh bank starts cold.

Usage:
  python -m epic_tpu_torch.tools.extend_rem_banks SRC_CKPT DST_STAGE_DIR \\
      --check_levels 0.25 0.75
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def fresh_bank(model, j: int, seed: int):
    """Draw bank j of ``model`` afresh (its StackedConv layers, from a
    generator seeded ``seed``) and return it as a JAX-layout tree."""
    from ..convert import to_jax_params
    from ..ops.rem import StackedConv

    gen = torch.Generator().manual_seed(seed)
    for mod in model.bank(j).modules():
        if isinstance(mod, StackedConv):
            mod.init_(gen)
    return to_jax_params(model)[f"post_latent_{j}"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("src", help="trained REM checkpoint dir")
    p.add_argument("dst", help="output stage dir (e.g. runs/r5/rems)")
    p.add_argument("--check_levels", type=float, nargs="+", required=True)
    p.add_argument("--which", default="last")
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)

    from ..convert import (_model_from_config, from_jax_params,
                           load_checkpoint, to_jax_params)
    from ..training.checkpoint import save_checkpoint

    model, config, step = load_checkpoint(args.src, args.which)
    old = [float(c) for c in config["check_levels"]]
    new = [float(c) for c in args.check_levels]
    if not all(a < b for a, b in zip(new, new[1:])):
        raise SystemExit(f"check_levels must be increasing: {new}")

    config = dict(config, check_levels=new)
    name = config.pop("model", "rem")
    config = {k: list(v) if isinstance(v, tuple) else v
              for k, v in config.items()}
    new_model = _model_from_config(dict(config, model=name))
    config["model"] = name

    params = to_jax_params(model)
    trained = {old[j]: params.pop(f"post_latent_{j}")
               for j in range(len(old)) if f"post_latent_{j}" in params}
    kept, cold = 0, 0
    src_shapes = None
    for j, edge in enumerate(new):
        bank = trained.get(edge)
        if bank is not None:
            kept += 1
            src_shapes = _shapes(bank)
        else:
            cold += 1
            bank = fresh_bank(new_model, j, args.seed + j)
        params[f"post_latent_{j}"] = bank
    if kept:
        # fresh banks must be shape-identical to trained ones
        for j in range(len(new)):
            if _shapes(params[f"post_latent_{j}"]) != src_shapes:
                raise SystemExit(f"bank {j} shape mismatch vs trained bank")
    new_model.load_state_dict(from_jax_params(params, new_model))

    os.makedirs(args.dst, exist_ok=True)
    save_checkpoint(args.dst, new_model, config, step=0)
    print(f"wrote {args.dst}: check_levels {old} -> {new} "
          f"({kept} trained banks re-indexed, {cold} fresh), "
          f"src step {step}")

    run_dir = os.path.dirname(os.path.abspath(args.dst))
    prog = {"stage": "rems", "next_step": 1, "lr": None,
            "best_loss": None, "plateau": 0}
    with open(os.path.join(run_dir, "progress.json"), "w") as f:
        json.dump(prog, f)
    print(f"progress journal -> {run_dir}/progress.json (resume @ step 1)")
    return new_model, config


if __name__ == "__main__":
    main(sys.argv[1:])
