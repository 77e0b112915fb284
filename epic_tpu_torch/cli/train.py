"""The host-loader trainer: one stage of the curriculum (first_train ->
refine_gs -> refine_gs_ga -> rems) per launch, as the JAX package's
``cli/train.py``. Per epoch: ``steps_per_epoch`` batches of random crops
from a folder of images (``data/datasets.py``, 8 loader threads), the
stage's step on each, an entropy-estimation validation, a plateau
learning-rate drop, best / last checkpoints with the config embedded;
every ``eval_every`` epochs and at the last, the real codec on the first 4
test images (``compress_with_ac``), ``test_epoch`` and an RD plot.

    python -m epic_tpu_torch.cli.train --training_type first_train \\
        --training_dataset DIR --test_dataset DIR --save_path DIR
    python -m epic_tpu_torch.cli.train --training_type rems --model rem \\
        --checkpoint DIR/refine_gs_ga ...

A stage resumes from ``--checkpoint`` (a ``rem`` model from a ``pic``
checkpoint gets fresh REM banks over the parent's weights) or starts from
a fresh init, with ``--checkpoint_base``'s matching arrays merged in. The
model is float32. It runs on the GPU unless ``--device cpu`` is given, and
raises without one. The fresh init (``init_weights(seed)``) and the
training noise (a ``torch.Generator`` seeded with ``--seed``) cannot equal
the JAX package's ``jax.random`` draws; the batches and the sampled
qualities do (the same ``random.Random`` and numpy generators).
"""

from __future__ import annotations

import itertools
import os
import sys
import time
from typing import Optional

import numpy as np

from ..training.checkpoint import merge_params

# the JAX CLI's partial merge from a base checkpoint: every array whose
# name and shape match
_merge_matching = merge_params


def main(argv=None) -> dict:
    """Run one stage as ``argv`` says (``utils.parser.parse_train_args``).
    Returns {"save_dir", "steps", "steps_per_s" (the steps alone, batch
    loads excluded), "peak_mem_bytes" (on a GPU, else None), "timers"
    (``Timers.summary()``: load, step, valid, eval, save), "train_loss",
    "val" (the last validation), "real" (the last real-codec evaluation),
    "plot" (its path, or None without matplotlib), "lr"}."""
    import torch

    from ..codec import PICCodec
    from ..convert import load_checkpoint
    from ..data import ImageFolder, TestImageDataset, data_loader
    from ..device import resolve_device
    from ..models import get_model
    from ..training.checkpoint import save_checkpoint
    from ..training.evaluate import compress_with_ac
    from ..training.stages import draw_quality, make_stage
    from ..training.state import TrainState, set_learning_rate
    from ..training.step import (make_ckpt_extractor, make_eval_step,
                                 make_train_step, make_valid_loss_step,
                                 test_epoch, valid_epoch)
    from ..utils.parser import model_config_from_args, parse_train_args
    from ..utils.plot import plot_rate_distortion
    from ..utils.profiling import Timers

    args = parse_train_args(argv)
    dev = resolve_device(args.device)
    np_rng = np.random.default_rng(args.seed)
    noise = torch.Generator(device=dev).manual_seed(args.seed)

    # ---- model: from a checkpoint's config or from the arguments ----
    if args.checkpoint != "none":
        overrides = {}
        if args.model == "rem":
            overrides = {"model": "rem",
                         "check_levels": tuple(args.check_levels),
                         "mu_std": args.mu_std,
                         "rem_dimension": args.dimension}
        # a pic checkpoint with the REM overrides: the rem model, its banks
        # fresh from init_weights(seed), the parent's weights merged in
        model, cfg, start_step = load_checkpoint(
            args.checkpoint, config_overrides=overrides,
            disable_rems_if_missing=False, seed=args.seed)
    else:
        cfg = model_config_from_args(args)
        model = get_model(args.model, **cfg).init_weights(args.seed)
        cfg["model"] = args.model
        if args.checkpoint_base != "none":
            base = load_checkpoint(args.checkpoint_base)[0]
            model.load_state_dict(_merge_matching(model.state_dict(),
                                                  base.state_dict()))
        start_step = 0
    model.to(dev).train()

    # ---- stage plan / state ----
    plan = make_stage(args.training_type, tuple(args.lmbda_list),
                      tuple(args.check_levels), tuple(args.check_levels_np),
                      unfreeze_lrp=args.lrp)
    state = TrainState(model, args.training_type, args.learning_rate,
                       args.aux_learning_rate, args.clip_max_norm, args.lrp)
    train_step = make_train_step(model, plan)
    eval_step = make_eval_step(model)
    valid_loss_step = make_valid_loss_step(model, plan)
    ckpt_extractor = (make_ckpt_extractor(model, plan.rems) if plan.rems
                      else None)

    # ---- data ----
    train_set = ImageFolder(args.training_dataset, "train", args.patch_size,
                            args.num_images)
    train_set, valid_set = _validation_split(
        train_set, args.training_dataset, args.patch_size,
        args.num_images_val)
    test_set = TestImageDataset(args.test_dataset)

    def on_device(batches):
        for b in batches:
            yield torch.from_numpy(b).to(dev)

    best_loss = float("inf")
    lr = args.learning_rate
    plateau = 0
    save_dir = os.path.join(args.save_path, args.training_type)
    timers = Timers()
    report = {"save_dir": save_dir, "val": None, "real": None, "plot": None}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    for epoch in range(args.epochs):
        t0 = time.time()
        meters = {}
        loader = on_device(data_loader(train_set, args.batch_size,
                                       seed=args.seed + epoch,
                                       steps=args.steps_per_epoch))
        while True:
            with timers.time("load"):
                batch = next(loader, None)
            if batch is None:
                break
            with timers.time("step"):
                if plan.sampling:
                    q, lm = draw_quality(plan, np_rng)
                    ckpt_lat = (ckpt_extractor(batch, q) if ckpt_extractor
                                else None)
                    metrics = train_step(state, batch, noise, q, lm,
                                         ckpt_lat)
                else:
                    metrics = train_step(state, batch, noise)
                # reading the loss waits for the step's device work
                for k in ("loss", "bpp_loss", "bpp_hype", "aux_loss"):
                    if k in metrics:
                        meters.setdefault(k, []).append(float(metrics[k]))

        train_loss = float(np.mean(meters.get("loss", [np.nan])))

        # validation (rate estimated from the likelihoods)
        with timers.time("valid"):
            model.eval()
            vbatches = on_device(data_loader(valid_set,
                                             args.valid_batch_size,
                                             seed=1234, steps=4))
            val = valid_epoch(eval_step, vbatches,
                              loss_step=valid_loss_step)
            model.train()
        # the plateau steps on the stage criterion's validation loss
        val_loss = val["loss"]
        print(f"epoch {epoch}: train loss {train_loss:.4f} | "
              f"valid bpp {np.mean(val['bpp']):.4f} "
              f"psnr {np.mean(val['psnr']):.2f} | "
              f"{time.time() - t0:.0f}s", flush=True)

        if val_loss < best_loss - 1e-6:
            best_loss = val_loss
            plateau = 0
            is_best = True
        else:
            plateau += 1
            is_best = False
            if plateau > args.patience:
                lr *= args.lr_factor
                plateau = 0
                # the Adam moments survive the drop
                state = set_learning_rate(state, lr)
                print(f"  lr -> {lr:.2e}", flush=True)

        with timers.time("save"):
            save_checkpoint(save_dir, model, cfg,
                            step=start_step + (epoch + 1), is_best=is_best)

        # periodic real-codec evaluation and RD plot
        if (epoch + 1) % args.eval_every == 0 or epoch == args.epochs - 1:
            with timers.time("eval"):
                codec = PICCodec(model, device=dev)
                imgs = [img for img, _ in itertools.islice(test_set, 4)]
                real = compress_with_ac(codec, imgs,
                                        pr_list=(0, 0.5, 1, 2, 5, 10),
                                        check_levels=plan.rems)
                est = test_epoch(eval_step, on_device(i[None] for i in imgs))
                print(f"  real-codec bpp {real['bpp']} psnr {real['psnr']}",
                      flush=True)
                report["real"] = real
                report["plot"] = plot_rate_distortion(
                    {"epic_tpu_torch (real)": real,
                     "epic_tpu_torch (est)": est},
                    os.path.join(save_dir, f"rd_epoch{epoch}.png"))
            model.train()
        report.update(val=val, train_loss=train_loss)

    print("training done", flush=True)
    steps = timers.counts.get("step", 0)
    report.update(
        steps=steps, lr=lr, timers=timers.summary(),
        steps_per_s=steps / timers.totals["step"] if steps else None,
        peak_mem_bytes=(torch.cuda.max_memory_allocated(dev)
                        if dev.type == "cuda" else None))
    return report


def _validation_split(train_set, training_dataset: str, patch_size: int,
                      num_images_val: Optional[int]):
    """Return (train_set, valid_set). Prefers the dataset's own 'test'
    split; without one, carves a deterministic holdout (last ~10%, capped
    at 64 images) off the train list so plateau/best-checkpoint signals
    come from unseen data instead of the train set."""
    from ..data import ImageFolder

    try:
        return train_set, ImageFolder(training_dataset, "test", patch_size,
                                      num_images_val)
    except FileNotFoundError:
        pass
    if len(train_set.paths) >= 2:
        import copy

        n_hold = max(1, min(len(train_set.paths) // 10, 64))
        valid_set = copy.copy(train_set)
        valid_set.paths = train_set.paths[-n_hold:]
        train_set.paths = train_set.paths[:-n_hold]
        print(f"WARNING: no 'test' split under {training_dataset}; held "
              f"out the last {n_hold} train image(s) for validation",
              file=sys.stderr, flush=True)
        return train_set, valid_set
    print(f"WARNING: no 'test' split under {training_dataset} and only "
          "one train image; validating on the TRAIN set "
          "(plateau/best-checkpoint signals will be optimistic)",
          file=sys.stderr, flush=True)
    return train_set, train_set


if __name__ == "__main__":
    main(sys.argv[1:])
