"""The four-stage trainer with device-resident data, in one resumable
process: first_train -> refine_gs -> refine_gs_ga -> rems, each with its
criterion, quality grid and freezing, a plateau learning-rate drop, and
checkpoints. The training data lives on the device (``data/device_bank``);
steps are counted per stage; progress is journaled in ``progress.json``
so that a killed process resumes mid-stage; a loss that stays non-finite
rewinds to the last checkpoint at half the learning rate (exit code 4).

    python -m epic_tpu_torch.cli.train_device --save_path runs/t1 \\
        --steps first_train=30000,refine_gs=6000,refine_gs_ga=6000,rems=4000

``--model cnn`` trains the single-quality WACNN, first_train only.

``main`` trains on the teaser photographs (read by ``data/png.py``; the
image must be present); ``run(args, images, has_val)`` trains on any uint8
images, e.g. ``utils.synthetic.synth_images``. It runs on the GPU unless
``--device cpu`` (or ``device="cpu"``) is given, and raises without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

STAGE_ORDER = ("first_train", "refine_gs", "refine_gs_ga", "rems")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="epic_tpu_torch device-data "
                                            "trainer")
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--model", type=str, default="pic",
                   choices=["pic", "cnn"],
                   help="cnn = the single-quality WACNN (first_train "
                        "only)")
    p.add_argument("--steps", type=str,
                   default="first_train=30000,refine_gs=6000,"
                           "refine_gs_ga=6000,rems=4000")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--N", type=int, default=128)
    p.add_argument("--M", type=int, default=320)
    p.add_argument("--division_dimension", type=int, nargs=2,
                   default=[160, 320])
    p.add_argument("--dim_chunk", type=int, default=32)
    p.add_argument("--support_progressive_slices", type=int, default=5)
    p.add_argument("--param_net_widths", type=int, nargs="+",
                   default=[224, 176, 128, 64])
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--lmbda_list", type=float, nargs="+",
                   default=[0.0055, 0.04])
    p.add_argument("--check_levels", type=float, nargs="+", default=[0.75])
    p.add_argument("--check_levels_np", type=int, nargs="+", default=[24])
    p.add_argument("--mu_std", action="store_true", default=True)
    p.add_argument("--rem_dimension", type=str, default="middle")
    p.add_argument("--lrp", action="store_true",
                   help="unfreeze lrp_prog in refine_gs")
    p.add_argument("--exclude_regions", type=str, nargs="*", default=[],
                   help="teaser regions held out of training entirely")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--aux_learning_rate", type=float, default=1e-3)
    p.add_argument("--clip_max_norm", type=float, default=1.0)
    p.add_argument("--patience", type=int, default=6,
                   help="plateau patience in val intervals")
    p.add_argument("--lr_factor", type=float, default=0.3)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--val_every", type=int, default=500)
    p.add_argument("--ckpt_every", type=int, default=2000)
    p.add_argument("--heartbeat", type=str, default="",
                   help="file touched at every log point (watchdog)")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def parse_steps(spec: str):
    out = {}
    for part in spec.split(","):
        name, _, n = part.partition("=")
        name = name.strip()
        if name not in STAGE_ORDER:
            raise ValueError(f"unknown stage {name!r}")
        out[name] = int(n)
    return [(s, out.get(s, 0)) for s in STAGE_ORDER if out.get(s, 0) > 0]


def model_config(args, rem: bool):
    if args.model == "cnn":  # WACNN pins division and branches itself
        return dict(n=args.N, m=args.M, dim_chunk=args.dim_chunk,
                    param_net_widths=tuple(args.param_net_widths),
                    compute_dtype=args.compute_dtype)
    cfg = dict(n=args.N, m=args.M,
               division=tuple(args.division_dimension),
               dim_chunk=args.dim_chunk,
               support_progressive_slices=args.support_progressive_slices,
               param_net_widths=tuple(args.param_net_widths),
               compute_dtype=args.compute_dtype)
    if rem:
        cfg.update(check_levels=tuple(args.check_levels),
                   mu_std=args.mu_std, rem_dimension=args.rem_dimension)
    return cfg


def _stage_params(stage_name, stages, model, save_path, resuming_here,
                  params, seed):
    """The state_dict a stage starts from: its own last checkpoint when
    resuming it; else the previous stage's weights (from memory, or from
    its checkpoint in a fresh process); else a fresh init. REM training on
    a model without banks gets fresh banks merged with the parent."""
    from ..convert import load_checkpoint
    from ..training.checkpoint import merge_params

    stage_dir = os.path.join(save_path, stage_name)
    if resuming_here and os.path.exists(os.path.join(stage_dir,
                                                     "config.json")):
        print(f"[{stage_name}] resumed params from {stage_dir}", flush=True)
        return load_checkpoint(stage_dir)[0].state_dict()
    if params is None and STAGE_ORDER.index(stage_name) > 0:
        names = [s for s, _ in stages]
        prev = names[names.index(stage_name) - 1]
        params = load_checkpoint(os.path.join(save_path, prev))[0] \
            .state_dict()
        print(f"[{stage_name}] loaded previous stage {prev}", flush=True)
    if params is None:
        model.init_weights(seed)
        n = sum(p.numel() for p in model.parameters())
        print(f"[{stage_name}] fresh init: {n / 1e6:.1f}M params",
              flush=True)
        return model.state_dict()
    if stage_name == "rems" and not any(k.startswith("post_latent_0")
                                        for k in params):
        model.init_weights(seed)
        print(f"[{stage_name}] fresh REM banks + merged parent", flush=True)
        return merge_params(model.state_dict(), params)
    return params


def run(args, images, has_val, device=None) -> dict:
    """Train on ``images`` (uint8 [H, W, 3] arrays; ``has_val`` marks those
    with a validation strip) as ``args`` (``parse_args``) say, on
    ``device`` (default ``args.device``, else the GPU). Returns
    {"stages": {stage: {"steps", "seconds" (the stage's wall),
    "train_seconds" (its steps alone, batches drawn and checkpoint latents
    included), "steps_per_s", "peak_mem_bytes" (on a GPU), "metrics" (the
    last log's), "val"}}, "model": the last stage's model}."""
    import numpy as np
    import torch

    from ..data.device_bank import (build_crop_bank, fixed_val_batches,
                                    make_device_sampler)
    from ..device import resolve_device
    from ..models import get_model
    from ..training.checkpoint import save_checkpoint
    from ..training.stages import draw_quality, make_stage
    from ..training.state import TrainState, set_learning_rate
    from ..training.step import (make_ckpt_extractor, make_eval_step,
                                 make_train_step, make_valid_loss_step,
                                 valid_epoch)

    dev = resolve_device(device if device is not None else args.device)
    stages = parse_steps(args.steps)
    is_cnn = args.model == "cnn"
    if is_cnn and [s for s, _ in stages] != ["first_train"]:
        raise SystemExit("--model cnn trains the single-quality WACNN: only "
                         "the first_train stage applies")
    os.makedirs(args.save_path, exist_ok=True)
    progress_path = os.path.join(args.save_path, "progress.json")
    log_path = os.path.join(args.save_path, "train_log.jsonl")

    def beat():
        if args.heartbeat:
            with open(args.heartbeat, "w") as f:
                f.write(str(time.time()))

    def jlog(rec):
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    progress = {"stage": stages[0][0], "next_step": 0, "lr": None,
                "best_loss": None, "plateau": 0}
    if os.path.exists(progress_path):
        with open(progress_path) as f:
            progress = json.load(f)
        print(f"resuming: {progress}", flush=True)

    def save_progress():
        with open(progress_path, "w") as f:
            json.dump(progress, f)

    t0 = time.time()
    cb = build_crop_bank(images, has_val, patch=args.patch_size)
    sampler = make_device_sampler(cb, args.patch_size, args.batch_size, dev)
    val_batches = fixed_val_batches(cb, args.patch_size,
                                    max(args.batch_size // 2, 2), dev, 2)
    print(f"crop bank: {cb.bank.shape} uint8 ({cb.bank.nbytes / 1e6:.0f} "
          f"MB), upload+val in {time.time() - t0:.0f}s", flush=True)
    beat()

    # the noise generator runs through every stage; a NaN rewind changes its
    # seed, so that a rewind before the stage's first checkpoint does not
    # replay the same noise
    noise = torch.Generator(device=dev).manual_seed(
        args.seed + 7919 * int(progress.get("nan_rewinds", 0)))
    data_gen = torch.Generator(device=dev)
    done_before = [s for s, _ in stages if STAGE_ORDER.index(s)
                   < STAGE_ORDER.index(progress["stage"])]
    report = {}
    params = model = None
    for stage_name, stage_steps in stages:
        if stage_name in done_before:
            continue
        stage_dir = os.path.join(args.save_path, stage_name)
        stage_is_current = stage_name == progress["stage"]
        resuming_here = stage_is_current and progress["next_step"] > 0
        is_rem = stage_name == "rems"
        cfg = model_config(args, rem=is_rem)
        name = "cnn" if is_cnn else ("rem" if is_rem else "pic")
        model = get_model(name, **cfg)
        cfg["model"] = name
        params = _stage_params(stage_name, stages, model, args.save_path,
                               resuming_here, params, args.seed)
        model.load_state_dict(params)
        model.to(dev).train()

        plan = make_stage(stage_name, tuple(args.lmbda_list),
                          tuple(args.check_levels),
                          tuple(args.check_levels_np),
                          unfreeze_lrp=args.lrp)
        # a journaled LR of this stage (a plateau drop or a NaN rewind)
        lr = progress["lr"] if (stage_is_current and progress["lr"]) else \
            args.learning_rate
        state = TrainState(model, stage_name, lr, args.aux_learning_rate,
                           args.clip_max_norm, args.lrp)
        train_step = make_train_step(model, plan)
        # WACNN has one quality: validation runs its base-only forward
        sq = 0.0 if is_cnn else None
        eval_step = make_eval_step(model, static_quality=sq)
        valid_loss_step = make_valid_loss_step(model, plan,
                                               static_quality=sq)
        ckpt_extractor = (make_ckpt_extractor(model, plan.rems)
                          if plan.rems else None)

        start = progress["next_step"] if resuming_here else 0
        best_loss = (progress["best_loss"]
                     if resuming_here and progress["best_loss"] is not None
                     else float("inf"))
        plateau = progress["plateau"] if resuming_here else 0
        progress.update(stage=stage_name, next_step=start, lr=lr,
                        best_loss=None if best_loss == float("inf")
                        else best_loss, plateau=plateau)
        save_progress()
        print(f"[{stage_name}] steps {start}..{stage_steps} lr {lr:.2e} "
              f"criterion {plan.criterion} sampling {plan.sampling}",
              flush=True)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t_stage = t_log = time.time()
        t_train = 0.0
        pending, m, val = None, {}, None
        nonfinite_logs = 0
        for step in range(start, stage_steps):
            t_step = time.perf_counter()
            # deterministic per step (resume-safe): the quality draw and
            # the batch
            qrng = np.random.default_rng(args.seed * 100003 + step)
            data_gen.manual_seed((args.seed + 1) * 1_000_003 + step)
            batch = sampler(data_gen)
            if plan.sampling:
                q, lm = draw_quality(plan, qrng)
                ckpt_lat = (ckpt_extractor(batch, q) if ckpt_extractor
                            else None)
                pending = train_step(state, batch, noise, q, lm, ckpt_lat)
            else:
                pending = train_step(state, batch, noise)
            t_train += time.perf_counter() - t_step

            gstep = step + 1
            if gstep % args.log_every == 0 or gstep == stage_steps:
                m = {k: float(v) for k, v in pending.items()
                     if v.dim() == 0}
                dt = time.time() - t_log
                t_log = time.time()
                sps = args.log_every / max(dt, 1e-9)
                print(f"[{stage_name}] {gstep}/{stage_steps} "
                      f"loss {m.get('loss', float('nan')):.4f} "
                      f"bpp {m.get('bpp_loss', float('nan')):.4f} "
                      f"({sps:.2f} steps/s)", flush=True)
                jlog({"stage": stage_name, "step": gstep, **m,
                      "steps_per_s": round(sps, 3), "ts": time.time()})
                beat()
                if not np.isfinite(m.get("loss", 0.0)):
                    # a skipped update survives one bad batch; a loss that
                    # stays non-finite means the forward itself diverged
                    nonfinite_logs += 1
                    print(f"non-finite loss ({nonfinite_logs}/3) — update "
                          "skipped", flush=True)
                    if nonfinite_logs >= 3:
                        rewinds = progress.get("nan_rewinds", 0) + 1
                        if rewinds > 6:
                            print("too many NaN rewinds — giving up",
                                  flush=True)
                            sys.exit(3)
                        progress.update(nan_rewinds=rewinds,
                                        lr=max(lr * 0.5, 1e-6))
                        save_progress()
                        print(f"non-finite loss persists — rewind "
                              f"{rewinds}: restoring last checkpoint, "
                              f"lr -> {progress['lr']:.2e}", flush=True)
                        sys.exit(4)
                else:
                    nonfinite_logs = 0

            if gstep % args.val_every == 0 or gstep == stage_steps:
                model.eval()
                val = valid_epoch(eval_step, val_batches,
                                  pr_list=(0.0,) if is_cnn
                                  else (0.5, 1, 2, 10),
                                  loss_step=valid_loss_step)
                model.train()
                vloss = val["loss"]
                print(f"[{stage_name}] val loss {vloss:.4f} "
                      f"bpp {np.round(val['bpp'], 3).tolist()} "
                      f"psnr {np.round(val['psnr'], 2).tolist()}",
                      flush=True)
                jlog({"stage": stage_name, "step": gstep, "val": val,
                      "ts": time.time()})
                is_best = vloss < best_loss - 1e-6
                if is_best:
                    best_loss = vloss
                    plateau = 0
                else:
                    plateau += 1
                    if plateau > args.patience:
                        lr *= args.lr_factor
                        plateau = 0
                        set_learning_rate(state, lr)
                        print(f"[{stage_name}] lr -> {lr:.2e}", flush=True)
                beat()
                if (gstep % args.ckpt_every == 0 or gstep == stage_steps
                        or is_best):
                    t_ck = time.time()
                    save_checkpoint(stage_dir, model, cfg, step=gstep,
                                    is_best=is_best)
                    progress.update(stage=stage_name, next_step=gstep,
                                    lr=lr, best_loss=best_loss,
                                    plateau=plateau)
                    save_progress()
                    print(f"[{stage_name}] ckpt @ {gstep} "
                          f"({time.time() - t_ck:.0f}s)", flush=True)
                    beat()

        params = model.state_dict()
        progress.update(stage=stage_name, next_step=stage_steps, lr=None,
                        best_loss=None, plateau=0)
        names = [s for s, _ in stages]
        i = names.index(stage_name)
        if i + 1 < len(names):
            progress.update(stage=names[i + 1], next_step=0)
        save_progress()
        seconds = time.time() - t_stage
        n_steps = stage_steps - start
        report[stage_name] = {
            "steps": n_steps, "seconds": seconds, "train_seconds": t_train,
            "steps_per_s": n_steps / t_train if t_train else None,
            "peak_mem_bytes": (torch.cuda.max_memory_allocated(dev)
                               if dev.type == "cuda" else None),
            "metrics": m, "val": val}
        print(f"[{stage_name}] done in {seconds:.0f}s", flush=True)
    print("curriculum complete", flush=True)
    return {"stages": report, "model": model}


def main(argv=None):
    args = parse_args(argv)
    from ..data.device_bank import load_teaser_images

    images, has_val = load_teaser_images(
        exclude=tuple(args.exclude_regions))
    run(args, images, has_val)


if __name__ == "__main__":
    main(sys.argv[1:])
