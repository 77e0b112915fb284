"""Where the GPU time of a training step goes, at flagship width.

Each stage of ``cli.train_device``'s curriculum on the flagship
configuration (``tools/workload.py``: first_train, refine_gs and
refine_gs_ga on ``pic``, rems on ``rem`` with the parent's weights and
fresh REM banks; bf16, random weights from seed 0), batches drawn on the
device from ``bench.py``'s synthetic images (batch 16, patch 256 by
default, ``train_device``'s defaults), a quality and lambda drawn per step
as the trainer does. Per stage: warm-up steps, then ``--steps`` steps
with a device sync after each (steps/s, peak memory), then as many under
``torch.profiler`` (device busy share of the wall, kernel launches and
device time per step, device time by kernel family with the GDN forward
and backward kernels apart). Needs one CUDA device.

    python3 -m epic_tpu_torch.tools.profile_train [--steps 5] [--batch 16]
        [--stages first_train,rems]
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from epic_tpu_torch.data.device_bank import (build_crop_bank,
                                             make_device_sampler)
from epic_tpu_torch.device import resolve_device
from epic_tpu_torch.models import get_model
from epic_tpu_torch.tools.profile_sweep import (busy_us, device_kernels,
                                                print_families)
from epic_tpu_torch.tools.workload import FLAGSHIP, PIC
from epic_tpu_torch.training.checkpoint import merge_params
from epic_tpu_torch.training.stages import STAGES, draw_quality, make_stage
from epic_tpu_torch.training.state import TrainState
from epic_tpu_torch.training.step import make_ckpt_extractor, make_train_step
from epic_tpu_torch.utils.synthetic import synth_images


def stage_model(stage: str, model):
    """The model that ``stage`` trains, on ``model``'s device: ``model``
    itself; for rems a flagship ``rem`` with fresh REM banks (weights from
    seed 1) and ``model``'s weights everywhere else (``merge_params``), as
    ``train_device`` hands a stage its parent's weights."""
    if stage != "rems":
        return model
    dev = next(model.parameters()).device
    rem = get_model("rem", **FLAGSHIP).init_weights(1)
    rem.load_state_dict(merge_params(rem.state_dict(), model.state_dict()))
    return rem.to(dev)


def stage_runner(model, stage: str, sampler, dev):
    """(run, state): ``run()`` takes one training step of ``stage`` on a
    new batch from ``sampler`` (a quality and lambda drawn and, in rems,
    the checkpoint latent computed, as ``train_device.run`` does) and
    returns its metrics; ``state`` is the stage's ``TrainState``. The
    noise, batch and quality draws are seeded with 0, 1 and 0."""
    plan = make_stage(stage, check_levels=FLAGSHIP["check_levels"],
                      check_levels_np=(24, 24))
    state = TrainState(model, stage)
    step = make_train_step(model, plan)
    extractor = make_ckpt_extractor(model, plan.rems) if plan.rems else None
    noise = torch.Generator(device=dev).manual_seed(0)
    data = torch.Generator(device=dev).manual_seed(1)
    qrng = np.random.default_rng(0)

    def run():
        batch = sampler(data)
        if not plan.sampling:
            return step(state, batch, noise)
        q, lm = draw_quality(plan, qrng)
        ckpt = extractor(batch, q) if extractor else None
        return step(state, batch, noise, q, lm, ckpt)

    return run, state


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--patch", type=int, default=256)
    ap.add_argument("--stages", default=",".join(STAGES),
                    help="the stages to run, in curriculum order")
    args = ap.parse_args(argv)
    stages = [s for s in STAGES if s in args.stages.split(",")]
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[profile_train] {smi}; batch {args.batch} x {args.patch}^2, "
          f"{args.steps} timed + {args.steps} profiled steps per stage",
          flush=True)
    imgs = synth_images(8, np.random.default_rng(0))
    cb = build_crop_bank(imgs, None, args.patch)
    sampler = make_device_sampler(cb, args.patch, args.batch, dev)
    model = get_model("pic", **PIC).init_weights(0).to(dev)
    for stage in stages:
        model = stage_model(stage, model)
        run, _ = stage_runner(model, stage, sampler, dev)
        for _ in range(args.warmup):
            run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        walls = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = device_kernels(prof)
        total = sum(e.time_range.elapsed_us() for e in kernels)
        print(f"[{stage}] step wall s: "
              + " ".join(f"{w:.4f}" for w in walls)
              + f" (median {np.median(walls):.4f}, "
              f"{1 / np.median(walls):.3f} steps/s); peak memory "
              f"{peak / 2**30:.2f} GiB; profiled: {len(kernels) / args.steps:.0f}"
              f" kernel launches and {total / 1e3 / args.steps:.2f} ms of "
              f"device kernels per step, device busy "
              f"{100 * busy_us(kernels) / 1e6 / wall:.1f}% of the "
              f"{wall / args.steps:.4f} s profiled step", flush=True)
        print_families(kernels, total)


if __name__ == "__main__":
    main()
