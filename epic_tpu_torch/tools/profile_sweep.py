"""Where the GPU time of the port's workloads goes.

First the serial main-path sweep of ``tools/workload.py`` (the one
chip_smoke.py drives: the full-width flagship ``rem`` model, bf16, random
weights from seed 0, synthetic 768x512 image, ``progressive_encode`` with
REMs, then ``progressive_decode`` of levels 0..15 and
``progressive_decode_all``) three times without the profiler and once
under ``torch.profiler``: the wall time of each sweep and of its three
stages with their device / host rANS split, the summed device-kernel time
and the device's busy share (against the profiled wall and against the
median unprofiled wall), device time by kernel family, and the top kernels
by device time.

Then ``bench.py``'s pipelined loop (``workload.bench_loop``: 24 images in
batches of 4, ``SweepPipeline`` with 2 workers on their own CUDA streams):
once unprofiled (img/s, sequential img/s, overlap speedup, the split, peak
memory), then its timed region with 2 and 1 workers in turns (2, 1, 1, 2),
then once under the profiler: the device busy
share as the union of kernel intervals over all streams (kernels of two
streams may overlap), the kernel time per stream and by family. Needs one
CUDA device.

    python3 -m epic_tpu_torch.tools.profile_sweep [--trace sweep.json]
        [--pipelined-only]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

import epic_tpu_torch as et
from epic_tpu_torch.tools.workload import (bench_batches, bench_loop,
                                          full_width_codec, images,
                                          pipelined_sweeps, sweep)

# (family, substrings of the lower-cased kernel name); the first match wins
FAMILIES = (
    ("GDN / IGDN backward (csrc/gdn_bwd.cu)", ("gdn_bwd_kernel",
                                               "gdn_bwd_reduce_kernel")),
    ("GDN / IGDN kernel (csrc/gdn.cu)", ("gdn_kernel",)),
    ("optimizer (multi-tensor)", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel",)),
    ("cuDNN convolutions", ("conv", "cudnn", "implicit", "wgrad", "dgrad",
                            "nhwcaddpadding")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "gemv", "cutlass", "xmma")),
    ("softmax", ("softmax",)),
    ("dtype casts and strided copies", ("bfloat16_copy", "direct_copy")),
    ("adds", ("functor_add", "functoronself_add", "functoronother_add")),
    ("cat / roll / gather", ("catarray", "roll_cuda", "gather")),
    ("activations (GELU, tanh, sigmoid)", ("gelu", "tanh", "sigmoid")),
    ("sort / scan", ("sort", "scan")),
    ("copies (memcpy)", ("memcpy",)),
    ("memsets", ("memset",)),
)


def family(name: str) -> str:
    low = name.lower()
    for label, keys in FAMILIES:
        if any(k in low for k in keys):
            return label
    return "other elementwise"


def busy_us(kernels) -> float:
    """Microseconds in which at least one kernel ran: the union of the
    kernels' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    total, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def device_kernels(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def print_families(kernels, total_us: float) -> None:
    by_family = defaultdict(float)
    for e in kernels:
        by_family[family(e.name)] += e.time_range.elapsed_us()
    for label, us in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {label:34s} {us / 1e3:9.2f} ms  "
              f"{100 * us / max(total_us, 1e-9):5.1f}%")


def profile_serial(codec, trace) -> None:
    x, warm = images()

    def run(img, timing=None):
        sweep(codec, img, timing)
        torch.cuda.synchronize()

    run(warm)
    walls, stages = [], []
    for _ in range(3):
        timing = {}
        t0 = time.perf_counter()
        run(x, timing)
        walls.append(time.perf_counter() - t0)
        stages.append(timing)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(x)
        wall = time.perf_counter() - t0
    if trace:
        os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
        prof.export_chrome_trace(trace)

    kernels = device_kernels(prof)
    total_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    nq = len(et.DEFAULT_Q_LIST)
    plain = float(np.median(walls))
    print(f"sweep (encode with REMs + decode of levels 0..{nq} + decode_all)"
          f" without the profiler: walls "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms, median "
          f"{plain * 1e3:.1f} ms")
    for stage in ("encode", "decode", "decode_all"):
        print(f"  {stage}: " + "; ".join(
            f"device {t[stage]['device_s'] * 1e3:.1f} ms + host rANS "
            f"{t[stage]['rans_s'] * 1e3:.1f} ms" for t in stages))
    print(f"profiled sweep: wall {wall * 1e3:.1f} ms; device kernels "
          f"{total_us / 1e3:.1f} ms in {len(kernels)} launches; device busy "
          f"{100 * total_us / 1e6 / wall:.1f}% of the profiled wall, "
          f"{100 * total_us / 1e6 / plain:.1f}% of the median unprofiled "
          "wall")
    print_families(kernels, total_us)
    print("top 25 kernels by device time:")
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:25]:
        print(f"  {us / 1e3:9.3f} ms  {n:5d}x  {name[:110]}")


def profile_pipelined(codec) -> None:
    res = bench_loop(codec)
    sp = res["split"]
    print(f"bench loop ({res['n_images']} images, batch 4, "
          f"{sp['workers']} workers, max_in_flight {sp['workers']}) without "
          f"the profiler: {res['elapsed_s']:.3f} s, {res['img_per_s']:.3f} "
          f"img/s; sequential {sp['sequential_img_per_s']:.3f} img/s "
          f"(sweeps {', '.join(f'{t:.3f}' for t in sp['sequential_sweeps_s'])}"
          f" s); overlap speedup {sp['overlap_speedup']:.3f}; peak memory "
          f"{res['peak_mem_bytes'] / 2**30:.2f} GiB")
    print("  split: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in sp.items() if k not in ("finish_phases",
                                            "sequential_sweeps_s")))
    batches = bench_batches()[1:]
    # does a second worker help? in turns: 2, 1, 1, 2 workers
    walls = {1: [], 2: []}
    for w in (2, 1, 1, 2):
        walls[w].append(pipelined_sweeps(codec, batches, w)["elapsed_s"])
    print("timed region by workers (max_in_flight = workers), in turns 2, 1,"
          " 1, 2: " + "; ".join(
              f"{w} worker(s) " + ", ".join(
                  f"{len(batches) * 4 / t:.3f}" for t in ts) + " img/s"
              for w, ts in sorted(walls.items())))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run = pipelined_sweeps(codec, batches)
    wall_us = run["elapsed_s"] * 1e6
    kernels = device_kernels(prof)
    total_us = sum(e.time_range.elapsed_us() for e in kernels)
    union = busy_us(kernels)
    by_stream = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        key = getattr(e, "device_resource_id", None)
        by_stream[key][0] += e.time_range.elapsed_us()
        by_stream[key][1] += 1
    print(f"profiled pipelined region: wall {wall_us / 1e3:.1f} ms "
          f"({len(batches) * 4 / run['elapsed_s']:.3f} img/s); device "
          f"kernels {total_us / 1e3:.1f} ms in {len(kernels)} launches; "
          f"device busy (union over streams) {union / 1e3:.1f} ms = "
          f"{100 * union / wall_us:.1f}% of the profiled wall, "
          f"{100 * union / 1e6 / res['elapsed_s']:.1f}% of the unprofiled "
          "wall")
    for key, (us, n) in sorted(by_stream.items(), key=lambda kv: -kv[1][0]):
        print(f"  stream {key}: {us / 1e3:9.2f} ms in {n} launches")
    print_families(kernels, total_us)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace of the profiled serial sweep "
                    "here")
    ap.add_argument("--pipelined-only", action="store_true",
                    help="skip the serial sweep")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    codec = full_width_codec(0)
    if not args.pipelined_only:
        profile_serial(codec, args.trace)
    profile_pipelined(codec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
