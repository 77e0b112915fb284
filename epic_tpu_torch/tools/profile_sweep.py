"""Where the GPU time of the port's main path goes.

Runs the main-path workload of ``tools/workload.py`` (the one chip_smoke.py
drives: the full-width flagship ``rem`` model, bf16, random weights from
seed 0, synthetic 768x512 image, ``progressive_encode`` with REMs, then
``progressive_decode`` of levels 0..15 and ``progressive_decode_all``)
three times without the profiler and once under ``torch.profiler``, and
prints: the wall time of each sweep and of its three stages with their
device / host rANS split, the summed device-kernel time and the device's
busy share (against the profiled wall and against the median unprofiled
wall), device time by kernel family, and the top kernels by device time.
Needs one CUDA device.

    python3 -m epic_tpu_torch.tools.profile_sweep [--trace sweep.json]
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
from epic_tpu_torch.tools.workload import full_width_codec, images, sweep

# (family, substrings of the lower-cased kernel name); the first match wins
FAMILIES = (
    ("GDN / IGDN kernel (csrc/gdn.cu)", ("gdn_kernel",)),
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None,
                    help="write a Chrome trace of the profiled sweep here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    codec = full_width_codec(0)
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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_family, by_name = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_family[family(e.name)] += us
        by_name[e.name][0] += us
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
    for label, us in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {label:34s} {us / 1e3:9.2f} ms  "
              f"{100 * us / max(total_us, 1e-9):5.1f}%")
    print("top 25 kernels by device time:")
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:25]:
        print(f"  {us / 1e3:9.3f} ms  {n:5d}x  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
