"""Multi-process progressive RD sweep over a sharded image list.

Each process codes its ``local_shard`` of the global image list with its
own host rANS coder (``progressive_encode`` + ``progressive_decode_all``
at Q_LIST); the per-image rows ``[id, bpp x (1+Q), psnr x (1+Q)]``
(float32) are gathered over gloo, sorted by image id, and process 0 prints
them as one ``RDSWEEP {json}`` line. The arithmetic does not depend on the
number of processes, so the rows are the same for any count.

    # one process, the whole list (the tiny model on 64x64 images):
    python -m epic_tpu_torch.tools.multihost_rd_sweep --device cpu

    # one of two processes over localhost, each sharding the same list:
    python -m epic_tpu_torch.tools.multihost_rd_sweep --num_processes 2 \\
        --process_id {0,1} --coordinator localhost:PORT

The model is the tiny ``pic`` with weights from seed 1 (the same on every
process) unless ``main`` is given another model config. Processes
may share one GPU: the group's collectives run on host tensors (gloo).
Entry points run on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, Optional

import numpy as np

Q_LIST = [0.5, 2.0, 10.0]
TINY = dict(n=16, m=32, division=(16, 32), dim_chunk=8,
            param_net_widths=(24, 16))
SEED = 1


def synth_image(i: int, size: int = 64, width: Optional[int] = None
                ) -> np.ndarray:
    """Image i of the list, [size, width (default size), 3] float32 in
    [0, 1]: waves whose periods depend on i, plus N(0, 0.03) noise from
    seed 100 + i (the JAX package's tool's images for a square size)."""
    w = size if width is None else width
    yy, xx = np.mgrid[0:size, 0:w].astype(np.float32)
    img = np.stack([
        0.5 + 0.5 * np.sin(xx / (5 + 2 * i)) * np.cos(yy / 7),
        0.5 + 0.4 * np.cos(xx / 9 + yy / (11 + i)),
        (xx + yy) / (size + w),
    ], -1)
    rng = np.random.default_rng(100 + i)
    return np.clip(img + rng.normal(0, 0.03, img.shape), 0, 1) \
        .astype(np.float32)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0")
    p.add_argument("--n_images", type=int, default=4)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--width", type=int, default=None,
                   help="default: the height")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None, model_config: Optional[Dict[str, Any]] = None
         ) -> Optional[Dict[str, Any]]:
    """Run this process's part of the sweep. Returns the merged result on
    process 0 (also printed as the RDSWEEP line), None on the others."""
    args = parse_args(argv)
    import torch
    import torch.distributed as dist

    from ..codec import PICCodec, progressive_decode_all, progressive_encode
    from ..models import get_model
    from ..parallel import init_multihost, local_shard

    t0 = time.perf_counter()
    distributed = init_multihost(
        args.coordinator, args.num_processes if args.num_processes > 1
        else None, args.process_id, backend="gloo")
    if distributed:
        dist.barrier()  # every process up before the work starts
    model = get_model("pic", **(model_config or TINY)).init_weights(SEED)
    codec = PICCodec(model, device=args.device)
    mine = local_shard(list(range(args.n_images)))
    rows = []
    t_code = time.perf_counter()
    for i in mine:
        x = synth_image(i, args.height, args.width)[None]
        bs, bits = progressive_encode(codec, x, Q_LIST)
        x_hat = progressive_decode_all(codec, bs)["x_hat"].float().cpu() \
            .numpy()  # [1+Q, 1, H, W, 3]
        bpp = np.cumsum([bits[0] + bits[1]] + list(bits[2])) / (
            x.shape[1] * x.shape[2])
        mse = ((x_hat[:, 0] - x[0]) ** 2).mean(axis=(1, 2, 3))
        psnr = -10 * np.log10(np.maximum(mse, 1e-12))
        rows.append([float(i)] + [round(float(b), 6) for b in bpp]
                    + [round(float(p), 4) for p in psnr])
    code_s = time.perf_counter() - t_code
    width = 1 + 2 * (len(Q_LIST) + 1)
    local = np.asarray(rows, np.float32).reshape(-1, width)
    if distributed:
        # equal-sized pieces for all_gather: pad with id -1 rows
        per = -(-args.n_images // args.num_processes)
        padded = np.full((per, width), -1.0, np.float32)
        padded[:len(local)] = local
        parts = [torch.empty((per, width)) for _ in range(
            args.num_processes)]
        dist.all_gather(parts, torch.from_numpy(padded))
        merged = torch.cat(parts).numpy()
        merged = merged[merged[:, 0] >= 0]
    else:
        merged = local
    merged = merged[np.argsort(merged[:, 0], kind="stable")]
    rank = dist.get_rank() if distributed else 0
    if distributed:
        dist.destroy_process_group()
    if rank != 0:
        return None
    res = {
        "processes": args.num_processes, "n_images": int(merged.shape[0]),
        "q_list": Q_LIST,
        "rows": [[round(float(v), 6) for v in r] for r in merged],
        "mean_bpp_top": round(float(merged[:, len(Q_LIST) + 1].mean()), 6),
        "mean_psnr_top": round(float(merged[:, -1].mean()), 4),
        "code_s": code_s, "total_s": time.perf_counter() - t0,
    }
    print("RDSWEEP " + json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
