"""Where ``progressive_decode_all`` and the per-level decode part ways.

``progressive_decode_all`` reconstructs every level at once with the levels
folded into the batch axis (batch Q = 15 for one image); the per-level
decode runs each level at batch 1. This tool runs the full-width flagship
``rem`` workload of ``tools/workload.py`` (random weights from seed 0, the
synthetic 768x512 image), encodes once, and then feeds the same inputs to
each stage of the reconstruction at batch 1 (one level at a time) and
folded (all levels at once), layer by layer: the LRP heads and merge
(``prog_latent``), then every layer of g_s, each given the batch-1 path's
own input so that only that layer's batch dependence shows. For every
stage it prints whether the folded output equals the batch-1 outputs
bitwise and the largest absolute difference, and for a stage that differs
the device kernels (``torch.profiler``) that only one of the two runs
launched. It does so in bf16 (the workload) and float32 compute, with
cuDNN on, and in bf16 with cuDNN off (PyTorch's own convolution kernels).
Needs one CUDA device.

    python3 -m epic_tpu_torch.tools.fold_diff
"""

from __future__ import annotations

import subprocess
import sys
from typing import Dict, List

import torch

import epic_tpu_torch as et
from epic_tpu_torch.tools.workload import FLAGSHIP, images


def _fold(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.repeat((n,) + (1,) * (t.dim() - 1))


def kernel_names(fn) -> set:
    """Names of the device kernels that fn launches."""
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA}


@torch.no_grad()
def stage_diffs(codec: et.PICCodec, st: Dict) -> List[tuple]:
    """[(stage, bitwise equal, max abs diff, (kernels only at batch 1,
    kernels only folded))] between the folded and the batch-1 computation
    of every level, stage by stage."""
    psym, sid, mu_s = st["psym"], st["sid"], st["mu_s"]
    msups, base = st["msups"], st["base_slices"]
    nq = 15
    model = codec.model
    # the LRP heads and merge: per-level latents at batch 1, and folded
    lat1 = [codec.prog_latent(psym * (sid.to(torch.int32) < lvl), mu_s,
                              msups, base) for lvl in range(1, nq + 1)]
    lvl = torch.arange(1, nq + 1, device=sid.device,
                       dtype=torch.int32).reshape(-1, 1, 1, 1, 1, 1)
    sym_l = psym[None] * (sid[None].to(torch.int32) < lvl)
    b = psym.shape[1]
    folded = []
    for i in range(psym.shape[0]):
        y_hat = (sym_l[:, i].to(torch.float32) + mu_s[i][None]).reshape(
            (nq * b,) + tuple(mu_s.shape[2:]))
        folded.append(model.finish_prog_slice(y_hat, _fold(msups[i], nq),
                                              _fold(base[i], nq), i))
    latf = torch.cat(folded, dim=-1)
    y0 = (sym_l[:, 0].to(torch.float32) + mu_s[0][None]).reshape(
        (nq * b,) + tuple(mu_s.shape[2:]))
    out = [_compare("LRP + merge (prog_latent)", torch.cat(lat1), latf,
                    lambda: model.finish_prog_slice(y0[:b], msups[0],
                                                    base[0], 0),
                    lambda: model.finish_prog_slice(
                        y0, _fold(msups[0], nq), _fold(base[0], nq), 0))]
    # g_s, one layer at a time, each fed the batch-1 path's input
    h1 = lat1
    for name, layer in model.g_s_1.named_children():
        nxt = [layer(h) for h in h1]
        hf = torch.cat(h1)
        out.append(_compare(f"g_s {name}", torch.cat(nxt), layer(hf),
                            lambda: layer(h1[0]), lambda: layer(hf)))
        h1 = nxt
    return out


def _compare(stage: str, one: torch.Tensor, folded: torch.Tensor,
             run_one, run_folded):
    diff = (one.float() - folded.float()).abs().max().item()
    equal = torch.equal(one, folded)
    kernels = (set(), set())
    if not equal:
        k1, kf = kernel_names(run_one), kernel_names(run_folded)
        kernels = (k1 - kf, kf - k1)
    return stage, equal, diff, kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    x, _ = images()
    for dtype, cudnn in (("bfloat16", True), ("float32", True),
                         ("bfloat16", False)):
        cfg = dict(FLAGSHIP, compute_dtype=dtype)
        codec = et.PICCodec(et.get_model("rem", **cfg).init_weights(0))
        st: Dict = {}
        et.progressive_encode(codec, x, rems=True, state=st)
        torch.backends.cudnn.enabled = cudnn
        try:
            rows = stage_diffs(codec, st)
        finally:
            torch.backends.cudnn.enabled = True
        print(f"compute {dtype}, cuDNN {'on' if cudnn else 'off'}: "
              "folded (batch 15) against batch 1, per stage")
        for stage, equal, diff, (only1, onlyf) in rows:
            print(f"  {stage:36s} {'bitwise equal' if equal else 'differs'}"
                  f", max abs diff {diff:.3e}")
            for label, names in (("batch 1 only", only1),
                                 ("folded only", onlyf)):
                for n in sorted(names):
                    print(f"      {label}: {n[:150]}")
        del codec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
