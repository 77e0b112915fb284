"""The port's workloads, shared by chip_smoke.py and
``tools/profile_sweep.py`` so the two drive the same things, on the
flagship ``rem`` configuration (``artifacts/ckpt_r5_flagship/config.json``:
N=192, M=640, division (320, 640), dim_chunk 32, support 5, ParamNet
widths 224-176-128-64, check levels (0.25, 0.75), mu_std, "middle" REMs,
bf16 compute) with random weights from a seed:

- ``sweep``: one seeded synthetic 768x512 image, batch 1, serial:
  ``progressive_encode`` with ``DEFAULT_Q_LIST`` and ``rems=True``,
  ``progressive_decode`` of levels 0..15 with one cache and the encoder's
  checkpoint latents, then ``progressive_decode_all`` of the same stream;
- ``bench_loop``: the timed loop of the JAX package's ``bench.py``:
  its 24 synthetic 768x512 images in batches of 4 through
  ``SweepPipeline`` (2 workers, at most 2 sweeps in flight; encode with
  REMs, ``progressive_decode_all``), then two sequential sweeps and the
  per-level PSNR / MS-SSIM of the first two sweeps."""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..codec import (DEFAULT_Q_LIST, PICCodec, SweepPipeline,
                     progressive_decode, progressive_decode_all,
                     progressive_encode, progressive_encode_finish,
                     progressive_encode_start)
from ..models import get_model
from ..utils.metrics import per_level_msssim, per_level_psnr
from ..utils.synthetic import synth_images, synthetic_image, to_f32

H, W = 512, 768
PIC = dict(n=192, m=640, division=(320, 640), dim_chunk=32,
           support_progressive_slices=5,
           param_net_widths=(224, 176, 128, 64), compute_dtype="bfloat16")
FLAGSHIP = dict(PIC, check_levels=(0.25, 0.75), mu_std=True,
                rem_dimension="middle")
# bench.py's loop: images, sweep batch, pipeline workers (= max_in_flight)
N_IMAGES, BATCH, WORKERS = 24, 4, 2


def full_width_codec(seed: int = 0, device=None,
                     name: str = "rem") -> PICCodec:
    """The full-width model (the flagship ``rem`` configuration, or its
    ``pic`` half without REMs) in bf16, weights from ``seed``."""
    config = FLAGSHIP if name == "rem" else PIC
    return PICCodec(get_model(name, **config).init_weights(seed),
                    device=device)


def images() -> Tuple[np.ndarray, np.ndarray]:
    """(image, warm-up image): the synthetic H x W image and its mirror, so
    a warm-up run codes other data than the measured one."""
    x = synthetic_image(H, W)
    return x, np.ascontiguousarray(x[:, :, ::-1])


def decode_levels(codec: PICCodec, bitstreams: Dict[str, Any],
                  timing: Optional[Dict[str, float]] = None,
                  rems: bool = False, y_checkpoints=None
                  ) -> Iterator[Tuple[int, Dict[str, Any]]]:
    """Decode levels 0..Q one after another with one cache; yields (level,
    the ``progressive_decode`` result)."""
    cache: Dict[str, Any] = {}
    for lvl in range(len(bitstreams["q_list"]) + 1):
        yield lvl, progressive_decode(codec, bitstreams, lvl, cache, rems,
                                      y_checkpoints, timing)


def sweep(codec: PICCodec, x, timing: Optional[Dict[str, Dict]] = None
          ) -> Dict[str, Any]:
    """The main path once: encode (REMs on for a ``rem`` model), decode of
    levels 0..Q, decode of all levels at once. ``timing`` gets one timing
    dict per stage ("encode", "decode", "decode_all"). Returns the stream,
    the encoder's state and the decoded x_hat of both decoders."""
    timing = timing if timing is not None else {}
    for k in ("encode", "decode", "decode_all"):
        timing.setdefault(k, {})
    rems = hasattr(codec.model, "check_levels")
    state: Dict[str, Any] = {}
    bs, bits = progressive_encode(codec, x, rems=rems,
                                  timing=timing["encode"], state=state)
    ckpts = state["auto_ckpts"]
    levels = [out["x_hat"] for _, out in decode_levels(
        codec, bs, timing["decode"], rems, ckpts)]
    out_all = progressive_decode_all(codec, bs, rems, ckpts,
                                     timing["decode_all"])
    return {"bitstreams": bs, "bits": bits, "state": state,
            "levels": levels, "x_hat_all": out_all["x_hat"]}


def barrier(codec: PICCodec) -> None:
    """Wait for all of the codec's device work (every stream)."""
    if codec.device.type == "cuda":
        torch.cuda.synchronize(codec.device)


def bench_batches(n_images: int = N_IMAGES,
                  batch: int = BATCH) -> List[np.ndarray]:
    """``bench.py``'s images: n_images // batch + 1 uint8 batches
    [batch, 512, 768, 3] from ``default_rng(0)``; the first is the
    warm-up's."""
    n_sweeps = max(n_images // batch, 1)
    pool = synth_images(batch * (n_sweeps + 1), np.random.default_rng(0))
    return [np.stack(pool[k * batch:(k + 1) * batch])
            for k in range(n_sweeps + 1)]


def serial_sweep(codec: PICCodec, x, q_list=None,
                 timing: Optional[Dict[str, float]] = None
                 ) -> Dict[str, Any]:
    """One sweep without the pipeline: encode (REMs on for a ``rem``
    model), then ``progressive_decode_all``. ``timing`` gets the encode's
    dispatch seconds under "device_s" (``progressive_encode_start``)."""
    rems = hasattr(codec.model, "check_levels")
    st = progressive_encode_start(codec, x, q_list, rems, timing=timing)
    bs, bits = progressive_encode_finish(codec, st)
    out = progressive_decode_all(codec, bs, rems, st["auto_ckpts"])
    return {"bitstreams": bs, "bits": bits, "x": st["x"],
            "ckpts": st["auto_ckpts"], "x_hat": out["x_hat"]}


def pipelined_sweeps(codec: PICCodec, batches, workers: int = WORKERS,
                     q_list=None, on_result=None) -> Dict[str, Any]:
    """The timed region of ``bench_loop``: the uint8 ``batches`` through
    ``SweepPipeline`` (``max_in_flight=workers``), each uploaded as
    ``bench.py`` does, x_hat dropped as it comes (after
    ``on_result(k, res)``, if given), then one device barrier. Returns
    the wall, the pipeline and the per-sweep bits and bpp by level."""
    rems = hasattr(codec.model, "check_levels")
    q_list = list(q_list or DEFAULT_Q_LIST)
    pipe = SweepPipeline(codec, q_list, rems=rems, workers=workers,
                         max_in_flight=workers)
    bits, bpp, kept = [], [], []
    t0 = time.perf_counter()
    for k, res in enumerate(pipe.run(to_f32(u8, codec.device)
                                     for u8 in batches)):
        b = res["bits"]
        px = res["x"].shape[0] * res["x"].shape[1] * res["x"].shape[2]
        bits.append(b[0] + b[1] + sum(b[2]))
        bpp.append(np.cumsum([b[0] + b[1]] + list(b[2])) / px)
        if on_result is not None:
            on_result(k, res)
        if k < 2:
            kept.append((res["bitstreams"], res["x"], res["ckpts"]))
        del res
    barrier(codec)
    return {"elapsed_s": time.perf_counter() - t0, "pipe": pipe,
            "bits": bits, "bpp": bpp, "kept": kept}


def bench_loop(codec: PICCodec, n_images: int = N_IMAGES,
               batch: int = BATCH, workers: int = WORKERS,
               q_list=None) -> Dict[str, Any]:
    """``bench.py``'s measurement (its lines 283-383) on the port: a
    warm-up sweep, the pipelined sweeps of ``pipelined_sweeps`` (timed),
    two sequential sweeps of the warm-up batch (timed one by one), then
    the per-level PSNR and MS-SSIM of the first two pipelined sweeps,
    re-decoded from their bitstreams (the decode is deterministic).

    Returns "img_per_s", "elapsed_s", "n_images", "split" (host phases
    summed over the threads, wall and CPU; the coders' rANS seconds and
    symbols; "sequential_img_per_s", "sequential_sweeps_s", the mean
    encode dispatch of a sequential sweep "sequential_encode_start_s",
    "overlap_speedup"),
    "bpp", "psnr" and "msssim" by level (means over the sweeps measured)
    and, on a GPU, "peak_mem_bytes" of the pipelined region."""
    rems = hasattr(codec.model, "check_levels")
    images = bench_batches(n_images, batch)
    dev = codec.device
    out = serial_sweep(codec, to_f32(images[0], dev), q_list)
    per_level_psnr(out["x_hat"], out["x"])
    per_level_msssim(out["x_hat"], out["x"])
    del out
    barrier(codec)
    coders = (codec.y_coder, codec.z_coder)
    for c in coders:
        c.stats.update({k: type(v)(0) for k, v in c.stats.items()})
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run = pipelined_sweeps(codec, images[1:], workers, q_list)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    stats = [dict(c.stats) for c in coders]
    pipe, elapsed = run["pipe"], run["elapsed_s"]
    n_done = len(run["bits"]) * batch
    split = {"encode_start_s": pipe.timing["encode_start_s"],
             "encode_finish_s": pipe.timing["encode_finish_s"],
             "decode_host_s": pipe.timing["decode_s"],
             **{k: v for k, v in pipe.timing.items() if "_cpu_" in k},
             "host_rans_s": sum(s["encode_s"] + s["decode_s"]
                                for s in stats),
             "host_rans_msyms": sum(s["encode_syms"] + s["decode_syms"]
                                    for s in stats) / 1e6,
             "finish_phases": dict(pipe.finish_phases),
             "pipelined": True, "workers": pipe.workers}
    seq, seq_start = [], {}
    for _ in range(2):
        t = time.perf_counter()
        serial_sweep(codec, to_f32(images[0], dev), q_list, seq_start)
        barrier(codec)
        seq.append(time.perf_counter() - t)
    seq_img_per_s = batch / (sum(seq) / len(seq))
    split.update(sequential_img_per_s=seq_img_per_s, sequential_sweeps_s=seq,
                 sequential_encode_start_s=seq_start["device_s"] / len(seq),
                 overlap_speedup=(n_done / elapsed) / seq_img_per_s)
    psnr, msssim = [], []
    for bs, x, ckpts in run["kept"]:
        x_hat = progressive_decode_all(codec, bs, rems, ckpts)["x_hat"]
        psnr.append(per_level_psnr(x_hat, x).cpu().numpy())
        msssim.append(per_level_msssim(x_hat, x).cpu().numpy())
    return {"img_per_s": n_done / elapsed, "elapsed_s": elapsed,
            "n_images": n_done, "split": split,
            "bpp": np.mean(run["bpp"], axis=0), "psnr": np.mean(psnr, 0),
            "msssim": np.mean(msssim, 0), "peak_mem_bytes": peak}
