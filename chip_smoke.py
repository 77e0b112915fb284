"""Smoke run of epic_tpu_torch on one NVIDIA GPU: builds the kernels from the
repository's sources, holds every kernel against its plain PyTorch version,
then drives the main path once at full width and checks what comes out.

    python3 chip_smoke.py

Phases, one progress line each (flush=True):
 1. environment: torch / CUDA versions, the card's name and power limit,
    nvcc's version;
 1b. z tables: the entropy bottleneck's CDF tables computed by the port on
    this host (which has no JAX) for the two cases of
    ``tests/fixtures/z_tables_jax.npz`` (the constructor's weights and a
    seeded draw, 192 channels, their arrays stored beside them), equal bit
    for bit to the JAX package's tables stored there;
 2. build: the GDN kernel and its backward (wgmma, TMA, clusters; nvcc,
    sm_90a) and the host rANS library (g++), started together; ptxas's
    registers, spills and warnings;
 3. kernels: fused GDN and inverse GDN against ``gdn_plain``, max relative
    error <= 1e-5, with float32 and with bf16 in and out (bf16: bitwise the
    float32 variant's output on the same values, rounded to bf16): at the
    main path's row counts (393,216 / 98,304 / 24,576 / 6,144 for 768x512
    images at batch 4 and 1, a ragged 21, and 262,144 / 65,536 / 16,384
    for a training step at batch 16, patch 256; for IGDN also the rows of
    ``progressive_decode_all``, whose 15 levels fold into the batch:
    5,898,240 at batch 4, 1,474,560 / 368,640 / 92,160), C = 192, with
    CUDA-event times of the kernel in both types, of ``gdn_plain``, of the
    product alone (``torch.matmul(x*x, gamma)``, cuBLAS SGEMM) and of the
    bf16 ``GDN`` module call beside the cast, float32 call, cast it
    replaces, beside the tensor-core bound of each type and the CUDA-core
    bound; at ragged R 1 / 31 / 33 / 98,309; at every C the kernel takes
    (R = 333); 21 rows alone against the same rows at offsets 0, 5 and 37
    inside 98,304, bitwise; and, as the pipeline launches it, on a side
    stream and from two threads on two streams at once, bitwise the main
    stream's; 300 launches of one 24,576-row input bitwise alike; every
    check in both types;
 3b. backward: GDN's and IGDN's backward (``gdn_backward_rows``: dx and u)
    against ``gdn_backward_rows_plain``, and ``gdn_backward``'s (dx,
    dgamma, dbeta; the kernel and its reduction) against autograd through
    ``gdn_plain``, norm-wise (max abs error over max abs value): dx and u
    within 1e-5, dgamma and dbeta within 1e-4; the bf16 variant bitwise the
    float32 path's on the widened values (dx rounded once). At a training
    step's rows (262,144 / 65,536 / 16,384 / 4,096) with CUDA-event times of
    the whole ``gdn_backward`` in float32 and bf16, the kernel with u
    written, the reduction alone (beside ``torch.sum``), their plain
    versions, the three-product bound of each type beside the two-product
    one of the kernel it replaced and the wgmma floor at the SM clock read
    under load; at ragged R and at every C (R = 333) in both types; 100
    launches of one input bitwise alike and a side stream bitwise, both
    types; the backward through autograd, float32 and bf16, launches its
    kernel and its reduction once each (their counts) and torch.profiler
    records no other kernel (no cast);
 4. ``pic`` path: the full-width ``pic`` model (N=192, M=640, division
    (320, 640), dim_chunk 32, bf16 compute, random weights from a seed) on
    a seeded synthetic 768x512 image (``epic_tpu_torch/tools/workload.py``):
    ``progressive_encode`` with the 15-shell ``DEFAULT_Q_LIST``, then
    ``progressive_decode`` of levels 0..15. Every level's y_hat and x_hat
    must equal the encoder's own reconstruction bitwise, the decoded symbols
    the encoder's, bpp must not decrease with the level and PSNR must be
    finite;
 5. main path: the full-width flagship ``rem`` model (the ``pic`` model
    plus REM banks, check levels 0.25 / 0.75, random weights from a seed)
    on the same image, as ``bench.py`` runs it: ``progressive_encode`` with
    ``rems=True`` (the chained checkpoint latents extracted inside the
    encode), ``progressive_decode`` of levels 0..15 with the encoder's
    checkpoint latents, and ``progressive_decode_all`` twice. Checks: every
    level bitwise as in phase 4; the encoder's checkpoint latents bitwise
    equal to a separate ``extract_checkpoint`` chain; the REM-chained
    scales differ from the plain chain's; ``decode_all`` gives the same
    bits twice and is within DECODE_ALL_ATOL of the per-level decode;
 6. reference: small float32 ``pic`` and ``rem`` models on the GPU against
    the same code on the CPU, entropy parameters (REM-refined for ``rem``)
    within 1e-3;
 7. pipelined sweeps: the JAX package's ``bench.py`` loop on the flagship
    ``rem`` model (``tools/workload.py``): its 24 synthetic 768x512 images
    in batches of 4 through ``SweepPipeline`` with 2 workers on their own
    CUDA streams (at most 2 sweeps in flight), encode with REMs, then
    ``progressive_decode_all``. Each pipelined sweep's y / z streams,
    prefix table, bits and x_hat (SHA-256 of its bytes) must equal the same
    batch run serially; then ``bench_loop``: pipelined and sequential
    img/s, overlap speedup, the host split, peak memory, and per-level
    PSNR (finite) and MS-SSIM (in [0, 1]) of the 16 levels;
 8. random access on the flagship ``rem`` model at batch 1:
    ``PICCodec.compress`` then ``decompress`` at qualities 0, 0.25, 0.75
    and 10 (each check level conditioned on the one before, as in the
    encode), y_hat bitwise the encoder's; the receiver-side chain of the
    check-level streams bitwise equal to the encode's checkpoint latents;
    ``dump_bitstreams`` / ``load_bitstreams`` byte for byte;
 9. training at flagship width (``cli.train_device``'s curriculum, bf16,
    batch 16, patch 256, on ``bench.py``'s synthetic images): each stage's
    steps on one fixed batch through ``make_train_step`` (forward and
    backward launches per step, finite losses, frozen parameters bitwise
    unchanged, first_train's loss falling over its first three steps);
    then ``train_device.run`` with 4 / 3 / 3 / 3 steps, a validation and a
    checkpoint at each stage's end (in a temporary directory), launches
    counted over the whole run, steps/s and peak memory per stage; the
    rems checkpoint loaded by ``load_checkpoint`` bitwise the trained
    weights, and an encode / decode of levels 0..15 with it bitwise
    between encoder and decoder;
10. WACNN codec: the full-width ``cnn`` model (N=192, M=320, dim_chunk
    32, 10 slices, bf16, random weights from seed 0) on the 768x512
    image at batch 1 and 2: ``compress(buffered=True)`` gives one y and
    one z stream per image, ``decompress`` is bitwise the encoder's y_hat
    and x_hat; walls printed;
11. WACNN training: ``train_device.run(--model cnn)``, first_train for 3
    steps at batch 16, patch 256: finite losses, steps/s, peak memory;
    its checkpoint loaded bitwise and coded with;
12. file CLI: ``cli.codec`` on a seeded 768x512 image in two PNG files,
    one written by ``data/png.py`` (filter 0) and one whose rows use all
    five filters (``read_png`` timed on each): compress each with phase
    9's rems checkpoint (equal files), ``python -m
    epic_tpu_torch.cli.codec info``, decompress at levels 0 / 7 / 15, each
    PNG bitwise the quantised ``progressive_decode`` output (checkpoint
    latents rebuilt from the file's streams); the filtered PNG with the
    WACNN checkpoint of phase 11 likewise against its ``decompress``;
13. RD evaluation: ``rd_sweep`` on 2 synthetic 768x512 images with the
    flagship ``rem`` model (REMs on), per-level bpp equal to
    ``progressive_encode``'s bits and non-decreasing; ``compress_with_ac``
    at 0 / 0.5 / 10;
14. first_train against the JAX trainer: the losses of 6 float32 steps
    (``training=False``) on the weights and batch of
    ``tests/fixtures/first_train_jax.json`` (SHA-256 checked), side by
    side with the fixture's: within 1% through step 2, at step 3 both
    above or both below 3x step 2, and falling after it in both;
15. the host-loader trainer: ``cli.train.main`` in this process at the JAX
    CLI's defaults (N=192, M=640, division 320 / 640, dim_chunk 32, float32,
    batch 16, patch 256) on PNG files it writes (18 synthetic 512x768
    train images, a five-filter and a palette one, 4 in the test split, 2
    test images): first_train, 2 epochs of 3 steps (validations, the
    plateau, checkpoints, the real codec's evaluation), then rems with
    ``--model rem`` from its checkpoint (fresh REM banks), 1 epoch of 2
    steps; launches per step equal to a ``train_device`` step's, and per
    run; steps/s, peak memory, load against step seconds, validation,
    evaluation and save seconds; then ``tools.make_artifact`` on the rems
    checkpoint: every array the bf16 cast of the float32 one's, the dead
    rows zero, its bytes beside the committed flagship's, and a
    progressive encode / decode of levels 0..15 with it bitwise between
    encoder and decoder. The phase must finish within 300 s;
16. the non-default PIC options on the flagship ``rem`` model with
    ``all_scalable=False`` (bf16, random weights from seed 0), the 768x512
    image at batch 1: ``compress`` / ``decompress`` through the
    interleaved codec at 0.5 / 0.75 / 5 / 10 with the REM checkpoint chain
    (0.25's latent from ``extract_checkpoint``, 0.75's from the compress
    at 0.75, bitwise a separate ``extract_checkpoint``): the decoder's
    y_hat and x_hat bitwise the encoder's; the seconds of each call and of
    the decoder's 10 per-slice round trips; ``progressive_encode``
    refused. One bitwise round trip at 0.5 each with ``delta_encode`` off,
    ``total_mu_rep`` off and the "two-levels" policy (the same weights).
    Then ``cli.train.main --no_all_scalable`` at the JAX CLI's defaults on
    phase 15's PNG files: first_train 1 epoch of 3 steps, then ``--model
    rem`` from its checkpoint, 1 epoch of 2 steps; launches per step equal
    phase 15's, and per run; steps/s, peak memory. Within 200 s;
17. the data-parallel layer: ``make_parallel_train_step`` over NCCL, one
    rank per card (``torch.cuda.device_count()``), each rank a process of
    this script (``--parallel-rank``): first_train at flagship width,
    float32, a global batch of 16 at 256^2, ``training=False``, 3 steps;
    with one rank its losses and parameters bitwise the single-process
    ``TrainStep``'s on the same batch (in this process), with more the
    losses within 1e-5 relative and the ranks' parameters bitwise equal;
    steps/s and peak memory. Then ``tools.multihost_rd_sweep`` with the
    flagship ``pic`` on 4 synthetic 768x512 images: 2 processes sharing
    the card (rows gathered over gloo) against 1 process, rows bitwise.

18. the image readers and the repository tools: the committed image
    fixtures (``tests/fixtures/images``: JPEG, PNG, BMP, PPM) decoded by
    ``data/images.read_image`` to the SHA-256 of Pillow's decode;
    ``read_jpeg`` timed on the 768x512 baseline and progressive files; the
    host loader (``ImageFolder`` + ``data_loader``, batch 16) on copies of
    them, beside PNG files of the same pixels; ``tools.eval_checkpoint`` on
    phase 9's rems checkpoint (6 tiles of the 768x512 JPEG) and
    ``tools.eval_cnn`` on phase 11's WACNN one, launches per call, real bpp
    equal to the streams' bytes at all 16 levels, the REM group present;
    ``tools.extend_rem_banks`` to one more check level (1.75), the result
    loaded (kept arrays bitwise) and coded at q = 2 with its three
    checkpoint latents; ``tools.bench_rans`` at 4,000,000 symbols. Within
    150 s.

19. the JAX trainer's checkpoints: the committed Orbax directory
    ``tests/fixtures/orbax/flagship_tiled`` (the flagship ``rem`` model's
    609 arrays, 623.3 MiB of float32, each its own first 1,021 trained
    values tiled, written by the JAX package's ``save_checkpoint``) read
    by ``training/orbax.read_orbax`` (OCDBT, zarr, the zstd decoder of
    ``native/epic_zstd.cpp``): every array's SHA-256 equal to the JAX
    package's ``load_checkpoint`` of it
    (``tests/fixtures/orbax/flagship_tiled.json``); the read, the load and
    the zstd decode (MB/s, one thread) timed, the decode both on the
    fixture's chunks (tiled, mostly match copies) and on
    ``tests/fixtures/orbax/normals_f32.zst`` (4 MiB of seeded float32
    normals, few matches, as in trained weights; its SHA-256 checked); then
    phase 5's serial sweep with the loaded model (encode with REMs, levels
    0..15, ``decode_all``) on the 768x512 image, every level bitwise the
    encoder's, launches equal to phase 5's; then
    ``tools.make_artifact`` on the directory, its bf16 npz reloaded: every
    array the bf16 cast of the fixture's, the dead rows zero. Within 150 s.

``python3 chip_smoke.py --phases 16,17`` runs the environment, the build
and the listed phases only (and prints no kernels record; 3 and 3b may be
listed too); ``--phases 18``
runs phase 18 on random-weight stand-ins of phases 9 and 11's
checkpoints; ``--phases 19`` needs nothing else.

Each path's kernel launches are counted from zero and must match its count
(GDN 6 per encode or ``compress``; IGDN 3 per decoded level, 48 for
levels 0..15, 9 per ``decode_all``, 3 per ``decompress``; 15 per pipelined
sweep of 4 images; WACNN 3 GDN per ``compress`` and 3 IGDN per
``decompress``; the training launches in phases 9, 11, 14 and 15; the file
CLI and RD evaluation in phases 12-13, the tools in phase 18, phase 19's
sweep as phase 5's; phase 16's interleaved codec as the
all_scalable one (6 GDN per ``compress``, 3 IGDN per ``decompress``) and
its ``cli.train`` steps as phase 15's; phase 17's steps, each rank's
counted in its process, and the sweep's 6 GDN + 9 IGDN per image; no
inference path launches the backward kernel). Any failure raises and exits non-zero. The line before
the last is the kernels' JSON record; the last line is the device record.
Needs one CUDA device and no network; writes only into the package's
build directories and a temporary directory it removes.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

# Published dense peaks (NVIDIA data sheets), by SKU: float32 on CUDA cores
# and TF32 on tensor cores in TFLOP/s, memory in TB/s.
_PEAKS = {"SXM": (67.0, 495.0, 3.35), "PCIe": (51.0, 378.0, 2.0),
          "NVL": (60.0, 417.5, 3.9)}
# g_a's layers at batch 4 (bench.py's batch) and 1; the IGDN of a decoded
# level has the same rows; then a training step's (batch 16, patch 256)
GDN_ROWS = (393_216, 98_304, 24_576, 6_144, 21, 262_144, 65_536, 16_384,
            # WACNN at batch 2 (phase 10); first_train at batch 4 (14)
            196_608, 49_152, 12_288, 4_096)
# IGDN in progressive_decode_all: 15 levels folded into the batch, at
# batch 4 (its top layer's 5,898,240 rows are 4.5 GB in float32) and 1
IGDN_FOLDED_ROWS = (5_898_240, 1_474_560, 368_640, 92_160)
GDN_RAGGED_ROWS = (1, 31, 33, 98_309)
# launches of one input that must give the same bits (phase 3)
REPEAT_LAUNCHES = 300
GDN_C = 192
REL_TOL = 1e-5
# the backward kernel at a flagship first_train step (batch 16, patch 256):
# g_a's GDNs and g_s's IGDNs run at these rows
GDN_BWD_ROWS = (262_144, 65_536, 16_384, 4_096)  # 4,096: phase 14
# dx and u of the backward kernel against the plain closed form, norm-wise
# (max abs error over max abs value)
BWD_REL_TOL = 1e-5
# dgamma and dbeta against autograd: sums over every row, in the kernel's
# tensor cores and its reduction, and by autograd in its own order
WGRAD_REL_TOL = 1e-4
# clocks of one SM's tensor cores per m64n8k8 TF32 slice of a wgmma at the
# TF32 peak (1,024 multiply-adds a clock an SM: 495 TFLOP/s on 132 SMs at
# 1.83 GHz)
MMA_CLOCKS = 4
# progressive_decode_all against the per-level decode, x_hat in [0, 1]. cuDNN
# picks other convolution kernels for the folded batch (15 levels) than for
# batch 1, and they round bf16 work differently; with cuDNN off the two
# agree bitwise (python3 -m epic_tpu_torch.tools.fold_diff). x_hat leaves
# g_s's last conv in bf16, whose step is 2^-8 just below 1: five such steps.
DECODE_ALL_ATOL = 5 * 2.0 ** -8


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return _PEAKS[key]
    return _PEAKS["SXM"]


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def phase_environment() -> str:
    smi = nvidia_smi()
    nvcc = subprocess.run([os.path.join(os.environ.get("CUDA_HOME",
                                                       "/usr/local/cuda"),
                                        "bin", "nvcc"), "--version"],
                          capture_output=True, text=True)
    log(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(smi)
    log("[1 env] nvcc: " + (nvcc.stdout.strip().splitlines() or ["?"])[-1])
    return smi


def phase_z_tables() -> None:
    """The port's z tables on this host against the JAX package's, stored
    with the bottleneck arrays they come from (tests/gen_torch_z_tables.py)."""
    from epic_tpu_torch.entropy.bottleneck import EntropyBottleneck

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures", "z_tables_jax.npz")
    with np.load(path) as z:
        for case in ("constructor", "seeded"):
            arrays = {k.rsplit("/", 1)[1]: torch.from_numpy(z[k])
                      for k in z.files if k.startswith(f"{case}/arrays/")}
            eb = EntropyBottleneck(arrays["quantiles"].shape[0])
            eb.load_state_dict(arrays)
            t0 = time.perf_counter()
            tables, medians = eb.cdf_tables()
            ms = 1e3 * (time.perf_counter() - t0)
            got = {"quantized_cdf": tables.quantized_cdf,
                   "cdf_length": tables.cdf_length, "offset": tables.offset,
                   "medians": medians}
            for k, v in got.items():
                want = z[f"{case}/tables/{k}"]
                if v.shape != want.shape or v.tobytes() != want.tobytes():
                    raise AssertionError(f"z tables, {case}: {k} differs "
                                         "from the JAX package's")
            log(f"[1b z tables] {case}: {tables.quantized_cdf.shape[0]} "
                f"channels, {tables.quantized_cdf.size} CDF entries, "
                f"lengths, offsets and medians bit for bit the JAX "
                f"package's ({ms:.1f} ms on this host)")


def phase_build():
    from epic_tpu_torch.native import build as rans_build
    from epic_tpu_torch.ops import gdn_kernel

    results, errors = {}, []

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # re-raised below, after both builds end
            errors.append(e)
        results[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=a) for a in
               (("gdn.cu (nvcc)", gdn_kernel.build_library),
                ("gdn_bwd.cu (nvcc)", lambda: gdn_kernel.build_library(
                    gdn_kernel.BACKWARD_SOURCE)),
                ("epic_rans.cpp (g++)", rans_build.build_library))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    log("[2 build] " + ", ".join(f"{k} {v:.1f} s" for k, v in results.items()))
    for stem in ("gdn", "gdn_bwd"):
        ptxas = os.path.join(os.path.dirname(gdn_kernel.SOURCE), "..",
                             "_build", f"{stem}_ptxas.txt")
        if os.path.exists(ptxas):
            for line in open(ptxas).read().splitlines():
                if any(k in line for k in ("registers", "spill",
                                           "Performance")):
                    log(f"[2 build] ptxas {stem}: " + line.strip())


def time_cuda(fn, reps: int = 20, inner: int = 10) -> float:
    """Median over reps of the CUDA-event time of `inner` calls, in ms per
    call, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return float(np.median(samples))


def gdn_bounds_ms(rows: int, c: int, peak: tuple, elem: int = 4):
    """Least times for GDN over [rows, c] on this card, in ms: (tensor-core
    bound, what binds it, CUDA-core bound). The bytes are x read once and y
    written once (`elem` bytes each: 4 float32, 2 bf16), gamma and beta
    (float32) read once, over the memory rate. The kernel's float32 accuracy
    on tensor cores takes three TF32 products (3 * 2RC^2 operations at the
    TF32 peak); the CUDA-core bound, the design of the first kernel, counts
    2RC^2 + 4RC float32 operations at the float32 peak."""
    f32, tf32, bw = peak
    t_bytes = (2.0 * elem * rows * c + 4.0 * (c * c + c)) / (bw * 1e12)
    t_tc = 3 * 2.0 * rows * c * c / (tf32 * 1e12)
    t_cc = (2.0 * rows * c * c + 4.0 * rows * c) / (f32 * 1e12)
    by = "operations" if t_tc >= t_bytes else "bytes"
    return max(t_tc, t_bytes) * 1e3, by, max(t_cc, t_bytes) * 1e3


def _gdn_data(rows: int, c: int, rng, dev):
    x = torch.as_tensor(rng.normal(0, 1, (rows, c)).astype(np.float32),
                        device=dev)
    gamma = torch.as_tensor((0.1 * np.eye(c) + 0.01 * rng.random((c, c)))
                            .astype(np.float32), device=dev)
    beta = torch.as_tensor((1.0 + 0.1 * rng.random(c)).astype(np.float32),
                           device=dev)
    return x, gamma, beta


def _check_gdn(label: str, x, gamma, beta, inverse: bool):
    """The kernel against gdn_plain on the same inputs: (max abs error, max
    relative error); raises above REL_TOL."""
    from epic_tpu_torch.ops.gdn_kernel import gdn, gdn_plain

    got = gdn(x, gamma, beta, inverse)
    want = gdn_plain(x, gamma, beta, inverse)
    torch.cuda.synchronize()
    err = (got - want).abs()
    rel = float((err / want.abs().clamp_min(1e-30)).max())
    if not math.isfinite(rel) or rel > REL_TOL:
        raise AssertionError(f"{label}: max relative error {rel:.3e} > "
                             f"{REL_TOL}")
    return float(err.max()), rel


def _check_gdn_bf16(label: str, x, gamma, beta, inverse: bool):
    """The kernel's bf16 variant on x rounded to bf16: bitwise the float32
    variant's output on the same (widened) values, rounded to bf16, and that
    one within REL_TOL of gdn_plain. Returns (bf16 x, max relative
    error)."""
    from epic_tpu_torch.ops.gdn_kernel import gdn

    xb = x.bfloat16()
    _, rel = _check_gdn(f"{label} (bf16 values)", xb.float(), gamma, beta,
                        inverse)
    got = gdn(xb, gamma, beta, inverse)
    want = gdn(xb.float(), gamma, beta, inverse).bfloat16()
    if got.dtype is not torch.bfloat16 or not torch.equal(got, want):
        raise AssertionError(f"{label}: the bf16 output is not the float32 "
                             "output rounded to bf16")
    return xb, rel


def _check_streams(name: str, inverse: bool, rng, dev,
                   bf16: bool = False) -> None:
    """As the pipeline launches it: on a side stream, and from two threads
    on two streams at once (4 launches each, interleaved on the card), at
    batch 4's 393,216 rows, float32 or bf16. Every result must equal the
    main stream's bitwise, and that one gdn_plain within REL_TOL (bf16: the
    float32 variant's rounded, bitwise)."""
    from epic_tpu_torch.ops.gdn_kernel import gdn

    x, g, b = _gdn_data(393_216, GDN_C, rng, dev)
    if bf16:
        name += " bf16"
        x, rel = _check_gdn_bf16(f"{name} main stream", x, g, b, inverse)
    else:
        _, rel = _check_gdn(f"{name} main stream", x, g, b, inverse)
    want = gdn(x, g, b, inverse)
    torch.cuda.synchronize()
    outs, errors = [[], [], []], []

    def launch(k, reps):
        try:
            s = torch.cuda.Stream()
            with torch.cuda.stream(s):
                outs[k] = [gdn(x, g, b, inverse) for _ in range(reps)]
            s.synchronize()
        except Exception as e:  # re-raised below, after the join
            errors.append(e)

    launch(0, 1)
    threads = [threading.Thread(target=launch, args=(k, 4))
               for k in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    if not all(torch.equal(y, want) for out in outs for y in out):
        raise AssertionError(f"{name}: a side-stream launch differs from "
                             "the main stream's bits")
    log(f"[3 kernels] {name} R=393216 on a side stream and from two threads "
        f"on two streams at once (9 launches): bitwise the main stream's, "
        f"max rel err against gdn_plain {rel:.2e}"
        + (", bf16 bitwise the float32 rounded" if bf16 else ""))


def phase_kernels(smi: str):
    """GDN / IGDN against gdn_plain (max relative error <= 1e-5), float32
    and bf16 I/O (bf16: bitwise the float32 variant's output rounded): at
    the main path's row counts (timed: kernel in both types, plain, the
    product alone, the bf16 ``GDN`` module call beside the cast, float32
    call, cast it replaces), at ragged row counts, at every width the kernel
    takes; rows whose bits do not depend on where they sit in the launch;
    side streams and threads."""
    from epic_tpu_torch.ops.gdn import GDN
    from epic_tpu_torch.ops.gdn_kernel import MAX_CHANNELS, gdn, gdn_plain

    dev = torch.device("cuda")
    peak = peaks(smi)
    rng = np.random.default_rng(0)
    c = GDN_C
    _, gamma, beta = _gdn_data(1, c, rng, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows_out = {}
    for inverse, name in ((False, "gdn"), (True, "igdn")):
        mod = GDN(c, inverse).to(dev)
        per_shape = []
        for rows in (IGDN_FOLDED_ROWS if inverse else ()) + GDN_ROWS:
            x = torch.randn((rows, c), generator=gen, device=dev)
            abs_err, rel = _check_gdn(f"{name} R={rows}", x, gamma, beta,
                                      inverse)
            xb, rel_b = _check_gdn_bf16(f"{name} R={rows}", x, gamma, beta,
                                        inverse)
            # fewer samples where one call takes milliseconds
            reps, inner = (5, 2) if rows > 2_000_000 else (20, 10)
            ms = time_cuda(lambda: gdn(x, gamma, beta, inverse), reps, inner)
            bf16_ms = time_cuda(lambda: gdn(xb, gamma, beta, inverse), reps,
                                inner)
            plain_ms = time_cuda(lambda: gdn_plain(x, gamma, beta, inverse),
                                 reps, inner)
            product_ms = time_cuda(lambda: torch.matmul(x * x, gamma), reps,
                                   inner)
            with torch.no_grad():
                module_ms = time_cuda(lambda: mod(xb), reps, inner)
                cast_ms = time_cuda(
                    lambda: mod(xb.float()).to(torch.bfloat16), reps, inner)
            bound, by, cc_bound = gdn_bounds_ms(rows, c, peak)
            bf16_bound, bf16_by, _ = gdn_bounds_ms(rows, c, peak, elem=2)
            per_shape.append(dict(
                rows=rows, max_abs_err=abs_err, max_rel_err=max(rel, rel_b),
                ms=ms, plain_ms=plain_ms, product_ms=product_ms,
                bound_ms=bound, bound_by=by, cuda_core_bound_ms=cc_bound,
                bf16_ms=bf16_ms, bf16_bound_ms=bf16_bound,
                bf16_bound_by=bf16_by, module_bf16_ms=module_ms,
                module_cast_ms=cast_ms))
            log(f"[3 kernels] {name} R={rows} C={c}: max rel err {rel:.2e} "
                f"(bf16 values {rel_b:.2e}; bf16 out bitwise the float32 "
                f"rounded), float32 kernel {ms:.4f} ms (bound {bound:.4f}, "
                f"{by}), bf16 kernel {bf16_ms:.4f} ms (bound "
                f"{bf16_bound:.4f}, {bf16_by}), plain {plain_ms:.4f} ms, "
                f"product alone {product_ms:.4f} ms, CUDA-core bound "
                f"{cc_bound:.4f} ms; bf16 GDN module {module_ms:.4f} ms "
                f"against cast, float32 module, cast {cast_ms:.4f} ms [{smi}]")
            del x, xb
        torch.cuda.empty_cache()
        worst = 0.0
        for rows in GDN_RAGGED_ROWS:
            x, g, b = _gdn_data(rows, c, rng, dev)
            worst = max(worst, _check_gdn(f"{name} R={rows}", x, g, b,
                                          inverse)[1],
                        _check_gdn_bf16(f"{name} R={rows}", x, g, b,
                                        inverse)[1])
        for width in range(1, MAX_CHANNELS + 1):
            x, g, b = _gdn_data(333, width, rng, dev)
            worst = max(worst, _check_gdn(f"{name} C={width}", x, g, b,
                                          inverse)[1],
                        _check_gdn_bf16(f"{name} C={width}", x, g, b,
                                        inverse)[1])
        x, g, b = _gdn_data(98_304, c, rng, dev)
        for xt in (x, x.bfloat16()):
            alone = gdn(xt[:21].clone(), g, b, inverse)
            for off in (0, 5, 37):
                big = xt.clone()
                big[off:off + 21] = xt[:21]
                if not torch.equal(gdn(big, g, b, inverse)[off:off + 21],
                                   alone):
                    raise AssertionError(
                        f"{name} {xt.dtype}: rows at offset {off} of 98,304 "
                        "differ from the same rows alone")
        # a box slot freed or filled out of turn shows as a rare wrong row
        # or column block: many launches, every one bitwise the first
        x, g, b = _gdn_data(24_576, c, rng, dev)
        for xt in (x, x.bfloat16()):
            want = gdn(xt, g, b, inverse)
            for _ in range(REPEAT_LAUNCHES // 10):
                outs = [gdn(xt, g, b, inverse) for _ in range(10)]
                if not all(torch.equal(y, want) for y in outs):
                    raise AssertionError(f"{name} {xt.dtype}: launches of "
                                         "the same input differ")
        log(f"[3 kernels] {name} ragged R {GDN_RAGGED_ROWS} and C = 1.."
            f"{MAX_CHANNELS} at R=333, float32 and bf16: max rel err "
            f"{worst:.2e}, bf16 bitwise the float32 rounded; 21 rows alone "
            "and at offsets 0/5/37 of 98,304 bitwise equal, both types; "
            f"{REPEAT_LAUNCHES} launches at R=24576 bitwise alike, both "
            "types")
        _check_streams(name, inverse, rng, dev)
        _check_streams(name, inverse, rng, dev, bf16=True)
        rows_out[name] = per_shape
    torch.cuda.empty_cache()
    return rows_out


def gdn_bwd_bounds_ms(rows: int, c: int, peak: tuple, elem: int = 4):
    """Least time for the whole backward over [rows, c], (ms, what binds
    it): x and g read once and dx written once (`elem` bytes each: 4
    float32, 2 bf16), gamma and beta read once, at the memory rate, against
    three products of 2RC^2 (n, u @ gamma^T, (x^2)^T @ u) in 3xTF32 at the
    TF32 peak."""
    _, tf32, bw = peak
    t_bytes = (3.0 * elem * rows * c + 4.0 * (c * c + c)) / (bw * 1e12)
    t_ops = 3 * 3 * 2.0 * rows * c * c / (tf32 * 1e12)
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def gdn_bwd_two_product_bound_ms(rows: int, c: int, peak: tuple) -> float:
    """The bound of the kernel before dgamma and dbeta were folded in (PR
    12's mma.sync kernel: dx and u): x and g read, dx and u written in
    float32 (16RC + 4C^2 + 4C bytes) against two 3xTF32 products."""
    _, tf32, bw = peak
    t_bytes = 4.0 * (4 * rows * c + c * c + c) / (bw * 1e12)
    t_ops = 2 * 3 * 2.0 * rows * c * c / (tf32 * 1e12)
    return max(t_bytes, t_ops) * 1e3


def gdn_bwd_mma_floor_ms(rows: int, clusters: int, sm_mhz: float) -> float:
    """The least time of the backward kernel's wgmma design: its busiest
    cluster walks ceil(tiles / clusters) 64-row tiles, and each block issues
    per tile 3 products x 3 passes x 24 k-steps of m64n48k8 TF32 wgmma, each
    6 x MMA_CLOCKS clocks of its SM's tensor cores, at the SM clock
    nvidia-smi reads under load. The kernel pads C to 192, so the floor
    does not depend on C."""
    tiles = -(-rows // 64)
    clocks = -(-tiles // clusters) * 3 * 3 * 24 * 6 * MMA_CLOCKS
    return clocks / (sm_mhz * 1e3)


def gdn_bwd_reduce_bound_ms(parts: int, c: int, peak: tuple) -> float:
    """Least time of the reduction kernel: the (c + 1) x c floats it reads
    of each partial and the (c + 1) x c it writes, at the memory rate."""
    return 4.0 * (parts + 1) * (c + 1) * c / (peak[2] * 1e12) * 1e3


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (norm-wise: dx sums terms of both
    signs and may cancel to 0, where an elementwise ratio means nothing)."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _check_gdn_bwd(label: str, x, gamma, beta, g, inverse: bool,
                   autograd: bool = True):
    """The backward kernel's (dx, u) against gdn_backward_rows_plain, and
    gdn_backward's (dx, dgamma, dbeta) against autograd through gdn_plain.
    dx and u within BWD_REL_TOL of the plain closed form; against autograd
    dx within BWD_REL_TOL and dgamma / dbeta within WGRAD_REL_TOL (sums over
    every row in another order). Returns the errors."""
    from epic_tpu_torch.ops.gdn_kernel import (gdn_backward,
                                               gdn_backward_rows,
                                               gdn_backward_rows_plain,
                                               gdn_plain)

    dx, u = gdn_backward_rows(x, gamma, beta, g, inverse)
    dx_p, u_p = gdn_backward_rows_plain(x, gamma, beta, g, inverse)
    errs = {"dx": _rel(dx, dx_p), "u": _rel(u, u_p),
            "max_abs_err": float((dx - dx_p).abs().max())}
    if autograd:
        xr, gr, br = (t.clone().requires_grad_() for t in (x, gamma, beta))
        want = torch.autograd.grad(gdn_plain(xr, gr, br, inverse),
                                   (xr, gr, br), g)
        got = gdn_backward(x, gamma, beta, g, inverse)
        for k, a, b in zip(("dx_autograd", "dgamma", "dbeta"), got, want):
            errs[k] = _rel(a, b)
    torch.cuda.synchronize()
    for k, v in errs.items():
        lim = WGRAD_REL_TOL if k in ("dgamma", "dbeta") else BWD_REL_TOL
        if k != "max_abs_err" and not (math.isfinite(v) and v <= lim):
            raise AssertionError(f"{label}: {k} relative error {v:.3e} > "
                                 f"{lim}")
    return errs


def _check_gdn_bwd_bf16(label: str, x, gamma, beta, g, inverse: bool,
                        autograd: bool = True):
    """The backward on x and g rounded to bf16: the float32 kernel on the
    widened values held as ``_check_gdn_bwd`` holds it, and the bf16
    variant bitwise that one (dx rounded once, u, dgamma and dbeta equal).
    Returns (bf16 x, bf16 g, the float32 errors)."""
    from epic_tpu_torch.ops.gdn_kernel import gdn_backward, gdn_backward_rows

    xb, gb = x.bfloat16(), g.bfloat16()
    errs = _check_gdn_bwd(f"{label} (bf16 values)", xb.float(), gamma, beta,
                          gb.float(), inverse, autograd)
    pairs = ((gdn_backward_rows(xb, gamma, beta, gb, inverse),
              gdn_backward_rows(xb.float(), gamma, beta, gb.float(),
                                inverse)),
             (gdn_backward(xb, gamma, beta, gb, inverse),
              gdn_backward(xb.float(), gamma, beta, gb.float(), inverse)))
    for got, want in pairs:
        if got[0].dtype is not torch.bfloat16 or not (
                torch.equal(got[0], want[0].bfloat16())
                and all(torch.equal(a, b) for a, b in zip(got[1:],
                                                          want[1:]))):
            raise AssertionError(f"{label}: the bf16 backward is not the "
                                 "float32 one's (dx rounded)")
    return xb, gb, errs


def _bwd_kernel_names(x, gamma, beta, g, inverse: bool):
    """The CUDA kernels that torch.profiler records in one backward through
    the autograd function (it may drop a record, never add one), and the
    launches of the backward kernel and of its reduction it counted."""
    from torch.profiler import ProfilerActivity, profile

    from epic_tpu_torch.ops.gdn_kernel import (gdn_backward,
                                               gdn_backward_reduce,
                                               gdn_differentiable)

    kind = "igdn" if inverse else "gdn"
    xr, gr, br = (t.clone().requires_grad_() for t in (x, gamma, beta))
    y = gdn_differentiable(xr, gr, br, inverse)
    torch.cuda.synchronize()
    before = gdn_backward.launches[kind] + gdn_backward_reduce.launches[kind]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(y, (xr, gr, br), g)
        torch.cuda.synchronize()
    launched = (gdn_backward.launches[kind]
                + gdn_backward_reduce.launches[kind] - before)
    return ([e.name for e in prof.events() if e.device_type.name == "CUDA"],
            launched)


def phase_backward_kernel(smi: str):
    """The GDN / IGDN backward (the kernel and its reduction) against its
    plain version and against autograd through gdn_plain, float32 and bf16
    (bf16 bitwise the float32 path's, dx rounded): at a flagship
    first_train step's row counts (timed in both types: the whole
    ``gdn_backward``, the kernel with u written, the reduction, their plain
    versions, the bounds, the wgmma floor), at ragged R, at every C it takes
    (R = 333), repeated launches and a side stream bitwise; the backward
    through autograd launches the two kernels once each and no cast, in
    both types. Returns the rows checked, per kind."""
    from epic_tpu_torch.ops.gdn_kernel import (
        MAX_CHANNELS, _backward_launch, backward_clusters, gdn_backward,
        gdn_backward_plain, gdn_backward_reduce, gdn_backward_reduce_plain,
        gdn_backward_rows, gdn_backward_rows_plain)
    from epic_tpu_torch.tools.gdn_phases import sm_clock_mhz_under_load

    dev = torch.device("cuda")
    peak = peaks(smi)
    rng = np.random.default_rng(3)
    gen = torch.Generator(device=dev).manual_seed(3)
    c = GDN_C
    _, gamma, beta = _gdn_data(1, c, rng, dev)
    out = {}
    for inverse, name in ((False, "gdn"), (True, "igdn")):
        per_shape = []
        for rows in GDN_BWD_ROWS:
            x = torch.randn((rows, c), generator=gen, device=dev)
            g = torch.randn((rows, c), generator=gen, device=dev)
            errs = _check_gdn_bwd(f"{name} backward R={rows}", x, gamma,
                                  beta, g, inverse)
            xb, gb, errs_b = _check_gdn_bwd_bf16(
                f"{name} backward R={rows}", x, gamma, beta, g, inverse)
            ms = time_cuda(lambda: gdn_backward(x, gamma, beta, g, inverse))
            bf16_ms = time_cuda(lambda: gdn_backward(xb, gamma, beta, gb,
                                                     inverse))
            rows_ms = time_cuda(lambda: gdn_backward_rows(x, gamma, beta, g,
                                                          inverse))
            plain_ms = time_cuda(lambda: gdn_backward_plain(
                x, gamma, beta, g, inverse))
            rows_plain_ms = time_cuda(lambda: gdn_backward_rows_plain(
                x, gamma, beta, g, inverse))
            # the reduction alone, on this launch's partials
            _, _, part, parts = _backward_launch(x, gamma, beta, g, inverse,
                                                 False)
            red = gdn_backward_reduce(part, parts, c, inverse)
            red_p = gdn_backward_reduce_plain(part, parts, c, inverse)
            red_err = max(float((a - b).abs().max())
                          for a, b in zip(red, red_p))
            red_rel = max(_rel(a, b) for a, b in zip(red, red_p))
            if not red_rel <= 1e-6:
                raise AssertionError(f"{name} reduction R={rows}: relative "
                                     f"error {red_rel:.3e} > 1e-6")
            red_ms = time_cuda(lambda: gdn_backward_reduce(part, parts, c,
                                                           inverse))
            red_plain_ms = time_cuda(lambda: gdn_backward_reduce_plain(
                part, parts, c, inverse))
            pv = part[:parts * (MAX_CHANNELS + 1) * MAX_CHANNELS].view(
                parts, MAX_CHANNELS + 1, MAX_CHANNELS)
            red_lib_ms = time_cuda(lambda: torch.sum(pv, dim=0))
            bound, by = gdn_bwd_bounds_ms(rows, c, peak)
            bf16_bound, bf16_by = gdn_bwd_bounds_ms(rows, c, peak, elem=2)
            old_bound = gdn_bwd_two_product_bound_ms(rows, c, peak)
            if rows == GDN_BWD_ROWS[0]:  # about a second of launches
                mhz = sm_clock_mhz_under_load(lambda: gdn_backward(
                    x, gamma, beta, g, inverse), int(1000 / ms) + 1)
                clusters = backward_clusters(torch.float32, inverse)
            floor = gdn_bwd_mma_floor_ms(rows, clusters, mhz)
            per_shape.append(dict(
                rows=rows, ms=ms, bf16_ms=bf16_ms, rows_ms=rows_ms,
                plain_ms=plain_ms, rows_plain_ms=rows_plain_ms,
                bound_ms=bound, bound_by=by, bf16_bound_ms=bf16_bound,
                bf16_bound_by=bf16_by, two_product_bound_ms=old_bound,
                mma_floor_ms=floor, clusters=clusters, sm_mhz=mhz,
                reduce_parts=parts, reduce_ms=red_ms,
                reduce_plain_ms=red_plain_ms, reduce_library_ms=red_lib_ms,
                reduce_bound_ms=gdn_bwd_reduce_bound_ms(parts, c, peak),
                reduce_max_abs_err=red_err,
                bf16_errs=errs_b, **errs))
            log(f"[3b backward] {name} R={rows} C={c}: rel err dx "
                f"{errs['dx']:.2e} u {errs['u']:.2e}, against autograd dx "
                f"{errs['dx_autograd']:.2e} dgamma {errs['dgamma']:.2e} "
                f"dbeta {errs['dbeta']:.2e} (bf16 values: dx "
                f"{errs_b['dx']:.2e} dgamma {errs_b['dgamma']:.2e}; bf16 "
                f"bitwise the float32 path's); whole gdn_backward float32 "
                f"{ms:.4f} ms, bf16 {bf16_ms:.4f} ms (bound {bound:.4f} / "
                f"{bf16_bound:.4f}, {by}; the two-product bound "
                f"{old_bound:.4f}), the kernel with u written "
                f"{rows_ms:.4f} ms, plain {plain_ms:.4f} ms (dx and u alone "
                f"{rows_plain_ms:.4f}), wgmma floor {floor:.4f} ms at "
                f"{mhz:.0f} MHz on {clusters} clusters; reduction of "
                f"{parts} partials {red_ms:.4f} ms (plain {red_plain_ms:.4f}, "
                f"torch.sum {red_lib_ms:.4f}, bound "
                f"{gdn_bwd_reduce_bound_ms(parts, c, peak):.4f}, rel err "
                f"{red_rel:.1e}) [{smi}]")
            del x, g, xb, gb, part
        torch.cuda.empty_cache()
        worst = 0.0
        for rows in GDN_RAGGED_ROWS:
            x, gm, b = _gdn_data(rows, c, rng, dev)
            g = torch.as_tensor(rng.normal(0, 1, (rows, c)).astype(
                np.float32), device=dev)
            e = _check_gdn_bwd(f"{name} backward R={rows}", x, gm, b, g,
                               inverse)
            eb = _check_gdn_bwd_bf16(f"{name} backward R={rows}", x, gm, b,
                                     g, inverse)[2]
            worst = max(worst, e["dx"], e["u"], e["dx_autograd"], eb["dx"],
                        eb["u"], eb["dx_autograd"])
        for width in range(1, MAX_CHANNELS + 1):
            x, gm, b = _gdn_data(333, width, rng, dev)
            g = torch.as_tensor(rng.normal(0, 1, (333, width)).astype(
                np.float32), device=dev)
            e = _check_gdn_bwd(f"{name} backward C={width}", x, gm, b, g,
                               inverse, autograd=width % 16 == 0)
            eb = _check_gdn_bwd_bf16(f"{name} backward C={width}", x, gm, b,
                                     g, inverse, autograd=width % 16 == 8)[2]
            worst = max(worst, e["dx"], e["u"], eb["dx"], eb["u"])
        # the u exchange and the box ring: many launches, every one bitwise
        # the first, then a side stream
        x, gm, b = _gdn_data(24_576, c, rng, dev)
        g = torch.randn(x.shape, generator=gen, device=dev)
        for xt, gt in ((x, g), (x.bfloat16(), g.bfloat16())):
            want = gdn_backward(xt, gm, b, gt, inverse)
            for _ in range(REPEAT_LAUNCHES // 30):
                outs = [gdn_backward(xt, gm, b, gt, inverse)
                        for _ in range(10)]
                if not all(torch.equal(p, q) for o in outs
                           for p, q in zip(o, want)):
                    raise AssertionError(f"{name} backward {xt.dtype}: "
                                         "launches of the same input differ")
        x, gm, b = _gdn_data(GDN_BWD_ROWS[0], c, rng, dev)
        g = torch.randn(x.shape, generator=gen, device=dev)
        for xt, gt in ((x, g), (x.bfloat16(), g.bfloat16())):
            want = (gdn_backward_rows(xt, gm, b, gt, inverse)
                    + gdn_backward(xt, gm, b, gt, inverse))
            torch.cuda.synchronize()
            s = torch.cuda.Stream()
            with torch.cuda.stream(s):
                got = (gdn_backward_rows(xt, gm, b, gt, inverse)
                       + gdn_backward(xt, gm, b, gt, inverse))
            s.synchronize()
            if not all(torch.equal(p, q) for p, q in zip(got, want)):
                raise AssertionError(f"{name} backward {xt.dtype}: a "
                                     "side-stream launch differs from the "
                                     "main stream's bits")
        # no cast around the bf16 backward: as float32's, our two kernels
        # launched once each and nothing else recorded
        x, gm, b = _gdn_data(4_096, c, rng, dev)
        g = torch.randn(x.shape, generator=gen, device=dev)
        seen = [_bwd_kernel_names(xt, gm, b, gt, inverse)
                for xt, gt in ((x, g), (x.bfloat16(), g.bfloat16()))]
        for names, launched in seen:
            if launched != 2 or not names or not all("gdn_bwd" in n
                                                      for n in names):
                raise AssertionError(f"{name} backward: {launched} counted "
                                     f"launches, the profiler recorded "
                                     f"{names}")
        log(f"[3b backward] {name} ragged R {GDN_RAGGED_ROWS} and C = 1.."
            f"{MAX_CHANNELS} at R=333, float32 and bf16: max rel err "
            f"{worst:.2e}, bf16 bitwise the float32 path's; "
            f"{REPEAT_LAUNCHES // 3} launches at R=24576 bitwise alike and "
            f"R={GDN_BWD_ROWS[0]} on a side stream bitwise the main "
            f"stream's, both types; the bf16 backward through autograd, as "
            f"float32's, launched the kernel and its reduction once each and "
            f"the profiler recorded no other kernel ("
            f"{len(seen[1][0])} recorded)")
        out[name] = per_shape
    torch.cuda.empty_cache()
    return out


def _counted(fn, backward: bool = False):
    """Run fn with the kernel launch counts (forward and backward) set to 0
    just before; returns (fn's result, the forward counts just after), and
    with ``backward`` also the backward counts. Without it, a backward
    launch raises: no inference path may run one. The backward's reduction
    kernel must launch once per backward kernel launch."""
    from epic_tpu_torch.ops.gdn_kernel import (gdn, gdn_backward,
                                               gdn_backward_reduce)

    torch.cuda.synchronize()
    gdn.launches.update(gdn=0, igdn=0)
    gdn_backward.launches.update(gdn=0, igdn=0)
    gdn_backward_reduce.launches.update(gdn=0, igdn=0)
    out = fn()
    torch.cuda.synchronize()
    bwd = dict(gdn_backward.launches)
    red = dict(gdn_backward_reduce.launches)
    if red != bwd:
        raise AssertionError(f"the backward's reduction launched {red} "
                             f"times, the backward kernel {bwd}")
    if backward:
        return out, dict(gdn.launches), bwd
    if any(bwd.values()):
        raise AssertionError(f"an inference path launched the backward "
                             f"kernel: {bwd}")
    return out, dict(gdn.launches)


def _expect(tag: str, path: str, launches: dict, expect: dict) -> None:
    log(f"[{tag}] {path}: kernel launches {launches} (expected {expect})")
    if launches != expect:
        raise AssertionError(f"{path}: launch counts {launches} != {expect}")


def _encode_and_decode_levels(tag: str, codec, x, rems: bool):
    """Encode x, then decode levels 0..Q with one cache (and the encoder's
    checkpoint latents), each path's launches counted apart. Prints the
    times with their device / host rANS split. Returns (bitstreams,
    encoder state, [(x_hat, y_hat, decoded symbols)] per level, launches
    by path)."""
    import epic_tpu_torch as et
    from epic_tpu_torch.codec.progressive import decoded_symbols
    from epic_tpu_torch.tools.workload import decode_levels

    nq = len(et.DEFAULT_Q_LIST)
    enc_t, state = {}, {}
    t = time.perf_counter()
    (bs, _), enc_launches = _counted(lambda: et.progressive_encode(
        codec, x, rems=rems, timing=enc_t, state=state))
    enc_s = time.perf_counter() - t
    dec_t, outs, level_s = {}, [], []

    def walk():
        t = time.perf_counter()
        for lvl, out in decode_levels(codec, bs, dec_t, rems,
                                      state["auto_ckpts"]):
            level_s.append(time.perf_counter() - t)
            outs.append((out["x_hat"].clone(), out["y_hat"].clone(),
                         decoded_symbols(out["cache"]) if lvl else None))
            t = time.perf_counter()

    _, dec_launches = _counted(walk)
    log(f"[{tag}] encode {enc_s:.3f} s (device {enc_t['device_s']:.3f}, "
        f"host rANS {enc_t['rans_s']:.3f}); decode levels 0..{nq} "
        f"{sum(level_s):.3f} s (device {dec_t['device_s']:.3f}, host rANS "
        f"{dec_t['rans_s']:.3f})")
    log(f"[{tag}] per-level decode s: "
        + " ".join(f"{s:.4f}" for s in level_s)
        + f" (median {np.median(level_s):.4f}, worst {max(level_s):.4f})")
    # g_a x2 (3 GDN each); checkpoint latents skip g_s; g_s once per level
    _expect(tag, "encode", enc_launches, {"gdn": 6, "igdn": 0})
    _expect(tag, f"decode of levels 0..{nq}", dec_launches,
            {"gdn": 0, "igdn": 3 * (nq + 1)})
    return bs, state, outs, {"encode": enc_launches,
                             "decode": dec_launches}


def _check_levels(tag: str, codec, x, bs, state, outs) -> None:
    """Every decoded level bitwise equal to the encoder's own
    reconstruction (symbols, y_hat, x_hat); bpp non-decreasing, PSNR
    finite."""
    from epic_tpu_torch.tools.workload import H, W
    from epic_tpu_torch.utils.metrics import compute_psnr

    xt = torch.as_tensor(x, device=codec.device)
    prefix = bs["prefix"]
    base_bytes = sum(len(s) for s in bs["z"])
    p_flat = state["psym"].transpose(0, 1).reshape(1, -1).cpu().numpy()
    sid_flat = state["sid"].transpose(0, 1).reshape(1, -1).cpu().numpy()
    last_bpp = -1.0
    for lvl, (x_hat, y_hat, canvas) in enumerate(outs):
        with torch.no_grad():
            if lvl == 0:
                x_e, y_e = codec.synth_base(state["base_slices"])
            else:
                keep = state["sid"].to(torch.int32) < lvl
                x_e, y_e = codec.prog_reconstruct(
                    state["psym"] * keep, state["mu_s"], state["msups"],
                    state["base_slices"])
                want_sym = np.where(sid_flat < lvl, p_flat, 0)
                if not np.array_equal(canvas, want_sym):
                    raise AssertionError(f"level {lvl}: decoded symbols "
                                         "differ")
        if not (torch.equal(y_e, y_hat) and torch.equal(x_e, x_hat)):
            raise AssertionError(f"level {lvl}: y_hat/x_hat not bitwise "
                                 "equal to the encoder's")
        bpp = (base_bytes + float(prefix[0, lvl])) * 8.0 / (H * W)
        psnr = compute_psnr(x_hat, xt)
        if bpp < last_bpp or not math.isfinite(psnr) or \
                tuple(x_hat.shape) != (1, H, W, 3):
            raise AssertionError(f"level {lvl}: bpp {bpp} psnr {psnr} "
                                 f"shape {tuple(x_hat.shape)}")
        last_bpp = bpp
        log(f"[{tag}] level {lvl:2d}: bpp {bpp:.4f} psnr {psnr:.3f} dB, "
            "symbols and y_hat equal the encoder's")


def _warm_up(codec, warm, rems: bool) -> None:
    """One encode and decode of other data (cuDNN / cuBLAS handles, the
    allocator)."""
    import epic_tpu_torch as et
    from epic_tpu_torch.tools.workload import decode_levels

    st = {}
    bs, _ = et.progressive_encode(codec, warm, rems=rems, state=st)
    for _ in decode_levels(codec, bs, None, rems, st["auto_ckpts"]):
        pass
    if rems:
        et.progressive_decode_all(codec, bs, rems, st["auto_ckpts"])
    torch.cuda.synchronize()


def phase_pic_path():
    from epic_tpu_torch.tools.workload import full_width_codec, images

    t0 = time.perf_counter()
    codec = full_width_codec(0, name="pic")  # cuda
    x, warm = images()
    log(f"[4 pic] model + codec set up in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in codec.model.parameters()) / 1e6:.1f} M "
        "params)")
    _warm_up(codec, warm, False)
    bs, state, outs, _ = _encode_and_decode_levels("4 pic", codec, x, False)
    _check_levels("4 pic", codec, x, bs, state, outs)


def phase_main_path():
    """The flagship rem model: encode with REMs, decode of levels 0..15,
    decode_all; returns the launches by path."""
    import epic_tpu_torch as et
    from epic_tpu_torch.tools.workload import full_width_codec, images

    t0 = time.perf_counter()
    codec = full_width_codec(0)  # the flagship rem configuration, cuda
    x, warm = images()
    log(f"[5 main] model + codec set up in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in codec.model.parameters()) / 1e6:.1f} M "
        "params)")
    _warm_up(codec, warm, True)
    bs, state, outs, launches = _encode_and_decode_levels("5 main", codec, x,
                                                          True)
    nq = len(bs["q_list"])
    runs = []
    for k in range(2):
        t_all = {}
        t = time.perf_counter()
        out, n = _counted(lambda: et.progressive_decode_all(
            codec, bs, True, state["auto_ckpts"], t_all))
        log(f"[5 main] decode_all run {k + 1}: {time.perf_counter() - t:.3f}"
            f" s (device {t_all['device_s']:.3f}, host rANS "
            f"{t_all['rans_s']:.3f})")
        # the top level, g_s of the base, then all Q levels folded
        _expect("5 main", "decode_all", n, {"gdn": 0, "igdn": 9})
        runs.append(out["x_hat"])
    launches["decode_all"] = n
    if not torch.equal(runs[0], runs[1]):
        raise AssertionError("decode_all is not deterministic")
    x_all = runs[0]
    if tuple(x_all.shape) != (1 + nq,) + tuple(outs[0][0].shape):
        raise AssertionError(f"decode_all shape {tuple(x_all.shape)}")
    diffs = [float((x_all[lvl] - outs[lvl][0]).abs().max())
             for lvl in range(1 + nq)]
    log("[5 main] decode_all vs per-level decode, max abs diff by level: "
        + " ".join(f"{d:.2e}" for d in diffs)
        + f" (max {max(diffs):.3e}, tolerance {DECODE_ALL_ATOL}; twice "
        "bitwise equal)")
    if not max(diffs) <= DECODE_ALL_ATOL:
        raise AssertionError(f"decode_all differs from the per-level decode "
                             f"by {max(diffs)}")

    _check_levels("5 main", codec, x, bs, state, outs)
    prev = None
    for j, cl in enumerate(codec.model.check_levels):
        prev = codec.extract_checkpoint(x, cl, prev)
        if not torch.equal(prev, state["auto_ckpts"][j]):
            raise AssertionError(f"checkpoint latent {cl}: the encoder's "
                                 "differs from extract_checkpoint")
    with torch.no_grad():
        plain = codec.prog_params(state["base_slices"], state["lm"],
                                  state["ls"])
    d_scale = float((plain[1] - state["scale_s"]).abs().max())
    if d_scale == 0.0:
        raise AssertionError("REM-chained scales equal the plain chain's")
    log(f"[5 main] checkpoint latents at {codec.model.check_levels} bitwise "
        "equal to extract_checkpoint; REM-chained scales differ from the "
        f"plain chain's by up to {d_scale:.3e}")
    return launches


def phase_reference():
    """Small float32 models on the GPU against the same code on the CPU."""
    import epic_tpu_torch as et

    tiny = dict(n=32, m=32, division=(16, 32), dim_chunk=8,
                param_net_widths=(24, 16))
    x = np.random.default_rng(1).random((1, 64, 64, 3), dtype=np.float32)
    for name, cfg in (("pic", tiny), ("rem", dict(
            tiny, check_levels=(0.25, 0.75), rem_dimension="middle"))):
        states = []
        for device in ("cuda", "cpu"):
            codec = et.PICCodec(et.get_model(name, **cfg).init_weights(0),
                                device=device)
            st = {}
            et.progressive_encode(codec, x, rems=name == "rem", state=st)
            states.append({k: st[k].float().cpu()
                           for k in ("mu_s", "scale_s")})
        for k in ("mu_s", "scale_s"):
            err = float((states[0][k] - states[1][k]).abs().max())
            log(f"[6 reference] tiny f32 {name} model, GPU vs CPU {k}: max "
                f"abs diff {err:.2e} (tolerance 1e-3)")
            if not err <= 1e-3:
                raise AssertionError(f"{name} {k} differs between GPU and "
                                     f"CPU: {err}")


def _digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes."""
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def _sweep_record(res) -> dict:
    bs = res["bitstreams"]
    return {"y": bs["y"], "z": bs["z"], "prefix": bs["prefix"].tolist(),
            "bits": res["bits"], "x_hat": _digest(res["x_hat"])}


def phase_pipeline(smi: str):
    """bench.py's loop on the flagship rem model: 24 synthetic 768x512
    images, batch 4, SweepPipeline with 2 workers (max_in_flight 2). Each
    pipelined sweep (launches counted) must equal the same batch run
    serially, bitwise; then bench_loop's img/s, overlap, split, peak memory
    and per-level PSNR / MS-SSIM. Returns the pipelined launches."""
    from epic_tpu_torch.tools import workload as wl
    from epic_tpu_torch.utils.synthetic import to_f32

    t0 = time.perf_counter()
    codec = wl.full_width_codec(0)
    batches = wl.bench_batches(wl.N_IMAGES, wl.BATCH)
    dev = codec.device
    serial = [_sweep_record(wl.serial_sweep(codec, to_f32(u8, dev)))
              for u8 in batches[1:]]
    torch.cuda.synchronize()
    log(f"[7 pipeline] {len(serial)} serial sweeps of batch {wl.BATCH} "
        f"(reference) {time.perf_counter() - t0:.1f} s")
    got = {}
    run, n = _counted(lambda: wl.pipelined_sweeps(
        codec, batches[1:], wl.WORKERS,
        on_result=lambda k, res: got.__setitem__(k, _sweep_record(res))))
    log(f"[7 pipeline] pipelined run with x_hat digests: "
        f"{run['elapsed_s']:.3f} s")
    for k, want in enumerate(serial):
        if got.get(k) != want:
            diff = [f for f in want if got.get(k, {}).get(f) != want[f]]
            raise AssertionError(f"pipelined sweep {k} differs from serial "
                                 f"in {diff}")
    nsw = len(serial)
    _expect("7 pipeline", f"{nsw} pipelined sweeps", n,
            {"gdn": 6 * nsw, "igdn": 9 * nsw})
    log(f"[7 pipeline] {nsw} pipelined sweeps bitwise equal to serial "
        "(y, z, prefix, bits, x_hat SHA-256)")
    res = wl.bench_loop(codec, wl.N_IMAGES, wl.BATCH, wl.WORKERS)
    sp = res["split"]
    psnr, msssim = res["psnr"], res["msssim"]
    log(f"[7 pipeline] bench_loop: {res['n_images']} images in "
        f"{res['elapsed_s']:.3f} s = {res['img_per_s']:.3f} img/s pipelined,"
        f" {sp['sequential_img_per_s']:.3f} img/s sequential (sweeps "
        + ", ".join(f"{t:.3f}" for t in sp["sequential_sweeps_s"])
        + f" s), overlap speedup {sp['overlap_speedup']:.3f}; peak memory "
        f"{res['peak_mem_bytes'] / 2**30:.2f} GiB [{smi}]")
    log("[7 pipeline] split: " + json.dumps(
        {k: v for k, v in sp.items()}, default=float))
    log("[7 pipeline] per level (random weights: says nothing about "
        "compression): bpp " + " ".join(f"{v:.3f}" for v in res["bpp"])
        + "; PSNR " + " ".join(f"{v:.3f}" for v in psnr)
        + "; MS-SSIM " + " ".join(f"{v:.4f}" for v in msssim))
    if not (len(psnr) == len(msssim) == 16 and np.isfinite(psnr).all()
            and ((msssim >= 0) & (msssim <= 1)).all()):
        raise AssertionError(f"per-level PSNR {psnr} / MS-SSIM {msssim}")
    return n


def phase_random_access():
    """compress / decompress at one quality on the flagship rem model,
    batch 1: y_hat bitwise the encoder's; the receiver-side chain of
    check-level streams bitwise the encode's own checkpoint latents; the
    container round trip byte for byte. Returns the launches."""
    import epic_tpu_torch as et
    from epic_tpu_torch.tools.workload import full_width_codec, images

    codec = full_width_codec(0)
    x, _ = images()
    launches = {"gdn": 0, "igdn": 0}

    def counted(tag, fn, expect):
        t = time.perf_counter()
        out, n = _counted(fn)
        log(f"[8 random access] {tag}: {time.perf_counter() - t:.3f} s")
        _expect("8 random access", tag, n, expect)
        for k in launches:
            launches[k] += n[k]
        return out

    st = {}
    bs, _ = et.progressive_encode(codec, x, rems=True, state=st)
    ckpts = dict(zip(codec.model.check_levels, st["auto_ckpts"]))
    streams, rep = {}, None
    for q in (0.0, 0.25, 0.75, 10.0):
        # the check levels chain their latents, as the encode does
        enc = counted(f"compress q={q}", lambda: codec.compress(
            x, q, return_latents=True, checkpoint_rep=rep),
            {"gdn": 6, "igdn": 0})
        dec = counted(f"decompress q={q}", lambda: codec.decompress(
            enc, checkpoint_rep=rep), {"gdn": 0, "igdn": 3})
        y_enc = enc["y_hat"] if q > 0 else enc["y_hat_base"]
        if not torch.equal(dec["y_hat"], y_enc):
            raise AssertionError(f"q={q}: decompress y_hat differs from "
                                 "compress's")
        nbytes = sum(len(m) for sl in enc["strings"][0] for m in sl) + sum(
            len(m) for m in enc["strings"][1])
        log(f"[8 random access] q={q}: {nbytes * 8 / x[0, ..., 0].size:.4f}"
            f" bpp, y_hat bitwise equal, x_hat {tuple(dec['x_hat'].shape)}")
        if q in ckpts:
            if not torch.equal(y_enc, ckpts[q]):
                raise AssertionError(f"compress y_hat at {q} differs from "
                                     "the encode's checkpoint latent")
            streams[q], rep = enc, y_enc
    rep = None
    for q in codec.model.check_levels:
        rep = codec.decompress(streams[q], checkpoint_rep=rep)["y_hat"]
        if not torch.equal(rep, ckpts[q]):
            raise AssertionError(f"receiver-side checkpoint latent at {q} "
                                 "differs from the encoder's")
    bs["ckpt_streams"] = [{k: streams[q][k] for k in (
        "strings", "shape", "quality", "buffered", "io_chain")}
        for q in codec.model.check_levels]
    blob = et.dump_bitstreams(bs)
    back = et.load_bitstreams(blob)
    if et.dump_bitstreams(back) != blob or back["y"] != bs["y"]:
        raise AssertionError("container round trip changed the bytes")
    log(f"[8 random access] receiver chain over {codec.model.check_levels} "
        "bitwise equal to the encoder's checkpoint latents; container "
        f"({len(blob)} bytes with the check-level streams) round trip byte "
        "for byte")
    return launches


# phase 9: train_device's curriculum at flagship width, batch and patch as
# its defaults, a few steps of each stage
TRAIN_STEPS = {"first_train": 4, "refine_gs": 3, "refine_gs_ga": 3,
               "rems": 3}
TRAIN_BATCH, TRAIN_PATCH = 16, 256
# GDN / IGDN launches of one training forward, by stage: g_a_0 and g_a_1
# (3 GDN each); first_train synthesizes the base (g_s_0) and its one level
# (g_s_1), the single-quality stages g_s_1 alone (3 IGDN each). The
# backward launches the same layers (every gradient is computed, those of
# frozen parameters too: they enter the global-norm clip), but for rems'
# IGDNs: its loss is the rate alone, which x_hat does not touch.
STEP_LAUNCHES = {"first_train": {"gdn": 6, "igdn": 6},
                 "refine_gs": {"gdn": 6, "igdn": 3},
                 "refine_gs_ga": {"gdn": 6, "igdn": 3},
                 "rems": {"gdn": 6, "igdn": 3}}
STEP_BACKWARD = dict(STEP_LAUNCHES, rems={"gdn": 6, "igdn": 0})
# one single-quality forward without gradient (a validation forward, or a
# rems step's checkpoint latent): g_a_0 and g_a_1, then g_s_1
NO_GRAD_LAUNCHES = {"gdn": 6, "igdn": 3}
# a validation: 2 batches x 4 qualities x (the eval forward + the loss
# forward), single-quality, no gradient
VAL_FORWARDS = 16


def _train_args(save_path: str):
    from epic_tpu_torch.cli import train_device as td

    steps = ",".join(f"{k}={v}" for k, v in TRAIN_STEPS.items())
    return td.parse_args([
        "--save_path", save_path, "--N", "192", "--M", "640",
        "--division_dimension", "320", "640", "--dim_chunk", "32",
        "--param_net_widths", "224", "176", "128", "64",
        "--compute_dtype", "bfloat16", "--check_levels", "0.25", "0.75",
        "--check_levels_np", "24", "24", "--batch_size", str(TRAIN_BATCH),
        "--patch_size", str(TRAIN_PATCH), "--steps", steps,
        "--log_every", "1", "--val_every", "1000", "--ckpt_every", "1000"])


def _train_images():
    from epic_tpu_torch.utils.synthetic import synth_images

    imgs = synth_images(8, np.random.default_rng(0))
    return imgs, [i % 2 == 0 for i in range(len(imgs))]


def _terms(m) -> str:
    """A step's loss terms: rates, and the MSE of each level."""
    mse = "/".join(f"{v:.5f}" for v in m["mse_loss"].tolist())
    return (f"{float(m['loss']):.4f} (bpp base {float(m['bpp_base']):.4f} "
            f"scalable {float(m['bpp_scalable']):.4f} hype "
            f"{float(m['bpp_hype']):.4f}, mse {mse}, grad norm "
            f"{float(m['grad_norm']):.3e})")


def _stage_steps(dev) -> None:
    """Each stage's steps on one fixed batch through the package's pieces
    (``tools.profile_train.stage_runner``: make_stage, TrainState,
    make_train_step, the quality draw and the rems checkpoint latent):
    launches per step from zero, finite losses, frozen parameters bitwise
    unchanged, and first_train's loss falling."""
    import epic_tpu_torch as et
    from epic_tpu_torch.data.device_bank import (build_crop_bank,
                                                 make_device_sampler)
    from epic_tpu_torch.tools.profile_train import stage_model, stage_runner
    from epic_tpu_torch.tools.workload import PIC

    imgs, has_val = _train_images()
    batch = make_device_sampler(build_crop_bank(imgs, has_val, TRAIN_PATCH),
                                TRAIN_PATCH, TRAIN_BATCH, dev)(
        torch.Generator(device=dev).manual_seed(5))
    model = et.get_model("pic", **PIC).init_weights(0).to(dev)
    for stage, n_steps in TRAIN_STEPS.items():
        model = stage_model(stage, model)
        run, state = stage_runner(model, stage, lambda _: batch, dev)
        want = STEP_LAUNCHES[stage]
        if stage == "rems":  # and the checkpoint latent's forward
            want = {k: v + NO_GRAD_LAUNCHES[k] for k, v in want.items()}
        before = [p.detach().clone() for p in state.params]
        losses, times = [], []
        for i in range(n_steps):
            t = time.perf_counter()
            metrics, fwd, bwd = _counted(run, True)
            times.append(time.perf_counter() - t)
            _expect("9 training", f"{stage} step forward", fwd, want)
            _expect("9 training", f"{stage} step backward", bwd,
                    STEP_BACKWARD[stage])
            losses.append(float(metrics["loss"]))
            log(f"[9 training] {stage} step {i} on one fixed batch: loss "
                + _terms(metrics))
            if not math.isfinite(losses[-1]):
                raise AssertionError(f"{stage}: loss {losses[-1]}")
        changed = {n for n, p, b in zip(state.names, state.params, before)
                   if not torch.equal(p, b)}
        frozen = {n for n, t in zip(state.names, state.trainable)
                  if not t and n not in state.aux_names}
        if changed & frozen or not changed - set(state.aux_names):
            raise AssertionError(f"{stage}: frozen parameters changed "
                                 f"{sorted(changed & frozen)[:5]}, or no "
                                 "trainable one did")
        prefixes = sorted({n.split(".")[0] for n in changed})
        log(f"[9 training] {stage} on one fixed batch: step s "
            + " ".join(f"{v:.3f}" for v in times)
            + f"; {len(changed)} tensors changed ({', '.join(prefixes)}), "
            f"{len(frozen)} frozen ones bitwise unchanged")
        # From random weights at lr 1e-4 the fourth step's loss jumps (the
        # top level's MSE) and falls again by the sixth; it does so with
        # GDN's plain autograd in place of the kernels and in float32, and
        # not at a tenth of the lr (tools/train_witness.py, PERF.md). So
        # the loss must fall over the first three steps.
        if stage == "first_train" and not losses[0] > losses[1] > losses[2]:
            raise AssertionError(f"first_train loss did not fall on a fixed "
                                 f"batch: {losses}")
        del before
    del model, state
    torch.cuda.empty_cache()


def phase_training(smi: str, work: str):
    """train_device's curriculum at flagship width: first the steps of each
    stage through the package's pieces (_stage_steps); then
    ``cli.train_device.run`` on bench.py-style synthetic images, a few
    steps of each stage with a validation and a checkpoint at each stage's
    end (in ``work``/train), launches counted from zero over the whole run;
    the rems checkpoint loaded by ``load_checkpoint`` bitwise the trained
    weights, and a progressive encode / decode with them bitwise between
    encoder and decoder. Returns the run's (forward, backward) launches."""
    import epic_tpu_torch as et
    from epic_tpu_torch.cli import train_device as td
    from epic_tpu_torch.device import resolve_device
    from epic_tpu_torch.tools.workload import images

    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    _stage_steps(dev)
    log(f"[9 training] stage steps {time.perf_counter() - t0:.1f} s")
    imgs, has_val = _train_images()
    tmp = os.path.join(work, "train")
    t = time.perf_counter()
    res, fwd, bwd = _counted(lambda: td.run(_train_args(tmp), imgs,
                                            has_val), True)
    log(f"[9 training] train_device.run {time.perf_counter() - t:.1f} s")
    want_f, want_b = {"gdn": 0, "igdn": 0}, {"gdn": 0, "igdn": 0}
    for stage, n in TRAIN_STEPS.items():
        for k in want_f:
            # the steps, one validation, and in rems one checkpoint
            # latent per step
            no_grad = VAL_FORWARDS + (n if stage == "rems" else 0)
            want_f[k] += (n * STEP_LAUNCHES[stage][k]
                          + no_grad * NO_GRAD_LAUNCHES[k])
            want_b[k] += n * STEP_BACKWARD[stage][k]
    _expect("9 training", "train_device.run forward", fwd, want_f)
    _expect("9 training", "train_device.run backward", bwd, want_b)
    for stage, r in res["stages"].items():
        m = r["metrics"]
        if not (math.isfinite(m["loss"]) and math.isfinite(
                r["val"]["loss"])):
            raise AssertionError(f"{stage}: loss {m['loss']} val "
                                 f"{r['val']['loss']}")
        log(f"[9 training] {stage}: {r['steps']} steps, "
            f"{r['steps_per_s']:.3f} steps/s (train steps alone, batch "
            f"{TRAIN_BATCH} x {TRAIN_PATCH}^2), stage {r['seconds']:.1f}"
            f" s, peak memory {r['peak_mem_bytes'] / 2**30:.2f} GiB, "
            f"last loss {m['loss']:.4f} bpp {m['bpp_loss']:.4f} aux "
            f"{m['aux_loss']:.2f} grad norm {m['grad_norm']:.3e}, val "
            f"loss {r['val']['loss']:.4f} [{smi}]")
    trained = {k: v.detach().float().cpu()
               for k, v in res["model"].state_dict().items()}
    loaded, _, ck_step = et.load_checkpoint(os.path.join(tmp, "rems"))
    if ck_step != TRAIN_STEPS["rems"] or not all(
            torch.equal(v, trained[k])
            for k, v in loaded.state_dict().items()):
        raise AssertionError("the rems checkpoint differs from the "
                             "trained weights")
    nbytes = os.path.getsize(os.path.join(tmp, "rems", "last.npz"))
    del res
    torch.cuda.empty_cache()
    log(f"[9 training] rems checkpoint ({nbytes} bytes) loads bitwise the "
        f"trained weights ({len(trained)} tensors)")
    codec = et.PICCodec(loaded, device="cuda")
    x, _ = images()
    bs, state, outs, _ = _encode_and_decode_levels("9 training", codec, x,
                                                   True)
    _check_levels("9 training", codec, x, bs, state, outs)
    return fwd, bwd


# phases 10-11: WACNN at full width (artifacts/ckpt_r5_cnn/config.json)
WACNN = dict(n=192, m=320, dim_chunk=32,
             param_net_widths=(224, 176, 128, 64), compute_dtype="bfloat16")
CNN_STEPS = 3
# one WACNN forward: g_a (3 GDN), then g_s (3 IGDN); a training step
# launches as many backward. A validation: 2 batches x 1 quality x (the
# eval forward + the loss forward), without gradient
CNN_LAUNCHES = {"gdn": 3, "igdn": 3}
CNN_VAL_FORWARDS = 4
ZERO = {"gdn": 0, "igdn": 0}


def _add(total: dict, n: dict) -> None:
    for k in total:
        total[k] += n[k]


def _wacnn_round_trip(tag: str, codec, x) -> dict:
    """compress(buffered=True) then decompress of x, launches counted (3 GDN,
    then 3 IGDN): one y stream and one z stream per image; y_hat and x_hat
    bitwise the encoder's. Returns the launches by path."""
    b = x.shape[0]
    t = time.perf_counter()
    out, n_c = _counted(lambda: codec.compress(x, 0, return_latents=True,
                                               buffered=True))
    t_c = time.perf_counter() - t
    t = time.perf_counter()
    dec, n_d = _counted(lambda: codec.decompress(out))
    t_d = time.perf_counter() - t
    _expect(tag, f"compress batch {b}", n_c, {"gdn": 3, "igdn": 0})
    _expect(tag, f"decompress batch {b}", n_d, {"gdn": 0, "igdn": 3})
    y_strings, z_strings = out["strings"]
    if not (out["buffered"] and len(y_strings) == 1
            and len(y_strings[0]) == len(z_strings) == b):
        raise AssertionError(f"{tag}: not one y and one z stream per image")
    with torch.no_grad():
        x_enc = torch.clamp(codec.model.synthesize_base(out["y_hat_base"]),
                            0.0, 1.0)
    if not (torch.equal(dec["y_hat"], out["y_hat_base"])
            and torch.equal(dec["x_hat"], x_enc)):
        raise AssertionError(f"{tag}: decompress differs from the encoder")
    nbytes = sum(len(m) for m in y_strings[0] + z_strings)
    log(f"[{tag}] batch {b}: compress {t_c:.4f} s, decompress {t_d:.4f} s, "
        f"{nbytes * 8 / (b * x.shape[1] * x.shape[2]):.4f} bpp; y_hat and "
        "x_hat bitwise the encoder's")
    return {"compress": n_c, "decompress": n_d}


def phase_wacnn_codec() -> dict:
    """WACNN (full width, bf16, seed 0) on the synthetic 768x512 image at
    batch 1 and 2 (the image and its mirror); returns the launches by
    path."""
    import epic_tpu_torch as et
    from epic_tpu_torch.tools.workload import images

    t = time.perf_counter()
    codec = et.PICCodec(et.get_model("cnn", **WACNN).init_weights(0),
                        device="cuda")
    x, warm = images()
    log(f"[10 wacnn] model + codec set up in {time.perf_counter() - t:.1f} "
        f"s ({sum(p.numel() for p in codec.model.parameters()) / 1e6:.1f} M "
        "params)")
    _wacnn_round_trip("10 wacnn", codec, warm)  # warm-up
    launches = {"wacnn_compress": dict(ZERO), "wacnn_decompress": dict(ZERO)}
    for xb in (x, np.concatenate([x, warm])):
        n = _wacnn_round_trip("10 wacnn", codec, xb)
        _add(launches["wacnn_compress"], n["compress"])
        _add(launches["wacnn_decompress"], n["decompress"])
    return launches


def phase_wacnn_training(smi: str, work: str):
    """``cli.train_device.run(--model cnn)``: first_train for CNN_STEPS
    steps at batch 16, patch 256, with a validation and a checkpoint at the
    end (in ``work``/cnn); launches counted over the run; every loss finite;
    the checkpoint loaded by ``load_checkpoint`` bitwise the trained
    weights and coded with (compress / decompress bitwise). Returns
    (forward launches, backward launches, the checkpoint's directory)."""
    import epic_tpu_torch as et
    from epic_tpu_torch.cli import train_device as td
    from epic_tpu_torch.tools.workload import images

    save = os.path.join(work, "cnn")
    args = td.parse_args([
        "--save_path", save, "--model", "cnn", "--N", "192", "--M", "320",
        "--dim_chunk", "32", "--param_net_widths", "224", "176", "128", "64",
        "--compute_dtype", "bfloat16", "--batch_size", str(TRAIN_BATCH),
        "--patch_size", str(TRAIN_PATCH), "--steps",
        f"first_train={CNN_STEPS}", "--log_every", "1", "--val_every",
        "1000", "--ckpt_every", "1000"])
    imgs, has_val = _train_images()
    t = time.perf_counter()
    res, fwd, bwd = _counted(lambda: td.run(args, imgs, has_val), True)
    log(f"[11 wacnn training] train_device.run {time.perf_counter() - t:.1f}"
        " s")
    _expect("11 wacnn training", "run forward", fwd,
            {k: (CNN_STEPS + CNN_VAL_FORWARDS) * v
             for k, v in CNN_LAUNCHES.items()})
    _expect("11 wacnn training", "run backward", bwd,
            {k: CNN_STEPS * v for k, v in CNN_LAUNCHES.items()})
    r = res["stages"]["first_train"]
    m = r["metrics"]
    losses = [json.loads(line).get("loss") for line in open(
        os.path.join(save, "train_log.jsonl"))]
    losses = [v for v in losses if v is not None]
    if len(losses) != CNN_STEPS or not all(map(math.isfinite, losses)) \
            or not math.isfinite(r["val"]["loss"]):
        raise AssertionError(f"wacnn losses {losses}, val {r['val']}")
    log(f"[11 wacnn training] first_train: losses "
        + " ".join(f"{v:.4f}" for v in losses)
        + f"; {r['steps_per_s']:.3f} steps/s (train steps alone, batch "
        f"{TRAIN_BATCH} x {TRAIN_PATCH}^2), peak memory "
        f"{r['peak_mem_bytes'] / 2**30:.2f} GiB, bpp {m['bpp_loss']:.4f}, "
        f"val loss {r['val']['loss']:.4f} [{smi}]")
    ckpt = os.path.join(save, "first_train")
    trained = {k: v.detach().float().cpu()
               for k, v in res["model"].state_dict().items()}
    del res
    loaded, cfg, step = et.load_checkpoint(ckpt)
    if cfg["model"] != "cnn" or step != CNN_STEPS or not all(
            torch.equal(v, trained[k])
            for k, v in loaded.state_dict().items()):
        raise AssertionError("the WACNN checkpoint differs from the trained "
                             "weights")
    x, _ = images()
    _wacnn_round_trip("11 wacnn training", et.PICCodec(loaded, "cuda"), x)
    torch.cuda.empty_cache()
    return fwd, bwd, ckpt


def _write_filtered_png(path: str, rgb: np.ndarray) -> None:
    """An RGB8 PNG whose row y uses filter y % 5 (None, Sub, Up, Average,
    Paeth), as encoders that choose a filter per row write them."""
    h, w, _ = rgb.shape
    cur = rgb.reshape(h, w * 3).astype(np.int16)
    up = np.concatenate([np.zeros((1, w * 3), np.int16), cur[:-1]])
    left = np.pad(cur, ((0, 0), (3, 0)))[:, :-3]
    upleft = np.pad(up, ((0, 0), (3, 0)))[:, :-3]
    pa, pb = np.abs(up - upleft), np.abs(left - upleft)
    pc = np.abs(left + up - 2 * upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    kind = (np.arange(h) % 5)[:, None]
    pred = np.choose(kind, [0, left, up, (left + up) >> 1, paeth])
    rows = np.concatenate([kind.astype(np.uint8),
                           ((cur - pred) & 0xFF).astype(np.uint8)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))


def phase_file_cli(work: str, rems_ckpt: str, cnn_ckpt: str) -> dict:
    """``epic_tpu_torch.cli.codec`` on a seeded 768x512 image in two PNG
    files, one from the port's writer (filter 0) and one whose rows use all
    five filters: compress each with phase 9's rems checkpoint (equal
    files), ``info`` (as ``python -m``), decompress at levels 0, 7 and 15,
    each PNG read back bitwise the quantised ``progressive_decode`` output
    at that level (checkpoint latents from the file's check-level streams);
    then the filtered PNG with the WACNN checkpoint of phase 11, its PNG
    bitwise its ``decompress`` output. Returns the launches by path."""
    import epic_tpu_torch as et
    from epic_tpu_torch.cli import codec as cli
    from epic_tpu_torch.data.png import read_png, to_uint8, write_png
    from epic_tpu_torch.tools.workload import H, W
    from epic_tpu_torch.utils.synthetic import synthetic_image

    img = os.path.join(work, "image.png")
    filtered = os.path.join(work, "filtered.png")
    u8 = np.round(synthetic_image(H, W, seed=3)[0] * 255).astype(np.uint8)
    write_png(img, u8)
    _write_filtered_png(filtered, u8)
    for path in (img, filtered):
        t = time.perf_counter()
        got = read_png(path)
        log(f"[12 file cli] read_png {os.path.basename(path)} ({W}x{H}): "
            f"{(time.perf_counter() - t) * 1e3:.1f} ms")
        if not np.array_equal(got, u8):
            raise AssertionError(f"{path}: the PNG reader's pixels differ")
    launches = {"cli_compress": dict(ZERO), "cli_decompress": dict(ZERO)}

    def run(argv, expect):
        t = time.perf_counter()
        out, n = _counted(lambda: cli.main(argv))
        log(f"[12 file cli] {argv[0]} {os.path.basename(argv[2])} "
            f"{' '.join(argv[3:])}: {time.perf_counter() - t:.2f} s")
        _expect("12 file cli", argv[0], n, expect)
        _add(launches[f"cli_{argv[0]}"], n)
        return out

    ck = ["--checkpoint", rems_ckpt]
    epic = os.path.join(work, "rem.epic")
    # two check-level compresses, then the progressive encode: g_a_0 and
    # g_a_1 each time
    run(["compress", img, epic] + ck, {"gdn": 18, "igdn": 0})
    run(["compress", filtered, epic + "2"] + ck, {"gdn": 18, "igdn": 0})
    with open(epic, "rb") as f, open(epic + "2", "rb") as g:
        if f.read() != g.read():
            raise AssertionError("the two PNG files code to different files")
    info = subprocess.run([sys.executable, "-m", "epic_tpu_torch.cli.codec",
                           "info", epic], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()
    log("[12 file cli] python -m epic_tpu_torch.cli.codec info: " + info[0])
    codec = et.PICCodec(et.load_checkpoint(rems_ckpt)[0], device="cuda")
    with open(epic, "rb") as f:
        bs = et.load_bitstreams(f.read())
    with torch.no_grad():
        ckpts = cli.decode_checkpoints(codec, bs["ckpt_streams"])
    for level in (0, 7, 15):
        png = os.path.join(work, f"rem_level{level}.png")
        # the two check-level latents (g_s each), then the level's g_s
        got = run(["decompress", epic, png, "--level", str(level)] + ck,
                  {"gdn": 0, "igdn": 9})
        ref = et.progressive_decode(codec, bs, level, {}, rems=True,
                                    y_checkpoints=ckpts)["x_hat"]
        ref = to_uint8(ref[0].float().cpu().numpy())
        if not (np.array_equal(read_png(png), ref)
                and np.array_equal(got, ref)):
            raise AssertionError(f"level {level}: the decoded PNG differs "
                                 "from progressive_decode")
    ck = ["--checkpoint", cnn_ckpt]
    epic = os.path.join(work, "cnn.epic")
    run(["compress", filtered, epic] + ck, {"gdn": 3, "igdn": 0})
    png = os.path.join(work, "cnn.png")
    run(["decompress", epic, png] + ck, {"gdn": 0, "igdn": 3})
    codec = et.PICCodec(et.load_checkpoint(cnn_ckpt)[0], device="cuda")
    with open(epic, "rb") as f:
        st = dict(et.load_bitstreams(f.read())["ckpt_streams"][0])
    st["shape"] = tuple(st["shape"])
    ref = to_uint8(codec.decompress(st)["x_hat"][0].float().cpu().numpy())
    if not np.array_equal(read_png(png), ref):
        raise AssertionError("the WACNN PNG differs from decompress")
    log(f"[12 file cli] rem levels 0 / 7 / 15 and WACNN: each PNG bitwise "
        f"the codec's output ({os.path.getsize(epic)} bytes WACNN file)")
    return launches


def phase_rd_eval() -> dict:
    """``training.evaluate`` on the flagship rem model (random weights,
    REMs on) over 2 synthetic 768x512 images: ``rd_sweep`` (per-level bpp
    equal to what progressive_encode's bits give, non-decreasing over the
    16 levels) and ``compress_with_ac`` at 0 / 0.5 / 10. Returns the
    launches by path."""
    import epic_tpu_torch as et
    from epic_tpu_torch.tools.workload import H, W, full_width_codec
    from epic_tpu_torch.training.evaluate import (compress_with_ac,
                                                  extract_checkpoints,
                                                  rd_sweep)
    from epic_tpu_torch.utils.synthetic import synthetic_image

    codec = full_width_codec(0)
    imgs = [synthetic_image(H, W, seed=s)[0] for s in (1, 2)]
    cl = list(codec.model.check_levels)
    q = et.DEFAULT_Q_LIST
    t = time.perf_counter()
    res, n_rd = _counted(lambda: rd_sweep(codec, imgs, q, check_levels=cl))
    log(f"[13 rd eval] rd_sweep of 2 images {time.perf_counter() - t:.2f} s "
        f"(decode_all {res['decode_all_time']:.3f} s per image)")
    # per image: two checkpoint latents + the encode (g_a_0, g_a_1 each),
    # decode_all (9 IGDN)
    _expect("13 rd eval", "rd_sweep", n_rd, {"gdn": 36, "igdn": 18})
    want = np.zeros(len(q) + 1)
    for img in imgs:
        x = codec.as_input(img)[None]
        _, bits = et.progressive_encode(codec, x, q, rems=True,
                                        y_checkpoints=extract_checkpoints(
                                            codec, x, cl))
        for j in range(len(want)):
            want[j] += (bits[0] + bits[1] + sum(bits[2][:j])) / (H * W)
    want = (want / len(imgs)).tolist()
    if res["bpp"] != want or res["bpp"] != sorted(res["bpp"]) or not all(
            map(math.isfinite, res["psnr"] + res["ms_ssim_db"])):
        raise AssertionError(f"rd_sweep bpp {res['bpp']} (want {want}), "
                             f"psnr {res['psnr']}")
    log("[13 rd eval] rd_sweep per level (random weights): bpp "
        + " ".join(f"{v:.4f}" for v in res["bpp"]) + "; PSNR "
        + " ".join(f"{v:.3f}" for v in res["psnr"]) + "; MS-SSIM dB "
        + " ".join(f"{v:.3f}" for v in res["ms_ssim_db"])
        + "; bpp equal to progressive_encode's bits, non-decreasing")
    prs = (0.0, 0.5, 10.0)
    t = time.perf_counter()
    ac, n_ac = _counted(lambda: compress_with_ac(codec, imgs, prs,
                                                 check_levels=cl))
    log(f"[13 rd eval] compress_with_ac {time.perf_counter() - t:.2f} s: "
        + ", ".join(f"q={p} bpp {b:.4f} psnr {s:.3f} decode {d:.4f} s"
                    for p, b, s, d in zip(prs, ac["bpp"], ac["psnr"],
                                          ac["decode_time"])))
    # per image: two checkpoint latents, then per quality compress (6 GDN)
    # and decompress (3 IGDN)
    _expect("13 rd eval", "compress_with_ac", n_ac,
            {"gdn": 2 * (12 + 6 * len(prs)), "igdn": 2 * 3 * len(prs)})
    if not all(map(math.isfinite, ac["bpp"] + ac["psnr"])):
        raise AssertionError(f"compress_with_ac {ac}")
    return {"rd_sweep": n_rd, "compress_with_ac": n_ac}


def phase_first_train_vs_jax():
    """The JAX trainer's first_train losses (tests/fixtures/
    first_train_jax.json, written by tests/gen_torch_train_fixture.py) against
    the port's on the card: the same weights (init_weights(0), float32
    ``pic`` flagship) and batch (utils.synthetic.synth_batch), both held to
    the fixture's SHA-256; 6 steps with ``training=False`` at lr 1e-4
    through the kernels. Steps 0-2 within 1% relative; at step 3 both above
    (or both below) 3x step 2; steps 4-5 below step 3 in both. Returns the
    (forward, backward) launches."""
    import epic_tpu_torch as et
    from epic_tpu_torch.device import resolve_device
    from epic_tpu_torch.tools import train_witness as tw
    from epic_tpu_torch.tools.workload import PIC
    from epic_tpu_torch.utils.synthetic import synth_batch

    dev = resolve_device("cuda")
    with open(tw.FIXTURE) as f:
        fx = json.load(f)
    model = et.get_model("pic", **dict(PIC, compute_dtype="float32")) \
        .init_weights(fx["weights_seed"])
    batch = synth_batch(fx["batch"], fx["patch"], fx["batch_seed"])
    got = (tw.weights_sha256(model), tw.batch_sha256(batch))
    if got != (fx["weights_sha256"], fx["batch_sha256"]):
        raise AssertionError(f"weights / batch SHA-256 {got} differ from the "
                             "fixture's")
    steps = len(fx["steps"])
    model = model.to(dev)
    rows, fwd, bwd = _counted(lambda: tw.fixture_steps(
        model, torch.as_tensor(batch, device=dev), steps, fx["lr"]), True)
    want = {k: steps * v for k, v in STEP_LAUNCHES["first_train"].items()}
    _expect("14 first_train vs JAX", "forward", fwd, want)
    _expect("14 first_train vs JAX", "backward", bwd, want)
    jl = [r["loss"] for r in fx["steps"]]
    pl = [r["loss"] for r in rows]
    log(f"[14 first_train vs JAX] float32, batch {fx['batch']} x "
        f"{fx['patch']}^2, weights and batch SHA-256 equal the fixture's")
    for i, (j, p, jr, pr) in enumerate(zip(jl, pl, fx["steps"], rows)):
        log(f"[14 first_train vs JAX] step {i}: JAX {j:.4f} port {p:.4f} "
            f"(rel diff {abs(p - j) / j:.2e}); MSE JAX "
            + "/".join(f"{v:.5f}" for v in jr["mse"]) + " port "
            + "/".join(f"{v:.5f}" for v in pr["mse"]))
    close = all(abs(p - j) <= 0.01 * j for j, p in zip(jl[:3], pl[:3]))
    jump = (jl[3] > 3 * jl[2]) == (pl[3] > 3 * pl[2])
    after = all(v < s[3] for s in (jl, pl) for v in s[4:])
    if not (close and jump and after and all(map(math.isfinite, pl))):
        raise AssertionError(f"first_train: port {pl} against JAX {jl}")
    log(f"[14 first_train vs JAX] steps 0-2 within 1%; step 3 "
        f"{'jumps' if pl[3] > 3 * pl[2] else 'does not jump'} above 3x step "
        "2 in both, and falls after it in both")
    del model
    torch.cuda.empty_cache()
    return fwd, bwd


# phase 15: the host-loader trainer (cli.train) at its defaults of width,
# batch (16) and patch (256), float32, on PNG files written here: 18
# synthetic train images, a five-filter one and a palette one, 4 in the test
# split, 2 "kodak" test images, all 512 x 768
HOST_TRAIN, HOST_VALID, HOST_TEST = 18, 4, 2
HOST_VALID_BATCH = 4
# a validation: 4 batches x valid_epoch's 7 qualities x (the eval forward +
# the loss forward); an evaluation: compress_with_ac at 6 qualities and
# test_epoch at 15 on each test image
HOST_VAL_FORWARDS = 4 * 7 * 2
HOST_EVAL_PR, HOST_TEST_Q = 6, 15
HOST_RUNS = {"first_train": {"epochs": 2, "steps": 3},
             "rems": {"epochs": 1, "steps": 2}}
COMMITTED_FLAGSHIP_BYTES = 250_480_975  # artifacts/ckpt_r5_flagship/last.npz


def _check_artifact(ck_model, model) -> tuple:
    """Every array of the artifact's ``model`` the bf16 cast of the
    checkpoint's ``ck_model``, the stacked heads' dead rows zero; returns
    (dead-row entries, those of them nonzero in the checkpoint)."""
    from epic_tpu_torch.convert import _flatten, _stacked_dead_blocks
    from epic_tpu_torch.convert import to_jax_params
    from epic_tpu_torch.training.checkpoint import zero_dead_rows

    got = dict(_flatten(to_jax_params(model)))
    ck_tree = to_jax_params(ck_model)
    tree = zero_dead_rows(ck_tree, ck_model)
    for path, v in _flatten(tree):
        want = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
        if not np.array_equal(got[path], want):
            raise AssertionError(f"artifact {'/'.join(path)} is not the "
                                 "bf16 cast of the checkpoint's")
    dead = live = 0
    for name, count, slots in _stacked_dead_blocks(model):
        if (name, "Conv_0_kernel") not in got:
            continue
        a = got[(name, "Conv_0_kernel")]
        b = ck_tree[name]["Conv_0_kernel"]
        for i in range(count):
            pos, pad = slots(i)
            rows = (slice(i, i + 1), slice(None), slice(None),
                    slice(pos, pos + pad))
            if np.any(a[rows]):
                raise AssertionError(f"{name} slice {i}: dead rows not zero")
            dead += a[rows].size
            live += int(np.count_nonzero(b[rows]))
    return dead, live


def _write_palette_png(path: str, rgb: np.ndarray) -> np.ndarray:
    """rgb quantised to a 6 x 7 x 6 palette (252 entries) and written as an
    8-bit palette PNG (filter 0); returns the RGB image the file holds."""
    levels = np.array([6, 7, 6])
    idx = np.zeros(rgb.shape[:2], np.int64)
    for c, n in enumerate(levels):
        idx = idx * n + rgb[..., c].astype(np.int64) * n // 256
    grid = np.stack(np.meshgrid(*[np.arange(n) for n in levels],
                                indexing="ij"), -1).reshape(-1, 3)
    palette = (grid * 255 // (levels - 1)).astype(np.uint8)
    h, w = idx.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           idx.astype(np.uint8)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
                + chunk(b"PLTE", palette.tobytes())
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))
    return palette[idx]


def _host_trainer_data(root: str):
    """The PNG files of phase 15 under ``root``; returns (training dataset
    root, test directory). The five-filter and the palette file are read
    back bitwise."""
    from epic_tpu_torch.data.png import read_png, write_png
    from epic_tpu_torch.utils.synthetic import synth_images, synthetic_image

    dirs = {k: os.path.join(root, *p) for k, p in (
        ("train", ("trainset", "train", "data")),
        ("test", ("trainset", "test", "data")), ("kodak", ("kodak",)))}
    for d in dirs.values():
        os.makedirs(d)
    imgs = synth_images(HOST_TRAIN + 2 + HOST_VALID,
                        np.random.default_rng(15))
    for i in range(HOST_TRAIN):
        write_png(os.path.join(dirs["train"], f"im{i:02d}.png"), imgs[i])
    filtered = os.path.join(dirs["train"], "filtered.png")
    _write_filtered_png(filtered, imgs[HOST_TRAIN])
    palette = os.path.join(dirs["train"], "palette.png")
    want = _write_palette_png(palette, imgs[HOST_TRAIN + 1])
    if not (np.array_equal(read_png(filtered), imgs[HOST_TRAIN])
            and np.array_equal(read_png(palette), want)):
        raise AssertionError("the five-filter or the palette PNG reads back "
                             "wrong")
    for i in range(HOST_VALID):
        write_png(os.path.join(dirs["test"], f"v{i}.png"),
                  imgs[HOST_TRAIN + 2 + i])
    for i in range(HOST_TEST):
        img = synthetic_image(512, 768, seed=20 + i)[0]
        write_png(os.path.join(dirs["kodak"], f"kodim{i:02d}.png"),
                  np.round(img * 255).astype(np.uint8))
    return os.path.join(root, "trainset"), dirs["kodak"]


def _host_expected(stage: str, runs: dict = HOST_RUNS):
    """(forward, backward) launches of one ``cli.train`` run of phase 15
    (or of ``runs``): its steps, a rems step's checkpoint latent, the
    validations, and the evaluation at the last epoch (rems: two
    checkpoint latents per image first)."""
    from epic_tpu_torch.training.stages import make_stage

    r = runs[stage]
    n, rems = r["epochs"] * r["steps"], stage == "rems"
    if rems and min(make_stage("rems", check_levels=(0.25, 0.75),
                               check_levels_np=(24, 24)).list_quality) \
            <= 0.25:
        raise AssertionError("a rems quality at or below the first check "
                             "level takes no checkpoint latent")
    no_grad = (r["epochs"] * HOST_VAL_FORWARDS + HOST_TEST * HOST_TEST_Q
               + (n if rems else 0))
    fwd = {k: n * STEP_LAUNCHES[stage][k] + no_grad * NO_GRAD_LAUNCHES[k]
           for k in ZERO}
    fwd["gdn"] += HOST_TEST * (6 * HOST_EVAL_PR + (12 if rems else 0))
    fwd["igdn"] += HOST_TEST * 3 * HOST_EVAL_PR
    return fwd, {k: n * STEP_BACKWARD[stage][k] for k in ZERO}


def phase_host_trainer(smi: str, work: str):
    """``cli.train.main`` in this process on the card, at the JAX CLI's
    default width (N=192, M=640, division 320 / 640, dim_chunk 32), batch
    16, patch 256, float32, on PNG files read by the host loader: (a)
    first_train, 2 epochs of 3 steps with ``--patience 0`` and
    ``--eval_every 2`` (validations, the plateau, checkpoints, the real
    codec's evaluation); (b) rems with ``--model rem --checkpoint (a)``
    (the loader's fresh-bank path), 1 epoch of 2 steps; (c)
    ``tools.make_artifact`` on (b): every array equal to torch's bf16 cast
    of the float32 checkpoint's with the dead rows zeroed, and a
    progressive encode / decode of levels 0..15 with it bitwise between
    encoder and decoder. Launches per training step and per run from zero.
    Returns (forward, backward) launches."""
    import epic_tpu_torch as et
    from epic_tpu_torch.cli import train as cli_train
    from epic_tpu_torch.ops.gdn_kernel import gdn, gdn_backward
    from epic_tpu_torch.tools import make_artifact
    from epic_tpu_torch.tools.workload import images
    from epic_tpu_torch.training import step as step_mod

    t_phase = time.perf_counter()
    root = os.path.join(work, "host")
    train_root, kodak = _host_trainer_data(root)
    save = os.path.join(root, "ckpt")
    common = ["--training_dataset", train_root, "--test_dataset", kodak,
              "--save_path", save, "--valid_batch_size",
              str(HOST_VALID_BATCH)]
    argv = {
        "first_train": ["--eval_every", "2", "--patience", "0"],
        "rems": ["--model", "rem", "--checkpoint",
                 os.path.join(save, "first_train"), "--check_levels", "0.25",
                 "0.75", "--check_levels_np", "24", "24", "--dimension",
                 "middle"]}
    log(f"[15 host trainer] {HOST_TRAIN + 2} train PNGs (one five-filter, "
        f"one palette; both read back bitwise), {HOST_VALID} in the test "
        f"split, {HOST_TEST} test images, 512 x 768, written in "
        f"{time.perf_counter() - t_phase:.1f} s")
    per_step = []
    step_call = step_mod.TrainStep.__call__

    def counted_step(self, *args, **kwargs):
        f0, b0 = dict(gdn.launches), dict(gdn_backward.launches)
        t = time.perf_counter()
        out = step_call(self, *args, **kwargs)
        torch.cuda.synchronize()
        per_step.append(({k: gdn.launches[k] - f0[k] for k in f0},
                         {k: gdn_backward.launches[k] - b0[k] for k in b0},
                         time.perf_counter() - t))
        return out

    total_f, total_b = dict(ZERO), dict(ZERO)
    step_mod.TrainStep.__call__ = counted_step
    try:
        for stage, r in HOST_RUNS.items():
            per_step.clear()
            buf = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rep, fwd, bwd = _counted(lambda: cli_train.main(
                    common + argv[stage] + [
                        "--training_type", stage, "--epochs",
                        str(r["epochs"]), "--steps_per_epoch",
                        str(r["steps"])]), True)
            wall = time.perf_counter() - t
            for line in buf.getvalue().splitlines():
                log(f"[15 host trainer] cli.train {stage}: {line}")
            want = (STEP_LAUNCHES[stage], STEP_BACKWARD[stage])
            if len(per_step) != r["epochs"] * r["steps"] or any(
                    s[:2] != want for s in per_step):
                raise AssertionError(f"{stage}: launches per step {per_step}"
                                     f" (want {want} each, as a "
                                     "train_device step's)")
            walls = [s[2] for s in per_step]
            log(f"[15 host trainer] {stage}: each of {len(per_step)} steps "
                f"launched forward {want[0]}, backward {want[1]} (a "
                "train_device step's); TrainStep walls s "
                + " ".join(f"{v:.4f}" for v in walls) + ", warm "
                f"{(len(walls) - 1) / sum(walls[1:]):.3f} steps/s")
            want_f, want_b = _host_expected(stage)
            _expect("15 host trainer", f"cli.train {stage} forward", fwd,
                    want_f)
            _expect("15 host trainer", f"cli.train {stage} backward", bwd,
                    want_b)
            _add(total_f, fwd)
            _add(total_b, bwd)
            out = buf.getvalue()
            if stage == "rems" and "initialized REM banks fresh" not in out:
                raise AssertionError("rems: no fresh REM banks from the "
                                     "first_train checkpoint")
            tm = rep["timers"]
            val = rep["val"]
            if not (math.isfinite(rep["train_loss"])
                    and math.isfinite(val["loss"])
                    and all(map(math.isfinite, rep["real"]["bpp"]
                                + rep["real"]["psnr"]))):
                raise AssertionError(f"{stage}: train loss "
                                     f"{rep['train_loss']}, val {val}, "
                                     f"real {rep['real']}")
            log(f"[15 host trainer] {stage}: {rep['steps']} steps in "
                f"{wall:.1f} s, {rep['steps_per_s']:.3f} steps/s (steps "
                f"alone, first included, batch 16 x 256^2, float32), peak "
                f"memory {rep['peak_mem_bytes'] / 2**30:.2f} GiB; load "
                f"{tm['load']['mean_ms'] / 1e3:.4f} s per batch (16 PNG "
                f"crops on 8 threads, to the card) against "
                f"{tm['step']['mean_ms'] / 1e3:.4f} s per step; "
                f"validation {tm['valid']['total_s']:.2f} s "
                f"({tm['valid']['count']}x), evaluation "
                f"{tm['eval']['total_s']:.2f} s, checkpoint save "
                f"{tm['save']['total_s']:.2f} s ({tm['save']['count']}x); "
                f"train loss {rep['train_loss']:.4f}, val loss "
                f"{val['loss']:.4f}, lr {rep['lr']:.2e}; RD plot "
                + (f"written ({rep['plot']})" if rep["plot"] else
                   "not written (no matplotlib)") + f" [{smi}]")
    finally:
        step_mod.TrainStep.__call__ = step_call

    rems_dir = os.path.join(save, "rems")
    art = os.path.join(root, "artifact")
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rec = make_artifact.main([rems_dir, art])
    art_s = time.perf_counter() - t
    which = rec["src"].rsplit("/", 1)[1]
    f32_bytes = os.path.getsize(os.path.join(rems_dir, which + ".npz"))
    nbytes = os.path.getsize(rec["out"])
    log(f"[15 host trainer] make_artifact: {buf.getvalue().strip()}")
    ck_model = et.load_checkpoint(rems_dir, which)[0]
    model, cfg, step = et.load_checkpoint(art)
    if cfg["model"] != "rem" or step != rec["step"]:
        raise AssertionError(f"artifact config {cfg['model']} step {step}")
    dead, live = _check_artifact(ck_model, model)
    log(f"[15 host trainer] artifact {nbytes} bytes (float32 checkpoint "
        f"{f32_bytes}; the committed trained flagship "
        f"{COMMITTED_FLAGSHIP_BYTES}) in {art_s:.1f} s (load + bf16 + zlib "
        f"on the host); every array the bf16 cast of the checkpoint's, "
        f"{dead} dead-row entries zero ({live} of them nonzero in the "
        f"checkpoint) [{smi}]")
    codec = et.PICCodec(model, device="cuda")
    x, _ = images()
    bs, state, outs, n = _encode_and_decode_levels("15 host trainer", codec,
                                                   x, True)
    _check_levels("15 host trainer", codec, x, bs, state, outs)
    _add(total_f, n["encode"])
    _add(total_f, n["decode"])
    del codec, model, ck_model
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    log(f"[15 host trainer] phase {secs:.1f} s")
    if secs > 300:
        raise AssertionError(f"phase 15 took {secs:.1f} s (limit 300 s)")
    return total_f, total_b


# phase 16: the non-default PIC options at flagship width
OPT_QUALITIES = (0.5, 0.75, 5.0, 10.0)
OPT_RUNS = {"first_train": {"epochs": 1, "steps": 3},
            "rems": {"epochs": 1, "steps": 2}}


def _cli_counted(tag: str, argv, stage: str, runs: dict, smi: str):
    """``cli.train.main(argv)`` in this process, launches counted per
    step (each equal to a ``train_device`` step's) and over the run
    (``_host_expected``). Returns (report, forward, backward launches)."""
    from epic_tpu_torch.cli import train as cli_train
    from epic_tpu_torch.ops.gdn_kernel import gdn, gdn_backward
    from epic_tpu_torch.training import step as step_mod

    per_step = []
    step_call = step_mod.TrainStep.__call__

    def counted_step(self, *args, **kwargs):
        f0, b0 = dict(gdn.launches), dict(gdn_backward.launches)
        t = time.perf_counter()
        out = step_call(self, *args, **kwargs)
        torch.cuda.synchronize()
        per_step.append(({k: gdn.launches[k] - f0[k] for k in f0},
                         {k: gdn_backward.launches[k] - b0[k] for k in b0},
                         time.perf_counter() - t))
        return out

    step_mod.TrainStep.__call__ = counted_step
    try:
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rep, fwd, bwd = _counted(lambda: cli_train.main(argv), True)
        wall = time.perf_counter() - t
    finally:
        step_mod.TrainStep.__call__ = step_call
    for line in buf.getvalue().splitlines():
        log(f"[{tag}] cli.train {stage}: {line}")
    want = (STEP_LAUNCHES[stage], STEP_BACKWARD[stage])
    r = runs[stage]
    if len(per_step) != r["epochs"] * r["steps"] or any(
            s[:2] != want for s in per_step):
        raise AssertionError(f"{stage}: launches per step {per_step} (want "
                             f"{want} each, as phase 15's)")
    want_f, want_b = _host_expected(stage, runs)
    _expect(tag, f"cli.train {stage} forward", fwd, want_f)
    _expect(tag, f"cli.train {stage} backward", bwd, want_b)
    if not (math.isfinite(rep["train_loss"])
            and math.isfinite(rep["val"]["loss"])
            and all(map(math.isfinite, rep["real"]["bpp"]
                        + rep["real"]["psnr"]))):
        raise AssertionError(f"{stage}: train loss {rep['train_loss']}, "
                             f"val {rep['val']}, real {rep['real']}")
    walls = [s[2] for s in per_step]
    tm = rep["timers"]
    log(f"[{tag}] {stage}: {rep['steps']} steps in {wall:.1f} s, each "
        f"launching forward {want[0]}, backward {want[1]} (phase 15's); "
        f"{rep['steps_per_s']:.3f} steps/s (first included; warm "
        f"{(len(walls) - 1) / sum(walls[1:]):.3f}), peak memory "
        f"{rep['peak_mem_bytes'] / 2**30:.2f} GiB; validation "
        f"{tm['valid']['total_s']:.2f} s, evaluation "
        f"{tm['eval']['total_s']:.2f} s, save {tm['save']['total_s']:.2f} s;"
        f" train loss {rep['train_loss']:.4f}, val loss "
        f"{rep['val']['loss']:.4f} [{smi}]")
    return rep, fwd, bwd


def phase_options(smi: str, work: str):
    """The options of ``all_scalable=False`` and the three others on the
    flagship ``rem`` model (bf16, random weights from seed 0) on the
    768x512 image at batch 1: (a) ``compress`` / ``decompress`` at
    OPT_QUALITIES through the interleaved codec, the REM checkpoint chain
    where the quality is above a check level (0.25's latent from
    ``extract_checkpoint``, 0.75's from the compress at 0.75), the
    decoder's y_hat and x_hat bitwise the encoder's, 6 GDN per compress,
    3 IGDN per decompress; ``progressive_encode`` refused; (b) one bitwise
    round trip at 0.5 with ``delta_encode``, ``total_mu_rep`` off and with
    the "two-levels" policy (the same weights: the options change no
    shape); (c) ``cli.train.main --no_all_scalable`` at the JAX CLI's
    defaults (float32, batch 16, patch 256) on phase 15's PNG files:
    first_train 1 epoch of 3 steps, then ``--model rem`` from it, 1 epoch
    of 2 steps. Returns (forward, backward) launches. Within 200 s."""
    import epic_tpu_torch as et
    from epic_tpu_torch.tools.workload import FLAGSHIP, images

    tag = "16 options"
    t_phase = time.perf_counter()
    model = et.get_model("rem", **dict(FLAGSHIP, all_scalable=False))
    codec = et.PICCodec(model.init_weights(0), device="cuda")
    x, warm = images()
    log(f"[{tag}] flagship rem, all_scalable=False, set up in "
        f"{time.perf_counter() - t_phase:.1f} s")
    total_f, total_b = dict(ZERO), dict(ZERO)

    def counted(what, fn, expect):
        t = time.perf_counter()
        out, n = _counted(fn)
        secs = time.perf_counter() - t
        _expect(tag, what, n, expect)
        _add(total_f, n)
        return out, secs

    def round_trip(q, rep, label=""):
        enc, enc_s = counted(f"{label}compress q={q}", lambda: codec.compress(
            x, q, return_latents=True, checkpoint_rep=rep),
            {"gdn": 6, "igdn": 0})
        timing = {}
        dec, dec_s = counted(f"{label}decompress q={q}",
                             lambda: codec.decompress(
                                 enc, checkpoint_rep=rep, timing=timing),
                             {"gdn": 0, "igdn": 3})
        with torch.no_grad():
            x_enc, _ = counted(f"{label}encoder x_hat q={q}",
                               lambda: torch.clamp(model.synthesize_prog(
                                   enc["y_hat"]), 0.0, 1.0),
                               {"gdn": 0, "igdn": 3})
        if not (torch.equal(dec["y_hat"], enc["y_hat"])
                and torch.equal(dec["x_hat"], x_enc)):
            raise AssertionError(f"{label}q={q}: the decoder's y_hat / x_hat"
                                 " differ from the encoder's")
        trips = timing.get("slice_round_trip_s", [])
        nbytes = sum(len(m) for sl in enc["strings"][0] for m in sl) + sum(
            len(m) for m in enc["strings"][1])
        log(f"[{tag}] {label}q={q}: compress {enc_s:.3f} s, decompress "
            f"{dec_s:.3f} s" + (f" ({len(trips)} slice round trips "
                                f"{sum(trips):.3f} s: "
                                + " ".join(f"{s:.4f}" for s in trips) + ")"
                                if trips else "")
            + f", {nbytes * 8 / x[0, ..., 0].size:.4f} bpp; y_hat and x_hat"
            " bitwise the encoder's")
        return enc

    round_trip(0.5, None, "warm-up ")  # cuDNN / cuBLAS handles
    c0, c0_s = counted("extract_checkpoint 0.25", lambda:
                       codec.extract_checkpoint(x, 0.25),
                       {"gdn": 6, "igdn": 0})
    ckpts = {0.25: c0}
    for q in OPT_QUALITIES:
        rep = ckpts[max(c for c in ckpts if c < q)]
        enc = round_trip(q, rep)
        if q == 0.75:
            ckpts[0.75] = enc["y_hat"]
            again, _ = counted("extract_checkpoint 0.75", lambda:
                               codec.extract_checkpoint(x, 0.75, c0),
                               {"gdn": 6, "igdn": 0})
            if not torch.equal(again, enc["y_hat"]):
                raise AssertionError("extract_checkpoint at 0.75 differs "
                                     "from the compress's latent")
    try:
        et.progressive_encode(codec, x)
    except ValueError as e:
        log(f"[{tag}] progressive_encode refused: {e}")
    else:
        raise AssertionError("progressive_encode took an all_scalable=False "
                             "model")
    model.all_scalable = True
    for attr, value in (("delta_encode", False), ("total_mu_rep", False),
                        ("mask_policy", "two-levels")):
        default = getattr(model, attr)
        setattr(model, attr, value)
        round_trip(0.5, c0, f"{attr}={value} ")
        setattr(model, attr, default)
    del codec, model
    torch.cuda.empty_cache()

    root = os.path.join(work, "host")
    if not os.path.isdir(os.path.join(root, "trainset")):
        _host_trainer_data(root)
    save = os.path.join(work, "options")
    common = ["--training_dataset", os.path.join(root, "trainset"),
              "--test_dataset", os.path.join(root, "kodak"), "--save_path",
              save, "--valid_batch_size", str(HOST_VALID_BATCH),
              "--no_all_scalable", "--epochs", "1"]
    argv = {"first_train": ["--steps_per_epoch", "3"],
            "rems": ["--steps_per_epoch", "2", "--model", "rem",
                     "--checkpoint", os.path.join(save, "first_train"),
                     "--check_levels", "0.25", "0.75", "--check_levels_np",
                     "24", "24", "--dimension", "middle"]}
    for stage in OPT_RUNS:
        _, fwd, bwd = _cli_counted(tag, common + argv[stage] + [
            "--training_type", stage], stage, OPT_RUNS, smi)
        _add(total_f, fwd)
        _add(total_b, bwd)
        loaded = et.load_checkpoint(os.path.join(save, stage))[0]
        if loaded.all_scalable:
            raise AssertionError(f"{stage}: the checkpoint lost "
                                 "all_scalable=False")
        del loaded
    secs = time.perf_counter() - t_phase
    log(f"[{tag}] phase {secs:.1f} s")
    if secs > 200:
        raise AssertionError(f"phase 16 took {secs:.1f} s (limit 200 s)")
    return total_f, total_b


# phase 17: the data-parallel layer. The NCCL train step at flagship width,
# float32 (as cli.train builds it), first_train, on one global batch; then
# the multi-process RD sweep with the flagship pic on 4 768x512 images.
PAR_BATCH, PAR_PATCH, PAR_STEPS, PAR_LOSS_RTOL = 16, 256, 3, 1e-5
SWEEP_IMAGES = 4


def _par_model():
    import epic_tpu_torch as et
    from epic_tpu_torch.tools.workload import PIC

    return et.get_model("pic", **dict(PIC, compute_dtype="float32")) \
        .init_weights(0)


def _par_batch() -> np.ndarray:
    return np.random.default_rng(17).random(
        (PAR_BATCH, PAR_PATCH, PAR_PATCH, 3), dtype=np.float32)


def _params_digest(model) -> str:
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def parallel_rank(rank: int, world: int, port: int, out: str) -> None:
    """One NCCL rank of phase 17 (``chip_smoke.py --parallel-rank``): its
    rows of the global batch through ``make_parallel_train_step``
    (``training=False``), PAR_STEPS steps; writes the losses, the step
    walls, the kernels' launches over the steps, the parameters' SHA-256
    and the peak memory to ``out``."""
    from epic_tpu_torch.ops.gdn_kernel import (gdn, gdn_backward,
                                               gdn_backward_reduce)
    from epic_tpu_torch.parallel import (init_multihost, make_mesh,
                                         make_parallel_train_step, replicate,
                                         shard_batch)
    from epic_tpu_torch.training.stages import make_stage
    from epic_tpu_torch.training.state import TrainState

    init_multihost(f"localhost:{port}", world, rank, "nccl")
    mesh = make_mesh()
    model = _par_model().to(mesh.device)
    state = replicate(TrainState(model), mesh)
    step = make_parallel_train_step(model, make_stage("first_train"), mesh,
                                    training=False)
    x = shard_batch(_par_batch(), mesh)
    gdn.launches.update(ZERO)
    gdn_backward.launches.update(ZERO)
    gdn_backward_reduce.launches.update(ZERO)
    losses, walls = _timed_steps(step, state, x)
    if dict(gdn_backward_reduce.launches) != dict(gdn_backward.launches):
        raise AssertionError(f"rank {rank}: the backward's reduction "
                             f"launched {dict(gdn_backward_reduce.launches)}"
                             f", the kernel {dict(gdn_backward.launches)}")
    res = {"rank": rank, "world": world, "losses": losses, "walls": walls,
           "launches": dict(gdn.launches),
           "backward": dict(gdn_backward.launches),
           "digest": _params_digest(model),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(mesh.device)}
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_procs(tag: str, cmds, work: str, timeout: float = 300):
    """Start the commands together (from the repository's root, output to
    files under ``work``, so that no process blocks on a full pipe) and
    wait for all, killing what is left after ``timeout`` seconds; any
    failure raises with its output. Returns their outputs."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    logs = [os.path.join(work, f"proc{i}.log") for i in range(len(cmds))]
    procs = [subprocess.Popen(c, cwd=root, env=env, stdout=open(lg, "w"),
                              stderr=subprocess.STDOUT)
             for c, lg in zip(cmds, logs)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [open(lg).read() for lg in logs]
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"[{tag}] a process exited with "
                                 f"{p.returncode}:\n{o[-4000:]}")
    return outs


def phase_parallel(smi: str, work: str, sweep_too: bool = True):
    """(a) ``make_parallel_train_step`` over NCCL, one rank per card
    (``torch.cuda.device_count()``), each a process of its own: first_train
    at flagship width, float32, a global batch of 16 at 256^2,
    ``training=False``, PAR_STEPS steps; against the single-process
    ``TrainStep`` on the same batch in this process: with one rank, the
    losses and the parameters bitwise; with more, the losses within
    PAR_LOSS_RTOL relative and every rank's parameters bitwise each
    other's. (b) ``tools.multihost_rd_sweep`` with the flagship ``pic``
    (bf16) on 4 synthetic 768x512 images: 2 processes sharing the card
    (their rows gathered over gloo) against 1 process (in this process,
    its launches counted): rows bitwise; skipped without ``sweep_too``.
    Returns the launches of its paths: (forward, backward) by path."""
    from epic_tpu_torch.device import resolve_device
    from epic_tpu_torch.tools import multihost_rd_sweep as sweep
    from epic_tpu_torch.training.stages import make_stage
    from epic_tpu_torch.training.state import TrainState
    from epic_tpu_torch.training.step import TrainStep

    tag = "17 parallel"
    world = torch.cuda.device_count()
    port = _free_port()
    outs = [os.path.join(work, f"rank{r}.json") for r in range(world)]
    t = time.perf_counter()
    _run_procs(tag, [[sys.executable, os.path.abspath(__file__),
                      "--parallel-rank", str(r), str(world), str(port),
                      outs[r]] for r in range(world)], work)
    ranks_s = time.perf_counter() - t
    ranks = [json.load(open(o)) for o in outs]
    steps_f = {k: PAR_STEPS * v for k, v in STEP_LAUNCHES["first_train"]
               .items()}
    steps_b = {k: PAR_STEPS * v for k, v in STEP_BACKWARD["first_train"]
               .items()}
    # the single-process TrainStep on the global batch, on card 0, with
    # the entry points' settings (TF32 off, deterministic cuDNN)
    t = time.perf_counter()
    dev = resolve_device()
    model = _par_model().to(dev)
    state = TrainState(model)
    step = TrainStep(model, make_stage("first_train"), training=False)
    x = torch.from_numpy(_par_batch()).to(dev)
    torch.cuda.reset_peak_memory_stats()
    (losses, walls), fwd, bwd = _counted(lambda: _timed_steps(step, state,
                                                              x), True)
    single_s = time.perf_counter() - t
    _expect(tag, "TrainStep forward", fwd, steps_f)
    _expect(tag, "TrainStep backward", bwd, steps_b)
    digest = _params_digest(model)
    peak = torch.cuda.max_memory_allocated()
    del model, state, step, x
    torch.cuda.empty_cache()
    par_f, par_b = dict(ZERO), dict(ZERO)
    rel = 0.0
    for r in ranks:
        _expect(tag, f"rank {r['rank']} forward", r["launches"], steps_f)
        _expect(tag, f"rank {r['rank']} backward", r["backward"], steps_b)
        _add(par_f, r["launches"])
        _add(par_b, r["backward"])
        if r["digest"] != ranks[0]["digest"]:
            raise AssertionError("the ranks' parameters differ")
        worst = max(abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                       losses))
        rel = max(rel, worst)
        if world == 1 and (r["losses"] != losses or r["digest"] != digest):
            raise AssertionError(f"1-rank NCCL step {r['losses']} / "
                                 f"{r['digest'][:12]} differs from "
                                 f"TrainStep's {losses} / {digest[:12]}")
        if worst > PAR_LOSS_RTOL:
            raise AssertionError(f"rank {r['rank']} losses {r['losses']} "
                                 f"against TrainStep's {losses}")
    warm = [sum(r["walls"][1:]) for r in ranks]
    log(f"[{tag}] {world} NCCL rank(s), {PAR_BATCH // world} rows each of "
        f"{PAR_PATCH}^2, first_train float32, training=False: losses "
        + " ".join(f"{v:.7f}" for v in ranks[0]["losses"])
        + "; TrainStep on the global batch " + " ".join(
            f"{v:.7f}" for v in losses)
        + (" (bitwise, parameters bitwise)" if world == 1 else
           f" (max rel diff {rel:.2e}; the ranks' parameters bitwise "
           "equal)")
        + f"; steps/s warm {(PAR_STEPS - 1) / max(warm):.3f} ({world} "
        f"rank(s); step walls rank 0 "
        + " ".join(f"{v:.4f}" for v in ranks[0]["walls"])
        + f"), TrainStep warm {(PAR_STEPS - 1) / sum(walls[1:]):.3f} "
        "steps/s (walls " + " ".join(f"{v:.4f}" for v in walls)
        + "); peak memory per rank "
        + " ".join(f"{r['peak_mem_bytes'] / 2**30:.2f}" for r in ranks)
        + f" GiB, TrainStep {peak / 2**30:.2f} GiB; ranks' processes "
        f"{ranks_s:.1f} s, TrainStep {single_s:.1f} s [{smi}]")

    launches = ({"parallel_train_step": par_f, "train_step_reference": fwd},
                {"parallel_train_step": par_b, "train_step_reference": bwd})
    if not sweep_too:
        return launches
    argv = ["--n_images", str(SWEEP_IMAGES), "--height", "512", "--width",
            "768"]
    port = _free_port()
    code = ("import sys; from epic_tpu_torch.tools.multihost_rd_sweep "
            "import main; from epic_tpu_torch.tools.workload import PIC; "
            "main(sys.argv[1:], PIC)")
    t = time.perf_counter()
    two = _run_procs(tag, [[sys.executable, "-c", code] + argv + [
        "--num_processes", "2", "--process_id", str(r), "--coordinator",
        f"localhost:{port}"] for r in range(2)], work)
    two_s = time.perf_counter() - t
    line = [ln for ln in two[0].splitlines() if ln.startswith("RDSWEEP ")]
    pair = json.loads(line[0][len("RDSWEEP "):])
    from epic_tpu_torch.tools.workload import PIC

    t = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        single, n_sweep = _counted(lambda: sweep.main(argv, PIC))
    one_s = time.perf_counter() - t
    # per image: the encode (g_a_0, g_a_1) and decode_all (9 IGDN)
    _expect(tag, "multihost_rd_sweep, 1 process", n_sweep,
            {"gdn": 6 * SWEEP_IMAGES, "igdn": 9 * SWEEP_IMAGES})
    if pair["rows"] != single["rows"] or pair["processes"] != 2:
        raise AssertionError(f"2-process rows {pair['rows']} differ from "
                             f"1 process's {single['rows']}")
    log(f"[{tag}] multihost_rd_sweep, flagship pic on {SWEEP_IMAGES} "
        f"768x512 images: 2 processes sharing the card {two_s:.1f} s "
        f"(coding {pair['code_s']:.2f} s of rank 0's {pair['total_s']:.1f} "
        f"s), 1 process {one_s:.1f} s (coding {single['code_s']:.2f} s); "
        "rows bitwise equal; top-level bpp / PSNR per image "
        + ", ".join(f"{r[len(sweep.Q_LIST) + 1]:.4f} / {r[-1]:.3f}"
                    for r in single["rows"]) + f" [{smi}]")
    launches[0]["multihost_rd_sweep"] = n_sweep
    return launches


# phase 18: the image fixtures (tests/gen_torch_image_fixtures.py), the
# 768x512 JPEG files timed and copied into the loader's folder, and the
# level that extend_rem_banks adds to phase 9's check levels
IMAGE_FIXTURES = os.path.join("tests", "fixtures", "images")
TIMED_JPEGS = ("photo768_baseline.jpg", "photo768_progressive.jpg")
LOADER_COPIES, LOADER_BATCH, LOADER_STEPS = 16, 16, 6
EXTEND_LEVEL = 1.75
PHASE18_LIMIT_S = 150
# one eval_checkpoint call on a rem checkpoint with two check levels: the
# plain estimate (one multi-quality forward: g_a_0 + g_a_1, g_s_0 + g_s_1),
# the plain ladder (encode, decode_all), the shell table (an encode), the
# REM ladder (two checkpoint extractions, encode, decode_all) and the
# per-quality REM rows (two extractions, then at 1 / 2 / 4 / 10 two
# compresses and two decompresses)
EVAL_CKPT_LAUNCHES = {"gdn": 6 + 6 + 6 + (12 + 6) + (12 + 4 * 12),
                      "igdn": 6 + 9 + 9 + 4 * 2 * 3}
# eval_cnn, one group: the estimate's forward (g_a, g_s), compress (g_a),
# decompress (g_s)
EVAL_CNN_LAUNCHES = {"gdn": 6, "igdn": 6}


def _standalone_checkpoints(work: str):
    """For ``--phases 18`` alone: random-weight stand-ins (seed 0) of phase
    9's flagship rems checkpoint and phase 11's WACNN one."""
    from epic_tpu_torch import get_model
    from epic_tpu_torch.tools.workload import FLAGSHIP
    from epic_tpu_torch.training.checkpoint import save_checkpoint

    out = []
    for name, cfg in (("rem", FLAGSHIP), ("cnn", WACNN)):
        path = os.path.join(work, "standalone", name)
        save_checkpoint(path, get_model(name, **cfg).init_weights(0),
                        {k: list(v) if isinstance(v, tuple) else v
                         for k, v in dict(cfg, model=name).items()})
        out.append(path)
    return out


def _median_ms(fn, reps: int = 20) -> float:
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return 1e3 * float(np.median(times))


def _loader_seconds(root: str) -> tuple:
    """``ImageFolder`` (patch 256) + ``data_loader`` (batch 16, 8 threads)
    over ``root``/train: (first batch s, median s of the next ones)."""
    from epic_tpu_torch.data.datasets import ImageFolder, data_loader

    it = data_loader(ImageFolder(root, "train", TRAIN_PATCH), LOADER_BATCH,
                     seed=0, steps=LOADER_STEPS)
    walls = []
    while True:
        t = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            break
        walls.append(time.perf_counter() - t)
        if batch.shape != (LOADER_BATCH, TRAIN_PATCH, TRAIN_PATCH, 3) or \
                batch.dtype != np.float32:
            raise AssertionError(f"loader batch {batch.shape} {batch.dtype}")
    return walls[0], float(np.median(walls[1:]))


def phase_images_and_tools(smi: str, work: str, rems_ckpt: str,
                           cnn_ckpt: str) -> dict:
    """Phase 18: (a) the image readers: every committed fixture decoded to
    the SHA-256 that Pillow's decode gave (tests/fixtures/images/
    checksums.json), ``read_jpeg`` timed on the 768x512 baseline and
    progressive files (median of 20), and the host loader's seconds per
    batch of 16 on a folder of copies of them, beside the same pixels as
    PNG files; (b) ``tools.eval_checkpoint`` on ``rems_ckpt`` (bf16,
    ``--images`` a folder holding the 768x512 baseline JPEG: 6 tiles of
    256x256) and ``tools.eval_cnn`` on ``cnn_ckpt``, launches counted per
    call: real bpp equal to the captured streams' bytes at every level, 16
    rows, the REM group present; (c) ``tools.extend_rem_banks`` from the
    checkpoint's check levels to those plus EXTEND_LEVEL, the result
    loaded: kept banks and every other array bitwise the source's, one
    ``compress`` / ``decompress`` at q = 2 with the three chained
    checkpoint latents, bitwise; (d) ``tools.bench_rans`` at 4,000,000
    symbols. Returns the launches by path."""
    import shutil

    import epic_tpu_torch as et
    import epic_tpu_torch.codec as et_codec
    from epic_tpu_torch.data.images import read_image
    from epic_tpu_torch.data.jpeg import read_jpeg
    from epic_tpu_torch.data.png import write_png
    from epic_tpu_torch.native.build import build_jpeg_library
    from epic_tpu_torch.tools import (bench_rans, eval_checkpoint, eval_cnn,
                                      extend_rem_banks)
    from epic_tpu_torch.tools.workload import images

    tag = "18 images+tools"
    t_phase = time.perf_counter()
    t = time.perf_counter()
    build_jpeg_library()
    log(f"[{tag}] epic_jpeg.cpp (g++) {time.perf_counter() - t:.1f} s")

    # (a) decoding
    fdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        IMAGE_FIXTURES)
    with open(os.path.join(fdir, "checksums.json")) as f:
        sums = json.load(f)
    for name, digest in sums.items():
        got = hashlib.sha256(np.ascontiguousarray(read_image(
            os.path.join(fdir, name))).tobytes()).hexdigest()
        if got != digest:
            raise AssertionError(f"{name}: decoded SHA-256 {got} differs "
                                 f"from Pillow's {digest}")
    log(f"[{tag}] {len(sums)} fixtures (JPEG, PNG, BMP, PPM) decoded to "
        "Pillow's SHA-256: " + ", ".join(sorted(sums)))
    decoded = {}
    for name in TIMED_JPEGS:
        path = os.path.join(fdir, name)
        ms = _median_ms(lambda: read_jpeg(path))
        decoded[name] = read_jpeg(path)
        h, w = decoded[name].shape[:2]
        log(f"[{tag}] read_jpeg {name} ({w}x{h}): {ms:.2f} ms median of 20 "
            f"({h * w / ms / 1e3:.1f} Mpixel/s, one host thread)")
    roots = {"jpeg": os.path.join(work, "loader_jpeg"),
             "png": os.path.join(work, "loader_png")}
    for r in roots.values():
        os.makedirs(os.path.join(r, "train"))
    for i in range(LOADER_COPIES):
        for name in TIMED_JPEGS:
            stem = f"{i:02d}_{os.path.splitext(name)[0]}"
            shutil.copyfile(os.path.join(fdir, name), os.path.join(
                roots["jpeg"], "train", stem + ".jpg"))
            write_png(os.path.join(roots["png"], "train", stem + ".png"),
                      decoded[name])
    for kind, r in roots.items():
        first, per = _loader_seconds(r)
        log(f"[{tag}] loader on {2 * LOADER_COPIES} 768x512 {kind.upper()} "
            f"files: first batch of {LOADER_BATCH} {first:.3f} s, then "
            f"{per:.4f} s per batch (median of {LOADER_STEPS - 1}, 8 "
            "threads)")

    # (b) the evaluation tools
    crops = os.path.join(work, "eval_crops")
    os.makedirs(crops)
    shutil.copyfile(os.path.join(fdir, TIMED_JPEGS[0]),
                    os.path.join(crops, TIMED_JPEGS[0]))
    captured, encode = [], et_codec.progressive_encode

    def capture(*a, **kw):
        out = encode(*a, **kw)
        captured.append(out[0])
        return out

    quiet = io.StringIO()
    et_codec.progressive_encode = capture
    try:
        t = time.perf_counter()
        with contextlib.redirect_stdout(quiet):
            res, n_eval = _counted(lambda: eval_checkpoint.main(
                [rems_ckpt, "--images", crops, "--out",
                 os.path.join(work, "eval.json")]))
        eval_s = time.perf_counter() - t
    finally:
        et_codec.progressive_encode = encode
    _expect(tag, "eval_checkpoint", n_eval, EVAL_CKPT_LAUNCHES)
    groups = res["groups"]
    if set(groups) != {"val", "val_rem"} or len(captured) != 2:
        raise AssertionError(f"eval_checkpoint groups {sorted(groups)}, "
                             f"{len(captured)} encodes")
    npix = groups["val"]["n_crops"] * 256 * 256
    for name, bs in zip(("val", "val_rem"), captured):
        g = groups[name]
        z_bits = 8.0 * sum(len(s) for s in bs["z"])
        want = [round((z_bits + 8.0 * float(bs["prefix"][:, k].sum()))
                      / npix, 4) for k in range(bs["prefix"].shape[1])]
        if (g["real_bpp"] != want or len(g["real_bpp"]) != 16
                or len(g["psnr"]) != 16 or len(g["msssim_db"]) != 16
                or int(bs["prefix"][:, -1].sum())
                != sum(len(s) for s in bs["y"])):
            raise AssertionError(f"eval_checkpoint {name}: real bpp "
                                 f"{g['real_bpp']} != the streams' {want}")
        if not all(map(math.isfinite, g["psnr"] + g["est_bpp"])):
            raise AssertionError(f"eval_checkpoint {name}: not finite")
    g = groups["val"]
    log(f"[{tag}] eval_checkpoint (rems checkpoint, bf16, "
        f"{g['n_crops']} crops of 256x256 from the 768x512 JPEG): "
        f"{eval_s:.1f} s; real bpp of the 16 levels equal to the streams' "
        f"bytes in both groups; top level {g['real_bpp'][-1]} bpp (REM "
        f"{groups['val_rem']['real_bpp'][-1]}), est {g['est_bpp'][-1]}, "
        f"PSNR {g['psnr'][-1]} dB, shells "
        f"{[r['elems'] for r in g['shells']['per_shell']]}, REM rows "
        f"{[(r['q'], r['rate_saving_pct']) for r in g['rem_per_quality']]}")
    t = time.perf_counter()
    with contextlib.redirect_stdout(quiet):
        res, n_cnn = _counted(lambda: eval_cnn.main(
            [cnn_ckpt, "--images", crops, "--regions", "val"]))
    cnn_s = time.perf_counter() - t
    _expect(tag, "eval_cnn", n_cnn, EVAL_CNN_LAUNCHES)
    g = res["groups"]["val"]
    if g["streams_per_image"] != 1 or not math.isfinite(g["psnr"]):
        raise AssertionError(f"eval_cnn: {g}")
    log(f"[{tag}] eval_cnn (WACNN checkpoint, bf16): {cnn_s:.1f} s; "
        f"{g['bpp']} bpp (est {g['est_bpp']}), PSNR {g['psnr']} dB, "
        f"MS-SSIM {g['msssim_db']} dB, 1 stream per image")

    # (c) extend the REM banks
    src, src_cfg, _ = et.load_checkpoint(rems_ckpt)
    old = [float(c) for c in src_cfg["check_levels"]]
    dst = os.path.join(work, "extended", "rems")
    t = time.perf_counter()
    with contextlib.redirect_stdout(quiet):
        extend_rem_banks.main([rems_ckpt, dst, "--check_levels",
                               *map(str, old + [EXTEND_LEVEL])])
    ext_s = time.perf_counter() - t
    model, cfg, step = et.load_checkpoint(dst)
    with open(os.path.join(work, "extended", "progress.json")) as f:
        prog = json.load(f)
    if cfg["check_levels"] != old + [EXTEND_LEVEL] or step != 0 or \
            prog["stage"] != "rems" or prog["next_step"] != 1:
        raise AssertionError(f"extended checkpoint: {cfg['check_levels']}, "
                             f"step {step}, {prog}")
    a, b = src.state_dict(), model.state_dict()
    fresh = f"post_latent_{len(old)}."
    kept = [k for k in b if not k.startswith(fresh)]
    if set(kept) != set(a) or not all(torch.equal(a[k], b[k])
                                      for k in kept):
        raise AssertionError("the extended checkpoint's kept arrays differ "
                             "from the source's")
    del src, a, b
    codec = et.PICCodec(model, device="cuda")
    x, _ = images()

    def code():
        ck = None
        for cl in model.check_levels:
            ck = codec.extract_checkpoint(x, cl, checkpoint_rep=ck)
        out = codec.compress(x, 2.0, return_latents=True,
                             checkpoint_rep=ck)
        return out, codec.decompress(out, checkpoint_rep=ck)

    (out, dec), n_ext = _counted(code)
    _expect(tag, "extended model: 3 extractions, compress, decompress",
            n_ext, {"gdn": 6 * 4, "igdn": 3})
    if not torch.equal(dec["y_hat"], out["y_hat"]):
        raise AssertionError("extended model: decoder y_hat differs")
    y_strings, z_strings = out["strings"]
    nbytes = sum(len(s) for sl in y_strings for s in sl) + sum(
        len(s) for s in z_strings)
    log(f"[{tag}] extend_rem_banks {old} -> {cfg['check_levels']} "
        f"{ext_s:.1f} s: {len(kept)} arrays bitwise the source's, bank "
        f"{len(old)} fresh; compress / decompress at q=2 with the three "
        f"checkpoint latents bitwise, {nbytes * 8 / (x.shape[1] * x.shape[2]):.4f} bpp")
    del codec, model
    torch.cuda.empty_cache()

    # (d) the rANS microbenchmark
    r = bench_rans.run(4_000_000)
    log(f"[{tag}] bench_rans: n={r['n']} enc {r['enc_msym_s']:.2f} Msym/s, "
        f"dec {r['dec_msym_s']:.2f} Msym/s ({r['bits_per_sym']:.3f} "
        f"bits/sym, 16 messages on {r['threads']} host threads)")
    secs = time.perf_counter() - t_phase
    log(f"[{tag}] phase 18 {secs:.1f} s [{smi}]")
    if secs > PHASE18_LIMIT_S:
        raise AssertionError(f"phase 18 took {secs:.1f} s (limit "
                             f"{PHASE18_LIMIT_S} s)")
    return {"eval_checkpoint": n_eval, "eval_cnn": n_cnn,
            "extended_rem_codec": n_ext}


# phase 19: the committed Orbax checkpoint (tests/gen_torch_orbax_fixture.py)
ORBAX_FIXTURE = os.path.join("tests", "fixtures", "orbax", "flagship_tiled")
ORBAX_DIGESTS = ORBAX_FIXTURE + ".json"
PHASE19_LIMIT_S = 150
NORMALS_REPEATS = 5


def phase_orbax_checkpoint(smi: str, work: str) -> dict:
    import epic_tpu_torch as et
    from epic_tpu_torch.convert import _flatten
    from epic_tpu_torch.native import zstd
    from epic_tpu_torch.tools import make_artifact
    from epic_tpu_torch.tools.workload import images
    from epic_tpu_torch.training.ocdbt import read_ocdbt
    from epic_tpu_torch.training.orbax import read_orbax

    tag = "19 orbax"
    t_phase = time.perf_counter()
    last = os.path.join(ORBAX_FIXTURE, "last")
    with open(ORBAX_DIGESTS) as f:
        want = json.load(f)
    # (a) the zstd decoder alone, one thread, on the store's chunks
    kv = read_ocdbt(last)
    frames = [v for k, v in kv.items() if not k.endswith("/.zarray")]
    zstd.decompress(frames[0])  # builds the library
    t = time.perf_counter()
    out_bytes = sum(len(zstd.decompress(v)) for v in frames)
    z_s = time.perf_counter() - t
    in_bytes = sum(len(v) for v in frames)
    nrec = want["zstd_normals"]
    with open(nrec["file"], "rb") as f:
        normals = f.read()
    n_walls = []
    for _ in range(NORMALS_REPEATS):
        t = time.perf_counter()
        raw = zstd.decompress(normals)
        n_walls.append(time.perf_counter() - t)
    if hashlib.sha256(raw).hexdigest() != nrec["sha256"]:
        raise AssertionError(f"{nrec['file']}: not the seeded normals")
    n_s = float(np.median(n_walls))
    del raw
    # (b) the read and every array's SHA-256 against the JAX package's
    t = time.perf_counter()
    tree = read_orbax(last)
    read_s = time.perf_counter() - t
    flat = {"/".join(p): np.asarray(a) for p, a in _flatten(tree)}
    if len(flat) != want["n_arrays"] or set(flat) != set(want["arrays"]):
        raise AssertionError(f"{len(flat)} arrays read, the fixture has "
                             f"{want['n_arrays']}")
    for k, a in flat.items():
        w = want["arrays"][k]
        if (list(a.shape) != w["shape"] or str(a.dtype) != w["dtype"]
                or hashlib.sha256(a.tobytes()).hexdigest() != w["sha256"]):
            raise AssertionError(f"{k}: not the JAX package's array")
    nbytes = sum(a.nbytes for a in flat.values())
    del flat, tree, kv, frames
    t = time.perf_counter()
    model, cfg, step = et.load_checkpoint(ORBAX_FIXTURE)
    load_s = time.perf_counter() - t
    log(f"[{tag}] zstd, one thread: {out_bytes} B from "
        f"{in_bytes} B in {z_s:.3f} s, {out_bytes / z_s / 1e6:.1f} MB/s "
        f"(tiled weights); {nrec['bytes']} B from {len(normals)} B in "
        f"{n_s:.4f} s, {nrec['bytes'] / n_s / 1e6:.1f} MB/s (seeded float32 "
        f"normals, median of {NORMALS_REPEATS}, SHA-256 checked); read_orbax "
        f"{read_s:.3f} s for {want['n_arrays']} arrays, {nbytes} B, every "
        f"SHA-256 the JAX package's; load_checkpoint {load_s:.3f} s "
        f"({cfg['model']}, step {step}) [{smi}]")
    if cfg["model"] != "rem":
        raise AssertionError(f"loaded a {cfg['model']} model")
    # (c) phase 5's serial sweep with the loaded weights
    codec = et.PICCodec(model, device="cuda")
    x, warm = images()
    _warm_up(codec, warm, True)
    bs, state, outs, launches = _encode_and_decode_levels(tag, codec, x,
                                                          True)
    t = time.perf_counter()
    out, n = _counted(lambda: et.progressive_decode_all(
        codec, bs, True, state["auto_ckpts"]))
    log(f"[{tag}] decode_all {time.perf_counter() - t:.3f} s")
    _expect(tag, "decode_all", n, {"gdn": 0, "igdn": 9})
    launches["decode_all"] = n
    _check_levels(tag, codec, x, bs, state, outs)
    diff = max(float((out["x_hat"][lvl] - outs[lvl][0]).abs().max())
               for lvl in range(len(outs)))
    if not diff <= DECODE_ALL_ATOL:
        raise AssertionError(f"decode_all differs by {diff}")
    log(f"[{tag}] every level bitwise the encoder's; decode_all within "
        f"{diff:.3e}")
    del codec, out, outs, state, bs
    torch.cuda.empty_cache()
    # (d) the bf16 artifact of the JAX trainer's checkpoint
    art = os.path.join(work, "orbax_artifact")
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rec = make_artifact.main([ORBAX_FIXTURE, art])
    art_s = time.perf_counter() - t
    art_model, art_cfg, art_step = et.load_checkpoint(art)
    if art_cfg["model"] != "rem" or art_step != step:
        raise AssertionError(f"artifact {art_cfg['model']} step {art_step}")
    dead, live = _check_artifact(model, art_model)
    secs = time.perf_counter() - t_phase
    log(f"[{tag}] make_artifact {art_s:.1f} s: {rec['out']} "
        f"{os.path.getsize(rec['out'])} B, every array the bf16 cast of the "
        f"fixture's, {dead} dead-row entries zero ({live} nonzero in the "
        f"fixture); phase {secs:.1f} s [{smi}]")
    if secs > PHASE19_LIMIT_S:
        raise AssertionError(f"phase 19 took {secs:.1f} s (limit "
                             f"{PHASE19_LIMIT_S} s)")
    return {f"orbax_{k}": v for k, v in launches.items()}


def _timed_steps(step, state, x):
    losses, walls = [], []
    for _ in range(PAR_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(step(state, x)["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return losses, walls


def main(argv=None) -> int:
    """All phases (no arguments: what the chip check runs). ``--phases
    16,17`` runs the environment, the build and the listed phases only
    ("17a": phase 17's train step without the sweep), and prints no
    kernels record (for working on those phases);
    ``--parallel-rank R WORLD PORT OUT`` is one rank of phase 17."""
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if argv[:1] == ["--parallel-rank"]:
        rank, world, port, out = argv[1:5]
        parallel_rank(int(rank), int(world), int(port), out)
        return 0
    only = None
    if argv[:1] == ["--phases"]:
        only = set(argv[1].split(","))
    t_start = time.perf_counter()
    smi = phase_environment()
    if only is not None:
        phase_build()
        if "3" in only:
            phase_kernels(smi)
        if "3b" in only:
            phase_backward_kernel(smi)
        with tempfile.TemporaryDirectory() as work:
            if "16" in only:
                phase_options(smi, work)
            if only & {"17", "17a"}:
                phase_parallel(smi, work, sweep_too="17" in only)
            if "18" in only:
                phase_images_and_tools(smi, work,
                                       *_standalone_checkpoints(work))
            if "19" in only:
                phase_orbax_checkpoint(smi, work)
        log(f"[done] phases {sorted(only)} in "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0
    phase_z_tables()
    phase_build()
    per_shape = phase_kernels(smi)
    bwd_shapes = phase_backward_kernel(smi)
    phase_pic_path()
    launches = phase_main_path()
    phase_reference()
    launches["pipelined"] = phase_pipeline(smi)
    launches["random_access"] = phase_random_access()
    with tempfile.TemporaryDirectory() as work:
        train_fwd, train_bwd = phase_training(smi, work)
        launches["training"] = train_fwd
        launches.update(phase_wacnn_codec())
        cnn_fwd, cnn_bwd, cnn_ckpt = phase_wacnn_training(smi, work)
        launches["wacnn_training"] = cnn_fwd
        launches.update(phase_file_cli(
            work, os.path.join(work, "train", "rems"), cnn_ckpt))
        # phase 18 runs the repository tools on phases 9 and 11's
        # checkpoints, which live in this directory
        launches.update(phase_images_and_tools(
            smi, work, os.path.join(work, "train", "rems"), cnn_ckpt))
    launches.update(phase_rd_eval())
    with tempfile.TemporaryDirectory() as work:
        launches.update(phase_orbax_checkpoint(smi, work))
    c2_fwd, c2_bwd = phase_first_train_vs_jax()
    launches["first_train_vs_jax"] = c2_fwd
    with tempfile.TemporaryDirectory() as work:
        host_fwd, host_bwd = phase_host_trainer(smi, work)
        # phase 16 trains on phase 15's PNG files
        opt_fwd, opt_bwd = phase_options(smi, work)
        par_fwd, par_bwd = phase_parallel(smi, work)
    launches["host_trainer"] = host_fwd
    launches["options"] = opt_fwd
    launches.update(par_fwd)
    backward = {"training": train_bwd, "wacnn_training": cnn_bwd,
                "first_train_vs_jax": c2_bwd, "host_trainer": host_bwd,
                "options": opt_bwd, **par_bwd}
    kernels = []
    for name in ("gdn", "igdn"):
        top = per_shape[name][0]  # the largest call of the main path
        kernels.append({
            "name": name, "route": "cuda",
            "source": "epic_tpu_torch/csrc/gdn.cu",
            "replaces": "epic_tpu/ops/pallas_gdn.py:37",
            "launches": sum(n[name] for n in launches.values()),
            "max_abs_err": max(r["max_abs_err"] for r in per_shape[name]),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None, "rows": top["rows"],
            "launches_by_path": {k: n[name] for k, n in launches.items()},
            "cuda_core_bound_ms": top["cuda_core_bound_ms"],
            "product_ms": top["product_ms"],
            # the same kernel with bf16 in and out, and the bf16 GDN module
            # call beside the cast, float32 call, cast it replaces
            "bf16_ms": top["bf16_ms"], "bf16_bound_ms": top["bf16_bound_ms"],
            "module_bf16_ms": top["module_bf16_ms"],
            "module_cast_ms": top["module_cast_ms"]})
    for name in ("gdn", "igdn"):
        top = bwd_shapes[name][0]  # a first_train step's largest call
        kernels.append({
            "name": f"{name}_backward", "route": "cuda",
            "source": "epic_tpu_torch/csrc/gdn_bwd.cu",
            "replaces": "epic_tpu/ops/pallas_gdn.py:80",
            "launches": sum(n[name] for n in backward.values()),
            "max_abs_err": max(r["max_abs_err"] for r in bwd_shapes[name]),
            # the whole gdn_backward (the kernel and its reduction) and its
            # plain version
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None, "rows": top["rows"],
            "launches_by_path": {k: n[name] for k, n in backward.items()},
            "max_rel_err_dx": max(r["dx"] for r in bwd_shapes[name]),
            "bf16_ms": top["bf16_ms"], "bf16_bound_ms": top["bf16_bound_ms"],
            "rows_ms": top["rows_ms"],
            "two_product_bound_ms": top["two_product_bound_ms"],
            "mma_floor_ms": top["mma_floor_ms"]})
        # the second kernel of a backward call: the partials' fixed-order
        # sum (launched once per backward kernel launch, asserted on every
        # counted path)
        kernels.append({
            "name": f"{name}_backward_reduce", "route": "cuda",
            "source": "epic_tpu_torch/csrc/gdn_bwd.cu",
            "replaces": "epic_tpu/ops/pallas_gdn.py:80",
            "launches": sum(n[name] for n in backward.values()),
            "max_abs_err": max(r["reduce_max_abs_err"]
                               for r in bwd_shapes[name]),
            "ms": top["reduce_ms"], "plain_ms": top["reduce_plain_ms"],
            "bound_ms": top["reduce_bound_ms"], "bound_by": "bytes",
            # torch.sum over the partials (unscaled)
            "library_ms": top["reduce_library_ms"],
            "parts": top["reduce_parts"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
