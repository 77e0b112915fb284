"""Smoke run of epic_tpu_torch on one NVIDIA GPU: builds the kernels from the
repository's sources, holds every kernel against its plain PyTorch version,
then drives the main path once at full width and checks what comes out.

    python3 chip_smoke.py

Phases, one progress line each (flush=True):
 1. environment: torch / CUDA versions, the card's name and power limit,
    nvcc's version;
 2. build: the GDN kernel (nvcc, sm_90a) and the host rANS library (g++),
    started together;
 3. kernels: fused GDN and inverse GDN against ``gdn_plain``, max relative
    error <= 1e-5: at the main path's row counts (98,304 / 24,576 / 6,144
    for a 768x512 image, and a ragged 21), C = 192, with CUDA-event times of
    the kernel, of ``gdn_plain`` and of the product alone
    (``torch.matmul(x*x, gamma)``, cuBLAS SGEMM) beside the tensor-core and
    CUDA-core bounds; at ragged R 1 / 31 / 33 / 98,309; at every C the
    kernel takes (R = 333); and 21 rows alone against the same rows at
    offsets 0, 5 and 37 inside 98,304, bitwise;
 4. main path: the full-width ``pic`` model (N=192, M=640, division
    (320, 640), dim_chunk 32, bf16 compute, random weights from a seed) on a
    seeded synthetic 768x512 image (``epic_tpu_torch/tools/workload.py``):
    ``progressive_encode`` with the 15-shell ``DEFAULT_Q_LIST``, then
    ``progressive_decode`` of levels 0..15. Every level's y_hat and x_hat
    must equal the encoder's own reconstruction bitwise, the decoded symbols
    the encoder's, bpp must not decrease with the level and PSNR must be
    finite. The kernel launch counts of this run must match the count per
    image;
 5. reference: a small float32 model on the GPU against the same code on
    the CPU (the plain GDN), entropy parameters within 1e-3.

Any failure raises and exits non-zero. The line before the last is the
kernels' JSON record; the last line is the device record. Needs one CUDA
device and no network; writes only into the package's build directories.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# Published dense peaks (NVIDIA data sheets), by SKU: float32 on CUDA cores
# and TF32 on tensor cores in TFLOP/s, memory in TB/s.
_PEAKS = {"SXM": (67.0, 495.0, 3.35), "PCIe": (51.0, 378.0, 2.0),
          "NVL": (60.0, 417.5, 3.9)}
GDN_ROWS = (98_304, 24_576, 6_144, 21)
GDN_RAGGED_ROWS = (1, 31, 33, 98_309)
GDN_C = 192
REL_TOL = 1e-5


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
                ("epic_rans.cpp (g++)", rans_build.build_library))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    log("[2 build] " + ", ".join(f"{k} {v:.1f} s" for k, v in results.items()))
    ptxas = os.path.join(os.path.dirname(gdn_kernel.SOURCE), "..", "_build",
                         "gdn_ptxas.txt")
    if os.path.exists(ptxas):
        for line in open(ptxas).read().splitlines():
            if "registers" in line or "spill" in line:
                log("[2 build] ptxas: " + line.strip())


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


def gdn_bounds_ms(rows: int, c: int, peak: tuple):
    """Least times for GDN over [rows, c] on this card, in ms: (tensor-core
    bound, what binds it, CUDA-core bound). The bytes are x, gamma, beta read
    once and y written once over the memory rate. The kernel's float32
    accuracy on tensor cores takes three TF32 products (3 * 2RC^2 operations
    at the TF32 peak); the CUDA-core bound, the design of the earlier kernel,
    counts 2RC^2 + 4RC float32 operations at the float32 peak."""
    f32, tf32, bw = peak
    t_bytes = 4.0 * (2 * rows * c + c * c + c) / (bw * 1e12)
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


def phase_kernels(smi: str):
    """GDN / IGDN against gdn_plain (max relative error <= 1e-5): at the main
    path's row counts (timed: kernel, plain, the product alone), at ragged
    row counts, at every width the kernel takes; and rows whose bits do not
    depend on where they sit in the launch."""
    from epic_tpu_torch.ops.gdn_kernel import MAX_CHANNELS, gdn, gdn_plain

    dev = torch.device("cuda")
    peak = peaks(smi)
    rng = np.random.default_rng(0)
    c = GDN_C
    _, gamma, beta = _gdn_data(1, c, rng, dev)
    rows_out = {}
    for inverse, name in ((False, "gdn"), (True, "igdn")):
        per_shape = []
        for rows in GDN_ROWS:
            x = torch.as_tensor(rng.normal(0, 1, (rows, c)).astype(np.float32),
                                device=dev)
            abs_err, rel = _check_gdn(f"{name} R={rows}", x, gamma, beta,
                                      inverse)
            ms = time_cuda(lambda: gdn(x, gamma, beta, inverse))
            plain_ms = time_cuda(lambda: gdn_plain(x, gamma, beta, inverse))
            product_ms = time_cuda(lambda: torch.matmul(x * x, gamma))
            bound, by, cc_bound = gdn_bounds_ms(rows, c, peak)
            per_shape.append(dict(rows=rows, max_abs_err=abs_err,
                                  max_rel_err=rel, ms=ms, plain_ms=plain_ms,
                                  product_ms=product_ms, bound_ms=bound,
                                  bound_by=by, cuda_core_bound_ms=cc_bound))
            log(f"[3 kernels] {name} R={rows} C={c}: max rel err {rel:.2e}, "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, product alone "
                f"{product_ms:.4f} ms, bound {bound:.4f} ms ({by}), CUDA-core "
                f"bound {cc_bound:.4f} ms [{smi}]")
        worst = 0.0
        for rows in GDN_RAGGED_ROWS:
            x, g, b = _gdn_data(rows, c, rng, dev)
            worst = max(worst, _check_gdn(f"{name} R={rows}", x, g, b,
                                          inverse)[1])
        for width in range(1, MAX_CHANNELS + 1):
            x, g, b = _gdn_data(333, width, rng, dev)
            worst = max(worst, _check_gdn(f"{name} C={width}", x, g, b,
                                          inverse)[1])
        x, g, b = _gdn_data(98_304, c, rng, dev)
        alone = gdn(x[:21].clone(), g, b, inverse)
        for off in (0, 5, 37):
            big = x.clone()
            big[off:off + 21] = x[:21]
            if not torch.equal(gdn(big, g, b, inverse)[off:off + 21], alone):
                raise AssertionError(f"{name}: rows at offset {off} of "
                                     "98,304 differ from the same rows alone")
        log(f"[3 kernels] {name} ragged R {GDN_RAGGED_ROWS} and C = 1.."
            f"{MAX_CHANNELS} at R=333: max rel err {worst:.2e}; 21 rows "
            "alone and at offsets 0/5/37 of 98,304 bitwise equal")
        rows_out[name] = per_shape
    return rows_out


def phase_main_path():
    import epic_tpu_torch as et
    from epic_tpu_torch.codec.progressive import decoded_symbols
    from epic_tpu_torch.ops.gdn_kernel import gdn
    from epic_tpu_torch.tools.workload import (H, W, decode_levels,
                                               full_width_codec, images)
    from epic_tpu_torch.utils.metrics import compute_psnr

    t0 = time.perf_counter()
    codec = full_width_codec(0)  # cuda
    model = codec.model
    x, warm = images()
    log(f"[4 main] model + codec set up in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params)")

    # warm-up on another image (cuDNN / cuBLAS handles, allocator)
    for _ in decode_levels(codec, et.progressive_encode(codec, warm)[0]):
        pass
    torch.cuda.synchronize()

    nq = len(et.DEFAULT_Q_LIST)
    gdn.launches.update(gdn=0, igdn=0)
    enc_t, state = {}, {}
    t = time.perf_counter()
    bs, bits = et.progressive_encode(codec, x, timing=enc_t, state=state)
    enc_s = time.perf_counter() - t
    dec_t, outs, level_s = {}, [], []
    t = time.perf_counter()
    for lvl, out in decode_levels(codec, bs, dec_t):
        level_s.append(time.perf_counter() - t)
        outs.append((out["x_hat"].clone(), out["y_hat"].clone(),
                     decoded_symbols(out["cache"]) if lvl else None))
        t = time.perf_counter()
    launches = dict(gdn.launches)

    # g_a x2 (3 GDN each); g_s once per decoded level (3 IGDN each)
    expect = {"gdn": 6, "igdn": 3 * (nq + 1)}
    log(f"[4 main] encode {enc_s:.3f} s (device {enc_t['device_s']:.3f}, "
        f"host rANS {enc_t['rans_s']:.3f}); decode levels 0..{nq} "
        f"{sum(level_s):.3f} s (device {dec_t['device_s']:.3f}, host rANS "
        f"{dec_t['rans_s']:.3f})")
    log("[4 main] per-level decode s: "
        + " ".join(f"{s:.4f}" for s in level_s)
        + f" (median {np.median(level_s):.4f}, worst {max(level_s):.4f})")
    log(f"[4 main] kernel launches {launches} (expected per image {expect})")
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != {expect}")

    # the encoder's own reconstruction of every level, bitwise
    xt = torch.as_tensor(x, device=codec.device)
    prefix = bs["prefix"]
    base_bytes = sum(len(s) for s in bs["z"])
    p_flat = state["psym"].transpose(0, 1).reshape(1, -1).cpu().numpy()
    sid_flat = state["sid"].transpose(0, 1).reshape(1, -1).cpu().numpy()
    last_bpp = -1.0
    for lvl, (x_hat, y_hat, canvas) in enumerate(outs):
        if lvl == 0:
            x_e, y_e = codec.synth_base(state["base_slices"])
        else:
            keep = state["sid"].to(torch.int32) < lvl
            x_e, y_e = codec.prog_reconstruct(state["psym"] * keep,
                                              state["mu_s"], state["msups"],
                                              state["base_slices"])
            want_sym = np.where(sid_flat < lvl, p_flat, 0)
            if not np.array_equal(canvas, want_sym):
                raise AssertionError(f"level {lvl}: decoded symbols differ")
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
        log(f"[4 main] level {lvl:2d}: bpp {bpp:.4f} psnr {psnr:.3f} dB, "
            "symbols and y_hat equal the encoder's")
    return launches


def phase_reference():
    """A small float32 model on the GPU against the same code on the CPU."""
    import epic_tpu_torch as et

    cfg = dict(n=32, m=32, division=(16, 32), dim_chunk=8,
               param_net_widths=(24, 16))
    x = np.random.default_rng(1).random((1, 64, 64, 3), dtype=np.float32)
    states = []
    for device in ("cuda", "cpu"):
        codec = et.PICCodec(et.VarianceMaskingPIC(**cfg).init_weights(0), device=device)
        st = {}
        et.progressive_encode(codec, x, state=st)
        states.append({k: st[k].float().cpu() for k in ("mu_s", "scale_s")})
    for k in ("mu_s", "scale_s"):
        err = float((states[0][k] - states[1][k]).abs().max())
        log(f"[5 reference] tiny f32 model, GPU vs CPU {k}: max abs diff "
            f"{err:.2e} (tolerance 1e-3)")
        if not err <= 1e-3:
            raise AssertionError(f"{k} differs between GPU and CPU: {err}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t_start = time.perf_counter()
    smi = phase_environment()
    phase_build()
    per_shape = phase_kernels(smi)
    launches = phase_main_path()
    phase_reference()
    kernels = []
    for name in ("gdn", "igdn"):
        top = per_shape[name][0]  # the largest main-path call, R = 98,304
        kernels.append({
            "name": name, "route": "cuda",
            "source": "epic_tpu_torch/csrc/gdn.cu",
            "replaces": "epic_tpu/ops/pallas_gdn.py:37",
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in per_shape[name]),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": None,
            "cuda_core_bound_ms": top["cuda_core_bound_ms"],
            "product_ms": top["product_ms"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
