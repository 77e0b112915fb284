"""Where the GDN kernels' time goes, on the card.

Forward: builds ``csrc/gdn.cu`` with ``-DGDN_PHASES`` (clock64 timers in
block 0: the producer's waits for a free ring slot; the first consumer
warpgroup's k-loop, its waits for a full box, the MMA drain after the
loop and its epilogue) and two timing-only copies: ``-DGDN_MMA_ONLY`` (the
MMAs on operands made from the step index, no loads or splits) and
``-DGDN_NO_MMA`` (loads, splits and epilogue, no MMA); times every copy and
the library that ``ops/gdn_kernel.py`` builds with CUDA events at R =
98,304 / 393,216 / 5,898,240 (C = 192), float32 and bf16, beside the
bound, and prints block 0's clocks, the clusters of the grid and the
tensor-core instructions in each copy's machine code (``cuobjdump``).
``--fwd-source PATH`` adds another forward source with the same float32
entry point (the repository's earlier mma.sync kernel, say: put it, with
its ``gdn_common.cuh``, under the git-ignored ``runs/``), timed in the same
run and held to the library's output within 1e-5 relative.

Backward: builds ``csrc/gdn_bwd.cu`` with ``-DGDN_PHASES`` (clock64 timers
in block 0: the producer's waits for a free ring slot; the consumer
row warpgroup's product 1, its box waits, epilogue 1, its waits for the
peers to free their u quarters, its waits for the peers' u, product 2 and
epilogue 2; the dgamma warpgroup's product 3 and its waits for u) and the
two timing-only copies (``-DGDN_MMA_ONLY``,
``-DGDN_NO_MMA``); times the whole backward (the kernel and its reduction)
of every copy and of the library that ``ops/gdn_kernel.py`` builds, and
the kernel alone, at a first_train step's R = 262,144 / 65,536 / 16,384 (C
= 192), float32 and bf16, beside the bound, with the SM clock nvidia-smi
reads under load; prints block 0's clocks and whether each copy's output
equals the library's bitwise. ``--bwd-source PATH`` adds another backward
source: the repository's earlier mma.sync kernel (PR 12's, dx and u
alone, float32; ``git show c04272d:epic_tpu_torch/csrc/gdn_bwd.cu`` and its
``gdn_common.cuh`` under the git-ignored ``runs/``), timed in the same run
alone and with the ``torch.matmul`` / ``torch.sum`` reductions its wrapper
ran, and held to 1e-5 (dx) and 1e-4 (dgamma, dbeta) of
``gdn_backward_plain``.

    python3 -m epic_tpu_torch.tools.gdn_phases [--part forward|backward]
        [--fwd-source PATH ...] [--bwd-source PATH ...]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import numpy as np
import torch

from ..ops.gdn_kernel import (_FWD_ARGS, BACKWARD_SOURCE, SOURCE, _BUILD_DIR,
                               _nvcc, backward_clusters, gdn, gdn_backward,
                               gdn_backward_plain, gdn_plain)

_NVCC = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the forward copies: name -> nvcc flags (the repository's source)
_FWD_COPIES = {"phases": ["-DGDN_PHASES"],
               "mma_only": ["-DGDN_PHASES", "-DGDN_MMA_ONLY"],
               "no_mma": ["-DGDN_PHASES", "-DGDN_NO_MMA"]}
_FWD_PHASE_NAMES = ("producer slot waits", "consumer k-loop (its waits "
                    "excluded)", "consumer box waits", "MMA drain",
                    "epilogue")
FWD_ROWS = (98_304, 393_216, 5_898_240)
FWD_TOL = 1e-5
# PTX-level instructions of the tensor cores and their waits, as cuobjdump
# names them
_SASS = ("HGMMA", "HMMA", "WARPGROUP.DEPBAR", "WARPGROUP.ARRIVE", "UTMALDG",
         "SYNCS")


def _compile(jobs: dict, out: str) -> dict:
    """nvcc for each {name: (source, flags)}, all started together; prints
    ptxas's registers, spills and warnings; returns {name: library path}."""
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, (src, flags) in jobs.items():
        procs[name] = subprocess.Popen(
            [_nvcc(), *_NVCC, *flags, src, "-o",
             os.path.join(out, f"lib{name}.so")],
            stderr=subprocess.PIPE, text=True)
    paths = {}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        for line in err.splitlines():
            if any(k in line for k in ("registers", "spill", "arning")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
        paths[name] = os.path.join(out, f"lib{name}.so")
    return paths


def _sass_counts(path: str) -> str:
    """Counts of the tensor-core, TMA and barrier instructions in a
    library's machine code (cuobjdump beside nvcc), or why not."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        return "cuobjdump failed"
    text = proc.stdout
    return ", ".join(f"{k} {text.count(k)}" for k in _SASS)


def _ms(fn, n: int = 50) -> float:
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _fwd_bound_ms(rows: int, c: int, elem: int) -> float:
    """max(3 x 2RC^2 at 495 TFLOP/s, (2 elem RC + 4C^2 + 4C) B at 3.35
    TB/s), the published H100 SXM peaks."""
    ops = 3 * 2.0 * rows * c * c / 495e12
    io = (2.0 * elem * rows * c + 4 * c * c + 4 * c) / 3.35e12
    return 1e3 * max(ops, io)


def run_forward(extra_sources=()) -> None:
    out = os.path.join(_BUILD_DIR, "phases")
    jobs = {n: (SOURCE, f) for n, f in _FWD_COPIES.items()}
    for i, path in enumerate(extra_sources):
        jobs[f"fwd_extra{i}"] = (os.path.abspath(path), [])
    paths = _compile(jobs, out)
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        entries = {}
        for dtype, entry in ((torch.float32, "epic_gdn_forward"),
                             (torch.bfloat16, "epic_gdn_forward_bf16")):
            if hasattr(lib, entry):
                fn = getattr(lib, entry)
                fn.restype, fn.argtypes = ctypes.c_int, _FWD_ARGS
                entries[dtype] = fn
        libs[name] = (lib, entries)
        print(f"{name}: {_sass_counts(path)}", flush=True)
    for i, path in enumerate(extra_sources):
        print(f"fwd_extra{i}: {path}", flush=True)
    rng = np.random.default_rng(0)
    c = 192
    gamma = torch.as_tensor((0.1 * np.eye(c) + 0.01 * rng.random((c, c)))
                            .astype(np.float32), device="cuda")
    beta = torch.as_tensor((1.0 + 0.1 * rng.random(c)).astype(np.float32),
                           device="cuda")
    for rows in FWD_ROWS:
        x32 = torch.randn((rows, c), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(0))
        n = 10 if rows > 1_000_000 else 50
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            tag = "f32 " if dtype is torch.float32 else "bf16"
            bound = _fwd_bound_ms(rows, c, x.element_size())
            for inverse in (0, 1):
                kind = "igdn" if inverse else "gdn "
                want = gdn(x, gamma, beta, bool(inverse))
                plain = gdn_plain(x, gamma, beta, bool(inverse)).float()
                ms = _ms(lambda: gdn(x, gamma, beta, bool(inverse)), n)
                print(f"R={rows} {tag} {kind} library   {ms:.4f} ms "
                      f"(bound {bound:.4f})", flush=True)
                for name, (lib, entries) in libs.items():
                    fn = entries.get(dtype)
                    if fn is None:
                        continue
                    y = torch.empty_like(x)

                    def launch():
                        rc = fn(x.data_ptr(), gamma.data_ptr(),
                                beta.data_ptr(), y.data_ptr(), rows, c,
                                inverse,
                                torch.cuda.current_stream().cuda_stream)
                        if rc:
                            raise RuntimeError(f"{name}: CUDA error {rc}")

                    ms = _ms(launch, n)
                    launch()
                    torch.cuda.synchronize()
                    rel = float(((y.float() - plain).abs()
                                 / plain.abs().clamp_min(1e-30)).max())
                    line = (f"R={rows} {tag} {kind} {name:9s} {ms:.4f} ms, "
                            f"equal to the library's: "
                            f"{torch.equal(y, want)}, max rel err against "
                            f"gdn_plain {rel:.2e}")
                    if name.startswith("fwd_extra") and not rel <= FWD_TOL:
                        raise AssertionError(line)
                    if hasattr(lib, "epic_gdn_fwd_phases"):
                        clk = (ctypes.c_longlong * 5)()
                        lib.epic_gdn_fwd_phases(clk)
                        line += "; block 0 clocks: " + ", ".join(
                            f"{p} {v}" for p, v in zip(_FWD_PHASE_NAMES,
                                                       clk))
                    if hasattr(lib, "epic_gdn_forward_clusters"):
                        line += (f"; clusters "
                                 f"{lib.epic_gdn_forward_clusters(int(dtype is torch.bfloat16), inverse)}")
                    print(line, flush=True)
            del x
        del x32
        torch.cuda.empty_cache()


# the backward copies: name -> nvcc flags (the repository's source)
_BWD_COPIES = {"bwd": ["-DGDN_PHASES"],
               "bwd_mma_only": ["-DGDN_PHASES", "-DGDN_MMA_ONLY"],
               "bwd_no_mma": ["-DGDN_PHASES", "-DGDN_NO_MMA"]}
_BWD_PHASE_NAMES = ("producer slot waits", "product 1 (box waits "
                    "excluded)", "box waits", "epilogue 1",
                    "waits for the peers to free u", "product 3",
                    "waits for the peers' u", "product 2", "epilogue 2",
                    "total", "dgamma warpgroup's waits for u")
BWD_ROWS = (262_144, 65_536, 16_384)
_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def build_backward(extra_sources=()):
    """Compile the backward copies (one nvcc each, all started together);
    returns {name: ctypes library}. An extra source with the old entry
    point (dx and u alone, float32) is bound as such."""
    jobs = {n: (BACKWARD_SOURCE, f) for n, f in _BWD_COPIES.items()}
    for i, path in enumerate(extra_sources):
        jobs[f"extra{i}"] = (os.path.abspath(path), [])
    paths = _compile(jobs, os.path.join(_BUILD_DIR, "phases"))
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        lib.epic_gdn_backward.restype = ctypes.c_int
        if hasattr(lib, "epic_gdn_backward_reduce"):
            lib.epic_gdn_backward.argtypes = [
                _PTR] * 7 + [_I64, _I64, _INT, _INT, _INT,
                             ctypes.POINTER(ctypes.c_int), _PTR]
            lib.epic_gdn_backward_reduce.restype = ctypes.c_int
            lib.epic_gdn_backward_reduce.argtypes = [
                _PTR, _INT, _INT, _INT, _PTR, _PTR, _PTR]
        else:
            lib.epic_gdn_backward.argtypes = [_PTR] * 6 + [
                _I64, _INT, _INT, _PTR]
        libs[name] = lib
        print(f"{name}: {_sass_counts(path)}", flush=True)
    for i, path in enumerate(extra_sources):
        print(f"extra{i}: {path}", flush=True)
    return libs


def sm_clock_mhz_under_load(fn, launches: int = 1000) -> float:
    """The SM clock (MHz) that nvidia-smi reads while `launches` calls of
    fn are queued on the card (the clock drops when it idles)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(launches):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    torch.cuda.synchronize()
    return float(out.split()[0])


def _bwd_bound_ms(rows: int, c: int, elem: int) -> float:
    """max(9 x 2RC^2 at 495 TFLOP/s, (3 elem RC + 4C^2 + 4C) B at 3.35
    TB/s): the whole backward (three 3xTF32 products; x, g read, dx
    written), the published H100 SXM peaks."""
    ops = 9 * 2.0 * rows * c * c / 495e12
    io = (3.0 * elem * rows * c + 4 * c * c + 4 * c) / 3.35e12
    return 1e3 * max(ops, io)


def _launcher(name, lib, x, gamma, beta, g, inverse):
    """A function that runs one whole backward through `lib` (the kernel
    and its reduction; an old source: its kernel, then dgamma and dbeta
    reduced with torch.matmul and torch.sum as its wrapper did), and one
    that runs the kernel alone; both return (dx, dgamma, dbeta)."""
    rows, c = x.shape
    stream = torch.cuda.current_stream().cuda_stream
    dx = torch.empty_like(x)
    if hasattr(lib, "epic_gdn_backward_reduce"):
        cap = (torch.cuda.get_device_properties(0).multi_processor_count
               // 4) * 193 * 192
        part = torch.empty(cap, device="cuda")
        dgamma = torch.empty((c, c), device="cuda")
        dbeta = torch.empty((c,), device="cuda")
        parts = ctypes.c_int(0)

        def kernel():
            rc = lib.epic_gdn_backward(
                x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                g.data_ptr(), dx.data_ptr(), None, part.data_ptr(), cap,
                rows, c, inverse, int(x.dtype is torch.bfloat16),
                ctypes.byref(parts), stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        def whole():
            kernel()
            rc = lib.epic_gdn_backward_reduce(
                part.data_ptr(), parts.value, c, inverse, dgamma.data_ptr(),
                dbeta.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")
            return dx, dgamma, dbeta
    else:
        if x.dtype is not torch.float32:
            return None, None
        u = torch.empty_like(x)
        s = 0.5 if inverse else -0.5

        def kernel():
            rc = lib.epic_gdn_backward(
                x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                g.data_ptr(), dx.data_ptr(), u.data_ptr(), rows, c, inverse,
                stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        def whole():
            kernel()
            return dx, s * ((x * x).T @ u), s * u.sum(dim=0)
    return whole, kernel


def run_backward(extra_sources=()) -> None:
    libs = build_backward(extra_sources)
    rng = np.random.default_rng(0)
    c = 192
    gamma = torch.as_tensor((0.1 * np.eye(c) + 0.01 * rng.random((c, c)))
                            .astype(np.float32), device="cuda")
    beta = torch.as_tensor((1.0 + 0.1 * rng.random(c)).astype(np.float32),
                           device="cuda")
    for rows in BWD_ROWS:
        x32 = torch.as_tensor(rng.normal(0, 1, (rows, c)).astype(np.float32),
                              device="cuda")
        g32 = torch.as_tensor(rng.normal(0, 1, (rows, c)).astype(np.float32),
                              device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            x, g = x32.to(dtype), g32.to(dtype)
            tag = "f32 " if dtype is torch.float32 else "bf16"
            bound = _bwd_bound_ms(rows, c, x.element_size())
            for inverse in (0, 1):
                kind = "igdn" if inverse else "gdn "
                want = gdn_backward(x, gamma, beta, g, bool(inverse))
                plain = gdn_backward_plain(x.float(), gamma, beta, g.float(),
                                           bool(inverse))
                ms = _ms(lambda: gdn_backward(x, gamma, beta, g,
                                              bool(inverse)))
                print(f"R={rows} {tag} {kind} library      {ms:.4f} ms "
                      f"(bound {bound:.4f})", flush=True)
                if rows == BWD_ROWS[0] and dtype is torch.float32:
                    mhz = sm_clock_mhz_under_load(lambda: gdn_backward(
                        x, gamma, beta, g, bool(inverse)))
                    print(f"SM clock under load: {mhz:.0f} MHz, clusters "
                          f"{backward_clusters(dtype, bool(inverse))}",
                          flush=True)
                for name, lib in libs.items():
                    whole, kernel = _launcher(name, lib, x, gamma, beta, g,
                                              inverse)
                    if whole is None:
                        continue
                    ms = _ms(whole)
                    k_ms = _ms(kernel)
                    got = whole()
                    torch.cuda.synchronize()
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    errs = [float((a.float() - b).abs().max()
                                  / b.abs().max()) for a, b in zip(got,
                                                                   plain)]
                    line = (f"R={rows} {tag} {kind} {name:12s} whole "
                            f"{ms:.4f} ms, kernel {k_ms:.4f} ms, equal to "
                            f"the library's: {same}, rel err dx / dgamma / "
                            f"dbeta against gdn_backward_plain "
                            + " / ".join(f"{e:.1e}" for e in errs))
                    if name.startswith("extra") and not (
                            errs[0] <= 1e-5 and max(errs[1:]) <= 1e-4):
                        raise AssertionError(line)
                    if hasattr(lib, "epic_gdn_bwd_phases"):
                        clk = (ctypes.c_longlong * len(_BWD_PHASE_NAMES))()
                        lib.epic_gdn_bwd_phases(clk)
                        line += "; block 0 clocks: " + ", ".join(
                            f"{p} {v}" for p, v in zip(_BWD_PHASE_NAMES,
                                                       clk))
                    print(line, flush=True)
            del x, g
        del x32, g32
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--part", choices=("forward", "backward", "both"),
                    default="both")
    ap.add_argument("--bwd-source", action="append", default=[],
                    help="another backward source to time beside the "
                         "repository's")
    ap.add_argument("--fwd-source", action="append", default=[],
                    help="another forward source (float32 entry point "
                         "epic_gdn_forward) to time beside the repository's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gdn_phases: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.part != "forward":
        run_backward(args.bwd_source)
    if args.part != "backward":
        run_forward(args.fwd_source)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
