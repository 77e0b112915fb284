"""Where the GDN kernels' time goes, on the card.

Forward: builds copies of ``csrc/gdn.cu`` with clock64 timers around its
phases (gamma and first-tile load, tile waits, the MMA loop, the epilogue)
and, as variants, with one change each; times every copy with CUDA events
at R = 98,304 and 21 (C = 192) and prints block 0's phase clocks and
whether its output equals the unchanged kernel's bitwise.

Backward: builds ``csrc/gdn_bwd.cu`` with ``-DGDN_PHASES`` (its clock64
timers: gamma and the first tile, tile waits, product 1, epilogue 1,
product 2, epilogue 2, waits for the tensor-core turn) and with
``-DGDN_PHASES -DGDN_MMA_ONLY`` (the products' MMAs with no operand loads:
not the backward's output, the MMAs alone); times both, and the library
that ``ops/gdn_kernel.py`` builds, at a first_train step's R = 262,144 /
65,536 / 16,384 (C = 192), with the SM clock nvidia-smi reads under load;
prints block 0's clocks (thread 0, so its group's), and whether the timed
copy's dx and u equal the library's bitwise. ``--bwd-source PATH`` adds
another backward source (an earlier version, say), timed in the same run.

    python3 -m epic_tpu_torch.tools.gdn_phases [--part forward|backward]
        [--bwd-source PATH ...]

Forward variants: ``split4`` hands the MMA the unmasked hi operand (the MMA
reads only its TF32 bits), one integer operation less per split;
``16_warps`` runs 16 warps of 3 n-fragments instead of 8 of 6;
``mma_only`` keeps the k-loop's MMAs and drops its loads and splits (its
output is not GDN's: it times the MMAs alone).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import numpy as np
import torch

from ..ops.gdn_kernel import (BACKWARD_SOURCE, HEADER, SOURCE, _BUILD_DIR,
                               _nvcc, gdn_backward_rows)

_TIMERS = [
    ("#include <cstdint>\n",
     "#include <cstdint>\n__device__ long long g_phase[5];\n"),
    ("    extern __shared__ __align__(16) float smem[];\n",
     "    extern __shared__ __align__(16) float smem[];\n"
     "    const long long t_start = clock64();\n"
     "    long long t_fill = 0, t_wait = 0, t_mma = 0, t_epi = 0;\n"
     "    long long t_mark;\n"),
    ("        cp_async_wait_one();\n        __syncthreads();\n",
     "        t_mark = clock64();\n"
     "        cp_async_wait_one();\n        __syncthreads();\n"
     "        if (it == 0) t_fill = clock64() - t_start;\n"
     "        else t_wait += clock64() - t_mark;\n"
     "        t_mark = clock64();\n"),
    ("        // epilogue: rows",
     "        t_mma += clock64() - t_mark;\n        t_mark = clock64();\n"
     "        // epilogue: rows"),
    ("        __syncthreads();  // the next prefetch may overwrite this "
     "buffer\n    }\n",
     "        __syncthreads();\n"
     "        t_epi += clock64() - t_mark;\n    }\n"
     "    if (threadIdx.x == 0 && blockIdx.x == 0) {\n"
     "        g_phase[0] = t_fill; g_phase[1] = t_wait; g_phase[2] = t_mma;\n"
     "        g_phase[3] = t_epi; g_phase[4] = clock64() - t_start;\n    }\n"),
]
_READ = ('\nextern "C" int epic_gdn_phases(long long* out) {\n'
         '    return (int)cudaMemcpyFromSymbol(out, g_phase, '
         'sizeof(long long) * 5);\n}\n')
_LOOP_OPERANDS = """            uint32_t ahi[4], alo[4];
            const float* xk = xa + 8 * ks;
            const float v0 = xk[0], v1 = xk[8 * stride];
            const float v2 = xk[4], v3 = xk[8 * stride + 4];
            split(v0 * v0, ahi[0], alo[0]);
            split(v1 * v1, ahi[1], alo[1]);
            split(v2 * v2, ahi[2], alo[2]);
            split(v3 * v3, ahi[3], alo[3]);
            // B fragment (k = tig, tig + 4; n = gid) of n-fragment f
            const float* gk = gs + (8 * ks + tig) * kGammaStride + gid;
            uint32_t bhi[kFragsPerWarp][2], blo[kFragsPerWarp][2];
#pragma unroll
            for (int j = 0; j < kFragsPerWarp; ++j) {
                const float* g = gk + 8 * (f0 + kWarpsN * j);
                split(g[0], bhi[j][0], blo[j][0]);
                split(g[4 * kGammaStride], bhi[j][1], blo[j][1]);
            }
"""
_MMA_ONLY_OPERANDS = """            const uint32_t v = 0x3c000000u + ks + lane;
            uint32_t ahi[4] = {v, v, v, v}, alo[4] = {v, v, v, v};
            uint32_t bhi[kFragsPerWarp][2], blo[kFragsPerWarp][2];
#pragma unroll
            for (int j = 0; j < kFragsPerWarp; ++j)
                bhi[j][0] = bhi[j][1] = blo[j][0] = blo[j][1] = v + j;
"""
_VARIANTS = {
    "kernel": [],
    "split4": [("    hi = to_tf32(v);\n"
                "    lo = to_tf32(v - __uint_as_float(hi));\n",
                "    hi = __float_as_uint(v) + 0x1000u;\n"
                "    lo = __float_as_uint(v - __uint_as_float("
                "hi & 0xffffe000u)) + 0x1000u;\n")],
    "16_warps": [("constexpr int kWarpsN = 4;",
                  "constexpr int kWarpsN = 8;")],
    # timing only: the k-loop keeps its 18 MMAs per step but no loads or
    # splits (operands from the step index), so its output differs
    "mma_only": [(_LOOP_OPERANDS, _MMA_ONLY_OPERANDS)],
}


def _edit(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"csrc/gdn.cu (with gdn_common.cuh) no "
                               f"longer holds {old[:40]!r}")
        text = text.replace(old, new)
    return text


def build():
    """Compile every variant (one nvcc each, all started together); returns
    {name: ctypes library}."""
    # the shared header inlined, so that the edits reach its helpers too
    src = _edit(open(SOURCE).read(), [('#include "gdn_common.cuh"\n',
                                       open(HEADER).read())])
    src = _edit(src, _TIMERS) + _READ
    out = os.path.join(_BUILD_DIR, "phases")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, edits in _VARIANTS.items():
        cu = os.path.join(out, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(_edit(src, edits))
        procs[name] = subprocess.Popen(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", cu,
             "-o", os.path.join(out, f"lib{name}.so")],
            stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        lib = ctypes.CDLL(os.path.join(out, f"lib{name}.so"))
        lib.epic_gdn_forward.restype = ctypes.c_int
        lib.epic_gdn_forward.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        libs[name] = lib
    return libs


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


# the backward copies: name -> (source, extra nvcc flags)
_BWD_PHASES = ["-DGDN_PHASES"]
_BWD_MMA_ONLY = ["-DGDN_PHASES", "-DGDN_MMA_ONLY"]
_BWD_PHASE_NAMES = ("gamma + first tile", "tile waits", "product 1",
                    "epilogue 1", "product 2", "epilogue 2", "turn waits",
                    "total")
BWD_ROWS = (262_144, 65_536, 16_384)


def build_backward(extra_sources=()):
    """Compile the backward copies (one nvcc each, all started together);
    returns {name: (ctypes library, has phase clocks)}."""
    out = os.path.join(_BUILD_DIR, "phases")
    os.makedirs(out, exist_ok=True)
    jobs = {"bwd": (BACKWARD_SOURCE, _BWD_PHASES),
            "bwd_mma_only": (BACKWARD_SOURCE, _BWD_MMA_ONLY)}
    for i, path in enumerate(extra_sources):
        jobs[f"extra{i}"] = (os.path.abspath(path), _BWD_PHASES)
    procs = {}
    for name, (src, flags) in jobs.items():
        procs[name] = subprocess.Popen(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", *flags, src, "-o",
             os.path.join(out, f"lib{name}.so")],
            stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        for line in err.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
        lib = ctypes.CDLL(os.path.join(out, f"lib{name}.so"))
        lib.epic_gdn_backward.restype = ctypes.c_int
        lib.epic_gdn_backward.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        libs[name] = (lib, hasattr(lib, "epic_gdn_bwd_phases"))
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


def run_backward(extra_sources=()) -> None:
    libs = build_backward(extra_sources)
    rng = np.random.default_rng(0)
    c = 192
    gamma = torch.as_tensor((0.1 * np.eye(c) + 0.01 * rng.random((c, c)))
                            .astype(np.float32), device="cuda")
    beta = torch.as_tensor((1.0 + 0.1 * rng.random(c)).astype(np.float32),
                           device="cuda")
    for rows in BWD_ROWS:
        x = torch.as_tensor(rng.normal(0, 1, (rows, c)).astype(np.float32),
                            device="cuda")
        g = torch.as_tensor(rng.normal(0, 1, (rows, c)).astype(np.float32),
                            device="cuda")
        for inverse in (0, 1):
            kind = "igdn" if inverse else "gdn "
            want = gdn_backward_rows(x, gamma, beta, g, bool(inverse))
            ms = _ms(lambda: gdn_backward_rows(x, gamma, beta, g,
                                               bool(inverse)))
            print(f"R={rows} library      {kind} {ms:.4f} ms", flush=True)
            if rows == BWD_ROWS[0]:
                mhz = sm_clock_mhz_under_load(lambda: gdn_backward_rows(
                    x, gamma, beta, g, bool(inverse)))
                print(f"SM clock under load: {mhz:.0f} MHz", flush=True)
            for name, (lib, clocks) in libs.items():
                dx, u = torch.empty_like(x), torch.empty_like(x)

                def launch():
                    rc = lib.epic_gdn_backward(
                        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                        g.data_ptr(), dx.data_ptr(), u.data_ptr(), rows, c,
                        inverse, torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"launch failed: CUDA error {rc}")

                ms = _ms(launch)
                launch()
                torch.cuda.synchronize()
                same = torch.equal(dx, want[0]) and torch.equal(u, want[1])
                line = (f"R={rows} {name:12s} {kind} {ms:.4f} ms, dx and u "
                        f"equal to the library's: {same}")
                if clocks:
                    clk = (ctypes.c_longlong * 8)()
                    lib.epic_gdn_bwd_phases(clk)
                    line += "; block 0 clocks: " + ", ".join(
                        f"{n} {v}" for n, v in zip(_BWD_PHASE_NAMES, clk))
                print(line, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--part", choices=("forward", "backward", "both"),
                    default="both")
    ap.add_argument("--bwd-source", action="append", default=[],
                    help="another backward source to time beside the "
                         "repository's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gdn_phases: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.part != "forward":
        run_backward(args.bwd_source)
    if args.part != "backward":
        run_forward()
    return 0


def run_forward() -> None:
    libs = build()
    rng = np.random.default_rng(0)
    c = 192
    gamma = torch.as_tensor((0.1 * np.eye(c) + 0.01 * rng.random((c, c)))
                            .astype(np.float32), device="cuda")
    beta = torch.as_tensor((1.0 + 0.1 * rng.random(c)).astype(np.float32),
                           device="cuda")
    for rows in (98_304, 21):
        x = torch.as_tensor(rng.normal(0, 1, (rows, c)).astype(np.float32),
                            device="cuda")
        outs = {}
        for name, lib in libs.items():
            for inverse in (0, 1):
                y = torch.empty_like(x)

                def launch():
                    rc = lib.epic_gdn_forward(
                        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                        y.data_ptr(), rows, c, inverse,
                        torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"launch failed: CUDA error {rc}")

                ms = _ms(launch)
                launch()
                torch.cuda.synchronize()
                outs[name, inverse] = y
                clk = (ctypes.c_longlong * 5)()
                lib.epic_gdn_phases(clk)
                same = torch.equal(y, outs["kernel", inverse])
                print(f"R={rows} {name:9s} {'igdn' if inverse else 'gdn '} "
                      f"{ms:.4f} ms, equal to the kernel's output: {same}; "
                      f"block 0 clocks: gamma + first tile {clk[0]}, tile "
                      f"waits {clk[1]}, MMA loop {clk[2]}, epilogue "
                      f"{clk[3]}, total {clk[4]}", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
