// gdn_common.cuh — what the GDN kernels for Hopper (sm_90a) share: gdn.cu
// (forward) and gdn_bwd.cu (backward) each include it once. The forward
// takes from it only the 3xTF32 operand split (the same rounding in both
// kernels) and kMaxChannels; the rest is the backward's: its tile geometry,
// the mma.sync TF32 product, the cp.async copy of gamma and the persistent
// launch's per-device set-up. Everything here has internal linkage, so each
// source's library keeps its own copy of the per-device state.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTileRows = 32;
constexpr int kWarpsN = 4;                      // warps across N (x 2 in M)
constexpr int kThreads = 64 * kWarpsN;
constexpr int kMaxChannels = 192;
constexpr int kGammaStride = kMaxChannels + 8;  // floats per gamma row
constexpr int kFragsPerWarp = kMaxChannels / 8 / kWarpsN;  // 6

// The TF32 value nearest to v, ties away from zero: what cvt.rna.tf32.f32
// gives for a finite v, in two integer operations (half a TF32 unit added
// to the magnitude's bits, then the 13 low bits cleared).
__device__ __forceinline__ uint32_t to_tf32(float v) {
    return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo, both TF32.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
    hi = to_tf32(v);
    lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Start copying gamma ([c][c]) into gs ([fill_rows][kGammaStride]), all
// copies in flight at once; outside [c][c] the same copies zero-fill it, up
// to column kMaxChannels.
__device__ __forceinline__ void load_gamma(float* gs, const float* gamma,
                                           int c, int fill_rows) {
    if ((c & 3) == 0 && (reinterpret_cast<uintptr_t>(gamma) & 15) == 0) {
        constexpr int per_row = kMaxChannels / 4;
        for (int i = threadIdx.x; i < fill_rows * per_row; i += kThreads) {
            const int r = i / per_row, q = 4 * (i - r * per_row);
            const bool valid = r < c && q < c;
            cp_async16(gs + r * kGammaStride + q,
                       valid ? gamma + r * c + q : gamma, valid);
        }
    } else {
        for (int i = threadIdx.x; i < fill_rows * kMaxChannels;
             i += kThreads) {
            const int r = i / kMaxChannels, q = i - r * kMaxChannels;
            const bool valid = r < c && q < c;
            cp_async4(gs + r * kGammaStride + q,
                      valid ? gamma + r * c + q : gamma, valid);
        }
    }
}

// beta at the two accumulator columns 8 (f0 + kWarpsN j) + 2 tig (+ 1) of
// each of this warp's n-fragments j; 1 past C.
__device__ __forceinline__ void load_beta_cols(
        float (&bcol)[kFragsPerWarp][2], const float* beta, int c, int f0,
        int tig) {
#pragma unroll
    for (int j = 0; j < kFragsPerWarp; ++j) {
        const int col = 8 * (f0 + kWarpsN * j) + 2 * tig;
        bcol[j][0] = col < c ? beta[col] : 1.0f;
        bcol[j][1] = col + 1 < c ? beta[col + 1] : 1.0f;
    }
}

// Per device: the SM count, and whether each variant's shared-memory limit
// was raised (once, to what the widest C needs).
struct DeviceState {
    int sm_count = 0;
    bool smem_set[2] = {false, false};
};
constexpr int kMaxDevices = 64;
DeviceState g_devices[kMaxDevices];

// The grid of a persistent launch of `kernel` (variant 0: GDN, 1: inverse)
// over `rows` on the current device: min(tiles, SMs) blocks, into
// `blocks`. The SM count is read, and the kernel's shared-memory limit
// raised to `max_smem`, once per device and variant, not on every launch.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int variant, int max_smem,
                            long long rows, int& blocks) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    DeviceState& st = g_devices[dev];
    if (st.sm_count == 0) {
        err = cudaDeviceGetAttribute(&st.sm_count,
                                     cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return err;
    }
    if (!st.smem_set[variant]) {
        err = cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   max_smem);
        if (err != cudaSuccess) return err;
        st.smem_set[variant] = true;
    }
    const long long tiles = (rows + kTileRows - 1) / kTileRows;
    blocks = static_cast<int>(tiles < st.sm_count ? tiles : st.sm_count);
    return cudaSuccess;
}

}  // namespace
