// gdn_bwd.cu — backward of fused GDN / inverse GDN for Hopper (sm_90a) on
// tensor cores, with a plain C interface bound from Python with ctypes
// (epic_tpu_torch/ops/gdn_kernel.py: gdn_backward).
//
// Replaces the backward half of the JAX package's GDN kernel: the
// closed-form custom_vjp rule `_bwd` of gdn_pallas in
// epic_tpu/ops/pallas_gdn.py (XLA there, not Pallas). Over x and the
// incoming gradient g flattened to [R, C] (float32):
//     n[r, i]  = beta[i] + sum_j x[r, j]^2 * gamma[j, i]
//   GDN  (y = x n^-1/2):  u = g x n^-3/2,  dx = g n^-1/2 - x (u @ gamma^T)
//   IGDN (y = x n^+1/2):  u = g x n^-1/2,  dx = g n^+1/2 + x (u @ gamma^T)
// The kernel writes dx and u; the caller forms dgamma = -/+ 1/2 (x^2)^T @ u
// and dbeta = -/+ 1/2 sum_r u with two library reductions, as the JAX
// package leaves them to XLA.
//
// What bounds it on the H100. Two products of 2RC^2 operations (n, then
// u @ gamma^T) against 16RC + 4C^2 + 4C bytes (x, g read; dx, u written):
// at C = 192, 48 operations per byte. In 3xTF32 (below) that is 6 * 2RC^2 /
// 495 TFLOP/s = 0.037 ms at R = 98,304 against 0.090 ms for the bytes at
// 3.35 TB/s: bound by bytes.
//
// Design (the forward kernel's, gdn.cu, with a second product per tile):
//  - mma.sync.m16n8k8 TF32 with 3xTF32 compensation for both products (hi
//    and lo halves of each operand, a_lo*b_hi + a_hi*b_lo + a_hi*b_hi into
//    one float32 accumulator). The second product's A operand u is signed,
//    so its sum may cancel; each term keeps float32 accuracy, the sum an
//    error relative to sum |u_i gamma_ji|.
//  - A persistent grid of min(tiles, SMs) blocks; gamma is read once per
//    block into shared memory, zero-padded to [192][200] so that the first
//    product (B = gamma, k = j) and the second (B = gamma^T, read as
//    gamma[n][k], k = i) index inside it for every C.
//  - Per 32-row tile: x and g arrive by cp.async. Product 1 gives n in the
//    registers; its epilogue forms u in the registers, writes it over g in
//    shared memory (each thread reads g and writes u at the same elements)
//    and to global memory, and keeps g n^-1/2 (or g n^1/2) and x for the
//    last epilogue. Then the next tile's x is fetched while product 2 runs
//    on u; product 2's epilogue writes dx; then the next g is fetched.
//  - Determinism: fixed summation order, no atomics, nothing that depends
//    on R or on a row's tile.
//
// Shared memory at any C: gamma 192 * 200 * 4 = 153,600 B plus the x and
// g/u tiles of 32 * (round8(C) + 4) * 4 B each: 203,776 B at C = 192.
//
// The helpers (TF32 split, mma.sync, cp.async, the launch's set-up) are
// gdn.cu's, from gdn_common.cuh.

#include "gdn_common.cuh"

namespace {

__host__ __device__ constexpr int smem_bytes(int c) {
    return (kMaxChannels * kGammaStride + 2 * kTileRows * tile_stride(c)) *
           static_cast<int>(sizeof(float));
}

// acc[j] += A (16 rows of the tile from `as`, K = kp) times B, where
// B[k][n] = gs[k * kGammaStride + n] (kTransB = false) or
// gs[n * kGammaStride + k] (kTransB = true), for this warp's n-fragments.
// With kSquare the A operand is as^2.
template <bool kSquare, bool kTransB>
__device__ __forceinline__ void product(float (&acc)[kFragsPerWarp][4],
                                        const float* as, const float* gs,
                                        int stride, int ksteps, int f0,
                                        int gid, int tig) {
#pragma unroll
    for (int j = 0; j < kFragsPerWarp; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    const float* xa = as + gid * stride + tig;
#pragma unroll 2
    for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t ahi[4], alo[4];
        const float* xk = xa + 8 * ks;
        float v0 = xk[0], v1 = xk[8 * stride];
        float v2 = xk[4], v3 = xk[8 * stride + 4];
        if (kSquare) {
            v0 *= v0; v1 *= v1; v2 *= v2; v3 *= v3;
        }
        split(v0, ahi[0], alo[0]);
        split(v1, ahi[1], alo[1]);
        split(v2, ahi[2], alo[2]);
        split(v3, ahi[3], alo[3]);
        uint32_t bhi[kFragsPerWarp][2], blo[kFragsPerWarp][2];
#pragma unroll
        for (int j = 0; j < kFragsPerWarp; ++j) {
            const int n = 8 * (f0 + kWarpsN * j) + gid;
            const int k = 8 * ks + tig;
            float b0, b1;
            if (kTransB) {
                b0 = gs[n * kGammaStride + k];
                b1 = gs[n * kGammaStride + k + 4];
            } else {
                b0 = gs[k * kGammaStride + n];
                b1 = gs[(k + 4) * kGammaStride + n];
            }
            split(b0, bhi[j][0], blo[j][0]);
            split(b1, bhi[j][1], blo[j][1]);
        }
#pragma unroll
        for (int j = 0; j < kFragsPerWarp; ++j) mma_tf32(acc[j], alo, bhi[j]);
#pragma unroll
        for (int j = 0; j < kFragsPerWarp; ++j) mma_tf32(acc[j], ahi, blo[j]);
#pragma unroll
        for (int j = 0; j < kFragsPerWarp; ++j) mma_tf32(acc[j], ahi, bhi[j]);
    }
}

__device__ __forceinline__ void store2(float* p, float a, float b, bool pair,
                                       bool second) {
    if (pair) {
        *reinterpret_cast<float2*>(p) = make_float2(a, b);
    } else {
        p[0] = a;
        if (second) p[1] = b;
    }
}

template <bool kInverse>
__global__ void __launch_bounds__(kThreads, 1)
gdn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const float* __restrict__ g,
               float* __restrict__ dx, float* __restrict__ u,
               long long rows, int c) {
    extern __shared__ __align__(16) float smem[];
    const int kp = round8(c);
    const int ksteps = kp >> 3;
    const int stride = tile_stride(c);
    float* gs = smem;                               // [192][kGammaStride]
    float* xs = smem + kMaxChannels * kGammaStride;  // x tile
    float* us = xs + kTileRows * stride;             // g tile, then u

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const long long ntiles = (rows + kTileRows - 1) / kTileRows;
    const bool vec4x = (c & 3) == 0 &&
                       (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const bool vec4g = (c & 3) == 0 &&
                       (reinterpret_cast<uintptr_t>(g) & 15) == 0;
    const bool pair_dx = (c & 1) == 0 &&
                         (reinterpret_cast<uintptr_t>(dx) & 7) == 0;
    const bool pair_u = (c & 1) == 0 &&
                        (reinterpret_cast<uintptr_t>(u) & 7) == 0;

    // gamma -> shared memory, zero outside [c][c]
    load_gamma(gs, gamma, c, kMaxChannels);
    long long t = blockIdx.x;
    load_tile(xs, x, rows, c, t, vec4x);
    load_tile(us, g, rows, c, t, vec4g);
    cp_async_commit();
    // zero the K padding of both tiles (never written by the copies, and u
    // is written only at columns < c)
    zero_k_padding(xs, c);

    const int m0 = 16 * (warp & 1);
    const int f0 = warp >> 1;
    float bcol[kFragsPerWarp][2];
    load_beta_cols(bcol, beta, c, f0, tig);

    for (; t < ntiles; t += gridDim.x) {
        cp_async_wait_all();
        __syncthreads();
        const long long r0 = t * kTileRows;
        const bool has_next = t + gridDim.x < ntiles;

        float acc[kFragsPerWarp][4];
        product<true, false>(acc, xs + m0 * stride, gs, stride, ksteps, f0,
                             gid, tig);

        // epilogue 1: u over g in shared memory and to global memory; keep
        // the first term of dx and x in registers
        float first[kFragsPerWarp][4], xv[kFragsPerWarp][4];
#pragma unroll
        for (int j = 0; j < kFragsPerWarp; ++j) {
            const int col = 8 * (f0 + kWarpsN * j) + 2 * tig;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = m0 + gid + 8 * h;
                float uu[2] = {0.0f, 0.0f};
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int k = 2 * h + e;
                    first[j][k] = 0.0f;
                    xv[j][k] = 0.0f;
                    if (col + e >= c) continue;
                    const float norm = acc[j][k] + bcol[j][e];
                    const float rs = rsqrtf(norm);
                    const float xe = xs[r * stride + col + e];
                    float* ge = us + r * stride + col + e;
                    const float gv = *ge;
                    // GDN: u = g x n^-3/2, g n^-1/2; IGDN: u = g x n^-1/2,
                    // g n^1/2 (sqrt as norm * rsqrt, within 2 ulp)
                    uu[e] = kInverse ? gv * xe * rs : gv * xe * (rs * rs * rs);
                    first[j][k] = kInverse ? gv * (norm * rs) : gv * rs;
                    xv[j][k] = xe;
                    *ge = uu[e];
                }
                if (col < c && r0 + r < rows)
                    store2(u + (r0 + r) * c + col, uu[0], uu[1], pair_u,
                           col + 1 < c);
            }
        }
        __syncthreads();  // u complete; the x tile is free
        if (has_next) load_tile(xs, x, rows, c, t + gridDim.x, vec4x);
        cp_async_commit();

        product<false, true>(acc, us + m0 * stride, gs, stride, ksteps, f0,
                             gid, tig);
#pragma unroll
        for (int j = 0; j < kFragsPerWarp; ++j) {
            const int col = 8 * (f0 + kWarpsN * j) + 2 * tig;
            if (col >= c) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = m0 + gid + 8 * h;
                if (r0 + r >= rows) continue;
                float out[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int k = 2 * h + e;
                    out[e] = kInverse ? first[j][k] + xv[j][k] * acc[j][k]
                                      : first[j][k] - xv[j][k] * acc[j][k];
                }
                store2(dx + (r0 + r) * c + col, out[0], out[1], pair_dx,
                       col + 1 < c);
            }
        }
        __syncthreads();  // done with u: the g/u tile is free
        if (has_next) load_tile(us, g, rows, c, t + gridDim.x, vec4g);
        cp_async_commit();
    }
}

template <bool kInverse>
cudaError_t launch(const float* x, const float* gamma, const float* beta,
                   const float* g, float* dx, float* u, long long rows, int c,
                   cudaStream_t stream) {
    int blocks = 0;
    const cudaError_t err = persistent_grid(
        gdn_bwd_kernel<kInverse>, kInverse, smem_bytes(kMaxChannels), rows,
        blocks);
    if (err != cudaSuccess) return err;
    gdn_bwd_kernel<kInverse><<<blocks, kThreads, smem_bytes(c), stream>>>(
        x, gamma, beta, g, dx, u, rows, c);
    return cudaGetLastError();
}

}  // namespace

// x, g, dx, u: [rows, channels] float32, contiguous; gamma [channels,
// channels]; beta [channels]; 1 <= channels <= 192. Enqueues on `stream` on
// the current device and does not synchronise. Returns a cudaError_t.
extern "C" int epic_gdn_backward(const float* x, const float* gamma,
                                 const float* beta, const float* g, float* dx,
                                 float* u, long long rows, int channels,
                                 int inverse, void* stream) {
    if (channels <= 0 || channels > kMaxChannels || rows < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (rows == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return static_cast<int>(
        inverse ? launch<true>(x, gamma, beta, g, dx, u, rows, channels, s)
                : launch<false>(x, gamma, beta, g, dx, u, rows, channels, s));
}
