// gdn.cu — fused GDN / inverse GDN for Hopper (sm_90a) on tensor cores,
// with a plain C interface bound from Python with ctypes
// (epic_tpu_torch/ops/gdn_kernel.py).
//
// Replaces the JAX package's Pallas TPU kernel: epic_tpu/ops/pallas_gdn.py
// (_gdn_kernel, launched by _gdn_pallas_2d). Over x flattened to [R, C]
// (the rows of an NHWC tensor, float32):
//     norm[r, i] = beta[i] + sum_j x[r, j]^2 * gamma[j, i]
//     y[r, i]    = x[r, i] * rsqrt(norm[r, i])      GDN
//     y[r, i]    = x[r, i] * sqrt(norm[r, i])       inverse GDN
//
// What bounds it on the H100. The product is 2RC^2 operations against
// 8RC + 4C^2 + 4C bytes: at C = 192, 48 operations per byte. On the float32
// CUDA cores (67 TFLOP/s) that is bound by operations (0.109 ms at R =
// 98,304). On the tensor cores, float32 accuracy takes three TF32 products
// (3xTF32, below): 3 * 2RC^2 at 495 TFLOP/s is 0.044 ms against 0.045 ms for
// the bytes at 3.35 TB/s, so the kernel is bound by bytes, with the
// tensor-core work just under it.
//
// Design:
//  - mma.sync.m16n8k8 TF32 with 3xTF32 compensation: each operand v splits
//    into hi = tf32(v) and lo = tf32(v - hi), rounded to nearest with ties
//    away from zero (cvt.rna's rounding, done with two integer operations),
//    and every k-step accumulates a_lo*b_hi, then a_hi*b_lo, then a_hi*b_hi
//    into one float32 accumulator. All terms are >= 0 (x^2, and gamma after
//    its reparametrisation), so the sum does not cancel and keeps float32
//    accuracy (plain TF32 would miss 1e-5 relative).
//  - A persistent grid of min(tiles, SMs) blocks. Each block reads gamma
//    from global memory once, with 16-byte cp.async all in flight together
//    with its first x tile, keeps it in shared memory (row stride 200
//    floats, so the B-fragment loads hit 32 distinct banks), then walks
//    over 32-row tiles of x. The CUDA-core kernel it replaces re-read all
//    of gamma from L2 for every 64 rows (226 MB per launch at R = 98,304).
//  - x tiles are double-buffered with cp.async (16-byte copies when C is a
//    multiple of 4, else 4-byte ones): the next tile arrives while this
//    one's MMAs run. Rows past R are zero-filled, not read; the padded row
//    stride (C rounded up to 8, + 4) keeps the A-fragment loads free of
//    bank conflicts.
//  - 8 warps; warp w owns rows 16 * (w % 2) .. +15 of the tile and the
//    n-fragments (8 columns each) f = w / 2 + 4j, j < 6: 24 accumulators.
//    The epilogue takes sqrt(norm) as norm * rsqrt(norm).
//    x^2 is formed and split in registers; it never goes to memory. K is
//    zero-padded to a multiple of 8 and gamma's N to 192, so any C in
//    1..192 runs the same unguarded k-loop.
//  - The epilogue adds beta, applies rsqrt or sqrt and multiplies by x read
//    from the tile in shared memory (not from global memory again), then
//    stores y, two columns at a time when C is even; the ragged last tile
//    is masked.
//  - Determinism: every output sums k in the same fixed order with the same
//    three-MMA sequence; no split-K, no atomics, nothing that depends on R.
//    A row's bits do not depend on R or on its tile, so the encoder and the
//    decoder, which see different batch shapes of the same rows, agree.
//  - Host cost: the shared-memory limit is raised and the SM count read
//    once per device (and variant), not on every launch.
//
// Shared memory at C = 192: gamma 192 * 200 * 4 = 153,600 B plus two x
// tiles of 32 * 196 * 4 = 25,088 B: 203,776 B of the 232,448 a block may use.

#include "gdn_common.cuh"

namespace {

__host__ __device__ constexpr int smem_bytes(int c) {
    return (round8(c) * kGammaStride + 2 * kTileRows * tile_stride(c)) *
           static_cast<int>(sizeof(float));
}

template <bool kInverse>
__global__ void __launch_bounds__(kThreads, 1)
gdn_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
           const float* __restrict__ beta, float* __restrict__ y,
           long long rows, int c) {
    extern __shared__ __align__(16) float smem[];
    const int kp = round8(c);          // K padded to the MMA depth
    const int ksteps = kp >> 3;
    const int stride = tile_stride(c);
    // gamma [kp][kGammaStride], N zero-padded to 192: every warp then runs
    // the same 6 n-fragments with no guard in the k-loop; the row stride
    // 200 (= 8 mod 32 banks) keeps the B-fragment loads conflict-free
    float* gs = smem;
    float* xbuf = smem + kp * kGammaStride;  // two x tiles [2][32][stride]
    const int tile_floats = kTileRows * stride;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int gid = lane >> 2;         // fragment row group
    const int tig = lane & 3;          // thread in group
    const long long ntiles = (rows + kTileRows - 1) / kTileRows;
    const bool vec4 = (c & 3) == 0 &&
                      (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const bool even = (c & 1) == 0 &&
                      (reinterpret_cast<uintptr_t>(y) & 7) == 0;

    // gamma -> shared memory, once per block, all in flight at once; the
    // padding (rows >= C, columns >= C) is zero-filled by the same copies
    load_gamma(gs, gamma, c, kp);
    long long t = blockIdx.x;
    load_tile(xbuf, x, rows, c, t, vec4);
    cp_async_commit();  // gamma and the first tile
    zero_k_padding(xbuf, c);

    const int m0 = 16 * (warp & 1);    // this warp's rows in the tile
    const int f0 = warp >> 1;          // its first n-fragment (of 24)
    float bcol[kFragsPerWarp][2];
    load_beta_cols(bcol, beta, c, f0, tig);

    for (int it = 0; t < ntiles; t += gridDim.x, ++it) {
        const float* xs = xbuf + (it & 1) * tile_floats;
        if (t + gridDim.x < ntiles)
            load_tile(xbuf + ((it + 1) & 1) * tile_floats, x, rows, c,
                      t + gridDim.x, vec4);
        cp_async_commit();  // possibly empty: keeps the group count uniform
        cp_async_wait_one();
        __syncthreads();

        float acc[kFragsPerWarp][4];
#pragma unroll
        for (int j = 0; j < kFragsPerWarp; ++j)
            acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

        // Each k-step adds a_lo*b_hi, then a_hi*b_lo, then a_hi*b_hi to
        // every accumulator; the three passes go over all n-fragments in
        // turn, so consecutive MMAs are independent and overlap.
        const float* xa = xs + (m0 + gid) * stride + tig;
#pragma unroll 4
        for (int ks = 0; ks < ksteps; ++ks) {
            uint32_t ahi[4], alo[4];
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
#pragma unroll
            for (int j = 0; j < kFragsPerWarp; ++j)
                mma_tf32(acc[j], alo, bhi[j]);
#pragma unroll
            for (int j = 0; j < kFragsPerWarp; ++j)
                mma_tf32(acc[j], ahi, blo[j]);
#pragma unroll
            for (int j = 0; j < kFragsPerWarp; ++j)
                mma_tf32(acc[j], ahi, bhi[j]);
        }

        // epilogue: rows m0 + gid (+ 8), columns 8 f + 2 tig (+ 1); y is
        // stored two columns at a time when C is even
        const long long r0 = t * kTileRows;
#pragma unroll
        for (int j = 0; j < kFragsPerWarp; ++j) {
            const int col = 8 * (f0 + kWarpsN * j) + 2 * tig;
            if (col >= c) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = m0 + gid + 8 * h;
                if (r0 + r >= rows) continue;
                const float* xr = xs + r * stride + col;
                float out[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float norm = acc[j][2 * h + e] + bcol[j][e];
                    // sqrt(norm) as norm * rsqrt(norm): two operations
                    // instead of the correctly rounded square root's
                    // slow path, within 2 ulp (norm >= beta > 0)
                    const float r = rsqrtf(norm);
                    out[e] = kInverse ? xr[e] * (norm * r) : xr[e] * r;
                }
                float* yr = y + (r0 + r) * c + col;
                if (even) {
                    *reinterpret_cast<float2*>(yr) =
                        make_float2(out[0], out[1]);
                } else {
                    yr[0] = out[0];
                    if (col + 1 < c) yr[1] = out[1];
                }
            }
        }
        __syncthreads();  // the next prefetch may overwrite this buffer
    }
}

template <bool kInverse>
cudaError_t launch(const float* x, const float* gamma, const float* beta,
                   float* y, long long rows, int c, cudaStream_t stream) {
    int blocks = 0;
    const cudaError_t err = persistent_grid(
        gdn_kernel<kInverse>, kInverse, smem_bytes(kMaxChannels), rows,
        blocks);
    if (err != cudaSuccess) return err;
    gdn_kernel<kInverse><<<blocks, kThreads, smem_bytes(c), stream>>>(
        x, gamma, beta, y, rows, c);
    return cudaGetLastError();
}

}  // namespace

// x, y: [rows, channels] float32, contiguous; gamma [channels, channels];
// beta [channels]; 1 <= channels <= 192. Enqueues on `stream` on the current
// device and does not synchronise. Returns a cudaError_t (0 on success).
extern "C" int epic_gdn_forward(const float* x, const float* gamma,
                                const float* beta, float* y, long long rows,
                                int channels, int inverse, void* stream) {
    if (channels <= 0 || channels > kMaxChannels || rows < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (rows == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return static_cast<int>(
        inverse ? launch<true>(x, gamma, beta, y, rows, channels, s)
                : launch<false>(x, gamma, beta, y, rows, channels, s));
}
