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
// at C = 192, 48 operations per byte, bound by bytes at the published TF32
// peak. But mma.sync TF32 m16n8k8 runs at one per 8 clocks per SM
// sub-partition when two warps issue (tools/gdn_phases.py, the mma_only
// copies), half the rate that peak assumes, and one warp alone issues one
// per ~14 clocks. A 32-row tile's 6,912 MMAs (2 products x 3 passes x 2
// m16 x 24 n8 x 24 k8) take at least 13,824 clocks per SM: the floor of an
// mma.sync design. The kernel is laid out so that the rest costs few
// instructions and runs while the tensor cores are busy:
//  - 3xTF32 (a_lo*b_hi, a_hi*b_lo and a_hi*b_hi, each pass into its own
//    float32 accumulators, summed as (hi*hi + lo*hi) + hi*lo at the end)
//    for float32 accuracy. The MMA reads only the top 19 bits of a
//    register, so hi is the value itself (truncated by the MMA) and
//    lo = v - (v with its 13 low bits cleared), handed over as it is: two
//    operations per operand instead of a rounded split's five. The second
//    product's A operand u is signed, so its sum may cancel; each term keeps
//    float32 accuracy, the sum an error relative to sum |u_i gamma_ji|.
//  - Both products run 24 k-steps, fully unrolled, at any C: gamma is
//    zero-padded to [192][192] and both A operands to 192 columns.
//  - Within each 8-wide k-step, MMA slot k = tig holds column 2 tig and slot
//    tig + 4 column 2 tig + 1 (the contraction does not care which column
//    sits in which slot, as long as A and B agree). Then the A fragment of
//    product 2 at k-step f is exactly what lane (gid, tig) of the warp that
//    owns n-fragment f holds of u after product 1: epilogue 1 stores it in
//    that fragment order, and product 2 reads its A operand with one
//    128-bit load per k-step. Product 1's A (x^2) is two 64-bit loads.
//  - gamma sits in shared memory once per block as [192][192], each row's
//    columns XOR-swizzled in bits 3-4 by the row (swz below), so that both
//    products read it without bank conflicts: product 1 as B[k][n] =
//    gamma[k][n] (32-bit loads), product 2 as B[k][n] = gamma[n][k] (64-bit
//    loads of a column pair). Every fragment address is a per-thread base
//    plus a constant, or, in product 2, one XOR per k-step.
//  - Two groups of 4 warps (one warp of each on every sub-partition); each
//    group owns 16 rows of every tile and walks the block's tiles on its
//    own, with its own barriers. The groups take turns on the tensor cores
//    (two named barriers): while one issues a product's MMAs, the other
//    runs its epilogue, its tile wait and its loads, which so hide under
//    the MMAs instead of leaving the tensor cores idle.
//  - x tiles (32 rows, row stride 200 floats: conflict-free 64-bit loads)
//    are double-buffered with cp.async, the next in flight from the start of
//    this tile. g is read once, straight into the registers of the thread
//    that uses it, issued before product 1 and consumed in epilogue 1.
//  - Per tile and group: product 1 gives n in the registers; epilogue 1
//    forms u (to shared memory in fragment order, and to global memory) and
//    keeps g n^-/+1/2 in registers; product 2 on u; epilogue 2 reads x again
//    from its tile and writes dx.
//  - A persistent grid of min(tiles, SMs) blocks; warp f0 of a group owns
//    the n-fragments f0 + 4 j, j < 6. The tile copies' per-thread offsets
//    are computed once per launch.
//  - Determinism: fixed summation order, no atomics, nothing that depends
//    on R or on a row's tile.
//
// Shared memory at any C: gamma 192 * 192 * 4 = 147,456 B, two x tiles of
// 32 * 200 * 4 = 25,600 B and u in fragment order (24,576 B): 223,232 B of
// the 232,448 a block may use.
//
// The helpers (mma.sync, cp.async, beta columns, the launch's set-up) are
// gdn.cu's, from gdn_common.cuh.

#include "gdn_common.cuh"

// Phase clocks, compiled in only with -DGDN_PHASES (tools/gdn_phases.py):
// block 0's thread 0 sums clock64() deltas per phase into g_phase.
#ifdef GDN_PHASES
__device__ long long g_phase[8];
#define PHASE_INIT long long ph_t0 = clock64(), ph_t = ph_t0, ph[7] = {};
#define PHASE(i) do { const long long n_ = clock64(); ph[i] += n_ - ph_t; \
                      ph_t = n_; } while (0)
#define PHASE_SAVE if (blockIdx.x == 0 && threadIdx.x == 0) {            \
        for (int i_ = 0; i_ < 7; ++i_) g_phase[i_] = ph[i_];              \
        g_phase[7] = clock64() - ph_t0; }
#else
#define PHASE_INIT
#define PHASE(i)
#define PHASE_SAVE
#endif

namespace {

constexpr int kStride = kMaxChannels + 8;          // x tile row stride
constexpr int kTileFloats = kTileRows * kStride;
constexpr int kGammaFloats = kMaxChannels * kMaxChannels;
constexpr int kKSteps = kMaxChannels / 8;          // 24
// u in fragment order: [2 row halves][24 k-steps][32 lanes][4]
constexpr int kUFloats = 2 * kKSteps * 32 * 4;
constexpr int kSmemBytes = (kGammaFloats + 2 * kTileFloats + kUFloats) *
                           static_cast<int>(sizeof(float));
// Two groups of 4 warps, each on its own 16 rows of every tile
constexpr int kGroupThreads = kThreads / 2;
constexpr int kGroupRows = kTileRows / 2;
// 16-byte chunks of a group's 16 rows per thread, at most (C = 192)
constexpr int kChunks = kGroupRows * kMaxChannels / 4 / kGroupThreads;  // 6
// named barriers: 1 + group within a group; kTurn + group: that group's
// turn on the tensor cores
constexpr int kTurn = 3;
constexpr uint32_t kTf32Mask = 0xffffe000u;

// gamma[row][col] lives at row * 192 + (col ^ swz(row)): row bit 0 flips
// column bit 4, row bits 1 and 2 flip column bits 3 and 4. A 4-column
// chunk stays whole, and both products' fragment loads hit distinct banks.
__host__ __device__ constexpr int swz(int row) {
    return ((row & 1) << 4) ^ ((row & 6) << 2);
}

__device__ __forceinline__ uint32_t lo_of(float v) {
    return __float_as_uint(v - __uint_as_float(__float_as_uint(v) &
                                               kTf32Mask));
}

// Copy gamma ([c][c]) into gs, swizzled, zero-filled to [192][192]; all
// copies in flight at once.
__device__ __forceinline__ void load_gamma_swizzled(float* gs,
                                                    const float* gamma,
                                                    int c) {
    if ((c & 3) == 0 && (reinterpret_cast<uintptr_t>(gamma) & 15) == 0) {
        constexpr int per_row = kMaxChannels / 4;
        for (int i = threadIdx.x; i < kMaxChannels * per_row;
             i += kThreads) {
            const int r = i / per_row, q = 4 * (i - r * per_row);
            const bool valid = r < c && q < c;
            cp_async16(gs + r * kMaxChannels + (q ^ swz(r)),
                       valid ? gamma + r * c + q : gamma, valid);
        }
    } else {
        for (int i = threadIdx.x; i < kMaxChannels * kMaxChannels;
             i += kThreads) {
            const int r = i / kMaxChannels, q = i - r * kMaxChannels;
            const bool valid = r < c && q < c;
            cp_async4(gs + r * kMaxChannels + (q ^ swz(r)),
                      valid ? gamma + r * c + q : gamma, valid);
        }
    }
}

// Copies of one group's 16 rows of a 32-row x tile into a buffer, by the
// group's 128 threads: with `vec4` (c a multiple of 4, 16-byte aligned
// source) each thread's 16-byte chunks at offsets computed once per launch;
// otherwise 4-byte copies. Rows past `rows` are zero-filled, not read;
// columns c .. 199 are never written.
struct TileCopy {
    int soff[kChunks], goff[kChunks];  // soff < 0: no chunk
    int r_first;                       // the group's first row

    __device__ __forceinline__ TileCopy(int c, int group)
        : r_first(kGroupRows * group) {
        const int per_row = c >> 2;
        const int gtid = threadIdx.x % kGroupThreads;
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
            const int i = gtid + j * kGroupThreads;
            const int r = r_first + (per_row ? i / per_row : 0);
            const int q = per_row ? i % per_row : 0;
            soff[j] = i < kGroupRows * per_row ? r * kStride + 4 * q : -1;
            goff[j] = r * c + 4 * q;
        }
    }

    __device__ __forceinline__ void issue(float* buf, const float* src,
                                          long long rows, int c, long long t,
                                          bool vec4) const {
        const long long r0 = t * kTileRows;
        const float* base = src + r0 * c;
        if (vec4) {
            const long long left = (rows - r0) * c;  // floats from r0 on
#pragma unroll
            for (int j = 0; j < kChunks; ++j) {
                if (soff[j] < 0) continue;
                const bool valid = goff[j] < left;
                cp_async16(buf + soff[j], valid ? base + goff[j] : src,
                           valid);
            }
        } else {
            for (int i = threadIdx.x % kGroupThreads; i < kGroupRows * c;
                 i += kGroupThreads) {
                const int r = r_first + i / c, q = i % c;
                const bool valid = r0 + r < rows;
                cp_async4(buf + r * kStride + q,
                          valid ? base + r * c + q : src, valid);
            }
        }
    }
};

// Named barriers: bar.sync waits until `n` threads have arrived (its own
// warp's included); bar.arrive counts its warp in without waiting.
__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(n) : "memory");
}

// The 18 MMAs of one k-step on raw operands a (4 values) and b (6 x 2):
// a_lo*b_hi, a_hi*b_lo and a_hi*b_hi over the 6 fragments, each pass into
// its own accumulators (the small terms summed apart from hi*hi: half the
// error of one shared accumulator, with the truncated split).
__device__ __forceinline__ void mma_step(
        float (&acc)[3][kFragsPerWarp][4], const float (&a)[4],
        const float (&b)[kFragsPerWarp][2]) {
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        ahi[e] = __float_as_uint(a[e]);
        alo[e] = lo_of(a[e]);
    }
    uint32_t bhi[kFragsPerWarp][2], blo[kFragsPerWarp][2];
#pragma unroll
    for (int j = 0; j < kFragsPerWarp; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            bhi[j][e] = __float_as_uint(b[j][e]);
            blo[j][e] = lo_of(b[j][e]);
        }
    }
#pragma unroll
    for (int j = 0; j < kFragsPerWarp; ++j) mma_tf32(acc[0][j], alo, bhi[j]);
#pragma unroll
    for (int j = 0; j < kFragsPerWarp; ++j) mma_tf32(acc[1][j], ahi, blo[j]);
#pragma unroll
    for (int j = 0; j < kFragsPerWarp; ++j) mma_tf32(acc[2][j], ahi, bhi[j]);
}

// The three passes' sums into one: (hi*hi + lo*hi) + hi*lo.
__device__ __forceinline__ void combine(float (&acc)[kFragsPerWarp][4],
                                        float (&part)[3][kFragsPerWarp][4]) {
#pragma unroll
    for (int j = 0; j < kFragsPerWarp; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            acc[j][e] = (part[2][j][e] + part[0][j][e]) + part[1][j][e];
}

__device__ __forceinline__ void zero(float (&part)[3][kFragsPerWarp][4]) {
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int j = 0; j < kFragsPerWarp; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[p][j][e] = 0.0f;
}

#ifdef GDN_MMA_ONLY
// timing only (-DGDN_MMA_ONLY): operands from the step index, no loads
// (distinct per fragment, so that no two MMA chains are the same)
__device__ __forceinline__ void fake_frags(float (&a)[4],
                                           float (&b)[kFragsPerWarp][2],
                                           int ks, int gid) {
    const uint32_t v = 0x3c000000u + ks + gid;
    a[0] = a[1] = a[2] = a[3] = __uint_as_float(v);
#pragma unroll
    for (int j = 0; j < kFragsPerWarp; ++j)
        b[j][0] = b[j][1] = __uint_as_float(v + (j << 13));
}
#endif

// n - beta = x^2 @ gamma over this warp's 16 rows (xa: row gid, column
// 2 tig of its x tile) and n-fragments. B[k][n] = gamma[k][n] at k = 8 ks +
// 2 tig + e, n = 8 (f0 + 4 j) + gid: since k & 7 = 2 tig + e, the swizzle
// is fixed per e and every address is b_e + 8 ks 192 + 32 j.
__device__ __forceinline__ void product1(float (&acc)[kFragsPerWarp][4],
                                         const float* xa, const float* gs,
                                         int f0, int gid, int tig) {
    const float* b0 = gs + (2 * tig) * kMaxChannels +
                      8 * (f0 ^ (swz(2 * tig) >> 3)) + gid;
    const float* b1 = gs + (2 * tig + 1) * kMaxChannels +
                      8 * (f0 ^ (swz(2 * tig + 1) >> 3)) + gid;
    float part[3][kFragsPerWarp][4];
    zero(part);
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
        float a[4], b[kFragsPerWarp][2];
#ifdef GDN_MMA_ONLY
        fake_frags(a, b, ks, gid);
        (void)xa; (void)b0; (void)b1;
#else
        const float2 p = *reinterpret_cast<const float2*>(xa + 8 * ks);
        const float2 q = *reinterpret_cast<const float2*>(
            xa + 8 * kStride + 8 * ks);
        a[0] = p.x * p.x; a[1] = q.x * q.x;
        a[2] = p.y * p.y; a[3] = q.y * q.y;
#pragma unroll
        for (int j = 0; j < kFragsPerWarp; ++j) {
            const int off = 8 * ks * kMaxChannels + 32 * j;
            b[j][0] = b0[off];
            b[j][1] = b1[off];
        }
#endif
        mma_step(part, a, b);
    }
    combine(acc, part);
}

// u @ gamma^T over this warp's rows (ua: its 24 k-steps of u in fragment
// order, lane's float4 at ua + 4 lane) and n-fragments. B[k][n] =
// gamma[n][k] at n = 8 (f0 + 4 j) + gid, k = 8 ks + 2 tig: swz(n) =
// swz(gid), so the pair sits at bt + 8 (ks ^ s) + 32 j 192.
__device__ __forceinline__ void product2(float (&acc)[kFragsPerWarp][4],
                                         const float* ua, const float* gs,
                                         int f0, int gid, int tig, int lane) {
    const float* bt = gs + (8 * f0 + gid) * kMaxChannels + 2 * tig;
    const int s = swz(gid) >> 3;
    float part[3][kFragsPerWarp][4];
    zero(part);
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
        float a[4], b[kFragsPerWarp][2];
#ifdef GDN_MMA_ONLY
        fake_frags(a, b, ks, gid);
        (void)ua; (void)bt; (void)s; (void)lane;
#else
        const float4 v = *reinterpret_cast<const float4*>(
            ua + (ks * 32 + lane) * 4);
        a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
        const float* bk = bt + 8 * (ks ^ s);
#pragma unroll
        for (int j = 0; j < kFragsPerWarp; ++j) {
            const float2 w = *reinterpret_cast<const float2*>(
                bk + 32 * j * kMaxChannels);
            b[j][0] = w.x;
            b[j][1] = w.y;
        }
#endif
        mma_step(part, a, b);
    }
    combine(acc, part);
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
    PHASE_INIT
    float* gs = smem;                          // gamma, swizzled
    float* xbuf = smem + kGammaFloats;         // two x tiles
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const int group = warp >> 2;               // rows 16 group .. + 15
    const int f0 = warp & 3;                   // n-fragments f0 + 4 j
    const int m0 = kGroupRows * group;
    // this group's u in fragment order: [24 k-steps][32 lanes][4]
    float* uw = xbuf + 2 * kTileFloats + group * kKSteps * 32 * 4;
    const long long ntiles = (rows + kTileRows - 1) / kTileRows;
    const TileCopy copy(c, group);
    const bool vec4x = (c & 3) == 0 &&
                       (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const bool pair_g = (c & 1) == 0 &&
                        (reinterpret_cast<uintptr_t>(g) & 7) == 0;
    const bool pair_dx = (c & 1) == 0 &&
                         (reinterpret_cast<uintptr_t>(dx) & 7) == 0;
    const bool pair_u = (c & 1) == 0 &&
                        (reinterpret_cast<uintptr_t>(u) & 7) == 0;

    long long t = blockIdx.x;
    load_gamma_swizzled(gs, gamma, c);
    copy.issue(xbuf, x, rows, c, t, vec4x);
    cp_async_commit();
    // zero this group's rows of both x tiles at columns c .. 199, which the
    // copies never write and the k-loop reads up to 191
    for (int i = tid % kGroupThreads; i < 2 * kGroupRows * (kStride - c);
         i += kGroupThreads) {
        const int k = i / (kStride - c);  // 0 .. 31: tile k / 16, row k % 16
        xbuf[(k / kGroupRows) * kTileFloats + (m0 + k % kGroupRows) *
             kStride + c + i % (kStride - c)] = 0.0f;
    }
    float bcol[kFragsPerWarp][2];
    load_beta_cols(bcol, beta, c, f0, tig);
    cp_async_wait_all();
    __syncthreads();  // gamma, copied by every thread, is complete

    // The two groups take turns on the tensor cores: while one runs a
    // product, the other runs its epilogue, its tile wait and its loads.
    // Group 0 starts; each product ends by passing the turn on (group 1's
    // last excepted, which nobody waits for).
    const int nphases = 2 * static_cast<int>(
        (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
    int phase = 0;
    auto take_turn = [&]() {
        if (group == 1 || phase > 0) bar_sync(kTurn + group, kThreads);
    };
    auto pass_turn = [&]() {
        if (group == 0 || phase + 1 < nphases)
            bar_arrive(kTurn + 1 - group, kThreads);
        ++phase;
    };

    for (int it = 0; t < ntiles; t += gridDim.x, ++it) {
        const float* xs = xbuf + (it & 1) * kTileFloats;
        const long long r0 = t * kTileRows;
        cp_async_wait_all();
        bar_sync(1 + group, kGroupThreads);  // this group's x rows landed;
                                             // its u and x readers are done
        if (t + gridDim.x < ntiles)
            copy.issue(xbuf + ((it + 1) & 1) * kTileFloats, x, rows, c,
                       t + gridDim.x, vec4x);
        cp_async_commit();
        // g at this thread's accumulator positions, for epilogue 1
        float gv[kFragsPerWarp][4];
#pragma unroll
        for (int j = 0; j < kFragsPerWarp; ++j) {
            const int col = 8 * (f0 + kWarpsN * j) + 2 * tig;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const long long row = r0 + m0 + gid + 8 * h;
                float2 v = make_float2(0.0f, 0.0f);
                if (row < rows && col < c) {
                    const float* p = g + row * c + col;
                    if (pair_g) {
                        v = *reinterpret_cast<const float2*>(p);
                    } else {
                        v.x = p[0];
                        if (col + 1 < c) v.y = p[1];
                    }
                }
                gv[j][2 * h] = v.x;
                gv[j][2 * h + 1] = v.y;
            }
        }
        if (it == 0) PHASE(0);  // gamma and the first tile
        else PHASE(1);          // a tile wait
        take_turn();
        PHASE(6);

        float acc[kFragsPerWarp][4];
        product1(acc, xs + (m0 + gid) * kStride + 2 * tig, gs, f0, gid,
                 tig);
        pass_turn();
        PHASE(2);

        // epilogue 1: u to shared memory in fragment order (0 past C) and
        // to global memory; keep the first term of dx in registers
        float first[kFragsPerWarp][4];
#pragma unroll
        for (int j = 0; j < kFragsPerWarp; ++j) {
            const int col = 8 * (f0 + kWarpsN * j) + 2 * tig;
            float uu[4];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = m0 + gid + 8 * h;
                const float2 xe =
                    *reinterpret_cast<const float2*>(xs + r * kStride + col);
                const float xa2[2] = {xe.x, xe.y};
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int k = 2 * h + e;
                    const float norm = acc[j][k] + bcol[j][e];
                    const float rs = rsqrtf(norm);
                    const float gk = gv[j][k];
                    // GDN: u = g x n^-3/2, g n^-1/2; IGDN: u = g x n^-1/2,
                    // g n^1/2 (sqrt as norm * rsqrt, within 2 ulp)
                    uu[k] = col + e < c
                                ? (kInverse ? gk * xa2[e] * rs
                                            : gk * xa2[e] * (rs * rs * rs))
                                : 0.0f;
                    first[j][k] = kInverse ? gk * (norm * rs) : gk * rs;
                }
                if (col < c && r0 + r < rows)
                    store2(u + (r0 + r) * c + col, uu[2 * h], uu[2 * h + 1],
                           pair_u, col + 1 < c);
            }
            // fragment order of k-step f = f0 + 4 j: rows gid / gid + 8 x
            // slots tig / tig + 4 (columns 2 tig / 2 tig + 1)
            *reinterpret_cast<float4*>(uw + ((f0 + kWarpsN * j) * 32 +
                                             lane) * 4) =
                make_float4(uu[0], uu[2], uu[1], uu[3]);
        }
        bar_sync(1 + group, kGroupThreads);  // this group's u is complete
        PHASE(3);
        take_turn();
        PHASE(6);

        product2(acc, uw, gs, f0, gid, tig, lane);
        pass_turn();
        PHASE(4);
#pragma unroll
        for (int j = 0; j < kFragsPerWarp; ++j) {
            const int col = 8 * (f0 + kWarpsN * j) + 2 * tig;
            if (col >= c) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = m0 + gid + 8 * h;
                if (r0 + r >= rows) continue;
                const float2 xe =
                    *reinterpret_cast<const float2*>(xs + r * kStride + col);
                const float xa2[2] = {xe.x, xe.y};
                float out[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int k = 2 * h + e;
                    out[e] = kInverse ? first[j][k] + xa2[e] * acc[j][k]
                                      : first[j][k] - xa2[e] * acc[j][k];
                }
                store2(dx + (r0 + r) * c + col, out[0], out[1], pair_dx,
                       col + 1 < c);
            }
        }
        PHASE(5);
    }
    PHASE_SAVE
}

template <bool kInverse>
cudaError_t launch(const float* x, const float* gamma, const float* beta,
                   const float* g, float* dx, float* u, long long rows, int c,
                   cudaStream_t stream) {
    int blocks = 0;
    const cudaError_t err = persistent_grid(
        gdn_bwd_kernel<kInverse>, kInverse, kSmemBytes, rows, blocks);
    if (err != cudaSuccess) return err;
    gdn_bwd_kernel<kInverse><<<blocks, kThreads, kSmemBytes, stream>>>(
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

#ifdef GDN_PHASES
// block 0's phase clocks of the last launch (8 values, see PHASE above)
extern "C" int epic_gdn_bwd_phases(long long* out) {
    return static_cast<int>(
        cudaMemcpyFromSymbol(out, g_phase, sizeof(long long) * 8));
}
#endif
