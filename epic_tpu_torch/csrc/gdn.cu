// gdn.cu — fused GDN / inverse GDN forward for Hopper (sm_90a): wgmma 3xTF32
// with gamma resident in shared memory, x brought in by TMA and shared by a
// cluster of two blocks, float32 or bf16 in and out. A plain C interface
// bound from Python with ctypes (epic_tpu_torch/ops/gdn_kernel.py).
//
// Replaces the JAX package's Pallas TPU kernel: epic_tpu/ops/pallas_gdn.py
// (_gdn_kernel :27, launched by _gdn_pallas_2d :37). Over x flattened to
// [R, C] (the rows of an NHWC tensor), 1 <= C <= 192:
//     norm[r, i] = beta[i] + sum_j x[r, j]^2 * gamma[j, i]      (float32)
//     y[r, i]    = x[r, i] * rsqrt(norm[r, i])                   GDN
//     y[r, i]    = x[r, i] * sqrt(norm[r, i])                    inverse GDN
// x and y are float32 or bf16 (one template each); gamma and beta float32.
// bf16 x is widened exactly, everything is computed in float32, and y is
// rounded once (round to nearest even) in the epilogue: the bf16 variant
// gives bitwise the float32 variant's output rounded to bf16, so the casts
// that used to wrap each bf16 call (x.float(), y.to(bf16)) are gone.
//
// What bounds it on the H100. float32 accuracy on the tensor cores takes
// three TF32 products (below): 3 * 2RC^2 operations at the TF32 peak of 495
// TFLOP/s. The bytes are x read once, y written once, gamma and beta: 8RC
// (float32) or 4RC (bf16) + 4C^2 + 4C at 3.35 TB/s. At C = 192 and R =
// 5,898,240, float32 is bound by bytes, just (2.70 ms against 2.64 ms of
// operations), bf16 by operations (2.64 ms against 1.35 ms of bytes).
//
// Design:
//  - 3xTF32: each operand v splits into TF32 halves hi + lo: gamma's once
//    per block, rounded (hi = tf32(v), lo = tf32(v - hi): gdn_common.cuh's
//    split); x^2's in two operations (hi = v, which the MMA reads truncated
//    to TF32, and lo = v - trunc(v)). Every k-step adds a_lo*b_hi, then
//    a_hi*b_lo, then a_hi*b_hi into one float32 accumulator. Every term is
//    >= 0 (x^2, and gamma after its reparametrisation), so the sum does not
//    cancel.
//  - wgmma.mma_async m64n96k8 TF32 with A from registers: A = x^2 of a
//    64-row tile, squared and split in registers from the x tile in shared
//    memory; it never goes to memory. B = gamma's hi and lo halves, split
//    once per block into shared memory in wgmma's K-major core-matrix layout
//    (no swizzle: each 8 x 16 B core matrix is 128 contiguous bytes). K is
//    zero-padded to 192, so every C runs the same unrolled 24 k-steps.
//  - Within each 16 columns of K, thread (gid, tig) of a warp owns columns
//    4 tig .. 4 tig + 3 of its two rows: k-step 2m takes the first two of
//    them into MMA slots tig, tig + 4, k-step 2m + 1 the last two (the
//    contraction does not care which column sits in which slot, as long as
//    gamma's rows sit in the same ones). So one 16-byte (float32) or 8-byte
//    (bf16) load per row feeds two k-steps.
//  - Shared memory forces a split of the work: gamma's hi + lo at C = 192
//    is 294,912 B, more than a block may use. A cluster of two blocks on
//    neighbouring SMs walks the same 64-row tiles; block rank r computes
//    the output columns 96 r .. 96 r + 95 (gamma 147,456 B). Each x tile
//    is loaded once from device memory and TMA-multicast to both blocks
//    (each block issues half of its boxes).
//  - x arrives as boxes of 64 rows x 128 bytes (32 float32 or 64 bf16
//    columns, 8,192 B; a 2-D tensor map encoded on the host at each launch,
//    passed as a __grid_constant__), 6 or 3 boxes a tile, into rings of box
//    slots with a full and an empty mbarrier each. TMA's cost goes by box
//    row: rows of 64 and 32 bytes (boxes of 16 columns) held the loads alone
//    to 2.4 and 1.7 TB/s. Rows past R and columns past C are zero-filled by
//    TMA. The boxes are laid out with the 128-byte swizzle (each 16-byte
//    chunk's index XOR the row's index within its 8 rows), and MMA row g of
//    a warp's 8-row group reads tile row tile_row(g), so that a load
//    instruction's rows fall on distinct banks. A consumer releases a box to
//    the whole cluster as soon as its threads have read it into registers
//    (the epilogue's x values included), before the MMAs on it finish, so a
//    ring keeps close to its 5 boxes of loads in flight.
//  - Warp roles: warps 0-7 are two consumer warpgroups that take the
//    cluster's tiles in turn and run side by side (taking turns on the
//    tensor cores, as ping-pong kernels do, was no faster: PERF.md); warps 8
//    and 9 are their producers (one lane each issues the TMA loads), each
//    with its own ring: one producer and one consumer per ring, both in box
//    order, so an mbarrier parity wait never meets a phase two ahead (with
//    one ring shared by two warpgroups running side by side, one could run a
//    phase ahead of a slot and read it before its box arrived). A
//    persistent grid of as many clusters as fit on the card (at most one
//    per tile).
//  - A row pitch TMA cannot take (C * size not a multiple of 16 B), C
//    narrower than a box, or x not 16-byte aligned takes a load path inside
//    the same kernel: the producer warp's 32 lanes copy each box into the
//    same swizzled layout with plain loads and stores (cp.async cannot: its
//    smallest copy is 4 bytes, and a bf16 row of odd C starts on a 2-byte
//    boundary) and each arrives on the box's barrier.
//  - Epilogue: adds beta (from shared memory), applies rsqrt (or norm *
//    rsqrt(norm) for IGDN: two operations instead of the correctly rounded
//    square root's slow path, within 2 ulp; norm >= beta > 0, so the MUFU
//    approximation needs no scaling of denormals), multiplies by x kept in
//    registers from the box (a bf16 pair in one register), rounds once to
//    the output type and stores two columns at a time when C is even. A
//    whole tile at C = 192 takes a path with no bounds checks.
//  - Determinism: every output sums k in the same fixed order with the same
//    three-product sequence, in one accumulator; no split-K, no atomics. A
//    row's bits depend only on the row: not on R, its tile, the block's
//    rank or the stream. The encoder and the decoder, which see different
//    batch shapes of the same rows, agree bitwise.
//
// Shared memory (either type): gamma hi 73,728 B + lo 73,728 B; two rings
// of 5 boxes (81,920 B in all); a full and an empty barrier per slot;
// beta's 96 columns (384 B); a 16-byte scratch word; 1,024 B of alignment
// slack (the swizzle's atom): 230,960 B of the 232,448 a block may use.
// 320 threads.
//
// Phase clocks, compiled in only with -DGDN_PHASES (tools/gdn_phases.py):
// block 0's first consumer thread and producer lane sum clock64() deltas.
// Timing-only copies of that tool: -DGDN_MMA_ONLY feeds the MMAs operands
// made from the step index (no loads or splits), -DGDN_NO_MMA issues no
// MMA; their outputs are not GDN's.

#include "gdn_common.cuh"

#include <mutex>

namespace {

constexpr int kRows = 64;                    // rows of a tile (wgmma's M)
constexpr int kK = kMaxChannels;             // K, zero-padded
constexpr int kCluster = 2;                  // blocks sharing a tile
constexpr int kN = kMaxChannels / kCluster;  // output columns per block
constexpr int kConsumerWarps = 8;             // two warpgroups
constexpr int kFwdThreads = 32 * kConsumerWarps + 64;  // + a producer each
constexpr int kGammaBytes = kN * kK * 4;     // one TF32 half
constexpr int kSmemBudget = 232448;
constexpr int kAlign = 1024;                 // the 128-byte swizzle's atom
constexpr int kBoxBytes = kRows * kBoxRow;   // 8,192

// A box is 64 rows x 128 bytes of x: 32 float32 or 64 bf16 columns.
template <typename Raw>
struct Box {
    static constexpr int kCols = kBoxRow / static_cast<int>(sizeof(Raw));
    static constexpr int kCount = kK / kCols;    // boxes per tile: 6 or 3
    static constexpr int kGroups = kCols / 16;   // 16-column groups: 2 or 4
    // slots of each consumer warpgroup's ring, with a full and an empty
    // barrier each, beside gamma and beta
    static constexpr int kSlots =
        (kSmemBudget - 2 * kGammaBytes - 4 * kN - 16 - kAlign) /
        (2 * (kBoxBytes + 16));
    static constexpr int kSmem = 2 * kGammaBytes +
        2 * kSlots * (kBoxBytes + 16) + 4 * kN + 16 + kAlign;
};

// The tile row of MMA row g (0..7) of a warp's 8-row group: permuted so
// that one load instruction's rows fall on distinct banks. float32 (16-byte
// loads, 8 lanes a pass): rows g and g + 1 of a pass 4 apart; bf16 (8-byte
// loads, 16 lanes a pass): the 4 rows of a pass 2 apart.
template <typename Raw>
__device__ __forceinline__ int tile_row(int g) {
    return sizeof(Raw) == 4 ? (g >> 1) | ((g & 1) << 2)
                            : ((g & 3) << 1) | (g >> 2);
}

#ifdef GDN_PHASES
__device__ long long g_phase[8];
#define PHASE_DECL long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0}, ph_mark = 0;
#define PHASE_MARK ph_mark = clock64();
#define PHASE_ADD(i) ph[i] += clock64() - ph_mark;
#else
#define PHASE_DECL
#define PHASE_MARK
#define PHASE_ADD(i)
#endif

// d[64 x 96] += a[64 x 8] (TF32, registers) * b[8 x 96] (TF32, descriptor)
__device__ __forceinline__ void wgmma_tf32(float (&d)[48],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, "
        "1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <typename Raw, bool kInverse>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kFwdThreads, 1)
gdn_kernel(const __grid_constant__ CUtensorMap tmap,
           const Raw* __restrict__ x, const float* __restrict__ gamma,
           const float* __restrict__ beta, Raw* __restrict__ y, int rows,
           int c, int use_tma) {
    using B = Box<Raw>;
    constexpr int kSlots = B::kSlots;  // per ring
    constexpr int kEs = static_cast<int>(sizeof(Raw));
    extern __shared__ __align__(16) uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1)))
                                & (kAlign - 1));
    uint32_t* ghi = reinterpret_cast<uint32_t*>(smem);
    uint32_t* glo = reinterpret_cast<uint32_t*>(smem + kGammaBytes);
    uint8_t* ring = smem + 2 * kGammaBytes;
    const uint32_t ring_s = smem_u32(ring);
    const uint32_t full_s = ring_s + 2 * kSlots * kBoxBytes;  // 2 kSlots
    const uint32_t empty_s = full_s + 16 * kSlots;            // 2 kSlots
    float* bs = reinterpret_cast<float*>(ring + 2 * kSlots * (kBoxBytes + 16));
    // a word the releasing lanes store to (see the consumer's release)
    volatile uint32_t* sink = reinterpret_cast<uint32_t*>(bs + kN);

    const int tid = threadIdx.x;
    const int rank = static_cast<int>(cluster_rank());
    const int n0 = kN * rank;

    // gamma's hi and lo halves, columns n0 .. n0 + 95, zero-padded
    for (int e = tid; e < kN * kK; e += kFwdThreads) {
        const int k = e / kN, n = e - k * kN;
        const float g = k < c && n0 + n < c ? gamma[k * c + n0 + n] : 0.0f;
        uint32_t hi, lo;
        split(g, hi, lo);
        const int w = gamma_word(n, k);
        ghi[w] = hi;
        glo[w] = lo;
    }
    if (tid < kN) bs[tid] = n0 + tid < c ? beta[n0 + tid] : 1.0f;
    if (tid == 0) {
        for (int s = 0; s < 2 * kSlots; ++s) {
            mbar_init(full_s + 8 * s, use_tma ? 1 : 32);
            mbar_init(empty_s + 8 * s, 4 * kCluster);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // gamma was written by threads and is read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    cluster_sync();

    const int ntiles = (rows + kRows - 1) / kRows;
    const int cid = static_cast<int>(cluster_id());
    const int ncl = static_cast<int>(cluster_count());
    const int warp = tid >> 5, lane = tid & 31;
    PHASE_DECL

    // Warpgroup w consumes the cluster's tiles i = w, w + 2, ..., fed by
    // producer warp 8 + w through ring w (slots w kSlots .. + kSlots - 1):
    // each ring has one producer and one consumer, both in box order, so a
    // parity wait never sees a phase two ahead.
    if (warp >= kConsumerWarps) {
        // producer: box m of the ring's j-th tile is its box g = B::kCount j
        // + m
        const int w = warp - kConsumerWarps;
        uint32_t g = 0;
        for (int t = cid + w * ncl; t < ntiles; t += 2 * ncl) {
            for (int m = 0; m < B::kCount; ++m, ++g) {
                const uint32_t slot = w * kSlots + g % kSlots;
                const uint32_t par = ((g / kSlots) & 1) ^ 1;
                const uint32_t full = full_s + 8 * slot;
                if (use_tma) {
                    if (lane == 0) {
                        PHASE_MARK
                        mbar_wait(empty_s + 8 * slot, par);
                        PHASE_ADD(0)
                        mbar_expect_tx(full, kBoxBytes);
                        if (m % kCluster == rank)
                            tma_multicast(ring_s + slot * kBoxBytes, &tmap,
                                          B::kCols * m, kRows * t, full,
                                          (1u << kCluster) - 1);
                    }
                } else {
                    mbar_wait(empty_s + 8 * slot, par);
                    uint8_t* box = ring + slot * kBoxBytes;
                    for (int e = lane; e < kRows * B::kCols; e += 32) {
                        const int r = e / B::kCols, cb = e % B::kCols;
                        const int gr = kRows * t + r, col = B::kCols * m + cb;
                        *reinterpret_cast<Raw*>(box + swz(r, kEs * cb)) =
                            gr < rows && col < c
                                ? x[static_cast<long long>(gr) * c + col]
                                : Raw(0);
                    }
                    mbar_arrive(full);
                }
            }
        }
    } else {
        // consumers: warpgroup wg takes the cluster's tiles i = wg, wg + 2..
        const int wg = warp >> 2;
        const int gid = lane >> 2, tig = lane & 3;
        // this thread's two tile rows (MMA rows gid and gid + 8 of the warp)
        const int rl = 16 * (warp & 3) + tile_row<Raw>(gid), rh = rl + 8;
        const uint64_t desc_hi = make_desc(smem_u32(ghi));
        const uint64_t desc_lo = make_desc(smem_u32(glo));
        const bool pairs = (c & 1) == 0 &&
            (reinterpret_cast<uintptr_t>(y) & (2 * sizeof(Raw) - 1)) == 0;
        for (int j = 0, t = cid + wg * ncl; t < ntiles;
             ++j, t += 2 * ncl) {
            float acc[48];
#pragma unroll
            for (int q = 0; q < 48; ++q) acc[q] = 0.0f;
            uint32_t a[2][2][4][2];  // A operands of the last two groups:
                                     // [group parity][k-step][reg][hi, lo]
            typename Pair<Raw>::T xe[kN / 8][2];  // x at this thread's outputs
            const uint32_t g0 = B::kCount * j;
            PHASE_MARK
#pragma unroll
            for (int m = 0; m < B::kCount; ++m) {
                const uint32_t slot = wg * kSlots + (g0 + m) % kSlots;
                const uint32_t par = ((g0 + m) / kSlots) & 1;
                PHASE_ADD(1)
                PHASE_MARK
                mbar_wait(full_s + 8 * slot, par);
                PHASE_ADD(2)
                PHASE_MARK
                const uint8_t* box = ring + slot * kBoxBytes;
                uint32_t read = 0;  // a register of each load of the box
#pragma unroll
                for (int h = 0; h < B::kGroups; ++h) {
                    // columns 16 q .. 16 q + 15 of the tile: k-steps 2q, 2q+1
                    const int q = B::kGroups * m + h;
                    float v[2][4];
#ifdef GDN_MMA_ONLY
                    for (int u = 0; u < 4; ++u)
                        v[0][u] = v[1][u] =
                            __uint_as_float(0x3c000000u + q + u);
#else
                    const int b = kEs * (16 * h + 4 * tig);
                    load4(reinterpret_cast<const Raw*>(box + swz(rl, b)),
                          v[0]);
                    load4(reinterpret_cast<const Raw*>(box + swz(rh, b)),
                          v[1]);
                    read ^= __float_as_uint(v[0][0]) ^ __float_as_uint(v[1][0]);
#endif
#pragma unroll
                    for (int u = 0; u < 2; ++u) {
                        // n8-group 2q + u of the 24: output columns of rank
                        // (2q + u) / 12
                        if ((2 * q + u) / (kN / 8) == rank) {
                            const int i = (2 * q + u) % (kN / 8);
                            const int be = kEs * (16 * h + 8 * u + 2 * tig);
                            xe[i][0] = load_pair(
                                reinterpret_cast<const Raw*>(box + swz(rl, be)));
                            xe[i][1] = load_pair(
                                reinterpret_cast<const Raw*>(box + swz(rh, be)));
                            read ^= bits(xe[i][0]) ^ bits(xe[i][1]);
                        }
                    }
                    if (h == B::kGroups - 1) {
                        // The box is read: free its slot in both blocks. The
                        // arrive's release (at the block's scope) does not
                        // wait for this warp's shared-memory loads to be
                        // performed before the TMA write it lets in (the
                        // async proxy, maybe from the other block); so the
                        // releasing lanes first store a value computed from
                        // a register of every load of the box, which cannot
                        // issue before those loads have returned. (Without
                        // it, a slot was overwritten under its reads in a
                        // few launches in a hundred.) A load is one
                        // instruction for the whole warp.
                        __syncwarp();
                        if (lane < kCluster) {
                            *sink = read;
                            mbar_arrive_cluster(empty_s + 8 * slot, lane);
                        }
                        __syncwarp();
                    }
                    uint32_t(&ab)[2][4][2] = a[q & 1];
                    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
                    for (int p = 0; p < 2; ++p) {
                        // x^2 rounded, as gdn_plain forms it (never an FMA)
#pragma unroll
                        for (int u = 0; u < 4; ++u) {
                            const float xv = v[u & 1][2 * p + (u >> 1)];
                            split_a(__fmul_rn(xv, xv), ab[p][u][0],
                                    ab[p][u][1]);
                            ahi[p][u] = ab[p][u][0];
                            alo[p][u] = ab[p][u][1];
                        }
                    }
#ifdef GDN_NO_MMA
#pragma unroll
                    for (int u = 0; u < 8; ++u)
                        acc[u] += __uint_as_float(ahi[u / 4][u % 4] ^
                                                  alo[u / 4][u % 4]);
#else
                    wgmma_fence();
#pragma unroll
                    for (int p = 0; p < 2; ++p) {
                        // k-step 2q + p: 256 bytes (two k-chunks) each
                        const uint64_t step = 16 * (2 * q + p);
                        wgmma_tf32(acc, alo[p], desc_hi + step);
                        wgmma_tf32(acc, ahi[p], desc_lo + step);
                        wgmma_tf32(acc, ahi[p], desc_hi + step);
                    }
                    wgmma_commit();
                    wgmma_wait<1>();
                    if (q > 0) keep(a[(q - 1) & 1]);  // its MMAs are done
#endif
                }
            }
            PHASE_ADD(1)
            PHASE_MARK
            wgmma_wait<0>();
            fence_acc(acc);
            keep(a[(kK / 16 - 1) & 1]);
            PHASE_ADD(3)
            PHASE_MARK
            // epilogue: rows t * 64 + rl (and rh), columns n0 + 8 i + 2 tig
            // (+ 1)
            const int r0 = t * kRows + rl;
            if ((t + 1) * kRows <= rows && c == kMaxChannels && pairs) {
                // a whole tile at the full width: no checks
#pragma unroll
                for (int i = 0; i < kN / 8; ++i) {
                    const float2 b = *reinterpret_cast<const float2*>(
                        bs + 8 * i + 2 * tig);
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const float2 xv = widen2(xe[i][h]);
                        const float n_0 = acc[4 * i + 2 * h] + b.x;
                        const float n_1 = acc[4 * i + 2 * h + 1] + b.y;
                        const float s_0 = rsqrt_ftz(n_0), s_1 = rsqrt_ftz(n_1);
                        store2(y + static_cast<long long>(r0 + 8 * h) * c +
                                   n0 + 8 * i + 2 * tig,
                               kInverse ? xv.x * (n_0 * s_0) : xv.x * s_0,
                               kInverse ? xv.y * (n_1 * s_1) : xv.y * s_1);
                    }
                }
            } else {
#pragma unroll
                for (int i = 0; i < kN / 8; ++i) {
                    const int col = n0 + 8 * i + 2 * tig;
                    if (col >= c) continue;
                    const float2 b = *reinterpret_cast<const float2*>(
                        bs + 8 * i + 2 * tig);
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int r = r0 + 8 * h;
                        if (r >= rows) continue;
                        const float2 xv = widen2(xe[i][h]);
                        const float n_0 = acc[4 * i + 2 * h] + b.x;
                        const float n_1 = acc[4 * i + 2 * h + 1] + b.y;
                        const float s_0 = rsqrt_ftz(n_0), s_1 = rsqrt_ftz(n_1);
                        const float o_0 =
                            kInverse ? xv.x * (n_0 * s_0) : xv.x * s_0;
                        const float o_1 =
                            kInverse ? xv.y * (n_1 * s_1) : xv.y * s_1;
                        Raw* yr = y + static_cast<long long>(r) * c + col;
                        if (pairs) {
                            store2(yr, o_0, o_1);
                        } else {
                            yr[0] = narrow(o_0, Raw());
                            if (col + 1 < c) yr[1] = narrow(o_1, Raw());
                        }
                    }
                }
            }
            PHASE_ADD(4)
        }
    }
#ifdef GDN_PHASES
    if (blockIdx.x == 0 && (tid == 0 || tid == 32 * kConsumerWarps)) {
        if (tid == 0) {
            g_phase[1] = ph[1]; g_phase[2] = ph[2]; g_phase[3] = ph[3];
            g_phase[4] = ph[4];
        } else {
            g_phase[0] = ph[0];
        }
    }
#endif
    // no block leaves while its peer may still write to it or arrive on it
    cluster_sync();
}

// Per device and variant: clusters that fit at once (0 until set up). The
// shared-memory limit is raised and the count read once, not per launch.
int g_clusters[kMaxDevices][4];
std::mutex g_setup;

template <typename Raw, bool kInverse>
cudaError_t launch(const Raw* x, const float* gamma, const float* beta,
                   Raw* y, long long rows, int c, cudaStream_t stream) {
    auto kernel = gdn_kernel<Raw, kInverse>;
    constexpr int variant = 2 * (sizeof(Raw) == 2) + kInverse;
    constexpr int smem = Box<Raw>::kSmem;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (g_clusters[dev][variant] == 0) {
        std::lock_guard<std::mutex> lock(g_setup);
        if (g_clusters[dev][variant] == 0) {
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (err != cudaSuccess) return err;
            cudaLaunchConfig_t cfg = {};
            cfg.gridDim = dim3(kCluster, 1, 1);
            cfg.blockDim = dim3(kFwdThreads, 1, 1);
            cfg.dynamicSmemBytes = smem;
            int n = 0;
            err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
            if (err != cudaSuccess) return err;
            if (n <= 0) return cudaErrorInvalidConfiguration;
            g_clusters[dev][variant] = n;
        }
    }
    const long long tiles = (rows + kRows - 1) / kRows;
    const int clusters = static_cast<int>(
        tiles < g_clusters[dev][variant] ? tiles : g_clusters[dev][variant]);

    constexpr int es = static_cast<int>(sizeof(Raw));
    CUtensorMap map = {};
    const bool use_tma = (c * es) % 16 == 0 && c >= Box<Raw>::kCols &&
                         (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    if (use_tma) {
        const CUresult r = encode_rows(&map, x, rows, c, es);
        if (r == CUDA_ERROR_NOT_SUPPORTED) return cudaErrorNotSupported;
        if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
    }
    kernel<<<kCluster * clusters, kFwdThreads, smem, stream>>>(
        map, x, gamma, beta, y, static_cast<int>(rows), c, use_tma ? 1 : 0);
    return cudaGetLastError();
}

template <typename Raw>
int forward(const Raw* x, const float* gamma, const float* beta, Raw* y,
            long long rows, int channels, int inverse, void* stream) {
    if (channels <= 0 || channels > kMaxChannels || rows < 0 ||
        rows > (1LL << 31) - 2 * kRows)
        return static_cast<int>(cudaErrorInvalidValue);
    if (rows == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return static_cast<int>(
        inverse ? launch<Raw, true>(x, gamma, beta, y, rows, channels, s)
                : launch<Raw, false>(x, gamma, beta, y, rows, channels, s));
}

}  // namespace

// x, y: [rows, channels] float32 (epic_gdn_forward) or bf16
// (epic_gdn_forward_bf16), contiguous; gamma [channels, channels] and beta
// [channels] float32; 1 <= channels <= 192. Enqueues on `stream` on the
// current device and does not synchronise. Returns a cudaError_t (0 on
// success).
extern "C" int epic_gdn_forward(const float* x, const float* gamma,
                                const float* beta, float* y, long long rows,
                                int channels, int inverse, void* stream) {
    return forward(x, gamma, beta, y, rows, channels, inverse, stream);
}

extern "C" int epic_gdn_forward_bf16(const void* x, const float* gamma,
                                     const float* beta, void* y,
                                     long long rows, int channels,
                                     int inverse, void* stream) {
    return forward(static_cast<const uint16_t*>(x), gamma, beta,
                   static_cast<uint16_t*>(y), rows, channels, inverse,
                   stream);
}

// Clusters a launch of the variant (bf16, inverse) runs on this device: 0
// before its first launch.
extern "C" int epic_gdn_forward_clusters(int bf16, int inverse) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
    return g_clusters[dev][2 * (bf16 != 0) + (inverse != 0)];
}

#ifdef GDN_PHASES
// Block 0's clocks of the last launch: producer waits for a free slot,
// consumer 0's k-loop (loads, splits, MMA issue; its box waits excluded), its
// waits for a full box, the MMA drain after the loop, its epilogue.
extern "C" int epic_gdn_fwd_phases(long long* out) {
    return static_cast<int>(
        cudaMemcpyFromSymbol(out, g_phase, sizeof(long long) * 5));
}
#endif
