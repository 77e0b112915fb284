// gdn_bwd.cu — backward of fused GDN / inverse GDN for Hopper (sm_90a):
// wgmma 3xTF32 on three products, x brought in by TMA and shared by a
// cluster of four blocks, dgamma and dbeta folded in, float32 or bf16 in
// and out. A plain C interface bound from Python with ctypes
// (epic_tpu_torch/ops/gdn_kernel.py: gdn_backward, gdn_backward_rows).
//
// Replaces the backward half of the JAX package's GDN kernel: the
// closed-form custom_vjp rule `_bwd` of gdn_pallas in
// epic_tpu/ops/pallas_gdn.py:80 (XLA there, not Pallas). Over x and the
// incoming gradient g flattened to [R, C], 1 <= C <= 192:
//     n[r, i]  = beta[i] + sum_j x[r, j]^2 * gamma[j, i]
//   GDN  (y = x n^-1/2):  u = g x n^-3/2,  dx = g n^-1/2 - x (u @ gamma^T)
//   IGDN (y = x n^+1/2):  u = g x n^-1/2,  dx = g n^+1/2 + x (u @ gamma^T)
//   dgamma = -/+ 1/2 (x^2)^T @ u,  dbeta = -/+ 1/2 sum_r u
// x, g and dx are float32 or bf16 (one template each), gamma, beta, u,
// dgamma and dbeta float32. bf16 is widened exactly, everything is computed
// in float32, and dx is rounded once (to nearest even): the bf16 variant
// gives dx bitwise the float32 variant's rounded, and dgamma / dbeta
// bitwise the float32 variant's, so no cast wraps a bf16 call.
//
// What bounds it on the H100. Three products of 2RC^2 (n; u @ gamma^T;
// (x^2)^T @ u), each as three TF32 products for float32 accuracy: 9 x 2RC^2
// operations at the TF32 peak of 495 TFLOP/s, against x and g read and dx
// written (12RC bytes in float32, 6RC in bf16) at 3.35 TB/s. At C = 192 it
// is bound by operations in both types (0.3514 ms at R = 262,144, against
// 0.1803 ms of float32 bytes).
//
// Design, and the choice made at each hard point:
//  - gamma in two orientations. TF32 wgmma takes both operands K-major:
//    product 1 (x^2 @ gamma) wants B[k][n] = gamma[k][n], product 2
//    (u @ gamma^T) B[k][n] = gamma[n][k]. Both orientations' TF32 hi and lo
//    halves are 589,824 B. A cluster of four blocks walks the same 64-row
//    tiles; block rank q owns the output columns 48 q .. 48 q + 47 of both
//    products and holds its 48 columns of both orientations (147,456 B).
//    Each x tile is loaded once from device memory and TMA-multicast to the
//    four blocks (each block issues its share of the boxes).
//  - Product 1 is the forward's: A = x^2 of the tile's rows, squared and
//    split in registers from the x boxes, B = gamma's first orientation
//    (the same K-slot order: a thread's four columns of a 16-column group
//    feed two k-steps). Its epilogue forms u (and g n^-/+1/2, kept in
//    registers for dx) for the block's 48 columns.
//  - u between the blocks. Product 2 contracts over all 192 columns of u,
//    and each block formed 48. Each block writes its u quarter, transposed
//    ([48 columns][64 rows], hi and lo halves), into its own shared memory;
//    product 2 reads its A operand straight from the four blocks' quarters
//    (ld.shared::cluster, 8 bytes: a thread's two rows sit at adjacent K
//    positions, kpos_row), three k-step groups ahead. The signals that a
//    quarter is written and that the peers have read it need a release at
//    the cluster's scope, which compiles to MEMBAR.GPU (a wait for every
//    memory operation of the thread): a warp of the producer warpgroup
//    relays them from local mbarriers, four lanes at once, so that the row
//    warpgroup never executes one.
//  - dgamma contracts over rows: A and B both arrive row-major, that is M-
//    and N-major for it, and TMA does not transpose. So its A (x^2, M = the
//    192 rows of gamma in three m64 tiles) is gathered into registers from
//    the swizzled x boxes, and its B is the u quarter the epilogue already
//    wrote transposed: dgamma[:, 48 q ..] of the tile adds into 72
//    accumulator registers a thread, which every 8 tiles are added to the
//    cluster's partial in device memory and start afresh (the tensor cores
//    round their float32 sums toward zero: kept over a whole launch, the
//    error grew with R).
//  - dbeta: the dgamma warpgroup sums each tile's u quarter per column from
//    shared memory, two threads a column, in K order.
//  - Determinism. dx and u of a row depend only on the row (fixed k order,
//    one accumulator per product). dgamma and dbeta: no atomics; each
//    cluster writes its partial sums ([193][192]: dgamma's rows, then
//    dbeta) to a scratch buffer that the caller allocates, and a second,
//    small kernel sums the partials in cluster order and scales them. The
//    rows a cluster walks depend only on R and the cluster count, and the K
//    order of the tile's rows is the same in both types, so the two types
//    agree bitwise.
//  - Accuracy: 3xTF32 (a_lo*b_hi, a_hi*b_lo, a_hi*b_hi) on every product.
//    gamma's halves are rounded once per block (gdn_common.cuh's split);
//    A's are the value (the MMA reads it truncated) and the exact rest, as
//    is u's transposed copy (hi the value, lo the rest), so every term
//    keeps float32 accuracy; u is signed, so products 2 and 3 may cancel,
//    with an error relative to sum |u_j gamma_ij| and sum |x^2 u|.
//  - Edges: gamma zero-padded to 192 x 192 and beta to 1, so every C runs
//    the same unrolled k-steps; TMA zero-fills rows past R and columns past
//    C; g is read with bounds checks and u is 0 outside; dx and u are
//    stored with bounds checks. A row pitch TMA cannot take (C * size not a
//    multiple of 16 B), C narrower than a box, or x not 16-byte aligned
//    takes the forward's load path: the producer warp's lanes copy each box
//    into the same swizzled layout.
//  - Warp roles: the row warpgroup (warps 0-3) runs products 1 and 2 and
//    both epilogues of each tile; the dgamma warpgroup (warps 4-7) runs
//    product 3 beside it, with its 72 accumulators in registers of its own
//    (in one warpgroup beside the rest they took 255 registers, spilled,
//    and ptxas then waited after every wgmma); the producer warpgroup
//    (warps 8-11) loads x into a ring of 7 box slots (one lane of warp 8
//    issues the TMA loads; a full and an empty mbarrier per slot) and
//    relays the u signals (warp 9). A tile's boxes go back to the ring as
//    soon as both consumer warpgroups have read them (the dgamma
//    warpgroup gathers its x values into registers as the boxes land), so
//    the next tile's boxes load under this one's epilogues and product 2
//    (a release box by box, tried, was no faster). g is kept as stored
//    until epilogue 1,
//    so that its loads' latency runs under product 1. A persistent grid of
//    as many clusters as fit on the card (at most one per tile). ptxas
//    gives each thread 168 registers (a block of three warpgroups); the
//    producer warpgroup hands its registers to the consumers at run time
//    (setmaxnreg), but ptxas does not allocate past 168 in their code, so
//    each consumer warpgroup keeps two wgmma groups in flight.
//
// Shared memory (either type): a ring of 7 boxes of 64 rows x 128 bytes
// (57,344 B), gamma's two orientations' hi and lo halves of 48 columns
// (147,456 B), u's transposed quarter's hi and lo (24,576 B), 20 mbarriers,
// beta's 48 columns, dbeta's half-sums, a scratch word, 1,024 B of
// alignment slack: 231,152 B of the 232,448 a block may use. 384 threads.
//
// Phase clocks, compiled in only with -DGDN_PHASES (tools/gdn_phases.py):
// block 0's first thread of each consumer warpgroup and the producer lane
// sum clock64() deltas. Timing-only copies of that tool: -DGDN_MMA_ONLY
// feeds the MMAs operands made from the step index (no x, box or u loads,
// no splits), -DGDN_NO_MMA issues no MMA; their outputs are not the
// backward's.

#include "gdn_common.cuh"

#include <mutex>

namespace {

constexpr int kRows = 64;                    // rows of a tile (wgmma's M)
constexpr int kK = kMaxChannels;             // K of products 1 and 2
constexpr int kCluster = 4;                  // blocks sharing a tile
constexpr int kN = kMaxChannels / kCluster;  // output columns per block: 48
constexpr int kNGroups = kN / 8;             // their n8-groups: 6
// the row and dgamma warpgroups, and a producer warpgroup (one warp works)
// that hands its registers to them
constexpr int kBwdThreads = 3 * 128;
constexpr int kGammaWords = kN * kK;         // one TF32 half, one orientation
constexpr int kUWords = kN * kRows;          // one half of u's quarter
constexpr uint32_t kUSbo = (kRows / 4) * 128;  // its N-adjacent core matrices
constexpr int kBoxBytes = kRows * kBoxRow;   // 8,192
constexpr int kSlots = 7;                    // boxes in the ring
constexpr int kAlign = 1024;                 // the 128-byte swizzle's atom
constexpr int kPartRows = kMaxChannels + 1;  // a partial: dgamma, then dbeta
// tiles whose dgamma sums stay in the accumulators before they are added to
// the cluster's partial (the tensor cores' float32 sums round toward zero:
// over a launch's hundred tiles and more that error grew to 6e-5 of the
// largest dgamma at R = 262,144)
constexpr int kFlush = 8;
// k-step groups (two k-steps, six wgmmas each) a warpgroup keeps in flight
constexpr int kDepth = 2;
// k-step groups of u that product 2 reads ahead of its MMAs
constexpr int kAhead = 3;
constexpr int kSmem = kAlign + kSlots * kBoxBytes + 16 * kGammaWords +
                      8 * kUWords + 16 * kSlots + 48 + 4 * kN +
                      4 * 2 * kN + 16;
static_assert(kSmem <= 232448, "shared memory");

// The tile row of MMA row g (0..7) of a warp's 8-row group, one order for
// both types (so that a row's K position in dgamma's product, and with it
// the order of dgamma's and dbeta's sums, is the same in both): 0, 6, 2, 4,
// 1, 7, 3, 5. A float32 16-byte load's pass (rows g and g + 1) reads two
// rows whose 128-byte swizzles differ in bit 2, a bf16 8-byte load's (rows
// g .. g + 3) four rows whose swizzles differ in bits 1-2: distinct banks.
__device__ __forceinline__ int tile_row(int g) {
    return (0x53714260u >> (4 * g)) & 7;
}

// Word offset of gamma[n0 + n][k] in a TF32 half laid out as B[k][n] for
// u @ gamma^T: core matrix (n / 8, k / 4), row n % 8, element k % 4
// (k-step k / 8 takes MMA slot k % 8, the natural order).
__device__ __forceinline__ int gamma_t_word(int n, int k) {
    return (n >> 3) * (kSbo / 4) + (k >> 2) * (kLbo / 4) + 4 * (n & 7) +
           (k & 3);
}

// Word offset of u at K position p (a tile row, see kpos_row) and column
// n0 + n in u's transposed quarter, B[k = p][n] of dgamma's product: core
// matrix (n / 8, p / 4), row n % 8, element p % 4.
__device__ __forceinline__ int u_word(int n, int p) {
    return (n >> 3) * (kUSbo / 4) + (p >> 2) * (kLbo / 4) + 4 * (n & 7) +
           (p & 3);
}

// The tile row at K position p of dgamma's product: K position 16 w + 2 g
// + h holds the row of MMA row g + 8 h of warp w of the row warpgroup, so
// that the two rows a thread holds are adjacent words of u's quarter (one
// 8-byte store each, and one 8-byte load each for product 2).
__device__ __forceinline__ int kpos_row(int p) {
    return 16 * (p >> 4) + tile_row((p >> 1) & 7) + 8 * (p & 1);
}

#ifdef GDN_PHASES
__device__ long long g_phase[11];
#define PHASE_DECL long long ph[11] = {}, ph_mark = 0, ph_t0 = clock64();
#define PHASE_MARK ph_mark = clock64();
#define PHASE_ADD(i) ph[i] += clock64() - ph_mark;
#else
#define PHASE_DECL
#define PHASE_MARK
#define PHASE_ADD(i)
#endif

// The same barrier in block `cta` of the cluster, arrived on with a release
// at the cluster's scope: it orders this block's writes of its u quarter
// (made visible to this thread by a named barrier) before the peers' reads.
__device__ __forceinline__ void mbar_arrive_release(uint32_t bar,
                                                    uint32_t cta) {
    asm volatile("{\n.reg .b32 ra;\n"
                 "mapa.shared::cluster.u32 ra, %0, %1;\n"
                 "mbarrier.arrive.release.cluster.shared::cluster.b64 _, "
                 "[ra];\n}"
                 :: "r"(bar), "r"(cta) : "memory");
}

// Wait for a phase of parity `parity`, acquiring at the cluster's scope.
__device__ __forceinline__ void mbar_wait_acquire(uint32_t bar,
                                                  uint32_t parity) {
    uint32_t done;
    do {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.acquire.cluster.shared::cta"
                     ".b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t cta) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(r) : "r"(addr), "r"(cta));
    return r;
}

__device__ __forceinline__ float2 ld_cluster2(uint32_t addr) {
    float2 v;
    asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
                 : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
    return v;
}

// A warpgroup's own barrier (id 1: the row warpgroup, 2: the dgamma one;
// 0 is __syncthreads').
__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, 128;" :: "r"(id) : "memory");
}

// d[64 x 48] += a[64 x 8] (TF32, registers) * b[8 x 48] (TF32, descriptor)
__device__ __forceinline__ void wgmma48(float (&d)[24], const uint32_t (&a)[4],
                                        uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, "
        "%28, p, 1, 1;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The three TF32 products of one k-step into d: a_lo*b_hi, a_hi*b_lo,
// a_hi*b_hi (the small terms first).
__device__ __forceinline__ void mma3(float (&d)[24], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint64_t bhi,
                                     uint64_t blo) {
#ifdef GDN_NO_MMA
    d[0] += __uint_as_float((ahi[0] ^ alo[1]) & 0x3fffffffu) +
            static_cast<float>((bhi ^ blo) & 1);
#else
    wgmma48(d, alo, bhi);
    wgmma48(d, ahi, blo);
    wgmma48(d, ahi, bhi);
#endif
}

// A operands of one k-step from four values (rows gid / gid + 8 x slots
// tig / tig + 4, in MMA register order): [reg][hi, lo].
__device__ __forceinline__ void split4(const float (&v)[4],
                                       uint32_t (&ab)[4][2]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) split_a(v[e], ab[e][0], ab[e][1]);
}

__device__ __forceinline__ void his_los(const uint32_t (&ab)[4][2],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        hi[e] = ab[e][0];
        lo[e] = ab[e][1];
    }
}

// keep() for every group of a ring of A operands, after the wait that
// retires them all
template <int D>
__device__ __forceinline__ void keep_all(const uint32_t (&a)[D][2][4][2]) {
#pragma unroll
    for (int i = 0; i < D; ++i) keep(a[i]);
}

#ifdef GDN_MMA_ONLY
__device__ __forceinline__ float fake(int step, int e) {
    return __uint_as_float(0x3c000000u + step + e);
}
#endif

template <typename Raw, bool kInverse>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kBwdThreads, 1)
gdn_bwd_kernel(const __grid_constant__ CUtensorMap tmap,
               const Raw* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const Raw* __restrict__ g,
               Raw* __restrict__ dx, float* __restrict__ u,
               float* __restrict__ part, int rows, int c, int use_tma) {
    constexpr int kEs = static_cast<int>(sizeof(Raw));
    constexpr int kCols = kBoxRow / kEs;     // box columns: 32 or 64
    constexpr int kCount = kK / kCols;       // boxes per tile: 6 or 3
    constexpr int kGroups = kCols / 16;      // 16-column groups a box
    extern __shared__ __align__(16) uint8_t smem_raw[];
    uint8_t* smem = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1)))
                                & (kAlign - 1));
    uint8_t* ring = smem;
    uint32_t* g1hi = reinterpret_cast<uint32_t*>(smem + kSlots * kBoxBytes);
    uint32_t* g1lo = g1hi + kGammaWords;
    uint32_t* g2hi = g1lo + kGammaWords;
    uint32_t* g2lo = g2hi + kGammaWords;
    float* uhi = reinterpret_cast<float*>(g2lo + kGammaWords);
    float* ulo = uhi + kUWords;
    const uint32_t ring_s = smem_u32(ring);
    const uint32_t full_s = smem_u32(ulo + kUWords);   // kSlots barriers
    const uint32_t empty_s = full_s + 8 * kSlots;      // kSlots barriers
    const uint32_t ufull_s = empty_s + 8 * kSlots;     // u quarters written
    const uint32_t uempty_s = ufull_s + 8;             // u quarters read
    const uint32_t uown_s = uempty_s + 8;              // this block's u
    const uint32_t uread_s = uown_s + 8;               // peers' u read
    const uint32_t xread_s = uread_s + 8;              // boxes read by rows
    const uint32_t xfree_s = xread_s + 8;              // ... and freed
    float* bs = reinterpret_cast<float*>(ulo + kUWords) + 4 * kSlots + 12;
    float* dbs = bs + kN;                              // [2 halves][kN]
    // a word that releasing lanes store to (see the box release)
    volatile uint32_t* sink = reinterpret_cast<uint32_t*>(dbs + 2 * kN);

    const int tid = threadIdx.x;
    const int rank = static_cast<int>(cluster_rank());
    const int n0 = kN * rank;

    // gamma's hi and lo halves in both orientations, columns n0 .. n0 + 47,
    // zero-padded
    for (int e = tid; e < kN * kK; e += kBwdThreads) {
        const int k = e / kN, n = e - k * kN;
        const bool in = k < c && n0 + n < c;
        uint32_t hi, lo;
        split(in ? gamma[k * c + n0 + n] : 0.0f, hi, lo);
        g1hi[gamma_word(n, k)] = hi;
        g1lo[gamma_word(n, k)] = lo;
        split(in ? gamma[(n0 + n) * c + k] : 0.0f, hi, lo);
        g2hi[gamma_t_word(n, k)] = hi;
        g2lo[gamma_t_word(n, k)] = lo;
    }
    if (tid < kN) bs[tid] = n0 + tid < c ? beta[n0 + tid] : 1.0f;
    if (tid == 0) {
        for (int s = 0; s < kSlots; ++s) {
            mbar_init(full_s + 8 * s, use_tma ? 1 : 32);
            mbar_init(empty_s + 8 * s, 4 * kCluster);
        }
        mbar_init(ufull_s, kCluster);
        mbar_init(uempty_s, kCluster + 1);
        mbar_init(uown_s, 1);
        mbar_init(uread_s, 1);
        mbar_init(xread_s, 1);
        mbar_init(xfree_s, 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // gamma was written by threads and is read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    cluster_sync();

    const int ntiles = (rows + kRows - 1) / kRows;
    const int cid = static_cast<int>(cluster_id());
    const int ncl = static_cast<int>(cluster_count());
    const int warp = tid >> 5, lane = tid & 31;
    const int gid = lane >> 2, tig = lane & 3;
    // this cluster's partial sums: dgamma's rows, then dbeta's
    float* pp = part + static_cast<long long>(cid) * kPartRows * kK;
    PHASE_DECL

    if (warp >= 8) {
        // the producer warpgroup: warp 8 loads, box m of the cluster's j-th
        // tile is ring box kCount j + m; warp 9 relays the row warpgroup's
        // signals about u to the cluster
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
        if (warp == 9 && lane < kCluster) {
            // A release at the cluster's scope waits for every memory
            // operation of its thread to be performed (MEMBAR.GPU): done
            // here, by lanes with no stores of their own in flight (one
            // membar for the four, each lane signalling one block), off the
            // row warpgroup's path. The local waits acquire the row
            // warpgroup's writes, which the releases then carry.
            for (int j = 0, t = cid; t < ntiles; ++j, t += ncl) {
                mbar_wait(uown_s, j & 1);
                mbar_arrive_release(ufull_s, lane);
                mbar_wait(uread_s, j & 1);
                mbar_arrive_release(uempty_s, lane);
            }
        }
        uint32_t gb = 0;
        for (int t = cid; warp == 8 && t < ntiles; t += ncl) {
            for (int m = 0; m < kCount; ++m, ++gb) {
                const uint32_t slot = gb % kSlots;
                const uint32_t par = ((gb / kSlots) & 1) ^ 1;
                const uint32_t full = full_s + 8 * slot;
                if (use_tma) {
                    if (lane == 0) {
                        PHASE_MARK
                        mbar_wait(empty_s + 8 * slot, par);
                        PHASE_ADD(0)
                        mbar_expect_tx(full, kBoxBytes);
                        if (m % kCluster == rank)
                            tma_multicast(ring_s + slot * kBoxBytes, &tmap,
                                          kCols * m, kRows * t, full,
                                          (1u << kCluster) - 1);
                    }
                } else {
                    mbar_wait(empty_s + 8 * slot, par);
                    uint8_t* box = ring + slot * kBoxBytes;
                    for (int e = lane; e < kRows * kCols; e += 32) {
                        const int r = e / kCols, cb = e % kCols;
                        const int gr = kRows * t + r, col = kCols * m + cb;
                        *reinterpret_cast<Raw*>(box + swz(r, kEs * cb)) =
                            gr < rows && col < c
                                ? x[static_cast<long long>(gr) * c + col]
                                : Raw(0);
                    }
                    mbar_arrive(full);
                }
            }
        }
    } else if (warp >= 4) {
        // the dgamma warpgroup: product 3, dgamma[64 mt + ..][n0 + ..] +=
        // (x^2)^T @ u over each tile's rows, and dbeta's sums. A (M =
        // gamma's row j, K = the tile's row at K position p) is gathered from
        // the boxes: slots tig and tig + 4 of k-step ks are K positions
        // 8 ks + tig (+ 4), MMA rows gid and gid + 8 columns 64 mt + 16 w +
        // gid (+ 8). B is u's transposed quarter.
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
        const int w = warp - 4, wt = tid - 128;
        const uint64_t duhi = make_desc<kUSbo>(smem_u32(uhi));
        const uint64_t dulo = make_desc<kUSbo>(smem_u32(ulo));
        float acc3[3][24];  // kFlush tiles' sums
#pragma unroll
        for (int mt = 0; mt < 3; ++mt)
#pragma unroll
            for (int q = 0; q < 24; ++q) acc3[mt][q] = 0.0f;
        // dbeta: thread wt < 96 sums K positions 32 (wt / 48) .. + 31 of
        // column n0 + wt % 48, in order
        float dbt = 0.0f;
        const float* dbu = uhi + u_word(wt % kN, 32 * (wt / kN));
        uint32_t a[kDepth][2][4][2];  // A operands of the groups in flight
        for (int j = 0, t = cid; t < ntiles; ++j, t += ncl) {
            const uint32_t g0 = kCount * j;
            PHASE_MARK
            // the tile's boxes have landed: this thread's A values of the
            // whole tile, x^2 of register e of k-step ks of third mt, into
            // registers, so that the boxes can go back to the ring early
#pragma unroll
            for (int m = 0; m < kCount; ++m)
                mbar_wait(full_s + 8 * ((g0 + m) % kSlots),
                          ((g0 + m) / kSlots) & 1);
            float sq[3][kRows / 8][4];
            uint32_t read = 0;  // a bit of every load, for the release
#pragma unroll
            for (int mt = 0; mt < 3; ++mt)
#pragma unroll
                for (int ks = 0; ks < kRows / 8; ++ks)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        // register e: MMA row gid + 8 (e & 1), slot tig +
                        // 4 (e >> 1)
                        const int jj = 64 * mt + 16 * w + gid + 8 * (e & 1);
                        const int r = kpos_row(8 * ks + tig + 4 * (e >> 1));
#ifdef GDN_MMA_ONLY
                        const float xv = fake(ks, e + jj);
                        (void)r;
#else
                        const uint32_t slot = (g0 + jj / kCols) % kSlots;
                        const float xv = widen(*reinterpret_cast<const Raw*>(
                            ring + slot * kBoxBytes +
                            swz(r, kEs * (jj % kCols))));
#endif
                        // x^2 rounded, as gdn_plain forms it
                        sq[mt][ks][e] = __fmul_rn(xv, xv);
                        read ^= __float_as_uint(sq[mt][ks][e]);
                    }
            // the row warpgroup has read the boxes too
            mbar_wait(xread_s, j & 1);
            PHASE_ADD(10)
            PHASE_MARK
            // free the tile's boxes (this block's copies) in the four
            // blocks' rings. The arrive's release (at the block's scope)
            // does not wait for this warp's shared-memory loads before the
            // TMA write it lets in (the async proxy), so the releasing lanes
            // first store a value computed from every load (one instruction
            // for the whole warp each), which cannot issue before they have
            // returned.
            __syncwarp();
            if (lane < kCluster) {
                *sink = read;
#pragma unroll
                for (int m = 0; m < kCount; ++m)
                    mbar_arrive_cluster(empty_s + 8 * ((g0 + m) % kSlots),
                                        lane);
            }
            __syncwarp();
            named_sync(2);
            if (wt == 0) mbar_arrive(xfree_s);
            // this block's u quarter of the tile is written
            mbar_wait(uown_s, j & 1);
#pragma unroll
            for (int mt = 0; mt < 3; ++mt) {
#pragma unroll
                for (int kp = 0; kp < kRows / 16; ++kp) {
                    const int q = 4 * mt + kp;  // the tile's group
                    uint32_t(&ab)[2][4][2] = a[q % kDepth];
                    split4(sq[mt][2 * kp], ab[0]);
                    split4(sq[mt][2 * kp + 1], ab[1]);
                    wgmma_fence();
#pragma unroll
                    for (int p = 0; p < 2; ++p) {
                        const uint64_t step = 16 * (2 * kp + p);
                        uint32_t ahi[4], alo[4];
                        his_los(ab[p], ahi, alo);
                        mma3(acc3[mt], ahi, alo, duhi + step, dulo + step);
                    }
                    wgmma_commit();
                    wgmma_wait<kDepth - 1>();
                    if (q >= kDepth - 1)  // its MMAs are done
                        keep(a[(q - kDepth + 1) % kDepth]);
                }
            }
            // dbeta's sums of the tile while the last MMAs run
            if (wt < 2 * kN) {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const float4 v = *reinterpret_cast<const float4*>(
                        dbu + i * (kLbo / 4));
                    dbt = (((dbt + v.x) + v.y) + v.z) + v.w;
                }
            }
            wgmma_wait<0>();
            keep_all(a);
            // the quarter's reads are done
            named_sync(2);
            if (wt == 0) mbar_arrive(uempty_s);
            PHASE_ADD(5)

            // every kFlush tiles and after the last, add dgamma's sums to
            // the cluster's partial (each thread its own words: the same
            // order at every launch) and start them afresh
            if ((j + 1) % kFlush == 0 || t + ncl >= ntiles) {
#pragma unroll
                for (int mt = 0; mt < 3; ++mt) {
                    fence_acc(acc3[mt]);
#pragma unroll
                    for (int n = 0; n < kNGroups; ++n)
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const int jr = 64 * mt + 16 * w + gid + 8 * h;
                            float2* p = reinterpret_cast<float2*>(
                                pp + jr * kK + n0 + 8 * n + 2 * tig);
                            float2 v = make_float2(acc3[mt][4 * n + 2 * h],
                                                   acc3[mt][4 * n + 2 * h + 1]);
                            if (j >= kFlush) {
                                const float2 o = *p;
                                v = make_float2(o.x + v.x, o.y + v.y);
                            }
                            *p = v;
                            acc3[mt][4 * n + 2 * h] = 0.0f;
                            acc3[mt][4 * n + 2 * h + 1] = 0.0f;
                        }
                }
            }
        }
        // dbeta's partial: the two halves of each column, in order
        if (wt < 2 * kN) dbs[wt] = dbt;
        named_sync(2);
        if (wt < kN) pp[kMaxChannels * kK + n0 + wt] = dbs[wt] + dbs[kN + wt];
    } else {
        // the row warpgroup: product 1, epilogue 1, product 2, epilogue 2
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
        // this thread's two tile rows (MMA rows gid and gid + 8 of the warp)
        // and their K position in u's quarter (rh's is one more)
        const int rl = 16 * warp + tile_row(gid), rh = rl + 8;
        const int pl = 16 * warp + 2 * gid;
        const uint64_t d1hi = make_desc(smem_u32(g1hi));
        const uint64_t d1lo = make_desc(smem_u32(g1lo));
        const uint64_t d2hi = make_desc(smem_u32(g2hi));
        const uint64_t d2lo = make_desc(smem_u32(g2lo));
        // product 2's A: u[rl][j] and u[rh][j] of block j / 48 at its words
        // u_word(j % 48, pl) and one on, a byte address in the cluster's
        // window
        uint32_t ub[kCluster];
#pragma unroll
        for (int q = 0; q < kCluster; ++q) ub[q] = mapa(smem_u32(uhi), q);
        const uint32_t uoff = 4u * static_cast<uint32_t>(u_word(tig, pl));
        const bool pairs_g = (c & 1) == 0 &&
            (reinterpret_cast<uintptr_t>(g) & (2 * kEs - 1)) == 0;
        const bool pairs_dx = (c & 1) == 0 &&
            (reinterpret_cast<uintptr_t>(dx) & (2 * kEs - 1)) == 0;
        const bool pairs_u = (c & 1) == 0 &&
            (reinterpret_cast<uintptr_t>(u) & 7) == 0;

        for (int j = 0, t = cid; t < ntiles; ++j, t += ncl) {
            const uint32_t g0 = kCount * j;
            const long long row_l = static_cast<long long>(t) * kRows + rl;
            const long long row_h = row_l + 8;
            // g at this thread's outputs as stored (0 past R and C), for
            // epilogue 1: widened only there, so that the loads' latency
            // runs under product 1
            typename Pair<Raw>::T gp[kNGroups][2];
#pragma unroll
            for (int n = 0; n < kNGroups; ++n) {
                const int col = n0 + 8 * n + 2 * tig;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const long long row = h ? row_h : row_l;
                    gp[n][h] = typename Pair<Raw>::T();
                    if (row < rows && col < c) {
                        const Raw* p = g + row * c + col;
                        gp[n][h] = pairs_g ? load_pair(p)
                                           : pair_of(p[0], col + 1 < c
                                                               ? p[1]
                                                               : Raw(0));
                    }
                }
            }

            // product 1: n - beta = x^2 @ gamma over the block's columns
            float acc[24];
#pragma unroll
            for (int q = 0; q < 24; ++q) acc[q] = 0.0f;
            uint32_t a[kDepth][2][4][2];  // A operands of the groups in
                                          // flight: [group][k-step][reg][hi,
                                          // lo]
            typename Pair<Raw>::T xe[kNGroups][2];  // x at the outputs
            PHASE_MARK
#pragma unroll
            for (int m = 0; m < kCount; ++m) {
                const uint32_t slot = (g0 + m) % kSlots;
                PHASE_ADD(1)
                PHASE_MARK
                mbar_wait(full_s + 8 * slot, ((g0 + m) / kSlots) & 1);
                PHASE_ADD(2)
                PHASE_MARK
                const uint8_t* box = ring + slot * kBoxBytes;
                uint32_t read = 0;  // a bit of every load of x at the outputs
#pragma unroll
                for (int h = 0; h < kGroups; ++h) {
                    // columns 16 q .. 16 q + 15 of the tile: k-steps 2q, 2q+1
                    const int q = kGroups * m + h;
                    float v[2][4];
#ifdef GDN_MMA_ONLY
                    for (int e = 0; e < 4; ++e)
                        v[0][e] = v[1][e] = fake(q, e);
                    (void)box;
#else
                    const int b = kEs * (16 * h + 4 * tig);
                    load4(reinterpret_cast<const Raw*>(box + swz(rl, b)),
                          v[0]);
                    load4(reinterpret_cast<const Raw*>(box + swz(rh, b)),
                          v[1]);
#endif
#pragma unroll
                    for (int s = 0; s < 2; ++s) {
                        // n8-group 2q + s of the 24: columns of rank
                        // (2q + s) / 6
                        if ((2 * q + s) / kNGroups == rank) {
                            const int i = (2 * q + s) % kNGroups;
#ifdef GDN_MMA_ONLY
                            xe[i][0] = xe[i][1] =
                                typename Pair<Raw>::T();
#else
                            const int be = kEs * (16 * h + 8 * s + 2 * tig);
                            xe[i][0] = load_pair(
                                reinterpret_cast<const Raw*>(box + swz(rl, be)));
                            xe[i][1] = load_pair(
                                reinterpret_cast<const Raw*>(box + swz(rh, be)));
#endif
                            read ^= bits(xe[i][0]) ^ bits(xe[i][1]);
                        }
                    }
                    uint32_t(&ab)[2][4][2] = a[q % kDepth];
#pragma unroll
                    for (int p = 0; p < 2; ++p) {
                        // x^2 rounded, as gdn_plain forms it (never an FMA)
                        float sq[4];
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const float xv = v[e & 1][2 * p + (e >> 1)];
                            sq[e] = __fmul_rn(xv, xv);
                        }
                        split4(sq, ab[p]);
                    }
                    wgmma_fence();
#pragma unroll
                    for (int p = 0; p < 2; ++p) {
                        // k-step 2q + p: 256 bytes (two k-chunks) each
                        const uint64_t step = 16 * (2 * q + p);
                        uint32_t ahi[4], alo[4];
                        his_los(ab[p], ahi, alo);
                        mma3(acc, ahi, alo, d1hi + step, d1lo + step);
                    }
                    wgmma_commit();
                    wgmma_wait<kDepth - 1>();
                    if (q >= kDepth - 1)  // its MMAs are done
                        keep(a[(q - kDepth + 1) % kDepth]);
                }
                if (lane == 0) *sink = read;
            }
            // this warpgroup's reads of the boxes have returned (the sink's
            // value depends on every load of x at the outputs; the A
            // operands' fed the MMAs): the dgamma warpgroup may free them
            named_sync(1);
            if (tid == 0) {
                // (the previous tile's boxes were freed: a phase of xread
                // is never two ahead of its waiter)
                if (j > 0) mbar_wait(xfree_s, (j - 1) & 1);
                mbar_arrive(xread_s);
            }
            wgmma_wait<0>();
            fence_acc(acc);
            keep_all(a);
            PHASE_ADD(1)
            PHASE_MARK

            // every block has read the previous tile's u quarters, and this
            // block's dgamma warpgroup has run its product on this one's
            if (j > 0) mbar_wait_acquire(uempty_s, (j - 1) & 1);
            PHASE_ADD(4)
            PHASE_MARK
            // epilogue 1: u (to the transposed quarter, its hi and lo, and
            // to device memory if asked), dx's first term g n^-/+1/2
            float gv[kNGroups][4];
#pragma unroll
            for (int n = 0; n < kNGroups; ++n) {
                const int cl = 8 * n + 2 * tig;  // the block's column
                const int col = n0 + cl;
                const float2 b = *reinterpret_cast<const float2*>(bs + cl);
                float uu[2][2];  // [row h][column e]
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const long long row = h ? row_h : row_l;
                    const float2 xv = widen2(xe[n][h]);
                    const float2 gw = widen2(gp[n][h]);
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int k = 2 * h + e;
                        const float norm = acc[4 * n + k] + (e ? b.y : b.x);
                        const float rs = rsqrt_ftz(norm);
                        const float gk = e ? gw.y : gw.x;
                        const float xk = e ? xv.y : xv.x;
                        // GDN: u = g x n^-3/2, g n^-1/2; IGDN: u = g x
                        // n^-1/2, g n^1/2 (sqrt as norm * rsqrt)
                        uu[h][e] = row < rows && col + e < c
                                       ? (kInverse ? gk * xk * rs
                                                   : gk * xk * (rs * rs * rs))
                                       : 0.0f;
                        gv[n][k] = kInverse ? gk * (norm * rs) : gk * rs;
                    }
                    if (u != nullptr && row < rows && col < c) {
                        float* p = u + row * c + col;
                        if (pairs_u) {
                            store2(p, uu[h][0], uu[h][1]);
                        } else {
                            p[0] = uu[h][0];
                            if (col + 1 < c) p[1] = uu[h][1];
                        }
                    }
                }
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    // rows rl and rh at K positions pl and pl + 1
                    const int w = u_word(cl + e, pl);
                    uint32_t hi, lo0, lo1;
                    split_a(uu[0][e], hi, lo0);
                    split_a(uu[1][e], hi, lo1);
                    *reinterpret_cast<float2*>(uhi + w) =
                        make_float2(uu[0][e], uu[1][e]);
                    *reinterpret_cast<float2*>(ulo + w) = make_float2(
                        __uint_as_float(lo0), __uint_as_float(lo1));
                }
            }
            // the quarter is read by wgmma (the async proxy) and by the
            // peers' loads: all four warps' writes first
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            named_sync(1);
            if (tid == 0) mbar_arrive(uown_s);
            PHASE_ADD(3)
            PHASE_MARK

            // product 2: (u @ gamma^T)[row][n0 + ..], A = u's 192 columns
            // from the four blocks' quarters, kAhead k-step groups ahead
            mbar_wait_acquire(ufull_s, j & 1);
            PHASE_ADD(6)
            PHASE_MARK
#pragma unroll
            for (int q = 0; q < 24; ++q) acc[q] = 0.0f;
            float nv[kAhead][2][4];  // the next groups' values
            // k-step ks: columns 8 ks + tig (+ 4) of block ks / 6, rows rl
            // and rh (adjacent words)
            auto fetch = [&](float (&v)[2][4], int grp) {
#pragma unroll
                for (int p = 0; p < 2; ++p) {
                    const int ks = 2 * grp + p;
#pragma unroll
                    for (int s = 0; s < 2; ++s) {
#ifdef GDN_MMA_ONLY
                        v[p][2 * s] = v[p][2 * s + 1] = fake(ks, s);
#else
                        const float2 w = ld_cluster2(
                            ub[ks / kNGroups] + uoff +
                            4u * ((ks % kNGroups) * (kUSbo / 4) + 16 * s));
                        v[p][2 * s] = w.x;
                        v[p][2 * s + 1] = w.y;
#endif
                    }
                }
            };
#pragma unroll
            for (int q = 0; q < kAhead; ++q) fetch(nv[q], q);
#pragma unroll
            for (int q = 0; q < kK / 16; ++q) {
                float cv[2][4];
#pragma unroll
                for (int p = 0; p < 2; ++p)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        cv[p][e] = nv[q % kAhead][p][e];
                if (q + kAhead < kK / 16) fetch(nv[q % kAhead], q + kAhead);
                uint32_t(&ab)[2][4][2] = a[q % kDepth];
                split4(cv[0], ab[0]);
                split4(cv[1], ab[1]);
                wgmma_fence();
#pragma unroll
                for (int p = 0; p < 2; ++p) {
                    const uint64_t step = 16 * (2 * q + p);
                    uint32_t ahi[4], alo[4];
                    his_los(ab[p], ahi, alo);
                    mma3(acc, ahi, alo, d2hi + step, d2lo + step);
                }
                wgmma_commit();
                wgmma_wait<kDepth - 1>();
                if (q >= kDepth - 1) keep(a[(q - kDepth + 1) % kDepth]);
            }
            // every u value this block needed has been read (each fed an
            // MMA's operands): the blocks may overwrite their quarters
            named_sync(1);
            if (tid == 0) mbar_arrive(uread_s);
            wgmma_wait<0>();
            fence_acc(acc);
            keep_all(a);
            PHASE_ADD(7)
            PHASE_MARK

            // epilogue 2: dx = first -/+ x (u @ gamma^T)
#pragma unroll
            for (int n = 0; n < kNGroups; ++n) {
                const int col = n0 + 8 * n + 2 * tig;
                if (col >= c) continue;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const long long row = h ? row_h : row_l;
                    if (row >= rows) continue;
                    const float2 xv = widen2(xe[n][h]);
                    const float o0 = kInverse
                        ? gv[n][2 * h] + xv.x * acc[4 * n + 2 * h]
                        : gv[n][2 * h] - xv.x * acc[4 * n + 2 * h];
                    const float o1 = kInverse
                        ? gv[n][2 * h + 1] + xv.y * acc[4 * n + 2 * h + 1]
                        : gv[n][2 * h + 1] - xv.y * acc[4 * n + 2 * h + 1];
                    Raw* p = dx + row * c + col;
                    if (pairs_dx) {
                        store2(p, o0, o1);
                    } else {
                        p[0] = narrow(o0, Raw());
                        if (col + 1 < c) p[1] = narrow(o1, Raw());
                    }
                }
            }
            PHASE_ADD(8)
        }
    }
#ifdef GDN_PHASES
    if (blockIdx.x == 0 && (tid == 0 || tid == 128 || tid == 256)) {
        if (tid == 0) {
            for (int i = 1; i < 9; ++i) g_phase[i] = ph[i];
            g_phase[9] = clock64() - ph_t0;
        } else if (tid == 128) {
            g_phase[5] = ph[5];
            g_phase[10] = ph[10];
        } else {
            g_phase[0] = ph[0];
        }
    }
#endif
    // no block leaves while its peers may still read its u quarter or
    // arrive on its barriers
    cluster_sync();
}

// dgamma[j][i] = scale sum_k part[k][j][i], dbeta[i] = scale sum_k
// part[k][192][i], the partials in cluster order.
__global__ void gdn_bwd_reduce_kernel(const float* __restrict__ part,
                                      int parts, int c, float scale,
                                      float* __restrict__ dgamma,
                                      float* __restrict__ dbeta) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= (c + 1) * c) return;
    const int j = e / c, i = e - j * c;
    const float* p = part + (j < c ? j : kMaxChannels) * kK + i;
    float s = 0.0f;
    for (int k = 0; k < parts; ++k)
        s += p[static_cast<long long>(k) * kPartRows * kK];
    if (j < c)
        dgamma[e] = scale * s;
    else
        dbeta[i] = scale * s;
}

// Per device and variant: clusters that fit at once (0 until set up). The
// shared-memory limit is raised and the count read once, not per launch.
int g_clusters[kMaxDevices][4];
std::mutex g_setup;

template <typename Raw, bool kInverse>
cudaError_t launch(const Raw* x, const float* gamma, const float* beta,
                   const Raw* g, Raw* dx, float* u, float* part,
                   long long part_floats, long long rows, int c, int* parts,
                   cudaStream_t stream) {
    auto kernel = gdn_bwd_kernel<Raw, kInverse>;
    constexpr int variant = 2 * (sizeof(Raw) == 2) + kInverse;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (g_clusters[dev][variant] == 0) {
        std::lock_guard<std::mutex> lock(g_setup);
        if (g_clusters[dev][variant] == 0) {
            err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
            if (err != cudaSuccess) return err;
            cudaLaunchConfig_t cfg = {};
            cfg.gridDim = dim3(kCluster, 1, 1);
            cfg.blockDim = dim3(kBwdThreads, 1, 1);
            cfg.dynamicSmemBytes = kSmem;
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
    if (static_cast<long long>(clusters) * kPartRows * kK > part_floats)
        return cudaErrorInvalidValue;

    constexpr int es = static_cast<int>(sizeof(Raw));
    CUtensorMap map = {};
    const bool use_tma = (c * es) % 16 == 0 && c >= kBoxRow / es &&
                         (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    if (use_tma) {
        const CUresult r = encode_rows(&map, x, rows, c, es);
        if (r == CUDA_ERROR_NOT_SUPPORTED) return cudaErrorNotSupported;
        if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
    }
    kernel<<<kCluster * clusters, kBwdThreads, kSmem, stream>>>(
        map, x, gamma, beta, g, dx, u, part, static_cast<int>(rows), c,
        use_tma ? 1 : 0);
    *parts = clusters;
    return cudaGetLastError();
}

template <typename Raw>
int backward(const Raw* x, const float* gamma, const float* beta,
             const Raw* g, Raw* dx, float* u, float* part,
             long long part_floats, long long rows, int channels,
             int inverse, int* parts, void* stream) {
    *parts = 0;
    if (channels <= 0 || channels > kMaxChannels || rows < 0 ||
        rows > (1LL << 31) - 2 * kRows || part == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    if (rows == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return static_cast<int>(
        inverse ? launch<Raw, true>(x, gamma, beta, g, dx, u, part,
                                    part_floats, rows, channels, parts, s)
                : launch<Raw, false>(x, gamma, beta, g, dx, u, part,
                                     part_floats, rows, channels, parts, s));
}

}  // namespace

// x, g, dx: [rows, channels] float32 (bf16 == 0) or bf16 (bf16 != 0),
// contiguous; gamma [channels, channels] and beta [channels] float32;
// 1 <= channels <= 192. u: [rows, channels] float32, or null (not written).
// part: float32 scratch of part_floats >= clusters x 193 x 192 (clusters
// <= SMs / 4), into which each cluster writes its partial dgamma ([192][192],
// unscaled, zero-padded) and dbeta (row 192); the number of partials goes
// to *parts (0 when rows == 0), for epic_gdn_backward_reduce. Enqueues on
// `stream` on the current device and does not synchronise. Returns a
// cudaError_t (0 on success).
extern "C" int epic_gdn_backward(const void* x, const float* gamma,
                                 const float* beta, const void* g, void* dx,
                                 float* u, float* part, long long part_floats,
                                 long long rows, int channels, int inverse,
                                 int bf16, int* parts, void* stream) {
    if (bf16)
        return backward(static_cast<const uint16_t*>(x), gamma, beta,
                        static_cast<const uint16_t*>(g),
                        static_cast<uint16_t*>(dx), u, part, part_floats,
                        rows, channels, inverse, parts, stream);
    return backward(static_cast<const float*>(x), gamma, beta,
                    static_cast<const float*>(g), static_cast<float*>(dx), u,
                    part, part_floats, rows, channels, inverse, parts,
                    stream);
}

// dgamma ([channels, channels]) and dbeta ([channels]) from `parts` partials
// of epic_gdn_backward, summed in order and scaled by -1/2 (GDN) or +1/2
// (inverse). Enqueues on `stream`; returns a cudaError_t.
extern "C" int epic_gdn_backward_reduce(const float* part, int parts,
                                        int channels, int inverse,
                                        float* dgamma, float* dbeta,
                                        void* stream) {
    if (channels <= 0 || channels > kMaxChannels || parts < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int n = (channels + 1) * channels;
    gdn_bwd_reduce_kernel<<<(n + 255) / 256, 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        part, parts, channels, inverse ? 0.5f : -0.5f, dgamma, dbeta);
    return static_cast<int>(cudaGetLastError());
}

// Clusters a launch of the variant (bf16, inverse) runs on this device: 0
// before its first launch.
extern "C" int epic_gdn_backward_clusters(int bf16, int inverse) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
    return g_clusters[dev][2 * (bf16 != 0) + (inverse != 0)];
}

#ifdef GDN_PHASES
// Block 0's clocks of the last launch: producer waits for a free slot; the
// row warpgroup's product 1 (its box waits excluded), box waits, epilogue
// 1, waits for the peers to free their u quarters; the dgamma warpgroup's
// product 3; the row warpgroup's waits for the peers' u, product 2,
// epilogue 2, its whole run; the dgamma warpgroup's waits for u.
extern "C" int epic_gdn_bwd_phases(long long* out) {
    return static_cast<int>(
        cudaMemcpyFromSymbol(out, g_phase, sizeof(long long) * 11));
}
#endif
