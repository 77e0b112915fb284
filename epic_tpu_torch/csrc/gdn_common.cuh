// gdn_common.cuh — what the GDN kernels for Hopper (sm_90a) share: gdn.cu
// (forward) and gdn_bwd.cu (backward) each include it once. Both read x in
// TMA boxes of 64 rows x 128 bytes laid out with the 128-byte swizzle,
// keep gamma's TF32 halves in shared memory in wgmma's K-major core-matrix
// layout, run wgmma 3xTF32 with A from registers, and take float32 or bf16
// rows. So the pieces live here once: the 3xTF32 operand splits, the
// mbarrier, cluster and TMA primitives, the wgmma fences and descriptor,
// the bf16 loads, widening and rounding, and the host's tensor-map encoder.
// Everything has internal linkage, so each source's library keeps its own
// copy of the per-device state.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxChannels = 192;
constexpr int kMaxDevices = 64;
constexpr int kBoxRow = 128;                 // bytes of a TMA box row
// gamma's halves: core matrices (8 rows of N x 16 bytes of K), K-adjacent
// ones 128 B apart (LBO), N-adjacent ones a whole K row of them apart (SBO)
constexpr uint32_t kLbo = 128;
constexpr uint32_t kSbo = (kMaxChannels / 4) * 128;

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

// A's operands: v = hi + lo with hi the value itself (the MMA reads only the
// top 19 bits of a TF32 register: v truncated) and lo = v - (v with its 13
// low bits cleared), exact; two operations instead of a rounded split's
// five.
__device__ __forceinline__ void split_a(float v, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(v);
    lo = __float_as_uint(v - __uint_as_float(hi & 0xffffe000u));
}

// Byte offset of byte b of row r in a box as TMA's 128-byte swizzle lays
// it out: the 16-byte chunk index XOR the row's index within its 8 rows.
__host__ __device__ constexpr int swz(int r, int b) {
    return r * kBoxRow + (((b >> 4) ^ (r & 7)) << 4) + (b & 15);
}

// Word offset of gamma[k][n0 + n] in a TF32 half laid out as B[k][n] for
// the product x^2 @ gamma: core matrix (n / 8, k-chunk h), row n % 8,
// element tq. k = 16 mm + 4 tq + 2 p + s sits in k-step 2 mm + p, MMA slot
// tq + 4 s (a thread's four columns of a 16-column group feed two k-steps),
// so chunk h = 2 (2 mm + p) + s.
__device__ __forceinline__ int gamma_word(int n, int k) {
    const int mm = k >> 4, tq = (k >> 2) & 3, p = (k >> 1) & 1, s = k & 1;
    const int h = 2 * (2 * mm + p) + s;
    return (n >> 3) * (kSbo / 4) + h * (kLbo / 4) + 4 * (n & 7) + tq;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
    return r;
}

__device__ __forceinline__ uint32_t cluster_count() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
    return r;
}

__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release;\n"
                 "barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// Arrive on the barrier at the same offset in block `cta` of the cluster.
// Release at the block's scope, as CUTLASS's ClusterBarrier does: what it
// orders is this thread's reads of its own shared memory, before the TMA
// write that the arrival lets in. A cluster-scope release would also wait
// for the previous tile's stores to device memory, every box.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
    asm volatile("{\n.reg .b32 ra;\n"
                 "mapa.shared::cluster.u32 ra, %0, %1;\n"
                 "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}"
                 :: "r"(bar), "r"(cta) : "memory");
}

// One box of the tensor map at (column c0, row r0) into `dst` of every
// block in `mask`, completing bytes on the barrier at `bar` in each.
__device__ __forceinline__ void tma_multicast(uint32_t dst,
                                              const CUtensorMap* map,
                                              int c0, int r0, uint32_t bar,
                                              uint16_t mask) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0),
           "r"(bar), "h"(mask)
        : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulators above a wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// A use of a 16-column group's A operands after the wait that retires its
// MMAs: their registers stay allocated until the tensor cores have read
// them, whatever the register allocator would otherwise reuse them for.
__device__ __forceinline__ void keep(const uint32_t (&a)[2][4][2]) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
        asm volatile("" :: "r"(a[i / 8][i % 4][(i / 4) % 2]));
}

// Shared-memory matrix descriptor, no swizzle: K-adjacent core matrices
// kLbo bytes apart, N-adjacent ones `Sbo` bytes apart.
template <uint32_t Sbo = kSbo>
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
    return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(kLbo >> 4) << 16) |
           (static_cast<uint64_t>(Sbo >> 4) << 32);
}

// Element types: float32, or bf16 held as its 16 bits (uint16_t). Four
// consecutive elements of a box row, widened (16- or 8-byte aligned).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const uint16_t* p, float (&v)[4]) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// One element, widened.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// Two consecutive elements as stored (a bf16 pair in one register), and
// widened.
template <typename Raw> struct Pair { using T = float2; };
template <> struct Pair<uint16_t> { using T = uint32_t; };
__device__ __forceinline__ float2 load_pair(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ uint32_t load_pair(const uint16_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}
// Two elements as one stored pair.
__device__ __forceinline__ float2 pair_of(float a, float b) {
    return make_float2(a, b);
}
__device__ __forceinline__ uint32_t pair_of(uint16_t a, uint16_t b) {
    return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 16);
}
__device__ __forceinline__ uint32_t bits(float2 v) {
    return __float_as_uint(v.x);
}
__device__ __forceinline__ uint32_t bits(uint32_t q) { return q; }
__device__ __forceinline__ float2 widen2(float2 v) { return v; }
__device__ __forceinline__ float2 widen2(uint32_t q) {
    return make_float2(__uint_as_float(q << 16),
                       __uint_as_float(q & 0xffff0000u));
}

// 1/sqrt(v) for a normal v (norm >= beta > 0): the MUFU result, without
// rsqrtf's scaling of denormal inputs.
__device__ __forceinline__ float rsqrt_ftz(float v) {
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
    return r;
}

// float32 to the element type: bf16 rounded to nearest even.
__device__ __forceinline__ float narrow(float v, float) { return v; }
__device__ __forceinline__ uint16_t narrow(float v, uint16_t) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(uint16_t* p, float a, float b) {
    *reinterpret_cast<uint32_t*>(p) =
        static_cast<uint32_t>(narrow(a, uint16_t())) |
        (static_cast<uint32_t>(narrow(b, uint16_t())) << 16);
}

// cuTensorMapEncodeTiled, reached through the runtime so that nothing but
// cudart is linked
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = []() -> EncodeTiled {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                             12000, cudaEnableDefault,
                                             &q) != cudaSuccess)
            return nullptr;
#else
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                    cudaEnableDefault, &q) != cudaSuccess)
            return nullptr;
#endif
        return q == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p) : nullptr;
    }();
    return fn;
}

// A 2-D tensor map of x ([rows, c] of `es`-byte elements, float32 or bf16)
// in boxes of 64 rows x 128 bytes, 128-byte swizzle, zero-filled past the
// edges. Returns a CUresult.
inline CUresult encode_rows(CUtensorMap* map, const void* x, long long rows,
                            int c, int es) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return CUDA_ERROR_NOT_SUPPORTED;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(c),
                                static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(c) * es};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBoxRow / es), 64};
    const cuuint32_t unit[2] = {1, 1};
    return encode(map, es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  2, const_cast<void*>(x), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace
