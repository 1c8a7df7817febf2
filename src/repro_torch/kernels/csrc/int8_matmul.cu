// K3 (int8_matmul) and K4 (cache_matmul): matrix products with fp32
// accumulation, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels that share one grid:
//   src/repro/kernels/int8_matmul.py:int8_matmul (K3, behind ops.matmul_q8):
//     out[m, n] = round_to_x_type(scale[n] * sum_k x[m, k] * qw[k, n]),
//     x (M, K) fp32 or bf16, qw (K, N) int8, scale (N,) fp32. The scale is
//     applied once, to the fp32 total; no float copy of the weights is ever
//     written to device memory.
//   src/repro/kernels/cache_matmul.py:cache_matmul (K4, behind ops.matmul):
//     the same with a float w of x's type and no scale.
// One template serves both: K4 is K3 with a bf16 weight, no conversion and
// no scale. int8 values are exact in bf16, and bf16 x bf16 products are
// exact in fp32, so only the order of the sum differs from the TPU kernel.
//
// Three paths; the host picks one from (M, N, K) alone (int8_matmul.py:
// matmul_plan), and takes the masked path for fp32 x or rows that 16-byte
// loads cannot read (a row stride or width that is not a multiple of 16
// bytes, or an unaligned base).
//
// 1. mm_wgmma, large M (an encoder batch or a decoder prefill, M = B x
//    bucket, e.g. 4096): bound by operations (GECToR-base's four 768 x 768
//    products at M = 4096 take 4.9 us at 989 TFLOP/s). One block per
//    (64 * WG) x BN output tile: WG = 2 with BN = 128 (two consumer
//    warpgroups, two blocks an SM) or BN = 192 (one block an SM, where it
//    evens out the grid), or WG = 1 with BN = 64 (products with too few
//    128 x 128 tiles to fill the 132 SMs). A ring of shared-memory stages
//    of BK = 64 (three, four at 64 x 64) is filled by cp.async, zero-filled
//    past the ragged edges; while stage kt is multiplied the next two are
//    in flight. The x tile lies K-major in the 128-byte swizzle that wgmma
//    reads (the A operand); the weight tile lies as it is stored, (K, N)
//    row-major, which is wgmma's MN-major B operand in 64-column swizzle
//    atoms. K4's bf16 weight is copied straight into that layout. K3's
//    int8 tile is loaded into registers two stages ahead (16 bytes a load)
//    and converted to bf16 into the layout (per pair of bytes two prmt and
//    one fma.rn.bf16x2, exact for every int8: i8x4_to_bf16x4 below), once
//    per stage and block, into one of two buffers: stage kt+1 is converted
//    while the tensor cores multiply stage kt. The products are
//    wgmma.mma_async m64nBNk16 (bf16 in, fp32 accumulators in registers),
//    four per stage, waited for within the stage; a second block on the
//    SM fills the gaps. Epilogue: the scale, one rounding to bf16, a
//    staging tile in shared memory, 16-byte stores.
// 2. mm_split, decode M (M <= 64: a decode step's M is the batch width):
//    bound by the weight stream (Qwen2-0.5B's w_in, 896 x 9728 int8, is
//    8.7 MB, 2.6 us at 3.35 TB/s; streaming at that rate needs about 24 KB
//    in flight on every SM). The grid is (column tiles of 32) x (K splits);
//    the split count and slab (whole stages of 128 rows) come from (N, K)
//    alone, never from M, so that at least 2 x 132 blocks stream the
//    weight at Qwen2's w_in and w_down and a row's result does not depend
//    on how many rows come with it. Each of a block's four warps streams
//    its own 32 rows of every stage through a private three-stage
//    cp.async ring (x rows, zero-padded to 16, 32 or 64 and kept in L1 for
//    the SM's other blocks, and the weight rows), so the main loop has no
//    block barrier. The products are mma.sync m16n8k16 with ldmatrix
//    fragments of x; K3 builds the weight fragments in registers from
//    32-bit reads of the int8 rows (columns permuted within a 32-column
//    group, mapped back in the epilogue), K4 reads them with
//    ldmatrix.trans. The warps' partials are added in warp order; with one
//    split that is the output. Otherwise the S splits of a column tile are
//    one thread block cluster (S <= 16): each leaves its fp32 partial in
//    its shared memory, and the blocks read each other's (distributed
//    shared memory) to add them in split order 0..S-1, apply the scale and
//    round once. No float atomics and no round trip through device memory:
//    the result is the same bits on every run, and every row's bits are
//    the same at every width M <= 64.
// 3. mm_masked: fp32 x (CUDA-core FMAs, no TF32; the fp32 reference
//    models) and rows 16-byte loads cannot read. One block per output tile
//    loops over K with element-wise loads, 128 x 128 x 32 (8 warps) where
//    the plan says wgmma and 32 x 32 x 128 (4 warps) where it says split,
//    without splitting K; bf16 x takes mma.sync.
//
// Measured by python3 chip_smoke.py (phases 10 and 14) on an NVIDIA H100;
// PERF.md has the times.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

enum Path { kMasked = 0, kWgmma = 1, kSplit = 2 };

struct Params {
  const void* x;
  const void* w;
  const float* scale;       // K3 only
  void* out;                // (M, N) contiguous, x's type
  int M, N, K;
  long long ldx, ldw;       // row strides in elements (unit inner stride)
  int vec_x, vec_w;         // 1: 16-byte loads of x / w rows are aligned
  int splits, kslab;        // split path: K splits of kslab rows each
};

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(ok ? 16 : 0));
}

// the same, kept in L1 too: for data that other blocks on the SM re-read
__device__ __forceinline__ void cp_async16_l1(void* smem, const void* gmem,
                                              bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's copy groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 (one word, element 0 in the low byte) -> four bf16, exactly.
// A byte q = r - 128 s (r its low 7 bits, s its sign bit): r placed in the
// mantissa of bf16 128 is 128 + r, s placed in the exponent's low bit of
// bf16 -128 is -(128 + 128 s), and their sum, q, is exact in bf16. Two
// prmt build each pair, one fma.rn.bf16x2 (times 1) adds it.
__device__ __forceinline__ uint2 i8x4_to_bf16x4(uint32_t w) {
  const uint32_t r = w & 0x7F7F7F7Fu, s = w & 0x80808080u;
  const uint32_t one = 0x3F803F80u;       // bf16x2 (1, 1)
  uint2 q;
  const uint32_t a0 = __byte_perm(r, 0x43434343u, 0x4140);
  const uint32_t b0 = __byte_perm(s, 0xC3C3C3C3u, 0x4140);
  const uint32_t a1 = __byte_perm(r, 0x43434343u, 0x4342);
  const uint32_t b1 = __byte_perm(s, 0xC3C3C3C3u, 0x4342);
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(q.x) : "r"(a0), "r"(one),
      "r"(b0));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(q.y) : "r"(a1), "r"(one),
      "r"(b1));
  return q;
}

// 16 int8 -> 16 bf16 in order: lo holds elements 0-7, hi 8-15
__device__ __forceinline__ void i8x16_to_bf16(uint4 v, uint4& lo,
                                              uint4& hi) {
  const uint2 a = i8x4_to_bf16x4(v.x), b = i8x4_to_bf16x4(v.y);
  const uint2 c = i8x4_to_bf16x4(v.z), d = i8x4_to_bf16x4(v.w);
  lo = make_uint4(a.x, a.y, b.x, b.y);
  hi = make_uint4(c.x, c.y, d.x, d.y);
}

// ------------------------------------------------------- wgmma (sm_90a)

// A shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading byte offset (K-major: unused; MN-major: the stride
// between 64-element swizzle atoms along N) and stride byte offset (1024:
// the stride between groups of eight 128-byte rows), all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// order this thread's shared-memory writes (st.shared, cp.async) before
// the async proxy's reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from moving accumulator accesses across wgmma
template <int N> __device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N> struct Wgmma;

template <> struct Wgmma<64> {
  // d (64 x 64 fp32, this thread's 32) += A (64 x 16, K-major) *
  // B (16 x 64, MN-major)
  __device__ __forceinline__ static void mma(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<128> {
  // d (64 x 128 fp32, this thread's 64) += A (64 x 16, K-major) *
  // B (16 x 128, MN-major)
  __device__ __forceinline__ static void mma(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<192> {
  __device__ __forceinline__ static void mma(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(da), "l"(db), "r"(1));
  }
};

// ------------------------------------------------------ 1. large M: wgmma

// (64 * WG) x BN output tile, BK = 64: one 128-byte swizzle row of bf16
// per x row. TW: int8 (K3) or bf16 (K4).
template <typename TW, int WG, int BN>
struct WgTile {
  static constexpr int BM = 64 * WG, BK = 64, NT = 128 * WG;
  static constexpr int STAGES = WG == 2 ? 3 : 4;
  static constexpr bool kConvert = std::is_same<TW, int8_t>::value;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;        // bf16, as wgmma reads
  // K4's weight tile rides in the ring; K3's int8 tile goes through
  // registers into one of two converted B tiles
  static constexpr int W_BYTES = kConvert ? 0 : B_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + W_BYTES;
  // 1024 bytes of slack to align the ring to the swizzle's period
  static constexpr int SMEM =
      1024 + STAGES * STAGE_BYTES + (kConvert ? 2 * B_BYTES : 0);
  static constexpr int VW = 16 / static_cast<int>(sizeof(TW));
  static constexpr int CPR = BN / VW;                // 16-byte chunks a row
  static constexpr int RCH = BK * CPR / NT;          // a thread's chunks
  static_assert(BN % 64 == 0 && BN <= 256, "whole swizzle atoms");
  static_assert(BM * 8 % NT == 0 && BK * CPR % NT == 0, "even copies");
  static_assert(A_BYTES % 1024 == 0 && W_BYTES % 1024 == 0, "aligned");
  static_assert(BM * (BN + 8) * 2 <= SMEM - 1024, "staging fits");
};

// byte offset of x row m, 16-byte chunk c (k = 8c..8c+7) in an A tile
__device__ __forceinline__ int sw_a(int m, int c) {
  return m * 128 + ((c ^ (m & 7)) << 4);
}

// byte offset of weight row k, columns n..n+7 (n a multiple of 8) in a
// B tile of BK = 64 rows: 64-column atoms of 64 x 128 bytes
__device__ __forceinline__ int sw_b(int k, int n) {
  return (n >> 6) * (64 * 128) + k * 128 + ((((n & 63) >> 3) ^ (k & 7)) << 4);
}

template <typename TW, int WG, int BN>
__global__ void __launch_bounds__(128 * WG, WG == 1 ? 4 : BN == 128 ? 2 : 1)
    mm_wgmma(Params p) {
  using T = WgTile<TW, WG, BN>;
  constexpr int BM = T::BM, BK = T::BK, NT = T::NT, S = T::STAGES;
  constexpr int NACC = BN / 2;
  constexpr bool kScale = T::kConvert;
  extern __shared__ uint8_t smem_wg[];
  // the swizzle is a function of the address: align the ring to 1024
  const uint32_t raw = smem_u32(smem_wg);
  uint8_t* base = smem_wg + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* conv = base + S * T::STAGE_BYTES;         // K3: two B tiles

  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const TW* w = static_cast<const TW*>(p.w);
  const int KT = (p.K + BK - 1) / BK;

  auto load = [&](int kt, int s) {
    const int k0 = kt * BK;
    uint8_t* as = base + s * T::STAGE_BYTES;
#pragma unroll
    for (int r = 0; r < BM * 8 / NT; ++r) {
      const int i = tid + r * NT, m = i >> 3, c = i & 7;
      const int gm = m0 + m, gk = k0 + c * 8;
      const bool ok = gm < p.M && gk < p.K;
      cp_async16(as + sw_a(m, c), x + (ok ? gm * p.ldx + gk : 0), ok);
    }
    if constexpr (!T::kConvert) {      // K4: straight into wgmma's layout
#pragma unroll
      for (int r = 0; r < T::RCH; ++r) {
        const int i = tid + r * NT, k = i / T::CPR, n = (i % T::CPR) * T::VW;
        const int gk = k0 + k, gn = n0 + n;
        const bool ok = gk < p.K && gn < p.N;
        cp_async16(as + T::A_BYTES + sw_b(k, n),
                   w + (ok ? gk * p.ldw + gn : 0), ok);
      }
    }
  };

  // K3: this thread's int8 chunks of stage kt into registers (zero past
  // the edges), and from registers to bf16 in B tile b
  auto ldg = [&](int kt, uint4* r) {
#pragma unroll
    for (int j = 0; j < T::RCH; ++j) {
      const int i = tid + j * NT, k = i / T::CPR, n = (i % T::CPR) * T::VW;
      const int gk = kt * BK + k, gn = n0 + n;
      r[j] = make_uint4(0u, 0u, 0u, 0u);
      if (kt < KT && gk < p.K && gn < p.N)
        r[j] = __ldg(reinterpret_cast<const uint4*>(w + gk * p.ldw + gn));
    }
  };
  auto convert = [&](const uint4* r, int b) {
    uint8_t* bs = conv + b * T::B_BYTES;
#pragma unroll
    for (int j = 0; j < T::RCH; ++j) {
      const int i = tid + j * NT, k = i / T::CPR, n = (i % T::CPR) * T::VW;
      uint4 lo, hi;
      i8x16_to_bf16(r[j], lo, hi);
      // the two 64-column atoms of a 128-column tile share bank groups:
      // threads in an odd atom store their odd chunk first, so that the 8
      // threads of a quarter warp (one k) hit 8 distinct bank groups
      const bool odd = (n >> 6) & 1;
      *reinterpret_cast<uint4*>(bs + sw_b(k, n + (odd ? 8 : 0))) =
          odd ? hi : lo;
      *reinterpret_cast<uint4*>(bs + sw_b(k, n + (odd ? 0 : 8))) =
          odd ? lo : hi;
    }
  };

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  // K3 keeps the int8 tiles of the next two stages in registers
  uint4 rn[T::RCH], rf[T::RCH];
  if constexpr (T::kConvert) {
    uint4 r0[T::RCH];
    ldg(0, r0);
    ldg(1, rn);
    ldg(2, rf);
    convert(r0, 0);
  }
  // stage 0 in place (K3: converted) for every thread
  cp_async_wait<S - 2>();
  fence_proxy_async();
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % S;
    // slot kt-1's products are done in every warpgroup: refill it
    if (kt + S - 1 < KT) load(kt + S - 1, (kt + S - 1) % S);
    cp_async_commit();
    const uint32_t a0 = smem_u32(base + s * T::STAGE_BYTES) + wg * 64 * 128;
    const uint32_t b0 = smem_u32(T::kConvert
                                     ? conv + (kt & 1) * T::B_BYTES
                                     : base + s * T::STAGE_BYTES + T::A_BYTES);
    fence_acc<NACC>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<BN>::mma(acc, sw128_desc(a0 + kk * 32, 16),
                     sw128_desc(b0 + kk * 16 * 128, BK * 128));
    wgmma_commit();
    // while the tensor cores run stage kt: stage kt+1 lands, and K3
    // converts it into the other B tile and loads stage kt+3
    if (kt + 1 < KT) {
      cp_async_wait<S - 2>();
      if constexpr (T::kConvert) {
        convert(rn, (kt + 1) & 1);
#pragma unroll
        for (int j = 0; j < T::RCH; ++j) rn[j] = rf[j];
        ldg(kt + 3, rf);
      }
      fence_proxy_async();
    }
    wgmma_wait<0>();
    fence_acc<NACC>(acc);
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();                           // the ring becomes staging

  // ---- epilogue: scale, one rounding to bf16, 16-byte stores
  constexpr int SP = BN + 8;                 // staging row pitch
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(base);
  const int lane = tid & 31, wr = (tid >> 5) & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + 2 * (lane & 3);
    float s0 = 1.f, s1 = 1.f;
    if constexpr (kScale) {
      if (n0 + col < p.N) {                  // N % 16 == 0 on this path
        s0 = p.scale[n0 + col];
        s1 = p.scale[n0 + col + 1];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wg * 64 + wr * 16 + (lane >> 2) + 8 * h;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if constexpr (kScale) {
        v0 *= s0;
        v1 *= s1;
      }
      *reinterpret_cast<__nv_bfloat162*>(st + row * SP + col) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  __syncthreads();
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int r = 0; r < BM * BN / 8 / NT; ++r) {
    const int i = tid + r * NT, row = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int gm = m0 + row, gn = n0 + c;
    if (gm < p.M && gn < p.N)
      *reinterpret_cast<uint4*>(out + static_cast<long long>(gm) * p.N + gn) =
          *reinterpret_cast<const uint4*>(st + row * SP + c);
  }
}

// ----------------------------------------------------- 2. decode M: split

// A block: BN output columns, NW warps, each streaming its own RW rows
// of every BK = NW * RW row stage; MP = 16 * MT rows of x (M zero-padded).
template <typename TW, int MT>
struct SplitTile {
  static constexpr int BN = 32, NW = 4, RW = 32, STAGES = 3;
  static constexpr int BK = NW * RW, NT = 32 * NW;
  static constexpr int MP = 16 * MT;
  static constexpr bool kConvert = std::is_same<TW, int8_t>::value;
  // bf16 pitches of 16 bytes past a row, so that the 8 rows of an
  // ldmatrix land on distinct banks: x (MP x RW k) and the weight rows
  static constexpr int XP = RW + 8, P = BN + 8;
  static constexpr int RP = BN + 16;          // int8 rows as loaded
  static constexpr int VW = 16 / static_cast<int>(sizeof(TW));
  static constexpr int CH = BN / VW;          // 16-byte chunks a weight row
  static constexpr int X_BYTES = MP * XP * 2;
  static constexpr int W_BYTES = kConvert ? RW * RP : RW * P * 2;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  static constexpr int WARP_BYTES = STAGES * STAGE_BYTES;
  // the rings, which the warps' partials and then the block's reuse
  static constexpr int PART_BYTES = (NW + 1) * MP * BN * 4;
  static constexpr int SMEM = NW * WARP_BYTES > PART_BYTES
                                  ? NW * WARP_BYTES : PART_BYTES;
  static constexpr int PER = MP * BN / NT;  // outputs a thread sums
  static constexpr int MAX_SPLITS = 16;     // a cluster (non-portable size)
  static_assert(MP * RW / 8 % 32 == 0 && RW * CH % 32 == 0 &&
                    RW % 16 == 0 && BN % 32 == 0,
                "whole chunks a lane, whole 32-column groups");
};

template <typename TW, int MT>
__global__ void __launch_bounds__(SplitTile<TW, MT>::NT) mm_split(Params p) {
  using T = SplitTile<TW, MT>;
  constexpr int MP = T::MP, P = T::P, XP = T::XP, S = T::STAGES;
  constexpr int BN = T::BN, NT = T::NT, PER = T::PER, CH = T::CH;
  constexpr int NW = T::NW, RW = T::RW;
  constexpr bool kScale = T::kConvert;
  extern __shared__ __align__(16) uint8_t smem_sp[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint8_t* wb = smem_sp + warp * T::WARP_BYTES;

  const int n0 = blockIdx.x * BN, split = blockIdx.y;
  const int kbeg = split * p.kslab, kend = min(p.K, kbeg + p.kslab);
  const int nsteps = (kend - kbeg + T::BK - 1) / T::BK;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const TW* w = static_cast<const TW*>(p.w);

  // this warp's rows kbeg + t*BK + warp*RW .. +RW-1 of stage t into slot
  // s; neighbouring lanes take neighbouring chunks of a row, so that one
  // instruction reads whole 32-byte sectors. x goes through L1 as well:
  // the other blocks on the SM read the same rows of x.
  auto load = [&](int t, int s) {
    const int k = kbeg + t * T::BK + warp * RW;
    uint8_t* st = wb + s * T::STAGE_BYTES;
#pragma unroll
    for (int r = 0; r < MP * RW / 8 / 32; ++r) {  // MP rows x RW/8 chunks
      const int i = lane + 32 * r, m = i / (RW / 8), c = i % (RW / 8);
      const int gk = k + c * 8;
      const bool ok = m < p.M && gk < kend;
      cp_async16_l1(st + (m * XP + c * 8) * 2,
                    x + (ok ? m * p.ldx + gk : 0), ok);
    }
#pragma unroll
    for (int r = 0; r < RW * CH / 32; ++r) {  // RW rows x CH chunks
      const int i = lane + 32 * r, row = i / CH, c = i % CH;
      const int gk = k + row, gn = n0 + c * T::VW;
      const bool ok = gk < kend && gn < p.N;
      const TW* src = w + (ok ? gk * p.ldw + gn : 0);
      cp_async16(st + T::X_BYTES +
                     (T::kConvert ? row * T::RP + c * 16 : row * P * 2 + c * 16),
                 src, ok);
    }
  };

  float acc[MT][BN / 8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // K3 builds its B fragments in registers from the int8 rows: lane
  // (g, t) reads the words of columns 4g..4g+3 in rows 2t, 2t+1, 2t+8 and
  // 2t+9, and one byte_perm per row pair and the exact conversion give
  // the bf16 pairs of four n-blocks, n-block j's column g being column
  // 4g + j of the 32 (the epilogue maps them back). K4 reads its bf16
  // rows with ldmatrix.trans.
  auto compute = [&](int s) {
    const uint8_t* st = wb + s * T::STAGE_BYTES;
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st);
    const uint8_t* ws = st + T::X_BYTES;
#pragma unroll
    for (int kk = 0; kk < RW; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], xs + (i * 16 + (lane & 15)) * XP + kk +
                              (lane >> 4) * 8);
#pragma unroll
      for (int c0 = 0; c0 < BN; c0 += 32) {
        uint32_t b0[4], b1[4];
        if constexpr (T::kConvert) {
          const uint8_t* q =
              ws + (kk + 2 * (lane & 3)) * T::RP + c0 + 4 * (lane >> 2);
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(q);
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(q + T::RP);
          const uint32_t w8 =
              *reinterpret_cast<const uint32_t*>(q + 8 * T::RP);
          const uint32_t w9 =
              *reinterpret_cast<const uint32_t*>(q + 9 * T::RP);
          const uint2 l01 = i8x4_to_bf16x4(__byte_perm(w0, w1, 0x5140));
          const uint2 l23 = i8x4_to_bf16x4(__byte_perm(w0, w1, 0x7362));
          const uint2 h01 = i8x4_to_bf16x4(__byte_perm(w8, w9, 0x5140));
          const uint2 h23 = i8x4_to_bf16x4(__byte_perm(w8, w9, 0x7362));
          b0[0] = l01.x; b0[1] = l01.y; b0[2] = l23.x; b0[3] = l23.y;
          b1[0] = h01.x; b1[1] = h01.y; b1[2] = h23.x; b1[3] = h23.y;
        } else {
          const __nv_bfloat16* bs = reinterpret_cast<const __nv_bfloat16*>(ws);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, bs + (kk + (lane & 7) +
                                       ((lane >> 3) & 1) * 8) * P +
                                     c0 + h * 16 + (lane >> 4) * 8);
            b0[2 * h] = b[0]; b1[2 * h] = b[1];
            b0[2 * h + 1] = b[2]; b1[2 * h + 1] = b[3];
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[i][c0 / 8 + j], a[i], b0[j], b1[j]);
      }
    }
  };

#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < nsteps) load(t, t);
    cp_async_commit();
  }
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<S - 2>();
    __syncwarp();              // the warp's stage t is in; t-1 is consumed
    if (t + S - 1 < nsteps) load(t + S - 1, (t + S - 1) % S);
    cp_async_commit();
    compute(t % S);
  }
  cp_async_wait<0>();
  __syncthreads();             // the ring becomes the warps' partials

  // ---- the block's partial: the warps' tiles added in warp order
  float* red = reinterpret_cast<float*>(smem_sp);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = i * 16 + (lane >> 2) + 8 * (e >> 1);
        const int cg = 2 * (lane & 3) + (e & 1);     // column in the block
        const int col = T::kConvert ? (j / 4) * 32 + 4 * cg + j % 4
                                    : j * 8 + cg;
        red[(warp * MP + row) * BN + col] = acc[i][j][e];
      }
  __syncthreads();
  float v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = tid + NT * j;
    v[j] = red[i];
#pragma unroll
    for (int w = 1; w < NW; ++w) v[j] += red[w * MP * BN + i];
  }

  auto store = [&]() {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + NT * j, m = i / BN, n = n0 + i % BN;
      if (m < p.M && n < p.N) {
        float r = v[j];
        if constexpr (kScale) r *= p.scale[n];
        out[static_cast<long long>(m) * p.N + n] = __float2bfloat16_rn(r);
      }
    }
  };
  if (p.splits == 1) {
    store();
    return;
  }

  // ---- the splits of a column tile are one cluster: each leaves its
  // partial in its shared memory, and block r adds outputs r*NT + tid,
  // (r + S)*NT + tid, .. over the cluster in split order 0..S-1
  cg::cluster_group cluster = cg::this_cluster();
  float* mine = red + NW * MP * BN;
#pragma unroll
  for (int j = 0; j < PER; ++j) mine[tid + NT * j] = v[j];
  cluster.sync();
  const int S_ = p.splits, M = p.M;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  for (int i = split * NT + tid; i < M * BN; i += S_ * NT) {
    float pv[T::MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < T::MAX_SPLITS; ++s)     // the loads first, then
      if (s < S_) pv[s] = cluster.map_shared_rank(mine, s)[i];
    float r = pv[0];
#pragma unroll
    for (int s = 1; s < T::MAX_SPLITS; ++s)     // the sum, in split order
      if (s < S_) r += pv[s];
    const int m = i / BN, n = n0 + i % BN;
    if (m < M && n < p.N) {
      if constexpr (kScale) r *= p.scale[n];
      out[static_cast<long long>(m) * p.N + n] = __float2bfloat16_rn(r);
    }
  }
  cluster.sync();          // no block leaves while another reads its partial
}

// -------------------------------------- 3. masked: fp32, unaligned rows

// (BM, BN, BK): the block tile; (WM, WN): a warp's tile on the tensor
// cores; (TM, TN): a thread's tile on the CUDA cores. Both give NT threads.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int WM = WM_, WN = WN_, TM = TM_, TN = TN_;
  static constexpr int NT = 32 * (BM / WM) * (BN / WN);
  static_assert((BM / TM) * (BN / TN) == NT, "FMA and MMA thread counts");
  static_assert(WM % 16 == 0 && WN % 8 == 0 && BK % 16 == 0, "mma shape");
};
using MaskLarge = Tile<128, 128, 32, 64, 32, 8, 8>;
using MaskSmall = Tile<32, 32, 128, 16, 16, 2, 4>;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

template <typename S> __device__ __forceinline__ S from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo,
                                         __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// TX: x's (and the output's and the staged tiles') type; TW: the weight's
// type, int8 for K3 (then the scale is applied) or TX for K4.
template <typename TX, typename TW, class T>
__global__ void __launch_bounds__(T::NT) mm_masked(Params p) {
  using S = TX;
  constexpr bool kScale = std::is_same<TW, int8_t>::value;
  constexpr bool kMma = std::is_same<S, __nv_bfloat16>::value;
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, NT = T::NT;
  constexpr int PAD = 16 / sizeof(S);     // rows stay 16-byte aligned
  constexpr int LDA = BK + PAD, LDB = BN + PAD;
  constexpr int FM = T::WM / 16, FN = T::WN / 8;
  constexpr int NACC = kMma ? FM * FN * 4 : T::TM * T::TN;
  constexpr int VX = 16 / sizeof(TX), VW = 16 / sizeof(TW);
  static_assert(BK % VX == 0 && BN % VW == 0, "vector loads per row");
  __shared__ __align__(16) S As[BM * LDA];
  __shared__ __align__(16) S Bs[BK * LDB];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const TX* x = static_cast<const TX*>(p.x);
  const TW* w = static_cast<const TW*>(p.w);
  const S zero = from_f32<S>(0.f);
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    // ---- stage the x tile (BM x BK) and the weight tile (BK x BN)
    if (p.vec_x) {
      for (int c = tid; c < BM * BK / VX; c += NT) {
        const int m = c / (BK / VX), k = (c % (BK / VX)) * VX;
        const int gm = m0 + m, gk = k0 + k;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);     // zero bits = 0.0
        if (gm < p.M && gk < p.K)
          raw = *reinterpret_cast<const uint4*>(x + gm * p.ldx + gk);
        *reinterpret_cast<uint4*>(As + m * LDA + k) = raw;
      }
    } else {
      for (int c = tid; c < BM * BK; c += NT) {
        const int m = c / BK, k = c % BK, gm = m0 + m, gk = k0 + k;
        As[m * LDA + k] = (gm < p.M && gk < p.K) ? x[gm * p.ldx + gk] : zero;
      }
    }
    if (p.vec_w) {
      for (int c = tid; c < BK * BN / VW; c += NT) {
        const int k = c / (BN / VW), n = (c % (BN / VW)) * VW;
        const int gk = k0 + k, gn = n0 + n;
        __align__(16) S tmp[VW];
        if (gk < p.K && gn < p.N) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(w + gk * p.ldw + gn);
          const TW* v = reinterpret_cast<const TW*>(&raw);
#pragma unroll
          for (int e = 0; e < VW; ++e) tmp[e] = from_f32<S>(to_f32(v[e]));
        } else {
#pragma unroll
          for (int e = 0; e < VW; ++e) tmp[e] = zero;
        }
        uint4* dst = reinterpret_cast<uint4*>(Bs + k * LDB + n);
#pragma unroll
        for (int s = 0; s < VW * static_cast<int>(sizeof(S)) / 16; ++s)
          dst[s] = reinterpret_cast<const uint4*>(tmp)[s];
      }
    } else {
      for (int c = tid; c < BK * BN; c += NT) {
        const int k = c / BN, n = c % BN, gk = k0 + k, gn = n0 + n;
        Bs[k * LDB + n] = (gk < p.K && gn < p.N)
                              ? from_f32<S>(to_f32(w[gk * p.ldw + gn]))
                              : zero;
      }
    }
    __syncthreads();

    // ---- the tile's products
    if constexpr (kMma) {
      const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
      const int wr = (warp / (BN / T::WN)) * T::WM;
      const int wc = (warp % (BN / T::WN)) * T::WN;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[FM][4], b[FN][2];
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          const S* pa = As + (wr + i * 16 + g) * LDA + kk + 2 * t;
          a[i][0] = ld32(pa);
          a[i][1] = ld32(pa + 8 * LDA);
          a[i][2] = ld32(pa + 8);
          a[i][3] = ld32(pa + 8 * LDA + 8);
        }
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          const S* pb = Bs + (kk + 2 * t) * LDB + wc + j * 8 + g;
          b[j][0] = pack(pb[0], pb[LDB]);
          b[j][1] = pack(pb[8 * LDB], pb[9 * LDB]);
        }
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j)
            mma_bf16(&acc[(i * FN + j) * 4], a[i], b[j][0], b[j][1]);
      }
    } else {
      constexpr int RY = BM / T::TM, RX = BN / T::TN;
      const int ty = tid / RX, tx = tid % RX;
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float a[T::TM], b[T::TN];
#pragma unroll
        for (int i = 0; i < T::TM; ++i) a[i] = As[(ty + RY * i) * LDA + kk];
#pragma unroll
        for (int j = 0; j < T::TN; ++j) b[j] = Bs[kk * LDB + tx + RX * j];
#pragma unroll
        for (int i = 0; i < T::TM; ++i)
#pragma unroll
          for (int j = 0; j < T::TN; ++j)
            acc[i * T::TN + j] = fmaf(a[i], b[j], acc[i * T::TN + j]);
      }
    }
    __syncthreads();
  }

  // ---- epilogue: the scale at the fp32 accumulator, one rounding to x's type
  TX* out = static_cast<TX*>(p.out);
  auto put = [&](int r, int c, float v) {
    if (r < p.M && c < p.N) {
      if constexpr (kScale) v *= p.scale[c];
      out[static_cast<long long>(r) * p.N + c] = from_f32<TX>(v);
    }
  };
  if constexpr (kMma) {
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int wr = m0 + (warp / (BN / T::WN)) * T::WM;
    const int wc = n0 + (warp % (BN / T::WN)) * T::WN;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            put(wr + i * 16 + g + 8 * h, wc + j * 8 + 2 * t + e,
                acc[(i * FN + j) * 4 + 2 * h + e]);
  } else {
    constexpr int RY = BM / T::TM, RX = BN / T::TN;
    const int ty = tid / RX, tx = tid % RX;
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
#pragma unroll
      for (int j = 0; j < T::TN; ++j)
        put(m0 + ty + RY * i, n0 + tx + RX * j, acc[i * T::TN + j]);
  }
}

// ----------------------------------------------------------------- launch

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

// above 48 KB of dynamic shared memory a kernel must be allowed it
template <typename K>
int raise_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename TW, int WG, int BN>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  using T = WgTile<TW, WG, BN>;
  // once per instantiation (thread-safe static initialisation), never per
  // launch, so that a captured CUDA graph can replay the launch
  static const int attr = raise_smem(mm_wgmma<TW, WG, BN>, T::SMEM);
  if (attr != 0) return attr;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + T::BM - 1) / T::BM);
  mm_wgmma<TW, WG, BN><<<grid, T::NT, T::SMEM, stream>>>(p);
  return 0;
}

template <typename K>
int allow_split_clusters(K kernel, int bytes) {
  const int rc = raise_smem(kernel, bytes);
  if (rc != 0) return rc;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
}

template <typename TW, int MT>
int launch_split(const Params& p, cudaStream_t stream) {
  using T = SplitTile<TW, MT>;
  static const int attr = allow_split_clusters(mm_split<TW, MT>, T::SMEM);
  if (attr != 0) return attr;
  // the K splits of a column tile form one thread block cluster
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = p.splits;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + T::BN - 1) / T::BN, p.splits);
  cfg.blockDim = dim3(T::NT);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, mm_split<TW, MT>, p));
}

template <typename TX, typename TW>
int dispatch_masked(const Params& p, int bm, int bn, int bk,
                    cudaStream_t stream) {
  if (bm == MaskLarge::BM && bn == MaskLarge::BN && bk == MaskLarge::BK) {
    const dim3 grid((p.N + 127) / 128, (p.M + 127) / 128);
    mm_masked<TX, TW, MaskLarge><<<grid, MaskLarge::NT, 0, stream>>>(p);
  } else if (bm == MaskSmall::BM && bn == MaskSmall::BN &&
             bk == MaskSmall::BK) {
    const dim3 grid((p.N + 31) / 32, (p.M + 31) / 32);
    mm_masked<TX, TW, MaskSmall><<<grid, MaskSmall::NT, 0, stream>>>(p);
  } else {
    return kInvalid;
  }
  return 0;
}

// bf16 x; TW = int8 (K3) or bf16 (K4)
template <typename TW>
int dispatch_bf16(const Params& p, int path, int bm, int bn, int bk,
                  cudaStream_t stream) {
  if (path == kMasked)
    return dispatch_masked<__nv_bfloat16, TW>(p, bm, bn, bk, stream);
  if (!p.vec_x || !p.vec_w) return kInvalid;   // 16-byte copies only
  if (path == kWgmma) {
    if (bm == 128 && bn == 128 && bk == 64)
      return launch_wgmma<TW, 2, 128>(p, stream);
    if (bm == 128 && bn == 192 && bk == 64)
      return launch_wgmma<TW, 2, 192>(p, stream);
    if (bm == 64 && bn == 64 && bk == 64)
      return launch_wgmma<TW, 1, 64>(p, stream);
    return kInvalid;
  }
  if (path != kSplit || bm != 64 || bn != SplitTile<TW, 1>::BN ||
      bk != SplitTile<TW, 1>::BK || p.M > 64 ||
      p.kslab < SplitTile<TW, 1>::BK || p.kslab % SplitTile<TW, 1>::BK ||
      p.splits != (p.K + p.kslab - 1) / p.kslab ||
      p.splits > SplitTile<TW, 1>::MAX_SPLITS)
    return kInvalid;
  if (p.M <= 16) return launch_split<TW, 1>(p, stream);
  if (p.M <= 32) return launch_split<TW, 2>(p, stream);
  return launch_split<TW, 4>(p, stream);
}

Params make_params(const void* x, const void* w, const void* scale,
                   void* out, int M, int N, int K, long long ldx,
                   long long ldw, int splits, int kslab, int vec_x,
                   int vec_w) {
  Params p;
  p.x = x; p.w = w; p.scale = static_cast<const float*>(scale); p.out = out;
  p.M = M; p.N = N; p.K = K; p.ldx = ldx; p.ldw = ldw;
  p.vec_x = vec_x; p.vec_w = vec_w; p.splits = splits; p.kslab = kslab;
  return p;
}

bool bad_shape(int M, int N, int K) {
  return M < 1 || N < 1 || K < 1 || (M + 31) / 32 > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and the output). qw is int8 (K, N)
// with row stride ldw, scale fp32 (N,), x (M, K) with row stride ldx; the
// output is (M, N) contiguous. path: 0 masked, 1 wgmma, 2 split, with
// (bm, bn, bk) one of its built tiles; the split path takes `splits` (at
// most 16) K slabs of `kslab` rows. fp32 x takes the masked path only.
// Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int int8_matmul_fwd(const void* x, const void* qw,
                               const void* scale, void* out, int dtype,
                               int M, int N, int K, long long ldx,
                               long long ldw, int path, int bm, int bn,
                               int bk, int splits, int kslab, int vec_x,
                               int vec_w, void* stream) {
  if (bad_shape(M, N, K)) return kInvalid;
  const Params p = make_params(x, qw, scale, out, M, N, K, ldx, ldw, splits,
                               kslab, vec_x, vec_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0 && path == kMasked)
    rc = dispatch_masked<float, int8_t>(p, bm, bn, bk, st);
  else if (dtype == 1) rc = dispatch_bf16<int8_t>(p, path, bm, bn, bk, st);
  else rc = kInvalid;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The same for a float w of x's type (K4): no scale.
extern "C" int cache_matmul_fwd(const void* x, const void* w, void* out,
                                int dtype, int M, int N, int K,
                                long long ldx, long long ldw, int path,
                                int bm, int bn, int bk, int splits,
                                int kslab, int vec_x, int vec_w,
                                void* stream) {
  if (bad_shape(M, N, K)) return kInvalid;
  const Params p = make_params(x, w, nullptr, out, M, N, K, ldx, ldw, splits,
                               kslab, vec_x, vec_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0 && path == kMasked)
    rc = dispatch_masked<float, float>(p, bm, bn, bk, st);
  else if (dtype == 1)
    rc = dispatch_bf16<__nv_bfloat16>(p, path, bm, bn, bk, st);
  else rc = kInvalid;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of one block of the built kernel (path, tile) for bf16 x
// with an int8 (w_int8 = 1) or bf16 weight, or fp32 x on the masked path
// (dtype 0); for the split path bm is the padded row count (16, 32 or 64).
// -1 for a tile that is not built. The wrapper's smem_bytes mirrors it.
extern "C" int int8_matmul_smem(int path, int bm, int bn, int bk, int dtype,
                                int w_int8) {
  if (path == kMasked) {
    const int isz = dtype == 0 ? 4 : 2, pad = 16 / isz;
    const bool built = (bm == 128 && bn == 128 && bk == 32) ||
                       (bm == 32 && bn == 32 && bk == 128);
    return built ? (bm * (bk + pad) + bk * (bn + pad)) * isz : -1;
  }
  if (dtype != 1) return -1;
  if (path == kWgmma && bk == 64) {
    if (bm == 128 && bn == 128)
      return w_int8 ? WgTile<int8_t, 2, 128>::SMEM
                    : WgTile<__nv_bfloat16, 2, 128>::SMEM;
    if (bm == 128 && bn == 192)
      return w_int8 ? WgTile<int8_t, 2, 192>::SMEM
                    : WgTile<__nv_bfloat16, 2, 192>::SMEM;
    if (bm == 64 && bn == 64)
      return w_int8 ? WgTile<int8_t, 1, 64>::SMEM
                    : WgTile<__nv_bfloat16, 1, 64>::SMEM;
  }
  if (path == kSplit && bn == SplitTile<int8_t, 1>::BN &&
      bk == SplitTile<int8_t, 1>::BK) {
    if (bm == 16)
      return w_int8 ? SplitTile<int8_t, 1>::SMEM
                    : SplitTile<__nv_bfloat16, 1>::SMEM;
    if (bm == 32)
      return w_int8 ? SplitTile<int8_t, 2>::SMEM
                    : SplitTile<__nv_bfloat16, 2>::SMEM;
    if (bm == 64)
      return w_int8 ? SplitTile<int8_t, 4>::SMEM
                    : SplitTile<__nv_bfloat16, 4>::SMEM;
  }
  return -1;
}
