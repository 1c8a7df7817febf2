// K3 (int8_matmul) and K4 (cache_matmul): tiled matrix products with fp32
// accumulation, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels that share one grid:
//   src/repro/kernels/int8_matmul.py:int8_matmul (K3, behind ops.matmul_q8):
//     out[m, n] = round_to_x_type(scale[n] * sum_k x[m, k] * qw[k, n]),
//     x (M, K) fp32 or bf16, qw (K, N) int8, scale (N,) fp32. The scale is
//     applied once, at the fp32 accumulator; no float copy of the weights is
//     ever written.
//   src/repro/kernels/cache_matmul.py:cache_matmul (K4, behind ops.matmul):
//     the same with a float w of x's type and no scale.
//
// Design. One thread block per (BM x BN) output tile loops over K in BK
// steps: the loop inside the block replaces the TPU's sequential grid axis
// that carries the accumulator. Each step stages the x tile and the weight
// tile in shared memory; an int8 weight is converted to x's type as it is
// staged (|q| <= 127 is exact in bf16 and in fp32). For bf16 x the products
// run on the tensor cores, mma.sync m16n8k16 bf16 with fp32 accumulators in
// registers: bf16 x bf16 products are exact in fp32, so only the order of
// the sum differs from the Pallas kernel. For fp32 x they are fp32 FMAs on
// the CUDA cores (no TF32). Loads are 16 bytes a thread where the wrapper
// finds the rows aligned and whole; otherwise element by element. The
// kernel masks ragged M, N and K itself (the TPU wrapper pads to multiples
// of 128). Two tiles are built: 128 x 128 x 32 (8 warps) for products with
// enough output tiles to fill the card, and 32 x 32 x 128 (4 warps) for
// small M (a decode step's M is the batch), where the grid is N / 32 blocks.
//
// Bound. At a decode step (M = 32) the product is bound by the weight
// stream: Qwen2-0.5B's 357.8 MB of int8 weights a step take 0.107 ms at
// 3.35 TB/s, half the bf16 weights' time. At a GECToR-base batch (M = 4096)
// it is bound by operations: 0.70 ms at 989 TFLOP/s for 12 layers. This
// first version has no copy pipelining (cp.async or TMA) and no wgmma, and
// at small M its grid of N / 32 blocks leaves most of the 132 SMs idle for
// N = 128 or 896; splitting K would fill them but changes the order of the
// sum, which is later work. PERF.md has its times.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

struct Params {
  const void* x;
  const void* w;
  const float* scale;       // K3 only
  void* out;                // (M, N) contiguous, x's type
  int M, N, K;
  long long ldx, ldw;       // row strides in elements (unit inner stride)
  int vec_x, vec_w;         // 1: 16-byte loads of x / w rows are aligned
};

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
using Large = Tile<128, 128, 32, 64, 32, 8, 8>;
using Small = Tile<32, 32, 128, 16, 16, 2, 4>;

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

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// TX: x's (and the output's and the staged tiles') type; TW: the weight's
// type, int8 for K3 (then the scale is applied) or TX for K4.
template <typename TX, typename TW, class T>
__global__ void __launch_bounds__(T::NT) matmul_kernel(Params p) {
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
          for (int j = 0; j < FN; ++j) mma_bf16(&acc[(i * FN + j) * 4], a[i], b[j]);
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

template <typename TX, typename TW, class T>
void launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.N + T::BN - 1) / T::BN, (p.M + T::BM - 1) / T::BM);
  matmul_kernel<TX, TW, T><<<grid, T::NT, 0, stream>>>(p);
}

template <typename TX, typename TW>
int dispatch(const Params& p, int bm, int bn, int bk, cudaStream_t stream) {
  if (bm == Large::BM && bn == Large::BN && bk == Large::BK)
    launch<TX, TW, Large>(p, stream);
  else if (bm == Small::BM && bn == Small::BN && bk == Small::BK)
    launch<TX, TW, Small>(p, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

Params make_params(const void* x, const void* w, const void* scale,
                   void* out, int M, int N, int K, long long ldx,
                   long long ldw, int vec_x, int vec_w) {
  Params p;
  p.x = x; p.w = w; p.scale = static_cast<const float*>(scale); p.out = out;
  p.M = M; p.N = N; p.K = K; p.ldx = ldx; p.ldw = ldw;
  p.vec_x = vec_x; p.vec_w = vec_w;
  return p;
}

bool bad_shape(int M, int N, int K) {
  return M < 1 || N < 1 || K < 1 || (M + Small::BM - 1) / Small::BM > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and the output). qw is int8 (K, N)
// with row stride ldw, scale fp32 (N,), x (M, K) with row stride ldx; the
// output is (M, N) contiguous. (bm, bn, bk) is one of the built tiles.
// Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int int8_matmul_fwd(const void* x, const void* qw,
                               const void* scale, void* out, int dtype,
                               int M, int N, int K, long long ldx,
                               long long ldw, int bm, int bn, int bk,
                               int vec_x, int vec_w, void* stream) {
  if (bad_shape(M, N, K)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(x, qw, scale, out, M, N, K, ldx, ldw, vec_x,
                               vec_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) rc = dispatch<float, int8_t>(p, bm, bn, bk, st);
  else if (dtype == 1) rc = dispatch<__nv_bfloat16, int8_t>(p, bm, bn, bk, st);
  else rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The same for a float w of x's type (K4): no scale.
extern "C" int cache_matmul_fwd(const void* x, const void* w, void* out,
                                int dtype, int M, int N, int K,
                                long long ldx, long long ldw, int bm, int bn,
                                int bk, int vec_x, int vec_w, void* stream) {
  if (bad_shape(M, N, K)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(x, w, nullptr, out, M, N, K, ldx, ldw, vec_x,
                               vec_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) rc = dispatch<float, float>(p, bm, bn, bk, st);
  else if (dtype == 1)
    rc = dispatch<__nv_bfloat16, __nv_bfloat16>(p, bm, bn, bk, st);
  else rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
