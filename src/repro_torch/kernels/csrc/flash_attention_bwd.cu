// K1's backward: dQ, dK and dV of block-wise attention for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package trains by differentiating jnp
// attention (naive_attention, or chunked_attention past 2048 positions;
// src/repro/models/attention.py:255), and its Pallas K1
// (src/repro/kernels/flash_attention.py) has no custom_vjp. The port's
// models run K1 (csrc/flash_attention.cu) at that site, a ctypes launch
// that autograd cannot see through, so kernels/ops.py pairs it with this
// backward in one torch.autograd.Function. It is the gradient of K1's
// function, masks included: causal, sliding window, logit softcap (the
// chain rule through c tanh(x / c) is 1 - (s / c)^2), grouped-query heads
// (dK and dV summed over the G query heads of a kv head) and kv_len.
//
// Inputs q, out, dout (B, Sq, Hq, D), k, v (B, Skv, Hkv, D), contiguous, in
// one type (fp32 or bf16), and the forward's row log-sum-exps lse
// (B, Hq, Sq) fp32 (row_lse in csrc/flash_attention.cu). Outputs dq, dk, dv
// in the input type; every sum is fp32. D in {64, 128, 256}. With P_ij =
// exp(s_ij - lse_i) recomputed from the scores, three launches:
//   1. flash_bwd_dot: delta_i = rowsum(dout_i * out_i), one warp a row;
//   2. flash_bwd_dkdv: one block per (kv tile, b * Hkv + kv head). It keeps
//      its K and V tile in shared memory and dK, dV in registers, and walks
//      the G query heads of its kv head and, for each, the q tiles whose
//      live range holds the tile, 16 query rows at a time: S = Q K^T and
//      dP = dO V^T, then dV += P^T dO and dK += dS^T Q with
//      dS = P (dP - delta). No atomics: each block owns its dK and dV rows,
//      so the result does not depend on the order blocks run in;
//   3. flash_bwd_dq: one block per (rows of a q tile, b * Hq + head) over
//      the tile's live kv tiles, dQ += dS K.
// The tiles are the forward's (bq, bk), and a kv tile outside a q tile's
// live range [lo, hi] (flash_attention.py:_lo_block/_hi_block) is skipped
// exactly, as in the forward: kernel 3 visits live_block_counts tiles per q
// tile and kernel 2 the same pairs from the kv side, both counted. A row
// with no live column (its forward output is the mean of the values of the
// tiles it visited, all scored -1e30 and weighted 1) scores those columns 0
// here, so that P = exp(0 - log l) = 1 / l gives that mean's gradient to V,
// and none to Q or K. Tiles past the last live one (kv_len, causal) still
// write dK = dV = 0.
//
// Threads own slices of a row: in kernel 2, TPJ = 256 / bk threads share a
// kv row, each holding D / TPJ of its dK and dV; in kernel 3, 4 threads
// (8 at D = 256) share a query row. A score is the partial dot products
// summed with warp shuffles. Everything runs on the CUDA cores in fp32; the
// tensor cores, as the forward's bf16 kernel uses them, are later work.
//
// Bound. The function reads q, k, v, out, dout and lse once and writes dq,
// dk and dv once, and does five products of the forward's size (S, dP, dV,
// dK, dQ: 10 B Hq pairs D operations). At Qwen2-0.5B's training shape
// (B = 8, S = 512, 14 query heads over 2 kv heads of 64, causal, bf16) that
// is 33.8 MB, 0.0101 ms at 3.35 TB/s, against 9.4 GFLOP, 0.0095 ms at the
// bf16 tensor cores' 989 TFLOP/s: bound by memory. This kernel recomputes
// S and dP in both kernels 2 and 3 and runs on the CUDA cores, so it is far
// from that bound; PERF.md keeps its times from chip_smoke.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int NT = 256;         // threads of the dK/dV and dQ kernels
constexpr int QC = 16;          // query rows a dK/dV step takes

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;             // (B, Hq, Sq)
  float* delta;                 // (B, Hq, Sq), written by kernel 1
  void* dq;
  void* dk;
  void* dv;
  int* kv_visits;               // (B * Hq, n_kv_all): q tiles per kv tile
  int* q_visits;                // (B * Hq, n_q): kv tiles per q tile
  int B, Hq, Hkv, Sq, Skv, kv_len;
  int causal, window;           // window <= 0: no window
  float softcap, scale;         // softcap <= 0: no softcap
  int bq, bk;
  int n_kv, n_q, n_kv_all;      // live kv tiles, q tiles, kv tiles over Skv
};

// ------------------------------------------------------------ helpers

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void fma4(float4& acc, float s, float4 x) {
  acc.x = fmaf(s, x.x, acc.x);
  acc.y = fmaf(s, x.y, acc.y);
  acc.z = fmaf(s, x.z, acc.z);
  acc.w = fmaf(s, x.w, acc.w);
}

// element offset of row s, head h of a contiguous (B, S, H, D) tensor
__device__ __forceinline__ long long row_off(int b, int s, int h, int S,
                                             int H, int D) {
  return ((static_cast<long long>(b) * S + s) * H + h) * D;
}

// live kv tiles [lo, hi] of q tile qi, as in the forward
__device__ __forceinline__ void live_range(const Params& p, int qi, int* lo,
                                           int* hi) {
  const int q0 = qi * p.bq;
  *lo = 0;
  if (p.window > 0) {
    const int t = q0 - (p.window - 1);
    *lo = t > 0 ? t / p.bk : 0;
  }
  *hi = p.n_kv - 1;
  if (p.causal) *hi = min(*hi, (q0 + p.bq - 1) / p.bk);
}

// the kv columns [c_lo, c_hi] query row `row` may see
__device__ __forceinline__ void col_bounds(const Params& p, int row,
                                           int* c_lo, int* c_hi) {
  *c_hi = p.causal ? min(p.kv_len - 1, row) : p.kv_len - 1;
  *c_lo = p.window > 0 ? row - p.window + 1 : 0;
}

// P and dS of one (row, column) from the raw product q.k and dP = dO.v;
// dS is taken with respect to q.k * scale (the caller multiplies the
// scale in once, at the end)
__device__ __forceinline__ void entry(const Params& p, float qk, float dp,
                                      float lse, float dlt, int kp, int c_lo,
                                      int c_hi, float* P, float* dS) {
  float x = qk * p.scale;
  float dx = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(x / p.softcap);
    x = p.softcap * t;
    dx = 1.f - t * t;
  }
  const bool ok = kp >= c_lo && kp <= c_hi;
  const float s = ok ? x : (c_lo > c_hi ? 0.f : kNegInf);
  const float pr = expf(s - lse);
  *P = pr;
  *dS = ok ? pr * (dp - dlt) * dx : 0.f;
}

// ----------------------------------------------- 1. delta = rowsum(dO O)

template <typename T>
__global__ void __launch_bounds__(128) flash_bwd_dot(Params p, int D) {
  const long long rows = static_cast<long long>(p.B) * p.Sq * p.Hq;
  const long long r = static_cast<long long>(blockIdx.x) * 4 +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;                   // whole warps leave together
  const T* o = static_cast<const T*>(p.o) + r * D;
  const T* g = static_cast<const T*>(p.dout) + r * D;
  float acc = 0.f;
  for (int c = lane * 4; c < D; c += 128) acc = dot4(load4(o + c),
                                                      load4(g + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {                         // r = (b Sq + s) Hq + h
    const long long h = r % p.Hq, bs = r / p.Hq;
    const long long s = bs % p.Sq, b = bs / p.Sq;
    p.delta[(b * p.Hq + h) * p.Sq + s] = acc;
  }
}

// ------------------------------------------------------- 2. dK and dV

template <int D, int BK>
__host__ __device__ constexpr int smem_dkdv() {
  return (2 * BK * (D + 16) + 2 * QC * D + 2 * QC) *
         static_cast<int>(sizeof(float));
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv(Params p) {
  constexpr int TPJ = NT / BK;             // threads per kv row: 4 or 8
  constexpr int C4 = D / (4 * TPJ);        // float4 chunks per thread
  constexpr int LDK = D + 16;              // K/V rows: two rows a phase
                                           // fall in distinct banks
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                        // [BK][LDK]
  float* Vs = Ks + BK * LDK;               // [BK][LDK]
  float* Qs = Vs + BK * LDK;               // [QC][D]
  float* Gs = Qs + QC * D;                 // [QC][D], dO
  float* Ls = Gs + QC * D;                 // [QC], lse
  float* Ds = Ls + QC;                     // [QC], delta

  const int tid = threadIdx.x;
  const int j = tid / TPJ, sub = tid % TPJ;
  const int kt = blockIdx.x;
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int G = p.Hq / p.Hkv;
  const int k0 = kt * BK;
  const int kp = k0 + j;
  const T* qg = static_cast<const T*>(p.q);
  const T* gg = static_cast<const T*>(p.dout);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = tid; i < BK * D / 4; i += NT) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 kk = zero, vv = zero;
    if (k0 + r < p.Skv) {
      const long long off = row_off(b, k0 + r, hk, p.Skv, p.Hkv, D) + c;
      kk = load4(static_cast<const T*>(p.k) + off);
      vv = load4(static_cast<const T*>(p.v) + off);
    }
    store4(Ks + r * LDK + c, kk);
    store4(Vs + r * LDK + c, vv);
  }
  float4 dk[C4], dv[C4];
#pragma unroll
  for (int c = 0; c < C4; ++c) dk[c] = dv[c] = zero;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long bh = static_cast<long long>(b) * p.Hq + h;
    int visits = 0;
    for (int qi = 0; qi < p.n_q; ++qi) {   // the same for every thread
      int lo, hi;
      live_range(p, qi, &lo, &hi);
      if (kt < lo || kt > hi) continue;
      ++visits;
      const int r_end = min(qi * p.bq + p.bq, p.Sq);
      for (int r0 = qi * p.bq; r0 < r_end; r0 += QC) {
        __syncthreads();                   // the last step's reads are done
        for (int i = tid; i < QC * D / 4; i += NT) {
          const int r = i / (D / 4), c = (i % (D / 4)) * 4;
          float4 qq = zero, dd = zero;
          if (r0 + r < p.Sq) {
            const long long off = row_off(b, r0 + r, h, p.Sq, p.Hq, D) + c;
            qq = load4(qg + off);
            dd = load4(gg + off);
          }
          store4(Qs + r * D + c, qq);
          store4(Gs + r * D + c, dd);
        }
        if (tid < QC) {
          const bool in = r0 + tid < p.Sq;
          Ls[tid] = in ? p.lse[bh * p.Sq + r0 + tid] : -kNegInf;
          Ds[tid] = in ? p.delta[bh * p.Sq + r0 + tid] : 0.f;
        }
        __syncthreads();

        float s[QC], dp[QC];
#pragma unroll
        for (int r = 0; r < QC; ++r) s[r] = dp[r] = 0.f;
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          const int col = 4 * (sub + TPJ * c);
          const float4 kk = load4(Ks + j * LDK + col);
          const float4 vv = load4(Vs + j * LDK + col);
#pragma unroll
          for (int r = 0; r < QC; ++r) {
            s[r] = dot4(load4(Qs + r * D + col), kk, s[r]);
            dp[r] = dot4(load4(Gs + r * D + col), vv, dp[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < QC; ++r) {
#pragma unroll
          for (int off = 1; off < TPJ; off <<= 1) {
            s[r] += __shfl_xor_sync(0xffffffffu, s[r], off);
            dp[r] += __shfl_xor_sync(0xffffffffu, dp[r], off);
          }
          int c_lo, c_hi;
          col_bounds(p, r0 + r, &c_lo, &c_hi);
          float pr, ds;
          entry(p, s[r], dp[r], Ls[r], Ds[r], kp, c_lo, c_hi, &pr, &ds);
          const bool in = r0 + r < p.Sq;
          s[r] = in ? pr : 0.f;            // s becomes P, dp becomes dS
          dp[r] = in ? ds : 0.f;
        }
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          const int col = 4 * (sub + TPJ * c);
#pragma unroll
          for (int r = 0; r < QC; ++r) {
            fma4(dv[c], s[r], load4(Gs + r * D + col));
            fma4(dk[c], dp[r], load4(Qs + r * D + col));
          }
        }
      }
    }
    if (tid == 0) p.kv_visits[bh * p.n_kv_all + kt] = visits;
  }

  if (kp < p.Skv) {
    const long long off = row_off(b, kp, hk, p.Skv, p.Hkv, D);
    T* dkp = static_cast<T*>(p.dk) + off;
    T* dvp = static_cast<T*>(p.dv) + off;
#pragma unroll
    for (int c = 0; c < C4; ++c) {
      const int col = 4 * (sub + TPJ * c);
      const float4 a = dk[c];
      store4(dkp + col, make_float4(a.x * p.scale, a.y * p.scale,
                                    a.z * p.scale, a.w * p.scale));
      store4(dvp + col, dv[c]);
    }
  }
}

// --------------------------------------------------------------- 3. dQ

// threads per query row
template <int D>
__host__ __device__ constexpr int tpr() { return D == 256 ? 8 : 4; }

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq(Params p) {
  constexpr int TPR = tpr<D>();
  constexpr int C4 = D / (4 * TPR);
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                        // [bk][D]
  float* Vs = smem + p.bk * D;             // [bk][D]

  const int nt = blockDim.x;
  const int rows = nt / TPR;               // query rows of this block
  const int tid = threadIdx.x;
  const int i = tid / TPR, sub = tid % TPR;
  const int bh = blockIdx.y;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int row0 = blockIdx.x * rows;
  const int qi = row0 / p.bq;              // the q tile that holds them
  const int row = row0 + i;
  const bool in = row < p.Sq;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 qv[C4], gv[C4], acc[C4];
  const long long off = row_off(b, in ? row : 0, h, p.Sq, p.Hq, D);
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    const int col = 4 * (sub + TPR * c);
    qv[c] = in ? load4(static_cast<const T*>(p.q) + off + col) : zero;
    gv[c] = in ? load4(static_cast<const T*>(p.dout) + off + col) : zero;
    acc[c] = zero;
  }
  const long long rs = static_cast<long long>(bh) * p.Sq + (in ? row : 0);
  const float lse = in ? p.lse[rs] : -kNegInf;
  const float dlt = in ? p.delta[rs] : 0.f;
  int c_lo, c_hi;
  col_bounds(p, row, &c_lo, &c_hi);
  int lo, hi;
  live_range(p, qi, &lo, &hi);

  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * p.bk;
    __syncthreads();                       // the last tile's reads are done
    for (int x = tid; x < p.bk * D / 4; x += nt) {
      const int r = x / (D / 4), c = (x % (D / 4)) * 4;
      float4 kk = zero, vv = zero;
      if (k0 + r < p.Skv) {
        const long long o = row_off(b, k0 + r, hk, p.Skv, p.Hkv, D) + c;
        kk = load4(static_cast<const T*>(p.k) + o);
        vv = load4(static_cast<const T*>(p.v) + o);
      }
      store4(Ks + r * D + c, kk);
      store4(Vs + r * D + c, vv);
    }
    __syncthreads();
    for (int jj = 0; jj < p.bk; ++jj) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        const int col = 4 * (sub + TPR * c);
        s = dot4(qv[c], load4(Ks + jj * D + col), s);
        dp = dot4(gv[c], load4(Vs + jj * D + col), dp);
      }
#pragma unroll
      for (int o = 1; o < TPR; o <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        dp += __shfl_xor_sync(0xffffffffu, dp, o);
      }
      float pr, ds;
      entry(p, s, dp, lse, dlt, k0 + jj, c_lo, c_hi, &pr, &ds);
      if (!in) ds = 0.f;
#pragma unroll
      for (int c = 0; c < C4; ++c)
        fma4(acc[c], ds, load4(Ks + jj * D + 4 * (sub + TPR * c)));
    }
  }

  if (in) {
    T* dqp = static_cast<T*>(p.dq) + off;
#pragma unroll
    for (int c = 0; c < C4; ++c) {
      const float4 a = acc[c];
      store4(dqp + 4 * (sub + TPR * c),
             make_float4(a.x * p.scale, a.y * p.scale, a.z * p.scale,
                         a.w * p.scale));
    }
  }
  if (tid == 0 && row0 % p.bq == 0)
    p.q_visits[static_cast<long long>(bh) * p.n_q + qi] = max(0, hi - lo + 1);
}

// ---------------------------------------------------------------- launch

template <typename K>
int raise_smem_limit(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <typename T, int D, int BK>
int launch(const Params& p, cudaStream_t st) {
  const long long rows = static_cast<long long>(p.B) * p.Sq * p.Hq;
  flash_bwd_dot<T><<<static_cast<unsigned>((rows + 3) / 4), 128, 0, st>>>(
      p, D);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  constexpr int kv_bytes = smem_dkdv<D, BK>();
  // once per kernel instance (thread-safe static initialisation)
  static const int kv_attr =
      raise_smem_limit(flash_bwd_dkdv<T, D, BK>, kv_bytes);
  if (kv_attr != 0) return kv_attr;
  flash_bwd_dkdv<T, D, BK>
      <<<dim3(p.n_kv_all, p.B * p.Hkv), NT, kv_bytes, st>>>(p);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  constexpr int q_bytes = 2 * BK * D * static_cast<int>(sizeof(float));
  static const int q_attr = raise_smem_limit(flash_bwd_dq<T, D>, q_bytes);
  if (q_attr != 0) return q_attr;
  const int rows_per_block = p.bq < NT / tpr<D>() ? p.bq : NT / tpr<D>();
  const int q_blocks = (p.Sq + rows_per_block - 1) / rows_per_block;
  flash_bwd_dq<T, D><<<dim3(q_blocks, p.B * p.Hq),
                       rows_per_block * tpr<D>(), q_bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The kv tile of the backward for (dtype, D), the forward's: 0 = float32,
// 1 = bfloat16; 0 if it is not built.
extern "C" int flash_attention_bwd_block_k(int dtype, int D) {
  if (D != 64 && D != 128 && D != 256) return 0;
  if (dtype == 0) return 32;
  if (dtype == 1) return D == 256 ? 32 : 64;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o, dout, dq, dk, dv are
// contiguous (B, S, H, D); lse and delta (B, Hq, Sq) float32 (delta is
// scratch); kv_visits (B * Hq, ceil(Skv / bk)) and q_visits
// (B * Hq, ceil(Sq / bq)) int32. (bq, bk) are the forward's tiles: bq 32
// or 64, bk flash_attention_bwd_block_k's. Returns cudaGetLastError()
// after each launch (0 = ok).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int* kv_visits, int* q_visits, int dtype, int D, int bq,
    int bk, int B, int Hq, int Hkv, int Sq, int Skv, int kv_len, int causal,
    int window, float softcap, float scale, void* stream) {
  if (bk != flash_attention_bwd_block_k(dtype, D) || (bq != 32 && bq != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = lse; p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.kv_visits = kv_visits; p.q_visits = q_visits;
  p.B = B; p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Skv = Skv; p.kv_len = kv_len;
  p.causal = causal; p.window = window;
  p.softcap = softcap; p.scale = scale;
  p.bq = bq; p.bk = bk;
  p.n_kv = (kv_len + bk - 1) / bk;
  p.n_q = (Sq + bq - 1) / bq;
  p.n_kv_all = (Skv + bk - 1) / bk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D == 64) return launch<float, 64, 32>(p, st);
    if (D == 128) return launch<float, 128, 32>(p, st);
    return launch<float, 256, 32>(p, st);
  }
  if (D == 64) return launch<__nv_bfloat16, 64, 64>(p, st);
  if (D == 128) return launch<__nv_bfloat16, 128, 64>(p, st);
  return launch<__nv_bfloat16, 256, 32>(p, st);
}
