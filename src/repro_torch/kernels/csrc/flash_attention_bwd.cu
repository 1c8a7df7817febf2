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
// exp(s_ij - lse_i) recomputed from the scores and delta_i =
// rowsum(dout_i * out_i):
//   dK and dV: one block per (kv tile, b * Hkv + kv head) walks the query
//     heads of its kv head and, for each, the q tiles whose live range
//     holds the tile: dV += P^T dO and dK += dS^T Q with
//     dS = P (dP - delta);
//   dQ: one block per (q tile, b * Hq + head) over the tile's live kv
//     tiles, dQ += dS K.
// bf16 takes two launches, dQ (which also writes delta, since its block
// owns the rows) and then dK/dV; fp32 three: flash_bwd_dot (delta, one
// warp a row), dK/dV, dQ.
// The tiles are the forward's (bq, bk), and a kv tile outside a q tile's
// live range [lo, hi] (flash_attention.py:_lo_block/_hi_block) is skipped
// exactly, as in the forward: dQ visits live_block_counts tiles per q tile
// and dK/dV the same pairs from the kv side, both counted. A row
// with no live column (its forward output is the mean of the values of the
// tiles it visited, all scored -1e30 and weighted 1) scores those columns 0
// here, so that P = exp(0 - log l) = 1 / l gives that mean's gradient to V,
// and none to Q or K. Tiles past the last live one (kv_len, causal) still
// write dK = dV = 0. No float atomics anywhere: every sum is taken in a
// fixed order, so two calls give the same bits.
//
// bf16 (training's path): tensor cores, FlashAttention-2's backward built
// from the forward's pieces (mma.sync.m16n8k16 bf16 with fp32
// accumulators, ldmatrix(.trans), cp.async, rows padded by 16 bytes).
//   dK/dV (flash_bwd_dkdv_bf16): each warp owns 16 kv rows of the
//   block's kv tile (bk 64: 4 warps; at D = 256, bk 32, two warps share a
//   16-row slab and each owns half of dK's and dV's 256 columns, since one
//   warp cannot hold two 16 x 256 fp32 accumulators). K and V stay bf16 in
//   shared memory. The (query head, q tile) steps stream Q, dO (bq x D
//   bf16) and the tile's lse and delta through a two-stage cp.async ring,
//   the copy of step i + 1 issued before step i is computed. A warp takes
//   S^T = K_w Q^T and dP^T = V_w dO^T as C fragments (32 query columns at a
//   time, to keep the scores beside the accumulators), masks
//   them with each query row's column bounds, and packs P^T and
//   dS^T = P^T (dP^T - delta) from the C fragments straight into bf16 A
//   fragments (the forward's P V repack) for dV += P^T dO and dK += dS^T Q,
//   dO and Q read by ldmatrix.trans.
//   Grouped-query heads fill the card through a thread block cluster over
//   the query heads of one kv head: the c blocks of a cluster (the largest
//   c that divides G up to 8, chosen on the host by
//   flash_attention.bwd_cluster) take G / c heads each for the same kv tile, leave their fp32 dK/dV partials in
//   shared memory, and block r adds chunk r, r + c, ... of every block's
//   partial in rank order 0..c-1 through distributed shared memory before
//   it rounds once. At Qwen2-0.5B's training shape (G = 7) that is 7 x 128
//   blocks instead of 128 on 132 SMs; at the hybrid's (G = 16), 8 x 32.
//   The result does not depend on the order in which blocks run; a
//   cluster of c differs from c = 1 only in where the fp32 sum of the
//   heads is split.
//   dQ (flash_bwd_dq_bf16) has the forward's structure: each warp owns
//   16 query rows; Q and dO stay in shared memory, K and V tiles arrive
//   through a two-stage cp.async ring over the live kv tiles; it computes
//   its rows' delta first (a quad of lanes a row, 16-byte loads), then
//   S = Q K^T and dP = dO V^T, dS in registers, and dQ += dS K with K read
//   by ldmatrix.trans. S and dP are computed again there (7 products where
//   the function needs 5): fusing dQ into the dK/dV kernel would need
//   atomics or a dS buffer of B Hq Sq Skv elements.
//   At D = 64 both kernels are compiled for 3 blocks an SM (168
//   registers, no spill), which the card ran faster than builds that
//   left ptxas free to take more registers for 2 blocks an SM.
//   P and dS are rounded to bf16 before their products, as the forward
//   rounds p for P V; flash_attention_bwd_plain rounds at the same points.
//
// fp32 (the reference-precision checks): CUDA-core FMAs, never TF32, as
// the forward's fp32 kernel. dK/dV (flash_bwd_dkdv): TPJ = 256 / bk
// threads share a kv row, each holding D / TPJ of its dK and dV, 16 query
// rows a step; dQ (flash_bwd_dq): 4 threads (8 at D = 256) share a query
// row. A score is the partial dot products summed with warp
// shuffles.
//
// Bound. The function reads q, k, v, out, dout and lse once and writes dq,
// dk and dv once, and does five products of the forward's size (S, dP, dV,
// dK, dQ: 10 B Hq pairs D operations). At Qwen2-0.5B's training shape
// (B = 8, S = 512, 14 query heads over 2 kv heads of 64, causal, bf16) that
// is 33.8 MB, 0.0101 ms at 3.35 TB/s, against 9.4 GFLOP, 0.0095 ms at the
// bf16 tensor cores' 989 TFLOP/s: bound by memory, with the arithmetic
// close behind, so the design keeps every product on the tensor cores and
// every tile bf16. Measured by python3 chip_smoke.py (phase 28 (c), by
// graph_ms) on an NVIDIA H100 80GB HBM3 at 700 W: 0.1530 ms there
// (SDPA's backward 0.0850 ms; the CUDA-core design took 2.0075), 0.0566 ms
// at GECToR-base's shape (B = 32, S = 128, 12 heads of 64; SDPA 0.0466,
// was 0.5441) and 0.2264 ms at the hybrid's (B = 2, S = 512, 16 query
// heads over one kv head of 256, causal; SDPA 0.1023). PERF.md keeps the
// times of each run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr int NT = 256;         // threads of the fp32 dK/dV and dQ kernels
constexpr int QC = 16;          // query rows an fp32 dK/dV step takes
constexpr int MAX_CLUSTER = 8;  // blocks of a bf16 dK/dV cluster (portable)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;             // (B, Hq, Sq)
  float* delta;                 // (B, Hq, Sq), written before dK/dV
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
  int cluster;                  // bf16 dK/dV blocks per (kv tile, kv head)
};

// ------------------------------------------------------------ helpers

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
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

// ----------------------------------------- 1. fp32: delta = rowsum(dO O)

__global__ void __launch_bounds__(128) flash_bwd_dot(Params p, int D) {
  const long long rows = static_cast<long long>(p.B) * p.Sq * p.Hq;
  const long long r = static_cast<long long>(blockIdx.x) * 4 +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;                   // whole warps leave together
  const float* o = static_cast<const float*>(p.o) + r * D;
  const float* g = static_cast<const float*>(p.dout) + r * D;
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

// ------------------------------------------------ 2. fp32: dK and dV

template <int D, int BK>
__host__ __device__ constexpr int smem_dkdv() {
  return (2 * BK * (D + 16) + 2 * QC * D + 2 * QC) *
         static_cast<int>(sizeof(float));
}

template <int D, int BK>
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
  const float* qg = static_cast<const float*>(p.q);
  const float* gg = static_cast<const float*>(p.dout);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = tid; i < BK * D / 4; i += NT) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 kk = zero, vv = zero;
    if (k0 + r < p.Skv) {
      const long long off = row_off(b, k0 + r, hk, p.Skv, p.Hkv, D) + c;
      kk = load4(static_cast<const float*>(p.k) + off);
      vv = load4(static_cast<const float*>(p.v) + off);
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
    float* dkp = static_cast<float*>(p.dk) + off;
    float* dvp = static_cast<float*>(p.dv) + off;
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

// ------------------------------------------------------------ 3. fp32: dQ

// threads per query row
template <int D>
__host__ __device__ constexpr int tpr() { return D == 256 ? 8 : 4; }

template <int D>
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
    qv[c] = in ? load4(static_cast<const float*>(p.q) + off + col) : zero;
    gv[c] = in ? load4(static_cast<const float*>(p.dout) + off + col) : zero;
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
        kk = load4(static_cast<const float*>(p.k) + o);
        vv = load4(static_cast<const float*>(p.v) + o);
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
    float* dqp = static_cast<float*>(p.dq) + off;
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

// ------------------------------------------------ bf16: tensor-core helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(ok ? 16 : 0));
}

// 4 bytes global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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

// e^x as 2^(x log2 e) on the special-function unit; e^(-1e30) is 0
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// (lo, hi) rounded to bf16 in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// acc + the dot product of 8 bf16 pairs held in two 16-byte words
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const uint32_t* x = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* y = reinterpret_cast<const uint32_t*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(x + i));
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(y + i));
    acc = fmaf(u.x, v.x, acc);
    acc = fmaf(u.y, v.y, acc);
  }
  return acc;
}

// the A fragment (16 x 16, row) of columns [16 ks, 16 ks + 16) from the C
// fragments c[2 ks], c[2 ks + 1] (16 x 8 each), rounded to bf16
__device__ __forceinline__ void c_to_a(uint32_t* a, const float* c0,
                                       const float* c1) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

// rows [r0, r0 + R) of a bf16 matrix with rows `stride` elements apart
// into shared memory rows of D + 8 elements; rows at or past n are
// zero-filled
template <int D, int R, int NTH>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int r0, int n,
                                          int tid) {
  constexpr int LD = D + 8;
  constexpr int PER_ROW = D / 8;           // 16-byte chunks
#pragma unroll
  for (int i = tid; i < R * PER_ROW; i += NTH) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * LD + c, src + (ok ? r0 + r : 0) * stride + c, ok);
  }
}

// the 16 x (8 NS) block C += A B^T, A the 16 rows of `as` (row-major,
// rows D + 8 apart), B^T's columns the rows [0, 8 NS) of `bs`, both over D
template <int D, int NS>
__device__ __forceinline__ void rows_by_rows(float (*c)[4],
                                             const __nv_bfloat16* as,
                                             const __nv_bfloat16* bs,
                                             int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, as + (lane % 16) * LD + kk + (lane / 16) * 8);
#pragma unroll
    for (int n = 0; n < NS; n += 2) {
      uint32_t bb[4];
      ldmatrix_x4(bb, bs + (n * 8 + lane % 8 + (lane / 16) * 8) * LD + kk +
                          ((lane / 8) % 2) * 8);
      mma_bf16(c[n], a, bb[0], bb[1]);
      mma_bf16(c[n + 1], a, bb[2], bb[3]);
    }
  }
}

// C (16 x 8 NO) += A (16 x 16, the fragments `a`) times rows [0, 16) of
// `bs` (row-major, rows D + 8 apart; its columns [0, 8 NO)), read by
// ldmatrix.trans
template <int D, int NO>
__device__ __forceinline__ void frag_by_rows(float (*c)[4], const uint32_t* a,
                                             const __nv_bfloat16* bs,
                                             int lane) {
  constexpr int LD = D + 8;
  const int r = lane % 8 + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int n = 0; n < NO; n += 2) {
    uint32_t bb[4];
    ldmatrix_x4_trans(bb, bs + r * LD + n * 8 + (lane / 16) * 8);
    mma_bf16(c[n], a, bb[0], bb[1]);
    mma_bf16(c[n + 1], a, bb[2], bb[3]);
  }
}

// the score of a raw product: x * scale through the softcap, and the
// softcap's derivative
__device__ __forceinline__ float capped(const Params& p, float qk,
                                        float* dx) {
  float x = qk * p.scale;
  *dx = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(x / p.softcap);
    x = p.softcap * t;
    *dx = 1.f - t * t;
  }
  return x;
}

// kv rows of a bf16 tile, the forward's
template <int D>
__host__ __device__ constexpr int bk_bf16() { return D == 256 ? 32 : 64; }
// warps sharing a 16-row kv slab of the dK/dV kernel, each owning
// D / dsplit of its dK and dV columns
template <int D>
__host__ __device__ constexpr int dsplit() { return D == 256 ? 2 : 1; }
// query columns a dK/dV warp scores at a time: S^T and dP^T take 32
// registers beside the accumulators
constexpr int QS = 32;
// blocks an SM the bf16 kernels are compiled for: 3 at D = 64 (168
// registers a thread, no spill; faster on the card than 2 blocks with
// more registers), else 1 (the accumulators of D = 128 and 256 need the
// registers)
template <int D>
__host__ __device__ constexpr int min_blocks() { return D == 64 ? 3 : 1; }

// shared memory of the dK/dV kernel: K and V (bf16), then either the
// two-stage ring of Q, dO (bf16), lse, delta (fp32), or, once the steps
// are done, the fp32 partials of dK and dV that the cluster adds
template <int D, int BQ>
struct DkdvSmem {
  static constexpr int BK = bk_bf16<D>();
  static constexpr int LD = D + 8;         // bf16 rows
  static constexpr int LDP = D + 8;        // fp32 partial rows
  static constexpr int NT = BK / 16 * dsplit<D>() * 32;
  static constexpr int KV = 2 * BK * LD * 2;
  static constexpr int STAGE = 2 * BQ * LD * 2 + 2 * BQ * 4;
  static constexpr int RING = 2 * STAGE;
  static constexpr int PART = 2 * BK * LDP * 4;
  static constexpr int BYTES = KV + (RING > PART ? RING : PART);
};

// -------------------------- bf16: dK and dV (a cluster), launched after dQ

template <int D, int BQ>
__global__ void __launch_bounds__(DkdvSmem<D, BQ>::NT, min_blocks<D>())
    flash_bwd_dkdv_bf16(Params p) {
  using L = DkdvSmem<D, BQ>;
  constexpr int BK = L::BK, LD = L::LD, LDP = L::LDP, NT_ = L::NT;
  constexpr int DC = D / dsplit<D>();      // dK/dV columns of a warp
  constexpr int NS = QS / 8;               // 8-column tiles of S^T
  constexpr int NO = DC / 8;               // 8-column tiles of dK, dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BK * LD;
  unsigned char* ring = smem_raw + L::KV;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slab = warp / dsplit<D>();
  const int dc0 = (warp % dsplit<D>()) * DC;
  const int c = p.cluster;
  const int kt = blockIdx.x / c, rank = blockIdx.x % c;
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int G = p.Hq / p.Hkv, Gc = G / c, g0 = rank * Gc;
  const int k0 = kt * BK;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* gg = static_cast<const __nv_bfloat16*>(p.dout);

  // the q tiles whose live range holds kt: a contiguous run [qa, qa + n)
  int qa = 0, n_live = 0;
  for (int qi = 0; qi < p.n_q; ++qi) {     // the same for every thread
    int lo, hi;
    live_range(p, qi, &lo, &hi);
    if (kt >= lo && kt <= hi) {
      if (n_live == 0) qa = qi;
      ++n_live;
    }
  }
  const int n_steps = Gc * n_live;         // (head, q tile), head-major

  // step s (head g0 + s / n_live, q tile qa + s % n_live) into stage s & 1
  auto load_step = [&](int s) {
    __nv_bfloat16* Qs =
        reinterpret_cast<__nv_bfloat16*>(ring + (s & 1) * L::STAGE);
    __nv_bfloat16* Gs = Qs + BQ * LD;
    float* Ls = reinterpret_cast<float*>(Gs + BQ * LD);  // lse, then delta
    const int h = hk * G + g0 + s / n_live;
    const int q0 = (qa + s % n_live) * BQ;
    const long long base = (static_cast<long long>(b) * p.Sq * p.Hq + h) * D;
    load_rows<D, BQ, NT_>(Qs, qg + base, p.Hq * D, q0, p.Sq, tid);
    load_rows<D, BQ, NT_>(Gs, gg + base, p.Hq * D, q0, p.Sq, tid);
    const long long lb = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
    for (int i = tid; i < 2 * BQ; i += NT_) {
      const int r = i % BQ;
      const bool ok = q0 + r < p.Sq;
      cp_async4(Ls + i, (i < BQ ? p.lse : p.delta) + lb + (ok ? q0 + r : 0),
                ok);
    }
    cp_async_commit();
  };
  if (n_steps > 0) {                       // K and V with the first step
    const long long kb = (static_cast<long long>(b) * p.Skv * p.Hkv + hk) * D;
    load_rows<D, BK, NT_>(Ks, static_cast<const __nv_bfloat16*>(p.k) + kb,
                          p.Hkv * D, k0, p.Skv, tid);
    load_rows<D, BK, NT_>(Vs, static_cast<const __nv_bfloat16*>(p.v) + kb,
                          p.Hkv * D, k0, p.Skv, tid);
    load_step(0);
  }
  if (tid == 0)
    for (int g = g0; g < g0 + Gc; ++g)
      p.kv_visits[(static_cast<long long>(b) * p.Hq + hk * G + g) *
                      p.n_kv_all + kt] = n_live;

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const __nv_bfloat16* Kw = Ks + slab * 16 * LD;   // the warp's kv rows
  const __nv_bfloat16* Vw = Vs + slab * 16 * LD;
  const int kp0 = k0 + slab * 16 + lane / 4;       // rows kp0, kp0 + 8

  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait_all();
    __syncthreads();   // step s visible; every warp is done with s - 1
    if (s + 1 < n_steps) load_step(s + 1);       // in flight during s
    const __nv_bfloat16* Qs =
        reinterpret_cast<const __nv_bfloat16*>(ring + (s & 1) * L::STAGE);
    const __nv_bfloat16* Gs = Qs + BQ * LD;
    const float* Ls = reinterpret_cast<const float*>(Gs + BQ * LD);
    const float* Ds = Ls + BQ;
    const int q0 = (qa + s % n_live) * BQ;
#pragma unroll
    for (int qs0 = 0; qs0 < BQ; qs0 += QS) {
      // S^T = K_w Q^T and dP^T = V_w dO^T over the QS query columns
      float st[NS][4], dpt[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      rows_by_rows<D, NS>(st, Kw, Qs + qs0 * LD, lane);
      rows_by_rows<D, NS>(dpt, Vw, Gs + qs0 * LD, lane);
      // P^T and dS^T in place: element e of tile n is kv row kp0 + 8 (e / 2)
      // and query column qs0 + 8 n + 2 (lane % 4) + (e & 1)
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ql = qs0 + n * 8 + 2 * (lane % 4) + j;
          const int row = q0 + ql;
          int c_lo, c_hi;
          col_bounds(p, row, &c_lo, &c_hi);
          const bool in = row < p.Sq;
          const float lse = Ls[ql], dlt = Ds[ql];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 2 * i + j, kp = kp0 + 8 * i;
            float dx;
            const float x = capped(p, st[n][e], &dx);
            const bool ok = in && kp >= c_lo && kp <= c_hi;
            const float sv = ok ? x : (c_lo > c_hi ? 0.f : kNegInf);
            const float pr = in ? fast_exp(sv - lse) : 0.f;
            st[n][e] = pr;
            dpt[n][e] = ok ? pr * (dpt[n][e] - dlt) * dx : 0.f;
          }
        }
      }
      // dV += P^T dO and dK += dS^T Q, 16 query rows a k-step
#pragma unroll
      for (int ks = 0; ks < QS / 16; ++ks) {
        uint32_t ap[4], as[4];
        c_to_a(ap, st[2 * ks], st[2 * ks + 1]);
        c_to_a(as, dpt[2 * ks], dpt[2 * ks + 1]);
        const int r0 = (qs0 + ks * 16) * LD + dc0;
        frag_by_rows<D, NO>(dv, ap, Gs + r0, lane);
        frag_by_rows<D, NO>(dk, as, Qs + r0, lane);
      }
    }
  }

  // the partials into shared memory (the ring is free once every warp is
  // past its last step): dK then dV, [BK][LDP] fp32 each
  __syncthreads();
  float* part = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* r = part + (slab * 16 + lane / 4 + 8 * i) * LDP + dc0 + n * 8 +
                 2 * (lane % 4);
      *reinterpret_cast<float2*>(r) = make_float2(dk[n][2 * i],
                                                  dk[n][2 * i + 1]);
      *reinterpret_cast<float2*>(r + BK * LDP) =
          make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  cg::cluster_group cluster = cg::this_cluster();
  if (c > 1)
    cluster.sync();    // every block's partial is written
  else
    __syncthreads();
  // block `rank` adds float4 chunks rank, rank + c, ... of the cluster's
  // partials in rank order 0..c-1 and rounds once
  constexpr int CH = BK * D / 4;           // float4 chunks of dK (of dV)
  for (int i = rank * NT_ + tid; i < 2 * CH; i += c * NT_) {
    const int which = i / CH, j = i % CH;  // 0: dK, 1: dV
    const int r = j / (D / 4), col = (j % (D / 4)) * 4;
    const int off = (which * BK + r) * LDP + col;
    float4 a = *reinterpret_cast<const float4*>(part + off);
    if (c > 1) {
      float4 pv[MAX_CLUSTER];
#pragma unroll
      for (int s = 0; s < MAX_CLUSTER; ++s)   // the loads first, then
        if (s < c)
          pv[s] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part, s) + off);
      a = pv[0];
#pragma unroll
      for (int s = 1; s < MAX_CLUSTER; ++s)   // the sum, in rank order
        if (s < c) {
          a.x += pv[s].x;
          a.y += pv[s].y;
          a.z += pv[s].z;
          a.w += pv[s].w;
        }
    }
    if (k0 + r < p.Skv) {
      const float f = which == 0 ? p.scale : 1.f;
      uint2 u;
      u.x = pack_bf16x2(a.x * f, a.y * f);
      u.y = pack_bf16x2(a.z * f, a.w * f);
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(which ? p.dv : p.dk);
      *reinterpret_cast<uint2*>(
          out + row_off(b, k0 + r, hk, p.Skv, p.Hkv, D) + col) = u;
    }
  }
  if (c > 1) cluster.sync();   // no block leaves while another reads it
}

// ----------------------------------------- bf16: dQ and delta, launched first

template <int D, int BQ>
__host__ __device__ constexpr int smem_dq_bf16() {
  return (2 * BQ + 4 * bk_bf16<D>()) * (D + 8) * 2;
}

template <int D, int NWARP>
__global__ void __launch_bounds__(NWARP * 32, min_blocks<D>())
    flash_bwd_dq_bf16(Params p) {
  constexpr int BQ = 16 * NWARP;
  constexpr int NT_ = NWARP * 32;
  constexpr int BK = bk_bf16<D>();
  constexpr int LD = D + 8;
  constexpr int NS = BK / 8;               // 8-column tiles of S
  constexpr int NO = D / 8;                // 8-column tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Gs = Qs + BQ * LD;        // dO
  __nv_bfloat16* KV = Gs + BQ * LD;        // [stage][K | V][BK][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qi = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qi * BQ;
  const long long qb = (static_cast<long long>(b) * p.Sq * p.Hq + h) * D;
  const long long kb = (static_cast<long long>(b) * p.Skv * p.Hkv + hk) * D;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + kb;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + kb;

  auto load_kv = [&](int s, int t) {
    __nv_bfloat16* dst = KV + s * 2 * BK * LD;
    load_rows<D, BK, NT_>(dst, kg, p.Hkv * D, t * BK, p.Skv, tid);
    load_rows<D, BK, NT_>(dst + BK * LD, vg, p.Hkv * D, t * BK, p.Skv, tid);
    cp_async_commit();
  };
  int lo, hi;
  live_range(p, qi, &lo, &hi);
  if (lo <= hi) {                          // Q and dO with the first tile
    load_rows<D, BQ, NT_>(Qs, static_cast<const __nv_bfloat16*>(p.q) + qb,
                          p.Hq * D, q0, p.Sq, tid);
    load_rows<D, BQ, NT_>(Gs, static_cast<const __nv_bfloat16*>(p.dout) + qb,
                          p.Hq * D, q0, p.Sq, tid);
    load_kv(0, lo);
  }

  // this thread's rows lane/4 and lane/4 + 8 of the warp's 16, and their
  // delta = rowsum(dO O): the quad shares each row's columns, 8 at a time
  // (the fp32 path's flash_bwd_dot folded in here, since this block owns
  // the rows; the dK/dV kernel, which reads delta, runs after this one)
  const int qr[2] = {q0 + warp * 16 + lane / 4,
                     q0 + warp * 16 + lane / 4 + 8};
  int c_lo[2], c_hi[2];
  float lse[2], dlt[2];
  bool in[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    col_bounds(p, qr[i], &c_lo[i], &c_hi[i]);
    in[i] = qr[i] < p.Sq;
    const long long rs = static_cast<long long>(bh) * p.Sq + qr[i];
    lse[i] = in[i] ? p.lse[rs] : -kNegInf;
    float d = 0.f;
    if (in[i]) {
      const long long ro = qb + static_cast<long long>(qr[i]) * p.Hq * D;
#pragma unroll
      for (int c = (lane % 4) * 8; c < D; c += 32) {
        const uint4 o = *reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(p.o) + ro + c);
        const uint4 g = *reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(p.dout) + ro + c);
        d = dot8(o, g, d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    dlt[i] = d;
    if (in[i] && lane % 4 == 0) p.delta[rs] = d;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = lo; kt <= hi; ++kt) {
    const int stage = (kt - lo) & 1;
    cp_async_wait_all();
    __syncthreads();   // tile kt visible; every warp is done with kt - 1
    if (kt < hi) load_kv(stage ^ 1, kt + 1);  // in flight during tile kt
    const __nv_bfloat16* Ks = KV + stage * 2 * BK * LD;
    const __nv_bfloat16* Vs = Ks + BK * LD;
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    rows_by_rows<D, NS>(s, Qs + warp * 16 * LD, Ks, lane);
    rows_by_rows<D, NS>(dp, Gs + warp * 16 * LD, Vs, lane);
    // dS in place of dP: element e of tile n is row qr[e / 2], kv column
    // kt * BK + 8 n + 2 (lane % 4) + (e & 1)
    const int kc = kt * BK + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2, kp = kc + n * 8 + (e & 1);
        float dx;
        const float x = capped(p, s[n][e], &dx);
        const bool ok = in[i] && kp >= c_lo[i] && kp <= c_hi[i];
        dp[n][e] = ok ? fast_exp(x - lse[i]) * (dp[n][e] - dlt[i]) * dx
                      : 0.f;
      }
    }
    // dQ += dS K, 16 kv rows a k-step
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4];
      c_to_a(a, dp[2 * ks], dp[2 * ks + 1]);
      frag_by_rows<D, NO>(acc, a, Ks + ks * 16 * LD, lane);
    }
  }

  // dQ through the warp's own Q rows (no other warp reads them), then out
  // in 16-byte row chunks
  __nv_bfloat16* Os = Qs + warp * 16 * LD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t* orow = reinterpret_cast<uint32_t*>(
        Os + (lane / 4 + 8 * i) * LD + 2 * (lane % 4));
#pragma unroll
    for (int n = 0; n < NO; ++n)
      orow[n * 4] = pack_bf16x2(acc[n][2 * i] * p.scale,
                                acc[n][2 * i + 1] * p.scale);
  }
  __syncwarp();
  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + qb;
#pragma unroll
  for (int idx = lane; idx < 16 * (D / 8); idx += 32) {
    const int r = idx / (D / 8), col = (idx % (D / 8)) * 8;
    const int row = q0 + warp * 16 + r;
    if (row < p.Sq)
      *reinterpret_cast<uint4*>(dqg + static_cast<long long>(row) * p.Hq *
                                          D + col) =
          *reinterpret_cast<const uint4*>(Os + r * LD + col);
  }
  if (tid == 0)
    p.q_visits[static_cast<long long>(bh) * p.n_q + qi] = max(0, hi - lo + 1);
}

// ---------------------------------------------------------------- launch

template <typename K>
int raise_smem_limit(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// three launches: delta, dK/dV, dQ
template <int D, int BK>
int launch_f32(const Params& p, cudaStream_t st) {
  const long long rows = static_cast<long long>(p.B) * p.Sq * p.Hq;
  flash_bwd_dot<<<static_cast<unsigned>((rows + 3) / 4), 128, 0, st>>>(p, D);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  constexpr int kv_bytes = smem_dkdv<D, BK>();
  // once per kernel instance (thread-safe static initialisation)
  static const int kv_attr =
      raise_smem_limit(flash_bwd_dkdv<D, BK>, kv_bytes);
  if (kv_attr != 0) return kv_attr;
  flash_bwd_dkdv<D, BK>
      <<<dim3(p.n_kv_all, p.B * p.Hkv), NT, kv_bytes, st>>>(p);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  constexpr int q_bytes = 2 * BK * D * static_cast<int>(sizeof(float));
  static const int q_attr = raise_smem_limit(flash_bwd_dq<D>, q_bytes);
  if (q_attr != 0) return q_attr;
  const int rows_per_block = p.bq < NT / tpr<D>() ? p.bq : NT / tpr<D>();
  const int q_blocks = (p.Sq + rows_per_block - 1) / rows_per_block;
  flash_bwd_dq<D><<<dim3(q_blocks, p.B * p.Hq), rows_per_block * tpr<D>(),
                    q_bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// two launches: dQ (which writes delta), then dK/dV (which reads it)
template <int D, int BQ>
int launch_bf16(const Params& p, cudaStream_t st) {
  constexpr int q_bytes = smem_dq_bf16<D, BQ>();
  static const int q_attr =
      raise_smem_limit(flash_bwd_dq_bf16<D, BQ / 16>, q_bytes);
  if (q_attr != 0) return q_attr;
  flash_bwd_dq_bf16<D, BQ / 16>
      <<<dim3(p.n_q, p.B * p.Hq), BQ * 2, q_bytes, st>>>(p);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  // dK/dV: p.cluster blocks per (kv tile, kv head), one cluster
  using L = DkdvSmem<D, BQ>;
  static const int kv_attr =
      raise_smem_limit(flash_bwd_dkdv_bf16<D, BQ>, L::BYTES);
  if (kv_attr != 0) return kv_attr;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = p.cluster;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_kv_all * p.cluster, p.B * p.Hkv);
  cfg.blockDim = dim3(L::NT);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = st;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  rc = static_cast<int>(
      cudaLaunchKernelEx(&cfg, flash_bwd_dkdv_bf16<D, BQ>, p));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The kv tile of the backward for (dtype, D), the forward's: 0 = float32,
// 1 = bfloat16; 0 if it is not built.
extern "C" int flash_attention_bwd_block_k(int dtype, int D) {
  if (D != 64 && D != 128 && D != 256) return 0;
  if (dtype == 0) return 32;
  if (dtype == 1) return D == 256 ? bk_bf16<256>() : bk_bf16<64>();
  return 0;
}

// The largest cluster of the bf16 dK/dV kernel (blocks that split the
// query heads of one kv head).
extern "C" int flash_attention_bwd_max_cluster() { return MAX_CLUSTER; }

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o, dout, dq, dk, dv are
// contiguous (B, S, H, D); lse and delta (B, Hq, Sq) float32 (delta is
// scratch); kv_visits (B * Hq, ceil(Skv / bk)) and q_visits
// (B * Hq, ceil(Sq / bq)) int32. (bq, bk) are the forward's tiles: bq 32
// or 64, bk flash_attention_bwd_block_k's. cluster: the bf16 dK/dV
// kernel's blocks per (kv tile, kv head), a divisor of Hq / Hkv up to
// MAX_CLUSTER; 1 in fp32. Returns cudaGetLastError() after each launch
// (0 = ok).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int* kv_visits, int* q_visits, int dtype, int D, int bq,
    int bk, int B, int Hq, int Hkv, int Sq, int Skv, int kv_len, int causal,
    int window, int cluster, float softcap, float scale, void* stream) {
  if (bk != flash_attention_bwd_block_k(dtype, D) || (bq != 32 && bq != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hkv > 0 ? Hq / Hkv : 0;
  if (cluster < 1 || cluster > MAX_CLUSTER || G < 1 || G % cluster != 0 ||
      (dtype == 0 && cluster != 1))
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
  p.cluster = cluster;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D == 64) return launch_f32<64, 32>(p, st);
    if (D == 128) return launch_f32<128, 32>(p, st);
    return launch_f32<256, 32>(p, st);
  }
  if (D == 64) return bq == 32 ? launch_bf16<64, 32>(p, st)
                               : launch_bf16<64, 64>(p, st);
  if (D == 128) return bq == 32 ? launch_bf16<128, 32>(p, st)
                                : launch_bf16<128, 64>(p, st);
  return bq == 32 ? launch_bf16<256, 32>(p, st)
                  : launch_bf16<256, 64>(p, st);
}
