// K1: block-wise online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel). Same function: softmax(q k^T * D^-1/2) v with
// optional causal mask, sliding window, logit softcap, grouped-query heads
// (query head h reads kv head h / (Hq / Hkv)) and a kv_len bound that masks
// padded kv columns. Dead kv tiles outside the live range [lo(qi), hi(qi)]
// are skipped exactly, and the number of tiles each block scored is written
// to `visits` (one int32 per (b*Hq + h, q tile)). Scores are fp32, masked
// ones -1e30 (not -inf, so a fully masked row does the TPU kernel's and the
// plain version's arithmetic), (m, l, acc) fp32, p rounded to the input
// type for p @ v while l sums it unrounded, output acc / max(l, 1e-30).
//
// Two kernels, one per input type. Both take one thread block per
// (b*Hq + h, q tile of BQ rows); the TPU's sequential kv grid axis becomes
// the loop over kv tiles inside the block. Inputs are read in the
// (B, S, H, D) layout through their strides (no transpose, reshape or pad
// copies); the ragged Sq and Skv edges are masked here. D in {64, 128, 256}.
//
// bf16 (the serving path): tensor cores, FlashAttention-2 style. Each warp
// owns 16 query rows (BQ = 32 or 64: 2 or 4 warps). Q (BQ x D) and two stages
// of K and V tiles (BK x D; BK = 64, or 32 at D = 256) stay bf16 in shared
// memory, rows padded by 16 bytes so that ldmatrix's eight row addresses fall
// in distinct banks, filled by cp.async 16 bytes a thread (zero-filled past Sq
// and Skv). The copy of tile j+1 is issued right after the one __syncthreads
// of tile j and runs while tile j is computed (two tiles loading ahead were no
// faster on the card). S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 with
// fp32 accumulators: Q fragments by ldmatrix (re-read from shared memory each
// k-step rather than held, which at D = 256 would add 64 registers to the 128
// of the output accumulators), K by ldmatrix, V by ldmatrix.trans. The softmax
// works on the C fragments (row lane/4 + 8i, column 2(lane%4) + j): each
// thread masks against the column bounds [col_lo, col_hi] of its two rows
// (kv_len, causal, window) with no branch, takes row max and sum with quad
// shuffles, and exponentiates differences of scores as 2^(x log2 e) on the
// special-function unit. P goes from the C fragments of S to the A fragments
// of P V by packing to bf16 in registers, which is the reference's "p rounded
// to v's type". The output acc / max(l, 1e-30), one reciprocal a row and a
// Newton-corrected product an element, goes out through the warp's own Q rows
// in 16-byte chunks. At D = 256 the 32-row kv tile keeps the scores at 16
// registers and two 99 KB blocks on an SM. Slower on the card: a separate
// unmasked path for interior tiles and skipping a warp's fully masked causal
// tiles (branches around the unrolled tile code), and a 128-row q or kv tile
// at D = 64.
//
// fp32 (the reference-precision checks, TF32 off): full fp32 FMAs on the
// CUDA cores, never TF32. TPR neighbouring threads share one query row (4
// for D = 64 and 128, 8 for D = 256), each keeping 1/TPR of the row's q
// and accumulator in registers; K and V tiles of BK = 32 rows are staged
// in dynamic shared memory; a score is the TPR partial dot products summed
// with warp shuffles. BQ in {32, 64} for D <= 128 and 32 for D = 256 (a
// 64-row tile's 512 threads spilled).
//
// Bound. At the encoder's serving shape (B=32, S=128, 12 heads of 64, bf16)
// q, k, v and o are 4 x 32*128*12*64*2 B = 25.2 MB: 7.5 us at 3.35 TB/s,
// against 4*32*12*128*128*64 = 1.61 GFLOP, 1.6 us at 989 TFLOP/s. At
// RecurrentGemma's local layers (B=32, S=128, 16 query heads and one kv
// head of 256, bf16, causal) 71.3 MB, 0.021 ms, against 2.2 GFLOP, 0.002
// ms. So at serving lengths the kernel is bound by memory, and the bf16
// design's job is to keep its tiles bf16, keep copies in flight and fill
// the card rather than to reach the tensor cores' peak. Measured by python3
// chip_smoke.py (phases 5 and 19) on an NVIDIA H100 80GB HBM3 at 700 W, by
// device time with a warm L2: 0.0170 ms at the encoder's shape (SDPA 0.0093
// ms) and 0.0503 ms at the local layers' (SDPA 0.0355 ms). PERF.md keeps
// the times of each run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BK_F32 = 32;        // kv rows per tile, fp32 kernel
constexpr float kNegInf = -1e30f;

// kv rows per tile of the bf16 kernel
__host__ __device__ constexpr int bk_bf16(int D) { return D == 256 ? 32 : 64; }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int* visits;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int Hq, Hkv, Sq, Skv, kv_len;
  int causal, window;             // window <= 0: no window
  float softcap, scale;           // softcap <= 0: no softcap
  int n_kv, n_q;                  // live kv tiles, q tiles
};

// live kv tiles [lo, hi] of the q tile starting at row q0
// (flash_attention.py: _lo_block/_hi_block)
__device__ __forceinline__ void live_range(const Params& p, int q0, int bq,
                                           int bk, int* lo, int* hi) {
  *lo = 0;
  if (p.window > 0) {
    const int t = q0 - (p.window - 1);
    *lo = t > 0 ? t / bk : 0;
  }
  *hi = p.n_kv - 1;
  if (p.causal) *hi = min(*hi, (q0 + bq - 1) / bk);
}

__device__ __forceinline__ float score(const Params& p, float acc, int q_pos,
                                       int kp) {
  float x = acc * p.scale;
  if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
  bool ok = kp < p.kv_len;
  if (p.causal) ok = ok && kp <= q_pos;
  if (p.window > 0) ok = ok && kp > q_pos - p.window;
  return ok ? x : kNegInf;
}

// ------------------------------------------------------------------ fp32

// threads per query row
template <int D>
__host__ __device__ constexpr int tpr() { return D == 256 ? 8 : 4; }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

template <int D, int BQ>
__global__ void __launch_bounds__(BQ * tpr<D>()) flash_fwd_f32(Params p) {
  constexpr int BK = BK_F32;
  constexpr int TPR = tpr<D>();
  constexpr int NT = BQ * TPR;             // threads per block
  constexpr int C = D / (4 * TPR);         // float4 chunks per thread
  extern __shared__ __align__(16) float smem[];
  float (*Ks)[D] = reinterpret_cast<float (*)[D]>(smem);
  float (*Vs)[D] = reinterpret_cast<float (*)[D]>(smem + BK * D);

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;
  const int qi = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.Hq;
  const int h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q_pos = qi * BQ + row;
  const bool q_ok = q_pos < p.Sq;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 qv[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = 4 * (sub + TPR * c);
    qv[c] = q_ok ? load4(qb + q_pos * p.q_ss + col) : zero;
    acc[c] = zero;
  }
  float m = kNegInf, l = 0.f;
  int lo, hi;
  live_range(p, qi * BQ, BQ, BK, &lo, &hi);

  int visits = 0;
  for (int kt = lo; kt <= hi; ++kt) {
    const int k0 = kt * BK;
    for (int idx = tid; idx < BK * D / 4; idx += NT) {
      const int r = idx / (D / 4);
      const int c4 = (idx % (D / 4)) * 4;
      const int kp = k0 + r;
      float4 kk = zero, vv = zero;
      if (kp < p.Skv) {
        kk = load4(kb + kp * p.k_ss + c4);
        vv = load4(vb + kp * p.v_ss + c4);
      }
      store4(&Ks[r][c4], kk);
      store4(&Vs[r][c4], vv);
    }
    __syncthreads();

    float s[BK];
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&Ks[j][4 * (sub + TPR * c)]);
        part += qv[c].x * kk.x + qv[c].y * kk.y + qv[c].z * kk.z +
                qv[c].w * kk.w;
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      s[j] = score(p, part, q_pos, k0 + j);
      m_tile = fmaxf(m_tile, s[j]);
    }

    const float m_new = fmaxf(m, m_tile);
    const float corr = expf(m - m_new);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c].x *= corr;
      acc[c].y *= corr;
      acc[c].z *= corr;
      acc[c].w *= corr;
    }
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float pj = expf(s[j] - m_new);
      psum += pj;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[j][4 * (sub + TPR * c)]);
        acc[c].x += pj * vv.x;
        acc[c].y += pj * vv.y;
        acc[c].z += pj * vv.z;
        acc[c].w += pj * vv.w;
      }
    }
    l = l * corr + psum;
    m = m_new;
    ++visits;
    __syncthreads();                       // tiles are overwritten next
  }

  const float den = fmaxf(l, 1e-30f);
  if (q_ok) {
    float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh +
                q_pos * p.o_ss;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float4 a = acc[c];
      store4(ob + 4 * (sub + TPR * c),
             make_float4(a.x / den, a.y / den, a.z / den, a.w / den));
    }
  }
  if (tid == 0) p.visits[bh * p.n_q + qi] = visits;
}

// ------------------------------------------------------------------ bf16

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

// e^x as 2^(x log2 e) on the special-function unit. x is a difference
// of two scores, so a fully masked row's -1e30 - (-1e30) is exactly 0 and
// gives exactly 1, as expf does.
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// a / den from inv = 1 / den: the product, corrected by one Newton step
// to the correctly rounded quotient (an IEEE division per element was
// slow, and the bare product rounds some outputs to another bf16)
__device__ __forceinline__ float quotient(float a, float den, float inv) {
  const float q = a * inv;
  return fmaf(fmaf(-q, den, a), inv, q);
}

// (lo, hi) rounded to bf16 in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// shared memory of the bf16 kernel: Q and two stages of K and V, rows of
// D + 8 elements
template <int D, int BQ>
__host__ __device__ constexpr int smem_bytes_bf16() {
  return (BQ + 4 * bk_bf16(D)) * (D + 8) * 2;
}

// rows [r0, r0 + R) of a (rows, D) bf16 matrix into shared memory rows of
// LD elements; rows at or past n are zero-filled
template <int D, int R, int NT>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int r0, int n,
                                          int tid) {
  constexpr int LD = D + 8;
  constexpr int PER_ROW = D / 8;           // 16-byte chunks
#pragma unroll
  for (int i = tid; i < R * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * LD + c, src + (ok ? r0 + r : 0) * stride + c, ok);
  }
}

// (minimum one block an SM: without it ptxas capped the D = 64 and 128
// instances below their need and spilled)
template <int D, int NWARP>
__global__ void __launch_bounds__(NWARP * 32, 1) flash_fwd_bf16(Params p) {
  constexpr int BQ = 16 * NWARP;
  constexpr int NT = NWARP * 32;
  constexpr int BK = bk_bf16(D);
  constexpr int LD = D + 8;                // padded row, elements
  constexpr int NS = BK / 8;               // 8-column tiles of S
  constexpr int NO = D / 8;                // 8-column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs =                      // [BQ][LD]
      reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* KV = Qs + BQ * LD;        // [stage][K | V][BK][LD]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int qi = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.Hq;
  const int h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qi * BQ;

  const __nv_bfloat16* qb =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // K and V of tile t into stage s, as one cp.async group
  auto load_kv = [&](int s, int t) {
    __nv_bfloat16* dst = KV + s * 2 * BK * LD;
    load_rows<D, BK, NT>(dst, kb, p.k_ss, t * BK, p.Skv, tid);
    load_rows<D, BK, NT>(dst + BK * LD, vb, p.v_ss, t * BK, p.Skv, tid);
    cp_async_commit();
  };
  int lo, hi;
  live_range(p, q0, BQ, BK, &lo, &hi);
  if (lo <= hi) {                          // Q with the first tile
    load_rows<D, BQ, NT>(Qs, qb, p.q_ss, q0, p.Sq, tid);
    load_kv(0, lo);
  }

  // this thread's rows of the warp's 16: lane/4 and lane/4 + 8, and the
  // kv columns [col_lo, col_hi] each may see (kv_len, causal, window)
  const int qr[2] = {q0 + warp * 16 + lane / 4, q0 + warp * 16 + lane / 4 + 8};
  int col_lo[2], col_hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    col_hi[i] = p.causal ? min(p.kv_len - 1, qr[i]) : p.kv_len - 1;
    col_lo[i] = p.window > 0 ? qr[i] - p.window + 1 : 0;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  int visits = 0;
  for (int kt = lo; kt <= hi; ++kt) {
    const int stage = (kt - lo) & 1;
    cp_async_wait_all();
    __syncthreads();   // tile kt visible; every warp is done with kt - 1
    if (kt < hi) load_kv(stage ^ 1, kt + 1);  // in flight during tile kt
    const __nv_bfloat16* Ks = KV + stage * 2 * BK * LD;
    const __nv_bfloat16* Vs = Ks + BK * LD;
    const int c0 = kt * BK;
    // S = Q K^T for the warp's 16 rows
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, Qs + (warp * 16 + lane % 16) * LD + kk +
                         (lane / 16) * 8);
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t bb[4];
        ldmatrix_x4(bb, Ks + (n * 8 + lane % 8 + (lane / 16) * 8) * LD + kk +
                            ((lane / 8) % 2) * 8);
        mma_bf16(s[n], a, bb[0], bb[1]);
        mma_bf16(s[n + 1], a, bb[2], bb[3]);
      }
    }

    // scale, softcap, mask; row max over the quad
    const int k0 = c0 + 2 * (lane % 4);
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        const int kp = k0 + n * 8 + (e & 1);
        s[n][e] = kp >= col_lo[e / 2] && kp <= col_hi[e / 2] ? x : kNegInf;
        mt[e / 2] = fmaxf(mt[e / 2], s[n][e]);
      }
    }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m[i], mt[i]);
      corr[i] = fast_exp(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = fast_exp(s[n][e] - m[e / 2]);
        psum[e / 2] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
      l[i] = l[i] * corr[i] + psum[i];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: P's C fragments become A fragments, rounded to bf16
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * ks][0], s[2 * ks][1]);
      a[1] = pack_bf16x2(s[2 * ks][2], s[2 * ks][3]);
      a[2] = pack_bf16x2(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      a[3] = pack_bf16x2(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bb[4];
        const int vr = ks * 16 + lane % 8 + ((lane / 8) % 2) * 8;
        ldmatrix_x4_trans(bb, Vs + vr * LD + n * 8 + (lane / 16) * 8);
        mma_bf16(acc[n], a, bb[0], bb[1]);
        mma_bf16(acc[n + 1], a, bb[2], bb[3]);
      }
    }
    ++visits;
  }

  // the output through the warp's own Q rows (no other warp reads them),
  // then out in 16-byte row chunks
  __nv_bfloat16* Os = Qs + warp * 16 * LD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float den = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / den;
    uint32_t* orow = reinterpret_cast<uint32_t*>(
        Os + (lane / 4 + 8 * i) * LD + 2 * (lane % 4));
#pragma unroll
    for (int n = 0; n < NO; ++n)
      orow[n * 4] = pack_bf16x2(quotient(acc[n][2 * i], den, inv),
                                quotient(acc[n][2 * i + 1], den, inv));
  }
  __syncwarp();
  __nv_bfloat16* ob =
      static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int idx = lane; idx < 16 * (D / 8); idx += 32) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const int row = q0 + warp * 16 + r;
    if (row < p.Sq)
      *reinterpret_cast<uint4*>(ob + row * p.o_ss + c) =
          *reinterpret_cast<const uint4*>(Os + r * LD + c);
  }
  if (tid == 0) p.visits[bh * p.n_q + qi] = visits;
}

// ---------------------------------------------------------------- launch

template <typename K>
int raise_smem_limit(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int D, int BQ>
int launch_f32(const Params& p, int B, cudaStream_t stream) {
  constexpr int bytes = 2 * BK_F32 * D * static_cast<int>(sizeof(float));
  // once per kernel instance (thread-safe static initialisation)
  static const int attr = raise_smem_limit(flash_fwd_f32<D, BQ>, bytes);
  if (attr != 0) return attr;
  const dim3 grid(p.n_q, B * p.Hq);
  flash_fwd_f32<D, BQ><<<grid, BQ * tpr<D>(), bytes, stream>>>(p);
  return 0;
}

template <int D, int BQ>
int launch_bf16(const Params& p, int B, cudaStream_t stream) {
  constexpr int bytes = smem_bytes_bf16<D, BQ>();
  static const int attr =
      raise_smem_limit(flash_fwd_bf16<D, BQ / 16>, bytes);
  if (attr != 0) return attr;
  const dim3 grid(p.n_q, B * p.Hq);
  flash_fwd_bf16<D, BQ / 16><<<grid, BQ * 2, bytes, stream>>>(p);
  return 0;
}

int dispatch_f32(const Params& p, int B, int D, int bq, cudaStream_t st) {
  if (D == 64 && bq == 32) return launch_f32<64, 32>(p, B, st);
  if (D == 64 && bq == 64) return launch_f32<64, 64>(p, B, st);
  if (D == 128 && bq == 32) return launch_f32<128, 32>(p, B, st);
  if (D == 128 && bq == 64) return launch_f32<128, 64>(p, B, st);
  if (D == 256 && bq == 32) return launch_f32<256, 32>(p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch_bf16(const Params& p, int B, int D, int bq, cudaStream_t st) {
  if (D == 64 && bq == 32) return launch_bf16<64, 32>(p, B, st);
  if (D == 64 && bq == 64) return launch_bf16<64, 64>(p, B, st);
  if (D == 128 && bq == 32) return launch_bf16<128, 32>(p, B, st);
  if (D == 128 && bq == 64) return launch_bf16<128, 64>(p, B, st);
  if (D == 256 && bq == 32) return launch_bf16<256, 32>(p, B, st);
  if (D == 256 && bq == 64) return launch_bf16<256, 64>(p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The kv tile of the kernel for (dtype, D): 0 = float32, 1 = bfloat16;
// 0 if it is not built.
extern "C" int flash_attention_block_k(int dtype, int D) {
  if (D != 64 && D != 128 && D != 256) return 0;
  if (dtype == 0) return BK_F32;
  if (dtype == 1) return bk_bf16(D);
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head-dim
// stride must be 1 and rows 16-byte aligned. Returns cudaGetLastError()
// after the launch (0 = ok).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int* visits,
    int dtype, int D, int bq, int B, int Hq, int Hkv, int Sq, int Skv,
    int kv_len, int causal, int window, float softcap, float scale,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    void* stream) {
  const int bk = flash_attention_block_k(dtype, D);
  if (bk == 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.visits = visits;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Skv = Skv; p.kv_len = kv_len;
  p.causal = causal; p.window = window;
  p.softcap = softcap; p.scale = scale;
  p.n_kv = (kv_len + bk - 1) / bk;
  p.n_q = (Sq + bq - 1) / bq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = dtype == 0 ? dispatch_f32(p, B, D, bq, st)
                            : dispatch_bf16(p, B, D, bq, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
