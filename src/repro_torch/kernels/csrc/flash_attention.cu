// K1: block-wise online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel). Same function: softmax(q k^T * D^-1/2) v with
// optional causal mask, sliding window, logit softcap, grouped-query heads
// (query head h reads kv head h / (Hq / Hkv)) and a kv_len bound that masks
// padded kv columns. Dead kv tiles outside the live range [lo(qi), hi(qi)]
// are skipped exactly, and the number of tiles each block scored is written
// to `visits` (one int32 per (b*Hq + h, q tile)).
//
// Design. One thread block per (b*Hq + h, q tile of BQ rows). The TPU's
// sequential kv grid axis becomes the loop over kv tiles inside the block.
// TPR neighbouring threads share one query row (4 for D = 64 and 128, 8 for
// D = 256): each keeps 1/TPR of the row's q and of its fp32 output
// accumulator in registers, as float4 chunks interleaved so that the TPR
// threads read neighbouring shared memory words. At D = 256 four threads a
// row would hold 64 q and 64 accumulator floats each beside the 32 scores
// and spill; eight hold 32 and 32, for one more shuffle per score. K and V
// tiles (BK = 32 rows) are staged in dynamic shared memory as fp32: 64 KB at
// D = 256, over the 48 KB a static array may take, so the launch raises the
// kernel's dynamic limit first. A score is the TPR partial dot products
// summed with log2(TPR) warp shuffles. The running max m, denominator l
// and accumulator stay in fp32; p is rounded to the input type for the
// p @ v product and the output is acc / max(l, 1e-30), as on the TPU. Masked scores are -1e30, not -inf, so
// the arithmetic on fully masked rows matches the TPU kernel and the plain
// PyTorch version in flash_attention.py.
//
// Inputs are read in the (B, S, H, D) layout through their strides, so the
// caller makes no transpose, reshape or pad copies; the ragged Sq and Skv
// edges are masked here. fp32 and bf16 inputs, D in {64, 128, 256}, BQ in
// {32, 64} for D <= 128 and 32 for D = 256: at BQ = 64 the D = 256 block
// has 512 threads, which get at most 128 registers each, and ptxas spilled
// (160 bytes a thread in bf16); at BQ = 32 it takes 183, with no spill.
//
// Bound. At the encoder's serving shape (B=32, S=128, 12 heads of 64, bf16)
// q, k, v and o are 4 x 32*128*12*64*2 B = 25.2 MB: 7.5 us at 3.35 TB/s,
// against 4*32*12*128*128*64 = 1.61 GFLOP, 1.6 us at 989 TFLOP/s. So at
// serving lengths the kernel is bound by memory. This first version does the
// products on the CUDA cores in fp32 with no tensor cores and no copy
// pipelining, so it runs well above that bound (PERF.md has its times);
// mma/wgmma tiles and TMA-fed double buffering are the later step. At
// RecurrentGemma's local layers (B=32, S=128, 16 query heads and one kv head
// of 256, bf16) the bytes are 2*32*128*16*256*2 + 2*32*128*256*2 B =
// 71.3 MB, 0.021 ms, and the causal products 2.2 GFLOP, 0.002 ms: bound by
// memory too.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;            // kv rows per tile
constexpr float kNegInf = -1e30f;

// threads per query row
template <int D>
__host__ __device__ constexpr int tpr() { return D == 256 ? 8 : 4; }

// the K and V tiles in dynamic shared memory, bytes
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * BK * D * static_cast<int>(sizeof(float));
}

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

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  // bf16 -> fp32 is exact: the 16 bits become the high half of the float
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

// p in the working type: the TPU kernel casts p to v's type before the
// p @ v product (the denominator l sums p unrounded).
__device__ __forceinline__ float as_input_type(float x, const float*) {
  return x;
}

__device__ __forceinline__ float as_input_type(float x,
                                               const __nv_bfloat16*) {
  return __uint_as_float(
      static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)))
      << 16);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  uint2 raw;
  raw.x = pack_bf16x2(x.x, x.y);
  raw.y = pack_bf16x2(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(BQ * tpr<D>()) flash_fwd(Params p) {
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

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 qv[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = 4 * (sub + TPR * c);
    qv[c] = q_ok ? load4(qb + q_pos * p.q_ss + col) : zero;
    acc[c] = zero;
  }
  float m = kNegInf, l = 0.f;

  // live kv tiles of this q tile (flash_attention.py: _lo_block/_hi_block)
  int lo = 0;
  if (p.window > 0) {
    const int t = qi * BQ - (p.window - 1);
    lo = t > 0 ? t / BK : 0;
  }
  int hi = p.n_kv - 1;
  if (p.causal) hi = min(hi, (qi * BQ + BQ - 1) / BK);

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
      float x = part * p.scale;
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      const int kp = k0 + j;
      bool ok = kp < p.kv_len;
      if (p.causal) ok = ok && kp <= q_pos;
      if (p.window > 0) ok = ok && kp > q_pos - p.window;
      s[j] = ok ? x : kNegInf;
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
      const float pv = as_input_type(pj, vb);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[j][4 * (sub + TPR * c)]);
        acc[c].x += pv * vv.x;
        acc[c].y += pv * vv.y;
        acc[c].z += pv * vv.z;
        acc[c].w += pv * vv.w;
      }
    }
    l = l * corr + psum;
    m = m_new;
    ++visits;
    __syncthreads();                       // tiles are overwritten next
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
  if (q_ok) {
    T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + q_pos * p.o_ss;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float4 a = acc[c];
      store4(ob + 4 * (sub + TPR * c),
             make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
    }
  }
  if (tid == 0) p.visits[bh * p.n_q + qi] = visits;
}

template <typename T, int D, int BQ>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  if (bytes > 48 * 1024) {
    // once per kernel instance (thread-safe static initialisation)
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_fwd<T, D, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  const dim3 grid(p.n_q, B * p.Hq);
  flash_fwd<T, D, BQ><<<grid, BQ * tpr<D>(), bytes, stream>>>(p);
  return 0;
}

template <typename T>
int dispatch(const Params& p, int B, int D, int bq, cudaStream_t stream) {
  if (D == 64 && bq == 32) return launch<T, 64, 32>(p, B, stream);
  if (D == 64 && bq == 64) return launch<T, 64, 64>(p, B, stream);
  if (D == 128 && bq == 32) return launch<T, 128, 32>(p, B, stream);
  if (D == 128 && bq == 64) return launch<T, 128, 64>(p, B, stream);
  if (D == 256 && bq == 32) return launch<T, 256, 32>(p, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int flash_attention_block_k(void) { return BK; }

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head-dim
// stride must be 1. Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int* visits,
    int dtype, int D, int bq, int B, int Hq, int Hkv, int Sq, int Skv,
    int kv_len, int causal, int window, float softcap, float scale,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.visits = visits;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.Hq = Hq; p.Hkv = Hkv; p.Sq = Sq; p.Skv = Skv; p.kv_len = kv_len;
  p.causal = causal; p.window = window;
  p.softcap = softcap; p.scale = scale;
  p.n_kv = (kv_len + BK - 1) / BK;
  p.n_q = (Sq + bq - 1) / bq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) rc = dispatch<float>(p, B, D, bq, st);
  else if (dtype == 1) rc = dispatch<__nv_bfloat16>(p, B, D, bq, st);
  else rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
