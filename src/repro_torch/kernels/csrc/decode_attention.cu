// K2: single-query grouped-query decode attention over a ring KV cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention / _kernel), reached through ops.gqa_decode. For each
// (batch row b, kv head h) the G query heads h*G .. h*G+G-1 attend over the
// row's L cache slots. A slot is live when kv_pos >= 0, kv_pos <= q_pos and,
// with a window, kv_pos > q_pos - window; empty slots hold kv_pos = -1, and
// a wrapped ring needs nothing more, since validity comes from the absolute
// positions. Scores are q.k * D^-1/2 in fp32, then the optional
// softcap * tanh(s / softcap); dead slots are -1e30; the online softmax
// carries (m, l, acc) in fp32; p is rounded to q's type before p @ v (the
// denominator l sums p unrounded) and the output is acc / max(l, 1e-30) in
// q's type, as on the TPU.
//
// Design. One thread block per (b, kv head), of 128 threads (256 at
// D = 256): the TPU's
// sequential kv grid axis becomes a loop over kv tiles of BK = 32 slots
// inside the block. For each tile the first BK threads read the slots'
// positions and the block decides with one __syncthreads_or whether any
// slot is live; a dead tile is skipped before either product and is not
// counted, as the Pallas kernel's pl.when(jnp.any(mask)) and cnt_ref do.
// A live tile's K and V are staged in shared memory as fp32, each element
// rounded to q's type as it is loaded: a cache stored in fp32 under a bf16
// model is thus read as the model's _cache_read_kv(cache, q.dtype) would
// cast it, with no bf16 copy of the cache. The K rows are padded by one
// float so that the 32 lanes of a warp, each scoring one slot against the
// same query head, read distinct banks. Then one warp per query head takes
// the tile's max and sum with shuffles and updates (m, l); and each thread
// owns one output column d of one head's accumulators (D = 256 or 128; two
// heads' at D = 64), for every query head of its group, in registers and
// adds sum_j p_j v_j. The K, V and q tiles live in dynamic shared memory:
// (32 * (D + 1) + 32 * D + 16 * D) * 4 bytes, 82 KB at D = 256, over the
// 48 KB a static array may take, so the launch raises the kernel's dynamic
// limit first. Inputs are read in the
// (B, L, Hkv, D) layout through their strides, so the caller makes no
// transpose, repeat or pad copies; the ragged last tile is masked here.
// q and the cache may each be fp32 or bf16; D in {64, 128, 256}; G <= 16.
//
// Bound. Decode attention reads the whole live cache once and does 4 flops
// per cached element per query head of its group: at Qwen2-0.5B's serving
// shape (B = 32, L = 144 slots, 2 kv heads of 64, fp32 cache, G = 7) that
// is 4.7 MB, 1.4 us at 3.35 TB/s, against 17 MFLOP, so the kernel is bound
// by memory by far. This first version issues plain loads with no copy
// pipelining and its grid has only B * Hkv blocks (64 at B = 32, 2 at
// B = 1, on 132 SMs), so it runs well above that bound (PERF.md has its
// times). RecurrentGemma's local layers have one kv head, so there the grid
// is B blocks: 32 at B = 32, a known limit (bound: the 16 query heads of
// 256 and an fp32 ring of 144 slots at B = 32, 9.7 MB, 0.003 ms).
// Splitting the ring over several blocks per (b, kv head) (flash-decoding)
// would fill the card but changes the order of the reduction; it is later
// work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;            // kv slots per tile (= one warp)
constexpr int MAXG = 16;          // query heads per kv head

// threads per block: one output column each, for D <= 128 at least 128
template <int D>
__host__ __device__ constexpr int nthreads() { return D > 128 ? D : 128; }

// the K, V and q tiles in dynamic shared memory, bytes
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return (BK * (D + 1) + BK * D + MAXG * D) * static_cast<int>(sizeof(float));
}
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* kv_pos;
  void* o;
  int* visits;
  long long q_sb, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long p_sb, p_sl;
  int Hq, Hkv, G, L, window;      // window <= 0: no window
  float softcap, scale;           // softcap <= 0: no softcap
};

__device__ __forceinline__ float to_float(float x) { return x; }

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  // bf16 -> fp32 is exact: the 16 bits become the high half of the float
  return __uint_as_float(static_cast<uint32_t>(__bfloat16_as_ushort(x))
                         << 16);
}

// x rounded to the query's type (round to nearest even for bf16)
__device__ __forceinline__ float as_q_type(float x, const float*) {
  return x;
}

__device__ __forceinline__ float as_q_type(float x, const __nv_bfloat16*) {
  return __uint_as_float(
      static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)))
      << 16);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(nthreads<D>()) decode_fwd(Params p) {
  constexpr int NT = nthreads<D>();
  constexpr int RPP = NT / D;              // heads per pass of the block
  constexpr int NACC = MAXG / RPP;         // accumulators per thread
  extern __shared__ float smem[];
  float (*Ks)[D + 1] = reinterpret_cast<float (*)[D + 1]>(smem);
  float (*Vs)[D] = reinterpret_cast<float (*)[D]>(smem + BK * (D + 1));
  float (*Qs)[D] =
      reinterpret_cast<float (*)[D]>(smem + BK * (D + 1) + BK * D);
  __shared__ float Ps[MAXG][BK];
  __shared__ float m_s[MAXG], l_s[MAXG], corr_s[MAXG];
  __shared__ int live_s[BK];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / p.Hkv;
  const int hk = bh % p.Hkv;
  const int G = p.G;
  const int q_pos = p.q_pos[b];

  const TQ* qb = static_cast<const TQ*>(p.q) + b * p.q_sb +
                 static_cast<long long>(hk) * G * p.q_sh;
  const TKV* kb = static_cast<const TKV*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const TKV* vb = static_cast<const TKV*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int* pb = p.kv_pos + b * p.p_sb;

  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    Qs[g][d] = to_float(qb[g * p.q_sh + d]);
  }
  if (tid < MAXG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int d_out = tid % D;               // this thread's output column
  const int g_first = tid / D;             // and its first head
  float acc[NACC];
#pragma unroll
  for (int a = 0; a < NACC; ++a) acc[a] = 0.f;

  int visits = 0;
  for (int j0 = 0; j0 < p.L; j0 += BK) {
    int ok = 0;
    if (tid < BK && j0 + tid < p.L) {
      const int kp = pb[(j0 + tid) * p.p_sl];
      ok = kp >= 0 && kp <= q_pos && (p.window <= 0 || kp > q_pos - p.window);
    }
    if (tid < BK) live_s[tid] = ok;
    // a barrier for every thread; no slot of the tile live -> skip it
    if (!__syncthreads_or(ok)) continue;

    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D;
      const int j = j0 + r;
      float kk = 0.f, vv = 0.f;
      if (j < p.L) {
        kk = as_q_type(to_float(kb[j * p.k_sl + d]), qb);
        vv = as_q_type(to_float(vb[j * p.v_sl + d]), qb);
      }
      Ks[r][d] = kk;
      Vs[r][d] = vv;
    }
    __syncthreads();

    {  // scores: lane j of warp w scores slot j against heads w, w + 4, ..
      const int j = tid % BK;
      for (int g = tid / BK; g < G; g += NT / BK) {
        float s = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) s += Qs[g][d] * Ks[j][d];
        s *= p.scale;
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        Ps[g][j] = live_s[j] ? s : kNegInf;
      }
    }
    __syncthreads();

    {  // online softmax: warp w updates (m, l) of heads w, w + 4, ..
      const int warp = tid / 32, lane = tid % 32;
      for (int g = warp; g < G; g += NT / 32) {
        const float s = Ps[g][lane];
        float mt = s;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mt);
        const float pj = expf(s - m_new);
        float ps = pj;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, off);
        const float c = expf(m_old - m_new);
        Ps[g][lane] = as_q_type(pj, qb);
        __syncwarp();
        if (lane == 0) {
          m_s[g] = m_new;
          l_s[g] = l_s[g] * c + ps;
          corr_s[g] = c;
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < NACC; ++a) {        // acc = acc * corr + p @ v
      const int g = g_first + a * RPP;
      if (g < G) {
        float pv = 0.f;
#pragma unroll 8
        for (int j = 0; j < BK; ++j) pv += Ps[g][j] * Vs[j][d_out];
        acc[a] = acc[a] * corr_s[g] + pv;
      }
    }
    ++visits;
    __syncthreads();                       // the tile is overwritten next
  }
  __syncthreads();

  TQ* ob = static_cast<TQ*>(p.o) +
           (static_cast<long long>(b) * p.Hq + hk * G) * D;
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    const int g = g_first + a * RPP;
    if (g < G) store(ob + g * D + d_out, acc[a] / fmaxf(l_s[g], 1e-30f));
  }
  if (tid == 0) p.visits[bh] = visits;
}

template <typename TQ, typename TKV, int D>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  if (bytes > 48 * 1024) {
    // once per kernel instance (thread-safe static initialisation)
    static const cudaError_t attr = cudaFuncSetAttribute(
        decode_fwd<TQ, TKV, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  decode_fwd<TQ, TKV, D><<<dim3(B * p.Hkv), nthreads<D>(), bytes, stream>>>(
      p);
  return 0;
}

template <typename TQ, typename TKV>
int dispatch(const Params& p, int B, int D, cudaStream_t stream) {
  if (D == 64) return launch<TQ, TKV, 64>(p, B, stream);
  if (D == 128) return launch<TQ, TKV, 128>(p, B, stream);
  if (D == 256) return launch<TQ, TKV, 256>(p, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int decode_attention_block_k(void) { return BK; }
extern "C" int decode_attention_max_g(void) { return MAXG; }

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16. Strides are in elements;
// the head-dim stride must be 1. The output is (B, 1, Hq, D) contiguous,
// visits (B * Hkv,). Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, void* o, int* visits, int q_dtype, int kv_dtype,
    int D, int B, int Hq, int Hkv, int L, int window, float softcap,
    float scale, long long q_sb, long long q_sh, long long k_sb,
    long long k_sl, long long k_sh, long long v_sb, long long v_sl,
    long long v_sh, long long p_sb, long long p_sl, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.q_pos = q_pos; p.kv_pos = kv_pos;
  p.o = o; p.visits = visits;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.p_sb = p_sb; p.p_sl = p_sl;
  p.Hq = Hq; p.Hkv = Hkv; p.G = Hq / Hkv; p.L = L; p.window = window;
  p.softcap = softcap; p.scale = scale;
  if (p.G < 1 || p.G > MAXG || Hq % Hkv != 0 || B < 1 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (q_dtype == 0 && kv_dtype == 0) rc = dispatch<float, float>(p, B, D, st);
  else if (q_dtype == 0 && kv_dtype == 1)
    rc = dispatch<float, __nv_bfloat16>(p, B, D, st);
  else if (q_dtype == 1 && kv_dtype == 0)
    rc = dispatch<__nv_bfloat16, float>(p, B, D, st);
  else if (q_dtype == 1 && kv_dtype == 1)
    rc = dispatch<__nv_bfloat16, __nv_bfloat16>(p, B, D, st);
  else rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
