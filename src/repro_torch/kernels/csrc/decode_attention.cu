// K2: single-query grouped-query decode attention over a ring KV cache, for
// Hopper (sm_90a), split over the ring (flash-decoding).
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
// Design. Two launches. decode_split runs a grid of (B * Hkv, n_split)
// blocks (256 threads; 128 at D = 64, so that four share an SM): the TPU's
// sequential kv grid axis becomes, for each split, a loop over a
// contiguous run of `per_split` tiles of BK = 32 slots. n_split is chosen
// on the host from the shapes alone (decode_attention.py: decode_splits),
// so that B = 32 rows fill the 132 SMs even with one kv head. Every warp
// reads the positions of the next tile itself and takes a ballot of its
// live slots, so a dead tile is skipped before any load or product and is
// not counted, as the Pallas kernel's pl.when(jnp.any(mask)) and cnt_ref
// do. A live tile's K and V rows are copied in their stored type (fp32 or
// bf16) into shared memory with cp.async, 16 bytes a thread, zero-filled
// past L; the copy of the next live tile is issued before the current
// tile's math (two stages when a split has more than one tile). Each
// element is rounded to q's type as it is read, so a cache stored in fp32
// under a bf16 model reads as the model's _cache_read_kv(cache, q.dtype)
// would cast it, with no copy. Scores: warp w owns query heads w, w + NW,
// ..; each lane holds D/32 of their q in registers and, per group of 8
// slots, forms partial dot products with its D/32 columns (contiguous,
// conflict-free vector reads; K rounded once for all the warp's heads). A
// transposing butterfly over lane bits 4..2 and two plain shuffle steps
// reduce a group, and four shuffles hand lane j the score of slot j. The
// owning warp updates the head's (m, l) in registers and writes the
// rounded p to shared memory. In p @ v each thread owns one output column
// of one or more heads, reads p four slots at a time, and keeps its
// accumulators in shared memory, which frees registers for the scores
// (they spilled under the 128-register cap of two blocks an SM). Two
// __syncthreads a tile. The split writes its (m, l) per query head and
// its unnormalised acc (G x D fp32) to scratch; a split with no live tile
// writes (-1e30, 0, 0). decode_merge ((B * Hkv, G) blocks of D threads)
// folds the splits: m* = max m_s, l = sum l_s e^(m_s - m*),
// o = sum acc_s e^(m_s - m*) / max(l, 1e-30) in q's type, and sums the
// splits' visit counts. With one split this is the single-pass arithmetic
// exactly. Inputs are read in the (B, L, Hkv, D) layout through their
// strides; the ragged last tile is masked here. q and the cache may each
// be fp32 or bf16; D in {64, 128, 256}; G <= 16.
//
// Bound. Decode attention reads the live cache once and does 4 flops per
// cached element per query head of its group: at Qwen2-0.5B's serving
// shape (B = 32, L = 144 slots, 2 kv heads of 64, fp32 cache, G = 7) that
// is 4.7 MB, 1.4 us at 3.35 TB/s, against 17 MFLOP, and at
// RecurrentGemma's (B = 32, L = 144, one kv head of 256, G = 16, fp32
// ring) 9.7 MB, 2.9 us, against 75 MFLOP: bound by memory, so the design
// fills the card (5 splits of one tile each at both shapes: 320 and 160
// blocks) and keeps copies in flight rather than using tensor cores.
// Measured by python3 chip_smoke.py (phases 9 and 19) on an NVIDIA H100
// 80GB HBM3 at 700 W, both launches by device time with a warm L2: 0.0095
// ms at Qwen2-0.5B's shape (SDPA 0.0089 ms) and 0.0155 ms at
// RecurrentGemma's (SDPA 0.0121 ms). PERF.md keeps the times of each run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;            // kv slots per tile (= one warp)
constexpr int MAXG = 16;          // query heads per kv head
constexpr float kNegInf = -1e30f;

// threads of a split block: one output column of every query head each
// at D = 256, of half of them at D = 128, of a quarter at D = 64, where
// 128-thread blocks let four share an SM
template <int D>
__host__ __device__ constexpr int nthreads() { return D >= 128 ? 256 : 128; }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* kv_pos;
  float* m_part;                  // (B * Hkv, n_split, G)
  float* l_part;                  // (B * Hkv, n_split, G)
  float* acc_part;                // (B * Hkv, n_split, G, D)
  int* visit_part;                // (B * Hkv, n_split)
  long long q_sb, q_sh;
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long p_sb, p_sl;
  int Hkv, G, L, window;          // window <= 0: no window
  int n_split, per_split;         // splits, tiles per split
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

// CH consecutive elements from shared memory as fp32, in vector loads of
// up to 16 bytes (neighbouring lanes read neighbouring chunks: no bank
// conflicts)
template <int CH>
__device__ __forceinline__ void load_cols(const float* s, float* out) {
  if constexpr (CH % 4 == 0) {
#pragma unroll
    for (int i = 0; i < CH / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(s)[i];
      out[4 * i] = x.x; out[4 * i + 1] = x.y;
      out[4 * i + 2] = x.z; out[4 * i + 3] = x.w;
    }
  } else {
    static_assert(CH == 2, "CH is D / 32");
    const float2 x = *reinterpret_cast<const float2*>(s);
    out[0] = x.x; out[1] = x.y;
  }
}

template <int CH>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* s,
                                          float* out) {
  uint32_t w[CH / 2];
  if constexpr (CH == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(s);
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else if constexpr (CH == 4) {
    const uint2 x = *reinterpret_cast<const uint2*>(s);
    w[0] = x.x; w[1] = x.y;
  } else {
    static_assert(CH == 2, "CH is D / 32");
    w[0] = *reinterpret_cast<const uint32_t*>(s);
  }
#pragma unroll
  for (int i = 0; i < CH / 2; ++i) {   // bf16 -> fp32 exactly
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16 bytes global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const uint32_t dst =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The ballot of live slots of tile t (every lane of the warp gets it).
__device__ __forceinline__ uint32_t live_mask(const Params& p, const int* pb,
                                              int q_pos, int t, int lane) {
  const int j = t * BK + lane;
  bool ok = false;
  if (j < p.L) {
    const int kp = pb[j * p.p_sl];
    ok = kp >= 0 && kp <= q_pos && (p.window <= 0 || kp > q_pos - p.window);
  }
  return __ballot_sync(0xffffffffu, ok);
}

// The first tile at or after t, before t_end, with a live slot (t_end if
// none), and its ballot.
__device__ __forceinline__ int next_live(const Params& p, const int* pb,
                                         int q_pos, int t, int t_end,
                                         int lane, uint32_t* mask) {
  for (; t < t_end; ++t) {
    *mask = live_mask(p, pb, q_pos, t, lane);
    if (*mask) return t;
  }
  *mask = 0;
  return t_end;
}

// one tile's K and V rows (raw type) into shared memory
template <typename TKV, int D>
__device__ __forceinline__ void load_tile(TKV* Ks, TKV* Vs, const TKV* kb,
                                          const TKV* vb, const Params& p,
                                          int t, int tid) {
  constexpr int NT = nthreads<D>();
  constexpr int PER_ROW = D * static_cast<int>(sizeof(TKV)) / 16;
  constexpr int EL = 16 / static_cast<int>(sizeof(TKV));
  for (int i = tid; i < BK * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * EL;
    const int j = t * BK + r;
    const bool ok = j < p.L;
    const long long jj = ok ? j : 0;
    cp_async16(Ks + r * D + c, kb + jj * p.k_sl + c, ok);
    cp_async16(Vs + r * D + c, vb + jj * p.v_sl + c, ok);
  }
  cp_async_commit();
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(nthreads<D>(), 512 / nthreads<D>())
    decode_split(Params p) {
  constexpr int NT = nthreads<D>();
  constexpr int NW = NT / 32;              // warps
  constexpr int HPW = MAXG / NW;           // query heads a warp scores
  constexpr int CH = D / 32;               // columns a lane scores
  constexpr int RPP = NT / D;              // heads per pass in p @ v
  constexpr int NACC = MAXG / RPP;         // accumulators per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TKV* kv_s = reinterpret_cast<TKV*>(smem_raw);   // [stage][K | V][BK][D]
  __shared__ __align__(16) float Ps[MAXG][BK];
  __shared__ float corr_s[MAXG];
  // the unnormalised accumulators, each element owned by one thread (kept
  // out of registers, which the scores need)
  __shared__ float acc_s[MAXG][D];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int b = bh / p.Hkv;
  const int hk = bh % p.Hkv;
  const int G = p.G;
  const int q_pos = p.q_pos[b];

  const TQ* qb = static_cast<const TQ*>(p.q) + b * p.q_sb +
                 static_cast<long long>(hk) * G * p.q_sh;
  const TKV* kb = static_cast<const TKV*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const TKV* vb = static_cast<const TKV*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int* pb = p.kv_pos + b * p.p_sb;

  const int n_tiles = (p.L + BK - 1) / BK;
  const int t_begin = split * p.per_split;
  const int t_end = min(n_tiles, t_begin + p.per_split);

  // this warp's heads: q in registers, (m, l) in registers (every lane)
  float qr[HPW][CH];
  float m_h[HPW], l_h[HPW];
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    const int g = warp + hh * NW;
#pragma unroll
    for (int c = 0; c < CH; ++c)
      qr[hh][c] = g < G ? to_float(qb[g * p.q_sh + lane * CH + c]) : 0.f;
    m_h[hh] = kNegInf;
    l_h[hh] = 0.f;
  }
  const int d_out = tid % D;               // this thread's output column
  const int g_first = tid / D;             // and its first head
#pragma unroll
  for (int a = 0; a < NACC; ++a) acc_s[g_first + a * RPP][d_out] = 0.f;

  uint32_t mask;
  int t = next_live(p, pb, q_pos, t_begin, t_end, lane, &mask);
  if (t < t_end)
    load_tile<TKV, D>(kv_s, kv_s + BK * D, kb, vb, p, t, tid);
  int stage = 0, visits = 0;
  while (t < t_end) {
    uint32_t mask_next;
    const int t_next = next_live(p, pb, q_pos, t + 1, t_end, lane,
                                 &mask_next);
    cp_async_wait_all();
    __syncthreads();   // tile t visible; the last tile's reads are done
    if (t_next < t_end) {
      TKV* nxt = kv_s + (stage ^ 1) * 2 * BK * D;
      load_tile<TKV, D>(nxt, nxt + BK * D, kb, vb, p, t_next, tid);
    }
    const TKV* Ks = kv_s + stage * 2 * BK * D;
    const TKV* Vs = Ks + BK * D;

    // scores: per group of 8 slots, each lane's partial dots of its CH
    // columns (K read and rounded once for all of the warp's heads); a
    // transposing butterfly over lane bits 4..2 and two plain steps then
    // leave the group's slot (lane >> 2) & 7 in every lane
    float res[HPW][BK / 8];
#pragma unroll
    for (int grp = 0; grp < BK / 8; ++grp) {
      float part[HPW][8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float kk[CH];
        load_cols<CH>(Ks + (grp * 8 + jj) * D + lane * CH, kk);
#pragma unroll
        for (int c = 0; c < CH; ++c) kk[c] = as_q_type(kk[c], qb);
#pragma unroll
        for (int hh = 0; hh < HPW; ++hh) {
          float sum = 0.f;
          if (warp + hh * NW < G) {
#pragma unroll
            for (int c = 0; c < CH; ++c) sum += qr[hh][c] * kk[c];
          }
          part[hh][jj] = sum;
        }
      }
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh) {
        if (warp + hh * NW < G) {
#pragma unroll
          for (int off = 16, half = 4; off >= 4; off >>= 1, half >>= 1) {
            const bool upper = lane & off;
#pragma unroll
            for (int i = 0; i < half; ++i) {
              const float send = upper ? part[hh][i] : part[hh][i + half];
              const float keep = upper ? part[hh][i + half] : part[hh][i];
              part[hh][i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
            }
          }
          part[hh][0] += __shfl_xor_sync(0xffffffffu, part[hh][0], 2);
          part[hh][0] += __shfl_xor_sync(0xffffffffu, part[hh][0], 1);
        }
        res[hh][grp] = part[hh][0];
      }
    }
    // online softmax of this warp's heads over slot `lane`
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const int g = warp + hh * NW;
      if (g < G) {
        // lane j takes slot j: group j / 8, held by lane (j % 8) * 4
        float s = 0.f;
#pragma unroll
        for (int grp = 0; grp < BK / 8; ++grp) {
          const float x =
              __shfl_sync(0xffffffffu, res[hh][grp], (lane % 8) * 4);
          if (lane / 8 == grp) s = x;
        }
        s *= p.scale;
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        s = (mask >> lane) & 1u ? s : kNegInf;
        float mt = s;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_new = fmaxf(m_h[hh], mt);
        const float pj = expf(s - m_new);
        float ps = pj;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, o);
        const float c = expf(m_h[hh] - m_new);
        Ps[g][lane] = as_q_type(pj, qb);
        if (lane == 0) corr_s[g] = c;
        l_h[hh] = l_h[hh] * c + ps;
        m_h[hh] = m_new;
      }
    }
    __syncthreads();   // p and corr visible

    float pv[NACC];
#pragma unroll
    for (int a = 0; a < NACC; ++a) pv[a] = 0.f;
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {       // p of 4 slots in one load
      float vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        vv[u] = as_q_type(to_float(Vs[(j + u) * D + d_out]), qb);
#pragma unroll
      for (int a = 0; a < NACC; ++a) {
        const int g = g_first + a * RPP;
        if (g < G) {
          const float4 pp = *reinterpret_cast<const float4*>(&Ps[g][j]);
          pv[a] += pp.x * vv[0];
          pv[a] += pp.y * vv[1];
          pv[a] += pp.z * vv[2];
          pv[a] += pp.w * vv[3];
        }
      }
    }
#pragma unroll
    for (int a = 0; a < NACC; ++a) {        // acc = acc * corr + p @ v
      const int g = g_first + a * RPP;
      if (g < G) acc_s[g][d_out] = acc_s[g][d_out] * corr_s[g] + pv[a];
    }
    ++visits;
    t = t_next;
    mask = mask_next;
    stage ^= 1;
  }

  const long long part_row = static_cast<long long>(bh) * p.n_split + split;
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) {
    const int g = warp + hh * NW;
    if (g < G && lane == 0) {
      p.m_part[part_row * G + g] = m_h[hh];
      p.l_part[part_row * G + g] = l_h[hh];
    }
  }
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    const int g = g_first + a * RPP;
    if (g < G)
      p.acc_part[(part_row * G + g) * D + d_out] = acc_s[g][d_out];
  }
  if (tid == 0) p.visit_part[part_row] = visits;
}

// One block of D threads per (b, kv head, query head): fold the splits'
// partials, thread d owning output column d.
template <typename TQ>
__global__ void __launch_bounds__(256) decode_merge(
    const float* m_part, const float* l_part, const float* acc_part,
    const int* visit_part, void* out, int* visits, int G, int D,
    int n_split) {
  const int bh = blockIdx.x, g = blockIdx.y, d = threadIdx.x;
  const long long row0 = static_cast<long long>(bh) * n_split;
  float m = kNegInf;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s)
    m = fmaxf(m, m_part[(row0 + s) * G + g]);
  float l = 0.f, o = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(m_part[(row0 + s) * G + g] - m);
    l += l_part[(row0 + s) * G + g] * w;
    o += acc_part[((row0 + s) * G + g) * D + d] * w;
  }
  store(static_cast<TQ*>(out) + (static_cast<long long>(bh) * G + g) * D + d,
        o / fmaxf(l, 1e-30f));
  if (g == 0 && d == 0) {
    int n = 0;
    for (int s = 0; s < n_split; ++s) n += visit_part[row0 + s];
    visits[bh] = n;
  }
}

template <typename TQ, typename TKV, int D>
int launch(const Params& p, int B, void* out, int* visits,
           cudaStream_t stream) {
  // a second stage only where a split walks more than one tile
  const int stages = p.per_split > 1 ? 2 : 1;
  const int bytes = stages * 2 * BK * D * static_cast<int>(sizeof(TKV));
  constexpr int max_bytes = 2 * 2 * BK * D * static_cast<int>(sizeof(TKV));
  if (max_bytes > 48 * 1024) {
    // once per kernel instance (thread-safe static initialisation)
    static const cudaError_t attr = cudaFuncSetAttribute(
        decode_split<TQ, TKV, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, max_bytes);
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  decode_split<TQ, TKV, D>
      <<<dim3(B * p.Hkv, p.n_split), nthreads<D>(), bytes, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge<TQ><<<dim3(B * p.Hkv, p.G), D, 0, stream>>>(
      p.m_part, p.l_part, p.acc_part, p.visit_part, out, visits, p.G, D,
      p.n_split);
  return 0;
}

template <typename TQ, typename TKV>
int dispatch(const Params& p, int B, int D, void* out, int* visits,
             cudaStream_t stream) {
  if (D == 64) return launch<TQ, TKV, 64>(p, B, out, visits, stream);
  if (D == 128) return launch<TQ, TKV, 128>(p, B, out, visits, stream);
  if (D == 256) return launch<TQ, TKV, 256>(p, B, out, visits, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int decode_attention_block_k(void) { return BK; }
extern "C" int decode_attention_max_g(void) { return MAXG; }

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16. Strides are in elements;
// the head-dim stride must be 1 and the cache's rows 16-byte aligned. The
// output is (B, 1, Hq, D) contiguous, visits (B * Hkv,); m_part, l_part
// (B * Hkv * n_split * G), acc_part (B * Hkv * n_split * G * D) fp32 and
// visit_part (B * Hkv * n_split) int32 are scratch. Returns
// cudaGetLastError() after the two launches (0 = ok).
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* kv_pos, void* o, int* visits, float* m_part, float* l_part,
    float* acc_part, int* visit_part, int q_dtype, int kv_dtype, int D,
    int B, int Hq, int Hkv, int L, int window, int n_split, int per_split,
    float softcap, float scale, long long q_sb, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, long long p_sb, long long p_sl,
    void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.q_pos = q_pos; p.kv_pos = kv_pos;
  p.m_part = m_part; p.l_part = l_part; p.acc_part = acc_part;
  p.visit_part = visit_part;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sl = k_sl; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sl = v_sl; p.v_sh = v_sh;
  p.p_sb = p_sb; p.p_sl = p_sl;
  p.Hkv = Hkv; p.G = Hq / Hkv; p.L = L; p.window = window;
  p.n_split = n_split; p.per_split = per_split;
  p.softcap = softcap; p.scale = scale;
  if (p.G < 1 || p.G > MAXG || Hq % Hkv != 0 || B < 1 || L < 1 ||
      n_split < 1 || per_split < 1 || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (q_dtype == 0 && kv_dtype == 0)
    rc = dispatch<float, float>(p, B, D, o, visits, st);
  else if (q_dtype == 0 && kv_dtype == 1)
    rc = dispatch<float, __nv_bfloat16>(p, B, D, o, visits, st);
  else if (q_dtype == 1 && kv_dtype == 0)
    rc = dispatch<__nv_bfloat16, float>(p, B, D, o, visits, st);
  else if (q_dtype == 1 && kv_dtype == 1)
    rc = dispatch<__nv_bfloat16, __nv_bfloat16>(p, B, D, o, visits, st);
  else rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
