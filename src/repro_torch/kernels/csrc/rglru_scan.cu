// K5: the RG-LRU linear scan h_t = a_t * h_{t-1} + b_t (h_{-1} = 0) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (rglru_scan / _kernel), reached through ops.lru_scan. a, b and h are
// (B, S, W) fp32, contiguous.
//
// Design. The recurrence is independent across the B * W channels and serial
// in t. One thread owns one (b, w) channel and walks t = 0 .. S-1 with h in a
// register: the TPU kernel's VMEM scratch, carried across its sequential
// seq-block grid axis, becomes that register, and the seq-block axis goes
// away. The TPU wrapper pads S to a whole block with the identity
// (a = 1, b = 0); here nothing is padded, and a ragged W is masked by the
// thread count. Neighbouring threads take neighbouring w, so each step's
// loads of a and b and each store of h are coalesced 128-byte lines. The
// loads do not depend on h: the t loop is unrolled by U steps and all 2U
// loads of a step group are issued before its U fused multiply-adds, so only
// the FMA chain is serial. h = fmaf(a, h, b) rounds once; the plain PyTorch
// version (a * h, then + b) rounds twice, so the two agree to about one ulp
// per step, not bit for bit.
//
// Bound. The scan reads a and b once and writes h once: 3 * B * S * W * 4
// bytes, 0.060 ms at 3.35 TB/s for (B, S, W) = (32, 128, 4096), against
// 2 * B * S * W flops (nothing for the tensor cores), so it is bound by
// memory. At B = 32, W = 4096 the grid has 131,072 threads (1,024 blocks of
// 128), which fills the 132 SMs. A single short prompt (B * W = 4,096
// threads, 32 blocks) leaves most SMs idle, and each thread's chain of S
// dependent steps is then the whole run time. A chunked two-pass scan (each
// chunk of t scanned alone, then the chunk carries folded in) would fill the
// card there, but it changes the order of the sum; it is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;           // threads (channels) per block
constexpr int U = 8;              // time steps whose loads are issued together

__global__ void __launch_bounds__(NT)
rglru_scan_fwd(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ h, int S, int W, long long channels) {
  const long long c = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (c >= channels) return;
  const long long bi = c / W;
  const long long w = c % W;
  const long long base = bi * S * W + w;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float hv = 0.f;
  int t = 0;
  for (; t + U <= S; t += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long off = static_cast<long long>(t + u) * W;
      av[u] = __ldg(ap + off);
      bv[u] = __ldg(bp + off);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      hv = fmaf(av[u], hv, bv[u]);
      hp[static_cast<long long>(t + u) * W] = hv;
    }
  }
  for (; t < S; ++t) {
    const long long off = static_cast<long long>(t) * W;
    hv = fmaf(__ldg(ap + off), hv, __ldg(bp + off));
    hp[off] = hv;
  }
}

// The backward: the reverse scan g_t = dh_t + a_{t+1} g_{t+1} (g_S = 0),
// then db_t = g_t and da_t = g_t h_{t-1} (h_{-1} = 0), from the forward's
// saved h. The TPU kernel has no backward (JAX differentiates
// jax.lax.associative_scan, src/repro/models/rglru.py:106); this one
// mirrors the forward: a thread per channel walks t = S-1 .. 0 with g in a
// register, U steps of loads issued ahead. It reads a, h and dh and writes
// da and db, 5 * B * S * W * 4 bytes (0.100 ms at the hybrid's prefill
// shape), so it is bound by memory too. g = fmaf(a_{t+1}, g, dh_t) rounds
// once where the plain version rounds twice.
__global__ void __launch_bounds__(NT)
rglru_scan_bwd_k(const float* __restrict__ a, const float* __restrict__ h,
                 const float* __restrict__ dh, float* __restrict__ da,
                 float* __restrict__ db, int S, int W, long long channels) {
  const long long c = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (c >= channels) return;
  const long long base = (c / W) * S * W + c % W;
  const float* ap = a + base;
  const float* hp = h + base;
  const float* gp = dh + base;
  float* dap = da + base;
  float* dbp = db + base;
  float g = 0.f, a_next = 0.f;
  int t = S - 1;
  for (; t + 1 >= U; t -= U) {           // steps t, t-1, .., t-U+1
    float av[U], hv[U], gv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long off = static_cast<long long>(t - u) * W;
      av[u] = __ldg(ap + off);
      gv[u] = __ldg(gp + off);
      hv[u] = t - u > 0 ? __ldg(hp + off - W) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long off = static_cast<long long>(t - u) * W;
      g = fmaf(a_next, g, gv[u]);
      dbp[off] = g;
      dap[off] = g * hv[u];
      a_next = av[u];
    }
  }
  for (; t >= 0; --t) {
    const long long off = static_cast<long long>(t) * W;
    g = fmaf(a_next, g, __ldg(gp + off));
    dbp[off] = g;
    dap[off] = t > 0 ? g * __ldg(hp + off - W) : 0.f;
    a_next = __ldg(ap + off);
  }
}

bool bad_shape(int B, int S, int W, long long* channels, long long* blocks) {
  *channels = static_cast<long long>(B) * W;
  *blocks = (*channels + NT - 1) / NT;
  return B < 1 || S < 1 || W < 1 || *blocks > 0x7fffffffLL;
}

}  // namespace

// a, b, h: (B, S, W) float32, contiguous. Returns cudaGetLastError() after
// the launch (0 = ok).
extern "C" int rglru_scan(const float* a, const float* b, float* h, int B,
                          int S, int W, void* stream) {
  long long channels, blocks;
  if (bad_shape(B, S, W, &channels, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  rglru_scan_fwd<<<static_cast<unsigned>(blocks), NT, 0,
                   static_cast<cudaStream_t>(stream)>>>(a, b, h, S, W,
                                                        channels);
  return static_cast<int>(cudaGetLastError());
}

// a, h (the forward's output), dh -> da, db: (B, S, W) float32,
// contiguous. Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int rglru_scan_bwd(const float* a, const float* h,
                              const float* dh, float* da, float* db, int B,
                              int S, int W, void* stream) {
  long long channels, blocks;
  if (bad_shape(B, S, W, &channels, &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  rglru_scan_bwd_k<<<static_cast<unsigned>(blocks), NT, 0,
                     static_cast<cudaStream_t>(stream)>>>(a, h, dh, da, db,
                                                          S, W, channels);
  return static_cast<int>(cudaGetLastError());
}
