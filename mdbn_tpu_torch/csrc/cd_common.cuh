// What the CD training kernels (cd_train.cu, cd_train_wide.cu) share: the
// storage type, the mode bits, the Philox draws, the fixed-order sums and the
// in-place parameter update.
//
// Storage: every source is compiled once per storage type, chosen by
// -DMDBN_STORE_BF16=0|1. Store is the type of the parameters (W, b, c, z),
// their velocities, the chain, the data and the kernels' own hidden-sample
// buffers in device memory. Every read widens to f32 (ld), all arithmetic is
// f32, and a value rounds once when it is stored (st): round-to-nearest-even,
// as torch's .to(torch.bfloat16). 0 and 1 are exact in bf16, so samples lose
// nothing.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MDBN_STORE_BF16
#define MDBN_STORE_BF16 0
#endif

namespace cg = cooperative_groups;

namespace {

#if MDBN_STORE_BF16
using Store = __nv_bfloat16;
#else
using Store = float;
#endif

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Flags {
  kGaussian = 1,
  kSampleVisible = 2,
  kPersistent = 4,
  kBf16 = 8,
  kXent = 16,
  kInject = 32,
  kClip = 64,
  kSparsity = 128,
  kMomentumSchedule = 256,
  kTempering = 512,
  kEnhanced = 1024,
  kLearnVar = 2048,
  kPseudo = 4096,
};

enum DrawKind { kDrawH0 = 0, kDrawH = 1, kDrawV = 2, kDrawSwap = 3 };

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// x as it reads back after a store.
__device__ __forceinline__ float round_store(float x) {
  return MDBN_STORE_BF16 ? round_bf16(x) : x;
}

// An operand of a product under the compute dtype.
template <bool kBf>
__device__ __forceinline__ float op(float x) {
  return kBf ? round_bf16(x) : x;
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned lo0 = 0xD2511F53u * ctr.x;
    const unsigned hi0 = __umulhi(0xD2511F53u, ctr.x);
    const unsigned lo1 = 0xCD9E8D57u * ctr.z;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, ctr.z);
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += 0x9E3779B9u;
    key.y += 0xBB67AE85u;
  }
  return ctr;
}

// U[0,1) from 23 random mantissa bits: [1,2) by bit pattern, minus 1.
__device__ __forceinline__ float uniform_from_bits(unsigned bits) {
  return __uint_as_float((bits & 0x007FFFFFu) | 0x3F800000u) - 1.0f;
}

// The Philox block of draw (kind, t) for element (row, col) of update upd.
// Each counter field is a full 32-bit word: col and row are element indices,
// and the third word packs the draw as (t >> 8) << 10 | kind << 8 | (t & 255)
// (kind < 4), so any t < 2^22 has a word of its own, and for t < 256 the word
// is kind << 8 | t. t is the Gibbs step (k of them) or, for a swap draw, the
// rung pair.
__device__ __forceinline__ uint4 draw_bits(unsigned long long seed, unsigned upd, int kind,
                                           int t, int row, int col) {
  const uint2 key = make_uint2(static_cast<unsigned>(seed), static_cast<unsigned>(seed >> 32));
  const unsigned ut = static_cast<unsigned>(t);
  const uint4 ctr = make_uint4(static_cast<unsigned>(col), static_cast<unsigned>(row),
                               ((ut >> 8) << 10) | (static_cast<unsigned>(kind) << 8) | (ut & 255u),
                               upd);
  return philox4x32_10(ctr, key);
}

__device__ __forceinline__ float draw_uniform(unsigned long long seed, unsigned upd, int kind,
                                              int t, int row, int col) {
  return uniform_from_bits(draw_bits(seed, upd, kind, t, row, col).x);
}

// N(0,1) by Box-Muller from two uniforms of one Philox block.
__device__ __forceinline__ float draw_normal(unsigned long long seed, unsigned upd, int kind,
                                             int t, int row, int col) {
  const uint4 x = draw_bits(seed, upd, kind, t, row, col);
  const float u1 = uniform_from_bits(x.x);
  const float u2 = uniform_from_bits(x.y);
  const float r = sqrtf(-2.0f * logf(1.0f - u1 + 1e-12f));
  return r * cosf(6.2831855f * u2);
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// log(1 + e^x), as jax.nn.softplus computes it.
__device__ __forceinline__ float softplusf(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// Fixed-shape butterfly: every lane ends with the same sum, in the same
// order on every run.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sums each of x[0..N) over the block's threads in a fixed order (butterfly,
// then warps in order); every thread ends with the totals. red: kWarps * N
// floats of shared memory. All threads of the block call it.
template <int N>
__device__ __forceinline__ void block_sum(float (&x)[N], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) x[n] = warp_sum(x[n]);
  __syncthreads();  // red is no longer read
  if (lane == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) red[warp * N + n] = x[n];
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float t = 0.0f;
    for (int w = 0; w < kWarps; ++w) t += red[w * N + n];
    x[n] = t;
  }
}

// Warp-per-item work split (b, c and z updates). Warps are numbered across
// blocks first (warp w of block g is global warp w*grid + g) so that a loop
// with few items still spreads over every SM.
struct Split {
  int lane, gwarp, nwarps;
  __device__ Split() {
    lane = threadIdx.x & 31;
    gwarp = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
    nwarps = kWarps * gridDim.x;
  }
};

// Clip, L2 (when decay), momentum and the in-place update of one parameter:
// f32 arithmetic, the velocity rounds once into storage, and the parameter
// is old + rounded velocity, rounded once. A: a kernel's argument struct
// (flags, grad_clip, l2, lr). old, old_vel: the values p and vel hold.
template <class A>
__device__ __forceinline__ void apply_loaded(const A& a, Store* p, Store* vel, float old,
                                             float old_vel, float g, float m, float lr,
                                             bool decay) {
  if (a.flags & kClip) g = fminf(fmaxf(g, -a.grad_clip), a.grad_clip);
  if (decay && a.l2 != 0.0f) g = g - a.l2 * old;
  const float nv = round_store(m * old_vel + lr * g);
  st(vel, nv);
  st(p, old + nv);
}

template <class A>
__device__ __forceinline__ void apply(const A& a, Store* p, Store* vel, float g, float m,
                                      float lr, bool decay) {
  apply_loaded(a, p, vel, ld(p), ld(vel), g, m, lr, decay);
}

// The update of one thread's N elements of W, `stride` apart (rows q of one
// column), of which the first n exist; g holds their gradients. All loads
// come before the first store: a store to W or vW may alias a later
// load as far as the compiler knows, so interleaved they would wait for
// device memory one element after the other.
template <int N, class A>
__device__ __forceinline__ void apply_column(const A& a, Store* w, Store* vw, size_t stride,
                                             int n, const float (&g)[N], float m) {
  float old[N], old_vel[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    old[i] = i < n ? ld(w + i * stride) : 0.0f;
    old_vel[i] = i < n ? ld(vw + i * stride) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n)
      apply_loaded(a, w + i * stride, vw + i * stride, old[i], old_vel[i], g[i], m, a.lr, true);
  }
}

// The monitor's sum over one batch row: squared error of x against its
// reconstruction y, or the cross-entropy terms x log y + (1 - x) log(1 - y);
// summed by a fixed-shape tree into *out. smem: kWarps floats. All threads
// of the block call it.
__device__ __forceinline__ void monitor_row(const Store* x, const float* y, int V, bool xent,
                                            float* smem, float* out) {
  float acc = 0.0f;
  for (int q = threadIdx.x; q < V; q += kThreads) {
    const float xv = ld(x + q);
    if (xent) {
      const float pc = fminf(fmaxf(y[q], 1e-7f), 1.0f - 1e-7f);
      acc += xv * logf(pc) + (1.0f - xv) * logf(1.0f - pc);
    } else {
      const float d = xv - y[q];
      acc = fmaf(d, d, acc);
    }
  }
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.0f;
    for (int w = 0; w < kWarps; ++w) tot += smem[w];
    *out = tot;
  }
}

// One epoch-mean contribution of an update's monitor from the B row sums:
// summed in a fixed order by the calling warp (all 32 lanes call it).
__device__ __forceinline__ float rows_total(const float* rowerr, int B) {
  float tot = 0.0f;
  for (int r = threadIdx.x & 31; r < B; r += 32) tot += rowerr[r];
  return warp_sum(tot);
}

}  // namespace
