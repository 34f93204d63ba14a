// Fused multi-epoch CD-k / PCD training run of one RBM in ONE launch.
//
// Replaces: mdbn_tpu/ops/cd_epoch_pallas.py::_cd_train_kernel in its
// const-block single-device mode (ndev=1, hbm_state=False), the kernel every
// layer of the graded configs trains through on the TPU.
//
// What it computes, for e in [0, E), i in [0, nb) (one update each):
//   v0   = data rows [order[e,i]*B, +B)
//   h0p  = sigmoid(v0 W + c),  h0s = (u_h0 < h0p)
//   h    = chain (PCD) or h0s (CD); k Gibbs steps:
//            vmean = sigmoid(h W^T + b)  (Bernoulli)  or  h W^T + b  (Gaussian)
//            vs    = (u_v < vmean) | vmean + noise | vmean  (sampled/mean-field)
//            hmean = sigmoid(vs W + c),  h = (u_h < hmean)
//   gW = (v0^T h0p - vs^T hmean)/B, gb = sum(v0 - vs)/B,
//   gc = sum(h0p - hmean)/B + sparsity_cost*(target - mean(h0p))
//   clip, L2 on W, vel = m*vel + lr*g, param += vel   (m follows the
//   initial_momentum -> momentum schedule by absolute epoch)
//   monitor: mse or xent of v0 against the t=0 visible mean (PCD: against
//   sigmoid(h0s W^T + b), the reconstruction of the data chain)
//   errs[e] = mean over the epoch's updates of the monitor.
// The chain is written back only in PCD mode, as the TPU kernel does.
//
// Random numbers: Philox4x32-10 keyed by the 64-bit seed the wrapper draws
// from its torch.Generator, counter (col, row, kind<<8 | t, absolute update
// index), so a draw does not depend on the launch's grid shape. Uniforms use
// the 23-bit mantissa trick of _uniform_from_bits, normals Box-Muller as in
// _normal_from_bits. Inject mode reads the draw_uniform_blocks layout
// ([E, nb(,k), B, D]) from device buffers instead.
//
// Precision: with f32 compute every product is an fp32 FMA with fp32
// accumulation, at least the precision of the TPU kernel's default
// one-pass-MXU "auto" mode. With bf16 compute the operands are rounded with
// __float2bfloat16 and accumulated in fp32. Storage is f32.
//
// What bounds it on an H100: at batch 20 and 784x500 one CD-1 update is about
// 78 MFLOP (three Gibbs products and the gradient, each 2*B*V*H = 15.7 MFLOP)
// and moves about 8-12 MB of W and velocity through L2 (W is 1.57 MB and stays
// L2-resident in the 50 MB L2). Neither FLOPs nor bytes bound it: the update is
// a chain of 2 + 2k dependent phases, each separated by a grid-wide barrier,
// so it is bound by barrier and memory latency.
//
// Design now: one persistent cooperative launch per run
// (cudaLaunchCooperativeKernel, grid no larger than the co-resident block
// count, one block per SM by default), cooperative_groups grid sync between
// the phases of each update. W, the velocities and the chain stay in device
// memory (L2-resident). To cut L2 round trips, each product phase works on
// tiles of kRowTile batch rows staged in shared memory, so every W element
// is read once per row tile, and the latency-bound loops are unrolled. Every
// sum is taken in a fixed order by one thread, by a fixed-shape warp shuffle
// tree, or by adding per-warp partials in warp order: no atomics, so a run is
// deterministic and independent of the grid size. Any B is handled by
// looping over row tiles. The optional trace records each phase's start on
// block 0's clock (chip_smoke.py prints the breakdown).
// Later: keep W in the distributed shared memory of a thread-block cluster
// (fewer L2 round trips, cluster barriers instead of grid barriers), prefetch
// W tiles with TMA/cp.async, and use wgmma tensor-core products once batches
// are large enough to fill them.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 4;    // batch rows per accumulator tile (any B: loop over tiles)
constexpr int kStage = 2048;   // columns of a row tile staged in shared memory at once
constexpr int kQPerWarp = 4;   // visible units per warp in the visible phase
constexpr int kQStrip = 16;    // visible units per W unit of the update phase
constexpr int kSmemFloats = kRowTile * kStage + kWarps * kRowTile * 32;

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
};

enum DrawKind { kDrawH0 = 0, kDrawH = 1, kDrawV = 2 };

struct Args {
  const float* data;   // [n_rows, V]
  const int* order;    // [E, nb] minibatch index of each update
  const float* u_h0;   // inject: [E, nb, B, H]
  const float* u_h;    // inject: [E, nb, k, B, H]
  const float* u_v;    // inject: [E, nb, k, B, V] uniforms or normals
  float* W;            // [V, H]
  float* b;            // [V]
  float* c;            // [H]
  float* vW;
  float* vb;
  float* vc;
  float* chain;        // [B, H]
  float* errs;         // [E]
  float* h0p;          // scratch [B, H]
  float* h0s;          // scratch [B, H]
  float* hbuf;         // scratch [B, H] CD chain sample
  float* hmean;        // scratch [B, H]
  float* vs;           // scratch [B, V]
  float* v1mean;       // scratch [B, V]
  float* rowerr;       // scratch [B]
  unsigned long long* trace;  // optional [E, nb, 3 + 2k] phase start times (ns)
  int V, H, B, nb, E, k, start_epoch, switch_epoch, flags;
  float lr, momentum, initial_momentum, l2, grad_clip, sparsity_target,
      sparsity_cost;
  unsigned long long seed;
};

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

__device__ __forceinline__ uint4 draw_bits(const Args& a, unsigned upd,
                                           int kind, int t, int row, int col) {
  const uint2 key = make_uint2(static_cast<unsigned>(a.seed),
                               static_cast<unsigned>(a.seed >> 32));
  const uint4 ctr = make_uint4(static_cast<unsigned>(col),
                               static_cast<unsigned>(row),
                               (static_cast<unsigned>(kind) << 8) |
                                   static_cast<unsigned>(t),
                               upd);
  return philox4x32_10(ctr, key);
}

__device__ __forceinline__ float draw_uniform(const Args& a, unsigned upd,
                                              int kind, int t, int row,
                                              int col) {
  return uniform_from_bits(draw_bits(a, upd, kind, t, row, col).x);
}

// N(0,1) by Box-Muller from two uniforms of one Philox block.
__device__ __forceinline__ float draw_normal(const Args& a, unsigned upd,
                                             int kind, int t, int row,
                                             int col) {
  const uint4 x = draw_bits(a, upd, kind, t, row, col);
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

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <bool kBf>
__device__ __forceinline__ float op(float x) {
  return kBf ? round_bf16(x) : x;
}

// Fixed-shape butterfly: every lane ends with the same sum, in the same
// order on every run.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Warp-per-item work split (b and c of the update phase). Warps are
// numbered across blocks first (warp w of block g is global warp w*grid + g)
// so that a loop with few items still spreads over every SM.
struct Split {
  int lane, gwarp, nwarps;
  __device__ Split() {
    lane = threadIdx.x & 31;
    gwarp = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
    nwarps = kWarps * gridDim.x;
  }
};

// Copies rows [r0, r0 + kRowTile) x columns [c0, c0 + n) of the row-major
// [rows, ld] matrix src into tile[kRowTile][kStage] (zero past the last row),
// rounding to bf16 when kBf. All threads of the block take part.
template <bool kBf>
__device__ __forceinline__ void stage_rows(float* tile, const float* src, int rows, int ld,
                                           int r0, int c0, int n) {
  for (int idx = threadIdx.x; idx < kRowTile * n; idx += kThreads) {
    const int rr = idx / n, cc = idx - rr * n;
    tile[rr * kStage + cc] =
        r0 + rr < rows ? op<kBf>(src[static_cast<size_t>(r0 + rr) * ld + c0 + cc]) : 0.0f;
  }
}

// h = sigmoid(x W + c) for all B*H outputs, then h_sample = (u < h); x [B, V].
// Work unit: 32 hidden columns (lane = column) x kRowTile batch rows, one
// block. The unit's rows of x are staged in shared memory (kStage columns at
// a time); warp w sums the products over v = w, w + kWarps, ... into
// kRowTile registers, so each W element is read once per row tile; the
// kWarps partial sums are then added in warp order. The summation order
// depends only on kWarps, not on the grid.
template <bool kBf>
__device__ void hidden_phase(const Args& a, float* smem, const float* x, float* hprob,
                             float* hsample, const float* u, unsigned upd, int kind,
                             int t) {
  float* xs = smem;                       // [kRowTile][kStage]
  float* part = smem + kRowTile * kStage;  // [kWarps][kRowTile][32]
  const int V = a.V, H = a.H, B = a.B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncol = (H + 31) / 32, nrow = (B + kRowTile - 1) / kRowTile;
  for (int unit = blockIdx.x; unit < ncol * nrow; unit += gridDim.x) {
    const int j0 = (unit % ncol) * 32, r0 = (unit / ncol) * kRowTile;
    const int j = j0 + lane;
    float acc[kRowTile];
#pragma unroll
    for (int rr = 0; rr < kRowTile; ++rr) acc[rr] = 0.0f;
    for (int q0 = 0; q0 < V; q0 += kStage) {
      const int nq = min(kStage, V - q0);
      __syncthreads();  // the previous tile is no longer read
      stage_rows<kBf>(xs, x, B, V, r0, q0, nq);
      __syncthreads();
      if (j < H) {
        const float* wcol = a.W + static_cast<size_t>(q0) * H + j;
#pragma unroll 8
        for (int qq = warp; qq < nq; qq += kWarps) {
          const float w = op<kBf>(wcol[static_cast<size_t>(qq) * H]);
#pragma unroll
          for (int rr = 0; rr < kRowTile; ++rr) acc[rr] = fmaf(xs[rr * kStage + qq], w, acc[rr]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowTile; ++rr) part[(warp * kRowTile + rr) * 32 + lane] = acc[rr];
    __syncthreads();
    if (threadIdx.x < kRowTile * 32) {
      const int rr = threadIdx.x >> 5, r = r0 + rr, jj = j0 + lane;
      if (r < B && jj < H) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += part[(w * kRowTile + rr) * 32 + lane];
        const int idx = r * H + jj;
        const float p = sigmoidf(sum + a.c[jj]);
        hprob[idx] = p;
        const float uu = u ? u[idx] : draw_uniform(a, upd, kind, t, r, jj);
        hsample[idx] = uu < p ? 1.0f : 0.0f;
      }
    }
  }
}

// The visible half-step of Gibbs step t: vmean = sigmoid(h W^T + b) or the
// Gaussian mean, then the visible sample. Work unit: kRowTile batch rows x
// kWarps * kQPerWarp visible units, one block, with the rows of h staged in
// shared memory; each warp takes kQPerWarp visible units, its lanes stride
// over H (coalesced rows of W) and a fixed butterfly sums each output. At
// t == 0 it also writes the monitor's visible mean (PCD: a second set of
// units, from h0s).
template <bool kBf>
__device__ void visible_phase(const Args& a, float* smem, const float* hsrc, unsigned upd,
                              int e, int i, int t) {
  float* hs = smem;  // [kRowTile][kStage]
  const int V = a.V, H = a.H, B = a.B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool gaussian = a.flags & kGaussian;
  const bool sample_v = a.flags & kSampleVisible;
  const bool persistent = a.flags & kPersistent;
  constexpr int kQBlock = kWarps * kQPerWarp;
  const int nrow = (B + kRowTile - 1) / kRowTile, nqb = (V + kQBlock - 1) / kQBlock;
  const int nunit = nrow * nqb;
  const int nout = (persistent && t == 0) ? 2 * nunit : nunit;
  const float* uv = nullptr;
  if ((a.flags & kInject) && sample_v)
    uv = a.u_v + ((static_cast<size_t>(e) * a.nb + i) * a.k + t) * B * V;
  for (int unit = blockIdx.x; unit < nout; unit += gridDim.x) {
    const bool monitor = unit >= nunit;
    const int uu = monitor ? unit - nunit : unit;
    const int r0 = (uu / nqb) * kRowTile, qbase = (uu % nqb) * kQBlock + warp * kQPerWarp;
    const float* src = monitor ? a.h0s : hsrc;
    float acc[kQPerWarp][kRowTile];
#pragma unroll
    for (int qi = 0; qi < kQPerWarp; ++qi)
#pragma unroll
      for (int rr = 0; rr < kRowTile; ++rr) acc[qi][rr] = 0.0f;
    for (int j0 = 0; j0 < H; j0 += kStage) {
      const int nj = min(kStage, H - j0);
      __syncthreads();
      stage_rows<kBf>(hs, src, B, H, r0, j0, nj);
      __syncthreads();
#pragma unroll
      for (int qi = 0; qi < kQPerWarp; ++qi) {
        const int q = qbase + qi;
        if (q >= V) break;
        const float* wrow = a.W + static_cast<size_t>(q) * H + j0;
#pragma unroll 4
        for (int j = lane; j < nj; j += 32) {
          const float w = op<kBf>(wrow[j]);
#pragma unroll
          for (int rr = 0; rr < kRowTile; ++rr)
            acc[qi][rr] = fmaf(hs[rr * kStage + j], w, acc[qi][rr]);
        }
      }
    }
#pragma unroll
    for (int qi = 0; qi < kQPerWarp; ++qi) {
      float mine = 0.0f;  // lane rr keeps row r0 + rr
#pragma unroll
      for (int rr = 0; rr < kRowTile; ++rr) {
        const float tot = warp_sum(acc[qi][rr]);
        if (lane == rr) mine = tot;
      }
      const int q = qbase + qi, r = r0 + lane;
      if (q >= V || lane >= kRowTile || r >= B) continue;
      const int idx = r * V + q;
      const float pre = mine + a.b[q];
      const float mean = gaussian ? pre : sigmoidf(pre);
      if (monitor) {
        a.v1mean[idx] = mean;
        continue;
      }
      if (t == 0 && !persistent) a.v1mean[idx] = mean;
      float sample = mean;
      if (sample_v) {
        if (gaussian) {
          sample = mean + (uv ? uv[idx] : draw_normal(a, upd, kDrawV, t, r, q));
        } else {
          const float uu2 = uv ? uv[idx] : draw_uniform(a, upd, kDrawV, t, r, q);
          sample = uu2 < mean ? 1.0f : 0.0f;
        }
      }
      a.vs[idx] = sample;
    }
  }
}

// Clip, L2 (W only), momentum and the in-place update of one parameter.
__device__ __forceinline__ void apply(const Args& a, float* p, float* vel, float g, float m,
                                      bool decay) {
  if (a.flags & kClip) g = fminf(fmaxf(g, -a.grad_clip), a.grad_clip);
  if (decay && a.l2 != 0.0f) g = g - a.l2 * *p;
  const float nv = m * *vel + a.lr * g;
  *vel = nv;
  *p = *p + nv;
}

// Gradient and update of W, b and c, plus the per-row monitor sums.
// W unit (one block): kQStrip consecutive visible units x kThreads hidden
// columns (thread = column). The strip's v0 and vs columns are staged in
// shared memory; each thread reads its columns of h0p and hmean once and sums
// each element over the B rows in row order. Monitor unit (one block): one
// batch row, summed by a fixed-shape tree. b and c: one warp per element,
// lanes over the rows, fixed butterfly.
template <bool kBf>
__device__ void update_phase(const Args& a, float* smem, const Split& s, const float* v0,
                             float m) {
  const int V = a.V, H = a.H, B = a.B;
  const float inv_b = 1.0f / static_cast<float>(B);
  constexpr int kRowChunk = kSmemFloats / (2 * kQStrip);  // rows of the strip staged at once
  const int nstrip = (V + kQStrip - 1) / kQStrip, njc = (H + kThreads - 1) / kThreads;
  const int nwu = nstrip * njc;
  const bool xent = a.flags & kXent;
  for (int unit = blockIdx.x; unit < nwu + B; unit += gridDim.x) {
    __syncthreads();  // shared memory of the previous unit is no longer read
    if (unit >= nwu) {  // monitor: sum over row r of the reconstruction error
      const int r = unit - nwu;
      float acc = 0.0f;
      for (int q = threadIdx.x; q < V; q += kThreads) {
        const float x = v0[static_cast<size_t>(r) * V + q];
        const float y = a.v1mean[static_cast<size_t>(r) * V + q];
        if (xent) {
          const float pc = fminf(fmaxf(y, 1e-7f), 1.0f - 1e-7f);
          acc += x * logf(pc) + (1.0f - x) * logf(1.0f - pc);
        } else {
          const float d = x - y;
          acc = fmaf(d, d, acc);
        }
      }
      acc = warp_sum(acc);
      if (s.lane == 0) smem[threadIdx.x >> 5] = acc;
      __syncthreads();
      if (threadIdx.x == 0) {
        float tot = 0.0f;
        for (int w = 0; w < kWarps; ++w) tot += smem[w];
        a.rowerr[r] = tot;
      }
      continue;
    }
    const int q0 = (unit % nstrip) * kQStrip, j = (unit / nstrip) * kThreads + threadIdx.x;
    const int nq = min(kQStrip, V - q0);
    float pos[kQStrip], neg[kQStrip];
#pragma unroll
    for (int qi = 0; qi < kQStrip; ++qi) pos[qi] = neg[qi] = 0.0f;
    for (int rc = 0; rc < B; rc += kRowChunk) {
      const int nr = min(kRowChunk, B - rc);
      __syncthreads();
      for (int idx = threadIdx.x; idx < nr * kQStrip; idx += kThreads) {
        const int rr = idx / kQStrip, qi = idx - rr * kQStrip;
        const size_t g = static_cast<size_t>(rc + rr) * V + q0 + qi;
        smem[rr * 2 * kQStrip + qi] = qi < nq ? op<kBf>(v0[g]) : 0.0f;
        smem[rr * 2 * kQStrip + kQStrip + qi] = qi < nq ? op<kBf>(a.vs[g]) : 0.0f;
      }
      __syncthreads();
      if (j < H) {
#pragma unroll 4
        for (int rr = 0; rr < nr; ++rr) {
          const float hp = op<kBf>(a.h0p[(rc + rr) * H + j]);
          const float hm = op<kBf>(a.hmean[(rc + rr) * H + j]);
          const float* sv = smem + rr * 2 * kQStrip;
#pragma unroll
          for (int qi = 0; qi < kQStrip; ++qi) {
            pos[qi] = fmaf(sv[qi], hp, pos[qi]);
            neg[qi] = fmaf(sv[kQStrip + qi], hm, neg[qi]);
          }
        }
      }
    }
    if (j < H) {
#pragma unroll
      for (int qi = 0; qi < kQStrip; ++qi) {
        if (qi < nq) {
          const size_t w = static_cast<size_t>(q0 + qi) * H + j;
          apply(a, a.W + w, a.vW + w, (pos[qi] - neg[qi]) * inv_b, m, true);
        }
      }
    }
  }
  for (int o = s.gwarp; o < V + H; o += s.nwarps) {
    float acc = 0.0f, on = 0.0f;
    if (o < V) {
      for (int r = s.lane; r < B; r += 32)
        acc += v0[static_cast<size_t>(r) * V + o] - a.vs[static_cast<size_t>(r) * V + o];
    } else {
      for (int r = s.lane; r < B; r += 32) {
        acc += a.h0p[r * H + o - V] - a.hmean[r * H + o - V];
        on += a.h0p[r * H + o - V];
      }
    }
    acc = warp_sum(acc);
    on = warp_sum(on);
    if (s.lane != 0) continue;
    if (o < V) {
      apply(a, a.b + o, a.vb + o, acc * inv_b, m, false);
    } else {
      float g = acc * inv_b;
      if (a.flags & kSparsity) g = g + a.sparsity_cost * (a.sparsity_target - on * inv_b);
      apply(a, a.c + o - V, a.vc + o - V, g, m, false);
    }
  }
}

template <bool kBf>
__global__ void __launch_bounds__(kThreads, 1) cd_train_kernel(Args a) {
  __shared__ float smem[kSmemFloats];  // 36 KB: staged row tiles + partial sums
  cg::grid_group grid = cg::this_grid();
  const Split s;
  const bool inject = a.flags & kInject;
  const bool persistent = a.flags & kPersistent;
  const bool xent = a.flags & kXent;
  const bool lead_warp = blockIdx.x == 0 && threadIdx.x < 32;  // sums the monitor
  const int B = a.B, V = a.V, H = a.H;
  const size_t bh = static_cast<size_t>(B) * H;
  float err_sum = 0.0f;  // lead warp: the epoch's running monitor sum
  for (int e = 0; e < a.E; ++e) {
    const int abs_epoch = a.start_epoch + e;
    const float m = ((a.flags & kMomentumSchedule) && abs_epoch < a.switch_epoch)
                        ? a.initial_momentum
                        : a.momentum;
    for (int i = 0; i < a.nb; ++i) {
      const unsigned upd = static_cast<unsigned>(abs_epoch) *
                               static_cast<unsigned>(a.nb) + static_cast<unsigned>(i);
      const size_t ei = static_cast<size_t>(e) * a.nb + i;
      const float* v0 = a.data + static_cast<size_t>(a.order[ei]) * B * V;
      // block 0 stamps the start of each phase (after the barrier before it)
      unsigned long long* stamp =
          (a.trace && blockIdx.x == 0 && threadIdx.x == 0) ? a.trace + ei * (3 + 2 * a.k) : nullptr;
      if (stamp) *stamp++ = globaltimer_ns();
      hidden_phase<kBf>(a, smem, v0, a.h0p, a.h0s, inject ? a.u_h0 + ei * bh : nullptr,
                        upd, kDrawH0, 0);
      grid.sync();
      float* hdst = persistent ? a.chain : a.hbuf;
      for (int t = 0; t < a.k; ++t) {
        const float* hsrc = t > 0 ? hdst : (persistent ? a.chain : a.h0s);
        if (stamp) *stamp++ = globaltimer_ns();
        visible_phase<kBf>(a, smem, hsrc, upd, e, i, t);
        grid.sync();
        if (stamp) *stamp++ = globaltimer_ns();
        hidden_phase<kBf>(a, smem, a.vs, a.hmean, hdst,
                          inject ? a.u_h + (ei * a.k + t) * bh : nullptr, upd,
                          kDrawH, t);
        grid.sync();
      }
      if (stamp) *stamp++ = globaltimer_ns();
      update_phase<kBf>(a, smem, s, v0, m);
      grid.sync();
      if (stamp) *stamp++ = globaltimer_ns();
      if (lead_warp) {
        float tot = 0.0f;
        for (int r = threadIdx.x; r < B; r += 32) tot += a.rowerr[r];
        tot = warp_sum(tot);
        err_sum += xent ? -tot / static_cast<float>(B)
                        : tot / (static_cast<float>(B) * static_cast<float>(V));
      }
    }
    if (lead_warp && threadIdx.x == 0) {
      a.errs[e] = err_sum * (1.0f / static_cast<float>(a.nb));
      err_sum = 0.0f;
    }
  }
}

}  // namespace

extern "C" {

// Launches the whole run on `stream`. grid <= 0 picks one block per SM.
// Returns a cudaError_t (0 on success); a grid larger than the co-resident
// block count returns cudaErrorCooperativeLaunchTooLarge without launching.
int cd_train_run(const float* data, const int* order, const float* u_h0,
                 const float* u_h, const float* u_v, float* W, float* b,
                 float* c, float* vW, float* vb, float* vc, float* chain,
                 float* errs, float* scratch, unsigned long long* trace, int V, int H,
                 int B, int nb,
                 int E, int k, int start_epoch, int switch_epoch, int flags,
                 float lr, float momentum, float initial_momentum, float l2,
                 float grad_clip, float sparsity_target, float sparsity_cost,
                 unsigned long long seed, int device, int grid, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int coop = 0, nsm = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const bool bf = flags & kBf16;
  const void* fn = bf ? reinterpret_cast<const void*>(&cd_train_kernel<true>)
                      : reinterpret_cast<const void*>(&cd_train_kernel<false>);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0)) !=
      cudaSuccess)
    return err;
  if (grid <= 0) grid = nsm;
  if (grid > per_sm * nsm) return cudaErrorCooperativeLaunchTooLarge;

  Args a;
  a.data = data; a.order = order; a.u_h0 = u_h0; a.u_h = u_h; a.u_v = u_v;
  a.W = W; a.b = b; a.c = c; a.vW = vW; a.vb = vb; a.vc = vc; a.chain = chain;
  a.errs = errs;
  const size_t bh = static_cast<size_t>(B) * H, bv = static_cast<size_t>(B) * V;
  a.h0p = scratch;
  a.h0s = a.h0p + bh;
  a.hbuf = a.h0s + bh;
  a.hmean = a.hbuf + bh;
  a.vs = a.hmean + bh;
  a.v1mean = a.vs + bv;
  a.rowerr = a.v1mean + bv;
  a.trace = trace;
  a.V = V; a.H = H; a.B = B; a.nb = nb; a.E = E; a.k = k;
  a.start_epoch = start_epoch; a.switch_epoch = switch_epoch; a.flags = flags;
  a.lr = lr; a.momentum = momentum; a.initial_momentum = initial_momentum;
  a.l2 = l2; a.grad_clip = grad_clip; a.sparsity_target = sparsity_target;
  a.sparsity_cost = sparsity_cost; a.seed = seed;

  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), params, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Scratch floats the wrapper allocates for one run.
long long cd_train_scratch_floats(int V, int H, int B) {
  return 4LL * B * H + 2LL * B * V + B;
}

const char* cd_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
