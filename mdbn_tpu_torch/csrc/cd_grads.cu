// One CD-k / PCD step's statistics for one data-parallel shard, in ONE launch,
// with no update: the per-step kernel of the data-parallel training path.
//
// Replaces: mdbn_tpu/ops/cd_epoch_pallas.py::_cd_grads_kernel (:3184), built
// by make_pallas_grads_fn (:3279), which mdbn_tpu/parallel/dp.py calls once
// per shard per step before its pmean. Here each rank launches this kernel,
// which writes (gW, gb, gc, err) into one flat buffer, then all-reduces the
// buffer with torch.distributed outside the kernel
// (mdbn_tpu_torch/parallel/dp.py), and applies the update with the second
// kernel of this file, cd_update_kernel (below): together with the NCCL
// all-reduce the two stand for the TPU's DP mega-kernel, whose in-kernel
// exchange maps to a collective between launches on this card.
//
// What it computes (B rows of this shard, fixed variance, no tempering, the
// plain gradient; the wrapper refuses the rest):
//   h0p  = sigmoid(v0 W + c),  h0s = (u_h0 < h0p)
//   h    = chain (PCD) or h0s (CD); k Gibbs steps:
//            vmean = sigmoid(h W^T + b)  (Bernoulli)  or  h W^T + b  (Gaussian)
//            vs    = (u_v < vmean) | vmean + noise | vmean  (sampled/mean-field)
//            hmean = sigmoid(vs W + c),  h = (u_h < hmean)
//   PCD: chain_out = h, and the monitor reconstructs the data chain,
//        v1mean = sigmoid(h0s W^T + b) (Gaussian: h0s W^T + b);
//   CD:  chain_out = chain, v1mean = the t = 0 visible mean.
//   With m_r the row mask (1 when there is none) and n = norm:
//   gW = sum_r m_r (v0_r^T h0p_r - vs_r^T hmean_r) / n
//   gb = sum_r m_r (v0_r - vs_r) / n
//   gc = sum_r m_r (h0p_r - hmean_r) / n + cost (target - sum_r m_r h0p_r / n)
//   err = mse: sum_r m_r |v0_r - v1mean_r|^2 / n / V
//         xent: -sum_r m_r sum_q (v0 log p + (1 - v0) log(1 - p)) / n,
//               p = clip(v1mean, 1e-7, 1 - 1e-7)
// Pad rows (m_r = 0) still run their Gibbs chain; they enter no statistic.
//
// Random numbers: Philox4x32-10 (cd_common.cuh) keyed by the wrapper's 64-bit
// seed, counter (col, row, kind<<8 | t, 0); the data-parallel path derives a
// distinct seed per step and rank. Inject mode reads the ops/cd_step.draw_uniforms
// layout: u_h0 [B, H], u_h [k, B, H], u_v [k, B, V] (uniforms, or normals for
// Gaussian visibles).
//
// Precision: every input and output is f32 (the TPU kernel's refs are f32;
// built at float32 storage only). With f32 compute every product is an fp32
// FMA with fp32 accumulation; with bf16 compute the operands of every product
// round to bf16 and accumulate in fp32, as core.rbm_math._dot does.
//
// What bounds it on an H100: at c1's shape (784x500, B 20, CD-1) one step is
// 78 MFLOP (three Gibbs products 2*B*V*H each, the gradient 2*2B*V*H), 1.2 us
// at the f32 peak, and moves W in and gW out, 3.1 MB, 0.9 us at the memory rate.
// Neither bounds it: the step is 2 + 2k dependent phases with a grid-wide
// barrier after each, so it is bound by barrier and L2 latency, like
// cd_train.cu (whose c1 update takes about 35-40 us), plus one launch per step.
//
// Design now: one cooperative launch per step (grid no larger than the
// co-resident block count, one block per SM by default), cooperative_groups
// grid sync between phases: hidden from data; k x (visible, hidden); gradient.
// The product phases stage kRowTile batch rows in shared memory so each W
// element is read once per row tile. The monitor's row sums ride as extra units
// of the first hidden phase (v1mean is ready by then), and the gradient phase
// adds them up. Each gW unit (kQStrip rows of W x kThreads columns, one block)
// sums its elements over the 2B rows in row order; gb and gc take one warp per
// element with a fixed butterfly. No atomics: the bits do not depend on the
// grid. Later: keep the per-step launch but capture a whole epoch in a CUDA
// graph, or fold the all-reduce into the kernel (the TPU's DP mega-kernel).

#include "cd_common.cuh"

namespace {

static_assert(!MDBN_STORE_BF16, "cd_grads.cu is built at float32 storage only");

constexpr int kRowTile = 4;   // batch rows per accumulator tile
constexpr int kStage = 2048;  // columns of a row tile staged in shared memory at once
constexpr int kQPerWarp = 4;  // visible units per warp in the visible phase
constexpr int kQStrip = 16;   // visible units per gW unit
constexpr int kSmemFloats = kRowTile * kStage + kWarps * kRowTile * 32;
constexpr int kMasked = 8192;  // a row mask is given (the other bits: cd_common.cuh)

struct Args {
  const float* v0;        // [B, V]
  const float* mask;      // kMasked: [B] of 0/1
  const float* u_h0;      // inject: [B, H]
  const float* u_h;       // inject: [k, B, H]
  const float* u_v;       // inject, sampled visibles: [k, B, V]
  const float* W;         // [V, H]
  const float* b;         // [V]
  const float* c;         // [H]
  const float* chain_in;  // [B, H]
  float* gW;              // [V, H]
  float* gb;              // [V]
  float* gc;              // [H]
  float* chain_out;       // [B, H]
  float* err;             // [1]
  float* h0p;             // scratch [B, H]
  float* h0s;             // scratch [B, H] samples of h0p
  float* hbuf;            // scratch [B, H] CD chain samples
  float* hmean;           // scratch [B, H]
  float* vs;              // scratch [B, V]
  float* v1mean;          // scratch [B, V]
  float* rowerr;          // scratch [B] masked monitor sum of each row
  int V, H, B, k, flags;
  float inv_norm, sparsity_target, sparsity_cost;
  unsigned long long seed;
};

__device__ __forceinline__ float row_mask(const Args& a, int r) {
  return (a.flags & kMasked) ? a.mask[r] : 1.0f;
}

// Copies rows [r0, r0 + kRowTile) x columns [c0, c0 + n) of the row-major
// [rows, stride] matrix src into tile[kRowTile][kStage] (zero past the last
// row), rounding to bf16 when kBf. All threads of the block take part.
template <bool kBf>
__device__ __forceinline__ void stage_rows(float* tile, const float* src, int rows, int stride,
                                           int r0, int c0, int n) {
  for (int idx = threadIdx.x; idx < kRowTile * n; idx += kThreads) {
    const int rr = idx / n, cc = idx - rr * n;
    tile[rr * kStage + cc] =
        r0 + rr < rows ? op<kBf>(src[static_cast<size_t>(r0 + rr) * stride + c0 + cc]) : 0.0f;
  }
}

// hprob = sigmoid(x W + c) for the B rows of x [B, V], hsample = (u < hprob).
// Work unit: 32 hidden columns (lane = column) x kRowTile rows, one block; the
// unit's rows of x are staged in shared memory and warp w sums the products
// over v = w, w + kWarps, ...; the kWarps partial sums are added in warp order.
// When `monitor`, B more units each sum one row of the monitor into rowerr.
template <bool kBf>
__device__ void hidden_phase(const Args& a, float* smem, const float* x, float* hprob,
                             float* hsample, const float* u, int kind, int t, bool monitor) {
  float* xs = smem;                        // [kRowTile][kStage]
  float* part = smem + kRowTile * kStage;  // [kWarps][kRowTile][32]
  const int V = a.V, H = a.H, B = a.B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncol = (H + 31) / 32, nrow = (B + kRowTile - 1) / kRowTile;
  const int nprod = ncol * nrow;
  for (int unit = blockIdx.x; unit < nprod + (monitor ? B : 0); unit += gridDim.x) {
    if (unit >= nprod) {
      const int r = unit - nprod;
      const size_t row = static_cast<size_t>(r) * V;
      __syncthreads();  // smem of the previous unit is no longer read
      monitor_row(a.v0 + row, a.v1mean + row, V, a.flags & kXent, smem, a.rowerr + r);
      if (threadIdx.x == 0) a.rowerr[r] *= row_mask(a, r);
      continue;
    }
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
        const size_t idx = static_cast<size_t>(r) * H + jj;
        const float p = sigmoidf(sum + a.c[jj]);
        hprob[idx] = p;
        const float uu = u ? u[idx] : draw_uniform(a.seed, 0u, kind, t, r, jj);
        hsample[idx] = uu < p ? 1.0f : 0.0f;
      }
    }
  }
}

// Gibbs step t's visible mean and sample from h [B, H] -> vs (CD, t = 0: the
// monitor's v1mean too); with `recon`, also the data chain's reconstruction
// from h0s -> v1mean (PCD). Work unit: kRowTile rows x kWarps * kQPerWarp
// visible units, one block, with the rows of h staged in shared memory; each
// warp takes kQPerWarp visible units, its lanes stride over H (coalesced rows
// of W) and a fixed butterfly sums each output.
template <bool kBf>
__device__ void visible_phase(const Args& a, float* smem, const float* h, int t, bool recon) {
  float* hs = smem;  // [kRowTile][kStage]
  const int V = a.V, H = a.H, B = a.B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool gaussian = a.flags & kGaussian;
  const bool sample_v = a.flags & kSampleVisible;
  const bool persistent = a.flags & kPersistent;
  constexpr int kQBlock = kWarps * kQPerWarp;
  const int nqb = (V + kQBlock - 1) / kQBlock, nrow = (B + kRowTile - 1) / kRowTile;
  const int nseg = nrow * nqb;
  const float* uv =
      ((a.flags & kInject) && sample_v) ? a.u_v + static_cast<size_t>(t) * B * V : nullptr;
  for (int unit = blockIdx.x; unit < nseg * (recon ? 2 : 1); unit += gridDim.x) {
    const bool is_recon = unit >= nseg;
    const float* src = is_recon ? a.h0s : h;
    const int uu = unit - (is_recon ? nseg : 0);
    const int r0 = (uu / nqb) * kRowTile, qbase = (uu % nqb) * kQBlock + warp * kQPerWarp;
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
      const size_t idx = static_cast<size_t>(r) * V + q;
      const float pre = mine + a.b[q];
      const float mean = gaussian ? pre : sigmoidf(pre);
      if (is_recon) {
        a.v1mean[idx] = mean;
        continue;
      }
      if (t == 0 && !persistent) a.v1mean[idx] = mean;
      float sample = mean;
      if (sample_v) {
        if (gaussian)
          sample = mean + (uv ? uv[idx] : draw_normal(a.seed, 0u, kDrawV, t, r, q));
        else
          sample = (uv ? uv[idx] : draw_uniform(a.seed, 0u, kDrawV, t, r, q)) < mean ? 1.0f
                                                                                    : 0.0f;
      }
      a.vs[idx] = sample;
    }
  }
}

// gW, gb, gc and err. gW unit (one block): kQStrip consecutive visible units x
// kThreads hidden columns (thread = column); the strip's masked v0 and vs
// columns are staged in shared memory, and each thread sums its elements over
// the rows in row order. gb and gc: one warp per element, lanes over the rows,
// fixed butterfly. err: block 0's first warp adds the monitor's row sums.
template <bool kBf>
__device__ void grads_phase(const Args& a, float* smem, const Split& s) {
  const int V = a.V, H = a.H, B = a.B;
  const float inv = a.inv_norm;
  constexpr int kRowChunk = kSmemFloats / (2 * kQStrip);  // rows of a strip staged at once
  const int nstrip = (V + kQStrip - 1) / kQStrip, njc = (H + kThreads - 1) / kThreads;
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const float tot = rows_total(a.rowerr, B);
    if (threadIdx.x == 0)
      *a.err = (a.flags & kXent) ? -tot * inv : tot * inv * (1.0f / static_cast<float>(V));
  }
  for (int unit = blockIdx.x; unit < nstrip * njc; unit += gridDim.x) {
    const int strip = unit % nstrip, cu = unit / nstrip;
    const int q0 = strip * kQStrip, j = cu * kThreads + threadIdx.x;
    const int nq = min(kQStrip, V - q0);
    float pos[kQStrip], neg[kQStrip];
#pragma unroll
    for (int qi = 0; qi < kQStrip; ++qi) pos[qi] = neg[qi] = 0.0f;
    for (int rc = 0; rc < B; rc += kRowChunk) {
      const int nr = min(kRowChunk, B - rc);
      __syncthreads();  // smem of the previous chunk or unit is no longer read
      for (int idx = threadIdx.x; idx < nr * kQStrip; idx += kThreads) {
        const int rr = idx / kQStrip, qi = idx - rr * kQStrip;
        const size_t g = static_cast<size_t>(rc + rr) * V + q0 + qi;
        const float m = row_mask(a, rc + rr);
        smem[rr * 2 * kQStrip + qi] = qi < nq ? op<kBf>(a.v0[g] * m) : 0.0f;
        smem[rr * 2 * kQStrip + kQStrip + qi] = qi < nq ? op<kBf>(a.vs[g] * m) : 0.0f;
      }
      __syncthreads();
      if (j < H) {
#pragma unroll 4
        for (int rr = 0; rr < nr; ++rr) {
          const size_t hj = static_cast<size_t>(rc + rr) * H + j;
          const float hp = op<kBf>(a.h0p[hj]), hm = op<kBf>(a.hmean[hj]);
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
      for (int qi = 0; qi < kQStrip; ++qi)
        if (qi < nq) a.gW[static_cast<size_t>(q0 + qi) * H + j] = (pos[qi] - neg[qi]) * inv;
    }
  }
  for (int o = s.gwarp; o < V + H; o += s.nwarps) {
    float acc = 0.0f, on = 0.0f;
    if (o < V) {
      for (int r = s.lane; r < B; r += 32) {
        const size_t g = static_cast<size_t>(r) * V + o;
        const float m = row_mask(a, r);
        acc += a.v0[g] * m - a.vs[g] * m;
      }
    } else {
      for (int r = s.lane; r < B; r += 32) {
        const size_t g = static_cast<size_t>(r) * H + o - V;
        const float m = row_mask(a, r);
        acc += (a.h0p[g] - a.hmean[g]) * m;
        on += a.h0p[g] * m;
      }
    }
    acc = warp_sum(acc);
    on = warp_sum(on);
    if (s.lane != 0) continue;
    if (o < V) {
      a.gb[o] = acc * inv;
    } else {
      float g = acc * inv;
      if (a.flags & kSparsity) g = g + a.sparsity_cost * (a.sparsity_target - on * inv);
      a.gc[o - V] = g;
    }
  }
}

template <bool kBf>
__global__ void __launch_bounds__(kThreads, 1) cd_grads_kernel(Args a) {
  __shared__ float smem[kSmemFloats];  // 36 KB: staged row tiles + partial sums
  cg::grid_group grid = cg::this_grid();
  const Split s;
  const bool inject = a.flags & kInject;
  const bool persistent = a.flags & kPersistent;
  const size_t bh = static_cast<size_t>(a.B) * a.H;
  hidden_phase<kBf>(a, smem, a.v0, a.h0p, a.h0s, inject ? a.u_h0 : nullptr, kDrawH0, 0, false);
  if (!persistent) {  // CD: the chain passes through unchanged
    for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < bh;
         i += static_cast<size_t>(gridDim.x) * kThreads)
      a.chain_out[i] = a.chain_in[i];
  }
  grid.sync();
  float* hdst = persistent ? a.chain_out : a.hbuf;
  for (int t = 0; t < a.k; ++t) {
    const float* hsrc = t > 0 ? hdst : (persistent ? a.chain_in : a.h0s);
    visible_phase<kBf>(a, smem, hsrc, t, t == 0 && persistent);
    grid.sync();
    hidden_phase<kBf>(a, smem, a.vs, a.hmean, hdst, inject ? a.u_h + t * bh : nullptr, kDrawH, t,
                      t == 0);
    grid.sync();
  }
  grads_phase<kBf>(a, smem, s);
}

// The update after the all-reduce, the second kernel of a data-parallel step:
// every rank launches it on the same summed buffer, so every rank's W, b and c
// stay bit-identical. Replaces the update in the body of the TPU's DP
// mega-kernel (mdbn_tpu/ops/cd_epoch_pallas.py:1622-1687, the DP mode of
// _cd_train_kernel built at :3039), which there follows its in-kernel
// exchange. Per element, with g = sums * scale (scale = 1 / ranks):
//   clip g (when asked), g -= l2 * W (W only), vel = m * vel + lr * g,
//   param += vel.
// Each product and sum rounds on its own (__fmul_rn, __fadd_rn: no fused
// multiply-add), as the plain version's separate PyTorch ops do, so the two
// give the same bits. Bound by bytes: it reads the sums, W, b, c and their
// velocities once and writes the parameters and velocities once (c1: 7.8 MB,
// 2.3 us at 3.35 TB/s); one element per thread, grid-stride.
struct UpdateArgs {
  const float* sums;  // [V*H + V + H + 1]: gW, gb, gc, err summed over the ranks
  float* W;           // [V, H], in place
  float* b;           // [V]
  float* c;           // [H]
  float* vW;          // velocities, in place
  float* vb;
  float* vc;
  float* err;  // [1]: the step's mean monitor
  long long nW;
  int V, H, flags;
  float scale, lr, m, l2, grad_clip;
};

__device__ __forceinline__ void update_one(const UpdateArgs& a, float* p, float* vel, float g,
                                           bool decay) {
  if (a.flags & kClip) g = fminf(fmaxf(g, -a.grad_clip), a.grad_clip);
  const float old = *p;
  if (decay && a.l2 != 0.0f) g = __fsub_rn(g, __fmul_rn(a.l2, old));
  const float nv = __fadd_rn(__fmul_rn(a.m, *vel), __fmul_rn(a.lr, g));
  *vel = nv;
  *p = __fadd_rn(old, nv);
}

__global__ void __launch_bounds__(kThreads) cd_update_kernel(UpdateArgs a) {
  const long long n = a.nW + a.V + a.H;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const float g = __fmul_rn(a.sums[i], a.scale);
    if (i < a.nW)
      update_one(a, a.W + i, a.vW + i, g, true);
    else if (i < a.nW + a.V)
      update_one(a, a.b + (i - a.nW), a.vb + (i - a.nW), g, false);
    else
      update_one(a, a.c + (i - a.nW - a.V), a.vc + (i - a.nW - a.V), g, false);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.err = __fmul_rn(a.sums[n], a.scale);
}

// Points the scratch fields of `a` into `base` (when not null) and returns
// the floats they take.
long long carve_scratch(Args& a, float* base, int V, int H, int B) {
  const long long bh = static_cast<long long>(B) * H, bv = static_cast<long long>(B) * V;
  long long n = 0;
  auto take = [&](long long count) {
    float* p = base ? base + n : nullptr;
    n += count;
    return p;
  };
  a.h0p = take(bh);
  a.h0s = take(bh);
  a.hbuf = take(bh);
  a.hmean = take(bh);
  a.vs = take(bv);
  a.v1mean = take(bv);
  a.rowerr = take(B);
  return n;
}

}  // namespace

extern "C" {

// Launches one step on `stream`. grid <= 0 picks one block per SM. Returns a
// cudaError_t (0 on success); a grid larger than the co-resident block count
// returns cudaErrorCooperativeLaunchTooLarge without launching.
int cd_grads_step(const float* v0, const float* mask, const float* u_h0, const float* u_h,
                  const float* u_v, const float* W, const float* b, const float* c,
                  const float* chain_in, float* gW, float* gb, float* gc, float* chain_out,
                  float* err, float* scratch, int V, int H, int B, int k, int flags,
                  float inv_norm, float sparsity_target, float sparsity_cost,
                  unsigned long long seed, int device, int grid, void* stream) {
  // the device's SM count and each variant's co-resident blocks per SM, asked once
  static int nsm[64] = {0}, per_sm[64][2] = {{0}};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  cudaError_t err_ = cudaSetDevice(device);
  if (err_ != cudaSuccess) return err_;
  const bool bf = flags & kBf16;
  const void* fn = bf ? reinterpret_cast<const void*>(&cd_grads_kernel<true>)
                      : reinterpret_cast<const void*>(&cd_grads_kernel<false>);
  if (nsm[device] == 0) {
    int coop = 0;
    if ((err_ = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) !=
        cudaSuccess)
      return err_;
    if (!coop) return cudaErrorNotSupported;
    int n = 0;
    if ((err_ = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return err_;
    for (int v = 0; v < 2; ++v) {
      const void* f = v ? reinterpret_cast<const void*>(&cd_grads_kernel<true>)
                        : reinterpret_cast<const void*>(&cd_grads_kernel<false>);
      if ((err_ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[device][v], f, kThreads,
                                                                0)) != cudaSuccess)
        return err_;
    }
    nsm[device] = n;
  }
  if (grid <= 0) grid = nsm[device];
  if (grid > per_sm[device][bf ? 1 : 0] * nsm[device]) return cudaErrorCooperativeLaunchTooLarge;

  Args a;
  a.v0 = v0; a.mask = mask; a.u_h0 = u_h0; a.u_h = u_h; a.u_v = u_v;
  a.W = W; a.b = b; a.c = c; a.chain_in = chain_in;
  a.gW = gW; a.gb = gb; a.gc = gc; a.chain_out = chain_out; a.err = err;
  carve_scratch(a, scratch, V, H, B);
  a.V = V; a.H = H; a.B = B; a.k = k; a.flags = flags;
  a.inv_norm = inv_norm; a.sparsity_target = sparsity_target; a.sparsity_cost = sparsity_cost;
  a.seed = seed;

  void* params[] = {&a};
  err_ = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), params, 0,
                                     static_cast<cudaStream_t>(stream));
  if (err_ != cudaSuccess) return err_;
  return cudaGetLastError();
}

// Launches the update on `stream`: one thread per element of W, b and c, at
// most 8 blocks per SM. Returns a cudaError_t (0 on success).
int cd_update_step(const float* sums, float* W, float* b, float* c, float* vW, float* vb,
                   float* vc, float* err, int V, int H, int flags, float scale, float lr,
                   float m, float l2, float grad_clip, int device, void* stream) {
  static int nsm[64] = {0};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  cudaError_t err_ = cudaSetDevice(device);
  if (err_ != cudaSuccess) return err_;
  if (nsm[device] == 0 &&
      (err_ = cudaDeviceGetAttribute(&nsm[device], cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return err_;
  UpdateArgs a;
  a.sums = sums; a.W = W; a.b = b; a.c = c; a.vW = vW; a.vb = vb; a.vc = vc; a.err = err;
  a.nW = static_cast<long long>(V) * H;
  a.V = V; a.H = H; a.flags = flags;
  a.scale = scale; a.lr = lr; a.m = m; a.l2 = l2; a.grad_clip = grad_clip;
  const long long n = a.nW + V + H;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 8LL * nsm[device] ? blocks : 8LL * nsm[device]);
  cd_update_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// Scratch floats the wrapper allocates for one step.
long long cd_grads_scratch_floats(int V, int H, int B) {
  Args a;
  return carve_scratch(a, nullptr, V, H, B);
}

const char* cd_grads_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
