// The phases that csrc/cd_train.cu (the single-device run) and
// csrc/cd_grads.cu (the data-parallel step) share: the products of a batch
// of rows with W (hidden phase) and with W^T (visible phase, with the
// epilogue of each role), the pseudo-likelihood monitor's rows and the
// tempering ladder's swap rounds. Each is a template on the kernel's
// argument struct A, which names its buffers alike: W, b, c (Store), the
// chain, the scratch (h0p, hmean, vs, v1mean, rowerr, pre_h0, s_lv, sig_lv,
// wh_a, pre_lp), the draws (u_v, u_swap, seed), betas and the sizes (V, H,
// B, M, CR, k, flags). Every sum runs in a fixed order, so the bits do not
// depend on the grid; see csrc/cd_train.cu for the design.

#pragma once

#include "cd_common.cuh"

namespace {

constexpr int kRowTile = 4;    // batch rows per accumulator tile (any B: loop over tiles)
constexpr int kStage = 2048;   // columns of a row tile staged in shared memory at once
constexpr int kQPerWarp = 4;   // visible units per warp in the visible phase
constexpr int kQStrip = 16;    // visible units per W unit of the update phase
constexpr int kSmemFloats = kRowTile * kStage + kWarps * kRowTile * 32;

// Inverse temperature of chain row r (1 off a tempering ladder).
template <bool kModes, class A>
__device__ __forceinline__ float row_beta(const A& a, int r) {
  return (kModes && (a.flags & kTempering)) ? a.betas[r / a.B] : 1.0f;
}

// Copies rows [r0, r0 + kRowTile) x columns [c0, c0 + n) of the row-major
// [rows, ld] matrix src into tile[kRowTile][kStage] (zero past the last row),
// times scale[column] when scale is given, times e^{-zscale[column]} when
// zscale is given, rounding to bf16 when kBf. T: Store (data, samples) or
// float (scratch). All threads of the block take part.
template <bool kBf, bool kModes, typename T>
__device__ __forceinline__ void stage_rows(float* tile, const T* src, int rows, int stride,
                                           int r0, int c0, int n, const float* scale,
                                           const Store* zscale) {
  for (int idx = threadIdx.x; idx < kRowTile * n; idx += kThreads) {
    const int rr = idx / n, cc = idx - rr * n;
    float x = 0.0f;
    if (r0 + rr < rows) {
      x = ld(src + static_cast<size_t>(r0 + rr) * stride + c0 + cc);
      if (kModes && scale) x *= scale[c0 + cc];
      if (kModes && zscale) x *= expf(-ld(zscale + c0 + cc));
      x = op<kBf>(x);
    }
    tile[rr * kStage + cc] = x;
  }
}

// h = sigmoid(beta_r (x W + c)) for all rows x H outputs, then h_sample =
// (u < h); x [rows, V] (the data, or f32 scratch), scaled per column as stage_rows says (learned
// variance); beta_r = 1 off a tempering ladder. pre_out, when given,
// receives x W + c (the pseudo monitor's pre_h0). With nmon > 0, nmon more
// units each sum row r of the reconstruction monitor, of mon_v0 [nmon, V]
// against a.v1mean, into a.rowerr[r].
// Work unit: 32 hidden columns (lane = column) x kRowTile rows, one block.
// The unit's rows of x are staged in shared memory (kStage columns at a
// time); warp w sums the products over v = w, w + kWarps, ... into kRowTile
// registers, so each W element is read once per row tile; the kWarps partial
// sums are then added in warp order. The summation order depends only on
// kWarps, not on the grid.
template <bool kBf, bool kModes, class A, typename T>
__device__ void hidden_phase(const A& a, float* smem, const T* x, int rows,
                             const float* scale, const Store* zscale, float* hprob,
                             Store* hsample, float* pre_out, const float* u, unsigned upd,
                             int kind, int t, const Store* mon_v0 = nullptr, int nmon = 0) {
  float* xs = smem;                       // [kRowTile][kStage]
  float* part = smem + kRowTile * kStage;  // [kWarps][kRowTile][32]
  const int V = a.V, H = a.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncol = (H + 31) / 32, nrow = (rows + kRowTile - 1) / kRowTile;
  const int nprod = ncol * nrow;
  for (int unit = blockIdx.x; unit < nprod + nmon; unit += gridDim.x) {
    if (unit >= nprod) {  // the monitor's sum over one row (v1mean is complete)
      const size_t row = static_cast<size_t>(unit - nprod) * V;
      __syncthreads();  // smem of the previous unit is no longer read
      monitor_row(mon_v0 + row, a.v1mean + row, V, a.flags & kXent, smem,
                  a.rowerr + (unit - nprod));
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
      stage_rows<kBf, kModes>(xs, x, rows, V, r0, q0, nq, scale, zscale);
      __syncthreads();
      if (j < H) {
        const Store* wcol = a.W + static_cast<size_t>(q0) * H + j;
#pragma unroll 8
        for (int qq = warp; qq < nq; qq += kWarps) {
          const float w = op<kBf>(ld(wcol + static_cast<size_t>(qq) * H));
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
      if (r < rows && jj < H) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += part[(w * kRowTile + rr) * 32 + lane];
        const size_t idx = static_cast<size_t>(r) * H + jj;
        const float pre = sum + ld(a.c + jj);
        if (kModes && pre_out) pre_out[idx] = pre;
        const float p = sigmoidf(row_beta<kModes>(a, r) * pre);
        hprob[idx] = p;
        const float uu = u ? u[idx] : draw_uniform(a.seed, upd, kind, t, r, jj);
        st(hsample + idx, uu < p ? 1.0f : 0.0f);
      }
    }
  }
}

// Row r of the pseudo-likelihood monitor. Flipping visible bit `bit` moves
// the hidden pre-activation by delta W[bit] (a rank-1 update of pre_h0), so
// FE(v0) - FE(flip) = delta b_bit + sum_j [softplus(pre + delta W[bit, j]) -
// softplus(pre)]; rowerr[r] = V softplus(that). Reads W and b, so it runs
// before the update phase.
template <class A>
__device__ void pseudo_row(const A& a, float* smem, const Store* v0, int r, int bit) {
  const int H = a.H, V = a.V;
  const float delta = 1.0f - 2.0f * ld(v0 + static_cast<size_t>(r) * V + bit);
  const float* pre = a.pre_h0 + static_cast<size_t>(r) * H;
  const Store* w = a.W + static_cast<size_t>(bit) * H;
  float acc[1] = {0.0f};
  for (int j = threadIdx.x; j < H; j += kThreads)
    acc[0] += softplusf(pre[j] + delta * ld(w + j)) - softplusf(pre[j]);
  block_sum<1>(acc, smem);
  if (threadIdx.x == 0)
    a.rowerr[r] = static_cast<float>(V) * softplusf(delta * ld(a.b + bit) + acc[0]);
}

// What a visible-shaped product (rows of src [rows, H] times W^T) is for.
enum Role {
  kRoleGibbs,    // Gibbs step t's visible mean and sample -> vs (CD: v1mean at t = 0)
  kRoleMonitor,  // the data chain's reconstruction -> v1mean (src = h0s)
  kRolePreLp,    // the ladder's h W^T + b -> pre_lp (tempering swap rounds)
  kRoleWhData,   // A = (v0 - b)^2/2 - v0 (W h0p) -> wh_a rows [0, B)
  kRoleWhModel,  // A = (vs - b)^2/2 - vs (W hmean) -> wh_a rows [B, 2B)
};

// The rows come from samples (the chain, h0s, the CD chain buffer: Store) or
// from probs (h0p, hmean: f32 scratch); the other pointer is null. A segment
// of no rows takes no units.
struct Seg {
  const Store* samples;
  const float* probs;
  int rows;
  int role;
};

__device__ __forceinline__ Seg no_seg() { return Seg{nullptr, nullptr, 0, kRoleGibbs}; }

// Visible-shaped products of up to three row segments, each with its role's
// epilogue, in one phase; then, when pseudo_bit >= 0, B units of the pseudo
// monitor. The segments come by value, so they stay in registers. Work
// unit: kRowTile rows x kWarps * kQPerWarp visible units, one block, with
// the rows of src staged in shared memory; each warp takes kQPerWarp
// visible units, its lanes stride over H (coalesced rows of W) and a fixed
// butterfly sums each output.
template <bool kBf, bool kModes, class A>
__device__ void visible_phase(const A& a, float* smem, Seg s0, Seg s1, Seg s2,
                              const Store* v0, unsigned upd, size_t ei, int t, int pseudo_bit) {
  float* hs = smem;  // [kRowTile][kStage]
  const int V = a.V, H = a.H, B = a.B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool gaussian = a.flags & kGaussian;
  const bool sample_v = a.flags & kSampleVisible;
  const bool persistent = a.flags & kPersistent;
  const bool tempering = kModes && (a.flags & kTempering);
  const bool lv = kModes && (a.flags & kLearnVar);
  constexpr int kQBlock = kWarps * kQPerWarp;
  const int nqb = (V + kQBlock - 1) / kQBlock;
  const int b1 = ((s0.rows + kRowTile - 1) / kRowTile) * nqb;
  const int b2 = b1 + ((s1.rows + kRowTile - 1) / kRowTile) * nqb;
  const int nprod = b2 + ((s2.rows + kRowTile - 1) / kRowTile) * nqb;
  const int nout = nprod + ((kModes && pseudo_bit >= 0) ? B : 0);
  const float* uv = nullptr;
  if ((a.flags & kInject) && sample_v)
    uv = a.u_v + (ei * a.k + t) * static_cast<size_t>(a.CR) * V;
  for (int unit = blockIdx.x; unit < nout; unit += gridDim.x) {
    if (unit >= nprod) {
      pseudo_row(a, smem, v0, unit - nprod, pseudo_bit);
      continue;
    }
    const Seg seg = unit < b1 ? s0 : unit < b2 ? s1 : s2;
    const int uu = unit - (unit < b1 ? 0 : unit < b2 ? b1 : b2);
    const int r0 = (uu / nqb) * kRowTile, qbase = (uu % nqb) * kQBlock + warp * kQPerWarp;
    float acc[kQPerWarp][kRowTile];
#pragma unroll
    for (int qi = 0; qi < kQPerWarp; ++qi)
#pragma unroll
      for (int rr = 0; rr < kRowTile; ++rr) acc[qi][rr] = 0.0f;
    for (int j0 = 0; j0 < H; j0 += kStage) {
      const int nj = min(kStage, H - j0);
      __syncthreads();
      if (seg.samples)
        stage_rows<kBf, false>(hs, seg.samples, seg.rows, H, r0, j0, nj, nullptr, nullptr);
      else
        stage_rows<kBf, false>(hs, seg.probs, seg.rows, H, r0, j0, nj, nullptr, nullptr);
      __syncthreads();
#pragma unroll
      for (int qi = 0; qi < kQPerWarp; ++qi) {
        const int q = qbase + qi;
        if (q >= V) break;
        const Store* wrow = a.W + static_cast<size_t>(q) * H + j0;
#pragma unroll 4
        for (int j = lane; j < nj; j += 32) {
          const float w = op<kBf>(ld(wrow + j));
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
      if (q >= V || lane >= kRowTile || r >= seg.rows) continue;
      const size_t idx = static_cast<size_t>(r) * V + q;
      switch (seg.role) {
        case kRoleGibbs: {
          const float pre = mine + ld(a.b + q);
          const float beta = row_beta<kModes>(a, r);
          const float mean = gaussian ? pre : sigmoidf(beta * pre);
          if (t == 0 && !persistent) a.v1mean[idx] = mean;
          float sample = mean;
          if (sample_v) {
            if (gaussian) {
              float n = uv ? uv[idx] : draw_normal(a.seed, upd, kDrawV, t, r, q);
              if (tempering) n = n / sqrtf(beta);  // variance sigma^2 / beta
              if (lv) n = n * a.sig_lv[q];
              sample = mean + n;
            } else {
              const float u2 = uv ? uv[idx] : draw_uniform(a.seed, upd, kDrawV, t, r, q);
              sample = u2 < mean ? 1.0f : 0.0f;
            }
          }
          a.vs[idx] = sample;
          break;
        }
        case kRoleMonitor: {
          const float pre = mine + ld(a.b + q);
          a.v1mean[idx] = gaussian ? pre : sigmoidf(pre);
          break;
        }
        case kRolePreLp:
          a.pre_lp[idx] = mine + ld(a.b + q);
          break;
        case kRoleWhData: {
          const float x = ld(v0 + idx), d = x - ld(a.b + q);
          a.wh_a[idx] = 0.5f * (d * d) - x * mine;
          break;
        }
        default: {  // kRoleWhModel
          const float x = a.vs[idx], d = x - ld(a.b + q);
          a.wh_a[static_cast<size_t>(B) * V + idx] = 0.5f * (d * d) - x * mine;
          break;
        }
      }
    }
  }
}

// Swap round p of the tempering ladder. For each pair (m, m+1), m = p, p+2,
// ... < M-1, and each row r: the Metropolis log ratio of exchanging the two
// rungs' hidden states, log a = lp_{b_m}(h_{m+1}) + lp_{b_m+1}(h_m) -
// lp_{b_m}(h_m) - lp_{b_m+1}(h_{m+1}), with log p*_beta(h) = beta c.h +
// sum_q softplus(beta pre_lp) (Bernoulli) or beta (c.h + sum_q (wh b +
// wh^2/2) s), wh = pre_lp - b (Gaussian). An accepted pair exchanges its
// chain rows and its pre_lp rows (pre_lp is a function of h alone). One
// block per (pair, row): the rows it reads and writes are its own.
template <bool kBf, class A>
__device__ void swap_phase(const A& a, float* smem, unsigned upd, size_t ei, int p) {
  const int B = a.B, V = a.V, H = a.H, M = a.M;
  const bool gaussian = a.flags & kGaussian, lv = a.flags & kLearnVar;
  const int npairs = (M - p) / 2;
  for (int unit = blockIdx.x; unit < npairs * B; unit += gridDim.x) {
    const int m = p + 2 * (unit / B), r = unit % B;
    const size_t r0 = static_cast<size_t>(m) * B + r, r1 = r0 + B;
    const float b0 = a.betas[m], b1 = a.betas[m + 1];
    float* x0 = a.pre_lp + r0 * V;
    float* x1 = a.pre_lp + r1 * V;
    Store* h0 = a.chain + r0 * H;
    Store* h1 = a.chain + r1 * H;
    // Bernoulli: softplus sums of h_m at b_m, b_m+1, of h_m+1 at b_m+1, b_m;
    // Gaussian: the quadratic sums of h_m, h_m+1 in [0], [1]; then c.h_m, c.h_m+1
    float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int q = threadIdx.x; q < V; q += kThreads) {
      if (gaussian) {
        const float bq = ld(a.b + q), sq = lv ? a.s_lv[q] : 1.0f;
        const float w0 = x0[q] - bq, w1 = x1[q] - bq;
        acc[0] += (w0 * bq + 0.5f * w0 * w0) * sq;
        acc[1] += (w1 * bq + 0.5f * w1 * w1) * sq;
      } else {
        acc[0] += softplusf(b0 * x0[q]);
        acc[1] += softplusf(b1 * x0[q]);
        acc[2] += softplusf(b1 * x1[q]);
        acc[3] += softplusf(b0 * x1[q]);
      }
    }
    for (int j = threadIdx.x; j < H; j += kThreads) {
      const float cj = op<kBf>(ld(a.c + j));
      acc[4] = fmaf(ld(h0 + j), cj, acc[4]);
      acc[5] = fmaf(ld(h1 + j), cj, acc[5]);
    }
    block_sum<6>(acc, smem);  // every thread holds the same sums
    float log_a;
    if (gaussian) {
      const float l0 = acc[4] + acc[0], l1 = acc[5] + acc[1];
      log_a = b0 * l1 + b1 * l0 - b0 * l0 - b1 * l1;
    } else {
      log_a = (b0 * acc[5] + acc[3]) + (b1 * acc[4] + acc[1]) - (b0 * acc[4] + acc[0]) -
              (b1 * acc[5] + acc[2]);
    }
    const float u = (a.flags & kInject)
                        ? a.u_swap[(ei * 2 + p) * static_cast<size_t>(M - 1) * B +
                                   static_cast<size_t>(m) * B + r]
                        : draw_uniform(a.seed, upd, kDrawSwap, p, static_cast<int>(r0), 0);
    if (logf(fmaxf(u, 1e-38f)) < log_a) {  // the same outcome in every thread
      for (int j = threadIdx.x; j < H; j += kThreads) {
        const Store tmp = h0[j];
        h0[j] = h1[j];
        h1[j] = tmp;
      }
      for (int q = threadIdx.x; q < V; q += kThreads) {
        const float tmp = x0[q];
        x0[q] = x1[q];
        x1[q] = tmp;
      }
    }
  }
}

}  // namespace
