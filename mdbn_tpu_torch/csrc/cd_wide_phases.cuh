// The phases that csrc/cd_train_wide.cu (the single-device W-blocked run)
// and csrc/cd_grads_wide.cu (its data-parallel step and update) share: the
// x W product as a sum over fixed strips of W's rows (xw_partial_phase, then
// hidden_reduce_phase), the h W^T product (visible_phase), and the gradient
// and update of W, b and c (update_phase). Each is a template on the
// kernel's argument struct A, which names its buffers alike: W, b, c (Store),
// the strips' partial sums part, vs (the negative-phase visibles, f32 or
// Store: both hold values rounded through Store), v1mean, and the sizes (V,
// H, B: the rows of a product, NS: the strips, flags, seed, and for the
// update lr, l2, grad_clip, sparsity_target, sparsity_cost). The update
// reads its rows through a row source R (BatchRows, or the gathered factors
// of the data-parallel update), so the same sums run over one batch or over
// every rank's rows in rank order. Every sum runs in a fixed order, so the
// bits do not depend on the grid; see csrc/cd_train_wide.cu for the design.

#pragma once

#include "cd_common.cuh"

namespace {

constexpr int kStripRows = 512;    // rows of W per strip of an x W product (fixed: see above)
constexpr int kRowsPerWarp = 16;   // W rows a warp holds in registers at once
constexpr int kSub = kWarps * kRowsPerWarp;  // strip rows staged at once
constexpr int kRowGroup = 24;      // batch rows summed per pass of an x W unit
constexpr int kRowTile = 4;        // batch rows per accumulator tile of h W^T
constexpr int kStage = 2048;       // hidden columns of a row tile staged at once
constexpr int kQPerWarp = 4;       // W rows per warp in h W^T
constexpr int kQStrip = 16;        // W rows per unit of the update phase
constexpr int kSmemFloats = kRowGroup * kSub + kWarps * kRowGroup * 32;
static_assert(kSmemFloats >= kRowTile * kStage, "h W^T stages kRowTile x kStage floats");
static_assert(kRowsPerWarp % 4 == 0, "x tiles are read as float4");

// The reconstruction monitor's rows that ride as extra units of a phase:
// row r sums x0[r] against v1mean[r] into rowerr[r] (monitor_row), r < n.
struct Monitor {
  const Store* x0 = nullptr;
  const float* v1mean = nullptr;
  float* rowerr = nullptr;
  int n = 0;
};

// One batch's rows, contiguous: the data x0 [rows, V] (Store), the
// negative-phase visibles xs [rows, V] and the hidden probabilities of the
// two phases [rows, H].
struct BatchRows {
  const Store* x0;
  const float* xs;
  const float* h0p;
  const float* hmean;
  int V, H;
  __device__ __forceinline__ float v0(int r, int q) const {
    return ld(x0 + static_cast<size_t>(r) * V + q);
  }
  __device__ __forceinline__ float vs(int r, int q) const {
    return xs[static_cast<size_t>(r) * V + q];
  }
  __device__ __forceinline__ float hp(int r, int j) const { return h0p[r * H + j]; }
  __device__ __forceinline__ float hm(int r, int j) const { return hmean[r * H + j]; }
};

// part[s] = x[:, strip s] W[strip s, :] for every strip s; x [B, V] is the
// data (Store) or vs (f32 or Store). mon's rows run as mon.n more units
// (v1mean must be complete).
template <bool kBf, class A, typename T>
__device__ void xw_partial_phase(const A& a, float* smem, const T* x, const Monitor& mon = {}) {
  float* xs = smem;                       // [kRowGroup][kSub]
  float* accs = smem + kRowGroup * kSub;  // [kWarps][kRowGroup][32]
  const int V = a.V, H = a.H, B = a.B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncol = (H + 31) / 32, nprod = a.NS * ncol;
  float* mine = accs + warp * kRowGroup * 32 + lane;
  for (int unit = blockIdx.x; unit < nprod + mon.n; unit += gridDim.x) {
    if (unit >= nprod) {  // one row of the monitor
      const int r = unit - nprod;
      __syncthreads();  // smem of the previous unit is no longer read
      monitor_row(mon.x0 + static_cast<size_t>(r) * V, mon.v1mean + static_cast<size_t>(r) * V,
                  V, a.flags & kXent, smem, mon.rowerr + r);
      continue;
    }
    const int s = unit / ncol, j0 = (unit % ncol) * 32, j = j0 + lane;
    const int q_lo = s * kStripRows, q_hi = min(V, q_lo + kStripRows);
    for (int rg0 = 0; rg0 < B; rg0 += kRowGroup) {
      const int nr = min(kRowGroup, B - rg0);
      for (int rr = 0; rr < nr; ++rr) mine[rr * 32] = 0.0f;  // this thread's own slots
      for (int q0 = q_lo; q0 < q_hi; q0 += kSub) {
        const int nq = min(kSub, q_hi - q0);
        __syncthreads();  // the previous tile of x is no longer read
        for (int idx = threadIdx.x; idx < nr * kSub; idx += kThreads) {
          const int rr = idx / kSub, cc = idx - rr * kSub;
          xs[idx] = cc < nq ? op<kBf>(ld(x + static_cast<size_t>(rg0 + rr) * V + q0 + cc))
                            : 0.0f;
        }
        __syncthreads();
        float w[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int q = q0 + warp * kRowsPerWarp + i;
          w[i] = (q < q_hi && j < H) ? op<kBf>(ld(a.W + static_cast<size_t>(q) * H + j)) : 0.0f;
        }
        const float* xw = xs + warp * kRowsPerWarp;
        for (int rr = 0; rr < nr; ++rr) {
          const float4* x4 = reinterpret_cast<const float4*>(xw + rr * kSub);
          float p = 0.0f;
#pragma unroll
          for (int i = 0; i < kRowsPerWarp / 4; ++i) {
            const float4 xv = x4[i];
            p = fmaf(xv.x, w[4 * i], p);
            p = fmaf(xv.y, w[4 * i + 1], p);
            p = fmaf(xv.z, w[4 * i + 2], p);
            p = fmaf(xv.w, w[4 * i + 3], p);
          }
          mine[rr * 32] += p;
        }
      }
      __syncthreads();  // every warp's sums are complete
      for (int idx = threadIdx.x; idx < nr * 32; idx += kThreads) {
        const int rr = idx >> 5, l = idx & 31;
        if (j0 + l < H) {
          float sum = 0.0f;
#pragma unroll
          for (int wv = 0; wv < kWarps; ++wv) sum += accs[(wv * kRowGroup + rr) * 32 + l];
          a.part[(static_cast<size_t>(s) * B + rg0 + rr) * H + j0 + l] = sum;
        }
      }
      __syncthreads();  // the sums are read before the next group clears them
    }
  }
}

// hprob = sigmoid(sum over strips of part, in strip order, + c) and
// hsample = (u < hprob), for all B x H outputs; one thread per output. With
// hsigned, also hsigned = sign * hprob on the first nvalid rows and 0 on the
// rest (the data-parallel step's h-matrix).
template <class A>
__device__ void hidden_reduce_phase(const A& a, float* hprob, Store* hsample, const float* u,
                                    unsigned upd, int kind, int t, float* hsigned = nullptr,
                                    float sign = 1.0f, int nvalid = 0) {
  const size_t n = static_cast<size_t>(a.B) * a.H;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; idx < n;
       idx += static_cast<size_t>(gridDim.x) * kThreads) {
    const float* p = a.part + idx;
    float sum = 0.0f;
#pragma unroll 8
    for (int s = 0; s < a.NS; ++s) sum += p[static_cast<size_t>(s) * n];
    const int r = static_cast<int>(idx / a.H), j = static_cast<int>(idx - static_cast<size_t>(r) * a.H);
    const float pr = sigmoidf(sum + ld(a.c + j));
    hprob[idx] = pr;
    if (hsigned) hsigned[idx] = r < nvalid ? sign * pr : 0.0f;
    const float uu = u ? u[idx] : draw_uniform(a.seed, upd, kind, t, r, j);
    st(hsample + idx, uu < pr ? 1.0f : 0.0f);
  }
}

// Gibbs step t's visible mean of h [B, H]: vs (rounded through Store), and
// v1mean when this is the CD monitor's step (t = 0, not persistent); then,
// when mon is given (PCD, t = 0), the reconstruction from mon -> v1mean.
// Work unit: kWarps * kQPerWarp rows of W, one block; for each tile of
// kRowTile batch rows (staged in shared memory) each warp takes its
// kQPerWarp rows of W, its lanes stride over H (coalesced rows of W) and a
// fixed butterfly sums each output.
template <bool kBf, class A>
__device__ void visible_phase(const A& a, float* smem, const Store* h, const Store* mon, int t) {
  float* hs = smem;  // [kRowTile][kStage]
  const int V = a.V, H = a.H, B = a.B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool gaussian = a.flags & kGaussian;
  const bool cd_monitor = t == 0 && !(a.flags & kPersistent);
  constexpr int kQBlock = kWarps * kQPerWarp;
  const int nqb = (V + kQBlock - 1) / kQBlock;
  for (int unit = blockIdx.x; unit < nqb; unit += gridDim.x) {
    const int qbase = unit * kQBlock + warp * kQPerWarp;
    for (int sg = 0; sg < (mon ? 2 : 1); ++sg) {
      const Store* src = sg == 0 ? h : mon;
      for (int r0 = 0; r0 < B; r0 += kRowTile) {
        float acc[kQPerWarp][kRowTile];
#pragma unroll
        for (int qi = 0; qi < kQPerWarp; ++qi)
#pragma unroll
          for (int rr = 0; rr < kRowTile; ++rr) acc[qi][rr] = 0.0f;
        for (int j0 = 0; j0 < H; j0 += kStage) {
          const int nj = min(kStage, H - j0);
          __syncthreads();  // the previous tile is no longer read
          for (int idx = threadIdx.x; idx < kRowTile * nj; idx += kThreads) {
            const int rr = idx / nj, cc = idx - rr * nj;
            hs[rr * kStage + cc] =
                r0 + rr < B ? op<kBf>(ld(src + static_cast<size_t>(r0 + rr) * H + j0 + cc))
                            : 0.0f;
          }
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
          if (q >= V || lane >= kRowTile || r >= B) continue;
          const size_t idx = static_cast<size_t>(r) * V + q;
          const float pre = mine + ld(a.b + q);
          const float mean = gaussian ? pre : sigmoidf(pre);
          if (sg == 1) {
            a.v1mean[idx] = mean;
          } else {
            if (cd_monitor) a.v1mean[idx] = mean;
            st(a.vs + idx, round_store(mean));
          }
        }
      }
    }
  }
}

// Gradient and update of W, b and c from the first nrows rows of `rows`
// (the gradient divides by nrows), plus mon's rows of the monitor.
// W unit (one block): kQStrip consecutive rows of W x kThreads hidden
// columns (thread = column). The strip's v0 and vs columns are staged in
// shared memory; each thread reads its columns of h0p and hmean once and
// sums each element over the rows in row order; in the units of the first
// column chunk, thread qi < kQStrip also sums v0 - vs of row qi of the strip
// over the rows and updates b. Monitor unit (one block): one batch row.
// c: one warp per element, lanes over the rows, fixed butterfly.
template <bool kBf, class A, class R>
__device__ void update_phase(const A& a, float* smem, const Split& s, const R& rows, int nrows,
                             float m, const Monitor& mon = {}) {
  const int V = a.V, H = a.H;
  const float inv_b = 1.0f / static_cast<float>(nrows);
  constexpr int kRowChunk = kSmemFloats / (2 * kQStrip);  // rows of the strip staged at once
  const int nstrip = (V + kQStrip - 1) / kQStrip, njc = (H + kThreads - 1) / kThreads;
  const int nwu = nstrip * njc;
  for (int unit = blockIdx.x; unit < nwu + mon.n; unit += gridDim.x) {
    __syncthreads();  // shared memory of the previous unit is no longer read
    if (unit >= nwu) {
      const size_t row = static_cast<size_t>(unit - nwu) * V;
      monitor_row(mon.x0 + row, mon.v1mean + row, V, a.flags & kXent, smem,
                  mon.rowerr + (unit - nwu));
      continue;
    }
    const int strip = unit % nstrip, cu = unit / nstrip;
    const int q0 = strip * kQStrip, j = cu * kThreads + threadIdx.x;
    const int nq = min(kQStrip, V - q0);
    float pos[kQStrip], neg[kQStrip];
#pragma unroll
    for (int qi = 0; qi < kQStrip; ++qi) pos[qi] = neg[qi] = 0.0f;
    float dsum = 0.0f;  // thread qi < nq of the first column chunk: sum of v0 - vs
    for (int rc = 0; rc < nrows; rc += kRowChunk) {
      const int nr = min(kRowChunk, nrows - rc);
      __syncthreads();
      for (int idx = threadIdx.x; idx < nr * kQStrip; idx += kThreads) {
        const int rr = idx / kQStrip, qi = idx - rr * kQStrip;
        smem[rr * 2 * kQStrip + qi] = qi < nq ? rows.v0(rc + rr, q0 + qi) : 0.0f;
        smem[rr * 2 * kQStrip + kQStrip + qi] = qi < nq ? rows.vs(rc + rr, q0 + qi) : 0.0f;
      }
      __syncthreads();
      if (cu == 0 && threadIdx.x < nq) {
        for (int rr = 0; rr < nr; ++rr)
          dsum += smem[rr * 2 * kQStrip + threadIdx.x] -
                  smem[rr * 2 * kQStrip + kQStrip + threadIdx.x];
      }
      if (j < H) {
#pragma unroll 2
        for (int rr = 0; rr < nr; ++rr) {
          const float hp = op<kBf>(rows.hp(rc + rr, j));
          const float hm = op<kBf>(rows.hm(rc + rr, j));
          const float* sv = smem + rr * 2 * kQStrip;
#pragma unroll
          for (int qi = 0; qi < kQStrip; ++qi) {
            pos[qi] = fmaf(op<kBf>(sv[qi]), hp, pos[qi]);
            neg[qi] = fmaf(op<kBf>(sv[kQStrip + qi]), hm, neg[qi]);
          }
        }
      }
    }
    if (j < H) {
#pragma unroll
      for (int qi = 0; qi < kQStrip; ++qi) pos[qi] = (pos[qi] - neg[qi]) * inv_b;
      const size_t w = static_cast<size_t>(q0) * H + j;
      apply_column<kQStrip>(a, a.W + w, a.vW + w, H, nq, pos, m);
    }
    if (cu == 0 && threadIdx.x < nq)
      apply(a, a.b + q0 + threadIdx.x, a.vb + q0 + threadIdx.x, dsum * inv_b, m, a.lr, false);
  }
  for (int o = s.gwarp; o < H; o += s.nwarps) {
    float acc = 0.0f, on = 0.0f;
    for (int r = s.lane; r < nrows; r += 32) {
      const float hp = rows.hp(r, o);
      acc += hp - rows.hm(r, o);
      on += hp;
    }
    acc = warp_sum(acc);
    on = warp_sum(on);
    if (s.lane != 0) continue;
    float g = acc * inv_b;
    if (a.flags & kSparsity) g = g + a.sparsity_cost * (a.sparsity_target - on * inv_b);
    apply(a, a.c + o, a.vc + o, g, m, a.lr, false);
  }
}

}  // namespace
