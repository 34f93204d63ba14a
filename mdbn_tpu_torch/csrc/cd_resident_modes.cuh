// The estimator modes of csrc/cd_train_resident.cu (its kModes variant):
// parallel tempering, the enhanced gradient, learned variance and the
// pseudo-likelihood monitor on the W-resident cluster design. What each
// mode computes is cd_train.cu's (see that file's header); how it lies on
// the clusters is in cd_train_resident.cu's header. Included by that file
// after its constants (kRThreads, kRWarps, kMaxRanks) and helpers.

#pragma once

namespace {

constexpr int kTermGroup = 8;  // rungs' log p* terms a lane sums at once

// The modes' arguments (Args::md); a mode that is off leaves its fields unused.
struct ModeArgs {
  const float* u_swap;  // inject, tempering: [E, nb, 2, (M-1)*B]
  const float* betas;   // tempering: [M], betas[0] = 1
  Store* z;             // learned variance: [V] log sigma^2
  Store* vz;
  float* lp_part;       // tempering: [S, CR, NT] each strip's sums of the log p*_beta(h) terms
  float* ch_part;       // tempering: [ranks, CR] each column tile's share of c.h per chain row
  float* pc;            // enhanced: [S, Hp] each strip's share of gW_e^T mu
  float* hx;            // tempering: [2, CR, Hp] a ladder's hidden probabilities and samples
  int M, CR, NT;        // rungs, chain rows (M*B on a ladder, else B), log p* terms a row
  float lr_z;
};

// Sum of p[s * stride] over s < n in order (n <= kMaxStrips), from device
// memory, the loads of kInFlight of them in flight before the first add.
__device__ __forceinline__ float ordered_sum(const float* p, size_t stride, int n) {
  float sum = 0.0f;
#pragma unroll
  for (int s0 = 0; s0 < kMaxStrips; s0 += kInFlight) {
    float v[kInFlight];
#pragma unroll
    for (int b = 0; b < kInFlight; ++b)
      if (s0 + b < n) v[b] = __ldcg(p + (s0 + b) * stride);
#pragma unroll
    for (int b = 0; b < kInFlight; ++b)
      if (s0 + b < n) sum += v[b];
  }
  return sum;
}

// Four consecutive partials p[s * stride + 0..3] summed over s < n in order
// (n <= kMaxStrips) from device memory, kInFlight loads in flight at once.
__device__ __forceinline__ float4 ordered_sum4(const float* p, size_t stride, int n) {
  float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int s0 = 0; s0 < kMaxStrips; s0 += kInFlight) {
    float4 v[kInFlight];
#pragma unroll
    for (int b = 0; b < kInFlight; ++b)
      if (s0 + b < n) v[b] = __ldcg(reinterpret_cast<const float4*>(p + (s0 + b) * stride));
#pragma unroll
    for (int b = 0; b < kInFlight; ++b) {
      if (s0 + b < n) {
        sum.x += v[b].x; sum.y += v[b].y; sum.z += v[b].z; sum.w += v[b].w;
      }
    }
  }
  return sum;
}

// Four consecutive visible partials summed over the cluster's ranks in rank
// order (rq[c] + off over distributed shared memory), every load in flight
// before the first add.
__device__ __forceinline__ float4 rank_sum4(const float* const (&rq)[kMaxRanks], int ranks,
                                            int off) {
  float4 v[kMaxRanks];
#pragma unroll
  for (int c = 0; c < kMaxRanks; ++c)
    if (c < ranks) v[c] = *reinterpret_cast<const float4*>(rq[c] + off);
  float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int c = 0; c < kMaxRanks; ++c) {
    if (c < ranks) {
      sum.x += v[c].x; sum.y += v[c].y; sum.z += v[c].z; sum.w += v[c].w;
    }
  }
  return sum;
}

// A tempering ladder's x W[strip, tile] for `rows` rows in one pass, each sum
// over the strip's rows in order (no chunks: the rows fill the warps),
// stored to dst[r * stride + j] (the hidden phase's device partials). rowp(r)
// gives row r of x (f32, zero past the strip's nq rows). Warp unit: 64
// columns (lane = j, j + 32) x kRT rows, as hidden_products.
template <bool kBf, class RowP>
__device__ __forceinline__ void hidden_rows(RowP rowp, const Store* w, int ldw, int nq, int rows,
                                            int nj, float* dst, size_t stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncg = cdiv(nj, 64), nrt = cdiv(rows, kRT), nq4 = cdiv(nq, 4) * 4;
  for (int u = warp; u < ncg * nrt; u += kRWarps) {
    const int cg = u % ncg, r0 = (u / ncg) * kRT, j0 = cg * 64 + lane;
    const bool two = cg * 64 + 32 < nj;  // the warp's second 32 columns exist
    const float* xr[kRT];
#pragma unroll
    for (int rr = 0; rr < kRT; ++rr) xr[rr] = rowp(min(r0 + rr, rows - 1));
    float acc[2][kRT];
#pragma unroll
    for (int rr = 0; rr < kRT; ++rr) acc[0][rr] = acc[1][rr] = 0.0f;
    for (int q = 0; q < nq4; q += 4) {
      float wv[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wv[0][i] = op<kBf>(ld(w + (q + i) * ldw + j0));
        wv[1][i] = two ? op<kBf>(ld(w + (q + i) * ldw + j0 + 32)) : 0.0f;
      }
#pragma unroll
      for (int rr = 0; rr < kRT; ++rr) {
        float xv[4];
        load4(xr[rr] + q, xv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xo = op<kBf>(xv[i]);
          acc[0][rr] = fmaf(xo, wv[0][i], acc[0][rr]);
          acc[1][rr] = fmaf(xo, wv[1][i], acc[1][rr]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRT; ++rr) {
      if (r0 + rr >= rows) continue;
      float* o = dst + static_cast<size_t>(r0 + rr) * stride;
      if (j0 < nj) __stcg(o + j0, acc[0][rr]);
      if (two && j0 + 32 < nj) __stcg(o + j0 + 32, acc[1][rr]);
    }
  }
}

// A tempering ladder's h W[strip, tile]^T for nsegs row sets of B rows in one
// pass, each sum over the tile's columns in order (no chunks), into
// out[(s * B + r) * tv + q] (the strip's visible partials). segp(s) gives
// set s (f32 [B][th], zero past the tile's nj columns). Warp unit: 64
// visible rows (lane = q, q + 32) x kRT rows of a set, as visible_products.
template <bool kBf, class SegP>
__device__ __forceinline__ void visible_rows(SegP segp, int nsegs, const Store* w, int ldw,
                                             int tv, int th, int nq, int B, int nj,
                                             float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nqg = cdiv(nq, 64), nrt = cdiv(B, kRT), nj4 = cdiv(nj, 4) * 4;
  for (int u = warp; u < nqg * nrt * nsegs; u += kRWarps) {
    const int qg = u % nqg, rest = u / nqg, rt = rest % nrt, seg = rest / nrt;
    const float* h = segp(seg);
    const int q0 = qg * 64 + lane, r0 = rt * kRT;
    const bool two = qg * 64 + 32 < nq;  // the warp's second 32 rows exist
    const float* hr[kRT];
#pragma unroll
    for (int rr = 0; rr < kRT; ++rr) hr[rr] = h + min(r0 + rr, B - 1) * th;
    float acc[2][kRT];
#pragma unroll
    for (int rr = 0; rr < kRT; ++rr) acc[0][rr] = acc[1][rr] = 0.0f;
    const Store* wr0 = w + min(q0, tv - 1) * ldw;  // rows past the tile read its last row
    const Store* wr1 = w + min(q0 + 32, tv - 1) * ldw;
    for (int jj = 0; jj < nj4; jj += 4) {
      float wv[2][4];
      load4(wr0 + jj, wv[0]);
      if (two) load4(wr1 + jj, wv[1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wv[0][i] = op<kBf>(wv[0][i]);
        wv[1][i] = two ? op<kBf>(wv[1][i]) : 0.0f;
      }
#pragma unroll
      for (int rr = 0; rr < kRT; ++rr) {
        float hv[4];
        load4(hr[rr] + jj, hv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ho = op<kBf>(hv[i]);
          acc[0][rr] = fmaf(ho, wv[0][i], acc[0][rr]);
          acc[1][rr] = fmaf(ho, wv[1][i], acc[1][rr]);
        }
      }
    }
    float* o = out + static_cast<size_t>(seg) * B * tv;
#pragma unroll
    for (int rr = 0; rr < kRT; ++rr) {
      if (r0 + rr >= B) continue;
      if (q0 < nq) o[(r0 + rr) * tv + q0] = acc[0][rr];
      if (two && q0 + 32 < nq) o[(r0 + rr) * tv + q0 + 32] = acc[1][rr];
    }
  }
}

// The pseudo monitor's share of one column tile for each of the B rows:
// sum_j softplus(pre + delta_r W[bit, j]) - softplus(pre), with pre = v0 W + c
// of the row (pre [B, th]: the data phase's pre-activations of the tile),
// wrow the tile's row `bit` of W and v0bit[r * tv] the row's bit, delta_r =
// 1 - 2 v0[r, bit]. A warp a row, lanes over the columns, a fixed butterfly;
// out[r] from lane 0.
__device__ __forceinline__ void pseudo_shares(const float* pre, const Store* wrow,
                                              const Store* v0bit, int tv, int th, int nj,
                                              int B, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < B; r += kRWarps) {
    const float delta = 1.0f - 2.0f * ld(v0bit + r * tv);
    float acc = 0.0f;
    for (int jj = lane; jj < nj; jj += 32) {
      const float p = pre[r * th + jj];
      acc += softplusf(p + delta * ld(wrow + jj)) - softplusf(p);
    }
    acc = warp_sum(acc);
    if (lane == 0) out[r] = acc;
  }
}

// Tempering: the terms of log p*_beta(h) of one chain row over a strip's nq
// rows of W, from the column tiles' partials of h W^T (rq[c] + off, c <
// ranks, summed in rank order) plus b: Bernoulli, sum_q softplus(beta_n pre)
// at every rung's beta_n (NT = M terms); Gaussian, sum_q (w b + w^2/2) s with
// w = pre - b and s = e^{-z} under learned variance, else 1 (NT = 1). One
// warp: lanes over groups of 4 q, kTermGroup terms at a time, a fixed
// butterfly; out[n] from lane 0.
__device__ __forceinline__ void ladder_terms(const float* const (&rq)[kMaxRanks], int ranks,
                                             int off, const Store* bs, const float* s, int nq,
                                             int NT, const float* betas, bool gaussian,
                                             float* out) {
  const int lane = threadIdx.x & 31, nq4 = cdiv(nq, 4) * 4;
  for (int n0 = 0; n0 < NT; n0 += kTermGroup) {
    float acc[kTermGroup];
#pragma unroll
    for (int n = 0; n < kTermGroup; ++n) acc[n] = 0.0f;
    for (int qq = 4 * lane; qq < nq4; qq += 128) {
      const float4 sum = rank_sum4(rq, ranks, off + qq);
      const float sv[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = qq + i;
        if (q >= nq) break;
        const float bq = ld(bs + q), pre = sv[i] + bq;
        if (gaussian) {
          const float w = pre - bq;
          acc[0] += (w * bq + 0.5f * w * w) * (s ? s[q] : 1.0f);
        } else {
#pragma unroll
          for (int n = 0; n < kTermGroup; ++n)
            if (n0 + n < NT) acc[n] += softplusf(__ldg(betas + n0 + n) * pre);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kTermGroup; ++n) {
      if (n0 + n >= NT) break;
      const float tot = warp_sum(acc[n]);
      if (lane == 0) __stcg(out + n0 + n, tot);
    }
  }
}

// The ladder's two Metropolis swap rounds (even pairs, then odd), run alike
// by every block from the same totals: lp [CR][NT] the log p*_beta terms and
// ch [CR] the c.h of every chain row, as cd_wide_modes_phases.cuh's
// modes_swap_phase forms log a from them. An accepted pair exchanges its two
// rows' totals; flags [2][CR] records it at the pair's lower row. Then the
// block's tile of the chain (hc [CR][th], nj columns) exchanges the rows
// round by round. Swap draws: inject u_swap [E, nb, 2, (M-1)*B], else Philox
// counter (0, m*B+r, kDrawSwap<<8 | round, update), as cd_train.cu keys them.
// All threads call it.
__device__ void ladder_swaps(const float* betas, const float* u_swap, int M, int NT, int B,
                              int flags, unsigned long long seed, float* lp, float* ch,
                              int* accepted, float* hc, int th, int nj, unsigned upd, size_t ei) {
  const int CR = M * B;
  const bool gaussian = flags & kGaussian;
  for (int p = 0; p < 2; ++p) {
    const int npairs = (M - p) / 2;
    for (int idx = threadIdx.x; idx < npairs * B; idx += kRThreads) {
      const int m = p + 2 * (idx / B), r = idx % B;
      const int r0 = m * B + r, r1 = r0 + B;
      const float b0 = __ldg(betas + m), b1 = __ldg(betas + m + 1);
      const float* v0 = lp + r0 * NT;
      const float* v1 = lp + r1 * NT;
      float log_a;
      if (gaussian) {
        const float l0 = ch[r0] + v0[0], l1 = ch[r1] + v1[0];
        log_a = b0 * l1 + b1 * l0 - b0 * l0 - b1 * l1;
      } else {
        log_a = (b0 * ch[r1] + v1[m]) + (b1 * ch[r0] + v0[m + 1]) - (b0 * ch[r0] + v0[m]) -
                (b1 * ch[r1] + v1[m + 1]);
      }
      const float u = (flags & kInject)
                          ? u_swap[(ei * 2 + p) * static_cast<size_t>(M - 1) * B +
                                      static_cast<size_t>(m) * B + r]
                          : draw_uniform(seed, upd, kDrawSwap, p, r0, 0);
      const bool accept = logf(fmaxf(u, 1e-38f)) < log_a;
      accepted[p * CR + r0] = accept;
      if (accept) {  // the pair's rows are this thread's alone in this round
        for (int n = 0; n < NT; ++n) {
          const float x = lp[r0 * NT + n];
          lp[r0 * NT + n] = lp[r1 * NT + n];
          lp[r1 * NT + n] = x;
        }
        const float x = ch[r0];
        ch[r0] = ch[r1];
        ch[r1] = x;
      }
    }
    __syncthreads();
  }
  for (int p = 0; p < 2; ++p) {
    const int npairs = (M - p) / 2;
    for (int idx = threadIdx.x; idx < npairs * B * nj; idx += kRThreads) {
      const int jj = idx % nj, pr = idx / nj;
      const int r0 = (p + 2 * (pr / B)) * B + pr % B;
      if (!accepted[p * CR + r0]) continue;
      float* x0 = hc + r0 * th + jj;
      float* x1 = x0 + B * th;
      const float x = *x0;
      *x0 = *x1;
      *x1 = x;
    }
    __syncthreads();
  }
}

}  // namespace
