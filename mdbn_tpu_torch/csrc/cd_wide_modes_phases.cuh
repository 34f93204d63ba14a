// The phases of csrc/cd_train_wide_modes.cu: the W-blocked design of
// cd_wide_phases.cuh carried over to the estimator modes (tempering, the
// enhanced gradient, learned variance). Each is a template on the kernel's
// argument struct A (see cd_train_wide_modes.cu for its fields and the
// design). Every sum runs in a fixed order, so the bits do not depend on
// the grid.
//
// - xw_rows_phase: part[s] = x[:, strip s] W[strip s, :] for the rows of
//   one phase (the B data rows or the M*B ladder rows), all of them in one
//   pass over each strip while they fit a row group of kXRowGroup.
// - hidden_rows_reduce: sigmoid(beta_r (sum of the strips' partials in
//   strip order + c)) and the sample, one thread per output.
// - hwt_phase: h W^T over units of kVQ rows of W, a register tile of kTR
//   rows x kTQ rows of W a thread, every row of the phase looping inside the
//   unit; the epilogue of each segment's role (the Gibbs visibles, the
//   monitor's reconstruction, tempering's log p*(h) strip partials, learned
//   variance's A terms).
// - modes_swap_phase: a Metropolis swap round of the tempering ladder from
//   the strip partials of log p*_beta(h).
// - modes_update_phase: the gradient and update of a strip of kUQ rows of W
//   across all H columns, with gb (gb_e), and z under learned variance, for
//   its own rows; enhanced_c_phase: the enhanced gradient's gc_e from the
//   strips' partials.

#pragma once

#include "cd_common.cuh"

// The kernel's dynamic shared memory (kSmemFloats floats). The phases name it
// themselves: a pointer handed to a function that is not inlined would turn
// every shared access into a generic one.
extern __shared__ __align__(16) float cd_wide_modes_smem[];

namespace {

constexpr int kXStripRows = 512;    // rows of W per strip of an x W product
constexpr int kXRowsPerWarp = 16;   // W rows a warp holds in registers at once
constexpr int kXSub = kWarps * kXRowsPerWarp;  // strip rows staged at once
constexpr int kXRowGroup = 64;      // rows of x summed per pass over a strip
constexpr int kXSmemFloats = kXRowGroup * kXSub + kWarps * kXRowGroup * 32;
constexpr int kXPre = 16;           // x values of the next sub-tile a thread holds in flight
// h W^T: thread (tr, tq) of a 16 x 16 grid owns rows tr*kTR.. of the pass
// and rows tq*kTQ.. of the unit's block of W
constexpr int kTR = 4, kTQ = 4;
constexpr int kVR = 16 * kTR;       // rows of h per pass
constexpr int kVQ = 16 * kTQ;       // rows of W per unit (one strip of tempering's partials)
constexpr int kVK = 64;             // hidden units staged at once
constexpr int kHS = kVR + 4;        // row stride of the staged h tile [kVK][kHS]
constexpr int kWS = kVQ + 4;        // row stride of the staged W tile [kVK][kWS]
constexpr int kHPre = kVR * kVK / kThreads;  // h values a thread stages per chunk
constexpr int kWPre = kVQ * kVK / kThreads;  // W values a thread stages per chunk
constexpr int kUQ = 16;             // rows of W per update unit
constexpr int kPre = 4;             // staged values a thread prefetches in registers
constexpr int kMaxBatch = 256;      // the largest batch whose strip the update stages
constexpr int kSmemFloats = kXSmemFloats;  // dynamic shared memory of a block (96 KB)
static_assert(kVK * (kHS + kWS) <= kSmemFloats, "h W^T tiles fit");
static_assert(kXRowsPerWarp % 4 == 0 && kTR == 4 && kTQ == 4, "vector widths below");
static_assert(kVR * kVK % kThreads == 0 && kVQ * kVK % kThreads == 0, "whole chunks");

// The phases are separate functions, not inlined into the kernel: each has
// the registers for itself instead of sharing them with what the kernel keeps
// live across the phases (inlined, the kernel spilled 1.6 KB a thread). Each
// takes the kernel's arguments by reference (the __grid_constant__
// parameter, not a copy). Read through the reference, a field is loaded
// again after each store to global memory and each __syncthreads (which
// might change it as far as the compiler knows); the h W^T, update and
// enhanced bias phases, which store between their reads, copy the
// arguments into a local first (on an H100 those phases ran 7-40% faster
// so; the reduce and swap phases ran slower with the copy, x W the same).
#define MODES_PHASE __device__ __noinline__

// The 32 bits a value is stored in (a bf16 in the low half), and the float
// they hold. A prefetch keeps the raw bits and converts them only when it
// stores them, so the warp does not wait for the load where it is issued.
__device__ __forceinline__ unsigned raw_bits(const float* p) { return __float_as_uint(*p); }
__device__ __forceinline__ unsigned raw_bits(const __nv_bfloat16* p) {
  return __bfloat16_as_ushort(*p);
}
template <typename T>
__device__ __forceinline__ float from_raw(unsigned r);
template <>
__device__ __forceinline__ float from_raw<float>(unsigned r) { return __uint_as_float(r); }
template <>
__device__ __forceinline__ float from_raw<__nv_bfloat16>(unsigned r) {
  return __uint_as_float(r << 16);
}

// Inverse temperature of chain row r (1 off a tempering ladder).
template <class A>
__device__ __forceinline__ float ladder_beta(const A& a, int r) {
  return (a.flags & kTempering) ? a.betas[r / a.B] : 1.0f;
}

// Element (row rg0 + rr, column q0 + cc) of x as xw_rows_phase stages it.
template <bool kBf, typename T>
__device__ __forceinline__ float x_value(const T* x, int V, int rr, int cc, int nq, int rg0,
                                         int q0, const float* scale, const Store* zscale) {
  if (cc >= nq) return 0.0f;
  float v = ld(x + static_cast<size_t>(rg0 + rr) * V + q0 + cc);
  if (scale) v *= scale[q0 + cc];
  if (zscale) v *= expf(-ld(zscale + q0 + cc));
  return op<kBf>(v);
}

// part[s] = x[:, strip s] W[strip s, :] for every strip s of kXStripRows rows
// of W; x [rows, V] is the data (Store) or vs (f32), times scale[column] when
// scale is given, times e^{-zscale[column]} when zscale is given, rounded to
// the compute dtype. Unit (one block): one strip x 32 hidden columns (lane =
// column). Each warp holds kXRowsPerWarp elements of its column in registers
// and adds their products with every row of the group into per-row sums in
// shared memory, so a W element is read once per group of kXRowGroup rows;
// the warps' sums are then added in warp order. The next sub-tile's W and
// (up to kXPre a thread) x are loaded into registers while this one's
// products run.
template <bool kBf, class A, typename T>
MODES_PHASE void xw_rows_phase(const A& a, const T* x, int rows, const float* scale,
                               const Store* zscale) {
  float* const smem = cd_wide_modes_smem;
  float* xs = smem;                        // [kXRowGroup][kXSub]
  float* accs = smem + kXRowGroup * kXSub;  // [kWarps][kXRowGroup][32]
  const int V = a.V, H = a.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncol = (H + 31) / 32, nprod = a.NS * ncol;
  float* mine = accs + warp * kXRowGroup * 32 + lane;
  for (int unit = blockIdx.x; unit < nprod; unit += gridDim.x) {
    const int s = unit / ncol, j0 = (unit % ncol) * 32, j = j0 + lane;
    const int q_lo = s * kXStripRows, q_hi = min(V, q_lo + kXStripRows);
    for (int rg0 = 0; rg0 < rows; rg0 += kXRowGroup) {
      const int nr = min(kXRowGroup, rows - rg0);
      for (int rr = 0; rr < nr; ++rr) mine[rr * 32] = 0.0f;  // this thread's own slots
      // the next sub-tile in flight, as raw bits: W, and x at this thread's
      // column of the staged rows (kThreads is a multiple of kXSub) with its
      // column's scale
      const int cc = threadIdx.x % kXSub;
      unsigned wraw[kXRowsPerWarp], xraw[kXPre], sraw = 0;
      float w[kXRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kXRowsPerWarp; ++i) {
        const int q = q_lo + warp * kXRowsPerWarp + i;
        wraw[i] = (q < q_hi && j < H) ? raw_bits(a.W + static_cast<size_t>(q) * H + j) : 0u;
      }
      int nq = min(kXSub, q_hi - q_lo);
#pragma unroll
      for (int i = 0; i < kXPre; ++i) {
        const int rr = (threadIdx.x + i * kThreads) / kXSub;
        xraw[i] = (rr < nr && cc < nq)
                      ? raw_bits(x + static_cast<size_t>(rg0 + rr) * V + q_lo + cc) : 0u;
      }
      if (cc < nq && scale) sraw = raw_bits(scale + q_lo + cc);
      if (cc < nq && zscale) sraw = raw_bits(zscale + q_lo + cc);
      for (int q0 = q_lo; q0 < q_hi; q0 += kXSub) {
        __syncthreads();  // the previous tile of x is no longer read
        const float sc = scale ? from_raw<float>(sraw)
                               : zscale ? expf(-from_raw<Store>(sraw)) : 1.0f;
#pragma unroll
        for (int i = 0; i < kXPre; ++i) {
          const int idx = threadIdx.x + i * kThreads;
          if (idx < nr * kXSub) xs[idx] = op<kBf>(from_raw<T>(xraw[i]) * sc);
        }
        for (int idx = threadIdx.x + kXPre * kThreads; idx < nr * kXSub; idx += kThreads) {
          const int rr = idx / kXSub;
          xs[idx] = x_value<kBf>(x, V, rr, idx - rr * kXSub, nq, rg0, q0, scale, zscale);
        }
#pragma unroll
        for (int i = 0; i < kXRowsPerWarp; ++i) w[i] = op<kBf>(from_raw<Store>(wraw[i]));
        __syncthreads();
        const int q1 = q0 + kXSub;
        if (q1 < q_hi) {  // the next sub-tile, in flight during this one's products
          nq = min(kXSub, q_hi - q1);
#pragma unroll
          for (int i = 0; i < kXRowsPerWarp; ++i) {
            const int q = q1 + warp * kXRowsPerWarp + i;
            wraw[i] = (q < q_hi && j < H) ? raw_bits(a.W + static_cast<size_t>(q) * H + j) : 0u;
          }
#pragma unroll
          for (int i = 0; i < kXPre; ++i) {
            const int rr = (threadIdx.x + i * kThreads) / kXSub;
            xraw[i] = (rr < nr && cc < nq)
                          ? raw_bits(x + static_cast<size_t>(rg0 + rr) * V + q1 + cc) : 0u;
          }
          if (cc < nq && scale) sraw = raw_bits(scale + q1 + cc);
          if (cc < nq && zscale) sraw = raw_bits(zscale + q1 + cc);
        }
        // two rows at a time: two independent chains of FMAs (each row's sum
        // is in the same order as one row at a time)
        const float* xw = xs + warp * kXRowsPerWarp;
        for (int rr = 0; rr < nr; rr += 2) {
          const bool two = rr + 1 < nr;
          const float4* xa = reinterpret_cast<const float4*>(xw + rr * kXSub);
          const float4* xb = reinterpret_cast<const float4*>(xw + (two ? rr + 1 : rr) * kXSub);
          float pa = 0.0f, pb = 0.0f;
#pragma unroll
          for (int i = 0; i < kXRowsPerWarp / 4; ++i) {
            const float4 va = xa[i], vb = xb[i];
            pa = fmaf(va.x, w[4 * i], pa);
            pb = fmaf(vb.x, w[4 * i], pb);
            pa = fmaf(va.y, w[4 * i + 1], pa);
            pb = fmaf(vb.y, w[4 * i + 1], pb);
            pa = fmaf(va.z, w[4 * i + 2], pa);
            pb = fmaf(vb.z, w[4 * i + 2], pb);
            pa = fmaf(va.w, w[4 * i + 3], pa);
            pb = fmaf(vb.w, w[4 * i + 3], pb);
          }
          mine[rr * 32] += pa;
          if (two) mine[(rr + 1) * 32] += pb;
        }
      }
      __syncthreads();  // every warp's sums are complete
      for (int idx = threadIdx.x; idx < nr * 32; idx += kThreads) {
        const int rr = idx >> 5, l = idx & 31;
        if (j0 + l < H) {
          float sum = 0.0f;
#pragma unroll
          for (int wv = 0; wv < kWarps; ++wv) sum += accs[(wv * kXRowGroup + rr) * 32 + l];
          a.part[(static_cast<size_t>(s) * rows + rg0 + rr) * H + j0 + l] = sum;
        }
      }
      __syncthreads();  // the sums are read before the next group clears them
    }
  }
}

// hprob = sigmoid(beta_r (sum over strips of part, in strip order, + c)) and
// hsample = (u < hprob), for all rows x H outputs; one thread per output.
template <class A>
MODES_PHASE void hidden_rows_reduce(const A& a, int rows, float* hprob, Store* hsample,
                                   const float* u, unsigned upd, int kind, int t) {
  const size_t n = static_cast<size_t>(rows) * a.H;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; idx < n;
       idx += static_cast<size_t>(gridDim.x) * kThreads) {
    const float* p = a.part + idx;
    float sum = 0.0f;
#pragma unroll 8
    for (int s = 0; s < a.NS; ++s) sum += p[static_cast<size_t>(s) * n];
    const int r = static_cast<int>(idx / a.H);
    const int j = static_cast<int>(idx - static_cast<size_t>(r) * a.H);
    const float pr = sigmoidf(ladder_beta(a, r) * (sum + ld(a.c + j)));
    hprob[idx] = pr;
    const float uu = u ? u[idx] : draw_uniform(a.seed, upd, kind, t, r, j);
    st(hsample + idx, uu < pr ? 1.0f : 0.0f);
  }
}

// What the rows of an h W^T segment are for.
enum MRole {
  kMGibbs,    // Gibbs step t's visible mean and sample -> vs (CD, t = 0: the monitor too)
  kMMonitor,  // the data chain's reconstruction -> the monitor (rows of h0s)
  kMLp,       // tempering: the terms of log p*_beta(h) summed over the unit's rows of W
  kMWhData,   // learned variance: A = (v0 - b)^2/2 - v0 (W h0p) -> wh_a rows [0, B)
  kMWhModel,  // learned variance: A = (vs - b)^2/2 - vs (W hmean) -> wh_a rows [B, 2B)
};

// Rows from samples (Store) or from probabilities (f32 scratch); the other
// pointer is null. A segment of no rows takes no work.
struct MSeg {
  const Store* samples;
  const float* probs;
  int rows;
  int role;
};

__device__ __forceinline__ MSeg no_mseg() { return MSeg{nullptr, nullptr, 0, kMGibbs}; }

// The monitor's term of one element: the squared error of the data x
// against its reconstruction y, or the cross-entropy terms x log y + (1 - x)
// log(1 - y) (cd_common.cuh's monitor_row).
__device__ __forceinline__ float monitor_term(float x, float y, bool xent) {
  if (xent) {
    const float pc = fminf(fmaxf(y, 1e-7f), 1.0f - 1e-7f);
    return x * logf(pc) + (1.0f - x) * logf(1.0f - pc);
  }
  const float d = x - y;
  return d * d;
}

// h W^T for up to three row segments, each with its role's epilogue. Unit
// (one block): kVQ rows of W. For each pass of kVR rows of a segment, the
// rows' h and the unit's W are staged kVK hidden units at a time (transposed,
// rounded to the compute dtype; the next chunk's loads are issued into
// registers before the products of this one) and thread (tr, tq) adds the
// products of its kTR rows and kTQ rows of W over all H in order: no sum
// crosses threads, so a W row is read from device memory once per pass and
// the rows loop inside the unit. A pass of fewer rows leaves the warps past
// them idle. The reconstruction monitor's terms of the unit's rows of W are
// summed per batch row into a.mon_part [V/64, B] (the update phase adds them
// up), as tempering's terms are into a.lp_part.
template <bool kBf, class A>
MODES_PHASE void hwt_phase(const A& args, MSeg s0, MSeg s1, MSeg s2, const Store* v0,
                           unsigned upd, size_t ei, int t) {
  const A a = args;  // a local copy: see MODES_PHASE
  float* const smem = cd_wide_modes_smem;
  float* hsT = smem;              // [kVK][kHS]
  float* wsT = smem + kVK * kHS;  // [kVK][kWS]
  const int V = a.V, H = a.H, B = a.B;
  const int tid = threadIdx.x, tq = tid & 15, tr = tid >> 4;
  const bool gaussian = a.flags & kGaussian;
  const bool sample_v = a.flags & kSampleVisible;
  const bool persistent = a.flags & kPersistent;
  const bool tempering = a.flags & kTempering;
  const bool lv = a.flags & kLearnVar;
  const bool xent = a.flags & kXent;
  const float* uv = nullptr;
  if ((a.flags & kInject) && sample_v)
    uv = a.u_v + (ei * a.k + t) * static_cast<size_t>(a.CR) * V;
  const int nunit = (V + kVQ - 1) / kVQ;
  for (int unit = blockIdx.x; unit < nunit; unit += gridDim.x) {
    const int q0 = unit * kVQ;
    // this thread's rows of W: b, and learned variance's s and sigma
    float bq[kTQ], sq[kTQ], sgq[kTQ];
#pragma unroll
    for (int jq = 0; jq < kTQ; ++jq) {
      const int q = q0 + tq * kTQ + jq;
      bq[jq] = q < V ? ld(a.b + q) : 0.0f;
      sq[jq] = (lv && q < V) ? a.s_lv[q] : 1.0f;
      sgq[jq] = (lv && q < V) ? a.sig_lv[q] : 1.0f;
    }
    for (int sg = 0; sg < 3; ++sg) {
      const MSeg seg = sg == 0 ? s0 : sg == 1 ? s1 : s2;
      for (int r0 = 0; r0 < seg.rows; r0 += kVR) {
        const int nr = min(kVR, seg.rows - r0);
        const bool active = tr * kTR < nr;
        float acc[kTR][kTQ];
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int jq = 0; jq < kTQ; ++jq) acc[i][jq] = 0.0f;
        unsigned hraw[kHPre], wraw[kWPre];  // the next chunk in flight, as raw bits
#pragma unroll
        for (int i = 0; i < kHPre; ++i) {
          const int idx = tid + i * kThreads, r = idx / kVK, kk = idx - r * kVK;
          const size_t g = static_cast<size_t>(r0 + r) * H + kk;
          hraw[i] = (r < nr && kk < H)
                        ? (seg.samples ? raw_bits(seg.samples + g) : raw_bits(seg.probs + g)) : 0u;
        }
#pragma unroll
        for (int i = 0; i < kWPre; ++i) {
          const int idx = tid + i * kThreads, q = idx / kVK, kk = idx - q * kVK;
          wraw[i] = (q0 + q < V && kk < H) ? raw_bits(a.W + static_cast<size_t>(q0 + q) * H + kk)
                                           : 0u;
        }
        for (int j0 = 0; j0 < H; j0 += kVK) {
          __syncthreads();  // the previous tiles are no longer read
#pragma unroll
          for (int i = 0; i < kHPre; ++i) {
            const int idx = tid + i * kThreads, r = idx / kVK, kk = idx - r * kVK;
            hsT[kk * kHS + r] =
                op<kBf>(seg.samples ? from_raw<Store>(hraw[i]) : from_raw<float>(hraw[i]));
          }
#pragma unroll
          for (int i = 0; i < kWPre; ++i) {
            const int idx = tid + i * kThreads, q = idx / kVK, kk = idx - q * kVK;
            wsT[kk * kWS + q] = op<kBf>(from_raw<Store>(wraw[i]));
          }
          __syncthreads();
          const int j1 = j0 + kVK;
          if (j1 < H) {
#pragma unroll
            for (int i = 0; i < kHPre; ++i) {
              const int idx = tid + i * kThreads, r = idx / kVK, kk = idx - r * kVK;
              const size_t g = static_cast<size_t>(r0 + r) * H + j1 + kk;
              hraw[i] = (r < nr && j1 + kk < H)
                            ? (seg.samples ? raw_bits(seg.samples + g) : raw_bits(seg.probs + g))
                            : 0u;
            }
#pragma unroll
            for (int i = 0; i < kWPre; ++i) {
              const int idx = tid + i * kThreads, q = idx / kVK, kk = idx - q * kVK;
              wraw[i] = (q0 + q < V && j1 + kk < H)
                            ? raw_bits(a.W + static_cast<size_t>(q0 + q) * H + j1 + kk) : 0u;
            }
          }
          if (active) {
#pragma unroll 8
            for (int kk = 0; kk < kVK; ++kk) {
              const float4 hv = *reinterpret_cast<const float4*>(hsT + kk * kHS + tr * kTR);
              const float4 wv = *reinterpret_cast<const float4*>(wsT + kk * kWS + tq * kTQ);
              const float h4[4] = {hv.x, hv.y, hv.z, hv.w}, w4[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
              for (int i = 0; i < kTR; ++i)
#pragma unroll
                for (int jq = 0; jq < kTQ; ++jq) acc[i][jq] = fmaf(h4[i], w4[jq], acc[i][jq]);
            }
          }
        }
        // the monitor's rows: the reconstruction of the data chain (PCD), or
        // Gibbs step 0's visible mean (CD)
        const bool mon = seg.role == kMMonitor || (seg.role == kMGibbs && t == 0 && !persistent);
        // every value the epilogue reads from device memory, loaded before its
        // first store: a store might alias them as far as the compiler knows,
        // so interleaved they would wait for memory one output after another
        const bool with_v0 = mon || seg.role == kMWhData, with_vs = seg.role == kMWhModel;
        const bool with_u = seg.role == kMGibbs && uv;
        float xin[kTR][kTQ], uin[kTR][kTQ], beta[kTR];
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          const int rl = tr * kTR + i, r = r0 + rl;
          beta[i] = (tempering && rl < nr) ? a.betas[r / B] : 1.0f;
#pragma unroll
          for (int jq = 0; jq < kTQ; ++jq) {
            const int q = q0 + tq * kTQ + jq;
            const bool in = rl < nr && q < V;
            const size_t idx = static_cast<size_t>(r) * V + q;
            xin[i][jq] = (in && with_v0) ? ld(v0 + idx) : (in && with_vs) ? a.vs[idx] : 0.0f;
            uin[i][jq] = (in && with_u) ? uv[idx] : 0.0f;
          }
        }
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          const int rl = tr * kTR + i, r = r0 + rl;
          const bool rv = rl < nr;
          if (seg.role == kMLp) {
            // the terms of row r over this thread's rows of W, then over the
            // 16 threads (tq) of the half warp by a fixed butterfly; every
            // lane takes part in the shuffles
            for (int n = 0; n < a.NT; ++n) {
              float tot = 0.0f;
#pragma unroll
              for (int jq = 0; jq < kTQ; ++jq) {
                const int q = q0 + tq * kTQ + jq;
                if (rv && q < V) {
                  const float pre = acc[i][jq] + bq[jq];
                  if (gaussian) {
                    const float w = pre - bq[jq];
                    tot += (w * bq[jq] + 0.5f * w * w) * sq[jq];
                  } else {
                    tot += softplusf(a.betas[n] * pre);
                  }
                }
              }
#pragma unroll
              for (int off = 8; off > 0; off >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, off);
              if (tq == 0 && rv)
                a.lp_part[(static_cast<size_t>(unit) * a.CR + r) * a.NT + n] = tot;
            }
            continue;
          }
          float mterm = 0.0f;  // the monitor's terms of row r over this thread's rows of W
#pragma unroll
          for (int jq = 0; jq < kTQ; ++jq) {
            const int q = q0 + tq * kTQ + jq;
            if (!rv || q >= V) continue;
            const size_t idx = static_cast<size_t>(r) * V + q;
            const float mine = acc[i][jq], x = xin[i][jq];
            switch (seg.role) {
              case kMGibbs: {
                const float pre = mine + bq[jq];
                const float mean = gaussian ? pre : sigmoidf(beta[i] * pre);
                if (mon) mterm += monitor_term(x, mean, xent);
                float sample = mean;
                if (sample_v) {
                  if (gaussian) {
                    float nz = uv ? uin[i][jq] : draw_normal(a.seed, upd, kDrawV, t, r, q);
                    if (tempering) nz = nz / sqrtf(beta[i]);  // variance sigma^2 / beta
                    if (lv) nz = nz * sgq[jq];
                    sample = mean + nz;
                  } else {
                    const float u2 = uv ? uin[i][jq] : draw_uniform(a.seed, upd, kDrawV, t, r, q);
                    sample = u2 < mean ? 1.0f : 0.0f;
                  }
                }
                a.vs[idx] = sample;
                break;
              }
              case kMMonitor: {
                const float pre = mine + bq[jq];
                mterm += monitor_term(x, gaussian ? pre : sigmoidf(pre), xent);
                break;
              }
              case kMWhData: {  // x: the data
                const float d = x - bq[jq];
                a.wh_a[idx] = 0.5f * (d * d) - x * mine;
                break;
              }
              default: {  // kMWhModel, x: vs
                const float d = x - bq[jq];
                a.wh_a[static_cast<size_t>(B) * V + idx] = 0.5f * (d * d) - x * mine;
                break;
              }
            }
          }
          if (mon) {  // over the 16 threads (tq) of the half warp, as for kMLp
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
              mterm += __shfl_xor_sync(0xffffffffu, mterm, off);
            if (tq == 0 && rv) a.mon_part[static_cast<size_t>(unit) * B + r] = mterm;
          }
        }
      }
    }
  }
}

// The sum over the strips of tempering's partials for chain row `row`, term
// n, in a fixed order (thread-strided, then block_sum); every thread ends
// with it. red: kWarps floats.
template <class A>
__device__ __forceinline__ float lp_total(const A& a, float* red, size_t row, int n) {
  const int nqb = (a.V + kVQ - 1) / kVQ;
  float x[1] = {0.0f};
  for (int s = threadIdx.x; s < nqb; s += kThreads)
    x[0] += a.lp_part[(static_cast<size_t>(s) * a.CR + row) * a.NT + n];
  block_sum<1>(x, red);
  return x[0];
}

// Swap round p of the tempering ladder, as csrc/cd_phases.cuh's swap_phase
// computes it, from the reduced terms of log p*_beta(h) instead of pre_lp:
// lp[row][n] holds sum_q softplus(beta_n pre) (Bernoulli, one per rung) or
// sum_q (wh b + wh^2/2) s (Gaussian, NT = 1) of chain row `row`. Round 0
// reduces the strip partials of the rows it pairs (and of the last rung,
// which it leaves unpaired when M is odd) and writes lp, swapped with the
// rows; round 1 reads lp. One block per (pair, row): the rows it reads and
// writes are its own.
template <bool kBf, class A>
MODES_PHASE void modes_swap_phase(const A& a, unsigned upd, size_t ei, int p) {
  float* const smem = cd_wide_modes_smem;
  const int B = a.B, H = a.H, M = a.M, NT = a.NT;
  const bool gaussian = a.flags & kGaussian;
  float* red = smem;                // [kWarps * 2]
  float* vals = smem + kWarps * 2;  // [2][NT]
  const int npairs = (M - p) / 2;
  const int extra = (p == 0 && M % 2 == 1) ? B : 0;
  for (int unit = blockIdx.x; unit < npairs * B + extra; unit += gridDim.x) {
    __syncthreads();  // vals of the previous unit are no longer read
    if (unit >= npairs * B) {  // round 0: the last rung's rows, for round 1
      const size_t row = static_cast<size_t>(M - 1) * B + (unit - npairs * B);
      for (int n = 0; n < NT; ++n) {
        const float tot = lp_total(a, red, row, n);
        if (threadIdx.x == 0) a.lp[row * NT + n] = tot;
      }
      continue;
    }
    const int m = p + 2 * (unit / B), r = unit % B;
    const size_t r0 = static_cast<size_t>(m) * B + r, r1 = r0 + B;
    const float b0 = a.betas[m], b1 = a.betas[m + 1];
    Store* h0 = a.chain + r0 * H;
    Store* h1 = a.chain + r1 * H;
    if (p == 0) {
      for (int side = 0; side < 2; ++side)
        for (int n = 0; n < NT; ++n) {
          const float tot = lp_total(a, red, side ? r1 : r0, n);
          if (threadIdx.x == 0) vals[side * NT + n] = tot;
        }
    } else if (threadIdx.x < 2 * NT) {
      vals[threadIdx.x] = a.lp[(threadIdx.x < NT ? r0 : r1) * NT + threadIdx.x % NT];
    }
    float acc[2] = {0.0f, 0.0f};  // c.h_m, c.h_m+1
    for (int j = threadIdx.x; j < H; j += kThreads) {
      const float cj = op<kBf>(ld(a.c + j));
      acc[0] = fmaf(ld(h0 + j), cj, acc[0]);
      acc[1] = fmaf(ld(h1 + j), cj, acc[1]);
    }
    block_sum<2>(acc, red);  // every thread holds the same sums; vals are written
    float log_a;
    if (gaussian) {
      const float l0 = acc[0] + vals[0], l1 = acc[1] + vals[NT];
      log_a = b0 * l1 + b1 * l0 - b0 * l0 - b1 * l1;
    } else {
      // vals[0][n]: h_m at beta_n, vals[1][n]: h_m+1 at beta_n
      log_a = (b0 * acc[1] + vals[NT + m]) + (b1 * acc[0] + vals[m + 1]) -
              (b0 * acc[0] + vals[m]) - (b1 * acc[1] + vals[NT + m + 1]);
    }
    const float u = (a.flags & kInject)
                        ? a.u_swap[(ei * 2 + p) * static_cast<size_t>(M - 1) * B +
                                   static_cast<size_t>(m) * B + r]
                        : draw_uniform(a.seed, upd, kDrawSwap, p, static_cast<int>(r0), 0);
    const bool accept = logf(fmaxf(u, 1e-38f)) < log_a;  // the same in every thread
    if (accept) {
      for (int j = threadIdx.x; j < H; j += kThreads) {
        const Store tmp = h0[j];
        h0[j] = h1[j];
        h1[j] = tmp;
      }
    }
    if (p == 0 && threadIdx.x < 2 * NT) {  // the terms go with their rows
      const int side = threadIdx.x / NT, n = threadIdx.x % NT;
      a.lp[((side == 0) != accept ? r0 : r1) * NT + n] = vals[threadIdx.x];
    }
  }
}

// The enhanced gradient's hidden-bias update, gc_e = gc - gW_e^T mu (+ the
// sparsity term), from the update units' strip partials added in strip
// order; one warp per hidden unit. It reads what modes_update_phase wrote
// (after a grid barrier) and writes only c and its velocity.
template <class A>
MODES_PHASE void enhanced_c_phase(const A& args, Split s, float m) {
  const A a = args;  // a local copy: see MODES_PHASE
  const int H = a.H, nstrip = (a.V + kUQ - 1) / kUQ;
  for (int o = s.gwarp; o < H; o += s.nwarps) {
    float acc = 0.0f;
#pragma unroll 8
    for (int u = s.lane; u < nstrip; u += 32) acc += a.part_c[static_cast<size_t>(u) * H + o];
    acc = warp_sum(acc);
    if (s.lane != 0) continue;
    float g = a.g_c[o] - acc;
    if (a.flags & kSparsity) g = g + a.sparsity_cost * (a.sparsity_target - a.h0_mean[o]);
    apply(a, a.c + o, a.vc + o, g, m, a.lr, false);
  }
}

// One unit's staged rows, value idx of [B][sw]: the strip's columns of v0
// and of vs (times learned variance's snapshot s), and under learned
// variance (sw = 3 kUQ) of A_data - A_model; 0 past the last row of W.
// strip_raw loads the raw bits of the one or two values it takes,
// strip_value forms it.
template <class A>
__device__ __forceinline__ void strip_raw(const A& a, const Store* v0, int q0, int sw, int idx,
                                          unsigned& x, unsigned& y) {
  const int r = idx / sw, c = idx - r * sw, blk = c / kUQ;
  const int q = q0 + c - blk * kUQ;
  x = y = 0u;
  if (q >= a.V) return;
  const size_t g = static_cast<size_t>(r) * a.V + q;
  if (blk == 2) {
    x = raw_bits(a.wh_a + g);
    y = raw_bits(a.wh_a + static_cast<size_t>(a.B) * a.V + g);
    return;
  }
  x = blk == 0 ? raw_bits(v0 + g) : raw_bits(a.vs + g);
  if (a.flags & kLearnVar) y = raw_bits(a.s_lv + q);
}

template <class A>
__device__ __forceinline__ float strip_value(const A& a, int sw, int idx, unsigned x,
                                             unsigned y) {
  const int c = idx % sw, blk = c / kUQ;
  if (blk == 2) return from_raw<float>(x) - from_raw<float>(y);
  const float v = blk == 0 ? from_raw<Store>(x) : from_raw<float>(x);
  return (a.flags & kLearnVar) ? v * from_raw<float>(y) : v;
}

// The gradient and update of W, b (and z), plus the monitor's row sums. Unit
// (one block): a strip of kUQ rows of W across all H columns, thread =
// column (columns tid, tid + kThreads, ...). The unit's v0 and vs columns
// (and learned variance's A terms) are staged in shared memory from
// registers that were loaded while the previous unit ran; h0p and hmean
// (rows [0, B)) are staged once per phase when they fit (else read from
// device memory). For each column a thread first issues the loads of W (and
// of vW under momentum), then sums the products over the rows in row order,
// so the loads are in flight while it computes; b (and z) of the unit's rows
// are loaded at the unit's start the same way. Enhanced: the thread
// recombines gW_e in place, adds gW_e lam into per-warp sums (gb_e, local to
// the unit) and writes the strip's gW_e^T mu partial for its column (gc_e:
// enhanced_c_phase, after a barrier). b and, under learned variance, z of
// the unit's rows are updated by the unit; c (plain gradient) by one warp
// per hidden unit after the units. The monitor's B row sums (from the h W^T
// phase's partials) run on the last blocks.
template <bool kBf, class A>
MODES_PHASE void modes_update_phase(const A& args, Split s, const Store* v0, float m) {
  const A a = args;  // a local copy: see MODES_PHASE
  float* const smem = cd_wide_modes_smem;
  const int V = a.V, H = a.H, B = a.B;
  const float inv_b = 1.0f / static_cast<float>(B);
  const bool lv = a.flags & kLearnVar, enh = a.flags & kEnhanced;
  const bool need_vel = m != 0.0f;  // m * vel is 0 otherwise (vel is finite)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nstrip = (V + kUQ - 1) / kUQ, ncs = (H + kThreads - 1) / kThreads;
  const size_t bh = static_cast<size_t>(B) * H;
  const int sw = lv ? 3 * kUQ : 2 * kUQ, nstage = B * sw;
  float* hst = smem;                                             // [2][B][H] when a.hstaged
  float* sbuf = smem + (a.hstaged ? (2 * bh + 3) / 4 * 4 : 0);  // [B][sw], 16-byte aligned
  float* stat = sbuf + nstage;                                   // [3 kUQ] column sums
  float* nred = stat + 3 * kUQ;                                  // [kWarps][kUQ] gW_e lam
  float* red = nred + kWarps * kUQ;                              // [kWarps] block_sum
  if (a.hstaged) {  // 8 loads of each a thread in flight at once
    constexpr int kBatch = 8;
    for (size_t base = tid; base < bh; base += kBatch * kThreads) {
      float x0[kBatch], x1[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const size_t idx = base + static_cast<size_t>(u) * kThreads;
        x0[u] = idx < bh ? a.h0p[idx] : 0.0f;
        x1[u] = idx < bh ? a.hmean[idx] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const size_t idx = base + static_cast<size_t>(u) * kThreads;
        if (idx < bh) {
          hst[idx] = x0[u];
          hst[bh + idx] = x1[u];
        }
      }
    }
  }
  const float* hp = a.hstaged ? hst : a.h0p;
  const float* hm = a.hstaged ? hst + bh : a.hmean;
  unsigned prex[kPre], prey[kPre];  // the next unit's staged values in flight, as raw bits
#pragma unroll
  for (int i = 0; i < kPre; ++i) {
    const int idx = tid + i * kThreads;
    prex[i] = prey[i] = 0u;
    if (static_cast<int>(blockIdx.x) < nstrip && idx < nstage)
      strip_raw(a, v0, blockIdx.x * kUQ, sw, idx, prex[i], prey[i]);
  }
  for (int unit = blockIdx.x; unit < nstrip; unit += gridDim.x) {
    const int q0 = unit * kUQ, nq = min(kUQ, V - q0);
    __syncthreads();  // the previous unit no longer reads sbuf, stat, nred
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < nstage) sbuf[idx] = strip_value(a, sw, idx, prex[i], prey[i]);
    }
    for (int idx = tid + kPre * kThreads; idx < nstage; idx += kThreads) {
      unsigned x, y;
      strip_raw(a, v0, q0, sw, idx, x, y);
      sbuf[idx] = strip_value(a, sw, idx, x, y);
    }
    if (tid < kWarps * kUQ) nred[tid] = 0.0f;
    const int next = unit + static_cast<int>(gridDim.x);
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int idx = tid + i * kThreads;
      if (next < nstrip && idx < nstage) strip_raw(a, v0, next * kUQ, sw, idx, prex[i], prey[i]);
    }
    // b (and z) of the unit's rows, loaded now and updated at the unit's end
    const bool own = tid < nq;
    const float ob = own ? ld(a.b + q0 + tid) : 0.0f;
    const float ovb = own ? ld(a.vb + q0 + tid) : 0.0f;
    const float oz = (own && lv) ? ld(a.z + q0 + tid) : 0.0f;
    const float ovz = (own && lv) ? ld(a.vz + q0 + tid) : 0.0f;
    __syncthreads();
    if (tid < (lv ? 3 : 2) * kUQ) {  // in row order, as cd_train.cu's units sum them
      const int qi = tid % kUQ, blk = tid / kUQ;
      float acc = 0.0f;
      for (int r = 0; r < B; ++r) {
        const float* row = sbuf + r * sw;
        acc += blk == 2 ? row[2 * kUQ + qi]
                        : (blk == 0 ? row[qi] - row[kUQ + qi] : row[qi] + row[kUQ + qi]);
      }
      stat[tid] = acc;  // [0, kUQ): v0 - vs, [kUQ, 2 kUQ): v0 + vs, then A_data - A_model
    }
    if (kBf) {  // the products' operands, rounded once here instead of at every FMA
      __syncthreads();  // the sums above read the unrounded values
      for (int idx = tid; idx < nstage; idx += kThreads) sbuf[idx] = op<kBf>(sbuf[idx]);
    }
    __syncthreads();
    for (int cs = 0; cs < ncs; ++cs) {
      const int j = cs * kThreads + tid;
      const bool col = j < H;
      const size_t w0 = static_cast<size_t>(q0) * H + j;
      float old[kUQ], old_vel[kUQ], pos[kUQ], neg[kUQ];
#pragma unroll
      for (int i = 0; i < kUQ; ++i) {
        const bool in = col && i < nq;
        old[i] = in ? ld(a.W + w0 + static_cast<size_t>(i) * H) : 0.0f;
        old_vel[i] = (in && need_vel) ? ld(a.vW + w0 + static_cast<size_t>(i) * H) : 0.0f;
        pos[i] = neg[i] = 0.0f;
      }
      float hdif = 0.0f, hsum = 0.0f, hpos = 0.0f;  // enhanced: column j over the rows
      if (col) {
#pragma unroll 2
        for (int r = 0; r < B; ++r) {
          const float hp_raw = hp[static_cast<size_t>(r) * H + j];
          const float hm_raw = hm[static_cast<size_t>(r) * H + j];
          const float hpo = op<kBf>(hp_raw), hmo = op<kBf>(hm_raw);
          const float4* sv = reinterpret_cast<const float4*>(sbuf + r * sw);
#pragma unroll
          for (int i4 = 0; i4 < kUQ / 4; ++i4) {
            const float4 x = sv[i4], y = sv[kUQ / 4 + i4];
            pos[4 * i4] = fmaf(x.x, hpo, pos[4 * i4]);
            pos[4 * i4 + 1] = fmaf(x.y, hpo, pos[4 * i4 + 1]);
            pos[4 * i4 + 2] = fmaf(x.z, hpo, pos[4 * i4 + 2]);
            pos[4 * i4 + 3] = fmaf(x.w, hpo, pos[4 * i4 + 3]);
            neg[4 * i4] = fmaf(y.x, hmo, neg[4 * i4]);
            neg[4 * i4 + 1] = fmaf(y.y, hmo, neg[4 * i4 + 1]);
            neg[4 * i4 + 2] = fmaf(y.z, hmo, neg[4 * i4 + 2]);
            neg[4 * i4 + 3] = fmaf(y.w, hmo, neg[4 * i4 + 3]);
          }
          hdif += hp_raw - hm_raw;
          hsum += hp_raw + hm_raw;
          hpos += hp_raw;
        }
      }
#pragma unroll
      for (int i = 0; i < kUQ; ++i) pos[i] = (pos[i] - neg[i]) * inv_b;
      if (enh) {
        // gW_e = gW - mu gc^T - gb lam^T; the two matvecs gW_e lam and
        // gW_e^T mu are products under the compute dtype
        // (core.rbm_math.enhance_grads), the outer products are not
        const float gc_j = hdif * inv_b, lam_j = 0.5f * hsum * inv_b;
        float pc = 0.0f;
#pragma unroll
        for (int i = 0; i < kUQ; ++i) {
          const float gb_q = stat[i] * inv_b, mu_q = 0.5f * stat[kUQ + i] * inv_b;
          pos[i] = pos[i] - mu_q * gc_j - gb_q * lam_j;
          const float ge = op<kBf>(pos[i]);
          neg[i] = (col && i < nq) ? ge * op<kBf>(lam_j) : 0.0f;
          if (i < nq) pc = fmaf(ge, op<kBf>(mu_q), pc);
        }
        if (col) {
          a.part_c[static_cast<size_t>(unit) * H + j] = pc;
          if (unit == 0) {
            a.g_c[j] = gc_j;
            a.h0_mean[j] = hpos * inv_b;
          }
        }
#pragma unroll
        for (int i = 0; i < kUQ; ++i) {  // every lane takes part
          const float tsum = warp_sum(neg[i]);
          if (lane == 0) nred[warp * kUQ + i] += tsum;
        }
      }
      if (col) {
#pragma unroll
        for (int i = 0; i < kUQ; ++i) {
          if (i < nq)
            apply_loaded(a, a.W + w0 + static_cast<size_t>(i) * H,
                         a.vW + w0 + static_cast<size_t>(i) * H, old[i], old_vel[i], pos[i], m,
                         a.lr, true);
        }
      }
    }
    if (enh) __syncthreads();  // nred is complete
    if (own) {
      const int q = q0 + tid;
      float g = stat[tid] * inv_b;  // learned variance: of the staged v s
      if (enh) {
        float acc = 0.0f;
        for (int w = 0; w < kWarps; ++w) acc += nred[w * kUQ + tid];
        g = g - acc;
      }
      apply_loaded(a, a.b + q, a.vb + q, ob, ovb, g, m, a.lr, false);
      if (lv) {
        float gz = a.s_lv[q] * stat[2 * kUQ + tid] * inv_b;
        if (!(a.flags & kSampleVisible)) gz = gz - 0.5f;  // mean-field: E[(v-b)^2] adds sigma^2
        apply_loaded(a, a.z + q, a.vz + q, oz, ovz, gz, m, a.lr_z, false);
      }
    }
  }
  if (!enh) {  // c: one warp per hidden unit
    for (int o = s.gwarp; o < H; o += s.nwarps) {
      float acc = 0.0f, on = 0.0f;
      for (int r = s.lane; r < B; r += 32) {
        const float hpr = a.h0p[static_cast<size_t>(r) * H + o];
        acc += hpr - a.hmean[static_cast<size_t>(r) * H + o];
        on += hpr;
      }
      acc = warp_sum(acc);
      on = warp_sum(on);
      if (s.lane != 0) continue;
      float g = acc * inv_b;
      if (a.flags & kSparsity) g = g + a.sparsity_cost * (a.sparsity_target - on * inv_b);
      apply(a, a.c + o, a.vc + o, g, m, a.lr, false);
    }
  }
  // the monitor's row sums over the h W^T units' partials, on the last
  // blocks (which hold the fewest units)
  const int nmon = (V + kVQ - 1) / kVQ;
  for (int r = static_cast<int>(gridDim.x - 1 - blockIdx.x); r < B;
       r += static_cast<int>(gridDim.x)) {
    float x[1] = {0.0f};
#pragma unroll 4
    for (int u = tid; u < nmon; u += kThreads) x[0] += a.mon_part[static_cast<size_t>(u) * B + r];
    block_sum<1>(x, red);
    if (tid == 0) a.rowerr[r] = x[0];
  }
}

}  // namespace
