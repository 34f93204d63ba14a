// One CD-k / PCD step's statistics for one data-parallel shard, in ONE launch,
// with no update: the per-step kernel of the data-parallel training path.
//
// Replaces: mdbn_tpu/ops/cd_epoch_pallas.py::_cd_grads_kernel (:3184), built
// by make_pallas_grads_fn (:3279), which mdbn_tpu/parallel/dp.py calls once
// per shard per step before its pmean, and the step of the TPU's DP
// mega-kernel (the DP mode of _cd_train_kernel, :2743-2910) in every
// estimator mode. Here each rank launches this kernel, which writes its
// statistics into one flat buffer, then all-reduces the buffer with
// torch.distributed outside the kernel (mdbn_tpu_torch/parallel/dp.py), and
// applies the update with the second kernel of this file, cd_update_kernel
// (below): together with the NCCL all-reduce the two stand for the TPU's DP
// mega-kernel, whose in-kernel exchange maps to a collective between launches
// on this card.
//
// What it computes (B rows of this shard; m_r the row mask, 1 when there is
// none; n = norm; s = e^{-z} under learned variance, else 1):
//   h0p  = sigmoid((s v0) W + c),  h0s = (u_h0 < h0p)
//   h    = chain (PCD) or h0s (CD); k Gibbs steps on all chain rows:
//            vmean = sigmoid(beta (h W^T + b))  (Bernoulli)  or  h W^T + b  (Gaussian)
//            vs    = (u_v < vmean) | vmean + sigma noise / sqrt(beta) | vmean
//            hmean = sigmoid(beta ((s vs) W + c)),  h = (u_h < hmean)
//   tempering (M rungs): the chain is [M*B, H] rung-major, rung m at
//     betas[m]; after the sweeps, pre_lp = h W^T + b of the ladder and two
//     Metropolis swap rounds (cd_phases.cuh); the statistics use rung 0.
//   PCD: chain_out = h, and the monitor reconstructs the data chain,
//        v1mean = sigmoid(h0s W^T + b) (Gaussian: h0s W^T + b);
//   CD:  chain_out = chain, v1mean = the t = 0 visible mean.
//   The flat buffer (ops/cd_grads_cuda.py::flat_size), every entry a sum
//   that the exchange can add up (core.rbm_math.split_grads):
//   gW = sum_r m_r ((s v0_r)^T h0p_r - (s vs_r)^T hmean_r) / n
//   gb = s sum_r m_r (v0_r - vs_r) / n
//   gc = sum_r m_r (h0p_r - hmean_r) / n [+ cost (target - sum_r m_r h0p_r / n)]
//   learned variance: gz = sum_r m_r (A_data - A_model) / n, the raw statistic,
//     A = (v - b)^2/2 - v (W h); the update kernel scales it by s (and
//     subtracts 1/2 under mean-field visibles) after the exchange;
//   enhanced: the plain gW, gb, gc (no sparsity term) and mu = sum_r m_r
//     (v0_r + vs_r) / 2n, lam = sum_r m_r (h0p_r + hmean_r) / 2n, h0 = sum_r
//     m_r h0p_r / n; the update kernel recombines them after the exchange;
//   err = mse: sum_r m_r |v0_r - v1mean_r|^2 / n / V
//         xent: -sum_r m_r sum_q (v0 log p + (1 - v0) log(1 - p)) / n,
//               p = clip(v1mean, 1e-7, 1 - 1e-7)
//         pseudo: sum_r m_r V softplus(FE(v0_r) - FE(flip_bit(v0_r))) / n, on
//               the pre-update W and b (the bit is the wrapper's).
// Pad rows (m_r = 0) still run their Gibbs chain (their ladder); they enter
// no statistic.
//
// Random numbers: Philox4x32-10 (cd_common.cuh) keyed by the wrapper's 64-bit
// seed, counter (col, row, the draw word of t and kind, 0: draw_bits); the
// data-parallel path derives a
// distinct seed per step and rank. Inject mode reads the ops/cd_step layout:
// u_h0 [B, H], u_h [k, CR, H], u_v [k, CR, V] (uniforms, or normals for
// Gaussian visibles), u_swap [2, (M-1)*B] (draw_pt_uniforms under tempering).
//
// Precision: the parameters, the data and the chain are stored at the
// library's storage type (Store, cd_common.cuh: f32 or bf16, -DMDBN_STORE_BF16)
// and widen to f32 as they are read; the statistics, the scratch and the
// draws are f32; the chain written back rounds into Store (0 and 1 are exact).
// With f32 compute every product is an fp32 FMA with fp32 accumulation; with
// bf16 compute the operands of every product round to bf16 and accumulate in
// fp32, as core.rbm_math._dot does.
//
// What bounds it on an H100: at c1's shape (784x500, B 20, CD-1) one step is
// 78 MFLOP (three Gibbs products 2*B*V*H each, the gradient 2*2B*V*H), 1.2 us
// at the f32 peak, and moves W in and gW out, 3.1 MB, 0.9 us at the memory rate.
// Neither bounds it: the step is 2 + 2k dependent phases (+1 products phase
// under tempering or learned variance, +2 swap rounds under tempering) with a
// grid-wide barrier after each, so it is bound by barrier and L2 latency,
// like cd_train.cu, plus one launch per step.
//
// Design now: one cooperative launch per step (grid no larger than the
// co-resident block count, one block per SM by default), cooperative_groups
// grid sync between phases (a run whose tiles fit the shared memory of
// thread-block clusters takes csrc/cd_train_resident.cu's step variant
// instead: ops/cd_epoch_cuda.py::select_dp_kernel). The product, pseudo and swap phases are
// cd_train.cu's (cd_phases.cuh): the same tiles and the same order of sums.
// The monitor's row sums ride as extra units of the first hidden phase
// (v1mean is ready by then; the pseudo monitor's in the first visible phase,
// as in cd_train.cu), and the gradient phase adds them up. Each gW unit
// (kQStrip rows of W x kThreads columns, one block) sums its elements over
// the 2B rows in row order; the vector statistics take one warp per element
// with a fixed butterfly. No atomics: the bits do not depend on the grid.
// kModes: tempering, learned variance, the enhanced sums and pseudo are
// compiled in; the plain CD/PCD step leaves them out. A captured epoch
// (parallel/dp.py) passes `tab`, a device row of {minibatch, seed, pseudo
// bit} that the kernel reads at entry, so one graph serves every epoch.

#include "cd_phases.cuh"

namespace {

constexpr int kMasked = 8192;  // a row mask is given (the other bits: cd_common.cuh)

struct Args {
  const Store* v0;        // [B, V] (with tab: the minibatches [*, B, V] it indexes)
  const long long* tab;   // optional [3]: the step's minibatch, seed and pseudo bit
  const float* mask;      // kMasked: [B] of 0/1
  const float* u_h0;      // inject: [B, H]
  const float* u_h;       // inject: [k, CR, H]
  const float* u_v;       // inject, sampled visibles: [k, CR, V]
  const float* u_swap;    // inject, tempering: [2, (M-1)*B]
  const float* betas;     // tempering: [M], betas[0] = 1
  const Store* W;         // [V, H]
  const Store* b;         // [V]
  const Store* c;         // [H]
  const Store* z;         // learned variance: [V] log sigma^2
  const Store* chain_in;  // [CR, H]
  Store* chain;           // [CR, H] the chain out
  float* gW;              // [V, H]: views of the flat statistics buffer
  float* gb;              // [V]
  float* gc;              // [H]
  float* gz;              // learned variance: [V] the raw statistic
  float* mu;              // enhanced: [V]
  float* lam;             // enhanced: [H]
  float* h0m;             // enhanced: [H] the data-phase mean of h
  float* err;             // [1]
  float* h0p;             // scratch [B, H]
  Store* h0s;             // scratch [B, H] samples of h0p
  Store* hbuf;            // scratch [B, H] CD chain samples
  float* hmean;           // scratch [CR, H]
  float* vs;              // scratch [CR, V]
  float* v1mean;          // scratch [B, V]
  float* rowerr;          // scratch [B] the monitor's sum over each row
  float* pre_h0;          // pseudo: scratch [B, H] v0 W + c
  float* s_lv;            // learned variance: scratch [V] e^{-z}
  float* sig_lv;          // learned variance: scratch [V] e^{z/2}
  float* wh_a;            // learned variance: scratch [2B, V] A of the data ; model rows
  float* pre_lp;          // tempering: scratch [CR, V] h W^T + b of the ladder
  int V, H, B, M, CR, k, flags, bit;
  float inv_norm, sparsity_target, sparsity_cost;
  unsigned long long seed;
};

__device__ __forceinline__ float row_mask(const Args& a, int r) {
  return (a.flags & kMasked) ? a.mask[r] : 1.0f;
}

// The flat buffer's statistics and err. gW unit (one block): kQStrip
// consecutive visible units x kThreads hidden columns (thread = column); the
// strip's masked (learned variance: precision-scaled) v0 and vs columns are
// staged in shared memory, and each thread sums its elements over the rows in
// row order. The vector statistics (gb, gc, gz, mu, lam, h0): one warp per
// element, lanes over the rows, fixed butterfly. err: block 0's first warp
// adds the monitor's masked row sums.
template <bool kBf, bool kModes>
__device__ void grads_phase(const Args& a, float* smem, const Split& s) {
  const int V = a.V, H = a.H, B = a.B;
  const float inv = a.inv_norm;
  const bool lv = kModes && (a.flags & kLearnVar);
  const bool enh = kModes && (a.flags & kEnhanced);
  const bool pseudo = kModes && (a.flags & kPseudo);
  constexpr int kRowChunk = kSmemFloats / (2 * kQStrip);  // rows of a strip staged at once
  const int nstrip = (V + kQStrip - 1) / kQStrip, njc = (H + kThreads - 1) / kThreads;
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    float tot = 0.0f;
    for (int r = threadIdx.x; r < B; r += 32) tot += a.rowerr[r] * row_mask(a, r);
    tot = warp_sum(tot);
    if (threadIdx.x == 0)
      *a.err = pseudo                   ? tot * inv
               : (a.flags & kXent) ? -tot * inv
                                   : tot * inv * (1.0f / static_cast<float>(V));
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
        const float sc = (lv && qi < nq) ? a.s_lv[q0 + qi] : 1.0f;
        smem[rr * 2 * kQStrip + qi] = qi < nq ? op<kBf>(ld(a.v0 + g) * m * sc) : 0.0f;
        smem[rr * 2 * kQStrip + kQStrip + qi] = qi < nq ? op<kBf>(a.vs[g] * m * sc) : 0.0f;
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
  // vector statistics: [0, V) visible units, [V, V + H) hidden units,
  // [V + H, 2V + H) the z statistic (learned variance)
  for (int o = s.gwarp; o < V + H + (lv ? V : 0); o += s.nwarps) {
    float acc = 0.0f, sp = 0.0f, sn = 0.0f;
    if (o < V) {
      const float sc = lv ? a.s_lv[o] : 1.0f;
      for (int r = s.lane; r < B; r += 32) {
        const size_t g = static_cast<size_t>(r) * V + o;
        const float m = row_mask(a, r);
        const float x0 = ld(a.v0 + g) * m, xs = a.vs[g] * m;
        acc += x0 * sc - xs * sc;
        if (enh) {
          sp += x0;
          sn += xs;
        }
      }
    } else if (o < V + H) {
      for (int r = s.lane; r < B; r += 32) {
        const size_t g = static_cast<size_t>(r) * H + o - V;
        const float m = row_mask(a, r);
        acc += (a.h0p[g] - a.hmean[g]) * m;
        sp += a.h0p[g] * m;
        if (enh) sn += a.hmean[g] * m;
      }
    } else {
      const int q = o - V - H;
      for (int r = s.lane; r < B; r += 32)
        acc += (a.wh_a[static_cast<size_t>(r) * V + q] -
                a.wh_a[static_cast<size_t>(B + r) * V + q]) * row_mask(a, r);
    }
    acc = warp_sum(acc);  // o and enh are the same in every lane of the warp
    if (enh || (o >= V && o < V + H)) sp = warp_sum(sp);
    if (enh) sn = warp_sum(sn);
    if (s.lane != 0) continue;
    if (o < V) {
      a.gb[o] = acc * inv;
      if (enh) a.mu[o] = 0.5f * (sp + sn) * inv;
    } else if (o < V + H) {
      const int jj = o - V;
      float g = acc * inv;
      if (enh) {
        a.lam[jj] = 0.5f * (sp + sn) * inv;
        a.h0m[jj] = sp * inv;
      } else if (a.flags & kSparsity) {
        g = g + a.sparsity_cost * (a.sparsity_target - sp * inv);
      }
      a.gc[jj] = g;
    } else {
      a.gz[o - V - H] = acc * inv;
    }
  }
}

template <bool kBf, bool kModes>
__global__ void __launch_bounds__(kThreads, 1) cd_grads_kernel(Args a) {
  __shared__ float smem[kSmemFloats];  // 36 KB: staged row tiles + partial sums
  if (a.tab) {  // a captured step: its minibatch, seed and bit from device memory
    a.v0 += a.tab[0] * a.B * a.V;
    a.seed = static_cast<unsigned long long>(a.tab[1]);
    a.bit = static_cast<int>(a.tab[2]);
  }
  cg::grid_group grid = cg::this_grid();
  const Split s;
  const bool inject = a.flags & kInject;
  const bool persistent = a.flags & kPersistent;
  const bool tempering = kModes && (a.flags & kTempering);
  const bool lv = kModes && (a.flags & kLearnVar);
  const bool pseudo = kModes && (a.flags & kPseudo);
  const int B = a.B, V = a.V, CR = a.CR;
  const size_t ch = static_cast<size_t>(CR) * a.H;
  hidden_phase<kBf, kModes>(a, smem, a.v0, B, nullptr, lv ? a.z : nullptr, a.h0p, a.h0s,
                            pseudo ? a.pre_h0 : nullptr, inject ? a.u_h0 : nullptr, 0u,
                            kDrawH0, 0);
  if (lv) {  // this step's precision and std-dev, read by the later phases
    for (int q = blockIdx.x * kThreads + threadIdx.x; q < V; q += gridDim.x * kThreads) {
      a.s_lv[q] = expf(-ld(a.z + q));
      a.sig_lv[q] = expf(0.5f * ld(a.z + q));
    }
  }
  if (!persistent) {  // CD: the chain passes through unchanged
    for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < ch;
         i += static_cast<size_t>(gridDim.x) * kThreads)
      a.chain[i] = a.chain_in[i];
  }
  grid.sync();
  Store* hdst = persistent ? a.chain : a.hbuf;
  for (int t = 0; t < a.k; ++t) {
    const Store* hsrc = t > 0 ? hdst : (persistent ? a.chain_in : a.h0s);
    const Seg recon = (t == 0 && persistent && !pseudo) ? Seg{a.h0s, nullptr, B, kRoleMonitor}
                                                          : no_seg();
    visible_phase<kBf, kModes>(a, smem, Seg{hsrc, nullptr, CR, kRoleGibbs}, recon, no_seg(),
                               a.v0, 0u, 0, t, (t == 0 && pseudo) ? a.bit : -1);
    grid.sync();
    hidden_phase<kBf, kModes>(a, smem, a.vs, CR, lv ? a.s_lv : nullptr, nullptr, a.hmean,
                              hdst, nullptr, inject ? a.u_h + t * ch : nullptr, 0u, kDrawH, t,
                              a.v0, (t == 0 && !pseudo) ? B : 0);
    grid.sync();
  }
  if (tempering || lv) {  // the ladder's pre_lp; the z statistic's A terms
    visible_phase<kBf, kModes>(
        a, smem, tempering ? Seg{a.chain, nullptr, CR, kRolePreLp} : no_seg(),
        lv ? Seg{nullptr, a.h0p, B, kRoleWhData} : no_seg(),
        lv ? Seg{nullptr, a.hmean, B, kRoleWhModel} : no_seg(), a.v0, 0u, 0, 0, -1);
    grid.sync();
  }
  if (tempering) {
    for (int p = 0; p < 2; ++p) {
      swap_phase<kBf>(a, smem, 0u, 0, p);
      grid.sync();
    }
  }
  grads_phase<kBf, kModes>(a, smem, s);
}

// The update after the all-reduce, the second kernel of a data-parallel step:
// every rank launches it on the same summed buffer, so every rank's W, b, c
// (and z) stay bit-identical. Replaces the update in the body of the TPU's DP
// mega-kernel (mdbn_tpu/ops/cd_epoch_pallas.py:1568-1687, the DP mode of
// _cd_train_kernel built at :3039), which there follows its in-kernel
// exchange. Per element, with g = sums * scale (scale = 1 / ranks):
//   learned variance: gz = e^{-z} g (- 1/2 under mean-field visibles);
//   enhanced: gW_e = gW - mu gc^T - gb lam^T, gb_e = gb - gW_e lam,
//     gc_e = gc - gW_e^T mu + cost (target - h0);
//   clip g (when asked), g -= l2 * W (W only), vel = m * vel + lr * g
//   (lr_z for z), param += vel.
// Each product and sum rounds on its own (__fmul_rn, __fadd_rn: no fused
// multiply-add), as the plain version's separate PyTorch ops do, so the two
// give the same bits wherever the plain version is elementwise; at bf16
// storage the velocity rounds once into Store and the parameter is old +
// rounded velocity, rounded once (cd_common.cuh). The enhanced gradient's
// two matvecs sum over all of gW_e, so they run first, as a kernel of their
// own (cd_enhance_kernel, below): tiles of gW_e over every SM, each element
// formed once for both sums, the tiles' shares in fixed order, so every rank
// gets the same bits; the update adds the shares in tile order where it
// updates b and c, and forms gW_e again, with the same rounding, where W is
// updated. Bound by bytes: it reads the sums, W, b, c and their velocities
// once and writes the parameters and velocities once (c1: 7.8 MB, 2.3 us at
// 3.35 TB/s; the enhanced pass reads gW's sums once more); one element per
// thread, grid-stride. The momentum comes from device memory when `mom` is
// given (a captured epoch's), else from `m`.
struct UpdateArgs {
  const float* sums;  // the flat statistics (ops/cd_grads_cuda.py::flat_size) summed over ranks
  Store* W;           // [V, H], in place
  Store* b;           // [V]
  Store* c;           // [H]
  Store* z;           // learned variance: [V]
  Store* vW;          // velocities, in place
  Store* vb;
  Store* vc;
  Store* vz;
  float* err;         // [1]: the step's mean monitor
  float* part;        // enhanced: cd_enhance_kernel's shares (enh_tiling: [ncb, V], [nrb, H])
  const float* mom;   // optional [1]: the momentum, read in place of m
  long long nW, n_flat;
  int V, H, flags;
  float scale, lr, lr_z, m, l2, grad_clip, sparsity_target, sparsity_cost;
};

// Offsets of the flat buffer's parts.
__device__ __forceinline__ long long off_extra(const UpdateArgs& a) {
  return a.nW + a.V + a.H;  // gz (learned variance) or mu (enhanced)
}

__device__ __forceinline__ float sum_at(const UpdateArgs& a, long long i) {
  return __fmul_rn(a.sums[i], a.scale);
}

// gW_e of element (q, j): gW - mu_q gc_j - gb_q lam_j, each op rounded.
__device__ __forceinline__ float enhanced_w(const UpdateArgs& a, int q, int j) {
  const long long x = off_extra(a);
  const float g = sum_at(a, static_cast<long long>(q) * a.H + j);
  const float t1 = __fmul_rn(sum_at(a, x + q), sum_at(a, a.nW + a.V + j));
  const float t2 = __fmul_rn(sum_at(a, a.nW + q), sum_at(a, x + a.V + j));
  return __fsub_rn(__fsub_rn(g, t1), t2);
}

__device__ __forceinline__ void update_one(const UpdateArgs& a, Store* p, Store* vel, float g,
                                           float m, float lr, bool decay) {
  if (a.flags & kClip) g = fminf(fmaxf(g, -a.grad_clip), a.grad_clip);
  const float old = ld(p);
  if (decay && a.l2 != 0.0f) g = __fsub_rn(g, __fmul_rn(a.l2, old));
  const float nv = round_store(__fadd_rn(__fmul_rn(m, ld(vel)), __fmul_rn(lr, g)));
  st(vel, nv);
  st(p, __fadd_rn(old, nv));
}

// The enhanced gradient's matvecs gW_e lam (for gb_e) and gW_e^T mu (for
// gc_e), spread over the card. gW_e is cut into tiles of kEnhCols columns
// and `rows` rows (enh_tiling, from V and H alone: about kEnhTiles tiles),
// one block each, so every element is formed once and feeds both sums.
// Thread (group g, column c) walks the tile's rows g, g + kEnhGroups, ... in
// order: its column's share of gW_e^T mu, and each row's share of gW_e lam
// over the tile's columns (a fixed butterfly in each of the row's two warps,
// then the two in order). Out: part[cb * V + q] the share of tile column cb
// in row q, part[ncb * V + rb * H + j] the share of tile row rb in column j
// (the row groups in order); cd_update_kernel adds them in tile order. The
// products' operands round to bf16 under bf16 compute
// (core.rbm_math.enhance_grads). Replaces a pass of 15 us at c1 whose column
// sums ran on ceil(H / 32) blocks, each warp one dependent load at a time.
constexpr int kEnhCols = 64, kEnhGroups = kThreads / kEnhCols;
constexpr int kEnhTiles = 128, kEnhMaxRowTiles = 32, kEnhMaxRows = 4096;

struct EnhTiling {
  int ncb, nrb, rows;  // tile columns, tile rows, rows of a tile
};

__host__ __device__ inline EnhTiling enh_tiling(int V, int H) {
  EnhTiling t;
  t.ncb = (H + kEnhCols - 1) / kEnhCols;
  int nrb = kEnhTiles / t.ncb;
  nrb = nrb < 1 ? 1 : nrb > kEnhMaxRowTiles ? kEnhMaxRowTiles : nrb;
  t.rows = (V + nrb - 1) / nrb;
  if (t.rows > kEnhMaxRows) t.rows = kEnhMaxRows;  // the row shares fit 32 KB
  t.nrb = (V + t.rows - 1) / t.rows;
  return t;
}

template <bool kBf>
__global__ void __launch_bounds__(kThreads) cd_enhance_kernel(UpdateArgs a) {
  extern __shared__ float esm[];  // [rows][2] the row shares of the tile's halves; [groups][cols]
  const int V = a.V, H = a.H;
  const EnhTiling et = enh_tiling(V, H);
  const int cb = blockIdx.x % et.ncb, rb = blockIdx.x / et.ncb;
  const int c = threadIdx.x % kEnhCols, grp = threadIdx.x / kEnhCols;
  const int lane = threadIdx.x & 31, half = (threadIdx.x >> 5) & 1;
  const int j = cb * kEnhCols + c, q0 = rb * et.rows, nq = min(et.rows, V - q0);
  const long long x = off_extra(a);
  const bool col = j < H;
  const float lam_j = col ? op<kBf>(sum_at(a, x + V + j)) : 0.0f;
  float* rs = esm;
  float* cs = esm + 2 * et.rows;
  float acc = 0.0f;
  for (int qq = grp; qq < nq; qq += kEnhGroups) {  // the same rows in every lane of a warp
    const int q = q0 + qq;
    const float ge = col ? op<kBf>(enhanced_w(a, q, j)) : 0.0f;
    acc = fmaf(ge, op<kBf>(sum_at(a, x + q)), acc);
    const float r = warp_sum(ge * lam_j);
    if (lane == 0) rs[qq * 2 + half] = r;
  }
  cs[grp * kEnhCols + c] = acc;
  __syncthreads();
  for (int qq = threadIdx.x; qq < nq; qq += kThreads)
    a.part[static_cast<size_t>(cb) * V + q0 + qq] = rs[qq * 2] + rs[qq * 2 + 1];
  if (grp == 0 && col) {
    float tot = 0.0f;
    for (int g = 0; g < kEnhGroups; ++g) tot += cs[g * kEnhCols + c];
    a.part[static_cast<size_t>(et.ncb) * V + static_cast<size_t>(rb) * H + j] = tot;
  }
}

// kModes: learned variance and the enhanced gradient are compiled in; the
// plain update leaves them out, and with them their registers.
template <bool kModes>
__global__ void __launch_bounds__(kThreads) cd_update_kernel(UpdateArgs a) {
  const bool lv = kModes && (a.flags & kLearnVar), enh = kModes && (a.flags & kEnhanced);
  const long long nb = a.nW + a.V, nc = nb + a.H, n = nc + (lv ? a.V : 0);
  const float m = a.mom ? __ldg(a.mom) : a.m;
  const EnhTiling et = enh_tiling(a.V, a.H);
  // the vector elements (b, c, z) on the first threads, then W from the next
  // whole warp on (so a warp's W elements stay aligned): the vector sums (the
  // enhanced gradient's shares) then overlap W's elements instead of trailing
  const long long nvec = n - a.nW, wbase = (nvec + 31) / 32 * 32;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       t < wbase + a.nW; t += static_cast<long long>(gridDim.x) * kThreads) {
    if (t >= nvec && t < wbase) continue;
    const long long i = t < nvec ? a.nW + t : t - wbase;
    if (i < a.nW) {
      const float g = enh ? enhanced_w(a, static_cast<int>(i / a.H), static_cast<int>(i % a.H))
                          : sum_at(a, i);
      update_one(a, a.W + i, a.vW + i, g, m, a.lr, true);
    } else if (i < nb) {
      const long long q = i - a.nW;
      float g = sum_at(a, i);
      if (enh) {  // gb_e = gb - gW_e lam: the tile columns' shares in order
        float tot = 0.0f;
        for (int cb = 0; cb < et.ncb; ++cb) tot += a.part[cb * static_cast<long long>(a.V) + q];
        g = __fsub_rn(g, tot);
      }
      update_one(a, a.b + q, a.vb + q, g, m, a.lr, false);
    } else if (i < nc) {
      const long long j = i - nb;
      float g = sum_at(a, i);
      if (enh) {  // gc_e = gc - gW_e^T mu: the tile rows' shares in order; the sparsity term
        const float* p = a.part + et.ncb * static_cast<long long>(a.V) + j;
        float tot = 0.0f;
        for (int rb = 0; rb < et.nrb; ++rb) tot += p[rb * static_cast<long long>(a.H)];
        g = __fsub_rn(g, tot);
        if (a.flags & kSparsity)
          g = __fadd_rn(g, __fmul_rn(a.sparsity_cost,
                                     __fsub_rn(a.sparsity_target,
                                               sum_at(a, off_extra(a) + a.V + a.H + j))));
      }
      update_one(a, a.c + j, a.vc + j, g, m, a.lr, false);
    } else {
      const long long q = i - nc;
      float g = __fmul_rn(expf(-ld(a.z + q)), sum_at(a, i));
      if (!(a.flags & kSampleVisible)) g = __fsub_rn(g, 0.5f);
      update_one(a, a.z + q, a.vz + q, g, m, a.lr_z, false);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.err = sum_at(a, a.n_flat - 1);
}

// Points the scratch fields of `a` into `base` (when not null) and returns
// the floats they take; a buffer of a mode that is off takes none.
long long carve_scratch(Args& a, float* base, int V, int H, int B, int M, int flags) {
  const long long CR = (flags & kTempering) ? static_cast<long long>(M) * B : B;
  const long long bh = static_cast<long long>(B) * H, bv = static_cast<long long>(B) * V;
  const bool lv = flags & kLearnVar;
  long long n = 0;
  auto take = [&](long long count) {
    float* p = base ? base + n : nullptr;
    n += count;
    return p;
  };
  a.h0p = take(bh);
  a.h0s = reinterpret_cast<Store*>(take(bh));  // samples, in a float-sized slot each
  a.hbuf = reinterpret_cast<Store*>(take(bh));
  a.hmean = take(CR * H);
  a.vs = take(CR * V);
  a.v1mean = take(bv);
  a.rowerr = take(B);
  a.pre_h0 = take((flags & kPseudo) ? bh : 0);
  a.s_lv = take(lv ? V : 0);
  a.sig_lv = take(lv ? V : 0);
  a.wh_a = take(lv ? 2 * bv : 0);
  a.pre_lp = take((flags & kTempering) ? CR * V : 0);
  return n;
}

// The step kernel's variant for the compute type and the modes.
const void* step_variant(int v) {
  switch (v) {
    case 0: return reinterpret_cast<const void*>(&cd_grads_kernel<false, false>);
    case 1: return reinterpret_cast<const void*>(&cd_grads_kernel<false, true>);
    case 2: return reinterpret_cast<const void*>(&cd_grads_kernel<true, false>);
    default: return reinterpret_cast<const void*>(&cd_grads_kernel<true, true>);
  }
}

// The device's SM count and each step variant's co-resident blocks per SM,
// asked once per device (before a launch is captured in a CUDA graph, which
// must make no such request: cd_grads_prepare).
constexpr int kMaxDevices = 64;
int g_nsm[kMaxDevices], g_per_sm[kMaxDevices][4];

cudaError_t device_info(int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_nsm[device] != 0) return cudaSuccess;
  cudaError_t err = cudaSuccess;
  int coop = 0, n = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  for (int v = 0; v < 4; ++v) {
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g_per_sm[device][v],
                                                              step_variant(v), kThreads, 0)) !=
        cudaSuccess)
      return err;
  }
  g_nsm[device] = n;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches one step on `stream`, writing the statistics into the flat
// buffer `out` (ops/cd_grads_cuda.py::flat_size). grid <= 0 picks one block
// per SM. Returns a cudaError_t (0 on success); a grid larger than the
// co-resident block count returns cudaErrorCooperativeLaunchTooLarge without
// launching.
int cd_grads_step(const Store* v0, const long long* tab, const float* mask, const float* u_h0,
                  const float* u_h, const float* u_v, const float* u_swap, const float* betas,
                  const Store* W, const Store* b, const Store* c, const Store* z,
                  const Store* chain_in, float* out, Store* chain_out, float* scratch, int V,
                  int H, int B, int M, int k, int flags, int bit, float inv_norm,
                  float sparsity_target, float sparsity_cost, unsigned long long seed,
                  int device, int grid, void* stream) {
  cudaError_t err_ = cudaSetDevice(device);
  if (err_ != cudaSuccess) return err_;
  if ((err_ = device_info(device)) != cudaSuccess) return err_;
  const bool modes = flags & (kTempering | kEnhanced | kLearnVar | kPseudo);
  const int variant = ((flags & kBf16) ? 2 : 0) + (modes ? 1 : 0);
  if (grid <= 0) grid = g_nsm[device];
  if (grid > g_per_sm[device][variant] * g_nsm[device]) return cudaErrorCooperativeLaunchTooLarge;

  const long long nW = static_cast<long long>(V) * H;
  Args a;
  a.v0 = v0; a.tab = tab; a.mask = mask; a.u_h0 = u_h0; a.u_h = u_h; a.u_v = u_v; a.u_swap = u_swap;
  a.betas = betas; a.W = W; a.b = b; a.c = c; a.z = z; a.chain_in = chain_in;
  a.chain = chain_out;
  a.gW = out; a.gb = out + nW; a.gc = out + nW + V;
  float* extra = out + nW + V + H;
  a.gz = (flags & kLearnVar) ? extra : nullptr;
  a.mu = (flags & kEnhanced) ? extra : nullptr;
  a.lam = (flags & kEnhanced) ? extra + V : nullptr;
  a.h0m = (flags & kEnhanced) ? extra + V + H : nullptr;
  a.err = extra + ((flags & kLearnVar) ? V : 0) + ((flags & kEnhanced) ? V + 2 * H : 0);
  carve_scratch(a, scratch, V, H, B, M, flags);
  a.V = V; a.H = H; a.B = B; a.M = M; a.CR = (flags & kTempering) ? M * B : B;
  a.k = k; a.flags = flags; a.bit = bit;
  a.inv_norm = inv_norm; a.sparsity_target = sparsity_target; a.sparsity_cost = sparsity_cost;
  a.seed = seed;

  void* params[] = {&a};
  err_ = cudaLaunchCooperativeKernel(step_variant(variant), dim3(grid), dim3(kThreads), params,
                                     0, static_cast<cudaStream_t>(stream));
  if (err_ != cudaSuccess) return err_;
  return cudaGetLastError();
}

// Launches the update on `stream`: under the enhanced gradient first
// cd_enhance_kernel (its shares into `part`, cd_enhance_scratch_floats),
// then one thread per element of W, b, c (and z), at most 8 blocks per SM.
// `mom`: the momentum in device memory, or null to take m. Returns a
// cudaError_t (0 on success).
int cd_update_step(const float* sums, Store* W, Store* b, Store* c, Store* z, Store* vW,
                   Store* vb, Store* vc, Store* vz, float* err, float* part, const float* mom,
                   int V, int H, int flags, float scale, float lr, float lr_z, float m, float l2,
                   float grad_clip, float sparsity_target, float sparsity_cost, int device,
                   void* stream) {
  cudaError_t err_ = cudaSetDevice(device);
  if (err_ != cudaSuccess) return err_;
  if ((err_ = device_info(device)) != cudaSuccess) return err_;
  const int nsm = g_nsm[device];
  const bool lv = flags & kLearnVar, enh = flags & kEnhanced;
  UpdateArgs a;
  a.sums = sums; a.W = W; a.b = b; a.c = c; a.z = z;
  a.vW = vW; a.vb = vb; a.vc = vc; a.vz = vz; a.err = err; a.part = part; a.mom = mom;
  a.nW = static_cast<long long>(V) * H;
  a.n_flat = a.nW + V + H + (lv ? V : 0) + (enh ? V + 2 * H : 0) + 1;
  a.V = V; a.H = H; a.flags = flags;
  a.scale = scale; a.lr = lr; a.lr_z = lr_z; a.m = m; a.l2 = l2; a.grad_clip = grad_clip;
  a.sparsity_target = sparsity_target; a.sparsity_cost = sparsity_cost;
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  if (enh) {
    const EnhTiling et = enh_tiling(V, H);
    const size_t smem = (2 * static_cast<size_t>(et.rows) + kEnhGroups * kEnhCols) * sizeof(float);
    if (flags & kBf16)
      cd_enhance_kernel<true><<<et.ncb * et.nrb, kThreads, smem, st_>>>(a);
    else
      cd_enhance_kernel<false><<<et.ncb * et.nrb, kThreads, smem, st_>>>(a);
    if ((err_ = cudaGetLastError()) != cudaSuccess) return err_;
  }
  const long long n = a.nW + V + H + (lv ? V : 0);
  const long long blocks = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 8LL * nsm ? blocks : 8LL * nsm);
  if (lv || enh)
    cd_update_kernel<true><<<grid, kThreads, 0, st_>>>(a);
  else
    cd_update_kernel<false><<<grid, kThreads, 0, st_>>>(a);
  return cudaGetLastError();
}

// Asks the device what the launches need (device_info) ahead of them, as a
// launch captured in a CUDA graph must ask nothing. Returns a cudaError_t.
int cd_grads_prepare(int device) {
  cudaError_t err = cudaSetDevice(device);
  return err != cudaSuccess ? err : device_info(device);
}

// Floats of the enhanced gradient's shares (cd_update_step's `part`).
long long cd_enhance_scratch_floats(int V, int H) {
  const EnhTiling et = enh_tiling(V, H);
  return static_cast<long long>(et.ncb) * V + static_cast<long long>(et.nrb) * H;
}

// Scratch floats the wrapper allocates for one step.
long long cd_grads_scratch_floats(int V, int H, int B, int M, int flags) {
  Args a;
  return carve_scratch(a, nullptr, V, H, B, M, flags);
}

const char* cd_grads_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
