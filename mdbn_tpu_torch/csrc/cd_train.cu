// Fused multi-epoch CD-k / PCD training run of one RBM in ONE launch.
//
// Replaces: mdbn_tpu/ops/cd_epoch_pallas.py::_cd_train_kernel in its
// single-device modes (ndev=1), the kernel every layer of the graded configs
// trains through on the TPU, with its estimator modes: parallel tempering
// (:995-1113), the enhanced gradient (:1568-1586), learned variance (:980-989,
// :1589-1596) and the pseudo-likelihood monitor (_pseudo_likelihood_err :654,
// used at :1604-1610); with bf16 storage (:970-973, :1634-1711); and at the
// widths the TPU kernel needs its wide-state modes for (hbm_state :755-812,
// chunk_update _upd_w_chunk :1352, stream_vel, h_real :887-896). Those modes
// compute the same function under a VMEM budget: one master copy DMA'd in and
// out, the gradient applied in row chunks, velocity chunks staged from HBM, H
// padded to 128 lanes. This kernel keeps all state in device memory at any
// width and never holds gW whole, so it has no such modes.
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
// The modes:
//   tempering (M rungs): the chain is [M*B, H], rung m = rows [m*B, (m+1)*B)
//     at inverse temperature betas[m] (betas[0] = 1). The Gibbs steps run on
//     all M*B rows: means sigmoid(beta (pre)), Gaussian noise scaled by
//     1/sqrt(beta). Then pre_lp = h W^T + b of the whole ladder, and two
//     Metropolis swap rounds (even pairs, then odd) on log p*_beta(h). The
//     statistics come from rung 0 before the swaps; the monitor reconstructs
//     from h0s.
//   enhanced: gW_e = gW - mu gc^T - gb lam^T, gb_e = gb - gW_e lam,
//     gc_e = gc - gW_e^T mu (mu, lam: data+model means of v, h), then the
//     sparsity term on gc_e.
//   learned variance: z [V] = log sigma^2; s = e^{-z} scales the visibles
//     that enter the hidden units and the W / b statistics; sigma = e^{z/2}
//     scales the visible noise; gz = s sum_r (A_data - A_model)/B (-1/2 under
//     a mean-field negative phase), A = (v - b)^2/2 - v (W h); z follows the
//     momentum rule at lr_z with clipping and no decay.
//   pseudo monitor: flip bit i = ((start_epoch+e)*nb + i) mod V of each row
//     of v0: V * softplus(FE(v0) - FE(flip)), from pre_h0 = v0 W + c, row i
//     of W and b_i, all before the update.
//
// Random numbers: Philox4x32-10 keyed by the 64-bit seed the wrapper draws
// from its torch.Generator, counter (col, row, the draw word of t and kind,
// absolute update index; cd_common.cuh::draw_bits packs t < 2^22, so any k),
// so a draw does not depend on the launch's grid shape. Uniforms use
// the 23-bit mantissa trick of _uniform_from_bits, normals Box-Muller as in
// _normal_from_bits. Swap draws are a kind of their own, counter (0, m*B+r,
// the draw word of the round, update). Inject mode reads the draw_uniform_blocks layout
// ([E, nb(,k), rows, D], swap [E, nb, 2, (M-1)*B]) from device buffers.
//
// Precision: with f32 compute every product is an fp32 FMA with fp32
// accumulation, at least the precision of the TPU kernel's default
// one-pass-MXU "auto" mode. With bf16 compute the operands are rounded with
// __float2bfloat16 and accumulated in fp32. Storage (W, b, c, z, their
// velocities, the chain, the data) is f32 or bf16, chosen when the file is
// compiled (Store, cd_common.cuh): every read widens to fp32, the update
// arithmetic is fp32, a velocity rounds once into storage and a parameter is
// old + rounded velocity, rounded once. Scratch (h0p, hmean, vs, pre_lp, the
// enhanced partial sums) stays fp32.
//
// What bounds it on an H100: at batch 20 and 784x500 one CD-1 update is about
// 78 MFLOP (three Gibbs products and the gradient, each 2*B*V*H = 15.7 MFLOP)
// and moves about 8-12 MB of W and velocity through L2 (W is 1.57 MB and stays
// L2-resident in the 50 MB L2). Neither FLOPs nor bytes bound it: the update is
// a chain of 2 + 2k dependent phases (plus 1 product phase for tempering or
// learned variance, 2 swap rounds for tempering, 1 bias phase for enhanced),
// each separated by a grid-wide barrier, so it is bound by barrier and memory
// latency. At the wide shapes (20000x400, W 32 MB) the hidden phase is the
// cost: a block walks all of V for its 32 columns x 4 rows, so there are
// ceil(H/32) x ceil(B/4) = 65 units for 132 SMs and W is read once per row
// tile (5 times per phase); csrc/cd_train_wide.cu splits these products over
// V instead, and takes the runs whose W does not fit the L2.
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
// Which runs take this kernel: ops.cd_epoch_cuda.select_kernel gives every
// run whose tiles fit the shared memory of the card to cd_train_resident.cu
// (the estimator modes included) and the wide runs to cd_train_wide.cu and
// cd_train_wide_modes.cu, at any k; this kernel keeps the mode runs that fit
// neither (a tempering ladder too tall for the shared memory, say) and the
// pseudo monitor at widths the resident kernel cannot hold.
// In-place hazards of the modes: W, b, c and z change in place in the update
// phase, so nothing in that phase may read them. The pseudo monitor reads W
// and b, so it runs as extra units of the first visible phase; learned
// variance reads s = e^{-z} in the update phase, so the first phase of every
// update snapshots s and sigma into scratch and every later phase reads the
// snapshot. The enhanced bias sums need every W unit's gW_e, so each unit
// writes per-unit partial sums and a bias phase after one more barrier adds
// them in a fixed order. A tempering swap exchanges the two rows it owns.
// cd_train_resident.cu is the redesign of this kernel (W in the shared memory
// of thread-block clusters, cluster barriers instead of most grid barriers).
// The product, pseudo and swap phases live in cd_phases.cuh, shared with
// cd_grads.cu's data-parallel step.

#include "cd_phases.cuh"

namespace {

struct Args {
  const Store* data;    // [n_rows, V]
  const int* order;     // [E, nb] minibatch index of each update
  const float* u_h0;    // inject: [E, nb, B, H]
  const float* u_h;     // inject: [E, nb, k, CR, H]
  const float* u_v;     // inject: [E, nb, k, CR, V] uniforms or normals
  const float* u_swap;  // inject, tempering: [E, nb, 2, (M-1)*B]
  const float* betas;   // tempering: [M], betas[0] = 1
  Store* W;             // [V, H]
  Store* b;             // [V]
  Store* c;             // [H]
  Store* vW;
  Store* vb;
  Store* vc;
  Store* z;             // learned variance: [V] log sigma^2
  Store* vz;
  Store* chain;         // [CR, H], CR = M*B under tempering, else B
  float* errs;          // [E]
  float* h0p;           // scratch [B, H]
  Store* h0s;           // scratch [B, H] samples of h0p
  Store* hbuf;          // scratch [B, H] CD chain sample
  float* hmean;         // scratch [CR, H]
  float* vs;            // scratch [CR, V]
  float* v1mean;        // scratch [B, V]
  float* rowerr;        // scratch [B]
  float* pre_h0;        // pseudo: scratch [B, H] v0 W + c
  float* s_lv;          // learned variance: scratch [V] e^{-z} of this update
  float* sig_lv;        // learned variance: scratch [V] e^{z/2} of this update
  float* wh_a;          // learned variance: scratch [2B, V] A of the data ; model rows
  float* pre_lp;        // tempering: scratch [CR, V] h W^T + b of the ladder
  float* g_b;           // enhanced: scratch [V] plain gb
  float* g_c;           // enhanced: scratch [H] plain gc
  float* h0_mean;       // enhanced: scratch [H] mean of h0p (sparsity)
  float* part_b;        // enhanced: scratch [njc, V] partial sums of gW_e lam
  float* part_c;        // enhanced: scratch [nstrip, H] partial sums of gW_e^T mu
  unsigned long long* trace;  // optional [E, nb, stamps] phase start times (ns)
  int V, H, B, M, CR, nb, E, k, start_epoch, switch_epoch, flags;
  float lr, lr_z, momentum, initial_momentum, l2, grad_clip, sparsity_target,
      sparsity_cost;
  unsigned long long seed;
};

// Gradient and update of W, b, c (and z), plus the per-row monitor sums.
// W unit (one block): kQStrip consecutive visible units x kThreads hidden
// columns (thread = column). The strip's v0 and vs columns (learned variance:
// times the snapshot s) are staged in shared memory; each thread reads its
// columns of h0p and hmean once and sums each element over the B rows in row
// order. Enhanced: every thread also sums its strip's v columns and its own
// h column, which gives it gb, mu, gc and lam for its elements, so it
// recombines gW_e in place; the unit writes its partial sums of gW_e lam
// (block sum over its columns) and gW_e^T mu (per column, over its strip),
// and the bias phase adds them up after the next barrier. Monitor unit (one
// block): one batch row, summed by a fixed-shape tree. b, c and z: one warp
// per element, lanes over the rows, fixed butterfly (enhanced: in the bias
// phase).
template <bool kBf, bool kModes>
__device__ void update_phase(const Args& a, float* smem, const Split& s, const Store* v0,
                             float m) {
  const int V = a.V, H = a.H, B = a.B;
  const float inv_b = 1.0f / static_cast<float>(B);
  constexpr int kRowChunk = kSmemFloats / (2 * kQStrip);  // rows of the strip staged at once
  const int nstrip = (V + kQStrip - 1) / kQStrip, njc = (H + kThreads - 1) / kThreads;
  const int nwu = nstrip * njc;
  const bool xent = a.flags & kXent;
  const bool lv = kModes && (a.flags & kLearnVar);
  const bool enh = kModes && (a.flags & kEnhanced);
  const int nmon = (kModes && (a.flags & kPseudo)) ? 0 : B;  // the pseudo monitor ran already
  for (int unit = blockIdx.x; unit < nwu + nmon; unit += gridDim.x) {
    __syncthreads();  // shared memory of the previous unit is no longer read
    if (unit >= nwu) {  // monitor: sum over row r of the reconstruction error
      const size_t row = static_cast<size_t>(unit - nwu) * V;
      monitor_row(v0 + row, a.v1mean + row, V, xent, smem, a.rowerr + (unit - nwu));
      continue;
    }
    const int strip = unit % nstrip, cu = unit / nstrip;
    const int q0 = strip * kQStrip, j = cu * kThreads + threadIdx.x;
    const int nq = min(kQStrip, V - q0);
    float pos[kQStrip], neg[kQStrip], dsum[kQStrip], msum[kQStrip];
#pragma unroll
    for (int qi = 0; qi < kQStrip; ++qi) pos[qi] = neg[qi] = dsum[qi] = msum[qi] = 0.0f;
    float hdif = 0.0f, hsum = 0.0f, hpos = 0.0f;  // enhanced: sums of column j over the rows
    for (int rc = 0; rc < B; rc += kRowChunk) {
      const int nr = min(kRowChunk, B - rc);
      __syncthreads();
      for (int idx = threadIdx.x; idx < nr * kQStrip; idx += kThreads) {
        const int rr = idx / kQStrip, qi = idx - rr * kQStrip;
        const size_t g = static_cast<size_t>(rc + rr) * V + q0 + qi;
        const float sc = (lv && qi < nq) ? a.s_lv[q0 + qi] : 1.0f;
        smem[rr * 2 * kQStrip + qi] = qi < nq ? ld(v0 + g) * sc : 0.0f;
        smem[rr * 2 * kQStrip + kQStrip + qi] = qi < nq ? a.vs[g] * sc : 0.0f;
      }
      __syncthreads();
      if (j < H) {
#pragma unroll 4
        for (int rr = 0; rr < nr; ++rr) {
          const float hp_raw = a.h0p[(rc + rr) * H + j];
          const float hm_raw = a.hmean[(rc + rr) * H + j];
          const float hp = op<kBf>(hp_raw), hm = op<kBf>(hm_raw);
          const float* sv = smem + rr * 2 * kQStrip;
#pragma unroll
          for (int qi = 0; qi < kQStrip; ++qi) {
            pos[qi] = fmaf(op<kBf>(sv[qi]), hp, pos[qi]);
            neg[qi] = fmaf(op<kBf>(sv[kQStrip + qi]), hm, neg[qi]);
          }
          if (enh) {
#pragma unroll
            for (int qi = 0; qi < kQStrip; ++qi) {
              dsum[qi] += sv[qi] - sv[kQStrip + qi];
              msum[qi] += sv[qi] + sv[kQStrip + qi];
            }
            hdif += hp_raw - hm_raw;
            hsum += hp_raw + hm_raw;
            hpos += hp_raw;
          }
        }
      }
    }
    // pos := the gradient of each element; enhanced: neg := gW_e lam terms
#pragma unroll
    for (int qi = 0; qi < kQStrip; ++qi) pos[qi] = (pos[qi] - neg[qi]) * inv_b;
    if (enh) {
      const float gc_j = hdif * inv_b, lam_j = 0.5f * hsum * inv_b;
      float pc = 0.0f;
      // the two matvecs gW_e lam and gW_e^T mu are products under the compute
      // dtype (core.rbm_math.enhance_grads); the outer products are not
#pragma unroll
      for (int qi = 0; qi < kQStrip; ++qi) {
        const float gb_q = dsum[qi] * inv_b, mu_q = 0.5f * msum[qi] * inv_b;
        pos[qi] = pos[qi] - mu_q * gc_j - gb_q * lam_j;
        const float ge = op<kBf>(pos[qi]);
        neg[qi] = (j < H && qi < nq) ? ge * op<kBf>(lam_j) : 0.0f;
        if (qi < nq) pc = fmaf(ge, op<kBf>(mu_q), pc);
      }
      if (j < H) a.part_c[static_cast<size_t>(strip) * H + j] = pc;
      block_sum<kQStrip>(neg, smem);
      if (threadIdx.x == 0) {
        for (int qi = 0; qi < nq; ++qi) {
          a.part_b[static_cast<size_t>(cu) * V + q0 + qi] = neg[qi];
          if (cu == 0) a.g_b[q0 + qi] = dsum[qi] * inv_b;
        }
      }
      if (strip == 0 && j < H) {
        a.g_c[j] = gc_j;
        a.h0_mean[j] = hpos * inv_b;
      }
    }
    if (j < H) {
      const size_t w = static_cast<size_t>(q0) * H + j;
      apply_column<kQStrip>(a, a.W + w, a.vW + w, H, nq, pos, m);
    }
  }
  if (enh) return;  // b and c: enhanced_bias_phase, after the next barrier
  const int nz = lv ? V : 0;
  for (int o = s.gwarp; o < V + H + nz; o += s.nwarps) {
    float acc = 0.0f, on = 0.0f;
    if (o < V) {
      for (int r = s.lane; r < B; r += 32)
        acc += ld(v0 + static_cast<size_t>(r) * V + o) - a.vs[static_cast<size_t>(r) * V + o];
    } else if (o < V + H) {
      for (int r = s.lane; r < B; r += 32) {
        acc += a.h0p[r * H + o - V] - a.hmean[r * H + o - V];
        on += a.h0p[r * H + o - V];
      }
    } else {
      const int q = o - V - H;
      for (int r = s.lane; r < B; r += 32)
        acc += a.wh_a[static_cast<size_t>(r) * V + q] -
               a.wh_a[static_cast<size_t>(B + r) * V + q];
    }
    acc = warp_sum(acc);
    on = warp_sum(on);
    if (s.lane != 0) continue;
    if (o < V) {
      float g = acc * inv_b;
      if (lv) g = g * a.s_lv[o];
      apply(a, a.b + o, a.vb + o, g, m, a.lr, false);
    } else if (o < V + H) {
      float g = acc * inv_b;
      if (a.flags & kSparsity) g = g + a.sparsity_cost * (a.sparsity_target - on * inv_b);
      apply(a, a.c + o - V, a.vc + o - V, g, m, a.lr, false);
    } else {
      const int q = o - V - H;
      float g = a.s_lv[q] * acc * inv_b;
      if (!(a.flags & kSampleVisible)) g = g - 0.5f;  // mean-field: E[(v-b)^2] adds sigma^2
      apply(a, a.z + q, a.vz + q, g, m, a.lr_z, false);
    }
  }
}

// The enhanced gradient's bias updates: gb_e = gb - gW_e lam and gc_e = gc -
// gW_e^T mu (+ the sparsity term), each from the W units' partial sums added
// in a fixed order. One warp per element.
__device__ void enhanced_bias_phase(const Args& a, const Split& s, float m) {
  const int V = a.V, H = a.H;
  const int nstrip = (V + kQStrip - 1) / kQStrip, njc = (H + kThreads - 1) / kThreads;
  for (int o = s.gwarp; o < V + H; o += s.nwarps) {
    float acc = 0.0f;
    if (o < V) {
      for (int u = s.lane; u < njc; u += 32) acc += a.part_b[static_cast<size_t>(u) * V + o];
    } else {
      for (int u = s.lane; u < nstrip; u += 32)
        acc += a.part_c[static_cast<size_t>(u) * H + o - V];
    }
    acc = warp_sum(acc);
    if (s.lane != 0) continue;
    if (o < V) {
      apply(a, a.b + o, a.vb + o, a.g_b[o] - acc, m, a.lr, false);
    } else {
      const int jj = o - V;
      float g = a.g_c[jj] - acc;
      if (a.flags & kSparsity) g = g + a.sparsity_cost * (a.sparsity_target - a.h0_mean[jj]);
      apply(a, a.c + jj, a.vc + jj, g, m, a.lr, false);
    }
  }
}

// kModes: the estimator modes are compiled in (the plain CD/PCD run leaves
// them out, and with them their registers and branches).
template <bool kBf, bool kModes>
__global__ void __launch_bounds__(kThreads, 1) cd_train_kernel(Args a) {
  __shared__ float smem[kSmemFloats];  // 36 KB: staged row tiles + partial sums
  cg::grid_group grid = cg::this_grid();
  const Split s;
  const bool inject = a.flags & kInject;
  const bool persistent = a.flags & kPersistent;
  const bool xent = a.flags & kXent;
  const bool tempering = kModes && (a.flags & kTempering);
  const bool lv = kModes && (a.flags & kLearnVar);
  const bool enh = kModes && (a.flags & kEnhanced);
  const bool pseudo = kModes && (a.flags & kPseudo);
  const bool lead_warp = blockIdx.x == 0 && threadIdx.x < 32;  // sums the monitor
  const int B = a.B, V = a.V, CR = a.CR;
  const size_t bh = static_cast<size_t>(B) * a.H, ch = static_cast<size_t>(CR) * a.H;
  const int nstamp = 3 + 2 * a.k + ((tempering || lv) ? 1 : 0) + (tempering ? 2 : 0) +
                     (enh ? 1 : 0);
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
      const Store* v0 = a.data + static_cast<size_t>(a.order[ei]) * B * V;
      const int bit = static_cast<int>(
          (static_cast<long long>(abs_epoch) * a.nb + i) % V);  // pseudo monitor
      // block 0 stamps the start of each phase (after the barrier before it)
      unsigned long long* stamp =
          (a.trace && blockIdx.x == 0 && threadIdx.x == 0) ? a.trace + ei * nstamp : nullptr;
      if (stamp) *stamp++ = globaltimer_ns();
      hidden_phase<kBf, kModes>(a, smem, v0, B, nullptr, lv ? a.z : nullptr, a.h0p, a.h0s,
                        pseudo ? a.pre_h0 : nullptr, inject ? a.u_h0 + ei * bh : nullptr,
                        upd, kDrawH0, 0);
      if (lv) {  // this update's precision and std-dev, read by the later phases
        for (int q = blockIdx.x * kThreads + threadIdx.x; q < V; q += gridDim.x * kThreads) {
          a.s_lv[q] = expf(-ld(a.z + q));
          a.sig_lv[q] = expf(0.5f * ld(a.z + q));
        }
      }
      grid.sync();
      Store* hdst = persistent ? a.chain : a.hbuf;
      for (int t = 0; t < a.k; ++t) {
        const Store* hsrc = t > 0 ? hdst : (persistent ? a.chain : a.h0s);
        const Seg recon = (t == 0 && persistent && !pseudo)
                              ? Seg{a.h0s, nullptr, B, kRoleMonitor} : no_seg();
        if (stamp) *stamp++ = globaltimer_ns();
        visible_phase<kBf, kModes>(a, smem, Seg{hsrc, nullptr, CR, kRoleGibbs}, recon, no_seg(),
                                   v0, upd, ei, t, (t == 0 && pseudo) ? bit : -1);
        grid.sync();
        if (stamp) *stamp++ = globaltimer_ns();
        hidden_phase<kBf, kModes>(a, smem, a.vs, CR, lv ? a.s_lv : nullptr, nullptr, a.hmean, hdst,
                          nullptr, inject ? a.u_h + (ei * a.k + t) * ch : nullptr, upd,
                          kDrawH, t);
        grid.sync();
      }
      if (tempering || lv) {  // the ladder's pre_lp; the z statistic's A terms
        if (stamp) *stamp++ = globaltimer_ns();
        visible_phase<kBf, kModes>(
            a, smem, tempering ? Seg{a.chain, nullptr, CR, kRolePreLp} : no_seg(),
            lv ? Seg{nullptr, a.h0p, B, kRoleWhData} : no_seg(),
            lv ? Seg{nullptr, a.hmean, B, kRoleWhModel} : no_seg(), v0, upd, ei, 0, -1);
        grid.sync();
      }
      if (tempering) {
        for (int p = 0; p < 2; ++p) {
          if (stamp) *stamp++ = globaltimer_ns();
          swap_phase<kBf>(a, smem, upd, ei, p);
          grid.sync();
        }
      }
      if (stamp) *stamp++ = globaltimer_ns();
      update_phase<kBf, kModes>(a, smem, s, v0, m);
      grid.sync();
      if (enh) {
        if (stamp) *stamp++ = globaltimer_ns();
        enhanced_bias_phase(a, s, m);
        grid.sync();
      }
      if (stamp) *stamp++ = globaltimer_ns();
      if (lead_warp) {
        const float tot = rows_total(a.rowerr, B);
        err_sum += pseudo ? tot / static_cast<float>(B)
                   : xent ? -tot / static_cast<float>(B)
                          : tot / (static_cast<float>(B) * static_cast<float>(V));
      }
    }
    if (lead_warp && threadIdx.x == 0) {
      a.errs[e] = err_sum * (1.0f / static_cast<float>(a.nb));
      err_sum = 0.0f;
    }
  }
}

// Points the scratch fields of `a` into `base` (when not null) and returns
// the floats they take; a buffer of a mode that is off takes none.
long long carve_scratch(Args& a, float* base, int V, int H, int B, int M, int flags) {
  const long long CR = (flags & kTempering) ? static_cast<long long>(M) * B : B;
  const long long bh = static_cast<long long>(B) * H, bv = static_cast<long long>(B) * V;
  const long long nstrip = (V + kQStrip - 1) / kQStrip, njc = (H + kThreads - 1) / kThreads;
  const bool pt = flags & kTempering, enh = flags & kEnhanced, lv = flags & kLearnVar;
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
  a.pre_lp = take(pt ? CR * V : 0);
  a.g_b = take(enh ? V : 0);
  a.g_c = take(enh ? H : 0);
  a.h0_mean = take(enh ? H : 0);
  a.part_b = take(enh ? njc * V : 0);
  a.part_c = take(enh ? nstrip * H : 0);
  return n;
}

}  // namespace

extern "C" {

// Launches the whole run on `stream`. grid <= 0 picks one block per SM.
// Returns a cudaError_t (0 on success); a grid larger than the co-resident
// block count returns cudaErrorCooperativeLaunchTooLarge without launching.
int cd_train_run(const Store* data, const int* order, const float* u_h0,
                 const float* u_h, const float* u_v, const float* u_swap,
                 const float* betas, Store* W, Store* b, Store* c, Store* vW, Store* vb,
                 Store* vc, Store* z, Store* vz, Store* chain, float* errs, float* scratch,
                 unsigned long long* trace, int V, int H, int B, int M, int nb, int E, int k,
                 int start_epoch, int switch_epoch, int flags, float lr, float lr_z,
                 float momentum, float initial_momentum, float l2, float grad_clip,
                 float sparsity_target, float sparsity_cost, unsigned long long seed,
                 int device, int grid, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int coop = 0, nsm = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const bool bf = flags & kBf16;
  const bool modes = flags & (kTempering | kEnhanced | kLearnVar | kPseudo);
  const void* fn =
      bf ? (modes ? reinterpret_cast<const void*>(&cd_train_kernel<true, true>)
                  : reinterpret_cast<const void*>(&cd_train_kernel<true, false>))
         : (modes ? reinterpret_cast<const void*>(&cd_train_kernel<false, true>)
                  : reinterpret_cast<const void*>(&cd_train_kernel<false, false>));
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0)) !=
      cudaSuccess)
    return err;
  if (grid <= 0) grid = nsm;
  if (grid > per_sm * nsm) return cudaErrorCooperativeLaunchTooLarge;

  Args a;
  a.data = data; a.order = order; a.u_h0 = u_h0; a.u_h = u_h; a.u_v = u_v;
  a.u_swap = u_swap; a.betas = betas;
  a.W = W; a.b = b; a.c = c; a.vW = vW; a.vb = vb; a.vc = vc; a.z = z; a.vz = vz;
  a.chain = chain; a.errs = errs;
  carve_scratch(a, scratch, V, H, B, M, flags);
  a.trace = trace;
  a.V = V; a.H = H; a.B = B; a.M = M; a.CR = (flags & kTempering) ? M * B : B;
  a.nb = nb; a.E = E; a.k = k;
  a.start_epoch = start_epoch; a.switch_epoch = switch_epoch; a.flags = flags;
  a.lr = lr; a.lr_z = lr_z; a.momentum = momentum; a.initial_momentum = initial_momentum;
  a.l2 = l2; a.grad_clip = grad_clip; a.sparsity_target = sparsity_target;
  a.sparsity_cost = sparsity_cost; a.seed = seed;

  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), params, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Scratch floats the wrapper allocates for one run.
long long cd_train_scratch_floats(int V, int H, int B, int M, int flags) {
  Args a;
  return carve_scratch(a, nullptr, V, H, B, M, flags);
}

const char* cd_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
