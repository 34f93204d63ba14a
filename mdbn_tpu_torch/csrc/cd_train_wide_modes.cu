// Fused multi-epoch training run of one WIDE RBM under the estimator modes
// (parallel tempering, the enhanced gradient, learned variance, in any
// combination the config allows) in ONE cooperative launch; every x W product
// is a sum over fixed strips of W's rows, as in csrc/cd_train_wide.cu.
//
// Replaces: mdbn_tpu/ops/cd_epoch_pallas.py::_cd_train_kernel (:692) in its
// single-device estimator modes at the widths the TPU trains through its
// hbm_state mode (:755-812): tempering (:995-1113), the enhanced gradient
// (:1568-1586), learned variance (:980-989, :1589-1596), bf16 storage
// (:970-973, :1634-1711). It computes what csrc/cd_train.cu's kModes variant
// computes for such a config (see that file's header for the function and
// the modes), with the same Philox keying (counter (col, row, the draw word of t
// and kind, update: cd_common.cuh::draw_bits), swap draws a kind of their
// own, counter (0, m*B+r, the draw word of the round, update)) and the same inject layout, so one seed draws the same
// numbers on both kernels. Its plain version is
// ops.cd_epoch_cuda.cd_train_run_plain. Scope (the wrapper refuses the
// rest, ops.cd_epoch_cuda.wide_modes_unsupported): at least one of the three
// modes, Gaussian or Bernoulli visibles, mean-field or sampled, mse or xent
// monitor, any k, batch <= 256; not the pseudo-likelihood monitor.
//
// What bounds it on an H100 at the rows it was built for (20000x400, batch
// 20): W is 32 MB at f32 (16 MB at bf16). One update needs 2 + 2k products
// of B rows with W (3 + 3k rows' worth under a tempering ladder of M rungs:
// the k Gibbs steps run on M*B rows, the swap rounds need h W^T of the whole
// ladder), about 0.65 GFLOP at CD-1 f32 (10 us at the 67 TFLOP/s f32 peak),
// and the update reads W and writes W and its velocity (96 MB, 29 us at
// 3.35 TB/s; 128 MB under momentum). So the bound is the bytes of the
// update plus the products' operations, about 40 us an update; cd_train.cu
// takes 990-2000 us there because its products do not split over V (65
// units for 132 SMs, W re-read per 4-row tile), tempering's pre_lp pass
// writes and reads [M*B, V], and its update neither overlaps nor keeps h in
// shared memory.
//
// Design: one persistent cooperative launch per run, one 256-thread block an
// SM (up to 255 registers a thread; each phase a function of its own), 96 KB
// of dynamic shared memory a block, grid barriers between the phases of an
// update (cd_wide_modes_phases.cuh):
// 1. x W (the data rows, then each Gibbs step's M*B rows): W's rows are cut
//    into strips of 512; a unit is a strip x 32 columns, and one pass over
//    the strip carries all of the phase's rows (up to 64 at once), so W is
//    read once per phase whatever M is; the next 128 rows' W and x load into
//    registers while this sub-tile's products run. Each strip writes its
//    partial sums; after a barrier they are added in strip order: no
//    atomics, the bits do not depend on the grid.
// 2. h W^T (each Gibbs step's visibles and the PCD monitor's reconstruction;
//    tempering's log p*(h) terms; learned variance's A terms): a unit is 64
//    rows of W, every row of the phase loops inside it, and a thread holds a
//    4-row x 4-row register tile of the product; the next 64 hidden units of
//    h and W load into registers while this chunk's products run. Tempering
//    never stores [M*B, V]: the unit reduces its rows' terms of log
//    p*_beta(h) (the Gaussian quadratic, scaled by s under learned variance,
//    or the Bernoulli softplus at every rung's beta) into [V/64, M*B] strip
//    partials; swap round 0 adds them in strip order and the rounds then
//    swap the terms with their rows. The statistics come from rung 0 before
//    the swaps. The reconstruction monitor's terms (from h0s under PCD, from
//    Gibbs step 0 under CD) are reduced the same way into [V/64, B]
//    partials, which the update phase adds up per row: no pass over [B, V]
//    for the monitor.
// 3. The update: a unit owns a strip of 16 rows of W across all H columns;
//    its v0 and vs columns (and learned variance's A terms) are staged in
//    shared memory from registers loaded while the previous unit ran, h0p
//    and hmean are staged once per phase, and each thread issues its loads
//    of W (and vW under momentum) before it sums the products, b and z of
//    the unit's rows at the unit's start. In the same pass the unit applies the enhanced
//    correction gW_e = gW - mu gc^T - gb lam^T, gb_e and b for its own rows,
//    and learned variance's gz and z for its own rows, read through the
//    snapshot of s = e^{-z} and sigma = e^{z/2} taken in the first phase of
//    the update. Only gc_e = gc - gW_e^T mu sums over V: each unit writes
//    [V/16, H] strip partials, and the sum in strip order runs in the first
//    phase of the next update (x W from the data does not read c), or after
//    the last update, so it costs no barrier.
// Grid barriers per update: 3 + 3k, +1 under tempering or learned variance
// (the h W^T product phase), +2 under tempering (the swap rounds); the
// enhanced gradient adds none. cd_train.cu has 2 + 2k (+1, +2, +1 enhanced).
// Products are fp32 FMAs with fp32 accumulation (bf16 compute rounds the
// operands, as cd_train.cu does); storage is Store (cd_common.cuh). Every sum
// runs in a fixed order, so grids 1, 7, 132 and the default give the same
// bits. The optional trace records each phase's start on block 0's clock.
// In-place hazards: W, b, z change in the update phase and c in the first
// phase of the next update (under the enhanced gradient), where nothing
// reads them; the swap rounds exchange only the rows they own.
// Later: wgmma products at bf16 compute, a fused strip of the update with
// the next update's x W partial over the same strip.

#include "cd_wide_modes_phases.cuh"

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
  float* part;          // scratch [NS, CR, H] an x W product's partial sums per strip
  float* h0p;           // scratch [B, H]
  Store* h0s;           // scratch [B, H] samples of h0p
  Store* hbuf;          // scratch [B, H] CD chain sample
  float* hmean;         // scratch [CR, H]
  float* vs;            // scratch [CR, V]
  float* mon_part;      // scratch [V/64, B] the monitor's terms per strip of 64 rows of W
  float* rowerr;        // scratch [B]
  float* s_lv;          // learned variance: scratch [V] e^{-z} of this update
  float* sig_lv;        // learned variance: scratch [V] e^{z/2} of this update
  float* wh_a;          // learned variance: scratch [2B, V] A of the data ; model rows
  float* lp_part;       // tempering: scratch [V/64, CR, NT] terms of log p*_beta(h) per strip
  float* lp;            // tempering: scratch [CR, NT] the terms of each chain row
  float* g_c;           // enhanced: scratch [H] plain gc
  float* h0_mean;       // enhanced: scratch [H] mean of h0p (sparsity)
  float* part_c;        // enhanced: scratch [V/16, H] partial sums of gW_e^T mu
  unsigned long long* trace;  // optional [E, nb, stamps] phase start times (ns)
  int V, H, B, M, CR, NT, NS, nb, E, k, start_epoch, switch_epoch, flags, hstaged;
  float lr, lr_z, momentum, initial_momentum, l2, grad_clip, sparsity_target,
      sparsity_cost;
  unsigned long long seed;
};

// One block an SM, so a thread has up to 255 registers: at two blocks an SM
// (128 registers) the phases spilled.
template <bool kBf>
__global__ void __launch_bounds__(kThreads, 1)
    cd_train_wide_modes_kernel(const __grid_constant__ Args a) {
  cg::grid_group grid = cg::this_grid();
  const Split s;
  const bool inject = a.flags & kInject;
  const bool persistent = a.flags & kPersistent;
  const bool xent = a.flags & kXent;
  const bool tempering = a.flags & kTempering;
  const bool lv = a.flags & kLearnVar;
  const bool enh = a.flags & kEnhanced;
  const bool lead_warp = blockIdx.x == 0 && threadIdx.x < 32;  // sums the monitor
  const int B = a.B, V = a.V, CR = a.CR;
  const size_t bh = static_cast<size_t>(B) * a.H, ch = static_cast<size_t>(CR) * a.H;
  const int nstamp = 4 + 3 * a.k + ((tempering || lv) ? 1 : 0) + (tempering ? 2 : 0);
  float err_sum = 0.0f;  // lead warp: the epoch's running monitor sum
  bool c_pending = false;  // enhanced: the last update's gc_e is still to apply
  float m_prev = 0.0f;
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
      // block 0 stamps the start of each phase (after the barrier before it)
      unsigned long long* stamp =
          (a.trace && blockIdx.x == 0 && threadIdx.x == 0) ? a.trace + ei * nstamp : nullptr;
      if (stamp) *stamp++ = globaltimer_ns();
      xw_rows_phase<kBf>(a, v0, B, nullptr, lv ? a.z : nullptr);
      if (lv) {  // this update's precision and std-dev, read by the later phases
        for (int q = blockIdx.x * kThreads + threadIdx.x; q < V; q += gridDim.x * kThreads) {
          a.s_lv[q] = expf(-ld(a.z + q));
          a.sig_lv[q] = expf(0.5f * ld(a.z + q));
        }
      }
      if (c_pending) enhanced_c_phase(a, s, m_prev);
      grid.sync();
      if (stamp) *stamp++ = globaltimer_ns();
      hidden_rows_reduce(a, B, a.h0p, a.h0s, inject ? a.u_h0 + ei * bh : nullptr, upd,
                         kDrawH0, 0);
      grid.sync();
      Store* hdst = persistent ? a.chain : a.hbuf;
      for (int t = 0; t < a.k; ++t) {
        const Store* hsrc = t > 0 ? hdst : (persistent ? a.chain : a.h0s);
        const MSeg recon = (t == 0 && persistent) ? MSeg{a.h0s, nullptr, B, kMMonitor}
                                                  : no_mseg();
        if (stamp) *stamp++ = globaltimer_ns();
        hwt_phase<kBf>(a, MSeg{hsrc, nullptr, CR, kMGibbs}, recon, no_mseg(), v0, upd,
                       ei, t);
        grid.sync();
        if (stamp) *stamp++ = globaltimer_ns();
        xw_rows_phase<kBf>(a, a.vs, CR, lv ? a.s_lv : nullptr, nullptr);
        grid.sync();
        if (stamp) *stamp++ = globaltimer_ns();
        hidden_rows_reduce(a, CR, a.hmean, hdst, inject ? a.u_h + (ei * a.k + t) * ch : nullptr,
                           upd, kDrawH, t);
        grid.sync();
      }
      if (tempering || lv) {  // the ladder's log p*(h) terms; the z statistic's A terms
        if (stamp) *stamp++ = globaltimer_ns();
        hwt_phase<kBf>(a,
                       tempering ? MSeg{a.chain, nullptr, CR, kMLp} : no_mseg(),
                       lv ? MSeg{nullptr, a.h0p, B, kMWhData} : no_mseg(),
                       lv ? MSeg{nullptr, a.hmean, B, kMWhModel} : no_mseg(), v0, upd, ei, 0);
        grid.sync();
      }
      if (tempering) {
        for (int p = 0; p < 2; ++p) {
          if (stamp) *stamp++ = globaltimer_ns();
          modes_swap_phase<kBf>(a, upd, ei, p);
          grid.sync();
        }
      }
      if (stamp) *stamp++ = globaltimer_ns();
      modes_update_phase<kBf>(a, s, v0, m);
      grid.sync();
      c_pending = enh;
      m_prev = m;
      if (stamp) *stamp++ = globaltimer_ns();
      if (lead_warp) {
        const float tot = rows_total(a.rowerr, B);
        err_sum += xent ? -tot / static_cast<float>(B)
                        : tot / (static_cast<float>(B) * static_cast<float>(V));
      }
    }
    if (lead_warp && threadIdx.x == 0) {
      a.errs[e] = err_sum * (1.0f / static_cast<float>(a.nb));
      err_sum = 0.0f;
    }
  }
  if (c_pending) enhanced_c_phase(a, s, m_prev);  // the last update's gc_e
}

// Points the scratch fields of `a` into `base` (when not null) and returns
// the floats they take; a buffer of a mode that is off takes none.
long long carve_scratch(Args& a, float* base, int V, int H, int B, int M, int flags) {
  const bool pt = flags & kTempering, enh = flags & kEnhanced, lv = flags & kLearnVar;
  const long long CR = pt ? static_cast<long long>(M) * B : B;
  const long long bh = static_cast<long long>(B) * H, bv = static_cast<long long>(B) * V;
  const long long ns = (V + kXStripRows - 1) / kXStripRows, nqb = (V + kVQ - 1) / kVQ;
  const long long nt = pt ? ((flags & kGaussian) ? 1 : M) : 0;
  const long long nus = (V + kUQ - 1) / kUQ;
  long long n = 0;
  auto take = [&](long long count) {
    float* p = base ? base + n : nullptr;
    n += (count + 3) / 4 * 4;  // every buffer 16-byte aligned
    return p;
  };
  a.part = take(ns * CR * H);
  a.h0p = take(bh);
  a.h0s = reinterpret_cast<Store*>(take(bh));  // samples, in a float-sized slot each
  a.hbuf = reinterpret_cast<Store*>(take(bh));
  a.hmean = take(CR * H);
  a.vs = take(CR * V);
  a.mon_part = take(nqb * B);
  a.rowerr = take(B);
  a.s_lv = take(lv ? V : 0);
  a.sig_lv = take(lv ? V : 0);
  a.wh_a = take(lv ? 2 * bv : 0);
  a.lp_part = take(pt ? nqb * CR * nt : 0);
  a.lp = take(pt ? CR * nt : 0);
  a.g_c = take(enh ? H : 0);
  a.h0_mean = take(enh ? H : 0);
  a.part_c = take(enh ? nus * H : 0);
  return n;
}

// The update phase's shared memory with h0p and hmean staged: whether it
// fits decides Args::hstaged. Without them it needs at most
// update_smem_floats(kMaxBatch, 0) floats.
long long update_smem_floats(int B, int H) {
  return (2LL * B * H + 3) / 4 * 4 + 3LL * kUQ * B + 3 * kUQ + kWarps * kUQ + kWarps;
}
static_assert((3 * kUQ * kMaxBatch + 3 * kUQ + kWarps * kUQ + kWarps) <= kSmemFloats,
              "a strip of the largest batch fits");

}  // namespace

extern "C" {

// Launches the whole run on `stream`. grid <= 0 picks one block per SM.
// Returns a cudaError_t (0 on success); a grid larger than the co-resident
// block count returns cudaErrorCooperativeLaunchTooLarge without launching.
int cd_train_wide_modes_run(const Store* data, const int* order, const float* u_h0,
                            const float* u_h, const float* u_v, const float* u_swap,
                            const float* betas, Store* W, Store* b, Store* c, Store* vW,
                            Store* vb, Store* vc, Store* z, Store* vz, Store* chain,
                            float* errs, float* scratch, unsigned long long* trace, int V, int H,
                            int B, int M, int nb, int E, int k, int start_epoch,
                            int switch_epoch, int flags, float lr, float lr_z, float momentum,
                            float initial_momentum, float l2, float grad_clip,
                            float sparsity_target, float sparsity_cost, unsigned long long seed,
                            int device, int grid, void* stream) {
  if (B > kMaxBatch) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int coop = 0, nsm = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const void* fn = (flags & kBf16)
                       ? reinterpret_cast<const void*>(&cd_train_wide_modes_kernel<true>)
                       : reinterpret_cast<const void*>(&cd_train_wide_modes_kernel<false>);
  const int smem_bytes = kSmemFloats * static_cast<int>(sizeof(float));
  if ((err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem_bytes)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                           smem_bytes)) != cudaSuccess)
    return err;
  if (grid <= 0) grid = nsm;
  if (grid < 1 || grid > per_sm * nsm) return cudaErrorCooperativeLaunchTooLarge;

  Args a;
  a.data = data; a.order = order; a.u_h0 = u_h0; a.u_h = u_h; a.u_v = u_v;
  a.u_swap = u_swap; a.betas = betas;
  a.W = W; a.b = b; a.c = c; a.vW = vW; a.vb = vb; a.vc = vc; a.z = z; a.vz = vz;
  a.chain = chain; a.errs = errs;
  carve_scratch(a, scratch, V, H, B, M, flags);
  a.trace = trace;
  const bool pt = flags & kTempering;
  a.V = V; a.H = H; a.B = B; a.M = M; a.CR = pt ? M * B : B;
  a.NT = pt ? ((flags & kGaussian) ? 1 : M) : 0;
  a.NS = (V + kXStripRows - 1) / kXStripRows;
  a.hstaged = update_smem_floats(B, H) <= kSmemFloats;
  a.nb = nb; a.E = E; a.k = k;
  a.start_epoch = start_epoch; a.switch_epoch = switch_epoch; a.flags = flags;
  a.lr = lr; a.lr_z = lr_z; a.momentum = momentum; a.initial_momentum = initial_momentum;
  a.l2 = l2; a.grad_clip = grad_clip; a.sparsity_target = sparsity_target;
  a.sparsity_cost = sparsity_cost; a.seed = seed;

  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), params, smem_bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Scratch floats the wrapper allocates for one run.
long long cd_train_wide_modes_scratch_floats(int V, int H, int B, int M, int flags) {
  Args a;
  return carve_scratch(a, nullptr, V, H, B, M, flags);
}

const char* cd_train_wide_modes_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
