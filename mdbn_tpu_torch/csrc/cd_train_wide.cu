// Fused multi-epoch CD-k / PCD training run of one WIDE RBM in one launch:
// every product with W is a sum over fixed strips of W's rows.
//
// Replaces: mdbn_tpu/ops/cd_epoch_pallas.py::_cd_train_kernel_wb (:1981, built
// by _build_wblocked_call :2398), the fully W-blocked kernel the TPU trains
// 28000x400 f32, 40000x1000 bf16 and 20000x400 at batch 64 through. Written
// from what that kernel computes, not from its blocks: there is no lane
// packing of the factors, no padding of H and no broadcast bias here.
//
// What it computes, for e in [0, E), i in [0, nb) (one update each):
//   v0   = data rows [order[e,i]*B, +B)               (at storage dtype)
//   h0p  = sigmoid(v0 W + c),  h0s = (u_h0 < h0p)
//   h    = chain (PCD) or h0s (CD); k Gibbs steps, mean-field visibles:
//            vm    = h W^T + b (Gaussian) or its sigmoid (Bernoulli)
//            vs    = vm rounded through the storage dtype (the TPU kernel keeps
//                    its factors in a scratch at storage dtype)
//            hmean = sigmoid(vs W + c),  h = (u_h < hmean)
//   gW = (v0^T h0p - vs^T hmean)/B, gb = sum(v0 - vs)/B,
//   gc = sum(h0p - hmean)/B + sparsity_cost*(target - mean(h0p))
//   clip, L2 on W, vel = m*vel + lr*g rounded once into storage,
//   param = param + vel rounded once (m follows the momentum schedule)
//   monitor: mse or xent of v0 against the unrounded vm of t = 0 (PCD:
//   against the reconstruction from h0s); errs[e] = the epoch's mean.
// The chain is written back only in PCD mode. Scope: mean-field negative
// phase, mse/xent monitor, plain gradient, no tempering, no learned variance
// (the wrapper refuses the rest). Draws: h0 and h only, with cd_train.cu's
// Philox keying and inject layout, so one seed gives both kernels the same
// draws.
//
// What bounds it on an H100 (132 SMs, 50 MB L2, 3.35 TB/s, 67 TFLOP/s f32):
// one CD-1 update of B rows makes three products of B x V x H with W and the
// gradient's two (B V H FMAs each), and reads and writes W and writes its
// velocity once (reads it too under momentum). At 20000x400 f32, batch 20,
// that is 1.6 GFLOP (24 us at the f32 peak) and 96 MB (29 us, 38 us under
// momentum); W's 32 MB stay in the L2 between the products. At 40000x1000
// bf16, 8 GFLOP and 240 MB: 72 us of bytes (8 us of operations at the bf16
// tensor-core peak, 119 us as f32 FMAs). So the bound is the update's bytes,
// and every phase is short enough that its latency and the 3 + 3k grid
// barriers of an update count. On the card two more limits bind first: a
// load the compiler cannot move past a shared-memory store (the global reads
// are generic) is the only one in flight, so every staging loop batches its
// loads or uses cp.async; and a broadcast LDS.128 costs 4 of the SM's clocks
// (128 bytes a clock) like any other, so a value read from shared memory has
// to enter several FMAs: each product loop holds a thread tile that reuses
// what it reads, without changing any sum's order.
//
// Design (Hopper): one persistent cooperative launch per run, ONE 256-thread
// block an SM (grid <= 0: the SM count), so each thread has up to 255
// registers, and each phase is a function of its own (not inlined) with the
// registers for itself; dynamic shared memory up to the card's opt-in limit
// (232,448 bytes on an H100), sized by wide_plan from the shapes alone. Grid
// barriers between the phases of an update. The phases are in
// cd_wide_phases.cuh, shared with the data-parallel step and update
// (cd_grads_wide.cu).
// - x W (x = v0 or vs): W's rows are cut into strips of 512. A unit is one
//   strip x 32 hidden columns (lane = column), or x 64 (two a lane) where H
//   is wide enough that the grid still has as much work; each warp loads 16
//   rows of its columns for each of two 128-row sub-tiles at once, started
//   before the batch rows of x are staged, and adds each sub-tile's products
//   with up to 64 rows into per-row sums in shared memory. The unit writes
//   its partial sums; after a barrier the reduce phase adds the strips'
//   partials in strip order, adds c, takes the sigmoid and samples. At bf16
//   compute the units run on the tensor cores instead: a unit is one strip x
//   32 columns staged as bf16, each warp takes 64 of its rows as
//   mma.m16n8k16 tiles (bf16 operands, f32 sums) and the warps' sums are
//   added in warp order. The strip size and the tiles are fixed, not derived
//   from the grid, and nothing is atomic: grids 1, 7, 132 and the default give
//   the same bits.
// - h W^T: a unit is 64 rows of W, two a lane (lane, lane + 32); warp w owns
//   rows w, w + 8, ... of the phase's rows (the Gibbs step's h, then under
//   PCD the data chain's h0s for the monitor), up to 8 each, so a pass of up
//   to 64 rows fits the batch (B = 20: three rows a warp, no padding to a
//   fixed tile) and a thread owns whole outputs: each is summed over H in
//   order, with no sum across threads. The pass's rows of h are staged in
//   shared memory once per phase (by windows of hidden units, again per
//   unit, when one row does not fit); W streams through a ring of three
//   64-row tiles of 512 bytes a row by cp.async (plain loads where W's rows
//   do not start on 16 bytes), two tiles in flight while this one's FMAs
//   run; the rows are padded by 16 bytes against bank conflicts.
// - gradient and update: a unit is a strip of 16 rows of W across all H
//   columns; a thread takes items of 8 rows x 4 adjacent columns. h0p and
//   hmean are staged once per phase where [2, B, H] floats fit (else read
//   through the L2); the strip's v0 and vs (and v0 - vs for gb) sit in one of
//   two buffers, the next unit's staged at the end of this one from registers
//   loaded a unit earlier; the next strip's W (and vW under momentum only: at
//   momentum 0 the old velocity is never needed) streams into shared memory
//   by cp.async while this one is updated, where it fits (else a thread
//   loads its old values after its sums). Each element is summed over the
//   rows in row order, then updated: W read and written once, vW written
//   once. b and vb of the strip's rows are loaded at the unit's start; c is
//   updated by one warp per hidden unit.
// In-place hazard: the update phase changes W and the next update's v0 W
// reads it, so a barrier separates them. Later: tensor-core h W^T and gW at
// bf16 compute, and fusing a strip's update with the next update's v0 W
// partial over the same strip (one pass over W less).

#include "cd_wide_phases.cuh"

namespace {

struct Args {
  const Store* data;    // [n_rows, V]
  const int* order;     // [E, nb] minibatch index of each update
  const float* u_h0;    // inject: [E, nb, B, H]
  const float* u_h;     // inject: [E, nb, k, B, H]
  Store* W;             // [V, H]
  Store* b;             // [V]
  Store* c;             // [H]
  Store* vW;
  Store* vb;
  Store* vc;
  Store* chain;         // [B, H]
  float* errs;          // [E]
  float* part;          // scratch [NS, B, H] one x W product's partial sums per strip
  float* h0p;           // scratch [B, H]
  Store* h0s;           // scratch [B, H] samples of h0p
  Store* hbuf;          // scratch [B, H] CD chain sample
  float* hmean;         // scratch [B, H]
  float* vs;            // scratch [B, V] negative-phase visibles, rounded through Store
  float* v1mean;        // scratch [B, V] the monitor's reconstruction (unrounded)
  float* rowerr;        // scratch [B]
  unsigned long long* trace;  // optional [E, nb, 3k + 4] phase start times (ns)
  int V, H, B, NS, nb, E, k, start_epoch, switch_epoch, flags;
  int vis_rows, vis_window, hstride, hstaged, strip_rows, wtiles;  // the WidePlan
  float lr, momentum, initial_momentum, l2, grad_clip, sparsity_target, sparsity_cost;
  unsigned long long seed;
};

template <bool kBf>
__global__ void __launch_bounds__(kThreads, 1)
    cd_train_wide_kernel(const __grid_constant__ Args a) {
  cg::grid_group grid = cg::this_grid();
  const bool inject = a.flags & kInject;
  const bool persistent = a.flags & kPersistent;
  const bool xent = a.flags & kXent;
  const bool lead_warp = blockIdx.x == 0 && threadIdx.x < 32;  // sums the monitor
  const int B = a.B, V = a.V;
  const size_t bh = static_cast<size_t>(B) * a.H;
  const int nstamp = 3 * a.k + 4;
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
      // block 0 stamps the start of each phase (after the barrier before it)
      unsigned long long* stamp =
          (a.trace && blockIdx.x == 0 && threadIdx.x == 0) ? a.trace + ei * nstamp : nullptr;
      if (stamp) *stamp++ = globaltimer_ns();
      xw_partial_phase<kBf>(a, v0, Monitor{});
      grid.sync();
      if (stamp) *stamp++ = globaltimer_ns();
      hidden_reduce_phase(a, a.h0p, a.h0s, inject ? a.u_h0 + ei * bh : nullptr, upd, kDrawH0, 0);
      grid.sync();
      Store* hdst = persistent ? a.chain : a.hbuf;
      for (int t = 0; t < a.k; ++t) {
        const Store* hsrc = t > 0 ? hdst : (persistent ? a.chain : a.h0s);
        if (stamp) *stamp++ = globaltimer_ns();
        visible_phase<kBf>(a, hsrc, (t == 0 && persistent) ? a.h0s : nullptr, t);
        grid.sync();
        if (stamp) *stamp++ = globaltimer_ns();
        xw_partial_phase<kBf>(a, a.vs, Monitor{});
        grid.sync();
        if (stamp) *stamp++ = globaltimer_ns();
        hidden_reduce_phase(a, a.hmean, hdst, inject ? a.u_h + (ei * a.k + t) * bh : nullptr,
                            upd, kDrawH, t);
        grid.sync();
      }
      if (stamp) *stamp++ = globaltimer_ns();
      update_phase<kBf>(a, BatchRows{v0, a.vs, a.h0p, a.hmean, V, a.H}, B, m,
                        Monitor{v0, a.v1mean, a.rowerr, B});
      grid.sync();
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
}

// The launch plan of a run: h W^T passes hold the Gibbs step's rows and,
// under PCD, the data chain's (2B); the update reads B rows, and the old
// velocity when a momentum of the run is not 0.
WidePlan run_plan(int H, int B, int flags, float momentum, float initial_momentum, int limit) {
  const bool vel = momentum != 0.0f || ((flags & kMomentumSchedule) && initial_momentum != 0.0f);
  return wide_plan(H, (flags & kPersistent) ? 2 * B : B, true, B, vel, limit);
}

// Points the scratch fields of `a` into `base` (when not null) and returns
// the floats they take.
long long carve_scratch(Args& a, float* base, int V, int H, int B) {
  const long long bh = static_cast<long long>(B) * H, bv = static_cast<long long>(B) * V;
  const long long ns = (V + kStripRows - 1) / kStripRows;
  long long n = 0;
  auto take = [&](long long count) {
    float* p = base ? base + n : nullptr;
    n += (count + 3) / 4 * 4;  // every buffer 16-byte aligned
    return p;
  };
  a.part = take(ns * bh);
  a.h0p = take(bh);
  a.h0s = reinterpret_cast<Store*>(take(bh));  // samples, in a float-sized slot each
  a.hbuf = reinterpret_cast<Store*>(take(bh));
  a.hmean = take(bh);
  a.vs = take(bv);
  a.v1mean = take(bv);
  a.rowerr = take(B);
  return n;
}

}  // namespace

extern "C" {

// Launches the whole run on `stream`. grid <= 0 picks one block per SM (the
// kernel runs one block an SM). Returns a cudaError_t (0 on success); a
// grid larger than the co-resident block count returns
// cudaErrorCooperativeLaunchTooLarge without launching.
int cd_train_wide_run(const Store* data, const int* order, const float* u_h0, const float* u_h,
                      Store* W, Store* b, Store* c, Store* vW, Store* vb, Store* vc,
                      Store* chain, float* errs, float* scratch, unsigned long long* trace,
                      int V, int H, int B, int nb, int E, int k, int start_epoch,
                      int switch_epoch, int flags, float lr, float momentum,
                      float initial_momentum, float l2, float grad_clip, float sparsity_target,
                      float sparsity_cost, unsigned long long seed, int device, int grid,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int coop = 0, nsm = 0, per_sm = 0, optin = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
      cudaSuccess)
    return err;
  const WidePlan plan = run_plan(H, B, flags, momentum, initial_momentum, optin);
  if (!plan.ok) return cudaErrorInvalidValue;
  const void* fn = (flags & kBf16) ? reinterpret_cast<const void*>(&cd_train_wide_kernel<true>)
                                   : reinterpret_cast<const void*>(&cd_train_wide_kernel<false>);
  if ((err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  plan.smem_bytes)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                           plan.smem_bytes)) != cudaSuccess)
    return err;
  if (grid <= 0) grid = nsm;
  if (grid < 1 || grid > per_sm * nsm) return cudaErrorCooperativeLaunchTooLarge;

  Args a;
  a.data = data; a.order = order; a.u_h0 = u_h0; a.u_h = u_h;
  a.W = W; a.b = b; a.c = c; a.vW = vW; a.vb = vb; a.vc = vc;
  a.chain = chain; a.errs = errs;
  carve_scratch(a, scratch, V, H, B);
  a.trace = trace;
  a.V = V; a.H = H; a.B = B; a.NS = (V + kStripRows - 1) / kStripRows;
  a.nb = nb; a.E = E; a.k = k;
  a.start_epoch = start_epoch; a.switch_epoch = switch_epoch; a.flags = flags;
  a.vis_rows = plan.vis_rows; a.vis_window = plan.vis_window; a.hstride = plan.hstride;
  a.hstaged = plan.hstaged; a.strip_rows = plan.strip_rows; a.wtiles = plan.wtiles;
  a.lr = lr; a.momentum = momentum; a.initial_momentum = initial_momentum;
  a.l2 = l2; a.grad_clip = grad_clip; a.sparsity_target = sparsity_target;
  a.sparsity_cost = sparsity_cost; a.seed = seed;

  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), params, plan.smem_bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The launch plan of a run at `limit` bytes of shared memory a block: out =
// {smem_bytes, vis_rows, vis_window, hstride, hstaged, strip_rows, wtiles,
// ok} (ops/cd_epoch_wide_cuda.py::wide_launch_plan mirrors it).
void cd_train_wide_plan(int H, int B, int flags, float momentum, float initial_momentum,
                        int limit, int* out) {
  const WidePlan p = run_plan(H, B, flags, momentum, initial_momentum, limit);
  const int v[8] = {p.smem_bytes, p.vis_rows, p.vis_window, p.hstride, p.hstaged,
                    p.strip_rows, p.wtiles, p.ok};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}

// Scratch floats the wrapper allocates for one run.
long long cd_train_wide_scratch_floats(int V, int H, int B) {
  Args a;
  return carve_scratch(a, nullptr, V, H, B);
}

const char* cd_train_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
