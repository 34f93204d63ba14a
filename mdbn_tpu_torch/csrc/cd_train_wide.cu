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
// What bounds it on an H100 at the widest shapes: W does not stay in the 50 MB
// L2 (44.8 MB f32 at 28000x400 beside its velocity's writes, 80 MB bf16 at
// 40000x1000), so one CD-1 update streams W from device memory for each of
// its three products and reads and writes it once in the update: five passes,
// 224 MB or 67 us at 28000x400, 400 MB or 119 us at 40000x1000, beside 2.2
// and 8 GFLOP (33 and 119 us at the f32 peak). Both bounds are of the same
// size, and cd_train.cu's hidden phase cannot approach either here: it walks
// all of V in one block and re-reads W per 4-row tile. Splitting the products
// over V pays from about 4000 columns on, whether W fits the L2 or not
// (scripts/torch_wide_crossover.py; ops.cd_epoch_cuda.WIDE_MIN_VISIBLE).
//
// Design: one persistent cooperative launch per run, grid barriers between
// the phases of an update, as cd_train.cu. The phases are in
// cd_wide_phases.cuh, shared with the data-parallel step and update
// (cd_grads_wide.cu).
// - x W (x = v0 or vs): W's rows are cut into strips of kStripRows. A unit
//   (one block) is one strip x 32 hidden columns (lane = column). Each warp
//   loads kRowsPerWarp elements of its column into registers, 16 loads in
//   flight, so every W element is read once from device memory; the batch
//   rows of x for the strip are staged in shared memory and each warp adds
//   its products into per-row sums in shared memory. The unit writes its
//   [B, 32] partial sums; after a barrier the reduce phase adds the strips'
//   partials in strip order, adds c, takes the sigmoid and samples. The
//   strip size is fixed, not derived from the grid, and nothing is atomic:
//   grids 1, 7, 132 and the default give identical bits (the tests' grids).
// - h W^T: a unit is 32 rows of W (4 per warp); the row tiles of h loop
//   inside the unit, so a W row comes from device memory once and from L1
//   for the later row tiles. No reduction across blocks. Under PCD the
//   data chain's reconstruction (the monitor) rides in the same unit.
// - gradient and update: a unit is 16 rows of W x 256 columns (thread =
//   column); the strip's v0 and vs columns are staged in shared memory; gb
//   and b come from the same staged columns. W, vW are read and written
//   once, a thread's 16 loads of each started together (apply_column).
// In-place hazard: the update phase changes W and the next update's v0 W
// reads it, so a barrier separates them. Later: fuse a strip's update with
// the next update's v0 W partial over the same strip (one pass over W less),
// wgmma products, TMA prefetch.

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
  float lr, momentum, initial_momentum, l2, grad_clip, sparsity_target, sparsity_cost;
  unsigned long long seed;
};

template <bool kBf>
__global__ void __launch_bounds__(kThreads, 2) cd_train_wide_kernel(Args a) {
  __shared__ __align__(16) float smem[kSmemFloats];  // 36 KB
  cg::grid_group grid = cg::this_grid();
  const Split s;
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
      xw_partial_phase<kBf>(a, smem, v0);
      grid.sync();
      if (stamp) *stamp++ = globaltimer_ns();
      hidden_reduce_phase(a, a.h0p, a.h0s, inject ? a.u_h0 + ei * bh : nullptr, upd, kDrawH0, 0);
      grid.sync();
      Store* hdst = persistent ? a.chain : a.hbuf;
      for (int t = 0; t < a.k; ++t) {
        const Store* hsrc = t > 0 ? hdst : (persistent ? a.chain : a.h0s);
        if (stamp) *stamp++ = globaltimer_ns();
        visible_phase<kBf>(a, smem, hsrc, (t == 0 && persistent) ? a.h0s : nullptr, t);
        grid.sync();
        if (stamp) *stamp++ = globaltimer_ns();
        xw_partial_phase<kBf>(a, smem, a.vs);
        grid.sync();
        if (stamp) *stamp++ = globaltimer_ns();
        hidden_reduce_phase(a, a.hmean, hdst, inject ? a.u_h + (ei * a.k + t) * bh : nullptr,
                            upd, kDrawH, t);
        grid.sync();
      }
      if (stamp) *stamp++ = globaltimer_ns();
      update_phase<kBf>(a, smem, s, BatchRows{v0, a.vs, a.h0p, a.hmean, V, a.H}, B, m,
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

// Launches the whole run on `stream`. grid <= 0 picks every co-resident
// block (at most two per SM). Returns a cudaError_t (0 on success); a grid
// larger than the co-resident block count returns
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
  int coop = 0, nsm = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const void* fn = (flags & kBf16) ? reinterpret_cast<const void*>(&cd_train_wide_kernel<true>)
                                   : reinterpret_cast<const void*>(&cd_train_wide_kernel<false>);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0)) !=
      cudaSuccess)
    return err;
  if (grid <= 0) grid = nsm * (per_sm < 2 ? per_sm : 2);
  if (grid > per_sm * nsm) return cudaErrorCooperativeLaunchTooLarge;

  Args a;
  a.data = data; a.order = order; a.u_h0 = u_h0; a.u_h = u_h;
  a.W = W; a.b = b; a.c = c; a.vW = vW; a.vb = vb; a.vc = vc;
  a.chain = chain; a.errs = errs;
  carve_scratch(a, scratch, V, H, B);
  a.trace = trace;
  a.V = V; a.H = H; a.B = B; a.NS = (V + kStripRows - 1) / kStripRows;
  a.nb = nb; a.E = E; a.k = k;
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
long long cd_train_wide_scratch_floats(int V, int H, int B) {
  Args a;
  return carve_scratch(a, nullptr, V, H, B);
}

const char* cd_train_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
