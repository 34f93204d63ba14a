// The W-blocked kernel's data-parallel mode in two launches per update: a
// step that computes one rank's factors, and an update that every rank runs
// on every rank's gathered factors.
//
// Replaces: mdbn_tpu/ops/cd_epoch_pallas.py::_cd_train_kernel_wb with ndev > 1
// (:1981; the DP refs :2017-2019, the pad-row masks :2081-2085, the ring hop
// :2101-2116, the h-matrix all-gather and gc :2233-2273, the per-chunk SFX
// gather and per-source gradient :2298-2333), which the TPU's data-parallel
// path builds through _cached_dp_train_fn (:2924) for the models that need
// W-chunking. Its remote copies around a ring map to one all-gather between
// the two launches (torch.distributed, ops/cd_grads_wide_cuda.py and
// parallel/dp.py): step kernel, all-gather, update kernel.
//
// What it computes, on the rank's shard of B rows (the first nvalid real, the
// rest pad rows; norm = global batch / ranks):
//   step:   h0p = sigmoid(v0 W + c), h0s = (u_h0 < h0p)
//           h = chain (PCD) or h0s (CD); k mean-field Gibbs steps:
//             vs = round_Store(vm), vm = h W^T + b (Gaussian) or its sigmoid,
//             hmean = sigmoid(vs W + c), h = (u_h < hmean)
//           the rank's slot of the gather buffer (ops/cd_grads_wide_cuda.py::
//           slot_layout): vs [B, V] at Store, the h-matrix [2, B, H] f32 =
//           [h0p m ; -hmean m] (m = 1 on the real rows, 0 on pad rows), and
//           err = the masked monitor sum / norm (mse: / V as well; xent:
//           negated), the reference's ndev/(B V) and ndev/B scaling (:2225);
//           the chain out under PCD. The monitor is cd_train_wide.cu's (the
//           unrounded vm of t = 0; PCD: the reconstruction from h0s).
//   update: over the R = global-batch rows of the gathered slots in rank
//           order (row r of rank d is global row d B + r), with v0 read from
//           the global minibatch (every rank holds the data, so it does not
//           cross the wire):
//           gW = (sum_r v0_r^T h0p_r - vs_r^T hmean_r) / R, gb = sum_r (v0_r -
//           vs_r) / R, gc = sum_r (h0p_r - hmean_r) / R [+ cost (target -
//           sum_r h0p_r / R)]; clip, L2, momentum, rounded once into Store
//           (cd_train_wide.cu's update_phase, the same code); err = the sum of
//           the slots' errs in rank order times 1 / ranks. Pad rows are the
//           last rows of the last ranks, so the first R rows are the real ones.
// Every rank runs the update on the same bytes, so every rank's W, b, c and
// velocities keep the same bits. One rank is the single-device W-blocked
// update: the same phases on the same rows.
//
// Draws: Philox keyed by the wrapper's seed with update counter 0 (the
// data-parallel path derives a seed per step and rank), or injected u_h0
// [B, H], u_h [k, B, H] (ops/cd_step.draw_uniforms).
//
// What bounds it on an H100 at 20000x400 bf16 over 4 ranks (B 5 a rank):
// the step reads W three times (16 MB bf16, which the 50 MB L2 can hold
// after the first pass) and writes 216 KB of factors; the update reads and
// writes W and its velocity once (64 MB, 19 us) and reads every rank's
// factors. Both are far from their bounds at this batch: the step is 3 + 3k
// dependent phases with a grid barrier after each (cd_train_wide.cu's
// products), the update cd_train_wide.cu's update phase.
//
// Design: the step is one cooperative launch (grid barriers between its
// phases); the monitor's row sums ride as extra units of the first Gibbs
// step's x W pass, and block 0 adds them after the last phase. The update is
// an ordinary launch: its W units and its c warps are independent of one
// another. Both run cd_train_wide.cu's phases with their launch setup: one
// 256-thread block an SM, dynamic shared memory sized by wide_plan (the
// update stages every rank's h0p and hmean once where they fit). Nothing is
// atomic and the unit order is fixed, so grids 1, 7, 132 and the default
// give the same bits.

#include "cd_wide_phases.cuh"

namespace {

// One rank's slot of the gather buffer, bytes: vs [B, V] Store, then the
// h-matrix [2, B, H] f32, then err f32 (each part 16-byte aligned).
struct Slot {
  long long vs, h, err, bytes;
};

__host__ __device__ inline long long align16(long long n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline Slot slot_layout(int V, int H, int B) {
  Slot s;
  s.vs = 0;
  s.h = align16(static_cast<long long>(B) * V * sizeof(Store));
  s.err = s.h + align16(2LL * B * H * sizeof(float));
  s.bytes = s.err + 16;
  return s;
}

struct StepArgs {
  const Store* v0;        // [B, V] the shard
  const float* u_h0;      // inject: [B, H]
  const float* u_h;       // inject: [k, B, H]
  const Store* W;         // [V, H]
  const Store* b;         // [V]
  const Store* c;         // [H]
  const Store* chain_in;  // [B, H]
  Store* chain;           // [B, H] the chain out (PCD)
  Store* vs;              // [B, V] the slot's negative-phase visibles
  float* hmat;            // [2, B, H] the slot's h-matrix
  float* err;             // [1] the slot's monitor
  float* part;            // scratch [NS, B, H] one x W product's partial sums per strip
  float* h0p;             // scratch [B, H]
  Store* h0s;             // scratch [B, H] samples of h0p
  Store* hbuf;            // scratch [B, H] CD chain sample
  float* hmean;           // scratch [B, H]
  float* v1mean;          // scratch [B, V] the monitor's reconstruction (unrounded)
  float* rowerr;          // scratch [B]
  int V, H, B, NS, k, flags, nvalid;
  int vis_rows, vis_window, hstride;  // the WidePlan
  float inv_norm;
  unsigned long long seed;
};

template <bool kBf>
__global__ void __launch_bounds__(kThreads, 1)
    cd_wide_step_kernel(const __grid_constant__ StepArgs a) {
  cg::grid_group grid = cg::this_grid();
  const bool inject = a.flags & kInject;
  const bool persistent = a.flags & kPersistent;
  const size_t bh = static_cast<size_t>(a.B) * a.H;
  xw_partial_phase<kBf>(a, a.v0, Monitor{});
  grid.sync();
  hidden_reduce_phase(a, a.h0p, a.h0s, inject ? a.u_h0 : nullptr, 0u, kDrawH0, 0, a.hmat,
                      1.0f, a.nvalid);
  grid.sync();
  Store* hdst = persistent ? a.chain : a.hbuf;
  for (int t = 0; t < a.k; ++t) {
    const Store* hsrc = t > 0 ? hdst : (persistent ? a.chain_in : a.h0s);
    visible_phase<kBf>(a, hsrc, (t == 0 && persistent) ? a.h0s : nullptr, t);
    grid.sync();
    xw_partial_phase<kBf>(a, a.vs,
                          t == 0 ? Monitor{a.v0, a.v1mean, a.rowerr, a.B} : Monitor{});
    grid.sync();
    const bool last = t == a.k - 1;
    hidden_reduce_phase(a, a.hmean, hdst, inject ? a.u_h + t * bh : nullptr, 0u, kDrawH, t,
                        last ? a.hmat + bh : nullptr, -1.0f, a.nvalid);
    if (!last) grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {  // rowerr is complete since t = 0's x W pass
    float tot = 0.0f;
    for (int r = threadIdx.x; r < a.nvalid; r += 32) tot += a.rowerr[r];
    tot = warp_sum(tot);
    if (threadIdx.x == 0)
      *a.err = (a.flags & kXent) ? -tot * a.inv_norm
                                 : tot * a.inv_norm * (1.0f / static_cast<float>(a.V));
  }
}

// Every rank's rows of the gather buffer, in rank order: row r is row
// r % lb of rank r / lb; v0 comes from the global minibatch. The accessors
// are BatchRows' (cd_wide_phases.cuh).
struct GatheredRows {
  static constexpr bool kContiguousH = false;
  const Store* x0;           // [>= R, V] the global minibatch
  const unsigned char* buf;  // [ndev, slot.bytes]
  Slot slot;
  int lb, V, H;
  __device__ __forceinline__ const unsigned char* at(int r, int& rr) const {
    const int d = r / lb;
    rr = r - d * lb;
    return buf + d * slot.bytes;
  }
  __device__ __forceinline__ unsigned v0_bits(int r, int q) const {
    return raw_bits(x0 + static_cast<size_t>(r) * V + q);
  }
  __device__ __forceinline__ unsigned vs_bits(int r, int q) const {
    int rr;
    const Store* x = reinterpret_cast<const Store*>(at(r, rr) + slot.vs);
    return raw_bits(x + static_cast<size_t>(rr) * V + q);
  }
  __device__ __forceinline__ float v0_of(unsigned x) const { return from_raw<Store>(x); }
  __device__ __forceinline__ float vs_of(unsigned x) const { return from_raw<Store>(x); }
  __device__ __forceinline__ float hp(int r, int j) const {
    int rr;
    return reinterpret_cast<const float*>(at(r, rr) + slot.h)[rr * H + j];
  }
  __device__ __forceinline__ float hm(int r, int j) const {
    int rr;
    return -reinterpret_cast<const float*>(at(r, rr) + slot.h)[(lb + rr) * H + j];
  }
};

struct UpdateArgs {
  Store* W;      // [V, H], in place
  Store* b;      // [V]
  Store* c;      // [H]
  Store* vW;     // velocities, in place
  Store* vb;
  Store* vc;
  float* err;    // [1]: the update's mean monitor
  int V, H, R, ndev, flags;
  int hstaged, strip_rows, wtiles;  // the WidePlan
  float lr, m, scale, l2, grad_clip, sparsity_target, sparsity_cost;
};

template <bool kBf>
__global__ void __launch_bounds__(kThreads, 1)
    cd_wide_update_kernel(const __grid_constant__ UpdateArgs a,
                          const __grid_constant__ GatheredRows rows) {
  update_phase<kBf>(a, rows, a.R, a.m, Monitor{});
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float tot = 0.0f;
    for (int d = 0; d < a.ndev; ++d)
      tot += *reinterpret_cast<const float*>(rows.buf + d * rows.slot.bytes + rows.slot.err);
    *a.err = tot * a.scale;
  }
}

// Points the step's scratch fields into `base` (when not null) and returns
// the floats they take.
long long carve_scratch(StepArgs& a, float* base, int V, int H, int B) {
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
  a.v1mean = take(bv);
  a.rowerr = take(B);
  return n;
}

const void* step_variant(bool bf) {
  return bf ? reinterpret_cast<const void*>(&cd_wide_step_kernel<true>)
            : reinterpret_cast<const void*>(&cd_wide_step_kernel<false>);
}

const void* update_variant(bool bf) {
  return bf ? reinterpret_cast<const void*>(&cd_wide_update_kernel<true>)
            : reinterpret_cast<const void*>(&cd_wide_update_kernel<false>);
}

// The SM count of `device` and its opt-in shared memory a block, asked once
// per device.
cudaError_t device_info(int device, int* nsm, int* optin) {
  static int cached_nsm[64] = {0}, cached_optin[64] = {0};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (cached_nsm[device] == 0) {
    int coop = 0, n = 0, o = 0;
    if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) !=
        cudaSuccess)
      return err;
    if (!coop) return cudaErrorNotSupported;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&o, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
        cudaSuccess)
      return err;
    cached_optin[device] = o;
    cached_nsm[device] = n;
  }
  *nsm = cached_nsm[device];
  *optin = cached_optin[device];
  return cudaSuccess;
}

// Sets `fn`'s dynamic shared memory to `bytes` and gives its co-resident
// blocks per SM.
cudaError_t prepare(const void* fn, int bytes, int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kThreads, bytes);
}

}  // namespace

extern "C" {

// Launches one step on `stream`, writing the rank's slot (`slot`, bytes of
// cd_wide_slot_bytes(V, H, B)) and, under PCD, chain_out. grid <= 0 picks
// one block per SM. Returns a cudaError_t (0 on success); a grid larger than
// the co-resident block count returns cudaErrorCooperativeLaunchTooLarge
// without launching.
int cd_wide_step(const Store* v0, const float* u_h0, const float* u_h, const Store* W,
                 const Store* b, const Store* c, const Store* chain_in, Store* chain_out,
                 unsigned char* slot, float* scratch, int V, int H, int B, int k, int flags,
                 int nvalid, float inv_norm, unsigned long long seed, int device, int grid,
                 void* stream) {
  int nsm = 0, optin = 0, co = 0;
  cudaError_t err = device_info(device, &nsm, &optin);
  if (err != cudaSuccess) return err;
  const WidePlan plan = wide_plan(H, (flags & kPersistent) ? 2 * B : B, true, 0, false, optin);
  if (!plan.ok) return cudaErrorInvalidValue;
  const bool bf = flags & kBf16;
  if ((err = prepare(step_variant(bf), plan.smem_bytes, &co)) != cudaSuccess) return err;
  if (grid <= 0) grid = nsm;
  if (grid < 1 || grid > co * nsm) return cudaErrorCooperativeLaunchTooLarge;

  const Slot sl = slot_layout(V, H, B);
  StepArgs a;
  a.v0 = v0; a.u_h0 = u_h0; a.u_h = u_h; a.W = W; a.b = b; a.c = c;
  a.chain_in = chain_in; a.chain = chain_out;
  a.vs = reinterpret_cast<Store*>(slot + sl.vs);
  a.hmat = reinterpret_cast<float*>(slot + sl.h);
  a.err = reinterpret_cast<float*>(slot + sl.err);
  carve_scratch(a, scratch, V, H, B);
  a.V = V; a.H = H; a.B = B; a.NS = (V + kStripRows - 1) / kStripRows; a.k = k;
  a.flags = flags; a.nvalid = nvalid; a.inv_norm = inv_norm; a.seed = seed;
  a.vis_rows = plan.vis_rows; a.vis_window = plan.vis_window; a.hstride = plan.hstride;

  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(step_variant(bf), dim3(grid), dim3(kThreads), params,
                                    plan.smem_bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launches the update on `stream` over the gathered slots of ndev ranks of
// lb rows each (`gathered`, ndev * cd_wide_slot_bytes(V, H, lb) bytes), the
// first R rows in rank order, with v0 [R, V] the global minibatch: W, b, c
// and their velocities change in place, err [1] gets the update's monitor.
// grid <= 0 picks one block per SM. Returns a cudaError_t (0 on success).
int cd_wide_update(const Store* v0, const unsigned char* gathered, Store* W, Store* b, Store* c,
                   Store* vW, Store* vb, Store* vc, float* err, int V, int H, int R, int lb,
                   int ndev, int flags, float scale, float lr, float m, float l2,
                   float grad_clip, float sparsity_target, float sparsity_cost, int device,
                   int grid, void* stream) {
  int nsm = 0, optin = 0, co = 0;
  cudaError_t e = device_info(device, &nsm, &optin);
  if (e != cudaSuccess) return e;
  const WidePlan plan = wide_plan(H, 0, false, R, m != 0.0f, optin);
  if (!plan.ok) return cudaErrorInvalidValue;
  const bool bf = flags & kBf16;
  if ((e = prepare(update_variant(bf), plan.smem_bytes, &co)) != cudaSuccess) return e;
  if (grid <= 0) grid = nsm;
  UpdateArgs a;
  a.W = W; a.b = b; a.c = c; a.vW = vW; a.vb = vb; a.vc = vc; a.err = err;
  a.V = V; a.H = H; a.R = R; a.ndev = ndev; a.flags = flags;
  a.lr = lr; a.m = m; a.scale = scale; a.l2 = l2; a.grad_clip = grad_clip;
  a.sparsity_target = sparsity_target; a.sparsity_cost = sparsity_cost;
  a.hstaged = plan.hstaged; a.strip_rows = plan.strip_rows; a.wtiles = plan.wtiles;
  GatheredRows rows;
  rows.x0 = v0; rows.buf = gathered; rows.slot = slot_layout(V, H, lb);
  rows.lb = lb; rows.V = V; rows.H = H;
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  if (bf)
    cd_wide_update_kernel<true><<<grid, kThreads, plan.smem_bytes, st_>>>(a, rows);
  else
    cd_wide_update_kernel<false><<<grid, kThreads, plan.smem_bytes, st_>>>(a, rows);
  return cudaGetLastError();
}

// Bytes of one rank's slot of B rows (ops/cd_grads_wide_cuda.py::wide_factor_size).
long long cd_wide_slot_bytes(int V, int H, int B) { return slot_layout(V, H, B).bytes; }

// Scratch floats the wrapper allocates for one step.
long long cd_wide_scratch_floats(int V, int H, int B) {
  StepArgs a;
  return carve_scratch(a, nullptr, V, H, B);
}

const char* cd_grads_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
