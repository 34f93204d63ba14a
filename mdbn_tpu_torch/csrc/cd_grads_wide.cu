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
//           cross the wire): gW = (sum_r v0_r^T h0p_r - vs_r^T hmean_r) / R,
//           gb = sum_r (v0_r - vs_r) / R, gc = sum_r (h0p_r - hmean_r) / R [+
//           cost (target - sum_r h0p_r / R)]; clip, L2, momentum, rounded once
//           into Store; err = the sum of the slots' errs in rank order times
//           1 / ranks. Pad rows are the last rows of the last ranks, so the
//           first R rows are the real ones.
// Every rank runs the update on the same bytes, so every rank's W, b, c and
// velocities keep the same bits.
//
// Draws: Philox keyed by the wrapper's seed with update counter 0 (the
// data-parallel path derives a seed per step and rank), or injected u_h0
// [B, H], u_h [k, B, H] (ops/cd_step.draw_uniforms). A captured epoch
// (parallel/dp.py::EpochSteps) hands the step `tab`, a device row of
// {minibatch, seed, .}: it reads its minibatch of the minibatches it is
// given and its seed there; the update reads its minibatch from the same
// row and its momentum from device memory.
//
// What bounds it on an H100 at 20000x400 bf16 over 4 ranks (B 5 a rank):
// the step reads W three times (16 MB bf16, which the 50 MB L2 can hold
// after the first pass) and writes 216 KB of factors; the update reads and
// writes W and its velocity once (64 MB, 19 us) and reads every rank's
// factors. The step is 3 + 3k dependent phases with a grid barrier after
// each (cd_train_wide.cu's products); the update streams W near the memory
// rate (csrc/cd_wide_update.cuh).
//
// Design: the step is one cooperative launch (grid barriers between its
// phases); the monitor's row sums ride as extra units of the first Gibbs
// step's x W pass, and block 0 adds them after the last phase. It runs
// cd_train_wide.cu's phases with their launch setup: one 256-thread block an
// SM, dynamic shared memory sized by wide_plan. The update is an ordinary
// launch of its own design (csrc/cd_wide_update.cuh: a ring of W tiles by
// cp.async, gW on mma.sync at bf16 compute, the update on the sums in
// registers). Nothing is atomic and every sum's order is fixed, so grids 1,
// 7, 132 and the default give the same bits.

#include "cd_wide_phases.cuh"
#include "cd_wide_update.cuh"

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
  const Store* v0;        // [B, V] the shard (with tab: the shards [*, B, V] it indexes)
  const long long* tab;   // optional [3]: the step's minibatch and seed
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

// What hidden_reduce_phase reads of its arguments: a captured step hands it
// these, its seed from the table, so that the other phases read the kernel's
// parameter itself (a patched copy of it in local memory slowed the step).
struct ReduceArgs {
  int B, H, NS;
  float* part;
  const Store* c;
  unsigned long long seed;
};

// The step's phases on v0, the hidden phases reading their arguments from ra
// (a: the step's arguments, or ReduceArgs).
template <bool kBf, class RA>
__device__ __forceinline__ void step_phases(const StepArgs& a, const Store* v0, const RA& ra) {
  cg::grid_group grid = cg::this_grid();
  const bool inject = a.flags & kInject;
  const bool persistent = a.flags & kPersistent;
  const size_t bh = static_cast<size_t>(a.B) * a.H;
  xw_partial_phase<kBf>(a, v0, Monitor{});
  grid.sync();
  hidden_reduce_phase(ra, a.h0p, a.h0s, inject ? a.u_h0 : nullptr, 0u, kDrawH0, 0, a.hmat,
                      1.0f, a.nvalid);
  grid.sync();
  Store* hdst = persistent ? a.chain : a.hbuf;
  for (int t = 0; t < a.k; ++t) {
    const Store* hsrc = t > 0 ? hdst : (persistent ? a.chain_in : a.h0s);
    visible_phase<kBf>(a, hsrc, (t == 0 && persistent) ? a.h0s : nullptr, t);
    grid.sync();
    xw_partial_phase<kBf>(a, a.vs, t == 0 ? Monitor{v0, a.v1mean, a.rowerr, a.B} : Monitor{});
    grid.sync();
    const bool last = t == a.k - 1;
    hidden_reduce_phase(ra, a.hmean, hdst, inject ? a.u_h + t * bh : nullptr, 0u, kDrawH, t,
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

// kTab: a captured step, its minibatch and seed from the table row a.tab
// (a kernel of its own, so the other one keeps the code it had without it).
template <bool kBf, bool kTab>
__global__ void __launch_bounds__(kThreads, 1)
    cd_wide_step_kernel(const __grid_constant__ StepArgs a) {
  if constexpr (kTab) {
    const ReduceArgs ra{a.B, a.H, a.NS, a.part, a.c, static_cast<unsigned long long>(a.tab[1])};
    step_phases<kBf>(a, a.v0 + a.tab[0] * a.B * a.V, ra);
  } else {
    step_phases<kBf>(a, a.v0, a);
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


// The kernels' variants: (bf16 compute) + 2 (table) the step; 4 + (bf16
// compute) * 2 + (momentum) the update.
constexpr int kVariants = 8;

const void* variant_fn(int v) {
  switch (v) {
    case 0: return reinterpret_cast<const void*>(&cd_wide_step_kernel<false, false>);
    case 1: return reinterpret_cast<const void*>(&cd_wide_step_kernel<true, false>);
    case 2: return reinterpret_cast<const void*>(&cd_wide_step_kernel<false, true>);
    case 3: return reinterpret_cast<const void*>(&cd_wide_step_kernel<true, true>);
    case 4: return reinterpret_cast<const void*>(&cd_wide_update_kernel<false, false>);
    case 5: return reinterpret_cast<const void*>(&cd_wide_update_kernel<false, true>);
    case 6: return reinterpret_cast<const void*>(&cd_wide_update_kernel<true, false>);
    default: return reinterpret_cast<const void*>(&cd_wide_update_kernel<true, true>);
  }
}

int step_variant(int flags, bool tab) { return ((flags & kBf16) ? 1 : 0) + (tab ? 2 : 0); }
int update_variant(int flags, bool vel) { return 4 + ((flags & kBf16) ? 2 : 0) + (vel ? 1 : 0); }

// The SM count and opt-in shared memory a block of each device, and each
// variant's dynamic shared memory as last set with its co-resident blocks per
// SM there: asked once per device and size, ahead of a launch captured in a
// CUDA graph, which must ask nothing (cd_wide_prepare).
constexpr int kMaxDevices = 64;
int g_nsm[kMaxDevices], g_optin[kMaxDevices], g_per_sm[kMaxDevices];
int g_bytes[kMaxDevices][kVariants], g_co[kMaxDevices][kVariants];

cudaError_t device_info(int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || g_nsm[device] != 0) return err;
  int coop = 0, n = 0, o = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&o, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&g_per_sm[device], cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                    device)) != cudaSuccess)
    return err;
  g_optin[device] = o;
  g_nsm[device] = n;
  return cudaSuccess;
}

// Sets variant v's dynamic shared memory to `bytes` where it was last set to
// another size, and gives its co-resident blocks per SM.
cudaError_t prepare_variant(int device, int v, int bytes, int* co) {
  if (g_bytes[device][v] != bytes) {
    const void* fn = variant_fn(v);
    cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&g_co[device][v], fn, kThreads, bytes);
    if (err != cudaSuccess) return err;
    g_bytes[device][v] = bytes;
  }
  *co = g_co[device][v];
  return cudaSuccess;
}

bool on16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

WidePlan step_plan(int H, int B, int flags, int optin) {
  return wide_plan(H, (flags & kPersistent) ? 2 * B : B, true, 0, false, optin);
}

// The update's plan: its pointers aligned as the ring's copies need them.
UpdatePlan plan_for(int V, int H, int R, int flags, bool vel, bool aligned, int optin,
                    int per_sm) {
  return update_plan(V, H, R, flags & kBf16, vel, aligned, optin, per_sm);
}

}  // namespace

extern "C" {

// Launches one step on `stream`, writing the rank's slot (`slot`, bytes of
// cd_wide_slot_bytes(V, H, B)) and, under PCD, chain_out. With `tab` (a
// device row {minibatch, seed, .}) v0 holds the shards [*, B, V] it indexes
// and the seed is read there. grid <= 0 picks one block per SM. Returns a
// cudaError_t (0 on success); a grid larger than the co-resident block count
// returns cudaErrorCooperativeLaunchTooLarge without launching.
int cd_wide_step(const Store* v0, const long long* tab, const float* u_h0, const float* u_h,
                 const Store* W, const Store* b, const Store* c, const Store* chain_in,
                 Store* chain_out, unsigned char* slot, float* scratch, int V, int H, int B, int k,
                 int flags, int nvalid, float inv_norm, unsigned long long seed, int device,
                 int grid, void* stream) {
  int co = 0;
  cudaError_t err = device_info(device);
  if (err != cudaSuccess) return err;
  const WidePlan plan = step_plan(H, B, flags, g_optin[device]);
  if (!plan.ok) return cudaErrorInvalidValue;
  const int v = step_variant(flags, tab);
  if ((err = prepare_variant(device, v, plan.smem_bytes, &co)) != cudaSuccess) return err;
  const int nsm = g_nsm[device];
  if (grid <= 0) grid = nsm;
  if (grid < 1 || grid > co * nsm) return cudaErrorCooperativeLaunchTooLarge;

  const Slot sl = slot_layout(V, H, B);
  StepArgs a;
  a.v0 = v0; a.tab = tab; a.u_h0 = u_h0; a.u_h = u_h; a.W = W; a.b = b; a.c = c;
  a.chain_in = chain_in; a.chain = chain_out;
  a.vs = reinterpret_cast<Store*>(slot + sl.vs);
  a.hmat = reinterpret_cast<float*>(slot + sl.h);
  a.err = reinterpret_cast<float*>(slot + sl.err);
  carve_scratch(a, scratch, V, H, B);
  a.V = V; a.H = H; a.B = B; a.NS = (V + kStripRows - 1) / kStripRows; a.k = k;
  a.flags = flags; a.nvalid = nvalid; a.inv_norm = inv_norm; a.seed = seed;
  a.vis_rows = plan.vis_rows; a.vis_window = plan.vis_window; a.hstride = plan.hstride;

  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(variant_fn(v), dim3(grid), dim3(kThreads), params,
                                    plan.smem_bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launches the update on `stream` over the gathered slots of ndev ranks of
// lb rows each (`gathered`, ndev * cd_wide_slot_bytes(V, H, lb) bytes), the
// first R rows in rank order, with v0 [R, V] the global minibatch (with
// `tab`: v0 + tab[0] * v0_stride): W, b, c and their velocities change in
// place, err [1] gets the update's monitor. `mom`: the momentum in device
// memory, or null to take m; vel: the variant that reads the old velocity
// (momentum anywhere in the run: at m = 0 it gives the other's values).
// `trace`: null or the kernel's 8 stamps. grid <= 0 picks one block per SM
// (two of 128 threads where the plan takes them).
// Returns a cudaError_t (0 on success).
int cd_wide_update(const Store* v0, const long long* tab, long long v0_stride,
                   const unsigned char* gathered, Store* W, Store* b, Store* c, Store* vW,
                   Store* vb, Store* vc, float* err, const float* mom,
                   unsigned long long* trace, int V, int H, int R, int lb, int ndev, int flags,
                   int vel, float scale, float lr, float m, float l2, float grad_clip,
                   float sparsity_target, float sparsity_cost, int device, int grid,
                   void* stream) {
  int co = 0;
  cudaError_t e = device_info(device);
  if (e != cudaSuccess) return e;
  const bool aligned = on16(v0) && on16(gathered) && on16(W) && on16(vW) &&
                       (v0_stride * static_cast<long long>(sizeof(Store))) % 16 == 0;
  const UpdatePlan plan =
      plan_for(V, H, R, flags, vel, aligned, g_optin[device], g_per_sm[device]);
  if (!plan.ok) return cudaErrorInvalidValue;
  const int v = update_variant(flags, vel);
  if ((e = prepare_variant(device, v, plan.smem_bytes, &co)) != cudaSuccess) return e;
  if (grid <= 0) grid = g_nsm[device] * (kThreads / plan.threads);
  UpdateArgs a;
  a.W = W; a.b = b; a.c = c; a.vW = vW; a.vb = vb; a.vc = vc; a.err = err;
  a.v0 = v0; a.tab = tab; a.v0_stride = v0_stride; a.mom = mom; a.trace = trace;
  a.V = V; a.H = H; a.R = R; a.ndev = ndev; a.flags = flags; a.plan = plan;
  a.lr = lr; a.m = m; a.scale = scale; a.l2 = l2; a.grad_clip = grad_clip;
  a.sparsity_target = sparsity_target; a.sparsity_cost = sparsity_cost;
  const Slot sl = slot_layout(V, H, lb);
  Gathered g;
  g.buf = gathered; g.slot_bytes = sl.bytes; g.vs = sl.vs; g.h = sl.h; g.err = sl.err;
  g.lb = lb;
  void* params[] = {&a, &g};
  e = cudaLaunchKernel(variant_fn(v), dim3(grid), dim3(plan.threads), params, plan.smem_bytes,
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Sets up the step's and the update's launches of a run ahead of them (a
// launch captured in a CUDA graph must ask the device nothing): B the rank's
// rows, R the global batch. Returns a cudaError_t.
int cd_wide_prepare(int V, int H, int B, int R, int flags, int vel, int device) {
  int co = 0;
  cudaError_t e = device_info(device);
  if (e != cudaSuccess) return e;
  const WidePlan sp = step_plan(H, B, flags, g_optin[device]);
  const UpdatePlan up = plan_for(V, H, R, flags, vel, true, g_optin[device], g_per_sm[device]);
  if (!sp.ok || !up.ok) return cudaErrorInvalidValue;
  for (int tab = 0; tab < 2; ++tab)
    if ((e = prepare_variant(device, step_variant(flags, tab), sp.smem_bytes, &co)) != cudaSuccess)
      return e;
  return prepare_variant(device, update_variant(flags, vel), up.smem_bytes, &co);
}

// The update's plan (ops/cd_grads_wide_cuda.py::update_plan): out[7] =
// threads, stages, resident, kp, kc, smem_bytes, ok.
void cd_wide_update_plan(int V, int H, int R, int flags, int vel, int aligned, int limit,
                         int per_sm, int* out) {
  const UpdatePlan p = plan_for(V, H, R, flags, vel, aligned, limit, per_sm);
  const int v[7] = {p.threads, p.stages, p.resident, p.kp, p.kc, p.smem_bytes, p.ok};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
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
