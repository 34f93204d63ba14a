// Fused multi-epoch CD-k / PCD training run of one RBM in ONE launch, with W
// and its velocity resident in shared memory for the whole run.
//
// Replaces: mdbn_tpu/ops/cd_epoch_pallas.py::_cd_train_kernel (:692) in its
// single-device mode, the kernel every layer of the graded configs trains
// through on the TPU, with its estimator modes: parallel tempering
// (:995-1113), the enhanced gradient (:1568-1586), learned variance
// (:980-989, :1589-1596) and the pseudo-likelihood monitor (:654,
// :1604-1610). It computes what csrc/cd_train.cu computes: per update
//   v0 = data rows [order[e,i]*B, +B); h0p = sigmoid(v0 W + c), h0s = (u < h0p)
//   k Gibbs steps from the chain (PCD) or h0s (CD): vmean = sigmoid(h W^T + b)
//   (Bernoulli) or h W^T + b (Gaussian), vs sampled or mean-field, hmean =
//   sigmoid(vs W + c), h = (u < hmean)
//   gW = (v0^T h0p - vs^T hmean)/B, gb, gc (+ sparsity), clip, L2 on W,
//   vel = m vel + lr g, param += vel; the mse or xent monitor against the t=0
//   visible mean (PCD: against the reconstruction from h0s)
// with f32 or bf16 storage (Store, cd_common.cuh), f32 or bf16 compute, the
// momentum schedule, inject mode and the optional trace. The estimator modes
// are a variant of their own (kModes, device code in cd_resident_modes.cuh);
// the plain variant (kModes = 0) compiles without them.
//
// What bounds it on an H100: at c1 (784x500, batch 20) an update is four
// products of 7.84 M FMA, about 1 us of FP32 FMA over 132 SMs, and nothing
// needs to leave the chip between updates. cd_train.cu streams W from L2 in
// every phase and ends each of its 2 + 2k phases in a grid barrier; half of
// its c1 update is barrier and fixed latency. So this kernel is built around
// the number of device-wide synchronisations and keeps the state on chip.
//
// Design: one persistent cooperative launch of G clusters x C blocks (thread
// block clusters: cudaLaunchKernelEx with a cluster dimension and the
// cooperative attribute), one block of 512 threads per SM. The tiling depends
// on (V, H) alone (tiling()): W is cut into S <= 15 strips of tv rows (an
// H100 holds 15 clusters of 7 or 8 blocks at once) and C <= 8 column tiles
// of th columns (th a multiple of 32). Block j of cluster g owns column tile
// j of strips g, g + G, ...: it keeps those tiles of W and vW, their b and vb,
// and c and vc of tile j in shared memory from the first update to the last,
// reading each from device memory once at the start and writing it once at
// the end. c is kept, identically, in every cluster.
// - Hidden phase (x W + c): each block forms its strips' partial products
//   x[:, strip] W[strip, tile] and writes them to a device buffer
//   (double-buffered by the phase's parity); the G blocks that share column
//   tile j meet at a release/acquire flag barrier; each sums the strips'
//   partials in strip order 0..S-1, applies the sigmoid and draws, so every
//   cluster ends with the same h[:, tile j]. That barrier is the only
//   device-wide synchronisation: k + 1 per CD-k update (cd_train.cu: 2 + 2k
//   grid barriers).
// - Visible phase (h W^T + b): each block forms its partial h[:, tile j]
//   W[strip, tile j]^T in its own shared memory (double-buffered by parity);
//   after cluster.sync() every block of the cluster sums the C partials in
//   rank order over distributed shared memory, adds b and draws, so each
//   holds the same vs[:, strip]. No device-wide barrier.
// - Update: gW[strip, tile] = (v0^T h0p - vs^T hmean)/B needs only what the
//   block holds; clipping is elementwise and the sparsity term per column.
//   b and c are updated redundantly, identically, in every block that holds
//   them. The monitor's strip sums go to a device buffer (by update parity)
//   that block (0, 0) adds up in strip order after the next barrier.
// - Overlap: the next minibatch's rows (order is known up front) are copied
//   into shared memory with cp.async while the current update runs.
// - The products: a thread holds 4 batch rows and reads 4 consecutive
//   elements of W or of the rows at once (16-byte shared loads; a W row is
//   padded by 4 elements so that a column of 8 lanes' rows falls in distinct
//   banks). Where one pass leaves SM lanes idle, the summed dimension is cut
//   into a few fixed chunks whose sums are added in chunk order.
// Every sum runs in an order the tiling fixes, with no atomics (the barrier
// counters are the only atomics); draws are Philox keyed by (update, kind,
// row, column) as in cd_common.cuh. So the bits do not depend on G, the
// number of clusters, and one seed draws what cd_train.cu draws. A cluster
// count whose strips do not fit a block's shared memory is refused before
// launch.
//
// Arithmetic: with f32 compute every product is an fp32 FMA with fp32
// accumulation (no TF32, which keeps 10 mantissa bits): at about 1 us of FMA
// per c1 update the tensor cores are not what bounds this kernel. With bf16
// compute the operands are rounded with __float2bfloat16 and accumulated in
// fp32, as in cd_train.cu. The update of an element repeats cd_train.cu's
// arithmetic (rows summed in order, apply_loaded).
//
// The estimator modes (kModes; cd_train.cu's header says what each computes)
// keep the design's rules: every sum in an order the tiling fixes, no atomics
// but the barrier counters, bits independent of G. A tempering ladder's
// exchanges raise the registers every phase needs, so the modes compile into
// two variants, without a ladder (kModes = 1) and with one (2).
// - Tempering (M rungs, CR = M*B chain rows, rung-major): the chain, hmean,
//   vs and the draws hold CR rows, and its products run on all of them in one
//   pass, unchunked (the rows fill the warps). Its sums would have every block
//   read every row's partials (distributed shared memory after a visible
//   phase, device memory after a hidden one), which bounds them, so they are
//   split: after a visible phase's cluster barrier rank c sums and samples
//   rows r = c mod C, then one more cluster barrier and each rank copies the
//   other ranks' rows; after a hidden phase's tile barrier cluster g sums and
//   samples rows r = g mod G into a device buffer, then one more barrier of
//   the tile's blocks and each block reads every row back. Each row's draw
//   is drawn once where it is sampled. After the last hidden phase a
//   visible-shaped product of the ladder (pre = h W^T + b) meets at a cluster
//   barrier; the ranks split the chain rows and reduce each row's log p*_beta
//   terms over their strips into a device buffer [S, CR, NT], and the tiles
//   of cluster 0 their c.h shares into [ranks, CR]. One more flag barrier, of
//   every block, and each block adds them up in strip and rank order and runs
//   both swap rounds alike from the same Philox swap draws, exchanging the
//   rows of its own chain tile. The statistics come from rung 0 before the
//   swaps. +(k + 1) cluster and +(k + 1) flag barriers an update.
// - Enhanced gradient: mu, gb (per strip row) and lam, gc (per tile column)
//   are local, so gW_e = gW - mu gc^T - gb lam^T is formed in the update.
//   gb_e = gb - gW_e lam sums over the ranks: each rank's shares ride the
//   next update's first cluster barrier, before b is read. gc_e = gc -
//   gW_e^T mu sums over the strips: each strip's shares ride the device
//   buffer of the next update's first tile barrier, and c is updated there
//   before the sigmoid (the sparsity term on gc_e). After the last update
//   one more of each settles them. +0 barriers.
// - Learned variance: z and vz are resident with b; s = e^{-z} and sigma =
//   e^{z/2} come from the strip's copy at each update's start. The A terms'
//   W h0p and W hmean are one more visible-shaped product (with tempering's,
//   when both are on). +1 cluster barrier.
// - Pseudo monitor: the cluster that holds row `bit` of W forms each rank's
//   share of sum_j softplus(pre + delta W[bit, j]) - softplus(pre) from the
//   data phase's pre-activations, sums the ranks' shares over distributed
//   shared memory after the first cluster barrier (before W changes) and
//   writes the monitor's strip sum in place of the reconstruction's. +0.
//
// The data-parallel step (kStep, a library of its own: -DMDBN_RESIDENT_STEP=1,
// one per kModes variant). Replaces mdbn_tpu/ops/cd_epoch_pallas.py::
// _cd_grads_kernel (:3184) and the step of the TPU's DP mega-kernel in every
// estimator mode, as csrc/cd_grads.cu does (its header says what the step
// computes: one CD-k / PCD step of a rank's rows into the flat statistics
// buffer that parallel/dp.py all-reduces, with the row mask and norm of a
// shard, learned variance's raw z statistic and the enhanced gradient's mean
// sums; the same Philox keying, update 0 under the step's seed, and inject
// layouts). It is this kernel's single update with no update phase: W (and
// z), b and c change between launches, so each block loads its tiles from
// device memory at entry (W with cp.async) and keeps no velocity; then the
// hidden and visible phases as above (k + 1 tile barriers, k cluster
// barriers, the modes' own), and in place of the update each block writes
// its tile of gW, rank 0 its strips' gb (mu, gz) and cluster 0 its tile's gc
// (lam, h0) straight into the flat buffer: every sum in the order the tiling
// fixes, no atomics, so the bits do not depend on the cluster count. The
// barrier counters and the monitor's strip sums are scratch kept between
// launches: after its last barrier each block counts itself out, and the last
// one (a device-scope counter, the threadfence-reduction pattern) adds the
// strip sums in strip order into err and sets the counters back to zero. A
// captured epoch (parallel/dp.py) passes `tab`, a device row of {minibatch,
// seed, pseudo bit} that the kernel reads at entry, so one graph serves
// every epoch.
//
// The optional trace stamps, on block (0, 0)'s clock, the start of each
// step of an update: per hidden phase its products, its tile barrier and its
// sums; per visible phase its products, its cluster barrier and its sums; a
// ladder's exchanges (each a barrier and a copy); the modes' product phase
// and swap rounds; the update; and the end (resident_trace_phases in the
// wrapper).

#include "cd_common.cuh"

namespace {

constexpr int kRThreads = 512;
constexpr int kRWarps = kRThreads / 32;
constexpr int kRT = 4;           // batch rows per thread in the products
constexpr int kMaxStrips = 15;   // V is cut into at most this many strips
constexpr int kMaxRanks = 8;     // H into at most this many column tiles (portable clusters)
constexpr int kInFlight = 8;     // strips' partials loaded at once in a hidden phase's sums
constexpr int kMaxSplit = 4;     // chunks of the hidden products' summed dimension
constexpr int kMaxVSplit = 2;    // of the visible products' (their sums take shared memory)
constexpr int kMinSmem = 120 * 1024;  // asked for at least: one block per SM
constexpr unsigned long long kWatchdogNs = 10000000000ULL;  // a barrier wait this long traps

struct Tiling {
  int tv, th, nstrip, ranks;
};

__host__ __device__ inline Tiling tiling(int V, int H) {
  Tiling t;
  t.tv = ((V + kMaxStrips - 1) / kMaxStrips + 3) / 4 * 4;
  t.th = ((H + kMaxRanks - 1) / kMaxRanks + 31) / 32 * 32;
  t.nstrip = (V + t.tv - 1) / t.tv;
  t.ranks = (H + t.th - 1) / t.th;
  return t;
}

__host__ __device__ inline int align16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Chunks of a product's summed dimension (`quads` groups of 4) for `units`
// work units over `slots` workers: the fewest chunks, at most `most`, that
// make the longest worker's walk shortest.
__host__ __device__ inline int split_for(int units, int slots, int quads, int most) {
  int best = 1, cost = cdiv(units, slots) * quads;
  for (int s = 2; s <= most; ++s) {
    const int c = cdiv(units * s, slots) * cdiv(quads, s);
    if (c < cost) {
      best = s;
      cost = c;
    }
  }
  return best;
}

constexpr int kModeFlags = kTempering | kEnhanced | kLearnVar | kPseudo;

// Byte offsets of a block's shared memory: ns strips of `strip` bytes each,
// then the block's own arrays. The modes' buffers (zero bytes when their
// mode is off) follow the plain ones, in the strip and after the block's.
struct Layout {
  int ldw;               // row stride of a W tile (elements): th + 4
  int hsplit, vsplit;    // chunks of the hidden (over tv) and visible (over th) products
  int w, vw, b, vb, v0, v0_buf, vs, q, q_par;  // offsets inside a strip; buffer strides
  int strip;             // bytes of one strip
  int c, vc, h0p, hmean, h0s, hcur, ud, part, red;  // offsets after the strips
  int total;
  // the modes: in a strip, learned variance's z, vz, s = e^{-z}, sigma =
  // e^{z/2} and the scaled rows [CR][tv]; the enhanced gradient's pending gb,
  // mu and its ranks' shares of gW_e lam by update parity [2][tv]
  int z, vz, s, sig, vss, gbp, mu, pb;
  // after the block's: the enhanced gradient's lam, pending gc and mean h0p
  // [th], shares of gW_e^T mu [tv/4][th] and of gW_e lam [th/64][tv];
  // tempering's totals [CR][NT], c.h [CR], swap flags [2][CR] and the ranks'
  // shares of each strip's monitor [ns]; the pseudo monitor's shares by
  // update parity [2][B]
  int lam, gcp, h0m, pq, ep, lp, ch, acc, psh, merr;
};

// flags: the run's mode bits; M the ladder's rungs. With no mode bit set it
// is the plain variant's layout, nseg (2 under PCD: the monitor's rows) the
// row sets of B rows a visible phase holds. The modes' variant holds CR = M*B
// chain rows (B off a ladder) and up to two row sets a pass.
__host__ __device__ inline Layout layout(const Tiling& t, int B, int nseg, int ns, int sz,
                                         int flags = 0, int M = 1) {
  Layout L;
  const bool pt = flags & kTempering, enh = flags & kEnhanced, lv = flags & kLearnVar;
  const bool modes = flags & kModeFlags;
  const int CR = pt ? M * B : B;
  const int NT = pt ? ((flags & kGaussian) ? 1 : M) : 0;
  const bool recon = (flags & kPersistent) && !(flags & kPseudo);
  // rows of a visible phase: a Gibbs step's chain rows (+ the monitor's) or
  // the product phase's ladder (+ learned variance's h0p and hmean rows)
  const int gibbs_rows = CR + (recon ? B : 0), prod_rows = (pt ? CR : 0) + (lv ? 2 * B : 0);
  const int qrows = modes ? (gibbs_rows > prod_rows ? gibbs_rows : prod_rows) : nseg * B;
  const int vseg = modes ? 2 : nseg;
  const int nrt = cdiv(B, kRT);
  L.ldw = t.th + 4;
  L.hsplit = split_for(cdiv(t.th, 64) * nrt, kRWarps, t.tv / 4, kMaxSplit);
  L.vsplit = split_for(cdiv(t.tv, 64) * nrt, kRWarps, t.th / 4, kMaxVSplit);
  int o = 0;
  L.w = o;   o += align16(t.tv * L.ldw * sz);
  L.vw = o;  o += align16(t.tv * L.ldw * sz);
  L.b = o;   o += align16(t.tv * sz);
  L.vb = o;  o += align16(t.tv * sz);
  L.v0_buf = align16(B * t.tv * sz);
  L.v0 = o;  o += 2 * L.v0_buf;  // this update's rows and the next's
  L.vs = o;  o += align16(CR * t.tv * 4);
  L.q_par = qrows * t.tv * 4;
  L.q = o;   o += 2 * L.q_par;  // the visible partials, by parity
  L.z = o;   o += lv ? align16(t.tv * sz) : 0;
  L.vz = o;  o += lv ? align16(t.tv * sz) : 0;
  L.s = o;   o += lv ? align16(t.tv * 4) : 0;
  L.sig = o; o += lv ? align16(t.tv * 4) : 0;
  L.vss = o; o += lv ? align16(CR * t.tv * 4) : 0;
  L.gbp = o; o += enh ? align16(t.tv * 4) : 0;
  L.mu = o;  o += enh ? align16(t.tv * 4) : 0;
  L.pb = o;  o += enh ? 2 * align16(t.tv * 4) : 0;
  L.strip = o;
  o *= ns;
  L.c = o;     o += align16(t.th * sz);
  L.vc = o;    o += align16(t.th * sz);
  L.h0p = o;   o += align16(B * t.th * 4);
  L.hmean = o; o += align16(CR * t.th * 4);
  L.h0s = o;   o += align16(B * t.th * 4);
  L.hcur = o;  o += align16(CR * t.th * 4);
  L.ud = o;    o += align16(B * t.th * 4);  // a hidden phase's draws (a ladder draws its own)
  const int hp = L.hsplit * B * t.th, vp = L.vsplit * vseg * B * t.tv;
  L.part = o;  o += align16((hp > vp ? hp : vp) * 4);  // the chunks' sums
  L.red = o;   o += align16(kRWarps * 4);
  L.lam = o;   o += enh ? align16(t.th * 4) : 0;
  L.gcp = o;   o += enh ? align16(t.th * 4) : 0;
  L.h0m = o;   o += enh ? align16(t.th * 4) : 0;
  L.pq = o;    o += enh ? align16(cdiv(t.tv, 4) * t.th * 4) : 0;
  L.ep = o;    o += enh ? align16(cdiv(t.th, 64) * t.tv * 4) : 0;
  L.lp = o;    o += pt ? align16(CR * NT * 4) : 0;
  L.ch = o;    o += pt ? align16(CR * 4) : 0;
  L.acc = o;   o += pt ? align16(2 * CR * 4) : 0;
  L.psh = o;   o += (flags & kPseudo) ? align16(2 * B * 4) : 0;
  L.merr = o;  o += pt ? align16(ns * 4) : 0;
  L.total = o;
  return L;
}

// Four consecutive elements, widened to f32 (16 bytes f32, 8 bytes bf16; the
// address is aligned to that).
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  o[0] = __low2float(lo); o[1] = __high2float(lo);
  o[2] = __low2float(hi); o[3] = __high2float(hi);
}

}  // namespace

#include "cd_resident_modes.cuh"

namespace {

// The data-parallel step's arguments (Args::st; the training run leaves them
// unused): the flat buffer's parts (ops/cd_grads_cuda.py::flat_views), the
// row mask, the chain out, the departure counter and the optional table row.
struct StepArgs {
  const long long* tab;  // optional [3]: the step's minibatch, seed and pseudo bit
  const float* mask;     // optional [B] of 0/1: pad rows enter no statistic
  float *gW, *gb, *gc;   // [V, H], [V], [H]
  float* gz;             // learned variance: [V] the raw z statistic
  float *mu, *lam, *h0m; // enhanced: [V], [H], [H]
  float* err;            // [1]
  Store* chain_out;      // PCD: [CR, H]
  unsigned* dep;         // blocks past their last barrier (scratch, zero between launches)
  float inv_norm;
  int bit;
};

struct Args {
  const Store* data;    // [n_rows, V] (the step: its minibatches [*, B, V])
  const int* order;     // [E, nb]
  const float* u_h0;    // inject: [E, nb, B, H]
  const float* u_h;     // inject: [E, nb, k, CR, H]
  const float* u_v;     // inject: [E, nb, k, CR, V] uniforms or normals
  Store* W;
  Store* b;
  Store* c;
  Store* vW;
  Store* vb;
  Store* vc;
  Store* chain;         // [CR, H]: CR = M*B on a tempering ladder, else B
  float* errs;          // [E]
  float* part;          // [2, S, CR, Hp] hidden partials by phase parity, Hp = ranks * th
  float* mon;           // [2, S] monitor strip sums by update parity
  unsigned* bar;        // [ranks] arrival counters of the column-tile barriers (zero);
                        // tempering: [ranks + 1], the last every block's
  unsigned long long* trace;  // optional [E, nb, 6k + 5]
  int V, H, B, nb, E, k, start_epoch, switch_epoch, flags;
  float lr, momentum, initial_momentum, l2, grad_clip, sparsity_target, sparsity_cost;
  unsigned long long seed;
  Tiling t;
  Layout L;
  int clusters;
  ModeArgs md;          // the estimator modes (kModes)
  StepArgs st;          // the data-parallel step (kStep)
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
// Four elements of Store at once (16 bytes of f32, 8 of bf16; both addresses
// aligned to that).
__device__ __forceinline__ void cp_async_quad(Store* dst, const Store* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (sizeof(Store) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_add(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(p) : "memory");
}

// The G blocks of one column tile meet in two halves, with work that needs
// nobody else's results between them. Arrive: thread 0 adds one to the count
// (release: what the block wrote before the __syncthreads is visible to
// whoever acquires the count). Wait: thread 0 waits until the count reaches
// `target` (acquire), then the block goes on. Others' writes are read with
// ld.global.cg. All threads call both.
__device__ __forceinline__ void tile_arrive(unsigned* ctr) {
  __syncthreads();
  if (threadIdx.x == 0) red_release_add(ctr);
}

__device__ __forceinline__ void tile_wait(const unsigned* ctr, unsigned target) {
  if (threadIdx.x == 0) {
    const unsigned long long t0 = globaltimer_ns();
    unsigned spins = 0;
    while (static_cast<int>(ld_acquire(ctr) - target) < 0) {
      if ((++spins & 1023u) == 0 && globaltimer_ns() - t0 > kWatchdogNs) __trap();
    }
  }
  __syncthreads();
}

// The cluster barrier in two halves (cluster.sync() is both): arrive
// releases this thread's writes, wait acquires everyone's. All threads call both.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One strip's partial x W[strip, tile], chunk by chunk into part[p][r][jj]
// (p < hsplit, r < B, jj < th): warp unit = 64 columns (lane = columns jj
// and jj + 32: W reads conflict-free) x kRT rows (x reads broadcast, 4
// columns of x at once) x one chunk of the strip's rows, summed in order.
// Two columns a lane make each broadcast x value feed two FMAs. x and W are
// zero past the strip's nq rows, and W past the tile's nj columns.
template <bool kBf, typename T>
__device__ __forceinline__ void hidden_products(const T* x, const Store* w, const Layout& L,
                                                int tv, int th, int nq, int B, int nj,
                                                float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncg = cdiv(nj, 64), nrt = cdiv(B, kRT), nq4 = cdiv(nq, 4) * 4;
  const int chunk = cdiv(tv / 4, L.hsplit) * 4;
  for (int u = warp; u < ncg * nrt * L.hsplit; u += kRWarps) {
    const int cg = u % ncg, rest = u / ncg, rt = rest % nrt, p = rest / nrt;
    const int j0 = cg * 64 + lane, r0 = rt * kRT;
    const bool two = cg * 64 + 32 < nj;  // the warp's second 32 columns exist
    const int qa = p * chunk, qb = min(qa + chunk, nq4);
    const T* xr[kRT];
#pragma unroll
    for (int rr = 0; rr < kRT; ++rr) xr[rr] = x + min(r0 + rr, B - 1) * tv;
    float acc[2][kRT];
#pragma unroll
    for (int rr = 0; rr < kRT; ++rr) acc[0][rr] = acc[1][rr] = 0.0f;
    for (int q = qa; q < qb; q += 4) {
      float wv[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wv[0][i] = op<kBf>(ld(w + (q + i) * L.ldw + j0));
        wv[1][i] = two ? op<kBf>(ld(w + (q + i) * L.ldw + j0 + 32)) : 0.0f;
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
      if (r0 + rr >= B) continue;
      part[(p * B + r0 + rr) * th + j0] = acc[0][rr];
      if (two) part[(p * B + r0 + rr) * th + j0 + 32] = acc[1][rr];
    }
  }
}

// One strip's partial h W[strip, tile]^T of nseg row sets, chunk by chunk
// into part[p][seg][r][qq]: warp unit = 64 visible rows (lane = rows qq and
// qq + 32; with the padded row stride, 4 consecutive elements of 8 lanes'
// rows fall in distinct banks) x kRT batch rows (h reads broadcast) x one
// chunk of the tile's columns, summed in order. Two rows a lane make each
// broadcast h value feed two FMAs. h and W are zero past the tile's columns.
template <bool kBf>
__device__ __forceinline__ void visible_products(const float* h0, const float* h1, int nseg,
                                                 const Store* w, const Layout& L, int tv,
                                                 int th, int nq, int B, int nj, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nqg = cdiv(nq, 64), nrt = cdiv(B, kRT), nj4 = cdiv(nj, 4) * 4;
  const int chunk = cdiv(th / 4, L.vsplit) * 4;
  for (int u = warp; u < nqg * nrt * nseg * L.vsplit; u += kRWarps) {
    const int qg = u % nqg;
    int rest = u / nqg;
    const int rt = rest % nrt;
    rest /= nrt;
    const int seg = rest % nseg, p = rest / nseg;
    const float* h = seg ? h1 : h0;
    const int q0 = qg * 64 + lane, r0 = rt * kRT, ja = p * chunk, jb = min(ja + chunk, nj4);
    const bool two = qg * 64 + 32 < nq;  // the warp's second 32 rows exist
    const float* hr[kRT];
#pragma unroll
    for (int rr = 0; rr < kRT; ++rr) hr[rr] = h + min(r0 + rr, B - 1) * th;
    float acc[2][kRT];
#pragma unroll
    for (int rr = 0; rr < kRT; ++rr) acc[0][rr] = acc[1][rr] = 0.0f;
    const Store* wr0 = w + min(q0, tv - 1) * L.ldw;  // rows past the tile read its last row
    const Store* wr1 = w + min(q0 + 32, tv - 1) * L.ldw;
    for (int jj = ja; jj < jb; jj += 4) {
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
    float* out = part + ((p * nseg + seg) * B) * tv;
#pragma unroll
    for (int rr = 0; rr < kRT; ++rr) {
      if (r0 + rr >= B) continue;
      if (q0 < nq) out[(r0 + rr) * tv + q0] = acc[0][rr];
      if (two && q0 + 32 < nq) out[(r0 + rr) * tv + q0 + 32] = acc[1][rr];
    }
  }
}

// The monitor's term of one element: squared error, or the cross-entropy
// terms, of data x against its reconstruction y.
__device__ __forceinline__ float monitor_term(float x, float y, bool xent, float acc) {
  if (xent) {
    const float pc = fminf(fmaxf(y, 1e-7f), 1.0f - 1e-7f);
    return acc + (x * logf(pc) + (1.0f - x) * logf(1.0f - pc));
  }
  const float d = x - y;
  return fmaf(d, d, acc);
}

// Sum of x over the block: warp butterflies, then the warps in order; every
// thread gets it. red: kRWarps floats.
__device__ __forceinline__ float block_total(float x, float* red) {
  x = warp_sum(x);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kRWarps; ++w) t += red[w];
  return t;
}

// kModes: 0 the plain variant, which leaves the estimator modes out (and
// with them their registers and branches); 1 the modes without a tempering
// ladder; 2 with one (the ladder's exchanges weigh on the registers of every
// phase, so the other modes do without them). kStep: the data-parallel step
// (one update's phases into the flat statistics buffer, no update).
template <bool kBf, int kModes, bool kStep>
__global__ void __launch_bounds__(kRThreads, 1) cd_train_resident_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Tiling& T = a.t;
  const Layout& L = a.L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = static_cast<int>(blockIdx.x) / T.ranks, G = a.clusters;
  const int V = a.V, H = a.H, B = a.B, S = T.nstrip, tv = T.tv, th = T.th, ldw = L.ldw;
  const int Hp = T.ranks * th;  // row stride of the hidden partials
  const int j0 = rank * th, nj = min(th, H - j0), nj4 = cdiv(nj, 4);
  const int mine = (S - g + G - 1) / G;  // strips g, g + G, ...
  const bool persistent = a.flags & kPersistent;
  const bool gaussian = a.flags & kGaussian;
  const bool sample_v = a.flags & kSampleVisible;
  const bool xent = a.flags & kXent;
  const bool inject = a.flags & kInject;
  const bool lead = g == 0 && rank == 0;  // adds up the monitor, stamps the trace
  const float inv_b = 1.0f / static_cast<float>(B);
  constexpr bool kAny = kModes > 0, kLadder = kModes == 2;
  const bool pt = kLadder && (a.flags & kTempering);
  const bool lv = kAny && (a.flags & kLearnVar);
  const bool enh = kAny && (a.flags & kEnhanced);
  const bool pseudo = kAny && (a.flags & kPseudo);
  const int M = kLadder ? a.md.M : 1, CR = kLadder ? a.md.CR : B;  // rungs, chain rows
  // the step: its minibatch, seed and pseudo bit from the table row when given
  const long long* tab = kStep ? a.st.tab : nullptr;
  const unsigned long long seed = tab ? static_cast<unsigned long long>(tab[1]) : a.seed;
  const float* rmask = kStep ? a.st.mask : nullptr;
  auto mrow = [&](int r) { return rmask ? __ldg(rmask + r) : 1.0f; };  // a row's mask
  Store* c_s = reinterpret_cast<Store*>(smem + L.c);
  Store* vc_s = reinterpret_cast<Store*>(smem + L.vc);
  float* h0p = reinterpret_cast<float*>(smem + L.h0p);
  float* hmean = reinterpret_cast<float*>(smem + L.hmean);
  float* h0s = reinterpret_cast<float*>(smem + L.h0s);
  float* hcur = reinterpret_cast<float*>(smem + L.hcur);  // the PCD chain, or this update's CD chain
  float* ud = reinterpret_cast<float*>(smem + L.ud);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* red = reinterpret_cast<float*>(smem + L.red);
  auto strip = [&](int i) { return smem + static_cast<size_t>(i) * L.strip; };
  auto Wt = [&](int i) { return reinterpret_cast<Store*>(strip(i) + L.w); };
  auto vWt = [&](int i) { return reinterpret_cast<Store*>(strip(i) + L.vw); };
  auto bt = [&](int i) { return reinterpret_cast<Store*>(strip(i) + L.b); };
  auto vbt = [&](int i) { return reinterpret_cast<Store*>(strip(i) + L.vb); };
  auto v0t = [&](int i, int p) { return reinterpret_cast<Store*>(strip(i) + L.v0 + p * L.v0_buf); };
  auto vst = [&](int i) { return reinterpret_cast<float*>(strip(i) + L.vs); };
  auto qt = [&](int i, int p) { return reinterpret_cast<float*>(strip(i) + L.q + p * L.q_par); };
  auto q0_of = [&](int i) { return (g + i * G) * tv; };
  auto nq_of = [&](int i) { return min(tv, V - q0_of(i)); };
  // the modes' buffers (Layout)
  auto f32at = [&](int off) { return reinterpret_cast<float*>(smem + off); };
  auto zt = [&](int i) { return reinterpret_cast<Store*>(strip(i) + L.z); };
  auto vzt = [&](int i) { return reinterpret_cast<Store*>(strip(i) + L.vz); };
  auto st_lv = [&](int i) { return reinterpret_cast<float*>(strip(i) + L.s); };
  auto sig_lv = [&](int i) { return reinterpret_cast<float*>(strip(i) + L.sig); };
  auto vsst = [&](int i) { return reinterpret_cast<float*>(strip(i) + L.vss); };
  auto gbpt = [&](int i) { return reinterpret_cast<float*>(strip(i) + L.gbp); };
  auto mut = [&](int i) { return reinterpret_cast<float*>(strip(i) + L.mu); };
  auto pbt = [&](int i, int p) {
    return reinterpret_cast<float*>(strip(i) + L.pb + p * align16(tv * 4));
  };

  // the rows of minibatch `mb` into buffer p of each strip: cp.async where a
  // 4-byte word holds whole elements, else plain copies
  auto stage_batch = [&](int mb, int p) {
    const Store* src = a.data + static_cast<size_t>(mb) * B * V;
    for (int i = 0; i < mine; ++i) {
      const int q0 = q0_of(i), nq = nq_of(i);
      Store* dst = v0t(i, p);
      if (sizeof(Store) == 4) {
        for (int idx = tid; idx < B * nq; idx += kRThreads) {
          const int r = idx / nq, q = idx - r * nq;
          cp_async4(dst + r * tv + q, src + static_cast<size_t>(r) * V + q0 + q);
        }
      } else if (V % 2 == 0) {  // bf16 pairs: q0 and nq are even
        const int np = nq / 2;
        for (int idx = tid; idx < B * np; idx += kRThreads) {
          const int r = idx / np, q = 2 * (idx - r * np);
          cp_async4(dst + r * tv + q, src + static_cast<size_t>(r) * V + q0 + q);
        }
      } else {
        for (int idx = tid; idx < B * nq; idx += kRThreads) {
          const int r = idx / nq, q = idx - r * nq;
          dst[r * tv + q] = src[static_cast<size_t>(r) * V + q0 + q];
        }
      }
    }
    cp_async_commit();
  };

  // load the resident state (shared memory starts at zero: the tiles' padding
  // and the rows past a strip's end stay zero for the whole run)
  for (int x = tid; x < L.total / 16; x += kRThreads)
    reinterpret_cast<uint4*>(smem)[x] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  // the W and vW tiles with cp.async, all in flight at once: four elements
  // a copy where H and the tile's columns are multiples of 4 (the tile's rows
  // and columns then start on whole copies), else 4-byte words (bf16 pairs
  // where H and the tile's columns are even), else plain copies
  const bool quads = H % 4 == 0 && nj % 4 == 0;
  const bool words = sizeof(Store) == 4 || (H % 2 == 0 && nj % 2 == 0);
  const int per = quads ? 4 : words ? 4 / static_cast<int>(sizeof(Store)) : 1;  // a copy's
  const int njw = nj / per;
  for (int i = 0; i < mine; ++i) {
    const int q0 = q0_of(i), nq = nq_of(i);
    for (int idx = tid; idx < nq * njw; idx += kRThreads) {
      const int q = idx / njw, jj = per * (idx - q * njw);
      const size_t gi = static_cast<size_t>(q0 + q) * H + j0 + jj;
      if (quads) {
        cp_async_quad(Wt(i) + q * ldw + jj, a.W + gi);
        if (!kStep) cp_async_quad(vWt(i) + q * ldw + jj, a.vW + gi);
      } else if (words) {
        cp_async4(Wt(i) + q * ldw + jj, a.W + gi);
        if (!kStep) cp_async4(vWt(i) + q * ldw + jj, a.vW + gi);
      } else {
        Wt(i)[q * ldw + jj] = a.W[gi];
        if (!kStep) vWt(i)[q * ldw + jj] = a.vW[gi];
      }
    }
    for (int q = tid; q < nq; q += kRThreads) {
      bt(i)[q] = a.b[q0 + q];
      if (!kStep) vbt(i)[q] = a.vb[q0 + q];
      if (lv) {
        zt(i)[q] = a.md.z[q0 + q];
        if (!kStep) vzt(i)[q] = a.md.vz[q0 + q];
      }
    }
  }
  for (int jj = tid; jj < nj; jj += kRThreads) {
    c_s[jj] = a.c[j0 + jj];
    if (!kStep) vc_s[jj] = a.vc[j0 + jj];
  }
  if (persistent)
    for (int idx = tid; idx < CR * nj; idx += kRThreads) {
      const int r = idx / nj, jj = idx - r * nj;
      hcur[r * th + jj] = ld(a.chain + static_cast<size_t>(r) * H + j0 + jj);
    }
  stage_batch(kStep ? (tab ? static_cast<int>(tab[0]) : 0) : a.order[0], 0);
  cp_async_wait_all();
  __syncthreads();

  const long long nupd = static_cast<long long>(a.E) * a.nb;
  const int nstamp = 6 * a.k + 5 + (kAny ? ((pt || lv) ? 3 : 0) + (pt ? 2 + 4 * a.k : 0) : 0);
  const size_t bhp = static_cast<size_t>(CR) * Hp;
  const size_t bh = static_cast<size_t>(B) * H;
  const size_t ch = static_cast<size_t>(CR) * H;
  unsigned nbar = 0;  // tile barriers passed
  unsigned nall = 0;  // tempering: barriers of every block passed
  int nhid = 0, nvis = 0;
  float err_sum = 0.0f;  // lead's kMonitorTid: the running monitor sum of the epoch
  float m_pend = 0.0f;   // enhanced: the momentum of the update whose b and c are pending
  int next_mb = nupd > 1 ? a.order[1] : 0;  // the minibatch of the next update
  unsigned long long* stamp = nullptr;
  auto mark = [&]() {
    if (stamp) *stamp++ = globaltimer_ns();
  };

  // lead's last warp (idle in a hidden phase's sums at the graded shapes):
  // add update u's monitor (its strip sums are complete after the barrier
  // that follows it; lane s loads strip s's, lane 0 adds them in strip order)
  // and close its epoch
  constexpr int kMonitorTid = kRThreads - 32;
  auto add_monitor = [&](long long u) {
    if (!(lead && tid >= kMonitorTid)) return;
    const float x = lane < S ? __ldcg(a.mon + (u & 1) * S + lane) : 0.0f;
    float tot = 0.0f;
    for (int s = 0; s < S; ++s) tot += __shfl_sync(0xffffffffu, x, s);
    if (lane != 0) return;
    err_sum += (xent || pseudo) ? (pseudo ? tot : -tot) / static_cast<float>(B)
                                : tot / (static_cast<float>(B) * static_cast<float>(V));
    if ((u + 1) % a.nb == 0) {
      a.errs[u / a.nb] = err_sum * (1.0f / static_cast<float>(a.nb));
      err_sum = 0.0f;
    }
  };

  // enhanced: the pending gc_e of the last update, from the strips' shares of
  // gW_e^T mu in strip order (after a barrier of the tile's blocks)
  auto enhanced_c = [&]() {
    for (int jj = tid; jj < nj; jj += kRThreads) {
      float gcv = f32at(L.gcp)[jj] - ordered_sum(a.md.pc + j0 + jj, Hp, S);
      if (a.flags & kSparsity)
        gcv = gcv + a.sparsity_cost * (a.sparsity_target - f32at(L.h0m)[jj]);
      apply(a, c_s + jj, vc_s + jj, gcv, m_pend, a.lr, false);
    }
    __syncthreads();
  };
  // enhanced: the pending gb_e of update u, from the ranks' shares of gW_e lam
  // in rank order over distributed shared memory (after a cluster barrier)
  auto enhanced_b = [&](long long u) {
    for (int i = 0; i < mine; ++i) {
      const float* pr[kMaxRanks];
#pragma unroll
      for (int c = 0; c < kMaxRanks; ++c)
        pr[c] = c < T.ranks ? cluster.map_shared_rank(pbt(i, static_cast<int>(u & 1)), c)
                            : nullptr;
      for (int q = tid; q < nq_of(i); q += kRThreads) {
        float acc = 0.0f;
#pragma unroll
        for (int c = 0; c < kMaxRanks; ++c)
          if (c < T.ranks) acc += pr[c][q];
        apply(a, bt(i) + q, vbt(i) + q, gbpt(i)[q] - acc, m_pend, a.lr, false);
      }
    }
    __syncthreads();
  };

  // a hidden phase: the strips' partials of x (this update's rows or vs) into
  // the device buffer, the tile barrier, the strip-ordered sums, sigmoid, draw.
  // Modes: the ladder's CR rows past the data phase, a rung a pass; under
  // learned variance x times s, staged per pass
  auto hidden_phase = [&](bool from_data, int pv, float* hprob, float* hsamp,
                          const float* u_inj, unsigned upd, int kind, int t, long long u) {
    mark();
    if (from_data && u + 1 < nupd) {  // the next update's rows land while this one runs
      stage_batch(next_mb, pv ^ 1);
      if (u + 2 < nupd) next_mb = a.order[u + 2];  // read now, used an update later
    }
    const int rows = from_data ? B : CR;
    float* dev = a.part + static_cast<size_t>(nhid & 1) * S * bhp;
    for (int i = 0; pt && !from_data && i < mine; ++i) {
      // the ladder's rows fill the warps: one pass, no chunks, straight to
      // the device buffer (under learned variance every row times s first)
      const float* x = vst(i);
      if (lv) {
        const int nq = nq_of(i);
        const float* sc = st_lv(i);
        for (int idx = tid; idx < rows * nq; idx += kRThreads) {
          const int r = idx / nq, o = r * tv + idx - r * nq;
          vsst(i)[o] = x[o] * sc[o - r * tv];
        }
        __syncthreads();
        x = vsst(i);
      }
      hidden_rows<kBf>([&](int r) { return x + r * tv; }, Wt(i), ldw, nq_of(i), rows, nj,
                       dev + static_cast<size_t>(g + i * G) * bhp + j0, Hp);
    }
    for (int i = 0; !(pt && !from_data) && i < mine; ++i) {
      if (lv) {  // the rows times s
        const int nq = nq_of(i);
        const Store* v0 = v0t(i, pv);
        const float* src = vst(i);
        const float* sc = st_lv(i);
        float* dst = vsst(i);
        for (int idx = tid; idx < B * nq; idx += kRThreads) {
          const int r = idx / nq, o = r * tv + idx - r * nq;
          dst[o] = (from_data ? ld(v0 + o) : src[o]) * sc[o - r * tv];
        }
        __syncthreads();
      }
      if (from_data && !lv)
        hidden_products<kBf>(v0t(i, pv), Wt(i), L, tv, th, nq_of(i), B, nj, part);
      else
        hidden_products<kBf>(lv ? vsst(i) : vst(i), Wt(i), L, tv, th, nq_of(i), B, nj, part);
      __syncthreads();
      float* dst = dev + static_cast<size_t>(g + i * G) * bhp + j0;
      for (int idx = tid; idx < B * nj4; idx += kRThreads) {
        const int r = idx / nj4, jq = 4 * (idx - r * nj4);
        float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int p = 0; p < L.hsplit; ++p) {
          const float4 v = *reinterpret_cast<const float4*>(part + (p * B + r) * th + jq);
          sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
        }
        __stcg(reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * Hp + jq), sum);
      }
      if (i + 1 < mine) __syncthreads();  // (tile_arrive syncs after the last strip)
    }
    const bool ladder = pt && !from_data;
    mark();
    tile_arrive(a.bar + rank);
    // while the other clusters arrive: this phase's draws (or injected
    // uniforms; a ladder draws its own rows' in its sums)
    for (int idx = tid; !ladder && idx < rows * nj; idx += kRThreads) {
      const int r = idx / nj, jj = idx - r * nj;
      ud[r * th + jj] = u_inj ? u_inj[static_cast<size_t>(r) * H + j0 + jj]
                              : draw_uniform(seed, upd, kind, t, r, j0 + jj);
    }
    tile_wait(a.bar + rank, ++nbar * static_cast<unsigned>(G));
    mark();
    if (from_data && u > 0) add_monitor(u - 1);
    if (enh && from_data && u > 0) enhanced_c();  // c before the sigmoid reads it
    if (ladder) {
      // the tile's blocks split the ladder's rows, row r to cluster r mod G:
      // its strips' sums in strip order, sigmoid and draw into the exchange
      // buffer (probabilities, samples); one more barrier of the tile's
      // blocks, and every block reads every row back (a seventh of the
      // device-memory reads and of the draws of every block summing every row)
      float* xp = a.md.hx;
      float* xs = a.md.hx + static_cast<size_t>(CR) * Hp;
      const int nown = cdiv(CR - g, G);
      for (int idx = tid; idx < nown * nj4; idx += kRThreads) {
        const int k = idx / nj4, jq = 4 * (idx - k * nj4), r = g + k * G;
        const size_t o = static_cast<size_t>(r) * Hp + j0 + jq;
        const float4 sum = ordered_sum4(dev + o, bhp, S);
        const float sv[4] = {sum.x, sum.y, sum.z, sum.w};
        const float beta = __ldg(a.md.betas + r / B);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int jj = jq + i;
          if (jj >= nj) break;
          const float pr = sigmoidf(beta * (sv[i] + ld(c_s + jj)));
          const float uu = u_inj ? u_inj[static_cast<size_t>(r) * H + j0 + jj]
                                 : draw_uniform(seed, upd, kind, t, r, j0 + jj);
          __stcg(xp + o + i, pr);
          __stcg(xs + o + i, uu < pr ? 1.0f : 0.0f);
        }
      }
      mark();
      tile_arrive(a.bar + rank);
      tile_wait(a.bar + rank, ++nbar * static_cast<unsigned>(G));
      mark();
      constexpr int kBatch = 2;  // rows' loads a thread keeps in flight
      const int n = CR * nj4;
      for (int base = tid; base < n; base += kBatch * kRThreads) {
        float4 vp[kBatch], vh[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int idx = base + k * kRThreads, r = idx / nj4;
          const size_t o = static_cast<size_t>(r) * Hp + j0 + 4 * (idx - r * nj4);
          if (idx < n) {
            vp[k] = __ldcg(reinterpret_cast<const float4*>(xp + o));
            vh[k] = __ldcg(reinterpret_cast<const float4*>(xs + o));
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int idx = base + k * kRThreads, r = idx / nj4, jq = 4 * (idx - r * nj4);
          if (idx >= n) break;
          const float p4[4] = {vp[k].x, vp[k].y, vp[k].z, vp[k].w};
          const float h4[4] = {vh[k].x, vh[k].y, vh[k].z, vh[k].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (jq + i >= nj) break;
            hprob[r * th + jq + i] = p4[i];
            hsamp[r * th + jq + i] = h4[i];
          }
        }
      }
    }
    for (int idx = tid; !ladder && idx < rows * nj4; idx += kRThreads) {
      const int r = idx / nj4, jq = 4 * (idx - r * nj4);
      const float* p = dev + static_cast<size_t>(r) * Hp + j0 + jq;
      float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int s0 = 0; s0 < kMaxStrips; s0 += kInFlight) {
        float4 v[kInFlight];  // a batch of strips' loads in flight before its first add
#pragma unroll
        for (int b = 0; b < kInFlight; ++b)
          if (s0 + b < S) v[b] = __ldcg(reinterpret_cast<const float4*>(p + (s0 + b) * bhp));
#pragma unroll
        for (int b = 0; b < kInFlight; ++b) {
          if (s0 + b < S) {
            sum.x += v[b].x; sum.y += v[b].y; sum.z += v[b].z; sum.w += v[b].w;
          }
        }
      }
      const float sv[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int jj = jq + i;
        if (jj >= nj) break;
        const float pre = sv[i] + ld(c_s + jj);
        const float pr = sigmoidf(pre);
        hprob[r * th + jj] = pr;
        hsamp[r * th + jj] = ud[r * th + jj] < pr ? 1.0f : 0.0f;
        if (pseudo && from_data) ud[r * th + jj] = pre;  // the pseudo monitor's pre_h0
      }
    }
    ++nhid;
    __syncthreads();
  };

  // the visible partials of every strip for nsegs row sets of B rows (set s
  // from seg(s), into rows s*B of the strip's partials of parity pq); the
  // modes' variant puts two sets a pass through the products' chunk sums
  auto visible_partials = [&](int pq, int nsegs, auto seg) {
    if (pt) {  // a ladder's row sets fill the warps: one pass, no chunks
      for (int i = 0; i < mine; ++i)
        visible_rows<kBf>(seg, nsegs, Wt(i), ldw, tv, th, nq_of(i), B, nj, qt(i, pq));
      return;
    }
    for (int i = 0; i < mine; ++i) {  // at most two row sets: one pass
      const int nq = nq_of(i), nq4 = cdiv(nq, 4);
      visible_products<kBf>(seg(0), seg(1), nsegs, Wt(i), L, tv, th, nq, B, nj, part);
      __syncthreads();
      float* q = qt(i, pq);
      for (int idx = tid; idx < nsegs * B * nq4; idx += kRThreads) {
        const int row = idx / nq4, qq = 4 * (idx - row * nq4);  // row = seg * B + r
        float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int p = 0; p < L.vsplit; ++p) {
          const float4 v =
              *reinterpret_cast<const float4*>(part + (p * nsegs * B + row) * tv + qq);
          sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
        }
        *reinterpret_cast<float4*>(q + row * tv + qq) = sum;
      }
      if (i + 1 < mine) __syncthreads();  // (the cluster barrier follows the last strip)
    }
  };

  // the step (kStep): the statistics into the flat buffer in place of the
  // update. gW of each unit of the block's tiles (4 strip rows x 64 columns,
  // as the update's), its rows summed in order; rank 0's blocks the strips'
  // gb (mu, gz), cluster 0's the tile's gc (lam, h0), a thread an element on
  // the last threads, rows in order. Masked rows (and their precision-scaled
  // visibles) count zero; rung 0 of a ladder, before its swaps
  auto step_stats = [&](int pv) {
    const float inv = a.st.inv_norm;
    for (int i = 0; i < mine; ++i) {
      const int nq = nq_of(i), q0 = q0_of(i);
      const Store* v0 = v0t(i, pv);
      const float* vs = vst(i);
      const int ncg = cdiv(nj, 64), nq4 = cdiv(nq, 4);
      for (int unit = warp; unit < nq4 * ncg; unit += kRWarps) {
        const int cg = unit % ncg, qb = 4 * (unit / ncg), jl = cg * 64 + lane;
        const bool two = cg * 64 + 32 < nj;  // the warp's second 32 columns exist
        float pos[2][4], neg[2][4];
#pragma unroll
        for (int qi = 0; qi < 4; ++qi) pos[0][qi] = pos[1][qi] = neg[0][qi] = neg[1][qi] = 0.0f;
        float s4[4] = {1.0f, 1.0f, 1.0f, 1.0f};  // learned variance: s of the unit's rows
        if (lv) load4(st_lv(i) + qb, s4);
#pragma unroll 4
        for (int r = 0; r < B; ++r) {
          const float mr = mrow(r);
          const float hp0 = op<kBf>(h0p[r * th + jl]), hm0 = op<kBf>(hmean[r * th + jl]);
          const float hp1 = two ? op<kBf>(h0p[r * th + jl + 32]) : 0.0f;
          const float hm1 = two ? op<kBf>(hmean[r * th + jl + 32]) : 0.0f;
          float xv[4], sv[4];
          load4(v0 + r * tv + qb, xv);
          load4(vs + r * tv + qb, sv);
#pragma unroll
          for (int qi = 0; qi < 4; ++qi) {
            const float xo = op<kBf>(xv[qi] * mr * s4[qi]);
            const float so = op<kBf>(sv[qi] * mr * s4[qi]);
            pos[0][qi] = fmaf(xo, hp0, pos[0][qi]);
            neg[0][qi] = fmaf(so, hm0, neg[0][qi]);
            pos[1][qi] = fmaf(xo, hp1, pos[1][qi]);
            neg[1][qi] = fmaf(so, hm1, neg[1][qi]);
          }
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int jj = jl + 32 * c;
          if (jj >= nj) break;
#pragma unroll
          for (int qi = 0; qi < 4; ++qi) {
            if (qb + qi >= nq) break;
            a.st.gW[static_cast<size_t>(q0 + qb + qi) * H + j0 + jj] =
                (pos[c][qi] - neg[c][qi]) * inv;
          }
        }
      }
      // gb (mu, gz) on the threads after gc's (the last ones, whose warps hold
      // the fewest gW units): (rev - nj) mod kRThreads, as the update's b
      const int rev = kRThreads - 1 - tid;
      for (int q = ((rev - nj) % kRThreads + kRThreads) % kRThreads; rank == 0 && q < nq;
           q += kRThreads) {
        const float sq = lv ? st_lv(i)[q] : 1.0f;
        float d = 0.0f, sm = 0.0f, az = 0.0f;
        for (int r = 0; r < B; ++r) {
          const float mr = mrow(r);
          const float x = ld(v0 + r * tv + q) * mr, y = vs[r * tv + q] * mr;
          d += x * sq - y * sq;
          sm += x + y;
          if (lv) az += vsst(i)[r * tv + q] * mr;  // A_data - A_model of the row
        }
        a.st.gb[q0 + q] = d * inv;
        if (enh) a.st.mu[q0 + q] = 0.5f * sm * inv;
        if (lv) a.st.gz[q0 + q] = az * inv;
      }
    }
    for (int jj = kRThreads - 1 - tid; g == 0 && jj < nj; jj += kRThreads) {
      float d = 0.0f, on = 0.0f, sn = 0.0f;
      for (int r = 0; r < B; ++r) {
        const float mr = mrow(r);
        const float x = h0p[r * th + jj] * mr, y = hmean[r * th + jj] * mr;
        d += x - y;
        on += x;
        sn += y;
      }
      float gc = d * inv;
      if (enh) {
        a.st.lam[j0 + jj] = 0.5f * (on + sn) * inv;
        a.st.h0m[j0 + jj] = on * inv;
      } else if (a.flags & kSparsity) {
        gc = gc + a.sparsity_cost * (a.sparsity_target - on * inv);
      }
      a.st.gc[j0 + jj] = gc;
    }
  };

  for (int e = 0; e < a.E; ++e) {
    const int abs_epoch = a.start_epoch + e;
    const float m = ((a.flags & kMomentumSchedule) && abs_epoch < a.switch_epoch)
                        ? a.initial_momentum
                        : a.momentum;
    for (int ib = 0; ib < a.nb; ++ib) {
      const long long u = static_cast<long long>(e) * a.nb + ib;
      const int pv = static_cast<int>(u & 1);
      const unsigned upd = static_cast<unsigned>(abs_epoch) * static_cast<unsigned>(a.nb) +
                           static_cast<unsigned>(ib);
      const size_t ei = static_cast<size_t>(u);
      const int bit = kStep ? (tab ? static_cast<int>(tab[2]) : a.st.bit)
                            : static_cast<int>((static_cast<long long>(abs_epoch) * a.nb + ib) % V);
      stamp = (a.trace && lead && tid == 0) ? a.trace + ei * nstamp : nullptr;
      if (lv) {  // this update's s = e^{-z} and sigma = e^{z/2}, from the strip's z
        for (int i = 0; i < mine; ++i)
          for (int q = tid; q < nq_of(i); q += kRThreads) {
            const float zq = ld(zt(i) + q);
            st_lv(i)[q] = expf(-zq);
            sig_lv(i)[q] = expf(0.5f * zq);
          }
        __syncthreads();
      }
      hidden_phase(true, pv, h0p, h0s, inject ? a.u_h0 + ei * bh : nullptr, upd, kDrawH0, 0, u);

      const float* hsrc = persistent ? hcur : h0s;
      for (int t = 0; t < a.k; ++t) {
        // visible phase t: partials, cluster barrier, rank-ordered sums
        mark();
        // PCD: the monitor's reconstruction from h0s (not under the pseudo monitor)
        const bool recon = t == 0 && persistent && !pseudo;
        const int nseg = recon ? 2 : 1;
        const int pq = nvis & 1;
        // the chain's row sets (tempering: a rung each), then the data chain's
        visible_partials(pq, kAny ? M + (recon ? 1 : 0) : nseg,
                         [&](int s) { return s < M ? hsrc + s * B * th : h0s; });
        if (pseudo && t == 0 && (bit / tv) % G == g) {  // this cluster holds row `bit` of W
          const int ibit = bit / tv / G, qb = bit - (bit / tv) * tv;
          pseudo_shares(ud, Wt(ibit) + qb * ldw, v0t(ibit, pv) + qb, tv, th, nj, B,
                        f32at(L.psh) + (u & 1) * B);
        }
        mark();
        cluster_arrive();
        // while the cluster arrives: the draws (or injected uniforms or
        // noise) of the visible samples, into vs (a ladder draws its own rows'
        // in its sums)
        if (sample_v && !pt) {
          const float* uv =
              inject ? a.u_v + (ei * a.k + t) * static_cast<size_t>(CR) * V : nullptr;
          for (int i = 0; i < mine; ++i) {
            const int q0 = q0_of(i), nq = nq_of(i);
            float* vs = vst(i);
            for (int idx = tid; idx < CR * nq; idx += kRThreads) {
              const int r = idx / nq, q = idx - r * nq;
              vs[r * tv + q] = uv ? uv[static_cast<size_t>(r) * V + q0 + q]
                               : gaussian ? draw_normal(seed, upd, kDrawV, t, r, q0 + q)
                                          : draw_uniform(seed, upd, kDrawV, t, r, q0 + q);
            }
          }
        }
        __syncthreads();
        cluster_wait();
        mark();
        if (enh && t == 0 && u > 0) enhanced_b(u - 1);  // b before the sums read it
        // the pseudo monitor in place of the reconstruction's: V softplus(delta
        // b_bit + the ranks' shares) of each row, in the strip that holds bit
        auto pseudo_monitor = [&](int i) {
          const int si = g + i * G;
          float x = 0.0f;
          for (int r = tid; bit / tv == si && r < B; r += kRThreads) {
            const int qb = bit - si * tv;
            float acc = 0.0f;
            for (int c = 0; c < T.ranks; ++c)
              acc += cluster.map_shared_rank(f32at(L.psh) + (u & 1) * B, c)[r];
            const float delta = 1.0f - 2.0f * ld(v0t(i, pv) + r * tv + qb);
            const float term = static_cast<float>(V) * softplusf(delta * ld(bt(i) + qb) + acc);
            x += kStep ? mrow(r) * term : term;
          }
          const float tot = block_total(x, red);
          if (tid == 0) __stcg(a.mon + (u & 1) * S + si, tot);
        };
        if (pt) {
          // a ladder: the ranks split its rows (and the monitor's) for the
          // sums, row r to rank r mod C, each drawing its own rows' samples;
          // then one more cluster barrier, and each copies the other ranks'
          // rows of vs (a quarter of the distributed shared memory traffic of
          // every rank summing every row)
          const float* uv = (inject && sample_v)
                                ? a.u_v + (ei * a.k + t) * static_cast<size_t>(CR) * V : nullptr;
          const int nown = cdiv(CR + (recon ? B : 0) - rank, T.ranks);
          for (int i = 0; i < mine; ++i) {
            const int q0 = q0_of(i), nq = nq_of(i), nq4 = cdiv(nq, 4);
            const float* rq[kMaxRanks];
#pragma unroll
            for (int c = 0; c < kMaxRanks; ++c)
              rq[c] = c < T.ranks ? cluster.map_shared_rank(qt(i, pq), c) : nullptr;
            const Store* v0 = v0t(i, pv);
            const Store* bs = bt(i);
            float* vs = vst(i);
            const float* sg = lv ? sig_lv(i) : nullptr;
            float err = 0.0f;
            for (int idx = tid; idx < nown * nq4; idx += kRThreads) {
              const int k = idx / nq4, qq = 4 * (idx - k * nq4), row = rank + k * T.ranks;
              const float4 sum = rank_sum4(rq, T.ranks, row * tv + qq);
              const float sv[4] = {sum.x, sum.y, sum.z, sum.w};
              const float beta = row < CR ? __ldg(a.md.betas + row / B) : 1.0f;
#pragma unroll
              for (int ii = 0; ii < 4; ++ii) {
                const int qi = qq + ii;
                if (qi >= nq) break;
                const float pre = sv[ii] + ld(bs + qi);
                if (row >= CR) {  // the data chain's reconstruction: the monitor
                  const float y = gaussian ? pre : sigmoidf(pre);
                  const float x = ld(v0 + (row - CR) * tv + qi);
                  err = kStep ? err + mrow(row - CR) * monitor_term(x, y, xent, 0.0f)
                              : monitor_term(x, y, xent, err);
                  continue;
                }
                const float mean = gaussian ? pre : sigmoidf(beta * pre);
                float sample = mean;
                if (sample_v) {
                  const int q = q0 + qi;
                  const float d = uv ? uv[static_cast<size_t>(row) * V + q]
                                  : gaussian ? draw_normal(seed, upd, kDrawV, t, row, q)
                                             : draw_uniform(seed, upd, kDrawV, t, row, q);
                  float nz = d / sqrtf(beta);  // Gaussian noise: variance sigma^2 / beta
                  if (lv) nz = nz * sg[qi];
                  sample = gaussian ? mean + nz : (d < mean ? 1.0f : 0.0f);
                }
                vs[row * tv + qi] = sample;
              }
            }
            if (recon) {  // this rank's share of the strip's monitor
              const float tot = block_total(err, red);
              if (tid == 0) f32at(L.merr)[i] = tot;
            }
          }
          mark();
          cluster_arrive();
          cluster_wait();
          mark();
          for (int i = 0; i < mine; ++i) {
            const int nq4 = cdiv(nq_of(i), 4), n = CR * nq4;
            float* vs = vst(i);
            constexpr int kBatch = 2;  // rows' loads a thread keeps in flight
            for (int base = tid; base < n; base += kBatch * kRThreads) {
              float4 v[kBatch];
#pragma unroll
              for (int k = 0; k < kBatch; ++k) {
                const int idx = base + k * kRThreads, r = idx / nq4, c = r % T.ranks;
                if (idx < n && c != rank)
                  v[k] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(vs, c) + r * tv +
                                                          4 * (idx - r * nq4));
              }
#pragma unroll
              for (int k = 0; k < kBatch; ++k) {
                const int idx = base + k * kRThreads, r = idx / nq4, c = r % T.ranks;
                if (idx < n && c != rank)
                  *reinterpret_cast<float4*>(vs + r * tv + 4 * (idx - r * nq4)) = v[k];
              }
            }
            if (recon && rank == 0 && tid == 0) {  // the ranks' shares in rank order
              float tot = 0.0f;
              for (int c = 0; c < T.ranks; ++c)
                tot += cluster.map_shared_rank(f32at(L.merr), c)[i];
              __stcg(a.mon + (u & 1) * S + g + i * G, tot);
            }
            if (pseudo && t == 0 && rank == 0) pseudo_monitor(i);
          }
        }
        const bool monitor = t == 0 && rank == 0 && !pseudo;
        for (int i = 0; !pt && i < mine; ++i) {
          const int nq = nq_of(i), nq4 = cdiv(nq, 4);
          const float* rq[kMaxRanks];
#pragma unroll
          for (int c = 0; c < kMaxRanks; ++c)
            rq[c] = c < T.ranks ? cluster.map_shared_rank(qt(i, pq), c) : nullptr;
          const Store* v0 = v0t(i, pv);
          const Store* bs = bt(i);
          float* vs = vst(i);
          const float* sg = lv ? sig_lv(i) : nullptr;
          float err = 0.0f;
          for (int idx = tid; idx < CR * nq4; idx += kRThreads) {
            const int r = idx / nq4, qq = 4 * (idx - r * nq4), o = r * tv + qq;
            // the C ranks' partials, every load in flight before the first add
            auto rank_sum = [&](int off) {
              float4 v[kMaxRanks];
#pragma unroll
              for (int c = 0; c < kMaxRanks; ++c)
                if (c < T.ranks) v[c] = *reinterpret_cast<const float4*>(rq[c] + off);
              float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
              for (int c = 0; c < kMaxRanks; ++c) {
                if (c < T.ranks) {
                  sum.x += v[c].x; sum.y += v[c].y; sum.z += v[c].z; sum.w += v[c].w;
                }
              }
              return sum;
            };
            const float4 sum = rank_sum(o);
            const float4 sum2 =
                (monitor && recon) ? rank_sum(CR * tv + o) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            const float sv[4] = {sum.x, sum.y, sum.z, sum.w};
            const float sv2[4] = {sum2.x, sum2.y, sum2.z, sum2.w};
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) {
              const int qi = qq + ii;
              if (qi >= nq) break;
              const float bq = ld(bs + qi);
              const float pre = sv[ii] + bq;
              const float mean = gaussian ? pre : sigmoidf(pre);
              float sample = mean;
              if (sample_v) {  // vs holds this element's draw
                const float d = vs[o + ii];
                const float nz = lv ? d * sg[qi] : d;  // learned variance: sigma d
                sample = gaussian ? mean + nz : (d < mean ? 1.0f : 0.0f);
              }
              vs[o + ii] = sample;
              if (monitor) {
                const float p2 = sv2[ii] + bq;
                const float y = recon ? (gaussian ? p2 : sigmoidf(p2)) : mean;
                err = kStep ? err + mrow(r) * monitor_term(ld(v0 + o + ii), y, xent, 0.0f)
                            : monitor_term(ld(v0 + o + ii), y, xent, err);
              }
            }
          }
          if (monitor) {
            const float tot = block_total(err, red);
            if (tid == 0) __stcg(a.mon + (u & 1) * S + g + i * G, tot);
          }
          if (pseudo && t == 0 && rank == 0) pseudo_monitor(i);
        }
        ++nvis;
        __syncthreads();
        // hidden phase t: into the chain (PCD) or this update's CD chain
        hidden_phase(false, pv, hmean, hcur,
                     inject ? a.u_h + (ei * a.k + t) * ch : nullptr, upd, kDrawH, t, u);
        hsrc = hcur;
      }

      if (pt || lv) {
        // the modes' product phase: tempering's ladder h W^T (+ b: pre) and
        // learned variance's W h0p and W hmean, at one cluster barrier
        mark();
        const int pq = nvis & 1;
        const int nl = pt ? M : 0;  // the ladder's row sets
        visible_partials(pq, nl + (lv ? 2 : 0), [&](int s) {
          return s < nl ? hcur + s * B * th : s == nl ? h0p : hmean;
        });
        if (pt && g == 0)  // this tile's share of c.h of every chain row
          for (int r = warp; r < CR; r += kRWarps) {
            float acc = 0.0f;
            for (int jj = lane; jj < nj; jj += 32)
              acc = fmaf(hcur[r * th + jj], op<kBf>(ld(c_s + jj)), acc);
            acc = warp_sum(acc);
            if (lane == 0) __stcg(a.md.ch_part + static_cast<size_t>(rank) * CR + r, acc);
          }
        mark();
        cluster_arrive();
        cluster_wait();
        mark();
        for (int i = 0; i < mine; ++i) {
          const int nq = nq_of(i), si = g + i * G;
          const float* rq[kMaxRanks];
#pragma unroll
          for (int c = 0; c < kMaxRanks; ++c)
            rq[c] = c < T.ranks ? cluster.map_shared_rank(qt(i, pq), c) : nullptr;
          if (pt)  // the ranks split the chain rows, a warp a row
            for (int r = rank + T.ranks * warp; r < CR; r += T.ranks * kRWarps)
              ladder_terms(rq, T.ranks, r * tv, bt(i), lv ? st_lv(i) : nullptr, nq, a.md.NT,
                           a.md.betas, gaussian,
                           a.md.lp_part + (static_cast<size_t>(si) * CR + r) * a.md.NT);
          if (lv) {  // A_data - A_model of each data row, into the scaled rows' buffer
            const Store* v0 = v0t(i, pv);
            const Store* bs = bt(i);
            const float* vs = vst(i);
            float* out = vsst(i);
            const int od = nl * B * tv, om = od + B * tv, nq4 = cdiv(nq, 4);
            for (int idx = tid; idx < B * nq4; idx += kRThreads) {
              const int r = idx / nq4, qq = 4 * (idx - r * nq4), o = r * tv + qq;
              const float4 wd = rank_sum4(rq, T.ranks, od + o), wm = rank_sum4(rq, T.ranks, om + o);
              const float whd[4] = {wd.x, wd.y, wd.z, wd.w}, whm[4] = {wm.x, wm.y, wm.z, wm.w};
#pragma unroll
              for (int ii = 0; ii < 4; ++ii) {
                if (qq + ii >= nq) break;
                const float bq = ld(bs + qq + ii), x = ld(v0 + o + ii), y = vs[o + ii];
                const float d = x - bq, dm = y - bq;
                out[o + ii] = (0.5f * (d * d) - x * whd[ii]) - (0.5f * (dm * dm) - y * whm[ii]);
              }
            }
          }
        }
        ++nvis;
        __syncthreads();
      }
      if (pt) {  // the swap rounds, after a barrier of every block
        mark();
        tile_arrive(a.bar + T.ranks);
        tile_wait(a.bar + T.ranks, ++nall * static_cast<unsigned>(G * T.ranks));
        mark();
        float* lp = f32at(L.lp);
        float* chs = f32at(L.ch);
        const int NT = a.md.NT;
        for (int idx = tid; idx < CR * NT; idx += kRThreads)  // in strip order
          lp[idx] = ordered_sum(a.md.lp_part + idx, static_cast<size_t>(CR) * NT, S);
        for (int r = tid; r < CR; r += kRThreads)  // in rank order
          chs[r] = ordered_sum(a.md.ch_part + r, CR, T.ranks);
        __syncthreads();
        ladder_swaps(a.md.betas, a.md.u_swap, M, NT, B, a.flags, seed, lp, chs,
                     reinterpret_cast<int*>(smem + L.acc), hcur, th, nj, upd, ei);
      }

      // update: W and vW tiles, b and vb of each strip, c and vc (b and c on
      // the last threads, whose warps hold the fewest W units). Enhanced: the
      // statistics of the recombination first; b and c wait for the shares
      // of the other ranks and strips (enhanced_b, enhanced_c). The step
      // writes its statistics instead
      mark();
      if constexpr (kStep) {
        step_stats(pv);
        __syncthreads();
        mark();
        continue;
      }
      const int rev = kRThreads - 1 - tid;
      if (enh) {
        for (int jj = tid; jj < nj; jj += kRThreads) {
          float hd = 0.0f, hs = 0.0f, hp = 0.0f;
          for (int r = 0; r < B; ++r) {
            const float x = h0p[r * th + jj], y = hmean[r * th + jj];
            hd += x - y;
            hs += x + y;
            hp += x;
          }
          f32at(L.gcp)[jj] = hd * inv_b;
          f32at(L.lam)[jj] = 0.5f * hs * inv_b;
          f32at(L.h0m)[jj] = hp * inv_b;
        }
        for (int i = 0; i < mine; ++i) {  // (on the last threads, beside the columns')
          const Store* v0 = v0t(i, pv);
          const float* vs = vst(i);
          for (int q = rev; q < nq_of(i); q += kRThreads) {
            float ds = 0.0f, ms = 0.0f;
            for (int r = 0; r < B; ++r) {
              const float x = ld(v0 + r * tv + q), y = vs[r * tv + q];
              ds += x - y;
              ms += x + y;
            }
            gbpt(i)[q] = ds * inv_b;
            mut(i)[q] = 0.5f * ms * inv_b;
          }
        }
        __syncthreads();
      }
      for (int i = 0; i < mine; ++i) {
        const int nq = nq_of(i);
        const Store* v0 = v0t(i, pv);
        const float* vs = vst(i);
        Store* w = Wt(i);
        Store* vw = vWt(i);
        // warp unit: 4 visible rows x 64 columns (lane = columns jj, jj + 32),
        // so each broadcast row of v0 and vs feeds two columns
        const int ncg = cdiv(nj, 64), nq4 = cdiv(nq, 4);
        for (int unit = warp; unit < nq4 * ncg; unit += kRWarps) {
          const int cg = unit % ncg, qb = 4 * (unit / ncg);
          const int j0 = cg * 64 + lane;
          const bool two = cg * 64 + 32 < nj;  // the warp's second 32 columns exist
          float pos[2][4], neg[2][4];
#pragma unroll
          for (int qi = 0; qi < 4; ++qi) pos[0][qi] = pos[1][qi] = neg[0][qi] = neg[1][qi] = 0.0f;
          float s4[4];  // learned variance: s of the unit's rows
          if (lv) load4(st_lv(i) + qb, s4);
#pragma unroll 4
          for (int r = 0; r < B; ++r) {
            const float hp0 = op<kBf>(h0p[r * th + j0]), hm0 = op<kBf>(hmean[r * th + j0]);
            const float hp1 = two ? op<kBf>(h0p[r * th + j0 + 32]) : 0.0f;
            const float hm1 = two ? op<kBf>(hmean[r * th + j0 + 32]) : 0.0f;
            float xv[4], sv[4];
            load4(v0 + r * tv + qb, xv);
            load4(vs + r * tv + qb, sv);
#pragma unroll
            for (int qi = 0; qi < 4; ++qi) {
              const float xo = op<kBf>(lv ? xv[qi] * s4[qi] : xv[qi]);
              const float so = op<kBf>(lv ? sv[qi] * s4[qi] : sv[qi]);
              pos[0][qi] = fmaf(xo, hp0, pos[0][qi]);
              neg[0][qi] = fmaf(so, hm0, neg[0][qi]);
              pos[1][qi] = fmaf(xo, hp1, pos[1][qi]);
              neg[1][qi] = fmaf(so, hm1, neg[1][qi]);
            }
          }
          float eb[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ec[2] = {0.0f, 0.0f};  // enhanced shares
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int jj = j0 + 32 * c;
            if (jj >= nj) break;
#pragma unroll
            for (int qi = 0; qi < 4; ++qi) {
              if (qb + qi >= nq) break;
              const int o = (qb + qi) * ldw + jj;
              float gw = (pos[c][qi] - neg[c][qi]) * inv_b;
              if (enh) {  // gW_e; the matvecs' operands under the compute dtype
                const float mu_q = mut(i)[qb + qi], lam_j = f32at(L.lam)[jj];
                gw = gw - mu_q * f32at(L.gcp)[jj] - gbpt(i)[qb + qi] * lam_j;
                const float ge = op<kBf>(gw);
                eb[qi] = fmaf(ge, op<kBf>(lam_j), eb[qi]);
                ec[c] = fmaf(ge, op<kBf>(mu_q), ec[c]);
              }
              apply_loaded(a, w + o, vw + o, ld(w + o), ld(vw + o), gw, m, a.lr, true);
            }
          }
          if (enh) {  // the unit's shares: gW_e lam per row, gW_e^T mu per column
#pragma unroll
            for (int qi = 0; qi < 4; ++qi) {
              const float tot = warp_sum(eb[qi]);
              if (lane == 0 && qb + qi < nq) f32at(L.ep)[cg * tv + qb + qi] = tot;
            }
#pragma unroll
            for (int c = 0; c < 2; ++c)
              if (j0 + 32 * c < nj) f32at(L.pq)[(qb / 4) * th + j0 + 32 * c] = ec[c];
          }
        }
        if (!enh) {
          // b from the threads after the c ones: (rev - nj) mod kRThreads, which
          // stays in [0, kRThreads) also where a tile is wider than the block
          for (int q = ((rev - nj) % kRThreads + kRThreads) % kRThreads; q < nq;
               q += kRThreads) {
            float acc = 0.0f;
            if (lv) {  // the precision-scaled visibles; and z from the A terms
              const float sq = st_lv(i)[q];
              float az = 0.0f;
              for (int r = 0; r < B; ++r) {
                acc += ld(v0 + r * tv + q) * sq - vs[r * tv + q] * sq;
                az += vsst(i)[r * tv + q];
              }
              float gz = sq * (az * inv_b);
              if (!sample_v) gz = gz - 0.5f;  // mean-field: E[(v-b)^2] adds sigma^2
              apply(a, zt(i) + q, vzt(i) + q, gz, m, a.md.lr_z, false);
            } else {
              for (int r = 0; r < B; ++r) acc += ld(v0 + r * tv + q) - vs[r * tv + q];
            }
            apply(a, bt(i) + q, vbt(i) + q, acc * inv_b, m, a.lr, false);
          }
        } else {  // the strip's shares: to the ranks (gb_e) and the strips (gc_e)
          __syncthreads();
          for (int q = tid; q < nq; q += kRThreads) {
            float acc = 0.0f;
            for (int cg = 0; cg < ncg; ++cg) acc += f32at(L.ep)[cg * tv + q];
            pbt(i, static_cast<int>(u & 1))[q] = acc;
          }
          for (int jj = rev; jj < nj; jj += kRThreads) {  // (beside the rows')
            float acc = 0.0f;
            for (int q4 = 0; q4 < nq4; ++q4) acc += f32at(L.pq)[q4 * th + jj];
            __stcg(a.md.pc + static_cast<size_t>(g + i * G) * Hp + j0 + jj, acc);
          }
          __syncthreads();  // the units' shares are free for the next strip
        }
      }
      if (!enh)
        for (int jj = rev; jj < nj; jj += kRThreads) {
          float acc = 0.0f, on = 0.0f;
          for (int r = 0; r < B; ++r) {
            acc += h0p[r * th + jj] - hmean[r * th + jj];
            on += h0p[r * th + jj];
          }
          float gc = acc * inv_b;
          if (a.flags & kSparsity) gc = gc + a.sparsity_cost * (a.sparsity_target - on * inv_b);
          apply(a, c_s + jj, vc_s + jj, gc, m, a.lr, false);
        }
      m_pend = m;
      cp_async_wait_all();  // the next update's rows
      __syncthreads();
      mark();
    }
  }

  if constexpr (kStep) {
    if (g == 0 && persistent)  // the chain out
      for (int idx = tid; idx < CR * nj; idx += kRThreads) {
        const int r = idx / nj, jj = idx - r * nj;
        st(a.st.chain_out + static_cast<size_t>(r) * H + j0 + jj, hcur[r * th + jj]);
      }
    __threadfence();  // the monitor's strip sums, before this block counts itself out
    cluster.sync();   // no block leaves while another may still read its shared memory
    if (tid == 0) {
      const unsigned nblocks = gridDim.x;
      if (atomicAdd(a.st.dep, 1u) == nblocks - 1) {
        // the last block: every block is past its last barrier. The monitor
        // in strip order (the strip sums zeroed for the next launch), and the
        // barrier counters back to zero
        __threadfence();
        float tot = 0.0f;
        for (int s = 0; s < S; ++s) {
          tot += __ldcg(a.mon + s);
          __stcg(a.mon + s, 0.0f);
        }
        const float inv = a.st.inv_norm;
        *a.st.err = pseudo ? tot * inv
                    : xent ? -tot * inv
                           : tot * inv * (1.0f / static_cast<float>(V));
        for (int c = 0; c < T.ranks + (pt ? 1 : 0); ++c) __stcg(a.bar + c, 0u);
        __stcg(a.st.dep, 0u);
        __threadfence();
      }
    }
    return;
  }
  if (enh) {
    // the last update's monitor, gc_e and gb_e: one more barrier of each kind
    tile_arrive(a.bar + rank);
    tile_wait(a.bar + rank, ++nbar * static_cast<unsigned>(G));
    add_monitor(nupd - 1);
    enhanced_c();
    cluster_arrive();
    cluster_wait();
    enhanced_b(nupd - 1);
  } else if (rank == 0) {  // the last update's monitor: one more barrier of the rank-0 tiles
    tile_arrive(a.bar);
    tile_wait(a.bar, ++nbar * static_cast<unsigned>(G));
    add_monitor(nupd - 1);
  }
  // write the state back once
  for (int i = 0; i < mine; ++i) {
    const int q0 = q0_of(i), nq = nq_of(i);
    for (int idx = tid; idx < nq * nj; idx += kRThreads) {
      const int q = idx / nj, jj = idx - q * nj;
      const size_t gi = static_cast<size_t>(q0 + q) * H + j0 + jj;
      a.W[gi] = Wt(i)[q * ldw + jj];
      a.vW[gi] = vWt(i)[q * ldw + jj];
    }
    if (rank == 0)
      for (int q = tid; q < nq; q += kRThreads) {
        a.b[q0 + q] = bt(i)[q];
        a.vb[q0 + q] = vbt(i)[q];
        if (lv) {
          a.md.z[q0 + q] = zt(i)[q];
          a.md.vz[q0 + q] = vzt(i)[q];
        }
      }
  }
  if (g == 0) {
    for (int jj = tid; jj < nj; jj += kRThreads) {
      a.c[j0 + jj] = c_s[jj];
      a.vc[j0 + jj] = vc_s[jj];
    }
    if (persistent)
      for (int idx = tid; idx < CR * nj; idx += kRThreads) {
        const int r = idx / nj, jj = idx - r * nj;
        st(a.chain + static_cast<size_t>(r) * H + j0 + jj, hcur[r * th + jj]);
      }
  }
  cluster.sync();  // no block leaves while another may still read its shared memory
}

// A library holds one variant, chosen when the file is compiled:
// -DMDBN_RESIDENT_MODES=0 the plain estimator, 1 the estimator modes without
// a tempering ladder, 2 with one (kModes); -DMDBN_RESIDENT_STEP=1 the
// data-parallel step of that variant instead of the training run (kStep).
// _build.py builds all six, in parallel.
#ifndef MDBN_RESIDENT_MODES
#define MDBN_RESIDENT_MODES 0
#endif
#ifndef MDBN_RESIDENT_STEP
#define MDBN_RESIDENT_STEP 0
#endif
constexpr int kLibModes = MDBN_RESIDENT_MODES;
constexpr bool kLibStep = MDBN_RESIDENT_STEP;

const void* kernel_fn(bool bf) {
  return bf ? reinterpret_cast<const void*>(&cd_train_resident_kernel<true, kLibModes, kLibStep>)
            : reinterpret_cast<const void*>(&cd_train_resident_kernel<false, kLibModes, kLibStep>);
}

// Lets the kernel ask for up to the card's opt-in shared memory (once per
// kernel and device: changing a kernel's attribute between launches costs a
// wait for the launches before), and gives the clusters of `ranks` blocks
// with that much shared memory each (one block an SM) that fit the card at
// once, asked once per kernel, device and cluster size. `optin` is the card's
// opt-in shared memory per block.
constexpr int kMaxDevices = 16;

cudaError_t max_clusters(bool bf, int device, int ranks, int optin, int* out) {
  static int set[2][kMaxDevices];
  static int known[2][kMaxDevices][kMaxRanks + 1];
  if (device < 0 || device >= kMaxDevices || ranks < 1 || ranks > kMaxRanks)
    return cudaErrorInvalidValue;
  const int kf = bf ? 1 : 0;
  const void* fn = kernel_fn(bf);
  cudaError_t err;
  if (set[kf][device] != optin) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    set[kf][device] = optin;
  }
  if (known[kf][device][ranks] == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ranks);
    cfg.blockDim = dim3(kRThreads);
    cfg.dynamicSmemBytes = optin;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = ranks;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    if ((err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg)) != cudaSuccess) return err;
    known[kf][device][ranks] = n > 0 ? n : -1;
  }
  *out = known[kf][device][ranks] > 0 ? known[kf][device][ranks] : 0;
  return cudaSuccess;
}

// Points the device scratch of `a` into `base` (when not null) and returns
// the floats it takes: the hidden partials [2, S, CR, ranks * th], the
// monitor's strip sums [2, S], the barrier counters [ranks] (tempering: + 1,
// every block's); tempering's log p* terms [S, CR, NT], c.h shares [ranks,
// CR] and the ladder's hidden exchange [2, CR, ranks * th]; the enhanced
// gradient's gW_e^T mu shares [S, ranks * th]; the step's departure
// counter. A buffer of a mode that is off takes none.
long long carve_scratch(Args& a, float* base, const Tiling& t, int B, int M, int flags) {
  const bool pt = flags & kTempering;
  const long long CR = pt ? static_cast<long long>(M) * B : B;
  const long long Hp = static_cast<long long>(t.ranks) * t.th;
  const long long NT = pt ? ((flags & kGaussian) ? 1 : M) : 0;
  long long n = 0;
  auto take = [&](long long count) {
    float* p = base ? base + n : nullptr;
    n += count;
    return p;
  };
  // the modes' buffers start 16-byte aligned (read as float4)
  auto take16 = [&](long long count) {
    if (count > 0) n = (n + 3) / 4 * 4;
    return take(count);
  };
  a.part = take(2LL * t.nstrip * CR * Hp);
  a.mon = take(2LL * t.nstrip);
  a.bar = reinterpret_cast<unsigned*>(take(t.ranks + (pt ? 1 : 0)));
  a.md.lp_part = take16(pt ? t.nstrip * CR * NT : 0);
  a.md.ch_part = take16(pt ? t.ranks * CR : 0);
  a.md.pc = take16((flags & kEnhanced) ? t.nstrip * Hp : 0);
  a.md.hx = take16(pt ? 2 * CR * Hp : 0);
  a.st.dep = reinterpret_cast<unsigned*>(take(kLibStep ? 1 : 0));
  return n;
}

}  // namespace

extern "C" {

// The tiling of a V x H run: out = {tv, th, strips, ranks}.
void cd_train_resident_tiling(int V, int H, int* out) {
  const Tiling t = tiling(V, H);
  out[0] = t.tv;
  out[1] = t.th;
  out[2] = t.nstrip;
  out[3] = t.ranks;
}

// Shared memory bytes a block needs when it holds ns strips (M: the rungs of
// a tempering ladder).
int cd_train_resident_smem_bytes(int V, int H, int B, int M, int flags, int ns) {
  return layout(tiling(V, H), B, (flags & kPersistent) ? 2 : 1, ns,
                static_cast<int>(sizeof(Store)), flags, M).total;
}

// out = {opt-in shared memory per block, clusters of this tiling's ranks
// that fit the card at once}. Sets both compute types' kernels up for
// launch (the attribute and the cluster count, asked once), so a launch
// after this call makes no such request (as a launch captured in a CUDA
// graph must not). Returns a cudaError_t.
int cd_train_resident_limits(int V, int H, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    device)) != cudaSuccess)
    return err;
  int other = 0;
  if ((err = max_clusters(true, device, tiling(V, H).ranks, out[0], &other)) != cudaSuccess)
    return err;
  return max_clusters(false, device, tiling(V, H).ranks, out[0], &out[1]);
}

// Scratch floats the wrapper allocates (zeroed) for one run (carve_scratch).
long long cd_train_resident_scratch_floats(int V, int H, int B, int M, int flags) {
  Args a;
  return carve_scratch(a, nullptr, tiling(V, H), B, M, flags);
}

// Launches the whole run on `stream`: `clusters` clusters of the tiling's
// ranks (<= 0: as many as the card holds at once, balanced over the strips).
// The arguments are cd_train.cu's cd_train_run's, with the cluster count for
// its grid. Returns a cudaError_t (0 on success): cudaErrorInvalidValue for
// strips that do not fit a block's shared memory or a run of another
// variant's (kLibModes),
// cudaErrorCooperativeLaunchTooLarge for more clusters than fit the card or
// than there are strips; neither launches.
int cd_train_resident_run(const Store* data, const int* order, const float* u_h0,
                          const float* u_h, const float* u_v, const float* u_swap,
                          const float* betas, Store* W, Store* b, Store* c, Store* vW, Store* vb,
                          Store* vc, Store* z, Store* vz, Store* chain, float* errs,
                          float* scratch, unsigned long long* trace, int V, int H, int B, int M,
                          int nb, int E, int k, int start_epoch, int switch_epoch, int flags,
                          float lr, float lr_z, float momentum, float initial_momentum, float l2,
                          float grad_clip, float sparsity_target, float sparsity_cost,
                          unsigned long long seed, int device, int clusters, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool modes = flags & kModeFlags, pt = flags & kTempering;
  if (kLibStep || (pt && M < 2) || (pt ? 2 : modes ? 1 : 0) != kLibModes)
    return cudaErrorInvalidValue;
  const bool bf = flags & kBf16;
  const Tiling t = tiling(V, H);
  int optin = 0;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
      cudaSuccess)
    return err;
  const int nseg = (flags & kPersistent) ? 2 : 1;
  int maxc = 0;
  if ((err = max_clusters(bf, device, t.ranks, optin, &maxc)) != cudaSuccess) return err;
  if (clusters <= 0) {
    const int per = cdiv(t.nstrip, maxc > 0 ? maxc : 1);
    clusters = cdiv(t.nstrip, per);
  }
  if (clusters > maxc || clusters > t.nstrip) return cudaErrorCooperativeLaunchTooLarge;
  const int ns = cdiv(t.nstrip, clusters);
  const Layout L = layout(t, B, nseg, ns, static_cast<int>(sizeof(Store)), flags, M);
  if (L.total > optin) return cudaErrorInvalidValue;
  const int smem = L.total > kMinSmem ? L.total : (kMinSmem < optin ? kMinSmem : optin);

  Args a;
  a.data = data; a.order = order; a.u_h0 = u_h0; a.u_h = u_h; a.u_v = u_v;
  a.W = W; a.b = b; a.c = c; a.vW = vW; a.vb = vb; a.vc = vc; a.chain = chain; a.errs = errs;
  carve_scratch(a, scratch, t, B, M, flags);
  a.trace = trace;
  a.V = V; a.H = H; a.B = B; a.nb = nb; a.E = E; a.k = k;
  a.start_epoch = start_epoch; a.switch_epoch = switch_epoch; a.flags = flags;
  a.lr = lr; a.momentum = momentum; a.initial_momentum = initial_momentum; a.l2 = l2;
  a.grad_clip = grad_clip; a.sparsity_target = sparsity_target;
  a.sparsity_cost = sparsity_cost; a.seed = seed;
  a.t = t; a.L = L; a.clusters = clusters;
  a.md.u_swap = u_swap; a.md.betas = betas; a.md.z = z; a.md.vz = vz;
  a.md.M = pt ? M : 1;
  a.md.CR = pt ? M * B : B;
  a.md.NT = pt ? ((flags & kGaussian) ? 1 : M) : 0;
  a.md.lr_z = lr_z;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * t.ranks);
  cfg.blockDim = dim3(kRThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = t.ranks;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;  // every block resident at once
  attrs[1].val.cooperative = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  void* params[] = {&a};
  if ((err = cudaLaunchKernelExC(&cfg, kernel_fn(bf), params)) != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launches one data-parallel step on `stream` (a library built with
// -DMDBN_RESIDENT_STEP=1): `clusters` clusters as cd_train_resident_run
// takes them; the statistics into the flat buffer `out`
// (ops/cd_grads_cuda.py::flat_size), the PCD chain into chain_out. data:
// the step's rows [B, V], or with `tab` ({minibatch, seed, pseudo bit} in
// device memory, read at entry) the minibatches [*, B, V] it indexes; seed
// and bit are used without `tab`. mask: [B] of 0/1 or null. `scratch`
// (cd_train_resident_scratch_floats) is zero before the first launch and
// left zero by each. Returns a cudaError_t (0 on success), as
// cd_train_resident_run; a library of the training run returns
// cudaErrorInvalidValue without launching.
int cd_grads_resident_step(const Store* data, const long long* tab, const float* mask,
                           const float* u_h0, const float* u_h, const float* u_v,
                           const float* u_swap, const float* betas, const Store* W,
                           const Store* b, const Store* c, const Store* z,
                           const Store* chain_in, float* out, Store* chain_out, float* scratch,
                           unsigned long long* trace, int V, int H, int B, int M, int k,
                           int flags, int bit, float inv_norm, float sparsity_target,
                           float sparsity_cost, unsigned long long seed, int device,
                           int clusters, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool modes = flags & kModeFlags, pt = flags & kTempering;
  if (!kLibStep || (pt && M < 2) || (pt ? 2 : modes ? 1 : 0) != kLibModes)
    return cudaErrorInvalidValue;
  const bool bf = flags & kBf16;
  const Tiling t = tiling(V, H);
  static int optin[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (optin[device] == 0 &&
      (err = cudaDeviceGetAttribute(&optin[device], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    device)) != cudaSuccess)
    return err;
  int maxc = 0;
  if ((err = max_clusters(bf, device, t.ranks, optin[device], &maxc)) != cudaSuccess) return err;
  if (clusters <= 0) {
    const int per = cdiv(t.nstrip, maxc > 0 ? maxc : 1);
    clusters = cdiv(t.nstrip, per);
  }
  if (clusters > maxc || clusters > t.nstrip) return cudaErrorCooperativeLaunchTooLarge;
  const int ns = cdiv(t.nstrip, clusters);
  const Layout L = layout(t, B, (flags & kPersistent) ? 2 : 1, ns, static_cast<int>(sizeof(Store)),
                          flags, M);
  if (L.total > optin[device]) return cudaErrorInvalidValue;
  const int smem = L.total > kMinSmem ? L.total
                                      : (kMinSmem < optin[device] ? kMinSmem : optin[device]);

  const long long nW = static_cast<long long>(V) * H;
  Args a = {};
  a.data = data; a.u_h0 = u_h0; a.u_h = u_h; a.u_v = u_v;
  a.W = const_cast<Store*>(W); a.b = const_cast<Store*>(b); a.c = const_cast<Store*>(c);
  a.chain = const_cast<Store*>(chain_in);
  carve_scratch(a, scratch, t, B, M, flags);
  a.trace = trace;
  a.V = V; a.H = H; a.B = B; a.nb = 1; a.E = 1; a.k = k;
  a.start_epoch = 0; a.switch_epoch = 0; a.flags = flags;
  a.sparsity_target = sparsity_target; a.sparsity_cost = sparsity_cost; a.seed = seed;
  a.t = t; a.L = L; a.clusters = clusters;
  a.md.u_swap = u_swap; a.md.betas = betas; a.md.z = const_cast<Store*>(z);
  a.md.M = pt ? M : 1;
  a.md.CR = pt ? M * B : B;
  a.md.NT = pt ? ((flags & kGaussian) ? 1 : M) : 0;
  a.st.tab = tab; a.st.mask = mask;
  a.st.gW = out; a.st.gb = out + nW; a.st.gc = out + nW + V;
  float* extra = out + nW + V + H;
  a.st.gz = (flags & kLearnVar) ? extra : nullptr;
  a.st.mu = (flags & kEnhanced) ? extra : nullptr;
  a.st.lam = (flags & kEnhanced) ? extra + V : nullptr;
  a.st.h0m = (flags & kEnhanced) ? extra + V + H : nullptr;
  a.st.err = extra + ((flags & kLearnVar) ? V : 0) + ((flags & kEnhanced) ? V + 2 * H : 0);
  a.st.chain_out = chain_out;
  a.st.inv_norm = inv_norm; a.st.bit = bit;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * t.ranks);
  cfg.blockDim = dim3(kRThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = t.ranks;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;  // every block resident at once
  attrs[1].val.cooperative = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  void* params[] = {&a};
  if ((err = cudaLaunchKernelExC(&cfg, kernel_fn(bf), params)) != cudaSuccess) return err;
  return cudaGetLastError();
}

const char* cd_train_resident_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
