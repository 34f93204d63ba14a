// The W-blocked data-parallel update (csrc/cd_grads_wide.cu's second launch),
// designed for Hopper as a stream over W: every rank forms the global gW
// from every rank's gathered factors and updates W, b, c and their
// velocities in place.
//
// Replaces: the per-source gradient and the update of
// mdbn_tpu/ops/cd_epoch_pallas.py::_cd_train_kernel_wb with ndev > 1
// (:2298-2333, then its update).
//
// What it computes (unchanged from the update it replaces): over the R global
// rows of the gathered slots in rank order, v0 from the global minibatch,
//   gW = (v0^T h0p - vs^T hmean) / R, gb = sum_r (v0_r - vs_r) / R,
//   gc = sum_r (h0p_r - hmean_r) / R [+ cost (target - sum_r h0p_r / R)],
// then clip, L2 (W only) and momentum, the velocity rounded once into Store
// and the parameter old + velocity rounded once; err = the slots' errs summed
// in rank order times 1 / ranks.
//
// What bounds it on an H100: the bytes. W is read and written and its
// velocity written (and read under momentum) once: 96 MB at 20000x400 f32,
// 240 MB at 40000x1000 bf16, against gW's 2 * 2R * V * H operations (0.6 and
// 3.2 GFLOP at R = 20), far below either peak of the card. The update it
// replaces took 16-row strips with a block barrier each, staged every strip's
// v0 and vs columns from R separate rows, and summed bf16 operands on FFMA.
//
// Design:
// - A tile is kTQ = 16 rows of W across all H columns, contiguous in device
//   memory. Each block walks the tiles blockIdx.x, + grid, ... (one block of
//   256 threads an SM, or two of 128 where Y and two stages fit half an SM,
//   so that one block's memory traffic overlaps the other's sums), and a
//   ring of up to kMaxStages stages in shared memory holds the
//   next tiles' W (and vW under momentum) and their operand X, filled a few
//   tiles ahead: W's tile by one TMA bulk copy on the stage's mbarrier, X's
//   rows by cp.async groups; one block barrier a tile. The new W and vW
//   leave from registers.
// - gW's tile is X^T Y with the K = 2R rows interleaved, X = [v0_0; vs_0;
//   v0_1; vs_1; ...] (kTQ columns of the tile) and Y = [h0p_0; -hmean_0;
//   ...] (all H columns; the slots hold -hmean), so one sum holds pos - neg
//   and a chunk of K holds whole pairs. Y is staged once a block where it
//   fits (80 KB at 40000x1000 bf16), converted to the compute dtype.
// - bf16 compute: mma.sync.m16n8k16 (bf16 operands, f32 sums), K padded to
//   a multiple of 16. A warp's unit is 16 rows x 32 columns, four n8 blocks
//   whose columns are permuted in Y's staged fragments so that a lane's
//   accumulators are 8 adjacent columns of W: the update runs on them in
//   registers and writes 128 bits at a time.
// - f32 compute: register-blocked FFMA, a thread 8 rows x 4 columns, the
//   sum over K in order (f32 semantics hold: no tensor-core rounding).
// - gb: kTQ threads each sum a tile row's R differences in row order; gc:
//   one warp a column on the blocks that walk one tile fewer, a fixed
//   butterfly. No atomics, a fixed order everywhere: grids 1, 7, 132 and the
//   default give the same bits.
// - Y's rows arrive by TMA bulk copies on mbarriers while the ring's first
//   stage comes in (at bf16 compute through the ring's other stages, two
//   chunks in flight, converted from there).
// Every other shape, where Y does not fit with a ring (large R at wide H) or
// a row of X or W is not whole 16-byte pieces, runs K in chunks staged tile
// by tile with plain loads and W read from device memory (update_plan:
// resident 0), slowly but to the same sums.

#pragma once

#include "cd_wide_phases.cuh"

namespace {

constexpr int kTQ = 16;            // rows of W a tile
constexpr int kUCols = 32;         // columns of a warp's unit (bf16 compute): four n8 blocks
constexpr int kUPass = 4;          // units a warp holds at once
constexpr int kFQ = 8;             // f32 compute: rows an item holds
constexpr int kFJ = 4;             // f32 compute: columns an item holds
constexpr int kMaxStages = 4;
constexpr int kBarBytes = 48;  // mbarriers: Y's two buffers', then each stage's
constexpr int kReservedPerBlock = 1024;  // shared memory the card keeps for each block

// How the update uses a block's shared memory (ops/cd_grads_wide_cuda.py::
// update_plan mirrors it).
struct UpdatePlan {
  int threads;     // a block's threads: 256, or 128 with two blocks an SM
  int stages;      // ring stages (0: chunked, no ring)
  int resident;    // Y staged once a block, X and W (and vW) through the ring
  int kp;          // K rows of Y: 2R, padded to 16 at bf16 compute
  int kc;          // K rows staged at once (kp when resident)
  int smem_bytes;  // dynamic shared memory of a block
  int ok;          // 0 when no chunk of K fits
};

// Bytes of k rows of Y as staged: bf16 fragments of 32-column units, or f32
// rows padded to 4 columns.
__host__ __device__ inline long long y_row_bytes(bool bf, int H) {
  return bf ? round_up(H, kUCols) * 2 : round_up(H, 4) * 4;
}

// limit: the shared memory a block may opt in to; per_sm: an SM's, whose half
// (less the 1 KB the card reserves a block) two blocks of 128 threads each
// take where Y and two stages fit it, so that one block's loads and stores
// overlap the other's sums; else one block of 256 threads an SM. aligned:
// the pointers are 16-byte aligned; the rows of X (V values) and of W and Y
// (H values) must be whole 16-byte pieces too for the resident plan's copies.
inline UpdatePlan update_plan(int V, int H, int R, bool bf, bool vel, bool aligned, int limit,
                              int per_sm) {
  UpdatePlan p{kThreads, 0, 0, 0, 0, 0, 0};
  const long long s = sizeof(Store), k2 = 2LL * R;
  p.kp = static_cast<int>(bf ? round_up(k2, 16) : k2);
  const long long y = p.kp * y_row_bytes(bf, H);
  const long long x = round_up(k2 * kTQ * s, 16);
  const long long w = round_up(kTQ * static_cast<long long>(H) * s, 16) * (vel ? 2 : 1);
  if (aligned && (static_cast<long long>(V) * s) % 16 == 0 && (H * s) % 16 == 0) {
    const long long half = per_sm / 2 - kReservedPerBlock;
    for (int two = 1; two >= 0; --two)
      for (int st = kMaxStages; st >= 2; --st) {
        const long long need = kBarBytes + y + st * (x + w);
        if (need <= (two ? std::min<long long>(half, limit) : limit)) {
          p.threads = two ? kThreads / 2 : kThreads; p.stages = st; p.resident = 1;
          p.kc = p.kp; p.smem_bytes = static_cast<int>(need); p.ok = 1;
          return p;
        }
      }
  }
  const long long unit = bf ? 16 : 2, per = y_row_bytes(bf, H) + kTQ * s;
  const long long kc = std::min<long long>(p.kp, limit / per / unit * unit);
  if (kc < unit) return p;
  p.kc = static_cast<int>(kc);
  p.smem_bytes = static_cast<int>(kc * per);
  p.ok = 1;
  return p;
}

// Every rank's rows of the gather buffer in rank order: row r is row r % lb
// of rank r / lb.
struct Gathered {
  const unsigned char* buf;  // [ndev, slot_bytes]
  long long slot_bytes, vs, h, err;  // a slot's bytes, the offsets of vs, the h-matrix, err
  int lb;
};

struct UpdateArgs {
  Store* W;        // [V, H], in place
  Store* b;        // [V]
  Store* c;        // [H]
  Store* vW;       // velocities, in place
  Store* vb;
  Store* vc;
  float* err;      // [1]: the update's mean monitor
  const Store* v0;  // [R, V] the global minibatch (with tab: the minibatches it indexes)
  const long long* tab;  // optional: tab[0] picks the minibatch, v0 + tab[0] * v0_stride
  long long v0_stride;
  const float* mom;     // optional [1]: the momentum, read in place of m
  unsigned long long* trace;  // optional [8]: block 0's stamps (cd_wide_update_kernel)
  int V, H, R, ndev, flags;
  UpdatePlan plan;
  float lr, m, scale, l2, grad_clip, sparsity_target, sparsity_cost;
};

// Row k of X (k = 2r: v0 row r; k = 2r + 1: vs row r), as Store values.
__device__ __forceinline__ const Store* x_row(const Store* v0, const Gathered& g, int V, int k) {
  const int r = k >> 1;
  if (!(k & 1)) return v0 + static_cast<size_t>(r) * V;
  const int d = r / g.lb;
  return reinterpret_cast<const Store*>(g.buf + d * g.slot_bytes + g.vs) +
         static_cast<size_t>(r - d * g.lb) * V;
}

// Row k of Y (h0p row r, or the slot's -hmean row r), f32.
__device__ __forceinline__ const float* y_row(const Gathered& g, int H, int k) {
  const int r = k >> 1, d = r / g.lb;
  return reinterpret_cast<const float*>(g.buf + d * g.slot_bytes + g.h) +
         static_cast<size_t>((k & 1) * g.lb + r - d * g.lb) * H;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Stages Y's rows [k0, k0 + kc) of all H columns into ys, converted: bf16
// compute, as the B fragments of mma.sync.m16n8k16 in the order the units
// read them ([unit][k step][half][lane][4 words]: half h holds n8 blocks 2h
// and 2h + 1, b0 and b1 each), column c of n8 block nb of unit u being W's
// column u * 32 + (c >> 1) * 8 + nb * 2 + (c & 1); f32 compute, rows of
// round_up(H, 4) floats. Rows past 2R and columns past H are zero.
template <bool kBf>
__device__ __forceinline__ void stage_y(unsigned char* ys, const Gathered& g, int H, int R, int k0, int kc) {
  const int k2 = 2 * R;
  if constexpr (kBf) {
    const int hp = static_cast<int>(round_up(H, kUCols)), ks = kc / 16;
    unsigned* out = reinterpret_cast<unsigned*>(ys);
    const long long n = static_cast<long long>(kc / 2) * hp;
    for (long long idx = threadIdx.x; idx < n; idx += blockDim.x) {
      const int p = static_cast<int>(idx / hp), j = static_cast<int>(idx - static_cast<long long>(p) * hp);
      const int k = k0 + 2 * p;
      const float y0 = (k < k2 && j < H) ? y_row(g, H, k)[j] : 0.0f;
      const float y1 = (k + 1 < k2 && j < H) ? y_row(g, H, k + 1)[j] : 0.0f;
      const int kk = 2 * p % 16, step = 2 * p / 16, which = kk >> 3, t = (kk & 7) >> 1;
      const int u = j / kUCols, jj = j % kUCols, nb = (jj >> 1) & 3;
      const int lane = ((((jj >> 3) << 1) | (jj & 1)) << 2) | t;
      const int word = ((nb & 1) << 1) | which;
      out[((static_cast<size_t>(u * ks + step) * 2 + (nb >> 1)) * 32 + lane) * 4 + word] =
          pack_bf16(y0, y1);
    }
  } else {
    const int hs = static_cast<int>(round_up(H, 4));
    float* out = reinterpret_cast<float*>(ys);
    const long long n = static_cast<long long>(kc) * hs;
    for (long long idx = threadIdx.x; idx < n; idx += blockDim.x) {
      const int kr = static_cast<int>(idx / hs), j = static_cast<int>(idx - static_cast<long long>(kr) * hs);
      const int k = k0 + kr;
      out[idx] = (k < k2 && j < H) ? y_row(g, H, k)[j] : 0.0f;
    }
  }
}

// An mbarrier in shared memory, completed by TMA bulk copies (their bytes).
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Warp 0 starts TMA copies of Y's f32 rows [k0, k1) (all below 2R, rows of H
// floats, H % 4 == 0) into dst, completing on bar (lane 0 arms it).
__device__ __forceinline__ void copy_y_rows(float* dst, const Gathered& g, int H, int k0, int k1,
                            unsigned long long* bar) {
  if (threadIdx.x >= 32) return;
  const unsigned row = static_cast<unsigned>(H) * 4;
  if (threadIdx.x == 0) mbar_expect(bar, row * (k1 - k0));
  __syncwarp();
  for (int k = k0 + static_cast<int>(threadIdx.x); k < k1; k += 32)
    bulk_copy(dst + static_cast<size_t>(k - k0) * H, y_row(g, H, k), row, bar);
}

// Half k steps (8 rows of Y, f32) the bounce holds at bf16 compute: the
// ring's stages but the first, which the ring fills only after Y is staged
// (at least one: a stage's W tile alone is 16 rows of H bf16 values).
__device__ __forceinline__ int y_halves(int H, int stages, long long stage_bytes) {
  return static_cast<int>((stages - 1) * stage_bytes / (8LL * H * 4));
}

// The bounce's chunks at bf16 compute: two buffers of `halves` / 2 half k
// steps each where it holds two, so that one chunk's copies overlap the
// other's conversion; else one buffer of one.
struct YChunks {
  int bufs, rows;  // buffers, Y rows a chunk
  __device__ YChunks(int halves) : bufs(halves >= 2 ? 2 : 1), rows(8 * (halves >= 2 ? halves / 2 : 1)) {}
};

// Starts the TMA copies of Y before the ring starts: at f32 compute all its
// rows straight into ys (on bar[0]), at bf16 compute the first chunk of each
// bounce buffer (buffer i on bar[i]).
template <bool kBf>
__device__ __forceinline__ void start_y_async(unsigned char* ys, unsigned char* bounce,
                                              const Gathered& g, int H, int R, int halves,
                                              unsigned long long* bar) {
  if constexpr (kBf) {
    const YChunks ch(halves);
    for (int i = 0; i < ch.bufs && i * ch.rows < 2 * R; ++i)
      copy_y_rows(reinterpret_cast<float*>(bounce) + static_cast<size_t>(i) * ch.rows * H, g, H,
                  i * ch.rows, min((i + 1) * ch.rows, 2 * R), bar + i);
  } else {
    copy_y_rows(reinterpret_cast<float*>(ys), g, H, 0, 2 * R, bar);
  }
}

// Completes the resident Y (the layout of stage_y) from the copies of
// start_y_async: at f32 compute waits for them; at bf16 compute converts Y
// chunk by chunk (YChunks) from the bounce into its fragments, a word pair of
// each (unit, half, lane) a thread, and starts a buffer's next chunk once it
// is read.
template <bool kBf>
__device__ __forceinline__ void finish_y_async(unsigned char* ys, unsigned char* bounce,
                                               const Gathered& g, int H, int R, int kp,
                                               int halves, unsigned long long* bar) {
  if constexpr (!kBf) {
    mbar_wait(bar, 0);
  } else {
    const int k2 = 2 * R, ks = kp / 16, nunit = static_cast<int>(round_up(H, kUCols)) / kUCols;
    const YChunks ch(halves);
    unsigned* out = reinterpret_cast<unsigned*>(ys);
    for (int c = 0, k0 = 0; k0 < kp; ++c, k0 += ch.rows) {  // chunk c: rows [k0, k0 + rows)
      const int buf = c % ch.bufs;
      const float* src = reinterpret_cast<const float*>(bounce) + static_cast<size_t>(buf) * ch.rows * H;
      if (k0 < k2) mbar_wait(bar + buf, (c / ch.bufs) & 1);
      for (int hs = k0 / 8; hs < min(k0 + ch.rows, kp) / 8; ++hs) {  // its half k steps
        const int which = hs & 1, step = hs >> 1;
        for (int r = threadIdx.x; r < nunit * 64; r += blockDim.x) {
          const int u = r >> 6, h = (r >> 5) & 1, lane = r & 31, gq = lane >> 2, t = lane & 3;
          const int k = 8 * hs + 2 * t;
          const float* y = src + static_cast<size_t>(k - k0) * H;
          unsigned* o = out + ((static_cast<size_t>(u * ks + step) * 2 + h) * 32 + lane) * 4 + which;
          const int j0 = u * kUCols + (gq >> 1) * 8 + 4 * h + (gq & 1);  // n8 block 2h's column
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // word `which` (n8 block 2h), then 2 + which (2h + 1)
            const int j = j0 + 2 * e;
            const float y0 = (k < k2 && j < H) ? y[j] : 0.0f;
            const float y1 = (k + 1 < k2 && j < H) ? y[H + j] : 0.0f;
            o[2 * e] = pack_bf16(y0, y1);
          }
        }
      }
      __syncthreads();  // the buffer is read
      const int next = k0 + ch.bufs * ch.rows;  // this buffer's next chunk
      if (next < k2)
        copy_y_rows(const_cast<float*>(src), g, H, next, min(next + ch.rows, k2), bar + buf);
    }
  }
}

// X's rows [k0, k0 + kc) of the tile's kTQ columns into xs [kc][kTQ] Store,
// plain loads (the chunked plan); zeros past row 2R and column V.
__device__ __forceinline__ void stage_x(Store* xs, const Store* v0, const Gathered& g, int V, int R, int q0,
                        int k0, int kc) {
  for (int idx = threadIdx.x; idx < kc * kTQ; idx += blockDim.x) {
    const int k = k0 + idx / kTQ, q = q0 + idx % kTQ;
    st(xs + idx, (k < 2 * R && q < V) ? ld(x_row(v0, g, V, k) + q) : 0.0f);
  }
}

// Starts the cp.async copies of X's 2R rows of tile `tile`'s columns into its
// stage (kTQ Store values a row, zeros past V).
__device__ __forceinline__ void start_x_rows(unsigned char* stage, const UpdateArgs& a,
                                             const Store* v0, const Gathered& g, int tile) {
  const int q0 = tile * kTQ, V = a.V, k2 = 2 * a.R;
  constexpr int npr = kTQ * static_cast<int>(sizeof(Store)) / 16;  // pieces a row of X
  const int xvalid = min(kTQ, V - q0) * static_cast<int>(sizeof(Store));
  for (int pc = threadIdx.x; pc < k2 * npr; pc += blockDim.x) {
    const int k = pc / npr, b = (pc - k * npr) * 16;
    const char* src = reinterpret_cast<const char*>(x_row(v0, g, V, k) + q0);
    const int n = max(0, min(16, xvalid - b));
    cp_async16(stage + k * kTQ * sizeof(Store) + b, n > 0 ? src + b : src, n);
  }
}

// Warp 0 starts the TMA copies of tile `tile`'s W rows (and vW's under
// momentum) into its stage, completing on `bar`: one copy each of the
// tile's rows (whole 16-byte pieces in the resident plan). Rows past V
// keep what the stage held; they enter only rows of gW that are not stored.
__device__ __forceinline__ void start_tiles_tma(unsigned char* stage, const UpdateArgs& a,
                                                int tile, long long xbytes, long long wbytes,
                                                bool vel, unsigned long long* bar) {
  const int lane = threadIdx.x & 31, q0 = tile * kTQ, rows = min(kTQ, a.V - q0);
  const unsigned wb = static_cast<unsigned>(static_cast<long long>(rows) * a.H * sizeof(Store));
  const size_t off = static_cast<size_t>(q0) * a.H;
  if (lane == 0) {
    mbar_expect(bar, wb * (vel ? 2 : 1));
    bulk_copy(stage + xbytes, a.W + off, wb, bar);
  }
  __syncwarp();
  if (vel && lane == 1) bulk_copy(stage + xbytes + wbytes, a.vW + off, wb, bar);
}

// d += A B on one n8 block: A the 16x16 bf16 fragment a, B's b0, b1.
__device__ __forceinline__ void mma_16816(float& d0, float& d1, float& d2, float& d3,
                                         const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// N adjacent values of a Store array as floats and back (each rounded once
// into Store); p is 16-byte aligned (N 8, or 4 of f32) or 8-byte (4 of bf16).
template <int N>
__device__ __forceinline__ void ld_vec(const float* p, float (&o)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + i);
    o[i] = x.x; o[i + 1] = x.y; o[i + 2] = x.z; o[i + 3] = x.w;
  }
}
template <int N>
__device__ __forceinline__ void ld_vec(const __nv_bfloat16* p, float (&o)[N]) {
  unsigned w[N / 2];
  if constexpr (N == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x; w[1] = x.y;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
template <int N>
__device__ __forceinline__ void st_vec(float* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
template <int N>
__device__ __forceinline__ void st_vec(__nv_bfloat16* p, const float (&v)[N]) {
  unsigned w[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) w[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
  if constexpr (N == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// The update of N adjacent elements of W (row q, columns j..j + N) from
// their gradients g (gW before 1 / R), the old values read from ow / ov
// (the ring's tile, or W and vW themselves), the new ones stored into dw /
// dv (W and vW). vec: N whole columns, aligned; else element by element up
// to H.
template <int N, bool kVel>
__device__ __forceinline__ void update_run(const UpdateArgs& a, const Store* ow, const Store* ov,
                                           Store* dw, Store* dv, int j, const float (&g)[N],
                                           float inv_b, float m, bool vec) {
  float old[N], old_vel[N], nv[N], np[N];
  if (vec && j + N <= a.H) {
    ld_vec<N>(ow, old);
    if (kVel) ld_vec<N>(ov, old_vel);
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (!kVel) old_vel[c] = 0.0f;
      apply_value(a, old[c], old_vel[c], g[c] * inv_b, m, a.lr, true, nv[c], np[c]);
    }
    st_vec<N>(dv, nv);
    st_vec<N>(dw, np);
    return;
  }
#pragma unroll
  for (int c = 0; c < N; ++c) {
    if (j + c >= a.H) break;
    const float o = ld(ow + c), ovel = kVel ? ld(ov + c) : 0.0f;
    apply_value(a, o, ovel, g[c] * inv_b, m, a.lr, true, nv[c], np[c]);
    st(dv + c, nv[c]);
    st(dw + c, np[c]);
  }
}

// c: one warp a column (warp gwarp of nwarps), the rows by lane then a fixed
// butterfly (cd_wide_phases.cuh's update_units, the same sums).
__device__ __forceinline__ void update_c(const UpdateArgs& a, const Gathered& g, float m, float inv_b, int gwarp,
                         int nwarps) {
  const int lane = threadIdx.x & 31;
  for (int o = gwarp; o < a.H; o += nwarps) {
    float acc = 0.0f, on = 0.0f;
    for (int r = lane; r < a.R; r += 32) {
      const float hp = y_row(g, a.H, 2 * r)[o];
      const float hm = -y_row(g, a.H, 2 * r + 1)[o];
      acc += hp - hm;
      on += hp;
    }
    acc = warp_sum(acc);
    on = warp_sum(on);
    if (lane != 0) continue;
    float gr = acc * inv_b;
    if (a.flags & kSparsity) gr = gr + a.sparsity_cost * (a.sparsity_target - on * inv_b);
    apply(a, a.c + o, a.vc + o, gr, m, a.lr, false);
  }
}

__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages >= 4)
    cp_async_wait<2>();
  else if (stages == 3)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// The update (see the top of this file). Trace (block 0, thread 0, ns on the
// global timer): [0] entry, [1] Y staged and the ring started, then summed
// over the block's tiles [2] waiting for the ring's stages (the tile
// pipeline), [3] the sums, [4] the update of W and b; [5] the tiles done,
// [6] exit (after c where block 0 takes part in it), [7] the block's tiles.
// The resident plan: the ring of TMA and cp.async stages and Y staged once;
// else K in chunks, W read from device memory.
template <bool kBf, bool kVel>
__global__ void __launch_bounds__(kThreads, 1)
    cd_wide_update_kernel(const __grid_constant__ UpdateArgs args,
                          const __grid_constant__ Gathered gathered) {
  // local copies: read through a reference, a field would be loaded again
  // after every store (cd_wide_phases.cuh's WIDE_PHASE note)
  const UpdateArgs a = args;
  const Gathered g = gathered;
  unsigned char* const smem = reinterpret_cast<unsigned char*>(cd_wide_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned long long* const tr = (a.trace && blockIdx.x == 0 && tid == 0) ? a.trace : nullptr;
  unsigned long long t_last = tr ? globaltimer_ns() : 0, t_wait = 0, t_sums = 0, t_upd = 0;
  if (tr) tr[0] = t_last;
  const UpdatePlan plan = a.plan;
  const int V = a.V, H = a.H, R = a.R, grid = static_cast<int>(gridDim.x);
  const float m = a.mom ? *a.mom : a.m, inv_b = 1.0f / static_cast<float>(R);
  const Store* const v0 = a.v0 + (a.tab ? a.tab[0] * a.v0_stride : 0LL);
  const int ntiles = (V + kTQ - 1) / kTQ, k2 = 2 * R;
  const long long s = sizeof(Store);
  const long long ybytes = plan.kc * y_row_bytes(kBf, H);
  const long long xbytes = plan.resident ? round_up(k2 * kTQ * s, 16) : plan.kc * kTQ * s;
  const long long wbytes = round_up(kTQ * static_cast<long long>(H) * s, 16);
  const long long stage_bytes = xbytes + (plan.resident ? wbytes * (kVel ? 2 : 1) : 0);
  unsigned long long* const bar = reinterpret_cast<unsigned long long*>(smem);
  unsigned char* const ys = smem + (plan.resident ? kBarBytes : 0);
  unsigned char* const ring = ys + ybytes;  // the stages, or X's chunk
  // the ring's loads: X's rows by cp.async groups; W's tile (and vW's) by one
  // TMA bulk copy each on the stage's mbarrier
  unsigned long long* const full = bar + 2;  // after Y's two
  auto start = [&](int st, int tile) {
    unsigned char* const stage = ring + st * stage_bytes;
    start_x_rows(stage, a, v0, g, tile);
    if (warp == 0) start_tiles_tma(stage, a, tile, xbytes, wbytes, kVel, full + st);
  };
  if (plan.resident) {
    // Y by TMA on its mbarrier (at bf16 compute through the ring's stages but
    // the first) while the ring's first stage comes in; its other stages once
    // Y is staged
    unsigned char* const bounce = ring + stage_bytes;
    const int halves = y_halves(H, plan.stages, stage_bytes);
    if (tid == 0)
      for (int i = 0; i < 2 + plan.stages; ++i) mbar_init(bar + i);
    __syncthreads();
    start_y_async<kBf>(ys, bounce, g, H, R, halves, bar);
    for (int st = 0; st < plan.stages - 1; ++st) {
      if (st == 1 && kBf)  // the bounce is read before the ring fills it
        finish_y_async<kBf>(ys, bounce, g, H, R, plan.kc, halves, bar);
      const int tile = blockIdx.x + st * grid;
      if (tile < ntiles) start(st, tile);
      cp_async_commit();
    }
    if (!kBf || plan.stages == 2) finish_y_async<kBf>(ys, bounce, g, H, R, plan.kc, halves, bar);
  }
  if (tr) tr[1] = t_last = globaltimer_ns();

  const bool vec = (H * s) % 16 == 0 && aligned16(a.W) && aligned16(a.vW);
  const int nthr = static_cast<int>(blockDim.x), nwarps = nthr >> 5;  // plan.threads
  const int qb = tid - (nthr - kTQ);  // the b thread's row of the tile (when >= 0)
  const int nunit = (H + kUCols - 1) / kUCols, ngj = (H + kFJ - 1) / kFJ;
  const int npass = kBf ? (nunit + nwarps * kUPass - 1) / (nwarps * kUPass)
                        : (2 * ngj + nthr - 1) / nthr;
  const int nchunk = plan.resident ? 1 : (plan.kp + plan.kc - 1) / plan.kc;
  int ntile_block = 0;
  for (int i = 0, tile = blockIdx.x; tile < ntiles; ++i, tile += grid, ++ntile_block) {
    const int q0 = tile * kTQ;
    unsigned char* stage = ring + (plan.resident ? (i % plan.stages) * stage_bytes : 0);
    if (plan.resident) {
      cp_async_wait_ring(plan.stages);
      __syncthreads();  // this tile's cp.async copies are in; the last tile's stage is read
      const int nxt = tile + (plan.stages - 1) * grid;
      if (nxt < ntiles) start((i + plan.stages - 1) % plan.stages, nxt);
      cp_async_commit();
      mbar_wait(full + i % plan.stages, (i / plan.stages) & 1);  // its TMA copies
    }
    if (tr) {
      const unsigned long long t = globaltimer_ns();
      t_wait += t - t_last;
      t_last = t;
    }
    const Store* const xs = reinterpret_cast<const Store*>(stage);
    const Store* const tw = plan.resident ? reinterpret_cast<const Store*>(stage + xbytes)
                                          : a.W + static_cast<size_t>(q0) * H;
    const Store* const tv = plan.resident ? reinterpret_cast<const Store*>(stage + xbytes + wbytes)
                                          : a.vW + static_cast<size_t>(q0) * H;
    Store* const dw = a.W + static_cast<size_t>(q0) * H;  // where the new values go
    Store* const dv = a.vW + static_cast<size_t>(q0) * H;
    const bool own = qb >= 0 && q0 + qb < V;
    const float ob = own ? ld(a.b + q0 + qb) : 0.0f;
    const float ovb = own ? ld(a.vb + q0 + qb) : 0.0f;
    float dsum = 0.0f;  // the b thread: v0 - vs of its row, summed over the rows in order
    for (int pass = 0; pass < npass; ++pass) {
      float acc[kBf ? kUPass : kFQ][kBf ? 16 : kFJ];
#pragma unroll
      for (int u = 0; u < (kBf ? kUPass : kFQ); ++u)
#pragma unroll
        for (int e = 0; e < (kBf ? 16 : kFJ); ++e) acc[u][e] = 0.0f;
      const int it = pass * nthr + tid;  // f32 compute: this thread's item
      const int qg = kBf ? 0 : it / ngj, jg = kBf ? 0 : it - qg * ngj;
      for (int ch = 0; ch < nchunk; ++ch) {
        const int k0 = ch * plan.kc;
        if (!plan.resident) {
          __syncthreads();  // the last chunk is no longer read
          stage_x(reinterpret_cast<Store*>(ring), v0, g, V, R, q0, k0, plan.kc);
          stage_y<kBf>(ys, g, H, R, k0, plan.kc);
          __syncthreads();
        }
        const int kn = min(plan.kc, k2 - k0);  // X's rows in this chunk
        if constexpr (kBf) {
          const int gq = lane >> 2, t = lane & 3, nks = (kn + 15) / 16, ks_all = plan.kc / 16;
          const unsigned* yf = reinterpret_cast<const unsigned*>(ys);
          for (int ks = 0; ks < nks; ++ks) {
            const int kb = ks * 16 + 2 * t;
            auto xv = [&](int k, int row) {
              return k < kn ? ld(xs + k * kTQ + row) : 0.0f;
            };
            const unsigned af[4] = {pack_bf16(xv(kb, gq), xv(kb + 1, gq)),
                                    pack_bf16(xv(kb, gq + 8), xv(kb + 1, gq + 8)),
                                    pack_bf16(xv(kb + 8, gq), xv(kb + 9, gq)),
                                    pack_bf16(xv(kb + 8, gq + 8), xv(kb + 9, gq + 8))};
#pragma unroll
            for (int u = 0; u < kUPass; ++u) {
              const int unit = pass * nwarps * kUPass + warp + nwarps * u;
              if (unit >= nunit) continue;
              const uint4* bp = reinterpret_cast<const uint4*>(
                  yf + (static_cast<size_t>(unit * ks_all + ks) * 2 * 32 + lane) * 4);
              const uint4 b01 = bp[0], b23 = bp[32];
              float(&d)[16] = acc[u];
              mma_16816(d[0], d[1], d[2], d[3], af, b01.x, b01.y);
              mma_16816(d[4], d[5], d[6], d[7], af, b01.z, b01.w);
              mma_16816(d[8], d[9], d[10], d[11], af, b23.x, b23.y);
              mma_16816(d[12], d[13], d[14], d[15], af, b23.z, b23.w);
            }
          }
        } else if (qg < 2) {
          const float* yr = reinterpret_cast<const float*>(ys) + kFJ * jg;
          const int hs = static_cast<int>(round_up(H, 4));
#pragma unroll 4
          for (int k = 0; k < kn; ++k) {
            float x[kFQ], y[kFJ];
            ld_vec<kFQ>(xs + k * kTQ + kFQ * qg, x);
            const float4 yv = *reinterpret_cast<const float4*>(yr + static_cast<size_t>(k) * hs);
            y[0] = yv.x; y[1] = yv.y; y[2] = yv.z; y[3] = yv.w;
#pragma unroll
            for (int r = 0; r < kFQ; ++r)
#pragma unroll
              for (int c = 0; c < kFJ; ++c) acc[r][c] = fmaf(x[r], y[c], acc[r][c]);
          }
        }
        if (pass == 0 && qb >= 0) {
          for (int k = 0; k + 1 < kn; k += 2)  // whole pairs: kc and k0 are even
            dsum += ld(xs + k * kTQ + qb) - ld(xs + (k + 1) * kTQ + qb);
        }
      }
      if (tr) {
        const unsigned long long t = globaltimer_ns();
        t_sums += t - t_last;
        t_last = t;
      }
      if constexpr (kBf) {
        const int gq = lane >> 2, t = lane & 3;
#pragma unroll
        for (int u = 0; u < kUPass; ++u) {
          const int unit = pass * nwarps * kUPass + warp + nwarps * u;
          if (unit >= nunit) continue;
          const int j = unit * kUCols + 8 * t;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = gq + 8 * hh;
            if (q0 + row >= V) continue;
            float gv[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) gv[e] = acc[u][(e >> 1) * 4 + 2 * hh + (e & 1)];
            const size_t o = static_cast<size_t>(row) * H + j;
            update_run<8, kVel>(a, tw + o, tv + o, dw + o, dv + o, j, gv, inv_b, m, vec);
          }
        }
      } else if (qg < 2) {
#pragma unroll
        for (int r = 0; r < kFQ; ++r) {
          const int row = kFQ * qg + r;
          if (q0 + row >= V) break;
          const size_t o = static_cast<size_t>(row) * H + kFJ * jg;
          update_run<kFJ, kVel>(a, tw + o, tv + o, dw + o, dv + o, kFJ * jg, acc[r], inv_b, m,
                                H % 4 == 0 && aligned16(a.W) && aligned16(a.vW));
        }
      }
    }
    if (own)
      apply_loaded(a, a.b + q0 + qb, a.vb + q0 + qb, ob, ovb, dsum * inv_b, m, a.lr, false);
    if (tr) {
      const unsigned long long t = globaltimer_ns();
      t_upd += t - t_last;
      t_last = t;
    }
  }
  if (plan.resident) cp_async_wait<0>();  // no copy into shared memory outlives the kernel
  if (tr) tr[5] = globaltimer_ns();
  // c on the blocks that walk one tile fewer (all of them when the tiles divide)
  const int first = ntiles % grid;
  if (static_cast<int>(blockIdx.x) >= first)
    update_c(a, g, m, inv_b, warp * (grid - first) + (blockIdx.x - first),
             nwarps * (grid - first));
  if (blockIdx.x == 0 && tid == 0) {
    float tot = 0.0f;
    for (int d = 0; d < a.ndev; ++d)
      tot += *reinterpret_cast<const float*>(g.buf + d * g.slot_bytes + g.err);
    *a.err = tot * a.scale;
  }
  if (tr) {
    tr[2] = t_wait; tr[3] = t_sums; tr[4] = t_upd;
    tr[6] = globaltimer_ns();
    tr[7] = ntile_block;
  }
}

}  // namespace
