// The phases that csrc/cd_train_wide.cu (the single-device W-blocked run)
// and csrc/cd_grads_wide.cu (its data-parallel step and update) share: the
// x W product as a sum over fixed strips of W's rows (xw_partial_phase, then
// hidden_reduce_phase), the h W^T product (visible_phase), and the gradient
// and update of W, b and c (update_phase), with their launch plan
// (wide_plan). Each is a template on the kernel's argument struct A, which
// names its buffers alike: W, b, c (Store), the strips' partial sums part,
// vs (the negative-phase visibles, f32 or Store: both hold values rounded
// through Store), v1mean, and the sizes (V, H, B: the rows of a product, NS:
// the strips, flags, seed, and for the update lr, l2, grad_clip,
// sparsity_target, sparsity_cost), and the plan's fields it reads (vis_rows,
// vis_window, hstride for h W^T; hstaged, strip_rows for the update). The
// update reads its rows through a row source R (BatchRows, or the gathered
// factors of the data-parallel update), so the same sums run over one batch
// or over every rank's rows in rank order. Every sum runs in a fixed order,
// so the bits do not depend on the grid; see csrc/cd_train_wide.cu for the
// design.

#pragma once

#include <algorithm>

#include "cd_common.cuh"

// The kernels' dynamic shared memory (wide_plan's smem_bytes). The phases
// name it themselves: a pointer handed to a function that is not inlined
// would turn every shared access into a generic one.
extern __shared__ __align__(16) float cd_wide_smem[];

namespace {

// The phases are functions of their own, not inlined into the kernels: each
// has up to 255 registers for itself at one block an SM instead of sharing
// them with what the kernel keeps live across the phases. The h W^T and
// update phases store between their reads of the arguments, so they copy
// them into a local first (read through the reference, a field would be
// loaded again after every global store and __syncthreads).
#define WIDE_PHASE __device__ __noinline__

constexpr int kStripRows = 512;    // rows of W per strip of an x W product (fixed: see above)
constexpr int kRowsPerWarp = 16;   // W rows a warp holds in registers per sub-tile
constexpr int kSub = kWarps * kRowsPerWarp;  // strip rows in one sub-tile
constexpr int kXDepth = 2;         // sub-tiles whose W and x are loaded at once
constexpr int kXCols = kXDepth * kSub;       // strip rows staged at once
constexpr int kRowGroup = 64;      // batch rows summed per pass of an x W unit
constexpr int kXPre = 24;          // x values of a step a thread loads with its W
constexpr int kBatch = 8;          // loads a staging loop keeps in flight a thread
constexpr int kXMaxCols = 2;       // hidden columns a lane can hold (x W units of 64 columns)
constexpr int kXwFloats = kRowGroup * kXCols + kWarps * kRowGroup * 32 * kXMaxCols;
// h W^T: a unit is kVQ rows of W, kVL of them a lane (rows lane, lane + 32);
// warp w holds the rows w, w + kWarps, ... of a pass, at most kVTR of them
constexpr int kVL = 2;
constexpr int kVQ = 32 * kVL;
constexpr int kVTR = 8;
constexpr int kVPass = kWarps * kVTR;  // rows of h a pass can hold
constexpr int kVStages = 3;            // W tiles in flight (a ring)
constexpr int kVec = 16 / static_cast<int>(sizeof(Store));  // Store values in 16 bytes
constexpr int kVK = 32 * kVec;         // hidden units of a W tile (512 bytes a row)
constexpr int kVRow = kVK + kVec;      // a tile row, padded by 16 bytes against bank conflicts
constexpr int kVTileBytes = kVQ * kVRow * static_cast<int>(sizeof(Store));
constexpr int kVRingFloats = kVStages * kVTileBytes / 4;
constexpr int kHAlign = 8;             // staged h rows are padded to a multiple of this
// update: a unit is a strip of kUQ rows of W across all H columns
constexpr int kUQ = 16;
constexpr int kUH = kUQ / 2;           // rows of W an update item holds
constexpr int kUJ = 4;                 // adjacent columns an update item holds
constexpr int kUPre = 8;               // strip values a thread prefetches in registers
constexpr int kUMaxStripRows = 256;    // strip rows staged at once when h is not staged
static_assert(kRowsPerWarp % 4 == 0, "x tiles are read as float4");
static_assert(kThreads % kXCols == 0, "a thread stages one column of x");
static_assert(kThreads == 32 * kWarps && kVQ == 32 * kVL, "lane = rows of W in h W^T");
static_assert((32 * kVQ) % kThreads == 0, "a W tile is whole 16-byte pieces per thread");

__host__ __device__ inline long long round_up(long long n, long long m) {
  return (n + m - 1) / m * m;
}

// How a launch of the phases uses its block's shared memory, from the shapes
// alone (ops/cd_epoch_wide_cuda.py::wide_launch_plan mirrors it).
struct WidePlan {
  int smem_bytes;  // dynamic shared memory of a block: the largest phase's
  int vis_rows;    // h W^T: rows of h a pass stages (0: no h W^T phase)
  int vis_window;  // h W^T: hidden units of h staged at once (H: whole rows, once a pass)
  int hstride;     // h W^T: row stride of the staged h, floats
  int hstaged;     // update: h0p and hmean staged once per phase (else read from L2)
  int strip_rows;  // update: rows of a strip's v0 and vs staged at once (0: no update)
  int wtiles;      // update: the next strip's W (1), and vW (2), streamed to shared memory
  int ok;          // 0 when the card's shared memory cannot hold a phase
};

// Floats of one strip's rows of W (kUQ x H Store values), 16-byte aligned.
__host__ __device__ inline long long strip_tile_floats(int H) {
  return round_up(static_cast<long long>(kUQ) * H * static_cast<long long>(sizeof(Store)), 16) / 4;
}

// vis_total: rows of the widest h W^T pass (B, 2B under PCD; 0: none);
// xw: whether x W runs; upd_rows: rows of the update (0: none); vel: whether
// an update of the run has momentum (its old velocity is read); limit: the
// block's opt-in shared memory in bytes. The update's shared memory goes to
// h0p and hmean first, then to two strips' tiles of W (and vW).
inline WidePlan wide_plan(int H, int vis_total, bool xw, int upd_rows, bool vel, int limit) {
  WidePlan p{0, 0, 0, 0, 0, 0, 0, 1};
  const long long lim = limit / 4;  // floats
  long long need = xw ? kXwFloats : 0;
  if (vis_total > 0) {
    const long long hs = round_up(H, kHAlign), avail = lim - kVRingFloats;
    if (avail >= hs) {  // whole rows of h, staged once a pass
      p.vis_window = H;
      p.hstride = static_cast<int>(hs);
      p.vis_rows = static_cast<int>(std::min<long long>(std::min(vis_total, kVPass), avail / hs));
    } else {  // a row does not fit: windows of whole W tiles, staged per unit
      p.vis_rows = static_cast<int>(std::min<long long>(std::min(vis_total, kVPass),
                                                        avail / kVK));
      p.vis_window = p.vis_rows > 0
                         ? static_cast<int>(avail / p.vis_rows / kVK * kVK) : 0;
      p.hstride = p.vis_window;
      if (p.vis_rows < 1) p.ok = 0;
    }
    need = std::max<long long>(need, kVRingFloats +
                                         static_cast<long long>(p.vis_rows) * p.hstride);
  }
  if (upd_rows > 0) {
    // h0p and hmean, rows padded to whole column groups of the update's items
    const long long h2 = round_up(2LL * upd_rows * round_up(H, kUJ), 4);
    // two buffers of a strip's rows ([rows][2 kUQ]) and of their differences ([rows][kUQ])
    const long long strip = 2LL * 3 * kUQ * upd_rows;
    long long upd;
    if (h2 + strip <= lim) {
      p.hstaged = 1;
      p.strip_rows = upd_rows;
      upd = h2 + strip;
    } else {
      p.strip_rows = std::min(upd_rows, kUMaxStripRows);
      upd = 2LL * 3 * kUQ * p.strip_rows;
    }
    const int nt = vel ? 2 : 1;
    const long long tiles = 2LL * nt * strip_tile_floats(H);  // double-buffered
    if (upd + tiles <= lim) {
      p.wtiles = nt;
      upd += tiles;
    }
    need = std::max(need, upd);
  }
  need = std::max<long long>(need, kWarps);  // monitor_row
  if (need > lim) p.ok = 0;
  p.smem_bytes = static_cast<int>(need * 4);
  return p;
}

// The 32 bits a value is stored in (a bf16 in the low half), and the float
// they hold. A prefetch keeps the raw bits and converts them only when it
// stores them, so the warp does not wait for the load where it starts.
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

// cp.async of 16 bytes into shared memory; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts cp.async copies of n floats (a multiple of 4; both 16-byte aligned)
// from src into shared memory at dst, by every thread of the block.
__device__ __forceinline__ void cp_async_floats(float* dst, const float* src, long long n) {
  for (long long i = 4LL * threadIdx.x; i < n; i += 4LL * kThreads) cp_async16(dst + i, src + i, 16);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The reconstruction monitor's rows that ride as extra units of a phase:
// row r sums x0[r] against v1mean[r] into rowerr[r] (monitor_row), r < n.
struct Monitor {
  const Store* x0 = nullptr;
  const float* v1mean = nullptr;
  float* rowerr = nullptr;
  int n = 0;
};

// One batch's rows, contiguous: the data x0 [rows, V] (Store), the
// negative-phase visibles xs [rows, V] and the hidden probabilities of the
// two phases [rows, H] (kContiguousH: h0p and hmean are plain arrays). v0_bits
// / vs_bits load a value's raw bits, v0_of / vs_of form it.
struct BatchRows {
  static constexpr bool kContiguousH = true;
  const Store* x0;
  const float* xs;
  const float* h0p;
  const float* hmean;
  int V, H;
  __device__ __forceinline__ unsigned v0_bits(int r, int q) const {
    return raw_bits(x0 + static_cast<size_t>(r) * V + q);
  }
  __device__ __forceinline__ unsigned vs_bits(int r, int q) const {
    return raw_bits(xs + static_cast<size_t>(r) * V + q);
  }
  __device__ __forceinline__ float v0_of(unsigned x) const { return from_raw<Store>(x); }
  __device__ __forceinline__ float vs_of(unsigned x) const { return from_raw<float>(x); }
  __device__ __forceinline__ float hp(int r, int j) const {
    return h0p[static_cast<size_t>(r) * H + j];
  }
  __device__ __forceinline__ float hm(int r, int j) const {
    return hmean[static_cast<size_t>(r) * H + j];
  }
};

// monitor_row (cd_common.cuh) with kBatch loads of each operand in flight a
// thread: the same terms summed in the same order, so the same bits.
__device__ __forceinline__ void monitor_row_batched(const Store* x, const float* y, int V,
                                                    bool xent, float* smem, float* out) {
  float acc = 0.0f;
  for (int q0 = threadIdx.x; q0 < V; q0 += kBatch * kThreads) {
    float xv[kBatch], yv[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int q = q0 + k * kThreads;
      xv[k] = q < V ? ld(x + q) : 0.0f;
      yv[k] = q < V ? y[q] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (q0 + k * kThreads >= V) break;
      if (xent) {
        const float pc = fminf(fmaxf(yv[k], 1e-7f), 1.0f - 1e-7f);
        acc += xv[k] * logf(pc) + (1.0f - xv[k]) * logf(1.0f - pc);
      } else {
        const float d = xv[k] - yv[k];
        acc = fmaf(d, d, acc);
      }
    }
  }
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.0f;
    for (int w = 0; w < kWarps; ++w) tot += smem[w];
    *out = tot;
  }
}

// The x W units of xw_partial_phase with TJ hidden columns a lane (lane +
// 32 t): a unit is one strip x 32 TJ columns. Each warp holds kRowsPerWarp
// elements of each of its columns per sub-tile of kSub strip rows, for
// kXDepth sub-tiles at once (loads started with the step's first kXPre
// values of x a thread before the block waits to stage them), and adds each
// sub-tile's products with every row of the group into per-row sums in
// shared memory, sub-tile after sub-tile, four rows at a time; the warps'
// sums are then added in warp order. Each output's sum is the one of a row
// and a column at a time; a value of x staged in shared memory enters TJ
// products.
template <bool kBf, int TJ, class A, typename T>
__device__ __forceinline__ void xw_units(const A& a, const T* x, const Monitor& mon) {
  float* const smem = cd_wide_smem;
  constexpr int kCols = 32 * TJ;
  float* xs = smem;                        // [kRowGroup][kXCols]
  float* accs = smem + kRowGroup * kXCols;  // [kWarps][kRowGroup][kCols]
  const int V = a.V, H = a.H, B = a.B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncol = (H + kCols - 1) / kCols, nprod = a.NS * ncol;
  const int cc = threadIdx.x % kXCols;  // this thread's column of x
  float* mine = accs + warp * kRowGroup * kCols + lane;
  for (int unit = blockIdx.x; unit < nprod + mon.n; unit += gridDim.x) {
    if (unit >= nprod) {  // one row of the monitor
      const int r = unit - nprod;
      __syncthreads();  // smem of the previous unit is no longer read
      monitor_row_batched(mon.x0 + static_cast<size_t>(r) * V,
                          mon.v1mean + static_cast<size_t>(r) * V, V, a.flags & kXent, smem,
                          mon.rowerr + r);
      continue;
    }
    const int s = unit / ncol, j0 = (unit % ncol) * kCols;
    const int q_lo = s * kStripRows, q_hi = min(V, q_lo + kStripRows);
    for (int rg0 = 0; rg0 < B; rg0 += kRowGroup) {
      const int nr = min(kRowGroup, B - rg0);
      for (int rr = 0; rr < nr; ++rr)
#pragma unroll
        for (int t = 0; t < TJ; ++t) mine[rr * kCols + 32 * t] = 0.0f;  // own slots
      for (int q0 = q_lo; q0 < q_hi; q0 += kXCols) {
        const int nq = min(kXCols, q_hi - q0);
        unsigned wraw[kXDepth][TJ][kRowsPerWarp], xraw[kXPre];  // in flight before the wait
#pragma unroll
        for (int d = 0; d < kXDepth; ++d)
#pragma unroll
          for (int t = 0; t < TJ; ++t)
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i) {
              const int q = q0 + d * kSub + warp * kRowsPerWarp + i, j = j0 + 32 * t + lane;
              wraw[d][t][i] = (q < q_hi && j < H)
                                  ? raw_bits(a.W + static_cast<size_t>(q) * H + j) : 0u;
            }
#pragma unroll
        for (int k = 0; k < kXPre; ++k) {
          const int rr = (threadIdx.x + k * kThreads) / kXCols;
          xraw[k] = (rr < nr && cc < nq)
                        ? raw_bits(x + static_cast<size_t>(rg0 + rr) * V + q0 + cc) : 0u;
        }
        __syncthreads();  // the previous tile of x is no longer read
#pragma unroll
        for (int k = 0; k < kXPre; ++k) {
          const int idx = threadIdx.x + k * kThreads;
          if (idx < nr * kXCols) xs[idx] = op<kBf>(from_raw<T>(xraw[k]));
        }
        for (int base = threadIdx.x + kXPre * kThreads; base < nr * kXCols;
             base += kBatch * kThreads) {  // rows past the prefetch, kBatch loads in flight
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const int rr = (base + k * kThreads) / kXCols;
            xraw[k] = (rr < nr && cc < nq)
                          ? raw_bits(x + static_cast<size_t>(rg0 + rr) * V + q0 + cc) : 0u;
          }
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const int idx = base + k * kThreads;
            if (idx < nr * kXCols) xs[idx] = op<kBf>(from_raw<T>(xraw[k]));
          }
        }
        __syncthreads();
#pragma unroll
        for (int d = 0; d < kXDepth; ++d) {
          if (q0 + d * kSub >= q_hi) break;
          float w[TJ][kRowsPerWarp];
#pragma unroll
          for (int t = 0; t < TJ; ++t)
#pragma unroll
            for (int i = 0; i < kRowsPerWarp; ++i)
              w[t][i] = op<kBf>(from_raw<Store>(wraw[d][t][i]));
          const float* xw = xs + d * kSub + warp * kRowsPerWarp;
          for (int rr = 0; rr < nr; rr += 4) {  // four rows' independent chains of FMAs
            float p[4][TJ];
#pragma unroll
            for (int g = 0; g < 4; ++g)
#pragma unroll
              for (int t = 0; t < TJ; ++t) p[g][t] = 0.0f;
#pragma unroll
            for (int i = 0; i < kRowsPerWarp / 4; ++i) {
#pragma unroll
              for (int g = 0; g < 4; ++g) {
                const float4 xv = *reinterpret_cast<const float4*>(
                    xw + min(rr + g, nr - 1) * kXCols + 4 * i);
#pragma unroll
                for (int t = 0; t < TJ; ++t) {
                  p[g][t] = fmaf(xv.x, w[t][4 * i], p[g][t]);
                  p[g][t] = fmaf(xv.y, w[t][4 * i + 1], p[g][t]);
                  p[g][t] = fmaf(xv.z, w[t][4 * i + 2], p[g][t]);
                  p[g][t] = fmaf(xv.w, w[t][4 * i + 3], p[g][t]);
                }
              }
            }
#pragma unroll
            for (int g = 0; g < 4; ++g)
              if (rr + g < nr) {
#pragma unroll
                for (int t = 0; t < TJ; ++t) mine[(rr + g) * kCols + 32 * t] += p[g][t];
              }
          }
        }
      }
      __syncthreads();  // every warp's sums are complete
      for (int idx = threadIdx.x; idx < nr * kCols; idx += kThreads) {
        const int rr = idx / kCols, l = idx - rr * kCols;
        if (j0 + l < H) {
          float sum = 0.0f;
#pragma unroll
          for (int wv = 0; wv < kWarps; ++wv) sum += accs[(wv * kRowGroup + rr) * kCols + l];
          a.part[(static_cast<size_t>(s) * B + rg0 + rr) * H + j0 + l] = sum;
        }
      }
      __syncthreads();  // the sums are read before the next group clears them
    }
  }
}

// Tensor-core x W at bf16 compute: the operands are bf16 values (op<true>),
// so every product is exact and only the order of the f32 sums inside a
// fixed tile differs from the FMA units'. A unit is one strip x kMCols
// columns, staged as bf16 (W [512][kMCols] once, x [rows][512] per group of
// up to 64 batch rows); warp w takes the strip's rows [64 w, 64 w + 64) as 4
// k-steps of mma.m16n8k16 (bf16 operands, f32 sums) over the group's rows (4
// tiles of 16) and the unit's columns (4 tiles of 8); the warps' sums are
// then added in warp order. The tiles are fixed, so the bits do not depend
// on the grid.
constexpr int kMCols = 32;                        // hidden columns of a unit
constexpr int kMXRow = kStripRows + 8;            // bf16 row stride of the staged x (padded)
constexpr int kMWRow = kMCols + 8;                // bf16 row stride of the staged W tile
constexpr int kMXBytes = kRowGroup * kMXRow * 2;  // x [kRowGroup][kMXRow]
constexpr int kMWBytes = kStripRows * kMWRow * 2;  // W [kStripRows][kMWRow]
constexpr int kMRedFloats = kWarps * kRowGroup * kMCols;  // the warps' sums
static_assert((kMXBytes + kMWBytes) / 4 + kMRedFloats <= kXwFloats, "x W's shared memory");
static_assert(kStripRows == kWarps * 64, "a warp takes 64 rows of a strip");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
// d += a b: a 16 x 16 bf16 tile (row-major fragments), b 16 x 8 (column-major), f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <class A, typename T>
__device__ __forceinline__ void xw_units_mma(const A& a, const T* x, const Monitor& mon) {
  float* const smem = cd_wide_smem;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [kRowGroup][kMXRow]
  __nv_bfloat16* ws =
      reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<char*>(smem) + kMXBytes);  // [512][kMWRow]
  float* red = smem + (kMXBytes + kMWBytes) / 4;  // [kWarps][kRowGroup][kMCols]
  const int V = a.V, H = a.H, B = a.B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncol = (H + kMCols - 1) / kMCols, nprod = a.NS * ncol;
  // W's rows of 32 bf16 columns copy as four 16-byte pieces where they start on 16 bytes
  const bool async = MDBN_STORE_BF16 && H % 8 == 0 && aligned16(a.W);
  constexpr int kXB = 2 * kBatch;  // loads of x in flight a thread
  for (int unit = blockIdx.x; unit < nprod + mon.n; unit += gridDim.x) {
    if (unit >= nprod) {  // one row of the monitor
      const int r = unit - nprod;
      __syncthreads();  // smem of the previous unit is no longer read
      monitor_row_batched(mon.x0 + static_cast<size_t>(r) * V,
                          mon.v1mean + static_cast<size_t>(r) * V, V, a.flags & kXent, smem,
                          mon.rowerr + r);
      continue;
    }
    const int s = unit / ncol, j0 = (unit % ncol) * kMCols;
    const int q_lo = s * kStripRows, nq = min(kStripRows, V - q_lo);
    __syncthreads();  // the previous unit no longer reads ws, xs or red
    // the strip's W tile [512][32] as bf16, zero past V and H
    if (async) {
      for (int pc = threadIdx.x; pc < kStripRows * 4; pc += kThreads) {
        const int q = pc >> 2, c = (pc & 3) * 8;
        const bool in = q < nq && j0 + c < H;
        cp_async16(ws + q * kMWRow + c,
                   in ? reinterpret_cast<const __nv_bfloat16*>(a.W) +
                            static_cast<size_t>(q_lo + q) * H + j0 + c
                      : reinterpret_cast<const __nv_bfloat16*>(a.W),
                   in ? 16 : 0);
      }
      cp_async_commit();
    } else {
      for (int base = threadIdx.x; base < kStripRows * kMCols; base += kBatch * kThreads) {
        float v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int idx = base + k * kThreads, q = idx / kMCols, c = idx % kMCols;
          v[k] = (idx < kStripRows * kMCols && q < nq && j0 + c < H)
                     ? ld(a.W + static_cast<size_t>(q_lo + q) * H + j0 + c) : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int idx = base + k * kThreads;
          if (idx < kStripRows * kMCols)
            ws[(idx / kMCols) * kMWRow + idx % kMCols] = __float2bfloat16(v[k]);
        }
      }
    }
    for (int rg0 = 0; rg0 < B; rg0 += kRowGroup) {
      const int nr = min(kRowGroup, B - rg0), nmt = (nr + 15) / 16;
      if (rg0 > 0) __syncthreads();  // the previous group no longer reads xs or red
      // the group's rows of x over the strip as bf16, zero past nr (to whole tiles) and V
      for (int base = threadIdx.x; base < nmt * 16 * kStripRows; base += kXB * kThreads) {
        float v[kXB];
#pragma unroll
        for (int k = 0; k < kXB; ++k) {
          const int idx = base + k * kThreads, rr = idx / kStripRows, q = idx % kStripRows;
          v[k] = (rr < nr && q < nq) ? ld(x + static_cast<size_t>(rg0 + rr) * V + q_lo + q)
                                     : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < kXB; ++k) {
          const int idx = base + k * kThreads;
          if (idx < nmt * 16 * kStripRows)
            xs[(idx / kStripRows) * kMXRow + idx % kStripRows] = __float2bfloat16(v[k]);
        }
      }
      cp_async_wait<0>();
      __syncthreads();
      float acc[4][kMCols / 8][4];  // [m tile][n tile][fragment]
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < kMCols / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // the warp's 64 rows of the strip, 16 at a time
        const int k0 = warp * 64 + ks * 16;
        unsigned b[kMCols / 8][2];
#pragma unroll
        for (int np = 0; np < kMCols / 16; ++np) {  // two n tiles a load
          unsigned r[4];
          ldmatrix_x4_trans(r, ws + (k0 + (lane & 15)) * kMWRow + np * 16 + (lane >> 4) * 8);
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt >= nmt) break;
          unsigned af[4];
          ldmatrix_x4(af, xs + (mt * 16 + (lane & 15)) * kMXRow + k0 + (lane >> 4) * 8);
#pragma unroll
          for (int nt = 0; nt < kMCols / 8; ++nt) mma_bf16(acc[mt][nt], af, b[nt][0], b[nt][1]);
        }
      }
      // the warp's sums, then every warp's added in warp order
      float* mine = red + warp * kRowGroup * kMCols;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt >= nmt) break;
#pragma unroll
        for (int nt = 0; nt < kMCols / 8; ++nt) {
          const int r = mt * 16 + (lane >> 2), c = nt * 8 + (lane & 3) * 2;
          mine[r * kMCols + c] = acc[mt][nt][0];
          mine[r * kMCols + c + 1] = acc[mt][nt][1];
          mine[(r + 8) * kMCols + c] = acc[mt][nt][2];
          mine[(r + 8) * kMCols + c + 1] = acc[mt][nt][3];
        }
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < nr * kMCols; idx += kThreads) {
        const int rr = idx / kMCols, l = idx - rr * kMCols;
        if (j0 + l < H) {
          float sum = 0.0f;
#pragma unroll
          for (int wv = 0; wv < kWarps; ++wv) sum += red[(wv * kRowGroup + rr) * kMCols + l];
          a.part[(static_cast<size_t>(s) * B + rg0 + rr) * H + j0 + l] = sum;
        }
      }
    }
  }
}

// part[s] = x[:, strip s] W[strip s, :] for every strip s of kStripRows rows
// of W; x [B, V] is the data (Store) or vs (f32 or Store). mon's rows run as
// mon.n more units (v1mean must be complete). At bf16 compute the units run
// on the tensor cores (xw_units_mma). Else units of 64 columns (two a lane)
// halve the shared-memory reads of x per product; they are taken where they
// still give every block as much work, in rounds of the grid, as two thirds
// of the rounds of 32-column units (a wide H); the sums are the same.
template <bool kBf, class A, typename T>
WIDE_PHASE void xw_partial_phase(const A& a, const T* x, const Monitor mon) {
  if constexpr (kBf) {  // tensor cores at bf16 compute
    xw_units_mma(a, x, mon);
  } else {
    const int g = gridDim.x;
    const int r1 = (a.NS * ((a.H + 31) / 32) + g - 1) / g;
    const int r2 = (a.NS * ((a.H + 63) / 64) + g - 1) / g;
    if (3 * r2 < 2 * r1)
      xw_units<kBf, 2>(a, x, mon);
    else
      xw_units<kBf, 1>(a, x, mon);
  }
}

// hprob = sigmoid(sum over strips of part, in strip order, + c) and
// hsample = (u < hprob), for all B x H outputs; one thread per output. With
// hsigned, also hsigned = sign * hprob on the first nvalid rows and 0 on the
// rest (the data-parallel step's h-matrix).
template <class A>
WIDE_PHASE void hidden_reduce_phase(const A& a, float* hprob, Store* hsample, const float* u,
                                    unsigned upd, int kind, int t, float* hsigned = nullptr,
                                    float sign = 1.0f, int nvalid = 0) {
  const size_t n = static_cast<size_t>(a.B) * a.H;
  for (size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; idx < n;
       idx += static_cast<size_t>(gridDim.x) * kThreads) {
    const float* p = a.part + idx;
    float sum = 0.0f;
#pragma unroll 8
    for (int s = 0; s < a.NS; ++s) sum += p[static_cast<size_t>(s) * n];
    const int r = static_cast<int>(idx / a.H), j = static_cast<int>(idx - static_cast<size_t>(r) * a.H);
    const float pr = sigmoidf(sum + ld(a.c + j));
    hprob[idx] = pr;
    if (hsigned) hsigned[idx] = r < nvalid ? sign * pr : 0.0f;
    const float uu = u ? u[idx] : draw_uniform(a.seed, upd, kind, t, r, j);
    st(hsample + idx, uu < pr ? 1.0f : 0.0f);
  }
}

// Rows [p0, p0 + np) of the h W^T phase's row list (h's B rows, then mon's),
// hidden units [j_lo, j_hi), into hs [np][hstride] as f32, zero up to the
// next multiple of kHAlign past j_hi - j_lo (the tiles' zero padding meets
// zeros there). All threads of the block call it.
__device__ __forceinline__ void stage_h(float* hs, int hstride, const Store* h, const Store* mon,
                                        int B, int H, int p0, int np, int j_lo, int j_hi) {
  const int nj = j_hi - j_lo, w = static_cast<int>(round_up(nj, kHAlign));
  for (int base = threadIdx.x; base < np * w; base += kBatch * kThreads) {
    float v[kBatch];  // kBatch loads in flight before the stores
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = base + k * kThreads, rr = idx / w, jj = idx - rr * w, row = p0 + rr;
      const Store* src = row < B ? h + static_cast<size_t>(row) * H
                                 : mon + static_cast<size_t>(row - B) * H;
      v[k] = (idx < np * w && jj < nj) ? ld(src + j_lo + jj) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = base + k * kThreads, rr = idx / w;
      if (idx < np * w) hs[rr * hstride + idx - rr * w] = v[k];
    }
  }
}

// Starts the loads of W tile (unit u, chunk c) into `tile` [kVQ][kVRow]:
// rows u*kVQ.., hidden units c*kVK.., zero past V and H. cp.async when every
// row of W starts on 16 bytes, else plain loads.
template <class A>
__device__ __forceinline__ void start_w_tile(const A& a, Store* tile, int u, int c, bool async) {
  const int V = a.V, H = a.H, j0 = c * kVK;
  if (async) {
#pragma unroll
    for (int k = 0; k < 32 * kVQ / kThreads; ++k) {
      const int piece = threadIdx.x + k * kThreads, row = piece >> 5, col = (piece & 31) * kVec;
      const int q = u * kVQ + row, j = j0 + col;
      const bool in = q < V && j < H;
      cp_async16(tile + row * kVRow + col, in ? a.W + static_cast<size_t>(q) * H + j : a.W,
                 in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < kVQ * kVK; idx += kThreads) {
      const int row = idx / kVK, col = idx - row * kVK;
      const int q = u * kVQ + row, j = j0 + col;
      tile[row * kVRow + col] = (q < V && j < H) ? a.W[static_cast<size_t>(q) * H + j]
                                                 : Store(0.0f);
    }
  }
}

// The FMAs of one W tile for a warp's NR rows of h: acc[i][l] += h[row i][j]
// * W[lane row l][j] over the tile's nj hidden units in order (tile: this
// lane's first row of the tile, its rows 32 apart; hrow: the warp's first row
// of staged h, rows hstep apart).
template <int NR, bool kRoundW>
__device__ __forceinline__ void tile_fmas(float (&acc)[kVTR][kVL], const Store* tile,
                                          const float* hrow, int hstep, int nj) {
#pragma unroll 2
  for (int jj = 0; jj < nj; jj += kVec) {
    float w[kVL][kVec];
#pragma unroll
    for (int l = 0; l < kVL; ++l) {
      const uint4 wr = *reinterpret_cast<const uint4*>(tile + l * 32 * kVRow + jj);
      if constexpr (kVec == 4) {
        w[l][0] = __uint_as_float(wr.x); w[l][1] = __uint_as_float(wr.y);
        w[l][2] = __uint_as_float(wr.z); w[l][3] = __uint_as_float(wr.w);
      } else {
        const unsigned x[4] = {wr.x, wr.y, wr.z, wr.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          w[l][2 * k] = __uint_as_float(x[k] << 16);
          w[l][2 * k + 1] = __uint_as_float(x[k] & 0xFFFF0000u);
        }
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) w[l][k] = op<kRoundW>(w[l][k]);
    }
    float4 hv[NR][kVec / 4];
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int k4 = 0; k4 < kVec / 4; ++k4)
        hv[i][k4] = *reinterpret_cast<const float4*>(hrow + i * hstep + jj + 4 * k4);
#pragma unroll
    for (int k4 = 0; k4 < kVec / 4; ++k4)
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int l = 0; l < kVL; ++l) {
          acc[i][l] = fmaf(hv[i][k4].x, w[l][4 * k4], acc[i][l]);
          acc[i][l] = fmaf(hv[i][k4].y, w[l][4 * k4 + 1], acc[i][l]);
          acc[i][l] = fmaf(hv[i][k4].z, w[l][4 * k4 + 2], acc[i][l]);
          acc[i][l] = fmaf(hv[i][k4].w, w[l][4 * k4 + 3], acc[i][l]);
        }
  }
}

// Gibbs step t's visible mean of h [B, H]: vs (rounded through Store), and
// v1mean when this is the CD monitor's step (t = 0, not persistent); then,
// when mon is given (PCD, t = 0), the reconstruction from mon -> v1mean.
// Unit (one block): kVQ rows of W, a lane's rows lane and lane + 32; warp w
// owns rows w, w + kWarps, ... of a pass of the row list (h's rows, then
// mon's), so a thread owns whole outputs and sums each over all H in order,
// no sum across threads; each staged value of h it reads enters kVL products. The pass's rows of h are staged once per pass (a.vis_rows rows,
// whole rows when they fit, else a.vis_window hidden units at a time, again
// per unit); W streams through a ring of kVStages tiles of kVK hidden units
// by cp.async, the next tiles in flight while this one's FMAs run.
template <bool kBf, class A>
WIDE_PHASE void visible_phase(const A& args, const Store* h, const Store* mon, int t) {
  const A a = args;  // a local copy: see WIDE_PHASE
  float* const smem = cd_wide_smem;
  Store* ring = reinterpret_cast<Store*>(smem);  // [kVStages][kVQ][kVRow]
  float* hs = smem + kVRingFloats;               // [vis_rows][hstride]
  const int V = a.V, H = a.H, B = a.B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool gaussian = a.flags & kGaussian;
  const bool cd_monitor = t == 0 && !(a.flags & kPersistent);
  const int nrows = mon ? 2 * B : B;
  const int nunit = (V + kVQ - 1) / kVQ, nch = (H + kVK - 1) / kVK;
  const int my_units = static_cast<int>(blockIdx.x) < nunit
                           ? (nunit - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
  const int nitems = my_units * nch;
  const bool windowed = a.vis_window < H;
  const int wch = windowed ? a.vis_window / kVK : nch;  // tiles of a window
  const bool async = (static_cast<size_t>(H) * sizeof(Store)) % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(a.W) & 15) == 0;
  // bf16 storage holds bf16 values: rounding them for bf16 compute is exact
  constexpr bool kRoundW = kBf && !MDBN_STORE_BF16;
  for (int p0 = 0; p0 < nrows; p0 += a.vis_rows) {
    const int np = min(a.vis_rows, nrows - p0);
    const int nmine = np > warp ? (np - 1 - warp) / kWarps + 1 : 0;
    __syncthreads();  // the previous pass no longer reads hs or the ring
    if (!windowed) {
      // float rows already in the staged layout copy as they are (cp.async), the
      // rest converts through registers
      const int nh = max(0, min(np, B - p0));  // rows of the pass from h, then from mon
      if (!MDBN_STORE_BF16 && a.hstride == H && aligned16(h) && (nh == np || aligned16(mon))) {
        const float* hf = reinterpret_cast<const float*>(h);
        const float* mf = reinterpret_cast<const float*>(mon);
        cp_async_floats(hs, hf + static_cast<size_t>(p0) * H, static_cast<long long>(nh) * H);
        if (np > nh)
          cp_async_floats(hs + static_cast<size_t>(nh) * H,
                          mf + static_cast<size_t>(p0 + nh - B) * H,
                          static_cast<long long>(np - nh) * H);
      } else {
        stage_h(hs, a.hstride, h, mon, B, H, p0, np, 0, H);
      }
    }
#pragma unroll
    for (int s = 0; s < kVStages - 1; ++s) {
      if (s < nitems)
        start_w_tile(a, ring + s * kVQ * kVRow, blockIdx.x + (s / nch) * gridDim.x, s % nch,
                     async);
      cp_async_commit();
    }
    float acc[kVTR][kVL];
    for (int it = 0; it < nitems; ++it) {
      const int u = blockIdx.x + (it / nch) * gridDim.x, c = it % nch;
      cp_async_wait<kVStages - 2>();
      __syncthreads();  // tile it has landed; every thread is done with tile it - 1
      {
        const int nx = it + kVStages - 1;
        if (nx < nitems)
          start_w_tile(a, ring + (nx % kVStages) * kVQ * kVRow,
                       blockIdx.x + (nx / nch) * gridDim.x, nx % nch, async);
        cp_async_commit();
      }
      if (windowed && c % wch == 0) {
        stage_h(hs, a.hstride, h, mon, B, H, p0, np, c * kVK, min(H, c * kVK + a.vis_window));
        __syncthreads();
      }
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < kVTR; ++i)
#pragma unroll
          for (int l = 0; l < kVL; ++l) acc[i][l] = 0.0f;
      }
      const Store* tile = ring + (it % kVStages) * kVQ * kVRow + lane * kVRow;
      const float* hrow = hs + warp * a.hstride + (windowed ? (c % wch) * kVK : c * kVK);
      const int nj = min(kVK, H - c * kVK), hstep = kWarps * a.hstride;
      switch (nmine) {  // the warp's row count, so its FMAs have no predicates
        case 1: tile_fmas<1, kRoundW>(acc, tile, hrow, hstep, nj); break;
        case 2: tile_fmas<2, kRoundW>(acc, tile, hrow, hstep, nj); break;
        case 3: tile_fmas<3, kRoundW>(acc, tile, hrow, hstep, nj); break;
        case 4: tile_fmas<4, kRoundW>(acc, tile, hrow, hstep, nj); break;
        case 5: tile_fmas<5, kRoundW>(acc, tile, hrow, hstep, nj); break;
        case 6: tile_fmas<6, kRoundW>(acc, tile, hrow, hstep, nj); break;
        case 7: tile_fmas<7, kRoundW>(acc, tile, hrow, hstep, nj); break;
        case 8: tile_fmas<8, kRoundW>(acc, tile, hrow, hstep, nj); break;
        default: break;
      }
      if (c == nch - 1) {  // the unit's outputs
#pragma unroll
        for (int l = 0; l < kVL; ++l) {
          const int q = u * kVQ + l * 32 + lane;
          if (q >= V) break;
          const float bq = ld(a.b + q);
#pragma unroll
          for (int i = 0; i < kVTR; ++i) {
            if (i >= nmine) break;
            const int row = p0 + warp + i * kWarps;
            const bool seg1 = row >= B;
            const size_t idx = static_cast<size_t>(seg1 ? row - B : row) * V + q;
            const float pre = acc[i][l] + bq;
            const float mean = gaussian ? pre : sigmoidf(pre);
            if (seg1) {
              a.v1mean[idx] = mean;
            } else {
              if (cd_monitor) a.v1mean[idx] = mean;
              st(a.vs + idx, round_store(mean));
            }
          }
        }
      }
    }
    cp_async_wait<0>();
  }
}

// The values of a strip that update_units stages, value idx of [rows][2 kUQ]
// (rows r0..): v0 then vs of the strip's columns q0.., 0 past V.
// strip_bits loads the raw bits, strip_of forms the value.
template <class R>
__device__ __forceinline__ unsigned strip_bits(const R& rows, int V, int q0, int r0, int idx) {
  const int r = r0 + idx / (2 * kUQ), c = idx % (2 * kUQ), q = q0 + c % kUQ;
  if (q >= V) return 0u;
  return c < kUQ ? rows.v0_bits(r, q) : rows.vs_bits(r, q);
}
template <class R>
__device__ __forceinline__ float strip_of(const R& rows, int idx, unsigned x) {
  return (idx % (2 * kUQ)) < kUQ ? rows.v0_of(x) : rows.vs_of(x);
}

// Stores value idx of a strip (raw bits x) into sb [rows][2 kUQ], rounded to
// the compute dtype (the products' operand), and v0 - vs of its row and
// column into sd [rows][kUQ] (unrounded, for gb). A warp's 32 lanes hold one
// row's 2 kUQ values (lane = column), so every lane of a warp calls it or
// none does.
template <bool kBf, class R>
__device__ __forceinline__ void put_strip(float* sb, float* sd, const R& rows, int idx,
                                          unsigned x) {
  const float v = strip_of(rows, idx, x);
  const float vs = __shfl_down_sync(0xFFFFFFFFu, v, kUQ);
  const int r = idx / (2 * kUQ), c = idx % (2 * kUQ);
  sb[idx] = op<kBf>(v);
  if (c < kUQ) sd[r * kUQ + c] = v - vs;
}

// Values [from, nst) of a strip chunk (rows r0..) into sb and sd, from this
// thread's indices (from is tid + a multiple of kThreads), kBatch loads in
// flight before the stores.
template <bool kBf, class R>
__device__ __forceinline__ void stage_strip(float* sb, float* sd, const R& rows, int V, int q0,
                                            int r0, int from, int nst) {
  for (int base = from; base < nst; base += kBatch * kThreads) {
    unsigned x[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = base + k * kThreads;
      x[k] = idx < nst ? strip_bits(rows, V, q0, r0, idx) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = base + k * kThreads;  // nst is whole rows: a warp's lanes agree
      if (idx < nst) put_strip<kBf>(sb, sd, rows, idx, x[k]);
    }
  }
}

// Four adjacent values of a Store array as floats, and back (each rounded
// once into Store, as st does); p is 16-byte (float) or 8-byte (bf16) aligned.
__device__ __forceinline__ void ld4(const float* p, float (&o)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(x.x << 16); o[1] = __uint_as_float(x.x & 0xFFFF0000u);
  o[2] = __uint_as_float(x.y << 16); o[3] = __uint_as_float(x.y & 0xFFFF0000u);
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float (&v)[4]) {
  unsigned u[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) u[c] = __bfloat16_as_ushort(__float2bfloat16(v[c]));
  *reinterpret_cast<uint2*>(p) = make_uint2(u[0] | (u[1] << 16), u[2] | (u[3] << 16));
}

// Starts the cp.async copies of strip `unit`'s rows of W (and of vW when
// vel) into dw (and dv): kUQ rows of H values, contiguous in device memory,
// zeros past row V.
template <class A>
__device__ __forceinline__ void start_strip_tiles(const A& a, float* dw, float* dv, int unit,
                                                  bool vel) {
  const size_t off = static_cast<size_t>(unit) * kUQ * a.H;
  const long long bytes = static_cast<long long>(min(kUQ, a.V - unit * kUQ)) * a.H *
                          static_cast<long long>(sizeof(Store));
  const long long npiece = round_up(static_cast<long long>(kUQ) * a.H * sizeof(Store), 16) / 16;
  const char* sw = reinterpret_cast<const char*>(a.W + off);
  const char* sv = reinterpret_cast<const char*>(a.vW + off);
  for (long long pc = threadIdx.x; pc < npiece; pc += kThreads) {
    const long long b = pc * 16;
    const int n = static_cast<int>(max(0LL, min(16LL, bytes - b)));
    cp_async16(reinterpret_cast<char*>(dw) + b, n > 0 ? sw + b : sw, n);
    if (vel) cp_async16(reinterpret_cast<char*>(dv) + b, n > 0 ? sv + b : sv, n);
  }
}

// apply_loaded's arithmetic (cd_common.cuh), returning the new velocity nv
// (rounded through Store) and the parameter old + nv before it is stored.
template <class A>
__device__ __forceinline__ void apply_value(const A& a, float old, float old_vel, float g,
                                            float m, float lr, bool decay, float& nv,
                                            float& np) {
  if (a.flags & kClip) g = fminf(fmaxf(g, -a.grad_clip), a.grad_clip);
  if (decay && a.l2 != 0.0f) g = g - a.l2 * old;
  nv = round_store(m * old_vel + lr * g);
  np = old + nv;
}

// Gradient and update of W, b and c from the first nrows rows of `rows`
// (the gradient divides by nrows), plus mon's rows of the monitor.
// Unit (one block): a strip of kUQ rows of W across all H columns; a thread
// takes items of half the strip's rows (kUH) x kUJ adjacent columns, so each
// value it reads from shared memory enters kUJ or kUH products (shared
// memory's bandwidth, not the FMAs, bounds the sums otherwise). h0p and
// hmean (rounded to the compute dtype, rows padded to a multiple of kUJ) are
// staged once per phase when a.hstaged (else read from device memory). The
// strip's v0 and vs columns (rounded to the compute dtype) and their
// differences v0 - vs are staged in one of two buffers: where the batch
// fits a buffer (a.strip_rows rows), the next unit's strip is staged at the
// end of this one from registers loaded a unit earlier, so a unit has one
// barrier; else chunk by chunk inline. The old values of W, and of vW under
// momentum only (kVel: at momentum 0 the old velocity is not needed), stream
// into shared memory by cp.async a unit ahead where a.wtiles says they fit
// (else a thread loads them, 16 or 8 bytes a row, after its sums).
// A thread sums each element of its item over the rows in row order, then
// updates it; the last kUQ threads of the block (idle in the items at H =
// 400) sum v0 - vs of the strip's rows in row order and update b, whose
// values they load at the unit's start. Monitor unit (one block): one batch
// row. c: one warp per element, lanes over the rows, fixed butterfly.
template <bool kBf, bool kVel, class A, class R>
WIDE_PHASE void update_units(const A& args, const R rows, int nrows, float m,
                             const Monitor mon) {
  const A a = args;  // a local copy: see WIDE_PHASE
  float* const smem = cd_wide_smem;
  const int V = a.V, H = a.H, tid = threadIdx.x;
  const float inv_b = 1.0f / static_cast<float>(nrows);
  const int nstrip = (V + kUQ - 1) / kUQ, grid = static_cast<int>(gridDim.x);
  // items of a strip: 2 halves x column groups of kUJ, in blocks of 8 groups
  const int nitem = 2 * static_cast<int>(round_up((H + kUJ - 1) / kUJ, 8));
  const int hs4 = static_cast<int>(round_up(H, kUJ));
  const size_t rh = static_cast<size_t>(nrows) * hs4;
  const bool hstaged = a.hstaged;
  const int srows = a.strip_rows, nchunk = (nrows + srows - 1) / srows;
  const bool piped = nchunk == 1;  // the next unit's strip staged at the end of this one
  // whole kUJ-column groups load and store as one vector
  const bool vec = H % kUJ == 0 && (reinterpret_cast<uintptr_t>(a.W) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(a.vW) & 15) == 0;
  // shared memory: h [2][nrows][hs4] when staged; strips [2][srows][2 kUQ]; their
  // differences [2][srows][kUQ]; tiles [2][kUQ][H] of W, then of vW
  float* hst = smem;
  const int sfl = srows * 2 * kUQ, dfl = srows * kUQ;
  float* sbuf = smem + (hstaged ? round_up(2 * rh, 4) : 0);
  float* sdif = sbuf + 2 * sfl;
  float* tiles = sdif + round_up(2 * dfl, 4);
  const long long tf = strip_tile_floats(H);
  const bool tiled = a.wtiles == 2 || (a.wtiles == 1 && !kVel);
  if (tiled && static_cast<int>(blockIdx.x) < nstrip)
    start_strip_tiles(a, tiles, tiles + 2 * tf, blockIdx.x, kVel);
  cp_async_commit();
  bool hcopied = false;  // h0p and hmean copied as they are (cp.async)
  if constexpr (R::kContiguousH && !kBf) {
    hcopied = hstaged && hs4 == H && aligned16(rows.h0p) && aligned16(rows.hmean);
    if (hcopied) {
      cp_async_floats(hst, rows.h0p, static_cast<long long>(rh));
      cp_async_floats(hst + rh, rows.hmean, static_cast<long long>(rh));
    }
    cp_async_commit();
  }
  if (hstaged && !hcopied) {  // kBatch loads of each a thread in flight at once
    for (size_t base = tid; base < rh; base += kBatch * kThreads) {
      float x0[kBatch], x1[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const size_t idx = base + static_cast<size_t>(k) * kThreads;
        const int r = static_cast<int>(idx / hs4), j = static_cast<int>(idx - static_cast<size_t>(r) * hs4);
        const bool in = idx < rh && j < H;
        x0[k] = in ? rows.hp(r, j) : 0.0f;
        x1[k] = in ? rows.hm(r, j) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const size_t idx = base + static_cast<size_t>(k) * kThreads;
        if (idx < rh) {
          hst[idx] = op<kBf>(x0[k]);
          hst[rh + idx] = op<kBf>(x1[k]);
        }
      }
    }
  }
  const int nst = nrows * 2 * kUQ;  // values of a piped unit's strip
  unsigned pre[kUPre];  // the strip of the unit after the next, in flight, as raw bits
  if (piped) {
    if (static_cast<int>(blockIdx.x) < nstrip)
      stage_strip<kBf>(sbuf, sdif, rows, V, blockIdx.x * kUQ, 0, tid, nst);
    const int next = blockIdx.x + grid;
#pragma unroll
    for (int k = 0; k < kUPre; ++k) {
      const int idx = tid + k * kThreads;
      pre[k] = (next < nstrip && idx < nst) ? strip_bits(rows, V, next * kUQ, 0, idx) : 0u;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  const int qb = tid - (kThreads - kUQ);  // the b thread's row of the strip (when >= 0)
  for (int unit = blockIdx.x, k = 0; unit < nstrip + mon.n; unit += grid, ++k) {
    if (unit >= nstrip) {
      const size_t row = static_cast<size_t>(unit - nstrip) * V;
      __syncthreads();  // smem of the previous unit is no longer read
      monitor_row_batched(mon.x0 + row, mon.v1mean + row, V, a.flags & kXent, smem,
                          mon.rowerr + (unit - nstrip));
      continue;
    }
    const int cur = k & 1, next = unit + grid;
    if (tiled) {  // the next unit's tiles into the other buffer
      const long long bo = (cur ^ 1) * tf;
      if (next < nstrip) start_strip_tiles(a, tiles + bo, tiles + 2 * tf + bo, next, kVel);
      cp_async_commit();
    }
    const int q0 = unit * kUQ;
    const bool own = qb >= 0 && q0 + qb < V;
    const float ob = own ? ld(a.b + q0 + qb) : 0.0f;
    const float ovb = own ? ld(a.vb + q0 + qb) : 0.0f;
    float* sb = sbuf + cur * sfl;
    float* sd = sdif + cur * dfl;
    float dsum = 0.0f;  // the b thread: sum of v0 - vs of its row over the rows
    if (piped && qb >= 0) {
      for (int rr = 0; rr < nrows; ++rr) dsum += sd[rr * kUQ + qb];  // in row order
    }
    const Store* tw = reinterpret_cast<const Store*>(tiles + cur * tf);
    const Store* tv = reinterpret_cast<const Store*>(tiles + 2 * tf + cur * tf);
    for (int base = 0; base < nitem; base += kThreads) {
      // lanes 8h..8h+7 of a quarter warp share a half (one row of a tile) and take
      // consecutive column groups, so their reads of a tile row are conflict-free
      const int it = base + tid, hh = (it >> 3) & 1, g = ((it >> 4) << 3) | (it & 7);
      const int j0 = g * kUJ, qa = q0 + hh * kUH;
      const int nqa = j0 < H ? max(0, min(kUH, V - qa)) : 0;
      const size_t w0 = static_cast<size_t>(qa) * H + j0;
      const int t0 = hh * kUH * H + j0;  // the item's first value in a tile
      float pos[kUH][kUJ], neg[kUH][kUJ];
#pragma unroll
      for (int i = 0; i < kUH; ++i)
#pragma unroll
        for (int c = 0; c < kUJ; ++c) pos[i][c] = neg[i][c] = 0.0f;
      for (int ch = 0; ch < nchunk; ++ch) {
        const int r0 = ch * srows, nr = min(srows, nrows - r0);
        if (!piped) {  // stage this chunk of the strip inline
          __syncthreads();  // sb is no longer read
          stage_strip<kBf>(sb, sd, rows, V, q0, r0, tid, nr * 2 * kUQ);
          __syncthreads();
          if (base == 0 && qb >= 0) {
            for (int rr = 0; rr < nr; ++rr) dsum += sd[rr * kUQ + qb];  // in row order
          }
        }
        if (nqa > 0) {
#pragma unroll 2
          for (int rr = 0; rr < nr; ++rr) {
            const int r = r0 + rr;
            float hp[kUJ], hm[kUJ];
            if (hstaged) {
              const float4 x = *reinterpret_cast<const float4*>(hst + static_cast<size_t>(r) * hs4 + j0);
              const float4 y =
                  *reinterpret_cast<const float4*>(hst + rh + static_cast<size_t>(r) * hs4 + j0);
              hp[0] = x.x; hp[1] = x.y; hp[2] = x.z; hp[3] = x.w;
              hm[0] = y.x; hm[1] = y.y; hm[2] = y.z; hm[3] = y.w;
            } else {
#pragma unroll
              for (int c = 0; c < kUJ; ++c) {
                hp[c] = j0 + c < H ? op<kBf>(rows.hp(r, j0 + c)) : 0.0f;
                hm[c] = j0 + c < H ? op<kBf>(rows.hm(r, j0 + c)) : 0.0f;
              }
            }
            const float4* sv = reinterpret_cast<const float4*>(sb + rr * 2 * kUQ + hh * kUH);
#pragma unroll
            for (int i4 = 0; i4 < kUH / 4; ++i4) {
              const float4 x = sv[i4], y = sv[kUQ / 4 + i4];
              const float xv[4] = {x.x, x.y, x.z, x.w}, yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
              for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int c = 0; c < kUJ; ++c) {
                  pos[4 * i4 + q][c] = fmaf(xv[q], hp[c], pos[4 * i4 + q][c]);
                  neg[4 * i4 + q][c] = fmaf(yv[q], hm[c], neg[4 * i4 + q][c]);
                }
            }
          }
        }
      }
      // the old values after the sums (they hold no registers during them): from
      // this unit's tiles, else from device memory, all loads before the stores
      float old[kUH][kUJ], old_vel[kUH][kUJ];
#pragma unroll
      for (int i = 0; i < kUH; ++i) {
#pragma unroll
        for (int c = 0; c < kUJ; ++c) old[i][c] = old_vel[i][c] = 0.0f;
        if (i >= nqa) continue;
        const Store* pw = tiled ? tw + t0 + i * H : a.W + w0 + static_cast<size_t>(i) * H;
        const Store* pv = tiled ? tv + t0 + i * H : a.vW + w0 + static_cast<size_t>(i) * H;
        if (vec) {
          ld4(pw, old[i]);
          if (kVel) ld4(pv, old_vel[i]);
        } else {
#pragma unroll
          for (int c = 0; c < kUJ; ++c) {
            if (j0 + c >= H) continue;
            old[i][c] = ld(pw + c);
            if (kVel) old_vel[i][c] = ld(pv + c);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kUH; ++i) {
        if (i >= nqa) break;
        float nv[kUJ], np[kUJ];
#pragma unroll
        for (int c = 0; c < kUJ; ++c)
          apply_value(a, old[i][c], old_vel[i][c], (pos[i][c] - neg[i][c]) * inv_b, m, a.lr,
                      true, nv[c], np[c]);
        const size_t w = w0 + static_cast<size_t>(i) * H;
        if (vec) {
          st4(a.vW + w, nv);
          st4(a.W + w, np);
        } else {
#pragma unroll
          for (int c = 0; c < kUJ; ++c) {
            if (j0 + c < H) {
              st(a.vW + w + c, nv[c]);
              st(a.W + w + c, np[c]);
            }
          }
        }
      }
    }
    if (own)
      apply_loaded(a, a.b + q0 + qb, a.vb + q0 + qb, ob, ovb, dsum * inv_b, m, a.lr, false);
    if (piped && next < nstrip) {  // the next unit's strip into the other buffers
      float* nb_ = sbuf + (cur ^ 1) * sfl;
      float* nd = sdif + (cur ^ 1) * dfl;
#pragma unroll
      for (int k2 = 0; k2 < kUPre; ++k2) {
        const int idx = tid + k2 * kThreads;
        if (idx < nst) put_strip<kBf>(nb_, nd, rows, idx, pre[k2]);
      }
      stage_strip<kBf>(nb_, nd, rows, V, next * kUQ, 0, tid + kUPre * kThreads, nst);
      const int after = next + grid;
#pragma unroll
      for (int k2 = 0; k2 < kUPre; ++k2) {
        const int idx = tid + k2 * kThreads;
        if (after < nstrip && idx < nst) pre[k2] = strip_bits(rows, V, after * kUQ, 0, idx);
      }
    }
    cp_async_wait<0>();  // the next unit's tiles (this thread's copies)
    __syncthreads();
  }
  cp_async_wait<0>();  // no copy into shared memory outlives the phase
  const Split s;
  for (int o = s.gwarp; o < H; o += s.nwarps) {
    float acc = 0.0f, on = 0.0f;
    for (int r = s.lane; r < nrows; r += 32) {
      const float hp = rows.hp(r, o);
      acc += hp - rows.hm(r, o);
      on += hp;
    }
    acc = warp_sum(acc);
    on = warp_sum(on);
    if (s.lane != 0) continue;
    float g = acc * inv_b;
    if (a.flags & kSparsity) g = g + a.sparsity_cost * (a.sparsity_target - on * inv_b);
    apply(a, a.c + o, a.vc + o, g, m, a.lr, false);
  }
}

// The update (update_units), compiled without the old velocity's registers
// at momentum 0, where m * vel is 0 (vel is finite) and it is never read.
template <bool kBf, class A, class R>
__device__ __forceinline__ void update_phase(const A& a, const R rows, int nrows, float m,
                                             const Monitor mon) {
  if (m != 0.0f)
    update_units<kBf, true>(a, rows, nrows, m, mon);
  else
    update_units<kBf, false>(a, rows, nrows, m, mon);
}

}  // namespace
