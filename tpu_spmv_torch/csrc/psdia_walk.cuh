// The walks of the periodic streaming DIA SpMV, shared by K2 (psdia_spmv,
// dia_stream.cu: the padded row space of one pack) and K8b (psdia_ring,
// dist_stream.cu: one shard and its received slivers).  The two differ only
// in where a window's columns come from (WindowSource), the first row of
// the row mask (base) and their thin launchers.
//
// Both compute, for the local rows k of [0, cp),
//     y[k] = sum_d pattern[d, k mod rb] * xw(k + off_d)
// with xw the window source: column j is x[j] for 0 <= j < cp, left[h + j]
// for -h <= j < 0, right[j - cp] for cp <= j < cp + h, zero elsewhere (K2:
// x = xpad, cp = npad, h = 0), and rows whose base + k leaves [L, L + nrow)
// written as exact zeros.  cp is a multiple of rb, so the local phase of
// the pattern is the global one.
//
// What bounds them: device-memory bytes, x and y once each (the pattern
// is a few MB at most and stays in L2); one FMA per diagonal per row.  A
// thread read of x or of the pattern from L2 per diagonal and row puts the
// 4096^2 Poisson's x through L2 three times (its +-4096 reads fall 16 KB
// away, in other blocks' rows) and adds five pattern reads a row.  So a
// tile of kWalkTile rows (kWalkRows a thread, neighbouring threads on
// neighbouring rows: conflict-free shared-memory reads, coalesced stores)
// reads its windows of xw and its coefficient rows from shared memory,
// along one of two walks that the host plan picks
// (kernels/dia_stream.py:psdia_walk_plan):
//   - the stride walk, where the offsets sit near whole multiples j_d * S
//     of S = M * kWalkTile rows (the 2-D Poisson: S = 4096): one window a
//     tile; a block walks a segment of the tiles M apart and keeps the
//     windows of tiles i - 1, i and i + 1 (in steps of S) in a ring, so
//     each x value crosses into shared memory once.  Where S is a multiple
//     of the pattern's period every tile of the segment has the same
//     coefficient rows, staged once per segment (the plan's reuse flag);
//     else with each tile, in its window's slot;
//   - otherwise the cluster walk: one window per cluster of nearby offsets
//     per tile, with the tile's coefficient rows; the blocks walk the tiles
//     in row order together, so a far window another block fetched is in L2.
// Either walk takes only the tiles that hold rows of [L, L + nrow) and
// writes zeros in the others (a small grid's pack pads its row space to
// three times its rows).  An operand of few such tiles (direct_tiles, from
// K2's wrapper) runs one thread a row instead (psdia_walk_direct).
//
// How the stride walk's copies are made, chosen from the operands before
// the launch:
//   - bulk copies (psdia_walk_bulk; 16-byte aligned buffers, rb, cp and
//     h): a producer warp beside the kWalkThreads
//     consumer threads runs ahead along the same walk and asks for each
//     window with one cp.async.bulk per piece (one contiguous range of
//     xpad, clipped to [0, npad), for K2; up to three, left, x and right,
//     for K8b), and for the coefficient rows; completion arrives on the
//     slot's full mbarrier, and the consumer warps release a slot on its
//     empty mbarrier once no later tile reads it.  No consumer spends a
//     register or an instruction on a copy and none waits at a block-wide
//     barrier, so up to kBulkAhead windows are in flight (the plan's ahead:
//     as many as leave room for two blocks an SM).  The producer zeroes a
//     window's clipped columns (only the first and last tiles of a column
//     have any);
//   - cp.async, one value a copy (psdia_walk_stride; the V = 1 branch,
//     where the buffers or rb are not 16-byte aligned): each thread copies
//     its share of the window, selecting left, x or right per piece; one
//     window in flight and three blocks an SM (the register cap under
//     which the f64 walk does not spill).  It is K8b's former design with
//     one-value copies; with 16-byte ones it ran slower than the bulk walk
//     on every operand measured, and the bulk walk took its place.
// The cluster walk always copies with cp.async (16 bytes or one value a
// copy, kWalkStages - 1 stages in flight), and reads the offsets and the
// plan's table from shared memory.
//
// Each row sums its diagonals in stored order with fma from zero, from the
// values K2's former one-thread-a-row kernel read (a valid row never reads
// past the source's columns; masked rows are selected away, not
// multiplied), so K2, K8b at one shard and every column of K3b agree bit
// for bit; one writer per row, no atomics.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kWalkThreads = 256;
constexpr int kWalkRows = 4;
constexpr int kWalkTile = kWalkThreads * kWalkRows;
// slots in the cluster walk's ring: kWalkStages - 1 copies in flight
constexpr int kWalkStages = 4;
// the bulk stride walk's windows in flight, at most (the plan takes fewer
// where the ring would not leave room for two blocks an SM)
constexpr int kBulkAhead = 3;
// the stride walk reads at most three windows a tile (the plan's rule)
constexpr int kMaxSlots = 3 + kBulkAhead;

// where a window's columns come from (see the header)
template <typename T>
struct WindowSource {
  const T* x;
  const T* left;
  const T* right;
  int64_t cp, h;
};

// a walk's launch arguments from the host plan, made once per plan, row
// tile and device (kernels/dia_stream.py:_walk_args, a ctypes structure of
// the same layout)
struct WalkArgs {
  const int* offsets;  // the diagonals' offsets, stored order
  const int* table;    // the plan's table
  int64_t rb;
  int ndiags, nclusters, stride, slot, jspan, reuse;
  int ahead;  // the bulk stride walk's windows in flight (0: the clusters)
  // operands of at most this many tiles run psdia_walk_direct (K2's
  // wrapper: the card's SM count; 0: always the walk)
  int direct_tiles;
};

// the walk's geometry and the host plan's scalars
struct WalkShape {
  int64_t rb, base, L, nrow;
  // the tiles that hold rows of [L, L + nrow): t0 .. t0 + ntiles - 1 (the
  // launcher); the walks skip the others, whose rows are all zero
  int64_t t0, ntiles;
  int64_t seg;    // the stride walk: tiles per segment (launcher)
  int ndiags;
  int nclusters;  // the cluster walk's clusters of nearby offsets
  int stride;     // the stride walk's tile stride M (0: the cluster walk)
  int slot;       // elements of one ring slot
  int jspan;      // the stride walk: windows a tile reads
  int nslot;      // slots in the ring (launcher: jspan + windows in flight)
  int reuse;      // coefficient rows staged once per segment
};

// the first row of the walk's tile t
__device__ __forceinline__ int64_t tile_k0(const WalkShape& g, int64_t t) {
  return (g.t0 + t) * kWalkTile;
}

// the rows of no walked tile (before tile t0 and past the last) are zero:
// every thread of the grid writes a share
template <typename T>
__device__ __forceinline__ void zero_unwalked(T* __restrict__ y,
                                              const WalkShape& g,
                                              int64_t cp) {
  const int64_t lo = g.t0 * kWalkTile;
  int64_t hi = (g.t0 + g.ntiles) * kWalkTile;
  if (hi > cp) hi = cp;
  const int64_t n = lo + (cp - hi);
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < n; e += static_cast<int64_t>(gridDim.x) * blockDim.x)
    __stcs(y + (e < lo ? e : hi + (e - lo)), T(0));
}

// the cluster walk's ints behind its ring: the offsets, then the plan's
// table (nclusters + 1 starts, nclusters window starts and widths)
__host__ __device__ __forceinline__ int walk_ints(const WalkShape& g) {
  return g.stride ? 0 : g.ndiags + 3 * g.nclusters + 1;
}

// -- mbarriers and bulk copies (sm_90) -------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_address(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also expects BYTES of bulk copies on the barrier
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_address(bar)),
               "r"(bytes)
               : "memory");
}

// one arrival
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_address(bar))
               : "memory");
}

// wait until the barrier's phase of PARITY has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_address(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// order this thread's earlier shared-memory accesses before later bulk
// copies into the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// BYTES (a multiple of 16, both addresses 16-byte aligned) from device to
// shared memory, completing on BAR
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_address(dst)),
      "l"(src), "r"(bytes), "r"(smem_address(bar))
      : "memory");
}

// -- staging ---------------------------------------------------------------

// the pieces of window columns j0 .. j0 + w that the source holds: f(dst
// offset, source pointer, elements) for each non-empty one
template <typename T, typename F>
__device__ __forceinline__ void window_pieces(const WindowSource<T>& s,
                                              int64_t j0, int w, F f) {
  auto piece = [&](const T* base, int64_t begin, int64_t end) {
    const int64_t lo = j0 > begin ? j0 : begin;
    const int64_t hi = j0 + w < end ? j0 + w : end;
    if (hi > lo)
      f(static_cast<int>(lo - j0), base + (lo - begin),
        static_cast<int>(hi - lo));
  };
  if (s.h) piece(s.left, -s.h, 0);
  piece(s.x, 0, s.cp);
  if (s.h) piece(s.right, s.cp, s.cp + s.h);
}

// bytes of window columns j0 .. j0 + w that the source holds
template <typename T>
__device__ __forceinline__ unsigned window_bytes(const WindowSource<T>& s,
                                                 int64_t j0, int w) {
  unsigned bytes = 0;
  window_pieces(s, j0, w, [&](int, const T*, int n) {
    bytes += static_cast<unsigned>(n) * sizeof(T);
  });
  return bytes;
}

// zero the window columns j0 .. j0 + w outside [-h, cp + h), which the
// copies leave alone (every thread a share); true where this thread wrote
template <typename T>
__device__ __forceinline__ bool zero_clipped(T* __restrict__ win,
                                             const WindowSource<T>& s,
                                             int64_t j0, int w) {
  int64_t in0 = -s.h - j0, in1 = s.cp + s.h - j0;
  in0 = in0 < 0 ? 0 : (in0 > w ? w : in0);
  in1 = in1 < in0 ? in0 : (in1 > w ? w : in1);
  bool wrote = false;
  for (int v = threadIdx.x; v < w; v += kWalkThreads)
    if (v < in0 || v >= in1) {
      win[v] = T(0);
      wrote = true;
    }
  return wrote;
}

// copy window columns j0 .. j0 + w to win with cp.async, V elements per
// copy (j0, w, cp and h are then multiples of V: the plan and the launcher
// see to it); columns outside [-h, cp + h), which no stored row reads,
// are zero
template <typename T, int V>
__device__ __forceinline__ void stage_window_async(
    T* __restrict__ win, const WindowSource<T>& s, int64_t j0, int w) {
  for (int v = threadIdx.x * V; v < w; v += kWalkThreads * V) {
    const int64_t j = j0 + v;
    const T* src = nullptr;
    if (j < 0) {
      if (j >= -s.h) src = s.left + (s.h + j);
    } else if (j < s.cp) {
      src = s.x + j;
    } else if (j < s.cp + s.h) {
      src = s.right + (j - s.cp);
    }
    if (src) {
      cp_async<V * sizeof(T)>(win + v, src);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) win[v + i] = T(0);
    }
  }
}

// the pattern slot of local row k0 + r: (k0 + r) mod rb
__device__ __forceinline__ int64_t pattern_slot(int64_t s0, int r,
                                                int64_t rb) {
  int64_t s = s0 + r;
  if (s >= rb) s %= rb;
  return s;
}

// copy the coefficient rows of diagonals d0 .. d0 + nd for the tile's
// kWalkTile rows from pattern slot s0 = k0 mod rb on, with cp.async
template <typename T, int V>
__device__ __forceinline__ void stage_coef_async(T* __restrict__ coef,
                                                 const T* __restrict__ pattern,
                                                 int d0, int nd, int64_t s0,
                                                 int64_t rb) {
  for (int e = threadIdx.x * V; e < nd * kWalkTile; e += kWalkThreads * V)
    cp_async<V * sizeof(T)>(
        coef + e, pattern + (d0 + e / kWalkTile) * rb +
                      pattern_slot(s0, e % kWalkTile, rb));
}

// the same rows with plain loads, for the cp.async stride walk's
// once-per-segment coefficients (waiting for a cp.async group would also
// wait for the windows in flight)
template <typename T, int V>
struct alignas(sizeof(T) * V) Chunk {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load_coef(T* __restrict__ coef,
                                          const T* __restrict__ pattern,
                                          int nd, int64_t s0, int64_t rb) {
  using C = Chunk<T, V>;
  static_assert(sizeof(C) == V * sizeof(T), "a chunk is V values");
  for (int e = threadIdx.x * V; e < nd * kWalkTile; e += kWalkThreads * V)
    *reinterpret_cast<C*>(coef + e) = *reinterpret_cast<const C*>(
        pattern + (e / kWalkTile) * rb + pattern_slot(s0, e % kWalkTile, rb));
}

// the same rows of diagonals 0 .. nd with bulk copies (one thread), each
// row cut where it wraps at rb; returns the bytes asked for
template <typename T>
__device__ __forceinline__ unsigned bulk_coef(T* __restrict__ coef,
                                              const T* __restrict__ pattern,
                                              int nd, int64_t s0, int64_t rb,
                                              uint64_t* bar) {
  for (int d = 0; d < nd; ++d) {
    int64_t s = s0;
    for (int e = 0; e < kWalkTile;) {
      int n = kWalkTile - e;
      if (rb - s < n) n = static_cast<int>(rb - s);
      bulk_copy(coef + d * kWalkTile + e, pattern + d * rb + s,
                static_cast<unsigned>(n) * sizeof(T), bar);
      e += n;
      s = 0;
    }
  }
  return static_cast<unsigned>(nd) * kWalkTile * sizeof(T);
}

// one tile's rows from their sums: masked rows (base + k outside [L, L +
// nrow)) are zero, rows past cp are not written
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ y,
                                           const T (&acc)[kWalkRows],
                                           int64_t k0, int64_t cp,
                                           const WalkShape& g) {
#pragma unroll
  for (int a = 0; a < kWalkRows; ++a) {
    const int64_t k = k0 + threadIdx.x + a * kWalkThreads;
    const int64_t row = g.base + k;
    if (k < cp)
      __stcs(y + k, row >= g.L && row < g.L + g.nrow ? acc[a] : T(0));
  }
}

// -- the stride walk -------------------------------------------------------

// The window of tile t (columns k0 + a0 .. k0 + a0 + w) is also the window
// that diagonal d of tile t - j_d * stride reads.  Column c of the tiles is
// c, c + stride, c + 2 stride, ...; an item is a segment of seg
// consecutive tiles i0 .. i1 of one column (item = segment * stride +
// column, block b taking items b, b + gridDim.x, ...), and its copies are
// the windows of column positions i0 + jmin .. i1 - 1 + jmin + jspan - 1 in
// order; the copy of position p completes tile p - jmin - jspan + 1 and,
// without reuse, also stages that tile's coefficient rows.
struct StrideWalk {
  int64_t item, i0, i1, p;
  int column;
};

__device__ __forceinline__ void stride_item(StrideWalk& wk, int64_t item,
                                          int64_t nitems, int64_t ntiles,
                                          const WalkShape& g, int jmin) {
  for (wk.item = item; wk.item < nitems; wk.item += gridDim.x) {
    wk.column = static_cast<int>(wk.item % g.stride);
    wk.i0 = wk.item / g.stride * g.seg;
    const int64_t len = (ntiles - wk.column + g.stride - 1) / g.stride;
    if (wk.i0 < len) {
      wk.i1 = wk.i0 + g.seg < len ? wk.i0 + g.seg : len;
      wk.p = wk.i0 + jmin;
      return;
    }
  }
}

// The stride walk with cp.async, V elements a copy: one window in flight
// and three blocks an SM (under this cap the f64 walk does not spill; at
// the default cap it spills and runs slower)
template <typename T, int V>
__global__ void __launch_bounds__(kWalkThreads, 3)
    psdia_walk_stride(const T* __restrict__ pattern,
                      const int* __restrict__ offsets,
                      const int* __restrict__ table, WindowSource<T> src,
                      T* __restrict__ y, WalkShape g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  zero_unwalked(y, g, src.cp);
  // table: jmin, a0, w, then j_d of every diagonal; the ring holds the
  // jspan windows a tile reads and one in flight (nslot = jspan + 1)
  const int jmin = __ldg(table), a0 = __ldg(table + 1), w = __ldg(table + 2);
  const int* const jd = table + 3;
  const int jspan = g.jspan;
  const int nd = g.ndiags;
  // with reuse the segment's coefficient rows lead, then the ring of
  // windows; without, each slot holds a tile's rows and then its window
  T* const ring = smem + (g.reuse ? nd * kWalkTile : 0);
  const int wofs = g.reuse ? 0 : nd * kWalkTile;

  const int64_t ntiles = g.ntiles;
  const int64_t ncol = (ntiles + g.stride - 1) / g.stride;
  const int64_t nitems = (ncol + g.seg - 1) / g.seg * g.stride;
  const int64_t jlast = jmin + jspan - 1;
  const int64_t span = static_cast<int64_t>(g.stride) * kWalkTile;
  StrideWalk first;
  stride_item(first, blockIdx.x, nitems, ntiles, g, jmin);
  auto next = [&](StrideWalk& wk) {
    if (++wk.p > wk.i1 - 1 + jlast)
      stride_item(wk, wk.item + gridDim.x, nitems, ntiles, g, jmin);
  };
  auto issue = [&](const StrideWalk& wk, int slot) {
    if (wk.item < nitems) {
      T* const dst = ring + slot * g.slot;
      const int64_t i = wk.p - jlast;  // the tile this copy completes
      if (!g.reuse && i >= wk.i0)
        stage_coef_async<T, V>(dst, pattern, 0, nd,
                               tile_k0(g, wk.column + i * g.stride) % g.rb,
                               g.rb);
      stage_window_async<T, V>(
          dst + wofs, src, tile_k0(g, wk.column + wk.p * g.stride) + a0, w);
    }
    cp_async_commit();  // an empty group past the last copy keeps count
  };

  StrideWalk ahead = first;
  issue(ahead, 0);
  next(ahead);
  int slot_ahead = 1;

  const int ir = threadIdx.x;
  int slot = 0;
  for (StrideWalk wk = first; wk.item < nitems;) {
    issue(ahead, slot_ahead);
    next(ahead);
    slot_ahead = slot_ahead + 1 == g.nslot ? 0 : slot_ahead + 1;
    cp_async_wait<1>();  // this thread's copies up to wk's landed
    __syncthreads();     // and every other thread's
    if (g.reuse && wk.p == wk.i0 + jmin) {
      // a new segment: its tiles' coefficient rows, read by no tile of the
      // block's previous segment any more (the last __syncthreads)
      load_coef<T, V>(smem, pattern, nd,
                      tile_k0(g, wk.column + wk.i0 * g.stride) % g.rb, g.rb);
      __syncthreads();
    }
    const int64_t i = wk.p - jlast;
    if (i >= wk.i0) {  // tile i of the column has all its windows
      const T* const coef = (g.reuse ? smem : ring + slot * g.slot) + ir;
      T acc[kWalkRows];
#pragma unroll
      for (int a = 0; a < kWalkRows; ++a) acc[a] = T(0);
      // diagonals in stored order: K2's order and rounding
      for (int d = 0; d < nd; ++d) {
        const int j = __ldg(jd + d);
        // the slot of window i + j
        int ws = slot - static_cast<int>(jlast) + j;
        if (ws < 0) ws += g.nslot;
        const T* const xrow = ring + ws * g.slot + wofs + ir +
                              (__ldg(offsets + d) - j * span - a0);
#pragma unroll
        for (int a = 0; a < kWalkRows; ++a)
          acc[a] = fma(coef[d * kWalkTile + a * kWalkThreads],
                       xrow[a * kWalkThreads], acc[a]);
      }
      store_rows(y, acc, tile_k0(g, wk.column + i * g.stride), src.cp, g);
    }
    __syncthreads();  // the slot is read before a later copy refills it
    next(wk);
    slot = slot + 1 == g.nslot ? 0 : slot + 1;
  }
  cp_async_wait<0>();
}

// The stride walk by bulk copy, warp-specialised: kWalkThreads consumer
// threads compute the tiles as psdia_walk_stride does, and one producer
// warp runs ahead of them along the same walk, asking for each window
// (and, without reuse, its tile's coefficient rows) with one bulk copy
// per piece into the ring's next slot as soon as the consumers have
// released it.  Slot s has two barriers: full[s] completes when its
// copies have landed (the producer's one arrival and the bytes), empty[s]
// when every consumer warp has read it for the last time (the window of
// position t is last read by the tile of iteration t + jspan - 1).  The
// once-per-segment coefficient rows have their pair too.  No block-wide
// barrier: a consumer warp waits only for the copies it reads, so the
// copies of up to nslot - jspan windows are in flight while it computes.
constexpr int kBulkThreads = kWalkThreads + 32;

template <typename T>
__global__ void __launch_bounds__(kBulkThreads, 3)
    psdia_walk_bulk(const T* __restrict__ pattern,
                    const int* __restrict__ offsets,
                    const int* __restrict__ table, WindowSource<T> src,
                    T* __restrict__ y, WalkShape g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxSlots], empty[kMaxSlots],
      coef_full, coef_empty;
  constexpr int kConsumerWarps = kWalkThreads / 32;
  T* const smem = reinterpret_cast<T*>(smem_raw);
  zero_unwalked(y, g, src.cp);
  const int jmin = __ldg(table), a0 = __ldg(table + 1), w = __ldg(table + 2);
  const int* const jd = table + 3;
  const int jspan = g.jspan;
  const int nd = g.ndiags;
  T* const ring = smem + (g.reuse ? nd * kWalkTile : 0);
  const int wofs = g.reuse ? 0 : nd * kWalkTile;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.nslot; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_init(&coef_full, 1);
    mbar_init(&coef_empty, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int64_t ntiles = g.ntiles;
  const int64_t ncol = (ntiles + g.stride - 1) / g.stride;
  const int64_t nitems = (ncol + g.seg - 1) / g.seg * g.stride;
  const int64_t jlast = jmin + jspan - 1;
  const int64_t span = static_cast<int64_t>(g.stride) * kWalkTile;
  StrideWalk wk;
  stride_item(wk, blockIdx.x, nitems, ntiles, g, jmin);
  auto next = [&](StrideWalk& v) {
    if (++v.p > v.i1 - 1 + jlast)
      stride_item(v, v.item + gridDim.x, nitems, ntiles, g, jmin);
  };
  const int lane = threadIdx.x % 32;

  if (threadIdx.x >= kWalkThreads) {
    // the producer warp; the parity to wait for starts at 1, which a
    // fresh barrier passes (every slot starts free)
    unsigned released = (1u << kMaxSlots) - 1u, coef_released = 1u;
    for (int slot = 0; wk.item < nitems;) {
      mbar_wait(empty + slot, (released >> slot) & 1u);
      released ^= 1u << slot;
      T* const dst = ring + slot * g.slot;
      const int64_t i = wk.p - jlast;  // the tile this copy completes
      const bool coef = !g.reuse && i >= wk.i0;
      const int64_t j0 = tile_k0(g, wk.column + wk.p * g.stride) + a0;
      // the window's clipped columns (only at the ends of the source)
      int64_t in0 = -src.h - j0, in1 = src.cp + src.h - j0;
      if (in0 > 0 || in1 < w) {
        for (int v = lane; v < w; v += 32)
          if (v < in0 || v >= in1) dst[wofs + v] = T(0);
        fence_proxy_async();
      }
      __syncwarp();
      if (g.reuse && wk.p == wk.i0 + jmin) {
        // a new segment: its coefficient rows, once the consumers are done
        // with the last segment's
        mbar_wait(&coef_empty, coef_released);
        coef_released ^= 1u;
        if (lane == 0)
          mbar_arrive_expect(
              &coef_full,
              bulk_coef(smem, pattern, nd,
                        tile_k0(g, wk.column + wk.i0 * g.stride) % g.rb,
                        g.rb, &coef_full));
      }
      if (lane == 0) {
        uint64_t* const bar = full + slot;
        mbar_arrive_expect(
            bar, window_bytes(src, j0, w) +
                     (coef ? static_cast<unsigned>(nd) * kWalkTile * sizeof(T)
                           : 0u));
        if (coef)
          bulk_coef(dst, pattern, nd,
                    tile_k0(g, wk.column + i * g.stride) % g.rb, g.rb, bar);
        window_pieces(src, j0, w, [&](int o, const T* p, int n) {
          bulk_copy(dst + wofs + o, p, static_cast<unsigned>(n) * sizeof(T),
                    bar);
        });
      }
      next(wk);
      slot = slot + 1 == g.nslot ? 0 : slot + 1;
    }
    return;
  }

  // the consumers
  const int ir = threadIdx.x;
  unsigned landed = 0, coef_landed = 0;  // the parity to wait for
  int slot = 0, t = 0;
  for (; wk.item < nitems; ++t) {
    mbar_wait(full + slot, (landed >> slot) & 1u);  // wk's window landed
    landed ^= 1u << slot;
    const int64_t i = wk.p - jlast;
    if (i >= wk.i0) {  // tile i of the column has all its windows
      if (g.reuse && i == wk.i0) {
        mbar_wait(&coef_full, coef_landed);
        coef_landed ^= 1u;
      }
      const T* const coef = (g.reuse ? smem : ring + slot * g.slot) + ir;
      T acc[kWalkRows];
#pragma unroll
      for (int a = 0; a < kWalkRows; ++a) acc[a] = T(0);
      // diagonals in stored order: K2's order and rounding
      for (int d = 0; d < nd; ++d) {
        const int j = __ldg(jd + d);
        int ws = slot - static_cast<int>(jlast) + j;  // window i + j's slot
        if (ws < 0) ws += g.nslot;
        const T* const xrow = ring + ws * g.slot + wofs + ir +
                              (__ldg(offsets + d) - j * span - a0);
#pragma unroll
        for (int a = 0; a < kWalkRows; ++a)
          acc[a] = fma(coef[d * kWalkTile + a * kWalkThreads],
                       xrow[a * kWalkThreads], acc[a]);
      }
      store_rows(y, acc, tile_k0(g, wk.column + i * g.stride), src.cp, g);
      if (g.reuse && i == wk.i1 - 1) {  // the segment's last tile
        __syncwarp();
        if (lane == 0) mbar_arrive(&coef_empty);
      }
    }
    // the window no later tile reads: that of position t - jspan + 1
    if (t >= jspan - 1) {
      int rs = slot - (jspan - 1);
      if (rs < 0) rs += g.nslot;
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + rs);
    }
    next(wk);
    slot = slot + 1 == g.nslot ? 0 : slot + 1;
  }
}

// -- the cluster walk ------------------------------------------------------

// One stage of a block: a row tile and one cluster of diagonals; block b
// takes tiles b, b + gridDim.x, ..., so the blocks walk the tiles in row
// order together and a window that one block fetched is in L2 for the
// blocks that read it again as another cluster's window.  table: the
// plan's cluster starts (nclusters + 1 diagonal indices), then each
// cluster's window start a0 and width w.  The offsets and the table are
// read once into shared memory behind the ring (walk_ints), so that no
// diagonal of a tile waits on a load from L2: an operand of a few tiles
// has one tile a block, and its time is that chain of latencies.
template <typename T, int V>
__global__ void __launch_bounds__(kWalkThreads)
    psdia_walk_clusters(const T* __restrict__ pattern,
                        const int* __restrict__ offsets,
                        const int* __restrict__ table, WindowSource<T> src,
                        T* __restrict__ y, WalkShape g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  int* const s_off = reinterpret_cast<int*>(smem + kWalkStages * g.slot);
  zero_unwalked(y, g, src.cp);
  for (int i = threadIdx.x; i < walk_ints(g); i += kWalkThreads)
    s_off[i] = i < g.ndiags ? __ldg(offsets + i) : __ldg(table + i - g.ndiags);
  __syncthreads();
  const int* const cstart = s_off + g.ndiags;
  const int* const ca0 = cstart + g.nclusters + 1;
  const int* const cwidth = ca0 + g.nclusters;
  const int64_t ntiles = g.ntiles;

  // stage (tile, cluster c) into a slot: the cluster's coefficient rows
  // [nd, kWalkTile], then its window
  auto issue = [&](int64_t tile, int c, int slot) {
    if (tile < ntiles) {
      const int d0 = cstart[c];
      const int nd = cstart[c + 1] - d0;
      T* const dst = smem + slot * g.slot;
      const int64_t k0 = tile_k0(g, tile);
      stage_coef_async<T, V>(dst, pattern, d0, nd, k0 % g.rb, g.rb);
      stage_window_async<T, V>(dst + nd * kWalkTile, src, k0 + ca0[c],
                               cwidth[c]);
    }
    cp_async_commit();  // an empty group past the last stage keeps count
  };
  auto next = [&](int64_t& tile, int& c) {
    if (++c == g.nclusters) {
      c = 0;
      tile += gridDim.x;
    }
  };

  int64_t tile_ahead = blockIdx.x;
  int c_ahead = 0, slot_ahead = 0;
  for (int i = 0; i < kWalkStages - 1; ++i) {
    issue(tile_ahead, c_ahead, slot_ahead);
    next(tile_ahead, c_ahead);
    slot_ahead = slot_ahead + 1 == kWalkStages ? 0 : slot_ahead + 1;
  }

  const int ir = threadIdx.x;
  T acc[kWalkRows];
#pragma unroll
  for (int a = 0; a < kWalkRows; ++a) acc[a] = T(0);
  int slot = 0, c = 0;
  for (int64_t tile = blockIdx.x; tile < ntiles;) {
    issue(tile_ahead, c_ahead, slot_ahead);
    next(tile_ahead, c_ahead);
    slot_ahead = slot_ahead + 1 == kWalkStages ? 0 : slot_ahead + 1;
    cp_async_wait<kWalkStages - 1>();  // this thread's copies landed
    __syncthreads();                   // and every other thread's

    const int d0 = cstart[c];
    const int nd = cstart[c + 1] - d0;
    const int a0 = ca0[c];
    const T* const coef = smem + slot * g.slot + ir;
    const T* const win = coef + nd * kWalkTile - a0;
    // diagonals in stored order: K2's order and rounding
    for (int dd = 0; dd < nd; ++dd) {
      const T* const xrow = win + s_off[d0 + dd];
#pragma unroll
      for (int a = 0; a < kWalkRows; ++a)
        acc[a] = fma(coef[dd * kWalkTile + a * kWalkThreads],
                     xrow[a * kWalkThreads], acc[a]);
    }
    if (c == g.nclusters - 1) {  // the tile's last cluster: store
      store_rows(y, acc, tile_k0(g, tile), src.cp, g);
#pragma unroll
      for (int a = 0; a < kWalkRows; ++a) acc[a] = T(0);
    }
    __syncthreads();  // the slot is read before a later stage refills it
    next(tile, c);
    slot = slot + 1 == kWalkStages ? 0 : slot + 1;
  }
  cp_async_wait<0>();
}

// -- few tiles: one thread a row -------------------------------------------

// An operand of few tiles sits in L2, and on a walk a block stages one or
// two of them (a tile's coefficient rows are nd times its window) with
// most SMs idle: staging then costs more than it saves.  Here each thread
// owns one row and reads its coefficients and columns through L1 (the
// pattern is small): the same values, the same fma order from zero and
// the same row mask as the walks.
template <typename T>
__device__ __forceinline__ T window_value(const WindowSource<T>& s,
                                          int64_t j) {
  if (j < 0) return j >= -s.h ? __ldg(s.left + (s.h + j)) : T(0);
  if (j < s.cp) return __ldg(s.x + j);
  return j < s.cp + s.h ? __ldg(s.right + (j - s.cp)) : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kWalkThreads)
    psdia_walk_direct(const T* __restrict__ pattern,
                      const int* __restrict__ offsets, WindowSource<T> src,
                      T* __restrict__ y, WalkShape g) {
  extern __shared__ int s_offsets[];
  for (int d = threadIdx.x; d < g.ndiags; d += kWalkThreads)
    s_offsets[d] = __ldg(offsets + d);
  __syncthreads();
  const int64_t k =
      static_cast<int64_t>(blockIdx.x) * kWalkThreads + threadIdx.x;
  if (k >= src.cp) return;
  const int64_t row = g.base + k;
  T acc = T(0);
  if (row >= g.L && row < g.L + g.nrow) {  // masked rows read nothing
    const int64_t slot = k % g.rb;
    // diagonals in stored order: K2's order and rounding
    for (int d = 0; d < g.ndiags; ++d)
      acc = fma(__ldg(pattern + d * g.rb + slot),
                window_value(src, k + s_offsets[d]), acc);
  }
  __stcs(y + k, acc);
}

// -- the launcher ----------------------------------------------------------

// the device's SM count, read once per device
inline int sm_count(int dev) {
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices] = {};
  if (dev >= 0 && dev < kMaxDevices && sms[dev]) return sms[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev >= 0 && dev < kMaxDevices) sms[dev] = n;
  return n;
}

// resident blocks an SM of `kernel` at `smem` bytes on device `dev`, with
// the kernel's shared-memory limit raised there first; answers are kept (an
// operand launches again with the same ring), the oldest dropped first
template <typename K>
cudaError_t blocks_per_sm(K kernel, int threads, int dev, size_t smem,
                          int* per_sm) {
  struct Seen {
    const void* fn;
    int dev;
    size_t smem;
    int per_sm;
  };
  constexpr int kSeen = 16;
  static Seen seen[kSeen];
  static int nseen = 0, oldest = 0;
  const void* fn = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < nseen; ++i)
    if (seen[i].fn == fn && seen[i].dev == dev && seen[i].smem == smem) {
      *per_sm = seen[i].per_sm;
      return cudaSuccess;
    }
  // above 48 KB only with the kernel's limit raised (per device), to what
  // its static shared memory (the bulk walk's barriers) leaves
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemMax - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (nseen < kSeen) {
    seen[nseen++] = Seen{fn, dev, smem, *per_sm};
  } else {
    seen[oldest] = Seen{fn, dev, smem, *per_sm};
    oldest = (oldest + 1) % kSeen;
  }
  return cudaSuccess;
}

// launch one of the walks (kernel, with threads a block) with persistent
// blocks: as many as the card holds at once, no more than there are items
template <typename T, typename K>
int launch_walk_t(K kernel, int threads, const T* pattern, const int* offsets,
                  const int* table, const WindowSource<T>& src, T* y,
                  WalkShape g, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(g.nslot) * g.slot +
       (g.reuse ? static_cast<size_t>(g.ndiags) * kWalkTile : 0)) *
          sizeof(T) +
      static_cast<size_t>(walk_ints(g)) * sizeof(int);
  int dev = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = blocks_per_sm(kernel, threads, dev, smem, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t resident =
      static_cast<int64_t>(sm_count(dev)) * (per_sm > 0 ? per_sm : 1);
  const int64_t ntiles = g.ntiles;
  int64_t items = ntiles;
  if (g.stride) {
    // segments of a column, as long as one wave of blocks needs (a segment
    // re-reads jspan - 1 windows): the fewest items that one wave holds
    const int64_t ncol = (ntiles + g.stride - 1) / g.stride;
    g.seg = (ntiles + resident - 1) / resident;
    if (g.seg < 1) g.seg = 1;
    while (g.seg < ncol && (ncol + g.seg - 1) / g.seg * g.stride > resident)
      ++g.seg;
    if (g.seg > ncol) g.seg = ncol < 1 ? 1 : ncol;
    items = (ncol + g.seg - 1) / g.seg * g.stride;
  }
  int64_t blocks = resident < items ? resident : items;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      pattern, offsets, table, src, y, g);
  return static_cast<int>(cudaGetLastError());
}

// The walk with the host plan, for K2 and K8b alike: stride 0 walks the
// clusters (a ring of kWalkStages slots), stride M > 0 walks the tiles M
// apart, each tile reading the windows of jspan consecutive column
// positions (reuse: the coefficient rows once per segment).  Chosen from
// the operands before the launch: where the pattern, the source's
// buffers, rb, cp and h are 16-byte aligned, the stride walk copies by bulk
// copy with a ring of jspan + ahead slots (the plan's ahead: the most
// windows up to kBulkAhead that leave room for two blocks an SM, else one);
// otherwise
// (the V = 1 branch) with cp.async one value a copy and a ring of jspan +
// 1 slots.  The cluster walk copies 16 bytes a copy where aligned.  The
// walks take only the tiles that hold rows of [L, L + nrow) and zero the
// rest; an operand of at most direct_tiles such tiles runs
// psdia_walk_direct instead.
template <typename T>
int launch_walk(const WalkArgs& a, const void* pattern,
                const WindowSource<T>& src, void* y, int64_t base, int64_t L,
                int64_t nrow, void* stream) {
  const int ndiags = a.ndiags, nclusters = a.nclusters, stride = a.stride,
            slot = a.slot, jspan = a.jspan, reuse = a.reuse, ahead = a.ahead;
  const int64_t rb = a.rb;
  if (src.cp <= 0) return 0;
  const size_t coef = reuse ? static_cast<size_t>(ndiags) * kWalkTile : 0;
  auto ring_bytes = [&](int nslot) {
    return (static_cast<size_t>(nslot) * slot + coef) * sizeof(T);
  };
  WalkShape g;
  g.rb = rb;
  g.base = base;
  g.L = L;
  g.nrow = nrow;
  g.seg = 0;
  g.ndiags = ndiags;
  g.nclusters = nclusters;
  g.stride = stride;
  g.slot = slot;
  g.jspan = jspan;
  g.nslot = stride ? jspan + 1 : kWalkStages;
  g.reuse = reuse;
  // the tiles that hold rows of [L, L + nrow)
  const int64_t all = (src.cp + kWalkTile - 1) / kWalkTile;
  const int64_t lo = L - base, hi = L + nrow - base;
  g.t0 = lo <= 0 ? 0 : (lo / kWalkTile < all ? lo / kWalkTile : all);
  const int64_t t1 =
      hi <= 0 ? 0 : ((hi + kWalkTile - 1) / kWalkTile < all
                         ? (hi + kWalkTile - 1) / kWalkTile
                         : all);
  g.ntiles = t1 > g.t0 ? t1 - g.t0 : 0;
  if (ndiags < 1 || slot < 1 || stride < 0 || rb < 1 || src.h < 0 ||
      (stride == 0 && (nclusters < 1 || jspan != 0 || reuse || ahead)) ||
      (stride > 0 && (nclusters != 1 || jspan < 1 || jspan > 3 ||
                      ahead < 1 || ahead > kBulkAhead)) ||
      ring_bytes(g.nslot) + walk_ints(g) * sizeof(int) > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(T);
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool aligned =
      a16(pattern) && a16(src.x) && (src.h == 0 || (a16(src.left) &&
                                                    a16(src.right))) &&
      rb % V == 0 && src.cp % V == 0 && src.h % V == 0;
  const T* const pat = static_cast<const T*>(pattern);
  const int* const offs = a.offsets;
  const int* const tab = a.table;
  T* const out = static_cast<T*>(y);
  const auto st = static_cast<cudaStream_t>(stream);
  if (g.ntiles <= a.direct_tiles) {
    psdia_walk_direct<T><<<static_cast<unsigned>(
                               (src.cp + kWalkThreads - 1) / kWalkThreads),
                           kWalkThreads, ndiags * sizeof(int), st>>>(
        pat, offs, src, out, g);
    return static_cast<int>(cudaGetLastError());
  }
  if (!stride)
    return aligned ? launch_walk_t(psdia_walk_clusters<T, V>, kWalkThreads,
                                   pat, offs, tab, src, out, g, st)
                   : launch_walk_t(psdia_walk_clusters<T, 1>, kWalkThreads,
                                   pat, offs, tab, src, out, g, st);
  // the bulk walk's barriers take static shared memory beside the ring
  if (aligned && ring_bytes(jspan + ahead) +
                         (2 * kMaxSlots + 2) * sizeof(uint64_t) <=
                     static_cast<size_t>(kSmemMax)) {
    g.nslot = jspan + ahead;
    return launch_walk_t(psdia_walk_bulk<T>, kBulkThreads, pat, offs, tab,
                         src, out, g, st);
  }
  return launch_walk_t(psdia_walk_stride<T, 1>, kWalkThreads, pat, offs, tab,
                       src, out, g, st);
}

}  // namespace
