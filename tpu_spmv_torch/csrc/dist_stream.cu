// Sharded streaming DIA kernels for Hopper (sm_90a): K8a (SDIA ring) and K8b
// (PSDIA ring), the local kernels of the distributed streaming strategies.
//
// Replaces the Pallas TPU kernels of the JAX reference package:
//   K8a tpu_spmv/dist/planned.py:_sdia_ring_kernel   (spmv_sdia_sharded)
//   K8b tpu_spmv/dist/planned.py:_psdia_ring_kernel  (spmv_psdia_sharded)
//
// One launch computes one shard.  The shard owns cp consecutive rows of the
// pack's padded row space (cp a multiple of the row tile rb); x is its own
// chunk of cp values, left the last h values of the previous shard's chunk
// and right the first h values of the next shard's chunk (ring order: shard
// 0's left neighbour is the last shard, and at one shard both are its own
// chunk).  h >= the band, so every read falls in the window
//     xw(j) = left[h + j]  for j < 0,  x[j]  for 0 <= j < cp,
//             right[j - cp] for j >= cp,
// and for local row k
//     y[k] = sum_d coef(d, k) * xw(k + off_d)
// with coef(d, k) = data[d * cp + k] for SDIA and pattern[d * rb + k % rb]
// for PSDIA (cp a multiple of rb, so the local phase is the global one).
// PSDIA writes exact zeros where base + k leaves [L, L + nrow), base being
// the shard's first padded row.  Wrapped reads at the ring's ends meet zero
// data (SDIA pad rows) or masked rows (PSDIA), as in the TPU kernels: they
// are reproduced, not special-cased.
//
// What bounds them on this card: device-memory bytes, as for K1/K2 (one FMA
// per diagonal per row): SDIA streams its data, x and y, about
// (ndiags + 2) * cp * sizeof(T); PSDIA only x and y; the slivers add 2h
// values.
//
// K8a keeps the structure of K1 in dia_stream.cu: one thread per padded row
// in a grid-stride loop, coalesced loads, the offsets in shared memory; each
// read picks its buffer with two compares.  It sums the diagonals in their
// stored (ascending offset) order in one thread: no atomics, bitwise
// reproducible, and (a wrapped read times zero data adding exactly zero)
// bitwise equal to K1 on the same pack, which skips reads outside the
// padded row space instead.
//
// K8b stages x and the coefficients in shared memory, the design of K3b's
// (dia_stream.cu) at one right-hand side: a thread read of x or of the
// pattern from L2 per diagonal and row would put the 4096^2 Poisson's x
// through L2 three times (its +-4096 reads fall 16 KB away, in other
// blocks' rows) and add five pattern reads a row.  A tile is kRingTile
// rows, kRingRows a thread; a window of the ring [left | x | right] is
// copied into a ring of shared-memory slots with cp.async, copies in flight
// while the block computes from an earlier slot (one window for the stride
// walk, which ran faster so than with two or three, kRingStages - 1 stages
// for the cluster walk), and the copy helper takes each 16-byte piece from
// left, x or right (zeros outside [-h, cp + h), columns no row reads), so
// the inner loop has no select.  The host
// plan (kernels/dist_stream.py:psdia_ring_plan, kept with the sharded pack)
// picks one of K3b's two walks:
//   - the stride walk, where the offsets sit near whole multiples j_d * S
//     of S = M * kRingTile rows (the 2-D Poisson: S = 4096): one window a
//     tile; a block walks a segment of the tiles M apart and keeps the
//     windows of tiles i - 1, i and i + 1 (in steps of S) in the ring, so
//     each x value crosses into shared memory once.  Where S is a multiple
//     of the pattern's period, every tile of the segment has the same
//     coefficient rows: the block stages them once per segment (the plan's
//     reuse flag); else with each tile;
//   - otherwise the cluster walk: one window per cluster of nearby offsets
//     per tile, with the tile's coefficient rows; the blocks walk the tiles
//     in row order together.
// Persistent blocks, as many as the card holds at once; rows whose base + k
// leaves [L, L + nrow) are written as zeros.  Each row sums its diagonals
// in stored order with fma, as K2 does, from the values K2 reads (at one
// shard the valid rows never read past the padded row space), so K8b is
// bitwise K2 on the same pack at one shard and the sharded chain bitwise
// the single-chip product; one writer per row, no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
// one full wave on an H100: 132 SMs x 8 resident blocks of 256 threads
constexpr int kMaxBlocks = 132 * 8;

inline int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

template <typename T>
__device__ __forceinline__ T window(const T* __restrict__ x,
                                    const T* __restrict__ left,
                                    const T* __restrict__ right, int64_t j,
                                    int64_t cp, int64_t h) {
  return j < 0 ? left[h + j] : (j < cp ? x[j] : right[j - cp]);
}

template <typename T>
__global__ void sdia_ring(const T* __restrict__ data,
                          const int* __restrict__ offsets, int ndiags,
                          const T* __restrict__ x, const T* __restrict__ left,
                          const T* __restrict__ right, T* __restrict__ y,
                          int64_t cp, int64_t h) {
  extern __shared__ int s_off[];
  for (int d = threadIdx.x; d < ndiags; d += blockDim.x) s_off[d] = offsets[d];
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < cp; k += stride) {
    T acc = T(0);
    for (int d = 0; d < ndiags; ++d)
      acc += data[d * cp + k] * window(x, left, right, k + s_off[d], cp, h);
    y[k] = acc;
  }
}

// ---------------------------------------------------------------------------
// K8b psdia_ring: windows of the ring staged in shared memory (see the header)
// ---------------------------------------------------------------------------

// K8b's tile: kRingRows rows a thread, neighbouring threads on neighbouring
// rows (conflict-free shared-memory reads, coalesced stores)
constexpr int kRingRows = 4;
constexpr int kRingTile = kThreads * kRingRows;
// slots in the cluster walk's ring: kRingStages - 1 copies in flight
constexpr int kRingStages = 4;

// the shard's geometry and the host plan's scalars
struct RingShape {
  int64_t rb, cp, h, base, L, nrow;
  int64_t seg;    // the stride walk: tiles per segment (launcher)
  int ndiags;
  int nclusters;  // the cluster walk's clusters of nearby offsets
  int stride;     // the stride walk's tile stride M (0: the cluster walk)
  int slot;       // elements of one ring slot
  int nslot;      // slots in the ring (launcher: the walk's constant)
  int reuse;      // coefficient rows staged once per segment
};

// copy columns j0 .. j0 + w of the ring [left | x | right] to win, V
// elements per copy (j0, w, cp and h are then multiples of V: the plan and
// the launcher see to it); columns outside [-h, cp + h), which no row
// reads, are zero
template <typename T, int V>
__device__ __forceinline__ void stage_ring_window(
    T* __restrict__ win, const T* __restrict__ x, const T* __restrict__ left,
    const T* __restrict__ right, int64_t j0, int w, const RingShape& g) {
  for (int v = threadIdx.x * V; v < w; v += kThreads * V) {
    const int64_t j = j0 + v;
    const T* src = nullptr;
    if (j < 0) {
      if (j >= -g.h) src = left + (g.h + j);
    } else if (j < g.cp) {
      src = x + j;
    } else if (j < g.cp + g.h) {
      src = right + (j - g.cp);
    }
    if (src) {
      cp_async<V * sizeof(T)>(win + v, src);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) win[v + i] = T(0);
    }
  }
}

// the pattern slot of local row k0 + r: (k0 + r) mod rb (the shard's rows
// start at a whole row tile, so the local phase is the global one)
__device__ __forceinline__ int64_t pattern_slot(int64_t s0, int r,
                                                int64_t rb) {
  int64_t s = s0 + r;
  if (s >= rb) s %= rb;
  return s;
}

// copy the coefficient rows of diagonals d0 .. d0 + nd for the tile's
// kRingTile rows from pattern slot s0 = k0 mod rb on
template <typename T, int V>
__device__ __forceinline__ void stage_ring_coef(T* __restrict__ coef,
                                                const T* __restrict__ pattern,
                                                int d0, int nd, int64_t s0,
                                                int64_t rb) {
  for (int e = threadIdx.x * V; e < nd * kRingTile; e += kThreads * V)
    cp_async<V * sizeof(T)>(
        coef + e, pattern + (d0 + e / kRingTile) * rb +
                      pattern_slot(s0, e % kRingTile, rb));
}

// the same rows with plain loads, for the stride walk's once-per-segment
// coefficients (waiting for a cp.async group would also wait for the
// windows in flight)
template <typename T, int V>
struct alignas(sizeof(T) * V) Chunk {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load_ring_coef(T* __restrict__ coef,
                                               const T* __restrict__ pattern,
                                               int nd, int64_t s0,
                                               int64_t rb) {
  using C = Chunk<T, V>;
  static_assert(sizeof(C) == V * sizeof(T), "a chunk is V values");
  for (int e = threadIdx.x * V; e < nd * kRingTile; e += kThreads * V)
    *reinterpret_cast<C*>(coef + e) = *reinterpret_cast<const C*>(
        pattern + (e / kRingTile) * rb + pattern_slot(s0, e % kRingTile, rb));
}

// one tile's rows from their sums: masked rows (base + k outside [L, L +
// nrow)) are zero, rows past the shard are not written
template <typename T>
__device__ __forceinline__ void store_ring_rows(T* __restrict__ y,
                                                const T (&acc)[kRingRows],
                                                int64_t k0,
                                                const RingShape& g) {
#pragma unroll
  for (int a = 0; a < kRingRows; ++a) {
    const int64_t k = k0 + threadIdx.x + a * kThreads;
    const int64_t row = g.base + k;
    if (k < g.cp) __stcs(y + k, row >= g.L && row < g.L + g.nrow ? acc[a]
                                                                 : T(0));
  }
}

// The stride walk: the window of tile t (columns k0 + a0 .. k0 + a0 + w)
// is also the window that diagonal d of tile t - j_d * stride reads.
// Column c of the tiles is c, c + stride, c + 2 stride, ...; an item is a
// segment of seg consecutive tiles i0 .. i1 of one column (item = segment *
// stride + column, block b taking items b, b + gridDim.x, ...), and its
// copies are the windows of column positions i0 + jmin .. i1 - 1 + jmin +
// jspan - 1 in order; the copy of position p completes tile p - jmin -
// jspan + 1 and, without reuse, also stages that tile's coefficient rows.
struct RingWalk {
  int64_t item, i0, i1, p;
  int column;
};

__device__ __forceinline__ void ring_item(RingWalk& wk, int64_t item,
                                          int64_t nitems, int64_t ntiles,
                                          const RingShape& g, int jmin) {
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

// three blocks an SM: the register cap under which the f64 walk does not
// spill (at the default cap it spills and runs slower)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 3)
    psdia_ring_stride(const T* __restrict__ pattern,
                      const int* __restrict__ offsets,
                      const int* __restrict__ table, const T* __restrict__ x,
                      const T* __restrict__ left,
                      const T* __restrict__ right, T* __restrict__ y,
                      RingShape g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  // table: jmin, a0, w, then j_d of every diagonal; the ring holds the
  // jspan windows a tile reads and one in flight (nslot = jspan + 1)
  const int jmin = __ldg(table), a0 = __ldg(table + 1), w = __ldg(table + 2);
  const int* const jd = table + 3;
  const int jspan = g.nslot - 1;
  const int nd = g.ndiags;
  // with reuse the segment's coefficient rows lead, then the ring of
  // windows; without, each slot holds a tile's rows and then its window
  T* const ring = smem + (g.reuse ? nd * kRingTile : 0);
  const int wofs = g.reuse ? 0 : nd * kRingTile;

  const int64_t ntiles = (g.cp + kRingTile - 1) / kRingTile;
  const int64_t ncol = (ntiles + g.stride - 1) / g.stride;
  const int64_t nitems = (ncol + g.seg - 1) / g.seg * g.stride;
  const int64_t jlast = jmin + jspan - 1;
  const int64_t span = static_cast<int64_t>(g.stride) * kRingTile;
  RingWalk first;
  ring_item(first, blockIdx.x, nitems, ntiles, g, jmin);
  auto next = [&](RingWalk& wk) {
    if (++wk.p > wk.i1 - 1 + jlast)
      ring_item(wk, wk.item + gridDim.x, nitems, ntiles, g, jmin);
  };
  auto issue = [&](const RingWalk& wk, int slot) {
    if (wk.item < nitems) {
      T* const dst = ring + slot * g.slot;
      const int64_t i = wk.p - jlast;  // the tile this copy completes
      if (!g.reuse && i >= wk.i0)
        stage_ring_coef<T, V>(dst, pattern, 0, nd,
                              (wk.column + i * g.stride) * kRingTile % g.rb,
                              g.rb);
      stage_ring_window<T, V>(dst + wofs, x, left, right,
                              (wk.column + wk.p * g.stride) * kRingTile + a0,
                              w, g);
    }
    cp_async_commit();  // an empty group past the last copy keeps count
  };

  RingWalk ahead = first;
  issue(ahead, 0);
  next(ahead);
  int slot_ahead = 1;

  const int ir = threadIdx.x;
  int slot = 0;
  for (RingWalk wk = first; wk.item < nitems;) {
    issue(ahead, slot_ahead);
    next(ahead);
    slot_ahead = slot_ahead + 1 == g.nslot ? 0 : slot_ahead + 1;
    cp_async_wait<1>();  // this thread's copies up to wk's landed
    __syncthreads();     // and every other thread's
    if (g.reuse && wk.p == wk.i0 + jmin) {
      // a new segment: its tiles' coefficient rows, read by no tile of the
      // block's previous segment any more (the last __syncthreads)
      load_ring_coef<T, V>(smem, pattern, nd,
                           (wk.column + wk.i0 * g.stride) * kRingTile % g.rb,
                           g.rb);
      __syncthreads();
    }
    const int64_t i = wk.p - jlast;
    if (i >= wk.i0) {  // tile i of the column has all its windows
      const T* const coef = (g.reuse ? smem : ring + slot * g.slot) + ir;
      T acc[kRingRows];
#pragma unroll
      for (int a = 0; a < kRingRows; ++a) acc[a] = T(0);
      // diagonals in stored order: K2's order and rounding
      for (int d = 0; d < nd; ++d) {
        const int j = __ldg(jd + d);
        // the slot of window i + j
        int ws = slot - static_cast<int>(jlast) + j;
        if (ws < 0) ws += g.nslot;
        const T* const xrow = ring + ws * g.slot + wofs + ir +
                              (__ldg(offsets + d) - j * span - a0);
#pragma unroll
        for (int a = 0; a < kRingRows; ++a)
          acc[a] = fma(coef[d * kRingTile + a * kThreads], xrow[a * kThreads],
                       acc[a]);
      }
      store_ring_rows(y, acc, (wk.column + i * g.stride) * kRingTile, g);
    }
    __syncthreads();  // the slot is read before a later copy refills it
    next(wk);
    slot = slot + 1 == g.nslot ? 0 : slot + 1;
  }
  cp_async_wait<0>();
}

// The cluster walk.  One stage of a block: a row tile and one cluster of
// diagonals; block b takes tiles b, b + gridDim.x, ..., so the blocks walk
// the tiles in row order together and a window that one block fetched is
// in L2 for the blocks that read it again as another cluster's window.
// table: the plan's cluster starts (nclusters + 1 diagonal indices), then
// each cluster's window start a0 and width w.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    psdia_ring_clusters(const T* __restrict__ pattern,
                        const int* __restrict__ offsets,
                        const int* __restrict__ table,
                        const T* __restrict__ x, const T* __restrict__ left,
                        const T* __restrict__ right, T* __restrict__ y,
                        RingShape g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const int* const cstart = table;
  const int* const ca0 = table + g.nclusters + 1;
  const int* const cwidth = ca0 + g.nclusters;
  const int64_t ntiles = (g.cp + kRingTile - 1) / kRingTile;

  // stage (tile, cluster c) into a slot: the cluster's coefficient rows
  // [nd, kRingTile], then its window
  auto issue = [&](int64_t tile, int c, int slot) {
    if (tile < ntiles) {
      const int d0 = __ldg(cstart + c);
      const int nd = __ldg(cstart + c + 1) - d0;
      T* const dst = smem + slot * g.slot;
      const int64_t k0 = tile * kRingTile;
      stage_ring_coef<T, V>(dst, pattern, d0, nd, k0 % g.rb, g.rb);
      stage_ring_window<T, V>(dst + nd * kRingTile, x, left, right,
                              k0 + __ldg(ca0 + c), __ldg(cwidth + c), g);
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
  for (int i = 0; i < kRingStages - 1; ++i) {
    issue(tile_ahead, c_ahead, slot_ahead);
    next(tile_ahead, c_ahead);
    slot_ahead = slot_ahead + 1 == kRingStages ? 0 : slot_ahead + 1;
  }

  const int ir = threadIdx.x;
  T acc[kRingRows];
#pragma unroll
  for (int a = 0; a < kRingRows; ++a) acc[a] = T(0);
  int slot = 0, c = 0;
  for (int64_t tile = blockIdx.x; tile < ntiles;) {
    issue(tile_ahead, c_ahead, slot_ahead);
    next(tile_ahead, c_ahead);
    slot_ahead = slot_ahead + 1 == kRingStages ? 0 : slot_ahead + 1;
    cp_async_wait<kRingStages - 1>();  // this thread's copies landed
    __syncthreads();                   // and every other thread's

    const int d0 = __ldg(cstart + c);
    const int nd = __ldg(cstart + c + 1) - d0;
    const int a0 = __ldg(ca0 + c);
    const T* const coef = smem + slot * g.slot + ir;
    const T* const win = coef + nd * kRingTile - a0;
    // diagonals in stored order: K2's order and rounding
    for (int dd = 0; dd < nd; ++dd) {
      const T* const xrow = win + __ldg(offsets + d0 + dd);
#pragma unroll
      for (int a = 0; a < kRingRows; ++a)
        acc[a] = fma(coef[dd * kRingTile + a * kThreads], xrow[a * kThreads],
                     acc[a]);
    }
    if (c == g.nclusters - 1) {  // the tile's last cluster: store
      store_ring_rows(y, acc, tile * kRingTile, g);
#pragma unroll
      for (int a = 0; a < kRingRows; ++a) acc[a] = T(0);
    }
    __syncthreads();  // the slot is read before a later stage refills it
    next(tile, c);
    slot = slot + 1 == kRingStages ? 0 : slot + 1;
  }
  cp_async_wait<0>();
}

template <typename T>
int launch_sdia_ring(const void* data, const void* offsets, int ndiags,
                     const void* x, const void* left, const void* right,
                     void* y, int64_t cp, int64_t h, void* stream) {
  sdia_ring<T><<<grid_for(cp), kThreads, ndiags * sizeof(int),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(offsets), ndiags,
      static_cast<const T*>(x), static_cast<const T*>(left),
      static_cast<const T*>(right), static_cast<T*>(y), cp, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_psdia_ring_t(const void* pattern, const void* offsets,
                        const void* table, const void* x, const void* left,
                        const void* right, void* y, RingShape g,
                        cudaStream_t stream) {
  auto kernel = g.stride ? psdia_ring_stride<T, V> : psdia_ring_clusters<T, V>;
  const size_t smem =
      (static_cast<size_t>(g.nslot) * g.slot +
       (g.reuse ? static_cast<size_t>(g.ndiags) * kRingTile : 0)) *
      sizeof(T);
  int dev = 0, sms = 0, per_sm = 0;
  // above 48 KB only with the kernel's limit raised (per device)
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent blocks: as many as the card holds at once, no more than
  // there are items
  const int64_t resident =
      static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t ntiles = (g.cp + kRingTile - 1) / kRingTile;
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
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(pattern), static_cast<const int*>(offsets),
      static_cast<const int*>(table), static_cast<const T*>(x),
      static_cast<const T*>(left), static_cast<const T*>(right),
      static_cast<T*>(y), g);
  return static_cast<int>(cudaGetLastError());
}

// K8b with the host plan: stride 0 walks the clusters (jspan 0, a ring of
// kRingStages slots), stride M > 0 walks the tiles M apart, each tile
// reading the windows of jspan consecutive column positions (a ring of
// jspan + 1 slots; reuse: the coefficient rows once per segment); 16-byte
// copies where the buffers and the ring's boundaries are 16-byte aligned
template <typename T>
int launch_psdia_ring(const void* pattern, const void* offsets, int ndiags,
                      const void* table, int nclusters, int stride, int slot,
                      int jspan, int reuse, int64_t rb, const void* x,
                      const void* left, const void* right, void* y,
                      int64_t cp, int64_t h, int64_t base, int64_t L,
                      int64_t nrow, void* stream) {
  if (cp <= 0) return 0;
  const int nslot = stride ? jspan + 1 : kRingStages;
  const size_t smem =
      (static_cast<size_t>(nslot) * slot +
       (reuse ? static_cast<size_t>(ndiags) * kRingTile : 0)) *
      sizeof(T);
  if (ndiags < 1 || slot < 1 || stride < 0 || rb < 1 || h < 0 ||
      (stride == 0 && (nclusters < 1 || jspan != 0 || reuse)) ||
      (stride > 0 && (nclusters != 1 || jspan < 1)) || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(T);
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool aligned = a16(pattern) && a16(x) && a16(left) && a16(right) &&
                       rb % V == 0 && cp % V == 0 && h % V == 0;
  RingShape g;
  g.rb = rb;
  g.cp = cp;
  g.h = h;
  g.base = base;
  g.L = L;
  g.nrow = nrow;
  g.seg = 0;
  g.ndiags = ndiags;
  g.nclusters = nclusters;
  g.stride = stride;
  g.slot = slot;
  g.nslot = nslot;
  g.reuse = reuse;
  const auto st = static_cast<cudaStream_t>(stream);
  return aligned ? launch_psdia_ring_t<T, V>(pattern, offsets, table, x, left,
                                             right, y, g, st)
                 : launch_psdia_ring_t<T, 1>(pattern, offsets, table, x, left,
                                             right, y, g, st);
}

}  // namespace

extern "C" {

int tsp_sdia_ring_f32(const void* data, const void* offsets, int ndiags,
                      const void* x, const void* left, const void* right,
                      void* y, int64_t cp, int64_t h, void* stream) {
  return launch_sdia_ring<float>(data, offsets, ndiags, x, left, right, y, cp,
                                 h, stream);
}

int tsp_sdia_ring_f64(const void* data, const void* offsets, int ndiags,
                      const void* x, const void* left, const void* right,
                      void* y, int64_t cp, int64_t h, void* stream) {
  return launch_sdia_ring<double>(data, offsets, ndiags, x, left, right, y,
                                  cp, h, stream);
}

int tsp_psdia_ring_f32(const void* pattern, const void* offsets, int ndiags,
                       const void* table, int nclusters, int stride, int slot,
                       int jspan, int reuse, int64_t rb, const void* x,
                       const void* left, const void* right, void* y,
                       int64_t cp, int64_t h, int64_t base, int64_t L,
                       int64_t nrow, void* stream) {
  return launch_psdia_ring<float>(pattern, offsets, ndiags, table, nclusters,
                                  stride, slot, jspan, reuse, rb, x, left,
                                  right, y, cp, h, base, L, nrow, stream);
}

int tsp_psdia_ring_f64(const void* pattern, const void* offsets, int ndiags,
                       const void* table, int nclusters, int stride, int slot,
                       int jspan, int reuse, int64_t rb, const void* x,
                       const void* left, const void* right, void* y,
                       int64_t cp, int64_t h, int64_t base, int64_t L,
                       int64_t nrow, void* stream) {
  return launch_psdia_ring<double>(pattern, offsets, ndiags, table, nclusters,
                                   stride, slot, jspan, reuse, rb, x, left,
                                   right, y, cp, h, base, L, nrow, stream);
}

}  // extern "C"
