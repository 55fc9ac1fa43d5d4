// Streaming DIA kernels for Hopper (sm_90a): the SpMVs K1 (SDIA) and K2
// (PSDIA) and their multi-RHS forms K3a and K3b.
//
// Replaces the Pallas TPU kernels of the JAX reference package:
//   K1  tpu_spmv/kernels/dia_stream.py:_kernel       (spmv_sdia_padded)
//   K2  tpu_spmv/kernels/dia_stream.py:_pkernel      (spmv_psdia_padded)
//   K3a tpu_spmv/kernels/dia_stream.py:_spmm_kernel  (spmm_sdia_padded_t)
//   K3b tpu_spmv/kernels/dia_stream.py:_pspmm_kernel (spmm_psdia_padded_t)
//
// K1 and K2 compute, in the padded row space of the pack (xpad[k] = x[k - L]),
//     ypad[k] = sum_d coef(d, k) * xpad[k + off_d]
// with coef(d, k) = data[d * npad + k] for SDIA and pattern[d * rb + k % rb]
// for PSDIA (rb is a multiple of the period and L a multiple of rb, so the
// pattern phase is the global row's).  PSDIA writes exact zeros outside the
// valid rows [L, L + nrow), the row-validity mask of the TPU kernel.
//
// What bounds them on this card: device-memory bytes.  SDIA streams every
// diagonal once plus x and y, about (ndiags + 2) * npad * sizeof(T); PSDIA
// streams only x and y, 2 * npad * sizeof(T), because the pattern
// (ndiags * rb values, a few MB at most) stays in L2/L1.  Arithmetic is one
// FMA per diagonal per row, far below the card's FLOP rate.
//
// K1: one thread owns one padded row (grid-stride loop), so neighbouring
// threads read neighbouring addresses of data and xpad and every load is
// coalesced; the diagonal offsets sit in shared memory.  The TPU kernel
// needs halo blocks and clamped edge fetches because its grid walks row
// tiles through VMEM; here the caches serve the neighbouring rows' x (every
// row streams its own data rows, so x is not what bounds K1), and a read of
// k + off outside [0, npad) is skipped instead of clamped.  Each row's sum
// runs over the diagonals in their stored (ascending offset) order in one
// thread: no atomics, bitwise reproducible.
//
// K2 streams only x and y, so where x is read from decides it: it runs the
// walks of psdia_walk.cuh on the padded row space, K8b's design without the
// ring (the window source is xpad, zero outside [0, npad); the row mask
// starts at row 0).  The host plan (kernels/dia_stream.py:psdia_walk_plan)
// picks the stride walk (windows of xpad kept in a shared-memory ring for
// the tiles S apart that read them, the coefficient rows once per segment
// where S is a multiple of the period) or the cluster walk; the stride
// walk's windows arrive by bulk copy, asked for by a producer warp beside
// the consumers, where xpad, the pattern and rb are 16-byte aligned, else
// by cp.async (the V = 1 branch).  Each row sums its
// diagonals in stored order with fma from zero, so K2 is bitwise the former
// one-thread-a-row kernel, K8b at one shard and every column of K3b.  nvcc
// contracts a * b + c to FMA, so results may differ from an unfused plain
// version in the last bits.
//
// K3a/K3b keep the reference's transposed multi-RHS layout: Xt and Yt are
// [nrhs, npad], RHS q of padded row k at q * npad + k, and
//     Yt[q, k] = sum_d coef(d, k) * Xt[q, k + off_d].
// The bytes they must move are the coefficients once plus nrhs x and y
// rows, so the coefficient read that bounds K1 is shared by the RHS.
//
// K3a: one thread owns one padded row for a chunk of QC <= 32 RHS
// (blockIdx.y picks the chunk; the last chunk of an nrhs that QC does not
// divide leaves its upper accumulators unused): per diagonal it loads the
// coefficient once and does one FMA per RHS, the QC accumulators stay in
// registers (the loops over q are unrolled), and each Xt load is coalesced
// across the warp.  The order of the diagonals is K1's, so each RHS sums in
// K1's order.
//
// K3b stages x in shared memory, as the reference stages an [nrhs, rb] x
// tile and two [nrhs, h] halo blocks in VMEM
// (tpu_spmv/kernels/dia_stream.py:908-926).
// What bounds it: the 2 * nrhs * npad * sizeof(T) bytes of Xt and Yt; the
// pattern is a few MB at most and stays in L2.  Every x value is read by
// ndiags rows; a kernel that loads it once per diagonal, or once per
// window of nearby diagonals, from L2 is bound by L2 traffic, not device
// memory.  The design: a tile of TK rows of QCAP RHS (kSpmmRows x kSpmmRhs
// outputs a thread, in registers, 256 threads; TK = 128 at 32 RHS).  The
// tile's coefficient rows (pattern slot k mod rb, computed once per tile)
// and windows of Xt are copied into a ring of shared-memory slots with
// cp.async (16-byte copies that bypass L1, where Xt's rows are 16-byte
// aligned), several copies in flight while the block computes from an
// earlier slot; threads of a warp read neighbouring rows of a window, so
// the reads are free of bank conflicts and each store is one 128-byte line.
// A full halo does not fit (+-4096 rows x 32 RHS of the 4096^2 Poisson is
// 1 MB), so the host plan (kernels/dia_stream.py:psdia_spmm_plan, from the
// offsets, the RHS count and the shared-memory budget) picks one of two
// walks:
//   - the stride walk, where the offsets sit near whole multiples j_d * S
//     of a stride of S = M * TK rows (the 2-D Poisson: -4096, {-1, 0, 1}
//     and +4096 at S = 4096): one window of TK plus a few columns a tile;
//     a block walks a segment of the tiles M apart and keeps the windows
//     of tiles i - 1, i and i + 1 (in steps of S) in the ring, so each
//     window is read from device memory once and serves as the +S, the
//     middle and the -S window of three successive tiles;
//   - otherwise the cluster walk: one window per cluster of nearby offsets
//     per tile; the blocks walk the tiles in row order together, so a far
//     window that another block fetched a moment ago is still in L2.
// Persistent blocks, as many as the card holds at once.  Each thread sums
// its outputs over the diagonals in stored order with fma, K2's order and
// rounding, so every column of K3b is bitwise K2's on the same pack; one
// writer per output and no atomics, so results are bitwise reproducible.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "psdia_walk.cuh"

namespace {

constexpr int kThreads = 256;
// one full wave on an H100: 132 SMs x 8 resident blocks of 256 threads
constexpr int kMaxBlocks = 132 * 8;

inline int grid_for(int64_t npad) {
  int64_t blocks = (npad + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

template <typename T>
__global__ void sdia_spmv(const T* __restrict__ data,
                          const int* __restrict__ offsets, int ndiags,
                          const T* __restrict__ xpad, T* __restrict__ ypad,
                          int64_t npad) {
  extern __shared__ int s_off[];
  for (int d = threadIdx.x; d < ndiags; d += blockDim.x) s_off[d] = offsets[d];
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < npad; k += stride) {
    T acc = T(0);
    for (int d = 0; d < ndiags; ++d) {
      const int64_t j = k + s_off[d];
      if (j >= 0 && j < npad) acc += data[d * npad + k] * xpad[j];
    }
    ypad[k] = acc;
  }
}

template <typename T, int QC>
__global__ void sdia_spmm(const T* __restrict__ data,
                          const int* __restrict__ offsets, int ndiags,
                          const T* __restrict__ xt, T* __restrict__ yt,
                          int64_t npad, int nrhs) {
  extern __shared__ int s_off[];
  for (int d = threadIdx.x; d < ndiags; d += blockDim.x) s_off[d] = offsets[d];
  __syncthreads();
  const int q0 = blockIdx.y * QC;
  const int nq = min(QC, nrhs - q0);
  const T* x = xt + q0 * npad;
  T* y = yt + q0 * npad;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < npad; k += stride) {
    T acc[QC];
#pragma unroll
    for (int q = 0; q < QC; ++q) acc[q] = T(0);
    for (int d = 0; d < ndiags; ++d) {
      const int64_t j = k + s_off[d];
      if (j >= 0 && j < npad) {
        const T c = data[d * npad + k];
#pragma unroll
        for (int q = 0; q < QC; ++q)
          if (q < nq) acc[q] += c * x[q * npad + j];
      }
    }
#pragma unroll
    for (int q = 0; q < QC; ++q)
      if (q < nq) y[q * npad + k] = acc[q];
  }
}

// ---------------------------------------------------------------------------
// K3b psdia_spmm: windows of Xt staged in shared memory (see the header)
// ---------------------------------------------------------------------------

// slots in the ring of the cluster walk: kSpmmStages - 1 copies are in
// flight while one slot is read
constexpr int kSpmmStages = 4;
// outputs a thread keeps in registers: kSpmmRows rows x kSpmmRhs RHS
constexpr int kSpmmRows = 4;
constexpr int kSpmmRhs = 4;

// the operand's geometry and the host plan's scalars
struct SpmmShape {
  int64_t rb, npad, L, nrow;
  int64_t seg;    // the stride walk: tiles per segment (launcher)
  int nrhs;
  int ndiags;
  int nchunks;    // RHS chunks of QT * kSpmmRhs
  int nclusters;  // the cluster walk's clusters of nearby offsets
  int stride;     // the stride walk's tile stride M (0: the cluster walk)
  int slot;       // elements of one ring slot
  int nslot;      // slots in the ring
};

// the row mask: rows outside [L, L + nrow) are zero (every block a share)
template <typename T>
__device__ __forceinline__ void zero_masked_rows(T* __restrict__ yt,
                                                 const SpmmShape& g) {
  const int64_t npadrows = g.npad - g.nrow;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int q = 0; q < g.nrhs; ++q)
    for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x;
         r < npadrows; r += stride)
      yt[q * g.npad + (r < g.L ? r : r + g.nrow)] = T(0);
}

// copy the window Xt[q0 + q, j0 .. j0 + w) (q < nq) to win[q * w ..];
// columns outside [0, npad) are zero.  V elements per copy: j0, w, npad
// and Xt's rows are then V-aligned (the plan and the launcher see to it)
template <typename T, int V>
__device__ __forceinline__ void stage_window(T* __restrict__ win,
                                             const T* __restrict__ xt,
                                             int64_t j0, int w, int q0,
                                             int nq, int64_t npad) {
  const int nv = w / V;
  const int dq = kThreads / nv, dv = kThreads % nv;
  const T* const src = xt + static_cast<int64_t>(q0) * npad + j0;
  for (int q = threadIdx.x / nv, v = threadIdx.x % nv; q < nq;) {
    const int64_t j = j0 + static_cast<int64_t>(v) * V;
    T* const dst = win + q * w + v * V;
    if (j >= 0 && j < npad) {
      cp_async<V * sizeof(T)>(dst, src + q * npad + v * V);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) dst[i] = T(0);
    }
    q += dq;
    v += dv;
    if (v >= nv) {
      v -= nv;
      ++q;
    }
  }
}

// copy the coefficients of diagonals d0 .. d0 + nd for the TK rows from
// pattern slot `base` (= k0 mod rb, once per tile) on, wrapping at rb
template <typename T, int TK>
__device__ __forceinline__ void stage_pattern(T* __restrict__ pat,
                                              const T* __restrict__ pattern,
                                              int d0, int nd, int64_t base,
                                              int64_t rb) {
  for (int e = threadIdx.x; e < nd * TK; e += kThreads) {
    int64_t k = base + e % TK;
    if (k >= rb) k %= rb;
    cp_async<sizeof(T)>(pat + e, pattern + (d0 + e / TK) * rb + k);
  }
}

// The cluster walk.  One stage of a block: a (row tile, RHS chunk) item
// and one cluster.  Block b takes items b, b + gridDim.x, ... (item =
// tile * nchunks + chunk), so the blocks walk the tiles in row order
// together and a window that one block fetched is in L2 for the blocks
// that read it again as another cluster's window.
struct Stage {
  int64_t tile;
  int chunk;
  int c;
  int64_t base;  // k0 mod rb of the tile's first row k0
};

__device__ __forceinline__ void next_stage(Stage& st, const SpmmShape& g,
                                           int64_t dtile, int dchunk,
                                           int64_t tk) {
  if (++st.c < g.nclusters) return;
  st.c = 0;
  st.chunk += dchunk;
  st.tile += dtile;
  if (st.chunk >= g.nchunks) {
    st.chunk -= g.nchunks;
    ++st.tile;
  }
  st.base = (g.L + st.tile * tk) % g.rb;  // once per item
}

// QT threads along the RHS, kThreads / QT along the rows; a tile is
// TK = kSpmmRows * kThreads / QT rows of QCAP = kSpmmRhs * QT RHS.  V:
// elements per window copy (16 bytes, or 1 where Xt is not 16-byte
// aligned).  table: the plan's cluster starts (nclusters + 1 diagonal
// indices), then each cluster's window start a0 and width w (columns
// k0 + a0 .. k0 + a0 + w of Xt for the tile at k0).
template <typename T, int QT, int V>
__global__ void __launch_bounds__(kThreads)
    psdia_spmm_clusters(const T* __restrict__ pattern,
                        const int* __restrict__ offsets,
                        const int* __restrict__ table,
                        const T* __restrict__ xt, T* __restrict__ yt,
                        SpmmShape g) {
  constexpr int RT = kThreads / QT;
  constexpr int TK = RT * kSpmmRows;
  constexpr int QCAP = QT * kSpmmRhs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const int* const cstart = table;
  const int* const ca0 = table + g.nclusters + 1;
  const int* const cwidth = ca0 + g.nclusters;
  zero_masked_rows(yt, g);

  const int64_t ntiles = (g.nrow + TK - 1) / TK;
  const int64_t dtile = gridDim.x / g.nchunks;
  const int dchunk = static_cast<int>(gridDim.x % g.nchunks);
  Stage first;
  first.tile = blockIdx.x / g.nchunks;
  first.chunk = static_cast<int>(blockIdx.x % g.nchunks);
  first.c = 0;
  first.base = (g.L + first.tile * TK) % g.rb;

  // stage st into a slot: the cluster's coefficient rows [nd, TK], then
  // its window of the chunk's RHS rows
  auto issue = [&](const Stage& st, int slot) {
    if (st.tile < ntiles) {
      const int q0 = st.chunk * QCAP;
      const int d0 = __ldg(cstart + st.c);
      const int nd = __ldg(cstart + st.c + 1) - d0;
      T* const pat = smem + slot * g.slot;
      stage_pattern<T, TK>(pat, pattern, d0, nd, st.base, g.rb);
      stage_window<T, V>(pat + nd * TK, xt,
                         g.L + st.tile * TK + __ldg(ca0 + st.c),
                         __ldg(cwidth + st.c), q0, min(QCAP, g.nrhs - q0),
                         g.npad);
    }
    cp_async_commit();  // an empty group past the last stage keeps count
  };

  Stage ahead = first;
  int slot_ahead = 0;
  for (int i = 0; i < kSpmmStages - 1; ++i) {
    issue(ahead, slot_ahead);
    next_stage(ahead, g, dtile, dchunk, TK);
    slot_ahead = slot_ahead + 1 == kSpmmStages ? 0 : slot_ahead + 1;
  }

  const int ir = threadIdx.x % RT, iq = threadIdx.x / RT;
  T acc[kSpmmRows][kSpmmRhs];
#pragma unroll
  for (int a = 0; a < kSpmmRows; ++a)
#pragma unroll
    for (int b = 0; b < kSpmmRhs; ++b) acc[a][b] = T(0);

  int slot = 0;
  for (Stage st = first; st.tile < ntiles;) {
    issue(ahead, slot_ahead);
    next_stage(ahead, g, dtile, dchunk, TK);
    slot_ahead = slot_ahead + 1 == kSpmmStages ? 0 : slot_ahead + 1;
    cp_async_wait<kSpmmStages - 1>();  // this thread's copies of st landed
    __syncthreads();                   // and every other thread's

    const int q0 = st.chunk * QCAP;
    const int nq = min(QCAP, g.nrhs - q0);
    const int d0 = __ldg(cstart + st.c);
    const int nd = __ldg(cstart + st.c + 1) - d0;
    const int a0 = __ldg(ca0 + st.c), w = __ldg(cwidth + st.c);
    const T* const pat = smem + slot * g.slot + ir;
    const T* const win = smem + slot * g.slot + nd * TK + iq * w + ir - a0;
    // diagonals in stored order, so each RHS sums in K2's order
    for (int dd = 0; dd < nd; ++dd) {
      const T* const xrow = win + __ldg(offsets + d0 + dd);
#pragma unroll
      for (int a = 0; a < kSpmmRows; ++a) {
        const T coef = pat[dd * TK + a * RT];
#pragma unroll
        for (int b = 0; b < kSpmmRhs; ++b)
          if (iq + b * QT < nq)
            acc[a][b] = fma(coef, xrow[b * QT * w + a * RT], acc[a][b]);
      }
    }
    if (st.c == g.nclusters - 1) {  // the item's last cluster: store
      const int64_t k0 = g.L + st.tile * TK;
#pragma unroll
      for (int a = 0; a < kSpmmRows; ++a) {
        const int64_t k = k0 + ir + a * RT;
#pragma unroll
        for (int b = 0; b < kSpmmRhs; ++b) {
          const int q = iq + b * QT;
          if (k < g.L + g.nrow && q < nq)
            yt[static_cast<int64_t>(q0 + q) * g.npad + k] = acc[a][b];
          acc[a][b] = T(0);
        }
      }
    }
    __syncthreads();  // the slot is read before a later stage refills it
    next_stage(st, g, dtile, dchunk, TK);
    slot = slot + 1 == kSpmmStages ? 0 : slot + 1;
  }
  cp_async_wait<0>();
}

// The stride walk, for offsets near whole multiples of S = stride * TK
// rows: the window of tile t (columns k0 + a0 .. k0 + a0 + w) is also the
// window that diagonal d of tile t - j_d * stride reads (j_d = the plan's
// nearest multiple of S to off_d).  Column c of the tiles is c, c +
// stride, c + 2 stride, ...; an item is a segment of seg consecutive tiles
// i0 .. i1 of one column and one RHS chunk (item = (chunk * nseg +
// segment) * stride + column, block b taking items b, b + gridDim.x, ...),
// and its copies are the windows of column positions i0 + jmin .. i1 - 1 +
// jmin + jspan - 1 in order: each one also stages the coefficient rows of
// tile p - jmin - jspan + 1, which every window it needs then holds.
struct Walk {
  int64_t item, i0, i1, p, ncol, nseg;
  int chunk, column;
};

// decode the items from `item` on until one that holds tiles
__device__ __forceinline__ void walk_item(Walk& wk, int64_t item,
                                          int64_t nitems, int64_t ntiles,
                                          const SpmmShape& g, int jmin) {
  for (wk.item = item; wk.item < nitems; wk.item += gridDim.x) {
    wk.column = static_cast<int>(wk.item % g.stride);
    const int64_t rest = wk.item / g.stride;
    wk.chunk = static_cast<int>(rest / wk.nseg);
    wk.i0 = rest % wk.nseg * g.seg;
    const int64_t len = (ntiles - wk.column + g.stride - 1) / g.stride;
    if (wk.i0 < len) {
      wk.i1 = wk.i0 + g.seg < len ? wk.i0 + g.seg : len;
      wk.p = wk.i0 + jmin;
      return;
    }
  }
}

template <typename T, int QT, int V>
__global__ void __launch_bounds__(kThreads)
    psdia_spmm_stride(const T* __restrict__ pattern,
                      const int* __restrict__ offsets,
                      const int* __restrict__ table,
                      const T* __restrict__ xt, T* __restrict__ yt,
                      SpmmShape g) {
  constexpr int RT = kThreads / QT;
  constexpr int TK = RT * kSpmmRows;
  constexpr int QCAP = QT * kSpmmRhs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  // table: jmin, jspan, a0, w, lookahead, then j_d of every diagonal
  const int jmin = __ldg(table), jspan = __ldg(table + 1);
  const int a0 = __ldg(table + 2), w = __ldg(table + 3);
  const int ahead_n = __ldg(table + 4);
  const int* const jd = table + 5;
  const int nd = g.ndiags;
  zero_masked_rows(yt, g);

  const int64_t ntiles = (g.nrow + TK - 1) / TK;
  Walk first;
  first.ncol = (ntiles + g.stride - 1) / g.stride;
  first.nseg = (first.ncol + g.seg - 1) / g.seg;
  const int64_t nitems = first.nseg * g.nchunks * g.stride;
  walk_item(first, blockIdx.x, nitems, ntiles, g, jmin);
  const int64_t jlast = jmin + jspan - 1;
  auto next = [&](Walk& wk) {
    if (++wk.p > wk.i1 - 1 + jlast)
      walk_item(wk, wk.item + gridDim.x, nitems, ntiles, g, jmin);
  };

  auto issue = [&](const Walk& wk, int slot) {
    if (wk.item < nitems) {
      T* const pat = smem + slot * g.slot;
      const int64_t i = wk.p - jlast;  // the tile this copy completes
      if (i >= wk.i0)
        stage_pattern<T, TK>(pat, pattern, 0, nd,
                             (g.L + (wk.column + i * g.stride) * TK) % g.rb,
                             g.rb);
      const int q0 = wk.chunk * QCAP;
      stage_window<T, V>(pat + nd * TK, xt,
                         g.L + (wk.column + wk.p * g.stride) * TK + a0, w,
                         q0, min(QCAP, g.nrhs - q0), g.npad);
    }
    cp_async_commit();  // an empty group past the last copy keeps count
  };

  Walk ahead = first;
  int slot_ahead = 0;
  for (int i = 0; i < ahead_n; ++i) {
    issue(ahead, slot_ahead);
    next(ahead);
    slot_ahead = slot_ahead + 1 == g.nslot ? 0 : slot_ahead + 1;
  }

  const int ir = threadIdx.x % RT, iq = threadIdx.x / RT;
  const int64_t span = static_cast<int64_t>(g.stride) * TK;
  int slot = 0;
  for (Walk wk = first; wk.item < nitems;) {
    issue(ahead, slot_ahead);
    next(ahead);
    slot_ahead = slot_ahead + 1 == g.nslot ? 0 : slot_ahead + 1;
    if (ahead_n == 1)
      cp_async_wait<1>();  // this thread's copies up to wk's landed
    else if (ahead_n == 2)
      cp_async_wait<2>();
    else
      cp_async_wait<3>();
    __syncthreads();  // and every other thread's

    const int64_t i = wk.p - jlast;
    if (i >= wk.i0) {  // tile i of the column has all its windows
      const int q0 = wk.chunk * QCAP;
      const int nq = min(QCAP, g.nrhs - q0);
      const T* const pat = smem + slot * g.slot + ir;
      T acc[kSpmmRows][kSpmmRhs];
#pragma unroll
      for (int a = 0; a < kSpmmRows; ++a)
#pragma unroll
        for (int b = 0; b < kSpmmRhs; ++b) acc[a][b] = T(0);
      // diagonals in stored order, so each RHS sums in K2's order
      for (int d = 0; d < nd; ++d) {
        const int j = __ldg(jd + d);
        int ws = slot - jlast + j;  // the slot of window i + j
        if (ws < 0) ws += g.nslot;
        const T* const xrow = smem + ws * g.slot + nd * TK + iq * w + ir +
                              (__ldg(offsets + d) - j * span - a0);
#pragma unroll
        for (int a = 0; a < kSpmmRows; ++a) {
          const T coef = pat[d * TK + a * RT];
#pragma unroll
          for (int b = 0; b < kSpmmRhs; ++b)
            if (iq + b * QT < nq)
              acc[a][b] = fma(coef, xrow[b * QT * w + a * RT], acc[a][b]);
        }
      }
      const int64_t k0 = g.L + (wk.column + i * g.stride) * TK;
#pragma unroll
      for (int a = 0; a < kSpmmRows; ++a) {
        const int64_t k = k0 + ir + a * RT;
#pragma unroll
        for (int b = 0; b < kSpmmRhs; ++b) {
          const int q = iq + b * QT;
          if (k < g.L + g.nrow && q < nq)
            yt[static_cast<int64_t>(q0 + q) * g.npad + k] = acc[a][b];
        }
      }
    }
    __syncthreads();  // the slot is read before a later copy refills it
    next(wk);
    slot = slot + 1 == g.nslot ? 0 : slot + 1;
  }
  cp_async_wait<0>();
}

template <typename T>
int launch_sdia(const void* data, const void* offsets, int ndiags,
                const void* xpad, void* ypad, int64_t npad, void* stream) {
  sdia_spmv<T><<<grid_for(npad), kThreads, ndiags * sizeof(int),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(offsets), ndiags,
      static_cast<const T*>(xpad), static_cast<T*>(ypad), npad);
  return static_cast<int>(cudaGetLastError());
}

// K2: the walk of psdia_walk.cuh with xpad as the window source (no
// slivers), all npad rows local (base 0)
template <typename T>
int launch_psdia(const void* pattern, const void* args, const void* xpad,
                 void* ypad, int64_t npad, int64_t L, int64_t nrow,
                 void* stream) {
  const WindowSource<T> src{static_cast<const T*>(xpad), nullptr, nullptr,
                            npad, 0};
  return launch_walk<T>(*static_cast<const WalkArgs*>(args), pattern, src,
                        ypad, 0, L, nrow, stream);
}

// the RHS chunk: the smallest power of two that holds nrhs, at most 32
template <typename T, template <typename, int> class Launch, typename... A>
int by_chunk(int nrhs, A... args) {
  if (nrhs <= 0) return 0;
  if (nrhs == 1) return Launch<T, 1>::run(nrhs, args...);
  if (nrhs <= 2) return Launch<T, 2>::run(nrhs, args...);
  if (nrhs <= 4) return Launch<T, 4>::run(nrhs, args...);
  if (nrhs <= 8) return Launch<T, 8>::run(nrhs, args...);
  if (nrhs <= 16) return Launch<T, 16>::run(nrhs, args...);
  return Launch<T, 32>::run(nrhs, args...);
}

template <typename T, int QC>
struct SdiaSpmm {
  static int run(int nrhs, const void* data, const void* offsets, int ndiags,
                 const void* xt, void* yt, int64_t npad, void* stream) {
    const dim3 grid(grid_for(npad), (nrhs + QC - 1) / QC);
    sdia_spmm<T, QC><<<grid, kThreads, ndiags * sizeof(int),
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(data), static_cast<const int*>(offsets), ndiags,
        static_cast<const T*>(xt), static_cast<T*>(yt), npad, nrhs);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, int QT, int V>
int launch_psdia_spmm_t(const void* pattern, const void* offsets,
                        const void* table, const void* xt, void* yt,
                        SpmmShape g, cudaStream_t stream) {
  auto kernel = g.stride ? psdia_spmm_stride<T, QT, V>
                         : psdia_spmm_clusters<T, QT, V>;
  const size_t smem = static_cast<size_t>(g.nslot) * g.slot * sizeof(T);
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
  // there are items (and one at least, for the row mask)
  const int64_t resident =
      static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  constexpr int64_t tk = kSpmmRows * kThreads / QT;
  const int64_t ntiles = (g.nrow + tk - 1) / tk;
  int64_t items = ntiles * g.nchunks;
  if (g.stride) {
    // segments of a column: about four items per block, at least 16
    // tiles each (a segment re-reads jspan - 1 windows)
    const int64_t ncol = (ntiles + g.stride - 1) / g.stride;
    const int64_t want = (ntiles * g.nchunks + 4 * resident - 1) /
                         (4 * resident);
    g.seg = want < 16 ? 16 : want;
    if (g.seg > ncol) g.seg = ncol < 1 ? 1 : ncol;
    items = (ncol + g.seg - 1) / g.seg * g.nchunks * g.stride;
  }
  int64_t blocks = resident < items ? resident : items;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(pattern), static_cast<const int*>(offsets),
      static_cast<const int*>(table), static_cast<const T*>(xt),
      static_cast<T*>(yt), g);
  return static_cast<int>(cudaGetLastError());
}

// K3b with the host plan: tk = kSpmmRows * kThreads / qt rows per tile
// (the plan's rule, checked here), qt in {1, 2, 4, 8}; stride 0 walks the
// clusters (nslot = kSpmmStages), stride M > 0 walks the tiles M apart;
// 16-byte window copies where Xt's rows start 16-byte aligned
template <typename T>
int launch_psdia_spmm(const void* pattern, const void* offsets, int ndiags,
                      const void* table, int nclusters, int stride, int qt,
                      int tk, int slot, int nslot, int64_t rb,
                      const void* xt, void* yt, int64_t npad, int64_t L,
                      int64_t nrow, int nrhs, void* stream) {
  if (nrhs <= 0) return 0;
  if (qt < 1 || tk != kSpmmRows * kThreads / qt || slot < 1 || stride < 0 ||
      (stride == 0 && (nclusters < 1 || nslot != kSpmmStages)) ||
      (stride > 0 && nslot < 2) ||
      static_cast<size_t>(nslot) * slot * sizeof(T) > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(xt) % 16 == 0 &&
                       npad % V == 0 && L % V == 0;
  SpmmShape g;
  g.rb = rb;
  g.npad = npad;
  g.L = L;
  g.nrow = nrow;
  g.seg = 0;
  g.nrhs = nrhs;
  g.ndiags = ndiags;
  g.nchunks = (nrhs + kSpmmRhs * qt - 1) / (kSpmmRhs * qt);
  g.nclusters = nclusters;
  g.stride = stride;
  g.slot = slot;
  g.nslot = nslot;
  const auto st = static_cast<cudaStream_t>(stream);
#define TSP_PSDIA_SPMM(QT)                                                   \
  return aligned ? launch_psdia_spmm_t<T, QT, V>(pattern, offsets, table, xt, \
                                                 yt, g, st)                  \
                 : launch_psdia_spmm_t<T, QT, 1>(pattern, offsets, table, xt, \
                                                 yt, g, st)
  switch (qt) {
    case 1:
      TSP_PSDIA_SPMM(1);
    case 2:
      TSP_PSDIA_SPMM(2);
    case 4:
      TSP_PSDIA_SPMM(4);
    case 8:
      TSP_PSDIA_SPMM(8);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TSP_PSDIA_SPMM
}

}  // namespace

extern "C" {

int tsp_sdia_spmv_f32(const void* data, const void* offsets, int ndiags,
                      const void* xpad, void* ypad, int64_t npad,
                      void* stream) {
  return launch_sdia<float>(data, offsets, ndiags, xpad, ypad, npad, stream);
}

int tsp_sdia_spmv_f64(const void* data, const void* offsets, int ndiags,
                      const void* xpad, void* ypad, int64_t npad,
                      void* stream) {
  return launch_sdia<double>(data, offsets, ndiags, xpad, ypad, npad, stream);
}

int tsp_psdia_spmv_f32(const void* pattern, const void* args,
                       const void* xpad, void* ypad, int64_t npad, int64_t L,
                       int64_t nrow, void* stream) {
  return launch_psdia<float>(pattern, args, xpad, ypad, npad, L, nrow, stream);
}

int tsp_psdia_spmv_f64(const void* pattern, const void* args,
                       const void* xpad, void* ypad, int64_t npad, int64_t L,
                       int64_t nrow, void* stream) {
  return launch_psdia<double>(pattern, args, xpad, ypad, npad, L, nrow,
                              stream);
}

int tsp_sdia_spmm_f32(const void* data, const void* offsets, int ndiags,
                      const void* xt, void* yt, int64_t npad, int nrhs,
                      void* stream) {
  return by_chunk<float, SdiaSpmm>(nrhs, data, offsets, ndiags, xt, yt, npad,
                                   stream);
}

int tsp_sdia_spmm_f64(const void* data, const void* offsets, int ndiags,
                      const void* xt, void* yt, int64_t npad, int nrhs,
                      void* stream) {
  return by_chunk<double, SdiaSpmm>(nrhs, data, offsets, ndiags, xt, yt, npad,
                                    stream);
}

int tsp_psdia_spmm_f32(const void* pattern, const void* offsets,
                       int ndiags, const void* table, int nclusters,
                       int stride, int qt, int tk, int slot, int nslot,
                       int64_t rb, const void* xt, void* yt, int64_t npad,
                       int64_t L, int64_t nrow, int nrhs, void* stream) {
  return launch_psdia_spmm<float>(pattern, offsets, ndiags, table, nclusters,
                                  stride, qt, tk, slot, nslot, rb, xt, yt,
                                  npad, L, nrow, nrhs, stream);
}

int tsp_psdia_spmm_f64(const void* pattern, const void* offsets,
                       int ndiags, const void* table, int nclusters,
                       int stride, int qt, int tk, int slot, int nslot,
                       int64_t rb, const void* xt, void* yt, int64_t npad,
                       int64_t L, int64_t nrow, int nrhs, void* stream) {
  return launch_psdia_spmm<double>(pattern, offsets, ndiags, table,
                                   nclusters, stride, qt, tk, slot, nslot,
                                   rb, xt, yt, npad, L, nrow, nrhs, stream);
}

const char* tsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
