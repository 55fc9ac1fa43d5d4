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
// K1 on bf16 data (the TPU kernel with pack_sdia(data_dtype=bfloat16),
// tpu_spmv/kernels/dia_stream.py:167-205 and :269, which writes
// result_type(data, x)): the same kernel with the coefficients stored as
// __nv_bfloat16 against a float32 xpad,
//     ypad[k] = sum_d float(data_bf16[d, k]) * xpad_f32[k + off_d],
// each coefficient widened with __bfloat162float (exact), then one fma per
// diagonal in stored order from zero, in float32.  It moves
// (2 * ndiags + 8) * npad bytes against the float32 K1's (4 * ndiags + 8)
// * npad.
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
// K3a and K3b run one kernel body, along the walks below, and differ only
// in where a tile's coefficient rows come from (CoefSource): K3b's periodic
// pattern, read at k mod rb from L2 with one-value copies, or K3a's SDIA
// data rows, data[d * npad + k], which nothing reads twice: they stream
// from device memory once per RHS chunk, with 16-byte copies where the
// data, npad and L are 16-byte aligned, under an evict-first L2 policy so
// that they do not push the windows of Xt out of L2.  K3a's former kernel
// gave each thread one padded row of up to 32 RHS and loaded Xt[q, k +
// off_d] from the global cache once per diagonal: each Xt value went
// through L2 ndiags times (the +-4096 diagonals of the 4096^2 Poisson read
// lines 16 KB away that L1 does not hold), and it took 4.1439 ms at 32 RHS
// f32 against a bound of 1.3930 (an NVIDIA H100 80GB HBM3 at 700 W,
// PERF.md).
//
// The walks stage x in shared memory, as the reference stages an [nrhs,
// rb] x tile and two [nrhs, h] halo blocks in VMEM
// (tpu_spmv/kernels/dia_stream.py:908-926, and :339-400 for K3a, which
// also stages the [nd, rb] data tile).
// What bounds them: the 2 * nrhs * npad * sizeof(T) bytes of Xt and Yt,
// and K3a's ndiags * npad * sizeof(T) of data; K3b's pattern is a few MB
// at most and stays in L2.  Every x value is read by
// ndiags rows; a kernel that loads it once per diagonal, or once per
// window of nearby diagonals, from L2 is bound by L2 traffic, not device
// memory.  The design: a tile of TK rows of QCAP RHS (kSpmmRows x kSpmmRhs
// outputs a thread, in registers, 256 threads; TK = 128 at 32 RHS).  The
// tile's coefficient rows (from the pattern slot k mod rb, computed once
// per tile, or the data rows) and windows of Xt are copied into a ring of
// shared-memory slots with cp.async (16-byte copies that bypass L1, where
// Xt's rows are 16-byte aligned), several copies in flight while the block
// computes from an earlier slot; threads of a warp read neighbouring rows
// of a window, so the reads are free of bank conflicts and each store is
// one 128-byte line.
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
// its outputs over the diagonals in stored order with fma from zero, K1's
// and K2's order and rounding, so every column of K3a is bitwise K1's and
// every column of K3b K2's on the same pack; rows outside [L, L + nrow)
// are written as exact zeros; one writer per output and no atomics, so
// results are bitwise reproducible.

#include <cuda_bf16.h>
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

// a stored coefficient in the type of the sums: bf16 widens exactly
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

// T: the type of x, y and the sums; C: the stored coefficients' (T, or
// __nv_bfloat16 against a float T)
template <typename T, typename C = T>
__global__ void sdia_spmv(const C* __restrict__ data,
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
      if (j >= 0 && j < npad)
        acc = fma(widen(data[d * npad + k]), xpad[j], acc);
    }
    ypad[k] = acc;
  }
}

// ---------------------------------------------------------------------------
// K3a sdia_spmm and K3b psdia_spmm: windows of Xt staged in shared memory
// (see the header)
// ---------------------------------------------------------------------------

// slots in the ring of the cluster walk: kSpmmStages - 1 copies are in
// flight while one slot is read
constexpr int kSpmmStages = 4;
// outputs a thread keeps in registers: kSpmmRows rows x kSpmmRhs RHS
constexpr int kSpmmRows = 4;
constexpr int kSpmmRhs = 4;

// the operand's geometry and the host plan's scalars
struct SpmmShape {
  int64_t npad, L, nrow;
  int64_t seg;    // the stride walk: tiles per segment (launcher)
  int nrhs;
  int ndiags;
  int nchunks;    // RHS chunks of QT * kSpmmRhs
  int nclusters;  // the cluster walk's clusters of nearby offsets
  int stride;     // the stride walk's tile stride M (0: the cluster walk)
  int slot;       // elements of one ring slot
  int nslot;      // slots in the ring
};

// where a tile's coefficient rows come from: K3b's pattern, coef(d, k) =
// p[d * ld + k mod ld] (ld = rb), or with SDIA K3a's data rows, coef(d, k)
// = p[d * ld + k] (ld = npad), whose rows from `end` = L + nrow on are
// never stored and are staged as zeros
template <typename T>
struct CoefSource {
  const T* p;
  int64_t ld;
  int64_t end;
};

// the column of a tile's first row k0 in the coefficient rows (once a
// tile)
template <bool SDIA, typename T>
__device__ __forceinline__ int64_t coef_base(const CoefSource<T>& c,
                                             int64_t k0) {
  return SDIA ? k0 : k0 % c.ld;
}

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
// column `base` (coef_base) on to pat[dd * TK ..]: the pattern one value a
// copy, wrapping at rb; the data rows V values a copy (p, ld and base are
// then V-aligned: the launcher sees to it), first out of L2
template <typename T, int TK, int V, bool SDIA>
__device__ __forceinline__ void stage_coef(T* __restrict__ pat,
                                           const CoefSource<T>& c, int d0,
                                           int nd, int64_t base) {
  if constexpr (SDIA) {
    constexpr int nv = TK / V;
    const uint64_t pol = evict_first_policy();
    for (int e = threadIdx.x; e < nd * nv; e += kThreads) {
      const int dd = e / nv, v = e % nv;
      const int64_t k = base + static_cast<int64_t>(v) * V;
      T* const dst = pat + dd * TK + v * V;
      if (k < c.end) {
        cp_async_hint<V * sizeof(T)>(dst, c.p + (d0 + dd) * c.ld + k, pol);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) dst[i] = T(0);
      }
    }
  } else {
    for (int e = threadIdx.x; e < nd * TK; e += kThreads) {
      int64_t k = base + e % TK;
      if (k >= c.ld) k %= c.ld;
      cp_async<sizeof(T)>(pat + e, c.p + (d0 + e / TK) * c.ld + k);
    }
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
  int64_t base;  // coef_base of the tile's first row k0
};

template <bool SDIA, typename T>
__device__ __forceinline__ void next_stage(Stage& st, const SpmmShape& g,
                                           const CoefSource<T>& coef,
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
  st.base = coef_base<SDIA>(coef, g.L + st.tile * tk);  // once per item
}

// QT threads along the RHS, kThreads / QT along the rows; a tile is
// TK = kSpmmRows * kThreads / QT rows of QCAP = kSpmmRhs * QT RHS.  V:
// elements per copy of a window or a data row (16 bytes, or 1 where Xt or
// the data rows are not 16-byte aligned).  SDIA: the coefficient source
// (K3a's data rows, else K3b's pattern).  table: the plan's cluster starts
// (nclusters + 1 diagonal indices), then each cluster's window start a0
// and width w (columns k0 + a0 .. k0 + a0 + w of Xt for the tile at k0).
template <typename T, int QT, int V, bool SDIA>
__global__ void __launch_bounds__(kThreads)
    dia_spmm_clusters(CoefSource<T> coef, const int* __restrict__ offsets,
                      const int* __restrict__ table, const T* __restrict__ xt,
                      T* __restrict__ yt, SpmmShape g) {
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
  first.base = coef_base<SDIA>(coef, g.L + first.tile * TK);

  // stage st into a slot: the cluster's coefficient rows [nd, TK], then
  // its window of the chunk's RHS rows
  auto issue = [&](const Stage& st, int slot) {
    if (st.tile < ntiles) {
      const int q0 = st.chunk * QCAP;
      const int d0 = __ldg(cstart + st.c);
      const int nd = __ldg(cstart + st.c + 1) - d0;
      T* const pat = smem + slot * g.slot;
      stage_coef<T, TK, V, SDIA>(pat, coef, d0, nd, st.base);
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
    next_stage<SDIA>(ahead, g, coef, dtile, dchunk, TK);
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
    next_stage<SDIA>(ahead, g, coef, dtile, dchunk, TK);
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
    // diagonals in stored order, so each RHS sums in K1's and K2's order
    for (int dd = 0; dd < nd; ++dd) {
      const T* const xrow = win + __ldg(offsets + d0 + dd);
#pragma unroll
      for (int a = 0; a < kSpmmRows; ++a) {
        const T cf = pat[dd * TK + a * RT];
#pragma unroll
        for (int b = 0; b < kSpmmRhs; ++b)
          if (iq + b * QT < nq)
            acc[a][b] = fma(cf, xrow[b * QT * w + a * RT], acc[a][b]);
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
    next_stage<SDIA>(st, g, coef, dtile, dchunk, TK);
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

template <typename T, int QT, int V, bool SDIA>
__global__ void __launch_bounds__(kThreads)
    dia_spmm_stride(CoefSource<T> coef, const int* __restrict__ offsets,
                    const int* __restrict__ table, const T* __restrict__ xt,
                    T* __restrict__ yt, SpmmShape g) {
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
        stage_coef<T, TK, V, SDIA>(
            pat, coef, 0, nd,
            coef_base<SDIA>(coef, g.L + (wk.column + i * g.stride) * TK));
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
      // diagonals in stored order, so each RHS sums in K1's and K2's order
      for (int d = 0; d < nd; ++d) {
        const int j = __ldg(jd + d);
        int ws = slot - jlast + j;  // the slot of window i + j
        if (ws < 0) ws += g.nslot;
        const T* const xrow = smem + ws * g.slot + nd * TK + iq * w + ir +
                              (__ldg(offsets + d) - j * span - a0);
#pragma unroll
        for (int a = 0; a < kSpmmRows; ++a) {
          const T cf = pat[d * TK + a * RT];
#pragma unroll
          for (int b = 0; b < kSpmmRhs; ++b)
            if (iq + b * QT < nq)
              acc[a][b] = fma(cf, xrow[b * QT * w + a * RT], acc[a][b]);
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

template <typename T, typename C = T>
int launch_sdia(const void* data, const void* offsets, int ndiags,
                const void* xpad, void* ypad, int64_t npad, void* stream) {
  sdia_spmv<T, C><<<grid_for(npad), kThreads, ndiags * sizeof(int),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(data), static_cast<const int*>(offsets), ndiags,
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

template <typename T, int QT, int V, bool SDIA>
int launch_dia_spmm_t(CoefSource<T> coef, const void* offsets,
                      const void* table, const void* xt, void* yt,
                      SpmmShape g, cudaStream_t stream) {
  auto kernel = g.stride ? dia_spmm_stride<T, QT, V, SDIA>
                         : dia_spmm_clusters<T, QT, V, SDIA>;
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
      coef, static_cast<const int*>(offsets), static_cast<const int*>(table),
      static_cast<const T*>(xt), static_cast<T*>(yt), g);
  return static_cast<int>(cudaGetLastError());
}

// K3a (SDIA: coef is the [ndiags, npad] data) and K3b (coef is the
// [ndiags, rb] pattern, ld = rb) with the host plan: tk = kSpmmRows *
// kThreads / qt rows per tile (the plan's rule, checked here), qt in {1,
// 2, 4, 8}; stride 0 walks the clusters (nslot = kSpmmStages), stride M >
// 0 walks the tiles M apart; 16-byte copies where Xt's rows (and K3a's
// data rows) start 16-byte aligned.  A plan that does not fit is refused.
template <typename T, bool SDIA>
int launch_dia_spmm(const void* coef, const void* offsets, int ndiags,
                    const void* table, int nclusters, int stride, int qt,
                    int tk, int slot, int nslot, int64_t rb, const void* xt,
                    void* yt, int64_t npad, int64_t L, int64_t nrow,
                    int nrhs, void* stream) {
  if (nrhs <= 0) return 0;
  if (qt < 1 || tk != kSpmmRows * kThreads / qt || slot < 1 || stride < 0 ||
      (stride == 0 && (nclusters < 1 || nslot != kSpmmStages)) ||
      (stride > 0 && nslot < 2) ||
      static_cast<size_t>(nslot) * slot * sizeof(T) > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(xt) % 16 == 0 &&
                       (!SDIA || reinterpret_cast<uintptr_t>(coef) % 16 == 0) &&
                       npad % V == 0 && L % V == 0;
  const CoefSource<T> src{static_cast<const T*>(coef), SDIA ? npad : rb,
                          L + nrow};
  SpmmShape g;
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
#define TSP_DIA_SPMM(QT)                                                    \
  return aligned ? launch_dia_spmm_t<T, QT, V, SDIA>(src, offsets, table,  \
                                                     xt, yt, g, st)        \
                 : launch_dia_spmm_t<T, QT, 1, SDIA>(src, offsets, table,  \
                                                     xt, yt, g, st)
  switch (qt) {
    case 1:
      TSP_DIA_SPMM(1);
    case 2:
      TSP_DIA_SPMM(2);
    case 4:
      TSP_DIA_SPMM(4);
    case 8:
      TSP_DIA_SPMM(8);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TSP_DIA_SPMM
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

// K1 on bf16 data: bf16 coefficients, float32 x, y and sums
int tsp_sdia_spmv_bf16f32(const void* data, const void* offsets, int ndiags,
                          const void* xpad, void* ypad, int64_t npad,
                          void* stream) {
  return launch_sdia<float, __nv_bfloat16>(data, offsets, ndiags, xpad, ypad,
                                           npad, stream);
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

// K3a (coef: the SDIA data; rb unused) and K3b (coef: the pattern): the
// same walks, the same plan (kernels/dia_stream.py:psdia_spmm_plan) and the
// same arguments
int tsp_sdia_spmm_f32(const void* coef, const void* offsets, int ndiags,
                      const void* table, int nclusters, int stride, int qt,
                      int tk, int slot, int nslot, int64_t rb, const void* xt,
                      void* yt, int64_t npad, int64_t L, int64_t nrow,
                      int nrhs, void* stream) {
  return launch_dia_spmm<float, true>(coef, offsets, ndiags, table, nclusters,
                                      stride, qt, tk, slot, nslot, rb, xt, yt,
                                      npad, L, nrow, nrhs, stream);
}

int tsp_sdia_spmm_f64(const void* coef, const void* offsets, int ndiags,
                      const void* table, int nclusters, int stride, int qt,
                      int tk, int slot, int nslot, int64_t rb, const void* xt,
                      void* yt, int64_t npad, int64_t L, int64_t nrow,
                      int nrhs, void* stream) {
  return launch_dia_spmm<double, true>(coef, offsets, ndiags, table, nclusters,
                                       stride, qt, tk, slot, nslot, rb, xt, yt,
                                       npad, L, nrow, nrhs, stream);
}

int tsp_psdia_spmm_f32(const void* coef, const void* offsets, int ndiags,
                       const void* table, int nclusters, int stride, int qt,
                       int tk, int slot, int nslot, int64_t rb, const void* xt,
                       void* yt, int64_t npad, int64_t L, int64_t nrow,
                       int nrhs, void* stream) {
  return launch_dia_spmm<float, false>(coef, offsets, ndiags, table, nclusters,
                                       stride, qt, tk, slot, nslot, rb, xt, yt,
                                       npad, L, nrow, nrhs, stream);
}

int tsp_psdia_spmm_f64(const void* coef, const void* offsets, int ndiags,
                       const void* table, int nclusters, int stride, int qt,
                       int tk, int slot, int nslot, int64_t rb, const void* xt,
                       void* yt, int64_t npad, int64_t L, int64_t nrow,
                       int nrhs, void* stream) {
  return launch_dia_spmm<double, false>(coef, offsets, ndiags, table, nclusters,
                                        stride, qt, tk, slot, nslot, rb, xt, yt,
                                        npad, L, nrow, nrhs, stream);
}

const char* tsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
