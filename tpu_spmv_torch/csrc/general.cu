// General-sparsity kernels for Hopper (sm_90a): the SpMVs gpr_spmv and
// ell_spmv and their multi-RHS forms gpr_spmm and ell_spmm.
//
// gpr_spmv replaces the gather-permute-reduce pipeline of the JAX reference
// package, tpu_spmv/kernels/gpr.py (via spmv_gpr):
//   K5a _fused_gather_s1_kernel   gather x + permutation stage 1
//   K5b _fused_s23_reduce_rhs_kernel(_v3)   stages 2-3 + width-8 partials
//   K5c _reduce_step_kernel       per-width-class mask-dot row reduce
//   K5d _gather_kernel            unfused x gather into slot tiles
// On a TPU those four stages exist because the fast gather works only
// inside 128 lanes: x is gathered in column-segment order and routed by a
// Clos permutation into row-aligned tiles.  A Hopper thread reads any
// address, so the composite (gather, route, reduce) is one pass over the
// class-sorted CSR rows: for every sorted row r,
//     y_int[rows[r]] = sum_{j in [indptr[r], indptr[r+1])} data[j] * x[indices[j]]
// Rows are written in place at their internal id, so the reference's
// y-restoring permutation has nothing to do.  The virtual (hub-split) rows
// fold back into their owners outside the kernel (kernels/gpr.py).
//
// ell_spmv replaces K4, tpu_spmv/kernels/ell_pallas.py:_kernel (via
// spmv_pallas): sliced ELL with 32 rows per slice, slots column-major in a
// slice (slot j of row i of slice s at slice_ptr[s] + 32 j + i); pad slots
// hold value 0 and column 0.
//
// What bounds them on this card: device-memory bytes and the x gather.
// Per entry both read a value and an int32 column (8 B in f32) and gather
// one x value; x is reused across rows and mostly served from the 50 MB
// L2, and the random gather is a 32 B sector of L2 per value where L1
// misses (32M sectors for the 2M-row operand's 32M entries, as many as a
// library CSR kernel pays).  GPR adds 12 B of row data per row (int32 row
// id, int64 pointer), ELL its pad slots and 8 B per 32-row slice.  Two
// FLOPs per entry are far below the card's FLOP rate.
//
// What the designs do about it.  gpr_spmv: a row of class W (8, 16, 32,
// 64, 128 entries at most) gets T = W / 4 lanes, so each lane holds at
// most four of its entries (kPerLane) and a warp serves 32 / T rows.  One
// lane per class width would leave each lane one entry and a chain of
// three dependent loads (row pointer, column, x) with one FMA at its end;
// here the warp reads its rows' pointers and row ids with one coalesced
// load each and hands them out with __shfl_sync, and each lane then
// issues all its column and value loads, then all its x gathers, before
// the first FMA: four independent chains in flight per lane.  The columns
// and values are read once and carry the streaming hint (__ldcs, evict
// first); x goes through the read-only path (__ldg), its reuse left to L1
// and L2.  Lane
// l sums entries l, l + T, l + 2T, ... in order; a fixed __shfl_xor_sync
// butterfly combines the lanes; one lane writes the row.  All classes go
// in one launch: the block index picks the class.
// ell_spmv: one thread per row sums its slots j = 0 .. width-1 in order;
// neighbouring threads read neighbouring slots, so every value and column
// load is coalesced.  Neither kernel uses atomics: every row has one
// writer and a fixed summation order, so results are bitwise reproducible
// from run to run.  Sums stay in the data type (no TF32).  nvcc contracts
// a * b + c to FMA, so results may differ from an unfused plain version in
// the last bits.
//
// gpr_spmm replaces the RHS-batched GPR pipeline (via spmm_gpr): K6
// _fused_gather_s1_rhs_kernel (gather + stage 1 over RHS planes) and the
// RHS-batched use of K5b (_fused_s23_reduce_rhs_kernel(_v3), grid (nrhs,
// tiles)), with the class combine and y-order restore that the reference
// runs after them.  ell_spmm replaces spmm_pallas, which maps K4 over the
// RHS columns.  X is [ncol, nrhs] and Y [rows, nrhs], row-major (the
// reference's convention), so the nrhs values of one x row are one
// contiguous line (128 B for 32 f32 values).  The bytes they must move are
// the matrix once plus nrhs x and y values per row; the matrix read that
// bounds the SpMVs is shared by the RHS.  What bounds gpr_spmm in
// practice is the X lines: one per entry (the matrix is read once), from
// L2, and from device memory where X outgrows the 50 MB L2 (the 2M-row
// operand's X at 32 RHS is 256 MB).  A warp a row with one lane per RHS
// makes 32 four-byte loads for each line and keeps one row's lines in
// flight a warp.
//
// gpr_spmm's design: G lanes a row, each lane V consecutive RHS (V = 4
// f32 or 2 values, 16 bytes, where nrhs allows it and keeps 4 lanes a row;
// else 2, else 1), G the smallest power of two of lanes that holds nrhs /
// V, at most 32, chunks of G * V RHS beyond that.  At 32 f32 RHS that is
// 8 lanes of 4 RHS a row and 4 rows a warp: each lane loads 16 bytes of an
// X row, the 8 lanes one 128-byte line, and a warp has four rows' lines in
// flight.  Each lane loads the columns and values of a batch of entries
// (spmm_batch; the group's lanes read the same address, one broadcast),
// then their X values (V at a time), then runs the FMAs in entry order;
// one RHS a lane on 2 or 4 lanes a row runs gpr_spmm_lanes, a plain loop
// over the row unrolled by 4.  A warp of one lane per RHS that shares each
// entry by __shfl_sync, a warp per group of short rows, the streaming
// hints on the matrix and Y, and deeper batches were all slower on the
// card.  Every output has one writer and sums its entries in order from
// zero with fma (nvcc contracts gpr_spmm_lanes' acc += v * x to the same
// fma), so results are bitwise reproducible and equal on every path.
// ell_spmm: a group of G lanes per row, one lane per RHS, looping over
// chunks of G RHS when nrhs > 32; every lane of a group walks the row's
// slots in order (j = 0 .. width-1), so results are bitwise reproducible.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kClasses = 5;
// one full wave on an H100: 132 SMs x 8 resident blocks of 256 threads
constexpr int kMaxBlocks = 132 * 8;

// gpr_spmv: lanes per row of each width class (8, 16, 32, 64, 128), a
// quarter of the class width, so a lane holds at most kPerLane entries
constexpr int kPerLane = 4;
__host__ __device__ constexpr int class_lanes(int c) { return 2 << c; }

struct ClassLayout {
  int64_t first_row[kClasses];      // first sorted row of the class
  int64_t nrows[kClasses];          // rows in the class
  int64_t first_block[kClasses + 1];
};

template <typename T, int TPR>
__device__ __forceinline__ void gpr_rows(
    const int* __restrict__ rows, const int64_t* __restrict__ indptr,
    const int* __restrict__ indices, const T* __restrict__ data,
    const T* __restrict__ x, T* __restrict__ y, int64_t first_row,
    int64_t nrows, int64_t block) {
  constexpr int kRowsPerWarp = 32 / TPR;
  const int lane = threadIdx.x % 32;
  const int64_t r0 =
      (block * (kThreads / 32) + threadIdx.x / 32) * kRowsPerWarp;
  if (r0 >= nrows) return;            // the whole warp: no shuffle is left
  // the warp's row metadata in one coalesced load each: lanes 0..nw read
  // the nw + 1 row pointers, lanes 0..nw-1 the internal row ids
  const int nw = nrows - r0 < kRowsPerWarp ? static_cast<int>(nrows - r0)
                                            : kRowsPerWarp;
  const int64_t g0 = first_row + r0;
  long long ip = 0;
  int id = 0;
  if (lane <= nw)
    ip = __ldcs(reinterpret_cast<const long long*>(indptr) + g0 + lane);
  if (lane < nw) id = __ldcs(rows + g0 + lane);
  const int sub = lane / TPR, l = lane % TPR;
  // a row past the warp's last gets begin >= end (lane nw + 1 holds 0)
  const int64_t begin = __shfl_sync(0xffffffffu, ip, sub);
  const int64_t end = __shfl_sync(0xffffffffu, ip, sub + 1);
  const int row = __shfl_sync(0xffffffffu, id, sub);
  T acc = T(0);
  // lane l sums entries l, l + TPR, l + 2 TPR, ... in order; a row of its
  // class has at most kPerLane of them per lane, so the loop runs once,
  // with every value and column load issued before the first x gather
  for (int64_t j0 = begin + l; j0 < end; j0 += kPerLane * TPR) {
    int col[kPerLane];
    T v[kPerLane];
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int64_t j = j0 + e * TPR;
      col[e] = j < end ? __ldcs(indices + j) : 0;
      v[e] = j < end ? __ldcs(data + j) : T(0);
    }
    T xv[kPerLane];
#pragma unroll
    for (int e = 0; e < kPerLane; ++e)
      xv[e] = j0 + e * TPR < end ? __ldg(x + col[e]) : T(0);
#pragma unroll
    for (int e = 0; e < kPerLane; ++e)
      if (j0 + e * TPR < end) acc = fma(v[e], xv[e], acc);
  }
  // every lane of the warp takes part in the butterfly (TPR divides 32)
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off, TPR);
  if (sub < nw && l == 0) y[row] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gpr_spmv(const int* __restrict__ rows, const int64_t* __restrict__ indptr,
             const int* __restrict__ indices, const T* __restrict__ data,
             const T* __restrict__ x, T* __restrict__ y, ClassLayout layout) {
  // the block's class: the last one that starts at or before it (an empty
  // class starts where the next one does).  The unrolled loop indexes the
  // layout with constants, so it stays in registers.
  const int64_t b = blockIdx.x;
  int c = 0;
  int64_t block = b, first = 0, n = 0;
#pragma unroll
  for (int k = 0; k < kClasses; ++k) {
    if (b >= layout.first_block[k]) {
      c = k;
      block = b - layout.first_block[k];
      first = layout.first_row[k];
      n = layout.nrows[k];
    }
  }
  switch (class_lanes(c)) {
    case 2:
      gpr_rows<T, 2>(rows, indptr, indices, data, x, y, first, n, block);
      break;
    case 4:
      gpr_rows<T, 4>(rows, indptr, indices, data, x, y, first, n, block);
      break;
    case 8:
      gpr_rows<T, 8>(rows, indptr, indices, data, x, y, first, n, block);
      break;
    case 16:
      gpr_rows<T, 16>(rows, indptr, indices, data, x, y, first, n, block);
      break;
    default:
      gpr_rows<T, 32>(rows, indptr, indices, data, x, y, first, n, block);
  }
}

template <typename T>
__global__ void ell_spmv(const T* __restrict__ vals,
                         const int* __restrict__ cols,
                         const int64_t* __restrict__ slice_ptr,
                         const T* __restrict__ x, T* __restrict__ y,
                         int64_t nrow) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       row < nrow; row += stride) {
    const int64_t s = row >> 5;
    const int64_t end = slice_ptr[s + 1];
    T acc = T(0);
    for (int64_t p = slice_ptr[s] + (row & 31); p < end; p += 32)
      acc += vals[p] * x[cols[p]];
    y[row] = acc;
  }
}

// V consecutive values of one type, loaded and stored as one
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// gpr_spmm: entries whose X values a lane loads before their FMAs, 16
// values a lane where it has V > 1 RHS (4 entries of 4, 8 of 2); with one
// RHS a lane, 16 entries where the lane has its row to itself (G = 1) and
// 8 where 8 or more lanes share a row
__host__ __device__ constexpr int spmm_batch(int G, int V) {
  return V > 1 ? 16 / V : (G == 1 ? 16 : 8);
}

// one RHS a lane on 2 or 4 lanes a row: a plain loop unrolled by 4 (the
// batches, and the launch bounds, were slower here)
template <typename T, int G>
__global__ void gpr_spmm_lanes(const int* __restrict__ rows,
                               const int64_t* __restrict__ indptr,
                               const int* __restrict__ indices,
                               const T* __restrict__ data,
                               const T* __restrict__ x, T* __restrict__ y,
                               int64_t nrows, int nrhs) {
  constexpr int kRowsPerBlock = kThreads / G;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / G;
  if (r >= nrows) return;
  const int64_t begin = indptr[r], end = indptr[r + 1];
  T* yrow = y + static_cast<int64_t>(rows[r]) * nrhs;
  for (int q = threadIdx.x % G; q < nrhs; q += G) {
    T acc = T(0);
#pragma unroll 4
    for (int64_t j = begin; j < end; ++j)
      acc += data[j] * x[static_cast<int64_t>(indices[j]) * nrhs + q];
    yrow[q] = acc;
  }
}

template <typename T, int G, int V>
__global__ void __launch_bounds__(kThreads)
    gpr_spmm(const int* __restrict__ rows, const int64_t* __restrict__ indptr,
             const int* __restrict__ indices, const T* __restrict__ data,
             const T* __restrict__ x, T* __restrict__ y, int64_t nrows,
             int nrhs) {
  using P = Pack<T, V>;
  constexpr int kBatch = spmm_batch(G, V);
  constexpr int kRowsPerBlock = kThreads / G;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / G;
  if (r >= nrows) return;
  const int64_t begin = indptr[r], end = indptr[r + 1];
  P* const yrow =
      reinterpret_cast<P*>(y + static_cast<int64_t>(rows[r]) * nrhs);
  const P* const xp = reinterpret_cast<const P*>(x);
  const int64_t xstride = nrhs / V;
  for (int q = threadIdx.x % G; q < xstride; q += G) {
    T acc[V];
#pragma unroll
    for (int t = 0; t < V; ++t) acc[t] = T(0);
    for (int64_t j0 = begin; j0 < end; j0 += kBatch) {
      int col[kBatch];
      T v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int64_t j = j0 + i;
        col[i] = j < end ? indices[j] : 0;
        v[i] = j < end ? data[j] : T(0);
      }
      P xv[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (j0 + i < end)
          xv[i] = xp[static_cast<int64_t>(col[i]) * xstride + q];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (j0 + i < end) {
#pragma unroll
          for (int t = 0; t < V; ++t) acc[t] = fma(v[i], xv[i].v[t], acc[t]);
        }
    }
    P out;
#pragma unroll
    for (int t = 0; t < V; ++t) out.v[t] = acc[t];
    yrow[q] = out;
  }
}

template <typename T, int G>
__global__ void ell_spmm(const T* __restrict__ vals,
                         const int* __restrict__ cols,
                         const int64_t* __restrict__ slice_ptr,
                         const T* __restrict__ x, T* __restrict__ y,
                         int64_t nrow, int nrhs) {
  constexpr int kRowsPerBlock = kThreads / G;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / G;
  if (row >= nrow) return;
  const int64_t s = row >> 5;
  const int64_t begin = slice_ptr[s] + (row & 31), end = slice_ptr[s + 1];
  T* yrow = y + row * nrhs;
  for (int q = threadIdx.x % G; q < nrhs; q += G) {
    T acc = T(0);
#pragma unroll 4
    for (int64_t p = begin; p < end; p += 32)
      acc += vals[p] * x[static_cast<int64_t>(cols[p]) * nrhs + q];
    yrow[q] = acc;
  }
}

template <typename T>
int launch_gpr(const void* rows, const void* indptr, const void* indices,
               const void* data, const void* x, void* y,
               const int64_t* class_rows, void* stream) {
  ClassLayout layout;
  int64_t row = 0, blocks = 0;
  for (int c = 0; c < kClasses; ++c) {
    const int64_t rows_per_block = kThreads / class_lanes(c);
    layout.first_row[c] = row;
    layout.nrows[c] = class_rows[c];
    layout.first_block[c] = blocks;
    row += class_rows[c];
    blocks += (class_rows[c] + rows_per_block - 1) / rows_per_block;
  }
  layout.first_block[kClasses] = blocks;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  gpr_spmv<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<const int64_t*>(indptr),
      static_cast<const int*>(indices), static_cast<const T*>(data),
      static_cast<const T*>(x), static_cast<T*>(y), layout);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ell(const void* vals, const void* cols, const void* slice_ptr,
               const void* x, void* y, int64_t nrow, void* stream) {
  if (nrow == 0) return 0;
  int64_t blocks = (nrow + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  ell_spmv<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int*>(cols),
      static_cast<const int64_t*>(slice_ptr), static_cast<const T*>(x),
      static_cast<T*>(y), nrow);
  return static_cast<int>(cudaGetLastError());
}

// lanes per row: the smallest power of two that holds nrhs, at most 32
template <typename T, template <typename, int> class Launch, typename... A>
int by_group(int64_t nrows, int nrhs, A... args) {
  if (nrows <= 0 || nrhs <= 0) return 0;
  if (nrhs == 1) return Launch<T, 1>::run(nrows, nrhs, args...);
  if (nrhs <= 2) return Launch<T, 2>::run(nrows, nrhs, args...);
  if (nrhs <= 4) return Launch<T, 4>::run(nrows, nrhs, args...);
  if (nrhs <= 8) return Launch<T, 8>::run(nrows, nrhs, args...);
  if (nrhs <= 16) return Launch<T, 16>::run(nrows, nrhs, args...);
  return Launch<T, 32>::run(nrows, nrhs, args...);
}

template <int G>
int row_blocks(int64_t nrows, unsigned* blocks) {
  const int64_t n = (nrows + kThreads / G - 1) / (kThreads / G);
  if (n > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(n);
  return 0;
}

template <typename T, int G, int V>
int launch_gpr_spmm_g(int64_t nrows, int nrhs, const void* rows,
                      const void* indptr, const void* indices,
                      const void* data, const void* x, void* y,
                      cudaStream_t stream) {
  unsigned blocks;
  if (int err = row_blocks<G>(nrows, &blocks)) return err;
  const auto launch = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<const int*>(rows), static_cast<const int64_t*>(indptr),
        static_cast<const int*>(indices), static_cast<const T*>(data),
        static_cast<const T*>(x), static_cast<T*>(y), nrows, nrhs);
    return static_cast<int>(cudaGetLastError());
  };
  if constexpr (V == 1 && (G == 2 || G == 4))
    return launch(gpr_spmm_lanes<T, G>);
  else
    return launch(gpr_spmm<T, G, V>);
}

// gpr_spmm with V RHS a lane: G the smallest power of two of lanes that
// holds nrhs / V, at most 32
template <typename T, int V>
int launch_gpr_spmm_v(int64_t nrows, int nrhs, const void* rows,
                      const void* indptr, const void* indices,
                      const void* data, const void* x, void* y,
                      cudaStream_t stream) {
  const int lanes = nrhs / V;
  const auto run = [&](auto g) {
    return launch_gpr_spmm_g<T, decltype(g)::value, V>(
        nrows, nrhs, rows, indptr, indices, data, x, y, stream);
  };
  if (lanes <= 1) return run(std::integral_constant<int, 1>());
  if (lanes <= 2) return run(std::integral_constant<int, 2>());
  if (lanes <= 4) return run(std::integral_constant<int, 4>());
  if (lanes <= 8) return run(std::integral_constant<int, 8>());
  if (lanes <= 16) return run(std::integral_constant<int, 16>());
  return run(std::integral_constant<int, 32>());
}

// the widest V (16 bytes, else 8, else one value) that divides nrhs,
// leaves at least 4 lanes a row (nrhs / V >= 4: fewer lanes would put
// more rows, of unequal lengths, on one warp) and whose alignment X and Y
// have
template <typename T>
int launch_gpr_spmm(int64_t nrows, int nrhs, const void* rows,
                    const void* indptr, const void* indices, const void* data,
                    const void* x, void* y, void* stream) {
  if (nrows <= 0 || nrhs <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  auto fits = [&](int v) {
    const uintptr_t bytes = v * sizeof(T);
    return nrhs % v == 0 && nrhs / v >= 4 &&
           reinterpret_cast<uintptr_t>(x) % bytes == 0 &&
           reinterpret_cast<uintptr_t>(y) % bytes == 0;
  };
  if constexpr (sizeof(T) == 4) {
    if (fits(4))
      return launch_gpr_spmm_v<T, 4>(nrows, nrhs, rows, indptr, indices, data,
                                     x, y, st);
  }
  if (fits(2))
    return launch_gpr_spmm_v<T, 2>(nrows, nrhs, rows, indptr, indices, data,
                                   x, y, st);
  return launch_gpr_spmm_v<T, 1>(nrows, nrhs, rows, indptr, indices, data, x,
                                 y, st);
}

template <typename T, int G>
struct EllSpmm {
  static int run(int64_t nrow, int nrhs, const void* vals, const void* cols,
                 const void* slice_ptr, const void* x, void* y,
                 void* stream) {
    unsigned blocks;
    if (int err = row_blocks<G>(nrow, &blocks)) return err;
    ell_spmm<T, G><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(vals), static_cast<const int*>(cols),
        static_cast<const int64_t*>(slice_ptr), static_cast<const T*>(x),
        static_cast<T*>(y), nrow, nrhs);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

extern "C" {

int tsp_gpr_spmv_f32(const void* rows, const void* indptr,
                     const void* indices, const void* data, const void* x,
                     void* y, int64_t n8, int64_t n16, int64_t n32,
                     int64_t n64, int64_t n128, void* stream) {
  const int64_t class_rows[kClasses] = {n8, n16, n32, n64, n128};
  return launch_gpr<float>(rows, indptr, indices, data, x, y, class_rows,
                           stream);
}

int tsp_gpr_spmv_f64(const void* rows, const void* indptr,
                     const void* indices, const void* data, const void* x,
                     void* y, int64_t n8, int64_t n16, int64_t n32,
                     int64_t n64, int64_t n128, void* stream) {
  const int64_t class_rows[kClasses] = {n8, n16, n32, n64, n128};
  return launch_gpr<double>(rows, indptr, indices, data, x, y, class_rows,
                            stream);
}

int tsp_ell_spmv_f32(const void* vals, const void* cols, const void* slice_ptr,
                     const void* x, void* y, int64_t nrow, void* stream) {
  return launch_ell<float>(vals, cols, slice_ptr, x, y, nrow, stream);
}

int tsp_ell_spmv_f64(const void* vals, const void* cols, const void* slice_ptr,
                     const void* x, void* y, int64_t nrow, void* stream) {
  return launch_ell<double>(vals, cols, slice_ptr, x, y, nrow, stream);
}

int tsp_gpr_spmm_f32(const void* rows, const void* indptr,
                     const void* indices, const void* data, const void* x,
                     void* y, int64_t nrows, int nrhs, void* stream) {
  return launch_gpr_spmm<float>(nrows, nrhs, rows, indptr, indices, data, x, y,
                                stream);
}

int tsp_gpr_spmm_f64(const void* rows, const void* indptr,
                     const void* indices, const void* data, const void* x,
                     void* y, int64_t nrows, int nrhs, void* stream) {
  return launch_gpr_spmm<double>(nrows, nrhs, rows, indptr, indices, data, x,
                                 y, stream);
}

int tsp_ell_spmm_f32(const void* vals, const void* cols, const void* slice_ptr,
                     const void* x, void* y, int64_t nrow, int nrhs,
                     void* stream) {
  return by_group<float, EllSpmm>(nrow, nrhs, vals, cols, slice_ptr, x, y,
                                  stream);
}

int tsp_ell_spmm_f64(const void* vals, const void* cols, const void* slice_ptr,
                     const void* x, void* y, int64_t nrow, int nrhs,
                     void* stream) {
  return by_group<double, EllSpmm>(nrow, nrhs, vals, cols, slice_ptr, x, y,
                                   stream);
}

}  // extern "C"
