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
// What bounds them on this card: device-memory bytes.  Per entry both read
// a value and an int32 column (8 B in f32) and gather one x value; x is
// reused across rows and mostly served from the 50 MB L2, and the random
// gather is a 32 B sector per value where it misses.  GPR adds 12 B of row
// data per row (int32 row id, int64 pointer), ELL its pad slots and 8 B per
// 32-row slice.  Two FLOPs per entry are far below the card's FLOP rate.
//
// What the designs do about it.  gpr_spmv: each width class gets
// min(W, 32) threads per row (classes 8 and 16 pack 4 and 2 rows into a
// warp, classes 32, 64 and 128 loop a full warp over the row), so the
// threads of a row read neighbouring entries and a narrow row does not
// idle a whole warp.  Lane l sums entries l, l + T, l + 2T, ... in order;
// a fixed __shfl_xor_sync butterfly combines the lanes; one lane writes
// the row.  All classes go in one launch: the block index picks the class.
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
// bounds the SpMVs is shared by the RHS.  The design: a group of G lanes
// per row (G the smallest power of two that holds nrhs, at most 32), one
// lane per RHS, looping over chunks of G RHS when nrhs > 32.  Every lane of
// a group walks the row's entries in order, so the value and column loads
// are the same address for the group (one broadcast) and the x loads of a
// group are one contiguous line; each lane sums its RHS in entry order with
// no shuffle, and one lane writes each output value.  The row order is
// gpr_spmv's (class-sorted, written in place at the internal row id) and
// ell_spmv's (slots j = 0 .. width-1), so results are bitwise reproducible
// from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kClasses = 5;
// one full wave on an H100: 132 SMs x 8 resident blocks of 256 threads
constexpr int kMaxBlocks = 132 * 8;

// threads per row of each width class (8, 16, 32, 64, 128)
__host__ __device__ constexpr int class_tpr(int c) {
  return c == 0 ? 8 : (c == 1 ? 16 : 32);
}

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
  constexpr int kRowsPerBlock = kThreads / TPR;
  const int lane = threadIdx.x % TPR;
  const int64_t r = block * kRowsPerBlock + threadIdx.x / TPR;
  const bool valid = r < nrows;
  T acc = T(0);
  if (valid) {
    const int64_t g = first_row + r;
    const int64_t end = indptr[g + 1];
    for (int64_t j = indptr[g] + lane; j < end; j += TPR)
      acc += data[j] * x[indices[j]];
  }
  // every lane of the warp takes part in the butterfly (TPR divides 32)
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off, TPR);
  if (valid && lane == 0) y[rows[first_row + r]] = acc;
}

template <typename T>
__global__ void gpr_spmv(const int* __restrict__ rows,
                         const int64_t* __restrict__ indptr,
                         const int* __restrict__ indices,
                         const T* __restrict__ data, const T* __restrict__ x,
                         T* __restrict__ y, ClassLayout layout) {
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
  switch (class_tpr(c)) {
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

template <typename T, int G>
__global__ void gpr_spmm(const int* __restrict__ rows,
                         const int64_t* __restrict__ indptr,
                         const int* __restrict__ indices,
                         const T* __restrict__ data, const T* __restrict__ x,
                         T* __restrict__ y, int64_t nrows, int nrhs) {
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
    const int64_t rows_per_block = kThreads / class_tpr(c);
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

template <typename T, int G>
struct GprSpmm {
  static int run(int64_t nrows, int nrhs, const void* rows,
                 const void* indptr, const void* indices, const void* data,
                 const void* x, void* y, void* stream) {
    unsigned blocks;
    if (int err = row_blocks<G>(nrows, &blocks)) return err;
    gpr_spmm<T, G><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rows), static_cast<const int64_t*>(indptr),
        static_cast<const int*>(indices), static_cast<const T*>(data),
        static_cast<const T*>(x), static_cast<T*>(y), nrows, nrhs);
    return static_cast<int>(cudaGetLastError());
  }
};

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
  return by_group<float, GprSpmm>(nrows, nrhs, rows, indptr, indices, data, x,
                                  y, stream);
}

int tsp_gpr_spmm_f64(const void* rows, const void* indptr,
                     const void* indices, const void* data, const void* x,
                     void* y, int64_t nrows, int nrhs, void* stream) {
  return by_group<double, GprSpmm>(nrows, nrhs, rows, indptr, indices, data,
                                   x, y, stream);
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
