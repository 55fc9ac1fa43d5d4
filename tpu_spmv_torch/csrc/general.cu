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
// Both SpMVs also take bf16 data (the reference's packs with
// dtype=bfloat16 run K4 and K5a-K5d on bf16 coefficients): one more
// template parameter C, the stored coefficients' type, on the same bodies
// (gpr_spmv<float, __nv_bfloat16>, ell_spmv<float, __nv_bfloat16>;
// tsp_gpr_spmv_bf16f32, tsp_ell_spmv_bf16f32).  Each value is loaded as
// its 2 bytes, widened by __bfloat162float (exact) and summed in float32
// in the same lane order and butterfly (GPR) or slot order (ELL); x, y and
// the sums are float32.  Where the float and double forms contract
// a * b + c to one fma, the bf16 form rounds the product, then the sum
// (__fmul_rn, __fadd_rn), so its plain version (kernels/gpr.py,
// kernels/ell_packed.py), which sums the float32 products in the kernel's
// order, gives the same bits.  The byte bound falls from 8 to 6 bytes an
// entry; the scattered x gathers stay as they are.
//
// What bounds them on this card: device-memory bytes where the x gathers
// are local, and the L2's rate for scattered requests where they are not.
// Per entry both read a value and an int32 column (8 B in f32) and gather
// one x value; x is reused across rows and mostly served from the 50 MB
// L2, and a scattered gather is a 32 B sector request to L2 per value
// where L1 misses (32M for the 2M-row operand's 32M entries, as many as a
// library CSR kernel pays).  On an NVIDIA H100 80GB HBM3 at 700 W
// (bench/variant_ab.py --suite gather, PERF.md) sliced ELL one slot a step
// took 0.0736 ms on the 2048x2048-grid Poisson in its natural order, 82%
// of its byte bound, and 0.1613 ms on the same matrix in a shuffled node
// order: the same slots and bytes, the difference its 21M scattered
// gathers (about 240 G requests/s in f32, 111 G/s in f64).  With its slot
// loads ahead (below): 0.0772 and 0.1523 ms, in f64 0.1144 and 0.2469
// (0.2984 before).
// GPR adds 12 B of row data per row (int32 row id, int64 pointer), ELL its
// pad slots and 8 B per 32-row slice.  Two FLOPs per entry are far below
// the card's FLOP rate.
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
// ell_spmv: one warp a slice, one thread a row.  The warp reads its
// slice's width once (slice_ptr[s], slice_ptr[s + 1]: one broadcast load
// each), and each thread walks its row's slots in batches of kEllBatch:
// first all the batch's column and value loads (streaming, __ldcs;
// neighbouring threads read neighbouring slots, so they are coalesced),
// then all its x gathers (__ldg), then the FMAs in slot order.  A loop of
// one slot a step with a trip count the compiler does not know keeps one
// chain (column, x, FMA) in flight a thread; the batches keep kEllBatch
// gathers in flight, which is what the shuffled operands wait on.  Neither
// kernel uses atomics: every row has one writer and a fixed summation
// order (ell_spmv: slots j = 0 .. width-1, the same contraction as a loop
// of one slot a step), so results are bitwise reproducible from run to
// run.  Sums stay in the data type (no TF32).  nvcc contracts a * b + c to
// FMA, so results may differ from an unfused plain version in the last
// bits.
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
// over the row unrolled by 4 (spmm_row_lanes).  A warp of one lane per RHS that shares each
// entry by __shfl_sync, a warp per group of short rows, the streaming
// hints on the matrix and Y, and deeper batches were all slower on the
// card.  Every output has one writer and sums its entries in order from
// zero with fma (nvcc contracts spmm_row_lanes' acc += v * x to the same
// fma), so results are bitwise reproducible and equal on every path.
// ell_spmm runs gpr_spmm's body (spmm_row), with the entries of a row
// addressed as sliced ELL's slots: slot j of row r at slice_ptr[r / 32] +
// 32 j + r % 32, every slot of the slice's width, pads included, the rows
// in order.  At 32 f32 RHS the 4 rows of a warp are neighbours of one
// slice, so each slot load of a batch reads neighbouring words of one
// sector, and each lane's 16-byte X loads fetch a 128-byte line with its
// row's 7 other lanes.  Its former design (a warp a row, one lane per RHS,
// one 4-byte X load a slot in a plain loop) kept one row's chain of column,
// X line and FMA in flight a warp: 1.9877 ms at 32 RHS on the shuffled
// 2048^2 Poisson against gpr_spmm's 1.1322 on the same operand (PERF.md).
// Each output sums its row's slots j = 0 .. width-1 in order from zero
// with fma, as the former kernel and ell_spmv did, so every column equals
// ell_spmv's and results are bitwise the former kernel's.
//
// gpr_spmm and ell_spmm also take bf16 data (the reference's SpMMs on
// pack_gpr(dtype=bfloat16) and pack_ell(dtype=bfloat16)): the stored
// coefficients' type C is one more template parameter of the same bodies
// (tsp_gpr_spmm_bf16f32, tsp_ell_spmm_bf16f32, every lane and RHS-width
// instantiation), X, Y and the sums float32.  Each value is loaded as its
// 2 bytes and widened exactly; each product is rounded, then added to the
// output's sum in entry (slot) order from zero (__fmul_rn, __fadd_rn), the
// bf16 SpMVs' arithmetic, so every column of ell_spmm bf16 is bitwise
// ell_spmv bf16's and the plain versions repeat the order bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// a stored coefficient in the type of the sums: bf16 widens exactly
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// acc + v * x on bf16 data: the product rounded, then the sum (the plain
// version's arithmetic, step for step; no contraction to fma)
__device__ __forceinline__ float madd(__nv_bfloat16 v, float x, float acc) {
  return __fadd_rn(acc, __fmul_rn(widen(v), x));
}
// ... and one fma where the coefficient is in the type of the sums
__device__ __forceinline__ float madd(float v, float x, float acc) {
  return fma(v, x, acc);
}
__device__ __forceinline__ double madd(double v, double x, double acc) {
  return fma(v, x, acc);
}

constexpr int kThreads = 256;
constexpr int kClasses = 5;
// gpr_spmv: lanes per row of each width class (8, 16, 32, 64, 128), a
// quarter of the class width, so a lane holds at most kPerLane entries
constexpr int kPerLane = 4;
__host__ __device__ constexpr int class_lanes(int c) { return 2 << c; }

struct ClassLayout {
  int64_t first_row[kClasses];      // first sorted row of the class
  int64_t nrows[kClasses];          // rows in the class
  int64_t first_block[kClasses + 1];
};

template <typename T, typename C, int TPR>
__device__ __forceinline__ void gpr_rows(
    const int* __restrict__ rows, const int64_t* __restrict__ indptr,
    const int* __restrict__ indices, const C* __restrict__ data,
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
    C v[kPerLane];
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int64_t j = j0 + e * TPR;
      col[e] = j < end ? __ldcs(indices + j) : 0;
      v[e] = j < end ? __ldcs(data + j) : C(0.0f);
    }
    T xv[kPerLane];
#pragma unroll
    for (int e = 0; e < kPerLane; ++e)
      xv[e] = j0 + e * TPR < end ? __ldg(x + col[e]) : T(0);
#pragma unroll
    for (int e = 0; e < kPerLane; ++e)
      if (j0 + e * TPR < end) acc = madd(v[e], xv[e], acc);
  }
  // every lane of the warp takes part in the butterfly (TPR divides 32)
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off, TPR);
  if (sub < nw && l == 0) y[row] = acc;
}

// C: the stored coefficients' type (T, or __nv_bfloat16 against a float T)
template <typename T, typename C = T>
__global__ void __launch_bounds__(kThreads)
    gpr_spmv(const int* __restrict__ rows, const int64_t* __restrict__ indptr,
             const int* __restrict__ indices, const C* __restrict__ data,
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
      gpr_rows<T, C, 2>(rows, indptr, indices, data, x, y, first, n, block);
      break;
    case 4:
      gpr_rows<T, C, 4>(rows, indptr, indices, data, x, y, first, n, block);
      break;
    case 8:
      gpr_rows<T, C, 8>(rows, indptr, indices, data, x, y, first, n, block);
      break;
    case 16:
      gpr_rows<T, C, 16>(rows, indptr, indices, data, x, y, first, n, block);
      break;
    default:
      gpr_rows<T, C, 32>(rows, indptr, indices, data, x, y, first, n, block);
  }
}

// ell_spmv: slots a thread loads before its x gathers
constexpr int kEllBatch = 4;

// one slot's column and value, read once: streamed (evict first)
template <typename C>
__device__ __forceinline__ void ell_slot(const int* c, const C* v, int& col,
                                         C& val) {
  col = __ldcs(c);
  val = __ldcs(v);
}

// the plain loops' step (ell_spmv, spmm_row_lanes): acc += v * x, which
// nvcc contracts to one fma where the coefficient is in the type of the
// sums (the f32 and f64 code as it was); madd's rounded product, then sum,
// on bf16 data
template <typename T, typename C>
__device__ __forceinline__ T loop_madd(C v, T x, T acc) {
  if constexpr (std::is_same_v<T, C>)
    return acc + v * x;
  else
    return madd(v, x, acc);
}

template <typename T, typename C = T>
__global__ void __launch_bounds__(kThreads)
    ell_spmv(const C* __restrict__ vals, const int* __restrict__ cols,
             const int64_t* __restrict__ slice_ptr, const T* __restrict__ x,
             T* __restrict__ y, int64_t nrow) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int64_t nslices = (nrow + 31) >> 5;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps +
                   (threadIdx.x >> 5);
       s < nslices; s += warps) {
    const int64_t begin = slice_ptr[s];
    const int width = static_cast<int>((slice_ptr[s + 1] - begin) >> 5);
    const C* __restrict__ v = vals + begin + lane;
    const int* __restrict__ c = cols + begin + lane;
    T acc = T(0);
    int j = 0;
    for (; j + kEllBatch <= width; j += kEllBatch) {
      int col[kEllBatch];
      C val[kEllBatch];
      T xv[kEllBatch];
#pragma unroll
      for (int i = 0; i < kEllBatch; ++i)
        ell_slot(c + 32 * (j + i), v + 32 * (j + i), col[i], val[i]);
#pragma unroll
      for (int i = 0; i < kEllBatch; ++i) xv[i] = __ldg(x + col[i]);
#pragma unroll
      for (int i = 0; i < kEllBatch; ++i)
        acc = loop_madd(val[i], xv[i], acc);
    }
    if (j < width) {
      // the last width - j < kEllBatch slots, the same three steps
      int col[kEllBatch];
      C val[kEllBatch];
      T xv[kEllBatch];
#pragma unroll
      for (int i = 0; i < kEllBatch; ++i)
        if (j + i < width)
          ell_slot(c + 32 * (j + i), v + 32 * (j + i), col[i], val[i]);
#pragma unroll
      for (int i = 0; i < kEllBatch; ++i)
        if (j + i < width) xv[i] = __ldg(x + col[i]);
#pragma unroll
      for (int i = 0; i < kEllBatch; ++i)
        if (j + i < width) acc = loop_madd(val[i], xv[i], acc);
    }
    const int64_t row = (s << 5) + lane;
    if (row < nrow) y[row] = acc;
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

// The SpMM body that gpr_spmm and ell_spmm both run, on the G lanes of one
// row whose entries are j = begin, begin + STEP, ... below end (CSR: STEP
// 1; sliced ELL: STEP 32, every slot of the slice's width, pads included)
// and whose output row starts at yrow.  One RHS a lane on 2 or 4 lanes a
// row: a plain loop unrolled by 4 (the batches, and the launch bounds, were
// slower here)
template <typename T, typename C, int G, int STEP>
__device__ __forceinline__ void spmm_row_lanes(int64_t begin, int64_t end,
                                               const int* __restrict__ indices,
                                               const C* __restrict__ data,
                                               const T* __restrict__ x,
                                               T* __restrict__ yrow,
                                               int nrhs) {
  for (int q = threadIdx.x % G; q < nrhs; q += G) {
    T acc = T(0);
#pragma unroll 4
    for (int64_t j = begin; j < end; j += STEP)
      acc = loop_madd(data[j],
                      x[static_cast<int64_t>(indices[j]) * nrhs + q], acc);
    yrow[q] = acc;
  }
}

// V RHS a lane, a batch of entries' columns and values loaded ahead of
// their X values; madd: one fma, or on bf16 data the rounded product,
// then the sum
template <typename T, typename C, int G, int V, int STEP>
__device__ __forceinline__ void spmm_row(int64_t begin, int64_t end,
                                         const int* __restrict__ indices,
                                         const C* __restrict__ data,
                                         const T* __restrict__ x,
                                         T* __restrict__ yrow_t, int nrhs) {
  using P = Pack<T, V>;
  constexpr int kBatch = spmm_batch(G, V);
  P* const yrow = reinterpret_cast<P*>(yrow_t);
  const P* const xp = reinterpret_cast<const P*>(x);
  const int64_t xstride = nrhs / V;
  for (int q = threadIdx.x % G; q < xstride; q += G) {
    T acc[V];
#pragma unroll
    for (int t = 0; t < V; ++t) acc[t] = T(0);
    for (int64_t j0 = begin; j0 < end; j0 += kBatch * STEP) {
      int col[kBatch];
      C v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int64_t j = j0 + i * STEP;
        col[i] = j < end ? indices[j] : 0;
        v[i] = j < end ? data[j] : static_cast<C>(0.0f);
      }
      P xv[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (j0 + i * STEP < end)
          xv[i] = xp[static_cast<int64_t>(col[i]) * xstride + q];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (j0 + i * STEP < end) {
#pragma unroll
          for (int t = 0; t < V; ++t)
            acc[t] = madd(v[i], xv[i].v[t], acc[t]);
        }
    }
    P out;
#pragma unroll
    for (int t = 0; t < V; ++t) out.v[t] = acc[t];
    yrow[q] = out;
  }
}

// gpr_spmm and ell_spmm take the same arguments: rows and ptr are GPR's
// output rows and indptr, or (ELL) unused and the slice pointers; C the
// stored coefficients' type
template <typename T, typename C, int G>
__global__ void gpr_spmm_lanes(const int* __restrict__ rows,
                               const int64_t* __restrict__ indptr,
                               const int* __restrict__ indices,
                               const C* __restrict__ data,
                               const T* __restrict__ x, T* __restrict__ y,
                               int64_t nrows, int nrhs) {
  constexpr int kRowsPerBlock = kThreads / G;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / G;
  if (r >= nrows) return;
  spmm_row_lanes<T, C, G, 1>(indptr[r], indptr[r + 1], indices, data, x,
                          y + static_cast<int64_t>(rows[r]) * nrhs, nrhs);
}

template <typename T, typename C, int G, int V>
__global__ void __launch_bounds__(kThreads)
    gpr_spmm(const int* __restrict__ rows, const int64_t* __restrict__ indptr,
             const int* __restrict__ indices, const C* __restrict__ data,
             const T* __restrict__ x, T* __restrict__ y, int64_t nrows,
             int nrhs) {
  constexpr int kRowsPerBlock = kThreads / G;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / G;
  if (r >= nrows) return;
  spmm_row<T, C, G, V, 1>(indptr[r], indptr[r + 1], indices, data, x,
                       y + static_cast<int64_t>(rows[r]) * nrhs, nrhs);
}

// sliced ELL: slot j of row r at slice_ptr[r / 32] + 32 j + r % 32
template <typename T, typename C, int G>
__global__ void ell_spmm_lanes(const int* __restrict__ rows,
                               const int64_t* __restrict__ slice_ptr,
                               const int* __restrict__ cols,
                               const C* __restrict__ vals,
                               const T* __restrict__ x, T* __restrict__ y,
                               int64_t nrow, int nrhs) {
  constexpr int kRowsPerBlock = kThreads / G;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / G;
  if (r >= nrow) return;
  spmm_row_lanes<T, C, G, 32>(slice_ptr[r >> 5] + (r & 31),
                           slice_ptr[(r >> 5) + 1], cols, vals, x,
                           y + r * nrhs, nrhs);
}

template <typename T, typename C, int G, int V>
__global__ void __launch_bounds__(kThreads)
    ell_spmm(const int* __restrict__ rows,
             const int64_t* __restrict__ slice_ptr,
             const int* __restrict__ cols, const C* __restrict__ vals,
             const T* __restrict__ x, T* __restrict__ y, int64_t nrow,
             int nrhs) {
  constexpr int kRowsPerBlock = kThreads / G;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / G;
  if (r >= nrow) return;
  spmm_row<T, C, G, V, 32>(slice_ptr[r >> 5] + (r & 31),
                        slice_ptr[(r >> 5) + 1], cols, vals, x, y + r * nrhs,
                        nrhs);
}

template <typename T, typename C = T>
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
  gpr_spmv<T, C><<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<const int64_t*>(indptr),
      static_cast<const int*>(indices), static_cast<const C*>(data),
      static_cast<const T*>(x), static_cast<T*>(y), layout);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename C = T>
int launch_ell(const void* vals, const void* cols, const void* slice_ptr,
               const void* x, void* y, int64_t nrow, void* stream) {
  if (nrow == 0) return 0;
  // one warp a slice of 32 rows, every slice's warp launched at once
  int64_t blocks = (nrow + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) blocks = 0x7fffffff;
  ell_spmv<T, C><<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(vals), static_cast<const int*>(cols),
      static_cast<const int64_t*>(slice_ptr), static_cast<const T*>(x),
      static_cast<T*>(y), nrow);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int row_blocks(int64_t nrows, unsigned* blocks) {
  const int64_t n = (nrows + kThreads / G - 1) / (kThreads / G);
  if (n > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  *blocks = static_cast<unsigned>(n);
  return 0;
}

// ELL: ell_spmm (rows unused, ptr the slice pointers), else gpr_spmm
template <typename T, typename C, int G, int V, bool ELL>
int launch_spmm_g(int64_t nrows, int nrhs, const void* rows, const void* ptr,
                  const void* indices, const void* data, const void* x,
                  void* y, cudaStream_t stream) {
  unsigned blocks;
  if (int err = row_blocks<G>(nrows, &blocks)) return err;
  const auto launch = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<const int*>(rows), static_cast<const int64_t*>(ptr),
        static_cast<const int*>(indices), static_cast<const C*>(data),
        static_cast<const T*>(x), static_cast<T*>(y), nrows, nrhs);
    return static_cast<int>(cudaGetLastError());
  };
  if constexpr (V == 1 && (G == 2 || G == 4))
    return launch(ELL ? ell_spmm_lanes<T, C, G> : gpr_spmm_lanes<T, C, G>);
  else
    return launch(ELL ? ell_spmm<T, C, G, V> : gpr_spmm<T, C, G, V>);
}

// V RHS a lane: G the smallest power of two of lanes that holds nrhs / V,
// at most 32
template <typename T, typename C, int V, bool ELL>
int launch_spmm_v(int64_t nrows, int nrhs, const void* rows, const void* ptr,
                  const void* indices, const void* data, const void* x,
                  void* y, cudaStream_t stream) {
  const int lanes = nrhs / V;
  const auto run = [&](auto g) {
    return launch_spmm_g<T, C, decltype(g)::value, V, ELL>(
        nrows, nrhs, rows, ptr, indices, data, x, y, stream);
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
// have; C the stored coefficients' type (T, or __nv_bfloat16 against a
// float32 X)
template <typename T, bool ELL, typename C = T>
int launch_spmm(int64_t nrows, int nrhs, const void* rows, const void* ptr,
                const void* indices, const void* data, const void* x,
                void* y, void* stream) {
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
      return launch_spmm_v<T, C, 4, ELL>(nrows, nrhs, rows, ptr, indices,
                                         data, x, y, st);
  }
  if (fits(2))
    return launch_spmm_v<T, C, 2, ELL>(nrows, nrhs, rows, ptr, indices, data,
                                       x, y, st);
  return launch_spmm_v<T, C, 1, ELL>(nrows, nrhs, rows, ptr, indices, data,
                                     x, y, st);
}

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

// K5a-K5d and K4 on bf16 data: bf16 coefficients, float32 x, y and sums
int tsp_gpr_spmv_bf16f32(const void* rows, const void* indptr,
                         const void* indices, const void* data,
                         const void* x, void* y, int64_t n8, int64_t n16,
                         int64_t n32, int64_t n64, int64_t n128,
                         void* stream) {
  const int64_t class_rows[kClasses] = {n8, n16, n32, n64, n128};
  return launch_gpr<float, __nv_bfloat16>(rows, indptr, indices, data, x, y,
                                          class_rows, stream);
}

int tsp_ell_spmv_bf16f32(const void* vals, const void* cols,
                         const void* slice_ptr, const void* x, void* y,
                         int64_t nrow, void* stream) {
  return launch_ell<float, __nv_bfloat16>(vals, cols, slice_ptr, x, y, nrow,
                                          stream);
}

int tsp_gpr_spmm_f32(const void* rows, const void* indptr,
                     const void* indices, const void* data, const void* x,
                     void* y, int64_t nrows, int nrhs, void* stream) {
  return launch_spmm<float, false>(nrows, nrhs, rows, indptr, indices, data,
                                  x, y, stream);
}

int tsp_gpr_spmm_f64(const void* rows, const void* indptr,
                     const void* indices, const void* data, const void* x,
                     void* y, int64_t nrows, int nrhs, void* stream) {
  return launch_spmm<double, false>(nrows, nrhs, rows, indptr, indices, data,
                                   x, y, stream);
}

// gpr_spmm on bf16 data: bf16 coefficients, float32 X, Y and sums
int tsp_gpr_spmm_bf16f32(const void* rows, const void* indptr,
                         const void* indices, const void* data,
                         const void* x, void* y, int64_t nrows, int nrhs,
                         void* stream) {
  return launch_spmm<float, false, __nv_bfloat16>(nrows, nrhs, rows, indptr,
                                                  indices, data, x, y,
                                                  stream);
}

int tsp_ell_spmm_f32(const void* vals, const void* cols, const void* slice_ptr,
                     const void* x, void* y, int64_t nrow, int nrhs,
                     void* stream) {
  return launch_spmm<float, true>(nrow, nrhs, nullptr, slice_ptr, cols, vals,
                                  x, y, stream);
}

int tsp_ell_spmm_f64(const void* vals, const void* cols, const void* slice_ptr,
                     const void* x, void* y, int64_t nrow, int nrhs,
                     void* stream) {
  return launch_spmm<double, true>(nrow, nrhs, nullptr, slice_ptr, cols,
                                   vals, x, y, stream);
}

// ell_spmm on bf16 data
int tsp_ell_spmm_bf16f32(const void* vals, const void* cols,
                         const void* slice_ptr, const void* x, void* y,
                         int64_t nrow, int nrhs, void* stream) {
  return launch_spmm<float, true, __nv_bfloat16>(nrow, nrhs, nullptr,
                                                 slice_ptr, cols, vals, x, y,
                                                 stream);
}

}  // extern "C"
