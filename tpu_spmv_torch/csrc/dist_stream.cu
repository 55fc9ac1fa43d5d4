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
// K8b runs the walks of psdia_walk.cuh, shared with K2 (dia_stream.cu):
// windows of the ring [left | x | right] (zeros outside [-h, cp + h),
// columns no row reads) and the pattern's rows staged in shared memory
// along the stride or cluster walk that the host plan picks
// (kernels/dia_stream.py:psdia_walk_plan, kept with the sharded pack), the
// stride walk's windows by bulk copy (up to three pieces a window: left, x
// and right) where the buffers, cp, h and rb are 16-byte aligned, else by
// cp.async.  Rows whose base + k leaves [L, L + nrow) are written as zeros.
// Each row sums its diagonals in stored order with fma, as K2 does, from
// the values K2 reads (at one shard the valid rows never read past the
// padded row space), so K8b is bitwise K2 on the same pack at one shard and
// the sharded chain bitwise the single-chip product; one writer per row,
// no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "psdia_walk.cuh"

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

// K8b: the walk of psdia_walk.cuh with the ring [left | x | right] as the
// window source and the shard's first padded row as the row mask's origin
template <typename T>
int launch_psdia_ring(const void* pattern, const void* args, const void* x,
                      const void* left, const void* right, void* y,
                      int64_t cp, int64_t h, int64_t base, int64_t L,
                      int64_t nrow, void* stream) {
  const WindowSource<T> src{static_cast<const T*>(x),
                            static_cast<const T*>(left),
                            static_cast<const T*>(right), cp, h};
  return launch_walk<T>(*static_cast<const WalkArgs*>(args), pattern, src, y,
                        base, L, nrow, stream);
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

int tsp_psdia_ring_f32(const void* pattern, const void* args, const void* x,
                       const void* left, const void* right, void* y,
                       int64_t cp, int64_t h, int64_t base, int64_t L,
                       int64_t nrow, void* stream) {
  return launch_psdia_ring<float>(pattern, args, x, left, right, y, cp, h,
                                  base, L, nrow, stream);
}

int tsp_psdia_ring_f64(const void* pattern, const void* args, const void* x,
                       const void* left, const void* right, void* y,
                       int64_t cp, int64_t h, int64_t base, int64_t L,
                       int64_t nrow, void* stream) {
  return launch_psdia_ring<double>(pattern, args, x, left, right, y, cp, h,
                                   base, L, nrow, stream);
}

}  // extern "C"
