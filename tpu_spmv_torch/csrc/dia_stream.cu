// Streaming DIA SpMV kernels for Hopper (sm_90a): K1 (SDIA) and K2 (PSDIA).
//
// Replaces the Pallas TPU kernels of the JAX reference package:
//   K1  tpu_spmv/kernels/dia_stream.py:_kernel   (via spmv_sdia_padded)
//   K2  tpu_spmv/kernels/dia_stream.py:_pkernel  (via spmv_psdia_padded)
//
// Both compute, in the padded row space of the pack (xpad[k] = x[k - L]),
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
// What the design does about it: one thread owns one padded row (grid-stride
// loop), so neighbouring threads read neighbouring addresses of data, pattern
// and xpad and every load is coalesced; the diagonal offsets sit in shared
// memory.  The TPU kernel needs halo blocks and clamped edge fetches because
// its grid walks row tiles through VMEM; here the caches serve the
// neighbouring rows' x, and a read of k + off outside [0, npad) is skipped
// instead of clamped, so nothing is read out of bounds.  Each row's sum runs
// over the diagonals in their stored (ascending offset) order in one thread:
// no atomics, and the result is bitwise reproducible from run to run.  nvcc
// contracts a * b + c to FMA, so results may differ from an unfused plain
// version in the last bits.

#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T>
__global__ void psdia_spmv(const T* __restrict__ pattern,
                           const int* __restrict__ offsets, int ndiags,
                           int64_t rb, const T* __restrict__ xpad,
                           T* __restrict__ ypad, int64_t npad, int64_t L,
                           int64_t nrow) {
  extern __shared__ int s_off[];
  for (int d = threadIdx.x; d < ndiags; d += blockDim.x) s_off[d] = offsets[d];
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < npad; k += stride) {
    T acc = T(0);
    if (k >= L && k < L + nrow) {
      const int64_t slot = k % rb;
      for (int d = 0; d < ndiags; ++d) {
        const int64_t j = k + s_off[d];
        if (j >= 0 && j < npad) acc += pattern[d * rb + slot] * xpad[j];
      }
    }
    ypad[k] = acc;
  }
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

template <typename T>
int launch_psdia(const void* pattern, const void* offsets, int ndiags,
                 int64_t rb, const void* xpad, void* ypad, int64_t npad,
                 int64_t L, int64_t nrow, void* stream) {
  psdia_spmv<T><<<grid_for(npad), kThreads, ndiags * sizeof(int),
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pattern), static_cast<const int*>(offsets),
      ndiags, rb, static_cast<const T*>(xpad), static_cast<T*>(ypad), npad, L,
      nrow);
  return static_cast<int>(cudaGetLastError());
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

int tsp_psdia_spmv_f32(const void* pattern, const void* offsets, int ndiags,
                       int64_t rb, const void* xpad, void* ypad, int64_t npad,
                       int64_t L, int64_t nrow, void* stream) {
  return launch_psdia<float>(pattern, offsets, ndiags, rb, xpad, ypad, npad, L,
                             nrow, stream);
}

int tsp_psdia_spmv_f64(const void* pattern, const void* offsets, int ndiags,
                       int64_t rb, const void* xpad, void* ypad, int64_t npad,
                       int64_t L, int64_t nrow, void* stream) {
  return launch_psdia<double>(pattern, offsets, ndiags, rb, xpad, ypad, npad,
                              L, nrow, stream);
}

const char* tsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
