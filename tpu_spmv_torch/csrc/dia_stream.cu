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
//
// K3a/K3b keep the reference's transposed multi-RHS layout: Xt and Yt are
// [nrhs, npad], RHS q of padded row k at q * npad + k, and
//     Yt[q, k] = sum_d coef(d, k) * Xt[q, k + off_d].
// The bytes they must move are the coefficients once plus nrhs x and y
// rows, so the coefficient read that bounds K1 is shared by the RHS.  One
// thread still owns one padded row, now for a chunk of QC <= 32 RHS
// (blockIdx.y picks the chunk; the last chunk of an nrhs that QC does not
// divide leaves its upper accumulators unused): per diagonal it loads the
// coefficient once and does one FMA per RHS, the QC accumulators stay in
// registers (the loops over q are unrolled), and each Xt load is coalesced
// across the warp.  The order of the diagonals is K1's, so each RHS sums in
// K1's order.

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

template <typename T, int QC>
__global__ void psdia_spmm(const T* __restrict__ pattern,
                           const int* __restrict__ offsets, int ndiags,
                           int64_t rb, const T* __restrict__ xt,
                           T* __restrict__ yt, int64_t npad, int64_t L,
                           int64_t nrow, int nrhs) {
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
    if (k >= L && k < L + nrow) {
      const int64_t slot = k % rb;
      for (int d = 0; d < ndiags; ++d) {
        const int64_t j = k + s_off[d];
        if (j >= 0 && j < npad) {
          const T c = pattern[d * rb + slot];
#pragma unroll
          for (int q = 0; q < QC; ++q)
            if (q < nq) acc[q] += c * x[q * npad + j];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < QC; ++q)
      if (q < nq) y[q * npad + k] = acc[q];
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

template <typename T, int QC>
struct PsdiaSpmm {
  static int run(int nrhs, const void* pattern, const void* offsets,
                 int ndiags, int64_t rb, const void* xt, void* yt,
                 int64_t npad, int64_t L, int64_t nrow, void* stream) {
    const dim3 grid(grid_for(npad), (nrhs + QC - 1) / QC);
    psdia_spmm<T, QC><<<grid, kThreads, ndiags * sizeof(int),
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(pattern), static_cast<const int*>(offsets),
        ndiags, rb, static_cast<const T*>(xt), static_cast<T*>(yt), npad, L,
        nrow, nrhs);
    return static_cast<int>(cudaGetLastError());
  }
};

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

int tsp_psdia_spmm_f32(const void* pattern, const void* offsets, int ndiags,
                       int64_t rb, const void* xt, void* yt, int64_t npad,
                       int64_t L, int64_t nrow, int nrhs, void* stream) {
  return by_chunk<float, PsdiaSpmm>(nrhs, pattern, offsets, ndiags, rb, xt,
                                    yt, npad, L, nrow, stream);
}

int tsp_psdia_spmm_f64(const void* pattern, const void* offsets, int ndiags,
                       int64_t rb, const void* xt, void* yt, int64_t npad,
                       int64_t L, int64_t nrow, int nrhs, void* stream) {
  return by_chunk<double, PsdiaSpmm>(nrhs, pattern, offsets, ndiags, rb, xt,
                                     yt, npad, L, nrow, stream);
}

const char* tsp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
