// Permutation gather kernels for Hopper (sm_90a): permute_gather and its
// batched form permute_gather_batched.
//
// Replaces the permutation engine of the JAX reference package,
// tpu_spmv/kernels/permute.py:
//   K7a _tile_perm_kernel        (apply_tile_permutation, one [128,128] tile)
//   K7b _stage1_kernel           (apply_permutation, stage 1)
//   K7c _stage23_kernel          (apply_stage23_flat, stages 2-3)
//   K7d _stage1_batched_kernel   (apply_permutation_batched, stage 1)
//   K7e _stage23_batched_kernel  (apply_stage23_flat_batched, stages 2-3)
// All five compute one function, out[i] = x[perm[i]] (K7d/K7e on every row
// of a [nrhs, n] block with one perm).  On a TPU the fast gather works only
// inside 128 lanes, so an arbitrary permutation is routed on the host as a
// Clos network (three lane gathers, two transposes, a row exchange) and the
// kernels apply the routing planes.  A Hopper thread reads any address, so
// the whole network is one gather: permute_gather covers K7a-K7c,
// permute_gather_batched covers K7d-K7e, and the routing is not ported.
//
//   permute_gather:          out[i]        = perm[i] >= 0 ? x[perm[i]] : 0
//   permute_gather_batched:  out[q * n + i] = perm[i] >= 0 ? x[q * n + perm[i]]
//                                                        : 0,  q < nrhs
//
// A negative perm[i] marks a don't-care slot (the reference leaves garbage
// there); the port writes zero.  The kernels move words and do no
// arithmetic: the value type is reduced to an unsigned word of its size (1,
// 2, 4 or 8 bytes), so the result is bitwise x[perm] for any dtype.  The
// index type is int32 (n < 2^31) or int64.
//
// What bounds them on this card: device-memory bytes.  One gather reads the
// index vector once (4 B per slot), writes out once and reads x; the batched
// form needs the index once for all nrhs rows.  x of a 4M-entry f32 vector
// (16.8 MB) stays in the 50 MB L2, so scattered reads cost L2 sectors, not
// extra DRAM traffic; a structured perm (RCM of a band) reads x nearly in
// order.  What the design does about it: one thread per output slot,
// neighbouring threads on neighbouring slots, so the index loads and the
// stores are coalesced.  The batched form takes one row per grid row
// (blockIdx.y), so the row being gathered stays in L2 (a thread looping
// over all rows would scatter its reads over the whole [nrhs, n] block,
// 537 MB at 32 x 4M f32, one DRAM sector per value); the index vector is
// then read once per row, from L2 where it fits.  No atomics and no
// reduction: each output has one writer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = int64_t(1) << 20;
// gridDim.y limit
constexpr int kMaxRows = 65535;

inline int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

template <typename W, typename I>
__global__ void permute_gather(const W* __restrict__ x,
                               const I* __restrict__ perm, W* __restrict__ out,
                               int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int64_t p = static_cast<int64_t>(perm[i]);
    out[i] = p >= 0 ? x[p] : W(0);
  }
}

// blockIdx.y walks the rows; blocks are dispatched x-major, so the blocks
// in flight gather from one row at a time and that row (16.8 MB for 4M
// f32 values) is served from L2 instead of a random DRAM sector per value
template <typename W, typename I>
__global__ void permute_gather_batched(const W* __restrict__ x,
                                       const I* __restrict__ perm,
                                       W* __restrict__ out, int64_t n,
                                       int nrhs) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int q = blockIdx.y; q < nrhs; q += gridDim.y) {
    const W* __restrict__ xq = x + static_cast<int64_t>(q) * n;
    W* __restrict__ oq = out + static_cast<int64_t>(q) * n;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
         i < n; i += stride) {
      const int64_t p = static_cast<int64_t>(perm[i]);
      oq[i] = p >= 0 ? xq[p] : W(0);
    }
  }
}

template <typename W, typename I>
int launch(const void* x, const void* perm, void* out, int64_t n, int nrhs,
           bool batched, cudaStream_t stream) {
  if (batched) {
    const dim3 grid(grid_for(n), nrhs < kMaxRows ? nrhs : kMaxRows);
    permute_gather_batched<W, I><<<grid, kThreads, 0, stream>>>(
        static_cast<const W*>(x), static_cast<const I*>(perm),
        static_cast<W*>(out), n, nrhs);
  } else {
    permute_gather<W, I><<<grid_for(n), kThreads, 0, stream>>>(
        static_cast<const W*>(x), static_cast<const I*>(perm),
        static_cast<W*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename I>
int launch_word(const void* x, const void* perm, void* out, int64_t n,
                int nrhs, int word_bytes, bool batched, cudaStream_t stream) {
  switch (word_bytes) {
    case 1: return launch<uint8_t, I>(x, perm, out, n, nrhs, batched, stream);
    case 2: return launch<uint16_t, I>(x, perm, out, n, nrhs, batched, stream);
    case 4: return launch<uint32_t, I>(x, perm, out, n, nrhs, batched, stream);
    case 8: return launch<uint64_t, I>(x, perm, out, n, nrhs, batched, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(const void* x, const void* perm, int index_bytes, void* out,
             int64_t n, int nrhs, int word_bytes, bool batched,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0 || nrhs == 0) return 0;
  if (index_bytes == 4)
    return launch_word<int32_t>(x, perm, out, n, nrhs, word_bytes, batched, s);
  if (index_bytes == 8)
    return launch_word<int64_t>(x, perm, out, n, nrhs, word_bytes, batched, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int tsp_permute_gather(const void* x, const void* perm, int index_bytes,
                       void* out, int64_t n, int word_bytes, void* stream) {
  return dispatch(x, perm, index_bytes, out, n, 1, word_bytes, false, stream);
}

int tsp_permute_gather_batched(const void* x, const void* perm,
                               int index_bytes, void* out, int64_t n,
                               int nrhs, int word_bytes, void* stream) {
  return dispatch(x, perm, index_bytes, out, n, nrhs, word_bytes, true,
                  stream);
}

}  // extern "C"
