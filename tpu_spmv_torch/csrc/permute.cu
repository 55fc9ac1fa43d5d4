// Permutation gather kernels for Hopper (sm_90a): the direct gather
// permute_gather, the planned two-pass gather (permute_pass1 and
// permute_pass2, launched together) and the batched form
// permute_gather_batched.
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
// Clos network and the kernels apply the routing planes in stages.  Here
// the plan (kernels/permute.py:plan_permutation) picks one of two forms
// for K7a-K7c, and permute_gather_batched covers K7d-K7e:
//
//   out[i]        = perm[i] >= 0 ? x[perm[i]] : 0
//   out[q * n + i] = perm[i] >= 0 ? x[q * n + perm[i]] : 0,  q < nrhs
//
// A negative perm[i] marks a don't-care slot (the reference leaves garbage
// there); the port writes zero.  The kernels move words and do no
// arithmetic: the value type is reduced to an unsigned word of its size (1,
// 2, 4 or 8 bytes), so the result is bitwise x[perm] for any dtype.
//
// What bounds them on this card (an NVIDIA H100 80GB HBM3 at 700 W;
// bench/variant_ab.py --suite gather, PERF.md): not the bytes alone.  One
// thread a slot gathered 4,194,304 f32 values in 0.0278 ms on the identity
// perm (54% of the byte bound: the index, x and out once each) and in
// 0.0394 ms on a random or an RCM perm.  With four slots a thread the
// identity takes 0.0117 ms replayed (x stays in the 50 MB L2 between
// calls) and a random perm still 0.0377: each scattered 4-byte read is a
// 32-byte L2 sector request, about 160 G requests/s (120 G/s in f64).
// Neighbouring slots that read within about 1024 words of each other cost
// no more than the identity's (a shuffle inside windows of 1024 slots:
// 0.0124 ms; of 4096: 0.0202; of 16384: 0.0318).  What the designs do:
//
// - permute_gather, the direct gather: 4 consecutive slots a thread, their
//   perm entries read with one 16-byte streaming load (__ldcs), the 4
//   gathers (__ldg) issued before the first store, the 4 words stored
//   together (__stcs).  The plan takes it below 2^21 slots, where fewer
//   than 90% of neighbouring slots read more than 1024 words apart, and
//   where the two-pass plan's bucket table would be too large; every
//   8-byte word takes it.
// - the two-pass gather, for scattered perms of 1-, 2- and 4-byte words
//   (tsp_permute_two_pass; tsp_permute_pass1 and tsp_permute_pass2 launch
//   one pass alone, to time it): the plan cuts source and
//   destination into chunks of C = 2^chunk_log2 words and orders the pairs
//   (src = perm[i], dst = i) stably by (source chunk, destination chunk);
//   per pair it keeps the source and destination offsets inside their
//   chunks (uint16), and the start of every (source chunk, destination
//   chunk) bucket in that order (int32, K*K + 1 entries, K chunks).  Pass 1
//   (one block per source chunk b) reads x's chunk into shared memory with
//   16-byte loads and writes its pairs to the stage buffer in plan order
//   (consecutive threads on consecutive stage slots, reading shared memory
//   at the planned source offsets).  Pass 2 (one block per destination
//   chunk k) zeroes its chunk in shared memory (the don't-care slots and
//   the slots no pair writes), copies its K buckets (b, k) -- runs of about
//   C / K words, whole sectors -- to their planned destination offsets,
//   and stores the chunk with 16-byte streaming stores.  No read of device
//   memory is scattered; the stage (one word per pair) is written with
//   plain stores so that it stays in L2 between the passes.  Entries may
//   repeat: a source word is read by as many pairs as name it, and every
//   destination slot has one pair at most, so every slot has one writer.
//   On a random perm of 4,194,304 f32 values, replayed with x in L2
//   between calls: pass 1 0.0103 ms, pass 2 0.0194 (every block reads,
//   then every block stores), both 0.0338 against the direct gather's
//   0.0378; on rotated inputs, from device memory (chip_smoke.py): pass 1
//   0.0187, pass 2 0.0239, both 0.0380 against 0.0454.  In f64 the
//   two were level (0.0659 and 0.0658), so 8-byte words are not staged.
// - permute_gather_batched: one row per grid row (blockIdx.y), so the row
//   being gathered stays in L2 (a thread looping over all rows would
//   scatter its reads over the whole [nrhs, n] block, 537 MB at 32 x 4M
//   f32, one DRAM sector per value); the index vector is then read once per
//   row, from L2 where it fits.
// No atomics and no reduction: each output has one writer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = int64_t(1) << 20;
// gridDim.y limit
constexpr int kMaxRows = 65535;
// the direct gather: consecutive slots a thread
constexpr int kGroup = 4;
// the two passes: threads a block, rows of a stage run a thread has in
// flight
constexpr int kPassThreads = 512;
constexpr int kPassUnroll = 8;
// the most chunks a two-pass plan may have (pass 2 keeps two ints a
// chunk in shared memory); the plan's MAX_CHUNKS
constexpr int kMaxChunks = 4096;
constexpr int kMaxDevices = 64;
constexpr int kSmemDefault = 48 * 1024;

inline int grid_for(int64_t n, int64_t per_block) {
  int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

// the native types of the cache-hinted load and store intrinsics
template <typename T> struct Native { using type = T; };
template <> struct Native<int64_t> { using type = long long; };
template <> struct Native<uint64_t> { using type = unsigned long long; };

template <typename T>
__device__ __forceinline__ T ldcs(const T* p) {
  using N = typename Native<T>::type;
  return static_cast<T>(__ldcs(reinterpret_cast<const N*>(p)));
}

template <typename T>
__device__ __forceinline__ T ldg(const T* p) {
  using N = typename Native<T>::type;
  return static_cast<T>(__ldg(reinterpret_cast<const N*>(p)));
}

template <typename T>
__device__ __forceinline__ void stcs(T* p, T v) {
  using N = typename Native<T>::type;
  __stcs(reinterpret_cast<N*>(p), static_cast<N>(v));
}

// BYTES (4, 8, 16 or 32) moved with one or two streaming accesses
template <int BYTES>
__device__ __forceinline__ void load_cs(void* dst, const void* src) {
  if constexpr (BYTES == 4) {
    *static_cast<unsigned*>(dst) = __ldcs(static_cast<const unsigned*>(src));
  } else if constexpr (BYTES == 8) {
    *static_cast<uint2*>(dst) = __ldcs(static_cast<const uint2*>(src));
  } else {
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k)
      static_cast<uint4*>(dst)[k] = __ldcs(static_cast<const uint4*>(src) + k);
  }
}

template <int BYTES>
__device__ __forceinline__ void store_cs(void* dst, const void* src) {
  if constexpr (BYTES == 4) {
    __stcs(static_cast<unsigned*>(dst), *static_cast<const unsigned*>(src));
  } else if constexpr (BYTES == 8) {
    __stcs(static_cast<uint2*>(dst), *static_cast<const uint2*>(src));
  } else {
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k)
      __stcs(static_cast<uint4*>(dst) + k, static_cast<const uint4*>(src)[k]);
  }
}

template <typename T>
struct alignas(sizeof(T) * kGroup) Group {
  T v[kGroup];
};

// the direct gather: thread t of the grid takes the groups of kGroup
// consecutive slots g = t, t + threads, ...; a whole group moves its perm
// entries and its outputs as one access each, and its kGroup gathers are
// issued before its first store
template <typename W, typename I>
__global__ void __launch_bounds__(kThreads)
    permute_gather(const W* __restrict__ x, const I* __restrict__ perm,
                   W* __restrict__ out, int64_t n) {
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t ngroups = (n + kGroup - 1) / kGroup;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       g < ngroups; g += threads) {
    const int64_t i = g * kGroup;
    const bool whole = i + kGroup <= n;
    Group<I> p;
    if (whole) {
      load_cs<sizeof(Group<I>)>(&p, perm + i);
    } else {
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        p.v[k] = i + k < n ? ldcs(perm + i + k) : I(-1);
    }
    Group<W> v;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int64_t src = static_cast<int64_t>(p.v[k]);
      v.v[k] = src >= 0 ? ldg(x + src) : W(0);
    }
    if (whole) {
      store_cs<sizeof(Group<W>)>(out + i, &v);
    } else {
      for (int k = 0; k < kGroup && i + k < n; ++k) stcs(out + i + k, v.v[k]);
    }
  }
}

// words [0, len) of one chunk between device and shared memory, 16 bytes
// at a time where the device address allows it (the chunk's shared copy
// is 16-byte aligned and C words are a multiple of 16 bytes)
template <typename W>
__device__ __forceinline__ void chunk_in(W* s, const W* __restrict__ x,
                                         int len) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    constexpr int kPer = 16 / sizeof(W);
    const int nvec = len / kPer;
    const uint4* src = reinterpret_cast<const uint4*>(x);
    uint4* dst = reinterpret_cast<uint4*>(s);
    for (int v = threadIdx.x; v < nvec; v += kPassThreads * 4) {
      uint4 r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (v + u * kPassThreads < nvec)
          r[u] = __ldg(src + v + u * kPassThreads);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (v + u * kPassThreads < nvec) dst[v + u * kPassThreads] = r[u];
    }
    done = nvec * kPer;
  }
  for (int i = done + threadIdx.x; i < len; i += kPassThreads)
    s[i] = ldg(x + i);
}

template <typename W>
__device__ __forceinline__ void chunk_out(W* __restrict__ out, const W* s,
                                          int len) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    constexpr int kPer = 16 / sizeof(W);
    const int nvec = len / kPer;
    const uint4* src = reinterpret_cast<const uint4*>(s);
    uint4* dst = reinterpret_cast<uint4*>(out);
    for (int v = threadIdx.x; v < nvec; v += kPassThreads)
      __stcs(dst + v, src[v]);
    done = nvec * kPer;
  }
  for (int i = done + threadIdx.x; i < len; i += kPassThreads)
    stcs(out + i, s[i]);
}

// pass 1: block b stages x's chunk b and writes the pairs whose source lies
// in it, [bucket_ptr[b K], bucket_ptr[(b + 1) K]), to the stage in order,
// kPassUnroll offsets loaded before their words are written
template <typename W>
__global__ void __launch_bounds__(kPassThreads)
    permute_pass1(const W* __restrict__ x,
                  const uint16_t* __restrict__ src_off,
                  const int* __restrict__ bucket_ptr, W* __restrict__ stage,
                  int64_t n, int chunk_log2) {
  extern __shared__ uint4 smem[];
  W* chunk = reinterpret_cast<W*>(smem);
  const int64_t nchunks = ((n - 1) >> chunk_log2) + 1;
  const int64_t b = blockIdx.x;
  const int64_t first = b << chunk_log2;
  const int64_t rest = n - first;
  const int len = static_cast<int>(rest < (int64_t(1) << chunk_log2)
                                       ? rest : (int64_t(1) << chunk_log2));
  chunk_in(chunk, x + first, len);
  __syncthreads();
  const int begin = bucket_ptr[b * nchunks];
  const int end = bucket_ptr[(b + 1) * nchunks];
  for (int j0 = begin + threadIdx.x; j0 < end;
       j0 += kPassThreads * kPassUnroll) {
    uint16_t o[kPassUnroll];
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      const int j = j0 + u * kPassThreads;
      o[u] = j < end ? ldcs(src_off + j) : uint16_t(0);
    }
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      const int j = j0 + u * kPassThreads;
      if (j < end) stage[j] = chunk[o[u]];
    }
  }
}

// exclusive prefix sums in place: size[1 .. k] holds the k bucket sizes on
// entry and pre[i] = size[0] + ... + size[i - 1] on exit (pre[0] = 0); each
// thread sums a run of entries, the runs' sums are scanned by warps and
// across the warps (warp_sums: kPassThreads / 32 ints)
__device__ __forceinline__ void scan_sizes(int* pre, int k, int* warp_sums) {
  constexpr int kWarps = kPassThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (k + kPassThreads - 1) / kPassThreads;
  const int lo = 1 + threadIdx.x * per;
  const int hi = lo + per < k + 1 ? lo + per : k + 1;
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += pre[i];
  int inc = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  int run = inc - sum + (warp ? warp_sums[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    run += pre[i];
    pre[i] = run;
  }
  if (threadIdx.x == 0) pre[0] = 0;
}

// pass 2: block k zeroes its chunk, copies the pairs of its buckets (b, k),
// b = 0 .. K - 1, to their planned offsets, and stores the chunk.  The
// buckets' sizes vary (a local perm fills one bucket a chunk), so the
// block copies their concatenation evenly: warp w takes an equal share of
// it, each lane walks its position's bucket forward in the prefix sums, and
// kPassUnroll words are in flight a lane.  Shared memory: the chunk (C
// words), then the prefix sums (K + 1 ints), the buckets' starts in the
// stage (K ints) and the warps' sums.
template <typename W>
__global__ void __launch_bounds__(kPassThreads)
    permute_pass2(const W* __restrict__ stage,
                  const uint16_t* __restrict__ dst_off,
                  const int* __restrict__ bucket_ptr, W* __restrict__ out,
                  int64_t n, int chunk_log2) {
  constexpr int kWarps = kPassThreads / 32;
  extern __shared__ uint4 smem[];
  W* chunk = reinterpret_cast<W*>(smem);
  const int nchunks = static_cast<int>(((n - 1) >> chunk_log2) + 1);
  int* pre = reinterpret_cast<int*>(chunk + (int64_t(1) << chunk_log2));
  int* start = pre + nchunks + 1;
  int* warp_sums = start + nchunks;
  const int64_t k = blockIdx.x;
  const int64_t first = k << chunk_log2;
  const int64_t rest = n - first;
  const int len = static_cast<int>(rest < (int64_t(1) << chunk_log2)
                                       ? rest : (int64_t(1) << chunk_log2));
  for (int b = threadIdx.x; b < nchunks; b += kPassThreads) {
    const int64_t at = static_cast<int64_t>(b) * nchunks + k;
    const int s = bucket_ptr[at];
    start[b] = s;
    pre[b + 1] = bucket_ptr[at + 1] - s;
  }
  const int nvec = static_cast<int>(
      ((int64_t(1) << chunk_log2) * sizeof(W)) / 16);
  for (int v = threadIdx.x; v < nvec; v += kPassThreads)
    smem[v] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  scan_sizes(pre, nchunks, warp_sums);
  __syncthreads();
  const int total = pre[nchunks];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int share = (total + kWarps - 1) / kWarps;
  const int v0 = warp * share;
  const int v1 = v0 + share < total ? v0 + share : total;
  // the bucket of this lane's first position: the last b with
  // pre[b] <= v
  int bk = 0;
  if (v0 + lane < v1) {
    int lo = 0, hi = nchunks - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (pre[mid] <= v0 + lane) lo = mid; else hi = mid - 1;
    }
    bk = lo;
  }
  for (int v = v0 + lane; v < v1; v += 32 * kPassUnroll) {
    int j[kPassUnroll];
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u) {
      const int vv = v + 32 * u;
      if (vv < v1) {
        while (pre[bk + 1] <= vv) ++bk;
        j[u] = start[bk] + (vv - pre[bk]);
      }
    }
    uint16_t o[kPassUnroll];
    W w[kPassUnroll];
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u)
      if (v + 32 * u < v1) {
        o[u] = ldcs(dst_off + j[u]);
        w[u] = ldcs(stage + j[u]);
      }
#pragma unroll
    for (int u = 0; u < kPassUnroll; ++u)
      if (v + 32 * u < v1) chunk[o[u]] = w[u];
  }
  __syncthreads();
  chunk_out(out + first, chunk, len);
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
    const dim3 grid(grid_for(n, kThreads), nrhs < kMaxRows ? nrhs : kMaxRows);
    permute_gather_batched<W, I><<<grid, kThreads, 0, stream>>>(
        static_cast<const W*>(x), static_cast<const I*>(perm),
        static_cast<W*>(out), n, nrhs);
  } else {
    permute_gather<W, I>
        <<<grid_for(n, int64_t(kThreads) * kGroup), kThreads, 0,
           stream>>>(static_cast<const W*>(x), static_cast<const I*>(perm),
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

// the passes on one stream, pass 2 after pass 1 (passes: bit 0 pass 1,
// bit 1 pass 2); the chunk's shared memory (C words) above 48 KB needs
// each pass's limit raised, once per device
template <typename W>
int launch_passes(const void* x, const void* src_off, const void* dst_off,
                  const void* bucket_ptr, void* stage, void* out, int64_t n,
                  int chunk_log2, int passes, cudaStream_t stream) {
  const int64_t nchunks = ((n - 1) >> chunk_log2) + 1;
  const size_t smem = (size_t(1) << chunk_log2) * sizeof(W);
  const size_t smem2 =
      smem + (2 * static_cast<size_t>(nchunks) + 1 + kPassThreads / 32) * 4;
  if (smem2 > size_t(kSmemMax) || smem < 16 || nchunks > kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem2 > size_t(kSmemDefault)) {
    static bool configured[kMaxDevices] = {};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= kMaxDevices || !configured[device]) {
      err = cudaFuncSetAttribute(permute_pass1<W>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemMax);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(permute_pass2<W>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kSmemMax);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (device < kMaxDevices) configured[device] = true;
    }
  }
  const unsigned grid = static_cast<unsigned>(nchunks);
  if (passes & 1) {
    permute_pass1<W><<<grid, kPassThreads, smem, stream>>>(
        static_cast<const W*>(x), static_cast<const uint16_t*>(src_off),
        static_cast<const int*>(bucket_ptr), static_cast<W*>(stage), n,
        chunk_log2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (passes & 2)
    permute_pass2<W><<<grid, kPassThreads, smem2, stream>>>(
        static_cast<const W*>(stage), static_cast<const uint16_t*>(dst_off),
        static_cast<const int*>(bucket_ptr), static_cast<W*>(out), n,
        chunk_log2);
  return static_cast<int>(cudaGetLastError());
}

// words of 1, 2 or 4 bytes (8-byte words take the direct gather)
int dispatch_passes(const void* x, const void* src_off, const void* dst_off,
                    const void* bucket_ptr, void* stage, void* out, int64_t n,
                    int chunk_log2, int word_bytes, int passes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  switch (word_bytes) {
    case 1:
      return launch_passes<uint8_t>(x, src_off, dst_off, bucket_ptr, stage,
                                    out, n, chunk_log2, passes, s);
    case 2:
      return launch_passes<uint16_t>(x, src_off, dst_off, bucket_ptr, stage,
                                     out, n, chunk_log2, passes, s);
    case 4:
      return launch_passes<uint32_t>(x, src_off, dst_off, bucket_ptr, stage,
                                     out, n, chunk_log2, passes, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int tsp_permute_gather(const void* x, const void* perm, int index_bytes,
                       void* out, int64_t n, int word_bytes, void* stream) {
  return dispatch(x, perm, index_bytes, out, n, 1, word_bytes, false, stream);
}

// both passes of a two-pass plan
int tsp_permute_two_pass(const void* x, const void* src_off,
                         const void* dst_off, const void* bucket_ptr,
                         void* stage, void* out, int64_t n, int chunk_log2,
                         int word_bytes, void* stream) {
  return dispatch_passes(x, src_off, dst_off, bucket_ptr, stage, out, n,
                         chunk_log2, word_bytes, 3, stream);
}

// one pass alone, to time it: x -> stage, or stage -> out
int tsp_permute_pass1(const void* x, const void* src_off,
                      const void* bucket_ptr, void* stage, int64_t n,
                      int chunk_log2, int word_bytes, void* stream) {
  return dispatch_passes(x, src_off, nullptr, bucket_ptr, stage, nullptr, n,
                         chunk_log2, word_bytes, 1, stream);
}

int tsp_permute_pass2(const void* stage, const void* dst_off,
                      const void* bucket_ptr, void* out, int64_t n,
                      int chunk_log2, int word_bytes, void* stream) {
  return dispatch_passes(nullptr, nullptr, dst_off, bucket_ptr,
                         const_cast<void*>(stage), out, n, chunk_log2,
                         word_bytes, 2, stream);
}

int tsp_permute_gather_batched(const void* x, const void* perm,
                               int index_bytes, void* out, int64_t n,
                               int nrhs, int word_bytes, void* stream) {
  return dispatch(x, perm, index_bytes, out, n, nrhs, word_bytes, true,
                  stream);
}

}  // extern "C"
