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
// K8a (its first form ran K1's one-thread-a-row loop with every read
// picking its buffer with two compares): the reference's ring kernel is
// K1's body with the clipped neighbour slivers swapped in at the ring's
// ends (tpu_spmv/dist/planned.py:342-349), and here too only the rows near
// the ends read a sliver.  With off_min and off_max the least and the greatest
// offset, rows in [lo, hi), lo = min(cp, max(0, -off_min)) and hi = max(lo,
// cp - max(0, off_max)), read x alone (kernels/dist_stream.py:ring_interior
// computes them on the host).  The rows are dealt out in spans of 32 x R
// (R rows a thread); a warp whose span lies inside [lo, hi) runs the
// interior body, any other the edge body, so the branch is taken per warp
// and no warp diverges on it.  The interior body reads data[d * cp + k]
// and x[k + off_d] with no test: for kRingAhead diagonals at a time it
// issues every coefficient and x load before the first fma.  Where cp is a
// multiple of R and data and y are aligned to their runs, a thread owns R
// consecutive rows and loads each diagonal's R coefficients as one vector
// (and stores its R outputs as one); else it owns R rows 32 apart and every
// load is scalar and coalesced.  Plain loads and stores: the streaming
// hints on the coefficients and y (__ldcs, __stcs) measured no faster.
// The edge body is the same loop on
// rows 32 apart with every x read through window() (as the former kernel
// read it) and the rows past cp left out: its loads go ahead of their fmas
// too, so a warp on the edges is not the one the launch waits for.  One
// launch a shard, a grid of as many blocks as the card holds at once.
//
// Every row sums its diagonals in their stored (ascending offset) order,
// one fma a diagonal from zero, in one thread: no atomics, bitwise
// reproducible, bitwise the former kernel, and (a wrapped read times zero
// data adding exactly zero) bitwise equal to K1 on the same pack, which
// skips reads outside the padded row space instead.
//
// K8a on bf16 data (the reference's ring kernel on a shard of a
// pack_sdia(data_dtype=bfloat16) pack, whose output and sums take x's
// type): the same kernel with the data stored as __nv_bfloat16 against a
// float32 x and slivers, sdia_ring<float, __nv_bfloat16, R, VEC>; each
// coefficient widened exactly and fma'd in stored order from zero, K1
// bf16's arithmetic, so the sharded chain is bitwise K1 bf16 on the same
// pack.  Its interior loads kRingRowsBf16 coefficients of a diagonal as one
// 16-byte word where aligned.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

#include "psdia_walk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;

// K8a: rows a thread (by the type of x and of the stored coefficients)
// and diagonals whose loads go ahead of their fmas.  Each form stays at 64
// registers or fewer (four blocks an SM): more rows a thread cost
// occupancy and ran slower (bench/variant_ab.py --suite ring)
constexpr int kRingRowsF32 = 2;
constexpr int kRingRowsF64 = 1;
constexpr int kRingRowsBf16 = 2;
constexpr int kRingAhead = 8;

template <typename T, typename C>
constexpr int ring_rows() {
  return std::is_same_v<C, __nv_bfloat16> ? kRingRowsBf16
         : sizeof(T) == 8                 ? kRingRowsF64
                                          : kRingRowsF32;
}

// a stored coefficient in the type of the sums: bf16 widens exactly
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

// the raw word of B bytes that a run of values moves in
template <int B>
struct Word;
template <>
struct Word<2> {
  using type = unsigned short;
};
template <>
struct Word<4> {
  using type = unsigned int;
};
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<16> {
  using type = uint4;
};

// the widest word a run of N values moves in (at most 16 bytes); p must be
// aligned to it
template <int N, typename V>
__host__ __device__ constexpr int run_word() {
  return N * sizeof(V) < 16 ? N * sizeof(V) : 16;
}

// N consecutive values at p, in words of run_word<N, V>() bytes
template <int N, typename V>
__device__ __forceinline__ void load_run(V (&v)[N], const V* __restrict__ p) {
  constexpr int B = run_word<N, V>(), NW = N * sizeof(V) / B;
  using W = typename Word<B>::type;
  const W* q = reinterpret_cast<const W*>(p);
  W w[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = q[i];
  memcpy(v, w, sizeof(w));
}

template <int N, typename V>
__device__ __forceinline__ void store_run(V* __restrict__ p,
                                          const V (&v)[N]) {
  constexpr int B = run_word<N, V>(), NW = N * sizeof(V) / B;
  using W = typename Word<B>::type;
  W* q = reinterpret_cast<W*>(p);
  W w[NW];
  memcpy(w, v, sizeof(w));
#pragma unroll
  for (int i = 0; i < NW; ++i) q[i] = w[i];
}

template <typename T>
__device__ __forceinline__ T window(const T* __restrict__ x,
                                    const T* __restrict__ left,
                                    const T* __restrict__ right, int64_t j,
                                    int64_t cp, int64_t h) {
  return j < 0 ? left[h + j] : (j < cp ? x[j] : right[j - cp]);
}

// the R rows a lane owns in the span of a warp that starts at row k0: R
// consecutive rows from k0 + R * lane (VEC: the coefficients and y in runs
// of R), or rows k0 + lane + 32 i.  EDGE: rows that may read a sliver or
// lie past cp, each x read through window() and rows past cp neither read
// nor written; else every k + off_d lies in [0, cp).  Every coefficient
// and x load of kRingAhead diagonals goes before their fmas.
template <bool EDGE, bool VEC, int R, typename T, typename C>
__device__ __forceinline__ void ring_span(
    const C* __restrict__ data, const int* __restrict__ s_off, int ndiags,
    const T* __restrict__ x, const T* __restrict__ left,
    const T* __restrict__ right, T* __restrict__ y, int64_t cp, int64_t h,
    int64_t k0, int lane) {
  static_assert(!(EDGE && VEC), "edge rows are 32 apart");
  const int64_t k = VEC ? k0 + lane * R : k0 + lane;
  constexpr int64_t step = VEC ? 1 : kWarp;
  T acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = T(0);
  for (int d0 = 0; d0 < ndiags; d0 += kRingAhead) {
    C c[kRingAhead][R];
    T xv[kRingAhead][R];
#pragma unroll
    for (int a = 0; a < kRingAhead; ++a) {
      if (d0 + a < ndiags) {
        const int64_t off = s_off[d0 + a];
        const C* dp = data + static_cast<int64_t>(d0 + a) * cp + k;
        if constexpr (VEC) load_run<R>(c[a], dp);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int64_t ki = k + i * step;
          if (EDGE && ki >= cp) continue;
          if constexpr (!VEC) {
            C one[1];
            load_run<1>(one, dp + i * step);
            c[a][i] = one[0];
          }
          xv[a][i] = EDGE ? window(x, left, right, ki + off, cp, h)
                          : x[ki + off];
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kRingAhead; ++a) {
      if (d0 + a < ndiags) {
#pragma unroll
        for (int i = 0; i < R; ++i)
          if (!EDGE || k + i * step < cp)
            acc[i] = fma(widen(c[a][i]), xv[a][i], acc[i]);
      }
    }
  }
  if constexpr (VEC) {
    store_run<R>(y + k, acc);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const T one[1] = {acc[i]};
      if (!EDGE || k + i * step < cp)
        store_run<1>(y + k + i * step, one);
    }
  }
}

// K8a.  T: the type of x, the slivers, y and the sums; C: the stored
// coefficients' (T, or __nv_bfloat16 against a float T); R rows a thread;
// VEC: the interior's rows consecutive a thread, its runs aligned
template <typename T, typename C, int R, bool VEC>
__global__ void __launch_bounds__(kThreads)
    sdia_ring(const C* __restrict__ data, const int* __restrict__ offsets,
              int ndiags, const T* __restrict__ x,
              const T* __restrict__ left, const T* __restrict__ right,
              T* __restrict__ y, int64_t cp, int64_t h, int64_t lo,
              int64_t hi) {
  extern __shared__ int s_off[];
  for (int d = threadIdx.x; d < ndiags; d += blockDim.x) s_off[d] = offsets[d];
  __syncthreads();
  constexpr int64_t kSpan = kWarp * R;
  constexpr int kWarps = kThreads / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t nspans = (cp + kSpan - 1) / kSpan;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps +
                   threadIdx.x / kWarp;
       s < nspans; s += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int64_t k0 = s * kSpan;
    // the branch is the warp's: its span is interior or not
    if (k0 >= lo && k0 + kSpan <= hi)
      ring_span<false, VEC, R>(data, s_off, ndiags, x, left, right, y, cp, h,
                               k0, lane);
    else
      ring_span<true, false, R>(data, s_off, ndiags, x, left, right, y, cp,
                                h, k0, lane);
  }
}

template <typename T, typename C, int R, bool VEC>
int launch_ring(const C* data, const int* offsets, int ndiags, const T* x,
                const T* left, const T* right, T* y, int64_t cp, int64_t h,
                int64_t lo, int64_t hi, cudaStream_t stream) {
  const auto kernel = sdia_ring<T, C, R, VEC>;
  const int smem = ndiags * static_cast<int>(sizeof(int));
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  const int64_t spans = (cp + kWarp * R - 1) / (kWarp * R);
  int64_t blocks = (spans + kThreads / kWarp - 1) / (kThreads / kWarp);
  const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<int>(blocks), kThreads, smem, stream>>>(
      data, offsets, ndiags, x, left, right, y, cp, h, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// the rows' layout per launch: consecutive rows a thread where cp is a
// multiple of R and data and y are aligned to their runs, else rows 32
// apart (ShardedDIA's chunks may be odd)
template <typename T, typename C = T>
int launch_sdia_ring(const void* data, const void* offsets, int ndiags,
                     const void* x, const void* left, const void* right,
                     void* y, int64_t cp, int64_t h, int64_t lo, int64_t hi,
                     void* stream) {
  constexpr int R = ring_rows<T, C>();
  const auto* d = static_cast<const C*>(data);
  auto* out = static_cast<T*>(y);
  const bool vec = R > 1 && cp % R == 0 &&
                   aligned(d, run_word<R, C>()) &&
                   aligned(out, run_word<R, T>());
  const auto* o = static_cast<const int*>(offsets);
  const auto* xs = static_cast<const T*>(x);
  const auto* l = static_cast<const T*>(left);
  const auto* r = static_cast<const T*>(right);
  const auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch_ring<T, C, R, true>(d, o, ndiags, xs, l, r, out, cp, h,
                                          lo, hi, s)
             : launch_ring<T, C, R, false>(d, o, ndiags, xs, l, r, out, cp, h,
                                           lo, hi, s);
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
                      void* y, int64_t cp, int64_t h, int64_t lo,
                      int64_t hi, void* stream) {
  return launch_sdia_ring<float>(data, offsets, ndiags, x, left, right, y, cp,
                                 h, lo, hi, stream);
}

int tsp_sdia_ring_f64(const void* data, const void* offsets, int ndiags,
                      const void* x, const void* left, const void* right,
                      void* y, int64_t cp, int64_t h, int64_t lo,
                      int64_t hi, void* stream) {
  return launch_sdia_ring<double>(data, offsets, ndiags, x, left, right, y,
                                  cp, h, lo, hi, stream);
}

// K8a on bf16 data: bf16 coefficients, float32 x, slivers, y and sums
int tsp_sdia_ring_bf16f32(const void* data, const void* offsets, int ndiags,
                          const void* x, const void* left, const void* right,
                          void* y, int64_t cp, int64_t h, int64_t lo,
                          int64_t hi, void* stream) {
  return launch_sdia_ring<float, __nv_bfloat16>(
      data, offsets, ndiags, x, left, right, y, cp, h, lo, hi, stream);
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
