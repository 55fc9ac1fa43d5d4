// Permutation gather kernels for Hopper (sm_90a): the direct gather
// permute_gather, the planned two-pass gather (permute_pass1 and
// permute_pass2, launched together), and their batched forms on the rows
// of a [nrhs, n] block, permute_gather_batched (direct) and
// permute_rows_two_pass (both passes in one persistent launch).
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
// the plan (kernels/permute.py:plan_permutation) picks one of two forms,
// for one vector (K7a-K7c) and for the rows of a block (K7d/K7e) alike:
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
// - permute_rows_two_pass, the two-pass form on the rows of a block (the
//   same plan): a group of R rows (4 bytes of every slot: one row of
//   4-byte words, two of 2-byte, four of 1-byte) is an item of each pass
//   for every chunk, and a block holds the group's R chunks in shared
//   memory, so each offset it loads serves R rows.  One launch runs both
//   passes of every group: persistent blocks take items by ticket from one
//   counter, in an order that puts pass 2 of a group's chunk `lag` items
//   after pass 1 of the same chunk, so that pass 1 of the next group runs
//   beside pass 2 of this one and no boundary between passes idles the
//   card.  A pass-2 item waits until its group's K pass-1 items have
//   counted themselves done.  That wait is on items with earlier tickets,
//   and a ticket is taken only by a running block, so no wait can
//   deadlock whatever the grid; the grid is what the card holds at once
//   (two blocks an SM, a register cap).  The counters order items and sum
//   nothing.  The lag is K plus half the grid (at most K more).  Every row
//   has its own stage row (stride a multiple of 32 words), written once in
//   the launch, so pass 2's loads through L1 never meet a line cached
//   before it was written.  Its pass bodies are not the single gather's:
//   with those (and per-group stage buffers reused four times) 32 rows of
//   4,194,304 f32 values took 1.25 ms, pass 1's items 0.50 and pass 2's
//   0.82 of it, both moving x, the stage and the offsets from device
//   memory (bench/variant_ab.py --suite batched-quick, p1only / p2only).
//   rows_pass1 copies the chunks by 16-byte cp.async while its threads
//   load their offsets in runs of eight (one 16-byte load each) and stores
//   the stage eight words at a time; rows_pass2 copies 4-byte stage words
//   straight into shared memory by 4-byte cp.async, 8 a lane in flight;
//   both load the offsets, which every group reads again, under an L2
//   evict-last policy.  0.98 ms (evict-last alone: 1.03 without it); the
//   same bodies made the single gather slower (0.0337 -> 0.0456 ms
//   replayed), so it keeps its own.  Waits, the lag, register caps of one
//   or three blocks an SM, more loads in flight (they spill) and x's
//   copies under an evict-first policy gained nothing.
// - permute_gather_batched, the direct form on rows: a thread takes four
//   consecutive slots (one 16-byte streaming load of their perm entries)
//   on RB rows, issues the rows' 4 RB gathers before its first store, and
//   stores each row's four words together.  blockIdx.y walks groups of
//   RB rows and blocks are dispatched x-major, so the blocks in flight
//   gather from those rows only; the perm is read once per group.  RB (1,
//   2 or 4) is the wrapper's: as many rows as keep their bytes in a share
//   of the L2, since a scattered perm reads all of each row in flight.
//   With four rows of 4,194,304 f32 values (67 MB) in flight, a scattered
//   perm's reads missed the L2 and took 2.89 ms for 32 rows against one
//   row a group's 1.32; on the natural 1M band's local perm four rows a
//   group took 0.104-0.107 ms against 0.178-0.183 for one slot a thread.
// No atomics in the data path: each output has one writer.

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
// dynamic shared memory the persistent two-pass kernel may ask for (its
// static shared memory holds the ticket)
constexpr int kSmemRows = kSmemMax - 1024;
// the persistent two-pass kernel's blocks an SM (a register cap: both
// pass bodies inlined take 112 registers a thread uncapped, one block an
// SM)
constexpr int kRowsBlocksPerSM = 2;

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
__device__ __forceinline__ T ldcg(const T* p) {
  using N = typename Native<T>::type;
  return static_cast<T>(__ldcg(reinterpret_cast<const N*>(p)));
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

// an L2 policy under which the lines a load brings in are the last to be
// evicted: for data every row reads again
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

// offsets (16 or 2 bytes) through the read-only path under an L2 policy
__device__ __forceinline__ uint4 ld_hint(const uint4* p, uint64_t pol) {
  uint4 r;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p), "l"(pol));
  return r;
}

__device__ __forceinline__ uint16_t ld_hint(const uint16_t* p,
                                            uint64_t pol) {
  unsigned short r;
  asm("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;"
      : "=h"(r) : "l"(p), "l"(pol));
  return r;
}

template <typename T>
__device__ __forceinline__ void stcg(T* p, T v) {
  using N = typename Native<T>::type;
  __stcg(reinterpret_cast<N*>(p), static_cast<N>(v));
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

// the perm entries of the group of kGroup slots at i (-1 past n): one
// streaming access for a whole group
template <typename I>
__device__ __forceinline__ Group<I> perm_group(const I* __restrict__ perm,
                                               int64_t i, int64_t n) {
  Group<I> p;
  if (i + kGroup <= n) {
    load_cs<sizeof(Group<I>)>(&p, perm + i);
  } else {
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      p.v[k] = i + k < n ? ldcs(perm + i + k) : I(-1);
  }
  return p;
}

// the group's words at out[i ..], one streaming store where the group is
// whole and its address aligned to it
template <typename W>
__device__ __forceinline__ void store_group(W* out, const Group<W>& v,
                                            int64_t i, int64_t n) {
  W* o = out + i;
  if (i + kGroup <= n &&
      reinterpret_cast<uintptr_t>(o) % sizeof(Group<W>) == 0) {
    store_cs<sizeof(Group<W>)>(o, &v);
  } else {
    for (int k = 0; k < kGroup && i + k < n; ++k) stcs(o + k, v.v[k]);
  }
}

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
    const Group<I> p = perm_group(perm, i, n);
    Group<W> v;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int64_t src = static_cast<int64_t>(p.v[k]);
      v.v[k] = src >= 0 ? ldg(x + src) : W(0);
    }
    store_group(out, v, i, n);
  }
}

// the direct gather on rows: blockIdx.y walks groups of RB rows
// (gridDim.y at most kMaxRows, so any nrhs), and each group of four perm
// entries a thread loads serves the group's rows, all of whose gathers
// are issued before the first store
template <typename W, typename I, int RB>
__global__ void __launch_bounds__(kThreads)
    permute_gather_batched(const W* __restrict__ x, const I* __restrict__ perm,
                           W* __restrict__ out, int64_t n, int nrhs) {
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t ngroups = (n + kGroup - 1) / kGroup;
  for (int64_t q0 = static_cast<int64_t>(blockIdx.y) * RB; q0 < nrhs;
       q0 += static_cast<int64_t>(gridDim.y) * RB) {
    const int rows = static_cast<int>(
        nrhs - q0 < RB ? nrhs - q0 : RB);
    const W* __restrict__ xq = x + q0 * n;
    W* __restrict__ oq = out + q0 * n;
    for (int64_t g =
             static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
         g < ngroups; g += threads) {
      const int64_t i = g * kGroup;
      const Group<I> p = perm_group(perm, i, n);
      Group<W> v[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < rows) {
#pragma unroll
          for (int k = 0; k < kGroup; ++k) {
            const int64_t src = static_cast<int64_t>(p.v[k]);
            v[r].v[k] = src >= 0 ? ldg(xq + r * n + src) : W(0);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r < rows) store_group(oq + r * n, v[r], i, n);
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

// the same by 16-byte cp.async copies (.cg: not through L1) where the
// device address allows it, plain loads for the rest; the caller commits
// and waits.  (Under an L2 evict-first policy the copies gained nothing on
// the rows and were refused as an illegal instruction for 1-byte rows.)
template <typename W>
__device__ __forceinline__ void chunk_copy(W* s, const W* __restrict__ x,
                                           int len) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    constexpr int kPer = 16 / sizeof(W);
    const int nvec = len / kPer;
    for (int v = threadIdx.x; v < nvec; v += kPassThreads)
      cp_async<16>(s + v * kPer, x + v * kPer);
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

// words of chunk c: min(C, n - c C)
__device__ __forceinline__ int chunk_len(int64_t n, int chunk_log2,
                                         int64_t c) {
  const int64_t rest = n - (c << chunk_log2);
  const int64_t C = int64_t(1) << chunk_log2;
  return static_cast<int>(rest < C ? rest : C);
}

// eight consecutive words, moved as one (8, 16 or 32 bytes)
template <typename T>
struct alignas(sizeof(T) * 8) Oct {
  T v[8];
};

// the q-th 32 bits of eight words (q a constant once unrolled)
template <typename T>
__device__ __forceinline__ unsigned oct_bits(const Oct<T>& w, int q) {
  if constexpr (sizeof(T) == 4) {
    return w.v[q];
  } else if constexpr (sizeof(T) == 2) {
    return unsigned(w.v[2 * q]) | unsigned(w.v[2 * q + 1]) << 16;
  } else {
    return unsigned(w.v[4 * q]) | unsigned(w.v[4 * q + 1]) << 8 |
           unsigned(w.v[4 * q + 2]) << 16 | unsigned(w.v[4 * q + 3]) << 24;
  }
}

// eight words of 1, 2 or 4 bytes stored at L2 (.cg: no line of them in
// L1)
template <typename T>
__device__ __forceinline__ void store_oct_cg(T* p, const Oct<T>& w) {
  if constexpr (sizeof(T) == 1) {
    __stcg(reinterpret_cast<uint2*>(p), make_uint2(oct_bits(w, 0),
                                                   oct_bits(w, 1)));
  } else {
#pragma unroll
    for (int k = 0; k < static_cast<int>(sizeof(T)) / 2; ++k)
      __stcg(reinterpret_cast<uint4*>(p) + k,
             make_uint4(oct_bits(w, 4 * k), oct_bits(w, 4 * k + 1),
                        oct_bits(w, 4 * k + 2), oct_bits(w, 4 * k + 3)));
  }
}

constexpr int kVecs = 2;

// offset e (0-7) of a run of eight held in a uint4 (e a constant once
// unrolled, so the run stays in registers)
__device__ __forceinline__ uint16_t offset_at(const uint4& v, int e) {
  const unsigned w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
  return static_cast<uint16_t>(e & 1 ? w >> 16 : w & 0xffffu);
}

// pass 1's offsets of one round, under the evict-last policy `pol` (every
// row reads them again): run v = (round kVecs + i) threads + t of `per`
// pairs (8: one 16-byte load into ov[i]; 1: one into os[i]) from pair
// a0; past the array's `total` pairs read as 0
__device__ __forceinline__ void load_offsets(
    uint4 (&ov)[kVecs], uint16_t (&os)[kVecs],
    const uint16_t* __restrict__ src_off, int a0, int per, int nrun,
    int total, int round, uint64_t pol) {
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = (round * kVecs + i) * kPassThreads + threadIdx.x;
    if (v < nrun) {
      const int j = a0 + v * per;
      if (per == 1) {
        os[i] = ld_hint(src_off + j, pol);
      } else if (j + 8 <= total) {
        ov[i] = ld_hint(reinterpret_cast<const uint4*>(src_off + j), pol);
      } else {
        unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (j + e < total)
            w[e >> 1] |= static_cast<unsigned>(ld_hint(src_off + j + e, pol))
                         << (16 * (e & 1));
        ov[i] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

// pass 1 of source chunk b on `rows` rows (at most R; row r of x at
// x + r n, of the stage at stage + r stride): the rows' chunks into
// shared memory by cp.async (R chunks of C words) while this thread's
// offsets load, then the chunk's pairs, [bucket_ptr[b K], bucket_ptr[(b +
// 1) K]), to the stage in order (.cg stores: pass 2 may read the stage
// through L1, which must then hold no line of it).  A thread takes runs
// of eight pairs from a multiple of 8 (kVecs runs a round, one 16-byte
// load of offsets each under the evict-last policy), and stores each
// run's eight words of a row together; a run cut by the range's ends, or
// arrays not aligned for it, goes a word at a time.
template <typename W, int R>
__device__ __forceinline__ void rows_pass1(
    W* chunk, const W* __restrict__ x, const uint16_t* __restrict__ src_off,
    const int* __restrict__ bucket_ptr, W* __restrict__ stage,
    int64_t stride, int rows, int64_t n, int chunk_log2, int64_t b) {
  const int64_t nchunks = ((n - 1) >> chunk_log2) + 1;
  const int64_t C = int64_t(1) << chunk_log2;
  const int64_t first = b << chunk_log2;
  const int len = chunk_len(n, chunk_log2, b);
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < rows) chunk_copy(chunk + r * C, x + r * n + first, len);
  cp_async_commit();
  const int begin = bucket_ptr[b * nchunks];
  const int end = bucket_ptr[(b + 1) * nchunks];
  const int total = bucket_ptr[nchunks * nchunks];
  const bool vec =
      (reinterpret_cast<uintptr_t>(src_off) & 15) == 0 &&
      reinterpret_cast<uintptr_t>(stage) % sizeof(Oct<W>) == 0 &&
      stride % 8 == 0;
  const int a0 = vec ? begin & ~7 : begin;
  // runs of 8 pairs from a0 (single pairs where not vec)
  const int per = vec ? 8 : 1;
  const int nrun = (end - a0 + per - 1) / per;
  const uint64_t pol = evict_last_policy();
  uint4 ov[kVecs];
  uint16_t os[kVecs];
  load_offsets(ov, os, src_off, a0, per, nrun, total, 0, pol);
  cp_async_wait<0>();
  __syncthreads();
  for (int round = 0;; ++round) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int v = (round * kVecs + i) * kPassThreads + threadIdx.x;
      if (v >= nrun) continue;
      const int j = a0 + v * per;
      if (!vec) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < rows) stcg(stage + r * stride + j, chunk[r * C + os[i]]);
        continue;
      }
      if (j >= begin && j + 8 <= end) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rows) {
            Oct<W> w;
#pragma unroll
            for (int e = 0; e < 8; ++e)
              w.v[e] = chunk[r * C + offset_at(ov[i], e)];
            store_oct_cg(stage + r * stride + j, w);
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (j + e >= begin && j + e < end) {
#pragma unroll
            for (int r = 0; r < R; ++r)
              if (r < rows)
                stcg(stage + r * stride + j + e,
                     chunk[r * C + offset_at(ov[i], e)]);
          }
        }
      }
    }
    if ((round + 1) * kVecs * kPassThreads >= nrun) break;
    load_offsets(ov, os, src_off, a0, per, nrun, total, round + 1, pol);
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

// pass 2 of destination chunk k on `rows` rows (at most R; row r of the
// stage at stage + r stride): zero the rows' chunks, copy the pairs of
// the buckets (b, k), b = 0 .. K - 1, to their planned offsets, and store
// the chunks.  The buckets' sizes vary (a local perm fills one bucket a
// chunk), so the block copies their concatenation evenly: warp w takes an
// equal share of it, each lane walks its position's bucket forward in the
// prefix sums, and kAsync positions are in flight a lane, each offset
// loaded once for every row (under an L2 evict-last policy: every group
// reads the offsets again).  4-byte words go from the stage straight to
// their offset in shared memory by 4-byte cp.async (through L1: the stage
// must not have been rewritten in this launch since this SM may have read
// it, which the persistent launch keeps by giving every group its own
// stage rows); other words through registers, from L2 (.cg).  Shared
// memory: the R chunks (R C words), then the prefix sums (K + 1 ints), the
// buckets' starts in the stage (K ints) and the warps' sums.
template <typename W, int R>
__device__ __forceinline__ void rows_pass2(
    uint4* smem, const W* stage, const uint16_t* __restrict__ dst_off,
    const int* __restrict__ bucket_ptr, W* __restrict__ out, int64_t stride,
    int rows, int64_t n, int chunk_log2, int64_t k) {
  constexpr int kWarps = kPassThreads / 32;
  constexpr int kAsync = 8;
  constexpr bool kCopy = sizeof(W) == 4;
  constexpr int kBatch = kCopy ? kAsync : kPassUnroll;
  W* chunk = reinterpret_cast<W*>(smem);
  const int nchunks = static_cast<int>(((n - 1) >> chunk_log2) + 1);
  const int64_t C = int64_t(1) << chunk_log2;
  int* pre = reinterpret_cast<int*>(chunk + R * C);
  int* start = pre + nchunks + 1;
  int* warp_sums = start + nchunks;
  const int64_t first = k << chunk_log2;
  const int len = chunk_len(n, chunk_log2, k);
  const uint64_t pol = evict_last_policy();
  for (int b = threadIdx.x; b < nchunks; b += kPassThreads) {
    const int64_t at = static_cast<int64_t>(b) * nchunks + k;
    const int s = bucket_ptr[at];
    start[b] = s;
    pre[b + 1] = bucket_ptr[at + 1] - s;
  }
  const int nvec = static_cast<int>((R * C * sizeof(W)) / 16);
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
  for (int v = v0 + lane; v < v1; v += 32 * kBatch) {
    int j[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int vv = v + 32 * u;
      if (vv < v1) {
        while (pre[bk + 1] <= vv) ++bk;
        j[u] = start[bk] + (vv - pre[bk]);
      }
    }
    uint16_t o[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (v + 32 * u < v1) o[u] = ld_hint(dst_off + j[u], pol);
    if constexpr (kCopy) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (v + 32 * u < v1) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (r < rows)
              cp_async<4>(chunk + r * C + o[u], stage + r * stride + j[u]);
        }
    } else {
      W w[kBatch][R];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (v + 32 * u < v1) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (r < rows)
              w[u][r] = ldcg(stage + r * stride + j[u]);
        }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (v + 32 * u < v1) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (r < rows) chunk[r * C + o[u]] = w[u][r];
        }
    }
  }
  if constexpr (kCopy) {
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < rows) chunk_out(out + r * n + first, chunk + r * C, len);
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

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// the block goes on once *count has reached target (thread 0 polls)
__device__ __forceinline__ void wait_count(const unsigned* count,
                                           unsigned target) {
  if (threadIdx.x == 0) {
    while (ld_acquire(count) < target) __nanosleep(64);
  }
  __syncthreads();
}

// after a __syncthreads that ends an item: its reads and writes ordered
// before the count that others wait on
__device__ __forceinline__ void count_done(unsigned* count) {
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
  }
}

// both passes on the rows of [nrhs, n], groups of R rows, in one launch
// of persistent blocks.  counters (zeroed before the launch): the ticket
// (64 bits), then per group the pass-1 items done.  Item order
// (tickets): pass-1 item i (group i / K, chunk i % K) at time i, pass-2
// item i at time i + lag, a pass-2 item first on a tie; lag >= K, so a
// pass-2 item waits only on earlier tickets.  Row q of the stage at
// stage + q stride: every group has its own stage rows.
template <typename W, int R>
__global__ void __launch_bounds__(kPassThreads, kRowsBlocksPerSM)
    permute_rows_two_pass(const W* __restrict__ x,
                          const uint16_t* __restrict__ src_off,
                          const uint16_t* __restrict__ dst_off,
                          const int* __restrict__ bucket_ptr, W* stage,
                          unsigned* counters, W* __restrict__ out, int64_t n,
                          int64_t stride, int nrhs, int chunk_log2,
                          int64_t lag) {
  extern __shared__ uint4 smem[];
  __shared__ long long ticket;
  const int64_t nchunks = ((n - 1) >> chunk_log2) + 1;
  const int64_t groups = (nrhs + R - 1) / R;
  const int64_t items = groups * nchunks;     // of each pass
  const int64_t lead = lag < items ? lag : items;
  unsigned* done = counters + 2;
  for (;;) {
    if (threadIdx.x == 0)
      ticket = static_cast<long long>(atomicAdd(
          reinterpret_cast<unsigned long long*>(counters), 1ull));
    __syncthreads();
    const int64_t t = ticket;
    if (t >= 2 * items) return;
    bool second;
    int64_t i;
    if (t < lead) {
      second = false;
      i = t;
    } else if (t - lead < 2 * (items - lead)) {
      const int64_t u = t - lead;
      second = (u & 1) == 0;
      i = second ? u >> 1 : lead + (u >> 1);
    } else {
      second = true;
      i = t - items;
    }
    const int64_t g = i / nchunks, c = i % nchunks;
    const int rows = static_cast<int>(nrhs - g * R < R ? nrhs - g * R : R);
    W* st = stage + g * R * stride;
    if (!second) {
      rows_pass1<W, R>(reinterpret_cast<W*>(smem), x + g * R * n, src_off,
                       bucket_ptr, st, stride, rows, n, chunk_log2, c);
      __syncthreads();
      count_done(done + g);
    } else {
      wait_count(done + g, static_cast<unsigned>(nchunks));
      rows_pass2<W, R>(smem, st, dst_off, bucket_ptr, out + g * R * n,
                       stride, rows, n, chunk_log2, c);
      __syncthreads();
    }
  }
}

template <typename W, typename I, int RB>
void launch_rows_direct(const void* x, const void* perm, void* out,
                        int64_t n, int nrhs, cudaStream_t stream) {
  const int64_t ygroups = (nrhs + RB - 1) / RB;
  const dim3 grid(grid_for(n, int64_t(kThreads) * kGroup),
                  static_cast<unsigned>(ygroups < kMaxRows ? ygroups
                                                            : kMaxRows));
  permute_gather_batched<W, I, RB><<<grid, kThreads, 0, stream>>>(
      static_cast<const W*>(x), static_cast<const I*>(perm),
      static_cast<W*>(out), n, nrhs);
}

// batch_rows: 0 for one vector (permute_gather), else the rows of a group
// of the direct form on rows (1, 2 or 4)
template <typename W, typename I>
int launch(const void* x, const void* perm, void* out, int64_t n, int nrhs,
           int batch_rows, cudaStream_t stream) {
  if (batch_rows == 1) {
    launch_rows_direct<W, I, 1>(x, perm, out, n, nrhs, stream);
  } else if (batch_rows == 2) {
    launch_rows_direct<W, I, 2>(x, perm, out, n, nrhs, stream);
  } else if (batch_rows == 4) {
    launch_rows_direct<W, I, 4>(x, perm, out, n, nrhs, stream);
  } else if (batch_rows != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
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
                int nrhs, int word_bytes, int rows, cudaStream_t stream) {
  switch (word_bytes) {
    case 1: return launch<uint8_t, I>(x, perm, out, n, nrhs, rows, stream);
    case 2: return launch<uint16_t, I>(x, perm, out, n, nrhs, rows, stream);
    case 4: return launch<uint32_t, I>(x, perm, out, n, nrhs, rows, stream);
    case 8: return launch<uint64_t, I>(x, perm, out, n, nrhs, rows, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(const void* x, const void* perm, int index_bytes, void* out,
             int64_t n, int nrhs, int word_bytes, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0 || nrhs == 0) return 0;
  if (index_bytes == 4)
    return launch_word<int32_t>(x, perm, out, n, nrhs, word_bytes, rows, s);
  if (index_bytes == 8)
    return launch_word<int64_t>(x, perm, out, n, nrhs, word_bytes, rows, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the dynamic shared memory limit of a kernel raised to `bytes`, once
// per device (`configured`: the kernel's own flags)
template <typename K>
cudaError_t raise_smem(K kernel, int bytes, bool* configured) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && configured[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && device < kMaxDevices) configured[device] = true;
  return err;
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
    static bool configured1[kMaxDevices] = {};
    static bool configured2[kMaxDevices] = {};
    cudaError_t err = raise_smem(permute_pass1<W>, kSmemMax, configured1);
    if (err == cudaSuccess)
      err = raise_smem(permute_pass2<W>, kSmemMax, configured2);
    if (err != cudaSuccess) return static_cast<int>(err);
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

// the persistent two-pass launch on rows: the counters zeroed on the
// stream, a grid of what the card holds at once (at most one block an
// item), the lag of pass 2 behind pass 1 (see permute_rows_two_pass)
template <typename W, int R>
int launch_rows(const void* x, const void* src_off, const void* dst_off,
                const void* bucket_ptr, void* stage, void* counters,
                void* out, int64_t n, int64_t stride, int nrhs,
                int chunk_log2, cudaStream_t stream) {
  const int64_t nchunks = ((n - 1) >> chunk_log2) + 1;
  const int64_t groups = (nrhs + R - 1) / R;
  const size_t chunk_bytes = (size_t(1) << chunk_log2) * sizeof(W);
  const size_t smem = R * chunk_bytes +
      (2 * static_cast<size_t>(nchunks) + 1 + kPassThreads / 32) * 4;
  if (smem > size_t(kSmemRows) || chunk_bytes < 16 || nchunks > kMaxChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured[kMaxDevices] = {};
  cudaError_t err =
      raise_smem(permute_rows_two_pass<W, R>, kSmemRows, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the blocks the card holds at once, asked once per device and shared
  // memory size (so that a launch captured in a graph asks nothing)
  static size_t asked[kMaxDevices] = {};
  static int resident[kMaxDevices] = {};
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = device < kMaxDevices && asked[device] == smem
                   ? resident[device] : 0;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, permute_rows_two_pass<W, R>, kPassThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    blocks = per_sm * sms;
    if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (device < kMaxDevices) {
      asked[device] = smem;
      resident[device] = blocks;
    }
  }
  int64_t grid = blocks;
  if (grid > 2 * groups * nchunks) grid = 2 * groups * nchunks;
  const int64_t lag =
      nchunks + (grid / 2 < nchunks ? grid / 2 : nchunks);
  err = cudaMemsetAsync(counters, 0, (2 + groups) * sizeof(unsigned),
                        stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  permute_rows_two_pass<W, R><<<static_cast<unsigned>(grid), kPassThreads,
                                smem, stream>>>(
      static_cast<const W*>(x), static_cast<const uint16_t*>(src_off),
      static_cast<const uint16_t*>(dst_off),
      static_cast<const int*>(bucket_ptr), static_cast<W*>(stage),
      static_cast<unsigned*>(counters), static_cast<W*>(out), n, stride, nrhs,
      chunk_log2, lag);
  return static_cast<int>(cudaGetLastError());
}

// a group holds 4 bytes of every slot: R = 4 / sizeof(W) (`rows`, the
// wrapper's kernels/permute.py:two_pass_rows, must agree)
template <typename W>
int launch_rows_word(const void* x, const void* src_off, const void* dst_off,
                     const void* bucket_ptr, void* stage, void* counters,
                     void* out, int64_t n, int64_t stride, int nrhs,
                     int chunk_log2, int rows, cudaStream_t stream) {
  constexpr int R = 4 / sizeof(W);
  if (rows != R) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows<W, R>(x, src_off, dst_off, bucket_ptr, stage, counters,
                           out, n, stride, nrhs, chunk_log2, stream);
}

}  // namespace

extern "C" {

int tsp_permute_gather(const void* x, const void* perm, int index_bytes,
                       void* out, int64_t n, int word_bytes, void* stream) {
  return dispatch(x, perm, index_bytes, out, n, 1, word_bytes, 0, stream);
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

// the direct form on the rows of [nrhs, n]: groups of `rows` rows (1, 2
// or 4) a thread gathers with each group of four perm entries
int tsp_permute_gather_batched(const void* x, const void* perm,
                               int index_bytes, void* out, int64_t n,
                               int nrhs, int word_bytes, int rows,
                               void* stream) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(x, perm, index_bytes, out, n, nrhs, word_bytes, rows,
                  stream);
}

// both passes of a two-pass plan on the rows of [nrhs, n]: groups of
// `rows` rows (4 bytes of every slot) of 1-, 2- or 4-byte words, a stage
// of nrhs rows of `stride` words (at least the plan's pairs, a multiple of
// 32), counters of 2 + ceil(nrhs / rows) uint32
int tsp_permute_rows_two_pass(const void* x, const void* src_off,
                              const void* dst_off, const void* bucket_ptr,
                              void* stage, void* counters, void* out,
                              int64_t n, int64_t stride, int nrhs,
                              int chunk_log2, int word_bytes, int rows,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0 || nrhs == 0) return 0;
  if (stride % 32) return static_cast<int>(cudaErrorInvalidValue);
  switch (word_bytes) {
    case 1:
      return launch_rows_word<uint8_t>(x, src_off, dst_off, bucket_ptr, stage,
                                       counters, out, n, stride, nrhs,
                                       chunk_log2, rows, s);
    case 2:
      return launch_rows_word<uint16_t>(x, src_off, dst_off, bucket_ptr,
                                        stage, counters, out, n, stride, nrhs,
                                        chunk_log2, rows, s);
    case 4:
      return launch_rows_word<uint32_t>(x, src_off, dst_off, bucket_ptr,
                                        stage, counters, out, n, stride, nrhs,
                                        chunk_log2, rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
