// Probe kernels for Hopper (sm_90a): copy_scale, launch_probe, segsum8 and
// tile_permute, the roofline and probe path of the port.
//
// Replaces the last Pallas kernels of the JAX reference package, the
// measurement probes outside tpu_spmv/:
//   K9  bench.py:_pallas_copy (ckernel)        y = x * 0.9999999, the
//       bandwidth probe that sets the roofline's peak           -> copy_scale
//   T1  tools/profile_gpr.py (_copy_kernel)    a [128, 128] f32 copy, the
//       fixed cost of one launch (timed once and four in a row) -> launch_probe
//   T2  tools/profile_reduce.py (k_strided and its variants) the width-8
//       segmented lane sum [R, 128] -> [R, 16]                  -> segsum8
//   T3  tools/profile_sublane.py (k_sub1, k_gsg, k_exch_sg, k_exch_sg_red,
//       k_s1v2) and T4 tools/prof_tgtg_mxu.py (make_kernel's tgtg): gathers
//       along axis 0 (S) and axis 1 (G) and transposes (T) of a [128, 128]
//       tile, optionally loaded through a row index, multiplied by a second
//       tile and width-8 summed                                 -> tile_permute
// The probes asked TPU questions (VMEM copy rates, MXU against VPU
// transposes, sublane gathers).  What each computes is what is ported; the
// questions have no Hopper meaning.
//
// copy_scale: out[i] = x[i] * 0.9999999f, one f32 multiply (the constant
// is torch's x * 0.9999999 in f32), so the result equals the plain version
// bitwise.  Bound: bytes, 8 B per value (one read, one write).  Design:
// 16-byte loads and stores (float4) in a grid-stride loop, a scalar tail.
//
// launch_probe: out = x for one [128, 128] f32 tile (64 KiB).  Bound: the
// launch itself; 128 KiB of traffic is 0.04 us at 3.35 TB/s.  Design: 16
// blocks of 256 threads, one float4 each.
//
// segsum8: out[r, j] = x[r, 8j] + x[r, 8j+1] + ... + x[r, 8j+7], added left
// to right with __fadd_rn (no FMA contraction, no matmul and so no TF32), so
// the result equals a plain version that adds in the same order bitwise.
// Bound: bytes, 512 B in and 64 B out per row.  Design: one thread per
// output, two float4 loads of its 8 lanes; neighbouring threads read
// neighbouring 32-byte runs.
//
// tile_permute: a program of up to 8 steps on [128, 128] f32 tiles
//   S (k):  z[i][j] <- z[idx_k[i][j]][j]    take_along_axis, axis 0
//   G (k):  z[i][j] <- z[i][idx_k[i][j]]    take_along_axis, axis 1
//   T:      z[i][j] <- z[j][i]
// on a tile loaded either directly (src is [T, 128, 128]) or row by row
// through rowsrc (src is [S, 128]): row r < nload of tile t is
// src[rowsrc[t * nload + r]], lane-gathered by lidx[t * nload + r] when
// lidx is given; rows nload..127 are zero.  idx is [K, Ti, 128, 128] int8
// (the plan stores every index in one byte): slot k's tile for tile t is
// idx[k, t] when Ti > 1 and idx[k, 0] when every tile shares it.  An
// optional epilogue multiplies by mul[t] (__fmul_rn) and, with psum8,
// writes the width-8 sums of segsum8 ([T, 128, 16]) instead of the tile.
// Bound: bytes, the loaded rows once, the output once, the index tiles,
// rowsrc, lidx and mul once.
// Design: every step moves words, so the program's output is one gather
// from the loaded tile.  A thread walks the steps backward from its output
// position (i, j) through the index tiles (T: (i, j) <- (j, i); S_k: i <-
// idx_k[i][j]; G_k: j <- idx_k[i][j]) to a position of the loaded tile and
// reads that value once: no intermediate tile, no per-step barrier.  A
// block first stages, with cp.async (every copy asked for before any is
// waited for), the part of the loaded tile its outputs can reach and the
// same part of every index tile the program reads, one byte an index, in
// shared memory; the walks then read only shared memory, and each thread
// writes four neighbouring outputs (one 16-byte store) or, with psum8, one
// sum of eight.  The staged rows are padded (4 values, 16 index bytes),
// so that a walk reading down a column, after a transpose, spreads over
// the banks.  The host plan names what a block can reach: an S-only
// program keeps every column (blocks of 512 threads take 32 columns of a
// tile), a G-only one every row (32 rows), anything else the whole tile:
// one block of 1024 threads a tile (a block on half a tile would still
// stage all of it: slower on the card, though it fills more SMs), and
// where there are more tiles than SMs, one persistent block an SM with two
// stage buffers, the next tile's copies in flight while it computes this
// one.  The epilogue
// rounds once per product and once per add in the plain version's order,
// so the result equals it bitwise.  Index values lie in [0, 128) (the
// wrapper's plan checks them on the host; the kernel masks them with 127
// so that no bad index reads outside the tile).
//
// Every kernel launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kQ = 128;
constexpr int kMaxSteps = 8;
constexpr int kMaxDevices = 64;
constexpr float kScale = 0.9999999f;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = int64_t(1) << 20;

inline int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

__global__ void copy_scale_vec(const float4* __restrict__ x,
                               float4* __restrict__ out, int64_t n4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    float4 v = x[i];
    v.x = __fmul_rn(v.x, kScale);
    v.y = __fmul_rn(v.y, kScale);
    v.z = __fmul_rn(v.z, kScale);
    v.w = __fmul_rn(v.w, kScale);
    out[i] = v;
  }
}

__global__ void copy_scale_scalar(const float* __restrict__ x,
                                  float* __restrict__ out, int64_t begin,
                                  int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = begin + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride)
    out[i] = __fmul_rn(x[i], kScale);
}

__global__ void copy_tile(const float4* __restrict__ x,
                          float4* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = x[i];
}

__device__ __forceinline__ float sum8(const float* v) {
  float s = v[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) s = __fadd_rn(s, v[k]);
  return s;
}

__global__ void segsum8(const float4* __restrict__ x, float* __restrict__ out,
                        int64_t nout) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < nout; i += stride) {
    const float4 a = x[2 * i];
    const float4 b = x[2 * i + 1];
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    out[i] = sum8(v);
  }
}

// what a tile_permute block can reach of its tile (the plan's mode)
enum TileMode { kFullTile = 0, kRowSlabs = 1, kColSlabs = 2 };
constexpr int kSlab = 32;       // rows or columns a block of the slab modes
constexpr int kIndexSlots = 4;  // index slots a step can name (2 bits)
// a program's launch arguments, made once with the program
// (bench/probes.py:TileProgram, a ctypes structure of the same layout)
struct TileArgs {
  const int32_t* rowsrc;  // [T * nload] or null: tiles loaded directly
  const int8_t* lidx;     // [T * nload, 128] or null: no lane gathers
  int nload;
  const int8_t* idx;      // [K, idx_tiles, 128, 128]
  int idx_tiles;
  unsigned steps;
  int nsteps;
  unsigned staged;
  int mode;
};

// bytes of one stage buffer: the region of the loaded tile [nr][nc + 4]
// floats (rows padded so that a walk reading down a column, after a
// transpose, spreads over the banks), the staged index slots
// [nstaged][nr][nc + 16] bytes, then for row-loaded tiles the rows'
// sources [128] and, with lane gathers, lidx's region [nr][nc]
__host__ __device__ __forceinline__ int stage_bytes(const TileArgs& a) {
  const int nr = a.mode == kRowSlabs ? kSlab : kQ;
  const int nc = a.mode == kColSlabs ? kSlab : kQ;
  int nstaged = 0;
  for (int k = 0; k < kIndexSlots; ++k) nstaged += (a.staged >> k) & 1;
  return nr * ((nc + 4) * 4 + nstaged * (nc + 16)) +
         (a.rowsrc != nullptr ? kQ * 4 : 0) +
         (a.lidx != nullptr ? nr * nc : 0);
}

// a.steps: nibble s (bits 4s..4s+3) is step s (a.nsteps of them): low 2
// bits the op (1 S, 2 G, 3 T), high 2 bits the index slot k; a.staged:
// bit k set where a step reads slot k (each such slot is staged in shared
// memory).  A unit is one block's share of a tile (parts a tile); a block
// walks units blockIdx.x, blockIdx.x + gridDim.x, ..., with nbuf stage
// buffers: with two, the next unit's copies are in flight while it
// computes this one.  PSUM8: a thread sums eight outputs, else writes four.
template <bool PSUM8, int THREADS>
__global__ void __launch_bounds__(THREADS)
tile_permute(const float* __restrict__ src, TileArgs a, int parts, int nbuf,
             int64_t nunits, const float* __restrict__ mul,
             float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int G = PSUM8 ? 8 : 4;
  const int64_t tile = static_cast<int64_t>(kQ) * kQ;
  // the staged region's shape (rows nr, columns nc; a slab of 32 rows or
  // columns in the slab modes) and its padded rows
  const int nr = a.mode == kRowSlabs ? kSlab : kQ;
  const int nc = a.mode == kColSlabs ? kSlab : kQ;
  const int zs = nc + 4, is = nc + 16;
  const int nbytes = stage_bytes(a);
  // nibble k of places: the place of slot k among the staged ones
  unsigned places = 0xFFFFu;
  for (int k = 0, n = 0; k < kIndexSlots; ++k)
    if ((a.staged >> k) & 1u)
      places ^= (0xFu ^ static_cast<unsigned>(n++)) << (4 * k);

  struct Buffer {
    float* z;
    int8_t* zi;
    int32_t* srow;
    int8_t* zl;
  };
  auto buffer = [&](int b) {
    Buffer f;
    f.z = reinterpret_cast<float*>(smem_raw + b * nbytes);
    f.zi = reinterpret_cast<int8_t*>(f.z + nr * zs);
    f.srow = reinterpret_cast<int32_t*>(f.zi + __popc(a.staged) * nr * is);
    f.zl = reinterpret_cast<int8_t*>(f.srow + (a.rowsrc != nullptr ? kQ : 0));
    return f;
  };
  // unit u: tile u / parts; its region starts at row r0, column c0
  auto origin = [&](int64_t u, int& r0, int& c0) {
    const int part = static_cast<int>(u % parts);
    r0 = a.mode == kRowSlabs ? part * kSlab : 0;
    c0 = a.mode == kColSlabs ? part * kSlab : 0;
  };

  // ask for unit u's copies into buffer b, every one before any is waited
  // for (row-loaded tiles read their rows' sources first), and commit
  auto stage = [&](int64_t u, int b) {
    const Buffer f = buffer(b);
    const int64_t t = u / parts;
    int r0, c0;
    origin(u, r0, c0);
    const int64_t tsel = a.idx_tiles > 1 ? t : 0;
    for (int k = 0, n = 0; k < kIndexSlots; ++k) {
      if (!((a.staged >> k) & 1u)) continue;
      const int8_t* const from = a.idx + (k * a.idx_tiles + tsel) * tile;
      int8_t* const dst = f.zi + n++ * nr * is;
      for (int e = threadIdx.x; e < nr * nc / 16; e += THREADS) {
        const int r = e / (nc / 16), c = (e % (nc / 16)) * 16;
        cp_async<16>(dst + r * is + c, from + (r0 + r) * kQ + c0 + c);
      }
    }
    if (a.rowsrc != nullptr) {
      for (int r = threadIdx.x; r < a.nload; r += THREADS)
        f.srow[r] = __ldg(a.rowsrc + t * a.nload + r);
      __syncthreads();
      if (a.lidx != nullptr)
        for (int e = threadIdx.x; e < nr * nc / 16; e += THREADS) {
          const int r = e / (nc / 16), c = (e % (nc / 16)) * 16;
          if (r0 + r < a.nload)
            cp_async<16>(f.zl + r * nc + c,
                         a.lidx + (t * a.nload + r0 + r) * kQ + c0 + c);
        }
    }
    for (int e = threadIdx.x; e < nr * nc / 4; e += THREADS) {
      const int r = e / (nc / 4), c = (e % (nc / 4)) * 4;
      float* const dst = f.z + r * zs + c;
      if (a.rowsrc == nullptr)
        cp_async<16>(dst, src + t * tile + (r0 + r) * kQ + c0 + c);
      else if (r0 + r < a.nload)
        cp_async<16>(dst, src + static_cast<int64_t>(f.srow[r0 + r]) * kQ +
                              c0 + c);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    cp_async_commit();
  };

  // the outputs of unit u from buffer b
  auto compute = [&](int64_t u, int b) {
    const Buffer f = buffer(b);
    const int64_t t = u / parts;
    int r0, c0;
    origin(u, r0, c0);
    const int per_row = nc / G;
    for (int q = threadIdx.x; q < nr * per_row; q += THREADS) {
      const int i = r0 + q / per_row, j = c0 + (q % per_row) * G;
      const int64_t at = t * tile + i * kQ + j;
      // mul's values first: their load overlaps the walks
      float4 m[G / 4];
      if (mul != nullptr) {
#pragma unroll
        for (int e = 0; e < G / 4; ++e)
          m[e] = __ldg(reinterpret_cast<const float4*>(mul + at) + e);
      }
      // the G outputs (i, j + e) walked backward together through the
      // steps (each step decoded once) to positions of the loaded tile
      // (in the region's coordinates), whose lane a lane gather (lidx)
      // then picks from the staged row
      int r[G], c[G];
#pragma unroll
      for (int e = 0; e < G; ++e) {
        r[e] = i - r0;
        c[e] = j + e - c0;
      }
      for (int st = a.nsteps - 1; st >= 0; --st) {
        const unsigned code = (a.steps >> (4 * st)) & 0xFu;
        const unsigned op = code & 3u;
        if (op == 3u) {
#pragma unroll
          for (int e = 0; e < G; ++e) {
            const int tmp = r[e] + r0;
            r[e] = c[e] + c0 - r0;
            c[e] = tmp - c0;
          }
        } else {
          const int8_t* const zt =
              f.zi + ((places >> (4 * (code >> 2))) & 0xFu) * nr * is;
          if (op == 1u) {
#pragma unroll
            for (int e = 0; e < G; ++e)
              r[e] = (zt[r[e] * is + c[e]] & (kQ - 1)) - r0;
          } else {
#pragma unroll
            for (int e = 0; e < G; ++e)
              c[e] = (zt[r[e] * is + c[e]] & (kQ - 1)) - c0;
          }
        }
      }
      float v[G];
#pragma unroll
      for (int e = 0; e < G; ++e) {
        if (a.lidx != nullptr) c[e] = f.zl[r[e] * nc + c[e]] & (kQ - 1);
        v[e] = f.z[r[e] * zs + c[e]];
      }
      if (mul != nullptr) {
#pragma unroll
        for (int e = 0; e < G / 4; ++e) {
          v[4 * e] = __fmul_rn(v[4 * e], m[e].x);
          v[4 * e + 1] = __fmul_rn(v[4 * e + 1], m[e].y);
          v[4 * e + 2] = __fmul_rn(v[4 * e + 2], m[e].z);
          v[4 * e + 3] = __fmul_rn(v[4 * e + 3], m[e].w);
        }
      }
      if (PSUM8) {
        float sum = v[0];
#pragma unroll
        for (int e = 1; e < G; ++e) sum = __fadd_rn(sum, v[e]);
        out[at / 8] = sum;
      } else {
        __stcs(reinterpret_cast<float4*>(out + at),
               make_float4(v[0], v[1], v[2], v[3]));
      }
    }
  };

  int b = 0;
  int64_t u = blockIdx.x;
  if (u < nunits) stage(u, 0);
  for (; u < nunits; u += gridDim.x) {
    const int64_t next = u + gridDim.x;
    if (nbuf == 2 && next < nunits) {
      stage(next, b ^ 1);  // in flight while unit u computes
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of unit u landed
    compute(u, b);
    __syncthreads();  // buffer b is read before a later stage refills it
    if (nbuf == 2)
      b ^= 1;
    else if (next < nunits)
      stage(next, b);
  }
}

// the device's SM count, read once per device
int sm_count(int dev) {
  static int sms[kMaxDevices] = {};
  if (dev >= 0 && dev < kMaxDevices && sms[dev]) return sms[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev >= 0 && dev < kMaxDevices) sms[dev] = n;
  return n;
}

template <bool PSUM8, int THREADS>
int launch_tile_t(const float* src, const TileArgs& a, int parts, int nbuf,
                  int64_t nunits, int64_t blocks, const float* mul,
                  float* out, cudaStream_t stream) {
  // the shared-memory limit is a per-device attribute of the function
  static bool configured[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices || !configured[device]) {
    err = cudaFuncSetAttribute(tile_permute<PSUM8, THREADS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) configured[device] = true;
  }
  tile_permute<PSUM8, THREADS>
      <<<static_cast<unsigned>(blocks), THREADS,
         static_cast<size_t>(nbuf) * stage_bytes(a), stream>>>(
          src, a, parts, nbuf, nunits, mul, out);
  return static_cast<int>(cudaGetLastError());
}

// the slab modes: four blocks a tile of 512 threads; the whole tile: one
// block of 1024 threads a tile, and where there are more tiles than SMs,
// one persistent block an SM with two stage buffers (the next tile's
// copies in flight while it computes this one), where two fit
template <bool PSUM8>
int launch_tile(const float* src, const TileArgs& a, const float* mul,
                float* out, int64_t ntiles, cudaStream_t stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.mode != kFullTile) {
    const int64_t nunits = ntiles * (kQ / kSlab);
    if (nunits > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    return launch_tile_t<PSUM8, 512>(src, a, kQ / kSlab, 1, nunits, nunits,
                                     mul, out, stream);
  }
  const int64_t sms = sm_count(device);
  const bool ring = ntiles > sms && 2 * stage_bytes(a) <= kSmemMax;
  const int64_t blocks = ring ? sms : ntiles;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  return launch_tile_t<PSUM8, 1024>(src, a, 1, ring ? 2 : 1, ntiles, blocks,
                                    mul, out, stream);
}

}  // namespace

extern "C" {

int tsp_copy_scale(const void* x, void* out, int64_t n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  int64_t begin = 0;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) %
          16 == 0) {
    const int64_t n4 = n / 4;
    if (n4 > 0)
      copy_scale_vec<<<grid_for(n4), kThreads, 0, s>>>(
          reinterpret_cast<const float4*>(xf), reinterpret_cast<float4*>(of),
          n4);
    begin = 4 * n4;
  }
  if (begin < n)
    copy_scale_scalar<<<grid_for(n - begin), kThreads, 0, s>>>(xf, of, begin,
                                                               n);
  return static_cast<int>(cudaGetLastError());
}

int tsp_launch_probe(const void* x, void* out, void* stream) {
  // one [128, 128] f32 tile: 4096 float4s, 16 blocks of 256
  copy_tile<<<kQ * kQ / 4 / kThreads, kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

int tsp_segsum8(const void* x, void* out, int64_t nout, void* stream) {
  if (nout == 0) return 0;
  segsum8<<<grid_for(nout), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float*>(out), nout);
  return static_cast<int>(cudaGetLastError());
}

int tsp_tile_permute(const void* src, const void* program, const void* mul,
                     int psum8, void* out, int64_t ntiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TileArgs& a = *static_cast<const TileArgs*>(program);
  if (ntiles == 0) return 0;
  if (ntiles < 0 || a.nsteps < 1 || a.nsteps > kMaxSteps ||
      a.staged >> kIndexSlots || a.mode < kFullTile || a.mode > kColSlabs)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sf = static_cast<const float*>(src);
  const float* mf = static_cast<const float*>(mul);
  float* of = static_cast<float*>(out);
  return psum8 ? launch_tile<true>(sf, a, mf, of, ntiles, s)
               : launch_tile<false>(sf, a, mf, of, ntiles, s);
}

}  // extern "C"
