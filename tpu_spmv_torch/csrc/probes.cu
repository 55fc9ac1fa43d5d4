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
// tile_permute: one block per [128, 128] f32 tile.  The tile is staged in
// shared memory (row stride 129, so a transpose reads a column without bank
// conflicts; 66 KB, dynamic shared memory) and a program of up to 8 steps
// runs on it in one launch:
//   S (k):  z[i][j] <- z[idx_k[i][j]][j]    take_along_axis, axis 0
//   G (k):  z[i][j] <- z[i][idx_k[i][j]]    take_along_axis, axis 1
//   T:      z[i][j] <- z[j][i]
// idx is [K, Ti, 128, 128] (int8 or int32): slot k's tile for tile t is
// idx[k, t] when Ti > 1 and idx[k, 0] when every tile shares it.  Each step
// reads its new values into registers (16 per thread of 1024), syncs,
// writes them back and syncs.  The tile is loaded either directly (src is
// [T, 128, 128]) or row by row through rowsrc (src is [S, 128]): row r < nload
// of tile t is src[rowsrc[t * nload + r]], lane-gathered by
// lidx[t * nload + r] when lidx is given; rows nload..127 are zero.  An
// optional epilogue multiplies by mul[t] (__fmul_rn) and, with psum8,
// writes the width-8 sums of segsum8 ([T, 128, 16]) instead of the tile.
// The steps move words; the epilogue rounds once per product and once per
// add in a fixed order, so the result equals the plain version bitwise.
// Index values lie in [0, 128) (the wrapper's plan checks them on the host;
// the kernel masks them with 127 so that no bad index reads outside the
// tile).  Bound: bytes, the tile once in and once out, the index tiles once
// (shared index tiles are read from L2 by every block).
//
// Every kernel launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 128;
constexpr int kStride = kQ + 1;             // shared-memory row stride
constexpr int kTileThreads = 1024;
constexpr int kPerThread = kQ * kQ / kTileThreads;   // 16
constexpr int kMaxSteps = 8;
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

// steps: nibble s (bits 4s..4s+3) is step s: low 2 bits the op (0 end,
// 1 S, 2 G, 3 T), high 2 bits the index slot k
template <typename I>
__global__ void __launch_bounds__(kTileThreads)
tile_permute(const float* __restrict__ src, const int32_t* __restrict__ rowsrc,
             const I* __restrict__ lidx, int nload,
             const I* __restrict__ idx, int idx_tiles, unsigned steps,
             const float* __restrict__ mul, int psum8,
             float* __restrict__ out) {
  extern __shared__ float z[];               // [kQ][kStride]
  const int64_t t = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t tile = static_cast<int64_t>(kQ) * kQ;

  // load: position p = tid + kTileThreads * e, row p / 128, lane p % 128
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int p = tid + kTileThreads * e;
    const int r = p / kQ, c = p % kQ;
    float v;
    if (rowsrc == nullptr) {
      v = src[t * tile + p];
    } else if (r < nload) {
      const int64_t row = t * nload + r;
      const int lane = lidx == nullptr
          ? c : (static_cast<int>(lidx[row * kQ + c]) & (kQ - 1));
      v = src[static_cast<int64_t>(rowsrc[row]) * kQ + lane];
    } else {
      v = 0.0f;
    }
    z[r * kStride + c] = v;
  }
  __syncthreads();

  for (int s = 0; s < kMaxSteps; ++s) {
    const unsigned code = (steps >> (4 * s)) & 0xFu;
    const unsigned op = code & 3u;
    if (op == 0) break;
    const I* ix = idx + (static_cast<int64_t>(code >> 2) * idx_tiles +
                         (idx_tiles > 1 ? t : 0)) * tile;
    float v[kPerThread];
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int p = tid + kTileThreads * e;
      const int r = p / kQ, c = p % kQ;
      if (op == 3u) {
        v[e] = z[c * kStride + r];
      } else {
        const int k = static_cast<int>(ix[p]) & (kQ - 1);
        v[e] = op == 1u ? z[k * kStride + c] : z[r * kStride + k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int p = tid + kTileThreads * e;
      z[(p / kQ) * kStride + p % kQ] = v[e];
    }
    __syncthreads();
  }

  if (psum8) {
    // 128 rows x 16 sums, two per thread
    for (int o = tid; o < kQ * (kQ / 8); o += kTileThreads) {
      const int r = o / (kQ / 8), j = o % (kQ / 8);
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = 8 * j + k;
        const float a = z[r * kStride + c];
        v[k] = mul == nullptr ? a : __fmul_rn(a, mul[t * tile + r * kQ + c]);
      }
      out[t * (kQ * kQ / 8) + o] = sum8(v);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int p = tid + kTileThreads * e;
      const float a = z[(p / kQ) * kStride + p % kQ];
      out[t * tile + p] = mul == nullptr ? a : __fmul_rn(a, mul[t * tile + p]);
    }
  }
}

constexpr int kTileSmem = kQ * kStride * static_cast<int>(sizeof(float));
constexpr int kMaxDevices = 64;

template <typename I>
int launch_tile(const float* src, const int32_t* rowsrc, const void* lidx,
                int nload, const void* idx, int idx_tiles, unsigned steps,
                const float* mul, int psum8, float* out, int64_t ntiles,
                cudaStream_t stream) {
  // the shared-memory limit is a per-device attribute of the function
  static bool configured[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices || !configured[device]) {
    err = cudaFuncSetAttribute(tile_permute<I>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTileSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < kMaxDevices) configured[device] = true;
  }
  tile_permute<I><<<static_cast<unsigned>(ntiles), kTileThreads, kTileSmem,
                    stream>>>(src, rowsrc, static_cast<const I*>(lidx), nload,
                              static_cast<const I*>(idx), idx_tiles, steps,
                              mul, psum8, out);
  return static_cast<int>(cudaGetLastError());
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

int tsp_tile_permute(const void* src, const void* rowsrc, const void* lidx,
                     int nload, const void* idx, int index_bytes,
                     int idx_tiles, unsigned steps, const void* mul, int psum8,
                     void* out, int64_t ntiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ntiles == 0) return 0;
  if (ntiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const float* sf = static_cast<const float*>(src);
  const int32_t* rs = static_cast<const int32_t*>(rowsrc);
  const float* mf = static_cast<const float*>(mul);
  float* of = static_cast<float*>(out);
  if (index_bytes == 1)
    return launch_tile<int8_t>(sf, rs, lidx, nload, idx, idx_tiles, steps,
                               mf, psum8, of, ntiles, s);
  if (index_bytes == 4)
    return launch_tile<int32_t>(sf, rs, lidx, nload, idx, idx_tiles, steps,
                                mf, psum8, of, ntiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
