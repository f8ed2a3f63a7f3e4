// Helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_delta.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu): vector loads that
// widen bf16 or f32 to float32 registers, stores that round back, and the
// tile copy from a row-major [S, D] array into shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kftpu {

__device__ __forceinline__ void load2(const float* p, float (&f)[2]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  f[0] = a.x; f[1] = a.y;
}

__device__ __forceinline__ void load2(const __nv_bfloat16* p, float (&f)[2]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  f[0] = a.x; f[1] = a.y;
}

__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&f)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
    w[e] = *reinterpret_cast<const uint32_t*>(&t);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

// Copies rows [row0, row0 + kRows) of a row-major [S, D] array into shared
// memory, 16 bytes per thread per step, zero-filling rows at or past S.
// kTranspose stores element (r, c) at sm[c * stride + r], else at
// sm[r * stride + c].
template <typename T, int D, int kRows, int kThreads, bool kTranspose>
__device__ __forceinline__ void load_tile(const T* __restrict__ g, int row0,
                                          int S, T* sm, int stride) {
  constexpr int kElems = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int kChunksPerRow = D / kElems;
  for (int c = threadIdx.x; c < kRows * kChunksPerRow; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * kElems;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) {
      u = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * D + col);
    }
    if (kTranspose) {
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int x = 0; x < kElems; ++x) sm[(col + x) * stride + r] = e[x];
    } else {
      *reinterpret_cast<uint4*>(sm + r * stride + col) = u;
    }
  }
}

// Every flash grid is n_tiles tiles for each of bh (batch*head) rows,
// folded into gridDim.x with bh fastest: gridDim.y would cap bh at 65535,
// and ring flash folds its ring positions into bh. Blocks start in
// blockIdx order, so the tile index is the slow part of the launch order:
// every head's tile 0 (the longest causal walk) starts before any head's
// tile 1. A grid of more than 2^31 - 1 blocks comes back as 0 blocks, which
// the launch refuses.
inline dim3 fold_grid(int n_tiles, int bh) {
  const long long n = (long long)n_tiles * bh;
  return dim3(n > 0x7fffffffLL ? 0u : (unsigned)n);
}

// This block's (tile, bh) in a `fold_grid` of n_tiles tiles per row.
struct TileHead {
  int tile;
  int bh;
};

__device__ __forceinline__ TileHead tile_head(int n_tiles) {
  const int n_bh = (int)gridDim.x / n_tiles;
  return {(int)blockIdx.x / n_bh, (int)blockIdx.x % n_bh};
}

// Sets the kernel's dynamic shared-memory limit, then launches it.
template <typename Kernel, typename... Args>
int launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem,
                  cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace kftpu

extern "C" const char* kftpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
