// The flash-attention backward's shared precompute for Hopper (sm_90a),
// CUDA C++: delta = rowsum(dO * O) per query row, in float32.
//
// Replaces the TPU kernel kubeflow_tpu/ops/flash.py:_delta_kernel. There
// each grid step reads a (bq, D) block of O and dO and writes delta in a
// lane-replicated or lane-packed lse layout, a Mosaic tiling artefact;
// here delta is a plain [BH, S] float32 array, as lse is. The backward
// kernels (flash_bwd_dq.cu, flash_bwd_dkv.cu) read it and never O.
//
// What bounds it: 2 FLOP per element against 2 input elements read, so
// it is bound by bytes (at the training shape 67 MB read, 0.5 MB written:
// ~0.02 ms at 3.35 TB/s). The design only keeps the reads coalesced: one
// warp per row, each lane reading D/32 adjacent elements in one vector
// load of O and one of dO, a float32 fused multiply-add chain, and a
// shuffle reduction across the warp.

#include "flash_common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // one warp per row
constexpr int kThreads = 32 * kRowsPerBlock;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                   float* __restrict__ delta, long long rows) {
  constexpr int kPer = D / 32;
  static_assert(kPer == 2 || kPer == 4, "D must be 64 or 128");
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t at = (size_t)row * D + lane * kPer;
  float a[kPer], b[kPer];
  if constexpr (kPer == 4) {
    kftpu::load4(o + at, a);
    kftpu::load4(dout + at, b);
  } else {
    kftpu::load2(o + at, a);
    kftpu::load2(dout + at, b);
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) sum = fmaf(a[i], b[i], sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

template <typename T, int D>
int launch(const void* o, const void* dout, void* delta, long long rows,
           cudaStream_t stream) {
  const dim3 grid((unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock));
  return kftpu::launch_kernel(flash_delta_kernel<T, D>, grid, kThreads, 0, stream,
                              static_cast<const T*>(o), static_cast<const T*>(dout),
                              static_cast<float*>(delta), rows);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. d: 64 or 128. o and dout are device
// pointers to contiguous [bh, s, d] arrays, 16-byte aligned; delta is a
// [bh, s] float32 array. Returns a cudaError_t.
extern "C" int kftpu_flash_delta(const void* o, const void* dout, void* delta,
                                 int bh, int s, int d, int dtype, void* stream) {
  if (bh <= 0 || s <= 0) return (int)cudaSuccess;
  const long long rows = (long long)bh * s;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 128) return launch<__nv_bfloat16, 128>(o, dout, delta, rows, st);
  if (dtype == 1 && d == 64) return launch<__nv_bfloat16, 64>(o, dout, delta, rows, st);
  if (dtype == 0 && d == 128) return launch<float, 128>(o, dout, delta, rows, st);
  if (dtype == 0 && d == 64) return launch<float, 64>(o, dout, delta, rows, st);
  return (int)cudaErrorInvalidValue;
}
