// Causal flash-attention backward, dq of the two-pass schedule, for
// Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel kubeflow_tpu/ops/flash.py:_dq_kernel_compact
// (body _dq_body): for each query row, dq = scale * sum over keys k_pos <=
// q_pos of ds * k, where p = exp(s - lse) (0 where masked), dp = dO . v^T
// and ds = p * (dp - delta). q, k, v, dO and dq are [BH, S, D] in the
// input dtype; lse and delta are [BH, S] float32 (delta from
// flash_delta.cu). dq is written in the input dtype.
//
// The TPU walks a sequential grid over the lower-triangular block pairs
// of a lookup table and carries dq in VMEM scratch. Here one thread block
// owns one (bh, 64-row q tile) and loops over the 64-key tiles up to the
// diagonal, with its q and dO tiles resident in shared memory and dq in
// registers for the whole loop: nothing crosses blocks, so the result is
// deterministic, and it is the oracle for the fused kernel's atomics.
// Keys past S are masked in the kernel (k_pos < S); rows past S are
// zero-filled and never written, so no sequence length needs padding.
//
// What bounds it: three 64 x 64 x D products per tile pair (s = q.k^T,
// dp = dO.v^T, dq += ds.k), 6 FLOP per causal pair per head dim: about
// 1.0e11 FLOP at the training shape (B=8, S=2048, H=8, D=128), against
// 84 MB of traffic: compute-bound. Like flash_fwd.cu it spends that
// compute on float32 FMAs on the CUDA cores, the closest match to the TPU
// kernel's float32 products; each thread holds a 4 x 8 tile of s and of
// dp and a 4 x D/8 tile of dq, fed by 8- and 16-byte shared-memory loads
// from the transposed tiles. Tensor cores are later work.

#include <math.h>

#include "flash_common.cuh"

namespace {

using kftpu::load4;
using kftpu::load8;
using kftpu::store8;

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kPad = 8;        // row padding of the transposed tiles
constexpr int kQS = kBQ + kPad;
constexpr int kKS = kBK + kPad;
constexpr int kPS = kBQ + 4;   // row stride of the transposed ds tile

template <typename T, int D>
constexpr size_t smem_bytes() {
  return 2 * (size_t)D * kQS * sizeof(T)    // q^T, dO^T
         + 2 * (size_t)D * kKS * sizeof(T)  // k^T, v^T
         + (size_t)kBK * D * sizeof(T)      // k
         + (size_t)kBK * kPS * sizeof(float);  // ds^T
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int S, float scale) {
  constexpr int kChunks = D / 64;  // 8-column output chunks per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQT = reinterpret_cast<T*>(smem);
  T* sDoT = sQT + D * kQS;
  T* sKT = sDoT + D * kQS;
  T* sVT = sKT + D * kKS;
  T* sK = sVT + D * kKS;
  float* sDsT = reinterpret_cast<float*>(sK + kBK * D);

  const int n_tiles = (S + kBQ - 1) / kBQ;
  const int q0 = (n_tiles - 1 - (int)blockIdx.x) * kBQ;  // heaviest first
  const size_t head = (size_t)blockIdx.y * S * D;
  q += head;
  k += head;
  v += head;
  dout += head;
  dq += head;
  lse += (size_t)blockIdx.y * S;
  delta += (size_t)blockIdx.y * S;

  // Thread (rg, tc) owns rows r0..r0+3; keys tc*8..+7 of each score tile
  // and, per 64-column chunk h, dq columns h*64 + tc*8..+7.
  const int tc = threadIdx.x & 7;
  const int r0 = (threadIdx.x >> 3) * 4;

  kftpu::load_tile<T, D, kBQ, kThreads, true>(q, q0, S, sQT, kQS);
  kftpu::load_tile<T, D, kBQ, kThreads, true>(dout, q0, S, sDoT, kQS);

  float row_lse[4], row_delta[4], acc[4][kChunks * 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + r0 + i;
    // Rows past S have no lse; +inf makes their p exactly 0.
    row_lse[i] = q_pos < S ? lse[q_pos] : INFINITY;
    row_delta[i] = q_pos < S ? delta[q_pos] : 0.f;
#pragma unroll
    for (int c = 0; c < kChunks * 8; ++c) acc[i][c] = 0.f;
  }

  const int k_end = min(S, q0 + kBQ);  // causal loop bound
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's reads are done
    kftpu::load_tile<T, D, kBK, kThreads, true>(k, k0, S, sKT, kKS);
    kftpu::load_tile<T, D, kBK, kThreads, true>(v, k0, S, sVT, kKS);
    kftpu::load_tile<T, D, kBK, kThreads, false>(k, k0, S, sK, D);
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float qv[4], dov[4], kv[8], vv[8];
      load4(sQT + kk * kQS + r0, qv);
      load4(sDoT + kk * kQS + r0, dov);
      load8(sKT + kk * kKS + tc * 8, kv);
      load8(sVT + kk * kKS + tc * 8, vv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + r0 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k_pos = k0 + tc * 8 + j;
        const float p = (k_pos <= q_pos && k_pos < S)
                            ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        sDsT[(tc * 8 + j) * kPS + r0 + i] = p * (dp[i][j] - row_delta[i]);
      }
    }
    // A row group reads back only the ds rows its own lanes wrote, and
    // the group lives in one warp.
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float dsv[4];
      load4(sDsT + c * kPS + r0, dsv);
#pragma unroll
      for (int h = 0; h < kChunks; ++h) {
        float kv[8];
        load8(sK + c * D + h * 64 + tc * 8, kv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int x = 0; x < 8; ++x)
            acc[i][h * 8 + x] = fmaf(dsv[i], kv[x], acc[i][h * 8 + x]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + r0 + i;
    if (q_pos >= S) continue;
#pragma unroll
    for (int h = 0; h < kChunks; ++h) {
      float out[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) out[x] = acc[i][h * 8 + x] * scale;
      store8(dq + (size_t)q_pos * D + h * 64 + tc * 8, out);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int bh, int s,
           cudaStream_t stream) {
  const dim3 grid((s + kBQ - 1) / kBQ, bh);
  return kftpu::launch_kernel(
      flash_bwd_dq_kernel<T, D>, grid, kThreads, smem_bytes<T, D>(), stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), s, 1.0f / sqrtf((float)D));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. d: 64 or 128. q, k, v, dout, dq are
// device pointers to contiguous [bh, s, d] arrays, 16-byte aligned; lse
// and delta are [bh, s] float32. Returns a cudaError_t.
extern "C" int kftpu_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dq, int bh, int s,
                                  int d, int dtype, void* stream) {
  if (bh <= 0 || s <= 0) return (int)cudaSuccess;
  if (bh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, bh, s, st);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, bh, s, st);
  if (dtype == 0 && d == 128) return launch<float, 128>(q, k, v, dout, lse, delta, dq, bh, s, st);
  if (dtype == 0 && d == 64) return launch<float, 64>(q, k, v, dout, lse, delta, dq, bh, s, st);
  return (int)cudaErrorInvalidValue;
}
