// Flash-attention backward, dq of the two-pass schedule, for Hopper
// (sm_90a), CUDA C++: the causal kernel and the rectangular one (causal
// or not), instantiations of one template.
//
// Replaces two TPU kernels of kubeflow_tpu/ops/flash.py, both with the
// body _dq_body:
//  - _dq_kernel_compact (entry kftpu_flash_bwd_dq): causal
//    self-attention, q, k, v, dO and dq [BH, S, D];
//  - _dq_kernel (entry kftpu_flash_bwd_dq_rect): the rectangular grid, q,
//    dO and dq [BH, S_q, D] against k, v [BH, S_k, D], non-causal or
//    causal with the top-left mask q_pos >= k_pos (no offset). It runs
//    in the backward of every full hop of ring flash attention.
// For each query row, dq = scale * sum over the keys the row sees of
// ds * k, where p = exp(s - lse) (0 where masked), dp = dO . v^T and
// ds = p * (dp - delta). lse and delta are [BH, S_q] float32 (delta from
// flash_delta.cu). dq is written in the input dtype.
//
// The TPU walks a sequential grid over block pairs (from a lookup table,
// or the whole rectangle with the blocks above the diagonal predicated
// off and their DMAs clamped) and carries dq in VMEM scratch. Here one
// thread block owns one (bh, 64-row q tile) and loops over the 64-key
// tiles — all of them when non-causal, up to the diagonal when causal —
// with its q and dO tiles resident in shared memory and dq in registers
// for the whole loop: nothing crosses blocks, so the result is
// deterministic, and it is the oracle for the fused kernel's atomics.
// Keys past S_k are masked in the kernel (k_pos < S_k); rows past S_q are
// zero-filled and never written, so no sequence length needs padding.
//
// What bounds it: three 64 x 64 x D products per tile pair (s = q.k^T,
// dp = dO.v^T, dq += ds.k), 6 FLOP per pair per head dim: about 1.0e11
// FLOP both at the training shape (B=8, S=2048, H=8, D=128, causal) and
// at a full ring hop (B=1, S_q = S_k = 4096, H=8, D=128, non-causal),
// against 168 and 42 MB of bf16 traffic: compute-bound. Like flash_fwd.cu
// it spends that compute on float32 FMAs on the CUDA cores, the closest
// match to the TPU kernel's float32 products; each thread holds a 4 x 8
// tile of s and of dp and a 4 x D/8 tile of dq, fed by 8- and 16-byte
// shared-memory loads from the transposed tiles. Tensor cores are later
// work.

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

// kRect = false: causal self-attention with S_k = S_q, fixed at compile
// time (the compact case; kCausal must be true). kRect = true: q, dO and dq
// [BH, S_q, D] against k, v [BH, S_k, D], with the top-left causal mask
// (q_pos >= k_pos, no offset) when kCausal.
template <typename T, int D, bool kRect, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int Sq, int Sk_arg,
                    float scale) {
  static_assert(kRect || kCausal, "the compact case is causal");
  const int Sk = kRect ? Sk_arg : Sq;
  constexpr int kChunks = D / 64;  // 8-column output chunks per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQT = reinterpret_cast<T*>(smem);
  T* sDoT = sQT + D * kQS;
  T* sKT = sDoT + D * kQS;
  T* sVT = sKT + D * kKS;
  T* sK = sVT + D * kKS;
  float* sDsT = reinterpret_cast<float*>(sK + kBK * D);

  const int n_tiles = (Sq + kBQ - 1) / kBQ;
  const int q0 = (n_tiles - 1 - (int)blockIdx.x) * kBQ;  // heaviest first
  const size_t q_head = (size_t)blockIdx.y * Sq * D;
  const size_t k_head = kRect ? (size_t)blockIdx.y * Sk * D : q_head;
  q += q_head;
  k += k_head;
  v += k_head;
  dout += q_head;
  dq += q_head;
  lse += (size_t)blockIdx.y * Sq;
  delta += (size_t)blockIdx.y * Sq;

  // Thread (rg, tc) owns rows r0..r0+3; keys tc*8..+7 of each score tile
  // and, per 64-column chunk h, dq columns h*64 + tc*8..+7.
  const int tc = threadIdx.x & 7;
  const int r0 = (threadIdx.x >> 3) * 4;

  kftpu::load_tile<T, D, kBQ, kThreads, true>(q, q0, Sq, sQT, kQS);
  kftpu::load_tile<T, D, kBQ, kThreads, true>(dout, q0, Sq, sDoT, kQS);

  float row_lse[4], row_delta[4], acc[4][kChunks * 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + r0 + i;
    // Rows past S_q have no lse; +inf makes their p exactly 0.
    row_lse[i] = q_pos < Sq ? lse[q_pos] : INFINITY;
    row_delta[i] = q_pos < Sq ? delta[q_pos] : 0.f;
#pragma unroll
    for (int c = 0; c < kChunks * 8; ++c) acc[i][c] = 0.f;
  }

  const int k_end = kCausal ? min(Sk, q0 + kBQ) : Sk;  // causal loop bound
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's reads are done
    kftpu::load_tile<T, D, kBK, kThreads, true>(k, k0, Sk, sKT, kKS);
    kftpu::load_tile<T, D, kBK, kThreads, true>(v, k0, Sk, sVT, kKS);
    kftpu::load_tile<T, D, kBK, kThreads, false>(k, k0, Sk, sK, D);
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
        const bool seen = (!kCausal || k_pos <= q_pos) && k_pos < Sk;
        const float p = seen ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
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
    if (q_pos >= Sq) continue;
#pragma unroll
    for (int h = 0; h < kChunks; ++h) {
      float out[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) out[x] = acc[i][h * 8 + x] * scale;
      store8(dq + (size_t)q_pos * D + h * 64 + tc * 8, out);
    }
  }
}

template <typename T, int D, bool kRect, bool kCausal>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int bh, int sq,
           int sk, cudaStream_t stream) {
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  return kftpu::launch_kernel(
      flash_bwd_dq_kernel<T, D, kRect, kCausal>, grid, kThreads,
      smem_bytes<T, D>(), stream, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), sq, sk,
      1.0f / sqrtf((float)D));
}

template <bool kRect, bool kCausal>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int bh, int sq,
             int sk, int d, int dtype, cudaStream_t st) {
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128, kRect, kCausal>(q, k, v, dout, lse, delta, dq, bh, sq, sk, st);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64, kRect, kCausal>(q, k, v, dout, lse, delta, dq, bh, sq, sk, st);
  if (dtype == 0 && d == 128)
    return launch<float, 128, kRect, kCausal>(q, k, v, dout, lse, delta, dq, bh, sq, sk, st);
  if (dtype == 0 && d == 64)
    return launch<float, 64, kRect, kCausal>(q, k, v, dout, lse, delta, dq, bh, sq, sk, st);
  return (int)cudaErrorInvalidValue;
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
  return dispatch<false, true>(q, k, v, dout, lse, delta, dq, bh, s, s, d,
                               dtype, static_cast<cudaStream_t>(stream));
}

// The rectangular dq: q, dout and dq [bh, sq, d], k and v [bh, sk, d],
// lse and delta [bh, sq] float32; causal != 0 masks k_pos > q_pos
// (top-left, no offset). Otherwise as kftpu_flash_bwd_dq.
extern "C" int kftpu_flash_bwd_dq_rect(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, int bh, int sq, int sk, int d,
                                       int causal, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0) return (int)cudaSuccess;
  if (bh > 65535 || sk < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (causal)
    return dispatch<true, true>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, dtype, st);
  return dispatch<true, false>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, dtype, st);
}
