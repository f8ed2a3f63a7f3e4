// Causal flash-attention backward for Hopper (sm_90a), CUDA C++: dk and
// dv of the two-pass schedule, and the fused one-pass dq/dk/dv.
//
// Replaces two TPU kernels of kubeflow_tpu/ops/flash.py:
//  - _dkv_kernel_compact (body _dkv_body): for each key, dv = sum over
//    query rows q_pos >= k_pos of p * dO and dk = scale * sum of ds * q,
//    with p = exp(s - lse) (0 where masked), dp = dO . v^T and
//    ds = p * (dp - delta);
//  - _dqkv_kernel_fused: the same column walk, which also hands each
//    step's dq contribution ds . k to dq, so s, p and ds are computed once
//    for all three gradients (5 tile products a step instead of the
//    two-pass schedule's 7).
// q, k, v, dO and the gradients are [BH, S, D] in the input dtype; lse
// and delta are [BH, S] float32 (delta from flash_delta.cu).
//
// The TPU runs the triangle column-major on a sequential grid, so its
// fused kernel keeps dq in a VMEM ring and seeds it with a store at
// column 0. Here one thread block owns one (bh, 32-key tile), holds that
// tile's k^T and v^T in shared memory and its dk and dv in registers, and
// loops over the 64-row q tiles from the diagonal down. Blocks of one
// head run at once, so in the fused kernel every block adds its dq
// contribution into a zeroed [BH, S, D] float32 buffer with float32
// atomicAdd; a last pass scales that buffer and casts it to dq. The sum's
// order, and so its last bits, changes from run to run; the two-pass
// kernels (this one with kFused = false, and flash_bwd_dq.cu) are
// deterministic and are its oracle. Keys and rows past S are masked in
// the kernel, so no sequence length needs padding.
//
// What bounds it: 8 FLOP per causal pair per head dim for dk/dv (s, dp,
// dv, dk products), 10 for the fused kernel (plus dq): 1.4e11 and 1.7e11
// FLOP at the training shape (B=8, S=2048, H=8, D=128) against ~100 MB of
// traffic, so compute-bound, spent on float32 FMAs on the CUDA cores as in
// flash_fwd.cu. A 32-key tile keeps dk and dv (2 x 2 x D/8 floats a
// thread) in registers beside the 2 x 8 tiles of s and dp; a 64-key tile
// would need twice that. The fused kernel's atomics add 64 x D float32
// values per step into L2, as 16-byte vector reductions (1.4e8 at the
// training shape); scalar atomics made it 18% slower (13.72 against
// 11.67 ms in two runs of chip_smoke.py on an H100 80GB HBM3 at 700 W,
// in which the unchanged two-pass kernels held at 4.90-4.91 and
// 8.57-8.61 ms).

#include <math.h>

#include "flash_common.cuh"

namespace {

using kftpu::load2;
using kftpu::load4;
using kftpu::load8;
using kftpu::store8;

constexpr int kBK = 32;        // keys per block
constexpr int kBQ = 64;        // query rows per step
constexpr int kThreads = 128;  // 16 key pairs (or row groups) x 8 lanes
constexpr int kPad = 8;        // row padding of the transposed tiles
constexpr int kKS = kBK + kPad;
constexpr int kQS = kBQ + kPad;
constexpr int kPS = kBQ + 4;   // row stride of the transposed p and ds tiles

template <typename T, int D, bool kFused>
constexpr size_t smem_bytes() {
  return 2 * (size_t)D * kKS * sizeof(T)        // k^T, v^T
         + 2 * (size_t)D * kQS * sizeof(T)      // q^T, dO^T
         + 2 * (size_t)kBQ * D * sizeof(T)      // q, dO
         + 2 * (size_t)kBK * kPS * sizeof(float)  // p^T, ds^T
         + 2 * (size_t)kBQ * sizeof(float)      // lse, delta rows
         + (kFused ? (size_t)kBK * D * sizeof(T) : 0);  // k
}

template <typename T, int D, bool kFused>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ dq_acc, int S,
                     float scale) {
  constexpr int kChunks = D / 64;  // 8-column output chunks per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* sKT = reinterpret_cast<T*>(smem);
  T* sVT = sKT + D * kKS;
  T* sQT = sVT + D * kKS;
  T* sDoT = sQT + D * kQS;
  T* sQ = sDoT + D * kQS;
  T* sDo = sQ + kBQ * D;
  float* sPT = reinterpret_cast<float*>(sDo + kBQ * D);
  float* sDsT = sPT + kBK * kPS;
  float* sLse = sDsT + kBK * kPS;
  float* sDelta = sLse + kBQ;
  T* sK = reinterpret_cast<T*>(sDelta + kBQ);  // kFused only

  const int k0 = blockIdx.x * kBK;  // heaviest (longest column) first
  const size_t head = (size_t)blockIdx.y * S * D;
  q += head;
  k += head;
  v += head;
  dout += head;
  dk += head;
  dv += head;
  lse += (size_t)blockIdx.y * S;
  delta += (size_t)blockIdx.y * S;

  // Score tiles are held transposed, s^T[key][row]: thread (kp, tc) owns
  // keys kr..kr+1 and rows tc*8..+7 of each q tile, and, per 64-column
  // chunk h, dk/dv columns h*64 + tc*8..+7 of its two keys.
  const int tc = threadIdx.x & 7;
  const int kr = (threadIdx.x >> 3) * 2;

  kftpu::load_tile<T, D, kBK, kThreads, true>(k, k0, S, sKT, kKS);
  kftpu::load_tile<T, D, kBK, kThreads, true>(v, k0, S, sVT, kKS);
  if (kFused) kftpu::load_tile<T, D, kBK, kThreads, false>(k, k0, S, sK, D);

  float dk_acc[2][kChunks * 8], dv_acc[2][kChunks * 8];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int c = 0; c < kChunks * 8; ++c) dk_acc[x][c] = dv_acc[x][c] = 0.f;

  // Rows above this tile's first key see none of its keys.
  for (int q0 = (k0 / kBQ) * kBQ; q0 < S; q0 += kBQ) {
    __syncthreads();  // the previous step's reads are done
    kftpu::load_tile<T, D, kBQ, kThreads, true>(q, q0, S, sQT, kQS);
    kftpu::load_tile<T, D, kBQ, kThreads, true>(dout, q0, S, sDoT, kQS);
    kftpu::load_tile<T, D, kBQ, kThreads, false>(q, q0, S, sQ, D);
    kftpu::load_tile<T, D, kBQ, kThreads, false>(dout, q0, S, sDo, D);
    for (int r = threadIdx.x; r < kBQ; r += kThreads) {
      const int q_pos = q0 + r;
      // Rows past S have no lse; +inf makes their p exactly 0.
      sLse[r] = q_pos < S ? lse[q_pos] : INFINITY;
      sDelta[r] = q_pos < S ? delta[q_pos] : 0.f;
    }
    __syncthreads();

    float st[2][8], dpt[2][8];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int j = 0; j < 8; ++j) st[x][j] = dpt[x][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float kv[2], vv[2], qv[8], dov[8];
      load2(sKT + c * kKS + kr, kv);
      load2(sVT + c * kKS + kr, vv);
      load8(sQT + c * kQS + tc * 8, qv);
      load8(sDoT + c * kQS + tc * 8, dov);
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          st[x][j] = fmaf(kv[x], qv[j], st[x][j]);
          dpt[x][j] = fmaf(vv[x], dov[j], dpt[x][j]);
        }
    }

#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int k_pos = k0 + kr + x;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = tc * 8 + j;
        const float p = (q0 + r >= k_pos && k_pos < S)
                            ? expf(st[x][j] * scale - sLse[r]) : 0.f;
        sPT[(kr + x) * kPS + r] = p;
        sDsT[(kr + x) * kPS + r] = p * (dpt[x][j] - sDelta[r]);
      }
    }
    // dk and dv of keys kr..kr+1 read the p and ds rows that the 8 lanes
    // of this key pair wrote, all in one warp; the fused dq reads every
    // key's, hence the block barrier.
    if (kFused) {
      __syncthreads();
    } else {
      __syncwarp();
    }

#pragma unroll 4
    for (int r = 0; r < kBQ; ++r) {
      const float p0 = sPT[kr * kPS + r], p1 = sPT[(kr + 1) * kPS + r];
      const float ds0 = sDsT[kr * kPS + r], ds1 = sDsT[(kr + 1) * kPS + r];
#pragma unroll
      for (int h = 0; h < kChunks; ++h) {
        float dov[8], qv[8];
        load8(sDo + r * D + h * 64 + tc * 8, dov);
        load8(sQ + r * D + h * 64 + tc * 8, qv);
#pragma unroll
        for (int y = 0; y < 8; ++y) {
          dv_acc[0][h * 8 + y] = fmaf(p0, dov[y], dv_acc[0][h * 8 + y]);
          dv_acc[1][h * 8 + y] = fmaf(p1, dov[y], dv_acc[1][h * 8 + y]);
          dk_acc[0][h * 8 + y] = fmaf(ds0, qv[y], dk_acc[0][h * 8 + y]);
          dk_acc[1][h * 8 + y] = fmaf(ds1, qv[y], dk_acc[1][h * 8 + y]);
        }
      }
    }

    if (kFused) {
      // dq[row] += ds[row][key] . k[key]: thread (rg, tc) adds rows
      // r0..r0+3, columns h*64 + tc*8..+7, over this tile's 32 keys.
      const int r0 = (threadIdx.x >> 3) * 4;
      float* dq_rows = dq_acc + head + (size_t)q0 * D;
#pragma unroll
      for (int h = 0; h < kChunks; ++h) {
        float part[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int y = 0; y < 8; ++y) part[i][y] = 0.f;
#pragma unroll 4
        for (int c = 0; c < kBK; ++c) {
          float dsv[4], kv[8];
          load4(sDsT + c * kPS + r0, dsv);
          load8(sK + c * D + h * 64 + tc * 8, kv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int y = 0; y < 8; ++y) part[i][y] = fmaf(dsv[i], kv[y], part[i][y]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (q0 + r0 + i >= S) continue;
          float* dst = dq_rows + (size_t)(r0 + i) * D + h * 64 + tc * 8;
          // One 16-byte reduction per 4 columns (sm_90's vector
          // atomicAdd on global memory): a quarter of the atomic ops.
          atomicAdd(reinterpret_cast<float4*>(dst),
                    make_float4(part[i][0], part[i][1], part[i][2], part[i][3]));
          atomicAdd(reinterpret_cast<float4*>(dst + 4),
                    make_float4(part[i][4], part[i][5], part[i][6], part[i][7]));
        }
      }
    }
  }

#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int k_pos = k0 + kr + x;
    if (k_pos >= S) continue;
#pragma unroll
    for (int h = 0; h < kChunks; ++h) {
      float outk[8], outv[8];
#pragma unroll
      for (int y = 0; y < 8; ++y) {
        outk[y] = dk_acc[x][h * 8 + y] * scale;
        outv[y] = dv_acc[x][h * 8 + y];
      }
      store8(dk + (size_t)k_pos * D + h * 64 + tc * 8, outk);
      store8(dv + (size_t)k_pos * D + h * 64 + tc * 8, outv);
    }
  }
}

// dq = scale * dq_acc, rounded to the input dtype, 8 elements a thread.
template <typename T>
__global__ void __launch_bounds__(256)
flash_dq_scale_kernel(const float* __restrict__ dq_acc, T* __restrict__ dq,
                      long long n8, float scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  float f[8];
  load8(dq_acc + i * 8, f);
#pragma unroll
  for (int y = 0; y < 8; ++y) f[y] *= scale;
  store8(dq + i * 8, f);
}

template <typename T, int D, bool kFused>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv,
           float* dq_acc, int bh, int s, cudaStream_t stream) {
  const dim3 grid((s + kBK - 1) / kBK, bh);
  return kftpu::launch_kernel(
      flash_bwd_dkv_kernel<T, D, kFused>, grid, kThreads,
      smem_bytes<T, D, kFused>(), stream, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), dq_acc, s, 1.0f / sqrtf((float)D));
}

template <typename T, int D>
int launch_fused(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, void* dk,
                 void* dv, void* dq_acc, int bh, int s, cudaStream_t stream) {
  const long long n = (long long)bh * s * D;
  float* acc = static_cast<float*>(dq_acc);
  cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)n * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  const int rc = launch<T, D, true>(q, k, v, dout, lse, delta, dk, dv, acc, bh, s, stream);
  if (rc) return rc;
  const long long n8 = n / 8;
  return kftpu::launch_kernel(flash_dq_scale_kernel<T>,
                              dim3((unsigned)((n8 + 255) / 256)), 256, 0, stream,
                              static_cast<const float*>(acc), static_cast<T*>(dq),
                              n8, 1.0f / sqrtf((float)D));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. d: 64 or 128. q, k, v, dout, dk, dv
// are device pointers to contiguous [bh, s, d] arrays, 16-byte aligned;
// lse and delta are [bh, s] float32. Returns a cudaError_t.
extern "C" int kftpu_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv,
                                   int bh, int s, int d, int dtype,
                                   void* stream) {
  if (bh <= 0 || s <= 0) return (int)cudaSuccess;
  if (bh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128, false>(q, k, v, dout, lse, delta, dk, dv, nullptr, bh, s, st);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64, false>(q, k, v, dout, lse, delta, dk, dv, nullptr, bh, s, st);
  if (dtype == 0 && d == 128)
    return launch<float, 128, false>(q, k, v, dout, lse, delta, dk, dv, nullptr, bh, s, st);
  if (dtype == 0 && d == 64)
    return launch<float, 64, false>(q, k, v, dout, lse, delta, dk, dv, nullptr, bh, s, st);
  return (int)cudaErrorInvalidValue;
}

// As kftpu_flash_bwd_dkv, and also dq ([bh, s, d], input dtype), through
// dq_acc: a [bh, s, d] float32 scratch array that this call zeroes.
extern "C" int kftpu_flash_bwd_fused(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse,
                                     const void* delta, void* dq, void* dk,
                                     void* dv, void* dq_acc, int bh, int s,
                                     int d, int dtype, void* stream) {
  if (bh <= 0 || s <= 0) return (int)cudaSuccess;
  if (bh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 128)
    return launch_fused<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc, bh, s, st);
  if (dtype == 1 && d == 64)
    return launch_fused<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc, bh, s, st);
  if (dtype == 0 && d == 128)
    return launch_fused<float, 128>(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc, bh, s, st);
  if (dtype == 0 && d == 64)
    return launch_fused<float, 64>(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc, bh, s, st);
  return (int)cudaErrorInvalidValue;
}
