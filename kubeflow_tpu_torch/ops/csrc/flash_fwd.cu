// Causal flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel kubeflow_tpu/ops/flash.py:_fwd_kernel_compact
// (body _fwd_body): causal self-attention over q, k, v laid out
// [BH, S, D], writing O in the input dtype and lse = m + log l as a
// plain [BH, S] float32 array (-inf where a row saw no key).
//
// What it computes is _fwd_body's function, not its block schedule. The
// TPU walks a sequential grid over lower-triangular (i, j) block pairs
// read from two lookup tables, carrying m, l and acc in VMEM scratch
// from step to step. Here one thread block owns one (bh, 64-row q tile)
// and loops over the 64-key tiles up to the diagonal: the causal loop
// bound replaces the tables, so there is no step cap, and the running
// m, l and acc stay in registers for the whole loop. Keys past S are
// masked in the kernel (k_pos < S), so no sequence length needs padding.
//
// Numerics follow _fwd_body: s = (q.k) * (1/sqrt(d)) and p.v in float32
// on float32 copies of the bf16/f32 inputs; the online softmax with its
// guards (corr = 0 while m = -inf, p = 0 where s = -inf); O = acc / (l or
// 1), rounded once to the input dtype.
//
// What bounds it. At the serving shape (B=4, S=2048, H=8, D=128, bf16)
// causal attention is 4*BH*D*S(S+1)/2 = 3.4e10 FLOP against 67 MB of
// q/k/v/o traffic: ~500 FLOP per byte, above the H100's ~295 FLOP/byte
// ridge, so it is compute-bound. This first version spends that compute
// on float32 FMAs in the CUDA cores (67 TFLOP/s peak), the closest match
// to the TPU kernel's float32 products, and not on the bf16 tensor cores
// (989 TFLOP/s): its floor is ~15x the tensor-core bound. The design
// keeps the FMA units fed rather than the memory: each thread holds a
// 4x8 tile of scores and a 4x(D/8) tile of the output in registers, so
// one 8-byte q load and one 16-byte k load feed 32 FMAs, and every q/k/v
// element is read from device memory once per tile that needs it. The
// tiles sit in shared memory transposed (q^T, k^T, p^T) so that the
// inner loops read contiguous 8- and 16-byte vectors without bank
// conflicts. Heaviest q tiles (most key tiles) launch first to even out
// the causal triangle. Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py): 1.87 ms at the serving shape, 18.4 TFLOP/s, against a
// 0.035 ms tensor-core bound. Tensor cores (mma/wgmma on bf16 tiles), TMA
// loads and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kPad = 8;        // row padding of the transposed q/k tiles
constexpr int kPS = kBQ + 4;   // row stride of the transposed p tile
static_assert(kBQ == kBK, "load_tile copies 64-row tiles of q, k and v alike");

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

// Copies rows [row0, row0 + 64) of a row-major [S, D] array into shared
// memory, 16 bytes per thread per step, zero-filling rows at or past S.
// kTranspose stores element (r, c) at sm[c * stride + r], else at
// sm[r * stride + c].
template <typename T, int D, bool kTranspose>
__device__ __forceinline__ void load_tile(const T* __restrict__ g, int row0,
                                          int S, T* sm, int stride) {
  constexpr int kElems = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int kChunksPerRow = D / kElems;
  for (int c = threadIdx.x; c < kBQ * kChunksPerRow; c += kThreads) {
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

template <typename T, int D>
constexpr size_t smem_bytes() {
  return (size_t)D * (kBQ + kPad) * sizeof(T)    // q^T
         + (size_t)D * (kBK + kPad) * sizeof(T)  // k^T
         + (size_t)kBK * D * sizeof(T)           // v
         + (size_t)kBK * kPS * sizeof(float);    // p^T
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, float scale) {
  constexpr int kQS = kBQ + kPad;
  constexpr int kKS = kBK + kPad;
  constexpr int kChunks = D / 64;  // 8-column output chunks per thread
  const float kNegInf = -INFINITY;

  extern __shared__ __align__(16) unsigned char smem[];
  T* sQT = reinterpret_cast<T*>(smem);
  T* sKT = sQT + D * kQS;
  T* sV = sKT + D * kKS;
  float* sPT = reinterpret_cast<float*>(sV + kBK * D);

  const int n_tiles = (S + kBQ - 1) / kBQ;
  const int q0 = (n_tiles - 1 - (int)blockIdx.x) * kBQ;  // heaviest first
  const size_t head = (size_t)blockIdx.y * S * D;
  q += head;
  k += head;
  v += head;
  o += head;
  lse += (size_t)blockIdx.y * S;

  // Thread (rg, tc) owns score rows r0..r0+3 and, per 64-column chunk h,
  // columns h*64 + tc*8 .. +7: a row's 8 lanes are adjacent in one warp.
  const int tc = threadIdx.x & 7;
  const int r0 = (threadIdx.x >> 3) * 4;

  load_tile<T, D, true>(q, q0, S, sQT, kQS);

  float m[4], l[4], acc[4][kChunks * 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks * 8; ++c) acc[i][c] = 0.f;
  }

  // Causal loop bound: no row of this tile sees a key past its last row.
  const int k_end = min(S, q0 + kBQ);
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's k^T/v reads are done
    load_tile<T, D, true>(k, k0, S, sKT, kKS);
    load_tile<T, D, false>(v, k0, S, sV, D);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float qv[4], kv[8];
      load4(sQT + kk * kQS + r0, qv);
      load8(sKT + kk * kKS + tc * 8, kv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k_pos = k0 + tc * 8 + j;
        const float x = (k_pos <= q_pos && k_pos < S) ? s[i][j] * scale : kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      // Rows with every key masked so far keep m = -inf; exp(-inf - -inf)
      // is nan, so the correction and p both need the guard.
      const float safe_m = m_new == kNegInf ? 0.f : m_new;
      const float corr = m[i] == kNegInf ? 0.f : expf(m[i] - safe_m);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = s[i][j] == kNegInf ? 0.f : expf(s[i][j] - safe_m);
        sPT[(tc * 8 + j) * kPS + r0 + i] = p;
        row_sum += p;
      }
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
      row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 4);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kChunks * 8; ++c) acc[i][c] *= corr;
    }
    // A row group reads back only the p rows its own lanes wrote, and the
    // group lives in one warp.
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
      load4(sPT + c * kPS + r0, pv);
#pragma unroll
      for (int h = 0; h < kChunks; ++h) {
        float vv[8];
        load8(sV + c * D + h * 64 + tc * 8, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int x = 0; x < 8; ++x)
            acc[i][h * 8 + x] = fmaf(pv[i], vv[x], acc[i][h * 8 + x]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + r0 + i;
    if (q_pos >= S) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int h = 0; h < kChunks; ++h) {
      float out[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) out[x] = acc[i][h * 8 + x] / safe_l;
      store8(o + (size_t)q_pos * D + h * 64 + tc * 8, out);
    }
    if (tc == 0) lse[q_pos] = m[i] == kNegInf ? kNegInf : m[i] + logf(safe_l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int s, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + kBQ - 1) / kBQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      s, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. d: 64 or 128. Pointers are device
// pointers to contiguous [bh, s, d] arrays (lse: [bh, s] float32), each
// 16-byte aligned; stream is a cudaStream_t. Returns a cudaError_t.
extern "C" int kftpu_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int bh, int s, int d,
                               int dtype, void* stream) {
  if (bh <= 0 || s <= 0) return (int)cudaSuccess;
  if (bh > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 128) return launch<__nv_bfloat16, 128>(q, k, v, o, lse, bh, s, st);
  if (dtype == 1 && d == 64) return launch<__nv_bfloat16, 64>(q, k, v, o, lse, bh, s, st);
  if (dtype == 0 && d == 128) return launch<float, 128>(q, k, v, o, lse, bh, s, st);
  if (dtype == 0 && d == 64) return launch<float, 64>(q, k, v, o, lse, bh, s, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kftpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
