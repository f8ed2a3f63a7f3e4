// Flash-attention forward for Hopper (sm_90a), CUDA C++: the causal
// kernel and the rectangular one (causal or not), instantiations of one
// template per body.
//
// Replaces two TPU kernels of kubeflow_tpu/ops/flash.py, both with the
// body _fwd_body:
//  - _fwd_kernel_compact (entry kftpu_flash_fwd): causal self-attention
//    over q, k, v laid out [BH, S, D];
//  - _fwd_kernel (entry kftpu_flash_fwd_rect): the rectangular grid, q
//    [BH, S_q, D] against k, v [BH, S_k, D], non-causal or causal with
//    the TPU kernels' top-left mask q_pos >= k_pos (no s_k - s_q offset).
//    It runs every full hop of ring flash attention.
// Both write O in the input dtype and lse = m + log l as a plain
// [BH, S_q] float32 array (-inf where a row saw no key).
//
// What it computes is _fwd_body's function, not its block schedule. The
// TPU walks a sequential grid over (i, j) block pairs — lower-triangular
// pairs from two lookup tables, or the whole rectangle with the blocks
// above the diagonal predicated off and their DMAs clamped
// (_clamp_j/_clamp_i) — carrying m, l and acc in VMEM scratch from step
// to step. Here one thread block owns one (bh, q tile) and loops over the
// key tiles: all of them when non-causal, up to the diagonal when
// causal. That loop bound replaces the tables, the predicate and the
// clamps, so there is no step cap, and the running m, l and acc stay in
// registers for the whole loop. Under the causal bound the heaviest q
// tiles (most key tiles) launch first to even out the triangle. Keys past
// S_k and rows past S_q are masked in the kernel, so no sequence length
// needs padding. The online softmax keeps _fwd_body's guards: corr = 0
// while m = -inf, p = 0 where s = -inf, l = 0 -> 1, lse = -inf for a row
// that saw no key; O is rounded once to the input dtype.
//
// What bounds it. At the serving shape (B=4, S=2048, H=8, D=128, bf16)
// causal attention is 4*BH*D*S(S+1)/2 = 3.4e10 FLOP against 67 MB of
// q/k/v/o traffic: ~500 FLOP per byte, above the H100's ~295 FLOP/byte
// bf16 ridge, so it is bound by operations; a full ring hop (S_q = S_k =
// 4096, non-causal) is ~2000 FLOP per byte, more so. The work has to go
// through the tensor cores (989 TFLOP/s bf16, against 67 TFLOP/s of
// float32 FMAs).
//
// Two bodies, chosen by the element type:
//
// bf16 (flash_fwd_tc, the main paths): both products on the tensor cores
// with wgmma. A block of 256 threads is two consumer warpgroups, each
// owning 64 of the block's 128 query rows. The q tile is loaded once by
// TMA and stays in shared memory; k and v stream through a ring of
// kStages 128-key tiles, each stage with a "full" mbarrier per operand
// (TMA completes it) and an "empty" mbarrier (every warp arrives after
// its last wgmma on the stage), so the copy of the next tiles is in
// flight while this tile's products run. All tiles use the 128-byte
// swizzle that TMA writes and the wgmma descriptors read, loaded through
// 3-D tensor maps over [BH, S, D], so rows past S read as zeros inside
// their own head. s = q.k^T is an SS wgmma (q and k K-major in shared
// memory, float32 accumulator in registers); the softmax runs on the
// accumulator, a row spread over the 4 lanes of a quad; O += p.v is an RS
// wgmma, p from registers (wgmma's accumulator layout is its A-fragment
// layout, so p needs no shuffle) and v read MN-major, so it needs no
// transposition on the way in. _fwd_body multiplies a float32 p by v; a
// p rounded once to bf16 carries 2^-9 relative error per term, more than
// the bf16 output gate allows where a row's output nearly cancels. So p
// is split into p_hi + p_lo, both bf16, and both go through the same
// accumulator: p keeps ~2^-17 of its precision, v is bf16 already, and
// the products are exact. That costs 1.5x the tensor-core work of one
// product pair; the bound stays the function's own 4 FLOP per unmasked
// pair per head dim, so this design tops out near 67% of it.
//
// float32 (flash_fwd_simt, the f32 checks): the first version's body,
// float32 FMAs on the CUDA cores. TF32 tensor cores would not hold the
// f32 checks' 5e-5 gate. Each thread holds a 4x8 tile of scores and a
// 4x(D/8) tile of the output in registers; the tiles sit in shared memory
// transposed (q^T, k^T, p^T) so the inner loops read contiguous vectors.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md has the
// table): at B=8, S=2048, H=8, D=128 causal the bf16 body takes 0.24 ms,
// 3.5x the 0.0695 ms bound, where the float32-FMA body took 3.24 ms on
// the same bf16 inputs; a ring hop (S_q = S_k = 4096, H=8, non-causal)
// takes 0.18 ms. What holds it is the serial chain inside a warpgroup
// (q.k^T, wait, softmax, p.v, wait) with two warpgroups an SM. Later
// work for the bf16 body: warp specialisation (a producer warp issuing
// the TMA loads, setmaxnreg moving registers to the consumers),
// persistent blocks, overlapping one tile's softmax with the next tile's
// q.k^T, and a TMA store epilogue.

#include <math.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

// -- bf16: wgmma, TMA and an mbarrier ring --------------------------------

namespace tc {

using namespace kftpu::hopper;

constexpr int kBQ = 128;          // query rows per block
constexpr int kBK = 128;          // keys per tile
constexpr int kStages = 2;        // k/v tiles in the ring
constexpr int kThreads = 2 * 128;  // two consumer warpgroups of 64 rows
constexpr int kWarps = kThreads / 32;
constexpr int kRowBytes = 128;    // one swizzled row: 64 bf16 columns

template <int D>
struct Layout {
  static constexpr int kColBlocks = D / 64;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;  // one stage of k (or v)
  static constexpr int kTileBytes = kQBytes + 2 * kStages * kKVBytes;
  // + the barriers (q, full k, full v, empty per stage) and the slack
  // that aligns the tiles to 1024 bytes.
  static constexpr int kBytes = kTileBytes + 8 * (1 + 3 * kStages) + 1024;
};

template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* k_map, const CUtensorMap* v_map,
                                        uint32_t sk, uint32_t sv, uint32_t full_k,
                                        uint32_t full_v, int k0, int bh) {
  using L = Layout<D>;
  mbar_expect_tx(full_k, L::kKVBytes);
#pragma unroll
  for (int c = 0; c < L::kColBlocks; ++c)
    tma_load_3d(sk + c * kBK * kRowBytes, k_map, full_k, c * 64, k0, bh);
  mbar_expect_tx(full_v, L::kKVBytes);
#pragma unroll
  for (int c = 0; c < L::kColBlocks; ++c)
    tma_load_3d(sv + c * kBK * kRowBytes, v_map, full_v, c * 64, k0, bh);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (D == 128) {
    wgmma_rs_m64n128k16_mn(o, a, desc_v);
  } else {
    wgmma_rs_m64n64k16_mn(o, a, desc_v);
  }
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// kRect = false: causal self-attention with S_k = S_q, fixed at compile
// time (the compact case; kCausal must be true). kRect = true: q [BH, S_q,
// D] against k, v [BH, S_k, D], with the top-left causal mask when
// kCausal. scale_log2 = log2(e) / sqrt(D): the softmax runs in base 2.
template <int D, bool kRect, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap q_map,
             const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
             float* __restrict__ lse, int Sq, int Sk_arg, float scale_log2) {
  static_assert(kRect || kCausal, "the compact case is causal");
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  using L = Layout<D>;
  constexpr int kOut = D / 2;  // accumulator registers of O per thread
  const float kNegInf = -INFINITY;
  const int Sk = kRect ? Sk_arg : Sq;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_k = s_q + L::kQBytes;  // stage st at + st * kKVBytes
  const uint32_t s_v = s_k + kStages * L::kKVBytes;
  const uint32_t bar_q = s_v + kStages * L::kKVBytes;
  const uint32_t full_k = bar_q + 8;  // stage st at + 8 * st
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty = full_v + 8 * kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int n_qtiles = (Sq + kBQ - 1) / kBQ;
  const int q0 = (kCausal ? n_qtiles - 1 - (int)blockIdx.x : (int)blockIdx.x) * kBQ;
  const int bh = blockIdx.y;
  // Causal loop bound: no row of this tile sees a key past its last row
  // (rows past S_q need none).
  const int k_end = kCausal ? min(Sk, min(Sq, q0 + kBQ)) : Sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty + 8 * st, kWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
    for (int c = 0; c < L::kColBlocks; ++c)
      tma_load_3d(s_q + c * kBQ * kRowBytes, &q_map, bar_q, c * 64, q0, bh);
    for (int t = 0; t < kStages && t < n_tiles; ++t)
      load_kv<D>(&k_map, &v_map, s_k + t * L::kKVBytes, s_v + t * L::kKVBytes,
                 full_k + 8 * t, full_v + 8 * t, t * kBK, bh);
  }

  // Accumulator layout (wgmma m64nN, float32): warp w of the warpgroup
  // holds rows 16w + lane/4 (+8), and register 4j + 2i + c is row
  // (lane/4 + 8i), column 8j + 2(lane%4) + c.
  const int row0 = q0 + wg * 64 + (tid / 32 % 4) * 16 + lane / 4;  // and row0 + 8
  const int col0 = 2 * (lane % 4);
  const int wg_first = q0 + wg * 64;
  const bool rows_live = wg_first < Sq;

  float acc[kOut];
#pragma unroll
  for (int x = 0; x < kOut; ++x) acc[x] = 0.f;
  float s[kBK / 2];
#pragma unroll
  for (int x = 0; x < kBK / 2; ++x) s[x] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // K-major operands: 8-row groups 1024 bytes apart. v is MN-major: its
  // 64-column blocks lie kBK rows apart, 8-key groups 1024 bytes apart.
  const uint64_t desc_q = smem_desc(s_q + wg * 64 * kRowBytes, 16, 1024);
  mbar_wait(bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const int k0 = t * kBK;
    // Every warp waits for both loads of every tile, working or not: so no
    // warp arrives on a stage's next round before this one has completed,
    // and no copy is still in flight when the block exits.
    mbar_wait(full_k + 8 * st, parity);
    mbar_wait(full_v + 8 * st, parity);
    // Tiles wholly above this warpgroup's diagonal, and warpgroups whose
    // rows all lie past S_q, skip the work but still release the stage.
    if (rows_live && !(kCausal && k0 > wg_first + 63)) {
      const uint64_t desc_k = smem_desc(s_k + st * L::kKVBytes, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < L::kColBlocks; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_m64n128k16(s, desc_q + ((c * kBQ * kRowBytes + kk * 32) >> 4),
                              desc_k + ((c * kBK * kRowBytes + kk * 32) >> 4),
                              (c | kk) != 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // Mask keys past S_k (TMA's zero fill gives s = 0, not -inf) and,
      // on tiles that cross the diagonal, keys past the row.
      if (k0 + kBK > Sk || (kCausal && k0 + kBK - 1 > wg_first)) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int k_pos = k0 + 8 * j + col0 + c;
              if (k_pos >= Sk || (kCausal && k_pos > row0 + 8 * i))
                s[4 * j + 2 * i + c] = kNegInf;
            }
      }

      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx * scale_log2);
        // Rows with every key masked so far keep m = -inf; exp(-inf - -inf)
        // is nan, so the correction needs the guard (p = exp2(-inf) = 0).
        const float safe_m = m_new == kNegInf ? 0.f : m_new;
        corr[i] = m[i] == kNegInf ? 0.f : exp2f(m[i] - safe_m);
        m[i] = m_new;
        float row_sum = 0.f;  // this thread's columns; the quad sums at the end
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f(fmaf(s[4 * j + 2 * i + c], scale_log2, -safe_m));
            s[4 * j + 2 * i + c] = p;
            row_sum += p;
          }
        l[i] = l[i] * corr[i] + row_sum;
      }
#pragma unroll
      for (int x = 0; x < kOut; ++x) acc[x] *= corr[(x >> 1) & 1];

      // p as wgmma A fragments, key step kt (keys 16kt..16kt+15): the
      // accumulator's registers 8kt..8kt+7 in order. p = hi + lo.
      uint32_t hi[kBK / 16][4], lo[kBK / 16][4];
#pragma unroll
      for (int kt = 0; kt < kBK / 16; ++kt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = s[8 * kt + 2 * r], b = s[8 * kt + 2 * r + 1];
          const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
          const float2 hf = __bfloat1622float2(h);
          hi[kt][r] = *reinterpret_cast<const uint32_t*>(&h);
          lo[kt][r] = bf16x2(a - hf.x, b - hf.y);
        }

      const uint64_t desc_v = smem_desc(s_v + st * L::kKVBytes, kBK * kRowBytes, 1024);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < kBK / 16; ++kt) {
        const uint64_t dv = desc_v + ((kt * 16 * kRowBytes) >> 4);
        wgmma_pv<D>(acc, hi[kt], dv);
        wgmma_pv<D>(acc, lo[kt], dv);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kt = 0; kt < kBK / 16; ++kt) {
        fence_regs(hi[kt]);
        fence_regs(lo[kt]);
      }
    }

    // Release the stage; thread 0 refills it once every warp is done.
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
    if (tid == 0 && t + kStages < n_tiles) {
      mbar_wait(empty + 8 * st, parity);
      load_kv<D>(&k_map, &v_map, s_k + st * L::kKVBytes, s_v + st * L::kKVBytes,
                 full_k + 8 * st, full_v + 8 * st, (t + kStages) * kBK, bh);
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const size_t head = (size_t)bh * Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q_pos = row0 + 8 * i;
    if (q_pos >= Sq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    __nv_bfloat16* out = o + (head + q_pos) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          bf16x2(acc[4 * j + 2 * i] / safe_l, acc[4 * j + 2 * i + 1] / safe_l);
    if (lane % 4 == 0)
      lse[head + q_pos] =
          m[i] == kNegInf ? kNegInf : m[i] * 0.6931471805599453f + logf(safe_l);
  }
}

template <int D, bool kRect, bool kCausal>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int sq,
           int sk, cudaStream_t stream) {
  // k and v may have no rows (S_k = 0): no tile is loaded then, and q
  // stands in for them so that the maps are well formed.
  const bool keys = sk > 0;
  CUtensorMap q_map, k_map, v_map;
  int err = encode_bf16_rows(&q_map, q, bh, sq, D, kBQ);
  if (!err) err = encode_bf16_rows(&k_map, keys ? k : q, bh, keys ? sk : sq, D, kBK);
  if (!err) err = encode_bf16_rows(&v_map, keys ? v : q, bh, keys ? sk : sq, D, kBK);
  if (err) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  return kftpu::launch_kernel(flash_fwd_tc<D, kRect, kCausal>, grid, kThreads,
                              (size_t)Layout<D>::kBytes, stream, q_map, k_map, v_map,
                              static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), sq,
                              sk, (float)(1.4426950408889634 / sqrt((double)D)));
}

}  // namespace tc

// -- float32: FMAs on the CUDA cores ----------------------------------------

namespace simt {

using kftpu::load4;
using kftpu::load8;
using kftpu::store8;

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kPad = 8;        // row padding of the transposed q/k tiles
constexpr int kPS = kBQ + 4;   // row stride of the transposed p tile
static_assert(kBQ == kBK, "load_tile copies 64-row tiles of q, k and v alike");

template <int D, bool kTranspose>
__device__ __forceinline__ void load_tile(const float* __restrict__ g, int row0, int S,
                                          float* sm, int stride) {
  kftpu::load_tile<float, D, kBQ, kThreads, kTranspose>(g, row0, S, sm, stride);
}

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)D * (kBQ + kPad) * sizeof(float)    // q^T
         + (size_t)D * (kBK + kPad) * sizeof(float)  // k^T
         + (size_t)kBK * D * sizeof(float)           // v
         + (size_t)kBK * kPS * sizeof(float);        // p^T
}

// kRect and kCausal as in tc::flash_fwd_tc.
template <int D, bool kRect, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, int Sq, int Sk_arg, float scale) {
  static_assert(kRect || kCausal, "the compact case is causal");
  const int Sk = kRect ? Sk_arg : Sq;
  constexpr int kQS = kBQ + kPad;
  constexpr int kKS = kBK + kPad;
  constexpr int kChunks = D / 64;  // 8-column output chunks per thread
  const float kNegInf = -INFINITY;

  extern __shared__ __align__(16) unsigned char smem[];
  float* sQT = reinterpret_cast<float*>(smem);
  float* sKT = sQT + D * kQS;
  float* sV = sKT + D * kKS;
  float* sPT = sV + kBK * D;

  const int n_tiles = (Sq + kBQ - 1) / kBQ;
  const int q0 = (n_tiles - 1 - (int)blockIdx.x) * kBQ;  // heaviest first
  const size_t q_head = (size_t)blockIdx.y * Sq * D;
  const size_t k_head = kRect ? (size_t)blockIdx.y * Sk * D : q_head;
  q += q_head;
  k += k_head;
  v += k_head;
  o += q_head;
  lse += (size_t)blockIdx.y * Sq;

  // Thread (rg, tc) owns score rows r0..r0+3 and, per 64-column chunk h,
  // columns h*64 + tc*8 .. +7: a row's 8 lanes are adjacent in one warp.
  const int tc = threadIdx.x & 7;
  const int r0 = (threadIdx.x >> 3) * 4;

  load_tile<D, true>(q, q0, Sq, sQT, kQS);

  float m[4], l[4], acc[4][kChunks * 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks * 8; ++c) acc[i][c] = 0.f;
  }

  // Causal loop bound: no row of this tile sees a key past its last row.
  const int k_end = kCausal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's k^T/v reads are done
    load_tile<D, true>(k, k0, Sk, sKT, kKS);
    load_tile<D, false>(v, k0, Sk, sV, D);
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
        const bool seen = (!kCausal || k_pos <= q_pos) && k_pos < Sk;
        const float x = seen ? s[i][j] * scale : kNegInf;
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
    if (q_pos >= Sq) continue;
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

template <int D, bool kRect, bool kCausal>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int sq,
           int sk, cudaStream_t stream) {
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  return kftpu::launch_kernel(
      flash_fwd_simt<D, kRect, kCausal>, grid, kThreads, smem_bytes<D>(), stream,
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), sq,
      sk, 1.0f / sqrtf((float)D));
}

}  // namespace simt

template <bool kRect, bool kCausal>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             int bh, int sq, int sk, int d, int dtype, cudaStream_t st) {
  if (dtype == 1 && d == 128)
    return tc::launch<128, kRect, kCausal>(q, k, v, o, lse, bh, sq, sk, st);
  if (dtype == 1 && d == 64)
    return tc::launch<64, kRect, kCausal>(q, k, v, o, lse, bh, sq, sk, st);
  if (dtype == 0 && d == 128)
    return simt::launch<128, kRect, kCausal>(q, k, v, o, lse, bh, sq, sk, st);
  if (dtype == 0 && d == 64)
    return simt::launch<64, kRect, kCausal>(q, k, v, o, lse, bh, sq, sk, st);
  return (int)cudaErrorInvalidValue;
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
  return dispatch<false, true>(q, k, v, o, lse, bh, s, s, d, dtype,
                               static_cast<cudaStream_t>(stream));
}

// The rectangular forward: q and o [bh, sq, d], k and v [bh, sk, d], lse
// [bh, sq] float32; causal != 0 masks k_pos > q_pos (top-left, no
// offset). Otherwise as kftpu_flash_fwd.
extern "C" int kftpu_flash_fwd_rect(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int bh,
                                    int sq, int sk, int d, int causal,
                                    int dtype, void* stream) {
  if (bh <= 0 || sq <= 0) return (int)cudaSuccess;
  if (bh > 65535 || sk < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (causal) return dispatch<true, true>(q, k, v, o, lse, bh, sq, sk, d, dtype, st);
  return dispatch<true, false>(q, k, v, o, lse, bh, sq, sk, d, dtype, st);
}

// Dynamic shared memory of one block of the kernel that runs for this
// head dim and dtype, in bytes (0 if there is none).
extern "C" int kftpu_flash_fwd_smem_bytes(int d, int dtype) {
  if (dtype == 1 && d == 128) return tc::Layout<128>::kBytes;
  if (dtype == 1 && d == 64) return tc::Layout<64>::kBytes;
  if (dtype == 0 && d == 128) return (int)simt::smem_bytes<128>();
  if (dtype == 0 && d == 64) return (int)simt::smem_bytes<64>();
  return 0;
}
