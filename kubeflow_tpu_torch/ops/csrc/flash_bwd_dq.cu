// Flash-attention backward, dq of the two-pass schedule, for Hopper
// (sm_90a), CUDA C++: the causal kernel and the rectangular one (causal
// or not), instantiations of one template per body.
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
// thread block owns one (bh, q tile) and loops over the key tiles — all
// of them when non-causal, up to the diagonal when causal, the longest
// walks launched first — with its q and dO tiles resident in shared
// memory and dq in registers for the whole loop: nothing crosses blocks,
// so dq adds in a fixed order and repeats bitwise. Keys past S_k are
// masked in the kernel (k_pos < S_k); rows past S_q are zero-filled and
// never written, so no sequence length needs padding.
//
// What bounds it: three products per tile pair (s = q.k^T, dp = dO.v^T,
// dq += ds.k), 6 FLOP per unmasked pair per head dim: 1.03e11 FLOP both
// at the training shape (B=8, S=2048, H=8, D=128, causal) and at a full
// ring hop (B=1, S_q = S_k = 4096, H=8, D=128, non-causal), against 168
// and 42 MB of bf16 traffic: bound by operations. The work has to go
// through the tensor cores (989 TFLOP/s bf16, against 67 TFLOP/s of
// float32 FMAs).
//
// Two bodies, chosen at compile time by the element type and the entry:
//
// bf16 rectangular dq (flash_bwd_dq_tc, the ring's full hops): every
// product on the tensor cores with wgmma, in the forward's shape
// (flash_fwd.cu, namespace tc). A block of 256 threads is two consumer
// warpgroups, each owning 64 of the block's 128 query rows (wgmma's M).
// q and dO are loaded once by TMA through 3-D tensor maps over [BH, S_q,
// D] with the 128-byte swizzle, so rows past S_q read as zeros inside
// their own head; k and v stream in 64-key tiles through a 2-stage ring,
// each stage with a "full" mbarrier per operand (TMA completes it) and an
// "empty" one (every warp arrives after its last wgmma on the stage), so
// the next tile's copy is in flight while this tile's products run.
// s = q.k^T and dp = dO.v^T are SS wgmmas (q, dO as A and k, v as B, all
// K-major); p, ds = p * (dp - delta) and the masks run on the
// accumulators, each row's lse and delta held in registers for the whole
// walk; dq += ds.k is an RS wgmma, ds from registers (wgmma's accumulator
// layout is its A-fragment layout) and k read MN-major from the same
// swizzled tile, so each k tile serves both of its products and nothing
// is transposed.
//
// Precision: as in flash_bwd_dkv.cu's tensor-core body, and for the same
// two reasons. ds rounded once to bf16 carries 2^-9 of relative error
// per term, so it goes through the product as three bf16 terms (hi + mid
// + lo, ~2^-27); k is bf16 already, so the products are exact. And dq's
// sum runs over every key (16384 keys at the long rect shape): summed in
// one wgmma accumulator it would drift as dk did in the dk/dv kernel's
// first version, so each key tile's product goes into a zeroed
// accumulator and is then added to the running dq with float32 adds
// (tests/test_torch_flash_bwd.py emulates both measures). That costs
// 5/3 of the function's tensor-core work (s and dp once, dq three
// times); the bound stays the function's own 6 FLOP per unmasked pair
// per head dim. Registers at D = 128: the running dq 64 a thread, s and
// dp 32 each, the ds terms 48 and the tile accumulator 64.
//
// Causality and ragged edges: the causal walk ends at min(S_k, q0 + 128);
// only tiles that cross a warpgroup's diagonal, and the tile that holds
// S_k, mask element by element (rows past S_q get lse = +inf, so p = 0).
// A warpgroup with no work on a tile (all its rows past S_q, or above the
// tile's first key) still waits for the tile's loads and releases it, so
// no copy is in flight when the block exits. No atomics: dq·scale is
// rounded to bf16 and stored once.
//
// float32, and the bf16 compact dq (flash_bwd_dq_simt): float32 FMAs on
// the CUDA cores; TF32 would not hold the f32 checks' 5e-5 gate. One
// block of 128 threads owns a 64-row q tile; each thread holds a 4 x 8
// tile of s and dp and a 4 x D/8 tile of dq, fed from transposed copies
// of q, dO, k and v in shared memory. The tensor-core body takes kRect as
// a template parameter, so moving the compact bf16 dq onto it is a
// dispatch switch.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md has the
// table): at the ring hop shape the bf16 tensor-core body takes 0.26 ms,
// 394 TFLOP/s of the function's work, 2.5x its 0.104 ms bound and 0.73x
// SDPA's whole backward, where the CUDA-core body took 4.60 ms; ptxas
// gives it 208 registers at D = 128 (causal 240) and no spills. The
// compact bf16 dq, still on the CUDA cores, takes 4.45 ms at the training
// shape. What holds the tensor-core body is the serial chain in each
// warpgroup (s and dp, wait, p and ds, the dq product, wait, the float32
// adds) with two warpgroups an SM; warp specialisation and overlapping one
// tile's ds math with the next tile's products are later work.

#include <math.h>

#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

// -- bf16 rectangular: wgmma, TMA and an mbarrier k/v ring --------------------

namespace tc {

using namespace kftpu::hopper;

constexpr int kBQ = 128;          // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kStages = 2;        // k/v tiles in the ring
constexpr int kThreads = 2 * 128;  // two consumer warpgroups of 64 rows
constexpr int kWarps = kThreads / 32;
constexpr int kRowBytes = 128;    // one swizzled row: 64 bf16 columns

template <int D>
struct Layout {
  static constexpr int kColBlocks = D / 64;
  static constexpr int kQBytes = kBQ * D * 2;   // q (or dO)
  static constexpr int kKVBytes = kBK * D * 2;  // one stage of k (or v)
  static constexpr int kTileBytes = 2 * kQBytes + 2 * kStages * kKVBytes;
  // + the barriers (q/dO, full k, full v, empty per stage) and the slack
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

// acc[64 rows x kBK keys] = A . B^T over D: A this warpgroup's 64 rows of
// q (or dO), B one stage's k (or v), both K-major.
template <int D>
__device__ __forceinline__ void wgmma_rows_keys(float (&acc)[kBK / 2], uint64_t desc_a,
                                                uint64_t desc_b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_m64n64k16<0, 0>(acc, desc_a + ((c * kBQ * kRowBytes + kk * 32) >> 4),
                               desc_b + ((c * kBK * kRowBytes + kk * 32) >> 4), (c | kk) != 0);
}

// kRect = false: causal self-attention with S_k = S_q, fixed at compile
// time (the compact case; kCausal must be true). kRect = true: q, dO and
// dq [BH, S_q, D] against k, v [BH, S_k, D], with the top-left causal
// mask when kCausal. scale_log2 = log2(e) * scale: p runs in base 2.
template <int D, bool kRect, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tc(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Sq,
                int Sk_arg, float scale, float scale_log2) {
  static_assert(kRect || kCausal, "the compact case is causal");
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  using L = Layout<D>;
  constexpr int kOut = D / 2;  // accumulator registers of dq per thread
  constexpr int kS = kBK / 2;  // of s (or dp)
  constexpr float kLog2e = 1.4426950408889634f;
  const int Sk = kRect ? Sk_arg : Sq;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_do = s_q + L::kQBytes;
  const uint32_t s_k = s_do + L::kQBytes;  // stage st at + st * kKVBytes
  const uint32_t s_v = s_k + kStages * L::kKVBytes;
  const uint32_t bar_q = s_v + kStages * L::kKVBytes;
  const uint32_t full_k = bar_q + 8;  // stage st at + 8 * st
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty = full_v + 8 * kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int n_qtiles = (Sq + kBQ - 1) / kBQ;
  const kftpu::TileHead at = kftpu::tile_head(n_qtiles);
  const int q0 = (kCausal ? n_qtiles - 1 - at.tile : at.tile) * kBQ;  // heaviest first
  const int bh = at.bh;
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
    mbar_expect_tx(bar_q, 2 * L::kQBytes);
#pragma unroll
    for (int c = 0; c < L::kColBlocks; ++c) {
      tma_load_3d(s_q + c * kBQ * kRowBytes, &q_map, bar_q, c * 64, q0, bh);
      tma_load_3d(s_do + c * kBQ * kRowBytes, &do_map, bar_q, c * 64, q0, bh);
    }
    for (int t = 0; t < kStages && t < n_tiles; ++t)
      load_kv<D>(&k_map, &v_map, s_k + t * L::kKVBytes, s_v + t * L::kKVBytes,
                 full_k + 8 * t, full_v + 8 * t, t * kBK, bh);
  }

  // Accumulator layout (wgmma m64nN, float32): warp w of the warpgroup
  // holds rows 16w + lane/4 (+8), and register 4j + 2i + c is row
  // (lane/4 + 8i), column 8j + 2(lane%4) + c. Rows are q rows; columns
  // are keys (s, dp) or head dims (dq).
  const int row0 = q0 + wg * 64 + (tid / 32 % 4) * 16 + lane / 4;  // and row0 + 8
  const int col0 = 2 * (lane % 4);
  const int wg_first = q0 + wg * 64;
  const bool rows_live = wg_first < Sq;

  // lse (base 2) and delta of this thread's two rows, for the whole walk;
  // rows past S_q get lse = +inf, so their p is 0.
  float lse2[2], dl[2];
  const size_t head = (size_t)bh * Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q_pos = row0 + 8 * i;
    lse2[i] = q_pos < Sq ? lse[head + q_pos] * kLog2e : INFINITY;
    dl[i] = q_pos < Sq ? delta[head + q_pos] : 0.f;
  }

  float dq_acc[kOut];
#pragma unroll
  for (int x = 0; x < kOut; ++x) dq_acc[x] = 0.f;

  // K-major operands: 8-row groups 1024 bytes apart. k as dq's MN-major
  // B: its 64-column blocks lie kBK rows apart, 8-key groups 1024 bytes
  // apart.
  const uint64_t desc_q = smem_desc(s_q + wg * 64 * kRowBytes, 16, 1024);
  const uint64_t desc_do = smem_desc(s_do + wg * 64 * kRowBytes, 16, 1024);
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
      const uint32_t sk = s_k + st * L::kKVBytes;
      // Declared per tile, so s and dp die once ds is split (the wgmmas
      // read their accumulators, so registers kept across the loop would
      // stay live through the dq product).
      float s[kS], dp[kS];
#pragma unroll
      for (int x = 0; x < kS; ++x) s[x] = dp[x] = 0.f;
      wgmma_fence();
      wgmma_rows_keys<D>(s, desc_q, smem_desc(sk, 16, 1024));
      wgmma_commit();
      wgmma_rows_keys<D>(dp, desc_do, smem_desc(s_v + st * L::kKVBytes, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // p in place; keys past S_k (TMA's zero fill gives s = 0) and, on
      // tiles that cross this warpgroup's diagonal, keys past the row get
      // p = 0.
      const bool edge = k0 + kBK > Sk || (kCausal && k0 + kBK - 1 > wg_first);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int x = 4 * j + 2 * i + c;
            float p = exp2f(fmaf(s[x], scale_log2, -lse2[i]));
            if (edge) {
              const int k_pos = k0 + 8 * j + col0 + c;
              if (k_pos >= Sk || (kCausal && k_pos > row0 + 8 * i)) p = 0.f;
            }
            s[x] = p;
          }
      wgmma_wait<0>();
      fence_regs(dp);

      // ds = p (dp - delta) as three bf16 terms, wgmma A fragments (key
      // step kt, keys 16kt..16kt+15: the accumulator's registers
      // 8kt..8kt+7 in order; register 8kt + 2r is row lane/4 + 8(r & 1)).
      uint32_t a[kTerms][kBK / 16][4];
#pragma unroll
      for (int kt = 0; kt < kBK / 16; ++kt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int x = 8 * kt + 2 * r;
          const float d = dl[r & 1];
          uint32_t t3[kTerms];
          split3(s[x] * (dp[x] - d), s[x + 1] * (dp[x + 1] - d), t3);
#pragma unroll
          for (int i = 0; i < kTerms; ++i) a[i][kt][r] = t3[i];
        }

      // dq += ds.k: this tile's product into a zeroed accumulator (terms
      // smallest first), then added to the running dq with float32 adds,
      // so the long sum over key tiles rounds to nearest. k is MN-major.
      float tmp[kOut];
#pragma unroll
      for (int x = 0; x < kOut; ++x) tmp[x] = 0.f;
      const uint64_t desc_kb = smem_desc(sk, kBK * kRowBytes, 1024);
      fence_regs(tmp);
      wgmma_fence();
#pragma unroll
      for (int i = kTerms - 1; i >= 0; --i)
#pragma unroll
        for (int kt = 0; kt < kBK / 16; ++kt)
          wgmma_rs_mn<D>(tmp, a[i][kt], desc_kb + ((kt * 16 * kRowBytes) >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(tmp);
#pragma unroll
      for (int i = 0; i < kTerms; ++i)
#pragma unroll
        for (int kt = 0; kt < kBK / 16; ++kt) fence_regs(a[i][kt]);
#pragma unroll
      for (int x = 0; x < kOut; ++x) dq_acc[x] += tmp[x];
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
    const int q_pos = row0 + 8 * i;
    if (q_pos >= Sq) continue;
    __nv_bfloat16* out = dq + (head + q_pos) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          bf16x2(dq_acc[4 * j + 2 * i] * scale, dq_acc[4 * j + 2 * i + 1] * scale);
  }
}

template <int D, bool kRect, bool kCausal>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int bh, int sq, int sk, cudaStream_t stream) {
  // k and v may have no rows (S_k = 0): no tile is loaded then, and q
  // stands in for them so that the maps are well formed.
  const bool keys = sk > 0;
  CUtensorMap q_map, k_map, v_map, do_map;
  int err = encode_bf16_rows(&q_map, q, bh, sq, D, kBQ);
  if (!err) err = encode_bf16_rows(&do_map, dout, bh, sq, D, kBQ);
  if (!err) err = encode_bf16_rows(&k_map, keys ? k : q, bh, keys ? sk : sq, D, kBK);
  if (!err) err = encode_bf16_rows(&v_map, keys ? v : q, bh, keys ? sk : sq, D, kBK);
  if (err) return err;
  const dim3 grid = kftpu::fold_grid((sq + kBQ - 1) / kBQ, bh);
  return kftpu::launch_kernel(
      flash_bwd_dq_tc<D, kRect, kCausal>, grid, kThreads, (size_t)Layout<D>::kBytes, stream,
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), sq, sk,
      1.0f / sqrtf((float)D), (float)(1.4426950408889634 / sqrt((double)D)));
}

}  // namespace tc

// -- float32 and the bf16 compact dq: FMAs on the CUDA cores ------------------

namespace simt {

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

// kRect and kCausal as in tc::flash_bwd_dq_tc.
template <typename T, int D, bool kRect, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_simt(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dq, int Sq, int Sk_arg, float scale) {
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
  const kftpu::TileHead at = kftpu::tile_head(n_tiles);
  const int q0 = (n_tiles - 1 - at.tile) * kBQ;  // heaviest first
  const size_t q_head = (size_t)at.bh * Sq * D;
  const size_t k_head = kRect ? (size_t)at.bh * Sk * D : q_head;
  q += q_head;
  k += k_head;
  v += k_head;
  dout += q_head;
  dq += q_head;
  lse += (size_t)at.bh * Sq;
  delta += (size_t)at.bh * Sq;

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
  const dim3 grid = kftpu::fold_grid((sq + kBQ - 1) / kBQ, bh);
  return kftpu::launch_kernel(
      flash_bwd_dq_simt<T, D, kRect, kCausal>, grid, kThreads,
      smem_bytes<T, D>(), stream, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), sq, sk,
      1.0f / sqrtf((float)D));
}

}  // namespace simt

using bf16 = __nv_bfloat16;

// The bf16 rectangular dq on the tensor cores; f32, and the bf16 compact
// dq, on the CUDA cores.
template <typename T, int D, bool kRect, bool kCausal>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int sq, int sk,
              cudaStream_t st) {
  if constexpr (kRect && std::is_same<T, bf16>::value)
    return tc::launch<D, kRect, kCausal>(q, k, v, dout, lse, delta, dq, bh, sq, sk, st);
  else
    return simt::launch<T, D, kRect, kCausal>(q, k, v, dout, lse, delta, dq, bh, sq, sk, st);
}

template <bool kRect, bool kCausal>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int bh, int sq,
             int sk, int d, int dtype, cudaStream_t st) {
  if (dtype == 1 && d == 128)
    return launch_dq<bf16, 128, kRect, kCausal>(q, k, v, dout, lse, delta, dq, bh, sq, sk, st);
  if (dtype == 1 && d == 64)
    return launch_dq<bf16, 64, kRect, kCausal>(q, k, v, dout, lse, delta, dq, bh, sq, sk, st);
  if (dtype == 0 && d == 128)
    return launch_dq<float, 128, kRect, kCausal>(q, k, v, dout, lse, delta, dq, bh, sq, sk, st);
  if (dtype == 0 && d == 64)
    return launch_dq<float, 64, kRect, kCausal>(q, k, v, dout, lse, delta, dq, bh, sq, sk, st);
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
  if (sk < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (causal)
    return dispatch<true, true>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, dtype, st);
  return dispatch<true, false>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d, dtype, st);
}

// Dynamic shared memory of one block, in bytes, for head dim d: of the
// tensor-core body (tensor_cores != 0; bf16) or of the CUDA-core body in
// this dtype; 0 if there is none.
extern "C" int kftpu_flash_bwd_dq_smem_bytes(int d, int dtype, int tensor_cores) {
  if (tensor_cores) {
    if (dtype != 1) return 0;
    if (d == 128) return tc::Layout<128>::kBytes;
    if (d == 64) return tc::Layout<64>::kBytes;
    return 0;
  }
  if (dtype == 1 && d == 128) return (int)simt::smem_bytes<bf16, 128>();
  if (dtype == 1 && d == 64) return (int)simt::smem_bytes<bf16, 64>();
  if (dtype == 0 && d == 128) return (int)simt::smem_bytes<float, 128>();
  if (dtype == 0 && d == 64) return (int)simt::smem_bytes<float, 64>();
  return 0;
}
