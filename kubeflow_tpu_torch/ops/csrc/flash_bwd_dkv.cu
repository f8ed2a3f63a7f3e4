// Flash-attention backward for Hopper (sm_90a), CUDA C++: dk and dv of
// the two-pass schedule (causal and rectangular), and the fused one-pass
// dq/dk/dv.
//
// Replaces three TPU kernels of kubeflow_tpu/ops/flash.py:
//  - _dkv_kernel (body _dkv_body; entry kftpu_flash_bwd_dkv_rect): the
//    rectangular grid, q and dO [BH, S_q, D] against k, v, dk and dv
//    [BH, S_k, D], every query row when non-causal, the rows with
//    q_pos >= k_pos (top-left, no offset) when causal. It runs in the
//    backward of every full hop of ring flash attention;
//  - _dqkv_kernel_fused (entry kftpu_flash_bwd_fused): causal self-
//    attention in one pass, which also hands each step's dq contribution
//    ds . k to dq, so s, p and ds are computed once for all three
//    gradients (5 tile products a step instead of the two-pass
//    schedule's 7);
//  - _dkv_kernel_compact (body _dkv_body; entry kftpu_flash_bwd_dkv):
//    causal self-attention, dk and dv of the two-pass schedule.
// For each key, dv = sum over the query rows that see it of p * dO and
// dk = scale * sum of ds * q, with p = exp(s * scale - lse) (0 where
// masked), dp = dO . v^T and ds = p * (dp - delta); the fused kernel
// also gives dq = scale * sum over keys of ds * k. The gradients are in
// the input dtype; lse and delta are [BH, S_q] float32, the q side's
// (delta from flash_delta.cu).
//
// The TPU runs its grid column-major and in order, so its fused kernel
// keeps dq in a VMEM ring and seeds it with a store at column 0, and its
// rectangular kernel predicates off the blocks above the diagonal and
// clamps their DMAs. Here one thread block owns one (bh, key tile),
// holds that tile's k and v in shared memory and its dk and dv in
// registers, and loops over the q tiles: from the diagonal down when
// causal (that start replaces the predicate and the clamps), all of
// them when not; the blocks with the longest walk launch first. Blocks
// of one head run at once, so the fused kernel adds its dq contributions
// into a zeroed [BH, S, D] float32 buffer with vector atomics, and a
// last pass scales that buffer and casts it to dq. The sum's order, and
// so dq's last bits, changes from run to run; its oracle is the plain
// version (flash_bwd_fused_reference in ops/flash.py), and the two-pass
// kernels (flash_bwd_dq.cu and the dk/dv here) add in a fixed order and
// repeat bitwise, so KFTPU_FLASH_FUSED_BWD=0 pins a deterministic
// backward. Keys past S_k and rows past S_q are masked in the kernel, so
// no sequence length needs padding.
//
// What bounds it: 8 FLOP per unmasked pair per head dim for dk/dv (the
// s, dp, dv and dk products), 10 for the fused kernel (plus dq):
// 1.37e11 FLOP for dk/dv at a full ring hop (B=1, S_q = S_k = 4096,
// H=8, D=128, non-causal) against 50 MB of bf16 traffic, and 1.72e11
// for the fused kernel at the training shape (B=8, S=2048, H=8, D=128,
// causal) against 235 MB: some 2700 and 730 FLOP per byte, far above
// the H100's ~295 bf16 ridge, so bound by operations. The work has to
// go through the tensor cores (989 TFLOP/s bf16, against 67 TFLOP/s of
// float32 FMAs on the CUDA cores).
//
// Two bodies, chosen at compile time by the element type and the entry:
//
// bf16 dk/dv, rectangular and compact, and bf16 fused (flash_bwd_tc):
// every product on the tensor cores with wgmma. A block of 256 threads
// is two consumer warpgroups, each owning 64 of the block's 128 keys
// (wgmma's M). k and v are loaded once by TMA through 3-D tensor maps
// over [BH, S_k, D] with the 128-byte swizzle, so rows past S_k read as
// zeros inside their own head; q and dO stream through a 2-stage ring of
// 64-row tiles in their natural [S_q, D] layout, each stage with a
// "full" mbarrier per operand (TMA completes it) and an "empty" one
// (every warp arrives after its last wgmma on the stage), so the next
// tile's copy is in flight while this tile's products run. One copy of
// each tile serves both of its products, so nothing is transposed on
// the way in: s^T = k.q^T and dp^T = v.dO^T are SS wgmmas (k, v as A
// and q, dO as B, all K-major); dv += p^T.dO is an RS wgmma, p^T from
// the accumulator registers (wgmma's accumulator layout is its
// A-fragment layout) and dO read MN-major. ds^T goes to shared memory
// as bf16, [key][q row] with the 128-byte swizzle, and that one copy is
// the K-major A of dk += ds^T.q (an SS wgmma, q MN-major) and, in the
// fused kernel, the MN-major A of dq = ds.k: after a named barrier each
// warpgroup runs that product over all 128 keys of the block for 64 of
// the head dims (D = 64: warpgroup 0 for all 64), k MN-major, and adds it
// to dq_acc with 8-byte vector atomics, 64 x D float32 adds per 128 keys
// and 64 rows, a quarter of what a 32-key tile issued. A second named
// barrier keeps the next tile's ds^T from overwriting one a dq product
// still reads. lse and delta of a thread's columns come from global
// memory while the s^T and dp^T products run.
//
// Precision. The bf16 gradient gate (atol 5e-5 x RMS, rtol 2^-7 against
// the plain version) is a float32-level gate, and two things the tensor
// cores would do break it on the long sums:
//  - a p or ds rounded once to bf16 carries 2^-9 of relative error per
//    term, and hi + lo (the forward's split) still 2^-18: at S_q = 16384
//    that moves dv past the gate where a sum nearly cancels
//    (tests/test_torch_flash_bwd.py emulates the forms). So p and ds are
//    split into hi + mid + lo, three bf16 terms that keep ~2^-27, and
//    all three go through the products; q, dO and k are bf16 already, so
//    the products are exact;
//  - summing a long chain of products in the wgmma accumulator (2048
//    accumulations per element at S_q = 16384) drifted dk to 1.4x the
//    gate on the card, where the same sums rounded to nearest held it.
//    So each tile's dv (and dk) product goes into a zeroed accumulator,
//    64 head dims at a time (32 registers), and is added to the running
//    dk and dv with float32 adds.
// That costs 2x the tensor-core work of the function's dk/dv products
// (s^T and dp^T once, dv and dk three times) and 2.2x of the fused
// kernel's; the bound stays the function's own 8 and 10 FLOP per
// unmasked pair per head dim. Registers: dk and dv take 2 x D/2 float32
// a thread, s^T and dp^T 2 x 32, the p fragments 48 and the tile
// accumulator 32; ds^T leaves the registers for shared memory before
// the p fragments are built.
//
// Causality and ragged edges: the causal walk starts at the q tile that
// holds the block's first key; only tiles that cross a warpgroup's
// diagonal, and the block that holds S_k, mask element by element (rows
// past S_q get lse = +inf, so p = 0). A warpgroup with nothing to do on
// a tile (all its keys past the tile's rows, or past S_k) still waits
// for the tile's loads and releases it, so no arrival races the next
// phase and no copy is in flight when the block exits.
//
// float32 (simt::flash_bwd_dkv_kernel): float32 FMAs on the CUDA cores;
// TF32 would not hold the f32 checks' 5e-5 gate. One block owns a 32-key
// tile, holds k^T and v^T in shared memory and loops over the 64-row q
// tiles, copying q and dO in twice (transposed for s and dp, row-major
// for dk and dv).
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md has the
// table): the rectangular dk/dv at the hop shape takes 0.59-0.61 ms, 4.3x
// its 0.139 ms bound and 1.7x SDPA's whole backward, where the CUDA-core
// body took 7.76 ms; the compact dk/dv at the training shape 0.75 ms, 5.4x
// its 0.139 ms bound and 1.3x SDPA's backward, where it took 8.5 ms; the
// fused kernel there 1.23 ms with its memset and scale pass, 7.1x its
// 0.174 ms bound and 2.2x SDPA's backward, where it took 11.67 ms. A
// 64-key block (one warpgroup, 512 blocks at the hop shape) took 0.97 ms
// there, so the block stays at 128 keys: it reads each q/dO tile once for
// twice the keys (PERF.md has the measurement). At D = 128 the body sits
// at the 255 register cap and spills 72-132 bytes a thread. What holds it is the
// serial chain in each warpgroup: s^T and dp^T, wait, p and ds, then
// four tile products, each waited on before its float32 adds, with two
// warpgroups an SM. Later work: warp specialisation (a producer warp
// issuing the TMA loads, setmaxnreg moving registers to the consumers),
// overlapping one tile's p/ds math and adds with the next tile's
// products, persistent blocks that even out the causal triangle, TMA's
// bulk reduce-add for dq, and a TMA store epilogue.

#include <math.h>

#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

// -- bf16: wgmma, TMA and an mbarrier q/dO ring -------------------------------

namespace tc {

using namespace kftpu::hopper;

constexpr int kBQ = 64;          // query rows per ring tile (s^T is m64n64)
constexpr int kStages = 2;       // q/dO tiles in the ring
constexpr int kRowBytes = 128;   // one swizzled row: 64 bf16 columns
constexpr int kWGKeys = 64;      // keys per consumer warpgroup (wgmma's M)
constexpr int kBK = 2 * kWGKeys; // keys per block: two consumer warpgroups
constexpr int kThreads = 256;

template <int D>
struct Layout {
  static constexpr int kColBlocks = D / 64;
  static constexpr int kKVBytes = kBK * D * 2;    // the block's k (or v)
  static constexpr int kQBytes = kBQ * D * 2;     // one stage of q (or dO)
  static constexpr int kDsBytes = kBK * kBQ * 2;  // one term of ds^T
  static constexpr int kTileBytes = 2 * kKVBytes + 2 * kStages * kQBytes + kTerms * kDsBytes;
  // + the barriers (k/v, then full q, full dO and empty per stage) and the
  // slack that aligns the tiles to 1024 bytes.
  static constexpr int kBytes = kTileBytes + 8 * (1 + 3 * kStages) + 1024;
};

template <int D>
__device__ __forceinline__ void load_rows(const CUtensorMap* q_map, const CUtensorMap* do_map,
                                          uint32_t sq, uint32_t sdo, uint32_t full_q,
                                          uint32_t full_do, int q0, int bh) {
  constexpr int kBytes = kBQ * D * 2;
  mbar_expect_tx(full_q, kBytes);
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_3d(sq + c * kBQ * kRowBytes, q_map, full_q, c * 64, q0, bh);
  mbar_expect_tx(full_do, kBytes);
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_3d(sdo + c * kBQ * kRowBytes, do_map, full_do, c * 64, q0, bh);
}

// kRect = false: causal self-attention with S_k = S_q, fixed at compile
// time (the fused kernel; kCausal must be true). kRect = true: q and dO
// [BH, S_q, D] against k, v, dk, dv [BH, S_k, D], with the top-left
// causal mask (q_pos >= k_pos, no offset) when kCausal. kFused also adds
// dq / scale into dq_acc. scale_log2 = log2(e) * scale: p runs in base 2.
template <int D, bool kRect, bool kCausal, bool kFused>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tc(const __grid_constant__ CUtensorMap q_map,
             const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map,
             const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
             const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
             __nv_bfloat16* __restrict__ dv, float* __restrict__ dq_acc, int Sq,
             int Sk_arg, float scale, float scale_log2) {
  static_assert(!(kRect && kFused), "the fused kernel walks the causal triangle");
  static_assert(kRect || kCausal, "the compact case is causal");
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  using L = Layout<D>;
  constexpr int kAcc = D / 2;  // accumulator registers of dk (or dv) per thread
  constexpr int kS = kBQ / 2;  // of s^T (or dp^T)
  constexpr float kLog2e = 1.4426950408889634f;
  const int Sk = kRect ? Sk_arg : Sq;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t s_k = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t s_v = s_k + L::kKVBytes;
  const uint32_t s_q = s_v + L::kKVBytes;  // stage st at + st * kQBytes
  const uint32_t s_do = s_q + kStages * L::kQBytes;
  const uint32_t s_ds = s_do + kStages * L::kQBytes;  // term i at + i * kDsBytes
  const uint32_t bar_kv = s_ds + kTerms * L::kDsBytes;
  const uint32_t full_q = bar_kv + 8;  // stage st at + 8 * st
  const uint32_t full_do = full_q + 8 * kStages;
  const uint32_t empty = full_do + 8 * kStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const kftpu::TileHead at = kftpu::tile_head((Sk + kBK - 1) / kBK);
  const int k0 = at.tile * kBK;  // heaviest (longest causal walk) first
  const int bh = at.bh;
  // Causal: rows above the block's first key see none of its keys.
  const int q_first = kCausal ? (k0 / kBQ) * kBQ : 0;
  const int n_tiles = Sq > q_first ? (Sq - q_first + kBQ - 1) / kBQ : 0;
  lse += (size_t)bh * Sq;
  delta += (size_t)bh * Sq;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_q + 8 * st, 1);
      mbar_init(full_do + 8 * st, 1);
      mbar_init(empty + 8 * st, kThreads / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * L::kKVBytes);
#pragma unroll
    for (int c = 0; c < L::kColBlocks; ++c) {
      tma_load_3d(s_k + c * kBK * kRowBytes, &k_map, bar_kv, c * 64, k0, bh);
      tma_load_3d(s_v + c * kBK * kRowBytes, &v_map, bar_kv, c * 64, k0, bh);
    }
    for (int t = 0; t < kStages && t < n_tiles; ++t)
      load_rows<D>(&q_map, &do_map, s_q + t * L::kQBytes, s_do + t * L::kQBytes,
                   full_q + 8 * t, full_do + 8 * t, q_first + t * kBQ, bh);
  }

  // Accumulator layout (wgmma m64nN, float32): warp w of the warpgroup
  // holds rows 16w + lane/4 (+8), and register 4j + 2i + c is row
  // (lane/4 + 8i), column 8j + 2(lane%4) + c. Rows are this warpgroup's
  // keys; columns are q rows (s^T, dp^T) or head dims (dk, dv).
  const int kw0 = k0 + wg * kWGKeys;
  const int key0 = kw0 + (warp % 4) * 16 + lane / 4;  // and key0 + 8
  const int col0 = 2 * (lane % 4);
  // Whether warpgroup w has work on the q tile at q0: keys before S_k,
  // and (causal) a row of the tile at or past its first key. The live
  // warpgroups are a prefix of the block.
  auto live = [&](int w, int q0) {
    const int kw = k0 + w * kWGKeys;
    return kw < Sk && !(kCausal && q0 + kBQ - 1 < kw);
  };

  float dk_acc[kAcc], dv_acc[kAcc], s[kS], dp[kS];
#pragma unroll
  for (int x = 0; x < kAcc; ++x) dk_acc[x] = dv_acc[x] = 0.f;
#pragma unroll
  for (int x = 0; x < kS; ++x) s[x] = dp[x] = 0.f;

  // K-major operands: 8-row groups 1024 bytes apart, this warpgroup's 64
  // keys 64 rows into each 64-column block.
  const uint64_t desc_k = smem_desc(s_k + wg * kWGKeys * kRowBytes, 16, 1024);
  const uint64_t desc_v = smem_desc(s_v + wg * kWGKeys * kRowBytes, 16, 1024);
  mbar_wait(bar_kv, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const int q0 = q_first + t * kBQ;
    const uint32_t sq = s_q + st * L::kQBytes;
    const uint32_t sdo = s_do + st * L::kQBytes;
    // Fused: both warpgroups' dq products of the previous tile are done
    // reading ds^T.
    if (kFused && t > 0) named_bar_sync(1, kThreads);
    // Every warp waits for both loads of every tile, working or not.
    mbar_wait(full_q + 8 * st, parity);
    mbar_wait(full_do + 8 * st, parity);

    if (live(wg, q0)) {
      const uint64_t desc_q = smem_desc(sq, 16, 1024);
      const uint64_t desc_do = smem_desc(sdo, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < L::kColBlocks; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_m64n64k16<0, 0>(s, desc_k + ((c * kBK * kRowBytes + kk * 32) >> 4),
                                   desc_q + ((c * kBQ * kRowBytes + kk * 32) >> 4), (c | kk) != 0);
      wgmma_commit();
#pragma unroll
      for (int c = 0; c < L::kColBlocks; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_m64n64k16<0, 0>(dp, desc_v + ((c * kBK * kRowBytes + kk * 32) >> 4),
                                   desc_do + ((c * kBQ * kRowBytes + kk * 32) >> 4), (c | kk) != 0);
      wgmma_commit();
      // lse (base 2) of this thread's columns, loaded while the products
      // run; rows past S_q get lse = +inf, so their p is 0.
      float lse2[kBQ / 4];
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int q_pos = q0 + 8 * j + col0 + c;
          lse2[2 * j + c] = q_pos < Sq ? lse[q_pos] * kLog2e : INFINITY;
        }
      wgmma_wait<1>();
      fence_regs(s);

      // p in place; keys past S_k (TMA's zero fill gives s = 0) and, on
      // tiles that cross this warpgroup's diagonal, keys past the row get
      // p = 0.
      const bool edge = kw0 + kWGKeys > Sk || (kCausal && q0 < kw0 + kWGKeys - 1);
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int x = 4 * j + 2 * i + c;
            float p = exp2f(fmaf(s[x], scale_log2, -lse2[2 * j + c]));
            if (edge) {
              const int k_pos = key0 + 8 * i;
              if (k_pos >= Sk || (kCausal && q0 + 8 * j + col0 + c < k_pos)) p = 0.f;
            }
            s[x] = p;
          }
      float dl[kBQ / 4];
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int q_pos = q0 + 8 * j + col0 + c;
          dl[2 * j + c] = q_pos < Sq ? delta[q_pos] : 0.f;
        }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int x = 4 * j + 2 * i + c;
            dp[x] = s[x] * (dp[x] - dl[2 * j + c]);
          }

      // ds^T into shared memory as three bf16 terms, [key][q row] with the
      // 128-byte swizzle (16-byte chunk m/8 of key row kb at
      // (m/8) ^ (kb % 8)): the K-major A of dk += ds^T.q, and the
      // MN-major A of the fused dq += ds.k. Registers 8kt + 2r and + 1
      // hold key row 16(warp%4) + lane/4 + 8(r&1), q rows 16kt + 8(r>>1)
      // + col0 and + 1; the 32 lanes of a store hit 32 banks. The first
      // barrier waits for this warpgroup's dk products of the previous
      // tile, the second for the whole tile.
      named_bar_sync(3 + wg, 128);
#pragma unroll
      for (int kt = 0; kt < kBQ / 16; ++kt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int kb = wg * kWGKeys + (warp % 4) * 16 + lane / 4 + 8 * (r & 1);
          const int chunk = 2 * kt + (r >> 1);
          const uint32_t off = (kb / 8) * 1024 + (kb % 8) * kRowBytes +
                               ((chunk ^ (kb % 8)) * 16) + col0 * 2;
          uint32_t t3[kTerms];
          split3(dp[8 * kt + 2 * r], dp[8 * kt + 2 * r + 1], t3);
#pragma unroll
          for (int i = 0; i < kTerms; ++i) st_shared_u32(s_ds + i * L::kDsBytes + off, t3[i]);
        }
      fence_proxy_async();

      // p^T as A fragments (k-step kt: registers 8kt..8kt+7 in order).
      uint32_t pf[kTerms][kBQ / 16][4];
#pragma unroll
      for (int kt = 0; kt < kBQ / 16; ++kt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          uint32_t t3[kTerms];
          split3(s[8 * kt + 2 * r], s[8 * kt + 2 * r + 1], t3);
#pragma unroll
          for (int i = 0; i < kTerms; ++i) pf[i][kt][r] = t3[i];
        }
      named_bar_sync(3 + wg, 128);

      // dv += p^T.dO and dk += ds^T.q, 64 head dims at a time: each tile's
      // product goes into a zeroed accumulator (terms smallest first) and
      // is then added to the running sum with float32 adds, so the long
      // sum over q tiles rounds to nearest. dO and q are MN-major: 8-row
      // groups 1024 bytes apart, 64-column block h at h * kBQ rows.
      float tmp[32];
#pragma unroll
      for (int h = 0; h < L::kColBlocks; ++h) {
#pragma unroll
        for (int x = 0; x < 32; ++x) tmp[x] = 0.f;
        const uint64_t b = smem_desc(sdo + h * kBQ * kRowBytes, kBQ * kRowBytes, 1024);
        wgmma_fence();
#pragma unroll
        for (int i = kTerms - 1; i >= 0; --i)
#pragma unroll
          for (int kt = 0; kt < kBQ / 16; ++kt)
            wgmma_rs_m64n64k16_mn(tmp, pf[i][kt], b + ((kt * 16 * kRowBytes) >> 4));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(tmp);
#pragma unroll
        for (int x = 0; x < 32; ++x) dv_acc[32 * h + x] += tmp[x];
      }
#pragma unroll
      for (int i = 0; i < kTerms; ++i)
#pragma unroll
        for (int kt = 0; kt < kBQ / 16; ++kt) fence_regs(pf[i][kt]);
      // ds^T K-major: this warpgroup's 64 key rows, 16 q rows (32 bytes)
      // a k-step.
      const uint64_t a_ds = smem_desc(s_ds + wg * kWGKeys * kRowBytes, 16, 1024);
#pragma unroll
      for (int h = 0; h < L::kColBlocks; ++h) {
#pragma unroll
        for (int x = 0; x < 32; ++x) tmp[x] = 0.f;
        const uint64_t b = smem_desc(sq + h * kBQ * kRowBytes, kBQ * kRowBytes, 1024);
        wgmma_fence();
#pragma unroll
        for (int i = kTerms - 1; i >= 0; --i)
#pragma unroll
          for (int kt = 0; kt < kBQ / 16; ++kt)
            wgmma_ss_m64n64k16<0, 1>(tmp, a_ds + ((i * L::kDsBytes + kt * 32) >> 4),
                                     b + ((kt * 16 * kRowBytes) >> 4), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(tmp);
#pragma unroll
        for (int x = 0; x < 32; ++x) dk_acc[32 * h + x] += tmp[x];
      }
    }

    // Release the stage; thread 0 refills it once every warp is done.
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
    if (tid == 0 && t + kStages < n_tiles) {
      mbar_wait(empty + 8 * st, parity);
      load_rows<D>(&q_map, &do_map, sq, sdo, full_q + 8 * st, full_do + 8 * st,
                   q0 + kStages * kBQ, bh);
    }
    __syncwarp();

    if constexpr (kFused) {
      // Every live warpgroup's ds^T is in shared memory. dq rows q0..q0+63
      // += ds.k over the live warpgroups' keys (warpgroup 0 is always
      // live: the walk starts at the tile holding its first key);
      // warpgroup w takes head dims 64w..64w+63 (D = 64: warpgroup 0 all).
      named_bar_sync(2, kThreads);
      if (D == 128 || wg == 0) {
        const bool both = live(1, q0);
        const uint64_t a = smem_desc(s_ds, kBK * kRowBytes, 1024);  // MN-major
        const uint64_t b = smem_desc(s_k + wg * kBK * kRowBytes, kBK * kRowBytes, 1024);
        float dq[32];
#pragma unroll
        for (int x = 0; x < 32; ++x) dq[x] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int i = kTerms - 1; i >= 0; --i)
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            if (kk >= kWGKeys / 16 && !both) break;
            const uint64_t off = (kk * 16 * kRowBytes) >> 4;
            wgmma_ss_m64n64k16<1, 1>(dq, a + ((i * L::kDsBytes) >> 4) + off, b + off, 1);
          }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        float* rows = dq_acc + ((size_t)bh * Sq + q0) * D + wg * 64 + col0;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = (warp % 4) * 16 + lane / 4 + 8 * i;
          if (q0 + r >= Sq) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            atomicAdd(reinterpret_cast<float2*>(rows + (size_t)r * D + 8 * j),
                      make_float2(dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]));
        }
      }
    }
  }

  const size_t k_head = (size_t)bh * Sk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k_pos = key0 + 8 * i;
    if (k_pos >= Sk) continue;
    __nv_bfloat16* gk = dk + (k_head + k_pos) * D + col0;
    __nv_bfloat16* gv = dv + (k_head + k_pos) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(gk + 8 * j) =
          bf16x2(dk_acc[4 * j + 2 * i] * scale, dk_acc[4 * j + 2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(gv + 8 * j) =
          bf16x2(dv_acc[4 * j + 2 * i], dv_acc[4 * j + 2 * i + 1]);
    }
  }
}

template <int D, bool kRect, bool kCausal, bool kFused>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, float* dq_acc,
           int bh, int sq, int sk, cudaStream_t stream) {
  // q and dO may have no rows (S_q = 0): no tile is loaded then, and k
  // stands in for them so that the maps are well formed.
  const bool rows = sq > 0;
  CUtensorMap q_map, k_map, v_map, do_map;
  int err = encode_bf16_rows(&k_map, k, bh, sk, D, kBK);
  if (!err) err = encode_bf16_rows(&v_map, v, bh, sk, D, kBK);
  if (!err) err = encode_bf16_rows(&q_map, rows ? q : k, bh, rows ? sq : sk, D, kBQ);
  if (!err) err = encode_bf16_rows(&do_map, rows ? dout : k, bh, rows ? sq : sk, D, kBQ);
  if (err) return err;
  const dim3 grid = kftpu::fold_grid((sk + kBK - 1) / kBK, bh);
  return kftpu::launch_kernel(
      flash_bwd_tc<D, kRect, kCausal, kFused>, grid, kThreads, (size_t)Layout<D>::kBytes,
      stream, q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), dq_acc, sq, sk, 1.0f / sqrtf((float)D),
      (float)(1.4426950408889634 / sqrt((double)D)));
}

}  // namespace tc

// -- float32: FMAs on the CUDA cores ------------------------------------------

namespace simt {

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

// kRect, kCausal and kFused as in tc::flash_bwd_tc.
template <typename T, int D, bool kRect, bool kCausal, bool kFused>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ dq_acc, int Sq,
                     int Sk_arg, float scale) {
  static_assert(!(kRect && kFused), "the fused kernel walks the causal triangle");
  static_assert(kRect || kCausal, "the compact case is causal");
  const int Sk = kRect ? Sk_arg : Sq;
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

  const kftpu::TileHead at = kftpu::tile_head((Sk + kBK - 1) / kBK);
  const int k0 = at.tile * kBK;  // heaviest (longest column) first
  const size_t q_head = (size_t)at.bh * Sq * D;
  const size_t k_head = kRect ? (size_t)at.bh * Sk * D : q_head;
  q += q_head;
  k += k_head;
  v += k_head;
  dout += q_head;
  dk += k_head;
  dv += k_head;
  lse += (size_t)at.bh * Sq;
  delta += (size_t)at.bh * Sq;

  // Score tiles are held transposed, s^T[key][row]: thread (kp, tc) owns
  // keys kr..kr+1 and rows tc*8..+7 of each q tile, and, per 64-column
  // chunk h, dk/dv columns h*64 + tc*8..+7 of its two keys.
  const int tc = threadIdx.x & 7;
  const int kr = (threadIdx.x >> 3) * 2;

  kftpu::load_tile<T, D, kBK, kThreads, true>(k, k0, Sk, sKT, kKS);
  kftpu::load_tile<T, D, kBK, kThreads, true>(v, k0, Sk, sVT, kKS);
  if (kFused) kftpu::load_tile<T, D, kBK, kThreads, false>(k, k0, Sk, sK, D);

  float dk_acc[2][kChunks * 8], dv_acc[2][kChunks * 8];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int c = 0; c < kChunks * 8; ++c) dk_acc[x][c] = dv_acc[x][c] = 0.f;

  // Causal: rows above this tile's first key see none of its keys.
  for (int q0 = kCausal ? (k0 / kBQ) * kBQ : 0; q0 < Sq; q0 += kBQ) {
    __syncthreads();  // the previous step's reads are done
    kftpu::load_tile<T, D, kBQ, kThreads, true>(q, q0, Sq, sQT, kQS);
    kftpu::load_tile<T, D, kBQ, kThreads, true>(dout, q0, Sq, sDoT, kQS);
    kftpu::load_tile<T, D, kBQ, kThreads, false>(q, q0, Sq, sQ, D);
    kftpu::load_tile<T, D, kBQ, kThreads, false>(dout, q0, Sq, sDo, D);
    for (int r = threadIdx.x; r < kBQ; r += kThreads) {
      const int q_pos = q0 + r;
      // Rows past S_q have no lse; +inf makes their p exactly 0.
      sLse[r] = q_pos < Sq ? lse[q_pos] : INFINITY;
      sDelta[r] = q_pos < Sq ? delta[q_pos] : 0.f;
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
        const bool seen = (!kCausal || q0 + r >= k_pos) && k_pos < Sk;
        const float p = seen ? expf(st[x][j] * scale - sLse[r]) : 0.f;
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
      float* dq_rows = dq_acc + q_head + (size_t)q0 * D;
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
          if (q0 + r0 + i >= Sq) continue;
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
    if (k_pos >= Sk) continue;
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

template <typename T, int D, bool kRect, bool kCausal, bool kFused>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv,
           float* dq_acc, int bh, int sq, int sk, cudaStream_t stream) {
  const dim3 grid = kftpu::fold_grid((sk + kBK - 1) / kBK, bh);
  return kftpu::launch_kernel(
      flash_bwd_dkv_kernel<T, D, kRect, kCausal, kFused>, grid, kThreads,
      smem_bytes<T, D, kFused>(), stream, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), dq_acc, sq, sk, 1.0f / sqrtf((float)D));
}

}  // namespace simt

// dq = scale * dq_acc, rounded to the input dtype, 8 elements a thread.
template <typename T>
__global__ void __launch_bounds__(256)
flash_dq_scale_kernel(const float* __restrict__ dq_acc, T* __restrict__ dq,
                      long long n8, float scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  float f[8];
  kftpu::load8(dq_acc + i * 8, f);
#pragma unroll
  for (int y = 0; y < 8; ++y) f[y] *= scale;
  kftpu::store8(dq + i * 8, f);
}

using bf16 = __nv_bfloat16;

// The two-pass dk/dv, rectangular and compact: bf16 on the tensor cores,
// f32 on the CUDA cores.
template <typename T, int D, bool kRect, bool kCausal>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
               int sk, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value)
    return tc::launch<D, kRect, kCausal, false>(q, k, v, dout, lse, delta, dk, dv, nullptr,
                                                bh, sq, sk, st);
  else
    return simt::launch<T, D, kRect, kCausal, false>(q, k, v, dout, lse, delta, dk, dv,
                                                     nullptr, bh, sq, sk, st);
}

template <bool kRect, bool kCausal>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dk, void* dv, int bh,
             int sq, int sk, int d, int dtype, cudaStream_t st) {
  if (dtype == 1 && d == 128)
    return launch_dkv<bf16, 128, kRect, kCausal>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, st);
  if (dtype == 1 && d == 64)
    return launch_dkv<bf16, 64, kRect, kCausal>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, st);
  if (dtype == 0 && d == 128)
    return launch_dkv<float, 128, kRect, kCausal>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, st);
  if (dtype == 0 && d == 64)
    return launch_dkv<float, 64, kRect, kCausal>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, st);
  return (int)cudaErrorInvalidValue;
}

// The fused kernel (bf16 on the tensor cores, f32 on the CUDA cores)
// between the memset of dq_acc and the pass that scales it into dq.
template <typename T, int D>
int launch_fused(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, void* dk,
                 void* dv, void* dq_acc, int bh, int s, cudaStream_t stream) {
  const long long n = (long long)bh * s * D;
  float* acc = static_cast<float*>(dq_acc);
  cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)n * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  int rc;
  if constexpr (std::is_same<T, bf16>::value)
    rc = tc::launch<D, false, true, true>(q, k, v, dout, lse, delta, dk, dv, acc, bh, s, s,
                                          stream);
  else
    rc = simt::launch<T, D, false, true, true>(q, k, v, dout, lse, delta, dk, dv, acc, bh,
                                               s, s, stream);
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
  return dispatch<false, true>(q, k, v, dout, lse, delta, dk, dv, bh, s, s, d,
                               dtype, static_cast<cudaStream_t>(stream));
}

// The rectangular dk/dv: q and dout [bh, sq, d], k, v, dk and dv
// [bh, sk, d], lse and delta [bh, sq] float32; causal != 0 masks
// k_pos > q_pos (top-left, no offset). Otherwise as kftpu_flash_bwd_dkv.
extern "C" int kftpu_flash_bwd_dkv_rect(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv, int bh, int sq,
                                        int sk, int d, int causal, int dtype,
                                        void* stream) {
  if (bh <= 0 || sk <= 0) return (int)cudaSuccess;
  if (sq < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (causal)
    return dispatch<true, true>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, dtype, st);
  return dispatch<true, false>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, dtype, st);
}

// As kftpu_flash_bwd_dkv, and also dq ([bh, s, d], input dtype), through
// dq_acc: a [bh, s, d] float32 scratch array that this call zeroes.
extern "C" int kftpu_flash_bwd_fused(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse,
                                     const void* delta, void* dq, void* dk,
                                     void* dv, void* dq_acc, int bh, int s,
                                     int d, int dtype, void* stream) {
  if (bh <= 0 || s <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 128)
    return launch_fused<bf16, 128>(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc, bh, s, st);
  if (dtype == 1 && d == 64)
    return launch_fused<bf16, 64>(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc, bh, s, st);
  if (dtype == 0 && d == 128)
    return launch_fused<float, 128>(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc, bh, s, st);
  if (dtype == 0 && d == 64)
    return launch_fused<float, 64>(q, k, v, dout, lse, delta, dq, dk, dv, dq_acc, bh, s, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block, in bytes, for head dim d: of the
// tensor-core body (tensor_cores != 0; bf16; the same for all four of
// its kernels) or of the CUDA-core body (float32), of the fused kernel
// (fused != 0) or a dk/dv one; 0 if there is none.
extern "C" int kftpu_flash_bwd_dkv_smem_bytes(int d, int dtype, int tensor_cores, int fused) {
  if (tensor_cores) {
    if (dtype != 1) return 0;
    if (d == 128) return tc::Layout<128>::kBytes;
    if (d == 64) return tc::Layout<64>::kBytes;
    return 0;
  }
  if (dtype == 0 && d == 128) return (int)(fused ? simt::smem_bytes<float, 128, true>() : simt::smem_bytes<float, 128, false>());
  if (dtype == 0 && d == 64) return (int)(fused ? simt::smem_bytes<float, 64, true>() : simt::smem_bytes<float, 64, false>());
  return 0;
}
