// Causal flash-attention forward for NVIDIA Hopper (sm_90a) in bfloat16,
// built from wgmma, TMA and warp specialisation, at the two head-dim pairs
// the benchmark's decoders run: q.k 128 / v 128 (Mistral-7B,
// DeepSeek-LLM-7B, llama7b) and q.k 192 / v 128 (DeepSeek-V2's latent
// attention).  Scores and softmax statistics in float32, P rounded once to
// bf16 for P V, float32 accumulation, output cast to bf16.
//
// What it replaces: no TPU kernel.  It stands in for the decoders' chain
// of score kernels (tpusim_torch/models/blocks.py `score_chain`: the
// repeated keys and values, the QK^T einsum, the scale, the causal where,
// softmax in float32, the PV einsum), which the decoders still run outside
// this kernel's domain.
// It reads q [B, S, H, DQK] with rows ldq elements apart, k [B, S, KVH,
// DQK] with rows ldk apart and v [B, S, KVH, DV] with rows ldv and heads
// hsv apart, all in place, and writes o as a contiguous [B, S, H, DV];
// query head h reads key/value head h / (H / KVH); row i keeps keys j <= i,
// its scores scaled by the caller's scale.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): B H S (S + 1)
// (DQK + DV) operations over the lower triangle with its diagonal, against
// 2 B S (H + KVH) (DQK + DV) bytes (q, k, v read and o written once):
//   * DeepSeek-V2-Lite [1, 16384, 16, 192/128]: 1.374e12 operations, 1.390
//     ms; 3.4e8 bytes, 0.100 ms: operations (about 4,100 a byte);
//   * Mistral 4k [1, 4096, 32, 128], KVH 8: 1.374e11, 0.139 ms; 8.4e7
//     bytes, 0.025 ms: operations;
//   * Mistral and DeepSeek-LLM 2k [2, 2048, 32, 128], KVH 8 and 32: 6.87e10,
//     0.0695 ms; 8.4e7 and 1.3e8 bytes: operations;
//   * 256 [16, 256, 32, 128], KVH 8: 8.6e9, 0.0087 ms; 8.4e7 bytes, 0.025
//     ms: bytes, and in practice each block's prologue (2 query blocks a
//     sequence, 1 or 2 key tiles each).
// An mma.sync design cannot come near: warp-level mma.sync tops out at
// about 533 TFLOP/s in bf16 on this card, and the port's earlier causal
// kernel, built on it and since retired, reached 218-295.
//
// The design (FlashAttention-3's: a TMA-fed ring, one producer, consumer
// warpgroups on wgmma):
//   * a block owns 128 query rows of one (batch, head) and runs three
//     warpgroups.  Warpgroup 0 is the producer: its first thread keeps a
//     ring of K and V tiles filled by TMA (cp.async.bulk.tensor, 4-d tensor
//     maps over [head dim, heads, seq, batch], 128-byte swizzle), each
//     arrival counted in bytes on an mbarrier.  Warpgroups 1 and 2 are the
//     consumers, 64 query rows each: S = Q K^T as an SS-wgmma m64n128k16
//     (Q and K K-major in shared memory), O += P V as an RS-wgmma
//     m64n128k16 (P from registers, V MN-major in shared memory, so nothing
//     is transposed).  The accumulator layout of S is the A-operand layout
//     of P V, so P goes from S to the product with no shuffle.
//   * within a consumer, tile i's Q K^T is issued together with tile
//     i - 1's P V, and tile i's softmax runs while that P V is on the
//     tensor cores.  K and V have barriers of their own, so a K slot is
//     refilled as soon as its Q K^T is done.
//   * the two consumers take turns to issue their products (named barriers
//     1 and 2): one's softmax overlaps the other's wgmma.  On the card this
//     turn-taking is worth 10-15% at every shape (16k 2.21 against 2.55 ms,
//     4k 0.261 against 0.291, 2k 0.152 against 0.167; NVIDIA H100 80GB HBM3,
//     700 W), so it stays.
//   * registers: setmaxnreg leaves the producer warpgroup 24 registers a
//     thread and gives each consumer 240: 128 x 24 + 256 x 240 = 64,512 of
//     the SM's 65,536 (ptxas reports the launch's 168 a thread, 65,536 /
//     384 rounded to 8).  A consumer thread holds S (64 floats), P (32 bf16
//     pairs) and O (64 floats) at once, with no spill.  One block an SM.
//   * tiles: a TMA box is 64 head-dim columns (128 bytes, one swizzle row)
//     by 128 rows, 16 KB, on a 1,024-byte boundary (the swizzle's period):
//       DQK 128: Q 128 x 128 (32 KB) + 2 stages x (K 128 x 128 + V 128 x
//         128: 64 KB) = 160 KB;
//       DQK 192: Q 128 x 192 (48 KB) + 2 stages x (K 128 x 192 + V 128 x
//         128: 80 KB) = 208 KB;
//     of the 227 KB a block may have, with 1 KB for the alignment and the
//     barriers.  A key tile is 128 keys at both pairs.  A third stage fits
//     at DQK 128 (224 KB) and measured within 2% of two either way, so both
//     pairs keep two.
//   * the causal order: key tiles above a query block's
//     diagonal are never loaded or multiplied (a block reads tiles q0 / 128
//     down to 0, its diagonal first, the only one masked); the heaviest query
//     blocks launch first; query heads that share a K/V head are neighbouring
//     blocks and read it from L2; a ragged end is TMA's zero fill: query rows
//     past the end are not written, keys past the end lie past every written
//     row's diagonal.  Where a wave of blocks would read more K/V than L2
//     holds, bands of heads launch one after the other, each heaviest first
//     (`band`).
//   * the host encodes the three tensor maps at each launch with
//     cuTensorMapEncodeTiled, looked up at run time through
//     cudaGetDriverEntryPoint (no link to libcuda); they travel as
//     __grid_constant__ parameters.  A call through the Python wrapper
//     costs the host 24-58 us (chip_smoke.py phases 21 and 22).
//
// Domain (tpusim_torch/kernels/flash_attention.py `causal_kernel_takes`,
// which the decoders' gate tpusim_torch/models/blocks.py `takes_kernel`
// reads): bf16 causal calls at head dims 128 / 128 or 192 / 128; the
// wrapper refuses pointers off 16-byte boundaries and row or head strides
// that are not whole 16-byte chunks (what TMA addresses).  Outside the
// domain the decoders run the score chain.  No sequence-length threshold:
// at every cell's shape, 256 included, the kernel is an order of magnitude
// faster than the score chain it replaces (0.065-0.075 against 0.81-0.83
// ms at 256; chip_smoke.py phase 21).

#include <algorithm>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

constexpr int BM = 128;      // query rows a block, 64 a consumer
constexpr int BN = 128;      // keys a K/V tile
constexpr int STAGES = 2;    // K/V tiles in flight
constexpr int THREADS = 384;  // the producer and two consumer warpgroups
constexpr int BOX = 64;      // head-dim columns a TMA box: one 128-byte row
constexpr int ROW_BYTES = BOX * 2;
constexpr int BOX_BYTES = BN * ROW_BYTES;  // a box of 128 rows, 16 KB
static_assert(BM == BN, "a query block's diagonal is one key tile");

template <int DQK, int DV>
struct Cfg {
  static constexpr int Q_BYTES = BM * DQK * 2;
  static constexpr int K_BYTES = BN * DQK * 2;
  static constexpr int V_BYTES = BN * DV * 2;
  static constexpr int TILE_BYTES = Q_BYTES + STAGES * (K_BYTES + V_BYTES);
  // the tiles, 1 KB of room to align them, and the barriers
  static constexpr int SMEM_BYTES = TILE_BYTES + 1024 + 128;
  static_assert(DQK % BOX == 0 && DV == 2 * BOX, "head dims of whole boxes");
  static_assert(SMEM_BYTES <= 232448, "tiles do not fit in shared memory");
};

// ---- PTX building blocks -------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

// arrive once and expect `bytes` of TMA traffic in this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// arrive when `pred` holds, predicated inside the instruction: a branch
// around it would make the path between two wgmma divergent, and ptxas
// then serializes the wgmma
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(bar),
      "r"((int)pred)
      : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// a [64 columns, 1 head, rows, 1 batch] box of a 4-d tensor map into
// shared memory, its bytes counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive_if(int id, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p bar.arrive %0, 256;\n"
      "}\n" ::"r"(id),
      "r"((int)pred)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile: the start
// address, the leading-dimension byte offset (between two 64-column boxes
// of an MN-major operand; unused K-major) and the stride byte offset
// (between two groups of 8 rows: 8 x 128 bytes), all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// wait until at most N of the warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma still reads or writes across the wait that ends it
// (and from giving their physical registers to other values meanwhile).
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define TPUSIM_D64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define TPUSIM_ACC8(d, i)                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TPUSIM_ACC64(d)                                                   \
  TPUSIM_ACC8(d, 0), TPUSIM_ACC8(d, 8), TPUSIM_ACC8(d, 16),               \
      TPUSIM_ACC8(d, 24), TPUSIM_ACC8(d, 32), TPUSIM_ACC8(d, 40),         \
      TPUSIM_ACC8(d, 48), TPUSIM_ACC8(d, 56)

// d (+)= a b over m64 n128 k16: a [64 x 16] and b [16 x 128] both K-major in
// shared memory; d is overwritten when `accumulate` is 0.  Accumulator i of
// a thread is row 16 (warp % 4) + lane / 4 + 8 (i % 4 / 2), column
// 8 (i / 4) + 2 (lane % 4) + i % 2.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TPUSIM_D64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : TPUSIM_ACC64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += a b over m64 n128 k16: a from registers (each warp's 16 rows in the
// mma.sync m16n8k16 A layout), b [16 x 128] MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TPUSIM_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : TPUSIM_ACC64(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

#undef TPUSIM_ACC64
#undef TPUSIM_ACC8
#undef TPUSIM_D64

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- the kernel ----------------------------------------------------------

struct Layout {
  int seq, heads, group;  // query heads a key/value head
  int band;               // (batch, head) pairs launched together
  float scale_log2;
};

// One online-softmax step over a tile's scores s (this thread's 64, in the
// accumulator layout): the running max m (raw scores) and this thread's
// part of the running sum l for its rows lane / 4 and lane / 4 + 8; s
// becomes exp2(s * scale_log2 - m * scale_log2).  Returns the factors by
// which the output rows are to be rescaled.
__device__ __forceinline__ float2 softmax_step(float (&s)[64], float (&m)[2],
                                               float (&l)[2],
                                               float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[i % 4 / 2] = fmaxf(mx[i % 4 / 2], s[i]);
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // m[r] is -inf before the first tile: alpha 0
    alpha[r] = exp2f((m[r] - mx[r]) * scale_log2);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
  const float ms[2] = {mx[0] * scale_log2, mx[1] * scale_log2};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = exp2f(fmaf(s[i], scale_log2, -ms[i % 4 / 2]));
    l[i % 4 / 2] += s[i];
  }
  return make_float2(alpha[0], alpha[1]);
}

// S = Q K^T for the warpgroup's 64 rows against one K tile (issued and
// committed, not waited for).  Both K-major: k-step kk reads box kk / 4 of
// each tile, 32 bytes along its 128-byte rows per step.
template <int DQK>
__device__ __forceinline__ void issue_scores(float (&s)[64], uint32_t q_rows,
                                             uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk) {
    const uint32_t off = kk / 4 * BOX_BYTES + kk % 4 * 32;
    wgmma_ss(s, sw128_desc(q_rows + off, 16), sw128_desc(k_tile + off, 16),
             kk > 0);
  }
  wgmma_commit();
}

// O += P V over one V tile (issued and committed): V MN-major, k-step kk
// (16 keys) 16 rows down, its two 64-column boxes a box apart
__device__ __forceinline__ void issue_pv(float (&acc)[64],
                                         const uint32_t (&p)[32],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
             sw128_desc(v_tile + kk * 16 * ROW_BYTES, BOX_BYTES));
  wgmma_commit();
}

// the probabilities as the A operand of P V: register 4 kk + r of k-step kk
// holds accumulators 8 kk + 2r and 8 kk + 2r + 1
__device__ __forceinline__ void to_p(uint32_t (&p)[32], const float (&s)[64]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// Grid (batch x heads, query blocks), read as one launch order (below).
// Warpgroup 0 produces, 1 and 2 consume; the roles never meet again after
// the split.
template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 __nv_bfloat16* __restrict__ o, Layout lay) {
  using C = Cfg<DQK, DV>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the tiles on a 1,024-byte boundary (the swizzle's period), then the
  // barriers: full and empty for each K and each V slot, and Q's
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + C::Q_BYTES;
  const uint32_t v_s = k_s + STAGES * C::K_BYTES;
  const uint32_t bars = v_s + STAGES * C::V_BYTES;
#define FULL_K(st) (bars + 8 * (st))
#define FULL_V(st) (bars + 8 * (STAGES + (st)))
#define EMPTY_K(st) (bars + 8 * (2 * STAGES + (st)))
#define EMPTY_V(st) (bars + 8 * (3 * STAGES + (st)))
  const uint32_t full_q = bars + 8 * 4 * STAGES;

  // Blocks launch in the order of blockIdx.x + gridDim.x * blockIdx.y.
  // Bands of lay.band (batch, head) pairs follow each other; within a
  // band, query blocks go from the heaviest (the last) down, the band's
  // pairs side by side.  One band (band = batch x heads) is the plain
  // order: blockIdx.x the pair, blockIdx.y the query block from the last.
  const int pairs = gridDim.x, nq = gridDim.y;
  const int linear = blockIdx.x + pairs * blockIdx.y;
  const int band0 = linear / (lay.band * nq) * lay.band;
  const int width = min(lay.band, pairs - band0);
  const int rest = linear - band0 * nq;
  const int bh = band0 + rest % width;
  const int b = bh / lay.heads, h = bh % lay.heads;
  const int q0 = (nq - 1 - rest / width) * BM;
  const int ntiles = q0 / BN + 1;  // keys 0 .. q0 + BM - 1

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(FULL_K(st), 1);
      mbar_init(FULL_V(st), 1);
      mbar_init(EMPTY_K(st), 8);  // one arrival a consumer warp
      mbar_init(EMPTY_V(st), 8);
    }
    mbar_init(full_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, from lane 0 so that the compiler sees it is the same
  // in every lane: no branch below on it is divergent
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    // ---- producer warpgroup: its first thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      const int kvh = h / lay.group;
      mbar_expect_tx(full_q, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < DQK / BOX; ++c)
        tma_load(q_s + c * BOX_BYTES, &tq, full_q, c * BOX, h, q0, b);
      // tile i of the ring is key tile ntiles - 1 - i: the diagonal first
      for (int i = 0; i < ntiles; ++i) {
        const int row = (ntiles - 1 - i) * BN, st = i % STAGES;
        const uint32_t ph = (i / STAGES & 1) ^ 1;
        mbar_wait(EMPTY_K(st), ph);
        mbar_expect_tx(FULL_K(st), C::K_BYTES);
#pragma unroll
        for (int c = 0; c < DQK / BOX; ++c)
          tma_load(k_s + st * C::K_BYTES + c * BOX_BYTES, &tk, FULL_K(st),
                   c * BOX, kvh, row, b);
        mbar_wait(EMPTY_V(st), ph);
        mbar_expect_tx(FULL_V(st), C::V_BYTES);
#pragma unroll
        for (int c = 0; c < DV / BOX; ++c)
          tma_load(v_s + st * C::V_BYTES + c * BOX_BYTES, &tv, FULL_V(st),
                   c * BOX, kvh, row, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = role - 1;  // 0 or 1
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    // The consumers take turns to issue their products: each waits on its
    // named barrier (1 + wg) before issuing and lets the other go after.
    // The first goes first; the second skips its last hand-over, which
    // the first would never wait for.
    named_arrive_if(1, wg == 0);
    const int other = 2 - wg;

    float acc[64], s[64];
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint32_t q_rows = q_s + wg * 64 * ROW_BYTES;

    mbar_wait(full_q, 0);

    // tile 0, the diagonal: keys q0 .. q0 + 127 against the warpgroup's
    // rows q0 + 64 wg .. q0 + 64 wg + 63
    mbar_wait(FULL_K(0), 0);
    named_sync(1 + wg);
    wgmma_fence();
    issue_scores<DQK>(s, q_rows, k_s);
    named_arrive_if(other, !(wg == 1 && ntiles == 1));
    wgmma_wait<0>();
    hold(s);
    mbar_arrive_if(EMPTY_K(0), lane == 0);
    {
      // accumulator i holds key q0 + 8 (i / 4) + 2t + i % 2 of row q0 +
      // 64 wg + 16 warp + g + 8 (i % 4 / 2): kept at or before the row
      const int lim = 64 * wg + 16 * warp + g - 2 * t;
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (8 * (i / 4) + i % 2 - 8 * (i % 4 / 2) > lim) s[i] = -INFINITY;
    }
    softmax_step(s, m, l, lay.scale_log2);
    to_p(p, s);

    for (int i = 1; i < ntiles; ++i) {
      const int st = i % STAGES, pst = (i - 1) % STAGES;
      mbar_wait(FULL_K(st), i / STAGES & 1);
      named_sync(1 + wg);
      wgmma_fence();
      issue_scores<DQK>(s, q_rows, k_s + st * C::K_BYTES);
      mbar_wait(FULL_V(pst), (i - 1) / STAGES & 1);
      issue_pv(acc, p, v_s + pst * C::V_BYTES);
      named_arrive_if(other, !(wg == 1 && i == ntiles - 1));
      wgmma_wait<1>();  // the scores of tile i
      hold(s);
      mbar_arrive_if(EMPTY_K(st), lane == 0);
      const float2 alpha = softmax_step(s, m, l, lay.scale_log2);
      wgmma_wait<0>();  // P V of tile i - 1
      hold(acc);
      hold(p);
      mbar_arrive_if(EMPTY_V(pst), lane == 0);
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] *= j % 4 < 2 ? alpha.x : alpha.y;
      to_p(p, s);
    }

    const int last = (ntiles - 1) % STAGES;
    mbar_wait(FULL_V(last), (ntiles - 1) / STAGES & 1);
    wgmma_fence();
    issue_pv(acc, p, v_s + last * C::V_BYTES);
    wgmma_wait<0>();
    hold(acc);
    hold(p);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / sum;
      const int row = q0 + 64 * wg + 16 * warp + g + 8 * r;
      if (row >= lay.seq) continue;
      __nv_bfloat16* orow =
          o + (((size_t)b * lay.seq + row) * lay.heads + h) * DV + 2 * t;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                  acc[4 * j + 2 * r + 1] * inv);
    }
  }
#undef FULL_K
#undef FULL_V
#undef EMPTY_K
#undef EMPTY_V
}

// ---- host side -----------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled as the CUDA runtime finds it, looked up once
// (null where it is missing)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 [batch, seq, heads, dim] tensor whose rows lie `ld` and heads `hs`
// elements apart, read in boxes of [64 columns, 1 head, `rows` rows, 1
// batch] with the 128-byte swizzle; positions past seq read as zeros.
bool tensor_map(CUtensorMap* map, const void* base, int batch, int seq,
                int heads, int dim, long long ld, long long hs, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t size[4] = {(cuuint64_t)dim, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t stride[3] = {(cuuint64_t)hs * 2, (cuuint64_t)ld * 2,
                                (cuuint64_t)seq * ld * 2};
  const cuuint32_t box[4] = {BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), size, stride, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// How many (batch, head) pairs to launch together (a multiple of the query
// heads that share a key/value head).  In the plain order a wave of 132
// blocks holds about 132 / (batch x kv_heads) blocks of each key/value
// head; a K/V tile read from memory then serves that many blocks, at 128
// operations a byte each, where the card needs about 295.  With fewer than
// 4 a wave, and K/V past half the 50 MB of L2 (DeepSeek-LLM-7B at 2k: 64
// key/value heads, 67 MB), the blocks of a band of key/value heads launch
// together instead, about 256 blocks a band, so that each K/V tile comes
// from memory about once: 0.1553 against 0.1697 ms there, where the shapes
// that keep the plain order read alike in both builds (NVIDIA H100 80GB
// HBM3, 700 W).  Every other cell keeps the plain order.
int band(int batch, int seq, int heads, int kv_heads, int nq, int dims) {
  const long long kv_bytes = 2LL * batch * seq * kv_heads * dims;
  const int pairs = batch * heads, group = heads / kv_heads;
  if (132 < 4 * batch * kv_heads && kv_bytes > 25LL * 1000 * 1000) {
    const int kv_band = 256 / (nq * group);
    if (kv_band >= 1) return std::min(pairs, kv_band * group);
    return group;
  }
  return pairs;
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int seq, int heads, int kv_heads, int ldq, int ldk, int ldv,
           int hsv, float scale, cudaStream_t stream) {
  using C = Cfg<DQK, DV>;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, batch, seq, heads, DQK, ldq, DQK, BM) ||
      !tensor_map(&tk, k, batch, seq, kv_heads, DQK, ldk, DQK, BN) ||
      !tensor_map(&tv, v, batch, seq, kv_heads, DV, ldv, hsv, BN))
    return (int)cudaErrorInvalidValue;
  const int nq = (seq + BM - 1) / BM;
  const dim3 grid(batch * heads, nq);
  flash_attention_wgmma_kernel<DQK, DV>
      <<<grid, THREADS, C::SMEM_BYTES, stream>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(o),
          Layout{seq, heads, heads / kv_heads,
                 band(batch, seq, heads, kv_heads, nq, DQK + DV),
                 scale * LOG2E});
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Causal attention in bf16 over grouped heads read in place: q [batch,
// seq, heads, dim] with rows ldq elements apart, k [batch, seq, kv_heads,
// dim] with rows ldk apart, v [batch, seq, kv_heads, dim_v] with rows ldv
// and heads hsv apart, o [batch, seq, heads, dim_v] contiguous.  Takes
// (dim, dim_v) = (128, 128) or (192, 128), every pointer on a 16-byte
// boundary and ldq, ldk, ldv, hsv multiples of 8.
// Returns a cudaError_t (0 = launched).
int tpusim_causal_attention_wgmma_fwd(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int seq, int heads, int kv_heads,
                                      int dim, int dim_v, int ldq, int ldk,
                                      int ldv, int hsv, float scale,
                                      void* stream) {
  const uintptr_t any =
      (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
  if (batch < 1 || seq < 1 || heads < 1 || kv_heads < 1 ||
      heads % kv_heads != 0 || dim_v != 128 || (dim != 128 && dim != 192) ||
      any % 16 != 0 || ldq % 8 || ldk % 8 || ldv % 8 || hsv % 8 ||
      hsv < dim_v || ldq < heads * dim || ldk < kv_heads * dim ||
      (long long)ldv < (long long)(kv_heads - 1) * hsv + dim_v ||
      (dim == dim_v && (ldv != ldk || hsv != dim)) ||
      (long long)batch * heads > 0x7fffffffLL || (seq + 127) / 128 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 128)
    return launch<128, 128>(q, k, v, o, batch, seq, heads, kv_heads, ldq, ldk,
                            ldv, hsv, scale, s);
  return launch<192, 128>(q, k, v, o, batch, seq, heads, kv_heads, ldq, ldk,
                          ldv, hsv, scale, s);
}

const char* tpusim_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
