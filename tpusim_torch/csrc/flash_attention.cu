// Flash-attention forward for NVIDIA Hopper (sm_90a): softmax(Q K^T / sqrt(D)) V
// over [BH, S, D] tensors in float32 or bfloat16, accumulated in float32 and
// cast to the input dtype.
//
// Replaces the TPU kernel `_attn_kernel`, launched by `flash_attention` in
// tpusim/models/pallas_attention.py (pl.pallas_call at line 50).  The TPU
// kernel holds one query block and the whole K and V of its head in VMEM and
// does the softmax in one pass.  One head's K and V take 1 MiB at the
// registered shape [32, 1024, 128], far more than the 227 KB of shared memory
// a block can have here, so K and V stream through shared memory in tiles
// under an online softmax (running max, running sum, rescaled accumulator).
//
// What bounds it on an H100: 4*BH*S^2*D flops (1.718e10 at the registered
// shape) against 4*BH*S*D elements moved (64 MiB in f32), about 256 flops
// per byte, so arithmetic bounds it.  The fastest unit that takes f32
// operands is the tensor core in TF32 (495 TFLOP/s): 0.0347 ms.  One TF32
// product misses the f32 tolerance (atol 2e-5) by a factor of ten, so the
// f32 path splits every operand into a TF32 pair and takes three products
// (hi*hi + hi*lo + lo*hi): three times the tensor-core work, 0.104 ms at
// best.  bf16 runs the bf16 tensor cores (989 TFLOP/s, 0.0174 ms).  The
// warp-level mma.sync this kernel is built from reaches about 266 TFLOP/s
// in TF32 and 533 in bf16 on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit (`python -m tpusim_torch.kernels.bench ceiling`), so the f32 floor
// of this design is 0.19 ms there; the data-sheet rates need wgmma.
//
// What the design does about it:
//   * both products of every tile run on the tensor cores as warp-level
//     mma.sync (m16n8k8 TF32 for f32, m16n8k16 bf16 for bf16), in the
//     FlashAttention-2 layout: a block owns 128 query rows (8 warps of 16
//     in f32, 4 warps of 32 in bf16; see Warps), and a warp's score tile
//     never leaves its registers.
//     The score accumulator is the A operand of P V: for TF32 its columns
//     {2t, 2t+1} feed the operand's columns {t, t+4}, so V's rows are read
//     in that same order instead of shuffling P; for bf16 the layouts match
//     as they are.  Row max and row sum come from two shuffles over the four
//     lanes of a row; the softmax has no shared-memory round trip and no
//     barrier.  log2(e) is folded into the scale and exp2f does the rest.
//   * f32: each thread loads its own fragment elements from shared memory
//     (16-byte loads) and splits them in registers, so shared memory holds
//     one copy of each tile and no transposed V.  The head-dim order of the
//     QK^T product is permuted (both operands alike, so the dot product is
//     unchanged) and the output columns of P V are permuted, so that every
//     thread reads 8 consecutive floats of a row; rows padded by 4 floats
//     make every such load free of bank conflicts.  bf16 uses ldmatrix (and
//     ldmatrix.trans for V) on rows padded by 16 bytes.
//   * K and V arrive through a two-stage ring filled with 16-byte cp.async
//     copies: tile k+1 lands while tile k is computed, one barrier per tile.
//     Shared memory per block at head dim 128: Q 66 KB + 2 x (K + V) 132 KB
//     = 198 KB in f32, 102 KB in bf16.
//   * the head dim is a compile-time 32, 64 or 128; smaller dims are
//     zero-padded by the copies.  Keys past the end are zero-filled and
//     masked to -inf before the row max.  A head dim whose rows are not
//     whole 16-byte chunks is loaded element by element instead.
// Not used: wgmma (TF32 wgmma takes both operands K-major from shared
// memory, so the split would need a transposed V tile and lo copies of K
// and V^T: no room for two stages), TMA and warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using namespace tpusim;

constexpr float LOG2E = 1.4426950408889634f;

// Warps: f32 needs 226 registers a thread for one 16-row tile a warp, so a
// block is 8 warps and one block runs an SM (its tiles take 198 KB anyway).
// bf16 gives each warp two row tiles, which share every K and V fragment
// it loads, and runs two 4-warp blocks an SM; its softmax goes in 32-key
// steps so that the scores of both row tiles fit without a spill.
template <typename T>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int BQ = 128;             // query rows a block
  static constexpr int BK = 64;              // keys a K/V tile
  static constexpr int STAGES = 2;           // K/V tiles in flight
  static constexpr int MT = F32 ? 1 : 2;     // 16-row mma tiles a warp
  static constexpr int NK = F32 ? BK : 32;   // keys a softmax step
  static constexpr int THREADS = BQ / (16 * MT) * 32;
  static constexpr int BLOCKS_PER_SM = F32 ? 1 : 2;
};

// Shared-memory layout of one block: Q [BQ][LD], then K [STAGES][BK][LD],
// then V [STAGES][BK][LD].  Rows are padded by 16 bytes, so that the
// fragment loads of a quarter warp (eight 16-byte pieces) hit 32 distinct
// banks.
template <typename T, int DMAX>
struct Tiles {
  static constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int LD = DMAX + EPC;       // row stride in elements
  static constexpr int Q_ELEMS = Cfg<T>::BQ * LD;
  static constexpr int KV_ELEMS = Cfg<T>::BK * LD;
  static constexpr size_t BYTES =
      ((size_t)Q_ELEMS + 2 * Cfg<T>::STAGES * KV_ELEMS) * sizeof(T);
};
static_assert(Tiles<float, 128>::BYTES <= 232448,
              "f32 tiles do not fit in shared memory");

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// rows [row0, row0 + ROWS) of one head's [seq, dim] matrix into a padded
// [ROWS][LD] tile; rows past seq and columns past dim become zero.  vec:
// 16-byte cp.async copies (dim a whole number of chunks, pointers aligned),
// else element by element through registers.
template <typename T, int DMAX, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int seq, int dim, bool vec) {
  using TL = Tiles<T, DMAX>;
  constexpr int THREADS = Cfg<T>::THREADS;
  constexpr int CPR = DMAX / TL::EPC;  // chunks per row
  static_assert(ROWS * CPR % THREADS == 0, "chunks split evenly");
  if (vec) {
#pragma unroll
    for (int it = 0; it < ROWS * CPR / THREADS; ++it) {
      const int i = it * THREADS + threadIdx.x;
      const int r = i / CPR, c = (i % CPR) * TL::EPC;
      const int g = row0 + r;
      const bool ok = g < seq && c < dim;
      cp_async16(dst + r * TL::LD + c, ok ? src + (size_t)g * dim + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DMAX; i += THREADS) {
      const int r = i / DMAX, c = i % DMAX;
      const int g = row0 + r;
      dst[r * TL::LD + c] =
          g < seq && c < dim ? src[(size_t)g * dim + c] : zero<T>();
    }
  }
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// S[16][BK] = Q[16][DMAX] K^T for this warp's rows, f32 as split TF32.
// Head-dim order: in each 32-wide chunk c, thread column t owns the 8 dims
// 32c + 8t + [0, 8); element e of them is k-step 4c + e/2 at operand column
// t (e even) or t + 4 (e odd).  Q and K use the same order.
template <int DMAX, int NK>
__device__ __forceinline__ void scores_tf32(const float* qw, const float* kt,
                                            float (&s)[NK / 8][4], int g,
                                            int t) {
  constexpr int LD = Tiles<float, DMAX>::LD;
#pragma unroll
  for (int c = 0; c < DMAX / 32; ++c) {
    float qa[2][8];
    load8(qw + g * LD + 32 * c + 8 * t, qa[0]);
    load8(qw + (g + 8) * LD + 32 * c + 8 * t, qa[1]);
    uint32_t qh[2][8], ql[2][8];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) split_tf32(qa[r][e], qh[r][e], ql[r][e]);
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
      float kb[8];
      load8(kt + (8 * j + g) * LD + 32 * c + 8 * t, kb);
      uint32_t kh[8], kl[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) split_tf32(kb[e], kh[e], kl[e]);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint32_t ah[4] = {qh[0][2 * ks], qh[1][2 * ks],
                                qh[0][2 * ks + 1], qh[1][2 * ks + 1]};
        const uint32_t al[4] = {ql[0][2 * ks], ql[1][2 * ks],
                                ql[0][2 * ks + 1], ql[1][2 * ks + 1]};
        mma_tf32x3(s[j], ah, al, kh[2 * ks], kh[2 * ks + 1], kl[2 * ks],
                   kl[2 * ks + 1]);
      }
    }
  }
}

// S for bf16, MT row tiles of 16: ldmatrix fragments of Q (A) and K (B,
// two key tiles a load, each used by all MT row tiles)
template <int DMAX, int MT, int NK>
__device__ __forceinline__ void scores_bf16(const __nv_bfloat16* qw,
                                            const __nv_bfloat16* kt,
                                            float (&s)[MT][NK / 8][4],
                                            int lane) {
  constexpr int LD = Tiles<__nv_bfloat16, DMAX>::LD;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(a[mt], qw + (16 * mt + lane % 16) * LD + 16 * kk +
                             8 * (lane / 16));
#pragma unroll
    for (int jp = 0; jp < NK / 16; ++jp) {
      uint32_t b[4];
      ldmatrix_x4(b, kt + (16 * jp + lane % 8 + 8 * (lane / 16)) * LD +
                         16 * kk + 8 * (lane / 8 % 2));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(s[mt][2 * jp], a[mt], b[0], b[1]);
        mma_bf16(s[mt][2 * jp + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// O[16][DMAX] += P V, f32 as split TF32.  P's k-step j is score tile j:
// operand column t is key 8j + 2t (accumulator column 2t) and t + 4 is key
// 8j + 2t + 1, so the thread reads V rows 8j + 2t and 8j + 2t + 1.  Output
// tile i = 4c + u, column n is head dim 32c + 4n + u: the thread reads the
// 4 consecutive floats 32c + 4g + [0, 4) of each row, one for each u, and
// its accumulators hold dims 32c + 8t + [0, 8) (see out_dim).
template <int DMAX, int NK>
__device__ __forceinline__ void pv_tf32(const float (&p)[NK / 8][4],
                                        const float* vt,
                                        float (&acc)[DMAX / 8][4], int g,
                                        int t) {
  constexpr int LD = Tiles<float, DMAX>::LD;
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(p[j][0], ah[0], al[0]);
    split_tf32(p[j][2], ah[1], al[1]);
    split_tf32(p[j][1], ah[2], al[2]);
    split_tf32(p[j][3], ah[3], al[3]);
    const float* v0 = vt + (8 * j + 2 * t) * LD + 4 * g;
#pragma unroll
    for (int c = 0; c < DMAX / 32; ++c) {
      const float4 x0 = *reinterpret_cast<const float4*>(v0 + 32 * c);
      const float4 x1 = *reinterpret_cast<const float4*>(v0 + LD + 32 * c);
      const float b0[4] = {x0.x, x0.y, x0.z, x0.w};
      const float b1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t h0, l0, h1, l1;
        split_tf32(b0[u], h0, l0);
        split_tf32(b1[u], h1, l1);
        mma_tf32x3(acc[4 * c + u], ah, al, h0, h1, l0, l1);
      }
    }
  }
}

// O += P V for bf16: P rounded once to bf16 (the accumulator layout is the
// A layout), V through ldmatrix.trans, two output tiles a load, each used
// by all MT row tiles
template <int DMAX, int MT, int NK>
__device__ __forceinline__ void pv_bf16(const float (&p)[MT][NK / 8][4],
                                        const __nv_bfloat16* vt,
                                        float (&acc)[MT][DMAX / 8][4],
                                        int lane) {
  constexpr int LD = Tiles<__nv_bfloat16, DMAX>::LD;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = pack_bf16(p[mt][2 * kk][0], p[mt][2 * kk][1]);
      a[mt][1] = pack_bf16(p[mt][2 * kk][2], p[mt][2 * kk][3]);
      a[mt][2] = pack_bf16(p[mt][2 * kk + 1][0], p[mt][2 * kk + 1][1]);
      a[mt][3] = pack_bf16(p[mt][2 * kk + 1][2], p[mt][2 * kk + 1][3]);
    }
#pragma unroll
    for (int ip = 0; ip < DMAX / 16; ++ip) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vt + (16 * kk + lane % 8 + 8 * (lane / 8 % 2)) * LD +
                               16 * ip + 8 * (lane / 16));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * ip], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * ip + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// head dim held by accumulator acc[i][e] (e = 0, 1: columns 2t, 2t + 1)
template <typename T>
__device__ __forceinline__ int out_dim(int i, int e, int t) {
  if constexpr (sizeof(T) == 4) return 32 * (i / 4) + 8 * t + 4 * e + i % 4;
  return 8 * i + 2 * t + e;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(Cfg<T>::THREADS, Cfg<T>::BLOCKS_PER_SM)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int seq,
                       int dim, float scale_log2, bool vec) {
  using TL = Tiles<T, DMAX>;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int BQ = Cfg<T>::BQ, BK = Cfg<T>::BK, STAGES = Cfg<T>::STAGES;
  constexpr int MT = Cfg<T>::MT, NK = Cfg<T>::NK;
  static_assert(!F32 || (MT == 1 && NK == BK), "f32: one row tile, whole tiles");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + TL::Q_ELEMS;
  T* vs = ks + STAGES * TL::KV_ELEMS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ;
  const size_t head = (size_t)blockIdx.y * seq * dim;
  const int ntiles = (seq + BK - 1) / BK;

  load_tile<T, DMAX, BQ>(qs, q + head, q0, seq, dim, vec);
  load_tile<T, DMAX, BK>(ks, k + head, 0, seq, dim, vec);
  load_tile<T, DMAX, BK>(vs, v + head, 0, seq, dim, vec);
  cp_async_commit();

  float acc[MT][DMAX / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < DMAX / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.f;
  // rows g and g + 8 of each row tile: running max (log2 domain, the same
  // in the row's four lanes) and this lane's part of the running sum
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_run[mt][r] = -INFINITY;
      l_run[mt][r] = 0.f;
    }
  const int row0 = warp * 16 * MT;  // the warp's first row in the block
  const T* qw = qs + row0 * TL::LD;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it has landed; tile it - 1's readers are done
    if (it + 1 < ntiles) {
      const int st = (it + 1) % STAGES;
      load_tile<T, DMAX, BK>(ks + st * TL::KV_ELEMS, k + head, (it + 1) * BK,
                             seq, dim, vec);
      load_tile<T, DMAX, BK>(vs + st * TL::KV_ELEMS, v + head, (it + 1) * BK,
                             seq, dim, vec);
      cp_async_commit();
    }
    // the tile in sub-tiles of NK keys, an online-softmax step each
#pragma unroll
    for (int h = 0; h < BK / NK; ++h) {
      const int k0 = it * BK + h * NK;
      if (k0 >= seq) break;
      const T* kt = ks + (it % STAGES) * TL::KV_ELEMS + h * NK * TL::LD;
      const T* vt = vs + (it % STAGES) * TL::KV_ELEMS + h * NK * TL::LD;

      float s[MT][NK / 8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
      if constexpr (F32)
        scores_tf32<DMAX, NK>(qw, kt, s[0], g, t);
      else
        scores_bf16<DMAX, MT, NK>(qw, kt, s, lane);

      // accumulator column 2t + e of score tile j is key k0 + 8j + 2t + e
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& x = s[mt][j][e];
            x = k0 + 8 * j + 2 * t + (e & 1) < seq ? x * scale_log2
                                                   : -INFINITY;
            mx[e / 2] = fmaxf(mx[e / 2], x);
          }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_run[mt][r], mx[r]);  // finite: k0 < seq
          alpha[r] = exp2f(m_run[mt][r] - m_new);  // 0 on the first step
          m_run[mt][r] = m_new;
          l_run[mt][r] *= alpha[r];
        }
#pragma unroll
        for (int j = 0; j < NK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& x = s[mt][j][e];
            x = exp2f(x - m_run[mt][e / 2]);  // 0 for keys past the end
            l_run[mt][e / 2] += x;
          }
#pragma unroll
        for (int i = 0; i < DMAX / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][i][e] *= alpha[e / 2];
      }

      if constexpr (F32)
        pv_tf32<DMAX, NK>(s[0], vt, acc[0], g, t);
      else
        pv_bf16<DMAX, MT, NK>(s, vt, acc, lane);
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = q0 + row0 + 16 * mt + g + 8 * r;
      if (row >= seq) continue;
      T* orow = o + head + (size_t)row * dim;
      const float(&a)[DMAX / 8][4] = acc[mt];
      if constexpr (F32) {
        // dims 32c + 8t + 4e + [0, 4) are a[4c + u][2r + e], u = 0..3
#pragma unroll
        for (int c = 0; c < DMAX / 32; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = out_dim<T>(4 * c, e, t);
            const float x[4] = {a[4 * c][2 * r + e] / l,
                                a[4 * c + 1][2 * r + e] / l,
                                a[4 * c + 2][2 * r + e] / l,
                                a[4 * c + 3][2 * r + e] / l};
            if (vec) {
              if (col < dim)
                *reinterpret_cast<float4*>(orow + col) =
                    make_float4(x[0], x[1], x[2], x[3]);
            } else {
#pragma unroll
              for (int u = 0; u < 4; ++u)
                if (col + u < dim) orow[col + u] = x[u];
            }
          }
      } else {
#pragma unroll
        for (int i = 0; i < DMAX / 8; ++i) {
          const int col = out_dim<T>(i, 0, t);
          const float x0 = a[i][2 * r] / l, x1 = a[i][2 * r + 1] / l;
          if (vec) {
            if (col < dim)
              *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                  __floats2bfloat162_rn(x0, x1);
          } else {
            if (col < dim) orow[col] = __float2bfloat16(x0);
            if (col + 1 < dim) orow[col + 1] = __float2bfloat16(x1);
          }
        }
      }
    }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int seq, int dim, float scale, cudaStream_t stream) {
  constexpr size_t smem = Tiles<T, DMAX>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_attention_kernel<T, DMAX>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const uintptr_t any =
      (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
  const bool vec = dim % Tiles<T, DMAX>::EPC == 0 && any % 16 == 0;
  const dim3 grid((seq + Cfg<T>::BQ - 1) / Cfg<T>::BQ, bh);
  flash_attention_kernel<T, DMAX><<<grid, Cfg<T>::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq, dim, scale * LOG2E,
      vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* o, int bh,
               int seq, int dim, float scale, cudaStream_t stream) {
  if (dim <= 32) return launch<T, 32>(q, k, v, o, bh, seq, dim, scale, stream);
  if (dim <= 64) return launch<T, 64>(q, k, v, o, bh, seq, dim, scale, stream);
  return launch<T, 128>(q, k, v, o, bh, seq, dim, scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
int tpusim_flash_attention_fwd(const void* q, const void* k, const void* v,
                               void* o, int bh, int seq, int dim, int dtype,
                               float scale, void* stream) {
  if (bh < 1 || bh > 65535 || seq < 1 || dim < 1 || dim > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(q, k, v, o, bh, seq, dim, scale, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(q, k, v, o, bh, seq, dim, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* tpusim_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
