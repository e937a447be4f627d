// Flash-attention forward for NVIDIA Hopper (sm_90a): softmax(Q K^T / sqrt(D)) V
// over [BH, S, D] tensors in float32 or bfloat16, computed in float32.
//
// Replaces the TPU kernel `_attn_kernel`, launched by `flash_attention` in
// tpusim/models/pallas_attention.py (pl.pallas_call at line 50).  The TPU
// kernel holds one query block and the whole K and V of its head in VMEM and
// does the softmax in one pass.  One head's K and V take 1 MiB at the
// registered shape [32, 1024, 128], far more than the 227 KB of shared memory
// a block can have here, so this kernel is not a block-by-block copy of it.
//
// What bounds it on an H100: the function does 4*BH*S^2*D flops (17.2 GFLOP
// at the registered shape) and must move 4*BH*S*D elements (64 MiB in f32),
// about 256 flops per byte.  It is bound by arithmetic, not by device memory.
// This version runs that arithmetic as f32 FMAs on the CUDA cores (67 TFLOP/s
// peak on an H100 SXM), not on the tensor cores.
//
// What the design does about it:
//   * one block per (head, 128-row query tile) streams K and V through
//     shared memory in 64-row tiles with an online softmax (running max,
//     running sum, f32 accumulator rescaled per tile), so K and V never have
//     to fit in shared memory and device memory is read once per query tile;
//   * each thread keeps an 8x4 tile of scores and an 8 x (D/16) tile of the
//     output in registers.  Q, K and P sit transposed in padded shared tiles
//     and each thread's output columns are two runs that the row's threads
//     read as one contiguous span, so every operand comes in as a vector
//     load without bank conflicts: a thread issues 3 shared loads per 32
//     FMAs for the scores and 4 per 64 FMAs for P V, which keeps the FMA
//     pipes, not shared memory, the limit;
//   * the head dim is a compile-time bound (32, 64 or 128; smaller dims are
//     zero-padded), so the tile loads unroll and all of a thread's global
//     loads are in flight at once;
//   * the probability tile reuses the K tile's shared memory.
// wgmma, TMA and tensor-core precisions (TF32, bf16) are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 128;         // query rows per block
constexpr int BK = 64;          // key rows per K/V tile
constexpr int THREADS = 256;    // 16 x 16 threads
constexpr int TM = BQ / 16;     // query rows per thread
constexpr int TN = BK / 16;     // key columns per thread
constexpr int QPAD = BQ + 4;    // row of Q^T [DMAX][QPAD] and P^T [BK][QPAD]
constexpr int KPAD = BK + 4;    // row of K^T [DMAX][KPAD]
constexpr int RPT = THREADS / BQ;  // threads per softmax row
static_assert(TM == 8 && TN == 4, "the inner loops read float4 operands");
static_assert(BQ * 32 % THREADS == 0 && BK * 32 % THREADS == 0,
              "tile loads split evenly over the threads");
static_assert(RPT == 2, "the softmax combines two threads per row");

template <int DMAX>
struct Smem {
  static constexpr int KP = DMAX * KPAD > BK * QPAD ? DMAX * KPAD : BK * QPAD;
  static constexpr size_t FLOATS =
      (size_t)DMAX * QPAD + KP + (size_t)BK * DMAX + BQ;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};
static_assert(Smem<128>::BYTES <= 232448, "tile does not fit in shared memory");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// eight consecutive floats of shared memory (16-byte aligned) as two float4
__device__ __forceinline__ void load8(const float* p, float (&out)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// H consecutive floats of shared memory in one vector load (H = 1, 2, 4)
template <int H>
__device__ __forceinline__ void load_run(const float* p, float* out) {
  if constexpr (H == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  } else if constexpr (H == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    out[0] = a.x; out[1] = a.y;
  } else {
    out[0] = *p;
  }
}

// Output column of a thread's j-th accumulator: the thread owns a run of
// TD/2 columns in each half of the head dim, so that the 16 threads of a
// row read one contiguous span of V per load (no bank conflicts)
template <int DMAX>
__device__ __forceinline__ int out_col(int tx, int j) {
  constexpr int H = DMAX / 32;
  return (j / H) * (DMAX / 2) + tx * H + j % H;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int seq,
                       int dim, float scale) {
  constexpr int TD = DMAX / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                              // Q^T [DMAX][QPAD]
  float* ks = qs + DMAX * QPAD;                  // K^T [DMAX][KPAD] ...
  float* ps = ks;                                // ... then P^T [BK][QPAD]
  float* vs = ks + Smem<DMAX>::KP;               // V   [BK][DMAX]
  float* row_scale = vs + BK * DMAX;             // per-row alpha, then sum

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const size_t head = (size_t)blockIdx.y * seq * dim;

  // Q tile, transposed; rows past the end and columns past dim are zero
#pragma unroll
  for (int it = 0; it < BQ * DMAX / THREADS; ++it) {
    const int i = it * THREADS + tid;
    const int r = i / DMAX, c = i % DMAX;
    const int g = q0 + r;
    qs[c * QPAD + r] =
        g < seq && c < dim ? to_f32(q[head + (size_t)g * dim + c]) : 0.f;
  }

  float acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;

  // softmax state of row (tid / RPT), identical in the row's threads
  const int srow = tid / RPT;
  const int spart = tid % RPT;
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int k0 = 0; k0 < seq; k0 += BK) {
    __syncthreads();  // the previous tile's readers of ps, vs are done
#pragma unroll
    for (int it = 0; it < BK * DMAX / THREADS; ++it) {
      const int i = it * THREADS + tid;
      const int r = i / DMAX, c = i % DMAX;
      const int g = k0 + r;
      const bool ok = g < seq && c < dim;
      const size_t off = head + (size_t)g * dim + c;
      ks[c * KPAD + r] = ok ? to_f32(k[off]) : 0.f;
      vs[r * DMAX + c] = ok ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    // scores for rows ty*TM + i, keys tx*TN + j
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DMAX; ++d) {
      float qa[TM];
      load8(&qs[d * QPAD + ty * TM], qa);
      const float4 kv = *reinterpret_cast<const float4*>(&ks[d * KPAD + tx * TN]);
      const float ka[TN] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }
    __syncthreads();  // every read of ks is done: ps overwrites it
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx * TN + j;
      const bool live = k0 + c < seq;
      float4* dst = reinterpret_cast<float4*>(&ps[c * QPAD + ty * TM]);
      dst[0] = live ? make_float4(s[0][j] * scale, s[1][j] * scale,
                                  s[2][j] * scale, s[3][j] * scale)
                    : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      dst[1] = live ? make_float4(s[4][j] * scale, s[5][j] * scale,
                                  s[6][j] * scale, s[7][j] * scale)
                    : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    }
    __syncthreads();

    // online softmax over this tile: two threads per row (a column of P^T),
    // interleaved keys
    {
      float mx = -INFINITY;
#pragma unroll
      for (int cc = 0; cc < BK / RPT; ++cc)
        mx = fmaxf(mx, ps[(cc * RPT + spart) * QPAD + srow]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_run, mx);  // finite: k0 < seq
      float sum = 0.f;
#pragma unroll
      for (int cc = 0; cc < BK / RPT; ++cc) {
        float* pp = &ps[(cc * RPT + spart) * QPAD + srow];
        const float p = expf(*pp - m_new);  // 0 for keys past the end
        *pp = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float alpha = expf(m_run - m_new);  // 0 on the first tile
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (spart == 0) row_scale[srow] = alpha;
    }
    __syncthreads();

    // O = alpha * O + P V for rows ty*TM + i, columns out_col(tx, j)
    {
      float alpha[TM];
      load8(&row_scale[ty * TM], alpha);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] *= alpha[i];
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pa[TM];
      load8(&ps[c * QPAD + ty * TM], pa);
      float va[TD];
      load_run<TD / 2>(&vs[c * DMAX + tx * (TD / 2)], va);
      load_run<TD / 2>(&vs[c * DMAX + DMAX / 2 + tx * (TD / 2)], va + TD / 2);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
    }
  }

  __syncthreads();
  if (spart == 0) row_scale[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int g = q0 + ty * TM + i;
    if (g >= seq) continue;
    const float l = row_scale[ty * TM + i];
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const int c = out_col<DMAX>(tx, j);
      if (c < dim) store_out(&o[head + (size_t)g * dim + c], acc[i][j] / l);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int seq, int dim, float scale, cudaStream_t stream) {
  constexpr size_t smem = Smem<DMAX>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + BQ - 1) / BQ, bh);
  flash_attention_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), seq, dim, scale);
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
