// RMSNorm for NVIDIA Hopper (sm_90a) in bfloat16, one read and one write of
// each row: y = bf16(float(bf16(x * inv)) * float(w)), with inv =
// rsqrt(mean(x^2) + eps) in float32 over the row.
//
// What it replaces: no TPU kernel.  The reference's `_rmsnorm`
// (tpusim/models/llama.py) is plain jnp, which XLA fuses; the port's
// decoders ran it as an eager chain of eight kernels
// (tpusim_torch/kernels/rms_norm.py `rms_norm_reference`: a cast to
// float32, a square, a mean, + eps, rsqrt, a product, a cast back to bf16,
// the product with the weight), each a pass over the whole [rows, dim]
// tensor, mostly in float32: about 36 bytes moved an element.  The decoders
// still run that chain wherever this kernel is not taken (a gradient, a
// capture, the CPU, float32).
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s): bytes.  An element is
// one bf16 read and one bf16 write, 4 bytes, against about 8 operations; the
// weight row is read once a block, from L2.  At the decoders' shapes:
//   * [4096, 4096] (Mistral-7B and DeepSeek-LLM-7B, 4096 tokens a step):
//     67.1 MB, 20.0 us;
//   * [16384, 2048] (DeepSeek-V2-Lite's hidden norms at 16k): 134.2 MB,
//     40.1 us;
//   * [16384, 512] read from rows 576 apart (its latent norm): 33.6 MB,
//     10.0 us.
//
// The design meets the bound by touching each byte once, with loads that
// fill the memory pipe:
//   * a group of threads owns a row: each thread loads up to VECS 16-byte
//     vectors (8 bf16 each) of it and of the weight, all issued before any
//     is used, and keeps them in registers through the reduction, so the
//     row is read once and written once, with no shared-memory staging;
//   * threads per row follow dim: dim / 8 / VECS, rounded up to whole warps
//     (128 at 4096, 64 at 2048, 32 at 512), and a block of BLOCK threads
//     holds as many rows as fit (2, 4, 8), so short rows still make
//     256-thread blocks, with up to 16 KB of the row loads in flight each;
//   * the row's sum of squares: a butterfly over the warp's lanes (every
//     lane ends with the same bits), then the row's warps' partials through
//     shared memory, summed by every thread of the row in one order;
//   * the chain's roundings, so that only the order of the row's sum
//     differs from it: each square rounded to float32 (no fused multiply-
//     add), the mean as the sum times 1/dim (ATen's mean multiplies by the
//     same factor, exact for the decoders' power-of-two dims), + eps,
//     rsqrtf, the product x * inv rounded to bf16, then the bf16 product
//     with the weight computed in float32 and rounded once;
//   * rows read at the caller's stride (a multiple of 8 elements), so
//     DeepSeek-V2's latent norm reads its 512 of each 576-element row in
//     place; the output is contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int VECS = 4;     // 16-byte vectors a thread holds at most
constexpr int ELEMS = 8;    // bf16 elements in a vector
constexpr int BLOCK = 256;  // threads a block, where a row needs fewer
constexpr int MAX_THREADS = 1024;
constexpr int MAX_DIM = MAX_THREADS * VECS * ELEMS;

// the two bf16 halves of a 32-bit word, as floats (exact)
__device__ __forceinline__ float low(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float high(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

__device__ __forceinline__ float squares(uint32_t v, float s) {
  s = __fadd_rn(s, __fmul_rn(low(v), low(v)));
  return __fadd_rn(s, __fmul_rn(high(v), high(v)));
}

// one element: bf16(float(bf16(x * inv)) * w), as bits
__device__ __forceinline__ uint32_t norm1(float x, float inv, float w) {
  const float y = __bfloat162float(__float2bfloat16_rn(__fmul_rn(x, inv)));
  return __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(y, w)));
}

__device__ __forceinline__ uint32_t norm2(uint32_t x, uint32_t w,
                                          float inv) {
  return norm1(low(x), inv, low(w)) | norm1(high(x), inv, high(w)) << 16;
}

// blockDim.x threads (whole warps) a row, blockDim.y rows a block
__global__ void __launch_bounds__(MAX_THREADS)
    rms_norm_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ y, int rows, int dim,
                    long long ldx, float inv_dim, float eps) {
  __shared__ float partial[MAX_THREADS / 32];
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const int nvec = dim / ELEMS;
  const bool live = row < rows;
  const uint4* xr = reinterpret_cast<const uint4*>(
      x + static_cast<long long>(live ? row : 0) * ldx);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  uint4 xv[VECS], wv[VECS];
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (live && i < nvec) {
      xv[k] = xr[i];
      wv[k] = __ldg(wr + i);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (live && i < nvec) {
      s = squares(xv[k].x, s);
      s = squares(xv[k].y, s);
      s = squares(xv[k].z, s);
      s = squares(xv[k].w, s);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  const int warps = blockDim.x / 32;
  if (warps > 1) {
    float* mine = partial + threadIdx.y * warps;
    if (threadIdx.x % 32 == 0) mine[threadIdx.x / 32] = s;
    __syncthreads();
    s = 0.f;
    for (int i = 0; i < warps; ++i) s += mine[i];
  }
  if (!live) return;
  const float inv = rsqrtf(__fadd_rn(__fmul_rn(s, inv_dim), eps));
  uint4* yr = reinterpret_cast<uint4*>(y + static_cast<long long>(row) * dim);
#pragma unroll
  for (int k = 0; k < VECS; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      uint4 out;
      out.x = norm2(xv[k].x, wv[k].x, inv);
      out.y = norm2(xv[k].y, wv[k].y, inv);
      out.z = norm2(xv[k].z, wv[k].z, inv);
      out.w = norm2(xv[k].w, wv[k].w, inv);
      yr[i] = out;
    }
  }
}

}  // namespace

extern "C" {

// RMSNorm over the last dim in bf16: x holds `rows` rows of `dim` elements,
// ldx elements apart; w holds dim elements; y is written as a contiguous
// [rows, dim].  Takes dim a multiple of 8 up to MAX_DIM, ldx >= dim a
// multiple of 8, every pointer on a 16-byte boundary.
// Returns a cudaError_t (0 = launched).
int tpusim_rms_norm_fwd(const void* x, const void* w, void* y, int rows,
                        int dim, long long ldx, float eps, void* stream) {
  const uintptr_t any = (uintptr_t)x | (uintptr_t)w | (uintptr_t)y;
  if (rows < 1 || dim < ELEMS || dim % ELEMS || dim > MAX_DIM || ldx < dim ||
      ldx % ELEMS || any % 16 != 0)
    return (int)cudaErrorInvalidValue;
  int threads = (dim / ELEMS + VECS - 1) / VECS;
  threads = (threads + 31) / 32 * 32;
  const int per_block = threads >= BLOCK ? 1 : BLOCK / threads;
  const dim3 block(threads, per_block);
  const unsigned blocks =
      (unsigned)(((long long)rows + per_block - 1) / per_block);
  rms_norm_kernel<<<blocks, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
      rows, dim, ldx, 1.0f / (float)dim, eps);
  return (int)cudaGetLastError();
}

const char* tpusim_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
