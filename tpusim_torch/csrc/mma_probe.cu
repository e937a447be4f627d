// Throughput probes of the instructions the attention kernel is built from,
// on the card at hand: warp-level mma.sync in TF32 (m16n8k8) and bf16
// (m16n8k16), and the TF32 rounding of a float32, by cvt.rna.tf32.f32 and by
// two integer operations.  Each warp runs ILP independent chains; nothing is
// read from memory.  Beside them, the latency of one dependent float64 add
// (__dadd_rn), which bounds each lane's chain in scan_rows.cu.  Run through
// `python -m tpusim_torch.kernels.bench ceiling`.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using namespace tpusim;

constexpr int ILP = 8;

__global__ void mma_tf32_probe(float* out, int iters) {
  float d[ILP][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                         threadIdx.x + 3};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < ILP; ++j) mma_tf32(d[j], a, i + j, i);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < ILP; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void mma_bf16_probe(float* out, int iters) {
  float d[ILP][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                         threadIdx.x + 3};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < ILP; ++j) mma_bf16(d[j], a, i + j, i);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < ILP; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// one TF32 rounding per element and step; the result feeds the next step
template <bool CVT>
__global__ void round_probe(float* out, int iters) {
  float x[ILP];
#pragma unroll
  for (int j = 0; j < ILP; ++j) x[j] = threadIdx.x * 1.01f + j;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < ILP; ++j) {
      uint32_t h;
      if constexpr (CVT)
        asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x[j]));
      else
        h = (__float_as_uint(x[j]) + 0x1000u) & 0xffffe000u;
      x[j] = __uint_as_float(h ^ 0x00400000u);
    }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < ILP; ++j) s += x[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// One warp adds x to acc iters x kChainUnroll times, each add waiting for the
// one before.  clock64 and the global timer (ns) around the chain give its
// cycles and nanoseconds; the asm statements pin the chain between them.
constexpr int kChainUnroll = 16;

__global__ void dadd_chain_probe(const double* in, double* out,
                                 long long* stamps, int iters) {
  double acc = in[0];
  const double x = in[1];
  long long c0, c1, g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0)::"memory");
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c0)::"memory");
  asm volatile("" : "+d"(acc)::"memory");
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < kChainUnroll; ++j) acc = __dadd_rn(acc, x);
  asm volatile("" : "+d"(acc)::"memory");
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c1)::"memory");
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1)::"memory");
  out[threadIdx.x] = acc;
  if (threadIdx.x == 0) {
    stamps[0] = c1 - c0;
    stamps[1] = g1 - g0;
  }
}

}  // namespace

extern "C" {

// The dependent-add chain on one warp: in holds {acc, x}, out 32 doubles
// (each lane's acc + iters * kChainUnroll * x), stamps {cycles, ns} of the
// second of two runs.  Returns a cudaError_t.
int tpusim_dadd_chain_probe(int iters, const double* in, double* out,
                            long long* stamps, void* stream) {
  for (int rep = 0; rep < 2; ++rep)
    dadd_chain_probe<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        in, out, stamps, iters);
  return (int)cudaGetLastError();
}

int tpusim_dadd_chain_unroll() { return kChainUnroll; }

// which: 0 = mma tf32, 1 = mma bf16, 2 = cvt.rna.tf32, 3 = integer rounding.
// Runs the probe twice (the first warms up) and puts the second run's time
// in *ms.  out holds blocks * threads floats.  Returns a cudaError_t.
int tpusim_mma_probe(int which, int blocks, int threads, int iters,
                     float* out, float* ms) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    if (which == 0) mma_tf32_probe<<<blocks, threads>>>(out, iters);
    if (which == 1) mma_bf16_probe<<<blocks, threads>>>(out, iters);
    if (which == 2) round_probe<true><<<blocks, threads>>>(out, iters);
    if (which == 3) round_probe<false><<<blocks, threads>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
  }
  cudaEventElapsedTime(ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return (int)cudaGetLastError();
}

}  // extern "C"

// ILP chains a warp, for the Python side's operation count
extern "C" int tpusim_mma_probe_ilp() { return ILP; }
