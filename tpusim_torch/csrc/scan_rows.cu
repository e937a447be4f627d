// Row-seeded serial float64 scans for scenario-batched pricing.
//
// Counterpart of the JAX package's lane-axis scan backend,
// ``jax_scan_rows`` (tpusim/fastpath/jax_backend.py:74-93), which is a
// ``vmap``-ed ``lax.scan``; it replaces no Pallas kernel.  Lane s of the
// result is cumsum([seeds[s], mat[0][s], ..., mat[k-1][s]]): the exact
// ``+=`` chain of the per-state pricing walk, so the result must equal the
// host's serial scan byte for byte.
//
// Design: one thread per lane, serial over ops.  Every add is
// ``__dadd_rn`` — round to nearest, never contracted or reassociated — and
// no parallel prefix sum is used, because a different association order
// changes the bytes.  The matrix is ops-major ([k, S], lanes contiguous),
// so the 32 lanes of a warp read 32 neighbouring doubles (256 bytes) per
// op and write their partial sums the same way.
//
// What bounds it on an H100: each lane is a chain of k dependent adds, so
// with few lanes the scan is latency-bound (a few cycles per add, plus a
// load); with many lanes it is bound by the bytes moved, S*(k+1)*8 read
// (seeds + matrix) and as many written.  The loads do not depend on the
// chain, so the loop loads a block of UNROLL values ahead of its adds to
// keep several loads in flight per thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

__global__ void scan_rows_kernel(const double* __restrict__ seeds,
                                 const double* __restrict__ mat,
                                 double* __restrict__ out,
                                 int64_t lanes, int64_t k) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= lanes) return;
  double acc = seeds[s];
  out[s] = acc;
  int64_t i = 0;
  for (; i + kUnroll <= k; i += kUnroll) {
    double x[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) x[j] = mat[(i + j) * lanes + s];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      acc = __dadd_rn(acc, x[j]);
      out[(i + j + 1) * lanes + s] = acc;
    }
  }
  for (; i < k; ++i) {
    acc = __dadd_rn(acc, mat[i * lanes + s]);
    out[(i + 1) * lanes + s] = acc;
  }
}

}  // namespace

// out[0][s] = seeds[s]; out[i+1][s] = out[i][s] + mat[i][s].  All three
// arrays are float64 on the device; mat is [k, lanes] and out is
// [k+1, lanes], both row-major.  Returns the launch's cudaError_t.
extern "C" int tpusim_scan_rows(const void* seeds, const void* mat, void* out,
                                int64_t lanes, int64_t k, void* stream) {
  if (lanes <= 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (lanes + kThreads - 1) / kThreads;
  scan_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(seeds), static_cast<const double*>(mat),
      static_cast<double*>(out), lanes, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpusim_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
