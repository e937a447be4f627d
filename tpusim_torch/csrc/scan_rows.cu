// Row-seeded serial float64 scans for scenario-batched pricing: every scan
// of a run step in one launch.
//
// What it replaces.  The counterpart of the JAX package's lane-axis scan
// backend, ``jax_scan_rows`` (tpusim/fastpath/jax_backend.py:74-93), a
// ``vmap``-ed ``lax.scan``; it replaces no Pallas kernel.  A segment is a
// list of rows of an ops-major float64 matrix ([ops, lanes]) and one seed
// per lane: lane s of its scan is cumsum([seed[s], mat[r_0][s], ...,
// mat[r_{k-1}][s]]), the exact ``+=`` chain of the per-state pricing walk,
// so it must equal the host's serial scan byte for byte.  A run step of the
// batched pricer has several segments (its time chain over ops lo..hi, one
// per unit group and one per opcode group); ``tpusim_scan_segments`` scans
// them all in one launch, and ``tpusim_scan_rows`` is its one-segment,
// full-chain case.
//
// Arithmetic.  One thread owns one lane of one segment and adds its rows
// left to right with ``__dadd_rn``: round to nearest, never contracted into
// a fused multiply-add, never reassociated, no parallel prefix.
//
// What bounds it on an H100, and what the design does about each:
//  * bytes, at many lanes: (k+1)*S*8 read (seeds and rows) and, for a full
//    chain, as many written.  Rows are ops-major, so a warp's 32 lanes read
//    and write 256 contiguous bytes a row.  A block streams its segment's
//    rows, gathered through the index array, into a ring of shared-memory
//    stages with cp.async: kStages - 1 chunks of kChunk rows (96 rows, 24
//    KB) are in flight per warp while its adds run, enough for one warp per
//    SM to keep its share of HBM busy.
//  * the dependent chain, at few lanes: a lane's k adds are serial, so the
//    scan takes at least k times the latency of one dependent DADD.  The
//    adds read shared memory the ring filled ahead, and a chunk's operands
//    are read before the next copies are issued, so no load sits on the
//    chain; what is left beside it is the one warp's instruction issue
//    (per row a copy, a shared load, a store and their addresses, against
//    the add's latency), and a wait per chunk.  No store is guarded (a
//    guard per store compiles to a branch per row): lanes past the end, in
//    the last tile only, compute the last lane's chain from the same
//    operands and store the same bytes to the same slots.
//  * launch and copy latency, at the pricer's shapes (runs of 1-51 ops,
//    64-746 lanes): one launch covers a whole run step, each segment a row
//    of the grid, so a batched call pays one round trip per run step.
//
// Layout.  A block is one warp: a tile of 32 lanes of one segment; the grid
// is (lane tiles, segments).  The ring is static shared memory, kStages x
// kChunk x 32 doubles = 4 x 32 x 256 B = 32 KB, under the 48 KB a block
// gets without opting in, so 7 blocks fit an SM's 227 KB: 924 on the card,
// against the 128 of [4096 lanes, one segment] and the 120 of a 746-lane
// step of 5 segments.  The stage count is fixed, so every wait is an
// immediate: with the count chosen at run time (a switch of waits) and a
// guard on every store, the same loop ran several times slower on an
// H100.  Of 16 x 8, 16 x 4, 32 x 4 and 8 x 8 rows x stages, 32 x 4 timed
// fastest at 64 lanes and on ragged segments, and level at 4096 lanes.  A
// thread copies and reads only its own lane's slots, so
// cp.async.wait_group alone orders them: no barrier.  When every lane reads
// one column (lane stride 0, or one lane), 32 copies of one address a row
// would be slow, so each thread copies one row of the chunk instead and
// every lane reads it from the same slot; the wait then orders another
// thread's copy, so the read follows a __syncwarp.  A partial last tile
// of an ops-major matrix keeps the slow case: its idle lanes copy the
// last lane's address.

#include <cstdint>
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

using namespace tpusim;

constexpr int kLanes = 32;    // lanes of a block: one warp
constexpr int kChunk = 32;    // rows of a ring stage
constexpr int kStages = 4;    // ring stages
constexpr int kStage = kChunk * kLanes;
static_assert(kChunk == kLanes, "a chunk's rows are held one a thread");

// One segment: its rows are idx[off .. off+len) (off .. off+len when idx is
// null).  full: output rows orow .. orow+len get the seed and every partial
// sum; else row orow gets the end.
struct Segment {
  int64_t off, len, orow, full;
};

// the row at position c * kChunk + t of a gathered segment, held by thread
// t < kChunk (0 past the end and in the other threads)
__device__ __forceinline__ int chunk_row(const int64_t* __restrict__ idx,
                                         const Segment& sg, int c, int t) {
  const int64_t pos = static_cast<int64_t>(c) * kChunk + t;
  if (t >= kChunk || pos >= sg.len) return 0;
  return static_cast<int>(idx[sg.off + pos]);
}

// Copy chunk c of the segment (gathered: its rows held by threads
// 0..kChunk-1 in row_t) into its ring stage, nothing past the segment's
// end, and commit one group whether or not anything was copied.  kOne: every
// lane reads one column, so thread t copies row t of the chunk once, for
// all lanes (32 copies of one address a row are slow on the card).
template <bool kGather, bool kOne>
__device__ __forceinline__ void issue_chunk(double* ring, const double* col,
                                            int64_t op_stride,
                                            const Segment& sg, int c,
                                            int row_t, int t) {
  const int64_t base = static_cast<int64_t>(c) * kChunk;
  double* stage = ring + (c & (kStages - 1)) * kStage + t;
  if (kOne) {
    const int64_t row = kGather ? row_t : sg.off + base + t;
    if (base + t < sg.len) cp_async8(stage, col + row * op_stride);
  } else if (base + kChunk <= sg.len) {
    const double* src = col + (sg.off + base) * op_stride;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const double* p =
          kGather ? col + static_cast<int64_t>(
                              __shfl_sync(0xffffffffu, row_t, j)) * op_stride
                  : src + j * op_stride;
      cp_async8(stage + j * kLanes, p);
    }
  } else if (base < sg.len) {
    for (int j = 0; j < kChunk; ++j) {
      const int64_t row =
          kGather ? __shfl_sync(0xffffffffu, row_t, j) : sg.off + base + j;
      if (base + j < sg.len)
        cp_async8(stage + j * kLanes, col + row * op_stride);
    }
  }
  cp_async_commit();
}

// One lane's scan of one segment from acc = its seed.
template <bool kGather, bool kOne, bool kFull>
__device__ __forceinline__ void scan_segment(
    const Segment& sg, const int64_t* __restrict__ idx, const double* col,
    int64_t op_stride, double* ring, double acc, double* __restrict__ out,
    int64_t lanes, int64_t lane, int t) {
  // a stage holds row j at slot j * kLanes + t, or at slot j for one column
  constexpr int kRowStep = kOne ? 1 : kLanes;
  const int chunks = static_cast<int>((sg.len + kChunk - 1) / kChunk);
  const int whole = static_cast<int>(sg.len / kChunk);
  double* o = out + sg.orow * lanes + lane;
  if (kFull) *o = acc;
  // prologue: chunks 0 .. kStages-2 in flight
  int row_t = kGather ? chunk_row(idx, sg, 0, t) : 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const int next = kGather ? chunk_row(idx, sg, s + 1, t) : 0;
    issue_chunk<kGather, kOne>(ring, col, op_stride, sg, s, row_t, t);
    row_t = next;
  }
  int c = 0;
  for (; c < whole; ++c) {
    // groups committed so far: chunks 0 .. c+kStages-2, so at most
    // kStages-2 pending means chunk c has landed
    cp_async_wait<kStages - 2>();
    // one column: the rows were copied by other threads, and the stage the
    // copies below refill was read by them a chunk ago
    if (kOne) __syncwarp();
    const int next = kGather ? chunk_row(idx, sg, c + kStages, t) : 0;
    const double* in = ring + (c & (kStages - 1)) * kStage + (kOne ? 0 : t);
    double x[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) x[j] = in[j * kRowStep];
    // into the stage read one chunk ago
    issue_chunk<kGather, kOne>(ring, col, op_stride, sg, c + kStages - 1,
                               row_t, t);
    row_t = next;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      acc = __dadd_rn(acc, x[j]);
      if (kFull) *(o += lanes) = acc;
    }
  }
  cp_async_wait<0>();  // the tail, and nothing in flight for the next segment
  if (kOne) __syncwarp();
  if (c < chunks) {
    // the last chunk, partial
    const double* in = ring + (c & (kStages - 1)) * kStage + (kOne ? 0 : t);
    const int rows =
        static_cast<int>(sg.len - static_cast<int64_t>(c) * kChunk);
    for (int j = 0; j < rows; ++j) {
      acc = __dadd_rn(acc, in[j * kRowStep]);
      if (kFull) *(o += lanes) = acc;
    }
  }
  if (!kFull) *o = acc;
  if (kOne) __syncwarp();  // every read done before the next segment's copies
}

template <bool kGather, bool kOne>
__global__ void __launch_bounds__(kLanes)
    scan_segments_kernel(const double* __restrict__ mat, int64_t op_stride,
                         int64_t lane_stride, const int64_t* __restrict__ idx,
                         const int64_t* __restrict__ table, Segment one,
                         const double* __restrict__ seeds,
                         double* __restrict__ out, int64_t lanes,
                         int64_t n_seg) {
  __shared__ __align__(16) double ring[kStages * kStage];
  const int t = threadIdx.x;
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kLanes + t;
  // lanes past the end (the last tile only) stand in for the last lane:
  // the same operands, the same chain, the same bytes to the same slots
  const int64_t lane_c = lane < lanes ? lane : lanes - 1;
  const double* col = mat + lane_c * lane_stride;
  for (int64_t seg = blockIdx.y; seg < n_seg; seg += gridDim.y) {
    Segment sg = one;
    if (table != nullptr) {
      const int64_t* e = table + 4 * seg;
      sg = Segment{e[0], e[1], e[2], e[3]};
    }
    const double seed = seeds[seg * lanes + lane_c];
    if (sg.full)
      scan_segment<kGather, kOne, true>(sg, idx, col, op_stride, ring, seed,
                                        out, lanes, lane_c, t);
    else
      scan_segment<kGather, kOne, false>(sg, idx, col, op_stride, ring, seed,
                                         out, lanes, lane_c, t);
  }
}

int launch(const void* mat, int64_t op_stride, int64_t lane_stride,
           const void* idx, const void* table, Segment one, const void* seeds,
           void* out, int64_t lanes, int64_t n_seg, void* stream) {
  const int64_t tiles = (lanes + kLanes - 1) / kLanes;
  if (lanes <= 0 || n_seg <= 0 || op_stride < 0 || lane_stride < 0 ||
      tiles > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(n_seg < 65535 ? n_seg : 65535));
  const auto* ix = static_cast<const int64_t*>(idx);
  const auto run = [&](auto kernel) {
    kernel<<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(mat), op_stride, lane_stride, ix,
        static_cast<const int64_t*>(table), one,
        static_cast<const double*>(seeds), static_cast<double*>(out), lanes,
        n_seg);
  };
  // one column for every lane: shared (stride 0), or a single lane
  const bool one_col = lane_stride == 0 || lanes == 1;
  if (ix != nullptr)
    one_col ? run(scan_segments_kernel<true, true>)
            : run(scan_segments_kernel<true, false>);
  else
    one_col ? run(scan_segments_kernel<false, true>)
            : run(scan_segments_kernel<false, false>);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[0][s] = seeds[s]; out[i+1][s] = out[i][s] + mat[i][s].  All three
// arrays are float64 on the device; mat is [k, lanes] and out is
// [k+1, lanes], both row-major.  Returns the launch's cudaError_t.
extern "C" int tpusim_scan_rows(const void* seeds, const void* mat, void* out,
                                int64_t lanes, int64_t k, void* stream) {
  if (k < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(mat, lanes, 1, nullptr, nullptr, Segment{0, k, 0, 1}, seeds,
                out, lanes, 1, stream);
}

// Every segment of one run step in one launch.  mat: float64, element
// (op, lane) at mat[op * op_stride + lane * lane_stride] (lane_stride 0: one
// column shared by every lane).  table: int64 [n_seg, 4], a row per segment:
// offset of its rows in idx, length, first output row, full (1) or end only
// (0).  idx: int64 row numbers, each below 2^31 (null: segment rows off ..
// off+len).  seeds: float64 [n_seg, lanes].  out: float64 [rows, lanes],
// rows = the sum over segments of len+1 (full) or 1.  Returns the launch's
// cudaError_t.
extern "C" int tpusim_scan_segments(const void* mat, int64_t op_stride,
                                    int64_t lane_stride, const void* idx,
                                    const void* table, const void* seeds,
                                    void* out, int64_t lanes, int64_t n_seg,
                                    void* stream) {
  if (table == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(mat, op_stride, lane_stride, idx, table, Segment{0, 0, 0, 0},
                seeds, out, lanes, n_seg, stream);
}

extern "C" const char* tpusim_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
