// flic_update: the coherence sweep of N FLIC caches by R broadcast rows,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flic_update.py::flic_update_pallas,
// which the JAX package vmaps over caches; this kernel covers all N caches
// in one call.  Contract: repro_torch/kernels/ref.py::flic_update_ref.  A
// live row qualifies for a line if the line is valid, the tags match and the
// row's timestamp is strictly newer than the line's timestamp from BEFORE
// the sweep; per line the highest qualifying row index wins and writes
// data_ts, last_use = now and the payload; the count is of qualifying rows,
// per cache.  A row whose set index lies outside [0, S) never qualifies.
//
// What bounds it on the card: bytes.  The (N, R) live mask is read once,
// each (node, row) pair gathers one W-way set row of three tables, and
// only the updated lines are written.
//
// Design: one block per node, the whole election in shared memory, one
// launch.  The block stages its node's tags, pre-sweep timestamps and valid
// flags in shared memory, with a shared winner per line set to -1.  Its
// threads walk the R rows: the node's live flags are read coalesced, and a
// live row's key, set index and timestamp (which every block reads, from
// L2) are tested against the W staged ways of its set.  A qualifying row
// goes into the line's shared winner by a shared-memory atomicMax, skipped
// when the winner is already at least the row (on hot keys most are).  Each
// thread counts its qualifying rows; one block reduction stores the node's
// count (no zero-fill, no global atomics).  After a barrier the threads
// walk the node's lines and, where the winner is >= 0, write data_ts,
// last_use and the payload in place.  Integer maxima are order-free, so the
// result is deterministic.
//
// A node whose table does not fit the shared budget is swept in ranges of
// whole sets, one pass over the rows per range; a range's timestamps are
// staged before any of its lines is written, so every comparison still sees
// the timestamps from before the sweep.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLineBytes = 13;             // tag, timestamp, winner (4 each), valid (1)
constexpr int kMaxLines = 15360;           // lines of a range: 199,680 bytes of shared memory
constexpr int kDefaultSmem = 48 * 1024;

__global__ void __launch_bounds__(kThreads) flic_update_sweep(
    const int32_t* __restrict__ tags, int32_t* __restrict__ data_ts,
    const uint8_t* __restrict__ valid, int32_t* __restrict__ last_use,
    float* __restrict__ data, const int32_t* __restrict__ keys,
    const int32_t* __restrict__ sidx, const int32_t* __restrict__ row_ts,
    const float* __restrict__ row_data, const uint8_t* __restrict__ live,
    int32_t* __restrict__ counts, int now, int r, int n_sets, int n_ways,
    int dim, int range_sets) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int range_lines = range_sets * n_ways;
  int* s_tag = reinterpret_cast<int*>(smem);
  int* s_ts = s_tag + range_lines;
  int* s_win = s_ts + range_lines;
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_win + range_lines);
  __shared__ int s_warp_count[kThreads / 32];

  const int node = blockIdx.x;
  const int tid = threadIdx.x;
  const long long node_lines = static_cast<long long>(n_sets) * n_ways;
  const uint8_t* live_n = live + static_cast<long long>(node) * r;
  int count = 0;

  for (int s0 = 0; s0 < n_sets; s0 += range_sets) {
    const int s1 = min(s0 + range_sets, n_sets);
    const int lines = (s1 - s0) * n_ways;
    const long long base = node * node_lines + static_cast<long long>(s0) * n_ways;
    if (s0 > 0) __syncthreads();   // the previous range's lines are written
    for (int i = tid; i < lines; i += kThreads) {
      s_tag[i] = tags[base + i];
      s_ts[i] = data_ts[base + i];
      s_valid[i] = valid[base + i];
      s_win[i] = -1;
    }
    __syncthreads();

    // Election: the highest qualifying row of each line.
    for (int row = tid; row < r; row += kThreads) {
      if (!live_n[row]) continue;
      const int s = sidx[row];
      if (s < s0 || s >= s1) continue;
      const int key = keys[row];
      const int ts = row_ts[row];
      const int at = (s - s0) * n_ways;
      bool any = false;
      for (int w = 0; w < n_ways; ++w) {
        const int line = at + w;
        if (s_valid[line] && s_tag[line] == key && ts > s_ts[line]) {
          any = true;
          if (s_win[line] < row) atomicMax(s_win + line, row);
        }
      }
      count += any;
    }
    __syncthreads();

    // Apply in place: timestamps and last use a line, payloads a value.
    for (int i = tid; i < lines; i += kThreads) {
      const int win = s_win[i];
      if (win >= 0) {
        data_ts[base + i] = row_ts[win];
        last_use[base + i] = now;
      }
    }
    for (int e = tid; e < lines * dim; e += kThreads) {
      const int i = e / dim;
      const int win = s_win[i];
      if (win >= 0)
        data[base * dim + e] = row_data[static_cast<long long>(win) * dim + (e - i * dim)];
    }
  }

  // The node's count: warp sums, then warp 0 sums the warps in order.
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(0xffffffffu, count, off);
  if ((tid & 31) == 0) s_warp_count[tid >> 5] = count;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += s_warp_count[w];
    counts[node] = total;
  }
}

}  // namespace

// tags, data_ts, last_use (N, S, W) int32; valid (N, S, W) and live (N, R)
// bool; data (N, S, W, D) and row_data (R, D) f32; keys, sidx, row_ts (R,)
// int32; counts (N,) int32, every entry written.  All contiguous; data_ts,
// last_use and data are updated in place.
extern "C" int flic_update_launch(
    const void* tags, void* data_ts, const void* valid, void* last_use,
    void* data, const void* keys, const void* sidx, const void* row_ts,
    const void* row_data, const void* live, void* counts, int now, int n, int r,
    int n_sets, int n_ways, int dim, void* stream) {
  if (n <= 0) return 0;
  if (n_sets <= 0 || n_ways <= 0 || n_ways > kMaxLines || r < 0 || dim < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int range_sets = n_sets < kMaxLines / n_ways ? n_sets : kMaxLines / n_ways;
  if (static_cast<long long>(range_sets) * n_ways * dim > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = range_sets * n_ways * kLineBytes;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        flic_update_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  flic_update_sweep<<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tags), static_cast<int32_t*>(data_ts),
      static_cast<const uint8_t*>(valid), static_cast<int32_t*>(last_use),
      static_cast<float*>(data), static_cast<const int32_t*>(keys),
      static_cast<const int32_t*>(sidx), static_cast<const int32_t*>(row_ts),
      static_cast<const float*>(row_data), static_cast<const uint8_t*>(live),
      static_cast<int32_t*>(counts), now, r, n_sets, n_ways, dim, range_sets);
  return static_cast<int>(cudaGetLastError());
}
