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
// per cache.
//
// What bounds it on the card: bytes.  The (N, R) live mask is read once,
// each (node, row) pair gathers one W-way set row of three tables, and
// only the updated lines are written.
//
// Design: the winner election of DESIGN.md §3 in two passes.
//   pass 1 (elect): one thread per (node, row).  It tests the W ways against
//     the timestamps as they were before the sweep, atomicMax-es its row
//     index into the scratch winr (N, S, W) (which starts at -1), and adds
//     one to its cache's count if any way qualified.  Integer atomics are
//     order-free, so the result is deterministic.
//   pass 2 (apply): one thread per line; where winr >= 0 it copies the
//     winning row in place.
// Pass 2 runs after pass 1 on the same stream, so every comparison sees the
// timestamps from before the sweep -- the "judged before the sweep" rule
// comes for free, where the TPU kernel reads an un-aliased copy instead.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void flic_update_elect(
    const int32_t* __restrict__ tags, const int32_t* __restrict__ data_ts,
    const uint8_t* __restrict__ valid, const int32_t* __restrict__ keys,
    const int32_t* __restrict__ sidx, const int32_t* __restrict__ row_ts,
    const uint8_t* __restrict__ live, int32_t* __restrict__ winr,
    int32_t* __restrict__ counts, int n, int r, int n_sets, int n_ways) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n * r) return;
  if (!live[i]) return;  // live is (N, R) row-major
  const int node = static_cast<int>(i / r);
  const int row = static_cast<int>(i % r);
  const int s = sidx[row];
  if (s < 0 || s >= n_sets) return;  // callers derive sidx as key % S
  const int key = keys[row];
  const int ts = row_ts[row];
  const long long base = ((long long)node * n_sets + s) * n_ways;
  bool any = false;
  for (int w = 0; w < n_ways; ++w) {
    if (valid[base + w] && tags[base + w] == key && ts > data_ts[base + w]) {
      atomicMax(winr + base + w, row);
      any = true;
    }
  }
  if (any) atomicAdd(counts + node, 1);
}

__global__ void flic_update_apply(
    const int32_t* __restrict__ winr, const int32_t* __restrict__ row_ts,
    const float* __restrict__ row_data, int32_t* __restrict__ data_ts,
    int32_t* __restrict__ last_use, float* __restrict__ data, int now,
    long long lines, int dim) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lines) return;
  const int win = winr[i];
  if (win < 0) return;
  data_ts[i] = row_ts[win];
  last_use[i] = now;
  const float* src = row_data + (long long)win * dim;
  float* dst = data + i * dim;
  for (int j = 0; j < dim; ++j) dst[j] = src[j];
}

}  // namespace

extern "C" int flic_update_launch(
    const void* tags, void* data_ts, const void* valid, void* last_use,
    void* data, const void* keys, const void* sidx, const void* row_ts,
    const void* row_data, const void* live, void* winr, void* counts,
    int now, int n, int r, int n_sets, int n_ways, int dim, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long pairs = (long long)n * r;
  if (pairs > 0) {
    flic_update_elect<<<(unsigned)((pairs + threads - 1) / threads), threads, 0, st>>>(
        static_cast<const int32_t*>(tags), static_cast<const int32_t*>(data_ts),
        static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(keys),
        static_cast<const int32_t*>(sidx), static_cast<const int32_t*>(row_ts),
        static_cast<const uint8_t*>(live), static_cast<int32_t*>(winr),
        static_cast<int32_t*>(counts), n, r, n_sets, n_ways);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long lines = (long long)n * n_sets * n_ways;
  flic_update_apply<<<(unsigned)((lines + threads - 1) / threads), threads, 0, st>>>(
      static_cast<const int32_t*>(winr), static_cast<const int32_t*>(row_ts),
      static_cast<const float*>(row_data), static_cast<int32_t*>(data_ts),
      static_cast<int32_t*>(last_use), static_cast<float*>(data), now, lines,
      dim);
  return static_cast<int>(cudaGetLastError());
}
