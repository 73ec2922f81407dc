// flic_insert: batched one-line-per-node upsert over the eight FLIC cache
// tables, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flic_insert.py::flic_insert_pallas.
// Contract: repro_torch/kernels/ref.py::flic_insert_ref.  Per node: pick the
// first matching valid way, else the first invalid way, else the least
// recently used way; write the line unless the lane is dead or a present
// copy is as new or newer; ins_ts = last_use = now.  No eviction record.
//
// What bounds it on the card: bytes.  Per node it reads one W-way set row of
// four tables (tags, valid, last_use, data_ts) and its incoming line, and
// writes at most one line (7 scalars + D payload floats); there is no
// arithmetic to speak of.  The whole tables are never copied.
//
// Design: one thread per node, all N caches in one launch.  Rows of
// different nodes are disjoint, so no atomics and no ordering are needed.
// The tables are updated IN PLACE: that replaces the Pallas kernel's
// input_output_aliases buffer donation, and saves the copy of every table
// that a functional update would cost.  The TPU kernel's sequential node
// loop over VMEM-pinned blocks has no counterpart: on this card each node
// is an independent thread.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void flic_insert_kernel(
    int32_t* __restrict__ tags, int32_t* __restrict__ data_ts,
    int32_t* __restrict__ ins_ts, int32_t* __restrict__ origin,
    uint8_t* __restrict__ valid, uint8_t* __restrict__ dirty,
    int32_t* __restrict__ last_use, float* __restrict__ data,
    const int32_t* __restrict__ keys, const int32_t* __restrict__ sidx,
    const int32_t* __restrict__ line_ts, const int32_t* __restrict__ line_origin,
    const uint8_t* __restrict__ line_dirty, const uint8_t* __restrict__ live,
    const float* __restrict__ line_data,
    int now, int n, int n_sets, int n_ways, int dim) {
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n) return;
  const int s = sidx[node];
  if (s < 0 || s >= n_sets) return;  // callers derive sidx as key % S
  const int key = keys[node];
  const long long row = ((long long)node * n_sets + s) * n_ways;

  int present_way = -1, invalid_way = -1, lru_way = 0, lru_use = INT_MAX;
  for (int w = 0; w < n_ways; ++w) {
    if (valid[row + w]) {
      if (present_way < 0 && tags[row + w] == key) present_way = w;
      const int use = last_use[row + w];
      if (use < lru_use) {  // strict: the first least-recent way wins
        lru_use = use;
        lru_way = w;
      }
    } else if (invalid_way < 0) {
      invalid_way = w;
    }
  }
  const int way = present_way >= 0 ? present_way
                                   : (invalid_way >= 0 ? invalid_way : lru_way);
  const long long line = row + way;
  const int ts = line_ts[node];
  const bool stale = present_way >= 0 && ts <= data_ts[line];
  if (!live[node] || stale) return;

  tags[line] = key;
  data_ts[line] = ts;
  ins_ts[line] = now;
  origin[line] = line_origin[node];
  valid[line] = 1;
  dirty[line] = line_dirty[node] ? 1 : 0;
  last_use[line] = now;
  const float* src = line_data + (long long)node * dim;
  float* dst = data + line * dim;
  for (int j = 0; j < dim; ++j) dst[j] = src[j];
}

}  // namespace

extern "C" int flic_insert_launch(
    void* tags, void* data_ts, void* ins_ts, void* origin, void* valid,
    void* dirty, void* last_use, void* data, const void* keys,
    const void* sidx, const void* line_ts, const void* line_origin,
    const void* line_dirty, const void* live, const void* line_data,
    int now, int n, int n_sets, int n_ways, int dim, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  flic_insert_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(tags), static_cast<int32_t*>(data_ts),
      static_cast<int32_t*>(ins_ts), static_cast<int32_t*>(origin),
      static_cast<uint8_t*>(valid), static_cast<uint8_t*>(dirty),
      static_cast<int32_t*>(last_use), static_cast<float*>(data),
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(sidx),
      static_cast<const int32_t*>(line_ts),
      static_cast<const int32_t*>(line_origin),
      static_cast<const uint8_t*>(line_dirty),
      static_cast<const uint8_t*>(live), static_cast<const float*>(line_data),
      now, n, n_sets, n_ways, dim);
  return static_cast<int>(cudaGetLastError());
}
