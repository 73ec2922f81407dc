// flic_lookup: set-associative probe of C FLIC caches by Q shared queries,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flic_lookup.py::flic_lookup_pallas,
// which the JAX package vmaps over caches with queries padded to a block of
// 128.  Contract: repro_torch/kernels/ref.py::flic_lookup_ref.  Per (cache,
// query): hit = any valid way whose tag matches; ts = the highest timestamp
// among matches (-1 if none); way = the first way at that timestamp (0 on a
// miss); payload = that way's D lanes (zeros on a miss).
//
// What bounds it on the card: bytes.  Each (cache, query) gathers one W-way
// set row of three tables and, on a hit, one payload line, and writes
// hit, ts, way and D payload lanes.
//
// Design: one launch over (C, Q), one thread per (cache, query), a loop
// over the W ways.  Neighbouring threads take neighbouring queries of one
// cache, so the outputs are written coalesced.  There is no padding: the
// kernel masks the ragged edge of C * Q itself, so the caller passes Q as
// it is.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void flic_lookup_kernel(
    const int32_t* __restrict__ tags, const int32_t* __restrict__ data_ts,
    const uint8_t* __restrict__ valid, const float* __restrict__ data,
    const int32_t* __restrict__ keys, const int32_t* __restrict__ sidx,
    uint8_t* __restrict__ hit, int32_t* __restrict__ ts_out,
    float* __restrict__ payload, int32_t* __restrict__ way_out, int c, int q,
    int n_sets, int n_ways, int dim) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)c * q) return;
  const int cache = static_cast<int>(i / q);
  const int qi = static_cast<int>(i % q);
  const int s = sidx[qi];
  float* out = payload + i * dim;
  if (s < 0 || s >= n_sets) {  // callers derive sidx as key % S
    hit[i] = 0;
    ts_out[i] = -1;
    way_out[i] = 0;
    for (int j = 0; j < dim; ++j) out[j] = 0.0f;
    return;
  }
  const int key = keys[qi];
  const long long base = ((long long)cache * n_sets + s) * n_ways;
  bool any = false;
  int best = -1, best_way = 0;
  for (int w = 0; w < n_ways; ++w) {
    const bool match = valid[base + w] && tags[base + w] == key;
    const int t = match ? data_ts[base + w] : -1;
    any |= match;
    if (w == 0 || t > best) {  // strict: the first way at the max wins
      best = t;
      best_way = w;
    }
  }
  hit[i] = any ? 1 : 0;
  ts_out[i] = best;
  way_out[i] = any ? best_way : 0;
  const float* src = data + (base + best_way) * dim;
  for (int j = 0; j < dim; ++j) out[j] = any ? src[j] : 0.0f;
}

}  // namespace

extern "C" int flic_lookup_launch(
    const void* tags, const void* data_ts, const void* valid, const void* data,
    const void* keys, const void* sidx, void* hit, void* ts, void* payload,
    void* way, int c, int q, int n_sets, int n_ways, int dim, void* stream) {
  const long long total = (long long)c * q;
  if (total <= 0) return 0;
  const int threads = 256;
  flic_lookup_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tags), static_cast<const int32_t*>(data_ts),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(data),
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(sidx),
      static_cast<uint8_t*>(hit), static_cast<int32_t*>(ts),
      static_cast<float*>(payload), static_cast<int32_t*>(way), c, q, n_sets,
      n_ways, dim);
  return static_cast<int>(cudaGetLastError());
}
