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
// What bounds it on the card: bytes where C * Q is large (the (C, Q, D)
// payload output), latency where it is small.  Each (cache, query) reads
// one W-way set row of three tables and, on a hit, one payload line, and
// writes hit, ts, way and D payload lanes.
//
// Design: a 2-D grid, caches x query blocks, a thread per (cache, query),
// no index division and no padding (the kernel masks the ragged edge of Q).
// Neighbouring threads take neighbouring queries of one cache, so the
// outputs go out coalesced, the payload as float4 where D % 4 == 0 on
// 16-byte aligned storage.  A thread loads the query's key and set index,
// then the whole set row (tags, valid and data_ts of all W ways, as int4 /
// one W-byte word at W = 4 under ROW16), then the payload gather: three
// dependent round trips to device memory.  flic_lookup_probe<W, ROW16,
// PAY16> is chosen on the host by ops.lookup_plan_for: W in {1, 2, 4, 8}
// has compile-time loops, W = 0 a runtime-W loop for other values.  The
// host sets the block size (ops.lookup_threads: up to 256, no more warps
// than Q needs).
#include <cstdint>

#include <cuda_runtime.h>

#include "flic_rows.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kPrefetch = 8;     // payload floats gathered in one round

struct Tables {
  const int32_t* tags;
  const int32_t* data_ts;
  const uint8_t* valid;
  const float* data;
};

struct Queries {
  const int32_t* keys;
  const int32_t* sidx;
};

struct Out {
  uint8_t* hit;
  int32_t* ts;
  float* payload;
  int32_t* way;
};

// The answer of one (cache, query) probe.
struct Probe {
  bool any;
  int best;
  int way;
};

// Election over one way: a match offers its timestamp, a miss -1; the first
// way at the highest offer wins.
__device__ __forceinline__ void offer(Probe& p, int w, bool valid, int tag, int dts, int key) {
  const bool match = valid && tag == key;
  const int t = match ? dts : -1;
  p.any |= match;
  if (w == 0 || t > p.best) {
    p.best = t;
    p.way = w;
  }
}

// A set row of W ways (W = 0: n_ways, runtime) at tags / dts / valid.
template <int W, bool ROW16>
__device__ __forceinline__ Probe probe_row(const int32_t* tags, const int32_t* dts,
                                           const uint8_t* valid, int n_ways, int key) {
  Probe p{false, -1, 0};
  if constexpr (W > 0) {
    int tag[W], ts[W];
    bool v[W];
    flic::load_ways<W, ROW16>(tags, tag);
    flic::load_flags<W, ROW16>(valid, v);
    flic::load_ways<W, ROW16>(dts, ts);
#pragma unroll
    for (int w = 0; w < W; ++w) offer(p, w, v[w], tag[w], ts[w], key);
  } else {
    // flic::kRuntimeWays ways a round, all loaded before any compare.
    for (int w0 = 0; w0 < n_ways; w0 += flic::kRuntimeWays) {
      int tag[flic::kRuntimeWays], ts[flic::kRuntimeWays];
      bool v[flic::kRuntimeWays];
#pragma unroll
      for (int k = 0; k < flic::kRuntimeWays; ++k) {
        const int w = flic::way_at(w0 + k, n_ways);
        tag[k] = tags[w];
        v[k] = valid[w] != 0;
        ts[k] = dts[w];
      }
#pragma unroll
      for (int k = 0; k < flic::kRuntimeWays; ++k) {
        offer(p, flic::way_at(w0 + k, n_ways), v[k], tag[k], ts[k], key);
      }
    }
  }
  return p;
}

// Write the answer of output row i; src is the winning line's payload.
template <bool PAY16>
__device__ __forceinline__ void answer(const Out& o, long long i, const Probe& p,
                                       const float* src, int dim) {
  o.hit[i] = p.any ? 1 : 0;
  o.ts[i] = p.best;
  o.way[i] = p.any ? p.way : 0;
  float* dst = o.payload + i * dim;
  if constexpr (PAY16) {
    constexpr int kPre = kPrefetch / 4;
    const int chunks = dim / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 v[kPre];
#pragma unroll
    for (int k = 0; k < kPre; ++k) v[k] = (p.any && k < chunks) ? s4[k] : zero;
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
      if (k < chunks) d4[k] = v[k];
    }
#pragma unroll 1
    for (int k = kPre; k < chunks; ++k) d4[k] = p.any ? s4[k] : zero;
  } else {
    float v[kPrefetch];
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) v[j] = (p.any && j < dim) ? src[j] : 0.f;
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      if (j < dim) dst[j] = v[j];
    }
#pragma unroll 1
    for (int j = kPrefetch; j < dim; ++j) dst[j] = p.any ? src[j] : 0.f;
  }
}

template <int W, bool ROW16, bool PAY16>
__global__ void __launch_bounds__(kMaxThreads) flic_lookup_probe(
    Tables t, Queries q, Out o, int n_queries, int n_sets, int n_ways, int dim) {
  const int cache = blockIdx.x;
  const int qi = blockIdx.y * blockDim.x + threadIdx.x;
  if (qi >= n_queries) return;
  const long long i = static_cast<long long>(cache) * n_queries + qi;
  const int s = q.sidx[qi];
  const int key = q.keys[qi];
  const int ways = W > 0 ? W : n_ways;
  Probe p{false, -1, 0};
  long long row = 0;
  if (s >= 0 && s < n_sets) {  // callers derive sidx as key % S
    row = (static_cast<long long>(cache) * n_sets + s) * ways;
    p = probe_row<W, ROW16>(t.tags + row, t.data_ts + row, t.valid + row, n_ways, key);
  }
  answer<PAY16>(o, i, p, t.data + (row + p.way) * dim, dim);
}

struct Launch {
  Tables t;
  Queries q;
  Out o;
  int c, n_queries, n_sets, n_ways, dim, threads;
  cudaStream_t stream;

  dim3 grid() const {
    return dim3(c, (n_queries + threads - 1) / threads);
  }
};

template <int W, bool ROW16, bool PAY16>
void launch_probe(const Launch& l) {
  flic_lookup_probe<W, ROW16, PAY16><<<l.grid(), l.threads, 0, l.stream>>>(
      l.t, l.q, l.o, l.n_queries, l.n_sets, l.n_ways, l.dim);
}

// The instantiations that ops.lookup_plan_for can choose (see flic_insert.cu):
// no scalar row with float4 payload copies above W = 1.
template <int W, bool PAY16>
int launch_row(const Launch& l, bool row16) {
  if constexpr (W <= 1) {
    if (row16) return static_cast<int>(cudaErrorInvalidValue);
    launch_probe<W, false, PAY16>(l);
  } else if constexpr (PAY16) {
    if (!row16) return static_cast<int>(cudaErrorInvalidValue);
    launch_probe<W, true, true>(l);
  } else if (row16) {
    launch_probe<W, true, false>(l);
  } else {
    launch_probe<W, false, false>(l);
  }
  return 0;
}

template <bool PAY16>
int by_ways(const Launch& l, int ways_t, bool row16) {
  switch (ways_t) {
    case 0: return launch_row<0, PAY16>(l, row16);
    case 1: return launch_row<1, PAY16>(l, row16);
    case 2: return launch_row<2, PAY16>(l, row16);
    case 4: return launch_row<4, PAY16>(l, row16);
    case 8: return launch_row<8, PAY16>(l, row16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// ways_t: W of a compile-time instantiation (1, 2, 4, 8; it must equal
// n_ways) or 0 for the runtime-W loop.  row16 / pay16: 16-byte row loads
// and payload copies (the caller has checked the alignment;
// pay16 also needs dim % 4 == 0).  threads: a query block, a multiple of
// 32 of at most 256.
extern "C" int flic_lookup_launch(
    const void* tags, const void* data_ts, const void* valid, const void* data,
    const void* keys, const void* sidx, void* hit, void* ts, void* payload,
    void* way, int c, int q, int n_sets, int n_ways, int dim, int ways_t,
    int row16, int pay16, int threads, void* stream) {
  if (c <= 0 || q <= 0) return 0;
  if ((ways_t != 0 && ways_t != n_ways) || n_ways <= 0 || (pay16 && dim % 4 != 0) ||
      threads <= 0 || threads > kMaxThreads || threads % 32 != 0 ||
      (q + threads - 1) / threads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch l{
      {static_cast<const int32_t*>(tags), static_cast<const int32_t*>(data_ts),
       static_cast<const uint8_t*>(valid), static_cast<const float*>(data)},
      {static_cast<const int32_t*>(keys), static_cast<const int32_t*>(sidx)},
      {static_cast<uint8_t*>(hit), static_cast<int32_t*>(ts), static_cast<float*>(payload),
       static_cast<int32_t*>(way)},
      c, q, n_sets, n_ways, dim, threads, static_cast<cudaStream_t>(stream)};
  const int err = pay16 ? by_ways<true>(l, ways_t, row16 != 0)
                        : by_ways<false>(l, ways_t, row16 != 0);
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}
