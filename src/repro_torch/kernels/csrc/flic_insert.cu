// flic_insert: batched one-line-per-node upsert over the eight FLIC cache
// tables, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flic_insert.py::flic_insert_pallas.
// Contract: repro_torch/kernels/ref.py::flic_insert_ref.  Per node: pick the
// first matching valid way, else the first invalid way, else the first least
// recently used way (strict <); write the line unless the lane is dead or a
// present copy is as new or newer; ins_ts = last_use = now.  No eviction
// record.
//
// What bounds it on the card: for the main path's calls, latency.  Per node
// it reads one W-way set row of four tables and its incoming line, and
// writes at most one line (7 scalars + D payload floats): a few hundred KB a
// call, well under a microsecond of bytes, while each dependent round trip
// to device memory costs ~0.5-0.8 us.  So the design counts round trips.
//
// Design: the tables are updated IN PLACE (the counterpart of the Pallas
// kernel's input_output_aliases), all N caches in one launch; rows of
// different nodes are disjoint, so no atomics and no ordering are needed.
// A thread's loads come in two rounds:
//   1. the node's inputs (key, set index, timestamp, origin, dirty, live)
//      and the first kPrefetch floats of its payload, all independent;
//   2. the whole set row, all W ways of tags, valid, last_use AND data_ts,
//      loaded before any compare (no load waits on a valid flag, and the
//      present copy's timestamp needs no third trip).
// The election then runs in registers and the stores go out.
//
// Instantiations (chosen on the host by ops.insert_plan_for):
// flic_insert_node<W, ROW16, PAY16>, a thread per node.  W in {1, 2, 4, 8}
// has compile-time loops; W = 0 loops over the runtime n_ways, four ways
// a round, each round loaded before any compare.  ROW16:
// the tables start on 16-byte boundaries, so a row is read as int4 / int2
// words (W = 4: one int4 each of tags, last_use and data_ts, one 32-bit word
// of valid flags).  PAY16: D % 4 == 0 on 16-byte aligned storage, payload
// moved as float4 (D = 8: two loads, two stores).  Otherwise scalars.
// The host also sets the block size (ops.insert_threads): one warp a block
// where 128-thread blocks would leave most SMs idle, so that the random row
// loads of a small N queue on more SMs.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "flic_rows.cuh"

namespace {

constexpr int kMaxThreads = 128;
constexpr int kPrefetch = 8;   // payload floats loaded in the first round

struct Tables {
  int32_t* tags;
  int32_t* data_ts;
  int32_t* ins_ts;
  int32_t* origin;
  uint8_t* valid;
  uint8_t* dirty;
  int32_t* last_use;
  float* data;
};

struct Lines {
  const int32_t* keys;
  const int32_t* sidx;
  const int32_t* ts;
  const int32_t* origin;
  const uint8_t* dirty;
  const uint8_t* live;
  const float* data;
};

// Payload chunk k of a line: 4 floats (PAY16) or 1.
template <bool PAY16>
__device__ __forceinline__ float4 load_chunk(const float* p, int k) {
  if constexpr (PAY16) return reinterpret_cast<const float4*>(p)[k];
  return make_float4(p[k], 0.f, 0.f, 0.f);
}

template <bool PAY16>
__device__ __forceinline__ void store_chunk(float* p, int k, float4 v) {
  if constexpr (PAY16) {
    reinterpret_cast<float4*>(p)[k] = v;
  } else {
    p[k] = v.x;
  }
}

// The election over a set row, way by way: the first present copy, the
// first invalid way, the first least-recently-used valid way.
struct Pick {
  int present = -1, present_ts = 0, invalid = -1, lru = 0, lru_use = INT_MAX;

  __device__ __forceinline__ void offer(int w, bool valid, int tag, int use, int dts, int key) {
    if (valid) {
      if (present < 0 && tag == key) {
        present = w;
        present_ts = dts;
      }
      if (use < lru_use) {  // strict: the first least-recent way wins
        lru_use = use;
        lru = w;
      }
    } else if (invalid < 0) {
      invalid = w;
    }
  }
};

template <int W, bool ROW16, bool PAY16>
__global__ void __launch_bounds__(kMaxThreads) flic_insert_node(
    Tables t, Lines in, int now, int n, int n_sets, int n_ways, int dim) {
  constexpr int kStep = PAY16 ? 4 : 1;
  constexpr int kPre = kPrefetch / kStep;
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n) return;
  const int chunks = dim / kStep;

  // Round 1: the node's inputs and the head of its payload.
  const bool live = in.live[node] != 0;
  const int s = in.sidx[node];
  const int key = in.keys[node];
  const int ts = in.ts[node];
  const int org = in.origin[node];
  const uint8_t dty = in.dirty[node] != 0;
  const float* src = in.data + static_cast<long long>(node) * dim;
  float4 pre[kPre];
#pragma unroll
  for (int k = 0; k < kPre; ++k) {
    pre[k] = k < chunks ? load_chunk<PAY16>(src, k) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (!live || s < 0 || s >= n_sets) return;  // callers derive sidx as key % S

  // Round 2: the whole set row.
  const long long row = (static_cast<long long>(node) * n_sets + s) * (W > 0 ? W : n_ways);
  Pick p;
  if constexpr (W > 0) {
    int tag[W], use[W], dts[W];
    bool valid[W];
    flic::load_ways<W, ROW16>(t.tags + row, tag);
    flic::load_flags<W, ROW16>(t.valid + row, valid);
    flic::load_ways<W, ROW16>(t.last_use + row, use);
    flic::load_ways<W, ROW16>(t.data_ts + row, dts);
#pragma unroll
    for (int w = 0; w < W; ++w) p.offer(w, valid[w], tag[w], use[w], dts[w], key);
  } else {
    // flic::kRuntimeWays ways a round, all loaded before any compare.
    for (int w0 = 0; w0 < n_ways; w0 += flic::kRuntimeWays) {
      int tag[flic::kRuntimeWays], use[flic::kRuntimeWays], dts[flic::kRuntimeWays];
      bool valid[flic::kRuntimeWays];
#pragma unroll
      for (int k = 0; k < flic::kRuntimeWays; ++k) {
        const int w = flic::way_at(w0 + k, n_ways);
        tag[k] = t.tags[row + w];
        valid[k] = t.valid[row + w] != 0;
        use[k] = t.last_use[row + w];
        dts[k] = t.data_ts[row + w];
      }
#pragma unroll
      for (int k = 0; k < flic::kRuntimeWays; ++k) {
        p.offer(flic::way_at(w0 + k, n_ways), valid[k], tag[k], use[k], dts[k], key);
      }
    }
  }
  if (p.present >= 0 && ts <= p.present_ts) return;  // a present copy as new or newer
  const int way = p.present >= 0 ? p.present : (p.invalid >= 0 ? p.invalid : p.lru);
  const long long line = row + way;
  t.tags[line] = key;
  t.data_ts[line] = ts;
  t.ins_ts[line] = now;
  t.origin[line] = org;
  t.valid[line] = 1;
  t.dirty[line] = dty;
  t.last_use[line] = now;
  float* dst = t.data + line * dim;
#pragma unroll
  for (int k = 0; k < kPre; ++k) {
    if (k < chunks) store_chunk<PAY16>(dst, k, pre[k]);
  }
  // Rolled: unrolled, the tail spills, and D <= kPrefetch on the main path.
#pragma unroll 1
  for (int k = kPre; k < chunks; ++k) store_chunk<PAY16>(dst, k, load_chunk<PAY16>(src, k));
}

struct Launch {
  Tables t;
  Lines in;
  int now, n, n_sets, n_ways, dim, threads;
  cudaStream_t stream;
};

template <int W, bool ROW16, bool PAY16>
void launch_node(const Launch& l) {
  flic_insert_node<W, ROW16, PAY16><<<(l.n + l.threads - 1) / l.threads, l.threads, 0, l.stream>>>(
      l.t, l.in, l.now, l.n, l.n_sets, l.n_ways, l.dim);
}

// The instantiations that ops.insert_plan_for can choose: row16 and pay16 come
// from one alignment test, so a row read in scalars never goes with float4
// payload copies, except at W <= 1 (no row vector).
template <int W, bool PAY16>
int launch_node_row(const Launch& l, bool row16) {
  if constexpr (W <= 1) {
    if (row16) return static_cast<int>(cudaErrorInvalidValue);
    launch_node<W, false, PAY16>(l);
  } else if constexpr (PAY16) {
    if (!row16) return static_cast<int>(cudaErrorInvalidValue);
    launch_node<W, true, true>(l);
  } else if (row16) {
    launch_node<W, true, false>(l);
  } else {
    launch_node<W, false, false>(l);
  }
  return 0;
}

template <bool PAY16>
int launch(const Launch& l, int ways_t, bool row16) {
  switch (ways_t) {
    case 0: return launch_node_row<0, PAY16>(l, row16);
    case 1: return launch_node_row<1, PAY16>(l, row16);
    case 2: return launch_node_row<2, PAY16>(l, row16);
    case 4: return launch_node_row<4, PAY16>(l, row16);
    case 8: return launch_node_row<8, PAY16>(l, row16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// ways_t: W of a compile-time instantiation (1, 2, 4, 8; it must equal
// n_ways), or 0 for the runtime-W loop (any W).  row16 / pay16:
// the 16-byte row loads and payload copies (the caller has checked the
// alignment; pay16 also needs dim % 4 == 0).  threads: the block size, a
// multiple of 32 of at most 128.
extern "C" int flic_insert_launch(
    void* tags, void* data_ts, void* ins_ts, void* origin, void* valid,
    void* dirty, void* last_use, void* data, const void* keys,
    const void* sidx, const void* line_ts, const void* line_origin,
    const void* line_dirty, const void* live, const void* line_data,
    int now, int n, int n_sets, int n_ways, int dim, int ways_t, int row16,
    int pay16, int threads, void* stream) {
  if (n <= 0) return 0;
  if ((ways_t != 0 && ways_t != n_ways) || n_ways <= 0 || (pay16 && dim % 4 != 0) ||
      threads <= 0 || threads > kMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch l{
      {static_cast<int32_t*>(tags), static_cast<int32_t*>(data_ts),
       static_cast<int32_t*>(ins_ts), static_cast<int32_t*>(origin),
       static_cast<uint8_t*>(valid), static_cast<uint8_t*>(dirty),
       static_cast<int32_t*>(last_use), static_cast<float*>(data)},
      {static_cast<const int32_t*>(keys), static_cast<const int32_t*>(sidx),
       static_cast<const int32_t*>(line_ts), static_cast<const int32_t*>(line_origin),
       static_cast<const uint8_t*>(line_dirty), static_cast<const uint8_t*>(live),
       static_cast<const float*>(line_data)},
      now, n, n_sets, n_ways, dim, threads, static_cast<cudaStream_t>(stream)};
  const int err = pay16 ? launch<true>(l, ways_t, row16 != 0)
                        : launch<false>(l, ways_t, row16 != 0);
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}
