// flic_merge: soft-coherence merge of two aligned FLIC cache shards, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flic_merge.py::flic_merge_pallas,
// which streams tiles of 256 sets through VMEM and computes the select mask
// once per tile for metadata and payload.  Contract:
// repro_torch/kernels/ref.py::flic_merge_ref.  Per line (s, w): take_b =
// valid_b && (!valid_a || ts_b > ts_a); tags, ts and the D payload lanes
// come from B where take_b, else from A; valid = valid_a || valid_b.  Ties
// keep A.  Any S, W and D.
//
// What bounds it on the card: bytes.  Each line reads both replicas'
// timestamp and valid flag, the chosen replica's tag and payload, and writes
// one of each; a compare and a select per field.  At D = 8 a line moves 87
// bytes for 4 compares, far below the card's ~20 operations a byte.
//
// Design (the first design ran a thread per line that copied its D payload
// lanes as D scalar loads and stores 32 bytes apart across the warp, so a
// warp instruction touched 32 sectors to move 128 bytes):
// * Every access 16 bytes wide and coalesced.  A warp takes a tile of
//   kSets = 16 consecutive sets, lane s < 16 one set: its W tags,
//   timestamps (one int4 a replica at W = 4) and valid flags (one 32-bit
//   word) from both replicas, all loaded before any compare
//   (flic_rows.cuh), then the W decisions as a bit mask.  The whole warp
//   then copies the tile's payload span: lane l moves 16-byte chunks l,
//   l + 32, ..., each from the replica that its line's owner chose (the
//   owner's mask by __shfl_sync), a batch of kBatch chunks loaded before
//   any is stored.  Only the chosen replica's
//   payload is read.  Both replicas' tags are read with the other metadata,
//   so that the payload round trip is the only one that waits on a
//   decision (4 bytes a line above the bound's count).
// * Enough bytes in flight: one-warp blocks, at most 24 an SM (ops.py
//   merge_blocks), each walking tiles by a grid stride; the dense
//   catch-up's 50,000 sets are one wave of ~24 warps an SM, and a small
//   merge spreads its warps over as many SMs.  (Tiles of 32 sets, a set a
//   lane, took as long on the catch-up and longer on small merges.)
// * Templated on W (1, 2, 4, 8) where the 12 tables start on 16-byte
//   boundaries and D % 4 == 0 (ops.py merge_plan).  Every other case is the
//   same kernel at W = 1 and 4-byte words over the S * W lines taken as
//   sets of one way: any W, D and alignment.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "flic_rows.cuh"

namespace {

constexpr int kThreads = 32;   // one warp a block
constexpr int kSets = 16;      // sets of a warp's tile (ops.py MERGE_SETS_PER_BLOCK)
constexpr int kBatch = 8;      // payload units a lane loads before it stores

template <int W, bool V>
__device__ __forceinline__ void store_ways(int32_t* p, const int (&v)[W]) {
  if constexpr (V && W % 4 == 0) {
#pragma unroll
    for (int k = 0; k < W / 4; ++k)
      reinterpret_cast<int4*>(p)[k] = make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else if constexpr (V && W == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) p[w] = v[w];
  }
}

template <int W, bool V>
__device__ __forceinline__ void store_flags(uint8_t* p, const bool (&v)[W]) {
  if constexpr (V && (W == 2 || W == 4 || W == 8)) {
    uint64_t bits = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) bits |= static_cast<uint64_t>(v[w]) << (8 * w);
    if constexpr (W == 2) *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(bits);
    if constexpr (W == 4) *reinterpret_cast<uint32_t*>(p) = static_cast<uint32_t>(bits);
    if constexpr (W == 8) *reinterpret_cast<unsigned long long*>(p) = bits;
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) p[w] = v[w] ? 1 : 0;
  }
}

// n_sets sets of W ways; a payload unit is 16 bytes under V (D % 4 == 0),
// else one 32-bit word.
template <int W, bool V>
__global__ void __launch_bounds__(kThreads) flic_merge_sets(
    const int32_t* __restrict__ tags_a, const int32_t* __restrict__ ts_a,
    const uint8_t* __restrict__ valid_a, const uint32_t* __restrict__ data_a,
    const int32_t* __restrict__ tags_b, const int32_t* __restrict__ ts_b,
    const uint8_t* __restrict__ valid_b, const uint32_t* __restrict__ data_b,
    int32_t* __restrict__ tags_o, int32_t* __restrict__ ts_o,
    uint8_t* __restrict__ valid_o, uint32_t* __restrict__ data_o,
    long long n_sets, int dim) {
  using Unit = typename std::conditional<V, uint4, uint32_t>::type;
  const Unit* pay_a = reinterpret_cast<const Unit*>(data_a);
  const Unit* pay_b = reinterpret_cast<const Unit*>(data_b);
  Unit* pay_o = reinterpret_cast<Unit*>(data_o);
  const int lane = threadIdx.x & 31;
  const int per_line = V ? dim / 4 : dim;   // units of a line
  const int per_set = W * per_line;         // units of a set
  const int n_tiles = static_cast<int>((n_sets + kSets - 1) / kSets);
  const int stride = gridDim.x * (kThreads / 32);
  for (int tile = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); tile < n_tiles;
       tile += stride) {
    const long long set0 = static_cast<long long>(tile) * kSets;
    const int n_here = static_cast<int>(min(static_cast<long long>(kSets), n_sets - set0));
    unsigned take = 0;   // bit w: way w of this lane's set takes B
    if (lane < n_here) {
      const long long at = (set0 + lane) * W;
      int sa[W], sb[W], ta[W], tb[W];
      bool va[W], vb[W];
      flic::load_ways<W, V>(ts_a + at, sa);
      flic::load_ways<W, V>(ts_b + at, sb);
      flic::load_flags<W, V>(valid_a + at, va);
      flic::load_flags<W, V>(valid_b + at, vb);
      flic::load_ways<W, V>(tags_a + at, ta);
      flic::load_ways<W, V>(tags_b + at, tb);
      int to[W], so[W];
      bool vo[W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const bool b = vb[w] && (!va[w] || sb[w] > sa[w]);
        take |= static_cast<unsigned>(b) << w;
        to[w] = b ? tb[w] : ta[w];
        so[w] = b ? sb[w] : sa[w];
        vo[w] = va[w] || vb[w];
      }
      store_ways<W, V>(tags_o + at, to);
      store_ways<W, V>(ts_o + at, so);
      store_flags<W, V>(valid_o + at, vo);
    }
    // The tile's payload span, per_lane units a lane: unit j of the span
    // belongs to set j / per_set of the tile (owned by that lane), way
    // (j % per_set) / per_line.
    const long long base = set0 * per_set;
    const int n_units = n_here * per_set;   // units of the tile's live sets
    const int per_lane = (kSets * per_set + 31) / 32;
    for (int k0 = 0; k0 < per_lane; k0 += kBatch) {
      Unit v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int j = lane + 32 * (k0 + k);
        const int set = j / per_set;
        const int way = (j - set * per_set) / per_line;
        const unsigned bits = __shfl_sync(0xffffffffu, take, set & 31);
        if (j < n_units) v[k] = ((bits >> way) & 1u ? pay_b : pay_a)[base + j];
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int j = lane + 32 * (k0 + k);
        if (j < n_units) pay_o[base + j] = v[k];
      }
    }
  }
}

template <int W, bool V>
int launch(const void* const* in, void* const* out, long long n_sets, int dim, int blocks,
           cudaStream_t stream) {
  flic_merge_sets<W, V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(in[0]), static_cast<const int32_t*>(in[1]),
      static_cast<const uint8_t*>(in[2]), static_cast<const uint32_t*>(in[3]),
      static_cast<const int32_t*>(in[4]), static_cast<const int32_t*>(in[5]),
      static_cast<const uint8_t*>(in[6]), static_cast<const uint32_t*>(in[7]),
      static_cast<int32_t*>(out[0]), static_cast<int32_t*>(out[1]),
      static_cast<uint8_t*>(out[2]), static_cast<uint32_t*>(out[3]), n_sets, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tags (S, W) int32, ts (S, W) int32, valid (S, W) bool and data (S, W, D)
// float32 of replicas A and B and of the output, all contiguous.  The plan
// (ops.py merge_plan): ways in {1, 2, 4, 8} with vec = 1 takes the 16-byte
// instantiation, which needs ways == W, D % 4 == 0 and all twelve tables on
// 16-byte boundaries; ways = 0 with vec = 0 takes the lines one by one
// (any W, D, alignment).  `blocks`: the grid (ops.py merge_blocks).
extern "C" int flic_merge_launch(
    const void* tags_a, const void* ts_a, const void* valid_a, const void* data_a,
    const void* tags_b, const void* ts_b, const void* valid_b, const void* data_b,
    void* tags_o, void* ts_o, void* valid_o, void* data_o, int n_sets,
    int n_ways, int dim, int ways, int vec, int blocks, void* stream) {
  const long long lines = static_cast<long long>(n_sets) * n_ways;
  if (lines <= 0) return 0;
  if ((lines + 31) / 32 > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const void* in[8] = {tags_a, ts_a, valid_a, data_a, tags_b, ts_b, valid_b, data_b};
  void* out[4] = {tags_o, ts_o, valid_o, data_o};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks <= 0 || dim < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (ways == 0 && !vec) return launch<1, false>(in, out, lines, dim, blocks, s);
  uintptr_t addr = 0;
  for (const void* p : in) addr |= reinterpret_cast<uintptr_t>(p);
  for (void* p : out) addr |= reinterpret_cast<uintptr_t>(p);
  if (!vec || ways != n_ways || dim % 4 != 0 || addr % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (ways) {
    case 1: return launch<1, true>(in, out, n_sets, dim, blocks, s);
    case 2: return launch<2, true>(in, out, n_sets, dim, blocks, s);
    case 4: return launch<4, true>(in, out, n_sets, dim, blocks, s);
    case 8: return launch<8, true>(in, out, n_sets, dim, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
