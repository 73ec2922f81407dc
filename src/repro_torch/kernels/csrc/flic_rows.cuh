// Set-row loads shared by the FLIC kernels (flic_insert.cu, flic_lookup.cu):
// the W ways of one set of an (N, S, W) table, all issued at once, as 16-byte
// (W = 4, 8) or 8-byte (W = 2) words where V says the table starts on a
// 16-byte boundary (a row then starts on a multiple of its own size), else
// as scalars.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace flic {

// Ways a runtime-W loop loads per round, before any compare.
constexpr int kRuntimeWays = 4;

// Way w of a row of n_ways, clamped to the last way: past the row a round
// repeats that way, and offering a way twice changes no election.
__device__ __forceinline__ int way_at(int w, int n_ways) { return w < n_ways ? w : n_ways - 1; }

// The W int32 ways of a row.
template <int W, bool V>
__device__ __forceinline__ void load_ways(const int32_t* p, int (&out)[W]) {
  if constexpr (V && W % 4 == 0) {
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      const int4 v = reinterpret_cast<const int4*>(p)[k];
      out[4 * k] = v.x;
      out[4 * k + 1] = v.y;
      out[4 * k + 2] = v.z;
      out[4 * k + 3] = v.w;
    }
  } else if constexpr (V && W == 2) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) out[w] = p[w];
  }
}

// The W valid flags (bytes) of a row; under V as one W-byte word.
template <int W, bool V>
__device__ __forceinline__ void load_flags(const uint8_t* p, bool (&out)[W]) {
  if constexpr (V && (W == 2 || W == 4 || W == 8)) {
    uint64_t bits;
    if constexpr (W == 2) bits = *reinterpret_cast<const uint16_t*>(p);
    if constexpr (W == 4) bits = *reinterpret_cast<const uint32_t*>(p);
    if constexpr (W == 8) bits = *reinterpret_cast<const unsigned long long*>(p);
#pragma unroll
    for (int w = 0; w < W; ++w) out[w] = ((bits >> (8 * w)) & 0xff) != 0;
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) out[w] = p[w] != 0;
  }
}

}  // namespace flic
