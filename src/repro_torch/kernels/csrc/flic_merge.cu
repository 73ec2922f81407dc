// flic_merge: soft-coherence merge of two aligned FLIC cache shards, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flic_merge.py::flic_merge_pallas,
// which streams tiles of 256 sets through VMEM and computes the select mask
// once per tile for metadata and payload.  Contract:
// repro_torch/kernels/ref.py::flic_merge_ref.  Per line (s, w): take_b =
// valid_b && (!valid_a || ts_b > ts_a); tags, ts and the D payload lanes
// come from B where take_b, else from A; valid = valid_a || valid_b.  Ties
// keep A.
//
// What bounds it on the card: bytes.  Each line reads both replicas' tag,
// timestamp, valid flag and payload and writes one of each; a compare and a
// select per field.
//
// Design: one thread per line, neighbouring threads on neighbouring lines,
// so the metadata loads and stores are coalesced; the thread copies its
// line's D payload lanes from the replica it chose, as 32-bit words (the
// bits are copied, never rounded).  Any number of sets: the kernel masks
// the ragged edge itself, where the TPU kernel needed S % 256 == 0.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void flic_merge_kernel(
    const int32_t* __restrict__ tags_a, const int32_t* __restrict__ ts_a,
    const uint8_t* __restrict__ valid_a, const uint32_t* __restrict__ data_a,
    const int32_t* __restrict__ tags_b, const int32_t* __restrict__ ts_b,
    const uint8_t* __restrict__ valid_b, const uint32_t* __restrict__ data_b,
    int32_t* __restrict__ tags_o, int32_t* __restrict__ ts_o,
    uint8_t* __restrict__ valid_o, uint32_t* __restrict__ data_o,
    long long lines, int dim) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lines) return;
  const bool va = valid_a[i] != 0;
  const bool vb = valid_b[i] != 0;
  const int32_t ta = ts_a[i];
  const int32_t tb = ts_b[i];
  const bool take_b = vb && (!va || tb > ta);
  tags_o[i] = take_b ? tags_b[i] : tags_a[i];
  ts_o[i] = take_b ? tb : ta;
  valid_o[i] = (va || vb) ? 1 : 0;
  const uint32_t* src = (take_b ? data_b : data_a) + i * dim;
  uint32_t* dst = data_o + i * dim;
  for (int j = 0; j < dim; ++j) dst[j] = src[j];
}

}  // namespace

extern "C" int flic_merge_launch(
    const void* tags_a, const void* ts_a, const void* valid_a, const void* data_a,
    const void* tags_b, const void* ts_b, const void* valid_b, const void* data_b,
    void* tags_o, void* ts_o, void* valid_o, void* data_o, int n_sets,
    int n_ways, int dim, void* stream) {
  const long long lines = (long long)n_sets * n_ways;
  if (lines <= 0) return 0;
  const int threads = 256;
  flic_merge_kernel<<<(unsigned)((lines + threads - 1) / threads), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tags_a), static_cast<const int32_t*>(ts_a),
      static_cast<const uint8_t*>(valid_a), static_cast<const uint32_t*>(data_a),
      static_cast<const int32_t*>(tags_b), static_cast<const int32_t*>(ts_b),
      static_cast<const uint8_t*>(valid_b), static_cast<const uint32_t*>(data_b),
      static_cast<int32_t*>(tags_o), static_cast<int32_t*>(ts_o),
      static_cast<uint8_t*>(valid_o), static_cast<uint32_t*>(data_o), lines, dim);
  return static_cast<int>(cudaGetLastError());
}
