// payload_hash: the payload lanes of M cache rows from their keys (and, for a
// mutable key, the version's timestamp), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the hash
// (repro/core/workload.py::payload_for, versioned_payload) to XLA, which
// fuses its uint32 arithmetic into one loop.  PyTorch has no uint32
// arithmetic, so the plain version (ref.py::payload_hash_ref, through
// utils/hashing.py) emulates it with int64 tensor ops and masks: 109
// elementwise launches a versioned call (54 an unversioned one), two calls a
// fog tick.  This kernel is those ops in one launch.  Contract: repro_torch/kernels/ref.py::payload_hash_ref,
// bit for bit.  Row r's base is a = hash2(key[r], data_ts[r]) when data_ts
// is given, else a = key[r] (both as uint32); lane d is hash2(a, d) as a
// float32, rounded to nearest, times 2**-32 (a power of two: exact, so the
// same bits as the plain version's division).
//
// What bounds it on the card: the launch.  The tick's calls hash 667 to
// 10,000 rows of D = 8 lanes (21 to 320 KB written, a few us of device time
// on an H100); the kernel exists to make the hash one launch.
//
// Design: one thread a row.  The thread computes splitmix(a) and the row's
// part of the mix once, then each lane's second splitmix, and stores the
// row one float at a time (wider stores buy nothing at a few hundred KB,
// inside the launch).  Native uint32_t arithmetic wraps as the plain
// version's masks do.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr float kScale = 0x1p-32f;

__device__ __forceinline__ uint32_t splitmix(uint32_t x) {
  x += kGolden;
  x = (x ^ (x >> 16)) * kM1;
  x = (x ^ (x >> 13)) * kM2;
  return x ^ (x >> 16);
}

// The part of hash2(a, b) = splitmix(splitmix(a) ^ (b + mix_base(a))) that
// depends on a alone, beside splitmix(a).
__device__ __forceinline__ uint32_t mix_base(uint32_t a) { return kGolden + (a << 6) + (a >> 2); }

__device__ __forceinline__ uint32_t hash2(uint32_t a, uint32_t b) {
  return splitmix(splitmix(a) ^ (b + mix_base(a)));
}

// Lane b of a row whose base has splitmix ``mixed`` and mix_base ``base``.
__device__ __forceinline__ float lane_value(uint32_t mixed, uint32_t base, uint32_t b) {
  return static_cast<float>(splitmix(mixed ^ (b + base))) * kScale;
}

__global__ void __launch_bounds__(kThreads) payload_hash_rows(
    const int32_t* __restrict__ key, const int32_t* __restrict__ data_ts,
    float* __restrict__ out, long long m, int dim) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= m) return;
  uint32_t a = static_cast<uint32_t>(key[row]);
  if (data_ts != nullptr) a = hash2(a, static_cast<uint32_t>(data_ts[row]));
  const uint32_t mixed = splitmix(a);
  const uint32_t base = mix_base(a);
  float* dst = out + row * dim;
  for (int d = 0; d < dim; ++d) dst[d] = lane_value(mixed, base, d);
}

}  // namespace

// key (M,) int32; data_ts (M,) int32 or null (the unversioned payload); out
// (M, D) float32, every entry written.  All contiguous.
extern "C" int payload_hash_launch(const void* key, const void* data_ts, void* out, int m,
                                   int dim, void* stream) {
  if (m < 0 || dim < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || dim == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(m) + kThreads - 1) / kThreads);
  payload_hash_rows<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(key), static_cast<const int32_t*>(data_ts),
      static_cast<float*>(out), m, dim);
  return static_cast<int>(cudaGetLastError());
}
