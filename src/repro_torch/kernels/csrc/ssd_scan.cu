// ssd_scan: the Mamba2/SSD inter-chunk state recurrence, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan_pallas, which
// walks a (batch, chunk) grid in order and carries the (H, P, N) state in
// VMEM scratch from one chunk to the next.  Contract:
// repro_torch/kernels/ref.py::ssd_scan_ref.  With S_{-1} = init (zeros if
// none): prev[b, c] = S_{c-1} and S_c = decay[b, c, h] * S_{c-1} +
// states[b, c]; final[b] = S_{C-1}.  All float32.
//
// What bounds it on the card: bytes.  Every state is read once and every
// prev written once (plus init, decay and final); there is one multiply and
// one add per element, far below the float32 rate.
//
// Design: one thread per (b, h, p, n) lane, n fastest, so a warp reads and
// writes 128 contiguous bytes of each chunk's state.  The chunk loop that
// was the TPU's sequential grid axis runs inside the thread with the carry
// in a register; no block depends on another.  The loop is unrolled so the
// loads of later chunks' states, which do not depend on the carry, are in
// flight while the carry is updated.  The step rounds the product and then
// the sum (__fmul_rn, __fadd_rn: never contracted into a fused
// multiply-add), as PyTorch's multiply and add kernels do, so the kernel
// equals the plain version bitwise.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void ssd_scan_kernel(const float* __restrict__ states,
                                const float* __restrict__ decay,
                                const float* __restrict__ init,
                                float* __restrict__ prev,
                                float* __restrict__ final_state, int batch,
                                int chunks, int heads, int pn) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_batch = (long long)heads * pn;  // (H, P, N) of one chunk
  if (lane >= batch * per_batch) return;
  const int b = static_cast<int>(lane / per_batch);
  const long long r = lane - b * per_batch;           // offset within a chunk
  const int h = static_cast<int>(r / pn);
  float carry = init != nullptr ? init[lane] : 0.0f;
  const long long first = (long long)b * chunks;      // (b, chunk 0)
#pragma unroll 4
  for (int c = 0; c < chunks; ++c) {
    const long long off = (first + c) * per_batch + r;
    prev[off] = carry;
    carry = __fadd_rn(__fmul_rn(decay[(first + c) * heads + h], carry), states[off]);
  }
  final_state[lane] = carry;
}

}  // namespace

extern "C" int ssd_scan_launch(const void* states, const void* decay,
                               const void* init, void* prev, void* final_state,
                               int batch, int chunks, int heads, int pn,
                               void* stream) {
  const long long total = (long long)batch * heads * pn;
  if (total <= 0) return 0;
  const int threads = 256;
  ssd_scan_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(states), static_cast<const float*>(decay),
      static_cast<const float*>(init), static_cast<float*>(prev),
      static_cast<float*>(final_state), batch, chunks, heads, pn);
  return static_cast<int>(cudaGetLastError());
}
