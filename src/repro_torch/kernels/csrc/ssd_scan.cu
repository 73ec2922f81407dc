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
//
// The backward (ssd_scan_bwd_launch) replaces no TPU kernel: the JAX
// package differentiates its lax.scan with XLA.  Contract:
// repro_torch/kernels/ref.py::ssd_scan_bwd_ref.  With A_{C-1} = g_final and
// A_{c-1} = g_prev[c] + decay[c] * A_c: g_states[c] = A_c, g_init =
// g_prev[0] + decay[0] * A_0, g_decay[b, c, h] = sum over (p, n) of
// A_c * prev[c].  Bytes bound it too: g_prev, prev and g_states are moved
// once each.  One thread per (b, h, p, n) lane walks the chunks in reverse
// with the adjoint in a register, rounding as the forward does, so g_states
// and g_init equal the plain version bitwise.  The block of a (b, h) and a
// range of 256 lanes sums its products of each chunk in a fixed order (a
// shuffle tree in each warp, then the warp sums in warp order) into one
// partial; a second kernel adds a (b, c, h)'s partials in block order.
// There are no float atomics, so two calls give the same bits; the order of
// the sum is not PyTorch's, so g_decay is held to the plain version within
// a tolerance (ref.ssd_scan_bwd_decay_tol).
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

constexpr int kBwdThreads = 256;

// The sum of v over the block in a fixed order, in thread 0 (every thread
// of the block must call it).
__device__ float block_sum(float v, float* warp_sums) {
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kBwdThreads / 32; ++w) total = __fadd_rn(total, warp_sums[w]);
  }
  __syncthreads();  // warp_sums is written again for the next chunk
  return total;
}

// grid (ceil(pn / 256), batch * heads); partial holds one float per
// (b, c, h) and block column, in block order.
__global__ void __launch_bounds__(kBwdThreads)
ssd_scan_bwd_kernel(const float* __restrict__ g_prev,
                    const float* __restrict__ g_final,
                    const float* __restrict__ prev,
                    const float* __restrict__ decay,
                    float* __restrict__ g_states, float* __restrict__ g_init,
                    float* __restrict__ partial, int chunks, int heads, int pn) {
  __shared__ float warp_sums[kBwdThreads / 32];
  const int bh = blockIdx.y;  // b * heads + h
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int cols = gridDim.x;
  const long long l = (long long)blockIdx.x * kBwdThreads + threadIdx.x;
  const bool active = l < pn;
  const long long lane = (long long)bh * pn + l;  // offset in (B, H, P, N)
  float a = (active && g_final != nullptr) ? g_final[lane] : 0.0f;
  for (int c = chunks - 1; c >= 0; --c) {
    const long long row = ((long long)b * chunks + c) * heads + h;  // (b, c, h)
    const long long off = row * pn + l;
    float prod = 0.0f;
    float gp = 0.0f;
    if (active) {
      g_states[off] = a;
      prod = __fmul_rn(a, prev[off]);
      gp = g_prev[off];
    }
    const float s = block_sum(prod, warp_sums);
    if (threadIdx.x == 0) partial[row * cols + blockIdx.x] = s;
    a = __fadd_rn(gp, __fmul_rn(decay[row], a));
  }
  if (active && g_init != nullptr) g_init[lane] = a;
}

// One thread per (b, c, h): its block partials added in block order.
__global__ void ssd_scan_bwd_decay_kernel(const float* __restrict__ partial,
                                          float* __restrict__ g_decay,
                                          long long rows, int cols) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  float s = 0.0f;
  for (int j = 0; j < cols; ++j) s = __fadd_rn(s, partial[row * cols + j]);
  g_decay[row] = s;
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

// cols must be ceil(pn / 256), the block columns the wrapper sized partial
// (batch * chunks * heads * cols floats) for; batch * heads <= 65,535.
extern "C" int ssd_scan_bwd_launch(const void* g_prev, const void* g_final,
                                   const void* prev, const void* decay,
                                   void* g_states, void* g_decay, void* g_init,
                                   void* partial, int batch, int chunks,
                                   int heads, int pn, int cols, void* stream) {
  if ((long long)cols * kBwdThreads < pn || batch * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((long long)batch * heads * pn <= 0 || chunks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ssd_scan_bwd_kernel<<<dim3(cols, batch * heads), kBwdThreads, 0, s>>>(
      static_cast<const float*>(g_prev), static_cast<const float*>(g_final),
      static_cast<const float*>(prev), static_cast<const float*>(decay),
      static_cast<float*>(g_states), static_cast<float*>(g_init),
      static_cast<float*>(partial), chunks, heads, pn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = (long long)batch * chunks * heads;
  const int threads = 256;
  ssd_scan_bwd_decay_kernel<<<(unsigned)((rows + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(g_decay), rows, cols);
  return static_cast<int>(cudaGetLastError());
}
