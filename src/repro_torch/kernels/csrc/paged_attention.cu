// paged_attention: one-token decode attention through a FLIC page table,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_attention_pallas, whose grid walks (sequence, KV head, page) in
// order and DMAs every page slot from page 0, masking the ones past the
// sequence's length.  Contract: repro_torch/kernels/ref.py::
// paged_attention_ref.  For each sequence b and KV head h, the G query heads
// q[b, h] attend over the first lengths[b] positions of the pages that
// page_table[b] names: scores in f32 scaled by 1/sqrt(D), positions at or
// past the length masked with -1e30, an online softmax (running max m, sum
// l, accumulator acc[G, D]) in f32, output acc / max(l, 1e-37) in q's dtype.
//
// What bounds it on the card: bytes.  At decode each (sequence, KV head)
// reads its K and V rows of the live pages once and does 4*G*D flops per
// position, about G/2 flops per byte of bf16 K/V, far below the ~295 the
// card needs to be bound by operations.
//
// Design: one block of 128 threads per (sequence, KV head); it loads its
// own page-table row and length (there is no scalar prefetch here).  It
// walks only the ceil(length / page) live pages, never the masked ones,
// a tile of up to 64 positions (several pages) at a time: the K and V rows
// of the tile are brought into shared memory with 16-byte loads, threads on
// neighbouring addresses of a row.  The G query heads share each tile.
// Scores: one thread per (head, position), each walking D from its own
// offset so that a warp's reads of q and K fall in different banks.
// Softmax update: one warp per head.  PV product: one thread per (head, d)
// of acc, which lives in shared memory.  A length <= 0 walks every page
// slot, where all scores are -1e30 and the softmax is uniform, as in the
// plain version; a page id outside the pool makes that (sequence, head)
// output NaN instead of reading outside the pool.
//
// Left for later work: splitting a long sequence's pages over several blocks
// (flash decoding) so that B*Hkv < 132 SMs still fills the card, cp.async
// or TMA double buffering of the next tile behind the current one, and
// tensor-core mma for the (G x tile) score and PV products.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileTokens = 64;
constexpr int kDefaultSmem = 48 * 1024;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

struct Layout {  // byte offsets into dynamic shared memory
  int k, v, q, acc, s, m, l, alpha, pg, bad, total;
};

template <typename TKV>
__host__ __device__ Layout smem_layout(int g, int d, int tile_tokens, int tile_pages) {
  Layout o;
  const int kv = tile_tokens * d * static_cast<int>(sizeof(TKV));  // a multiple of 16
  o.k = 0;
  o.v = o.k + kv;
  o.q = o.v + kv;
  o.acc = o.q + g * d * 4;
  o.s = o.acc + g * d * 4;
  o.m = o.s + g * tile_tokens * 4;
  o.l = o.m + g * 4;
  o.alpha = o.l + g * 4;
  o.pg = o.alpha + g * 4;
  o.bad = o.pg + tile_pages * 4;
  o.total = o.bad + 4;
  return o;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const int32_t* __restrict__ table,
    const int32_t* __restrict__ lengths, TQ* __restrict__ out, int hkv, int g,
    int d, int page, int n_pool, int max_pages, int tile_pages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_tokens = tile_pages * page;
  const Layout lay = smem_layout<TKV>(g, d, tile_tokens, tile_pages);
  TKV* s_k = reinterpret_cast<TKV*>(smem + lay.k);
  TKV* s_v = reinterpret_cast<TKV*>(smem + lay.v);
  float* s_q = reinterpret_cast<float*>(smem + lay.q);
  float* s_acc = reinterpret_cast<float*>(smem + lay.acc);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);
  float* s_m = reinterpret_cast<float*>(smem + lay.m);
  float* s_l = reinterpret_cast<float*>(smem + lay.l);
  float* s_alpha = reinterpret_cast<float*>(smem + lay.alpha);
  int* s_pg = reinterpret_cast<int*>(smem + lay.pg);
  int* s_bad = reinterpret_cast<int*>(smem + lay.bad);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int n_warps = kThreads / 32;
  const int gd = g * d;

  const int len = lengths[b];
  int n_pages = len > 0 ? (len + page - 1) / page : max_pages;
  if (n_pages > max_pages) n_pages = max_pages;

  const TQ* q_bh = q + (static_cast<long long>(b) * hkv + h) * gd;
  for (int i = tid; i < gd; i += kThreads) {
    s_q[i] = to_f32(q_bh[i]);
    s_acc[i] = 0.0f;
  }
  for (int i = tid; i < g; i += kThreads) {
    s_m[i] = kNegInf;
    s_l[i] = 0.0f;
  }
  if (tid == 0) *s_bad = 0;

  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  constexpr int vec = 16 / static_cast<int>(sizeof(TKV));  // elements per 16-byte load
  const int chunks_row = d / vec;
  const long long row_stride = static_cast<long long>(hkv) * d;  // between positions
  const long long page_stride = page * row_stride;
  const int32_t* table_b = table + static_cast<long long>(b) * max_pages;

  for (int p0 = 0; p0 < n_pages; p0 += tile_pages) {
    const int np = min(tile_pages, n_pages - p0);
    const int tokens = np * page;
    __syncthreads();  // the previous tile's readers are done
    if (tid < np) {
      const int pg = table_b[p0 + tid];
      s_pg[tid] = pg;
      if (pg < 0 || pg >= n_pool) atomicOr(s_bad, 1);
    }
    __syncthreads();
    if (*s_bad) break;  // uniform: every thread reads the same flag

#pragma unroll 4
    for (int c = tid; c < tokens * chunks_row; c += kThreads) {
      const int tt = c / chunks_row;  // position within the tile
      const int j = c - tt * chunks_row;
      const long long off = s_pg[tt / page] * page_stride + (tt % page) * row_stride +
                            static_cast<long long>(h) * d + j * vec;
      reinterpret_cast<uint4*>(s_k)[c] = *reinterpret_cast<const uint4*>(k_pages + off);
      reinterpret_cast<uint4*>(s_v)[c] = *reinterpret_cast<const uint4*>(v_pages + off);
    }
    __syncthreads();

    // Scores: one thread per (head, position).  Each walks D from its own
    // offset t % D, so the threads of a warp, on neighbouring positions,
    // read different shared-memory banks of both q and K.
    const int pos0 = p0 * page;
    for (int pair = tid; pair < g * tokens; pair += kThreads) {
      const int gi = pair / tokens;
      const int t = pair - gi * tokens;
      const float* q_g = s_q + gi * d;
      const TKV* k_t = s_k + t * d;
      float acc = 0.0f;
      int dd = t % d;
      for (int j = 0; j < d; ++j) {
        acc += q_g[dd] * to_f32(k_t[dd]);
        dd = dd + 1 == d ? 0 : dd + 1;
      }
      s_s[gi * tile_tokens + t] = (pos0 + t < len) ? acc * scale : kNegInf;
    }
    __syncthreads();

    // Online softmax: one warp per query head.
    for (int gi = warp; gi < g; gi += n_warps) {
      float* sc = s_s + gi * tile_tokens;
      const float m_prev = s_m[gi];
      float mx = m_prev;
      for (int t = lane; t < tokens; t += 32) mx = fmaxf(mx, sc[t]);
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.0f;
      for (int t = lane; t < tokens; t += 32) {
        const float e = expf(sc[t] - mx);
        sc[t] = e;
        sum += e;
      }
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - mx);
        s_alpha[gi] = alpha;
        s_l[gi] = s_l[gi] * alpha + sum;
        s_m[gi] = mx;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: one thread per (head, d).
    for (int i = tid; i < gd; i += kThreads) {
      const int gi = i / d;
      const int dd = i - gi * d;
      const float* pr = s_s + gi * tile_tokens;
      float a = s_acc[i] * s_alpha[gi];
      for (int t = 0; t < tokens; ++t) a += pr[t] * to_f32(s_v[t * d + dd]);
      s_acc[i] = a;
    }
  }
  __syncthreads();

  TQ* out_bh = out + (static_cast<long long>(b) * hkv + h) * gd;
  const bool bad = *s_bad != 0;
  for (int i = tid; i < gd; i += kThreads) {
    const float val = bad ? __int_as_float(0x7fc00000) : s_acc[i] / fmaxf(s_l[i / d], 1e-37f);
    out_bh[i] = from_f32<TQ>(val);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* table, const void* lengths, void* out, int b, int hkv,
           int g, int d, int page, int n_pool, int max_pages,
           cudaStream_t stream) {
  if (b <= 0 || hkv <= 0) return 0;
  if (b > 65535 || g <= 0 || page <= 0 || max_pages <= 0 ||
      (d * static_cast<int>(sizeof(TKV))) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int tile_pages = kTileTokens / page > 1 ? kTileTokens / page : 1;
  if (tile_pages > max_pages) tile_pages = max_pages;
  while (tile_pages > 1 &&
         smem_layout<TKV>(g, d, tile_pages * page, tile_pages).total > kDefaultSmem)
    --tile_pages;
  const int smem = smem_layout<TKV>(g, d, tile_pages * page, tile_pages).total;
  auto kernel = paged_attention_kernel<TQ, TKV>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(hkv, b), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lengths), static_cast<TQ*>(out), hkv, g, d,
      page, n_pool, max_pages, tile_pages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hkv, G, D) and out in bf16 if q_bf16 else f32; k_pages, v_pages
// (P, page, Hkv, D) in bf16 if kv_bf16 else f32; page_table (B, max_pages)
// and lengths (B,) int32.  All contiguous, K/V 16-byte aligned.  The
// dtype pairs: bf16/bf16 (the model as served), f32 q over a bf16 pool (a
// float32 model: the pool is always bf16), f32/f32 (the oracle's sweep).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* table,
    const void* lengths, void* out, int b, int hkv, int g, int d, int page,
    int n_pool, int max_pages, int q_bf16, int kv_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (q_bf16 && kv_bf16)
    return launch<bf16, bf16>(q, k_pages, v_pages, table, lengths, out, b, hkv, g, d, page, n_pool, max_pages, s);
  if (q_bf16) return static_cast<int>(cudaErrorInvalidValue);
  if (kv_bf16)
    return launch<float, bf16>(q, k_pages, v_pages, table, lengths, out, b, hkv, g, d, page, n_pool, max_pages, s);
  return launch<float, float>(q, k_pages, v_pages, table, lengths, out, b, hkv, g, d, page, n_pool, max_pages, s);
}
