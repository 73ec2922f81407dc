// paged_attention: one-token decode attention through a FLIC page table,
// for Hopper (sm_90a): flash decoding over the KV length.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_attention_pallas, whose grid walks (sequence, KV head, page) in
// order and DMAs every page slot from page 0, masking the ones past the
// sequence's length.  Contract: repro_torch/kernels/ref.py::
// paged_attention_ref.  For each sequence b and KV head h, the G query heads
// q[b, h] attend over the first lengths[b] positions of the pages that
// page_table[b] names: scores in f32 scaled by 1/sqrt(D), positions at or
// past the length masked with -1e30, a softmax in f32, output acc / max(l,
// 1e-37) in q's dtype.  A length <= 0 walks every page slot, where all
// scores are -1e30 and the softmax is uniform, as in the plain version; a
// page id outside the pool, in any live slot, makes that (sequence, head)
// output NaN instead of reading outside the pool.
//
// What bounds it on the card: bytes.  At decode each (sequence, KV head)
// reads its K and V rows of the live pages once and does 4*G*D flops per
// position, about G/2 flops per byte of bf16 K/V, far below the ~295 the
// card needs to be bound by operations.
//
// Design, and how it answers the limits of the first design (one block per
// (sequence, KV head) walking all its pages with synchronous loads):
// * Too few blocks -> split over the KV length.  The grid is (Hkv x head
//   groups of 4, B, splits); split s takes page slots [s*pps, (s+1)*pps).
//   The host picks splits and pps from the shapes alone (ops.py
//   paged_split_plan), never from lengths.  A block whose slots lie past its
//   sequence's live pages exits at once.  Each block writes a partial
//   (acc[G, D], m, l) in f32 to scratch and counts itself in on an arrival
//   counter of its (sequence, KV head); the last live split to arrive
//   resets the counter and merges the live splits' partials in split
//   order, so the result is the same from run to run (no float atomics) and
//   a call is one launch.  With one split the block writes the output
//   itself.
// * Synchronous loads -> cp.async.  Each of the 4 warps takes sub-tiles of
//   16 positions (w, w+4, ...) of its block's range and keeps up to 3 of
//   them in flight in its own ring in shared memory (16-byte cp.async.cg,
//   commit/wait groups): the next sub-tiles' rows are being copied while the
//   current one is computed.  Warps synchronise only within themselves until
//   the end, where the block merges the 4 warps' softmax states.
// * Two shared loads per multiply-add -> bf16 q over bf16 K: the (16
//   positions x 8 heads) scores of a sub-tile are one mma.sync m16n8k16 per
//   16 of D on the tensor cores, K read from shared memory by ldmatrix
//   (rows XOR-swizzled in 16-byte chunks, so the 8 rows of a matrix hit 8
//   bank groups), q held in registers as the B fragments; products of bf16
//   values are exact in f32 and the sums are f32.  Each K element is read
//   once for all G heads.  float32 q (a float32 model) keeps float32
//   multiply-adds: each lane owns one 16-byte chunk of a row and q's values
//   for it in registers, and the row's lanes sum their parts by shuffles.
// * The PV product -> the softmax runs in f32 on the scores in shared
//   memory (16 x 4 per warp).  With bf16 V, out^T[d][head] += V^T P^T on
//   the tensor cores: V^T from the V tile by ldmatrix.trans, P split into
//   bf16 hi = rn(p) and lo = rn(p - hi), two mma per 16 of D, so P keeps
//   ~16 significant bits (relative error below 2^-16) where one bf16 would
//   keep 8; each V element is read once for all heads.  With f32 V, P stays
//   f32: each lane owns one 16-byte chunk of D and keeps acc for all 4 heads
//   in registers, reading each V element once, as one 16-byte vector.
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;            // positions of a sub-tile: the mma's M
constexpr int kHeads = 4;            // query heads of a block (a head group)
constexpr int kMaxStages = 2;        // sub-tiles a warp keeps in its ring
constexpr int kMaxRowBytes = 512;    // D * bytes of a K/V value
constexpr int kMaxSplitPages = 512;  // ops.py SPLIT_MAX_PAGES
constexpr int kDefaultSmem = 48 * 1024;
constexpr float kMasked = -1e30f;

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

// The 16 bytes of a chunk as f32 values: 8 bf16 or 4 f32.
__device__ __forceinline__ void unpack(const uint4& u, float* v, __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float* v, float) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most n (0 or 1: kMaxStages - 1) of this thread's groups
// are pending.
static_assert(kMaxStages == 2, "cp_async_wait covers rings of 1 and 2 stages");
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* a, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* a, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16_pair(const __nv_bfloat16* p) {
  const uint32_t lo = __bfloat16_as_ushort(p[0]);
  const uint32_t hi = __bfloat16_as_ushort(p[1]);
  return lo | (hi << 16);
}

// Two f32 values as bf16 pairs hi and lo with x ~= hi + lo (16 significant
// bits of x kept; hi rounds x, lo rounds x - hi, which is exact in f32).
__device__ __forceinline__ void bf16_split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  const __nv_bfloat16 l0 = __float2bfloat16(x0 - __bfloat162float(h0));
  const __nv_bfloat16 l1 = __float2bfloat16(x1 - __bfloat162float(h1));
  hi = static_cast<uint32_t>(__bfloat16_as_ushort(h0)) |
       (static_cast<uint32_t>(__bfloat16_as_ushort(h1)) << 16);
  lo = static_cast<uint32_t>(__bfloat16_as_ushort(l0)) |
       (static_cast<uint32_t>(__bfloat16_as_ushort(l1)) << 16);
}

__device__ __forceinline__ int n_live_pages(int len, int page, int max_pages) {
  const int n = len > 0 ? (len + page - 1) / page : max_pages;
  return n < max_pages ? n : max_pages;
}

// Shared-memory layout (bytes) of the split kernel.
struct Layout {
  int ring, pg, sp, alpha, ml, total;
};

__host__ __device__ inline Layout smem_layout(int row_bytes, int stages, int pps) {
  Layout o;
  o.ring = 0;                                                  // [warp][stage][K|V][row][chunk]
  o.pg = o.ring + kWarps * stages * 2 * kRows * row_bytes;     // page ids of the split
  o.sp = o.pg + ((pps * 4 + 15) / 16) * 16;                    // [warp][row][head] scores, then P
  o.alpha = o.sp + kWarps * kRows * kHeads * 4;                // [warp][head]
  o.ml = o.alpha + kWarps * kHeads * 4;                        // [m|l][warp][head]
  o.total = o.ml + 2 * kWarps * kHeads * 4;
  return o;
}

// The end of a split's block when the plan has several: after its partial
// is written, the block counts itself in on its (sequence, KV head, head
// group)'s arrival counter; the last of the live splits to arrive resets the
// counter to 0 for the next call and merges the live splits' partials, warp
// w head w, each output element summed in split order (so the result is the
// same from run to run), or writes NaN where any split saw a bad page id.
template <typename TQ>
__device__ __forceinline__ void combine_if_last(
    const float* part, int* arrivals, TQ* out, int& s_last, long long pair, int g,
    int g0, int gb, int d, int n_pages, int pps, int splits) {
  static_assert(kWarps == kHeads, "a warp merges one head");
  const int live = (n_pages + pps - 1) / pps;
  __syncthreads();   // the block's partial is written; thread 0's fences cover it
  if (threadIdx.x == 0) {
    int* counter = arrivals + static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
    __threadfence();
    s_last = atomicAdd(counter, 1) == live - 1;
    if (s_last) {
      *counter = 0;
      __threadfence();   // the other splits' partials are visible to this block
    }
  }
  __syncthreads();
  if (!s_last) return;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= gb) return;
  const long long step = static_cast<long long>(g) * (d + 2);   // between splits
  const float* rows = part + (pair * splits * g + g0 + warp) * (d + 2);
  float mx = -INFINITY;
  int bad = 0;
  for (int s = lane; s < live; s += 32) {
    const float m = __ldcg(rows + s * step + d);
    bad |= m != m;
    mx = fmaxf(mx, m);
  }
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    bad |= __shfl_xor_sync(0xffffffffu, bad, off);
  }
  constexpr int kPerLane = kMaxRowBytes / 2 / 32;   // values of D a lane merges
  float a[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) a[k] = 0.0f;
  float l = 0.0f;
#pragma unroll 4
  for (int s = 0; s < live; ++s) {
    const float* r = rows + s * step;
    const float w = expf(__ldcg(r + d) - mx);
    l += w * __ldcg(r + d + 1);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k)
      if (lane + 32 * k < d) a[k] += w * __ldcg(r + lane + 32 * k);
  }
  TQ* o = out + (pair * g + g0 + warp) * d;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k)
    if (lane + 32 * k < d)
      o[lane + 32 * k] =
          from_f32<TQ>(bad ? __int_as_float(0x7fc00000) : __fdividef(a[k], fmaxf(l, 1e-37f)));
}

// grid (Hkv * head groups, B, splits), kThreads threads; scale = 1/sqrt(D),
// rounded on the host (a division here would be a call, and spill).
// kSteps > 0: bf16 q over bf16 K/V with D % 16 == 0 and D <= 16 * kSteps,
// scores and PV on the tensor cores; kSteps == 0: f32 multiply-adds on the
// CUDA cores.
template <typename TQ, typename TKV, int kSteps>
__global__ void __launch_bounds__(kThreads, 3) paged_attention_split(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const int32_t* __restrict__ table,
    const int32_t* __restrict__ lengths, TQ* __restrict__ out,
    float* __restrict__ part, int* __restrict__ arrivals, float scale, int hkv, int g,
    int d, int page, int n_pool, int max_pages, int pps, int splits, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  constexpr bool kMma = kSteps > 0;
  constexpr int vec = 16 / static_cast<int>(sizeof(TKV));   // values in a 16-byte chunk
  const int row_bytes = d * static_cast<int>(sizeof(TKV));
  const int cpr = row_bytes / 16;                           // chunks in a row, <= 32
  const int rpp = min(32 / cpr, kRows);                     // rows a warp covers at once
  const int swz = min(cpr & -cpr, 8) - 1;                   // chunk swizzle mask
  const Layout lay = smem_layout(row_bytes, stages, pps);
  int* s_pg = reinterpret_cast<int*>(smem + lay.pg);

  const int n_hg = (g + kHeads - 1) / kHeads;
  const int h = blockIdx.x / n_hg;
  const int g0 = (blockIdx.x - h * n_hg) * kHeads;
  const int gb = min(kHeads, g - g0);
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long pair = static_cast<long long>(b) * hkv + h;
  const int slot0 = split * pps;
  // This lane's chunk and row group in a sub-tile (lanes past rpp * cpr idle).
  const int c = lane % cpr;
  const int rg = lane / cpr;
  const TQ* q_bh = q + (pair * g + g0) * d;

  // Loads that need no length first, so their latencies overlap: the
  // length, this split's page ids, and q (the mma's B fragments, head
  // lane / 4, or the f32 values of this lane's chunk for each head).
  const int len = lengths[b];
  const int avail = min(pps, max_pages - slot0);
  const int32_t* table_b = table + static_cast<long long>(b) * max_pages + slot0;
  for (int i = tid; i < avail; i += kThreads) s_pg[i] = table_b[i];
  uint32_t qf[kMma ? kSteps : 1][2];
  float qv[kMma ? 1 : kHeads][kMma ? 1 : vec];
  if constexpr (kMma) {
    const int n = lane >> 2;
    const int kk = (lane & 3) * 2;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      qf[ks][0] = qf[ks][1] = 0u;
      if (n < gb && ks * 16 < d) {
        const TQ* qr = q_bh + n * d + ks * 16 + kk;
        qf[ks][0] = bf16_pair(reinterpret_cast<const __nv_bfloat16*>(qr));
        qf[ks][1] = bf16_pair(reinterpret_cast<const __nv_bfloat16*>(qr + 8));
      }
    }
  } else {
#pragma unroll
    for (int gi = 0; gi < kHeads; ++gi)
#pragma unroll
      for (int e = 0; e < vec; ++e)
        qv[gi][e] = (gi < gb && rg < rpp) ? to_f32(q_bh[gi * d + c * vec + e]) : 0.0f;
  }

  const int n_pages = n_live_pages(len, page, max_pages);
  if (slot0 >= n_pages) return;  // past the live pages: no partial
  const int np = min(pps, n_pages - slot0);
  int bad = 0;
  for (int i = tid; i < np; i += kThreads) bad |= s_pg[i] < 0 || s_pg[i] >= n_pool;
  if (__syncthreads_or(bad)) {  // uniform: NaN for this (sequence, head)
    const float nan = __int_as_float(0x7fc00000);
    if (splits == 1) {
      for (int i = tid; i < gb * d; i += kThreads)
        out[(pair * g + g0) * d + i] = from_f32<TQ>(nan);
      return;
    }
    if (tid < gb) {
      float* row = part + ((pair * splits + split) * g + g0 + tid) * (d + 2);
      row[d] = nan;
      row[d + 1] = nan;
    }
    combine_if_last(part, arrivals, out, s_last, pair, g, g0, gb, d, n_pages, pps, splits);
    return;
  }

  const int n_pos = np * page;                       // positions of this split
  const long long pos_base = static_cast<long long>(slot0) * page;
  const int n_sub = (n_pos + kRows - 1) / kRows;
  const int my_n = n_sub > warp ? (n_sub - warp + kWarps - 1) / kWarps : 0;
  const long long row_stride = static_cast<long long>(hkv) * d;   // between positions
  const long long head_off = static_cast<long long>(h) * d + c * vec;
  const int tile_bytes = kRows * row_bytes;
  unsigned char* ring = smem + lay.ring + warp * stages * 2 * tile_bytes;
  float* sp = reinterpret_cast<float*>(smem + lay.sp) + warp * kRows * kHeads;
  float* s_alpha = reinterpret_cast<float*>(smem + lay.alpha) + warp * kHeads;

  // This warp's i-th sub-tile into stage i % stages: lane (rg, c) copies
  // chunk c of rows rg, rg + rpp, ...; rows past the split are zeros.
  auto issue = [&](int i) {
    unsigned char* dk = ring + (i % stages) * 2 * tile_bytes;
    unsigned char* dv = dk + tile_bytes;
    if (rg >= rpp) return;
    int p = (warp + i * kWarps) * kRows + rg;
    int slot = p / page;
    int off = p - slot * page;
    for (int t = rg; t < kRows; t += rpp) {
      const int at = (t * cpr + (c ^ (t & swz))) * 16;
      if (p < n_pos) {
        const long long src =
            (static_cast<long long>(s_pg[slot]) * page + off) * row_stride + head_off;
        cp_async16(dk + at, k_pages + src, 16);
        cp_async16(dv + at, v_pages + src, 16);
      } else {
        cp_async16(dk + at, k_pages, 0);
        cp_async16(dv + at, v_pages, 0);
      }
      p += rpp;
      off += rpp;
      while (off >= page) {
        off -= page;
        ++slot;
      }
    }
  };

  // The running softmax state: lane (head sg, rows sr and sr + 8 of each
  // sub-tile) keeps head sg's m and l.  acc: with the mma, the C fragments
  // of out^T[d][head] (d = 16 mt + lane / 4 (+ 8), heads 2 (lane % 4) (+ 1));
  // without, acc[head][e] for this lane's chunk.
  const int sg = lane >> 3;
  const int sr = lane & 7;
  float m_run = -INFINITY, l_run = 0.0f;
  float acc_t[kMma ? kSteps : 1][4];
  float acc[kMma ? 1 : kHeads][kMma ? 1 : vec];
#pragma unroll
  for (int mt = 0; mt < (kMma ? kSteps : 1); ++mt)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc_t[mt][k] = 0.0f;
#pragma unroll
  for (int gi = 0; gi < (kMma ? 1 : kHeads); ++gi)
#pragma unroll
    for (int e = 0; e < (kMma ? 1 : vec); ++e) acc[gi][e] = 0.0f;

  for (int i = 0; i < stages - 1; ++i) {
    if (i < my_n) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < my_n; ++i) {
    if (i + stages - 1 < my_n) issue(i + stages - 1);
    cp_async_commit();
    cp_async_wait(stages - 1);
    __syncwarp();
    const unsigned char* sk = ring + (i % stages) * 2 * tile_bytes;
    const unsigned char* sv = sk + tile_bytes;

    // Scores of the 16 positions x 4 heads into sp[row][head].
    if constexpr (kMma) {
      float cf[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const int row = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        if (ks * 16 < d) {
          const int ch = 2 * ks + (lane >> 4);
          uint32_t a[4];
          ldmatrix_x4(a, sk + (row * cpr + (ch ^ (row & swz))) * 16);
          mma_bf16(cf, a, qf[ks][0], qf[ks][1]);
        }
      }
      const int t = lane >> 2;
      const int gc = (lane & 3) * 2;
      if (gc < kHeads) {
        sp[t * kHeads + gc] = cf[0];
        sp[t * kHeads + gc + 1] = cf[1];
        sp[(t + 8) * kHeads + gc] = cf[2];
        sp[(t + 8) * kHeads + gc + 1] = cf[3];
      }
    } else {
      for (int t0 = 0; t0 < kRows; t0 += rpp) {
        const int t = t0 + rg;
        const bool mine = rg < rpp && t < kRows;
        float partial[kHeads] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (mine) {
          float kv[vec];
          unpack(*reinterpret_cast<const uint4*>(sk + (t * cpr + (c ^ (t & swz))) * 16), kv, TKV());
#pragma unroll
          for (int gi = 0; gi < kHeads; ++gi)
#pragma unroll
            for (int e = 0; e < vec; ++e) partial[gi] += qv[gi][e] * kv[e];
        }
        // sum over the row's cpr lanes into its chunk-0 lane
        for (int off = 1; off < cpr; off <<= 1) {
#pragma unroll
          for (int gi = 0; gi < kHeads; ++gi) {
            const float o = __shfl_down_sync(0xffffffffu, partial[gi], off);
            if (c + off < cpr) partial[gi] += o;
          }
        }
        if (mine && c == 0) {
#pragma unroll
          for (int gi = 0; gi < kHeads; ++gi) sp[t * kHeads + gi] = partial[gi];
        }
      }
    }
    __syncwarp();

    // Online softmax: lane (head sg, rows sr and sr + 8); 8 lanes a head.
    {
      const int rel = (warp + i * kWarps) * kRows + sr;
      float s[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int p = rel + 8 * k;
        const float x = sp[(sr + 8 * k) * kHeads + sg] * scale;
        s[k] = p >= n_pos ? -INFINITY : (pos_base + p < len ? x : kMasked);
      }
      float mx = fmaxf(s[0], s[1]);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run, mx);
      const float p0 = expf(s[0] - m_new);
      const float p1 = expf(s[1] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_run - m_new);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      sp[sr * kHeads + sg] = p0;
      sp[(sr + 8) * kHeads + sg] = p1;
      if (sr == 0) s_alpha[sg] = alpha;
    }
    __syncwarp();

    // acc = acc * alpha + P V.
    if constexpr (kMma) {
      // out^T[d][head] += V^T[d][t] P^T[t][head]: A from V by ldmatrix.trans,
      // B from P split into bf16 hi + lo (two mma per tile of 16 of D).
      const int gc = (lane & 3) * 2;
      const float a0 = gc < kHeads ? s_alpha[gc] : 0.0f;
      const float a1 = gc < kHeads ? s_alpha[gc + 1] : 0.0f;
      const int n = lane >> 2;   // the head of the B fragment
      const int tk = (lane & 3) * 2;
      const float pn0 = n < kHeads ? sp[tk * kHeads + n] : 0.0f;
      const float pn1 = n < kHeads ? sp[(tk + 1) * kHeads + n] : 0.0f;
      const float pn8 = n < kHeads ? sp[(tk + 8) * kHeads + n] : 0.0f;
      const float pn9 = n < kHeads ? sp[(tk + 9) * kHeads + n] : 0.0f;
      uint32_t b0h, b0l, b1h, b1l;
      bf16_split(pn0, pn1, b0h, b0l);
      bf16_split(pn8, pn9, b1h, b1l);
      const int vrow = (lane & 7) + ((lane >> 4) & 1) * 8;
#pragma unroll
      for (int mt = 0; mt < kSteps; ++mt) {
        if (mt * 16 < d) {
          acc_t[mt][0] *= a0;
          acc_t[mt][1] *= a1;
          acc_t[mt][2] *= a0;
          acc_t[mt][3] *= a1;
          const int ch = 2 * mt + ((lane >> 3) & 1);
          uint32_t a[4];
          ldmatrix_x4_trans(a, sv + (vrow * cpr + (ch ^ (vrow & swz))) * 16);
          mma_bf16(acc_t[mt], a, b0h, b1h);
          mma_bf16(acc_t[mt], a, b0l, b1l);
        }
      }
    } else {
      float al[kHeads];
#pragma unroll
      for (int gi = 0; gi < kHeads; ++gi) al[gi] = s_alpha[gi];
#pragma unroll
      for (int gi = 0; gi < kHeads; ++gi)
#pragma unroll
        for (int e = 0; e < vec; ++e) acc[gi][e] *= al[gi];
      if (rg < rpp) {
        for (int t = rg; t < kRows; t += rpp) {
          const float4 pr = *reinterpret_cast<const float4*>(sp + t * kHeads);
          float vv[vec];
          unpack(*reinterpret_cast<const uint4*>(sv + (t * cpr + (c ^ (t & swz))) * 16), vv, TKV());
          const float pw[kHeads] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
          for (int gi = 0; gi < kHeads; ++gi)
#pragma unroll
            for (int e = 0; e < vec; ++e) acc[gi][e] += pw[gi] * vv[e];
        }
      }
    }
    __syncwarp();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  if constexpr (!kMma) {
    // Sum the row groups' acc into lanes 0..cpr-1, in row-group order.
    for (int r = 1; r < rpp; ++r) {
#pragma unroll
      for (int gi = 0; gi < kHeads; ++gi)
#pragma unroll
        for (int e = 0; e < vec; ++e) {
          const float o = __shfl_sync(0xffffffffu, acc[gi][e], lane + r * cpr);
          if (rg == 0) acc[gi][e] += o;
        }
    }
  }

  // Merge the 4 warps' states in warp order; the ring is free now.
  float* s_m = reinterpret_cast<float*>(smem + lay.ml);
  float* s_l = s_m + kWarps * kHeads;
  if (sr == 0) {
    s_m[warp * kHeads + sg] = m_run;
    s_l[warp * kHeads + sg] = l_run;
  }
  __syncthreads();
  auto weight = [&](int gi) {   // this warp's weight for head gi
    float mx = s_m[gi];
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * kHeads + gi]);
    const float mw = s_m[warp * kHeads + gi];
    return mw == -INFINITY ? 0.0f : expf(mw - mx);
  };
  float* s_acc = reinterpret_cast<float*>(smem + lay.ring);   // [warp][head][d]
  if constexpr (kMma) {
    const int gc = (lane & 3) * 2;
    if (gc < kHeads) {
      const float f0 = weight(gc), f1 = weight(gc + 1);
      float* dst = s_acc + (warp * kHeads + gc) * d + (lane >> 2);
#pragma unroll
      for (int mt = 0; mt < kSteps; ++mt) {
        if (mt * 16 < d) {
          dst[16 * mt] = acc_t[mt][0] * f0;
          dst[d + 16 * mt] = acc_t[mt][1] * f1;
          dst[16 * mt + 8] = acc_t[mt][2] * f0;
          dst[d + 16 * mt + 8] = acc_t[mt][3] * f1;
        }
      }
    }
  } else if (rg == 0) {
#pragma unroll
    for (int gi = 0; gi < kHeads; ++gi) {
      const float f = weight(gi);
#pragma unroll
      for (int e = 0; e < vec; ++e) s_acc[(warp * kHeads + gi) * d + c * vec + e] = acc[gi][e] * f;
    }
  }
  __syncthreads();
  for (int i = tid; i < gb * d; i += kThreads) {
    const int gi = i / d;
    const int dd = i - gi * d;
    float mx = s_m[gi];
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * kHeads + gi]);
    float a = 0.0f, l = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float mw = s_m[w * kHeads + gi];
      if (mw == -INFINITY) continue;   // a warp with no sub-tile
      l += s_l[w * kHeads + gi] * expf(mw - mx);
      a += s_acc[(w * kHeads + gi) * d + dd];
    }
    if (splits == 1) {
      out[(pair * g + g0) * d + i] = from_f32<TQ>(__fdividef(a, fmaxf(l, 1e-37f)));
    } else {
      float* row = part + ((pair * splits + split) * g + g0 + gi) * (d + 2);
      row[dd] = a;
      if (dd == 0) {
        row[d] = mx;
        row[d + 1] = l;
      }
    }
  }
  if (splits > 1)
    combine_if_last(part, arrivals, out, s_last, pair, g, g0, gb, d, n_pages, pps, splits);
}

template <typename TQ, typename TKV, int kSteps>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* table, const void* lengths, void* out, void* part,
           void* arrivals, int b, int hkv, int g, int d, int page, int n_pool,
           int max_pages, int splits, int pps, cudaStream_t stream) {
  const int row_bytes = d * static_cast<int>(sizeof(TKV));
  const int n_hg = (g + kHeads - 1) / kHeads;
  if (b > 65535 || g <= 0 || d <= 0 || page <= 0 || max_pages <= 0 ||
      row_bytes % 16 != 0 || row_bytes > kMaxRowBytes || splits <= 0 || splits > 65535 ||
      pps <= 0 || pps > kMaxSplitPages || static_cast<long long>(splits) * pps < max_pages ||
      static_cast<long long>(splits - 1) * pps >= max_pages ||
      (splits > 1 && (part == nullptr || arrivals == nullptr)) ||
      static_cast<long long>(hkv) * n_hg > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  // ring depth: the most sub-tiles a warp takes, at most kMaxStages
  const int subs = ((pps * page + kRows - 1) / kRows + kWarps - 1) / kWarps;
  const int stages = subs < kMaxStages ? subs : kMaxStages;
  const int smem = smem_layout(row_bytes, stages, pps).total;
  auto kernel = paged_attention_split<TQ, TKV, kSteps>;
  if (smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(hkv * n_hg, b, splits), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(lengths), static_cast<TQ*>(out),
      static_cast<float*>(part), static_cast<int*>(arrivals),
      1.0f / std::sqrt(static_cast<float>(d)), hkv, g, d, page, n_pool, max_pages, pps, splits,
      stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Hkv, G, D) and out in bf16 if q_bf16 else f32; k_pages, v_pages
// (P, page, Hkv, D) in bf16 if kv_bf16 else f32; page_table (B, max_pages)
// and lengths (B,) int32.  All contiguous, K/V 16-byte aligned, D * (bytes
// of a K/V value) a multiple of 16 and at most 512.  The dtype pairs:
// bf16/bf16 (the model as served), f32 q over a bf16 pool (a float32 model:
// the pool is always bf16), f32/f32 (the oracle's sweep).  Split plan:
// `splits` ranges of `pps` page slots (at most 512) that cover max_pages,
// none empty.  With splits > 1: `part` f32 scratch of B*Hkv*splits*G*(D+2)
// values, and `arrivals` B*Hkv*ceil(G/4) int32 counters that are 0 before
// the call and are 0 again after it (calls sharing them must not overlap);
// with one split both may be null.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* table,
    const void* lengths, void* out, void* part, void* arrivals, int b, int hkv,
    int g, int d, int page, int n_pool, int max_pages, int splits, int pps,
    int q_bf16, int kv_bf16, void* stream) {
  if (b <= 0 || hkv <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
#define PAGED_ARGS q, k_pages, v_pages, table, lengths, out, part, arrivals, b, hkv, g, d, \
                   page, n_pool, max_pages, splits, pps, s
  if (q_bf16 && kv_bf16) {
    if (d % 16 == 0) {
      return d <= 128 ? launch<bf16, bf16, 8>(PAGED_ARGS) : launch<bf16, bf16, 16>(PAGED_ARGS);
    }
    return launch<bf16, bf16, 0>(PAGED_ARGS);
  }
  if (q_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return kv_bf16 ? launch<float, bf16, 0>(PAGED_ARGS) : launch<float, float, 0>(PAGED_ARGS);
#undef PAGED_ARGS
}
