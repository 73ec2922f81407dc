// ring: the fog tick's writer ring (repro_torch/core/writeback.py and
// simulator._resolve_backstop{,_keyed}), for Hopper (sm_90a).  Six entries,
// one launch a call:
//
//   ring_enqueue          FIFO push of the masked lanes; overflow drops the newest
//   ring_enqueue_keyed    keyed push: in-batch dedup, cross-tick coalescing, append
//   ring_backstop         a fog-missed read against the FIFO ring and the store
//   ring_backstop_keyed   the same against the keyed ring and the store's table
//   ring_drain            one writer tick: token bucket, backoff, retry
//   ring_drained          the (max_per_tick,) rows the last drain took
//
// Replaces no TPU kernel: the JAX package leaves the ring
// (repro/core/writeback.py, repro/core/simulator.py::_resolve_backstop) to
// XLA, which fuses each call's ops into a few loops.  PyTorch runs them one
// op at a time: 10 to 80 launches a call, 150 of a keyed tick's launches
// and 79 of a FIFO tick's.  These kernels are those calls in one launch
// each.  Contract: repro_torch/kernels/ref.py::ring_*_ref, bit for bit.
//
// What bounds it on the card: the launch.  A call works on a ring of a few
// thousand slots (8,192 in the fog cells: 96 KB for keys, timestamps and
// origins, 16 KB for a keyed ring's slot map), at most ~10,000 lanes or one
// scalar; its bytes take a few us at the card's bandwidth.
//
// Design.  The parent ring is never written (the simulator's state is a
// value): an enqueue copies the ring, and a keyed one its slot map, into its
// output, then writes the new entries there.  Both enqueues run in ONE block
// of 1,024 threads, which walks the lanes in chunks of 1,024; a block-wide
// exclusive scan (ballot, then the warps' counts) gives each appending lane
// its offset in lane order, as torch.cumsum does, so the result is
// deterministic.  The keyed enqueue first finds the last masked lane of each
// key with atomicMax on the lane index, using its output slot map as the
// (K,) table (filled with -1, read back, then overwritten by the copy), and
// keeps one bit a lane in shared memory.  The backstops and the gather are
// one thread a lane; the drain is one thread.  Arithmetic as torch does it:
// int32 sums wrap (through uint32), integer % is a floor modulo, the token
// bucket is float32 with the rate and the burst rounded to float32 by the
// caller, and out-of-range key ids are clamped for lookups and dropped for
// scatters.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;          // the enqueues: one block walks the lanes
constexpr int kWarps = kBlock / 32;
constexpr int kLaneThreads = 256;     // the backstops and the gather
constexpr int kMaxRepBytes = 48 * 1024;

__device__ __forceinline__ int32_t add_i32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t sub_i32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// torch's integer % for a positive divisor: the result lies in [0, cap).
__device__ __forceinline__ int32_t floor_mod(int32_t a, int32_t cap) {
  const int32_t r = a % cap;
  return r < 0 ? r + cap : r;
}

__device__ __forceinline__ int32_t clamp_key(int32_t kid, int ku) {
  return kid < 0 ? 0 : (kid > ku - 1 ? ku - 1 : kid);
}

// The block's copy of n words from src to dst, in 16-byte words where both
// start on a 16-byte boundary.
__device__ __forceinline__ void copy_words(int32_t* __restrict__ dst, const int32_t* __restrict__ src, int n) {
  int i = threadIdx.x;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int n4 = n / 4;
    for (; i < n4; i += kBlock) reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
    i = 4 * n4 + threadIdx.x;
  }
  for (; i < n; i += kBlock) dst[i] = src[i];
}

// Exclusive prefix count of `flag` over the block in thread order (.x) and
// the block's count (.y).  Every thread of the block calls it.
__device__ __forceinline__ int2 block_scan(bool flag, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_sums[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int v = warp_sums[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += u;
    }
    warp_sums[lane] = v;                 // inclusive, by warp
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  const int total = warp_sums[kWarps - 1];
  __syncthreads();                       // warp_sums is free for the next call
  return make_int2(before + __popc(ballot & ((1u << lane) - 1u)), total);
}

struct Rows {
  int32_t* keys;
  int32_t* data_ts;
  int32_t* origin;
};

__device__ __forceinline__ void put_row(Rows ring, int32_t slot, int32_t key, int32_t ts,
                                        int32_t origin) {
  ring.keys[slot] = key;
  ring.data_ts[slot] = ts;
  ring.origin[slot] = origin;
}

// The append that both enqueues share: a lane that asks for a slot at
// offset `off` from the tail (its rank in lane order among the lanes that
// ask) takes monotone index tail + off if that lies within the free room,
// and returns whether it did.  Overflow drops it.
__device__ __forceinline__ bool append_row(Rows ring, int cap, int32_t tail, int32_t room,
                                           int off, int32_t key, int32_t ts, int32_t origin,
                                           int32_t* index) {
  if (off >= room) return false;
  *index = add_i32(tail, off);
  put_row(ring, floor_mod(*index, cap), key, ts, origin);
  return true;
}

// The scalars an enqueue writes after its lanes: appended = min(max(room,
// 0), asked), the rest of the asking lanes dropped.
__device__ __forceinline__ int appended(int32_t room, int asked) {
  return room <= 0 ? 0 : (room < asked ? room : asked);
}

// out: keys, data_ts, origin (cap each); scalars: tail, dropped, n_accept.
__global__ void __launch_bounds__(kBlock, 1) ring_enqueue_rows(
    const int32_t* __restrict__ keys, const int32_t* __restrict__ data_ts,
    const int32_t* __restrict__ origin, const int32_t* __restrict__ head,
    const int32_t* __restrict__ tail, const int32_t* __restrict__ dropped,
    const int32_t* __restrict__ in_keys, const int32_t* __restrict__ in_ts,
    const int32_t* __restrict__ in_origin, const bool* __restrict__ mask,
    int32_t* __restrict__ out, int32_t* __restrict__ scalars, int cap, int r) {
  __shared__ int warp_sums[kWarps];
  const Rows ring{out, out + cap, out + 2 * cap};
  copy_words(ring.keys, keys, cap);
  copy_words(ring.data_ts, data_ts, cap);
  copy_words(ring.origin, origin, cap);
  const int32_t t0 = *tail;
  const int32_t room = sub_i32(cap, sub_i32(t0, *head));
  __syncthreads();                       // the copy lands before any append
  int asked = 0;
  for (int base = 0; base < r; base += kBlock) {
    const int i = base + threadIdx.x;
    const bool want = i < r && mask[i];
    const int2 scan = block_scan(want, warp_sums);
    int32_t index;
    if (want)
      append_row(ring, cap, t0, room, asked + scan.x, in_keys[i], in_ts[i], in_origin[i], &index);
    asked += scan.y;
  }
  if (threadIdx.x == 0) {
    const int n = appended(room, asked);
    scalars[0] = add_i32(t0, n);
    scalars[1] = add_i32(*dropped, asked - n);
    scalars[2] = n;
  }
}

// out: keys, data_ts, origin (cap each), slot_of_key (ku); scalars: tail,
// dropped, coalesced, n_accept.
__global__ void __launch_bounds__(kBlock, 1) ring_enqueue_keyed_rows(
    const int32_t* __restrict__ keys, const int32_t* __restrict__ data_ts,
    const int32_t* __restrict__ origin, const int32_t* __restrict__ head,
    const int32_t* __restrict__ tail, const int32_t* __restrict__ dropped,
    const int32_t* __restrict__ slot_of_key, const int32_t* __restrict__ coalesced,
    const int32_t* __restrict__ key_ids, const int32_t* __restrict__ in_ts,
    const int32_t* __restrict__ in_origin, const bool* __restrict__ mask,
    int32_t* __restrict__ out, int32_t* __restrict__ scalars, int cap, int ku, int r) {
  extern __shared__ unsigned rep_bits[];  // one bit a lane, a word a warp a chunk
  __shared__ int warp_sums[kWarps];
  const Rows ring{out, out + cap, out + 2 * cap};
  int32_t* slot_out = out + 3 * cap;

  // 1. In-batch dedup: a lane is its key's representative iff it is the
  //    LAST masked lane of the key (slot_out is the table here).
  for (int k = threadIdx.x; k < ku; k += kBlock) slot_out[k] = -1;
  __syncthreads();
  for (int i = threadIdx.x; i < r; i += kBlock) {
    const int32_t kid = key_ids[i];
    if (mask[i] && kid >= 0 && kid < ku) atomicMax(&slot_out[kid], i);
  }
  __syncthreads();
  for (int base = 0; base < r; base += kBlock) {
    const int i = base + threadIdx.x;
    const bool rep = i < r && mask[i] && slot_out[clamp_key(key_ids[i], ku)] == i;
    const unsigned word = __ballot_sync(0xffffffffu, rep);
    if ((threadIdx.x & 31) == 0) rep_bits[i >> 5] = word;
  }
  __syncthreads();

  // 2. The parent's ring and slot map into the outputs.
  copy_words(ring.keys, keys, cap);
  copy_words(ring.data_ts, data_ts, cap);
  copy_words(ring.origin, origin, cap);
  copy_words(slot_out, slot_of_key, ku);
  const int32_t h0 = *head;
  const int32_t t0 = *tail;
  const int32_t room = sub_i32(cap, sub_i32(t0, h0));
  __syncthreads();

  // 3. A representative whose key is pending is rewritten in its slot; the
  //    others append in lane order and record their index in the slot map.
  int asked = 0;
  int masked = 0;
  for (int base = 0; base < r; base += kBlock) {
    const int i = base + threadIdx.x;
    const bool live = i < r && mask[i];
    const bool rep = live && ((rep_bits[i >> 5] >> (i & 31)) & 1u);
    const int32_t kid = i < r ? key_ids[i] : 0;
    const int32_t slot = rep ? slot_of_key[kid] : 0;
    const bool pending = rep && slot >= h0 && slot < t0;
    const bool fresh = rep && !pending;
    const int2 scan = block_scan(fresh, warp_sums);
    masked += __syncthreads_count(live);
    if (pending) put_row(ring, floor_mod(slot, cap), kid, in_ts[i], in_origin[i]);
    int32_t index;
    if (fresh && append_row(ring, cap, t0, room, asked + scan.x, kid, in_ts[i], in_origin[i],
                            &index))
      slot_out[kid] = index;
    asked += scan.y;
  }
  if (threadIdx.x == 0) {
    const int n = appended(room, asked);
    scalars[0] = add_i32(t0, n);
    scalars[1] = add_i32(*dropped, asked - n);
    scalars[2] = add_i32(*coalesced, masked - asked);   // superseded in the batch + pending
    scalars[3] = n;
  }
}

// out: (5, r) bool: queue_hit, store_read, failed, found, in_store.
__global__ void __launch_bounds__(kLaneThreads) ring_backstop_lanes(
    const int32_t* __restrict__ head, const int32_t* __restrict__ tail,
    const bool* __restrict__ healthy, const int32_t* __restrict__ drained_total,
    const bool* __restrict__ need, const int32_t* __restrict__ enq_idx,
    bool* __restrict__ out, int cap, int r) {
  const int i = blockIdx.x * kLaneThreads + threadIdx.x;
  if (i >= r) return;
  const int32_t h0 = *head, t0 = *tail;
  const bool ok = *healthy;
  const int32_t e = enq_idx[i];
  const bool in_pending = e >= h0 && e < t0;
  const bool in_ring = e >= sub_i32(t0, cap) && e < t0;
  const bool n = need[i];
  const bool queue_hit = n && (in_pending || (!ok && in_ring));
  const bool store_read = n && !queue_hit && ok;
  const bool in_store = e < *drained_total;
  out[i] = queue_hit;
  out[r + i] = store_read;
  out[2 * r + i] = n && !queue_hit && !ok;
  out[3 * r + i] = store_read && in_store;
  out[4 * r + i] = in_store;
}

// flags: (4, r) bool: queue_hit, store_read, failed, found; served_ts (r,).
__global__ void __launch_bounds__(kLaneThreads) ring_backstop_keyed_lanes(
    const int32_t* __restrict__ head, const int32_t* __restrict__ tail,
    const int32_t* __restrict__ slot_of_key, const int32_t* __restrict__ ring_ts,
    const bool* __restrict__ healthy, const int32_t* __restrict__ table_ts,
    const bool* __restrict__ need, const int32_t* __restrict__ key_ids,
    bool* __restrict__ flags, int32_t* __restrict__ served_ts, int cap, int ku, int r) {
  const int i = blockIdx.x * kLaneThreads + threadIdx.x;
  if (i >= r) return;
  const int32_t h0 = *head, t0 = *tail;
  const bool ok = *healthy;
  const int32_t kid = clamp_key(key_ids[i], ku);
  const int32_t slot = slot_of_key[kid];
  const bool in_pending = slot >= h0 && slot < t0;
  const bool in_ring = slot >= 0 && slot >= sub_i32(t0, cap) && slot < t0;
  const bool n = need[i];
  const bool queue_hit = n && (in_pending || (!ok && in_ring));
  const bool store_read = n && !queue_hit && ok;
  const int32_t durable = table_ts[kid];
  const bool found = store_read && durable >= 0;
  flags[i] = queue_hit;
  flags[r + i] = store_read;
  flags[2 * r + i] = n && !queue_hit && !ok;
  flags[3 * r + i] = found;
  served_ts[i] = queue_hit ? ring_ts[floor_mod(slot < 0 ? 0 : slot, cap)] : (found ? durable : -1);
}

// out: head, backoff, next_retry, n, calls; tokens_out the bucket.
__global__ void __launch_bounds__(32) ring_drain_step(
    const int32_t* __restrict__ head, const int32_t* __restrict__ tail,
    const float* __restrict__ tokens, const int32_t* __restrict__ backoff,
    const int32_t* __restrict__ next_retry, const bool* __restrict__ store_ok,
    int32_t* __restrict__ out, float* __restrict__ tokens_out, int now, int rate_bits,
    int burst_bits, int max_per_tick, int backoff_base, int backoff_max) {
  if (threadIdx.x != 0) return;
  const float burst = __int_as_float(burst_bits);
  float tok = __fadd_rn(*tokens, __int_as_float(rate_bits));
  if (tok > burst) tok = burst;
  const int32_t h0 = *head;
  const int32_t size = sub_i32(*tail, h0);
  const bool attempt = now >= *next_retry && tok >= 1.0f && size > 0;
  const bool up = *store_ok;
  const bool ok = attempt && up;
  const bool failed = attempt && !up;
  const int32_t n = ok ? (size < max_per_tick ? size : max_per_tick) : 0;
  const int32_t b = *backoff;
  int32_t nb = b;
  if (failed) {
    nb = static_cast<int32_t>(static_cast<uint32_t>(b) * 2u);
    nb = nb < backoff_base ? backoff_base : nb;
    nb = nb > backoff_max ? backoff_max : nb;
  } else if (ok) {
    nb = 0;
  }
  out[0] = add_i32(h0, n);
  out[1] = nb;
  out[2] = failed ? add_i32(now, nb) : *next_retry;
  out[3] = n;
  out[4] = attempt ? 1 : 0;
  *tokens_out = __fsub_rn(tok, attempt ? 1.0f : 0.0f);
}

// rows: (2, m) keys, then data_ts; live (m,): the rows the last drain took.
__global__ void __launch_bounds__(kLaneThreads) ring_drained_rows(
    const int32_t* __restrict__ keys, const int32_t* __restrict__ data_ts,
    const int32_t* __restrict__ head, const int32_t* __restrict__ n_drained,
    int32_t* __restrict__ rows, bool* __restrict__ live, int cap, int m) {
  const int lane = blockIdx.x * kLaneThreads + threadIdx.x;
  if (lane >= m) return;
  const int32_t n = *n_drained;
  const int32_t idx = floor_mod(add_i32(sub_i32(*head, n), lane), cap);
  rows[lane] = keys[idx];
  rows[m + lane] = data_ts[idx];
  live[lane] = lane < n;
}

unsigned lane_blocks(int n) { return static_cast<unsigned>((n + kLaneThreads - 1) / kLaneThreads); }

int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Every pointer is to a contiguous device tensor: the ring's (cap,) int32
// arrays, its 0-d int32 (float32: tokens; bool: healthy, store_ok) scalars,
// (r,) lanes; `out` as each kernel above says, every entry written.

extern "C" int ring_enqueue_launch(const void* keys, const void* data_ts, const void* origin,
                                   const void* head, const void* tail, const void* dropped,
                                   const void* in_keys, const void* in_ts, const void* in_origin,
                                   const void* mask, void* out, void* scalars, int cap, int r,
                                   void* stream) {
  if (cap <= 0 || r < 0) return static_cast<int>(cudaErrorInvalidValue);
  ring_enqueue_rows<<<1, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(data_ts),
      static_cast<const int32_t*>(origin), static_cast<const int32_t*>(head),
      static_cast<const int32_t*>(tail), static_cast<const int32_t*>(dropped),
      static_cast<const int32_t*>(in_keys), static_cast<const int32_t*>(in_ts),
      static_cast<const int32_t*>(in_origin), static_cast<const bool*>(mask),
      static_cast<int32_t*>(out), static_cast<int32_t*>(scalars), cap, r);
  return launched();
}

extern "C" int ring_enqueue_keyed_launch(const void* keys, const void* data_ts, const void* origin,
                                         const void* head, const void* tail, const void* dropped,
                                         const void* slot_of_key, const void* coalesced,
                                         const void* key_ids, const void* in_ts,
                                         const void* in_origin, const void* mask, void* out,
                                         void* scalars, int cap, int ku, int r, void* stream) {
  const long long chunks = (static_cast<long long>(r) + kBlock - 1) / kBlock;
  const long long rep_bytes = chunks * kWarps * sizeof(unsigned);
  if (cap <= 0 || ku <= 0 || r < 0 || rep_bytes > kMaxRepBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  ring_enqueue_keyed_rows<<<1, kBlock, static_cast<size_t>(rep_bytes),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(data_ts),
      static_cast<const int32_t*>(origin), static_cast<const int32_t*>(head),
      static_cast<const int32_t*>(tail), static_cast<const int32_t*>(dropped),
      static_cast<const int32_t*>(slot_of_key), static_cast<const int32_t*>(coalesced),
      static_cast<const int32_t*>(key_ids), static_cast<const int32_t*>(in_ts),
      static_cast<const int32_t*>(in_origin), static_cast<const bool*>(mask),
      static_cast<int32_t*>(out), static_cast<int32_t*>(scalars), cap, ku, r);
  return launched();
}

extern "C" int ring_backstop_launch(const void* head, const void* tail, const void* healthy,
                                    const void* drained_total, const void* need,
                                    const void* enq_idx, void* out, int cap, int r, void* stream) {
  if (cap <= 0 || r < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (r == 0) return 0;
  ring_backstop_lanes<<<lane_blocks(r), kLaneThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(head), static_cast<const int32_t*>(tail),
      static_cast<const bool*>(healthy), static_cast<const int32_t*>(drained_total),
      static_cast<const bool*>(need), static_cast<const int32_t*>(enq_idx),
      static_cast<bool*>(out), cap, r);
  return launched();
}

extern "C" int ring_backstop_keyed_launch(const void* head, const void* tail,
                                          const void* slot_of_key, const void* ring_ts,
                                          const void* healthy, const void* table_ts,
                                          const void* need, const void* key_ids, void* flags,
                                          void* served_ts, int cap, int ku, int r, void* stream) {
  if (cap <= 0 || ku <= 0 || r < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (r == 0) return 0;
  ring_backstop_keyed_lanes<<<lane_blocks(r), kLaneThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(head), static_cast<const int32_t*>(tail),
      static_cast<const int32_t*>(slot_of_key), static_cast<const int32_t*>(ring_ts),
      static_cast<const bool*>(healthy), static_cast<const int32_t*>(table_ts),
      static_cast<const bool*>(need), static_cast<const int32_t*>(key_ids),
      static_cast<bool*>(flags), static_cast<int32_t*>(served_ts), cap, ku, r);
  return launched();
}

extern "C" int ring_drain_launch(const void* head, const void* tail, const void* tokens,
                                 const void* backoff, const void* next_retry,
                                 const void* store_ok, void* out, void* tokens_out, int now,
                                 int rate_bits, int burst_bits, int max_per_tick,
                                 int backoff_base, int backoff_max, void* stream) {
  ring_drain_step<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(head), static_cast<const int32_t*>(tail),
      static_cast<const float*>(tokens), static_cast<const int32_t*>(backoff),
      static_cast<const int32_t*>(next_retry), static_cast<const bool*>(store_ok),
      static_cast<int32_t*>(out), static_cast<float*>(tokens_out), now, rate_bits, burst_bits,
      max_per_tick, backoff_base, backoff_max);
  return launched();
}

extern "C" int ring_drained_launch(const void* keys, const void* data_ts, const void* head,
                                   const void* n_drained, void* rows, void* live, int cap, int m,
                                   void* stream) {
  if (cap <= 0 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  ring_drained_rows<<<lane_blocks(m), kLaneThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(data_ts),
      static_cast<const int32_t*>(head), static_cast<const int32_t*>(n_drained),
      static_cast<int32_t*>(rows), static_cast<bool*>(live), cap, m);
  return launched();
}
