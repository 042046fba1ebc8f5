// Streaming exact top-k softmax memory read for Hopper (sm_90a).
//
// Replaces the TPU kernel cutie_tpu/ops/pallas_kernels.py:fused_topk_readout
// (body _read_kernel, running top-k _topk_merge). It computes the same
// function as radix_topk_readout.cu, for one batch row and one value store
// values [O, N, Cv] fp32:
//   tau[p]   = the exact k-th largest sim[p,:]           (ties all kept)
//   w[p,n]   = exp(sim[p,n]) * [sim[p,n] >= tau[p]]
//   out[o,p] = sum_n w[p,n] v[o,n,:] / sum_n w[p,n]
//   usage[n] = sum_p w[p,n] / sum_n w[p,n]
// with the similarity of read_common.cuh:similarity_run, so tau agrees bit
// for bit with radix_topk_readout.cu and with the plain version.
//
// What bounds it on this card: the similarity, 4*P*N*Ck fp32 operations
// (2.0 G at P=1620 and 4,860 valid keys, Ck=64), none of them fused into an
// FMA; this design evaluates it once. The bytes it must move (keys, the kept
// value rows, the outputs) are a few tens of MB.
//
// Design. Its distinct property, kept from the TPU kernel, is that no memory
// grows with N: the state is O(k) a query and split. Two stages:
//   A. partial_topk_kernel, grid (splits, query tiles), two blocks an SM. A
//      block takes 64 queries and one split of the keys, key tiles s, s +
//      splits, ... (tiles without a valid key lie in runs; this spreads them
//      evenly), and streams them through the similarity loop both kernels
//      share (read_common.cuh:similarity_run). After a tile is computed its
//      order keys are staged over the tile's key buffer, which frees the
//      register tile, and warp w filters those of its queries 8w..8w+7: per
//      query a threshold lo (none until the first merge) and a buffer of
//      (key, token) pairs, the query's row of the state. Keys > lo are
//      appended 32 at a time (a ballot, no atomics). A buffer past ld - 32
//      pairs is merged by its warp: the exact top_k-th largest key t by 32
//      one-bit passes over keys held in registers (the TPU kernel's
//      selection), then the keys > t and copies of t up to top_k are kept in
//      place and lo = t. At the end each (query, split) leaves at most top_k
//      pairs (key 0 pads the rest) and `drop`, the largest key it left out
//      that equalled its threshold at the time (0 if none).
//   B. merge_readout_kernel, one block a query. tau is the exact min(k, N)-th
//      largest of the splits' pairs (read_common.cuh:radix_select over them),
//      raised to NEG_INF's key if fewer are listed (tiles without a valid key
//      are skipped; their keys are NEG_INF's, below every valid similarity).
//      Why that is exact: a split's pairs are its top_k largest keys as a
//      multiset, so every key > tau is listed (a key > tau left out would
//      give its split top_k keys > tau, and tau would be larger), and tau
//      itself is listed often enough: a split that truncated copies of tau
//      lists top_k keys >= tau. Copies of tau can be missing only from a
//      split that left one out, and its `drop` then equals tau (a threshold
//      never exceeds its split's final one, nor that tau). Only for such a
//      split, and only when exp(tau) > 0 (else tokens at tau weigh 0 and are
//      not kept), the block recomputes that split's similarities and takes
//      its keys equal to tau from them.
//      The kept tokens (>= tau, w > 0) are sorted by token index, and Z and
//      the readout sum in token order with fmaf and divide by max(Z, 1e-30),
//      as radix_topk_readout.cu's select stage does: the readouts agree bit
//      for bit. usage += w/Z by atomicAdd at the kept tokens only. Past
//      kListCap kept tokens (over a thousand exact ties at tau) the same sums
//      run over N in chunks, recomputing the similarity.
// The wrapper (ops/read_kernel.py:fused_topk_readout_geometry) takes as many
// splits as one round of resident partial blocks holds.
// Padded queries (qk = 1e6, qe = 1) give sim ~ -1e14: every w underflows to
// 0 and they add nothing to the readout or to usage.

#include <cuda_runtime.h>
#include <stdint.h>

#include "read_common.cuh"

namespace {

using namespace cutie_read;

// stage A: the tile's order keys are staged over its key buffer, kStageLd
// a query; a query's buffer (in the state row) takes them kStep at a time
// and holds ld = max(top_k + kStep, kMinLd) pairs, merged past ld - kStep
constexpr int kStep = 32;
constexpr int kStageLd = kKTile + 4;  // staging rows 4 tq apart: distinct banks
constexpr int kMinLd = 176;
constexpr int kRegs = (kMinLd + 31) / 32;  // a merge holds keys in registers
                                           // up to 32 kRegs pairs
static_assert(kQTile * kStageLd <= kKTile * kLd, "staging fits the key tile");

// stage B: kept tokens a block lists in shared memory; chunk of the
// overflow path
constexpr int kListCap = 1024;
constexpr int kChunk = 1024;
constexpr int kCols = 3;  // readout columns a thread carries, as in kernel #1

// pairs a (query, split) row of the state holds
__host__ __device__ __forceinline__ int state_ld(int top_k) {
  return max(top_k + kStep, kMinLd);
}

// Stage B selects tau among the listed keys (each row's first top_k) in
// shared memory when they fit, else over the whole state rows, whose tails
// stage A then pads with key 0 too.
__device__ __forceinline__ bool listed_fit(int splits, int top_k) {
  return splits * top_k <= 2 * kListCap;
}

// ------------------------------------------------------------ stage A

// The running top-k of a query tile's queries over one split. Warp w owns
// queries 8 w .. 8 w + 7: their buffers, counts, thresholds and drops.
struct TopkEpilogue {
  static constexpr bool kStaged = true;
  uint32_t* keys;   // query q's buffer: keys at q * stride
  int* idx;         // and token indices
  size_t stride;
  int cap;          // pairs a buffer holds
  int* cnt;         // [kQTile] pairs held
  uint32_t* lo;     // [kQTile] threshold (0: none yet)
  uint32_t* drop;   // [kQTile] largest key dropped at the threshold
  int n, top_k, q_count;

  __device__ __forceinline__ void empty_tile(int) const {}

  // stage: [kQTile][kStageLd] over the tile's key buffer
  __device__ __forceinline__ void row(int q, int, const uint32_t* key,
                                      uint32_t* stage) const {
    const int tk = threadIdx.x & 15;
#pragma unroll
    for (int j = 0; j < 8; ++j) stage[q * kStageLd + tk + 16 * j] = key[j];
  }

  // The top_k-th largest key t of query q's c > top_k pairs by 32 one-bit
  // passes: keep the keys > t and copies of t up to top_k, in place; lo = t,
  // cnt = top_k. The owning warp calls it after its appends; returns t. Up
  // to 32 kRegs keys are read into registers once.
  __device__ uint32_t merge(int q, int c) const {
    const int lane = threadIdx.x & 31;
    const unsigned lt = (1u << lane) - 1u;
    uint32_t* bk = keys + q * stride;
    int* bi = idx + q * stride;
    __syncwarp();  // every lane's appends are visible
    const bool cached = c <= kRegs * 32;
    uint32_t r[kRegs];  // key 0 past c: below every key
    int ri[kRegs];
#pragma unroll
    for (int u = 0; u < kRegs; ++u) {
      const int e = lane + 32 * u;
      r[u] = cached && e < c ? bk[e] : 0u;
      ri[u] = cached && e < c ? bi[e] : 0;
    }
    auto count = [&](uint32_t x, bool above) {  // keys >= x, or > x
      unsigned m = 0;
      if (cached) {
#pragma unroll
        for (int u = 0; u < kRegs; ++u) m += (above ? r[u] > x : r[u] >= x) ? 1u : 0u;
      } else {
        for (int e = lane; e < c; e += 32) m += (above ? bk[e] > x : bk[e] >= x) ? 1u : 0u;
      }
      return (int)__reduce_add_sync(0xffffffffu, m);
    };
    uint32_t t = 0u;
    for (int bit = 31; bit >= 0; --bit)
      if (count(t | (1u << bit), false) >= top_k) t |= 1u << bit;
    const int keep_eq = top_k - count(t, true);  // copies of t kept
    int out = 0, eq_seen = 0;
    bool dropped = false;
    auto chunk = [&](int e0, uint32_t kv, int iv) {  // entries e0 .. e0 + 31
      const bool in = e0 + lane < c;
      const bool eq = in && kv == t;
      const unsigned eqb = __ballot_sync(0xffffffffu, eq);
      const bool keep = in && (kv > t || (eq && eq_seen + __popc(eqb & lt) < keep_eq));
      const unsigned kb = __ballot_sync(0xffffffffu, keep);
      dropped |= eq && !keep;
      __syncwarp();  // the chunk is read before any of it is overwritten
      if (keep) {
        bk[out + __popc(kb & lt)] = kv;
        bi[out + __popc(kb & lt)] = iv;
      }
      out += __popc(kb);
      eq_seen += __popc(eqb);
    };
    if (cached) {
#pragma unroll
      for (int u = 0; u < kRegs; ++u)
        if (32 * u < c) chunk(32 * u, r[u], ri[u]);
    } else {
      for (int e0 = 0; e0 < c; e0 += 32) {
        const bool in = e0 + lane < c;
        chunk(e0, in ? bk[e0 + lane] : 0u, in ? bi[e0 + lane] : 0);
      }
    }
    const bool any_dropped = __any_sync(0xffffffffu, dropped);
    if (lane == 0) {
      if (any_dropped) drop[q] = t;
      lo[q] = t;
      cnt[q] = out;  // == top_k
    }
    __syncwarp();
    return t;
  }

  // Each owned query appends its staged keys above its threshold, kStep at
  // a time, and is merged once it holds more than cap - kStep pairs.
  __device__ void tile_done(int k0, const uint32_t* stage) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned lt = (1u << lane) - 1u;
    for (int q = warp * 8; q < min(q_count, warp * 8 + 8); ++q) {
      uint32_t* bk = keys + q * stride;
      int* bi = idx + q * stride;
      uint32_t l = lo[q];
      int c = cnt[q];
      bool tie = false;  // a key equal to the threshold l was left out
#pragma unroll
      for (int u = 0; u < kKTile / kStep; ++u) {
        const int i = k0 + lane + kStep * u;
        const uint32_t key = stage[q * kStageLd + lane + kStep * u];
        const bool pass = i < n && key > l;
        tie |= i < n && key == l;
        const unsigned b = __ballot_sync(0xffffffffu, pass);
        if (pass) {
          bk[c + __popc(b & lt)] = key;
          bi[c + __popc(b & lt)] = i;
        }
        c += __popc(b);
        if (c > cap - kStep) {
          if (__any_sync(0xffffffffu, tie) && lane == 0) drop[q] = l;
          tie = false;
          l = merge(q, c);
          c = top_k;
        }
      }
      const bool any_tie = __any_sync(0xffffffffu, tie);
      if (lane == 0) {
        cnt[q] = c;
        if (any_tie) drop[q] = l;
      }
    }
    __syncwarp();
  }
};

// State rows: query p, split s at (p * splits + s) * ld pairs (keys and
// token indices apart), drop at p * splits + s; each row is its (query,
// split)'s buffer.
__global__ void __launch_bounds__(kThreads, 2)
partial_topk_kernel(const float* __restrict__ mk, const float* __restrict__ ms,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ qk, const float* __restrict__ qe,
                    int n, int ck, int p, int top_k, int splits, int ld,
                    uint32_t* __restrict__ st_keys, int* __restrict__ st_idx,
                    uint32_t* __restrict__ st_drop) {
  extern __shared__ __align__(16) float smem_f[];
  __shared__ TileRunShared sh;
  __shared__ int s_cnt[kQTile];
  __shared__ uint32_t s_lo[kQTile];
  __shared__ uint32_t s_drop[kQTile];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x;
  const int q_lo = blockIdx.y * kQTile;
  const int q_count = min(kQTile, p - q_lo);
  const int k_tiles = (n + kKTile - 1) / kKTile;
  if (tid < kQTile) {
    s_cnt[tid] = 0;
    s_lo[tid] = 0u;
    s_drop[tid] = 0u;
  }
  // (similarity_run's first barrier orders these before any epilogue)

  uint32_t* row_keys = st_keys + ((size_t)q_lo * splits + s) * ld;
  int* row_idx = st_idx + ((size_t)q_lo * splits + s) * ld;
  const TopkEpilogue epi{row_keys, row_idx, (size_t)splits * ld, ld,
                         s_cnt,    s_lo,    s_drop,              n,
                         top_k,    q_count};

  // split s takes key tiles s, s + splits, ...: the tiles without a valid
  // key (free ring and long-term slots, which lie in runs) spread evenly
  for (int t = s; t < k_tiles; t += splits * kMaxTilesPerRun)
    similarity_run(mk, ms, valid, qk, qe, n, ck, q_lo, q_count, t * kKTile,
                   min(kMaxTilesPerRun, (k_tiles - t + splits - 1) / splits),
                   splits, smem_f, sh, epi);

  // at most top_k pairs a query; key 0 pads the row's first top_k, or all
  // of it where stage B selects over whole rows
  const int pad_to = listed_fit(splits, top_k) ? top_k : ld;
  for (int q = warp * 8; q < min(q_count, warp * 8 + 8); ++q) {
    if (s_cnt[q] > top_k) epi.merge(q, s_cnt[q]);
    const size_t r = (size_t)q * splits * ld;
    for (int e = s_cnt[q] + lane; e < pad_to; e += 32) row_keys[r + e] = 0u;
    if (lane == 0) st_drop[(size_t)(q_lo + q) * splits + s] = s_drop[q];
  }
}

// ------------------------------------------------------------ stage B

__global__ void __launch_bounds__(kThreads)
merge_readout_kernel(const float* __restrict__ mk, const float* __restrict__ ms,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ qk, const float* __restrict__ qe,
                     const float* __restrict__ values, int n, int ck,
                     int p_total, int o_dim, int cv, int top_k, int splits,
                     int ld, const uint32_t* __restrict__ st_keys,
                     const int* __restrict__ st_idx,
                     const uint32_t* __restrict__ st_drop,
                     float* __restrict__ out, float* __restrict__ usage,
                     float* __restrict__ tau_out) {
  __shared__ __align__(16) float q_k[256];
  __shared__ __align__(16) float q_e[256];
  __shared__ uint32_t g_buf[2 * kListCap];
  uint32_t* g_key = g_buf;  // gathered kept tokens, any order
  int* g_idx = reinterpret_cast<int*>(g_buf + kListCap);
  __shared__ int list_idx[kListCap];    // the same in token order
  __shared__ float list_w[kListCap];
  __shared__ RadixShared rsh;
  __shared__ int warp_sums[kWarps];
  __shared__ int s_count, s_total;

  const int tid = threadIdx.x;
  const int p = blockIdx.x;
  const int listed = splits * top_k;  // row s's first top_k pairs
  const uint32_t* row = st_keys + (size_t)p * splits * ld;
  const int* irow = st_idx + (size_t)p * splits * ld;
  const uint32_t* drow = st_drop + (size_t)p * splits;
  const int k_tiles = (n + kKTile - 1) / kKTile;
  const float nis = neg_inv_sqrt(ck);

  // tau: the min(k, N)-th largest listed key, NEG_INF's if fewer are
  // listed; in shared memory (g_buf) where the listed keys fit there, else
  // over the whole state rows
  const bool fit = listed_fit(splits, top_k);
  for (int e = tid; fit && e < listed; e += kThreads)
    g_buf[e] = row[(size_t)(e / top_k) * ld + e % top_k];
  const uint32_t tau = max(fit ? radix_select(g_buf, listed, min(top_k, n), rsh)
                               : radix_select(row, splits * ld, min(top_k, n), rsh),
                           order_key(kNegInf));
  __syncthreads();  // g_buf is read
  if (tid == 0) {
    tau_out[p] = invert_order_key(tau);
    s_count = 0;
  }
  const bool live = expf(invert_order_key(tau)) > 0.f;
  bool refill_any = false;
  for (int s = 0; s < splits; ++s) refill_any |= live && drow[s] == tau;
  if (refill_any) load_query(qk, qe, p, ck, q_k, q_e);
  __syncthreads();

  // the kept tokens: listed ones, and in a split that dropped a copy of tau,
  // its keys equal to tau recomputed
  auto gather = [&](uint32_t key, int i) {
    const int slot = atomicAdd(&s_count, 1);
    if (slot < kListCap) {
      g_key[slot] = key;
      g_idx[slot] = i;
    }
  };
  for (int e = tid; e < listed; e += kThreads) {
    const size_t g = (size_t)(e / top_k) * ld + e % top_k;
    const uint32_t key = row[g];
    const bool refill = live && drow[e / top_k] == tau;
    if (refill ? key > tau : kept(key, tau)) gather(key, irow[g]);
  }
  if (refill_any) {
    for (int s = 0; s < splits; ++s) {
      if (drow[s] != tau) continue;
      for (int t = s; t < k_tiles; t += splits)  // split s's key tiles
        for (int i = t * kKTile + tid; i < min(n, (t + 1) * kKTile); i += kThreads) {
          const uint32_t key =
              order_key(token_similarity(mk, ms, valid, i, ck, q_k, q_e, nis));
          if (key == tau) gather(key, i);
        }
    }
  }
  __syncthreads();
  const int count = s_count;
  const int ocv = o_dim * cv;
  const size_t stride = (size_t)n * cv;  // from one object's values to the next

  if (count <= kListCap) {
    // token order: each token's rank among the distinct indices
    for (int j = tid; j < count; j += kThreads) {
      const int i = g_idx[j];
      int r = 0;
      for (int m = 0; m < count; ++m) r += g_idx[m] < i ? 1 : 0;
      list_idx[r] = i;
      list_w[r] = expf(invert_order_key(g_key[j]));
    }
    __syncthreads();
    float z = 0.f;
    for (int j = 0; j < count; ++j) z += list_w[j];
    const float zsafe = fmaxf(z, 1e-30f);
    for (int col0 = tid; col0 < ocv; col0 += kCols * kThreads) {
      int o[kCols], c[kCols];
      float acc[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int col = min(col0 + u * kThreads, ocv - 1);  // past ocv: not stored
        o[u] = col / cv;
        c[u] = col - o[u] * cv;
        acc[u] = 0.f;
      }
#pragma unroll 1
      for (int j = 0; j < count; ++j) {
        const float w = list_w[j];
        const float* r = values + (size_t)list_idx[j] * cv;
        float v[kCols];
#pragma unroll
        for (int u = 0; u < kCols; ++u) v[u] = r[o[u] * stride + c[u]];
#pragma unroll
        for (int u = 0; u < kCols; ++u) acc[u] = fmaf(w, v[u], acc[u]);
      }
#pragma unroll
      for (int u = 0; u < kCols; ++u)
        if (col0 + u * kThreads < ocv)
          out[((size_t)o[u] * p_total + p) * cv + c[u]] = acc[u] / zsafe;
    }
    for (int j = tid; j < count; j += kThreads)
      atomicAdd(&usage[list_idx[j]], list_w[j] / zsafe);
    return;
  }

  // more kept tokens than the list holds: the same sums over N in chunks of
  // kChunk tokens, the similarity recomputed, the output row carried in out
  if (!refill_any) load_query(qk, qe, p, ck, q_k, q_e);
  uint32_t* keys = g_key;
  int* list = g_idx;
  for (int col = tid; col < ocv; col += kThreads) {
    const int o = col / cv, c = col - o * cv;
    out[((size_t)o * p_total + p) * cv + c] = 0.f;
  }
  float z = 0.f;
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int len = min(n, c0 + kChunk) - c0;
    for (int i = tid; i < len; i += kThreads)
      keys[i] = order_key(token_similarity(mk, ms, valid, c0 + i, ck, q_k, q_e, nis));
    __syncthreads();
    const int kc = compact_kept(keys, len, tau, list, warp_sums, &s_total);
    for (int j = 0; j < kc; ++j) z += expf(invert_order_key(keys[list[j]]));
    for (int col = tid; col < ocv; col += kThreads) {
      const int o = col / cv, c = col - o * cv;
      float* dst = out + ((size_t)o * p_total + p) * cv + c;
      float acc = *dst;
      for (int j = 0; j < kc; ++j)
        acc = fmaf(expf(invert_order_key(keys[list[j]])),
                   values[o * stride + (size_t)(c0 + list[j]) * cv + c], acc);
      *dst = acc;
    }
    __syncthreads();  // keys and list are rewritten by the next chunk
  }
  const float zsafe = fmaxf(z, 1e-30f);
  for (int col = tid; col < ocv; col += kThreads) {
    const int o = col / cv, c = col - o * cv;
    float* dst = out + ((size_t)o * p_total + p) * cv + c;
    *dst = *dst / zsafe;
  }
  for (int i = tid; i < n; i += kThreads) {
    const uint32_t key =
        order_key(token_similarity(mk, ms, valid, i, ck, q_k, q_e, nis));
    if (kept(key, tau)) atomicAdd(&usage[i], expf(invert_order_key(key)) / zsafe);
  }
}

cudaError_t partial_attributes() {
  return cudaFuncSetAttribute(partial_topk_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kSimSmemBytes);
}

}  // namespace

extern "C" {

// Resident blocks per SM of each stage. Returns a cudaError_t.
int fused_topk_readout_occupancy(int* partial_blocks, int* merge_blocks) {
  cudaError_t err = partial_attributes();
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      partial_blocks, partial_topk_kernel, kThreads, kSimSmemBytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      merge_blocks, merge_readout_kernel, kThreads, 0);
}

// Stage A. The state: keys [p, splits, ld] uint32, token indices [p,
// splits, ld] int32, drop [p, splits] uint32, with ld = max(top_k + 32,
// 176); 1 <= splits <= the key tiles ceil(n / 128). Device
// pointers; qk and qe 16-byte aligned. Returns a cudaError_t (0 = launched).
int fused_topk_readout_partial_launch(const void* mk, const void* ms,
                                      const void* valid, const void* qk,
                                      const void* qe, int n, int ck, int p,
                                      int top_k, int splits, int ld,
                                      void* st_keys, void* st_idx,
                                      void* st_drop, void* stream) {
  const int k_tiles = (n + kKTile - 1) / kKTile;
  if (ld != state_ld(top_k) || splits < 1 || splits > k_tiles)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = partial_attributes();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(splits, (p + kQTile - 1) / kQTile);
  partial_topk_kernel<<<grid, kThreads, kSimSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mk), static_cast<const float*>(ms),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(qk),
      static_cast<const float*>(qe), n, ck, p, top_k, splits, ld,
      static_cast<uint32_t*>(st_keys), static_cast<int*>(st_idx),
      static_cast<uint32_t*>(st_drop));
  return (int)cudaGetLastError();
}

// Stage B, from the state stage A filled: values [o, n, cv] fp32, out [o, p,
// cv] fp32, usage [n] fp32 (zeroed by the caller), tau [p] fp32. Returns a
// cudaError_t (0 = launched).
int fused_topk_readout_merge_launch(const void* mk, const void* ms,
                                    const void* valid, const void* qk,
                                    const void* qe, const void* values, int n,
                                    int ck, int p, int o, int cv, int top_k,
                                    int splits, int ld, const void* st_keys,
                                    const void* st_idx, const void* st_drop,
                                    void* out, void* usage, void* tau,
                                    void* stream) {
  if (ld != state_ld(top_k) || splits < 1) return (int)cudaErrorInvalidValue;
  merge_readout_kernel<<<p, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mk), static_cast<const float*>(ms),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(qk),
      static_cast<const float*>(qe), static_cast<const float*>(values), n, ck,
      p, o, cv, top_k, splits, ld, static_cast<const uint32_t*>(st_keys),
      static_cast<const int*>(st_idx), static_cast<const uint32_t*>(st_drop),
      static_cast<float*>(out), static_cast<float*>(usage),
      static_cast<float*>(tau));
  return (int)cudaGetLastError();
}

}  // extern "C"
