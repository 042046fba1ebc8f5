// Device code shared by the port's two memory-read kernels
// (radix_topk_readout.cu and fused_topk_readout.cu).
//
// Both kernels compute the same function, so both evaluate the similarity by
// the same fp32 operations in the same order as the plain version
// (ops/memory.py:get_similarity) and select on the same order keys: their
// thresholds agree with each other and with the plain version bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cutie_read {

constexpr int kThreads = 256;  // one block; radix_select needs 256 bins
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

// fp32 -> key whose unsigned order is the float order (no NaNs here)
__device__ __forceinline__ uint32_t order_key(float x) {
  uint32_t b = __float_as_uint(x);
  return (b >> 31) == 0 ? (b | 0x80000000u) : ~b;
}

__device__ __forceinline__ float invert_order_key(uint32_t k) {
  uint32_t b = (k >> 31) == 1 ? (k ^ 0x80000000u) : ~k;
  return __uint_as_float(b);
}

// one channel of the direct-form similarity: s + (qe * (m - q)) * (m - q),
// each operation rounded on its own
__device__ __forceinline__ float sim_term(float s, float m, float q, float e) {
  const float d = __fsub_rn(m, q);
  return __fadd_rn(s, __fmul_rn(__fmul_rn(e, d), d));
}

// the plain version multiplies by the fp64 value -1/sqrt(Ck) rounded to fp32
__device__ __forceinline__ float neg_inv_sqrt(int ck) {
  return (float)(-1.0 / sqrt((double)ck));
}

// Copy query p's key and selection (ck <= 256, a multiple of 4) into
// 16-byte aligned shared memory. Ends with a barrier.
__device__ __forceinline__ void load_query(const float* __restrict__ qk,
                                           const float* __restrict__ qe,
                                           int p, int ck, float* q_k,
                                           float* q_e) {
  for (int c = threadIdx.x; c < ck; c += kThreads) {
    q_k[c] = qk[(size_t)p * ck + c];
    q_e[c] = qe[(size_t)p * ck + c];
  }
  __syncthreads();
}

// sim[p, i] = -sum_c qe (mk - qk)^2 * ms[i] / sqrt(Ck), NEG_INF if invalid
__device__ __forceinline__ float token_similarity(
    const float* __restrict__ mk, const float* __restrict__ ms,
    const uint8_t* __restrict__ valid, int i, int ck, const float* q_k,
    const float* q_e, float neg_inv_sqrt_ck) {
  if (!valid[i]) return kNegInf;
  const float4* row = reinterpret_cast<const float4*>(mk + (size_t)i * ck);
  const float4* qk4 = reinterpret_cast<const float4*>(q_k);
  const float4* qe4 = reinterpret_cast<const float4*>(q_e);
  float s = 0.f;
  for (int c4 = 0; c4 < ck / 4; ++c4) {
    const float4 m = __ldg(row + c4), q = qk4[c4], e = qe4[c4];
    s = sim_term(s, m.x, q.x, e.x);
    s = sim_term(s, m.y, q.y, e.y);
    s = sim_term(s, m.z, q.z, e.z);
    s = sim_term(s, m.w, q.w, e.w);
  }
  return __fmul_rn(__fmul_rn(s, ms[i]), neg_inv_sqrt_ck);
}

// A token is kept by the read when its similarity is at least the query's
// threshold and its weight exp(sim) does not underflow.
__device__ __forceinline__ bool kept(uint32_t key, uint32_t tau_key) {
  return key >= tau_key && expf(invert_order_key(key)) > 0.f;
}

// Exclusive scan of one int per thread over the block; returns the
// exclusive prefix and writes the block total to *total.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
    int si = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, si, off);
      if (lane >= off) si += y;
    }
    if (lane < kWarps) warp_sums[lane] = si - s;  // exclusive warp offsets
    if (lane == kWarps - 1) *total = si;
  }
  __syncthreads();
  int res = warp_sums[warp] + incl - v;
  __syncthreads();
  return res;
}

struct RadixShared {
  int hist[256];
  uint32_t prefix;
  int krem;
};

// The exact krem-th largest of keys[0, count) (1 <= krem <= count): four
// MSB-first 8-bit radix passes with shared-memory histograms and
// warp-aggregated atomics, the same exact threshold the TPU kernel's 32
// one-bit passes give. Every thread of the block calls it and gets the key.
// keys may lie in shared or in global memory; the caller has written them.
__device__ __forceinline__ uint32_t radix_select(const uint32_t* keys,
                                                 int count, int krem,
                                                 RadixShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();  // keys written; a previous result has been read
  if (tid == 0) {
    sh.prefix = 0u;
    sh.krem = krem;
  }
  __syncthreads();
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const uint32_t hi_mask = pass == 0 ? 0u : (0xffffffffu << (shift + 8));
    const uint32_t prefix = sh.prefix;
    sh.hist[tid] = 0;  // kThreads == 256 bins
    __syncthreads();
    for (int i = tid; i < count; i += kThreads) {
      uint32_t key = keys[i];
      bool in = ((key ^ prefix) & hi_mask) == 0u;
      int bin = in ? (int)((key >> shift) & 255u) : -1;
      unsigned peers = __match_any_sync(__activemask(), bin);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&sh.hist[bin], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      // lane l owns bins 255-8l .. 248-8l (descending)
      int cnt[8];
      int sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cnt[j] = sh.hist[255 - 8 * lane - j];
        sum += cnt[j];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      const int kr = sh.krem;
      unsigned ballot = __ballot_sync(0xffffffffu, incl >= kr);
      if (lane == __ffs(ballot) - 1) {
        int above = incl - sum;  // keys whose digit is above this lane's bins
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (above + cnt[j] >= kr) {
            sh.prefix = prefix | ((uint32_t)(255 - 8 * lane - j) << shift);
            sh.krem = kr - above;
            break;
          }
          above += cnt[j];
        }
      }
    }
    __syncthreads();
  }
  return sh.prefix;
}

// Ordered compaction of the kept keys among keys[0, count): writes their
// indices, in index order, to list and returns how many there are. Each
// thread takes one contiguous range; the odd range length starts the
// threads' ranges in different shared-memory banks. Ends with a barrier.
__device__ __forceinline__ int compact_kept(const uint32_t* keys, int count,
                                            uint32_t tau_key, int* list,
                                            int* warp_sums, int* total) {
  const int chunk = ((count + kThreads - 1) / kThreads) | 1;
  const int lo = min(count, (int)threadIdx.x * chunk);
  const int hi = min(count, lo + chunk);
  int mine = 0;
  for (int i = lo; i < hi; ++i) mine += kept(keys[i], tau_key) ? 1 : 0;
  int pos = block_exclusive_scan(mine, warp_sums, total);
  for (int i = lo; i < hi; ++i)
    if (kept(keys[i], tau_key)) list[pos++] = i;
  __syncthreads();
  return *total;
}

// ------------------------------------------------------------ similarity tiles
//
// The similarity loop both kernels run: a block takes a tile of 64 queries
// and a run of up to kMaxTilesPerRun 128-key tiles. Key tiles stream into
// shared memory through a two-stage cp.async ring; the query tile stays
// resident (for Ck > 64 the channels go in chunks of 64, the query chunk
// reloaded per chunk). Each thread (tq = tid / 16, tk = tid % 16) keeps a
// 4-query x 8-key register tile, queries 4 tq + i and keys k0 + tk + 16 j:
// 32 independent chains, each over channels 0..Ck-1 in order with sim_term,
// so every similarity is bit-equal to token_similarity's and the plain
// version's. Tiles without a valid key are neither loaded nor computed.

// 16 x 16 threads, each 4 queries x 8 keys
constexpr int kQTile = 64;
constexpr int kKTile = 128;
constexpr int kCChunk = 64;       // channels a shared tile holds
constexpr int kLd = kCChunk + 4;  // row stride in floats: rows stay 16-byte
                                  // aligned, 8 consecutive rows hit 8
                                  // distinct 4-bank groups
constexpr int kMaxTilesPerRun = 8;
// dynamic shared memory of similarity_run: the query tile and two key tiles
constexpr size_t kSimSmemBytes =
    (size_t)(2 * kQTile + 2 * kKTile) * kLd * sizeof(float);

struct TileRunShared {
  int flag[kMaxTilesPerRun];
  int tiles[kMaxTilesPerRun];
  int ntiles;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The order keys of sim[q, key] for the queries in rows [q_row0, q_row0 +
// q_count) of qk / qe (q_count <= kQTile, 16-byte aligned rows) and the
// n_tiles (<= kMaxTilesPerRun) key tiles from key_lo, tile_stride tiles
// apart, handed to the epilogue:
//   epi.empty_tile(k0)      a tile from key k0 without a valid key;
//   epi.row(q, k0, key[8], tile)
//                           query q < q_count of the tile from key k0: the
//                           order keys of keys k0 + tk + 16 j (NEG_INF's for
//                           invalid keys; keys past n are the epilogue's to
//                           skip), called for q = 4 tq + i, i = 0..3 in order;
//   epi.tile_done(k0, tile) only if Epilogue::kStaged: after every row of the
//                           tile, behind a barrier.
// `tile` is the tile's key buffer, kKTile * kLd words of shared memory that
// a staged epilogue's rows may overwrite (the block has read it, behind a
// barrier): its tile_done then reads the order keys back, with the register
// tile free. smem_f holds kSimSmemBytes of dynamic shared memory. Every
// thread of the block calls it; it ends with a barrier.
template <class Epilogue>
__device__ __forceinline__ void similarity_run(
    const float* __restrict__ mk, const float* __restrict__ ms,
    const uint8_t* __restrict__ valid, const float* __restrict__ qk,
    const float* __restrict__ qe, int n, int ck, int q_row0, int q_count,
    int key_lo, int n_tiles, int tile_stride, float* smem_f, TileRunShared& sh,
    Epilogue& epi) {
  float* q_s = smem_f;              // [kQTile][kLd]
  float* e_s = q_s + kQTile * kLd;  // [kQTile][kLd]
  float* k_s = e_s + kQTile * kLd;  // [2][kKTile][kLd]
  const int tid = threadIdx.x, tq = tid >> 4, tk = tid & 15;
  const int nch = (ck + kCChunk - 1) / kCChunk;
  const float nis = neg_inv_sqrt(ck);
  const uint32_t neg_key = order_key(kNegInf);
  auto tile_key0 = [&](int t) { return key_lo + t * tile_stride * kKTile; };

  // which of the run's tiles hold a valid key
  if (tid < kMaxTilesPerRun) sh.flag[tid] = 0;
  __syncthreads();
  for (int e = tid; e < n_tiles * kKTile; e += kThreads) {
    const int i = tile_key0(e / kKTile) + e % kKTile;
    if (i < n && valid[i]) sh.flag[e / kKTile] = 1;
  }
  __syncthreads();
  if (tid == 0) {
    int m = 0;
    for (int t = 0; t < n_tiles; ++t)
      if (sh.flag[t]) sh.tiles[m++] = t;
    sh.ntiles = m;
  }
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t)
    if (!sh.flag[t]) epi.empty_tile(tile_key0(t));

  auto load_qe = [&](int h) {
    const int c0 = h * kCChunk, cw4 = min(kCChunk, ck - c0) / 4;
    for (int e = tid; e < kQTile * cw4; e += kThreads) {
      const int r = e / cw4, c4 = e - r * cw4;
      if (r < q_count) {
        const size_t g = (size_t)(q_row0 + r) * ck + c0 + 4 * c4;
        cp_async16(q_s + r * kLd + 4 * c4, qk + g);
        cp_async16(e_s + r * kLd + 4 * c4, qe + g);
      }
    }
  };
  auto load_k = [&](int stage, int buf) {
    const int h = stage % nch;
    const int c0 = h * kCChunk, cw4 = min(kCChunk, ck - c0) / 4;
    const int k0 = tile_key0(sh.tiles[stage / nch]);
    float* dst = k_s + buf * kKTile * kLd;
    for (int e = tid; e < kKTile * cw4; e += kThreads) {
      const int r = e / cw4, c4 = e - r * cw4, key = k0 + r;
      if (key < n)
        cp_async16(dst + r * kLd + 4 * c4, mk + (size_t)key * ck + c0 + 4 * c4);
    }
  };

  // the ring: stage s = (valid tile s / nch, channel chunk s % nch). Rows
  // past N and queries past q_count are not loaded; their accumulators are
  // never handed on.
  const int n_stages = sh.ntiles * nch;
  if (nch == 1) load_qe(0);
  if (n_stages > 0) load_k(0, 0);
  cp_async_commit();
  float acc[4][8];
  for (int s = 0; s < n_stages; ++s) {
    const int h = s % nch;
    if (nch > 1) load_qe(h);  // the previous stage's readers are past the barrier
    cp_async_commit();
    if (s + 1 < n_stages) load_k(s + 1, (s + 1) & 1);
    cp_async_commit();
    cp_async_wait_all_but_newest();  // this stage's key (and query) chunk
    __syncthreads();
    if (h == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    float* kb = k_s + (s & 1) * kKTile * kLd;
    const int cw = min(kCChunk, ck - h * kCChunk);
#pragma unroll 2
    for (int c = 0; c < cw; c += 4) {
      float4 q4[4], e4[4], m4[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        q4[i] = *reinterpret_cast<const float4*>(q_s + (tq * 4 + i) * kLd + c);
        e4[i] = *reinterpret_cast<const float4*>(e_s + (tq * 4 + i) * kLd + c);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        m4[j] = *reinterpret_cast<const float4*>(kb + (tk + 16 * j) * kLd + c);
      // channels c, c+1, c+2, c+3 in order on every chain
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = sim_term(acc[i][j], m4[j].x, q4[i].x, e4[i].x);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = sim_term(acc[i][j], m4[j].y, q4[i].y, e4[i].y);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = sim_term(acc[i][j], m4[j].z, q4[i].z, e4[i].z);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = sim_term(acc[i][j], m4[j].w, q4[i].w, e4[i].w);
    }
    if (h == nch - 1) {  // the tile's last chunk: apply ms and -1/sqrt(Ck)
      if (Epilogue::kStaged) __syncthreads();  // the key tile is read
      const int k0 = tile_key0(sh.tiles[s / nch]);
      float shr[8];
      bool ok[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + tk + 16 * j;
        ok[j] = key < n && valid[key];
        shr[j] = ok[j] ? ms[key] : 0.f;
      }
      uint32_t* tile = reinterpret_cast<uint32_t*>(kb);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = tq * 4 + i;
        if (q >= q_count) continue;
        uint32_t key[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          key[j] = ok[j] ? order_key(__fmul_rn(__fmul_rn(acc[i][j], shr[j]), nis))
                         : neg_key;
        epi.row(q, k0, key, tile);
      }
      if (Epilogue::kStaged) {
        __syncthreads();
        epi.tile_done(k0, tile);
      }
    }
    __syncthreads();  // both buffers free for the next loads
  }
  __syncthreads();  // the run's flags are read; the caller may start another
}

}  // namespace cutie_read
