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

}  // namespace cutie_read
