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
// with the similarity of read_common.cuh:token_similarity, so tau agrees bit
// for bit with radix_topk_readout.cu and with the plain version.
//
// What bounds it on this card: the similarity, which this design evaluates
// three times (2*P*N*2Ck operations a pass: 3.4 GFLOP at P=1620, N~8.1k,
// Ck=64); the bytes (keys, kept value rows, outputs) are a few tens of MB.
//
// Design. Its distinct property, kept from the TPU kernel, is a streaming
// read whose per-query state is O(k), not O(N): no scratch of N entries in
// shared or global memory, so N has no upper bound. One block of 256
// threads owns one query and walks the keys in chunks of kChunk tokens,
// recomputing the similarity in each of three passes:
//   1. the running top-k: the chunk's order keys that can enter the current
//      top-k multiset (all of them while it holds fewer than k, else those
//      above its minimum) are appended to it in shared memory, and a radix
//      select over the (k + candidates) keys gives the new k-th largest t;
//      the new multiset is the keys above t plus copies of t up to k. After
//      the last chunk tau is that multiset's minimum, the exact k-th largest
//      (min(k, N)-th when N < k, as in the plain version). The TPU kernel
//      does the same merge by k steps of max-extract.
//   2. the readout: the chunk's kept tokens are compacted in token order, Z
//      and sum w*v accumulate in that order (the O*Cv columns of the output
//      row are this block's alone, carried in the output between chunks),
//      and the row is divided by Z at the end: the same operations in the
//      same order as radix_topk_readout.cu, so the readouts agree bit for
//      bit too.
//   3. usage: w/Z added with atomicAdd, whose order varies from run to run.
// Padded queries (qk = 1e6, qe = 1) give sim ~ -1e14: every w underflows to
// 0 and they add nothing to the readout or to usage.

#include <cuda_runtime.h>
#include <stdint.h>

#include "read_common.cuh"

namespace {

using namespace cutie_read;

constexpr int kChunk = 2048;

__global__ void __launch_bounds__(kThreads)
fused_topk_readout_kernel(const float* __restrict__ mk,
                          const float* __restrict__ ms,
                          const uint8_t* __restrict__ valid,
                          const float* __restrict__ qk,
                          const float* __restrict__ qe,
                          const float* __restrict__ values, int n, int p_total,
                          int ck, int o_dim, int cv, int top_k,
                          float* __restrict__ out, float* __restrict__ usage,
                          float* __restrict__ tau_out) {
  extern __shared__ uint32_t smem[];
  // pass 1: the top-k multiset [0, m) then the chunk's candidates;
  // passes 2-3: the chunk's order keys
  uint32_t* keys = smem;                                      // [top_k + kChunk]
  // pass 1: keys above the new threshold; passes 2-3: the kept-token list
  uint32_t* aux = smem + top_k + kChunk;                      // [max(top_k, kChunk)]
  int* list = reinterpret_cast<int*>(aux);
  __shared__ __align__(16) float q_k[256];
  __shared__ __align__(16) float q_e[256];
  __shared__ RadixShared rsh;
  __shared__ int warp_sums[kWarps];
  __shared__ int s_count, s_cand, s_above, s_m;
  __shared__ uint32_t s_min;

  const int tid = threadIdx.x;
  const int p = blockIdx.x;
  const float nis = neg_inv_sqrt(ck);

  if (tid == 0) {
    s_m = 0;
    s_min = 0u;
    s_cand = 0;
  }
  load_query(qk, qe, p, ck, q_k, q_e);

  // ---- 1. running exact top-k multiset
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int c1 = min(n, c0 + kChunk);
    const int m = s_m;
    const uint32_t lo = s_min;
    for (int i = c0 + tid; i < c1; i += kThreads) {
      const uint32_t key =
          order_key(token_similarity(mk, ms, valid, i, ck, q_k, q_e, nis));
      if (m < top_k || key > lo) keys[m + atomicAdd(&s_cand, 1)] = key;
    }
    __syncthreads();
    const int cand = s_cand;
    __syncthreads();  // everyone has read s_cand before it changes
    if (cand == 0) continue;
    const int total = m + cand;
    const int kk = min(top_k, total);
    const uint32_t t = radix_select(keys, total, kk, rsh);
    if (tid == 0) s_above = 0;
    __syncthreads();
    for (int j = tid; j < total; j += kThreads)
      if (keys[j] > t) aux[atomicAdd(&s_above, 1)] = keys[j];  // fewer than kk
    __syncthreads();
    const int above = s_above;
    for (int j = tid; j < kk; j += kThreads) keys[j] = j < above ? aux[j] : t;
    if (tid == 0) {
      s_m = kk;
      s_min = t;
      s_cand = 0;
    }
    __syncthreads();
  }
  const uint32_t tau_key = s_min;
  if (tid == 0) tau_out[p] = invert_order_key(tau_key);

  // ---- 2. readout, chunk by chunk in token order
  const int ocv = o_dim * cv;
  for (int col = tid; col < ocv; col += kThreads) {
    const int o = col / cv, c = col - o * cv;
    out[((size_t)o * p_total + p) * cv + c] = 0.f;
  }
  float z = 0.f;
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int len = min(n, c0 + kChunk) - c0;
    for (int i = tid; i < len; i += kThreads)
      keys[i] = order_key(
          token_similarity(mk, ms, valid, c0 + i, ck, q_k, q_e, nis));
    __syncthreads();
    const int count = compact_kept(keys, len, tau_key, list, warp_sums, &s_count);
    for (int j = 0; j < count; ++j) z += expf(invert_order_key(keys[list[j]]));
    if (count > 0) {
      for (int col = tid; col < ocv; col += kThreads) {
        const int o = col / cv, c = col - o * cv;
        float* dst = out + ((size_t)o * p_total + p) * cv + c;
        float acc = *dst;
        for (int j = 0; j < count; ++j) {
          const int i = list[j];
          const float w = expf(invert_order_key(keys[i]));
          acc = fmaf(w, values[((size_t)o * n + c0 + i) * cv + c], acc);
        }
        *dst = acc;
      }
    }
    __syncthreads();  // keys and list are rewritten by the next chunk
  }
  const float zsafe = fmaxf(z, 1e-30f);
  for (int col = tid; col < ocv; col += kThreads) {
    const int o = col / cv, c = col - o * cv;
    float* dst = out + ((size_t)o * p_total + p) * cv + c;
    *dst = *dst / zsafe;
  }

  // ---- 3. usage
  for (int i = tid; i < n; i += kThreads) {
    const uint32_t key =
        order_key(token_similarity(mk, ms, valid, i, ck, q_k, q_e, nis));
    if (kept(key, tau_key))
      atomicAdd(&usage[i], expf(invert_order_key(key)) / zsafe);
  }
}

size_t smem_bytes(int top_k) {
  return (size_t)(top_k + kChunk + (top_k > kChunk ? top_k : kChunk)) *
         sizeof(uint32_t);
}

}  // namespace

extern "C" {

// Resident blocks per SM at this top_k (shared memory O(top_k + kChunk),
// whatever N is). Returns a cudaError_t.
int fused_topk_readout_occupancy(int top_k, int* blocks) {
  const size_t smem = smem_bytes(top_k);
  cudaError_t err = cudaFuncSetAttribute(
      fused_topk_readout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fused_topk_readout_kernel, kThreads, smem);
}

// All pointers are device pointers: values [o, n, cv] fp32, out [o, p, cv]
// fp32, usage [n] fp32 (zeroed by the caller), tau [p] fp32. Returns a
// cudaError_t (0 = launched).
int fused_topk_readout_launch(const void* mk, const void* ms, const void* valid,
                              const void* qk, const void* qe,
                              const void* values, int n, int p, int ck, int o,
                              int cv, int top_k, void* out, void* usage,
                              void* tau, void* stream) {
  const size_t smem = smem_bytes(top_k);
  cudaError_t err = cudaFuncSetAttribute(
      fused_topk_readout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_topk_readout_kernel<<<p, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mk), static_cast<const float*>(ms),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(qk),
      static_cast<const float*>(qe), static_cast<const float*>(values), n, p,
      ck, o, cv, top_k, static_cast<float*>(out), static_cast<float*>(usage),
      static_cast<float*>(tau));
  return (int)cudaGetLastError();
}

}  // extern "C"
