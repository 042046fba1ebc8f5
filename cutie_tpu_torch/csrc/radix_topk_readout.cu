// Exact top-k softmax memory read for Hopper (sm_90a).
//
// Replaces the TPU kernel cutie_tpu/ops/pallas_kernels.py:radix_topk_readout
// (body _radix_read_kernel). For one batch row it computes, per query p:
//   sim[p,n] = -sum_c qe[p,c] (mk[n,c] - qk[p,c])^2 * ms[n] / sqrt(Ck)
//              (NEG_INF where valid[n] == 0)
//   tau[p]   = the exact k-th largest sim[p,:]           (ties all kept)
//   w[p,n]   = exp(sim[p,n]) * [sim[p,n] >= tau[p]]      (sim <= 0: no max)
//   out[o,p] = sum_n w[p,n] v[o,n,:] / sum_n w[p,n]
//   usage[n] = sum_p w[p,n] / sum_n w[p,n]
//
// What bounds it on this card: the similarity, 2*P*N*2Ck operations (3.4
// GFLOP at the d17 shapes: P=1620, N~8.1k, Ck=64), is the largest term; the
// bytes it must move (keys once, the value rows the queries keep, the
// outputs) are a few tens of MB.
//
// Precision. The TPU kernel and the reference evaluate the expanded form
// sum_c qe*(2 qk mk - mk^2) - sum_c qe qk^2, which cancels by about three
// digits on trained keys (norms near 17 while the kept similarities are near
// -1): in fp32 it is off by ~1e-3 there. This kernel evaluates the direct
// form instead (read_common.cuh:token_similarity), whose terms
// qe*(mk - qk)^2 are nonnegative: in fp32 on the CUDA cores it is exact to
// fp32 rounding, with no fp64, TF32 or bf16. Every difference, product and
// sum is rounded on its own, over the channels in order, exactly as the
// plain version (ops/memory.py:get_similarity) does with PyTorch ops: the
// kernel and its plain version agree bit for bit on the similarity, so on
// tau and on every kept token as well.
//
// Design. The TPU kernel keeps a [256, N] block of order keys resident in a
// 100 MB VMEM. Here one thread block owns ONE query and keeps that query's N
// order keys plus an N-entry index list, 8N bytes, in a scratch:
//   - in dynamic shared memory when 8N bytes fit one block's opt-in limit
//     (N <= radix_topk_readout_max_tokens(), 28,666 keys on an H100: 65 KB at
//     the d17 N~8.1k, one block per SM near the limit);
//   - past that, in a global-memory workspace of 8N bytes per query that the
//     wrapper allocates for a wave of queries; the queries are launched in
//     waves of that size. The kernel body is the same template, instantiated
//     on where the scratch lives, so both give the same bits.
// The block
//   1. streams the keys (mk, ms, valid) from L2/HBM and computes the
//      similarity,
//   2. finds tau by four MSB-first 8-bit radix passes over the order keys
//      (read_common.cuh:radix_select): the same exact threshold the TPU's 32
//      one-bit passes give,
//   3. compacts the kept tokens (w > 0) into the index list IN TOKEN ORDER
//      with a block scan, so the readout sums in a fixed order and is
//      deterministic,
//   4. gathers only those value rows (at most k plus ties) and accumulates
//      sum w*v in fp32 over the O*Cv output columns; values stay in their
//      perm | lt | work segments and are read in place (fp32, or bf16 in
//      the amp mode, widened to fp32),
//   5. adds w/Z to usage with atomicAdd. The order of those adds varies
//      from run to run, so usage agrees with a fixed-order sum to fp32
//      rounding, not bit for bit.
// Padded queries (qk = 1e6, qe = 1) give sim ~ -1e14: every w underflows to
// 0 and they add nothing to the readout or to usage.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "read_common.cuh"

namespace {

using namespace cutie_read;

constexpr int kMaxSegs = 3;

struct Segments {
  const void* ptr[kMaxSegs];
  long long off[kMaxSegs];  // first key index of the segment
  long long cap[kMaxSegs];  // value rows of the segment
  int n;
};

__device__ __forceinline__ float load_value(const float* p) { return *p; }
__device__ __forceinline__ float load_value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// kGlobalScratch: the keys and the index list live in scratch (8N bytes per
// block of the wave) instead of dynamic shared memory. Block b reads query
// p0 + b.
template <typename T, bool kGlobalScratch>
__global__ void __launch_bounds__(kThreads)
radix_topk_readout_kernel(const float* __restrict__ mk,
                          const float* __restrict__ ms,
                          const uint8_t* __restrict__ valid,
                          const float* __restrict__ qk,
                          const float* __restrict__ qe,
                          Segments segs, int n, int p0, int p_total, int ck,
                          int o_dim, int cv, int top_k,
                          uint32_t* __restrict__ scratch,
                          float* __restrict__ out,
                          float* __restrict__ usage, float* __restrict__ tau_out) {
  extern __shared__ uint32_t smem[];
  uint32_t* keys;                                          // [n]
  if constexpr (kGlobalScratch)
    keys = scratch + (size_t)blockIdx.x * 2 * (size_t)n;
  else
    keys = smem;
  int* list = reinterpret_cast<int*>(keys + n);           // [n]
  __shared__ __align__(16) float q_k[256];
  __shared__ __align__(16) float q_e[256];
  __shared__ RadixShared rsh;
  __shared__ int warp_sums[kWarps];
  __shared__ int s_count;

  const int tid = threadIdx.x;
  const int p = p0 + blockIdx.x;
  const float nis = neg_inv_sqrt(ck);

  load_query(qk, qe, p, ck, q_k, q_e);

  // ---- 1. similarity -> order keys in the scratch
  for (int i = tid; i < n; i += kThreads)
    keys[i] = order_key(token_similarity(mk, ms, valid, i, ck, q_k, q_e, nis));

  // ---- 2. exact k-th largest
  const uint32_t tau_key = radix_select(keys, n, min(top_k, n), rsh);
  if (tid == 0) tau_out[p] = invert_order_key(tau_key);

  // ---- 3. ordered compaction of the kept tokens (w > 0)
  const int count = compact_kept(keys, n, tau_key, list, warp_sums, &s_count);

  // ---- 4. readout: gather the kept value rows, fp32 accumulation
  float z = 0.f;
  for (int j = 0; j < count; ++j) z += expf(invert_order_key(keys[list[j]]));
  const float zsafe = fmaxf(z, 1e-30f);
  const int ocv = o_dim * cv;
  for (int col = tid; col < ocv; col += kThreads) {
    const int o = col / cv, c = col - o * cv;
    float acc = 0.f;
    for (int j = 0; j < count; ++j) {
      const int i = list[j];
      int s = 0;
      while (s + 1 < segs.n && i >= segs.off[s + 1]) ++s;
      const long long r = i - segs.off[s];
      const T* v = static_cast<const T*>(segs.ptr[s]);
      const float w = expf(invert_order_key(keys[i]));
      acc = fmaf(w, load_value(v + ((size_t)o * segs.cap[s] + r) * cv + c), acc);
    }
    out[((size_t)o * p_total + p) * cv + c] = acc / zsafe;
  }

  // ---- 5. usage
  for (int j = tid; j < count; j += kThreads) {
    const int i = list[j];
    atomicAdd(&usage[i], expf(invert_order_key(keys[i])) / zsafe);
  }
}

template <typename T>
int launch(const float* mk, const float* ms, const uint8_t* valid,
           const float* qk, const float* qe, Segments segs, int n, int p,
           int ck, int o, int cv, int top_k, uint32_t* scratch, int wave,
           float* out, float* usage, float* tau, cudaStream_t stream) {
  if (scratch == nullptr) {
    const size_t smem = (size_t)n * 2 * sizeof(uint32_t);
    cudaError_t err = cudaFuncSetAttribute(
        radix_topk_readout_kernel<T, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    radix_topk_readout_kernel<T, false><<<p, kThreads, smem, stream>>>(
        mk, ms, valid, qk, qe, segs, n, 0, p, ck, o, cv, top_k, nullptr, out,
        usage, tau);
    return (int)cudaGetLastError();
  }
  // the waves run one after another on the stream and share the scratch
  for (int p0 = 0; p0 < p; p0 += wave) {
    radix_topk_readout_kernel<T, true><<<min(wave, p - p0), kThreads, 0, stream>>>(
        mk, ms, valid, qk, qe, segs, n, p0, p, ck, o, cv, top_k, scratch, out,
        usage, tau);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <typename T>
int occupancy(int n, int global_scratch, int* blocks) {
  if (global_scratch)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, radix_topk_readout_kernel<T, true>, kThreads, 0);
  const size_t smem = (size_t)n * 2 * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      radix_topk_readout_kernel<T, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, radix_topk_readout_kernel<T, false>, kThreads, smem);
}

}  // namespace

extern "C" {

// Largest key count whose 8 bytes a token fit one block's dynamic shared
// memory beside the kernel's static shared memory: the shared-memory path
// takes N up to this, the global-scratch path every N above it.
int radix_topk_readout_max_tokens(void) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  cudaFuncAttributes a32, a16;
  if (cudaFuncGetAttributes(&a32, radix_topk_readout_kernel<float, false>) !=
          cudaSuccess ||
      cudaFuncGetAttributes(&a16, radix_topk_readout_kernel<__nv_bfloat16, false>) !=
          cudaSuccess)
    return -1;
  const int stat = (int)(a32.sharedSizeBytes > a16.sharedSizeBytes
                             ? a32.sharedSizeBytes : a16.sharedSizeBytes);
  return (optin - stat) / 8;
}

// Resident blocks per SM of the path a key count takes (global_scratch 0:
// shared memory, 1: global workspace). Returns a cudaError_t.
int radix_topk_readout_occupancy(int n, int global_scratch, int values_bf16,
                                 int* blocks) {
  return values_bf16 ? occupancy<__nv_bfloat16>(n, global_scratch, blocks)
                     : occupancy<float>(n, global_scratch, blocks);
}

// All pointers are device pointers; out is [o, p, cv] fp32, usage [n] fp32
// (zeroed by the caller), tau [p] fp32. scratch is null for the
// shared-memory path, else a workspace of wave * n * 8 bytes. Returns a
// cudaError_t (0 = launched).
int radix_topk_readout_launch(const void* mk, const void* ms, const void* valid,
                              const void* qk, const void* qe, const void* v0,
                              const void* v1, const void* v2, long long off0,
                              long long off1, long long off2, long long cap0,
                              long long cap1, long long cap2, int n_segs, int n,
                              int p, int ck, int o, int cv, int top_k,
                              int values_bf16, void* scratch, int wave,
                              void* out, void* usage, void* tau, void* stream) {
  Segments segs;
  segs.ptr[0] = v0; segs.ptr[1] = v1; segs.ptr[2] = v2;
  segs.off[0] = off0; segs.off[1] = off1; segs.off[2] = off2;
  segs.cap[0] = cap0; segs.cap[1] = cap1; segs.cap[2] = cap2;
  segs.n = n_segs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f_mk = static_cast<const float*>(mk);
  const float* f_ms = static_cast<const float*>(ms);
  const uint8_t* u_valid = static_cast<const uint8_t*>(valid);
  const float* f_qk = static_cast<const float*>(qk);
  const float* f_qe = static_cast<const float*>(qe);
  uint32_t* u_scratch = static_cast<uint32_t*>(scratch);
  float* f_out = static_cast<float*>(out);
  float* f_usage = static_cast<float*>(usage);
  float* f_tau = static_cast<float*>(tau);
  if (values_bf16)
    return launch<__nv_bfloat16>(f_mk, f_ms, u_valid, f_qk, f_qe, segs, n, p, ck,
                                 o, cv, top_k, u_scratch, wave, f_out, f_usage,
                                 f_tau, s);
  return launch<float>(f_mk, f_ms, u_valid, f_qk, f_qe, segs, n, p, ck, o, cv,
                       top_k, u_scratch, wave, f_out, f_usage, f_tau, s);
}

}  // extern "C"
