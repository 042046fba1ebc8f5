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
// form instead, whose terms qe*(mk - qk)^2 are nonnegative: in fp32 on the
// CUDA cores it is exact to fp32 rounding, with no fp64, TF32 or bf16.
// Every difference, product and sum is rounded on its own (__fsub_rn,
// __fmul_rn, __fadd_rn: no contraction into FMAs), over the channels in
// order, exactly as the plain version (ops/memory.py:get_similarity) does
// with PyTorch ops: the kernel and its plain version agree bit for bit on
// the similarity, so on tau and on every kept token as well.
//
// Design. The TPU kernel keeps a [256, N] block of order keys resident in a
// 100 MB VMEM. An SM has 227 KB of shared memory, so here one thread block
// owns ONE query and keeps that query's N order keys (plus an N-entry index
// list) in dynamic shared memory: 8N bytes, 65 KB at N~8.1k and 225 KB at
// the long-term N~28k. The block
//   1. streams the keys (mk, ms, valid) from L2/HBM and computes the
//      similarity,
//   2. finds tau by four MSB-first 8-bit radix passes over the order keys
//      (shared-memory histograms, warp-aggregated atomics): the same exact
//      threshold the TPU's 32 one-bit passes give,
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

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kMaxSegs = 3;

struct Segments {
  const void* ptr[kMaxSegs];
  long long off[kMaxSegs];  // first key index of the segment
  long long cap[kMaxSegs];  // value rows of the segment
  int n;
};

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

__device__ __forceinline__ float load_value(const float* p) { return *p; }
__device__ __forceinline__ float load_value(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Exclusive scan of one int per thread over the block; returns the
// exclusive prefix and writes the block total to *total.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
radix_topk_readout_kernel(const float* __restrict__ mk,
                          const float* __restrict__ ms,
                          const uint8_t* __restrict__ valid,
                          const float* __restrict__ qk,
                          const float* __restrict__ qe,
                          Segments segs, int n, int p_total, int ck, int o_dim,
                          int cv, int top_k, float* __restrict__ out,
                          float* __restrict__ usage, float* __restrict__ tau_out) {
  extern __shared__ uint32_t smem[];
  uint32_t* keys = smem;                                  // [n]
  int* list = reinterpret_cast<int*>(smem + n);           // [n]
  __shared__ __align__(16) float q_k[256];
  __shared__ __align__(16) float q_e[256];
  __shared__ int hist[256];
  __shared__ int warp_sums[kWarps];
  __shared__ uint32_t s_prefix;
  __shared__ int s_krem, s_count;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = blockIdx.x;
  // the plain version multiplies by the fp64 value -1/sqrt(Ck) rounded to fp32
  const float neg_inv_sqrt_ck = (float)(-1.0 / sqrt((double)ck));

  // ---- query constants
  for (int c = tid; c < ck; c += kThreads) {
    q_k[c] = qk[(size_t)p * ck + c];
    q_e[c] = qe[(size_t)p * ck + c];
  }
  __syncthreads();
  const float4* qk4 = reinterpret_cast<const float4*>(q_k);
  const float4* qe4 = reinterpret_cast<const float4*>(q_e);

  // ---- 1. similarity -> order keys in shared memory
  for (int i = tid; i < n; i += kThreads) {
    float sim = kNegInf;
    if (valid[i]) {
      const float4* row = reinterpret_cast<const float4*>(mk + (size_t)i * ck);
      float s = 0.f;
      for (int c4 = 0; c4 < ck / 4; ++c4) {
        const float4 m = __ldg(row + c4), q = qk4[c4], e = qe4[c4];
        s = sim_term(s, m.x, q.x, e.x);
        s = sim_term(s, m.y, q.y, e.y);
        s = sim_term(s, m.z, q.z, e.z);
        s = sim_term(s, m.w, q.w, e.w);
      }
      sim = __fmul_rn(__fmul_rn(s, ms[i]), neg_inv_sqrt_ck);
    }
    keys[i] = order_key(sim);
  }
  if (tid == 0) {
    s_prefix = 0u;
    s_krem = min(top_k, n);
  }
  __syncthreads();

  // ---- 2. exact k-th largest: four MSB-first 8-bit radix passes
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const uint32_t hi_mask = pass == 0 ? 0u : (0xffffffffu << (shift + 8));
    const uint32_t prefix = s_prefix;
    hist[tid] = 0;  // kThreads == 256 bins
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      uint32_t key = keys[i];
      bool in = ((key ^ prefix) & hi_mask) == 0u;
      int bin = in ? (int)((key >> shift) & 255u) : -1;
      unsigned peers = __match_any_sync(__activemask(), bin);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      // lane l owns bins 255-8l .. 248-8l (descending)
      int cnt[8];
      int sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cnt[j] = hist[255 - 8 * lane - j];
        sum += cnt[j];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      const int krem = s_krem;
      unsigned ballot = __ballot_sync(0xffffffffu, incl >= krem);
      if (lane == __ffs(ballot) - 1) {
        int above = incl - sum;  // tokens whose digit is above this lane's bins
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (above + cnt[j] >= krem) {
            s_prefix = prefix | ((uint32_t)(255 - 8 * lane - j) << shift);
            s_krem = krem - above;
            break;
          }
          above += cnt[j];
        }
      }
    }
    __syncthreads();
  }
  const uint32_t tau_key = s_prefix;
  if (tid == 0) tau_out[p] = invert_order_key(tau_key);

  // ---- 3. ordered compaction of the kept tokens (w > 0)
  // odd chunk length: the threads' contiguous chunks start in different
  // shared-memory banks
  const int chunk = ((n + kThreads - 1) / kThreads) | 1;
  const int lo = min(n, tid * chunk), hi = min(n, lo + chunk);
  int mine = 0;
  for (int i = lo; i < hi; ++i) {
    uint32_t key = keys[i];
    mine += (key >= tau_key && expf(invert_order_key(key)) > 0.f) ? 1 : 0;
  }
  int pos = block_exclusive_scan(mine, warp_sums, &s_count);
  for (int i = lo; i < hi; ++i) {
    uint32_t key = keys[i];
    if (key >= tau_key && expf(invert_order_key(key)) > 0.f) list[pos++] = i;
  }
  __syncthreads();
  const int count = s_count;

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
           int ck, int o, int cv, int top_k, float* out, float* usage,
           float* tau, cudaStream_t stream) {
  const size_t smem = (size_t)n * 2 * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      radix_topk_readout_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  radix_topk_readout_kernel<T><<<p, kThreads, smem, stream>>>(
      mk, ms, valid, qk, qe, segs, n, p, ck, o, cv, top_k, out, usage, tau);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest key count one block can hold: 8 bytes of dynamic shared memory per
// token, beside the kernel's static shared memory.
int radix_topk_readout_max_tokens(void) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, radix_topk_readout_kernel<float>) != cudaSuccess)
    return -1;
  return (optin - (int)attr.sharedSizeBytes) / 8;
}

// All pointers are device pointers; out is [o, p, cv] fp32, usage [n] fp32
// (zeroed by the caller), tau [p] fp32. Returns a cudaError_t (0 = launched).
int radix_topk_readout_launch(const void* mk, const void* ms, const void* valid,
                              const void* qk, const void* qe, const void* v0,
                              const void* v1, const void* v2, long long off0,
                              long long off1, long long off2, long long cap0,
                              long long cap1, long long cap2, int n_segs, int n,
                              int p, int ck, int o, int cv, int top_k,
                              int values_bf16, void* out, void* usage, void* tau,
                              void* stream) {
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
  float* f_out = static_cast<float*>(out);
  float* f_usage = static_cast<float*>(usage);
  float* f_tau = static_cast<float*>(tau);
  if (values_bf16)
    return launch<__nv_bfloat16>(f_mk, f_ms, u_valid, f_qk, f_qe, segs, n, p, ck,
                                 o, cv, top_k, f_out, f_usage, f_tau, s);
  return launch<float>(f_mk, f_ms, u_valid, f_qk, f_qe, segs, n, p, ck, o, cv,
                       top_k, f_out, f_usage, f_tau, s);
}

}  // extern "C"
