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
// What bounds it on this card: the similarity, 4*P*N*Ck fp32 operations (2.0
// G at the d17 shapes: P=1620, 4,860 valid keys, Ck=64), is the largest term.
// Its four operations per (query, key, channel) are rounded one by one (see
// Precision), so none fuses into an FMA: at most half of the card's 67
// TFLOP/s fp32 rate (which counts an FMA as two) is open to it. The bytes the
// function must move (keys once, the value rows the queries keep, the
// outputs) are a few tens of MB.
//
// Precision. The TPU kernel and the reference evaluate the expanded form
// sum_c qe*(2 qk mk - mk^2) - sum_c qe qk^2, which cancels by about three
// digits on trained keys. This kernel evaluates the direct form
// (read_common.cuh:sim_term), whose terms qe*(mk - qk)^2 are nonnegative:
// exact to fp32 rounding on the CUDA cores, with no fp64, TF32, bf16 or
// tensor cores. Every difference, product and sum is rounded on its own, over
// the channels in order, as the plain version (ops/memory.py:get_similarity)
// does with PyTorch ops: the kernel and its plain version agree bit for bit
// on the similarity, so on tau and on every kept token as well.
//
// Design: two stages a wave of queries, through a workspace of order keys
// [wave, ld] uint32 (ld = N rounded up to 4) in global memory. The wrapper
// (ops/read_kernel.py) sizes the waves to its workspace budget.
//   1. similarity_kernel: a block takes a tile of 64 queries and one run of
//      up to 8 128-key tiles, through the loop both kernels share
//      (read_common.cuh:similarity_run): key tiles stream into shared memory
//      through a two-stage cp.async ring, each thread keeps a 4-query x 8-key
//      register tile, and the key bytes move from L2 once per query tile, not
//      once per query. Its epilogue writes the order keys to the workspace;
//      tiles without a valid key (empty ring slots, free long-term slots) are
//      not loaded or computed, and their order keys are NEG_INF's.
//   2. select_readout_kernel: one block of 256 threads a query, over its row.
//      a. A pivot: the k-th largest of the 256 threads' maxima over the row.
//         At least k distinct keys are >= it, so tau >= pivot.
//      b. The keys >= pivot, in token order, go to a candidate list in shared
//         memory (a few hundred at the d17 and LVOS shapes), with a block scan
//         per 1,024 keys. tau is the exact k-th largest of the candidates: four
//         MSB-first 8-bit radix passes (read_common.cuh:radix_select) over the
//         list, not over N. Past kCandCap candidates the same select runs over
//         the row in global memory.
//      c. The kept tokens (>= tau, w > 0) are compacted in token order, each
//         with its weight and value-row pointer (segment lookup and expf
//         hoisted out of the column loop). A thread carries three output
//         columns, so their value loads overlap. Z and the readout sum in
//         token order with fmaf and divide by max(Z, 1e-30): the same operations in
//         the same order as fused_topk_readout.cu, so the two kernels' readouts
//         agree bit for bit. Past kListCap kept tokens (more than a thousand
//         exact ties at tau) the same sums run straight over the row.
//      d. usage += w/Z by atomicAdd, whose order varies from run to run.
//   Values stay in their perm | lt | work segments and are read in place
//   (fp32, or bf16 in the amp mode, widened to fp32).
// Padded queries (qk = 1e6, qe = 1) give sim ~ -1e14: every w underflows to
// 0 and they add nothing to the readout or to usage.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "read_common.cuh"

namespace {

using namespace cutie_read;

constexpr int kMaxSegs = 3;

// stage 2 capacities (shared memory)
constexpr int kCandCap = 2048;
constexpr int kListCap = 1024;
// readout columns a thread carries at once (3 x 256 = the 768 columns of
// three objects): their loads overlap. 4, or two tokens at once, cost
// registers and with them resident blocks, and measured slower (PERF.md).
constexpr int kCols = 3;

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

// ------------------------------------------------------------ stage 1

// Writes the order keys of one query tile's rows to the workspace.
struct WorkspaceEpilogue {
  static constexpr bool kStaged = false;
  uint32_t* ws;  // row 0 = the tile's first query
  int ld, n, q_count;
  __device__ __forceinline__ void empty_tile(int k0) const {
    const int tq = threadIdx.x >> 4, tk = threadIdx.x & 15;
    const uint32_t neg_key = order_key(kNegInf);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (tq * 4 + i >= q_count) continue;
      uint32_t* dst = ws + (size_t)(tq * 4 + i) * ld;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + tk + 16 * j;
        if (key < n) dst[key] = neg_key;
      }
    }
  }
  __device__ __forceinline__ void row(int q, int k0, const uint32_t* key,
                                      uint32_t*) const {
    const int tk = threadIdx.x & 15;
    uint32_t* dst = ws + (size_t)q * ld;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (k0 + tk + 16 * j < n) dst[k0 + tk + 16 * j] = key[j];
  }
  __device__ __forceinline__ void tile_done(int, uint32_t*) const {}
};

// Order keys of sim[p0 + q, key] for the wave's queries q in [0, p_count),
// into ws[q * ld + key]: read_common.cuh:similarity_run over one run of
// tiles_per_block key tiles a block. Grid: x runs, y query tiles.
__global__ void __launch_bounds__(kThreads, 2)
similarity_kernel(const float* __restrict__ mk, const float* __restrict__ ms,
                  const uint8_t* __restrict__ valid,
                  const float* __restrict__ qk, const float* __restrict__ qe,
                  int n, int ck, int p0, int p_count, int tiles_per_block,
                  int ld, uint32_t* __restrict__ ws) {
  extern __shared__ __align__(16) float smem_f[];
  __shared__ TileRunShared sh;
  const int q_lo = blockIdx.y * kQTile;
  const int key_lo = blockIdx.x * tiles_per_block * kKTile;
  const int n_tiles = (min(n, key_lo + tiles_per_block * kKTile) - key_lo +
                       kKTile - 1) / kKTile;
  const int q_count = min(kQTile, p_count - q_lo);
  WorkspaceEpilogue epi{ws + (size_t)q_lo * ld, ld, n, q_count};
  similarity_run(mk, ms, valid, qk, qe, n, ck, p0 + q_lo, q_count, key_lo,
                 n_tiles, 1, smem_f, sh, epi);
}

// ------------------------------------------------------------ stage 2

// The entries of src[0, count) that pass pred, in index order: emit(slot, j,
// key) for the slot-th of them (slot counts from 0). Returns how many pass.
// src is 16-byte aligned (shared or global). Every thread of the block calls
// it; ends with a barrier.
template <class Pred, class Emit>
__device__ __forceinline__ int ordered_filter(const uint32_t* src, int count,
                                              Pred pred, Emit emit,
                                              int* warp_sums, int* s_total) {
  int total = 0;
  auto load4 = [&](int b, uint32_t* key) {
    if (b + 3 < count) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + b);
      key[0] = v.x; key[1] = v.y; key[2] = v.z; key[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) key[e] = b + e < count ? src[b + e] : 0u;
    }
  };
  uint32_t nxt[4];  // the next chunk's keys load during this chunk's scan
  load4(4 * (int)threadIdx.x, nxt);
  for (int b0 = 0; b0 < count; b0 += 4 * kThreads) {
    const int b = b0 + 4 * (int)threadIdx.x;
    uint32_t key[4] = {nxt[0], nxt[1], nxt[2], nxt[3]};
    if (b0 + 4 * kThreads < count) load4(b + 4 * kThreads, nxt);
    bool pass[4];
    int m = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pass[e] = b + e < count && pred(key[e]);
      m += pass[e] ? 1 : 0;
    }
    int slot = total + block_exclusive_scan(m, warp_sums, s_total);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (pass[e]) emit(slot++, b + e, key[e]);
    total += *s_total;  // rewritten only past the next scan's first barrier
  }
  __syncthreads();
  return total;
}

// One block a query of the wave: block b reads row b of the workspace, which
// holds query p0 + b.
template <typename T>
__global__ void __launch_bounds__(kThreads)
select_readout_kernel(const uint32_t* __restrict__ ws, int ld, int n, int p0,
                      int p_total, Segments segs, int o_dim, int cv, int top_k,
                      float* __restrict__ out, float* __restrict__ usage,
                      float* __restrict__ tau_out) {
  __shared__ uint32_t s_max[kThreads];
  __shared__ __align__(16) uint32_t cand_key[kCandCap];
  __shared__ int cand_idx[kCandCap];
  __shared__ int list_idx[kListCap];
  __shared__ float list_w[kListCap];
  __shared__ const T* list_row[kListCap];
  __shared__ uint8_t list_seg[kListCap];
  __shared__ const T* seg_ptr[kMaxSegs];
  __shared__ long long seg_off[kMaxSegs];
  __shared__ long long seg_stride[kMaxSegs];  // elements from one o to the next
  __shared__ RadixShared rsh;
  __shared__ int warp_sums[kWarps];
  __shared__ int s_total;

  const int tid = threadIdx.x;
  const int p = p0 + blockIdx.x;
  const uint32_t* row = ws + (size_t)blockIdx.x * ld;
  const int krem = min(top_k, n);
  if (tid < segs.n) {
    seg_ptr[tid] = static_cast<const T*>(segs.ptr[tid]);
    seg_off[tid] = segs.off[tid];
    seg_stride[tid] = segs.cap[tid] * cv;
  }

  // a. pivot <= tau: the krem-th largest of the threads' maxima (a thread
  // without keys has 0, below every key; past 256 the pivot is 0)
  uint32_t mx = 0u;
  for (int b = 4 * tid; b < n; b += 16 * kThreads) {  // 4 loads in flight
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (b + 4 * u * kThreads < n)
        v[u] = *reinterpret_cast<const uint4*>(row + b + 4 * u * kThreads);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = b + 4 * u * kThreads;
      if (e < n) mx = max(mx, v[u].x);
      if (e + 1 < n) mx = max(mx, v[u].y);
      if (e + 2 < n) mx = max(mx, v[u].z);
      if (e + 3 < n) mx = max(mx, v[u].w);
    }
  }
  s_max[tid] = mx;
  const uint32_t pivot =
      krem <= kThreads ? radix_select(s_max, kThreads, krem, rsh) : 0u;

  // b. candidates in token order, and tau among them
  const int n_cand = ordered_filter(
      row, n, [&](uint32_t key) { return key >= pivot; },
      [&](int slot, int i, uint32_t key) {
        if (slot < kCandCap) {
          cand_key[slot] = key;
          cand_idx[slot] = i;
        }
      },
      warp_sums, &s_total);
  const bool in_cand = n_cand <= kCandCap;
  const uint32_t tau = in_cand ? radix_select(cand_key, n_cand, krem, rsh)
                               : radix_select(row, n, krem, rsh);
  if (tid == 0) tau_out[p] = invert_order_key(tau);

  // c. kept tokens in token order: weight, value row, segment
  auto is_kept = [&](uint32_t key) { return kept(key, tau); };
  auto emit_kept = [&](int slot, int i, uint32_t key) {
    if (slot >= kListCap) return;
    int s = 0;
    while (s + 1 < segs.n && i >= seg_off[s + 1]) ++s;
    list_idx[slot] = i;
    list_w[slot] = expf(invert_order_key(key));
    list_seg[slot] = (uint8_t)s;
    list_row[slot] = seg_ptr[s] + (size_t)(i - seg_off[s]) * cv;
  };
  const int count =
      in_cand ? ordered_filter(
                    cand_key, n_cand, is_kept,
                    [&](int slot, int j, uint32_t key) {
                      emit_kept(slot, cand_idx[j], key);
                    },
                    warp_sums, &s_total)
              : ordered_filter(row, n, is_kept, emit_kept, warp_sums, &s_total);

  const int ocv = o_dim * cv;
  float z = 0.f;
  if (count <= kListCap) {
    for (int j = 0; j < count; ++j) z += list_w[j];
    const float zsafe = fmaxf(z, 1e-30f);
    // each column sums its kept tokens in token order
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
        const T* r = list_row[j];
        const long long stride = seg_stride[list_seg[j]];
        float v[kCols];
#pragma unroll
        for (int u = 0; u < kCols; ++u) v[u] = load_value(r + o[u] * stride + c[u]);
#pragma unroll
        for (int u = 0; u < kCols; ++u) acc[u] = fmaf(w, v[u], acc[u]);
      }
#pragma unroll
      for (int u = 0; u < kCols; ++u)
        if (col0 + u * kThreads < ocv)
          out[((size_t)o[u] * p_total + p) * cv + c[u]] = acc[u] / zsafe;
    }
    // d. usage
    for (int j = tid; j < count; j += kThreads)
      atomicAdd(&usage[list_idx[j]], list_w[j] / zsafe);
    return;
  }
  // more kept tokens than the list holds: the same sums straight over the row
  for (int i = 0; i < n; ++i)
    if (kept(row[i], tau)) z += expf(invert_order_key(row[i]));
  const float zsafe = fmaxf(z, 1e-30f);
  for (int col = tid; col < ocv; col += kThreads) {
    const int o = col / cv, c = col - o * cv;
    float acc = 0.f;
    int s = 0;
    for (int i = 0; i < n; ++i) {
      const uint32_t key = row[i];
      if (!kept(key, tau)) continue;
      while (s + 1 < segs.n && i >= seg_off[s + 1]) ++s;
      acc = fmaf(expf(invert_order_key(key)),
                 load_value(seg_ptr[s] + (i - seg_off[s]) * cv + o * seg_stride[s] + c),
                 acc);
    }
    out[((size_t)o * p_total + p) * cv + c] = acc / zsafe;
  }
  for (int i = tid; i < n; i += kThreads)
    if (kept(row[i], tau))
      atomicAdd(&usage[i], expf(invert_order_key(row[i])) / zsafe);
}

template <typename T>
int launch_select(const uint32_t* ws, int ld, int n, int p, int p0, int p_count,
                  Segments segs, int o, int cv, int top_k, float* out,
                  float* usage, float* tau, cudaStream_t stream) {
  select_readout_kernel<T><<<p_count, kThreads, 0, stream>>>(
      ws, ld, n, p0, p, segs, o, cv, top_k, out, usage, tau);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Resident blocks per SM of each stage. Returns a cudaError_t.
int radix_topk_readout_occupancy(int values_bf16, int* sim_blocks,
                                 int* select_blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      similarity_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSimSmemBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      sim_blocks, similarity_kernel, kThreads, kSimSmemBytes);
  if (err != cudaSuccess) return (int)err;
  return values_bf16
             ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   select_blocks, select_readout_kernel<__nv_bfloat16>, kThreads, 0)
             : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   select_blocks, select_readout_kernel<float>, kThreads, 0);
}

// Stage 1 for queries [p0, p0 + p_count): order keys into workspace rows
// [0, p_count) of ld keys (ld >= n, a multiple of 4: 16-byte rows). Device
// pointers; qk and qe 16-byte aligned. Returns a cudaError_t (0 = launched).
int radix_topk_readout_similarity_launch(const void* mk, const void* ms,
                                         const void* valid, const void* qk,
                                         const void* qe, int n, int ck, int p0,
                                         int p_count, int ld, void* workspace,
                                         void* stream) {
  if (ld < n || ld % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      similarity_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSimSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return (int)err;
  const int k_tiles = (n + kKTile - 1) / kKTile;
  const int q_tiles = (p_count + kQTile - 1) / kQTile;
  // runs of tiles long enough to use the ring, short enough to leave about
  // four rounds of two blocks an SM
  const int per_block =
      max(1, min(kMaxTilesPerRun, k_tiles * q_tiles / (8 * sms)));
  const dim3 grid((k_tiles + per_block - 1) / per_block, q_tiles);
  similarity_kernel<<<grid, kThreads, kSimSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mk), static_cast<const float*>(ms),
      static_cast<const uint8_t*>(valid), static_cast<const float*>(qk),
      static_cast<const float*>(qe), n, ck, p0, p_count, per_block, ld,
      static_cast<uint32_t*>(workspace));
  return (int)cudaGetLastError();
}

// Stage 2 for queries [p0, p0 + p_count) of p, from the workspace (rows of
// ld keys) stage 1 filled. out is [o, p, cv] fp32, usage [n] fp32 (zeroed by the caller), tau
// [p] fp32; value segment s is [o, cap_s, cv] at v_s, holding keys [off_s,
// off_s + cap_s). Returns a cudaError_t (0 = launched).
int radix_topk_readout_select_launch(const void* workspace, int ld,
                                     const void* v0,
                                     const void* v1, const void* v2,
                                     long long off0, long long off1,
                                     long long off2, long long cap0,
                                     long long cap1, long long cap2, int n_segs,
                                     int n, int p, int p0, int p_count, int o,
                                     int cv, int top_k, int values_bf16,
                                     void* out, void* usage, void* tau,
                                     void* stream) {
  Segments segs;
  segs.ptr[0] = v0; segs.ptr[1] = v1; segs.ptr[2] = v2;
  segs.off[0] = off0; segs.off[1] = off1; segs.off[2] = off2;
  segs.cap[0] = cap0; segs.cap[1] = cap1; segs.cap[2] = cap2;
  segs.n = n_segs;
  if (ld < n || ld % 4 != 0) return (int)cudaErrorInvalidValue;
  const uint32_t* ws = static_cast<const uint32_t*>(workspace);
  float* f_out = static_cast<float*>(out);
  float* f_usage = static_cast<float*>(usage);
  float* f_tau = static_cast<float*>(tau);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (values_bf16)
    return launch_select<__nv_bfloat16>(ws, ld, n, p, p0, p_count, segs, o, cv,
                                        top_k, f_out, f_usage, f_tau, s);
  return launch_select<float>(ws, ld, n, p, p0, p_count, segs, o, cv, top_k,
                              f_out, f_usage, f_tau, s);
}

}  // extern "C"
