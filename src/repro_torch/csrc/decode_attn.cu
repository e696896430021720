// GQA decode attention against a KV cache (flash-decode), for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/decode_attn/decode_attn.py,
// `decode_attn_pallas` (`_kernel`): one query token of H heads against caches
// (B, S, KV, Dh), heads grouped KV-major (G = H / KV query heads share a KV
// head), cache row t seen when t <= pos and, with a window, t > pos - window;
// softmax with scale 1/sqrt(Dh) in float32; the output in q's dtype.
//
// What bounds it on this card: bytes. Every cache row it attends to is read
// once (K and V), for all G heads of its group; everything else is small. At
// gemma3-1b's decode shape (B=8, KV=1, Dh=256, bf16, ~1000 rows) a global
// layer moves about 8.5 MB: a few microseconds of memory time, so at B=8 the
// kernel is as much launch- and latency-bound as bandwidth-bound.
//
// Design. The TPU grid walks S in order inside one program per (b, kv head),
// 8 programs at gemma3's B=8, KV=1; 8 blocks would leave 124 of the 132 SMs
// idle. So the rows a position attends to, [lo, hi] (computed by the caller
// from pos and the window; blocks of the cache wholly outside are never
// visited, so a local layer reads `window` rows, not S), are split over
// `nsplit` blocks per (b, kv head):
//   * decode_attn_split_kernel: the caller aims at about four blocks an SM;
//     a block loads tiles of 32 rows of K and V
//     into shared memory (16-byte loads), one warp per row computes the G
//     scores (a lane per slice of Dh, shuffle sums), one warp per head keeps
//     the running (max m, sum l) with a lane per row, and the block updates
//     acc[g][:] = acc * exp(m_old - m_new) + p V. It writes its partial
//     (m, l, acc) in float32.
//   * decode_attn_combine_kernel: one block per (b, kv head, head), a
//     thread per channel, folds the partials in split order — out = sum_s
//     acc_s e^(m_s - M) / sum_s l_s e^(m_s - M) — and rounds once to q's
//     dtype.
// No atomics: the result is the same bits run to run. Every split holds at
// least one row by construction; a partial with m = -inf (which only a
// changed caller could produce) still adds nothing, as the reference's
// `m_safe`/`corr` guard does. A ragged S needs no padded copy: rows past hi
// are never read.
//
// Limits (checked by the launcher and the Python wrapper): Dh a multiple of
// 8 up to 256, G * Dh <= 4096, q bf16 or float32, caches bf16 or float32,
// 16-byte aligned.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// stream it is given, does not synchronise, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // cache rows per tile: one lane per row in the softmax
constexpr int kMaxDh = 256;
constexpr int kMaxGDh = 4096;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Floats of shared memory in front of the K/V tiles, rounded up to 16 bytes.
__host__ __device__ __forceinline__ int head_floats(int g, int dh) {
  return (2 * g * dh + g * kTile + 3 * g + 3) & ~3;
}

template <typename TQ, typename TC>
__global__ void __launch_bounds__(kThreads)
decode_attn_split_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                         const TC* __restrict__ vc, float* __restrict__ part_m,
                         float* __restrict__ part_l, float* __restrict__ part_acc,
                         int S, int KV, int G, int Dh, int lo, int hi,
                         int rows_per_split, float scale) {
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int bk = blockIdx.y;  // b * KV + kv head
  const int b = bk / KV, kvh = bk - (bk / KV) * KV;
  const int t_begin = lo + split * rows_per_split;
  const int t_end = min(hi + 1, t_begin + rows_per_split);  // exclusive
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gd = G * Dh;

  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  float* q_s = smem;               // (G, Dh) query heads of the group
  float* acc_s = q_s + gd;         // (G, Dh) running sum of p V
  float* p_s = acc_s + gd;         // (G, kTile) scores, then probabilities
  float* m_s = p_s + G * kTile;    // (G) running max
  float* l_s = m_s + G;            // (G) running sum of p
  float* corr_s = l_s + G;         // (G) rescale of this tile
  TC* k_s = reinterpret_cast<TC*>(smem + head_floats(G, Dh));  // (kTile, Dh)
  TC* v_s = k_s + kTile * Dh;                                  // (kTile, Dh)

  // q (B, H, Dh): the group's heads are kvh*G .. kvh*G + G - 1
  const TQ* qg = q + static_cast<size_t>(bk) * gd;
  for (int i = tid; i < gd; i += kThreads) {
    q_s[i] = to_f32(qg[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  constexpr int kVec = 16 / sizeof(TC);  // elements per 16-byte load
  const int vec_per_row = Dh / kVec;
  const size_t row_stride = static_cast<size_t>(KV) * Dh;  // t -> t + 1
  const TC* kbase = kc + (static_cast<size_t>(b) * S * KV + kvh) * Dh;
  const TC* vbase = vc + (static_cast<size_t>(b) * S * KV + kvh) * Dh;

  for (int t0 = t_begin; t0 < t_end; t0 += kTile) {
    const int rows = min(kTile, t_end - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < rows * vec_per_row; i += kThreads) {
      const int r = i / vec_per_row, c = i - r * vec_per_row;
      const size_t off = static_cast<size_t>(t0 + r) * row_stride;
      reinterpret_cast<uint4*>(k_s + r * Dh)[c] =
          __ldg(reinterpret_cast<const uint4*>(kbase + off) + c);
      reinterpret_cast<uint4*>(v_s + r * Dh)[c] =
          __ldg(reinterpret_cast<const uint4*>(vbase + off) + c);
    }
    __syncthreads();

    // scores: a warp per row, a lane per slice of Dh, all G heads
    for (int r = warp; r < kTile; r += kWarps) {
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
        if (r < rows)
          for (int d = lane; d < Dh; d += 32)
            s = fmaf(q_s[g * Dh + d], to_f32(k_s[r * Dh + d]), s);
        s = warp_sum(s);
        if (lane == 0) p_s[g * kTile + r] = r < rows ? s * scale : -INFINITY;
      }
    }
    __syncthreads();

    // running softmax: a warp per head, a lane per row
    for (int g = warp; g < G; g += kWarps) {
      const float s = p_s[g * kTile + lane];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float p = lane < rows ? expf(s - m_safe) : 0.f;
      const float p_sum = warp_sum(p);
      p_s[g * kTile + lane] = p;
      if (lane == 0) {
        const float corr = isfinite(m_old) ? expf(m_old - m_safe) : 0.f;
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + p_sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc <- acc * corr + p V
    for (int i = tid; i < gd; i += kThreads) {
      const int g = i / Dh, d = i - g * Dh;
      float a = acc_s[i] * corr_s[g];
      for (int r = 0; r < rows; ++r)
        a = fmaf(p_s[g * kTile + r], to_f32(v_s[r * Dh + d]), a);
      acc_s[i] = a;
    }
  }
  __syncthreads();

  const size_t pbase = (static_cast<size_t>(bk) * nsplit + split) * G;
  for (int i = tid; i < gd; i += kThreads) part_acc[pbase * Dh + i] = acc_s[i];
  for (int g = tid; g < G; g += kThreads) {
    part_m[pbase + g] = m_s[g];
    part_l[pbase + g] = l_s[g];
  }
}

// One block per (b, kv head, head g), a thread per channel: warp 0 finds the
// largest m over the splits and the weights w_s = e^(m_s - M) and L = sum_s
// l_s w_s (lanes over splits, a fixed xor tree: the same order every run),
// kept in shared memory; then each thread folds its channel's partial sums
// in split order.
template <typename TQ>
__global__ void decode_attn_combine_kernel(const float* __restrict__ part_m,
                                           const float* __restrict__ part_l,
                                           const float* __restrict__ part_acc,
                                           TQ* __restrict__ out, int G, int Dh,
                                           int nsplit) {
  const int bk = blockIdx.x, g = blockIdx.y;
  const int lane = threadIdx.x & 31;
  extern __shared__ float w_s[];  // (nsplit) weights, then L
  const size_t base = static_cast<size_t>(bk) * nsplit * G + g;  // + s * G
  if (threadIdx.x < 32) {
    float m_all = -INFINITY;
    for (int s = lane; s < nsplit; s += 32) m_all = fmaxf(m_all, part_m[base + s * G]);
    m_all = warp_max(m_all);
    const float m_safe = isfinite(m_all) ? m_all : 0.f;
    float l_all = 0.f;
    for (int s = lane; s < nsplit; s += 32) {
      const float m = part_m[base + s * G];
      const float w = isfinite(m) ? expf(m - m_safe) : 0.f;
      w_s[s] = w;
      l_all = fmaf(part_l[base + s * G], w, l_all);
    }
    l_all = warp_sum(l_all);
    if (lane == 0) w_s[nsplit] = fmaxf(l_all, 1e-30f);
  }
  __syncthreads();
  const float l_all = w_s[nsplit];
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s)
      acc = fmaf(part_acc[(base + s * G) * Dh + d], w_s[s], acc);
    out[(static_cast<size_t>(bk) * G + g) * Dh + d] = from_f32<TQ>(acc / l_all);
  }
}

template <typename TQ, typename TC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* part_m, float* part_l, float* part_acc, int B, int S,
                   int KV, int G, int Dh, int lo, int hi, int rows_per_split,
                   int nsplit, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * head_floats(G, Dh) +
                      2 * sizeof(TC) * static_cast<size_t>(kTile) * Dh;
  auto split_kernel = decode_attn_split_kernel<TQ, TC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  split_kernel<<<dim3(nsplit, B * KV), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(k), static_cast<const TC*>(v),
      part_m, part_l, part_acc, S, KV, G, Dh, lo, hi, rows_per_split, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int combine_threads = (Dh + 31) / 32 * 32;
  decode_attn_combine_kernel<TQ><<<dim3(B * KV, G), combine_threads,
                                   sizeof(float) * (nsplit + 1), stream>>>(
      part_m, part_l, part_acc, static_cast<TQ*>(out), G, Dh, nsplit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, KV*G, Dh), caches (B, S, KV, Dh), out (B, KV*G, Dh) in q's dtype;
// scratch part_m, part_l (B*KV, nsplit, G) and part_acc (B*KV, nsplit, G, Dh)
// float32. Rows lo..hi (inclusive, 0 <= lo <= hi < S) are attended to, split
// into nsplit runs of rows_per_split (the last may be shorter; none empty).
// q_bf16 / c_bf16: 1 for bfloat16, 0 for float32.
int decode_attn_launch(const void* q, const void* k, const void* v, void* out,
                       float* part_m, float* part_l, float* part_acc, int B,
                       int S, int KV, int G, int Dh, int lo, int hi,
                       int rows_per_split, int nsplit, int q_bf16, int c_bf16,
                       float scale, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || G < 1 || Dh < 8 || Dh % 8 != 0 ||
      Dh > kMaxDh || G * Dh > kMaxGDh || lo < 0 || hi < lo || hi >= S ||
      rows_per_split < 1 || nsplit < 1 || B * KV > 65535 ||
      static_cast<long long>(nsplit - 1) * rows_per_split > hi - lo ||
      static_cast<long long>(nsplit) * rows_per_split < hi - lo + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_bf16 && c_bf16)
    e = launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, part_m, part_l, part_acc, B, S,
                                             KV, G, Dh, lo, hi, rows_per_split, nsplit, scale, st);
  else if (q_bf16)
    e = launch<__nv_bfloat16, float>(q, k, v, out, part_m, part_l, part_acc, B, S, KV, G,
                                     Dh, lo, hi, rows_per_split, nsplit, scale, st);
  else if (c_bf16)
    e = launch<float, __nv_bfloat16>(q, k, v, out, part_m, part_l, part_acc, B, S, KV, G,
                                     Dh, lo, hi, rows_per_split, nsplit, scale, st);
  else
    e = launch<float, float>(q, k, v, out, part_m, part_l, part_acc, B, S, KV, G, Dh, lo,
                             hi, rows_per_split, nsplit, scale, st);
  return static_cast<int>(e);
}

const char* decode_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
