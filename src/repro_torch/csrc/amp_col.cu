// Column-layout (C-MP-AMP) local computation, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/amp_fused/col.py:
//   * `col_residual_pallas` (`_col_r_kernel`)   ->  col_rows_ring_kernel<UPDATE=false>
//         r[b,p,m] = sum_n A[b,p,m,n] x[b,p,n]      (col_rows_kernel without a ring)
//   * `col_inner_pallas` (`_col_inner_kernel`)  ->  three launches on one stream
//         col_f_partial_kernel   partial sums over chunks of M rows of
//                                f[b,p,n] = sum_m A[b,p,m,n] z[b,p,m] and of ||z[b,p]||^2
//         col_denoise_kernel     f = x + sum of the partials, s2 = max(||z||^2/m_eff, 1e-30),
//                                (x', eta') = Bernoulli-Gauss conditional mean and its
//                                derivative, masked; c[b,p] = sum(eta' mask) / m_eff
//         col_rows_ring_kernel<UPDATE=true>   (only when update_z; col_rows_kernel
//                                without a ring)
//                                z'[b,p,m] = g[b,m] - sum_n A[b,p,m,n] (x'-x0)[b,p,n] + c[b,p] z[b,p,m]
//
// What bounds it on this card: bytes. Every pass is a matrix-vector product
// (2 flops per element of A read), far below the ~20 flop/byte at which
// float32 arithmetic would limit an H100, so the least time is |A| / memory
// rate per pass: one pass for the residual, one for stage 0 of an inner
// step, one more when the step updates z. At the paper's column shape
// (P=25, M=3000, Np=400) |A| is 120 MB in float32, more than the 50 MB L2.
//
// What the design does about it:
//   * The row passes stream A_p through the streamer of amp_common.cuh that
//     the row layout's band kernel uses: one block per (b, p, band of rows;
//     bands planned in col.py::col_band_plan, about two blocks an SM), a
//     ring of stages of whole rows (~16 KB a stage, ~80 KB in all) in
//     shared memory, filled by a producer warp with TMA bulk copies, one
//     full and one empty mbarrier per slot. x_p (or x' - x0) is staged in
//     shared memory once per block. Each of 8 consumer warps takes rows of a
//     stage and forms a row's dot product from shared memory (lanes stride
//     along Np, 16 bytes a lane, amp_common.cuh's warp_row_dot, the same
//     order as before), then frees the slot. Rows of a few hundred floats
//     thus keep ~64 KB in flight per block instead of three loads a lane.
//   * Rows the ring does not take (Np * sizeof A not a multiple of 16, or
//     more than 16 KB: col.py::col_stage_rows) keep one warp a row reading
//     device memory (col_rows_kernel).
//   * The A^T z pass is the one that underfilled the card in the row layout
//     (one thread per column walking every row: at P=25, Np=400 that is 25
//     blocks' worth of columns). Here the M rows are split into chunks over
//     blocks, sized so that the grid has about eight blocks per SM; each
//     block writes its partial f and partial ||z||^2, and a second small
//     kernel, one block per (b, p), adds them in a fixed order. No float
//     atomics anywhere: the outputs, c included, are the same bits run to run.
//   * The denoiser runs in float32 in that second kernel, the closed form of
//     src/repro_torch/core/denoisers.py::eta_bg_and_deriv with its stable
//     sigmoid; logit(eps) comes from the host in double and is rounded once.
//   * A may be stored in bfloat16 (half the bytes); it is widened in
//     registers and every sum is float32.
//   * Ragged edges are masked here, so no padded copy of A is ever made;
//     the batch is a grid axis and a shared A is a batch stride of 0.
//
// Plain C interface, loaded with ctypes. The entry points launch on the
// stream they are given, do not synchronise, allocate nothing (the caller
// passes the scratch) and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "amp_common.cuh"

namespace {

using amp::load_a;
using amp::Width;

constexpr int kMaxWarps = 32;     // warps of a row-pass block, at most
constexpr int kRingWarps = 8;     // consumer warps of a ring block
constexpr int kRingThreads = (kRingWarps + 1) * 32;   // and one producer warp
constexpr int kColMaxStages = 16;
constexpr int kColRingBytes = 80 * 1024;  // two blocks an SM
constexpr int kColStageBytes = 16 * 1024; // the stage's rows, at most (col_stage_rows)
constexpr int kColHeader = 2 * kColMaxStages * 8;
constexpr int kFThreads = 128;    // threads of an A^T z block (a power of two)
constexpr int kStage = 1024;      // rows of z staged in shared memory at a time
constexpr int kDThreads = 256;    // threads of a denoise block (a power of two)
constexpr float kTwoPi = 6.283185307179586f;

// ---- row passes: one warp per row (b, p, m) ---------------------------------
// grid (ceil(m / warps), P, B), block warps*32. x, x0 (B, P, np); out, z
// (B, P, m); g (B, m); c (B, P).
template <typename TA, bool VEC, bool UPDATE>
__global__ void col_rows_kernel(const TA* __restrict__ a, long long a_bstride,
                                const float* __restrict__ x,
                                const float* __restrict__ x0,
                                const float* __restrict__ g,
                                const float* __restrict__ z,
                                const float* __restrict__ c,
                                float* __restrict__ out, int m, int np) {
  constexpr int V = Width<TA, VEC>::value;
  const int b = blockIdx.z;
  const int p = blockIdx.y;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= m) return;  // whole warps leave; nothing below synchronises
  const long long bp = static_cast<long long>(b) * gridDim.y + p;
  const TA* arow = a + static_cast<long long>(b) * a_bstride +
                   (static_cast<long long>(p) * m + row) * np;
  float acc;
  if constexpr (UPDATE)
    acc = amp::warp_row_dot<TA, V>(arow, amp::VecDiff{x + bp * np, x0 + bp * np},
                                   np, lane);
  else
    acc = amp::warp_row_dot<TA, V>(arow, amp::VecX{x + bp * np}, np, lane);
  if (lane == 0) {
    const long long idx = bp * m + row;
    if constexpr (UPDATE)
      out[idx] = (g[static_cast<long long>(b) * m + row] - acc) + c[bp] * z[idx];
    else
      out[idx] = acc;
  }
}

// ---- row passes through the ring: one block per (band, p, b) ----------------
// grid (n_bands, P, B), block kRingThreads. Warps 0..kRingWarps-1 consume,
// the last warp's lane 0 produces. A stage is stage_rows whole rows of the
// band, one bulk copy.
template <typename TA, bool UPDATE>
__global__ void __launch_bounds__(kRingThreads)
    col_rows_ring_kernel(const TA* __restrict__ a, long long a_bstride,
                         const float* __restrict__ x,
                         const float* __restrict__ x0,
                         const float* __restrict__ g,
                         const float* __restrict__ z,
                         const float* __restrict__ c, float* __restrict__ out,
                         int m, int np, int band_rows, int stage_rows,
                         int stages) {
  constexpr int V = Width<TA, true>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kColMaxStages;
  float* xs = reinterpret_cast<float*>(smem + kColHeader);
  TA* ring = reinterpret_cast<TA*>(xs + ((np + 31) & ~31));  // 128-byte aligned

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = blockIdx.y, b = blockIdx.z;
  const long long bp = static_cast<long long>(b) * gridDim.y + p;
  const int r0 = blockIdx.x * band_rows;
  const int nrows = min(band_rows, m - r0);  // >= 1: no band is empty
  const int n_stage = (nrows + stage_rows - 1) / stage_rows;
  const long long stage_elems = static_cast<long long>(stage_rows) * np;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      amp::mbar_init(&full[i], 1);
      amp::mbar_init(&empty[i], kRingWarps);
    }
    amp::fence_mbar_init();
  }
  __syncthreads();

  if (warp == kRingWarps) {  // the producer
    if (lane == 0) {
      const TA* src = a + b * a_bstride + (static_cast<long long>(p) * m + r0) * np;
      for (int k = 0; k < n_stage; ++k) {
        const int slot = k % stages;
        if (k >= stages) {  // the consumers have freed the slot's last use
          amp::mbar_wait(&empty[slot], ((k / stages) - 1) & 1);
          amp::fence_proxy_async();
        }
        const int nr = min(stage_rows, nrows - k * stage_rows);
        const uint32_t bytes = static_cast<uint32_t>(nr) * np * sizeof(TA);
        amp::mbar_expect_tx(&full[slot], bytes);
        amp::bulk_load(ring + slot * stage_elems, src + k * stage_elems, bytes,
                       &full[slot]);
      }
    }
    return;
  }

  // the vector of the dot products, once per block (np % 4 == 0 here)
  for (int i = tid * 4; i < np; i += kRingWarps * 32 * 4) {
    float4 v = *reinterpret_cast<const float4*>(x + bp * np + i);
    if constexpr (UPDATE) {
      const float4 v0 = *reinterpret_cast<const float4*>(x0 + bp * np + i);
      v = make_float4(v.x - v0.x, v.y - v0.y, v.z - v0.z, v.w - v0.w);
    }
    *reinterpret_cast<float4*>(xs + i) = v;
  }
  amp::named_sync(1, kRingWarps * 32);

  for (int k = 0; k < n_stage; ++k) {
    const int slot = k % stages;
    amp::mbar_wait(&full[slot], (k / stages) & 1);
    const int nr = min(stage_rows, nrows - k * stage_rows);
    const TA* st = ring + slot * stage_elems;
    for (int r = warp; r < nr; r += kRingWarps) {
      const float acc = amp::warp_row_dot<TA, V, true>(
          st + static_cast<long long>(r) * np, amp::VecX{xs}, np, lane);
      if (lane == 0) {
        const int row = r0 + k * stage_rows + r;
        const long long idx = bp * m + row;
        if constexpr (UPDATE)
          out[idx] = (g[static_cast<long long>(b) * m + row] - acc) + c[bp] * z[idx];
        else
          out[idx] = acc;
      }
    }
    __syncwarp();
    if (lane == 0) amp::mbar_arrive(&empty[slot]);
  }
}

// ---- stage 0 of an inner step: partial A^T z and ||z||^2 over row chunks ----
// grid (ceil(np / (kFThreads*V)), n_chunks, B*P), block kFThreads.
// fpart (B*P, n_chunks, np); sspart (B*P, n_chunks), written by the blocks of
// the first column tile.
template <typename TA, bool VEC>
__global__ void col_f_partial_kernel(const TA* __restrict__ a, long long a_bstride,
                                     const float* __restrict__ z,
                                     float* __restrict__ fpart,
                                     float* __restrict__ sspart,
                                     int n_proc, int m, int np, int chunk) {
  constexpr int V = Width<TA, VEC>::value;
  __shared__ float zs[kStage];
  __shared__ float red[kFThreads];
  const int tid = threadIdx.x;
  const long long bp = blockIdx.z;
  const long long b = bp / n_proc;
  const int p = static_cast<int>(bp % n_proc);
  const int ck = blockIdx.y;
  const int m0 = ck * chunk;
  const int cnt = min(chunk, m - m0);
  const int col = (blockIdx.x * kFThreads + tid) * V;
  const bool live = col < np;  // VEC implies np % V == 0
  const bool first_tile = blockIdx.x == 0;
  const TA* arow = a + b * a_bstride + (static_cast<long long>(p) * m + m0) * np + col;
  const float* zp = z + bp * m + m0;

  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  float sq = 0.f;
  for (int s0 = 0; s0 < cnt; s0 += kStage) {
    const int ns = min(kStage, cnt - s0);
    __syncthreads();  // the previous stage has been used up
    for (int i = tid; i < ns; i += kFThreads) {
      const float v = zp[s0 + i];
      zs[i] = v;
      if (first_tile) sq = fmaf(v, v, sq);
    }
    __syncthreads();
    if (live) {
#pragma unroll 8
      for (int r = 0; r < ns; ++r) {
        float av[V];
        load_a<TA, V>(arow, av);
        const float zv = zs[r];
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = fmaf(av[k], zv, acc[k]);
        arow += np;
      }
    }
  }
  const long long slot = bp * gridDim.y + ck;
  if (live) {
    float* fo = fpart + slot * np + col;
#pragma unroll
    for (int k = 0; k < V; ++k) fo[k] = acc[k];
  }
  if (first_tile) {  // the same for the whole block: no divergent barrier
    red[tid] = sq;
    __syncthreads();
    for (int st = kFThreads / 2; st > 0; st >>= 1) {
      if (tid < st) red[tid] += red[tid + st];
      __syncthreads();
    }
    if (tid == 0) sspart[slot] = red[0];
  }
}

// ---- the rest of stage 0: fixed-order sums, denoise, c -----------------------
// grid (B*P), block kDThreads. x, x_out (B*P, np); mask (np,) or null;
// c_out (B*P).
__global__ void col_denoise_kernel(const float* __restrict__ fpart,
                                   const float* __restrict__ sspart,
                                   const float* __restrict__ x,
                                   const float* __restrict__ mask,
                                   float* __restrict__ x_out,
                                   float* __restrict__ c_out, int np,
                                   int n_chunks, float m_eff, float logit_eps,
                                   float mu, float sigma_s2) {
  __shared__ float red[kDThreads];
  __shared__ float ss_sh;
  const int tid = threadIdx.x;
  const long long bp = blockIdx.x;
  const float* fp = fpart + bp * n_chunks * np;
  if (tid == 0) {
    float ss = 0.f;
    for (int k = 0; k < n_chunks; ++k) ss += sspart[bp * n_chunks + k];
    ss_sh = ss;
  }
  __syncthreads();
  const float s2 = fmaxf(ss_sh / m_eff, 1e-30f);
  const float v1 = sigma_s2 + s2;
  const float log_n1 = 0.5f * logf(kTwoPi * v1);
  const float log_n0 = 0.5f * logf(kTwoPi * s2);
  float dsum = 0.f;
  for (int col = tid; col < np; col += kDThreads) {
    float acc = 0.f;
    for (int k = 0; k < n_chunks; ++k) acc += fp[static_cast<long long>(k) * np + col];
    const float f = x[bp * np + col] + acc;
    const float d1 = f - mu;
    const float log_g1 = -0.5f * (d1 * d1 / v1) - log_n1;
    const float log_g0 = -0.5f * (f * f / s2) - log_n0;
    const float lo = logit_eps + log_g1 - log_g0;
    const float e = expf(-fabsf(lo));
    const float pi = lo >= 0.f ? 1.f / (1.f + e) : e / (1.f + e);
    const float cm = (mu * s2 + f * sigma_s2) / v1;
    const float d_lo = f / s2 - d1 / v1;
    const float deriv = pi * (1.f - pi) * d_lo * cm + pi * (sigma_s2 / v1);
    const float mk = mask ? mask[col] : 1.f;
    x_out[bp * np + col] = pi * cm * mk;
    dsum += deriv * mk;
  }
  red[tid] = dsum;
  __syncthreads();
  for (int st = kDThreads / 2; st > 0; st >>= 1) {
    if (tid < st) red[tid] += red[tid + st];
    __syncthreads();
  }
  if (tid == 0) c_out[bp] = red[0] / m_eff;
}

// How the ring splits the rows: bands of band_rows rows (the last ragged,
// none empty) and stages of stage_rows rows; stage_rows = 0: no ring.
struct RingPlan {
  int band_rows, n_bands, stage_rows;
};

bool bad_plan(const RingPlan& plan, int m) {
  if (plan.stage_rows == 0) return false;
  return plan.stage_rows < 0 || plan.band_rows < 1 || plan.n_bands < 1 ||
         static_cast<long long>(plan.n_bands - 1) * plan.band_rows >= m ||
         static_cast<long long>(plan.n_bands) * plan.band_rows < m;
}

template <typename TA, bool VEC, bool UPDATE>
cudaError_t launch_rows(const void* a, long long a_bstride, const float* x,
                        const float* x0, const float* g, const float* z,
                        const float* c, float* out, int batch, int n_proc,
                        int m, int np, int warps, cudaStream_t s) {
  const dim3 grid((m + warps - 1) / warps, n_proc, batch);
  col_rows_kernel<TA, VEC, UPDATE><<<grid, warps * 32, 0, s>>>(
      static_cast<const TA*>(a), a_bstride, x, x0, g, z, c, out, m, np);
  return cudaGetLastError();
}

// The ring: stage_rows rows a stage, as many stages as kColRingBytes holds.
template <typename TA, bool UPDATE>
cudaError_t launch_rows_ring(const void* a, long long a_bstride, const float* x,
                             const float* x0, const float* g, const float* z,
                             const float* c, float* out, int batch, int n_proc,
                             int m, int np, const RingPlan& plan, cudaStream_t s) {
  const size_t stage_bytes = static_cast<size_t>(plan.stage_rows) * np * sizeof(TA);
  if (stage_bytes > kColStageBytes) return cudaErrorInvalidValue;
  const int stages = static_cast<int>(
      stage_bytes * kColMaxStages <= kColRingBytes ? kColMaxStages
                                                   : kColRingBytes / stage_bytes);
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t smem = kColHeader + ((np + 31) & ~31) * sizeof(float) +
                      stages * stage_bytes;
  auto kernel = col_rows_ring_kernel<TA, UPDATE>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<dim3(plan.n_bands, n_proc, batch), kRingThreads, smem, s>>>(
      static_cast<const TA*>(a), a_bstride, x, x0, g, z, c, out, m, np,
      plan.band_rows, plan.stage_rows, stages);
  return cudaGetLastError();
}

template <bool UPDATE>
cudaError_t dispatch_rows(const void* a, int a_bf16, long long a_bstride,
                          const float* x, const float* x0, const float* g,
                          const float* z, const float* c, float* out, int batch,
                          int n_proc, int m, int np, int warps, int vec,
                          const RingPlan& plan, cudaStream_t s) {
  if (plan.stage_rows > 0)  // the ring (the caller's vec rule holds)
    return a_bf16 ? launch_rows_ring<__nv_bfloat16, UPDATE>(a, a_bstride, x, x0, g, z, c, out, batch, n_proc, m, np, plan, s)
                  : launch_rows_ring<float, UPDATE>(a, a_bstride, x, x0, g, z, c, out, batch, n_proc, m, np, plan, s);
  if (a_bf16)
    return vec ? launch_rows<__nv_bfloat16, true, UPDATE>(a, a_bstride, x, x0, g, z, c, out, batch, n_proc, m, np, warps, s)
               : launch_rows<__nv_bfloat16, false, UPDATE>(a, a_bstride, x, x0, g, z, c, out, batch, n_proc, m, np, warps, s);
  return vec ? launch_rows<float, true, UPDATE>(a, a_bstride, x, x0, g, z, c, out, batch, n_proc, m, np, warps, s)
             : launch_rows<float, false, UPDATE>(a, a_bstride, x, x0, g, z, c, out, batch, n_proc, m, np, warps, s);
}

template <typename TA, bool VEC>
cudaError_t launch_f_partial(const void* a, long long a_bstride, const float* z,
                             float* fpart, float* sspart, int batch, int n_proc,
                             int m, int np, int chunk, cudaStream_t s) {
  constexpr int V = Width<TA, VEC>::value;
  const int cols = kFThreads * V;
  const dim3 grid((np + cols - 1) / cols, (m + chunk - 1) / chunk, batch * n_proc);
  col_f_partial_kernel<TA, VEC><<<grid, kFThreads, 0, s>>>(
      static_cast<const TA*>(a), a_bstride, z, fpart, sspart, n_proc, m, np, chunk);
  return cudaGetLastError();
}

bool bad_grid(int batch, int n_proc, int m, int np) {
  return batch < 1 || batch > 65535 || n_proc < 1 || n_proc > 65535 ||
         m < 1 || np < 1;
}

}  // namespace

extern "C" {

// r = A_p x_p. a: (B or 1, P, m, np) elements of float32 (a_bf16 = 0) or
// bfloat16 (1), a_bstride elements between batch entries (0 = shared);
// x (B, P, np); r (B, P, m). vec = 1 promises np % (16 / sizeof A) == 0 and
// 16-byte aligned a, x. stage_rows > 0 takes the ring (and needs vec = 1):
// bands of band_rows rows, n_bands of them; else one warp a row, warps rows
// a block.
int col_residual_launch(const void* a, int a_bf16, long long a_bstride,
                        const float* x, float* r, int batch, int n_proc, int m,
                        int np, int warps, int vec, int band_rows, int n_bands,
                        int stage_rows, void* stream) {
  const RingPlan plan{band_rows, n_bands, stage_rows};
  if (bad_grid(batch, n_proc, m, np) || warps < 1 || warps > kMaxWarps ||
      bad_plan(plan, m) || (stage_rows > 0 && !vec))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_rows<false>(
      a, a_bf16, a_bstride, x, nullptr, nullptr, nullptr, nullptr, r, batch,
      n_proc, m, np, warps, vec, plan, static_cast<cudaStream_t>(stream)));
}

// One inner iteration. a as above; x, x0, x_out (B, P, np); z, z_out
// (B, P, m); g (B, m); mask (np,) or null; c_out (B, P). Scratch: fpart
// (B*P, ceil(m / chunk), np), sspart (B*P, ceil(m / chunk)). z_out is
// written only when update_z, by the row pass (ring plan as in
// col_residual_launch). vec = 1 promises np % (16 / sizeof A) == 0 and
// 16-byte aligned a, x_out, x0.
int col_inner_launch(const void* a, int a_bf16, long long a_bstride,
                     const float* x, const float* x0, const float* z,
                     const float* g, const float* mask, float m_eff,
                     float logit_eps, float mu_s, float sigma_s2, float* fpart,
                     float* sspart, float* x_out, float* c_out, float* z_out,
                     int batch, int n_proc, int m, int np, int chunk,
                     int warps, int update_z, int vec, int band_rows,
                     int n_bands, int stage_rows, void* stream) {
  const RingPlan plan{band_rows, n_bands, stage_rows};
  if (bad_grid(batch, n_proc, m, np) || chunk < 1 || warps < 1 ||
      warps > kMaxWarps || static_cast<long long>(batch) * n_proc > 65535 ||
      bad_plan(plan, m) || (stage_rows > 0 && !vec))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (a_bf16)
    e = vec ? launch_f_partial<__nv_bfloat16, true>(a, a_bstride, z, fpart, sspart, batch, n_proc, m, np, chunk, s)
            : launch_f_partial<__nv_bfloat16, false>(a, a_bstride, z, fpart, sspart, batch, n_proc, m, np, chunk, s);
  else
    e = vec ? launch_f_partial<float, true>(a, a_bstride, z, fpart, sspart, batch, n_proc, m, np, chunk, s)
            : launch_f_partial<float, false>(a, a_bstride, z, fpart, sspart, batch, n_proc, m, np, chunk, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_chunks = (m + chunk - 1) / chunk;
  col_denoise_kernel<<<batch * n_proc, kDThreads, 0, s>>>(
      fpart, sspart, x, mask, x_out, c_out, np, n_chunks, m_eff, logit_eps,
      mu_s, sigma_s2);
  e = cudaGetLastError();
  if (e != cudaSuccess || !update_z) return static_cast<int>(e);
  return static_cast<int>(dispatch_rows<true>(
      a, a_bf16, a_bstride, x_out, x0, g, z, c_out, z_out, batch, n_proc, m,
      np, warps, vec, plan, s));
}

const char* amp_col_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
