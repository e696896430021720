// Fused AMP local-computation (LC) step for the row layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel pair of src/repro/kernels/amp_fused/amp_fused.py,
// entry `amp_local_pallas_grid`:
//   * `_z_kernel`  ->  amp_local_z_kernel + amp_local_ss_kernel
//         z'[b,p,m] = y[b,p,m] - sum_n A[b,p,m,n] x[b,n] + onsager[b] z[b,p,m]
//         ss[b]     = sum_{p,m} z'[b,p,m]^2
//   * `_f_kernel`  ->  amp_local_f_kernel
//         f[b,p,n]  = x[b,n] / P + sum_m A[b,p,m,n] z'[b,p,m]
//
// What bounds it on this card: bytes. Both passes are matrix-vector products
// (2 flops per element of A), far below the ~20 flop/byte at which float32
// arithmetic would limit an H100, so the least time for one LC step is
// (2 |A| + small vectors) / memory rate: A is read once by each pass, and at
// the paper's size (120 MB in float32) the second read cannot come from the
// 50 MB L2.
//
// What the design does about it:
//   * A is row-major with N contiguous (loads and the warp's row dot product
//     live in amp_common.cuh, shared with amp_col.cu). The z-pass gives one warp to each
//     output row and lets its lanes stride along N; the f-pass puts its
//     threads along N and walks down the rows of the shard. Either way
//     neighbouring threads read neighbouring addresses, 16 bytes a thread
//     (4 float32 or 8 bfloat16) when N and the base pointers allow it, one
//     element a thread otherwise (the `vec` flag, decided by the caller).
//   * A may be stored in bfloat16 (half the bytes); it is widened in
//     registers and every sum is kept in float32.
//   * The ragged edge is masked here, so no (M, N)-sized padding is ever made.
//   * The TPU kernel sums `ss` across a grid that runs in order. Here blocks
//     run in any order, so each z-pass block writes one partial sum and a
//     second small kernel adds the partials of a batch entry in a fixed
//     order: no float atomics, the same bits from run to run.
//   * The batch is a grid axis; a shared A is a batch stride of 0.
//
// Known weak spots, left for later work: with P = 1 the f-pass has only
// ceil(N / columns-per-block) blocks, each walking all M rows, and
// underfills the card; A is read twice a step; a shared A with B > 1 is read
// B times where a matrix-matrix product would read it once.
//
// Plain C interface, loaded with ctypes. The entry points launch on the
// stream they are given, do not synchronise, allocate nothing and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "amp_common.cuh"

namespace {

using amp::load_a;
using amp::Width;

constexpr int kMaxWarps = 32;      // warps of a z-pass block, at most
constexpr int kFChunk = 1024;      // rows of z' staged in shared memory at a time
constexpr int kSsThreads = 256;    // threads of the second-stage block

// ---- z-pass: one warp per row (b, p*Mp + m) --------------------------------
// grid (ceil(rows / warps), B), block warps*32. partial is (B, gridDim.x).
template <typename TA, bool VEC>
__global__ void amp_local_z_kernel(const TA* __restrict__ a, long long a_bstride,
                                   const float* __restrict__ x,
                                   const float* __restrict__ y,
                                   const float* __restrict__ z,
                                   const float* __restrict__ ons,
                                   float* __restrict__ z_out,
                                   float* __restrict__ partial,
                                   int rows, int n) {
  constexpr int V = Width<TA, VEC>::value;
  __shared__ float sq[kMaxWarps];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int r = blockIdx.x * warps + warp;
  float zsq = 0.f;
  if (r < rows) {  // r is the same for the whole warp
    const TA* arow = a + static_cast<long long>(b) * a_bstride +
                     static_cast<long long>(r) * n;
    const float acc = amp::warp_row_dot<TA, V>(
        arow, amp::VecX{x + static_cast<long long>(b) * n}, n, lane);
    if (lane == 0) {
      const long long idx = static_cast<long long>(b) * rows + r;
      const float zn = (y[idx] - acc) + ons[b] * z[idx];
      z_out[idx] = zn;
      zsq = zn * zn;
    }
  }
  if (lane == 0) sq[warp] = zsq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += sq[w];  // fixed order
    partial[static_cast<long long>(b) * gridDim.x + blockIdx.x] = s;
  }
}

// ---- second stage of ss: one block per batch entry, fixed order ------------
__global__ void amp_local_ss_kernel(const float* __restrict__ partial,
                                    float* __restrict__ ss, int nblk) {
  __shared__ float sh[kSsThreads];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  float s = 0.f;
  for (int i = tid; i < nblk; i += kSsThreads)
    s += partial[static_cast<long long>(b) * nblk + i];
  sh[tid] = s;
  __syncthreads();
  for (int st = kSsThreads / 2; st > 0; st >>= 1) {
    if (tid < st) sh[tid] += sh[tid + st];
    __syncthreads();
  }
  if (tid == 0) ss[b] = sh[0];
}

// ---- f-pass: threads along N, loop over the Mp rows of shard (b, p) --------
// grid (ceil(N / (threads*V)), P, B). One block owns all rows of its columns,
// so nothing is reduced across blocks.
template <typename TA, bool VEC>
__global__ void amp_local_f_kernel(const TA* __restrict__ a, long long a_bstride,
                                   const float* __restrict__ zn,
                                   const float* __restrict__ x,
                                   float* __restrict__ f,
                                   float n_proc, int mp, int n) {
  constexpr int V = Width<TA, VEC>::value;
  __shared__ float zs[kFChunk];
  const int b = blockIdx.z;
  const int p = blockIdx.y;
  const int p_count = gridDim.y;
  const long long col =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  const bool live = col < n;  // VEC implies n % V == 0: a live thread owns V columns
  const TA* ap = a + static_cast<long long>(b) * a_bstride +
                 static_cast<long long>(p) * mp * n;
  const float* zp = zn + (static_cast<long long>(b) * p_count + p) * mp;
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;

  for (int m0 = 0; m0 < mp; m0 += kFChunk) {
    const int cnt = min(kFChunk, mp - m0);
    __syncthreads();  // the previous chunk has been used up
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) zs[i] = zp[m0 + i];
    __syncthreads();
    if (live) {
      const TA* arow = ap + static_cast<long long>(m0) * n + col;
#pragma unroll 8
      for (int m = 0; m < cnt; ++m) {
        float av[V];
        load_a<TA, V>(arow, av);
        const float zv = zs[m];
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = fmaf(av[k], zv, acc[k]);
        arow += n;
      }
    }
  }
  if (live) {
    const float* xb = x + static_cast<long long>(b) * n + col;
    float* fo = f + (static_cast<long long>(b) * p_count + p) * n + col;
#pragma unroll
    for (int k = 0; k < V; ++k) fo[k] = xb[k] / n_proc + acc[k];
  }
}

template <typename TA, bool VEC>
cudaError_t launch_z(const void* a, long long a_bstride, const float* x,
                     const float* y, const float* z, const float* ons,
                     float* z_out, float* partial, int batch, int rows, int n,
                     int warps, cudaStream_t stream) {
  const int nblk = (rows + warps - 1) / warps;
  const dim3 grid(nblk, batch);
  amp_local_z_kernel<TA, VEC><<<grid, warps * 32, 0, stream>>>(
      static_cast<const TA*>(a), a_bstride, x, y, z, ons, z_out, partial, rows, n);
  return cudaGetLastError();
}

template <typename TA, bool VEC>
cudaError_t launch_f(const void* a, long long a_bstride, const float* zn,
                     const float* x, float* f, float n_proc, int batch,
                     int n_shards, int mp, int n, int threads,
                     cudaStream_t stream) {
  constexpr int V = Width<TA, VEC>::value;
  const int cols = threads * V;
  const dim3 grid((n + cols - 1) / cols, n_shards, batch);
  amp_local_f_kernel<TA, VEC><<<grid, threads, 0, stream>>>(
      static_cast<const TA*>(a), a_bstride, zn, x, f, n_proc, mp, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// z-pass and its second stage. a: (B or 1, rows, n) elements of float32
// (a_bf16 = 0) or bfloat16 (1), a_bstride elements between batch entries (0 =
// shared). x (B, n); y, z, z_out (B, rows); ons, ss (B,); partial
// (B, ceil(rows / warps)) scratch. vec = 1 promises n % (16 / sizeof A) == 0
// and 16-byte aligned a, x.
int amp_local_z_launch(const void* a, int a_bf16, long long a_bstride,
                       const float* x, const float* y, const float* z,
                       const float* ons, float* z_out, float* partial, float* ss,
                       int batch, int rows, int n, int warps, int vec,
                       void* stream) {
  if (warps < 1 || warps > kMaxWarps || batch < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (a_bf16) {
    e = vec ? launch_z<__nv_bfloat16, true>(a, a_bstride, x, y, z, ons, z_out, partial, batch, rows, n, warps, s)
            : launch_z<__nv_bfloat16, false>(a, a_bstride, x, y, z, ons, z_out, partial, batch, rows, n, warps, s);
  } else {
    e = vec ? launch_z<float, true>(a, a_bstride, x, y, z, ons, z_out, partial, batch, rows, n, warps, s)
            : launch_z<float, false>(a, a_bstride, x, y, z, ons, z_out, partial, batch, rows, n, warps, s);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nblk = (rows + warps - 1) / warps;
  amp_local_ss_kernel<<<batch, kSsThreads, 0, s>>>(partial, ss, nblk);
  return static_cast<int>(cudaGetLastError());
}

// f-pass. a as above with rows = n_shards * mp; zn (B, n_shards, mp);
// x (B, n); f (B, n_shards, n) = x / n_proc + A^T zn. vec = 1 promises
// n % (16 / sizeof A) == 0 and a 16-byte aligned a.
int amp_local_f_launch(const void* a, int a_bf16, long long a_bstride,
                       const float* zn, const float* x, float* f, float n_proc,
                       int batch, int n_shards, int mp, int n, int threads,
                       int vec, void* stream) {
  if (threads < 32 || threads > 1024 || batch < 1 || batch > 65535 ||
      n_shards < 1 || n_shards > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (a_bf16) {
    e = vec ? launch_f<__nv_bfloat16, true>(a, a_bstride, zn, x, f, n_proc, batch, n_shards, mp, n, threads, s)
            : launch_f<__nv_bfloat16, false>(a, a_bstride, zn, x, f, n_proc, batch, n_shards, mp, n, threads, s);
  } else {
    e = vec ? launch_f<float, true>(a, a_bstride, zn, x, f, n_proc, batch, n_shards, mp, n, threads, s)
            : launch_f<float, false>(a, a_bstride, zn, x, f, n_proc, batch, n_shards, mp, n, threads, s);
  }
  return static_cast<int>(e);
}

const char* amp_local_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
