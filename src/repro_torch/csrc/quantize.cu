// Block-wise max-abs quantization and its inverse, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/quantize/quantize.py:
//   * `quantize_pallas` (`_quant_kernel`)     ->  quantize_blocks_kernel
//         for each block of `block` consecutive elements of a row of x (R, N):
//         amax  = max |x|
//         Delta = bf16(max(amax / qmax, 1e-30) * 1.004)
//         q     = clip(round_half_even(x / Delta), -qmax, qmax)   (int8)
//   * `dequantize_pallas` (`_dequant_kernel`) ->  dequantize_blocks_kernel
//         out = q * Delta
//
// The contract is bit-exactness with the reference (`quantize_blocks` of
// src/repro/core/compression.py) and with the plain PyTorch version: IEEE
// division (this file must never be built with --use_fast_math), rintf
// (round half to even, like jnp.round / torch.round), and the scale rounded
// to bfloat16 with __float2bfloat16_rn before it is used, as the reference
// rounds it.
//
// What bounds it on this card: bytes, and at the transport's sizes not even
// those. At the row shape (30, 10000) a call moves about 1.5 MB, under a
// microsecond of memory time: the kernels are launch-bound, and kept simple.
//
// Design: one warp per scale block. The warp reads its block twice (the
// second time from L1/L2), once for amax (a shuffle reduction; max is exact
// in any order) and once to quantize. Any `block` that is a multiple of 32
// works (the reference uses 256 and 512). The ragged tail of a row is read
// as zeros and its symbols are not written, so the caller makes no padded
// copy: q is (R, N), the scales (R, ceil(N / block)).
//
// Plain C interface, loaded with ctypes. The entry points launch on the
// stream they are given, do not synchronise, allocate nothing and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, 8 scale blocks per thread block

__global__ void quantize_blocks_kernel(const float* __restrict__ x,
                                       int8_t* __restrict__ q,
                                       __nv_bfloat16* __restrict__ scale,
                                       long long n_blocks, int n, int block,
                                       int nb, float qmax) {
  const long long w = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= n_blocks) return;  // whole warps leave; nothing below synchronises
  const long long r = w / nb;
  const int base = static_cast<int>(w % nb) * block;
  const int lim = min(block, n - base);
  const float* xb = x + r * n + base;

  float amax = 0.f;
  for (int i = lane; i < lim; i += 32) amax = fmaxf(amax, fabsf(xb[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  const __nv_bfloat16 d16 = __float2bfloat16_rn(fmaxf(amax / qmax, 1e-30f) * 1.004f);
  const float delta = __bfloat162float(d16);
  int8_t* qb = q + r * n + base;
  for (int i = lane; i < lim; i += 32) {
    const float v = rintf(xb[i] / delta);
    qb[i] = static_cast<int8_t>(fminf(fmaxf(v, -qmax), qmax));
  }
  if (lane == 0) scale[w] = d16;
}

__global__ void dequantize_blocks_kernel(const int8_t* __restrict__ q,
                                         const __nv_bfloat16* __restrict__ scale,
                                         float* __restrict__ out,
                                         long long total, int n, int block,
                                         int nb) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / n;
    const int c = static_cast<int>(i - r * n);
    out[i] = static_cast<float>(q[i]) * __bfloat162float(scale[r * nb + c / block]);
  }
}

}  // namespace

extern "C" {

// x (rows, n) float32 -> q (rows, n) int8, scale (rows, ceil(n / block))
// bfloat16. block % 32 == 0; 1 <= qmax <= 127.
int quantize_blocks_launch(const float* x, int8_t* q, void* scale,
                           long long rows, int n, int block, int qmax,
                           void* stream) {
  if (rows < 1 || n < 1 || block < 32 || block % 32 != 0 || qmax < 1 ||
      qmax > 127)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (n + block - 1) / block;
  const long long n_blocks = rows * nb;
  const long long grid = (n_blocks + (kThreads / 32) - 1) / (kThreads / 32);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  quantize_blocks_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, q, static_cast<__nv_bfloat16*>(scale), n_blocks, n, block, nb,
      static_cast<float>(qmax));
  return static_cast<int>(cudaGetLastError());
}

// q (rows, n) int8, scale (rows, ceil(n / block)) bfloat16 -> out (rows, n)
// float32.
int dequantize_blocks_launch(const int8_t* q, const void* scale, float* out,
                             long long rows, int n, int block, void* stream) {
  if (rows < 1 || n < 1 || block < 32 || block % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (n + block - 1) / block;
  const long long total = rows * n;
  long long grid = (total + kThreads - 1) / kThreads;
  if (grid > 132 * 16) grid = 132 * 16;  // grid-stride beyond a few waves
  dequantize_blocks_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      q, static_cast<const __nv_bfloat16*>(scale), out, total, n, block, nb);
  return static_cast<int>(cudaGetLastError());
}

const char* quantize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
