// The RWKV-6 WKV recurrence in chunks of 32 steps, for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/wkv6/wkv6.py, `wkv6_pallas`
// (`_kernel`): for r, k, v, logw (B, T, H, Dh) and a bonus u (H, Dh),
//     S_t = diag(e^{logw_t}) S_{t-1} + k_t v_t^T,
//     y_t = r_t (S_{t-1} + diag(u) k_t v_t^T),
// computed a chunk of C = 32 steps at a time in the decay-rebased basis: with
// l_inc the inclusive cumulative log-decay of a channel inside the chunk and
// l_exc = l_inc - logw, r' = r e^{l_exc}, k' = k e^{-l_inc};
//     y     = tril_strict(r' k'^T) v + (sum_d r u k) v + r' S,
//     S    <- diag(e^{l_tot}) S + (k' e^{l_tot})^T v.
// It also takes an initial state and writes the final one: the model's call
// (prefill hands the state to decode) needs both. The TPU kernel holds the
// same state in its scratch after its last chunk.
//
// Contract kept from the TPU kernel: the caller clamps logw >= -2 (the model
// does, `_LOGW_MIN`), so over 32 steps the rebased factors stay within
// e^{+-64}, inside float32. Nothing here clamps.
//
// What bounds it on this card: at rwkv6-3b's prefill shape (B=4, T=1000,
// H=40, Dh=64, bf16 r/k/v, float32 logw and y) it moves about 148 MB and does
// about 4 GFLOP of float32 work, so the two bounds are close (~44 us of
// memory time against ~60 us of CUDA-core time).
//
// Design. One block per (b, h) walks the chunks in order, as the TPU's
// sequential grid axis did; the Dh x Dh float32 state stays in shared memory
// for the whole sequence. A chunk's r, k, v, logw are read with strided,
// coalesced loads straight from the (B, T, H, Dh) layout (no transposed
// copy). Steps past T are read as r = k = v = 0, logw = 0: they neither add
// to the state nor decay it, the reference's padding, and their y is not
// written. The cumulative sum runs in step order, one thread per channel.
// The four small products of a chunk (A = r' k'^T, A v, r' S and the state
// update k'^T v) are float32 FMAs on the CUDA cores, each thread holding a
// small tile of outputs in registers (2 x 2 of A, 2 x 4 of y, 4 x 4 of S) so
// that one shared-memory load feeds several FMAs; a tile's rows and columns
// are strided (t, t + 16; e, e + Dh/4, ...) so a warp's loads are
// conflict-free or broadcasts, and the rows of r', k' and A are padded by
// one float for the same reason. Sums run in a fixed order: the result is
// the same bits run to run. At B=4, H=40 there are 160 blocks for 132 SMs.
//
// Limits: Dh a multiple of 4 up to 128; r, k, v bf16 or float32 (one
// dtype); logw, u, the states and y float32.
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
constexpr int kChunk = 32;
constexpr int kHalf = kChunk / 2;
constexpr int kLdA = kChunk + 1;
constexpr int kMaxDh = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ __forceinline__ size_t smem_floats(int dh) {
  return static_cast<size_t>(dh) * dh      // state S
         + 2 * kChunk * (dh + 1)           // r', k' (rows padded by one)
         + 2 * kChunk * dh                 // v, logw
         + kChunk * kLdA                   // A (rows padded by one)
         + kChunk                          // u-bonus diagonal
         + 2 * dh;                         // e^{l_tot}, u
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ logw,
                  const float* __restrict__ u, const float* __restrict__ state0,
                  float* __restrict__ y, float* __restrict__ state_out,
                  int T_len, int H, int Dh) {
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ld = Dh + 1;   // padded row of r' and k'
  const int q = Dh / 4;    // column stride inside a thread's tile

  extern __shared__ float smem[];
  float* s_s = smem;                  // (Dh, Dh) state, row = k channel
  float* r_s = s_s + Dh * Dh;         // (C, Dh + 1) r, then r'
  float* k_s = r_s + kChunk * ld;     // (C, Dh + 1) k, then k'
  float* v_s = k_s + kChunk * ld;     // (C, Dh)
  float* l_s = v_s + kChunk * Dh;     // (C, Dh)  logw
  float* a_s = l_s + kChunk * Dh;     // (C, C + 1)
  float* diag_s = a_s + kChunk * kLdA;  // (C)
  float* etot_s = diag_s + kChunk;    // (Dh) e^{l_tot}
  float* u_s = etot_s + Dh;           // (Dh)

  const size_t state_base = static_cast<size_t>(bh) * Dh * Dh;
  for (int i = tid; i < Dh * Dh; i += kThreads)
    s_s[i] = state0 != nullptr ? state0[state_base + i] : 0.f;
  for (int d = tid; d < Dh; d += kThreads) u_s[d] = u[h * Dh + d];

  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk;
    __syncthreads();  // the previous chunk's readers of the buffers are done
    for (int i = tid; i < kChunk * Dh; i += kThreads) {
      const int t = i / Dh, d = i - t * Dh;
      const bool ok = t0 + t < T_len;
      const size_t off = ((static_cast<size_t>(b) * T_len + t0 + t) * H + h) * Dh + d;
      r_s[t * ld + d] = ok ? to_f32(r[off]) : 0.f;
      k_s[t * ld + d] = ok ? to_f32(k[off]) : 0.f;
      v_s[i] = ok ? to_f32(v[off]) : 0.f;
      l_s[i] = ok ? logw[off] : 0.f;
    }
    __syncthreads();

    // u-bonus diagonal sum_d r u k, on the raw r and k: a warp per step
    for (int t = warp; t < kChunk; t += kWarps) {
      float s = 0.f;
      for (int d = lane; d < Dh; d += 32)
        s = fmaf(r_s[t * ld + d] * u_s[d], k_s[t * ld + d], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) diag_s[t] = s;
    }
    __syncthreads();

    // cumulative log-decay in step order, one thread per channel; rebase
    for (int d = tid; d < Dh; d += kThreads) {
      float inc = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        const float lw = l_s[t * Dh + d];
        inc += lw;
        const float exc = inc - lw;
        r_s[t * ld + d] *= expf(exc);
        k_s[t * ld + d] *= expf(-inc);
      }
      etot_s[d] = expf(inc);
    }
    __syncthreads();

    // A[t][j] = r'_t . k'_j for j < t, else 0: rows t, t + 16, columns
    // j, j + 16 per thread
    for (int i = tid; i < kHalf * kHalf; i += kThreads) {
      const int ta = i / kHalf, ja = i - ta * kHalf;
      const float* r0 = r_s + ta * ld;
      const float* r1 = r_s + (ta + kHalf) * ld;
      const float* k0 = k_s + ja * ld;
      const float* k1 = k_s + (ja + kHalf) * ld;
      float s00 = 0.f, s10 = 0.f, s11 = 0.f;   // (t, j + 16) is never below
      for (int d = 0; d < Dh; ++d) {            // the diagonal: no s01
        const float a0 = r0[d], a1 = r1[d], b0 = k0[d], b1 = k1[d];
        s00 = fmaf(a0, b0, s00);
        s10 = fmaf(a1, b0, s10);
        s11 = fmaf(a1, b1, s11);
      }
      a_s[ta * kLdA + ja] = ja < ta ? s00 : 0.f;
      a_s[ta * kLdA + ja + kHalf] = 0.f;
      a_s[(ta + kHalf) * kLdA + ja] = s10;
      a_s[(ta + kHalf) * kLdA + ja + kHalf] = ja < ta ? s11 : 0.f;
    }
    __syncthreads();

    // y_t = sum_{j<t} A[t][j] v_j + diag_t v_t + r'_t S: rows t, t + 16,
    // columns e, e + Dh/4, e + Dh/2, e + 3Dh/4 per thread
    for (int i = tid; i < kHalf * q; i += kThreads) {
      const int tt = i / q, te = i - tt * q;
      const int ta = tt, tb = tt + kHalf;
      float in_a[4] = {0.f, 0.f, 0.f, 0.f}, in_b[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < tb; ++j) {   // A[ta][j] is 0 for j >= ta
        const float wa = a_s[ta * kLdA + j], wb = a_s[tb * kLdA + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float vv = v_s[j * Dh + te + e * q];
          in_a[e] = fmaf(wa, vv, in_a[e]);
          in_b[e] = fmaf(wb, vv, in_b[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        in_a[e] = fmaf(diag_s[ta], v_s[ta * Dh + te + e * q], in_a[e]);
        in_b[e] = fmaf(diag_s[tb], v_s[tb * Dh + te + e * q], in_b[e]);
      }
      float x_a[4] = {0.f, 0.f, 0.f, 0.f}, x_b[4] = {0.f, 0.f, 0.f, 0.f};
      for (int d = 0; d < Dh; ++d) {
        const float ra = r_s[ta * ld + d], rb = r_s[tb * ld + d];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sv = s_s[d * Dh + te + e * q];
          x_a[e] = fmaf(ra, sv, x_a[e]);
          x_b[e] = fmaf(rb, sv, x_b[e]);
        }
      }
      const size_t row = static_cast<size_t>(H) * Dh;
      float* ya = y + ((static_cast<size_t>(b) * T_len + t0 + ta) * H + h) * Dh + te;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (t0 + ta < T_len) ya[e * q] = in_a[e] + x_a[e];
        if (t0 + tb < T_len) ya[kHalf * row + e * q] = in_b[e] + x_b[e];
      }
    }
    __syncthreads();

    // S <- diag(e^{l_tot}) S + (k' e^{l_tot})^T v: rows d, d + Dh/4, ...,
    // columns e, e + Dh/4, ... per thread
    for (int i = tid; i < q * q; i += kThreads) {
      const int td = i / q, te = i - td * q;
      float dec[4], acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        dec[a] = etot_s[td + a * q];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
      }
      for (int t = 0; t < kChunk; ++t) {
        float kf[4], vv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) kf[a] = k_s[t * ld + td + a * q] * dec[a];
#pragma unroll
        for (int e = 0; e < 4; ++e) vv[e] = v_s[t * Dh + te + e * q];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][e] = fmaf(kf[a], vv[e], acc[a][e]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* sp = s_s + (td + a * q) * Dh + te + e * q;
          *sp = fmaf(dec[a], *sp, acc[a][e]);
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < Dh * Dh; i += kThreads) state_out[state_base + i] = s_s[i];
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const float* logw,
                   const float* u, const float* state0, float* y, float* state_out,
                   int B, int T_len, int H, int Dh, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(Dh);
  auto kernel = wkv6_chunk_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), logw, u,
      state0, y, state_out, T_len, H, Dh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v (B, T, H, Dh) bf16 (in_bf16 = 1) or float32; logw (B, T, H, Dh),
// u (H, Dh), state0 (B, H, Dh, Dh) or null (zeros), y (B, T, H, Dh) and
// state_out (B, H, Dh, Dh) float32, not aliasing state0.
int wkv6_launch(const void* r, const void* k, const void* v, const float* logw,
                const float* u, const float* state0, float* y, float* state_out,
                int B, int T_len, int H, int Dh, int in_bf16, void* stream) {
  if (B < 1 || T_len < 1 || H < 1 || Dh < 4 || Dh % 4 != 0 || Dh > kMaxDh ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      in_bf16 ? launch<__nv_bfloat16>(r, k, v, logw, u, state0, y, state_out, B, T_len, H, Dh, st)
              : launch<float>(r, k, v, logw, u, state0, y, state_out, B, T_len, H, Dh, st);
  return static_cast<int>(e);
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
