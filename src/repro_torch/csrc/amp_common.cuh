// Device helpers shared by the matrix-vector kernels of amp_local.cu and
// amp_col.cu: loading A (float32 or bfloat16, 16 bytes a thread when
// aligned), one warp's dot product of a row of A with a vector, and the
// streamer that both files' band kernels use to bring rows of A into a ring
// of shared memory with TMA bulk copies.
// kernels/build.py hashes this header into every library's name, so an edit
// here rebuilds both.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace amp {

// ---- the streamer: mbarriers and bulk copies (inline PTX, sm_90) ----------
// A ring slot is filled by one thread: mbar_expect_tx (arrive, and announce
// the bytes) then bulk_load, which copies contiguous bytes from device memory
// into the slot and counts them off the slot's mbarrier as they land.
// Consumers wait on the slot's phase parity. Sizes and both addresses must be
// multiples of 16 bytes: the caller's `vec` rule (N * sizeof A % 16 == 0 and
// an aligned base) guarantees it for whole rows of A.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// after the mbarriers are initialised, before any thread uses them
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// orders this CTA's earlier generic-proxy accesses of shared memory (the
// consumers' reads of a slot, made visible by a barrier) before the bulk
// copy that refills it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a barrier over the first `threads` threads of the block (id 1..15)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// V consecutive elements of A, widened to float32. V > 1 is one 16-byte load,
// through the read-only cache from device memory, or from shared memory
// (SMEM: a slot of a ring).
template <typename TA, int V, bool SMEM = false>
__device__ __forceinline__ void load_a(const TA* p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = to_float(p[0]);
  } else if constexpr (std::is_same<TA, float>::value) {
    static_assert(V == 4, "float32 vectors hold 4 elements");
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 v = SMEM ? *q : __ldg(q);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    static_assert(V == 8, "bfloat16 vectors hold 8 elements");
    const uint4* q = reinterpret_cast<const uint4*>(p);
    const uint4 raw = SMEM ? *q : __ldg(q);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

template <typename TA, bool VEC>
struct Width {
  static constexpr int value = VEC ? 16 / static_cast<int>(sizeof(TA)) : 1;
};

// The vector of a row dot product: x itself ...
struct VecX {
  const float* x;
  __device__ __forceinline__ float at(long long e) const { return x[e]; }
  __device__ __forceinline__ float4 at4(long long e) const {
    return *reinterpret_cast<const float4*>(x + e);
  }
};

// ... or the difference x - x0, formed as it is read.
struct VecDiff {
  const float* x;
  const float* x0;
  __device__ __forceinline__ float at(long long e) const { return x[e] - x0[e]; }
  __device__ __forceinline__ float4 at4(long long e) const {
    const float4 a = *reinterpret_cast<const float4*>(x + e);
    const float4 b = *reinterpret_cast<const float4*>(x0 + e);
    return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
  }
};

// sum_k arow[k] * v[k] over k < n by the 32 lanes of one warp, striding
// along the row (V elements a lane at a time; V > 1 needs n % V == 0 and
// 16-byte aligned rows and vectors). The row lies in device memory, or in
// shared memory (SMEM). The sum is valid in lane 0.
template <typename TA, int V, bool SMEM = false, typename Vec>
__device__ __forceinline__ float warp_row_dot(const TA* arow, const Vec& v,
                                              int n, int lane) {
  float acc = 0.f;
  const int nv = n / V;
#pragma unroll 4
  for (int i = lane; i < nv; i += 32) {
    float av[V];
    load_a<TA, V, SMEM>(arow + static_cast<long long>(i) * V, av);
    if constexpr (V == 1) {
      acc = fmaf(av[0], v.at(i), acc);
    } else {
#pragma unroll
      for (int k = 0; k < V; k += 4) {
        const float4 xv = v.at4(static_cast<long long>(i) * V + k);
        acc = fmaf(av[k], xv.x, acc);
        acc = fmaf(av[k + 1], xv.y, acc);
        acc = fmaf(av[k + 2], xv.z, acc);
        acc = fmaf(av[k + 3], xv.w, acc);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  return acc;
}

}  // namespace amp
