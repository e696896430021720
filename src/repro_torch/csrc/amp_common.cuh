// Device helpers shared by the matrix-vector kernels of amp_local.cu and
// amp_col.cu: loading A (float32 or bfloat16, 16 bytes a thread when
// aligned) and one warp's dot product of a row of A with a vector.
// kernels/build.py hashes this header into every library's name, so an edit
// here rebuilds both.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace amp {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// V consecutive elements of A, widened to float32. V > 1 is one 16-byte load.
template <typename TA, int V>
__device__ __forceinline__ void load_a(const TA* p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = to_float(p[0]);
  } else if constexpr (std::is_same<TA, float>::value) {
    static_assert(V == 4, "float32 vectors hold 4 elements");
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    static_assert(V == 8, "bfloat16 vectors hold 8 elements");
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
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
// 16-byte aligned rows and vectors). The sum is valid in lane 0.
template <typename TA, int V, typename Vec>
__device__ __forceinline__ float warp_row_dot(const TA* arow, const Vec& v,
                                              int n, int lane) {
  float acc = 0.f;
  const int nv = n / V;
#pragma unroll 4
  for (int i = lane; i < nv; i += 32) {
    float av[V];
    load_a<TA, V>(arow + static_cast<long long>(i) * V, av);
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
