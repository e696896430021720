// Block-wise max-abs quantization, its inverse, and the block-quantized
// fusion of the int8/int4 transport in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/quantize/quantize.py:
//   * `quantize_pallas` (`_quant_kernel`)     ->  quantize_blocks_kernel
//         for each block of `block` consecutive elements of a row of x (R, N):
//         amax  = max |x|
//         Delta = bf16(max(amax / qmax, 1e-30) * 1.004)
//         q     = clip(round_half_even(x / Delta), -qmax, qmax)   (int8)
//   * `dequantize_pallas` (`_dequant_kernel`) ->  dequantize_blocks_kernel
//         out = q * Delta
//   and the forms the two-phase `compressed_psum` of
//   src/repro/core/compression.py needs on its int8/int4 wire:
//   * quantize_blocks_kernel<true>: the int4 symbols (qmax 7) packed two a
//     byte straight from the registers, the even element of each pair in
//     the low nibble (`pack_int4`): (R, ceil(N / 2)) uint8, no int8 array
//   * dequantize_blocks_kernel<true>: reads the nibbles, sign-extends, scales
//   * dequantize_sum_kernel<packed>: for D received chunks (D, C) and their
//     scales, out[c] = sum_d q[d, c] * Delta[d, c / block], d = 0, 1, ...
//     in turn (phase 1's dequantize-then-sum over ranks in one launch, no
//     (D, C) float32 intermediate)
//   * both, with the sum over processors and the noise accounting of the
//     reference's `BlockQuantTransport.fuse` (src/repro/core/engine.py,
//     `drop=None`)                            ->  block_quant_fuse_kernel
//         for messages f_p (B, P, L), each row cut into scale blocks:
//         f[b, :]           = sum_p q * Delta   (p = 0, 1, ..., P-1 in order)
//         symbols[b, p, :]  = float(q)          (optional)
//         extra[b]          = P * mean(Delta^2) / 12   over the P x
//                             ceil(L / block) blocks of batch entry b
//     and its erasure form (the same function with `drop`: the reference's
//     `_erasure_rescale`), given keep[b, p] = 1 - drop (a row shared by
//     every b, or one a batch entry), float32 0/1 on the card:
//         n_surv = max(sum_p keep, 1),   scale = P / n_surv
//         f[b, :]  = (sum_p (q * Delta) * keep[p]) * scale   (p in order)
//         extra[b] = mean(Delta^2) / 12 * n_surv * (scale * scale)
//     the mean still over every processor's blocks, dropped ones included
//     (`quant_noise_var` of src/repro/core/compression.py), and every
//     symbol written. With every flag 1 each new factor is an exact 1.0,
//     so the bits are the drop-free form's.
//
// The contract is bit-exactness with the reference (`quantize_blocks` of
// src/repro/core/compression.py) and with the plain PyTorch versions: IEEE
// division (this file must never be built with --use_fast_math), rintf
// (round half to even, like jnp.round / torch.round), the scale rounded to
// bfloat16 with __float2bfloat16_rn before it is used, as the reference
// rounds it, and sums in a fixed order with __fadd_rn, never contracted
// into a multiply-add.
//
// What bounds them on this card: nothing of the arithmetic, and at the
// transport's sizes not even the bytes. The row messages (30, 10000) are
// 1.2 MB; the fused call moves 2.44 MB, 0.73 us of memory time. The time is
// in launches and in dependent memory latency, so the design is one launch
// a fusion that keeps every load in flight at once and writes no
// intermediate to device memory.
//
// Design:
//   * quantize_block, one device function for every kernel here, quantizes
//     one scale block (or, in a cluster, one slice of it) in one warp. A
//     span of up to 32 NV elements is read once into registers (NV a lane:
//     16-byte loads where the row is 16-byte aligned, else plain loads, all
//     issued before the amax tree and shuffle); its symbols replace the
//     values in the same registers. A longer span is taken 32 NV elements
//     at a time and read twice (no driven path has one). The ragged tail of
//     a row is read as zeros. x / Delta is a product with the reciprocal of
//     Delta, proven to round to the same integer as the IEEE quotient
//     except within 2^-14 of a half-integer, where the element is divided
//     (rint_quotient): an IEEE division an element was the longest
//     instruction sequence of the quantizer.
//   * quantize_blocks_kernel: a warp a scale block (NV = 16); the q stores
//     are 4 bytes a lane where the row allows.
//   * block_quant_fuse_kernel: a thread-block cluster of C blocks per
//     (column of scale blocks j, batch entry b); rank r takes the columns
//     [r S, (r + 1) S) of the scale block, S = block / C (C = 4 at block
//     512 and 2 at 256: S = 128, one 16-byte load a lane; fewer blocks a
//     cluster where more would make a second wave, as a batch would; a
//     wider slice is taken 128 columns at a time and read twice). The work is
//     spread over C times more SMs because a block is held up by what its
//     SM can move, not by what the card can: each SM reads its slice of
//     every processor's message and writes as much again in symbols. A
//     block has W = min(P, 31) quantizing warps and one that keeps the
//     noise accounts. Warp w quantizes processors p = w, w + W, ...: its
//     lanes q < C store the warp's amax of its slice into rank q's shared
//     memory (DSMEM), one cluster barrier a group of W processors, and every
//     rank takes the max of the C slices, so all form the same Delta. Each
//     warp writes q * Delta into its row of shared memory and its symbols
//     straight to device memory as float32; after a barrier of the W warps
//     the block folds the group's rows into the running sum in p order, so
//     the order of the sum depends on neither W nor C, and the last group's
//     fold writes f. Every sum in order requests all of its terms before
//     its first add.
//   * The accounts run beside the quantizing, off its path, in rank 0:
//     each quantizing warp writes its Delta^2 as soon as it has Delta; the
//     accounts warp, woken by a named barrier once the last group has its
//     scales, sums them in p order into the cluster's partial, writes it
//     to a slot of b and counts the cluster in on an int32 counter of b,
//     both relaxed, with no fence between (a fence waits for the slot's
//     write to land: a round trip to L2 on the longest path of the kernel);
//     the cluster that arrives last reads every slot, all requested at
//     once, waits for any not yet landed (its cluster has counted in, so
//     its write is on its way), adds them in j order, writes extra[b] and
//     resets the slots and the counter to 0. The counter only orders the
//     work: the result is the same bits whichever cluster is last. At the row shape this is 20 clusters of 4 blocks of
//     31 warps, one wave.
//   * dequantize_blocks_kernel and dequantize_sum_kernel: grid-stride loops,
//     a thread an element (the sum: a thread a column, the D rows in turn).
//     Their path is compressed_psum (src/repro_torch/core/compression.py),
//     whose chunks at the paper's sizes are a few thousand elements: like
//     the fusion, bound by launch and memory latency, not by bytes.
//
// Plain C interface, loaded with ctypes. The entry points launch on the
// stream they are given, do not synchronise, allocate nothing (the caller
// passes the fusion's counters and slots, zeroed once) and
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // standalone kernels: 8 warps a block
constexpr int kMaxWarps = 31;       // the fusion's quantizing warps a block
constexpr int kMaxCluster = 8;      // the fusion's blocks a cluster
constexpr int kSmemLimit = 232448;  // shared memory a block may take

// elements [t0, t0 + 32 NV) of a span whose first `lim` elements are real
// (the rest read as zeros); every load is issued before any is used. A lane
// holds in v[i] the element t0 + 4 (lane + 32 (i / 4)) + i % 4 with 16-byte
// loads (a warp's load covers 512 contiguous bytes), else t0 + lane + 32 i
// (128 contiguous bytes a warp)
template <int NV>
__device__ __forceinline__ void load_tile(const float* __restrict__ xb, int t0,
                                          int lim, bool vec, int lane, float (&v)[NV]) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < NV / 4; ++k) {
      const int e = t0 + 4 * (lane + 32 * k);
      const float4 x = e < lim ? __ldg(reinterpret_cast<const float4*>(xb + e))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * k] = x.x;
      v[4 * k + 1] = x.y;
      v[4 * k + 2] = x.z;
      v[4 * k + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = t0 + lane + 32 * i;
      v[i] = e < lim ? __ldg(xb + e) : 0.f;
    }
  }
}

// rint(x / delta) for |x / delta| < 128, as IEEE division then rint give
// it, from a product with rcp = RN(1 / delta): z = RN(x * rcp) is within
// 127 * 2^-23 (rcp's and the product's rounding) of x / delta, and RN(x /
// delta) within 2^-18 of it, so the two are within 1.9e-5 of each other,
// and rint of either is the same unless z lies within that distance of a
// half-integer. `exact` is set where z lies within kTie of one (or is not
// below 128, or is not a number): there the caller divides.
constexpr float kTie = 6.103515625e-05f;  // 2^-14, three times the bound

__device__ __forceinline__ float rint_quotient(float x, float rcp, bool& exact) {
  const float z = __fmul_rn(x, rcp);
  const float frac = __fsub_rn(z, floorf(z));  // off by 3e-8 at most
  exact = !(fabsf(z) < 128.f) || !(fabsf(__fsub_rn(frac, 0.5f)) > kTie);
  return rintf(z);
}

// The quantizer of one span of a scale block, run by a whole warp: the
// span's amax (its first `lim` of `span` elements are real), made the
// block's by combine(amax) (the identity where the span is the block), the
// bf16 scale Delta, handed to on_scale(Delta) and returned as float, then
// for each tile of 32 NV elements the symbols, float(q) in v[i] for the
// element of load_tile's v[i], handed to emit(t0, v, Delta). Bit for bit
// clip(rint(x / Delta), -qmax, qmax) with IEEE division (see
// rint_quotient); the few elements near a tie are divided. A symbol is
// never -0 (+0 is added).
template <int NV, class Combine, class OnScale, class Emit>
__device__ __forceinline__ float quantize_block(const float* __restrict__ xb,
                                                int lim, int span, bool vec,
                                                float qmax, int lane, Combine&& combine,
                                                OnScale&& on_scale, Emit&& emit) {
  constexpr int kTile = 32 * NV;
  float v[NV];
  float amax = 0.f;
  for (int t0 = 0; t0 < span; t0 += kTile) {
    load_tile<NV>(xb, t0, lim, vec, lane, v);
    float m[NV];  // a tree: max is exact in any order
#pragma unroll
    for (int i = 0; i < NV; ++i) m[i] = fabsf(v[i]);
#pragma unroll
    for (int w = NV / 2; w > 0; w >>= 1)
#pragma unroll
      for (int i = 0; i < w; ++i) m[i] = fmaxf(m[i], m[i + w]);
    amax = fmaxf(amax, m[0]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  amax = combine(amax);
  const float delta =
      __bfloat162float(__float2bfloat16_rn(fmaxf(amax / qmax, 1e-30f) * 1.004f));
  on_scale(delta);
  const float rcp = __frcp_rn(delta);
  for (int t0 = 0; t0 < span; t0 += kTile) {
    if (span > kTile) load_tile<NV>(xb, t0, lim, vec, lane, v);
    unsigned exact = 0;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      bool e;
      const float q = rint_quotient(v[i], rcp, e);
      exact |= static_cast<unsigned>(e) << i;
      if (!e) v[i] = q;
    }
    if (__any_sync(0xffffffffu, exact != 0)) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (exact & (1u << i)) v[i] = rintf(v[i] / delta);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = __fadd_rn(fminf(fmaxf(v[i], -qmax), qmax), 0.f);
    emit(t0, v, delta);
  }
  return delta;
}

// the low nibble of a symbol (float(q), |q| <= 7): its 4-bit two's complement
__device__ __forceinline__ unsigned nibble(float q) {
  return static_cast<unsigned>(static_cast<int>(q)) & 0xFu;
}

// the symbol in nibble `hi` of a packed byte, sign-extended
__device__ __forceinline__ int unpack_nibble(uint8_t byte, int hi) {
  const int v = hi ? (byte >> 4) : (byte & 0xF);
  return v > 7 ? v - 16 : v;
}

// kPack false: q is int8 (rows, n). kPack true (qmax <= 7): q is uint8
// (rows, ceil(n / 2)), two symbols a byte, the even element of each pair in
// the low nibble (pack_int4 of src/repro_torch/core/compression.py); the
// odd tail's high nibble is 0. Rows start at r * ceil(n / 2) bytes.
template <bool kPack>
__global__ void quantize_blocks_kernel(const float* __restrict__ x,
                                       void* __restrict__ q_out,
                                       __nv_bfloat16* __restrict__ scale,
                                       long long n_blocks, int n, int block,
                                       int nb, float qmax, bool vec) {
  constexpr int NV = 16;
  const long long w = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= n_blocks) return;  // whole warps leave; nothing below synchronises
  const long long r = w / nb;
  const int base = static_cast<int>(w % nb) * block;
  const int lim = min(block, n - base);
  int8_t* qb = static_cast<int8_t*>(q_out) + r * n + base;
  // base is even (block % 32 == 0), so a block's pairs never straddle it
  uint8_t* pb = static_cast<uint8_t*>(q_out) + r * ((n + 1) / 2) + base / 2;
  const float delta = quantize_block<NV>(
      x + r * n + base, lim, block, vec, qmax, lane, [](float m) { return m; },
      [](float) {},
      [&](int t0, const float (&v)[NV], float) {
        if (kPack) {
          if (vec) {  // lim % 4 == 0: a lane's four elements are all real
#pragma unroll
            for (int k = 0; k < NV / 4; ++k) {
              const int e = t0 + 4 * (lane + 32 * k);
              if (e < lim)
                *reinterpret_cast<uchar2*>(pb + e / 2) = make_uchar2(
                    static_cast<unsigned char>(nibble(v[4 * k]) | (nibble(v[4 * k + 1]) << 4)),
                    static_cast<unsigned char>(nibble(v[4 * k + 2]) | (nibble(v[4 * k + 3]) << 4)));
            }
          } else {  // element t0 + lane + 32 i: its pair is in the next lane
#pragma unroll
            for (int i = 0; i < NV; ++i) {
              const float hi = __shfl_down_sync(0xffffffffu, v[i], 1);
              const int e = t0 + lane + 32 * i;
              if (!(lane & 1) && e < lim)
                pb[e / 2] = static_cast<uint8_t>(nibble(v[i]) | (nibble(hi) << 4));
            }
          }
        } else if (vec) {
#pragma unroll
          for (int k = 0; k < NV / 4; ++k) {
            const int e = t0 + 4 * (lane + 32 * k);
            if (e < lim)
              *reinterpret_cast<char4*>(qb + e) = make_char4(
                  static_cast<signed char>(v[4 * k]), static_cast<signed char>(v[4 * k + 1]),
                  static_cast<signed char>(v[4 * k + 2]), static_cast<signed char>(v[4 * k + 3]));
          }
        } else {
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int e = t0 + lane + 32 * i;
            if (e < lim) qb[e] = static_cast<int8_t>(v[i]);
          }
        }
      });
  if (lane == 0) scale[w] = __float2bfloat16_rn(delta);  // exact: a bf16 value
}

// kPack: q is the packed (rows, ceil(n / 2)) uint8 of quantize_blocks_kernel
template <bool kPack>
__global__ void dequantize_blocks_kernel(const void* __restrict__ q_in,
                                         const __nv_bfloat16* __restrict__ scale,
                                         float* __restrict__ out,
                                         long long total, int n, int block,
                                         int nb) {
  const long long nh = (n + 1) / 2;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / n;
    const int c = static_cast<int>(i - r * n);
    const int q = kPack ? unpack_nibble(static_cast<const uint8_t*>(q_in)[r * nh + c / 2], c & 1)
                        : static_cast<const int8_t*>(q_in)[i];
    out[i] = static_cast<float>(q) * __bfloat162float(scale[r * nb + c / block]);
  }
}

// out[c] = sum_d q[d, c] * Delta[d, c / block], d = 0, 1, ..., D-1 in turn
// (phase 1 of compressed_psum: the D received chunks dequantized and summed
// in rank order, no (D, C) intermediate); IEEE products and adds, never a
// multiply-add. kPack: q is (D, ceil(C / 2)) packed nibbles.
template <bool kPack>
__global__ void dequantize_sum_kernel(const void* __restrict__ q_in,
                                      const __nv_bfloat16* __restrict__ scale,
                                      float* __restrict__ out, int D, int C,
                                      int block, int nb) {
  const long long ch = kPack ? (C + 1) / 2 : C;
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < C;
       c += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int d = 0; d < D; ++d) {
      const int q = kPack ? unpack_nibble(static_cast<const uint8_t*>(q_in)[d * ch + c / 2], c & 1)
                          : static_cast<const int8_t*>(q_in)[d * ch + c];
      acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(q),
                                     __bfloat162float(scale[static_cast<long long>(d) * nb + c / block])));
    }
    out[c] = acc;
  }
}

// ---- the fusion: cluster, barriers, counter --------------------------------
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

// every thread of every block of the cluster: the shared-memory writes
// before it, in any rank, are seen by the reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// v into the shared memory of block `rank` of the cluster, at the place of
// this block's `local`
__device__ __forceinline__ void st_peer(float* local, int rank, float v) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(remote), "f"(v) : "memory");
}

// named barriers: `threads` threads, a multiple of 32, meet at barrier `id`
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
constexpr int kScalesReady = 1;  // the quantizing warps' Delta^2 -> the accounts
constexpr int kGroupDone = 2;    // among the quantizing warps: a group's rows

// the counters and slots of the accounts: relaxed, at device scope. A slot
// holds a partial's bits with the sign bit set (a partial is a sum of
// squares, +0 or more, or a NaN made by the card, sign bit clear), so that
// 0 means "not yet written"
__device__ __forceinline__ int count_in(int* counter) {
  int old;
  asm volatile("atom.relaxed.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}
__device__ __forceinline__ void put_slot(int* slot, float v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(slot),
               "r"(__float_as_int(v) | static_cast<int>(0x80000000u))
               : "memory");
}
__device__ __forceinline__ int peek_slot(const int* slot) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(slot) : "memory");
  return v;
}

// s + x[0] + x[1] + ... + x[n - 1] in that order, every x[i] = load(i)
// requested before the first add (32 at a time)
template <class Load>
__device__ __forceinline__ float add_in_order(float s, int n, Load&& load) {
  constexpr int kChunk = 32;
  for (int i0 = 0; i0 < n; i0 += kChunk) {
    float x[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) x[i] = i0 + i < n ? load(i0 + i) : 0.f;
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (i0 + i < n) s = __fadd_rn(s, x[i]);
  }
  return s;
}

struct FuseArgs {
  const float* fp;    // (B, P, L)
  float* f;           // (B, L)
  float* extra;       // (B,)
  float* sym;         // (B, P, L) or null
  int* counters;      // B counters, then B x nbj slots, zero between
                      // launches; null if nbj == 1
  const float* keep;  // the erasure form's keep flags, row b at
                      // b * keep_stride (0: one row for all); null: drop-free
  int keep_stride;
  int P, L, block, nbj, cluster;
  float qmax;
  bool vec;
};

// n_surv = max(sum_p keep[b, p], 1), summed in p order (a sum of 0s and
// 1s: the same in any order)
__device__ __forceinline__ float survivors(const FuseArgs& a, int b) {
  const float* kb = a.keep + static_cast<size_t>(b) * a.keep_stride;
  return fmaxf(add_in_order(0.f, a.P, [&](int p) { return kb[p]; }), 1.f);
}

// The accounts of cluster (j, b), kept by rank 0's last warp while the
// others quantize: the P Delta^2 summed in p order into the cluster's
// partial, written to its slot; then the cluster counts in on b's counter.
// The last of b's clusters to count in reads every slot, waiting for any
// not yet seen (each was written before its cluster counted in, so no
// fence stands between a partial and its count), adds them in j order into
// extra[b] = P * mean(Delta^2) / 12, and zeroes the slots and the counter.
__device__ __forceinline__ void keep_accounts(const FuseArgs& a, const float* dd,
                                              int j, int b, int threads) {
  bar_sync(kScalesReady, threads);
  if ((threadIdx.x & 31) != 0) return;
  float total = add_in_order(0.f, a.P, [&](int p) { return dd[p]; });
  if (a.nbj > 1) {
    int* slots = a.counters + gridDim.y + static_cast<size_t>(b) * a.nbj;
    put_slot(slots + j, total);
    if (count_in(&a.counters[b]) != a.nbj - 1) return;
    total = 0.f;
    constexpr int kChunk = 32;
    for (int i0 = 0; i0 < a.nbj; i0 += kChunk) {
      int v[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) v[i] = i0 + i < a.nbj ? peek_slot(slots + i0 + i) : 1;
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        while (v[i] == 0) v[i] = peek_slot(slots + i0 + i);
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        if (i0 + i < a.nbj) {
          total = __fadd_rn(total, __int_as_float(v[i] & 0x7fffffff));
          slots[i0 + i] = 0;
        }
    }
    a.counters[b] = 0;  // ready for the next launch on the stream
  }
  const float mean = __fdiv_rn(total, static_cast<float>(a.P * a.nbj));
  const float per = __fdiv_rn(mean, 12.f);
  if (a.keep) {
    const float n_surv = survivors(a, b);
    const float scale = __fdiv_rn(static_cast<float>(a.P), n_surv);
    a.extra[b] = __fmul_rn(__fmul_rn(per, n_surv), __fmul_rn(scale, scale));
  } else {
    a.extra[b] = __fmul_rn(per, static_cast<float>(a.P));
  }
}

// grid (nbj * C, B), clusters of (C, 1, 1), W + 1 warps a block. Shared
// memory: W rows of S (a group's q * Delta), the running sum over p (S),
// every processor's Delta^2 (P), the amax exchange (2 x C x W: a group's
// and the next's). A lane holds kFuseNV elements of a slice at a time: all
// of a slice of 128 columns (the plan's, where one wave allows it); a wider
// slice is taken 128 columns at a time and read twice.
constexpr int kFuseNV = 4;

__global__ void __launch_bounds__((kMaxWarps + 1) * 32, 1)
    block_quant_fuse_kernel(const FuseArgs a) {
  constexpr int NV = kFuseNV;
  extern __shared__ __align__(16) float smem[];
  const int W = (blockDim.x >> 5) - 1;
  const int C = a.cluster, S = a.block / C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = C > 1 ? cluster_rank() : 0;
  float* rows = smem;
  float* acc = smem + W * S;
  float* dd = acc + S;
  float* xchg = dd + a.P;
  const int j = blockIdx.x / C, b = blockIdx.y;
  const int groups = (a.P + W - 1) / W;
  if (warp == W) {  // one cluster barrier a group, then rank 0 keeps accounts
    for (int g = 0; g < groups && C > 1; ++g) cluster_sync();
    if (rank == 0) keep_accounts(a, dd, j, b, blockDim.x);
    return;
  }
  const int col0 = j * a.block + rank * S;  // this block's slice of the row
  const int lim = max(0, min(S, a.L - col0));
  float* fb = a.f + static_cast<size_t>(b) * a.L + col0;

  for (int gi = 0; gi < groups; ++gi) {
    const int g = gi * W, p = g + warp;
    const bool last = gi + 1 == groups;
    float* xg = xchg + (gi & 1) * C * W;  // [rank][warp] of this group
    if (p < a.P) {
      const size_t off = (static_cast<size_t>(b) * a.P + p) * a.L + col0;
      float* row = rows + warp * S;
      float* sb = a.sym ? a.sym + off : nullptr;
      // q * Delta, times p's keep flag in the erasure form
      const float kp = a.keep ? a.keep[static_cast<size_t>(b) * a.keep_stride + p] : 1.f;
      auto deq = [&](float q, float d) {
        const float m = __fmul_rn(q, d);
        return a.keep ? __fmul_rn(m, kp) : m;
      };
      quantize_block<NV>(
          a.fp + off, lim, S, a.vec, a.qmax, lane,
          [&](float m) {
            if (C == 1) return m;
            if (lane < C) st_peer(xg + rank * W + warp, lane, m);
            cluster_sync();
            float all = 0.f;
            for (int r = 0; r < C; ++r) all = fmaxf(all, xg[r * W + warp]);
            return all;
          },
          [&](float d) {
            if (rank != 0) return;
            if (lane == 0) dd[p] = __fmul_rn(d, d);
            if (last) bar_arrive(kScalesReady, blockDim.x);
          },
          [&](int t0, const float (&v)[NV], float d) {
            if (a.vec) {
#pragma unroll
              for (int k = 0; k < NV / 4; ++k) {
                const int e = t0 + 4 * (lane + 32 * k);
                if (e < lim) {
                  *reinterpret_cast<float4*>(row + e) =
                      make_float4(deq(v[4 * k], d), deq(v[4 * k + 1], d),
                                  deq(v[4 * k + 2], d), deq(v[4 * k + 3], d));
                  if (sb)
                    *reinterpret_cast<float4*>(sb + e) =
                        make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
                }
              }
            } else {
#pragma unroll
              for (int i = 0; i < NV; ++i) {
                const int e = t0 + lane + 32 * i;
                if (e < lim) {
                  row[e] = deq(v[i], d);
                  if (sb) sb[e] = v[i];
                }
              }
            }
          });
    } else {  // idle in the last group: the cluster's barrier all the same
      if (C > 1) cluster_sync();
      if (rank == 0) bar_arrive(kScalesReady, blockDim.x);
    }
    bar_sync(kGroupDone, W * 32);
    const int gw = min(W, a.P - g);
    // the erasure form's survivor rescale P / n_surv of the sum, reckoned
    // only now: the keep row is a line the warps' own flags brought into
    // L1, where at the start its loads would stall the first tile's
    const float fscale = last && a.keep
                             ? __fdiv_rn(static_cast<float>(a.P), survivors(a, b))
                             : 1.f;
    for (int c = threadIdx.x; c < lim; c += W * 32) {
      const float s = add_in_order(g == 0 ? 0.f : acc[c], gw,
                                   [&](int w) { return rows[w * S + c]; });
      if (last)
        fb[c] = a.keep ? __fmul_rn(s, fscale) : s;
      else
        acc[c] = s;
    }
    if (!last) bar_sync(kGroupDone, W * 32);  // the next group rewrites the rows
  }
}

// nothing: the floor of a launch with the fusion's grid, cluster, threads
// and shared memory, for timing
__global__ void empty_kernel() {}

int fuse_smem_bytes(int warps, int slice, int P, int cluster) {
  return ((warps + 1) * slice + P + 2 * cluster * warps) * static_cast<int>(sizeof(float));
}

cudaError_t allow_smem(const void* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

bool bad_block(int block) { return block < 32 || block % 32 != 0; }

// launch `kernel` on grid (gx, gy) in clusters of (cluster, 1, 1)
template <class... Args>
cudaError_t launch_clusters(void (*kernel)(Args...), int gx, int gy, int cluster,
                            int threads, int smem, cudaStream_t stream, Args... args) {
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (rows, n) float32 -> q (rows, n) int8, scale (rows, ceil(n / block))
// bfloat16. block % 32 == 0; 1 <= qmax <= 127. With `packed` (qmax <= 7) q
// is uint8 (rows, ceil(n / 2)): two nibbles a byte.
int quantize_blocks_launch(const float* x, void* q, void* scale, long long rows,
                           int n, int block, int qmax, int packed, void* stream) {
  if (rows < 1 || n < 1 || bad_block(block) || qmax < 1 || qmax > (packed ? 7 : 127))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (n + block - 1) / block;
  const long long n_blocks = rows * nb;
  const long long grid = (n_blocks + (kThreads / 32) - 1) / (kThreads / 32);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % (packed ? 2 : 4) == 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto* sc = static_cast<__nv_bfloat16*>(scale);
  const float qm = static_cast<float>(qmax);
  if (packed)
    quantize_blocks_kernel<true><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
        x, q, sc, n_blocks, n, block, nb, qm, vec);
  else
    quantize_blocks_kernel<false><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
        x, q, sc, n_blocks, n, block, nb, qm, vec);
  return static_cast<int>(cudaGetLastError());
}

// q (rows, n) int8 (packed: (rows, ceil(n / 2)) uint8), scale (rows,
// ceil(n / block)) bfloat16 -> out (rows, n) float32.
int dequantize_blocks_launch(const void* q, const void* scale, float* out,
                             long long rows, int n, int block, int packed,
                             void* stream) {
  if (rows < 1 || n < 1 || bad_block(block))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (n + block - 1) / block;
  const long long total = rows * n;
  long long grid = (total + kThreads - 1) / kThreads;
  if (grid > 132 * 16) grid = 132 * 16;  // grid-stride beyond a few waves
  auto st = static_cast<cudaStream_t>(stream);
  auto* sc = static_cast<const __nv_bfloat16*>(scale);
  if (packed)
    dequantize_blocks_kernel<true><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
        q, sc, out, total, n, block, nb);
  else
    dequantize_blocks_kernel<false><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
        q, sc, out, total, n, block, nb);
  return static_cast<int>(cudaGetLastError());
}

// q (D, C) int8 (packed: (D, ceil(C / 2)) uint8), scale (D, ceil(C /
// block)) bfloat16 -> out (C,) float32 = sum over d in order of q * Delta.
int dequantize_sum_launch(const void* q, const void* scale, float* out, int D,
                          int C, int block, int packed, void* stream) {
  if (D < 1 || C < 1 || bad_block(block) ||
      static_cast<long long>(D) * C >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (C + block - 1) / block;
  int grid = (C + kThreads - 1) / kThreads;
  if (grid > 132 * 16) grid = 132 * 16;
  auto st = static_cast<cudaStream_t>(stream);
  auto* sc = static_cast<const __nv_bfloat16*>(scale);
  if (packed)
    dequantize_sum_kernel<true><<<grid, kThreads, 0, st>>>(q, sc, out, D, C, block, nb);
  else
    dequantize_sum_kernel<false><<<grid, kThreads, 0, st>>>(q, sc, out, D, C, block, nb);
  return static_cast<int>(cudaGetLastError());
}

// fp (B, P, L) float32 -> f (B, L), extra (B,), sym (B, P, L) float32 or
// null. The plan (kernels/quantize/quantize.py::fuse_plan): clusters of
// `cluster` blocks, a cluster per (j, b), each block `warps` + 1 warps and
// smem == fuse_smem_bytes(warps, block / cluster, P, cluster) bytes. With
// ceil(L / block) > 1, counters holds B * (1 + ceil(L / block)) ints, zero
// (they are zero again after the kernel). keep (null: drop-free) holds the
// erasure form's flags, row b at b * keep_stride, keep_stride 0 or P.
int block_quant_fuse_launch(const float* fp, float* f, float* extra, float* sym,
                            int* counters, const float* keep, int keep_stride,
                            int B, int P, int L, int block, int qmax, int cluster,
                            int warps, int smem, void* stream) {
  const int slice = cluster > 0 ? block / cluster : 0;
  const int nbj = (L + block - 1) / block;
  if (B < 1 || B > 65535 || P < 1 || L < 1 || bad_block(block) || qmax < 1 ||
      qmax > 127 || cluster < 1 || cluster > kMaxCluster || block % cluster != 0 ||
      slice % 32 != 0 || warps < 1 || warps > kMaxWarps || warps > P ||
      smem != fuse_smem_bytes(warps, slice, P, cluster) || smem > kSmemLimit ||
      static_cast<long long>(P) * nbj >= (1 << 24) ||
      static_cast<long long>(nbj) * cluster > 0x7fffffffLL ||
      (keep != nullptr && keep_stride != 0 && keep_stride != P))
    return static_cast<int>(cudaErrorInvalidValue);
  FuseArgs a{fp, f, extra, sym, counters, keep, keep_stride, P, L, block, nbj, cluster,
             static_cast<float>(qmax), false};
  if (nbj > 1 && counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  a.vec = L % 4 == 0 && reinterpret_cast<uintptr_t>(fp) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(sym) % 16 == 0;
  const int threads = (warps + 1) * 32;
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch_clusters(block_quant_fuse_kernel, nbj * cluster, B,
                                          cluster, threads, smem, st, a));
}

// an empty kernel launched as block_quant_fuse_launch launches the fusion's:
// grid (grid_x, grid_y) in clusters of `cluster`, `warps` + 1 warps a block
// and `smem` bytes of shared memory; the floor under its time
int block_quant_empty_launch(int grid_x, int grid_y, int cluster, int warps, int smem,
                             void* stream) {
  if (grid_x < 1 || grid_y < 1 || grid_y > 65535 || cluster < 1 ||
      cluster > kMaxCluster || grid_x % cluster != 0 || warps < 1 ||
      warps > kMaxWarps || smem < 0 || smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_clusters(empty_kernel, grid_x, grid_y, cluster,
                                          (warps + 1) * 32, smem,
                                          static_cast<cudaStream_t>(stream)));
}

const char* quantize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
