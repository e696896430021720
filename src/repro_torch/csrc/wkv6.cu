// The RWKV-6 WKV recurrence in chunks of 32 steps, for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/wkv6/wkv6.py, `wkv6_pallas`
// (`_kernel`, l.27; its pallas_call, l.80): for r, k, v, logw (B, T, H, Dh)
// and a bonus u (H, Dh),
//     S_t = diag(e^{logw_t}) S_{t-1} + k_t v_t^T,
//     y_t = r_t (S_{t-1} + diag(u) k_t v_t^T),
// a chunk of C = 32 steps at a time. With l_inc the inclusive cumulative
// log-decay of a channel inside the chunk, l_exc = l_inc - logw and l_tot
// its value at the chunk's last step, the kernel rebases
//     r'' = r e^{l_exc - l_tot},  kk = k e^{l_tot - l_inc},  S_dec = diag(e^{l_tot}) S,
// and a chunk is four products:
//     A  = tril_strict(r'' kk^T) + diag(sum_d r u k)     32 x 32 x Dh
//     y  = r'' S_dec + A v                               32 x VB x Dh, 32 x VB x 32
//     S <- S_dec + kk^T v                                Dh x VB x 32
// These are the reference's r' k'^T, r' S and diag(e^{l_tot}) S + (k'
// e^{l_tot})^T v (r' = r e^{l_exc}, k' = k e^{-l_inc}) with the factors
// e^{+-l_tot} moved between the operands: the same values, and every
// operand stays inside float32's range, because the caller keeps logw >= -2
// (the model clamps it, `_LOGW_MIN`), so |l_tot| <= 64. Nothing here clamps.
// The kernel also takes an initial state and writes the final one (prefill
// hands it to decode); the TPU kernel holds the state in its scratch.
//
// What bounds it on this card: at rwkv6-3b's prefill shape (B=4, T=1000,
// H=40, Dh=64, bf16 r/k/v, float32 logw, state and y) the function must move
// 149 MB, 0.0444 ms at 3.35 TB/s; its 3.25 GFLOP of products take ~7 us at
// the TF32 tensor-core rate and the other 0.14 GFLOP ~2 us on CUDA cores.
// Bytes bound it.
//
// Design.
// * Blocks: one per (b, h) and slice of VB = Dh / NV value columns, grid
//   (B * H, NV) (`wkv_plan` in kernels/wkv6/wkv6.py: the largest NV whose
//   blocks are all resident at once, since each block walks the whole
//   sequence). Columns of y and S depend only on the same columns of v, so
//   a block keeps only its (Dh, VB) slice of S, in shared memory, for the
//   whole sequence. Every block recomputes the chunk's scan, rebasing and A
//   from all Dh channels, in the same order: the NV blocks agree bit for bit.
// * Loads: a chunk's rows of r, k, logw and of the block's v slice stream
//   into a raw buffer by 16-byte cp.async copies, straight from the
//   (B, T, H, Dh) layout; steps past T are zero-filled through the copy's
//   source size, so they neither add to the state nor decay it (the
//   reference's padding), and their y is not written. As soon as the scan
//   has turned chunk c into the float32 working set, chunk c + 1's copies
//   are issued: they land while chunk c's products run. Rows that are not
//   whole 16-byte pieces (bf16 with Dh % 8 != 0) take plain loads.
// * Scan: a warp takes four channels at a time, lane t holding step t. An
//   inclusive shuffle scan (5 steps) gives l_inc, lane 31 l_tot; all 256
//   threads work and the exponentials (__expf) run side by side. r'' and kk
//   leave the scan split into TF32 halves (below), once for every product
//   that reads them; the u-bonus diagonal sums in the same pass (a partial
//   a warp, added in warp order).
// * Products: mma.sync m16n8k8, TF32 in and float32 sums (wgmma wants
//   64-row tiles; a chunk has 32 rows). TF32 keeps float32's exponent but 10
//   mantissa bits, so every operand x is split x = hi + lo (cvt.rna) and a
//   product is lo*hi + hi*lo + hi*hi: about float32's precision, inside the
//   reference's tolerance (one-term TF32 is not). A bf16 v is a TF32 number:
//   its lo is zero and that term is skipped. Depths and widths under 8 are
//   padded with zeros in shared memory. Three barriers a chunk: after the
//   copies land, after the scan, and between phase A (A; r'' S_dec into each
//   warp's y tiles) and phase B (y += A v, written out; S updated in place).
// * Sums run in a fixed order: y and the state are the same bits run to run.
//   No intermediate state goes to device memory.
//
// Weak spots (measured at rwkv6-3b prefill, PERF.md): the SMs' instruction
// issue bounds it, not bytes. Each block repeats its (b, h)'s scan, A and
// copies of r, k, logw, so the plan's NV = 2 adds half again to that work;
// 320 blocks on 132 SMs leave the SMs that hold 3 blocks to finish last;
// within a block the phases of a chunk run one after the other (only the
// copies overlap them); S_dec is split anew for each tile that reads it.
// The one-wave plan ties NV to residency: 3 blocks an SM need <= 85
// registers and the ~75 KB of shared memory of a 32-column slice; a build
// over either falls to 2 blocks and the plan to NV = 1.
//
// Limits: Dh a multiple of 4 up to 128; r, k, v bf16 or float32 (one
// dtype); logw, u, the states and y float32.
//
// The backward (`wkv6_bwd_kernel`, entry `wkv6_bwd_launch`) has no TPU
// counterpart: the reference differentiates its jnp `wkv_chunked` with
// jax.grad. It is described where it starts, below the forward.
//
// Plain C interface, loaded with ctypes. The entry points launch on the
// stream they are given, do not synchronise, allocate nothing and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;
constexpr int kLdA = 36;          // row of A (floats): 4 mod 8
constexpr int kMaxDh = 128;
// y tiles (16 x 8) a warp holds across the chunk's middle barrier: 2 x 16 at
// the widest slice (128 columns), over the block's warps
constexpr int kMaxYTiles = 2 * (kMaxDh / 8) / kWarps;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory layout of a block, for head size dh, value slice vb and
// elements of esize bytes (r, k, v). Offsets in bytes. Row strides are
// chosen for conflict-free fragment loads: rows of r'' and kk (A operands,
// lanes g * ld + q) are 4 mod 8 floats, rows of v and S (B operands, lanes
// q * ld + g) 8 or 24 mod 32; raw rows carry 16 bytes of padding, so the
// scan's 32 lanes, one step (row) each, do not all hit one bank.
struct Layout {
  int dhp, dhm, vbp;          // dh up to 8, dh up to 16, vb up to 8
  int ld_rk, ld_v;            // rows of r'', kk and of v, S (floats)
  int raw_rk, raw_l, raw_v;   // rows of the raw r / k, logw, v (bytes)
  int o_r, o_k, o_l, o_v;     // raw chunk: r, k, logw, v slice
  int o_rp, o_rpl, o_kp, o_kpl, o_v32, o_a, o_s, o_dpart, o_etot, o_u;
  int bytes;
  __host__ __device__ Layout(int dh, int vb, int esize) {
    dhp = round_up(dh, 8);
    dhm = round_up(dh, 16);
    vbp = round_up(vb, 8);
    ld_rk = dhm + 4;
    ld_v = (vbp % 32 == 8 || vbp % 32 == 24) ? vbp : vbp + 8;
    raw_rk = round_up(dh * esize, 16) + 16;
    raw_l = round_up(dh * 4, 16) + 16;
    raw_v = round_up(vb * esize, 16) + 16;
    int o = 0;
    o_r = o;  o += kChunk * raw_rk;
    o_k = o;  o += kChunk * raw_rk;
    o_l = o;  o += kChunk * raw_l;
    o_v = o;  o += kChunk * raw_v;
    o_rp = o; o += 4 * kChunk * ld_rk;
    o_rpl = o; o += 4 * kChunk * ld_rk;
    o_kp = o; o += 4 * kChunk * ld_rk;
    o_kpl = o; o += 4 * kChunk * ld_rk;
    o_v32 = o; o += 4 * kChunk * ld_v;
    o_a = o;  o += 4 * kChunk * kLdA;
    o_s = o;  o += 4 * dhm * ld_v;
    o_dpart = o; o += 4 * kWarps * kChunk;
    o_etot = o;  o += 4 * dhm;
    o_u = o;  o += 4 * dhp;
    bytes = o;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four consecutive elements of a raw row as float32 (8- or 16-byte load).
__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  out[0] = __uint_as_float(x.x << 16);
  out[1] = __uint_as_float(x.x & 0xffff0000u);
  out[2] = __uint_as_float(x.y << 16);
  out[3] = __uint_as_float(x.y & 0xffff0000u);
}

// 16 bytes of raw elements to float32 (four floats, or eight from bf16).
template <typename T>
__device__ __forceinline__ void to_f32x16(const char* src, float* dst);
template <>
__device__ __forceinline__ void to_f32x16<float>(const char* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
template <>
__device__ __forceinline__ void to_f32x16<__nv_bfloat16>(const char* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  *reinterpret_cast<float4*>(dst) = make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
                                                __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
  *reinterpret_cast<float4*>(dst + 4) = make_float4(__uint_as_float(x.z << 16), __uint_as_float(x.z & 0xffff0000u),
                                                    __uint_as_float(x.w << 16), __uint_as_float(x.w & 0xffff0000u));
}

// Tensor cores: mma.sync m16n8k8 with TF32 inputs and float32 sums. Each
// float32 operand x is split as x = hi + lo, hi = tf32(x), lo = tf32(x - hi)
// (cvt.rna: round to nearest, ties away), and a product is hi*hi + hi*lo +
// lo*hi (the 3xTF32 split: about float32's precision, float32's range).
// Fragments (PTX ISA, m16n8k8 .tf32), g = lane / 4, q = lane % 4:
// a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4);
// b0 (k = q, n = g), b1 (k = q + 4, n = g); c0, c1 (g, 2q, 2q + 1), c2, c3
// (g + 8, 2q, 2q + 1).
struct Frag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: the two small terms first, then hi*hi. b_exact: b is
// a TF32 number already (v from bf16), its lo is zero and hi*lo is skipped.
__device__ __forceinline__ void mma3(float c[4], const Frag& a, const Frag& b, bool b_exact) {
  mma(c, a.lo, b.hi);
  if (!b_exact) mma(c, a.hi, b.lo);
  mma(c, a.hi, b.hi);
}

// A operand: rows m0.. m0 + 15, columns k0.. k0 + 7 of a row-major matrix.
__device__ __forceinline__ void load_a(const float* p, int ld, int m0, int k0, int g, int q,
                                       Frag& f) {
  const float* r0 = p + (m0 + g) * ld + k0 + q;
  const float* r1 = r0 + 8 * ld;
  split(r0[0], f.hi[0], f.lo[0]);
  split(r1[0], f.hi[1], f.lo[1]);
  split(r0[4], f.hi[2], f.lo[2]);
  split(r1[4], f.hi[3], f.lo[3]);
}

// B operand (k0.. k0 + 7, n0.. n0 + 7) of a matrix stored row-major by k.
__device__ __forceinline__ void load_b_kn(const float* p, int ld, int k0, int n0, int g, int q,
                                          Frag& f) {
  const float* c = p + (k0 + q) * ld + n0 + g;
  split(c[0], f.hi[0], f.lo[0]);
  split(c[4 * ld], f.hi[1], f.lo[1]);
}

// A and B operands from their TF32 halves, split once when they were made;
// B stored row-major by n (B = M^T: kk for r'' kk^T).
__device__ __forceinline__ void load_a(const uint32_t* hi, const uint32_t* lo, int ld, int m0,
                                       int k0, int g, int q, Frag& f) {
  const int i0 = (m0 + g) * ld + k0 + q, i1 = i0 + 8 * ld;
  f.hi[0] = hi[i0]; f.lo[0] = lo[i0];
  f.hi[1] = hi[i1]; f.lo[1] = lo[i1];
  f.hi[2] = hi[i0 + 4]; f.lo[2] = lo[i0 + 4];
  f.hi[3] = hi[i1 + 4]; f.lo[3] = lo[i1 + 4];
}
__device__ __forceinline__ void load_b_nk(const uint32_t* hi, const uint32_t* lo, int ld, int n0,
                                          int k0, int g, int q, Frag& f) {
  const int i = (n0 + g) * ld + k0 + q;
  f.hi[0] = hi[i]; f.lo[0] = lo[i];
  f.hi[1] = hi[i + 4]; f.lo[1] = lo[i + 4];
}
// B operand that is a TF32 number already (v from bf16): hi is its bits, lo
// is zero and never read (mma3 with b_exact).
__device__ __forceinline__ void load_b_kn_exact(const float* p, int ld, int k0, int n0, int g,
                                                int q, Frag& f) {
  const float* c = p + (k0 + q) * ld + n0 + g;
  f.hi[0] = __float_as_uint(c[0]);
  f.hi[1] = __float_as_uint(c[4 * ld]);
}

// B operand of diag(w) M, M stored row-major by k: rows scaled, then split
// (S_dec for r'' S_dec).
__device__ __forceinline__ void load_b_kn(const float* p, const float* w, int ld, int k0, int n0,
                                          int g, int q, Frag& f) {
  const float* c = p + (k0 + q) * ld + n0 + g;
  split(w[k0 + q] * c[0], f.hi[0], f.lo[0]);
  split(w[k0 + q + 4] * c[4 * ld], f.hi[1], f.lo[1]);
}

struct Args {
  const void* r; const void* k; const void* v; const float* logw;
  const float* u; const float* state0; float* y; float* state_out;
  int T_len, H, Dh, VB, vec;
};

// Chunk c's steps of r, k, logw (all Dh channels) and v (the block's value
// slice) into the raw buffer: 16-byte cp.async copies (steps past T
// zero-filled by a source size of 0), or plain loads where a row is not a
// whole number of 16-byte pieces.
template <typename T>
__device__ void load_chunk(const Args& a, const Layout& L, char* smem, int b, int h,
                           int j, int c) {
  const int tid = threadIdx.x;
  const int t0 = c * kChunk;
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int Dh = a.Dh, VB = a.VB;
  if (a.vec) {
    // step t's row starts rs elements after step t - 1's; a step past T
    // copies nothing (from step t0's row) and zero-fills
    const size_t rs = static_cast<size_t>(a.H) * Dh;
    const size_t base = (static_cast<size_t>(b) * a.T_len + t0) * rs + static_cast<size_t>(h) * Dh;
    const int n_ok = min(kChunk, a.T_len - t0);
    const int pr = Dh * static_cast<int>(sizeof(T)) / 16;
    for (int i = tid; i < kChunk * pr; i += kThreads) {
      const int t = i / pr, p = i - t * pr;
      const size_t off = base + (t < n_ok ? t : 0) * rs;
      const int n = t < n_ok ? 16 : 0;
      cp_async16(smem + L.o_r + t * L.raw_rk + 16 * p, reinterpret_cast<const char*>(r + off) + 16 * p, n);
      cp_async16(smem + L.o_k + t * L.raw_rk + 16 * p, reinterpret_cast<const char*>(k + off) + 16 * p, n);
    }
    const int pl = Dh / 4;
    for (int i = tid; i < kChunk * pl; i += kThreads) {
      const int t = i / pl, p = i - t * pl;
      const size_t off = base + (t < n_ok ? t : 0) * rs;
      cp_async16(smem + L.o_l + t * L.raw_l + 16 * p, reinterpret_cast<const char*>(a.logw + off) + 16 * p,
                 t < n_ok ? 16 : 0);
    }
    const int pv = VB * static_cast<int>(sizeof(T)) / 16;
    for (int i = tid; i < kChunk * pv; i += kThreads) {
      const int t = i / pv, p = i - t * pv;
      const size_t off = base + (t < n_ok ? t : 0) * rs + j * VB;
      cp_async16(smem + L.o_v + t * L.raw_v + 16 * p, reinterpret_cast<const char*>(v + off) + 16 * p,
                 t < n_ok ? 16 : 0);
    }
    cp_async_commit();
  } else {
    for (int i = tid; i < kChunk * Dh; i += kThreads) {
      const int t = i / Dh, d = i - t * Dh;
      const bool ok = t0 + t < a.T_len;
      const size_t off = ((static_cast<size_t>(b) * a.T_len + t0 + t) * a.H + h) * Dh + d;
      reinterpret_cast<T*>(smem + L.o_r + t * L.raw_rk)[d] = ok ? r[off] : T(0.f);
      reinterpret_cast<T*>(smem + L.o_k + t * L.raw_rk)[d] = ok ? k[off] : T(0.f);
      reinterpret_cast<float*>(smem + L.o_l + t * L.raw_l)[d] = ok ? a.logw[off] : 0.f;
    }
    for (int i = tid; i < kChunk * VB; i += kThreads) {
      const int t = i / VB, e = i - t * VB;
      const bool ok = t0 + t < a.T_len;
      const size_t off = ((static_cast<size_t>(b) * a.T_len + t0 + t) * a.H + h) * Dh + j * VB + e;
      reinterpret_cast<T*>(smem + L.o_v + t * L.raw_v)[e] = ok ? v[off] : T(0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_chunk_kernel(const Args a) {
  const int bh = blockIdx.x, j = blockIdx.y;
  const int b = bh / a.H, h = bh - (bh / a.H) * a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int Dh = a.Dh, VB = a.VB;
  const Layout L(Dh, VB, static_cast<int>(sizeof(T)));
  const int n_ytiles = 2 * (L.vbp / 8);
  constexpr bool kVExact = sizeof(T) == 2;   // bf16 v is a TF32 number

  extern __shared__ __align__(16) char smem[];
  uint32_t* rph_s = reinterpret_cast<uint32_t*>(smem + L.o_rp);   // (C, ld_rk) r'' hi
  uint32_t* rpl_s = reinterpret_cast<uint32_t*>(smem + L.o_rpl);  // r'' lo
  uint32_t* kph_s = reinterpret_cast<uint32_t*>(smem + L.o_kp);   // (C, ld_rk) kk hi
  uint32_t* kpl_s = reinterpret_cast<uint32_t*>(smem + L.o_kpl);  // kk lo
  float* v_s = reinterpret_cast<float*>(smem + L.o_v32);    // (C, ld_v) v slice
  float* a_s = reinterpret_cast<float*>(smem + L.o_a);      // (C, kLdA)
  float* s_s = reinterpret_cast<float*>(smem + L.o_s);      // (dhm, ld_v) S slice
  float* dpart_s = reinterpret_cast<float*>(smem + L.o_dpart);  // (warps, C)
  float* etot_s = reinterpret_cast<float*>(smem + L.o_etot);    // (dhm)
  float* u_s = reinterpret_cast<float*>(smem + L.o_u);          // (dhp)

  // the working set starts at zero: padded channels and columns stay zero
  for (int i = L.o_rp / 4 + tid; i < L.bytes / 4; i += kThreads)
    reinterpret_cast<float*>(smem)[i] = 0.f;
  __syncthreads();
  const size_t state_base = static_cast<size_t>(bh) * Dh * Dh + j * VB;
  if (a.state0 != nullptr)
    for (int i = tid; i < Dh * VB; i += kThreads) {
      const int d = i / VB, e = i - d * VB;
      s_s[d * L.ld_v + e] = a.state0[state_base + static_cast<size_t>(d) * Dh + e];
    }
  for (int d = tid; d < Dh; d += kThreads) u_s[d] = a.u[h * Dh + d];

  const int n_chunks = (a.T_len + kChunk - 1) / kChunk;
  load_chunk<T>(a, L, smem, b, h, j, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk;
    cp_async_wait_all();
    __syncthreads();  // chunk c is in the raw buffer; chunk c - 1 is done

    // Scan: a warp a group of four channels at a time, lane t = step t.
    // Inclusive scan of logw over the lanes (5 shuffle steps); r'' and kk
    // split into TF32 halves; e^{l_tot}; the u-bonus diagonal sum_d r u k
    // (a partial a warp).
    float dacc = 0.f;
    for (int g4 = warp; g4 < Dh / 4; g4 += kWarps) {
      const int d = 4 * g4;
      float lw[4], r4[4], k4[4];
      load4(reinterpret_cast<const float*>(smem + L.o_l + lane * L.raw_l) + d, lw);
      load4(reinterpret_cast<const T*>(smem + L.o_r + lane * L.raw_rk) + d, r4);
      load4(reinterpret_cast<const T*>(smem + L.o_k + lane * L.raw_rk) + d, k4);
      float inc[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dacc = fmaf(r4[q] * u_s[d + q], k4[q], dacc);
        inc[q] = lw[q];
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float n = __shfl_up_sync(0xffffffffu, inc[q], off);
          if (lane >= off) inc[q] += n;
        }
      uint4 rh, rl, kh, kl;
      uint32_t* rhp = &rh.x;
      uint32_t* rlp = &rl.x;
      uint32_t* khp = &kh.x;
      uint32_t* klp = &kl.x;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float tot = __shfl_sync(0xffffffffu, inc[q], 31);
        split(r4[q] * __expf((inc[q] - lw[q]) - tot), rhp[q], rlp[q]);
        split(k4[q] * __expf(tot - inc[q]), khp[q], klp[q]);
        if (lane == 0) etot_s[d + q] = __expf(tot);
      }
      const int o = lane * L.ld_rk + d;
      *reinterpret_cast<uint4*>(rph_s + o) = rh;
      *reinterpret_cast<uint4*>(rpl_s + o) = rl;
      *reinterpret_cast<uint4*>(kph_s + o) = kh;
      *reinterpret_cast<uint4*>(kpl_s + o) = kl;
    }
    dpart_s[warp * kChunk + lane] = dacc;
    if (a.vec) {   // the v slice to float32, 16 bytes at a time
      const int pv = VB * static_cast<int>(sizeof(T)) / 16;
      for (int i = tid; i < kChunk * pv; i += kThreads) {
        const int t = i / pv, p = i - t * pv;
        to_f32x16<T>(smem + L.o_v + t * L.raw_v + 16 * p, v_s + t * L.ld_v + p * (16 / sizeof(T)));
      }
    } else {
      for (int i = tid; i < kChunk * VB; i += kThreads) {
        const int t = i / VB, e = i - t * VB;
        v_s[t * L.ld_v + e] = to_f32(reinterpret_cast<const T*>(smem + L.o_v + t * L.raw_v)[e]);
      }
    }
    __syncthreads();  // the raw buffer is free: chunk c + 1 streams in
    if (c + 1 < n_chunks) load_chunk<T>(a, L, smem, b, h, j, c + 1);

    // Phase A. A = tril_strict(r'' kk^T) + diag(sum_d r u k) into shared
    // memory (six 16 x 8 tiles of the 32 x 32 lower half, from the last warp
    // down), and r'' S_dec into the y tiles' accumulators (from warp 0 up).
    for (int p = kWarps - 1 - warp; p < 6; p += kWarps) {
      const int ti = p < 2 ? 0 : 1, tj = p < 2 ? p : p - 2;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int s = 0; s < L.dhp / 8; ++s) {
        Frag fa, fb;
        load_a(rph_s, rpl_s, L.ld_rk, 16 * ti, 8 * s, g, tq, fa);
        load_b_nk(kph_s, kpl_s, L.ld_rk, 8 * tj, 8 * s, g, tq, fb);
        mma3(acc, fa, fb, false);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int row = 16 * ti + g + (x >> 1) * 8, col = 8 * tj + 2 * tq + (x & 1);
        float val = 0.f;
        if (col < row) {
          val = acc[x];
        } else if (col == row) {
          for (int w = 0; w < kWarps; ++w) val += dpart_s[w * kChunk + row];
        }
        a_s[row * kLdA + col] = val;
      }
    }
    float yacc[kMaxYTiles][4];
#pragma unroll
    for (int i = 0; i < kMaxYTiles; ++i) {
#pragma unroll
      for (int x = 0; x < 4; ++x) yacc[i][x] = 0.f;
      const int tile = warp + i * kWarps;
      if (tile < n_ytiles) {
        const int ti = tile & 1, tn = tile >> 1;
  #pragma unroll 4
      for (int s = 0; s < L.dhp / 8; ++s) {
          Frag fa, fb;
          load_a(rph_s, rpl_s, L.ld_rk, 16 * ti, 8 * s, g, tq, fa);
          load_b_kn(s_s, etot_s, L.ld_v, 8 * s, 8 * tn, g, tq, fb);
          mma3(yacc[i], fa, fb, false);
        }
      }
    }
    __syncthreads();  // A is written; every reader of S is done

    // Phase B. y += A v (steps j <= t: the first 16 rows need only the
    // first two k-steps), written out; S <- S_dec + kk^T v in place, a
    // 16 x 8 tile at a time.
#pragma unroll
    for (int i = 0; i < kMaxYTiles; ++i) {
      const int tile = warp + i * kWarps;
      if (tile < n_ytiles) {
        const int ti = tile & 1, tn = tile >> 1;
#pragma unroll 4
        for (int s = 0; s < 2 * ti + 2; ++s) {
          Frag fa, fb;
          load_a(a_s, kLdA, 16 * ti, 8 * s, g, tq, fa);
          if constexpr (kVExact)
            load_b_kn_exact(v_s, L.ld_v, 8 * s, 8 * tn, g, tq, fb);
          else
            load_b_kn(v_s, L.ld_v, 8 * s, 8 * tn, g, tq, fb);
          mma3(yacc[i], fa, fb, kVExact);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 16 * ti + g + 8 * half, col = 8 * tn + 2 * tq;
          if (t0 + row < a.T_len && col < VB) {
            float* yp = a.y + ((static_cast<size_t>(b) * a.T_len + t0 + row) * a.H + h) * Dh +
                        j * VB + col;
            if (col + 1 < VB)
              *reinterpret_cast<float2*>(yp) = make_float2(yacc[i][2 * half], yacc[i][2 * half + 1]);
            else
              *yp = yacc[i][2 * half];
          }
        }
      }
    }
    const int n_stiles = (L.dhm / 16) * (L.vbp / 8);
    for (int tile = kWarps - 1 - warp; tile < n_stiles; tile += kWarps) {
      const int tm = tile / (L.vbp / 8), tn = tile - tm * (L.vbp / 8);
      const int d0 = 16 * tm + g, d1 = d0 + 8, e0 = 8 * tn + 2 * tq;
      const float dec0 = etot_s[d0], dec1 = etot_s[d1];
      float* s0 = s_s + d0 * L.ld_v + e0;
      float* s1 = s_s + d1 * L.ld_v + e0;
      float acc[4] = {dec0 * s0[0], dec0 * s0[1], dec1 * s1[0], dec1 * s1[1]};
#pragma unroll
      for (int s = 0; s < kChunk / 8; ++s) {
        const int k0 = (8 * s + tq) * L.ld_rk, k1 = k0 + 4 * L.ld_rk;
        Frag fa, fb;
        fa.hi[0] = kph_s[k0 + d0]; fa.lo[0] = kpl_s[k0 + d0];
        fa.hi[1] = kph_s[k0 + d1]; fa.lo[1] = kpl_s[k0 + d1];
        fa.hi[2] = kph_s[k1 + d0]; fa.lo[2] = kpl_s[k1 + d0];
        fa.hi[3] = kph_s[k1 + d1]; fa.lo[3] = kpl_s[k1 + d1];
        if constexpr (kVExact)
          load_b_kn_exact(v_s, L.ld_v, 8 * s, 8 * tn, g, tq, fb);
        else
          load_b_kn(v_s, L.ld_v, 8 * s, 8 * tn, g, tq, fb);
        mma3(acc, fa, fb, kVExact);
      }
      s0[0] = acc[0]; s0[1] = acc[1];
      s1[0] = acc[2]; s1[1] = acc[3];
    }
  }
  __syncthreads();
  for (int i = tid; i < Dh * VB; i += kThreads) {
    const int d = i / VB, e = i - d * VB;
    a.state_out[state_base + static_cast<size_t>(d) * Dh + e] = s_s[d * L.ld_v + e];
  }
}

template <typename T>
cudaError_t prepare(int Dh, int VB, size_t* smem) {
  *smem = static_cast<size_t>(Layout(Dh, VB, static_cast<int>(sizeof(T))).bytes);
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(wkv6_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const Args& a, int B, int NV, cudaStream_t stream) {
  size_t smem = 0;
  const cudaError_t e = prepare<T>(a.Dh, a.VB, &smem);
  if (e != cudaSuccess) return e;
  wkv6_chunk_kernel<T><<<dim3(B * a.H, NV), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The backward: dr, dk, dv, dlogw, du and dstate0 for the cotangents dy
// (B, T, H, Dh) of y and dS_T (B, H, Dh, Dh) of the final state (or none).
//
// With G_t = dL/dS_t, the adjoint runs backward from G_T = dS_T as
// G_{t-1} = diag(w_t) G_t + r_t dy_t^T, and (kernels/wkv6/ref.py,
// `wkv6_bwd_ref`, is the same function step by step)
//     dr_t = S_{t-1} dy_t + u k_t (v_t . dy_t)
//     dk_t = G_t v_t + u r_t (v_t . dy_t)
//     dv_t = G_t^T k_t + (r_t . u k_t) dy_t
//     du = sum_t r_t k_t (v_t . dy_t),     dstate0 = G_0.
// dlogw_t[i] = w_t[i] sum_j G_t[i, j] S_{t-1}[i, j] is taken as a reverse
// cumulative sum: with P_t[i] = sum_j G_t[i, j] S_t[i, j] and dr^h, dk^h
// the two products above without their u terms, P_{t-1} = P_t - k_t dk^h_t
// + r_t dr^h_t and dlogw_t = P_t - k_t dk^h_t, from P_T = rowsum(S_T dS_T).
//
// A chunk of C = 32 steps in the basis of the reference's wkv_chunked
// (l_inc, l_exc = l_inc - logw, l_last = l_inc at the chunk's last step;
// r' = r e^{l_exc}, k' = k e^{-l_inc}, kk = k e^{l_last - l_inc}; S0 and G
// the state and adjoint at the chunk's start and end):
//     A = tril_strict(r' k'^T),  Bm = dy v^T,  ruk_t = sum_i r u k
//     dr^h = e^{l_exc} (dy S0^T + tril_strict(Bm) k')
//     dk^h = e^{l_last - l_inc} (v G^T) + e^{-l_inc} (tril_strict(Bm)^T r')
//     dv   = kk G + A^T dy + ruk dy
//     G   <- diag(e^{l_last}) G + r'^T dy      (the adjoint at the chunk's start)
// As in the forward, the caller keeps logw >= -2, so every factor stays
// within e^{+-64} and every product inside float32's range.
//
// Design (simple first: CUDA-core float32 FMAs, no tensor cores). One block
// per (b, h), 256 threads, the whole (Dh, Dh) state and adjoint in shared
// memory. Pass 1 runs the state recurrence forward and writes each chunk's
// start state to `scratch` (B, H, ceil(T / 32), Dh, Dh) float32; pass 2
// takes the chunks in reverse, carrying G and P. Steps past T are zero
// (k = v = r = dy = 0, logw = 0: they neither add to the state nor decay
// it) and their gradients are not written. du leaves as partials (B, H, Dh)
// that the wrapper sums over B in a fixed order. Sums run in a fixed order:
// the results are the same bits run to run.
//
// Limits: Dh a power of two from 4 to 64; r, k, v bf16 or float32 (one
// dtype; dr, dk, dv in it); logw, u, state0, dy, dS_T, dlogw, du and
// dstate0 float32.

constexpr int kBwdThreads = 256;

struct BwdLayout {
  int ld, ldc;               // rows of the (., Dh) and (C, C) matrices (floats)
  int o_s, o_g, o_r, o_k, o_v, o_dy, o_lw, o_ele, o_enl, o_ekk, o_rp, o_kp, o_kk,
      o_rd, o_kd, o_a, o_b, o_ruk, o_u, o_elast, o_p;
  int bytes;
  __host__ __device__ explicit BwdLayout(int dh) {
    ld = dh + 1;              // odd: a warp down a column hits 32 banks
    ldc = kChunk + 1;
    int o = 0;
    o_s = o;   o += dh * ld;
    o_g = o;   o += dh * ld;
    o_r = o;   o += kChunk * ld;
    o_k = o;   o += kChunk * ld;
    o_v = o;   o += kChunk * ld;
    o_dy = o;  o += kChunk * ld;
    o_lw = o;  o += kChunk * ld;
    o_ele = o; o += kChunk * ld;
    o_enl = o; o += kChunk * ld;
    o_ekk = o; o += kChunk * ld;
    o_rp = o;  o += kChunk * ld;
    o_kp = o;  o += kChunk * ld;
    o_kk = o;  o += kChunk * ld;
    o_rd = o;  o += kChunk * ld;
    o_kd = o;  o += kChunk * ld;
    o_a = o;   o += kChunk * ldc;
    o_b = o;   o += kChunk * ldc;
    o_ruk = o; o += kChunk;
    o_u = o;   o += dh;
    o_elast = o; o += dh;
    o_p = o;   o += dh;
    bytes = 4 * o;
  }
};

struct BwdArgs {
  const void* r; const void* k; const void* v; const float* logw; const float* u;
  const float* state0; const float* dy; const float* ds; float* scratch;
  void* dr; void* dk; void* dv; float* dlogw; float* du_part; float* dstate0;
  int T_len, H, Dh;
};

__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Chunk c's rows (steps past T as zeros) of the listed (B, T, H, Dh) inputs
// into shared memory as float32.
template <typename T>
__device__ void bwd_load_rows(const T* src, float* dst, int ld, size_t base, size_t rs, int Dh,
                              int n_ok) {
  for (int e = threadIdx.x; e < kChunk * Dh; e += kBwdThreads) {
    const int t = e / Dh, i = e - t * Dh;
    dst[t * ld + i] = t < n_ok ? to_f32(src[base + t * rs + i]) : 0.f;
  }
}

// The chunk's cumulative log-decay, a thread a channel: e^{l_exc},
// e^{-l_inc}, e^{l_last - l_inc} for every step, e^{l_last} for the chunk.
__device__ void bwd_scan(const BwdLayout& L, float* sm, int Dh) {
  for (int i = threadIdx.x; i < Dh; i += kBwdThreads) {
    float inc = 0.f;
    for (int t = 0; t < kChunk; ++t) {
      const float lw = sm[L.o_lw + t * L.ld + i];
      sm[L.o_ele + t * L.ld + i] = inc;          // l_exc, made e^{l_exc} below
      inc += lw;
      sm[L.o_enl + t * L.ld + i] = inc;          // l_inc
    }
    for (int t = 0; t < kChunk; ++t) {
      const float li = sm[L.o_enl + t * L.ld + i];
      sm[L.o_ele + t * L.ld + i] = expf(sm[L.o_ele + t * L.ld + i]);
      sm[L.o_enl + t * L.ld + i] = expf(-li);
      sm[L.o_ekk + t * L.ld + i] = expf(inc - li);
    }
    sm[L.o_elast + i] = expf(inc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
wkv6_bwd_kernel(const BwdArgs a) {
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H;
  const int tid = threadIdx.x;
  const int Dh = a.Dh, DD = Dh * Dh;
  const BwdLayout L(Dh);
  extern __shared__ __align__(16) float sm[];
  float* S = sm + L.o_s;
  float* G = sm + L.o_g;
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const size_t rs = static_cast<size_t>(a.H) * Dh;          // one step's row
  const size_t row0 = static_cast<size_t>(b) * a.T_len * rs + static_cast<size_t>(h) * Dh;
  const int n_chunks = (a.T_len + kChunk - 1) / kChunk;
  float* scratch = a.scratch + static_cast<size_t>(bh) * n_chunks * DD;
  const size_t state_base = static_cast<size_t>(bh) * DD;

  for (int e = tid; e < DD; e += kBwdThreads) {
    const int i = e / Dh, j = e - i * Dh;
    S[i * L.ld + j] = a.state0 != nullptr ? a.state0[state_base + e] : 0.f;
  }
  for (int i = tid; i < Dh; i += kBwdThreads) sm[L.o_u + i] = a.u[h * Dh + i];
  __syncthreads();

  // Pass 1: each chunk's start state to scratch, S_T left in S.
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk, n_ok = min(kChunk, a.T_len - t0);
    const size_t base = row0 + static_cast<size_t>(t0) * rs;
    for (int e = tid; e < DD; e += kBwdThreads) {
      const int i = e / Dh, j = e - i * Dh;
      scratch[static_cast<size_t>(c) * DD + e] = S[i * L.ld + j];
    }
    bwd_load_rows<T>(k, sm + L.o_k, L.ld, base, rs, Dh, n_ok);
    bwd_load_rows<T>(v, sm + L.o_v, L.ld, base, rs, Dh, n_ok);
    bwd_load_rows<float>(a.logw, sm + L.o_lw, L.ld, base, rs, Dh, n_ok);
    __syncthreads();
    bwd_scan(L, sm, Dh);
    __syncthreads();
    for (int e = tid; e < kChunk * Dh; e += kBwdThreads) {
      const int t = e / Dh, i = e - t * Dh;
      sm[L.o_kk + t * L.ld + i] = sm[L.o_k + t * L.ld + i] * sm[L.o_ekk + t * L.ld + i];
    }
    __syncthreads();
    for (int e = tid; e < DD; e += kBwdThreads) {
      const int i = e / Dh, j = e - i * Dh;
      float acc = sm[L.o_elast + i] * S[i * L.ld + j];
      for (int t = 0; t < kChunk; ++t)
        acc = fmaf(sm[L.o_kk + t * L.ld + i], sm[L.o_v + t * L.ld + j], acc);
      S[i * L.ld + j] = acc;
    }
    __syncthreads();
  }

  // Pass 2: G from dS_T, P = rowsum(S_T dS_T); the chunks in reverse.
  for (int e = tid; e < DD; e += kBwdThreads) {
    const int i = e / Dh, j = e - i * Dh;
    G[i * L.ld + j] = a.ds != nullptr ? a.ds[state_base + e] : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < Dh; i += kBwdThreads) {
    float p = 0.f;
    if (a.ds != nullptr)
      for (int j = 0; j < Dh; ++j) p = fmaf(S[i * L.ld + j], G[i * L.ld + j], p);
    sm[L.o_p + i] = p;
  }
  float du_acc = 0.f;                        // thread i < Dh: du[i]
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, n_ok = min(kChunk, a.T_len - t0);
    const size_t base = row0 + static_cast<size_t>(t0) * rs;
    __syncthreads();                         // the previous chunk is done with S
    for (int e = tid; e < DD; e += kBwdThreads) {
      const int i = e / Dh, j = e - i * Dh;
      S[i * L.ld + j] = scratch[static_cast<size_t>(c) * DD + e];
    }
    bwd_load_rows<T>(r, sm + L.o_r, L.ld, base, rs, Dh, n_ok);
    bwd_load_rows<T>(k, sm + L.o_k, L.ld, base, rs, Dh, n_ok);
    bwd_load_rows<T>(v, sm + L.o_v, L.ld, base, rs, Dh, n_ok);
    bwd_load_rows<float>(a.dy, sm + L.o_dy, L.ld, base, rs, Dh, n_ok);
    bwd_load_rows<float>(a.logw, sm + L.o_lw, L.ld, base, rs, Dh, n_ok);
    __syncthreads();
    bwd_scan(L, sm, Dh);
    __syncthreads();
    for (int e = tid; e < kChunk * Dh; e += kBwdThreads) {
      const int t = e / Dh, i = e - t * Dh, o = t * L.ld + i;
      sm[L.o_rp + o] = sm[L.o_r + o] * sm[L.o_ele + o];
      sm[L.o_kp + o] = sm[L.o_k + o] * sm[L.o_enl + o];
      sm[L.o_kk + o] = sm[L.o_k + o] * sm[L.o_ekk + o];
    }
    __syncthreads();
    // A (strictly lower) and Bm (whole), a thread an entry; ruk per step
    for (int e = tid; e < 2 * kChunk * kChunk; e += kBwdThreads) {
      const int m = e / (kChunk * kChunk), f = e - m * kChunk * kChunk;
      const int t = f / kChunk, s2 = f - t * kChunk;
      float acc = 0.f;
      if (m == 0) {
        if (s2 < t)
          for (int i = 0; i < Dh; ++i)
            acc = fmaf(sm[L.o_rp + t * L.ld + i], sm[L.o_kp + s2 * L.ld + i], acc);
        sm[L.o_a + t * L.ldc + s2] = acc;
      } else {
        for (int j = 0; j < Dh; ++j)
          acc = fmaf(sm[L.o_dy + t * L.ld + j], sm[L.o_v + s2 * L.ld + j], acc);
        sm[L.o_b + t * L.ldc + s2] = acc;
      }
    }
    for (int t = tid; t < kChunk; t += kBwdThreads) {
      float acc = 0.f;
      for (int i = 0; i < Dh; ++i)
        acc = fmaf(sm[L.o_r + t * L.ld + i] * sm[L.o_u + i], sm[L.o_k + t * L.ld + i], acc);
      sm[L.o_ruk + t] = acc;
    }
    __syncthreads();
    // dr, dk, dv: a thread an entry (t, i) of each
    for (int e = tid; e < kChunk * Dh; e += kBwdThreads) {
      const int t = e / Dh, i = e - t * Dh, o = t * L.ld + i;
      float x = 0.f, y = 0.f;
      for (int j = 0; j < Dh; ++j) {
        x = fmaf(S[i * L.ld + j], sm[L.o_dy + t * L.ld + j], x);
        y = fmaf(G[i * L.ld + j], sm[L.o_v + t * L.ld + j], y);
      }
      float xi = 0.f, yi = 0.f;
      for (int s2 = 0; s2 < t; ++s2)
        xi = fmaf(sm[L.o_b + t * L.ldc + s2], sm[L.o_kp + s2 * L.ld + i], xi);
      for (int s2 = t + 1; s2 < kChunk; ++s2)
        yi = fmaf(sm[L.o_b + s2 * L.ldc + t], sm[L.o_rp + s2 * L.ld + i], yi);
      const float drh = sm[L.o_ele + o] * (x + xi);
      const float dkh = sm[L.o_ekk + o] * y + sm[L.o_enl + o] * yi;
      const float vdy = sm[L.o_b + t * L.ldc + t];
      const float ru = sm[L.o_u + i] * vdy;
      sm[L.o_rd + o] = sm[L.o_r + o] * drh;
      sm[L.o_kd + o] = sm[L.o_k + o] * dkh;
      // dv[t, i] (i as the value column)
      float z = sm[L.o_ruk + t] * sm[L.o_dy + o];
      for (int d = 0; d < Dh; ++d) z = fmaf(sm[L.o_kk + t * L.ld + d], G[d * L.ld + i], z);
      for (int s2 = t + 1; s2 < kChunk; ++s2)
        z = fmaf(sm[L.o_a + s2 * L.ldc + t], sm[L.o_dy + s2 * L.ld + i], z);
      if (t < n_ok) {
        const size_t off = base + static_cast<size_t>(t) * rs + i;
        store_elem(static_cast<T*>(a.dr) + off, fmaf(ru, sm[L.o_k + o], drh));
        store_elem(static_cast<T*>(a.dk) + off, fmaf(ru, sm[L.o_r + o], dkh));
        store_elem(static_cast<T*>(a.dv) + off, z);
      }
    }
    __syncthreads();                         // every reader of G and S is done
    // dlogw by the reverse cumulative sum, and du, a thread a channel
    for (int i = tid; i < Dh; i += kBwdThreads) {
      float run = sm[L.o_p + i];
      for (int t = kChunk - 1; t >= 0; --t) {
        const float kd = sm[L.o_kd + t * L.ld + i];
        if (t < n_ok) a.dlogw[base + static_cast<size_t>(t) * rs + i] = run - kd;
        run = run - kd + sm[L.o_rd + t * L.ld + i];
        du_acc = fmaf(sm[L.o_r + t * L.ld + i] * sm[L.o_k + t * L.ld + i],
                      sm[L.o_b + t * L.ldc + t], du_acc);
      }
      sm[L.o_p + i] = run;
    }
    // the adjoint at the chunk's start
    for (int e = tid; e < DD; e += kBwdThreads) {
      const int i = e / Dh, j = e - i * Dh;
      float acc = sm[L.o_elast + i] * G[i * L.ld + j];
      for (int t = 0; t < kChunk; ++t)
        acc = fmaf(sm[L.o_rp + t * L.ld + i], sm[L.o_dy + t * L.ld + j], acc);
      G[i * L.ld + j] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < Dh; i += kBwdThreads) a.du_part[state_base / Dh + i] = du_acc;
  if (a.dstate0 != nullptr)
    for (int e = tid; e < DD; e += kBwdThreads) {
      const int i = e / Dh, j = e - i * Dh;
      a.dstate0[state_base + e] = G[i * L.ld + j];
    }
}

template <typename T>
cudaError_t bwd_launch(const BwdArgs& a, int B, cudaStream_t stream) {
  const int smem = BwdLayout(a.Dh).bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  wkv6_bwd_kernel<T><<<B * a.H, kBwdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

bool valid_split(int Dh, int NV) {
  return NV >= 1 && Dh % NV == 0 && (NV == 1 || (Dh / NV) % 8 == 0);
}

}  // namespace

extern "C" {

// r, k, v (B, T, H, Dh) bf16 (in_bf16 = 1) or float32; logw (B, T, H, Dh),
// u (H, Dh), state0 (B, H, Dh, Dh) or null (zeros), y (B, T, H, Dh) and
// state_out (B, H, Dh, Dh) float32, not aliasing state0. NV value slices of
// Dh / NV columns (a multiple of 8, or NV = 1); vec = 1 when every row of r,
// k, logw and of a v slice is a whole number of 16-byte pieces on 16-byte
// boundaries.
int wkv6_launch(const void* r, const void* k, const void* v, const float* logw,
                const float* u, const float* state0, float* y, float* state_out,
                int B, int T_len, int H, int Dh, int NV, int vec, int in_bf16,
                void* stream) {
  if (B < 1 || T_len < 1 || H < 1 || Dh < 4 || Dh % 4 != 0 || Dh > kMaxDh ||
      !valid_split(Dh, NV) || static_cast<long long>(B) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{r, k, v, logw, u, state0, y, state_out, T_len, H, Dh, Dh / NV, vec};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = in_bf16 ? launch<__nv_bfloat16>(a, B, NV, st) : launch<float>(a, B, NV, st);
  return static_cast<int>(e);
}

// The backward. r, k, v (B, T, H, Dh) bf16 (in_bf16 = 1) or float32;
// logw, dy (B, T, H, Dh), u (H, Dh), state0 and ds (B, H, Dh, Dh) or null
// (zeros) float32; scratch (B, H, ceil(T / 32), Dh, Dh) float32; dr, dk, dv
// in r's dtype, dlogw (B, T, H, Dh), du_part (B, H, Dh) float32, dstate0
// (B, H, Dh, Dh) float32 or null (not written). Dh a power of two, 4 to 64.
int wkv6_bwd_launch(const void* r, const void* k, const void* v, const float* logw,
                    const float* u, const float* state0, const float* dy, const float* ds,
                    float* scratch, void* dr, void* dk, void* dv, float* dlogw,
                    float* du_part, float* dstate0, int B, int T_len, int H, int Dh,
                    int in_bf16, void* stream) {
  if (B < 1 || T_len < 1 || H < 1 || Dh < 4 || Dh > 64 || (Dh & (Dh - 1)) != 0 ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{r, k, v, logw, u, state0, dy, ds, scratch, dr, dk, dv, dlogw, du_part,
                  dstate0, T_len, H, Dh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = in_bf16 ? bwd_launch<__nv_bfloat16>(a, B, st) : bwd_launch<float>(a, B, st);
  return static_cast<int>(e);
}

// Blocks of the kernel for head size Dh and value slices of VB columns that
// one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into
// *out.
int wkv6_max_active_blocks(int in_bf16, int Dh, int VB, int* out) {
  size_t smem = 0;
  cudaError_t e = in_bf16 ? prepare<__nv_bfloat16>(Dh, VB, &smem) : prepare<float>(Dh, VB, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = in_bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    out, wkv6_chunk_kernel<__nv_bfloat16>, kThreads, smem)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, wkv6_chunk_kernel<float>,
                                                              kThreads, smem);
  return static_cast<int>(e);
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
