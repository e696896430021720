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
// The value-column form: v may hold Dv < Dh columns of each head (a
// rank's share of a head under the "model" axis's head_dim fallback); the
// blocks then split those Dv columns (VB = Dv / NV), the state is (B, H, Dh,
// Dv) and y (B, T, H, Dv). Every block still scans all Dh key channels.
//
// Limits: Dh a multiple of 4 up to 128, Dv a multiple of 4 dividing Dh; r,
// k, v bf16 or float32 (one dtype); logw, u, the states and y float32.
//
// The backward (`wkv6_bwd_kernel`, entries `wkv6_bwd_launch` and
// `wkv6_bwd_max_active_clusters`) has no TPU counterpart: the reference
// differentiates its jnp `wkv_chunked` with jax.grad. It takes the
// forward's decomposition by value-column slices, with the NV blocks of a
// (b, h) in one thread-block cluster that sums the slices' partials of dr,
// dk, dlogw and du through distributed shared memory, and the forward's
// 3xTF32 products. It is described where it starts, below the forward.
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
  int T_len, H, Dh, Dv, VB, vec, vec_v;
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
  const int Dh = a.Dh, Dv = a.Dv, VB = a.VB;
  const int n_ok = min(kChunk, a.T_len - t0);
  if (a.vec) {
    // step t's row starts rs elements after step t - 1's; a step past T
    // copies nothing (from step t0's row) and zero-fills
    const size_t rs = static_cast<size_t>(a.H) * Dh;
    const size_t base = (static_cast<size_t>(b) * a.T_len + t0) * rs + static_cast<size_t>(h) * Dh;
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
  } else {
    for (int i = tid; i < kChunk * Dh; i += kThreads) {
      const int t = i / Dh, d = i - t * Dh;
      const bool ok = t0 + t < a.T_len;
      const size_t off = ((static_cast<size_t>(b) * a.T_len + t0 + t) * a.H + h) * Dh + d;
      reinterpret_cast<T*>(smem + L.o_r + t * L.raw_rk)[d] = ok ? r[off] : T(0.f);
      reinterpret_cast<T*>(smem + L.o_k + t * L.raw_rk)[d] = ok ? k[off] : T(0.f);
      reinterpret_cast<float*>(smem + L.o_l + t * L.raw_l)[d] = ok ? a.logw[off] : 0.f;
    }
  }
  // the block's v slice: rows of Dv columns (Dh, or the caller's value
  // columns), of which this block takes [j VB, (j + 1) VB)
  if (a.vec_v) {
    const size_t rsv = static_cast<size_t>(a.H) * Dv;
    const size_t base = (static_cast<size_t>(b) * a.T_len + t0) * rsv + static_cast<size_t>(h) * Dv;
    const int pv = VB * static_cast<int>(sizeof(T)) / 16;
    for (int i = tid; i < kChunk * pv; i += kThreads) {
      const int t = i / pv, p = i - t * pv;
      const size_t off = base + (t < n_ok ? t : 0) * rsv + j * VB;
      cp_async16(smem + L.o_v + t * L.raw_v + 16 * p, reinterpret_cast<const char*>(v + off) + 16 * p,
                 t < n_ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < kChunk * VB; i += kThreads) {
      const int t = i / VB, e = i - t * VB;
      const bool ok = t0 + t < a.T_len;
      const size_t off = ((static_cast<size_t>(b) * a.T_len + t0 + t) * a.H + h) * Dv + j * VB + e;
      reinterpret_cast<T*>(smem + L.o_v + t * L.raw_v)[e] = ok ? v[off] : T(0.f);
    }
  }
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_chunk_kernel(const Args a) {
  const int bh = blockIdx.x, j = blockIdx.y;
  const int b = bh / a.H, h = bh - (bh / a.H) * a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int Dh = a.Dh, Dv = a.Dv, VB = a.VB;
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
  const size_t state_base = static_cast<size_t>(bh) * Dh * Dv + j * VB;   // (d, e) at + d * Dv + e
  if (a.state0 != nullptr)
    for (int i = tid; i < Dh * VB; i += kThreads) {
      const int d = i / VB, e = i - d * VB;
      s_s[d * L.ld_v + e] = a.state0[state_base + static_cast<size_t>(d) * Dv + e];
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
    if (a.vec_v) {   // the v slice to float32, 16 bytes at a time
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
            float* yp = a.y + ((static_cast<size_t>(b) * a.T_len + t0 + row) * a.H + h) * Dv +
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
    a.state_out[state_base + static_cast<size_t>(d) * Dv + e] = s_s[d * L.ld_v + e];
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
// A chunk of C = 32 steps in the forward's rebased basis (l_inc, l_exc =
// l_inc - logw, l_tot = l_inc at the chunk's last step; r'' = r e^{l_exc -
// l_tot}, kk = k e^{l_tot - l_inc}, S_dec = diag(e^{l_tot}) S0; S0 and G
// the state and adjoint at the chunk's start and end; Bm = dy v^T):
//     A    = tril_strict(r'' kk^T) + diag(sum_i r u k)     (the forward's A)
//     X_r  = dy S_dec^T + tril_strict(Bm) kk,      dr^h = e^{l_exc - l_tot} X_r
//     X_k  = v G^T + tril_strict(Bm)^T r'',        dk^h = e^{l_tot - l_inc} X_k
//     dv   = kk G + A^T dy
//     G   <- diag(e^{l_tot}) (G + r''^T dy)        (the adjoint at the chunk's start)
// These are the reference's chunked products (e^{l_exc} (dy S0^T + tril(Bm)
// k'), e^{l_tot - l_inc} v G^T + e^{-l_inc} tril(Bm)^T r', with r' = r
// e^{l_exc}, k' = k e^{-l_inc}) with the factors e^{+-l_tot} moved between
// the operands, as in the forward: every operand stays inside float32's
// range because the caller keeps logw >= -2 (|l_tot| <= 64).
//
// What bounds it on this card: at rwkv6-3b's train microbatch (B=2, T=4096,
// H=40, Dh=64, bf16 r/k/v) the function must move 503 MB, 0.150 ms at 3.35
// TB/s; its 1.8e10 FLOP of products take ~0.04 ms at the TF32 tensor-core
// rate. Bytes bound it; the state scratch (below) adds 2 x 168 MB of its
// own.
//
// Design.
// * Blocks: grid (B * H, NV), VB = Dh / NV value columns a block. The state
//   S, the adjoint G and dv split exactly by value column (S[:, j] depends
//   only on v[:, j], G[:, j] only on dy[:, j]), so a block keeps only its
//   (Dh, VB) slices of S and G, in shared memory, for the whole sequence,
//   and writes its columns of dv. dr, dk, dlogw and du sum over value
//   columns: a block forms its slice's partials X_r, X_k (32 x Dh) and v.dy
//   (32) of a chunk, and the NV blocks of a (b, h), one thread-block
//   cluster, sum them through distributed shared memory: block j owns the
//   channels [j VB, (j + 1) VB), every block stores its partials of those
//   channels into block j's exchange buffer (a slot per rank, pairs of
//   floats from the products' registers), and block j adds the slots in
//   rank order, applies the factors and writes its channels of dr, dk and
//   dlogw once; it carries du of its channels. P is not carried across
//   chunks: at each chunk's end it is rowsum(G S) exactly (the adjoint just
//   updated, the next chunk's start state), its slice partials summed the
//   same way, so dlogw's reverse cumulative sum spans one chunk and its
//   rounding does not accumulate over the sequence (a carried P's errors
//   are shared by every earlier step of a channel, and the decay's
//   gradient sums them coherently over the tokens). The results are the same bits run to run, and no
//   partial goes to device memory. The plan (`bwd_plan` in
//   kernels/wkv6/wkv6.py) takes the largest NV whose B * H clusters the
//   card runs at once (cudaOccupancyMaxActiveClusters at this kernel's
//   shared memory): NV = 2 at rwkv6-3b's train shape (2 blocks an SM, ~105
//   KB of shared memory and <= 128 registers each; NV = 4 would need 3).
// * Pass 1 runs the state recurrence forward, S <- S_dec + kk^T v, and
//   writes each chunk's start state slice to `scratch` (B, H, ceil(T / 32),
//   Dh, Dh) float32; pass 2 takes the chunks in reverse, reads it back,
//   and carries G and P.
// * Every block recomputes the chunk's scan, rebasing and A from all Dh
//   channels (as the forward's blocks do): the scan is the forward's, a
//   warp four channels at a time with lane t on step t, an inclusive
//   shuffle scan for l_inc, __expf. Steps past T are zero (k = v = r = dy =
//   0, logw = 0: they neither add to the state nor decay it) and their
//   gradients are not written.
// * Loads: rows of r, k, logw (every channel) and of the block's v, dy
//   slices stream into raw buffers by 16-byte cp.async copies, steps past T
//   zero-filled through the copy's source size. Pass 1 keeps two raw
//   buffers (the second in shared memory that only pass 2 uses) and loads
//   chunk c + 1 while chunk c runs. In pass 2, chunk c - 1's r, k, logw are
//   issued once chunk c's scan has read them, its v, dy and start state once
//   chunk c's products are done. Rows that are not whole 16-byte pieces
//   take plain loads.
// * Products: mma.sync m16n8k8 3xTF32 with float32 sums (`mma3`); a bf16 v
//   is a TF32 number and its zero lo term is skipped. Operands are split
//   when their fragments are loaded, by `split_fin` (below). Each chunk of
//   pass 2 has two phases between barriers: phase 1 writes A and Bm
//   (strictly lower, v.dy apart) to shared memory and starts X_r, X_k and dv
//   in registers (dy S_dec^T, v G^T, kk G); phase 2 adds the triangle
//   products, writes dv, and updates G in place.
// * After phase 2 (and P's partials: one more barrier) a cluster barrier
//   publishes the partials; the owner sums them, runs dlogw's reverse
//   cumulative sum over the chunk with lane t on step t (shuffles, four
//   channels a warp at a time), and writes its channels. A second arrive tells the peers that the slots may be stored
//   again; they wait on it just before their next chunk's stores.
// * What bounds it now (PERF.md): instruction issue. Per chunk a block
//   splits ~2600 operand fragments and runs ~1400 mma.sync (counted from
//   this code at rwkv6-3b's shape); two blocks share an SM. Dh is a
//   template parameter (five instances a dtype) and every quotient by Dh,
//   VB or a row's size is a shift (all are powers of two).
//
// The value-column form (v of Dv < Dh columns, as the forward's): the NV
// blocks split the Dv value columns (VB = Dv / NV) and own Dh / NV key
// channels each (OW), which the exchange and the owner's sums take in place
// of VB; the state, its scratch and G are (Dh, Dv) a (b, h).
//
// Limits: Dh a power of two from 4 to 64, Dv a power of two from 4 to Dh,
// NV in value_splits(Dv) (at most 8, a cluster's portable size); r, k, v
// bf16 or float32 (one dtype; dr, dk, dv in it); logw, u, state0, dy, dS_T,
// dlogw, du and dstate0 float32.

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdMaxDh = 64;
// 16 x 8 tiles a warp holds across the chunk's middle barrier: of X_r and
// X_k (32 x Dh each) and of dv (32 x VB), 2 x 8 of each at Dh = 64
constexpr int kMaxXTiles = 2 * (kBwdMaxDh / 8) / kBwdWarps;

// Shared-memory layout of a backward block, for head size dh, value slice
// vb (= the channels it owns), nv slices and r, k, v elements of esize
// bytes. Offsets in bytes. Raw rows carry 16 bytes of padding (as the
// forward's); the rows of r'' and kk are 4 mod 8 floats (A operands), of S
// and G 8 or 24 mod 32 (B operands); the owner's arrays, read with lane t
// on step t, have odd rows. Pass 1 reads only k, logw and v, and keeps a
// second raw buffer of them (o_k1, o_l1, o_v1) where pass 2 keeps
// G, the exchange and the owner's arrays.
struct BwdLayout {
  int dhp, dhm, vbp;          // dh up to 8, dh up to 16, vb up to 8
  int ld_rk, ld_v, ld_o;
  int raw_rk, raw_l, raw_v, raw_dy;
  int o_r, o_k0, o_l0, o_v0, o_dy;                 // raw chunk
  int o_k1, o_l1, o_v1;                            // pass 1's second buffer
  int o_rp, o_kk, o_a, o_bm, o_s;
  int o_etot, o_u, o_dpart, o_vdyp, o_p, o_pn, o_du;
  int o_g, o_xr, o_xk, o_xv, o_xp, o_own;
  int bytes;
  __host__ __device__ BwdLayout(int dh, int vb, int ow, int nv, int esize) {
    dhp = round_up(dh, 8);
    dhm = round_up(dh, 16);
    vbp = round_up(vb, 8);
    ld_rk = dhm + 4;
    ld_v = (vbp % 32 == 8 || vbp % 32 == 24) ? vbp : vbp + 8;
    ld_o = ow + 1;
    raw_rk = round_up(dh * esize, 16) + 16;
    raw_l = round_up(dh * 4, 16) + 16;
    raw_v = round_up(vb * esize, 16) + 16;
    raw_dy = round_up(vb * 4, 16) + 16;
    int o = 0;
    o_r = o;  o += kChunk * raw_rk;
    o_k0 = o; o += kChunk * raw_rk;
    o_l0 = o; o += kChunk * raw_l;
    o_v0 = o; o += kChunk * raw_v;
    o_dy = o; o += kChunk * raw_dy;
    o_rp = o; o += 4 * kChunk * ld_rk;      // r'' (every channel)
    o_kk = o; o += 4 * kChunk * ld_rk;      // kk
    o_a = o;  o += 4 * kChunk * kLdA;       // A
    o_bm = o; o += 4 * kChunk * kLdA;       // tril_strict(Bm)
    o_s = o;  o += 4 * dhm * ld_v;          // S slice
    o_etot = o; o += 4 * dhm;
    o_u = o;  o += 4 * dhp;
    o_dpart = o; o += 4 * kBwdWarps * kChunk;
    o_vdyp = o; o += 4 * kChunk;            // this slice's v.dy
    o_p = o;  o += 4 * round_up(ow, 4);     // P of the owned channels
    o_pn = o; o += 4 * round_up(ow, 4);     // their P at the previous chunk's end
    o_du = o; o += 4 * round_up(ow, 4);     // du of the owned channels
    const int pass2 = o;
    o_g = o;  o += 4 * dhm * ld_v;          // G slice
    // the exchange, a slot per rank: X_r and X_k of the owned channels
    // (rows of ow floats), v.dy, and P at the previous chunk's end
    o_xr = o; o += 4 * nv * kChunk * ow;
    o_xk = o; o += 4 * nv * kChunk * ow;
    o_xv = o; o += 4 * nv * kChunk;
    o_xp = o; o += 4 * nv * round_up(ow, 4);   // and P's slice partials
    o_own = o; o += 4 * 4 * kChunk * ld_o;  // owned channels: r, k, e^{l_exc - l_tot}, e^{l_tot - l_inc}
    int p1 = pass2;
    o_k1 = p1; p1 += kChunk * raw_rk;
    o_l1 = p1; p1 += kChunk * raw_l;
    o_v1 = p1; p1 += kChunk * raw_v;
    bytes = o > p1 ? o : p1;
  }
  // raw buffer `buf` of k, logw, v
  __host__ __device__ int o_k(int buf) const { return buf ? o_k1 : o_k0; }
  __host__ __device__ int o_l(int buf) const { return buf ? o_l1 : o_l0; }
  __host__ __device__ int o_v(int buf) const { return buf ? o_v1 : o_v0; }
};

struct BwdArgs {
  const void* r; const void* k; const void* v; const float* logw; const float* u;
  const float* state0; const float* dy; const float* ds; float* scratch;
  void* dr; void* dk; void* dv; float* dlogw; float* du_part; float* dstate0;
  int T_len, H, Dh, Dv, VB, vec, vec_v;
};

// ---- the backward's operand loads (split on load) and products -----------
// The forward's split is cvt.rna.tf32.f32, which the compiler emulates with
// a test for infinity before each rounding. The backward is bound by
// instruction issue and splits ~2600 fragments a chunk, so it rounds the
// same way by integer steps: hi = the float32 bits plus half a TF32 ulp,
// cut to TF32 (round to nearest, ties away: cvt.rna's hi), lo = x - hi plus
// half an ulp, whose low 13 bits the tensor core does not read (cvt.rna's
// lo). For a finite x these are cvt.rna's TF32 values. A NaN with a full
// mantissa (the 0x7fffffff that CUDA's arithmetic makes) would carry into
// the sign and become a zero that drops out of every product, so hi is
// taken through fma(x, 0, hi): the same bits for a finite x (x * 0 is a
// zero of hi's sign), a NaN for a NaN or an infinity, whose lo then reads
// as -0 or is a NaN. Non-finite operands thus stay non-finite in the
// products, as with cvt.rna, for one instruction (a select on the exponent
// took three, and 12 % of the kernel's time).
__device__ __forceinline__ void split_fin(float x, uint32_t& hi, uint32_t& lo) {
  const float h = fmaf(x, 0.0f, __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u));
  hi = __float_as_uint(h);
  lo = __float_as_uint(x - h) + 0x1000u;
}
// The forward's load_a and load_b_kn (row-major A; B row-major by k) with
// split_fin.
__device__ __forceinline__ void load_a_fin(const float* p, int ld, int m0, int k0, int g, int q,
                                           Frag& f) {
  const float* r0 = p + (m0 + g) * ld + k0 + q;
  const float* r1 = r0 + 8 * ld;
  split_fin(r0[0], f.hi[0], f.lo[0]);
  split_fin(r1[0], f.hi[1], f.lo[1]);
  split_fin(r0[4], f.hi[2], f.lo[2]);
  split_fin(r1[4], f.hi[3], f.lo[3]);
}
__device__ __forceinline__ void load_b_kn_fin(const float* p, int ld, int k0, int n0, int g, int q,
                                              Frag& f) {
  const float* c = p + (k0 + q) * ld + n0 + g;
  split_fin(c[0], f.hi[0], f.lo[0]);
  split_fin(c[4 * ld], f.hi[1], f.lo[1]);
}
// A operand whose element (m, k) is stored at p[k * ld + m] (A = M^T).
__device__ __forceinline__ void load_at(const float* p, int ld, int m0, int k0, int g, int q,
                                        Frag& f) {
  const float* c0 = p + (k0 + q) * ld + m0 + g;
  const float* c1 = c0 + 4 * ld;
  split_fin(c0[0], f.hi[0], f.lo[0]);
  split_fin(c0[8], f.hi[1], f.lo[1]);
  split_fin(c1[0], f.hi[2], f.lo[2]);
  split_fin(c1[8], f.hi[3], f.lo[3]);
}
// B operand of a matrix stored row-major by n (B = M^T); with w, column n
// scaled by w[n] first (S_dec^T = (diag(e^{l_tot}) S)^T).
__device__ __forceinline__ void load_b_nk(const float* p, int ld, int n0, int k0, int g, int q,
                                          Frag& f) {
  const float* c = p + (n0 + g) * ld + k0 + q;
  split_fin(c[0], f.hi[0], f.lo[0]);
  split_fin(c[4], f.hi[1], f.lo[1]);
}
__device__ __forceinline__ void load_b_nk(const float* p, const float* w, int ld, int n0, int k0,
                                          int g, int q, Frag& f) {
  const float* c = p + (n0 + g) * ld + k0 + q;
  const float s = w[n0 + g];
  split_fin(s * c[0], f.hi[0], f.lo[0]);
  split_fin(s * c[4], f.hi[1], f.lo[1]);
}
// An element of a raw row (v) as a fragment entry: a bf16 is a TF32
// number, its hi the bits and its lo zero (never read: mma3 and
// mma3_a_exact skip it).
__device__ __forceinline__ void frag_elem(float x, uint32_t& hi, uint32_t& lo) { split_fin(x, hi, lo); }
__device__ __forceinline__ void frag_elem(__nv_bfloat16 x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(__bfloat162float(x));
  lo = 0u;
}
// A operand (rows m0.., depth k0..) and B operands (row-major by k, or by n)
// of the raw rows at `raw`, `stride` bytes apart, of elements T.
template <typename T>
__device__ __forceinline__ void load_a_raw(const char* raw, int stride, int m0, int k0, int g,
                                           int q, Frag& f) {
  const T* r0 = reinterpret_cast<const T*>(raw + (m0 + g) * stride) + k0 + q;
  const T* r1 = reinterpret_cast<const T*>(raw + (m0 + g + 8) * stride) + k0 + q;
  frag_elem(r0[0], f.hi[0], f.lo[0]);
  frag_elem(r1[0], f.hi[1], f.lo[1]);
  frag_elem(r0[4], f.hi[2], f.lo[2]);
  frag_elem(r1[4], f.hi[3], f.lo[3]);
}
template <typename T>
__device__ __forceinline__ void load_b_kn_raw(const char* raw, int stride, int k0, int n0, int g,
                                              int q, Frag& f) {
  frag_elem(reinterpret_cast<const T*>(raw + (k0 + q) * stride)[n0 + g], f.hi[0], f.lo[0]);
  frag_elem(reinterpret_cast<const T*>(raw + (k0 + q + 4) * stride)[n0 + g], f.hi[1], f.lo[1]);
}
template <typename T>
__device__ __forceinline__ void load_b_nk_raw(const char* raw, int stride, int n0, int k0, int g,
                                              int q, Frag& f) {
  const T* c = reinterpret_cast<const T*>(raw + (n0 + g) * stride) + k0 + q;
  frag_elem(c[0], f.hi[0], f.lo[0]);
  frag_elem(c[4], f.hi[1], f.lo[1]);
}
// c += a b in 3xTF32 with a TF32 number as A (v from bf16 in v G^T): its
// lo is zero, a.lo * b.hi is skipped.
__device__ __forceinline__ void mma3_a_exact(float c[4], const Frag& a, const Frag& b) {
  mma(c, a.hi, b.lo);
  mma(c, a.hi, b.hi);
}

// ---- the cluster: rank, barrier halves, stores into a peer's shared memory
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}
// every thread of the cluster's blocks: the shared-memory writes before an
// arrive are seen after the wait that follows it, in any rank
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// the shared::cluster address, in block `rank`, of this block's shared
// address `addr`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// v, or (v0, v1), into a block of the cluster at the shared::cluster
// address `addr`
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float v0, float v1) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(v0), "f"(v1)
               : "memory");
}

// ---- loads ------------------------------------------------------------------
// n_rows rows of `bytes` bytes (a power of two of 16-byte pieces), row t from src + t *
// src_stride to dst + t * dst_stride, by cp.async; rows t >= n_ok
// zero-filled (a source size of 0, from row 0).
__device__ __forceinline__ void bwd_copy_rows(char* dst, int dst_stride, const char* src, size_t src_stride,
                              int bytes, int n_rows, int n_ok) {
  const int pieces = bytes / 16, sh = __ffs(pieces) - 1;   // a power of two
  for (int i = threadIdx.x; i < n_rows * pieces; i += kBwdThreads) {
    const int t = i >> sh, p = i & (pieces - 1);
    const bool ok = t < n_ok;
    cp_async16(dst + t * dst_stride + 16 * p, src + static_cast<size_t>(ok ? t : 0) * src_stride + 16 * p,
               ok ? 16 : 0);
  }
}
// The same by plain loads, n elements a row (a power of two).
template <typename T>
__device__ __forceinline__ void bwd_plain_rows(char* dst, int dst_stride, const T* src, size_t src_stride, int n,
                               int n_ok) {
  const int sh = __ffs(n) - 1;                                // n a power of two
  for (int i = threadIdx.x; i < kChunk * n; i += kBwdThreads) {
    const int t = i >> sh, e = i & (n - 1);
    reinterpret_cast<T*>(dst + t * dst_stride)[e] = t < n_ok ? src[t * src_stride + e] : T(0.f);
  }
}

// A chunk's rows of k and logw (every channel) into raw buffer `buf`, and
// in pass 2 (with_r) of r; `row` is the element of (b, t0, h, 0), rs a
// step's row.
template <typename T, int Dh>
__device__ __forceinline__ void bwd_load_rkl(const BwdArgs& a, const BwdLayout& L, char* smem, size_t row,
                             size_t rs, int n_ok, int buf, bool with_r) {
  const T* r = static_cast<const T*>(a.r) + row;
  const T* k = static_cast<const T*>(a.k) + row;
  const int es = static_cast<int>(sizeof(T));
  if (a.vec) {
    if (with_r)
      bwd_copy_rows(smem + L.o_r, L.raw_rk, reinterpret_cast<const char*>(r), rs * es, Dh * es,
                    kChunk, n_ok);
    bwd_copy_rows(smem + L.o_k(buf), L.raw_rk, reinterpret_cast<const char*>(k), rs * es,
                  Dh * es, kChunk, n_ok);
    bwd_copy_rows(smem + L.o_l(buf), L.raw_l, reinterpret_cast<const char*>(a.logw + row),
                  rs * 4, Dh * 4, kChunk, n_ok);
  } else {
    if (with_r) bwd_plain_rows<T>(smem + L.o_r, L.raw_rk, r, rs, Dh, n_ok);
    bwd_plain_rows<T>(smem + L.o_k(buf), L.raw_rk, k, rs, Dh, n_ok);
    bwd_plain_rows<float>(smem + L.o_l(buf), L.raw_l, a.logw + row, rs, Dh, n_ok);
  }
  cp_async_commit();
}

// A chunk's rows of the block's v slice into raw buffer `buf` and, in pass
// 2 (s0 given), of its dy slice, and its start state slice (Dh rows of VB
// floats, row stride Dv) into S. `row` is the element of (b, t0, h, lo) in
// the (B, T, H, Dv) layout of v and dy, rs a step's row there.
template <typename T, int Dh>
__device__ __forceinline__ void bwd_load_vdy(const BwdArgs& a, const BwdLayout& L, char* smem, size_t row,
                             size_t rs, int n_ok, int buf, const float* s0) {
  const T* v = static_cast<const T*>(a.v) + row;
  const int es = static_cast<int>(sizeof(T));
  if (a.vec_v) {
    bwd_copy_rows(smem + L.o_v(buf), L.raw_v, reinterpret_cast<const char*>(v), rs * es,
                  a.VB * es, kChunk, n_ok);
    if (s0 != nullptr)
      bwd_copy_rows(smem + L.o_dy, L.raw_dy, reinterpret_cast<const char*>(a.dy + row), rs * 4,
                    a.VB * 4, kChunk, n_ok);
  } else {
    bwd_plain_rows<T>(smem + L.o_v(buf), L.raw_v, v, rs, a.VB, n_ok);
    if (s0 != nullptr) bwd_plain_rows<float>(smem + L.o_dy, L.raw_dy, a.dy + row, rs, a.VB, n_ok);
  }
  if (s0 != nullptr)
    bwd_copy_rows(smem + L.o_s, 4 * L.ld_v, reinterpret_cast<const char*>(s0),
                  4 * static_cast<size_t>(a.Dv), a.VB * 4, Dh, Dh);
  cp_async_commit();
}

// The chunk's cumulative log-decay, as the forward's scan: a warp four
// channels at a time, lane t on step t, an inclusive shuffle scan. Writes
// kk = k e^{l_tot - l_inc} and e^{l_tot} of every channel; with R (pass 2)
// also r'' = r e^{l_exc - l_tot}, the warp's partial of the u bonus
// sum_i r u k, and the owned channels' (ow from lo) r, k and two factors.
template <typename T, bool R>
__device__ __forceinline__ void bwd_scan(const BwdLayout& L, char* smem, int Dh, int lo, int ow, int buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* rp_s = reinterpret_cast<float*>(smem + L.o_rp);
  float* kk_s = reinterpret_cast<float*>(smem + L.o_kk);
  float* etot_s = reinterpret_cast<float*>(smem + L.o_etot);
  const float* u_s = reinterpret_cast<const float*>(smem + L.o_u);
  float* own = reinterpret_cast<float*>(smem + L.o_own);
  const int os = kChunk * L.ld_o;              // one owned array
  float dacc = 0.f;
  for (int g4 = warp; g4 < Dh / 4; g4 += kBwdWarps) {
    const int d = 4 * g4;
    float lw[4], k4[4], r4[4] = {0.f, 0.f, 0.f, 0.f};
    load4(reinterpret_cast<const float*>(smem + L.o_l(buf) + lane * L.raw_l) + d, lw);
    load4(reinterpret_cast<const T*>(smem + L.o_k(buf) + lane * L.raw_rk) + d, k4);
    if constexpr (R) load4(reinterpret_cast<const T*>(smem + L.o_r + lane * L.raw_rk) + d, r4);
    float inc[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) inc[q] = lw[q];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float n = __shfl_up_sync(0xffffffffu, inc[q], off);
        if (lane >= off) inc[q] += n;
      }
    float kk4[4], rp4[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float tot = __shfl_sync(0xffffffffu, inc[q], 31);
      const float ekk = __expf(tot - inc[q]);
      kk4[q] = k4[q] * ekk;
      if (lane == 0) etot_s[d + q] = __expf(tot);
      if constexpr (R) {
        const float erp = __expf((inc[q] - lw[q]) - tot);
        rp4[q] = r4[q] * erp;
        dacc = fmaf(r4[q] * u_s[d + q], k4[q], dacc);
        const int il = d + q - lo;
        if (il >= 0 && il < ow) {
          const int o = lane * L.ld_o + il;
          own[o] = r4[q];
          own[os + o] = k4[q];
          own[2 * os + o] = erp;
          own[3 * os + o] = ekk;
        }
      }
    }
    *reinterpret_cast<float4*>(kk_s + lane * L.ld_rk + d) = make_float4(kk4[0], kk4[1], kk4[2], kk4[3]);
    if constexpr (R)
      *reinterpret_cast<float4*>(rp_s + lane * L.ld_rk + d) = make_float4(rp4[0], rp4[1], rp4[2], rp4[3]);
  }
  if constexpr (R) reinterpret_cast<float*>(smem + L.o_dpart)[warp * kChunk + lane] = dacc;
}

// M <- diag(e^{l_tot}) (M + P^T Q) (ADD_FIRST: G's update) or diag(e^{l_tot})
// M + P^T Q (S's), in place, for M (Dh, VB) in shared memory, P (32, Dh) the
// float32 rows at `p` and Q the chunk's rows of Q_T elements at `q`: 16 x 8
// tiles of M, two a warp at a time (their products interleaved).
template <typename Q_T, bool ADD_FIRST>
__device__ __forceinline__ void bwd_state_update(const BwdLayout& L, float* m, const float* p, const float* etot,
                                 const char* q, int q_stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  constexpr bool kQExact = sizeof(Q_T) == 2;
  const int n_tiles = (L.dhm / 16) * (L.vbp / 8), tsh = __ffs(L.vbp / 8) - 1;
  for (int tile0 = warp; tile0 < n_tiles; tile0 += 2 * kBwdWarps) {
    float* mp[2][2];
    float w[2][2], acc[2][4];
    int tm[2], tn[2];
    bool on[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tile = tile0 + i * kBwdWarps;
      on[i] = tile < n_tiles;
      const int tt = on[i] ? tile : tile0;
      tm[i] = tt >> tsh;
      tn[i] = tt & (L.vbp / 8 - 1);
      const int d0 = 16 * tm[i] + g, e0 = 8 * tn[i] + 2 * tq;
      mp[i][0] = m + d0 * L.ld_v + e0;
      mp[i][1] = m + (d0 + 8) * L.ld_v + e0;
      w[i][0] = etot[d0];
      w[i][1] = etot[d0 + 8];
      acc[i][0] = mp[i][0][0]; acc[i][1] = mp[i][0][1];
      acc[i][2] = mp[i][1][0]; acc[i][3] = mp[i][1][1];
      if constexpr (!ADD_FIRST) {
        acc[i][0] *= w[i][0]; acc[i][1] *= w[i][0]; acc[i][2] *= w[i][1]; acc[i][3] *= w[i][1];
      }
    }
#pragma unroll
    for (int s = 0; s < kChunk / 8; ++s)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (on[i]) {
          Frag fa, fb;
          load_at(p, L.ld_rk, 16 * tm[i], 8 * s, g, tq, fa);
          load_b_kn_raw<Q_T>(q, q_stride, 8 * s, 8 * tn[i], g, tq, fb);
          mma3(acc[i], fa, fb, kQExact);
        }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (on[i]) {
        if constexpr (ADD_FIRST) {
          acc[i][0] *= w[i][0]; acc[i][1] *= w[i][0]; acc[i][2] *= w[i][1]; acc[i][3] *= w[i][1];
        }
        mp[i][0][0] = acc[i][0]; mp[i][0][1] = acc[i][1];
        mp[i][1][0] = acc[i][2]; mp[i][1][1] = acc[i][3];
      }
  }
}

// c += a b in 3xTF32 into two accumulators (the two small terms, the
// large one): the chains of one tile's products are half as long. The
// caller adds them when the tile is done.
__device__ __forceinline__ void mma3_split(float hi[4], float lo[4], const Frag& a, const Frag& b,
                                           bool b_exact) {
  mma(lo, a.lo, b.hi);
  if (!b_exact) mma(lo, a.hi, b.lo);
  mma(hi, a.hi, b.hi);
}

// (x, y) as the two elements at p (8 bytes aligned: a pair of channels)
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename T, int Dh>
__global__ void __launch_bounds__(kBwdThreads, 2)
wkv6_bwd_kernel(const BwdArgs a) {
  const int bh = blockIdx.x, j = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  // Dh, Dv, VB and OW are powers of two: their quotients are shifts. The
  // block's value columns are [lo, lo + VB) of Dv; the channels it owns
  // (sums of dr, dk, dlogw, du) [lo_o, lo_o + OW) of Dh.
  const int Dv = a.Dv, VB = a.VB, vsh = __ffs(VB) - 1, NV = Dv >> vsh, lo = j * VB;
  const int OW = Dh / NV, osh = __ffs(OW) - 1, lo_o = j * OW;
  const int rank = cluster_rank();             // == j: the cluster spans the NV slices
  const BwdLayout L(Dh, VB, OW, NV, static_cast<int>(sizeof(T)));
  constexpr bool kVExact = sizeof(T) == 2;     // bf16 v is a TF32 number

  extern __shared__ __align__(16) char smem[];
  float* rp_s = reinterpret_cast<float*>(smem + L.o_rp);     // (C, ld_rk) r''
  float* kk_s = reinterpret_cast<float*>(smem + L.o_kk);     // (C, ld_rk) kk
  float* a_s = reinterpret_cast<float*>(smem + L.o_a);       // (C, kLdA) A
  float* bm_s = reinterpret_cast<float*>(smem + L.o_bm);     // (C, kLdA) tril_strict(Bm)
  float* s_s = reinterpret_cast<float*>(smem + L.o_s);       // (dhm, ld_v) S slice
  float* g_s = reinterpret_cast<float*>(smem + L.o_g);       // (dhm, ld_v) G slice
  float* xr_s = reinterpret_cast<float*>(smem + L.o_xr);     // (NV, C, OW) exchange
  float* xk_s = reinterpret_cast<float*>(smem + L.o_xk);     // (NV, C, OW)
  float* xv_s = reinterpret_cast<float*>(smem + L.o_xv);     // (NV, C)
  float* xp_s = reinterpret_cast<float*>(smem + L.o_xp);     // (NV, OW)
  float* own = reinterpret_cast<float*>(smem + L.o_own);     // 4 x (C, ld_o)
  float* etot_s = reinterpret_cast<float*>(smem + L.o_etot);
  float* u_s = reinterpret_cast<float*>(smem + L.o_u);
  float* dpart_s = reinterpret_cast<float*>(smem + L.o_dpart);
  float* vdyp_s = reinterpret_cast<float*>(smem + L.o_vdyp);
  float* p_s = reinterpret_cast<float*>(smem + L.o_p);
  float* pn_s = reinterpret_cast<float*>(smem + L.o_pn);
  float* du_s = reinterpret_cast<float*>(smem + L.o_du);
  const float* dy_s = reinterpret_cast<const float*>(smem + L.o_dy);   // raw dy rows: float32
  const int ldy = L.raw_dy / 4;
  const int os = kChunk * L.ld_o;
  const uint32_t xr_addr = static_cast<uint32_t>(__cvta_generic_to_shared(xr_s));
  const uint32_t xk_addr = static_cast<uint32_t>(__cvta_generic_to_shared(xk_s));
  const uint32_t xv_addr = static_cast<uint32_t>(__cvta_generic_to_shared(xv_s));
  const uint32_t xp_addr = static_cast<uint32_t>(__cvta_generic_to_shared(xp_s));

  // everything starts at zero: padded channels, columns and steps stay zero
  for (int i = tid; i < L.bytes / 4; i += kBwdThreads) reinterpret_cast<float*>(smem)[i] = 0.f;
  __syncthreads();
  const size_t DD = static_cast<size_t>(Dh) * Dv;                 // a (b, h)'s state
  const size_t state_base = static_cast<size_t>(bh) * DD + lo;   // (i, e) at + i * Dv + e
  if (a.state0 != nullptr)
    for (int i = tid; i < Dh * VB; i += kBwdThreads) {
      const int d = i >> vsh, e = i & (VB - 1);
      s_s[d * L.ld_v + e] = a.state0[state_base + static_cast<size_t>(d) * Dv + e];
    }
  for (int d = tid; d < Dh; d += kBwdThreads) u_s[d] = a.u[h * Dh + d];
  const size_t rs = static_cast<size_t>(a.H) * Dh;                 // one step's row: r, k, logw
  const size_t rsv = static_cast<size_t>(a.H) * Dv;                // v, dy, dv
  const size_t row0 = static_cast<size_t>(b) * a.T_len * rs + static_cast<size_t>(h) * Dh;
  const size_t row0v = static_cast<size_t>(b) * a.T_len * rsv + static_cast<size_t>(h) * Dv;
  const int n_chunks = (a.T_len + kChunk - 1) / kChunk;
  float* scratch = a.scratch + static_cast<size_t>(bh) * n_chunks * DD + lo;

  // Pass 1: the state forward; each chunk's start state slice to scratch,
  // S_T left in S. Chunk c + 1 streams into the other raw buffer while
  // chunk c runs.
  bwd_load_rkl<T, Dh>(a, L, smem, row0, rs, min(kChunk, a.T_len), 0, false);
  bwd_load_vdy<T, Dh>(a, L, smem, row0v + lo, rsv, min(kChunk, a.T_len), 0, nullptr);
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk c is in; chunk c - 1 is done, its buffer free
    if (c + 1 < n_chunks) {
      const int t1 = (c + 1) * kChunk, n1 = min(kChunk, a.T_len - t1);
      bwd_load_rkl<T, Dh>(a, L, smem, row0 + t1 * rs, rs, n1, buf ^ 1, false);
      bwd_load_vdy<T, Dh>(a, L, smem, row0v + t1 * rsv + lo, rsv, n1, buf ^ 1, nullptr);
    }
    for (int i = tid; i < Dh * VB; i += kBwdThreads) {
      const int d = i >> vsh, e = i & (VB - 1);
      scratch[static_cast<size_t>(c) * DD + static_cast<size_t>(d) * Dv + e] = s_s[d * L.ld_v + e];
    }
    bwd_scan<T, false>(L, smem, Dh, lo_o, OW, buf);
    __syncthreads();  // kk and e^{l_tot} are in; S is stored
    bwd_state_update<T, false>(L, s_s, kk_s, etot_s, smem + L.o_v(buf), L.raw_v);
  }
  // S_T is in, and every block of the cluster is done with pass 1: its
  // second raw buffer (where the exchange lies) is free for the peers'
  // stores below
  cluster_arrive();
  cluster_wait();

  // G = dS_T (over the whole region: pass 1's buffer left it dirty), and
  // P_T = rowsum(S_T dS_T): the slices' partials of each channel stored
  // into its owner's slots, summed there in rank order.
  for (int i = tid; i < L.dhm * L.ld_v; i += kBwdThreads) {
    const int d = i / L.ld_v, e = i - d * L.ld_v;
    g_s[i] = a.ds != nullptr && d < Dh && e < VB
                 ? a.ds[state_base + static_cast<size_t>(d) * Dv + e] : 0.f;
  }
  __syncthreads();
  for (int d = tid; d < Dh; d += kBwdThreads) {
    float p = 0.f;
    for (int e = 0; e < VB; ++e) p = fmaf(s_s[d * L.ld_v + e], g_s[d * L.ld_v + e], p);
    const int q = d >> osh;
    st_cluster(map_rank(xr_addr + 4 * (rank * kChunk * OW + d - q * OW), q), p);
  }
  cluster_arrive();
  cluster_wait();
  for (int il = tid; il < OW; il += kBwdThreads) {
    float p = 0.f;
    for (int q = 0; q < NV; ++q) p += xr_s[q * kChunk * OW + il];
    p_s[il] = p;
    du_s[il] = 0.f;
  }
  cluster_arrive();   // the slots are read: the peers may store the next partials

  // Pass 2: the chunks in reverse, carrying G, and P and du of the owned
  // channels.
  {
    const int c = n_chunks - 1, t0 = c * kChunk;
    bwd_load_rkl<T, Dh>(a, L, smem, row0 + t0 * rs, rs, a.T_len - t0, 0, true);
    bwd_load_vdy<T, Dh>(a, L, smem, row0v + t0 * rsv + lo, rsv, a.T_len - t0, 0,
                    a.scratch + (static_cast<size_t>(bh) * n_chunks + c) * DD + lo);
  }
  const int ti = warp & 1;                     // the row block of every tile of this warp
  const int n_xt = 2 * (L.dhp / 8), n_dvt = 2 * (L.vbp / 8);
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, n_ok = min(kChunk, a.T_len - t0);
    const size_t row = row0 + static_cast<size_t>(t0) * rs;
    const size_t rowv = row0v + static_cast<size_t>(t0) * rsv;
    cp_async_wait_all();
    __syncthreads();  // chunk c is in; chunk c + 1 is done
    bwd_scan<T, true>(L, smem, Dh, lo_o, OW, 0);
    __syncthreads();  // r'', kk, the factors are in; the raw r, k, logw are free
    if (c > 0) bwd_load_rkl<T, Dh>(a, L, smem, row - kChunk * rs, rs, kChunk, 0, true);

    // Phase 1. A = tril_strict(r'' kk^T) + diag(sum_i r u k) and Bm = dy
    // v^T (strictly lower; its diagonal v.dy to vdyp) into shared memory,
    // twelve 16 x 8 tiles of the lower halves; in registers X_r = dy
    // S_dec^T, X_k = v G^T and dv = kk G.
    for (int p = warp; p < 12; p += kBwdWarps) {
      const int pp = p < 6 ? p : p - 6;
      const int mi = pp < 2 ? 0 : 1, nj = pp < 2 ? pp : pp - 2;
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, acc_lo[4] = {0.f, 0.f, 0.f, 0.f};
      if (p < 6) {
#pragma unroll 4
        for (int s = 0; s < L.dhp / 8; ++s) {
          Frag fa, fb;
          load_a_fin(rp_s, L.ld_rk, 16 * mi, 8 * s, g, tq, fa);
          load_b_nk(kk_s, L.ld_rk, 8 * nj, 8 * s, g, tq, fb);
          mma3_split(acc, acc_lo, fa, fb, false);
        }
      } else {
#pragma unroll 2
        for (int s = 0; s < L.vbp / 8; ++s) {
          Frag fa, fb;
          load_a_fin(dy_s, ldy, 16 * mi, 8 * s, g, tq, fa);
          load_b_nk_raw<T>(smem + L.o_v0, L.raw_v, 8 * nj, 8 * s, g, tq, fb);
          mma3_split(acc, acc_lo, fa, fb, kVExact);
        }
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float val = acc[x] + acc_lo[x];
        const int rw = 16 * mi + g + (x >> 1) * 8, col = 8 * nj + 2 * tq + (x & 1);
        if (p < 6) {
          float dg = 0.f;
          if (col == rw)
            for (int w = 0; w < kBwdWarps; ++w) dg += dpart_s[w * kChunk + rw];
          a_s[rw * kLdA + col] = col < rw ? val : dg;
        } else {
          bm_s[rw * kLdA + col] = col < rw ? val : 0.f;
          if (col == rw) vdyp_s[rw] = val;
        }
      }
    }
    float xr[kMaxXTiles][4], xk[kMaxXTiles][4], dv[kMaxXTiles][4];
#pragma unroll
    for (int i = 0; i < kMaxXTiles; ++i)
#pragma unroll
      for (int x = 0; x < 4; ++x) xr[i][x] = xk[i][x] = dv[i][x] = 0.f;
    if (warp < n_xt) {
#pragma unroll 2
      for (int s = 0; s < L.vbp / 8; ++s) {
        Frag fdy, fv;
        load_a_fin(dy_s, ldy, 16 * ti, 8 * s, g, tq, fdy);
        load_a_raw<T>(smem + L.o_v0, L.raw_v, 16 * ti, 8 * s, g, tq, fv);
#pragma unroll
        for (int i = 0; i < kMaxXTiles; ++i) {
          const int tn = (warp + i * kBwdWarps) >> 1;
          if (warp + i * kBwdWarps < n_xt) {
            Frag fb;
            load_b_nk(s_s, etot_s, L.ld_v, 8 * tn, 8 * s, g, tq, fb);    // S_dec^T
            mma3(xr[i], fdy, fb, false);
            load_b_nk(g_s, L.ld_v, 8 * tn, 8 * s, g, tq, fb);            // G^T
            if constexpr (kVExact) mma3_a_exact(xk[i], fv, fb);
            else mma3(xk[i], fv, fb, false);
          }
        }
      }
    }
    if (warp < n_dvt) {
      float dv_lo[kMaxXTiles][4];
#pragma unroll
      for (int i = 0; i < kMaxXTiles; ++i)
#pragma unroll
        for (int x = 0; x < 4; ++x) dv_lo[i][x] = 0.f;
#pragma unroll 2
      for (int s = 0; s < L.dhp / 8; ++s) {
        Frag fa;
        load_a_fin(kk_s, L.ld_rk, 16 * ti, 8 * s, g, tq, fa);
#pragma unroll
        for (int i = 0; i < kMaxXTiles; ++i) {
          const int tn = (warp + i * kBwdWarps) >> 1;
          if (warp + i * kBwdWarps < n_dvt) {
            Frag fb;
            load_b_kn_fin(g_s, L.ld_v, 8 * s, 8 * tn, g, tq, fb);
            mma3_split(dv[i], dv_lo[i], fa, fb, false);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxXTiles; ++i)
#pragma unroll
        for (int x = 0; x < 4; ++x) dv[i][x] += dv_lo[i][x];
    }
    __syncthreads();  // A, Bm and v.dy are written; every reader of S and G is done

    // Phase 2. X_r += tril_strict(Bm) kk (steps s < t: the first 16 rows
    // need the first two k-steps), X_k += tril_strict(Bm)^T r'' (s > t),
    // dv += A^T dy (s >= t), written out; G updated in place.
    if (warp < n_xt) {
#pragma unroll
      for (int s = 0; s < kChunk / 8; ++s) {
        const bool lower = s < 2 * ti + 2, upper = s >= 2 * ti;
        Frag fbm, fbt;
        if (lower) load_a_fin(bm_s, kLdA, 16 * ti, 8 * s, g, tq, fbm);
        if (upper) load_at(bm_s, kLdA, 16 * ti, 8 * s, g, tq, fbt);
#pragma unroll
        for (int i = 0; i < kMaxXTiles; ++i) {
          const int tn = (warp + i * kBwdWarps) >> 1;
          if (warp + i * kBwdWarps < n_xt) {
            Frag fb;
            if (lower) {
              load_b_kn_fin(kk_s, L.ld_rk, 8 * s, 8 * tn, g, tq, fb);
              mma3(xr[i], fbm, fb, false);
            }
            if (upper) {
              load_b_kn_fin(rp_s, L.ld_rk, 8 * s, 8 * tn, g, tq, fb);
              mma3(xk[i], fbt, fb, false);
            }
          }
        }
      }
    }
    if (warp < n_dvt) {
#pragma unroll
      for (int s = 0; s < kChunk / 8; ++s) {
        if (s < 2 * ti) continue;
        Frag fa;
        load_at(a_s, kLdA, 16 * ti, 8 * s, g, tq, fa);
#pragma unroll
        for (int i = 0; i < kMaxXTiles; ++i) {
          const int tn = (warp + i * kBwdWarps) >> 1;
          if (warp + i * kBwdWarps < n_dvt) {
            Frag fb;
            load_b_kn_fin(dy_s, ldy, 8 * s, 8 * tn, g, tq, fb);
            mma3(dv[i], fa, fb, false);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxXTiles; ++i) {
        const int tn = (warp + i * kBwdWarps) >> 1;
        if (warp + i * kBwdWarps < n_dvt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int t = 16 * ti + g + 8 * half, col = 8 * tn + 2 * tq;
            if (t < n_ok && col < VB) {
              T* dvp = static_cast<T*>(a.dv) + rowv + static_cast<size_t>(t) * rsv + lo + col;
              store_pair(dvp, dv[i][2 * half], dv[i][2 * half + 1]);
            }
          }
      }
    }
    bwd_state_update<float, true>(L, g_s, rp_s, etot_s, smem + L.o_dy, L.raw_dy);
    // P at chunk c - 1's end, exactly: rowsum(G S) of this slice, G the
    // adjoint just updated, S chunk c's start state (a thread a channel)
    float pe = 0.f;
    if (c > 0) {
      __syncthreads();  // G is updated
      if (tid < Dh)
        for (int e = 0; e < VB; ++e) pe = fmaf(g_s[tid * L.ld_v + e], s_s[tid * L.ld_v + e], pe);
    }

    // The partials of the owned channels into their owners' slots (a 16 x 8
    // tile lies in one owner's channels; a lane stores pairs of channels),
    // once every owner has read the last chunk's.
    cluster_wait();
#pragma unroll
    for (int i = 0; i < kMaxXTiles; ++i) {
      const int tn = (warp + i * kBwdWarps) >> 1;
      if (warp + i * kBwdWarps < n_xt && 8 * tn + 2 * tq < Dh) {
        const int q = (8 * tn) >> osh, il = 8 * tn + 2 * tq - q * OW;
        const int at = 4 * ((rank * kChunk + 16 * ti + g) * OW + il);
        const uint32_t r_at = map_rank(xr_addr + at, q), k_at = map_rank(xk_addr + at, q);
        st_cluster(r_at, xr[i][0], xr[i][1]);
        st_cluster(r_at + 32 * OW, xr[i][2], xr[i][3]);        // row + 8
        st_cluster(k_at, xk[i][0], xk[i][1]);
        st_cluster(k_at + 32 * OW, xk[i][2], xk[i][3]);
      }
    }
    for (int i = tid; i < kChunk * NV; i += kBwdThreads) {
      const int q = i >> 5, t = i & (kChunk - 1);
      st_cluster(map_rank(xv_addr + 4 * (rank * kChunk + t), q), vdyp_s[t]);
    }
    if (c > 0 && tid < Dh) {
      const int q = tid >> osh;
      st_cluster(map_rank(xp_addr + 4 * (rank * OW + tid - q * OW), q), pe);
    }
    cluster_arrive();
    cluster_wait();   // every slice's partials are in; this block is done with r, S, v, dy
    if (c > 0)
      bwd_load_vdy<T, Dh>(a, L, smem, rowv - kChunk * rsv + lo, rsv, kChunk, 0,
                      a.scratch + (static_cast<size_t>(bh) * n_chunks + c - 1) * DD + lo);

    // The owned channels, two a thread: the slots summed in rank order; dr,
    // dk written; x = k dk^h - r dr^h, k dk^h and du's term r k v.dy kept
    // for the scan.
    for (int e = tid; e < kChunk * OW / 2; e += kBwdThreads) {
      const int t = e >> (osh - 1), il = 2 * (e & (OW / 2 - 1));
      float2 sxr = make_float2(0.f, 0.f), sxk = make_float2(0.f, 0.f);
      float vdy = 0.f;
      for (int q = 0; q < NV; ++q) {
        const float2 xr2 = *reinterpret_cast<const float2*>(xr_s + (q * kChunk + t) * OW + il);
        const float2 xk2 = *reinterpret_cast<const float2*>(xk_s + (q * kChunk + t) * OW + il);
        sxr.x += xr2.x; sxr.y += xr2.y;
        sxk.x += xk2.x; sxk.y += xk2.y;
        vdy += xv_s[q * kChunk + t];
      }
      float out_r[2], out_k[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int o = t * L.ld_o + il + m;
        const float r = own[o], k = own[os + o];
        const float drh = own[2 * os + o] * (m ? sxr.y : sxr.x);
        const float dkh = own[3 * os + o] * (m ? sxk.y : sxk.x);
        const float ru = u_s[lo_o + il + m] * vdy;
        out_r[m] = fmaf(ru, k, drh);
        out_k[m] = fmaf(ru, r, dkh);
        const float kd = k * dkh;
        own[o] = kd - r * drh;
        own[os + o] = kd;
        own[2 * os + o] = r * k * vdy;
      }
      if (t < n_ok) {
        const size_t off = row + static_cast<size_t>(t) * rs + lo_o + il;
        store_pair(static_cast<T*>(a.dr) + off, out_r[0], out_r[1]);
        store_pair(static_cast<T*>(a.dk) + off, out_k[0], out_k[1]);
      }
    }
    if (c > 0)
      for (int il = tid; il < OW; il += kBwdThreads) {
        float p = 0.f;
        for (int q = 0; q < NV; ++q) p += xp_s[q * OW + il];
        pn_s[il] = p;
      }
    cluster_arrive();   // the slots are read
    __syncthreads();
    // dlogw_t = P_t - k dk^h_t with P_t = P - sum_{tau > t} x_tau: a warp
    // four channels at a time, lane t on step t, the suffix sums by
    // shuffles; P becomes the previous chunk's end's, as summed above; du
    // += sum_t r k v.dy (a fixed shuffle tree).
    for (int il0 = warp; il0 < OW; il0 += 4 * kBwdWarps) {
      float x[4], kd[4], du[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int il = il0 + m * kBwdWarps;
        const int o = lane * L.ld_o + (il < OW ? il : il0);
        x[m] = own[o];
        kd[m] = own[os + o];
        du[m] = own[2 * os + o];
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float n = __shfl_down_sync(0xffffffffu, x[m], off);
          if (lane + off < 32) x[m] += n;      // x: the sum over steps >= lane
        }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
#pragma unroll
        for (int m = 0; m < 4; ++m) du[m] += __shfl_xor_sync(0xffffffffu, du[m], off);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int il = il0 + m * kBwdWarps;
        float excl = __shfl_down_sync(0xffffffffu, x[m], 1);
        if (lane == 31) excl = 0.f;
        if (il < OW) {
          own[3 * os + lane * L.ld_o + il] = (p_s[il] - excl) - kd[m];
          __syncwarp();
          if (lane == 0) {
            p_s[il] = pn_s[il];
            du_s[il] += du[m];
          }
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < n_ok * OW / 2; e += kBwdThreads) {
      const int t = e >> (osh - 1), il = 2 * (e & (OW / 2 - 1));
      const float* src = own + 3 * os + t * L.ld_o + il;
      store_pair(a.dlogw + row + static_cast<size_t>(t) * rs + lo_o + il, src[0], src[1]);
    }
  }
  cluster_wait();     // no peer stores into this block any more
  for (int il = tid; il < OW; il += kBwdThreads)
    a.du_part[static_cast<size_t>(bh) * Dh + lo_o + il] = du_s[il];
  if (a.dstate0 != nullptr)
    for (int i = tid; i < Dh * VB; i += kBwdThreads) {
      const int d = i >> vsh, e = i & (VB - 1);
      a.dstate0[state_base + static_cast<size_t>(d) * Dv + e] = g_s[d * L.ld_v + e];
    }
}

// The backward on a grid (B * H, NV) in clusters of (1, NV) blocks:
// launched, or, with `max_clusters`, only asked how many such clusters the
// card runs at once.
template <typename T, int Dh>
cudaError_t bwd_launch(const BwdArgs& a, int B, int NV, cudaStream_t stream, int* max_clusters) {
  const int smem = BwdLayout(Dh, a.VB, Dh / NV, NV, static_cast<int>(sizeof(T))).bytes;
  auto kernel = wkv6_bwd_kernel<T, Dh>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = NV;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.H, NV);
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr) return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The kernel for a.Dh (a power of two from 4 to 64: one instance each).
template <typename T>
cudaError_t bwd_dispatch(const BwdArgs& a, int B, int NV, cudaStream_t stream, int* max_clusters) {
  switch (a.Dh) {
    case 4: return bwd_launch<T, 4>(a, B, NV, stream, max_clusters);
    case 8: return bwd_launch<T, 8>(a, B, NV, stream, max_clusters);
    case 16: return bwd_launch<T, 16>(a, B, NV, stream, max_clusters);
    case 32: return bwd_launch<T, 32>(a, B, NV, stream, max_clusters);
    case 64: return bwd_launch<T, 64>(a, B, NV, stream, max_clusters);
    default: return cudaErrorInvalidValue;
  }
}

// NV slices of D value columns: each a multiple of 8 columns, or NV = 1
bool valid_split(int D, int NV) {
  return NV >= 1 && D % NV == 0 && (NV == 1 || (D / NV) % 8 == 0);
}

}  // namespace

extern "C" {

// r, k (B, T, H, Dh) bf16 (in_bf16 = 1) or float32, v (B, T, H, Dv) in
// their dtype (Dv = Dh, or Dv value columns of each head: a multiple of 4
// that divides Dh); logw (B, T, H, Dh), u (H, Dh), state0 (B, H, Dh, Dv) or
// null (zeros), y (B, T, H, Dv) and state_out (B, H, Dh, Dv) float32, not
// aliasing state0. NV value slices of Dv / NV columns (a multiple of 8, or
// NV = 1); vec = 1 when every row of r, k and logw, vec_v = 1 when every row
// of a v slice, is a whole number of 16-byte pieces on 16-byte boundaries.
int wkv6_launch(const void* r, const void* k, const void* v, const float* logw,
                const float* u, const float* state0, float* y, float* state_out,
                int B, int T_len, int H, int Dh, int Dv, int NV, int vec, int vec_v,
                int in_bf16, void* stream) {
  if (B < 1 || T_len < 1 || H < 1 || Dh < 4 || Dh % 4 != 0 || Dh > kMaxDh || Dv < 4 ||
      Dv % 4 != 0 || Dv > Dh || Dh % Dv != 0 || !valid_split(Dv, NV) ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{r, k, v, logw, u, state0, y, state_out, T_len, H, Dh, Dv, Dv / NV, vec, vec_v};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = in_bf16 ? launch<__nv_bfloat16>(a, B, NV, st) : launch<float>(a, B, NV, st);
  return static_cast<int>(e);
}

// The backward. r, k (B, T, H, Dh) bf16 (in_bf16 = 1) or float32, v
// (B, T, H, Dv) in their dtype (Dv a power of two from 4 to Dh: Dh, or Dv
// value columns of each head); logw (B, T, H, Dh), dy (B, T, H, Dv), u (H,
// Dh), state0 and ds (B, H, Dh, Dv) or null (zeros) float32; scratch (B, H,
// ceil(T / 32), Dh, Dv) float32; dr, dk, dv in r's dtype, dlogw (B, T, H,
// Dh), du_part (B, H, Dh) float32, dstate0 (B, H, Dh, Dv) float32 or null
// (not written). Dh a power of two, 4 to 64; NV value slices of Dv / NV
// columns (a multiple of 8, or NV = 1), one cluster of NV blocks a (b, h),
// block j owning the channels [j Dh / NV, (j + 1) Dh / NV) of the sums over
// value columns; vec = 1 when every row of r, k and logw, vec_v = 1 when
// every row of a v or dy slice, is a whole number of 16-byte pieces on
// 16-byte boundaries.
int wkv6_bwd_launch(const void* r, const void* k, const void* v, const float* logw,
                    const float* u, const float* state0, const float* dy, const float* ds,
                    float* scratch, void* dr, void* dk, void* dv, float* dlogw,
                    float* du_part, float* dstate0, int B, int T_len, int H, int Dh, int Dv,
                    int NV, int vec, int vec_v, int in_bf16, void* stream) {
  if (B < 1 || T_len < 1 || H < 1 || Dh < 4 || Dh > kBwdMaxDh || (Dh & (Dh - 1)) != 0 ||
      Dv < 4 || Dv > Dh || (Dv & (Dv - 1)) != 0 || !valid_split(Dv, NV) ||
      static_cast<long long>(B) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{r, k, v, logw, u, state0, dy, ds, scratch, dr, dk, dv, dlogw, du_part,
                  dstate0, T_len, H, Dh, Dv, Dv / NV, vec, vec_v};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = in_bf16 ? bwd_dispatch<__nv_bfloat16>(a, B, NV, st, nullptr)
                                : bwd_dispatch<float>(a, B, NV, st, nullptr);
  return static_cast<int>(e);
}

// Clusters of the backward's NV blocks (head size Dh, slices of Dv / NV
// value columns) that the card runs at once (cudaOccupancyMaxActiveClusters
// at the kernel's shared memory), into *out.
int wkv6_bwd_max_active_clusters(int in_bf16, int Dh, int Dv, int NV, int* out) {
  if (Dh < 4 || Dh > kBwdMaxDh || (Dh & (Dh - 1)) != 0 || Dv < 4 || Dv > Dh ||
      (Dv & (Dv - 1)) != 0 || !valid_split(Dv, NV))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{};
  a.H = 1;
  a.Dh = Dh;
  a.Dv = Dv;
  a.VB = Dv / NV;
  const cudaError_t e = in_bf16 ? bwd_dispatch<__nv_bfloat16>(a, 1, NV, nullptr, out)
                                : bwd_dispatch<float>(a, 1, NV, nullptr, out);
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
