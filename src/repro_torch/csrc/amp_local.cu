// Fused AMP local-computation (LC) step for the row layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel pair of src/repro/kernels/amp_fused/amp_fused.py,
// entry `amp_local_pallas_grid` (`_z_kernel` and `_f_kernel`), which computes
//     z'[b,p,m] = y[b,p,m] - sum_n A[b,p,m,n] x[b,n] + onsager[b] z[b,p,m]
//     ss[b]     = sum_{p,m} z'[b,p,m]^2
//     f[b,p,n]  = x[b,n] / P + sum_m A[b,p,m,n] z'[b,p,m]
//
// What bounds it on this card: bytes. Two multiply-adds per element of A,
// far below the ~20 flop/byte at which float32 arithmetic would limit an
// H100, so the least time of a step is (|A| + the vectors) / memory rate:
// A read once. At the paper's size (P=30, Mp=100, N=10000) |A| is 120 MB in
// float32, more than the 50 MB L2, so a second read would come from device
// memory as well.
//
// Design (amp_local_band_kernel + amp_local_combine_kernel, two launches):
//   * z'_i needs only row i of A, and f is sum_i z'_i A_i, so a block that
//     owns a band of rows of one shard reads each row once, keeps it on chip,
//     and uses it twice: the dot product for z'_i, then f_acc += z'_i A_i.
//     One block per (b, p, band); the bands of a shard are planned in Python
//     (amp_fused.py::split_plan: about one block per SM, partial f traffic
//     under a tenth of |A|).
//   * Rows stream through a ring of whole rows in dynamic shared memory
//     (~192 KB, a stage = R rows), filled by one thread with TMA bulk copies
//     and an mbarrier per slot (amp_common.cuh). Each thread owns a fixed
//     strided set of columns: x for them in registers, loaded once, and its
//     f_acc. It reads its part of a stage's rows from shared memory into
//     registers once, forms the R dot products, reduces them over the block
//     (shuffles, then the 16 warps in order), and after the one barrier of the
//     stage every thread has the same z'_i and updates f_acc from the same
//     registers. That barrier also frees the slot: thread 0 refills it with
//     the stage `stages` ahead, so no empty-barrier is needed.
//   * R = 4 rows a stage for N <= 4096, 1 above (rows_per_stage), so a
//     stage carries at least ~16 KB per barrier; a thread holds 32 / R
//     elements of a row, which caps N at 512 * 32 = 16384 (float32 x and
//     f_acc take two registers per owned column). Wider rows take the
//     two-pass kernels below; amp_fused.py::single_read decides from (N,
//     dtype) alone.
//   * Without 16-byte aligned rows (N * sizeof A % 16 != 0: `vec` = 0) no
//     bulk copy is possible: the same kernel then loads each thread's
//     elements of a stage straight from device memory into registers; A is
//     still read once.
//   * The second kernel adds the band partials of f in band order and x / P,
//     and ss's partials in a fixed order: no float atomics, so z', f and ss
//     are the same bits from run to run.
//   * bfloat16 A: the ring holds bf16, widened in registers; every sum is
//     float32. The batch is a grid axis; a shared A is a batch stride of 0
//     (read once per instance). Ragged edges are masked; nothing is padded.
//
// The two-pass kernels (amp_local_z_kernel + amp_local_ss_kernel, then
// amp_local_f_kernel) read A twice; they run only for N > 16384.
//
// Known weak spots, left for later work: at the paper's shape the band
// kernel is bound by its own stream of bulk copies, not by the consumers,
// and a short kernel (25 rows a block) pays the ramp of that stream in full;
// the consumers' fixed cost a stage (dot, shuffles, barrier, reduction)
// binds instead for bf16 rows of 20 KB and for long bands; a shared A with
// B > 1 is read B times where a matrix-matrix product would read it once;
// with B * P >= the SM count a shard is one band, so B * P not a multiple
// of the SM count leaves a partly empty last wave; the second launch costs
// a few microseconds a step; the two-pass kernels underfill the card at
// P = 1 (the f-pass has ceil(N / 512) blocks).
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

constexpr int kBandThreads = 512;                 // threads of a band block
constexpr int kBandWarps = kBandThreads / 32;
constexpr int kRegElems = 32;                     // elements of a stage a thread holds
constexpr int kMaxStages = 16;                    // slots of the ring, at most
constexpr int kRingBytes = 192 * 1024;            // shared memory of the ring, at most
constexpr int kHeaderBytes = 1024;                // mbarriers and the reduction buffer
constexpr int kCombineThreads = 256;              // columns x band groups
constexpr int kMaxCombineGroups = 8;

constexpr int kMaxWarps = 32;      // warps of a z-pass block, at most
constexpr int kFChunk = 1024;      // rows of z' staged in shared memory at a time
constexpr int kSsThreads = 256;    // threads of the second-stage block

static_assert(kMaxStages * 8 + 2 * 4 * kBandWarps * 4 <= kHeaderBytes,
              "mbarriers and the reduction buffer fit the header");

struct BandArgs {
  const void* a;         // (B or 1, P, mp, n), float32 or bfloat16
  long long a_bstride;   // elements between batch entries, 0 = shared
  const float* x;        // (B, n)
  const float* y;        // (B, P, mp)
  const float* z;        // (B, P, mp)
  const float* ons;      // (B,)
  float* z_out;          // (B, P, mp)
  float* fpart;          // (B, P, n_bands, n); unused with one band
  float* sspart;         // (B, P, n_bands)
  float* f;              // (B, P, n), written here when there is one band
  float n_proc;
  int mp, n, band_rows, stages;
};

// ---- single read: one block per (band, p, b) ---------------------------------
// grid (n_bands, P, B), block kBandThreads. Thread t owns the V-wide chunks
// t, t + kBandThreads, ... of a row: CH of them at most, ch_live for this N
// (loops leave at ch_live, the same for the whole block).
template <typename TA, bool VEC, int R>
__global__ void __launch_bounds__(kBandThreads, 1)
    amp_local_band_kernel(const BandArgs args) {
  constexpr int V = Width<TA, VEC>::value;
  constexpr int E = kRegElems / R;
  constexpr int CH = E / V;
  static_assert(CH * V == E, "a thread owns whole chunks");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* red = reinterpret_cast<float*>(smem + kMaxStages * sizeof(uint64_t));
  TA* ring = reinterpret_cast<TA*>(smem + kHeaderBytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int band = blockIdx.x, n_bands = gridDim.x;
  const int p = blockIdx.y, b = blockIdx.z;
  const int mp = args.mp, n = args.n, stages = args.stages;
  const long long bp = static_cast<long long>(b) * gridDim.y + p;
  const int r0 = band * args.band_rows;
  const int nrows = min(args.band_rows, mp - r0);  // >= 1: the plan leaves no band empty
  const int n_stage = (nrows + R - 1) / R;
  const long long stage_elems = static_cast<long long>(R) * n;
  const int ch_live = (n / V + kBandThreads - 1) / kBandThreads;  // VEC: n % V == 0
  const TA* src = static_cast<const TA*>(args.a) + b * args.a_bstride +
                  (static_cast<long long>(p) * mp + r0) * n;

  // stage k's rows into its slot: one bulk copy of nr whole rows
  auto fill = [&](int k) {
    const int slot = k % stages;
    const int nr = min(R, nrows - k * R);
    const uint32_t bytes = static_cast<uint32_t>(nr) * n * sizeof(TA);
    amp::mbar_expect_tx(&full[slot], bytes);
    amp::bulk_load(ring + slot * stage_elems, src + k * stage_elems, bytes,
                   &full[slot]);
  };
  if constexpr (VEC) {
    if (tid == 0) {
      for (int i = 0; i < stages; ++i) amp::mbar_init(&full[i], 1);
      amp::fence_mbar_init();
    }
    __syncthreads();
    if (tid == 0)
      for (int k = 0; k < min(stages, n_stage); ++k) fill(k);
  }

  float xr[CH][V], fa[CH][V];
  const float* xb = args.x + static_cast<long long>(b) * n;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (tid + c * kBandThreads) * V;
#pragma unroll
    for (int v = 0; v < V; ++v) xr[c][v] = fa[c][v] = 0.f;
    if (col < n) {  // a live chunk is whole
#pragma unroll
      for (int v = 0; v < V; ++v) xr[c][v] = __ldg(xb + col + v);
    }
  }
  const float on = __ldg(args.ons + b);
  float ss = 0.f;  // thread 0's

  for (int k = 0; k < n_stage; ++k) {
    const int nr = min(R, nrows - k * R);
    const long long row0 = bp * mp + r0 + static_cast<long long>(k) * R;
    float yv[R], zv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      yv[r] = r < nr ? __ldg(args.y + row0 + r) : 0.f;
      zv[r] = r < nr ? __ldg(args.z + row0 + r) : 0.f;
    }
    const TA* st;
    if constexpr (VEC) {
      const int slot = k % stages;
      amp::mbar_wait(&full[slot], (k / stages) & 1);
      st = ring + slot * stage_elems;
    } else {
      st = src + k * stage_elems;
    }
    // the thread's elements of the stage, read once, used twice; two
    // interleaved sums shorten the dot product's chain of dependent FMAs
    float av[R][CH][V];
    float d[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (c >= ch_live) break;
        const int col = (tid + c * kBandThreads) * V;
        if (r < nr && col < n) {
          load_a<TA, V, VEC>(st + static_cast<long long>(r) * n + col, av[r][c]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) av[r][c][v] = 0.f;
        }
#pragma unroll
        for (int v = 0; v < V; v += 2) {
          d0 = fmaf(av[r][c][v], xr[c][v], d0);
          if (v + 1 < V) d1 = fmaf(av[r][c][v + 1], xr[c][v + 1], d1);
        }
      }
      d[r] = d0 + d1;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        d[r] += __shfl_xor_sync(0xffffffffu, d[r], off);
    }
    float* rb = red + (k & 1) * R * kBandWarps;  // double-buffered
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) rb[r * kBandWarps + warp] = d[r];
    }
    __syncthreads();  // the stage's sums are in; its slot has been read
    if constexpr (VEC) {
      if (tid == 0 && k + stages < n_stage) {
        amp::fence_proxy_async();
        fill(k + stages);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {
        float tot = 0.f;  // the warps' sums in a fixed order
        const float4* rw = reinterpret_cast<const float4*>(rb + r * kBandWarps);
#pragma unroll
        for (int w = 0; w < kBandWarps / 4; ++w) {
          const float4 q = rw[w];
          tot += q.x; tot += q.y; tot += q.z; tot += q.w;
        }
        const float zn = (yv[r] - tot) + on * zv[r];
        if (tid == 0) {
          args.z_out[row0 + r] = zn;
          ss = fmaf(zn, zn, ss);
        }
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          if (c >= ch_live) break;
#pragma unroll
          for (int v = 0; v < V; ++v) fa[c][v] = fmaf(zn, av[r][c][v], fa[c][v]);
        }
      }
    }
  }

  // one band: f itself; else this band's partial, for the combine
  const long long slot_out = bp * n_bands + band;
  const bool whole = n_bands == 1;
  float* fo = whole ? args.f + bp * n : args.fpart + slot_out * n;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (tid + c * kBandThreads) * V;
    if (col < n) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        fo[col + v] = whole ? xr[c][v] / args.n_proc + fa[c][v] : fa[c][v];
    }
  }
  if (tid == 0) args.sspart[slot_out] = ss;
}

// ---- second stage of the single read: fixed-order sums ----------------------
// grid (ceil(n / cols), P, B) with more than one band, else (1, 1, B);
// block (cols, groups), cols * groups = kCombineThreads, groups a power of two
// (amp_fused.py::combine_groups: more than one only where the columns alone
// leave the card short of threads). Thread (c, g) adds the partials of bands
// g, g + groups, ... of its column in band order; the groups' sums are added
// in group order, and f = x / n_proc + that. Block (0, 0, b) also sums ss's
// P * n_bands partials.
__global__ void __launch_bounds__(kCombineThreads)
    amp_local_combine_kernel(const float* __restrict__ fpart,
                             const float* __restrict__ sspart,
                             const float* __restrict__ x, float* __restrict__ f,
                             float* __restrict__ ss, float n_proc, int n_shards,
                             int n_bands, int n) {
  __shared__ float part[kCombineThreads];
  const int p = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x, g = threadIdx.y, cols = blockDim.x;
  if (n_bands > 1) {  // the same for the whole grid
    const long long bp = static_cast<long long>(b) * n_shards + p;
    const int col = blockIdx.x * cols + tx;
    float acc = 0.f;
    if (col < n) {
      const float* fp = fpart + bp * n_bands * n + col;
      for (int s = g; s < n_bands; s += blockDim.y)
        acc += fp[static_cast<long long>(s) * n];
    }
    part[g * cols + tx] = acc;
    __syncthreads();
    if (g == 0 && col < n) {
      float tot = 0.f;
      for (int q = 0; q < blockDim.y; ++q) tot += part[q * cols + tx];
      f[bp * n + col] = x[static_cast<long long>(b) * n + col] / n_proc + tot;
    }
  }
  if (blockIdx.x == 0 && p == 0 && g == 0 && tx < 32) {  // one whole warp
    const int lane = tx;
    const int cnt = n_shards * n_bands;
    const float* sp = sspart + static_cast<long long>(b) * cnt;
    float s = 0.f;
    for (int i = lane; i < cnt; i += 32) s += sp[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) ss[b] = s;
  }
}

template <typename TA, bool VEC, int R>
cudaError_t launch_band(BandArgs args, int batch, int n_shards, int n_bands,
                        cudaStream_t stream) {
  size_t smem = kHeaderBytes;
  args.stages = 0;
  if (VEC) {
    const size_t stage_bytes = static_cast<size_t>(R) * args.n * sizeof(TA);
    args.stages = static_cast<int>(
        stage_bytes * kMaxStages <= kRingBytes ? kMaxStages : kRingBytes / stage_bytes);
    if (args.stages < 2) return cudaErrorInvalidValue;
    smem += args.stages * stage_bytes;
  }
  auto kernel = amp_local_band_kernel<TA, VEC, R>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<dim3(n_bands, n_shards, batch), kBandThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

template <typename TA, bool VEC>
cudaError_t dispatch_band(int rows_per_stage, const BandArgs& args, int batch,
                          int n_shards, int n_bands, cudaStream_t stream) {
  if (rows_per_stage == 4)
    return launch_band<TA, VEC, 4>(args, batch, n_shards, n_bands, stream);
  return launch_band<TA, VEC, 1>(args, batch, n_shards, n_bands, stream);
}

// ---- two-pass form (N > 16384): z-pass, one warp per row (b, p*Mp + m) ------
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

// One LC step, single read of A: the band kernel, then the combine.
// a: (B or 1, n_shards, mp, n) elements of float32 (a_bf16 = 0) or bfloat16
// (1), a_bstride elements between batch entries (0 = shared). x (B, n); y, z,
// z_out (B, n_shards, mp); ons, ss (B,); f (B, n_shards, n). Scratch: fpart
// (B, n_shards, n_bands, n; not touched when n_bands = 1), sspart
// (B, n_shards, n_bands). Bands of
// band_rows rows, the last one ragged, none empty; rows_per_stage 1 or 4,
// and n <= 512 * 32 / rows_per_stage; combine_groups 1, 2, 4 or 8. vec = 1 promises
// n % (16 / sizeof A) == 0 and 16-byte aligned a, x.
int amp_local_launch(const void* a, int a_bf16, long long a_bstride,
                     const float* x, const float* y, const float* z,
                     const float* ons, float* z_out, float* fpart,
                     float* sspart, float* f, float* ss, float n_proc,
                     int batch, int n_shards, int mp, int n, int band_rows,
                     int n_bands, int rows_per_stage, int combine_groups,
                     int vec, void* stream) {
  if (batch < 1 || batch > 65535 || n_shards < 1 || n_shards > 65535 ||
      mp < 1 || n < 1 || band_rows < 1 || n_bands < 1 ||
      static_cast<long long>(n_bands - 1) * band_rows >= mp ||
      static_cast<long long>(n_bands) * band_rows < mp ||
      (rows_per_stage != 1 && rows_per_stage != 4) ||
      combine_groups < 1 || combine_groups > kMaxCombineGroups ||
      (combine_groups & (combine_groups - 1)) != 0 ||
      n > kBandThreads * (kRegElems / rows_per_stage))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BandArgs args{a, a_bstride, x, y, z, ons, z_out, fpart, sspart,
                      f, n_proc, mp, n, band_rows, 0};
  cudaError_t e;
  if (a_bf16)
    e = vec ? dispatch_band<__nv_bfloat16, true>(rows_per_stage, args, batch, n_shards, n_bands, s)
            : dispatch_band<__nv_bfloat16, false>(rows_per_stage, args, batch, n_shards, n_bands, s);
  else
    e = vec ? dispatch_band<float, true>(rows_per_stage, args, batch, n_shards, n_bands, s)
            : dispatch_band<float, false>(rows_per_stage, args, batch, n_shards, n_bands, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cols = kCombineThreads / combine_groups;
  const dim3 grid(n_bands > 1 ? (n + cols - 1) / cols : 1,
                  n_bands > 1 ? n_shards : 1, batch);
  amp_local_combine_kernel<<<grid, dim3(cols, combine_groups), 0, s>>>(
      fpart, sspart, x, f, ss, n_proc, n_shards, n_bands, n);
  return static_cast<int>(cudaGetLastError());
}

// The two-pass form, for rows wider than the single read takes.
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
