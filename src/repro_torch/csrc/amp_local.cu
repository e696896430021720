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
//   * R = 4 rows a stage for a row (slice) of at most 4096 elements, 1
//     above (rows_per_stage), so a stage carries at least ~16 KB per
//     barrier; a thread holds 32 / R elements of a row, which caps what one
//     block can take at 512 * 32 = 16384 columns (float32 x and f_acc take
//     two registers per owned column).
//   * Wider rows, up to 8 * 16384 = 131072: a thread-block cluster of C
//     = ceil(N / 16384) blocks (on C SMs of one GPC) takes each band.
//     Rank r owns the columns [r W, min((r + 1) W, N)), W = ceil(N / C)
//     rounded up to the vector width (amp_fused.py::cluster_slices),
//     keeps x and f_acc for them in registers and streams only its slice
//     of each row through its own ring (one bulk copy a row). The dot
//     products go through distributed shared memory (DSMEM) without a
//     cluster barrier a row: lane q of each warp stores the warp's sum
//     straight into rank q's exchange buffer (st.async), which counts
//     the bytes off rank q's exchange mbarrier; a rank waits on its own
//     mbarrier for the C x 16 sums and adds them in (rank, warp) order,
//     so all ranks form the same z'_i, bit for bit. A cluster barrier a
//     row instead costs its release fence a row (measured in PERF.md).
//     The buffer is double-buffered: rank q stores stage k + 2 only
//     after its stage k + 1 completed, i.e. after every warp of every
//     rank stored k + 1, which each does after reading stage k. The
//     exchange's completion also frees the ring slot: every warp stores
//     its sum after reading its part of the row. Two cluster barriers a
//     kernel: after the mbarriers are set up, and at the end, so that no
//     rank leaves while a peer may still store into it. With C = 1 there
//     is no cluster: the kernel is the plain block instance, with
//     __syncthreads as the stage's barrier. amp_fused.py::single_read
//     and cluster_size decide from (N, dtype) alone.
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
// amp_local_f_kernel) read A twice; they run only for N > 131072.
//
// Known weak spots, left for later work: at the paper's shape the band
// kernel is bound by its own stream of bulk copies, not by the consumers,
// and a short kernel (25 rows a block) pays the ramp of that stream in full;
// the consumers' fixed cost a stage (dot, shuffles, barrier, reduction)
// binds instead for bf16 rows of 20 KB and for long bands; a shared A with
// B > 1 is read B times where a matrix-matrix product would read it once;
// with B * P >= the SM count a shard is one band, so B * P not a multiple
// of the SM count leaves a partly empty last wave; the second launch costs
// a few microseconds a step. In a cluster every row waits for the
// exchange (a store into each peer's shared memory and its mbarrier)
// between the dot product and the f update, with nothing else to do; a
// cluster needs C free SMs of one GPC, so the active clusters
// (cudaOccupancyMaxActiveClusters, asked by the wrapper) can leave SMs idle.
// The two-pass kernels underfill the card at P = 1 (the f-pass has
// ceil(N / 512) blocks).
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
constexpr int kMaxCluster = 8;                    // blocks of a cluster, at most
constexpr int kClusterHeaderBytes = 2048;         // the same, with the cluster's exchange
constexpr int kSumsOffset = 256;                  // of the exchange's warp sums
constexpr int kCombineThreads = 256;              // columns x band groups
constexpr int kMaxCombineGroups = 8;

constexpr int kMaxWarps = 32;      // warps of a z-pass block, at most
constexpr int kFChunk = 1024;      // rows of z' staged in shared memory at a time
constexpr int kSsThreads = 256;    // threads of the second-stage block

static_assert(kMaxStages * 8 + 2 * 4 * kBandWarps * 4 <= kHeaderBytes,
              "mbarriers and the reduction buffer fit the header");
static_assert((kMaxStages + 2) * 8 <= kSumsOffset &&
                  kSumsOffset + 2 * kMaxCluster * kBandWarps * 4 <= kClusterHeaderBytes,
              "mbarriers and the exchange's sums fit the cluster's header");

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
  int slice_w;           // columns of a cluster rank's slice (n without a cluster)
};

// ---- the cluster: rank, barrier, stores into a peer's shared memory -------
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ int cluster_ranks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return static_cast<int>(r);
}

// every thread of every block of the cluster: the writes to shared memory
// before it are seen by the reads after it, in any rank. Twice a kernel:
// once the mbarriers are set up, and before a block leaves.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the shared::cluster address, in block `rank`, of this block's shared
// memory at `addr` (a shared::cta address)
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// v into the shared memory of a block of the cluster at `addr`, counted
// (4 bytes) off that block's mbarrier at `bar` as it lands (both
// shared::cluster addresses): no fence is needed, the mbarrier's phase
// completes only when the data is there
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
      ::"r"(addr), "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// spin until the phase of parity `parity` of this block's mbarrier `bar`
// has completed, with acquire at cluster scope: the peers' st_async data
// is then seen
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = amp::smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---- single read: one block, or one cluster, per (band, p, b) --------------
// grid (C * n_bands, P, B), block kBandThreads; CLUSTER: clusters of (C, 1,
// 1), rank r of band s being block C s + r; else C = 1. Rank r owns columns
// [r slice_w, r slice_w + sw) of every row. Thread t owns the V-wide chunks
// t, t + kBandThreads, ... of its slice: CH of them at most, ch_live for this
// slice (loops leave at ch_live, the same for the whole block).
template <typename TA, bool VEC, int R, bool CLUSTER>
__global__ void __launch_bounds__(kBandThreads, 1)
    amp_local_band_kernel(const BandArgs args) {
  constexpr int V = Width<TA, VEC>::value;
  constexpr int E = kRegElems / R;
  constexpr int CH = E / V;
  static_assert(CH * V == E, "a thread owns whole chunks");
  static_assert(!CLUSTER || R == 1, "a cluster's slices are wider than 4096");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* red = reinterpret_cast<float*>(smem + kMaxStages * sizeof(uint64_t));
  // a cluster: one mbarrier a buffer of the exchange, and the buffers, each
  // of the 16 warp sums of every rank
  uint64_t* xbar = full + kMaxStages;
  float* sums = reinterpret_cast<float*>(smem + kSumsOffset);
  TA* ring = reinterpret_cast<TA*>(
      smem + (CLUSTER ? kClusterHeaderBytes : kHeaderBytes));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = CLUSTER ? cluster_rank() : 0;
  const int ranks = CLUSTER ? cluster_ranks() : 1;
  const int band = blockIdx.x / ranks, n_bands = gridDim.x / ranks;
  const int p = blockIdx.y, b = blockIdx.z;
  const int mp = args.mp, n = args.n, stages = args.stages;
  const int c0 = rank * args.slice_w;                   // the slice's first column
  const int sw = CLUSTER ? min(args.slice_w, n - c0) : n;  // and its width, >= 1
  const int rs = VEC ? sw : n;                  // elements between rows of a stage
  const long long bp = static_cast<long long>(b) * gridDim.y + p;
  const int r0 = band * args.band_rows;
  const int nrows = min(args.band_rows, mp - r0);  // >= 1: the plan leaves no band empty
  const int n_stage = (nrows + R - 1) / R;
  const long long stage_elems = static_cast<long long>(R) * rs;
  const int ch_live = (sw / V + kBandThreads - 1) / kBandThreads;  // VEC: sw % V == 0
  const TA* src = static_cast<const TA*>(args.a) + b * args.a_bstride +
                  (static_cast<long long>(p) * mp + r0) * n + c0;

  // stage k's rows into its slot: one bulk copy of nr whole rows, or in a
  // cluster one of each row's slice
  auto fill = [&](int k) {
    const int slot = k % stages;
    const int nr = min(R, nrows - k * R);
    const uint32_t bytes = static_cast<uint32_t>(nr) * sw * sizeof(TA);
    amp::mbar_expect_tx(&full[slot], bytes);
    if constexpr (CLUSTER) {
      for (int r = 0; r < nr; ++r)
        amp::bulk_load(ring + slot * stage_elems + r * sw,
                       src + (static_cast<long long>(k) * R + r) * n,
                       static_cast<uint32_t>(sw) * sizeof(TA), &full[slot]);
    } else {
      amp::bulk_load(ring + slot * stage_elems, src + k * stage_elems, bytes,
                     &full[slot]);
    }
  };
  if constexpr (VEC || CLUSTER) {
    if (tid == 0) {
      if constexpr (VEC)
        for (int i = 0; i < stages; ++i) amp::mbar_init(&full[i], 1);
      if constexpr (CLUSTER) {
        amp::mbar_init(&xbar[0], 1);
        amp::mbar_init(&xbar[1], 1);
      }
      amp::fence_mbar_init();
    }
    // a cluster: every rank's mbarriers are set up before any peer stores
    if constexpr (CLUSTER) cluster_sync(); else __syncthreads();
    if constexpr (VEC) {
      if (tid == 0)
        for (int k = 0; k < min(stages, n_stage); ++k) fill(k);
    }
  }

  float xr[CH][V], fa[CH][V];
  const float* xb = args.x + static_cast<long long>(b) * n + c0;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (tid + c * kBandThreads) * V;  // within the slice
#pragma unroll
    for (int v = 0; v < V; ++v) xr[c][v] = fa[c][v] = 0.f;
    if (col < sw) {  // a live chunk is whole
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
    // a cluster: this stage's exchange expects the 16 warp sums of each rank
    if constexpr (CLUSTER) {
      if (tid == 0)
        amp::mbar_expect_tx(&xbar[k & 1], ranks * kBandWarps * sizeof(float));
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
        if (r < nr && col < sw) {
          load_a<TA, V, VEC>(st + static_cast<long long>(r) * rs + col, av[r][c]);
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
    // double-buffered: without a cluster, this block's sums of the stage's
    // R rows; in a cluster, every rank's sums of its one row, [rank][warp]
    float* rb = CLUSTER ? sums + (k & 1) * kMaxCluster * kBandWarps
                        : red + (k & 1) * R * kBandWarps;
    if constexpr (CLUSTER) {
      // lane q stores the warp's sum into rank q's buffer k & 1. The
      // exchange's mbarrier completes when all ranks' sums are in, so after
      // every warp of every rank has read its part of the slot (its sum
      // needs it). No store overwrites sums a peer still reads: a warp
      // stores stage k after its rank's stage k - 1 completed, i.e. after
      // every warp of every rank stored stage k - 1, which each did after
      // adding up stage k - 2, the buffer's previous use.
      if (lane < ranks) {
        st_async(map_rank(amp::smem_u32(rb + rank * kBandWarps + warp), lane),
                 d[0], map_rank(amp::smem_u32(&xbar[k & 1]), lane));
      }
      mbar_wait_cluster(&xbar[k & 1], (k >> 1) & 1);
    } else {
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) rb[r * kBandWarps + warp] = d[r];
      }
      __syncthreads();  // the stage's sums are in; its slot has been read
    }
    if constexpr (VEC) {
      if (tid == 0 && k + stages < n_stage) {
        amp::fence_proxy_async();
        fill(k + stages);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {
        float tot = 0.f;  // the warps' sums in a fixed order: (rank, warp)
        const float4* rw = reinterpret_cast<const float4*>(rb + r * kBandWarps);
        for (int q = 0; q < ranks; ++q) {
#pragma unroll
          for (int w = 0; w < kBandWarps / 4; ++w) {
            const float4 u = rw[q * (kBandWarps / 4) + w];
            tot += u.x; tot += u.y; tot += u.z; tot += u.w;
          }
        }
        const float zn = (yv[r] - tot) + on * zv[r];
        if (tid == 0 && rank == 0) {
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

  // one band: f itself; else this band's partial, for the combine; each
  // rank its slice
  const long long slot_out = bp * n_bands + band;
  const bool whole = n_bands == 1;
  float* fo = (whole ? args.f + bp * n : args.fpart + slot_out * n) + c0;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (tid + c * kBandThreads) * V;
    if (col < sw) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        fo[col + v] = whole ? xr[c][v] / args.n_proc + fa[c][v] : fa[c][v];
    }
  }
  if (tid == 0 && rank == 0) args.sspart[slot_out] = ss;
  // no rank leaves while a peer may still store into its shared memory
  if constexpr (CLUSTER) cluster_sync();
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

// The band kernel for (TA, VEC, R, CLUSTER) on a grid (C * n_bands, P, B):
// launched, or, with `max_clusters`, only asked how many clusters of C blocks
// (at its shared memory) the card runs at once. The ring holds args.stages
// slots of R rows of args.slice_w elements.
template <typename TA, bool VEC, int R, bool CLUSTER>
cudaError_t run_band(const BandArgs& args, int cluster, dim3 grid,
                     cudaStream_t stream, int* max_clusters) {
  size_t smem = CLUSTER ? kClusterHeaderBytes : kHeaderBytes;
  if (VEC) {
    const size_t stage_bytes = static_cast<size_t>(R) * args.slice_w * sizeof(TA);
    if (args.stages < 2 || args.stages > kMaxStages ||
        args.stages * stage_bytes > kRingBytes)
      return cudaErrorInvalidValue;
    smem += args.stages * stage_bytes;
  }
  auto kernel = amp_local_band_kernel<TA, VEC, R, CLUSTER>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  if (!CLUSTER) {
    kernel<<<grid, kBandThreads, smem, stream>>>(args);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kBandThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  e = cudaLaunchKernelEx(&cfg, kernel, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// cluster > 1 takes the cluster instance, whose slices are wider than 4096
// columns (R = 1: the caller checks); else R = rows_per_stage.
template <typename TA, bool VEC>
cudaError_t dispatch_band(int rows_per_stage, const BandArgs& args, int cluster,
                          dim3 grid, cudaStream_t stream, int* max_clusters) {
  if (cluster > 1)
    return run_band<TA, VEC, 1, true>(args, cluster, grid, stream, max_clusters);
  if (rows_per_stage == 4)
    return run_band<TA, VEC, 4, false>(args, 1, grid, stream, max_clusters);
  return run_band<TA, VEC, 1, false>(args, 1, grid, stream, max_clusters);
}

cudaError_t dispatch_band(int a_bf16, int vec, int rows_per_stage,
                          const BandArgs& args, int cluster, dim3 grid,
                          cudaStream_t stream, int* max_clusters) {
  if (a_bf16)
    return vec ? dispatch_band<__nv_bfloat16, true>(rows_per_stage, args, cluster, grid, stream, max_clusters)
               : dispatch_band<__nv_bfloat16, false>(rows_per_stage, args, cluster, grid, stream, max_clusters);
  return vec ? dispatch_band<float, true>(rows_per_stage, args, cluster, grid, stream, max_clusters)
             : dispatch_band<float, false>(rows_per_stage, args, cluster, grid, stream, max_clusters);
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
// (B, n_shards, n_bands). Bands of band_rows rows, the last one ragged, none
// empty; each band taken by a cluster of `cluster` blocks (1..8), rank r
// owning columns [r slice_w, min((r + 1) slice_w, n)), none empty
// (slice_w = n for cluster = 1); rows_per_stage 1 or 4 (1 for cluster > 1),
// and slice_w <= 512 * 32 / rows_per_stage; the ring has `stages` slots of
// rows_per_stage rows of slice_w elements (2..16, at most 192 KB; vec only);
// combine_groups 1, 2, 4 or 8. vec = 1 promises n % (16 / sizeof A) == 0,
// slice_w a multiple of it, and 16-byte aligned a, x.
int amp_local_launch(const void* a, int a_bf16, long long a_bstride,
                     const float* x, const float* y, const float* z,
                     const float* ons, float* z_out, float* fpart,
                     float* sspart, float* f, float* ss, float n_proc,
                     int batch, int n_shards, int mp, int n, int band_rows,
                     int n_bands, int rows_per_stage, int combine_groups,
                     int vec, int cluster, int slice_w, int stages,
                     void* stream) {
  if (batch < 1 || batch > 65535 || n_shards < 1 || n_shards > 65535 ||
      mp < 1 || n < 1 || band_rows < 1 || n_bands < 1 ||
      static_cast<long long>(n_bands - 1) * band_rows >= mp ||
      static_cast<long long>(n_bands) * band_rows < mp ||
      (rows_per_stage != 1 && rows_per_stage != 4) ||
      combine_groups < 1 || combine_groups > kMaxCombineGroups ||
      (combine_groups & (combine_groups - 1)) != 0 ||
      cluster < 1 || cluster > kMaxCluster || (cluster > 1 && rows_per_stage != 1) ||
      slice_w < 1 || (cluster == 1 && slice_w != n) ||
      static_cast<long long>(cluster - 1) * slice_w >= n ||
      static_cast<long long>(cluster) * slice_w < n ||
      (vec && slice_w % (a_bf16 ? 8 : 4) != 0) ||
      slice_w > kBandThreads * (kRegElems / rows_per_stage))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BandArgs args{a, a_bstride, x, y, z, ons, z_out, fpart, sspart,
                      f, n_proc, mp, n, band_rows, vec ? stages : 0, slice_w};
  cudaError_t e = dispatch_band(a_bf16, vec, rows_per_stage, args, cluster,
                                dim3(cluster * n_bands, n_shards, batch), s,
                                nullptr);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cols = kCombineThreads / combine_groups;
  const dim3 grid(n_bands > 1 ? (n + cols - 1) / cols : 1,
                  n_bands > 1 ? n_shards : 1, batch);
  amp_local_combine_kernel<<<grid, dim3(cols, combine_groups), 0, s>>>(
      fpart, sspart, x, f, ss, n_proc, n_shards, n_bands, n);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `cluster` (2..8) band blocks, each with a ring of
// `stages` slots of one row of slice_w elements (vec = 1; none with vec =
// 0), the card runs at once: cudaOccupancyMaxActiveClusters, into *out.
int amp_local_max_active_clusters(int a_bf16, int vec, int cluster,
                                  int slice_w, int stages, int* out) {
  if (cluster < 2 || cluster > kMaxCluster || slice_w < 1 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  BandArgs args{};
  args.slice_w = slice_w;
  args.stages = vec ? stages : 0;
  return static_cast<int>(dispatch_band(a_bf16, vec, 1, args, cluster,
                                        dim3(cluster, 1, 1), nullptr, out));
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
