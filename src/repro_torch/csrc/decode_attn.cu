// GQA decode attention against a KV cache (flash-decode), for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/decode_attn/decode_attn.py,
// `decode_attn_pallas` (`_kernel`): one query token of H heads against caches
// (B, S, KV, Dh), heads grouped KV-major (G = H / KV query heads share a KV
// head), cache row t seen when t <= pos and, with a window, t > pos - window;
// softmax with scale 1/sqrt(Dh) in float32; the output in q's dtype.
//
// What bounds it on this card: bytes, and at the serving path's shapes the
// latency of a short kernel. Every cache row the position attends to, rows
// lo..hi (the caller computes them from pos and the window; no other row is
// read), is read once, K and V, for all heads of its group. At gemma3-1b's
// decode shape (B=8, KV=1, Dh=256, bf16, ~1000 rows) a global layer moves
// about 8.5 MB: 2.5 microseconds at 3.35 TB/s. So what decides its time is
// what a block does in series: waiting for its first rows, its batches of
// rows, the fold of its teams, the count and the last block's fold.
//
// Design: one launch, grid (nsplit, B * KV, ceil(G / 4)), a block per run of
// rows of one (b, kv head) and slice of up to kHeads = 4 of its query heads.
//   * The plan (kernels/decode_attn/decode_attn.py::split_plan) cuts rows
//     lo..hi into nsplit runs so that all blocks are resident at once (the
//     occupancy API, asked for this kernel's shared memory): at gemma3-1b's
//     decode shape one block an SM, 8 groups x 16 runs.
//   * Rows are streamed into a ring of up to kMaxStages stages (~192 KB) of
//     shared memory by TMA bulk copies (amp_common.cuh's streamer). The
//     producer warp initialises the mbarriers and issues every first use of
//     a stage before the consumers are let in (a named barrier), so the
//     copies are in flight while the consumers load q; it refills a stage
//     once the consumers free it. With KV = 1 the rows of a stage are
//     contiguous: two copies a stage (K, V); with KV > 1 one copy a row.
//   * What limits the consumers is instructions a byte (G = 4 gives ~4
//     flops a byte of cache; CUDA cores do ~20 a byte of HBM): 8 warps cut
//     into teams of L = 8, 16 or 32 lanes (a template argument, so that the
//     shuffle loops unroll), a lane 16 bytes of a row. A team takes kBatch
//     rows of a stage at a time and reads all their K and V chunks at once
//     (zeros past the stage: no branch). Each lane holds its channels of the
//     slice's q and of its running sum acc in registers for the whole run.
//     Scores: one 16-byte read of K gives the partial dots of all four
//     heads; a reduce-scatter across the team (3 shuffles) leaves each lane
//     one head's partial, summed by a butterfly over that head's lanes. The
//     lanes of a head keep its running max and sum (in log2 units: exp2f)
//     and form the batch's probabilities, broadcast to the team. PV: one
//     16-byte read of V a row serves all four heads.
//   * Each team keeps its own (m, l, acc); at the end of the run the teams
//     are folded in team order in shared memory, and the block writes its
//     partial (m, l, acc) in float32. One thread counts the block in on an
//     integer counter of its (b, kv head, head slice) with an acq_rel atomic
//     after a block barrier; the block that arrives last stages every
//     (m, l) in shared memory while its partial sums are in flight, folds
//     the partials in split order, writes the output in q's dtype and
//     resets the counter to 0. The counter only orders the work: the
//     arithmetic is the same whichever block is last, so the result is the
//     same bits run to run. A single split writes the output directly.
//   * A partial or team with m = -inf (no row) adds nothing, as the
//     reference's `m_safe`/`corr` guard does.
//
// Limits (checked here and by the Python wrapper): Dh a multiple of 8 up to
// 256, G * Dh <= 4096, q bf16 or float32, caches bf16 or float32, 16-byte
// aligned.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// stream it is given, does not synchronise, allocates nothing (the caller
// passes the scratch of the partials and the counters, zeroed once) and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "amp_common.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kHeads = 4;                  // query heads a block holds
constexpr int kBatch = 4;                  // rows a team takes at a time
constexpr int kMaxStages = 6;
constexpr int kHeader = 128;  // bytes: the mbarriers and the last-block flag
constexpr int kMaxDh = 256;
constexpr int kMaxGDh = 4096;
constexpr int kMaxSmem = 232448;  // a block's shared memory on an H100
constexpr int kMaxSplits = 32;    // runs of rows a unit is cut into, at most
constexpr int kPrefetch = 16;     // partials the last block requests at once
constexpr int kReady = 1;         // named barrier: the mbarriers are initialised
static_assert(2 * kMaxStages * 8 + 4 <= kHeader, "the header holds the mbarriers and a flag");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* part;    // (B*KV*n_slices, nsplit, kHeads * (Dh + 2)): acc, then (m, l) a head
  int* counters;  // (B*KV*n_slices), zero between launches
  int S, KV, G, Dh, lo, hi, rows_per_split, nsplit, q_bf16;
  int stage_rows, stages;
  float scale_log2;  // 1/sqrt(Dh) * log2 e
};

// the kernel's shared memory: header, then the ring of `stages` stages, each
// a K tile and a V tile of stage_rows rows
__host__ __device__ inline size_t smem_bytes(int dh, int esize, int stage_rows, int stages) {
  return kHeader + static_cast<size_t>(stages) * 2 * stage_rows * dh * esize;
}

// V consecutive elements of q (V = 4 or 8, 8 or 16 bytes aligned), widened
template <int V>
__device__ __forceinline__ void load_q(const void* q, bool bf16, size_t i, float* out) {
  if (bf16) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const __nv_bfloat16*>(q) + i);
#pragma unroll
    for (int e = 0; e < V / 2; ++e) {
      const float2 f = __bfloat1622float2(p[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  } else {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(q) + i);
#pragma unroll
    for (int e = 0; e < V / 4; ++e) {
      const float4 f = p[e];
      out[4 * e] = f.x;
      out[4 * e + 1] = f.y;
      out[4 * e + 2] = f.z;
      out[4 * e + 3] = f.w;
    }
  }
}

// four consecutive channels of the output, in q's dtype
__device__ __forceinline__ void store_out4(void* out, bool bf16, size_t i, float4 v) {
  if (bf16) {
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + i);
    o[0] = __floats2bfloat162_rn(v.x, v.y);
    o[1] = __floats2bfloat162_rn(v.z, v.w);
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + i) = v;
  }
}

// the 16 bytes of a chunk of a cache row, widened to float32
template <typename TC>
__device__ __forceinline__ void widen(const uint4 raw, float (&out)[16 / sizeof(TC)]) {
  if constexpr (sizeof(TC) == 4) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  } else {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> float32: the high half of a word
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// arrive at named barrier `id` of `threads` threads without waiting
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// one more block of a unit is done: add one to its counter, and return what
// it held before. Release orders this block's partial (written before the
// barrier that precedes the call) before the count; acquire orders the
// other blocks' partials before what the last block reads after it.
__device__ __forceinline__ int count_in(int* counter) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// scores, maxima and weights are in log2 units (the scale carries log2 e)
__device__ __forceinline__ float weight(float m, float m_safe) {
  return isfinite(m) ? exp2f(m - m_safe) : 0.f;
}

// L: lanes of a team (8, 16 or 32), so that every shuffle loop unrolls and
// the rows of a batch interleave
template <typename TC, int L>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(const Args a) {
  constexpr int kVec = 16 / sizeof(TC);  // elements of a 16-byte chunk
  constexpr int kCpl = 8 / kVec;         // chunks a lane, at most (Dh <= 256)
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  int* last_flag = reinterpret_cast<int*>(empty + kMaxStages);
  TC* ring = reinterpret_cast<TC*>(smem + kHeader);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, bk = blockIdx.y, hs = blockIdx.z;
  const int unit = bk * gridDim.z + hs;  // (b, kv head, head slice)
  const int b = bk / a.KV, kvh = bk - b * a.KV;
  const int gn = min(kHeads, a.G - hs * kHeads);  // heads of this slice
  const int Dh = a.Dh;
  const int t_begin = a.lo + split * a.rows_per_split;
  const int nrows = min(a.hi + 1, t_begin + a.rows_per_split) - t_begin;  // >= 1
  const int TR = a.stage_rows;
  const int n_stage = (nrows + TR - 1) / TR;
  const size_t tile = static_cast<size_t>(TR) * Dh;  // elements of a K (or V) tile
  const size_t row_stride = static_cast<size_t>(a.KV) * Dh;
  const size_t cache0 = (static_cast<size_t>(b) * a.S * a.KV + kvh) * Dh;  // row 0 of (b, kvh)

  constexpr int nteams = kConsumers / L;
  constexpr int head_lanes = L / kHeads;  // lanes of one head after the scatter
  const int team = tid / L;  // consumers: the team, lane lt of it
  const int lt = lane & (L - 1);
  const int my_head = lt / head_lanes;
  const int chunks = Dh / kVec;
  float acc[kHeads][8];
#pragma unroll
  for (int g = 0; g < kHeads; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  float m_me = -INFINITY, l_me = 0.f;  // running max and sum of head my_head

  if (warp == kConsumerWarps) {  // the producer
    if (lane == 0) {
      for (int i = 0; i < a.stages; ++i) {
        amp::mbar_init(&full[i], 1);
        amp::mbar_init(&empty[i], kConsumerWarps);
      }
      amp::fence_mbar_init();
    }
    __syncwarp();
    const TC* kc = static_cast<const TC*>(a.k) + cache0;
    const TC* vc = static_cast<const TC*>(a.v) + cache0;
    const uint32_t row_bytes = static_cast<uint32_t>(Dh * sizeof(TC));
    for (int k = 0; k < n_stage; ++k) {
      // the barriers are ready: let the consumers in once every first use
      // of a slot is issued (they load q meanwhile)
      if (k == min(a.stages, n_stage)) named_arrive(kReady, kThreads);
      const int slot = k % a.stages;
      if (k >= a.stages) {  // the consumers have freed the slot's last use
        amp::mbar_wait(&empty[slot], ((k / a.stages) - 1) & 1);
        amp::fence_proxy_async();
      }
      const int t0 = t_begin + k * TR;
      const int nr = min(TR, nrows - k * TR);
      TC* kdst = ring + 2 * slot * tile;
      TC* vdst = kdst + tile;
      if (lane == 0) amp::mbar_expect_tx(&full[slot], 2u * nr * row_bytes);
      __syncwarp();
      if (a.KV == 1) {
        if (lane < 2)
          amp::bulk_load(lane ? vdst : kdst, (lane ? vc : kc) + static_cast<size_t>(t0) * Dh,
                         nr * row_bytes, &full[slot]);
      } else {
        for (int r = lane; r < nr; r += 32) {
          const size_t off = static_cast<size_t>(t0 + r) * row_stride;
          amp::bulk_load(kdst + r * Dh, kc + off, row_bytes, &full[slot]);
          amp::bulk_load(vdst + r * Dh, vc + off, row_bytes, &full[slot]);
        }
      }
    }
    if (n_stage <= a.stages) named_arrive(kReady, kThreads);
  } else {  // the consumers
    const int team_lane0 = lane & ~(L - 1);
    const size_t q0 = (static_cast<size_t>(bk) * a.G + hs * kHeads) * Dh;  // the slice's head 0
    float q[kHeads][8];
#pragma unroll
    for (int g = 0; g < kHeads; ++g)
#pragma unroll
      for (int j = 0; j < kCpl; ++j) {
        const int c = lt + j * L;
        if (g < gn && c < chunks)
          load_q<kVec>(a.q, a.q_bf16, q0 + g * Dh + c * kVec, &q[g][j * kVec]);
        else
#pragma unroll
          for (int e = 0; e < kVec; ++e) q[g][j * kVec + e] = 0.f;
      }
    const int warp_row0 = warp * (32 / L) * kBatch;  // the warp's first row of a stage
    amp::named_sync(kReady, kThreads);  // the producer has set up the barriers

    for (int k = 0; k < n_stage; ++k) {
      const int slot = k % a.stages;
      amp::mbar_wait(&full[slot], (k / a.stages) & 1);
      const int nr = min(TR, nrows - k * TR);
      if (warp_row0 < nr) {  // the same for the whole warp
        const TC* ks = ring + 2 * slot * tile;
        const TC* vs = ks + tile;
        const int r0 = team * kBatch;

        // the batch's K and V chunks, all loads issued at once (zeros for a
        // row past the stage or a lane past the row)
        uint4 kraw[kBatch][kCpl], vraw[kBatch][kCpl];
#pragma unroll
        for (int rb = 0; rb < kBatch; ++rb)
#pragma unroll
          for (int j = 0; j < kCpl; ++j) {
            const int c = lt + j * L;
            const bool live = r0 + rb < nr && c < chunks;
            const size_t off = static_cast<size_t>(r0 + rb) * Dh + c * kVec;
            kraw[rb][j] = live ? *reinterpret_cast<const uint4*>(ks + off) : make_uint4(0, 0, 0, 0);
            vraw[rb][j] = live ? *reinterpret_cast<const uint4*>(vs + off) : make_uint4(0, 0, 0, 0);
          }

        // scores of the batch, each lane ends with its head's
        float s_me[kBatch];
#pragma unroll
        for (int rb = 0; rb < kBatch; ++rb) {
          const bool ok = r0 + rb < nr;
          float p[kHeads] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < kCpl; ++j) {
            float kf[kVec];
            widen<TC>(kraw[rb][j], kf);
#pragma unroll
            for (int g = 0; g < kHeads; ++g)
#pragma unroll
              for (int e = 0; e < kVec; ++e) p[g] = fmaf(q[g][j * kVec + e], kf[e], p[g]);
          }
          // reduce-scatter over the team: heads {0,1} | {2,3}, then one head
          constexpr int off1 = L >> 1, off2 = L >> 2;
          const bool up1 = lt & off1, up2 = lt & off2;
          const float x0 = (up1 ? p[2] : p[0]) +
                           __shfl_xor_sync(0xffffffffu, up1 ? p[0] : p[2], off1);
          const float x1 = (up1 ? p[3] : p[1]) +
                           __shfl_xor_sync(0xffffffffu, up1 ? p[1] : p[3], off1);
          float s = (up2 ? x1 : x0) + __shfl_xor_sync(0xffffffffu, up2 ? x0 : x1, off2);
#pragma unroll
          for (int off = head_lanes >> 1; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          s_me[rb] = ok ? s * a.scale_log2 : -INFINITY;
        }

        // running softmax of head my_head over the batch
        float m_new = m_me;
#pragma unroll
        for (int rb = 0; rb < kBatch; ++rb) m_new = fmaxf(m_new, s_me[rb]);
        const float m_safe = isfinite(m_new) ? m_new : 0.f;
        const float corr_me = weight(m_me, m_safe);
        float p_me[kBatch], p_sum = 0.f;
#pragma unroll
        for (int rb = 0; rb < kBatch; ++rb) {
          p_me[rb] = exp2f(s_me[rb] - m_safe);  // 0 for a row past the stage
          p_sum += p_me[rb];
        }
        l_me = fmaf(l_me, corr_me, p_sum);
        m_me = m_new;

        // acc <- acc * corr + p V, every head from one read of V a row
#pragma unroll
        for (int g = 0; g < kHeads; ++g) {
          const float corr = __shfl_sync(0xffffffffu, corr_me, team_lane0 + g * head_lanes);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
        }
#pragma unroll
        for (int rb = 0; rb < kBatch; ++rb) {
          float p[kHeads];
#pragma unroll
          for (int g = 0; g < kHeads; ++g)
            p[g] = __shfl_sync(0xffffffffu, p_me[rb], team_lane0 + g * head_lanes);
#pragma unroll
          for (int j = 0; j < kCpl; ++j) {
            float vf[kVec];
            widen<TC>(vraw[rb][j], vf);
#pragma unroll
            for (int g = 0; g < kHeads; ++g)
#pragma unroll
              for (int e = 0; e < kVec; ++e)
                acc[g][j * kVec + e] = fmaf(p[g], vf[e], acc[g][j * kVec + e]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) amp::mbar_arrive(&empty[slot]);
    }
  }
  __syncthreads();  // every stage is consumed: the ring is free

  // each team's partial into shared memory: acc (nteams, kHeads, Dh), then
  // (m, l) (nteams, kHeads)
  float* tacc = reinterpret_cast<float*>(ring);
  float* tml = tacc + static_cast<size_t>(nteams) * kHeads * Dh;
  if (warp < kConsumerWarps) {
#pragma unroll
    for (int g = 0; g < kHeads; ++g)
#pragma unroll
      for (int j = 0; j < kCpl; ++j) {
        const int c = lt + j * L;
        if (c < chunks) {
          float* dst = tacc + (team * kHeads + g) * Dh + c * kVec;
#pragma unroll
          for (int e = 0; e < kVec; e += 4)
            *reinterpret_cast<float4*>(dst + e) =
                make_float4(acc[g][j * kVec + e], acc[g][j * kVec + e + 1],
                            acc[g][j * kVec + e + 2], acc[g][j * kVec + e + 3]);
        }
      }
    if (lt % head_lanes == 0) {
      tml[2 * (team * kHeads + my_head)] = m_me;
      tml[2 * (team * kHeads + my_head) + 1] = l_me;
    }
  }
  __syncthreads();

  // fold the teams in team order: thread tid < kHeads * Dh / 4 owns head g,
  // channels 4 d4 .. 4 d4 + 3
  const int n4 = kHeads * Dh / 4;
  const int g = tid / (Dh / 4), d4 = tid - g * (Dh / 4);
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  float m_all = -INFINITY, l_all = 0.f;
  if (tid < n4) {
#pragma unroll 8
    for (int t = 0; t < nteams; ++t) m_all = fmaxf(m_all, tml[2 * (t * kHeads + g)]);
    const float m_safe = isfinite(m_all) ? m_all : 0.f;
#pragma unroll 8
    for (int t = 0; t < nteams; ++t) {
      const float w = weight(tml[2 * (t * kHeads + g)], m_safe);
      l_all = fmaf(tml[2 * (t * kHeads + g) + 1], w, l_all);
      const float4 v = *reinterpret_cast<const float4*>(tacc + (t * kHeads + g) * Dh + 4 * d4);
      o = make_float4(fmaf(v.x, w, o.x), fmaf(v.y, w, o.y), fmaf(v.z, w, o.z), fmaf(v.w, w, o.w));
    }
  }
  const size_t out_i = (static_cast<size_t>(bk) * a.G + hs * kHeads + g) * Dh + 4 * d4;
  if (a.nsplit == 1) {
    if (tid < n4 && g < gn) {
      const float inv = 1.f / fmaxf(l_all, 1e-30f);
      store_out4(a.out, a.q_bf16, out_i,
                 make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv));
    }
    return;
  }

  // this block's partial, then count it; the last block of the unit folds
  const int rec = kHeads * (Dh + 2);
  float* part = a.part + static_cast<size_t>(unit) * a.nsplit * rec;
  if (tid < n4) {
    *reinterpret_cast<float4*>(part + static_cast<size_t>(split) * rec + g * Dh + 4 * d4) = o;
    if (d4 == 0) {
      part[static_cast<size_t>(split) * rec + kHeads * Dh + 2 * g] = m_all;
      part[static_cast<size_t>(split) * rec + kHeads * Dh + 2 * g + 1] = l_all;
    }
  }
  __syncthreads();
  if (tid == 0)  // release: the block's writes, seen through the barrier; acquire: the others'
    *last_flag = count_in(&a.counters[unit]) == a.nsplit - 1;
  __syncthreads();
  if (!*last_flag) return;
  // the splits in split order, read past L1. The first kPrefetch partial
  // sums of this thread's channels are requested first, then every (m, l)
  // goes into shared memory (the teams' region is free), one load a thread
  const bool folds = tid < n4 && g < gn;
  const float4* part4 = reinterpret_cast<const float4*>(part + g * Dh + 4 * d4);
  float4 pre[kPrefetch];
#pragma unroll
  for (int s = 0; s < kPrefetch; ++s)
    if (folds && s < a.nsplit) pre[s] = __ldcg(part4 + static_cast<size_t>(s) * (rec / 4));
  float* sml = tacc;  // (nsplit, kHeads, 2)
  for (int i = tid; i < a.nsplit * 2 * kHeads; i += kThreads) {
    const int s = i / (2 * kHeads);
    sml[i] = __ldcg(part + static_cast<size_t>(s) * rec + kHeads * Dh + (i - s * 2 * kHeads));
  }
  __syncthreads();
  if (folds) {
    float m_s[kMaxSplits];  // the ring has room for kMaxSplits records: no read leaves it
    m_all = -INFINITY;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      m_s[s] = s < a.nsplit ? sml[2 * (s * kHeads + g)] : -INFINITY;
      m_all = fmaxf(m_all, m_s[s]);
    }
    const float m_safe = isfinite(m_all) ? m_all : 0.f;
    o = make_float4(0.f, 0.f, 0.f, 0.f);
    l_all = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s >= a.nsplit) break;
      const float4 v = s < kPrefetch ? pre[s] : __ldcg(part4 + static_cast<size_t>(s) * (rec / 4));
      const float w = weight(m_s[s], m_safe);
      l_all = fmaf(sml[2 * (s * kHeads + g) + 1], w, l_all);
      o = make_float4(fmaf(v.x, w, o.x), fmaf(v.y, w, o.y), fmaf(v.z, w, o.z), fmaf(v.w, w, o.w));
    }
    const float inv = 1.f / fmaxf(l_all, 1e-30f);
    store_out4(a.out, a.q_bf16, out_i, make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv));
  }
  if (tid == 0) a.counters[unit] = 0;  // ready for the next launch on the stream
}

// the layout the wrapper chose (kernels/decode_attn/decode_attn.py::layout):
// a team a 16-byte chunk a lane, a stage kBatch rows a team
bool valid_layout(int dh, int esize, int lanes, int stage_rows, int stages) {
  const int chunks = dh * esize / 16;
  const int cpl = esize / 2;  // chunks a lane, at most
  return (lanes == 8 || lanes == 16 || lanes == 32) && chunks <= lanes * cpl &&
         stage_rows == kConsumers / lanes * kBatch && stages >= 1 && stages <= kMaxStages &&
         smem_bytes(dh, esize, stage_rows, stages) <= static_cast<size_t>(kMaxSmem) &&
         // the teams' partials fit in the ring
         static_cast<size_t>(kConsumers / lanes) * kHeads * (dh + 2) * 4 <=
             smem_bytes(dh, esize, stage_rows, stages) - kHeader;
}

using Kernel = void (*)(const Args);

// the instance for the cache dtype and the team width (valid_layout holds)
Kernel kernel_for(bool c_bf16, int lanes) {
  if (c_bf16)
    return lanes == 8    ? decode_attn_kernel<__nv_bfloat16, 8>
           : lanes == 16 ? decode_attn_kernel<__nv_bfloat16, 16>
                         : decode_attn_kernel<__nv_bfloat16, 32>;
  return lanes == 8    ? decode_attn_kernel<float, 8>
         : lanes == 16 ? decode_attn_kernel<float, 16>
                       : decode_attn_kernel<float, 32>;
}

cudaError_t prepare(Kernel kernel, int dh, int esize, int stage_rows, int stages,
                    size_t* smem) {
  *smem = smem_bytes(dh, esize, stage_rows, stages);
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  return cudaSuccess;
}

}  // namespace

extern "C" {

// q (B, KV*G, Dh), caches (B, S, KV, Dh), out (B, KV*G, Dh) in q's dtype.
// Rows lo..hi (inclusive, 0 <= lo <= hi < S) are attended to, split into
// nsplit runs of rows_per_split (the last may be shorter; none empty). With
// nsplit > 1: part, float32 scratch of B*KV*ceil(G/4) * nsplit * 4*(Dh+2),
// and counters, int32 of B*KV*ceil(G/4), zero (they are zero again after
// the kernel). lanes, stage_rows, stages: the layout of
// decode_attn.py::layout. q_bf16 / c_bf16: 1 for bfloat16, 0 for float32.
int decode_attn_launch(const void* q, const void* k, const void* v, void* out, float* part,
                       int* counters, int B, int S, int KV, int G, int Dh, int lo, int hi,
                       int rows_per_split, int nsplit, int q_bf16, int c_bf16, int lanes,
                       int stage_rows, int stages, float scale, void* stream) {
  const int n_slices = (G + kHeads - 1) / kHeads;
  if (B < 1 || S < 1 || KV < 1 || G < 1 || Dh < 8 || Dh % 8 != 0 || Dh > kMaxDh ||
      G * Dh > kMaxGDh || lo < 0 || hi < lo || hi >= S || rows_per_split < 1 || nsplit < 1 ||
      nsplit > kMaxSplits || B * KV > 65535 || static_cast<long long>(nsplit - 1) * rows_per_split > hi - lo ||
      static_cast<long long>(nsplit) * rows_per_split < hi - lo + 1 ||
      (nsplit > 1 && (part == nullptr || counters == nullptr)) ||
      !valid_layout(Dh, c_bf16 ? 2 : 4, lanes, stage_rows, stages))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  k,      v,    out, part, counters, S,     KV,         G,      Dh,   lo,
               hi, rows_per_split, nsplit, q_bf16, stage_rows, stages,
               scale * 1.4426950408889634f};
  const Kernel kernel = kernel_for(c_bf16, lanes);
  size_t smem = 0;
  const cudaError_t e = prepare(kernel, Dh, c_bf16 ? 2 : 4, stage_rows, stages, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(nsplit, B * KV, n_slices), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel for this layout that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks, and the
// shared memory a block takes, into *smem.
int decode_attn_max_active_blocks(int c_bf16, int Dh, int lanes, int stage_rows, int stages,
                                  int* blocks, int* smem) {
  if (Dh < 8 || Dh % 8 != 0 || Dh > kMaxDh ||
      !valid_layout(Dh, c_bf16 ? 2 : 4, lanes, stage_rows, stages))
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kernel = kernel_for(c_bf16, lanes);
  size_t bytes = 0;
  cudaError_t e = prepare(kernel, Dh, c_bf16 ? 2 : 4, stage_rows, stages, &bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  *smem = static_cast<int>(bytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, bytes));
}

const char* decode_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
