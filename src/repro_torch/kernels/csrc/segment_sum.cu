// Fixed-order segment sum over a sorted segment list, for Hopper (sm_90a):
//
//   out[s, c] = sum over the edges e with seg[e] == s, in edge order, of
//               v[e, c]            (the plain form: v = vals [E, C])
//               table[idx[e], c]   (the gather form)
//               table[hot[idx[e] - M], c] where idx[e] >= M (the gather
//                                  form with residency: M table rows, and
//                                  idx addresses concat(table, table[hot]))
//   out[s, c] /= max(len_s, 1)     (mean only; len_s the segment's count)
//
// A port-only kernel: the reference computes jax.ops.segment_sum in XLA
// (src/repro/core/stages.py:134-151 for the csr GAT, :305-310 for the
// segment mean of RGCN's csr arm and of GCN), with no Pallas kernel behind
// it.  The port's first version used index_add_, which adds with float
// atomics on a CUDA tensor, so its last bits changed from run to run; this
// kernel adds every segment in one order on every run, so the identities
// the reference holds bitwise (cached == uncached) hold on the card too.
//
// What bounds it on an H100: bytes.  seg (and idx) once, each named table
// row (or each value) once, out once.  The gather form reads a row per
// edge; GCN/Reddit's pool (23,296 x 64 floats at scale 0.1) stays in the
// 50 MB L2, so its ~2.3M row reads a call come from L2, not from memory.
// What sets the time is latency and the order: each segment is one chain
// of dependent adds, and the graphs are power-law (Reddit-like at scale
// 0.1: median degree 82, the largest segment 16,302 edges).
//
// Design: two kernels, one launch after the other on the stream.
//   1. segment_sum_kernel, one warp a segment, the columns across the
//      lanes (lane l holds columns c0 + l + 32 j, j < NF; grid.y walks
//      column blocks of 32 NF).  The segment's first edge is found in the
//      sorted seg by a 32-ary search (each step 32 probes, one ballot: ~5
//      dependent loads at 2.3M edges); its end by one ballot over the next
//      32 edges, or, for a longer segment, a second search.  An integer
//      search is exact, so no batch key beyond seg is needed, and edges
//      with seg >= N are never reached (JAX's segment_sum drops them too).
//      A segment of up to kLong edges is summed by its warp: 32 edges at a
//      time (the gather form loads their 32 indices in one coalesced load
//      and hands them round by shuffles), in batches of B edges whose loads
//      are all in flight together, added in edge order.  A longer segment
//      is appended, with its bounds, to a list (an integer atomic: the
//      list's order changes no sum) and left to the second kernel.  A warp
//      alone would walk it one round trip to L2 (~0.5 us) for 8 edges: the
//      first version of this kernel did, and took 1.2 ms on the 16,302-edge
//      segment of GCN/Reddit while the others were done in < 0.1 ms.
//   2. segment_sum_long_kernel, one block a listed segment (blocks draw
//      segments from a counter): the block's 256 threads stream the
//      segment's rows through a ring of kStages stages of 16 KB in shared
//      memory by cp.async (kStages - 1 stages in flight; the indices of
//      each stage arrive by cp.async kStages - 1 stages ahead of its rows;
//      each copy instruction covers whole 32-byte sectors of a row), and
//      32 NF threads, one a column, add the stage's rows in edge order,
//      the loads of 32 rows ahead of their adds.  Its time is the chain of
//      len dependent adds plus a barrier a stage, not len / 8 round trips
//      (GCN/Reddit at scale 0.1: 0.24 ms a call on an H100, from 1.22 with
//      one warp a segment).  The draw
//      that passes the end last sets the list's counters back to 0 for the
//      next launch.  Measured on an H100 and not kept
//      (scripts/torch_segment_sum_variants.py): 8 KB stages, 12 of them;
//      16 KB stages, 12 of them; 16 edges a batch in the warp kernel;
//      segments over 128 or over 1024 edges to the block kernel.
// Every add is __fadd_rn (no FMA contraction, no float atomics), the mean
// one IEEE division by max(len, 1), and a segment with no edge writes 0,
// never NaN.  The accumulator starts at +0 and adds each value once, in
// edge order, in both kernels, so the result is bitwise the CPU's
// index_add_ in index order (kernels/ref.py), which the chip smoke test and
// the GPU tests hold it to.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // segments a block of the first kernel
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxNF = 8;  // columns a lane: a column block is 256 wide
constexpr int kLong = 256;  // longer segments go to the block kernel
constexpr int kStages = 6;  // ring stages of the block kernel
constexpr int kStageFloats = 4096;  // 16 KB a stage: R rows x 32 NF columns
constexpr int kColsT = kStageFloats / kThreads;  // floats a thread copies
constexpr unsigned kFull = 0xffffffffu;

// the values of B edges loaded together: fewer for wider rows
template <int NF>
__host__ __device__ constexpr int batch_of() {
  return NF <= 2 ? 8 : (NF == 4 ? 4 : 2);
}

// rows a stage of the block kernel, and its shared memory: the row ring
// and the index ring (2 kStages slots of R indices)
__host__ __device__ constexpr int stage_rows(int NF) {
  return kStageFloats / (32 * NF);
}
size_t long_smem_bytes(int NF) {
  return sizeof(float) * kStages * kStageFloats +
         sizeof(int) * 2 * kStages * stage_rows(NF);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The first e in [lo, hi) with seg[e] >= s, or hi when there is none; seg
// sorted ascending.  Warp-uniform: every lane returns the same e.  Each
// step probes lo + l * step for the 32 lanes l; the probes below s form a
// prefix of the lanes (seg is sorted), so their count c places the answer
// in (probe c - 1, probe c], a range of at most `step`.
__device__ __forceinline__ int lower_bound_warp(const int* __restrict__ seg,
                                                int lo, int hi, int s,
                                                int lane) {
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const long long p = (long long)lo + (long long)lane * step;
    const bool below = p < hi && seg[p] < s;
    const int c = __popc(__ballot_sync(kFull, below));
    if (c == 0) return lo;  // seg[lo] >= s
    const long long top = (long long)lo + (long long)c * step;
    lo = lo + (c - 1) * step + 1;
    hi = top < hi ? (int)top : hi;
  }
  const int p = lo + lane;
  const bool below = p < hi && seg[p] < s;
  return lo + __popc(__ballot_sync(kFull, below));
}

template <int NF>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                   const int* __restrict__ hot, int M,
                   const int* __restrict__ seg, float* __restrict__ out,
                   int* __restrict__ longs, int* __restrict__ ctr, int E,
                   int N, int C, int mean) {
  constexpr int B = batch_of<NF>();
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= N) return;  // warp-uniform
  const int c0 = blockIdx.y * 32 * NF;

  // the segment's edges [start, end)
  const int start = lower_bound_warp(seg, 0, E, s, lane);
  int end;
  {
    const int p = start + lane;
    const unsigned in = __ballot_sync(kFull, p < E && seg[p] <= s);
    end = in != kFull ? start + __popc(in)
                      : lower_bound_warp(seg, start + 32, E, s + 1, lane);
  }
  if (end - start > kLong) {  // warp-uniform: to the block kernel
    if (blockIdx.y == 0 && lane == 0) {
      const int at = atomicAdd(&ctr[0], 1);
      longs[3 * at] = s;
      longs[3 * at + 1] = start;
      longs[3 * at + 2] = end;
    }
    return;
  }

  bool valid[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) valid[j] = c0 + j * 32 + lane < C;
  float acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) acc[j] = 0.f;

  // the edges 32 at a time, B loads in flight, added in edge order
  for (int base = start; base < end; base += 32) {
    const int cnt = min(32, end - base);
    int my_row = base + lane;  // the plain form reads row e
    if (idx != nullptr && lane < cnt) {
      my_row = idx[base + lane];
      // a cache index reads the hot row it names, as cached_gather does
      if (hot != nullptr && my_row >= M) my_row = hot[my_row - M];
    }
    for (int i = 0; i < cnt; i += B) {
      float v[B][NF];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int row = __shfl_sync(kFull, my_row, (i + b) & 31);
        const bool ok = i + b < cnt;
        const float* r = vals + (size_t)row * C + c0 + lane;
#pragma unroll
        for (int j = 0; j < NF; ++j) v[b][j] = ok && valid[j] ? r[j * 32] : 0.f;
      }
#pragma unroll
      for (int b = 0; b < B; ++b) {
        if (i + b < cnt) {  // warp-uniform
#pragma unroll
          for (int j = 0; j < NF; ++j) acc[j] = __fadd_rn(acc[j], v[b][j]);
        }
      }
    }
  }

  const float len = mean ? fmaxf((float)(end - start), 1.f) : 1.f;
#pragma unroll
  for (int j = 0; j < NF; ++j)
    if (valid[j])
      out[(size_t)s * C + c0 + j * 32 + lane] =
          mean ? __fdiv_rn(acc[j], len) : acc[j];
}

// One listed segment's rows [start, end), columns [c0, c0 + 32 NF), through
// the ring; thread t < 32 NF returns column c0 + t's sum in edge order.
template <int NF>
__device__ __forceinline__ float long_segment_sum(const float* __restrict__ vals,
                                  const int* __restrict__ idx,
                                  const int* __restrict__ hot, int M,
                                  float* ring,
                                  int* ids, int start, int end, int c0, int C,
                                  bool vec16) {
  constexpr int CB = 32 * NF;          // columns a pass
  constexpr int R = stage_rows(NF);    // rows a stage
  constexpr int TPR = kThreads / R;    // threads a row: CB / kColsT
  constexpr int kIds = 2 * kStages;    // index ring slots
  const int t = threadIdx.x;
  const int my_r = t / TPR, my_j = t % TPR;
  const int n_chunks = (end - start + R - 1) / R;

  // chunk j's R indices into slot j % kIds (the gather form)
  auto copy_ids = [&](int j) {
    const int e = start + j * R + t;
    if (idx != nullptr && t < R && j < n_chunks && e < end)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_addr(ids + (j % kIds) * R + t)),
                   "l"(idx + e));
  };
  // chunk k's rows into stage k % kStages: kColsT floats of this
  // thread's row, as 16-byte copies (columns 4 (j + TPR q)) or 4-byte ones
  // (columns j + TPR q), so that each copy instruction's lanes cover whole
  // 32-byte sectors of a row
  auto copy_rows = [&](int k) {
    const int e = start + k * R + my_r;
    if (k >= n_chunks || e >= end) return;
    int row = idx != nullptr ? ids[(k % kIds) * R + my_r] : e;
    if (hot != nullptr && row >= M) row = hot[row - M];
    const float* src = vals + (size_t)row * C + c0;
    float* dst = ring + (k % kStages) * kStageFloats + my_r * CB;
    if (vec16) {
#pragma unroll
      for (int q = 0; q < kColsT / 4; ++q) {
        const int col = 4 * (q * TPR + my_j);
        if (c0 + col < C)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                           smem_addr(dst + col)),
                       "l"(src + col));
      }
    } else {
#pragma unroll
      for (int q = 0; q < kColsT; ++q) {
        const int col = q * TPR + my_j;
        if (c0 + col < C)
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                           smem_addr(dst + col)),
                       "l"(src + col));
      }
    }
  };
  auto commit = [] { asm volatile("cp.async.commit_group;\n" ::); };

  // prologue: the indices of chunks 0 .. kStages - 2 land first; group
  // G_k then carries chunk k's rows and chunk k + kStages - 1's indices
  for (int j = 0; j < kStages - 1; ++j) copy_ids(j);
  commit();
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  for (int k = 0; k < kStages - 1; ++k) {
    copy_rows(k);
    copy_ids(k + kStages - 1);
    commit();
  }
  float acc = 0.f;
  for (int i = 0; i < n_chunks; ++i) {
    // G_i done: chunk i's rows and chunk i + kStages - 1's indices landed
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();
    if (t < CB && c0 + t < C) {
      const float* st = ring + (i % kStages) * kStageFloats + t;
      const int rows = min(R, end - start - i * R);
      if (rows == R) {  // a whole stage: loads ahead of the adds
        constexpr int G = R < 32 ? R : 32;
#pragma unroll
        for (int r0 = 0; r0 < R; r0 += G) {
          float v[G];
#pragma unroll
          for (int r = 0; r < G; ++r) v[r] = st[(r0 + r) * CB];
#pragma unroll
          for (int r = 0; r < G; ++r) acc = __fadd_rn(acc, v[r]);
        }
      } else {
        for (int r = 0; r < rows; ++r) acc = __fadd_rn(acc, st[r * CB]);
      }
    }
    // G_{i + kStages - 1} into the stage of chunk i - 1, which every
    // thread finished before the barrier above
    copy_rows(i + kStages - 1);
    copy_ids(i + 2 * kStages - 2);
    commit();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();  // the ring is free for the next pass
  return acc;
}

template <int NF>
__global__ void __launch_bounds__(kThreads)
segment_sum_long_kernel(const float* __restrict__ vals,
                        const int* __restrict__ idx,
                        const int* __restrict__ hot, int M,
                        float* __restrict__ out,
                        const int* __restrict__ longs, int* __restrict__ ctr,
                        int C, int mean, int vec16) {
  extern __shared__ __align__(16) float ring[];  // [kStages][kStageFloats]
  int* ids = reinterpret_cast<int*>(ring + kStages * kStageFloats);
  __shared__ int s_item;
  // the first kernel has finished: the list's length is fixed, and is read
  // before this block's first draw, so before the last draw resets it
  const int n_long = *reinterpret_cast<volatile int*>(&ctr[0]);
  for (;;) {
    if (threadIdx.x == 0) {
      const int it = atomicAdd(&ctr[1], 1);
      // every block draws once past the list's end: the last such draw
      // leaves both counters at 0 for the next launch
      if (it == n_long + (int)gridDim.x - 1) {
        ctr[0] = 0;
        ctr[1] = 0;
      }
      s_item = it;
    }
    __syncthreads();
    const int it = s_item;
    __syncthreads();  // s_item is rewritten by the next draw
    if (it >= n_long) break;
    const int s = longs[3 * it], start = longs[3 * it + 1],
              end = longs[3 * it + 2];
    const float len = mean ? fmaxf((float)(end - start), 1.f) : 1.f;
    for (int c0 = 0; c0 < C; c0 += 32 * NF) {
      const float acc = long_segment_sum<NF>(vals, idx, hot, M, ring, ids,
                                             start, end, c0, C, vec16 != 0);
      const int col = c0 + threadIdx.x;
      if (threadIdx.x < 32 * NF && col < C)
        out[(size_t)s * C + col] = mean ? __fdiv_rn(acc, len) : acc;
    }
  }
}

template <int NF>
cudaError_t launch_one(cudaStream_t st, const float* vals, const int* idx,
                       const int* hot, int M, const int* seg, float* out,
                       int* longs, int* ctr, int E, int N, int C, int mean) {
  const dim3 grid((N + kWarps - 1) / kWarps, (C + 32 * NF - 1) / (32 * NF));
  segment_sum_kernel<NF><<<grid, kThreads, 0, st>>>(vals, idx, hot, M, seg,
                                                    out, longs, ctr, E, N, C,
                                                    mean);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the block kernel's shared memory, and the blocks the card holds at
  // once, asked of the runtime once
  auto kernel = segment_sum_long_kernel<NF>;
  const size_t smem = long_smem_bytes(NF);
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // the refusal is returned, not left pending
      return err;
    }
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  // no more blocks than segments can be long
  const int cap = E / (kLong + 1) + 1;
  const bool vec16 = C % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  kernel<<<blocks < cap ? blocks : cap, kThreads, smem, st>>>(
      vals, idx, hot, M, out, longs, ctr, C, mean, vec16 ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" int segment_sum_long_edges() { return kLong; }

// Launch on `stream`: out [N, C] from vals [E, C] (idx null) or from the
// rows idx [E] of the table vals [M, C]; seg [E] sorted ascending.  With
// hot (the residency arm) idx addresses concat(table, table[hot]) and an
// index v >= M reads table row hot[v - M].  N >= 1, C >= 1, E >= 0.
// longs holds 3 (E / (kLong + 1) + 1) ints, ctr 2 ints that are 0 before
// the launch (the kernels leave them at 0).  Returns the cudaError_t of
// the launches (0 on success).
extern "C" int segment_sum_hot_launch(const float* vals, const int* idx,
                                      const int* hot, int M, const int* seg,
                                      float* out, int* longs, int* ctr,
                                      int E, int N, int C, int mean,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || C < 1 || E < 0) return (int)cudaErrorInvalidValue;
  const int nf = (C < 32 * kMaxNF ? C + 31 : 32 * kMaxNF) / 32;
  cudaError_t err;
  if (nf <= 1)
    err = launch_one<1>(st, vals, idx, hot, M, seg, out, longs, ctr, E, N, C,
                        mean);
  else if (nf <= 2)
    err = launch_one<2>(st, vals, idx, hot, M, seg, out, longs, ctr, E, N, C,
                        mean);
  else if (nf <= 4)
    err = launch_one<4>(st, vals, idx, hot, M, seg, out, longs, ctr, E, N, C,
                        mean);
  else
    err = launch_one<8>(st, vals, idx, hot, M, seg, out, longs, ctr, E, N, C,
                        mean);
  return (int)err;
}

// The same without residency.
extern "C" int segment_sum_launch(const float* vals, const int* idx,
                                  const int* seg, float* out, int* longs,
                                  int* ctr, int E, int N, int C, int mean,
                                  void* stream) {
  return segment_sum_hot_launch(vals, idx, nullptr, 0, seg, out, longs, ctr,
                                E, N, C, mean, stream);
}
