// Padded-neighbour sum/mean aggregation for Hopper (sm_90a):
//
//   out[n, :] = sum_{k < K} mask[n, k] * h_src[nbr[n, k], :]
//   out[n, :] /= max(sum_k mask[n, k], 1)                      (mean only)
//
// Replaces the TPU kernel src/repro/kernels/segment_spmm.py::segment_spmm
// (:93; _accumulate :31, _mean :44, bodies _kernel :52 / _stream_kernel
// :60).  The TPU kernel walks the K slots of a [block_n, K] tile in order,
// acc = acc + row * mask, over a resident or chunk-streamed source table in
// VMEM, one grid step after another.
//
// What bounds it on an H100: bytes.  The mask is read once (4 bytes a
// slot), nbr only at the live slots, each source row that a live slot
// names once, out once: under 1 us a RGCN/imdb relation at 3.35 TB/s.
// What sets its time is latency: every gather is a dependent load (mask,
// then index, then row), and the graphs are power-law, so a few rows hold
// up to 64 live slots where most hold one or two.  A warp that walks a
// heavy row by itself (the earlier design: one warp a row, 8 gathers a
// round trip) waits on 8 dependent DRAM round trips for a 64-slot row, and
// that warp sets the launch's time while the others have long finished.
//
// Design: the block gathers its rows' live slots together (the scheme of
// fused_fp_na.cu, steps 1-2).  A block owns kRows destination rows and one
// group of kCols columns (grid.y walks the groups, so any D works), and
// walks K in windows of kWin slots:
//   1. compaction: thread t reads kSlots mask values of row t / 16 (slots
//      4 (t % 16) .. + 3 of the window: one 16-byte load where K % 4 == 0
//      and the mask is 16-byte aligned, else four scalar loads), loads nbr
//      at its live slots only, and the block compacts the live slots into
//      one list in shared memory, (mask, index) pairs, rows in order and
//      slots in order within a row (a ballot per slot of the four and
//      popcounts give each thread its place);
//   2. gathers: the listed rows' kCols-column segments stream into a ring
//      of kStages chunks of kChunk entries through cp.async (16-byte copies
//      where D % 4 == 0 and h_src is 16-byte aligned, else 8 or 4 bytes),
//      all kStages chunks in flight together: 256 entries, more than any
//      block of the RGCN/imdb padded relations holds (at most 121), so such
//      a block waits on one round of gathers however its live slots fall
//      on its rows;
//   3. sums: the 16 threads that compacted a row then own it, 4 columns
//      each (16-byte shared loads), and add its entries in slot order with
//      the earlier kernel's arithmetic, acc = acc + row * m and deg = deg +
//      m, every product and sum rounded on its own (__fmul_rn / __fadd_rn,
//      no FMA contraction); the sums stay in registers across chunks and
//      windows, and the block's rows advance together, so a 64-slot row
//      costs 64 shared-memory steps, not 8 DRAM round trips;
//   4. the mean: one IEEE division by max(deg, 1); out written once.
// 73.8 KB of shared memory and 52 registers a thread give 3 blocks an SM,
// so the padded RGCN/imdb relations (131-329 blocks) run in one wave.
// Measured on an H100 and not kept: 32 rows a block and ring chunks of 64
// entries in 2 or 4 stages (scripts/torch_kernel_variants.py), and a
// thread a column of 4 rows (each row then summed by one warp after
// another).
// Skipping a slot whose mask is 0 gives the same bits as adding row * 0
// for a finite row (the accumulator starts at +0, never becomes -0, and
// x + (+-0) == x), so the output is bitwise the earlier kernel's and the
// emulation's (segment_spmm.py), and all-masked rows come out exactly 0.
// No atomics: a row is reduced in one order on every run.  No K is
// refused: the list holds one window's kRows * kWin entries whatever K is.
//
// The TPU's resident / streaming split (an 8 MB VMEM budget) and its chunk
// schedule have no counterpart: every block reads the source table through
// the 50 MB L2 (RGCN/imdb tables are 0.5-1.3 MB).
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;   // destination rows a block
constexpr int kCols = 64;   // columns a block
constexpr int kThreads = 256;
constexpr int kSlots = 4;   // mask values a thread reads a window
constexpr int kLanesRow = kThreads / kRows;  // threads a row: 16
constexpr int kWin = kLanesRow * kSlots;     // slots a window: 64
constexpr int kColsT = kCols / kLanesRow;    // columns a thread sums: 4
constexpr int kVecT = kColsT / 4;            // its float4s
constexpr int kChunk = 128;  // list entries a ring stage
constexpr int kStages = 2;
constexpr int kMinBlocks = 3;  // blocks an SM
constexpr unsigned kFull = 0xffffffffu;
static_assert(kLanesRow == 8 || kLanesRow == 16, "whole rows a warp");
static_assert(kRows <= 32, "a warp scans the rows' counts");
static_assert(kColsT % 4 == 0, "a thread sums float4s of its row");

// ring [kStages][kChunk][kCols] | list m [kRows * kWin] | list index
// [kRows * kWin] (ints) | live count a row [kRows] (ints): 73,792 bytes
constexpr size_t kSmemBytes =
    sizeof(float) * ((size_t)kStages * kChunk * kCols +
                     2 * (size_t)kRows * kWin + kRows);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Ring stage st <- list entries [lo, hi), columns [c0, c0 + cw) of their
// rows of h_src, VEC floats a copy (cp.async of 4 * VEC bytes), entry e at
// row e - lo of the stage; neighbouring threads copy neighbouring columns
// of one entry.  cw and D are multiples of VEC.
template <int VEC>
__device__ __forceinline__ void copy_chunk(float* st,
                                           const float* __restrict__ h_src,
                                           const int* s_idx, int lo, int hi,
                                           int c0, int cw, int D) {
  constexpr int kPerEntry = kCols / VEC;  // copies an entry
#pragma unroll 4
  for (int q = 0; q < kChunk * kPerEntry / kThreads; ++q) {
    const int lin = threadIdx.x + q * kThreads;
    const int e = lo + lin / kPerEntry, col = VEC * (lin % kPerEntry);
    if (e < hi && col < cw) {
      const float* src = h_src + (size_t)s_idx[e] * D + c0 + col;
      const uint32_t dst = smem_addr(st + (lin / kPerEntry) * kCols + col);
      if constexpr (VEC == 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                     "l"(src));
      else if constexpr (VEC == 2)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                     "l"(src));
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                     "l"(src));
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
segment_spmm_kernel(const float* __restrict__ h_src,
                    const int* __restrict__ nbr,
                    const float* __restrict__ mask, float* __restrict__ out,
                    int N, int K, int D, int mean, int vec_mask,
                    int vec_rows, int vec_out) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                      // the ring
  float* s_m = ring + kStages * kChunk * kCols;            // list m
  int* s_idx = reinterpret_cast<int*>(s_m + kRows * kWin);  // list index
  int* s_cnt = s_idx + kRows * kWin;                       // live a row
  const int t = threadIdx.x, lane = t & 31;
  const int n0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * kCols;
  const int cw = min(kCols, D - c0);
  // the compaction: this thread's row and slots, the lanes of its row,
  // and those of them below it
  const int rr = t / kLanesRow;
  const bool row_ok = n0 + rr < N;
  const int j4 = (t % kLanesRow) * kSlots;
  const unsigned row_lanes = ((1u << kLanesRow) - 1u)
                             << (lane & (32 - kLanesRow));
  const unsigned below = row_lanes & ((1u << lane) - 1u);
  // the sums: this thread's kColsT columns [cq, cq + kColsT) of row rr
  const int cq = (t % kLanesRow) * kColsT;
  float4 acc[kVecT];
#pragma unroll
  for (int h = 0; h < kVecT; ++h) acc[h] = make_float4(0.f, 0.f, 0.f, 0.f);
  float deg = 0.f;

  for (int w0 = 0; w0 < K; w0 += kWin) {
    // 1. this thread's mask values, its live slots' indices, and their
    //    place in the block's list
    const int j0 = w0 + j4;
    const size_t at0 = (size_t)(n0 + rr) * K + j0;
    float m[kSlots];
    if (vec_mask) {  // K % 4 == 0: four slots are all in the row or none
      const float4 v = row_ok && j0 < K
                           ? __ldg(reinterpret_cast<const float4*>(mask + at0))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      m[0] = v.x, m[1] = v.y, m[2] = v.z, m[3] = v.w;
    } else {
#pragma unroll
      for (int u = 0; u < kSlots; ++u)
        m[u] = row_ok && j0 + u < K ? __ldg(mask + at0 + u) : 0.f;
    }
    int idx[kSlots];
#pragma unroll
    for (int u = 0; u < kSlots; ++u)
      idx[u] = m[u] != 0.f ? __ldg(nbr + at0 + u) : 0;
    int before = 0, cnt = 0;
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      const unsigned b = __ballot_sync(kFull, m[u] != 0.f);
      before += __popc(b & below);
      cnt += __popc(b & row_lanes);
    }
    if (t % kLanesRow == 0) s_cnt[rr] = cnt;
    __syncthreads();
    // the list's row offsets, by a scan over the rows' counts in every
    // warp (lane r holds row r): this thread's row starts at off, and the
    // window's list holds n_live entries
    const int cr = lane < kRows ? s_cnt[lane] : 0;
    int inc = cr;
#pragma unroll
    for (int d = 1; d < kRows; d <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += y;
    }
    const int n_live = __shfl_sync(kFull, inc, kRows - 1);
    const int off = __shfl_sync(kFull, inc - cr, rr);
    int at = off + before;
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      if (m[u] != 0.f) {
        s_m[at] = m[u];
        s_idx[at] = idx[u];
        ++at;
      }
    }
    __syncthreads();

    // 2.-3. the list's rows through the ring, kStages chunks in flight;
    //    step g fills stage g % kStages
    const int n_chunks = (n_live + kChunk - 1) / kChunk;
    auto issue = [&](int g) {
      if (g < n_chunks) {
        float* stage = ring + (g % kStages) * kChunk * kCols;
        const int lo = g * kChunk, hi = min(n_live, lo + kChunk);
        if (vec_rows == 4)
          copy_chunk<4>(stage, h_src, s_idx, lo, hi, c0, cw, D);
        else if (vec_rows == 2)
          copy_chunk<2>(stage, h_src, s_idx, lo, hi, c0, cw, D);
        else
          copy_chunk<1>(stage, h_src, s_idx, lo, hi, c0, cw, D);
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
#pragma unroll
    for (int g = 0; g < kStages - 1; ++g) issue(g);
    for (int ch = 0; ch < n_chunks; ++ch) {
      issue(ch + kStages - 1);  // into the stage freed after step ch - 1
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1)
                   : "memory");
      __syncthreads();  // every thread's copies of chunk ch have landed
      const float* stage = ring + (ch % kStages) * kChunk * kCols + cq;
      const int lo = ch * kChunk, hi = min(n_live, lo + kChunk);
      const int e1 = min(off + cnt, hi);
#pragma unroll 8
      for (int e = max(off, lo); e < e1; ++e) {  // slot order
        const float mv = s_m[e];
        deg = __fadd_rn(deg, mv);
#pragma unroll
        for (int h = 0; h < kVecT; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              stage + (e - lo) * kCols + 4 * h);
          acc[h].x = __fadd_rn(acc[h].x, __fmul_rn(v.x, mv));
          acc[h].y = __fadd_rn(acc[h].y, __fmul_rn(v.y, mv));
          acc[h].z = __fadd_rn(acc[h].z, __fmul_rn(v.z, mv));
          acc[h].w = __fadd_rn(acc[h].w, __fmul_rn(v.w, mv));
        }
      }
      __syncthreads();  // the stage is refilled kStages - 1 steps on
    }
  }

  // 4. the mean, and out once (columns past cw were summed from stale
  //    shared memory and are not stored)
  if (n0 + rr < N) {
    float* o = out + (size_t)(n0 + rr) * D + c0 + cq;
#pragma unroll
    for (int h = 0; h < kVecT; ++h) {
      float4 a = acc[h];
      if (mean) {
        const float d = fmaxf(deg, 1.f);
        a.x = __fdiv_rn(a.x, d);
        a.y = __fdiv_rn(a.y, d);
        a.z = __fdiv_rn(a.z, d);
        a.w = __fdiv_rn(a.w, d);
      }
      if (vec_out && cq + 4 * h < cw) {  // cw % 4 == 0
        *reinterpret_cast<float4*>(o + 4 * h) = a;
      } else if (!vec_out) {
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (cq + 4 * h + u < cw) o[4 * h + u] = av[u];
      }
    }
  }
}

}  // namespace

// The block geometry, for the emulation's and the tests' copies: rows a
// block, slots a window, entries a ring stage, ring stages.
extern "C" void segment_spmm_geometry(int* g) {
  g[0] = kRows;
  g[1] = kWin;
  g[2] = kChunk;
  g[3] = kStages;
}

// h_src [M, D], nbr [N, K] int32, mask [N, K], out [N, D]; fp32 on the
// device.  Live slots (mask != 0) must name rows in [0, M).  Launches on
// `stream` and returns the cudaError_t of the launch (0 on success).  The
// kernel's shared memory (kSmemBytes, over the 48 KB default) is allowed
// once, at the first launch.
extern "C" int segment_spmm_launch(const float* h_src, const int* nbr,
                                   const float* mask, float* out, int N,
                                   int K, int D, int mean, void* stream) {
  if (N == 0 || D == 0) return 0;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_spmm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // the refusal is returned, not left pending
      return (int)err;
    }
    smem_set = true;
  }
  const int vec_mask =
      K % 4 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  const uintptr_t h = reinterpret_cast<uintptr_t>(h_src);
  const int vec_rows =
      D % 4 == 0 && h % 16 == 0 ? 4 : (D % 2 == 0 && h % 8 == 0 ? 2 : 1);
  const int vec_out =
      D % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((N + kRows - 1) / kRows, (D + kCols - 1) / kCols);
  segment_spmm_kernel<<<grid, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      h_src, nbr, mask, out, N, K, D, mean, vec_mask, vec_rows, vec_out);
  return (int)cudaGetLastError();
}
