// Fused Feature Projection + Neighbour Aggregation for Hopper (sm_90a):
//
//   agg[n, :] = sum_k mask[n, k] * x[nbr[n, k], :]   (/ max(sum_k mask, 1))
//   out[n, :] = agg[n, :] @ W                         x [M, F], W [F, D]
//
// Replaces the TPU kernel src/repro/kernels/fused_fp_na.py::fused_fp_na
// (:91; bodies _kernel :43 / _stream_kernel :54, F-tile accumulation
// _write_partial :32).  Like the TPU kernel it aggregates the RAW features
// per F-tile with segment_spmm's slot walk and projects the aggregate in
// the kernel body, so the projected table and the aggregate never go to
// device memory.
//
// What bounds it on an H100: at the RGCN/imdb (M, md, D) shape the
// 2*N*F*D = 0.82 GFLOP of the product (12.2 us at 67 TFLOP/s fp32, 5.0 us
// for the three TF32 products below at 495 TFLOP/s), then the raw rows
// that live slots name (2270 rows of 12 KB, 8.3 us at 3.35 TB/s).  The
// gathers are data-dependent: a block's 64 rows hold 116 live slots on
// average and up to 222, a row up to 64, so a warp that gathered its own
// rows would wait on its heaviest row; the block gathers together instead.
//
// Design.  The grid is (kSlices F-slices) x (row tiles of kRows rows), two
// blocks an SM, one wave at the RGCN/imdb shape.  A block walks the F-tiles
// (kBF raw-feature columns each) of its slice in order:
//   1. once, the block compacts its rows' live slots (mask != 0) into one
//      list in shared memory, rows in order and slots in order within a
//      row (a ballot per 32 slots, then row offsets);
//   2. per F-tile, the list's rows (kBF columns of each) go through a ring
//      of kStages chunks of kChunk entries in shared memory: every thread
//      issues cp.async copies of its share of a chunk, kStages - 1 chunks
//      ahead, so a block keeps 16 KB of gathers in flight whichever of its
//      rows they serve, and the ring runs on across F-tiles (the next
//      tile's first chunks land during this tile's product).  Thread (q,
//      c) owns column c of rows q, q + kQ, ... and adds each row's entries
//      with segment_spmm's arithmetic (acc = acc + x * m in slot order,
//      each step rounded) into the [kRows, kBF] aggregate tile, so a
//      64-slot row costs 64 steps of 64 threads, not of one;
//   3. the product of the aggregate tile and W's tile (staged from
//      registers loaded during the previous tile's product) runs on the
//      tensor cores, mma.sync m16n8k8 in TF32 with a 3xTF32 split: each
//      operand a = a_hi + a_lo (a_hi = a rounded to TF32, a_lo = the rest
//      rounded to TF32) and acc += a_lo b_hi + a_hi b_lo + a_hi b_hi, in k
//      order over the slice, so the sum keeps about fp32's 24 bits (a
//      single TF32 product keeps 11 and misses the fp32 tolerance at F =
//      3066).  Each warp owns a 16 x 32 block of the [kRows, 64] outputs;
//   4. the slices' [kRows, 64] partials go to a scratch buffer, and the
//      row tile's last block to finish (an integer counter per row tile)
//      sums them in slice order, partial 0 first, and with the mean divides
//      the sum by max(deg, 1) (deg = sum of the row's mask in slot order):
//      by linearity the TPU's per-tile mean, one IEEE division an output
//      instead of one a raw feature.
// No float is summed with atomics, so a run gives the same bits every
// time.  All-masked rows have a zero aggregate and come out exactly 0.  Any
// F (the last tile is partial, read without a padding copy; slices past
// the last tile add a zero partial), mean on or off; D is the hidden width
// of every model that calls it, kD = 64 (the launcher refuses another D
// and a K whose shared memory does not fit: the row tile's slot list holds
// kRows * K entries, so K <= 334).
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kSlices = 8;  // F-slices a row tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;  // destination rows a block
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kBF = 64;     // raw-feature columns an F-tile
constexpr int kAggLd = 68;  // agg row stride: A fragments without conflicts
constexpr int kQ = kThreads / kBF;  // row phases of the aggregation
constexpr int kRowsQ = kRows / kQ;   // rows a thread aggregates
constexpr int kWLd = 72;    // W tile row stride: B fragments without them
constexpr int kChunk = 32;  // list entries a ring stage
constexpr int kStages = 3;
constexpr int kD = 64;  // output columns
constexpr int kWVec = kBF * kD / 4 / kThreads;  // W float4s a thread: 4
static_assert(kRows == 64 && kD == 64 && kWarps == 8, "16 x 32 a warp");
static_assert(kQ * kBF == kThreads && kRows % kQ == 0, "whole row phases");
constexpr unsigned kFull = 0xffffffffu;

// Shared memory (floats): agg [kRows][kAggLd] | W tile [kBF][kWLd] (the
// partial [kRows][kD] at the end) | ring [kStages][kChunk][kBF] | live m
// [kRows*K] | live idx [kRows*K] (ints) | row offsets [kRows + 1] (ints)
// | the last-block flag (int) | row degrees max(deg, 1) [kRows]
size_t smem_bytes(int K) {
  return sizeof(float) * ((size_t)kRows * kAggLd + (size_t)kBF * kWLd +
                          (size_t)kStages * kChunk * kBF +
                          2 * (size_t)kRows * K + 2 * kRows + 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// a rounded to TF32 (nearest, ties away), as the bits of an fp32 value
__device__ __forceinline__ uint32_t tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

// acc += A (16x8, row) B (8x8, col) on the tensor cores, TF32 in, fp32 acc
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One ring stage: entries [e0, e0 + kChunk) of the list, columns [f0, f0 +
// kBF) of their rows of x, VEC floats a copy (cp.async of 4 * VEC bytes);
// columns past fw and entries past n_live are zero-filled.  fw is a
// multiple of VEC unless it ends F, and F is a multiple of VEC.
template <int VEC>
__device__ __forceinline__ void copy_chunk(float* st,
                                           const float* __restrict__ x,
                                           const int* s_idx, int e0,
                                           int n_live, int f0, int fw,
                                           int F) {
  constexpr int kPerEntry = kBF / VEC;  // copies an entry
#pragma unroll
  for (int q = 0; q < kChunk * kPerEntry / kThreads; ++q) {
    const int lin = threadIdx.x + q * kThreads;
    const int e = e0 + lin / kPerEntry, col = VEC * (lin % kPerEntry);
    float* dst = st + (lin / kPerEntry) * kBF + col;
    if (e < n_live && col < fw) {
      const float* src = x + (size_t)s_idx[e] * F + f0 + col;
      if constexpr (VEC == 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_addr(dst)),
                     "l"(src));
      else if constexpr (VEC == 2)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                         smem_addr(dst)),
                     "l"(src));
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                         smem_addr(dst)),
                     "l"(src));
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) dst[v] = 0.f;
    }
  }
}

// W rows [f0, f0 + fw) into registers; rows past fw (up to the tile) are 0.
__device__ __forceinline__ void load_w(const float* __restrict__ W, int f0,
                                       int fw, float4 (&wr)[kWVec]) {
#pragma unroll
  for (int j = 0; j < kWVec; ++j) {
    const int v = threadIdx.x + j * kThreads;  // float4 index in the tile
    const int k = v / (kD / 4);
    wr[j] = k < fw ? __ldg(reinterpret_cast<const float4*>(
                               W + (size_t)(f0 + k) * kD) + v % (kD / 4))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
fused_fp_na_kernel(const float* __restrict__ x, const float* __restrict__ W,
                   const int* __restrict__ nbr,
                   const float* __restrict__ mask, float* __restrict__ out,
                   float* __restrict__ part, int* __restrict__ done, int N,
                   int K, int F, int mean) {
  extern __shared__ __align__(16) float smem[];
  float* agg = smem;                                   // [kRows][kAggLd]
  float* w_t = agg + kRows * kAggLd;                   // [kBF][kWLd]
  float* ring = w_t + kBF * kWLd;                      // [kStages][kChunk][kBF]
  float* s_m = ring + kStages * kChunk * kBF;          // [kRows * K]
  int* s_idx = reinterpret_cast<int*>(s_m + kRows * K);  // [kRows * K]
  int* s_start = s_idx + kRows * K;                    // [kRows + 1]
  int* s_last = s_start + kRows + 1;
  float* s_deg = reinterpret_cast<float*>(s_last + 1);  // [kRows]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slice = blockIdx.x;
  const int n0 = blockIdx.y * kRows;

  // 1. the block's live slots, rows in order, slots in order: counts, row
  //    offsets, then the entries.  A warp loads its rows' mask (and then
  //    index) values for 32 slots together, one round trip for all rows.
  const int r0 = warp * kRowsPerWarp;
  int cnt[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) cnt[i] = 0;
  for (int base = 0; base < K; base += 32) {
    const int j = base + lane;
    float m_l[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
      m_l[i] = n0 + r0 + i < N && j < K ? mask[(size_t)(n0 + r0 + i) * K + j]
                                        : 0.f;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
      cnt[i] += __popc(__ballot_sync(kFull, m_l[i] != 0.f));
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s_start[r0 + i + 1] = cnt[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s_start[0] = 0;
    for (int r = 0; r < kRows; ++r) s_start[r + 1] += s_start[r];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) cnt[i] = s_start[r0 + i];
  for (int base = 0; base < K; base += 32) {
    const int j = base + lane;
    float m_l[kRowsPerWarp];
    int idx_l[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const bool ok = n0 + r0 + i < N && j < K;
      const size_t at = (size_t)(n0 + r0 + i) * K + j;
      m_l[i] = ok ? mask[at] : 0.f;
      idx_l[i] = ok ? nbr[at] : 0;
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const unsigned live = __ballot_sync(kFull, m_l[i] != 0.f);
      if (m_l[i] != 0.f) {
        const int at = cnt[i] + __popc(live & ((1u << lane) - 1u));
        s_m[at] = m_l[i];
        s_idx[at] = idx_l[i];
      }
      cnt[i] += __popc(live);
    }
  }
  __syncthreads();

  // the rows' degrees, sum of m in slot order (the mean divides the
  // output by max(deg, 1) once, after the slices are summed)
  if (threadIdx.x < kRows) {
    float d = 0.f;
    for (int e = s_start[threadIdx.x]; e < s_start[threadIdx.x + 1]; ++e)
      d = __fadd_rn(d, s_m[e]);
    s_deg[threadIdx.x] = fmaxf(d, 1.f);
  }
  __syncthreads();

  // this slice's F-tiles [t0, t1), and the ring's chunks: n_chunks a tile
  const int n_tiles = (F + kBF - 1) / kBF;
  const int per = (n_tiles + kSlices - 1) / kSlices;
  const int t0 = min(n_tiles, slice * per);
  const int t1 = min(n_tiles, t0 + per);
  const int n_live = s_start[kRows];
  // this thread's column and rows in the aggregation: column ca of rows
  // qa + kQ i (a warp's lanes share their rows)
  const int ca = threadIdx.x % kBF, qa = threadIdx.x / kBF;

  const int n_chunks = (n_live + kChunk - 1) / kChunk;
  const int n_steps = (t1 - t0) * n_chunks;

  // step g of the ring: chunk g % n_chunks of F-tile t0 + g / n_chunks,
  // into stage g % kStages; a thread's copies are VEC floats each (16 or 8
  // bytes where the rows allow, else 4), neighbouring threads on
  // neighbouring columns of one entry
  const int vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
                      ? 4
                      : (F % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0
                             ? 2
                             : 1);
  auto issue = [&](int g) {
    if (g < n_steps) {
      const int c = g % n_chunks;
      const int f0 = (t0 + g / n_chunks) * kBF;
      const int fw = min(kBF, F - f0);
      float* st = ring + (g % kStages) * kChunk * kBF;
      if (vec == 4)
        copy_chunk<4>(st, x, s_idx, c * kChunk, n_live, f0, fw, F);
      else if (vec == 2)
        copy_chunk<2>(st, x, s_idx, c * kChunk, n_live, f0, fw, F);
      else
        copy_chunk<1>(st, x, s_idx, c * kChunk, n_live, f0, fw, F);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // this warp's 16 x 32 block of the outputs: rows m0 + g (+ 8), columns
  // n0c + 8 j + 2 t (+ 1), as the mma fragments hold them
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (warp >> 1), n0c = 32 * (warp & 1);
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  float4 wr[kWVec];
  if (t0 < t1) load_w(W, t0 * kBF, min(kBF, F - t0 * kBF), wr);
#pragma unroll
  for (int g = 0; g < kStages - 1; ++g) issue(g);

  for (int t = t0; t < t1; ++t) {
    const int f0 = t * kBF;
    const int fw = min(kBF, F - f0);
    // the W tile, from registers
#pragma unroll
    for (int j = 0; j < kWVec; ++j) {
      const int v = threadIdx.x + j * kThreads;
      *reinterpret_cast<float4*>(&w_t[(v / (kD / 4)) * kWLd +
                                      4 * (v % (kD / 4))]) = wr[j];
    }
    // 2. the aggregate tile, chunk by chunk from the ring: each thread
    //    takes its rows in order and a row's entries in slot order (a
    //    row's entries may span chunks; rows with none come out 0)
    int ri = 0;  // the current row: qa + kQ * ri
    int rs = s_start[qa], re = s_start[qa + 1];
    float a = 0.f;
    auto finish_row = [&]() {
      agg[(qa + kQ * ri) * kAggLd + ca] = a;  // columns past fw hold 0
      a = 0.f;
      if (++ri < kRowsQ) {
        rs = s_start[qa + kQ * ri];
        re = s_start[qa + kQ * ri + 1];
      }
    };
    for (int c = 0; c < n_chunks; ++c) {
      const int g = (t - t0) * n_chunks + c;
      issue(g + kStages - 1);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1)
                   : "memory");
      __syncthreads();  // every thread's copies of step g have landed
      const float* st = ring + (g % kStages) * kChunk * kBF + ca;
      const int lo = c * kChunk, hi = min(n_live, lo + kChunk);
      while (ri < kRowsQ && rs < hi) {  // warp-uniform
        const int e1 = min(re, hi);
        for (int e = max(rs, lo); e < e1; e += 4) {  // slot order
          float m[4], v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {  // loads first, then the sums
            const int eu = e + u < e1 ? e + u : e;
            m[u] = s_m[eu];
            v[u] = st[(eu - lo) * kBF];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (e + u < e1) {
              a = __fadd_rn(a, __fmul_rn(v[u], m[u]));
            }
          }
        }
        if (re > hi) break;  // the row goes on in the next chunk
        finish_row();
      }
      __syncthreads();  // the stage is refilled kStages - 1 steps on
    }
    while (ri < kRowsQ) finish_row();
    __syncthreads();
    // the next tile's W goes in flight during the product
    if (t + 1 < t1) load_w(W, f0 + kBF, min(kBF, F - f0 - kBF), wr);
    // 3. the product on the tensor cores, 3xTF32, k in order (rows and
    //    columns past fw are 0)
    const int kmax = (fw + 7) & ~7;
    for (int k0 = 0; k0 < kmax; k0 += 8) {
      uint32_t ah[4], al[4];
      const float av[4] = {agg[(m0 + gq) * kAggLd + k0 + tq],
                           agg[(m0 + gq + 8) * kAggLd + k0 + tq],
                           agg[(m0 + gq) * kAggLd + k0 + tq + 4],
                           agg[(m0 + gq + 8) * kAggLd + k0 + tq + 4]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[i] = tf32(av[i]);
        al[i] = tf32(av[i] - __uint_as_float(ah[i]));
      }
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0c + 8 * j + gq;
        const float b[2] = {w_t[(k0 + tq) * kWLd + col],
                            w_t[(k0 + tq + 4) * kWLd + col]};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bh[j][h] = tf32(b[h]);
          bl[j][h] = tf32(b[h] - __uint_as_float(bh[j][h]));
        }
      }
      // per output the same three products in the same order; the four
      // column blocks interleaved, so no product waits on the one before
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[j], al, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);
    }
    __syncthreads();  // agg and w_t are rewritten by the next F-tile
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // 4. this slice's partial to the scratch buffer; the row tile's last
  //    block sums the kSlices partials in slice order
  const int n_pad = gridDim.y * kRows;
  float* my_part = part + ((size_t)slice * n_pad + n0) * kD;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0c + 8 * j + 2 * tq;
    *reinterpret_cast<float2*>(&my_part[(m0 + gq) * kD + col]) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(&my_part[(m0 + gq + 8) * kD + col]) =
        make_float2(acc[j][2], acc[j][3]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *s_last = atomicAdd(&done[blockIdx.y], 1) == kSlices - 1;
    if (*s_last) done[blockIdx.y] = 0;  // for the next launch
  }
  __syncthreads();
  if (*s_last) {
    __threadfence();
    for (int o = threadIdx.x; o < kRows * kD; o += kThreads) {
      const int n = n0 + o / kD;
      if (n >= N) break;  // o grows with n
      const float* p = part + (size_t)n * kD + o % kD;
      float v = __ldcg(p);
#pragma unroll
      for (int s = 1; s < kSlices; ++s)
        v = __fadd_rn(v, __ldcg(p + (size_t)s * n_pad * kD));
      out[(size_t)n * kD + o % kD] = mean ? __fdiv_rn(v, s_deg[o / kD]) : v;
    }
  }
}

}  // namespace

extern "C" int fused_fp_na_slices() { return kSlices; }

extern "C" int fused_fp_na_rows() { return kRows; }

// x [M, F], W [F, 64], nbr [N, K] int32, mask [N, K], out [N, 64]; fp32 on
// the device, W 16-byte aligned.  part is scratch of kSlices * ceil(N /
// kRows) * kRows * 64 floats, done of ceil(N / kRows) ints that are 0
// before the launch (the kernel leaves them at 0 again).  Live slots (mask
// != 0) must name rows in [0, M).  Launches on `stream` and returns the
// cudaError_t of the launch (0 on success): cudaErrorInvalidValue for D !=
// 64 or a misaligned W, and the error of cudaFuncSetAttribute for a K whose
// shared memory does not fit a block (K > 334: smem_bytes).
extern "C" int fused_fp_na_launch(const float* x, const float* W,
                                  const int* nbr, const float* mask,
                                  float* out, float* part, int* done, int N,
                                  int K, int F, int D, int mean,
                                  void* stream) {
  if (D != kD || reinterpret_cast<uintptr_t>(W) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const size_t smem = smem_bytes(K);
  static size_t set_smem = 48 * 1024;  // the largest size set so far
  if (smem > set_smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_fp_na_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // the refusal is returned, not left pending
      return (int)err;
    }
    set_smem = smem;
  }
  const int tiles = (N + kRows - 1) / kRows;
  fused_fp_na_kernel<<<dim3(kSlices, tiles), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, W, nbr, mask, out, part, done, N, K, F, mean);
  return (int)cudaGetLastError();
}
