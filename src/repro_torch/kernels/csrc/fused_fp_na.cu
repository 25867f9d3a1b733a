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
// Design.  One block owns kRows destination rows and walks the F-tiles of
// kBF raw-feature columns in order:
//   1. once per block, each warp compacts its rows' live slots (mask != 0)
//      into shared memory, in slot order, by ballot, and sums the degree
//      in that order;
//   2. per F-tile, W[f0 : f0 + kBF, :] is staged in shared memory, and the
//      warps build the [kRows, kBF] aggregate tile in shared memory with
//      segment_spmm's arithmetic (rows of kBatch live slots loaded
//      together, then acc = acc + x * m in slot order, each step rounded;
//      the mean is one IEEE division per F-tile, as the TPU's _mean);
//   3. every thread accumulates its outputs of the [kRows, D] product in
//      registers, fp32 FMA, k in order over the whole of F.
// out is written once, after the last F-tile; nothing is summed across
// blocks, so there are no atomics and a run gives the same bits every
// time.  Any F (the last tile is partial, no padding copy), mean on or
// off; D is the hidden width of every model that calls it, kD = 64 (the
// launcher refuses another D and a K whose shared memory does not fit).
//
// What bounds it on an H100: at the RGCN/imdb (M, md, D) shape, bytes and
// operations about equally — the raw rows that live slots name (up to
// 12 KB each; x_M is 52 MB) and 2*N*F*D = 0.82 GFLOP of the product at
// 67 TFLOP/s fp32.  The product runs on the SIMT cores in fp32 (TF32 /
// wgmma is a tolerance question left open).
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;  // destination rows per block
constexpr int kBF = 64;    // raw-feature columns per F-tile: two per lane
// live slots whose rows are loaded together: a row at the 64-slot cap costs
// 64 / kBatch dependent rounds on every F-tile (one block an SM at the
// RGCN/imdb shape, so registers are not what limits residency)
constexpr int kBatch = 16;
constexpr int kD = 64;  // output columns
constexpr int kOut = kRows * kD / kThreads;  // outputs per thread: 4
static_assert(kOut * kThreads == kRows * kD, "whole outputs a thread");
constexpr unsigned kFull = 0xffffffffu;

// Shared memory: agg [kRows*kBF] | W tile [kBF*kD] | live m [kRows*K] |
// deg [kRows] | live idx [kRows*K] | live count [kRows]
size_t smem_bytes(int K) {
  return sizeof(float) * ((size_t)kRows * kBF + (size_t)kBF * kD +
                          (size_t)kRows * K + kRows) +
         sizeof(int) * ((size_t)kRows * K + kRows);
}

__global__ void __launch_bounds__(kThreads)
fused_fp_na_kernel(const float* __restrict__ x, const float* __restrict__ W,
                   const int* __restrict__ nbr,
                   const float* __restrict__ mask, float* __restrict__ out,
                   int N, int K, int F, int mean) {
  extern __shared__ float smem[];
  float* agg = smem;                          // [kRows, kBF]
  float* w_t = agg + kRows * kBF;             // [kBF, kD]
  float* s_m = w_t + kBF * kD;                // [kRows, K]
  float* s_deg = s_m + kRows * K;             // [kRows]
  int* s_idx = reinterpret_cast<int*>(s_deg + kRows);  // [kRows, K]
  int* s_cnt = s_idx + kRows * K;             // [kRows]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kRows;

  // 1. compact each row's live slots, in slot order
  for (int r = warp; r < kRows; r += kWarps) {
    const int n = n0 + r;
    int cnt = 0;
    if (n < N) {  // warp-uniform
      const int* nb = nbr + (size_t)n * K;
      const float* mk = mask + (size_t)n * K;
      for (int base = 0; base < K; base += 32) {
        const int j = base + lane;
        const float m_l = j < K ? mk[j] : 0.f;
        const unsigned live = __ballot_sync(kFull, m_l != 0.f);
        if (m_l != 0.f) {
          const int pos = cnt + __popc(live & ((1u << lane) - 1u));
          s_m[r * K + pos] = m_l;
          s_idx[r * K + pos] = nb[j];
        }
        cnt += __popc(live);
      }
    }
    __syncwarp();
    if (lane == 0) {
      float deg = 0.f;
      for (int i = 0; i < cnt; ++i) deg = __fadd_rn(deg, s_m[r * K + i]);
      s_deg[r] = deg;
      s_cnt[r] = cnt;
    }
  }

  // this thread's outputs of the [kRows, kD] product: o = tid + i * kThreads
  float acc[kOut];
  int o_row[kOut], o_col[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const int o = threadIdx.x + i * kThreads;
    acc[i] = 0.f;
    o_row[i] = o / kD;
    o_col[i] = o % kD;
  }
  __syncthreads();

  for (int f0 = 0; f0 < F; f0 += kBF) {
    const int fw = min(kBF, F - f0);
    // 2a. stage W[f0 : f0 + fw, :] (contiguous rows of W)
    const float* w_src = W + (size_t)f0 * kD;
    for (int i = threadIdx.x; i < fw * kD; i += kThreads) w_t[i] = w_src[i];
    // 2b. the aggregate tile
    const int c0 = lane, c1 = lane + 32;
    const bool v0 = c0 < fw, v1 = c1 < fw;
    for (int r = warp; r < kRows; r += kWarps) {
      const int cnt = s_cnt[r];
      float a0 = 0.f, a1 = 0.f;
      for (int i = 0; i < cnt; i += kBatch) {
        // branch-free, as in segment_spmm: the kBatch gathers are in
        // flight together; past the last live slot m = 0, no row is read,
        // and adding 0 * 0 leaves the sums' bits unchanged
        float m[kBatch], x0[kBatch], x1[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const bool ok = i + b < cnt;
          const int slot = r * K + (ok ? i + b : 0);
          const float* row = x + (size_t)s_idx[slot] * F + f0;
          m[b] = ok ? s_m[slot] : 0.f;
          x0[b] = ok && v0 ? row[c0] : 0.f;
          x1[b] = ok && v1 ? row[c1] : 0.f;
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {  // slot order
          a0 = __fadd_rn(a0, __fmul_rn(x0[b], m[b]));
          a1 = __fadd_rn(a1, __fmul_rn(x1[b], m[b]));
        }
      }
      if (mean) {
        const float d = fmaxf(s_deg[r], 1.f);
        a0 = __fdiv_rn(a0, d);
        a1 = __fdiv_rn(a1, d);
      }
      agg[r * kBF + c0] = a0;  // columns past fw hold 0 and are not read
      agg[r * kBF + c1] = a1;
    }
    __syncthreads();
    // 3. the product, k in order
    for (int k = 0; k < fw; ++k) {
#pragma unroll
      for (int i = 0; i < kOut; ++i)
        acc[i] = fmaf(agg[o_row[i] * kBF + k], w_t[k * kD + o_col[i]],
                      acc[i]);
    }
    __syncthreads();  // agg and w_t are rewritten by the next F-tile
  }

#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    if (n0 + o_row[i] < N)
      out[(size_t)(n0 + o_row[i]) * kD + o_col[i]] = acc[i];
  }
}

}  // namespace

// x [M, F], W [F, 64], nbr [N, K] int32, mask [N, K], out [N, 64]; fp32 on
// the device.  Live slots (mask != 0) must name rows in [0, M).  Launches
// on `stream` and returns the cudaError_t of the launch (0 on success):
// cudaErrorInvalidValue for D != 64, and the error of
// cudaFuncSetAttribute for a K whose shared memory does not fit a block.
extern "C" int fused_fp_na_launch(const float* x, const float* W,
                                  const int* nbr, const float* mask,
                                  float* out, int N, int K, int F, int D,
                                  int mean, void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const size_t smem = smem_bytes(K);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_fp_na_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (N + kRows - 1) / kRows;
  fused_fp_na_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x, W, nbr, mask, out, N, K, F, mean);
  return (int)cudaGetLastError();
}
