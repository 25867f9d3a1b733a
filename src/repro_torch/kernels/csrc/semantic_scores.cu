// Semantic Aggregation pass 1 for Hopper (sm_90a):
//
//   w[p] = (1/N) sum_{n<N} q · tanh(z[p, n] W + b)     z [P, N, D], W [D, Hs]
//
// Replaces the TPU kernel src/repro/kernels/semantic_attn.py::
// semantic_scores (:100; bodies _score_kernel :27 and _score_stream_kernel
// :58).  The TPU kernels carry a running [P] sum from one grid step to the
// next, and the streaming twin double-buffers chunks of z under the v5e's
// 8 MB VMEM budget.  Neither carries over: CUDA blocks run in no order, and
// z is read once through L2 whatever its size, so one design covers every N.
//
// Design.  Block (x, p) owns 32 rows of metapath p (8 warps, 4 rows a
// warp) and stages W in shared memory once.  A warp copies its 4 rows of z
// into shared memory, then lane l keeps the NC = ceil(Hs / 32) columns
// l, l+32, ... of z W + b for all 4 rows in registers and walks the
// features in order: each W[f, col] read from shared memory feeds 4 rows,
// and each z[row, f] read (a broadcast) feeds NC columns, so a shared load
// serves two FMAs on average where a row at a time took five loads for
// four.  Then it sums q[col] tanh(.) over its columns in column order, and
// a xor-shuffle tree sums the lanes.  The row scores of a block are
// summed in row order into partial[p, block], and a second kernel sums
// partial[p, :] in block order and divides by N.  No float atomics: the
// result is the same bits on every run.  Rows >= N score 0 (the reference
// masks its pad rows the same way).
//
// What bounds it on an H100: operations.  At [2, 4278, 64] with Hs = 128
// the function needs 2*P*N*D*Hs ≈ 1.4e8 fp32 operations (2.1 us at 67
// TFLOP/s) against 2.2 MB of z (0.65 us at 3.35 TB/s).
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;  // rows a warp computes together
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kMaxColChunks = 8;  // Hs <= 256
constexpr unsigned kFull = 0xffffffffu;

template <int NC>
__global__ void __launch_bounds__(kWarps * 32)
scores_kernel(const float* __restrict__ z, const float* __restrict__ W,
              const float* __restrict__ bias, const float* __restrict__ q,
              float* __restrict__ partial, int N, int D, int Hs) {
  extern __shared__ float smem[];  // W [D*Hs], z rows [kRowsPerBlock*D],
  float* w_s = smem;               // row scores [kRowsPerBlock]
  float* z_s = smem + (size_t)D * Hs;
  float* row_score = z_s + kRowsPerBlock * D;
  const int p = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < D * Hs; i += blockDim.x) w_s[i] = W[i];
  const int n0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  float* zr = z_s + warp * kRowsPerWarp * D;
  for (int r = 0; r < kRowsPerWarp; ++r) {  // rows >= N stage as zeros
    const float* row = z + ((size_t)p * N + n0 + r) * D;
    const bool live = n0 + r < N;
    for (int f = lane; f < D; f += 32) zr[r * D + f] = live ? row[f] : 0.f;
  }
  bool cv[NC];
  float qv[NC], t[kRowsPerWarp][NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    cv[c] = c * 32 + lane < Hs;
    qv[c] = cv[c] ? q[c * 32 + lane] : 0.f;
    const float b0 = cv[c] ? bias[c * 32 + lane] : 0.f;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) t[r][c] = b0;
  }
  __syncthreads();
#pragma unroll 2
  for (int f = 0; f < D; ++f) {  // features in order
    float w[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      w[c] = cv[c] ? w_s[f * Hs + c * 32 + lane] : 0.f;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float zf = zr[r * D + f];
#pragma unroll
      for (int c = 0; c < NC; ++c) t[r][c] += zf * w[c];
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float score = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)  // columns in order
      if (cv[c]) score += qv[c] * tanhf(t[r][c]);
    for (int o = 16; o > 0; o >>= 1)
      score += __shfl_xor_sync(kFull, score, o);
    if (lane == 0)
      row_score[warp * kRowsPerWarp + r] = n0 + r < N ? score : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < kRowsPerBlock; ++i) s += row_score[i];  // row order
    partial[(size_t)p * gridDim.x + blockIdx.x] = s;
  }
}

template <int NC>
cudaError_t launch_nc(dim3 grid, size_t smem, cudaStream_t st,
                      const float* z, const float* W, const float* b,
                      const float* q, float* partial, int N, int D, int Hs) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        scores_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  scores_kernel<NC><<<grid, kWarps * 32, smem, st>>>(z, W, b, q, partial, N,
                                                     D, Hs);
  return cudaGetLastError();
}

// w[p] = (sum of partial[p, :] in block order) / N.
__global__ void scores_sum_kernel(const float* __restrict__ partial,
                                  int n_blocks, int N, float* __restrict__ w) {
  if (threadIdx.x != 0) return;
  const int p = blockIdx.x;
  float t = 0.f;
  for (int i = 0; i < n_blocks; ++i) t += partial[(size_t)p * n_blocks + i];
  w[p] = t / (float)N;
}

}  // namespace

// z [P, N, D], W [D, Hs], b [Hs], q [Hs], w [P]: contiguous fp32 on the
// device, Hs <= 256; partial holds P * ceil(N / 32) floats of scratch.
// Launches both kernels on `stream` and returns the cudaError_t of the
// launches.
extern "C" int semantic_scores_launch(const float* z, const float* W,
                                      const float* b, const float* q,
                                      float* partial, float* w, int P, int N,
                                      int D, int Hs, void* stream) {
  if (P <= 0 || N <= 0 || D <= 0 || Hs <= 0 || Hs > kMaxColChunks * 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  const dim3 grid(n_blocks, P);
  const size_t smem = sizeof(float) * ((size_t)D * Hs +
                                       (size_t)kRowsPerBlock * D +
                                       kRowsPerBlock);
  cudaError_t err;
  switch ((Hs + 31) / 32) {
#define SCORES_CASE(NCV)                                                     \
  case NCV:                                                                  \
    err = launch_nc<NCV>(grid, smem, st, z, W, b, q, partial, N, D, Hs);     \
    break;
    SCORES_CASE(1)
    SCORES_CASE(2)
    SCORES_CASE(3)
    SCORES_CASE(4)
    SCORES_CASE(5)
    SCORES_CASE(6)
    SCORES_CASE(7)
    SCORES_CASE(8)
#undef SCORES_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  scores_sum_kernel<<<P, 32, 0, st>>>(partial, n_blocks, N, w);
  return (int)cudaGetLastError();
}
