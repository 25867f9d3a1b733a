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
// What bounds it on an H100: operations.  At [2, 4278, 64] with Hs = 128
// the function needs 2*P*N*D*Hs ≈ 1.4e8 fp32 operations (2.1 us at 67
// TFLOP/s) against 2.2 MB of z (0.65 us at 3.35 TB/s).
//
// Design: one launch of at most one block an SM, so W is read from L2
// once an SM.  The [P, N] rows are cut into tiles of 8 R rows, each inside
// one metapath (tile t: metapath t / tiles_per_p), and block i takes tiles
// i, i + grid, ...  The launcher picks R (rows a warp, 8 to 16) as the
// least that puts every tile in one wave of blocks, so no block takes a
// second tile while the others wait (at [2, 4278, 64]: R = 9, 120 tiles
// of 72 rows).  A tile's z rows arrive through a two-stage cp.async ring
// of kFC-feature chunks (16-byte copies where z's rows allow, else 4; rows
// >= N and features >= D zero-filled), so the next chunk, of this tile or
// the next, lands during this chunk's product, and any D fits.  W [D, Hs]
// is staged in shared memory once a block, zero-padded to multiples of 4,
// by the same cp.async groups: its rows of chunk k travel with the first
// tile's chunk k, so the first product waits for one chunk of W, not all
// of it; each lane keeps b and q of its columns in registers.  The
// product is FFMA from shared memory: warp k owns the tile's rows R k ..
// R k + R - 1, lane l columns 4l .. 4l + 3 (+ 128 for Hs > 128); per 4
// features it reads its rows' z as broadcast 16-byte loads and W's 4 x 4
// (x NC) block as 16-byte loads, and accumulates zW + b by FMA in feature
// order.  A row's score sums q·tanh(.) over the lane's columns in order
// (all of a warp's tanhs first, for the parallelism), then over the 32
// lanes by an xor butterfly; a tile's partial sums its rows' scores in row
// order (rows >= N add 0) into scratch, indexed by tile.  The last block
// to finish (an int counter, taken by one acquire-release atomic a block
// and set back to 0 by the last) sums each metapath's partials in a fixed
// order: lane l adds tiles l, l + 32, ... in order, an xor butterfly adds
// the lanes, and the sum is divided by N.  No float atomics: two runs give
// the same bits.  Design variants and their times on an H100:
// scripts/torch_kernel_variants.py (--only scores).
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kFC = 32;    // features a ring stage
constexpr int kZLd = kFC;  // a ring row's stride (floats)
constexpr int kMaxHs = 256;  // two column chunks of 128
constexpr int kRows[] = {8, 9, 10, 12, 16};  // the rows a warp may take
constexpr unsigned kFull = 0xffffffffu;
static_assert(kFC % 4 == 0, "float4s");

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
// W's row stride in shared memory: Hs rounded up to 4 (16-byte rows)
__host__ __device__ inline int w_ld(int Hs) { return round4(Hs); }

// Shared memory (floats) at R rows a warp: W [round4(D)][w_ld(Hs)] | ring
// [2][8 R][kZLd] | row scores [8 R]
size_t smem_bytes(int D, int Hs, int R) {
  return sizeof(float) * ((size_t)round4(D) * w_ld(Hs) +
                          (2 * (size_t)kZLd + 1) * kWarps * R);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// Rows [k0, k1) of W into w_s [.][ldw] (rows >= D and columns >= Hs
// zero).  VEC (Hs % 4 == 0, so ldw == Hs and the rows are contiguous, and
// W 16-byte aligned): 16-byte cp.async copies, else 4-byte ones.
template <bool VEC>
__device__ __forceinline__ void copy_w(float* w_s,
                                       const float* __restrict__ W, int k0,
                                       int k1, int D, int Hs, int ldw) {
  const int kd = min(D, k1);  // the rows W has
  if constexpr (VEC) {
    for (int i = k0 * ldw / 4 + threadIdx.x; i < kd * ldw / 4;
         i += kThreads)
      cp_async16(w_s + 4 * i, W + 4 * (size_t)i);
    for (int i = kd * ldw + threadIdx.x; i < k1 * ldw; i += kThreads)
      w_s[i] = 0.f;
  } else {
    for (int i = k0 * ldw + threadIdx.x; i < k1 * ldw; i += kThreads) {
      const int k = i / ldw, c = i % ldw;
      if (k < D && c < Hs)
        cp_async4(w_s + i, W + (size_t)k * Hs + c);
      else
        w_s[i] = 0.f;
    }
  }
}

// Features [f0, f0 + kFC) of tile t's rows into one ring stage
// [kTile][kZLd] (rows >= N and features >= D zero); VEC (D % 4 == 0 and z
// 16-byte aligned): 16-byte cp.async copies, else 4-byte ones.
template <int kTile, bool VEC>
__device__ __forceinline__ void copy_chunk(float* st,
                                           const float* __restrict__ z,
                                           int t, int f0, int tpp, int N,
                                           int D) {
  const int p = t / tpp;
  const int n0 = (t - p * tpp) * kTile;
  constexpr int kV = VEC ? 4 : 1;
  for (int i = threadIdx.x; i < kTile * kFC / kV; i += kThreads) {
    const int r = i / (kFC / kV), f = kV * (i % (kFC / kV));
    float* dst = st + r * kZLd + f;
    if (n0 + r < N && f0 + f < D) {
      const float* src = z + ((size_t)p * N + n0 + r) * D + f0 + f;
      if constexpr (VEC)
        cp_async16(dst, src);
      else
        cp_async4(dst, src);
    } else {
#pragma unroll
      for (int v = 0; v < kV; ++v) dst[v] = 0.f;
    }
  }
}

template <int NC, int kR>
__global__ void __launch_bounds__(kThreads, 1)
semantic_scores_kernel(const float* __restrict__ z,
                       const float* __restrict__ W,
                       const float* __restrict__ bias,
                       const float* __restrict__ q,
                       float* __restrict__ partial, int* __restrict__ done,
                       float* __restrict__ w_out, int P, int N, int D,
                       int Hs) {
  constexpr int kTile = kWarps * kR;  // rows a tile (a partial)
  extern __shared__ __align__(16) float smem[];
  const int D4 = round4(D), ldw = w_ld(Hs);
  float* w_s = smem;                           // [D4][ldw]
  float* ring = w_s + (size_t)D4 * ldw;        // [2][kTile][kZLd]
  float* row_score = ring + 2 * kTile * kZLd;  // [kTile]
  __shared__ int s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(z) % 16 == 0;
  const bool vec_w = Hs % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;

  // this lane's columns: col[c] .. col[c] + 3 (clamped to 0 past Hs, and
  // left out of the score); b and q of them
  int col[NC];
  float bv[NC][4], qv[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int c0 = c * 128 + 4 * lane;
    col[c] = c0 < Hs ? c0 : 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bv[c][j] = c0 + j < Hs ? __ldg(bias + c0 + j) : 0.f;
      qv[c][j] = c0 + j < Hs ? __ldg(q + c0 + j) : 0.f;
    }
  }

  // the ring: step s is chunk s % nch of this block's tile s / nch; the
  // first tile's steps also bring W's rows of their chunk
  const int tpp = (N + kTile - 1) / kTile;
  const int n_tiles = P * tpp;
  const int nch = (D + kFC - 1) / kFC;
  const int my_tiles =
      (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int n_steps = my_tiles * nch;
  auto issue = [&](int s) {
    if (s < nch) {
      const int k1 = min(D4, (s + 1) * kFC);
      if (vec_w)
        copy_w<true>(w_s, W, s * kFC, k1, D, Hs, ldw);
      else
        copy_w<false>(w_s, W, s * kFC, k1, D, Hs, ldw);
    }
    if (s < n_steps) {
      const int t = blockIdx.x + (s / nch) * gridDim.x;
      float* st = ring + (s & 1) * kTile * kZLd;
      if (vec)
        copy_chunk<kTile, true>(st, z, t, (s % nch) * kFC, tpp, N, D);
      else
        copy_chunk<kTile, false>(st, z, t, (s % nch) * kFC, tpp, N, D);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  issue(0);

  float acc[kR][NC][4];
  for (int s = 0; s < n_steps; ++s) {
    const int ch = s % nch;
    if (ch == 0) {
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][c][j] = bv[c][j];
    }
    issue(s + 1);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // step s (and its W rows) landed, every thread's copies
    const float* zs = ring + (s & 1) * kTile * kZLd + warp * kR * kZLd;
    const int f0 = ch * kFC;
    const int fw = min(kFC, D4 - f0);  // a multiple of 4
#pragma unroll 2
    for (int f = 0; f < fw; f += 4) {  // features in order
      float4 zr[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r)
        zr[r] = *reinterpret_cast<const float4*>(zs + r * kZLd + f);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float4 wv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          wv[c] = *reinterpret_cast<const float4*>(
              w_s + (size_t)(f0 + f + k) * ldw + col[c]);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float zk = k == 0 ? zr[r].x
                         : k == 1 ? zr[r].y
                         : k == 2 ? zr[r].z
                                  : zr[r].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc[r][c][0] = fmaf(zk, wv[c].x, acc[r][c][0]);
            acc[r][c][1] = fmaf(zk, wv[c].y, acc[r][c][1]);
            acc[r][c][2] = fmaf(zk, wv[c].z, acc[r][c][2]);
            acc[r][c][3] = fmaf(zk, wv[c].w, acc[r][c][3]);
          }
        }
      }
    }
    if (ch == nch - 1) {  // the tile's row scores, then its partial
      const int t = blockIdx.x + (s / nch) * gridDim.x;
      const int p = t / tpp;
      const int n0 = (t - p * tpp) * kTile + warp * kR;
      float sc[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) sc[r] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j)  // columns in order
          if (c * 128 + 4 * lane + j < Hs) {
#pragma unroll
            for (int r = 0; r < kR; ++r)
              sc[r] += qv[c][j] * tanhf(acc[r][c][j]);
          }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < kR; ++r) sc[r] += __shfl_xor_sync(kFull, sc[r], o);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kR; ++r)
          row_score[warp * kR + r] = n0 + r < N ? sc[r] : 0.f;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        float v = 0.f;
        for (int r = 0; r < kTile; ++r) v += row_score[r];  // row order
        partial[t] = v;
      }
    }
    __syncthreads();  // the stage is refilled by the next step's issue
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // the last block to finish sums the partials of each metapath; the
  // ticket is an acquire-release atomic, so this block's partials are
  // visible before it, and every block's partials to the last one after it
  if (threadIdx.x == 0) {
    int ticket;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(ticket)
                 : "l"(done)
                 : "memory");
    s_last = ticket == (int)gridDim.x - 1;
    if (s_last) *done = 0;  // for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  for (int p = warp; p < P; p += kWarps) {
    float v = 0.f;
#pragma unroll 4
    for (int t = lane; t < tpp; t += 32)  // tiles in order, a lane each
      v += __ldcg(partial + (size_t)p * tpp + t);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    if (lane == 0) w_out[p] = v / (float)N;
  }
}

// The SM count and the opt-in shared memory of a block, read once.
cudaError_t device_limits(int* n_sm, int* smem_max) {
  static int sms = 0, smem = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) {
      sms = 0;
      return err;
    }
  }
  *n_sm = sms;
  *smem_max = smem;
  return cudaSuccess;
}

// Rows a warp: the least of kRows whose tiles all fit one block an SM and
// whose shared memory fits; 8 where Hs > 128 (twice the accumulators) or
// where none fits one wave.
int pick_rows(int P, int N, int D, int Hs, int n_sm, int smem_max) {
  if (Hs > 128) return 8;
  for (int R : kRows)
    if ((long long)P * ((N + kWarps * R - 1) / (kWarps * R)) <= n_sm &&
        smem_bytes(D, Hs, R) <= (size_t)smem_max)
      return R;
  return 8;
}

template <int NC, int R>
cudaError_t launch_one(cudaStream_t st, const float* z, const float* W,
                       const float* b, const float* q, float* partial,
                       int* done, float* w, int P, int N, int D, int Hs,
                       int n_sm) {
  auto kernel = semantic_scores_kernel<NC, R>;
  const size_t smem = smem_bytes(D, Hs, R);
  // the largest shared-memory size this instantiation was allowed so far
  static size_t set_smem = 48 * 1024;
  if (smem > set_smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // the refusal is returned, not left pending
      return err;
    }
    set_smem = smem;
  }
  const long long tiles =
      (long long)P * ((N + kWarps * R - 1) / (kWarps * R));
  const int blocks = (int)std::min<long long>(tiles, n_sm);
  kernel<<<blocks, kThreads, smem, st>>>(z, W, b, q, partial, done, w, P, N,
                                         D, Hs);
  return cudaGetLastError();
}

}  // namespace

// The rows of a tile that a launch at this shape takes (8 R), or 0 where
// the device cannot be read.
extern "C" int semantic_scores_tile_rows(int P, int N, int D, int Hs) {
  int n_sm = 0, smem_max = 0;
  if (device_limits(&n_sm, &smem_max) != cudaSuccess) return 0;
  return kWarps * pick_rows(P, N, D, Hs, n_sm, smem_max);
}

// The shared memory of a launch at 8 rows a warp, the least it takes: a
// shape whose W does not fit with it is refused.
extern "C" long long semantic_scores_smem_bytes(int D, int Hs) {
  return (long long)smem_bytes(D, Hs, 8);
}

// z [P, N, D], W [D, Hs], b [Hs], q [Hs], w [P]: contiguous fp32 on the
// device, Hs <= 256.  partial is scratch of P * ceil(N / 64) floats (a
// tile has 64 rows or more), done one int that is 0 before the launch (the
// kernel leaves it at 0 again).  Launches one kernel on `stream` and
// returns the cudaError_t of the launch (0 on success):
// cudaErrorInvalidValue for an empty shape or Hs > 256, the error of
// cudaFuncSetAttribute where W does not fit a block's shared memory.
extern "C" int semantic_scores_launch(const float* z, const float* W,
                                      const float* b, const float* q,
                                      float* partial, int* done, float* w,
                                      int P, int N, int D, int Hs,
                                      void* stream) {
  if (P <= 0 || N <= 0 || D <= 0 || Hs <= 0 || Hs > kMaxHs)
    return (int)cudaErrorInvalidValue;
  int n_sm = 0, smem_max = 0;
  cudaError_t err = device_limits(&n_sm, &smem_max);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hs > 128)
    return (int)launch_one<2, 8>(st, z, W, b, q, partial, done, w, P, N, D,
                                 Hs, n_sm);
  switch (pick_rows(P, N, D, Hs, n_sm, smem_max)) {
#define SCORES_CASE(RV)                                                     \
  case RV:                                                                  \
    err = launch_one<1, RV>(st, z, W, b, q, partial, done, w, P, N, D, Hs, \
                            n_sm);                                          \
    break;
    SCORES_CASE(9)
    SCORES_CASE(10)
    SCORES_CASE(12)
    SCORES_CASE(16)
#undef SCORES_CASE
    default:
      err = launch_one<1, 8>(st, z, W, b, q, partial, done, w, P, N, D, Hs,
                             n_sm);
  }
  return (int)err;
}
