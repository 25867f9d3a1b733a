// One-token GQA attention over a KV cache for Hopper (sm_90a), decode:
//
//   out[b, h] = sum_{j < kv_len[b]} p_j v[b, j, h / G],
//   p = softmax_j(q[b, h] . k[b, j, h / G] * scale)
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (:72; body _kernel :28).  The TPU kernel walks the
// cache's kv tiles of one batch row on its sequential grid axis, computing
// the online-softmax statistics of all H query heads at once (the G heads
// of a KV group share each K/V tile), skips tiles at or past kv_len, and
// writes on the last step.
//
// Semantics kept: q is scaled in fp32 before the dot; all arithmetic is
// fp32 (bf16 widened on load, P fp32 in P @ V); masked scores are -1e30
// and a masked key adds exactly 0; l is clamped at 1e-30; the output is
// in q's type.  kv_len is read on the device (no host sync, so a captured
// CUDA graph needs no change); a cache row at or past kv_len is never
// read, so any cache length S works.
//
// Design: split-KV (flash-decoding), two kernels, no atomics.
//  1. decode_split_kernel: one block of 128 threads per (cache split of
//     `split` rows, KV head, batch row), holding the G query heads of that
//     group.  A block whose split starts at or past kv_len returns at once.
//     The others stage 64-row K and V tiles in shared memory (fp32, odd
//     row stride), compute the G x 64 scores (one thread an entry, an FMA
//     chain over Dh), take each head's online-softmax step in one warp
//     (shuffle max and sum), and accumulate P V into a [G, Dh] fp32
//     accumulator in shared memory, one thread an entry.  The split's
//     (m, l, acc) go to a scratch buffer.
//  2. decode_combine_kernel: one block per (head, batch row) rescales the
//     live splits' partials to their common max and sums them in split
//     order, so the result is the same bits on every run.
//
// What bounds it on an H100: bytes — the live K and V rows (kv_len * KVH *
// Dh per batch row, twice), q and the output; the operations are 4 * H *
// Dh per live row.  Granite decode (B 4, kv_len 1..2080, KVH 8, Dh 128,
// bf16) moves 21 MB a layer: 6.3 us at 3.35 TB/s.  The loads are staged
// synchronously (load a tile, then compute), so latency, not bandwidth, is
// this first kernel's limit; cp.async / TMA double buffering is a later
// speed step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;  // cache rows staged a step (two per lane)
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// floats of shared memory: q [G][D], K and V [kTile][D|1], P [G][kTile],
// acc [G][D], m, l and alpha [G]
__host__ __device__ inline size_t split_floats(int G, int D) {
  return (size_t)G * D * 2 + (size_t)2 * kTile * (D | 1) +
         (size_t)G * kTile + (size_t)3 * G;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int S, int H, int KVH, int D, int split, int nsplit,
                    float scale) {
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = min(kv_len[b], S);
  const int r0 = sp * split;
  if (r0 >= len) return;  // no live row: the combine skips this split
  const int r1 = min(r0 + split, len);

  extern __shared__ float smem[];
  const int G = H / KVH;
  const int ld = D | 1;
  float* Qs = smem;  // [G][D], scaled
  float* Ks = Qs + G * D;  // [kTile][ld]
  float* Vs = Ks + kTile * ld;  // [kTile][ld]
  float* Ps = Vs + kTile * ld;  // [G][kTile]
  float* Acc = Ps + G * kTile;  // [G][D]
  float* Ms = Acc + G * D;  // [G]
  float* Ls = Ms + G;  // [G]
  float* As = Ls + G;  // [G] this tile's rescale

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h0 = kvh * G;
  const size_t kv_step = (size_t)KVH * D;
  const T* kb = k + (size_t)b * S * kv_step + (size_t)kvh * D;
  const T* vb = v + (size_t)b * S * kv_step + (size_t)kvh * D;
  const T* qb = q + ((size_t)b * H + h0) * D;
  for (int e = tid; e < G * D; e += kThreads) {
    Qs[e] = to_f32(qb[e]) * scale;
    Acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }

  for (int t0 = r0; t0 < r1; t0 += kTile) {
    const int n = min(kTile, r1 - t0);  // live rows of this tile
    __syncthreads();  // the last tile's readers are done
    for (int e = tid; e < kTile * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      const bool ok = r < n;
      const size_t at = (size_t)(t0 + r) * kv_step + d;
      Ks[r * ld + d] = ok ? to_f32(kb[at]) : 0.f;
      Vs[r * ld + d] = ok ? to_f32(vb[at]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < G * kTile; e += kThreads) {
      const int g = e / kTile, c = e - g * kTile;
      const float* qg = Qs + g * D;
      const float* kc = Ks + c * ld;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qg[d], kc[d], s);
      Ps[e] = c < n ? s : kNegInf;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {  // one warp a head
      float* pg = Ps + g * kTile;
      const float a = pg[lane], c = pg[lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float pa = lane < n ? expf(a - m_new) : 0.f;
      const float pc = lane + 32 < n ? expf(c - m_new) : 0.f;
      pg[lane] = pa;
      pg[lane + 32] = pc;
      float sum = pa + pc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        As[g] = alpha;
        Ls[g] = Ls[g] * alpha + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < G * D; e += kThreads) {
      const int g = e / D, d = e - g * D;
      const float* pg = Ps + g * kTile;
      float a = Acc[e] * As[g];
      for (int c = 0; c < n; ++c) a = fmaf(pg[c], Vs[c * ld + d], a);
      Acc[e] = a;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, d = e - g * D;
    const size_t at = ((size_t)b * H + h0 + g) * nsplit + sp;
    part_acc[at * D + d] = Acc[e];
  }
  for (int g = tid; g < G; g += kThreads) {
    const size_t at = ((size_t)b * H + h0 + g) * nsplit + sp;
    part_ml[2 * at] = Ms[g];
    part_ml[2 * at + 1] = Ls[g];
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxD)
decode_combine_kernel(const float* __restrict__ part_ml,
                      const float* __restrict__ part_acc,
                      const int* __restrict__ kv_len, T* __restrict__ out,
                      int S, int H, int D, int split, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int len = min(kv_len[b], S);
  const int live = len > 0 ? (len + split - 1) / split : 0;
  const size_t row = (size_t)b * H + h;
  const float* ml = part_ml + 2 * row * nsplit;
  const float* pa = part_acc + row * nsplit * D;
  float m = kNegInf;
  for (int s = 0; s < live; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f;
  for (int s = 0; s < live; ++s) l += ml[2 * s + 1] * expf(ml[2 * s] - m);
  const float l_safe = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < live; ++s)  // split order
      a += pa[(size_t)s * D + d] * expf(ml[2 * s] - m);
    store(out + row * D + d, a / l_safe);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           float* part_ml, float* part_acc, void* out, int B, int S, int H,
           int KVH, int D, int split, int nsplit, float scale,
           cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  if (D < 1 || D > kMaxD || KVH < 1 || H % KVH != 0 || split < 1 ||
      (long long)split * nsplit < S)
    return (int)cudaErrorInvalidValue;
  if (S > 0) {
    const size_t smem = split_floats(H / KVH, D) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    decode_split_kernel<T><<<dim3(nsplit, KVH, B), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), kv_len, part_ml, part_acc, S, H, KVH, D,
        split, nsplit, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  decode_combine_kernel<T><<<dim3(H, B), kMaxD, 0, stream>>>(
      part_ml, part_acc, kv_len, static_cast<T*>(out), S, H, D, split,
      nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out [B, H, D], k/v [B, S, KVH, D], contiguous, all fp32 (bf16 = 0) or
// all bf16 (bf16 = 1); kv_len [B] int32 on the device; H a multiple of
// KVH; 1 <= D <= 128.  part_ml [B, H, nsplit, 2] and part_acc [B, H,
// nsplit, D] fp32 scratch, split * nsplit >= S.  Launches both kernels on
// `stream` and returns the cudaError_t of the launches (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* kv_len,
                                       float* part_ml, float* part_acc,
                                       void* out, int B, int S, int H,
                                       int KVH, int D, int split, int nsplit,
                                       float scale, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, kv_len, part_ml, part_acc,
                                      out, B, S, H, KVH, D, split, nsplit,
                                      scale, st)
              : launch<float>(q, k, v, kv_len, part_ml, part_acc, out, B, S,
                              H, KVH, D, split, nsplit, scale, st);
}
