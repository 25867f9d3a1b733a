// Causal / windowed GQA flash attention for Hopper (sm_90a), prefill:
//
//   out[b, i, h] = sum_j p_ij v[b, j, h / G],
//   p_i = softmax_j(q_i . k_j * scale)
//   over the live pairs (j <= i when causal, i - j < window when windowed)
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (:83; body _kernel :30).  The TPU kernel walks the kv
// tiles of one (batch, head, 128-row q tile) on its sequential grid axis,
// keeping the running max m, the sum l and the fp32 accumulator in VMEM
// scratch, skipping tiles that are entirely masked, and writes the tile on
// the last kv step.
//
// Semantics kept from the TPU kernel: q is scaled in fp32 before the dot;
// every product and sum is fp32 (bf16 inputs are widened on load, and P
// stays fp32 in P @ V); a masked score is -1e30, and p = live ? exp(s - m)
// : 0 is taken after the exp, so a row with no live key in a tile adds
// exactly 0; l is clamped at 1e-30; the output is written in q's type.
// Unlike the TPU kernel, any S works: rows and keys past S are masked (a
// key row past S is never read), so no S % block constraint.
//
// Design.  One block of 256 threads per (64-row q tile, head, batch); the
// q tiles are taken longest-first (block x = 0 is the last tile, which has
// the most live kv tiles under a causal mask).  The scaled q tile, and per
// step one 64-row K and V tile, are staged in shared memory as fp32 with an
// odd row stride (no bank conflicts on the column reads).  Thread (tr, tc)
// of the 16 x 16 grid owns rows tr + 16 i and, of each score tile, columns
// tc + 16 j (i, j < 4): 16 scores by fp32 FMA in registers, 8 shared loads
// a step of the dot.  The 64 scores of a row lie with the 16 threads of
// one half-warp, so the row max and sum are 4 xor-shuffles each.  P goes
// to shared memory over the K tile (K is dead once the scores are in
// registers), and the same thread owns output columns tc + 16 j (j < 8, so
// Dh <= 128) of its 4 rows: the accumulator stays in registers and the
// online-softmax rescale is local.  Fully masked kv tiles are never
// loaded: the loop runs over kv tiles [first, last) of the block, first =
// the tile holding row q0 - window + 1 (window), last = the tile past row
// q0 + 63 (causal).  No atomics: each output is reduced by one thread in
// one order, the same bits on every run.
//
// What bounds it on an H100: operations.  Granite prefill (B 4, S 2048,
// H 32, Dh 128, causal) does 4 * B * H * Dh * (live pairs) = 1.4e11
// operations on 168 MB of inputs and outputs.  This first kernel computes
// in fp32 FMA, not on the tensor cores, and is bound by its shared loads
// (8 loads a 16 FMAs in Q K^T, 12 a 32 in P V); wgmma with bf16 inputs
// (exact products) and TMA are a later speed step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBQ = 64;  // query rows a block
constexpr int kBK = 64;  // key rows a tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kMaxD = 128;
constexpr int kDPer = kMaxD / 16;  // output columns a thread owns
constexpr int kLdP = kBK + 1;  // row stride of the P tile
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

__host__ __device__ inline int row_stride(int D) { return D | 1; }
// floats of the region that holds the K tile, then the P tile
__host__ __device__ inline int kp_floats(int D) {
  const int k = kBK * row_stride(D), p = kBQ * kLdP;
  return k > p ? k : p;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int H, int KVH, int D, int causal, int window,
                       float scale) {
  extern __shared__ float smem[];
  const int ld = row_stride(D);
  float* Qs = smem;  // [kBQ][ld], scaled
  float* Ks = Qs + kBQ * ld;  // [kBK][ld]; the P tile [kBQ][kLdP] after it
  float* Ps = Ks;
  float* Vs = Ks + kp_floats(D);  // [kBK][ld]

  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const size_t q_step = (size_t)H * D;  // between sequence positions
  const size_t kv_step = (size_t)KVH * D;
  const T* qb = q + (size_t)b * S * q_step + (size_t)h * D;
  const T* kb = k + (size_t)b * S * kv_step + (size_t)kvh * D;
  const T* vb = v + (size_t)b * S * kv_step + (size_t)kvh * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const int row = q0 + r;
    Qs[r * ld + d] = row < S ? to_f32(qb[(size_t)row * q_step + d]) * scale
                             : 0.f;
  }

  float m[4], l[4], acc[4][kDPer];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDPer; ++j) acc[i][j] = 0.f;
  }

  // the kv tiles holding a live pair for some row of this block
  const int k_end = causal ? min(S, q0 + kBQ) : S;
  int kt = 0;
  if (window && q0 - window + 1 > 0) kt = (q0 - window + 1) / kBK;
  const int kt_end = (k_end + kBK - 1) / kBK;

  for (; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's readers are done with Ps and Vs
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      const int row = k0 + r;
      const bool ok = row < S;
      Ks[r * ld + d] = ok ? to_f32(kb[(size_t)row * kv_step + d]) : 0.f;
      Vs[r * ld + d] = ok ? to_f32(vb[(size_t)row * kv_step + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[4];
    bool live[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tc + 16 * j;
        bool ok = col < S;
        if (causal) ok = ok && row >= col;
        if (window) ok = ok && row - col < window;
        live[i][j] = ok;
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // a row's 64 scores lie with the 16 threads of one half-warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    __syncthreads();  // every thread has read Ks: P may overwrite it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[i][j] ? expf(s[i][j] - m[i]) : 0.f;
        Ps[(tr + 16 * i) * kLdP + tc + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      l[i] = l[i] * alpha[i] + sum;
#pragma unroll
      for (int j = 0; j < kDPer; ++j) acc[i][j] *= alpha[i];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr + 16 * i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < kDPer; ++j) {
        const int d = tc + 16 * j;
        const float vv = d < D ? Vs[c * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= S) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* o = out + ((size_t)b * S + row) * q_step + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < kDPer; ++j) {
      const int d = tc + 16 * j;
      if (d < D) store(o + d, acc[i][j] / l_safe);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KVH, int D, int causal, int window, float scale,
           cudaStream_t stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (D < 1 || D > kMaxD || KVH < 1 || H % KVH != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)(kBQ + kBK) * row_stride(D) + kp_floats(D)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KVH, D, causal,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out [B, S, H, D], k/v [B, S, KVH, D], contiguous, all fp32 (bf16 = 0)
// or all bf16 (bf16 = 1); H a multiple of KVH; 1 <= D <= 128; window 0 =
// none.  Launches on `stream` and returns the cudaError_t of the launch (0
// on success; cudaErrorInvalidValue for a shape it does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int KVH, int D, int causal,
                                      int window, float scale, int bf16,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, out, B, S, H, KVH, D, causal,
                                      window, scale, st)
              : launch<float>(q, k, v, out, B, S, H, KVH, D, causal, window,
                              scale, st);
}
