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
// What bounds it on an H100: bytes — the live K and V rows (kv_len * KVH *
// Dh per batch row, twice), q and the output; the operations are 4 * H *
// Dh per live row (16 a byte of bf16 cache at G = 4, far below the card's
// ~295).  Granite decode (B 4, kv_len 1, 1000, 2049, 2080, KVH 8, Dh 128,
// bf16) moves 21 MB a call: 6.3 us at 3.35 TB/s; inside the serve (about
// 8260 live rows) 33.8 MB, 10.1 us.
//
// Design: split-KV (flash-decoding), two kernels, no atomics.
//  1. decode_split_kernel: one warp per (cache split of `split` = 64 rows,
//     KV head, batch row), four warps (four consecutive splits) a block.
//     The warps share nothing and meet at no barrier, so no warp waits on
//     another's loads.  A warp whose split starts at or past kv_len returns
//     at once.  The others walk their split in 8-row tiles through a
//     four-stage ring of their own in shared memory: the K and V rows of
//     tiles t + 1 .. t + 3 are in flight (cp.async, 16-byte copies when
//     Dh * size % 16 == 0, else 4-byte, else 2-byte loads; kept in the
//     input type; with Dh 128 or 64 in 16-byte copies each lane copies
//     one fixed column chunk of every few rows) while tile t computes, and
//     a split's 8 tiles go round the ring twice.
//     Bytes in flight: a warp keeps 3 tiles x 8 rows x 2 x 256 B = 12 KB
//     of bf16 K/V requested.  Granite's decode bench has 664 live splits
//     (8 MB in flight), the serve ~1056 (12.7 MB), where 3.35 TB/s times
//     ~1 us of latency needs ~3.4 MB.  Shared memory at Dh 128: 16.1 KB a
//     warp in bf16 (32.1 KB in fp32), 64.6 KB a block, three blocks
//     (twelve warps) an SM.
//     Per tile, in registers and shuffles: (a) scores — a cache row's Dh
//     values lie with the 16 lanes of a half-warp, 8 each (one 16-byte
//     shared load in bf16), so the warp takes two rows at a time, four
//     pairs a tile; a lane dots its 8 values with 4 query heads' q (held
//     in registers for the split) by FMA in order, and the 16 lanes reduce
//     their 16 partial (row, head) dots by xor-shuffles 8, 4, 2, 1, each
//     lane keeping half of its values at each step: a fixed order, 15
//     shuffles, and lane l ends with the score of one (row, head).  (b)
//     softmax — a head's max and sum over the tile's 8 rows by
//     xor-shuffles 4, 8, 16; one exp a lane.  (c) P V — P and the rescale
//     go through the warp's shared memory; lane l owns columns 4 l .. 4 l
//     + 3 of the 4 heads (16 fp32 accumulators), which take the tile's rows
//     in order, one FMA each.  More than 4 heads a group take more passes
//     (blockIdx.y), each reading the split again.  The split's (m, l, acc)
//     go to a scratch buffer.
//  2. decode_combine_kernel: one block per (head, batch row) rescales the
//     live splits' partials to their common max (the weights exp(m_s - m)
//     computed once, in shared memory) and sums them in split order, so
//     the result is the same bits on every run.  With an `lse` buffer it
//     also writes the row's log-sum-exp m + log(l) in fp32 (the
//     log-sum-exp form: a rank's partial over its shard of a
//     sequence-sharded cache, which the caller combines across ranks); a
//     row with no live cache row writes o = 0 and lse = -1e30, as the
//     plain partial does.  The output o is the same bits with or without
//     it.  The combine is launched as a
//     programmatic dependent of the split kernel: its blocks start while
//     the split kernel runs and wait on the device (griddepcontrol.wait)
//     for its partials, which hides the second launch's latency.
//
// Numbers kept from the TPU kernel: q is scaled in fp32 before the dot;
// all arithmetic is fp32 (K and V widened from shared memory, P fp32 in
// P V; no tensor cores are needed at G = 4); masked scores are -1e30 and
// a masked key adds exactly 0; l is clamped at 1e-30; the output is in
// q's type.  kv_len is read on the device (no host sync, so a captured
// CUDA graph needs no change); a cache row at or past kv_len is never
// read (never copied, never touched in shared memory), so any S works.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // splits a block, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 8;  // cache rows a ring stage: four pairs of rows
constexpr int kStages = 4;
constexpr int kHeads = 4;  // query heads a pass, in registers
constexpr int kMaxD = 128;  // 16 lanes x 8 values; 32 lanes x 4 columns
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

// N consecutive values (N = 4 or 8) from shared memory aligned to N * size
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 a = reinterpret_cast<const float4*>(p)[i];
    x[4 * i] = a.x, x[4 * i + 1] = a.y, x[4 * i + 2] = a.z,
          x[4 * i + 3] = a.w;
  }
}
template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p,
                                       float (&x)[N]) {
  uint32_t w[N / 2];
  if constexpr (N == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One BYTES-byte copy from global to shared memory: cp.async for 16 and 4
// bytes, a synchronous 2-byte load and store for an odd bf16 Dh.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  } else if constexpr (BYTES == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  } else {
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared row stride (elements) of a K/V ring: Dh rounded up to 8, so a
// lane's 8 values are whole and every row starts 16-byte aligned
__host__ __device__ inline int ring_ld(int D) { return (D + 7) & ~7; }

// bytes of shared memory a warp: its K and V rings, then P [kTile][kHeads]
// and alpha [kHeads] in fp32 (a multiple of 16 bytes)
template <typename T>
__host__ __device__ inline size_t warp_smem(int D) {
  return (size_t)2 * kStages * kTile * ring_ld(D) * sizeof(T) +
         (size_t)(kTile + 1) * kHeads * sizeof(float);
}

template <typename T, int BYTES>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int S, int H, int KVH, int D, int split, int nsplit,
                    float scale) {
  static_assert(BYTES % sizeof(T) == 0, "a copy is whole elements");
  static_assert(kTile == 8 && kHeads == 4, "(a) maps 16 values to 16 lanes");
  constexpr int VEC = BYTES / (int)sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int G = H / KVH, passes = (G + kHeads - 1) / kHeads;
  const int sp = blockIdx.x * kWarps + warp;
  const int kvh = blockIdx.y / passes, pass = blockIdx.y - kvh * passes;
  const int b = blockIdx.z;
  // let the combine kernel launch now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int len = min(kv_len[b], S);
  const int r0 = sp * split;
  // no live row: the combine skips this split (a warp may leave alone:
  // nothing in this kernel waits for the whole block)
  if (sp >= nsplit || r0 >= len) return;
  const int r1 = min(r0 + split, len);
  const int ntiles = (r1 - r0 + kTile - 1) / kTile;
  const int h0 = kvh * G + pass * kHeads;  // this pass's first query head
  const int nh = min(kHeads, G - pass * kHeads);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = ring_ld(D);
  T* Kr = reinterpret_cast<T*>(smem_raw + warp * warp_smem<T>(D));
  T* Vr = Kr + kStages * kTile * ld;  // [kStages][kTile][ld] each
  float* Ps = reinterpret_cast<float*>(Vr + kStages * kTile * ld);
  float* As = Ps + kTile * kHeads;  // P [kTile][kHeads], alpha [kHeads]
  const size_t kv_step = (size_t)KVH * D;
  const T* kb = k + (size_t)b * S * kv_step + (size_t)kvh * D;
  const T* vb = v + (size_t)b * S * kv_step + (size_t)kvh * D;

  // the copies of tile i (rows below r1 only) into ring stage i % kStages;
  // always one commit group, so the wait below counts tiles
  const int per_row = D / VEC;
  // When a row is a whole number of copies that divides 32 (Dh 128 or 64
  // in 16-byte copies), lane l copies chunk l % per_row of rows l / per_row
  // + rstep i: fixed offsets, no division in the loop.
  const bool fixed = 32 % per_row == 0;
  const int rstep = fixed ? 32 / per_row : 0;
  const int fc = fixed ? (lane % per_row) * VEC : 0;
  const int fr = fixed ? lane / per_row : 0;
  auto issue = [&](int i) {
    if (i < ntiles) {
      const int t0 = r0 + i * kTile, n = min(kTile, r1 - t0);
      T* ks = Kr + (i % kStages) * kTile * ld;
      T* vs = Vr + (i % kStages) * kTile * ld;
      if (fixed) {
        for (int r = fr; r < n; r += rstep) {
          const size_t at = (size_t)(t0 + r) * kv_step + fc;
          copy_async<BYTES>(ks + r * ld + fc, kb + at);
          copy_async<BYTES>(vs + r * ld + fc, vb + at);
        }
      } else {
        for (int e = lane; e < n * per_row; e += 32) {
          const int r = e / per_row, c = (e - r * per_row) * VEC;
          const size_t at = (size_t)(t0 + r) * kv_step + c;
          copy_async<BYTES>(ks + r * ld + c, kb + at);
          copy_async<BYTES>(vs + r * ld + c, vb + at);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  if (ld > D) {  // the K pad columns meet q's zeros in the dot: make them 0
    for (int e = lane; e < kStages * kTile * (ld - D); e += 32) {
      const int r = e / (ld - D), c = D + e - r * (ld - D);
      store(Kr + r * ld + c, 0.f);
    }
  }
  const int half = lane >> 4, c0 = (lane & 15) * 8;  // (a): rows, values
  const int hj = lane & 3, row = 2 * ((lane & 15) >> 2) + half;  // (b)
  const int cv = lane * 4;  // (c): this lane's columns
  float qr[kHeads][8];
#pragma unroll
  for (int j = 0; j < kHeads; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qr[j][e] = j < nh && c0 + e < D
                     ? to_f32(q[((size_t)b * H + h0 + j) * D + c0 + e]) * scale
                     : 0.f;
  float m = kNegInf, l = 0.f;  // of head hj
  float acc[kHeads][4];
#pragma unroll
  for (int j = 0; j < kHeads; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kStages - 2>();  // this lane's copies of tile i landed
    __syncwarp();  // ... every lane's; all lanes are done with tile i - 1
    issue(i + kStages - 1);
    const int n = min(kTile, r1 - (r0 + i * kTile));  // live rows of tile i
    const T* ks = Kr + (i % kStages) * kTile * ld;
    const T* vs = Vr + (i % kStages) * kTile * ld;

    // (a) partial dots of rows 2 p + half with 4 heads, x[4 p + j]; then
    // a transposing reduction over the half-warp's 16 lanes (xor 8, 4, 2,
    // 1, each lane keeping half of its values): lane l ends with the whole
    // score of row 2 ((l & 15) >> 2) + half, head l & 3
    float x[16];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float kx[8];
      if (2 * p + half < n && c0 < ld) {
        load_n<8>(ks + (2 * p + half) * ld + c0, kx);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kx[e] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kHeads; ++j) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) a = fmaf(qr[j][e], kx[e], a);
        x[4 * p + j] = a;
      }
    }
#pragma unroll
    for (int w = 8; w > 0; w >>= 1) {
      const bool up = lane & w;
#pragma unroll
      for (int e = 0; e < w; ++e) {
        const float send = up ? x[e] : x[e + w];
        const float keep = up ? x[e + w] : x[e];
        x[e] = keep + __shfl_xor_sync(kFull, send, w);
      }
    }

    // (b) online softmax of head hj over the tile's rows (lanes xor 4, 8,
    // 16 hold its other rows)
    const bool ok = row < n;
    const float sc = ok ? x[0] : kNegInf;
    float mx = sc;
#pragma unroll
    for (int w = 4; w <= 16; w <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    m = m_new;
    const float pr = ok ? expf(sc - m_new) : 0.f;
    float sum = pr;
#pragma unroll
    for (int w = 4; w <= 16; w <<= 1) sum += __shfl_xor_sync(kFull, sum, w);
    l = l * alpha + sum;
    Ps[row * kHeads + hj] = pr;
    if (lane < kHeads) As[lane] = alpha;
    __syncwarp();

    // (c) P V over the tile's rows in order
    const float4 al = *reinterpret_cast<const float4*>(As);
    const float alj[kHeads] = {al.x, al.y, al.z, al.w};
#pragma unroll
    for (int j = 0; j < kHeads; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] *= alj[j];
    if (cv < ld) {
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        if (r >= n) break;
        const float4 p4 = *reinterpret_cast<const float4*>(Ps + r * kHeads);
        const float pj[kHeads] = {p4.x, p4.y, p4.z, p4.w};
        float vv[4];
        load_n<4>(vs + r * ld + cv, vv);
#pragma unroll
        for (int j = 0; j < kHeads; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[j][c] = fmaf(pj[j], vv[c], acc[j][c]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < kHeads; ++j) {
    if (j >= nh) break;
    const size_t at = ((size_t)b * H + h0 + j) * nsplit + sp;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (cv + c < D) part_acc[at * D + cv + c] = acc[j][c];
    if (lane == j) {  // lanes hj == j hold head j's m and l
      part_ml[2 * at] = m;
      part_ml[2 * at + 1] = l;
    }
  }
}

// the largest split count the combine stages in shared memory at once
constexpr int kCombineChunk = 256;

template <typename T>
__global__ void __launch_bounds__(kMaxD)
decode_combine_kernel(const float* __restrict__ part_ml,
                      const float* __restrict__ part_acc,
                      const int* __restrict__ kv_len, T* __restrict__ out,
                      float* __restrict__ lse, int S, int H, int D,
                      int split, int nsplit) {
  __shared__ float Ws[kCombineChunk];  // exp(m_s - m) of a chunk of splits
  __shared__ float Red[kMaxD / 32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  // launched early (programmatic dependent launch): wait here until the
  // split kernel has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int len = min(kv_len[b], S);
  const int live = len > 0 ? (len + split - 1) / split : 0;
  const size_t row = (size_t)b * H + h;
  const float* ml = part_ml + 2 * row * nsplit;
  const float* pa = part_acc + row * nsplit * D;
  float m = kNegInf;  // the max is exact in any order
  for (int s = tid; s < live; s += kMaxD) m = fmaxf(m, ml[2 * s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  if ((tid & 31) == 0) Red[tid >> 5] = m;
  __syncthreads();
  m = Red[0];
#pragma unroll
  for (int w = 1; w < kMaxD / 32; ++w) m = fmaxf(m, Red[w]);
  // l and acc: the live splits' terms summed in split order, a chunk of
  // weights at a time
  float l = 0.f, a = 0.f;
  for (int c0 = 0; c0 < live; c0 += kCombineChunk) {
    const int nc = min(kCombineChunk, live - c0);
    __syncthreads();  // the last chunk's weights are read
    for (int s = tid; s < nc; s += kMaxD) Ws[s] = expf(ml[2 * (c0 + s)] - m);
    __syncthreads();
    for (int s = 0; s < nc; ++s) l += ml[2 * (c0 + s) + 1] * Ws[s];
    if (tid < D) {
      const float* pd = pa + (size_t)c0 * D + tid;
#pragma unroll 8
      for (int s = 0; s < nc; ++s) a += pd[(size_t)s * D] * Ws[s];
    }
  }
  if (tid < D) store(out + row * D + tid, a / fmaxf(l, 1e-30f));
  // no live split: m is still -1e30 and l 0, so o is 0; the log-sum-exp
  // form names such a row with -1e30, as the plain partial does
  if (lse != nullptr && tid == 0)
    lse[row] = live > 0 ? m + logf(fmaxf(l, 1e-30f)) : kNegInf;
}

template <typename T, int BYTES>
int launch_split(const void* q, const void* k, const void* v,
                 const int* kv_len, float* part_ml, float* part_acc, int B,
                 int S, int H, int KVH, int D, int split, int nsplit,
                 float scale, cudaStream_t stream) {
  const size_t smem = kWarps * warp_smem<T>(D);
  auto kernel = decode_split_kernel<T, BYTES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int passes = (H / KVH + kHeads - 1) / kHeads;
  const dim3 grid((nsplit + kWarps - 1) / kWarps, KVH * passes, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, part_ml, part_acc, S, H, KVH, D,
      split, nsplit, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           float* part_ml, float* part_acc, void* out, float* lse, int B,
           int S, int H, int KVH, int D, int split, int nsplit, float scale,
           cudaStream_t stream) {
  if (B == 0 || H == 0) return 0;
  if (D < 1 || D > kMaxD || KVH < 1 || H % KVH != 0 || split < 1 ||
      (long long)split * nsplit < S)
    return (int)cudaErrorInvalidValue;
  if (S > 0) {
    // the widest copy that every cache row start is aligned to
    const size_t row_bytes = (size_t)D * sizeof(T);
    const uintptr_t at = (uintptr_t)k | (uintptr_t)v;
    int err;
    if (row_bytes % 16 == 0 && at % 16 == 0)
      err = launch_split<T, 16>(q, k, v, kv_len, part_ml, part_acc, B, S, H,
                                KVH, D, split, nsplit, scale, stream);
    else if (row_bytes % 4 == 0 && at % 4 == 0)
      err = launch_split<T, 4>(q, k, v, kv_len, part_ml, part_acc, B, S, H,
                               KVH, D, split, nsplit, scale, stream);
    else  // an odd bf16 Dh: one element a copy
      err = launch_split<T, (int)sizeof(T)>(q, k, v, kv_len, part_ml,
                                            part_acc, B, S, H, KVH, D,
                                            split, nsplit, scale, stream);
    if (err != 0) return err;
  }
  // the combine may be launched while the split kernel runs; it waits for
  // it on the device (griddepcontrol.wait), which hides its launch latency
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B);
  cfg.blockDim = dim3(kMaxD);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, decode_combine_kernel<T>, part_ml,
                                 part_acc, kv_len, static_cast<T*>(out), lse,
                                 S, H, D, split, nsplit);
}

}  // namespace

// q/out [B, H, D], k/v [B, S, KVH, D], contiguous, all fp32 (bf16 = 0) or
// all bf16 (bf16 = 1); kv_len [B] int32 on the device; H a multiple of
// KVH; 1 <= D <= 128.  part_ml [B, H, nsplit, 2] and part_acc [B, H,
// nsplit, D] fp32 scratch, split * nsplit >= S.  lse [B, H] fp32, or null:
// each row's log-sum-exp of its scaled scores over its live rows (-1e30
// for a row with none).  Launches both kernels on `stream` and returns the
// cudaError_t of the launches (0 on success).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const int* kv_len,
                                       float* part_ml, float* part_acc,
                                       void* out, float* lse, int B, int S,
                                       int H, int KVH, int D, int split,
                                       int nsplit, float scale, int bf16,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, kv_len, part_ml, part_acc,
                                      out, lse, B, S, H, KVH, D, split,
                                      nsplit, scale, st)
              : launch<float>(q, k, v, kv_len, part_ml, part_acc, out, lse,
                              B, S, H, KVH, D, split, nsplit, scale, st);
}
