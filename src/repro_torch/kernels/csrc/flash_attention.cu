// Causal / windowed GQA flash attention for Hopper (sm_90a), prefill:
//
//   out[b, i, h] = sum_j p_ij v[b, j, h / G],
//   p_i = softmax_j(q_i . k_j * scale)
//   over the live pairs (j <= i when causal, i - j < window when windowed,
//   j < Skv)
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (:83; body _kernel :30).  The TPU kernel walks the kv
// tiles of one (batch, head, 128-row q tile) on its sequential grid axis,
// keeping the running max m, the sum l and the fp32 accumulator in VMEM
// scratch, skipping tiles that are entirely masked, and writes the tile on
// the last kv step.  Here a loop inside one block takes the place of that
// axis.  Two kernels, picked by the input type; both take any S (rows and
// keys past S are masked, a key row past S is never read) and any
// 1 <= Dh <= 128, and walk the same kv tiles: [first, last) of the 64-row
// q tile, first = the tile holding row q0 - window + 1 (window), last = the
// tile past row q0 + 63 (causal).  A fully masked tile is never loaded,
// and would give the same bits if it were (alpha = 1, p = 0).  No atomics:
// each output is reduced by one thread in one order, the same bits on
// every run.  Q tiles are taken longest-first (block x = 0 is the last q
// tile, which has the most live kv tiles under a causal mask).
//
// Cross-attention (the encdec decoder's, over the encoder's keys): k and v
// may hold Skv rows where q holds S, when neither causal nor windowed.
// The q side (tiles, output rows) stays on S; the kv side (base pointers,
// the tile walk [0, Skv), the row and column bounds) runs on Skv.  The TPU
// kernel takes its kv length from q (`b, s, h, dh = q.shape`, a kv grid of
// s // block_k), so it has no such form: the function this one computes is
// the reference's CPU arm, nn/attention.py::_plain_cross.
//
// What bounds it on an H100: operations.  Granite prefill (B 4, S 2048,
// H 32, Dh 128, causal, bf16) needs 4 * Dh operations a live pair, 1.37e11,
// on 168 MB of inputs and outputs: 0.139 ms at 989 TFLOP/s bf16.
//
// 1. bf16 (the served model): flash_attention_tc_kernel, on the tensor
//    cores with wgmma (warpgroup MMA, bf16 operands, fp32 accumulators).
//    One warpgroup (four warps) a block owns the 64-row q tile; warp w
//    holds rows 16 w .. 16 w + 15 of every accumulator.  Per 64-row kv tile
//    the warpgroup issues S = Q K^T as Dh/16 wgmma.m64n64k16 with both
//    operands read from shared memory, waits, takes the online-softmax step
//    on the accumulator fragments (a row's 64 scores lie with the 4 lanes
//    of a quad: 2 xor-shuffles; the mask only on the tiles that need it),
//    and issues O += P V as 8 wgmma.m64n128k16 (m64n64k16 at Dh <= 64)
//    with P from registers (the S accumulator layout is the A-fragment
//    layout, as bf16 pairs) and V read from shared memory transposed.
//    Q, K and V arrive as bf16 through cp.async (16-byte copies when Dh %
//    8 == 0, 4-byte when Dh is even, 2-byte loads otherwise): K through a
//    two-stage ring, tile t + 1 in flight while tile t computes, and V
//    into one buffer, its copy issued at the top of tile t and awaited
//    after the softmax.  The shared tiles are [DP / 64][64][64] bf16, DP =
//    Dh rounded up to 64 or 128 and zero-padded (zero columns add exactly
//    0), in the 128-byte swizzle the wgmma descriptors name.  Shared
//    memory: Q, two K stages and V, 65 KB at Dh 128, and at most 168
//    registers, so three blocks (twelve warps) fit an SM.
//    Numbers: the products of bf16 q and k are exact in fp32 and sum in
//    fp32 on the tensor cores.  scale multiplies the fp32 score after the
//    dot, not q before it (q * scale is not representable in bf16): the
//    running max m is taken on the unscaled dots (scale > 0 keeps their
//    order) and p = 2^(s cl - m cl), cl = scale * log2(e), one FFMA and
//    one ex2.approx (about 2 ulp) a score.  Masked scores are -1e30, p is
//    zeroed after the exp, l is clamped at 1e-30, and l sums the fp32 p.
//    P enters P V as two bf16 halves, P_hi = bf16(P), P_lo = bf16(P -
//    P_hi), two MMAs into one fp32 accumulator: P carries about 16
//    mantissa bits (a single bf16 P would put a row with one or two live
//    keys a bf16 step off the fp32 result).  The tensor cores thus do 6 Dh
//    operations a visited pair, 1.5x the recorded 4 Dh: the bound this
//    kernel is held to is 0.21 ms.
// 2. fp32 (the parity arm): flash_attention_kernel, the first kernel's fp32
//    FMA body, unchanged (tensor cores would mean TF32).  One block of 256
//    threads per (64-row q tile, head, batch).  The scaled q tile, and per
//    step one 64-row K and V tile, are staged in shared memory as fp32
//    with an odd row stride (no bank conflicts on the column reads).
//    Thread (tr, tc) of the 16 x 16 grid owns rows tr + 16 i and, of each
//    score tile, columns tc + 16 j (i, j < 4): 16 scores by fp32 FMA in
//    registers.  A row's 64 scores lie with the 16 threads of one
//    half-warp (4 xor-shuffles for the max and the sum).  P goes to shared
//    memory over the dead K tile, and the same thread owns output columns
//    tc + 16 j (j < 8) of its 4 rows, so the accumulator stays in
//    registers.  Numbers as the TPU kernel: q scaled in fp32 before the
//    dot, P fp32 into P V, -1e30, p zeroed after the exp, l >= 1e-30.
//    99 KB of shared memory at Dh 128, two blocks an SM; bound by its
//    shared loads (8 a 16 FMAs in QK^T, 12 a 32 in P V).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// ---------------- fp32: FMA ----------------


constexpr int kBQ = 64;  // query rows a block
constexpr int kBK = 64;  // key rows a tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kMaxD = 128;
constexpr int kDPer = kMaxD / 16;  // output columns a thread owns
constexpr int kLdP = kBK + 1;  // row stride of the P tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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
                       int Skv, int H, int KVH, int D, int causal,
                       int window, float scale) {
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
  const T* kb = k + (size_t)b * Skv * kv_step + (size_t)kvh * D;
  const T* vb = v + (size_t)b * Skv * kv_step + (size_t)kvh * D;

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
  const int k_end = causal ? min(S, q0 + kBQ) : Skv;
  int kt = 0;
  if (window && q0 - window + 1 > 0) kt = (q0 - window + 1) / kBK;
  const int kt_end = (k_end + kBK - 1) / kBK;

  for (; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's readers are done with Ps and Vs
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      const int row = k0 + r;
      const bool ok = row < Skv;
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
        bool ok = col < Skv;
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


// ---------------- bf16: tensor cores ----------------

constexpr int kTcThreads = 128;  // one warpgroup: 16 of the kBQ q rows a warp
constexpr int kStages = 2;  // the K ring
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Element offset of (row, col) in a [DP / 64][ROWS][64] bf16 tile: rows of
// 64 columns (128 bytes), each 8-row x 128-byte atom with its 16-byte chunk
// index XORed with row & 7.  This is the 128-byte swizzle wgmma reads (the
// hardware XORs address bits 4-6 with bits 7-9, so tiles are 1024-byte
// aligned); the 8 rows an access reads at one chunk fall in 8 bank groups.
template <int ROWS>
__device__ __forceinline__ int sw128(int row, int col) {
  return (col >> 6) * (ROWS * 64) + row * 64 +
         ((((col >> 3) & 7) ^ (row & 7)) << 3) + (col & 7);
}

// One VEC-element copy from global to shared memory: cp.async for 16 and
// 4 bytes, a synchronous 2-byte load and store for an odd Dh.
template <int VEC>
__device__ __forceinline__ void copy_async(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src) {
  if constexpr (VEC == 8) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  } else if constexpr (VEC == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [row0, row0 + ROWS) of a [S][step] global array, columns [0, D),
// into a swizzled tile; a row at or past S and the pad columns [D, DP) are
// written as zeros.  With 16-byte copies, thread tid copies column chunk
// tid % (DP / 8) of rows tid / (DP / 8) + i * kRowStep: one shared offset
// and one global pointer a thread, each stepped by a constant (steps of 8
// rows keep the swizzle's row & 7).
template <int ROWS, int DP, int VEC>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* src,
                                          size_t step, int row0, int S,
                                          int D, int tid) {
  constexpr int kPerRow = DP / VEC;
  if constexpr (VEC == 8) {
    constexpr int kRowStep = kTcThreads / kPerRow;
    static_assert(kRowStep % 8 == 0 && ROWS % kRowStep == 0, "8-row steps");
    const int c = (tid % kPerRow) * VEC, r = tid / kPerRow;
    __nv_bfloat16* dst = tile + sw128<ROWS>(r, c);
    const __nv_bfloat16* from = src + (size_t)(row0 + r) * step + c;
    const int live_rows = c < D ? S - row0 - r : 0;  // of r + kRowStep i
#pragma unroll
    for (int i = 0; i < ROWS / kRowStep; ++i) {
      __nv_bfloat16* to = dst + i * kRowStep * 64;
      if (i * kRowStep < live_rows) {
        copy_async<VEC>(to, from + (size_t)i * kRowStep * step);
      } else {
        *reinterpret_cast<uint4*>(to) = make_uint4(0, 0, 0, 0);
      }
    }
  } else {
    for (int e = tid; e < ROWS * kPerRow; e += kTcThreads) {
      const int r = e / kPerRow, c = (e % kPerRow) * VEC;
      __nv_bfloat16* dst = tile + sw128<ROWS>(r, c);
      const int row = row0 + r;
      if (row < S && c < D) {
        copy_async<VEC>(dst, src + (size_t)row * step + c);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) dst[i] = __float2bfloat16_rn(0.f);
      }
    }
  }
}

// A wgmma shared-memory descriptor with the 128-byte swizzle: the start
// address, the leading and the stride byte offsets, all in 16-byte units.
// K-major operands: rows 128 bytes apart, 8-row groups sbo = 1024 bytes
// apart (lbo unused).  MN-major: 64-element blocks lbo apart, 8-row groups
// along K sbo apart.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the accumulators are the wgmma's until its wait: keep the compiler from
// moving their reads or writes across it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d = a b (scale_d 0) or d += a b: A [64 x 16] and B [64 x 16] from shared
// memory, both K-major (128-byte swizzle), 64 x 64 fp32 accumulators
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += a b: A [64 x 16] in registers (the accumulator layout of a
// m64nNk16 product, as bf16 pairs), B [16 x 64] from shared memory, MN-major
// (transposed, 128-byte swizzle), 64 x 64 fp32 accumulators
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, "
      "1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a b: A [64 x 16] in registers (the accumulator layout of a
// m64nNk16 product, as bf16 pairs), B [16 x 128] from shared memory, MN-major
// (transposed, 128-byte swizzle), 64 x 128 fp32 accumulators
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) -> packed bf16 hi = bf16(x, y) and lo = bf16((x, y) - hi)
__device__ __forceinline__ void split_hi_lo(float x, float y, uint32_t& hi,
                                            uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// 2^x by the SFU (ex2.approx: about 2 ulp; a result below 2^-126 is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DP == 128) {
    wgmma_rs_n128(o, a, db);
  } else {
    wgmma_rs_n64(o, a, db);
  }
}

template <int DP, int VEC>
__global__ void __launch_bounds__(kTcThreads, 3)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out, int S, int Skv,
                          int H, int KVH, int D, int causal, int window,
                          float scale) {
  static_assert(DP == 64 || DP == 128, "DP is 64 or 128");
  constexpr int kTile = kBK * DP;  // elements of a Q, K or V tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // tiles 1024-byte aligned: the swizzle is a function of the address
  const uint32_t base = smem_addr(smem_raw);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + (((base + 1023) & ~1023u) - base));
  __nv_bfloat16* Ks = Qs + kTile;  // K of stage st at Ks + st kTile
  __nv_bfloat16* Vs = Ks + 2 * kTile;  // one V tile

  const int nq = (S + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;  // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  const size_t q_step = (size_t)H * D;
  const size_t kv_step = (size_t)KVH * D;
  const __nv_bfloat16* qb = q + (size_t)b * S * q_step + (size_t)h * D;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * kv_step + (size_t)kvh * D;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * kv_step + (size_t)kvh * D;

  // the kv tiles holding a live pair for some row of this block
  const int k_end = causal ? min(S, q0 + kBQ) : Skv;
  int kt = 0;
  if (window && q0 - window + 1 > 0) kt = (q0 - window + 1) / kBK;
  const int kt_end = (k_end + kBK - 1) / kBK;

  load_tile<kBQ, DP, VEC>(Qs, qb, q_step, q0, S, D, tid);
  load_tile<kBK, DP, VEC>(Ks, kb, kv_step, kt * kBK, Skv, D, tid);
  cp_async_commit();

  float o[DP / 2];  // accumulator of O: element 4 n + e is row
                    // w0 + g + 8 (e >> 1), column 8 n + 2 t + (e & 1)
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g and g + 8
  const int w0 = q0 + warp * 16;  // this warp's first q row
  const float cl = scale * kLog2e;  // p = 2^((s - m) cl) = e^((s - m) scale)
  // descriptors of the tiles' starts; a step adds its byte offset / 16
  const uint64_t dq = desc_sw128(Qs, 16, 1024);
  const uint64_t dk0 = desc_sw128(Ks, 16, 1024);
  const uint64_t dk1 = desc_sw128(Ks + kTile, 16, 1024);
  const uint64_t dv = desc_sw128(Vs, kBK * 128, 1024);

  for (int i = 0; kt < kt_end; ++kt, ++i) {
    const int st = i & 1;
    cp_async_wait_all();  // this thread's copies of K (and Q) have landed
    // make them visible to the tensor cores' (async proxy) reads, then to
    // every thread; the V tile and K's stage st ^ 1 are free
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    load_tile<kBK, DP, VEC>(Vs, vb, kv_step, kt * kBK, Skv, D, tid);
    cp_async_commit();  // V of tile kt: lands during S and the softmax
    if (kt + 1 < kt_end)
      load_tile<kBK, DP, VEC>(Ks + (st ^ 1) * kTile, kb, kv_step,
                              (kt + 1) * kBK, Skv, D, tid);
    cp_async_commit();  // K of tile kt + 1: lands during this tile
    const int k0 = kt * kBK;
    const uint64_t dk = st ? dk1 : dk0;

    // S = Q K^T over DP / 16 steps of 16: element 4 j + e of s is row
    // w0 + g + 8 (e >> 1), key k0 + 8 j + 2 t + (e & 1)
    float s[32];  // the first product ignores s (scale_d = 0)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      // 16 columns a step: 32 bytes into a 128-byte row, 8 KB a 64-col block
      const int at = ((kk >> 2) * kBK * 128 + (kk & 3) * 32) >> 4;
      wgmma_ss_n64(s, dq + at, dk + at, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // mask, online softmax on the unscaled dots; a tile every pair of
    // which is live for this warp (most of them) skips the mask
    const bool all_live = (!causal || k0 + kBK - 1 <= w0) && k0 + kBK <= Skv &&
                          (!window || w0 + 15 - k0 < window);
    auto live = [&](int e, int j) {
      const int row = w0 + g + 8 * (e >> 1);
      const int col = k0 + 8 * j + 2 * t + (e & 1);
      bool ok = col < Skv;
      if (causal) ok = ok && row >= col;
      if (window) ok = ok && row - col < window;
      return ok;
    };
    if (!all_live) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!live(e, j)) s[4 * j + e] = kNegInf;
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = ex2((m[r] - m_new) * cl);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
    const float mc[2] = {m[0] * cl, m[1] * cl};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = ex2(fmaf(s[4 * j + e], cl, -mc[e >> 1]));
    if (!all_live) {  // p zeroed after the exp
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!live(e, j)) s[4 * j + e] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e >> 1] += s[4 * j + e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(kFull, sum[r], 1);
      sum[r] += __shfl_xor_sync(kFull, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
    if (alpha[0] != 1.f || alpha[1] != 1.f) {  // times 1 is exact: skip it
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
    }

    // O += P_hi V + P_lo V, 16 keys a step: elements 4 j + e of s for
    // j = 2 kk, 2 kk + 1 are P's A fragment for keys 16 kk .. + 15
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* p0 = s + 8 * kk;  // n-tile 2 kk, then 2 kk + 1
      split_hi_lo(p0[0], p0[1], ph[kk][0], pl[kk][0]);
      split_hi_lo(p0[2], p0[3], ph[kk][1], pl[kk][1]);
      split_hi_lo(p0[4], p0[5], ph[kk][2], pl[kk][2]);
      split_hi_lo(p0[6], p0[7], ph[kk][3], pl[kk][3]);
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // V landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 rows of 128 bytes a step
      wgmma_pv<DP>(o, ph[kk], dv + kk * 128);
      wgmma_pv<DP>(o, pl[kk], dv + kk * 128);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= S) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* o_row = out + ((size_t)b * S + row) * q_step +
                           (size_t)h * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < D) o_row[col] = __float2bfloat16_rn(o[4 * n + 2 * r] / l_safe);
      if (col + 1 < D)
        o_row[col + 1] = __float2bfloat16_rn(o[4 * n + 2 * r + 1] / l_safe);
    }
  }
}

int launch_fp32(const void* q, const void* k, const void* v, void* out,
                int B, int S, int Skv, int H, int KVH, int D, int causal,
                int window, float scale, cudaStream_t stream) {
  const size_t smem =
      ((size_t)(kBQ + kBK) * row_stride(D) + kp_floats(D)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<float>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<float><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, Skv, H, KVH,
      D, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int DP, int VEC>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int S, int Skv, int H, int KVH, int D, int causal, int window,
              float scale, cudaStream_t stream) {
  // Q, two stages of K, V, and the slack to align them to 1024 bytes
  const size_t smem = (size_t)(2 + kStages) * kBK * DP * 2 + 1024;
  auto kernel = flash_attention_tc_kernel<DP, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), S, Skv, H, KVH, D, causal, window,
      scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_tc_vec(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int Skv, int H, int KVH, int D, int causal,
                  int window, float scale, cudaStream_t stream) {
  // the widest copy that every row start of q, k and v is aligned to
  const uintptr_t at = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v;
  if (D % 8 == 0 && at % 16 == 0)
    return launch_tc<DP, 8>(q, k, v, out, B, S, Skv, H, KVH, D, causal,
                            window, scale, stream);
  if (D % 2 == 0 && at % 4 == 0)
    return launch_tc<DP, 2>(q, k, v, out, B, S, Skv, H, KVH, D, causal,
                            window, scale, stream);
  return launch_tc<DP, 1>(q, k, v, out, B, S, Skv, H, KVH, D, causal, window,
                          scale, stream);
}

}  // namespace

// q/out [B, S, H, D], k/v [B, Skv, KVH, D], contiguous, all fp32 (bf16 =
// 0, the FMA kernel) or all bf16 (bf16 = 1, the tensor-core kernel); H a
// multiple of KVH; 1 <= D <= 128; window 0 = none; Skv != S only when
// neither causal nor windowed (cross-attention).  Launches on `stream` and
// returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for a shape it does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int Skv, int H, int KVH, int D,
                                      int causal, int window, float scale,
                                      int bf16, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (D < 1 || D > kMaxD || KVH < 1 || H % KVH != 0 || window < 0 ||
      Skv < 1 || ((causal || window) && Skv != S))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return launch_fp32(q, k, v, out, B, S, Skv, H, KVH, D, causal, window,
                       scale, st);
  if (D <= 64)
    return launch_tc_vec<64>(q, k, v, out, B, S, Skv, H, KVH, D, causal,
                             window, scale, st);
  return launch_tc_vec<128>(q, k, v, out, B, S, Skv, H, KVH, D, causal,
                            window, scale, st);
}

// The tensor-core instruction of the bf16 kernel.
extern "C" const char* flash_attention_bf16_instruction() {
  return "wgmma.mma_async.sync.aligned.m64n64k16 (Q K^T, both from shared "
         "memory) and m64n128k16 (P V, P from registers), bf16 in, fp32 "
         "accumulators";
}
