// Fused multi-head GAT neighbor aggregation for Hopper (sm_90a), with the
// optional fused NA->SA epilogue.
//
// Replaces the TPU kernel src/repro/kernels/gat_na.py::gat_na (:225; tile
// update _tile_update :62, bodies _resident_kernel :144 /
// _streaming_kernel :168, epilogue _sa_epilogue :109).  Same contract:
//
//   for each metapath s and destination row n, over the K neighbor slots j
//     e_j   = leaky_relu(a_dst[s]·h_dst[n] + a_src[s]·h_src[nbr[s,n,j]])
//     alpha = masked softmax of e over the live slots (mask != 0)
//     out   = sum_j alpha_j h_src[nbr[s,n,j]]      per head, [H, Dh]
//   with the epilogue (FUSED):
//     z = elu(out),  w[s] = (1/N) sum_{n<N} q·tanh(z[s,n] W + b)
//
// Design.  One warp owns one destination row; lane l holds features
// c*32 + l of the H*Dh row (c < NF).  A head's Dh features sit in Dh
// neighbouring lanes, so per-head dot products are xor-shuffle sums over
// aligned groups of Dh lanes (Dh divides 32).  The warp walks the slots
// j = 0..K-1 in order and skips masked ones; each live slot gathers one
// h_src row (coalesced, 4*H*Dh bytes) that feeds both its score and its
// weighted contribution, and the softmax is online (running max,
// denominator and rescaled accumulator per head), so every row reads its
// neighbours exactly once.  The slot order is fixed and independent of
// the source row id, so a later cache remap of source rows cannot change
// the sum.  An all-masked row ends with acc = denom = 0 and writes
// 0 / max(0, 1e-9) = 0, never NaN.
//
// The epilogue stages W [H*Dh, Hs] in shared memory once per block, and
// each warp computes its row's zW + b in the kernel body (lane l owns the
// columns l, l+32, ...; z_f is broadcast by shuffle).  Row scores of a
// block are summed in row order into partial[s, block]; a second kernel
// sums partial[s, :] in block order and divides by N.  No float atomics:
// the result is the same bits on every run.
//
// What bounds it on an H100: bytes.  Per call it must read nbr and mask
// (8 bytes a slot), h_dst once, the source rows that live slots name
// (h_src is 1.1 MB on HAN/imdb and stays in the 50 MB L2 after its first
// touch), and write z.  The epilogue adds 2*H*Dh*Hs flops a row, which
// stays below the byte time at the main shape.  The gathers are dependent
// loads (index, then row), so the design relies on many warps in flight:
// 8 warps a block, 2 rows a warp, and small shared memory (32 KB for W at
// the main shape) so several blocks share an SM.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kMaxChunks = 8;  // H*Dh <= 256
constexpr float kNeg = -1e9f;
constexpr unsigned kFull = 0xffffffffu;

// Sum over aligned groups of g lanes (g a power of two, g <= 32).  Float
// addition commutes, so every lane of a group ends with the same bits.
__device__ __forceinline__ float group_sum(float v, int g) {
  for (int o = g >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <int NF, bool FUSED>
__global__ void __launch_bounds__(kWarps * 32)
gat_na_kernel(const float* __restrict__ h_dst, const float* __restrict__ h_src,
              const int* __restrict__ nbr, const float* __restrict__ mask,
              const float* __restrict__ a_dst, const float* __restrict__ a_src,
              const float* __restrict__ W, const float* __restrict__ bias,
              const float* __restrict__ q, float* __restrict__ out,
              float* __restrict__ partial, int N, int K, int HD, int Dh,
              int Hs) {
  extern __shared__ float smem[];  // FUSED: W [HD*Hs], row scores [rows]
  float* w_s = smem;
  float* row_score = smem + HD * Hs;
  const int s = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (FUSED) {
    for (int i = threadIdx.x; i < HD * Hs; i += blockDim.x) w_s[i] = W[i];
    __syncthreads();
  }

  bool valid[NF];
  float ad[NF], as[NF];
#pragma unroll
  for (int c = 0; c < NF; ++c) {
    const int f = c * 32 + lane;
    valid[c] = f < HD;
    ad[c] = valid[c] ? a_dst[(size_t)s * HD + f] : 0.f;
    as[c] = valid[c] ? a_src[(size_t)s * HD + f] : 0.f;
  }

  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int local = warp * kRowsPerWarp + r;
    const int n = blockIdx.x * kRowsPerBlock + local;
    float score = 0.f;
    if (n < N) {  // warp-uniform
      float ed[NF], m[NF], den[NF], acc[NF];
#pragma unroll
      for (int c = 0; c < NF; ++c) {
        const float hd = valid[c] ? h_dst[(size_t)n * HD + c * 32 + lane] : 0.f;
        ed[c] = group_sum(ad[c] * hd, Dh);
        m[c] = kNeg;
        den[c] = 0.f;
        acc[c] = 0.f;
      }
      const size_t row = (size_t)s * N + n;
      const int* nb = nbr + row * K;
      const float* mk = mask + row * K;
      for (int base = 0; base < K; base += 32) {
        const int j = base + lane;
        const int idx_l = j < K ? nb[j] : 0;
        const float live_l = j < K ? mk[j] : 0.f;
        const int cnt = min(32, K - base);
        for (int jj = 0; jj < cnt; ++jj) {  // slots in order
          const float live = __shfl_sync(kFull, live_l, jj);
          const int idx = __shfl_sync(kFull, idx_l, jj);
          if (live == 0.f) continue;  // warp-uniform
          const float* hs = h_src + (size_t)idx * HD;
#pragma unroll
          for (int c = 0; c < NF; ++c) {
            const float h = valid[c] ? hs[c * 32 + lane] : 0.f;
            float e = ed[c] + group_sum(as[c] * h, Dh);
            e = e >= 0.f ? e : 0.2f * e;
            const float m_new = fmaxf(m[c], e);
            const float scale = expf(m[c] - m_new);
            const float pw = expf(e - m_new);
            den[c] = den[c] * scale + pw;
            acc[c] = acc[c] * scale + pw * h;
            m[c] = m_new;
          }
        }
      }
      float z[NF];
#pragma unroll
      for (int c = 0; c < NF; ++c) {
        float o = acc[c] / fmaxf(den[c], 1e-9f);
        if (FUSED) o = o > 0.f ? o : expm1f(o);
        z[c] = o;
        if (valid[c]) out[row * HD + c * 32 + lane] = o;
      }
      if (FUSED) {
        for (int cb = 0; cb < Hs; cb += 32) {
          const int col = cb + lane;
          const bool cv = col < Hs;
          float t = cv ? bias[col] : 0.f;
#pragma unroll
          for (int c = 0; c < NF; ++c) {
#pragma unroll
            for (int l = 0; l < 32; ++l) {
              const float zf = __shfl_sync(kFull, z[c], l);
              const int f = c * 32 + l;
              if (cv && f < HD) t += zf * w_s[f * Hs + col];
            }
          }
          if (cv) score += q[col] * tanhf(t);
        }
        score = group_sum(score, 32);
      }
    }
    if (FUSED && lane == 0) row_score[local] = score;  // rows >= N give 0
  }

  if (FUSED) {
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
      for (int i = 0; i < kRowsPerBlock; ++i) t += row_score[i];  // row order
      partial[(size_t)s * gridDim.x + blockIdx.x] = t;
    }
  }
}

// w[s] = (sum of partial[s, :] in block order) / N.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    int n_blocks, int N,
                                    float* __restrict__ w) {
  if (threadIdx.x != 0) return;
  const int s = blockIdx.x;
  float t = 0.f;
  for (int i = 0; i < n_blocks; ++i) t += partial[(size_t)s * n_blocks + i];
  w[s] = t / (float)N;
}

template <int NF>
cudaError_t launch_nf(bool fused, dim3 grid, size_t smem, cudaStream_t st,
                      const float* h_dst, const float* h_src, const int* nbr,
                      const float* mask, const float* a_dst,
                      const float* a_src, const float* W, const float* b,
                      const float* q, float* out, float* partial, int N, int K,
                      int HD, int Dh, int Hs) {
  if (fused) {
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          gat_na_kernel<NF, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return err;
    }
    gat_na_kernel<NF, true><<<grid, kWarps * 32, smem, st>>>(
        h_dst, h_src, nbr, mask, a_dst, a_src, W, b, q, out, partial, N, K,
        HD, Dh, Hs);
  } else {
    gat_na_kernel<NF, false><<<grid, kWarps * 32, 0, st>>>(
        h_dst, h_src, nbr, mask, a_dst, a_src, W, b, q, out, partial, N, K,
        HD, Dh, 0);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int gat_na_rows_per_block() { return kRowsPerBlock; }

extern "C" int gat_na_max_features() { return kMaxChunks * 32; }

// Launch on `stream`.  W, b, q, partial and w are null unless fused.
// partial holds S * ceil(N / gat_na_rows_per_block()) floats.  Returns
// the cudaError_t of the launches (0 on success).
extern "C" int gat_na_launch(const float* h_dst, const float* h_src,
                             const int* nbr, const float* mask,
                             const float* a_dst, const float* a_src,
                             const float* W, const float* b, const float* q,
                             float* out, float* partial, float* w, int S,
                             int N, int K, int H, int Dh, int Hs,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int HD = H * Dh;
  const int nf = (HD + 31) / 32;
  const bool fused = W != nullptr;
  const int n_blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  const dim3 grid(n_blocks, S);
  const size_t smem =
      fused ? sizeof(float) * ((size_t)HD * Hs + kRowsPerBlock) : 0;
  cudaError_t err;
  switch (nf) {
#define GAT_NA_CASE(NFV)                                                     \
  case NFV:                                                                  \
    err = launch_nf<NFV>(fused, grid, smem, st, h_dst, h_src, nbr, mask,     \
                         a_dst, a_src, W, b, q, out, partial, N, K, HD, Dh,  \
                         Hs);                                                \
    break;
    GAT_NA_CASE(1)
    GAT_NA_CASE(2)
    GAT_NA_CASE(3)
    GAT_NA_CASE(4)
    GAT_NA_CASE(5)
    GAT_NA_CASE(6)
    GAT_NA_CASE(7)
    GAT_NA_CASE(8)
#undef GAT_NA_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  if (fused) {
    sum_partials_kernel<<<S, 32, 0, st>>>(partial, n_blocks, N, w);
    err = cudaGetLastError();
  }
  return (int)err;
}
