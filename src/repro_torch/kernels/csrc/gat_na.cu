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
// What bounds it on an H100: bytes — nbr and mask (8 bytes a slot), h_dst
// once, the source rows that live slots name, z once; the epilogue adds
// 2*H*Dh*Hs flops a row.  At HAN/imdb that is 2-3 us of work.  The time is
// set by the per-slot online softmax (about 50 warp instructions a live
// slot: shuffle sums, an exp, the updates) and by how evenly rows of 1 to
// 64 live slots spread over the warps.
//
// Design.  A persistent grid (the blocks the card holds at once: one of 32
// warps an SM for rows of up to 64 features, two of 16 for wider ones);
// each warp takes rows from a work counter (an integer atomic, one row at
// a time), so a warp that drew a 64-slot row simply takes fewer rows and
// no SM waits on another's tail.  Per row, lane l holds features c*32 + l of
// the H*Dh row (c < NF).  A head's Dh features sit in Dh neighbouring
// lanes, so per-head dot products are xor-shuffle sums over aligned groups
// of Dh lanes (Dh divides 32).  The warp takes the slots 32 at a time: one
// ballot over their mask compacts the live slots' indices, in slot order,
// into the warp's shared memory, so a dead slot costs nothing more.  The
// live slots then go in batches: the batch's source rows are all gathered
// first (every load in flight together), then their scores (unrolled
// shuffle sums, independent across slots), then the online softmax takes
// them one by one in slot order (running max, denominator and rescaled
// accumulator per head), with the arithmetic, and so the bits, of a
// slot-by-slot walk: of exp(m - m_new) and exp(e - m_new) one is exp(0) =
// 1 exactly, so one exp(-|e - m|) gives both.  The slot order is fixed and
// independent of the source row id, so a later cache remap of source rows
// cannot change the sum.  An all-masked row ends with acc = denom = 0 and
// writes 0 / max(0, 1e-9) = 0, never NaN.  Which warp takes a row changes
// nothing in its arithmetic, so a run gives the same bits every time.
//
// The epilogue is a tile product.  W [H*Dh, Hs] goes to shared memory by
// cp.async once a block; each warp keeps the z = elu(out) of its last
// kGroupRows rows transposed in its shared memory and multiplies them by W
// together: lane l owns columns 4 l .. 4 l + 3 (+ 128 j) of all the rows
// and accumulates zW by FMA in feature order from one 16-byte z load (the
// rows) and one 16-byte W load (the columns) per feature.  A row's score
// sums q·tanh(zW + b) over the lane's columns in order, then over the 32
// lanes by an xor butterfly, into score[s, n].  A second kernel, one block
// a metapath, sums score[s, :] in a fixed order: rows in blocks of
// kRowsPerBlock in order, block b to lane b % 32 in order, the lanes by an
// xor butterfly, then / N.  No float atomics.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {

// warps a block: one block of 32 warps an SM for rows of up to 64
// features (64 registers a thread suffice), two of 16 for wider rows
__host__ __device__ constexpr int warps_of(int nf) { return nf <= 2 ? 32 : 16; }
constexpr int kRowsPerBlock = 16;  // rows a partial of the score sum
constexpr int kMaxChunks = 8;      // H*Dh <= 256
constexpr int kGroupRows = 4;      // rows of a warp's epilogue tile
constexpr int kSumThreads = 256;   // the score-sum kernel
constexpr float kNeg = -1e9f;
constexpr unsigned kFull = 0xffffffffu;

// live slots gathered together: more for narrow rows, fewer registers a
// slot for wide ones
template <int NF>
__host__ __device__ constexpr int batch_of() {
  return NF <= 2 ? 8 : (NF <= 4 ? 4 : 2);
}

// W's row stride in shared memory: Hs rounded up to 4 (16-byte rows)
__host__ __device__ inline int w_ld(int Hs) { return (Hs + 3) & ~3; }

// Shared memory: live slot indices [warps][32] | FUSED: W [HD][w_ld] |
// each warp's z rows, transposed [warps][HD][kGroupRows].  With the
// epilogue it must fit the 227 KB a block may hold on an H100, which sets
// the widest Hs: 1656 at HD = 32, 764 at HD = 64, 384 at HD = 128, 160 at
// HD = 256.  The wrapper refuses a wider W before it launches (its copy of
// this sum is held equal to gat_na_smem_bytes); the launcher returns
// cudaFuncSetAttribute's error.
size_t smem_bytes(bool fused, int HD, int Hs) {
  const int warps = warps_of((HD + 31) / 32);
  size_t floats = (size_t)warps * 32;
  if (fused)
    floats += (size_t)HD * w_ld(Hs) + (size_t)warps * HD * kGroupRows;
  return sizeof(float) * floats;
}

// Sum over aligned groups of G lanes (G a power of two, G <= 32), unrolled
// so that independent sums overlap.  Float addition commutes, so every
// lane of a group ends with the same bits.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// e[b][c] = leaky_relu(ed[c] + a_src·h over each head's G lanes) for a
// batch of gathered rows: B * NF independent shuffle sums
template <int NF, int B, int G>
__device__ __forceinline__ void batch_scores(const float (&h)[B][NF],
                                             const float (&ed)[NF],
                                             const float (&as)[NF], int n_ok,
                                             float (&e)[B][NF]) {
#pragma unroll
  for (int b = 0; b < B; ++b)
    if (b < n_ok) {  // warp-uniform: a short batch skips its padding
#pragma unroll
      for (int c = 0; c < NF; ++c) {
        const float v = ed[c] + group_sum<G>(as[c] * h[b][c]);
        e[b][c] = v >= 0.f ? v : 0.2f * v;
      }
    }
}

// ed[c] = a_dst·h_dst over each head's G lanes
template <int NF, int G>
__device__ __forceinline__ void row_scores(const float (&ad)[NF],
                                           const float (&hd)[NF],
                                           float (&ed)[NF]) {
#pragma unroll
  for (int c = 0; c < NF; ++c) ed[c] = group_sum<G>(ad[c] * hd[c]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The epilogue of one warp's rows: z_w [HD][kGroupRows] (rows past `rows`
// hold 0) times W [HD][ldw] in shared memory; score[rid[r]] for r < rows.
__device__ __forceinline__ void epilogue(const float* z_w, const float* w_s,
                                         int ldw, int HD, int Hs,
                                         const float* __restrict__ bias,
                                         const float* __restrict__ q,
                                         const int (&rid)[kGroupRows],
                                         int rows, float* score, int lane) {
  float sc[kGroupRows] = {0.f, 0.f, 0.f, 0.f};
  for (int cb = 0; cb < Hs; cb += 128) {
    const int col = cb + 4 * lane;
    if (col < Hs) {
      float t[kGroupRows][4] = {};
      for (int k = 0; k < HD; ++k) {  // feature order
        const float4 zv =
            *reinterpret_cast<const float4*>(&z_w[k * kGroupRows]);
        const float4 wv =
            *reinterpret_cast<const float4*>(&w_s[k * ldw + col]);
        const float zr[4] = {zv.x, zv.y, zv.z, zv.w};
#pragma unroll
        for (int r = 0; r < kGroupRows; ++r) {
          t[r][0] = fmaf(zr[r], wv.x, t[r][0]);
          t[r][1] = fmaf(zr[r], wv.y, t[r][1]);
          t[r][2] = fmaf(zr[r], wv.z, t[r][2]);
          t[r][3] = fmaf(zr[r], wv.w, t[r][3]);
        }
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        if (col + cc < Hs) {
          const float bc = bias[col + cc], qc = q[col + cc];
#pragma unroll
          for (int r = 0; r < kGroupRows; ++r)
            sc[r] = __fadd_rn(sc[r],
                              __fmul_rn(qc, tanhf(__fadd_rn(t[r][cc], bc))));
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kGroupRows; ++r) {
    const float v = group_sum<32>(sc[r]);
    if (lane == 0 && r < rows) score[rid[r]] = v;
  }
}

template <int NF, bool FUSED>
__global__ void __launch_bounds__(32 * warps_of(NF), 1)
gat_na_kernel(const float* __restrict__ h_dst, const float* __restrict__ h_src,
              const int* __restrict__ nbr, const float* __restrict__ mask,
              const float* __restrict__ a_dst, const float* __restrict__ a_src,
              const float* __restrict__ W, const float* __restrict__ bias,
              const float* __restrict__ q, float* __restrict__ out,
              float* __restrict__ score, int* __restrict__ work, int S,
              int N, int K, int HD, int Dh, int Hs) {
  constexpr int B = batch_of<NF>();
  extern __shared__ __align__(16) float smem[];
  constexpr int kWarps = warps_of(NF);
  constexpr int kThreads = 32 * kWarps;
  int* s_idx = reinterpret_cast<int*>(smem);  // [kWarps][32]
  float* w_s = smem + kWarps * 32;            // [HD][ldw]
  const int ldw = w_ld(Hs);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* z_w = w_s + HD * ldw + warp * HD * kGroupRows;  // [HD][kGroupRows]
  // the score sum may be scheduled now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if constexpr (FUSED) {  // W once a block, zero-padded to ldw columns
    const int total = HD * Hs;
    if (reinterpret_cast<uintptr_t>(W) % 16 == 0 && Hs % 4 == 0) {
      for (int i = threadIdx.x; i < total / 4; i += kThreads)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_addr(w_s + 4 * i)),
                     "l"(W + 4 * i));
    } else {
      for (int i = threadIdx.x; i < HD * ldw; i += kThreads) {
        const int k = i / ldw, c = i % ldw;
        if (c < Hs)
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                           smem_addr(w_s + i)),
                       "l"(W + k * Hs + c));
        else
          w_s[i] = 0.f;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }

  bool valid[NF];
#pragma unroll
  for (int c = 0; c < NF; ++c) valid[c] = c * 32 + lane < HD;
  int rid[kGroupRows];  // the rows of this warp's epilogue tile
  int rows = 0;
  int* my_idx = s_idx + warp * 32;
  const int total_rows = S * N;
  for (;;) {
    int r_id = 0;
    if (lane == 0) {
      r_id = atomicAdd(work, 1);
      // every warp draws once past the last row, so this draw is the
      // counter's last use: leave it at 0 for the next launch
      if (r_id == total_rows + (int)gridDim.x * kWarps - 1) *work = 0;
    }
    r_id = __shfl_sync(kFull, r_id, 0);
    if (r_id >= total_rows) break;  // warp-uniform
    const int s = r_id / N, n = r_id % N;
    float ed[NF], as[NF], ad[NF], hd[NF], m[NF], den[NF], acc[NF];
#pragma unroll
    for (int c = 0; c < NF; ++c) {
      const int f = c * 32 + lane;
      ad[c] = valid[c] ? a_dst[(size_t)s * HD + f] : 0.f;
      as[c] = valid[c] ? a_src[(size_t)s * HD + f] : 0.f;
      hd[c] = valid[c] ? h_dst[(size_t)n * HD + f] : 0.f;
      m[c] = kNeg;
      den[c] = 0.f;
      acc[c] = 0.f;
    }
    switch (Dh) {  // warp-uniform: the head width picks the shuffle sums
      case 1: row_scores<NF, 1>(ad, hd, ed); break;
      case 2: row_scores<NF, 2>(ad, hd, ed); break;
      case 4: row_scores<NF, 4>(ad, hd, ed); break;
      case 8: row_scores<NF, 8>(ad, hd, ed); break;
      case 16: row_scores<NF, 16>(ad, hd, ed); break;
      default: row_scores<NF, 32>(ad, hd, ed); break;
    }
    const int* nb = nbr + (size_t)r_id * K;
    const float* mk = mask + (size_t)r_id * K;
    for (int base = 0; base < K; base += 32) {
      const int j = base + lane;
      const bool live_l = j < K && mk[j] != 0.f;
      const unsigned live = __ballot_sync(kFull, live_l);
      if (live_l) my_idx[__popc(live & ((1u << lane) - 1u))] = nb[j];
      __syncwarp();
      const int cnt = __popc(live);
      for (int i = 0; i < cnt; i += B) {
        float h[B][NF], e[B][NF];
#pragma unroll
        for (int b = 0; b < B; ++b) {  // the batch's gathers, all in flight
          const bool ok = i + b < cnt;
          const float* hs = h_src + (size_t)my_idx[ok ? i + b : 0] * HD;
#pragma unroll
          for (int c = 0; c < NF; ++c)
            h[b][c] = ok && valid[c] ? hs[c * 32 + lane] : 0.f;
        }
        switch (Dh) {  // the scores: B * NF independent shuffle sums
          case 1: batch_scores<NF, B, 1>(h, ed, as, cnt - i, e); break;
          case 2: batch_scores<NF, B, 2>(h, ed, as, cnt - i, e); break;
          case 4: batch_scores<NF, B, 4>(h, ed, as, cnt - i, e); break;
          case 8: batch_scores<NF, B, 8>(h, ed, as, cnt - i, e); break;
          case 16: batch_scores<NF, B, 16>(h, ed, as, cnt - i, e); break;
          default: batch_scores<NF, B, 32>(h, ed, as, cnt - i, e); break;
        }
#pragma unroll
        for (int b = 0; b < B; ++b) {  // the online softmax, slot order
          if (i + b < cnt) {           // warp-uniform
#pragma unroll
            for (int c = 0; c < NF; ++c) {
              // m_new = max(m, e); of scale = exp(m - m_new) and pw =
              // exp(e - m_new) one is exp(0) = 1 exactly and the other
              // exp(-|e - m|): one exp, the same bits as both
              const float d = e[b][c] - m[c];
              const float t = expf(-fabsf(d));
              const bool up = d > 0.f;
              const float m_new = up ? e[b][c] : m[c];
              const float scale = up ? t : 1.f;
              const float pw = up ? 1.f : t;
              den[c] = den[c] * scale + pw;
              acc[c] = acc[c] * scale + pw * h[b][c];
              m[c] = m_new;
            }
          }
        }
      }
      __syncwarp();  // my_idx is rewritten by the next 32 slots
    }
#pragma unroll
    for (int c = 0; c < NF; ++c) {
      float o = acc[c] / fmaxf(den[c], 1e-9f);
      if (FUSED) o = o > 0.f ? o : expm1f(o);
      if (valid[c]) {
        out[(size_t)r_id * HD + c * 32 + lane] = o;
        if (FUSED) z_w[(c * 32 + lane) * kGroupRows + rows] = o;
      }
    }
    if constexpr (FUSED) {
#pragma unroll
      for (int r = 0; r < kGroupRows; ++r)
        if (r == rows) rid[r] = r_id;
      if (++rows == kGroupRows) {
        __syncwarp();
        epilogue(z_w, w_s, ldw, HD, Hs, bias, q, rid, rows, score, lane);
        __syncwarp();  // z_w is rewritten by the next rows
        rows = 0;
      }
    }
  }
  if constexpr (FUSED) {
    if (rows > 0) {  // the last, partial tile: its missing rows are 0
      for (int f = lane; f < HD; f += 32)
        for (int r = rows; r < kGroupRows; ++r) z_w[f * kGroupRows + r] = 0.f;
      __syncwarp();
      epilogue(z_w, w_s, ldw, HD, Hs, bias, q, rid, rows, score, lane);
    }
  }
}

// w[s] = (sum of score[s, :]) / N: rows in blocks of kRowsPerBlock summed
// in order, block b added to lane b % 32 in order, then the 32 lane sums by
// an xor butterfly.  Launched as a programmatic dependent of the main
// kernel: it starts early and waits on the device for the scores.
__global__ void __launch_bounds__(kSumThreads)
sum_scores_kernel(const float* __restrict__ score, int N,
                  float* __restrict__ w) {
  __shared__ float part[kSumThreads];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int s = blockIdx.x;
  const float* sc = score + (size_t)s * N;
  const int n_blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  float t = 0.f;  // lane sums, in warp 0
  for (int base = 0; base < n_blocks; base += kSumThreads) {
    const int b = base + threadIdx.x;
    float v[kRowsPerBlock];  // the block's rows, loaded together
#pragma unroll
    for (int r = 0; r < kRowsPerBlock; ++r) {
      const int row = b * kRowsPerBlock + r;
      v[r] = b < n_blocks && row < N ? sc[row] : 0.f;
    }
    float p = 0.f;
#pragma unroll
    for (int r = 0; r < kRowsPerBlock; ++r) p = __fadd_rn(p, v[r]);
    part[threadIdx.x] = p;
    __syncthreads();
    if (threadIdx.x < 32)
      for (int i = threadIdx.x; i < kSumThreads && base + i < n_blocks;
           i += 32)
        t = __fadd_rn(t, part[i]);
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    t = group_sum<32>(t);
    if (threadIdx.x == 0) w[s] = t / (float)N;
  }
}

template <int NF, bool FUSED>
cudaError_t launch_one(size_t smem, cudaStream_t st, const float* h_dst,
                       const float* h_src, const int* nbr, const float* mask,
                       const float* a_dst, const float* a_src, const float* W,
                       const float* b, const float* q, float* out,
                       float* score, int* work, int S, int N, int K, int HD,
                       int Dh, int Hs) {
  auto kernel = gat_na_kernel<NF, FUSED>;
  constexpr int kWarps = warps_of(NF);
  constexpr int kThreads = 32 * kWarps;
  // this instantiation's shared-memory size and the blocks an SM holds at
  // it, asked of the runtime only when the size changes
  static size_t set_smem = 0;
  static int per_sm = 0;
  static int n_sm = 0;
  if (smem != set_smem) {
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int dev = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // the refusal is returned, not left pending
      set_smem = 0;
      return err;
    }
    set_smem = smem;
  }
  // the blocks the card holds at once, no more than the rows need
  const long long rows = (long long)S * N;
  const int blocks = (int)std::max<long long>(
      1, std::min<long long>((long long)std::max(per_sm, 1) * n_sm,
                             (rows + kWarps - 1) / kWarps));
  kernel<<<blocks, kThreads, smem, st>>>(h_dst, h_src, nbr, mask, a_dst,
                                         a_src, W, b, q, out, score, work, S,
                                         N, K, HD, Dh, Hs);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gat_na_rows_per_block() { return kRowsPerBlock; }

extern "C" int gat_na_max_features() { return kMaxChunks * 32; }

extern "C" long long gat_na_smem_bytes(int fused, int HD, int Hs) {
  return (long long)smem_bytes(fused != 0, HD, Hs);
}

// Launch on `stream`.  W, b, q, score and w are null unless fused; score
// holds S * N floats, work one int that is 0 before the launch (the kernel
// leaves it at 0 again).  Returns the cudaError_t of the launches (0 on
// success): the error of cudaFuncSetAttribute where the epilogue's shared
// memory (see smem_bytes) does not fit a block.
extern "C" int gat_na_launch(const float* h_dst, const float* h_src,
                             const int* nbr, const float* mask,
                             const float* a_dst, const float* a_src,
                             const float* W, const float* b, const float* q,
                             float* out, float* score, float* w, int* work,
                             int S, int N, int K, int H, int Dh, int Hs,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int HD = H * Dh;
  const int nf = (HD + 31) / 32;
  const bool fused = W != nullptr;
  const size_t smem = smem_bytes(fused, HD, fused ? Hs : 0);
  cudaError_t err;
  switch (nf) {
#define GAT_NA_CASE(NFV)                                                    \
  case NFV:                                                                 \
    err = fused ? launch_one<NFV, true>(smem, st, h_dst, h_src, nbr, mask,  \
                                        a_dst, a_src, W, b, q, out, score,  \
                                        work, S, N, K, HD, Dh, Hs)          \
                : launch_one<NFV, false>(smem, st, h_dst, h_src, nbr, mask, \
                                         a_dst, a_src, W, b, q, out, score, \
                                         work, S, N, K, HD, Dh, 0);         \
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
  if (fused) {  // may start while the main kernel runs (see the kernel)
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(S);
    cfg.blockDim = dim3(kSumThreads);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, sum_scores_kernel, (const float*)score, N,
                             w);
  }
  return (int)err;
}
