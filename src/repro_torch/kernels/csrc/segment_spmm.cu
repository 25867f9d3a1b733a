// Padded-neighbour sum/mean aggregation for Hopper (sm_90a):
//
//   out[n, :] = sum_{k < K} mask[n, k] * h_src[nbr[n, k], :]
//   out[n, :] /= max(sum_k mask[n, k], 1)                      (mean only)
//
// Replaces the TPU kernel src/repro/kernels/segment_spmm.py::segment_spmm
// (:93; _accumulate :31, _mean :44, bodies _kernel :52 / _stream_kernel
// :60).  The TPU kernel walks the K slots of a [block_n, K] tile in order,
// acc = acc + row * mask, over a resident or chunk-streamed source table.
//
// Design.  One warp owns one destination row and one group of 64 columns
// (lane l holds columns g*64 + l and g*64 + 32 + l; grid.y walks the
// groups, so any D works).  The warp reads 32 mask values at a time and
// takes a ballot of the nonzero ones, so a dead slot costs one load and
// never touches h_src.  Live slots are taken lowest first, which is slot
// order j = 0..K-1, in batches of kBatch: their rows are loaded together
// (the loads are independent, and the batch has no branch, so they are in
// flight at once) and then accumulated one by one in slot order, each
// product and sum rounded on its own (__fmul_rn / __fadd_rn, no FMA
// contraction) as the TPU tile does.  Skipping a slot whose mask is 0
// gives the same bits as adding row * 0 for a finite row, since the
// accumulator starts at +0, never becomes -0, and x + (+-0) == x.  The degree is summed in
// the same slot order, and the mean is one IEEE division.  No atomics: a
// row is reduced by one warp, in one order, on every run.
//
// The TPU's resident / streaming split (an 8 MB VMEM budget) and its chunk
// schedule have no counterpart: every warp reads the source table through
// the 50 MB L2 (RGCN/imdb tables are 0.5-1.3 MB).
//
// What bounds it on an H100: bytes.  mask (4 bytes a slot) is read once,
// nbr only at the live slots, the source rows that live slots name once,
// out written once; per live slot 2*D operations.  On RGCN/imdb 3% of the
// 64 slots are live, so the mask stream is most of the bytes.  The gathers are dependent
// loads (index, then row), so the design keeps kBatch rows in flight per
// warp and many warps per SM (8 warps a block, no shared memory).
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 8;
constexpr int kCols = 64;  // columns a warp owns: two per lane
// live slots whose rows are loaded together: a row at the 64-slot cap
// costs 64 / kBatch dependent rounds, and its warp sets the kernel's time
// (RGCN/imdb has such rows); a larger batch costs registers, and so blocks
// resident per SM
constexpr int kBatch = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
segment_spmm_kernel(const float* __restrict__ h_src,
                    const int* __restrict__ nbr,
                    const float* __restrict__ mask, float* __restrict__ out,
                    int N, int K, int D, int mean) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;  // warp-uniform
  const int c0 = blockIdx.y * kCols + lane;
  const int c1 = c0 + 32;
  const bool v0 = c0 < D, v1 = c1 < D;
  const int* nb = nbr + (size_t)n * K;
  const float* mk = mask + (size_t)n * K;
  float a0 = 0.f, a1 = 0.f, deg = 0.f;
  for (int base = 0; base < K; base += 32) {
    const int j = base + lane;
    const float m_l = j < K ? mk[j] : 0.f;
    const int idx_l = m_l != 0.f ? nb[j] : 0;
    unsigned live = __ballot_sync(kFull, m_l != 0.f);
    while (live != 0u) {  // warp-uniform
      // Branch-free, so that all kBatch gathers issue before the first add
      // waits on one (with an `if` per slot the compiler may pair each
      // load with its add).  Past the last live slot m = 0 and the load is
      // predicated off, and adding 0 * 0 leaves the sums' bits unchanged.
      float m[kBatch], r0[kBatch], r1[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const bool ok = live != 0u;
        const int src = ok ? __ffs(live) - 1 : 0;  // lowest live slot first
        live &= live - 1u;
        const float m_b = __shfl_sync(kFull, m_l, src);
        const int idx = __shfl_sync(kFull, idx_l, src);
        const float* row = h_src + (size_t)idx * D;
        m[b] = ok ? m_b : 0.f;
        r0[b] = ok && v0 ? row[c0] : 0.f;
        r1[b] = ok && v1 ? row[c1] : 0.f;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {  // slot order
        deg = __fadd_rn(deg, m[b]);
        a0 = __fadd_rn(a0, __fmul_rn(r0[b], m[b]));
        a1 = __fadd_rn(a1, __fmul_rn(r1[b], m[b]));
      }
    }
  }
  if (mean) {
    const float d = fmaxf(deg, 1.f);
    a0 = __fdiv_rn(a0, d);
    a1 = __fdiv_rn(a1, d);
  }
  float* o = out + (size_t)n * D;
  if (v0) o[c0] = a0;
  if (v1) o[c1] = a1;
}

}  // namespace

// h_src [M, D], nbr [N, K] int32, mask [N, K], out [N, D]; fp32 on the
// device.  Live slots (mask != 0) must name rows in [0, M).  Launches on
// `stream` and returns the cudaError_t of the launch (0 on success).
extern "C" int segment_spmm_launch(const float* h_src, const int* nbr,
                                   const float* mask, float* out, int N,
                                   int K, int D, int mean, void* stream) {
  if (N == 0 || D == 0) return 0;
  const dim3 grid((N + kWarps - 1) / kWarps, (D + kCols - 1) / kCols);
  segment_spmm_kernel<<<grid, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      h_src, nbr, mask, out, N, K, D, mean);
  return (int)cudaGetLastError();
}
