// Hot-row feature-cache gather for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/feature_cache.py::cached_gather
// (:34, body _kernel :26).  Same contract:
//
//   out[r, c, :] = pool[idx[r, c], :],  pool = concat(table [N, D], table[hot])
//
// The TPU kernel keeps the [C, D] cache block resident in VMEM across the
// index tiles (feature_cache.py:51-62), serves the indices >= N in its body
// and merges the cold rows from a plain gather with a `where` outside it.
// On this card the 50 MB L2 is that residency: the hot rows are rows of
// `table` that many indices name, so they stay in L2 after their first
// touch, and a copied cache section would hold nothing that L2 does not
// already hold.  So there is no cache section and no fill: an index v >= N
// reads table[hot[v - N]], an index v < N reads table[v].  The cache rows
// were bitwise copies of those table rows, so the output is bitwise
// concat(table, table[hot])[idx].  Whatever the index, the kernel reads
// only inside the table: a cache slot is clamped to [0, C-1] as the Pallas
// body clamps it (feature_cache.py:29), a hot id and a table row to
// [0, N-1].
//
// What bounds it on an H100: bytes.  The operation moves data and computes
// nothing.  It must write the output once (17.5 MB for one MAGNN/imdb
// instance position), read the indices once, the hot ids once and at most
// the table once; about 19 MB, 5.7 us at 3.35 TB/s.
//
// Design.  A group of kLanes lanes serves one index with 16-byte copies
// (16 float4s are one 64-wide row; wider rows loop), and every thread
// carries kUnroll indices at once: their hot ids, then all their row
// loads, then the stores, so a thread keeps kUnroll x 16 bytes of gathers
// in flight.  The grid is persistent (at most kBlocksPerSM blocks an SM)
// and strides over tiles of kGroups x kUnroll indices, and a thread loads
// its next tile's indices before this tile's row loads, so the index round
// trip of one tile hides under the copies of the one before.  In a tile
// the groups take consecutive indices, so each round of stores writes
// kGroups whole output rows in order.  The output is written once and read
// by the next stage: it goes out by streaming stores (st.global.cs, evict
// first), which an H100 ran faster than plain stores; 2 and 8 indices a
// thread and 4 blocks an SM ran slower (scripts/torch_kernel_variants.py),
// and a copy of the hot ids in shared memory gained nothing.  The index
// may be a strided view (one position of MAGNN's [N, I, L] instance table
// has a column stride of L), and so may `hot`: the kernel takes their
// strides, so the wrapper copies nothing.  D % 4 != 0 or a base off 16
// bytes takes 4-byte copies with the same schedule.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 16;  // threads an index
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kLanes;  // indices a round of a block
constexpr int kUnroll = 4;                  // indices a thread carries
constexpr int kTile = kGroups * kUnroll;
constexpr int kBlocksPerSM = 8;

// this thread's kUnroll indices of a tile (positions i, values v)
__device__ __forceinline__ void load_indices(
    const int* __restrict__ idx, long long tile, int grp, long long cols,
    long long stride_r, long long stride_c, long long total,
    long long (&i)[kUnroll], int (&v)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    i[u] = tile * kTile + u * kGroups + grp;
    const long long r = i[u] / cols;
    v[u] = i[u] < total
               ? __ldg(idx + r * stride_r + (i[u] - r * cols) * stride_c)
               : 0;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
cached_gather_kernel(const float* __restrict__ table,
                     const int* __restrict__ hot,
                     const int* __restrict__ idx, float* __restrict__ out,
                     int N, int C, int D, long long stride_h, long long cols,
                     long long stride_r, long long stride_c,
                     long long total) {
  const int lane = threadIdx.x % kLanes;
  const int grp = threadIdx.x / kLanes;
  const long long n_tiles = (total + kTile - 1) / kTile;
  long long i[kUnroll];
  int v[kUnroll];
  long long tile = blockIdx.x;
  load_indices(idx, tile, grp, cols, stride_r, stride_c, total, i, v);
  for (; tile < n_tiles; tile += gridDim.x) {
    long long at[kUnroll];
    int row[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // the table rows
      at[u] = i[u];
      row[u] = v[u] >= N
                   ? min(max(__ldg(hot + min(v[u] - N, C - 1) * stride_h), 0),
                         N - 1)
                   : max(v[u], 0);
    }
    // the next tile's indices go in flight under this tile's copies
    if (tile + gridDim.x < n_tiles)
      load_indices(idx, tile + gridDim.x, grp, cols, stride_r, stride_c,
                   total, i, v);
    if (VEC) {  // D % 4 == 0, table and out 16-byte aligned
      for (int k = lane; k < D / 4; k += kLanes) {
        float4 x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          x[u] = __ldg(reinterpret_cast<const float4*>(table +
                                                       (size_t)row[u] * D) +
                       k);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (at[u] < total)
            __stcs(reinterpret_cast<float4*>(out + (size_t)at[u] * D) + k,
                   x[u]);
      }
    } else {
      for (int k = lane; k < D; k += kLanes) {
        float x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          x[u] = __ldg(table + (size_t)row[u] * D + k);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (at[u] < total) __stcs(out + (size_t)at[u] * D + k, x[u]);
      }
    }
  }
}

}  // namespace

// table [N, D] and out [rows * cols, D]: contiguous fp32 on the device;
// hot [C] int32 with element stride stride_h; idx int32 with element
// strides (stride_r, stride_c).  The copies are 16 bytes where D % 4 == 0
// and table and out are 16-byte aligned, else 4.  Launches on `stream` and
// returns the cudaError_t of the launch.  The SM count that sizes the
// persistent grid is read once, at the first launch.
extern "C" int cached_gather_launch(const float* table, const int* hot,
                                    const int* idx, float* out, int N, int C,
                                    int D, long long stride_h,
                                    long long rows, long long cols,
                                    long long stride_r, long long stride_c,
                                    void* stream) {
  const long long total = rows * cols;
  if (total == 0 || N <= 0 || C <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  const long long tiles = (total + kTile - 1) / kTile;
  const long long cap = (long long)sms * kBlocksPerSM;
  const unsigned blocks = (unsigned)(tiles < cap ? tiles : cap);
  const bool vec = D % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    cached_gather_kernel<true><<<blocks, kThreads, 0, st>>>(
        table, hot, idx, out, N, C, D, stride_h, cols, stride_r, stride_c,
        total);
  else
    cached_gather_kernel<false><<<blocks, kThreads, 0, st>>>(
        table, hot, idx, out, N, C, D, stride_h, cols, stride_r, stride_c,
        total);
  return (int)cudaGetLastError();
}
