// Hot-row feature-cache gather for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/feature_cache.py::cached_gather
// (:34, body _kernel :26).  Same contract:
//
//   out[r, c, :] = pool[idx[r, c], :],  pool = concat(table [N, D], cache [C, D])
//
// where the cache section holds bitwise copies of the hot rows (the wrapper
// fills it with table.index_select(0, hot), a plain gather outside the
// kernel, as the reference's fill at feature_cache.py:44 is).
//
// Design.  The TPU kernel keeps the [C, D] cache block in VMEM across index
// tiles, serves only the indices >= N in its body, and merges the cold rows
// from a plain gather with a `where` outside it, so the output is written
// three times.  Here one kernel does the whole function: a group of 16
// lanes owns one index, reads the row from the cache section when
// idx >= N and from the table otherwise, and writes the output row once
// (16 lanes x float4 = one 64-wide row, so a warp serves two indices).  The
// cache section is contiguous and small (64 KB at C = 256, D = 64), so it
// stays in the 50 MB L2 after its first touch: that is the counterpart of
// the VMEM residency.  The index may be a strided view (one position of
// MAGNN's [N, I, L] instance table has a column stride of L): the kernel
// takes the row and column strides, so the wrapper copies nothing.
//
// Whatever the index, the kernel reads only inside the table or the cache:
// a cache slot is clamped to [0, C-1] as the Pallas body clamps it
// (feature_cache.py:29), and a table row to [0, N-1].
//
// The operation moves data and computes nothing, so the result is bitwise
// equal to the plain version.  What bounds it on an H100: bytes.  It must
// write the output once (17.5 MB for one MAGNN/imdb instance position),
// read the indices once and at most the table once; about 19 MB, 5.7 us at
// 3.35 TB/s.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 16;  // threads per index
constexpr int kThreads = 256;
constexpr int kPerBlock = kThreads / kLanes;

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
cached_gather_kernel(const float* __restrict__ table,
                     const float* __restrict__ cache,
                     const int* __restrict__ idx, float* __restrict__ out,
                     int N, int C, int D, long long cols, long long stride_r,
                     long long stride_c, long long total) {
  const long long i = (long long)blockIdx.x * kPerBlock + threadIdx.x / kLanes;
  if (i >= total) return;
  const int lane = threadIdx.x % kLanes;
  const long long r = i / cols;
  const long long c = i - r * cols;
  const int v = idx[r * stride_r + c * stride_c];
  const float* src = v >= N ? cache + (size_t)min(v - N, C - 1) * D
                            : table + (size_t)max(v, 0) * D;
  float* dst = out + (size_t)i * D;
  if (VEC) {  // D % 4 == 0 and every base 16-byte aligned
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int k = lane; k < D / 4; k += kLanes) d4[k] = s4[k];
  } else {
    for (int k = lane; k < D; k += kLanes) dst[k] = src[k];
  }
}

}  // namespace

// table [N, D], cache [C, D], out [rows * cols, D]: contiguous fp32 on the
// device; idx int32 with element strides (stride_r, stride_c).  vec != 0
// asks for 16-byte copies (the caller checks D % 4 == 0 and alignment).
// Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int cached_gather_launch(const float* table, const float* cache,
                                    const int* idx, float* out, int N, int C,
                                    int D, long long rows, long long cols,
                                    long long stride_r, long long stride_c,
                                    int vec, void* stream) {
  const long long total = rows * cols;
  if (total == 0 || N <= 0 || C <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (total + kPerBlock - 1) / kPerBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    cached_gather_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(
        table, cache, idx, out, N, C, D, cols, stride_r, stride_c, total);
  } else {
    cached_gather_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(
        table, cache, idx, out, N, C, D, cols, stride_r, stride_c, total);
  }
  return (int)cudaGetLastError();
}
