// Semantic Aggregation pass 2 for Hopper (sm_90a):
//   out[n, d] = sum_p beta[p] * z[p, n, d]      in fp32, p = 0..P-1 in order
//
// Replaces the TPU kernel src/repro/kernels/semantic_attn.py::
// semantic_combine (:153, body _combine_kernel :50).  On the TPU the
// kernel streams [P, block_n, D] tiles through VMEM; here each thread owns
// kPer vectors of the flat [N*D] output and walks the P stacked inputs in
// order, so z is read exactly once.  The products and sums are rounded one
// by one (__fmul_rn / __fadd_rn, no contraction into FMA), which is the
// arithmetic of the plain PyTorch version (kernels/ref.py::
// semantic_combine) step for step, so the output is its bits.
//
// What bounds it on an H100: bytes — P*N*D*4 read and N*D*4 written, two
// flops per element read.  At the main shape (P=2, N=4278, D=64) that is
// 3.3 MB, about 1 us at 3.35 TB/s, so the fixed cost of a launch
// dominates.  Design: a vector is a float4 where z and out are 16-byte
// aligned and N*D % 4 == 0, else a float (the launcher picks); a thread's
// kPer vectors of one input are loaded together, beta[p] is read once for
// them, and the grid is at most one wave of kBlocksPerSM blocks an SM,
// striding over the rest.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 2;  // vectors a thread
constexpr int kBlocksPerSM = 8;

__device__ __forceinline__ float mul(float b, float x) {
  return __fmul_rn(b, x);
}
__device__ __forceinline__ float4 mul(float b, float4 x) {
  return make_float4(__fmul_rn(b, x.x), __fmul_rn(b, x.y),
                     __fmul_rn(b, x.z), __fmul_rn(b, x.w));
}
__device__ __forceinline__ float add(float a, float x) {
  return __fadd_rn(a, x);
}
__device__ __forceinline__ float4 add(float4 a, float4 x) {
  return make_float4(__fadd_rn(a.x, x.x), __fadd_rn(a.y, x.y),
                     __fadd_rn(a.z, x.z), __fadd_rn(a.w, x.w));
}

// z [P, n] and out [n] as vectors of type V
template <typename V>
__global__ void __launch_bounds__(kThreads)
semantic_combine_kernel(const V* __restrict__ z,
                        const float* __restrict__ beta, V* __restrict__ out,
                        int P, long long n) {
  const long long stride = (long long)gridDim.x * kThreads * kPer;
  for (long long base = (long long)blockIdx.x * kThreads * kPer + threadIdx.x;
       base < n; base += stride) {
    V acc[kPer];
    const float b0 = __ldg(beta);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < n) acc[u] = mul(b0, __ldg(z + i));
    }
    for (int p = 1; p < P; ++p) {
      const float bp = __ldg(beta + p);
      const V* zp = z + (long long)p * n;
      V x[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {  // the loads together
        const long long i = base + (long long)u * kThreads;
        if (i < n) x[u] = __ldg(zp + i);
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        if (base + (long long)u * kThreads < n)
          acc[u] = add(acc[u], mul(bp, x[u]));
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < n) out[i] = acc[u];
    }
  }
}

}  // namespace

// z [P, N*D], beta [P], out [N*D], all fp32 on the device.  Launches on
// `stream` and returns the cudaError_t of the launch (0 on success).  The
// SM count that sizes the grid is read once, at the first launch.
extern "C" int semantic_combine_launch(const float* z, const float* beta,
                                       float* out, int P, long long nd,
                                       void* stream) {
  if (nd == 0) return 0;
  if (P <= 0 || nd < 0) return (int)cudaErrorInvalidValue;
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
  const bool vec = nd % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(z) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long n = vec ? nd / 4 : nd;
  const long long per_block = (long long)kThreads * kPer;
  const unsigned blocks = (unsigned)std::min<long long>(
      (n + per_block - 1) / per_block, (long long)sms * kBlocksPerSM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    semantic_combine_kernel<float4><<<blocks, kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(z), beta,
        reinterpret_cast<float4*>(out), P, n);
  else
    semantic_combine_kernel<float><<<blocks, kThreads, 0, st>>>(
        z, beta, out, P, n);
  return (int)cudaGetLastError();
}
