// Semantic Aggregation pass 2 for Hopper (sm_90a):
//   out[n, d] = sum_p beta[p] * z[p, n, d]      in fp32, p = 0..P-1 in order
//
// Replaces the TPU kernel src/repro/kernels/semantic_attn.py::
// semantic_combine (:153, body _combine_kernel :50).  On the TPU the
// kernel streams [P, block_n, D] tiles through VMEM; here each thread owns
// one output element and walks the P stacked inputs in order, so z is read
// exactly once, and a warp's loads of one input are 128 contiguous bytes.
// The products and sums are rounded one by one (__fmul_rn / __fadd_rn, no
// contraction into FMA), which is the arithmetic of the plain PyTorch
// version (kernels/ref.py::semantic_combine) step for step.
//
// What bounds it on an H100: bytes — P*N*D*4 read and N*D*4 written, two
// flops per element read.  At the main shape (P=2, N=4278, D=64) that is
// 3.3 MB, about 1 us at 3.35 TB/s, so launch latency dominates; the
// design keeps one pass with coalesced accesses and nothing else.
#include <cuda_runtime.h>

namespace {

__global__ void combine_kernel(const float* __restrict__ z,
                               const float* __restrict__ beta,
                               float* __restrict__ out, int P, long long nd) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= nd) return;
  float acc = __fmul_rn(beta[0], z[i]);
  for (int p = 1; p < P; ++p)
    acc = __fadd_rn(acc, __fmul_rn(beta[p], z[p * nd + i]));
  out[i] = acc;
}

}  // namespace

// z [P, N*D], beta [P], out [N*D], all fp32 on the device.  Launches on
// `stream` and returns the cudaError_t of the launch (0 on success).
extern "C" int semantic_combine_launch(const float* z, const float* beta,
                                       float* out, int P, long long nd,
                                       void* stream) {
  if (nd == 0) return 0;
  const int threads = 256;
  const long long blocks = (nd + threads - 1) / threads;
  combine_kernel<<<(unsigned)blocks, threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(z, beta, out, P, nd);
  return (int)cudaGetLastError();
}
