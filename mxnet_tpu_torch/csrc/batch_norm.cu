// BatchNorm statistics for Hopper (sm_90a), fp32 and bf16.
//
// Replaces _stats_kernel of mxnet_tpu/ops/pallas/batch_norm.py (launched by
// _stats_pallas): per-channel sum and sum of squares, in fp32, of an (M, C)
// channel-last activation (the free [N*H*W, C] view of an NHWC tensor),
// read once.  On the TPU one program walked the row blocks in order and
// kept both sums resident in VMEM; here blocks run in parallel, so the sum
// is taken in two launches:
//
//   1. stats_partial_kernel: a grid of (channel strips of 64) x (P row
//      slabs).  256 threads = 64 channels x 4 row groups; neighbouring
//      threads read neighbouring channels of one row, so loads coalesce
//      along C.  Each thread sums its rows in fp32, the 4 row groups are
//      added in a fixed order in shared memory, and the block writes one
//      partial (sum, sumsq) per channel to a (2, P, C) fp32 scratch tensor
//      that the caller allocates.
//   2. stats_reduce_kernel (stats_reduce.cuh): adds the P partials of each
//      channel in a fixed order.
//
// No float atomics, so the statistics are bit-identical from run to run.
//
// Bound on an H100 SXM: the kernel reads M*C elements once and does 3
// operations on each, so it is bound by bytes: at ResNet-50's first stage
// (M = 401,408 = 128*56*56, C = 64) 51 MB in bf16, about 15 us at
// 3.35 TB/s.  This first version reads 2 (bf16) or 4 (fp32) bytes per
// thread per load; vector loads along C are later work.
//
// Built by nvcc into a C-ABI shared library (mxnet_tpu_torch/ops/kernels/
// build.py) and bound with ctypes.  Both launches go on the caller's
// stream; the function returns cudaGetLastError() after them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "stats_reduce.cuh"

namespace {

constexpr int CT = 64;       // channels per block
constexpr int RG = 4;        // row groups per block
constexpr int NT = CT * RG;  // threads per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    stats_partial_kernel(const T* __restrict__ x, float* __restrict__ part,
                         long long M, int C, long long rows_per_slab) {
  __shared__ float red[2][RG][CT];
  const int tc = threadIdx.x % CT;
  const int tr = threadIdx.x / CT;
  const int c = blockIdx.x * CT + tc;
  const int slab = blockIdx.y;
  const long long m0 = (long long)slab * rows_per_slab;
  const long long m1 = min(M, m0 + rows_per_slab);
  float s = 0.f, q = 0.f;
  if (c < C) {
    for (long long m = m0 + tr; m < m1; m += RG) {
      const float v = to_f(x[m * C + c]);
      s += v;
      q += v * v;
    }
  }
  red[0][tr][tc] = s;
  red[1][tr][tc] = q;
  __syncthreads();
  if (tr == 0 && c < C) {
    for (int i = 1; i < RG; ++i) {
      s += red[0][i][tc];
      q += red[1][i][tc];
    }
    const int P = gridDim.y;
    part[(long long)slab * C + c] = s;
    part[(long long)(P + slab) * C + c] = q;
  }
}

template <typename T>
cudaError_t launch(const void* x, float* part, float* sum, float* sumsq,
                   long long M, int C, int slabs, cudaStream_t stream) {
  const long long rows = (M + slabs - 1) / slabs;
  const dim3 grid((unsigned)((C + CT - 1) / CT), (unsigned)slabs);
  stats_partial_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), part, M, C, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return mxtt::launch_stats_reduce(part, sum, sumsq, slabs, C, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x is a contiguous (M, C) tensor; part
// a (2, slabs, C) fp32 scratch tensor, 1 <= slabs <= 65535; sum and sumsq
// (C,) fp32 outputs.  Returns a cudaError_t.
extern "C" int mxtt_bn_stats(const void* x, float* part, float* sum,
                             float* sumsq, long long M, int C, int slabs,
                             int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C < 1 || slabs < 1 || slabs > 65535 || M < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(x, part, sum, sumsq, M, C, slabs, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, part, sum, sumsq, M, C, slabs, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
