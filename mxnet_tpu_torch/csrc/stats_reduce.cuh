// Fixed-order reduction of per-channel partial sums, shared by the BN
// statistics kernel (batch_norm.cu) and the fused 1x1-conv kernels'
// statistics epilogue (conv_fused.cu).
//
// The first kernel of each writes partial sums to a (2, P, C) fp32 scratch
// tensor: P partial sums of each of C channels, then P partial sums of
// squares.  This kernel adds them up into sum[C] and sumsq[C].  Each block
// owns 32 channels; its 32 row groups each add a fixed contiguous run of
// partials in order, and group 0 then adds the 32 group results in order.
// No float atomics: the result depends only on (P, C) and the data, so the
// statistics come out bit-identical from run to run.
#pragma once

#include <cuda_runtime.h>

namespace mxtt {

constexpr int kReduceCols = 32;    // channels per block
constexpr int kReduceGroups = 32;  // row groups per channel

__global__ void __launch_bounds__(kReduceCols * kReduceGroups)
    stats_reduce_kernel(const float* __restrict__ part,
                        float* __restrict__ sum, float* __restrict__ sumsq,
                        int P, int C) {
  __shared__ float red[2][kReduceGroups][kReduceCols + 1];
  const int tc = threadIdx.x % kReduceCols;
  const int g = threadIdx.x / kReduceCols;
  const int c = blockIdx.x * kReduceCols + tc;
  float s = 0.f, q = 0.f;
  if (c < C) {
    const int per = (P + kReduceGroups - 1) / kReduceGroups;
    const int p0 = g * per;
    const int p1 = min(P, p0 + per);
    for (int p = p0; p < p1; ++p) {
      s += part[(long long)p * C + c];
      q += part[(long long)(P + p) * C + c];
    }
  }
  red[0][g][tc] = s;
  red[1][g][tc] = q;
  __syncthreads();
  if (g == 0 && c < C) {
    for (int i = 1; i < kReduceGroups; ++i) {
      s += red[0][i][tc];
      q += red[1][i][tc];
    }
    sum[c] = s;
    sumsq[c] = q;
  }
}

inline cudaError_t launch_stats_reduce(const float* part, float* sum,
                                       float* sumsq, int P, int C,
                                       cudaStream_t stream) {
  const unsigned blocks = (unsigned)((C + kReduceCols - 1) / kReduceCols);
  stats_reduce_kernel<<<blocks, kReduceCols * kReduceGroups, 0, stream>>>(
      part, sum, sumsq, P, C);
  return cudaGetLastError();
}

}  // namespace mxtt
