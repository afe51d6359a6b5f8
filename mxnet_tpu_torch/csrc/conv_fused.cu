// Fused 1x1-convolution kernels for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the three Pallas kernels of mxnet_tpu/ops/pallas/conv_fused.py:
//   _mm_stats_kernel          y = x @ w, plus per-column sum and sum of
//                             squares of the stored y    (kind 0)
//   _bn_act_mm_kernel         y = act(x*scale + shift) @ w      (kind 1)
//   _bn_act_mm_stats_kernel   both at once                      (kind 2)
// with x (M, K) and y (M, N) in x's dtype, scale and shift (K,) fp32, and
// the weight given as wt = w^T, (N, K) contiguous: a 1x1 convolution's
// OHWI weight reshaped to (Cout, Cin) is exactly that, so no copy is made.
// On NHWC activations a 1x1 convolution is this matrix product, and the
// fusions keep the BatchNorm passes around it out of device memory: the
// prologue applies the previous layer's folded BN (and ReLU) to each input
// tile as it is loaded, the epilogue sums the output tile's columns while
// it is still on chip.
//
// Arithmetic, as the TPU kernels define it:
//   - the prologue computes x.f32*scale + shift (a multiply then an add,
//     never contracted to an FMA, as PyTorch's plain version computes
//     it), then max(., 0) under RELU, and rounds the result to x's dtype
//     before the product (conv_fused.py:235-239);
//   - products accumulate in fp32 and y is stored in x's dtype;
//   - the statistics are of the stored, rounded y (conv_fused.py:135-141),
//     summed in fp32.
//
// Design.  One templated tiled GEMM, <T, PROLOGUE, RELU, STATS>.  A block
// of 256 threads owns a 64 x 64 output tile and walks K in steps of 32:
// each step loads a 64 x 32 tile of x (through the prologue) and of wt into
// shared memory, 8 elements a thread with neighbouring threads on
// neighbouring k.  bf16 multiplies on the tensor cores with WMMA 16x16x16
// fragments (mma.sync underneath), each of the 8 warps owning two output
// fragments; fp32 multiplies on the CUDA cores, each thread a 4 x 4
// register tile.  The fp32 tile then goes through shared memory to the
// epilogue, which rounds it to T, stores it (64 consecutive columns per
// row, coalesced) and, under STATS, sums each column over the tile's rows
// and writes one partial (sum, sumsq) per (row tile, column) to a
// (2, ceil(M/64), N) scratch tensor; stats_reduce_kernel (stats_reduce.cuh)
// then adds the partials in a fixed order.  No float atomics: the
// statistics are bit-identical from run to run.  Ragged M, N and K are
// masked (out-of-range elements load as 0 after the prologue).
//
// Bound on an H100 SXM: at ResNet-50's first stage in bf16 (M = 401,408,
// K = 64, N = 256) kind 2 moves 51 MB in and 205 MB out against 13.2 GFLOP,
// so it is bound by bytes (about 77 us at 3.35 TB/s); in fp32 on the CUDA
// cores it is bound by operations (about 197 us at 67 TFLOP/s).  This first
// version has no cp.async/TMA pipeline and no wgmma, so it cannot reach
// either bound; those are later work.
//
// Built by nvcc into a C-ABI shared library (mxnet_tpu_torch/ops/kernels/
// build.py) and bound with ctypes.  Launches go on the caller's stream; the
// function returns cudaGetLastError() after them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "stats_reduce.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 32;       // k per step
constexpr int NT = 256;      // threads per block
constexpr int LDC = BN + 4;  // row stride of the fp32 output tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

template <typename T, bool PROLOGUE, bool RELU, bool STATS>
__global__ void __launch_bounds__(NT)
    fused_mm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ shift, const T* __restrict__ wt,
                    T* __restrict__ y, float* __restrict__ part, long long M,
                    int K, int N) {
  // row stride of the shared x and wt tiles: fp32 pads by one so the
  // strided column reads of the register tiles hit distinct banks; bf16
  // pads by 8 elements (16 bytes), the multiple WMMA's loads require
  constexpr int LD = std::is_same<T, float>::value ? BK + 1 : BK + 8;
  __shared__ __align__(32) T As[BM * LD];
  __shared__ __align__(32) T Bs[BN * LD];
  __shared__ __align__(32) float Cs[BM * LDC];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int lk = tid % BK;  // loader: this thread's k within the step
  const int lr = tid / BK;  // loader: rows lr, lr + 8, ..., lr + 56

  // fp32: a 4 x 4 register tile at rows ty + 16 i, columns tx + 16 j
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
  // bf16: warp w owns fragment row w / 2 and fragment columns
  // 2 (w % 2) and 2 (w % 2) + 1 of the 4 x 4 fragments of the tile
  const int warp = tid / 32;
  const int fr = warp / 2, fc = (warp % 2) * 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> cfrag[2];
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  } else {
    wmma::fill_fragment(cfrag[0], 0.f);
    wmma::fill_fragment(cfrag[1], 0.f);
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int k = k0 + lk;
    float sc = 1.f, sh = 0.f;
    if (PROLOGUE && k < K) {
      sc = scale[k];
      sh = shift[k];
    }
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      const int r = lr + 8 * i;
      const long long m = m0 + r;
      float v = 0.f;
      if (m < M && k < K) {
        v = to_f(x[m * K + k]);
        if (PROLOGUE) {
          v = __fadd_rn(__fmul_rn(v, sc), sh);
          if (RELU) v = fmaxf(v, 0.f);
        }
      }
      As[r * LD + lk] = from_f<T>(v);
      const int n = n0 + r;
      Bs[r * LD + lk] = (n < N && k < K) ? wt[(long long)n * K + k]
                                         : from_f<T>(0.f);
    }
    __syncthreads();
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * LD + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * LD + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            afrag;
        wmma::load_matrix_sync(afrag, As + (fr * 16) * LD + kk, LD);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // wt's tile is stored n-major with k contiguous: w column-major
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major>
              bfrag;
          wmma::load_matrix_sync(bfrag, Bs + ((fc + j) * 16) * LD + kk, LD);
          wmma::mma_sync(cfrag[j], afrag, bfrag, cfrag[j]);
        }
      }
    }
    __syncthreads();
  }

  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Cs[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (fr * 16) * LDC + (fc + j) * 16, cfrag[j],
                              LDC, wmma::mem_row_major);
  }
  __syncthreads();

  // epilogue: thread (c, g) stores column c of rows 16 g .. 16 g + 15
  const int c = tid % BN;
  const int g = tid / BN;
  const int n = n0 + c;
  float s = 0.f, q = 0.f;
#pragma unroll 4
  for (int i = 0; i < BM / 4; ++i) {
    const int r = g * (BM / 4) + i;
    const long long m = m0 + r;
    if (m < M && n < N) {
      const T v = from_f<T>(Cs[r * LDC + c]);
      y[m * N + n] = v;
      if (STATS) {
        const float f = to_f(v);
        s += f;
        q += f * f;
      }
    }
  }
  if (STATS) {
    __syncthreads();  // every thread has read Cs: reuse it for the sums
    float* red = Cs;
    red[g * BN + c] = s;
    red[(4 + g) * BN + c] = q;
    __syncthreads();
    if (g == 0 && n < N) {
      for (int i = 1; i < 4; ++i) {
        s += red[i * BN + c];
        q += red[(4 + i) * BN + c];
      }
      const long long tiles = gridDim.x;
      part[(long long)blockIdx.x * N + n] = s;
      part[(tiles + blockIdx.x) * N + n] = q;
    }
  }
}

template <typename T, bool PROLOGUE, bool RELU, bool STATS>
cudaError_t launch(const void* x, const float* scale, const float* shift,
                   const void* wt, void* y, float* part, float* sum,
                   float* sumsq, long long M, int K, int N,
                   cudaStream_t stream) {
  const long long tiles = (M + BM - 1) / BM;
  const dim3 grid((unsigned)tiles, (unsigned)((N + BN - 1) / BN));
  fused_mm_kernel<T, PROLOGUE, RELU, STATS><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), scale, shift, static_cast<const T*>(wt),
      static_cast<T*>(y), part, M, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !STATS) return err;
  return mxtt::launch_stats_reduce(part, sum, sumsq, (int)tiles, N, stream);
}

template <typename T>
cudaError_t dispatch(int kind, int relu, const void* x, const float* scale,
                     const float* shift, const void* wt, void* y, float* part,
                     float* sum, float* sumsq, long long M, int K, int N,
                     cudaStream_t s) {
  switch (kind * 2 + (relu ? 1 : 0)) {
    case 0:
      return launch<T, false, false, true>(x, scale, shift, wt, y, part, sum,
                                           sumsq, M, K, N, s);
    case 2:
      return launch<T, true, false, false>(x, scale, shift, wt, y, part, sum,
                                           sumsq, M, K, N, s);
    case 3:
      return launch<T, true, true, false>(x, scale, shift, wt, y, part, sum,
                                          sumsq, M, K, N, s);
    case 4:
      return launch<T, true, false, true>(x, scale, shift, wt, y, part, sum,
                                          sumsq, M, K, N, s);
    case 5:
      return launch<T, true, true, true>(x, scale, shift, wt, y, part, sum,
                                         sumsq, M, K, N, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// kind: 0 = matmul_bn_stats (relu must be 0), 1 = bn_act_matmul,
// 2 = bn_act_matmul_stats.  dtype: 0 = float32, 1 = bfloat16.  x (M, K),
// wt (N, K) and y (M, N) contiguous in that dtype; scale and shift (K,)
// fp32 (read by kinds 1 and 2); part a (2, ceil(M/64), N) fp32 scratch
// tensor and sum, sumsq (N,) fp32 outputs (kinds 0 and 2).  M/64 rounded
// up must fit a grid dimension and N/64 rounded up must be at most 65535.
// Returns a cudaError_t.
extern "C" int mxtt_conv_fused(int kind, int relu, const void* x,
                               const float* scale, const float* shift,
                               const void* wt, void* y, float* part,
                               float* sum, float* sumsq, long long M, int K,
                               int N, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || N < 1 || (N + BN - 1) / BN > 65535 ||
      (M + BM - 1) / BM > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch<float>(kind, relu, x, scale, shift, wt, y, part, sum,
                                sumsq, M, K, N, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(kind, relu, x, scale, shift, wt, y,
                                        part, sum, sumsq, M, K, N, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
