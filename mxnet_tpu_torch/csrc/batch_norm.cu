// BatchNorm statistics for Hopper (sm_90a), fp32 and bf16.
//
// Replaces _stats_kernel of mxnet_tpu/ops/pallas/batch_norm.py (launched by
// _stats_pallas): per-channel sum and sum of squares, in fp32, of an (M, C)
// channel-last activation (the free [N*H*W, C] view of an NHWC tensor),
// read once.  On the TPU one program walked the row blocks in order and
// kept both sums resident in VMEM; here blocks run in parallel on the SMs
// and the last block to finish adds their partial sums, in one launch.
//
// Bound on an H100 SXM: the kernel reads M*C elements once and does 3
// operations on each, so it is bound by bytes: at ResNet-50's first stage
// (M = 401,408 = 128*56*56, C = 64) 51 MB in bf16, about 15 us at
// 3.35 TB/s.  What the design does about it:
//
//   - 16-byte loads along C.  A block owns a strip of 64 channels of a
//     contiguous run of rows; its 512 threads are (row groups) x (64/VEC
//     threads along the strip), VEC = 8 bf16 or 4 fp32 channels a thread,
//     so a warp reads whole 128-byte lines (4 rows x 128 B in bf16, 2 x
//     256 B in fp32).  A thread keeps 8 to 16 independent rows in flight
//     (two sets of 8: the next set loads while the last one is added, 64-128
//     KB a block) and its VEC sums and sums of squares in registers.
//   - Where C is not a multiple of VEC or x is not 16-byte aligned, the
//     same kernel runs with VEC = 1 (a thread a channel, one element a
//     load): the scalar route, for shapes off ResNet's path.
//   - The grid is sized from the card (ops/kernels/batch_norm.py:
//     row_blocks): P row blocks x ceil(C/64) strips, no more blocks than
//     the SMs hold at once (one an SM at 82-128 registers a thread), so
//     the partials the last block adds stay few (P <= 132 on an H100).
//   - One launch.  Each block adds its row groups in a fixed order (a
//     warp's by a butterfly of shuffles, then the warps in order), writes
//     one partial (sum, sumsq) per channel of its strip, and takes a ticket
//     (an integer atomicAdd after __threadfence) on its strip's counter; the
//     block that draws the last ticket adds the strip's P partials in a
//     fixed order (16 contiguous runs of partials, read as float4 with up
//     to 16 loads in flight a thread, then the 16 runs) and resets the
//     counter to 0 for the next launch.  The counters live in a
//     small per-device buffer the wrapper keeps, so a captured CUDA graph
//     replays the launch as it is.  Launches on one device must not run
//     concurrently on two streams: they would share the counters.
//   - No float atomics: the sums depend only on (M, C, P, VEC) and the
//     data, bit-identical from run to run.  Squares are __fmul_rn, never
//     contracted into an FMA, so a float32 model of the order reproduces
//     the kernel bit for bit (tests/test_torch_conv_fused.py).
//
// Built by nvcc into a C-ABI shared library (mxnet_tpu_torch/ops/kernels/
// build.py) and bound with ctypes.  The launch goes on the caller's stream
// on the device it names; the function returns cudaGetLastError() after it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;  // threads a block
constexpr int kStrip = 64;     // channels a block owns
constexpr int kUnroll = 8;     // rows in flight a thread
// the last block: runs of partials it adds apart (a thread for 4 channels
// of a run), and loads in flight a thread
constexpr int kTailRuns = kThreads / (2 * (kStrip / 4));
constexpr int kTailLoads = 16;

// Loads VEC channels of one row and widens them to fp32.
template <typename T, int VEC>
struct Row;

template <>
struct Row<float, 4> {
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ static void widen(const Raw& r, float* f) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
};

template <>
struct Row<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  // little-endian: channel 2k is the low half of word k; a bf16 is the
  // high 16 bits of the fp32 of the same value
  __device__ __forceinline__ static void widen(const Raw& r, float* f) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};

template <typename T>
struct Row<T, 1> {
  using Raw = T;
  __device__ __forceinline__ static Raw load(const T* p) { return __ldg(p); }
  __device__ __forceinline__ static void widen(const Raw& r, float* f) {
    if constexpr (sizeof(T) == 2) {
      f[0] = __bfloat162float(r);
    } else {
      f[0] = r;
    }
  }
};

// Adds the VEC channels of row r (when r < m1) to s and q.
template <typename T, int VEC>
__device__ __forceinline__ void add_row(const typename Row<T, VEC>::Raw& raw,
                                        long long r, long long m1, float* s,
                                        float* q) {
  if (r < m1) {
    float f[VEC];
    Row<T, VEC>::widen(raw, f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      s[j] += f[j];
      q[j] += __fmul_rn(f[j], f[j]);
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void load_rows(typename Row<T, VEC>::Raw* raw,
                                          const T* base, long long m,
                                          long long m1, int C, int stride) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long r = m + (long long)u * stride;
    if (r < m1) raw[u] = Row<T, VEC>::load(base + r * C);
  }
}

// out: the partials (strips, 2, P, kStrip) -- P sums of each channel of a
// strip, then P sums of squares -- then sum[C] and sumsq[C].  rows: rows
// a block (the last may have fewer).  Grid (P, strips).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const T* __restrict__ x, float* __restrict__ out,
                    unsigned* __restrict__ tickets, long long M, int C,
                    long long rows) {
  constexpr int TW = kStrip / VEC;   // threads along the strip
  constexpr int RG = kThreads / TW;  // row groups
  constexpr int GPW = TW < 32 ? 32 / TW : 1;  // row groups a warp
  constexpr int E = RG / GPW;        // a channel's entries after the warps
  constexpr int STEP = RG * kUnroll;
  static_assert(E <= kTailRuns, "red holds the entries and the tail's runs");
  __shared__ float red[2][kTailRuns][kStrip];
  __shared__ unsigned ticket;

  const int tv = threadIdx.x % TW;
  const int tr = threadIdx.x / TW;
  const long long P = gridDim.x;
  const long long p = blockIdx.x;
  const int strip = blockIdx.y;
  const int c0 = strip * kStrip;
  const int width = min(kStrip, C - c0);
  const long long m0 = p * rows;
  const long long m1 = min(M, m0 + rows);
  float* part = out + (long long)strip * 2 * P * kStrip;

  float s[VEC], q[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
  if (tv * VEC < width) {
    // rows m0 + tr, m0 + tr + RG, ... in order; two sets of kUnroll loads,
    // the next set in flight while the last one is added
    const T* base = x + c0 + tv * VEC;
    typename Row<T, VEC>::Raw a[kUnroll], b[kUnroll];
    long long m = m0 + tr;
    load_rows<T, VEC>(a, base, m, m1, C, RG);
    while (m < m1) {
      load_rows<T, VEC>(b, base, m + STEP, m1, C, RG);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        add_row<T, VEC>(a[u], m + (long long)u * RG, m1, s, q);
      m += STEP;
      if (m >= m1) break;
      load_rows<T, VEC>(a, base, m + STEP, m1, C, RG);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        add_row<T, VEC>(b[u], m + (long long)u * RG, m1, s, q);
      m += STEP;
    }
  }
  // the block's partial: a warp's GPW row groups by a butterfly of
  // shuffles (((g0 + g1) + (g2 + g3)) for 4), then its E entries in order
#pragma unroll
  for (int off = TW; off < 32; off *= 2) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
      q[j] += __shfl_xor_sync(0xffffffffu, q[j], off);
    }
  }
  if (tr % GPW == 0) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      red[0][tr / GPW][tv * VEC + j] = s[j];
      red[1][tr / GPW][tv * VEC + j] = q[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * kStrip) {
    const int which = threadIdx.x / kStrip;
    const int c = threadIdx.x % kStrip;
    float a = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) a += red[which][e][c];
    part[(which * P + p) * kStrip + c] = a;
    __threadfence();  // the partial is visible to every block before the ticket
  }
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(&tickets[strip], 1u);
  __syncthreads();
  if (ticket != (unsigned)(P - 1)) return;

  // the strip's last block: its P partials in kTailRuns contiguous runs,
  // each in order, then the runs in order; a thread a run of 4 channels
  if (threadIdx.x == 0) tickets[strip] = 0u;  // ready for the next launch
  __threadfence();
  {
    const int which = threadIdx.x / (kThreads / 2);
    const int g = threadIdx.x % (kThreads / 2) / (kStrip / 4);
    const int c = threadIdx.x % (kStrip / 4) * 4;
    const long long per = (P + kTailRuns - 1) / kTailRuns;
    const long long p0 = min(P, g * per);
    const long long p1 = min(P, p0 + per);
    const float4* src =
        reinterpret_cast<const float4*>(part + which * P * kStrip + c);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long i0 = p0; i0 < p1; i0 += kTailLoads) {
      float4 v[kTailLoads];
#pragma unroll
      for (int k = 0; k < kTailLoads; ++k)
        if (i0 + k < p1) v[k] = __ldcg(src + (i0 + k) * (kStrip / 4));
#pragma unroll
      for (int k = 0; k < kTailLoads; ++k) {
        if (i0 + k < p1) {
          a.x += v[k].x;
          a.y += v[k].y;
          a.z += v[k].z;
          a.w += v[k].w;
        }
      }
    }
    red[which][g][c] = a.x;
    red[which][g][c + 1] = a.y;
    red[which][g][c + 2] = a.z;
    red[which][g][c + 3] = a.w;
  }
  __syncthreads();
  if (threadIdx.x < 2 * kStrip) {
    const int which = threadIdx.x / kStrip;
    const int c = threadIdx.x % kStrip;
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < kTailRuns; ++g) a += red[which][g][c];
    const long long sums = (long long)gridDim.y * 2 * P * kStrip;
    if (c < width) out[sums + which * C + c0 + c] = a;
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, float* out, unsigned* tickets, long long M,
                   int C, long long P, cudaStream_t stream) {
  const long long rows = (M + P - 1) / P;
  const dim3 grid((unsigned)P, (unsigned)((C + kStrip - 1) / kStrip));
  bn_stats_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), out, tickets, M, C, rows);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t occupancy(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, bn_stats_kernel<T, VEC>, kThreads, 0);
}

// Makes `device` current for the scope and restores the caller's.
struct DeviceScope {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      prev = cur;
    }
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

bool valid(long long M, int C, int dtype) {
  return M >= 0 && C >= 1 && (dtype == 0 || dtype == 1) &&
         (C + kStrip - 1) / kStrip <= 65535;
}

}  // namespace

// Resident blocks an SM of the kernel for (dtype, vec) on `device`, from
// the occupancy calculator.  dtype: 0 = float32, 1 = bfloat16; vec: 1 for
// 16-byte loads, 0 for the scalar route.  Returns a cudaError_t.
extern "C" int mxtt_bn_stats_occupancy(int dtype, int vec, int device,
                                       int* blocks) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  if (dtype == 0)
    return (int)(vec ? occupancy<float, 4>(blocks)
                     : occupancy<float, 1>(blocks));
  if (dtype == 1)
    return (int)(vec ? occupancy<__nv_bfloat16, 8>(blocks)
                     : occupancy<__nv_bfloat16, 1>(blocks));
  return (int)cudaErrorInvalidValue;
}

// x: a contiguous (M, C) tensor, 16-byte aligned with C a multiple of 8
// (bf16) or 4 (fp32) where vec = 1.  out: 16-byte aligned, S*2*P*64 + 2*C
// fp32, S = ceil(C / 64) (the partials, then sum and sumsq).  tickets: S
// zeroed counters, left zeroed.
// 1 <= P < 2^31.  Returns a cudaError_t.
extern "C" int mxtt_bn_stats(const void* x, float* out, unsigned* tickets,
                             long long M, int C, long long P, int dtype,
                             int vec, int device, void* stream) {
  if (!valid(M, C, dtype) || P < 1 || P > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(vec ? launch<float, 4>(x, out, tickets, M, C, P, st)
                     : launch<float, 1>(x, out, tickets, M, C, P, st));
  return (int)(vec ? launch<__nv_bfloat16, 8>(x, out, tickets, M, C, P, st)
                   : launch<__nv_bfloat16, 1>(x, out, tickets, M, C, P, st));
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
