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
// Bound on an H100 SXM: at ResNet-50's first stage in bf16 (M = 401,408,
// K = 64, N = 256) kind 2 moves 51 MB in and 205 MB out against 13.2 GFLOP,
// so it is bound by bytes (about 77 us at 3.35 TB/s); so is kind 0 at
// K = 256, N = 64.  ResNet-50's last stage (M = 6,272, K and N up to 2,048)
// sits near the ridge, where the tensor cores' rate counts too.  In fp32
// kind 1 (ResNet-50's predict forward at b = 64: M = 200,704, K = 64,
// N = 256 at the first stage) moves 51 MB in and 205 MB out against 6.6
// GFLOP: on the CUDA cores bound by operations (98 us at 67 TFLOP/s), as
// 3xTF32 on the tensor cores (495/3 TFLOP/s, 40 us) bound by bytes (77 us).
//
// Three routes; the caller picks one (ops/kernels/conv_fused.py) and the
// entry refuses a route its operands do not allow.
//
// The TMA route, bf16 with K and N multiples of 8 and x, wt, y 16-byte
// aligned (what a TMA tensor map can address), is built for the bound:
//   - persistent blocks: the grid is (panels of BN columns) x P blocks,
//     P from the SM count; block b owns panel b % panels and walks the
//     128-row tiles b / panels, + P, + 2P, ...  BN is 128, or 64 for
//     N <= 64.  The blocks of one row tile have neighbouring indices, so
//     they run side by side and the later reads of an x tile hit L2;
//   - x arrives by TMA (128 rows x 64 k a copy, 128-byte swizzle) into a
//     ring of 2-8 slots in shared memory, filled by one thread of a
//     producer warpgroup (which gives its registers to the consumers with
//     setmaxnreg) and released by the consumers through full/empty
//     mbarriers.  The weight panel (BN x K) is loaded once per block when
//     it fits beside at least four slots, else streamed in the ring beside
//     each x chunk.  Ragged edges come from TMA's zero fill and clipped
//     stores;
//   - two consumer warpgroups of 128 threads each own 64 rows of a tile
//     and multiply on the tensor cores with wgmma (bf16 in, fp32
//     accumulators in registers).  Kind 0 reads A from shared memory by
//     descriptor.  Kinds 1 and 2 load A into registers with ldmatrix,
//     apply the prologue there (scale and shift staged in shared memory
//     once per block), round to bf16 and issue wgmma with A from
//     registers, two chunks per wait where K allows.  Each warpgroup
//     waits for its products before its next instruction: nvcc does not
//     keep the A registers of a wgmma in flight from being reused
//     (results went wrong when the next chunk's A was loaded under the
//     products), and keeping kind 0's products in flight made the
//     compiler insert the same wait;
//   - the epilogue rounds the accumulators to bf16 into a swizzled staging
//     tile (no fp32 round trip through shared memory) that TMA stores,
//     asynchronously, while the next tile's loads and products run.  Under
//     STATS each thread then sums one column pair over its rows of the
//     staged tile, adds each tile's sums into partials kept in registers
//     across all of the block's tiles, and the block writes one partial
//     per column, in a fixed order, to a (2, P, N) scratch tensor;
//     stats_reduce_kernel (stats_reduce.cuh) adds the P partials.  The
//     statistics are bit-identical from run to run: the assignment of
//     tiles to blocks depends only on (M, N, SM count), and no float
//     atomics are used.
//
// The TF32 route, fp32 kind 1 with K and N multiples of 8 and x, wt, y
// 16-byte aligned (every shape of ResNet-50's predict forward), runs its
// products on the tensor cores as 3xTF32 (tf32x3.cuh) with mma.sync:
// persistent blocks, two an SM, walk 64 x 128 tiles of y; x and wt
// arrive in chunks of 32 k by TMA (128-byte swizzle) into a four-slot
// ring that a producer warp keeps ahead across the block's tiles; each of
// four consumer warps applies the prologue to its A fragments in
// registers, splits A and B into TF32 hi and lo there, and stores its
// 32 x 64 of y from its accumulators.  See tf32_mm_kernel.
//
// The simple route takes everything else (fp32 kinds 0 and 2, ragged K or
// N, misaligned views): one templated tiled GEMM, <T, PROLOGUE, RELU,
// STATS>.  A block of 256 threads owns a 64 x 64 output tile and walks K
// in steps of 32: each step loads a 64 x 32 tile of x (through the
// prologue) and of wt into shared memory, 8 elements a thread with
// neighbouring threads on neighbouring k.  bf16 multiplies on the tensor cores with WMMA 16x16x16
// fragments (mma.sync underneath), each of the 8 warps owning two output
// fragments; fp32 multiplies on the CUDA cores, each thread a 4 x 4
// register tile.  The fp32 tile then goes through shared memory to the
// epilogue, which rounds it to T, stores it (64 consecutive columns per
// row, coalesced) and, under STATS, sums each column over the tile's rows
// and writes one partial (sum, sumsq) per (row tile, column) to a
// (2, ceil(M/64), N) scratch tensor, reduced as above.  Ragged M, N and K
// are masked (out-of-range elements load as 0 after the prologue).  It has
// no copy pipeline and loads one element a thread at a time.
//
// Built by nvcc into a C-ABI shared library (mxnet_tpu_torch/ops/kernels/
// build.py) and bound with ctypes.  Launches go on the caller's stream; the
// function returns cudaGetLastError() after them.  The TMA tensor maps are
// encoded on the host through the driver's entry point, found at run time
// (cudaGetDriverEntryPoint), so the library needs no -lcuda.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <algorithm>
#include <atomic>
#include <climits>
#include <type_traits>

#include "hopper.cuh"
#include "stats_reduce.cuh"
#include "tf32x3.cuh"

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

// -- the TMA route ----------------------------------------------------------

namespace tma {

using namespace mxtt::sm90;

constexpr int TM = 128;  // rows per tile: two consumer warpgroups of 64
constexpr int TK = 64;   // k per chunk: one 128-byte swizzled row of bf16
constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int PRODUCER_REGS = 40;         // registers a thread, by role:
constexpr int CONSUMER_REGS = 232;        // 128 x 40 + 256 x 232 <= 65536
constexpr int MAX_STAGES = 8;
constexpr int MIN_RESIDENT_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;    // dynamic shared memory of a block
constexpr int X_BYTES = TM * TK * 2;  // one chunk of an x tile
constexpr int ALIGN = 1024;           // a swizzle atom
constexpr int RED_BYTES = 4096;       // the final exchange of column sums
constexpr int BAR_BYTES = 256;        // 2 MAX_STAGES + 1 mbarriers

struct Plan {
  int bn;         // columns per panel: 64 or 128
  int panels;     // ceil(N / bn)
  int per_panel;  // P: blocks per panel, one statistics partial each
  int stages;     // ring slots
  int resident;   // 1: the weight panel is loaded once; 0: streamed
  int smem;       // dynamic shared memory, bytes
};

// The plan of an (M, K, N) call on a device with `sms` SMs; false where
// none fits.  It depends only on (M, K, N, sms).
bool make_plan(long long M, int K, int N, int sms, Plan* p) {
  if (M < 1 || M > INT_MAX - TM || K < 1 || N < 1 || sms < 1) return false;
  p->bn = N <= 64 ? 64 : 128;
  const long long chunks = (K + TK - 1) / TK;
  const long long w_chunk = (long long)p->bn * TK * 2;
  const long long staging = 2LL * 64 * p->bn * 2;
  const long long coef = chunks * TK * 8;  // the prologue's (scale, shift)
  const long long room =
      SMEM_LIMIT - ALIGN - RED_BYTES - BAR_BYTES - staging - coef;
  const long long panel = chunks * w_chunk;
  p->resident = panel + MIN_RESIDENT_STAGES * X_BYTES <= room;
  const long long stage = X_BYTES + (p->resident ? 0 : w_chunk);
  const long long slots = (room - (p->resident ? panel : 0)) / stage;
  if (slots < 2) return false;
  p->stages = (int)std::min<long long>(MAX_STAGES, slots);
  p->panels = (N + p->bn - 1) / p->bn;
  const long long tiles = (M + TM - 1) / TM;
  p->per_panel =
      (int)std::min<long long>(tiles, std::max(1, sms / p->panels));
  p->smem = (int)(ALIGN + RED_BYTES + BAR_BYTES + staging + coef +
                  (p->resident ? panel : 0) + p->stages * stage);
  return (long long)p->panels * p->per_panel <= INT_MAX;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the prologue on two bf16 values (k, k + 1) packed in one register
template <bool RELU>
__device__ __forceinline__ uint32_t bn_act2(uint32_t v, float sc0, float sc1,
                                            float sh0, float sh1) {
  float lo = __fadd_rn(__fmul_rn(__uint_as_float(v << 16), sc0), sh0);
  float hi = __fadd_rn(__fmul_rn(__uint_as_float(v & 0xffff0000u), sc1), sh1);
  if (RELU) {
    lo = fmaxf(lo, 0.f);
    hi = fmaxf(hi, 0.f);
  }
  return pack_bf16(lo, hi);
}

template <int BN>
__device__ __forceinline__ void mma_ss(float* d, uint64_t da, uint64_t db,
                                       int scale_d) {
  if constexpr (BN == 64)
    wgmma_ss_n64(d, da, db, scale_d);
  else
    wgmma_ss_n128(d, da, db, scale_d);
}

template <int BN>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a,
                                       uint64_t db, int scale_d) {
  if constexpr (BN == 64)
    wgmma_rs_n64(d, a, db, scale_d);
  else
    wgmma_rs_n128(d, a, db, scale_d);
}

// A (64 x 64 of k) of chunk `c` from the x slot `xs` into registers, in
// wgmma's fragment layout (a[s] the 16 x 16 tile of k 16 s ..), through the
// prologue and rounded to bf16.  coef[k / 2] holds (scale[k], scale[k + 1],
// shift[k], shift[k + 1]) for even k, zeros past K.
template <bool RELU>
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4],
                                       const unsigned char* xs, int c,
                                       const float4* coef, int wl, int lane) {
  const int mat = lane / 8, r8 = lane % 8;
  const uint32_t row = smem_addr(xs) + (wl * 16 + (mat % 2) * 8 + r8) * 128;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    ldmatrix_x4(a[s], row + (((2 * s + mat / 2) ^ r8) << 4));
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int k2 = (c * TK + 16 * s) / 2 + lane % 4;
    const float4 lo = coef[k2], hi = coef[k2 + 4];  // k and k + 8
    a[s][0] = bn_act2<RELU>(a[s][0], lo.x, lo.y, lo.z, lo.w);
    a[s][1] = bn_act2<RELU>(a[s][1], lo.x, lo.y, lo.z, lo.w);
    a[s][2] = bn_act2<RELU>(a[s][2], hi.x, hi.y, hi.z, hi.w);
    a[s][3] = bn_act2<RELU>(a[s][3], hi.x, hi.y, hi.z, hi.w);
  }
}

template <int BN, bool PROLOGUE, bool RELU, bool STATS>
__global__ void __launch_bounds__(THREADS, 1)
    tma_mm_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_w,
                  const __grid_constant__ CUtensorMap tm_y,
                  const float* __restrict__ scale,
                  const float* __restrict__ shift, float* __restrict__ part,
                  int M, int K, int N, int per_panel, int panels, int stages,
                  int resident) {
  constexpr int W_CHUNK = BN * TK * 2;     // one chunk of the weight panel
  constexpr int STAGING = 64 * BN * 2;     // a warpgroup's bf16 y tile
  constexpr int PAIRS = BN / 2;            // column pairs of a panel
  constexpr int GROUPS = 128 / PAIRS;      // row groups of the sums

  // shared memory: ring | weight panel | staging x 2 | sums | the
  // prologue's coefficients | barriers
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((ALIGN - (smem_addr(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  const int chunks = (K + TK - 1) / TK;
  const int stage_bytes = X_BYTES + (resident ? 0 : W_CHUNK);
  unsigned char* ring = base;
  unsigned char* wpanel = ring + stages * stage_bytes;
  unsigned char* staging = wpanel + (resident ? chunks * W_CHUNK : 0);
  float4* red = reinterpret_cast<float4*>(staging + 2 * STAGING);
  float4* coef = red + RED_BYTES / 16;
  uint64_t* full = reinterpret_cast<uint64_t*>(coef + chunks * TK / 2);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* wbar = empty + MAX_STAGES;

  const int panel = blockIdx.x % panels;
  const int first = blockIdx.x / panels;  // this block's partial
  const int n0 = panel * BN;
  const int tiles = (M + TM - 1) / TM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_init(wbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // the producer warpgroup: one lane issues
    regs_release<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      if (resident) {
        mbar_expect_tx(wbar, chunks * W_CHUNK);
        for (int c = 0; c < chunks; ++c)
          tma_load_2d(wpanel + c * W_CHUNK, &tm_w, wbar, c * TK, n0);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t = first; t < tiles; t += per_panel) {
        for (int c = 0; c < chunks; ++c) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* slot = ring + stage * stage_bytes;
          mbar_expect_tx(&full[stage], stage_bytes);
          tma_load_2d(slot, &tm_x, &full[stage], c * TK, t * TM);
          if (!resident)
            tma_load_2d(slot + X_BYTES, &tm_w, &full[stage], c * TK, n0);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile,
  // warp wl of it rows 16 wl .. 16 wl + 15 of those
  regs_claim<CONSUMER_REGS>();
  const int wg = warp / 4, wl = warp % 4, tid = threadIdx.x % 128;
  unsigned char* my_staging = staging + wg * STAGING;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // the sums: this thread's column pair and row group, over all its tiles
  const int pair = tid % PAIRS, group = tid / PAIRS;
  float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;

  if constexpr (PROLOGUE) {
    for (int i = threadIdx.x; i < chunks * TK / 2; i += CONSUMERS) {
      const int k = 2 * i;  // K is even
      coef[i] = k < K ? make_float4(scale[k], scale[k + 1], shift[k],
                                    shift[k + 1])
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    named_barrier(3, CONSUMERS);
  }
  if (resident) mbar_wait(wbar, 0);
  // one iteration per `per_wait` chunks of a tile, in the producer's
  // order: two for kinds 1 and 2 where the chunk count is even, so one
  // wait covers the prologue of both; each iteration waits for its
  // products before it releases its slots (the two warpgroups' turns
  // overlap instead).  fence_operand pins the accumulators' reads and
  // writes to the span between the waits.
  const int per_wait = PROLOGUE && chunks % 2 == 0 ? 2 : 1;
  const int iters =
      (tiles - first + per_panel - 1) / per_panel * (chunks / per_wait);
  int stage = 0, c = 0, t = first;
  uint32_t phase = 0;
  for (int it = 0; it < iters; ++it) {
    int stage1 = stage + 1;  // the second slot of a pair
    uint32_t phase1 = phase;
    if (stage1 == stages) {
      stage1 = 0;
      phase1 ^= 1;
    }
    const unsigned char* slot[2] = {ring + stage * stage_bytes,
                                    ring + stage1 * stage_bytes};
    uint64_t db[2];
#pragma unroll
    for (int g = 0; g < 2; ++g)
      db[g] = sw128_desc(resident ? wpanel + (c + g) * W_CHUNK
                                  : slot[g] + X_BYTES);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
    if constexpr (PROLOGUE) {
      uint32_t a[2][4][4];
      mbar_wait(&full[stage], phase);
      load_a<RELU>(a[0], slot[0] + wg * (64 * TK * 2), c, coef, wl, lane);
      if (per_wait == 2) {
        mbar_wait(&full[stage1], phase1);
        load_a<RELU>(a[1], slot[1] + wg * (64 * TK * 2), c + 1, coef, wl,
                     lane);
      }
      wgmma_fence();
#pragma unroll
      for (int g = 0; g < 2; ++g)
        if (g < per_wait) {
#pragma unroll
          for (int s = 0; s < 4; ++s)
            mma_rs<BN>(acc, a[g][s], db[g] + 2 * s, c + g > 0 || s > 0);
        }
    } else {  // one chunk an iteration
      mbar_wait(&full[stage], phase);
      wgmma_fence();
      const uint64_t da = sw128_desc(slot[0] + wg * (64 * TK * 2));
#pragma unroll
      for (int s = 0; s < 4; ++s)
        mma_ss<BN>(acc, da + 2 * s, db[0] + 2 * s, c > 0 || s > 0);
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
    if (lane == 0) {
      mbar_arrive(&empty[stage]);
      if (per_wait == 2) mbar_arrive(&empty[stage1]);
    }
    stage = per_wait == 2 ? stage1 : stage;
    phase = per_wait == 2 ? phase1 : phase;
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
    c += per_wait;
    if (c < chunks) continue;
    c = 0;

    // the tile's y: rounded to bf16 into the swizzled staging tile, which
    // TMA stores in boxes of 64 rows x 64 columns
    const int m0 = t * TM;
    t += per_panel;
    if (tid == 0) tma_store_wait_read();  // the last tile's stores read it
    named_barrier(1 + wg, 128);
    {
      const int r = wl * 16 + lane / 4;  // and r + 8; r % 8 == lane / 4
      unsigned char* row = my_staging + r * 128 + (lane % 4) * 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        unsigned char* p = row + (j / 8) * 8192 + (((j % 8) ^ (lane / 4)) << 4);
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(p + 8 * 128) =
            pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    fence_async_shared();
    named_barrier(1 + wg, 128);
    const int rows = min(64, M - m0 - 64 * wg);  // of this warpgroup
    if (tid == 0 && rows > 0) {
      for (int b = 0; b < BN / 64; ++b)
        if (n0 + 64 * b < N)
          tma_store_2d(&tm_y, my_staging + b * 8192, n0 + 64 * b,
                       m0 + 64 * wg);
      tma_store_commit();
    }
    if constexpr (STATS) {
      // the stored values of columns 2 pair, 2 pair + 1, rows group,
      // group + GROUPS, ... of the staging tile
      const int col = 2 * pair, chunk = (col % 64) / 8;
      const unsigned char* cb = my_staging + (col / 64) * 8192 + (col % 8) * 2;
      float ts0 = 0.f, ts1 = 0.f, tq0 = 0.f, tq1 = 0.f;
      for (int r = group; r < rows; r += GROUPS) {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(
            cb + r * 128 + ((chunk ^ (r % 8)) << 4));
        const float lo = __uint_as_float(v << 16);
        const float hi = __uint_as_float(v & 0xffff0000u);
        ts0 += lo;
        tq0 = fmaf(lo, lo, tq0);
        ts1 += hi;
        tq1 = fmaf(hi, hi, tq1);
      }
      s0 += ts0;
      s1 += ts1;
      q0 += tq0;
      q1 += tq1;
    }
  }
  if (tid == 0) tma_store_wait();

  if constexpr (STATS) {
    // the block's partial: both warpgroups' row groups, added in order
    red[(wg * GROUPS + group) * PAIRS + pair] = make_float4(s0, s1, q0, q1);
    named_barrier(3, CONSUMERS);
    if (wg == 0 && group == 0) {
      float4 tot = red[pair];
      for (int i = 1; i < 2 * GROUPS; ++i) {
        const float4 v = red[i * PAIRS + pair];
        tot.x += v.x;
        tot.y += v.y;
        tot.z += v.z;
        tot.w += v.w;
      }
      const int n = n0 + 2 * pair;  // N is even: n < N means n + 1 < N
      if (n < N) {
        part[(long long)first * N + n] = tot.x;
        part[(long long)first * N + n + 1] = tot.y;
        part[(long long)(per_panel + first) * N + n] = tot.z;
        part[(long long)(per_panel + first) * N + n + 1] = tot.w;
      }
    }
  }
}

// cuTensorMapEncodeTiled, from the driver at run time
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// a row-major (rows, cols) bf16 (or, with `fp32`, float32) matrix read or
// written in boxes of (box_rows, box_cols), box_cols elements = 128 bytes,
// with the 128-byte swizzle
bool encode(CUtensorMap* map, const void* ptr, long long rows, int cols,
            int box_rows, int box_cols, CUtensorMapL2promotion l2,
            bool fp32 = false) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * (fp32 ? 4 : 2)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return fn(map,
            fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(ptr), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, l2,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int MAX_DEVICES = 64;

// the current device, or -1
int current_device() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return -1;
  return dev;
}

// the current device's SM count, read once per device
int sm_count() {
  static std::atomic<int> cached[MAX_DEVICES];
  const int dev = current_device();
  if (dev < 0) return 0;
  int n = cached[dev].load();
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    cached[dev].store(n);
  }
  return n;
}

bool allowed(const void* x, const void* wt, const void* y, int dtype,
             long long M, int K, int N) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  return dtype == 1 && K % 8 == 0 && N % 8 == 0 && aligned(x) &&
         aligned(wt) && aligned(y);
}

template <int BN, bool PROLOGUE, bool RELU, bool STATS>
cudaError_t launch(const Plan& pl, const void* x, const float* scale,
                   const float* shift, const void* wt, void* y, float* part,
                   float* sum, float* sumsq, long long M, int K, int N,
                   cudaStream_t stream) {
  CUtensorMap tx, tw, ty;
  if (!encode(&tx, x, M, K, TM, TK, CU_TENSOR_MAP_L2_PROMOTION_L2_256B) ||
      !encode(&tw, wt, N, K, BN, TK, CU_TENSOR_MAP_L2_PROMOTION_L2_256B) ||
      !encode(&ty, y, M, N, 64, 64, CU_TENSOR_MAP_L2_PROMOTION_NONE))
    return cudaErrorInvalidValue;
  auto kernel = tma_mm_kernel<BN, PROLOGUE, RELU, STATS>;
  // every plan fits SMEM_LIMIT: allow that much once per device
  static std::atomic<unsigned long long> allowed_on{0};
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  cudaError_t err;
  if (!(allowed_on.load() >> dev & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    allowed_on.fetch_or(1ull << dev);
  }
  kernel<<<pl.panels * pl.per_panel, THREADS, pl.smem, stream>>>(
      tx, tw, ty, scale, shift, part, (int)M, K, N, pl.per_panel, pl.panels,
      pl.stages, pl.resident);
  err = cudaGetLastError();
  if (err != cudaSuccess || !STATS) return err;
  return mxtt::launch_stats_reduce(part, sum, sumsq, pl.per_panel, N, stream);
}

template <int BN>
cudaError_t dispatch_bn(const Plan& pl, int kind, int relu, const void* x,
                        const float* scale, const float* shift,
                        const void* wt, void* y, float* part, float* sum,
                        float* sumsq, long long M, int K, int N,
                        cudaStream_t s) {
  switch (kind * 2 + (relu ? 1 : 0)) {
    case 0:
      return launch<BN, false, false, true>(pl, x, scale, shift, wt, y, part,
                                            sum, sumsq, M, K, N, s);
    case 2:
      return launch<BN, true, false, false>(pl, x, scale, shift, wt, y, part,
                                            sum, sumsq, M, K, N, s);
    case 3:
      return launch<BN, true, true, false>(pl, x, scale, shift, wt, y, part,
                                           sum, sumsq, M, K, N, s);
    case 4:
      return launch<BN, true, false, true>(pl, x, scale, shift, wt, y, part,
                                           sum, sumsq, M, K, N, s);
    case 5:
      return launch<BN, true, true, true>(pl, x, scale, shift, wt, y, part,
                                          sum, sumsq, M, K, N, s);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int kind, int relu, const void* x, const float* scale,
                     const float* shift, const void* wt, void* y, float* part,
                     float* sum, float* sumsq, long long M, int K, int N,
                     cudaStream_t s) {
  Plan pl;
  if (!make_plan(M, K, N, sm_count(), &pl)) return cudaErrorInvalidValue;
  if (pl.bn == 64)
    return dispatch_bn<64>(pl, kind, relu, x, scale, shift, wt, y, part, sum,
                           sumsq, M, K, N, s);
  return dispatch_bn<128>(pl, kind, relu, x, scale, shift, wt, y, part, sum,
                          sumsq, M, K, N, s);
}

}  // namespace tma

// -- the TF32 route: fp32 bn_act_matmul on the tensor cores ------------------

namespace tf32 {

using namespace mxtt::sm90;
using mxtt::tf32x3::mma3;
using mxtt::tf32x3::split;

constexpr int TM = 64;   // rows of a tile
constexpr int TN = 128;  // columns of a tile
constexpr int TK = 32;   // k per chunk: one 128-byte swizzled row of fp32
constexpr int WARPS_M = 2, WARPS_N = 2;  // warp tiles of 32 x 64
constexpr int CONSUMERS = WARPS_M * WARPS_N;
constexpr int THREADS = 32 * (CONSUMERS + 1);  // and the producer warp
constexpr int PER_SM = 2;  // blocks an SM
constexpr int STAGES = 4;
constexpr int X_CHUNK = TM * TK;  // floats of one x chunk, 8 KB
constexpr int W_CHUNK = TN * TK;  // and of one wt chunk, 16 KB
constexpr int SLOT = X_CHUNK + W_CHUNK;
constexpr int ALIGN = 1024;  // a swizzle atom
constexpr int SMEM = ALIGN + STAGES * SLOT * 4 + 16 * STAGES;

// element (r, k) of a chunk as TMA leaves it with the 128-byte swizzle:
// rows of 32 floats whose 16-byte groups are permuted by group ^ (r % 8).
// The fragments' reads (8 rows g, 4 columns t) hit 32 distinct banks.
__device__ __forceinline__ float swizzled(const float* tile, int r, int k) {
  return tile[r * TK + ((((k >> 2) ^ (r & 7)) << 2) | (k & 3))];
}

template <bool RELU>
__device__ __forceinline__ float bn_act(float x, float sc, float sh) {
  const float a = __fadd_rn(__fmul_rn(x, sc), sh);
  return RELU ? fmaxf(a, 0.f) : a;
}

// The producer: the block's i-th chunk (its tile i / chunks, k
// chunk i % chunks) of x and wt into ring slot i % STAGES, completing on
// that slot's barrier.
__device__ __forceinline__ void issue_chunk(float* ring, uint64_t* full,
                                            const CUtensorMap* tm_x,
                                            const CUtensorMap* tm_w, int i,
                                            int chunks, int tiles_n) {
  const int tile = (int)blockIdx.x + (i / chunks) * (int)gridDim.x;
  const int c = i % chunks, stage = i % STAGES;
  float* xs = ring + stage * SLOT;
  mbar_expect_tx(&full[stage], SLOT * 4);
  tma_load_2d(xs, tm_x, &full[stage], c * TK, (tile / tiles_n) * TM);
  tma_load_2d(xs + X_CHUNK, tm_w, &full[stage], c * TK,
              (tile % tiles_n) * TN);
}

// Persistent blocks, two an SM (P in all): block b computes the 64 x 128
// tiles b, b + P, b + 2P, ... of y (tile i: row tile i / tiles_n, column
// tile i % tiles_n, so the blocks that read one x tile run side by side
// and the later reads hit L2).  The chunks of x and wt (tile rows x 32 k)
// arrive by TMA into a ring of STAGES slots in the order the block uses
// them, across its tiles, so the next tile's loads run under this tile's
// products and stores; a producer warp refills a slot once each consumer
// warp has arrived on its `empty` barrier, so the consumers never wait
// for one another.  64-row tiles keep the last round of tiles full where
// 128-row ones would not: at ResNet-50's fourth stage (M = 3,136, N =
// 2,048) 784 tiles fill 264 blocks three times, where 400 take four
// rounds of 132 (0.116 against 0.151 ms on an H100, PERF.md §6).  Four
// consumer warps own 32 x 64 of a tile each and multiply with
// mma.sync.m16n8k8 in 3xTF32: A is x through the prologue (scale and
// shift read per chunk from global memory, zeros past K), split in
// registers; B is wt as it is stored, split in registers.  Each lane
// stores its accumulators' column pairs straight to y.
template <bool RELU>
__global__ void __launch_bounds__(THREADS, PER_SM)
    tf32_mm_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift, float* __restrict__ y,
                   int M, int K, int N, int tiles_n, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((ALIGN - (smem_addr(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  float* ring = reinterpret_cast<float*>(base);  // slot: x chunk, wt chunk
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * SLOT);
  uint64_t* empty = full + STAGES;

  const int chunks = (K + TK - 1) / TK;
  const int mine = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                   (int)gridDim.x;
  const int total = mine * chunks;  // chunks this block multiplies
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = (warp / WARPS_N) * 32;  // this warp's rows of a tile
  const int wc = (warp % WARPS_N) * 64;  // and columns

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (warp == CONSUMERS) {  // the producer: one lane issues
    if (lane == 0) {
      for (int i = 0; i < total; ++i) {
        if (i >= STAGES)  // the slot's previous chunk has been read
          mbar_wait(&empty[i % STAGES], (i / STAGES - 1) & 1);
        issue_chunk(ring, full, &tm_x, &tm_w, i, chunks, tiles_n);
      }
    }
    return;
  }

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int i = 0; i < total; ++i) {
    const int stage = i % STAGES, c = i % chunks;
    // the prologue's coefficients of this lane's k: 8 s + t (+ 4)
    float sc[4][2], sh[4][2];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int k = c * TK + 8 * s + t + 4 * hf;
        sc[s][hf] = k < K ? scale[k] : 0.f;
        sh[s][hf] = k < K ? shift[k] : 0.f;
      }
    const float* xs = ring + stage * SLOT;
    const float* ws = xs + X_CHUNK;
    mbar_wait(&full[stage], (i / STAGES) & 1);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = 8 * s + t;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        const int r = wr + 16 * mb + g;
        split<true>(bn_act<RELU>(swizzled(xs, r, k), sc[s][0], sh[s][0]),
                    ah[mb][0], al[mb][0]);
        split<true>(bn_act<RELU>(swizzled(xs, r + 8, k), sc[s][0], sh[s][0]),
                    ah[mb][1], al[mb][1]);
        split<true>(bn_act<RELU>(swizzled(xs, r, k + 4), sc[s][1], sh[s][1]),
                    ah[mb][2], al[mb][2]);
        split<true>(
            bn_act<RELU>(swizzled(xs, r + 8, k + 4), sc[s][1], sh[s][1]),
            ah[mb][3], al[mb][3]);
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int n = wc + 8 * nb + g;
        uint32_t bh[2], bl[2];
        split<true>(swizzled(ws, n, k), bh[0], bl[0]);
        split<true>(swizzled(ws, n, k + 4), bh[1], bl[1]);
#pragma unroll
        for (int mb = 0; mb < 2; ++mb)
          mma3<true, true>(acc[mb][nb], ah[mb], al[mb], bh, bl);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with it
    if (c < chunks - 1) continue;

    // the tile's y: rows g, g + 8 and columns 2t, 2t + 1 of each fragment
    const int tile = (int)blockIdx.x + (i / chunks) * (int)gridDim.x;
    const int m0 = (tile / tiles_n) * TM + wr;
    const int n0 = (tile % tiles_n) * TN + wc + 2 * t;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = m0 + 16 * mb + g + 8 * hf;
        if (m >= M) continue;
        float* row = y + (long long)m * N;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int n = n0 + 8 * nb;  // N is even: n < N means n + 1 < N
          if (n < N)
            *reinterpret_cast<float2*>(row + n) =
                make_float2(acc[mb][nb][2 * hf], acc[mb][nb][2 * hf + 1]);
          acc[mb][nb][2 * hf] = acc[mb][nb][2 * hf + 1] = 0.f;
        }
      }
  }
}

// fp32 kind 1 with K and N multiples of 8 and x, wt, y 16-byte aligned
// (what the tensor maps and the pair stores address)
bool allowed(int kind, const void* x, const void* wt, const void* y,
             int dtype, long long M, int K, int N) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  return kind == 1 && dtype == 0 && K % 8 == 0 && N % 8 == 0 &&
         aligned(x) && aligned(wt) && aligned(y);
}

// whether an (M, K, N) call has a grid: its tiles fit an int
bool has_plan(long long M, int K, int N) {
  return M >= 1 && K >= 1 && N >= 1 &&
         ((M + TM - 1) / TM) * ((N + TN - 1) / TN) <= INT_MAX;
}

template <bool RELU>
cudaError_t launch(const void* x, const float* scale, const float* shift,
                   const void* wt, void* y, long long M, int K, int N,
                   cudaStream_t stream) {
  if (!has_plan(M, K, N) || M > INT_MAX) return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  if (!tma::encode(&tx, x, M, K, TM, TK, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   true) ||
      !tma::encode(&tw, wt, N, K, TN, TK,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, true))
    return cudaErrorInvalidValue;
  auto kernel = tf32_mm_kernel<RELU>;
  static std::atomic<unsigned long long> allowed_on{0};
  const int dev = tma::current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  cudaError_t err;
  if (!(allowed_on.load() >> dev & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    allowed_on.fetch_or(1ull << dev);
  }
  const int tiles_n = (N + TN - 1) / TN;
  const int tiles = (int)((M + TM - 1) / TM) * tiles_n;
  const int blocks = std::min(tiles, PER_SM * std::max(1, tma::sm_count()));
  kernel<<<blocks, THREADS, SMEM, stream>>>(
      tx, tw, scale, shift, static_cast<float*>(y), (int)M, K, N, tiles_n,
      tiles);
  return cudaGetLastError();
}

}  // namespace tf32

}  // namespace

constexpr int ROUTE_SIMPLE = 0, ROUTE_TMA = 1, ROUTE_TF32 = 2;

// The rows P of the (2, P, N) fp32 statistics scratch that a call of
// mxtt_conv_fused with this route and shape needs (on the current
// device, for the TMA route; 0 for the TF32 route, which takes no
// statistics), or -1 where the route has no plan.
extern "C" long long mxtt_conv_fused_partials(int route, long long M, int K,
                                              int N) {
  if (M < 1 || K < 1 || N < 1) return -1;
  if (route == ROUTE_SIMPLE) return (M + BM - 1) / BM;
  if (route == ROUTE_TF32) return tf32::has_plan(M, K, N) ? 0 : -1;
  tma::Plan pl;
  if (route == ROUTE_TMA && tma::make_plan(M, K, N, tma::sm_count(), &pl))
    return pl.per_panel;
  return -1;
}

// route: ROUTE_SIMPLE, ROUTE_TMA (bf16, K and N multiples of 8, x, wt
// and y 16-byte aligned; refused otherwise) or ROUTE_TF32 (kind 1 in
// fp32 with K and N multiples of 8 and x, wt, y 16-byte aligned; refused
// otherwise).  kind: 0 = matmul_bn_stats
// (relu must be 0), 1 = bn_act_matmul, 2 = bn_act_matmul_stats.  dtype:
// 0 = float32, 1 = bfloat16.  x (M, K), wt (N, K) and y (M, N) contiguous
// in that dtype; scale and shift (K,) fp32 (read by kinds 1 and 2); part a
// (2, P, N) fp32 scratch tensor, P from mxtt_conv_fused_partials, and sum,
// sumsq (N,) fp32 outputs (kinds 0 and 2).  Simple route: M/64 rounded
// up must fit a grid dimension and N/64 rounded up must be at most 65535.
// Returns a cudaError_t.
extern "C" int mxtt_conv_fused(int route, int kind, int relu, const void* x,
                               const float* scale, const float* shift,
                               const void* wt, void* y, float* part,
                               float* sum, float* sumsq, long long M, int K,
                               int N, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_TF32) {
    if (!tf32::allowed(kind, x, wt, y, dtype, M, K, N))
      return (int)cudaErrorInvalidValue;
    return relu ? (int)tf32::launch<true>(x, scale, shift, wt, y, M, K, N, st)
                : (int)tf32::launch<false>(x, scale, shift, wt, y, M, K, N,
                                           st);
  }
  if (route == ROUTE_TMA) {
    if (!tma::allowed(x, wt, y, dtype, M, K, N))
      return (int)cudaErrorInvalidValue;
    return (int)tma::dispatch(kind, relu, x, scale, shift, wt, y, part, sum,
                              sumsq, M, K, N, st);
  }
  if (route != ROUTE_SIMPLE || M < 1 || K < 1 || N < 1 ||
      (N + BN - 1) / BN > 65535 || (M + BM - 1) / BM > 2147483647LL)
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
