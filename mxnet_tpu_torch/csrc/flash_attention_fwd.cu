// Flash-attention forward for Hopper (sm_90a), fp32 and bf16.
//
// Replaces the two forward Pallas kernels of mxnet_tpu/ops/pallas/
// flash_attention.py: _flash_fwd_kernel (K/V resident in VMEM, called
// through _flash_forward) and _flash_fwd_stream_kernel (K/V streamed on a
// grid axis, called through _flash_forward_stream).  Their split exists
// only because of the TPU's VMEM budget; here one kernel streams K/V
// tiles through shared memory and covers both.
//
// What it computes, for q (b,h,sq,d) and k, v (b,h,sk,d):
//   s    = (q*scale rounded to q's dtype) . k^T in fp32
//          + kmask[b, key]            (optional additive key-padding row)
//   keys with k_pos >= sk, or k_pos > q_pos under `causal`, are excluded
//   o    = softmax(s) . v, the probabilities rounded to v's dtype before
//          the product (as the TPU kernel's p.astype(v.dtype)), in q's
//          dtype
//   lse  = m + log(l), fp32, laid out (b*h, sq)
// with an online softmax whose running max starts at -1e9, and l clamped
// to 1e-30, as the TPU kernel does.  A row whose keys are all masked by
// kmask (-1e9) therefore returns the mean of V over its keys, not NaN.
//
// Design.  One thread block of 128 threads per (b*h, 64-row q tile).  The
// q tile is loaded once, pre-scaled; K and V are streamed in 64-key tiles
// through shared memory (converted to fp32 on load).  Each tile:
//   1. S = Q K^T, each thread an 8x4 register micro-tile;
//   2. online softmax, two threads per row, m/l/alpha kept per row;
//   3. O = alpha*O + P V, each thread an 8x(d/16) fp32 accumulator in
//      registers, kept across tiles.
// Row strides of the shared tiles are padded by one float so the strided
// reads of phases 1 and 3 hit distinct banks.  No mma/wgmma/TMA: fp32
// FMAs on the CUDA cores.  Shared memory is (192*(d+1) + 64*65 + 192)*4
// bytes, 67 KB at d=64 and 210 KB at d=256, so it is dynamic shared
// memory above the 48 KB default.
//
// Bound on an H100 SXM (see chip_smoke.py, which computes it per call):
// the work is 4*b*h*sq*sk*d operations and reads q, k, v, the mask and
// writes o, lse once.  At BERT-base shapes (b=8, h=12, s=512, d=64) that
// is 6.4 GFLOP against ~50 MB in fp32: operations bound, 96 us at the
// 67 TFLOP/s fp32 peak of the CUDA cores.  In bf16 the byte bound
// (~7.5 us) and the tensor-core bound (~6.5 us) are close, and this
// kernel, computing on the CUDA cores, cannot approach either; reaching
// them needs wgmma tiles and a TMA pipeline, which is later work.
//
// Built by nvcc into a C-ABI shared library (mxnet_tpu_torch/ops/kernels/
// build.py) and bound with ctypes.  The launch goes on the caller's
// stream; the function returns cudaGetLastError() after it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per streamed tile
constexpr int NT = 128;        // threads per block: a 16 x 8 grid
constexpr int LDS = BK + 1;    // padded row stride of the score tile
constexpr float kNegInf = -1e9f;   // the TPU kernel's _NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* kmask;
  void* o;
  float* lse;
  int b, h, sq, sk;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  float scale;
  int causal;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)((BQ + 2 * BK) * (D + 1) + BQ * LDS + 3 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ kmask,
                 T* __restrict__ o, float* __restrict__ lse, int h, int sq,
                 int sk, long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss, float scale,
                 int causal) {
  constexpr int LD = D + 1;     // padded row stride of the Q/K/V tiles
  constexpr int CN = D / 16;    // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][LD]
  float* Ks = Qs + BQ * LD;            // [BK][LD]
  float* Vs = Ks + BK * LD;            // [BK][LD]
  float* Ss = Vs + BK * LD;            // [BQ][LDS]
  float* row_m = Ss + BQ * LDS;        // [BQ] running max
  float* row_l = row_m + BQ;           // [BQ] running sum
  float* row_alpha = row_l + BQ;       // [BQ] this tile's rescale factor

  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const T* qb = q + bi * q_sb + hi * q_sh;
  const T* kb = k + bi * k_sb + hi * k_sh;
  const T* vb = v + bi * v_sb + hi * v_sh;
  const float* km = kmask ? kmask + (long long)bi * sk : nullptr;

  // q tile, scaled in q's precision (the TPU kernel's q_ref[0] * scale)
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D;
    const int c = i - r * D;
    float x = 0.f;
    if (q0 + r < sq) x = round_to<T>(to_f(qb[(q0 + r) * q_ss + c]) * scale);
    Qs[r * LD + c] = x;
  }
  if (tid < BQ) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }

  float acc[8][CN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

  int n_kt = (sk + BK - 1) / BK;
  if (causal) {
    // tiles wholly above the diagonal of this q tile contribute nothing
    const int last_q = min(q0 + BQ, sq) - 1;
    n_kt = min(n_kt, last_q / BK + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D;
      const int c = i - r * D;
      float kx = 0.f, vx = 0.f;  // keys past sk: zeros, and excluded below
      if (k0 + r < sk) {
        kx = to_f(kb[(k0 + r) * k_ss + c]);
        vx = to_f(vb[(k0 + r) * v_ss + c]);
      }
      Ks[r * LD + c] = kx;
      Vs[r * LD + c] = vx;
    }
    __syncthreads();

    // 1. scores: rows ty + 8i, keys tx + 16j
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = Qs[(ty + 8 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        const int kpos = k0 + kc;
        const bool live = kpos < sk && (!causal || q0 + r >= kpos);
        float x = s[i][j];
        if (km != nullptr && kpos < sk) x += km[kpos];
        Ss[r * LDS + kc] = live ? x : -INFINITY;
      }
    }
    __syncthreads();

    // 2. online softmax: threads 2r and 2r+1 share row r
    {
      const int r = tid >> 1;
      const int half = tid & 1;
      float mx = -INFINITY;
      for (int j = half; j < BK; j += 2) mx = fmaxf(mx, Ss[r * LDS + j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = half; j < BK; j += 2) {
        const float p = expf(Ss[r * LDS + j] - m_new);  // excluded: exp(-inf)=0
        sum += p;
        Ss[r * LDS + j] = round_to<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (half == 0) {
        const float alpha = expf(m_prev - m_new);
        row_alpha[r] = alpha;
        row_m[r] = m_new;
        row_l[r] = alpha * row_l[r] + sum;
      }
    }
    __syncthreads();

    // 3. O = alpha*O + P V: rows ty + 8i, columns tx + 16j
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = row_alpha[ty + 8 * i];
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[8], vv[CN];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = Ss[(ty + 8 * i) * LDS + kk];
#pragma unroll
      for (int j = 0; j < CN; ++j) vv[j] = Vs[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    if (q0 + r < sq) {
      const float l = fmaxf(row_l[r], 1e-30f);
      T* orow = o + ((long long)bh * sq + q0 + r) * D;
#pragma unroll
      for (int j = 0; j < CN; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / l);
    }
  }
  if (tid < BQ && q0 + tid < sq) {
    lse[(long long)bh * sq + q0 + tid] =
        row_m[tid] + logf(fmaxf(row_l[tid], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.b * a.h), (unsigned)((a.sq + BQ - 1) / BQ));
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.kmask, static_cast<T*>(a.o), a.lse, a.h,
      a.sq, a.sk, a.q_sb, a.q_sh, a.q_ss, a.k_sb, a.k_sh, a.k_ss, a.v_sb,
      a.v_sh, a.v_ss, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(int d, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 192: return launch<T, 192>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head
// dim must be contiguous.  kmask is a (b, sk) fp32 row or null.  o is a
// contiguous (b,h,sq,d) tensor of q's dtype, lse a contiguous (b*h, sq)
// fp32 tensor.  Returns a cudaError_t.
extern "C" int mxtt_flash_attention_fwd(
    const void* q, const void* k, const void* v, const float* kmask, void* o,
    float* lse, int b, int h, int sq, int sk, int d, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    float scale, int causal, int dtype, void* stream) {
  const Args a{q,    k,    v,    kmask, o,    lse,  b,    h,     sq,
               sk,   q_sb, q_sh, q_ss,  k_sb, k_sh, k_ss, v_sb,  v_sh,
               v_ss, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_head_dim<float>(d, a, st);
  if (dtype == 1) return (int)dispatch_head_dim<__nv_bfloat16>(d, a, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
