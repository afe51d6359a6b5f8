// Flash-attention backward for Hopper (sm_90a), fp32 and bf16: a dQ kernel
// and a dK/dV kernel.
//
// Replaces the four backward Pallas kernels of mxnet_tpu/ops/pallas/
// flash_attention.py: _flash_dq_kernel and _flash_dkv_kernel (K/V or Q/dO
// resident in VMEM, called through _flash_backward) and their streamed
// forms _flash_dq_stream_kernel and _flash_dkv_stream_kernel (called
// through _flash_backward_stream).  Their split exists only because of
// the TPU's VMEM budget; here the dQ kernel streams K/V tiles and the
// dK/dV kernel streams Q/dO tiles through shared memory, which covers
// both forms.
//
// What they compute, for q, do (b,h,sq,d), k, v (b,h,sk,d), the forward's
// lse and delta = rowsum(dO * O) (both fp32, laid out (b*h, sq)):
//   s    = scale * (q . k^T) in fp32 + kmask[b, key] (optional additive
//          key-padding row)
//   p    = exp(s - lse); keys with k_pos >= sk, or k_pos > q_pos under
//          `causal`, have p = 0, excluded outright as the forward
//          excludes them
//   dp   = dO . v^T,  ds = p * (dp - delta)
//   dq   = scale * ds . k,  dk = scale * ds^T . q,  dv = p^T . dO
// every operand converted to fp32 and p never rounded to bf16, as the TPU
// kernels do; outputs in the input dtype.  A row whose keys are all
// masked by kmask (-1e9) has lse = -1e9 in fp32, so p = 1 for each of its
// keys and its gradients are non-zero, as the TPU kernels give them.
//
// Design.  128 threads per block, a 16 x 8 thread grid, fp32 FMAs on the
// CUDA cores (no mma/wgmma/TMA).
//   dQ:   one block per (b*h, BQ-row q tile).  Q, dO, lse and delta of
//         the tile are loaded once; K and V are streamed in BK-key tiles.
//         Per tile: S and dP (each thread an RM x BK/16 micro-tile, both
//         from one pass over d), dS into shared memory, then dQ += dS K
//         with each thread an RM x d/16 fp32 accumulator in registers.
//         dQ is written once, scaled.
//   dK/dV: one block per (b*h, BKV-key tile).  K, V and the tile's mask
//         values are loaded once; Q, dO, lse and delta are streamed in
//         BQ-row tiles.  Per tile: S^T and dP^T, then P^T and dS^T into
//         shared memory, then dV += P^T dO and dK += dS^T Q in registers.
//         No atomics: each block owns its keys.
// Under `causal` the dQ kernel stops at the last key tile its rows see and
// the dK/dV kernel starts at the first q tile that sees its keys.  Row
// strides of the shared tiles are padded by one float so the strided reads
// hit distinct banks.  Tiles shrink at d >= 128 (BQ = 32 for dQ, BKV = BQ
// = 32 for dK/dV) to stay inside 227 KB of shared memory and 255
// registers: 84/108/157/206 KB (dQ) and 101/75/108/140 KB (dK/dV) at
// d = 64/128/192/256.
//
// Bound on an H100 SXM (chip_smoke.py computes it per call): dQ does
// 6*d and dK/dV 8*d operations per (query, key) pair the row attends to,
// and each reads q, k, v, dO, lse, delta and the mask once and writes its
// outputs once.  At the training shape (b=32, h=12, s=128, d=64, fp32,
// every key valid) that is 1.2 and 1.6 GFLOP against ~25 MB: operations
// bound, about 36 and 48 us at the 67 TFLOP/s fp32 peak of the CUDA cores.
//
// Built by nvcc into a C-ABI shared library (mxnet_tpu_torch/ops/kernels/
// build.py) and bound with ctypes.  Each launch goes on the caller's
// stream; each function returns cudaGetLastError() after it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;  // threads per block: a 16 x 8 grid

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

// A strided (b,h,s,d) head tensor with a contiguous last dim.
template <typename T>
struct Heads {
  const T* p;
  long long sb, sh, ss;
  __device__ __forceinline__ const T* row0(int bi, int hi) const {
    return p + bi * sb + hi * sh;
  }
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const float* kmask;
  void* out0;  // dq, or dk
  void* out1;  // dv
  int b, h, sq, sk;
  long long st[12];  // (sb, sh, ss) of q, k, v, dout
  float scale;
  int causal;
};

// rows [r0, r0 + R) of a (s, D) head slice into an fp32 tile with row
// stride LD; rows at or past `s` are zeros
template <typename T, int D, int R, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int r0, int s) {
  for (int i = threadIdx.x; i < R * D; i += NT) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * LD + c] = r0 + r < s ? to_f(src[(r0 + r) * ss + c]) : 0.f;
  }
}

template <int D, int BQ, int BK>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + 2 * BQ);
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(Heads<T> q, Heads<T> k, Heads<T> v, Heads<T> dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ kmask, T* __restrict__ dq,
                    int h, int sq, int sk, float scale, int causal) {
  constexpr int LD = D + 1;    // padded row stride of the Q/dO/K/V tiles
  constexpr int LDS = BK + 1;  // padded row stride of the dS tile
  constexpr int RM = BQ / 8;   // q rows per thread
  constexpr int KN = BK / 16;  // keys per thread in S and dP
  constexpr int CN = D / 16;   // dq columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // [BQ][LD]
  float* dOs = Qs + BQ * LD;      // [BQ][LD]
  float* Ks = dOs + BQ * LD;      // [BK][LD]
  float* Vs = Ks + BK * LD;       // [BK][LD]
  float* dSs = Vs + BK * LD;      // [BQ][LDS]
  float* row_lse = dSs + BQ * LDS;  // [BQ]
  float* row_delta = row_lse + BQ;  // [BQ]

  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const float* km = kmask ? kmask + (long long)bi * sk : nullptr;
  load_tile<T, D, BQ, LD>(Qs, q.row0(bi, hi), q.ss, q0, sq);
  load_tile<T, D, BQ, LD>(dOs, dout.row0(bi, hi), dout.ss, q0, sq);
  if (tid < BQ) {
    const bool in = q0 + tid < sq;
    row_lse[tid] = in ? lse[(long long)bh * sq + q0 + tid] : 0.f;
    row_delta[tid] = in ? delta[(long long)bh * sq + q0 + tid] : 0.f;
  }

  float acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

  int n_kt = (sk + BK - 1) / BK;
  if (causal) {
    // key tiles wholly after this q tile's last row contribute nothing
    const int last_q = min(q0 + BQ, sq) - 1;
    n_kt = min(n_kt, last_q / BK + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K and dS are consumed
    load_tile<T, D, BK, LD>(Ks, k.row0(bi, hi), k.ss, k0, sk);
    load_tile<T, D, BK, LD>(Vs, v.row0(bi, hi), v.ss, k0, sk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: rows ty + 8i, keys tx + 16j
    float s[RM][KN], dp[RM][KN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < KN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[RM], ov[RM], kv[KN], vv[KN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        qv[i] = Qs[(ty + 8 * i) * LD + c];
        ov[i] = dOs[(ty + 8 * i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        kv[j] = Ks[(tx + 16 * j) * LD + c];
        vv[j] = Vs[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < KN; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 8 * i;
#pragma unroll
      for (int j = 0; j < KN; ++j) {
        const int kc = tx + 16 * j;
        const int kpos = k0 + kc;
        float ds = 0.f;
        if (kpos < sk && (!causal || q0 + r >= kpos)) {
          float x = scale * s[i][j];
          if (km != nullptr) x += km[kpos];
          const float p = expf(x - row_lse[r]);
          ds = p * (dp[i][j] - row_delta[r]);
        }
        dSs[r * LDS + kc] = ds;
      }
    }
    __syncthreads();

    // dQ += dS K: rows ty + 8i, columns tx + 16j
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) dsv[i] = dSs[(ty + 8 * i) * LDS + kk];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = Ks[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 8 * i;
    if (q0 + r < sq) {
      T* out = dq + ((long long)bh * sq + q0 + r) * D;
#pragma unroll
      for (int j = 0; j < CN; ++j)
        out[tx + 16 * j] = from_f<T>(scale * acc[i][j]);
    }
  }
}

template <int D, int BKV, int BQ>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (size_t)(2 * BKV * (D + 1) + 2 * BQ * (D + 1) +
                                  2 * BKV * (BQ + 1) + 2 * BQ + BKV);
}

template <typename T, int D, int BKV, int BQ>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(Heads<T> q, Heads<T> k, Heads<T> v, Heads<T> dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ kmask, T* __restrict__ dk,
                     T* __restrict__ dv, int h, int sq, int sk, float scale,
                     int causal) {
  constexpr int LD = D + 1;    // padded row stride of the K/V/Q/dO tiles
  constexpr int LDP = BQ + 1;  // padded row stride of the P^T, dS^T tiles
  constexpr int RM = BKV / 8;  // keys per thread
  constexpr int QN = BQ / 16;  // queries per thread in S^T and dP^T
  constexpr int CN = D / 16;   // dk/dv columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                // [BKV][LD]
  float* Vs = Ks + BKV * LD;       // [BKV][LD]
  float* Qs = Vs + BKV * LD;       // [BQ][LD]
  float* dOs = Qs + BQ * LD;       // [BQ][LD]
  float* Ps = dOs + BQ * LD;       // [BKV][LDP] P^T
  float* dSs = Ps + BKV * LDP;     // [BKV][LDP] dS^T
  float* t_lse = dSs + BKV * LDP;  // [BQ]
  float* t_delta = t_lse + BQ;     // [BQ]
  float* t_km = t_delta + BQ;      // [BKV] this tile's mask values

  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int k0 = blockIdx.y * BKV;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  load_tile<T, D, BKV, LD>(Ks, k.row0(bi, hi), k.ss, k0, sk);
  load_tile<T, D, BKV, LD>(Vs, v.row0(bi, hi), v.ss, k0, sk);
  if (tid < BKV) {
    t_km[tid] = (kmask != nullptr && k0 + tid < sk)
                    ? kmask[(long long)bi * sk + k0 + tid]
                    : 0.f;
  }

  float acc_k[RM][CN], acc_v[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_qt = (sq + BQ - 1) / BQ;
  // q tiles whose rows all come before this key tile see none of it
  const int qt0 = causal ? k0 / BQ : 0;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's Q, dO, P^T and dS^T are consumed
    load_tile<T, D, BQ, LD>(Qs, q.row0(bi, hi), q.ss, q0, sq);
    load_tile<T, D, BQ, LD>(dOs, dout.row0(bi, hi), dout.ss, q0, sq);
    if (tid < BQ) {
      const bool in = q0 + tid < sq;
      t_lse[tid] = in ? lse[(long long)bh * sq + q0 + tid] : 0.f;
      t_delta[tid] = in ? delta[(long long)bh * sq + q0 + tid] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: keys ty + 8i, queries tx + 16j
    float s[RM][QN], dp[RM][QN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < QN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float kv[RM], vv[RM], qv[QN], ov[QN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        kv[i] = Ks[(ty + 8 * i) * LD + c];
        vv[i] = Vs[(ty + 8 * i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < QN; ++j) {
        qv[j] = Qs[(tx + 16 * j) * LD + c];
        ov[j] = dOs[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int kr = ty + 8 * i;
      const int kpos = k0 + kr;
#pragma unroll
      for (int j = 0; j < QN; ++j) {
        const int qc = tx + 16 * j;
        const int qpos = q0 + qc;
        float p = 0.f, ds = 0.f;
        if (kpos < sk && qpos < sq && (!causal || qpos >= kpos)) {
          const float x = scale * s[i][j] + t_km[kr];
          p = expf(x - t_lse[qc]);
          ds = p * (dp[i][j] - t_delta[qc]);
        }
        Ps[kr * LDP + qc] = p;
        dSs[kr * LDP + qc] = ds;
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: keys ty + 8i, columns tx + 16j
#pragma unroll 2
    for (int qq = 0; qq < BQ; ++qq) {
      float pv[RM], dsv[RM], ov[CN], qv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        pv[i] = Ps[(ty + 8 * i) * LDP + qq];
        dsv[i] = dSs[(ty + 8 * i) * LDP + qq];
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        ov[j] = dOs[qq * LD + tx + 16 * j];
        qv[j] = Qs[qq * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          acc_v[i][j] = fmaf(pv[i], ov[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(dsv[i], qv[j], acc_k[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int kr = ty + 8 * i;
    if (k0 + kr < sk) {
      const long long off = ((long long)bh * sk + k0 + kr) * D;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        dk[off + tx + 16 * j] = from_f<T>(scale * acc_k[i][j]);
        dv[off + tx + 16 * j] = from_f<T>(acc_v[i][j]);
      }
    }
  }
}

template <typename T>
Heads<T> heads(const void* p, const long long* st) {
  return Heads<T>{static_cast<const T*>(p), st[0], st[1], st[2]};
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D, BQ, BK>();
  auto kern = flash_bwd_dq_kernel<T, D, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.b * a.h), (unsigned)((a.sq + BQ - 1) / BQ));
  kern<<<grid, NT, smem, stream>>>(
      heads<T>(a.q, a.st), heads<T>(a.k, a.st + 3), heads<T>(a.v, a.st + 6),
      heads<T>(a.dout, a.st + 9), a.lse, a.delta, a.kmask,
      static_cast<T*>(a.out0), a.h, a.sq, a.sk, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D, int BKV, int BQ>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D, BKV, BQ>();
  auto kern = flash_bwd_dkv_kernel<T, D, BKV, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.b * a.h), (unsigned)((a.sk + BKV - 1) / BKV));
  kern<<<grid, NT, smem, stream>>>(
      heads<T>(a.q, a.st), heads<T>(a.k, a.st + 3), heads<T>(a.v, a.st + 6),
      heads<T>(a.dout, a.st + 9), a.lse, a.delta, a.kmask,
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.h, a.sq, a.sk,
      a.scale, a.causal);
  return cudaGetLastError();
}

// tiles per head dim: (BQ, BK) for dQ, (BKV, BQ) for dK/dV
template <typename T>
cudaError_t dispatch_dq(int d, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_dq<T, 64, 64, 64>(a, stream);
    case 128: return launch_dq<T, 128, 32, 64>(a, stream);
    case 192: return launch_dq<T, 192, 32, 64>(a, stream);
    case 256: return launch_dq<T, 256, 32, 64>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dkv(int d, const Args& a, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_dkv<T, 64, 64, 64>(a, stream);
    case 128: return launch_dkv<T, 128, 32, 32>(a, stream);
    case 192: return launch_dkv<T, 192, 32, 32>(a, stream);
    case 256: return launch_dkv<T, 256, 32, 32>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const float* kmask,
               void* out0, void* out1, int b, int h, int sq, int sk,
               const long long* strides, float scale, int causal) {
  Args a{q, k, v, dout, lse, delta, kmask, out0, out1, b, h, sq, sk,
         {}, scale, causal};
  for (int i = 0; i < 12; ++i) a.st[i] = strides[i];
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides holds (sb, sh, ss) in
// elements for q, k, v and dout, in that order; each head dim must be
// contiguous.  lse and delta are contiguous (b*h, sq) fp32, kmask a
// (b, sk) fp32 row or null.  dq is a contiguous (b,h,sq,d) tensor of q's
// dtype; dk and dv contiguous (b,h,sk,d) of k's.  Each returns a
// cudaError_t.
extern "C" int mxtt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const float* kmask, void* dq,
    int b, int h, int sq, int sk, int d, const long long* strides,
    float scale, int causal, int dtype, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, kmask, dq, nullptr, b,
                           h, sq, sk, strides, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_dq<float>(d, a, st);
  if (dtype == 1) return (int)dispatch_dq<__nv_bfloat16>(d, a, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mxtt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const float* kmask, void* dk,
    void* dv, int b, int h, int sq, int sk, int d, const long long* strides,
    float scale, int causal, int dtype, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, kmask, dk, dv, b, h,
                           sq, sk, strides, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_dkv<float>(d, a, st);
  if (dtype == 1) return (int)dispatch_dkv<__nv_bfloat16>(d, a, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
