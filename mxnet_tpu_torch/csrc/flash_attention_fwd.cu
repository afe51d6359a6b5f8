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
// One kernel, flash_fwd_mma_kernel, on the tensor cores.  The tile
// machinery is attention_tiles.cuh's: 4 warps own 64 query rows, 16 each;
// Q arrives by cp.async.bulk and is scaled in place; K and V stream
// through a two-stage ring of bulk row copies, read in place from strided
// head views whose rows start on 16-byte boundaries (contiguous tensors
// and the packed QKV head views; the wrapper copies any other view).  32
// keys a tile (4 blocks an SM at d = 64, 52 KB of shared memory and 99
// registers in fp32), 16 at d = 64 where sk <= 128; key tiles of padding
// are skipped.  Per tile:
//   1. S = Q K^T on mma.sync.m16n8k8 TF32, 3xTF32 in fp32 (bf16: one
//      product, its values are exact in TF32);
//   2. mask, online softmax in registers (quad shuffles for the row max
//      and sum), P rounded to v's dtype;
//   3. O = alpha*O + P V, P taken from the S accumulators as the A
//      operand (attention_tiles.cuh's key order), O in registers.
// Bound on an H100 SXM (chip_smoke.py computes it per call): 4*d
// operations per valid (query, key) pair at the 3xTF32 rate (495/3
// TFLOP/s); at BERT-base's serve shape (b=8, h=12, s=512, d=64, key
// padding) 3.3 GFLOP, 0.0200 ms.  The kernel reaches neither that nor
// the tensor cores' issue rate: its warps wait on the latency of the
// dependent products and of the softmax between them (PERF.md §6).
//
// Built by nvcc into a C-ABI shared library (mxnet_tpu_torch/ops/kernels/
// build.py) and bound with ctypes.  The launch goes on the caller's
// stream; the function returns cudaGetLastError() after it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tiles.cuh"

namespace {

using mxtt::attn::kNegInf;
using mxtt::attn::from_f;

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

template <typename T, int D, int BKT>
__global__ void __launch_bounds__(mxtt::attn::kThreads)
flash_fwd_mma_kernel(mxtt::attn::Heads<T> q, mxtt::attn::Heads<T> k,
                     mxtt::attn::Heads<T> v, const float* __restrict__ kmask,
                     T* __restrict__ o, float* __restrict__ lse, int h,
                     int sq, int sk, float scale, int causal, int* tiles) {
  namespace at = mxtt::attn;
  namespace sm = mxtt::sm90;
  using P = at::Plan<T, D, BKT, 1>;
  constexpr bool S = at::Split<T>::value;
  constexpr int LD = P::LD;
  extern __shared__ __align__(128) unsigned char tile_smem[];
  T* Qs = reinterpret_cast<T*>(tile_smem);  // [kRows][LD], pre-scaled
  T* ring = Qs + at::kRows * LD;       // stage s: K tile, then V tile
  uint64_t* full = reinterpret_cast<uint64_t*>(tile_smem + P::kBarOffset);
  int* list = reinterpret_cast<int*>(full + at::kStages + 1);

  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int q0 = blockIdx.y * at::kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;  // this warp's rows of the tile
  const T* kb = k.row0(bi, hi);
  const T* vb = v.row0(bi, hi);
  const float* km = kmask ? kmask + (long long)bi * sk : nullptr;

  int n_kt = (sk + BKT - 1) / BKT;
  if (causal) {
    // tiles wholly above the diagonal of this q tile contribute nothing
    const int last_q = min(q0 + at::kRows, sq) - 1;
    n_kt = min(n_kt, last_q / BKT + 1);
  }
  uint64_t* qbar = full + at::kStages;  // the Q tile's
  if (threadIdx.x == 0) {
    for (int s = 0; s <= at::kStages; ++s) sm::mbar_init(&full[s], 1);
    sm::mbar_init_fence();
  }
  if (warp == 0) {  // Q first, while the block plans its key tiles
    __syncwarp();
    T* const dst[1] = {Qs};
    const T* const src[1] = {q.row0(bi, hi)};
    const long long ss[1] = {q.ss};
    at::load_tiles<T, D, LD, at::kRows, 1>(dst, src, ss, q0, sq, qbar);
  }
  const int n = at::plan_key_tiles<BKT>(km, sk, n_kt, causal ? q0 : sk, list);
  if (tiles != nullptr && threadIdx.x == 0) {
    atomicAdd(tiles, n);
    atomicAdd(tiles + 1, n_kt);
  }
  if (warp == 0) {
    for (int i = 0; i < min(at::kStages, n); ++i)
      at::load_kv<T, D, LD, BKT>(ring, i, kb, k.ss, vb, v.ss, list[1 + i],
                                 sk, full);
  }
  // q scaled in q's precision (the TPU kernel's q_ref[0] * scale)
  sm::mbar_wait(qbar, 0);
  at::scale_rows<T, D, LD>(Qs, scale);
  __syncthreads();

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};          // this lane's share of the running sums

  for (int i = 0; i < n; ++i) {
    const int stage = i % at::kStages;
    const int k0 = list[1 + i] * BKT;
    const T* Ks = ring + stage * 2 * P::kTile;
    const T* Vs = Ks + P::kTile;
    sm::mbar_wait(&full[stage], (i / at::kStages) & 1);

    // 1. S = Q K^T (q pre-scaled)
    float s[BKT / 8][4];
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 8) {
      uint32_t ah[4], al[4];
      at::a_rows<S>(Qs, LD, r0, c, ah, al);
#pragma unroll
      for (int j = 0; j < BKT / 8; ++j) {
        uint32_t bh[2], bl[2];
        at::b_rows<S>(Ks, LD, 8 * j, c, bh, bl);
        at::mma3<S, S>(s[j], ah, al, bh, bl);
      }
    }

    // 2. mask and online softmax; P rounded to v's dtype
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // keys 2t + c of the block, rows g, g+8
        const int kpos = k0 + 8 * j + 2 * t + c;
        const bool in = kpos < sk;
        const float add = km != nullptr && in ? km[kpos] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool live = in && (!causal || q0 + r0 + g + 8 * r >= kpos);
          float& x = s[j][2 * r + c];
          x = live ? x + add : -INFINITY;
          mx[r] = fmaxf(mx[r], x);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], at::quad_max(mx[r]));
      alpha[r] = at::exp_diff(m[r], m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = at::exp_diff(s[j][e], m[e >> 1]);  // excluded: 0
        l[e >> 1] += p;
        s[j][e] = at::round_to<T>(p);
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // 3. O += P V
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j) {
      uint32_t ah[4], al[4];
      at::a_scores<S>(s[j], ah, al);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        uint32_t bh[2], bl[2];
        at::b_keys<S>(Vs, LD, 8 * j, 8 * c, bh, bl);
        at::mma3<S, S>(acc[c], ah, al, bh, bl);
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (warp == 0 && i + at::kStages < n)
      at::load_kv<T, D, LD, BKT>(ring, stage, kb, k.ss, vb, v.ss,
                                 list[1 + i + at::kStages], sk, full);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    const float lr = fmaxf(at::quad_sum(l[r]), 1e-30f);
    if (row < sq) {
      T* orow = o + ((long long)bh * sq + row) * D + 2 * t;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        orow[8 * c] = from_f<T>(acc[c][2 * r] / lr);
        orow[8 * c + 1] = from_f<T>(acc[c][2 * r + 1] / lr);
      }
      if (t == 0) lse[(long long)bh * sq + row] = m[r] + logf(lr);
    }
  }
}

template <typename T, int D, int BKT>
cudaError_t launch_mma(const Args& a, int* tiles, cudaStream_t stream) {
  using P = mxtt::attn::Plan<T, D, BKT, 1>;
  const size_t smem = P::bytes((a.sk + BKT - 1) / BKT);
  auto kern = flash_fwd_mma_kernel<T, D, BKT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.b * a.h),
                  (unsigned)((a.sq + mxtt::attn::kRows - 1) /
                             mxtt::attn::kRows));
  using H = mxtt::attn::Heads<T>;
  kern<<<grid, mxtt::attn::kThreads, smem, stream>>>(
      H{static_cast<const T*>(a.q), a.q_sb, a.q_sh, a.q_ss},
      H{static_cast<const T*>(a.k), a.k_sb, a.k_sh, a.k_ss},
      H{static_cast<const T*>(a.v), a.v_sb, a.v_sh, a.v_ss}, a.kmask,
      static_cast<T*>(a.o), a.lse, a.h, a.sq, a.sk, a.scale, a.causal, tiles);
  return cudaGetLastError();
}

// keys a tile per head dim (shared memory, blocks an SM)
template <typename T>
cudaError_t dispatch_mma(int d, const Args& a, int* tiles,
                         cudaStream_t stream) {
  switch (d) {
    case 64:
      if (a.sk <= mxtt::attn::kShortKeys)
        return launch_mma<T, 64, 16>(a, tiles, stream);
      return launch_mma<T, 64, mxtt::attn::kKeysD64>(a, tiles, stream);
    case 128: return launch_mma<T, 128, 32>(a, tiles, stream);
    case 192: return launch_mma<T, 192, 32>(a, tiles, stream);
    case 256: return launch_mma<T, 256, 32>(a, tiles, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head
// dim must be contiguous.  kmask is a (b, sk) fp32 row or null.  o is a
// contiguous (b,h,sq,d) tensor of q's dtype, lse a contiguous (b*h, sq)
// fp32 tensor.  Every row of q, k and v starts on a 16-byte boundary.
// tiles, when not null, gains the key tiles the blocks visited ([0]) and
// would visit without skipping ([1]).  Returns a cudaError_t.
extern "C" int mxtt_flash_attention_fwd(
    const void* q, const void* k, const void* v, const float* kmask, void* o,
    float* lse, int b, int h, int sq, int sk, int d, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    float scale, int causal, int dtype, int* tiles, void* stream) {
  const Args a{q,    k,    v,    kmask, o,    lse,  b,    h,     sq,
               sk,   q_sb, q_sh, q_ss,  k_sb, k_sh, k_ss, v_sb,  v_sh,
               v_ss, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_mma<float>(d, a, tiles, st);
  if (dtype == 1) return (int)dispatch_mma<__nv_bfloat16>(d, a, tiles, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
