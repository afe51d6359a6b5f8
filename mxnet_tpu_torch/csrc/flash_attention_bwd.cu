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
// dQ on the tensor cores (flash_bwd_dq_mma_kernel).  The tile machinery
// is attention_tiles.cuh's: 4 warps own 64 query rows; Q and dO arrive
// by cp.async.bulk with the ring's first K/V tiles; K and V stream
// through a two-stage ring of bulk row copies, read in place from head
// views whose rows start on 16-byte boundaries (contiguous tensors and
// the head views autograd hands over; the wrapper copies any other
// view), 32 keys a tile at d <= 192 and 16 at 256 (3 blocks an SM at
// d = 64, 70 KB of shared memory and 126 registers in fp32); key tiles of
// padding are skipped.  Per tile: S = Q K^T and dP = dO V^T on
// mma.sync.m16n8k8 TF32 (3xTF32 in fp32, one product in bf16),
// dS = P (dP - delta) in fp32 registers, never rounded, then dQ += dS K
// with dS taken from the accumulators as the A operand (3xTF32; bf16 K
// needs hi and lo of dS only).  dQ is written once, scaled.  Under
// `causal` it stops at the last key tile its rows see.
//
// dK/dV on the tensor cores (flash_bwd_dkv_mma_kernel), the key-stationary
// mirror of the dQ kernel: 4 warps own 64 keys, 16 a warp; their K and V
// rows arrive once by cp.async.bulk, and Q and dO stream through the
// two-stage ring in tiles of BQ queries (32 at d = 64, 16 above, for
// shared memory; 3 blocks an SM at d = 64, 70 KB and 168 registers in
// fp32).  Per tile: S^T = K Q^T and dP^T = V dO^T on mma.sync
// (K, V rows as A; Q, dO rows as B; 3xTF32 in fp32), then
// P^T = exp(scale S^T + mask - lse) and dS^T = P^T (dP^T - delta) in fp32
// registers, never rounded; the tile's queries are the accumulators'
// columns, so each lane reads lse and delta of its columns (2t, 2t + 1 of
// each 8-query block) with ordinary loads, issued before it waits for the
// tile (a row of them is not 16-byte aligned at odd sq).  Then
// dV += P^T dO and dK += dS^T Q with P^T, dS^T taken from the accumulators
// as the A operand and the Q and dO rows read in b_keys' order.  dK is
// written once, scaled.  A warp's dK and dV accumulators take D fp32
// registers a thread: up to d = 128 one pass holds them all; at d = 192
// and 256 the kernel makes two passes over the query tiles, each for half
// of the columns (S^T and dP^T computed again), to stay within 255
// registers without spilling.  Under `causal` a block starts at the first
// query tile that sees its keys.  A block of keys that are all padding,
// where every row that sees it has a live key, writes zeros and returns
// (attention_tiles.cuh, `dead_key_block`); rows with no live key (dead
// rows) have p = 1 and keep every block.  No atomics: each block owns its
// keys, and two runs give the same bits.
//
// Bound on an H100 SXM (chip_smoke.py computes it per call): dQ does
// 6*d and dK/dV 8*d operations per (query, key) pair the row attends to,
// and each reads q, k, v, dO, lse, delta and the mask once and writes its
// outputs once.  At the training shape (b=32, h=12, s=128, d=64, fp32,
// key padding as chip_smoke.py draws it) that is 1.4 and 1.9 GFLOP over
// the valid pairs against ~63 and ~76 MB: bytes bound, 0.0189 and 0.0227
// ms at 3.35 TB/s (the 3xTF32 rate, 495/3 TFLOP/s, would take 0.0086 and
// 0.0114).
//
// Built by nvcc into a C-ABI shared library (mxnet_tpu_torch/ops/kernels/
// build.py) and bound with ctypes.  Each launch goes on the caller's
// stream; each function returns cudaGetLastError() after it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tiles.cuh"

namespace {

using mxtt::attn::Heads;
using mxtt::attn::from_f;

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

template <typename T, int D, int BKT>
__global__ void __launch_bounds__(mxtt::attn::kThreads)
flash_bwd_dq_mma_kernel(Heads<T> q, Heads<T> k, Heads<T> v, Heads<T> dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ kmask, T* __restrict__ dq,
                        int h, int sq, int sk, float scale, int causal,
                        int* tiles) {
  namespace at = mxtt::attn;
  namespace sm = mxtt::sm90;
  using P = at::Plan<T, D, BKT, 2>;
  constexpr bool S = at::Split<T>::value;
  constexpr int LD = P::LD;
  extern __shared__ __align__(128) unsigned char tile_smem[];
  T* Qs = reinterpret_cast<T*>(tile_smem);  // [kRows][LD]
  T* dOs = Qs + at::kRows * LD;        // [kRows][LD]
  T* ring = dOs + at::kRows * LD;      // stage s: K tile, then V tile
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
    // key tiles wholly after this q tile's last row contribute nothing
    const int last_q = min(q0 + at::kRows, sq) - 1;
    n_kt = min(n_kt, last_q / BKT + 1);
  }
  uint64_t* qbar = full + at::kStages;  // the Q and dO tiles'
  if (threadIdx.x == 0) {
    for (int s = 0; s <= at::kStages; ++s) sm::mbar_init(&full[s], 1);
    sm::mbar_init_fence();
  }
  if (warp == 0) {  // Q and dO first, while the block plans its key tiles
    __syncwarp();
    T* const dst[2] = {Qs, dOs};
    const T* const src[2] = {q.row0(bi, hi), dout.row0(bi, hi)};
    const long long ss[2] = {q.ss, dout.ss};
    at::load_tiles<T, D, LD, at::kRows, 2>(dst, src, ss, q0, sq, qbar);
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
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    row_lse[r] = row < sq ? lse[(long long)bh * sq + row] : 0.f;
    row_delta[r] = row < sq ? delta[(long long)bh * sq + row] : 0.f;
  }
  sm::mbar_wait(qbar, 0);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int stage = i % at::kStages;
    const int k0 = list[1 + i] * BKT;
    const T* Ks = ring + stage * 2 * P::kTile;
    const T* Vs = Ks + P::kTile;
    sm::mbar_wait(&full[stage], (i / at::kStages) & 1);

    // S = Q K^T and dP = dO V^T
    float s[BKT / 8][4], dp[BKT / 8][4];
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 8) {
      uint32_t qh[4], ql[4], oh[4], ol[4];
      at::a_rows<S>(Qs, LD, r0, c, qh, ql);
      at::a_rows<S>(dOs, LD, r0, c, oh, ol);
#pragma unroll
      for (int j = 0; j < BKT / 8; ++j) {
        uint32_t bh[2], bl[2];
        at::b_rows<S>(Ks, LD, 8 * j, c, bh, bl);
        at::mma3<S, S>(s[j], qh, ql, bh, bl);
        at::b_rows<S>(Vs, LD, 8 * j, c, bh, bl);
        at::mma3<S, S>(dp[j], oh, ol, bh, bl);
      }
    }

    // dS = P (dP - delta), P = exp(scale S + mask - lse), fp32, kept in s
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // keys 2t + c of the block, rows g, g+8
        const int kpos = k0 + 8 * j + 2 * t + c;
        const bool in = kpos < sk;
        const float add = km != nullptr && in ? km[kpos] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c;
          float ds = 0.f;
          if (in && (!causal || q0 + r0 + g + 8 * r >= kpos)) {
            const float p = at::exp_diff(scale * s[j][e] + add, row_lse[r]);
            ds = p * (dp[j][e] - row_delta[r]);
          }
          s[j][e] = ds;
        }
      }
    }

    // dQ += dS K: dS is fp32 (hi and lo); K's lo only in fp32
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j) {
      uint32_t ah[4], al[4];
      at::a_scores<true>(s[j], ah, al);
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        uint32_t bh[2], bl[2];
        at::b_keys<S>(Ks, LD, 8 * j, 8 * c, bh, bl);
        at::mma3<true, S>(acc[c], ah, al, bh, bl);
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
    if (row < sq) {
      T* out = dq + ((long long)bh * sq + row) * D + 2 * t;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        out[8 * c] = from_f<T>(scale * acc[c][2 * r]);
        out[8 * c + 1] = from_f<T>(scale * acc[c][2 * r + 1]);
      }
    }
  }
}

template <typename T, int D, int BQ, int DC>
__global__ void __launch_bounds__(mxtt::attn::kThreads)
flash_bwd_dkv_mma_kernel(Heads<T> q, Heads<T> k, Heads<T> v, Heads<T> dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ kmask, T* __restrict__ dk,
                         T* __restrict__ dv, int h, int sq, int sk,
                         float scale, int causal, int* blocks) {
  namespace at = mxtt::attn;
  namespace sm = mxtt::sm90;
  using P = at::Plan<T, D, BQ, 2>;  // K and V stationary, Q and dO streamed
  constexpr bool S = at::Split<T>::value;
  constexpr int LD = P::LD;
  constexpr int NP = D / DC;  // passes over the query tiles
  extern __shared__ __align__(128) unsigned char tile_smem[];
  T* Ks = reinterpret_cast<T*>(tile_smem);  // [kRows][LD]
  T* Vs = Ks + at::kRows * LD;         // [kRows][LD]
  T* ring = Vs + at::kRows * LD;       // stage s: Q tile, then dO tile
  uint64_t* full = reinterpret_cast<uint64_t*>(tile_smem + P::kBarOffset);

  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int k0 = blockIdx.y * at::kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;  // this warp's keys of the block
  const float* km = kmask ? kmask + (long long)bi * sk : nullptr;
  const int rows = min(at::kRows, sk - k0);
  const long long out0 = ((long long)bh * sk + k0) * D;

  const bool skip = at::dead_key_block(km, sk, k0, causal ? k0 : sk);
  if (blocks != nullptr && threadIdx.x == 0) {
    if (!skip) atomicAdd(blocks, 1);
    atomicAdd(blocks + 1, 1);
  }
  if (skip) {
    for (int i = threadIdx.x; i < rows * D; i += at::kThreads) {
      dk[out0 + i] = from_f<T>(0.f);
      dv[out0 + i] = from_f<T>(0.f);
    }
    return;
  }

  const int n_qt = (sq + BQ - 1) / BQ;
  // under causal, query tiles wholly before k0 see none of these keys
  const int qt0 = causal ? min(k0 / BQ, n_qt) : 0;
  const int n = n_qt - qt0;
  const T* qb = q.row0(bi, hi);
  const T* ob = dout.row0(bi, hi);
  uint64_t* kvbar = full + at::kStages;  // the K and V tiles'
  if (threadIdx.x == 0) {
    for (int s = 0; s <= at::kStages; ++s) sm::mbar_init(&full[s], 1);
    sm::mbar_init_fence();
  }
  __syncthreads();
  if (warp == 0) {
    T* const dst[2] = {Ks, Vs};
    const T* const src[2] = {k.row0(bi, hi), v.row0(bi, hi)};
    const long long ss[2] = {k.ss, v.ss};
    at::load_tiles<T, D, LD, at::kRows, 2>(dst, src, ss, k0, sk, kvbar);
    for (int i = 0; i < min(at::kStages, NP * n); ++i)
      at::load_kv<T, D, LD, BQ>(ring, i, qb, q.ss, ob, dout.ss, qt0 + i % n,
                                sq, full);
  }
  // the mask values of this lane's keys, rows g and g + 8
  float add[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = k0 + r0 + g + 8 * r;
    add[r] = km != nullptr && kpos < sk ? km[kpos] : 0.f;
  }
  const float* lse_b = lse + (long long)bh * sq;
  const float* delta_b = delta + (long long)bh * sq;
  sm::mbar_wait(kvbar, 0);

  for (int pass = 0; pass < NP; ++pass) {
    const int col0 = pass * DC;  // this pass's columns of dK and dV
    float acc_k[DC / 8][4], acc_v[DC / 8][4];
#pragma unroll
    for (int c = 0; c < DC / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[c][e] = acc_v[c][e] = 0.f;

    for (int i = 0; i < n; ++i) {
      const int it = pass * n + i;  // the ring's count
      const int stage = it % at::kStages;
      const int q0 = (qt0 + i) * BQ;
      // lse and delta of this lane's queries: 2t + c of each 8-query block
      float c_lse[BQ / 8][2], c_delta[BQ / 8][2];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qpos = q0 + 8 * j + 2 * t + c;
          c_lse[j][c] = qpos < sq ? lse_b[qpos] : 0.f;
          c_delta[j][c] = qpos < sq ? delta_b[qpos] : 0.f;
        }
      const T* Qs = ring + stage * 2 * P::kTile;
      const T* dOs = Qs + P::kTile;
      sm::mbar_wait(&full[stage], (it / at::kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T: keys as rows, queries as columns
      float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 2
      for (int c = 0; c < D; c += 8) {
        uint32_t kh[4], kl[4], vh[4], vl[4];
        at::a_rows<S>(Ks, LD, r0, c, kh, kl);
        at::a_rows<S>(Vs, LD, r0, c, vh, vl);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
          uint32_t bh[2], bl[2];
          at::b_rows<S>(Qs, LD, 8 * j, c, bh, bl);
          at::mma3<S, S>(s[j], kh, kl, bh, bl);
          at::b_rows<S>(dOs, LD, 8 * j, c, bh, bl);
          at::mma3<S, S>(dp[j], vh, vl, bh, bl);
        }
      }

      // P^T = exp(scale S^T + mask - lse) into s, dS^T = P^T (dP^T - delta)
      // into dp, fp32
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {  // queries 2t + c, keys g and g + 8
          const int qpos = q0 + 8 * j + 2 * t + c;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c;
            const int kpos = k0 + r0 + g + 8 * r;
            float p = 0.f, ds = 0.f;
            if (qpos < sq && kpos < sk && (!causal || qpos >= kpos)) {
              p = at::exp_diff(scale * s[j][e] + add[r], c_lse[j][c]);
              ds = p * (dp[j][e] - c_delta[j][c]);
            }
            s[j][e] = p;
            dp[j][e] = ds;
          }
        }
      }

      // dV += P^T dO and dK += dS^T Q: P^T and dS^T fp32 (hi and lo); the
      // lo terms of dO and Q only in fp32
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        uint32_t ph[4], pl[4], dh[4], dl[4];
        at::a_scores<true>(s[j], ph, pl);
        at::a_scores<true>(dp[j], dh, dl);
#pragma unroll
        for (int c = 0; c < DC / 8; ++c) {
          uint32_t bh[2], bl[2];
          at::b_keys<S>(dOs, LD, 8 * j, col0 + 8 * c, bh, bl);
          at::mma3<true, S>(acc_v[c], ph, pl, bh, bl);
          at::b_keys<S>(Qs, LD, 8 * j, col0 + 8 * c, bh, bl);
          at::mma3<true, S>(acc_k[c], dh, dl, bh, bl);
        }
      }
      __syncthreads();  // every warp is done with this stage
      const int next = it + at::kStages;
      if (warp == 0 && next < NP * n)
        at::load_kv<T, D, LD, BQ>(ring, stage, qb, q.ss, ob, dout.ss,
                                  qt0 + next % n, sq, full);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kr = r0 + g + 8 * r;
      if (kr < rows) {
        T* ok = dk + out0 + (long long)kr * D + col0 + 2 * t;
        T* ov = dv + out0 + (long long)kr * D + col0 + 2 * t;
#pragma unroll
        for (int c = 0; c < DC / 8; ++c) {
          at::store2(ok + 8 * c, scale * acc_k[c][2 * r],
                     scale * acc_k[c][2 * r + 1]);
          at::store2(ov + 8 * c, acc_v[c][2 * r], acc_v[c][2 * r + 1]);
        }
      }
    }
  }
}

template <typename T>
Heads<T> heads(const void* p, const long long* st) {
  return Heads<T>{static_cast<const T*>(p), st[0], st[1], st[2]};
}

template <typename T, int D, int BQ, int DC>
cudaError_t launch_dkv_mma(const Args& a, int* blocks, cudaStream_t stream) {
  using P = mxtt::attn::Plan<T, D, BQ, 2>;
  const size_t smem = P::bytes(0);
  auto kern = flash_bwd_dkv_mma_kernel<T, D, BQ, DC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.b * a.h),
                  (unsigned)((a.sk + mxtt::attn::kRows - 1) /
                             mxtt::attn::kRows));
  kern<<<grid, mxtt::attn::kThreads, smem, stream>>>(
      heads<T>(a.q, a.st), heads<T>(a.k, a.st + 3), heads<T>(a.v, a.st + 6),
      heads<T>(a.dout, a.st + 9), a.lse, a.delta, a.kmask,
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.h, a.sq, a.sk,
      a.scale, a.causal, blocks);
  return cudaGetLastError();
}

template <typename T, int D, int BKT>
cudaError_t launch_dq_mma(const Args& a, int* tiles, cudaStream_t stream) {
  using P = mxtt::attn::Plan<T, D, BKT, 2>;
  const size_t smem = P::bytes((a.sk + BKT - 1) / BKT);
  auto kern = flash_bwd_dq_mma_kernel<T, D, BKT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.b * a.h),
                  (unsigned)((a.sq + mxtt::attn::kRows - 1) /
                             mxtt::attn::kRows));
  kern<<<grid, mxtt::attn::kThreads, smem, stream>>>(
      heads<T>(a.q, a.st), heads<T>(a.k, a.st + 3), heads<T>(a.v, a.st + 6),
      heads<T>(a.dout, a.st + 9), a.lse, a.delta, a.kmask,
      static_cast<T*>(a.out0), a.h, a.sq, a.sk, a.scale, a.causal, tiles);
  return cudaGetLastError();
}

// keys a tile of the tensor-core dQ kernel per head dim (shared memory)
template <typename T>
cudaError_t dispatch_dq_mma(int d, const Args& a, int* tiles,
                            cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch_dq_mma<T, 64, mxtt::attn::kKeysD64>(a, tiles, stream);
    case 128: return launch_dq_mma<T, 128, 32>(a, tiles, stream);
    case 192: return launch_dq_mma<T, 192, 32>(a, tiles, stream);
    case 256: return launch_dq_mma<T, 256, 16>(a, tiles, stream);
    default: return cudaErrorInvalidValue;
  }
}

// query tiles BQ (shared memory) and the columns DC of dK and dV a pass
// holds in registers, per head dim, for the dK/dV kernel
template <typename T>
cudaError_t dispatch_dkv_mma(int d, const Args& a, int* blocks,
                             cudaStream_t stream) {
  switch (d) {
    case 64: return launch_dkv_mma<T, 64, 32, 64>(a, blocks, stream);
    case 128: return launch_dkv_mma<T, 128, 16, 128>(a, blocks, stream);
    case 192: return launch_dkv_mma<T, 192, 16, 96>(a, blocks, stream);
    case 256: return launch_dkv_mma<T, 256, 16, 128>(a, blocks, stream);
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
// dtype; dk and dv contiguous (b,h,sk,d) of k's.  Every row of q, k, v
// and dout starts on a 16-byte boundary.  For the dQ kernel tiles, when
// not null, gains the key tiles the blocks visited ([0]) and would visit
// without skipping ([1]); for the dK/dV kernel blocks gains the blocks of
// 64 keys that were not skipped ([0]) and all of them ([1]).  Each returns
// a cudaError_t.
extern "C" int mxtt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const float* kmask, void* dq,
    int b, int h, int sq, int sk, int d, const long long* strides,
    float scale, int causal, int dtype, int* tiles, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, kmask, dq, nullptr, b,
                           h, sq, sk, strides, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_dq_mma<float>(d, a, tiles, st);
  if (dtype == 1) return (int)dispatch_dq_mma<__nv_bfloat16>(d, a, tiles, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mxtt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const float* kmask, void* dk,
    void* dv, int b, int h, int sq, int sk, int d, const long long* strides,
    float scale, int causal, int dtype, int* blocks, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, kmask, dk, dv, b, h,
                           sq, sk, strides, scale, causal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_dkv_mma<float>(d, a, blocks, st);
  if (dtype == 1)
    return (int)dispatch_dkv_mma<__nv_bfloat16>(d, a, blocks, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
