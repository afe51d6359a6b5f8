// The tile machinery of the flash-attention kernels for Hopper (sm_90a):
// the query-stationary forward (flash_attention_fwd.cu) and dQ kernel,
// where a block of four warps owns 64 query rows of one (batch, head), 16
// a warp, and walks the key tiles of its row; and the key-stationary
// dK/dV kernel (flash_attention_bwd.cu), its mirror: the block owns 64
// keys, 16 a warp, holds their K and V rows and walks the query tiles.
//
// * Products on the tensor cores, fp32-accurate: warp-level
//   mma.sync.m16n8k8 in TF32 with fp32 accumulation.  An fp32 operand is
//   split once per fragment into hi = x rounded to TF32 and lo = x - hi,
//   and a product sums lo*hi + hi*lo + hi*hi (3xTF32: about 21 bits of
//   each operand, where 1xTF32 keeps 11).  The split is two integer ops
//   and a subtraction (cvt.rna.tf32 runs on the slow conversion pipe).
//   A bf16 or fp16 value is exact in TF32 (8 or 11 significant bits,
//   an exponent inside TF32's range), so its lo is zero and its terms
//   are left out at compile time (`Split`).
// * Scores stay in registers.  The accumulator of S = Q K^T (row g and
//   g + 8, keys 2t and 2t + 1 of each 8-key column block, for lane
//   4g + t) becomes the A operand of P V (or dS K) as it is, by reading
//   the 8 keys of each k-step in the order 0, 2, 4, 6, 1, 3, 5, 7: the B
//   operand reads V's (or K's) rows in that same order (`b_keys`).
// * K and V arrive by a two-stage ring: each key row is one
//   cp.async.bulk copy (TMA's bulk engine) into a padded shared row,
//   completing on the stage's mbarrier; so do the block's Q (and dO)
//   rows, on a barrier of their own, issued first.  (In the dK/dV kernel
//   the roles swap: K and V are the block's rows, Q and dO the ring's.)  The rows are read in
//   place from strided head views (the packed QKV layout); they must
//   start on 16-byte boundaries, and the wrapper copies a view whose rows
//   do not.
//   The pad (16 bytes a row) makes every fragment read conflict-free.
// * exp is ex2.approx of (x - m) log2(e): one MUFU op.
// * Key tiles that hold only padding are skipped (`plan_key_tiles`): a
//   tile is visited unless each of its keys has a mask value <= -1e9 and
//   every query row of the block has a live key.  In such a row
//   exp(s - 1e9 - m) is 0.0 in fp32, so skipping is exact; a row with no
//   live key (a dead row of a padded batch) still visits every tile and
//   keeps the TPU kernels' result (mean of V, p = 1 in the backward).
//   Seen from the keys (`dead_key_block`): a block of 64 keys that are
//   all padding has p = 0 in every row that sees it and a live key, so
//   its dK and dV are zeros when every such row has one.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace mxtt {
namespace attn {

constexpr float kNegInf = -1e9f;  // the TPU kernels' _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows of a block
constexpr int kStages = 2;          // the K/V ring

// keys a tile at d = 64: 32 keep four forward blocks (three dQ blocks) on
// an SM, where 64 kept two (PERF.md §6 has the timings of 16, 32 and 64).
// The forward takes 16 where sk <= kShortKeys (five blocks an SM, and
// finer skipping over few tiles).  At d >= 128 the kernels' dispatch
// tables fix the tiles.
constexpr int kKeysD64 = 32;
constexpr int kShortKeys = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T's precision, as fp32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// whether T's values need a lo term in TF32 (fp32 does, bf16 and fp16 do
// not)
template <typename T> struct Split { static constexpr bool value = true; };
template <> struct Split<__nv_bfloat16> {
  static constexpr bool value = false;
};
template <> struct Split<__half> { static constexpr bool value = false; };

// A strided (b, h, s, d) head tensor with a contiguous last dim.
template <typename T>
struct Heads {
  const T* p;
  long long sb, sh, ss;
  __device__ __forceinline__ const T* row0(int bi, int hi) const {
    return p + bi * sb + hi * sh;
  }
};

// -- TF32 fragments -----------------------------------------------------------

// split, mma_tf32 and mma3: tf32x3.cuh
using tf32x3::mma3;
using tf32x3::mma_tf32;
using tf32x3::split;

// the A fragment of rows r0.., columns k0.. of a row-major tile
template <bool SPLIT, typename T>
__device__ __forceinline__ void a_rows(const T* tile, int ld, int r0, int k0,
                                       uint32_t* hi, uint32_t* lo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* p = tile + (r0 + g) * ld + k0 + t;
  split<SPLIT>(to_f(p[0]), hi[0], lo[0]);
  split<SPLIT>(to_f(p[8 * ld]), hi[1], lo[1]);
  split<SPLIT>(to_f(p[4]), hi[2], lo[2]);
  split<SPLIT>(to_f(p[8 * ld + 4]), hi[3], lo[3]);
}

// the B fragment (k = columns k0.., n = rows n0..) of a row-major tile:
// K^T for S = Q K^T, V^T for dP = dO V^T
template <bool SPLIT, typename T>
__device__ __forceinline__ void b_rows(const T* tile, int ld, int n0, int k0,
                                       uint32_t* hi, uint32_t* lo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* p = tile + (n0 + g) * ld + k0 + t;
  split<SPLIT>(to_f(p[0]), hi[0], lo[0]);
  split<SPLIT>(to_f(p[4]), hi[1], lo[1]);
}

// the B fragment (k = key rows k0.. in the order 0, 2, 4, 6, 1, 3, 5, 7;
// n = columns n0..) of a row-major key tile: V for P V, K for dS K
template <bool SPLIT, typename T>
__device__ __forceinline__ void b_keys(const T* tile, int ld, int k0, int n0,
                                       uint32_t* hi, uint32_t* lo) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* p = tile + (k0 + 2 * t) * ld + n0 + g;
  split<SPLIT>(to_f(p[0]), hi[0], lo[0]);
  split<SPLIT>(to_f(p[ld]), hi[1], lo[1]);
}

// the A fragment of P (or dS) from its accumulator c of one 8-key block,
// in b_keys' key order
template <bool SPLIT>
__device__ __forceinline__ void a_scores(const float* c, uint32_t* hi,
                                         uint32_t* lo) {
  split<SPLIT>(c[0], hi[0], lo[0]);
  split<SPLIT>(c[2], hi[1], lo[1]);
  split<SPLIT>(c[1], hi[2], lo[2]);
  split<SPLIT>(c[3], hi[3], lo[3]);
}

// 2^x, one MUFU op (relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// exp(x - m) as 2^((x - m) log2 e): the difference first, so that x = m
// gives 1 exactly (a dead row's scores and max are both -1e9)
__device__ __forceinline__ float exp_diff(float x, float m) {
  return exp2_approx((x - m) * kLog2e);
}

// the max (or sum) of a row over the four lanes that hold it
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -- shared memory ------------------------------------------------------------

// A block's shared memory: NQ stationary tiles of kRows rows (Q, and dO
// in the dQ kernel), the K/V ring, the ring's barriers and the stationary
// tiles' barrier, and the list of key tiles to visit.  Rows are padded by
// 16 bytes.
template <typename T, int D, int BK, int NQ>
struct Plan {
  static constexpr int LD = D + 16 / sizeof(T);  // row stride, elements
  static constexpr int kTile = BK * LD;          // elements of a K or V tile
  static constexpr size_t kBarOffset =
      sizeof(T) * (size_t)(NQ * kRows * LD + kStages * 2 * kTile);
  static constexpr size_t bytes(int n_kt) {
    return kBarOffset + 8 * (kStages + 1) + 4 * (size_t)(n_kt + 1);
  }
};

// -- asynchronous row copies --------------------------------------------------

// one row of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_row(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sm90::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(sm90::smem_addr(bar))
      : "memory");
}

// Warp 0 copies rows [r0, r0 + R) of N head slices (src[i], row stride
// ss[i]) into padded tiles dst[i], completing on `bar`, which it arms
// with their bytes.  Rows at or past `s` are zeros: no score uses them,
// but V's meet P = 0, and 0 * garbage could be NaN.
template <typename T, int D, int LD, int R, int N>
__device__ __forceinline__ void load_tiles(T* const* dst, const T* const* src,
                                           const long long* ss, int r0, int s,
                                           uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  const int rows = min(R, s - r0);
  constexpr uint32_t kRowBytes = D * sizeof(T);
  if (rows < R) {
    for (int i = lane; i < (R - rows) * D; i += 32) {
      const int r = rows + i / D, c = i % D;
#pragma unroll
      for (int j = 0; j < N; ++j) dst[j][r * LD + c] = from_f<T>(0.f);
    }
    sm90::fence_async_shared();
  }
  __syncwarp();
  if (lane == 0) sm90::mbar_expect_tx(bar, (uint32_t)N * rows * kRowBytes);
  __syncwarp();
  for (int r = lane; r < rows; r += 32) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      bulk_row(dst[j] + r * LD, src[j] + (r0 + r) * ss[j], kRowBytes, bar);
  }
}

// Warp 0 fills stage `stage` of the ring (K tile, then V tile) with the
// rows of key tile kt, BK keys from kt * BK.  The dK/dV kernel streams Q
// and dO rows through it the same way (kb, vb = Q, dO; kt a query tile).
template <typename T, int D, int LD, int BK>
__device__ __forceinline__ void load_kv(T* ring, int stage, const T* kb,
                                        long long k_ss, const T* vb,
                                        long long v_ss, int kt, int sk,
                                        uint64_t* full) {
  T* const dst[2] = {ring + 2 * stage * BK * LD,
                     ring + (2 * stage + 1) * BK * LD};
  const T* const src[2] = {kb, vb};
  const long long ss[2] = {k_ss, v_ss};
  load_tiles<T, D, LD, BK, 2>(dst, src, ss, kt * BK, sk, &full[stage]);
}

// (a, b) at p and p + 1, rounded to T (p even: one 8- or 4-byte store)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// Multiplies a tile of kRows rows in place by `scale`, rounded to T (the
// TPU kernel's q_ref[0] * scale); every thread of the block calls it.
template <typename T, int D, int LD>
__device__ __forceinline__ void scale_rows(T* tile, float scale) {
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    T& x = tile[(i / D) * LD + i % D];
    x = from_f<T>(to_f(x) * scale);
  }
}

// -- which key tiles a block visits -------------------------------------------

// Writes the key tiles of [0, n_kt) that the block visits to list[1..]
// and their count to list[0], and returns the count.  Without a mask,
// every tile.  With one, a tile whose keys all have mask values <= -1e9
// is skipped when every query row of the block sees a live key: the
// first live key is at most `first_row` (the block's first row under
// causal, where row r sees keys 0..r; else any key).  Every thread of
// the block calls it; all read the mask, warp 0 compacts the list.
template <int BK>
__device__ int plan_key_tiles(const float* km, int sk, int n_kt,
                              int first_row, int* list) {
  __shared__ int first_live;
  const int tid = threadIdx.x, lane = tid & 31;
  if (km == nullptr) {
    for (int i = tid; i < n_kt; i += kThreads) list[1 + i] = i;
    if (tid == 0) list[0] = n_kt;
    __syncthreads();
    return n_kt;
  }
  for (int i = tid; i < n_kt; i += kThreads) list[1 + i] = 0;
  if (tid == 0) first_live = INT_MAX;
  __syncthreads();
  const int end = min(sk, n_kt * BK);
  int first = INT_MAX;
#pragma unroll 4
  for (int key = tid; key < end; key += kThreads) {
    if (km[key] > kNegInf) {
      list[1 + key / BK] = 1;  // the tile's flag, compacted below
      first = min(first, key);
    }
  }
  first = __reduce_min_sync(0xffffffffu, first);
  if (lane == 0 && first < INT_MAX) atomicMin(&first_live, first);
  __syncthreads();
  if (tid < 32) {
    const bool skip = first_live <= first_row;
    int n = 0;
    for (int base = 0; base < n_kt; base += 32) {
      const int i = base + lane;
      const bool keep = i < n_kt && (!skip || list[1 + i]);
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      // in place: entry n + (kept lanes below) <= i, read before the ballot
      if (keep) list[1 + n + __popc(ballot & ((1u << lane) - 1u))] = i;
      n += __popc(ballot);
    }
    if (lane == 0) list[0] = n;
  }
  __syncthreads();
  return list[0];
}

// Whether the block of kRows keys from k0 may be skipped by the dK/dV
// kernel: each of its keys below sk has a mask value <= -1e9, and every
// query row that sees the block has a live key, which holds when the
// first live key is at most `first_row` (k0 under causal, where the rows
// from k0 on see it and row r sees keys 0..r; else sk: any live key).
// Then p = exp(s - 1e9 - lse) is 0.0 in fp32 in each of those rows, so
// the block's dK and dV are zeros.  Without a mask, never.  Every thread
// of the block calls it; the whole key row is read only for a dead block.
__device__ bool dead_key_block(const float* km, int sk, int k0,
                               int first_row) {
  __shared__ int first_live;
  if (km == nullptr) return false;
  const int tid = threadIdx.x;
  const int key = k0 + tid;
  if (__syncthreads_or(tid < kRows && key < sk && km[key] > kNegInf))
    return false;
  if (tid == 0) first_live = INT_MAX;
  __syncthreads();
  int first = INT_MAX;
  for (int i = tid; i < sk; i += kThreads) {
    if (km[i] > kNegInf) {  // this thread's keys rise: its first is its least
      first = i;
      break;
    }
  }
  first = __reduce_min_sync(0xffffffffu, first);
  if ((tid & 31) == 0 && first < INT_MAX) atomicMin(&first_live, first);
  __syncthreads();
  return first_live <= first_row;
}

}  // namespace attn
}  // namespace mxtt
