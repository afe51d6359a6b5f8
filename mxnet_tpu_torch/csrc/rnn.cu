// LSTM and GRU recurrences for Hopper (sm_90a): forward and backward, fp32,
// bf16 and fp16 activations, fp32 math and state.  In bf16 and fp16 x_proj
// is read and ys, hn and cn are written in that dtype; Wh, the gates, the
// cell states and every gradient stay fp32 (the wrappers widen a 16-bit
// Wh, exactly, and round its gradient back).
//
// Replaces the four recurrence kernels of mxnet_tpu/ops/pallas/rnn.py:
// _lstm_fwd_kernel, _lstm_bwd_kernel, _gru_fwd_kernel and _gru_bwd_kernel.
// The input projection x @ Wi^T + b stays a matrix product outside (as the
// JAX package leaves it to XLA); these kernels run the serial part.  Gates
// are gate-major inside 4H (LSTM: i, f, g, o) and 3H (GRU: r, z, n, the
// cuDNN linear-before-reset cell).
//
// On the TPU one program walked a grid of T steps with h and c resident in
// VMEM.  Here one launch runs all T steps ("persistent").  A step is a
// (N x H) by (H x G*H) product and G*N*H activations: at DeepAR's width
// (N=32, H=40) a few hundred thousand FMAs, so a step costs the latency of
// its dependent chain (product, activations, the exchange of h or of the
// gate gradients, a synchronisation), not bytes or operations; at DeepAR
// predict's N = 1,600-3,200 the forward is bound by its bytes (x_proj in,
// the gates out: ~0.5 GB at N=3200).  Four routes; mxtt_rnn_plan picks one
// per (kernel, N, H) before any launch:
//
// - The split route (every kernel, where no other takes the size): the
//   grid is (unit tiles) x (row tiles); block (u, b) owns hidden units
//   [u*JB, u*JB+JB) of batch rows [b*NB, b*NB+NB), keeps the rows of Wh
//   for its units (forward) or the columns (backward) in shared memory for
//   the whole launch, and carries its own c (LSTM) and its part of dh/dc
//   in shared memory.  Where Wh fits one block (H up to
//   ~110 for the LSTM, ~125 for the GRU) blocks are independent: each keeps
//   its rows' whole h in shared memory and needs only __syncthreads between
//   phases.  Otherwise a step needs every unit's h (forward) or every
//   unit's gate gradients (backward) of the row, which other blocks
//   computed.  They go through global memory: the forward through a double
//   buffer hbuf (2, N, H) fp32, the backward through dxp (LSTM) or the dgh
//   scratch (GRU), which are written at a new t every step.  A grid barrier
//   (written here: one arrival counter whose top bit flips) separates the
//   writes of a step from the reads, once per step.  Every block must then
//   be resident: the launch is cooperative (cudaLaunchCooperativeKernel),
//   after a check with the occupancy API, and fails rather than deadlock.
//   Reads of exchanged data use __ldcg (L2), never a stale L1 line.
// - The register route (the LSTM at H <= kRegMaxH: its backward, and its
//   forward where the tensor-core route does not take the call; DeepAR
//   training): one block a batch row, a thread a gate of a unit with its
//   row of Wh (forward) or its column (backward) in registers, the four
//   gates of a unit in one quad of lanes (__shfl_sync), c (and dc) in
//   registers, h (the gate gradients) broadcast from a double buffer in
//   shared memory, inputs loaded kXpAhead steps ahead, one __syncthreads a
//   step (lstm_fwd_reg_kernel, lstm_bwd_reg_kernel).
// - The tensor-core route (LSTM forward, N >= kMmaMinN, even H <=
//   kMmaMaxH; DeepAR predict): 16 rows a block, the step's product as
//   3xTF32 mma.sync (tf32x3.cuh) with Wh's fragments in registers and each
//   lane holding all four gates of its cells, x_proj streamed through a
//   ring of bulk copies (lstm_fwd_mma_kernel).
// - The cluster route (the GRU backward, and its forward from H =
//   kClusterFwdMinH, where Wh's columns or rows fit the blocks of a
//   cluster of at most kClusterMax and the card holds every cluster at
//   once; the GRU phase): a cluster owns a slab of batch rows and all H
//   units, its block k the columns (backward) or rows (forward) of Wh of
//   units [k*JB, k*JB+JB) in shared memory.  Each step a block pushes its
//   units' gate gradients (backward) or new h (forward) into every block's
//   shared memory with st.async, which counts them on the receiver's
//   mbarrier, and each forms its units' next step from its own copy once
//   all have landed.  No grid or cluster barrier a step, no global
//   exchange; clusters never wait for each other (gru_bwd_cluster_kernel,
//   gru_fwd_cluster_kernel).
//
// The backward's weight gradients (dWh and, for the GRU, dbh) sum over all
// T*N rows.  They are not accumulated in the recurrence: a second kernel
// takes them as one product of the saved gate gradients with h_prev (the
// stored ys shifted by one step, h0 first), split over row slabs whose
// partials a third kernel adds in a fixed order.  No float atomics, so every
// output is bit-identical from run to run.
//
// The products are fp32 FMAs on every route but the tensor-core one.
// PERF.md records each route's time on an H100 against its bound.
//
// Built by nvcc into a C-ABI shared library (mxnet_tpu_torch/ops/kernels/
// build.py) and bound with ctypes.  Every launch goes on the caller's
// stream; each function returns a cudaError_t.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"
#include "tf32x3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // threads of every recurrence block
constexpr int kChunk = 64;     // units of gate gradients staged per pass
constexpr int kTile = 64;      // dW product: 64 x 64 outputs per block
constexpr int kTileK = 16;     // dW product: rows per shared-memory stage
constexpr int kInFlight = 8;   // L2 loads a thread issues before it waits
constexpr size_t kSmemBudget = 200 * 1024;  // a recurrence block's plan
constexpr int kRegMaxH = 96;       // register route: widest H
constexpr int kXpAhead = 4;        // register route: steps of x_proj ahead
constexpr int kClusterMax = 16;    // cluster route: blocks (above 8:
                                   // non-portable)
constexpr int kClusterUnits = 32;  // cluster route: the plan's units a block
constexpr int kItems = 2;          // cluster route: (row, unit) items a thread
constexpr int kWInFlight = 16;     // cluster route: Wh loads a thread issues
                                   // before it waits
constexpr int kClusterAhead = 2;   // GRU forward's cluster route: steps of
                                   // x_proj ahead (a step is microseconds)
constexpr int kClusterFwdMinH = 64;  // GRU forward's cluster route: narrowest
                                     // H the plan gives it
constexpr int kMmaRows = 16;       // tensor-core route: rows a block
constexpr int kMmaStages = 4;      // tensor-core route: steps of x_proj ahead
constexpr int kMmaMaxH = 64;       // tensor-core route: widest H (even)
constexpr int kMmaMinN = 896;      // tensor-core route: fewest rows (the
                                   // register route is faster below)
// kClusterFwdMinH is the crossover with the split route's independent
// blocks measured at N=32 (T=35, fp32, on an H100): the split route is
// faster to H=56, the cluster route from H=64 (PERF.md §6).
// kMmaMinN is the crossover measured at DeepAR's width, H=40 (T=96, fp32,
// on an H100).  At other widths it lies elsewhere: N=512-640 at H=32 and
// 64, 640-768 at H=48, 1280-1600 at H=16 (PERF.md §6), so there the
// plan can take a route up to 1.6x slower than the other.

// The routes of mxtt_rnn_plan and the launch entries.
enum Route {
  ROUTE_SPLIT = 0,
  ROUTE_REG = 1,
  ROUTE_CLUSTER = 2,
  ROUTE_MMA = 3
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// The tensor-core route's activations: ex2.approx (__expf) and an
// approximate reciprocal in place of expf and a division, and tanh as
// 2 sigmoid(2x) - 1; a few instructions each, within ~1e-6 of sigmoid_f
// and tanhf (absolute, and relative away from 0), far inside the kernels'
// tolerance over 96 steps.  They made that route 14-42% faster on an H100;
// the register route, latency-bound at DeepAR's training shape, gained
// nothing from them and keeps expf and tanhf (PERF.md).
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

__device__ __forceinline__ float tanh_fast(float x) {
  return 2.f * sigmoid_fast(2.f * x) - 1.f;
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Every block of the grid waits here until all have arrived (the scheme of
// cooperative groups' grid sync).  bar[0] starts at 0 (the wrapper zeroes
// it for each launch); block (0, 0) adds 0x80000000 - (blocks - 1) and
// every other block 1, so when all have arrived the top bit has flipped
// and the low bits are back where they were.  Only valid when every block
// is resident.
__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int nblocks = gridDim.x * gridDim.y;
    const unsigned int add =
        blockIdx.x == 0 && blockIdx.y == 0 ? 0x80000000u - (nblocks - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(bar, add);
    while (((old ^ load_acquire(bar)) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

// The tile of rows and units a block owns.
struct Tile {
  int n0, nn;  // first batch row, rows owned
  int j0, jn;  // first hidden unit, units owned
};

__device__ __forceinline__ Tile block_tile(int N, int H, int NB, int JB) {
  Tile tl;
  tl.j0 = blockIdx.x * JB;
  tl.jn = min(JB, H - tl.j0);
  tl.n0 = blockIdx.y * NB;
  tl.nn = min(NB, N - tl.n0);
  return tl;
}

// w_s[(g*JB + jj)*HP + k] = Wh[g][j0+jj][k]: the rows of the block's
// units, for the forward's h @ Wh[g]^T.
template <int G>
__device__ void load_w_rows(float* w_s, const float* __restrict__ wh, int H,
                            int JB, const Tile& tl) {
  const int HP = H + 1;
  for (int idx = threadIdx.x; idx < G * tl.jn * H; idx += blockDim.x) {
    const int g = idx / (tl.jn * H), r = idx % (tl.jn * H);
    const int jj = r / H, k = r % H;
    w_s[(g * JB + jj) * HP + k] = wh[((size_t)g * H + tl.j0 + jj) * H + k];
  }
}

// w_s[(g*JB + kk)*HP + j] = Wh[g][j][j0+kk]: the columns of the block's
// units, for the backward's dgates @ Wh[g].
template <int G>
__device__ void load_w_cols(float* w_s, const float* __restrict__ wh, int H,
                            int JB, const Tile& tl) {
  const int HP = H + 1;
  for (int idx = threadIdx.x; idx < G * H * tl.jn; idx += blockDim.x) {
    const int g = idx / (H * tl.jn), r = idx % (H * tl.jn);
    const int j = r / tl.jn, kk = r % tl.jn;
    w_s[(g * JB + kk) * HP + j] = wh[((size_t)g * H + j) * H + tl.j0 + kk];
  }
}

// Rows of `cols` floats from global memory (L2, never a stale L1 line) into
// shared memory: row r of src at src + r*src_ld, of dst at dst + r*dst_ld.
// Each thread issues kInFlight loads before it stores any, so a copy costs
// about one L2 latency per kInFlight * blockDim.x values; a thread's
// (row, column) advance by blockDim.x elements without a division.
__device__ void copy_rows_l2(float* dst, int dst_ld,
                             const float* __restrict__ src, size_t src_ld,
                             int rows, int cols) {
  const int step_r = blockDim.x / cols, step_c = blockDim.x % cols;
  int r = threadIdx.x / cols, c = threadIdx.x % cols;
  while (r < rows) {
    float v[kInFlight];
    int rr = r, cc = c;
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      v[u] = rr < rows ? __ldcg(src + (size_t)rr * src_ld + cc) : 0.f;
      rr += step_r;
      cc += step_c;
      if (cc >= cols) {
        cc -= cols;
        ++rr;
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (r < rows) dst[r * dst_ld + c] = v[u];
      r += step_r;
      c += step_c;
      if (c >= cols) {
        c -= cols;
        ++r;
      }
    }
  }
}

// sum_k a[k] * b[k] over k < n, in four interleaved partial sums (k mod 4)
// added at the end, so the FMA chain is a quarter as long.
__device__ __forceinline__ float dot4(const float* a, const float* b, int n) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int k = 0;
  for (; k + 3 < n; k += 4) {
    s0 = fmaf(a[k], b[k], s0);
    s1 = fmaf(a[k + 1], b[k + 1], s1);
    s2 = fmaf(a[k + 2], b[k + 2], s2);
    s3 = fmaf(a[k + 3], b[k + 3], s3);
  }
  for (; k < n; ++k) s0 = fmaf(a[k], b[k], s0);
  return (s0 + s1) + (s2 + s3);
}

// For each (n, g, jj) of the tile: acc = sum_k h_s[n][k] * Wh[g][j0+jj][k]
// (dot4).  The LSTM stores xp + acc in pre_s; the GRU stores
// gh = acc + bh in pre_s and xp in xp_s.  xp (and bh) are loaded before
// the products, so their latency hides behind them.
template <int G, typename T>
__device__ void gate_products(float* pre_s, float* xp_s, const float* h_s,
                              const float* w_s, const T* __restrict__ xp,
                              const float* __restrict__ bh, int t, int N,
                              int H, int JB, const Tile& tl) {
  const int HP = H + 1;
  for (int idx = threadIdx.x; idx < tl.nn * G * tl.jn; idx += blockDim.x) {
    const int n = idx / (G * tl.jn), r = idx % (G * tl.jn);
    const int g = r / tl.jn, jj = r % tl.jn, j = tl.j0 + jj;
    const float x =
        to_f(xp[(((size_t)t * N + tl.n0 + n) * G + g) * H + j]);
    const float b = bh ? bh[g * H + j] : 0.f;
    const float acc = dot4(h_s + n * H, w_s + (g * JB + jj) * HP, H);
    if (bh) {
      pre_s[(n * G + g) * JB + jj] = acc + b;
      xp_s[(n * G + g) * JB + jj] = x;
    } else {
      pre_s[(n * G + g) * JB + jj] = x + acc;
    }
  }
}

// After the step's h is out (in h_s when one tile owns whole rows, else in
// hbuf[slot] behind a grid barrier), bring the rows' h into h_s.
__device__ void exchange_h(float* h_s, const float* hbuf, int slot, int N,
                           int H, const Tile& tl, unsigned int* bar) {
  if (gridDim.x > 1) {
    grid_barrier(bar);
    copy_rows_l2(h_s, H, hbuf + ((size_t)slot * N + tl.n0) * H, H, tl.nn, H);
  }
  __syncthreads();
}

// part_s[(n*G + g)*JB + kk] = sum_j dg[t][n0+n][g][j] * Wh[g][j][j0+kk]
// (dot4 over each chunk, the chunks added in order), staged kChunk units
// at a time from global memory (dg is
// (Tn, N, G, H) fp32; the step's values are complete when this starts).
template <int G>
__device__ void grad_products(float* part_s, float* dg_s,
                              const float* __restrict__ dg, int t, int N,
                              int H, int JB, const float* w_s,
                              const Tile& tl) {
  const int HP = H + 1;
  for (int c0 = 0; c0 < H; c0 += kChunk) {
    const int cw = min(kChunk, H - c0);
    copy_rows_l2(dg_s, kChunk, dg + ((size_t)t * N + tl.n0) * G * H + c0, H,
                 tl.nn * G, cw);
    __syncthreads();
    for (int idx = threadIdx.x; idx < tl.nn * G * tl.jn; idx += blockDim.x) {
      const int n = idx / (G * tl.jn), r = idx % (G * tl.jn);
      const int g = r / tl.jn, kk = r % tl.jn;
      const float acc = dot4(dg_s + (n * G + g) * kChunk,
                             w_s + (g * JB + kk) * HP + c0, cw);
      part_s[(n * G + g) * JB + kk] =
          c0 == 0 ? acc : part_s[(n * G + g) * JB + kk] + acc;
    }
    __syncthreads();
  }
}

// -- LSTM -------------------------------------------------------------------

// xp (Tn, N, 4, H); wh (4, H, H) fp32; h0, c0 (N, H) fp32.  Out: ys (Tn, N,
// H), hn, cn (N, H) in T; gates (Tn, N, 4, H) post-activation and cs (Tn,
// N, H) fp32.  Shared memory: w_s [4][JB][H+1], h_s [NB][H],
// pre_s [NB][4][JB], c_s [NB][JB].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_fwd_kernel(const T* __restrict__ xp, const float* __restrict__ wh,
                    const float* __restrict__ h0,
                    const float* __restrict__ c0, T* __restrict__ ys,
                    T* __restrict__ hn, T* __restrict__ cn,
                    float* __restrict__ gates, float* __restrict__ cs,
                    float* hbuf, unsigned int* bar, int Tn, int N, int H,
                    int NB, int JB) {
  extern __shared__ float smem[];
  const Tile tl = block_tile(N, H, NB, JB);
  float* w_s = smem;
  float* h_s = w_s + 4 * JB * (H + 1);
  float* pre_s = h_s + NB * H;
  float* c_s = pre_s + NB * 4 * JB;
  load_w_rows<4>(w_s, wh, H, JB, tl);
  for (int idx = threadIdx.x; idx < tl.nn * H; idx += blockDim.x)
    h_s[idx] = h0[(size_t)tl.n0 * H + idx];
  for (int idx = threadIdx.x; idx < tl.nn * tl.jn; idx += blockDim.x) {
    const int n = idx / tl.jn, jj = idx % tl.jn;
    c_s[n * JB + jj] = c0[(size_t)(tl.n0 + n) * H + tl.j0 + jj];
  }
  __syncthreads();
  for (int t = 0; t < Tn; ++t) {
    gate_products<4>(pre_s, nullptr, h_s, w_s, xp, nullptr, t, N, H, JB,
                     tl);
    __syncthreads();
    for (int idx = threadIdx.x; idx < tl.nn * tl.jn; idx += blockDim.x) {
      const int n = idx / tl.jn, jj = idx % tl.jn, j = tl.j0 + jj;
      const size_t row = (size_t)t * N + tl.n0 + n;
      const float* p = pre_s + n * 4 * JB + jj;
      const float i = sigmoid_f(p[0]);
      const float f = sigmoid_f(p[JB]);
      const float g = tanhf(p[2 * JB]);
      const float o = sigmoid_f(p[3 * JB]);
      const float c = f * c_s[n * JB + jj] + i * g;
      const float h = o * tanhf(c);
      c_s[n * JB + jj] = c;
      ys[row * H + j] = from_f<T>(h);
      cs[row * H + j] = c;
      float* gr = gates + row * 4 * H + j;
      gr[0] = i;
      gr[H] = f;
      gr[2 * H] = g;
      gr[3 * H] = o;
      if (gridDim.x > 1)
        hbuf[((size_t)((t + 1) & 1) * N + tl.n0 + n) * H + j] = h;
      else
        h_s[n * H + j] = h;
    }
    exchange_h(h_s, hbuf, (t + 1) & 1, N, H, tl, bar);
  }
  for (int idx = threadIdx.x; idx < tl.nn * tl.jn; idx += blockDim.x) {
    const int n = idx / tl.jn, jj = idx % tl.jn;
    const size_t o = (size_t)(tl.n0 + n) * H + tl.j0 + jj;
    hn[o] = from_f<T>(h_s[n * H + tl.j0 + jj]);
    cn[o] = from_f<T>(c_s[n * JB + jj]);
  }
}

// dys (Tn, N, H), gates (Tn, N, 4, H), cs (Tn, N, H), c0, dhn, dcn (N, H),
// wh (4, H, H): all fp32.  Out fp32: dxp (Tn, N, 4, H) (also what the
// blocks exchange), dh0, dc0 (N, H).  Shared memory: w_s [4][JB][H+1],
// dg_s [NB][4][kChunk], part_s [NB][4][JB], dh_s, dc_s [NB][JB].
__global__ void __launch_bounds__(kThreads)
    lstm_bwd_kernel(const float* __restrict__ dys,
                    const float* __restrict__ gates,
                    const float* __restrict__ cs,
                    const float* __restrict__ c0,
                    const float* __restrict__ wh,
                    const float* __restrict__ dhn,
                    const float* __restrict__ dcn, float* dxp,
                    float* __restrict__ dh0, float* __restrict__ dc0,
                    unsigned int* bar, int Tn, int N, int H, int NB,
                    int JB) {
  extern __shared__ float smem[];
  const Tile tl = block_tile(N, H, NB, JB);
  float* w_s = smem;
  float* dg_s = w_s + 4 * JB * (H + 1);
  float* part_s = dg_s + NB * 4 * kChunk;
  float* dh_s = part_s + NB * 4 * JB;
  float* dc_s = dh_s + NB * JB;
  load_w_cols<4>(w_s, wh, H, JB, tl);
  for (int idx = threadIdx.x; idx < tl.nn * tl.jn; idx += blockDim.x) {
    const int n = idx / tl.jn, jj = idx % tl.jn;
    const size_t o = (size_t)(tl.n0 + n) * H + tl.j0 + jj;
    dh_s[n * JB + jj] = dhn[o];
    dc_s[n * JB + jj] = dcn[o];
  }
  __syncthreads();
  for (int t = Tn - 1; t >= 0; --t) {
    for (int idx = threadIdx.x; idx < tl.nn * tl.jn; idx += blockDim.x) {
      const int n = idx / tl.jn, jj = idx % tl.jn, j = tl.j0 + jj;
      const size_t row = (size_t)t * N + tl.n0 + n;
      const float* gr = gates + row * 4 * H + j;
      const float i = gr[0], f = gr[H], g = gr[2 * H], o = gr[3 * H];
      const float c_prev = t > 0 ? cs[(row - N) * H + j]
                                 : c0[(size_t)(tl.n0 + n) * H + j];
      const float dh = dh_s[n * JB + jj] + dys[row * H + j];
      const float tc = tanhf(cs[row * H + j]);
      const float d_o = dh * tc;
      const float dc = dh * o * (1.f - tc * tc) + dc_s[n * JB + jj];
      float* dr = dxp + row * 4 * H + j;
      dr[0] = (dc * g) * i * (1.f - i);
      dr[H] = (dc * c_prev) * f * (1.f - f);
      dr[2 * H] = (dc * i) * (1.f - g * g);
      dr[3 * H] = d_o * o * (1.f - o);
      dc_s[n * JB + jj] = dc * f;
    }
    if (gridDim.x > 1)
      grid_barrier(bar);
    else
      __syncthreads();
    grad_products<4>(part_s, dg_s, dxp, t, N, H, JB, w_s, tl);
    for (int idx = threadIdx.x; idx < tl.nn * tl.jn; idx += blockDim.x) {
      const int n = idx / tl.jn, kk = idx % tl.jn;
      const float* p = part_s + n * 4 * JB + kk;
      dh_s[n * JB + kk] = ((p[0] + p[JB]) + p[2 * JB]) + p[3 * JB];
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < tl.nn * tl.jn; idx += blockDim.x) {
    const int n = idx / tl.jn, jj = idx % tl.jn;
    const size_t o = (size_t)(tl.n0 + n) * H + tl.j0 + jj;
    dh0[o] = dh_s[n * JB + jj];
    dc0[o] = dc_s[n * JB + jj];
  }
}

// -- GRU --------------------------------------------------------------------

// xp (Tn, N, 3, H); wh (3, H, H), bh (3, H), h0 (N, H) fp32.  Out: ys (Tn,
// N, H), hn (N, H) in T; gates (Tn, N, 3, H) = (r, z, n) and hnlin (Tn, N,
// H) = h @ Wh_n^T + bh_n, fp32.  Shared memory: w_s [3][JB][H+1],
// h_s [NB][H], pre_s [NB][3][JB] (gh), xp_s [NB][3][JB].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gru_fwd_kernel(const T* __restrict__ xp, const float* __restrict__ wh,
                   const float* __restrict__ bh,
                   const float* __restrict__ h0, T* __restrict__ ys,
                   T* __restrict__ hn, float* __restrict__ gates,
                   float* __restrict__ hnlin, float* hbuf, unsigned int* bar,
                   int Tn, int N, int H, int NB, int JB) {
  extern __shared__ float smem[];
  const Tile tl = block_tile(N, H, NB, JB);
  float* w_s = smem;
  float* h_s = w_s + 3 * JB * (H + 1);
  float* pre_s = h_s + NB * H;
  float* xp_s = pre_s + NB * 3 * JB;
  load_w_rows<3>(w_s, wh, H, JB, tl);
  for (int idx = threadIdx.x; idx < tl.nn * H; idx += blockDim.x)
    h_s[idx] = h0[(size_t)tl.n0 * H + idx];
  __syncthreads();
  for (int t = 0; t < Tn; ++t) {
    gate_products<3>(pre_s, xp_s, h_s, w_s, xp, bh, t, N, H, JB, tl);
    __syncthreads();
    for (int idx = threadIdx.x; idx < tl.nn * tl.jn; idx += blockDim.x) {
      const int n = idx / tl.jn, jj = idx % tl.jn, j = tl.j0 + jj;
      const size_t row = (size_t)t * N + tl.n0 + n;
      const float* p = pre_s + n * 3 * JB + jj;
      const float* x = xp_s + n * 3 * JB + jj;
      const float gn = p[2 * JB];
      const float r = sigmoid_f(x[0] + p[0]);
      const float z = sigmoid_f(x[JB] + p[JB]);
      const float nv = tanhf(x[2 * JB] + r * gn);
      const float h = (1.f - z) * nv + z * h_s[n * H + j];
      ys[row * H + j] = from_f<T>(h);
      float* gt = gates + row * 3 * H + j;
      gt[0] = r;
      gt[H] = z;
      gt[2 * H] = nv;
      hnlin[row * H + j] = gn;
      if (gridDim.x > 1)
        hbuf[((size_t)((t + 1) & 1) * N + tl.n0 + n) * H + j] = h;
      else
        h_s[n * H + j] = h;
    }
    exchange_h(h_s, hbuf, (t + 1) & 1, N, H, tl, bar);
  }
  for (int idx = threadIdx.x; idx < tl.nn * tl.jn; idx += blockDim.x) {
    const int n = idx / tl.jn, jj = idx % tl.jn;
    hn[(size_t)(tl.n0 + n) * H + tl.j0 + jj] =
        from_f<T>(h_s[n * H + tl.j0 + jj]);
  }
}

// dys (Tn, N, H), gates (Tn, N, 3, H), hnlin (Tn, N, H), h0, dhn (N, H), wh
// (3, H, H): fp32; ys (Tn, N, H) in T, for h_prev as stored.  Out fp32:
// dxp (Tn, N, 3, H) = (dg_r, dg_z, dg_n); dgh (Tn, N, 3, H) = (dg_r, dg_z,
// dg_n * r), the gradient of the recurrent term, which the blocks exchange
// and the dW product reads; dh0 (N, H).  Shared memory: w_s [3][JB][H+1],
// dg_s [NB][3][kChunk], part_s [NB][3][JB], dh_s, dhz_s [NB][JB].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gru_bwd_kernel(const float* __restrict__ dys,
                   const float* __restrict__ gates,
                   const float* __restrict__ hnlin,
                   const T* __restrict__ ys, const float* __restrict__ h0,
                   const float* __restrict__ wh,
                   const float* __restrict__ dhn, float* __restrict__ dxp,
                   float* dgh, float* __restrict__ dh0, unsigned int* bar,
                   int Tn, int N, int H, int NB, int JB) {
  extern __shared__ float smem[];
  const Tile tl = block_tile(N, H, NB, JB);
  float* w_s = smem;
  float* dg_s = w_s + 3 * JB * (H + 1);
  float* part_s = dg_s + NB * 3 * kChunk;
  float* dh_s = part_s + NB * 3 * JB;
  float* dhz_s = dh_s + NB * JB;
  load_w_cols<3>(w_s, wh, H, JB, tl);
  for (int idx = threadIdx.x; idx < tl.nn * tl.jn; idx += blockDim.x) {
    const int n = idx / tl.jn, jj = idx % tl.jn;
    dh_s[n * JB + jj] = dhn[(size_t)(tl.n0 + n) * H + tl.j0 + jj];
  }
  __syncthreads();
  for (int t = Tn - 1; t >= 0; --t) {
    for (int idx = threadIdx.x; idx < tl.nn * tl.jn; idx += blockDim.x) {
      const int n = idx / tl.jn, jj = idx % tl.jn, j = tl.j0 + jj;
      const size_t row = (size_t)t * N + tl.n0 + n;
      const float* gt = gates + row * 3 * H + j;
      const float r = gt[0], z = gt[H], nv = gt[2 * H];
      const float hp = t > 0 ? to_f(ys[(row - N) * H + j])
                             : h0[(size_t)(tl.n0 + n) * H + j];
      const float dh = dh_s[n * JB + jj] + dys[row * H + j];
      const float dn = dh * (1.f - z);
      const float dz = dh * (hp - nv);
      const float dgn = dn * (1.f - nv * nv);
      const float dr = dgn * hnlin[row * H + j];
      const float dgr = dr * r * (1.f - r);
      const float dgz = dz * z * (1.f - z);
      float* dx = dxp + row * 3 * H + j;
      dx[0] = dgr;
      dx[H] = dgz;
      dx[2 * H] = dgn;
      float* dq = dgh + row * 3 * H + j;
      dq[0] = dgr;
      dq[H] = dgz;
      dq[2 * H] = dgn * r;
      dhz_s[n * JB + jj] = dh * z;
    }
    if (gridDim.x > 1)
      grid_barrier(bar);
    else
      __syncthreads();
    grad_products<3>(part_s, dg_s, dgh, t, N, H, JB, w_s, tl);
    for (int idx = threadIdx.x; idx < tl.nn * tl.jn; idx += blockDim.x) {
      const int n = idx / tl.jn, kk = idx % tl.jn;
      const float* p = part_s + n * 3 * JB + kk;
      dh_s[n * JB + kk] = ((dhz_s[n * JB + kk] + p[0]) + p[JB]) + p[2 * JB];
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < tl.nn * tl.jn; idx += blockDim.x) {
    const int n = idx / tl.jn, jj = idx % tl.jn;
    dh0[(size_t)(tl.n0 + n) * H + tl.j0 + jj] = dh_s[n * JB + jj];
  }
}

// -- LSTM forward, register route ---------------------------------------------

// One block per batch row, 4*KP threads (KP = H rounded up to 8): thread
// 4u + q owns gate q (i, f, g, o) of unit u < H and keeps row q*H + u of Wh
// (KP floats, zero past H) in registers for the whole launch.  A step: the
// product with h (float4 broadcasts of h from shared memory, four partial
// sums), the gate's activation, the quad's four gates exchanged by
// __shfl_sync, the cell update in registers (every lane of the quad holds
// the unit's c), h into the other half of a double buffer, one
// __syncthreads.  x_proj of step t + kXpAhead is loaded while step t runs,
// so no global load waits on the step's chain; stores are off it.
template <typename T, int KP>
__global__ void __launch_bounds__(4 * KP)
    lstm_fwd_reg_kernel(const T* __restrict__ xp, const float* __restrict__ wh,
                        const float* __restrict__ h0,
                        const float* __restrict__ c0, T* __restrict__ ys,
                        T* __restrict__ hn, T* __restrict__ cn,
                        float* __restrict__ gates, float* __restrict__ cs,
                        int Tn, int N, int H) {
  __shared__ __align__(16) float h_s[2][KP];
  const int n = blockIdx.x;
  const int u = threadIdx.x >> 2, q = threadIdx.x & 3;
  const int quad = threadIdx.x & 28;  // the quad's first lane in the warp
  const bool live = u < H;
  float w[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k)
    w[k] = live && k < H ? wh[((size_t)q * H + u) * H + k] : 0.f;
  for (int k = threadIdx.x; k < 2 * KP; k += blockDim.x)
    h_s[k / KP][k % KP] = k < H ? h0[(size_t)n * H + k] : 0.f;
  float c = live ? c0[(size_t)n * H + u] : 0.f;
  float h = live ? h0[(size_t)n * H + u] : 0.f;
  const size_t x0 = ((size_t)n * 4 + q) * H + u, xstep = (size_t)N * 4 * H;
  float xr[kXpAhead];
#pragma unroll
  for (int d = 0; d < kXpAhead; ++d)
    xr[d] = live && d < Tn ? to_f(xp[x0 + d * xstep]) : 0.f;
  __syncthreads();
  for (int t0 = 0; t0 < Tn; t0 += kXpAhead) {
#pragma unroll
    for (int d = 0; d < kXpAhead; ++d) {
      const int t = t0 + d;
      if (t >= Tn) break;
      const float x = xr[d];
      if (live && t + kXpAhead < Tn)
        xr[d] = to_f(xp[x0 + (size_t)(t + kXpAhead) * xstep]);
      const float4* hv = reinterpret_cast<const float4*>(h_s[t & 1]);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int k4 = 0; k4 < KP / 4; ++k4) {
        const float4 v = hv[k4];
        a0 = fmaf(w[4 * k4], v.x, a0);
        a1 = fmaf(w[4 * k4 + 1], v.y, a1);
        a2 = fmaf(w[4 * k4 + 2], v.z, a2);
        a3 = fmaf(w[4 * k4 + 3], v.w, a3);
      }
      const float pre = x + ((a0 + a1) + (a2 + a3));
      const float act = q == 2 ? tanhf(pre) : sigmoid_f(pre);
      const float gi = __shfl_sync(0xffffffffu, act, quad);
      const float gf = __shfl_sync(0xffffffffu, act, quad + 1);
      const float gg = __shfl_sync(0xffffffffu, act, quad + 2);
      const float go = __shfl_sync(0xffffffffu, act, quad + 3);
      c = gf * c + gi * gg;
      h = go * tanhf(c);
      if (live) {
        const size_t row = (size_t)t * N + n;
        if (q == 0) h_s[(t + 1) & 1][u] = h;
        gates[(row * 4 + q) * H + u] = act;
        if (q == 1) cs[row * H + u] = c;
        if (q == 2) ys[row * H + u] = from_f<T>(h);
      }
      __syncthreads();
    }
  }
  if (live && q == 0) hn[(size_t)n * H + u] = from_f<T>(h);
  if (live && q == 1) cn[(size_t)n * H + u] = from_f<T>(c);
}

// -- LSTM backward, register route --------------------------------------------

// One block per batch row, 4*KP threads (KP = H rounded up to 8), steps in
// reverse: thread 4u + q owns gate q of unit u and keeps column u of
// Wh[q] (Wh[q][j][u] for j < H, zero past H) in registers for the whole
// launch.  A step: the product of the previous step's gate gradients with
// that column (float4 broadcasts of dgp_q from a double buffer in shared
// memory, rows padded to KP + 4 floats so the quad's four rows take
// distinct banks; four partial sums), the quad's four partials exchanged by
// __shfl_sync and added in a fixed order (dh of unit u, in every lane of
// the quad), dh + dy, dc and the lane's gate gradient, carried in registers
// (every lane of the quad holds the unit's dh and dc); the gradient into
// the other half of the buffer and to dxp, one __syncthreads.  A lane
// loads its own gate, c_prev and dy kXpAhead steps ahead and takes the
// quad's other gates by __shfl_sync (registers are the limit at H = 96);
// cs of the step is c_prev of the one after it; stores are off the chain.
// Same inputs and
// outputs as lstm_bwd_kernel (dxp, dh0, dc0; the dW product follows).
template <int KP>
__global__ void __launch_bounds__(4 * KP)
    lstm_bwd_reg_kernel(const float* __restrict__ dys,
                        const float* __restrict__ gates,
                        const float* __restrict__ cs,
                        const float* __restrict__ c0,
                        const float* __restrict__ wh,
                        const float* __restrict__ dhn,
                        const float* __restrict__ dcn,
                        float* __restrict__ dxp, float* __restrict__ dh0,
                        float* __restrict__ dc0, int Tn, int N, int H) {
  constexpr int DS = KP + 4;
  __shared__ __align__(16) float dg_s[2][4 * DS];
  const int n = blockIdx.x;
  const int u = threadIdx.x >> 2, q = threadIdx.x & 3;
  const int quad = threadIdx.x & 28;  // the quad's first lane in the warp
  const bool live = u < H;
  float w[KP];
#pragma unroll
  for (int j = 0; j < KP; ++j)
    w[j] = live && j < H ? wh[((size_t)q * H + j) * H + u] : 0.f;
  // the ring: the lane's gate, c_prev and dy of step Tn-1-s in slot s % 4
  const size_t gstep = (size_t)N * 4 * H, step = (size_t)N * H;
  const size_t g0 = (size_t)n * 4 * H + u, s0 = (size_t)n * H + u;
  float rq[kXpAhead] = {}, rc[kXpAhead] = {}, rd[kXpAhead] = {};
  auto fetch = [&](int d, int t) {
    rq[d] = gates[t * gstep + g0 + (size_t)q * H];
    rc[d] = t > 0 ? cs[(t - 1) * step + s0] : c0[s0];
    rd[d] = dys[t * step + s0];
  };
#pragma unroll
  for (int d = 0; d < kXpAhead; ++d)
    if (live && d < Tn) fetch(d, Tn - 1 - d);
  float dh = live ? dhn[s0] : 0.f, dc = live ? dcn[s0] : 0.f;
  float c = live && Tn > 0 ? cs[(Tn - 1) * step + s0] : 0.f;  // cs of the step
  // dh of unit u from the gradients of the step after (slot `slot`)
  auto carry = [&](int slot) {
    const float4* gv = reinterpret_cast<const float4*>(dg_s[slot] + q * DS);
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int k4 = 0; k4 < KP / 4; ++k4) {
      const float4 v = gv[k4];
      a0 = fmaf(w[4 * k4], v.x, a0);
      a1 = fmaf(w[4 * k4 + 1], v.y, a1);
      a2 = fmaf(w[4 * k4 + 2], v.z, a2);
      a3 = fmaf(w[4 * k4 + 3], v.w, a3);
    }
    const float p = (a0 + a1) + (a2 + a3);
    const float p0 = __shfl_sync(0xffffffffu, p, quad);
    const float p1 = __shfl_sync(0xffffffffu, p, quad + 1);
    const float p2 = __shfl_sync(0xffffffffu, p, quad + 2);
    const float p3 = __shfl_sync(0xffffffffu, p, quad + 3);
    return ((p0 + p1) + p2) + p3;
  };
  for (int b0 = 0; b0 < Tn; b0 += kXpAhead) {
#pragma unroll
    for (int d = 0; d < kXpAhead; ++d) {
      const int s = b0 + d, t = Tn - 1 - s;
      if (s >= Tn) break;
      const float own = rq[d], cp = rc[d], dy = rd[d];
      if (live && s + kXpAhead < Tn) fetch(d, t - kXpAhead);
      // the quad's four gates, off the chain
      const float i = __shfl_sync(0xffffffffu, own, quad);
      const float f = __shfl_sync(0xffffffffu, own, quad + 1);
      const float g = __shfl_sync(0xffffffffu, own, quad + 2);
      const float o = __shfl_sync(0xffffffffu, own, quad + 3);
      if (s > 0) dh = carry((s - 1) & 1);
      const float dhv = dh + dy;
      const float tc = tanhf(c);
      const float dcv = dhv * o * (1.f - tc * tc) + dc;
      // lstm_bwd_kernel's four expressions, the lane's own
      const float m = q == 0 ? g : q == 1 ? cp : q == 2 ? i : tc;
      const float base = (q == 3 ? dhv : dcv) * m;
      const float dgp =
          q == 2 ? base * (1.f - own * own) : base * own * (1.f - own);
      dc = dcv * f;
      c = cp;
      dg_s[s & 1][q * DS + u] = live ? dgp : 0.f;
      if (live) dxp[t * gstep + g0 + (size_t)q * H] = dgp;
      __syncthreads();
    }
  }
  if (Tn > 0) dh = carry((Tn - 1) & 1);
  if (live && q == 0) dh0[s0] = dh;
  if (live && q == 1) dc0[s0] = dc;
}

// -- LSTM forward, tensor-core route ------------------------------------------

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(mxtt::sm90::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(mxtt::sm90::smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// The shared memory of a tensor-core-route block, in bytes: the ring's
// kMmaStages mbarriers (64 bytes), h [2][kMmaRows][8*KS + 4] fp32 (a double
// buffer; the row stride is 4 mod 8 floats, so a fragment's 32 reads take
// distinct banks), and the x_proj ring [kMmaStages][kMmaRows][4H] in T.
template <typename T>
size_t mma_smem(int KS, int H) {
  return 64 + sizeof(float) * 2 * kMmaRows * (8 * KS + 4) +
         sizeof(T) * (size_t)kMmaStages * kMmaRows * 4 * H;
}

// Blocks of kMmaRows (16) batch rows, KS warps (KS = H/8 rounded up):
// warp w owns units [8w, 8w+8).  A step is the (16 x H) by (H x 4H)
// product on the tensor cores as 3xTF32 mma.sync.m16n8k8 (tf32x3.cuh; h
// split every step, Wh once): warp w's four n-tiles are gate q's columns
// of its 8 units, so lane 4g + t holds all four gates of its cells (rows
// g, g+8; units 8w + 2t, 8w + 2t + 1) in its accumulators, and the cell
// update runs in its registers.  Wh's fragments stay in registers (hi and
// lo), h in a double buffer in shared memory, c in registers; x_proj
// streams in whole steps (the block's rows are contiguous) through a ring
// of bulk copies, kMmaStages steps ahead; one __syncthreads a step.  H is
// even (pairs of units move as float2).
template <typename T, int KS>
__global__ void __launch_bounds__(32 * KS)
    lstm_fwd_mma_kernel(const T* __restrict__ xp, const float* __restrict__ wh,
                        const float* __restrict__ h0,
                        const float* __restrict__ c0, T* __restrict__ ys,
                        T* __restrict__ hn, T* __restrict__ cn,
                        float* __restrict__ gates, float* __restrict__ cs,
                        int Tn, int N, int H) {
  namespace x3 = mxtt::tf32x3;
  namespace sm = mxtt::sm90;
  constexpr int HS = 8 * KS + 4;
  extern __shared__ __align__(16) unsigned char mma_smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(mma_smem_raw);
  float* h_s = reinterpret_cast<float*>(mma_smem_raw + 64);
  T* ring = reinterpret_cast<T*>(mma_smem_raw + 64 +
                                 sizeof(float) * 2 * kMmaRows * HS);
  const int G4 = 4 * H;
  const size_t stage = (size_t)kMmaRows * G4;
  const int n0 = blockIdx.x * kMmaRows, nn = min(kMmaRows, N - n0);
  const uint32_t stage_bytes = (uint32_t)(nn * G4 * sizeof(T));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int u0 = 8 * warp + 2 * tq;  // the lane's units u0, u0 + 1
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMmaStages; ++s) sm::mbar_init(&full[s], 1);
    sm::mbar_init_fence();
  }
  for (int i = threadIdx.x; i < 2 * kMmaRows * HS; i += blockDim.x) {
    const int r = (i / HS) % kMmaRows, k = i % HS;
    h_s[i] = i < kMmaRows * HS && r < nn && k < H
                 ? h0[(size_t)(n0 + r) * H + k]
                 : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < kMmaStages && s < Tn; ++s) {
      sm::mbar_expect_tx(&full[s], stage_bytes);
      bulk_copy(ring + s * stage, xp + ((size_t)s * N + n0) * G4,
                stage_bytes, &full[s]);
    }
  uint32_t bh[KS][4][2], bl[KS][4][2];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int unit = 8 * warp + g, k = 8 * s + tq + 4 * i;
        const float w =
            unit < H && k < H ? wh[((size_t)q * H + unit) * H + k] : 0.f;
        x3::split<true>(w, bh[s][q][i], bl[s][q][i]);
      }
  // the lane's cells e = 2 * half + j: row g + 8 * half, unit u0 + j
  const bool live_u = u0 < H;
  float c[4], h[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), u = u0 + (e & 1);
    const bool live = live_u && r < nn;
    c[e] = live ? c0[(size_t)(n0 + r) * H + u] : 0.f;
    h[e] = live ? h0[(size_t)(n0 + r) * H + u] : 0.f;
  }
  for (int t = 0; t < Tn; ++t) {
    const int st = t % kMmaStages;
    const float* hv = h_s + (t & 1) * kMmaRows * HS;
    float acc[2][4][4];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[p][q][0] = acc[p][q][1] = acc[p][q][2] = acc[p][q][3] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int k = 8 * s + tq;
      const float a[4] = {hv[g * HS + k], hv[(g + 8) * HS + k],
                          hv[g * HS + k + 4], hv[(g + 8) * HS + k + 4]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x3::split<true>(a[i], ah[i], al[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        x3::mma3<true, true>(acc[s & 1][q], ah, al, bh[s][q], bl[s][q]);
    }
    sm::mbar_wait(&full[st], (uint32_t)(t / kMmaStages) & 1u);
    const T* xs = ring + st * stage;
    float* hw = h_s + ((t + 1) & 1) * kMmaRows * HS;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = g + 8 * half;
      const bool live = live_u && r < nn;
      float act[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 x = live ? load2(xs + r * G4 + q * H + u0)
                              : make_float2(0.f, 0.f);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * half + j;
          const float pre =
              (j ? x.y : x.x) + (acc[0][q][e] + acc[1][q][e]);
          act[q][j] = q == 2 ? tanh_fast(pre) : sigmoid_fast(pre);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 2 * half + j;
        c[e] = act[1][j] * c[e] + act[0][j] * act[2][j];
        h[e] = act[3][j] * tanh_fast(c[e]);
      }
      if (live) {
        const int e = 2 * half;
        store2(hw + r * HS + u0, h[e], h[e + 1]);
        const size_t row = (size_t)t * N + n0 + r;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          store2(gates + row * G4 + q * H + u0, act[q][0], act[q][1]);
        store2(cs + row * H + u0, c[e], c[e + 1]);
        store2(ys + row * H + u0, h[e], h[e + 1]);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0 && t + kMmaStages < Tn) {
      sm::mbar_expect_tx(&full[st], stage_bytes);
      bulk_copy(ring + st * stage,
                xp + ((size_t)(t + kMmaStages) * N + n0) * G4, stage_bytes,
                &full[st]);
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g + 8 * half, e = 2 * half;
    if (live_u && r < nn) {
      store2(hn + (size_t)(n0 + r) * H + u0, h[e], h[e + 1]);
      store2(cn + (size_t)(n0 + r) * H + u0, c[e], c[e + 1]);
    }
  }
}

// -- GRU backward, cluster route ----------------------------------------------

// The shared memory of a cluster-route block, in floats from (H, NB, JB),
// then two mbarriers:
// w_s [2*pu][wsp]: w_s[kk][4j + g] = Wh[g][j][j0+kk] for g < 3, 0 for
//   g = 3: a row per owned unit (rows padded to wsp = 4 mod 32 floats, so
//   the float4 reads of 8 neighbouring rows take distinct banks);
// ex [2][nbp][4H]: two exchange slots, each the step's dgh of the slab's
//   rows as (dg_r, dg_z, dg_n * r, 0) per unit, which every block of the
//   cluster writes;
// part [2][s][nbp][2*pu]: the partial sums of the s chunks of the
//   reduction, double-buffered.
// A thread of the product owns units pu and pu + pu_count of one chunk of
// float4 columns and walks the rows rt at a time.
struct ClusterLayout {
  int ws, wsp, pu, s, ch, rt, nbp;
  size_t ex, part, part_slot, bar, bytes;
};

__host__ __device__ inline ClusterLayout cluster_layout(int H, int NB,
                                                        int JB) {
  ClusterLayout L;
  L.ws = 4 * H;
  L.wsp = L.ws + (36 - L.ws % 32) % 32;
  L.pu = (JB + 1) / 2;
  L.s = kThreads / L.pu;
  L.s = L.s < 1 ? 1 : (L.s > H ? H : L.s);
  L.ch = (H + L.s - 1) / L.s;
  L.rt = NB >= 3 ? 4 : NB;
  L.nbp = (NB + L.rt - 1) / L.rt * L.rt;
  L.ex = (size_t)2 * L.pu * L.wsp;
  L.part = L.ex + (size_t)2 * L.nbp * L.ws;
  L.part_slot = (size_t)L.s * L.nbp * 2 * L.pu;
  L.bar = (L.part + 2 * L.part_slot + 1) / 2 * 2;  // 8-byte aligned
  L.bytes = (L.bar + 4) * sizeof(float);
  return L;
}

// part[s][n][kk] = sum over the float4 columns of chunk s of ex[n] .
// w_s[kk], for every row n < nn (rounded up to RT) and both units of each
// thread, two partial sums each added at the end; all in a fixed order.
template <int RT>
__device__ __forceinline__ void cluster_products(float* part,
                                                 const float* w_s,
                                                 const float* ex,
                                                 const ClusterLayout L,
                                                 int nn, int H) {
  for (int it = threadIdx.x; it < L.pu * L.s; it += blockDim.x) {
    const int pu = it % L.pu, s = it / L.pu;
    const int k0 = s * L.ch, k1 = min(k0 + L.ch, H);
    const float4* wa =
        reinterpret_cast<const float4*>(w_s + (size_t)pu * L.wsp);
    const float4* wb =
        reinterpret_cast<const float4*>(w_s + (size_t)(pu + L.pu) * L.wsp);
    for (int r0 = 0; r0 < nn; r0 += RT) {
      float acc[RT][4];
#pragma unroll
      for (int r = 0; r < RT; ++r)
        acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      for (int k = k0; k < k1; ++k) {
        const float4 a = wa[k], b = wb[k];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float4 e =
              reinterpret_cast<const float4*>(ex + (size_t)(r0 + r) * L.ws)[k];
          acc[r][0] = fmaf(e.x, a.x, acc[r][0]);
          acc[r][1] = fmaf(e.y, a.y, acc[r][1]);
          acc[r][2] = fmaf(e.x, b.x, acc[r][2]);
          acc[r][3] = fmaf(e.y, b.y, acc[r][3]);
          acc[r][0] = fmaf(e.z, a.z, acc[r][0]);
          acc[r][2] = fmaf(e.z, b.z, acc[r][2]);
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float* p = part + ((size_t)s * L.nbp + r0 + r) * 2 * L.pu;
        p[pu] = acc[r][0] + acc[r][1];
        p[pu + L.pu] = acc[r][2] + acc[r][3];
      }
    }
  }
}

// A step's inputs of item (row m, unit j): r, z, n, hn_lin, h_prev, dy.
template <typename T>
__device__ __forceinline__ void gru_bwd_fetch(
    float* v, const float* __restrict__ gates,
    const float* __restrict__ hnlin, const T* __restrict__ ys,
    const float* __restrict__ h0, const float* __restrict__ dys, int t,
    int N, int H, int m, int j) {
  const size_t row = (size_t)t * N + m;
  const float* gt = gates + row * 3 * H + j;
  v[0] = gt[0];
  v[1] = gt[H];
  v[2] = gt[2 * H];
  v[3] = hnlin[row * H + j];
  v[4] = t > 0 ? to_f(ys[(row - N) * H + j]) : h0[(size_t)m * H + j];
  v[5] = dys[row * H + j];
}

// A cluster barrier: the arrive releases this thread's earlier memory
// operations to the cluster, the wait acquires the others'.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of `addr` (this block's shared memory) in
// block `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(const void* addr,
                                                 uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(mxtt::sm90::smem_addr(addr)), "r"(rank));
  return out;
}

// 16 bytes into another block's shared memory (shared::cluster address
// `dst`), counted on that block's mbarrier `bar` as complete_tx bytes.
__device__ __forceinline__ void push4(uint32_t dst, float a, float b,
                                      float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "r"(__float_as_uint(a)), "r"(__float_as_uint(b)),
      "r"(__float_as_uint(c)), "r"(__float_as_uint(d)), "r"(bar)
      : "memory");
}

// push4 for one float (4 bytes).
__device__ __forceinline__ void push1(uint32_t dst, float a, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(dst),
      "r"(__float_as_uint(a)), "r"(bar)
      : "memory");
}

// w_s[dst(i)] = val(i) for every i < n: a cluster-route block's slice of
// Wh, kWInFlight loads a thread before it stores any (the prologue is
// latency-bound, up to ~200 KB a block, and at few steps it is most of the
// launch).
template <typename Val, typename Dst>
__device__ __forceinline__ void fill_w(float* w_s, int n, Val val, Dst dst) {
  for (int i0 = threadIdx.x; i0 < n; i0 += kWInFlight * blockDim.x) {
    float v[kWInFlight];
#pragma unroll
    for (int u = 0; u < kWInFlight; ++u) {
      const int idx = i0 + u * blockDim.x;
      v[u] = idx < n ? val(idx) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kWInFlight; ++u) {
      const int idx = i0 + u * blockDim.x;
      if (idx < n) w_s[dst(idx)] = v[u];
    }
  }
}

// Waits for the phase of parity `parity` of this block's mbarrier `bar`,
// acquiring at cluster scope what the pushes released into it.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = mxtt::sm90::smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// The inputs and outputs of gru_bwd_kernel (no bar).  Grid (C, row slabs)
// in clusters of C = ceil(H/JB) blocks along x: the cluster of slab y owns
// rows [y*NB, y*NB+NB), its block k units [k*JB, k*JB+JB).  A step t: each
// block waits on its mbarrier of slot t&1 until all C blocks' pushes of
// step t have landed (nn*H*16 bytes); forms its partial products of the
// slot with its columns of Wh; a __syncthreads; then each (row, unit) item
// of the block (at most kItems a thread; its inputs were loaded a step
// ahead, its dh carried in a register) adds dh*z and the partials in a
// fixed order, forms step t-1's gate gradients, pushes its dgh into slot
// (t-1)&1 of every block of the cluster with st.async (16 bytes, counted
// on that block's mbarrier), writes dxp and dgh, and loads step t-2's
// inputs.  No barrier across blocks a step: a block pushes step t-1 only
// after all of step t has reached it, which every other block sent only
// after it had read step t+1 from the slot now written, so two slots
// suffice.  Cluster barriers only after the mbarriers are set up and
// before exit.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gru_bwd_cluster_kernel(const float* __restrict__ dys,
                           const float* __restrict__ gates,
                           const float* __restrict__ hnlin,
                           const T* __restrict__ ys,
                           const float* __restrict__ h0,
                           const float* __restrict__ wh,
                           const float* __restrict__ dhn,
                           float* __restrict__ dxp, float* __restrict__ dgh,
                           float* __restrict__ dh0, int Tn, int N, int H,
                           int NB, int JB) {
  extern __shared__ __align__(16) float cl_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterLayout L = cluster_layout(H, NB, JB);
  const int C = (H + JB - 1) / JB;
  const int j0 = (int)cluster.block_rank() * JB, jn = min(JB, H - j0);
  const int n0 = blockIdx.y * NB, nn = min(NB, N - n0);
  float* w_s = cl_smem;
  float* ex = cl_smem + L.ex;
  float* part = cl_smem + L.part;
  uint64_t* full = reinterpret_cast<uint64_t*>(cl_smem + L.bar);
  const size_t slot = (size_t)L.nbp * L.ws;
  const uint32_t step_bytes = (uint32_t)nn * H * 16;
  if (threadIdx.x == 0) {
    mxtt::sm90::mbar_init(&full[0], 1);
    mxtt::sm90::mbar_init(&full[1], 1);
    mxtt::sm90::mbar_init_fence();
    for (int t = Tn - 1; t >= 0 && t >= Tn - 2; --t)
      mxtt::sm90::mbar_expect_tx(&full[t & 1], step_bytes);
  }
  // Wh's columns
  const int pu2 = 2 * L.pu;
  fill_w(
      w_s, L.wsp * pu2,
      [&](int idx) {
        const int c = idx / pu2, kk = idx % pu2;
        const int j = c >> 2, g = c & 3;
        return c < L.ws && g < 3 && kk < jn
                   ? wh[((size_t)g * H + j) * H + j0 + kk]
                   : 0.f;
      },
      [&](int idx) { return (idx % pu2) * L.wsp + idx / pu2; });
  for (size_t idx = threadIdx.x; idx < 2 * slot; idx += blockDim.x)
    ex[idx] = 0.f;
  const int items = nn * jn;
  float pf[kItems][6], dh_c[kItems], dhz[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int idx = threadIdx.x + it * blockDim.x;
    dh_c[it] = dhz[it] = 0.f;
    if (idx < items) {
      const int m = n0 + idx / jn, j = j0 + idx % jn;
      dh_c[it] = dhn[(size_t)m * H + j];
      if (Tn > 0)
        gru_bwd_fetch(pf[it], gates, hnlin, ys, h0, dys, Tn - 1, N, H, m, j);
    }
  }
  // every block has started, zeroed its slots and set up its mbarriers
  cluster_barrier();
  // Round t: step t's products and dh (t < Tn), then the items of step
  // t-1 (t > 0): gate gradients from the carried dh and the prefetched
  // inputs, pushed to every block and stored; step t-2's inputs loaded.
  for (int t = Tn; t >= 0; --t) {
    if (t < Tn) {
      mbar_wait_cluster(&full[t & 1], (uint32_t)((Tn - 1 - t) >> 1) & 1u);
      if (threadIdx.x == 0 && t >= 2)  // the slot's next use: step t-2
        mxtt::sm90::mbar_expect_tx(&full[t & 1], step_bytes);
      float* part_t = part + (t & 1) * L.part_slot;
      const float* ex_t = ex + (t & 1) * slot;
      if (L.rt == 1)
        cluster_products<1>(part_t, w_s, ex_t, L, nn, H);
      else if (L.rt == 2)
        cluster_products<2>(part_t, w_s, ex_t, L, nn, H);
      else
        cluster_products<4>(part_t, w_s, ex_t, L, nn, H);
      __syncthreads();
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int idx = threadIdx.x + it * blockDim.x;
        if (idx >= items) continue;
        const int n = idx / jn, kk = idx % jn;
        float v = dhz[it];
        for (int s = 0; s < L.s; ++s)
          v += part_t[((size_t)s * L.nbp + n) * 2 * L.pu + kk];
        dh_c[it] = v;
      }
    }
    if (t == 0) break;
    const int u = t - 1;  // the items' step
    float* ex_u = ex + (u & 1) * slot;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int idx = threadIdx.x + it * blockDim.x;
      if (idx >= items) continue;
      const int n = idx / jn, j = j0 + idx % jn;
      const float r = pf[it][0], z = pf[it][1], nv = pf[it][2];
      const float hl = pf[it][3], hp = pf[it][4];
      const float dh = dh_c[it] + pf[it][5];
      const float dn = dh * (1.f - z);
      const float dz = dh * (hp - nv);
      const float dgn = dn * (1.f - nv * nv);
      const float dr = dgn * hl;
      const float dgr = dr * r * (1.f - r);
      const float dgz = dz * z * (1.f - z);
      const float dq = dgn * r;
      dhz[it] = dh * z;
      const float* e = ex_u + (size_t)n * L.ws + 4 * j;
      for (int p = 0; p < C; ++p)
        push4(cluster_addr(e, p), dgr, dgz, dq, 0.f,
              cluster_addr(&full[u & 1], p));
      const size_t row = (size_t)u * N + n0 + n;
      float* dx = dxp + row * 3 * H + j;
      dx[0] = dgr;
      dx[H] = dgz;
      dx[2 * H] = dgn;
      float* dg = dgh + row * 3 * H + j;
      dg[0] = dgr;
      dg[H] = dgz;
      dg[2 * H] = dq;
      if (u > 0)
        gru_bwd_fetch(pf[it], gates, hnlin, ys, h0, dys, u - 1, N, H,
                      n0 + n, j);
    }
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int idx = threadIdx.x + it * blockDim.x;
    if (idx < items)
      dh0[(size_t)(n0 + idx / jn) * H + j0 + idx % jn] = dh_c[it];
  }
  cluster_barrier();  // no push to or from this block is still in flight
}

// -- GRU forward, cluster route -----------------------------------------------

// The shared memory of a forward cluster-route block, in floats from (H,
// NB, JB), then two mbarriers:
// w_s [JB][3][wp]: w_s[jj][g][k] = Wh[g][j0+jj][k], zero past H: the rows
//   of the owned units (wp = hk, plus 4 where hk is a multiple of 8, so the
//   float4 reads of 8 neighbouring units take distinct banks);
// ex [2][nbp][hk]: two exchange slots, each the h of the slab's rows that
//   enters a step (hk = H rounded up to 4, zero past H), which every block
//   of the cluster writes;
// part [2][s][nbp][3][JB]: the partial sums of the s chunks of the
//   reduction over k, double-buffered.
// A thread of the product owns one unit and one chunk of ch float4
// columns, and walks the rows rt at a time.
struct ClusterFwdLayout {
  int hk, wp, s, ch, rt, nbp;
  size_t ex, part, part_slot, bar, bytes;
};

__host__ __device__ inline ClusterFwdLayout cluster_fwd_layout(int H, int NB,
                                                               int JB) {
  ClusterFwdLayout L;
  L.hk = (H + 3) / 4 * 4;
  L.wp = L.hk % 8 ? L.hk : L.hk + 4;
  const int k4 = L.hk / 4;
  int s = kThreads / JB;
  s = s < 1 ? 1 : (s > k4 ? k4 : s);
  L.ch = (k4 + s - 1) / s;
  L.s = (k4 + L.ch - 1) / L.ch;  // no empty chunk
  L.rt = NB >= 3 ? 4 : NB;
  L.nbp = (NB + L.rt - 1) / L.rt * L.rt;
  L.ex = (size_t)JB * 3 * L.wp;
  L.part = L.ex + (size_t)2 * L.nbp * L.hk;
  L.part_slot = (size_t)L.s * L.nbp * 3 * JB;
  L.bar = (L.part + 2 * L.part_slot + 1) / 2 * 2;  // 8-byte aligned
  L.bytes = (L.bar + 4) * sizeof(float);
  return L;
}

// part[s][n][g][jj] = sum over the float4 columns of chunk s of ex[n] .
// w_s[jj][g], for every row n < nn (rounded up to RT), every unit jj < JB
// and the three gates, two partial sums each added at the end; all in a
// fixed order.
template <int RT>
__device__ __forceinline__ void cluster_fwd_products(
    float* part, const float* w_s, const float* ex, const ClusterFwdLayout L,
    int nn, int JB) {
  const int k4 = L.hk / 4, wq = L.wp / 4;
  for (int it = threadIdx.x; it < JB * L.s; it += blockDim.x) {
    const int jj = it % JB, s = it / JB;
    const int k0 = s * L.ch, k1 = min(k0 + L.ch, k4);
    const float4* wr =
        reinterpret_cast<const float4*>(w_s + (size_t)jj * 3 * L.wp);
    for (int r0 = 0; r0 < nn; r0 += RT) {
      float acc[RT][3][2];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int g = 0; g < 3; ++g) acc[r][g][0] = acc[r][g][1] = 0.f;
      for (int k = k0; k < k1; ++k) {
        const float4 w[3] = {wr[k], wr[wq + k], wr[2 * wq + k]};
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float4 h =
              reinterpret_cast<const float4*>(ex + (size_t)(r0 + r) * L.hk)[k];
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            acc[r][g][0] = fmaf(h.x, w[g].x, acc[r][g][0]);
            acc[r][g][1] = fmaf(h.y, w[g].y, acc[r][g][1]);
          }
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            acc[r][g][0] = fmaf(h.z, w[g].z, acc[r][g][0]);
            acc[r][g][1] = fmaf(h.w, w[g].w, acc[r][g][1]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          part[((size_t)(s * L.nbp + r0 + r) * 3 + g) * JB + jj] =
              acc[r][g][0] + acc[r][g][1];
    }
  }
}

// The inputs and outputs of gru_fwd_kernel (no hbuf, no bar).  Grid (C,
// row slabs) in clusters of C = ceil(H/JB) blocks along x: the cluster of
// slab y owns rows [y*NB, y*NB+NB), its block k units [k*JB, k*JB+JB).
// Slot 0 of every block starts as the slab's h0; h_t for t >= 1 lands in
// slot t&1.  A step t: each block waits on its mbarrier of slot t&1 until
// all C blocks' pushes of h_t have landed (nn*H*4 bytes; not at t = 0),
// forms its partial products of the slot with its rows of Wh, a
// __syncthreads, then each (row, unit) item of the block (at most kItems a
// thread, its h carried in a register) adds the partials and bh in a fixed
// order, takes the activations with x_proj loaded kClusterAhead steps
// before, pushes h_{t+1} into slot (t+1)&1 of every block of the cluster
// with st.async (4 bytes, counted on that block's mbarrier), then stores
// ys, gates and hnlin.  No barrier across blocks a step: a block pushes
// h_{t+2} only after all of h_{t+1} has reached it, which every other
// block sent only after its products of step t had read the slot now
// written, so two slots suffice (and two buffers of partials, the
// __syncthreads of step t+1 lying between the reads of step t and the
// writes of step t+2).  Cluster barriers only after the set-up and before
// exit.  The launch bounds state at least one block an SM: without it
// nvcc held some instantiations to 80 registers and spilled.
template <typename T, int RT>
__global__ void __launch_bounds__(kThreads, 1)
    gru_fwd_cluster_kernel(const T* __restrict__ xp,
                           const float* __restrict__ wh,
                           const float* __restrict__ bh,
                           const float* __restrict__ h0, T* __restrict__ ys,
                           T* __restrict__ hn, float* __restrict__ gates,
                           float* __restrict__ hnlin, int Tn, int N, int H,
                           int NB, int JB) {
  extern __shared__ __align__(16) float cl_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterFwdLayout L = cluster_fwd_layout(H, NB, JB);
  const int C = (H + JB - 1) / JB;
  const int j0 = (int)cluster.block_rank() * JB, jn = min(JB, H - j0);
  const int n0 = blockIdx.y * NB, nn = min(NB, N - n0);
  float* w_s = cl_smem;
  float* ex = cl_smem + L.ex;
  float* part = cl_smem + L.part;
  uint64_t* full = reinterpret_cast<uint64_t*>(cl_smem + L.bar);
  const size_t slot = (size_t)L.nbp * L.hk;
  const uint32_t step_bytes = (uint32_t)nn * H * 4;
  if (threadIdx.x == 0) {
    mxtt::sm90::mbar_init(&full[0], 1);
    mxtt::sm90::mbar_init(&full[1], 1);
    mxtt::sm90::mbar_init_fence();
    for (int t = 1; t <= 2 && t < Tn; ++t)  // h_1 and h_2
      mxtt::sm90::mbar_expect_tx(&full[t & 1], step_bytes);
  }
  // Wh's rows of the owned units
  fill_w(
      w_s, JB * 3 * L.wp,
      [&](int idx) {
        const int row = idx / L.wp, k = idx % L.wp;
        const int jj = row / 3, g = row % 3;
        return jj < jn && k < H ? wh[((size_t)g * H + j0 + jj) * H + k] : 0.f;
      },
      [](int idx) { return idx; });
  for (int idx = threadIdx.x; idx < (int)(2 * slot); idx += blockDim.x) {
    const int n = idx / L.hk, k = idx % L.hk;  // slot 0's rows come first
    ex[idx] = n < nn && k < H ? h0[(size_t)(n0 + n) * H + k] : 0.f;
  }
  const int items = nn * jn;
  // x_proj of steps t .. t + kClusterAhead - 1 in xr[it][0 ..]: a step
  // shifts the ring by one and loads the step kClusterAhead ahead, so each
  // move reads a load issued a step (microseconds) before
  float hc[kItems], bz[kItems][3];
  T xr[kItems][kClusterAhead][3];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int idx = threadIdx.x + it * blockDim.x;
    hc[it] = 0.f;
    if (idx < items) {
      const int m = n0 + idx / jn, j = j0 + idx % jn;
      hc[it] = h0[(size_t)m * H + j];
#pragma unroll
      for (int g = 0; g < 3; ++g) bz[it][g] = bh[g * H + j];
#pragma unroll
      for (int d = 0; d < kClusterAhead; ++d)
        if (d < Tn)
#pragma unroll
          for (int g = 0; g < 3; ++g)
            xr[it][d][g] = xp[(((size_t)d * N + m) * 3 + g) * H + j];
    }
  }
  // every block has started, filled its slots and set up its mbarriers
  cluster_barrier();
  for (int t = 0; t < Tn; ++t) {
    if (t > 0) {
      mbar_wait_cluster(&full[t & 1], (uint32_t)((t - 1) >> 1) & 1u);
      if (threadIdx.x == 0 && t + 2 < Tn)  // the slot's next use: h_{t+2}
        mxtt::sm90::mbar_expect_tx(&full[t & 1], step_bytes);
    }
    float* part_t = part + (t & 1) * L.part_slot;
    cluster_fwd_products<RT>(part_t, w_s, ex + (t & 1) * slot, L, nn, JB);
    __syncthreads();
    float* ex_u = ex + ((t + 1) & 1) * slot;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int idx = threadIdx.x + it * blockDim.x;
      if (idx >= items) continue;
      const int n = idx / jn, jj = idx % jn, j = j0 + jj;
      float gh[3];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        float v = 0.f;
        for (int s = 0; s < L.s; ++s)
          v += part_t[((size_t)(s * L.nbp + n) * 3 + g) * JB + jj];
        gh[g] = v + bz[it][g];
      }
      const float x0 = to_f(xr[it][0][0]), x1 = to_f(xr[it][0][1]);
      const float x2 = to_f(xr[it][0][2]);
      const size_t row = (size_t)t * N + n0 + n;
#pragma unroll
      for (int d = 0; d + 1 < kClusterAhead; ++d)
#pragma unroll
        for (int g = 0; g < 3; ++g) xr[it][d][g] = xr[it][d + 1][g];
      if (t + kClusterAhead < Tn)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          xr[it][kClusterAhead - 1][g] =
              xp[((row + (size_t)kClusterAhead * N) * 3 + g) * H + j];
      const float r = sigmoid_f(x0 + gh[0]);
      const float z = sigmoid_f(x1 + gh[1]);
      const float nv = tanhf(x2 + r * gh[2]);
      const float h = (1.f - z) * nv + z * hc[it];
      hc[it] = h;
      if (t + 1 < Tn) {
        const float* e = ex_u + (size_t)n * L.hk + j;
        for (int p = 0; p < C; ++p)
          push1(cluster_addr(e, p), h, cluster_addr(&full[(t + 1) & 1], p));
      }
      ys[row * H + j] = from_f<T>(h);
      float* gt = gates + row * 3 * H + j;
      gt[0] = r;
      gt[H] = z;
      gt[2 * H] = nv;
      hnlin[row * H + j] = gh[2];
    }
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int idx = threadIdx.x + it * blockDim.x;
    if (idx < items)
      hn[(size_t)(n0 + idx / jn) * H + j0 + idx % jn] = from_f<T>(hc[it]);
  }
  cluster_barrier();  // no push to or from this block is still in flight
}

// -- weight gradients ---------------------------------------------------------

// part[slab][r][k] = sum over rows m of the slab, in order, of A[m][r] *
// B[m][k], for r < R = G*H and k < KC = H (+1 with the bias column, B = 1).
// A is the (M, R) gate-gradient matrix (M = Tn*N); B[m] is h_prev of row m:
// h0[m] for m < N, else ys[m - N] as stored.  A 64x64 output tile per block,
// 4x4 per thread, 16 rows per stage.
template <typename T>
__global__ void __launch_bounds__(256)
    dw_partial_kernel(const float* __restrict__ A,
                      const float* __restrict__ h0, const T* __restrict__ ys,
                      float* __restrict__ part, long long M, int N, int R,
                      int H, int KC, long long rows_per_slab) {
  __shared__ float a_s[kTileK][kTile];
  __shared__ float b_s[kTileK][kTile];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile;
  const long long m0 = (long long)blockIdx.z * rows_per_slab;
  const long long m1 = min(M, m0 + rows_per_slab);
  float acc[4][4] = {};
  for (long long mb = m0; mb < m1; mb += kTileK) {
    for (int idx = threadIdx.x; idx < kTileK * kTile; idx += blockDim.x) {
      const int mm = idx / kTile, c = idx % kTile;
      const long long m = mb + mm;
      const bool row_ok = m < m1;
      const int r = r0 + c, k = k0 + c;
      a_s[mm][c] = row_ok && r < R ? A[m * R + r] : 0.f;
      float b = 0.f;
      if (row_ok && k < H)
        b = m < N ? h0[m * H + k] : to_f(ys[(m - N) * H + k]);
      else if (row_ok && k < KC)
        b = 1.f;
      b_s[mm][c] = b;
    }
    __syncthreads();
    for (int mm = 0; mm < kTileK; ++mm) {
      float a[4], b[4];
      for (int i = 0; i < 4; ++i) a[i] = a_s[mm][ty * 4 + i];
      for (int j = 0; j < 4; ++j) b[j] = b_s[mm][tx * 4 + j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= R) continue;
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      if (k < KC) part[((size_t)blockIdx.z * R + r) * KC + k] = acc[i][j];
    }
  }
}

// dw[r][k] = sum_p part[p][r][k] for k < H, dbias[r] the same for k = H:
// the P slabs added in order.
__global__ void dw_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ dw,
                                 float* __restrict__ dbias, int P, int R,
                                 int H, int KC) {
  const long long total = (long long)R * KC;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += part[(long long)p * total + idx];
    const int r = (int)(idx / KC), k = (int)(idx % KC);
    if (k < H)
      dw[(long long)r * H + k] = s;
    else
      dbias[r] = s;
  }
}

template <typename T>
cudaError_t launch_dw(const float* A, const float* h0, const void* ys,
                      float* part, float* dw, float* dbias, long long M,
                      int N, int G, int H, int P, cudaStream_t stream) {
  const int R = G * H, KC = dbias ? H + 1 : H;
  const long long rows = (M + P - 1) / P;
  const dim3 grid((unsigned)((R + kTile - 1) / kTile),
                  (unsigned)((KC + kTile - 1) / kTile), (unsigned)P);
  dw_partial_kernel<T><<<grid, 256, 0, stream>>>(
      A, h0, static_cast<const T*>(ys), part, M, N, R, H, KC, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = (long long)R * KC;
  const unsigned blocks = (unsigned)min((total + 255) / 256, 4096LL);
  dw_reduce_kernel<<<blocks, 256, 0, stream>>>(part, dw, dbias, P, R, H, KC);
  return cudaGetLastError();
}

// -- launches -----------------------------------------------------------------

// Shared memory of each recurrence kernel, in bytes (the layouts above).
size_t fwd_smem(int G, int H, int NB, int JB, bool lstm) {
  return sizeof(float) * ((size_t)G * JB * (H + 1) + (size_t)NB * H +
                          (size_t)NB * G * JB * (lstm ? 1 : 2) +
                          (lstm ? (size_t)NB * JB : 0));
}

size_t bwd_smem(int G, int H, int NB, int JB) {
  return sizeof(float) * ((size_t)G * JB * (H + 1) + (size_t)NB * G * kChunk +
                          (size_t)NB * G * JB + 2 * (size_t)NB * JB);
}

// Launch a recurrence kernel over (ut unit tiles) x (bt row tiles).  One
// unit tile: a normal launch.  Several: every block must be resident for
// the grid barrier, so the occupancy API is asked first and the launch is
// cooperative.  The arguments take the kernel's own parameter types, so
// the cooperative launch's argument array points at values of those types.
template <typename T>
struct same_type {
  using type = T;
};

template <typename... KArgs>
cudaError_t launch_recurrence(void (*kernel)(KArgs...), int ut, int bt,
                              size_t smem, cudaStream_t stream,
                              typename same_type<KArgs>::type... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)ut, (unsigned)bt);
  if (ut == 1) {
    kernel<<<grid, kThreads, smem, stream>>>(args...);
    return cudaGetLastError();
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if ((long long)per_sm * sms < (long long)ut * bt)
    return cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {static_cast<void*>(&args)...};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     grid, dim3(kThreads), params, smem,
                                     stream);
}

int tiles(int total, int per) { return (total + per - 1) / per; }

// The split route's plan of a recurrence kernel (G = 4: LSTM, 3: GRU;
// forward or backward) on a device with `sms` SMs: NB batch rows and JB
// hidden units per block.  Where one block holds all of Wh (JB = H),
// blocks own whole rows, need no exchange, and take about 4 blocks per SM.
// Otherwise a block's rows are as many as fit half the budget and the
// units are split so that every block has an SM of its own, so all are
// resident for the grid barrier.
cudaError_t plan_split(int G, bool backward, int N, int H, int sms,
                       size_t budget, int* NB_out, int* JB_out) {
  auto smem = [&](int nb, int jb) {
    return backward ? bwd_smem(G, H, nb, jb) : fwd_smem(G, H, nb, jb, G == 4);
  };
  int NB, JB = H;
  if (smem(1, H) <= budget) {
    NB = tiles(N, 4 * sms);
    while (NB > 1 && smem(NB, H) > budget) NB = tiles(NB, 2);
  } else {
    NB = N;
    while (NB > 1 && sizeof(float) * NB * (size_t)H > budget / 2)
      NB = tiles(NB, 2);
    JB = tiles(H, std::max(1, sms / tiles(N, NB)));
    if ((long long)tiles(N, NB) * tiles(H, JB) > sms)
      return cudaErrorInvalidConfiguration;
  }
  if (smem(NB, JB) > budget || tiles(N, NB) > 65535)
    return cudaErrorInvalidConfiguration;
  *NB_out = NB;
  *JB_out = JB;
  return cudaSuccess;
}

bool bad_plan(int Tn, int N, int H, int NB, int JB) {
  return Tn < 0 || N < 1 || H < 1 || NB < 1 || JB < 1 || JB > H ||
         tiles(N, NB) > 65535;
}

// A cluster-route block's shared memory, backward or forward layout.
size_t cluster_smem(bool backward, int H, int NB, int JB) {
  return backward ? cluster_layout(H, NB, JB).bytes
                  : cluster_fwd_layout(H, NB, JB).bytes;
}

// Whether (NB, JB) is a cluster-route plan of (N, H) within `budget`
// bytes of shared memory a block.
bool cluster_fits(bool backward, int N, int H, int NB, int JB,
                  size_t budget) {
  return NB >= 1 && JB >= 1 && JB <= H && N >= 1 &&
         tiles(H, JB) <= kClusterMax &&
         (long long)NB * JB <= (long long)kItems * kThreads &&
         tiles(N, NB) <= 65535 && cluster_smem(backward, H, NB, JB) <= budget;
}

// The forward cluster kernel for rows walked rt at a time.
template <typename T>
auto gru_fwd_cluster_for(int rt) {
  return rt == 1   ? gru_fwd_cluster_kernel<T, 1>
         : rt == 2 ? gru_fwd_cluster_kernel<T, 2>
                   : gru_fwd_cluster_kernel<T, 4>;
}

// The launch configuration of a cluster-route kernel over C x rows blocks
// in clusters of C, and the clusters the device can hold at once.
template <typename K>
cudaError_t cluster_config(K* kernel, int C, int rows, size_t smem,
                           cudaStream_t stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr, int* active) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)C, (unsigned)rows);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(active, kernel, cfg);
}

// The cluster route's plan of the GRU backward or forward: the smallest
// cluster (a power of two up to kClusterMax) whose blocks own at most
// kClusterUnits units each (any number at kClusterMax) and fit `budget`,
// and whose clusters the device holds all at once; NB rows a cluster so
// that the clusters' blocks about cover the SMs, fewer where the shared
// memory or kItems a thread ask for it.  cudaErrorInvalidConfiguration
// where none fits.
cudaError_t plan_cluster(bool backward, int N, int H, int sms, size_t budget,
                         int* NB_out, int* JB_out) {
  for (int c = 1; c <= kClusterMax; c *= 2) {
    const int JB = tiles(H, c);
    if (JB > kClusterUnits && c < kClusterMax) continue;
    const int C = tiles(H, JB);
    int NB = std::max(1, std::min(N, tiles(N * C, sms)));
    while (NB > 1 && !cluster_fits(backward, N, H, NB, JB, budget))
      NB = tiles(NB, 2);
    if (!cluster_fits(backward, N, H, NB, JB, budget)) continue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int active = 0;
    const size_t smem = cluster_smem(backward, H, NB, JB);
    cudaError_t err =
        backward
            ? cluster_config(gru_bwd_cluster_kernel<float>, C, 1, smem,
                             nullptr, &cfg, &attr, &active)
            : cluster_config(
                  gru_fwd_cluster_for<float>(cluster_fwd_layout(H, NB, JB).rt),
                  C, 1, smem, nullptr, &cfg, &attr, &active);
    if (err != cudaSuccess) return err;
    // every cluster resident at once: a second wave would pay the T
    // steps' latency again (slower than the split route on an H100)
    if ((long long)active < tiles(N, NB)) continue;
    *NB_out = NB;
    *JB_out = JB;
    return cudaSuccess;
  }
  return cudaErrorInvalidConfiguration;
}

// The plan of a recurrence kernel on the current device: its route, NB
// batch rows a block (a cluster, on the cluster route) and JB hidden units
// a block.  want < 0 takes the kernel's own choice: for the LSTM forward
// the tensor-core route at N >= kMmaMinN and even H <= kMmaMaxH, else the
// register route at H <= kRegMaxH; the register route for the LSTM
// backward at H <= kRegMaxH; the cluster route for the GRU backward, and
// for the GRU forward at H >= kClusterFwdMinH, where plan_cluster finds
// one; else the split route.  want >= 0 asks for that
// route.  Returns cudaSuccess, cudaErrorInvalidConfiguration where the
// route has no plan for the kernel and size, or the error of a device
// query.
cudaError_t plan_recurrence(int G, bool backward, int N, int H, int want,
                            int* route, int* NB_out, int* JB_out) {
  if (N < 1 || H < 1 || (G != 3 && G != 4) || want > ROUTE_MMA)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  const size_t budget = std::min(kSmemBudget, (size_t)optin);
  const bool lstm_fwd = G == 4 && !backward, gru = G == 3;
  const bool mma_ok = lstm_fwd && H <= kMmaMaxH && H % 2 == 0;
  if (want == ROUTE_MMA || (want < 0 && mma_ok && N >= kMmaMinN)) {
    if (!mma_ok) return cudaErrorInvalidConfiguration;
    *route = ROUTE_MMA;
    *NB_out = kMmaRows;
    *JB_out = H;
    return cudaSuccess;
  }
  if (want == ROUTE_REG || (want < 0 && !gru && H <= kRegMaxH)) {
    if (gru || H > kRegMaxH) return cudaErrorInvalidConfiguration;
    *route = ROUTE_REG;
    *NB_out = 1;
    *JB_out = H;
    return cudaSuccess;
  }
  if (want == ROUTE_CLUSTER ||
      (want < 0 && gru && (backward || H >= kClusterFwdMinH))) {
    if (!gru) return cudaErrorInvalidConfiguration;
    err = plan_cluster(backward, N, H, sms, budget, NB_out, JB_out);
    if (err == cudaSuccess) *route = ROUTE_CLUSTER;
    if (err != cudaErrorInvalidConfiguration || want == ROUTE_CLUSTER)
      return err;
  }
  *route = ROUTE_SPLIT;
  return plan_split(G, backward, N, H, sms, budget, NB_out, JB_out);
}

template <typename T>
cudaError_t lstm_fwd(const void* xp, const float* wh, const float* h0,
                     const float* c0, void* ys, void* hn, void* cn,
                     float* gates, float* cs, float* hbuf, unsigned int* bar,
                     int Tn, int N, int H, int NB, int JB,
                     cudaStream_t stream) {
  return launch_recurrence(
      lstm_fwd_kernel<T>, tiles(H, JB), tiles(N, NB),
      fwd_smem(4, H, NB, JB, true), stream, static_cast<const T*>(xp), wh,
      h0, c0, static_cast<T*>(ys), static_cast<T*>(hn), static_cast<T*>(cn),
      gates, cs, hbuf, bar, Tn, N, H, NB, JB);
}

// f(std::integral_constant<int, KP>()) for KP = H rounded up to 8, the
// register routes' instantiations (H <= kRegMaxH), then the launch's error.
template <typename F>
cudaError_t reg_dispatch(int H, F&& f) {
#define MXTT_REG_CASE(KP)                  \
  case KP:                                 \
    f(std::integral_constant<int, KP>());  \
    break;
  switch ((H + 7) / 8 * 8) {
    MXTT_REG_CASE(8)
    MXTT_REG_CASE(16)
    MXTT_REG_CASE(24)
    MXTT_REG_CASE(32)
    MXTT_REG_CASE(40)
    MXTT_REG_CASE(48)
    MXTT_REG_CASE(56)
    MXTT_REG_CASE(64)
    MXTT_REG_CASE(72)
    MXTT_REG_CASE(80)
    MXTT_REG_CASE(88)
    MXTT_REG_CASE(96)
    default:
      return cudaErrorInvalidValue;
  }
#undef MXTT_REG_CASE
  return cudaGetLastError();
}

// The register routes over N blocks of 4*KP threads.
template <typename T>
cudaError_t lstm_fwd_reg(const void* xp, const float* wh, const float* h0,
                         const float* c0, void* ys, void* hn, void* cn,
                         float* gates, float* cs, int Tn, int N, int H,
                         cudaStream_t stream) {
  return reg_dispatch(H, [&](auto kp) {
    constexpr int KP = decltype(kp)::value;
    lstm_fwd_reg_kernel<T, KP><<<(unsigned)N, 4 * KP, 0, stream>>>(
        static_cast<const T*>(xp), wh, h0, c0, static_cast<T*>(ys),
        static_cast<T*>(hn), static_cast<T*>(cn), gates, cs, Tn, N, H);
  });
}

cudaError_t lstm_bwd_reg(const float* dys, const float* gates, const float* cs,
                         const float* c0, const float* wh, const float* dhn,
                         const float* dcn, float* dxp, float* dh0, float* dc0,
                         int Tn, int N, int H, cudaStream_t stream) {
  return reg_dispatch(H, [&](auto kp) {
    constexpr int KP = decltype(kp)::value;
    lstm_bwd_reg_kernel<KP><<<(unsigned)N, 4 * KP, 0, stream>>>(
        dys, gates, cs, c0, wh, dhn, dcn, dxp, dh0, dc0, Tn, N, H);
  });
}

// The tensor-core route over N/16 blocks of 32*KS threads, KS = H/8
// rounded up.
template <typename T>
cudaError_t lstm_fwd_mma(const void* xp, const float* wh, const float* h0,
                         const float* c0, void* ys, void* hn, void* cn,
                         float* gates, float* cs, int Tn, int N, int H,
                         cudaStream_t stream) {
  const int KS = (H + 7) / 8;
  const size_t smem = mma_smem<T>(KS, H);
  const unsigned grid = (unsigned)tiles(N, kMmaRows);
  cudaError_t err;
#define MXTT_MMA_CASE(K)                                                     \
  case K:                                                                    \
    err = cudaFuncSetAttribute(lstm_fwd_mma_kernel<T, K>,                    \
                               cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                               (int)smem);                                   \
    if (err != cudaSuccess) return err;                                      \
    lstm_fwd_mma_kernel<T, K><<<grid, 32 * K, smem, stream>>>(               \
        static_cast<const T*>(xp), wh, h0, c0, static_cast<T*>(ys),          \
        static_cast<T*>(hn), static_cast<T*>(cn), gates, cs, Tn, N, H);      \
    break;
  switch (KS) {
    MXTT_MMA_CASE(1)
    MXTT_MMA_CASE(2)
    MXTT_MMA_CASE(3)
    MXTT_MMA_CASE(4)
    MXTT_MMA_CASE(5)
    MXTT_MMA_CASE(6)
    MXTT_MMA_CASE(7)
    MXTT_MMA_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef MXTT_MMA_CASE
  return cudaGetLastError();
}

// The GRU forward's recurrence on the cluster route, checked as
// gru_bwd_cluster below.
template <typename T>
cudaError_t gru_fwd_cluster(const void* xp, const float* wh, const float* bh,
                            const float* h0, void* ys, void* hn, float* gates,
                            float* hnlin, int Tn, int N, int H, int NB, int JB,
                            cudaStream_t stream) {
  const auto kernel = gru_fwd_cluster_for<T>(cluster_fwd_layout(H, NB, JB).rt);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  cudaError_t err =
      cluster_config(kernel, tiles(H, JB), tiles(N, NB),
                     cluster_smem(false, H, NB, JB), stream, &cfg, &attr,
                     &active);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorInvalidConfiguration;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(xp), wh, bh,
                            h0, static_cast<T*>(ys), static_cast<T*>(hn),
                            gates, hnlin, Tn, N, H, NB, JB);
}

template <typename T>
cudaError_t gru_fwd(const void* xp, const float* wh, const float* bh,
                    const float* h0, void* ys, void* hn, float* gates,
                    float* hnlin, float* hbuf, unsigned int* bar, int Tn,
                    int N, int H, int route, int NB, int JB,
                    cudaStream_t stream) {
  if (route == ROUTE_CLUSTER)
    return gru_fwd_cluster<T>(xp, wh, bh, h0, ys, hn, gates, hnlin, Tn, N, H,
                              NB, JB, stream);
  return launch_recurrence(
      gru_fwd_kernel<T>, tiles(H, JB), tiles(N, NB),
      fwd_smem(3, H, NB, JB, false), stream, static_cast<const T*>(xp), wh,
      bh, h0, static_cast<T*>(ys), static_cast<T*>(hn), gates, hnlin, hbuf,
      bar, Tn, N, H, NB, JB);
}

// The GRU backward's recurrence on the cluster route: checked against
// what the device can hold (cudaOccupancyMaxActiveClusters) before the
// launch, which fails with cudaErrorInvalidConfiguration where no cluster
// of this size fits.
template <typename T>
cudaError_t gru_bwd_cluster(const float* dys, const float* gates,
                            const float* hnlin, const void* ys,
                            const float* h0, const float* wh,
                            const float* dhn, float* dxp, float* dgh,
                            float* dh0, int Tn, int N, int H, int NB, int JB,
                            cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int active = 0;
  cudaError_t err = cluster_config(gru_bwd_cluster_kernel<T>, tiles(H, JB),
                                   tiles(N, NB), cluster_smem(true, H, NB, JB),
                                   stream, &cfg, &attr, &active);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorInvalidConfiguration;
  return cudaLaunchKernelEx(&cfg, gru_bwd_cluster_kernel<T>, dys, gates,
                            hnlin, static_cast<const T*>(ys), h0, wh, dhn,
                            dxp, dgh, dh0, Tn, N, H, NB, JB);
}

template <typename T>
cudaError_t gru_bwd(const float* dys, const float* gates, const float* hnlin,
                    const void* ys, const float* h0, const float* wh,
                    const float* dhn, float* dxp, float* dgh, float* dwh,
                    float* dbh, float* dh0, float* part, unsigned int* bar,
                    int Tn, int N, int H, int route, int NB, int JB, int P,
                    cudaStream_t stream) {
  cudaError_t err;
  if (route == ROUTE_CLUSTER)
    err = gru_bwd_cluster<T>(dys, gates, hnlin, ys, h0, wh, dhn, dxp, dgh,
                             dh0, Tn, N, H, NB, JB, stream);
  else
    err = launch_recurrence(
        gru_bwd_kernel<T>, tiles(H, JB), tiles(N, NB),
        bwd_smem(3, H, NB, JB), stream, dys, gates, hnlin,
        static_cast<const T*>(ys), h0, wh, dhn, dxp, dgh, dh0, bar, Tn, N, H,
        NB, JB);
  if (err != cudaSuccess) return err;
  return launch_dw<T>(dgh, h0, ys, part, dwh, dbh, (long long)Tn * N, N, 3,
                      H, P, stream);
}

// Whether (NB, JB) is a cluster-route plan of (N, H) whose shared memory
// the current device lets a block take.
bool cluster_plan_ok(bool backward, int N, int H, int NB, int JB) {
  int dev = 0, optin = 0;
  return cluster_fits(backward, N, H, NB, JB, ~(size_t)0) &&
         cudaGetDevice(&dev) == cudaSuccess &&
         cudaDeviceGetAttribute(&optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev) == cudaSuccess &&
         cluster_smem(backward, H, NB, JB) <= (size_t)optin;
}

}  // namespace

// The plan of a recurrence kernel, as plan_recurrence above: its route
// (ROUTE_SPLIT, ROUTE_REG, ROUTE_CLUSTER or ROUTE_MMA), NB rows and JB
// units per block for the launches below.  backward: 0 = forward kernel;
// want: -1 the kernel's own choice, else a route.  Returns a cudaError_t
// (cudaErrorInvalidConfiguration: no plan of that route fits).
extern "C" int mxtt_rnn_plan(int G, int backward, int N, int H, int want,
                             int* route, int* NB, int* JB) {
  return (int)plan_recurrence(G, backward != 0, N, H, want, route, NB, JB);
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16, of x_proj and of
// ys/hn/cn.  Every
// tensor is contiguous, in the layouts of the kernels above.  route, NB
// and JB from mxtt_rnn_plan.  The split route takes hbuf, a (2, N, H) fp32
// scratch, and bar, one zeroed uint32; the register and tensor-core routes
// neither (null); the tensor-core route takes xp 16-byte aligned.
// Returns a cudaError_t.
extern "C" int mxtt_lstm_fwd(const void* xp, const float* wh,
                             const float* h0, const float* c0, void* ys,
                             void* hn, void* cn, float* gates, float* cs,
                             float* hbuf, unsigned int* bar, int Tn, int N,
                             int H, int route, int NB, int JB, int dtype,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_plan(Tn, N, H, NB, JB) || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (route == ROUTE_MMA) {
    if (NB != kMmaRows || JB != H || H > kMmaMaxH || H % 2 != 0 ||
        reinterpret_cast<uintptr_t>(xp) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      return (int)lstm_fwd_mma<float>(xp, wh, h0, c0, ys, hn, cn, gates, cs,
                                      Tn, N, H, st);
    if (dtype == 1)
      return (int)lstm_fwd_mma<__nv_bfloat16>(xp, wh, h0, c0, ys, hn, cn,
                                              gates, cs, Tn, N, H, st);
    return (int)lstm_fwd_mma<__half>(xp, wh, h0, c0, ys, hn, cn, gates, cs,
                                     Tn, N, H, st);
  }
  if (route == ROUTE_REG) {
    if (NB != 1 || JB != H || H > kRegMaxH) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      return (int)lstm_fwd_reg<float>(xp, wh, h0, c0, ys, hn, cn, gates, cs,
                                      Tn, N, H, st);
    if (dtype == 1)
      return (int)lstm_fwd_reg<__nv_bfloat16>(xp, wh, h0, c0, ys, hn, cn,
                                              gates, cs, Tn, N, H, st);
    return (int)lstm_fwd_reg<__half>(xp, wh, h0, c0, ys, hn, cn, gates, cs,
                                     Tn, N, H, st);
  }
  if (route != ROUTE_SPLIT) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)lstm_fwd<float>(xp, wh, h0, c0, ys, hn, cn, gates, cs, hbuf,
                                bar, Tn, N, H, NB, JB, st);
  if (dtype == 1)
    return (int)lstm_fwd<__nv_bfloat16>(xp, wh, h0, c0, ys, hn, cn, gates,
                                        cs, hbuf, bar, Tn, N, H, NB, JB, st);
  return (int)lstm_fwd<__half>(xp, wh, h0, c0, ys, hn, cn, gates, cs, hbuf,
                               bar, Tn, N, H, NB, JB, st);
}

// All fp32 but ys (dtype as above), read as h_prev by the dW product.
// part is a (P, 4H, H) fp32 scratch.  Out: dxp (Tn, N, 4H), dwh (4H, H),
// dh0, dc0 (N, H).  The split or the register route (bar null on the
// register route).
extern "C" int mxtt_lstm_bwd(const float* dys, const float* gates,
                             const float* cs, const float* h0,
                             const float* c0, const void* ys,
                             const float* wh, const float* dhn,
                             const float* dcn, float* dxp, float* dwh,
                             float* dh0, float* dc0, float* part,
                             unsigned int* bar, int Tn, int N, int H,
                             int route, int NB, int JB, int P, int dtype,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_plan(Tn, N, H, NB, JB) || P < 1 || P > 65535 || dtype < 0 ||
      dtype > 2 || (route != ROUTE_SPLIT && route != ROUTE_REG) ||
      (route == ROUTE_REG && (NB != 1 || JB != H || H > kRegMaxH)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      route == ROUTE_REG
          ? lstm_bwd_reg(dys, gates, cs, c0, wh, dhn, dcn, dxp, dh0, dc0, Tn,
                         N, H, st)
          : launch_recurrence(lstm_bwd_kernel, tiles(H, JB), tiles(N, NB),
                              bwd_smem(4, H, NB, JB), st, dys, gates, cs, c0,
                              wh, dhn, dcn, dxp, dh0, dc0, bar, Tn, N, H, NB,
                              JB);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)Tn * N;
  if (dtype == 0)
    return (int)launch_dw<float>(dxp, h0, ys, part, dwh, nullptr, M, N, 4, H,
                                 P, st);
  if (dtype == 1)
    return (int)launch_dw<__nv_bfloat16>(dxp, h0, ys, part, dwh, nullptr, M,
                                         N, 4, H, P, st);
  return (int)launch_dw<__half>(dxp, h0, ys, part, dwh, nullptr, M, N, 4, H,
                                P, st);
}

// As mxtt_lstm_fwd, for the GRU, on the split or the cluster route (hbuf
// and bar null on the cluster route): bh (3H) fp32; hnlin (Tn, N, H) fp32.
extern "C" int mxtt_gru_fwd(const void* xp, const float* wh, const float* bh,
                            const float* h0, void* ys, void* hn,
                            float* gates, float* hnlin, float* hbuf,
                            unsigned int* bar, int Tn, int N, int H,
                            int route, int NB, int JB, int dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_plan(Tn, N, H, NB, JB) || dtype < 0 || dtype > 2 ||
      (route != ROUTE_SPLIT && route != ROUTE_CLUSTER))
    return (int)cudaErrorInvalidValue;
  if (route == ROUTE_CLUSTER && !cluster_plan_ok(false, N, H, NB, JB))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)gru_fwd<float>(xp, wh, bh, h0, ys, hn, gates, hnlin, hbuf,
                               bar, Tn, N, H, route, NB, JB, st);
  if (dtype == 1)
    return (int)gru_fwd<__nv_bfloat16>(xp, wh, bh, h0, ys, hn, gates, hnlin,
                                       hbuf, bar, Tn, N, H, route, NB, JB, st);
  return (int)gru_fwd<__half>(xp, wh, bh, h0, ys, hn, gates, hnlin, hbuf, bar,
                              Tn, N, H, route, NB, JB, st);
}

// As mxtt_lstm_bwd, for the GRU, on the split or the cluster route (bar
// null on the cluster route): dgh is a (Tn, N, 3H) fp32 scratch, part a
// (P, 3H, H+1) one.  Out: dxp (Tn, N, 3H), dwh (3H, H), dbh (3H), dh0.
extern "C" int mxtt_gru_bwd(const float* dys, const float* gates,
                            const float* hnlin, const void* ys,
                            const float* h0, const float* wh,
                            const float* dhn, float* dxp, float* dgh,
                            float* dwh, float* dbh, float* dh0, float* part,
                            unsigned int* bar, int Tn, int N, int H,
                            int route, int NB, int JB, int P, int dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_plan(Tn, N, H, NB, JB) || P < 1 || P > 65535 || dtype < 0 ||
      dtype > 2 || (route != ROUTE_SPLIT && route != ROUTE_CLUSTER))
    return (int)cudaErrorInvalidValue;
  if (route == ROUTE_CLUSTER && !cluster_plan_ok(true, N, H, NB, JB))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)gru_bwd<float>(dys, gates, hnlin, ys, h0, wh, dhn, dxp, dgh,
                               dwh, dbh, dh0, part, bar, Tn, N, H, route, NB,
                               JB, P, st);
  if (dtype == 1)
    return (int)gru_bwd<__nv_bfloat16>(dys, gates, hnlin, ys, h0, wh, dhn,
                                       dxp, dgh, dwh, dbh, dh0, part, bar, Tn,
                                       N, H, route, NB, JB, P, st);
  return (int)gru_bwd<__half>(dys, gates, hnlin, ys, h0, wh, dhn, dxp, dgh,
                              dwh, dbh, dh0, part, bar, Tn, N, H, route, NB,
                              JB, P, st);
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
