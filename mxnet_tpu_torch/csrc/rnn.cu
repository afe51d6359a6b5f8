// LSTM and GRU recurrences for Hopper (sm_90a): forward and backward, fp32
// and bf16 activations, fp32 math and state.
//
// Replaces the four recurrence kernels of mxnet_tpu/ops/pallas/rnn.py:
// _lstm_fwd_kernel, _lstm_bwd_kernel, _gru_fwd_kernel and _gru_bwd_kernel.
// The input projection x @ Wi^T + b stays a matrix product outside (as the
// JAX package leaves it to XLA); these kernels run the serial part.  Gates
// are gate-major inside 4H (LSTM: i, f, g, o) and 3H (GRU: r, z, n, the
// cuDNN linear-before-reset cell).
//
// Design.  On the TPU one program walked a grid of T steps with h and c
// resident in VMEM.  Here one launch runs all T steps ("persistent"): the
// grid is (unit tiles) x (row tiles); block (u, b) owns hidden units
// [u*JB, u*JB+JB) of batch rows [b*NB, b*NB+NB), keeps the rows of Wh for
// its units (forward) or the columns (backward) in shared memory for the
// whole launch, and carries its own c (LSTM) and its part of dh/dc in
// shared memory.
//
// - One unit tile (Wh fits one block: H up to ~110 for the LSTM, ~125 for
//   the GRU): blocks are independent.  Each keeps its rows' whole h in
//   shared memory and needs only __syncthreads between phases.  A normal
//   launch; the number of row tiles is free.
// - Several unit tiles (larger H): a step needs every unit's h (forward) or
//   every unit's gate gradients (backward) of the row, which other blocks
//   computed.  They go through global memory: the forward through a double
//   buffer hbuf (2, N, H) fp32, the backward through dxp (LSTM) or the dgh
//   scratch (GRU), which are written at a new t every step.  A grid barrier
//   (written here: one arrival counter whose top bit flips) separates the
//   writes of a step from the reads, once per step.  Every block must then
//   be resident: the launch is cooperative (cudaLaunchCooperativeKernel),
//   after a check with the occupancy API, and fails rather than deadlock.
//   Reads of exchanged data use __ldcg (L2), never a stale L1 line.
//
// The backward's weight gradients (dWh and, for the GRU, dbh) sum over all
// T*N rows.  They are not accumulated in the recurrence: a second kernel
// takes them as one product of the saved gate gradients with h_prev (the
// stored ys shifted by one step, h0 first), split over row slabs whose
// partials a third kernel adds in a fixed order.  No float atomics, so every
// output is bit-identical from run to run.
//
// Bound on an H100 SXM.  A step is a (N x H) by (H x G*H) product and G*N*H
// activations: at DeepAR's width (N=32, H=40) a few hundred thousand FMAs,
// so the work is latency over T dependent steps (two or three block-wide
// or grid-wide synchronisations each), not bytes (~5 MB for the whole
// forward, ~1.5 us at 3.35 TB/s) nor operations.  This first version does
// plain fp32 FMAs from shared memory (no tensor cores, no prefetch of the
// next step's x_proj); the gap to the bound is recorded in PERF.md.
//
// Built by nvcc into a C-ABI shared library (mxnet_tpu_torch/ops/kernels/
// build.py) and bound with ctypes.  Every launch goes on the caller's
// stream; each function returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;  // threads of every recurrence block
constexpr int kChunk = 64;     // units of gate gradients staged per pass
constexpr int kTile = 64;      // dW product: 64 x 64 outputs per block
constexpr int kTileK = 16;     // dW product: rows per shared-memory stage
constexpr int kInFlight = 8;   // L2 loads a thread issues before it waits
constexpr size_t kSmemBudget = 200 * 1024;  // a recurrence block's plan

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
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

// The plan of a recurrence kernel (G = 4: LSTM, 3: GRU; forward or
// backward) on the current device: NB batch rows and JB hidden units per
// block.  Where one block holds all of Wh (JB = H), blocks own whole rows,
// need no exchange, and take about 4 blocks per SM.  Otherwise a block's
// rows are as many as fit half the budget and the units are split so that
// every block has an SM of its own, so all are resident for the grid
// barrier.  Returns cudaSuccess, cudaErrorInvalidConfiguration where no plan
// fits the shared memory and the SMs, or the error of a device query.
cudaError_t plan_recurrence(int G, bool backward, int N, int H, int* NB_out,
                            int* JB_out) {
  if (N < 1 || H < 1 || (G != 3 && G != 4)) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  const size_t budget = std::min(kSmemBudget, (size_t)optin);
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

template <typename T>
cudaError_t gru_fwd(const void* xp, const float* wh, const float* bh,
                    const float* h0, void* ys, void* hn, float* gates,
                    float* hnlin, float* hbuf, unsigned int* bar, int Tn,
                    int N, int H, int NB, int JB, cudaStream_t stream) {
  return launch_recurrence(
      gru_fwd_kernel<T>, tiles(H, JB), tiles(N, NB),
      fwd_smem(3, H, NB, JB, false), stream, static_cast<const T*>(xp), wh,
      bh, h0, static_cast<T*>(ys), static_cast<T*>(hn), gates, hnlin, hbuf,
      bar, Tn, N, H, NB, JB);
}

template <typename T>
cudaError_t gru_bwd(const float* dys, const float* gates, const float* hnlin,
                    const void* ys, const float* h0, const float* wh,
                    const float* dhn, float* dxp, float* dgh, float* dwh,
                    float* dbh, float* dh0, float* part, unsigned int* bar,
                    int Tn, int N, int H, int NB, int JB, int P,
                    cudaStream_t stream) {
  cudaError_t err = launch_recurrence(
      gru_bwd_kernel<T>, tiles(H, JB), tiles(N, NB), bwd_smem(3, H, NB, JB),
      stream, dys, gates, hnlin, static_cast<const T*>(ys), h0, wh, dhn, dxp,
      dgh, dh0, bar, Tn, N, H, NB, JB);
  if (err != cudaSuccess) return err;
  return launch_dw<T>(dgh, h0, ys, part, dwh, dbh, (long long)Tn * N, N, 3,
                      H, P, stream);
}

}  // namespace

// The plan of a recurrence kernel, as plan_recurrence above: NB rows and JB
// units per block for the launches below.  backward: 0 = forward kernel.
// Returns a cudaError_t (cudaErrorInvalidConfiguration: no plan fits).
extern "C" int mxtt_rnn_plan(int G, int backward, int N, int H, int* NB,
                             int* JB) {
  return (int)plan_recurrence(G, backward != 0, N, H, NB, JB);
}

// dtype: 0 = float32, 1 = bfloat16, of x_proj and of ys/hn/cn.  Every
// tensor is contiguous, in the layouts of the kernels above; hbuf is a
// (2, N, H) fp32 scratch, bar one zeroed uint32.  NB rows and JB units per
// block, from mxtt_rnn_plan.  Returns a cudaError_t.
extern "C" int mxtt_lstm_fwd(const void* xp, const float* wh,
                             const float* h0, const float* c0, void* ys,
                             void* hn, void* cn, float* gates, float* cs,
                             float* hbuf, unsigned int* bar, int Tn, int N,
                             int H, int NB, int JB, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_plan(Tn, N, H, NB, JB)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)lstm_fwd<float>(xp, wh, h0, c0, ys, hn, cn, gates, cs, hbuf,
                                bar, Tn, N, H, NB, JB, st);
  if (dtype == 1)
    return (int)lstm_fwd<__nv_bfloat16>(xp, wh, h0, c0, ys, hn, cn, gates,
                                        cs, hbuf, bar, Tn, N, H, NB, JB, st);
  return (int)cudaErrorInvalidValue;
}

// All fp32 but ys (dtype as above), read as h_prev by the dW product.
// part is a (P, 4H, H) fp32 scratch.  Out: dxp (Tn, N, 4H), dwh (4H, H),
// dh0, dc0 (N, H).
extern "C" int mxtt_lstm_bwd(const float* dys, const float* gates,
                             const float* cs, const float* h0,
                             const float* c0, const void* ys,
                             const float* wh, const float* dhn,
                             const float* dcn, float* dxp, float* dwh,
                             float* dh0, float* dc0, float* part,
                             unsigned int* bar, int Tn, int N, int H, int NB,
                             int JB, int P, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_plan(Tn, N, H, NB, JB) || P < 1 || P > 65535 || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_recurrence(
      lstm_bwd_kernel, tiles(H, JB), tiles(N, NB), bwd_smem(4, H, NB, JB),
      st, dys, gates, cs, c0, wh, dhn, dcn, dxp, dh0, dc0, bar, Tn, N, H, NB,
      JB);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)Tn * N;
  if (dtype == 0)
    return (int)launch_dw<float>(dxp, h0, ys, part, dwh, nullptr, M, N, 4, H,
                                 P, st);
  return (int)launch_dw<__nv_bfloat16>(dxp, h0, ys, part, dwh, nullptr, M, N,
                                       4, H, P, st);
}

// As mxtt_lstm_fwd, for the GRU: bh (3H) fp32; hnlin (Tn, N, H) fp32.
extern "C" int mxtt_gru_fwd(const void* xp, const float* wh, const float* bh,
                            const float* h0, void* ys, void* hn,
                            float* gates, float* hnlin, float* hbuf,
                            unsigned int* bar, int Tn, int N, int H, int NB,
                            int JB, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_plan(Tn, N, H, NB, JB)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)gru_fwd<float>(xp, wh, bh, h0, ys, hn, gates, hnlin, hbuf,
                               bar, Tn, N, H, NB, JB, st);
  if (dtype == 1)
    return (int)gru_fwd<__nv_bfloat16>(xp, wh, bh, h0, ys, hn, gates, hnlin,
                                       hbuf, bar, Tn, N, H, NB, JB, st);
  return (int)cudaErrorInvalidValue;
}

// As mxtt_lstm_bwd, for the GRU: dgh is a (Tn, N, 3H) fp32 scratch, part a
// (P, 3H, H+1) one.  Out: dxp (Tn, N, 3H), dwh (3H, H), dbh (3H), dh0.
extern "C" int mxtt_gru_bwd(const float* dys, const float* gates,
                            const float* hnlin, const void* ys,
                            const float* h0, const float* wh,
                            const float* dhn, float* dxp, float* dgh,
                            float* dwh, float* dbh, float* dh0, float* part,
                            unsigned int* bar, int Tn, int N, int H, int NB,
                            int JB, int P, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_plan(Tn, N, H, NB, JB) || P < 1 || P > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)gru_bwd<float>(dys, gates, hnlin, ys, h0, wh, dhn, dxp, dgh,
                               dwh, dbh, dh0, part, bar, Tn, N, H, NB, JB, P,
                               st);
  if (dtype == 1)
    return (int)gru_bwd<__nv_bfloat16>(dys, gates, hnlin, ys, h0, wh, dhn,
                                       dxp, dgh, dwh, dbh, dh0, part, bar,
                                       Tn, N, H, NB, JB, P, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
