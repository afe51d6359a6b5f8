// fp32-accurate products on Hopper's tensor cores as 3xTF32, for
// warp-level mma.sync.m16n8k8 TF32 with fp32 accumulation: an fp32
// operand is split into hi = x rounded to TF32 and lo = x - hi, and a
// product sums lo*hi + hi*lo + hi*hi (about 21 bits of each operand,
// where one TF32 product keeps 11).  The split is two integer ops and a
// subtraction (cvt.rna.tf32 runs on the slow conversion pipe).  A value
// that is exact in TF32 (bf16) needs no lo term.  Used by the attention
// kernels (attention_tiles.cuh) and the fp32 fused 1x1 kernel
// (conv_fused.cu).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace mxtt {
namespace tf32x3 {

// x as (hi, lo) TF32 terms: hi keeps the top 19 bits, rounded half away
// from zero; lo = x - hi is exact in fp32, and the tensor core reads its
// top 19 bits.  Without SPLIT, x is exact in TF32 and lo unused.
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (SPLIT) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// c (16 x 8, fp32) += a (16 x 8) b (8 x 8), TF32 operands.  Lane 4g + t
// holds a = (g, t), (g+8, t), (g, t+4), (g+8, t+4); b = (t, g), (t+4, g);
// c = (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b with the small terms first: lo*hi, hi*lo, hi*hi
template <bool SA, bool SB>
__device__ __forceinline__ void mma3(float* c, const uint32_t* ah,
                                     const uint32_t* al, const uint32_t* bh,
                                     const uint32_t* bl) {
  if constexpr (SA) mma_tf32(c, al, bh);
  if constexpr (SB) mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

}  // namespace tf32x3
}  // namespace mxtt
