// Copies into shared memory and tensor-core products shared by the GEMM
// kernels (gemm.cu: forward; gemm_any.cu: backward).
//
// 3xTF32.  An f32 x splits into hi = tf32(x) and lo = tf32(x - hi), each
// rounded to nearest with ties away from zero to a 10-bit mantissa (the
// rounding of PTX cvt.rna.tf32.f32, done here with an integer add and
// mask on the bits, at full rate); x - hi is exact in f32 and hi + lo
// carries 22 of x's 24 mantissa bits.  A product is then a_lo b_hi +
// a_hi b_lo + a_hi b_hi on mma.sync m16n8k8 TF32 (a_lo b_lo, below f32's
// rounding, is dropped), with the split done in registers on the loaded
// fragments.  The products of one 8-deep k step (two steps where B is
// bf16, gemm_any.cu) go into a zeroed register tile and that tile is
// added to the running sum with an f32 add: the tensor core's own
// accumulation truncates, and run over the whole K its error grows with
// K / 8 steps, several times an f32 sum's (chip_smoke.py phase 7 measures
// the kernel against f64 on same-sign operands at K = 98,304).
// ops/gemm.py:tf32x3_mm is the same arithmetic in PyTorch;
// tests/test_torch_port_tf32x3.py measures it against f64 (f32-level,
// where one TF32 pass is ~500x worse).  A bf16 operand is exact in TF32
// (its lo is 0), so a product with one bf16 side needs two mma, not three.
#pragma once

#include "common.cuh"

namespace isg {

// 16-byte copy of which the first `bytes` are read, the rest zero-filled
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four consecutive elements, `cnt` of them valid (the rest zero): one
// cp.async of 4 * sizeof(T) bytes, or, where the operands are not
// aligned for it (async false), plain loads and stores.  g is not read
// when cnt is 0.
template <typename T>
__device__ __forceinline__ void copy4(T* s, const T* g, int cnt, bool async) {
  if (async) {
    const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
    if (sizeof(T) == 4)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
                   "l"(g), "r"(cnt * 4));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(sa),
                   "l"(g), "r"(cnt * 2));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = i < cnt ? g[i] : from_f<T>(0.f);
  }
}

// x rounded to TF32, to nearest with ties away from zero (cvt.rna)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo in TF32 (see the 3xTF32 note at the top)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b (a zero accumulator: no register to clear)
__device__ __forceinline__ void mma_tf32_zero(float* d, const uint32_t* a,
                                              const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// acc[j] += a b[j] over one 8-deep k step for four n8 tiles (those j <
// live), at f32-level accuracy; kALo false when a is exact in TF32 (bf16
// values: their lo part is zero).  The products go into fresh tiles t[j],
// issued tile after tile so that neighbouring mma are independent, and t
// is added to acc in f32.
template <bool kALo>
__device__ __forceinline__ void mma_3xtf32_x4(float (*acc)[4],
                                              const uint32_t* ah,
                                              const uint32_t* al,
                                              const uint32_t (*bh)[2],
                                              const uint32_t (*bl)[2],
                                              int live) {
  float t[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < live) {
      if (kALo) mma_tf32_zero(t[j], al, bh[j]);
      else mma_tf32_zero(t[j], ah, bl[j]);
    }
  if (kALo) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < live) mma_tf32(t[j], ah, bl[j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < live) {
      mma_tf32(t[j], ah, bh[j]);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] += t[j][q];
    }
}

// t[j] (+)= a b[j] over one 8-deep k step for four n8 tiles (those j <
// live), b exact in TF32: a_lo b + a_hi b
template <bool kZero>
__device__ __forceinline__ void mma_2xtf32_x4(float (*t)[4],
                                              const uint32_t* ah,
                                              const uint32_t* al,
                                              const uint32_t (*bh)[2],
                                              int live) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < live) {
      if (kZero) mma_tf32_zero(t[j], al, bh[j]);
      else mma_tf32(t[j], al, bh[j]);
    }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < live) mma_tf32(t[j], ah, bh[j]);
}

}  // namespace isg
