// Residual + LayerNorm over rows of N <= 128 Q columns, shared by the
// Hopper GEMM's LayerNorm epilogue (gemm_sm90.cu, rows staged in shared
// memory) and the separate pass isg_residual_ln (text_kernel.cu, rows in
// device memory):
//
//   z = x + (y + bias) * ymask,  out = LN2?(LN1(z))
//
// with flax's LayerNorm numerics (f32 sums over z, fast variance
// max(E[z^2] - E[z]^2, 0) + eps).  Eight warps; warp w owns rows w,
// w + 8, ..., a lane 4 Q columns of each (Q float4 at 128 q + 4 lane).
// Every load of the warp's R rows is issued before the first row sum, so
// a warp keeps R Q of them in flight: the pass moves ~5 KB a row of 512
// and is bound by bytes.
#pragma once

#include "common.cuh"

namespace isg {

struct LnRows {
  const float* bias;              // [N] or null
  const void* x;                  // the residual [M, N] at x_dt
  int x_dt;
  const float* ymask;             // [M, N] f32 or null
  const float *g1, *b1, *g2, *b2; // g2 / b2 null: no final LayerNorm
  float* z_out;                   // [M, N] f32 or null: the pre-LN sum
  float* out_f;                   // [M, N] f32 or null
  void* out_t;                    // [M, N] at t_dt or null
  int t_dt;
  float eps;
  int M, N;
};

__device__ __forceinline__ void load4(const void* x, int dt, long off,
                                      float (&v)[4]) {
  if (dt == 0) {
    const float4 f = *reinterpret_cast<const float4*>(
        static_cast<const float*>(x) + off);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(x) + off);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
}

__device__ __forceinline__ void store4(void* c, int dt, long off,
                                       const float* v) {
  if (dt == 0) {
    *reinterpret_cast<float4*>(static_cast<float*>(c) + off) =
        make_float4(v[0], v[1], v[2], v[3]);
  } else {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&a);
    u.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(c) + off) = u;
  }
}

// Rows m0 + w + 8 i (i < R) of the [M, N] product y (row pitch `pitch`,
// its row 0 at m0) through the residual + LayerNorm(s) into p's outputs.
template <int R, int Q>
__device__ __forceinline__ void ln_rows(const float* y, int pitch,
                                        const LnRows& p, int m0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, N = p.N;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float v[R][Q][4];
  float4 bias[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int n = 128 * q + 4 * lane;
    bias[q] = p.bias && n < N ? *reinterpret_cast<const float4*>(p.bias + n)
                              : zero;
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = warp + 8 * i, m = m0 + r;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int n = 128 * q + 4 * lane;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[i][q][e] = 0.f;
      if (m >= p.M || n >= N) continue;
      const long off = (long)m * N + n;
      const float4 a = *reinterpret_cast<const float4*>(y + (long)r * pitch +
                                                        n);
      float t[4] = {a.x + bias[q].x, a.y + bias[q].y, a.z + bias[q].z,
                    a.w + bias[q].w};
      if (p.ymask) {
        const float4 k = *reinterpret_cast<const float4*>(p.ymask + off);
        t[0] *= k.x; t[1] *= k.y; t[2] *= k.z; t[3] *= k.w;
      }
      float xv[4];
      load4(p.x, p.x_dt, off, xv);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[i][q][e] = xv[e] + t[e];
      if (p.z_out) store4(p.z_out, 0, off, v[i][q]);
    }
  }
  for (int pass = 0; pass < (p.g2 ? 2 : 1); ++pass) {
    const float* gp = pass ? p.g2 : p.g1;
    const float* bp = pass ? p.b2 : p.b1;
    float4 g4[Q], b4[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int n = 128 * q + 4 * lane;
      g4[q] = n < N ? *reinterpret_cast<const float4*>(gp + n) : zero;
      b4[q] = n < N ? *reinterpret_cast<const float4*>(bp + n) : zero;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float s = 0.f, sq = 0.f;
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s += v[i][q][e];
          sq += v[i][q][e] * v[i][q][e];
        }
      const float mean = warp_sum(s) / N;
      const float rstd =
          rsqrtf(fmaxf(warp_sum(sq) / N - mean * mean, 0.f) + p.eps);
#pragma unroll
      for (int q = 0; q < Q; ++q) {     // columns past N get 0: g4 = b4 = 0
        v[i][q][0] = (v[i][q][0] - mean) * rstd * g4[q].x + b4[q].x;
        v[i][q][1] = (v[i][q][1] - mean) * rstd * g4[q].y + b4[q].y;
        v[i][q][2] = (v[i][q][2] - mean) * rstd * g4[q].z + b4[q].z;
        v[i][q][3] = (v[i][q][3] - mean) * rstd * g4[q].w + b4[q].w;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int m = m0 + warp + 8 * i;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int n = 128 * q + 4 * lane;
      if (m >= p.M || n >= N) continue;
      const long off = (long)m * N + n;
      if (p.out_f) store4(p.out_f, 0, off, v[i][q]);
      if (p.out_t) store4(p.out_t, p.t_dt, off, v[i][q]);
    }
  }
}

}  // namespace isg
