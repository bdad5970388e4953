// Question-stack kernels: attention core and residual + LayerNorm.
//
// Together with the shared GEMM (gemm.cu) they replace the Pallas
// kernels isubgvqa_tpu/ops/pallas/text_kernel.py:fused_encoder_layer
// (_enc_kernel) and fused_decoder_layer (_dec_kernel).
//
// isg_attention: one block per (question, head).  A question holds at
// most 64 tokens and a head 128 channels, so q, k, v and the score
// matrix sit in shared memory; no block-diagonal packing is needed (the
// TPU packed questions to fill 128-row MXU tiles).  The float key bias
// (the CLIP attention mask, ADDED to the logits: text_kernel.py:95-96,
// 146) is optional; the decoder's cross-attention passes none.  Softmax
// probabilities are rounded to the model dtype before P.V
// (text_kernel.py:101-104).  Bound: bytes (q, k, v in, o out; the
// 2*L*L*dh products are tiny), which the design meets by reading each
// operand once per block.
//
// isg_residual_ln: one warp per row, LN(x + y) with flax's fast
// variance max(E[x^2] - E[x]^2, 0) and eps 1e-6, optionally followed by
// the stack's final LayerNorm (folded in as on the TPU).  Bound: bytes.

#include "common.cuh"

namespace isg {

template <typename T>
__global__ void attention_kernel(const T* __restrict__ q, int q_rs,
                                 const T* __restrict__ k, int k_rs,
                                 const T* __restrict__ v, int v_rs,
                                 const float* __restrict__ bias,
                                 const float* __restrict__ keep,
                                 float* __restrict__ probs,
                                 T* __restrict__ o, int o_rs, int Lq, int Lk,
                                 int dh, float scale) {
  extern __shared__ float sm[];
  float* qs = sm;                       // [Lq, dh]
  float* ks = qs + Lq * dh;             // [Lk, dh + 1]
  float* vs = ks + Lk * (dh + 1);       // [Lk, dh]
  float* ps = vs + Lk * dh;             // [Lq, Lk]
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int col = h * dh;

  for (int i = tid; i < Lq * dh; i += nt) {
    const int r = i / dh, d = i % dh;
    qs[i] = to_f(q[(long)(b * Lq + r) * q_rs + col + d]);
  }
  for (int i = tid; i < Lk * dh; i += nt) {
    const int r = i / dh, d = i % dh;
    ks[r * (dh + 1) + d] = to_f(k[(long)(b * Lk + r) * k_rs + col + d]);
    vs[i] = to_f(v[(long)(b * Lk + r) * v_rs + col + d]);
  }
  __syncthreads();

  for (int i = tid; i < Lq * Lk; i += nt) {
    const int r = i / Lk, c = i % Lk;
    float s = 0.f;
    for (int d = 0; d < dh; ++d) s = fmaf(qs[r * dh + d], ks[c * (dh + 1) + d], s);
    s *= scale;
    if (bias) s += bias[b * Lk + c];
    ps[i] = s;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  for (int r = warp; r < Lq; r += nw) {
    float m = kNeg;
    for (int c = lane; c < Lk; c += 32) m = fmaxf(m, ps[r * Lk + c]);
    m = warp_max(m);
    float s = 0.f;
    for (int c = lane; c < Lk; c += 32) {
      const float e = expf(ps[r * Lk + c] - m);
      ps[r * Lk + c] = e;
      s += e;
    }
    s = warp_sum(s);
    const long prow = (((long)b * gridDim.x + h) * Lq + r) * Lk;
    for (int c = lane; c < Lk; c += 32) {
      float p = ps[r * Lk + c] / s;
      if (probs) probs[prow + c] = p;        // saved for the backward
      if (keep) p *= keep[prow + c];         // dropout on the probabilities
      ps[r * Lk + c] = round_to<T>(p);
    }
  }
  __syncthreads();

  for (int i = tid; i < Lq * dh; i += nt) {
    const int r = i / dh, d = i % dh;
    float acc = 0.f;
    for (int c = 0; c < Lk; ++c) acc = fmaf(ps[r * Lk + c], vs[c * dh + d], acc);
    o[(long)(b * Lq + r) * o_rs + col + d] = from_f<T>(acc);
  }
}

template <typename TX>
__global__ void residual_ln_kernel(const TX* __restrict__ x,
                                   const float* __restrict__ y,
                                   const float* __restrict__ g1,
                                   const float* __restrict__ b1,
                                   const float* __restrict__ g2,
                                   const float* __restrict__ b2,
                                   const float* __restrict__ ymask,
                                   float* __restrict__ z_out,
                                   float* __restrict__ out_f,
                                   void* __restrict__ out_t, int t_dt, int M,
                                   int D, float eps) {
  constexpr int kMaxPer = 32;           // D <= 1024
  const int lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= M) return;
  const int per = (D + 31) / 32;
  float v[kMaxPer];
#pragma unroll
  for (int t = 0; t < kMaxPer; ++t) {
    const int c = lane + 32 * t;
    v[t] = 0.f;
    if (t < per && c < D) {
      float yv = y ? y[row * D + c] : 0.f;
      if (ymask) yv *= ymask[row * D + c];   // dropout on the branch
      v[t] = to_f(x[row * D + c]) + yv;
      if (z_out) z_out[row * D + c] = v[t];  // pre-LN sum, for the backward
    }
  }
  for (int pass = 0; pass < (g2 ? 2 : 1); ++pass) {
    const float* g = pass ? g2 : g1;
    const float* bb = pass ? b2 : b1;
    float s = 0.f, sq = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxPer; ++t) {
      s += v[t];
      sq += v[t] * v[t];
    }
    const float mean = warp_sum(s) / D;
    const float var = fmaxf(warp_sum(sq) / D - mean * mean, 0.f);
    const float r = rsqrtf(var + eps);
#pragma unroll
    for (int t = 0; t < kMaxPer; ++t) {
      const int c = lane + 32 * t;
      if (t < per && c < D) v[t] = (v[t] - mean) * r * g[c] + bb[c];
    }
  }
#pragma unroll
  for (int t = 0; t < kMaxPer; ++t) {
    const int c = lane + 32 * t;
    if (t >= per || c >= D) continue;
    if (out_f) out_f[row * D + c] = v[t];
    if (out_t) {
      if (t_dt == 0) static_cast<float*>(out_t)[row * D + c] = v[t];
      else static_cast<__nv_bfloat16*>(out_t)[row * D + c] = __float2bfloat16(v[t]);
    }
  }
}

}  // namespace isg

using namespace isg;

// keep [B, H, Lq, Lk] (dropout keep values) and probs (the softmax,
// written for the backward) may be null.
ISG_API int isg_attention(const void* q, int q_rs, const void* k, int k_rs,
                          const void* v, int v_rs, const float* bias,
                          const float* keep, float* probs, void* o,
                          int o_rs, int B, int Lq, int Lk, int H, int dh,
                          float scale, int dt, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)Lq * dh + (size_t)Lk * (dh + 1) +
                       (size_t)Lk * dh + (size_t)Lq * Lk);
  dim3 grid(H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ISG_WITH_T(dt, T,
      allow_smem(attention_kernel<T>, smem);
      attention_kernel<T><<<grid, 128, smem, st>>>(
          static_cast<const T*>(q), q_rs, static_cast<const T*>(k), k_rs,
          static_cast<const T*>(v), v_rs, bias, keep, probs,
          static_cast<T*>(o), o_rs, Lq, Lk, dh, scale));
  return (int)cudaGetLastError();
}

// out = LN2?(LN1(x + y * ymask)); y, ymask, g2/b2, z_out (the pre-LN
// sum), out_f and out_t may each be null.
ISG_API int isg_residual_ln(const void* x, int x_dt, const float* y,
                            const float* g1, const float* b1, const float* g2,
                            const float* b2, const float* ymask, float* z_out,
                            float* out_f, void* out_t,
                            int t_dt, int M, int D, float eps, void* stream) {
  const int rows_per_block = 8;
  const int grid = (M + rows_per_block - 1) / rows_per_block;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ISG_WITH_T(x_dt, TX,
      residual_ln_kernel<TX><<<grid, 32 * rows_per_block, 0, st>>>(
          static_cast<const TX*>(x), y, g1, b1, g2, b2, ymask, z_out, out_f,
          out_t, t_dt, M, D, eps));
  return (int)cudaGetLastError();
}
