// Backward kernels of the question stack's training layers.
//
// With the shared GEMM's backward forms (gemm.cu: isg_gemm_any for dgrad
// and wgrad, isg_colsum for the bias gradients) they replace the backward
// Pallas kernels of isubgvqa_tpu/ops/pallas/text_train.py
// (_make_enc_bwd, _make_dec_bwd, called from _enc_call / _dec_call).
// The TPU kernels recompute the forward in VMEM; here the forward saves
// what the backward reads (q, k, v, the softmax probabilities, the pre-LN
// sums, the FFN activation) and these kernels walk the chain in reverse.
//
// isg_attention_bwd: one block per (question, head), like the forward.
//   The block holds q, k, v, dO, the probabilities P and the score
//   gradient in shared memory (L <= 64, head width <= 128) and computes
//     dV  = Pd^T dO                  (Pd = P * keep rounded to the model
//                                     dtype, as the forward used it)
//     dP~ = (dO V^T) * keep
//     dS  = P * (dP~ - rowsum(dP~ * P))
//     dQ  = scale * dS K,  dK = scale * dS^T Q
//   The key bias is added to the logits and gets no gradient.  Bound:
//   bytes (each operand read once per block; the products are tiny).
//
// isg_ln_bwd: one warp per row, the backward of LN(z) with flax's fast
//   variance clamped at 0 and eps 1e-6:
//     dz = r * (g s - mean(g s) - zhat * mean(g s zhat)),
//   optionally dy = dz * ymask (the dropout mask on the branch that fed
//   z = x + y * ymask); the scale and bias gradients are summed per block
//   and finished by isg_reduce_rows, in a fixed order.  Bound: bytes.
//
// isg_relu_bwd: dx = dy * keep * (act > 0), with act the saved ReLU
//   output (the FFN's dropout mask after the ReLU).  Bound: bytes.

#include "common.cuh"

namespace isg {

template <typename T>
__global__ void attention_bwd_kernel(
    const T* __restrict__ q, int q_rs, const T* __restrict__ k, int k_rs,
    const T* __restrict__ v, int v_rs, const float* __restrict__ probs,
    const float* __restrict__ keep, const float* __restrict__ dout, int do_rs,
    float* __restrict__ dq, int dq_rs, float* __restrict__ dk, int dk_rs,
    float* __restrict__ dv, int dv_rs, int Lq, int Lk, int dh, float scale) {
  extern __shared__ float sm[];
  float* qs = sm;                        // [Lq, dh]
  float* dos = qs + Lq * dh;             // [Lq, dh]
  float* ks = dos + Lq * dh;             // [Lk, dh + 1]
  float* vs = ks + Lk * (dh + 1);        // [Lk, dh + 1]
  float* ps = vs + Lk * (dh + 1);        // [Lq, Lk] probabilities
  float* ds = ps + Lq * Lk;              // [Lq, Lk] score gradient
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int col = h * dh;
  const long prow = ((long)b * H + h) * Lq * Lk;

  for (int i = tid; i < Lq * dh; i += nt) {
    const int r = i / dh, d = i % dh;
    qs[i] = to_f(q[(long)(b * Lq + r) * q_rs + col + d]);
    dos[i] = dout[(long)(b * Lq + r) * do_rs + col + d];
  }
  for (int i = tid; i < Lk * dh; i += nt) {
    const int r = i / dh, d = i % dh;
    ks[r * (dh + 1) + d] = to_f(k[(long)(b * Lk + r) * k_rs + col + d]);
    vs[r * (dh + 1) + d] = to_f(v[(long)(b * Lk + r) * v_rs + col + d]);
  }
  for (int i = tid; i < Lq * Lk; i += nt) ps[i] = probs[prow + i];
  __syncthreads();

  // dV and dP~ (both read P; neither writes what the other reads)
  for (int i = tid; i < Lk * dh; i += nt) {
    const int c = i / dh, d = i % dh;
    float acc = 0.f;
    for (int r = 0; r < Lq; ++r) {
      const float kp = keep ? keep[prow + r * Lk + c] : 1.f;
      acc = fmaf(round_to<T>(ps[r * Lk + c] * kp), dos[r * dh + d], acc);
    }
    dv[(long)(b * Lk + c) * dv_rs + col + d] = acc;
  }
  for (int i = tid; i < Lq * Lk; i += nt) {
    const int r = i / Lk, c = i % Lk;
    float acc = 0.f;
    for (int d = 0; d < dh; ++d) acc = fmaf(dos[r * dh + d], vs[c * (dh + 1) + d], acc);
    ds[i] = keep ? acc * keep[prow + i] : acc;
  }
  __syncthreads();

  // softmax backward, one warp per row
  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  for (int r = warp; r < Lq; r += nw) {
    float t = 0.f;
    for (int c = lane; c < Lk; c += 32) t += ds[r * Lk + c] * ps[r * Lk + c];
    t = warp_sum(t);
    for (int c = lane; c < Lk; c += 32)
      ds[r * Lk + c] = ps[r * Lk + c] * (ds[r * Lk + c] - t);
  }
  __syncthreads();

  for (int i = tid; i < Lq * dh; i += nt) {
    const int r = i / dh, d = i % dh;
    float acc = 0.f;
    for (int c = 0; c < Lk; ++c) acc = fmaf(ds[r * Lk + c], ks[c * (dh + 1) + d], acc);
    dq[(long)(b * Lq + r) * dq_rs + col + d] = acc * scale;
  }
  for (int i = tid; i < Lk * dh; i += nt) {
    const int c = i / dh, d = i % dh;
    float acc = 0.f;
    for (int r = 0; r < Lq; ++r) acc = fmaf(ds[r * Lk + c], qs[r * dh + d], acc);
    dk[(long)(b * Lk + c) * dk_rs + col + d] = acc * scale;
  }
}

constexpr int kLnRows = 8;               // warps (rows in flight) per block

template <typename TG, int kMaxPer>     // kMaxPer * 32 >= D
__global__ void ln_bwd_kernel(const TG* __restrict__ g,
                              const float* __restrict__ z,
                              const float* __restrict__ s,
                              const float* __restrict__ ymask,
                              float* __restrict__ dz, float* __restrict__ dy,
                              float* __restrict__ part, int M, int D,
                              float eps) {
  extern __shared__ float acc[];         // [2, kLnRows, D] per-warp sums
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int per = (D + 31) / 32;
  float ds_acc[kMaxPer], db_acc[kMaxPer];
#pragma unroll
  for (int t = 0; t < kMaxPer; ++t) ds_acc[t] = db_acc[t] = 0.f;

  for (long row = (long)blockIdx.x * kLnRows + warp; row < M;
       row += (long)gridDim.x * kLnRows) {
    float zv[kMaxPer], gv[kMaxPer];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxPer; ++t) {
      const int c = lane + 32 * t;
      zv[t] = gv[t] = 0.f;
      if (t < per && c < D) {
        zv[t] = z[row * D + c];
        gv[t] = to_f(g[row * D + c]);
      }
      sum += zv[t];
      sq += zv[t] * zv[t];
    }
    const float mean = warp_sum(sum) / D;
    const float var = fmaxf(warp_sum(sq) / D - mean * mean, 0.f);
    const float r = rsqrtf(var + eps);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxPer; ++t) {
      const int c = lane + 32 * t;
      if (t < per && c < D) {
        const float zh = (zv[t] - mean) * r;
        const float gs = gv[t] * s[c];
        m1 += gs;
        m2 += gs * zh;
        ds_acc[t] += gv[t] * zh;
        db_acc[t] += gv[t];
      }
    }
    m1 = warp_sum(m1) / D;
    m2 = warp_sum(m2) / D;
#pragma unroll
    for (int t = 0; t < kMaxPer; ++t) {
      const int c = lane + 32 * t;
      if (t < per && c < D) {
        const float zh = (zv[t] - mean) * r;
        const float d = r * (gv[t] * s[c] - m1 - zh * m2);
        dz[row * D + c] = d;
        if (dy) dy[row * D + c] = ymask ? d * ymask[row * D + c] : d;
      }
    }
  }
  // the block's scale / bias gradient sums: warps in order, then rows
#pragma unroll
  for (int t = 0; t < kMaxPer; ++t) {
    const int c = lane + 32 * t;
    if (t < per && c < D) {
      acc[(0 * kLnRows + warp) * D + c] = ds_acc[t];
      acc[(1 * kLnRows + warp) * D + c] = db_acc[t];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * D; i += blockDim.x) {
    const int which = i / D, c = i % D;
    float tot = 0.f;
    for (int w = 0; w < kLnRows; ++w) tot += acc[(which * kLnRows + w) * D + c];
    part[((long)which * gridDim.x + blockIdx.x) * D + c] = tot;
  }
}

template <typename TA>
__global__ void relu_bwd_kernel(const float* __restrict__ dy,
                                const TA* __restrict__ act,
                                const float* __restrict__ keep,
                                float* __restrict__ dx, long n) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    float v = to_f(act[i]) > 0.f ? dy[i] : 0.f;
    if (keep) v *= keep[i];
    dx[i] = v;
  }
}

}  // namespace isg

using namespace isg;

// Gradients of one attention core.  q/k/v as in isg_attention (dtype dt);
// probs [B, H, Lq, Lk] f32 from the forward, keep may be null; dout, dq,
// dk, dv are f32 with their own row pitches.
ISG_API int isg_attention_bwd(const void* q, int q_rs, const void* k,
                              int k_rs, const void* v, int v_rs,
                              const float* probs, const float* keep,
                              const float* dout, int do_rs, float* dq,
                              int dq_rs, float* dk, int dk_rs, float* dv,
                              int dv_rs, int B, int Lq, int Lk, int H, int dh,
                              float scale, int dt, void* stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)Lq * dh + 2 * (size_t)Lk * (dh + 1) +
                       2 * (size_t)Lq * Lk);
  dim3 grid(H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ISG_WITH_T(dt, T,
      allow_smem(attention_bwd_kernel<T>, smem);
      attention_bwd_kernel<T><<<grid, 128, smem, st>>>(
          static_cast<const T*>(q), q_rs, static_cast<const T*>(k), k_rs,
          static_cast<const T*>(v), v_rs, probs, keep, dout, do_rs, dq, dq_rs,
          dk, dk_rs, dv, dv_rs, Lq, Lk, dh, scale));
  return (int)cudaGetLastError();
}

// dz (and dy = dz * ymask) of LN over z [M, D] f32 from g; part receives
// [2, blocks, D] partial sums of the scale and bias gradients.  blocks <=
// ceil(M / 8); the caller sizes part for it.
ISG_API int isg_ln_bwd(const void* g, int g_dt, const float* z,
                       const float* s, const float* ymask,
                       float* dz, float* dy, float* part, int blocks, int M,
                       int D, float eps, void* stream) {
  if (D > 1024 || blocks < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * kLnRows * (size_t)D;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ISG_WITH_T(g_dt, TG,
      if (D <= 512) {
        allow_smem(ln_bwd_kernel<TG, 16>, smem);
        ln_bwd_kernel<TG, 16><<<blocks, 32 * kLnRows, smem, st>>>(
            static_cast<const TG*>(g), z, s, ymask, dz, dy, part, M, D, eps);
      } else {
        allow_smem(ln_bwd_kernel<TG, 32>, smem);
        ln_bwd_kernel<TG, 32><<<blocks, 32 * kLnRows, smem, st>>>(
            static_cast<const TG*>(g), z, s, ymask, dz, dy, part, M, D, eps);
      });
  return (int)cudaGetLastError();
}

// dx = dy * keep * (act > 0) over n elements; keep may be null.
ISG_API int isg_relu_bwd(const float* dy, const void* act, int act_dt,
                         const float* keep, float* dx, long n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  ISG_WITH_T(act_dt, TA,
      relu_bwd_kernel<TA><<<blocks > 0 ? blocks : 1, 256, 0, st>>>(
          dy, static_cast<const TA*>(act), keep, dx, n));
  return (int)cudaGetLastError();
}
