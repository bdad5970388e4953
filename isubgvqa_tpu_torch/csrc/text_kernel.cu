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
// isg_residual_ln: LN(x + y) with flax's fast variance max(E[x^2] -
// E[x]^2, 0) and eps 1e-6, optionally followed by the stack's final
// LayerNorm (folded in as on the TPU): ln_rows.cuh's rows, eight warps of
// eight rows a block, 16-byte accesses.  Bound: bytes.
//
// isg_attention_mma (bf16 models): the attention core on the tensor
// cores, one block per question and group of up to four heads, one warp
// per head.  The block stages its heads' columns of the question's q, k
// and v rows with 16-byte loads into shared memory
// (rows padded by 16 bytes so that ldmatrix reads hit distinct banks,
// rows past L zero), then each warp walks its head's queries 16 at a
// time: Q.K^T on mma.sync m16n8k16 (bf16 in, f32 sums) for up to 64 keys
// held in registers, the softmax in registers (scale, the key bias
// ADDED, keys past L at -inf, each row's max and sum over the quad that
// holds it), the probabilities saved and multiplied by the dropout keep
// mask where asked, rounded to bf16 and fed from the same registers as
// the A operand of P.V (V through ldmatrix.trans).  The output goes
// through shared memory back to coalesced 16-byte stores.  The products
// are ~2 L^2 D FLOPs per question against ~8 L D bytes, so at L <= 64 the
// core is bound by bytes; one pass over q, k and v meets that.

#include "common.cuh"
#include "ln_rows.cuh"

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

// The separate residual + LayerNorm pass (ln_rows.cuh): eight warps of R
// rows each a block.
template <int R, int Q>
__global__ void __launch_bounds__(256)
residual_ln_kernel(const float* __restrict__ y, LnRows p) {
  const int m0 = blockIdx.x * 8 * R;
  ln_rows<R, Q>(y + (long)m0 * p.N, p.N, p, m0);
}


// ---------------------------------------------------------------- bf16 mma

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [0, rows) of a question's [L, D] operand (pitch rs) into shared
// rows of pitch P, rows [L, rows) zero; 16-byte chunks.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int P,
                                           const __nv_bfloat16* src, long rs,
                                           int L, int rows, int D) {
  const int cpr = D / 8;
  for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
    const int r = i / cpr, c = (i % cpr) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < L) v = *reinterpret_cast<const uint4*>(src + r * rs + c);
    *reinterpret_cast<uint4*>(dst + r * P + c) = v;
  }
}

constexpr int kMaxKeys = 64;

template <int DH>
__global__ void attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, int q_rs,
    const __nv_bfloat16* __restrict__ k, int k_rs,
    const __nv_bfloat16* __restrict__ v, int v_rs,
    const float* __restrict__ bias, const float* __restrict__ keep,
    float* __restrict__ probs, __nv_bfloat16* __restrict__ o, int Lq, int Lk,
    int H, float scale) {
  extern __shared__ __align__(16) uint8_t sm_raw[];
  // this block's heads: blockDim.x / 32 of them from head h0 on
  const int HB = blockDim.x / 32, h0 = blockIdx.y * HB;
  const int D = H * DH, DB = HB * DH, c0 = h0 * DH, P = DB + 8;
  const int Lqp = (Lq + 15) / 16 * 16, Lkp = (Lk + 15) / 16 * 16;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(sm_raw);
  __nv_bfloat16* ks = qs + Lqp * P;
  __nv_bfloat16* vs = ks + Lkp * P;
  float* bs = reinterpret_cast<float*>(vs + Lkp * P);   // key bias [Lkp]
  const int b = blockIdx.x;
  stage_rows(qs, P, q + (long)b * Lq * q_rs + c0, q_rs, Lq, Lqp, DB);
  stage_rows(ks, P, k + (long)b * Lk * k_rs + c0, k_rs, Lk, Lkp, DB);
  stage_rows(vs, P, v + (long)b * Lk * v_rs + c0, v_rs, Lk, Lkp, DB);
  for (int c = threadIdx.x; c < Lkp; c += blockDim.x)
    bs[c] = c < Lk ? (bias ? bias[(long)b * Lk + c] : 0.f)
                   : __int_as_float(0xff800000);   // -inf
  __syncthreads();

  const int lane = threadIdx.x % 32, h = h0 + threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4, col = (threadIdx.x / 32) * DH;
  for (int mt = 0; mt < Lqp / 16; ++mt) {
    float s[kMaxKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kMaxKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qs + (mt * 16 + lane % 16) * P + col + kk * 16 +
                     (lane / 16) * 8);
#pragma unroll
      for (int jp = 0; jp < kMaxKeys / 16; ++jp) {
        if (jp * 16 >= Lkp) break;
        uint32_t bb[4];
        ldsm_x4(bb, ks + (jp * 16 + lane % 8 + (lane / 16) * 8) * P + col +
                        kk * 16 + ((lane / 8) % 2) * 8);
        mma16816(s[2 * jp], a, bb[0], bb[1]);
        mma16816(s[2 * jp + 1], a, bb[2], bb[3]);
      }
    }
    // softmax over the keys of rows g and g + 8 (registers 2i, 2i + 1)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = mt * 16 + g + 8 * i;
      float mx = __int_as_float(0xff800000);
#pragma unroll
      for (int j = 0; j < kMaxKeys / 8; ++j) {
        if (j * 8 >= Lkp) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * i + e] * scale + bs[8 * j + 2 * t4 + e];
          s[j][2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxKeys / 8; ++j) {
        if (j * 8 >= Lkp) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ex = expf(s[j][2 * i + e] - mx);
          s[j][2 * i + e] = ex;
          sum += ex;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const long prow = (((long)b * H + h) * Lq + r) * Lk;
#pragma unroll
      for (int j = 0; j < kMaxKeys / 8; ++j) {
        if (j * 8 >= Lkp) break;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 8 * j + 2 * t4 + e;
          float pv = s[j][2 * i + e] / sum;
          if (r < Lq && key < Lk) {
            if (probs) probs[prow + key] = pv;     // saved for the backward
            if (keep) pv *= keep[prow + key];      // dropout on the probs
          }
          s[j][2 * i + e] = pv;
        }
      }
    }
    // O = P . V: P's accumulator tiles are the A fragments of m16n8k16
    float oc[DH / 8][4];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMaxKeys / 16; ++kk) {
      if (kk * 16 >= Lkp) break;
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * P +
                          col + np * 16 + (lane / 16) * 8);
        mma16816(oc[2 * np], a, bb[0], bb[1]);
        mma16816(oc[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    // this warp's head columns of these 16 query rows are its own
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<uint32_t*>(qs + (mt * 16 + g + 8 * i) * P + col +
                                     8 * j + 2 * t4) =
            pack_bf16(oc[j][2 * i], oc[j][2 * i + 1]);
  }
  __syncthreads();
  const int cpr = DB / 8;
  for (int i = threadIdx.x; i < Lq * cpr; i += blockDim.x) {
    const int r = i / cpr, c = (i % cpr) * 8;
    *reinterpret_cast<uint4*>(o + ((long)b * Lq + r) * D + c0 + c) =
        *reinterpret_cast<const uint4*>(qs + r * P + c);
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

// out = LN2?(LN1(x + y * ymask)) over rows of D <= 1024 columns, D a
// multiple of 4; ymask, g2/b2, z_out (the pre-LN sum), out_f and out_t
// may each be null.
ISG_API int isg_residual_ln(const void* x, int x_dt, const float* y,
                            const float* g1, const float* b1, const float* g2,
                            const float* b2, const float* ymask, float* z_out,
                            float* out_f, void* out_t,
                            int t_dt, int M, int D, float eps, void* stream) {
  if (!y || D % 4 || D > 1024 || M < 1) return (int)cudaErrorInvalidValue;
  LnRows p = {};
  p.x = x;
  p.x_dt = x_dt;
  p.ymask = ymask;
  p.g1 = g1;
  p.b1 = b1;
  p.g2 = g2;
  p.b2 = b2;
  p.z_out = z_out;
  p.out_f = out_f;
  p.out_t = out_t;
  p.t_dt = t_dt;
  p.eps = eps;
  p.M = M;
  p.N = D;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 512)
    residual_ln_kernel<8, 4><<<(M + 63) / 64, 256, 0, st>>>(y, p);
  else
    residual_ln_kernel<4, 8><<<(M + 31) / 32, 256, 0, st>>>(y, p);
  return (int)cudaGetLastError();
}

template <int DH>
static void attention_mma_smem() {
  static bool done = false;      // once per kernel: a host call per launch
  if (!done) {
    cudaFuncSetAttribute(attention_mma_kernel<DH>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         227 * 1024);
    done = true;
  }
}

// The bf16 attention core on the tensor cores (see the note at the top):
// the same operands as isg_attention, o written with pitch H * dh.
// Lq, Lk <= 64, dh in {16, 32, 64, 128}, H <= 16; every row pitch a
// multiple of 8 elements and q, k, v 16-byte aligned.
ISG_API int isg_attention_mma(const void* q, int q_rs, const void* k,
                              int k_rs, const void* v, int v_rs,
                              const float* bias, const float* keep,
                              float* probs, void* o, int B, int Lq, int Lk,
                              int H, int dh, float scale, void* stream) {
  if (Lq < 1 || Lk < 1 || Lq > kMaxKeys || Lk > kMaxKeys || H < 1 || H > 16 ||
      q_rs % 8 || k_rs % 8 || v_rs % 8 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorInvalidValue;
  // up to four heads a block: more, smaller blocks hide the loads better
  const int HB = H <= 4 ? H : (H % 4 == 0 ? 4 : H);
  const int P = HB * dh + 8;
  const int Lqp = (Lq + 15) / 16 * 16, Lkp = (Lk + 15) / 16 * 16;
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(Lqp + 2 * Lkp) * P +
                      sizeof(float) * Lkp;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(o);
#define ISG_ATTN_MMA(DH)                                                    \
  case DH:                                                                 \
    attention_mma_smem<DH>();                                              \
    attention_mma_kernel<DH><<<dim3(B, H / HB), 32 * HB, smem, st>>>(      \
        qb, q_rs, kb, k_rs, vb, v_rs, bias, keep, probs, ob, Lq, Lk, H,    \
        scale);                                                            \
    break;
  switch (dh) {
    ISG_ATTN_MMA(16)
    ISG_ATTN_MMA(32)
    ISG_ATTN_MMA(64)
    ISG_ATTN_MMA(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ISG_ATTN_MMA
  return (int)cudaGetLastError();
}
