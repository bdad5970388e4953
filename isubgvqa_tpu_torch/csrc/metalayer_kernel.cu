// Scene-graph MetaLayer kernels: mean aggregation and GraphNorm.
//
// With the graph-layer GEMM (gemm_gather_sm90.cu for bf16, gemm.cu for
// f32: the edge MLP on [x_src, x_dst, e] with
// its [C, 3C] weight split by columns, node MLP1 on [x_src, e_out],
// node MLP2 on [x, agg]) they replace the Pallas kernel
// isubgvqa_tpu/ops/pallas/metalayer_kernel.py:fused_metalayer (_kernel).
//
// isg_scatter_mean: one block per (graph, 64-channel slice).  Each
// thread owns one channel and walks the graph's edges in order, adding
// the message into a shared-memory row of its destination node, so the
// sum is deterministic and needs no atomics (the TPU did it as a
// one-hot matmul).  Degrees count valid incoming edges and are clamped
// to >= 1.  Bound: bytes (each message read once).
//
// isg_graph_index: the gathers' row indices of the edge MLP and node
// MLP1, src and dst into the flattened [B * N] node rows (-1, a zero row,
// on padding edges and on an index outside the graph), and the edge mask
// as f32, in one pass: one launch in place of a dozen elementwise ops on
// the host's path to the first product.  Bound: bytes.
//
// isg_graph_norm: one block per graph.  GraphNorm over the graph's
// valid nodes: mean scaled by alpha, eps 1e-5, then normed * mask * w
// + b, so padding rows come out as b (+ the residual).  Optionally it
// first applies the GAT layer's instruction SDP softmax over valid nodes
// (gat_kernel.py:196-206) and adds the residual h; fused_gat_layer reuses
// it for its node half.  Bound: bytes.

#include "common.cuh"

namespace isg {

constexpr int kSliceC = 64;

__global__ void graph_index_kernel(const int* __restrict__ src,
                                   const int* __restrict__ dst,
                                   const bool* __restrict__ emask,
                                   int* __restrict__ gidx,
                                   float* __restrict__ emf, int E, int N,
                                   long total) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const int base = (int)(i / E) * N, s = src[i], d = dst[i];
    const bool v = emask[i];
    gidx[i] = v && s >= 0 && s < N ? base + s : -1;
    gidx[total + i] = v && d >= 0 && d < N ? base + d : -1;
    emf[i] = v ? 1.f : 0.f;
  }
}

template <typename TO>
__global__ void scatter_mean_kernel(const float* __restrict__ m,
                                    const int* __restrict__ dst,
                                    const float* __restrict__ emask,
                                    TO* __restrict__ agg, int N, int E, int C) {
  extern __shared__ float acc[];        // [N, kSliceC] then deg[N]
  float* deg = acc + N * kSliceC;
  const int b = blockIdx.x;
  const int c = blockIdx.y * kSliceC + threadIdx.x;
  for (int i = threadIdx.x; i < N * kSliceC; i += blockDim.x) acc[i] = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float d = 0.f;
    for (int e = 0; e < E; ++e)
      if (emask[b * E + e] > 0.f && dst[b * E + e] == n) d += 1.f;
    deg[n] = fmaxf(d, 1.f);
  }
  __syncthreads();
  if (c < C) {
    for (int e = 0; e < E; ++e) {
      const int d = dst[b * E + e];
      if (emask[b * E + e] > 0.f && d >= 0 && d < N)   // in-graph edges only
        acc[d * kSliceC + threadIdx.x] += m[((long)b * E + e) * C + c];
    }
    for (int n = 0; n < N; ++n)
      agg[((long)b * N + n) * C + c] =
          from_f<TO>(acc[n * kSliceC + threadIdx.x] / deg[n]);
  }
}

template <typename TI, typename TO>
__global__ void graph_norm_kernel(const float* __restrict__ p,
                                  const float* __restrict__ nmask,
                                  const TI* __restrict__ instr,
                                  const TI* __restrict__ h,
                                  const float* __restrict__ w,
                                  const float* __restrict__ bias,
                                  const float* __restrict__ ms,
                                  TO* __restrict__ out, int N, int C,
                                  float eps) {
  extern __shared__ float sm[];
  float* sdp = sm;                      // [N]
  float* ins = sm + N;                  // [C]
  __shared__ float count;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  const float* pb = p + (long)b * N * C;
  const float* mb = nmask + (long)b * N;

  if (tid == 0) {
    float s = 0.f;
    for (int n = 0; n < N; ++n) s += mb[n];
    count = fmaxf(s, 1.f);
  }
  if (instr) {
    for (int c = tid; c < C; c += nt) ins[c] = to_f(instr[(long)b * C + c]);
    __syncthreads();
    const float inv = 1.f / sqrtf((float)C);
    for (int n = warp; n < N; n += nw) {
      float s = 0.f;
      for (int c = lane; c < C; c += 32) s += pb[(long)n * C + c] * ins[c];
      s = warp_sum(s);
      if (lane == 0) sdp[n] = mb[n] > 0.f ? s * inv : kNeg;
    }
    __syncthreads();
    if (warp == 0) {
      float mx = kNeg;
      for (int n = lane; n < N; n += 32) mx = fmaxf(mx, sdp[n]);
      mx = warp_max(mx);
      float s = 0.f;
      for (int n = lane; n < N; n += 32) {
        const float e = expf(sdp[n] - mx) * mb[n];
        sdp[n] = e;
        s += e;
      }
      s = warp_sum(s);
      const float den = s > 1e-12f ? s : 1.f;
      for (int n = lane; n < N; n += 32) sdp[n] = sdp[n] / den;
    }
  } else {
    for (int n = tid; n < N; n += nt) sdp[n] = 1.f;
  }
  __syncthreads();

  // Each thread walks its channel's column down the nodes.  The loops are
  // unrolled 16 deep so that enough of those loads are in flight: at 4
  // or 8 the kernel ran 20-60 % slower on the H100.
  for (int c = tid; c < C; c += nt) {
    float s = 0.f;
#pragma unroll 16
    for (int n = 0; n < N; ++n) s += pb[(long)n * C + c] * sdp[n] * mb[n];
    const float mean = s / count;
    const float shift = ms[c] * mean;
    float v = 0.f;
#pragma unroll 16
    for (int n = 0; n < N; ++n) {
      const float d = pb[(long)n * C + c] * sdp[n] - shift;
      v += d * d * mb[n];
    }
    const float r = rsqrtf(v / count + eps);
#pragma unroll 16
    for (int n = 0; n < N; ++n) {
      const long i = ((long)b * N + n) * C + c;
      float y = (pb[(long)n * C + c] * sdp[n] - shift) * r * mb[n] * w[c] + bias[c];
      if (h) y += to_f(h[i]);
      out[i] = from_f<TO>(y);
    }
  }
}

}  // namespace isg

using namespace isg;

// agg[b, n, :] = sum of m over valid edges into n / max(deg, 1); m is f32.
// gidx [2, B * E] int32 (src rows, then dst rows), emf [B * E] f32.
ISG_API int isg_graph_index(const int* src, const int* dst, const bool* emask,
                            int* gidx, float* emf, int B, int E, int N,
                            void* stream) {
  const long total = (long)B * E;
  const int blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256
                                                       : 1024);
  if (total == 0) return 0;
  graph_index_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      src, dst, emask, gidx, emf, E, N, total);
  return (int)cudaGetLastError();
}

ISG_API int isg_scatter_mean(const float* m, const int* dst,
                             const float* emask, void* agg, int agg_dt, int B,
                             int N, int E, int C, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)N * kSliceC + N);
  dim3 grid(B, (C + kSliceC - 1) / kSliceC);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ISG_WITH_T(agg_dt, TO,
      allow_smem(scatter_mean_kernel<TO>, smem);
      scatter_mean_kernel<TO><<<grid, kSliceC, smem, st>>>(
          m, dst, emask, static_cast<TO*>(agg), N, E, C));
  return (int)cudaGetLastError();
}

// p is f32 [B*N, C]; instr [B, C] and h [B*N, C] share the dtype io_dt;
// instr and h may be null.
ISG_API int isg_graph_norm(const float* p, const float* nmask,
                           const void* instr, const void* h, int io_dt,
                           const float* w, const float* bias,
                           const float* ms, void* out,
                           int out_dt, int B, int N, int C, float eps,
                           void* stream) {
  const size_t smem = sizeof(float) * ((size_t)N + C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ISG_WITH_T(io_dt, TI, ISG_WITH_T(out_dt, TO,
      allow_smem(graph_norm_kernel<TI, TO>, smem);
      graph_norm_kernel<TI, TO><<<B, 256, smem, st>>>(
          p, nmask, static_cast<const TI*>(instr), static_cast<const TI*>(h),
          w, bias, ms, static_cast<TO*>(out), N, C, eps)));
  return (int)cudaGetLastError();
}
