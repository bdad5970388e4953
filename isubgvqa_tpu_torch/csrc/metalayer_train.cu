// Backward kernels of the scene-graph MetaLayer round + GraphNorm.
//
// With the staged backward GEMM (gemm_bwd.cu: each stage's dgrad and
// wgrad in one launch, the bias gradients, GELU's derivative, the
// accumulation into the e_out gradient and the output cast in its
// epilogue) they replace the backward Pallas kernel of
// isubgvqa_tpu/ops/pallas/metalayer_train.py (_bwd_kernel, called from
// _metalayer_bwd_call).  The TPU kernel recomputes the forward per graph
// in VMEM; here the forward (metalayer_kernel.cu and the graph-layer GEMM)
// saves the pre-activations and the products' operands, and these kernels
// do the steps that are no product:
//
// isg_graph_norm_bwd: one block per graph, one thread per channel, the
//   backward of y = w * (p - a * mean) / sqrt(var + eps) * mask + b over
//   the graph's valid nodes (mean and var over valid nodes, count clamped
//   at 1).  Writes dp and the graph's partial gradients of w, b and the
//   learnable mean scale a, laid out [B, 3, C] so that one isg_reduce_rows
//   sums all three over the graphs, in order.
// isg_scatter_mean_bwd: the mean aggregation's backward, a gather:
//   dm[e] = mask[e] * dagg[dst[e]] / max(deg[dst[e]], 1), one block per
//   graph (degrees counted in shared memory as in the forward).
// isg_scatter_rows: out[n] = base[n] + the sum of ds[e] over valid edges
//   with src = n and of dd[e] over valid edges with dst = n — the
//   gradients of the gathered x[src] / x[dst] rows sent back to their
//   nodes and written at the input's dtype.  One block per (graph,
//   64-channel slice), each thread owning a channel and walking the edges
//   in order into shared memory: deterministic, no atomics.
// All three are bound by bytes.

#include "common.cuh"

namespace isg {

constexpr int kSlice = 64;

template <typename TG>
__global__ void graph_norm_bwd_kernel(const TG* __restrict__ dout,
                                      const float* __restrict__ p,
                                      const float* __restrict__ nmask,
                                      const float* __restrict__ w,
                                      const float* __restrict__ ms,
                                      float* __restrict__ dp,
                                      float* __restrict__ part, int B, int N,
                                      int C, float eps) {
  const int b = blockIdx.x;
  const float* pb = p + (long)b * N * C;
  const TG* gb = dout + (long)b * N * C;
  const float* mb = nmask + (long)b * N;
  float count = 0.f;
  for (int n = 0; n < N; ++n) count += mb[n];
  count = fmaxf(count, 1.f);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int n = 0; n < N; ++n) s += pb[(long)n * C + c] * mb[n];
    const float mean = s / count;
    const float a = ms[c];
    float v = 0.f;
    for (int n = 0; n < N; ++n) {
      const float d = pb[(long)n * C + c] - a * mean;
      v += d * d * mb[n];
    }
    const float r = rsqrtf(v / count + eps);
    float dw = 0.f, db = 0.f, dr = 0.f;
    for (int n = 0; n < N; ++n) {
      const float g = to_f(gb[(long)n * C + c]);
      const float sh = pb[(long)n * C + c] - a * mean;
      dw += g * sh * r * mb[n];
      db += g;
      dr += g * w[c] * sh * mb[n];
    }
    const float dvar = dr * -0.5f * r * r * r;
    float dmean_col = 0.f;
    for (int n = 0; n < N; ++n) {
      const float g = to_f(gb[(long)n * C + c]);
      const float sh = pb[(long)n * C + c] - a * mean;
      const float dsh = g * w[c] * r * mb[n] + 2.f * sh * mb[n] * dvar / count;
      dp[((long)b * N + n) * C + c] = dsh;
      dmean_col += dsh;
    }
    const float dm = -a * dmean_col / count;
    for (int n = 0; n < N; ++n) dp[((long)b * N + n) * C + c] += mb[n] * dm;
    part[(3L * b + 0) * C + c] = dw;
    part[(3L * b + 1) * C + c] = db;
    part[(3L * b + 2) * C + c] = -dmean_col * mean;
  }
}

__global__ void scatter_mean_bwd_kernel(const float* __restrict__ dagg,
                                        const int* __restrict__ dst,
                                        const float* __restrict__ emask,
                                        float* __restrict__ dm, int N, int E,
                                        int C) {
  extern __shared__ float deg[];        // [N]
  const int b = blockIdx.x;
  for (int n = threadIdx.x; n < N; n += blockDim.x) deg[n] = 0.f;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int e = 0; e < E; ++e) {
      const int d = dst[b * E + e];
      if (emask[b * E + e] > 0.f && d >= 0 && d < N) deg[d] += 1.f;
    }
  __syncthreads();
  for (long i = threadIdx.x; i < (long)E * C; i += blockDim.x) {
    const int e = (int)(i / C), c = (int)(i % C);
    const int d = dst[b * E + e];
    float v = 0.f;
    if (emask[b * E + e] > 0.f && d >= 0 && d < N)
      v = dagg[((long)b * N + d) * C + c] / fmaxf(deg[d], 1.f);
    dm[((long)b * E + e) * C + c] = v;
  }
}

template <typename TO>
__global__ void scatter_rows_kernel(const float* __restrict__ ds,
                                    const float* __restrict__ dd,
                                    const int* __restrict__ src,
                                    const int* __restrict__ dst,
                                    const float* __restrict__ emask,
                                    const float* __restrict__ base,
                                    TO* __restrict__ out, int N, int E,
                                    int C) {
  extern __shared__ float acc[];        // [N, kSlice]
  const int b = blockIdx.x;
  const int c = blockIdx.y * kSlice + threadIdx.x;
  for (int i = threadIdx.x; i < N * kSlice; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  if (c < C) {
    for (int e = 0; e < E; ++e) {
      if (!(emask[b * E + e] > 0.f)) continue;
      const int s = src[b * E + e], d = dst[b * E + e];
      if (s < 0 || s >= N || d < 0 || d >= N) continue;   // as the forward
      const long er = ((long)b * E + e) * C + c;
      acc[s * kSlice + threadIdx.x] += ds[er];
      acc[d * kSlice + threadIdx.x] += dd[er];
    }
    for (int n = 0; n < N; ++n) {
      const long o = ((long)b * N + n) * C + c;
      out[o] = from_f<TO>(base[o] + acc[n * kSlice + threadIdx.x]);
    }
  }
}

}  // namespace isg

using namespace isg;

// dp [B*N, C] f32 and part [B, 3, C] (dw, db, da per graph) from the
// gradient dout (dtype g_dt) of GraphNorm(p).
ISG_API int isg_graph_norm_bwd(const void* dout, int g_dt, const float* p,
                               const float* nmask, const float* w,
                               const float* ms, float* dp, float* part, int B,
                               int N, int C, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ISG_WITH_T(g_dt, TG,
      graph_norm_bwd_kernel<TG><<<B, 128, 0, st>>>(
          static_cast<const TG*>(dout), p, nmask, w, ms, dp, part, B, N, C,
          eps));
  return (int)cudaGetLastError();
}

ISG_API int isg_scatter_mean_bwd(const float* dagg, const int* dst,
                                 const float* emask, float* dm, int B, int N,
                                 int E, int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  scatter_mean_bwd_kernel<<<B, 256, sizeof(float) * N, st>>>(
      dagg, dst, emask, dm, N, E, C);
  return (int)cudaGetLastError();
}

// out [B*N, C] (dtype out_dt) = base + scatter of ds by src and dd by dst.
ISG_API int isg_scatter_rows(const float* ds, const float* dd, const int* src,
                             const int* dst, const float* emask,
                             const float* base, void* out, int out_dt, int B,
                             int N, int E, int C, void* stream) {
  const size_t smem = sizeof(float) * (size_t)N * kSlice;
  dim3 grid(B, (C + kSlice - 1) / kSlice);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ISG_WITH_T(out_dt, TO,
      allow_smem(scatter_rows_kernel<TO>, smem);
      scatter_rows_kernel<TO><<<grid, kSlice, smem, st>>>(
          ds, dd, src, dst, emask, base, static_cast<TO*>(out), N, E, C));
  return (int)cudaGetLastError();
}
