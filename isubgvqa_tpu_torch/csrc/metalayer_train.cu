// Backward kernels of the scene-graph MetaLayer round + GraphNorm.
//
// With the shared GEMM's backward forms (gemm.cu) they replace the
// backward Pallas kernel of isubgvqa_tpu/ops/pallas/metalayer_train.py
// (_bwd_kernel, called from _metalayer_bwd_call).  The TPU kernel
// recomputes the forward per graph in VMEM; here the forward
// (metalayer_kernel.cu and the shared GEMM) saves the pre-activations and
// the products' operands, and these kernels do the non-GEMM steps:
//
// isg_graph_norm_bwd: one block per graph, one thread per channel, the
//   backward of y = w * (p - a * mean) / sqrt(var + eps) * mask + b over
//   the graph's valid nodes (mean and var over valid nodes, count clamped
//   at 1).  Writes dp and the graph's partial gradients of w, b and the
//   learnable mean scale a; isg_reduce_rows sums those over graphs.
// isg_gelu_bwd: dx = dy * (Phi(x) + x phi(x)), the exact GELU's
//   derivative at the saved pre-activation (erff / expf).
// isg_scatter_mean_bwd: the mean aggregation's backward, a gather:
//   dm[e] = mask[e] * dagg[dst[e]] / max(deg[dst[e]], 1), one block per
//   graph (degrees counted in shared memory as in the forward).
// isg_scatter_rows: dx[n] += sum of ds[e] over valid edges with src = n
//   and of dd[e] over valid edges with dst = n — the gradients of the
//   gathered x[src] / x[dst] rows sent back to their nodes.  One block per
//   (graph, 64-channel slice), each thread owning a channel and walking
//   the edges in order into shared memory: deterministic, no atomics.
// All four are bound by bytes.

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
    part[(0L * B + b) * C + c] = dw;
    part[(1L * B + b) * C + c] = db;
    part[(2L * B + b) * C + c] = -dmean_col * mean;
  }
}

__global__ void gelu_bwd_kernel(const float* __restrict__ dy,
                                const float* __restrict__ x,
                                float* __restrict__ dx, long n) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const float v = x[i];
    const float cdf = 0.5f * (1.f + erff(v * 0.70710678118654752f));
    const float pdf = 0.39894228040143268f * expf(-0.5f * v * v);
    dx[i] = dy[i] * (cdf + v * pdf);
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

__global__ void scatter_rows_kernel(const float* __restrict__ ds,
                                    const float* __restrict__ dd,
                                    const int* __restrict__ src,
                                    const int* __restrict__ dst,
                                    const float* __restrict__ emask,
                                    float* __restrict__ dx, int N, int E,
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
    for (int n = 0; n < N; ++n)
      dx[((long)b * N + n) * C + c] += acc[n * kSlice + threadIdx.x];
  }
}

}  // namespace isg

using namespace isg;

// dp [B*N, C] f32 and part [3, B, C] (dw, db, da per graph) from the
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

ISG_API int isg_gelu_bwd(const float* dy, const float* x, float* dx, long n,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long want = (n + 255) / 256;
  const int blocks = (int)(want < 4096 ? (want > 0 ? want : 1) : 4096);
  gelu_bwd_kernel<<<blocks, 256, 0, st>>>(dy, x, dx, n);
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

// dx [B*N, C] += scatter of ds by src and dd by dst.
ISG_API int isg_scatter_rows(const float* ds, const float* dd, const int* src,
                             const int* dst, const float* emask, float* dx,
                             int B, int N, int E, int C, void* stream) {
  const size_t smem = sizeof(float) * (size_t)N * kSlice;
  dim3 grid(B, (C + kSlice - 1) / kSlice);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  allow_smem(scatter_rows_kernel, smem);
  scatter_rows_kernel<<<grid, kSlice, smem, st>>>(ds, dd, src, dst, emask, dx,
                                                  N, E, C);
  return (int)cudaGetLastError();
}
