// Masked GATv2 layer kernels: instruction gating and the edge half.
//
// With the graph-layer GEMM (gemm_gather_sm90.cu for bf16, gemm.cu for
// f32: x_l | x_r, lin_edge and the x_proj MLP)
// and the GraphNorm kernel (metalayer_kernel.cu: instruction SDP,
// GraphNorm, residual) they replace the Pallas kernel
// isubgvqa_tpu/ops/pallas/gat_kernel.py:fused_gat_layer (_kernel).
//
// isg_instr_gelu: xf = gelu(h * instr[graph]) computed in f32 and
// rounded to the model dtype (the fuse_instr branch, gat_kernel.py:98-105).
//
// isg_gat_edge: one block per (graph, head), B * H blocks (N <= 256
// nodes, E <= 1024 edges); the logits, the softmax and the head's
// channels of conv need nothing of the other heads, and four times as many
// blocks as graphs spread evenly over the 132 SMs (at B = 256, one block
// per graph would fill them in two uneven waves).
//   1. edge gate gate[src] * gate[dst], 0 on padding edges, and the
//      incoming-edge lists per node (common.cuh:group_edges, a stable
//      counting sort in shared memory);
//   2. one warp per edge: m = x_l[src] + x_r[dst] + eproj over the head's
//      channels, multiplied by the edge gate before and after leaky-ReLU,
//      dotted with att; padding edges get the logit -1e30;
//   3. per destination: max over incoming valid edges (floor -1e30) and
//      the sum of exponentials, each by one thread walking its list in
//      edge order;
//   4. alpha = exp / (sum if sum > 1e-12 else 1), written out;
//   5. conv[n] = sum over incoming edges of round(x_l[src] * alpha *
//      egate) + bias, rounded to the model dtype: the aggregation reads
//      x_l, not x_r (gat_kernel.py:177-185).
// Bound: bytes at these shapes (x_l, x_r, eproj read once per edge, conv
// written once); the sorted incoming lists keep the scatter free of
// atomics and deterministic.  The TPU packed several graphs per program
// for its 128-row MXU; that is not carried over.

#include "common.cuh"

namespace isg {

constexpr float kSlope = 0.2f;          // GATv2's leaky-ReLU

template <typename T>
__global__ void instr_gelu_kernel(const T* __restrict__ h,
                                  const T* __restrict__ instr,
                                  T* __restrict__ xf, long total, int NC,
                                  int C) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const long b = i / NC;
    const int c = (int)(i % C);
    xf[i] = from_f<T>(gelu_exact(to_f(h[i]) * to_f(instr[b * C + c])));
  }
}

// TX: x_l / x_r (rows of pitch ldx: the eval layer's x_l and x_r are the
// two column halves of one stacked product), TE: projected edges, TC:
// conv.  The eval layer runs
// all three at the model dtype and rounds each weighted message to it
// (kRound); the training conv (gat_train.cu's forward) reads f32 x_l /
// x_r and writes f32 conv without rounding, as the Pallas training
// kernel does (gat_train.py:_fwd_kernel).
template <typename TX, typename TE, typename TC, bool kRound>
__global__ void gat_edge_kernel(const TX* __restrict__ xl,
                                const TX* __restrict__ xr,
                                const TE* __restrict__ ep,
                                const float* __restrict__ gate,
                                const int* __restrict__ src,
                                const int* __restrict__ dst,
                                const float* __restrict__ emask,
                                const float* __restrict__ att,
                                const float* __restrict__ cbias,
                                float* __restrict__ alpha,
                                TC* __restrict__ conv, int N, int E, int C,
                                int ldx) {
  extern __shared__ float sm[];
  float* lg = sm;                       // [E] logits
  float* wg = lg + E;                   // [E] alpha * egate
  float* eg = wg + E;                   // [E] edge gate
  float* mx = eg + E;                   // [N]
  float* den = mx + N;                  // [N]
  int* dS = reinterpret_cast<int*>(den + N);   // [E] dst or -1
  int* sS = dS + E;                     // [E] src
  int* lst = sS + E;                    // [E] edges grouped by dst
  int* cur = lst + E;                   // [N] scratch of the sort
  int* off = cur + N;                   // [N + 1]

  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  const int HC = H * C, h0 = h * C;
  const long nb = (long)b * N, eb = (long)b * E;

  for (int e = tid; e < E; e += nt) {
    const int s = src[eb + e], d = dst[eb + e];
    // an index outside the graph makes the edge padding, never a read
    // outside it
    const bool valid = emask[eb + e] > 0.f && s >= 0 && s < N && d >= 0 &&
                       d < N;
    sS[e] = valid ? s : 0;
    dS[e] = valid ? d : -1;
    eg[e] = valid ? gate[nb + s] * gate[nb + d] : 0.f;
  }
  __syncthreads();
  group_edges(E, N, [&](int e) { return dS[e]; }, off, cur, lst);

  const float* at = att + h0;
  for (int e = warp; e < E; e += nw) {
    const int d = dS[e];
    if (d < 0) {
      if (lane == 0) lg[e] = kNeg;
      continue;
    }
    const float g = eg[e];
    const TX* xs = xl + (nb + sS[e]) * ldx + h0;
    const TX* xd = xr + (nb + d) * ldx + h0;
    const TE* pe = ep + (eb + e) * HC + h0;
    float acc = 0.f;
#pragma unroll 4
    for (int c = lane; c < C; c += 32) {
      float m = (to_f(xs[c]) + to_f(xd[c])) + to_f(pe[c]);
      m *= g;
      m = m >= 0.f ? m : m * kSlope;
      m *= g;
      acc = fmaf(m, at[c], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) lg[e] = acc;
  }
  __syncthreads();

  for (int n = tid; n < N; n += nt) {
    float m = kNeg;
    for (int q = off[n]; q < off[n + 1]; ++q) m = fmaxf(m, lg[lst[q]]);
    float s = 0.f;
    for (int q = off[n]; q < off[n + 1]; ++q) s += expf(lg[lst[q]] - m);
    mx[n] = m;
    den[n] = s;
  }
  __syncthreads();

  for (int e = tid; e < E; e += nt) {
    const int d = dS[e];
    float a = 0.f;
    if (d >= 0) {
      const float s = den[d];
      a = expf(lg[e] - mx[d]) / (s > 1e-12f ? s : 1.f);
    }
    alpha[(eb + e) * H + h] = a;
    wg[e] = a * eg[e];
  }
  __syncthreads();

  // a thread per channel of the head, walking the nodes in order
  for (int c = tid; c < C; c += nt) {
    const int j = h0 + c;
    for (int n = 0; n < N; ++n) {
      float acc = 0.f;
      for (int q = off[n]; q < off[n + 1]; ++q) {
        const int e = lst[q];
        const float w = to_f(xl[(nb + sS[e]) * ldx + j]) * wg[e];
        acc += kRound ? round_to<TC>(w) : w;
      }
      conv[(nb + n) * HC + j] = from_f<TC>(acc + cbias[j]);
    }
  }
}

}  // namespace isg

using namespace isg;

static size_t gat_edge_smem(int N, int E) {
  return sizeof(float) * (3 * (size_t)E + 2 * (size_t)N) +
         sizeof(int) * (3 * (size_t)E + 2 * (size_t)N + 1);
}

// a thread per channel of a head in the aggregation
static int gat_edge_threads(int C) {
  const int t = (C + 31) / 32 * 32;
  return t < 128 ? 128 : t > 1024 ? 1024 : t;
}

ISG_API int isg_instr_gelu(const void* h, const void* instr, void* xf, int dt,
                           int B, int N, int C, void* stream) {
  const long total = (long)B * N * C;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ISG_WITH_T(dt, T,
      instr_gelu_kernel<T><<<blocks, threads, 0, st>>>(
          static_cast<const T*>(h), static_cast<const T*>(instr),
          static_cast<T*>(xf), total, N * C, C));
  return (int)cudaGetLastError();
}

// x_l / x_r rows of pitch ldx elements.
ISG_API int isg_gat_edge(const void* xl, const void* xr, int ldx,
                         const void* ep, int dt, const float* gate,
                         const int* src, const int* dst, const float* emask,
                         const float* att, const float* cbias, float* alpha,
                         void* conv, int B, int N, int E, int H, int C,
                         void* stream) {
  const size_t smem = gat_edge_smem(N, E);
  dim3 grid(H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ISG_WITH_T(dt, T,
      allow_smem(gat_edge_kernel<T, T, T, true>, smem);
      gat_edge_kernel<T, T, T, true><<<grid, gat_edge_threads(C), smem, st>>>(
          static_cast<const T*>(xl), static_cast<const T*>(xr),
          static_cast<const T*>(ep), gate, src, dst, emask, att, cbias, alpha,
          static_cast<T*>(conv), N, E, C, ldx));
  return (int)cudaGetLastError();
}

// The training conv's forward: f32 x_l / x_r, projected edges at ep_dt,
// f32 conv [B*N, H*C] and alpha, no rounding of the messages.
ISG_API int isg_gat_edge_train(const float* xl, const float* xr,
                               const void* ep, int ep_dt, const float* gate,
                               const int* src, const int* dst,
                               const float* emask, const float* att,
                               const float* cbias, float* alpha, float* conv,
                               int B, int N, int E, int H, int C,
                               void* stream) {
  const size_t smem = gat_edge_smem(N, E);
  dim3 grid(H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ISG_WITH_T(ep_dt, TE,
      allow_smem(gat_edge_kernel<float, TE, float, false>, smem);
      gat_edge_kernel<float, TE, float, false>
          <<<grid, gat_edge_threads(C), smem, st>>>(
              xl, xr, static_cast<const TE*>(ep), gate, src, dst, emask, att,
              cbias, alpha, conv, N, E, C, H * C));
  return (int)cudaGetLastError();
}
