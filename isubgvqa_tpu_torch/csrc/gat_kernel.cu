// Masked GATv2 layer kernels: instruction gating and the edge half.
//
// With the shared GEMM (gemm.cu: x_l, x_r, lin_edge and the x_proj MLP)
// and the GraphNorm kernel (metalayer_kernel.cu: instruction SDP,
// GraphNorm, residual) they replace the Pallas kernel
// isubgvqa_tpu/ops/pallas/gat_kernel.py:fused_gat_layer (_kernel).
//
// isg_instr_gelu: xf = gelu(h * instr[graph]) computed in f32 and
// rounded to the model dtype (the fuse_instr branch, gat_kernel.py:98-105).
//
// isg_gat_edge: one block per graph (N <= 256 nodes, E <= 1024 edges).
//   1. edge gate gate[src] * gate[dst], 0 on padding edges;
//   2. one warp per edge: m = x_l[src] + x_r[dst] + eproj, multiplied by
//      the edge gate before and after leaky-ReLU, dotted with att per
//      head; padding edges get the logit -1e30;
//   3. per destination and head: max over incoming valid edges (floor
//      -1e30) and the sum of exponentials, each by one thread walking the
//      edges in order (edges are not sorted by destination);
//   4. alpha = exp / (sum if sum > 1e-12 else 1), written out;
//   5. incoming-edge lists per node (a counting sort in shared memory);
//   6. conv[n] = sum over incoming edges of round(x_l[src] * alpha *
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

// TX: x_l / x_r, TE: projected edges, TC: conv.  The eval layer runs
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
                                TC* __restrict__ conv, int N, int E, int H,
                                int C) {
  extern __shared__ float sm[];
  float* lg = sm;                       // [E, H] logits
  float* wg = lg + E * H;               // [E, H] alpha * egate
  float* eg = wg + E * H;               // [E]    edge gate
  float* mx = eg + E;                   // [N, H]
  float* den = mx + N * H;              // [N, H]
  int* dS = reinterpret_cast<int*>(den + N * H);   // [E] dst or -1
  int* sS = dS + E;                     // [E] src
  int* lst = sS + E;                    // [E] edges grouped by dst
  int* cnt = lst + E;                   // [N]
  int* off = cnt + N;                   // [N + 1]

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  const int HC = H * C;
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

  for (int e = warp; e < E; e += nw) {
    const int d = dS[e];
    if (d < 0) {
      for (int hh = lane; hh < H; hh += 32) lg[e * H + hh] = kNeg;
      continue;
    }
    const float g = eg[e];
    const TX* xs = xl + (nb + sS[e]) * HC;
    const TX* xd = xr + (nb + d) * HC;
    const TE* pe = ep + (eb + e) * HC;
    for (int hh = 0; hh < H; ++hh) {
      float acc = 0.f;
      for (int c = lane; c < C; c += 32) {
        const int j = hh * C + c;
        float m = (to_f(xs[j]) + to_f(xd[j])) + to_f(pe[j]);
        m *= g;
        m = m >= 0.f ? m : m * kSlope;
        m *= g;
        acc = fmaf(m, att[j], acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) lg[e * H + hh] = acc;
    }
  }
  __syncthreads();

  for (int i = tid; i < N * H; i += nt) {
    const int n = i / H, hh = i % H;
    float m = kNeg;
    int c = 0;
    for (int e = 0; e < E; ++e)
      if (dS[e] == n) {
        m = fmaxf(m, lg[e * H + hh]);
        ++c;
      }
    float s = 0.f;
    for (int e = 0; e < E; ++e)
      if (dS[e] == n) s += expf(lg[e * H + hh] - m);
    mx[i] = m;
    den[i] = s;
    if (hh == 0) cnt[n] = c;
  }
  __syncthreads();

  for (int i = tid; i < E * H; i += nt) {
    const int e = i / H, hh = i % H;
    const int d = dS[e];
    float a = 0.f;
    if (d >= 0) {
      const float s = den[d * H + hh];
      a = expf(lg[i] - mx[d * H + hh]) / (s > 1e-12f ? s : 1.f);
    }
    alpha[eb * H + i] = a;
    wg[i] = a * eg[e];
  }
  if (tid == 0) {
    off[0] = 0;
    for (int n = 0; n < N; ++n) off[n + 1] = off[n] + cnt[n];
  }
  __syncthreads();
  for (int n = tid; n < N; n += nt) {
    int q = off[n];
    for (int e = 0; e < E; ++e)
      if (dS[e] == n) lst[q++] = e;
  }
  __syncthreads();

  for (int i = tid; i < N * HC; i += nt) {
    const int n = i / HC, j = i % HC, hh = j / C;
    float acc = 0.f;
    for (int q = off[n]; q < off[n + 1]; ++q) {
      const int e = lst[q];
      const float w = to_f(xl[(nb + sS[e]) * HC + j]) * wg[e * H + hh];
      acc += kRound ? round_to<TC>(w) : w;
    }
    conv[(nb + n) * HC + j] = from_f<TC>(acc + cbias[j]);
  }
}

}  // namespace isg

using namespace isg;

static size_t gat_edge_smem(int N, int E, int H) {
  return sizeof(float) * ((size_t)2 * E * H + E + 2 * N * H) +
         sizeof(int) * ((size_t)3 * E + 2 * N + 1);
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

ISG_API int isg_gat_edge(const void* xl, const void* xr, const void* ep,
                         int dt, const float* gate, const int* src,
                         const int* dst, const float* emask, const float* att,
                         const float* cbias, float* alpha, void* conv, int B,
                         int N, int E, int H, int C, void* stream) {
  const size_t smem = gat_edge_smem(N, E, H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ISG_WITH_T(dt, T,
      allow_smem(gat_edge_kernel<T, T, T, true>, smem);
      gat_edge_kernel<T, T, T, true><<<B, 512, smem, st>>>(
          static_cast<const T*>(xl), static_cast<const T*>(xr),
          static_cast<const T*>(ep), gate, src, dst, emask, att, cbias, alpha,
          static_cast<T*>(conv), N, E, H, C));
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
  const size_t smem = gat_edge_smem(N, E, H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ISG_WITH_T(ep_dt, TE,
      allow_smem(gat_edge_kernel<float, TE, float, false>, smem);
      gat_edge_kernel<float, TE, float, false><<<B, 512, smem, st>>>(
          xl, xr, static_cast<const TE*>(ep), gate, src, dst, emask, att,
          cbias, alpha, conv, N, E, H, C));
  return (int)cudaGetLastError();
}
