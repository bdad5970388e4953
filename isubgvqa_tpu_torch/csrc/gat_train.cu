// Backward of the training GATv2 conv (the edge half of an MGAT layer).
//
// With the shared GEMM's backward forms (gemm.cu: d xf from d x_l / d x_r
// against lin_l / lin_r, the lin_l / lin_r / lin_edge weight gradients,
// d e_attr against lin_edge, the bias column sums) it replaces the
// backward Pallas kernel of isubgvqa_tpu/ops/pallas/gat_train.py
// (_bwd_kernel, called from _gatconv_pallas_bwd).  The forward is
// gat_kernel.cu's edge kernel in its training form (isg_gat_edge_train):
// f32 x_l / x_r, projected edges at the model dtype, f32 conv and alpha.
//
// isg_gat_edge_bwd: one block per graph, the reverse of the forward over
// the same incoming-edge lists (and outgoing lists by source), built in
// shared memory by a counting sort.  The TPU kernel recomputes x_l, x_r
// and the projected edges from the layer inputs; here the forward saved
// them (f32 x_l / x_r, bf16 or f32 projected edges: about 0.24 GB per
// layer at B = 256, E = 384 in bf16) and the per-edge messages
// m0 = x_l[src] + x_r[dst] + eproj are recomputed from those on the fly,
// so no [E, H*C] intermediate is stored.  Per graph:
//   1. warp per edge: d w_e,h = sum_c dconv[dst] * x_l[src] (the weighted
//      sum's backward), d alpha = d w * egate + the alpha cotangent, and
//      the two per-head sums S1 = sum att * lrelu'(m1) * m0 and
//      S2 = sum att * lrelu(m1) that the edge-gate gradient needs;
//   2. per destination and head: t = sum over incoming edges of
//      alpha * d alpha; then d logit = alpha * (d alpha - t) (softmax);
//   3. d egate = sum_h [d w * alpha + d logit * (S2 + egate * S1)];
//   4. warp per edge: d m0 = d logit * att * egate * lrelu'(m1) * egate,
//      which is the projected edges' gradient (written out);
//   5. per node and channel, walking the lists in edge order:
//      d x_r[n] = sum over incoming edges of d m0,
//      d x_l[n] = sum over outgoing edges of dconv[dst] * alpha * egate
//      + d m0; and d gate[n] = sum of d egate over incoming edges only —
//      the reference's quirk (node_edge_masks.py:13-19, gat_train.py:
//      29-33): no product-rule term reaches the source node;
//   6. per channel: the graph's share of d att = sum_e m3 * d logit.
// d cbias (a column sum of dconv) and the sum of the d att shares over
// graphs run as isg_colsum / isg_reduce_rows, in a fixed order.  Every
// sum walks edges in index order: deterministic, no atomics.  Bound:
// bytes — x_l[src], x_r[dst] and the projected edges are read about four
// times per edge, dconv twice.

#include "common.cuh"

namespace isg {

constexpr float kSlopeT = 0.2f;         // GATv2's leaky-ReLU

template <typename TE>
__global__ void gat_edge_bwd_kernel(
    const float* __restrict__ xl, const float* __restrict__ xr,
    const TE* __restrict__ ep, const float* __restrict__ gate,
    const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ emask, const float* __restrict__ att,
    const float* __restrict__ alpha, const float* __restrict__ dconv,
    const float* __restrict__ dalpha, float* __restrict__ dxl,
    float* __restrict__ dxr, float* __restrict__ dep,
    float* __restrict__ dgate, float* __restrict__ datt, int N, int E, int H,
    int C) {
  extern __shared__ float sm[];
  float* eg = sm;                       // [E]    edge gate
  float* al = eg + E;                   // [E, H] alpha
  float* dal = al + E * H;              // [E, H] d alpha, then d logit
  float* s1 = dal + E * H;              // [E, H]
  float* s2 = s1 + E * H;               // [E, H]
  float* dge = s2 + E * H;              // [E]    d egate
  float* tn = dge + E;                  // [N, H]
  int* sS = reinterpret_cast<int*>(tn + N * H);   // [E] src
  int* dS = sS + E;                     // [E] dst or -1
  int* lin = dS + E;                    // [E] edges grouped by dst
  int* lout = lin + E;                  // [E] edges grouped by src
  int* oin = lout + E;                  // [N + 1]
  int* oout = oin + N + 1;              // [N + 1]

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  const int HC = H * C;
  const long nb = (long)b * N, eb = (long)b * E;

  for (int e = tid; e < E; e += nt) {
    const int s = src[eb + e], d = dst[eb + e];
    const bool valid = emask[eb + e] > 0.f && s >= 0 && s < N && d >= 0 &&
                       d < N;
    sS[e] = valid ? s : 0;
    dS[e] = valid ? d : -1;
    eg[e] = valid ? gate[nb + s] * gate[nb + d] : 0.f;
  }
  for (int i = tid; i < E * H; i += nt) al[i] = alpha[eb * H + i];
  __syncthreads();
  if (tid == 0) {                       // counting sort by dst and by src
    for (int n = 0; n <= N; ++n) oin[n] = oout[n] = 0;
    for (int e = 0; e < E; ++e)
      if (dS[e] >= 0) {
        ++oin[dS[e] + 1];
        ++oout[sS[e] + 1];
      }
    for (int n = 0; n < N; ++n) {
      oin[n + 1] += oin[n];
      oout[n + 1] += oout[n];
    }
    for (int e = 0; e < E; ++e)         // the offsets advance as cursors
      if (dS[e] >= 0) {
        lin[oin[dS[e]]++] = e;
        lout[oout[sS[e]]++] = e;
      }
    for (int n = N; n > 0; --n) {       // restore the offsets
      oin[n] = oin[n - 1];
      oout[n] = oout[n - 1];
    }
    oin[0] = oout[0] = 0;
  }

  // 1. per edge: d w, d alpha, S1, S2
  for (int e = warp; e < E; e += nw) {
    const int d = dS[e];
    if (d < 0) {
      for (int hh = lane; hh < H; hh += 32) {
        dal[e * H + hh] = 0.f;
        s1[e * H + hh] = 0.f;
        s2[e * H + hh] = 0.f;
      }
      if (lane == 0) dge[e] = 0.f;
      continue;
    }
    const float g = eg[e];
    const float* xs = xl + (nb + sS[e]) * HC;
    const float* xd = xr + (nb + d) * HC;
    const float* dc = dconv + (nb + d) * HC;
    const TE* pe = ep + (eb + e) * HC;
    float dge_acc = 0.f;
    for (int hh = 0; hh < H; ++hh) {
      float dw = 0.f, a1 = 0.f, a2 = 0.f;
      for (int c = lane; c < C; c += 32) {
        const int j = hh * C + c;
        const float x = xs[j];
        dw = fmaf(dc[j], x, dw);
        const float m0 = (x + xd[j]) + to_f(pe[j]);
        const float m1 = m0 * g;
        const float lr = m1 >= 0.f ? 1.f : kSlopeT;
        a1 = fmaf(att[j] * lr, m0, a1);
        a2 = fmaf(att[j], m1 * lr, a2);
      }
      dw = warp_sum(dw);
      a1 = warp_sum(a1);
      a2 = warp_sum(a2);
      if (lane == 0) {
        const float da = dw * g + (dalpha ? dalpha[(eb + e) * H + hh] : 0.f);
        dal[e * H + hh] = da;
        s1[e * H + hh] = a1;
        s2[e * H + hh] = a2;
        dge_acc += dw * al[e * H + hh];
      }
    }
    if (lane == 0) dge[e] = dge_acc;
  }
  __syncthreads();

  // 2. softmax over each destination's incoming edges
  for (int i = tid; i < N * H; i += nt) {
    const int n = i / H, hh = i % H;
    float t = 0.f;
    for (int q = oin[n]; q < oin[n + 1]; ++q) {
      const int e = lin[q];
      t += al[e * H + hh] * dal[e * H + hh];
    }
    tn[i] = t;
  }
  __syncthreads();
  for (int i = tid; i < E * H; i += nt) {
    const int e = i / H, hh = i % H;
    const int d = dS[e];
    dal[i] = d >= 0 ? al[i] * (dal[i] - tn[d * H + hh]) : 0.f;
  }
  __syncthreads();

  // 3. edge-gate gradient
  for (int e = tid; e < E; e += nt) {
    if (dS[e] < 0) continue;
    float acc = dge[e];
    for (int hh = 0; hh < H; ++hh)
      acc += dal[e * H + hh] * (s2[e * H + hh] + eg[e] * s1[e * H + hh]);
    dge[e] = acc;
  }

  // 4. d m0 = the projected edges' gradient
  for (int e = warp; e < E; e += nw) {
    const int d = dS[e];
    float* out = dep + (eb + e) * HC;
    if (d < 0) {
      for (int j = lane; j < HC; j += 32) out[j] = 0.f;
      continue;
    }
    const float g = eg[e];
    const float* xs = xl + (nb + sS[e]) * HC;
    const float* xd = xr + (nb + d) * HC;
    const TE* pe = ep + (eb + e) * HC;
    for (int j = lane; j < HC; j += 32) {
      const float m1 = ((xs[j] + xd[j]) + to_f(pe[j])) * g;
      const float lr = m1 >= 0.f ? 1.f : kSlopeT;
      out[j] = dal[e * H + j / C] * att[j] * g * lr * g;
    }
  }
  __syncthreads();   // dep (global) and dge are read below by other threads

  // 5. node gradients over the edge lists
  for (long i = tid; i < (long)N * HC; i += nt) {
    const int n = (int)(i / HC), j = (int)(i % HC), hh = j / C;
    float ar = 0.f, alx = 0.f;
    for (int q = oin[n]; q < oin[n + 1]; ++q)
      ar += dep[(eb + lin[q]) * HC + j];
    for (int q = oout[n]; q < oout[n + 1]; ++q) {
      const int e = lout[q];
      alx += dconv[(nb + dS[e]) * HC + j] * al[e * H + hh] * eg[e] +
             dep[(eb + e) * HC + j];
    }
    dxr[(nb + n) * HC + j] = ar;
    dxl[(nb + n) * HC + j] = alx;
  }
  for (int n = tid; n < N; n += nt) {
    float acc = 0.f;
    for (int q = oin[n]; q < oin[n + 1]; ++q) acc += dge[lin[q]];
    dgate[nb + n] = acc;
  }

  // 6. this graph's share of d att
  for (int j = tid; j < HC; j += nt) {
    const int hh = j / C;
    float acc = 0.f;
    for (int e = 0; e < E; ++e) {
      const int d = dS[e];
      if (d < 0) continue;
      const float g = eg[e];
      const float m1 = ((xl[(nb + sS[e]) * HC + j] + xr[(nb + d) * HC + j]) +
                        to_f(ep[(eb + e) * HC + j])) * g;
      const float m3 = (m1 >= 0.f ? m1 : m1 * kSlopeT) * g;
      acc = fmaf(m3, dal[e * H + hh], acc);
    }
    datt[(long)b * HC + j] = acc;
  }
}

}  // namespace isg

using namespace isg;

// dxl, dxr [B*N, H*C], dep [B*E, H*C], dgate [B, N], datt [B, H*C]
// (per-graph shares), all f32; dalpha may be null.
ISG_API int isg_gat_edge_bwd(const float* xl, const float* xr, const void* ep,
                             int ep_dt, const float* gate, const int* src,
                             const int* dst, const float* emask,
                             const float* att, const float* alpha,
                             const float* dconv, const float* dalpha,
                             float* dxl, float* dxr, float* dep, float* dgate,
                             float* datt, int B, int N, int E, int H, int C,
                             void* stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * E + 4 * (size_t)E * H +
                                       (size_t)N * H) +
                      sizeof(int) * ((size_t)4 * E + 2 * ((size_t)N + 1));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ISG_WITH_T(ep_dt, TE,
      allow_smem(gat_edge_bwd_kernel<TE>, smem);
      gat_edge_bwd_kernel<TE><<<B, 512, smem, st>>>(
          xl, xr, static_cast<const TE*>(ep), gate, src, dst, emask, att,
          alpha, dconv, dalpha, dxl, dxr, dep, dgate, datt, N, E, H, C));
  return (int)cudaGetLastError();
}
