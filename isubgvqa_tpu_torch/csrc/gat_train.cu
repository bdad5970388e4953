// Backward of the training GATv2 conv (the edge half of an MGAT layer).
//
// With the shared GEMM's backward forms (gemm_any.cu: d xf from d x_l /
// d x_r against lin_l / lin_r, the lin_l / lin_r / lin_edge weight
// gradients, d e_attr against lin_edge; gemm.cu: the bias column sums) it
// replaces the backward Pallas kernel of
// isubgvqa_tpu/ops/pallas/gat_train.py (_bwd_kernel, called from
// _gatconv_pallas_bwd).  The forward is gat_kernel.cu's edge kernel in its
// training form (isg_gat_edge_train): f32 x_l / x_r, projected edges at
// the model dtype, f32 conv and alpha.  The TPU kernel recomputes x_l, x_r
// and the projected edges from the layer inputs; here the forward saved
// them (f32 x_l / x_r, bf16 or f32 projected edges) and the per-edge
// messages m0 = x_l[src] + x_r[dst] + eproj are recomputed from those.
//
// Bound on the H100: bytes.  Each of x_l, x_r, the projected edges and
// dconv read once, d x_l, d x_r and the projected edges' f32 gradient
// written once: about 1.5 GB at B = 256, N = 128, E = 384, H*C = 1200
// (0.45 ms at 3.35 TB/s), against a few FLOPs per byte.  A pass over all
// of a graph's edges before the next reads x_l[src], x_r[dst] and eproj
// again long after the first read, and with hundreds of blocks in flight
// the 50 MB L2 no longer holds them.
//
// isg_gat_edge_bwd: one block per (graph, head), B * H blocks (1,024 at
// B = 256), since the logits, the softmax and d alpha are per head; a
// thread per channel of the head (C <= 320), at most 64 registers each
// so that three blocks share an SM: the kernel waits on memory latency,
// and more warps in flight hide more of it.  The block builds the graph's
// incoming-edge lists (by dst) and outgoing lists (by src) in shared
// memory (common.cuh:group_edges, a stable counting sort).  Then it walks the
// destination nodes in chunks of 8, so that a chunk's rows are read again
// while they are still in L1 or L2:
//   1. a warp per incoming edge of the chunk, over the head's channels:
//      d w = sum_c dconv[dst] x_l[src] (the weighted sum's backward),
//      d alpha = d w egate + the alpha cotangent, and S1 = sum att
//      lrelu'(m1) m0, S2 = sum att lrelu(m1) for the edge-gate gradient;
//   2. a thread per destination: t = sum over its incoming edges of alpha
//      d alpha, d logit = alpha (d alpha - t) (softmax), and its share of
//      d gate for this head, sum of d w alpha + d logit (S2 + egate S1)
//      over its incoming edges: destination nodes only — the reference's
//      quirk (node_edge_masks.py:13-19, gat_train.py:29-33): no
//      product-rule term reaches the source node.  The shares go out as
//      [H, B, N] and are summed in head order by isg_reduce_rows;
//   3. a thread per channel over the chunk's edges, four edges' loads in
//      flight at a time (the second read of x_l[src], x_r[dst], eproj):
//      d m0 = d logit att egate lrelu'(m1) egate, which is the projected
//      edges' gradient (written once), d x_r[n] = its sum over n's
//      incoming edges, d att += m3 d logit, and the sign of m1 kept as a
//      bit mask (one ballot per warp and edge) in shared memory.
// Last, a thread per channel over the outgoing lists: d x_l[n] = sum of
// dconv[dst] alpha egate + d m0, with d m0 rebuilt from d logit and the
// sign bits (dconv's second read; d m0 is not read back).  d cbias (a
// column sum of dconv) and the sum of the per-graph d att shares run as
// isg_colsum / isg_reduce_rows.  Every sum walks its edges in a fixed
// order: deterministic, no atomics.

#include "common.cuh"

namespace isg {

constexpr float kSlopeT = 0.2f;         // GATv2's leaky-ReLU
constexpr int kChunk = 8;               // destination nodes a chunk
constexpr int kMaxThreads = 320;        // a thread per channel: C <= 320

template <typename TE>
__global__ void __launch_bounds__(kMaxThreads, 3) gat_edge_bwd_kernel(
    const float* __restrict__ xl, const float* __restrict__ xr,
    const TE* __restrict__ ep, const float* __restrict__ gate,
    const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ emask, const float* __restrict__ att,
    const float* __restrict__ alpha, const float* __restrict__ dconv,
    const float* __restrict__ dalpha, float* __restrict__ dxl,
    float* __restrict__ dxr, float* __restrict__ dep,
    float* __restrict__ dgate, float* __restrict__ datt, int ldx, int N,
    int E, int C) {
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x, B = gridDim.y;
  const int tid = threadIdx.x, nt = blockDim.x;   // nt >= C
  const int warp = tid / 32, lane = tid % 32, nw = nt / 32;
  const int HC = H * C, h0 = h * C, per = (C + 31) / 32;
  const long nb = (long)b * N, eb = (long)b * E;

  extern __shared__ float sm[];
  float* eg = sm;                       // [E] edge gate
  float* al = eg + E;                   // [E] this head's alpha
  float* da = al + E;                   // [E] d alpha, then d logit
  float* s1 = da + E;                   // [E]
  float* s2 = s1 + E;                   // [E]
  float* dwa = s2 + E;                  // [E] d w * alpha
  uint32_t* sgn = reinterpret_cast<uint32_t*>(dwa + E);   // [E, per]
  int* sS = reinterpret_cast<int*>(sgn + E * per);  // [E] src
  int* dS = sS + E;                     // [E] dst or -1
  int* lin = dS + E;                    // [E] valid edges by dst, then padding
  int* lout = lin + E;                  // [E] valid edges by src
  int* oin = lout + E;                  // [N + 2]
  int* oout = oin + N + 2;              // [N + 1]
  int* scr = oout + N + 1;              // [N + 1] scratch of the sort

  for (int e = tid; e < E; e += nt) {
    const int s = src[eb + e], d = dst[eb + e];
    const bool valid = emask[eb + e] > 0.f && s >= 0 && s < N && d >= 0 &&
                       d < N;
    sS[e] = valid ? s : 0;
    dS[e] = valid ? d : -1;
    eg[e] = valid ? gate[nb + s] * gate[nb + d] : 0.f;
    al[e] = alpha[(eb + e) * H + h];
  }
  __syncthreads();
  // Edge lists in edge order: incoming by destination (group N: the
  // padding edges), outgoing by source (valid edges only)
  group_edges(E, N + 1, [&](int e) { return dS[e] >= 0 ? dS[e] : N; }, oin,
              scr, lin);
  group_edges(E, N, [&](int e) { return dS[e] >= 0 ? sS[e] : -1; }, oout,
              scr, lout);

  const int c = tid;                    // this thread's channel in 3. and 4.
  const bool okc = c < C;
  const int j = h0 + (okc ? c : 0);
  const float atj = att[j];
  const float* at = att + h0;
  float dat = 0.f;
  for (int n0 = 0; n0 < N; n0 += kChunk) {
    const int n1 = min(N, n0 + kChunk), qa = oin[n0], qb = oin[n1];
    // 1. a warp per edge: d w, d alpha, S1, S2
    for (int q = qa + warp; q < qb; q += nw) {
      const int e = lin[q], d = dS[e];
      const float g = eg[e];
      const float* xs = xl + (nb + sS[e]) * HC + h0;
      const float* xd = xr + (nb + d) * HC + h0;
      const float* dc = dconv + (nb + d) * HC + h0;
      const TE* pe = ep + (eb + e) * HC + h0;
      float w = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll 4
      for (int k = lane; k < C; k += 32) {   // loads of 4 steps in flight
        const float x = xs[k];
        w = fmaf(dc[k], x, w);
        const float m0 = (x + xd[k]) + to_f(pe[k]);
        const float m1 = m0 * g;
        const float lr = m1 >= 0.f ? 1.f : kSlopeT;
        a1 = fmaf(at[k] * lr, m0, a1);
        a2 = fmaf(at[k], m1 * lr, a2);
      }
      w = warp_sum(w);
      a1 = warp_sum(a1);
      a2 = warp_sum(a2);
      if (lane == 0) {
        da[e] = w * g + (dalpha ? dalpha[(eb + e) * H + h] : 0.f);
        s1[e] = a1;
        s2[e] = a2;
        dwa[e] = w * al[e];
      }
    }
    __syncthreads();
    // 2. softmax backward and the d gate share, a thread per destination
    for (int n = n0 + tid; n < n1; n += nt) {
      float t = 0.f;
      for (int q = oin[n]; q < oin[n + 1]; ++q) {
        const int e = lin[q];
        t += al[e] * da[e];
      }
      float acc = 0.f;
      for (int q = oin[n]; q < oin[n + 1]; ++q) {
        const int e = lin[q];
        const float dl = al[e] * (da[e] - t);
        acc += dwa[e] + dl * (s2[e] + eg[e] * s1[e]);
        da[e] = dl;
      }
      dgate[((long)h * B + b) * N + n] = acc;
    }
    __syncthreads();
    // 3. d m0, d x_r, d att and the signs of m1, a thread per channel
    float acc = 0.f;
    int cur = -1;
    for (int q0 = qa; q0 < qb; q0 += 4) {
      float m0[4];
      int ev[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = lin[min(q0 + u, qb - 1)];
        ev[u] = e;
        m0[u] = okc ? (xl[(nb + sS[e]) * HC + j] + xr[(nb + dS[e]) * HC + j]) +
                          to_f(ep[(eb + e) * HC + j])
                    : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (q0 + u < qb) {
          const int e = ev[u], d = dS[e];
          if (d != cur) {
            if (cur >= 0 && okc) dxr[(nb + cur) * ldx + j] = acc;
            acc = 0.f;
            cur = d;
          }
          const float g = eg[e];
          const float m1 = m0[u] * g;
          const bool pos = m1 >= 0.f;
          const float v = da[e] * atj * g * (pos ? 1.f : kSlopeT) * g;
          if (okc) dep[(eb + e) * HC + j] = v;
          acc += v;
          dat = fmaf((pos ? m1 : m1 * kSlopeT) * g, da[e], dat);
          const uint32_t word = __ballot_sync(0xffffffffu, pos);
          if (lane == 0 && warp < per) sgn[e * per + warp] = word;
        }
      }
    }
    if (okc) {
      if (cur >= 0) dxr[(nb + cur) * ldx + j] = acc;
      for (int n = n0; n < n1; ++n)          // no incoming edge
        if (oin[n] == oin[n + 1]) dxr[(nb + n) * ldx + j] = 0.f;
    }
  }
  __syncthreads();                      // d logit and the sign bits
  if (!okc) return;
  datt[(long)b * HC + j] = dat;
  for (int q = oin[N]; q < E; ++q) dep[(eb + lin[q]) * HC + j] = 0.f;

  // 4. d x_l over the edges grouped by source, four edges' loads in flight
  const int nout = oout[N];
  float acc = 0.f;
  int cur = nout ? sS[lout[0]] : 0;
  for (int q0 = 0; q0 < nout; q0 += 4) {
    float dcv[4];
    int ev[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = lout[min(q0 + u, nout - 1)];
      ev[u] = e;
      dcv[u] = dconv[(nb + dS[e]) * HC + j];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (q0 + u < nout) {
        const int e = ev[u], s = sS[e];
        if (s != cur) {
          dxl[(nb + cur) * ldx + j] = acc;
          acc = 0.f;
          cur = s;
        }
        const float g = eg[e];
        const bool pos = (sgn[e * per + c / 32] >> (c % 32)) & 1u;
        const float v = da[e] * atj * g * (pos ? 1.f : kSlopeT) * g;
        acc += dcv[u] * al[e] * g + v;
      }
    }
  }
  if (nout) dxl[(nb + cur) * ldx + j] = acc;
  for (int n = 0; n < N; ++n)                // no outgoing edge
    if (oout[n] == oout[n + 1]) dxl[(nb + n) * ldx + j] = 0.f;
}

}  // namespace isg

using namespace isg;

// dxl, dxr [B*N, H*C] with row pitch ldx (the two may be column slices of
// one [B*N, 2*H*C] buffer), dep [B*E, H*C], dgate [H, B, N] (per-head shares),
// datt [B, H*C] (per-graph shares), all f32; dalpha may be null.  C <= 320.
ISG_API int isg_gat_edge_bwd(const float* xl, const float* xr, const void* ep,
                             int ep_dt, const float* gate, const int* src,
                             const int* dst, const float* emask,
                             const float* att, const float* alpha,
                             const float* dconv, const float* dalpha,
                             float* dxl, float* dxr, float* dep, float* dgate,
                             float* datt, int ldx, int B, int N, int E, int H,
                             int C, void* stream) {
  if (C > kMaxThreads) return (int)cudaErrorInvalidValue;
  int threads = (C + 31) / 32 * 32;      // a thread per channel
  threads = threads < 128 ? 128 : threads;
  const size_t per = (C + 31) / 32;
  const size_t smem = sizeof(float) * 6 * (size_t)E +
                      sizeof(uint32_t) * E * per +
                      sizeof(int) * (4 * (size_t)E + 3 * (size_t)N + 4);
  dim3 grid(H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ISG_WITH_T(ep_dt, TE,
      allow_smem(gat_edge_bwd_kernel<TE>, smem);
      gat_edge_bwd_kernel<TE><<<grid, threads, smem, st>>>(
          xl, xr, static_cast<const TE*>(ep), gate, src, dst, emask, att,
          alpha, dconv, dalpha, dxl, dxr, dep, dgate, datt, ldx, N, E, C));
  return (int)cudaGetLastError();
}
