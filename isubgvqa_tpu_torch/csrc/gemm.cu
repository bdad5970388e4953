// Shared tiled GEMM for the port's f32 products.
//
// C[m, n] = act( sum_s  A_s'[m, :] . W[n, koff_s : koff_s + K_s]  + bias[n] )
//           * emul[m, n] * row_scale[m]
//
// * W is a torch Linear weight, row-major [N, ldw] ("out, in"); the A
//   segments are a virtual concatenation along K, so the MetaLayer's
//   MLP on [x_src, x_dst, e] runs against its [C, 3C] weight without
//   materialising the [E, 3C] concat (metalayer_kernel.py:63-77).
// * A segment row m may be gathered: row idx[m] of that segment's
//   tensor, or a zero row when idx[m] < 0.  That is x[src] / x[dst] of
//   the TPU kernels' one-hot incidence matmuls, with masked edges reading
//   zeros exactly as the masked one-hot rows do.
// * A and W are f32 (the wrapper widens a bf16 operand, which is exact).
//
// Bound on the H100: at the port's shapes (K = 300..2048) these are
// operation-bound products, so they go to the tensor cores in the 3xTF32
// form (tensor_core.cuh), which keeps f32-level accuracy on the TF32
// tensor cores (the training GAT conv's x_l / x_r, f32 models, the card's
// f32 references); with bf16 operands (exact in TF32) it takes two
// products, not three.  A 128x64x16 tile is fed by a three-stage cp.async
// ring (the loads of the next tiles overlap the products on this one).
// The bf16 products are gemm_gather_sm90.cu's (graph layers) and
// gemm_sm90.cu's (question stack).
//
#include "common.cuh"
#include "tensor_core.cuh"

namespace isg {

struct Seg {
  const float* a;
  const int* idx;
  int lda;
  int k;
};

struct Segs {
  Seg s[3];
  int n;
};

// Shared epilogue: v = act(acc + bias) * emul[m, n] * row_scale[m]; the
// pre-activation acc + bias goes to pre[m, n] when asked (the training
// forward keeps it for the activation's backward).  kExtra instantiates
// the emul / pre handling only where a caller passes them, so the eval
// layers' kernels compile as they did without it.
template <typename TC, bool kExtra>
__device__ __forceinline__ void epilogue(float acc, int m, int n, int N,
                                         const float* bias,
                                         const float* row_scale,
                                         const float* emul, float* pre,
                                         TC* C, int ldc, int act) {
  float v = acc + (bias ? bias[n] : 0.f);
  if (kExtra && pre) pre[(long)m * N + n] = v;
  if (act == 1) v = gelu_exact(v);
  else if (act == 2) v = fmaxf(v, 0.f);
  if (kExtra && emul) v *= emul[(long)m * N + n];
  if (row_scale) v *= row_scale[m];
  C[(long)m * ldc + n] = from_f<TC>(v);
}

// ---------------------------------------------------------------- f32
//
// A and W both f32, 3xTF32.  Each 16-wide K tile of A (128 rows,
// gathered) and W (64 rows) is copied by cp.async in 16-byte chunks (4
// floats: the wrapper asks for rows and K widths that are multiples of
// 4), three tiles in flight.  Rows are padded to 20 floats, so the
// fragment reads (8 rows x 4 columns a warp) hit 32 distinct banks.

constexpr int FBM = 128, FBN = 64, FBK = 16, FNT = 128, FSTAGES = 3;
constexpr int FLD = FBK + 4;

template <typename TC, bool kExtra>
__global__ void __launch_bounds__(FNT)
gemm_tf32_kernel(Segs segs, const float* __restrict__ W, int ldw,
                 const float* __restrict__ bias,
                 const float* __restrict__ row_scale,
                 const float* __restrict__ emul, float* __restrict__ pre,
                 TC* __restrict__ C, int ldc, int M, int N, int act,
                 bool a_exact) {
  __shared__ __align__(16) float As[FSTAGES][FBM][FLD];
  __shared__ __align__(16) float Ws[FSTAGES][FBN][FLD];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;       // warp tile 64 x 32
  const int g = lane / 4, t4 = lane % 4;        // mma fragment coordinates
  const int lc = (tid % (FBK / 4)) * 4;         // this thread's load column
  const int lr = tid / (FBK / 4);               // ... and first load row
  constexpr int ROW_STEP = FNT / (FBK / 4);     // 32
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;

  int ntiles = 0;
#pragma unroll
  for (int s = 0; s < 3; ++s)
    if (s < segs.n) ntiles += (segs.s[s].k + FBK - 1) / FBK;

  constexpr int AR = FBM / ROW_STEP, WR = FBN / ROW_STEP;
  int a_off[AR], w_off[WR];
#pragma unroll
  for (int i = 0; i < WR; ++i) {
    const int n = n0 + lr + i * ROW_STEP;
    w_off[i] = n < N ? n * ldw : -1;
  }
  Seg cur = segs.s[0];
  int seg = 0, tile = 0, koff = 0;
  auto enter = [&]() {
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      const int m = m0 + lr + i * ROW_STEP;
      const int row = m < M ? (cur.idx ? cur.idx[m] : m) : -1;
      a_off[i] = row >= 0 ? row * cur.lda : -1;
    }
  };
  enter();
  auto load_next = [&](int stage) {
    const float* A = cur.a;
    const int k = tile * FBK + lc;
    const bool kin = k < cur.k;
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      const bool ok = kin && a_off[i] >= 0;
      cp_async16(&As[stage][lr + i * ROW_STEP][lc], ok ? A + a_off[i] + k : A,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < WR; ++i) {
      const bool ok = kin && w_off[i] >= 0;
      cp_async16(&Ws[stage][lr + i * ROW_STEP][lc],
                 ok ? W + w_off[i] + koff + k : W, ok ? 16 : 0);
    }
    if (++tile * FBK >= cur.k && seg + 1 < segs.n) {
      koff += cur.k;
      tile = 0;
      cur = ++seg == 1 ? segs.s[1] : segs.s[2];
      enter();
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int t = 0; t < FSTAGES - 1; ++t) {
    if (t < ntiles) load_next(t);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<FSTAGES - 2>();   // tile t has landed
    __syncthreads();                // ... for every thread; t - 1 is consumed
    const int tn = t + FSTAGES - 1;
    if (tn < ntiles) load_next(tn % FSTAGES);
    cp_async_commit();
    const int st = t % FSTAGES;
#pragma unroll
    for (int ks = 0; ks < FBK; ks += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + g;
        split_tf32(Ws[st][n][ks + t4], bh[j][0], bl[j][0]);
        split_tf32(Ws[st][n][ks + t4 + 4], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm * 64 + i * 16 + g;
        uint32_t ah[4], al[4];
        split_tf32(As[st][row][ks + t4], ah[0], al[0]);
        split_tf32(As[st][row + 8][ks + t4], ah[1], al[1]);
        split_tf32(As[st][row][ks + t4 + 4], ah[2], al[2]);
        split_tf32(As[st][row + 8][ks + t4 + 4], ah[3], al[3]);
        if (a_exact)                  // A's lo parts are zero
          mma_3xtf32_x4<false>(acc[i], ah, al, bh, bl, 4);
        else
          mma_3xtf32_x4<true>(acc[i], ah, al, bh, bl, 4);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + i * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = n0 + wn * 32 + j * 8 + t4 * 2 + q;
          if (n >= N) continue;
          epilogue<TC, kExtra>(acc[i][j][half * 2 + q], m, n, N, bias,
                               row_scale, emul, pre, C, ldc, act);
        }
    }
}

// out[m, n] (+)= sum_z part[z, m, n], z in order.
__global__ void reduce_rows_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int ldo, int M,
                                   int N, int Z, int accumulate) {
  const long total = (long)M * N;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const long m = i / N, n = i % N;
    const long o = m * ldo + n;
    float s = accumulate ? out[o] : 0.f;
    for (int z = 0; z < Z; ++z) s += part[(long)z * total + i];
    out[o] = s;
  }
}

// part[z, n] = sum of X[m, n] over rows m of chunk z (a column sum's
// first pass; isg_reduce_rows finishes it).
__global__ void colsum_kernel(const float* __restrict__ X, int ldx, int M,
                              int N, int rows_per_chunk,
                              float* __restrict__ part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int m0 = blockIdx.y * rows_per_chunk;
  const int m1 = min(M, m0 + rows_per_chunk);
  float s = 0.f;
  for (int m = m0; m < m1; ++m) s += X[(long)m * ldx + n];
  part[(long)blockIdx.y * N + n] = s;
}

}  // namespace isg

using namespace isg;

// act: 0 none, 1 exact GELU, 2 ReLU; c_dt: 0 f32, 1 bf16.  emul [M, N]
// and pre [M, N] (f32) may be null.  a_exact: the f32 operands hold
// values exact in TF32 (bf16 activations), so the products drop their
// a_lo terms.  Every segment's row pitch and K width and the weight's
// pitch must be multiples of 4 elements, and the operands 16-byte aligned
// (chunked copies).
ISG_API int isg_gemm(const float* a0, const int* i0, int lda0, int k0,
                     const float* a1, const int* i1, int lda1, int k1,
                     const float* a2, const int* i2, int lda2, int k2,
                     int nseg, const float* w, int ldw, const float* bias,
                     const float* row_scale, const float* emul, float* pre,
                     void* c, int ldc, int M, int N, int act, int c_dt,
                     int a_exact, void* stream) {
  Segs segs;
  segs.s[0] = Seg{a0, i0, lda0, k0};
  segs.s[1] = Seg{a1, i1, lda1, k1};
  segs.s[2] = Seg{a2, i2, lda2, k2};
  segs.n = nseg;
  if (ldw % 4 || reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < nseg; ++s)
    if (segs.s[s].lda % 4 || segs.s[s].k % 4 ||
        reinterpret_cast<uintptr_t>(segs.s[s].a) % 16)
      return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + FBN - 1) / FBN, (M + FBM - 1) / FBM);
  if (emul || pre)
    ISG_WITH_T(c_dt, TC,
        gemm_tf32_kernel<TC, true><<<grid, FNT, 0, st>>>(
            segs, w, ldw, bias, row_scale, emul, pre, static_cast<TC*>(c),
            ldc, M, N, act, a_exact != 0));
  else
    ISG_WITH_T(c_dt, TC,
        gemm_tf32_kernel<TC, false><<<grid, FNT, 0, st>>>(
            segs, w, ldw, bias, row_scale, nullptr, nullptr,
            static_cast<TC*>(c), ldc, M, N, act, a_exact != 0));
  return (int)cudaGetLastError();
}

// out[m, n] (+)= sum_z part[z, m, n]
ISG_API int isg_reduce_rows(const float* part, float* out, int ldo, int M,
                            int N, int Z, int accumulate, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  reduce_rows_kernel<<<264, 256, 0, st>>>(part, out, ldo, M, N, Z,
                                          accumulate);
  return (int)cudaGetLastError();
}

// out[n] (+)= sum over the M rows of X[m, n]; work holds chunks * N floats.
ISG_API int isg_colsum(const float* x, int ldx, int M, int N, float* out,
                       int accumulate, float* work, int chunks,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per = (M + chunks - 1) / chunks;
  const int z = M > 0 ? (M + per - 1) / per : 1;
  dim3 grid((N + 127) / 128, z);
  colsum_kernel<<<grid, 128, 0, st>>>(x, ldx, M, N, per > 0 ? per : 1, work);
  int err = (int)cudaGetLastError();
  if (err) return err;
  reduce_rows_kernel<<<264, 256, 0, st>>>(work, out, N, 1, N, z, accumulate);
  return (int)cudaGetLastError();
}
