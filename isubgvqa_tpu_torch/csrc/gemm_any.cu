// Backward forms of the shared GEMM (gemm.cu): the dgrad and wgrad
// products of every training layer, isg_gemm_any.  They replace the
// jnp.dot products inside the backward Pallas kernels of
// isubgvqa_tpu/ops/pallas/{gat,metalayer,text}_train.py (_bwd_kernel,
// _make_enc_bwd, _make_dec_bwd).
//
// Bound on the H100: operations.  The products are f32 by design, and the
// 3xTF32 form below spends three TF32 products (two with a bf16 B) on
// each, so its ceiling is 495 / 3 = 165 TFLOP/s of f32 products (248 with
// a bf16 B), against 67 TFLOP/s for f32 on the FMA units.  mma.sync and
// the splits' integer work, not bytes, set its rate.
#include "common.cuh"
#include "tensor_core.cuh"

namespace isg {

// ------------------------------------------------------ backward forms
//
// C[m, n] (+)= sum_k A(m, k) B(k, n) in f32 for the backward passes:
//   dgrad  dX = dY @ W        A = dY [M, N'] row-major,  B = W [N', K]
//   wgrad  dW = dY^T @ X[idx] A = dY stored [rows, N'] read transposed
//                             (kATrans), B = X [rows, K], rows gathered
// B(k, n) = B[r(k) * ldb + n], r(k) = bidx[k] or k, a zero row where
// r < 0.  A is f32 (a gradient), B f32 or bf16 (a saved activation or a
// shipped weight; W may be a column slice of a wider weight).  The
// Pallas backward takes these products in f32 (``jnp.dot(dy,
// w.astype(f32))``), so the tensor cores' bf16 path does not apply; they
// run in the 3xTF32 form (two mma when B is bf16), which keeps f32-level
// accuracy at the TF32 tensor cores' rate instead of the FMA units'.
//
// Tile: 128 x 128 outputs per block of 8 warps, K tiles of
// 32 in a three-stage cp.async ring of 16-byte (f32) or 8-byte (bf16)
// chunks.  A tile that is k-major in memory (a transposed A, every B) is
// kept k-major with rows of 136 elements, A's row-major tile m-major with
// rows of 36: both make the fragment reads conflict-free.  Operands whose
// pitch or address does not allow the chunked copies (small odd shapes)
// take plain loads into the same ring.
//
// wgrad reduces over every edge or token row of the batch (up to ~10^5),
// so the k range is split across blockIdx.z.  Every slice writes its f32
// partial tile; the last block to finish a tile (a per-tile counter after
// a __threadfence) sums the slices in slice order into C and resets the
// counter.  The order of the sum does not depend on which block is last:
// deterministic, no float atomics, and no second pass over C.

constexpr int GBM = 128, GBN = 128, GBK = 32, GNT = 256, GSTAGES = 3;
constexpr int GLD = GBM + 8;    // k-major rows (GBM == GBN)
constexpr int GLDA = GBK + 4;   // m-major A rows

template <typename TB, bool kATrans>
constexpr size_t gemm_any_smem() {
  return GSTAGES * (sizeof(float) * (kATrans ? GBK * GLD : GBM * GLDA) +
                    sizeof(TB) * GBK * GLD);
}

template <typename TB, bool kATrans>
__global__ void __launch_bounds__(GNT, 2)
gemm_any_kernel(const float* __restrict__ A, int lda,
                const TB* __restrict__ B, const int* __restrict__ bidx,
                int ldb, float* __restrict__ C, int ldc, int M, int N, int K,
                int kchunk, int accumulate, float* __restrict__ work,
                int* __restrict__ counters, bool async) {
  constexpr int AST = kATrans ? GBK * GLD : GBM * GLDA;   // floats a stage
  constexpr int BST = GBK * GLD;                          // TB a stage
  constexpr bool kBLo = sizeof(TB) == 4;                  // bf16: lo == 0
  // Warp tiles: f32 B 64 x 32 (2 x 4 warps), so that each split B
  // fragment serves four m16 tiles; bf16 B, whose values are TF32 as they
  // stand (no split, no rounding), 16 x 128 (8 x 1 warps), so that each
  // split A fragment serves sixteen n8 tiles, and two k steps share one
  // fresh tile (half the f32 adds, which the products' issue rate feels).
  constexpr int WI = kBLo ? 4 : 1, WJ = 16 / WI;         // m16 / n8 tiles
  constexpr int WN = GBN / (8 * WJ);                      // warps across n
  extern __shared__ __align__(16) unsigned char gsm[];
  float* As = reinterpret_cast<float*>(gsm);
  TB* Bs = reinterpret_cast<TB*>(gsm + sizeof(float) * GSTAGES * AST);
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = (warp / WN) * WI * 16, col0 = (warp % WN) * WJ * 8;
  const int g = lane / 4, t4 = lane % 4;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const int ntiles = kend > kbeg ? (kend - kbeg + GBK - 1) / GBK : 0;
  // the warp's m16 / n8 tiles that hold outputs: a ragged edge (N = 300
  // leaves 44 of the last tile's 128 columns) skips the products of the
  // rest (a warp-uniform branch)
  const int live_i = min(WI, max(0, (M - m0 - row0 + 15) / 16));
  const int live_j = min(WJ, max(0, (N - n0 - col0 + 7) / 8));
  const int kr = tid / 32, kc = (tid % 32) * 4;   // k-major: 8 rows a pass
  const int mr = tid / 8, mc = (tid % 8) * 4;     // m-major: 32 rows a pass

  auto load = [&](int t, int stage) {
    const int k0 = kbeg + t * GBK;
    float* as = As + stage * AST;
    TB* bs = Bs + stage * BST;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kATrans) {
        const int r = kr + 8 * i, k = k0 + r, m = m0 + kc;
        const int cnt = (k < kend && m < M) ? min(4, M - m) : 0;
        copy4<float>(as + r * GLD + kc, cnt ? A + (long)k * lda + m : A, cnt,
                     async);
      } else {
        const int r = mr + 32 * i, m = m0 + r, k = k0 + mc;
        const int cnt = (m < M && k < kend) ? min(4, kend - k) : 0;
        copy4<float>(as + r * GLDA + mc, cnt ? A + (long)m * lda + k : A, cnt,
                     async);
      }
      const int r = kr + 8 * i, k = k0 + r, n = n0 + kc;
      const long row = k < kend ? (bidx ? (long)bidx[k] : (long)k) : -1;
      const int cnt = (row >= 0 && n < N) ? min(4, N - n) : 0;
      copy4<TB>(bs + r * GLD + kc, cnt ? B + row * ldb + n : B, cnt, async);
    }
  };
  // split fragments of m16 tile i and of the n8 tiles 4 jg .. 4 jg + 3
  auto frag_a = [&](const float* as, int i, int ks, uint32_t (&ah)[4],
                    uint32_t (&al)[4]) {
    const int r = row0 + i * 16 + g;
    float a[4];
    if (kATrans) {
      a[0] = as[(ks + t4) * GLD + r];
      a[1] = as[(ks + t4) * GLD + r + 8];
      a[2] = as[(ks + t4 + 4) * GLD + r];
      a[3] = as[(ks + t4 + 4) * GLD + r + 8];
    } else {
      a[0] = as[r * GLDA + ks + t4];
      a[1] = as[(r + 8) * GLDA + ks + t4];
      a[2] = as[r * GLDA + ks + t4 + 4];
      a[3] = as[(r + 8) * GLDA + ks + t4 + 4];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(a[q], ah[q], al[q]);
  };
  auto frag_b = [&](const TB* bs, int jg, int ks, uint32_t (&bh)[4][2],
                    uint32_t (&bl)[4][2]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = col0 + (jg * 4 + j) * 8 + g;
      if constexpr (kBLo) {
        split_tf32(bs[(ks + t4) * GLD + n], bh[j][0], bl[j][0]);
        split_tf32(bs[(ks + t4 + 4) * GLD + n], bh[j][1], bl[j][1]);
      } else {   // a bf16 value's f32 bits are TF32 already: no rounding
        bh[j][0] = __float_as_uint(to_f(bs[(ks + t4) * GLD + n]));
        bh[j][1] = __float_as_uint(to_f(bs[(ks + t4 + 4) * GLD + n]));
      }
    }
  };

  float acc[WI][WJ][4];
#pragma unroll
  for (int i = 0; i < WI; ++i)
#pragma unroll
    for (int j = 0; j < WJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int t = 0; t < GSTAGES - 1; ++t) {
    if (t < ntiles) load(t, t);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<GSTAGES - 2>();   // tile t has landed
    __syncthreads();                // ... for every thread; t - 1 is consumed
    const int tn = t + GSTAGES - 1;
    if (tn < ntiles) load(tn, tn % GSTAGES);
    cp_async_commit();
    const float* as = As + (t % GSTAGES) * AST;
    const TB* bs = Bs + (t % GSTAGES) * BST;
    if constexpr (WI == 1) {
      // two 8-deep k steps per fresh tile: half the f32 adds
      if (live_i > 0) {
#pragma unroll
        for (int ks = 0; ks < GBK; ks += 16) {
          uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
          frag_a(as, 0, ks, ah[0], al[0]);
          frag_a(as, 0, ks + 8, ah[1], al[1]);
#pragma unroll
          for (int jg = 0; jg < WJ / 4; ++jg)
            if (jg * 4 < live_j) {
              const int live = live_j - jg * 4;
              float fresh[4][4];
              frag_b(bs, jg, ks, bh, bl);
              mma_2xtf32_x4<true>(fresh, ah[0], al[0], bh, live);
              frag_b(bs, jg, ks + 8, bh, bl);
              mma_2xtf32_x4<false>(fresh, ah[1], al[1], bh, live);
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (j < live) {
#pragma unroll
                  for (int q = 0; q < 4; ++q)
                    acc[0][jg * 4 + j][q] += fresh[j][q];
                }
            }
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < GBK; ks += 8) {
        uint32_t ah[4], al[4], bh[4][2], bl[4][2];
        frag_b(bs, 0, ks, bh, bl);
#pragma unroll
        for (int i = 0; i < WI; ++i)
          if (i < live_i) {
            frag_a(as, i, ks, ah, al);
            mma_3xtf32_x4<true>(acc[i], ah, al, bh, bl, live_j);
          }
      }
    }
  }
  cp_async_wait<0>();

  // output q of this thread's tile (i, j): row m, column n
  auto out_m = [&](int i, int q) {
    return m0 + row0 + i * 16 + g + (q >> 1) * 8;
  };
  auto out_n = [&](int j, int q) {
    return n0 + col0 + j * 8 + t4 * 2 + (q & 1);
  };
  const int Z = gridDim.z;
  if (Z > 1) {                       // publish this slice's partial tile
#pragma unroll
    for (int i = 0; i < WI; ++i)
#pragma unroll
      for (int j = 0; j < WJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = out_m(i, q), n = out_n(j, q);
          if (m < M && n < N)
            work[((long)blockIdx.z * M + m) * N + n] = acc[i][j][q];
        }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int tile = blockIdx.y * gridDim.x + blockIdx.x;
      last = atomicAdd(&counters[tile], 1) == Z - 1;
      if (last) counters[tile] = 0;  // every slice has arrived: reset
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the tile's sum in slice order, each slice read back from work (this
    // block's own too), so that a thread's loads of one slice are
    // independent of each other
#pragma unroll
    for (int i = 0; i < WI; ++i)
#pragma unroll
      for (int j = 0; j < WJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = out_m(i, q), n = out_n(j, q);
          acc[i][j][q] =
              accumulate && m < M && n < N ? C[(long)m * ldc + n] : 0.f;
        }
    for (int zz = 0; zz < Z; ++zz)
#pragma unroll
      for (int i = 0; i < WI; ++i)
#pragma unroll
        for (int j = 0; j < WJ; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int m = out_m(i, q), n = out_n(j, q);
            if (m < M && n < N)
              acc[i][j][q] += __ldcg(&work[((long)zz * M + m) * N + n]);
          }
  } else if (accumulate) {
#pragma unroll
    for (int i = 0; i < WI; ++i)
#pragma unroll
      for (int j = 0; j < WJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = out_m(i, q), n = out_n(j, q);
          if (m < M && n < N) acc[i][j][q] += C[(long)m * ldc + n];
        }
  }
#pragma unroll
  for (int i = 0; i < WI; ++i)
#pragma unroll
    for (int j = 0; j < WJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = out_m(i, q), n = out_n(j, q);
        if (m < M && n < N) C[(long)m * ldc + n] = acc[i][j][q];
      }
}

template <typename TB, bool kATrans>
int launch_gemm_any(dim3 grid, cudaStream_t st, const float* a, int lda,
                    const void* b, const int* bidx, int ldb, float* c,
                    int ldc, int M, int N, int K, int kchunk, int accumulate,
                    float* work, int* counters, bool async) {
  constexpr size_t smem = gemm_any_smem<TB, kATrans>();
  allow_smem(gemm_any_kernel<TB, kATrans>, smem);
  gemm_any_kernel<TB, kATrans><<<grid, GNT, smem, st>>>(
      a, lda, static_cast<const TB*>(b), bidx, ldb, c, ldc, M, N, K, kchunk,
      accumulate, work, counters, async);
  return (int)cudaGetLastError();
}

}  // namespace isg

using namespace isg;

// C (+)= A(M x K) B(K x N) with the operand conventions of
// gemm_any_kernel; splits > 1 splits K into at most that many slices,
// whose partial tiles go to work [splits, M, N] and are summed in order
// by each tile's last block.  counters: one zeroed int per output tile
// (ceil(M / 128) * ceil(N / 128) of them), left zeroed.
ISG_API int isg_gemm_any(const float* a, int lda, int atr, const void* b,
                         const int* bidx, int ldb, int b_dt, float* c,
                         int ldc, int M, int N, int K, int accumulate,
                         float* work, int* counters, int splits,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || (splits > 1 && (!work || !counters)))
    return (int)cudaErrorInvalidValue;
  int kchunk = ((K + splits - 1) / splits + GBK - 1) / GBK * GBK;
  if (kchunk < GBK) kchunk = GBK;
  const int z = K > 0 ? (K + kchunk - 1) / kchunk : 1;
  if (M <= 0 || N <= 0) return 0;
  dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM, z);
  const uintptr_t esize = b_dt == 1 ? 2 : 4;
  const bool async = lda % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                     ldb % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(b) % (4 * esize) == 0;
  int err = 0;
  ISG_WITH_T(b_dt, TB,
      err = atr ? launch_gemm_any<TB, true>(grid, st, a, lda, b, bidx, ldb, c,
                                            ldc, M, N, K, kchunk, accumulate,
                                            work, counters, async)
                : launch_gemm_any<TB, false>(grid, st, a, lda, b, bidx, ldb,
                                             c, ldc, M, N, K, kchunk,
                                             accumulate, work, counters,
                                             async));
  return err;
}

