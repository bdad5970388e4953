// Shared tiled GEMM for the port's fused layers.
//
// C[m, n] = act( sum_s  A_s'[m, :] . W[n, koff_s : koff_s + K_s]  + bias[n] )
//           * row_scale[m]
//
// * W is a torch Linear weight, row-major [N, ldw] ("out, in"); the A
//   segments are a virtual concatenation along K, so the MetaLayer's
//   MLP on [x_src, x_dst, e] runs against its [C, 3C] weight without
//   materialising the [E, 3C] concat (metalayer_kernel.py:63-77).
// * A segment row m may be gathered: row idx[m] of that segment's
//   tensor, or a zero row when idx[m] < 0.  That is x[src] / x[dst] of
//   the TPU kernels' one-hot incidence matmuls, with masked edges reading
//   zeros exactly as the masked one-hot rows do.
// * A comes at W's dtype (the wrapper rounds it, as flax
//   Dense(dtype=bf16) rounds its operands); products and sums are f32.
//
// Bound on the H100: at the port's shapes (K = 300..2048) these are
// operation-bound products, so a bf16 weight goes to the tensor cores:
// a 128x64x32 shared-memory tile fed by a three-stage cp.async ring,
// four warps of 64x32 each issuing mma.sync m16n8k16 (bf16 in, f32
// accumulate).  The bf16 products are
// exact in f32, so the result differs from the plain version only by
// summation order.  An f32 weight (f32 models, the card's f32
// references) takes a 64x64x16 tile of f32 FMA instead, which keeps
// them in full f32; its loads are plain per-element reads.  wgmma tiles
// fed by TMA are later work.

#include "common.cuh"

namespace isg {

struct Seg {
  const void* a;
  const int* idx;
  int lda;
  int k;
};

struct Segs {
  Seg s[3];
  int n;
};

constexpr int BM = 64, BN = 64, BK = 16, NT = 256;

// f32 operands and weight.
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

template <typename TC, bool kExtra>
__global__ void __launch_bounds__(NT)
gemm_kernel(Segs segs, const float* __restrict__ W, int ldw,
            const float* __restrict__ bias, const float* __restrict__ row_scale,
            const float* __restrict__ emul, float* __restrict__ pre,
            TC* __restrict__ C, int ldc, int M, int N, int act) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Ws[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  int koff = 0;
  for (int si = 0; si < segs.n; ++si) {
    const float* A = static_cast<const float*>(segs.s[si].a);
    const int* idx = segs.s[si].idx;
    const int lda = segs.s[si].lda, K = segs.s[si].k;
    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
      for (int i = 0; i < (BM * BK) / NT; ++i) {
        const int e = tid + i * NT;
        const int r = e / BK, kk = e % BK;
        const int m = m0 + r, k = k0 + kk;
        float v = 0.f;
        if (m < M && k < K) {
          const long row = idx ? (long)idx[m] : (long)m;
          if (row >= 0) v = A[row * lda + k];
        }
        As[kk][r] = v;
      }
#pragma unroll
      for (int i = 0; i < (BN * BK) / NT; ++i) {
        const int e = tid + i * NT;
        const int r = e / BK, kk = e % BK;
        const int n = n0 + r, k = k0 + kk;
        Ws[kk][r] = (n < N && k < K) ? W[(long)n * ldw + koff + k] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }
    koff += K;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      epilogue<TC, kExtra>(acc[i][j], m, n, N, bias, row_scale, emul, pre, C,
                           ldc, act);
    }
  }
}

// ---------------------------------------------------------------- bf16
//
// A and W both bf16.  Each 32-wide K tile of A (128 rows, gathered) and
// W (64 rows) is copied into shared memory by cp.async in 8-byte chunks
// (4 bf16: rows need only 8-byte alignment, which a 300-wide row has),
// three tiles in flight, so the loads of the next tiles overlap the
// tensor-core work on this one.  A chunk past K, past the last row or of
// a gathered row with a negative index is zero-filled by the copy.

constexpr int TBM = 128, TBN = 64, TBK = 32, TNT = 128, STAGES = 3;
constexpr int TLD = TBK + 8;   // row pitch in bf16: conflict-free fragment reads
constexpr int CHUNK = 4;       // bf16 per 8-byte copy

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename TC, bool kExtra>
__global__ void __launch_bounds__(TNT)
gemm_bf16_kernel(Segs segs, const __nv_bfloat16* __restrict__ W, int ldw,
                 const float* __restrict__ bias,
                 const float* __restrict__ row_scale,
                 const float* __restrict__ emul, float* __restrict__ pre,
                 TC* __restrict__ C, int ldc, int M, int N, int act) {
  __shared__ __align__(16) __nv_bfloat16 As[STAGES][TBM][TLD];
  __shared__ __align__(16) __nv_bfloat16 Ws[STAGES][TBN][TLD];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;       // warp tile 64 x 32
  const int g = lane / 4, t4 = lane % 4;        // mma fragment coordinates
  const int lc = (tid % (TBK / CHUNK)) * CHUNK; // this thread's load column
  const int lr = tid / (TBK / CHUNK);           // ... and first load row
  constexpr int ROW_STEP = TNT / (TBK / CHUNK); // 16
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;

  int ntiles = 0;
#pragma unroll
  for (int s = 0; s < 3; ++s)
    if (s < segs.n) ntiles += (segs.s[s].k + TBK - 1) / TBK;

  // The copy stream walks the tiles of segment 0, then 1, then 2.  The
  // element offsets of this thread's rows are worked out once per
  // segment (-1: a zero row), so a copy costs one add; the wrapper keeps
  // every operand under 2^31 elements.
  constexpr int AR = TBM / ROW_STEP, WR = TBN / ROW_STEP;
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
    const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(cur.a);
    const int k = tile * TBK + lc;
    const bool kin = k < cur.k;
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      const bool ok = kin && a_off[i] >= 0;
      cp_async8(&As[stage][lr + i * ROW_STEP][lc], ok ? A + a_off[i] + k : A,
                ok);
    }
#pragma unroll
    for (int i = 0; i < WR; ++i) {
      const bool ok = kin && w_off[i] >= 0;
      cp_async8(&Ws[stage][lr + i * ROW_STEP][lc],
                ok ? W + w_off[i] + koff + k : W, ok);
    }
    if (++tile * TBK >= cur.k && seg + 1 < segs.n) {
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
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_next(t);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();   // tile t has landed
    __syncthreads();               // ... for every thread; t - 1 is consumed
    const int tn = t + STAGES - 1;
    if (tn < ntiles) load_next(tn % STAGES);
    cp_async_commit();
    const int st = t % STAGES;
#pragma unroll
    for (int ks = 0; ks < TBK; ks += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm * 64 + i * 16 + g;
        a[i][0] = ld_pair(&As[st][row][ks + t4 * 2]);
        a[i][1] = ld_pair(&As[st][row + 8][ks + t4 * 2]);
        a[i][2] = ld_pair(&As[st][row][ks + t4 * 2 + 8]);
        a[i][3] = ld_pair(&As[st][row + 8][ks + t4 * 2 + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + j * 8 + g;
        b[j][0] = ld_pair(&Ws[st][n][ks + t4 * 2]);
        b[j][1] = ld_pair(&Ws[st][n][ks + t4 * 2 + 8]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
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

// ------------------------------------------------------ backward forms
//
// C[m, n] (+)= sum_k A(m, k) B(k, n) in f32 for the backward passes:
//   dgrad  dX = dY @ W        A = dY [M, N'] row-major,  B = W [N', K]
//   wgrad  dW = dY^T @ X[idx] A = dY stored [rows, N'] read transposed
//                             (kATrans), B = X [rows, K], rows gathered
// B(k, n) = B[r(k) * ldb + n], r(k) = bidx[k] or k, a zero row where
// r < 0.  A is f32 (a gradient), B f32 or bf16 (a saved activation or a
// shipped weight; W may be a column slice of a wider weight).  The
// products are f32 on f32 operands, as the Pallas backward takes them
// (``jnp.dot(dy, w.astype(f32))``), so the tensor cores' bf16 path does
// not apply; the tile is the f32 FMA form: 128 x 128 outputs per block of
// 256 threads, each thread an 8 x 8 register tile fed by float4 reads of
// the k-major shared tiles (16 FMAs per shared load), and the next 8-wide
// k slice loaded into registers while this one is multiplied.  wgrad
// reduces over every edge or token row of the batch (up to ~10^5), so the
// k range is split across blockIdx.z: each slice writes an f32 partial
// tile and isg_reduce_rows sums the slices in a fixed order — a
// deterministic second pass instead of the TPU's sequential-grid
// accumulation or atomics.  Operation-bound at the backward's shapes.

constexpr int GBM = 128, GBN = 128, GBK = 8, GNT = 256;

template <typename TB, bool kATrans>
__global__ void __launch_bounds__(GNT)
gemm_any_kernel(const float* __restrict__ A, int lda,
                const TB* __restrict__ B, const int* __restrict__ bidx,
                int ldb, float* __restrict__ C, int ldc, int M, int N, int K,
                int kchunk, int accumulate, float* __restrict__ work) {
  __shared__ __align__(16) float As[2][GBK][GBM];
  __shared__ __align__(16) float Bs[2][GBK][GBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);

  // This thread's share of a k slice: four A and four B elements.
  // kATrans and B: row kk = tid / 32, columns 4 * (tid % 32) + 0..3 (a
  // warp reads 128 consecutive elements); plain A: row m = tid / 2,
  // k = 4 * (tid % 2) + 0..3.
  const int lr = tid / 32, lc = (tid % 32) * 4;
  const int am = tid / 2, ak = (tid % 2) * 4;
  float ra[4], rb[4];
  auto load = [&](int k0) {
    if (kATrans) {
      const int k = k0 + lr;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + lc + i;
        ra[i] = (k < kend && m < M) ? A[(long)k * lda + m] : 0.f;
      }
    } else {
      const int m = m0 + am;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + ak + i;
        ra[i] = (k < kend && m < M) ? A[(long)m * lda + k] : 0.f;
      }
    }
    const int k = k0 + lr;
    const long row = k < kend ? (bidx ? (long)bidx[k] : (long)k) : -1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + lc + i;
      rb[i] = (row >= 0 && n < N) ? to_f(B[row * ldb + n]) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (kATrans) As[buf][lr][lc + i] = ra[i];
      else As[buf][ak + i][am] = ra[i];
      Bs[buf][lr][lc + i] = rb[i];
    }
  };

  // thread (ty, tx) owns rows ty*4 + {0..3, 64..67} and columns
  // tx*4 + {0..3, 64..67}
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int buf = 0;
  if (kbeg < kend) {
    load(kbeg);
    store(0);
  }
  __syncthreads();
  for (int k0 = kbeg; k0 < kend; k0 += GBK) {
    const bool more = k0 + GBK < kend;
    if (more) load(k0 + GBK);          // in flight during the products
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) {
      store(buf ^ 1);                  // the other buffer: no reader left
      __syncthreads();
      buf ^= 1;
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n >= N) continue;
      if (work) {
        work[((long)blockIdx.z * M + m) * N + n] = acc[i][j];
      } else {
        const long o = (long)m * ldc + n;
        C[o] = (accumulate ? C[o] : 0.f) + acc[i][j];
      }
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

// act: 0 none, 1 exact GELU, 2 ReLU.  Dtype codes: 0 f32, 1 bf16.
// emul [M, N] and pre [M, N] (f32) may be null.
ISG_API int isg_gemm(const void* a0, const int* i0, int lda0, int k0,
                     const void* a1, const int* i1, int lda1, int k1,
                     const void* a2, const int* i2, int lda2, int k2,
                     int nseg, const void* w, int ldw, const float* bias,
                     const float* row_scale, const float* emul, float* pre,
                     void* c, int ldc, int M, int N,
                     int act, int a_dt, int w_dt, int c_dt, void* stream) {
  Segs segs;
  segs.s[0] = Seg{a0, i0, lda0, k0};
  segs.s[1] = Seg{a1, i1, lda1, k1};
  segs.s[2] = Seg{a2, i2, lda2, k2};
  segs.n = nseg;
  if (a_dt != w_dt) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_dt == 1) {
    // rows, K widths and the weight's pitch a multiple of 4 elements
    // (8-byte copies)
    if (ldw % CHUNK) return (int)cudaErrorInvalidValue;
    for (int s = 0; s < nseg; ++s)
      if (segs.s[s].lda % CHUNK || segs.s[s].k % CHUNK ||
          reinterpret_cast<uintptr_t>(segs.s[s].a) % 8)
        return (int)cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(w) % 8) return (int)cudaErrorInvalidValue;
    dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
    const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
    if (emul || pre)
      ISG_WITH_T(c_dt, TC,
          gemm_bf16_kernel<TC, true><<<grid, TNT, 0, st>>>(
              segs, wb, ldw, bias, row_scale, emul, pre,
              static_cast<TC*>(c), ldc, M, N, act));
    else
      ISG_WITH_T(c_dt, TC,
          gemm_bf16_kernel<TC, false><<<grid, TNT, 0, st>>>(
              segs, wb, ldw, bias, row_scale, nullptr, nullptr,
              static_cast<TC*>(c), ldc, M, N, act));
  } else {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    const float* wf = static_cast<const float*>(w);
    if (emul || pre)
      ISG_WITH_T(c_dt, TC,
          gemm_kernel<TC, true><<<grid, NT, 0, st>>>(
              segs, wf, ldw, bias, row_scale, emul, pre,
              static_cast<TC*>(c), ldc, M, N, act));
    else
      ISG_WITH_T(c_dt, TC,
          gemm_kernel<TC, false><<<grid, NT, 0, st>>>(
              segs, wf, ldw, bias, row_scale, nullptr, nullptr,
              static_cast<TC*>(c), ldc, M, N, act));
  }
  return (int)cudaGetLastError();
}

// C (+)= A(M x K) B(K x N) with the operand conventions of
// gemm_any_kernel; splits > 1 splits K into that many slices whose
// partial tiles go to work [splits, M, N] and are summed in order.
ISG_API int isg_gemm_any(const float* a, int lda, int atr, const void* b,
                         const int* bidx, int ldb, int b_dt, float* c,
                         int ldc, int M, int N, int K, int accumulate,
                         float* work, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || (splits > 1 && !work)) return (int)cudaErrorInvalidValue;
  int kchunk = ((K + splits - 1) / splits + GBK - 1) / GBK * GBK;
  if (kchunk < GBK) kchunk = GBK;
  const int z = K > 0 ? (K + kchunk - 1) / kchunk : 1;
  if (M <= 0 || N <= 0) return 0;
  dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM, z);
  float* w = z > 1 ? work : nullptr;
  ISG_WITH_T(b_dt, TB,
      if (atr)
        gemm_any_kernel<TB, true><<<grid, GNT, 0, st>>>(
            a, lda, static_cast<const TB*>(b), bidx, ldb, c, ldc, M, N, K,
            kchunk, accumulate, w);
      else
        gemm_any_kernel<TB, false><<<grid, GNT, 0, st>>>(
            a, lda, static_cast<const TB*>(b), bidx, ldb, c, ldc, M, N, K,
            kchunk, accumulate, w));
  int err = (int)cudaGetLastError();
  if (err || z <= 1) return err;
  reduce_rows_kernel<<<264, 256, 0, st>>>(work, c, ldc, M, N, z, accumulate);
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
