// Staged backward GEMM of the training layers (isg_gemm_bwd): one launch
// takes every dgrad and wgrad product of one stage of a layer's backward
// chain, with the stage's elementwise work in its epilogue.  It replaces,
// for the MetaLayer and the decoder layer, the jnp.dot products and the
// elementwise steps between them inside the backward Pallas kernels
// isubgvqa_tpu/ops/pallas/metalayer_train.py:_bwd_kernel and
// text_train.py:_make_dec_bwd.
//
// A stage is a table of up to four problems, C[m, n] = sum_k G(m, k)
// S(k, n), each over its own range of blockIdx.x:
//   dgrad  G = dY [M rows, K] row-major        S = W [K, N] (a weight's rows)
//   wgrad  G = dY stored [K rows, M] (read transposed)
//          S = [X_0[idx_0] | X_1[idx_1] | X_2] [K rows, N]: up to three
//          column segments, each a saved activation whose rows may be
//          gathered through an index (a zero row where it is negative).
// G is always an f32 gradient; S is a bf16 or f32 tensor of the model.
//
// Epilogue (per problem): a wgrad with a bias writes the column sum of G
// over k, the bias gradient, from a virtual ones column of S at column N,
// so the sum comes out of the same products and the same split-K order.
// A dgrad's columns fall in up to three output segments, each
//   out = act'(acc + add)    at f32 or bf16, at its own address and pitch
// with act' none, exact GELU's derivative at a saved f32 pre-activation,
// or ReLU's: (pre > 0) * keep.  So the layer's backward needs no
// column-sum, activation-derivative, zero-fill or cast launch of its own,
// and one launch runs a stage's dgrad and wgrad.
//
// Bound on the H100: operations.  The products are f32-accurate by
// design (the Pallas backward takes them in f32), which the tensor cores
// reach only by splitting.  Two cores, chosen by S's type:
//
// * bf16 S (the bf16 model): bf16x3 on wgmma.  G splits into three bf16
//   planes, g = g1 + g2 + g3, each the round-to-nearest bf16 of what the
//   earlier planes leave: together they carry f32's 24 mantissa bits and
//   its exponent range, and each plane times an exact bf16 S is exact in
//   the f32 sum.  Three products at 989 TFLOP/s: a ceiling of 330 TFLOP/s
//   of f32-accurate products (gemm_any.cu's 3xTF32 reaches 248 at best).
//   wgmma reads an MN-major operand from shared memory only for 16-bit
//   types (the descriptor's transpose bit), and S is MN-major in both
//   forms (a weight's row is along N; an activation's row is along N with
//   rows as the reduction), so S lands as it lies: cp.async copies, 16
//   bytes where the pitch allows, else 8 (a 600-byte row), gathered
//   through the row index, into 64-column swizzle atoms.  G's planes are
//   made by the block's threads: each thread loads its share of the next
//   slice's f32 tile into registers a slice ahead, splits it while the
//   current slice's wgmma run, and writes the planes K-major (transposing
//   a wgrad's G on the way), then a proxy fence orders the generic stores
//   before wgmma reads them.  The alternative, planes written by the
//   epilogue of whatever produced the gradient, would triple the bytes of
//   every gradient in device memory and needs every producer (GraphNorm,
//   LayerNorm, attention, scatter backward) to write them.
//   Block: 64 rows x 304 columns, two warpgroups of 64 x 152 (a 300-wide
//   output is 2 x 152, 1.3 % waste).  wgmma's own accumulation truncates,
//   and over a long reduction its error grows with the number of steps
//   (without the fresh tile below, 5.4e-6 of the result at K = 98,304,
//   against 5.2e-7 with it, on an H100), so each 64-deep slice's twelve
//   wgmma go into a fresh register tile that is added to the running sum
//   in f32: 152 accumulator registers a thread, one block an SM, three S
//   stages and two plane buffers in flight (193 KB of shared memory).
//   Measured on an H100 (scripts/gemm_bwd_lab.py), no one part sets the
//   time: without the wgmma the kernel runs 86-98 % as long, without S's
//   copies 79-82 %, without G's loads and planes 87-97 %, with all three
//   loads and conversions gone 64-74 %, while chains of twelve
//   m64n152k16 wgmma alone run at 973 TFLOP/s.
// * f32 S (the f32 model, TF32 off): gemm_any.cu's 3xTF32 on mma.sync
//   (tensor_core.cuh), a 64 x 128 block of eight warps, three cp.async
//   stages, the same table, loads of G and S and epilogue.
//
// wgrad reduces over every node, edge or token row of the batch (up to
// ~10^5), so its k range is split across blocks: every slice writes its
// f32 partial tile, and the last block to arrive at a tile (a per-tile
// counter after a __threadfence) sums the slices in slice order and runs
// the epilogue, then resets the counter.  Deterministic, no float atomics.
// The wrapper (ops/gemm.py:bwd_stage) orders a stage's wgrad blocks before
// its dgrad blocks, so the long split-K blocks start first.

#include <string.h>

#include "common.cuh"
#include "hopper.cuh"
#include "tensor_core.cuh"

namespace isg {

// The problem table, every field 8 bytes (ops/gemm.py packs int64s).
struct BwdSeg {            // a column range of S
  const void* s;           // [rows, ld] at S's type
  const int* idx;          // S row of reduction index k: idx[k]; null: k
  long long ld, n0;        // row pitch; first column of the range
};
struct BwdOut {            // a column range of a result
  void* out;
  long long ldo, odt;      // pitch, type (0 f32, 1 bf16)
  const void* add;
  long long lda, adt;      // out = acc + add
  long long act;           // 0 none, 1 gelu'(pre), 2 (pre > 0) * keep
  const void* pre;
  long long ldp, pdt;
  const void* keep;
  long long ldk, kdt;
  long long n0;            // first column of the range
};
struct BwdProblem {
  long long kind;          // 0 dgrad, 1 wgrad (G read transposed)
  const float* g;
  long long ldg, M, N, K;
  float* bias;             // wgrad: bias[m] = sum_k G(m, k), or null
  BwdSeg seg[3];
  long long nseg;
  BwdOut out[3];
  long long nout;
  long long tiles_n, splits, kchunk, block0;
  float* work;             // [splits, M, (N + (bias != null) + 3) & ~3]
  int* counters;           // one zeroed int per output tile, left zeroed
};
static_assert(sizeof(BwdSeg) == 32 && sizeof(BwdOut) == 112 &&
                  sizeof(BwdProblem) == 69 * 8,
              "ops/gemm.py packs 69 int64 a problem");
constexpr int kMaxProblems = 4;
struct BwdStage {
  BwdProblem p[kMaxProblems];
  int nprob;
};

struct Tile {
  int pi, tm, tn, z;
};

// The block's problem, output tile and k slice: blocks of a problem run
// slice-major, then row tiles, then column tiles.
__device__ __forceinline__ Tile decode(const BwdStage& st, int bm) {
  int pi = 0;
  while (pi + 1 < st.nprob && (long long)blockIdx.x >= st.p[pi + 1].block0)
    ++pi;
  const BwdProblem& P = st.p[pi];
  int b = (int)(blockIdx.x - P.block0);
  const int tiles_m = (int)((P.M + bm - 1) / bm);
  Tile t;
  t.pi = pi;
  t.tn = b % (int)P.tiles_n;
  b /= (int)P.tiles_n;
  t.tm = b % tiles_m;
  t.z = b / tiles_m;
  return t;
}

// The segment of S (or of the outputs) holding column n.
template <typename Seg>
__device__ __forceinline__ int seg_of(const Seg* s, long long count,
                                      long long n) {
  int i = 0;
  while (i + 1 < count && n >= s[i + 1].n0) ++i;
  return i;
}

// Four consecutive values of a row at f32 or bf16 (vector accesses where
// the address allows them).
__device__ __forceinline__ void ld4(const void* p, long long i, long long dt,
                                    float (&v)[4]) {
  if (dt) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p) + i;
    if ((reinterpret_cast<uintptr_t>(q) & 7) == 0) {
      const uint2 u = *reinterpret_cast<const uint2*>(q);
      v[0] = __uint_as_float(u.x << 16);
      v[1] = __uint_as_float(u.x & 0xFFFF0000u);
      v[2] = __uint_as_float(u.y << 16);
      v[3] = __uint_as_float(u.y & 0xFFFF0000u);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = __bfloat162float(q[e]);
    }
  } else {
    const float* q = static_cast<const float*>(p) + i;
    if ((reinterpret_cast<uintptr_t>(q) & 15) == 0) {
      const float4 u = *reinterpret_cast<const float4*>(q);
      v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = q[e];
    }
  }
}

__device__ __forceinline__ void st4(void* p, long long i, long long dt,
                                    const float (&v)[4]) {
  if (dt) {
    __nv_bfloat16* q = static_cast<__nv_bfloat16*>(p) + i;
    const __nv_bfloat16 b[4] = {__float2bfloat16(v[0]), __float2bfloat16(v[1]),
                                __float2bfloat16(v[2]), __float2bfloat16(v[3])};
    if ((reinterpret_cast<uintptr_t>(q) & 7) == 0) {
      *reinterpret_cast<uint2*>(q) =
          make_uint2((uint32_t)__bfloat16_as_ushort(b[0]) |
                         ((uint32_t)__bfloat16_as_ushort(b[1]) << 16),
                     (uint32_t)__bfloat16_as_ushort(b[2]) |
                         ((uint32_t)__bfloat16_as_ushort(b[3]) << 16));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) q[e] = b[e];
    }
  } else {
    float* q = static_cast<float*>(p) + i;
    if ((reinterpret_cast<uintptr_t>(q) & 15) == 0) {
      *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) q[e] = v[e];
    }
  }
}

// The block's result tile, staged as f32 in ys[BM][BNP], through the
// split-K reduction (when split) and the epilogue; every thread calls it.
// Thread t owns the 4-column chunk t % (BN / 4) of rows t / (BN / 4) + i
// (BN / 4 chunks a row; neighbouring threads, neighbouring chunks), so its
// output range and epilogue inputs are resolved once.  Output ranges start
// at multiples of 4 columns and N is one, so no chunk straddles two; the
// chunk at column N of a wgrad with a bias holds the bias gradient first.
// Split partial tiles lie in work at a row pitch of N + 1 rounded up to 4.
template <int BM, int BN, int BNP>
__device__ __forceinline__ void finish_tile(const BwdProblem& P,
                                            const Tile& t, const float* ys,
                                            int* last) {
  constexpr int CPR = BN / 4, RSTEP = 256 / CPR, ACTIVE = RSTEP * CPR;
  const int tid = threadIdx.x, cc = tid % CPR, r0 = tid / CPR;
  const int m0 = t.tm * BM, n = t.tn * BN + 4 * cc;
  const long long nw = P.N + (P.bias ? 1 : 0), wp = (nw + 3) & ~3LL;
  const bool active = tid < ACTIVE && n < nw;
  const int rows = (int)min((long long)BM, P.M - m0);
  const int Z = (int)P.splits;
  if (Z > 1) {
    if (active)
      for (int r = r0; r < rows; r += RSTEP)
        *reinterpret_cast<float4*>(P.work + ((long long)t.z * P.M + m0 + r) *
                                                wp + n) =
            *reinterpret_cast<const float4*>(ys + r * BNP + 4 * cc);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int tile = t.tm * (int)P.tiles_n + t.tn;
      *last = atomicAdd(&P.counters[tile], 1) == Z - 1;
      if (*last) P.counters[tile] = 0;   // every slice has arrived: reset
    }
    __syncthreads();
    if (!*last) return;
    __threadfence();
  }
  if (!active) return;
  // row r's four values: the staged tile, or the slices summed in order
  auto value = [&](int r, float (&v)[4]) {
    if (Z > 1) {
      v[0] = v[1] = v[2] = v[3] = 0.f;
      for (int z = 0; z < Z; ++z) {
        const float4 u = __ldcg(reinterpret_cast<const float4*>(
            P.work + ((long long)z * P.M + m0 + r) * wp + n));
        v[0] += u.x; v[1] += u.y; v[2] += u.z; v[3] += u.w;
      }
    } else {
      const float4 u = *reinterpret_cast<const float4*>(ys + r * BNP + 4 * cc);
      v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
    }
  };
  if (n >= P.N) {                        // n == N: the bias gradient
    for (int r = r0; r < rows; r += RSTEP) {
      float v[4];
      value(r, v);
      P.bias[m0 + r] = v[0];
    }
    return;
  }
  const BwdOut& o = P.out[seg_of(P.out, P.nout, n)];
  void* const out = o.out;
  const void* const add = o.add;
  const void* const pre = o.pre;
  const void* const keep = o.keep;
  const long long c = n - o.n0, ldo = o.ldo, odt = o.odt, lda = o.lda;
  const long long adt = o.adt, ldp = o.ldp, pdt = o.pdt, ldk = o.ldk;
  const long long kdt = o.kdt;
  const int act = (int)o.act;
  for (int r = r0; r < rows; r += RSTEP) {
    const long long m = m0 + r;
    float v[4], u[4];
    value(r, v);
    if (add) {
      ld4(add, m * lda + c, adt, u);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] += u[e];
    }
    if (act == 1) {
      ld4(pre, m * ldp + c, pdt, u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = u[e];
        const float cdf = 0.5f * (1.f + erff(x * 0.70710678118654752f));
        const float pdf = 0.39894228040143268f * expf(-0.5f * x * x);
        v[e] *= cdf + x * pdf;
      }
    } else if (act == 2) {
      ld4(pre, m * ldp + c, pdt, u);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = u[e] > 0.f ? v[e] : 0.f;
      if (keep) {
        ld4(keep, m * ldk + c, kdt, u);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] *= u[e];
      }
    }
    st4(out, m * ldo + c, odt, v);
  }
}

__device__ __forceinline__ void st_shared8(uint32_t addr, uint32_t lo) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(addr), "r"(lo),
               "r"(0u)
               : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t addr, uint32_t lo) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %2, %2};\n" ::"r"(addr),
               "r"(lo), "r"(0u)
               : "memory");
}

// ------------------------------------------------- bf16x3 core (wgmma)

constexpr int XBM = 64, XWN = 152, XBN = 2 * XWN, XBK = 64, XNS = 3;
constexpr int X_ATOM = XBK * 128;          // 64 K rows x 64 bf16 columns
constexpr int X_WG_S = 3 * X_ATOM;         // a warpgroup's 152 columns
constexpr int X_S = 2 * X_WG_S;            // one stage of S
constexpr int X_PLANE = XBM * 128;         // 64 rows x 64 bf16, K-major
constexpr int X_PLANES = 3 * X_PLANE;
constexpr int X_BNP = XBN + 4;             // floats a staged row
constexpr int X_COPIERS = 228;             // threads copying S: 3 x 76, 6 x 38
constexpr int X_SMEM = XNS * X_S + 2 * X_PLANES + XNS * 8 + 1024;
// S's MN-major descriptor (bytes): its 64-column atoms lie X_ATOM apart
// along N (the leading offset), its 8-row groups 1 KB apart along K (the
// stride offset).  The swapped reading fails the plain twin on an H100.
constexpr uint32_t X_MN_LBO = X_ATOM, X_MN_SBO = 1024;
static_assert(XBM * X_BNP * 4 <= XNS * X_S, "staging fits the ring");
static_assert(X_S % 1024 == 0 && X_PLANE % 1024 == 0, "swizzle alignment");

// The three bf16 planes of the pair (x, y), each plane's two values packed
// (x in the low half): p0 = bf16(x), p1 = bf16(x - p0), p2 = bf16(x - p0
// - p1), each to nearest even, two at a time (cvt.rn.bf16x2.f32).
__device__ __forceinline__ void split3x2(float x, float y, uint32_t (&w)[3]) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(x, y);
  const float2 f0 = __bfloat1622float2(h0);
  const float rx = x - f0.x, ry = y - f0.y;
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(rx, ry);
  const float2 f1 = __bfloat1622float2(h1);
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(rx - f1.x, ry - f1.y);
  w[0] = *reinterpret_cast<const uint32_t*>(&h0);
  w[1] = *reinterpret_cast<const uint32_t*>(&h1);
  w[2] = *reinterpret_cast<const uint32_t*>(&h2);
}

// This thread's share of G's 64 x 64 slice at reduction index k0: 16
// consecutive k of one row (f32, zero past M and kend) — a dgrad's row
// t / 4, k 16 (t % 4) .. (four 16-byte loads); a wgrad's row t % 64, k
// 16 (t / 64) .. (sixteen 4-byte loads, consecutive threads on
// consecutive m: coalesced).
__device__ __forceinline__ void load_g(const BwdProblem& P, int m0, int k0,
                                       int kend, float (&v)[16]) {
  const int t = threadIdx.x;
  if (P.kind == 0) {
    const int m = m0 + (t >> 2), k = k0 + (t & 3) * 16;
    const float* src = P.g + (long long)m * P.ldg + k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 u = m < P.M && k + 4 * j < kend
                           ? *reinterpret_cast<const float4*>(src + 4 * j)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * j] = u.x; v[4 * j + 1] = u.y; v[4 * j + 2] = u.z;
      v[4 * j + 3] = u.w;
    }
  } else {
    const int m = m0 + (t & 63), k = k0 + (t >> 6) * 16;
    const float* src = P.g + (long long)k * P.ldg + m;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      v[j] = m < P.M && k + j < kend ? src[j * P.ldg] : 0.f;
  }
}

// The three bf16 planes of load_g's values into the K-major swizzled
// tiles at `pl` (plane p at pl + p * X_PLANE): row r holds k 0..63 in
// 16-byte chunks at chunk ^ (r % 8), as TMA's 128-byte swizzle would; a
// thread writes chunks 2q and 2q + 1 of its row (eight rows of a warp's
// stores fall on distinct chunks: no bank conflicts).
__device__ __forceinline__ void write_planes(const BwdProblem& P, uint8_t* pl,
                                             const float (&v)[16]) {
  const int t = threadIdx.x;
  const int r = P.kind == 0 ? t >> 2 : t & 63;
  const int q = P.kind == 0 ? t & 3 : t >> 6;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t w[3][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t u[3];
      split3x2(v[8 * h + 2 * e], v[8 * h + 2 * e + 1], u);
#pragma unroll
      for (int p = 0; p < 3; ++p) w[p][e] = u[p];
    }
    const int off = r * 128 + (((2 * q + h) ^ (r & 7)) << 4);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint4*>(pl + p * X_PLANE + off) =
          make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
  }
}

// S's 64 x 304 slice at reduction index k0 into the stage at `slot`: the
// columns of warpgroup w in three 64-column MN-major atoms (K row r of an
// atom holds 64 columns in 16-byte chunks at chunk ^ (r % 8)).  Threads
// below X_COPIERS each own one chunk column (16 bytes with WIDE, else 8)
// and walk the rows, their row offsets (through the gather index) loaded
// first; a chunk past K, of a negative row index or past N reads nothing;
// column N of a wgrad with a bias holds ones.  Every thread then arrives
// on `bar` once its copies have landed.
template <bool WIDE>
__device__ __forceinline__ void issue_s(const BwdProblem& P, uint32_t slot,
                                        uint32_t bar, int n0, int k0,
                                        int kend) {
  constexpr int CH = WIDE ? 8 : 4, CPR = XBN / CH;
  constexpr int RSTEP = X_COPIERS / CPR, ROWS = (XBK + RSTEP - 1) / RSTEP;
  const int t = threadIdx.x;
  if (t < X_COPIERS) {
    const int cc = t % CPR, r0 = t / CPR;
    const int lc = cc * CH, n = n0 + lc;
    const int wg = lc >= XWN ? 1 : 0, c = lc - wg * XWN;
    const uint32_t col = slot + wg * X_WG_S + (c >> 6) * X_ATOM + (c & 7) * 2;
    const int chunk = (c & 63) >> 3;
    if (n < P.N) {
      const BwdSeg& g = P.seg[seg_of(P.seg, P.nseg, n)];
      const __nv_bfloat16* base =
          static_cast<const __nv_bfloat16*>(g.s) + (n - g.n0);
      const int* idx = g.idx;
      const int ld = (int)g.ld;
      int off[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int r = r0 + i * RSTEP, k = k0 + r;
        const int row = r < XBK && k < kend ? (idx ? idx[k] : k) : -1;
        off[i] = row >= 0 ? row * ld : -1;
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int r = r0 + i * RSTEP;
        if (r < XBK)
          cp_async_zfill<2 * CH>(col + r * 128 + ((chunk ^ (r & 7)) << 4),
                                 off[i] >= 0 ? base + off[i] : base,
                                 off[i] >= 0);
      }
    } else {
      // the virtual ones column (the bias gradient) and zeros past it
      const uint32_t fill = n == P.N && P.bias ? 0x3F80u : 0u;   // bf16 1.0
      for (int r = r0; r < XBK; r += RSTEP) {
        const uint32_t dst = col + r * 128 + ((chunk ^ (r & 7)) << 4);
        if (WIDE)
          st_shared16(dst, fill);
        else
          st_shared8(dst, fill);
      }
      fence_proxy_async();
    }
  }
  cp_async_mbar_arrive(bar);
}

__device__ __forceinline__ bool wide_copies(const BwdProblem& P) {
  if (P.N % 8) return false;
  for (int s = 0; s < P.nseg; ++s)
    if (P.seg[s].ld % 8 || P.seg[s].n0 % 8 ||
        reinterpret_cast<uintptr_t>(P.seg[s].s) % 16)
      return false;
  return true;
}

__global__ void __launch_bounds__(256, 1)
gemm_bwd_bf16x3_kernel(const __grid_constant__ BwdStage st) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int last;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t ring = base, planes = base + XNS * X_S;
  const uint32_t full = planes + 2 * X_PLANES;
  uint8_t* planes_g = gbase + XNS * X_S;
  float* ys = reinterpret_cast<float*>(gbase);

  const Tile tile = decode(st, XBM);
  const BwdProblem& P = st.p[tile.pi];
  const int tid = threadIdx.x;
  const int m0 = tile.tm * XBM, n0 = tile.tn * XBN;
  const int kbeg = tile.z * (int)P.kchunk;
  const int kend = (int)min(P.K, (long long)kbeg + P.kchunk);
  const int KT = kend > kbeg ? (kend - kbeg + XBK - 1) / XBK : 0;
  const bool wide = wide_copies(P);
  if (tid == 0) {
    for (int s = 0; s < XNS; ++s) mbar_init(full + 8 * s, 256);
    fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int slice) {
    const uint32_t slot = ring + (slice % XNS) * X_S;
    const uint32_t bar = full + 8 * (slice % XNS);
    if (wide)
      issue_s<true>(P, slot, bar, n0, kbeg + slice * XBK, kend);
    else
      issue_s<false>(P, slot, bar, n0, kbeg + slice * XBK, kend);
  };
  for (int s = 0; s < XNS - 1 && s < KT; ++s) issue(s);
  float gv[16];
  if (KT > 0) {
    load_g(P, m0, kbeg, kend, gv);
    write_planes(P, planes_g, gv);
    fence_proxy_async();
  }
  if (KT > 1) load_g(P, m0, kbeg + XBK, kend, gv);
  __syncthreads();

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  float acc[XWN / 2], fresh[XWN / 2];
#pragma unroll
  for (int i = 0; i < XWN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % XNS, pb = kt & 1;
    mbar_wait(full + 8 * s, (kt / XNS) & 1);
    __syncwarp();                   // wgmma's .aligned forms need the warp whole
    fence_proxy_async();
    const uint32_t a = planes + pb * X_PLANES;
    const uint32_t b = ring + s * X_S + wg * X_WG_S;
    wgmma_fence();
    fence_regs(fresh);
    // the small planes first, into a fresh tile: g3 s, g2 s, g1 s
#pragma unroll
    for (int p = 2; p >= 0; --p)
#pragma unroll
      for (int kk = 0; kk < XBK / 16; ++kk)
        wgmma_m64n152k16<1>(
            fresh, wgmma_desc(a + p * X_PLANE + kk * 32),
            wgmma_desc_mn(b + kk * 16 * 128, X_MN_LBO, X_MN_SBO),
            p == 2 && kk == 0 ? 0 : 1);
    wgmma_commit();
    fence_regs(fresh);
    // meanwhile: S of slice kt + 2 into the stage slice kt - 1 used, the
    // planes of slice kt + 1, G of slice kt + 2 into registers
    if (kt + XNS - 1 < KT) issue(kt + XNS - 1);
    if (kt + 1 < KT) {
      write_planes(P, planes_g + (pb ^ 1) * X_PLANES, gv);
      fence_proxy_async();
    }
    if (kt + 2 < KT) load_g(P, m0, kbeg + (kt + 2) * XBK, kend, gv);
    wgmma_wait<0>();
    fence_regs(fresh);
#pragma unroll
    for (int i = 0; i < XWN / 2; ++i) acc[i] += fresh[i];
    __syncthreads();                // stage s and planes pb are free
  }

  // Stage the f32 tile in the ring (every stage was waited on, every
  // product is done).  Register 4q + 2i + e holds row 16 warp + g + 8i,
  // column 8q + 2 t4 + e of the warpgroup's 64 x 152.
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int q = 0; q < XWN / 8; ++q)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i;
      *reinterpret_cast<float2*>(ys + r * X_BNP + wg * XWN + 8 * q + 2 * t4) =
          make_float2(acc[4 * q + 2 * i], acc[4 * q + 2 * i + 1]);
    }
  __syncthreads();
  finish_tile<XBM, XBN, X_BNP>(P, tile, ys, &last);
}

// --------------------------------------------- 3xTF32 core (mma.sync)

constexpr int TBM = 64, TBN = 128, TBK = 32, TNS = 3;
constexpr int T_GLD = TBK + 4;      // a dgrad's G rows (m-major)
constexpr int T_GLDT = TBM + 8;     // a wgrad's G rows (k-major)
constexpr int T_SLD = TBN + 8;      // S rows (k-major)
constexpr int T_G = TBM * T_GLD;    // floats a stage (== TBK * T_GLDT)
constexpr int T_STAGE = T_G + TBK * T_SLD;
constexpr int T_BNP = TBN + 4;
constexpr int T_SMEM = TNS * T_STAGE * 4;
static_assert(TBK * T_GLDT == T_G, "both G layouts fill a stage's G");
static_assert(TBM * T_BNP <= TNS * T_STAGE, "staging fits the ring");

__global__ void __launch_bounds__(256, 2)
gemm_bwd_tf32x3_kernel(const __grid_constant__ BwdStage st) {
  extern __shared__ __align__(16) float fsm[];
  __shared__ int last;
  const Tile tile = decode(st, TBM);
  const BwdProblem& P = st.p[tile.pi];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = tile.tm * TBM, n0 = tile.tn * TBN;
  const int kbeg = tile.z * (int)P.kchunk;
  const int kend = (int)min(P.K, (long long)kbeg + P.kchunk);
  const int KT = kend > kbeg ? (kend - kbeg + TBK - 1) / TBK : 0;
  const bool trans = P.kind == 1;
  const int row0 = (warp / 4) * 32, col0 = (warp % 4) * 32;
  const int g = lane / 4, t4 = lane % 4;

  // this thread's S column chunk (fixed) and its segment
  const int nc = (tid % 32) * 4, n = n0 + nc;
  const BwdSeg& sg = P.seg[seg_of(P.seg, P.nseg, n)];
  const float* sbase = static_cast<const float*>(sg.s) + (n - sg.n0);
  const bool data = n < P.N;
  const float fill = n == P.N && P.bias ? 1.f : 0.f;

  auto load = [&](int kt, int stage) {
    float* gs = fsm + stage * T_STAGE;
    float* ss = gs + T_G;
    const int k0 = kbeg + kt * TBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (trans) {
        const int kr = tid / 16 + 16 * i, mc = (tid % 16) * 4;
        const int k = k0 + kr, m = m0 + mc;
        const bool ok = k < kend && m < P.M;
        copy4<float>(gs + kr * T_GLDT + mc,
                     ok ? P.g + (long long)k * P.ldg + m : P.g, ok ? 4 : 0,
                     true);
      } else {
        const int r = tid / 8 + 32 * i, c = (tid % 8) * 4;
        const int m = m0 + r, k = k0 + c;
        const bool ok = m < P.M && k < kend;
        copy4<float>(gs + r * T_GLD + c,
                     ok ? P.g + (long long)m * P.ldg + k : P.g, ok ? 4 : 0,
                     true);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = tid / 32 + 8 * i, k = k0 + kr;
      float* dst = ss + kr * T_SLD + nc;
      if (data) {
        const long long row =
            k < kend ? (sg.idx ? (long long)sg.idx[k] : k) : -1;
        const bool ok = row >= 0;
        copy4<float>(dst, ok ? sbase + row * sg.ld : sbase, ok ? 4 : 0, true);
      } else {
        dst[0] = fill;
        dst[1] = dst[2] = dst[3] = 0.f;
      }
    }
  };
  auto frag_a = [&](const float* gs, int i, int ks, uint32_t (&ah)[4],
                    uint32_t (&al)[4]) {
    const int r = row0 + i * 16 + g;
    float a[4];
    if (trans) {
      a[0] = gs[(ks + t4) * T_GLDT + r];
      a[1] = gs[(ks + t4) * T_GLDT + r + 8];
      a[2] = gs[(ks + t4 + 4) * T_GLDT + r];
      a[3] = gs[(ks + t4 + 4) * T_GLDT + r + 8];
    } else {
      a[0] = gs[r * T_GLD + ks + t4];
      a[1] = gs[(r + 8) * T_GLD + ks + t4];
      a[2] = gs[r * T_GLD + ks + t4 + 4];
      a[3] = gs[(r + 8) * T_GLD + ks + t4 + 4];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(a[q], ah[q], al[q]);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
#pragma unroll
  for (int s = 0; s < TNS - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<TNS - 2>();       // slice kt has landed
    __syncthreads();                // ... for every thread; kt - 1 is consumed
    const int kn = kt + TNS - 1;
    if (kn < KT) load(kn, kn % TNS);
    cp_async_commit();
    const float* gs = fsm + (kt % TNS) * T_STAGE;
    const float* ss = gs + T_G;
#pragma unroll
    for (int ks = 0; ks < TBK; ks += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = col0 + j * 8 + g;
        split_tf32(ss[(ks + t4) * T_SLD + nn], bh[j][0], bl[j][0]);
        split_tf32(ss[(ks + t4 + 4) * T_SLD + nn], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t ah[4], al[4];
        frag_a(gs, i, ks, ah, al);
        mma_3xtf32_x4<true>(acc[i], ah, al, bh, bl, 4);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* ys = fsm;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        ys[(row0 + i * 16 + g + (q >> 1) * 8) * T_BNP + col0 + j * 8 +
           t4 * 2 + (q & 1)] = acc[i][j][q];
  __syncthreads();
  finish_tile<TBM, TBN, T_BNP>(P, tile, ys, &last);
}

static bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// What the kernels take (else the launch is refused): see isg_gemm_bwd.
static bool valid(const BwdProblem& P, int bm, int bn, int bk, int s_bytes) {
  if (P.kind < 0 || P.kind > 1 || P.M < 1 || P.N < 1 || P.K < 1 ||
      P.N % 4 || !P.g || !aligned(P.g, 16) || P.ldg % 4)
    return false;
  if (P.kind == 0 ? (P.K % 4 || P.ldg < P.K || P.bias)
                  : (P.M % 4 || P.ldg < P.M))
    return false;
  if (P.nseg < 1 || P.nseg > 3 || P.seg[0].n0 != 0 ||
      (P.kind == 0 && P.nseg != 1))
    return false;
  for (int s = 0; s < P.nseg; ++s) {
    const BwdSeg& g = P.seg[s];
    if (!g.s || g.ld % 4 || g.n0 % 4 || g.n0 >= P.N ||
        (s && g.n0 <= P.seg[s - 1].n0) || !aligned(g.s, 4 * s_bytes))
      return false;
  }
  if (P.nout < 1 || P.nout > 3 || P.out[0].n0 != 0) return false;
  for (int s = 0; s < P.nout; ++s) {
    const BwdOut& o = P.out[s];
    if (!o.out || o.act < 0 || o.act > 2 || (o.act && !o.pre) ||
        o.n0 % 4 || o.n0 >= P.N || (s && o.n0 <= P.out[s - 1].n0))
      return false;
  }
  const long long nw = P.N + (P.bias ? 1 : 0);
  if (P.tiles_n != (nw + bn - 1) / bn || P.splits < 1 || P.kchunk < bk ||
      P.kchunk % bk || (P.splits - 1) * P.kchunk >= P.K ||
      P.splits * P.kchunk < P.K)
    return false;
  if (P.splits > 1 && (!P.work || !P.counters)) return false;
  (void)bm;
  return true;
}

}  // namespace isg

using namespace isg;

// One backward stage: `table` holds nprob (1..4) problems (BwdProblem,
// 69 int64 each) whose blocks run from block0 to the next problem's
// block0, each problem's count being ceil(M / 64) * tiles_n * splits.
// core 1: bf16 S on wgmma (bf16x3; tiles of 64 x 304, 64-deep slices);
// core 0: f32 S on mma.sync (3xTF32; tiles of 64 x 128, 32-deep slices).
// Refused (cudaErrorInvalidValue): M, N or K below 1; N not a multiple of
// 4; G not 16-byte aligned or a pitch not a multiple of 4; a dgrad whose
// K is not a multiple of 4, with more than one S segment or with a bias;
// a wgrad whose M is not a multiple of 4; S segments or output ranges out
// of order, S or output range starts or S pitches not multiples of 4
// elements; tile counts, slices or block ranges that do not match the
// shapes.  S's row offsets are 32-bit (ops/gemm.py keeps S under 2^31
// elements).
ISG_API int isg_gemm_bwd(const void* table, int nprob, int core,
                         void* stream) {
  if (nprob < 1 || nprob > kMaxProblems || core < 0 || core > 1)
    return (int)cudaErrorInvalidValue;
  BwdStage st;
  memset(&st, 0, sizeof(st));
  memcpy(st.p, table, sizeof(BwdProblem) * nprob);
  st.nprob = nprob;
  const int bm = core ? XBM : TBM, bn = core ? XBN : TBN;
  const int bk = core ? XBK : TBK, s_bytes = core ? 2 : 4;
  long long blocks = 0;
  for (int i = 0; i < nprob; ++i) {
    const BwdProblem& P = st.p[i];
    if (!valid(P, bm, bn, bk, s_bytes) || P.block0 != blocks)
      return (int)cudaErrorInvalidValue;
    blocks += (P.M + bm - 1) / bm * P.tiles_n * P.splits;
  }
  if (blocks > (1LL << 31) - 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool smem_set[2] = {false, false};   // once: a host call otherwise
  if (core) {
    if (!smem_set[1]) {
      const int err = (int)cudaFuncSetAttribute(
          gemm_bwd_bf16x3_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, X_SMEM);
      if (err) return err;
      smem_set[1] = true;
    }
    gemm_bwd_bf16x3_kernel<<<(unsigned)blocks, 256, X_SMEM, s>>>(st);
  } else {
    if (!smem_set[0]) {
      const int err = (int)cudaFuncSetAttribute(
          gemm_bwd_tf32x3_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM);
      if (err) return err;
      smem_set[0] = true;
    }
    gemm_bwd_tf32x3_kernel<<<(unsigned)blocks, 256, T_SMEM, s>>>(st);
  }
  return (int)cudaGetLastError();
}
