// Hopper GEMM for the graph layers' bf16 products: wgmma fed by cp.async
// copies that gather A's rows and by TMA loads of W.
//
//   C[m, n] = act( sum_s A_s'[m, :] . W[n, cols_s] + bias[n] )
//             * emul[m, n] * row_scale[m]                  (isg_gemm_gather)
//
// with up to three segments s; A_s'[m] is row idx_s[m] of A_s (a zero row
// where idx_s[m] < 0) or row m where idx_s is null.  The segments are a
// virtual concatenation along K, so the MetaLayer's edge MLP on
// [x_src, x_dst, e] runs against its [C, 3C] weight without the [E, 3C]
// concat.  The optional f32 `pre` receives acc + bias (the training
// forward keeps it for the backward).  It takes every bf16 product of the
// Pallas kernels isubgvqa_tpu/ops/pallas/gat_kernel.py:fused_gat_layer
// (x_l | x_r, lin_edge, the x_proj MLP) and metalayer_kernel.py:
// fused_metalayer (the six MLP products), which gemm.cu's mma.sync GEMM
// ran at ~11 % of the card's bf16 peak.
//
// Bound: at the main path's shapes (M = B * N or B * E up to ~10^5 rows,
// K and N of 300 to 2400) the products are operation-bound or close to
// the line (K = N = 300: ~150 FLOP a byte against the card's ~295), with
// short reductions (K = 300: five 64-deep slices a tile).  gemm_sm90.cu's
// all-TMA form cannot take A: a 300-wide bf16 row is 600 bytes, not the
// 16-byte multiple a tensor map needs, and a TMA tile load cannot gather
// rows.  So, per 128 x 152 block of two warpgroups (256 threads):
// * every thread copies its share of each 64-deep K slice of A (gathered
//   through the block's row offsets, computed once into shared memory and
//   held in registers per segment) with cp.async straight into the
//   128-byte-swizzled layout the wgmma descriptor names: 16 bytes a copy
//   where the pitch and addresses allow it, else 8 (a 600-byte pitch); a
//   copy past K_s, past the last row or of a negative index reads nothing
//   and zero-fills.  Thread 0 loads W's slice by TMA onto the same stage
//   mbarrier, whose phase completes when every thread's copies have landed
//   (cp.async.mbarrier.arrive.noinc) and W's bytes have arrived;
// * copies run two slices ahead of the products (a 3-stage ring); each
//   warpgroup runs wgmma m64n152k16 on a landed stage (after a proxy fence:
//   cp.async writes through the generic proxy, wgmma reads through the
//   async one), f32 sums in registers, and a stage is refilled once both
//   warpgroups are past the products that read it (wgmma.wait_group, then
//   a named barrier);
// * no producer warp: the 256 threads fit 128 registers each, so two blocks
//   share an SM and one block's prologue and epilogue overlap the other's
//   products (measured on an H100 faster than a producer warpgroup at one
//   block an SM, with or without a persistent tile loop, than 128-wide
//   tiles, than 64-row blocks at four an SM, and than copying W with
//   cp.async);
// * each segment's K range ends in a partial slice whose A columns are
//   zero-filled, so a slice never straddles two segments (K = 300: 5
//   slices, +6.7 % MMA).  W holds segment s from column
//   sum_{t<s} ceil(K_t / 64) * 64, so a TMA box starts 128-byte aligned (a
//   box at a 600-byte column offset faults) and never reaches into the
//   next segment; the wrapper lays a torch weight out so once, with zero
//   columns between the segments, and TMA zero-fills past the last;
// * the epilogue stages the f32 tile in the idle ring and walks it in
//   chunks of 4 columns: bias, exact GELU or ReLU, emul, row_scale, the
//   f32 pre and the output at f32 or bf16 (8-byte stores for a bf16 row of
//   600 bytes).
//
// Tiles.  wgmma takes any N that is a multiple of 8 up to 256: a 300-wide
// output is 2 x 152 columns (1.3 % waste) rather than 3 x 128 (22 %), and
// 600, 1200 and 2400 split the same way.

#include "common.cuh"
#include "hopper.cuh"
#include "ln_rows.cuh"

namespace isg {

struct GatherSeg {
  const __nv_bfloat16* a;   // [rows, lda]
  const int* idx;           // [M] or null
  int lda, k;
};

struct GatherArgs {
  GatherSeg s[3];
  int nseg;
  const float* bias;        // [N] or null
  const float* row_scale;   // [M] or null
  const float* emul;        // [M, N] or null
  float* pre;               // [M, N] or null
  void* c;                  // [M, N] at c_dt
  int c_dt, M, N, act;
  int wide;                 // bit s: segment s in 16-byte copies
};

constexpr int GBK = 64;     // one 128-byte swizzle row of bf16
constexpr int GBM = 128;    // block rows: two warpgroups of 64
constexpr int GBN = 152;    // block columns: one m64n152 wgmma
constexpr int GSTAGES = 3;
constexpr int G_A_BYTES = GBM * 128, G_B_BYTES = GBN * 128;
constexpr int G_STAGE = G_A_BYTES + G_B_BYTES;
constexpr int G_PITCH = GBN + 8;                  // floats a staged row
static_assert(G_A_BYTES % 1024 == 0 && G_B_BYTES % 1024 == 0,
              "tiles of whole 8-row swizzle groups");
static_assert(GBM * G_PITCH * 4 <= GSTAGES * G_STAGE, "staging fits the ring");
constexpr int G_SMEM = GSTAGES * G_STAGE + 3 * GBM * 4 + GSTAGES * 8 + 1024;

// One 64-deep slice of A's 128 rows into the swizzled tile at `tile`:
// thread t copies chunk c of rows r0, r0 + STEP, ... (8-byte chunks:
// columns k0 + 4c .., 16-byte: k0 + 8c ..), each landing where TMA's
// 128-byte swizzle would put it (16-byte chunk ^ (row % 8); STEP is a
// multiple of 8, so all of a thread's rows share it).  off[i] is row i's
// element offset in src, negative for a zero row; columns at or past k
// are zero-filled (k is a multiple of the copy's width).
template <bool WIDE>
__device__ __forceinline__ void load_a(uint32_t tile,
                                       const __nv_bfloat16* src,
                                       const int* off, int k0, int k, int t) {
  constexpr int CH = WIDE ? 8 : 16;          // copies a 128-byte row
  constexpr int STEP = 256 / CH;
  const int c = t % CH, r0 = t / CH;
  const int col = k0 + c * (WIDE ? 8 : 4);
  const bool kin = col < k;
  const uint32_t dst =
      tile + r0 * 128 +
      (WIDE ? (uint32_t)((c ^ (r0 & 7)) << 4)
            : (uint32_t)((((c >> 1) ^ (r0 & 7)) << 4) | ((c & 1) << 3)));
#pragma unroll
  for (int i = 0; i < GBM / STEP; ++i) {
    const bool ok = kin && off[i] >= 0;
    cp_async_zfill<WIDE ? 16 : 8>(dst + i * STEP * 128,
                                  ok ? src + off[i] + col : src, ok);
  }
}

// The epilogue from the staged f32 tile: chunks of 4 columns, a warp over
// 128 consecutive columns of a row, so every global access is coalesced.
__device__ __forceinline__ void gather_epilogue(const float* ys,
                                                const GatherArgs& p, int m0,
                                                int n0) {
  for (int idx = threadIdx.x; idx < GBM * GBN / 4; idx += 256) {
    const int r = idx / (GBN / 4), cc = (idx % (GBN / 4)) * 4;
    const int m = m0 + r, n = n0 + cc;
    if (m >= p.M || n >= p.N) continue;         // N % 4 == 0: whole chunks
    const float4 y = *reinterpret_cast<const float4*>(ys + r * G_PITCH + cc);
    float v[4] = {y.x, y.y, y.z, y.w};
    if (p.bias) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] += p.bias[n + e];
    }
    const long off = (long)m * p.N + n;
    if (p.pre) store4(p.pre, 0, off, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (p.act == 1) v[e] = gelu_exact(v[e]);
      else if (p.act == 2) v[e] = fmaxf(v[e], 0.f);
    }
    if (p.emul) {
      const float4 u = *reinterpret_cast<const float4*>(p.emul + off);
      v[0] *= u.x; v[1] *= u.y; v[2] *= u.z; v[3] *= u.w;
    }
    if (p.row_scale) {
      const float s = p.row_scale[m];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] *= s;
    }
    store4(p.c, p.c_dt, off, v);
  }
}

__global__ void __launch_bounds__(256, 2)
gemm_gather_kernel(const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ GatherArgs p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  float* ys = reinterpret_cast<float*>(gbase);
  int* offs = reinterpret_cast<int*>(gbase + GSTAGES * G_STAGE);
  const uint32_t full = base + GSTAGES * G_STAGE + 3 * GBM * 4;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;

  int KT = 0;
  for (int s = 0; s < p.nseg; ++s) KT += (p.s[s].k + GBK - 1) / GBK;
  // each segment's element offset of the block's rows (-1: a zero row)
  for (int i = tid; i < p.nseg * GBM; i += 256) {
    const GatherSeg& g = p.s[i / GBM];
    const int m = m0 + i % GBM;
    const int row = m < p.M ? (g.idx ? g.idx[m] : m) : -1;
    offs[i] = row >= 0 ? row * g.lda : -1;
  }
  if (tid == 0) {
    // every thread's copies, and thread 0's expect_tx for W's bytes
    for (int s = 0; s < GSTAGES; ++s) mbar_init(full + 8 * s, 256 + 1);
    fence_barrier_init();
  }
  __syncthreads();

  // the copy stream: slice ks of segment seg, `next` slices issued
  int seg = 0, ks = 0, koff = 0, next = 0;
  int off[GBM / 16];          // this thread's rows of the segment
  bool wide = false;
  auto enter = [&](int s) {
    wide = (p.wide >> s) & 1;
    const int* so = offs + s * GBM;
    const int r0 = wide ? tid / 8 : tid / 16, step = wide ? 32 : 16;
#pragma unroll
    for (int i = 0; i < GBM / 16; ++i)
      off[i] = i * step + r0 < GBM ? so[i * step + r0] : -1;
  };
  auto issue = [&]() {
    const int st = next % GSTAGES;
    const uint32_t ta = base + st * G_STAGE;
    const GatherSeg& g = p.s[seg];
    if (tid == 0) {
      mbar_expect_tx(full + 8 * st, G_B_BYTES);
      tma_load_2d(ta + G_A_BYTES, &tw, koff + ks * GBK, n0, full + 8 * st);
    }
    if (wide)
      load_a<true>(ta, g.a, off, ks * GBK, g.k, tid);
    else
      load_a<false>(ta, g.a, off, ks * GBK, g.k, tid);
    cp_async_mbar_arrive(full + 8 * st);
    ++next;
    if (++ks * GBK >= g.k) {
      ks = 0;
      koff += (g.k + GBK - 1) / GBK * GBK;
      if (++seg < p.nseg) enter(seg);
    }
  };
  enter(0);
  for (int i = 0; i < GSTAGES - 1 && next < KT; ++i) issue();

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  float acc[GBN / 2];
#pragma unroll
  for (int i = 0; i < GBN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt % GSTAGES;
    mbar_wait(full + 8 * st, (kt / GSTAGES) & 1);
    __syncwarp();                   // wgmma's .aligned forms need the warp whole
    fence_proxy_async();
    const uint32_t a = base + st * G_STAGE + wg * 64 * 128;
    const uint32_t b = base + st * G_STAGE + G_A_BYTES;
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < GBK / 16; ++kk)
      wgmma_m64n152k16(acc, wgmma_desc(a + kk * 32), wgmma_desc(b + kk * 32),
                       1);
    wgmma_commit();
    fence_regs(acc);
    wgmma_wait<1>();                // slice kt - 1's products are done ...
    consumers_sync();               // ... in both warpgroups: refill its stage
    if (next < KT) issue();
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Stage the f32 tile in the ring: every copy has landed (each stage was
  // waited on) and every product is done.  Register 4q + 2i + e holds row
  // 16 warp + g + 8i, column 8q + 2 t4 + e of the warpgroup's 64 x 152.
  consumers_sync();
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int q = 0; q < GBN / 8; ++q)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wg * 64 + warp * 16 + g + 8 * i;
      *reinterpret_cast<float2*>(ys + r * G_PITCH + 8 * q + 2 * t4) =
          make_float2(acc[4 * q + 2 * i], acc[4 * q + 2 * i + 1]);
    }
  consumers_sync();
  gather_epilogue(ys, p, m0, n0);
}

static bool aligned(const void* ptr, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(ptr) & (bytes - 1)) == 0;
}

}  // namespace isg

using namespace isg;

// C [M, N] (c_dt: 0 f32, 1 bf16) = act(sum_s A_s[idx_s] . W[:, cols_s]^T
// + bias) * emul * row_scale; act 0 none, 1 exact GELU, 2 ReLU; idx_s,
// bias, row_scale, emul and pre (f32 [M, N], receives acc + bias) may be
// null.  W [N, ldw] holds segment s's columns from column
// sum_{t<s} ceil(K_t / 64) * 64.  Every K_s, A row pitch and N must be a
// multiple of 4 elements and each A_s 8-byte aligned; W's pitch a
// multiple of 8 elements and W 16-byte aligned (else
// cudaErrorInvalidValue); C, emul and pre have pitch N.
ISG_API int isg_gemm_gather(const void* a0, const int* i0, int lda0, int k0,
                            const void* a1, const int* i1, int lda1, int k1,
                            const void* a2, const int* i2, int lda2, int k2,
                            int nseg, const void* w, int ldw,
                            const float* bias, const float* row_scale,
                            const float* emul, float* pre, void* c, int c_dt,
                            int M, int N, int act, void* stream) {
  GatherArgs p = {};
  const void* as[3] = {a0, a1, a2};
  const int* is[3] = {i0, i1, i2};
  const int ldas[3] = {lda0, lda1, lda2};
  const int ks[3] = {k0, k1, k2};
  if (nseg < 1 || nseg > 3 || M < 0 || N < 1 || N % 4 || ldw % 8 ||
      !aligned(w, 16))
    return (int)cudaErrorInvalidValue;
  int width = 0;                      // W's columns the segments span
  for (int s = 0; s < nseg; ++s) {
    if (ks[s] < 1 || ks[s] % 4 || ldas[s] % 4 || ldas[s] < ks[s] ||
        !aligned(as[s], 8))
      return (int)cudaErrorInvalidValue;
    p.s[s] = GatherSeg{static_cast<const __nv_bfloat16*>(as[s]), is[s],
                       ldas[s], ks[s]};
    if (ks[s] % 8 == 0 && ldas[s] % 8 == 0 && aligned(as[s], 16))
      p.wide |= 1 << s;
    width += s + 1 < nseg ? (ks[s] + GBK - 1) / GBK * GBK : ks[s];
  }
  if (width > ldw) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  p.nseg = nseg;
  p.bias = bias;
  p.row_scale = row_scale;
  p.emul = emul;
  p.pre = pre;
  p.c = c;
  p.c_dt = c_dt;
  p.M = M;
  p.N = N;
  p.act = act;
  CUtensorMap tw;
  int err = tensor_map(w, N, width, ldw, GBN, &tw);
  if (err) return err;
  static bool smem_set = false;     // once: a host call per launch otherwise
  if (!smem_set) {
    err = (int)cudaFuncSetAttribute(
        gemm_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G_SMEM);
    if (err) return err;
    smem_set = true;
  }
  dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  gemm_gather_kernel<<<grid, 256, G_SMEM, static_cast<cudaStream_t>(stream)>>>(
      tw, p);
  return (int)cudaGetLastError();
}
