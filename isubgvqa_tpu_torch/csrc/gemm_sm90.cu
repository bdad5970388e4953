// Hopper GEMM for dense bf16 operands: wgmma fed by TMA.
//
//   C[m, n] = act(A[m, :] . W[n, :] + bias[n]) * emul[m, n]     (isg_gemm_sm90)
//   LN2?(LN1(x + (A . W^T + bias) * ymask))                     (isg_gemm_ln_sm90)
//
// A [M, K] and W [N, K] (a torch Linear weight) are bf16, row-major and
// ungathered.  They take the bf16 products of the question stack's layers
// (the Pallas kernels isubgvqa_tpu/ops/pallas/text_kernel.py:
// fused_encoder_layer and fused_decoder_layer), which gemm.cu's generic
// cp.async GEMM ran at ~15 % of the card's bf16 peak.
//
// Bound: at the question stack's shapes (M = B * L up to 16,384 rows,
// K and N of 512 to 2048) the products are operation-bound; bytes bound
// the LayerNorm epilogue.  Per block:
// * one producer thread issues TMA loads of 64-deep K slices of A and W
//   (128-byte swizzle) into a 3-stage ring in shared memory, each stage's
//   arrival signalled on its own mbarrier;
// * two consumer warpgroups run wgmma m64nNk16 on the stages that have
//   landed, f32 sums in registers, and hand a stage back (a second
//   mbarrier) once the wgmma that read it has completed, so the next
//   stages' loads overlap the products on this one;
// * the epilogue stages the f32 tile in the idle ring and writes C with
//   coalesced 16-byte accesses; the ragged M and N edges come from TMA's
//   zero fill and clipped stores.
//
// Tiles.  The plain form: 128 x 128 a block, each consumer warpgroup
// 64 x 128, two blocks an SM (one block's epilogue overlaps the other's
// products; measured on an H100 faster than 128 x 256 at one block an SM,
// than a persistent 2-stage form and than multicasting W across a
// cluster).  The LayerNorm form owns whole rows of N <= 512: 64 x 512 a
// block, each warpgroup 64 x 256 of the same rows, one block an SM (the
// producer's warpgroup hands its registers to the consumers).  Its
// epilogue is ln_rows.cuh's, the same rows code as the separate pass
// text_kernel.cu:isg_residual_ln: x + (y + bias) * ymask in f32, flax's
// fast variance max(E[v^2] - E[v]^2, 0) + eps, optionally the stack's
// final LayerNorm after it, the f32 pre-LN sum (z_out, for the training
// backward), the f32 result and its copy at the model dtype.  The f32
// product never goes through device memory, and a LayerNorm costs no
// launch of its own.
//
// Tensor maps are built on the host with cuTensorMapEncodeTiled (reached
// through the runtime's driver entry point, no -lcuda) and cached by
// (pointer, shape, pitch, box): a map depends on nothing else, so a cached
// map is right whatever tensor now lives at that address.

#include <array>
#include <map>
#include <mutex>

#include "common.cuh"
#include "hopper.cuh"
#include "ln_rows.cuh"

namespace isg {

constexpr int BK = 64;            // one 128-byte swizzle row of bf16

// The LayerNorm form's fields are LnRows' (ln_rows.cuh); bias is both
// forms'.
struct Sm90Args : LnRows {
  const float* emul;              // plain form: [M, N] f32 or null
  void* c;                        // plain form: [M, N] at c_dt
  int c_dt, act;
  int K;
};

// kTwo: two blocks per SM (288 threads, no register hand-over), else one
// (384 threads: the producer's warpgroup gives its registers to the
// consumers, whose 64 x 256 accumulators take 128 a thread).
template <int WG_M, int WN, int STAGES, bool kTwo>
struct Sm90Tile {
  static constexpr int BM = 64 * WG_M;             // block rows
  static constexpr int BN = WN * (2 / WG_M);       // block columns
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int WBOX = BN < 256 ? BN : 256; // W rows a TMA box
  static constexpr int THREADS = kTwo ? 288 : 384;
  // the epilogue stages the block's f32 tile in the (then idle) ring
  static constexpr int PITCH = BN + 8;             // floats a staged row
  static_assert(BM * PITCH * 4 <= STAGES * STAGE, "staging fits the ring");
  // ring, full + empty barriers, alignment
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");   // warps 0-7
}

// Plain epilogue from the staged tile: the 256 consumer threads walk it in
// chunks of 4 columns, a warp over 128 consecutive columns of a row, so
// every global access (bias, emul, C) is coalesced.
template <int BM, int BN, int PITCH>
__device__ __forceinline__ void epilogue_plain(const float* ys,
                                               const Sm90Args& p, int m0,
                                               int n0) {
  for (int idx = threadIdx.x; idx < BM * BN / 4; idx += 256) {
    const int r = idx / (BN / 4), cc = (idx % (BN / 4)) * 4;
    const int m = m0 + r, n = n0 + cc;
    if (m >= p.M || n >= p.N) continue;
    const float4 a = *reinterpret_cast<const float4*>(ys + r * PITCH + cc);
    float v[4] = {a.x, a.y, a.z, a.w};
    if (p.bias) {
      const float4 b = *reinterpret_cast<const float4*>(p.bias + n);
      v[0] += b.x; v[1] += b.y; v[2] += b.z; v[3] += b.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (p.act == 2) v[e] = fmaxf(v[e], 0.f);
      else if (p.act == 1) v[e] = gelu_exact(v[e]);
    }
    const long off = (long)m * p.N + n;
    if (p.emul) {
      const float4 e = *reinterpret_cast<const float4*>(p.emul + off);
      v[0] *= e.x; v[1] *= e.y; v[2] *= e.z; v[3] *= e.w;
    }
    store4(p.c, p.c_dt, off, v);
  }
}

// LN: the LayerNorm epilogue (64 x 512 blocks), else the plain one.
template <int WG_M, int WN, int STAGES, bool LN, bool kTwo>
__global__ void __launch_bounds__(kTwo ? 288 : 384, kTwo ? 2 : 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tw, Sm90Args p) {
  using Tl = Sm90Tile<WG_M, WN, STAGES, kTwo>;
  static_assert(!LN || (WG_M == 1 && WN == 256), "LN form: 64 x 512");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* ys = reinterpret_cast<float*>(smem_raw + (base - raw));
  const uint32_t full = base + STAGES * Tl::STAGE;   // STAGES barriers
  const uint32_t empty = full + STAGES * 8;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * Tl::BM, n0 = blockIdx.x * Tl::BN;
  const int KT = (p.K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);                 // one per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // ---------------------------------------------------------- producer
    if constexpr (!kTwo) setmaxnreg_dec<40>();
    if (tid == 256) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(empty + 8 * s, ((kt / STAGES) & 1) ^ 1);
        const uint32_t st = base + s * Tl::STAGE, bar = full + 8 * s;
        mbar_expect_tx(bar, Tl::STAGE);
        tma_load_2d(st, &ta, kt * BK, m0, bar);
#pragma unroll
        for (int i = 0; i < Tl::BN / Tl::WBOX; ++i)
          tma_load_2d(st + Tl::A_BYTES + i * Tl::WBOX * 128, &tw, kt * BK,
                      n0 + i * Tl::WBOX, bar);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (!kTwo) setmaxnreg_inc<232>();
    const int c = tid / 128;
    const int wm = WG_M == 2 ? c : 0, wn = WG_M == 2 ? 0 : c;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    float acc[WN / 2];
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full + 8 * s, (kt / STAGES) & 1);
      const uint32_t a = base + s * Tl::STAGE + wm * 64 * 128;
      const uint32_t b = base + s * Tl::STAGE + Tl::A_BYTES + wn * WN * 128;
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if constexpr (WN == 256)
          wgmma_m64n256k16(acc, wgmma_desc(a + kk * 32),
                           wgmma_desc(b + kk * 32), 1);
        else
          wgmma_m64n128k16(acc, wgmma_desc(a + kk * 32),
                           wgmma_desc(b + kk * 32), 1);
      }
      wgmma_commit();
      fence_regs(acc);
      wgmma_wait<1>();              // the previous stage's products are done
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // Stage the f32 tile in the ring, which both warpgroups are done
    // reading (and TMA writing: all KT loads have landed).  Register
    // 4j + 2i + e holds row 16 warp + g + 8i, column 8j + 2 t4 + e of the
    // warpgroup's 64 x WN tile.
    consumers_sync();
    const int g = lane / 4, t4 = lane % 4;
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm * 64 + warp * 16 + g + 8 * i;
        const int col = wn * WN + 8 * j + 2 * t4;
        *reinterpret_cast<float2*>(ys + r * Tl::PITCH + col) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    consumers_sync();
    if constexpr (LN)
      ln_rows<8, 4>(ys, Tl::PITCH, p, m0);
    else
      epilogue_plain<Tl::BM, Tl::BN, Tl::PITCH>(ys, p, m0, n0);
  }
}

// ------------------------------------------------------------ host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

static EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault);
#endif
    fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// The map of a row-major bf16 [rows, cols] matrix of row pitch `ld`
// elements, read in boxes of box_rows x 64 with the 128-byte swizzle.
static int tensor_map(const void* ptr, int rows, int cols, int ld,
                      int box_rows, CUtensorMap* out) {
  static std::mutex mu;
  static std::map<std::array<uint64_t, 5>, CUtensorMap> cache;
  const std::array<uint64_t, 5> key = {reinterpret_cast<uint64_t>(ptr),
                                       (uint64_t)rows, (uint64_t)cols,
                                       (uint64_t)ld, (uint64_t)box_rows};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return 0;
  }
  EncodeTiled enc = encode_fn();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache[key] = *out;
  return 0;
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int WG_M, int WN, int STAGES, bool LN, bool kTwo>
static int launch_sm90(const void* a, int lda, const void* w, int ldw,
                       const Sm90Args& args, cudaStream_t st) {
  using Tl = Sm90Tile<WG_M, WN, STAGES, kTwo>;
  if (args.K % 8 || args.N % 8 || lda % 8 || ldw % 8 || !aligned16(a) ||
      !aligned16(w) || args.M < 1 || args.N < 1 || args.K < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tw;
  int err = tensor_map(a, args.M, args.K, lda, Tl::BM, &ta);
  if (!err) err = tensor_map(w, args.N, args.K, ldw, Tl::WBOX, &tw);
  if (err) return err;
  auto kernel = gemm_sm90_kernel<WG_M, WN, STAGES, LN, kTwo>;
  static bool smem_set = false;     // once per kernel: a host call per launch
  if (!smem_set) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
    if (err) return err;
    smem_set = true;
  }
  dim3 grid((args.N + Tl::BN - 1) / Tl::BN, (args.M + Tl::BM - 1) / Tl::BM);
  kernel<<<grid, Tl::THREADS, Tl::SMEM, st>>>(ta, tw, args);
  return (int)cudaGetLastError();
}

}  // namespace isg

using namespace isg;

// C [M, N] (at c_dt: 0 f32, 1 bf16) = act(A [M, K] . W [N, K]^T + bias)
// * emul; act 0 none, 1 exact GELU, 2 ReLU; bias and emul (f32) may be
// null.  K, N and both row pitches must be multiples of 8 elements and A
// and W 16-byte aligned; C is written with pitch N.
ISG_API int isg_gemm_sm90(const void* a, int lda, const void* w, int ldw,
                          const float* bias, const float* emul, void* c,
                          int c_dt, int M, int N, int K, int act,
                          void* stream) {
  Sm90Args p = {};
  p.bias = bias;
  p.emul = emul;
  p.c = c;
  p.c_dt = c_dt;
  p.act = act;
  p.M = M;
  p.N = N;
  p.K = K;
  return launch_sm90<2, 128, 3, false, true>(
      a, lda, w, ldw, p, static_cast<cudaStream_t>(stream));
}

// out = LN2?(LN1(x + (A . W^T + bias) * ymask)) over rows of N <= 512
// columns; x [M, N] at x_dt, ymask, z_out (the pre-LN sum), g2 / b2,
// out_f (f32) and out_t (at t_dt) may be null except x, bias, g1, b1.
ISG_API int isg_gemm_ln_sm90(const void* a, int lda, const void* w, int ldw,
                             const float* bias, const void* x, int x_dt,
                             const float* ymask, const float* g1,
                             const float* b1, const float* g2,
                             const float* b2, float* z_out, float* out_f,
                             void* out_t, int t_dt, int M, int N, int K,
                             float eps, void* stream) {
  if (N > 512 || !bias || !x || !g1 || !b1) return (int)cudaErrorInvalidValue;
  Sm90Args p = {};
  p.bias = bias;
  p.x = x;
  p.x_dt = x_dt;
  p.ymask = ymask;
  p.g1 = g1;
  p.b1 = b1;
  p.g2 = g2;
  p.b2 = b2;
  p.z_out = z_out;
  p.out_f = out_f;
  p.out_t = out_t;
  p.t_dt = t_dt;
  p.eps = eps;
  p.M = M;
  p.N = N;
  p.K = K;
  return launch_sm90<1, 256, 3, true, false>(
      a, lda, w, ldw, p, static_cast<cudaStream_t>(stream));
}
