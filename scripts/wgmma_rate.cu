// The tensor-core rate of wgmma m64nNk16 (bf16, both operands from shared
// memory, K-major) for N = 128, 152 and 256, in the pattern of the staged
// backward GEMM (isubgvqa_tpu_torch/csrc/gemm_bwd.cu): chains of twelve on
// one accumulator per warpgroup, wait_group 0 after each chain (res[0..2])
// or wait_group 1 (res[3..5]), two warpgroups a block, one block on each
// of the 132 SMs, zero operands.  Built and run by scripts/gemm_bwd_lab.py;
// wgbench(res, iters) writes six times in ms.
#include "common.cuh"
#include "hopper.cuh"
using namespace isg;

template <int N>
__device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b);
template <> __device__ __forceinline__ void mma<128>(float* d, uint64_t a, uint64_t b) {
  wgmma_m64n128k16(*reinterpret_cast<float(*)[64]>(d), a, b, 1);
}
template <> __device__ __forceinline__ void mma<152>(float* d, uint64_t a, uint64_t b) {
  wgmma_m64n152k16<0>(*reinterpret_cast<float(*)[76]>(d), a, b, 1);
}
template <> __device__ __forceinline__ void mma<256>(float* d, uint64_t a, uint64_t b) {
  wgmma_m64n256k16(*reinterpret_cast<float(*)[128]>(d), a, b, 1);
}

template <int N, int CHAIN, int WAIT>
__global__ void __launch_bounds__(256, 1) bench(int iters, float* out) {
  extern __shared__ uint8_t sm[];
  const uint32_t base = (smem_u32(sm) + 1023u) & ~1023u;
  uint8_t* g = sm + (base - smem_u32(sm));
  for (int i = threadIdx.x; i < 48 * 1024 / 4; i += 256) reinterpret_cast<float*>(g)[i] = 0.f;
  __syncthreads();
  fence_proxy_async();
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const int wg = threadIdx.x / 128;
  const uint32_t a = base + wg * 8192, b = base + 16384;
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int c = 0; c < CHAIN; ++c) mma<N>(acc, wgmma_desc(a + (c & 3) * 32), wgmma_desc(b + (c & 3) * 32));
    wgmma_commit();
    fence_regs(acc);
    if (WAIT) { wgmma_wait<0>(); fence_regs(acc); }
    else wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s += acc[i];
  if (s == 12345.f) out[threadIdx.x] = s;
}

template <int N, int CHAIN, int WAIT>
static float run(int blocks, int iters) {
  const int smem = 48 * 1024 + 1024;
  cudaFuncSetAttribute(bench<N, CHAIN, WAIT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  float* out; cudaMalloc(&out, 4096);
  bench<N, CHAIN, WAIT><<<blocks, 256, smem>>>(10, out);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaEventRecord(e0);
  bench<N, CHAIN, WAIT><<<blocks, 256, smem>>>(iters, out);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  cudaFree(out);
  return ms;
}

ISG_API int wgbench(float* res, int iters) {
  res[0] = run<128, 12, 1>(132, iters);
  res[1] = run<152, 12, 1>(132, iters);
  res[2] = run<256, 12, 1>(132, iters);
  res[3] = run<128, 12, 0>(132, iters);
  res[4] = run<152, 12, 0>(132, iters);
  res[5] = run<256, 12, 0>(132, iters);
  return (int)cudaGetLastError();
}
