// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel works on two element types: float (f32 models) and
// __nv_bfloat16 (bf16 models).  A dtype code crosses the C interface
// as an int: 0 = float32, 1 = bfloat16.  All sums are taken in f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ISG_API extern "C" __attribute__((visibility("default")))

namespace isg {

constexpr float kNeg = -1.0e30f;   // the JAX kernels' masked-logit value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded through T and back: the "ship at the model dtype" step of
// the Pallas kernels (a no-op for float).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// exact (erf) GELU, the flax nn.gelu(approximate=False) numerics
__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A graph's edges grouped by key, a stable counting sort in shared
// memory.  key(e) is edge e's group in [0, nkeys), or negative to leave
// the edge out.  On return (after a __syncthreads) off[k] .. off[k + 1] -
// 1 index the edges of group k in lst, in edge order; cur (nkeys ints) is
// scratch.  The counts do not depend on the order of their shared-memory
// atomics, and one warp fills lst 32 edges at a time, ranking the edges of
// a group within the 32 with __match_any_sync: the same lists on every
// run.  Called by every thread of the block, with nkeys <= 32 * 64.
template <typename Key>
__device__ __forceinline__ void group_edges(int E, int nkeys, Key key,
                                            int* off, int* cur, int* lst) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid % 32;
  for (int k = tid; k < nkeys; k += nt) cur[k] = 0;
  __syncthreads();
  for (int e = tid; e < E; e += nt) {
    const int k = key(e);
    if (k >= 0) atomicAdd(&cur[k], 1);
  }
  __syncthreads();
  if (tid < 32) {
    // exclusive scan of the counts, each lane over a run of keys
    const int per = (nkeys + 31) / 32, k0 = min(nkeys, lane * per);
    const int k1 = min(nkeys, k0 + per);
    int s = 0;
    for (int k = k0; k < k1; ++k) s += cur[k];
    int incl = s;
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    int run = incl - s;
    for (int k = k0; k < k1; ++k) {
      const int c = cur[k];
      off[k] = cur[k] = run;
      run += c;
    }
    if (lane == 31) off[nkeys] = incl;
    __syncwarp();
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      const int k = e < E ? key(e) : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, k);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      if (k >= 0) lst[cur[k] + rank] = e;
      __syncwarp();
      if (k >= 0 && rank == 0) cur[k] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
}

// Raise a kernel's dynamic shared-memory cap when it needs more than the
// default 48 KB (Hopper allows up to 227 KB per block).
template <typename K>
inline void allow_smem(K kernel, size_t bytes) {
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
}

}  // namespace isg

// Run the statement list with T bound to the element type of `code`.
#define ISG_WITH_T(code, T, ...)          \
  do {                                    \
    if ((code) == 0) {                    \
      using T = float;                    \
      __VA_ARGS__;                        \
    } else {                              \
      using T = __nv_bfloat16;            \
      __VA_ARGS__;                        \
    }                                     \
  } while (0)
