// Shared device helpers for the port's kernels: typed loads/stores with an
// fp32 compute type, and deterministic block reductions (a fixed butterfly
// inside each warp, then warp 0 over the per-warp partials), so a kernel
// gives the same bits on every run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace repro_torch {

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store_from_f32(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max or sum; every thread gets the result.  blockDim.x must be
// a multiple of 32.  ``red`` is 32 floats of shared memory, free again on
// return.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const float identity = kMax ? -INFINITY : 0.f;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < n_warps ? red[lane] : identity;
    x = kMax ? warp_max(x) : warp_sum(x);
    if (lane == 0) red[0] = x;
  }
  __syncthreads();
  const float r = red[0];
  __syncthreads();
  return r;
}

}  // namespace repro_torch
