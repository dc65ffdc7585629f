// K1 and K2: the DS-FL server's "4. Aggregation" (paper Eq. 13) on Hopper.
//
// Replaces the TPU kernels in src/repro/kernels/era_sharpen.py:
//   K1  era_sharpen_pallas / _kernel           softmax((sum_k p_k) * (1/K) / T)
//   K2  weighted_era_sharpen_pallas / _weighted_kernel
//                                              softmax(sum_k w_k p_k / T), or the
//                                              weighted mean itself (sharpen=0)
//
// What bounds it: bytes.  Each output row reads K rows of C probabilities
// once and writes C floats; the work is K adds (or multiply-adds) and one
// exp per output value, far below the card's compute rate.
//
// Design: one block per output row n.  Threads stride over the class axis,
// so the K loads of one class column are coalesced across the warp; each
// thread accumulates its columns over k = 0..K-1 in fp32, in order, and
// keeps the row's aggregate in shared memory (C whole, as the TPU kernel
// keeps it whole in VMEM).  A block max-reduce and a block sum of exp then
// give the softmax, and the row is written once.  No row is padded: the
// grid has exactly N blocks.  The ragged class tail is masked by the loop.
//
// Zero-weight clients (K2): each term is w_k * p_k with w_k an exact 0.0,
// so a client of weight 0 adds +-0.0 to the sum whatever its (finite) rows
// hold, and the output bits equal those without it.
#include "common.cuh"

namespace {

using repro_torch::block_reduce;
using repro_torch::load_f32;

template <typename T, bool kWeighted>
__global__ void era_sharpen_kernel(const T* __restrict__ p, const float* __restrict__ w,
                                   float* __restrict__ out, int K, int N, int C, float scale,
                                   float inv_temp, int sharpen) {
  extern __shared__ float agg[];  // (C,) this row's aggregate, then its exp
  __shared__ float red[32];
  const size_t row = static_cast<size_t>(blockIdx.x) * C;
  const size_t k_stride = static_cast<size_t>(N) * C;
  float local_max = -INFINITY;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      const float v = load_f32(p, k * k_stride + row + c);
      if (kWeighted) {
        acc += w[k] * v;
      } else {
        acc += v;
      }
    }
    float x = kWeighted ? acc : acc * scale;
    if (sharpen) x *= inv_temp;
    agg[c] = x;
    local_max = fmaxf(local_max, x);
  }
  if (!sharpen) {  // uniform over the block: no thread reaches a barrier
    for (int c = threadIdx.x; c < C; c += blockDim.x) out[row + c] = agg[c];
    return;
  }
  const float m = block_reduce<true>(local_max, red);
  float local_sum = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float e = expf(agg[c] - m);
    agg[c] = e;
    local_sum += e;
  }
  const float total = block_reduce<false>(local_sum, red);
  for (int c = threadIdx.x; c < C; c += blockDim.x) out[row + c] = agg[c] / total;
}

int threads_for(int C) {
  const int t = ((C + 31) / 32) * 32;
  return t < 256 ? t : 256;
}

template <typename T, bool kWeighted>
int launch(const void* p, const void* w, void* out, int K, int N, int C, float scale,
           float inv_temp, int sharpen, void* stream) {
  auto kernel = era_sharpen_kernel<T, kWeighted>;
  const size_t smem = static_cast<size_t>(C) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<N, threads_for(C), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p), static_cast<const float*>(w), static_cast<float*>(out), K, N,
      C, scale, inv_temp, sharpen);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1.  p: (K, N, C) float32 (dtype 0) or bfloat16 (dtype 1), contiguous;
// out: (N, C) float32.  Returns cudaGetLastError() after the launch.
int era_sharpen(const void* p, void* out, int K, int N, int C, int dtype, float scale,
                float inv_temp, void* stream) {
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(p, nullptr, out, K, N, C, scale, inv_temp, 1, stream);
  return launch<float, false>(p, nullptr, out, K, N, C, scale, inv_temp, 1, stream);
}

// K2.  As K1, with w: (K,) float32 normalized weights; sharpen=0 returns
// the weighted mean itself.
int weighted_era_sharpen(const void* p, const void* w, void* out, int K, int N, int C,
                         int dtype, float inv_temp, int sharpen, void* stream) {
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(p, w, out, K, N, C, 1.f, inv_temp, sharpen, stream);
  return launch<float, true>(p, w, out, K, N, C, 1.f, inv_temp, sharpen, stream);
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
