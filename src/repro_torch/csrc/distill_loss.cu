// K3 and K4: the fused distillation cross-entropy CE(t || softmax(z)) and
// its gradient, on Hopper.
//
// Replaces the TPU kernels in src/repro/kernels/distill_loss.py:
//   K3  distill_loss_fwd_pallas / _fwd_kernel   per row: logZ = logsumexp(z),
//                                               loss = tmass * logZ - sum t*z
//   K4  distill_loss_bwd_pallas / _bwd_kernel   dz = g/N * (exp(z - logZ) * tmass - t)
//
// What bounds them: bytes.  K3 reads z and t once and writes two floats per
// row; K4 reads z and t once and writes dz.  Both do a handful of flops and
// one exp per element, far below the card's compute rate.
//
// Design.  K3: one block per row.  Threads stride over the vocabulary, so
// loads are coalesced, and each keeps a running max and sum of exp (one exp
// per element: the sum is rescaled only when the max grows), the teacher
// dot and the teacher mass in fp32 registers.  The (max, sum) pairs are
// then combined across the block in a fixed order, so the softmax is never
// written to device memory: the TPU kernel's vocab-tile loop over VMEM
// scratch becomes a loop inside the block.  Tails need no padding: a thread
// with no element keeps (max -inf, sum 0), which the combine skips.
// K4: one elementwise pass in a grid-stride loop over N*V, reading the row's
// logZ and tmass and the scale g/N from device memory (no host sync).
#include "common.cuh"

namespace {

using repro_torch::block_reduce;
using repro_torch::load_f32;
using repro_torch::store_from_f32;

// Combine two online-softmax states (m, l): l is the sum of exp(x - m).
// A state with l == 0 holds no element (m is -inf) and adds nothing.
__device__ __forceinline__ void lse_combine(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  const float a = l == 0.f ? 0.f : l * expf(m - mn);
  const float b = l2 == 0.f ? 0.f : l2 * expf(m2 - mn);
  m = mn;
  l = a + b;
}

template <typename T>
__global__ void distill_fwd_kernel(const T* __restrict__ z, const T* __restrict__ t,
                                   float* __restrict__ loss, float* __restrict__ logz, int V) {
  __shared__ float red_m[32];
  __shared__ float red_l[32];
  __shared__ float red[32];
  const size_t row = static_cast<size_t>(blockIdx.x) * V;
  float m = -INFINITY, l = 0.f, td = 0.f, tm = 0.f;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    const float zv = load_f32(z, row + v);
    const float tv = load_f32(t, row + v);
    if (zv > m) {
      l = l * expf(m - zv) + 1.f;
      m = zv;
    } else {
      l += expf(zv - m);
    }
    td += tv * zv;
    tm += tv;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    lse_combine(m, l, m2, l2);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_m[warp] = m;
    red_l[warp] = l;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    m = lane < n_warps ? red_m[lane] : -INFINITY;
    l = lane < n_warps ? red_l[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
      lse_combine(m, l, m2, l2);
    }
  }
  td = block_reduce<false>(td, red);
  tm = block_reduce<false>(tm, red);
  if (threadIdx.x == 0) {
    const float lz = m + logf(l);
    loss[blockIdx.x] = tm * lz - td;
    logz[blockIdx.x] = lz;
  }
}

template <typename T>
__global__ void distill_bwd_kernel(const T* __restrict__ z, const T* __restrict__ t,
                                   const float* __restrict__ logz,
                                   const float* __restrict__ tmass,
                                   const float* __restrict__ gscale, T* __restrict__ dz,
                                   size_t total, int V) {
  const float g = gscale[0];
  const size_t step = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += step) {
    const size_t n = i / V;
    const float p = expf(load_f32(z, i) - logz[n]);
    store_from_f32(dz, i, g * (p * tmass[n] - load_f32(t, i)));
  }
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

// K3.  z, t: (N, V) float32 (dtype 0) or bfloat16 (dtype 1), contiguous;
// loss, logz: (N,) float32.  Returns cudaGetLastError() after the launch.
int distill_loss_fwd(const void* z, const void* t, void* loss, void* logz, int N, int V,
                     int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    distill_fwd_kernel<__nv_bfloat16><<<N, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(z), static_cast<const __nv_bfloat16*>(t),
        static_cast<float*>(loss), static_cast<float*>(logz), V);
  } else {
    distill_fwd_kernel<float><<<N, kThreads, 0, s>>>(
        static_cast<const float*>(z), static_cast<const float*>(t), static_cast<float*>(loss),
        static_cast<float*>(logz), V);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4.  z, t, dz: (N, V) in z's dtype; logz, tmass: (N,) float32; gscale:
// (1,) float32 on the device.
int distill_loss_bwd(const void* z, const void* t, const void* logz, const void* tmass,
                     const void* gscale, void* dz, int N, int V, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const size_t total = static_cast<size_t>(N) * V;
  size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 blocks per SM
  if (blocks == 0) blocks = 1;
  if (dtype == 1) {
    distill_bwd_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(z), static_cast<const __nv_bfloat16*>(t),
        static_cast<const float*>(logz), static_cast<const float*>(tmass),
        static_cast<const float*>(gscale), static_cast<__nv_bfloat16*>(dz), total, V);
  } else {
    distill_bwd_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(z), static_cast<const float*>(t),
        static_cast<const float*>(logz), static_cast<const float*>(tmass),
        static_cast<const float*>(gscale), static_cast<float*>(dz), total, V);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
