// K1 and K2: the DS-FL server's "4. Aggregation" (paper Eq. 13) on Hopper.
//
// Replaces the TPU kernels in src/repro/kernels/era_sharpen.py:
//   K1  era_sharpen_pallas (:68) / _kernel      softmax((sum_k p_k) * (1/K) / T)
//   K2  weighted_era_sharpen_pallas (:113) / _weighted_kernel
//                                              softmax(sum_k w_k p_k / T), or the
//                                              weighted mean itself (sharpen=0)
//
// What bounds it: bytes.  The call reads K*N*C probabilities once and writes
// N*C floats; the work is one add (K1) or one multiply and one add (K2) per
// value read and one exp per value written, far below the card's compute
// rate.  At the DS-FL round's (100, 1000, 10) f32 that is 4 MB in 1.2 us at
// 3.35 TB/s: about the latency of one trip to device memory, so the call is
// as fast as the bytes it keeps in flight.
//
// Design (the plan comes from kernels/era_sharpen.launch_plan):
//  - A block owns R consecutive output rows.  For each client k those rows
//    are one contiguous span of R*C values, so the block's input is K spans.
//  - Threads own vectors of V consecutive values of the tile (16 bytes where
//    the pointer, N*C and R*C allow it, else 8, 4 or one element), not class
//    columns of one row, so every lane loads.  Where the tile has fewer
//    vectors than threads, k is split into S contiguous slices
//    [s*K/S, (s+1)*K/S), one group of threads per slice.
//  - A thread issues up to kUnroll loads at once (its slice's clients, and
//    its next vectors where the slice is short) before it adds any of them,
//    so the whole tile (16 KB at the round's shape) is in flight together:
//    the block waits for one trip's latency, not one trip after another.
//    Plain vector loads into registers do this without a copy through
//    shared memory, and four of them (64 bytes) keep a thread near 40
//    registers, so enough blocks fit each SM where the grid has several
//    waves.
//  - The sum's order, fixed and the same on every run: each slice sums its
//    clients in order k = k0, k0+1, ... in fp32, each term rounded as
//    w_k * p_k (K2) or p_k (K1) before it is added, starting from +0; the
//    slices' partials (shared memory, (S, R*C) floats) are then added in
//    order s = 0, 1, ..., S-1; K1 then multiplies by 1/K, and with sharpen
//    both multiply by 1/T.
//  - Zero-weight clients (K2): a term w_k * p_k with w_k an exact 0.0 is
//    +-0.0 for any finite row, and adding it to a sum started at +0 leaves
//    every bit as it was, so a client of weight 0 changes no output bit.
//    Its loads are not skipped: a non-finite row gives NaN, as in the
//    reference.
//  - The slices' partials wait in shared memory; each output value is then
//    added up (its slices in order), scaled and, with sharpen, taken
//    through its row's softmax by one thread, which writes it once: with
//    R > 1, L lanes a row (the power of two >= C, at most 32) and shuffle
//    reductions; with one row a block, the whole block on it (C up to the
//    shared memory).
#include "common.cuh"

namespace {

using repro_torch::block_reduce;

constexpr int kUnroll = 4;        // loads a thread has in flight (era_sharpen.UNROLL)
constexpr int kMaxThreads = 512;  // kernels/era_sharpen.MAX_THREADS

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Max or sum over each aligned group of L lanes (L a power of two <= 32);
// every lane of the warp takes part.
template <bool kMax>
__device__ __forceinline__ float group_reduce(float v, int L) {
  for (int o = L >> 1; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, u) : v + u;
  }
  return v;
}

template <typename T, int V, bool kWeighted>
__global__ void __launch_bounds__(kMaxThreads)
    era_sharpen_kernel(const T* __restrict__ p, const float* __restrict__ w,
                       float* __restrict__ out, int K, int N, int C, int R, int S, int Gt,
                       float scale, float inv_temp, int sharpen) {
  extern __shared__ __align__(16) float part[];  // (S, R*C) partials; row 0 the aggregate
  __shared__ float red[32];
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * R;
  const int rows = min(R, N - n0);
  const int W = R * C;       // stride of the partials
  const int Wh = rows * C;   // this tile's values (a multiple of V by the plan)
  const size_t k_stride = static_cast<size_t>(N) * C;
  const T* tile = p + static_cast<size_t>(n0) * C;
  float* dst = out + static_cast<size_t>(n0) * C;

  // 1. each slice's sum over its clients, V values at a time.  A thread's
  // work is the sequence of (vector g, client k) items, g-major: its vectors
  // g = g0, g0 + Gt, ... each with the slice's clients in order.  It loads
  // kUnroll items at once (across vectors where the slice is short), then
  // adds them in that order, storing a vector's sum after its last client.
  if (t < S * Gt) {
    const int s = t / Gt, g0 = t - s * Gt;
    const int k0 = static_cast<int>(static_cast<long long>(s) * K / S);
    const int nk = static_cast<int>(static_cast<long long>(s + 1) * K / S) - k0;
    const int Gh = Wh / V;
    const int items = g0 < Gh ? (Gh - g0 + Gt - 1) / Gt * nk : 0;
    const T* src0 = tile + static_cast<size_t>(k0) * k_stride + static_cast<size_t>(g0) * V;
    float* dst0 = part + s * W + g0 * V;
    float acc[V];
    int gi = 0, kr = 0;  // the chunk's first item: vector g0 + gi*Gt, client k0 + kr
    for (int i0 = 0; i0 < items; i0 += kUnroll) {
      Vec<T, V> buf[kUnroll];
      int g = gi, k = kr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i0 + u < items)
          buf[u] = *reinterpret_cast<const Vec<T, V>*>(
              src0 + static_cast<size_t>(k) * k_stride + static_cast<size_t>(g) * Gt * V);
        if (++k == nk) k = 0, ++g;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i0 + u < items) {
          if (kr == 0) {
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = 0.f;
          }
          const float wk = kWeighted ? __ldg(w + k0 + kr) : 1.f;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float x = to_f32(buf[u].v[v]);
            acc[v] = __fadd_rn(acc[v], kWeighted ? __fmul_rn(wk, x) : x);
          }
          if (kr == nk - 1) {
            constexpr int VS = V < 4 ? V : 4;  // stores of at most 16 bytes
#pragma unroll
            for (int v0 = 0; v0 < V; v0 += VS) {
              Vec<float, VS> st;
#pragma unroll
              for (int v = 0; v < VS; ++v) st.v[v] = acc[v0 + v];
              *reinterpret_cast<Vec<float, VS>*>(dst0 + gi * Gt * V + v0) = st;
            }
          }
        }
        if (++kr == nk) kr = 0, ++gi;
      }
    }
  }
  __syncthreads();

  // 2. each value's slices added in order, then the scales; with sharpen,
  // the softmax of its row; every output value written once
  auto combine = [&](int j) {
    float x = part[j];
    for (int s = 1; s < S; ++s) x = __fadd_rn(x, part[s * W + j]);
    if (!kWeighted) x *= scale;
    if (sharpen) x *= inv_temp;
    return x;
  };
  if (!sharpen) {  // the weighted mean itself
    for (int j = t; j < Wh; j += blockDim.x) dst[j] = combine(j);
    return;
  }
  if (R == 1) {  // the whole block on one row; a thread keeps to its own c
    float lm = -INFINITY;
    for (int c = t; c < C; c += blockDim.x) {
      const float x = combine(c);
      part[c] = x;
      lm = fmaxf(lm, x);
    }
    const float m = block_reduce<true>(lm, red);
    float ls = 0.f;
    for (int c = t; c < C; c += blockDim.x) {
      const float e = expf(part[c] - m);
      part[c] = e;
      ls += e;
    }
    const float total = block_reduce<false>(ls, red);
    for (int c = t; c < C; c += blockDim.x) dst[c] = part[c] / total;
  } else {  // L lanes a row, 32/L rows a warp
    int L = 1;
    while (L < C && L < 32) L <<= 1;
    const int rpw = 32 / L, lane = t & 31, li = lane & (L - 1);
    const int step = (blockDim.x >> 5) * rpw;
    for (int rb = (t >> 5) * rpw; rb < R; rb += step) {  // uniform over the warp
      const int r = rb + lane / L;
      const bool live = r < rows;
      float* row = part + r * C;
      float lm = -INFINITY;
      if (live)
        for (int c = li; c < C; c += L) {
          const float x = combine(r * C + c);
          row[c] = x;
          lm = fmaxf(lm, x);
        }
      const float m = group_reduce<true>(lm, L);
      float ls = 0.f;
      if (live)
        for (int c = li; c < C; c += L) {
          const float e = expf(row[c] - m);
          row[c] = e;
          ls += e;
        }
      const float total = group_reduce<false>(ls, L);
      if (live)
        for (int c = li; c < C; c += L) dst[r * C + c] = row[c] / total;
    }
  }
}

template <typename T, int V, bool kWeighted>
int launch_v(const void* p, const void* w, void* out, int K, int N, int C, int R, int S,
             int Gt, int threads, float scale, float inv_temp, int sharpen, void* stream) {
  auto kernel = era_sharpen_kernel<T, V, kWeighted>;
  const size_t smem = static_cast<size_t>(S) * R * C * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int blocks = (N + R - 1) / R;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p), static_cast<const float*>(w), static_cast<float*>(out), K, N,
      C, R, S, Gt, scale, inv_temp, sharpen);
  return static_cast<int>(cudaGetLastError());
}

// The plan must keep every vector load aligned and every thread in range;
// a plan that does not is refused before launch.
template <typename T, bool kWeighted>
int launch(const void* p, const void* w, void* out, int K, int N, int C, int R, int S, int Gt,
           int V, int threads, float scale, float inv_temp, int sharpen, void* stream) {
  const size_t vb = static_cast<size_t>(V) * sizeof(T);
  if (K < 1 || N < 1 || C < 1 || R < 1 || S < 1 || S > K || Gt < 1 || threads % 32 != 0 ||
      threads > kMaxThreads || S * Gt > threads || vb > 16 ||
      (static_cast<size_t>(N) * C) % V != 0 || (static_cast<size_t>(R) * C) % V != 0 ||
      reinterpret_cast<size_t>(p) % vb != 0 || reinterpret_cast<size_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (V) {
    case 1:
      return launch_v<T, 1, kWeighted>(p, w, out, K, N, C, R, S, Gt, threads, scale, inv_temp,
                                       sharpen, stream);
    case 2:
      return launch_v<T, 2, kWeighted>(p, w, out, K, N, C, R, S, Gt, threads, scale, inv_temp,
                                       sharpen, stream);
    case 4:
      return launch_v<T, 4, kWeighted>(p, w, out, K, N, C, R, S, Gt, threads, scale, inv_temp,
                                       sharpen, stream);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_v<T, 8, kWeighted>(p, w, out, K, N, C, R, S, Gt, threads, scale,
                                         inv_temp, sharpen, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// K1.  p: (K, N, C) float32 (dtype 0) or bfloat16 (dtype 1), contiguous;
// out: (N, C) float32.  (rows, slices, group_threads, vec, threads) is the
// wrapper's launch plan.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a plan the kernel does not take.
int era_sharpen(const void* p, void* out, int K, int N, int C, int dtype, float scale,
                float inv_temp, int rows, int slices, int group_threads, int vec, int threads,
                void* stream) {
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(p, nullptr, out, K, N, C, rows, slices, group_threads,
                                        vec, threads, scale, inv_temp, 1, stream);
  return launch<float, false>(p, nullptr, out, K, N, C, rows, slices, group_threads, vec,
                              threads, scale, inv_temp, 1, stream);
}

// K2.  As K1, with w: (K,) float32 normalized weights; sharpen=0 returns
// the weighted mean itself.
int weighted_era_sharpen(const void* p, const void* w, void* out, int K, int N, int C,
                         int dtype, float inv_temp, int sharpen, int rows, int slices,
                         int group_threads, int vec, int threads, void* stream) {
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(p, w, out, K, N, C, rows, slices, group_threads, vec,
                                       threads, 1.f, inv_temp, sharpen, stream);
  return launch<float, true>(p, w, out, K, N, C, rows, slices, group_threads, vec, threads,
                             1.f, inv_temp, sharpen, stream);
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
