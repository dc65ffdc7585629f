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
//
// The wide-row route (era_sharpen_wide_kernel): where a row of C f32 values
// does not fit a block's shared memory (C > 58,080; qwen1.5's 151,936
// classes need 607,744 bytes), the plan takes this route instead.
//  - One block a row, kWideThreads threads.  A row's clients share its
//    offset from a 16-byte boundary (the plan keeps N*C a multiple of V),
//    so a thread reads V values of every client with one load each: a
//    scalar head up to the first boundary, vectors, a scalar tail.
//  - Pass 1 forms each value's client sum in the narrow route's order with
//    S = 1 (k ascending from +0, each term rounded before it is added, then
//    1/K and 1/T), so zero-weight clients change no bit here either, and
//    keeps an online (max, sum of exp) per thread.  The threads' pairs are
//    merged in a fixed butterfly, with every product and sum rounded on its
//    own, so each lane gets the same bits and two launches agree.
//  - Pass 2 writes exp(s - m) / l.  It gets s one of two ways, whichever
//    moves fewer bytes: by running pass 1's sum again on the inputs (K*elt
//    bytes a value; the same bits, since it is the same arithmetic), or by
//    reading back what pass 1 stored in ``out`` (4 bytes written, 4 read).
//    The plan rereads where K*elt <= 8: at the LLM round's K = 2 bf16
//    that is 4 bytes a value against 8.
//  - Bound: bytes.  At (2, 1024, 151936) bf16 the call reads 622 MB and
//    writes 622 MB, 0.3715 ms at 3.35 TB/s; the reread adds 622 MB, so the
//    route moves 1.5x what the bound counts, less what the L2 cache keeps.
#include <type_traits>

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

constexpr int kWideThreads = 512;  // kernels/era_sharpen.WIDE_THREADS

// The merge of two online softmax partials (max, sum of exp(x - max)).
// Every product and sum is rounded on its own (no fused multiply-add), so
// the merge is symmetric and both lanes of a butterfly get the same bits.
__device__ __forceinline__ void merge_ml(float& m, float& l, float m2, float l2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;  // both empty
  l = __fadd_rn(__fmul_rn(l, expf(m - mm)), __fmul_rn(l2, expf(m2 - mm)));
  m = mm;
}

// One block a row; see "The wide-row route" above.
template <typename T, int V, bool kWeighted>
__global__ void __launch_bounds__(kWideThreads)
    era_sharpen_wide_kernel(const T* __restrict__ p, const float* __restrict__ w,
                            float* __restrict__ out, int K, int N, int C, float scale,
                            float inv_temp, int sharpen, int reread) {
  constexpr int U = V >= 16 ? 1 : 16 / V;  // vectors a thread loads at once
  __shared__ float red_m[32], red_l[32];
  const int t = threadIdx.x, T_ = blockDim.x;
  const size_t ks = static_cast<size_t>(N) * C;
  const T* row = p + static_cast<size_t>(blockIdx.x) * C;
  float* dst = out + static_cast<size_t>(blockIdx.x) * C;
  // the row's values before its first V-aligned one (every client alike)
  const int mis = static_cast<int>((reinterpret_cast<size_t>(row) / sizeof(T)) % V);
  const int head = min(C, (V - mis) % V);
  const int nvec = (C - head) / V;
  const int tail0 = head + nvec * V;

  auto finish = [&](float x) {
    if (!kWeighted) x *= scale;
    if (sharpen) x *= inv_temp;
    return x;
  };
  auto term = [&](int k, float x) {
    return kWeighted ? __fmul_rn(__ldg(w + k), x) : x;
  };
  // fn(c, xs): the values xs (a float[1] or float[V]) from c on, in order;
  // a thread's values are its head value, its vectors g = t, t + T, ...
  // and its tail value.  With from_out the values are read back from dst
  // instead of summed again.
  auto walk = [&](bool from_out, auto&& fn) {
    if (t < head) {
      float acc = 0.f;
      if (from_out) acc = dst[t];
      else {
        for (int k = 0; k < K; ++k)
          acc = __fadd_rn(acc, term(k, to_f32(row[k * ks + t])));
        acc = finish(acc);
      }
      float one[1] = {acc};
      fn(t, one);
    }
    for (int g0 = t; g0 < nvec; g0 += U * T_) {
      float acc[U][V];
      if (from_out) {
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (g0 + u * T_ < nvec) {
            const int c = head + (g0 + u * T_) * V;
#pragma unroll
            for (int v = 0; v < V; ++v) acc[u][v] = dst[c + v];
          }
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[u][v] = 0.f;
        for (int k = 0; k < K; ++k) {
          Vec<T, V> buf[U];
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (g0 + u * T_ < nvec)
              buf[u] = *reinterpret_cast<const Vec<T, V>*>(row + k * ks + head +
                                                           static_cast<size_t>(g0 + u * T_) * V);
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (g0 + u * T_ < nvec) {
#pragma unroll
              for (int v = 0; v < V; ++v)
                acc[u][v] = __fadd_rn(acc[u][v], term(k, to_f32(buf[u].v[v])));
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[u][v] = finish(acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (g0 + u * T_ < nvec) fn(head + (g0 + u * T_) * V, acc[u]);
    }
    if (tail0 + t < C) {
      const int c = tail0 + t;
      float acc = 0.f;
      if (from_out) acc = dst[c];
      else {
        for (int k = 0; k < K; ++k)
          acc = __fadd_rn(acc, term(k, to_f32(row[k * ks + c])));
        acc = finish(acc);
      }
      float one[1] = {acc};
      fn(c, one);
    }
  };
  // xs to dst + c: 16-byte stores where dst + c is 16-byte aligned
  auto store = [&](int c, const auto& xs) {
    constexpr int n = std::extent_v<std::remove_reference_t<decltype(xs)>>;
    float* d = dst + c;
    if (n % 4 == 0 && (reinterpret_cast<size_t>(d) & 15) == 0) {
#pragma unroll
      for (int i = 0; i < n; i += 4)
        *reinterpret_cast<float4*>(d + i) = make_float4(xs[i], xs[i + 1], xs[i + 2], xs[i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < n; ++i) d[i] = xs[i];
    }
  };

  if (!sharpen) {  // the weighted mean itself: one pass
    walk(false, store);
    return;
  }
  // pass 1: each thread's online (max, sum of exp)
  float m = -INFINITY, l = 0.f;
  walk(false, [&](int c, const auto& xs) {
    constexpr int n = std::extent_v<std::remove_reference_t<decltype(xs)>>;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float x = xs[i];
      if (x > m) {
        l = __fadd_rn(__fmul_rn(l, expf(m - x)), 1.f);
        m = x;
      } else {
        l = __fadd_rn(l, expf(x - m));
      }
    }
    if (!reread) store(c, xs);
  });
  // the block's (m, l): a butterfly in each warp, then warp 0 over the warps
  for (int o = 16; o > 0; o >>= 1)
    merge_ml(m, l, __shfl_xor_sync(0xffffffffu, m, o), __shfl_xor_sync(0xffffffffu, l, o));
  const int lane = t & 31, warp = t >> 5, n_warps = T_ >> 5;
  if (lane == 0) red_m[warp] = m, red_l[warp] = l;
  __syncthreads();
  if (warp == 0) {
    m = lane < n_warps ? red_m[lane] : -INFINITY;
    l = lane < n_warps ? red_l[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1)
      merge_ml(m, l, __shfl_xor_sync(0xffffffffu, m, o), __shfl_xor_sync(0xffffffffu, l, o));
    if (lane == 0) red_m[0] = m, red_l[0] = l;
  }
  __syncthreads();
  m = red_m[0];
  l = red_l[0];
  // pass 2: every value once more, sharpened and written
  walk(!reread, [&](int c, const auto& xs) {
    constexpr int n = std::extent_v<std::remove_reference_t<decltype(xs)>>;
    float e[n];
#pragma unroll
    for (int i = 0; i < n; ++i) e[i] = expf(xs[i] - m) / l;
    store(c, e);
  });
}

template <typename T, int V, bool kWeighted>
int launch_wide_v(const void* p, const void* w, void* out, int K, int N, int C, int threads,
                  float scale, float inv_temp, int sharpen, int reread, void* stream) {
  era_sharpen_wide_kernel<T, V, kWeighted><<<N, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(p), static_cast<const float*>(w), static_cast<float*>(out), K, N,
      C, scale, inv_temp, sharpen, reread);
  return static_cast<int>(cudaGetLastError());
}

// The wide route's plan: one block a row, V values a load (every client's
// row at the same offset from a V-element boundary: N*C a multiple of V).
template <typename T, bool kWeighted>
int launch_wide(const void* p, const void* w, void* out, int K, int N, int C, int V,
                int threads, float scale, float inv_temp, int sharpen, int reread,
                void* stream) {
  const size_t vb = static_cast<size_t>(V) * sizeof(T);
  if (K < 1 || N < 1 || C < 1 || threads % 32 != 0 || threads > kWideThreads || threads < 32 ||
      vb > 16 || (static_cast<size_t>(N) * C) % V != 0 ||
      reinterpret_cast<size_t>(p) % sizeof(T) != 0 || reinterpret_cast<size_t>(out) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (V) {
    case 1:
      return launch_wide_v<T, 1, kWeighted>(p, w, out, K, N, C, threads, scale, inv_temp,
                                            sharpen, reread, stream);
    case 2:
      return launch_wide_v<T, 2, kWeighted>(p, w, out, K, N, C, threads, scale, inv_temp,
                                            sharpen, reread, stream);
    case 4:
      return launch_wide_v<T, 4, kWeighted>(p, w, out, K, N, C, threads, scale, inv_temp,
                                            sharpen, reread, stream);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_wide_v<T, 8, kWeighted>(p, w, out, K, N, C, threads, scale, inv_temp,
                                              sharpen, reread, stream);
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

// K1 and K2 on the wide-row route (rows wider than a block's shared
// memory): (vec, threads, reread) is the wrapper's plan; the rest as above.
int era_sharpen_wide(const void* p, void* out, int K, int N, int C, int dtype, float scale,
                     float inv_temp, int vec, int threads, int reread, void* stream) {
  if (dtype == 1)
    return launch_wide<__nv_bfloat16, false>(p, nullptr, out, K, N, C, vec, threads, scale,
                                             inv_temp, 1, reread, stream);
  return launch_wide<float, false>(p, nullptr, out, K, N, C, vec, threads, scale, inv_temp, 1,
                                   reread, stream);
}

int weighted_era_sharpen_wide(const void* p, const void* w, void* out, int K, int N, int C,
                              int dtype, float inv_temp, int sharpen, int vec, int threads,
                              int reread, void* stream) {
  if (dtype == 1)
    return launch_wide<__nv_bfloat16, true>(p, w, out, K, N, C, vec, threads, 1.f, inv_temp,
                                            sharpen, reread, stream);
  return launch_wide<float, true>(p, w, out, K, N, C, vec, threads, 1.f, inv_temp, sharpen,
                                  reread, stream);
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
