// K3 and K4: the fused distillation cross-entropy CE(t || softmax(z)) and
// its gradient, on Hopper.
//
// Replaces the TPU kernels in src/repro/kernels/distill_loss.py:
//   K3  distill_loss_fwd_pallas (:74) / _fwd_kernel   per row: logZ = logsumexp(z),
//                                                    loss = tmass * logZ - sum t*z
//   K4  distill_loss_bwd_pallas (:98) / _bwd_kernel   dz = g/N * (exp(z - logZ) * tmass - t)
//
// What bounds them: bytes.  K3 reads z and t once and writes two floats per
// row; K4 reads z and t once and writes dz.  Both do a handful of flops and
// one exp per element, far below the card's compute rate.
//
// K3's design (the plan comes from kernels/distill_loss.launch_plan):
//  - Loads in flight.  A thread loads kBatchBytes of z and as many of t
//    (four 16-byte vectors of each where the pointers allow) before it uses
//    any of them: 32 KB per 256-thread block, so an SM holds enough
//    requests to stream at the memory's rate, where one scalar load of each
//    at a time held about 2 KB a block.
//  - Rows that do not start on a vector boundary (V odd in f32, V not a
//    multiple of 8 in bf16) keep their vector loads: each row has a scalar
//    head up to the first boundary of its z (t shares z's phase: the plan's
//    load width divides the distance between the two pointers), a vector
//    body and a scalar tail.
//  - Long rows: one row per block.  The block reduces its state (m, l, td,
//    tm) in a fixed order (a shuffle butterfly in each warp, then warp 0
//    over the warps) and writes loss and logZ.  No atomics: repeats give
//    the same bits.
//  - Short rows (V up to 64): L lanes a row, 32/L rows a warp, scalar
//    loads (a warp still reads contiguous bytes) and a butterfly inside the
//    row's lanes, so a 10-element row no longer leaves 246 of 256 threads
//    idle.
//  - One exponential per element and no divergent branch: for a batch of
//    values in registers, the batch's max first, the running sum l rescaled
//    once, then exp2f((z - m) * log2(e)) added for each value.  A state
//    with l == 0 holds no element (m = -inf) and adds nothing.
// K4: one elementwise pass in a grid-stride loop over N*V, reading the row's
// logZ and tmass and the scale g/N from device memory (no host sync).
#include <stdint.h>

#include "common.cuh"

namespace {

using repro_torch::load_f32;
using repro_torch::store_from_f32;

constexpr int kMaxThreads = 256;  // kernels/distill_loss.THREADS
constexpr int kBatchBytes = 64;   // bytes of z (and of t) a thread loads at once (BATCH_BYTES)
constexpr int kShortBatch = 4;    // elements a lane loads at once in a short row
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The running state of a row or a part of it: m the max, l = sum exp(z - m),
// td = sum t*z, tm = sum t.
struct State {
  float m, l, td, tm;
};

__device__ __forceinline__ State empty_state() { return {-INFINITY, 0.f, 0.f, 0.f}; }

// Combine two states.  A state with l == 0 holds no element and adds nothing.
__device__ __forceinline__ void combine(State& a, const State& b) {
  const float mn = fmaxf(a.m, b.m);
  const float x = a.l == 0.f ? 0.f : a.l * expf(a.m - mn);
  const float y = b.l == 0.f ? 0.f : b.l * expf(b.m - mn);
  a.m = mn;
  a.l = x + y;
  a.td += b.td;
  a.tm += b.tm;
}

// Add K values held in registers to a state: the first ``valid`` of them
// (all of them unless kMasked) are elements; the others are zeros that add
// nothing to td and tm and are kept out of the max and the sum of exp.
template <int K, bool kMasked>
__device__ __forceinline__ void absorb(State& s, const float (&z)[K], const float (&t)[K],
                                       int valid) {
  float mb = -INFINITY;
#pragma unroll
  for (int i = 0; i < K; ++i) mb = fmaxf(mb, (!kMasked || i < valid) ? z[i] : -INFINITY);
  const float mn = fmaxf(s.m, mb);
  const float ms = mn == -INFINITY ? 0.f : mn;  // all -inf so far: nothing to scale
  float l = s.l * exp2f((s.m - ms) * kLog2e);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float e = exp2f((z[i] - ms) * kLog2e);
    l += (!kMasked || i < valid) ? e : 0.f;
    s.td = fmaf(t[i], z[i], s.td);
    s.tm += t[i];
  }
  s.m = mn;
  s.l = l;
}

__device__ __forceinline__ void absorb_one(State& s, float z, float t) {
  const float zz[1] = {z}, tt[1] = {t};
  absorb<1, false>(s, zz, tt, 1);
}

// Butterfly over each aligned group of L lanes (L a power of two <= 32);
// every lane of the warp takes part.
__device__ __forceinline__ void group_combine(State& s, int L) {
  for (int o = L >> 1; o > 0; o >>= 1) {
    State p;
    p.m = __shfl_xor_sync(0xffffffffu, s.m, o);
    p.l = __shfl_xor_sync(0xffffffffu, s.l, o);
    p.td = __shfl_xor_sync(0xffffffffu, s.td, o);
    p.tm = __shfl_xor_sync(0xffffffffu, s.tm, o);
    combine(s, p);
  }
}

__device__ __forceinline__ void write_row(const State& s, float* loss, float* logz, size_t n) {
  const float lz = s.m + logf(s.l);
  loss[n] = s.tm * lz - s.td;
  logz[n] = lz;
}

// One row per block.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
    distill_fwd_rows(const T* __restrict__ z, const T* __restrict__ t, float* __restrict__ loss,
                     float* __restrict__ logz, int V) {
  constexpr int VB = VEC * static_cast<int>(sizeof(T));
  constexpr int U = kBatchBytes / VB;  // vectors of z (and of t) a thread loads at once
  using Vz = Vec<T, VEC>;
  __shared__ State warp_state[kMaxThreads / 32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t n = blockIdx.x;
  const T* zr = z + n * V;
  const T* tr = t + n * V;
  const int ph = static_cast<int>(reinterpret_cast<uintptr_t>(zr) % VB);
  const int head = min(V, ph ? (VB - ph) / static_cast<int>(sizeof(T)) : 0);
  const long long body = (V - head) / VEC;
  const int tail = V - head - static_cast<int>(body * VEC);

  State st = empty_state();
  if (tid < head) absorb_one(st, to_f32(zr[tid]), to_f32(tr[tid]));
  if (tid < tail) {
    const size_t i = head + body * VEC + tid;
    absorb_one(st, to_f32(zr[i]), to_f32(tr[i]));
  }
  // my vectors: tid, tid + nt, ... below body, U at a time
  const long long mine = body - tid;
  const int items = mine > 0 ? static_cast<int>((mine + nt - 1) / nt) : 0;
  const Vz* zv = reinterpret_cast<const Vz*>(zr + head) + tid;
  const Vz* tv = reinterpret_cast<const Vz*>(tr + head) + tid;
  int i0 = 0;
  for (; i0 + U <= items; i0 += U) {
    Vz bz[U], bt[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      bz[u] = zv[static_cast<size_t>(i0 + u) * nt];
      bt[u] = tv[static_cast<size_t>(i0 + u) * nt];
    }
    float fz[U * VEC], ft[U * VEC];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        fz[u * VEC + v] = to_f32(bz[u].v[v]);
        ft[u * VEC + v] = to_f32(bt[u].v[v]);
      }
    absorb<U * VEC, false>(st, fz, ft, U * VEC);
  }
  if (i0 < items) {  // the last, partial batch
    const int left = items - i0;
    Vz bz[U], bt[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < left) {
        bz[u] = zv[static_cast<size_t>(i0 + u) * nt];
        bt[u] = tv[static_cast<size_t>(i0 + u) * nt];
      }
    }
    float fz[U * VEC], ft[U * VEC];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        fz[u * VEC + v] = u < left ? to_f32(bz[u].v[v]) : 0.f;
        ft[u * VEC + v] = u < left ? to_f32(bt[u].v[v]) : 0.f;
      }
    absorb<U * VEC, true>(st, fz, ft, left * VEC);
  }

  // the block's state: a butterfly in each warp, then warp 0 over the warps
  group_combine(st, 32);
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) warp_state[warp] = st;
  __syncthreads();
  if (warp == 0) {
    st = lane < (nt >> 5) ? warp_state[lane] : empty_state();
    group_combine(st, 32);
    if (lane == 0) write_row(st, loss, logz, n);
  }
}

// Short rows: L lanes a row, blockDim.x / L rows a block.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    distill_fwd_short(const T* __restrict__ z, const T* __restrict__ t, float* __restrict__ loss,
                      float* __restrict__ logz, int N, int V, int L) {
  const int li = threadIdx.x & (L - 1);
  const long long r = static_cast<long long>(blockIdx.x) * (blockDim.x / L) + threadIdx.x / L;
  State st = empty_state();
  if (r < N) {
    const T* zr = z + static_cast<size_t>(r) * V;
    const T* tr = t + static_cast<size_t>(r) * V;
    for (int c0 = li; c0 < V; c0 += kShortBatch * L) {
      float fz[kShortBatch], ft[kShortBatch];
      int valid = 0;
#pragma unroll
      for (int k = 0; k < kShortBatch; ++k) {
        const int c = c0 + k * L;
        const bool ok = c < V;
        fz[k] = ok ? to_f32(zr[c]) : 0.f;
        ft[k] = ok ? to_f32(tr[c]) : 0.f;
        valid += ok;
      }
      absorb<kShortBatch, true>(st, fz, ft, valid);
    }
  }
  group_combine(st, L);
  if (r < N && li == 0) write_row(st, loss, logz, static_cast<size_t>(r));
}

template <typename T, int VEC>
int launch_rows(const void* z, const void* t, void* loss, void* logz, int N, int V, int threads,
                cudaStream_t stream) {
  distill_fwd_rows<T, VEC><<<static_cast<unsigned>(N), threads, 0, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(t), static_cast<float*>(loss),
      static_cast<float*>(logz), V);
  return static_cast<int>(cudaGetLastError());
}

// The plan must keep every vector load aligned and every thread in range;
// a plan that does not is refused before launch.
template <typename T>
int launch_fwd(const void* z, const void* t, void* loss, void* logz, int N, int V, int vec,
               int lanes, int threads, cudaStream_t stream) {
  constexpr int elt = static_cast<int>(sizeof(T));
  const uintptr_t zp = reinterpret_cast<uintptr_t>(z), tp = reinterpret_cast<uintptr_t>(t);
  const bool pow2_lanes = lanes >= 1 && (lanes & (lanes - 1)) == 0;
  if (N < 1 || V < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      vec < 1 || vec * elt > 16 || zp % elt != 0 || tp % elt != 0 ||
      (zp - tp) % static_cast<uintptr_t>(vec * elt) != 0 ||
      reinterpret_cast<uintptr_t>(loss) % 4 != 0 || reinterpret_cast<uintptr_t>(logz) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes < threads) {  // short rows
    if (!pow2_lanes || lanes > 32 || vec != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const int rows = threads / lanes;
    const unsigned blocks = static_cast<unsigned>((static_cast<long long>(N) + rows - 1) / rows);
    distill_fwd_short<T><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(z), static_cast<const T*>(t), static_cast<float*>(loss),
        static_cast<float*>(logz), N, V, lanes);
    return static_cast<int>(cudaGetLastError());
  }
  if (lanes != threads) return static_cast<int>(cudaErrorInvalidValue);
  switch (vec) {
    case 1:
      return launch_rows<T, 1>(z, t, loss, logz, N, V, threads, stream);
    case 2:
      return launch_rows<T, 2>(z, t, loss, logz, N, V, threads, stream);
    case 4:
      return launch_rows<T, 4>(z, t, loss, logz, N, V, threads, stream);
    case 8:
      if constexpr (elt == 2)
        return launch_rows<T, 8>(z, t, loss, logz, N, V, threads, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
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
// loss, logz: (N,) float32.  (vec, lanes, threads) is the wrapper's launch
// plan: lanes == threads is one row per block, lanes < threads is
// ``threads / lanes`` short rows a block.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a plan the kernel does not take (nothing is launched then).
int distill_loss_fwd(const void* z, const void* t, void* loss, void* logz, int N, int V,
                     int dtype, int vec, int lanes, int threads, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(z, t, loss, logz, N, V, vec, lanes, threads, s);
  return launch_fwd<float>(z, t, loss, logz, N, V, vec, lanes, threads, s);
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
