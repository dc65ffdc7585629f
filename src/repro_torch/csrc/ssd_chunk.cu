// K5: Mamba2's within-chunk ("diagonal") SSD block on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py:48
// (ssd_chunk_pallas / _kernel).  For every chunk m and head h, with
// cum = cumsum(dA) along the chunk and g = h / (H / G) the head's group:
//
//   y[i, :] = sum_{j <= i} (C[i, g, :] . B[j, g, :]) * exp(cum[i] - cum[j])
//                          * dt[j] * x[j, h, :]
//
// x (M, Q, H, P), dt and dA (M, Q, H), B and C (M, Q, G, N), all float32
// and contiguous; y (M, Q, H, P) float32.  Any Q, H, P, G, N with H % G == 0.
//
// What bounds it: operations.  At the serving path's prefill of (4, 2048)
// on mamba2-2.7b (M=32, Q=256, H=80, P=64, G=1, N=128) the causal work is
// 11.4 GFLOP (C B^T once per group, shared by its heads; the rest per
// head), 0.17 ms at the card's 67 TFLOP/s fp32 rate (outside the tensor
// cores), while the bytes (x, dt, dA, B, C in, y out: 349 MB) take 0.10 ms
// at 3.35 TB/s.  The reference's tolerance is 1e-4 in fp32, so the
// products run as fp32 FMAs, not TF32 tensor-core products.  This kernel
// forms C B^T again for every head (256 of its 388 operations per causal
// pair at G = 1); sharing it across a group's heads is the next redesign.
//
// Design.  The TPU kernel keeps one (m, h) tile whole in VMEM, including
// the (Q, Q) score matrix: 256 KB in fp32 at Q=256, more than the 227 KB a
// block may use here.  So a block takes one (m, h, tile of 64 query rows,
// tile of 64 head-dim columns) and walks the 64-row key tiles up to the
// diagonal only; the tiles above it are never touched (about half the
// work of the full square).  Per key tile it loads B and x into shared
// memory, forms S = C B^T (64 x 64, 4 x 4 per thread, 256 threads), scales
// S by exp(cum_i - cum_j) * dt_j where i >= j and sets it to 0 elsewhere,
// and adds S x into y, which stays in registers for the block's life.
// exp is never taken above the diagonal: there cum_i - cum_j > 0 can
// overflow to inf, and inf * 0 would be NaN.  Rows past Q and columns past
// P load as zeros and are not stored, so no shape needs to divide a tile.
// Blocks that share (m, qt) and differ in h run next to each other, so at
// G = 1 the B and C tiles they all read stay in L2.  With N = 128 and
// P = 64 a block uses about 100 KB of shared memory (two blocks per SM),
// above 48 KB, hence the dynamic shared memory attribute.
//
// cumsum order: warp 0 scans dA in 32-element pieces (a Hillis-Steele scan
// in registers plus the running carry), so the sums are taken in another
// order than the reference's sequential cumsum; the difference stays far
// inside the 1e-4 tolerance.  Shared-memory rows of C and B use an odd
// stride, so the per-n column reads of a warp hit distinct banks.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kBP = 64;        // head-dim columns per block
constexpr int kThreads = 256;  // 16 x 16 threads, each 4 x 4 outputs
constexpr int kLdS = kBK + 1;  // row stride of the score tile in shared memory

__host__ __device__ inline int odd_stride(int n) { return n | 1; }

size_t smem_floats(int Q, int N) {
  return static_cast<size_t>(Q) + kBK + static_cast<size_t>(kBQ + kBK) * odd_stride(N) +
         static_cast<size_t>(kBK) * kBP + static_cast<size_t>(kBQ) * kLdS;
}

__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ dA, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, float* __restrict__ y, int Q, int H, int P,
                     int G, int N, int n_qt, int n_pt) {
  extern __shared__ float smem[];
  const int ldn = odd_stride(N);
  float* cum = smem;              // (Q,)  cumsum of dA, rows 0..q_end
  float* dts = cum + Q;           // (kBK,) dt of the key tile
  float* Cs = dts + kBK;          // (kBQ, ldn) C rows of the query tile
  float* Bs = Cs + kBQ * ldn;     // (kBK, ldn) B rows of the key tile
  float* Xs = Bs + kBK * ldn;     // (kBK, kBP) x rows of the key tile
  float* Ss = Xs + kBK * kBP;     // (kBQ, kLdS) scaled scores

  long long idx = blockIdx.x;
  const int pt = static_cast<int>(idx % n_pt);
  idx /= n_pt;
  const int h = static_cast<int>(idx % H);
  idx /= H;
  const int qt = n_qt - 1 - static_cast<int>(idx % n_qt);  // longest rows first
  const long long m = idx / n_qt;
  const int g = h / (H / G);
  const int q0 = qt * kBQ;
  const int p0 = pt * kBP;
  const int q_end = min(Q, q0 + kBQ);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long mQ = m * Q;

  for (int q = tid; q < q_end; q += kThreads) cum[q] = dA[(mQ + q) * H + h];
  for (int e = tid; e < kBQ * N; e += kThreads) {
    const int r = e / N;
    const int n = e - r * N;
    const int q = q0 + r;
    Cs[r * ldn + n] = q < Q ? Cm[((mQ + q) * G + g) * N + n] : 0.f;
  }
  __syncthreads();
  if (tid < 32) {
    float carry = 0.f;
    for (int base = 0; base < q_end; base += 32) {
      const int q = base + tid;
      float v = q < q_end ? cum[q] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (tid >= o) v += u;
      }
      v += carry;
      if (q < q_end) cum[q] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kBK;
    const int k_n = min(kBK, Q - k0);  // key rows of this tile inside the chunk
    __syncthreads();  // the last tile's readers are done; cum is published
    for (int e = tid; e < kBK * N; e += kThreads) {
      const int r = e / N;
      const int n = e - r * N;
      Bs[r * ldn + n] = r < k_n ? Bm[((mQ + k0 + r) * G + g) * N + n] : 0.f;
    }
    for (int e = tid; e < kBK * kBP; e += kThreads) {
      const int r = e / kBP;
      const int p = p0 + (e - r * kBP);
      Xs[e] = (r < k_n && p < P) ? x[((mQ + k0 + r) * H + h) * P + p] : 0.f;
    }
    if (tid < kBK) dts[tid] = tid < k_n ? dt[(mQ + k0 + tid) * H + h] : 0.f;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Cs[(ty + 16 * r) * ldn + n];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Bs[(tx + 16 * c) * ldn + n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], b[c], s[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jl = tx + 16 * c;
        const int j = k0 + jl;
        float w = 0.f;
        if (i < Q && j <= i) w = s[r][c] * expf(cum[i] - cum[j]) * dts[jl];
        Ss[(ty + 16 * r) * kLdS + jl] = w;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < k_n; ++j) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Ss[(ty + 16 * r) * kLdS + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = Xs[j * kBP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= Q) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = p0 + tx + 16 * c;
      if (p < P) y[((mQ + i) * H + h) * P + p] = acc[r][c];
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block of the kernel needs at chunk length Q and state
// size N, in bytes (the wrapper refuses shapes above the card's limit).
long long ssd_chunk_smem_bytes(int Q, int N) {
  return static_cast<long long>(smem_floats(Q, N) * sizeof(float));
}

// K5.  See the note at the top.  Returns cudaGetLastError() after the launch.
int ssd_chunk(const void* x, const void* dt, const void* dA, const void* B, const void* C,
              void* y, int M, int Q, int H, int P, int G, int N, void* stream) {
  const int n_qt = (Q + kBQ - 1) / kBQ;
  const int n_pt = (P + kBP - 1) / kBP;
  const size_t smem = smem_floats(Q, N) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long blocks = static_cast<long long>(M) * H * n_qt * n_pt;
  ssd_chunk_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(dA), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y), Q, H, P, G, N, n_qt, n_pt);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
