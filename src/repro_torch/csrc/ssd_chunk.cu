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
// and contiguous; y (M, Q, H, P) float32.  Any Q, H, P, G, N with H % G == 0
// whose shared memory (ssd_chunk_smem_bytes) fits a block: at N = 128 that
// is Q up to 448.
//
// What bounds it: bytes.  At the serving path's prefill of (4, 2048) on
// mamba2-2.7b (M=32, Q=256, H=80, P=64, G=1, N=128) the function reads x,
// dt, dA, B, C and writes y, 349 MB: 0.104 ms at 3.35 TB/s.  Its products
// are 11.05 GFLOP (C B^T once per group, W x per head, causal pairs only);
// run as three TF32 tensor-core products each (below) that is 0.067 ms at
// 495 TFLOP/s, and the elementwise work (decay, dt, cumsum, 0.34 GFLOP) is
// 0.005 ms at 67 TFLOP/s.  With every operation at the fp32 rate outside the
// tensor cores the bound would be 0.170 ms.
//
// Design (a): one block per (chunk m, group g, 64-row query tile, slice of at
// most 16 of the group's heads), taken over design (b) (the scores written
// to a scratch and read back per head) because the scores then never leave
// shared memory.  The wrapper picks the slice size hs (kernels/ssd_chunk.py
// launch_plan): 16, halved while the grid would not fill the card's SMs,
// lowered further if the shared memory would not fit.  At the main shape
// hs = 16: 32 * 4 * 5 = 640 blocks, and the scores are about an eighth of a
// block's products (hs = 8 took 8% longer on the H100).  The last slice of
// a group may hold fewer heads; a slice never crosses a group.
//
// 1. Scores once per slice.  The block forms S = C B^T for its query rows
//    against every key tile up to the diagonal (at most Q/64 tiles of 64 x 64
//    fp32, 68 KB at Q = 256) and keeps them in shared memory.  Every head of
//    the slice then reads them: at G = 1 the 80 heads of a chunk's query tile
//    form S 5 times, not 80.
// 2. Products on the tensor cores at fp32 accuracy.  Both products run as
//    mma.sync.m16n8k8 with TF32 operands, split 3xTF32: a = hi + lo with
//    hi = tf32(a) and lo = tf32(a - hi), and d += lo*hi + hi*lo + hi*hi in
//    fp32 (lo*lo, about 2^-22 of the product, is dropped).  One TF32 product
//    keeps 10 mantissa bits and misses the 1e-4 tolerance at N = 128
//    (tests/test_torch_ssd_numerics.py shows both).  mma.sync reads its
//    fragments from shared memory with any indexing, so the x tile (key rows
//    x P) needs no transpose, which wgmma's K-major TF32 operands would.
//    W = S * exp(cum_i - cum_j) * dt_j is formed in fp32 before the split,
//    and only where j <= i: above the diagonal cum_i - cum_j > 0 can overflow
//    exp to inf, and inf * 0 would be NaN, so there W is set to 0 by a select.
//    The decay is exp2f((cum_i - cum_j) * log2(e)): scaling the difference,
//    not the cumsum, keeps the rounding of the scale proportional to
//    |cum_i - cum_j|, small where the decay is not.  The tensor cores' fp32
//    sums are kept short: the large and the two small terms go to separate
//    accumulators, added into the result in fp32 every 32 of N (scores)
//    and every key tile (y).
// 3. Loads overlap the products.  Tiles come in with 16-byte cp.async (4-byte
//    ones when a row is not 16-byte aligned), rows walked by warps and pieces
//    by lanes, with no integer division per element.  Two buffers: the next
//    B tile (scores) or x tile (heads) is in flight while the current one is
//    multiplied.  y stays in registers for a head's whole walk over its key
//    tiles (and a 64-column slice of P at a time).
//
// Ragged shapes: rows past Q, columns past N or P load as zeros (the copies'
// source size is 0) and are never stored; N is padded to the MMA's k = 8,
// so no shape has to divide a tile.  Padded query rows get dA = 0 and padded
// key rows dt = 0.
//
// Warps: 8.  For S each owns 16 rows x 32 columns of the 64 x 64 tile.  For
// y each owns 16 rows x 64 columns and one half of every key tile, so each
// element of W is formed once; the two halves' sums meet in shared memory at
// the end of a head's walk.  (Skipping, on the diagonal tile, the steps that
// lie wholly above a warp's rows took 7% longer on the H100: 205 registers
// in place of 188.)  Shared-memory rows are padded (N to 8k + 4, S to 68, x to 72 floats) so
// each fragment load of a warp hits 32 distinct banks.  The C and B tiles of
// the score phase share their space with the x buffers (and the halves'
// sums) of the head phase.  Blocks of the longest query tiles go first.
//
// cumsum order: warp w scans heads w, w + 8 of the slice in 32-element pieces (a
// Hillis-Steele scan in registers plus the running carry), another order
// than the reference's sequential cumsum; the difference stays far inside
// the 1e-4 tolerance.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key rows per tile
constexpr int kBP = 64;          // head-dim columns per pass
constexpr int kThreads = 256;    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeads = 16;   // heads per block at most
constexpr int kLdS = kBK + 4;    // row stride of a score tile
constexpr int kLdX = kBP + 8;    // row stride of an x tile
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int ld_n(int N) { return cdiv(N, 8) * 8 + 4; }

// Shared memory in floats: the staging area (C and two B tiles, or two x
// tiles and the key halves' sums of y), the score tiles of the block's query
// rows, and the cumsum and dt of the slice's heads.
struct Smem {
  size_t stage, scores, cum, total;
  __host__ __device__ Smem(int Q, int N, int hs) {
    const int n_qt = cdiv(Q, kBQ);
    const size_t a = static_cast<size_t>(kBQ + 2 * kBK) * ld_n(N);
    const size_t b = static_cast<size_t>(2 * kBK) * kLdX + 4 * 32 * 32;
    stage = a > b ? a : b;
    scores = static_cast<size_t>(n_qt) * kBQ * kLdS;
    cum = static_cast<size_t>(hs) * n_qt * kBQ;
    total = stage + scores + 2 * cum;
  }
};

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ inline void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ inline void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies a 64-row tile into shared memory (row stride ld): row r reads
// src + r * stride and is valid for r < n_rows; columns [0, n_cols) are
// valid, [n_cols, width) land as zeros, as do invalid rows.  width % 4 == 0.
// vec: n_cols % 4 == 0 and src, stride 16-byte aligned.  Lanes take a row's
// 16-byte pieces (1, 2 or 4 rows a warp), warps take rows.
__device__ inline void load_tile(float* dst, int ld, const float* src, long long stride,
                                 int n_rows, int n_cols, int width, bool vec) {
  const int pieces = width >> 2;
  const int sh = pieces <= 8 ? 3 : (pieces <= 16 ? 4 : 5);  // log2(lanes per row)
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * (32 >> sh) + (lane >> sh);
  const int step = kWarps * (32 >> sh);
  for (int r = r0; r < kBK; r += step) {
    const bool row_ok = r < n_rows;
    const float* row = src + r * stride;
    float* d = dst + r * ld;
    for (int c = (lane & ((1 << sh) - 1)) << 2; c < width; c += 4 << sh) {
      if (vec) {
        const bool ok = row_ok && c < n_cols;
        cp_async16(d + c, ok ? row + c : src, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const bool ok = row_ok && c + t < n_cols;
          cp_async4(d + c + t, ok ? row + c + t : src, ok ? 4 : 0);
        }
      }
    }
  }
}

__device__ inline uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(f));
  return r;
}
__device__ inline void split(float f, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(f);
  lo = to_tf32(f - __uint_as_float(hi));
}
__device__ inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// 3xTF32: a b with a = ah + al, b = bh + bl (al bl dropped); the large term
// goes to `big`, the two small ones to `small`.
__device__ inline void mma3(float (&big)[4], float (&small)[4], const uint32_t (&ah)[4],
                            const uint32_t (&al)[4], const uint32_t (&bh)[2],
                            const uint32_t (&bl)[2]) {
  mma_tf32(small, al, bh);
  mma_tf32(small, ah, bl);
  mma_tf32(big, ah, bh);
}
// acc += big + small, rounded to nearest in fp32; big and small restart at 0.
template <int NT>
__device__ inline void flush(float (&acc)[NT][4], float (&big)[NT][4], float (&small)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[n][e] += big[n][e] + small[n][e];
      big[n][e] = small[n][e] = 0.f;
    }
}

// Fragment coordinates of m16n8k8 (lane = 4 * gid + tig): A holds (gid, tig),
// (gid + 8, tig), (gid, tig + 4), (gid + 8, tig + 4); B holds (k = tig,
// n = gid), (tig + 4, gid); D holds (gid, 2 tig), (gid, 2 tig + 1),
// (gid + 8, 2 tig), (gid + 8, 2 tig + 1).

__global__ void __launch_bounds__(kThreads, 1)
    ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ dA, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, float* __restrict__ y, int M, int Q, int H,
                     int P, int G, int N, int hs, int n_slices, bool vec_x, bool vec_bc) {
  extern __shared__ __align__(16) float smem[];
  const Smem lay(Q, N, hs);
  const int n_qt = cdiv(Q, kBQ);
  const int qpad = n_qt * kBQ;
  const int ldn = ld_n(N);
  const int n8 = cdiv(N, 8) * 8;
  float* Cs = smem;                       // (kBQ, ldn)       score phase
  float* Bs = Cs + kBQ * ldn;             // 2 x (kBK, ldn)   score phase
  float* Xs = smem;                       // 2 x (kBK, kLdX)  head phase
  float* Ss = smem + lay.stage;           // n_qt x (kBQ, kLdS)
  float* cum = Ss + lay.scores;           // (hs, qpad): cumsum(dA)
  float* dts = cum + lay.cum;             // (hs, qpad)

  long long idx = blockIdx.x;
  const int slice = static_cast<int>(idx % n_slices);
  idx /= n_slices;
  const int g = static_cast<int>(idx % G);
  idx /= G;
  const long long m = idx % M;
  const int qt = n_qt - 1 - static_cast<int>(idx / M);  // longest rows first
  const int hpg = H / G;
  const int h0 = g * hpg + slice * hs;
  const int hs_b = min(hs, hpg - slice * hs);  // heads of this slice
  const int q0 = qt * kBQ;
  const int q_end = q0 + kBQ;                  // rows of cum and dt needed
  const long long mQ = m * Q;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wr = (warp & 3) * 16;              // the warp's rows of the 64
  const int wc = (warp >> 2) * 32;             // its columns

  // score phase: C tile and the first two B tiles in flight
  const long long bc0 = (mQ * G + g) * N;                 // row 0 of (m, g) in B, C
  const long long bc_stride = static_cast<long long>(G) * N;
  load_tile(Cs, ldn, Cm + bc0 + q0 * bc_stride, bc_stride, Q - q0, N, n8, vec_bc);
  load_tile(Bs, ldn, Bm + bc0, bc_stride, Q, N, n8, vec_bc);
  cp_async_commit();
  if (qt >= 1)
    load_tile(Bs + kBK * ldn, ldn, Bm + bc0 + kBK * bc_stride, bc_stride, Q - kBK, N, n8,
              vec_bc);
  cp_async_commit();

  // dA and dt of the slice's heads, rows [0, q_end); past Q both are 0
  for (int e = tid; e < q_end * kMaxHeads; e += kThreads) {
    const int q = e >> 4, s = e & (kMaxHeads - 1);
    if (s < hs_b) {
      float a = 0.f, d = 0.f;
      if (q < Q) {
        const long long o = (mQ + q) * H + h0 + s;
        a = dA[o];
        d = dt[o];
      }
      cum[s * qpad + q] = a;
      dts[s * qpad + q] = d;
    }
  }
  __syncthreads();
  for (int sw = warp; sw < hs_b; sw += kWarps) {
    float* c = cum + sw * qpad;
    float carry = 0.f;
    for (int base = 0; base < q_end; base += 32) {
      float v = c[base + lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      v += carry;
      c[base + lane] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }

  for (int kt = 0; kt <= qt; ++kt) {
    cp_async_wait<1>();
    __syncthreads();  // tile kt has landed for every thread; cum is published
    const float* Bt = Bs + (kt & 1) * kBK * ldn;
    float s[4][4] = {}, big[4][4] = {}, small[4][4] = {};
#pragma unroll 2
    for (int k = 0; k < n8; k += 8) {
      uint32_t ah[4], al[4];
      const float* a = Cs + (wr + gid) * ldn + k + tig;
      split(a[0], ah[0], al[0]);
      split(a[8 * ldn], ah[1], al[1]);
      split(a[4], ah[2], al[2]);
      split(a[8 * ldn + 4], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* b = Bt + (wc + nt * 8 + gid) * ldn + k + tig;
        uint32_t bh[2], bl[2];
        split(b[0], bh[0], bl[0]);
        split(b[4], bh[1], bl[1]);
        mma3(big[nt], small[nt], ah, al, bh, bl);
      }
      if ((k & 31) == 24 || k + 8 == n8) flush(s, big, small);  // every 32 of N
    }
    float* St = Ss + kt * kBQ * kLdS + (wr + gid) * kLdS + wc + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      *reinterpret_cast<float2*>(St + nt * 8) = make_float2(s[nt][0], s[nt][1]);
      *reinterpret_cast<float2*>(St + nt * 8 + 8 * kLdS) = make_float2(s[nt][2], s[nt][3]);
    }
    __syncthreads();  // B tile (kt & 1) is free
    if (kt + 2 <= qt)
      load_tile(Bs + (kt & 1) * kBK * ldn, ldn, Bm + bc0 + (kt + 2) * kBK * bc_stride,
                bc_stride, Q - (kt + 2) * kBK, N, n8, vec_bc);
    cp_async_commit();
  }

  // head phase: tiles (head s, P slice pt, key tile kt) in that order; the
  // staging area now holds two x buffers, the next tile in flight
  const int n_pt = cdiv(P, kBP);
  const long long x_stride = static_cast<long long>(H) * P;
  int ls = 0, lpt = 0, lkt = 0;  // the next tile to load
  auto issue = [&](int buf) {
    if (ls < hs_b) {
      const int p0 = lpt * kBP, k0 = lkt * kBK;
      load_tile(Xs + buf * kBK * kLdX, kLdX, x + ((mQ + k0) * H + h0 + ls) * P + p0, x_stride,
                Q - k0, min(kBP, P - p0), kBP, vec_x);
      if (++lkt > qt) {
        lkt = 0;
        if (++lpt == n_pt) {
          lpt = 0;
          ++ls;
        }
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);
  int buf = 0;
  for (int s = 0; s < hs_b; ++s) {
    const int h = h0 + s;
    const float* cs = cum + s * qpad;
    const float* ds = dts + s * qpad;
    const float ci0 = cs[q0 + wr + gid], ci1 = cs[q0 + wr + gid + 8];
    for (int pt = 0; pt < n_pt; ++pt) {
      float acc[8][4] = {}, big[8][4] = {}, small[8][4] = {};
      const int wk = (warp >> 2) * 32;  // the warp's half of the key tile
      for (int kt = 0; kt <= qt; ++kt) {
        cp_async_wait<1>();
        __syncthreads();
        const float* St = Ss + kt * kBQ * kLdS + (wr + gid) * kLdS;
        const float* Xt = Xs + buf * kBK * kLdX + gid;
        const float* cj = cs + kt * kBK;
        const float* dj = ds + kt * kBK;
        const bool diag = kt == qt;
#pragma unroll
        for (int kk = wk; kk < wk + 32; kk += 8) {
          const int c = kk + tig;
          const float cj0 = cj[c], cj1 = cj[c + 4], dj0 = dj[c], dj1 = dj[c + 4];
          float w[4] = {St[c] * exp2f((ci0 - cj0) * kLog2e) * dj0,
                        St[c + 8 * kLdS] * exp2f((ci1 - cj0) * kLog2e) * dj0,
                        St[c + 4] * exp2f((ci0 - cj1) * kLog2e) * dj1,
                        St[c + 4 + 8 * kLdS] * exp2f((ci1 - cj1) * kLog2e) * dj1};
          if (diag) {  // key j > query i: 0, whatever exp gave (q0 == k0 here)
            const int i = wr + gid;
            w[0] = c <= i ? w[0] : 0.f;
            w[1] = c <= i + 8 ? w[1] : 0.f;
            w[2] = c + 4 <= i ? w[2] : 0.f;
            w[3] = c + 4 <= i + 8 ? w[3] : 0.f;
          }
          uint32_t ah[4], al[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) split(w[t], ah[t], al[t]);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const float* b = Xt + c * kLdX + nt * 8;
            uint32_t bh[2], bl[2];
            split(b[0], bh[0], bl[0]);
            split(b[4 * kLdX], bh[1], bl[1]);
            mma3(big[nt], small[nt], ah, al, bh, bl);
          }
        }
        flush(acc, big, small);  // once per key tile
        __syncthreads();  // x buffer `buf` is free
        issue(buf);
        buf ^= 1;
      }
      // the two key halves' sums meet in shared memory; warps 0-3 store y
      float* red = Xs + 2 * kBK * kLdX + (warp & 3) * 32 * 32 + lane;
      if (warp >= 4) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) red[(nt * 4 + e) * 32] = acc[nt][e];
      }
      __syncthreads();
      if (warp >= 4) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] += red[(nt * 4 + e) * 32];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = q0 + wr + gid + 8 * half;
        if (i >= Q) continue;
        float* yr = y + ((mQ + i) * H + h) * P;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int p = pt * kBP + nt * 8 + 2 * tig;
          const float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
          if (p + 1 < P && (P & 1) == 0) {
            *reinterpret_cast<float2*>(yr + p) = make_float2(v0, v1);
          } else {
            if (p < P) yr[p] = v0;
            if (p + 1 < P) yr[p + 1] = v1;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" {

// Shared memory one block needs at chunk length Q, state size N and hs heads
// per block, in bytes (kernels/ssd_chunk.py smem_bytes computes the same).
long long ssd_chunk_smem_bytes(int Q, int N, int hs) {
  return static_cast<long long>(Smem(Q, N, hs).total * sizeof(float));
}

// K5.  See the note at the top; hs (1..16) is the wrapper's heads per block.
// Returns cudaGetLastError() after the launch.
int ssd_chunk(const void* x, const void* dt, const void* dA, const void* B, const void* C,
              void* y, int M, int Q, int H, int P, int G, int N, int hs, void* stream) {
  if (hs < 1 || hs > kMaxHeads) return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = cdiv(Q, kBQ);
  const int n_slices = cdiv(H / G, hs);
  const size_t smem = Smem(Q, N, hs).total * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec_x = P % 4 == 0 && aligned(x);
  const bool vec_bc = N % 4 == 0 && aligned(B) && aligned(C);
  const long long blocks = static_cast<long long>(M) * G * n_qt * n_slices;
  ssd_chunk_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(dA), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<float*>(y), M, Q, H, P, G, N, hs, n_slices,
      vec_x, vec_bc);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
