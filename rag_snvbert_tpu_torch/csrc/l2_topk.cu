// Exact squared-L2 top-k search for Hopper (sm_90a).
//
// Replaces: rag_snvbert_tpu/ops/l2_topk_pallas.py::_l2_topk_kernel (the
// query-tile-outer Pallas kernel behind l2_topk_pallas), the embedding-space
// search of the V18 serving path.  Semantics are those of ops/l2_ref.py:
//   dist = max(|q|^2 - 2 q.r + |r|^2, 0) in fp32, q.r from bf16 products
//   accumulated in fp32, |q|^2 from the bf16 queries, |r|^2 as given (+inf
//   on padding rows, which therefore rank after every finite row);
//   (vals [B, k] f32, ids [B, k] int32) ascending, ties to the lower id.
// Returned distances are exact fp32 values, not quantized to 2048 ULP as
// the TPU kernel's packed sort keys are (l2_topk_pallas.py:35-42); there is
// no key packing, no query pre-doubling and no -|r|^2-seeded accumulator.
//
// What bounds it on the H100: at the serving shape (q [64, 395520], refs
// [2048, 395520], bf16) one call must read the 1.62 GB reference matrix,
// 0.48 ms at 3.35 TB/s, against 1.04e11 FLOP (0.105 ms of tensor cores):
// it is memory-bound.  The TPU kernel carried the d-axis sum across
// sequential grid steps; GPU blocks run in no order, so the work is split:
//   pass 1: grid (ref tile of 64, d split, query tile of 64).  Each block
//     forms partial dots over its d chunk with mma.sync m16n8k16 (bf16 ->
//     fp32; each 64-wide d step in a fresh accumulator, summed with IEEE
//     adds) and writes them to a [splits, B, N] fp32 workspace.  Splitting
//     d is what fills 132 SMs when B * N is only 64 * 2048.  Blocks of one
//     split run side by side, so its query chunk is read from L2.
//   pass 2: one block per query row sums the partials in a fixed order,
//     forms distances in shared memory and extracts the k smallest by k
//     rounds of a block-wide (distance, id) argmin.
// No atomics: results are bit-identical from run to run.  Loads are
// synchronous 16-byte loads; a cp.async/TMA pipeline is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kTileB = 64;    // queries per pass-1 block (16 per warp)
constexpr int kTileN = 64;    // reference rows per pass-1 block
constexpr int kTileD = 64;    // d step of the pass-1 loop
constexpr int kLds = kTileD + 8;
constexpr int kThreads1 = 128;
constexpr int kThreads2 = 256;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + 64) x columns [col0, col0 + 64) of a [rows, d] matrix
// into shared memory; out-of-range rows and columns become zeros (d is a
// multiple of 8, so a 16-byte vector is wholly in or out).
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int rows, int col0, int d) {
  constexpr int kPerRow = kTileD / 8;
  for (int i = threadIdx.x; i < 64 * kPerRow; i += kThreads1) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows && col0 + c < d) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d +
                                            col0 + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kLds + c) = val;
  }
}

__global__ void __launch_bounds__(kThreads1)
l2_partial_dots(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ r,
                float* __restrict__ part, int B, int N, int d, int chunk) {
  __shared__ __align__(16) __nv_bfloat16 Qs[kTileB * kLds];
  __shared__ __align__(16) __nv_bfloat16 Rs[kTileN * kLds];
  const int n0 = blockIdx.x * kTileN;
  const int split = blockIdx.y;
  const int b0 = blockIdx.z * kTileB;
  const int d0 = split * chunk;
  const int d1 = min(d0 + chunk, d);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  float acc[kTileN / 8][4];
#pragma unroll
  for (int n = 0; n < kTileN / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

  const int row = warp * 16 + g;
  for (int dk = d0; dk < d1; dk += kTileD) {
    load_tile(Qs, q, b0, B, dk, d);
    load_tile(Rs, r, n0, N, dk, d);
    __syncthreads();
    // A fresh accumulator per d step, added to the running sum with IEEE
    // float adds: the tensor cores' fp32 accumulation truncates, and one
    // chain over a whole d chunk (~800 mma steps) drifts by ~3e-5 of the
    // distance scale (measured), 25x the error of a float32 matmul.
    float step[kTileN / 8][4];
#pragma unroll
    for (int n = 0; n < kTileN / 8; ++n) {
      step[n][0] = step[n][1] = step[n][2] = step[n][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < kTileD / 16; ++ks) {
      const int c = ks * 16 + t * 2;
      uint32_t a[4];
      a[0] = ld_pair(Qs + row * kLds + c);
      a[1] = ld_pair(Qs + (row + 8) * kLds + c);
      a[2] = ld_pair(Qs + row * kLds + c + 8);
      a[3] = ld_pair(Qs + (row + 8) * kLds + c + 8);
#pragma unroll
      for (int n = 0; n < kTileN / 8; ++n) {
        const __nv_bfloat16* rr = Rs + (n * 8 + g) * kLds + c;
        mma_bf16(step[n], a, ld_pair(rr), ld_pair(rr + 8));
      }
    }
#pragma unroll
    for (int n = 0; n < kTileN / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][j] += step[n][j];
    }
    __syncthreads();
  }

  const int qb0 = b0 + row, qb1 = qb0 + 8;
#pragma unroll
  for (int n = 0; n < kTileN / 8; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + n * 8 + t * 2 + j;
      if (col >= N) continue;
      if (qb0 < B) part[((size_t)split * B + qb0) * N + col] = acc[n][j];
      if (qb1 < B) part[((size_t)split * B + qb1) * N + col] = acc[n][2 + j];
    }
  }
}

// Lexicographic (distance, id) order: NaN (a taken row) is never smaller.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads2)
l2_select(const __nv_bfloat16* __restrict__ q, const float* __restrict__ part,
          const float* __restrict__ rnorm, float* __restrict__ vals,
          int* __restrict__ ids, int B, int N, int d, int splits, int k) {
  extern __shared__ float dist[];   // [N]
  __shared__ float red_v[kThreads2 / 32];
  __shared__ int red_i[kThreads2 / 32];
  __shared__ float qn_s;
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // |q|^2 of the bf16 query row, in a fixed order.
  float s = 0.f;
  const __nv_bfloat16* qr = q + (size_t)b * d;
  for (int i = threadIdx.x * 8; i < d; i += kThreads2 * 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(qr + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      s = fmaf(f.x, f.x, s);
      s = fmaf(f.y, f.y, s);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffff, s, off);
  if (lane == 0) red_v[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int w = 0; w < kThreads2 / 32; ++w) tot += red_v[w];
    qn_s = tot;
  }
  __syncthreads();
  const float qn = qn_s;

  for (int n = threadIdx.x; n < N; n += kThreads2) {
    float dot = 0.f;
    for (int sp = 0; sp < splits; ++sp) dot += part[((size_t)sp * B + b) * N + n];
    dist[n] = fmaxf(qn - 2.f * dot + rnorm[n], 0.f);
  }
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    float bv = CUDART_INF_F;
    int bi = INT_MAX;
    for (int n = threadIdx.x; n < N; n += kThreads2) {
      const float v = dist[n];
      if (better(v, n, bv, bi)) { bv = v; bi = n; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffff, bv, off);
      const int oi = __shfl_xor_sync(0xffffffff, bi, off);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kThreads2 / 32; ++w) {
        if (better(red_v[w], red_i[w], bv, bi)) { bv = red_v[w]; bi = red_i[w]; }
      }
      vals[(size_t)b * k + j] = bv;
      ids[(size_t)b * k + j] = bi;
      dist[bi] = CUDART_NAN_F;      // taken: never selected again
    }
    __syncthreads();
  }
}

}  // namespace

// q [B, d], r [N, d] bf16 contiguous and 16-byte aligned, d % 8 == 0;
// rnorm [N] f32; part [splits, B, N] f32 workspace; vals [B, k] f32,
// ids [B, k] int32.  chunk is a multiple of 64 with splits * chunk >= d.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int l2_topk_bf16(const void* q, const void* r, const void* rnorm,
                            void* part, void* vals, void* ids, int B, int N,
                            int d, int splits, int chunk, int k,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1((N + kTileN - 1) / kTileN, splits,
                   (B + kTileB - 1) / kTileB);
  l2_partial_dots<<<grid1, kThreads1, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(r), static_cast<float*>(part), B, N,
      d, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)N * sizeof(float);
  err = cudaFuncSetAttribute(l2_select,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  l2_select<<<B, kThreads2, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(part),
      static_cast<const float*>(rnorm), static_cast<float*>(vals),
      static_cast<int*>(ids), B, N, d, splits, k);
  return (int)cudaGetLastError();
}
