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
//   pass 1, l2_partial_dots: grid (ref tile of 128 rows, d split, query
//     tile of 64).  One block is a producer warpgroup and a consumer
//     warpgroup.  One producer thread keeps a ring of kStages stages in
//     flight by TMA: a stage is 128 columns of d (two 64-column panels,
//     256 contiguous bytes of each row) of the 128 ref rows and of the 64
//     queries, 48 KB, 128-byte swizzled, each stage under a "full" and an
//     "empty" mbarrier.  Rows past N or B and columns past d are zeros
//     from the tensor maps' bounds, not from checks in the kernel.  The
//     consumer multiplies each stage with eight wgmma m64n128k16 (both
//     operands K-major in shared memory) into a fresh accumulator
//     (scale-d 0 on the first product) and adds that to the running sum
//     with IEEE adds: the tensor cores' fp32 accumulation truncates, and
//     one chain over a whole d chunk drifts by ~3e-5 of the distance
//     scale, 25x the error of a float32 matmul.  With 128-column steps
//     the k = 1 distances stay within 2.5e-7 of float64, relative to
//     |q|^2 + |r|^2 (the float32 matmul of the plain version: 2.0e-6;
//     chip_smoke.py prints both).  The partial dots go to a
//     [splits, B, N] fp32 workspace.  Splitting d is what fills the SMs
//     when B * N is only 64 * 2048: the wrapper picks the splits so that
//     the grid is four full waves of one block an SM (16 ref tiles x 33
//     splits = 4 x 132; one wave of 8 splits leaves 4 SMs idle and
//     measured 0.6145 ms against 0.6000).  Blocks of one split run side by
//     side, so the query chunk, loaded once per 128 ref rows, comes from
//     L2.  The blocks of ref tile 0 also sum the squares of their query
//     tiles where they sit in shared memory, per stage and then across
//     stages, into a [splits, B] workspace.
//   pass 2, l2_select: one block of 512 threads per query row sums |q|^2
//     and the partial dots over the splits in split order, forms distances
//     in shared memory and extracts the k smallest by k rounds of a
//     block-wide (distance, id) argmin.  The shared-memory limits of both
//     kernels are raised once a process, not once a call.
// No atomics and every sum in a fixed order: reruns are bit-identical.
// The consumer needs no setmaxnreg: at 256 threads a block, one block an
// SM, every thread may hold 255 registers from the start.
// Replaces the first design (four warps, mma.sync m16n8k16, synchronous
// 16-byte loads of 64 x 64 tiles, |q|^2 re-read from device memory in
// pass 2).

#include <math_constants.h>

#include <climits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTileB = 64;     // queries per pass-1 block: one m64 tile
constexpr int kTileN = 128;    // reference rows per pass-1 block: wgmma's n
constexpr int kPanels = 2;     // 64-column panels per stage
constexpr int kStageD = 64 * kPanels;   // columns of d per stage
constexpr int kStages = 4;
constexpr int kThreads1 = 256;  // consumer warpgroup 0, producer warpgroup 1
constexpr int kThreads2 = 512;
constexpr int kQPanel = kTileB * 128;   // bytes
constexpr int kRPanel = kTileN * 128;
constexpr int kStageBytes = kPanels * (kQPanel + kRPanel);
constexpr int kSmem1 = kStages * kStageBytes + 2 * kStages * 8 + 1024;
constexpr int kMaxN = 49152;   // pass 2: one float per ref row in shared memory

// Sum of squares of 8 bf16 values.
__device__ __forceinline__ float sq8(const uint4& raw, float s) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    s = fmaf(f.x, f.x, s);
    s = fmaf(f.y, f.y, s);
  }
  return s;
}

__global__ void __launch_bounds__(kThreads1, 1)
l2_partial_dots(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_r,
                float* __restrict__ part, float* __restrict__ qn_part, int B,
                int N, int d, int chunk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * kTileN;
  const int split = blockIdx.y;
  const int b0 = blockIdx.z * kTileB;
  const int d0 = split * chunk;
  const int d1 = min(d0 + chunk, d);
  const int steps = (d1 - d0 + kStageD - 1) / kStageD;
  const int wg = warpgroup();

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 1) {
    // ---- producer: one thread, TMA ----
    if (threadIdx.x == 128) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        uint8_t* stage = smem + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          const int col = d0 + i * kStageD + p * 64;
          tma_load_2d(stage + p * kQPanel, &tm_q, &full[s], col, b0);
          tma_load_2d(stage + kPanels * kQPanel + p * kRPanel, &tm_r,
                      &full[s], col, n0);
        }
      }
    }
  } else {
    // ---- consumer ----
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const bool norms = blockIdx.x == 0;   // this block sums |q|^2 too
    const int qrow = tid >> 1;            // its half row of the query tile
    const int half = tid & 1;

    float acc[kTileN / 2], step[kTileN / 2];
#pragma unroll
    for (int j = 0; j < kTileN / 2; ++j) acc[j] = 0.f;
    float qsum = 0.f;

    for (int i = 0; i < steps; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* stage = smem + s * kStageBytes;
      const uint32_t q_addr = smem_u32(stage);
      const uint32_t r_addr = q_addr + kPanels * kQPanel;
      fence_regs(step);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < kPanels; ++p) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          Wgmma<kTileN>::template ss<0>(
              step, desc_k128(q_addr + p * kQPanel, 0, kk),
              desc_k128(r_addr + p * kRPanel, 0, kk), (p | kk) != 0);
        }
      }
      wgmma_commit();
      if (norms) {
        // The swizzle permutes 16-byte groups inside a row: the sum over
        // the row's eight groups does not care which is which.  Each
        // thread takes four groups of each panel of its row, rotated by
        // the row so that neighbouring threads hit other banks.
        float ssum = 0.f;
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          const uint4* row = reinterpret_cast<const uint4*>(
              stage + p * kQPanel + qrow * 128 + half * 64);
#pragma unroll
          for (int j = 0; j < 4; ++j) ssum = sq8(row[(j + qrow) & 3], ssum);
        }
        qsum += ssum;
      }
      wgmma_wait<0>();
      fence_regs(step);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int j = 0; j < kTileN / 2; ++j) acc[j] += step[j];
    }

    if (norms) {
      qsum += __shfl_xor_sync(0xffffffff, qsum, 1);
      if (half == 0 && b0 + qrow < B) {
        qn_part[(size_t)split * B + b0 + qrow] = qsum;
      }
    }
    const int qb0 = b0 + warp * 16 + g, qb1 = qb0 + 8;
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = n0 + j * 8 + t * 2 + c;
        if (col >= N) continue;
        if (qb0 < B) part[((size_t)split * B + qb0) * N + col] = acc[4 * j + c];
        if (qb1 < B) {
          part[((size_t)split * B + qb1) * N + col] = acc[4 * j + 2 + c];
        }
      }
    }
  }
}

// Lexicographic (distance, id) order: NaN (a taken row) is never smaller.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads2)
l2_select(const float* __restrict__ part, const float* __restrict__ qn_part,
          const float* __restrict__ rnorm, float* __restrict__ vals,
          int* __restrict__ ids, int B, int N, int splits, int k) {
  extern __shared__ float dist[];   // [N]
  __shared__ float red_v[kThreads2 / 32];
  __shared__ int red_i[kThreads2 / 32];
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float qn = 0.f;   // every thread sums the same values in the same order
  for (int sp = 0; sp < splits; ++sp) qn += qn_part[(size_t)sp * B + b];

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

// The two kernels' dynamic shared memory limits, raised at every launch:
// an attribute holds for the current device alone, and a process may
// search on more than one card.
cudaError_t set_limits() {
  cudaError_t err = cudaFuncSetAttribute(
      l2_partial_dots, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem1);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(l2_select,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxN * (int)sizeof(float));
}

}  // namespace

// q [B, d], r [N, d] bf16 contiguous and 16-byte aligned, d % 8 == 0 (the
// row stride TMA needs), N <= 49152; rnorm [N] f32; part: fp32 workspace
// of splits * B * (N + 1) values (the partial dots [splits, B, N], then
// the partial |q|^2 [splits, B]); vals [B, k] f32, ids [B, k] int32.
// chunk is a multiple of 128 with splits * chunk >= d.  Returns the CUDA
// error code of the launches (0 on success; cudaErrorInvalidValue also
// when a tensor map cannot be encoded).
extern "C" int l2_topk_bf16(const void* q, const void* r, const void* rnorm,
                            void* part, void* vals, void* ids, int B, int N,
                            int d, int splits, int chunk, int k,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk % kStageD != 0 || N > kMaxN || d % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = set_limits();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tm_q, tm_r;
  if (!make_map_2d(&tm_q, q, true, B, d, (uint64_t)d * 2, kTileB) ||
      !make_map_2d(&tm_r, r, true, N, d, (uint64_t)d * 2, kTileN)) {
    return (int)cudaErrorInvalidValue;
  }
  float* dots = static_cast<float*>(part);
  float* qn_part = dots + (size_t)splits * B * N;
  const dim3 grid1((N + kTileN - 1) / kTileN, splits,
                   (B + kTileB - 1) / kTileB);
  l2_partial_dots<<<grid1, kThreads1, kSmem1, s>>>(tm_q, tm_r, dots, qn_part,
                                                   B, N, d, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  l2_select<<<B, kThreads2, (size_t)N * sizeof(float), s>>>(
      dots, qn_part, static_cast<const float*>(rnorm),
      static_cast<float*>(vals), static_cast<int*>(ids), B, N, splits, k);
  return (int)cudaGetLastError();
}
