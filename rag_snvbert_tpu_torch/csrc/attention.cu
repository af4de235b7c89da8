// Fused attention forward for Hopper (sm_90a): O = softmax(Q K^T * scale) V.
//
// Replaces: rag_snvbert_tpu/models/transformer.py::_splash_attention (the
// splash-attention Pallas kernel, forward), which every encoder layer of
// the `tpu_default` preset runs.  Inputs are bf16 [B, H, L, hd], contiguous;
// the output is bf16 in the same layout.  Scores, the running max, the
// running sum and the accumulator are fp32.  Head dims 32, 64 and 128.
//
// LSE: when the caller passes an ``lse`` pointer (fp32 [B*H, L], training),
// the kernel also writes each valid row's log-sum-exp IN BASE 2 of the
// scaled scores: lse[r] = log2(sum_j 2^(s_rj * scale * log2(e))), i.e. the
// natural log-sum-exp of s*scale times log2(e).  The backward kernel
// (attention_bwd.cu) recomputes P = exp2(s*scale*log2(e) - lse) from it.
// With a null pointer (serving) nothing more is written.
//
// Differences from the TPU kernel, on purpose:
//   * L runs ragged (1030 on the serving path): keys at or past L get
//     P = 0 and rows at or past L are not written, instead of padding to
//     the TPU block multiple (1152) and a static block mask.
//   * splash scales q in bf16 before the product (transformer.py:136); this
//     kernel scales the fp32 scores instead.  The two differ within the
//     bf16 rounding of q.
//
// What bounds it on the H100: at the serving shape [64, 3, 1030, 128] one
// call is 4 * BH * L^2 * hd = 1.04e11 FLOP against 0.20 GB of q/k/v/o, so
// the tensor cores bound it: 0.105 ms at 989 TFLOP/s.  The [L, L] scores
// never reach device memory (online softmax), which is what the splash
// kernel bought on the TPU too.
//
// Design (FlashAttention-3's shape, Shah et al. 2024).  One block of three
// warpgroups per (stream*head, 128-row query tile):
//   * warpgroup 2 is the producer: one thread issues TMA loads of the Q
//     tile once and of K and V tiles of 176 keys into rings of two stages,
//     each stage guarded by a "full" and an "empty" mbarrier.  It keeps 24
//     registers (setmaxnreg) and hands the rest to
//   * warpgroups 0 and 1, the consumers (240 registers), each owning 64
//     query rows.  Per key tile: S = Q K^T as wgmma m64n176k16 with both
//     operands in shared memory (K-major); the online softmax in fp32
//     registers (log2 domain, exp2f, running max and sum); P packed to
//     bf16 in registers, where the accumulator's layout is already the
//     register-A layout of the next product; O += P V as wgmma m64nHDk16
//     with B = V read MN-major (transposed) from shared memory.
//   * S_j is issued together with P_{j-1} V_{j-1}, so tile j's softmax
//     runs while that product does, and the two consumers take turns to
//     issue (named barriers), so that one's softmax also runs while the
//     other's products hold the tensor cores.  At this shape the turns
//     took the kernel from 0.291 to 0.236 ms (H100 80GB HBM3, 700 W;
//     tools/attention_ab.py).
// Key tiles of 176 cover L = 1030 in 6 tiles (1056 keys, 2.5% padding;
// 128 would need 9 tiles, 11.8%).  Query tiles of 128 leave the last one
// 6 rows; a block whose second 64 rows all lie past L runs warpgroup 0
// alone (4.8% off the kernel's time at this shape).  The tensor maps are
// 3-D, [BH, L, hd]: TMA zero-fills rows at or past L inside the head (a
// 2-D [BH*L, hd] map would read the next head's rows), so other rows past
// L are computed on zeros and not written: a branch on the warpgroup
// around its products would make ptxas serialize every wgmma of the
// kernel (hopper.cuh, "wgmma").  Tiles are 128-byte swizzled
// (64-byte at hd 32) panels of 64 columns (hopper.cuh); 208 KB of shared
// memory at hd 128.  The maps reach the kernel as __grid_constant__
// parameters, encoded on the host through the driver entry point that
// hopper.cuh fetches from the runtime (no libcuda link).
// Replaces PR 1's design (four warps, mma.sync m16n8k16, synchronous
// uint4 loads, 64 x 64 tiles: 0.737 ms at this shape).

#include <math_constants.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBlockM = 128;   // query rows per block, 64 per consumer
constexpr int kBlockN = 176;   // keys per tile
constexpr int kStages = 2;
constexpr int kConsumers = 2;  // warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kTurn = 1;       // named barriers kTurn, kTurn + 1

template <int HD>
struct Smem {
  static constexpr int kQ = kBlockM * HD * 2;
  static constexpr int kKV = kBlockN * HD * 2;
  static constexpr int kBars = kQ + 2 * kStages * kKV;  // barrier offset
  static constexpr int kBytes = kBars + (1 + 4 * kStages) * 8 + 1024;
};

// Row max of this thread's two rows (g, g + 8) over the tile, the rows'
// running max updated to it, and the factor exp2((old - new) * scale_log2)
// that rescales what was summed before.  Scores stay unscaled; keys at or
// past L are -inf (only the last tile has any).
__device__ __forceinline__ void tile_max(float (&sc)[kBlockN / 2], int k0,
                                         int L, int t, float& m0, float& m1,
                                         float& c0, float& c1,
                                         float scale_log2) {
  if (k0 + kBlockN > L) {
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (k0 + n * 8 + t * 2 + c >= L) {
          sc[4 * n + c] = -CUDART_INF_F;
          sc[4 * n + 2 + c] = -CUDART_INF_F;
        }
      }
    }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 2));
  // Every tile holds at least one valid key, so mx0/mx1 are finite.
  c0 = exp2f((m0 - mx0) * scale_log2);
  c1 = exp2f((m1 - mx1) * scale_log2);
  m0 = mx0;
  m1 = mx1;
}

// P = exp2(S * scale_log2 - max * scale_log2) in place (one FFMA and one
// exp2 an element), and the rows' sums of P.
__device__ __forceinline__ void tile_exp(float (&sc)[kBlockN / 2], float m0,
                                         float m1, float& s0, float& s1,
                                         float scale_log2) {
  const float b0 = m0 * scale_log2, b1 = m1 * scale_log2;
  s0 = s1 = 0.f;
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
    sc[4 * n + 0] = exp2f(fmaf(sc[4 * n + 0], scale_log2, -b0));
    sc[4 * n + 1] = exp2f(fmaf(sc[4 * n + 1], scale_log2, -b0));
    sc[4 * n + 2] = exp2f(fmaf(sc[4 * n + 2], scale_log2, -b1));
    sc[4 * n + 3] = exp2f(fmaf(sc[4 * n + 3], scale_log2, -b1));
    s0 += sc[4 * n + 0] + sc[4 * n + 1];
    s1 += sc[4 * n + 2] + sc[4 * n + 3];
  }
}

// P packed to bf16: the accumulator's columns 16 kk .. 16 kk + 15 are the
// register-A fragment of K step kk of O += P V.
__device__ __forceinline__ void pack_p(const float (&sc)[kBlockN / 2],
                                       uint32_t (&pa)[kBlockN / 16][4]) {
#pragma unroll
  for (int n = 0; n < kBlockN / 8; ++n) {
    pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(sc[4 * n + 0], sc[4 * n + 1]);
    pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int L, float scale_log2) {
  using S = Smem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* q_tile = smem;
  // K and V have rings of their own: K of tile j is free once S_j is done,
  // V of tile j only after P_j V_j, one step later.
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;
  auto k_tile = [&](int s) { return smem + S::kQ + s * S::kKV; };
  auto v_tile = [&](int s) { return smem + S::kQ + (kStages + s) * S::kKV; };

  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int n_tiles = (L + kBlockN - 1) / kBlockN;
  const int wg = warpgroup();
  // A block whose rows past its first 64 all lie past L (the last one of
  // a head at L = 1030) runs warpgroup 0 alone: warpgroup 1 would only
  // compute on zero-filled rows.
  const int consumers = L - q0 <= 64 ? 1 : kConsumers;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 4 * consumers);  // one arrival per warp
      mbar_init(&v_empty[s], 4 * consumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer ----
    reg_dealloc<24>();
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(q_full, S::kQ);
      tma_tile<HD>(q_tile, &tm_q, q_full, kBlockM, q0, head);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t ph = ((j / kStages) & 1) ^ 1;
        if (j >= kStages) mbar_wait(&k_empty[s], ph);
        mbar_expect_tx(&k_full[s], S::kKV);
        tma_tile<HD>(k_tile(s), &tm_k, &k_full[s], kBlockN, j * kBlockN,
                     head);
        if (j >= kStages) mbar_wait(&v_empty[s], ph);
        mbar_expect_tx(&v_full[s], S::kKV);
        tma_tile<HD>(v_tile(s), &tm_v, &v_full[s], kBlockN, j * kBlockN,
                     head);
      }
    }
  } else if (wg < consumers) {
    // ---- consumers ----
    reg_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;  // accumulator row group
    const int t = lane & 3;   // thread in group
    const uint32_t q_addr = smem_u32(q_tile);

    // Rows g and g + 8 of the warp's 16: running max of the unscaled
    // scores, running sum of P.
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float sc[kBlockN / 2];
    uint32_t pa[kBlockN / 16][4];

    auto issue_s = [&](int j) {  // S_j = Q K_j^T, K-major operands
      const uint32_t k_addr = smem_u32(k_tile(j % kStages));
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        Wgmma<kBlockN>::template ss<0>(
            sc, desc_k<HD>(q_addr, kBlockM, 64 * wg, kk),
            desc_k<HD>(k_addr, kBlockN, 0, kk), kk > 0);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int j) {  // O += P_j V_j, V MN-major
      const uint32_t v_addr = smem_u32(v_tile(j % kStages));
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        Wgmma<HD>::template rs<1>(acc, pa[kk],
                                  desc_mn<HD>(v_addr, kBlockN, kk), 1);
      }
      wgmma_commit();
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // Turns (FA3's ping-pong): named barrier kTurn + w opens warpgroup w's
    // turn to issue; the other warpgroup opens it after issuing its own.
    // Warpgroup 0 goes first; each barrier sees n_tiles syncs and n_tiles
    // arrivals, so none is left half-arrived when the block ends.
    auto my_turn = [&] {
      if (consumers > 1) bar_sync(kTurn + wg, 256);
    };
    auto pass_turn = [&] {
      if (consumers > 1) bar_arrive(kTurn + 1 - wg, 256);
    };
    if (wg == 1) pass_turn();

    // Tile 0: S_0 alone.  Then tile j's S is issued together with
    // P_{j-1} V_{j-1}, and tile j's max and exp2 run while that product
    // runs; O is rescaled only after it completes.
    float c0, c1, s0, s1;  // the tile's rescale factors and sums of P
    auto softmax = [&](int j) {
      tile_max(sc, j * kBlockN, L, t, m0, m1, c0, c1, scale_log2);
      tile_exp(sc, m0, m1, s0, s1, scale_log2);
    };
    auto rescale = [&] {  // after the last product into acc has completed
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        acc[4 * i + 0] *= c0;
        acc[4 * i + 1] *= c0;
        acc[4 * i + 2] *= c1;
        acc[4 * i + 3] *= c1;
      }
      l0 = l0 * c0 + s0;
      l1 = l1 * c1 + s1;
      pack_p(sc, pa);
    };
    mbar_wait(q_full, 0);
    mbar_wait(&k_full[0], 0);
    my_turn();
    fence_regs(sc);
    wgmma_fence();
    issue_s(0);
    if (wg == 0 || n_tiles > 1) pass_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    release(&k_empty[0]);
    softmax(0);
    rescale();
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(&k_full[s], (j / kStages) & 1);
      mbar_wait(&v_full[(j - 1) % kStages], ((j - 1) / kStages) & 1);
      my_turn();
      fence_regs(sc);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      issue_s(j);
      issue_pv(j - 1);
      if (wg == 0 || j < n_tiles - 1) pass_turn();
      wgmma_wait<1>();
      fence_regs(sc);
      release(&k_empty[s]);
      softmax(j);
      wgmma_wait<0>();
      // P_{j-1} V_{j-1} read pa until here: keep its registers from reuse.
      fence_regs(acc);
      fence_regs(pa);
      rescale();
      release(&v_empty[(j - 1) % kStages]);
    }
    const int last = n_tiles - 1;
    mbar_wait(&v_full[last % kStages], (last / kStages) & 1);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
    issue_pv(last);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    release(&v_empty[last % kStages]);

    l0 += __shfl_xor_sync(0xffffffff, l0, 1);
    l0 += __shfl_xor_sync(0xffffffff, l0, 2);
    l1 += __shfl_xor_sync(0xffffffff, l1, 1);
    l1 += __shfl_xor_sync(0xffffffff, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int row0 = q0 + 64 * wg + 16 * warp + g, row1 = row0 + 8;
    const size_t rows = (size_t)head * L;
    if (lse != nullptr && t == 0) {
      // m is the unscaled row max, l the sum of exp2((s - m) * scale).
      if (row0 < L) lse[rows + row0] = m0 * scale_log2 + log2f(l0);
      if (row1 < L) lse[rows + row1] = m1 * scale_log2 + log2f(l1);
    }
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int c = i * 8 + t * 2;
      if (row0 < L) {
        *reinterpret_cast<uint32_t*>(o + (rows + row0) * HD + c) =
            pack_bf16(acc[4 * i + 0] * inv0, acc[4 * i + 1] * inv0);
      }
      if (row1 < L) {
        *reinterpret_cast<uint32_t*>(o + (rows + row1) * HD + c) =
            pack_bf16(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int L, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map<HD>(&tm_q, q, bh, L, kBlockM) ||
      !make_map<HD>(&tm_k, k, bh, L, kBlockN) ||
      !make_map<HD>(&tm_v, v, bh, L, kBlockN)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int smem = Smem<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kBlockM - 1) / kBlockM, bh);
  attention_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, L,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: bf16 [bh, L, hd] contiguous, 16-byte aligned; lse: fp32
// [bh, L] (base 2, see above) or null.  Returns the CUDA error code of the
// launch (0 on success; cudaErrorInvalidValue also when the driver refuses
// a tensor map).
extern "C" int attention_fwd_bf16(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int bh, int L, int hd,
                                  float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 32: return launch<32>(q, k, v, o, l, bh, L, scale, s);
    case 64: return launch<64>(q, k, v, o, l, bh, L, scale, s);
    case 128: return launch<128>(q, k, v, o, l, bh, L, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
