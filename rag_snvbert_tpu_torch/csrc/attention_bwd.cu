// Attention backward for Hopper (sm_90a): dQ, dK, dV of
// O = softmax(Q K^T * scale) V, from Q, K, V, O, dO and the forward's LSE.
//
// Replaces: the splash-attention fused dq/dkv backward Pallas kernel
// (rag_snvbert_tpu/models/transformer.py:141-145, ``use_fused_bwd_kernel=
// True``), which every encoder layer of the `tpu_default` preset runs in
// training.  Inputs are bf16 [B*H, L, hd] contiguous, the LSE fp32 [B*H, L]
// in base 2 as attention.cu writes it; dQ, dK, dV are bf16 in the input
// layout.  Head dims 32, 64 and 128.
//
// The function, written out (the plain version in ops/attention.py is the
// same recompute): P = exp2(S*scale*log2(e) - lse) with S = Q K^T;
// dV = P^T dO; dP = dO V^T; D = rowsum(dO o O); dS = P o (dP - D);
// dQ = dS K * scale; dK = dS^T Q * scale.
//
// What bounds it on the H100: at the training shape [48, 3, 1030, 128] the
// five products are 10*BH*L^2*hd = 1.96e11 FLOP, about 0.198 ms at the bf16
// tensor-core peak (989 TFLOP/s); q, k, v, o, dO read once and dq, dk, dv
// written once are 0.30 GB, 0.09 ms at 3.35 TB/s.  So the tensor cores bound
// it.  The dQ pass below recomputes S and dP (two products of the seven
// this design runs): 4 of the 10 * BH * L^2 * hd FLOP on top of the
// bound's, so at best 71% (5/7) of the bound is reachable this way.
//
// Design.  Splash accumulates dq across sequential TPU grid steps; GPU
// blocks run in no order, so the work is split into two launches on one
// stream, neither with atomics (runs are bit-identical).  Each block is two
// consumer warpgroups of 64 rows (240 registers each, setmaxnreg) and a
// producer warpgroup (24) whose first thread keeps TMA loads in flight
// through a three-stage mbarrier ring:
//   (a) dQ pass, one block per (stream*head, 128-query tile).  The
//       consumers first compute D = rowsum(dO o O) of their own rows
//       (written to the ``dsum`` scratch for pass (b), which replaces
//       PR 2's separate row-dot launch and its second read of dO) while
//       the Q and dO tiles (once) and the first 64-key K and V tiles
//       arrive.  Per key tile: S = Q K^T and dP = dO V^T as wgmma
//       m64n64k16 from shared memory; P = exp2(S scale log2(e) - lse)
//       while dP is in flight; dS = P (dP - D) packed to bf16 is the
//       register A operand of dQ += dS K (B = K read MN-major), issued
//       with the next tile's S and dP.
//   (b) dK/dV pass, one block per (stream*head, 128-key tile).  K and V are
//       loaded once and stay resident; 64-query tiles of Q and dO stream
//       through the ring, and the LSE and D of those queries through the
//       same stages (a second producer warp, plain loads: their rows are
//       not 16-byte aligned for a bulk copy).  S^T = K Q^T and dP^T =
//       V dO^T are wgmmas with keys as rows, so P^T and dS^T come out as
//       accumulators and, packed to bf16, are the register A operands of
//       dV += P^T dO (issued while dS^T is computed) and dK += dS^T Q.
//       dK and dV accumulate in fp32 registers.
// In both passes the consumers take turns to issue (named barriers, as in
// attention.cu), so one's exp2 and dS run while the other's products hold
// the tensor cores: 0.736 -> 0.690 ms at the training shape on an H100
// 80GB HBM3 at 700 W (tools/attention_ab.py).  P and dS are
// rounded to bf16 as product operands.  L runs ragged: the 3-D tensor maps
// zero-fill rows at or past L inside each head, keys at or past L get
// P = 0, and rows at or past L are never written.  A block whose second 64
// rows all lie past L runs warpgroup 0 alone; other rows past L are
// computed on zeros rather than branch on the warpgroup around the
// products (such a branch made ptxas serialize every wgmma).  Replaces PR 2's
// design (three launches: a row-dot pass for D, dK/dV and dQ passes of four
// warps with mma.sync m16n8k16 and synchronous uint4 loads: 2.03 ms at
// this shape).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBlock = 128;    // rows a block: queries (a), keys (b)
constexpr int kTile = 64;      // streamed keys (a), queries (b) a stage
constexpr int kStages = 3;
constexpr int kConsumers = 2;  // warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kTurn = 3;       // named barriers kTurn, kTurn + 1 (dQ pass)

template <int HD>
struct SmemDq {
  static constexpr int kBig = kBlock * HD * 2;   // Q or dO
  static constexpr int kSmall = kTile * HD * 2;  // K or V a stage
  static constexpr int kBars = 2 * kBig + 2 * kStages * kSmall;
  static constexpr int kD = kBars + (1 + 2 * kStages) * 8;  // D, 128 fp32
  static constexpr int kBytes = kD + kBlock * 4 + 1024;
};

template <int HD>
struct SmemDkv {
  static constexpr int kBig = kBlock * HD * 2;   // K or V
  static constexpr int kSmall = kTile * HD * 2;  // Q or dO a stage
  static constexpr int kStats = kBig * 2 + 2 * kStages * kSmall;  // lse, D
  static constexpr int kBars = kStats + kStages * 2 * kTile * 4;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
};

// (a) dQ (and D) for one (stream*head, 128-query tile).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ dsum,
                        __nv_bfloat16* __restrict__ dq, int L, float scale,
                        float scale_log2) {
  using S = SmemDq<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* q_tile = smem;
  uint8_t* do_tile = smem + S::kBig;
  auto k_tile = [&](int s) { return smem + 2 * S::kBig + s * S::kSmall; };
  auto v_tile = [&](int s) {
    return smem + 2 * S::kBig + (kStages + s) * S::kSmall;
  };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;
  float* d_s = reinterpret_cast<float*>(smem + S::kD);

  const int head = blockIdx.y;
  const int q0 = blockIdx.x * kBlock;
  const int n_tiles = (L + kTile - 1) / kTile;
  const int wg = warpgroup();
  // A block whose rows past its first 64 all lie past L (the last one of
  // a head at L = 1030) runs warpgroup 0 alone: warpgroup 1 would only
  // compute on zero-filled rows.
  const int consumers = L - q0 <= 64 ? 1 : kConsumers;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * consumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer ----
    reg_dealloc<24>();
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(q_full, 2 * S::kBig);
      tma_tile<HD>(q_tile, &tm_q, q_full, kBlock, q0, head);
      tma_tile<HD>(do_tile, &tm_do, q_full, kBlock, q0, head);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * S::kSmall);
        tma_tile<HD>(k_tile(s), &tm_k, &full[s], kTile, j * kTile, head);
        tma_tile<HD>(v_tile(s), &tm_v, &full[s], kTile, j * kTile, head);
      }
    }
  } else if (wg < consumers) {
    // ---- consumers ----
    reg_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const size_t rows = (size_t)head * L;

    // D = rowsum(dO o O) of this warpgroup's 64 rows, two threads a row,
    // 16-byte loads; rows at or past L get 0.
    {
      const int r = q0 + 64 * wg + tid / 2;
      float d = 0.f;
      if (r < L) {
        const uint4* a = reinterpret_cast<const uint4*>(
            o + (rows + r) * HD + (tid % 2) * (HD / 2));
        const uint4* b = reinterpret_cast<const uint4*>(
            dout + (rows + r) * HD + (tid % 2) * (HD / 2));
#pragma unroll
        for (int i = 0; i < HD / 16; ++i) {
          const uint4 x = a[i], y = b[i];
          const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
          const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 xf = __bfloat1622float2(x2[e]);
            const float2 yf = __bfloat1622float2(y2[e]);
            d += xf.x * yf.x + xf.y * yf.y;
          }
        }
      }
      d += __shfl_xor_sync(0xffffffff, d, 1);
      if (tid % 2 == 0) {
        d_s[64 * wg + tid / 2] = d;
        if (r < L) dsum[rows + r] = d;
      }
      bar_sync(1 + wg, 128);
    }
    const int r0 = 16 * warp + g;  // this thread's rows r0, r0 + 8
    const int row0 = q0 + 64 * wg + r0, row1 = row0 + 8;
    const float d0 = d_s[64 * wg + r0], d1 = d_s[64 * wg + r0 + 8];
    const float l0 = row0 < L ? lse[rows + row0] : 0.f;
    const float l1 = row1 < L ? lse[rows + row1] : 0.f;
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    };
    const uint32_t q_addr = smem_u32(q_tile), do_addr = smem_u32(do_tile);
    float sc[kTile / 2], dp[kTile / 2];
    uint32_t dsa[kTile / 16][4];
    auto issue_dq = [&](int s) {  // dQ += dS K, K MN-major
      const uint32_t k_addr = smem_u32(k_tile(s));
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        Wgmma<HD>::template rs<1>(acc, dsa[kk],
                                  desc_mn<HD>(k_addr, kTile, kk), 1);
      }
      wgmma_commit();
    };
    // Per key tile j, three wgmma groups: S_j, dP_j and dQ += dS_j K_j.
    // The consumers take turns (as in attention.cu) to issue dQ_{j-1}, S_j
    // and dP_j together; P_j's exp2 runs while dP_j is in flight, and dS_j
    // while the other warpgroup's products run.  Stage j - 1 is released
    // once the wait for S_j has retired dQ_{j-1}, the last product to read
    // it.
    auto my_turn = [&] {
      if (consumers > 1) bar_sync(kTurn + wg, 256);
    };
    auto pass_turn = [&] {
      if (consumers > 1) bar_arrive(kTurn + 1 - wg, 256);
    };
    if (wg == 1) pass_turn();
    mbar_wait(q_full, 0);
    fence_regs(acc);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      mbar_wait(&full[s], (j / kStages) & 1);
      my_turn();
      const uint32_t k_addr = smem_u32(k_tile(s));
      const uint32_t v_addr = smem_u32(v_tile(s));
      fence_regs(sc);
      fence_regs(dp);
      fence_regs(dsa);
      wgmma_fence();
      if (j > 0) issue_dq((j - 1) % kStages);
      // S = Q K^T and dP = dO V^T for 64 queries x 64 keys.
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        Wgmma<kTile>::template ss<0>(
            sc, desc_k<HD>(q_addr, kBlock, 64 * wg, kk),
            desc_k<HD>(k_addr, kTile, 0, kk), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        Wgmma<kTile>::template ss<0>(
            dp, desc_k<HD>(do_addr, kBlock, 64 * wg, kk),
            desc_k<HD>(v_addr, kTile, 0, kk), kk > 0);
      }
      wgmma_commit();
      if (wg == 0 || j < n_tiles - 1) pass_turn();
      wgmma_wait<1>();
      fence_regs(sc);
      // dQ_{j-1} read dsa until here: keep its registers from reuse.
      fence_regs(dsa);
      if (j > 0) release((j - 1) % kStages);
      // P = exp2(S * scale_log2 - lse), 0 for keys at or past L.
      const int k0 = j * kTile;
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool ok = k0 + n * 8 + t * 2 + c < L;
          sc[4 * n + c] = ok ? exp2f(sc[4 * n + c] * scale_log2 - l0) : 0.f;
          sc[4 * n + 2 + c] =
              ok ? exp2f(sc[4 * n + 2 + c] * scale_log2 - l1) : 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS = P (dP - D), packed as the A fragments of dQ += dS K.
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        dsa[n / 2][(n % 2) * 2 + 0] =
            pack_bf16(sc[4 * n + 0] * (dp[4 * n + 0] - d0),
                      sc[4 * n + 1] * (dp[4 * n + 1] - d0));
        dsa[n / 2][(n % 2) * 2 + 1] =
            pack_bf16(sc[4 * n + 2] * (dp[4 * n + 2] - d1),
                      sc[4 * n + 3] * (dp[4 * n + 3] - d1));
      }
    }
    fence_regs(dsa);
    wgmma_fence();
    issue_dq((n_tiles - 1) % kStages);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(dsa);
    release((n_tiles - 1) % kStages);

#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int c = i * 8 + t * 2;
      if (row0 < L) {
        *reinterpret_cast<uint32_t*>(dq + (rows + row0) * HD + c) =
            pack_bf16(acc[4 * i + 0] * scale, acc[4 * i + 1] * scale);
      }
      if (row1 < L) {
        *reinterpret_cast<uint32_t*>(dq + (rows + row1) * HD + c) =
            pack_bf16(acc[4 * i + 2] * scale, acc[4 * i + 3] * scale);
      }
    }
  }
}

// (b) dK, dV for one (stream*head, 128-key tile).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attention_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int L, float scale,
                         float scale_log2) {
  using S = SmemDkv<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* k_tile = smem;
  uint8_t* v_tile = smem + S::kBig;
  auto q_tile = [&](int s) { return smem + 2 * S::kBig + s * S::kSmall; };
  auto do_tile = [&](int s) {
    return smem + 2 * S::kBig + (kStages + s) * S::kSmall;
  };
  // Stage s: the LSE of its kTile queries, then their D.
  auto stats = [&](int s) {
    return reinterpret_cast<float*>(smem + S::kStats) + s * 2 * kTile;
  };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int head = blockIdx.y;
  const int k0 = blockIdx.x * kBlock;
  const int n_tiles = (L + kTile - 1) / kTile;
  const int wg = warpgroup();
  // A block whose rows past its first 64 all lie past L (the last one of
  // a head at L = 1030) runs warpgroup 0 alone: warpgroup 1 would only
  // compute on zero-filled rows.
  const int consumers = L - k0 <= 64 ? 1 : kConsumers;
  const size_t rows = (size_t)head * L;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread's arrival + the 32 lanes that store LSE and D
      mbar_init(&full[s], 1 + 32);
      mbar_init(&empty[s], 4 * consumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: warp 0 issues TMA, warp 1 stages LSE and D ----
    reg_dealloc<24>();
    const int pw = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    if (pw == 0 && lane == 0) {
      mbar_expect_tx(kv_full, 2 * S::kBig);
      tma_tile<HD>(k_tile, &tm_k, kv_full, kBlock, k0, head);
      tma_tile<HD>(v_tile, &tm_v, kv_full, kBlock, k0, head);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * S::kSmall);
        tma_tile<HD>(q_tile(s), &tm_q, &full[s], kTile, i * kTile, head);
        tma_tile<HD>(do_tile(s), &tm_do, &full[s], kTile, i * kTile, head);
      }
    } else if (pw == 1) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        float* st = stats(s);
#pragma unroll
        for (int e = lane; e < kTile; e += 32) {
          const int qi = i * kTile + e;
          st[e] = qi < L ? lse[rows + qi] : 0.f;
          st[kTile + e] = qi < L ? dsum[rows + qi] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else if (wg < consumers) {
    // ---- consumers ----
    reg_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const uint32_t k_addr = smem_u32(k_tile), v_addr = smem_u32(v_tile);

    float dv_acc[HD / 2], dk_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;
    fence_regs(dv_acc);
    fence_regs(dk_acc);

    // The consumers take turns to issue S^T and dP^T (as in the dQ pass).
    auto my_turn = [&] {
      if (consumers > 1) bar_sync(kTurn + wg, 256);
    };
    auto pass_turn = [&] {
      if (consumers > 1) bar_arrive(kTurn + 1 - wg, 256);
    };
    if (wg == 1) pass_turn();
    float sc[kTile / 2], dp[kTile / 2];
    uint32_t pa[kTile / 16][4], dsa[kTile / 16][4];
    mbar_wait(kv_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint32_t q_addr = smem_u32(q_tile(s));
      const uint32_t do_addr = smem_u32(do_tile(s));
      const float* st = stats(s);
      my_turn();
      // S^T = K Q^T and dP^T = V dO^T for 64 keys x 64 queries.
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        Wgmma<kTile>::template ss<0>(
            sc, desc_k<HD>(k_addr, kBlock, 64 * wg, kk),
            desc_k<HD>(q_addr, kTile, 0, kk), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        Wgmma<kTile>::template ss<0>(
            dp, desc_k<HD>(v_addr, kBlock, 64 * wg, kk),
            desc_k<HD>(do_addr, kTile, 0, kk), kk > 0);
      }
      wgmma_commit();
      if (wg == 0 || i < n_tiles - 1) pass_turn();
      wgmma_wait<1>();
      fence_regs(sc);

      // P^T = exp2(S^T * scale_log2 - lse[query]), 0 for queries at or
      // past L, while dP^T is in flight; packed as A fragments (16
      // queries a K step).
      const int qt0 = i * kTile;
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = n * 8 + t * 2 + c;
          const bool ok = qt0 + qi < L;
          const float l = st[qi];
          sc[4 * n + c] = ok ? exp2f(sc[4 * n + c] * scale_log2 - l) : 0.f;
          sc[4 * n + 2 + c] =
              ok ? exp2f(sc[4 * n + 2 + c] * scale_log2 - l) : 0.f;
        }
        pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(sc[4 * n], sc[4 * n + 1]);
        pa[n / 2][(n % 2) * 2 + 1] =
            pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
      }
      // dV += P^T dO, dO MN-major, in flight while dS^T is computed.
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        Wgmma<HD>::template rs<1>(dv_acc, pa[kk],
                                  desc_mn<HD>(do_addr, kTile, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(dp);
      // dS^T = P^T (dP^T - D[query]).
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
        const int qi = n * 8 + t * 2;
        const float dd0 = st[kTile + qi], dd1 = st[kTile + qi + 1];
        dsa[n / 2][(n % 2) * 2 + 0] =
            pack_bf16(sc[4 * n + 0] * (dp[4 * n + 0] - dd0),
                      sc[4 * n + 1] * (dp[4 * n + 1] - dd1));
        dsa[n / 2][(n % 2) * 2 + 1] =
            pack_bf16(sc[4 * n + 2] * (dp[4 * n + 2] - dd0),
                      sc[4 * n + 3] * (dp[4 * n + 3] - dd1));
      }
      // dK += dS^T Q, Q MN-major.
      fence_regs(dsa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        Wgmma<HD>::template rs<1>(dk_acc, dsa[kk],
                                  desc_mn<HD>(q_addr, kTile, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(dsa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const int row0 = k0 + 64 * wg + 16 * warp + g, row1 = row0 + 8;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int c = i * 8 + t * 2;
      if (row0 < L) {
        const size_t at = (rows + row0) * HD + c;
        *reinterpret_cast<uint32_t*>(dv + at) =
            pack_bf16(dv_acc[4 * i + 0], dv_acc[4 * i + 1]);
        *reinterpret_cast<uint32_t*>(dk + at) =
            pack_bf16(dk_acc[4 * i + 0] * scale, dk_acc[4 * i + 1] * scale);
      }
      if (row1 < L) {
        const size_t at = (rows + row1) * HD + c;
        *reinterpret_cast<uint32_t*>(dv + at) =
            pack_bf16(dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
        *reinterpret_cast<uint32_t*>(dk + at) =
            pack_bf16(dk_acc[4 * i + 2] * scale, dk_acc[4 * i + 3] * scale);
      }
    }
  }
}

template <int HD>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, const __nv_bfloat16* o,
           const float* lse, const __nv_bfloat16* dout, __nv_bfloat16* dq,
           __nv_bfloat16* dk, __nv_bfloat16* dv, float* dsum, int bh, int L,
           float scale, cudaStream_t stream) {
  // Maps with 128-row boxes (the block's own rows) and 64-row boxes (the
  // streamed tiles).
  CUtensorMap q_big, do_big, k_small, v_small, k_big, v_big, q_small,
      do_small;
  if (!make_map<HD>(&q_big, q, bh, L, kBlock) ||
      !make_map<HD>(&do_big, dout, bh, L, kBlock) ||
      !make_map<HD>(&k_small, k, bh, L, kTile) ||
      !make_map<HD>(&v_small, v, bh, L, kTile) ||
      !make_map<HD>(&k_big, k, bh, L, kBlock) ||
      !make_map<HD>(&v_big, v, bh, L, kBlock) ||
      !make_map<HD>(&q_small, q, bh, L, kTile) ||
      !make_map<HD>(&do_small, dout, bh, L, kTile)) {
    return (int)cudaErrorInvalidValue;
  }
  const float scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid((L + kBlock - 1) / kBlock, bh);

  constexpr int smem_dq = SmemDq<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_dq);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dq_kernel<HD><<<grid, kThreads, smem_dq, stream>>>(
      q_big, do_big, k_small, v_small, o, dout, lse, dsum, dq, L, scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int smem_dkv = SmemDkv<HD>::kBytes;
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkv);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkv_kernel<HD><<<grid, kThreads, smem_dkv, stream>>>(
      q_small, do_small, k_big, v_big, lse, dsum, dk, dv, L, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: bf16 [bh, L, hd] contiguous, 16-byte
// aligned; lse: fp32 [bh, L] in base 2 (attention_fwd_bf16's); dsum: fp32
// [bh, L] scratch (D, written by the dQ pass, read by the dK/dV pass).
// Launches the two kernels on ``stream`` and returns the CUDA error code of
// the launches (0 on success; cudaErrorInvalidValue also when the driver
// refuses a tensor map).
extern "C" int attention_bwd_bf16(const void* q, const void* k, const void* v,
                                  const void* o, const void* lse,
                                  const void* dout, void* dq, void* dk,
                                  void* dv, void* dsum, int bh, int L, int hd,
                                  float scale, void* stream) {
  using bf = __nv_bfloat16;
  auto* qp = static_cast<const bf*>(q);
  auto* kp = static_cast<const bf*>(k);
  auto* vp = static_cast<const bf*>(v);
  auto* op = static_cast<const bf*>(o);
  auto* lp = static_cast<const float*>(lse);
  auto* dop = static_cast<const bf*>(dout);
  auto* dqp = static_cast<bf*>(dq);
  auto* dkp = static_cast<bf*>(dk);
  auto* dvp = static_cast<bf*>(dv);
  auto* dsp = static_cast<float*>(dsum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(qp, kp, vp, op, lp, dop, dqp, dkp, dvp, dsp, bh, L,
                        scale, s);
    case 64:
      return launch<64>(qp, kp, vp, op, lp, dop, dqp, dkp, dvp, dsp, bh, L,
                        scale, s);
    case 128:
      return launch<128>(qp, kp, vp, op, lp, dop, dqp, dkp, dvp, dsp, bh, L,
                         scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
