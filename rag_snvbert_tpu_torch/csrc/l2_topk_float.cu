// Exact squared-L2 top-k over float32 or bf16 vectors, any B, N and d, for
// Hopper (sm_90a).
//
// Replaces the float searches of rag_snvbert_tpu/ops/l2_topk_pallas.py that
// csrc/l2_topk.cu does not take (bf16 only, N <= 49,152):
//   - _l2_topk_kernel with in_dtype=float32 (:203-353, the product at
//     Precision.HIGHEST): the query-tile-outer kernel that streams ref tiles
//     and d tiles, the route of a float32 index (two d tiles at d = 2040);
//   - the float branch of _l2_topk_kernel_rf (:410-411, :429-433, :441-443):
//     the refs-outer kernel of a bf16 index whose d fits one tile.
// Both reach it through index/flat.py::FlatL2Index.search / masked_search.
// Semantics are those of ops/l2_ref.py and of the port's other two searches:
//   dist = max(|q|^2 - 2 q.r + |r|^2, 0) in fp32, |q|^2 from the queries (in
//   the refs' dtype), |r|^2 as given (+inf rows rank after every finite row,
//   in id order); (vals [B, k] f32, ids [B, k] int32) ascending, ties to the
//   lower id, slots past N (+inf, -1).  Distances are exact fp32 values, not
//   the TPU kernel's 2^(id_bits+1)-ULP sort keys (l2_topk_pallas.py:35-42).
//
// Products.  bf16: wgmma m64n128k16, fp32 accumulation.  float32: three
// TF32 products per pair, hi*hi + hi*lo + lo*hi with hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest (21-22 of float32's 24 bits,
// what Precision.HIGHEST asks for; one TF32 product keeps 11), wgmma
// m64n128k8 tf32.  The parts are made once a call by a pre-pass
// (l2f_prep_queries for the queries; l2f_split for the refs, a batch of
// rows at a time, see the wrapper), not in the kernel: a loader warpgroup
// splitting each landed stage split every ref value once for each of the
// 8 query tiles of its split, and took half the kernel's time.  (The
// float32 values themselves would do as hi, the tensor cores reading their
// top 19 bits, but that truncation biases every |x| low: at d = 37 the
// distances then lay further from float64 than the plain product's.)  The
// tensor cores' fp32 accumulation truncates, so products go
// into a fresh accumulator that is added to the running sum with IEEE
// adds: bf16 once a stage (128 columns), float32 once an 8-column k-step
// (its three products, the small ones first; a chunk-long chain of twelve
// was further from float64 than the plain float32 product at d = 37).
// |q|^2 is summed in double (l2f_prep_queries), and each distance is
// formed in double and rounded to float once: the float32 matmul +
// expansion of the plain version rounds twice more.
//
// What bounds it on the H100, at the genotype-index shape ([1024, 2040]
// queries x 664,648 rows, k = 10; 2.78e12 operations): bf16, the tensor
// cores, 2.81 ms at 989 TFLOP/s (the 2.7 GB of refs take 0.81 ms); float32,
// 3 x 2.78e12 TF32 operations, 16.8 ms at 495 TFLOP/s (the 5.4 GB of refs
// 1.62 ms; the pre-pass's split moves 16.3 GB more, ~4.9 ms).
//
// Design: the TPU grids run in order and carry their top-k state across
// grid steps; here blocks run in no order, so the work is split by ref rows.
//   pass 1, l2f_split_topk: grid (query tile of 128, split of the ref rows);
//     the blocks that share a split are neighbours in launch order, so a
//     ref tile comes from device memory once and from L2 for the other
//     query tiles.  One block an SM, three warpgroups:
//     * the loader (warpgroup 2): one thread keeps TMA loads in flight into
//       a ring of 64 KB stages, each four panels of 128 rows x 128 bytes:
//       bf16, 256 bytes of d of the block's 128 queries and of the tile's
//       128 ref rows; float32, 128 bytes of d of their hi and lo parts; in
//       the 128-byte swizzle that wgmma's descriptors name (rows past B or
//       N and bytes past d come as zeros from the tensor maps' bounds),
//       each stage under a "full" and an "empty" mbarrier.
//     * two consumer warpgroups (0, 1) of 64 queries each (setmaxnreg hands
//       them the loader's registers): wgmma m64n128 with both operands
//       K-major in shared memory into a fresh accumulator, waited for and
//       added to the running sum (64 + 64 floats a thread).  The two take
//       turns on the tensor cores as their waits fall.  Selection from the
//       accumulators, as csrc/l2_topk_rf.cu does: each row's list bound
//       lives in the registers of the four threads that hold the row; a
//       pass over the accumulators compares norm - 2 q.r in float against
//       a bound that is conservative (the k-th distance less |q|^2, widened
//       by 2^-22 of itself: a row it rejects cannot have a double-formed
//       distance below the k-th); a row that passes has its distance
//       formed in double and rounded once, and the four threads find the
//       row's (distance, column) minimum below the k-th.  Only a row that
//       has one goes to its sorted list in shared memory (a warp-wide
//       insert), lowers its bound and looks again: best first, so equal
//       distances arrive in ascending id order and a strict < keeps the
//       lower id; a tile that offers nothing costs one pass over the
//       accumulators.  Rows past the split or N carry a +inf norm, which no
//       bound admits; after the split's last tile a list that is still
//       short takes the split's +inf rows in id order, so they rank after
//       every finite row.
//     The lists grow with k (128 rows x 8 bytes x 16 for k <= 16, else k
//     rounded up to 32), so the ring shrinks as k grows: 3 stages at
//     k <= 32 down to 1 at k > 96 (l2_topk_float_smem; every k <= 128 is
//     right, small k is fast).  A launch takes a batch of
//     rows whose ids start at id_base; its splits' lists go to their own
//     slots of the workspace.
//   pass 2, l2f_merge: one warp per query inserts the splits' lists in
//     split order, which is id order, into one list by the same rule.
// TMA's limits: the base 16-byte aligned and the row stride a multiple of
// 16 bytes (the wrapper pads d to 8 columns, and copies rows whose base is
// off 16 bytes), a box of at most 256 x 256 elements (here 128 bytes x 128
// rows).  No atomics, every sum and every insertion in a fixed order:
// reruns are bit-identical.
// Replaces the first design (eight warps of mma.sync m16n8k16 / m16n8k8
// from register fragments, every float32 value split 2-4 times inside the
// product loop, a cp.async ring in one instruction stream, every distance
// through a shared tile and a ballot pass).

#include <math_constants.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 128;         // queries per pass-1 block, 64 per consumer
constexpr int kBN = 128;         // ref rows per tile: wgmma's n
constexpr int kKB = 128;         // bytes of d a swizzled panel row holds
constexpr int kPanel = 128 * kKB;   // one panel (kBQ == kBN rows)
// A stage is four panels: bf16, 256 bytes of d (query, query, ref, ref);
// float32, 128 bytes of d (query hi, ref hi, query lo, ref lo).
constexpr int kStage = 4 * kPanel;
constexpr int kConsumers = 2;    // warpgroups 0, 1; the loader is 2
constexpr int kThreads = 128 * (kConsumers + 1);
// setmaxnreg: a consumer holds 64 + 64 accumulators and the selection's
// state; the loader is one thread issuing TMA loads.
constexpr int kLoaderRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kLoaderRegs + kConsumers * kConsumerRegs <= 3 * 168,
              "registers");
constexpr int kMaxStages = 4;
constexpr int kSmemMax = 232448;    // an H100 block's dynamic limit
constexpr int kMaxK = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWgBar = 1;           // named barriers kWgBar + consumer

// Byte offsets into the block's shared memory (after 1024-byte alignment).
struct Layout {
  int ld, li, rns, bars, bytes;
  __host__ __device__ Layout(int stages, int kp) {
    ld = stages * kStage;
    li = ld + kBQ * kp * 4;
    rns = li + kBQ * kp * 4;
    bars = rns + kConsumers * kBN * 4;
    bytes = bars + 2 * kMaxStages * 8 + 1024;
  }
};

__device__ __forceinline__ float inf_f() { return CUDART_INF_F; }

// Insert (cd, ci) into the sorted list ld/li of length k (warp-wide; every
// lane passes the same candidate).  Entries i = lane + 32 j; empty slots
// are (+inf, -1).  The new entry goes after every entry with a distance
// <= cd: callers offer candidates in ascending id order among equal
// distances.  Requires cd < ld[k - 1].
template <int J>   // k <= 32 J
__device__ __forceinline__ void insert(float* ld, int* li, int k, float cd,
                                       int ci, int lane) {
  int p = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = lane + 32 * j;
    p += __popc(__ballot_sync(kFull, i < k && ld[i] <= cd));
  }
  // entries p .. k - 2 move up by one, 32 at a time from the top, so that
  // a step reads only entries that no step has written yet
#pragma unroll
  for (int j = J - 1; j >= 0; --j) {
    const int i = lane + 32 * j;
    float nd = cd;
    int ni = ci;
    if (i < k && i > p) {
      nd = ld[i - 1];
      ni = li[i - 1];
    }
    __syncwarp();
    if (i < k && i >= p) {
      ld[i] = nd;
      li[i] = ni;
    }
    __syncwarp();
  }
}

// The float filter's bound on norm - 2 q.r for a row whose k-th distance is
// kth.  The exact test is fl32(X) < kth with X = |q|^2 - 2 q.r + |r|^2, which
// needs X < kth, i.e. t = |r|^2 - 2 q.r < T = kth - |q|^2.  The filter
// computes t_f = fma(-2, q.r, |r|^2), t (1 + e) with |e| <= 2^-24, and that
// is below T + 2^-24 |T| whenever t < T (either sign of t and T): so a
// bound of T + 2^-22 |T|, rounded up, rejects no row that could enter.
// +inf (a list not full yet) admits every finite row, -inf (a row past B)
// none.
__device__ __forceinline__ float filter_bound(float kth, double qn) {
  if (isinf(kth)) return kth;
  const double t = (double)kth - qn;
  return __double2float_ru(t + fabs(t) * 0x1p-22);
}

struct Args {
  const double* qn;     // [B] |q|^2
  const float* rnorm;   // the batch's [N]
  float* out_v;         // the batch's [splits, B, k] (the output itself
  int* out_i;           // with one batch of one split)
  int B, N, row_bytes, k, kp, rows_per_split, stages, id_base;
};

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
l2f_split_topk(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_r,
               const __grid_constant__ CUtensorMap tm_ql,
               const __grid_constant__ CUtensorMap tm_rl, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const Layout lay(a.stages, a.kp);
  float* Ld = reinterpret_cast<float*>(smem + lay.ld);
  int* Li = reinterpret_cast<int*>(smem + lay.li);
  float* rns = reinterpret_cast<float*>(smem + lay.rns);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + kMaxStages;

  const int b0 = blockIdx.x * kBQ;
  const int split = blockIdx.y;
  const int n_begin = split * a.rows_per_split;
  const int n_end = min(n_begin + a.rows_per_split, a.N);
  const int tiles = n_end > n_begin ? (n_end - n_begin + kBN - 1) / kBN : 0;
  constexpr int kChunk = kBf16 ? 2 * kKB : kKB;   // bytes of d a stage
  const int chunks = (a.row_bytes + kChunk - 1) / kChunk;
  const int stages = a.stages;
  const int consumers = a.B - b0 <= 64 ? 1 : kConsumers;
  const int wg = warpgroup();

  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(&full[s], 1);                // the loader's arrival + bytes
      mbar_init(&empty[s], 4 * consumers);   // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- loader: one thread keeps the ring full ----
    reg_dealloc<kLoaderRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      for (int it = 0; it < tiles * chunks; ++it) {
        const int s = it % stages;
        if (it >= stages) mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
        const int tile = it / chunks, c = it - tile * chunks;
        const int n0 = n_begin + tile * kBN;
        uint8_t* stage = smem + s * kStage;
        mbar_expect_tx(&full[s], kStage);
        // (a box wholly past d, the second of a bf16 row's last stage,
        // comes as zeros and counts its bytes all the same)
        if constexpr (kBf16) {
          tma_load_2d(stage, &tm_q, &full[s], 2 * c * kKB, b0);
          tma_load_2d(stage + kPanel, &tm_q, &full[s], (2 * c + 1) * kKB, b0);
          tma_load_2d(stage + 2 * kPanel, &tm_r, &full[s], 2 * c * kKB, n0);
          tma_load_2d(stage + 3 * kPanel, &tm_r, &full[s], (2 * c + 1) * kKB,
                      n0);
        } else {
          tma_load_2d(stage, &tm_q, &full[s], c * kKB, b0);
          tma_load_2d(stage + kPanel, &tm_r, &full[s], c * kKB, n0);
          tma_load_2d(stage + 2 * kPanel, &tm_ql, &full[s], c * kKB, b0);
          tma_load_2d(stage + 3 * kPanel, &tm_rl, &full[s], c * kKB, n0);
        }
      }
    }
  } else if (wg < consumers) {
    // ---- consumers ----
    reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;   // accumulator row group
    const int t4 = lane & 3;   // thread in group
    const int k = a.k, kp = a.kp;
    const int row0 = 64 * wg + 16 * warp + g;   // and row0 + 8
    for (int r = 0; r < 16; ++r) {   // the warp's own 16 lists
      for (int i = lane; i < kp; i += 32) {
        Ld[(64 * wg + 16 * warp + r) * kp + i] = inf_f();
        Li[(64 * wg + 16 * warp + r) * kp + i] = -1;
      }
    }
    __syncwarp();
    float* rn_s = rns + wg * kBN;
    float sum[kBN / 2], step[kBN / 2];
    // per row: |q|^2, the k-th distance (+inf until the list is full; -inf
    // for a row past B, which never has a candidate) and the filter's bound
    double qn[2];
    float kth[2], thr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int b = b0 + row0 + 8 * i;
      qn[i] = b < a.B ? a.qn[b] : 0.0;
      kth[i] = b < a.B ? inf_f() : -inf_f();
      thr[i] = kth[i];
    }
    auto release = [&](int slot) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    };
    auto add = [&](bool first) {
#pragma unroll
      for (int j = 0; j < kBN / 2; ++j) {
        sum[j] = first ? step[j] : sum[j] + step[j];
      }
    };
    int it = 0;
    for (int t = 0; t < tiles; ++t) {
      const int n0 = n_begin + t * kBN;
      const float rn_mine = n0 + tid < n_end ? a.rnorm[n0 + tid] : inf_f();
      for (int c = 0; c < chunks; ++c, ++it) {
        const int s = it % stages;
        mbar_wait(&full[s], (it / stages) & 1);
        const uint32_t q_addr = smem_u32(smem + s * kStage);
        if constexpr (kBf16) {
          // the stage's eight k-steps (128 columns) into a fresh accumulator
          fence_regs(step);
          wgmma_fence();
#pragma unroll
          for (int p = 0; p < 2; ++p) {
#pragma unroll
            for (int ks = 0; ks < kKB / 32; ++ks) {
              Wgmma<kBN>::template ss<0>(
                  step, desc_k128(q_addr + p * kPanel, 64 * wg, ks),
                  desc_k128(q_addr + (2 + p) * kPanel, 0, ks), (p | ks) != 0);
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(step);
          release(s);
          add(c == 0);
        } else {
          // lo*hi, hi*lo, hi*hi of each 8-column k-step (the small ones
          // first) into a fresh accumulator
          const uint32_t r_addr = q_addr + kPanel;
          const uint32_t ql_addr = q_addr + 2 * kPanel;
          const uint32_t rl_addr = q_addr + 3 * kPanel;
#pragma unroll
          for (int ks = 0; ks < kKB / 32; ++ks) {
            const uint64_t qh = desc_k128(q_addr, 64 * wg, ks);
            const uint64_t rh = desc_k128(r_addr, 0, ks);
            fence_regs(step);
            wgmma_fence();
            WgmmaTF32<kBN>::ss(step, desc_k128(ql_addr, 64 * wg, ks), rh, 0);
            WgmmaTF32<kBN>::ss(step, qh, desc_k128(rl_addr, 0, ks), 1);
            WgmmaTF32<kBN>::ss(step, qh, rh, 1);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(step);
            if (ks == kKB / 32 - 1) release(s);
            add(c == 0 && ks == 0);
          }
        }
      }

      // ---- selection from the accumulators ----
      bar_sync(kWgBar + wg, 128);   // the last tile's norms are read
      rn_s[tid] = rn_mine;
      bar_sync(kWgBar + wg, 128);
      // Rounds: every row's lexicographic (distance, column) minimum below
      // its k-th, found in the registers of the four threads that hold the
      // row; the rows that have one take it into their lists, one after
      // another, lower their bounds and poison the taken accumulator (-inf:
      // norm - 2 q.r is then +inf); until no row has a candidate.
      for (;;) {
        float bv[2] = {kth[0], kth[1]};
        int bc[2] = {-1, -1};
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const float2 r2 =
              *reinterpret_cast<const float2*>(rn_s + 8 * j + 2 * t4);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float dot = sum[4 * j + 2 * i + e];
              const float rn = e ? r2.y : r2.x;
              if (__fmaf_rn(-2.f, dot, rn) < thr[i]) {
                const float dist = fmaxf(
                    (float)(qn[i] - 2.0 * (double)dot + (double)rn), 0.f);
                if (dist < bv[i]) {
                  bv[i] = dist;
                  bc[i] = 8 * j + 2 * t4 + e;
                }
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int off = 1; off <= 2; off <<= 1) {
            const float ov = __shfl_xor_sync(kFull, bv[i], off);
            const int oc = __shfl_xor_sync(kFull, bc[i], off);
            if (ov < bv[i] || (ov == bv[i] && oc >= 0 && oc < bc[i])) {
              bv[i] = ov;
              bc[i] = oc;
            }
          }
        }
        const unsigned has0 = __ballot_sync(kFull, bc[0] >= 0);
        const unsigned has1 = __ballot_sync(kFull, bc[1] >= 0);
        if ((has0 | has1) == 0) break;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          unsigned hb = i == 0 ? has0 : has1;
          while (hb) {
            const int gs = (__ffs(hb) - 1) >> 2;
            hb &= ~(0xFu << (4 * gs));
            const int cc = __shfl_sync(kFull, bc[i], 4 * gs);
            const float cd = __shfl_sync(kFull, bv[i], 4 * gs);
            const int row = 64 * wg + 16 * warp + gs + 8 * i;
            float* ld = Ld + row * kp;
            int* li = Li + row * kp;
            if (k <= 32) {
              insert<1>(ld, li, k, cd, a.id_base + n0 + cc, lane);
            } else {
              insert<4>(ld, li, k, cd, a.id_base + n0 + cc, lane);
            }
            const float now = ld[k - 1];
            if (g == gs) {
              kth[i] = now;
              thr[i] = filter_bound(now, qn[i]);
#pragma unroll
              for (int j = 0; j < kBN / 8; ++j) {
                if (cc == 8 * j + 2 * t4) sum[4 * j + 2 * i] = -inf_f();
                if (cc == 8 * j + 2 * t4 + 1) {
                  sum[4 * j + 2 * i + 1] = -inf_f();
                }
              }
            }
          }
        }
      }
    }

    for (int r = 0; r < 16; ++r) {
      const int row = 64 * wg + 16 * warp + r;
      const int b = b0 + row;
      if (b >= a.B) break;
      // The tiles put finite rows only into the lists.  A list they left
      // short takes the split's +inf rows now, in id order, as far as it
      // has room: they rank after every finite row.
      int have = 0;
      for (int i = lane; i < k; i += 32) have += Li[row * kp + i] >= 0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        have += __shfl_xor_sync(kFull, have, off);
      }
      for (int n0 = n_begin; have < k && n0 < n_end; n0 += 32) {
        const int n = n0 + lane;
        unsigned inf = __ballot_sync(kFull, n < n_end && isinf(a.rnorm[n]));
        while (inf && have < k) {
          const int src = __ffs(inf) - 1;
          inf &= inf - 1;
          if (lane == 0) {
            Ld[row * kp + have] = inf_f();
            Li[row * kp + have] = a.id_base + n0 + src;
          }
          ++have;
        }
      }
      __syncwarp();
      const size_t out = ((size_t)split * a.B + b) * k;
      for (int i = lane; i < k; i += 32) {
        a.out_v[out + i] = Ld[row * kp + i];
        a.out_i[out + i] = Li[row * kp + i];
      }
    }
  }
}

// ---- pass 2 ----

// Insert (cv, cid) into the sorted list (rv, ri) of k entries, after every
// entry of equal distance; empty slots (id -1) form its tail.  The caller
// has checked that it enters (the list is not full, or cv < its k-th).
// Warp-wide: lane l owns entries l, l + 32, ...
__device__ __forceinline__ void list_insert(float* rv, int* ri, int k,
                                            float cv, int cid, int lane) {
  int cnt = 0;
#pragma unroll
  for (int u = 0; u < kMaxK / 32; ++u) {
    const int j = lane + 32 * u;
    if (j < k && ri[j] >= 0 && rv[j] <= cv) ++cnt;
  }
  const int pos = __reduce_add_sync(kFull, cnt);
  float ov[kMaxK / 32];
  int oi[kMaxK / 32];
#pragma unroll
  for (int u = 0; u < kMaxK / 32; ++u) {
    const int j = lane + 32 * u;
    if (j < k) {
      ov[u] = rv[j];
      oi[u] = ri[j];
    }
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < kMaxK / 32; ++u) {
    const int j = lane + 32 * u;
    if (j >= pos && j + 1 < k) {
      rv[j + 1] = ov[u];
      ri[j + 1] = oi[u];
    }
  }
  if (lane == 0) {
    rv[pos] = cv;
    ri[pos] = cid;
  }
  __syncwarp();
}

// Offer 32 candidates (lane l: value v, id, eligible if ok) to the list, in
// lane (= id) order.
__device__ __forceinline__ void offer(float* rv, int* ri, int k, float v,
                                      int id, bool ok, int lane) {
  float thr = rv[k - 1];
  bool full = ri[k - 1] >= 0;
  unsigned mask = __ballot_sync(kFull, ok && (!full || v < thr));
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float cv = __shfl_sync(kFull, v, src);
    const int cid = __shfl_sync(kFull, id, src);
    if (full && !(cv < thr)) continue;
    list_insert(rv, ri, k, cv, cid, lane);
    thr = rv[k - 1];
    full = ri[k - 1] >= 0;
  }
}

constexpr int kMergeWarps = 4;

__global__ void __launch_bounds__(32 * kMergeWarps)
    l2f_merge(const float* __restrict__ part_v, const int* __restrict__ part_i,
              float* __restrict__ vals, int* __restrict__ ids, int B, int k,
              int splits) {
  __shared__ float lv_all[kMergeWarps][kMaxK];
  __shared__ int li_all[kMergeWarps][kMaxK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * kMergeWarps + warp;
  if (qi >= B) return;
  float* lv = lv_all[warp];
  int* li = li_all[warp];
  for (int j = lane; j < k; j += 32) {
    lv[j] = inf_f();
    li[j] = -1;
  }
  __syncwarp();
  for (int s = 0; s < splits; ++s) {
    const size_t o = ((size_t)s * B + qi) * k;
    for (int base = 0; base < k; base += 32) {
      const int j = base + lane;
      const float v = j < k ? part_v[o + j] : inf_f();
      const int id = j < k ? part_i[o + j] : -1;
      offer(lv, li, k, v, id, id >= 0, lane);
    }
  }
  for (int j = lane; j < k; j += 32) {
    vals[(size_t)qi * k + j] = lv[j];
    ids[(size_t)qi * k + j] = li[j];
  }
}

// |q|^2 of each query row in double (a warp a row: lane-strided sums, then
// a fixed shuffle tree) and, for float32, q's TF32 parts q_hi and q_lo;
// q [B, d] in the refs' dtype.
__global__ void l2f_prep_queries(const void* __restrict__ q,
                                 double* __restrict__ qn,
                                 float* __restrict__ q_hi,
                                 float* __restrict__ q_lo, int B, int d,
                                 int bf16) {
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (b >= B) return;
  double s = 0.0;
  for (int j = lane; j < d; j += 32) {
    const size_t i = (size_t)b * d + j;
    double x;
    if (bf16) {
      x = __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i]);
    } else {
      const float f = static_cast<const float*>(q)[i];
      split_tf32(f, q_hi[i], q_lo[i]);
      x = f;
    }
    s = fma(x, x, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) qn[b] = s;
}

// The TF32 parts hi and lo of n4 groups of 4 floats.
__global__ void l2f_split(const float4* __restrict__ x,
                          float4* __restrict__ hi, float4* __restrict__ lo,
                          size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    float4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
}

// Raised at every launch: an attribute holds for the current device alone,
// and a process may search on more than one card.
template <bool kBf16>
cudaError_t set_limit() {
  return cudaFuncSetAttribute(
      l2f_split_topk<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemMax);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Shared memory of one pass-1 block (ops/l2_topk_float.py::smem_bytes is
// its twin and picks the stages).
extern "C" int l2_topk_float_smem(int kp, int stages) {
  return Layout(stages, kp).bytes;
}

// The queries' |q|^2 (qn [B] double) and, for float32, their TF32 parts
// q_hi, q_lo [B, d] float32; q [B, d] contiguous in the refs' dtype.
extern "C" int l2_topk_float_prep(const void* q, void* qn, void* q_hi,
                                  void* q_lo, int B, int d, int is_bf16,
                                  void* stream) {
  if (B < 1 || d < 1) return (int)cudaErrorInvalidValue;
  l2f_prep_queries<<<(B + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      q, static_cast<double*>(qn), static_cast<float*>(q_hi),
      static_cast<float*>(q_lo), B, d, is_bf16);
  return (int)cudaGetLastError();
}

// The TF32 parts r_hi, r_lo [n] of float32 r [n]; all on 16-byte bases, n a
// multiple of 4.
extern "C" int l2_topk_float_split(const void* r, void* r_hi, void* r_lo,
                                   long long n, void* stream) {
  if (n % 4 != 0 || !aligned16(r) || !aligned16(r_hi) || !aligned16(r_lo)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t n4 = (size_t)n / 4;
  const size_t want = (n4 + 255) / 256;
  const int blocks = want < 4096 ? (int)(want ? want : 1) : 4096;
  l2f_split<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(r), static_cast<float4*>(r_hi),
      static_cast<float4*>(r_lo), n4);
  return (int)cudaGetLastError();
}

// Pass 1 over a batch of N >= 1 ref rows whose ids start at id_base.
// q [B, d] and r [N, d] of one dtype (bf16 if is_bf16; float32: their TF32
// hi parts, with the lo parts q_lo and r_lo beside them), contiguous, on
// 16-byte bases, d % 8 == 0 (rows TMA can take); qn [B] from
// l2_topk_float_prep; rnorm [N] float32.  kp = 16 for k <= 16, else k
// rounded up to 32; stages such that l2_topk_float_smem fits the block;
// rows a multiple of 128 with splits * rows >= N.  Writes part_v/part_i
// [splits, B, k].  Returns the CUDA error code of the launch
// (cudaErrorInvalidValue also when a tensor map cannot be encoded).
extern "C" int l2_topk_float_pass1(const void* q, const void* q_lo,
                                   const void* qn, const void* r,
                                   const void* r_lo, const void* rnorm,
                                   void* part_v, void* part_i, int B, int N,
                                   int d, int k, int kp, int is_bf16,
                                   int splits, int rows, int stages,
                                   int id_base, void* stream) {
  const bool bf16 = is_bf16 != 0;
  if (B < 1 || N < 1 || d < 8 || d % 8 != 0 || k < 1 || k > kMaxK ||
      kp < k || kp > kMaxK || (kp != 16 && kp % 32 != 0) || rows < kBN ||
      rows % kBN != 0 || splits < 1 || (long long)splits * rows < N ||
      stages < 1 || stages > kMaxStages ||
      Layout(stages, kp).bytes > kSmemMax || !aligned16(q) ||
      !aligned16(r) || (!bf16 && (!aligned16(q_lo) || !aligned16(r_lo)))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = bf16 ? set_limit<true>() : set_limit<false>();
  if (err != cudaSuccess) return (int)err;
  const int row_bytes = d * (bf16 ? 2 : 4);
  // byte matrices: a box is 128 bytes of 128 rows in either dtype
  CUtensorMap tm_q, tm_r, tm_ql, tm_rl;
  if (!make_map_2d(&tm_q, q, false, B, row_bytes, row_bytes, kBQ) ||
      !make_map_2d(&tm_r, r, false, N, row_bytes, row_bytes, kBN)) {
    return (int)cudaErrorInvalidValue;
  }
  if (bf16) {
    tm_ql = tm_q;   // never read
    tm_rl = tm_r;
  } else if (!make_map_2d(&tm_ql, q_lo, false, B, row_bytes, row_bytes,
                          kBQ) ||
             !make_map_2d(&tm_rl, r_lo, false, N, row_bytes, row_bytes,
                          kBN)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.qn = static_cast<const double*>(qn);
  a.rnorm = static_cast<const float*>(rnorm);
  a.out_v = static_cast<float*>(part_v);
  a.out_i = static_cast<int*>(part_i);
  a.B = B; a.N = N; a.row_bytes = row_bytes; a.k = k; a.kp = kp;
  a.rows_per_split = rows; a.stages = stages; a.id_base = id_base;
  const dim3 grid((B + kBQ - 1) / kBQ, splits);
  const int smem = Layout(stages, kp).bytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    l2f_split_topk<true><<<grid, kThreads, smem, s>>>(tm_q, tm_r, tm_ql,
                                                      tm_rl, a);
  } else {
    l2f_split_topk<false><<<grid, kThreads, smem, s>>>(tm_q, tm_r, tm_ql,
                                                       tm_rl, a);
  }
  return (int)cudaGetLastError();
}

// Pass 2: the splits' lists part_v/part_i [splits, B, k], in split (= id)
// order, into vals/ids [B, k]; splits = 0 fills them with (+inf, -1).
extern "C" int l2_topk_float_merge(const void* part_v, const void* part_i,
                                   void* vals, void* ids, int B, int k,
                                   int splits, void* stream) {
  if (B < 1 || k < 1 || k > kMaxK || splits < 0) {
    return (int)cudaErrorInvalidValue;
  }
  l2f_merge<<<(B + kMergeWarps - 1) / kMergeWarps, 32 * kMergeWarps, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<float*>(vals), static_cast<int*>(ids), B, k, splits);
  return (int)cudaGetLastError();
}
