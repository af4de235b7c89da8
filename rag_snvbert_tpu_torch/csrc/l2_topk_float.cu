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
// Products.  bf16: mma.sync m16n8k16, fp32 accumulation.  float32: three
// TF32 products per pair (hi*hi + hi*lo + lo*hi, with hi = tf32(x) and
// lo = tf32(x - hi): 21-22 of float32's 24 bits, what Precision.HIGHEST
// asks for; one TF32 product keeps 11), mma.sync m16n8k8.  The tensor
// cores' fp32 accumulation truncates, so products go into fresh
// accumulators that are added to the running sum with IEEE adds (as
// csrc/l2_topk.cu does): bf16 a 128-byte chunk of d (64 columns) at a time,
// float32 an 8-column k-step (its three products) at a time.  |q|^2 is
// summed in double, and each distance is formed in double and rounded to
// float once: the float32 matmul + expansion of the plain version rounds
// twice more.
//
// What bounds it on the H100, at the genotype-index shape ([1024, 2040]
// queries x 664,648 rows, k = 10; 2.79e12 operations): bf16, the tensor
// cores, 2.82 ms at 989 TFLOP/s (the 2.7 GB of refs take 0.81 ms); float32,
// 3 x 2.79e12 TF32 operations, 16.9 ms at 495 TFLOP/s (the 5.4 GB of refs
// 1.62 ms).  This first design is simple and right, not fast: mma.sync, not
// wgmma; cp.async, not TMA; a 128 x 128 block tile that rereads its query
// tile from L2 for every ref tile.
//
// Design: the TPU grids run in order and carry their top-k state across
// grid steps; here blocks run in no order, so the work is split by ref rows.
//   pass 1, l2f_split_topk: grid (query tile of 128, split of the ref rows).
//     A block walks its split's ref tiles (BN rows) and, inside each, the
//     chunks of d through a cp.async ring of STAGES stages (query tile and
//     ref tile of one chunk each, rows padded to 36 words so that the mma
//     fragments load without bank conflicts; rows past B or N and columns
//     past d are zero-filled by the copies).  8 warps, 4 along the queries
//     x 2 along the refs, each own a 32 x BN/2 product tile in registers.
//     The block's first ref tile also sums the squares of its query rows
//     where they sit in shared memory.  At the end of a ref tile the
//     distances go to a shared [128, BN] tile, and each warp updates the
//     sorted lists of its 16 queries: a ballot of the row's distances below
//     the list's k-th, then one warp-wide insertion per candidate in id
//     order (the list stays sorted by (distance, id): a new row goes after
//     equal distances, whose ids are lower).  The lists go to a
//     [splits, B, k] workspace (or straight to the output with one split).
//   pass 2, l2f_merge: one warp per query inserts the splits' lists in
//     split order, which is id order, into one list by the same rule.
// k <= 32: BN = 128 and three stages; k <= 128: BN = 64 and two stages (the
// 128 lists of up to 128 entries take 128 KB).  No atomics, every sum and
// every insertion in a fixed order: reruns are bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps: 4 along the queries x 2 along refs
constexpr int kBQ = 128;        // queries per block
constexpr int kRowWords = 32;   // 32-bit words of one row in one chunk of d
constexpr int kLd = 36;         // padded row stride of a stage, in words
constexpr int kMaxK = 128;

__host__ __device__ constexpr int smem_bytes(int bn, int stages, int kp) {
  return stages * (kBQ + bn) * kLd * 4    // the cp.async ring
         + kBQ * (bn + 8) * 4             // the distance tile
         + kBQ * kp * 8                   // the lists: distances, then ids
         + kBQ * 8;                       // |q|^2 (double)
}

__device__ __forceinline__ float inf_f() { return CUDART_INF_F; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zeros where !pred (src untouched).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo in TF32, each returned as float bits.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(__uint_as_float(x));
  lo = to_tf32(__uint_as_float(x) - __uint_as_float(hi));
}

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
  const int pos = __reduce_add_sync(0xffffffffu, cnt);
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

// Offer 32 candidates (lane l: value v, id base + l, eligible if ok) to
// the list, in lane (= id) order.
__device__ __forceinline__ void offer(float* rv, int* ri, int k, float v,
                                      int id, bool ok, int lane) {
  float thr = rv[k - 1];
  bool full = ri[k - 1] >= 0;
  unsigned mask = __ballot_sync(0xffffffffu, ok && (!full || v < thr));
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float cv = __shfl_sync(0xffffffffu, v, src);
    const int cid = __shfl_sync(0xffffffffu, id, src);
    if (full && !(cv < thr)) continue;
    list_insert(rv, ri, k, cv, cid, lane);
    thr = rv[k - 1];
    full = ri[k - 1] >= 0;
  }
}

template <bool kBf16, int BN, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
    l2f_split_topk(const uint32_t* __restrict__ q,
                   const uint32_t* __restrict__ r,
                   const float* __restrict__ rnorm, float* __restrict__ out_v,
                   int* __restrict__ out_i, int B, int N, int d, int k,
                   int kp, int rows_per_split) {
  constexpr int NT = BN / 16;                // n-tiles of 8 a warp
  constexpr int kDistLd = BN + 8;            // conflict-free float2 stores
  constexpr int kCw = kBf16 ? 64 : 32;       // columns of d a chunk
  constexpr int kSeg = kBf16 ? 8 : 4;        // columns a 16-byte copy
  constexpr int kStage = (kBQ + BN) * kLd;   // words a stage
  extern __shared__ __align__(16) uint32_t smem[];
  float* dist = reinterpret_cast<float*>(smem + STAGES * kStage);
  float* lv = dist + kBQ * kDistLd;
  int* li = reinterpret_cast<int*>(lv + kBQ * kp);
  double* qn_s = reinterpret_cast<double*>(li + kBQ * kp);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wq = warp & 3, wn = warp >> 2;
  const int q0 = blockIdx.x * kBQ;
  const int split = blockIdx.y;
  const long long n_begin = (long long)split * rows_per_split;
  const int n_end = (int)min((long long)N, n_begin + rows_per_split);
  const int n_tiles =
      n_end > n_begin ? (int)((n_end - n_begin + BN - 1) / BN) : 0;
  const int n_chunks = (d + kCw - 1) / kCw;
  const int total = n_tiles * n_chunks;
  const size_t row_words = (size_t)d * (kBf16 ? 2 : 4) / 4;

  for (int i = tid; i < kBQ * kp; i += kThreads) {
    lv[i] = inf_f();
    li[i] = -1;
  }

  auto load = [&](int s) {
    if (s < total) {
      const int tile = s / n_chunks, c = s - tile * n_chunks;
      uint32_t* qs = smem + (s % STAGES) * kStage;
      const int col0 = c * kCw;
      const long long r0 = n_begin + (long long)tile * BN;
#pragma unroll
      for (int it = 0; it < (kBQ + BN) * 8 / kThreads; ++it) {
        const int i = tid + it * kThreads;
        const int row = i >> 3, seg = i & 7;
        const int col = col0 + seg * kSeg;
        const size_t w = (size_t)col * (kBf16 ? 2 : 4) / 4;
        if (row < kBQ) {
          const int qr = q0 + row;
          const bool ok = qr < B && col < d;
          cp_async16(qs + row * kLd + seg * 4,
                     ok ? q + (size_t)qr * row_words + w : q, ok);
        } else {
          const long long rr = r0 + (row - kBQ);
          const bool ok = rr < n_end && col < d;
          cp_async16(qs + row * kLd + seg * 4,
                     ok ? r + (size_t)rr * row_words + w : r, ok);
        }
      }
    }
    cp_async_commit();
  };

  __syncthreads();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);

  float sum[2][NT][4];
  double qacc = 0.0;
  for (int s = 0; s < total; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    load(s + STAGES - 1);
    const int tile = s / n_chunks, c = s - tile * n_chunks;
    const uint32_t* qs = smem + (s % STAGES) * kStage;
    const uint32_t* rs = qs + kBQ * kLd;
    if (c == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[mt][nt][e] = 0.f;
    }
    if (tile == 0) {   // |q|^2 in double: two threads a row, 16 words each
      const uint32_t* p = qs + (tid >> 1) * kLd + (tid & 1) * 16;
#pragma unroll
      for (int w = 0; w < 16; ++w) {
        const uint32_t x = p[w];
        if constexpr (kBf16) {
          const double lo = __uint_as_float(x << 16);
          const double hi = __uint_as_float(x & 0xffff0000u);
          qacc = fma(lo, lo, qacc);
          qacc = fma(hi, hi, qacc);
        } else {
          const double f = __uint_as_float(x);
          qacc = fma(f, f, qacc);
        }
      }
    }
    auto load_a = [&](int kk, uint32_t (&a)[2][4]) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t* pa = qs + (wq * 32 + mt * 16 + g) * kLd + kk * 8 + t;
        a[mt][0] = pa[0];
        a[mt][1] = pa[8 * kLd];
        a[mt][2] = pa[4];
        a[mt][3] = pa[8 * kLd + 4];
      }
    };
    if constexpr (kBf16) {
      // the chunk's four 16-column k-steps into a fresh accumulator, added
      // to the running sum
      float acc[2][NT][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kRowWords / 8; ++kk) {
        uint32_t a[2][4];
        load_a(kk, a);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t* pb =
              rs + (wn * (BN / 2) + nt * 8 + g) * kLd + kk * 8 + t;
          const uint32_t b0 = pb[0], b1 = pb[4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[mt][nt][e] += acc[mt][nt][e];
    } else {
      // lo*hi + hi*lo + hi*hi of one 8-column k-step into a fresh
      // accumulator, added to the running sum: three chained products, not
      // twelve (at d = 37 the chunk-long chain was 1.6x further from float64
      // than the plain float32 product; this is below it at d = 37-4096)
#pragma unroll
      for (int kk = 0; kk < kRowWords / 8; ++kk) {
        uint32_t a[2][4], ah[2][4], al[2][4];
        load_a(kk, a);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split_tf32(a[mt][e], ah[mt][e], al[mt][e]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t* pb =
              rs + (wn * (BN / 2) + nt * 8 + g) * kLd + kk * 8 + t;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(pb[0], bh0, bl0);
          split_tf32(pb[4], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            float p[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(p, al[mt], bh0, bh1);
            mma_tf32(p, ah[mt], bl0, bl1);
            mma_tf32(p, ah[mt], bh0, bh1);
#pragma unroll
            for (int e = 0; e < 4; ++e) sum[mt][nt][e] += p[e];
          }
        }
      }
    }
    if (c != n_chunks - 1) continue;

    // ---- the end of ref tile `tile`: distances, then the lists ----
    if (tile == 0) {
      qacc += __shfl_xor_sync(0xffffffffu, qacc, 1);
      if ((tid & 1) == 0) qn_s[tid >> 1] = qacc;
      __syncthreads();
    }
    // dist = |q|^2 - 2 q.r + |r|^2 in double, rounded to float once
    const long long nbase = n_begin + (long long)tile * BN;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = wn * (BN / 2) + nt * 8 + 2 * t;
      const long long gc = nbase + col;
      const double rn0 = gc < n_end ? __ldg(rnorm + gc) : 0.0;
      const double rn1 = gc + 1 < n_end ? __ldg(rnorm + gc + 1) : 0.0;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = wq * 32 + mt * 16 + g;
        const double qa = qn_s[row], qb = qn_s[row + 8];
        *reinterpret_cast<float2*>(dist + row * kDistLd + col) = make_float2(
            fmaxf((float)(qa - 2.0 * sum[mt][nt][0] + rn0), 0.f),
            fmaxf((float)(qa - 2.0 * sum[mt][nt][1] + rn1), 0.f));
        *reinterpret_cast<float2*>(dist + (row + 8) * kDistLd + col) =
            make_float2(fmaxf((float)(qb - 2.0 * sum[mt][nt][2] + rn0), 0.f),
                        fmaxf((float)(qb - 2.0 * sum[mt][nt][3] + rn1), 0.f));
      }
    }
    __syncthreads();
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int row = warp * (kBQ / 8) + rr;
      if (q0 + row >= B) break;
#pragma unroll
      for (int h = 0; h < BN / 32; ++h) {
        const int col = h * 32 + lane;
        offer(lv + row * kp, li + row * kp, k, dist[row * kDistLd + col],
              (int)(nbase + col), nbase + col < n_end, lane);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < kBQ * k; i += kThreads) {
    const int row = i / k, j = i - row * k;
    if (q0 + row < B) {
      const size_t o = ((size_t)split * B + q0 + row) * k + j;
      out_v[o] = lv[row * kp + j];
      out_i[o] = li[row * kp + j];
    }
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

template <bool kBf16, int BN, int STAGES>
cudaError_t launch_split(const void* q, const void* r, const float* rnorm,
                         float* out_v, int* out_i, int B, int N, int d, int k,
                         int kp, int splits, int rows, cudaStream_t s) {
  auto kern = l2f_split_topk<kBf16, BN, STAGES>;
  static bool attr_set = false;   // once a process, not once a call
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(BN, STAGES, BN == 128 ? 32 : kMaxK));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((B + kBQ - 1) / kBQ, splits);
  kern<<<grid, kThreads, smem_bytes(BN, STAGES, kp), s>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(r),
      rnorm, out_v, out_i, B, N, d, k, kp, rows);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of one pass-1 block (ops/l2_topk_float.py::smem_bytes is
// its twin).
extern "C" int l2_topk_float_smem(int bn, int stages, int kp) {
  return smem_bytes(bn, stages, kp);
}

// q [B, d] and r [N, d] of one dtype (bf16 if is_bf16, else float32),
// contiguous, 16-byte aligned, d % 8 == 0; rnorm [N] float32.  bn 128 with
// kp 32 (k <= 32) or bn 64 with kp = k rounded up to 32; rows a multiple of
// bn.  With splits == 1 part_v/part_i may be vals/ids, and pass 2 is not
// launched.
extern "C" int l2_topk_float(const void* q, const void* r, const void* rnorm,
                             void* part_v, void* part_i, void* vals,
                             void* ids, int B, int N, int d, int k, int kp,
                             int bn, int is_bf16, int splits, int rows,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = bn == 128;
  if (d % 8 != 0 || k < 1 || k > kMaxK || rows % bn != 0 ||
      (wide ? (k > 32 || kp != 32) : (bn != 64 || kp < k || kp % 32 ||
                                      kp > kMaxK))) {
    return (int)cudaErrorInvalidValue;
  }
  const float* rn = static_cast<const float*>(rnorm);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  cudaError_t err;
  if (is_bf16) {
    err = wide ? launch_split<true, 128, 3>(q, r, rn, pv, pi, B, N, d, k, kp,
                                            splits, rows, s)
               : launch_split<true, 64, 2>(q, r, rn, pv, pi, B, N, d, k, kp,
                                           splits, rows, s);
  } else {
    err = wide ? launch_split<false, 128, 3>(q, r, rn, pv, pi, B, N, d, k, kp,
                                             splits, rows, s)
               : launch_split<false, 64, 2>(q, r, rn, pv, pi, B, N, d, k, kp,
                                            splits, rows, s);
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  l2f_merge<<<(B + kMergeWarps - 1) / kMergeWarps, 32 * kMergeWarps, 0, s>>>(
      pv, pi, static_cast<float*>(vals), static_cast<int*>(ids), B, k, splits);
  return (int)cudaGetLastError();
}
