// Exact squared-L2 top-k over int8 vectors for Hopper (sm_90a), refs outer.
//
// Replaces: rag_snvbert_tpu/ops/l2_topk_pallas.py::_l2_topk_kernel_rf (the
// refs-outer Pallas kernel that l2_topk_pallas picks for integer vectors
// whose d fits one tile): the V17 token-space search (int8 token vectors,
// d = 1030) and the genotype index (binary vectors, planar-packed refs).
// Semantics (ops/l2_topk_rf.py::l2_topk_rf_plain):
//   dist = |q|^2 + trunc(r_norm) - 2 q.r, exact in int32, |q|^2 computed
//   here from the int8 queries (zero-padded to the unpacked width);
//   r_norm = +inf ranks the row after every finite row;
//   (vals [B, k] f32, ids [B, k] int32) ascending, ties to the lower id;
//   slots past the last row hold (+inf, -1).
// Unlike the TPU kernel, distances are not clamped at 2^20 - 1 (it packs
// them into sort keys) and queries are not pre-doubled, so every int8
// value is exact.  Planar-packed refs (pack 2/4/8) are unpacked by shift
// and mask on their way into shared memory; int4 compute is int8 here
// (Hopper has no int4 mma), which gives the same exact result.
//
// What bounds it on the H100: at the token-serving shape (q [64, 1030],
// refs [2048, 1030]) one call reads 2.2 MB and does 0.3 GOP, a few us of
// either: launch overhead bounds it.  At the genotype-index shape (1024
// queries vs 664,648 binary vectors, d = 2040, pack 8: 170 MB) it does
// 2.8 T int8 operations, 1.41 ms at 1979 TOP/s: operations bound it.
// The TPU kernel walked ref tiles in grid order and carried each query
// tile's top-k in scratch; GPU blocks run in no order, so:
//   pass 1: grid (query tile of 64, split of the ref rows).  The block
//     keeps its 64 queries in shared memory for its whole split, streams
//     the split's ref tiles (64 rows, 128-byte d chunks prefetched into
//     registers during the previous chunk's products), forms q.r with
//     mma.sync m16n8k32 s8 -> s32, turns each 64 x 64 tile into distances
//     and lets one warp per query row insert the tile's candidates below
//     the row's k-th best into its sorted list in shared memory (ballot
//     over the tile, then a warp-wide shift-insert; ref rows arrive in
//     ascending id order, so a strict < keeps the lower id on ties).
//     Each split writes its sorted [k] list per query.
//   pass 2: one warp per query merges the splits' lists in split order
//     with the same insert: lower ids come from earlier splits, so the
//     tie rule holds.  No atomics: reruns are bit-identical.
// Loads are synchronous; cp.async/TMA and wgmma are later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kBQ = 64;        // queries per pass-1 block (16 per warp)
constexpr int kBN = 64;        // ref rows per tile
constexpr int kKD = 128;       // unpacked bytes of d per chunk
constexpr int kThreads = 128;
constexpr int kLdsR = kKD + 16;   // ref chunk row stride (bytes)
constexpr int kLdsD = kBN + 4;    // distance tile row stride (ints)
constexpr int kDistInf = INT_MAX - 1;   // a row whose norm is +inf
constexpr int kEmpty = INT_MAX;         // a slot no row has filled
constexpr int kNormInf = -1;            // rn_s: the row's norm is +inf
constexpr int kNormOut = -2;            // rn_s: past the split or N
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes of one row at byte column `col` (a multiple of 16); bytes at or
// past the row width `w` are zero.  `align` is the largest of 16/8/4 that
// divides both the base address and the row stride (1 otherwise).
__device__ __forceinline__ uint4 load16(const int8_t* row, int col, int w,
                                        int align) {
  if (col >= w) return make_uint4(0, 0, 0, 0);
  const int8_t* p = row + col;
  if (col + 16 <= w) {
    if (align == 16) return *reinterpret_cast<const uint4*>(p);
    if (align == 8) {
      const uint2 lo = *reinterpret_cast<const uint2*>(p);
      const uint2 hi = *reinterpret_cast<const uint2*>(p + 8);
      return make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
    if (align == 4) {
      const uint32_t* p4 = reinterpret_cast<const uint32_t*>(p);
      return make_uint4(p4[0], p4[1], p4[2], p4[3]);
    }
  }
  uint32_t wd[4] = {0, 0, 0, 0};
  const int n = min(16, w - col);
  for (int i = 0; i < n; ++i) {
    wd[i >> 2] |= (uint32_t)(uint8_t)p[i] << (8 * (i & 3));
  }
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// One 16-byte group of the unpacked ref chunk [u0, u0 + 128): row `row`,
// chunk bytes [c, c + 16).  Planar-packed rows hold plane m of unpacked
// columns [m * d8, (m + 1) * d8) at bit offset m * bits of each byte.
__device__ __forceinline__ uint4 fetch_ref(const int8_t* __restrict__ r,
                                           int row, int n_end, int rw,
                                           int align, int pack, int u0,
                                           int c) {
  if (row >= n_end) return make_uint4(0, 0, 0, 0);
  const int8_t* base = r + (size_t)row * rw;
  if (pack == 1) return load16(base, u0 + c, rw, align);
  const int bits = 8 / pack;
  const int m = u0 / rw;
  const int shift = m * bits;
  const uint32_t mask = ((1u << bits) - 1) * 0x01010101u;
  uint4 v = load16(base, u0 - m * rw + c, rw, align);
  v.x = (v.x >> shift) & mask;
  v.y = (v.y >> shift) & mask;
  v.z = (v.z >> shift) & mask;
  v.w = (v.w >> shift) & mask;
  return v;
}

// Insert (cd, ci) into the sorted list ld/li of length k (warp-wide; every
// lane passes the same candidate).  Entries i = lane + 32 j.  The new entry
// goes after every entry with a distance <= cd: callers offer candidates in
// ascending id order among equal distances.  Requires cd < ld[k - 1].
__device__ __forceinline__ void insert(int* ld, int* li, int k, int cd,
                                       int ci, int lane) {
  int p = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = lane + 32 * j;
    p += __popc(__ballot_sync(kFull, i < k && ld[i] <= cd));
  }
  int nd[4], ni[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = lane + 32 * j;
    nd[j] = cd;
    ni[j] = ci;
    if (i < k && i > p) {
      nd[j] = ld[i - 1];
      ni[j] = li[i - 1];
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = lane + 32 * j;
    if (i < k && i >= p) {
      ld[i] = nd[j];
      li[i] = ni[j];
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
l2rf_split_topk(const int8_t* __restrict__ q, const int8_t* __restrict__ r,
                const float* __restrict__ rnorm, int* __restrict__ cand_d,
                int* __restrict__ cand_i, int B, int N, int d, int rw,
                int pack, int Dp, int k, int kp, int rows_per_split,
                int q_align, int r_align) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldq = Dp + 16;
  int8_t* Qs = reinterpret_cast<int8_t*>(smem);
  unsigned char* U = smem + (size_t)kBQ * ldq;   // ref chunk | distances
  int8_t* Rs = reinterpret_cast<int8_t*>(U);
  int* Ds = reinterpret_cast<int*>(U);
  int* Ld = reinterpret_cast<int*>(U + kBQ * kLdsD * sizeof(int));
  int* Li = Ld + kBQ * kp;
  int* qn_s = Li + kBQ * kp;
  int* rn_s = qn_s + kBQ;

  const int b0 = blockIdx.x * kBQ;
  const int split = blockIdx.y;
  const int n_begin = split * rows_per_split;
  const int n_end = min(n_begin + rows_per_split, N);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;

  // The block's queries, zero past d and past B, stay for the whole split.
  const int groups = Dp / 16;
  for (int i = tid; i < kBQ * groups; i += kThreads) {
    const int row = i / groups;
    const int col = (i % groups) * 16;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (b0 + row < B) v = load16(q + (size_t)(b0 + row) * d, col, d, q_align);
    *reinterpret_cast<uint4*>(Qs + row * ldq + col) = v;
  }
  for (int i = tid; i < kBQ * kp; i += kThreads) {
    Ld[i] = kEmpty;
    Li[i] = -1;
  }
  __syncthreads();
  for (int row = warp; row < kBQ; row += kThreads / 32) {
    int s = 0;
    for (int c = lane * 4; c < Dp; c += 128) {
      const int w = (int)ld32(Qs + row * ldq + c);
      s = __dp4a(w, w, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    if (lane == 0) qn_s[row] = s;
  }

  const int row_base = warp * 16;
  const int nchunks = Dp / kKD;
  for (int n0 = n_begin; n0 < n_end; n0 += kBN) {
    int acc[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
    }
    uint4 pre[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + j * kThreads;
      pre[j] = fetch_ref(r, n0 + i / 8, n_end, rw, r_align, pack, 0,
                         (i % 8) * 16);
    }
    for (int ch = 0; ch < nchunks; ++ch) {
      __syncthreads();   // the previous chunk's products (or tile's
                         // selection) are done with U
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = tid + j * kThreads;
        *reinterpret_cast<uint4*>(Rs + (i / 8) * kLdsR + (i % 8) * 16) = pre[j];
      }
      if (ch == 0 && tid < kBN) {
        const int n = n0 + tid;
        int v = kNormOut;
        if (n < n_end) {
          const float x = rnorm[n];
          v = isinf(x) ? kNormInf : (int)x;
        }
        rn_s[tid] = v;
      }
      __syncthreads();
      if (ch + 1 < nchunks) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = tid + j * kThreads;
          pre[j] = fetch_ref(r, n0 + i / 8, n_end, rw, r_align, pack,
                             (ch + 1) * kKD, (i % 8) * 16);
        }
      }
      const int u0 = ch * kKD;
#pragma unroll
      for (int ks = 0; ks < kKD / 32; ++ks) {
        const int8_t* qa = Qs + (row_base + g) * ldq + u0 + ks * 32 + t * 4;
        uint32_t a[4];
        a[0] = ld32(qa);
        a[1] = ld32(qa + 8 * ldq);
        a[2] = ld32(qa + 16);
        a[3] = ld32(qa + 8 * ldq + 16);
#pragma unroll
        for (int nt = 0; nt < kBN / 8; ++nt) {
          const int8_t* rr = Rs + (nt * 8 + g) * kLdsR + ks * 32 + t * 4;
          mma_s8(acc[nt], a, ld32(rr), ld32(rr + 16));
        }
      }
    }
    __syncthreads();   // every warp is done reading the ref chunk
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = nt * 8 + t * 2 + (j & 1);
        const int row = row_base + g + (j >> 1) * 8;
        const int rv = rn_s[col];
        int dist;
        if (rv == kNormOut) dist = kEmpty;
        else if (rv == kNormInf) dist = kDistInf;
        else dist = qn_s[row] + rv - 2 * acc[nt][j];
        Ds[row * kLdsD + col] = dist;
      }
    }
    __syncthreads();
    // Row `row` belongs to warp row % 4 in every tile.
    for (int row = warp; row < kBQ; row += kThreads / 32) {
      if (b0 + row >= B) break;
      int* ld = Ld + row * kp;
      int* li = Li + row * kp;
      int tau = ld[k - 1];
#pragma unroll
      for (int m = 0; m < kBN / 32; ++m) {
        const int v = Ds[row * kLdsD + m * 32 + lane];
        unsigned bits = __ballot_sync(kFull, v < tau);
        while (bits) {
          const int src = __ffs(bits) - 1;
          bits &= bits - 1;
          const int cv = __shfl_sync(kFull, v, src);
          if (cv < tau) {
            insert(ld, li, k, cv, n0 + m * 32 + src, lane);
            tau = ld[k - 1];
          }
        }
      }
    }
  }

  for (int row = warp; row < kBQ; row += kThreads / 32) {
    const int b = b0 + row;
    if (b >= B) break;
    const size_t out = ((size_t)split * B + b) * k;
    for (int i = lane; i < k; i += 32) {
      cand_d[out + i] = Ld[row * kp + i];
      cand_i[out + i] = Li[row * kp + i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
l2rf_merge(const int* __restrict__ cand_d, const int* __restrict__ cand_i,
           float* __restrict__ vals, int* __restrict__ ids, int B, int k,
           int kp, int splits) {
  extern __shared__ int lists[];   // per warp: ld [kp], li [kp]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * (kThreads / 32) + warp;
  if (b >= B) return;
  int* ld = lists + warp * 2 * kp;
  int* li = ld + kp;
  for (int i = lane; i < kp; i += 32) {
    ld[i] = kEmpty;
    li[i] = -1;
  }
  __syncwarp();
  int tau = kEmpty;
  for (int s = 0; s < splits; ++s) {
    const size_t base = ((size_t)s * B + b) * k;
    for (int i0 = 0; i0 < k; i0 += 32) {
      const int i = i0 + lane;
      const int v = i < k ? cand_d[base + i] : kEmpty;
      const int id = i < k ? cand_i[base + i] : -1;
      unsigned bits = __ballot_sync(kFull, v < tau);
      if (!bits) break;   // each split's list is sorted
      while (bits) {
        const int src = __ffs(bits) - 1;
        bits &= bits - 1;
        const int cv = __shfl_sync(kFull, v, src);
        const int cid = __shfl_sync(kFull, id, src);
        if (cv < tau) {
          insert(ld, li, k, cv, cid, lane);
          tau = ld[k - 1];
        }
      }
    }
  }
  for (int i = lane; i < k; i += 32) {
    const int dv = ld[i];
    vals[(size_t)b * k + i] = dv >= kDistInf ? CUDART_INF_F : (float)dv;
    ids[(size_t)b * k + i] = dv == kEmpty ? -1 : li[i];
  }
}

}  // namespace

// Shared memory of one pass-1 block, in bytes (the wrapper checks it
// against the card's limit before launching).
extern "C" int l2_topk_rf_smem(int Dp, int kp) {
  return kBQ * (Dp + 16) + kBQ * kLdsD * (int)sizeof(int) +
         2 * kBQ * kp * (int)sizeof(int) + (kBQ + kBN) * (int)sizeof(int);
}

// q [B, d] int8; r [N, rw] int8 (pack 1: rw = d; pack 2/4/8: planar-packed,
// rw a multiple of 128 and d <= rw * pack); rnorm [N] f32; Dp the unpacked
// width rounded up to 128 (pack > 1: rw * pack); kp = k rounded up to 32;
// cand_d/cand_i [splits, B, k] int32 workspace; vals [B, k] f32, ids
// [B, k] int32; q_align/r_align as for load16.  Returns the CUDA error
// code of the launches (0 on success).
extern "C" int l2_topk_rf_s8(const void* q, const void* r, const void* rnorm,
                             void* cand_d, void* cand_i, void* vals,
                             void* ids, int B, int N, int d, int rw,
                             int pack, int Dp, int k, int kp, int splits,
                             int rows_per_split, int q_align, int r_align,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem1 = l2_topk_rf_smem(Dp, kp);
  cudaError_t err = cudaFuncSetAttribute(
      l2rf_split_topk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid1((B + kBQ - 1) / kBQ, splits);
  l2rf_split_topk<<<grid1, kThreads, smem1, s>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(r),
      static_cast<const float*>(rnorm), static_cast<int*>(cand_d),
      static_cast<int*>(cand_i), B, N, d, rw, pack, Dp, k, kp,
      rows_per_split, q_align, r_align);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps = kThreads / 32;
  l2rf_merge<<<(B + warps - 1) / warps, kThreads,
               warps * 2 * kp * (int)sizeof(int), s>>>(
      static_cast<const int*>(cand_d), static_cast<const int*>(cand_i),
      static_cast<float*>(vals), static_cast<int*>(ids), B, k, kp, splits);
  return (int)cudaGetLastError();
}
