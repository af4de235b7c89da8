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
// it.  This design also recomputes S and dP in the dQ pass (two products
// the bound does not count).
//
// Design.  Splash accumulates dq across sequential TPU grid steps; GPU
// blocks run in no order, so the work is split into three launches on one
// stream, none with atomics (runs are bit-identical):
//   (a) row_dot: D = rowsum(dO o O) in fp32, one warp per row;
//   (b) dkv: one block of four warps per (stream*head, 64-key tile), each
//       warp owning 16 keys; a loop over 64-query tiles staged in shared
//       memory, 16 queries at a time.  It computes S^T = K Q^T and
//       dP^T = V dO^T directly (keys as mma rows), so P^T and dS^T come out
//       as C fragments and become the A operands of dV += P^T dO and
//       dK += dS^T Q without a transpose; dV and dK accumulate in fp32
//       registers;
//   (c) dq: one block per (stream*head, 64-query tile), Q and dO fragments
//       held in registers, a loop over 64-key tiles: S, dP, dS as in (b)
//       with queries as rows, dQ += dS K in fp32 registers.
// mma.sync m16n8k16 bf16 with fp32 accumulation throughout; P and dS are
// rounded to bf16 as product operands.  L runs ragged: keys at or past L
// get P = 0, rows at or past L are loaded as zeros and never written.
// Loads are synchronous (no cp.async/TMA, no wgmma): making it fast is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;     // keys per dkv block, queries per dq block
constexpr int kThreads = 128; // four warps, 16 rows each
constexpr int kPad = 8;       // bf16 of row padding in shared memory
constexpr int kRowDotRows = 8;  // rows per row_dot block (one per warp)

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

// Two bf16 that are not adjacent in memory, low half first.
__device__ __forceinline__ uint32_t ld_pair2(const __nv_bfloat16* lo,
                                             const __nv_bfloat16* hi) {
  uint32_t l = *reinterpret_cast<const uint16_t*>(lo);
  uint32_t h = *reinterpret_cast<const uint16_t*>(hi);
  return l | (h << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of one head's [L, HD] matrix into shared memory
// (row stride HD + kPad); rows at or past L become zeros.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int L) {
  constexpr int kVec = 8;                 // 16 bytes per load
  constexpr int kPerRow = HD / kVec;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < L) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + c);
    }
    *reinterpret_cast<uint4*>(dst + r * (HD + kPad) + c) = val;
  }
}

// A fragment (16 rows x 16 columns starting at col) of a shared tile.
__device__ __forceinline__ void ld_a_frag(uint32_t a[4],
                                          const __nv_bfloat16* tile, int ld,
                                          int row, int col) {
  a[0] = ld_pair(tile + row * ld + col);
  a[1] = ld_pair(tile + (row + 8) * ld + col);
  a[2] = ld_pair(tile + row * ld + col + 8);
  a[3] = ld_pair(tile + (row + 8) * ld + col + 8);
}

// (a) D[r] = sum_c dO[r, c] * O[r, c], fp32, one warp per row.
template <int HD>
__global__ void __launch_bounds__(32 * kRowDotRows)
row_dot_kernel(const __nv_bfloat16* __restrict__ o,
               const __nv_bfloat16* __restrict__ dout,
               float* __restrict__ dsum, int rows) {
  const int row = blockIdx.x * kRowDotRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps leave together
  const __nv_bfloat16* a = o + (size_t)row * HD;
  const __nv_bfloat16* b = dout + (size_t)row * HD;
  float s = 0.f;
#pragma unroll
  for (int c = lane; c < HD; c += 32) {
    s += __bfloat162float(a[c]) * __bfloat162float(b[c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffff, s, off);
  }
  if (lane == 0) dsum[row] = s;
}

// (b) dK, dV for one (stream*head, 64-key tile).
template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int L, float scale,
                         float scale_log2) {
  constexpr int LD = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kTile * LD;
  __nv_bfloat16* Qs = Vs + kTile * LD;
  __nv_bfloat16* dOs = Qs + kTile * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + kTile * LD);
  float* d_s = lse_s + kTile;

  const size_t head = (size_t)blockIdx.y * L * HD;
  const size_t rows = (size_t)blockIdx.y * L;
  const int k0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in group
  const int r = warp * 16 + g;  // this thread's key rows r and r + 8

  load_tile<HD>(Ks, k + head, k0, L);
  load_tile<HD>(Vs, v + head, k0, L);

  float dv_acc[HD / 8][4], dk_acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) dv_acc[i][j] = dk_acc[i][j] = 0.f;
  }

  const int n_tiles = (L + kTile - 1) / kTile;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // every warp is done with the previous query tile
    load_tile<HD>(Qs, q + head, q0, L);
    load_tile<HD>(dOs, dout + head, q0, L);
    if (threadIdx.x < kTile) {
      const bool ok = q0 + threadIdx.x < L;
      lse_s[threadIdx.x] = ok ? lse[rows + q0 + threadIdx.x] : 0.f;
      d_s[threadIdx.x] = ok ? dsum[rows + q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int qc = 0; qc < kTile; qc += 16) {
      // S^T = K Q^T and dP^T = V dO^T for 16 keys x 16 queries.
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[n][j] = dp[n][j] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk * 16 + t * 2;
        uint32_t ka[4], va[4];
        ld_a_frag(ka, Ks, LD, r, kk * 16 + t * 2);
        ld_a_frag(va, Vs, LD, r, kk * 16 + t * 2);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const __nv_bfloat16* qb = Qs + (qc + n * 8 + g) * LD + c;
          const __nv_bfloat16* ob = dOs + (qc + n * 8 + g) * LD + c;
          mma_bf16(s[n], ka, ld_pair(qb), ld_pair(qb + 8));
          mma_bf16(dp[n], va, ld_pair(ob), ld_pair(ob + 8));
        }
      }

      // P^T = exp2(S^T * scale_log2 - lse[query]), 0 for queries at or past
      // L; dS^T = P^T (dP^T - D[query]).  The C fragments of the two n
      // tiles form one A fragment (16 queries along k).
      uint32_t pa[4], dsa[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float p[4], ds[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qi = qc + n * 8 + t * 2 + j;
          const bool ok = q0 + qi < L;
          const float l = lse_s[qi], dd = d_s[qi];
          p[j] = ok ? exp2f(s[n][j] * scale_log2 - l) : 0.f;
          p[2 + j] = ok ? exp2f(s[n][2 + j] * scale_log2 - l) : 0.f;
          ds[j] = p[j] * (dp[n][j] - dd);
          ds[2 + j] = p[2 + j] * (dp[n][2 + j] - dd);
        }
        pa[n * 2 + 0] = pack_bf16(p[0], p[1]);
        pa[n * 2 + 1] = pack_bf16(p[2], p[3]);
        dsa[n * 2 + 0] = pack_bf16(ds[0], ds[1]);
        dsa[n * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T dO and dK += dS^T Q over these 16 queries: B[query][col]
      // pairs along the query axis.
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const __nv_bfloat16* ob = dOs + (qc + t * 2) * LD + i * 8 + g;
        const __nv_bfloat16* qb = Qs + (qc + t * 2) * LD + i * 8 + g;
        mma_bf16(dv_acc[i], pa, ld_pair2(ob, ob + LD),
                 ld_pair2(ob + 8 * LD, ob + 9 * LD));
        mma_bf16(dk_acc[i], dsa, ld_pair2(qb, qb + LD),
                 ld_pair2(qb + 8 * LD, qb + 9 * LD));
      }
    }
  }

  const int row0 = k0 + r, row1 = row0 + 8;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int c = i * 8 + t * 2;
    if (row0 < L) {
      const size_t at = head + (size_t)row0 * HD + c;
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack_bf16(dv_acc[i][0], dv_acc[i][1]);
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16(dk_acc[i][0] * scale, dk_acc[i][1] * scale);
    }
    if (row1 < L) {
      const size_t at = head + (size_t)row1 * HD + c;
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack_bf16(dv_acc[i][2], dv_acc[i][3]);
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16(dk_acc[i][2] * scale, dk_acc[i][3] * scale);
    }
  }
}

// (c) dQ for one (stream*head, 64-query tile).
template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        __nv_bfloat16* __restrict__ dq, int L, float scale,
                        float scale_log2) {
  constexpr int LD = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kTile * LD;

  const size_t head = (size_t)blockIdx.y * L * HD;
  const size_t rows = (size_t)blockIdx.y * L;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r = warp * 16 + g;
  const int row0 = q0 + r, row1 = row0 + 8;

  // Q and dO of this warp's 16 rows as A fragments, staged through the
  // K/V buffers before the key loop reuses them.
  load_tile<HD>(Ks, q + head, q0, L);
  load_tile<HD>(Vs, dout + head, q0, L);
  __syncthreads();
  uint32_t qa[HD / 16][4], oa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    ld_a_frag(qa[kk], Ks, LD, r, kk * 16 + t * 2);
    ld_a_frag(oa[kk], Vs, LD, r, kk * 16 + t * 2);
  }
  const float l0 = row0 < L ? lse[rows + row0] : 0.f;
  const float l1 = row1 < L ? lse[rows + row1] : 0.f;
  const float d0 = row0 < L ? dsum[rows + row0] : 0.f;
  const float d1 = row1 < L ? dsum[rows + row1] : 0.f;

  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  const int n_tiles = (L + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // fragments read / previous K, V tile consumed
    load_tile<HD>(Ks, k + head, k0, L);
    load_tile<HD>(Vs, v + head, k0, L);
    __syncthreads();

#pragma unroll 1
    for (int kc = 0; kc < kTile; kc += 16) {
      // S = Q K^T and dP = dO V^T for 16 queries x 16 keys.
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[n][j] = dp[n][j] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int at = (kc + n * 8 + g) * LD + kk * 16 + t * 2;
          mma_bf16(s[n], qa[kk], ld_pair(Ks + at), ld_pair(Ks + at + 8));
          mma_bf16(dp[n], oa[kk], ld_pair(Vs + at), ld_pair(Vs + at + 8));
        }
      }

      // dS = P (dP - D), P = exp2(S * scale_log2 - lse), 0 for keys at or
      // past L.
      uint32_t dsa[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float ds[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool ok = k0 + kc + n * 8 + t * 2 + j < L;
          const float p0 = ok ? exp2f(s[n][j] * scale_log2 - l0) : 0.f;
          const float p1 = ok ? exp2f(s[n][2 + j] * scale_log2 - l1) : 0.f;
          ds[j] = p0 * (dp[n][j] - d0);
          ds[2 + j] = p1 * (dp[n][2 + j] - d1);
        }
        dsa[n * 2 + 0] = pack_bf16(ds[0], ds[1]);
        dsa[n * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dQ += dS K: B[key][col] pairs along the key axis.
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const __nv_bfloat16* kb = Ks + (kc + t * 2) * LD + i * 8 + g;
        mma_bf16(acc[i], dsa, ld_pair2(kb, kb + LD),
                 ld_pair2(kb + 8 * LD, kb + 9 * LD));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int c = i * 8 + t * 2;
    if (row0 < L) {
      *reinterpret_cast<uint32_t*>(dq + head + (size_t)row0 * HD + c) =
          pack_bf16(acc[i][0] * scale, acc[i][1] * scale);
    }
    if (row1 < L) {
      *reinterpret_cast<uint32_t*>(dq + head + (size_t)row1 * HD + c) =
          pack_bf16(acc[i][2] * scale, acc[i][3] * scale);
    }
  }
}

template <int HD>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, const __nv_bfloat16* o,
           const float* lse, const __nv_bfloat16* dout, __nv_bfloat16* dq,
           __nv_bfloat16* dk, __nv_bfloat16* dv, float* dsum, int bh, int L,
           float scale, cudaStream_t stream) {
  const int rows = bh * L;
  row_dot_kernel<HD><<<(rows + kRowDotRows - 1) / kRowDotRows,
                       32 * kRowDotRows, 0, stream>>>(o, dout, dsum, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const float scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid((L + kTile - 1) / kTile, bh);
  const size_t tile_bytes = (size_t)kTile * (HD + kPad) * sizeof(__nv_bfloat16);
  const size_t smem_dkv = 4 * tile_bytes + 2 * kTile * sizeof(float);
  err = cudaFuncSetAttribute(attention_bwd_dkv_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkv);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkv_kernel<HD><<<grid, kThreads, smem_dkv, stream>>>(
      q, k, v, dout, lse, dsum, dk, dv, L, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_dq = 2 * tile_bytes;
  err = cudaFuncSetAttribute(attention_bwd_dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dq_kernel<HD><<<grid, kThreads, smem_dq, stream>>>(
      q, k, v, dout, lse, dsum, dq, L, scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: bf16 [bh, L, hd] contiguous, 16-byte
// aligned; lse: fp32 [bh, L] in base 2 (attention_fwd_bf16's); dsum: fp32
// [bh, L] scratch.  Launches the three kernels on ``stream`` and returns the
// CUDA error code of the launches (0 on success).
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
