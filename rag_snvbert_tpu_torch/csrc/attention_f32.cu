// Float32 attention with dropout on the attention probabilities, for Hopper
// (sm_90a): the forward, the backward (three kernels: rowsum(do * o), dk
// and dv with each key block's part of dq, the sum of the parts), and the
// packing of a bool keep mask into bits.
//
// Replaces no TPU kernel: the JAX package runs float32 attention with
// dropout as XLA's einsum path (rag_snvbert_tpu/models/transformer.py
// :220-233), and so did the port (models/transformer.py::_core).  That path
// keeps for the backward the float32 probabilities [B, H, L, L], the bool
// keep mask and the dropped probabilities, 9 bytes a score: at upstream
// V18's training shape (48 sequences of 12 heads, L = 1030, 12 layers) 88 GB
// at batch 24, more than the card holds.  These kernels keep the row
// log-sum-exp and the mask at one bit a score, and recompute the
// probabilities in the backward.
//
// Semantics, for one head with s = q k^T * scale, p = softmax(s) by rows,
// keep the mask the caller drew (models/layers.py::keep_mask: the draws of
// models/layers.py::dropout) and r the rate:
//   o   = (keep ? p / (1 - r) : 0) v
//   lse = log2(sum_j exp2(s_j * log2(e)))      (base 2, as attention.cu)
//   dv  = (keep ? p / (1 - r) : 0)^T do
//   ds  = p * ((keep ? (do v^T) / (1 - r) : 0) - rowsum(do * o))
//   dq  = ds k * scale,  dk = ds^T q * scale
// Without a mask (rate 0, or evaluation) every score is kept and r = 0.
//
// What bounds it on the H100: float32 operations on the CUDA cores (67
// TFLOP/s; TF32 is off in the configurations that take this path).  The
// forward is 4 L^2 hd operations a head and the backward 10 L^2 hd.  Bytes
// (q, k, v, o, their gradients, the LSE and the mask's bits) are a tenth of
// the operations' time at hd 32; the backward's dq parts (below) add 2 x 4
// bytes a query row, head dim and key block, a few percent more.
//
// Design, for head dim 32 (upstream V18's 12 heads of 32 and V17's 6): SIMT,
// one head and 64 rows a block of 128 threads: query rows in the forward, key
// rows in the backward; the block walks the other side in tiles of 64.
// Thread (ty, tx) = (tid / 16, tid % 16) holds rows ty + 8 i (i < 8), score
// columns 4 tx + j (j < 4) and output columns 2 tx + c, so the 16 threads
// of a row share a warp and reduce by xor shuffles.  A product over hd is a sum of outer products from
// shared memory: the row operand row-major (a float4 along hd a row, the
// same for the row's 16 threads), the column operand transposed (a float4
// along the tile's columns).  The score tile goes through shared memory
// once, row-major, as the left operand of the products with v (forward), do
// and q (dk/dv).  Strides padded by 4 floats keep every access free of
// bank conflicts.  The forward is flash attention's online softmax.  The
// backward is one pass over key blocks: a block keeps its keys' dk and dv
// in registers over every query tile and writes its key block's part of dq
// (ds k over its 64 keys) for each query tile; a second kernel sums the
// parts over the key blocks, so nothing is recomputed and no sum needs
// atomics.  The mask is bits [bh, L, W], W = 2 ceil(L / 64) words a row (bit
// c % 32 of word c / 32 is column c; bits past L are 0), packed once a
// forward by attn_f32_pack_kernel; the backward reads the same bits.  Every
// sum has a fixed order, so reruns are bit-identical.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;             // rows a block; the other side's tile
constexpr int kPad = 4;
constexpr int kTS = kTile + kPad;     // stride of score and transposed tiles

constexpr int kHD = 32;               // head dim
constexpr int kRS = kHD + kPad;       // stride of a row-major tile
constexpr int kCols = kHD / 16;       // output columns a thread

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// A tile is rows [0, 64) of a [rows, kHD] matrix, zero from row `valid`
// on, fetched from device memory into registers (kFetch float4 a thread),
// then put into shared memory row-major (stride kHD + 4) or transposed
// ([kHD][kTS]), or both from one fetch.  A warp fetches 16 rows x 32 bytes
// (whole sectors); its float4 stores of the row-major tile and its scalar
// stores of the transposed one fall in distinct banks.
constexpr int kVecs = kHD / 4;        // float4 a row
constexpr int kFetch = kTile * kVecs / kThreads;
using Regs = float4[kFetch];

__device__ __forceinline__ void tile_at(int f, int& r, int& c) {
  r = (f / (16 * kVecs)) * 16 + f % 16;
  c = ((f / 16) % kVecs) * 4;
}

__device__ __forceinline__ void fetch(Regs& x, const float* src, int valid,
                                      int tid) {
#pragma unroll
  for (int i = 0; i < kFetch; ++i) {
    int r, c;
    tile_at(tid + i * kThreads, r, c);
    x[i] = r < valid
               ? *reinterpret_cast<const float4*>(src + (size_t)r * kHD + c)
               : zero4();
  }
}

__device__ __forceinline__ void put_rows(float* dst, const Regs& x,
                                         int tid) {
#pragma unroll
  for (int i = 0; i < kFetch; ++i) {
    int r, c;
    tile_at(tid + i * kThreads, r, c);
    *reinterpret_cast<float4*>(dst + r * kRS + c) = x[i];
  }
}

__device__ __forceinline__ void put_transposed(float* dst, const Regs& x,
                                               int tid) {
#pragma unroll
  for (int i = 0; i < kFetch; ++i) {
    int r, c;
    tile_at(tid + i * kThreads, r, c);
    dst[(c + 0) * kTS + r] = x[i].x;
    dst[(c + 1) * kTS + r] = x[i].y;
    dst[(c + 2) * kTS + r] = x[i].z;
    dst[(c + 3) * kTS + r] = x[i].w;
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int valid, int tid) {
  Regs x;
  fetch(x, src, valid, tid);
  put_rows(dst, x, tid);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

// acc[i][j] += sum_d A[ty + 8 i][d] Bt[d][4 tx + j], i < R, d < D in order
// (A row-major with stride AS, Bt transposed with stride kTS).
template <int R, int D, int AS>
__device__ __forceinline__ void outer_products(float (&acc)[R][4],
                                               const float* A, const float* Bt,
                                               int ty, int tx) {
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      b[e] = *reinterpret_cast<const float4*>(Bt + (d + e) * kTS + 4 * tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(A + (ty + 8 * i) * AS + d);
      fma4(acc[i], a.x, b[0]);
      fma4(acc[i], a.y, b[1]);
      fma4(acc[i], a.z, b[2]);
      fma4(acc[i], a.w, b[3]);
    }
  }
}

// A score tile's products over hd: acc[i][j] += sum_d A[ty + 8 i][d]
// Bt[d][4 tx + j] (A a row-major tile, stride kHD + 4).
__device__ __forceinline__ void rows_by_cols(float (&acc)[8][4], const float* A,
                                             const float* Bt, int ty, int tx) {
  outer_products<8, kHD, kRS>(acc, A, Bt, ty, tx);
}

template <int C>
__device__ __forceinline__ void load_cols(float (&out)[C], const float* p) {
  static_assert(C == 2, "head dim 32: two output columns a thread");
  const float2 x = *reinterpret_cast<const float2*>(p);
  out[0] = x.x;
  out[1] = x.y;
}

// acc[i][c] += sum_n P[ty + 8 i][n] B[n][C tx + c]   (P a score tile, stride
// kTS; B row-major, stride kHD + 4), n in order.
__device__ __forceinline__ void probs_by_rows(float (&acc)[8][kCols],
                                              const float* P, const float* B,
                                              int ty, int tx) {
  constexpr int C = kCols;
#pragma unroll 2
  for (int n = 0; n < kTile; n += 4) {
    float b[4][C];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      load_cols<C>(b[e], B + (n + e) * kRS + C * tx);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 p = *reinterpret_cast<const float4*>(P + (ty + 8 * i) * kTS + n);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float a = acc[i][c];
        a = fmaf(p.x, b[0][c], a);
        a = fmaf(p.y, b[1][c], a);
        a = fmaf(p.z, b[2][c], a);
        a = fmaf(p.w, b[3][c], a);
        acc[i][c] = a;
      }
    }
  }
}

// The 4 mask bits of query row `row`, columns n0 + 4 tx + j (bit j), or 0
// past the last row.
__device__ __forceinline__ uint32_t row_nibble(const uint32_t* bits, int row,
                                               int L, int W, int n0, int tx) {
  if (row >= L) return 0u;
  return (bits[(size_t)row * W + n0 / 32 + tx / 8] >> (4 * (tx % 8))) & 0xFu;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

constexpr int kFwdSmemBytes = 4 * (2 * kTile * kRS + kHD * kTS + kTile * kTS);

// Grid (ceil(L / 64), bh).  q, k, v, o [bh, L, kHD]; bits [bh, L, W] or
// unused; lse [bh, L] or null.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads) attn_f32_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const uint32_t* __restrict__ bits,
    float* __restrict__ o, float* __restrict__ lse, int L, int W,
    float scale_log2, float inv_keep) {
  constexpr int RS = kRS, C = kCols;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [64][RS]
  float* Kt = Qs + kTile * RS;                   // [kHD][kTS]
  float* Vs = Kt + kHD * kTS;                    // [64][RS]
  float* Ps = Vs + kTile * RS;                   // [64][kTS]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, m0 = blockIdx.x * kTile;
  const size_t base = (size_t)bh * L * kHD;
  const uint32_t* hbits = kDrop ? bits + (size_t)bh * L * W : nullptr;

  load_rows(Qs, q + base + (size_t)m0 * kHD, L - m0, tid);
  float m[8], l[8], acc[8][C];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  for (int n0 = 0; n0 < L; n0 += kTile) {
    Regs kx, vx;
    fetch(kx, k + base + (size_t)n0 * kHD, L - n0, tid);
    fetch(vx, v + base + (size_t)n0 * kHD, L - n0, tid);
    __syncthreads();      // the last tile's readers are done
    put_transposed(Kt, kx, tid);
    put_rows(Vs, vx, tid);
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    rows_by_cols(s, Qs, Kt, ty, tx);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t keep =
          kDrop ? row_nibble(hbits, m0 + ty + 8 * i, L, W, n0, tx) : 0xFu;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = n0 + 4 * tx + j < L ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max(mx));   // finite: a column is valid
      const float alpha = exp2f(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
      float p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = exp2f(s[i][j] - mn);
        l[i] += e;
        p[j] = (keep >> j) & 1u ? e : 0.f;
      }
      *reinterpret_cast<float4*>(Ps + (ty + 8 * i) * kTS + 4 * tx) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();
    probs_by_rows(acc, Ps, Vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float lt = row_sum(l[i]);
    const int row = m0 + ty + 8 * i;
    if (row >= L) continue;
    const float inv = inv_keep / lt;
    float* out = o + base + (size_t)row * kHD + C * tx;
#pragma unroll
    for (int c = 0; c < C; ++c) out[c] = acc[i][c] * inv;
    if (lse != nullptr && tx == 0) lse[(size_t)bh * L + row] = m[i] + log2f(lt);
  }
}

// dsum[r] = sum_c do[r][c] o[r][c], a thread a row.
__global__ void attn_f32_dsum_kernel(const float* __restrict__ o,
                                     const float* __restrict__ dout,
                                     float* __restrict__ dsum, long long rows) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float4* a = reinterpret_cast<const float4*>(o + r * kHD);
  const float4* b = reinterpret_cast<const float4*>(dout + r * kHD);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kHD / 4; ++c) {
    const float4 x = a[c], y = b[c];
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  dsum[r] = s;
}

constexpr int kDkvSmemBytes =
    4 * (4 * kTile * kRS + 3 * kHD * kTS + 2 * kTile * kTS + 2 * kTile);

// Grid (nkb = ceil(L / 64), bh): dk and dv of the 64 key rows of key block
// kb = blockIdx.x, over every query tile, and this key block's part of dq
// (ds k, ds the block's columns of the scores' gradient) into
// dq_parts[kb][bh] [kHD][Lp] (transposed, Lp = 64 nkb: whole tiles), which
// attn_f32_bwd_dq_kernel sums over the key blocks.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads) attn_f32_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    const uint32_t* __restrict__ bits, float* __restrict__ dk,
    float* __restrict__ dv, float* __restrict__ dq_parts, int L, int W,
    float scale_log2, float scale, float inv_keep) {
  constexpr int RS = kRS, C = kCols;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [64][RS]
  float* Vs = Ks + kTile * RS;                   // [64][RS]
  float* Qs = Vs + kTile * RS;                   // [64][RS]
  float* Os = Qs + kTile * RS;                   // [64][RS]  do
  float* Kt = Os + kTile * RS;                   // [kHD][kTS] k^T
  float* Qt = Kt + kHD * kTS;                    // [kHD][kTS]
  float* Ot = Qt + kHD * kTS;                    // [kHD][kTS] do^T
  float* Ps = Ot + kHD * kTS;                    // [64][kTS] dropped p^T
  float* Ss = Ps + kTile * kTS;                  // [64][kTS] ds^T
  float* Ls = Ss + kTile * kTS;                  // [64] lse
  float* Ds = Ls + kTile;                        // [64] dsum
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, n0 = blockIdx.x * kTile;
  const size_t base = (size_t)bh * L * kHD, rbase = (size_t)bh * L;
  const uint32_t* hbits = kDrop ? bits + rbase * W : nullptr;
  const int Lp = gridDim.x * kTile;
  float* parts = dq_parts +
                 ((size_t)blockIdx.x * gridDim.y + bh) * kHD * (size_t)Lp;

  {
    Regs kx;
    fetch(kx, k + base + (size_t)n0 * kHD, L - n0, tid);
    put_rows(Ks, kx, tid);
    put_transposed(Kt, kx, tid);
  }
  load_rows(Vs, v + base + (size_t)n0 * kHD, L - n0, tid);
  float dva[8][C], dka[8][C];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dva[i][c] = dka[i][c] = 0.f;

  for (int m0 = 0; m0 < L; m0 += kTile) {
    Regs qx, ox;      // one fetch for both layouts
    fetch(qx, q + base + (size_t)m0 * kHD, L - m0, tid);
    fetch(ox, dout + base + (size_t)m0 * kHD, L - m0, tid);
    __syncthreads();
    put_rows(Qs, qx, tid);
    put_transposed(Qt, qx, tid);
    put_rows(Os, ox, tid);
    put_transposed(Ot, ox, tid);
    if (tid < kTile) {
      const int r = m0 + tid;
      Ls[tid] = r < L ? lse[rbase + r] : INFINITY;   // p = 0 past the rows
      Ds[tid] = r < L ? dsum[rbase + r] : 0.f;
    }
    __syncthreads();
    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    rows_by_cols(s, Ks, Qt, ty, tx);     // s^T: key rows, query columns
    rows_by_cols(dp, Vs, Ot, ty, tx);    // (do v^T)^T
    float lj[4], dj[4];
    uint2 w[4];     // query row 4 tx + j's bits of key rows n0 .. n0 + 63
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lj[j] = Ls[4 * tx + j];
      dj[j] = Ds[4 * tx + j];
      const int r = m0 + 4 * tx + j;
      w[j] = make_uint2(0u, 0u);
      if (kDrop && r < L)
        w[j] = *reinterpret_cast<const uint2*>(hbits + (size_t)r * W + n0 / 32);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const bool key_ok = n0 + ty + 8 * i < L;
      float pd[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = key_ok ? exp2f(s[i][j] * scale_log2 - lj[j]) : 0.f;
        const bool keep =
            !kDrop || (((i < 4 ? w[j].x : w[j].y) >> (ty + 8 * (i % 4))) & 1u);
        pd[j] = keep ? p * inv_keep : 0.f;
        const float dpm = keep ? dp[i][j] * inv_keep : 0.f;
        ds[j] = p * (dpm - dj[j]);
      }
      *reinterpret_cast<float4*>(Ps + (ty + 8 * i) * kTS + 4 * tx) =
          make_float4(pd[0], pd[1], pd[2], pd[3]);
      *reinterpret_cast<float4*>(Ss + (ty + 8 * i) * kTS + 4 * tx) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();
    probs_by_rows(dva, Ps, Os, ty, tx);
    probs_by_rows(dka, Ss, Qs, ty, tx);
    // this key block's dq^T [kHD][64] of the query tile: rows ty + 8 i
    // (i < kHD / 8), query columns 4 tx + j; zero past the query rows (ds = 0)
    float dqa[kHD / 8][4];
#pragma unroll
    for (int i = 0; i < kHD / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dqa[i][j] = 0.f;
    outer_products<kHD / 8, kTile, kTS>(dqa, Kt, Ss, ty, tx);
#pragma unroll
    for (int i = 0; i < kHD / 8; ++i)
      *reinterpret_cast<float4*>(parts + (size_t)(ty + 8 * i) * Lp + m0 +
                                 4 * tx) =
          make_float4(dqa[i][0], dqa[i][1], dqa[i][2], dqa[i][3]);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = n0 + ty + 8 * i;
    if (row >= L) continue;
    float* gv = dv + base + (size_t)row * kHD + C * tx;
    float* gk = dk + base + (size_t)row * kHD + C * tx;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      gv[c] = dva[i][c];
      gk[c] = dka[i][c] * scale;
    }
  }
}

// Grid (nkb, bh), 256 threads: dq [bh, L, kHD] of 64 query rows, the sum of
// dq_parts over the key blocks in their order, times the scale, through a
// transpose in shared memory.
__global__ void __launch_bounds__(256) attn_f32_bwd_dq_kernel(
    const float* __restrict__ dq_parts, float* __restrict__ dq, int L,
    float scale) {
  static_assert(kHD * kTile == 256 * 8, "a thread sums 8 entries");
  __shared__ float T[kHD][kTile + 1];
  const int t = threadIdx.x, bh = blockIdx.y, m0 = blockIdx.x * kTile;
  const int nkb = gridDim.x, Lp = nkb * kTile;
  const int c = t / 8, m = 4 * (t % 8);         // entries (c, m .. m + 3)
  float4 a0 = zero4(), a1 = zero4();            // and (c, m + 32 .. m + 35)
  for (int kb = 0; kb < nkb; ++kb) {
    const float* row =
        dq_parts + (((size_t)kb * gridDim.y + bh) * kHD + c) * Lp + m0 + m;
    const float4 x = *reinterpret_cast<const float4*>(row);
    const float4 y = *reinterpret_cast<const float4*>(row + 32);
    a0.x += x.x; a0.y += x.y; a0.z += x.z; a0.w += x.w;
    a1.x += y.x; a1.y += y.y; a1.z += y.z; a1.w += y.w;
  }
  T[c][m] = a0.x; T[c][m + 1] = a0.y; T[c][m + 2] = a0.z; T[c][m + 3] = a0.w;
  T[c][m + 32] = a1.x; T[c][m + 33] = a1.y;
  T[c][m + 34] = a1.z; T[c][m + 35] = a1.w;
  __syncthreads();
  const int r = t / 4, c0 = 8 * (t % 4);        // row r, columns c0 .. + 7
  if (m0 + r >= L) return;
  float* out = dq + ((size_t)bh * L + m0 + r) * kHD + c0;
  *reinterpret_cast<float4*>(out) =
      make_float4(T[c0][r] * scale, T[c0 + 1][r] * scale,
                  T[c0 + 2][r] * scale, T[c0 + 3][r] * scale);
  *reinterpret_cast<float4*>(out + 4) =
      make_float4(T[c0 + 4][r] * scale, T[c0 + 5][r] * scale,
                  T[c0 + 6][r] * scale, T[c0 + 7][r] * scale);
}

// bits [rows, W] from keep [rows, L] (bytes 0 / 1): a warp a row; for
// word w, lane c reads column 32 w + c and the warp's ballot is the word.
// A warp has kPackWords words' loads in flight at once.
constexpr int kPackWords = 8;

__global__ void attn_f32_pack_kernel(const uint8_t* __restrict__ keep,
                                     uint32_t* __restrict__ bits,
                                     long long rows, int L, int W) {
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * blockDim.x / 32;
  for (long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       row < rows; row += warps) {
    const uint8_t* src = keep + row * L;
    uint32_t* dst = bits + row * W;
    for (int w0 = 0; w0 < W; w0 += kPackWords) {
      bool b[kPackWords];
#pragma unroll
      for (int u = 0; u < kPackWords; ++u) {
        const int c = (w0 + u) * 32 + lane;
        b[u] = c < L && src[c] != 0;
      }
#pragma unroll
      for (int u = 0; u < kPackWords; ++u) {
        const uint32_t word = __ballot_sync(0xffffffffu, b[u]);
        if (lane == 0 && w0 + u < W) dst[w0 + u] = word;
      }
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <bool kDrop>
int launch_fwd(const float* q, const float* k, const float* v,
               const uint32_t* bits, float* o, float* lse, int bh, int L,
               int W, float scale, float inv_keep, cudaStream_t s) {
  constexpr int smem = kFwdSmemBytes;
  cudaError_t err = set_smem(attn_f32_fwd_kernel<kDrop>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kTile - 1) / kTile, bh);
  attn_f32_fwd_kernel<kDrop><<<grid, kThreads, smem, s>>>(
      q, k, v, bits, o, lse, L, W, scale * 1.4426950408889634f, inv_keep);
  return (int)cudaGetLastError();
}

template <bool kDrop>
int launch_bwd(const float* q, const float* k, const float* v, const float* o,
               const float* lse, const float* dout, const uint32_t* bits,
               float* dq, float* dk, float* dv, float* dsum, float* dq_parts,
               int bh, int L, int W, float scale, float inv_keep,
               cudaStream_t s) {
  const long long rows = (long long)bh * L;
  attn_f32_dsum_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
      o, dout, dsum, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kTile - 1) / kTile, bh);
  constexpr int smem = kDkvSmemBytes;
  err = set_smem(attn_f32_bwd_dkv_kernel<kDrop>, smem);
  if (err != cudaSuccess) return (int)err;
  attn_f32_bwd_dkv_kernel<kDrop><<<grid, kThreads, smem, s>>>(
      q, k, v, dout, lse, dsum, bits, dk, dv, dq_parts, L, W,
      scale * 1.4426950408889634f, scale, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_f32_bwd_dq_kernel<<<grid, 256, 0, s>>>(dq_parts, dq, L, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// keep: bool (bytes 0 / 1) [rows, L] contiguous; bits: int32 [rows, W],
// W = 2 ceil(L / 64).
extern "C" int attention_f32_pack(const void* keep, void* bits,
                                  long long rows, int L, int W, void* stream) {
  if (rows < 1 || L < 1 || W != 2 * ((L + 63) / 64))
    return (int)cudaErrorInvalidValue;
  const long long want = (rows + 7) / 8;       // 8 warps a block, a row each
  const unsigned grid = (unsigned)(want < 8192 ? want : 8192);
  attn_f32_pack_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(keep), static_cast<uint32_t*>(bits), rows,
      L, W);
  return (int)cudaGetLastError();
}

// q, k, v, o: float32 [bh, L, 32] contiguous, 16-byte aligned; bits: the
// packed keep mask [bh, L, W] or null (no dropout; inv_keep 1); lse: float32
// [bh, L] (base 2) or null.  inv_keep = 1 / (1 - rate).
extern "C" int attention_f32_fwd(const void* q, const void* k, const void* v,
                                 const void* bits, void* o, void* lse, int bh,
                                 int L, float scale, float inv_keep,
                                 void* stream) {
  if (bh < 1 || bh > 65535 || L < 1) return (int)cudaErrorInvalidValue;
  const int W = 2 * ((L + 63) / 64);
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  const uint32_t* b = static_cast<const uint32_t*>(bits);
  float *fo = static_cast<float*>(o), *fl = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return b != nullptr
             ? launch_fwd<true>(fq, fk, fv, b, fo, fl, bh, L, W, scale,
                                inv_keep, s)
             : launch_fwd<false>(fq, fk, fv, b, fo, fl, bh, L, W, scale,
                                 inv_keep, s);
}

// dq, dk, dv [bh, L, 32] from q, k, v, the forward's o and lse, the output
// gradient dout and the forward's bits (or null); dsum: float32 [bh, L] and
// dq_parts: float32 [nkb, bh, 32, 64 nkb], nkb = ceil(L / 64), scratch.
extern "C" int attention_f32_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* lse,
                                 const void* dout, const void* bits, void* dq,
                                 void* dk, void* dv, void* dsum,
                                 void* dq_parts, int bh, int L, float scale,
                                 float inv_keep, void* stream) {
  if (bh < 1 || bh > 65535 || L < 1) return (int)cudaErrorInvalidValue;
  const int W = 2 * ((L + 63) / 64);
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v),
              *fo = static_cast<const float*>(o),
              *fl = static_cast<const float*>(lse),
              *fd = static_cast<const float*>(dout);
  const uint32_t* b = static_cast<const uint32_t*>(bits);
  float *gq = static_cast<float*>(dq), *gk = static_cast<float*>(dk),
        *gv = static_cast<float*>(dv), *ds = static_cast<float*>(dsum),
        *parts = static_cast<float*>(dq_parts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return b != nullptr
             ? launch_bwd<true>(fq, fk, fv, fo, fl, fd, b, gq, gk, gv, ds,
                                parts, bh, L, W, scale, inv_keep, s)
             : launch_bwd<false>(fq, fk, fv, fo, fl, fd, b, gq, gk, gv, ds,
                                 parts, bh, L, W, scale, inv_keep, s);
}
