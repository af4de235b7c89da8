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
// r the rate and keep the mask the caller drew (models/layers.py::keep_draws
// >= r, as models/layers.py::dropout draws it):
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
// bytes a query row, head dim and block of 128 keys, a few percent more.
// On the CUDA cores every instruction that is not an FMA takes an FMA's
// issue slot, so the designs count loads, address arithmetic and the
// softmax's instructions against the products, and keep enough warps to
// hide the latency of each.
//
// The forward, for head dim 32 (upstream V18's 12 heads of 32 and V17's 6):
// one head and 64 query rows a block of 128 threads, walking the keys in
// tiles of 64 with flash attention's online softmax; 57 KB of shared memory
// and 168 registers a thread, so three blocks, 12 warps an SM (at 128
// registers, four blocks, it spilled and ran slower).  Warp w owns query
// rows 16 w .. 16 w + 15: a thread holds 4 rows x 8 key columns of the
// scores and 4 rows x 4 head columns of the output, and the dropped
// probabilities reach the product with v through shared memory in the
// warp's own rows, behind __syncwarp.  The operands share the backward's
// swizzled layout (below).  k and v tiles arrive by cp.async into two
// stages, a tile ahead: one barrier a tile.  With dropout the kernel takes
// the caller's uniform draws [B, H, L, L] (models/layers.py::keep_draws),
// keeps a score where its draw >= rate and writes the mask's bits for the
// backward: a warp's draws of the next key tile arrive in registers while
// it multiplies by v, a lane a column of each (row, word), so one ballot is
// one mask word.  No separate pass reads the draws, and no bool mask [B, H,
// L, L] is written.  Given a bool mask (the op's other entry), it reads the
// bits that attn_f32_pack_kernel packed from it.

// The backward is one pass over blocks of 128 keys (attn_f32_bwd_dkv_kernel):
// a block keeps its keys' dk and dv over every query tile of 64 and writes
// its part of dq (ds k over its keys) for each tile; attn_f32_bwd_dq_kernel
// sums the parts over the blocks, so nothing is recomputed and no sum needs
// atomics.  256 threads and 110 KB of shared memory a block, 128 registers a
// thread: two blocks, 16 warps an SM, 4 a scheduler.  Each operand has one
// layout in shared memory, [rows][32] with its 16-byte groups swizzled (group
// c of row r at c ^ ((r / 4) % 8)) in place of padding: a thread's 4 x 4
// block of a product reads 4 rows of one side and 4 of the other a float4
// along hd each (the transposed side's 4 x 4 block is the same 16 floats),
// and the 8 rows a warp reads at one group fall in distinct banks.  Warp w
// owns key rows 16 w .. 16 w + 15 of the scores and their gradients, so the
// products of p^T with do and of ds^T with q read only the warp's rows of
// the score tile, behind __syncwarp; the one tile holds p^T and then ds^T, a
// column group of 32 at a time, with 32 score sums, 16 dv sums and the
// operands in registers, and dk's sums in shared memory between tiles.  A
// tile's q, do, LSE, row sums and mask words arrive by cp.async while the
// tile before computes its dq part, which is the one phase that reads them
// no more; two barriers a tile.  The key block that holds at most 16 keys
// (L % 128 of them) runs four warps on every fourth tile each instead of one
// warp on all.  exp2 is the MUFU's, flushed to zero below 2^-126.  The
// mask is bits [bh, L, W], W = 2 ceil(L / 64) words a row (bit c % 32 of word
// c / 32 is column c; bits past L are 0), written by the forward (from the
// draws, or packed from a bool mask by attn_f32_pack_kernel); the backward
// reads the same bits.  Every sum has a fixed order, so reruns are
// bit-identical.


#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {
constexpr int kTile = 64;             // query rows of a forward block, and
                                      // the tiles the kernels walk over
constexpr int kHD = 32;               // head dim
constexpr int kVecs = kHD / 4;        // float4 a row

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// ---- tiles in shared memory (the forward and the backward) ----
//
// Tiles of [rows][kHD] floats are swizzled: 16-byte group c of row r sits at
// group c ^ ((r / 4) % 8), so the 8 rows 4 t8 + j a warp reads at one group,
// the 4 rows 16 w + 4 g + i and the 8 groups of one row each fall in
// distinct banks (lane (g, t8) = (lane / 8, lane % 8) of warp w holds rows
// 16 w + 4 g + i, i < 4, of a product).  Score tiles [rows][64] swizzle
// their groups by (r / 4) % 4.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bytes (16 or 4) from device memory to shared memory, zeros where !ok
// (nothing is read then; src must still be an address of the tensor)
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// float offset of 16-byte group grp of row r in a [rows][kHD] tile whose
// rows share the swizzle sw = (r / 4) % 8
__device__ __forceinline__ int at32(int r, int grp, int sw) {
  return r * kHD + ((grp ^ sw) << 2);
}

// the same in the [kKeys][kTile] score tile, sw = (r / 4) % 4
__device__ __forceinline__ int at64(int r, int grp, int sw) {
  return r * kTile + ((grp ^ sw) << 2);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& x, int c) {
  return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}

// rows [0, rows) of a [*, kHD] matrix from src (rows at or past `valid`
// zeros) into the swizzled tile dst: one 16-byte group a thread and pass,
// over the block's kNT threads
template <int kRows, int kNT>
__device__ __forceinline__ void fill_rows(float* dst, const float* src,
                                          int valid, int tid) {
#pragma unroll
  for (int u = 0; u < kRows * kVecs / kNT; ++u) {
    const int f = tid + u * kNT, r = f / kVecs, c = f % kVecs;
    const bool ok = r < valid;
    cp_async<16>(dst + at32(r, c, (r >> 2) & 7),
                 src + (ok ? (size_t)r * kHD + 4 * c : 0), ok);
  }
}

// 2^x of the MUFU unit, flushing to 0 below 2^-126 (exp2f's value there is
// a subnormal, and its range fix-ups cost four instructions a score)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes at byte offset off of shared memory.  The offsets below are of
// swizzled tiles whose rows start on 128 bytes: a row's 16-byte group c ^ sw
// is its start plus ((c ^ sw) << 4) = (start + (sw << 4)) ^ (c << 4), one
// xor a group for every row of the step, whose own offsets are immediates.
__device__ __forceinline__ float4 lds(const char* sm, uint32_t off) {
  return *reinterpret_cast<const float4*>(sm + off);
}

// acc[i][4 G + j] += sum_d A[r + i][d] B[32 (G0 + G) + 4 t8 + j][d], G <
// NG, d in order: A and B swizzled [rows][kHD] tiles at byte offsets a_off,
// b_off of sm; rows r + i (r a multiple of 4) share the swizzle sa, rows
// 32 G + 4 t8 + j the swizzle t8.
template <int NG>
__device__ __forceinline__ void rows_by_rows(float (&acc)[4][4 * NG],
                                             const char* sm, uint32_t a_off,
                                             uint32_t b_off, int r, int sa,
                                             int t8, int G0) {
  const uint32_t a0 = a_off + r * 128 + (sa << 4);
  const uint32_t b0 = b_off + (32 * G0 + 4 * t8) * 128 + (t8 << 4);
#pragma unroll
  for (int grp = 0; grp < kVecs; ++grp) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = lds(sm, (a0 ^ (grp << 4)) + i * 128);
#pragma unroll
    for (int j = 0; j < 4 * NG; ++j) {
      const float4 b = lds(sm, (b0 ^ (grp << 4)) + (32 * (j / 4) + j % 4) * 128);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = acc[i][j];
        x = fmaf(a[i].x, b.x, x);
        x = fmaf(a[i].y, b.y, x);
        x = fmaf(a[i].z, b.z, x);
        x = fmaf(a[i].w, b.w, x);
        acc[i][j] = x;
      }
    }
  }
}

// acc[i][c] += sum_n P[r + i][n] B[n][4 t8 + c], n0 <= n < n1 (multiples of
// 16) in order: P a [rows][kTile] score tile at byte offset p_off, rows r + i
// with swizzle g; B a swizzled [rows][kHD] tile at b_off.
__device__ __forceinline__ void probs_by_rows4(float (&acc)[4][4],
                                               const char* sm, uint32_t p_off,
                                               uint32_t b_off, int r, int g,
                                               int t8, int n0, int n1) {
  for (int n16 = n0; n16 < n1; n16 += 16) {
    // rows n16 + 4 u + e of B have the swizzle ((n16 / 4) & 4) ^ u
    const uint32_t p0 = p_off + r * 256 + n16 * 4 + (g << 4);
    const uint32_t b0 = b_off + n16 * 128 + ((t8 ^ ((n16 >> 2) & 4)) << 4);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 p[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = lds(sm, (p0 ^ (u << 4)) + i * 256);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        b[e] = lds(sm, (b0 ^ (u << 4)) + (4 * u + e) * 128);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = acc[i][c];
          x = fmaf(p[i].x, at(b[0], c), x);
          x = fmaf(p[i].y, at(b[1], c), x);
          x = fmaf(p[i].z, at(b[2], c), x);
          x = fmaf(p[i].w, at(b[3], c), x);
          acc[i][c] = x;
        }
    }
  }
}

// ---- the forward ----
//
// A block of 128 threads takes 64 query rows of one head; warp w owns rows
// 16 w .. 16 w + 15, lane (g, t8) their scores at the key columns 32 G + 4 t8
// + j (G < 2, j < 4) of a tile and their outputs at head columns 4 t8 + c.
// Byte offsets of the shared tiles: q [64][kHD]; two stages of the k and v
// tiles [64][kHD] each; the dropped probabilities [64][64] (warp w's rows
// 16 w ..); the mask words of the tile [64][2] (warp w's 32 from 32 w).
constexpr int kFwdThreads = 128;
constexpr uint32_t kFQOff = 0;
constexpr uint32_t kFKVOff = kFQOff + 4 * kTile * kHD;
constexpr uint32_t kFStage = 2 * 4 * kTile * kHD;   // a stage's k, then v
constexpr uint32_t kFPOff = kFKVOff + 2 * kFStage;
constexpr uint32_t kFMOff = kFPOff + 4 * kTile * kTile;
constexpr int kFwdSmemBytes = kFMOff + 4 * 2 * kTile;

// Where the forward's dropout mask comes from.
enum FwdMask { kNoMask, kMaskBits, kMaskDraws };

// kMaskBits: `bits` [bh, L, W] is read.  kMaskDraws: the draws of head bh
// are the [L, L] rows (stride L) at draws + (bh / heads) * sb + (bh % heads)
// * sh; a score is kept where its draw >= rate, and `bits` receives the mask.
struct FwdMaskArgs {
  const float* draws;
  long long sb, sh;
  int heads;
  float rate;
  uint32_t* bits;
};

// Grid (ceil(L / 64), bh).  q, k, v, o [bh, L, kHD]; lse [bh, L] or null.
// A warp's mask of a key tile is 32 (row, word) pairs, pair p = its row p /
// 2, word p % 2 of the tile.  Per key tile t: one barrier (tile t's k and v
// landed; every warp is done with tile t - 1); the next tile's k and v by
// cp.async into the other stage; the warp's scores q k^T, the online
// softmax, the dropped probabilities into its rows of the probability
// tile; its product with v in two halves of 32 keys, with half of the next
// tile's mask on the way into registers during each (from draws: lane c
// loads column c of each pair, so that one ballot after the half is one
// mask word, written to `bits` too).  Iteration -1 only fetches tile 0's
// mask.  A warp past the last row only loads.
template <int kMode>
__global__ void __launch_bounds__(kFwdThreads, 3) attn_f32_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, FwdMaskArgs mask, float* __restrict__ o,
    float* __restrict__ lse, int L, int W, float scale_log2,
    float inv_keep) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  float* P = reinterpret_cast<float*>(sm + kFPOff);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 8, t8 = lane % 8;
  const int bh = blockIdx.y, m0 = blockIdx.x * kTile, r0 = m0 + 16 * warp;
  const size_t base = (size_t)bh * L * kHD;
  const bool active = r0 < L;             // the warp has a query row
  const int ntiles = (L + kTile - 1) / kTile;
  uint32_t* Mw = reinterpret_cast<uint32_t*>(sm + kFMOff) + 32 * warp;

  // tile n / 64's k and v into stage st, one cp.async group
  auto load_kv = [&](int n, int st) {
    float* ks = reinterpret_cast<float*>(sm + kFKVOff + st * kFStage);
    fill_rows<kTile, kFwdThreads>(ks, k + base + (size_t)n * kHD, L - n, tid);
    fill_rows<kTile, kFwdThreads>(ks + kTile * kHD, v + base + (size_t)n * kHD,
                                  L - n, tid);
    cp_async_commit();
  };
  // Half h of the warp's mask of tile n / 64 (pairs 16 h ..) on its way:
  // from draws, column n + 32 (p % 2) + lane of row r0 + 8 h + p / 2 in d[p]
  // (-1, dropped, past L); from bits, lane p's word in `word` (h = 0).
  float d[kMode == kMaskDraws ? 16 : 1];
  uint32_t word = 0u;
  auto fetch_mask = [&](int n, int h) {
    if constexpr (kMode == kMaskDraws) {
      const float* src = mask.draws + (bh / mask.heads) * mask.sb +
                         (bh % mask.heads) * mask.sh +
                         (size_t)(r0 + 8 * h) * L + n + lane;
      if (r0 + 16 <= L && n + kTile <= L) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          d[2 * r] = __ldcs(src);
          d[2 * r + 1] = __ldcs(src + 32);
          src += L;
        }
      } else {
        const bool c0 = n + lane < L, c1 = n + 32 + lane < L;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const bool row = r0 + 8 * h + r < L;
          d[2 * r] = row && c0 ? __ldcs(src) : -1.f;
          d[2 * r + 1] = row && c1 ? __ldcs(src + 32) : -1.f;
          src += L;
        }
      }
    } else if constexpr (kMode == kMaskBits) {
      if (h == 0)
        word = r0 + lane / 2 < L
                   ? mask.bits[((size_t)bh * L + r0 + lane / 2) * W + n / 32 +
                               lane % 2]
                   : 0u;
    }
  };
  // half h of the mask words of tile n / 64 into Mw (from draws, the
  // second half writes the tile's words to `bits` too)
  auto put_mask = [&](int n, int h) {
    if constexpr (kMode == kMaskDraws) {
#pragma unroll
      for (int p = 0; p < 16; ++p)
        Mw[16 * h + p] = __ballot_sync(0xffffffffu, d[p] >= mask.rate);
      if (h == 1) {
        __syncwarp();
        if (r0 + lane / 2 < L)
          mask.bits[((size_t)bh * L + r0 + lane / 2) * W + n / 32 + lane % 2] =
              Mw[lane];
      }
    } else if constexpr (kMode == kMaskBits) {
      if (h == 1) Mw[lane] = word;
    }
  };

  fill_rows<kTile, kFwdThreads>(reinterpret_cast<float*>(sm + kFQOff),
                                q + base + (size_t)m0 * kHD, L - m0, tid);
  load_kv(0, 0);
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }

  for (int t = kMode == kNoMask ? 0 : -1; t < ntiles; ++t) {
    const int n0 = t * kTile, st = t & 1;
    const bool next = t + 1 < ntiles;
    if (t >= 0) {
      cp_async_wait_all();
      __syncthreads();   // tile t landed; every warp is done with tile t - 1
      if (next) load_kv(n0 + kTile, st ^ 1);
    }
    if (!active) continue;
    if (t >= 0) {
      float s[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) s[i][c] = 0.f;
      rows_by_rows<2>(s, sm, kFQOff, kFKVOff + st * kFStage,
                      16 * warp + 4 * g, (4 * warp + g) & 7, t8, 0);
      const bool past = n0 + kTile > L;   // columns past L in the tile
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (past && n0 + 32 * (c / 4) + 4 * t8 + c % 4 >= L)
            s[i][c] = -INFINITY;
          mx = fmaxf(mx, s[i][c]);
        }
#pragma unroll
        for (int x = 1; x < 8; x <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
        // finite: the tile has a column before L; scale_log2 > 0
        const float mn = fmaxf(m[i], mx * scale_log2);
        const float alpha = ex2(m[i] - mn);
        m[i] = mn;
        l[i] *= alpha;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] *= alpha;
        uint32_t keep = 0xFFu;   // bit c: column 32 (c / 4) + 4 t8 + c % 4
        if constexpr (kMode != kNoMask) {
          const uint2 wd =
              *reinterpret_cast<const uint2*>(Mw + 2 * (4 * g + i));
          keep = ((wd.x >> (4 * t8)) & 0xFu) | (((wd.y >> (4 * t8)) & 0xFu) << 4);
        }
        float p[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float e = ex2(fmaf(s[i][c], scale_log2, -mn));
          l[i] += e;
          p[c] = (keep >> c) & 1u ? e : 0.f;
        }
#pragma unroll
        for (int G = 0; G < 2; ++G)
          *reinterpret_cast<float4*>(
              P + at64(16 * warp + 4 * g + i, 8 * G + t8, g)) =
              make_float4(p[4 * G], p[4 * G + 1], p[4 * G + 2], p[4 * G + 3]);
      }
      __syncwarp();   // the warp's probabilities and mask words are read
    }
    const int nk = min(kTile, (L - n0 + 15) & ~15);
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      if (kMode != kNoMask && next) fetch_mask(n0 + kTile, h);
      if (t >= 0)
        probs_by_rows4(acc, sm, kFPOff,
                       kFKVOff + st * kFStage + 4 * kTile * kHD,
                       16 * warp + 4 * g, g, t8, 32 * h, min(32 * h + 32, nk));
      if (kMode != kNoMask && next) put_mask(n0 + kTile, h);
    }
  }
  if (!active) return;

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int x = 1; x < 8; x <<= 1) lt += __shfl_xor_sync(0xffffffffu, lt, x);
    const int row = r0 + 4 * g + i;
    if (row >= L) continue;
    const float inv = inv_keep / lt;
    *reinterpret_cast<float4*>(o + base + (size_t)row * kHD + 4 * t8) =
        make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv,
                    acc[i][3] * inv);
    if (lse != nullptr && t8 == 0) lse[(size_t)bh * L + row] = m[i] + log2f(lt);
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

// ---- the backward's key-block pass ----
//
// A block of 256 threads takes 128 key rows; warp w owns rows 16 w .. 16 w
// + 15 of the scores' and their gradients' tiles, lane (g, t8) = (lane / 8,
// lane % 8) rows 16 w + 4 g + i (i < 4).  k, v, q and do are swizzled
// [rows][kHD] tiles, p^T and then ds^T one [128][64] score tile.
constexpr int kKeys = 2 * kTile;       // key rows a block
constexpr int kBwdThreads = 256;       // 8 warps of 16 key rows
constexpr int kHalf = kBwdThreads / 2; // the threads of a 64-key half (dq)
constexpr int kMS = 5;   // a tile row's 4 mask words: stride 5, so the 8
                         // rows 4 t8 + j a warp reads fall in 8 banks

// the byte offsets of the dk/dv pass's shared tiles (dk's sums first)
constexpr uint32_t kKsOff = 16 * 4 * kBwdThreads;
constexpr uint32_t kVsOff = kKsOff + 4 * kKeys * kHD;
constexpr uint32_t kQsOff = kVsOff + 4 * kKeys * kHD;
constexpr uint32_t kOsOff = kQsOff + 4 * kTile * kHD;
constexpr uint32_t kPsOff = kOsOff + 4 * kTile * kHD;
constexpr uint32_t kXsOff = kPsOff + 4 * kKeys * kTile;
constexpr uint32_t kLsOff = kXsOff + 4 * kTile * kHD;
constexpr int kDkvSmemBytes = kLsOff + 4 * (2 * kTile + kTile * kMS);
static_assert(4096 + 4 * (4 * kTile * kHD * 2 + 4 * 16 * kTile + 16 * 4 * 32 +
                          3 * 4 * kTile) <= kDkvSmemBytes,
              "the tail's four warp regions fit");

// The thread's and block's indices read again: the offsets of the loads,
// of the dq part and of the stores are recomputed from them where they are
// used, once a tile, instead of being held in registers (or spilled) over
// the products.
__device__ __forceinline__ int fresh_tid() {
  int x;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(x));
  return x;
}

__device__ __forceinline__ int fresh_ctaid_x() {
  int x;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(x));
  return x;
}

// Block b of the dk/dv pass's grid of nkb * bh: key block kb of head bh,
// every head's last key block after all the others, so that the short
// blocks (tail_slab) fill the end of the grid.
struct KeyBlock {
  int kb, bh;
};

__device__ __forceinline__ KeyBlock key_block(int b, int L) {
  const int nkb = (L + kKeys - 1) / kKeys;
  const int full = (nkb - 1) * (int)(gridDim.x / nkb);
  if (b < full) return {b % (nkb - 1), b / (nkb - 1)};
  return {nkb - 1, b - full};
}

// the key block's part of dq: dq_parts[kb][bh], [64 ceil(L / 64)][kHD]
__device__ __forceinline__ float* dq_part(float* dq_parts, KeyBlock kbh,
                                          int L) {
  const int nkb = (L + kKeys - 1) / kKeys, ntiles = (L + kTile - 1) / kTile;
  return dq_parts + ((size_t)kbh.kb * (gridDim.x / nkb) + kbh.bh) *
                        (size_t)ntiles * kTile * kHD;
}

// One warp's 16 key rows against one query tile.  Lane (g, t8) = (lane / 8,
// lane % 8) holds key rows 4 g + i (i < 4) of the warp's rows of k and v
// (from row rk) and of the score tile (from row rp), and query columns 32 G
// + 4 t8 + j a group G of 32 at a time: (do v^T)^T and s^T, then p, the
// dropped p^T into the score tile and its product with do into dva, then ds
// = p (dp' - dsum) into the score tile and its product with q into the
// thread's dk sums ka[i * ka_stride].  Tile offsets are bytes of sm;
// Lt, Dt: the tile's LSE and row sums; mask bit i of query row q's word
// Mt[q * m_stride] >> m_shift keeps key row 4 g + i; rows from nk on get p
// = 0 where `partial`.  ds stays in the score tile for the dq part.
__device__ __forceinline__ void warp_tile(
    float (&dva)[4][4], float4* ka, int ka_stride, const char* sm,
    uint32_t k_off, uint32_t v_off, uint32_t q_off, uint32_t o_off,
    uint32_t p_off, const float* Lt, const float* Dt, const uint32_t* Mt,
    int m_stride, int m_shift, int rk, int rp, int nk, bool partial,
    int nq16, float scale_log2, float inv_keep) {
  const int lane = threadIdx.x % 32, g = lane / 8, t8 = lane % 8;
  const int rki = rk + 4 * g, rpi = rp + 4 * g, sa = (rki >> 2) & 7;
  float* P = reinterpret_cast<float*>(const_cast<char*>(sm) + p_off);
#pragma unroll 1
  for (int G = 0; G < 2; ++G) {
    if (G == 1 && nq16 <= 32) break;
    float dp[4][4], s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = s[i][j] = 0.f;
    rows_by_rows<1>(dp, sm, v_off, o_off, rki, sa, t8, G);
    rows_by_rows<1>(s, sm, k_off, q_off, rki, sa, t8, G);
    const float4 l4 = ld4(Lt + 32 * G + 4 * t8);
    const float4 d4 = ld4(Dt + 32 * G + 4 * t8);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][j] = ex2(s[i][j] * scale_log2 - at(l4, j));
    if (partial)   // p = 0 on the rows past the keys
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (rki + i - rk >= nk) s[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t kb = Mt[(32 * G + 4 * t8 + j) * m_stride] >> m_shift;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float kf = (kb >> i) & 1u ? inv_keep : 0.f;
        const float p = s[i][j];
        s[i][j] = p * kf;
        dp[i][j] = p * (__fmul_rn(dp[i][j], kf) - at(d4, j));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(P + at64(rpi + i, 8 * G + t8, g)) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    __syncwarp();
    probs_by_rows4(dva, sm, p_off, o_off, rpi, g, t8, 32 * G,
                   min(32 * G + 32, nq16));
    __syncwarp();    // the warp's reads of this group's p^T are done
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(P + at64(rpi + i, 8 * G + t8, g)) =
          make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
  }
  __syncwarp();
  float dka[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 x = ka[i * ka_stride];
    dka[i][0] = x.x; dka[i][1] = x.y; dka[i][2] = x.z; dka[i][3] = x.w;
  }
  probs_by_rows4(dka, sm, p_off, q_off, rpi, g, t8, 0, nq16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    ka[i * ka_stride] = make_float4(dka[i][0], dka[i][1], dka[i][2], dka[i][3]);
}

// A block whose keys fit one slab of 16 (L % 128 of them, the last block of
// a head): in the main loop one warp would work and seven wait at every
// barrier, holding a block's place for most of a block's time.  Here four
// warps take every fourth query tile each, with their own tile buffers,
// sums of dv and dk and score rows, and no block barrier until their sums
// are added, in the order of the warps.  Byte layout: k's and v's 16 rows
// at 0 and 2048, then a region of kTailBytes a warp.
constexpr int kTailWarps = 4;
constexpr uint32_t kTailQ = 0, kTailO = kTailQ + 4 * kTile * kHD,
                   kTailP = kTailO + 4 * kTile * kHD,
                   kTailKa = kTailP + 4 * 16 * kTile,
                   kTailL = kTailKa + 16 * 4 * 32, kTailD = kTailL + 4 * kTile,
                   kTailM = kTailD + 4 * kTile,
                   kTailBytes = kTailM + 4 * kTile;

template <bool kDrop>
__device__ __noinline__ void tail_slab(
    char* sm, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    const uint32_t* __restrict__ bits, float* __restrict__ dk,
    float* __restrict__ dv, float* __restrict__ dq_parts, int L, int W,
    int nk, float scale_log2, float scale, float inv_keep) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const KeyBlock kbh = key_block(blockIdx.x, L);
  const int n0 = kKeys * kbh.kb, ntiles = (L + kTile - 1) / kTile;
  const size_t rbase = (size_t)kbh.bh * L;
  if (tid < 16 * kVecs) {   // the slab's k and v rows, zeros past nk
    const int r = tid / kVecs, c = tid % kVecs;
    const bool ok = r < nk;
    const size_t at_src = ok ? (rbase + n0 + r) * kHD + 4 * c : 0;
    cp_async<16>(sm + 4 * at32(r, c, (r >> 2) & 7), k + at_src, ok);
    cp_async<16>(sm + 2048 + 4 * at32(r, c, (r >> 2) & 7), v + at_src, ok);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  float dva[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dva[i][c] = 0.f;
  const uint32_t region = 4096 + warp * kTailBytes;
  float4* ka = reinterpret_cast<float4*>(sm + region + kTailKa) + lane;
  if (warp < kTailWarps) {
#pragma unroll
    for (int i = 0; i < 4; ++i) ka[32 * i] = zero4();
    float* Qt = reinterpret_cast<float*>(sm + region + kTailQ);
    float* Ot = reinterpret_cast<float*>(sm + region + kTailO);
    float* Lt = reinterpret_cast<float*>(sm + region + kTailL);
    float* Dt = reinterpret_cast<float*>(sm + region + kTailD);
    uint32_t* Mt = reinterpret_cast<uint32_t*>(sm + region + kTailM);
    float* parts = dq_part(dq_parts, kbh, L);
    // tile m0's q, do (zeros past L), LSE (inf past L), row sums and mask
    // words of the slab
    auto load_tile = [&](int m0) {
#pragma unroll
      for (int u = 0; u < kTile * kVecs / 32; ++u) {
        const int f = lane + 32 * u, r = f / kVecs, c = f % kVecs;
        const bool ok = m0 + r < L;
        const size_t at_src = ok ? (rbase + m0 + r) * kHD + 4 * c : 0;
        cp_async<16>(Qt + at32(r, c, (r >> 2) & 7), q + at_src, ok);
        cp_async<16>(Ot + at32(r, c, (r >> 2) & 7), dout + at_src, ok);
      }
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) {
        const int r = lane + 32 * u;
        const bool ok = m0 + r < L;
        if (ok)
          cp_async<4>(Lt + r, lse + rbase + m0 + r, true);
        else
          Lt[r] = INFINITY;                       // p = 0 past the rows
        cp_async<4>(Dt + r, dsum + rbase + (ok ? m0 + r : 0), ok);
        if (kDrop)
          cp_async<4>(Mt + r, bits + (ok ? (rbase + m0 + r) * W + n0 / 32 : 0),
                      ok);
        else
          Mt[r] = ~0u;
      }
      cp_async_commit();
    };
    if (warp < ntiles) load_tile(kTile * warp);
    for (int t = warp; t < ntiles; t += kTailWarps) {
      const int m0 = t * kTile;
      cp_async_wait_all();
      __syncwarp();
      const int nq16 = (min(kTile, L - m0) + 15) & ~15;
      warp_tile(dva, ka, 32, sm, 0, 2048, region + kTailQ, region + kTailO,
                region + kTailP, Lt, Dt, Mt, 1, 4 * (lane / 8), 0, 0, nk,
                true, nq16, scale_log2, inv_keep);
      __syncwarp();   // q, do and the rest are read: the next tile's loads
      if (t + kTailWarps < ntiles) load_tile(m0 + kTile * kTailWarps);
      // the tile's dq part over the slab, 16 query rows at a time: rows
      // 16 h + 4 (lane / 8) + j, head columns 4 (lane % 8) + c
      const int qa = lane % 8, qb = lane / 8;
      for (int h = 0; h < nq16 / 16; ++h) {
        float dqa[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) dqa[j][c] = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float4 kk =
              lds(sm, (uint32_t)(4 * at32(e, qa, (e >> 2) & 7)));
          const float4 sd =
              lds(sm, region + kTailP + 4 * at64(e, 4 * h + qb, e >> 2));
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              dqa[j][c] = fmaf(at(sd, j), at(kk, c), dqa[j][c]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(
              parts + (size_t)(m0 + 16 * h + 4 * qb + j) * kHD + 4 * qa) =
              make_float4(dqa[j][0], dqa[j][1], dqa[j][2], dqa[j][3]);
      }
      __syncwarp();   // the tile's ds^T is read
    }
    // this warp's dv sums beside its dk sums, for warp 0 to add
    float4* dvp = reinterpret_cast<float4*>(sm + region + kTailQ) + lane;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dvp[32 * i] = make_float4(dva[i][0], dva[i][1], dva[i][2], dva[i][3]);
  }
  cp_async_wait_all();
  __syncthreads();
  if (warp != 0) return;
  const int g = lane / 8, t8 = lane % 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (4 * g + i >= nk) continue;
    float4 a = zero4(), b = zero4();
#pragma unroll
    for (int w = 0; w < kTailWarps; ++w) {
      const uint32_t rw = 4096 + w * kTailBytes + 16 * (32 * i + lane);
      const float4 x = lds(sm, rw + kTailQ), y = lds(sm, rw + kTailKa);
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      b.x += y.x; b.y += y.y; b.z += y.z; b.w += y.w;
    }
    const size_t row = (rbase + n0 + 4 * g + i) * kHD + 4 * t8;
    *reinterpret_cast<float4*>(dv + row) = a;
    *reinterpret_cast<float4*>(dk + row) =
        make_float4(b.x * scale, b.y * scale, b.z * scale, b.w * scale);
  }
}

// Grid (nkb = ceil(L / 128), bh), 256 threads: dk and dv of the 128 key rows
// of block kb = blockIdx.x, and this block's part of dq (ds k over its keys)
// into dq_parts[kb][bh] [Lp][kHD] (Lp = 64 ceil(L / 64): whole tiles), which
// attn_f32_bwd_dq_kernel sums over the blocks.  Warp w owns key rows 16 w ..
// 16 w + 15 (warp_tile).  Per query tile of 64: its q, do, LSE, row sums and
// mask words arrive by cp.async while the tile before finishes its dq part;
// two barriers, one when the tile has landed and one when every warp's ds^T
// is in place.  Each half of the threads takes the dq part of 64 keys; the
// second half's goes through shared memory to the first, which adds it
// after the next tile's first barrier and writes the sum.  dk's sums wait in
// shared memory between tiles, each thread's own, to leave registers to the
// products.  A block of at most 16 keys takes tail_slab.
template <bool kDrop>
__global__ void __launch_bounds__(kBwdThreads, 2) attn_f32_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum,
    const uint32_t* __restrict__ bits, float* __restrict__ dk,
    float* __restrict__ dv, float* __restrict__ dq_parts, int L, int W,
    float scale_log2, float scale, float inv_keep) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  // the block's keys
  const int nk = min(kKeys, L - kKeys * key_block(blockIdx.x, L).kb);
  if (nk <= 16) {
    tail_slab<kDrop>(sm, q, k, v, dout, lse, dsum, bits, dk, dv, dq_parts, L,
                     W, nk, scale_log2, scale, inv_keep);
    return;
  }
  // dk's sums [4][256]; k, v [128][kHD]; q, do [64][kHD]; (the score tile
  // at kPsOff); the second half's dq part [64][kHD]; LSE, row sums [64];
  // mask words [64][kMS]
  float4* Ka = smem4;
  float* Ks = reinterpret_cast<float*>(sm + kKsOff);
  float* Vs = reinterpret_cast<float*>(sm + kVsOff);
  float* Qs = reinterpret_cast<float*>(sm + kQsOff);
  float* Os = reinterpret_cast<float*>(sm + kOsOff);
  float* Xs = reinterpret_cast<float*>(sm + kXsOff);
  float* Ls = reinterpret_cast<float*>(sm + kLsOff);
  float* Ds = Ls + kTile;
  uint32_t* Ms = reinterpret_cast<uint32_t*>(Ds + kTile);
  const int ntiles = (L + kTile - 1) / kTile;

  // tile m0's q, do (zeros past L), LSE (inf past L), row sums and mask
  // words n0 / 32 .. + 3 (zeros past L and W)
  auto load_tile = [&](int m0) {
    const int tid = fresh_tid();
    const KeyBlock kbh = key_block(fresh_ctaid_x(), L);
    const int n0 = kKeys * kbh.kb;
    const size_t rbase = (size_t)kbh.bh * L;
    fill_rows<kTile, kBwdThreads>(Qs, q + (rbase + m0) * kHD, L - m0, tid);
    fill_rows<kTile, kBwdThreads>(Os, dout + (rbase + m0) * kHD, L - m0, tid);
    if (tid < kTile) {
      if (m0 + tid < L)
        cp_async<4>(Ls + tid, lse + rbase + m0 + tid, true);
      else
        Ls[tid] = INFINITY;                       // p = 0 past the rows
    } else if (tid < 2 * kTile) {
      const int r = m0 + tid - kTile;
      cp_async<4>(Ds + tid - kTile, dsum + rbase + min(r, L - 1), r < L);
    }
    if (kDrop) {
      const int r = tid / 4, col = n0 / 32 + tid % 4;
      const bool ok = m0 + r < L && col < W;
      cp_async<4>(Ms + r * kMS + tid % 4,
                  bits + (ok ? (rbase + m0 + r) * W + col : 0), ok);
    }
  };

  {
    const int tid = threadIdx.x;
    const KeyBlock kbh = key_block(blockIdx.x, L);
    const size_t base = ((size_t)kbh.bh * L + kKeys * kbh.kb) * kHD;
    fill_rows<kKeys, kBwdThreads>(Ks, k + base, nk, tid);
    fill_rows<kKeys, kBwdThreads>(Vs, v + base, nk, tid);
    load_tile(0);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < 4; ++i) Ka[i * kBwdThreads + tid] = zero4();
    if (!kDrop)   // no mask: every score kept
      for (int f = tid; f < kTile * kMS; f += kBwdThreads) Ms[f] = ~0u;
  }

  // the dq part: half h = tid / 128 sums keys 64 h .. 64 h + 63 of the
  // block; thread (qa, qb) = (lane % 8, 4 (warp % 4) + lane / 8) holds query
  // rows 4 qb + j, head columns 4 qa + c
  float dva[4][4], dqa[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dva[i][c] = dqa[i][c] = 0.f;

  // the first half's dq part of the tile at m0 plus the second half's (in
  // Xs), into the parts
  auto put_dq = [&](int m0) {
    const int tid = fresh_tid(), qa = tid % 8;
    const int qb = (tid / 32) % 4 * 4 + tid % 32 / 8;
    float* parts = dq_part(dq_parts, key_block(fresh_ctaid_x(), L), L);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 x = ld4(Xs + (4 * qb + j) * kHD + 4 * qa);
      *reinterpret_cast<float4*>(parts + (size_t)(m0 + 4 * qb + j) * kHD +
                                 4 * qa) =
          make_float4(dqa[j][0] + x.x, dqa[j][1] + x.y, dqa[j][2] + x.z,
                      dqa[j][3] + x.w);
    }
  };

  for (int t = 0; t < ntiles; ++t) {
    const int m0 = t * kTile;
    cp_async_wait_all();
    __syncthreads();   // tile t landed; every reader of tile t - 1 is done
    if (t > 0 && threadIdx.x < kHalf) put_dq(m0 - kTile);
    const int nq = min(kTile, L - m0), nq16 = (nq + 15) & ~15;
    const int warp = threadIdx.x / 32;
    if (16 * warp < nk)   // the warp has a key
      warp_tile(dva, Ka + threadIdx.x, kBwdThreads, sm, kKsOff, kVsOff,
                kQsOff, kOsOff, kPsOff, Ls, Ds, Ms + warp / 2, kMS,
                16 * (warp % 2) + 4 * (threadIdx.x % 32 / 8), 16 * warp,
                16 * warp, nk - 16 * warp, 16 * warp + 16 > nk, nq16,
                scale_log2, inv_keep);
    __syncthreads();   // every warp's ds^T is in Ps; q, do, ... are read
    if (t + 1 < ntiles) load_tile(m0 + kTile);
    cp_async_commit();

    // this half's dq part: rows 4 qb + j, columns 4 qa + c, over its keys
    // (none for the query rows past L)
    {
      const int tid = fresh_tid(), half = tid / kHalf;
      const int qa = tid % 8, qb = (tid / 32) % 4 * 4 + tid % 32 / 8;
      const int n_begin = kTile * half;
      const int n_end = 16 * (tid / 32 % 4) < nq
                            ? min(n_begin + kTile, (nk + 15) & ~15)
                            : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) dqa[j][c] = 0.f;
      for (int n16 = n_begin; n16 < n_end; n16 += 16) {
        // key rows n16 + e: swizzle ((n16 / 4) & 4) ^ (e / 4) in k,
        // e / 4 in ds^T
        const uint32_t k0 = kKsOff + n16 * 128 + ((qa ^ ((n16 >> 2) & 4)) << 4);
        const uint32_t s0 = kPsOff + n16 * 256 + (qb << 4);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float4 kk = lds(sm, (k0 ^ ((e >> 2) << 4)) + e * 128);
          const float4 sd = lds(sm, (s0 ^ ((e >> 2) << 4)) + e * 256);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              dqa[j][c] = fmaf(at(sd, j), at(kk, c), dqa[j][c]);
        }
      }
      if (half == 1)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(Xs + (4 * qb + j) * kHD + 4 * qa) =
              make_float4(dqa[j][0], dqa[j][1], dqa[j][2], dqa[j][3]);
    }
  }
  __syncthreads();
  if (threadIdx.x < kHalf) put_dq((ntiles - 1) * kTile);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ra = 16 * warp + 4 * (lane / 8);
  const KeyBlock kbh = key_block(blockIdx.x, L);
  const size_t base = ((size_t)kbh.bh * L + kKeys * kbh.kb) * kHD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (ra + i >= nk) continue;
    const size_t row = base + (size_t)(ra + i) * kHD + 4 * (lane % 8);
    const float4 x = Ka[i * kBwdThreads + tid];
    *reinterpret_cast<float4*>(dv + row) =
        make_float4(dva[i][0], dva[i][1], dva[i][2], dva[i][3]);
    *reinterpret_cast<float4*>(dk + row) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }
}

// Grid (ceil(L / 64), bh), 256 threads: dq [bh, L, kHD] of 64 query rows,
// the sum of dq_parts over the nkb key blocks in their order, times the
// scale: two 16-byte groups a thread.
__global__ void __launch_bounds__(256) attn_f32_bwd_dq_kernel(
    const float* __restrict__ dq_parts, float* __restrict__ dq, int L,
    int nkb, float scale) {
  static_assert(kTile * kVecs == 2 * 256, "two groups a thread");
  const int t = threadIdx.x, bh = blockIdx.y, m0 = blockIdx.x * kTile;
  const size_t Lp = (size_t)gridDim.x * kTile;
  float4 a[2] = {zero4(), zero4()};
  for (int kb = 0; kb < nkb; ++kb) {
    const float* part =
        dq_parts + (((size_t)kb * gridDim.y + bh) * Lp + m0) * kHD;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float4 x = ld4(part + 4 * (t + 256 * u));
      a[u].x += x.x; a[u].y += x.y; a[u].z += x.z; a[u].w += x.w;
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int f = t + 256 * u, r = f / kVecs;
    if (m0 + r >= L) continue;
    *reinterpret_cast<float4*>(dq + ((size_t)bh * L + m0 + r) * kHD +
                               4 * (f % kVecs)) =
        make_float4(a[u].x * scale, a[u].y * scale, a[u].z * scale,
                    a[u].w * scale);
  }
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

template <int kMode>
int launch_fwd(const float* q, const float* k, const float* v,
               const FwdMaskArgs& mask, float* o, float* lse, int bh, int L,
               int W, float scale, float inv_keep, cudaStream_t s) {
  constexpr int smem = kFwdSmemBytes;
  cudaError_t err = set_smem(attn_f32_fwd_kernel<kMode>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kTile - 1) / kTile, bh);
  attn_f32_fwd_kernel<kMode><<<grid, kFwdThreads, smem, s>>>(
      q, k, v, mask, o, lse, L, W, scale * 1.4426950408889634f, inv_keep);
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
  const int nkb = (L + kKeys - 1) / kKeys;
  constexpr int smem = kDkvSmemBytes;
  err = set_smem(attn_f32_bwd_dkv_kernel<kDrop>, smem);
  if (err != cudaSuccess) return (int)err;
  attn_f32_bwd_dkv_kernel<kDrop><<<nkb * bh, kBwdThreads, smem, s>>>(
      q, k, v, dout, lse, dsum, bits, dk, dv, dq_parts, L, W,
      scale * 1.4426950408889634f, scale, inv_keep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_f32_bwd_dq_kernel<<<dim3((L + kTile - 1) / kTile, bh), 256, 0, s>>>(
      dq_parts, dq, L, nkb, scale);
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

// q, k, v, o: float32 [bh, L, 32] contiguous, 16-byte aligned; lse: float32
// [bh, L] (base 2) or null; scale > 0.  The dropout mask, inv_keep = 1 / (1
// - rate):
//   draws non-null: float32 uniform draws of [bh / heads, heads, L, L] with
//     rows of stride L, those of (b, h) at draws + b * draw_sb + h * draw_sh;
//     a score is kept where its draw >= rate; the bits [bh, L, W] (W = 2
//     ceil(L / 64)) of the mask are written to `bits`;
//   draws null, bits non-null: the mask's bits [bh, L, W], read;
//   both null: no dropout (inv_keep 1).
extern "C" int attention_f32_fwd(const void* q, const void* k, const void* v,
                                 const void* draws, void* bits, void* o,
                                 void* lse, int bh, int heads, int L,
                                 long long draw_sb, long long draw_sh,
                                 float scale, float inv_keep, float rate,
                                 void* stream) {
  if (bh < 1 || bh > 65535 || L < 1 || !(scale > 0.f) ||
      (draws != nullptr && (bits == nullptr || heads < 1 || bh % heads)))
    return (int)cudaErrorInvalidValue;
  const int W = 2 * ((L + 63) / 64);
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  const FwdMaskArgs mask{static_cast<const float*>(draws), draw_sb, draw_sh,
                         heads, rate, static_cast<uint32_t*>(bits)};
  float *fo = static_cast<float*>(o), *fl = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (draws != nullptr)
    return launch_fwd<kMaskDraws>(fq, fk, fv, mask, fo, fl, bh, L, W, scale,
                                  inv_keep, s);
  if (bits != nullptr)
    return launch_fwd<kMaskBits>(fq, fk, fv, mask, fo, fl, bh, L, W, scale,
                                 inv_keep, s);
  return launch_fwd<kNoMask>(fq, fk, fv, mask, fo, fl, bh, L, W, scale,
                             inv_keep, s);
}

// dq, dk, dv [bh, L, 32] from q, k, v, the forward's o and lse, the output
// gradient dout and the forward's bits (or null); dsum: float32 [bh, L] and
// dq_parts: float32 [ceil(L / 128), bh, 64 ceil(L / 64), 32], scratch.
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
