// Fused attention forward for Hopper (sm_90a): O = softmax(Q K^T * scale) V.
//
// Replaces: rag_snvbert_tpu/models/transformer.py::_splash_attention (the
// splash-attention Pallas kernel, forward), which every encoder layer of
// the `tpu_default` preset runs.  Inputs are bf16 [B, H, L, hd], contiguous;
// the output is bf16 in the same layout.  Scores, the running max, the
// running sum and the accumulator are fp32.
//
// LSE: when the caller passes an ``lse`` pointer (fp32 [B*H, L], training),
// the kernel also writes each valid row's log-sum-exp IN BASE 2 of the
// scaled scores: lse[r] = log2(sum_j 2^(s_rj * scale * log2(e))), i.e. the
// natural log-sum-exp of s*scale times log2(e).  The backward kernel
// (attention_bwd.cu) recomputes P = exp2(s*scale*log2(e) - lse) from it.
// With a null pointer (serving) nothing more is written.
//
// Differences from the TPU kernel, on purpose:
//   * L runs ragged (1030 on the serving path): the last key tile and the
//     last query tile are masked here, instead of padding to the TPU block
//     multiple (1152) and encoding the padding in a static block mask.
//   * splash scales q in bf16 before the product (transformer.py:136); this
//     kernel scales the fp32 scores instead.  The two differ within the
//     bf16 rounding of q.
//
// What bounds it on the H100: at the serving shape ([64, 3, 1030, 128])
// one call is 1.04e11 FLOP against 0.20 GB of q/k/v/o, so the bound is the
// tensor cores (about 0.105 ms at 989 TFLOP/s).  The [L, L] scores never
// reach device memory (online softmax), which is what the splash kernel
// bought on the TPU too.  This first version is the simple correct design:
// one block of four warps per (stream*head, 64-row query tile); a loop
// over 64-row key tiles staged in shared memory; mma.sync m16n8k16 bf16
// products with fp32 accumulation; P kept in registers as the A operand
// of the P.V product.  Loads are synchronous (no cp.async/TMA pipeline,
// no wgmma): making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block, 16 per warp
constexpr int kBlockK = 64;   // key rows per tile
constexpr int kThreads = 128;
constexpr int kPad = 8;       // bf16 of row padding in shared memory

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
  for (int i = threadIdx.x; i < kBlockK * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < L) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + c);
    }
    *reinterpret_cast<uint4*>(dst + r * (HD + kPad) + c) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int L, float scale_log2) {
  constexpr int LD = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBlockQ * LD;
  __nv_bfloat16* Vs = Ks + kBlockK * LD;

  const size_t head = (size_t)blockIdx.y * L * HD;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row group
  const int t = lane & 3;    // thread in group

  load_tile<HD>(Qs, q + head, q0, L);
  __syncthreads();

  // This warp's 16 query rows as mma A fragments, kept for every key tile.
  uint32_t qa[HD / 16][4];
  const int r = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    qa[kk][0] = ld_pair(Qs + r * LD + c);
    qa[kk][1] = ld_pair(Qs + (r + 8) * LD + c);
    qa[kk][2] = ld_pair(Qs + r * LD + c + 8);
    qa[kk][3] = ld_pair(Qs + (r + 8) * LD + c + 8);
  }

  // Rows g and g + 8 of the warp's tile: running max (log2 domain), sum.
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }

  const int n_tiles = (L + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<HD>(Ks, k + head, k0, L);
    load_tile<HD>(Vs, v + head, k0, L);
    __syncthreads();

    // S = Q K^T for 16 x 64 (eight 8-column n tiles).
    float s[kBlockK / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (n * 8 + g) * LD + t * 2;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        mma_bf16(s[n], qa[kk], ld_pair(kr + kk * 16), ld_pair(kr + kk * 16 + 8));
      }
    }

    // Scale in fp32, mask keys at or past L, new row max.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = k0 + n * 8 + t * 2 + j < L;
        s[n][j] = ok ? s[n][j] * scale_log2 : -CUDART_INF_F;
        s[n][2 + j] = ok ? s[n][2 + j] * scale_log2 : -CUDART_INF_F;
        mx0 = fmaxf(mx0, s[n][j]);
        mx1 = fmaxf(mx1, s[n][2 + j]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 2));
    // Every tile holds at least one valid key, so mx0/mx1 are finite.
    const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      acc[i][0] *= c0;
      acc[i][1] *= c0;
      acc[i][2] *= c1;
      acc[i][3] *= c1;
    }

    // P = exp2(S - max); the C fragments of two n tiles form one A
    // fragment of the P.V product (16 keys).
    uint32_t pa[kBlockK / 16][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      const float p0 = exp2f(s[n][0] - m0), p1 = exp2f(s[n][1] - m0);
      const float p2 = exp2f(s[n][2] - m1), p3 = exp2f(s[n][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[n / 2][(n % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V.  B[key][col] = V[key][col]: pairs along the key axis.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const __nv_bfloat16* vb = Vs + (kk * 16 + t * 2) * LD + i * 8 + g;
        mma_bf16(acc[i], pa[kk], ld_pair2(vb, vb + LD),
                 ld_pair2(vb + 8 * LD, vb + 9 * LD));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffff, l0, 1);
  l0 += __shfl_xor_sync(0xffffffff, l0, 2);
  l1 += __shfl_xor_sync(0xffffffff, l1, 1);
  l1 += __shfl_xor_sync(0xffffffff, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + r, row1 = row0 + 8;
  if (lse != nullptr && t == 0) {
    // m is the row max in the log2 domain, l the sum of exp2(s - m).
    if (row0 < L) lse[(size_t)blockIdx.y * L + row0] = m0 + log2f(l0);
    if (row1 < L) lse[(size_t)blockIdx.y * L + row1] = m1 + log2f(l1);
  }
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int c = i * 8 + t * 2;
    if (row0 < L) {
      *reinterpret_cast<uint32_t*>(o + head + (size_t)row0 * HD + c) =
          pack_bf16(acc[i][0] * inv0, acc[i][1] * inv0);
    }
    if (row1 < L) {
      *reinterpret_cast<uint32_t*>(o + head + (size_t)row1 * HD + c) =
          pack_bf16(acc[i][2] * inv1, acc[i][3] * inv1);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int L, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(kBlockQ + 2 * kBlockK) * (HD + kPad) *
                      sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + kBlockQ - 1) / kBlockQ, bh);
  attention_fwd_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, L, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: bf16 [bh, L, hd] contiguous, 16-byte aligned; lse: fp32
// [bh, L] (base 2, see above) or null.  Returns the CUDA error code of the
// launch (0 on success).
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
