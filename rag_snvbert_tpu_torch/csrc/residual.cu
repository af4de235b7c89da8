// The pre-LN block's residual epilogue for bf16 activations on Hopper
// (sm_90a): y = x + drop_n(... drop_1(act(f))), forward and backward.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the block's LeakyReLU, its
// residual dropouts and the add into their neighbours.  Added because the
// port ran them as PyTorch's chain of elementwise passes: per pre-LN block
// (models/transformer.py) the attention sublayer's x + drop(a) as a scaled
// copy, a where against the broadcast mask and the add (7 passes over an
// activation forward, 4 backward), and the FFN tail's
// x + drop(drop(leaky_relu(f))) as the LeakyReLU, two (scale, where) pairs
// and the add (13 forward, 11 backward): 35 passes a layer, a third of a
// tpu_default training micro-step's device time with the rest of the
// elementwise chains.
//
// Semantics: those of the chain on the card, rounded to bf16 after each
// op, in its order.  With act = identity or LeakyReLU(0.1), masks m_1..m_n
// (n <= 2; bool [B, 1, D], broadcast along the sequence) and their scales
// s_k = float32(1) / float32(1 - rate_k) (PyTorch's CUDA division of a
// tensor by a Python scalar is a product with the float32 reciprocal; its
// DivBackward too):
//   t_0 = act(f)                 LeakyReLU: f > 0 ? f : bf16(f * 0.1f)
//   t_k = m_k ? bf16(t_{k-1} * s_k) : 0
//   y   = bf16(x + t_n)
// and backward, from the gradient g of y (the gradient of x is g itself,
// which the wrapper hands back without a kernel):
//   u_n = g,  u_{k-1} = m_k ? bf16(u_k * s_k) : 0
//   grad_f = act'(u_0)           LeakyReLU: f > 0 ? u_0 : bf16(u_0 * 0.1f)
//
// What bounds it on the H100: bytes.  The forward reads x and f and writes
// y (6 B an element), the backward reads g (and f under LeakyReLU) and
// writes grad_f (4 or 6 B); the masks are B x D bytes each.  At
// [48, 1030, 384] the forward and the FFN's backward move 114 MB (34.0 us
// at 3.35 TB/s), the attention's backward 76 MB (22.7 us).
//
// Design: a stream of 16-byte vectors of 8 bf16.  A block of 256 threads
// owns one batch row b (blockIdx.y) and tiles of 1024 vectors of it; each
// thread loads its 4 vectors of every operand before it computes (8 loads
// of 16 bytes in flight in the forward), neighbouring threads on
// neighbouring vectors.  The masks' row b is copied into shared memory
// once a block (8 bytes, one a column of a vector); a vector's column is
// its index modulo D / 8.  Instances for each act and mask count (0-2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                    // vectors a thread per tile
constexpr int kTile = kThreads * kUnroll;     // vectors a block per tile
constexpr int kMaxVecs = 512;                 // D <= 4096
constexpr int kMaxTiles = 4096;               // blocks along a batch row

template <bool kAct_, int kMasks_>
struct Variant {
  static constexpr bool kAct = kAct_;
  static constexpr int kMasks = kMasks_;
};

template <typename Fn>
int with_variant(int masks, int leaky, Fn&& fn) {
  if (masks == 0) return leaky ? fn(Variant<true, 0>{}) : fn(Variant<false, 0>{});
  if (masks == 1) return leaky ? fn(Variant<true, 1>{}) : fn(Variant<false, 1>{});
  if (masks == 2) return leaky ? fn(Variant<true, 2>{}) : fn(Variant<false, 2>{});
  return (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ void unpack(uint4 raw, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  return raw;
}

// The float32 value of v rounded to bf16 (to nearest, ties to even).
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Byte j (0 or 1) of a vector's 8 mask bytes.
__device__ __forceinline__ bool kept(uint2 m, int j) {
  return ((j < 4 ? m.x >> (8 * j) : m.y >> (8 * (j - 4))) & 0xffu) != 0u;
}

// Copies row b of each mask ([B, D / 8] vectors of 8 bytes) into shared
// memory; every thread of the block calls it.
template <int kMasks>
__device__ __forceinline__ void stage_masks(const uint2* __restrict__ m1,
                                            const uint2* __restrict__ m2,
                                            uint2 (*keep)[kMaxVecs],
                                            int64_t b, int nvec) {
  if constexpr (kMasks > 0) {
    for (int c = threadIdx.x; c < nvec; c += kThreads) {
      keep[0][c] = m1[b * nvec + c];
      if constexpr (kMasks > 1) keep[1][c] = m2[b * nvec + c];
    }
    __syncthreads();
  }
}

template <bool kAct, int kMasks>
__global__ void __launch_bounds__(kThreads)
residual_fwd(const uint4* __restrict__ x, const uint4* __restrict__ f,
             const uint2* __restrict__ m1, const uint2* __restrict__ m2,
             float s1, float s2, uint4* __restrict__ y, int64_t per_row,
             int nvec) {
  __shared__ uint2 keep[kMasks > 0 ? kMasks : 1][kMaxVecs];
  const int64_t b = blockIdx.y;
  stage_masks<kMasks>(m1, m2, keep, b, nvec);
  const uint4* xb = x + b * per_row;
  const uint4* fb = f + b * per_row;
  uint4* yb = y + b * per_row;
  for (int64_t base = (int64_t)blockIdx.x * kTile; base < per_row;
       base += (int64_t)gridDim.x * kTile) {
    uint4 xr[kUnroll], fr[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = base + k * kThreads + threadIdx.x;
      if (i < per_row) {
        xr[k] = xb[i];
        fr[k] = fb[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = base + k * kThreads + threadIdx.x;
      if (i < per_row) {
        const int c = (int)(i % nvec);
        float xv[8], t[8];
        unpack(xr[k], xv);
        unpack(fr[k], t);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if constexpr (kAct) t[j] = t[j] > 0.f ? t[j] : bf16r(t[j] * 0.1f);
          if constexpr (kMasks > 0) t[j] = kept(keep[0][c], j) ? bf16r(t[j] * s1) : 0.f;
          if constexpr (kMasks > 1) t[j] = kept(keep[1][c], j) ? bf16r(t[j] * s2) : 0.f;
          t[j] = xv[j] + t[j];
        }
        yb[i] = pack(t);
      }
    }
  }
}

template <bool kAct, int kMasks>
__global__ void __launch_bounds__(kThreads)
residual_bwd(const uint4* __restrict__ g, const uint4* __restrict__ f,
             const uint2* __restrict__ m1, const uint2* __restrict__ m2,
             float s1, float s2, uint4* __restrict__ gf, int64_t per_row,
             int nvec) {
  __shared__ uint2 keep[kMasks > 0 ? kMasks : 1][kMaxVecs];
  const int64_t b = blockIdx.y;
  stage_masks<kMasks>(m1, m2, keep, b, nvec);
  const uint4* gb = g + b * per_row;
  const uint4* fb = kAct ? f + b * per_row : nullptr;
  uint4* ob = gf + b * per_row;
  for (int64_t base = (int64_t)blockIdx.x * kTile; base < per_row;
       base += (int64_t)gridDim.x * kTile) {
    uint4 gr[kUnroll], fr[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = base + k * kThreads + threadIdx.x;
      if (i < per_row) {
        gr[k] = gb[i];
        if constexpr (kAct) fr[k] = fb[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t i = base + k * kThreads + threadIdx.x;
      if (i < per_row) {
        const int c = (int)(i % nvec);
        float u[8], fv[8];
        unpack(gr[k], u);
        if constexpr (kAct) unpack(fr[k], fv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if constexpr (kMasks > 1) u[j] = kept(keep[1][c], j) ? bf16r(u[j] * s2) : 0.f;
          if constexpr (kMasks > 0) u[j] = kept(keep[0][c], j) ? bf16r(u[j] * s1) : 0.f;
          if constexpr (kAct) u[j] = fv[j] > 0.f ? u[j] : u[j] * 0.1f;
        }
        ob[i] = pack(u);
      }
    }
  }
}

dim3 grid_of(int batch, int64_t per_row) {
  const int64_t tiles = (per_row + kTile - 1) / kTile;
  return dim3((unsigned)(tiles < kMaxTiles ? tiles : kMaxTiles), batch);
}

bool bad_shape(int batch, int rows, int D) {
  return D % 8 != 0 || D / 8 > kMaxVecs || D < 8 || batch < 1 ||
         batch > 65535 || rows < 1;
}

}  // namespace

// y [batch, rows, D] bf16 from x and f [batch, rows, D] bf16, keep1 and
// keep2 [batch, D] bool (the first `masks` of them read, in that order,
// with scales scale1 and scale2), LeakyReLU(0.1) on f where leaky != 0.
// D % 8 == 0, D <= 4096; x, f, y 16-byte and the masks 8-byte aligned (the
// wrapper checks).
extern "C" int residual_fwd_bf16(const void* x, const void* f,
                                 const void* keep1, const void* keep2,
                                 float scale1, float scale2, int masks,
                                 int leaky, void* y, int batch, int rows,
                                 int D, void* stream) {
  if (bad_shape(batch, rows, D)) return (int)cudaErrorInvalidValue;
  const int nvec = D / 8;
  const int64_t per_row = (int64_t)rows * nvec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_variant(masks, leaky, [&](auto variant) {
    using V = decltype(variant);
    residual_fwd<V::kAct, V::kMasks><<<grid_of(batch, per_row), kThreads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<const uint4*>(f),
        static_cast<const uint2*>(keep1), static_cast<const uint2*>(keep2),
        scale1, scale2, static_cast<uint4*>(y), per_row, nvec);
    return (int)cudaGetLastError();
  });
}

// grad_f [batch, rows, D] bf16 from the gradient g of y and, where leaky
// != 0, the forward's f; the masks and scales as the forward's.
extern "C" int residual_bwd_bf16(const void* g, const void* f,
                                 const void* keep1, const void* keep2,
                                 float scale1, float scale2, int masks,
                                 int leaky, void* grad_f, int batch, int rows,
                                 int D, void* stream) {
  if (bad_shape(batch, rows, D)) return (int)cudaErrorInvalidValue;
  const int nvec = D / 8;
  const int64_t per_row = (int64_t)rows * nvec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_variant(masks, leaky, [&](auto variant) {
    using V = decltype(variant);
    residual_bwd<V::kAct, V::kMasks><<<grid_of(batch, per_row), kThreads, 0, s>>>(
        static_cast<const uint4*>(g), static_cast<const uint4*>(f),
        static_cast<const uint2*>(keep1), static_cast<const uint2*>(keep2),
        scale1, scale2, static_cast<uint4*>(grad_f), per_row, nvec);
    return (int)cudaGetLastError();
  });
}
