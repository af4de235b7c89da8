// LayerNorm of bf16 activations for Hopper (sm_90a): the forward, the
// backward, and the column sums of the backward's partial dgamma / dbeta.
//
// Replaces no TPU kernel: on the TPU, XLA fuses flax's LayerNorm (float32
// statistics, output in the compute dtype) into its neighbours.  Added
// because in bf16 the port ran each LayerNorm as three PyTorch kernels
// (x.float(), F.layer_norm in float32, .to(bfloat16)) and its backward as
// four (the gradient cast up, layer_norm_grad_input, GammaBetaBackward
// reading the float32 x and dy again, dx cast down): about 20 B an element
// forward and 32 B backward, a quarter of a tpu_default training
// micro-step on the H100.
//
// Semantics: those of models/layers.py::LayerNorm's plain path, rounded
// once to bf16 at the same points.  With mean and var = mean((x - mean)^2)
// of the row in float32 and rstd = rsqrt(var + eps):
//   y      = bf16((x - mean) * rstd * gamma + beta)     gamma, beta float32
//   dx     = bf16(rstd * (gamma dy - mean(gamma dy) - xhat mean(gamma dy xhat)))
//   dgamma = sum over rows of dy xhat,  dbeta = sum over rows of dy  (float32)
// where xhat = (x - mean) * rstd, from the mean and rstd the forward saved.
//
// What bounds it on the H100: bytes.  The forward reads x and writes y (4 B
// an element), the backward reads x and dy and writes dx (6 B); gamma,
// beta, the row statistics and the partial sums are a few percent more.
// At the training shape (49,440 rows of 384 or of 1536) the forward is
// 0.023 / 0.091 ms of HBM time and the backward 0.034 / 0.136 ms.
//
// Design.  A row belongs to a group of G threads (8, 16, 32, 64 or 128: the
// smallest for which each thread holds at most 4 16-byte vectors of 8 bf16),
// neighbouring threads on neighbouring vectors, so every load is 16 bytes a
// thread and coalesced.  The row stays in registers: x is read once, and
// the variance is a second pass over the registers (no E[x^2] - E[x]^2
// cancellation).  A group sums by xor shuffles inside its warp and, for
// G = 64 or 128, across its warps through shared memory.  A block is 128
// threads, 128 / G rows at a time.  The forward writes mean and rstd only
// when the wrapper asks (under autograd).  The backward runs at most as many
// blocks as are resident at once; each walks the rows in a fixed stride,
// each thread sums dy xhat and dy of its columns over its rows in
// registers, and the block adds its row groups in shared memory in a fixed
// order into one partial row of dgamma and of dbeta.  A second kernel sums
// the partial rows column by column in a fixed order.  No atomics: reruns
// are bit-identical, and the grid depends only on the shape and the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxVecs = 512;   // 16-byte vectors a row: D <= 4096

template <int G_, int NV_>
struct Shape {
  static constexpr int G = G_;     // threads a row
  static constexpr int NV = NV_;   // 16-byte vectors a thread
};

// The (G, NV) of a row of nvec vectors; fn(Shape<G, NV>{}), or
// cudaErrorInvalidValue for a width no instance takes.
template <typename Fn>
int with_shape(int nvec, Fn&& fn) {
  if (nvec < 1) return (int)cudaErrorInvalidValue;
  if (nvec <= 8) return fn(Shape<8, 1>{});
  if (nvec <= 16) return fn(Shape<8, 2>{});
  if (nvec <= 24) return fn(Shape<8, 3>{});
  if (nvec <= 32) return fn(Shape<8, 4>{});
  if (nvec <= 48) return fn(Shape<16, 3>{});
  if (nvec <= 64) return fn(Shape<16, 4>{});
  if (nvec <= 96) return fn(Shape<32, 3>{});
  if (nvec <= 128) return fn(Shape<32, 4>{});
  if (nvec <= 192) return fn(Shape<64, 3>{});
  if (nvec <= 256) return fn(Shape<64, 4>{});
  if (nvec <= 384) return fn(Shape<128, 3>{});
  if (nvec <= kMaxVecs) return fn(Shape<128, 4>{});
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

// The 8 float32 values of vector c of a [D] parameter.
__device__ __forceinline__ void load8(const float* p, int c, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[2 * c];
  const float4 b = reinterpret_cast<const float4*>(p)[2 * c + 1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Sums each of v[0..N) over the G threads of a row.  Every thread of the
// block calls it (for G > 32 it synchronises the block).
template <int G, int N>
__device__ __forceinline__ void group_sum(float (&v)[N],
                                          float (&red)[N][kThreads / 32]) {
#pragma unroll
  for (int o = (G < 32 ? G : 32) / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += __shfl_xor_sync(0xffffffffu, v[n], o);
  }
  if constexpr (G > 32) {
    constexpr int kWarps = G / 32;
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
#pragma unroll
      for (int n = 0; n < N; ++n) red[n][warp] = v[n];
    }
    __syncthreads();
    const int first = warp / kWarps * kWarps;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[n][first + w];
      v[n] = s;
    }
    __syncthreads();
  }
}

template <int G, int NV>
__global__ void __launch_bounds__(kThreads)
ln_fwd(const uint4* __restrict__ x, const float* __restrict__ gamma,
       const float* __restrict__ beta, uint4* __restrict__ y,
       float* __restrict__ mean_out, float* __restrict__ rstd_out, int rows,
       int nvec, float eps) {
  __shared__ float red[1][kThreads / 32];
  const int lane = threadIdx.x % G;
  const int64_t row = (int64_t)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const bool live = row < rows;
  const float inv_d = 1.f / (8 * nvec);
  float v[NV][8];
  float s[1] = {0.f};
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + i * G;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (live && c < nvec) raw = x[row * nvec + c];
    unpack(raw, v[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) s[0] += v[i][j];
  }
  group_sum<G>(s, red);
  const float mean = s[0] * inv_d;
  float q[1] = {0.f};
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (lane + i * G < nvec) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[i][j] - mean;
        q[0] += d * d;
      }
    }
  }
  group_sum<G>(q, red);
  const float rstd = rsqrtf(q[0] * inv_d + eps);
  if (!live) return;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + i * G;
    if (c < nvec) {
      float g[8], b[8], o[8];
      load8(gamma, c, g);
      load8(beta, c, b);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = (v[i][j] - mean) * rstd * g[j] + b[j];
      y[row * nvec + c] = pack(o);
    }
  }
  if (mean_out != nullptr && lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// One partial row of a [D] sum: the block's row groups added in order.
template <int G, int NV>
__device__ __forceinline__ void block_partial(const float (&v)[NV][8],
                                              float* acc, float* out,
                                              int nvec) {
  constexpr int kCols = G * NV * 8;
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = lane + i * G;
    if (c < nvec) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[grp * kCols + c * 8 + j] = v[i][j];
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < 8 * nvec; col += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kThreads / G; ++r) s += acc[r * kCols + col];
    out[col] = s;
  }
  __syncthreads();
}

template <int G, int NV>
__global__ void __launch_bounds__(kThreads)
ln_bwd(const uint4* __restrict__ dy, const uint4* __restrict__ x,
       const float* __restrict__ mean, const float* __restrict__ rstd,
       const float* __restrict__ gamma, uint4* __restrict__ dx,
       float* __restrict__ parts, int rows, int nvec) {
  constexpr int kRows = kThreads / G;
  __shared__ float red[2][kThreads / 32];
  __shared__ float acc[kThreads * NV * 8];
  const int lane = threadIdx.x % G;
  const float inv_d = 1.f / (8 * nvec);
  float dg[NV][8], db[NV][8];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) dg[i][j] = db[i][j] = 0.f;
  }
  for (int64_t base = (int64_t)blockIdx.x * kRows; base < rows;
       base += (int64_t)gridDim.x * kRows) {
    const int64_t row = base + threadIdx.x / G;
    const bool live = row < rows;
    uint4 xr[NV], gr[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + i * G;
      xr[i] = gr[i] = make_uint4(0, 0, 0, 0);
      if (live && c < nvec) {
        xr[i] = x[row * nvec + c];
        gr[i] = dy[row * nvec + c];
      }
    }
    const float mu = live ? mean[row] : 0.f;
    const float rs = live ? rstd[row] : 0.f;
    float ab[2] = {0.f, 0.f};   // sums of gamma dy and of gamma dy xhat
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = lane + i * G;
      if (c < nvec) {
        float xv[8], gv[8], gm[8];
        unpack(xr[i], xv);
        unpack(gr[i], gv);
        load8(gamma, c, gm);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xh = (xv[j] - mu) * rs;
          const float gd = gv[j] * gm[j];
          ab[0] += gd;
          ab[1] += gd * xh;
          dg[i][j] += gv[j] * xh;
          db[i][j] += gv[j];
        }
      }
    }
    group_sum<G>(ab, red);
    const float a = ab[0] * inv_d, b = ab[1] * inv_d;
    if (live) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = lane + i * G;
        if (c < nvec) {
          float xv[8], gv[8], gm[8], o[8];
          unpack(xr[i], xv);
          unpack(gr[i], gv);
          load8(gamma, c, gm);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float xh = (xv[j] - mu) * rs;
            o[j] = rs * (gv[j] * gm[j] - a - xh * b);
          }
          dx[row * nvec + c] = pack(o);
        }
      }
    }
  }
  const int64_t d = 8 * nvec;
  block_partial<G, NV>(dg, acc, parts + blockIdx.x * d, nvec);
  block_partial<G, NV>(db, acc, parts + (gridDim.x + blockIdx.x) * d, nvec);
}

// out[k][col] = sum over p of parts[k][p][col] for k = 0 (dgamma), 1
// (dbeta): 32 columns a block, 32 slices of the partial rows a column,
// each summed in order, then the slices in order.
__global__ void __launch_bounds__(1024)
ln_bwd_sum(const float* __restrict__ parts, float* __restrict__ out, int np,
           int d) {
  __shared__ float s[32][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const float* p = parts + (int64_t)blockIdx.y * np * d;
  float acc = 0.f;
  if (col < d) {
    for (int r = threadIdx.y; r < np; r += 32) acc += p[(int64_t)r * d + col];
  }
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < 32; ++r) t += s[r][threadIdx.x];
    out[blockIdx.y * d + col] = t;
  }
}

}  // namespace

// y [rows, D] bf16 from x [rows, D] bf16 and gamma, beta [D] float32; mean
// and rstd [rows] float32 written when both are non-null.  D % 8 == 0,
// D <= 4096; x, y, gamma, beta 16-byte aligned (the wrapper checks).
extern "C" int layer_norm_fwd_bf16(const void* x, const void* gamma,
                                   const void* beta, void* y, void* mean,
                                   void* rstd, int rows, int D, float eps,
                                   void* stream) {
  if (D % 8 != 0 || rows < 1) return (int)cudaErrorInvalidValue;
  const int nvec = D / 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = (mean != nullptr && rstd != nullptr) ? static_cast<float*>(mean)
                                                  : nullptr;
  return with_shape(nvec, [&](auto shape) {
    using S = decltype(shape);
    constexpr int kRows = kThreads / S::G;
    const int grid = (rows + kRows - 1) / kRows;
    ln_fwd<S::G, S::NV><<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<uint4*>(y), m,
        m != nullptr ? static_cast<float*>(rstd) : nullptr, rows, nvec, eps);
    return (int)cudaGetLastError();
  });
}

// The number of partial rows (blocks) the backward takes for rows x D on
// the current device: the blocks resident at once, or fewer if the rows
// need fewer.
extern "C" int layer_norm_bwd_parts(int rows, int D, int* parts) {
  if (D % 8 != 0 || rows < 1) return (int)cudaErrorInvalidValue;
  return with_shape(D / 8, [&](auto shape) {
    using S = decltype(shape);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ln_bwd<S::G, S::NV>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    constexpr int kRows = kThreads / S::G;
    const int need = (rows + kRows - 1) / kRows;
    const int resident = sms * (per_sm > 0 ? per_sm : 1);
    *parts = need < resident ? need : resident;
    return (int)cudaSuccess;
  });
}

// dx [rows, D] bf16 and dgamma_dbeta [2, D] float32 (dgamma, then dbeta)
// from dy, x [rows, D] bf16, the forward's mean and rstd [rows] float32
// and gamma [D] float32; partials is [2, parts, D] float32 scratch, parts
// from layer_norm_bwd_parts for the same rows and D.
extern "C" int layer_norm_bwd_bf16(const void* dy, const void* x,
                                   const void* mean, const void* rstd,
                                   const void* gamma, void* dx,
                                   void* partials, void* dgamma_dbeta,
                                   int rows, int D, int parts, void* stream) {
  if (D % 8 != 0 || rows < 1 || parts < 1) return (int)cudaErrorInvalidValue;
  const int nvec = D / 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  const int rc = with_shape(nvec, [&](auto shape) {
    using S = decltype(shape);
    ln_bwd<S::G, S::NV><<<parts, kThreads, 0, s>>>(
        static_cast<const uint4*>(dy), static_cast<const uint4*>(x),
        static_cast<const float*>(mean), static_cast<const float*>(rstd),
        static_cast<const float*>(gamma), static_cast<uint4*>(dx), part, rows,
        nvec);
    return (int)cudaGetLastError();
  });
  if (rc != 0) return rc;
  ln_bwd_sum<<<dim3((D + 31) / 32, 2), dim3(32, 32), 0, s>>>(
      part, static_cast<float*>(dgamma_dbeta), parts, D);
  return (int)cudaGetLastError();
}
