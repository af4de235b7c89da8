// The int8 tensor-core probe for Hopper (sm_90a): every product of
// q [B, D] x refs [N, D] (or refs^T [D, N]) on wgmma, with no top-k
// epilogue, so that the int8 rate of the card can be read at the genotype
// index shape (B, N, D = 1024, 664,648, 2040).
//
// Replaces the three Pallas probes at the repository root:
//   tools/probe_mxu.py::matmul_only_kernel (refs [N, D], tiles tq x tn x td),
//   tools/probe_mxu2.py::kern (the same with loop order and "parallel"),
//   tools/probe_mxu3.py::kern (refs [N, D] or [D, N], int8 or int4, the
//     accumulator reset only at the first query tile of each ref tile).
// What they return (ops/int8_probe.py::int8_probe_plain): int32 [bp, 128],
// bp = B rounded up to tq, the products of the queries with the 128 ref
// rows o0 .. o0 + 127 of the last ref tile (o0 = (ceil(N / tn) - 1) tn;
// rows past N are zeros); probe 3 adds over query tiles (a running sum).
// tq, tn and td decide only that padding and o0: the TPU grid's tiles are
// not this kernel's.  The kernel writes those 128 columns and, as proof
// that it took every product of the B x N x D grid, a 64-bit sum of every
// accumulator it finished (it must equal colsum(q) . colsum(refs)).
//
// What bounds it on the H100: 2 B N D int8 operations (2.777e12 at the
// index shape: 1.403 ms at 1,979 TOP/s) against 1.36 GB of refs read once
// (0.41 ms at 3.35 TB/s): operations.  The design is the usual one for
// that: a persistent grid of one block an SM walking output tiles of
// BM x BN (a template parameter) in a raster order, one TMA warp keeping a
// ring of K chunks (KD bytes of d: 64 or 128) in flight, two consumer
// warpgroups of BM / 2 query rows each running wgmma m64nBNk32 s8 x s8 ->
// s32 with both operands K-major in shared memory.  The raster order is the
// TPU probes' loop order: query-tile-major ("qfirst": the blocks in flight
// share a query tile, so each ref tile comes from device memory once per
// query tile) or ref-tile-major ("rfirst": they share ref tiles, which come
// from device memory once and from L2 for the other query tiles).
// "parallel" has no meaning here: all blocks run at once.
//
// Three producers, one consumer:
//   kDirect: q and refs by TMA straight into the stage, 128- or 64-byte
//     swizzled.  Rows whose stride is not a multiple of 16 bytes (d = 2040)
//     are seen as F row classes: [N / F, F D] has 16-byte strides, and a box
//     at column c D of it holds rows c, c + F, ... of class c (a tile is one
//     class's rows).  A box starts on a 16-byte boundary, so class c's boxes
//     start delta = (c D) % 16 bytes before its rows; the launcher makes a
//     copy of the queries per class, shifted right by as much and zero
//     around, so the neighbours' bytes in a box meet zeros.  The copy's
//     rows are a multiple of 128 bytes (2176 at d = 2040; B x 2 KB a class,
//     0.3% of the bytes): box rows that straddle 128-byte lines made the
//     loads the pace (on an H100, d = 2040 took 3.09 ms with 16-byte rows,
//     2.16 with these, 1.66 at d = 2048; the refs' own rows still
//     straddle).  Past the matrix, TMA fills zeros.
//   kTrans: refs^T [D, N] (N contiguous).  wgmma takes 8-bit operands
//     K-major only (its transpose immediate exists for 16-bit types), so
//     each landed [KD, BN] tile is transposed in shared memory by the
//     producer's other three warps (4 x 4 byte blocks through prmt) into
//     the K-major panel, then fenced for the asynchronous proxy.  N = 8
//     mod 16 at the index shape: the d rows are seen as classes the same
//     way (the transposing warps take each row from its class's box).
//   kInt4: wgmma has no 4-bit form on sm_90a.  The refs are packed to
//     nibbles first (int8_probe_pack_int4: half the bytes), a tile is
//     loaded packed and unpacked to int8 in shared memory by the same three
//     warps.  The queries' copy wraps them to 4 bits.
// The consumers fold each finished accumulator into a 64-bit sum (rows
// past B and refs past N masked) and write the accumulators that fall in
// the 128 output columns.  No atomics except one 64-bit add a warp at the
// end: the output and the sum are the same every run.

#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

enum Mode { kDirect = 0, kTrans = 1, kInt4 = 2 };

constexpr int kConsumers = 2;                 // warpgroups 0, 1
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kConverters = 96;               // producer warps 1-3
// setmaxnreg: 3 x 168 registers a thread in all (launch bounds 384, 1)
constexpr int kProducerRegs = 72;
constexpr int kConsumerRegs = 216;
static_assert(kProducerRegs + kConsumers * kConsumerRegs <= 3 * 168, "regs");
constexpr int kSmemMax = 232448;              // an H100 block's dynamic limit
constexpr int kMaxStages = 8;
constexpr int kOutCols = 128;                 // the probes' output width
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  int B, N, D;
  int classes;     // kDirect: ref row classes F; kTrans: d row classes
  int n_view;      // kDirect: rows of a class (N / F); else N
  int q_rows;      // rows of one class's query copy (B), its map's stride
  int tiles_m, tiles_n, order;   // order 0: qfirst, 1: rfirst
  int o0;          // first ref row of the output columns
  int stages, checksum;
  int* out;        // [bp, 128], zeroed by the launcher
  unsigned long long* sum;
};

template <int BM, int BN, int KD, int MODE>
struct Cfg {
  static_assert(BM == 128 || BM == 256, "BM");
  static_assert(KD == 64 || KD == 128, "KD");
  static constexpr int kSlabs = BM / 128;          // m64 slabs a consumer
  static constexpr int kA = BM * KD;
  static constexpr int kB = BN * KD;
  static constexpr int kRawRow = BN + 16;          // kTrans: bytes a d row
  static constexpr int kRaw = MODE == kTrans  ? KD * kRawRow
                              : MODE == kInt4 ? BN * KD / 2
                                              : 0;
  static constexpr int kStage = kA + kB + (kRaw + 1023) / 1024 * 1024;
  static constexpr int kBars = 3 * kMaxStages * 8;
};

// K-major operand of a [rows, KD] panel at shared address ``panel``
// (1024-aligned), swizzled KD bytes a row: rows r0 .. (64 or N), k step ks
// of 32 bytes.
template <int KD>
__device__ __forceinline__ uint64_t desc_kd(uint32_t panel, int r0, int ks) {
  return make_desc(panel + r0 * KD + ks * 32, 16, 8 * KD, KD == 128 ? 1 : 2);
}

// Byte offset of 16-byte group G of row n in a KD-swizzled panel.
template <int KD>
__device__ __forceinline__ int swz(int n, int G) {
  return KD == 128 ? n * 128 + ((G ^ (n & 7)) << 4)
                   : n * 64 + ((G ^ ((n >> 1) & 3)) << 4);
}

// (query tile, ref tile) of output tile t in the raster order
__device__ __forceinline__ void tile_of(const Args& a, int t, int& mt,
                                        int& nt) {
  if (a.order == 0) {
    mt = t / a.tiles_n;
    nt = t % a.tiles_n;
  } else {
    nt = t / a.tiles_m;
    mt = t % a.tiles_m;
  }
}

template <int BM, int BN, int KD, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
int8_probe_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_r, const Args a) {
  using C = Cfg<BM, BN, KD, MODE>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const int stages = a.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * C::kStage);
  uint64_t* empty = full + kMaxStages;
  uint64_t* raw_full = empty + kMaxStages;
  const int F = MODE == kDirect ? a.classes : 1;   // ref row classes
  const int tiles = a.tiles_m * a.tiles_n;
  const int wg = warpgroup();

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], MODE == kDirect ? 1 : 1 + kConverters);
      mbar_init(&empty[s], 4 * kConsumers);   // one arrival a consumer warp
      mbar_init(&raw_full[s], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // (query tile, ref tile) of tile t: ref tile nt is (view tile nt / F,
  // class nt % F) under row classes
  auto decode = [&](int t, int& m0, int& n0, int& cls) {
    int mt, nt;
    tile_of(a, t, mt, nt);
    m0 = mt * BM;
    cls = nt % F;
    n0 = (nt / F) * BN;
  };
  // K chunks of a tile: class c's queries are shifted by delta bytes
  auto chunks_of = [&](int cls) {
    const int delta = MODE == kDirect ? (cls * (a.D % 16)) % 16 : 0;
    return (a.D + delta + KD - 1) / KD;
  };

  if (wg == kConsumers) {
    // ---- producer: warp 0 issues TMA, warps 1-3 transpose or unpack ----
    reg_dealloc<kProducerRegs>();
    const int warp = (threadIdx.x / 32) % 4;
    if (warp == 0) {
      if ((threadIdx.x % 32) != 0) return;
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0, cls;
        decode(t, m0, n0, cls);
        const int chunks = chunks_of(cls);
        for (int kc = 0; kc < chunks; ++kc, ++it) {
          const int s = it % stages;
          if (it >= stages) mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
          uint8_t* stage = smem + s * C::kStage;
          uint8_t* raw = stage + C::kA + C::kB;
          const int k0 = kc * KD;
          if (MODE == kDirect) {
            const int delta = (cls * (a.D % 16)) % 16;
            mbar_expect_tx(&full[s], C::kA + C::kB);
            tma_load_2d(stage, &tm_q, &full[s], k0, cls * a.q_rows + m0);
            // bytes before the row's start and past its end are its
            // neighbours' (or TMA's zeros): the shifted queries are zero
            // there
            tma_load_2d(stage + C::kA, &tm_r, &full[s],
                        cls * a.D - delta + k0, n0);
          } else {
            mbar_expect_tx(&full[s], C::kA);
            tma_load_2d(stage, &tm_q, &full[s], k0, m0);
            mbar_expect_tx(&raw_full[s], C::kRaw);
            if (MODE == kTrans) {
              // d rows k0 .. k0 + KD - 1: class cd's are view rows
              // k0 / F + i of [D / F, F N], at column cd N - delta + n0
              const int fd = a.classes;
              const int rows = KD / fd;
              for (int cd = 0; cd < fd; ++cd) {
                const int delta = (cd * (a.N % 16)) % 16;
                tma_load_2d(raw + cd * rows * C::kRawRow, &tm_r,
                            &raw_full[s], cd * a.N - delta + n0, k0 / fd);
              }
            } else {
              tma_load_2d(raw, &tm_r, &raw_full[s], k0 / 2, n0);
            }
          }
        }
      }
    } else if (MODE != kDirect) {
      const int ct = threadIdx.x - 128 * kConsumers - 32;   // 0 .. 95
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int chunks = chunks_of(0);
        for (int kc = 0; kc < chunks; ++kc, ++it) {
          const int s = it % stages;
          mbar_wait(&raw_full[s], (it / stages) & 1);
          uint8_t* stage = smem + s * C::kStage;
          uint8_t* panel = stage + C::kA;
          const uint8_t* raw = stage + C::kA + C::kB;
          if (MODE == kTrans) {
            const int fd = a.classes;
            const int rows = KD / fd;
            // unit: refs 4 n4 .. 4 n4 + 3 x d 16 G .. 16 G + 15
            for (int u = ct; u < (BN / 4) * (KD / 16); u += kConverters) {
              const int n4 = u % (BN / 4);
              const int G = u / (BN / 4);
              uint32_t o[4][4];   // o[jn][q]: ref 4 n4 + jn, d 16 G + 4 q ..
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                uint32_t w[4];   // d 16 G + 4 q + kk: refs 4 n4 .. + 3
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                  const int k = 16 * G + 4 * q + kk;
                  const int cd = k % fd;
                  const int delta = (cd * (a.N % 16)) % 16;
                  w[kk] = *reinterpret_cast<const uint32_t*>(
                      raw + (cd * rows + k / fd) * C::kRawRow + delta +
                      4 * n4);
                }
                const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
                const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
                const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);
                const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
                o[0][q] = __byte_perm(t0, t1, 0x5410);
                o[1][q] = __byte_perm(t0, t1, 0x7632);
                o[2][q] = __byte_perm(t2, t3, 0x5410);
                o[3][q] = __byte_perm(t2, t3, 0x7632);
              }
#pragma unroll
              for (int jn = 0; jn < 4; ++jn) {
                *reinterpret_cast<uint4*>(panel + swz<KD>(4 * n4 + jn, G)) =
                    make_uint4(o[jn][0], o[jn][1], o[jn][2], o[jn][3]);
              }
            }
          } else {
            // unit: packed group pg of ref row n -> int8 groups 2 pg, 2 pg + 1
            for (int u = ct; u < BN * (KD / 32); u += kConverters) {
              const int n = u / (KD / 32);
              const int pg = u % (KD / 32);
              const uint4 v = *reinterpret_cast<const uint4*>(
                  raw + n * (KD / 2) + pg * 16);
              const uint32_t in[4] = {v.x, v.y, v.z, v.w};
              uint32_t lo[4], hi[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                // a nibble x is the 4-bit integer (x ^ 8) - 8, bytewise
                lo[i] = __vsub4((in[i] & 0x0f0f0f0fu) ^ 0x08080808u,
                                0x08080808u);
                hi[i] = __vsub4(((in[i] >> 4) & 0x0f0f0f0fu) ^ 0x08080808u,
                                0x08080808u);
              }
              *reinterpret_cast<uint4*>(panel + swz<KD>(n, 2 * pg)) =
                  make_uint4(lo[0], lo[1], lo[2], lo[3]);
              *reinterpret_cast<uint4*>(panel + swz<KD>(n, 2 * pg + 1)) =
                  make_uint4(hi[0], hi[1], hi[2], hi[3]);
            }
          }
          fence_proxy_async();
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ---- consumers: BM / 2 query rows each ----
    reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    int acc[C::kSlabs][BN / 2];
    long long csum = 0;
    int it = 0;
    auto release = [&](int slot) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    };
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0, cls;
      decode(t, m0, n0, cls);
      const int chunks = chunks_of(cls);
#pragma unroll
      for (int sl = 0; sl < C::kSlabs; ++sl) fence_regs(acc[sl]);
      for (int kc = 0; kc < chunks; ++kc, ++it) {
        const int s = it % stages;
        mbar_wait(&full[s], (it / stages) & 1);
        const uint32_t a_addr = smem_u32(smem + s * C::kStage);
        const uint32_t b_addr = a_addr + C::kA;
#pragma unroll
        for (int sl = 0; sl < C::kSlabs; ++sl) fence_regs(acc[sl]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KD / 32; ++ks) {
#pragma unroll
          for (int sl = 0; sl < C::kSlabs; ++sl) {
            WgmmaS8<BN>::ss(acc[sl],
                            desc_kd<KD>(a_addr, wg * (BM / 2) + 64 * sl, ks),
                            desc_kd<KD>(b_addr, 0, ks), (kc | ks) != 0);
          }
        }
        wgmma_commit();
        if (kc > 0) {
          wgmma_wait<1>();
#pragma unroll
          for (int sl = 0; sl < C::kSlabs; ++sl) fence_regs(acc[sl]);
          release((it - 1) % stages);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int sl = 0; sl < C::kSlabs; ++sl) fence_regs(acc[sl]);
      release((it - 1) % stages);

      // ---- epilogue: the 64-bit sum and the output columns ----
      // accumulator acc[sl][4 j + 2 i + c]: row 16 warp + g + 8 i of the
      // slab, column 8 j + 2 t4 + c of the tile
      const int row0 = m0 + wg * (BM / 2) + 16 * warp + g;
      const int n_lim = a.n_view - n0;   // columns of the tile in range
      // ref id of tile column x: (n0 + x) F + cls
      const int id0 = n0 * F + cls;
      const bool writes = id0 <= a.o0 + kOutCols - 1 &&
                          id0 + (BN - 1) * F >= a.o0;
      // a tile whose columns are all in range sums without masks
      const bool fast_sum = n_lim >= BN && a.D <= 4096;
#pragma unroll
      for (int sl = 0; sl < C::kSlabs; ++sl) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int b = row0 + 64 * sl + 8 * i;
          const bool row_ok = b < a.B;
          if (a.checksum) {
            long long part = 0;
            if (fast_sum) {
              // 16 accumulators of |x| <= 4096 * 128^2 = 2^26 a 32-bit sum
#pragma unroll
              for (int j0 = 0; j0 < BN / 8; j0 += 8) {
                unsigned s32 = 0;
#pragma unroll
                for (int j = j0; j < j0 + 8; ++j) {
                  s32 += (unsigned)acc[sl][4 * j + 2 * i] +
                         (unsigned)acc[sl][4 * j + 2 * i + 1];
                }
                part += (int)s32;
              }
            } else {
#pragma unroll
              for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                  const int x = 8 * j + 2 * t4 + c;
                  part += x < n_lim ? acc[sl][4 * j + 2 * i + c] : 0;
                }
              }
            }
            csum += row_ok ? part : 0;
          }
          if (writes && row_ok) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int x = 8 * j + 2 * t4 + c;
                const int col = id0 + x * F - a.o0;
                if (x < n_lim && col >= 0 && col < kOutCols) {
                  a.out[(size_t)b * kOutCols + col] = acc[sl][4 * j + 2 * i + c];
                }
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      csum += __shfl_xor_sync(kFull, csum, off);
    }
    if (lane == 0 && a.checksum) {
      atomicAdd(a.sum, static_cast<unsigned long long>(csum));
    }
  }
}

// q [B, D] -> out [classes, B, qw]: copy c holds the queries shifted right
// by (c D) % 16 bytes, zero before and after (wrapped to 4 bits if wrap4):
// rows that TMA can take, lined up with class c's boxes.
__global__ void pad_queries(const int8_t* __restrict__ q,
                            int8_t* __restrict__ out, int B, int D, int qw,
                            int classes, int wrap4) {
  const size_t n = (size_t)classes * B * qw;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int y = (int)(i % qw);
    const size_t row = i / qw;
    const int c = (int)(row / B);
    const int x = y - (c * (D % 16)) % 16;
    int v = x >= 0 && x < D ? q[(row % B) * D + x] : 0;
    if (wrap4) v = ((v & 15) ^ 8) - 8;
    out[i] = (int8_t)v;
  }
}

// refs [N, D] (or refs^T [D, N] with trans) -> packed [N, pw], pw =
// 16 ceil(D / 32): byte j of 16-byte group p holds the low 4 bits of
// column 32 p + j (low nibble) and of column 32 p + 16 + j (high nibble),
// zero past D.  Four bytes a thread.
__global__ void pack_int4(const int8_t* __restrict__ r,
                          uint32_t* __restrict__ out, int N, int D, int pw,
                          int trans) {
  const size_t words = (size_t)N * (pw / 4);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < words;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t n = i / (pw / 4);
    const int p0 = (int)(i % (pw / 4)) * 4;
    uint32_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int p = p0 + b;
      const int lo_col = 32 * (p / 16) + p % 16;
      const int hi_col = lo_col + 16;
      auto at = [&](int col) -> uint32_t {
        if (col >= D) return 0;
        const int8_t v = trans ? r[(size_t)col * N + n] : r[n * (size_t)D + col];
        return (uint32_t)(v & 15);
      };
      w |= (at(lo_col) | (at(hi_col) << 4)) << (8 * b);
    }
    out[i] = w;
  }
}

// out [tiles, tq, 128] int32: tile i += tile i - 1, in order (probe 3's
// running sum over query tiles); int32 wraps as the TPU's adds do.
__global__ void running_sum(int* __restrict__ out, int tiles, int tq) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= tq * kOutCols) return;
  unsigned run = 0;
  for (int i = 0; i < tiles; ++i) {
    run += (unsigned)out[(size_t)i * tq * kOutCols + e];
    out[(size_t)i * tq * kOutCols + e] = (int)run;
  }
}

// A 2-D map [rows, cols] of bytes (row stride ``stride``: a multiple of
// 16, the base 16-byte aligned), box [box_rows, box_cols]; ``swizzle``
// 128, 64 or 0 bytes.  Past the matrix, zeros.
bool make_map(CUtensorMap* map, const void* base, uint64_t rows,
              uint64_t cols, uint64_t stride, int box_rows, int box_cols,
              int swizzle) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle sw = swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_NONE;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Launch {
  const void* q;     // [q_classes * q_rows, q_stride] int8, 16-byte rows
  int q_stride;
  const void* r;     // refs as the mode takes them
  int r_stride;      // kDirect: D; kTrans: N; kInt4: pw
  int grid;
};

template <int BM, int BN, int KD, int MODE>
int launch(const Launch& l, const Args& a, cudaStream_t s) {
  using C = Cfg<BM, BN, KD, MODE>;
  const int bytes = a.stages * C::kStage + C::kBars + 1024;
  if (a.stages < 2 || a.stages > kMaxStages || bytes > kSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  auto kern = int8_probe_kernel<BM, BN, KD, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tm_q, tm_r;
  const int q_class_rows = MODE == kDirect ? a.classes : 1;
  if (!make_map(&tm_q, l.q, (uint64_t)q_class_rows * a.q_rows, l.q_stride,
                l.q_stride, BM, KD, KD)) {
    return (int)cudaErrorInvalidValue;
  }
  bool ok;
  if (MODE == kDirect) {
    // [N / F, F D]
    ok = make_map(&tm_r, l.r, a.n_view, (uint64_t)a.classes * a.D,
                  (uint64_t)a.classes * a.D, BN, KD, KD);
  } else if (MODE == kTrans) {
    // [D / F, F N], boxes of KD / F d rows x (BN + 16) refs
    ok = make_map(&tm_r, l.r, a.D / a.classes, (uint64_t)a.classes * a.N,
                  (uint64_t)a.classes * a.N, KD / a.classes, C::kRawRow, 0);
  } else {
    ok = make_map(&tm_r, l.r, a.N, l.r_stride, l.r_stride, BN, KD / 2, 0);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  kern<<<l.grid, kThreads, bytes, s>>>(tm_q, tm_r, a);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of one stage of a configuration, in bytes (0: no such
// configuration); ops/int8_probe.py picks the ring's depth from it.
extern "C" int int8_probe_stage_bytes(int mode, int bm, int bn, int kd) {
#define I8P_STAGE(M, BM_, BN_, KD_)                              \
  if (mode == M && bm == BM_ && bn == BN_ && kd == KD_) {        \
    return Cfg<BM_, BN_, KD_, M>::kStage;                        \
  }
  I8P_STAGE(kDirect, 128, 128, 128) I8P_STAGE(kDirect, 128, 128, 64)
  I8P_STAGE(kDirect, 128, 192, 128) I8P_STAGE(kDirect, 128, 192, 64)
  I8P_STAGE(kDirect, 128, 256, 128) I8P_STAGE(kDirect, 128, 256, 64)
  I8P_STAGE(kDirect, 256, 128, 128) I8P_STAGE(kDirect, 256, 128, 64)
  I8P_STAGE(kTrans, 128, 128, 128) I8P_STAGE(kTrans, 128, 192, 128)
  I8P_STAGE(kInt4, 128, 128, 128) I8P_STAGE(kInt4, 128, 256, 128)
#undef I8P_STAGE
  return 0;
}

// The probe.  q: the queries as the kernel reads them ([q_classes *
// q_rows, q_stride] int8, rows of 16-byte stride: the caller's own or
// int8_probe_pad_queries' copy); r: refs [N, D] (mode 0, rows seen as
// ``classes`` classes), refs^T [D, N] (mode 1, d rows as ``classes``
// classes) or packed nibbles [N, r_stride] (mode 2); out [bp, 128] int32
// and sum (one u64) zeroed here.  Returns the CUDA error code (0: launched;
// cudaErrorInvalidValue for a configuration not built, a ring that does not
// fit or a tensor map the driver refuses).
extern "C" int int8_probe_s8(const void* q, int q_stride, int q_rows,
                             const void* r, int r_stride, void* out,
                             void* sum, int B, int N, int D, int mode,
                             int bm, int bn, int kd, int classes, int order,
                             int o0, int out_rows, int stages, int checksum,
                             int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)out_rows * kOutCols * 4, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(sum, 0, 8, s);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.B = B; a.N = N; a.D = D; a.classes = classes;
  a.n_view = mode == kDirect ? N / classes : N;
  a.q_rows = q_rows;
  a.tiles_m = (B + bm - 1) / bm;
  a.tiles_n = mode == kDirect ? classes * ((a.n_view + bn - 1) / bn)
                              : (N + bn - 1) / bn;
  a.order = order; a.o0 = o0; a.stages = stages; a.checksum = checksum;
  a.out = static_cast<int*>(out);
  a.sum = static_cast<unsigned long long*>(sum);
  Launch l{q, q_stride, r, r_stride, grid};
#define I8P_LAUNCH(M, BM_, BN_, KD_)                             \
  if (mode == M && bm == BM_ && bn == BN_ && kd == KD_) {        \
    return launch<BM_, BN_, KD_, M>(l, a, s);                    \
  }
  I8P_LAUNCH(kDirect, 128, 128, 128) I8P_LAUNCH(kDirect, 128, 128, 64)
  I8P_LAUNCH(kDirect, 128, 192, 128) I8P_LAUNCH(kDirect, 128, 192, 64)
  I8P_LAUNCH(kDirect, 128, 256, 128) I8P_LAUNCH(kDirect, 128, 256, 64)
  I8P_LAUNCH(kDirect, 256, 128, 128) I8P_LAUNCH(kDirect, 256, 128, 64)
  I8P_LAUNCH(kTrans, 128, 128, 128) I8P_LAUNCH(kTrans, 128, 192, 128)
  I8P_LAUNCH(kInt4, 128, 128, 128) I8P_LAUNCH(kInt4, 128, 256, 128)
#undef I8P_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" int int8_probe_pad_queries(const void* q, void* out, int B, int D,
                                      int qw, int classes, int wrap4,
                                      void* stream) {
  const size_t n = (size_t)classes * B * qw;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  pad_queries<<<blocks > 0 ? blocks : 1, 256, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<int8_t*>(out), B, D, qw,
      classes, wrap4);
  return (int)cudaGetLastError();
}

extern "C" int int8_probe_pack_int4(const void* r, void* out, int N, int D,
                                    int pw, int trans, void* stream) {
  const size_t words = (size_t)N * (pw / 4);
  const int blocks =
      (int)((words + 255) / 256 < 65536 ? (words + 255) / 256 : 65536);
  pack_int4<<<blocks > 0 ? blocks : 1, 256, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(r), static_cast<uint32_t*>(out), N, D, pw,
      trans);
  return (int)cudaGetLastError();
}

extern "C" int int8_probe_running_sum(void* out, int tiles, int tq,
                                      void* stream) {
  const int threads = tq * kOutCols;
  running_sum<<<(threads + 255) / 256, 256, 0,
                static_cast<cudaStream_t>(stream)>>>(static_cast<int*>(out),
                                                      tiles, tq);
  return (int)cudaGetLastError();
}
