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
// that: a persistent grid of one block an SM walking output tiles (a
// template parameter) in a raster order, one TMA thread keeping a ring of
// K chunks (KD bytes of d: 64 or 128) in flight, two consumer warpgroups
// running wgmma m64nNk32 s8 x s8 -> s32.  The raster order is the
// TPU probes' loop order: query-tile-major ("qfirst": the blocks in flight
// share a query tile, so each ref tile comes from device memory once per
// query tile) or ref-tile-major ("rfirst": they share ref tiles, which come
// from device memory once and from L2 for the other query tiles).
// "parallel" has no meaning here: all blocks run at once.
//
// Two kernels.  kDirect (int8_probe_kernel): q and refs by TMA straight
//   into the stage, 128- or 64-byte swizzled, both wgmma operands in shared
//   memory (ss); BM query rows x BN refs a tile.  Rows whose stride is not
//   a multiple of 16 bytes (d = 2040) are seen as F row classes: [N / F,
//   F D] has 16-byte strides, and a box at column c D of it holds rows c,
//   c + F, ... of class c (a tile is one class's rows).  A box starts on a
//   16-byte boundary, so class c's boxes start delta = (c D) % 16 bytes
//   before its rows; the launcher makes a copy of the queries per class,
//   shifted right by as much and zero around, so the neighbours' bytes in
//   a box meet zeros.  The copy's rows are a multiple of 128 bytes (2176 at
//   d = 2040; B x 2 KB a class, 0.3% of the bytes): box rows that straddle
//   128-byte lines made the loads the pace (on an H100, d = 2040 took 3.09
//   ms with 16-byte rows, 2.16 with these, 1.66 at d = 2048; the refs' own
//   rows still straddle).  Past the matrix, TMA fills zeros.
// kTrans and kInt4 (int8_probe_rs_kernel): the refs reach the tensor cores
//   only through registers.  wgmma takes 8-bit operands from shared memory
//   K-major only, and has no 4-bit form on sm_90a, so the product is turned
//   around: the ref tile is A (M = refs, BR = 128 a tile: one m64 slab a
//   consumer warpgroup), landed raw by TMA and converted by
//   each consumer thread into its own A fragment (wgmma ... s8.s8 with A
//   from registers); the queries are B (N = BQ query rows) from the
//   launcher's copy, K-major by TMA as in kDirect.  One producer thread, no
//   conversion pass in shared memory, no proxy fence a stage.
//   - kTrans: refs^T [D, N] (N contiguous).  A warpgroup's half of the tile
//     lands as [KD d rows, BR / 2 + 16 bytes].  N = 8 mod 16 at the index
//     shape, so the d rows are seen as classes the same way as kDirect's
//     rows, each class's box starting delta bytes early (a box must start
//     on a 16-byte boundary: the 16 bytes of slack).  A thread's fragment
//     rows are adjacent refs (ref_row), so one 16-bit load gives both its
//     refs at one d, and prmt assembles the registers; the k positions of
//     a KD chunk visit the landed rows in an
//     order (k_row) that puts the four lanes of a quad on rows two apart: 8
//     banks apart with BR / 2 + 16 byte rows, no bank conflict.  The
//     queries' copy carries the same d order (trans_d_of).
//   - kInt4: refs packed to nibbles first (int8_probe_pack_int4: half the
//     bytes; from refs^T by a tiled transpose through shared memory), loaded
//     [BR, KD / 2] by TMA, 64-byte swizzled.  The pack puts columns 32 p + j
//     and 32 p + 16 + j in byte j of group p, so one 32-bit load a fragment
//     row and k step gives a[0] (low nibbles) and a[2] (high nibbles),
//     widened to int8 in four integer operations.  The queries' copy wraps
//     them to 4 bits.
//   ptxas serializes every wgmma of a kernel in which an ordinary
//   instruction writes a wgmma's input registers while any wgmma is in
//   flight (its C7513 note), so a warpgroup converts a whole stage's
//   fragments between its batches (KD / 32 wgmmas, then wait), and the two
//   warpgroups issue their batches in turns: one converts while the
//   other's batch runs, having loaded its raw words (ordinary registers)
//   while its own batch ran.  The accumulator rows are refs:
//   the epilogue writes the output transposed.  (On an H100 at the index
//   shape, ldmatrix.trans in place of the 16-bit loads, with shuffles for
//   the classes' delta, and the refs^T tile copied by cp.async with no
//   delta, were both slower: PERF.md.)
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
// setmaxnreg: 3 x 168 registers a thread in all (launch bounds 384, 1)
constexpr int kProducerRegs = 72;
constexpr int kConsumerRegs = 216;
static_assert(kProducerRegs + kConsumers * kConsumerRegs <= 3 * 168, "regs");
// the rs kernel's producer is one thread issuing TMA
constexpr int kRsProducerRegs = 40;
constexpr int kRsConsumerRegs = 232;
static_assert(kRsProducerRegs + kConsumers * kRsConsumerRegs <= 3 * 168,
              "regs");
constexpr int kSmemMax = 232448;              // an H100 block's dynamic limit
constexpr int kMaxStages = 8;
constexpr int kBars = 2 * kMaxStages * 8;     // full and empty a stage
constexpr int kOutCols = 128;                 // the probes' output width
// the rs kernel's consumers issue their batches in turns (named barriers
// kTurn, kTurn + 1)
constexpr int kTurn = 1;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  int B, N, D;
  int classes;     // kDirect: ref row classes F; kTrans: d row classes
  int n_view;      // kDirect: rows of a class (N / F); else N
  int q_rows;      // rows of one class's query copy (B), its map's stride
  int tiles_m, tiles_n, order;   // query and ref tiles; 0: qfirst, 1: rfirst
  int o0;          // first ref row of the output columns
  int stages, checksum;
  int* out;        // [bp, 128], zeroed by the launcher
  unsigned long long* sum;
};

// kDirect: BM query rows x BN refs a tile
template <int BM, int BN, int KD>
struct Cfg {
  static_assert(BM == 128 || BM == 256, "BM");
  static_assert(KD == 64 || KD == 128, "KD");
  static constexpr int kSlabs = BM / 128;          // m64 slabs a consumer
  static constexpr int kA = BM * KD;
  static constexpr int kB = BN * KD;
  static constexpr int kStage = kA + kB;
};

// kTrans, kInt4: BR refs (A) x BQ query rows (B) a tile, one m64 slab of
// refs a consumer warpgroup (two slabs with half the queries were slower
// in both modes on an H100: PERF.md)
template <int BR, int BQ, int KD, int MODE>
struct RsCfg {
  static_assert(BR == 64 * kConsumers, "BR: a slab a consumer warpgroup");
  static_assert(KD == 128, "KD: a k32 step must lie in one d row class");
  static_assert(MODE == kTrans || MODE == kInt4, "mode");
  static constexpr int kHalfRow = BR / 2 + 16;     // kTrans: bytes a d row
  static constexpr int kQ = BQ * KD;
  static constexpr int kRaw = MODE == kTrans ? 2 * KD * kHalfRow
                                             : BR * KD / 2;
  static constexpr int kStage = kQ + (kRaw + 1023) / 1024 * 1024;
};

// K-major operand of a [rows, KD] panel at shared address ``panel``
// (1024-aligned), swizzled KD bytes a row: rows r0 .. (64 or N), k step ks
// of 32 bytes.
template <int KD>
__device__ __forceinline__ uint64_t desc_kd(uint32_t panel, int r0, int ks) {
  return make_desc(panel + r0 * KD + ks * 32, 16, 8 * KD, KD == 128 ? 1 : 2);
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

template <int BM, int BN, int KD>
__global__ void __launch_bounds__(kThreads, 1)
int8_probe_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_r, const Args a) {
  using C = Cfg<BM, BN, KD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const int stages = a.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * C::kStage);
  uint64_t* empty = full + kMaxStages;
  const int F = a.classes;   // ref row classes
  const int tiles = a.tiles_m * a.tiles_n;
  const int wg = warpgroup();

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);   // one arrival a consumer warp
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
    const int delta = (cls * (a.D % 16)) % 16;
    return (a.D + delta + KD - 1) / KD;
  };

  if (wg == kConsumers) {
    // ---- producer: one thread issues TMA ----
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0, cls;
        decode(t, m0, n0, cls);
        const int chunks = chunks_of(cls);
        for (int kc = 0; kc < chunks; ++kc, ++it) {
          const int s = it % stages;
          if (it >= stages) mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
          uint8_t* stage = smem + s * C::kStage;
          const int k0 = kc * KD;
          const int delta = (cls * (a.D % 16)) % 16;
          mbar_expect_tx(&full[s], C::kA + C::kB);
          tma_load_2d(stage, &tm_q, &full[s], k0, cls * a.q_rows + m0);
          // bytes before the row's start and past its end are its
          // neighbours' (or TMA's zeros): the shifted queries are zero
          // there
          tma_load_2d(stage + C::kA, &tm_r, &full[s],
                      cls * a.D - delta + k0, n0);
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

// kTrans: the landed row (of a warpgroup's [KD, BR / 2 + 16] half) that k
// position p of a KD chunk reads.  p = 32 ks + 16 h + 4 q + j (ks the k32
// step, h the register pair a[0..1] or a[2..3], q = lane % 4, j the byte)
// reads row 32 ks + 16 h + 8 (j >> 1) + 2 q + (j & 1): the four lanes of a
// quad two rows apart.  A bijection of 0 .. KD - 1 (ops/int8_probe.py::
// k_rows_of, which also maps rows to d under row classes).
__device__ __forceinline__ constexpr int k_row(int ks, int h, int q, int j) {
  return 32 * ks + 16 * h + 8 * (j >> 1) + 2 * q + (j & 1);
}

// Fragment row 16 warp + g + 8 i of warpgroup wg: its ref in the tile
// (ops/int8_probe.py::ref_rows_of).  kTrans: rows g and g + 8 are the
// adjacent refs 2 g, 2 g + 1, so that one 16-bit load at a d row gives
// both; kInt4: the rows in order (the 64-byte swizzle keeps a warp's
// 32-bit loads apart).
template <int MODE>
__device__ __forceinline__ int ref_row(int wg, int warp, int i, int g) {
  return MODE == kTrans ? 64 * wg + 16 * warp + 2 * g + i
                        : 64 * wg + 16 * warp + 8 * i + g;
}

// nibbles of w (every 4-bit field 0 .. 15) -> the int8 of each low nibble
// as two's complement, bytewise: ((x ^ 8) + 0x78) ^ 0x80 = x ^ 8 - 8 with
// no borrow between bytes
__device__ __forceinline__ uint32_t widen_lo(uint32_t w) {
  return (((w & 0x0f0f0f0fu) ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;
}

template <int BR, int BQ, int KD, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
int8_probe_rs_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_r, const Args a) {
  using C = RsCfg<BR, BQ, KD, MODE>;
  constexpr int kSteps = KD / 32;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const int stages = a.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * C::kStage);
  uint64_t* empty = full + kMaxStages;
  const int tiles = a.tiles_m * a.tiles_n;
  const int chunks = (a.D + KD - 1) / KD;
  const int wg = warpgroup();

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);   // one arrival a consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread issues TMA ----
    reg_dealloc<kRsProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int mt, nt;
        tile_of(a, t, mt, nt);
        const int q0 = mt * BQ, r0 = nt * BR;
        for (int kc = 0; kc < chunks; ++kc, ++it) {
          const int s = it % stages;
          if (it >= stages) mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
          uint8_t* stage = smem + s * C::kStage;
          uint8_t* raw = stage + C::kQ;
          const int k0 = kc * KD;
          mbar_expect_tx(&full[s], C::kQ + C::kRaw);
          tma_load_2d(stage, &tm_q, &full[s], k0, q0);
          if (MODE == kTrans) {
            // d rows k0 .. k0 + KD - 1 of refs r0 + h BR / 2 ..: class cd's
            // are view rows k0 / F + i of [D / F, F N], at column cd N -
            // delta + ...; each warpgroup's half lands with its own rows
            const int fd = a.classes;
            const int rows = KD / fd;
            for (int h = 0; h < 2; ++h) {
              for (int cd = 0; cd < fd; ++cd) {
                const int delta = (cd * (a.N % 16)) % 16;
                tma_load_2d(raw + (h * KD + cd * rows) * C::kHalfRow, &tm_r,
                            &full[s], cd * a.N - delta + r0 + h * (BR / 2),
                            k0 / fd);
              }
            }
          } else {
            tma_load_2d(raw, &tm_r, &full[s], k0 / 2, r0);
          }
        }
      }
    }
  } else {
    // ---- consumers: BR / 2 refs each ----
    reg_alloc<kRsConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    int acc[BQ / 2];
    uint32_t fa[kSteps][4];   // a stage's A fragments
    long long csum = 0;
    int it = 0;
    auto release = [&](int slot) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    };
    // Turns: named barrier kTurn + w opens warpgroup w's turn to issue its
    // batch; the other warpgroup opens it after issuing its own (warpgroup
    // 0 goes first).  Each barrier sees as many syncs as arrivals: the
    // warpgroup that goes second passes no turn after its last batch.
    auto pass_turn = [&](bool more) {
      if (wg == 0 || more) bar_arrive(kTurn + 1 - wg, 256);
    };
    if (wg == 1) pass_turn(true);
    // kTrans: this thread's refs in its warpgroup's half of the raw tile
    // (bytes after the class's delta)
    const int my_ref = ref_row<MODE>(0, warp, 0, g);
    // kInt4: the 64-byte swizzle of this thread's rows (bits 1-2 of the
    // row: g >> 1 for both)
    const int swz = (g >> 1) & 3;

    // A stage's fragments in two steps.  load_raw: this thread's raw words
    // of the stage at ``raw`` (ordinary registers, not a wgmma's, so they
    // are loaded while the warpgroup's previous batch runs); convert: the
    // words to the A fragments, only after that batch has retired.  kTrans:
    // rw[ks][4 h + j] holds refs 2 g, 2 g + 1 at k position 32 ks + 16 h +
    // 4 t4 + j; kInt4: rw[ks][i] the packed word of fragment row i, k step
    // ks.
    constexpr int kRaw = MODE == kTrans ? 8 : 2;
    uint32_t rw[kSteps][kRaw];
    auto load_raw = [&](const uint8_t* raw) {
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        if (MODE == kTrans) {
          // a k32 step lies in one d row class: its delta
          const int fd = a.classes;
          const int cd = (32 * ks) / (KD / fd);
          const int delta = (cd * (a.N % 16)) % 16;
          const uint8_t* base =
              raw + wg * KD * C::kHalfRow + delta + my_ref;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              rw[ks][4 * h + j] = *reinterpret_cast<const uint16_t*>(
                  base + k_row(ks, h, t4, j) * C::kHalfRow);
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            rw[ks][i] = *reinterpret_cast<const uint32_t*>(
                raw + ref_row<MODE>(wg, warp, i, g) * (KD / 2) +
                ((ks ^ swz) << 4) + 4 * t4);
          }
        }
      }
    };
    auto convert = [&] {
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        if (MODE == kTrans) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // byte i of word j is ref 2 g + i: register i gathers byte i
            // of words 0 .. 3
            const uint32_t* w = rw[ks] + 4 * h;
            const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
            const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
            fa[ks][2 * h] = __byte_perm(t0, t1, 0x5410);
            fa[ks][2 * h + 1] = __byte_perm(t0, t1, 0x7632);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            fa[ks][i] = widen_lo(rw[ks][i]);            // k 4 t4 .. + 3
            fa[ks][2 + i] = widen_lo(rw[ks][i] >> 4);   // k 16 + 4 t4 ..
          }
        }
      }
    };

    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int mt, nt;
      tile_of(a, t, mt, nt);
      const int q0 = mt * BQ, r0 = nt * BR;
      fence_regs(acc);
      // the tile's first stage: its raw words now, the later ones while
      // the batch before them runs
      mbar_wait(&full[it % stages], (it / stages) & 1);
      load_raw(smem + (it % stages) * C::kStage + C::kQ);
      for (int kc = 0; kc < chunks; ++kc, ++it) {
        const int s = it % stages;
        const uint32_t q_addr = smem_u32(smem + s * C::kStage);
        // ptxas serializes every wgmma of a kernel in which an ordinary
        // instruction writes a wgmma's input registers while another wgmma
        // is in flight (its C7513 note): the fragments are written only
        // between a warpgroup's batches, and the other warpgroup's batch
        // keeps the tensor cores busy meanwhile
        convert();
        bar_sync(kTurn + wg, 256);   // this warpgroup's turn
        fence_regs(fa);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          WgmmaS8<BQ>::rs(acc, fa[ks], desc_kd<KD>(q_addr, 0, ks),
                          (kc | ks) != 0);
        }
        wgmma_commit();
        pass_turn(t + (int)gridDim.x < tiles || kc + 1 < chunks);
        if (kc + 1 < chunks) {
          const int next = (it + 1) % stages;
          mbar_wait(&full[next], ((it + 1) / stages) & 1);
          load_raw(smem + next * C::kStage + C::kQ);
        }
        wgmma_wait<0>();
        fence_regs(fa);
        fence_regs(acc);
        // the next convert() reads the raw words only after the wait: no
        // fragment is computed while the batch runs
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
          for (int x = 0; x < kRaw; ++x) {
            asm volatile("" : "+r"(rw[ks][x])::"memory");
          }
        }
        release(s);
      }

      // ---- epilogue: the 64-bit sum and the output columns ----
      // accumulator acc[4 j + 2 i + c]: ref ref_row(wg, warp, i, g) of the
      // tile, query 8 j + 2 t4 + c of the tile
      const int q_lim = a.B - q0;   // queries of the tile in range
      const bool fast_sum = q_lim >= BQ && a.D <= 4096;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ref = r0 + ref_row<MODE>(wg, warp, i, g);
        const bool row_ok = ref < a.N;
        if (a.checksum) {
          long long part = 0;
          if (fast_sum) {
            // 16 accumulators of |x| <= 4096 * 128^2 = 2^26 a 32-bit sum
#pragma unroll
            for (int j0 = 0; j0 < BQ / 8; j0 += 8) {
              unsigned s32 = 0;
#pragma unroll
              for (int j = j0; j < j0 + 8; ++j) {
                s32 += (unsigned)acc[4 * j + 2 * i] +
                       (unsigned)acc[4 * j + 2 * i + 1];
              }
              part += (int)s32;
            }
          } else {
#pragma unroll
            for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int x = 8 * j + 2 * t4 + c;
                part += x < q_lim ? acc[4 * j + 2 * i + c] : 0;
              }
            }
          }
          csum += row_ok ? part : 0;
        }
        const int col = ref - a.o0;
        if (row_ok && col >= 0 && col < kOutCols) {
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int x = 8 * j + 2 * t4 + c;
              if (x < q_lim) {
                a.out[(size_t)(q0 + x) * kOutCols + col] =
                    acc[4 * j + 2 * i + c];
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

// kTrans: d offset (in a KD chunk) of the query column that k position p
// carries: the landed row k_row(p) is view row i of class cd (row = cd KD
// / F + i), d = F i + cd.
__device__ __forceinline__ int trans_d_of(int p, int kd, int classes) {
  const int row = k_row(p / 32, (p / 16) % 2, (p / 4) % 4, p % 4);
  const int rows = kd / classes;
  return classes * (row % rows) + row / rows;
}

// q [B, D] -> out [classes, B, qw]: copy c holds the queries shifted right
// by (c D) % 16 bytes, zero before and after (wrapped to 4 bits if wrap4):
// rows that TMA can take, lined up with class c's boxes.  With trans_kd
// (kTrans, one copy) column y = KD kc + p holds d = KD kc + trans_d_of(p)
// instead, for the d row classes ``trans_classes``.
__global__ void pad_queries(const int8_t* __restrict__ q,
                            int8_t* __restrict__ out, int B, int D, int qw,
                            int classes, int wrap4, int trans_kd,
                            int trans_classes) {
  const size_t n = (size_t)classes * B * qw;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int y = (int)(i % qw);
    const size_t row = i / qw;
    const int c = (int)(row / B);
    const int x = trans_kd ? y - y % trans_kd +
                                 trans_d_of(y % trans_kd, trans_kd,
                                            trans_classes)
                           : y - (c * (D % 16)) % 16;
    int v = x >= 0 && x < D ? q[(row % B) * D + x] : 0;
    if (wrap4) v = ((v & 15) ^ 8) - 8;
    out[i] = (int8_t)v;
  }
}

// The packed layout, out [N, pw], pw = 16 ceil(D / 32): byte j of 16-byte
// group p holds the low 4 bits of column 32 p + j (low nibble) and of
// column 32 p + 16 + j (high nibble), zero past D.  Word i of a group from
// bytes 4 i .. 4 i + 3 of its low and high halves:
__device__ __forceinline__ uint32_t pack_word(uint32_t lo, uint32_t hi) {
  return (lo & 0x0f0f0f0fu) | ((hi & 0x0f0f0f0fu) << 4);
}

// refs [N, D] -> packed: one 16-byte group a thread, its 32 columns read
// as 8-byte words where D allows (a row's groups are adjacent threads:
// reads and writes coalesce).
__global__ void pack_int4_rows(const int8_t* __restrict__ r,
                               uint4* __restrict__ out, int N, int D,
                               int pw) {
  const int groups = pw / 16;
  const size_t n_groups = (size_t)N * groups;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
       i < n_groups; i += (size_t)gridDim.x * blockDim.x) {
    const size_t n = i / groups;
    const int c0 = 32 * (int)(i % groups);
    const int8_t* row = r + n * D;
    uint32_t w[8];   // columns c0 + 4 k .. + 3
    if (D % 8 == 0 && c0 + 32 <= D) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + c0) + k);
        w[2 * k] = v.x;
        w[2 * k + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        uint32_t x = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int col = c0 + 4 * k + b;
          x |= (col < D ? (uint32_t)(uint8_t)row[col] : 0u) << (8 * b);
        }
        w[k] = x;
      }
    }
    out[i] = make_uint4(pack_word(w[0], w[4]), pack_word(w[1], w[5]),
                        pack_word(w[2], w[6]), pack_word(w[3], w[7]));
  }
}

// refs^T [D, N] -> packed, through shared memory: a block reads a tile of
// kPackD d rows x kPackN refs with coalesced loads (32-bit words where N
// allows, a warp a row), then each thread packs one 16-byte group of four
// refs from eight words of the tile (4 x 4 byte transposes), a warp's
// stores covering 8 refs x 64 contiguous bytes.  Tile word w of row r is
// kept at w ^ 8 ((r / 32) % 4), so that neither the row-wise stores nor
// the column-wise gathers meet a bank conflict.
constexpr int kPackD = 256;
constexpr int kPackN = 128;
constexpr int kPackPitch = kPackN / 4 + 1;   // words a tile row

__global__ void __launch_bounds__(256)
pack_int4_cols(const int8_t* __restrict__ rt, uint4* __restrict__ out, int N,
               int D, int pw) {
  __shared__ uint32_t tile[kPackD * kPackPitch];
  const int n0 = blockIdx.x * kPackN;
  const int d0 = blockIdx.y * kPackD;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool words = N % 4 == 0;
#pragma unroll 4
  for (int row = warp; row < kPackD; row += 8) {
    const int d = d0 + row;
    const int n = n0 + 4 * lane;
    uint32_t x = 0;
    if (d < D) {
      const int8_t* src = rt + (size_t)d * N + n;
      if (words) {
        if (n < N) x = __ldg(reinterpret_cast<const uint32_t*>(src));
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          x |= (n + b < N ? (uint32_t)(uint8_t)src[b] : 0u) << (8 * b);
        }
      }
    }
    tile[row * kPackPitch + (lane ^ (8 * ((row >> 5) & 3)))] = x;
  }
  __syncthreads();
  // refs 4 rq .. 4 rq + 3, group p of the tile (d 32 p .. 32 p + 31)
  const int rq = lane % 8 + 8 * (warp % 4);
  const int p = lane / 8 + 4 * (warp / 4);
  const int group = d0 / 32 + p;
  if (group * 16 >= pw) return;
  uint32_t w[32];   // refs 4 rq .. + 3 at d 32 p + j
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    w[j] = tile[(32 * p + j) * kPackPitch + (rq ^ (8 * (p & 3)))];
  }
  // 4 x 4 byte transpose: t[x] = byte x of v[0 .. 3]
  auto transpose = [](const uint32_t* v, uint32_t (&t)[4]) {
    const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140);
    const uint32_t t1 = __byte_perm(v[2], v[3], 0x5140);
    const uint32_t t2 = __byte_perm(v[0], v[1], 0x7362);
    const uint32_t t3 = __byte_perm(v[2], v[3], 0x7362);
    t[0] = __byte_perm(t0, t1, 0x5410);
    t[1] = __byte_perm(t0, t1, 0x7632);
    t[2] = __byte_perm(t2, t3, 0x5410);
    t[3] = __byte_perm(t2, t3, 0x7632);
  };
  uint32_t o[4][4];   // o[x][k]: word k of ref 4 rq + x's group
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t lo[4], hi[4];   // [x]: d 32 p + 4 k .. + 3 (+ 16 for hi)
    transpose(w + 4 * k, lo);
    transpose(w + 16 + 4 * k, hi);
#pragma unroll
    for (int x = 0; x < 4; ++x) o[x][k] = pack_word(lo[x], hi[x]);
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int n = n0 + 4 * rq + x;
    if (n < N) {
      out[(size_t)n * (pw / 16) + group] =
          make_uint4(o[x][0], o[x][1], o[x][2], o[x][3]);
    }
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

template <typename Kern>
int start(Kern kern, const CUtensorMap& tm_q, const CUtensorMap& tm_r,
          const Launch& l, const Args& a, int stage, cudaStream_t s) {
  const int bytes = a.stages * stage + kBars + 1024;
  if (a.stages < 2 || a.stages > kMaxStages || bytes > kSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err != cudaSuccess) return (int)err;
  kern<<<l.grid, kThreads, bytes, s>>>(tm_q, tm_r, a);
  return (int)cudaGetLastError();
}

template <int BM, int BN, int KD>
int launch_direct(const Launch& l, const Args& a, cudaStream_t s) {
  CUtensorMap tm_q, tm_r;
  // queries [classes * q_rows, q_stride]; refs [N / F, F D]
  if (!make_map(&tm_q, l.q, (uint64_t)a.classes * a.q_rows, l.q_stride,
                l.q_stride, BM, KD, KD) ||
      !make_map(&tm_r, l.r, a.n_view, (uint64_t)a.classes * a.D,
                (uint64_t)a.classes * a.D, BN, KD, KD)) {
    return (int)cudaErrorInvalidValue;
  }
  return start(int8_probe_kernel<BM, BN, KD>, tm_q, tm_r, l, a,
               Cfg<BM, BN, KD>::kStage, s);
}

template <int BR, int BQ, int KD, int MODE>
int launch_rs(const Launch& l, const Args& a, cudaStream_t s) {
  using C = RsCfg<BR, BQ, KD, MODE>;
  CUtensorMap tm_q, tm_r;
  bool ok = make_map(&tm_q, l.q, a.q_rows, l.q_stride, l.q_stride, BQ, KD,
                     KD);
  if (MODE == kTrans) {
    // [D / F, F N], boxes of KD / F d rows x (BR / 2 + 16) refs
    ok = ok && make_map(&tm_r, l.r, a.D / a.classes, (uint64_t)a.classes * a.N,
                        (uint64_t)a.classes * a.N, KD / a.classes,
                        C::kHalfRow, 0);
  } else {
    ok = ok && make_map(&tm_r, l.r, a.N, l.r_stride, l.r_stride, BR, KD / 2,
                        64);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return start(int8_probe_rs_kernel<BR, BQ, KD, MODE>, tm_q, tm_r, l, a,
               C::kStage, s);
}

}  // namespace

// Shared memory of one stage of a configuration, in bytes (0: no such
// configuration); ops/int8_probe.py picks the ring's depth from it (and
// mirrors it: stage_bytes).  (a, b, kd): kDirect BM queries x BN refs;
// kTrans and kInt4 BR refs x BQ queries.
extern "C" int int8_probe_stage_bytes(int mode, int a, int b, int kd) {
#define I8P_DIRECT(BM_, BN_, KD_)                                     \
  if (mode == kDirect && a == BM_ && b == BN_ && kd == KD_) {         \
    return Cfg<BM_, BN_, KD_>::kStage;                                \
  }
#define I8P_RS(M, BR_, BQ_, KD_)                                      \
  if (mode == M && a == BR_ && b == BQ_ && kd == KD_) {               \
    return RsCfg<BR_, BQ_, KD_, M>::kStage;                           \
  }
  I8P_DIRECT(128, 128, 128) I8P_DIRECT(128, 128, 64)
  I8P_DIRECT(128, 192, 128) I8P_DIRECT(128, 192, 64)
  I8P_DIRECT(128, 256, 128) I8P_DIRECT(128, 256, 64)
  I8P_DIRECT(256, 128, 128) I8P_DIRECT(256, 128, 64)
  I8P_RS(kTrans, 128, 256, 128) I8P_RS(kInt4, 128, 256, 128)
#undef I8P_DIRECT
#undef I8P_RS
  return 0;
}

// The probe.  q: the queries as the kernel reads them ([q_classes *
// q_rows, q_stride] int8, rows of 16-byte stride: the caller's own or
// int8_probe_pad_queries' copy); r: refs [N, D] (mode 0, rows seen as
// ``classes`` classes), refs^T [D, N] (mode 1, d rows as ``classes``
// classes) or packed nibbles [N, r_stride] (mode 2); (a, b, kd) the tile as
// int8_probe_stage_bytes names it; out [bp, 128] int32 and sum (one u64)
// zeroed here.  Returns the CUDA error code (0: launched;
// cudaErrorInvalidValue for a configuration not built, a ring that does not
// fit or a tensor map the driver refuses).
extern "C" int int8_probe_s8(const void* q, int q_stride, int q_rows,
                             const void* r, int r_stride, void* out,
                             void* sum, int B, int N, int D, int mode,
                             int ta, int tb, int kd, int classes, int order,
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
  if (mode == kDirect) {   // ta query rows, tb refs
    a.tiles_m = (B + ta - 1) / ta;
    a.tiles_n = classes * ((a.n_view + tb - 1) / tb);
  } else {                 // ta refs, tb query rows
    a.tiles_m = (B + tb - 1) / tb;
    a.tiles_n = (N + ta - 1) / ta;
  }
  a.order = order; a.o0 = o0; a.stages = stages; a.checksum = checksum;
  a.out = static_cast<int*>(out);
  a.sum = static_cast<unsigned long long*>(sum);
  Launch l{q, q_stride, r, r_stride, grid};
#define I8P_DIRECT(BM_, BN_, KD_)                                     \
  if (mode == kDirect && ta == BM_ && tb == BN_ && kd == KD_) {       \
    return launch_direct<BM_, BN_, KD_>(l, a, s);                     \
  }
#define I8P_RS(M, BR_, BQ_, KD_)                                      \
  if (mode == M && ta == BR_ && tb == BQ_ && kd == KD_) {             \
    return launch_rs<BR_, BQ_, KD_, M>(l, a, s);                      \
  }
  I8P_DIRECT(128, 128, 128) I8P_DIRECT(128, 128, 64)
  I8P_DIRECT(128, 192, 128) I8P_DIRECT(128, 192, 64)
  I8P_DIRECT(128, 256, 128) I8P_DIRECT(128, 256, 64)
  I8P_DIRECT(256, 128, 128) I8P_DIRECT(256, 128, 64)
  I8P_RS(kTrans, 128, 256, 128) I8P_RS(kInt4, 128, 256, 128)
#undef I8P_DIRECT
#undef I8P_RS
  return (int)cudaErrorInvalidValue;
}

extern "C" int int8_probe_pad_queries(const void* q, void* out, int B, int D,
                                      int qw, int classes, int wrap4,
                                      int trans_kd, int trans_classes,
                                      void* stream) {
  const size_t n = (size_t)classes * B * qw;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  pad_queries<<<blocks > 0 ? blocks : 1, 256, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<int8_t*>(out), B, D, qw,
      classes, wrap4, trans_kd, trans_classes);
  return (int)cudaGetLastError();
}

// refs [N, D] (or refs^T [D, N] with trans) -> packed [N, pw], pw =
// 16 ceil(D / 32), the layout of pack_word.
extern "C" int int8_probe_pack_int4(const void* r, void* out, int N, int D,
                                    int pw, int trans, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pw != 16 * ((D + 31) / 32) || N < 1 || D < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (trans) {
    const dim3 grid((N + kPackN - 1) / kPackN, (D + kPackD - 1) / kPackD);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    pack_int4_cols<<<grid, 256, 0, s>>>(static_cast<const int8_t*>(r),
                                        static_cast<uint4*>(out), N, D, pw);
  } else {
    const size_t groups = (size_t)N * (pw / 16);
    const int blocks =
        (int)((groups + 255) / 256 < 65536 ? (groups + 255) / 256 : 65536);
    pack_int4_rows<<<blocks, 256, 0, s>>>(static_cast<const int8_t*>(r),
                                          static_cast<uint4*>(out), N, D, pw);
  }
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
