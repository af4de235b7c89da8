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
// value is exact.  int4 compute is int8 here (Hopper has no int4 mma),
// which gives the same exact result.
//
// What bounds it on the H100: at the token-serving shape (q [64, 1030],
// refs [2048, 1030]) one call reads 2.2 MB and does 0.3 GOP, a few us of
// either: launch overhead bounds it.  At the genotype-index shape (1024
// queries vs 664,648 binary vectors, d = 2040, pack 8: 170 MB) it does
// 2.8 T int8 operations, 1.41 ms at 1979 TOP/s: operations bound it.
// The TPU kernel walked ref tiles in grid order and carried each query
// tile's top-k in scratch; GPU blocks run in no order, so:
//   pass 1, l2rf_split_topk: grid (query tile of 128, split of the ref
//     rows); the blocks that share a split are neighbours in launch order,
//     so a ref tile comes from device memory once and from L2 for the
//     other query tiles.  A block is three warpgroups:
//     * the loader (warpgroup 2) fills a ring of stages, each one
//       128-byte chunk of the unpacked width: the chunk of the block's 128
//       queries (16 KB) and of the tile's 192 ref rows (24 KB), both in
//       the 128-byte swizzle that wgmma's descriptors name, each stage
//       under a "full" and an "empty" mbarrier.  Queries always come by
//       TMA (the launcher first copies queries whose rows TMA cannot take
//       into a workspace with 16-byte row strides).  Refs come
//       - by TMA straight into the stage (pack 1, 16-byte rows and base);
//       - packed (pack 2/4/8): each packed 128-byte column block of the
//         tile is loaded once, by TMA, into a staging buffer; the
//         loader's 128 threads take it into registers (48 each; the next
//         block's load starts at once) and unpack its planes from there by
//         shift and mask into the stages, one plane a stage: reading the
//         staging buffer once a plane made the loader wait for shared
//         memory behind wgmma's reads and set the kernel's pace.  The K
//         loop walks (packed column block, plane), which integer sums
//         allow, so pack 8 reads 1/8 of pack 1's bytes.  An unpacked
//         16-byte group lands at the address of its packed group, so the
//         swizzle carries over;
//       - pack 1 rows whose stride is not a multiple of 16 bytes (d = 2040
//         or 1030) on a 16-byte base: by TMA all the same, through the
//         [N / F, F * d] view of the matrix, whose stride is one; a box of
//         it holds the rows c, c + F, ... of one "row class", and a block
//         searches one class (see the kernel);
//       - what is left (a base off 16 bytes, F not dividing N): the same
//         128 threads fill the same stages (or the staging buffer) with
//         cp.async pieces of the rows' alignment, up to three chunks in
//         flight, or with byte loads below 4-byte alignment.  Same
//         kernel, other producer.
//       Stores that wgmma reads (unpacked bytes, cp.async, byte loads) are
//       followed by fence.proxy.async in the writing thread before its
//       arrival on the stage's "full" barrier: wgmma reads shared memory
//       through the asynchronous proxy and may otherwise see stale bytes.
//       Chunks whose unpacked columns all lie past d (zero queries) are
//       skipped by every role.  The loader also turns each tile's norms
//       into int32 codes in a two-slot ring.
//     * two consumer warpgroups (0, 1) of 64 queries each: per chunk four
//       wgmma m64n192k32 s8 x s8 -> s32, both operands K-major in shared
//       memory, 96 int32 accumulators a thread, one group in flight.  In
//       the split's first tile they also sum their queries' squares from
//       the stages.  Selection from registers: each row's bound (k-th
//       best distance minus |q|^2) lives in a register of the four
//       threads that hold the row; norm - 2 q.r is compared against it
//       where the accumulators are, and the four threads find the row's
//       (distance, column) minimum below the bound.  Only a row that has
//       one goes to its sorted list in shared memory (a warp-wide insert),
//       lowers its bound and looks again, until nothing is below the
//       bound: best first, so a tile costs a row one insert per entry
//       that stays, equal distances arrive in ascending id order (tiles
//       ascend too, so a strict < keeps the lower id on ties), and a tile
//       that offers nothing costs one pass over the accumulators.  Rows
//       past the split or N and rows with a +inf norm carry a norm code
//       that no bound admits; after the split's last tile a list that is
//       still short takes the split's +inf rows in id order, so they rank
//       after every finite row.
//     Shared memory no longer grows with d, so the width limit is that of
//     the selection's int32 arithmetic (8192); the lists grow with k (128
//     rows x 8 bytes x k rounded up to 16 or a multiple of 32), so the
//     ring has 4 stages at k <= 32, 3 at k <= 64, and down to 2 (1 with
//     packed refs' staging buffer) at k = 128 (l2_topk_rf_smem; every
//     k <= 128 is right, small k is fast).
//   pass 2, l2rf_merge: one warp per query merges the splits' lists in
//     split order with the same insert: lower ids come from earlier
//     splits, so the tie rule holds.  No atomics: reruns are bit-identical.
// Replaces the first design (four warps, mma.sync m16n8k32, the block's
// queries resident over the whole d, refs fetched once per plane, every
// distance through shared memory).

#include <math_constants.h>

#include <climits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 128;        // queries per pass-1 block, 64 per consumer
constexpr int kBN = 192;        // ref rows per tile: wgmma's n
constexpr int kKD = 128;        // unpacked bytes of d per chunk
constexpr int kConsumers = 2;   // warpgroups 0, 1; the loader is 2
constexpr int kThreads = 128 * (kConsumers + 1);
// setmaxnreg: the loader holds a packed column block in 48 registers, a
// consumer 96 accumulators and the selection's state; 3 x 168 in all.
// (Without it the pack 8 index search took 3.87 ms, with it 3.41.)
constexpr int kLoaderRegs = 120;
constexpr int kConsumerRegs = 192;
static_assert(kLoaderRegs + kConsumers * kConsumerRegs <= 3 * 168, "registers");
constexpr int kMergeThreads = 128;
constexpr int kQChunk = kBQ * kKD;      // bytes of a stage's query part
constexpr int kRChunk = kBN * kKD;      // bytes of its ref part
constexpr int kStage = kQChunk + kRChunk;
constexpr int kMaxStages = 4;
constexpr int kSmemMax = 232448;        // an H100 block's dynamic limit
constexpr int kDistInf = INT_MAX - 1;   // a row whose norm is +inf
constexpr int kEmpty = INT_MAX;         // a slot no row has filled
constexpr int kRnNone = 0x60000000;     // norm code: +inf, or past the split
// Selection compares norm - 2 q.r with (k-th best distance) - |q|^2, capped
// at kThrCap.  With the unpacked width at most 8192 (the wrapper's limit) a
// distance is below 2^29 and |2 q.r| below 2^28, so: every finite row
// passes the cap; kRnNone minus 2 q.r stays above the cap, without
// overflow; and a taken accumulator (kTaken: minus 2 of it is 2^30) passes
// no bound at all.
constexpr int kThrCap = 1 << 30;
constexpr int kTaken = -(1 << 29);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kQnBar = 1;       // named barriers kQnBar + consumer
constexpr int kLoadBar = 3;     // the loader's own

// Byte offsets into the block's shared memory (after 1024-byte alignment).
struct Layout {
  int staging, ld, li, rns, qn, bars, bytes;
  __host__ __device__ Layout(int stages, int kp, bool packed) {
    staging = stages * kStage;
    ld = staging + (packed ? kRChunk : 0);
    li = ld + kBQ * kp * 4;
    rns = li + kBQ * kp * 4;
    qn = rns + 2 * kBN * 4;
    bars = qn + kBQ * 4;
    bytes = bars + (2 * kMaxStages + 5) * 8 + 1024;
  }
};

// ---- loading rows that TMA cannot take ----

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int piece, int valid) {
  const uint32_t d = smem_u32(dst);
  if (piece == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid) : "memory");
  } else if (piece == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [n0, n0 + 192) x byte columns [col0, col0 + 128) of r [*, rw] into
// the swizzled panel ``dst`` (16-byte group c of row i at i * 128 +
// ((c ^ (i & 7)) * 16), what TMA's 128-byte swizzle writes); rows at or
// past n_end and bytes at or past rw become zeros.  ``align`` is the
// largest of 16/8/4 dividing the base address and rw, else 1: cp.async in
// pieces of it, or byte loads.  Called by ``threads`` threads (a multiple
// of 64): thread ``tid`` takes group tid % 8 of rows tid / 8, + threads / 8,
// ..., so what depends on the column is computed once.
template <int A>
__device__ __forceinline__ void fill_pieces(uint8_t* out, const int8_t* src,
                                            const int8_t* any, int left) {
#pragma unroll
  for (int p = 0; p < 16; p += A) {
    const int valid = min(max(left - p, 0), A);
    // nothing is read where valid is 0: any address that is aligned
    cp_async(out + p, valid ? src + p : any, A, valid);
  }
}

__device__ __forceinline__ void fill_panel(uint8_t* dst,
                                           const int8_t* __restrict__ r,
                                           int n0, int n_end, int rw,
                                           int col0, int align, int tid,
                                           int threads) {
  const int c = tid & 7;
  const int col = col0 + c * 16;
  const int in_row = min(max(rw - col, 0), 16);
  const int step = threads >> 3;   // rows between a thread's groups
  // step is a multiple of 8, so i & 7 is the same for all of them
  uint8_t* out = dst + (tid >> 3) * 128 + ((c ^ ((tid >> 3) & 7)) << 4);
  const int8_t* src = r + (size_t)(n0 + (tid >> 3)) * rw + col;
  for (int i = tid >> 3; i < kBN; i += step) {
    const int left = n0 + i < n_end ? in_row : 0;
    if (align == 16) {
      fill_pieces<16>(out, src, r, left);
    } else if (align == 8) {
      fill_pieces<8>(out, src, r, left);
    } else if (align == 4) {
      fill_pieces<4>(out, src, r, left);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int word = 0; word < 4; ++word) {
        w[word] = 0;
#pragma unroll
        for (int byte = 0; byte < 4; ++byte) {
          const int p = 4 * word + byte;
          if (p < left) w[word] |= (uint32_t)(uint8_t)src[p] << (8 * byte);
        }
      }
      *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    out += step * 128;
    src += (size_t)step * rw;
  }
}

// ---- the sorted lists ----

// Insert (cd, ci) into the sorted list ld/li of length k (warp-wide; every
// lane passes the same candidate).  Entries i = lane + 32 j.  The new entry
// goes after every entry with a distance <= cd: callers offer candidates in
// ascending id order among equal distances.  Requires cd < ld[k - 1].
template <int J>   // k <= 32 J
__device__ __forceinline__ void insert(int* ld, int* li, int k, int cd,
                                       int ci, int lane) {
  int p = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = lane + 32 * j;
    p += __popc(__ballot_sync(kFull, i < k && ld[i] <= cd));
  }
  // entries p .. k - 2 move up by one, 32 at a time from the top, so that
  // a step reads only entries that no step has written yet
#pragma unroll
  for (int j = J - 1; j >= 0; --j) {
    const int i = lane + 32 * j;
    int nd = cd, ni = ci;
    if (i < k && i > p) {
      nd = ld[i - 1];
      ni = li[i - 1];
    }
    __syncwarp();
    if (i < k && i >= p) {
      ld[i] = nd;
      li[i] = ni;
    }
    __syncwarp();
  }
}

// The first unpacked column of the chunk (packed column block cb, plane m);
// the chunk is skipped by every role if that lies at or past d.
__device__ __forceinline__ int chunk_start(int cb, int m, int rw) {
  return m * rw + cb * kKD;
}

struct Args {
  const int8_t* q;   // rows of q_bytes bytes (a multiple of 16), zero past d
  const int8_t* r;
  const float* rnorm;
  int* cand_d;
  int* cand_i;
  int B, N, d, q_bytes, rw, pack, classes, k, kp, rows_per_split, stages,
      r_tma, r_align;
};

__global__ void __launch_bounds__(kThreads, 1)
l2rf_split_topk(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_r, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const bool packed = a.pack > 1;
  const Layout lay(a.stages, a.kp, packed);
  uint8_t* staging = smem + lay.staging;
  int* Ld = reinterpret_cast<int*>(smem + lay.ld);
  int* Li = reinterpret_cast<int*>(smem + lay.li);
  int* rns = reinterpret_cast<int*>(smem + lay.rns);
  int* qn_s = reinterpret_cast<int*>(smem + lay.qn);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + kMaxStages;
  uint64_t* st_full = empty + kMaxStages;
  uint64_t* rn_full = st_full + 1;
  uint64_t* rn_empty = rn_full + 2;

  const int b0 = blockIdx.x * kBQ;
  // Row classes (pack 1 refs whose rows are not 16-byte strided): class c
  // of F holds rows c, c + F, ...; seen as [N / F, F * rw] the matrix has
  // 16-byte strides, and a TMA box at column c * rw of it holds one
  // class's rows.  A block works on one class (F = 1: on all rows); n
  // counts the class's rows, row n of class c has id n * F + c.
  const int split = blockIdx.y;
  const int F = a.classes;
  const int cls = split % F;
  // A box must start on a 16-byte boundary: class c's starts ``delta``
  // bytes before its rows do, and the class has a copy of the queries
  // shifted right by as much (the launcher makes them), zero before.
  const int delta = (cls * a.rw) % 16;
  const int dq = a.d + delta;   // the shifted queries' width
  const int n_begin = (split / F) * a.rows_per_split;
  const int n_end = min(n_begin + a.rows_per_split, a.N / F);
  const int tiles = (n_end - n_begin + kBN - 1) / kBN;
  const int consumers = a.B - b0 <= 64 ? 1 : kConsumers;
  const int stages = a.stages;
  // The K walk: packed column blocks of 128 bytes, each with its planes.
  const int ncb = packed ? a.rw / kKD : (dq + kKD - 1) / kKD;
  const int planes = a.pack;
  const bool direct = a.r_tma && !packed;   // refs by TMA into the stage
  // (only then can F exceed 1)
  const int wg = warpgroup();

  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      // the query TMA's arrival, and the loader's threads' when they
      // write the ref part themselves
      mbar_init(&full[s], direct ? 1 : 129);
      mbar_init(&empty[s], 4 * consumers);   // one arrival a consumer warp
    }
    mbar_init(st_full, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(&rn_full[s], 128);
      mbar_init(&rn_empty[s], 4 * consumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- loader ----
    reg_dealloc<kLoaderRegs>();
    const int tid = threadIdx.x - 128 * kConsumers;
    const int bits = 8 / a.pack;
    const uint32_t mask = ((1u << bits) - 1) * 0x01010101u;
    // cp.async pieces of up to three chunks are in flight: the arrival
    // for a chunk lags its start by ``lag`` chunks.  The consumers free a
    // slot one chunk after they were handed it, so the ring must be two
    // slots deeper than the lag, or the loader waits for a slot whose
    // release waits for an arrival it has not made yet.
    const int lag = min(max(stages - 2, 0), 2);
    int p0 = 0, p1 = 0, n_pend = 0;   // slots started and not yet arrived
    int it = 0;          // chunks so far: ring slot it % stages
    // Packed refs: column block x of the split's tiles * ncb, tile-major,
    // goes through the staging buffer; its TMA load is started as soon as
    // the threads hold block x - 1 in registers.
    const int blocks = packed ? tiles * ncb : 0;
    auto stage_block = [&](int x) {
      mbar_expect_tx(st_full, kRChunk);
      tma_load_2d(staging, &tm_r, st_full, (x % ncb) * kKD,
                  n_begin + (x / ncb) * kBN);
    };
    if (a.r_tma && tid == 0 && blocks > 0) stage_block(0);
    for (int t = 0; t < tiles; ++t) {
      const int n0 = n_begin + t * kBN;
      {
        const int slot = t & 1;
        if (t >= 2) mbar_wait(&rn_empty[slot], ((t >> 1) & 1) ^ 1);
        for (int e = tid; e < kBN; e += 128) {
          int code = kRnNone;
          if (n0 + e < n_end) {
            const float x = a.rnorm[(size_t)(n0 + e) * F + cls];
            if (!isinf(x)) code = min((int)x, (1 << 28) - 1);
          }
          rns[slot * kBN + e] = code;
        }
        mbar_arrive(&rn_full[slot]);
      }
      for (int cb = 0; cb < ncb; ++cb) {
        // this thread's 16-byte groups of the packed column block: loaded
        // from the staging buffer once, unpacked once a plane
        uint4 pk[kRChunk / 16 / 128];
        if (packed) {
          const int x = t * ncb + cb;
          if (a.r_tma) {
            mbar_wait(st_full, x & 1);
          } else {
            fill_panel(staging, a.r, n0, n_end, a.rw, cb * kKD, a.r_align,
                       tid, 128);
            cp_async_commit();
            cp_async_wait<0>();
            bar_sync(kLoadBar, 128);
          }
#pragma unroll
          for (int u = 0; u < kRChunk / 16 / 128; ++u) {
            // volatile: the assembler must not load a group again later
            // in place of keeping it, the next block's TMA load overwrites it
            asm volatile("ld.volatile.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                         : "=r"(pk[u].x), "=r"(pk[u].y), "=r"(pk[u].z),
                           "=r"(pk[u].w)
                         : "r"(smem_u32(staging) + 16 * (tid + 128 * u))
                         : "memory");
          }
          // The staging buffer is free for the next block's load once
          // every thread HOLDS its groups: a warp reaches a barrier with
          // shared-memory loads still queued (behind wgmma's reads they
          // queue for long), and the load that TMA then starts overtook
          // them.  A branch on the loaded words makes each thread wait for
          // them first.
          uint32_t held = 0;
#pragma unroll
          for (int u = 0; u < kRChunk / 16 / 128; ++u) {
            held |= pk[u].x | pk[u].y | pk[u].z | pk[u].w;
          }
          if (held == 0x9e3779b9u) __nanosleep(0);   // any value: no effect
          bar_sync(kLoadBar, 128);
          if (a.r_tma && tid == 0 && x + 1 < blocks) {
            fence_proxy_async();
            stage_block(x + 1);
          }
        }
        for (int m = 0; m < planes; ++m) {
          const int u0 = chunk_start(cb, m, a.rw);
          if (u0 >= dq) continue;
          const int s = it % stages;
          if (direct) {
            if (tid == 0) {
              if (it >= stages) {
                mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
              }
              uint8_t* stage = smem + s * kStage;
              mbar_expect_tx(&full[s], kStage);
              tma_load_2d(stage, &tm_q, &full[s], u0, cls * a.B + b0);
              // bytes before the row's start and past its end are its
              // neighbours' (or zeros): the queries are zero there
              tma_load_2d(stage + kQChunk, &tm_r, &full[s],
                          cls * a.rw - delta + u0, n0);
            }
          } else {
            if (it >= stages) mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
            uint8_t* stage = smem + s * kStage;
            if (tid == 0) {
              mbar_expect_tx(&full[s], kQChunk);
              tma_load_2d(stage, &tm_q, &full[s], u0, b0);
            }
            if (packed) {
              // group u of the packed block is group u of the plane
              const int shift = m * bits;
              uint4* out = reinterpret_cast<uint4*>(stage + kQChunk);
#pragma unroll
              for (int u = 0; u < kRChunk / 16 / 128; ++u) {
                uint4 v = pk[u];
                v.x = (v.x >> shift) & mask;
                v.y = (v.y >> shift) & mask;
                v.z = (v.z >> shift) & mask;
                v.w = (v.w >> shift) & mask;
                out[tid + 128 * u] = v;
              }
              fence_proxy_async();
              mbar_arrive(&full[s]);
            } else {
              fill_panel(stage + kQChunk, a.r, n0, n_end, a.rw, u0,
                         a.r_align, tid, 128);
              cp_async_commit();
              // This thread's pieces of the oldest chunk have landed once
              // at most ``lag`` groups are pending; then the fence, then
              // the arrival.
              if (n_pend == lag) {
                if (lag == 0) {
                  cp_async_wait<0>();
                } else if (lag == 1) {
                  cp_async_wait<1>();
                } else {
                  cp_async_wait<2>();
                }
                fence_proxy_async();
                mbar_arrive(&full[lag == 0 ? s : p0]);
                p0 = p1;
                n_pend = max(n_pend - 1, 0);
              }
              if (lag > 0) {
                if (n_pend == 0) p0 = s; else p1 = s;
                ++n_pend;
              }
            }
          }
          ++it;
        }
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    if (n_pend >= 1) mbar_arrive(&full[p0]);
    if (n_pend == 2) mbar_arrive(&full[p1]);
  } else if (wg < consumers) {
    // ---- consumers ----
    reg_alloc<kConsumerRegs>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;   // accumulator row group
    const int t4 = lane & 3;   // thread in group
    const int k = a.k, kp = a.kp;
    const int row0 = 64 * wg + 16 * warp + g;   // and row0 + 8

    for (int i = tid; i < 64 * kp; i += 128) {
      Ld[64 * wg * kp + i] = kEmpty;
      Li[64 * wg * kp + i] = -1;
    }
    int chunks = 0;
    for (int cb = 0; cb < ncb; ++cb) {
      for (int m = 0; m < planes; ++m) {
        chunks += chunk_start(cb, m, a.rw) < dq;
      }
    }
    {
      // |q|^2 of the warpgroup's 64 queries, two threads a row, while the
      // loader fills the ring
      const int row = 64 * wg + (tid >> 1);
      int sum = 0;
      if (b0 + row < a.B) {
        const int8_t* qr = a.q + (size_t)(b0 + row) * a.q_bytes;
        for (int c = (tid & 1) * 16; c < a.q_bytes; c += 32) {
          const uint4 v = *reinterpret_cast<const uint4*>(qr + c);
          sum = __dp4a((int)v.x, (int)v.x, sum);
          sum = __dp4a((int)v.y, (int)v.y, sum);
          sum = __dp4a((int)v.z, (int)v.z, sum);
          sum = __dp4a((int)v.w, (int)v.w, sum);
        }
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      if ((tid & 1) == 0) qn_s[row] = sum;
    }
    bar_sync(kQnBar + wg, 128);   // the lists are initialised, |q|^2 is there

    int acc[kBN / 2];
    // per row: |q|^2 and the bound on norm - 2 q.r (the list is empty: any
    // finite row passes); a row past B never has a candidate
    int qn[2], thr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool valid = b0 + row0 + 8 * i < a.B;
      qn[i] = qn_s[row0 + 8 * i];
      thr[i] = valid ? kThrCap : INT_MIN;
    }
    int it = 0;
    auto release = [&](int slot) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    };

    for (int t = 0; t < tiles; ++t) {
      const int n0 = n_begin + t * kBN;
      fence_regs(acc);
      for (int c = 0; c < chunks; ++c, ++it) {
        const int s = it % stages;
        mbar_wait(&full[s], (it / stages) & 1);
        const uint8_t* stage = smem + s * kStage;
        const uint32_t q_addr = smem_u32(stage);
        const uint32_t r_addr = q_addr + kQChunk;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kKD / 32; ++ks) {
          WgmmaS8<kBN>::ss(acc, desc_k128(q_addr, 64 * wg, ks),
                           desc_k128(r_addr, 0, ks), (c | ks) != 0);
        }
        wgmma_commit();
        // One group stays in flight while the next stage is awaited,
        // unless the ring has a single stage: its slot must be free
        // before the loader can fill it again.
        if (stages == 1) {
          wgmma_wait<0>();
          fence_regs(acc);
          release(s);
        } else if (c > 0) {
          wgmma_wait<1>();
          fence_regs(acc);
          release((it - 1) % stages);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (stages > 1) release((it - 1) % stages);

      // ---- selection from the accumulators ----
      const int slot = t & 1;
      mbar_wait(&rn_full[slot], (t >> 1) & 1);
      const int* rn = rns + slot * kBN;
      {
        // Rounds: every row's lexicographic (distance, column) minimum
        // below its bound, found in the registers of the four threads
        // that hold the row; the rows that have one take it into their
        // lists, one after another, lower their bounds and poison the
        // taken accumulator; until no row has a candidate.  A tile that
        // offers nothing costs one round.
        for (;;) {
          int bv[2] = {thr[0], thr[1]}, bc[2] = {-1, -1};
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j) {
            const int2 r2 =
                *reinterpret_cast<const int2*>(rn + 8 * j + 2 * t4);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int v0 = r2.x - 2 * acc[4 * j + 2 * i];
              if (v0 < bv[i]) { bv[i] = v0; bc[i] = 8 * j + 2 * t4; }
              const int v1 = r2.y - 2 * acc[4 * j + 2 * i + 1];
              if (v1 < bv[i]) { bv[i] = v1; bc[i] = 8 * j + 2 * t4 + 1; }
            }
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int off = 1; off <= 2; off <<= 1) {
              const int ov = __shfl_xor_sync(kFull, bv[i], off);
              const int oc = __shfl_xor_sync(kFull, bc[i], off);
              if (ov < bv[i] || (ov == bv[i] && oc >= 0 && oc < bc[i])) {
                bv[i] = ov;
                bc[i] = oc;
              }
            }
          }
          const unsigned has0 = __ballot_sync(kFull, bc[0] >= 0);
          const unsigned has1 = __ballot_sync(kFull, bc[1] >= 0);
          if ((has0 | has1) == 0) break;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            unsigned hb = i == 0 ? has0 : has1;
            while (hb) {
              const int gs = (__ffs(hb) - 1) >> 2;
              hb &= ~(0xFu << (4 * gs));
              const int cc = __shfl_sync(kFull, bc[i], 4 * gs);
              const int cd = __shfl_sync(kFull, bv[i] + qn[i], 4 * gs);
              const int row = 64 * wg + 16 * warp + gs + 8 * i;
              int* ld = Ld + row * kp;
              int* li = Li + row * kp;
              if (k <= 32) {
                insert<1>(ld, li, k, cd, (n0 + cc) * F + cls, lane);
              } else {
                insert<4>(ld, li, k, cd, (n0 + cc) * F + cls, lane);
              }
              const int now = ld[k - 1];
              if (g == gs) {
                thr[i] = min(now - qn[i], kThrCap);
#pragma unroll
                for (int j = 0; j < kBN / 8; ++j) {
                  if (cc == 8 * j + 2 * t4) acc[4 * j + 2 * i] = kTaken;
                  if (cc == 8 * j + 2 * t4 + 1) acc[4 * j + 2 * i + 1] = kTaken;
                }
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&rn_empty[slot]);
    }

    for (int r = 0; r < 16; ++r) {
      const int row = 64 * wg + 16 * warp + r;
      const int b = b0 + row;
      if (b >= a.B) break;
      // The tiles put finite rows only into the lists.  A list they left
      // short takes the split's +inf rows now, in id order, as far as it
      // has room: they rank after every finite row.
      int have = 0;
      for (int i = lane; i < k; i += 32) have += Ld[row * kp + i] != kEmpty;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        have += __shfl_xor_sync(kFull, have, off);
      }
      for (int n0 = n_begin; have < k && n0 < n_end; n0 += 32) {
        const int n = n0 + lane;
        unsigned inf = __ballot_sync(
            kFull, n < n_end && isinf(a.rnorm[(size_t)n * F + cls]));
        while (inf && have < k) {
          const int src = __ffs(inf) - 1;
          inf &= inf - 1;
          if (lane == 0) {
            Ld[row * kp + have] = kDistInf;
            Li[row * kp + have] = (n0 + src) * F + cls;
          }
          ++have;
        }
      }
      __syncwarp();
      const size_t out = ((size_t)split * a.B + b) * k;
      for (int i = lane; i < k; i += 32) {
        a.cand_d[out + i] = Ld[row * kp + i];
        a.cand_i[out + i] = Li[row * kp + i];
      }
    }
  }
}

// Insert (cd, ci) into a list sorted by (distance, id): after every entry
// that is smaller in that order.  For the merge, whose lists may come in
// any id order (row classes interleave).
__device__ __forceinline__ void insert_by_id(int* ld, int* li, int k, int cd,
                                             int ci, int lane) {
  int p = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = lane + 32 * j;
    const bool before = i < k && (ld[i] < cd || (ld[i] == cd && li[i] < ci));
    p += __popc(__ballot_sync(kFull, before));
  }
#pragma unroll
  for (int j = 3; j >= 0; --j) {
    const int i = lane + 32 * j;
    int nd = cd, ni = ci;
    if (i < k && i > p) {
      nd = ld[i - 1];
      ni = li[i - 1];
    }
    __syncwarp();
    if (i < k && i >= p) {
      ld[i] = nd;
      li[i] = ni;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kMergeThreads)
l2rf_merge(const int* __restrict__ cand_d, const int* __restrict__ cand_i,
           float* __restrict__ vals, int* __restrict__ ids, int B, int k,
           int kp, int splits) {
  extern __shared__ int lists[];   // per warp: ld [kp], li [kp]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * (kMergeThreads / 32) + warp;
  if (b >= B) return;
  int* ld = lists + warp * 2 * kp;
  int* li = ld + kp;
  for (int i = lane; i < kp; i += 32) {
    ld[i] = kEmpty;
    li[i] = INT_MAX;
  }
  __syncwarp();
  // the k-th best so far, in (distance, id) order; an empty slot of a
  // split's list (kEmpty, -1) never beats it
  int tau = kEmpty, tau_id = INT_MAX;
  for (int s = 0; s < splits; ++s) {
    const size_t base = ((size_t)s * B + b) * k;
    for (int i0 = 0; i0 < k; i0 += 32) {
      const int i = i0 + lane;
      const int v = i < k ? cand_d[base + i] : kEmpty;
      const int id = i < k ? cand_i[base + i] : -1;
      auto wins = [&](int cv, int cid) {
        return cv != kEmpty && (cv < tau || (cv == tau && cid < tau_id));
      };
      unsigned bits = __ballot_sync(kFull, wins(v, id));
      if (!bits) break;   // each split's list is sorted
      while (bits) {
        const int src = __ffs(bits) - 1;
        bits &= bits - 1;
        const int cv = __shfl_sync(kFull, v, src);
        const int cid = __shfl_sync(kFull, id, src);
        if (wins(cv, cid)) {
          insert_by_id(ld, li, k, cv, cid, lane);
          tau = ld[k - 1];
          tau_id = li[k - 1];
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

// q [B, d] -> out [classes, B, qw]: copy c holds the queries shifted right
// by (c * rw) % 16 bytes, zero before and after: rows that TMA can take,
// lined up with the boxes of row class c (one copy, unshifted, without
// classes).
__global__ void l2rf_pad_queries(const int8_t* __restrict__ q,
                                 int8_t* __restrict__ out, int B, int d,
                                 int qw, int classes, int rw) {
  const size_t n = (size_t)classes * B * qw;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int y = (int)(i % qw);
    const size_t row = i / qw;
    const int c = (int)(row / B);
    const int x = y - (c * rw) % 16;
    out[i] = x >= 0 && x < d ? q[(row % B) * d + x] : (int8_t)0;
  }
}

// Raised at every launch: an attribute holds for the current device alone,
// and a process may search on more than one card.
cudaError_t set_limit() {
  return cudaFuncSetAttribute(
      l2rf_split_topk, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
}

bool tma_ok(const void* p, int row_bytes) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && row_bytes % 16 == 0;
}

int align_of(const void* p, int row_bytes) {
  for (int al = 16; al >= 4; al /= 2) {
    if (reinterpret_cast<uintptr_t>(p) % al == 0 && row_bytes % al == 0) {
      return al;
    }
  }
  return 1;
}

}  // namespace

// Shared memory of one pass-1 block with ``stages`` ring stages, in bytes
// (ops/l2_topk_rf.py::smem_bytes is its twin and picks the stages).
extern "C" int l2_topk_rf_smem(int kp, int packed, int stages) {
  return Layout(stages, kp, packed != 0).bytes;
}

// q [B, d] int8; r [N, rw] int8 (pack 1: rw = d; pack 2/4/8: planar-packed,
// rw a multiple of 128 and d <= rw * pack); rnorm [N] f32; kp = 16 for
// k <= 16, else k rounded up to 32.  classes: 1, or for pack 1 refs on a
// 16-byte base the F with 16 | F * rw and F | N (row classes, see the
// kernel); splits = ranges * classes, rows_per_split (rows of one class a
// range, a multiple of 192) with ranges * rows_per_split >= N / classes.
// ws: workspace, 256-byte aligned, of 8 * splits * B * k bytes (the
// splits' lists: distances, then ids) rounded up to 256, plus
// B * round_up(d, 16) bytes when the queries' rows are not 16-byte aligned
// and strided, or classes * B * round_up(d + 15, 16) bytes with classes;
// vals [B, k] f32, ids [B, k] int32.  Returns the CUDA error
// code of the launches (0 on success; cudaErrorInvalidValue also when
// a tensor map cannot be encoded or the stages do not fit shared memory).
extern "C" int l2_topk_rf_s8(const void* q, const void* r, const void* rnorm,
                             void* ws, void* vals, void* ids, int B, int N,
                             int d, int rw, int pack, int classes, int k,
                             int kp, int splits, int rows_per_split,
                             int stages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stages < 1 || stages > kMaxStages || rows_per_split % kBN != 0 ||
      classes < 1 || splits % classes != 0 ||
      Layout(stages, kp, pack > 1).bytes > kSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  if (classes > 1 && (pack != 1 || N % classes != 0 ||
                      !tma_ok(r, classes * rw))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = set_limit();
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.r = static_cast<const int8_t*>(r);
  a.rnorm = static_cast<const float*>(rnorm);
  a.cand_d = static_cast<int*>(ws);
  a.cand_i = a.cand_d + (size_t)splits * B * k;
  a.B = B; a.N = N; a.d = d; a.rw = rw; a.pack = pack; a.k = k; a.kp = kp;
  a.classes = classes;
  a.rows_per_split = rows_per_split; a.stages = stages;
  a.r_tma = tma_ok(r, classes * rw);
  a.r_align = align_of(r, rw);
  if (N > 0) {
    a.q = static_cast<const int8_t*>(q);
    a.q_bytes = d;
    if (classes > 1 || !tma_ok(q, d)) {
      const size_t lists = ((size_t)8 * splits * B * k + 255) / 256 * 256;
      a.q_bytes = (d + (classes > 1 ? 15 : 0) + 15) / 16 * 16;
      int8_t* padded = static_cast<int8_t*>(ws) + lists;
      const size_t want = ((size_t)classes * B * a.q_bytes + 255) / 256;
      const int blocks = want < 2048 ? (int)want : 2048;
      l2rf_pad_queries<<<blocks, 256, 0, s>>>(a.q, padded, B, d, a.q_bytes,
                                              classes, rw);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      a.q = padded;
    }
    CUtensorMap tm_q, tm_r;
    if (!make_map_2d(&tm_q, a.q, false, (uint64_t)classes * B, a.q_bytes,
                     a.q_bytes, kBQ)) {
      return (int)cudaErrorInvalidValue;
    }
    if (a.r_tma) {
      // [N / classes, classes * rw]: the matrix itself when classes is 1
      if (!make_map_2d(&tm_r, r, false, N / classes, (uint64_t)classes * rw,
                       (uint64_t)classes * rw, kBN)) {
        return (int)cudaErrorInvalidValue;
      }
    } else {
      tm_r = tm_q;   // never used
    }
    const dim3 grid1((B + kBQ - 1) / kBQ, splits);
    l2rf_split_topk<<<grid1, kThreads, Layout(stages, kp, pack > 1).bytes,
                      s>>>(tm_q, tm_r, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  } else {
    splits = 0;   // no row: every slot reads (+inf, -1)
  }
  const int warps = kMergeThreads / 32;
  l2rf_merge<<<(B + warps - 1) / warps, kMergeThreads,
               warps * 2 * kp * (int)sizeof(int), s>>>(
      a.cand_d, a.cand_i, static_cast<float*>(vals), static_cast<int*>(ids),
      B, k, kp, splits);
  return (int)cudaGetLastError();
}
