// Streaming register-tile Gram blocks for Hopper (sm_90a), shared by
// pairwise_gram.cu (the rows of a batch of blocks), fused_gather_gram.cu
// (rows gathered from one table) and fused_gather_gram_rect.cu (rows
// gathered from two tables).  For every reducer r of a launch
//
//     out[r] = A[r] . B[r]^T           (M, N) fp32, A (M, K), B (N, K)
//
// where a row source policy says where each staged row of A and B comes
// from.  The design:
//   * Tiles are TM x TN (1 .. 32 each from the widths, independent; wider
//     sides take several tiles).  A block owns G = 128 / max(TM, TN)
//     reducers of one tile pair (it, jt) and stages G * TM rows of A and
//     G * TN rows of B per chunk.  The grid is persistent: a block walks
//     its items (reducer group, tile pair) with a grid stride.
//   * Rows arrive as 16-byte cp.async vectors, 128 bytes of K per row and
//     chunk, through a STAGES-deep ring sized to the rows staged, so the
//     next chunk is in flight while one is multiplied; the ring runs across
//     items, so the next item's rows load under this one's last products.
//   * Register tiles: each thread owns RM x RN outputs (rows and columns
//     strided by the (TM/RM) x (TN/RN) thread grid), so one 16-byte
//     shared-memory load feeds RN (or RM) FMAs per element, on a row stride
//     of 144 bytes (an odd number of 16-byte units: a quarter-warp's loads
//     fall on distinct banks).  bf16 rows are widened to fp32 as they are
//     read; fp32 FMA, no TF32, so bf16 products are exact in fp32.
//   * Symmetry (Grid::self: B's rows are A's rows, M == N, TM == TN only):
//     only the tile pairs it <= jt are items; a diagonal pair stages one
//     side, an off-diagonal pair writes its mirror too.  With one tile per
//     side only the thread tiles on or above the diagonal multiply, each
//     storing its outputs twice.  Every (M, N) entry is written.
//
// A row source policy `Src` gives
//   static constexpr bool kTable: it looks an item's rows up once, at the
//     item's first chunk, into a shared table of table_ints<TM, TN>() ints
//     per stage;
//   template <int TM, int TN> static constexpr int table_ints();
//   template <int TM, int TN> __device__ void lookup(const Grid&, int*
//     table, long long item, int it, int jt, bool two_sides) const (only
//     when kTable; every thread calls it);
//   template <typename Tin, int TM, int TN> __device__ void load(const
//     Grid&, unsigned char* stage, const int* table, long long item, int
//     it, int jt, int kc, bool two_sides) const: stage chunk kc of the
//     item's rows (side 0 at rows [0, G TM), side 1 at [G TM, G (TM + TN)))
//     at stride RS.  Every tile position is multiplied and every product
//     inside (M, N) stored, so a position with no row of A or B (a masked
//     slot, a slot past M or N, a reducer past R) is staged as zeros.
//
// An epilogue policy `Epi` says what an item's last chunk stores; with
// kDiag and kNorms both false (Identity, the default) it stores the
// products:
//   static constexpr bool kDiag: true finishes them first, from the
//     block's own diagonal, and then needs a one-tile self-Gram (self,
//     M == N <= TM == TN, RM == RN; the caller's promise), so that reducer
//     r's diagonal lies in the item.  After a barrier the threads put their
//     products (and mirrors) into the stage they have just multiplied, as
//     G padded T x T tiles, and the ones that hold the diagonal put each
//     slot i's epi.norm(g_ii), or -1 where epi.live(r, i, M) is false,
//     beside them; after a second barrier every thread of the block (the
//     spare ones that only stage rows included) finishes entries in the
//     order of the output, so that the group's blocks, one contiguous
//     range, are stored coalesced: epi.finish(g_ij, norm_i, norm_j) where
//     both slots are live, else +0.
//   static constexpr bool kNorms: true finishes a one-tile cross block
//     (not self, M <= TM, N <= TN; the caller's promise) from norms held
//     outside it: a cross block has no diagonal.  It takes a kTable source
//     whose table lists the item's G * TM rows of A and then its G * TN
//     rows of B as gathered_rows' codes (a row of the table, -1 for no row,
//     -2 for a valid slot outside the table), which the source's last load
//     of the item has done reading.  After a barrier each table entry is
//     turned, in place, into its slot's epi.norm(side, code), -1 where the
//     slot is not live, and the products go into the stage just
//     multiplied as G padded TM x TN tiles; after a second barrier every
//     thread of the block finishes entries in the order of the output, as
//     kDiag does: with one tile a side the group's G blocks of M N floats
//     are one contiguous range, stored coalesced.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace stream_gram {

constexpr int ROWS = 128;          // staged rows per block on the wider side
constexpr int CB = 128;            // bytes of K per row and chunk
constexpr int RS = CB + 16;        // staged row stride in bytes
constexpr int STAGES = 2;          // depth of the cp.async ring

struct Grid {
  float* out;           // (R, M, N)
  long long R;          // reducers
  int M, N, K;          // rows of A, rows of B, their width
  int self;             // B's rows are A's rows (M == N)
  int n_tm, n_tn;       // tiles along i and j
  int pairs;            // tile pairs per reducer group
  long long items;      // reducer groups x tile pairs
};

// The epilogue that stores the products as they are.
struct Identity {
  static constexpr bool kDiag = false;
  static constexpr bool kNorms = false;
};

// Reducers per block for tiles TM x TN.
template <int TM, int TN>
__host__ __device__ constexpr int group() {
  return ROWS / (TM > TN ? TM : TN);
}

// The launch's schedule for tiles TM x TN.
template <int TM, int TN = TM>
Grid schedule(float* out, long long R, int M, int N, int K, bool self) {
  constexpr int G = group<TM, TN>();
  Grid g{};
  g.out = out;
  g.R = R;
  g.M = M;
  g.N = N;
  g.K = K;
  g.self = self;
  g.n_tm = (M + TM - 1) / TM;
  g.n_tn = (N + TN - 1) / TN;
  g.pairs = self ? g.n_tm * (g.n_tm + 1) / 2 : g.n_tm * g.n_tn;
  g.items = (R + G - 1) / G * g.pairs;
  return g;
}

// Tile pair of item `item`: row by row over all pairs, or over the upper
// triangle it <= jt when the block is a self-Gram.
__device__ __forceinline__ void tile_pair(const Grid& g, long long item,
                                          int& it, int& jt) {
  int k = static_cast<int>(item % g.pairs);
  if (!g.self) {
    it = k / g.n_tn;
    jt = k % g.n_tn;
    return;
  }
  it = 0;
  while (k >= g.n_tm - it) {
    k -= g.n_tm - it;
    ++it;
  }
  jt = it + k;
}

// Four or eight consecutive K elements of a staged row as fp32.
__device__ __forceinline__ void widen(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void widen(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = __uint_as_float(w[e] << 16);
    v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

// Shared memory of a `kDiag` epilogue, after the row tables: each staged
// slot's norm.
template <typename Epi, int TM>
__host__ __device__ constexpr int diag_bytes() {
  return Epi::kDiag ? group<TM, TM>() * TM * sizeof(float) : 0;
}

// Shared memory of one launch: the ring, the row tables of a `kTable`
// source and the diagonal of a `kDiag` epilogue.
template <typename Src, int TM, int TN, typename Epi = Identity>
int smem_bytes(const Grid& g) {
  constexpr int G = group<TM, TN>();
  const bool one_side = g.self && g.n_tm == 1;
  return STAGES * ((one_side ? G * TM : G * TM + G * TN) * RS +
                   Src::template table_ints<TM, TN>() *
                       static_cast<int>(sizeof(int))) +
         diag_bytes<Epi, TM>();
}

// The body of a kernel: block = G * (TM/RM) * (TN/RN) threads, grid-stride
// over g.items, smem_bytes<Src, TM, TN, Epi>(g) of dynamic shared memory at
// `smem`.
template <typename Tin, int TM, int TN, int RM, int RN, typename Src,
          typename Epi = Identity>
__device__ __forceinline__ void run(const Grid& a, const Src& src,
                                    unsigned char* smem,
                                    const Epi& epi = Epi()) {
  constexpr int G = group<TM, TN>();
  constexpr int TI = TM / RM, TJ = TN / RN;      // thread grid of one tile
  constexpr int VE = 16 / sizeof(Tin);
  constexpr int KC = CB / sizeof(Tin);
  constexpr int TABLE = Src::template table_ints<TM, TN>();

  // one side staged when A's rows are B's rows: self-Gram, one tile
  const bool one_side = a.self && a.n_tm == 1;
  const int stage_bytes = (one_side ? G * TM : G * TM + G * TN) * RS;
  const int n_chunks = (a.K + KC - 1) / KC;
  const long long my_items =
      a.items > blockIdx.x ? (a.items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long steps = my_items * n_chunks;

  // Thread t owns outputs (ti + TI i, tj + TJ j) of reducer g's tile.  One
  // staged side means out[r] is symmetric: only the pairs ti <= tj are
  // computed, each also stored mirrored, and the spare threads (whole
  // warps, mostly) only stage rows.
  const int t = threadIdx.x;
  int g = t / (TI * TJ), ti = (t / TJ) % TI, tj = t % TJ;
  if constexpr (TI == TJ) {
    constexpr int PAIRS = TI * (TI + 1) / 2;
    if (one_side) {
      g = t / PAIRS;
      int u = t % PAIRS;
      for (ti = 0; u >= TI - ti; ++ti) u -= TI - ti;
      tj = ti + u;
    }
  }
  const bool active = g < G;

  // A table source looks each item's rows up once, by its first chunk's
  // load, into one of STAGES tables (the loads in flight span at most
  // STAGES items); the barrier publishes them to every loading thread.
  int* tables = reinterpret_cast<int*>(smem + STAGES * stage_bytes);
  auto load = [&](long long s) {
    if (s < steps) {
      const long long item = blockIdx.x + (s / n_chunks) * gridDim.x;
      int it, jt;
      tile_pair(a, item, it, jt);
      const bool two_sides = !(a.self && it == jt);
      int* table = tables + ((s / n_chunks) % STAGES) * TABLE;
      const int kc = static_cast<int>(s % n_chunks);
      if constexpr (Src::kTable) {
        if (kc == 0) {
          src.template lookup<TM, TN>(a, table, item, it, jt, two_sides);
          __syncthreads();
        }
      }
      src.template load<Tin, TM, TN>(a, smem + (s % STAGES) * stage_bytes,
                                     table, item, it, jt, kc, two_sides);
    }
    cp_async_commit();              // empty groups keep the count uniform
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (long long s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                // chunk s landed; chunk s-1 consumed
    load(s + STAGES - 1);

    const long long item = blockIdx.x + (s / n_chunks) * gridDim.x;
    int it, jt;
    tile_pair(a, item, it, jt);
    const unsigned char* st = smem + (s % STAGES) * stage_bytes;
    // B's rows: the A rows themselves on a diagonal self-Gram pair
    const bool shared = a.self && it == jt;
    const unsigned char* sa = st + (g * TM) * RS;
    const unsigned char* sb = st + ((shared ? 0 : G * TM) + g * TN) * RS;
#pragma unroll
    for (int k = 0; k < KC && active; k += VE) {
      float av[RM][VE], bv[RN][VE];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        widen(reinterpret_cast<const Tin*>(sa + (ti + TI * i) * RS) + k,
              av[i]);
#pragma unroll
      for (int j = 0; j < RN; ++j)
        widen(reinterpret_cast<const Tin*>(sb + (tj + TJ * j) * RS) + k,
              bv[j]);
#pragma unroll
      for (int e = 0; e < VE; ++e)
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j)
            acc[i][j] = fmaf(av[i][e], bv[j][e], acc[i][j]);
    }

    if (s % n_chunks == n_chunks - 1) {     // the item's last chunk
      const long long r0 = (item / a.pairs) * G, r = r0 + g;
      if constexpr (Epi::kDiag) {
        static_assert(TM == TN && RM == RN, "a diagonal needs square tiles");
        static_assert((TM + 1) * sizeof(float) <= RS,
                      "a stage holds the group's padded tiles");
        constexpr int T = TM, TP = TM + 1;    // tile row stride, padded
        // the group's products go through this step's stage, which every
        // warp is done reading after the barrier, as G padded T x T tiles
        float* tile = reinterpret_cast<float*>(smem + (s % STAGES) *
                                               stage_bytes);
        // a slot's norm, or -1 where it is not live: a norm is never
        // negative (NaN for a slot outside the table, which is live)
        float* norm = reinterpret_cast<float*>(smem + STAGES * stage_bytes +
                                               STAGES * TABLE * sizeof(int));
        __syncthreads();
        if (active) {
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const int row = ti + TI * i;
#pragma unroll
            for (int j = 0; j < RN; ++j) {
              const int col = tj + TJ * j;
              tile[(g * T + row) * TP + col] = acc[i][j];
              if (ti != tj) tile[(g * T + col) * TP + row] = acc[i][j];
            }
            if (ti == tj && row < a.M && r < a.R)
              norm[g * T + row] =
                  epi.live(r, row, a.M) ? epi.norm(acc[i][i]) : -1.f;
          }
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
        __syncthreads();                    // every thread, spare ones too
        // every thread finishes entries in the order of the output, so
        // the group's blocks (one contiguous range) are stored coalesced
        const int L = a.M;
        float* o = a.out + r0 * L * static_cast<long long>(L);
        for (int e = threadIdx.x; e < G * T * T; e += blockDim.x) {
          const int gg = e / (T * T), row = e / T % T, col = e % T;
          if (row < L && col < L && r0 + gg < a.R) {
            const float nu = norm[gg * T + row], nv = norm[gg * T + col];
            o[(gg * L + row) * L + col] =
                nu < 0.f || nv < 0.f
                    ? 0.f
                    : epi.finish(tile[(gg * T + row) * TP + col], nu, nv);
          }
        }
      } else if constexpr (Epi::kNorms) {
        static_assert(Src::kTable, "the norms are read through the table");
        static_assert(TABLE >= G * (TM + TN), "a table entry a slot");
        static_assert(G * TM * (TN + 1) * sizeof(float) <=
                          G * (TM + TN) * RS,
                      "a stage holds the group's padded tiles");
        constexpr int TP = TN + 1;            // tile row stride, padded
        float* tile = reinterpret_cast<float*>(smem + (s % STAGES) *
                                               stage_bytes);
        // the item's row table, each entry turned into its slot's norm
        int* table = tables + ((s / n_chunks) % STAGES) * TABLE;
        float* norm = reinterpret_cast<float*>(table);
        __syncthreads();
        for (int e = threadIdx.x; e < G * (TM + TN); e += blockDim.x)
          norm[e] = epi.norm(e >= G * TM, table[e]);
        if (active) {
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j)
              tile[(g * TM + ti + TI * i) * TP + tj + TJ * j] = acc[i][j];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
        __syncthreads();                    // every thread, spare ones too
        const int M = a.M, N = a.N;
        float* o = a.out + r0 * M * static_cast<long long>(N);
        for (int e = threadIdx.x; e < G * TM * TN; e += blockDim.x) {
          const int gg = e / (TM * TN), row = e / TN % TM, col = e % TN;
          if (row < M && col < N && r0 + gg < a.R) {
            const float nu = norm[gg * TM + row];
            const float nv = norm[G * TM + gg * TN + col];
            o[(gg * M + row) * N + col] =
                nu < 0.f || nv < 0.f
                    ? 0.f
                    : epi.finish(tile[(gg * TM + row) * TP + col], nu, nv);
          }
        }
      } else if (active && r < a.R) {
        float* o = a.out + r * a.M * static_cast<long long>(a.N);
        // mirrored: the thread pairs ti < tj of a one-tile self-Gram,
        // every entry of an off-diagonal self-Gram tile pair
        const bool mirror = a.self && (one_side ? ti != tj : it != jt);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int row = it * TM + ti + TI * i;
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const int col = jt * TN + tj + TJ * j;
            if (row < a.M && col < a.N) {
              o[static_cast<long long>(row) * a.N + col] = acc[i][j];
              if (mirror)
                o[static_cast<long long>(col) * a.N + row] = acc[i][j];
            }
            acc[i][j] = 0.f;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
}

// The persistent grid of `kernel` with `threads` threads and `shmem` bytes
// of shared memory a block: as many blocks as fit on the card at once, at
// most one per item.
template <typename Kernel>
cudaError_t persistent_blocks(Kernel* kernel, const Grid& g, int threads,
                              int shmem, unsigned& blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, shmem);
  if (err != cudaSuccess) return err;
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  blocks = static_cast<unsigned>(g.items < resident ? g.items : resident);
  return cudaSuccess;
}

// Launch `kernel` (a __global__ wrapper of run<Tin, TM, TN, RM, RN, Src>)
// on a persistent grid.
template <int TM, int TN, int RM, int RN, typename Src>
cudaError_t launch(void (*kernel)(Grid, Src), const Grid& g, const Src& src,
                   cudaStream_t stream) {
  constexpr int threads = group<TM, TN>() * (TM / RM) * (TN / RN);
  static_assert(threads <= 256, "the kernels are bounded at 256 threads");
  if (g.self && TM != TN) return cudaErrorInvalidValue;
  const int shmem = smem_bytes<Src, TM, TN>(g);
  unsigned blocks = 0;
  cudaError_t err = persistent_blocks(kernel, g, threads, shmem, blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, shmem, stream>>>(g, src);
  return cudaGetLastError();
}

// Launch `kernel` (a __global__ wrapper of run<Tin, TM, TN, RM, RN, Src,
// Epi>) on a persistent grid.  A `kDiag` epilogue takes a one-tile
// self-Gram only, a `kNorms` one a one-tile cross block.
template <int TM, int TN, int RM, int RN, typename Src, typename Epi>
cudaError_t launch(void (*kernel)(Grid, Src, Epi), const Grid& g,
                   const Src& src, const Epi& epi, cudaStream_t stream) {
  constexpr int threads = group<TM, TN>() * (TM / RM) * (TN / RN);
  static_assert(threads <= 256, "the kernels are bounded at 256 threads");
  if (g.self && TM != TN) return cudaErrorInvalidValue;
  if (Epi::kDiag && !(g.self && g.n_tm == 1)) return cudaErrorInvalidValue;
  if (Epi::kNorms && !(!g.self && g.n_tm == 1 && g.n_tn == 1))
    return cudaErrorInvalidValue;
  const int shmem = smem_bytes<Src, TM, TN, Epi>(g);
  unsigned blocks = 0;
  cudaError_t err = persistent_blocks(kernel, g, threads, shmem, blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, shmem, stream>>>(g, src, epi);
  return cudaGetLastError();
}

}  // namespace stream_gram
