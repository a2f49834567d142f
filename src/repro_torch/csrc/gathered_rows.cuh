// Gathering row sources of stream_gram.cuh (see its contract): staged rows
// are rows of a table, picked per reducer slot by an (R, L) index and mask.
//   * GatheredRows (fused_gather_gram.cu): one table, square blocks.
//   * GatheredPairRows (fused_gather_gram_rect.cu): two tables with their
//     own index, mask and width, rectangular blocks.
// Both look an item's rows up once into the shared table and then stream
// the rows' 16-byte vectors from table + row * d + k through the ring.  A
// masked slot stages zeros (a zero-byte cp.async: no read), so its entries
// are the plain version's products with a zero row.  A valid slot whose
// index lies outside its table stages NaN (a shared store, no read), so
// the entries it touches come out NaN, not silently zero.
// Rows whose byte length or base is not a multiple of 16 (fp32 d = 33,
// bf16 d = 100) take element loads in the same ring; each side has its own
// flag, since a row slice of one table may be aligned on one side only.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_gram.cuh"

namespace gathered_rows {

using stream_gram::CB;
using stream_gram::Grid;
using stream_gram::group;
using stream_gram::ROWS;
using stream_gram::RS;

// Zero and NaN of the table's type.
template <typename Tin>
__device__ __forceinline__ Tin fill(bool nan);
template <>
__device__ __forceinline__ float fill<float>(bool nan) {
  return nan ? __int_as_float(0x7fc00000) : 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 fill<__nv_bfloat16>(bool nan) {
  return __ushort_as_bfloat16(nan ? 0x7fc0 : 0);
}

// The table row of slot `o` (flat index into idx / mask) of a table with m
// rows: >= 0 a row, -1 none (a masked slot), -2 NaN (a valid slot outside
// the table).
__device__ __forceinline__ int gathered_row(const int32_t* idx,
                                            const uint8_t* mask, int m,
                                            long long o) {
  if (!mask[o]) return -1;
  const int row = idx[o];
  return (row >= 0 && row < m) ? row : -2;
}

// The table row of (reducer r, slot) of an (R, L) index and mask:
// gathered_row's codes, -1 also for a slot past L or a reducer past R.
__device__ __forceinline__ int source_row(const int32_t* idx,
                                          const uint8_t* mask, int m,
                                          long long R, int L, long long r,
                                          int slot) {
  if (r >= R || slot >= L) return -1;
  return gathered_row(idx, mask, m, r * L + slot);
}

// Stage chunk `kc` of the `rows` rows listed in `table` (gathered_row
// codes) from the (m, K) table `x` into `stage`: -1 rows are zeros.
template <typename Tin>
__device__ __forceinline__ void stage_rows(unsigned char* stage,
                                           const int* table, int rows,
                                           const void* x, int K, int vec,
                                           int kc) {
  constexpr int VE = 16 / sizeof(Tin);         // elements per vector
  constexpr int KC = CB / sizeof(Tin);         // elements per chunk
  const int k0 = kc * KC;
  const Tin* xt = static_cast<const Tin*>(x);
  if (vec) {
    for (int e = threadIdx.x; e < rows * (CB / 16); e += blockDim.x) {
      const int row = e / (CB / 16), v = e % (CB / 16);
      const int from = table[row];
      const int k = k0 + v * VE;
      unsigned char* dst = stage + row * RS + v * 16;
      if (from == -2) {
        const Tin f = fill<Tin>(k < K);
        Tin* d = reinterpret_cast<Tin*>(dst);
#pragma unroll
        for (int u = 0; u < VE; ++u) d[u] = f;
      } else {
        const bool ok = from >= 0 && k < K;
        cp_async16(dst, ok ? xt + static_cast<long long>(from) * K + k : xt,
                   ok ? 16 : 0);
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * KC; e += blockDim.x) {
      const int row = e / KC, c = e % KC;
      const int from = table[row];
      const int k = k0 + c;
      Tin v = fill<Tin>(from == -2 && k < K);
      if (from >= 0 && k < K) v = xt[static_cast<long long>(from) * K + k];
      reinterpret_cast<Tin*>(stage + row * RS)[c] = v;
    }
  }
}

// Square source: staged row s of side `side` of reducer r is table row
// idx[r, slot] for slot (it or jt) * T + s % T.
struct GatheredRows {
  static constexpr bool kTable = true;
  const void* x;            // (m, d) table
  const int32_t* idx;       // (R, L)
  const uint8_t* mask;      // (R, L)
  int m;
  int vec;                  // rows and base on 16-byte boundaries

  template <int TM, int TN>
  __host__ __device__ static constexpr int table_ints() { return 2 * ROWS; }

  // Fill `table` with the table row of each staged row of item `item`:
  // side 0 then, when `two_sides`, side 1.
  template <int TM, int TN>
  __device__ __forceinline__ void lookup(const Grid& a, int* table,
                                         long long item, int it, int jt,
                                         bool two_sides) const {
    static_assert(TM == TN, "square tiles");
    constexpr int T = TM;
    constexpr int G = ROWS / T;
    const long long r0 = (item / a.pairs) * G;
    for (int row = threadIdx.x; row < (two_sides ? 2 : 1) * ROWS;
         row += blockDim.x) {
      const int side = row / ROWS, s = row % ROWS;
      table[row] = source_row(idx, mask, m, a.R, a.M, r0 + s / T,
                              (side ? jt : it) * T + s % T);
    }
  }

  // Stage chunk `kc` of the rows listed in `table` into `stage`.
  template <typename Tin, int TM, int TN>
  __device__ __forceinline__ void load(const Grid& a, unsigned char* stage,
                                       const int* table, long long, int, int,
                                       int kc, bool two_sides) const {
    stage_rows<Tin>(stage, table, (two_sides ? 2 : 1) * ROWS, x, a.K, vec,
                    kc);
  }
};

// Rectangular source: side 0 gathers X by xidx / xmask (R, M), side 1 Y by
// yidx / ymask (R, N).  Staged row p of a side's tile t of reducer r is the
// table row of slot t * T + p, T the side's tile width.
struct GatheredPairRows {
  static constexpr bool kTable = true;
  const void* x;            // (mx, d) X table
  const void* y;            // (my, d) Y table
  const int32_t* xidx;      // (R, M)
  const uint8_t* xmask;
  const int32_t* yidx;      // (R, N)
  const uint8_t* ymask;
  int mx, my;
  int vecx, vecy;           // each side's rows and base on 16 bytes

  template <int TM, int TN>
  __host__ __device__ static constexpr int table_ints() {
    return group<TM, TN>() * (TM + TN);
  }

  // Fill `table` with the table row of each staged row of item `item`.
  template <int TM, int TN>
  __device__ __forceinline__ void lookup(const Grid& a, int* table,
                                         long long item, int it, int jt,
                                         bool) const {
    constexpr int G = group<TM, TN>(), A = G * TM;
    const long long r0 = (item / a.pairs) * G;
    for (int e = threadIdx.x; e < G * (TM + TN); e += blockDim.x) {
      const int side = e >= A;
      const int T = side ? TN : TM;
      const int s = side ? e - A : e;
      table[e] = source_row(side ? yidx : xidx, side ? ymask : xmask,
                            side ? my : mx, a.R, side ? a.N : a.M,
                            r0 + s / T, (side ? jt : it) * T + s % T);
    }
  }

  // Stage chunk `kc` of the rows listed in `table`: side 0 from x, side 1
  // from y.
  template <typename Tin, int TM, int TN>
  __device__ __forceinline__ void load(const Grid& a, unsigned char* stage,
                                       const int* table, long long, int, int,
                                       int kc, bool) const {
    constexpr int A = group<TM, TN>() * TM, B = group<TM, TN>() * TN;
    stage_rows<Tin>(stage, table, A, x, a.K, vecx, kc);
    stage_rows<Tin>(stage + A * RS, table + A, B, y, a.K, vecy, kc);
  }
};

}  // namespace gathered_rows
