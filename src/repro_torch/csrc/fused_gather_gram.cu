// Fused gather + Gram for Hopper (sm_90a): the map->reduce shuffle streams
// straight into each reducer's all-pairs block.
//
// Replaces the Pallas TPU kernel `fused_gather_gram` / `_fused_kernel` in
// src/repro/kernels/pairwise/fused_gather_gram.py (pallas_call at :145).
// For every reducer r of one capacity bucket:
//
//     out[r] = X[idx_r] . X[idx_r]^T            (L, L) fp32
//
// with masked slots zeroed at gather time, so padding slots (which point at
// input 0) and all-masked padding rows give zero entries; or, with a metric
// (dot, cosine, l2), those blocks finished into similarities in the
// kernel's epilogue (below).  The kernel never
// reads outside the table: a valid slot whose index lies outside [0, m)
// stages NaN, so the entries it touches come out NaN, not silently zero
// (the executors reject such plans on the host before launching).  The
// gathered (R, L, d) block is never written to device memory: rows go from
// the table straight into shared memory.
//
// Bound on an H100 SXM at the main path's shape (m=4096, d=256, Zipf plan:
// buckets of width 4/8/16/32 with 115,976,064 Gram entries in all):
//   * operations: the block is symmetric, so only the products i <= j are
//     needed, L (L + 1) / 2 dot products of d multiply-adds per reducer:
//     at most 3.1e10 FLOP (every slot valid), 0.47 ms in fp32 on CUDA
//     cores (67 TFLOP/s), so fp32 is bound by operations.
//   * bytes: the (R, L, L) fp32 output is 464 MB, written once: 0.14 ms at
//     3.35 TB/s; the table (4 MiB) and idx/mask (~33 MB) are read once each.
//   (Only valid pairs need the product; chip_smoke.py states the bound for
//   the data it runs.)  The gather itself is an L2 stream: every staged row
//   is one read of d elements from the table, which stays in the 50 MB L2,
//   about 5 GB per fp32 request by the plan (modelled, not measured).  That
//   stream, not device memory, is the floor in practice.
//
// Design: stream_gram.cuh's streaming register-tile Gram (a persistent
// grid over (reducer group, tile pair it <= jt) items, a cp.async ring of
// 16-byte vectors, RM x RN register tiles, symmetric blocks) with a gather
// as its row source (GatheredRows, gathered_rows.cuh):
//   * The first chunk's load of an item reads the mask and index of each
//     of its staged rows into a shared table; then every chunk streams the
//     rows' 16-byte vectors from x + idx * d + k through the ring.
//   * A masked slot is a cp.async of 0 bytes (zeros); a valid slot outside
//     the table is a shared-memory store of NaN.  Rows whose byte length
//     or base is not a multiple of 16 (fp32 d = 33, bf16 d = 100) take
//     element loads in the same ring.
//   * Register tiles RM x RN = 4 x 4 (2 x 2 at T = 4, 8; 1 x 1 at T = 1, 2).
//   * The metric finish is the epilogue (Finish below, a `kDiag` policy of
//     stream_gram.cuh) where a block is one tile a side, L <= 32: every
//     slot's squared norm is the block's own diagonal, and each entry is
//     stored finished, exactly as the torch finish (finish_fused_blocks)
//     computes it from the raw block: cosine g / (sqrt(n2_i + 1e-9)
//     sqrt(n2_j + 1e-9)), l2 (n2_i + n2_j) - 2 g, dot g, and +0 where
//     either slot is masked, in IEEE fp32 with the roundings spelled out
//     (__fadd_rn and the like: nothing contracted).  A valid slot outside
//     the table still makes its row and column NaN.  The products pass
//     through the stage just multiplied (G padded T x T tiles and G x T
//     norms, two barriers), so that all the block's threads finish them and
//     store the group's blocks coalesced: on the m=8192 request's buckets
//     the kernel takes 12.58 ms finished against 11.88 raw, where the
//     threads that own the products finishing and storing them in place
//     took 13.42 (H100, PERF.md).  The caller passes `out` as its slice of
//     the one vector the assembly gathers from, so the finished blocks are
//     written once and never copied.  Wider buckets have their diagonal in
//     other items: they store the raw products, and the caller finishes
//     them in torch.
// Tried on an H100 and dropped: a 3- or 4-stage ring (fewer blocks fit on
// an SM), 64 staged rows per block and 64-byte chunks were all slower at
// the m=4096 request; a copy with the FMAs taken out gained about as much
// as the 2-stage ring, so the buckets are bound by the gather and the
// staging, not by their multiplies.  Times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gathered_rows.cuh"

namespace {

using gathered_rows::GatheredRows;
using stream_gram::Grid;

// What a launch stores (the `metric` of the C entry point).
enum Metric { RAW = 0, DOT = 1, COSINE = 2, L2 = 3 };
constexpr int FINISH_MAX_L = 32;    // one tile a side: the diagonal at hand

// The metric epilogue: the similarity of each entry from its raw product g
// and its slots' squared norms (the block's diagonal), +0 for a pair with
// a masked slot.
struct Finish {
  static constexpr bool kDiag = true;
  static constexpr bool kNorms = false;
  const uint8_t* mask;      // (R, L)
  int metric;               // DOT, COSINE or L2

  // What the exchange holds for a slot: the norm sqrt(n2 + 1e-9) for
  // cosine, the squared norm itself for l2 (dot reads none).
  __device__ __forceinline__ float norm(float n2) const {
    return metric == COSINE ? __fsqrt_rn(__fadd_rn(n2, 1e-9f)) : n2;
  }
  __device__ __forceinline__ bool live(long long r, int slot, int L) const {
    return mask[r * L + slot] != 0;
  }
  __device__ __forceinline__ float finish(float g, float ni, float nj) const {
    if (metric == COSINE) return __fdiv_rn(g, __fmul_rn(ni, nj));
    if (metric == L2) return __fsub_rn(__fadd_rn(ni, nj), __fmul_rn(2.f, g));
    return g;
  }
};

// block = G * (T/RM) * (T/RN) threads; grid-stride over the items.
template <typename Tin, int T, int RM, int RN, typename Epi>
__global__ void __launch_bounds__(256)
    fused_gather_gram_kernel(const Grid g, const GatheredRows src,
                             const Epi epi) {
  extern __shared__ __align__(16) unsigned char smem[];
  stream_gram::run<Tin, T, T, RM, RN>(g, src, smem, epi);
}

template <typename Tin, int T, int RM, int RN, typename Epi>
cudaError_t launch(float* out, long long R, int L, int d,
                   const GatheredRows& rows, const Epi& epi,
                   cudaStream_t stream) {
  const Grid g = stream_gram::schedule<T>(out, R, L, L, d, true);
  return stream_gram::launch<T, T, RM, RN>(
      fused_gather_gram_kernel<Tin, T, RM, RN, Epi>, g, rows, epi, stream);
}

template <typename Tin, typename Epi>
cudaError_t dispatch(float* out, long long R, int L, int d,
                     const GatheredRows& rows, const Epi& e,
                     cudaStream_t s) {
  if (L <= 1) return launch<Tin, 1, 1, 1>(out, R, L, d, rows, e, s);
  if (L <= 2) return launch<Tin, 2, 1, 1>(out, R, L, d, rows, e, s);
  if (L <= 4) return launch<Tin, 4, 2, 2>(out, R, L, d, rows, e, s);
  if (L <= 8) return launch<Tin, 8, 2, 2>(out, R, L, d, rows, e, s);
  if (L <= 16) return launch<Tin, 16, 4, 4>(out, R, L, d, rows, e, s);
  return launch<Tin, 32, 4, 4>(out, R, L, d, rows, e, s);
}

template <typename Tin>
cudaError_t by_metric(float* out, long long R, int L, int d,
                      const GatheredRows& rows, int metric,
                      cudaStream_t s) {
  if (metric == RAW)
    return dispatch<Tin>(out, R, L, d, rows, stream_gram::Identity{}, s);
  return dispatch<Tin>(out, R, L, d, rows, Finish{rows.mask, metric}, s);
}

}  // namespace

extern "C" {

// x (m, d) fp32 (is_bf16 == 0) or bf16 (is_bf16 == 1); idx (R, L) int32;
// mask (R, L) uint8; out (R, L, L) fp32, the raw blocks (metric 0) or their
// dot (1), cosine (2) or l2 (3) similarities, which take L <= 32.  All
// contiguous (out 4-byte aligned), on the device of `stream`.  Returns the
// cudaError_t of the launch (0 on success).
int fused_gather_gram_launch(const void* x, int is_bf16, const void* idx,
                             const void* mask, void* out, long long R, int L,
                             int d, int m, int metric, void* stream) {
  if (R <= 0) return 0;
  if (L <= 0 || d <= 0 || m <= 0 || metric < RAW || metric > L2 ||
      (metric != RAW && L > FINISH_MAX_L))
    return cudaErrorInvalidValue;
  GatheredRows rows{};
  rows.x = x;
  rows.idx = static_cast<const int32_t*>(idx);
  rows.mask = static_cast<const uint8_t*>(mask);
  rows.m = m;
  const int item = is_bf16 ? 2 : 4;
  rows.vec = (static_cast<long long>(d) * item) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(x) % 16 == 0;
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? by_metric<__nv_bfloat16>(o, R, L, d, rows, metric, s)
                 : by_metric<float>(o, R, L, d, rows, metric, s);
}

const char* fused_gather_gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
