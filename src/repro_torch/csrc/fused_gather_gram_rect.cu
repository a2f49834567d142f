// Rectangular fused gather + Gram for Hopper (sm_90a): the bipartite (X2Y)
// shuffle streams straight into each reducer's cross block.
//
// Replaces the Pallas TPU kernel `fused_gather_gram_rect` /
// `_fused_rect_kernel` in src/repro/kernels/pairwise/fused_gather_gram.py
// (kernel at :157, pallas_call at :255).  For every reducer r of one
// rectangular capacity bucket:
//
//     out[r] = X[xidx_r] . Y[yidx_r]^T          (Lx, Ly) fp32
//
// over two tables with independent gather maps and widths; or, with a
// metric (dot, cosine, l2), those blocks finished into similarities in the
// kernel's epilogue (below).  A masked slot stands for a zero row, as in
// the plain version: its entries are zero beside finite rows.  A valid
// slot whose index lies outside its table gives NaN in every entry of its
// row (X) or column (Y) (the kernel never reads outside a table; the
// executors reject such plans on the host).  x and y may be overlapping
// row slices of one table (block serving passes x[i0:i1] and x[j0:j1]):
// they are only read.  The gathered (R, Lx, d) and (R, Ly, d) blocks are
// never written to device memory.
//
// Bound on an H100 SXM: the work is 2 d FLOP per valid (x, y) pair, on CUDA
// cores in fp32 (67 TFLOP/s; no TF32: the reference holds fp32 at 1e-5);
// the bytes are the two tables and the idx/mask rows read once and the
// (R, Lx, Ly) fp32 output written once (3.35 TB/s), finished or raw (the
// epilogue reads one fp32 norm a staged slot, from vectors that stay in
// L2).  On chip_smoke.py's paths every request is bound by operations
// (0.032 ms for the X2Y skew join and balanced schemas, 0.23-0.24 ms for
// the 4096^2 serving blocks).
// In practice the floor is the gather: each reducer stages its valid rows
// from the tables, which stay in the 50 MB L2, a few GB per X2Y request
// modelled from the plan (fused_gather_gram.rect_gather_bytes), at a few
// thin dot products per row (about 0.5 FLOP per byte staged).
//
// Design: stream_gram.cuh's streaming register-tile Gram (persistent grid
// over (reducer group, tile pair) items, a cp.async ring that runs across
// items, RM x RN register tiles) with GatheredPairRows (gathered_rows.cuh)
// as its row source:
//   * Tile widths per side: the next power of two of the side's width,
//     from TMIN up to TMAX; wider sides take several tiles.  Thin sides get
//     thin tiles (the skew join's 8..39 x 1..2 buckets, balanced 2 x 2), so
//     a block holds 128 / max(TM, TN) reducers and keeps the gather
//     stream's bytes in flight.  Register tiles are the square kernels',
//     halved where fewer than 16 warps would fit on an SM (two staged
//     sides fill shared memory twice as fast as one).
//   * Only valid slots are read from the tables: a masked slot is staged as
//     zeros by a zero-byte cp.async, and its entries are products with that
//     zero row, as in the plain version.  Every position of a tile pair is
//     multiplied: the planners size each bucket to its reducers' widths and
//     put their valid slots first.  Two ways to multiply fewer positions
//     were measured slower on chip_smoke.py's four rect paths and dropped:
//     putting each side's valid slots first in the kernel, and staging only
//     valid slots with a store that scatters the products and zeroes the
//     rest (PERF.md).
//   * The metric finish is the epilogue (FinishRect below, a `kNorms`
//     policy of stream_gram.cuh) where a block is one tile a side,
//     Lx, Ly <= 32.  A cross block has no diagonal, so each staged slot's
//     norm comes from the tables' fp32 squared-norm vectors n2x / n2y
//     (the caller's two reductions), read once an item through the row
//     table the gather already holds in shared memory: sqrt(n2 + 1e-9) for
//     cosine, n2 for l2, -1 for a slot that is not live.  Each entry is
//     stored exactly as the torch finish (finish_rect_blocks) computes it
//     from the raw block: cosine g / (nx ny), l2 (nx + ny) - 2 g, dot g,
//     +0 where either slot is masked, in IEEE fp32 with the roundings
//     spelled out; a valid slot outside its table still makes its row or
//     column NaN.  As in the square kernel's measured design, the products
//     pass through the stage just multiplied (G padded TM x TN tiles, two
//     barriers), so that all the block's threads finish them and store the
//     group's blocks, one contiguous range, coalesced.  The caller passes
//     `out` as its slice of the one vector the assembly gathers from, so
//     the finished blocks are written once and never copied.  Wider
//     buckets store the raw products, and the caller finishes them in
//     torch.  `metric` is a launch argument: one finished instantiation a
//     tile pair beside the raw one.  Finished against raw on an H100, the
//     buckets the epilogue takes, cosine (tools/kernel_ab.py --parts
//     rect): X2Y skew 1.384 / 1.334 ms fp32, 0.880 / 0.808 bf16; balanced
//     1.504 / 1.435, 0.848 / 0.790; the serving blocks 3.240 / 3.036 and
//     2.326 / 2.199 fp32 (3.7-9.0% over the raw store in all); on the
//     benchmark's X2Y request (4096 x 8192 x 256, Zipf sizes) 14.46 ms
//     against 13.77, in place of 3.6 ms of torch finish and a 0.67 ms
//     copy into the assembly's vector (PERF.md).
// The constants were held against each other on an H100 with
// tools/kernel_ab.py (--parts rect); the times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gathered_rows.cuh"

namespace {

using gathered_rows::GatheredPairRows;
using stream_gram::Grid;

constexpr int TMIN = 1;       // thinnest tile of a side
constexpr int TMAX = 32;      // widest tile; longer sides take several
// Register tiles start as the square kernels' (4 x 4 from width 16, 2 x 2
// from width 4, one output per thread beside a side of 2 or less) and are
// halved while fewer than MIN_WARPS warps of the kernel fit on an SM: two
// staged sides fill shared memory twice as fast as the square kernel's one.
constexpr int MIN_WARPS = 16;
constexpr int SM_SMEM = 228 * 1024;   // shared memory of an H100 SM

// What a launch stores (the `metric` of the C entry point; the square
// kernel's codes).
enum Metric { RAW = 0, DOT = 1, COSINE = 2, L2 = 3 };
constexpr int FINISH_MAX_L = 32;    // one tile a side (TMAX)

// The metric epilogue of a cross block (a `kNorms` policy of
// stream_gram.cuh): each entry's similarity from its raw product g and its
// slots' squared norms, read from the tables' norm vectors through the
// item's row table; +0 for a pair with a masked slot.  The arithmetic is
// the torch finish's (finish_rect_blocks), rounding for rounding.
struct FinishRect {
  static constexpr bool kDiag = false;
  static constexpr bool kNorms = true;
  const float* n2x;         // (mx) squared norms of X's rows; null for dot
  const float* n2y;         // (my) of Y's rows
  int metric;               // DOT, COSINE or L2

  // The finishing form of the slot staged from table row `row` (a
  // gathered_row code) of side `side`: sqrt(n2 + 1e-9) for cosine, n2 for
  // l2, 0 for dot; -1 where the slot is not live; NaN for a valid slot
  // outside its table, whose products are NaN already.
  __device__ __forceinline__ float norm(int side, int row) const {
    if (row == -1) return -1.f;
    if (row < 0) return __int_as_float(0x7fc00000);
    if (metric == DOT) return 0.f;
    const float n2 = (side ? n2y : n2x)[row];
    return metric == COSINE ? __fsqrt_rn(__fadd_rn(n2, 1e-9f)) : n2;
  }
  __device__ __forceinline__ float finish(float g, float ni, float nj) const {
    if (metric == COSINE) return __fdiv_rn(g, __fmul_rn(ni, nj));
    if (metric == L2) return __fsub_rn(__fadd_rn(ni, nj), __fmul_rn(2.f, g));
    return g;
  }
};

struct RegTile {
  int m, n;
};

// The register tile RM x RN of tiles TM x TN.
template <int TM, int TN>
constexpr RegTile reg_tile() {
  constexpr int G = stream_gram::group<TM, TN>();
  constexpr int smem =
      stream_gram::STAGES *
      (G * (TM + TN) * stream_gram::RS +
       GatheredPairRows::table_ints<TM, TN>() * static_cast<int>(sizeof(int)));
  constexpr int blocks = SM_SMEM / (smem + 1024);   // 1 KB kept per block
  const bool thin = TM <= 2 || TN <= 2;
  RegTile t{thin ? 1 : TM <= 8 ? 2 : TM <= 32 ? 4 : 8,
            thin ? 1 : TN <= 8 ? 2 : TN <= 32 ? 4 : 8};
  while (t.m * t.n > 1 &&
         blocks * G * (TM / t.m) * (TN / t.n) < MIN_WARPS * 32 &&
         2 * G * (TM / t.m) * (TN / t.n) <= 256) {
    if (t.n >= t.m)
      t.n /= 2;
    else
      t.m /= 2;
  }
  return t;
}

// block = G * (TM/RM) * (TN/RN) threads; grid-stride over the items.
template <typename Tin, int TM, int TN, int RM, int RN>
__global__ void __launch_bounds__(256)
    fused_gather_gram_rect_kernel(const Grid g, const GatheredPairRows src) {
  extern __shared__ __align__(16) unsigned char smem[];
  stream_gram::run<Tin, TM, TN, RM, RN>(g, src, smem);
}

// The same, each block stored finished: tiles TM >= Lx, TN >= Ly.
template <typename Tin, int TM, int TN, int RM, int RN>
__global__ void __launch_bounds__(256)
    fused_gather_gram_rect_finished_kernel(const Grid g,
                                           const GatheredPairRows src,
                                           const FinishRect epi) {
  extern __shared__ __align__(16) unsigned char smem[];
  stream_gram::run<Tin, TM, TN, RM, RN>(g, src, smem, epi);
}

// A launch of tiles TM x TN: the raw kernel when `epi` is null, else the
// finished one.
template <typename Tin, int TM, int TN>
cudaError_t launch(float* out, long long R, int Lx, int Ly, int d,
                   const GatheredPairRows& src, const FinishRect* epi,
                   cudaStream_t stream) {
  constexpr int RM = reg_tile<TM, TN>().m, RN = reg_tile<TM, TN>().n;
  const Grid g = stream_gram::schedule<TM, TN>(out, R, Lx, Ly, d, false);
  if (epi)
    return stream_gram::launch<TM, TN, RM, RN>(
        fused_gather_gram_rect_finished_kernel<Tin, TM, TN, RM, RN>, g, src,
        *epi, stream);
  return stream_gram::launch<TM, TN, RM, RN>(
      fused_gather_gram_rect_kernel<Tin, TM, TN, RM, RN>, g, src, stream);
}

// The tile widths of (Lx, Ly): the smallest power of two >= the side, in
// [TMIN, TMAX].
template <typename Tin, int TM, int TN = TMIN>
cudaError_t pick_tn(float* out, long long R, int Lx, int Ly, int d,
                    const GatheredPairRows& src, const FinishRect* epi,
                    cudaStream_t s) {
  if constexpr (TN < TMAX) {
    if (Ly > TN)
      return pick_tn<Tin, TM, 2 * TN>(out, R, Lx, Ly, d, src, epi, s);
  }
  return launch<Tin, TM, TN>(out, R, Lx, Ly, d, src, epi, s);
}

template <typename Tin, int TM = TMIN>
cudaError_t pick_tm(float* out, long long R, int Lx, int Ly, int d,
                    const GatheredPairRows& src, const FinishRect* epi,
                    cudaStream_t s) {
  if constexpr (TM < TMAX) {
    if (Lx > TM) return pick_tm<Tin, 2 * TM>(out, R, Lx, Ly, d, src, epi, s);
  }
  return pick_tn<Tin, TM>(out, R, Lx, Ly, d, src, epi, s);
}

bool on_16_bytes(const void* p, int d, int item) {
  return (static_cast<long long>(d) * item) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// x (mx, d), y (my, d): fp32 (is_bf16 == 0) or bf16 (is_bf16 == 1), one
// dtype; xidx/xmask (R, Lx) int32/uint8; yidx/ymask (R, Ly) int32/uint8;
// out (R, Lx, Ly) fp32, the raw blocks (metric 0) or their dot (1), cosine
// (2) or l2 (3) similarities, which take Lx, Ly <= 32 and, but for dot,
// n2x (mx) and n2y (my), the tables' fp32 squared norms.  All contiguous
// (out 4-byte aligned), on the device of `stream`.  Returns the
// cudaError_t of the launch (0 on success).
int fused_gather_gram_rect_launch(const void* x, const void* y, int is_bf16,
                                  const void* xidx, const void* xmask,
                                  const void* yidx, const void* ymask,
                                  void* out, long long R, int Lx, int Ly,
                                  int d, int mx, int my, int metric,
                                  const void* n2x, const void* n2y,
                                  void* stream) {
  if (R <= 0 || Lx <= 0 || Ly <= 0) return 0;
  if (d <= 0 || mx < 0 || my < 0 || metric < RAW || metric > L2 ||
      (metric != RAW && (Lx > FINISH_MAX_L || Ly > FINISH_MAX_L)) ||
      ((metric == COSINE || metric == L2) && (!n2x || !n2y)))
    return cudaErrorInvalidValue;
  GatheredPairRows src{};
  src.x = x;
  src.y = y;
  src.xidx = static_cast<const int32_t*>(xidx);
  src.xmask = static_cast<const uint8_t*>(xmask);
  src.yidx = static_cast<const int32_t*>(yidx);
  src.ymask = static_cast<const uint8_t*>(ymask);
  src.mx = mx;
  src.my = my;
  const int item = is_bf16 ? 2 : 4;
  src.vecx = on_16_bytes(x, d, item);
  src.vecy = on_16_bytes(y, d, item);
  const FinishRect fin{static_cast<const float*>(n2x),
                       static_cast<const float*>(n2y), metric};
  const FinishRect* epi = metric == RAW ? nullptr : &fin;
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? pick_tm<__nv_bfloat16>(o, R, Lx, Ly, d, src, epi, s)
                 : pick_tm<float>(o, R, Lx, Ly, d, src, epi, s);
}

const char* fused_gather_gram_rect_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
