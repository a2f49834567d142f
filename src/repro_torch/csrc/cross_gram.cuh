// Batched cross-Gram tiles for Hopper (sm_90a), the tile of
// fused_gather_gram_rect.cu.
//
// For every reducer (batch item) r:
//
//     out[r] = A_r . B_r^T          (Lx, Ly) fp32
//
// where A_r's rows are X[xidx[r, i]] and B_r's rows Y[yidx[r, j]], rows of
// two row-major (m, d) tables; a masked slot stages zeros, a valid slot
// outside its table stages NaN (the kernel never reads outside a table, and
// the entries such a slot touches come out NaN, not silently zero).
//
// Design (a generalisation of fused_gather_gram.cu's square tile to
// independent widths; simple and correct first, speed is later work):
//   * Tile widths TX, TY: the next power of two of each side, capped at 32;
//     TY = 1 is allowed, so the skew join's 8..39 x 1..2 buckets do not sit
//     in a square tile with 90% of its threads idle.  A block takes
//     G = max(1, 256 / (TX*TY)) reducers and one (i, j) tile of each, one
//     output per thread: G*TX*TY threads (256, or TX*TY when that is more).
//   * Wider sides tile i and j.  The grid is one-dimensional over
//     (reducer group, tile) pairs, tiles fastest, so no side's tile count
//     meets the 65535 limit of gridDim.y; the launch refuses a grid over
//     2^31 - 1 blocks.
//   * The block loads its own idx/mask rows, then stages TX A-rows and TY
//     B-rows per reducer in shared memory, KC columns of d at a time, and
//     accumulates in fp32 FMA on CUDA cores (no TF32: the reference holds
//     fp32 at 1e-5), reading float4s from rows padded to a conflict-free
//     stride.  Shared-memory bandwidth and the staging barriers limit it,
//     well below the fp32 peak; register tiling or wgmma is later work.
//   * X and Y are only read.  They may be slices of one table, even
//     overlapping ones (block serving passes x[i0:i1] and x[j0:j1]), so
//     nothing here assumes they are distinct; only `out` is written.
//   * R = 0 launches nothing (the wrappers return an empty output).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cross_gram {

constexpr int KC = 32;        // d columns staged per chunk
constexpr int LDS = KC + 4;   // staged row stride in floats: 16-byte rows,
                              // conflict-free float4 reads across lanes
constexpr long long ZERO_ROW = -1;   // masked / padding slot
constexpr long long NAN_ROW = -2;    // valid slot outside its table

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int TX, int TY>
__host__ __device__ constexpr int reducers_per_block() {
  return 256 / (TX * TY) > 0 ? 256 / (TX * TY) : 1;
}

struct Args {
  const void* x;            // (mx, d) table
  const void* y;            // (my, d) table
  const int32_t* xidx;      // (R, Lx)
  const uint8_t* xmask;     // (R, Lx)
  const int32_t* yidx;      // (R, Ly)
  const uint8_t* ymask;     // (R, Ly)
  float* out;               // (R, Lx, Ly)
  long long R;
  int Lx, Ly, d, mx, my;
  int n_tx, n_ty;
};

// Staged row source of slot `slot` of reducer r on one side.
__device__ __forceinline__ long long staged_row(
    const int32_t* idx, const uint8_t* mask, long long r, int slot, int L,
    int m) {
  const long long o = r * L + slot;
  if (!mask[o]) return ZERO_ROW;
  const int row = idx[o];
  return (row >= 0 && row < m) ? row : NAN_ROW;
}

template <typename Tin, int TX, int TY>
__global__ void __launch_bounds__(1024) cross_gram_kernel(const Args a) {
  constexpr int G = reducers_per_block<TX, TY>();
  constexpr int NR = TX + TY;                     // staged rows per reducer
  extern __shared__ __align__(16) float smem[];
  float* rows = smem;                             // [G][NR][LDS]
  long long* src = reinterpret_cast<long long*>(smem + G * NR * LDS);

  const int n_tiles = a.n_tx * a.n_ty;
  const long long group = blockIdx.x / n_tiles;
  const int tile = blockIdx.x % n_tiles;
  const int it = tile / a.n_ty;
  const int jt = tile % a.n_ty;
  const long long r0 = group * G;
  const Tin* x = static_cast<const Tin*>(a.x);
  const Tin* y = static_cast<const Tin*>(a.y);

  // The block loads its own idx/mask rows: staged row s of reducer g comes
  // from A's table (s < TX) or B's (s >= TX).
  for (int e = threadIdx.x; e < G * NR; e += blockDim.x) {
    const int g = e / NR;
    const int s = e % NR;
    const long long r = r0 + g;
    const bool is_x = s < TX;
    const int slot = is_x ? it * TX + s : jt * TY + (s - TX);
    long long v = ZERO_ROW;
    if (r < a.R && slot < (is_x ? a.Lx : a.Ly))
      v = is_x ? staged_row(a.xidx, a.xmask, r, slot, a.Lx, a.mx)
               : staged_row(a.yidx, a.ymask, r, slot, a.Ly, a.my);
    src[e] = v;
  }
  __syncthreads();

  const int t = threadIdx.x;
  const int g = t / (TX * TY);
  const int ti = (t / TY) % TX;
  const int tj = t % TY;
  const float* A = rows + (g * NR + ti) * LDS;
  const float* B = rows + (g * NR + TX + tj) * LDS;
  float acc = 0.f;

  for (int k0 = 0; k0 < a.d; k0 += KC) {
    // Stage columns [k0, k0 + KC) of every row; threads walk k fastest, so
    // each warp reads contiguous table memory.
    for (int e = threadIdx.x; e < G * NR * KC; e += blockDim.x) {
      const int k = e % KC;
      const int rr = e / KC;
      const long long row = src[rr];
      float v = row == NAN_ROW ? __int_as_float(0x7fc00000) : 0.f;
      if (row >= 0 && k0 + k < a.d) {
        const Tin* tab = (rr % NR) < TX ? x : y;
        v = to_f32(tab[row * a.d + k0 + k]);
      }
      rows[rr * LDS + k] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; k += 4) {
      const float4 p = *reinterpret_cast<const float4*>(A + k);
      const float4 q = *reinterpret_cast<const float4*>(B + k);
      acc = fmaf(p.x, q.x, acc);
      acc = fmaf(p.y, q.y, acc);
      acc = fmaf(p.z, q.z, acc);
      acc = fmaf(p.w, q.w, acc);
    }
    __syncthreads();
  }

  const long long r = r0 + g;
  const int i = it * TX + ti;
  const int j = jt * TY + tj;
  if (r < a.R && i < a.Lx && j < a.Ly)
    a.out[(r * a.Lx + i) * a.Ly + j] = acc;
}

template <typename Tin, int TX, int TY>
cudaError_t launch(Args a, cudaStream_t stream) {
  constexpr int G = reducers_per_block<TX, TY>();
  constexpr int NR = TX + TY;
  a.n_tx = (a.Lx + TX - 1) / TX;
  a.n_ty = (a.Ly + TY - 1) / TY;
  const long long blocks = (a.R + G - 1) / G * a.n_tx * a.n_ty;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const size_t shmem = static_cast<size_t>(G) * NR *
                       (LDS * sizeof(float) + sizeof(long long));
  auto* kernel = cross_gram_kernel<Tin, TX, TY>;
  if (shmem > 48 * 1024) {    // above 48 KB only as opted-in dynamic smem
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), G * TX * TY, shmem, stream>>>(a);
  return cudaGetLastError();
}

template <typename Tin, int TX>
cudaError_t dispatch_y(const Args& a, cudaStream_t s) {
  if (a.Ly <= 1) return launch<Tin, TX, 1>(a, s);
  if (a.Ly <= 2) return launch<Tin, TX, 2>(a, s);
  if (a.Ly <= 4) return launch<Tin, TX, 4>(a, s);
  if (a.Ly <= 8) return launch<Tin, TX, 8>(a, s);
  if (a.Ly <= 16) return launch<Tin, TX, 16>(a, s);
  return launch<Tin, TX, 32>(a, s);
}

template <typename Tin>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (a.Lx <= 1) return dispatch_y<Tin, 1>(a, s);
  if (a.Lx <= 2) return dispatch_y<Tin, 2>(a, s);
  if (a.Lx <= 4) return dispatch_y<Tin, 4>(a, s);
  if (a.Lx <= 8) return dispatch_y<Tin, 8>(a, s);
  if (a.Lx <= 16) return dispatch_y<Tin, 16>(a, s);
  return dispatch_y<Tin, 32>(a, s);
}

// Checks of the entry point, then the dtype dispatch.
inline int run(const Args& a, int is_bf16, void* stream) {
  if (a.R <= 0 || a.Lx <= 0 || a.Ly <= 0) return 0;
  if (a.d <= 0 || a.mx < 0 || a.my < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(a, s) : dispatch<float>(a, s);
}

}  // namespace cross_gram
