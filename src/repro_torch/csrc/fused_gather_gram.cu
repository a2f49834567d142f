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
// input 0) and all-masked padding rows give zero entries.  The kernel never
// reads outside the table: a valid slot whose index lies outside [0, m)
// stages NaN, so the entries it touches come out NaN, not silently zero
// (the executors reject such plans on the host before launching).  The gathered
// (R, L, d) block is never written to device memory: rows go from the table
// straight into shared memory.
//
// Bound on an H100 SXM at the main path's shape (m=4096, d=256, Zipf plan:
// buckets of width 4/8/16/32 with 115,976,064 Gram entries in all):
//   * operations: 2 * 115,976,064 * 256 = 5.94e10 FLOP.  In fp32 on CUDA
//     cores (67 TFLOP/s) that is 0.89 ms, so fp32 is bound by operations.
//   * bytes: the (R, L, L) fp32 output is 464 MB, written once: 0.14 ms at
//     3.35 TB/s; the table (4 MiB) and idx/mask (~33 MB) are read once each.
//     For a bf16 table the tensor-core time (0.06 ms at 989 TFLOP/s) is
//     below that, so bf16 is bound by the block write.
//   (Only valid pairs need the product; chip_smoke.py states the bound for
//   the data it runs.)
//
// What this simple design does about that bound:
//   * One thread block takes G reducers of a bucket and one (i, j) tile of
//     T x T outputs; T is the smallest power of two >= the bucket width,
//     capped at 32, and G = max(1, 256 / T^2).  Wider buckets tile i and j
//     over gridDim.y.  Narrow buckets thus still fill 256-thread blocks.
//   * The block loads its own idx/mask rows, then stages the gathered rows
//     in shared memory KC columns of d at a time (0 for a masked slot).  The
//     table is 4 MiB and stays in the 50 MB L2, so the repeated gathers are
//     L2 reads, not device-memory reads.
//   * Each thread accumulates one output in fp32 FMA on CUDA cores (no TF32:
//     the reference is held at 1e-5), reading both operands as float4 from
//     shared memory rows padded to a conflict-free stride.  Shared-memory
//     bandwidth, not FMA issue, limits it: about a quarter of fp32 peak at
//     best.  Register tiling or wgmma on bf16 is later work.
//   * The output is written once, coalesced along j.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 32;        // d columns staged per chunk
constexpr int LDS = KC + 4;   // staged row stride in floats: 16-byte rows,
                              // conflict-free float4 reads across lanes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int T>
__host__ __device__ constexpr int reducers_per_block() {
  return 256 / (T * T) > 0 ? 256 / (T * T) : 1;
}

// grid = (ceil(R / G), n_t * n_t), block = G * T * T threads.
// rstride = staged rows per reducer: T when n_t == 1 (the i and j tiles are
// the same rows), else 2T.
template <typename Tin, int T>
__global__ void __launch_bounds__(1024)
fused_gather_gram_kernel(const Tin* __restrict__ x,
                         const int32_t* __restrict__ idx,
                         const uint8_t* __restrict__ mask,
                         float* __restrict__ out, long long R, int L, int d,
                         int m, int n_t, int rstride) {
  constexpr int G = reducers_per_block<T>();
  extern __shared__ __align__(16) float smem[];
  int* src = reinterpret_cast<int*>(smem);        // [G][rstride] table rows
  float* rows = smem + G * rstride;               // [G][rstride][LDS]

  const int it = blockIdx.y / n_t;
  const int jt = blockIdx.y % n_t;
  const bool same = it == jt;
  const int nrows = same ? T : 2 * T;             // rows staged per reducer
  const long long r0 = static_cast<long long>(blockIdx.x) * G;

  // The block loads its own idx/mask rows: staged row s of reducer g comes
  // from table row src[g][s]; -1 stages zeros (a masked / padding slot),
  // -2 stages NaN (an index outside the table).
  for (int e = threadIdx.x; e < G * nrows; e += blockDim.x) {
    const int g = e / nrows;
    const int s = e % nrows;
    const int slot = (s < T ? it : jt) * T + s % T;
    const long long r = r0 + g;
    int v = -1;
    if (r < R && slot < L) {
      const long long o = r * L + slot;
      if (mask[o]) {
        const int row = idx[o];
        v = (row >= 0 && row < m) ? row : -2;
      }
    }
    src[g * rstride + s] = v;
  }
  __syncthreads();

  const int t = threadIdx.x;
  const int g = t / (T * T);
  const int ti = (t / T) % T;
  const int tj = t % T;
  const float* A = rows + (g * rstride + ti) * LDS;
  const float* B = rows + (g * rstride + (same ? tj : T + tj)) * LDS;
  float acc = 0.f;

  for (int k0 = 0; k0 < d; k0 += KC) {
    // Stage columns [k0, k0 + KC) of every gathered row; threads walk k
    // fastest, so each warp reads contiguous table memory.
    for (int e = threadIdx.x; e < G * nrows * KC; e += blockDim.x) {
      const int k = e % KC;
      const int rr = e / KC;
      const int g2 = rr / nrows;
      const int s = rr % nrows;
      const int row = src[g2 * rstride + s];
      float v = row == -2 ? __int_as_float(0x7fc00000) : 0.f;   // NaN / 0
      if (row >= 0 && k0 + k < d)
        v = to_f32(x[static_cast<long long>(row) * d + k0 + k]);
      rows[(g2 * rstride + s) * LDS + k] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; k += 4) {
      const float4 a = *reinterpret_cast<const float4*>(A + k);
      const float4 b = *reinterpret_cast<const float4*>(B + k);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
    __syncthreads();
  }

  const long long r = r0 + g;
  const int i = it * T + ti;
  const int j = jt * T + tj;
  if (r < R && i < L && j < L) out[(r * L + i) * L + j] = acc;
}

template <typename Tin, int T>
cudaError_t launch(const void* x, const void* idx, const void* mask,
                   void* out, long long R, int L, int d, int m,
                   cudaStream_t stream) {
  constexpr int G = reducers_per_block<T>();
  const int n_t = (L + T - 1) / T;
  if (static_cast<long long>(n_t) * n_t > 65535) return cudaErrorInvalidValue;
  const int rstride = n_t == 1 ? T : 2 * T;
  const size_t shmem = static_cast<size_t>(G) * rstride *
                       (sizeof(int) + LDS * sizeof(float));
  const dim3 grid(static_cast<unsigned>((R + G - 1) / G), n_t * n_t);
  fused_gather_gram_kernel<Tin, T><<<grid, G * T * T, shmem, stream>>>(
      static_cast<const Tin*>(x), static_cast<const int32_t*>(idx),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), R, L, d,
      m, n_t, rstride);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t dispatch(const void* x, const void* idx, const void* mask,
                     void* out, long long R, int L, int d, int m,
                     cudaStream_t stream) {
  if (L <= 1) return launch<Tin, 1>(x, idx, mask, out, R, L, d, m, stream);
  if (L <= 2) return launch<Tin, 2>(x, idx, mask, out, R, L, d, m, stream);
  if (L <= 4) return launch<Tin, 4>(x, idx, mask, out, R, L, d, m, stream);
  if (L <= 8) return launch<Tin, 8>(x, idx, mask, out, R, L, d, m, stream);
  if (L <= 16) return launch<Tin, 16>(x, idx, mask, out, R, L, d, m, stream);
  return launch<Tin, 32>(x, idx, mask, out, R, L, d, m, stream);
}

}  // namespace

extern "C" {

// x (m, d) fp32 (is_bf16 == 0) or bf16 (is_bf16 == 1); idx (R, L) int32;
// mask (R, L) uint8; out (R, L, L) fp32.  All contiguous, on the device of
// `stream`.  Returns the cudaError_t of the launch (0 on success).
int fused_gather_gram_launch(const void* x, int is_bf16, const void* idx,
                             const void* mask, void* out, long long R, int L,
                             int d, int m, void* stream) {
  if (R <= 0) return 0;
  if (L <= 0 || d <= 0 || m <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(x, idx, mask, out, R, L, d, m, s)
                 : dispatch<float>(x, idx, mask, out, R, L, d, m, s);
}

const char* fused_gather_gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
