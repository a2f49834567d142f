// Batched Gram blocks for Hopper (sm_90a): the per-reducer product of the
// dense and bucketed executors' use_kernel=True path.
//
// Replaces the Pallas TPU kernel `pairwise_gram` / `_gram_kernel` in
// src/repro/kernels/pairwise/pairwise.py (kernel at :45, pallas_call at
// :109).  The reference tiles one (M, K) x (N, K) product with an fp32
// accumulator and masked tail tiles; on its path it runs once per reducer
// under vmap.  Here one launch computes the whole batch:
//
//     out[b] = X[b] . Y[b]^T          X (B, M, K), Y (B, N, K) -> (B, M, N)
//
// in fp32 (plain FMA, no TF32; bf16 rows are widened to fp32 as they are
// read from shared memory, and their products are exact in fp32: half the
// bytes, 3.1 ms for the m=4096 request against 3.7 ms in fp32 on an H100).
// On its only path (ops.pairwise_kernel) Y is X: the self-Gram route takes
// one pointer and stages each block row once for both sides.
//
// Bound on an H100 SXM at the main path's shape (bucket blocks of width
// L = 4..32, K = d = 256): B*L*(L+1)*K FLOP for the self-Gram's products
// i <= j, on CUDA cores in fp32 (67 TFLOP/s), against the blocks read once
// and the fp32 output written once (3.35 TB/s).  The intensity is below
// L/4 FLOP per byte, under the card's 20 for every width up to 32: the
// request is bound by bytes (7.2 GB, 2.1 ms).  So the design is about
// streaming rows in.  The kernel is stream_gram.cuh's streaming register-tile Gram (a
// persistent grid over (reducer group, tile pair) items, a cp.async ring
// of 16-byte vectors, RM x RN register tiles, symmetric self-Gram tiles)
// with the blocks' rows as its row source: row i of side 0 (1) of reducer
// r is x[r, i] (y[r, i]).  On the self-Gram route with one tile per side,
// A and B are the same staged rows, so every row is read from device
// memory once.  Rows whose byte length or base is not a multiple of 16
// (K = 33 in fp32, K = 100 in bf16) are staged by plain element loads in
// the same ring; the tail of K and rows past M / N / B are zero.
// Measured on an H100: a 4- or 6-stage ring is slower (fewer blocks fit on
// an SM), 2 and 3 stages run alike (so it shares fused_gather_gram's 2),
// and halving the multiplies by symmetry gains only ~5% at T = 32, so the
// widest bucket is not bound by its FMAs.  The times beside the
// bound and torch.bmm are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stream_gram.cuh"

namespace {

using stream_gram::CB;
using stream_gram::Grid;
using stream_gram::ROWS;
using stream_gram::RS;

template <typename Tin>
__device__ __forceinline__ Tin zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Row source: the rows of x (B, M, K) and y (B, N, K).
struct BlockRows {
  static constexpr bool kTable = false;
  const void* x;
  const void* y;        // == x on the self-Gram route
  int vec;              // rows and bases on 16-byte boundaries

  template <int TM, int TN>
  __host__ __device__ static constexpr int table_ints() { return 0; }

  // Stage chunk `kc` of item `item`'s rows into `stage`.
  template <typename Tin, int TM, int TN>
  __device__ __forceinline__ void load(const Grid& a, unsigned char* stage,
                                       const int*, long long item, int it,
                                       int jt, int kc, bool two_sides) const {
    static_assert(TM == TN, "square tiles");
    constexpr int T = TM;
    constexpr int G = ROWS / T;
    constexpr int VE = 16 / sizeof(Tin);         // elements per vector
    constexpr int KC = CB / sizeof(Tin);         // elements per chunk
    const long long r0 = (item / a.pairs) * G;
    const int k0 = kc * KC;
    const int rows = two_sides ? 2 * ROWS : ROWS;
    if (vec) {
      for (int e = threadIdx.x; e < rows * (CB / 16); e += blockDim.x) {
        const int row = e / (CB / 16), v = e % (CB / 16);
        const int side = row / ROWS, s = row % ROWS;
        const long long r = r0 + s / T;
        const int i = (side ? jt : it) * T + s % T;
        const int L = side ? a.N : a.M;
        const int k = k0 + v * VE;
        const bool ok = r < a.R && i < L && k < a.K;
        const Tin* src = static_cast<const Tin*>(side ? y : x);
        if (ok) src += (r * L + i) * static_cast<long long>(a.K) + k;
        cp_async16(stage + row * RS + v * 16, src, ok ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < rows * KC; e += blockDim.x) {
        const int row = e / KC, c = e % KC;
        const int side = row / ROWS, s = row % ROWS;
        const long long r = r0 + s / T;
        const int i = (side ? jt : it) * T + s % T;
        const int L = side ? a.N : a.M;
        const int k = k0 + c;
        Tin v = zero<Tin>();
        if (r < a.R && i < L && k < a.K)
          v = static_cast<const Tin*>(side ? y : x)
              [(r * L + i) * static_cast<long long>(a.K) + k];
        reinterpret_cast<Tin*>(stage + row * RS)[c] = v;
      }
    }
  }
};

// block = G * (T/RM) * (T/RN) threads; grid-stride over the items.
template <typename Tin, int T, int RM, int RN>
__global__ void __launch_bounds__(256)
    pairwise_gram_kernel(const Grid g, const BlockRows src) {
  extern __shared__ __align__(16) unsigned char smem[];
  stream_gram::run<Tin, T, T, RM, RN>(g, src, smem);
}

template <typename Tin, int T, int RM, int RN>
cudaError_t launch(float* out, long long B, int M, int N, int K, bool self,
                   const BlockRows& src, cudaStream_t stream) {
  const Grid g = stream_gram::schedule<T>(out, B, M, N, K, self);
  return stream_gram::launch<T, T, RM, RN>(
      pairwise_gram_kernel<Tin, T, RM, RN>, g, src, stream);
}

template <typename Tin>
cudaError_t dispatch(float* out, long long B, int M, int N, int K, bool self,
                     const BlockRows& src, cudaStream_t s) {
  const int L = M > N ? M : N;
  if (L <= 4) return launch<Tin, 4, 2, 2>(out, B, M, N, K, self, src, s);
  if (L <= 8) return launch<Tin, 8, 2, 2>(out, B, M, N, K, self, src, s);
  if (L <= 16) return launch<Tin, 16, 4, 4>(out, B, M, N, K, self, src, s);
  return launch<Tin, 32, 4, 4>(out, B, M, N, K, self, src, s);
}

}  // namespace

extern "C" {

// x (B, M, K), y (B, N, K): fp32 (is_bf16 == 0) or bf16 (is_bf16 == 1), one
// dtype; out (B, M, N) fp32.  All contiguous, on the device of `stream`.
// self_gram != 0: y is x (N == M); only x is read, each row once per tile
// pair, and only the tile pairs it <= jt are multiplied (the others are
// their mirrors).  Returns the cudaError_t of the launch (0 on success).
int pairwise_gram_launch(const void* x, const void* y, int is_bf16,
                         void* out, long long B, int M, int N, int K,
                         int self_gram, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0) return 0;
  if (K <= 0 || (self_gram && M != N)) return cudaErrorInvalidValue;
  BlockRows src{};
  src.x = x;
  src.y = self_gram ? x : y;
  const int item = is_bf16 ? 2 : 4;
  src.vec = (static_cast<long long>(K) * item) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(src.y) % 16 == 0;
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool self = self_gram != 0;
  return is_bf16 ? dispatch<__nv_bfloat16>(o, B, M, N, K, self, src, s)
                 : dispatch<float>(o, B, M, N, K, self, src, s);
}

const char* pairwise_gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
