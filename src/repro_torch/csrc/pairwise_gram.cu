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
// L = 4..32, K = d = 256): 2*B*L*L*K FLOP on CUDA cores in fp32 (67
// TFLOP/s) against the blocks read once and the fp32 output written once
// (3.35 TB/s).  The intensity is about L/2 FLOP per byte, below the card's
// 20 for every width up to 32: the request is bound by bytes (7.2 GB,
// 2.1 ms).  So the design is about streaming rows in:
//   * A block owns 128 staged rows per side: G = 128 / T reducers of one
//     T x T output tile (T = 4, 8, 16, 32 from max(M, N); wider blocks tile
//     i and j).  On the self-Gram route with one tile per side, A and B are
//     the same staged rows, so every row is read from device memory once,
//     and the tile is symmetric: only the thread tiles on or above its
//     diagonal multiply, and each stores its outputs twice.
//   * Rows arrive as 16-byte cp.async vectors, 128 bytes of K per row and
//     chunk, through a 3-stage ring, so two chunks are in flight while one
//     is multiplied.  The ring runs across tiles too: a persistent block
//     walks its tiles with a grid stride and the next tile's first chunks
//     load under this tile's last products.  Rows whose byte length or
//     base is not a multiple of 16 (K = 33 in fp32, K = 100 in bf16) are
//     staged by plain element loads in the same ring; the tail of K and
//     rows past M / N / B are zero.
//   * Register tiles: each thread owns RM x RN = 4 x 4 outputs (2 x 2 at
//     T = 4 and 8), rows and columns strided by the thread grid, so one
//     16-byte shared-memory load feeds RN (or RM) FMAs per element and a
//     quarter-warp's loads fall on distinct banks (row stride 144 bytes, an
//     odd number of 16-byte units).
// Measured on an H100: a 4- or 6-stage ring is slower (fewer blocks fit on
// an SM), and halving the multiplies by symmetry gains only ~5% at T = 32,
// so the widest bucket is not bound by its FMAs.  The times beside the
// bound and torch.bmm are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;          // staged rows per side and block
constexpr int CB = 128;            // bytes of K per row and chunk
constexpr int RS = CB + 16;        // staged row stride in bytes
constexpr int STAGES = 3;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

template <typename Tin>
__device__ __forceinline__ Tin zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

struct Args {
  const void* x;        // (B, M, K)
  const void* y;        // (B, N, K); == x on the self-Gram route
  float* out;           // (B, M, N)
  long long B;
  int M, N, K;
  int self_gram;        // y is x (and N == M)
  int vec;              // rows and bases on 16-byte boundaries
  int n_tm, n_tn;       // tiles along i and j
  long long items;      // reducer groups x tiles
};

// Stage chunk `kc` of item `item`'s rows into `stage`.
template <typename Tin, int T>
__device__ __forceinline__ void load_chunk(const Args& a, unsigned char* stage,
                                           long long item, int kc,
                                           bool two_sides) {
  constexpr int G = ROWS / T;
  constexpr int VE = 16 / sizeof(Tin);           // elements per vector
  constexpr int KC = CB / sizeof(Tin);           // elements per chunk
  const int tiles = a.n_tm * a.n_tn;
  const long long r0 = (item / tiles) * G;
  const int tile = static_cast<int>(item % tiles);
  const int it = tile / a.n_tn, jt = tile % a.n_tn;
  const int k0 = kc * KC;
  const int rows = two_sides ? 2 * ROWS : ROWS;
  if (a.vec) {
    for (int e = threadIdx.x; e < rows * (CB / 16); e += blockDim.x) {
      const int row = e / (CB / 16), v = e % (CB / 16);
      const int side = row / ROWS, s = row % ROWS;
      const long long r = r0 + s / T;
      const int i = (side ? jt : it) * T + s % T;
      const int L = side ? a.N : a.M;
      const int k = k0 + v * VE;
      const bool ok = r < a.B && i < L && k < a.K;
      const Tin* src = static_cast<const Tin*>(side ? a.y : a.x);
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
      if (r < a.B && i < L && k < a.K)
        v = static_cast<const Tin*>(side ? a.y : a.x)
            [(r * L + i) * static_cast<long long>(a.K) + k];
      reinterpret_cast<Tin*>(stage + row * RS)[c] = v;
    }
  }
}

// block = G * (T/RM) * (T/RN) threads; grid-stride over a.items.
template <typename Tin, int T, int RM, int RN>
__global__ void __launch_bounds__(256) pairwise_gram_kernel(const Args a) {
  constexpr int G = ROWS / T;
  constexpr int TI = T / RM, TJ = T / RN;        // thread grid of one tile
  constexpr int VE = 16 / sizeof(Tin);
  constexpr int KC = CB / sizeof(Tin);
  extern __shared__ __align__(16) unsigned char smem[];

  // one side staged when A's rows are B's rows: self-Gram, one tile
  const bool one_side = a.self_gram && a.n_tm == 1 && a.n_tn == 1;
  const int stage_bytes = (one_side ? 1 : 2) * ROWS * RS;
  const int n_chunks = (a.K + KC - 1) / KC;
  const long long my_items =
      a.items > blockIdx.x ? (a.items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long steps = my_items * n_chunks;
  const int tiles = a.n_tm * a.n_tn;

  // Thread t owns outputs (ti + TI i, tj + TJ j) of reducer g's tile.  One
  // staged side means out[r] is symmetric: only the pairs ti <= tj are
  // computed, each also stored mirrored, and the spare threads (whole
  // warps, mostly) only stage rows.
  static_assert(TI == TJ, "square thread grid");
  constexpr int PAIRS = TI * (TI + 1) / 2;
  const int t = threadIdx.x;
  int g = t / (TI * TJ), ti = (t / TJ) % TI, tj = t % TJ;
  if (one_side) {
    g = t / PAIRS;
    int u = t % PAIRS;
    for (ti = 0; u >= TI - ti; ++ti) u -= TI - ti;
    tj = ti + u;
  }
  const bool active = g < G;

  auto load = [&](long long s) {
    if (s < steps) {
      const long long item = blockIdx.x + (s / n_chunks) * gridDim.x;
      const int tile = static_cast<int>(item % tiles);
      const bool shared = a.self_gram && tile / a.n_tn == tile % a.n_tn;
      load_chunk<Tin, T>(a, smem + (s % STAGES) * stage_bytes, item,
                         static_cast<int>(s % n_chunks), !shared);
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
    const int tile = static_cast<int>(item % tiles);
    const int it = tile / a.n_tn, jt = tile % a.n_tn;
    const unsigned char* st = smem + (s % STAGES) * stage_bytes;
    // B's rows: the A rows themselves when the two sides are one
    const bool shared = a.self_gram && it == jt;
    const unsigned char* sa = st + (g * T) * RS;
    const unsigned char* sb = st + ((shared ? 0 : ROWS) + g * T) * RS;
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
      const long long r = (item / tiles) * G + g;
      if (active && r < a.B) {
        float* o = a.out + r * a.M * static_cast<long long>(a.N);
        const bool mirror = one_side && ti != tj;
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int row = it * T + ti + TI * i;
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const int col = jt * T + tj + TJ * j;
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

template <typename Tin, int T, int RM, int RN>
cudaError_t launch(Args a, cudaStream_t stream) {
  constexpr int G = ROWS / T;
  constexpr int threads = G * (T / RM) * (T / RN);
  a.n_tm = (a.M + T - 1) / T;
  a.n_tn = (a.N + T - 1) / T;
  a.items = (a.B + G - 1) / G * a.n_tm * a.n_tn;
  const bool one_side = a.self_gram && a.n_tm == 1 && a.n_tn == 1;
  const int shmem = STAGES * (one_side ? 1 : 2) * ROWS * RS;
  auto* kernel = pairwise_gram_kernel<Tin, T, RM, RN>;
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
  const long long blocks = a.items < resident ? a.items : resident;
  kernel<<<static_cast<unsigned>(blocks), threads, shmem, stream>>>(a);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  const int L = a.M > a.N ? a.M : a.N;
  if (L <= 4) return launch<Tin, 4, 2, 2>(a, s);
  if (L <= 8) return launch<Tin, 8, 2, 2>(a, s);
  if (L <= 16) return launch<Tin, 16, 4, 4>(a, s);
  return launch<Tin, 32, 4, 4>(a, s);
}

}  // namespace

extern "C" {

// x (B, M, K), y (B, N, K): fp32 (is_bf16 == 0) or bf16 (is_bf16 == 1), one
// dtype; out (B, M, N) fp32.  All contiguous, on the device of `stream`.
// self_gram != 0: y is x (N == M); only x is read, each row once per tile
// pair.  Returns the cudaError_t of the launch (0 on success).
int pairwise_gram_launch(const void* x, const void* y, int is_bf16,
                         void* out, long long B, int M, int N, int K,
                         int self_gram, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0) return 0;
  if (K <= 0 || (self_gram && M != N)) return cudaErrorInvalidValue;
  Args a{};
  a.x = x;
  a.y = self_gram ? x : y;
  a.out = static_cast<float*>(out);
  a.B = B;
  a.M = M;
  a.N = N;
  a.K = K;
  a.self_gram = self_gram != 0;
  const int item = is_bf16 ? 2 : 4;
  a.vec = (static_cast<long long>(K) * item) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.y) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(a, s) : dispatch<float>(a, s);
}

const char* pairwise_gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
