// Batched tiled X . Y^T for Hopper (sm_90a): the per-reducer Gram block of
// the dense and bucketed executors' use_kernel=True path.
//
// Replaces the Pallas TPU kernel `pairwise_gram` / `_gram_kernel` in
// src/repro/kernels/pairwise/pairwise.py (kernel at :45, pallas_call at
// :109).  The reference tiles one (M, K) x (N, K) product with an fp32
// accumulator and masked tail tiles; on its path it runs once per reducer
// under vmap.  Here one launch computes the whole batch:
//
//     out[b] = X[b] . Y[b]^T          X (B, M, K), Y (B, N, K) -> (B, M, N)
//
// in fp32 (plain FMA, no TF32), tails masked at the store.  The tile design
// is cross_gram.cuh's without the gather: row i of X[b] is row b*M + i of
// the (B*M, K) view.
//
// Bound on an H100 SXM at the main path's shape (bucket blocks of width
// 4..32, K = d = 256): 2*B*M*N*K FLOP, on CUDA cores in fp32 (67 TFLOP/s),
// against the blocks read once from device memory and the fp32 output
// written once (3.35 TB/s).  With L outputs per row read, the intensity is
// about L/2 FLOP per byte, below the card's 20 for every width up to 32:
// the whole request is bound by bytes (7.2 GB, 2.1 ms).  One output per
// thread re-reads each block row from shared memory L times; the measured
// times are in PERF.md.

#include "cross_gram.cuh"

extern "C" {

// x (B, M, K), y (B, N, K): fp32 (is_bf16 == 0) or bf16 (is_bf16 == 1), one
// dtype; out (B, M, N) fp32.  All contiguous, on the device of `stream`.
// Returns the cudaError_t of the launch (0 on success).
int pairwise_gram_launch(const void* x, const void* y, int is_bf16,
                         void* out, long long B, int M, int N, int K,
                         void* stream) {
  cross_gram::Args a{};
  a.x = x;
  a.y = y;
  a.out = static_cast<float*>(out);
  a.R = B;
  a.Lx = M;
  a.Ly = N;
  a.d = K;
  return cross_gram::run<false>(a, is_bf16, stream);
}

const char* pairwise_gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
