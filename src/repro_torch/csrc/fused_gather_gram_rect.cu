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
// over two tables with independent gather maps and widths, masked slots
// zeroed at gather time; the gathered (R, Lx, d) and (R, Ly, d) blocks are
// never written to device memory.  The tile design is in cross_gram.cuh.
//
// Bound on an H100 SXM: the work is 2*d FLOP per valid (x, y) pair, on CUDA
// cores in fp32 (67 TFLOP/s); the bytes are the two tables and the idx/mask
// rows read once and the (R, Lx, Ly) fp32 output written once (3.35 TB/s).
// On chip_smoke.py's paths every request is bound by operations: the X2Y
// skew join (8192 x 512, d=256) and balanced (2048 x 2048) schemas cover
// each of their 4.2M pairs once, 2.1e9 FLOP = 0.032 ms, with the bytes
// (tables, slot rows, outputs) at 40-50% of that; the 4096^2 serving
// blocks need 0.23-0.24 ms.  The kernel is far from either: each reducer
// re-gathers its rows from L2 into shared memory, and one output per
// thread leaves the FMA pipes waiting on shared-memory reads.  The
// measured times are in PERF.md.

#include "cross_gram.cuh"

extern "C" {

// x (mx, d), y (my, d): fp32 (is_bf16 == 0) or bf16 (is_bf16 == 1), one
// dtype; xidx/xmask (R, Lx) int32/uint8; yidx/ymask (R, Ly) int32/uint8;
// out (R, Lx, Ly) fp32.  All contiguous, on the device of `stream`.
// Returns the cudaError_t of the launch (0 on success).
int fused_gather_gram_rect_launch(const void* x, const void* y, int is_bf16,
                                  const void* xidx, const void* xmask,
                                  const void* yidx, const void* ymask,
                                  void* out, long long R, int Lx, int Ly,
                                  int d, int mx, int my, void* stream) {
  cross_gram::Args a{};
  a.x = x;
  a.y = y;
  a.xidx = static_cast<const int32_t*>(xidx);
  a.xmask = static_cast<const uint8_t*>(xmask);
  a.yidx = static_cast<const int32_t*>(yidx);
  a.ymask = static_cast<const uint8_t*>(ymask);
  a.out = static_cast<float*>(out);
  a.R = R;
  a.Lx = Lx;
  a.Ly = Ly;
  a.d = d;
  a.mx = mx;
  a.my = my;
  return cross_gram::run(a, is_bf16, stream);
}

const char* fused_gather_gram_rect_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
