// Mamba-2 SSD chunked scan for Hopper (sm_90a): every head of a Mamba layer
// in one launch.
//
// Replaces the Pallas TPU kernel `ssd_scan` / `_ssd_kernel` in
// src/repro/kernels/ssd/ssd.py (kernel at :29, pallas_call at :89), which
// the reference runs once per (batch, head) under vmap.  For each head the
// recurrence
//
//     h_t = a_t h_{t-1} + B_t x_t^T        y_t = C_t . h_t      (h: N x P)
//
// with a_t = exp(log_a_t), log_a_t <= 0, is evaluated in chunks of Q steps
// (Q <= 128; the model uses 128).  With la the within-chunk cumulative sum
// of log_a:
//
//     y_i   = sum_{j <= i} (C_i . B_j) exp(la_i - la_j) x_j       (intra)
//           + exp(la_i) C_i . h                                    (inter)
//     h_new = exp(la_end) h + sum_j B_j (x_j exp(la_end - la_j))^T
//
// the reference's formulation.  All arithmetic is fp32 (inputs fp32 or bf16,
// log_a fp32); y has x's dtype.
//
// Bound on an H100 SXM at the timed shape (B=2, S=4096, H=256 heads, Q=128,
// N=128, P=64, bf16): per chunk Q(Q+1)/2 (N + P) multiply-adds for the
// masked intra-chunk products and 2 Q N P for the inter-chunk term and the
// state update, 1.2e11 operations in all, 0.12 ms at 989 TFLOP/s; x and y
// (268 MB each), log_a (8 MB) and the shared B and C (4 MB) move 0.55 GB,
// 0.16 ms at 3.35 TB/s.  So the kernel sits near the ridge, bound by bytes.
//
// What this simple design does about that bound (not a block-by-block copy
// of the TPU kernel, whose sequential chunk grid and VMEM state do not
// exist here):
//   * One thread block per (b, h) loops over the chunks in order with the
//     (N, P) fp32 state in shared memory; that loop replaces the TPU's
//     sequential chunk grid.  x, B, C, y and log_a are read and written
//     exactly once.
//   * B and C are read through their strides: the model passes one B and
//     one C broadcast to every head (head stride 0), so they are never
//     copied per head and come from L2 after the first head reads them.
//   * Shared memory: staging x, B and C in fp32 with the state and a full
//     (Q, Q) decay-weighted product would need 256 KB, more than the 227 KB
//     a block may have.  So the (Q, Q) product is built 32 rows at a time
//     and consumed at once: 211 KB in all, one block per SM.
//   * The within-chunk cumulative sum of log_a is a warp-shuffle scan.
//   * 256 threads, fp32 FMA on CUDA cores (no TF32: the fp32 contract is
//     2e-4); each thread owns 4 x 4 products of a row block, 4 rows x 2
//     columns of y and 16 x 2 entries of the state, and skips the product
//     tiles above the diagonal warp by warp.  Shared-memory bandwidth bounds
//     the inner loops.  Measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int QMAX = 128;    // largest chunk
constexpr int NMAX = 128;    // largest state width N
constexpr int PMAX = 64;     // largest head width P
constexpr int RB = 32;       // rows of the (Q, Q) product built at a time
constexpr int LDG = QMAX + 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Params {
  const void* x;
  const float* la;
  const void* b;
  const void* c;
  void* y;
  long long x_sb, x_ss, x_sh;   // element strides; the last axis contiguous
  long long la_sb, la_ss, la_sh;
  long long b_sb, b_ss, b_sh;   // b_sh / c_sh may be 0 (broadcast heads)
  long long c_sb, c_ss, c_sh;
  long long y_sb, y_ss, y_sh;
  int S, N, P, Q;
};

size_t smem_bytes(int N, int P, int Q) {
  const size_t ldn = N + 1;
  return sizeof(float) * (size_t(Q) * P        // sX
                          + 2 * size_t(Q) * ldn  // sB, sC
                          + size_t(N) * P        // sH
                          + size_t(RB) * LDG     // sG
                          + 3 * size_t(QMAX)     // sLa, sW, sE
                          + 4);                  // warp totals of the scan
}

// grid = (H, B), block = NT threads.
template <typename T>
__global__ void __launch_bounds__(NT) ssd_scan_kernel(Params p) {
  const int N = p.N, P = p.P, Q = p.Q, LDN = N + 1;
  extern __shared__ float smem[];
  float* sX = smem;                   // [Q][P]
  float* sB = sX + Q * P;             // [Q][LDN]
  float* sC = sB + Q * LDN;           // [Q][LDN]
  float* sH = sC + Q * LDN;           // [N][P]   the carried state
  float* sG = sH + N * P;             // [RB][LDG] one row block of the product
  float* sLa = sG + RB * LDG;         // [QMAX]   cumulative log decay
  float* sW = sLa + QMAX;             // [QMAX]   exp(la_end - la_j)
  float* sE = sW + QMAX;              // [QMAX]   exp(la_i)
  float* sTot = sE + QMAX;            // [4]

  const int tid = threadIdx.x;
  const int tc = tid & 31, tr = tid >> 5;     // 8 warps of 32 lanes
  const int h = blockIdx.x, b = blockIdx.y;

  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* la = p.la + b * p.la_sb + h * p.la_sh;
  const T* bm = static_cast<const T*>(p.b) + b * p.b_sb + h * p.b_sh;
  const T* cm = static_cast<const T*>(p.c) + b * p.c_sb + h * p.c_sh;
  T* y = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh;

  for (int e = tid; e < N * P; e += NT) sH[e] = 0.f;

  for (int t0 = 0; t0 < p.S; t0 += Q) {
    const int ql = min(Q, p.S - t0);          // rows of this chunk
    __syncthreads();            // last chunk's state update and reads done
    for (int e = tid; e < ql * P; e += NT) {
      const int r = e / P, col = e % P;
      sX[r * P + col] = to_f32(x[(t0 + r) * p.x_ss + col]);
    }
    for (int e = tid; e < ql * N; e += NT) {
      const int r = e / N, col = e % N;
      sB[r * LDN + col] = to_f32(bm[(t0 + r) * p.b_ss + col]);
      sC[r * LDN + col] = to_f32(cm[(t0 + r) * p.c_ss + col]);
    }
    // within-chunk inclusive cumulative sum of log_a: a shuffle scan in each
    // of the first four warps, then the warps' totals
    float run = 0.f;
    if (tid < QMAX) {
      run = tid < ql ? la[(t0 + tid) * p.la_ss] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, run, off);
        if (tc >= off) run += u;
      }
      if (tc == 31) sTot[tr] = run;
    }
    __syncthreads();
    if (tid < ql) {
      for (int w = 0; w < tr; ++w) run += sTot[w];
      sLa[tid] = run;
    }
    __syncthreads();
    if (tid < ql) {
      sW[tid] = expf(sLa[ql - 1] - sLa[tid]);
      sE[tid] = expf(sLa[tid]);
    }

    for (int rb0 = 0; rb0 < ql; rb0 += RB) {
      // G[i][j] = (C_i . B_j) exp(la_i - la_j) for j <= i, rows rb0.. of
      // this block; columns past the warp's last row are never read
      const int r_lo = rb0 + tr * 4;           // this warp's first row
      const int jj_hi = min(4, r_lo / 32 + 1);
      float g[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sC[(r_lo + i) * LDN + n];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bb[j] = j < jj_hi ? sB[(tc + 32 * j) * LDN + n] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = fmaf(a[i], bb[j], g[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r_lo + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tc + 32 * j;
          if (j < jj_hi) {
            const bool ok = col <= row && row < ql;
            sG[(tr * 4 + i) * LDG + col] =
                ok ? g[i][j] * expf(sLa[row] - sLa[col]) : 0.f;
          }
        }
      }
      __syncthreads();

      // y rows r_lo..r_lo+3: intra-chunk product with x plus the carried
      // state; each x / h element loaded serves the warp's four rows
      if (r_lo < ql) {
        float yi[4][2], ys[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < 2; ++u) yi[i][u] = ys[i][u] = 0.f;
        const int j_end = min(r_lo + 3, ql - 1);  // G is 0 past each row
        for (int j = 0; j <= j_end; ++j) {
          float xv[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int col = tc + 32 * u;
            xv[u] = col < P ? sX[j * P + col] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float gij = sG[(tr * 4 + i) * LDG + j];
#pragma unroll
            for (int u = 0; u < 2; ++u) yi[i][u] = fmaf(gij, xv[u], yi[i][u]);
          }
        }
        for (int n = 0; n < N; ++n) {
          float hv[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int col = tc + 32 * u;
            hv[u] = col < P ? sH[n * P + col] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float cn = sC[(r_lo + i) * LDN + n];
#pragma unroll
            for (int u = 0; u < 2; ++u) ys[i][u] = fmaf(cn, hv[u], ys[i][u]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r_lo + i;
          if (row >= ql) break;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int col = tc + 32 * u;
            if (col < P)
              store(y + (t0 + row) * p.y_ss + col,
                    yi[i][u] + sE[row] * ys[i][u]);
          }
        }
      }
      __syncthreads();          // sG reads done before the next row block
    }

    // state update: h = exp(la_end) h + B^T (x * w); thread owns rows
    // n = tr + 8 * k and columns p = tc + 32 * u of the state
    const float decay = expf(sLa[ql - 1]);
    float acc[16][2];
#pragma unroll
    for (int k = 0; k < 16; ++k)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int n = tr + 8 * k, col = tc + 32 * u;
        acc[k][u] = (n < N && col < P) ? decay * sH[n * P + col] : 0.f;
      }
    for (int j = 0; j < ql; ++j) {
      float xw[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = tc + 32 * u;
        xw[u] = col < P ? sX[j * P + col] * sW[j] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int n = tr + 8 * k;
        const float bn = n < N ? sB[j * LDN + n] : 0.f;
#pragma unroll
        for (int u = 0; u < 2; ++u) acc[k][u] = fmaf(bn, xw[u], acc[k][u]);
      }
    }
#pragma unroll
    for (int k = 0; k < 16; ++k)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int n = tr + 8 * k, col = tc + 32 * u;
        if (n < N && col < P) sH[n * P + col] = acc[k][u];
      }
  }
}

// Always the largest layout's size: the row-block loops may read up to 31
// rows past a short chunk's staged rows (their results are discarded), and
// those reads must stay inside the block's shared memory.
template <typename T>
cudaError_t run(const Params& p, int B, int H, cudaStream_t stream) {
  const size_t smem = smem_bytes(NMAX, PMAX, QMAX);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T><<<dim3(H, B), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, S, H, P), log_a (B, S, H) fp32, b and c (B, S, H, N), y (B, S, H, P):
// x, b, c and y share one dtype, fp32 (is_bf16 == 0) or bf16 (is_bf16 ==
// 1); the last axis of each is contiguous and the others are at the element
// strides in `strides` = {x_sb, x_ss, x_sh, la_sb, la_ss, la_sh, b_sb, b_ss,
// b_sh, c_sb, c_ss, c_sh, y_sb, y_ss, y_sh} (a head stride may be 0).
// N <= 128, P <= 64, 1 <= chunk <= 128.  Runs on `stream`; returns the
// cudaError_t of the launch (0 on success).
int ssd_scan_launch(const void* x, const void* log_a, const void* b,
                    const void* c, void* y, int is_bf16,
                    const long long* strides, int B, int S, int H, int N,
                    int P, int chunk, void* stream) {
  if (N < 1 || N > NMAX || P < 1 || P > PMAX || chunk < 1 || chunk > QMAX)
    return cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.la = static_cast<const float*>(log_a);
  p.b = b;
  p.c = c;
  p.y = y;
  p.x_sb = strides[0];
  p.x_ss = strides[1];
  p.x_sh = strides[2];
  p.la_sb = strides[3];
  p.la_ss = strides[4];
  p.la_sh = strides[5];
  p.b_sb = strides[6];
  p.b_ss = strides[7];
  p.b_sh = strides[8];
  p.c_sb = strides[9];
  p.c_ss = strides[10];
  p.c_sh = strides[11];
  p.y_sb = strides[12];
  p.y_ss = strides[13];
  p.y_sh = strides[14];
  p.S = S;
  p.N = N;
  p.P = P;
  p.Q = chunk < S ? chunk : S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(p, B, H, s) : run<float>(p, B, H, s);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
