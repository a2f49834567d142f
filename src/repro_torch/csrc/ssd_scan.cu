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
//     y_i   = exp(la_i) C_i . h                                   (inter)
//           + sum_{j <= i} (C_i . B_j) exp(la_i - la_j) x_j       (intra)
//     h_new = exp(la_end) h + sum_j (B_j exp(la_end - la_j)) x_j^T
//
// the reference's formulation.  y has x's dtype; log_a is fp32.
//
// Bound on an H100 SXM at the timed shape (B=2, S=4096, H=256 heads, Q=128,
// N=128, P=64, bf16): per chunk and head Q(Q+1)/2 (N + P) multiply-adds for
// the masked intra-chunk products and 2 Q N P for the inter-chunk term and
// the state update, 1.2e11 operations in all, 0.12 ms at 989 TFLOP/s; x
// and y (268 MB each), log_a (8 MB) and the shared B and C (4 MB) move
// 0.55 GB, 0.16 ms at 3.35 TB/s.  So the kernel sits near the ridge, bound
// by bytes.
//
// bf16 (the model's route), ssd_scan_tc_kernel:
//   * Heads that share B and C.  The model passes one B and one C for all
//     heads (head stride 0); then a block takes GH = 2 heads of one batch
//     row, stages each chunk's B and C once and forms C.B^T once, in
//     registers: warp w of 8 owns rows 16w..16w+15 of the (Q, Q) product
//     and computes only the column blocks on or below its diagonal.  Per
//     head it applies the decay mask exp(la_i - la_j) to those registers,
//     then does G.x, C.h and the state update.  Per-head B and C take
//     GH = 1, and so do shared ones when one head per block ends sooner
//     (few heads: one block runs per SM, and GH = 2 halves the blocks).
//     The grid is (ceil(H / GH), B): 256 blocks at B=2, H=256 and 128 at
//     B=1, for 132 SMs.  Two heads per block take about 6% less time than
//     one on the Jamba prefills (PERF.md).
//   * Tensor cores: all four products are bf16 mma.sync m16n8k16 with fp32
//     accumulators, operands from swizzled shared memory by ldmatrix
//     (conflict-free).  x, B and C are bf16 and enter exactly.  The fp32
//     operands (the decay-weighted product, B scaled by exp(la_end - la_j),
//     the state h) are each split into bf16 hi + lo pairs and multiplied
//     twice, so every product keeps ~16 bits: rounding any one of the
//     three to bf16 once instead fails the bf16 contract (rtol 2e-2, atol
//     2e-3) on the Jamba prefill's own operands (SPLIT_G / SPLIT_W /
//     SPLIT_H below; tools/kernel_ab.py, numbers in PERF.md).  The
//     products thus do about twice the operations above, 0.24 ms at the
//     tensor cores' peak against the bytes' 0.16 ms.
//   * State: each head's (N, P) fp32 state is the master copy in the
//     accumulator registers of the warps that update it (warp w owns rows
//     16w..16w+15 of N); before each head's C.h it is written to a shared
//     exchange tile as bf16 hi / lo, which every warp reads.
//   * Loads overlap products: chunk t+1's x, B, C (bf16, 16-byte cp.async,
//     zero-filled past the chunk's rows and the N / P widths) and log_a
//     (4-byte cp.async) land in the other stage of a 2-stage ring while
//     chunk t is multiplied.  Rows not on 16-byte boundaries take element
//     loads into the same tiles.  Shared memory: 2 stages x 97 KB + the
//     32 KB exchange tile, 226 KB.
//   * Measured on an H100: about a tenth of the bound.  Copies of the
//     kernel with parts taken out showed the loads are not the limit: the
//     chains of ldmatrix, exp, hi / lo split and mma.sync are, with one
//     block of 8 warps per SM (241 registers, 226 KB) to hide them.
// fp32, ssd_scan_fma_kernel (the contract is 2e-4, no TF32): one block per
// (b, h) loops over the chunks with the fp32 state in shared memory; the
// (Q, Q) product is built 32 rows at a time in fp32 FMA from shared memory
// (211 KB, one block per SM).  Only the fp32 prefill and the tests take it.
// It keeps that design: fp32 B and C take 128 KB per stage, which leaves
// no room for a second head or a ring in 227 KB, and tensor cores would
// need each fp32 operand split in three bf16 products, which emulated on
// the fp32 prefill's operands used 97% of the 2e-4 tolerance (PERF.md).
// Measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

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

// ------------------------------------------------------------------ fp32

constexpr int NT = 256;      // threads per block
constexpr int QMAX = 128;    // largest chunk
constexpr int NMAX = 128;    // largest state width N
constexpr int PMAX = 64;     // largest head width P
constexpr int RB = 32;       // rows of the (Q, Q) product built at a time
constexpr int LDG = QMAX + 1;


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
__global__ void __launch_bounds__(NT) ssd_scan_fma_kernel(Params p) {
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

  const float* x = static_cast<const float*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* la = p.la + b * p.la_sb + h * p.la_sh;
  const float* bm = static_cast<const float*>(p.b) + b * p.b_sb + h * p.b_sh;
  const float* cm = static_cast<const float*>(p.c) + b * p.c_sb + h * p.c_sh;
  float* y = static_cast<float*>(p.y) + b * p.y_sb + h * p.y_sh;

  for (int e = tid; e < N * P; e += NT) sH[e] = 0.f;

  for (int t0 = 0; t0 < p.S; t0 += Q) {
    const int ql = min(Q, p.S - t0);          // rows of this chunk
    __syncthreads();            // last chunk's state update and reads done
    for (int e = tid; e < ql * P; e += NT) {
      const int r = e / P, col = e % P;
      sX[r * P + col] = x[(t0 + r) * p.x_ss + col];
    }
    for (int e = tid; e < ql * N; e += NT) {
      const int r = e / N, col = e % N;
      sB[r * LDN + col] = bm[(t0 + r) * p.b_ss + col];
      sC[r * LDN + col] = cm[(t0 + r) * p.c_ss + col];
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
              y[(t0 + row) * p.y_ss + col] = yi[i][u] + sE[row] * ys[i][u];
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
cudaError_t run_fma(const Params& p, int B, int H, cudaStream_t stream) {
  const size_t smem = smem_bytes(NMAX, PMAX, QMAX);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_scan_fma_kernel<<<dim3(H, B), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;                    // 8 warps
constexpr int QT = 128;                    // rows of a chunk tile
constexpr int NTL = 128;                   // state width tile (N padded)
constexpr int PT = 64;                     // head width tile (P padded)
constexpr int GMAX = 2;                    // heads per block
// Which fp32 operands enter their products as a bf16 hi + lo pair (two
// mma.sync, ~16 bits kept) rather than rounded once to bf16 (8 bits): the
// decay-weighted (Q, Q) tile of G.x, B scaled by exp(la_end - la_j) in the
// state update, and the state h in C.h.  x, B and C are exact in bf16.
// Each is needed: one rounding of any one of them fails the bf16 contract
// on the Jamba prefill's operands (tools/kernel_ab.py builds the variants).
constexpr bool SPLIT_G = true;
constexpr bool SPLIT_W = true;
constexpr bool SPLIT_H = true;
constexpr int CB_BYTES = QT * NTL * 2;     // sC or sB: [QT][NTL] bf16
constexpr int X_BYTES = QT * PT * 2;       // sX of one head: [QT][PT] bf16
constexpr int LA_BYTES = QT * 4;           // log_a of one head: [QT] fp32
constexpr int STAGE = 2 * CB_BYTES + GMAX * (X_BYTES + LA_BYTES);
constexpr int E_HALF = NTL * PT * 2;       // one of the state's hi / lo
constexpr int SMEM = 2 * STAGE + (SPLIT_H ? 2 : 1) * E_HALF + GMAX * 4 * 4;

// Byte offset of (row, col) in a tile of 256- or 128-byte bf16 rows: the
// 16-byte unit is XORed with row % 8, so the 8 rows an ldmatrix phase
// reads fall on 8 distinct bank groups.
__device__ __forceinline__ int off256(int row, int col) {
  const int u = col >> 3;
  return row * 256 + (((u ^ row) & 7) | (u & 8)) * 16 + (col & 7) * 2;
}
__device__ __forceinline__ int off128(int row, int col) {
  return row * 128 + (((col >> 3) ^ row) & 7) * 16 + (col & 7) * 2;
}

__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm4t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a . b on one m16n8k16 tile, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the low / high bf16 of a pair, as fp32
__device__ __forceinline__ float low_half(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float high_half(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
// (u, v) as one bf16 pair (u in the low half), rounded to nearest
__device__ __forceinline__ uint32_t pack(float u, float v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// (u, v) as two bf16 pairs hi + lo: their sum keeps ~16 bits of each value
__device__ __forceinline__ void split(float u, float v, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack(u, v);
  lo = pack(u - low_half(hi), v - high_half(hi));
}

// Stage chunk c (x of the block's ng heads, its B and C, log_a) into stage
// c % 2; rows past the chunk and columns past N / P are zero.
__device__ __forceinline__ void load_chunk(const Params& p, unsigned char* st,
                                           int c, int ng, bool vec,
                                           const bf16* xg, const float* lag,
                                           const bf16* bg, const bf16* cg) {
  const int tid = threadIdx.x;
  const int t0 = c * p.Q, ql = min(p.Q, p.S - t0);
  unsigned char* sC = st;
  unsigned char* sB = st + CB_BYTES;
  unsigned char* sX = st + 2 * CB_BYTES;
  if (vec) {
    for (int e = tid; e < QT * 16; e += NT) {
      const int row = e >> 4, col = (e & 15) * 8;
      const bool ok = row < ql && col < p.N;
      const long long r = t0 + row;
      cp_async16(sC + off256(row, col), ok ? cg + r * p.c_ss + col : cg,
                 ok ? 16 : 0);
      cp_async16(sB + off256(row, col), ok ? bg + r * p.b_ss + col : bg,
                 ok ? 16 : 0);
    }
    for (int e = tid; e < ng * QT * 8; e += NT) {
      const int gi = e / (QT * 8), row = (e >> 3) % QT, col = (e & 7) * 8;
      const bool ok = row < ql && col < p.P;
      cp_async16(sX + gi * X_BYTES + off128(row, col),
                 ok ? xg + gi * p.x_sh + (t0 + row) * p.x_ss + col : xg,
                 ok ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < QT * NTL; e += NT) {
      const int row = e / NTL, col = e % NTL;
      const bool ok = row < ql && col < p.N;
      const long long r = t0 + row;
      *reinterpret_cast<bf16*>(sC + off256(row, col)) =
          ok ? cg[r * p.c_ss + col] : zero;
      *reinterpret_cast<bf16*>(sB + off256(row, col)) =
          ok ? bg[r * p.b_ss + col] : zero;
    }
    for (int e = tid; e < ng * QT * PT; e += NT) {
      const int gi = e / (QT * PT), row = (e / PT) % QT, col = e % PT;
      const bool ok = row < ql && col < p.P;
      *reinterpret_cast<bf16*>(sX + gi * X_BYTES + off128(row, col)) =
          ok ? xg[gi * p.x_sh + (t0 + row) * p.x_ss + col] : zero;
    }
  }
  unsigned char* sLa = sX + GMAX * X_BYTES;
  for (int e = tid; e < ng * QT; e += NT) {
    const int gi = e / QT, row = e % QT;
    const bool ok = row < ql;
    cp_async4(sLa + gi * LA_BYTES + row * 4,
              ok ? lag + gi * p.la_sh + (t0 + row) * p.la_ss : lag,
              ok ? 4 : 0);
  }
}

// grid = (ceil(H / gh), B), block = NT threads, SMEM bytes of shared memory;
// gh heads per block (2 only when B and C have head stride 0).
__global__ void __launch_bounds__(NT, 1)
    ssd_scan_tc_kernel(const Params p, int H, int gh, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* E = smem + 2 * STAGE;              // state (hi, then lo)
  float* sTot = reinterpret_cast<float*>(E + (SPLIT_H ? 2 : 1) * E_HALF);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;            // mma fragment coords
  const int r0 = 16 * warp;                          // this warp's rows
  const int h0 = blockIdx.x * gh, bi = blockIdx.y;
  const int ng = min(gh, H - h0);
  const int n_chunks = (p.S + p.Q - 1) / p.Q;

  const bf16* xg = static_cast<const bf16*>(p.x) + bi * p.x_sb + h0 * p.x_sh;
  const float* lag = p.la + bi * p.la_sb + h0 * p.la_sh;
  const bf16* bg = static_cast<const bf16*>(p.b) + bi * p.b_sb + h0 * p.b_sh;
  const bf16* cg = static_cast<const bf16*>(p.c) + bi * p.c_sb + h0 * p.c_sh;
  bf16* yg = static_cast<bf16*>(p.y) + bi * p.y_sb + h0 * p.y_sh;

  // lane offsets of the ldmatrix addresses: rows of an A tile (and of a
  // transposed B tile), and of a B tile stored n-major
  const int la_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int la_col = (lane >> 4) * 8;
  const int nb_row = (lane & 7) + (lane >> 4) * 8;
  const int nb_col = ((lane >> 3) & 1) * 8;

  // master copy of each head's state: rows r0 + g (+8) of N, columns
  // 8 nt + 2 t (+1) of P
  float hs[GMAX][8][4];
#pragma unroll
  for (int gi = 0; gi < GMAX; ++gi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hs[gi][nt][e] = 0.f;

  load_chunk(p, smem, 0, ng, vec, xg, lag, bg, cg);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();            // chunk c-1 is done with the other stage
    if (c + 1 < n_chunks)
      load_chunk(p, smem + ((c + 1) & 1) * STAGE, c + 1, ng, vec, xg, lag,
                 bg, cg);
    cp_async_commit();
    cp_async_wait<1>();         // chunk c landed
    __syncthreads();
    unsigned char* st = smem + (c & 1) * STAGE;
    const uint32_t sC = smem_addr(st), sB = sC + CB_BYTES;
    float* sLa = reinterpret_cast<float*>(st + 2 * CB_BYTES + GMAX * X_BYTES);
    const int t0 = c * p.Q, ql = min(p.Q, p.S - t0);

    // within-chunk inclusive cumulative sum of each head's log_a, in place:
    // four warps per head scan 32 rows each, then add the warps' totals
    const int sg = warp >> 2, part = warp & 3;
    float run = 0.f;
    if (sg < ng) {
      run = sLa[sg * QT + part * 32 + lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += u;
      }
      if (lane == 31) sTot[sg * 4 + part] = run;
    }
    __syncthreads();
    if (sg < ng) {
      for (int w = 0; w < part; ++w) run += sTot[sg * 4 + w];
      sLa[sg * QT + part * 32 + lane] = run;
    }
    __syncthreads();

    // C.B^T for this warp's rows, once for all heads of the block; column
    // blocks past the diagonal are never needed
    const bool live = r0 < ql;
    float sacc[16][4];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.f;
    if (live) {
#pragma unroll
      for (int kk = 0; kk < NTL / 16; ++kk) {
        if (kk * 16 >= p.N) break;
        uint32_t a[4];
        ldsm4(sC + off256(r0 + la_row, kk * 16 + la_col), a);
#pragma unroll
        for (int np = 0; np < QT / 16; ++np) {
          if (np > warp) break;
          uint32_t bb[4];
          ldsm4(sB + off256(np * 16 + nb_row, kk * 16 + nb_col), bb);
          mma(sacc[2 * np], a, bb[0], bb[1]);
          mma(sacc[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }

#pragma unroll
    for (int gi = 0; gi < GMAX; ++gi) {
      if (gi >= ng) break;
      const float* la = sLa + gi * QT;
      const uint32_t sX = sC + 2 * CB_BYTES + gi * X_BYTES;
      const float la_end = la[ql - 1];
      if (gi > 0) __syncthreads();      // the last head's reads of E done
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float u = hs[gi][nt][2 * half], v = hs[gi][nt][2 * half + 1];
          const int o = off128(r0 + g + 8 * half, nt * 8 + 2 * t);
          if constexpr (SPLIT_H) {
            uint32_t hi, lo;
            split(u, v, hi, lo);
            *reinterpret_cast<uint32_t*>(E + o) = hi;
            *reinterpret_cast<uint32_t*>(E + E_HALF + o) = lo;
          } else {
            *reinterpret_cast<uint32_t*>(E + o) = pack(u, v);
          }
        }
      __syncthreads();
      const uint32_t eh = smem_addr(E), el = eh + E_HALF;

      if (live) {
        float y[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) y[nt][e] = 0.f;
        // inter-chunk term: C . h (h_hi + h_lo when split), scaled by
        // exp(la_i)
#pragma unroll
        for (int kk = 0; kk < NTL / 16; ++kk) {
          if (kk * 16 >= p.N) break;
          uint32_t a[4];
          ldsm4(sC + off256(r0 + la_row, kk * 16 + la_col), a);
#pragma unroll
          for (int np = 0; np < PT / 16; ++np) {
            if (np * 16 >= p.P) break;
            const int o = off128(kk * 16 + la_row, np * 16 + la_col);
            uint32_t bh[4];
            ldsm4t(eh + o, bh);
            mma(y[2 * np], a, bh[0], bh[1]);
            mma(y[2 * np + 1], a, bh[2], bh[3]);
            if constexpr (SPLIT_H) {
              uint32_t bl[4];
              ldsm4t(el + o, bl);
              mma(y[2 * np], a, bl[0], bl[1]);
              mma(y[2 * np + 1], a, bl[2], bl[3]);
            }
          }
        }
        const int i0 = r0 + g, i1 = i0 + 8;
        const float la0 = la[i0], la1 = la[i1];
        const float e0 = __expf(la0), e1 = __expf(la1);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          y[nt][0] *= e0;
          y[nt][1] *= e0;
          y[nt][2] *= e1;
          y[nt][3] *= e1;
        }
        // intra-chunk term: (C.B^T o exp(la_i - la_j), j <= i) . x, the
        // weighted product turned into bf16 A fragments in place (hi + lo
        // when split)
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk) {
          if (kk > warp) break;
          const int j0 = kk * 16 + 2 * t;
          const float lj[4] = {la[j0], la[j0 + 1], la[j0 + 8], la[j0 + 9]};
          const int jj[4] = {j0, j0 + 1, j0 + 8, j0 + 9};
          float gv[4][2];     // fragment register r holds (row, j pair)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int tile = 2 * kk + (r >> 1);
            const int i = (r & 1) ? i1 : i0;
            const float lai = (r & 1) ? la1 : la0;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int q = (r >> 1) * 2 + u;
              const float s = sacc[tile][(r & 1) * 2 + u];
              gv[r][u] = jj[q] <= i ? s * __expf(lai - lj[q]) : 0.f;
            }
          }
          uint32_t ah[4], al[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if constexpr (SPLIT_G)
              split(gv[r][0], gv[r][1], ah[r], al[r]);
            else
              ah[r] = pack(gv[r][0], gv[r][1]);
          }
#pragma unroll
          for (int np = 0; np < PT / 16; ++np) {
            if (np * 16 >= p.P) break;
            uint32_t xb[4];
            ldsm4t(sX + off128(kk * 16 + la_row, np * 16 + la_col), xb);
            mma(y[2 * np], ah, xb[0], xb[1]);
            mma(y[2 * np + 1], ah, xb[2], xb[3]);
            if constexpr (SPLIT_G) {
              mma(y[2 * np], al, xb[0], xb[1]);
              mma(y[2 * np + 1], al, xb[2], xb[3]);
            }
          }
        }
        bf16* yo = yg + gi * p.y_sh;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = nt * 8 + 2 * t;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = i0 + 8 * half;
            if (row < ql && col < p.P) {
              bf16* dst = yo + (t0 + row) * p.y_ss + col;
              const float u = y[nt][2 * half], v = y[nt][2 * half + 1];
              if (vec) {
                *reinterpret_cast<__nv_bfloat162*>(dst) =
                    __floats2bfloat162_rn(u, v);
              } else {
                dst[0] = __float2bfloat16(u);
                if (col + 1 < p.P) dst[1] = __float2bfloat16(v);
              }
            }
          }
        }
      }

      // state update of this warp's rows of N: h = exp(la_end) h +
      // (B o w)^T . x with w_j = exp(la_end - la_j); A = B^T read
      // transposed from sB, scaled and rounded to bf16 (hi + lo when
      // split)
      const float dec = __expf(la_end);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) hs[gi][nt][e] *= dec;
      if (r0 < p.N) {
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk) {
          if (kk * 16 >= ql) break;
          uint32_t ab[4];
          ldsm4t(sB + off256(kk * 16 + nb_row, r0 + nb_col), ab);
          const int j0 = kk * 16 + 2 * t;
          const float w0 = __expf(la_end - la[j0]);
          const float w1 = __expf(la_end - la[j0 + 1]);
          const float w2 = __expf(la_end - la[j0 + 8]);
          const float w3 = __expf(la_end - la[j0 + 9]);
          const float wv[4][2] = {
              {low_half(ab[0]) * w0, high_half(ab[0]) * w1},
              {low_half(ab[1]) * w0, high_half(ab[1]) * w1},
              {low_half(ab[2]) * w2, high_half(ab[2]) * w3},
              {low_half(ab[3]) * w2, high_half(ab[3]) * w3}};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if constexpr (SPLIT_W)
              split(wv[r][0], wv[r][1], ah[r], al[r]);
            else
              ah[r] = pack(wv[r][0], wv[r][1]);
          }
#pragma unroll
          for (int np = 0; np < PT / 16; ++np) {
            if (np * 16 >= p.P) break;
            uint32_t xb[4];
            ldsm4t(sX + off128(kk * 16 + la_row, np * 16 + la_col), xb);
            mma(hs[gi][2 * np], ah, xb[0], xb[1]);
            mma(hs[gi][2 * np + 1], ah, xb[2], xb[3]);
            if constexpr (SPLIT_W) {
              mma(hs[gi][2 * np], al, xb[0], xb[1]);
              mma(hs[gi][2 * np + 1], al, xb[2], xb[3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

bool on16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// Heads per block: GMAX where B and C are shared, unless one head per
// block ends sooner.  One block runs per SM, so a launch takes about
// (waves of blocks) x (heads per block) head-times; a block of GMAX heads
// costs a little less than GMAX blocks of one (B, C and C.B^T are shared),
// so a tie goes to GMAX.
int heads_per_block(const Params& p, int B, int H, int sms) {
  if (p.b_sh != 0 || p.c_sh != 0 || H < 2) return 1;
  auto cost = [&](int g) {
    const long long blocks = static_cast<long long>(B) * ((H + g - 1) / g);
    return (blocks + sms - 1) / sms * g;
  };
  return cost(GMAX) <= cost(1) ? GMAX : 1;
}

cudaError_t run(const Params& p, int B, int H, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int gh = heads_per_block(p, B, H, sms);
  // 16-byte rows: every pointer, stride and width on 8 bf16 elements
  const long long strides[] = {p.x_sb, p.x_ss, p.x_sh, p.b_sb, p.b_ss,
                               p.b_sh, p.c_sb, p.c_ss, p.c_sh, p.y_sb,
                               p.y_ss, p.y_sh};
  bool vec = on16(p.x) && on16(p.b) && on16(p.c) && on16(p.y) &&
             p.N % 8 == 0 && p.P % 8 == 0;
  for (long long s : strides) vec = vec && s % 8 == 0;
  err = cudaFuncSetAttribute(
      ssd_scan_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  ssd_scan_tc_kernel<<<dim3((H + gh - 1) / gh, B), NT, SMEM, stream>>>(
      p, H, gh, vec ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace tc

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
  return is_bf16 ? tc::run(p, B, H, s) : run_fma(p, B, H, s);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
