// Flash attention forward for Hopper (sm_90a): every attention head of a
// prefill layer in one launch.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash/flash_attention.py (kernel at :27, pallas_call at
// :104), which the reference runs once per (batch, head) under vmap.  Here
// one launch covers all of them:
//
//     o[b, i, h] = sum_j softmax_j(s_ij) v[b, j, h / G]
//     s_ij = scale * q[b, i, h] . k[b, j, h / G]      (G = Hq / Hkv, GQA)
//
// masked as the reference masks: causal keeps j <= i, a window w > 0 keeps
// i - j < w (and j - i < w when not causal), and key rows past Skv never
// win.  Masked scores are -1e30 and the normaliser is clamped at 1e-30, as
// in the reference.  Scores, the running max / normaliser and the output
// accumulator are fp32; the output has q's dtype.
//
// Bound on an H100 SXM at the timed prefill shape (B=2, S=4096, Hq=64,
// Hkv=8, D=128, causal, bf16): 4 * D operations for each of the
// B*Hq*S*(S+1)/2 unmasked (query, key) pairs, 5.5e11 in all, take 0.56 ms at
// the 989 TFLOP/s bf16 tensor-core rate; q, k, v and o move 0.3 GB, 0.09 ms
// at 3.35 TB/s.  So the kernel is bound by operations.
//
// What this simple design does about that bound (not a block-by-block copy
// of the TPU kernel, whose sequential kv grid axis and VMEM scratch do not
// exist here):
//   * One thread block takes one (b, h) and a tile of BQ = 64 query rows and
//     loops over kv tiles of BK = 64 rows; the running max, normaliser and
//     accumulator stay in registers across the loop.  That loop replaces
//     the TPU's sequential j axis.  Blocks start with the heaviest causal
//     tiles so the tail of the grid is short.
//   * kv tiles that the causal mask or the window removes entirely are
//     never loaded: about half of the work of a causal layer, and all but
//     ~window/S of a windowed one.
//   * q, k and v are read through their (B, S, H, D) strides, and KV head
//     h / G directly: no transposed or repeated copies.
//   * fp32 inputs (and bf16 with D = 256 or rows off 16-byte boundaries):
//     256 threads form a 16 x 16 grid; each owns 4 query rows x 4 keys of
//     the score tile and 4 rows x D/16 columns of the accumulator, in fp32
//     FMA on CUDA cores (no TF32: the fp32 contract is 2e-4).  Row max and
//     sum are reduced with warp shuffles inside 16-lane halves.  The q tile
//     and one kv tile (K, then V over it) sit in shared memory as fp32 rows
//     padded to a conflict-free stride; shared-memory bandwidth bounds the
//     inner loops, far below the tensor-core rate.
//   * bf16 with D = 64 or 128 (the model's prefill): both products on the
//     tensor cores as warp-level mma.sync, the FA2 arrangement (see
//     flash_attention_mma_kernel below).  Loads are not pipelined and wgmma
//     is not used: later work.  Measured times of both are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key rows per kv tile
constexpr int NT = 256;      // threads per block: a 16 x 16 grid
constexpr int LDP = BK + 1;  // probability tile row stride (floats)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;  // element strides; the D axis is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int Sq, Skv, Hq, Hkv;
  int causal, window;
  float scale;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) +
                          size_t(BQ) * LDP);
}

// Stage `rows` rows of D elements starting at row r0 of `src` (row stride
// ss) into dst[r][c] (row stride D + 1) as fp32; rows at or past `n` are 0.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int r0, int rows, int n) {
  for (int e = threadIdx.x; e < rows * D; e += NT) {
    const int r = e / D, c = e % D;
    const int row = r0 + r;
    dst[r * (D + 1) + c] = row < n ? to_f32(src[row * ss + c]) : 0.f;
  }
}

// grid = (ceil(Sq / BQ), Hq, B), block = NT threads.
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_attention_kernel(Params p) {
  constexpr int LD = D + 1;     // staged row stride (floats)
  constexpr int DC = D / 16;    // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                 // [BQ][LD]
  float* sKV = sQ + BQ * LD;        // [BK][LD]: the K tile, then the V tile
  float* sP = sKV + BK * LD;        // [BQ][LDP]

  const int tc = threadIdx.x & 15, tr = threadIdx.x >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * BQ;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  stage<T, D>(sQ, q, p.q_ss, q0, BQ, p.Sq);

  // the kv rows any query of this tile may see
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int kv_lo = 0, kv_hi = p.Skv;
  if (p.causal) kv_hi = min(kv_hi, q_last + 1);
  if (p.window > 0) {
    kv_lo = max(0, q0 - p.window + 1);
    if (!p.causal) kv_hi = min(kv_hi, q_last + p.window);
  }
  const int j_lo = kv_lo / BK, j_hi = (kv_hi + BK - 1) / BK;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int jt = j_lo; jt < j_hi; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();              // sQ staged / last tile's V reads done
    stage<T, D>(sKV, k, p.k_ss, k0, BK, p.Skv);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(tr * 4 + i) * LD + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = sKV[(tc + 16 * j) * LD + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }

    // mask, then the online-softmax update of each of this thread's rows;
    // the 16 threads of one row group are one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tc + 16 * j;
        bool ok = col < p.Skv;
        if (p.causal) ok = ok && col <= row;
        if (p.window > 0) {
          ok = ok && row - col < p.window;
          if (!p.causal) ok = ok && col - row < p.window;
        }
        s[i][j] = ok ? s[i][j] * p.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sP[(tr * 4 + i) * LDP + tc + 16 * j] = s[i][j];
    }
    __syncthreads();              // K reads done, P written
    stage<T, D>(sKV, v, p.v_ss, k0, BK, p.Skv);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(tr * 4 + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = sKV[kk * LD + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= p.Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(o + row * p.o_ss + tc + 16 * c, acc[i][c] / lc);
  }
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores (D = 64 or 128): the same tiling, with the two
// products as warp-level mma.sync m16n8k16 (bf16 in, fp32 accumulate).  Four
// warps each own 16 query rows of the 64-row tile; the q fragments stay in
// registers for the whole kv loop, S and the output accumulator are mma
// fragments, and P is rounded to bf16 for the second product (the rows'
// sums use the fp32 values).  K and V tiles are staged as bf16 in shared
// memory, rows padded by 16 bytes so ldmatrix reads are conflict-free.

constexpr int MMA_NT = 128;  // threads per block: four warps

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b for one m16n8k16 tile: a (16 x 16, row), b (16 x 8, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage `rows` rows of D bf16 starting at row r0 of `src` into dst (row
// stride LDS) in 16-byte vectors; rows at or past `n` are 0.
template <int D, int LDS>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long ss, int r0, int rows,
                                           int n) {
  constexpr int V = D / 8;
  for (int e = threadIdx.x; e < rows * V; e += MMA_NT) {
    const int r = e / V, c = (e % V) * 8;
    const int row = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < n) val = *reinterpret_cast<const uint4*>(src + row * ss + c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
}

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * size_t(BQ + 2 * BK) * (D + 8);
}

// grid = (ceil(Sq / BQ), Hq, B), block = MMA_NT threads; bf16 only.
template <int D>
__global__ void __launch_bounds__(MMA_NT)
flash_attention_mma_kernel(Params p) {
  constexpr int LDS = D + 8;      // staged row stride (bf16 elements)
  constexpr int KQ = D / 16;      // k-steps of q . k
  constexpr int NS = BK / 8;      // n-tiles of one score row block
  constexpr int NO = D / 8;       // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * LDS;
  __nv_bfloat16* sV = sK + BK * LDS;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int q0 = qt * BQ;

  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  stage_bf16<D, LDS>(sQ, q, p.q_ss, q0, BQ, p.Sq);
  __syncthreads();
  uint32_t qa[KQ][4];             // this warp's 16 query rows, all of D
#pragma unroll
  for (int ks = 0; ks < KQ; ++ks)
    ldsm_x4(qa[ks], sQ + (warp * 16 + (lane & 15)) * LDS + ks * 16 +
                        (lane >> 4) * 8);

  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int kv_lo = 0, kv_hi = p.Skv;
  if (p.causal) kv_hi = min(kv_hi, q_last + 1);
  if (p.window > 0) {
    kv_lo = max(0, q0 - p.window + 1);
    if (!p.causal) kv_hi = min(kv_hi, q_last + p.window);
  }
  const int j_lo = kv_lo / BK, j_hi = (kv_hi + BK - 1) / BK;

  // rows r = 0, 1 of this thread: query rows g and g + 8 of the warp's 16
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int jt = j_lo; jt < j_hi; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();              // the last tile's K / V reads are done
    stage_bf16<D, LDS>(sK, k, p.k_ss, k0, BK, p.Skv);
    stage_bf16<D, LDS>(sV, v, p.v_ss, k0, BK, p.Skv);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KQ; ++ks) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, sK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDS +
                        ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa[ks], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa[ks], kb[2], kb[3]);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      float mx = NEG_INF;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = k0 + n * 8 + 2 * t + c;
          bool ok = col < p.Skv;
          if (p.causal) ok = ok && col <= row;
          if (p.window > 0) {
            ok = ok && row - col < p.window;
            if (!p.causal) ok = ok && col - row < p.window;
          }
          float& x = s[n][2 * r + c];
          x = ok ? x * p.scale : NEG_INF;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[n][2 * r + c];
          x = expf(x - m_new);
          rs += x;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[r] = l[r] * corr + rs;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    // acc += P . V: the score fragments of n-tiles 2ks, 2ks+1 are the A
    // fragment of k-step ks
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * ks][0], s[2 * ks][1]),
          pack_bf16(s[2 * ks][2], s[2 * ks][3]),
          pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
          pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, sV + (ks * 16 + (lane & 7) +
                                ((lane >> 3) & 1) * 8) * LDS +
                              np * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= p.Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      __nv_bfloat162 val = __floats2bfloat162_rn(acc[n][2 * r] / lc,
                                                 acc[n][2 * r + 1] / lc);
      *reinterpret_cast<__nv_bfloat162*>(o + row * p.o_ss + n * 8 + 2 * t) =
          val;
    }
  }
}

template <typename T, int D>
cudaError_t run(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, B);
  flash_attention_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t run_mma(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, B);
  flash_attention_mma_kernel<D><<<grid, MMA_NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// The tensor-core kernel stages rows as 16-byte vectors: every row of q, k
// and v must start on a 16-byte boundary (the model's contiguous heads do).
bool rows_16b_aligned(const Params& p) {
  const long long st[] = {p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss, p.k_sh,
                          p.v_sb, p.v_ss, p.v_sh, p.o_sb, p.o_ss, p.o_sh};
  for (long long s : st)
    if (s % 8) return false;
  const void* ptrs[] = {p.q, p.k, p.v, p.o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  return true;
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return run<T, 64>(p, B, stream);
    case 128: return run<T, 128>(p, B, stream);
    case 256: return run<T, 256>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bf16(const Params& p, int B, int D,
                          cudaStream_t stream) {
  if (rows_16b_aligned(p)) {
    if (D == 64) return run_mma<64>(p, B, stream);
    if (D == 128) return run_mma<128>(p, B, stream);
  }
  return dispatch<__nv_bfloat16>(p, B, D, stream);
}

}  // namespace

extern "C" {

// q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), o (B, Sq, Hq, D): one dtype,
// fp32 (is_bf16 == 0) or bf16 (is_bf16 == 1), each with a contiguous D axis
// and the other axes at the element strides in `strides` = {q_sb, q_ss,
// q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh}.  D is 64, 128
// or 256 and Hkv divides Hq.  Runs on `stream`; returns the cudaError_t of
// the launch (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int is_bf16, const long long* strides,
                           int B, int Sq, int Skv, int Hq, int Hkv, int D,
                           int causal, int window, float scale,
                           void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.Sq = Sq;
  p.Skv = Skv;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_bf16(p, B, D, s)
                 : dispatch<float>(p, B, D, s);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
