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
// at 3.35 TB/s.  So the kernel is bound by operations, and only wgmma
// reaches the tensor cores' full rate on this card.
//
// Two kernels, neither a block-by-block copy of the TPU kernel (whose
// sequential kv grid axis and VMEM scratch do not exist here).  Both loop
// over kv tiles inside one block, with the running max, normaliser and
// accumulator in registers; both skip kv tiles that the causal mask or the
// window removes entirely (about half of a causal layer) and read KV head
// h / G in place through the (B, S, H, D) strides, with no repeated or
// transposed copies.
//
// * bf16 with D = 64 or 128 and every row on a 16-byte boundary (the
//   model's prefill): flash_wgmma_kernel, warp-specialised.
//   - A block takes 128 query rows of one (b, h): two consumer warpgroups
//     of 64 rows each, and one producer warpgroup that gives up its
//     registers (setmaxnreg) and whose one thread issues every TMA load.
//   - Q is loaded once by TMA; K and V tiles of BK = 128 rows go through a
//     2-stage ring in shared memory (Q + 2 x (K + V) = 160 KB at D = 128)
//     with full / empty mbarrier pairs, so the next tile's loads run under
//     this tile's products.  Tiles land 128B-swizzled, the layout wgmma
//     reads; TMA zero-fills rows past Sq and Skv.  The tensor maps are
//     built on the host per launch from the strides the wrapper passes.
//   - S = Q K^T is wgmma m64n128k16 with Q and K from shared memory
//     (K-major); O += P V is wgmma m64nDk16 with P in registers as bf16
//     (the rows' sums use the fp32 values) and V read MN-major, so V is
//     never transposed.
//   - The online softmax runs in base 2 on scores scaled once by
//     scale * log2(e) (ex2.approx); the causal / window / Skv mask is
//     evaluated only on tiles that straddle the diagonal, a window edge or
//     Skv.
//   - Launch order: heaviest causal q tiles first, and the G query heads
//     of one KV head next to each other, so they share K / V tiles in L2.
//   - Each consumer waits for S before its softmax and for P V before the
//     next S.  Keeping S and P V in flight together (the next tile's S
//     issued before this tile's softmax) needs more registers than ptxas
//     gives this code: at BK = 128 it spilled and serialised the wgmmas
//     (C7512), at BK = 96 it fit and still ran slower; so did a 3-stage
//     ring, a ping-pong between the consumer warpgroups and BK = 64
//     (PERF.md).
// * everything else (fp32; bf16 with D = 256, rows off 16-byte boundaries,
//   a zero stride or Skv = 0): flash_attention_kernel, 256 threads as a
//   16 x 16 grid, each owning 4 query rows x 4 keys of the score tile and
//   4 rows x D/16 columns of the accumulator, in fp32 FMA on CUDA cores (no
//   TF32: the fp32 contract is 2e-4).  Row max and sum are reduced with
//   warp shuffles inside 16-lane halves; q and one kv tile (K, then V over
//   it) sit in shared memory as fp32 rows padded to a conflict-free stride.
// Measured times of both are in PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
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
// bf16 on tensor cores (D = 64 or 128): wgmma fed by TMA through an mbarrier
// ring, two consumer warpgroups and one producer warpgroup per block.

namespace wg {

constexpr int BQ = 128;            // query rows per block (2 x 64)
constexpr int BK = 128;            // key rows per kv tile
constexpr int STAGES = 2;          // K / V ring depth
constexpr int NT = 384;            // 2 consumer warpgroups + 1 producer
constexpr int BOX = 64;            // D elements per TMA box: 128 bytes
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
// A wait that outlasts 2^28 polls traps: a lost arrival becomes a launch
// error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One 4-D TMA box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         const int (&c)[4], uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c[0]), "r"(c[1]), "r"(c[2]),
      "r"(c[3]), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------------ wgmma

// Shared-memory matrix descriptor of a 128B-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads of wgmma results above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q . K^T: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64],
    uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O += P . V: A (P, bf16) in registers, B (V) MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
    const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

struct WParams {
  void* o;
  long long o_sb, o_ss, o_sh;       // element strides of o
  int B, Sq, Skv, Hq, Hkv, n_qt;
  int causal, window;
  float scale2;                     // scale * log2(e)
  int qpos[3], kpos[3], vpos[3];    // map dimension of the s, h, b axes
};

template <int D>
constexpr size_t smem_bytes() {     // + 1024 to align the tiles by hand
  return 1024 + size_t(BQ) * D * 2 + size_t(STAGES) * 2 * BK * D * 2 +
         8 * (1 + 3 * STAGES);
}

// Coordinates of one box: D offset, then the (s, h, b) axes at their map
// dimensions.
__device__ __forceinline__ void coords(int (&c)[4], const int (&pos)[3],
                                       int d0, int s, int h, int b) {
  c[0] = d0;
  c[pos[0]] = s;
  c[pos[1]] = h;
  c[pos[2]] = b;
}

// grid = ceil(Sq / BQ) * B * Hq blocks, block = NT threads; bf16 only.
template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const WParams p) {
  constexpr int NBOX = D / BOX;               // boxes across one row
  constexpr int Q_BYTES = BQ * D * 2;
  constexpr int KV_BYTES = BK * D * 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;  // 128B swizzle: 1 KB aligned
  const uint32_t bar = sQ + Q_BYTES + STAGES * 2 * KV_BYTES;
  const uint32_t q_full = bar;
  auto sK = [&](int s) { return sQ + Q_BYTES + s * 2 * KV_BYTES; };
  auto sV = [&](int s) { return sK(s) + KV_BYTES; };
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto v_full = [&](int s) { return bar + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return bar + 8 * (1 + 2 * STAGES + s); };

  // block -> (q tile, b, KV head, query head of its group): heaviest causal
  // tiles first, the G query heads of one KV head side by side
  const int G = p.Hq / p.Hkv;
  int idx = blockIdx.x;
  const int hh = idx % G;
  idx /= G;
  const int hk = idx % p.Hkv;
  idx /= p.Hkv;
  const int b = idx % p.B;
  const int qt = p.n_qt - 1 - idx / p.B;
  const int h = hk * G + hh;
  const int q0 = qt * BQ;

  // the kv tiles any query of this block may see
  const int q_last = min(q0 + BQ, p.Sq) - 1;
  int kv_lo = 0, kv_hi = p.Skv;
  if (p.causal) kv_hi = min(kv_hi, q_last + 1);
  if (p.window > 0) {
    kv_lo = max(0, q0 - p.window + 1);
    if (!p.causal) kv_hi = min(kv_hi, q_last + p.window);
  }
  const int j_lo = kv_lo / BK;
  const int n_tiles = max(0, (kv_hi + BK - 1) / BK - j_lo);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 256);     // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int c[4];
      mbar_expect_tx(q_full, Q_BYTES);
      for (int x = 0; x < NBOX; ++x) {
        coords(c, p.qpos, x * BOX, q0, h, b);
        tma_load(sQ + x * BQ * 128, &tq, c, q_full);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int k0 = (j_lo + i) * BK;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full(s), KV_BYTES);
        for (int x = 0; x < NBOX; ++x) {
          coords(c, p.kpos, x * BOX, k0, hk, b);
          tma_load(sK(s) + x * BK * 128, &tk, c, k_full(s));
        }
        mbar_expect_tx(v_full(s), KV_BYTES);
        for (int x = 0; x < NBOX; ++x) {
          coords(c, p.vpos, x * BOX, k0, hk, b);
          tma_load(sV(s) + x * BK * 128, &tv, c, v_full(s));
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wgi owns query rows q0 + 64 wgi + [0, 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r_lo = q0 + 64 * wgi, r_hi = r_lo + 63;
    const int row0 = r_lo + warp * 16 + g;    // this thread's rows: +0, +8
    const uint32_t qa = sQ + wgi * 64 * 128;

    float o[D / 2], sc[BK / 2];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
    mbar_wait(q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const uint32_t par = (i / STAGES) & 1;
      const int k0 = (j_lo + i) * BK;

      // S = Q K^T (fp32), 16 D columns per wgmma
      mbar_wait(k_full(s), par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;   // bytes into a 128-byte row
        wgmma_ss_n128(sc, desc(qa + (kk / 4) * BQ * 128 + col, 16, 1024),
                      desc(sK(s) + (kk / 4) * BK * 128 + col, 16, 1024),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);

      // scale into base 2; mask only tiles that straddle an edge
      bool edge = k0 + BK > p.Skv;
      if (p.causal) edge = edge || k0 + BK - 1 > r_lo;
      if (p.window > 0) {
        edge = edge || r_hi - k0 >= p.window;
        if (!p.causal) edge = edge || k0 + BK - 1 - r_lo >= p.window;
      }
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) sc[e] *= p.scale2;
      if (edge) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int row = row0 + 8 * ((e >> 1) & 1);
          const int col = k0 + (e >> 2) * 8 + 2 * t + (e & 1);
          bool ok = col < p.Skv;
          if (p.causal) ok = ok && col <= row;
          if (p.window > 0) {
            ok = ok && row - col < p.window;
            if (!p.causal) ok = ok && col - row < p.window;
          }
          if (!ok) sc[e] = NEG_INF;
        }
      }

      // online softmax of rows row0 (r = 0) and row0 + 8 (r = 1); the four
      // threads of a row are lanes 4g .. 4g + 3
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
          mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float corr = ex2(m[r] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sc[4 * n + 2 * r + c];
            x = ex2(x - m_new);
            rs += x;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        l[r] = l[r] * corr + rs;
        m[r] = m_new;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[4 * n + 2 * r] *= corr;
          o[4 * n + 2 * r + 1] *= corr;
        }
      }

      // O += P V: the score registers of n-blocks 2ks, 2ks + 1 are the A
      // fragment of k-step ks
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[ks][e] = pack_bf16(sc[8 * ks + 2 * e], sc[8 * ks + 2 * e + 1]);
      mbar_wait(v_full(s), par);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        // V MN-major: D blocks of 64 are BK * 128 bytes apart, 8-row
        // groups 1024
        const uint64_t dv = desc(sV(s) + ks * 16 * 128, BK * 128, 1024);
        if constexpr (D == 128)
          wgmma_rs_n128(o, pa[ks], dv, 1);
        else
          wgmma_rs_n64(o, pa[ks], dv, 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
      mbar_arrive(empty(s));
    }

    using bf16 = __nv_bfloat16;
    bf16* out = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.Sq) continue;
      const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(out + row * p.o_ss + n * 8 +
                                           2 * t) =
            __floats2bfloat162_rn(o[4 * n + 2 * r] / lc,
                                  o[4 * n + 2 * r + 1] / lc);
    }
  }
}

}  // namespace wg


// ------------------------------------------------------------------- host

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

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &res);
#endif
    return err == cudaSuccess && res == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A 4-D bf16 map over one (B, S, H, D) operand: D innermost, then its s, h
// and b axes in increasing stride (ext / st in that axis order); boxes of
// wg::BOX x `rows` over D and s, 128B-swizzled, zero past the edges.
// pos[a] receives the map dimension of axis a.
cudaError_t make_map(CUtensorMap* map, const void* base, int D,
                     const int (&ext)[3], const long long (&st)[3],
                     int rows, int (&pos)[3]) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  int order[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && st[order[j]] < st[order[j - 1]]; --j) {
      const int tmp = order[j];
      order[j] = order[j - 1];
      order[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {wg::BOX, 1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    const int a = order[i];
    dims[i + 1] = static_cast<cuuint64_t>(ext[a]);
    strides[i] = static_cast<cuuint64_t>(st[a]) * 2;
    pos[a] = i + 1;
    if (a == 0) box[i + 1] = static_cast<cuuint32_t>(rows);
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t run_wgmma(const Params& p, int B, cudaStream_t stream) {
  wg::WParams w{};
  w.o = p.o;
  w.o_sb = p.o_sb;
  w.o_ss = p.o_ss;
  w.o_sh = p.o_sh;
  w.B = B;
  w.Sq = p.Sq;
  w.Skv = p.Skv;
  w.Hq = p.Hq;
  w.Hkv = p.Hkv;
  w.n_qt = (p.Sq + wg::BQ - 1) / wg::BQ;
  w.causal = p.causal;
  w.window = p.window;
  w.scale2 = p.scale * wg::LOG2E;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map(&tq, p.q, D, {p.Sq, p.Hq, B},
                      {p.q_ss, p.q_sh, p.q_sb}, wg::BQ, w.qpos)) ||
      (err = make_map(&tk, p.k, D, {p.Skv, p.Hkv, B},
                      {p.k_ss, p.k_sh, p.k_sb}, wg::BK, w.kpos)) ||
      (err = make_map(&tv, p.v, D, {p.Skv, p.Hkv, B},
                      {p.v_ss, p.v_sh, p.v_sb}, wg::BK, w.vpos)))
    return err;
  const size_t smem = wg::smem_bytes<D>();
  err = cudaFuncSetAttribute(wg::flash_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(w.n_qt) * B * p.Hq;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  wg::flash_wgmma_kernel<D><<<static_cast<unsigned>(blocks), wg::NT, smem,
                              stream>>>(tq, tk, tv, w);
  return cudaGetLastError();
}

// The tensor-core kernel loads rows by TMA: every row of q, k and v must
// start on a 16-byte boundary (the model's contiguous heads do), with
// every stride a non-zero multiple of 16 bytes, and there must be keys.
bool tma_ready(const Params& p) {
  const long long st[] = {p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss, p.k_sh,
                          p.v_sb, p.v_ss, p.v_sh, p.o_sb, p.o_ss, p.o_sh};
  for (long long s : st)
    if (s <= 0 || s % 8) return false;
  const void* ptrs[] = {p.q, p.k, p.v, p.o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  return p.Skv > 0;
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
  if (tma_ready(p)) {
    if (D == 64) return run_wgmma<64>(p, B, stream);
    if (D == 128) return run_wgmma<128>(p, B, stream);
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
