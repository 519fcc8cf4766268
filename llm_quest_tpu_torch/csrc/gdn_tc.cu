// The chunked gated delta rule for bf16 inputs on Hopper's tensor cores
// (sm_90a): K1's forward and its backward. gdn.cu's C entry points send
// every bf16 prefill here and keep their SIMT scan for fp32.
//
// Replaces, for bf16 inputs:
//   llm_quest_tpu/kernels/gdn_pallas.py::gated_delta_rule_pallas (:205,
//     _gdn_chunk_kernel), forward, with the chunk states saved for the
//     backward (save_chunk_states);
//   its custom VJP gdn_pallas.py::_gdn_bwd (:247-290), a reverse scan of
//     per-chunk VJPs of llm_quest_tpu/ops/gdn.py::gdn_chunk (:332-382).
// The TPU kernel's chunked form, per chunk of c = 64 tokens, with q~ = q
// dk^-1/2, lg the cumulative log max(alpha, 1e-30), gamma = exp(lg), R[t,i] =
// exp(min(lg_t - lg_i, 0)) for i <= t, rc_i = exp(min(lg_C - lg_i, 0)):
//   M = I + strict_tril(beta_t R A), A = K K^T;  X = M^-1
//   W = X diag(beta gamma) K,  U = X diag(beta) V;  D = W S0^T - U
//   O = diag(gamma) Q~ S0^T - P D,  P = tril(R o Q~ K^T)
//   S' = gamma_C S0 - (diag(rc) D)^T K
// Only the chunk axis is sequential. X is fp32 forward substitution on the
// two 32 x 32 diagonal blocks, then one block product (the TPU's
// Newton-Schulz inverse was a workaround for its slow triangular solve).
//
// Bound: at the hybrid train step's shape (b 4, h 8, s 2048, dk = dv = 64)
// forward + backward read and write 68.2 MB, 0.0203 ms at 3.35 TB/s, and
// the recurrence's 6.4 GFLOP take 0.0065 ms at 989 TFLOP/s (chip_smoke.py's
// K1 records): the bytes bound it. The time goes instead to the two
// sequential passes over the chunks (32 dependent chunk steps a (b, h) at
// s 2048, where the scan of gdn.cu takes 2,048), so the design keeps every
// chunk-parallel product out of them.
//
// Design.
// - Six kernels, one C call launching three each way:
//   forward:  F1 (chunk, b*h): A, X, W, U          (gdn_tc_chunk_kernel)
//             F2 (dv / 64, b*h): the state pass    (gdn_tc_state_kernel)
//             F3 (chunk, b*h): the output          (gdn_tc_out_kernel)
//   backward: B0 (chunk, b*h): X and P             (gdn_tc_chunk_kernel)
//             B1 (dv / 64, b*h): the reverse pass  (gdn_tc_reverse_kernel)
//             B2 (chunk, b*h): the chunk's gradients (gdn_tc_grad_kernel)
//   F2 writes each chunk's incoming state (the anchors, bf16 hi and lo) and
//   D^T; B1 the cotangent H of each chunk's outgoing state and d(rhs)^T. B2
//   sums over dv inside its products: no partial rows, no atomics, and the
//   result is the same bit for bit from run to run.
// - Products: wgmma m64n64k16, bf16 operands, fp32 accumulators; one
//   warpgroup a block. The passes keep the state (F2) and its cotangent
//   (B1) as a (64 dv rows x dk) fp32 accumulator, so that the state feeds the
//   next product as wgmma's register A operand (the accumulator fragment is
//   the A fragment, as P in flash attention); every fp32 operand is a
//   register A operand and every shared-memory operand is a bf16 tile that
//   TMA copied in (q, k, v, W, the anchors, D^T, X, P, H): nothing is written
//   to shared memory for wgmma by the threads.
// - Precision: an fp32 operand x enters as two bf16 operands, hi = bf16(x)
//   and lo = bf16(x - hi) (16 bits of mantissa), and a product takes hi.hi +
//   lo.hi + hi.lo (hi.B + lo.B where B is a bf16 input). bf16 alone
//   (LLMQ_GDN_TC_SPLIT 0) is 17 % faster at the hybrid shape (H100,
//   tools/gdn_probe.py --bf16-alone) but puts dalpha of long-memory heads
//   (alpha about 0.993) at 1.17x the bf16 bar, the split at 0.002x; in fp64
//   emulation (tools/gdn_tc_rounding.py) bf16 alone in any one of F1, F2 or
//   B1 alone takes that dalpha to 0.55-1.33x the bar. bf16 alone in F3 and
//   B2 would keep within 14 % of it, but gains 5 % of the time: one format
//   for every fp32 operand is kept (PERF.md §6).
// - Stores: the tiles the kernels write (W, U^T, the anchors, D^T, X, P, H,
//   drhs^T, dv) leave through shared memory in 16-byte rows (stage_split,
//   copy_out), the passes' while their next product runs: from the
//   fragments, 4 bytes a thread, they held the passes back (PERF.md §6).
// - Ragged tails: TMA fills rows past s with zeros and the kernels take
//   beta 0, alpha 1 there, which makes those tokens no-ops.
// - Issue is synchronous (fence, issue, commit, wait for 0), as in
//   attention_tc.cu; the passes prefetch the next chunk's tiles by TMA
//   while this one multiplies.
#include "gdn.cuh"
#include "tma_wgmma.cuh"

// calls of llmq_gdn_prefill ([0]) and llmq_gdn_prefill_bwd ([1]) that
// launched the tensor-core kernels: a variable, which a caller reads
// (ctypes' in_dll) without a call into the library
extern "C" {
int llmq_gdn_tc_calls[2] = {0, 0};
}

namespace llmq {
namespace {

constexpr int kC = 64;          // tokens a chunk
constexpr int kLd = kC + 1;     // row stride of the fp32 c x c matrices in shared memory
constexpr int kTLd = 32 + 1;     // row stride of the block-product scratch of the inverse

#ifndef LLMQ_GDN_TC_SPLIT
#define LLMQ_GDN_TC_SPLIT 1
#endif
// Every fp32 operand of a product as bf16 hi + lo (1), or bf16 alone (0: lo
// is zero and its products are skipped; a variant that `python -m
// tools.gdn_probe --bf16-alone` builds to time and check it).
constexpr bool kSplit = LLMQ_GDN_TC_SPLIT;

#define LLMQ_GDN_D32                                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define LLMQ_GDN_F8(i)                                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])

// D (64 x 64, fp32) += A B, both in shared memory; TA / TB: the operand is
// MN-major (its tile's rows run along the contraction)
template <int TA, int TB>
__device__ __forceinline__ void mma_s(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LLMQ_GDN_D32 ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : LLMQ_GDN_F8(0), LLMQ_GDN_F8(8), LLMQ_GDN_F8(16), LLMQ_GDN_F8(24)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D (64 x 64, fp32) += A B, A bf16 fragments in registers, B in shared memory
template <int TB>
__device__ __forceinline__ void mma_r(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LLMQ_GDN_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : LLMQ_GDN_F8(0), LLMQ_GDN_F8(8), LLMQ_GDN_F8(16), LLMQ_GDN_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

#undef LLMQ_GDN_D32
#undef LLMQ_GDN_F8

// an fp32 A operand, k16 step: its bf16 fragments hi and lo (x = hi + lo to 16 bits)
struct Frag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = kSplit ? pack_bf16(x0 - hf.x, x1 - hf.y) : 0u;
}

// The products of an fp32 operand. x: a register operand (Frag), hi + lo;
// Y: an fp32 matrix stored as hi and lo bf16 tiles. hi.hi + lo.hi + hi.lo;
// without kSplit, hi.hi alone.
// D += x B, B a bf16 tile
template <int TB>
__device__ __forceinline__ void mma_x(float (&d)[32], const Frag& x, uint64_t b) {
  mma_r<TB>(d, x.hi, b);
  if constexpr (kSplit) mma_r<TB>(d, x.lo, b);
}

// D += x Y
template <int TB>
__device__ __forceinline__ void mma_xy(float (&d)[32], const Frag& x, uint64_t yh, uint64_t yl) {
  mma_x<TB>(d, x, yh);
  if constexpr (kSplit) mma_r<TB>(d, x.hi, yl);
}

// D += A Y, A bf16 in registers
template <int TB>
__device__ __forceinline__ void mma_ry(float (&d)[32], const uint32_t (&a)[4], uint64_t yh, uint64_t yl) {
  mma_r<TB>(d, a, yh);
  if constexpr (kSplit) mma_r<TB>(d, a, yl);
}

// D += A Y, A a bf16 tile
template <int TA, int TB>
__device__ __forceinline__ void mma_sy(float (&d)[32], uint64_t a, uint64_t yh, uint64_t yl) {
  mma_s<TA, TB>(d, a, yh);
  if constexpr (kSplit) mma_s<TA, TB>(d, a, yl);
}

// D += X Y, X fp32 as hi and lo tiles too
template <int TA, int TB>
__device__ __forceinline__ void mma_xsy(float (&d)[32], uint64_t xh, uint64_t xl, uint64_t yh, uint64_t yl) {
  mma_sy<TA, TB>(d, xh, yh, yl);
  if constexpr (kSplit) mma_s<TA, TB>(d, xl, yh);
}

// The m64n64 accumulator fragment: element i of a thread sits at row
// 16 * warp + g + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * t + i % 2
// (g = lane / 4, t = lane % 4). The A fragment of k16 step kk is the
// accumulator's elements 8kk .. 8kk + 7 (columns 16kk .. 16kk + 15).
struct Lane {
  int warp, g, t;
  __device__ __forceinline__ Lane() : warp((threadIdx.x % kWG) / 32), g(threadIdx.x % 32 / 4), t(threadIdx.x % 4) {}
  __device__ __forceinline__ int row(int i) const { return 16 * warp + g + 8 * ((i >> 1) & 1); }
  __device__ __forceinline__ int col(int i) const { return 8 * (i >> 2) + 2 * t + (i & 1); }
  // which of the thread's 16 distinct columns element i sits in (col(i) = 8 (c16 / 2) + 2t + c16 % 2)
  __device__ static __forceinline__ int col16(int i) { return ((i >> 2) << 1) | (i & 1); }
};

// a 64-vector at this thread's 16 columns, indexed by Lane::col16
__device__ __forceinline__ void load_cols(const float* vec, const Lane& L, float (&out)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 x = *reinterpret_cast<const float2*>(vec + 8 * j + 2 * L.t);
    out[2 * j] = x.x;
    out[2 * j + 1] = x.y;
  }
}

// the A fragment of k16 step kk of the 64 x 64 fp32 matrix whose element
// (r, c) is val(r, c), split into hi and lo
template <typename F>
__device__ __forceinline__ void frag_of(const Lane& L, int kk, F val, Frag& f) {
  const int r0 = 16 * L.warp + L.g, c0 = 16 * kk + 2 * L.t;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = r0 + 8 * (q & 1), c = c0 + 8 * (q >> 1);
    split2(val(r, c), val(r, c + 1), f.hi[q], f.lo[q]);
  }
}

// the same from an accumulator fragment, each element scaled by mul(column)
template <typename F>
__device__ __forceinline__ void frag_acc(const Lane& L, const float (&s)[32], int kk, F mul, Frag& f) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = 8 * kk + 2 * q;
    split2(s[i] * mul(L.col(i)), s[i + 1] * mul(L.col(i + 1)), f.hi[q], f.lo[q]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// a row sum over the accumulator's 64 columns, this thread's two rows:
// the 4 threads of a row add their parts
__device__ __forceinline__ void row_sums(float (&part)[2]) {
  part[0] = quad_sum(part[0]);
  part[1] = quad_sum(part[1]);
}

// hi and lo halves of a bf16 pair, stored as two bf16 pairs `lo_off` elements apart
__device__ __forceinline__ void store_split(__nv_bfloat16* p, long long lo_off, float x0, float x1) {
  uint32_t hi, lo;
  split2(x0, x1, hi, lo);
  *reinterpret_cast<uint32_t*>(p) = hi;
  *reinterpret_cast<uint32_t*>(p + lo_off) = lo;
}

__device__ __forceinline__ float bf2f(__nv_bfloat16 x) { return __bfloat162float(x); }

// A 64-row tile staged in shared memory as bf16 rows of kSt (144 bytes: a
// fragment's writes hit all 32 banks), so that it leaves for global memory
// in 16-byte pieces, a row at a time.
constexpr int kSt = kC + 8;
constexpr int kStBytes = kC * kSt * 2;
constexpr int kUt = kC + 4;  // row stride (fp32) of a staged U^T tile: 272 bytes

// the fragment's 64 x 64 fp32 values as bf16 hi and lo into two staged tiles
__device__ __forceinline__ void stage_split(const Lane& L, const float (&x)[32], __nv_bfloat16* hi,
                                            __nv_bfloat16* lo) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    uint32_t h, l;
    split2(x[i], x[i + 1], h, l);
    const int o = L.row(i) * kSt + L.col(i);
    *reinterpret_cast<uint32_t*>(hi + o) = h;
    *reinterpret_cast<uint32_t*>(lo + o) = l;
  }
}

// rows 0 .. rows - 1 of a staged tile to global memory, row r at dst + r * ld
// (64 bf16, 16-byte aligned); all the block's threads
__device__ __forceinline__ void copy_out(const __nv_bfloat16* st, __nv_bfloat16* dst, long long ld, int rows = kC) {
  for (int e = threadIdx.x; e < rows * 8; e += kWG) {
    const int r = e / 8, c = e % 8 * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) = *reinterpret_cast<const uint4*>(st + r * kSt + c);
  }
}

// element (r, c) of a bf16 Tile<R, C> in shared memory (generic pointer to
// its 1024-byte aligned start), through the 128-byte swizzle TMA wrote
template <int R, int C>
__device__ __forceinline__ float tile_at(const uint8_t* tile, int r, int c) {
  using T = Tile<R, C>;
  static_assert(T::MODE == 1, "tiles of 64-column blocks");
  const int cc = c % T::BW;
  const int off = c / T::BW * T::BLOCKB + r * T::ROWB + ((cc / 8) ^ (r % 8)) * 16 + cc % 8 * 2;
  return bf2f(*reinterpret_cast<const __nv_bfloat16*>(tile + off));
}

// Everything a call's kernels read and write. Tensors are contiguous unless
// a TMA map reads them; (bh, ...) is (b * h, ...).
struct GdnTc {
  int B, H, S, n, DV;
  float scale;
  const float* beta;   // (b, h, s) fp32
  const float* alpha;  // (b, h, s) fp32
  const float* s0;     // (b, h, dv, dk) fp32, or null (zeros)
  float* s_out;        // (b, h, dv, dk) fp32
  __nv_bfloat16* out;  // (b, h, s, dv)
  __nv_bfloat16* w;    // (2, b, h, n * 64, dk): W hi, lo
  float* ut;           // (bh, n, dv, 64): U^T
  float* gam;          // (bh, n, 64): gamma
  float* rc;           // (bh, n, 64): rc
  float* gc;           // (bh, n): gamma_C
  __nv_bfloat16* st;   // (2, n, b, h, dv, dk): each chunk's incoming state, hi, lo (the anchors)
  __nv_bfloat16* dt;   // (2, bh, n, dv, 64): D^T hi, lo
  // backward
  const __nv_bfloat16* v;     // (b, h, s, dv)
  const float* dstate;        // (b, h, dv, dk) fp32, or null (zeros)
  __nv_bfloat16* xp;          // (4, bh, n, 64, 64): X hi, X lo, P hi, P lo
  __nv_bfloat16* hin;         // (2, bh, n, dv, dk): each chunk's outgoing state cotangent, hi, lo
  __nv_bfloat16* drt;         // (2, bh, n, dv, 64): d(rhs)^T hi, lo
  __nv_bfloat16* dq;          // (b, h, s, dk)
  __nv_bfloat16* dk;          // (b, h, s, dk)
  __nv_bfloat16* dv;          // (b, h, s, dv)
  float* dbeta;               // (b, h, s)
  float* dalpha;              // (b, h, s)
  float* dprev;               // (b, h, dv, dk)
};

// A chunk's scalars, computed by warp 0 into shared memory: lg (the
// inclusive cumulative log max(alpha, 1e-30)), beta, gamma = exp(lg), rc.
// Tokens past s (n_valid) take alpha 1 and beta 0.
struct Scalars {
  float lg[kC], beta[kC], gam[kC], rc[kC];
};

__device__ __forceinline__ void chunk_scalars(const float* alpha, const float* beta, int n_valid, Scalars& s) {
  const int lane = threadIdx.x % 32;
  float la[2], bb[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = 2 * lane + e;
    const bool ok = t < n_valid;
    la[e] = ok ? logf(fmaxf(alpha[t], 1e-30f)) : 0.f;
    bb[e] = ok ? beta[t] : 0.f;
  }
  const float pair = la[0] + la[1];
  float x = pair;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFullMask, x, off);
    if (lane >= off) x += y;
  }
  const float lg0 = x - pair + la[0], lg1 = x;
  const float lgc = __shfl_sync(kFullMask, x, 31);
  s.lg[2 * lane] = lg0;
  s.lg[2 * lane + 1] = lg1;
  s.beta[2 * lane] = bb[0];
  s.beta[2 * lane + 1] = bb[1];
  s.gam[2 * lane] = expf(lg0);
  s.gam[2 * lane + 1] = expf(lg1);
  s.rc[2 * lane] = expf(fminf(lgc - lg0, 0.f));
  s.rc[2 * lane + 1] = expf(fminf(lgc - lg1, 0.f));
}

__device__ __forceinline__ float ratio(const Scalars& s, int r, int c) { return expf(fminf(s.lg[r] - s.lg[c], 0.f)); }

// the whole block is done with its wgmmas and shared-memory reads
__device__ __forceinline__ void mma_done() {
  wg_commit();
  wg_wait();
}

template <int N>
__device__ __forceinline__ void fence_all(float (&d)[N][32]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_regs(d[i]);
}

// ------------------------------------------------------- F1 / B0: one chunk

// X = M^-1 of the unit lower-triangular M = I + L (L strict lower, fp32 in
// lm) into xm (zeroed by the caller), as 2 x 2 blocks of 32: warps 0 and 1
// invert the diagonal blocks by column-oriented forward substitution (a
// column a thread, its 32 values in registers, 31 steps of independent
// updates), then every thread takes 8 rows of one column of
// X_10 = -X_11 (L_10 X_00), through tm (32 x kTLd).
__device__ __forceinline__ void invert_unit_lower(const float* lm, float* xm, float* tm, int tid) {
  if (tid < 64) {
    const int o = 32 * (tid / 32), c = tid % 32;
    float x[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) x[r] = r == c ? 1.f : 0.f;
#pragma unroll
    for (int i = 0; i < 31; ++i) {
      const float xi = x[i];
#pragma unroll
      for (int r = i + 1; r < 32; ++r) x[r] -= lm[(o + r) * kLd + o + i] * xi;
    }
#pragma unroll
    for (int r = 0; r < 32; ++r) xm[(o + r) * kLd + o + c] = x[r];
  }
  __syncthreads();
  const int c = tid % 32, r0 = 8 * (tid / 32);
  float acc[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int m = 0; m < 32; ++m) {
    const float xv = xm[m * kLd + c];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] += lm[(32 + r0 + r) * kLd + m] * xv;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) tm[(r0 + r) * kTLd + c] = acc[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int m = 0; m < 32; ++m) {  // X_11 is lower triangular: the zeros above its diagonal add nothing
    const float tv = tm[m * kTLd + c];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] += xm[(32 + r0 + r) * kLd + 32 + m] * tv;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) xm[(32 + r0 + r) * kLd + c] = -acc[r];
  __syncthreads();
}

template <int DK, int DX>
constexpr size_t chunk_smem() {
  return kAlignSlack + Tile<kC, DK>::BYTES + Tile<kC, DX>::BYTES + (2 * kC * kLd + 32 * kTLd) * sizeof(float) +
         sizeof(Scalars) + 16;
}

// grid (n, b*h), one warpgroup. Forward (BWD false): tx is v's map (DX =
// dv), writes W hi/lo, U^T, rc and gamma_C. Backward: tx is q's map (DX =
// dk), writes X hi/lo, P hi/lo, gamma, rc and gamma_C.
template <int DK, int DX, bool BWD>
__global__ void __launch_bounds__(kWG) gdn_tc_chunk_kernel(const GdnTc a, const __grid_constant__ CUtensorMap tk,
                                                           const __grid_constant__ CUtensorMap tx) {
  using KT = Tile<kC, DK>;
  using XT = Tile<kC, DX>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t k_s = base, x_s = base + KT::BYTES;
  float* lm = reinterpret_cast<float*>(gbase + KT::BYTES + XT::BYTES);  // L (strict lower)
  float* xm = lm + kC * kLd;                                             // X
  float* tm = xm + kC * kLd;
  Scalars& sc = *reinterpret_cast<Scalars*>(tm + 32 * kTLd);
  const uint32_t bar = (smem_u32(&sc + 1) + 7u) & ~7u;

  const int j = blockIdx.x, bh = blockIdx.y, bi = bh / a.H, hi = bh % a.H;
  const int tid = threadIdx.x;
  const Lane L;
  const int t0 = j * kC, n_valid = min(kC, a.S - t0);
  init_bars(bar, 1, tid);
  if (tid == 0) {
    mbar_expect(bar, KT::BYTES + XT::BYTES);
    KT::tma(k_s, tk, bar, t0, hi, bi);
    XT::tma(x_s, tx, bar, t0, hi, bi);
  }
  if (tid < 32) chunk_scalars(a.alpha + (size_t)bh * a.S + t0, a.beta + (size_t)bh * a.S + t0, n_valid, sc);
  for (int i = tid; i < kC * kLd; i += kWG) xm[i] = 0.f;
  __syncthreads();
  mbar_wait(bar, 0);

  float acc[32];
  zero(acc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) mma_s<0, 0>(acc, KT::kmajor(k_s, 0, kk), KT::kmajor(k_s, 0, kk));
  mma_done();
  fence_regs(acc);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = L.row(i), c = L.col(i);
    lm[r * kLd + c] = c < r ? sc.beta[r] * ratio(sc, r, c) * acc[i] : 0.f;
  }
  __syncthreads();
  invert_unit_lower(lm, xm, tm, tid);

  const long long cidx = (long long)bh * a.n + j;  // this chunk's index in the (bh, n) arrays
  if (tid < kC) {
    a.rc[cidx * kC + tid] = sc.rc[tid];
    if (BWD) a.gam[cidx * kC + tid] = sc.gam[tid];
    if (tid == kC - 1) a.gc[cidx] = sc.gam[kC - 1];
  }

  if constexpr (!BWD) {
    // W = X diag(beta gamma) K and U = X diag(beta) V, the fp32 X split into hi and lo
    const long long sp = (long long)a.n * kC;
    const long long w_lo = (long long)a.B * a.H * sp * DK;
    float wacc[DK / 64][32], uacc[DX / 64][32];
#pragma unroll
    for (int nb = 0; nb < DK / 64; ++nb) zero(wacc[nb]);
#pragma unroll
    for (int nb = 0; nb < DX / 64; ++nb) zero(uacc[nb]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Frag fw, fu;
      frag_of(L, kk, [&](int r, int c) { return xm[r * kLd + c] * sc.beta[c] * sc.gam[c]; }, fw);
      frag_of(L, kk, [&](int r, int c) { return xm[r * kLd + c] * sc.beta[c]; }, fu);
      wg_fence();
#pragma unroll
      for (int nb = 0; nb < DK / 64; ++nb) mma_x<1>(wacc[nb], fw, KT::mnmajor(k_s, kk, nb));
#pragma unroll
      for (int nb = 0; nb < DX / 64; ++nb) mma_x<1>(uacc[nb], fu, XT::mnmajor(x_s, kk, nb));
    }
    mma_done();
    fence_all(wacc);
    fence_all(uacc);
    // W (hi, lo) and U^T leave through tiles staged over L and X
    __nv_bfloat16* wst = reinterpret_cast<__nv_bfloat16*>(lm);
    float* ust = lm;
#pragma unroll
    for (int nb = 0; nb < DK / 64; ++nb) {
      __syncthreads();
      stage_split(L, wacc[nb], wst, wst + kC * kSt);
      __syncthreads();
      __nv_bfloat16* p = a.w + ((long long)bh * sp + t0) * DK + 64 * nb;
      copy_out(wst, p, DK);
      copy_out(wst + kC * kSt, p + w_lo, DK);
    }
#pragma unroll
    for (int nb = 0; nb < DX / 64; ++nb) {
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 32; ++i) ust[L.col(i) * kUt + L.row(i)] = uacc[nb][i];
      __syncthreads();
      float* p = a.ut + (cidx * DX + 64 * nb) * kC;
      for (int e = tid; e < kC * kC / 4; e += kWG) {
        const int r = e / 16, c = e % 16 * 4;
        *reinterpret_cast<float4*>(p + r * kC + c) = *reinterpret_cast<const float4*>(ust + r * kUt + c);
      }
    }
  } else {
    // X hi/lo, then P = dk^-1/2 tril(R o Q K^T) hi/lo
    const long long plane = (long long)a.B * a.H * a.n * kC * kC;
    __nv_bfloat16* xo = a.xp + cidx * kC * kC;
    for (int e = tid; e < kC * kC / 2; e += kWG) {
      const int r = 2 * e / kC, c = 2 * e % kC;
      store_split(xo + r * kC + c, plane, xm[r * kLd + c], xm[r * kLd + c + 1]);
    }
    zero(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) mma_s<0, 0>(acc, XT::kmajor(x_s, 0, kk), KT::kmajor(k_s, 0, kk));
    mma_done();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = L.row(i), c = L.col(i);
      acc[i] = c <= r ? a.scale * ratio(sc, r, c) * acc[i] : 0.f;
    }
    __nv_bfloat16* pst = reinterpret_cast<__nv_bfloat16*>(lm);  // P (hi, lo) leaves through tiles staged over L and X
    __syncthreads();
    stage_split(L, acc, pst, pst + kC * kSt);
    __syncthreads();
    copy_out(pst, xo + 2 * plane, kC);
    copy_out(pst + kC * kSt, xo + 3 * plane, kC);
  }
}

// ------------------------------------------------------- F2: the state pass

template <int DK>
constexpr size_t state_smem() {
  return kAlignSlack + 2 * 3 * Tile<kC, DK>::BYTES + (2 * DK / 64 + 2) * kStBytes + 16;
}

// grid (dv / 64, b*h), one warpgroup: 64 rows of the state, (64 x dk) fp32
// in the accumulators, walked over the chunks. Per chunk: store it (the
// chunk's incoming state, hi and lo), D^T = S W^T - U^T (stored hi and lo),
// S = gamma_C S - (D^T diag(rc)) K. tw: W's map (batch 2b: hi then lo),
// tk: k's map. Stage s of the ring holds W hi, W lo and K of one chunk. The
// stores leave through staged tiles while the state update multiplies, and
// the next chunk's U^T, rc and gamma_C load meanwhile.
template <int DK>
__global__ void __launch_bounds__(kWG) gdn_tc_state_kernel(const GdnTc a, const __grid_constant__ CUtensorMap tw,
                                                           const __grid_constant__ CUtensorMap tk) {
  using KT = Tile<kC, DK>;
  constexpr int NB = DK / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(smem_raw + (base - smem_u32(smem_raw)) + 2 * 3 * KT::BYTES);
  const uint32_t bars = smem_u32(stg) + (2 * NB + 2) * kStBytes;
  auto staged = [&](int i) { return stg + i * kC * kSt; };  // 2nb, 2nb + 1: the state's hi, lo; 2NB, 2NB + 1: D^T's
  const int v0 = 64 * blockIdx.x, bh = blockIdx.y, bi = bh / a.H, hi = bh % a.H;
  const int tid = threadIdx.x;
  const Lane L;
  const int DV = a.DV, BH = a.B * a.H;

  auto load = [&](int j, int stage) {
    const uint32_t s = base + stage * 3 * KT::BYTES, bar = bars + 8 * stage;
    mbar_expect(bar, 3 * KT::BYTES);
    KT::tma(s, tw, bar, j * kC, hi, bi);
    KT::tma(s + KT::BYTES, tw, bar, j * kC, hi, a.B + bi);
    KT::tma(s + 2 * KT::BYTES, tk, bar, j * kC, hi, bi);
  };
  // chunk j's gamma_C, rc at this thread's 16 columns (Lane::col16) and U^T at its elements of D^T
  float gc, rcv[16];
  float2 ut[16];
  auto load_chunk = [&](int j) {
    const long long cidx = (long long)bh * a.n + j;
    gc = a.gc[cidx];
    load_cols(a.rc + cidx * kC, L, rcv);
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      ut[i / 2] = *reinterpret_cast<const float2*>(a.ut + (cidx * DV + v0 + L.row(i)) * kC + L.col(i));
  };
  init_bars(bars, 2, tid);
  if (tid == 0) load(0, 0);
  load_chunk(0);

  float st[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      float2 x = make_float2(0.f, 0.f);
      if (a.s0 != nullptr)
        x = *reinterpret_cast<const float2*>(a.s0 + ((long long)bh * DV + v0 + L.row(i)) * DK + 64 * nb + L.col(i));
      st[nb][i] = x.x;
      st[nb][i + 1] = x.y;
    }

  const long long st_lo = (long long)a.n * BH * DV * DK, dt_lo = (long long)BH * a.n * DV * kC;
  for (int j = 0; j < a.n; ++j) {
    const int stage = j & 1;
    const uint32_t w_s = base + stage * 3 * KT::BYTES, wl_s = w_s + KT::BYTES, k_s = w_s + 2 * KT::BYTES;
    const long long cidx = (long long)bh * a.n + j;
    mbar_wait(bars + 8 * stage, (j >> 1) & 1);
    __syncthreads();  // every thread is done with the stage refilled next, and with the staged tiles
    if (tid == 0 && j + 1 < a.n) load(j + 1, stage ^ 1);

    // the chunk's incoming state (the anchor), hi and lo
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) stage_split(L, st[nb], staged(2 * nb), staged(2 * nb + 1));

    // D^T = S W^T - U^T
    float dt[32];
    zero(dt);
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      Frag f;
      frag_acc(L, st[kk / 4], kk % 4, [](int) { return 1.f; }, f);
      wg_fence();
      mma_xy<0>(dt, f, KT::kmajor(w_s, 0, kk), KT::kmajor(wl_s, 0, kk));
    }
    mma_done();
    fence_regs(dt);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      dt[i] -= ut[i / 2].x;
      dt[i + 1] -= ut[i / 2].y;
    }
    stage_split(L, dt, staged(2 * NB), staged(2 * NB + 1));

    // S = gamma_C S - (D^T diag(rc)) K
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) st[nb][i] *= gc;
    fence_all(st);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Frag f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 8 * kk + 2 * q;
        split2(-dt[i] * rcv[Lane::col16(i)], -dt[i + 1] * rcv[Lane::col16(i + 1)], f.hi[q], f.lo[q]);
      }
      wg_fence();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma_x<1>(st[nb], f, KT::mnmajor(k_s, kk, nb));
    }
    wg_commit();
    // while it multiplies: the staged stores, and the next chunk's vectors
    __syncthreads();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      __nv_bfloat16* p = a.st + (((long long)j * BH + bh) * DV + v0) * DK + 64 * nb;
      copy_out(staged(2 * nb), p, DK);
      copy_out(staged(2 * nb + 1), p + st_lo, DK);
    }
    copy_out(staged(2 * NB), a.dt + (cidx * DV + v0) * kC, kC);
    copy_out(staged(2 * NB + 1), a.dt + dt_lo + (cidx * DV + v0) * kC, kC);
    if (j + 1 < a.n) load_chunk(j + 1);
    wg_wait();
    fence_all(st);
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      *reinterpret_cast<float2*>(a.s_out + ((long long)bh * DV + v0 + L.row(i)) * DK + 64 * nb + L.col(i)) =
          make_float2(st[nb][i], st[nb][i + 1]);
}

// ------------------------------------------------------- F3: the output

template <int DK, int DV>
constexpr size_t out_smem() {
  return kAlignSlack + 2 * Tile<kC, DK>::BYTES + 2 * Tile<DV, DK>::BYTES + 2 * Tile<DV, kC>::BYTES +
         sizeof(Scalars) + 16;
}

// grid (n, b*h), one warpgroup: O = dk^-1/2 diag(gamma) Q S0^T - P D with P
// = dk^-1/2 tril(R o Q K^T), from the chunk's incoming state S0 and D^T (hi
// and lo each, K-major B tiles). ts: the states' map (batch 2n: hi then lo;
// head b*h); td: D^T's map (batch 2 b*h: hi then lo; head n).
template <int DK, int DV>
__global__ void __launch_bounds__(kWG)
    gdn_tc_out_kernel(const GdnTc a, const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap ts, const __grid_constant__ CUtensorMap td) {
  using QT = Tile<kC, DK>;
  using ST = Tile<DV, DK>;
  using DT = Tile<DV, kC>;
  constexpr int NV = DV / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_s = base, k_s = q_s + QT::BYTES, sh_s = k_s + QT::BYTES, sl_s = sh_s + ST::BYTES,
                 dh_s = sl_s + ST::BYTES, dl_s = dh_s + DT::BYTES;
  Scalars& sc = *reinterpret_cast<Scalars*>(gbase + (dl_s + DT::BYTES - base));
  const uint32_t bar = (smem_u32(&sc + 1) + 7u) & ~7u;
  const int j = blockIdx.x, bh = blockIdx.y, bi = bh / a.H, hi = bh % a.H, BH = a.B * a.H;
  const int tid = threadIdx.x;
  const Lane L;
  const int t0 = j * kC, n_valid = min(kC, a.S - t0);
  init_bars(bar, 1, tid);
  if (tid == 0) {
    mbar_expect(bar, 2 * QT::BYTES + 2 * ST::BYTES + 2 * DT::BYTES);
    QT::tma(q_s, tq, bar, t0, hi, bi);
    QT::tma(k_s, tk, bar, t0, hi, bi);
    ST::tma(sh_s, ts, bar, 0, bh, j);
    ST::tma(sl_s, ts, bar, 0, bh, a.n + j);
    DT::tma(dh_s, td, bar, 0, j, bh);
    DT::tma(dl_s, td, bar, 0, j, BH + bh);
  }
  if (tid < 32) chunk_scalars(a.alpha + (size_t)bh * a.S + t0, a.beta + (size_t)bh * a.S + t0, n_valid, sc);
  __syncthreads();
  mbar_wait(bar, 0);

  float p[32], o[NV][32];
  zero(p);
#pragma unroll
  for (int nb = 0; nb < NV; ++nb) zero(o[nb]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) mma_s<0, 0>(p, QT::kmajor(q_s, 0, kk), QT::kmajor(k_s, 0, kk));
#pragma unroll
  for (int nb = 0; nb < NV; ++nb)
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      mma_sy<0, 0>(o[nb], QT::kmajor(q_s, 0, kk), ST::kmajor(sh_s, 64 * nb, kk), ST::kmajor(sl_s, 64 * nb, kk));
  mma_done();
  fence_regs(p);
  fence_all(o);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = L.row(i), c = L.col(i);
    p[i] = c <= r ? -a.scale * ratio(sc, r, c) * p[i] : 0.f;  // -P: O -= P D
  }
#pragma unroll
  for (int nb = 0; nb < NV; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] *= a.scale * sc.gam[L.row(i)];
  fence_all(o);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    Frag f;
    frag_acc(L, p, kk, [](int) { return 1.f; }, f);
    wg_fence();
#pragma unroll
    for (int nb = 0; nb < NV; ++nb) mma_xy<0>(o[nb], f, DT::kmajor(dh_s, 64 * nb, kk), DT::kmajor(dl_s, 64 * nb, kk));
  }
  mma_done();
  fence_all(o);
#pragma unroll
  for (int nb = 0; nb < NV; ++nb)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = L.row(i);
      if (r < n_valid)
        *reinterpret_cast<__nv_bfloat162*>(a.out + ((long long)bh * a.S + t0 + r) * DV + 64 * nb + L.col(i)) =
            __floats2bfloat162_rn(o[nb][i], o[nb][i + 1]);
    }
}

// ------------------------------------------------------- B1: the reverse pass

template <int DK>
constexpr size_t reverse_smem() {
  return kAlignSlack + 2 * (2 * Tile<kC, DK>::BYTES + 5 * Tile<kC, kC>::BYTES) + (2 * DK / 64 + 3) * kStBytes + 16;
}

// grid (dv / 64, b*h), one warpgroup: 64 rows of the state cotangent H
// ((64 x dk) fp32 accumulators, from d_state) walked from the last chunk to
// the first. Per chunk: store H (hi, lo: the cotangent of the chunk's
// outgoing state); dD^T = -dO^T P - (H K^T) diag(rc); drhs^T = dD^T X
// (stored hi and lo; dv = -beta o drhs); H = gamma_C H + (dO^T diag(dk^-1/2
// gamma)) Q + (drhs^T diag(beta gamma)) K. txp: X and P (batch 4 b*h: X hi,
// X lo, P hi, P lo; head n); tdo: d_out's map (a box of 64 columns). A stage
// of the ring holds K, Q, X hi/lo, P hi/lo and the block's 64 columns of dO.
template <int DK>
__global__ void __launch_bounds__(kWG)
    gdn_tc_reverse_kernel(const GdnTc a, const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap txp, const __grid_constant__ CUtensorMap tdo) {
  using KT = Tile<kC, DK>;
  using CT = Tile<kC, kC>;
  constexpr int NB = DK / 64;
  constexpr uint32_t kStage = 2 * KT::BYTES + 5 * CT::BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  __nv_bfloat16* stg = reinterpret_cast<__nv_bfloat16*>(gbase + 2 * kStage);
  // 2nb, 2nb + 1: H's hi, lo; 2NB, 2NB + 1: drhs^T's; 2NB + 2: dv (tokens along the rows)
  auto staged = [&](int i) { return stg + i * kC * kSt; };
  const uint32_t bars = smem_u32(stg) + (2 * NB + 3) * kStBytes;
  const int v0 = 64 * blockIdx.x, bh = blockIdx.y, bi = bh / a.H, hi = bh % a.H;
  const int tid = threadIdx.x;
  const Lane L;
  const int DV = a.DV, BH = a.B * a.H;

  auto load = [&](int j, int stage) {
    const uint32_t s = base + stage * kStage, bar = bars + 8 * stage;
    mbar_expect(bar, kStage);
    KT::tma(s, tk, bar, j * kC, hi, bi);
    KT::tma(s + KT::BYTES, tq, bar, j * kC, hi, bi);
#pragma unroll
    for (int w = 0; w < 4; ++w) CT::tma(s + 2 * KT::BYTES + w * CT::BYTES, txp, bar, 0, j, w * BH + bh);
    tma_load(s + 2 * KT::BYTES + 4 * CT::BYTES, tdo, bar, v0, j * kC, hi, bi);
  };
  init_bars(bars, 2, tid);
  if (tid == 0) load(a.n - 1, 0);

  float h[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      float2 x = make_float2(0.f, 0.f);
      if (a.dstate != nullptr)
        x = *reinterpret_cast<const float2*>(a.dstate + ((long long)bh * DV + v0 + L.row(i)) * DK + 64 * nb +
                                             L.col(i));
      h[nb][i] = x.x;
      h[nb][i + 1] = x.y;
    }

  const long long hin_lo = (long long)BH * a.n * DV * DK, drt_lo = (long long)BH * a.n * DV * kC;
  for (int jj = 0; jj < a.n; ++jj) {
    const int j = a.n - 1 - jj, stage = jj & 1;
    const uint32_t k_s = base + stage * kStage, q_s = k_s + KT::BYTES, xh_s = q_s + KT::BYTES,
                   xl_s = xh_s + CT::BYTES, ph_s = xl_s + CT::BYTES, pl_s = ph_s + CT::BYTES, do_s = pl_s + CT::BYTES;
    const long long cidx = (long long)bh * a.n + j;
    const int t0 = j * kC, n_valid = min(kC, a.S - t0);
    float rcv[16], gmv[16], btv[16];
    load_cols(a.rc + cidx * kC, L, rcv);
    load_cols(a.gam + cidx * kC, L, gmv);
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int t = 8 * (c / 2) + 2 * L.t + c % 2;
      btv[c] = t < n_valid ? a.beta[(long long)bh * a.S + t0 + t] : 0.f;
    }
    const float gc = a.gc[cidx];
    mbar_wait(bars + 8 * stage, (jj >> 1) & 1);
    __syncthreads();  // every thread is done with the stage refilled next, and with the staged tiles
    if (tid == 0 && jj + 1 < a.n) load(j - 1, stage ^ 1);

#pragma unroll
    for (int nb = 0; nb < NB; ++nb) stage_split(L, h[nb], staged(2 * nb), staged(2 * nb + 1));
    float dov[32];  // dO^T: rows dv, columns the chunk's tokens (bf16 values; rows past s are zeros)
    const uint8_t* do_g = gbase + (do_s - base);
#pragma unroll
    for (int i = 0; i < 32; ++i) dov[i] = tile_at<kC, kC>(do_g, L.col(i), L.row(i));

    // dD^T = -dO^T P - (H K^T) diag(rc)
    float hk[32], dd[32];
    zero(hk);
    zero(dd);
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      Frag f;
      frag_acc(L, h[kk / 4], kk % 4, [](int) { return 1.f; }, f);
      wg_fence();
      mma_x<0>(hk, f, KT::kmajor(k_s, 0, kk));
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t fo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) fo[q] = pack_bf16(dov[8 * kk + 2 * q], dov[8 * kk + 2 * q + 1]);  // exact
      wg_fence();
      mma_ry<1>(dd, fo, CT::mnmajor(ph_s, kk, 0), CT::mnmajor(pl_s, kk, 0));
    }
    mma_done();
    fence_regs(hk);
    fence_regs(dd);
#pragma unroll
    for (int i = 0; i < 32; ++i) dd[i] = -dd[i] - hk[i] * rcv[Lane::col16(i)];

    // drhs^T = dD^T X
    float dr[32];
    zero(dr);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Frag f;
      frag_acc(L, dd, kk, [](int) { return 1.f; }, f);
      wg_fence();
      mma_xy<1>(dr, f, CT::mnmajor(xh_s, kk, 0), CT::mnmajor(xl_s, kk, 0));
    }
    mma_done();
    fence_regs(dr);
    stage_split(L, dr, staged(2 * NB), staged(2 * NB + 1));
    __nv_bfloat16* dvs = staged(2 * NB + 2);
#pragma unroll
    for (int i = 0; i < 32; ++i) dvs[L.col(i) * kSt + L.row(i)] = __float2bfloat16(-btv[Lane::col16(i)] * dr[i]);

    // H = gamma_C H + (dO^T diag(dk^-1/2 gamma)) Q + (drhs^T diag(beta gamma)) K
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) h[nb][i] *= gc;
    fence_all(h);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Frag fo, fd;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 8 * kk + 2 * q, c0 = Lane::col16(i), c1 = Lane::col16(i + 1);
        split2(dov[i] * a.scale * gmv[c0], dov[i + 1] * a.scale * gmv[c1], fo.hi[q], fo.lo[q]);
        split2(dr[i] * btv[c0] * gmv[c0], dr[i + 1] * btv[c1] * gmv[c1], fd.hi[q], fd.lo[q]);
      }
      wg_fence();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        mma_x<1>(h[nb], fo, KT::mnmajor(q_s, kk, nb));
        mma_x<1>(h[nb], fd, KT::mnmajor(k_s, kk, nb));
      }
    }
    wg_commit();
    // while it multiplies: the staged stores
    __syncthreads();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      __nv_bfloat16* p = a.hin + (cidx * DV + v0) * DK + 64 * nb;
      copy_out(staged(2 * nb), p, DK);
      copy_out(staged(2 * nb + 1), p + hin_lo, DK);
    }
    copy_out(staged(2 * NB), a.drt + (cidx * DV + v0) * kC, kC);
    copy_out(staged(2 * NB + 1), a.drt + drt_lo + (cidx * DV + v0) * kC, kC);
    copy_out(dvs, a.dv + ((long long)bh * a.S + t0) * DV + v0, DV, n_valid);
    wg_wait();
    fence_all(h);
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      *reinterpret_cast<float2*>(a.dprev + ((long long)bh * DV + v0 + L.row(i)) * DK + 64 * nb + L.col(i)) =
          make_float2(h[nb][i], h[nb][i + 1]);
}

// ------------------------------------------------------- B2: the gradients

template <int DK, int DV>
constexpr size_t grad_smem() {
  return kAlignSlack + 2 * Tile<kC, DK>::BYTES + Tile<kC, DV>::BYTES + 4 * Tile<DV, kC>::BYTES +
         2 * Tile<DV, DK>::BYTES + 2 * kC * kLd * sizeof(float) + sizeof(Scalars) + (8 * kC + 8) * sizeof(float) +
         16;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

// grid (n, b*h), one warpgroup, dv whole: the chunk's dq, dk, dbeta and
// dalpha (dv is B1's) from its incoming state S (the anchor), the cotangent
// H of its outgoing state, D (saved by the forward) and drhs (B1), as the
// VJP of gdn_chunk written out:
//   dP = -dO D^T (i <= t);  dQK = dk^-1/2 dP o R;  dL = -drhs D^T (i < t)
//   dA = dL o beta_t R;     dR = dP o dk^-1/2 Q K^T + dL o beta_t A
//   dq = dk^-1/2 diag(gamma) dO S + dQK K
//   dk = diag(beta gamma) drhs S - diag(rc) D H + dQK^T Q + (dA + dA^T) K
//   dgamma = dk^-1/2 rowsum(dO o Q S^T) + beta o rowsum(drhs o K S^T)
//   dbeta = rowsum(drhs o (diag(gamma) K S^T - V)) + rowsum(dL o R o A)
//   drc = -rowsum(D o K H^T);  dgamma_C = <H, S>
// and dlg = dgamma gamma + rowsum(dR o R) - colsum(dR o R) - drc rc (+ the
// last token's dgamma_C gamma_C + sum drc rc), dalpha = revcumsum(dlg) /
// alpha where alpha >= 1e-30. D^T, drhs^T and dO stay in their TMA tiles
// (read elementwise through the swizzle); S's tiles are reloaded with H's
// once S is done. td, trt: D^T's and drhs^T's maps; ts: the anchors'; th:
// H's (batch 2 b*h, head n).
template <int DK, int DV>
__global__ void __launch_bounds__(kWG)
    gdn_tc_grad_kernel(const GdnTc a, const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tdo, const __grid_constant__ CUtensorMap td,
                       const __grid_constant__ CUtensorMap trt, const __grid_constant__ CUtensorMap ts,
                       const __grid_constant__ CUtensorMap th) {
  using QT = Tile<kC, DK>;
  using OT = Tile<kC, DV>;
  using DT = Tile<DV, kC>;
  using ST = Tile<DV, DK>;
  constexpr int NB = DK / 64, NV = DV / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  uint8_t* gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_s = base, k_s = q_s + QT::BYTES, do_s = k_s + QT::BYTES, dh_s = do_s + OT::BYTES,
                 dl_s = dh_s + DT::BYTES, rh_s = dl_s + DT::BYTES, rl_s = rh_s + DT::BYTES, sh_s = rl_s + DT::BYTES,
                 sl_s = sh_s + ST::BYTES;
  auto gen = [&](uint32_t s) { return gbase + (s - base); };
  float* dqk = reinterpret_cast<float*>(gen(sl_s + ST::BYTES));  // dQK (i <= t)
  float* dam = dqk + kC * kLd;                                    // dA (i < t)
  Scalars& sc = *reinterpret_cast<Scalars*>(dam + kC * kLd);
  float* dgam = reinterpret_cast<float*>(&sc + 1);
  float* dbet = dgam + kC;
  float* drc = dbet + kC;
  float* dlg = drc + kC;
  float* colp = dlg + kC;   // 4 warps' column sums of dR o R
  float* red = colp + 4 * kC;  // 4 warps' parts of <H, S>
  const uint32_t bars = (smem_u32(red + 8) + 7u) & ~7u;

  const int j = blockIdx.x, bh = blockIdx.y, bi = bh / a.H, hi = bh % a.H, BH = a.B * a.H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Lane L;
  const int t0 = j * kC, n_valid = min(kC, a.S - t0);
  const long long cidx = (long long)bh * a.n + j;
  init_bars(bars, 2, tid);
  if (tid == 0) {
    mbar_expect(bars, 2 * QT::BYTES + OT::BYTES + 4 * DT::BYTES + 2 * ST::BYTES);
    QT::tma(q_s, tq, bars, t0, hi, bi);
    QT::tma(k_s, tk, bars, t0, hi, bi);
    OT::tma(do_s, tdo, bars, t0, hi, bi);
    DT::tma(dh_s, td, bars, 0, j, bh);
    DT::tma(dl_s, td, bars, 0, j, BH + bh);
    DT::tma(rh_s, trt, bars, 0, j, bh);
    DT::tma(rl_s, trt, bars, 0, j, BH + bh);
    ST::tma(sh_s, ts, bars, 0, bh, j);
    ST::tma(sl_s, ts, bars, 0, bh, a.n + j);
  }
  if (tid < 32) chunk_scalars(a.alpha + (size_t)bh * a.S + t0, a.beta + (size_t)bh * a.S + t0, n_valid, sc);
  __syncthreads();
  mbar_wait(bars, 0);

  const uint8_t *dhg = gen(dh_s), *dlg_g = gen(dl_s), *rhg = gen(rh_s), *rlg = gen(rl_s), *dog = gen(do_s);
  auto drhs = [&](int t, int v) { return tile_at<DV, kC>(rhg, v, t) + tile_at<DV, kC>(rlg, v, t); };
  auto dval = [&](int t, int v) { return tile_at<DV, kC>(dhg, v, t) + tile_at<DV, kC>(dlg_g, v, t); };

  // dR o R: this thread's parts of its two rows' and 16 columns' sums
  float grow[2] = {0.f, 0.f}, gcol[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) gcol[c] = 0.f;

  // 1. Q K^T and dO D^T: dQK and the output's part of dR o R
  float x1[32], x2[32];
  zero(x1);
  zero(x2);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) mma_s<0, 0>(x1, QT::kmajor(q_s, 0, kk), QT::kmajor(k_s, 0, kk));
#pragma unroll
  for (int kk = 0; kk < DV / 16; ++kk)
    mma_sy<0, 1>(x2, OT::kmajor(do_s, 0, kk), DT::mnmajor(dh_s, kk, 0), DT::mnmajor(dl_s, kk, 0));
  mma_done();
  fence_regs(x1);
  fence_regs(x2);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = L.row(i), c = L.col(i);
    const float R = ratio(sc, r, c), dp = c <= r ? -x2[i] : 0.f, g = dp * a.scale * x1[i] * R;
    dqk[r * kLd + c] = a.scale * dp * R;
    grow[(i >> 1) & 1] += g;
    gcol[Lane::col16(i)] += g;
  }

  // 2. K K^T and drhs D^T (both from shared memory): dL, dA, and L's parts of dR o R and dbeta
  float rb[2] = {0.f, 0.f};
  zero(x1);
  zero(x2);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) mma_s<0, 0>(x1, QT::kmajor(k_s, 0, kk), QT::kmajor(k_s, 0, kk));
#pragma unroll
  for (int kk = 0; kk < DV / 16; ++kk)
    mma_xsy<1, 1>(x2, DT::mnmajor(rh_s, kk, 0), DT::mnmajor(rl_s, kk, 0), DT::mnmajor(dh_s, kk, 0),
                  DT::mnmajor(dl_s, kk, 0));
  mma_done();
  fence_regs(x1);
  fence_regs(x2);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = L.row(i), c = L.col(i);
    const float R = ratio(sc, r, c), dl = c < r ? -x2[i] : 0.f, g = dl * sc.beta[r] * x1[i] * R;
    rb[(i >> 1) & 1] += dl * R * x1[i];
    grow[(i >> 1) & 1] += g;
    gcol[Lane::col16(i)] += g;
    dam[r * kLd + c] = dl * sc.beta[r] * R;
  }

  // 3. Q S^T and K S^T: dgamma and the rhs part of dbeta
  float rg[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < NV; ++nb) {
    uint32_t vv[16];  // V at this thread's elements, bf16 pairs, loaded while the products run
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int t = L.row(i);
      vv[i / 2] = t < n_valid ? *reinterpret_cast<const uint32_t*>(
                                    a.v + ((long long)bh * a.S + t0 + t) * DV + 64 * nb + L.col(i))
                              : 0u;
    }
    zero(x1);
    zero(x2);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      mma_sy<0, 0>(x1, QT::kmajor(q_s, 0, kk), ST::kmajor(sh_s, 64 * nb, kk), ST::kmajor(sl_s, 64 * nb, kk));
      mma_sy<0, 0>(x2, QT::kmajor(k_s, 0, kk), ST::kmajor(sh_s, 64 * nb, kk), ST::kmajor(sl_s, 64 * nb, kk));
    }
    mma_done();
    fence_regs(x1);
    fence_regs(x2);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int t = L.row(i), v = 64 * nb + L.col(i), hh = (i >> 1) & 1;
      const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(&vv[i / 2]);
      const float vval = bf2f(i & 1 ? v2.y : v2.x), dr = drhs(t, v), dov = tile_at<kC, DV>(dog, t, v);
      rg[hh] += a.scale * dov * x1[i] + sc.beta[t] * dr * x2[i];
      rb[hh] += dr * (sc.gam[t] * x2[i] - vval);
    }
  }
  row_sums(rg);
  row_sums(rb);
  if (L.t == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * L.warp + L.g + 8 * hh;
      dgam[r] = rg[hh];
      dbet[r] = rb[hh];
    }
  }
  __syncthreads();  // dQK and dA are complete

  // 4. dq = dk^-1/2 diag(gamma) dO S + dQK K
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    zero(x1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
      mma_sy<0, 1>(x1, OT::kmajor(do_s, 0, kk), ST::mnmajor(sh_s, kk, nb), ST::mnmajor(sl_s, kk, nb));
    mma_done();
    fence_regs(x1);
#pragma unroll
    for (int i = 0; i < 32; ++i) x1[i] *= a.scale * sc.gam[L.row(i)];
    fence_regs(x1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Frag f;
      frag_of(L, kk, [&](int r, int c) { return dqk[r * kLd + c]; }, f);
      wg_fence();
      mma_x<1>(x1, f, QT::mnmajor(k_s, kk, nb));
    }
    mma_done();
    fence_regs(x1);
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = L.row(i);
      if (r < n_valid)
        *reinterpret_cast<__nv_bfloat162*>(a.dq + ((long long)bh * a.S + t0 + r) * DK + 64 * nb + L.col(i)) =
            __floats2bfloat162_rn(x1[i], x1[i + 1]);
    }
  }

  // 5. dk, the S, Q and K terms: diag(beta gamma) drhs S + dQK^T Q + (dA + dA^T) K
  float dk[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) zero(dk[nb]);
#pragma unroll
  for (int kk = 0; kk < DV / 16; ++kk) {
    Frag f;
    frag_of(L, kk, [&](int r, int c) { return drhs(r, c) * sc.beta[r] * sc.gam[r]; }, f);
    wg_fence();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_xy<1>(dk[nb], f, ST::mnmajor(sh_s, kk, nb), ST::mnmajor(sl_s, kk, nb));
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    Frag fq, fa;
    frag_of(L, kk, [&](int r, int c) { return dqk[c * kLd + r]; }, fq);
    frag_of(L, kk, [&](int r, int c) { return dam[r * kLd + c] + dam[c * kLd + r]; }, fa);
    wg_fence();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      mma_x<1>(dk[nb], fq, QT::mnmajor(q_s, kk, nb));
      mma_x<1>(dk[nb], fa, QT::mnmajor(k_s, kk, nb));
    }
  }
  mma_done();
  fence_all(dk);

  // dgamma_C = <H, S>, from the stored hi and lo halves
  {
    const long long st_lo = (long long)a.n * BH * DV * DK, hin_lo = (long long)BH * a.n * DV * DK;
    const __nv_bfloat16* sp = a.st + ((long long)j * BH + bh) * DV * DK;
    const __nv_bfloat16* hp = a.hin + cidx * DV * DK;
    float hs = 0.f;
    for (int e = 2 * tid; e < DV * DK; e += 2 * kWG) {
      const float2 s_hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sp + e));
      const float2 s_lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sp + st_lo + e));
      const float2 h_hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hp + e));
      const float2 h_lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hp + hin_lo + e));
      hs += (s_hi.x + s_lo.x) * (h_hi.x + h_lo.x) + (s_hi.y + s_lo.y) * (h_hi.y + h_lo.y);
    }
    hs = warp_sum(hs);
    if (lane == 0) red[warp] = hs;
  }

  // 6. H into S's tiles (every wgmma on them has completed)
  __syncthreads();
  if (tid == 0) {
    const uint32_t bar = bars + 8;
    mbar_expect(bar, 2 * ST::BYTES);
    ST::tma(sh_s, th, bar, 0, j, bh);
    ST::tma(sl_s, th, bar, 0, j, BH + bh);
  }
  mbar_wait(bars + 8, 0);

  // 7. K H^T: drc
  float rr[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < NV; ++nb) {
    zero(x1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      mma_sy<0, 0>(x1, QT::kmajor(k_s, 0, kk), ST::kmajor(sh_s, 64 * nb, kk), ST::kmajor(sl_s, 64 * nb, kk));
    mma_done();
    fence_regs(x1);
#pragma unroll
    for (int i = 0; i < 32; ++i) rr[(i >> 1) & 1] -= x1[i] * dval(L.row(i), 64 * nb + L.col(i));
  }
  row_sums(rr);
  if (L.t == 0) {
    drc[16 * L.warp + L.g] = rr[0];
    drc[16 * L.warp + L.g + 8] = rr[1];
  }

  // 8. dk -= diag(rc) D H
#pragma unroll
  for (int kk = 0; kk < DV / 16; ++kk) {
    Frag f;
    frag_of(L, kk, [&](int r, int c) { return -sc.rc[r] * dval(r, c); }, f);
    wg_fence();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_xy<1>(dk[nb], f, ST::mnmajor(sh_s, kk, nb), ST::mnmajor(sl_s, kk, nb));
  }
  mma_done();
  fence_all(dk);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = L.row(i);
      if (r < n_valid)
        *reinterpret_cast<__nv_bfloat162*>(a.dk + ((long long)bh * a.S + t0 + r) * DK + 64 * nb + L.col(i)) =
            __floats2bfloat162_rn(dk[nb][i], dk[nb][i + 1]);
    }

  // 9. dalpha through the chunk's reverse cumulative sum, and dbeta. The
  // column sums of dR o R: over the warp's rows by shuffles, then the warps'
  row_sums(grow);
#pragma unroll
  for (int c = 0; c < 16; ++c)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) gcol[c] += __shfl_xor_sync(kFullMask, gcol[c], off);
  if (L.g == 0) {
#pragma unroll
    for (int c = 0; c < 16; ++c) colp[warp * kC + 8 * (c / 2) + 2 * L.t + c % 2] = gcol[c];
  }
  if (L.t == 0) {
    dlg[16 * L.warp + L.g] = grow[0];
    dlg[16 * L.warp + L.g + 8] = grow[1];
  }
  __syncthreads();
  if (tid < kC) {
    const float col = colp[tid] + colp[kC + tid] + colp[2 * kC + tid] + colp[3 * kC + tid];
    dlg[tid] = dgam[tid] * sc.gam[tid] + dlg[tid] - col - drc[tid] * sc.rc[tid];
  }
  __syncthreads();
  if (tid < 32) {
    const float ends = warp_sum(drc[2 * lane] * sc.rc[2 * lane] + drc[2 * lane + 1] * sc.rc[2 * lane + 1]);
    const float d0 = dlg[2 * lane];
    const float d1 =
        dlg[2 * lane + 1] + (lane == 31 ? (red[0] + red[1] + red[2] + red[3]) * sc.gam[kC - 1] + ends : 0.f);
    const float pair = d0 + d1;
    float x = pair;  // suffix sum over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_down_sync(kFullMask, x, off);
      if (lane + off < 32) x += y;
    }
    const float dla[2] = {x, x - pair + d1};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = 2 * lane + e;
      if (t < n_valid) {
        const long long o = (long long)bh * a.S + t0 + t;
        const float al = a.alpha[o];
        a.dalpha[o] = al >= 1e-30f ? dla[e] / al : 0.f;
        a.dbeta[o] = dbet[t];
      }
    }
  }
}

// ------------------------------------------------------------------ launches

long long aligned(long long bytes) { return (bytes + 1023) / 1024 * 1024; }

// The forward's work buffer, carved in order: W hi/lo, U^T, rc, gamma_C,
// then (unless the caller keeps them) the anchors and D^T.
struct FwdWork {
  long long w, ut, rc, gc, st, dt, total;
  FwdWork(int B, int H, int S, int DK, int DV, bool saved) {
    const long long bh = (long long)B * H, n = (S + kC - 1) / kC;
    w = 0;
    ut = w + aligned(2 * bh * n * kC * DK * 2);
    rc = ut + aligned(bh * n * DV * kC * 4);
    gc = rc + aligned(bh * n * kC * 4);
    st = gc + aligned(bh * n * 4);
    dt = st + (saved ? 0 : aligned(2 * n * bh * DV * DK * 2));
    total = dt + (saved ? 0 : aligned(2 * bh * n * DV * kC * 2));
  }
};

// The backward's: X and P hi/lo, gamma, rc, gamma_C, H hi/lo, drhs^T.
struct BwdWork {
  long long xp, gam, rc, gc, hin, drt, total;
  BwdWork(int B, int H, int S, int DK, int DV) {
    const long long bh = (long long)B * H, n = (S + kC - 1) / kC;
    xp = 0;
    gam = xp + aligned(4 * bh * n * kC * kC * 2);
    rc = gam + aligned(bh * n * kC * 4);
    gc = rc + aligned(bh * n * kC * 4);
    hin = gc + aligned(bh * n * 4);
    drt = hin + aligned(2 * bh * n * DV * DK * 2);
    total = drt + aligned(2 * bh * n * DV * kC * 2);
  }
};

template <int DK, int DV>
int forward(const GdnTcCall& c, cudaStream_t stream) {
  const int n = (c.S + kC - 1) / kC, BH = c.B * c.H;
  const FwdWork wk(c.B, c.H, c.S, DK, DV, c.anchors != nullptr);
  uint8_t* work = static_cast<uint8_t*>(c.work);
  GdnTc a{};
  a.B = c.B, a.H = c.H, a.S = c.S, a.n = n, a.DV = DV, a.scale = c.scale;
  a.beta = c.beta, a.alpha = c.alpha, a.s0 = c.s0, a.s_out = c.s_out;
  a.out = static_cast<__nv_bfloat16*>(c.out);
  a.w = reinterpret_cast<__nv_bfloat16*>(work + wk.w);
  a.ut = reinterpret_cast<float*>(work + wk.ut);
  a.rc = reinterpret_cast<float*>(work + wk.rc);
  a.gc = reinterpret_cast<float*>(work + wk.gc);
  a.st = static_cast<__nv_bfloat16*>(c.anchors != nullptr ? c.anchors : work + wk.st);
  a.dt = static_cast<__nv_bfloat16*>(c.saved_d != nullptr ? c.saved_d : work + wk.dt);
  if ((c.anchors == nullptr) != (c.saved_d == nullptr)) return (int)cudaErrorInvalidValue;

  const long long sp = (long long)n * kC;
  CUtensorMap tq, tk, tv, tw, ts, td;
  if (!make_map<DK>(&tq, c.q, c.B, c.H, c.S, c.q_sb, c.q_sh, c.q_ss, kC) ||
      !make_map<DK>(&tk, c.k, c.B, c.H, c.S, c.k_sb, c.k_sh, c.k_ss, kC) ||
      !make_map<DV>(&tv, c.v, c.B, c.H, c.S, c.v_sb, c.v_sh, c.v_ss, kC) ||
      !make_map<DK>(&tw, a.w, 2 * c.B, c.H, (int)sp, c.H * sp * DK, sp * DK, DK, kC) ||
      !make_map<DK>(&ts, a.st, 2 * n, BH, DV, (long long)BH * DV * DK, (long long)DV * DK, DK, DV) ||
      !make_map<kC>(&td, a.dt, 2 * BH, n, DV, (long long)n * DV * kC, (long long)DV * kC, kC, DV)) {
    return (int)cudaErrorInvalidValue;
  }
  // each kernel's shared-memory limit, raised once
  static const int smem_err = set_smem(gdn_tc_chunk_kernel<DK, DV, false>, chunk_smem<DK, DV>()) |
                              set_smem(gdn_tc_state_kernel<DK>, state_smem<DK>()) |
                              set_smem(gdn_tc_out_kernel<DK, DV>, out_smem<DK, DV>());
  if (smem_err) return smem_err;
  gdn_tc_chunk_kernel<DK, DV, false><<<dim3(n, BH), kWG, chunk_smem<DK, DV>(), stream>>>(a, tk, tv);
  gdn_tc_state_kernel<DK><<<dim3(DV / 64, BH), kWG, state_smem<DK>(), stream>>>(a, tw, tk);
  gdn_tc_out_kernel<DK, DV><<<dim3(n, BH), kWG, out_smem<DK, DV>(), stream>>>(a, tq, tk, ts, td);
  return (int)cudaGetLastError();
}

template <int DK, int DV>
int backward(const GdnTcCall& c, cudaStream_t stream) {
  const int n = (c.S + kC - 1) / kC, BH = c.B * c.H;
  const BwdWork wk(c.B, c.H, c.S, DK, DV);
  uint8_t* work = static_cast<uint8_t*>(c.work);
  GdnTc a{};
  a.B = c.B, a.H = c.H, a.S = c.S, a.n = n, a.DV = DV, a.scale = c.scale;
  a.beta = c.beta, a.alpha = c.alpha;
  a.st = static_cast<__nv_bfloat16*>(c.anchors);
  a.dt = static_cast<__nv_bfloat16*>(c.saved_d);
  a.v = static_cast<const __nv_bfloat16*>(c.v);
  a.dstate = c.dstate;
  a.xp = reinterpret_cast<__nv_bfloat16*>(work + wk.xp);
  a.gam = reinterpret_cast<float*>(work + wk.gam);
  a.rc = reinterpret_cast<float*>(work + wk.rc);
  a.gc = reinterpret_cast<float*>(work + wk.gc);
  a.hin = reinterpret_cast<__nv_bfloat16*>(work + wk.hin);
  a.drt = reinterpret_cast<__nv_bfloat16*>(work + wk.drt);
  a.dq = static_cast<__nv_bfloat16*>(c.dq);
  a.dk = static_cast<__nv_bfloat16*>(c.dk);
  a.dv = static_cast<__nv_bfloat16*>(c.dv);
  a.dbeta = c.dbeta, a.dalpha = c.dalpha, a.dprev = c.dprev;
  if (c.anchors == nullptr || c.saved_d == nullptr) return (int)cudaErrorInvalidValue;

  const long long hs = (long long)c.H * c.S;
  CUtensorMap tq, tk, tdo, txp, ts, td, th, trt;
  if (!make_map<DK>(&tq, c.q, c.B, c.H, c.S, hs * DK, (long long)c.S * DK, DK, kC) ||
      !make_map<DK>(&tk, c.k, c.B, c.H, c.S, hs * DK, (long long)c.S * DK, DK, kC) ||
      !make_map<DV>(&tdo, c.dout, c.B, c.H, c.S, hs * DV, (long long)c.S * DV, DV, kC) ||
      !make_map<kC>(&txp, a.xp, 4 * BH, n, kC, (long long)n * kC * kC, (long long)kC * kC, kC, kC) ||
      !make_map<DK>(&ts, a.st, 2 * n, BH, DV, (long long)BH * DV * DK, (long long)DV * DK, DK, DV) ||
      !make_map<kC>(&td, a.dt, 2 * BH, n, DV, (long long)n * DV * kC, (long long)DV * kC, kC, DV) ||
      !make_map<DK>(&th, a.hin, 2 * BH, n, DV, (long long)n * DV * DK, (long long)DV * DK, DK, DV) ||
      !make_map<kC>(&trt, a.drt, 2 * BH, n, DV, (long long)n * DV * kC, (long long)DV * kC, kC, DV)) {
    return (int)cudaErrorInvalidValue;
  }
  static const int smem_err = set_smem(gdn_tc_chunk_kernel<DK, DK, true>, chunk_smem<DK, DK>()) |
                              set_smem(gdn_tc_reverse_kernel<DK>, reverse_smem<DK>()) |
                              set_smem(gdn_tc_grad_kernel<DK, DV>, grad_smem<DK, DV>());
  if (smem_err) return smem_err;
  gdn_tc_chunk_kernel<DK, DK, true><<<dim3(n, BH), kWG, chunk_smem<DK, DK>(), stream>>>(a, tk, tq);
  gdn_tc_reverse_kernel<DK><<<dim3(DV / 64, BH), kWG, reverse_smem<DK>(), stream>>>(a, tk, tq, txp, tdo);
  gdn_tc_grad_kernel<DK, DV><<<dim3(n, BH), kWG, grad_smem<DK, DV>(), stream>>>(a, tq, tk, tdo, td, trt, ts, th);
  return (int)cudaGetLastError();
}

void count_call(int backward) { __atomic_fetch_add(&llmq_gdn_tc_calls[backward], 1, __ATOMIC_RELAXED); }

}  // namespace

bool gdn_tc_takes(int DK, int DV) { return (DK == 64 || DK == 128) && (DV == 64 || DV == 128); }

long long gdn_tc_work_bytes(int backward, int B, int H, int S, int DK, int DV, int saved) {
  if (!gdn_tc_takes(DK, DV) || S < 1) return -1;
  return backward ? BwdWork(B, H, S, DK, DV).total : FwdWork(B, H, S, DK, DV, saved != 0).total;
}

int gdn_tc_prefill(const GdnTcCall& c, cudaStream_t stream) {
  if (!gdn_tc_takes(c.DK, c.DV) || c.S < 1) return (int)cudaErrorInvalidValue;
  int err;
  if (c.DK == 64) {
    err = c.DV == 64 ? forward<64, 64>(c, stream) : forward<64, 128>(c, stream);
  } else {
    err = c.DV == 64 ? forward<128, 64>(c, stream) : forward<128, 128>(c, stream);
  }
  if (err == 0) count_call(0);
  return err;
}

int gdn_tc_prefill_bwd(const GdnTcCall& c, cudaStream_t stream) {
  if (!gdn_tc_takes(c.DK, c.DV) || c.S < 1) return (int)cudaErrorInvalidValue;
  int err;
  if (c.DK == 64) {
    err = c.DV == 64 ? backward<64, 64>(c, stream) : backward<64, 128>(c, stream);
  } else {
    err = c.DV == 64 ? backward<128, 64>(c, stream) : backward<128, 128>(c, stream);
  }
  if (err == 0) count_call(1);
  return err;
}

}  // namespace llmq
