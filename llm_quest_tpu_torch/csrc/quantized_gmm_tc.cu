// Grouped matmul over int8 and int4 expert stacks for bf16 rows on Hopper's
// tensor cores (sm_90a): K11 for bf16.
//
// Replaces, for bf16 rows, llm_quest_tpu/kernels/quantized_gmm.py::
// quantized_ragged_dot (the Pallas kernel _qgmm_kernel, pallas_call :105):
// y[r] = (x[r] @ w_q[e(r)]) * scale[e(r)] for rows x (T, K) sorted by expert,
// w_q (E, K, N) int8, scale (E, N) fp32, the group sizes (E,) on the device.
// int8 -> bf16 is exact (|w| <= 127 < 2^8) and so are the bf16 products in
// fp32; the sums are fp32 and the scale multiplies them before the one
// rounding to bf16 (the TPU kernel rounds to bf16 before the scale).
// int4 stacks (BITS 4; JAX sends those to ragged_dot, not to its kernel):
// (E, ceil(K / 2), N) bytes, K rows 2i and 2i + 1 in the low and high
// nibbles of byte row i; values in [-8, 7] are exact in bf16 too.
//
// Bound: at decode (T 8 rows) the int8 weights of the experts hit, which
// no tile may read twice: at Qwen3-Next-small's widths (E 8, 896 <-> 3584)
// 16 MB for 5 experts, 0.0048 ms at 3.35 TB/s. At prefill (T 2400) the
// operations, 2*T*K*N = 15.4 GFLOP, 0.0156 ms at 989 TFLOP/s, which only
// the tensor cores approach (0.230 ms on the fp32 SIMT units).
//
// Design.
// - The operands are swapped: a block computes y^T tiles, kBNo output
//   channels by BR rows. A is a 64-channel slice of the expert's weights
//   per consumer warpgroup, converted from int8 to bf16 in shared memory and
//   read MN-major (N is w_q's contiguous dimension; wgmma's transpose
//   flag); B is the tile's BR rows of x, K-major. wgmma's N is then the row
//   count: 8 rows at decode waste no tensor-core work on empty rows, and one
//   kernel, templated on BR (8 to 128), serves both regimes.
// - One producer warp keeps a ring of kStages stages in flight by TMA: per
//   stage a (kBK x 64) int8 box of each warpgroup's channels and the
//   (BR x kBK) bf16 row box (128-byte swizzle, rows past T and columns past
//   K as zeros). Each consumer warpgroup widens its int8 box into a bf16
//   tile in the 128-byte swizzle wgmma reads (two tiles, so the next
//   stage's widening overlaps this stage's products), issues kBK / 16
//   products and releases the stage once they are done (wait_group 1).
// - The tile walk is read from the device: every warp scans the group sizes
//   (32 experts a step) and maps the block's row-tile index to (expert, first
//   row), so no host sync and no offsets tensor are needed. The grid covers
//   the worst case; a block past the last tile, or of an expert with no row,
//   exits before reading any weight. Rows past an expert's end are
//   multiplied (each output row depends only on its own x row) but never
//   stored.
// - K is split at decode, where too few (expert, channel) tiles exist to
//   keep the card's memory busy: `split` blocks of one cluster take
//   consecutive K ranges, leave their fp32 partials in shared memory, and
//   after a cluster barrier each sums its share of the tile's rows over the
//   cluster's partials in rank order (distributed shared memory): the same
//   order every run, no atomics, one launch.
// - int4: the weight format is the template argument BITS. A stage's
//   weight box is kBK / 2 byte rows of 64 channels (TMA's row stride stays
//   N bytes, so K % 8 and N % 16 are still the only width rules), half the
//   int8 box, and widen4 turns each byte row into two bf16 rows of the same
//   widened tile; the rest of the kernel is the int8 one. Box rows past
//   ceil(K / 2) load as zeros; the pad nibble of an odd K never reaches
//   here (K % 8 == 0).
// - Epilogue: the fp32 tile goes to shared memory, then rows are summed,
//   scaled by scale[e, n], rounded once to bf16 and stored 16 bytes a thread
//   (coalesced), only rows of the tile's expert.
#include <cooperative_groups.h>

#include <algorithm>

#include "quantized_gmm.cuh"
#include "tma_wgmma.cuh"

#ifndef LLMQ_QGMM_STAGES
#define LLMQ_QGMM_STAGES 6
#endif
#ifndef LLMQ_QGMM_BLOCKS_PER_SM
#define LLMQ_QGMM_BLOCKS_PER_SM 2
#endif

// calls of llmq_quantized_gmm that launched the tensor-core kernel: a
// variable, which a caller reads (ctypes' in_dll) without a call into the
// library
extern "C" {
int llmq_quantized_gmm_tc_launches = 0;
}

namespace llmq {
namespace {

namespace cg = cooperative_groups;

constexpr int kBK = 64;                       // K rows of a stage
constexpr int kNWG = 2;                       // consumer warpgroups, 64 channels each
constexpr int kBNo = 64 * kNWG;               // output channels of a block
constexpr int kThreads = kNWG * kWG + 32;     // the consumers and one producer warp
constexpr int kStages = LLMQ_QGMM_STAGES;     // the ring's stages at most (fewer where shared memory lacks room)
// blocks an SM the ring is cut to leave room for: one block's epilogue and
// prologue then overlap another's products and loads
constexpr int kBlocksPerSM = LLMQ_QGMM_BLOCKS_PER_SM;
constexpr int kMaxSplit = 8;                  // a portable cluster
constexpr int kCB = kBK * 128;                // bytes of a widened bf16 tile (kBK rows of 64 channels)
constexpr int kPR = kBNo + 4;                 // floats of a row of the fp32 partial tile (padded: other banks)

// byte rows of a warpgroup's weight box of a stage (int8: kBK; int4: kBK / 2), and its bytes
template <int BITS>
__host__ __device__ constexpr int box_rows() {
  return BITS == 8 ? kBK : kBK / 2;
}
template <int BITS>
__host__ __device__ constexpr int box_bytes() {
  return box_rows<BITS>() * 64;
}

// bytes of a stage (the x box, then the warpgroups' weight boxes) and of the
// region the stages share with the fp32 partial tile
template <int BR, int BITS>
__host__ __device__ constexpr int stage_bytes() {
  return BR * 128 + kNWG * box_bytes<BITS>();
}
template <int BR, int BITS>
__host__ __device__ constexpr uint32_t area_bytes(int stages) {
  const uint32_t ring = stages * stage_bytes<BR, BITS>(), part = BR * kPR * 4;
  return ((ring > part ? ring : part) + 1023u) & ~1023u;
}

#define QG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define QG_F16(i) QG_F4(i), QG_F4(i + 4), QG_F4(i + 8), QG_F4(i + 12)

// D (64 channels x N rows, fp32) (+)= A (64 channels x 16, bf16, MN-major:
// the transpose flag) B (16 x N rows, bf16, K-major), both in shared memory;
// acc 0 overwrites D (the first product: no instruction but wgmma defines
// the accumulators, which would make ptxas serialize the products)
template <int N>
__device__ __forceinline__ void mma_t(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
        : QG_F4(0)
        : "l"(da), "l"(db), "r"(acc));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, "
        "1, 0;\n}\n"
        : QG_F4(0), QG_F4(4)
        : "l"(da), "l"(db), "r"(acc));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
        : QG_F16(0)
        : "l"(da), "l"(db), "r"(acc));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, "
        "%33, p, 1, 1, 1, 0;\n}\n"
        : QG_F16(0), QG_F16(16)
        : "l"(da), "l"(db), "r"(acc));
  } else {
    static_assert(N == 128, "row tiles are 8, 16, 32, 64 or 128 rows");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
        "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 0;\n}\n"
        : QG_F16(0), QG_F16(16), QG_F16(32), QG_F16(48)
        : "l"(da), "l"(db), "r"(acc));
  }
}

#undef QG_F16
#undef QG_F4

// the consumer warpgroups alone (named barrier 3; wg_sync takes 1 and 2)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, %0;\n" ::"n"(kNWG * kWG) : "memory");
}
// bytes `sel` and sel + 1 of u (values v with the bias B added: int8 with
// their sign bit flipped, B 128; int4 nibbles with theirs flipped, B 8) as
// two bf16 values, exactly: 0x4B0000uu is 2^23 + uu as a float, and
// uu - B is v; full-rate float operations where the int conversion runs at
// a quarter of their rate
template <int B>
__device__ __forceinline__ uint32_t biased_x2_bf16(uint32_t u, int sel) {
  constexpr float kBias = 8388608.f + B;
  const float lo = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + sel)), kBias);
  const float hi = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541 + sel)), kBias);
  return pack_bf16(lo, hi);
}
__device__ __forceinline__ uint32_t s8x2_bf16(uint32_t u, int sel) { return biased_x2_bf16<128>(u, sel); }

// The warpgroup's (kBK x 64) int8 box at src (rows of 64 bytes) widened into
// the bf16 tile at dst: kBK rows of 64 channels in the 128-byte swizzle (the
// 16-byte chunk c of row k at chunk c ^ (k % 8)), as wgmma reads an MN-major
// operand. 16 int8 values a step, two steps a thread.
__device__ __forceinline__ void widen(uint32_t dst, uint32_t src, int tid) {
#pragma unroll
  for (int j = 0; j < box_bytes<8>() / 16 / kWG; ++j) {
    const int i = tid + j * kWG, k = i / 4, c = i % 4;
    const uint4 raw = ld_shared_v4(src + 16 * i);
    const uint32_t u[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u, raw.w ^ 0x80808080u};
    const uint32_t row = dst + k * 128;
    st_shared_v4(row + 16 * ((2 * c) ^ (k & 7)),
                 make_uint4(s8x2_bf16(u[0], 0), s8x2_bf16(u[0], 2), s8x2_bf16(u[1], 0), s8x2_bf16(u[1], 2)));
    st_shared_v4(row + 16 * ((2 * c + 1) ^ (k & 7)),
                 make_uint4(s8x2_bf16(u[2], 0), s8x2_bf16(u[2], 2), s8x2_bf16(u[3], 0), s8x2_bf16(u[3], 2)));
  }
}

// The warpgroup's (kBK / 2 x 64) int4 box at src (byte rows of 64 bytes)
// widened into the same bf16 tile as `widen`: byte row r gives K rows 2r
// (its low nibbles) and 2r + 1 (its high ones). 16 bytes a thread: their
// 16 channels in both rows, two 16-byte chunks each.
__device__ __forceinline__ void widen4(uint32_t dst, uint32_t src, int tid) {
#pragma unroll
  for (int j = 0; j < box_bytes<4>() / 16 / kWG; ++j) {
    const int i = tid + j * kWG, r = i / 4, c = i % 4;
    const uint4 raw = ld_shared_v4(src + 16 * i);
    const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the low nibbles to row 2r, the high ones to row 2r + 1
      uint32_t b[4];  // the nibbles as bytes v + 8
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = ((h ? u[q] >> 4 : u[q]) & 0x0F0F0F0Fu) ^ 0x08080808u;
      const int k = 2 * r + h;
      const uint32_t row = dst + k * 128;
      st_shared_v4(row + 16 * ((2 * c) ^ (k & 7)),
                   make_uint4(biased_x2_bf16<8>(b[0], 0), biased_x2_bf16<8>(b[0], 2), biased_x2_bf16<8>(b[1], 0),
                              biased_x2_bf16<8>(b[1], 2)));
      st_shared_v4(row + 16 * ((2 * c + 1) ^ (k & 7)),
                   make_uint4(biased_x2_bf16<8>(b[2], 0), biased_x2_bf16<8>(b[2], 2), biased_x2_bf16<8>(b[3], 0),
                              biased_x2_bf16<8>(b[3], 2)));
    }
  }
}

// A block's row tile: expert e's rows row0 .. min(row0 + BR, end) - 1; e < 0: none.
struct Job {
  int e, row0, end;
};

// Row tile j of the walk: the experts' tiles in expert order, ceil(g / br)
// for an expert of g rows. Taken by each warp from the group sizes, 32
// experts a step (inclusive scans of tiles and rows by shuffles).
__device__ __forceinline__ Job find_tile(const QgmmArgs& a, int br, int j) {
  const int lane = threadIdx.x % 32;
  int tiles = 0, rows = 0;  // of the experts before this step's
  for (int c = 0; c < a.E; c += 32) {
    const int g = c + lane < a.E ? group_size(a.group_sizes, a.gs64, c + lane) : 0;
    const int nt = (g + br - 1) / br;
    int st = nt, sg = g;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFullMask, st, o), v = __shfl_up_sync(kFullMask, sg, o);
      if (lane >= o) st += u, sg += v;
    }
    const int t0 = tiles + st - nt, r0 = rows + sg - g;
    const unsigned hit = __ballot_sync(kFullMask, j >= t0 && j < t0 + nt);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const int tb = __shfl_sync(kFullMask, t0, src), rb = __shfl_sync(kFullMask, r0, src);
      return {c + src, rb + (j - tb) * br, rb + __shfl_sync(kFullMask, g, src)};
    }
    tiles += __shfl_sync(kFullMask, st, 31);
    rows += __shfl_sync(kFullMask, sg, 31);
  }
  return {-1, 0, 0};
}

// grid (split * ceil(N / kBNo), row tiles), clusters of `split` blocks along
// x, block kThreads, dynamic shared memory as launch plans it. Block x
// takes channels (x / split) * kBNo .. and K part x % split of row tile y.
template <int BR, int BITS>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    quantized_gmm_tc_kernel(const QgmmArgs a, const int stages, const int split,
                            const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw) {
  constexpr int SB = stage_bytes<BR, BITS>(), WB = box_bytes<BITS>();
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x == kNWG * kWG) {  // the producer's descriptors, on their way while the walk reads the sizes
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tx)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tw)) : "memory");
  }
  const Job job = find_tile(a, BR, blockIdx.y);
  if (job.e < 0) return;  // past the last tile: no weight is read

  const uint32_t base = smem_base(smem_raw);
  const uint32_t area = area_bytes<BR, BITS>(stages);
  const uint32_t conv = base + area;             // kNWG x 2 widened tiles
  const uint32_t full = conv + kNWG * 2 * kCB;   // the stages' mbarriers: loaded,
  const uint32_t empty = full + 8 * stages;      // and released by both warpgroups
  float* part = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));  // the fp32 tile, over the ring

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rank = blockIdx.x % split, n0 = (blockIdx.x / split) * kBNo;
  const int n_k = (a.K + kBK - 1) / kBK;
  const int kb = n_k * rank / split, nk = n_k * (rank + 1) / split - kb;  // this block's K stages

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init_count(full + 8 * s, 1);
      mbar_init_count(empty + 8 * s, kNWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kNWG * 4) {  // the producer
    if (lane == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % stages, k0 = (kb + i) * kBK;
        if (i >= stages) mbar_wait(empty + 8 * s, (i / stages - 1) & 1);
        const uint32_t st = base + s * SB, bar = full + 8 * s;
        mbar_expect(bar, SB);
        tma_load(st, tx, bar, k0, job.row0, 0, 0);
#pragma unroll
        for (int w = 0; w < kNWG; ++w)
          tma_load(st + BR * 128 + w * WB, tw, bar, n0 + 64 * w, k0 * BITS / 8, job.e, 0);  // byte row of K row k0
      }
    }
    __syncwarp();
  } else {
    // this warpgroup, warp-uniform (a shuffle from lane 0), so that the
    // descriptors built from it stay in uniform registers
    const int wg = __shfl_sync(kFullMask, warp / 4, 0);
    const int tid = threadIdx.x % kWG;
    const uint32_t mine = conv + wg * 2 * kCB;
    float acc[BR / 2];  // written first by the first product (acc 0)
    for (int i = 0; i < nk; ++i) {
      const int s = i % stages;
      const uint32_t st = base + s * SB, cv = mine + (i & 1) * kCB;
      mbar_wait(full + 8 * s, (i / stages) & 1);
      // the products of stage i - 2, which read cv, are done
      if constexpr (BITS == 8) {
        widen(cv, st + BR * 128 + wg * WB, tid);
      } else {
        widen4(cv, st + BR * 128 + wg * WB, tid);
      }
      fence_async_smem();
      wg_sync(wg);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A: rows 16kk .. of the widened tile (MN-major); B: columns 16kk .. of the x box (K-major)
        mma_t<BR>(acc, make_desc(cv + 16 * kk * 128, 64 * 128, 8 * 128, 1), make_desc(st + 32 * kk, 16, 8 * 128, 1),
                  i > 0 || kk > 0);
      }
      wg_commit();
      wg_wait1();  // stage i - 1's products are done: its stage goes back to the producer
      if (i > 0 && tid == 0) mbar_arrive(empty + 8 * ((i - 1) % stages));
    }
    wg_wait();
    fence_regs(acc);
    consumers_sync();  // both warpgroups' products are done: the fp32 tile may overwrite the ring
    // accumulator fragment of m64nBR: element e of n8 block jb is channel
    // 16 * warp + lane / 4 + 8 * (e / 2) and row 8 * jb + 2 * (lane % 4) + e % 2
    const int ch = 64 * wg + 16 * (warp % 4) + lane / 4;
#pragma unroll
    for (int jb = 0; jb < BR / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[(8 * jb + 2 * (lane % 4) + (e & 1)) * kPR + ch + 8 * (e / 2)] = acc[4 * jb + e];
  }

  // rows [BR * rank / split, BR * (rank + 1) / split) of the tile, summed
  // over the cluster's partials in rank order, scaled, rounded and stored
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  constexpr int CPR = kBNo / 8;  // 16-byte output chunks of a tile row
  const int r_lo = BR * rank / split, r_hi = BR * (rank + 1) / split;
  const int end = min(job.end, a.T);
  const float* scale = a.scale + (size_t)job.e * a.N;
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(a.y);
  for (int i = threadIdx.x; i < (r_hi - r_lo) * CPR; i += kThreads) {
    const int r = r_lo + i / CPR, c = i % CPR;
    const int row = job.row0 + r, n = n0 + 8 * c;
    if (row >= end || n >= a.N) continue;
    float v[8];
    for (int q = 0; q < split; ++q) {
      const float* p = (split > 1 ? cluster.map_shared_rank(part, q) : part) + r * kPR + 8 * c;
      const float4 lo = *reinterpret_cast<const float4*>(p), hi = *reinterpret_cast<const float4*>(p + 4);
      const float w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = q == 0 ? w[t] : __fadd_rn(v[t], w[t]);
    }
    const float4 s0 = *reinterpret_cast<const float4*>(scale + n);
    const float4 s1 = *reinterpret_cast<const float4*>(scale + n + 4);
    *reinterpret_cast<uint4*>(y + (size_t)row * a.N + n) =
        make_uint4(pack_bf16(__fmul_rn(v[0], s0.x), __fmul_rn(v[1], s0.y)),
                   pack_bf16(__fmul_rn(v[2], s0.z), __fmul_rn(v[3], s0.w)),
                   pack_bf16(__fmul_rn(v[4], s1.x), __fmul_rn(v[5], s1.y)),
                   pack_bf16(__fmul_rn(v[6], s1.z), __fmul_rn(v[7], s1.w)));
  }
  if (split > 1) cluster.sync();  // no block leaves while another reads its partials
}

// ------------------------------------------------------------------ launches

template <int BR, int BITS>
int launch(const QgmmArgs& a, int split, cudaStream_t stream) {
  static const int smem_max = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  static const int smem_sm = device_attr(cudaDevAttrMaxSharedMemoryPerMultiprocessor);
  static const int reserved = device_attr(cudaDevAttrReservedSharedMemoryPerBlock);
  auto smem_of = [](int s) { return kAlignSlack + area_bytes<BR, BITS>(s) + kNWG * 2 * kCB + 16 * s; };
  int stages = kStages;  // the most that leave room for kBlocksPerSM blocks (2 at least)
  while (stages > 2 && kBlocksPerSM * (smem_of(stages) + reserved) > (size_t)smem_sm) --stages;
  const size_t smem = smem_of(stages);
  if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;

  // x (T, K) bf16: boxes of kBK columns by BR rows, 128-byte swizzle;
  // w_q (E, KS, N) bytes (KS = K, or ceil(K / 2) packed int4): boxes of 64
  // channels by box_rows byte rows, as they lie
  const int ks = stored_rows(a.K, BITS);
  const cuuint64_t tk = (cuuint64_t)a.T * a.K * 2, ekn = (cuuint64_t)a.E * ks * a.N;
  CUtensorMap tx, tw;
  if (!encode_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, {(cuuint64_t)a.K, (cuuint64_t)a.T, 1, 1},
              {(cuuint64_t)a.K * 2, tk, tk}, {kBK, BR, 1, 1}, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.w, {(cuuint64_t)a.N, (cuuint64_t)ks, (cuuint64_t)a.E, 1},
              {(cuuint64_t)a.N, (cuuint64_t)ks * a.N, ekn}, {64, box_rows<BITS>(), 1, 1},
              CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = quantized_gmm_tc_kernel<BR, BITS>;
  static const int attr_err = set_smem(kernel, smem_max);  // once: the limit, not this call's size
  if (attr_err) return attr_err;

  // row tiles: at most T / BR plus one partial tile per expert with rows
  const int hit = std::min(a.E, a.T);
  const unsigned tiles = (unsigned)(((long long)a.T + (long long)hit * (BR - 1)) / BR);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split * ((a.N + kBNo - 1) / kBNo), tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  if (cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, stages, split, tx, tw)) return (int)err;
  return (int)cudaGetLastError();
}

template <int BITS>
int launch_bits(const QgmmArgs& a, int br, int split, cudaStream_t stream) {
  if (br == 8) return launch<8, BITS>(a, split, stream);
  if (br == 16) return launch<16, BITS>(a, split, stream);
  if (br == 32) return launch<32, BITS>(a, split, stream);
  if (br == 64) return launch<64, BITS>(a, split, stream);
  if (br == 128) return launch<128, BITS>(a, split, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

int launch_qgmm_tc(const QgmmArgs& a, int br, int split, cudaStream_t stream) {
  const int n_k = (a.K + kBK - 1) / kBK;
  if (a.K % 8 != 0 || a.N % 16 != 0 || split < 1 || split > std::min(kMaxSplit, n_k)) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = a.bits == 4 ? launch_bits<4>(a, br, split, stream) : launch_bits<8>(a, br, split, stream);
  if (err == 0) __atomic_fetch_add(&llmq_quantized_gmm_tc_launches, 1, __ATOMIC_RELAXED);
  return err;
}

}  // namespace llmq
