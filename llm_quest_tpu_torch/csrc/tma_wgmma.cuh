// Hopper primitives shared by the tensor-core kernels (attention_tc.cu,
// attn_core_tc.cu, flash_decode_tc.cu, fused_mha_tc.cu, gdn_tc.cu,
// packed_mha_int8_tc.cu, quantized_gmm_tc.cu): mbarriers, TMA tile copies
// (loads, and stores from shared memory) through 4-d tensor maps, wgmma.mma_async with
// bf16 operands and fp32 accumulators or s8 operands and s32 accumulators,
// the swizzled shared-memory tile layouts that TMA (or the threads) write
// and wgmma reads, and the host side's tensor-map encoder (bf16 or int8
// elements) and device queries. sm_90a only.
//
// Layout: every tile is bf16 rows split into column blocks of 64 (128-byte
// swizzle) or, where a width is no multiple of 64 (32, 96), of 32 (64-byte
// swizzle); a 16-byte chunk c of row r sits at chunk c ^ (r % 8) (128 B) or
// c ^ ((r / 2) % 4) (64 B). The same tile serves as a K-major operand (the
// contraction runs along its columns) and as an MN-major one with the
// transpose flag (the contraction runs along its rows).
#pragma once

#include <cuda.h>  // CUtensorMap (the encoder is reached through cudaGetDriverEntryPoint)

#include "common.cuh"

namespace llmq {
namespace {

constexpr int kWG = 128;  // threads of a warpgroup
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers (one arrival: the thread that issues a stage's copies, plus the
// copies' bytes) and TMA tile copies
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// an mbarrier that completes a phase after `count` arrivals (a consumer
// release counted per warp or warpgroup)
__device__ __forceinline__ void mbar_init_count(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one box of a 4-d tensor map (columns, seq, head, batch) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// one box of shared memory at src into a 4-d tensor map (columns, seq, head,
// batch); the rows past the tensor's end are not written. Issued by one
// thread, in the bulk group it commits next.
__device__ __forceinline__ void tma_store(const CUtensorMap& map, uint32_t src, int col, int row, int head,
                                          int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(&map)), "r"(src), "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// returns once this thread's committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// shared memory of a kernel: its tiles start at the dynamic base aligned to
// 1024 bytes (the 128-byte swizzle's period), which takes up to this much slack
constexpr size_t kAlignSlack = 1024;
__device__ __forceinline__ uint32_t smem_base(uint8_t* raw) { return (smem_u32(raw) + 1023u) & ~1023u; }

// thread 0 makes the block's n mbarriers at `bars`; every thread waits for them
__device__ __forceinline__ void init_bars(uint32_t bars, int n, int tid) {
  if (tid == 0) {
    for (int i = 0; i < n; ++i) mbar_init(bars + 8 * i);
    mbar_fence_init();
  }
  __syncthreads();
}

// the threads of warpgroup wg alone (named barrier 1 + wg; __syncthreads is 0)
__device__ __forceinline__ void wg_sync(int wg) { asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(kWG) : "memory"); }

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait1() { asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory"); }

// keeps the compiler from moving accumulator accesses across an async product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// 16 bytes into shared memory at a 32-bit shared address
__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
// 16 bytes from shared memory at a 32-bit shared address
__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}
// makes this thread's shared-memory stores visible to the async proxy
// (wgmma's operand reads); a barrier after it orders them for the issuers
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// wgmma matrix descriptor: start address, leading and stride byte offsets,
// swizzle mode (1 = 128 B, 2 = 64 B)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (static_cast<uint64_t>(mode) << 62);
}

#define LLMQ_F8(i)                                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
      "+f"(d[i + 7])
#define LLMQ_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define LLMQ_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define LLMQ_D24                                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
  "%22, %23}"
#define LLMQ_D32                                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// S (64 x N, fp32) (+)= A (64 x 16) B (16 x N), both K-major in shared
// memory, N 16, 32, 48 or 64: the first N / 2 registers of d (the fragment
// of m64nN is the first N / 2 of m64n64's), the others untouched
template <int N = 64>
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LLMQ_D32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : LLMQ_F8(0), LLMQ_F8(8), LLMQ_F8(16), LLMQ_F8(24)
        : "l"(da), "l"(db), "r"(acc));
  } else if constexpr (N == 48) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 " LLMQ_D24 ", %24, %25, p, 1, 1, 0, 0;\n}\n"
        : LLMQ_F8(0), LLMQ_F8(8), LLMQ_F8(16)
        : "l"(da), "l"(db), "r"(acc));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " LLMQ_D16 ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : LLMQ_F8(0), LLMQ_F8(8)
        : "l"(da), "l"(db), "r"(acc));
  } else {
    static_assert(N == 16, "score pieces are 16, 32, 48 or 64 keys wide");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " LLMQ_D8 ", %8, %9, p, 1, 1, 0, 0;\n}\n"
        : LLMQ_F8(0)
        : "l"(da), "l"(db), "r"(acc));
  }
}

// D (64 x N, fp32) += A (64 x 16, bf16 fragments in registers) B (16 x N),
// B MN-major (transposed) in shared memory; acc 0 overwrites D
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int acc = 1) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LLMQ_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : LLMQ_F8(0), LLMQ_F8(8), LLMQ_F8(16), LLMQ_F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  } else {
    static_assert(N == 32, "N chunks are 64 or 32 columns");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " LLMQ_D16
        ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : LLMQ_F8(0), LLMQ_F8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
}

#define LLMQ_I8(i)                                                                                       \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), \
      "+r"(d[i + 7])

// S (64 x N, s32) (+)= A (64 x 32) B (32 x N), s8, both K-major in shared
// memory (8-bit wgmma takes no other), N 16, 32, 48 or 64: the first N / 2
// registers of d, as in the bf16 form above; the fragment's layout is the
// fp32 accumulator's
template <int N = 64>
__device__ __forceinline__ void mma_ss(int (&d)[32], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " LLMQ_D32 ", %32, %33, p;\n}\n"
        : LLMQ_I8(0), LLMQ_I8(8), LLMQ_I8(16), LLMQ_I8(24)
        : "l"(da), "l"(db), "r"(acc));
  } else if constexpr (N == 48) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 " LLMQ_D24 ", %24, %25, p;\n}\n"
        : LLMQ_I8(0), LLMQ_I8(8), LLMQ_I8(16)
        : "l"(da), "l"(db), "r"(acc));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 " LLMQ_D16 ", %16, %17, p;\n}\n"
        : LLMQ_I8(0), LLMQ_I8(8)
        : "l"(da), "l"(db), "r"(acc));
  } else {
    static_assert(N == 16, "score pieces are 16, 32, 48 or 64 keys wide");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 " LLMQ_D8 ", %8, %9, p;\n}\n"
        : LLMQ_I8(0)
        : "l"(da), "l"(db), "r"(acc));
  }
}

#undef LLMQ_I8
#undef LLMQ_F8
#undef LLMQ_D8
#undef LLMQ_D16
#undef LLMQ_D24
#undef LLMQ_D32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A bf16 tile of R rows by C columns in shared memory, in column blocks of
// BW (64: 128-byte swizzle; 32: 64-byte swizzle), each block R rows of BW:
// the 16-byte chunk c of row r sits at chunk c ^ (r % 8) (128 B) or
// c ^ ((r / 2) % 4) (64 B), as TMA writes it and wgmma reads it. The
// functions taking `rows` address a tile of the same columns whose row
// count is known only at run time (a multiple of 16).
template <int R, int C>
struct Tile {
  static_assert(C % 32 == 0 && R % 16 == 0, "tiles are 16-row multiples of 32 columns");
  static constexpr int BW = C % 64 == 0 ? 64 : 32;
  static constexpr int ROWB = BW * 2;
  static constexpr int BLOCKB = R * ROWB;
  static constexpr int BYTES = (C / BW) * BLOCKB;
  static constexpr int MODE = BW == 64 ? 1 : 2;

  // the contraction along the columns: rows row0 .. row0 + 63, columns 16kk .. 16kk + 15
  __device__ static __forceinline__ uint64_t kmajor(uint32_t base, int row0, int kk, int rows = R) {
    return make_desc(base + (16 * kk / BW) * rows * ROWB + row0 * ROWB + (16 * kk % BW) * 2, 16, 8 * ROWB, MODE);
  }
  // the contraction along the rows: rows 16kk .. 16kk + 15, columns of block nb
  __device__ static __forceinline__ uint64_t mnmajor(uint32_t base, int kk, int nb, int rows = R) {
    return make_desc(base + nb * rows * ROWB + 16 * kk * ROWB, rows * ROWB, 8 * ROWB, MODE);
  }
  // rows row0 .. row0 + rows - 1 of (batch, head) of a tensor map whose box
  // is (BW, rows): one TMA copy a column block, each writing its block's
  // swizzle; rows past the tensor's end arrive as zeros. Issued by one thread.
  __device__ static __forceinline__ void tma(uint32_t base, const CUtensorMap& map, uint32_t bar, int row0, int head,
                                             int batch, int rows = R) {
#pragma unroll
    for (int nb = 0; nb < C / BW; ++nb) tma_load(base + nb * rows * ROWB, map, bar, nb * BW, row0, head, batch);
  }
};

// An int8 tile of rows of RB bytes (32, 64 or 128: one head dim's row) in
// shared memory, written by the threads (not TMA) and read by the s8 wgmma
// as a K-major operand: one column block whose swizzle spans the row (the
// 32-, 64- or 128-byte swizzle), so the 16-byte chunk c of row r sits at
// chunk c ^ ((r / 4) % 2), c ^ ((r / 2) % 4) or c ^ (r % 8). A tile starts
// on a 1024-byte boundary.
template <int RB>
struct I8Tile {
  static_assert(RB == 32 || RB == 64 || RB == 128, "int8 rows are 32, 64 or 128 bytes");
  static constexpr int MODE = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  // the shared address of chunk c of row r
  __device__ static __forceinline__ uint32_t at(uint32_t base, int r, int c) {
    const int swz = RB == 128 ? r & 7 : RB == 64 ? (r >> 1) & 3 : (r >> 2) & 1;
    return base + r * RB + 16 * (c ^ swz);
  }
  // the contraction along the row: rows row0 .. row0 + 63, bytes 32kk .. 32kk + 31
  __device__ static __forceinline__ uint64_t kmajor(uint32_t base, int row0, int kk) {
    return make_desc(base + row0 * RB + 32 * kk, 16, 8 * RB, MODE);
  }
};

// accumulator fragment of m64nN: element e (0..3) of n8 block j sits at row
// 16 * warp + lane / 4 + 8 * (e / 2), column 8j + 2 * (lane % 4) + e % 2.
// The 4 threads of a row are lanes 4g .. 4g + 3.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  return x + __shfl_xor_sync(kFullMask, x, 2);
}

// k16 step kk of the 64 x 64 fp32 fragment s (keys or query rows along N)
// as a bf16 A operand
__device__ __forceinline__ void to_a_frag(const float (&s)[32], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}
// all four k16 steps of it
__device__ __forceinline__ void to_a_frags(const float (&s)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) to_a_frag(s, kk, a[kk]);
}

// ------------------------------------------------------------------ host side

// an attribute of the current device
int device_attr(cudaDeviceAttr attr) {
  int dev = 0, value = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&value, attr, dev);
  return value;
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  // above 48 KB the launch is refused unless the kernel's limit is raised
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, found once through the runtime, so the
// library links without -lcuda
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const bool ok = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) == cudaSuccess &&
                    found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a 4-d tensor map (innermost dimension first) of `type` elements (bf16
// operands, or int8 weights as bytes), with the byte strides of dimensions
// 1 .. 3; out-of-bounds elements arrive as zeros; false if the encoder
// refuses it
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, const cuuint64_t (&dims)[4],
                const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4], CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encoder();
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the 4-d tensor map (columns, seq, head, batch) of a bf16 (b, h, s, C)
// operand with (batch, head, seq) strides in elements; its box is one column
// block of a Tile of `rows` rows (at most 256), swizzled as wgmma reads it;
// false if the encoder refuses it
template <int C>
bool make_map(CUtensorMap* map, const void* ptr, int B, int H, int S, long long sb, long long sh, long long ss,
              int rows) {
  using T = Tile<16, C>;
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr,
                    {(cuuint64_t)C, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B},
                    {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2},
                    {(cuuint32_t)T::BW, (cuuint32_t)rows, 1, 1},
                    T::MODE == 1 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

}  // namespace
}  // namespace llmq
