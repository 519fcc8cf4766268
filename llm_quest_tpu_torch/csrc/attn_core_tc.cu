// Attention core of the int8-score ablation on Hopper's tensor cores
// (sm_90a): K12, both variants.
//
// Replaces scripts/ablate_int8_scores.py::make_attn_core (kernel
// _attn_kernel :41, pallas_call :63): for every group g of G = b * h,
// s = q[g] . k[g]^T accumulated in fp32 (bf16 q/k) or int32 (int8 q/k),
// p = s rounded to bf16, and o[g] = p . (v[g] + t[0]) with v + t a bf16 add
// rounded to bf16, the product accumulated in fp32 and stored as bf16. No
// softmax, no scale. t is a (1, 1, Kv) bf16 perturbation the timing loop
// changes on every launch. The ablation runs it at ViT-B/224's attention
// core at b 128: G 1536, M 208 (s 197 padded), D 64 in bf16; and M 224,
// D 128 (zero-padded) in int8. Kv is 64 in both, and every q/k/v/o row is
// 128 bytes.
//
// Bound: q, k, v and o are read or written once, 164 MB (bf16) or 176 MB
// (int8) at the ablation's shapes, above the 50 MB L2: 0.049 and 0.053 ms at
// 3.35 TB/s; the products take 0.017 and 0.020 ms at the tensor cores' dense
// peaks. So the loads of one group have to hide under another's products.
//
// Design.
// - Persistent blocks, one an SM at the ablation's shapes (the ring takes
//   192 KB), walk the groups g = blockIdx.x, + gridDim.x, ... A ring of
//   kStages stages, each one group's q, k and v tiles of Mp rows (M rounded
//   up to 64; the tensor maps are (row, M, G), so rows past M arrive as
//   zeros), in the 128-byte swizzle wgmma reads, is kept in flight by TMA:
//   once every warpgroup is past a group (the barrier after the next group's
//   v + t), one thread refills its stage with the group kStages ahead. So
//   the next group's loads run under this group's products and epilogue. (A
//   producer warp beside the four warpgroups capped ptxas at 96 registers a
//   thread, and the consumers spilled.)
// - Four warpgroups, one 64-row q tile each. Once a stage lands
//   they add t to V in place (each thread one 16-byte chunk of a row, its
//   column taken through the swizzle), round the sums to bf16, and fence
//   the async proxy before wgmma reads the tile.
// - Scores: per 64-key chunk, S = Q K^T on wgmma, bf16 -> fp32 (m64nNk16) or
//   s8 -> s32 (m64nNk32), N = 64 or, for the last chunk, the keys left (16,
//   32 or 48). The accumulator, rounded to bf16 in registers (int32 through
//   fp32, exact below 2^24), is the A operand of o += P (v + t) (m64n64k16,
//   V MN-major through the transpose flag), so no score leaves the
//   registers. A zero key row (past M) gives p = 0, so the padded keys add
//   nothing though v + t is t there.
// - Epilogue: each warpgroup writes its o tile as bf16 into a staging tile of
//   its own (128-byte swizzle) and one thread stores it by TMA, which drops
//   the rows past M; the store runs under the next group.
#include <type_traits>

#include "tma_wgmma.cuh"

// calls of llmq_attn_core that launched the kernel: a variable, which a
// caller reads (ctypes' in_dll) without a call into the library
extern "C" {
int llmq_attn_core_tc_launches = 0;
}

namespace llmq {
namespace {

constexpr int kRowB = 128;                 // bytes of a q/k row (64 bf16 or 128 int8) and of a v/o row (64 bf16)
constexpr int kKv = 64;                    // v/o columns
constexpr int kMaxRows = 256;              // M at most: one TMA box, four 64-row q tiles
constexpr int kNWG = 4;                    // consumer warpgroups
constexpr int kThreads = kNWG * kWG;
constexpr int kStages = 2;                 // groups in flight (three 256-row stages do not fit)
constexpr int kOTile = 64 * kRowB;         // a warpgroup's output staging tile

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// a score as fp32: as accumulated, or the exact int32 converted (|s| < 2^24)
__device__ __forceinline__ float score_f(float s) { return s; }
__device__ __forceinline__ float score_f(int s) { return __int2float_rn(s); }

// k16 step kk of the 64 x 64 score fragment, rounded to bf16, as an A operand
template <typename Acc>
__device__ __forceinline__ void p_frag(const Acc (&s)[32], int kk, uint32_t (&a)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = pack_bf16(score_f(s[8 * kk + 2 * r]), score_f(s[8 * kk + 2 * r + 1]));
}

// S = Q K^T for one chunk of N keys: four k-steps of 32 bytes a row (16 bf16
// or 32 int8), Q and K K-major in the 128-byte swizzle; the first overwrites S
template <int N, typename Acc>
__device__ __forceinline__ void score_chunk(Acc (&s)[32], uint32_t qs, uint32_t ks) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    mma_ss<N>(s, make_desc(qs + 32 * kk, 16, 8 * kRowB, 1), make_desc(ks + 32 * kk, 16, 8 * kRowB, 1), kk > 0);
  }
}

// grid: persistent blocks, block kThreads, dynamic shared memory as launch
// plans it. Acc: float (bf16 q/k) or int (int8 q/k).
template <typename Acc>
__global__ void __launch_bounds__(kThreads, 1)
    attn_core_tc_kernel(const __nv_bfloat16* __restrict__ t, int G, int M, const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap to) {
  extern __shared__ uint8_t smem_raw[];
  const int mp = (M + 63) / 64 * 64;           // rows of a loaded tile
  const uint32_t tile = mp * kRowB, stage = 3 * tile;
  const uint32_t base = smem_base(smem_raw);   // the stages: q, k, v tiles
  const uint32_t o_s = base + kStages * stage;  // kNWG staging tiles
  const uint32_t full = o_s + kNWG * kOTile;    // the stages' mbarriers
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  init_bars(full, kStages, threadIdx.x);
  // group g's tiles into stage s (thread 0)
  auto load = [&](int g, int s) {
    const uint32_t st = base + s * stage, bar = full + 8 * s;
    mbar_expect(bar, stage);
    tma_load(st, tq, bar, 0, 0, g, 0);
    tma_load(st + tile, tk, bar, 0, 0, g, 0);
    tma_load(st + 2 * tile, tv, bar, 0, 0, g, 0);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages && blockIdx.x + s * gridDim.x < G; ++s) load(blockIdx.x + s * gridDim.x, s);
  }

  // this warpgroup, warp-uniform (a shuffle from lane 0), so that the
  // descriptors built from it stay in uniform registers
  const int wg = __shfl_sync(kFullMask, warp / 4, 0);
  const int tid = threadIdx.x % kWG;
  const bool active = wg * 64 < M;  // this warpgroup's q tile holds rows
  const uint32_t o_mine = o_s + wg * kOTile;
  const int n16 = M / 16;  // 16-key steps

  // v + t: this thread's 16-byte chunk pc of rows r0, r0 + 64, ...; every
  // such row has r % 8 = r0 % 8, so the chunk holds columns 8 * lc .. + 7
  const int pc = threadIdx.x % 8, r0 = threadIdx.x / 8;
  const int lc = pc ^ (r0 % 8);
  float tf[8];
  {
    const uint4 raw = *reinterpret_cast<const uint4*>(t + 8 * lc);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) tf[j] = __bfloat162float(e[j]);
  }

  int i = 0;
  for (int g = blockIdx.x; g < G; g += gridDim.x, ++i) {
    const int s = i % kStages;
    const uint32_t st = base + s * stage;
    const uint32_t qt = st + wg * 64 * kRowB, kt = st + tile, vt = st + 2 * tile;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    for (int r = r0; r < M; r += 64) {
      const uint32_t addr = vt + r * kRowB + 16 * pc;
      uint4 w = ld_shared_v4(addr);
      uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&u[j]);
        u[j] = pack_bf16(__fadd_rn(__low2float(x), tf[2 * j]), __fadd_rn(__high2float(x), tf[2 * j + 1]));
      }
      st_shared_v4(addr, w);
    }
    fence_async_smem();
    __syncthreads();  // v + t is in place, and every warpgroup is past the last group: its stage refills
    if (threadIdx.x == 0 && i > 0 && g + (kStages - 1) * gridDim.x < G) {
      load(g + (kStages - 1) * gridDim.x, (i - 1) % kStages);
    }

    if (active) {
      float o[32];  // written first by the first product (acc 0)
      for (int c = 0; c < n16; c += 4) {
        const int w = min(4, n16 - c);  // 16-key steps of this chunk
        const uint32_t kc = kt + c * 16 * kRowB;
        Acc sc[32];
        wg_fence();
        if (w == 4) {
          score_chunk<64>(sc, qt, kc);
        } else if (w == 3) {
          score_chunk<48>(sc, qt, kc);
        } else if (w == 2) {
          score_chunk<32>(sc, qt, kc);
        } else {
          score_chunk<16>(sc, qt, kc);
        }
        wg_commit();
        wg_wait();
        fence_regs(sc);
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < w) p_frag(sc, kk, pa[kk]);
        }
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < w) {
            mma_rs<kKv>(o, pa[kk], make_desc(vt + (c + kk) * 16 * kRowB, tile, 8 * kRowB, 1), c > 0 || kk > 0);
          }
        }
        wg_commit();
        wg_wait();
        fence_regs(o);
      }
      if (tid == 0) bulk_wait_read();  // the last group's store has read the staging tile
      wg_sync(wg);
      // fragment of m64n64: element e of n8 block j at row 16 * (warp % 4) +
      // lane / 4 + 8 * (e / 2), column 8j + 2 * (lane % 4) + e % 2; the
      // staging tile keeps chunk j of row r at chunk j ^ (r % 8)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * (warp % 4) + lane / 4 + 8 * h;
#pragma unroll
        for (int j = 0; j < kKv / 8; ++j) {
          st_shared_b32(o_mine + r * kRowB + 16 * (j ^ (r % 8)) + 4 * (lane % 4),
                        pack_bf16(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]));
        }
      }
      fence_async_smem();
      wg_sync(wg);
      if (tid == 0) {
        tma_store(to, o_mine, 0, 64 * wg, g, 0);
        bulk_commit();
      }
    }
  }
  if (tid == 0) bulk_wait_read();  // no store reads the staging tile after the block exits
}

// the 4-d tensor map (row elements, M, G, 1) of a (G, M, row) tensor of
// 128-byte rows; its box is `rows` whole rows, in the 128-byte swizzle
bool make_rows_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int G, int M, int rows) {
  const cuuint64_t row_elems = type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? kRowB / 2 : kRowB;
  const cuuint64_t gb = (cuuint64_t)M * kRowB;
  return encode_map(map, type, ptr, {row_elems, (cuuint64_t)M, (cuuint64_t)G, 1}, {kRowB, gb, gb * G},
                    {(cuuint32_t)row_elems, (cuuint32_t)rows, 1, 1}, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename Acc>
int launch(const void* t, const void* q, const void* k, const void* v, void* o, int G, int M, cudaStream_t stream) {
  static const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  static const int smem_max = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const int mp = (M + 63) / 64 * 64;
  const size_t smem = kAlignSlack + (size_t)kStages * 3 * mp * kRowB + kNWG * kOTile + 8 * kStages;
  if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType qk = std::is_same_v<Acc, int> ? CU_TENSOR_MAP_DATA_TYPE_UINT8  // int8 as bytes
                                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tq, tk, tv, to;
  if (!make_rows_map(&tq, qk, q, G, M, mp) || !make_rows_map(&tk, qk, k, G, M, mp) ||
      !make_rows_map(&tv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, v, G, M, mp) ||
      !make_rows_map(&to, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, o, G, M, 64)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = attn_core_tc_kernel<Acc>;
  static const int attr_err = set_smem(kernel, smem_max);  // once: the limit, not this call's size
  if (attr_err) return attr_err;
  int per_sm = 0;  // the grid: as many blocks as fit on the card at once
  if (cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) {
    return (int)err;
  }
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  kernel<<<blocks < G ? blocks : G, kThreads, smem, stream>>>(static_cast<const __nv_bfloat16*>(t), G, M, tq, tk,
                                                              tv, to);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace llmq

using namespace llmq;

// K12: t (1, 1, 64) bf16; q/k (G, M, 64) bf16 (int8 == 0) or (G, M, 128)
// int8 (int8 == 1); v and o (G, M, 64) bf16; all contiguous, 16-byte
// aligned; M a multiple of 16, 16 <= M <= 256.
extern "C" int llmq_attn_core(int int8, const void* t, const void* q, const void* k, const void* v, void* o, int G,
                              int M, void* stream) {
  if (G <= 0 || M < 16 || M > kMaxRows || M % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = int8 ? launch<int>(t, q, k, v, o, G, M, st) : launch<float>(t, q, k, v, o, G, M, st);
  if (err == 0) __atomic_fetch_add(&llmq_attn_core_tc_launches, 1, __ATOMIC_RELAXED);
  return err;
}
