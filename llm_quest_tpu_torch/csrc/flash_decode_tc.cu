// Flash-decode over an int8 KV cache for bf16 q on Hopper's tensor cores
// (sm_90a): K10 for bf16.
//
// Replaces, for bf16 q, llm_quest_tpu/kernels/flash_decode.py::flash_decode
// (the Pallas kernel _kernel): one decode query per row, q (b, hq, 1, d)
// against k_q/v_q (b, hkv, S, d) int8 with per-(position, head) fp32 scales
// k_s/v_s and an additive fp32 bias (b, S): s_j = (q . k_q_j) (k_s_j scale)
// + bias_j, an online softmax over the keys with expf, and out = sum_j
// bf16(p_j v_s_j) v_q_j / sum_j p_j. An int8 value is exact in bf16 and JAX
// dots q with k_q cast to q's type, so bf16 products with fp32 sums keep its
// arithmetic; bf16(p v_s) is the B operand of the value product.
//
// Bound: bytes, 2 d bytes of K and V and 12 of scales and bias a key, which
// the card reads at 3.35 TB/s; the products are 4 hq d flops a key. At the
// long shape (b 16, hkv 2, S 8192, d 256) 137 MB: 0.041 ms. At decode (b 1,
// S 96) 108 KB: latency.
//
// Design.
// - A block owns a range of whole 64-key tiles of one (batch, kv head). One
//   producer warp keeps a ring of kStages tiles in flight: the int8 K and V
//   rows by TMA (boxes of 128 bytes by 64 keys, the 128-byte swizzle; keys
//   past S arrive as zeros), the tile's k_s, v_s and bias by 4-byte cp.async
//   (zero past S), all completing on the stage's mbarrier.
// - Eight consumer warps: warp w takes 16-key unit w % 4 of the tiles of
//   parity w / 4, with an online softmax of its own, and releases the stage.
//   Both products run on mma.sync m16n8k16 (bf16 -> fp32):
//   - scores S (16 rows: the q-head group, padded) = q k^T: the int8 K rows
//     are read straight from the stage 16 bytes a thread and widened to bf16
//     in registers, exactly, two values in three instructions (s8_02_bf16);
//     the contraction runs over d in a permuted order that q's fragments,
//     read once, share;
//   - out^T (d rows) = V^T P^T, so the q-head group is the product's N (8)
//     and the score accumulators, rounded as bf16(p v_s), are its B
//     fragments as they lie. V is read 4 bytes a row from four key rows and
//     widened in registers; the keys of a unit and the output's d rows are
//     permuted (rho, phi below) so that both K's and V's shared-memory reads
//     are free of bank conflicts in the swizzle.
// - The warps' partials (max, sum, output) are combined in warp order, and
//   the blocks that split one (batch, kv head) form a cluster and combine
//   theirs through distributed shared memory in rank order: one launch, no
//   atomics, the same bits every run.
#include <cooperative_groups.h>

#include "flash_decode.cuh"
#include "tma_wgmma.cuh"

// calls of launch_flash_decode_tc that launched the kernel: a variable,
// which a caller reads (ctypes' in_dll) without a call into the library
extern "C" {
int llmq_flash_decode_tc_launches = 0;
}

namespace llmq {
namespace {

namespace cg = cooperative_groups;

constexpr int kTile = 64;                 // keys a stage
constexpr int kUnit = 16;                 // keys a warp takes of a tile
constexpr int kNW = 8;                    // consumer warps: 4 units x kPar tile parities
constexpr int kPar = kNW / 4;             // tiles a block's warps take at once
constexpr int kThreads = (kNW + 1) * 32;  // and one producer warp
constexpr int kStages = 4;                // tiles in flight
static_assert(kNW % 4 == 0 && kStages * kTile * 2 >= kNW * 8 * 4,
              "whole tiles a parity, and the ring holds the warps' partials");
constexpr int kHeads = 8;                 // q heads a kv head at most (the products' N)
constexpr int kMaxSplit = 16;             // blocks a cluster (non-portable above 8)
constexpr int kSmall = 2048;              // bytes of the combine's small arrays

// the physical key (within a 16-key unit) of logical key 2t + (i & 1) + 8 (i >> 1)
// of the value product, which is also the score accumulator's column
// 2t + (i & 1) of n8 tile i >> 1: with the 128-byte swizzle (chunk c of row
// r at c ^ (r % 8)), the four rows a thread reads for V differ in r % 8 bits
// 1-2 across t, and the two K rows of a quarter warp in bit 2
__device__ __forceinline__ int rho(int t, int i) {
  const int r = 2 * t + (i >> 1);
  return (i & 1) ? (r ^ 4) + 8 : r;
}

// not volatile: a pure function of its operands, which the compiler may
// schedule among the others (the loads and conversions of other chains)
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bytes 0 and 2 of w (int8 values) as two bf16, exactly, in three
// instructions: 0x43 << 8 | (the low 7 bits) is 128 + those bits, 0x4300 or
// 0x4380 is 128 or 256 by the sign bit, and their difference is the int8
// value (every integer up to 256 is a bf16). Bytes 1 and 3 are those of w >> 8.
__device__ __forceinline__ uint32_t s8_02_bf16(uint32_t w) {
  const uint32_t m = (w & 0x007f007fu) | 0x43004300u, c = (w & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 v =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m), *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
// the mbarrier's pending count drops by one once this thread's cp.asyncs so far have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// grid (split, B * HKV), clusters of `split` blocks along x, block kThreads,
// dynamic shared memory as launch plans it. Block x takes tiles
// [T x / split, T (x + 1) / split) of the T = ceil(S / 64) of (batch, kv head) y.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_decode_tc_kernel(const DecodeArgs a, const int split, const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv) {
  constexpr int kTileB = kTile * D;   // bytes of a K (or V) tile
  constexpr int kHalves = D / 128;    // 128-byte column blocks of a row
  constexpr int kSteps = D / 16;      // k16 steps of the score product
  constexpr int kMT = D / 16;         // m16 tiles of out^T
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_base(smem_raw);          // the stages: K tile, V tile
  const uint32_t scales = base + kStages * 2 * kTileB;  // the stages' k_s, v_s, bias (64 floats each)
  const uint32_t small = scales + kStages * 3 * kTile * 4;
  const uint32_t full = small + kSmall;                // the stages' mbarriers: loaded,
  const uint32_t empty = full + 8 * kStages;           // and released by the tile's 4 warps
  uint8_t* const gen_base = smem_raw + (base - smem_u32(smem_raw));  // generic pointers to the same bytes
  const float* const sc_f = reinterpret_cast<const float*>(gen_base + (scales - base));
  float* const small_f = reinterpret_cast<float*>(gen_base + (small - base));

  const int G = a.HQ / a.HKV;
  const int bh = blockIdx.y, bi = bh / a.HKV, hk = bh % a.HKV;
  const int rank = blockIdx.x;
  const int n_all = (a.S + kTile - 1) / kTile;
  const int tile0 = n_all * rank / split, n_tiles = n_all * (rank + 1) / split - tile0;
  const int key_end = min(a.S, (tile0 + n_tiles) * kTile);  // keys past it belong to the next block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init_count(full + 8 * s, 32 + 1);  // the producer's 32 lanes' cp.asyncs and its TMA bytes
      mbar_init_count(empty + 8 * s, 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // per thread: head row g = lane / 4 and quad position t = lane % 4
  const int g = lane / 4, t = lane % 4;
  float m = -INFINITY, l = 0.f;  // the running max (head g) and this thread's share of the sum
  float acc[kMT][4];             // out^T: d rows phi(mt, g), phi(mt, g + 8); heads 2t, 2t + 1

  if (warp == kNW) {  // the producer
    const float* ksb = a.ks + bi * a.ks_sb + hk * a.ks_sh;
    const float* vsb = a.vs + bi * a.vs_sb + hk * a.vs_sh;
    const float* bsb = a.bias + bi * a.bias_sb;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages, key0 = (tile0 + i) * kTile;
      if (i >= kStages) mbar_wait(empty + 8 * s, (i / kStages - 1) & 1);
      const uint32_t sc = scales + s * 3 * kTile * 4, bar = full + 8 * s;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = key0 + lane + 32 * h, src = min(key, a.S - 1);
        const bool valid = key < a.S;
        cp_async4(sc + 4 * (lane + 32 * h), ksb + src, valid);
        cp_async4(sc + 4 * (kTile + lane + 32 * h), vsb + src, valid);
        cp_async4(sc + 4 * (2 * kTile + lane + 32 * h), bsb + src, valid);
      }
      cp_async_arrive(bar);
      if (lane == 0) {
        mbar_expect(bar, 2 * kTileB);
        const uint32_t st = base + s * 2 * kTileB;
#pragma unroll
        for (int h = 0; h < kHalves; ++h) {
          tma_load(st + h * kTile * 128, tk, bar, 128 * h, key0, hk, bi);
          tma_load(st + kTileB + h * kTile * 128, tv, bar, 128 * h, key0, hk, bi);
        }
      }
      __syncwarp();
    }
  } else {
    const int u = warp % 4;  // this warp's unit of a tile
    // q's A fragments of the score product, read once: step 4 blk + s4 takes
    // d = 64 blk + 16 t + 4 s4 + {0, 2} as logical k 2t, 2t + 1 and + {1, 3}
    // as 2t + 8, 2t + 9 (bytes 0, 2 and 1, 3 of a word of the K chunk a
    // thread reads); rows g < G, the rest zeros
    uint32_t qa[kSteps][2];
    {
      const unsigned short* qrow = static_cast<const unsigned short*>(a.q) + bi * a.q_sb + (hk * G + g) * a.q_sh;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int d0 = 64 * (st / 4) + 16 * t + 4 * (st % 4);
        uint32_t w[4] = {0, 0, 0, 0};
        if (g < G) {
#pragma unroll
          for (int e = 0; e < 4; ++e) w[e] = qrow[d0 + e];
        }
        qa[st][0] = w[0] | (w[2] << 16);
        qa[st][1] = w[1] | (w[3] << 16);
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
    // this thread's rows of a stage's tiles, the same in every tile, as byte
    // offsets in the tile's first 128-byte column block with the row's
    // swizzle folded in: chunk c of row r lies at c ^ (r % 8), and the XOR
    // with a column's high bits (a compile-time constant below) commutes
    // - K: row rho(g / 2, 2j + g % 2) of n8 tile j, the 16-byte chunk t
    //   (bits 4-5; 64-byte block bit 6 left for the XOR)
    // - V: rows rho(t, q4), the 4 bytes at column 4g (bits 2-4; the 32-byte
    //   group's bits 5-6 left for the XOR)
    // - the scales: this thread's keys rho(t, 2j + e) of the unit
    int k_off[2], v_off[4], keys[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = kUnit * u + rho(g / 2, 2 * j + g % 2);
      k_off[j] = r * 128 + ((16 * t) ^ (16 * (r % 8)));
#pragma unroll
      for (int e = 0; e < 2; ++e) keys[j][e] = kUnit * u + rho(t, 2 * j + e);
    }
#pragma unroll
    for (int q4 = 0; q4 < 4; ++q4) {
      const int r = kUnit * u + rho(t, q4);
      v_off[q4] = r * 128 + ((4 * g) ^ (16 * (r % 8)));
    }

    for (int i = warp / 4; i < n_tiles; i += kPar) {
      const int s = i % kStages;
      mbar_wait(full + 8 * s, (i / kStages) & 1);
      const int key0 = (tile0 + i) * kTile + kUnit * u;  // this unit's first key
      if (key0 < key_end) {
        // the stage's K and V tiles by generic pointers: plain loads, which the
        // compiler schedules early (the mbarrier waits fence them)
        const uint8_t* kt = gen_base + s * 2 * kTileB;
        const uint8_t* vt = kt + kTileB;
        const float* sc = sc_f + s * 3 * kTile;
        // scores: n8 tile j's column n (lane / 4 of the thread that loads it)
        // is key rho(n / 2, 2j + n % 2) of the unit; two accumulators a
        // tile (the even and odd 64-byte blocks of d), so that the products
        // form two chains of half the depth
        float sa[2][2][4] = {};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int blk = 0; blk < D / 64; ++blk) {
            const uint8_t* row = kt + (blk / 2) * kTile * 128 + (k_off[j] ^ (64 * (blk % 2)));
            const uint4 raw = *reinterpret_cast<const uint4*>(row);
            const uint32_t wds[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
            for (int s4 = 0; s4 < 4; ++s4) {
              mma16816(sa[j][blk % 2], qa[4 * blk + s4][0], 0u, qa[4 * blk + s4][1], 0u, s8_02_bf16(wds[s4]),
                       s8_02_bf16(wds[s4] >> 8));
            }
          }
        }
        // the thread's keys: n8 tile j's columns 2t + e, key rho(t, 2j + e)
        float x[2][2], mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kl = keys[j][e];
            const bool valid = (tile0 + i) * kTile + kl < key_end;
            const float dot = __fadd_rn(sa[j][0][e], sa[j][1][e]);
            x[j][e] = valid ? __fadd_rn(__fmul_rn(dot, __fmul_rn(sc[kl], a.scale)), sc[2 * kTile + kl]) : -INFINITY;
            mx = fmaxf(mx, x[j][e]);
          }
        const float m_new = fmaxf(m, quad_max(mx));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = expf(m - m_use);  // 0 while m is -inf
        float pv[2][2], psum = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kl = keys[j][e];
            const float p = expf(x[j][e] - m_use);
            psum += p;
            pv[j][e] = __fmul_rn(p, sc[kTile + kl]);  // v scales fold into p, rounded to bf16 below
          }
        l = l * alpha + psum;
        m = m_new;
        // the B fragments of out^T += V^T P^T: logical keys 2t, 2t + 1 (b0)
        // and 2t + 8, 2t + 9 (b1) of head g, as the score accumulators hold them
        const uint32_t b0 = pack_bf16(pv[0][0], pv[0][1]), b1 = pack_bf16(pv[1][0], pv[1][1]);
        // heads 2t and 2t + 1 rescale this thread's columns
        const float a_lo = __shfl_sync(kFullMask, alpha, 8 * t), a_hi = __shfl_sync(kFullMask, alpha, 8 * t + 4);
        if (__any_sync(kFullMask, a_lo != 1.f || a_hi != 1.f)) {  // no head's max moved: nothing to rescale
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            acc[mt][0] *= a_lo;
            acc[mt][1] *= a_hi;
            acc[mt][2] *= a_lo;
            acc[mt][3] *= a_hi;
          }
        }
        // V: rows rho(t, 0..3) of the unit, 4 bytes at column 32 G + 4g of
        // each; m16 tile 2G + h takes d = 32 G + 4g + 2h (row g) and + 1 (row g + 8)
#pragma unroll
        for (int G32 = 0; G32 < D / 32; ++G32) {
          uint32_t w[4];
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4) {
            w[q4] = *reinterpret_cast<const uint32_t*>(vt + (G32 / 4) * kTile * 128 + (v_off[q4] ^ (32 * (G32 % 4))));
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // bytes 2h, 2h + 1 of rows rho(t, 0) and rho(t, 1) (of rho(t, 2), rho(t, 3)), as
            // bytes 0, 2 (the A operand's row g) and 1, 3 (row g + 8)
            const uint32_t sel = h ? 0x7632u : 0x5410u;
            const uint32_t u01 = __byte_perm(w[0], w[1], sel), u23 = __byte_perm(w[2], w[3], sel);
            mma16816(acc[2 * G32 + h], s8_02_bf16(u01), s8_02_bf16(u01 >> 8), s8_02_bf16(u23),
                     s8_02_bf16(u23 >> 8), b0, b1);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with the stage
    }
    l = quad_sum(l);
  }

  // ---- the block's partials, combined in warp order
  __syncthreads();  // every warp is done with the ring: its bytes hold the partials now
  float* const part = reinterpret_cast<float*>(gen_base);  // [kNW][kHeads][D]
  float* const pm = small_f;                               // [kNW][kHeads]
  float* const pl = pm + kNW * kHeads;                     // [kNW][kHeads]
  float* const wts = pl + kNW * kHeads;                    // [kMaxSplit][kHeads]: the weights of a combine
  float* const bm = wts + kMaxSplit * kHeads;              // [kHeads]: the block's max and sum
  float* const bl = bm + kHeads;
  float* const cl = bl + kHeads;                           // [kHeads]: the cluster's sum
  if (warp < kNW) {
    if (t == 0) {
      pm[warp * kHeads + g] = m;
      pl[warp * kHeads + g] = l;
    }
    // m16 tile mt = 2 G32 + h: element e is d = 32 G32 + 4g + 2h + e / 2, head 2t + e % 2
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 32 * (mt / 2) + 4 * g + 2 * (mt % 2) + e / 2;
        part[(warp * kHeads + 2 * t + e % 2) * D + d] = acc[mt][e];
      }
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int h = threadIdx.x;
    float mb = -INFINITY, lb = 0.f;
    for (int w = 0; w < kNW; ++w) mb = fmaxf(mb, pm[w * kHeads + h]);
    for (int w = 0; w < kNW; ++w) {
      const float mw = pm[w * kHeads + h];
      const float e = mw == -INFINITY ? 0.f : expf(mw - mb);  // a warp with no key weighs nothing
      wts[w * kHeads + h] = e;
      lb += e * pl[w * kHeads + h];
    }
    bm[h] = mb;
    bl[h] = lb;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int h = idx / D, d = idx % D;
    float o = 0.f;
    for (int w = 0; w < kNW; ++w) o += wts[w * kHeads + h] * part[(w * kHeads + h) * D + d];
    part[h * D + d] = o;  // the block's output partial, in warp 0's place
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + (size_t)bh * G * D;
  if (split == 1) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
      out[idx] = __float2bfloat16_rn(part[idx] / fmaxf(bl[idx / D], 1e-30f));
    }
    return;
  }
  // ---- the cluster's partials, combined in rank order: rank r writes its
  // share of the (head, d) outputs
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (threadIdx.x < G) {
    const int h = threadIdx.x;
    float mc = -INFINITY, lc = 0.f;
    for (int q = 0; q < split; ++q) mc = fmaxf(mc, cluster.map_shared_rank(bm, q)[h]);
    for (int q = 0; q < split; ++q) {
      const float mq = cluster.map_shared_rank(bm, q)[h];
      const float e = mq == -INFINITY ? 0.f : expf(mq - mc);
      wts[q * kHeads + h] = e;
      lc += e * cluster.map_shared_rank(bl, q)[h];
    }
    cl[h] = lc;
  }
  __syncthreads();
  const int lo = G * D * rank / split, hi = G * D * (rank + 1) / split;
  for (int idx = lo + threadIdx.x; idx < hi; idx += kThreads) {
    const int h = idx / D;
    float o = 0.f;
    for (int q = 0; q < split; ++q) o += wts[q * kHeads + h] * cluster.map_shared_rank(part, q)[idx];
    out[idx] = __float2bfloat16_rn(o / fmaxf(cl[h], 1e-30f));
  }
  cluster.sync();  // no block leaves while another reads its partials
}

template <int D>
int launch(const DecodeArgs& a, int split, cudaStream_t stream) {
  static const int smem_max = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const size_t smem = kAlignSlack + (size_t)kStages * (2 * kTile * D + 3 * kTile * 4) + kSmall + 16 * kStages;
  if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  CUtensorMap tk, tv;
  const cuuint32_t box[4] = {128, kTile, 1, 1};
  if (!encode_map(&tk, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.kq, {(cuuint64_t)D, (cuuint64_t)a.S, (cuuint64_t)a.HKV,
                                                               (cuuint64_t)a.B},
                  {(cuuint64_t)a.k_ss, (cuuint64_t)a.k_sh, (cuuint64_t)a.k_sb}, box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&tv, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.vq, {(cuuint64_t)D, (cuuint64_t)a.S, (cuuint64_t)a.HKV,
                                                               (cuuint64_t)a.B},
                  {(cuuint64_t)a.v_ss, (cuuint64_t)a.v_sh, (cuuint64_t)a.v_sb}, box, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = flash_decode_tc_kernel<D>;
  static const int attr_err = [&] {
    int err = set_smem(kernel, smem_max);  // once: the limit, not this call's size
    if (err == 0) err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
  }();
  if (attr_err) return attr_err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, a.B * a.HKV);
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
  if (cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, split, tk, tv)) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

int launch_flash_decode_tc(const DecodeArgs& a, int split, cudaStream_t stream) {
  if (split < 1 || split > kMaxSplit || a.HQ % a.HKV != 0 || a.HQ / a.HKV > kHeads) return (int)cudaErrorInvalidValue;
  int err = (int)cudaErrorInvalidValue;
  if (a.D == 128) err = launch<128>(a, split, stream);
  if (a.D == 256) err = launch<256>(a, split, stream);
  if (err == 0) __atomic_fetch_add(&llmq_flash_decode_tc_launches, 1, __ATOMIC_RELAXED);
  return err;
}

}  // namespace llmq
