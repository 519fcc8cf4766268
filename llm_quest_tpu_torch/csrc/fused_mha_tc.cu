// Short-sequence attention for bf16 inputs on Hopper's tensor cores (sm_90a):
// the forward of K6 and of K7, one kernel body.
//
// Replaces, for bf16 inputs:
//   llm_quest_tpu/kernels/fused_mha.py::fused_mha (_fused_mha_kernel,
//     pallas_call :95): (b, h, s, d) heads, optionally causal; p cast to
//     v's type before p.V and the denominator from a ones column appended to
//     V, so it sums the rounded p;
//   llm_quest_tpu/kernels/fused_mha.py::packed_mha (_packed_mha_kernel,
//     pallas_call :205): bidirectional, read from the packed (b, s, h*d)
//     projections by stride; p cast to v's type before p.V, the denominator
//     the fp32 sum of p.
// Which denominator is ShortArgs::fp32_den. Both TPU kernels hold a head's
// whole (s, s) score tile on chip and take the softmax in one pass; this one
// keeps the head's K and V on chip and rescales once every 128 keys.
// Maskless, as many k/v heads as q heads, head dims 32, 64 and 128,
// 1 <= s <= 1024. With an lse pointer the kernel also writes the fp32 row
// logsumexp of the exact softmax, m + log(sum of fp32 p), for the recompute
// backward (attention.cu / attention_tc.cu), whatever the denominator: JAX's
// backward of both is the exact sdpa gradient. That backward takes
// delta = rowsum(dO * O) from this kernel's bf16 output, as K4's does.
//
// Bound: the bytes. At ViT-B's heads (b 128, 12 heads, s 197, d 64) q, k,
// v and o are 155 MB, 0.046 ms at 3.35 TB/s; the two products are 15.3
// GFLOP, 0.015 ms at 989 TFLOP/s. So each head's K and V are read once, and
// the scores never leave the registers.
//
// Design.
// - A block owns one (batch, head), or a share of its 64-row query tiles
//   where b*h alone would not fill the card (the causal fallback's b 4 x 16
//   heads). Thread 0 loads the head's K and V once by TMA (tma_wgmma.cuh)
//   into shared memory, s rounded up to 16 rows (in boxes of at most 256
//   rows; rows past s arrive as zeros): at ViT-B 208 rows, 53 KB. Two
//   consumer warpgroups (kConsumers) take the block's query tiles in turn
//   and share that one load: at ViT-B two blocks (four warpgroups, 126
//   registers a thread) share an SM, faster on the H100 than one warpgroup
//   a block, three blocks an SM (PERF.md). Where K and V do not fit (d 64
//   near s 1024, d 128 past s 384) the block is one warpgroup and they pass
//   through a ring of two 128-key slots, which each query tile streams
//   again from L2. Each warpgroup's query tiles pass through two stages of
//   its own: the next tile is in flight while this one multiplies.
// - Scores: S = Q K^T for a 64-row tile and a 128-key chunk is one m64n64k16
//   product per 64 keys and k16 step, the last one only as wide as the keys
//   left (n16, n32 or n48); a causal tile stops at its last row's key. The
//   chunk's scores stay in the accumulator registers (64 fp32 a thread):
//   keys past s (or the row) at -inf, the row max by shuffles (4 threads a
//   row), exp2, and one online rescale a chunk. Holding the whole row of 256
//   keys instead (one pass, no rescale) took twice the score registers,
//   fewer blocks an SM, and was slower at ViT-B on the H100 (PERF.md).
// - P V: p is rounded to bf16 in registers and fed as the register A operand
//   of m64nBWk16 products with V as the MN-major operand (the transpose
//   flag), so V keeps its (key, d) rows; fp32 accumulators.
// - Issue is synchronous (fence, issue, commit, wait for 0), as in
//   attention_tc.cu.
#include <algorithm>
#include <atomic>

#include "fused_mha.cuh"
#include "tma_wgmma.cuh"

namespace llmq {
namespace {

constexpr int kQT = 64;      // query rows a tile (one warpgroup's m64)
constexpr int kPiece = 64;   // keys of one full score product (m64n64)
constexpr int kChunk = 128;  // keys whose scores a thread holds at once (64 fp32 registers)
// consumer warpgroups a block where the head's K and V are resident (and
// the head has more than one query tile): they share the block's one K/V load
constexpr int kConsumers = 2;

// The host's choices for a call, passed by value.
struct ShortPlan {
  int resident;  // 1: the head's K and V (the keys the block needs) are loaded once; 0: a ring of 2 slots
  int kr;        // rows of one K (or V) box (at most 256, a multiple of 16): resident s rounded up to 16
                 // over the boxes, ring kChunk
  int boxes;     // resident: boxes a head's K takes (its tile is boxes * kr rows)
  int groups;    // blocks that share one head's query tiles
};

// S (+)= Q K^T for one 64-key piece of N keys (K rows key0 .. of a tile of
// `rows` rows): D / 16 k16 steps
template <int D, int N>
__device__ __forceinline__ void score_piece(float (&s)[32], uint32_t qs, uint32_t ks, int key0, int rows) {
  using QT = Tile<kQT, D>;
  using KT = Tile<kPiece, D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) mma_ss<N>(s, QT::kmajor(qs, 0, kk), KT::kmajor(ks, key0, kk, rows), kk > 0);
}

// grid (b*h, groups), block NWG warpgroups, dynamic smem as launch plans it.
// Warpgroup w of block y takes the head's tiles r, r + G, ... with
// G = groups * NWG and r = G - 1 - (y * NWG + w): the last tiles (the
// longest causal rows) go first. The head's K and V, resident or in the
// ring (NWG 1 only), are the block's; each warpgroup has its own 2 Q stages.
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * kWG)
    fused_mha_tc_kernel(const ShortArgs a, const ShortPlan p, const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv) {
  using QT = Tile<kQT, D>;
  using KT = Tile<kPiece, D>;  // K or V: resident p.boxes * p.kr rows, a ring slot p.kr
  constexpr int BW = QT::BW;
  constexpr int NB = D / BW;  // output column blocks
  constexpr int KC = kChunk;
  constexpr int NCH = KC / kPiece;  // score pieces a chunk
  extern __shared__ uint8_t smem_raw[];
  // this warpgroup, warp-uniform (a shuffle from lane 0), so that the Q
  // descriptors built from it stay in uniform registers
  const int wg = NWG == 1 ? 0 : __shfl_sync(0xffffffffu, (int)threadIdx.x / kWG, 0);
  const uint32_t q_s = smem_base(smem_raw) + wg * 2 * QT::BYTES;  // this warpgroup's 2 stages
  const uint32_t kv_s = smem_base(smem_raw) + NWG * 2 * QT::BYTES;  // K then V (resident), or 2 slots of K then V
  const int kv_rows = p.resident ? p.boxes * p.kr : p.kr;  // rows of a K (or V) tile
  const uint32_t half = kv_rows * D * 2;                    // its bytes
  const uint32_t bars = kv_s + (p.resident ? 2 : 4) * half;  // 2 * NWG + 2 mbarriers
  const uint32_t q_bar = bars + 8 * 2 * wg;                  // this warpgroup's 2 stages'
  const uint32_t kv_bar = bars + 8 * 2 * NWG;                // the 2 K/V slots' (resident: one)

  const int bh = blockIdx.x;
  const int bi = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x % kWG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_qt = (a.S + kQT - 1) / kQT;
  const int G = p.groups * NWG;
  auto first_of = [&](int w) { return G - 1 - (int)blockIdx.y * NWG - w; };
  auto count_of = [&](int r0) { return (n_qt - r0 + G - 1) / G; };
  auto keys_at = [&](int qt) { return a.causal ? min(a.S, (qt + 1) * kQT) : a.S; };  // the keys tile qt sees
  const int r = first_of(wg), n_mine = count_of(r);
  auto keys_of = [&](int i) { return keys_at(r + i * G); };  // the keys tile i of this warpgroup sees

  init_bars(bars, 2 * NWG + 2, threadIdx.x);
  // rows row0 .. row0 + p.kr - 1 of K and V into the tiles at ks (K) and
  // ks + half (V), at row `at`; completes on `bar`
  auto load_box = [&](uint32_t ks, int at, int row0, uint32_t bar) {
#pragma unroll
    for (int nb = 0; nb < D / BW; ++nb) {
      const uint32_t off = (nb * kv_rows + at) * KT::ROWB;
      tma_load(ks + off, tk, bar, nb * BW, row0, h, bi);
      tma_load(ks + half + off, tv, bar, nb * BW, row0, h, bi);
    }
  };
  // the ring's next load (NWG 1): chunk pc of tile pi into slot pj & 1, pj its step
  int pi = 0, pc = 0, pj = 0;
  auto load_next = [&]() {
    if (pi >= n_mine) return;
    if (tid == 0) {
      const uint32_t bar = kv_bar + 8 * (pj & 1);
      mbar_expect(bar, 2 * half);
      load_box(kv_s + (pj & 1) * 2 * half, 0, pc * KC, bar);
    }
    ++pj;
    if (++pc * KC >= keys_of(pi)) pc = 0, ++pi;
  };
  if (tid == 0) {
    mbar_expect(q_bar, QT::BYTES);
    QT::tma(q_s, tq, q_bar, r * kQT, h, bi);
  }
  if (threadIdx.x == 0 && p.resident) {  // the boxes the block's longest tile sees, once
    int keys = 0;
    for (int w = 0; w < NWG; ++w) keys = max(keys, keys_at(first_of(w) + (count_of(first_of(w)) - 1) * G));
    const int n = (keys + p.kr - 1) / p.kr;
    mbar_expect(kv_bar, 2u * n * p.kr * D * 2);
    for (int b = 0; b < n; ++b) load_box(kv_s, b * p.kr, b * p.kr, kv_bar);
  }
  if (!p.resident) {
    load_next();
    load_next();
  }

  int j = 0;  // the ring's step
  for (int i = 0; i < n_mine; ++i) {
    const int q0 = (r + i * G) * kQT;
    const uint32_t qs = q_s + (i & 1) * QT::BYTES;
    mbar_wait(q_bar + 8 * (i & 1), (i >> 1) & 1);
    wg_sync(wg);  // this tile has landed, and the warpgroup is done with the stage refilled next
    if (tid == 0 && i + 1 < n_mine) {  // in flight while this tile multiplies
      const uint32_t bar = q_bar + 8 * ((i + 1) & 1);
      mbar_expect(bar, QT::BYTES);
      QT::tma(q_s + ((i + 1) & 1) * QT::BYTES, tq, bar, q0 + G * kQT, h, bi);
    }
    const int k_end = keys_of(i);
    const int row0 = q0 + 16 * warp + g;  // rows row0 and row0 + 8 of this thread

    float o[NB][BW / 2];  // p V, p rounded to bf16
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < BW / 2; ++e) o[nb][e] = 0.f;
    // per row: max (base 2), this thread's share of the fp32 and the rounded sums
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, lr[2] = {0.f, 0.f};

    for (int k0 = 0; k0 < k_end; k0 += KC) {
      // the chunk's K and V: rows k0 .. of the resident tiles, or a ring slot
      const int slot = p.resident ? 0 : j & 1;
      mbar_wait(kv_bar + 8 * slot, p.resident ? 0 : (j >> 1) & 1);
      const uint32_t ks = kv_s + slot * 2 * half, vs = ks + half;
      const int kbase = p.resident ? k0 : 0;
      const int n16 = (min(KC, k_end - k0) + 15) / 16;  // 16-key steps of this chunk the tile sees

      float s[NCH][32];
      wg_fence();
#pragma unroll
      for (int pc4 = 0; pc4 < NCH; ++pc4) {
        const int w = n16 - 4 * pc4;  // 16-key steps in this piece
        if (w >= 4) {
          score_piece<D, 64>(s[pc4], qs, ks, kbase + kPiece * pc4, kv_rows);
        } else if (w == 3) {
          score_piece<D, 48>(s[pc4], qs, ks, kbase + kPiece * pc4, kv_rows);
        } else if (w == 2) {
          score_piece<D, 32>(s[pc4], qs, ks, kbase + kPiece * pc4, kv_rows);
        } else if (w == 1) {
          score_piece<D, 16>(s[pc4], qs, ks, kbase + kPiece * pc4, kv_rows);
        }
      }
      wg_commit();
      wg_wait();
#pragma unroll
      for (int pc4 = 0; pc4 < NCH; ++pc4) fence_regs(s[pc4]);

      // scaled to base 2; keys past s or past the row at -inf (a piece the
      // tile does not reach is never read)
      const float sl = a.scale * kLog2e;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int pc4 = 0; pc4 < NCH; ++pc4) {
        if (4 * pc4 >= n16) continue;
        const int kp0 = k0 + kPiece * pc4;
        if (kp0 + kPiece <= a.S && (!a.causal || kp0 + kPiece - 1 <= q0)) {  // every row sees the whole piece
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            s[pc4][e] *= sl;
            mx[(e / 2) & 1] = fmaxf(mx[(e / 2) & 1], s[pc4][e]);
          }
          continue;
        }
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          if (e / 8 >= n16 - 4 * pc4) break;  // past the piece's 16-key steps: never read
          const int kpos = kp0 + 8 * (e / 4) + 2 * t + (e & 1);
          const int qpos = row0 + 8 * ((e / 2) & 1);
          const bool hidden = kpos >= a.S || (a.causal && kpos > qpos);
          s[pc4][e] = hidden ? -INFINITY : s[pc4][e] * sl;
          mx[(e / 2) & 1] = fmaxf(mx[(e / 2) & 1], s[pc4][e]);
        }
      }
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(m[hh], quad_max(mx[hh]));
        corr[hh] = exp2f(m[hh] - m_new);  // 0 on the first chunk (m = -inf)
        m[hh] = m_new;
        l[hh] *= corr[hh];
        lr[hh] *= corr[hh];
      }
#pragma unroll
      for (int pc4 = 0; pc4 < NCH; ++pc4) {
        if (4 * pc4 >= n16) continue;
        if (a.fp32_den) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            if (e / 8 >= n16 - 4 * pc4) break;
            s[pc4][e] = exp2f(s[pc4][e] - m[(e / 2) & 1]);
            l[(e / 2) & 1] += s[pc4][e];
          }
        } else {  // also the sum of p as p.V sees it, rounded to bf16
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            if (e / 8 >= n16 - 4 * pc4) break;
            s[pc4][e] = exp2f(s[pc4][e] - m[(e / 2) & 1]);
            l[(e / 2) & 1] += s[pc4][e];
            lr[(e / 2) & 1] += __bfloat162float(__float2bfloat16_rn(s[pc4][e]));
          }
        }
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < BW / 2; ++e) o[nb][e] *= corr[(e / 2) & 1];

#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);
      wg_fence();
#pragma unroll
      for (int pc4 = 0; pc4 < NCH; ++pc4)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (4 * pc4 + kk >= n16) continue;
          uint32_t af[4];
          to_a_frag(s[pc4], kk, af);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) mma_rs<BW>(o[nb], af, KT::mnmajor(vs, kbase / 16 + 4 * pc4 + kk, nb, kv_rows));
        }
      wg_commit();
      wg_wait();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);
      if (!p.resident) {
        __syncthreads();  // the block (one warpgroup) is done with this slot: the ring's next load refills it
        load_next();
        ++j;
      }
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      const float lf = quad_sum(l[hh]), lrs = quad_sum(lr[hh]);
      const float inv = 1.f / (a.fp32_den ? lf : lrs);
      if (row < a.S) {
        __nv_bfloat16* orow = row_at<__nv_bfloat16>(a.o, a.o_sb, a.o_sh, a.o_ss, bi, h, row);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int jj = 0; jj < BW / 8; ++jj)
            *reinterpret_cast<__nv_bfloat162*>(orow + nb * BW + 8 * jj + 2 * t) =
                __floats2bfloat162_rn(o[nb][4 * jj + 2 * hh] * inv, o[nb][4 * jj + 2 * hh + 1] * inv);
        if (a.lse != nullptr && t == 0) a.lse[(long long)bh * a.S + row] = (m[hh] + log2f(lf)) / kLog2e;
      }
    }
  }
}

// ------------------------------------------------------------------ launches

constexpr int kNoPlan = -1;  // launch<D, 2>: K and V are not resident, take one warpgroup a block

template <int D, int NWG>
int launch(const ShortArgs& a, cudaStream_t stream) {
  static const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  static const int smem_max = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const size_t fixed = 2 * NWG * Tile<kQT, D>::BYTES + kAlignSlack + 8 * (2 * NWG + 2);
  const int s16 = (a.S + 15) / 16 * 16;
  ShortPlan p;
  p.boxes = (s16 + 255) / 256;  // a TMA box has at most 256 rows
  p.kr = ((s16 + p.boxes - 1) / p.boxes + 15) / 16 * 16;
  p.resident = fixed + 2 * (size_t)p.boxes * p.kr * D * 2 <= (size_t)smem_max;
  if (!p.resident && NWG > 1) return kNoPlan;
  if (!p.resident) p.kr = kChunk;  // a ring of 2 slots of one chunk each
  const size_t smem = fixed + (p.resident ? 2 * (size_t)p.boxes * p.kr : 4 * (size_t)p.kr) * D * 2;
  if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  // two blocks an SM at least, where the heads alone are fewer; each
  // warpgroup has a tile at least
  const int n_qt = (a.S + kQT - 1) / kQT, heads = a.B * a.H;
  p.groups = std::max(1, std::min(n_qt / NWG, (2 * sms + heads - 1) / heads));

  CUtensorMap tq, tk, tv;
  if (!make_map<D>(&tq, a.q, a.B, a.H, a.S, a.q_sb, a.q_sh, a.q_ss, kQT) ||
      !make_map<D>(&tk, a.k, a.B, a.H, a.S, a.k_sb, a.k_sh, a.k_ss, p.kr) ||
      !make_map<D>(&tv, a.v, a.B, a.H, a.S, a.v_sb, a.v_sh, a.v_ss, p.kr)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = fused_mha_tc_kernel<D, NWG>;
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<dim3(heads, p.groups), NWG * kWG, smem, stream>>>(a, p, tq, tk, tv);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const ShortArgs& a, cudaStream_t stream) {
  if (kConsumers == 2 && a.S > kQT) {
    const int err = launch<D, 2>(a, stream);
    if (err != kNoPlan) return err;
  }
  return launch<D, 1>(a, stream);
}

std::atomic<int> tc_calls{0};  // calls that launched the kernel, counted where the launch succeeded

}  // namespace

int launch_short_tc(int D, const ShortArgs& a, cudaStream_t stream) {
  int err = (int)cudaErrorInvalidValue;
  if (D == 32) err = launch_d<32>(a, stream);
  if (D == 64) err = launch_d<64>(a, stream);
  if (D == 128) err = launch_d<128>(a, stream);
  if (err == 0) tc_calls.fetch_add(1, std::memory_order_relaxed);
  return err;
}

}  // namespace llmq

extern "C" int llmq_fused_mha_tc_launches() { return llmq::tc_calls.load(std::memory_order_relaxed); }
