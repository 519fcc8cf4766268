// Blockwise online-softmax attention for bf16 inputs on Hopper's tensor cores:
// the forward and the two recompute-backward kernels of attention.cu,
// rewritten around wgmma (sm_90a). attention.cu's C entry points send every
// bf16 call here and keep their SIMT kernels for fp32.
//
// Replaces the same TPU kernels as attention.cu:
//   llm_quest_tpu/kernels/flash_attention.py::flash_attention (_fwd_kernel,
//     _bwd_dq_kernel, _bwd_dkv_kernel) and, through the same forward,
//     flash_attention_with_lse;
//   and, for the backward only, the recompute VJPs of
//   llm_quest_tpu/kernels/fused_mha.py::fused_mha and ::packed_mha (XLA's in
//   JAX): their short-sequence forward is fused_mha_tc.cu, their gradients
//   these kernels, written by the caller's strides.
// Semantics are attention.cu's, on the accumulator registers: causal rule
// with q_start, (b, sk) key mask, GQA by head division, sliding window,
// softcap cap * tanh(s / cap) in fp32 before the mask, per-head sinks added
// to the row sum after the last tile, masked scores at finfo(float32).min / 2
// (a row with no visible key averages the keys it visited), keys past sk
// zero-filled and at -inf. (d, dv) pairs: (64, 64), (128, 128), (256, 256),
// (64, 32) and (96, 64), and (32, 32) in the backward (K6 and K7 only).
//
// Bound: the products. In bf16 the score and value products run on the
// tensor cores (989 TFLOP/s dense) instead of the fp32 SIMT units (67
// TFLOP/s), so a long causal call is bound by operations, not bytes.
//
// Design.
// - Products: wgmma.mma_async m64nNk16, bf16 operands, fp32 accumulators.
//   Operands in shared memory are addressed by matrix descriptors; the
//   softmax probabilities P (forward) and P^T, dS^T, dS (backward) are
//   rounded to bf16 in registers and fed as wgmma's A operand from
//   registers, so they never touch shared memory. Wide products are issued
//   as N = 64 (or 32) column chunks: an N chunk is one swizzle block.
//   Issue is synchronous: fence, issue, commit, wait for 0.
// - Layout: the swizzled tiles of tma_wgmma.cuh, which also holds the
//   primitives (mbarriers, TMA, wgmma, the tensor-map encoder). One tile serves as a
//   K-major operand (Q and K in S = Q K^T) and as an MN-major one with the
//   transpose flag (V in P V, K in dQ = dS K, Q and dO in dK and dV), so V
//   keeps its natural (key, dv) rows.
// - Copies: TMA (cp.async.bulk.tensor), issued by one thread, completing on
//   an mbarrier a ring stage, each box one swizzle block of a tile. Every
//   operand is a 4-d tensor map (columns, seq, head, batch) built per call
//   from its (batch, head, seq) strides, so the packed (b, s, h*d) layout
//   and transposed views need no copy; rows past the end arrive as zeros.
//   The encoder is libcuda's cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint (no -lcuda). Key (or query) tiles pass through a
//   ring of two stages: the next tile is in flight while the current one is
//   multiplied (one stage in the d-256 forward, so that two blocks share an
//   SM and one loads while the other multiplies). A first version copied
//   with cp.async from every thread; issuing those copies stalled the
//   threads that multiply.
// - Forward: a block owns 128 query rows of one (batch, q head) in two
//   warpgroups of 64 (64 rows in one warpgroup at d 256, whose 64 x 256 fp32
//   output accumulator is 128 registers a thread) and walks 64-key tiles
//   from the window's first tile to the causal end, as attention.cu does.
//   The row max and sum reduce across the 4 threads that share a row of the
//   accumulator fragment, by shuffles. Heavy (late) causal blocks start first.
// - Backward: two kernels, no atomics, so the gradients are deterministic.
//   dq: a block owns 128 (64 at d 256) query rows and walks the visible key
//   tiles: S = Q K^T, dP = dO V^T, dS = P o (dP - delta), dQ += dS K.
//   dk/dv: a block owns 64 keys per warpgroup (two warpgroups, K and V
//   resident) and walks every q head of the GQA group and every visible
//   64-row query tile, with the tile's lse and delta beside it in the ring:
//   S^T = K Q^T, P^T = exp(S^T - lse), dP^T = V dO^T, dS^T = P^T o (dP^T -
//   delta), dV += P^T dO, dK += dS^T Q. At d 256 the dK and dV accumulators
//   (256 fp32 registers a thread together) do not fit, so both warpgroups
//   own the same 64 keys: one forms S^T, the other dP^T, both pass through
//   shared memory, and each warpgroup accumulates half the columns of dK
//   and dV.
// - Every element loop is free of branches (selects only): a branch in an
//   unrolled loop over a thread's 32 scores serialises them.
#include <atomic>

#include "attention.cuh"
#include "tma_wgmma.cuh"

namespace llmq {
namespace {

constexpr int kBK = 64;  // keys (forward, dq) or query rows (dk/dv) per streamed tile

// first key of the kBK-aligned tile the query at absolute position qpos0 needs
__device__ __forceinline__ int window_begin(int qpos0, int window) {
  return window > 0 ? (max(0, qpos0 - window + 1) / kBK) * kBK : 0;
}

// The element loops hold no branch: every choice is a select, and the
// uniform ones (softcap, key mask, a tile that needs no mask) sit outside.

// scores scaled and soft-capped (cap * tanh(s / cap)), natural-log units
__device__ __forceinline__ void scale_scores(float (&s)[32], float scale, float softcap) {
  if (softcap > 0.f) {
    const float k = scale / softcap;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = softcap * tanhf(s[i] * k);
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale;
  }
}

// the 16 keys k0 + 8j + 2t + e (bit 2j + e) of a fragment row that are real:
// inside sk and, with a key mask, nonzero there
__device__ __forceinline__ uint32_t real_keys(int k0, int t, int SK, const uint8_t* mb) {
  uint32_t bits = 0;
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const int kpos = k0 + 8 * (b / 2) + 2 * t + (b & 1);
    bits |= static_cast<uint32_t>(kpos < SK && (mb == nullptr || mb[kpos] != 0)) << b;
  }
  return bits;
}

// query rows along M (qpos0: this thread's first row's absolute position,
// the second 8 below), keys along N from k0: causal, window and the real
// keys; a key past sk scores -inf, another masked score `masked`
__device__ __forceinline__ void mask_rows(float (&s)[32], float masked, int k0, int qpos0, int t, int SK, int causal,
                                          int window, uint32_t real) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int kpos = k0 + 8 * (i / 4) + 2 * t + (i & 1);
    const int qpos = qpos0 + 8 * ((i / 2) & 1);
    const bool hidden = (causal && kpos > qpos) || (window > 0 && kpos <= qpos - window) ||
                        !((real >> (2 * (i / 4) + (i & 1))) & 1u);
    s[i] = kpos >= SK ? -INFINITY : (hidden ? masked : s[i]);
  }
}

// shared memory of a kernel: its tiles, 1024-byte aligned, plus the slack
// that aligning the dynamic base takes, and kBars mbarriers at the end
constexpr int kBars = 4;
constexpr size_t kSlack = kAlignSlack + 8 * kBars;


// ------------------------------------------------------------------ forward

// the warpgroups of a forward or dq block, 64 query rows each: one at d 256
// (the output or dq accumulator is then 128 fp32 registers a thread)
template <int D>
__host__ __device__ constexpr int fwd_wgs() {
  return D > 128 ? 1 : 2;
}

// K/V ring stages of the forward: two, or one at d 256, where two stages'
// 160 KB of tiles would hold one block an SM and one stage's 96 KB holds two
template <int D>
__host__ __device__ constexpr int fwd_stages() {
  return D > 128 ? 1 : 2;
}

template <int D, int DV>
constexpr size_t fwd_smem_bytes() {
  return Tile<64 * fwd_wgs<D>(), D>::BYTES + fwd_stages<D>() * (Tile<kBK, D>::BYTES + Tile<kBK, DV>::BYTES) + kSlack;
}

// grid (ceil(sq / BQ), b*hq), block 128 * NWG threads, dynamic smem fwd_smem_bytes<D, DV>()
template <int D, int DV>
__global__ void __launch_bounds__(kWG * fwd_wgs<D>())
    attention_tc_fwd_kernel(const FwdArgs a, const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv) {
  constexpr int NWG = fwd_wgs<D>();
  constexpr int BQ = 64 * NWG;
  using QT = Tile<BQ, D>;
  using KT = Tile<kBK, D>;
  using VT = Tile<kBK, DV>;
  constexpr int NB = DV / VT::BW;  // output column blocks
  constexpr int BW = VT::BW;
  constexpr int STAGES = fwd_stages<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = smem_base(smem_raw);
  const uint32_t k_s = q_s + QT::BYTES;            // STAGES stages
  const uint32_t v_s = k_s + STAGES * KT::BYTES;   // STAGES stages
  const uint32_t bars = v_s + STAGES * VT::BYTES;  // Q, then one a K/V stage

  const int bh = blockIdx.y;
  const int bi = bh / a.HQ, hq = bh % a.HQ;
  const int hk = hq / (a.HQ / a.HKV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest causal walks start first
  const int tid = threadIdx.x;
  const int wg = tid / kWG, warp = (tid % kWG) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * warp + g;  // rows row0 and row0 + 8 of this thread

  const uint8_t* mb = a.key_mask != nullptr ? a.key_mask + bi * a.mask_sb : nullptr;

  const int q_last = min(q0 + BQ, a.SQ) - 1;
  const int k_end = a.causal ? min(a.SK, a.q_start + q_last + 1) : a.SK;
  const int k_begin = window_begin(a.q_start + q0, a.window);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  init_bars(bars, kBars, tid);
  if (tid == 0) {
    mbar_expect(bars, QT::BYTES);
    QT::tma(q_s, tq, bars, q0, hq, bi);
    if (n_tiles > 0) {
      mbar_expect(bars + 8, KT::BYTES + VT::BYTES);
      KT::tma(k_s, tk, bars + 8, k_begin, hk, bi);
      VT::tma(v_s, tv, bars + 8, k_begin, hk, bi);
    }
  }
  mbar_wait(bars, 0);

  float o[NB][BW / 2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < BW / 2; ++i) o[nb][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's share of the row sum

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kBK;
    const int stage = STAGES == 2 ? it & 1 : 0;
    mbar_wait(bars + 8 * (1 + stage), STAGES == 2 ? (it >> 1) & 1 : it & 1);
    __syncthreads();  // this tile has landed, and every warpgroup is done with the stage refilled next
    if (STAGES == 2 && tid == 0 && it + 1 < n_tiles) {  // in flight while this tile is multiplied
      const uint32_t bar = bars + 8 * (2 - stage);
      mbar_expect(bar, KT::BYTES + VT::BYTES);
      KT::tma(k_s + (stage ^ 1) * KT::BYTES, tk, bar, k0 + kBK, hk, bi);
      VT::tma(v_s + (stage ^ 1) * VT::BYTES, tv, bar, k0 + kBK, hk, bi);
    }
    const uint32_t ks = k_s + stage * KT::BYTES, vs = v_s + stage * VT::BYTES;

    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      mma_ss(s, QT::kmajor(q_s, 64 * wg, kk), KT::kmajor(ks, 0, kk), kk > 0);
    }
    wg_commit();
    wg_wait();
    fence_regs(s);

    // a tile that every row of the block sees whole needs no mask
    const bool full = k0 + kBK <= a.SK && mb == nullptr && (!a.causal || k0 + kBK - 1 <= a.q_start + q0) &&
                      (a.window == 0 || k0 > a.q_start + q0 + BQ - 1 - a.window);
    scale_scores(s, a.scale, a.softcap);
    if (!full) {
      mask_rows(s, kMasked, k0, a.q_start + row0, t, a.SK, a.causal, a.window, real_keys(k0, t, a.SK, mb));
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] *= kLog2e;  // base-2 exponent from here on
      mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s[i]);
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      corr[h] = exp2f(m[h] - m_new);  // 0 on the first tile (m = -inf)
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(s[i] - m[(i / 2) & 1]);
      l[(i / 2) & 1] += s[i];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < BW / 2; ++i) o[nb][i] *= corr[(i / 2) & 1];
    uint32_t p[4][4];
    to_a_frags(s, p);

#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma_rs<BW>(o[nb], p[kk], VT::mnmajor(vs, kk, nb));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);
    if (STAGES == 1) {  // the one stage is free: the next tile, while another block on this SM multiplies
      __syncthreads();
      if (tid == 0 && it + 1 < n_tiles) {
        mbar_expect(bars + 8, KT::BYTES + VT::BYTES);
        KT::tma(k_s, tk, bars + 8, k0 + kBK, hk, bi);
        VT::tma(v_s, tv, bars + 8, k0 + kBK, hk, bi);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    float mh = m[h] / kLog2e;  // natural-log units
    float corr = 1.f;
    if (a.sink != nullptr) {  // one more logit in the normalizer, with no value
      const float sk = a.sink[hq];
      const float m_new = fmaxf(mh, sk);
      corr = expf(mh - m_new);
      l[h] = l[h] * corr + expf(sk - m_new);
      mh = m_new;
    }
    const int row = row0 + 8 * h;
    const float inv = l[h] > 0.f ? corr / l[h] : 0.f;  // l = 0 only for a row with no key tile at all
    if (row < a.SQ) {
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(a.o) + bi * a.o_sb + hq * a.o_sh + row * a.o_ss;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < BW / 8; ++j) {
          const int col = nb * BW + 8 * j + 2 * t;
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[nb][4 * j + 2 * h] * inv, o[nb][4 * j + 2 * h + 1] * inv);
        }
      if (a.lse != nullptr && t == 0) a.lse[(long long)bh * a.SQ + row] = mh + logf(l[h]);
    }
  }
}

// ------------------------------------------------------------------ backward

template <int D, int DV>
constexpr size_t dq_smem_bytes() {
  constexpr int BQ = 64 * fwd_wgs<D>();
  return Tile<BQ, D>::BYTES + Tile<BQ, DV>::BYTES + 2 * Tile<kBK, D>::BYTES + 2 * Tile<kBK, DV>::BYTES + kSlack;
}

// grid (ceil(sq / BQ), b*hq), block 128 * NWG threads, dynamic smem dq_smem_bytes<D, DV>()
template <int D, int DV>
__global__ void __launch_bounds__(kWG * fwd_wgs<D>())
    attention_tc_dq_kernel(const BwdArgs a, const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo, const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv) {
  constexpr int NWG = fwd_wgs<D>();
  constexpr int BQ = 64 * NWG;
  using QT = Tile<BQ, D>;
  using OT = Tile<BQ, DV>;
  using KT = Tile<kBK, D>;
  using VT = Tile<kBK, DV>;
  constexpr int BW = KT::BW;
  constexpr int NB = D / BW;  // dq column blocks
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = smem_base(smem_raw);
  const uint32_t do_s = q_s + QT::BYTES;
  const uint32_t k_s = do_s + OT::BYTES;      // 2 stages
  const uint32_t v_s = k_s + 2 * KT::BYTES;   // 2 stages
  const uint32_t bars = v_s + 2 * VT::BYTES;  // Q and dO, then one a K/V stage

  const int bh = blockIdx.y;
  const int bi = bh / a.HQ, hq = bh % a.HQ;
  const int hk = hq / (a.HQ / a.HKV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int tid = threadIdx.x;
  const int wg = tid / kWG, warp = (tid % kWG) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * wg + 16 * warp + g;

  const uint8_t* mb = a.key_mask != nullptr ? a.key_mask + bi * a.mask_sb : nullptr;

  float lse2[2], dl[2];  // the rows' lse (base 2) and delta - shift
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const long long stat = (long long)bh * a.SQ + row;
    const bool ok = row < a.SQ;
    lse2[h] = ok ? a.lse[stat] * kLog2e : 0.f;
    dl[h] = ok ? a.delta[stat] - (a.delta_shift != nullptr ? a.delta_shift[stat] : 0.f) : 0.f;
  }

  const int q_last = min(q0 + BQ, a.SQ) - 1;
  const int k_end = a.causal ? min(a.SK, a.q_start + q_last + 1) : a.SK;
  const int k_begin = window_begin(a.q_start + q0, a.window);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  init_bars(bars, kBars, tid);
  if (tid == 0) {
    mbar_expect(bars, QT::BYTES + OT::BYTES);
    QT::tma(q_s, tq, bars, q0, hq, bi);
    OT::tma(do_s, tdo, bars, q0, hq, bi);
    if (n_tiles > 0) {
      mbar_expect(bars + 8, KT::BYTES + VT::BYTES);
      KT::tma(k_s, tk, bars + 8, k_begin, hk, bi);
      VT::tma(v_s, tv, bars + 8, k_begin, hk, bi);
    }
  }
  mbar_wait(bars, 0);

  float dq[NB][BW / 2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < BW / 2; ++i) dq[nb][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kBK;
    const int stage = it & 1;
    mbar_wait(bars + 8 * (1 + stage), (it >> 1) & 1);
    __syncthreads();  // this tile has landed, and every warpgroup is done with the stage refilled next
    if (tid == 0 && it + 1 < n_tiles) {  // in flight while this tile is multiplied
      const uint32_t bar = bars + 8 * (2 - stage);
      mbar_expect(bar, KT::BYTES + VT::BYTES);
      KT::tma(k_s + (stage ^ 1) * KT::BYTES, tk, bar, k0 + kBK, hk, bi);
      VT::tma(v_s + (stage ^ 1) * VT::BYTES, tv, bar, k0 + kBK, hk, bi);
    }
    const uint32_t ks = k_s + stage * KT::BYTES, vs = v_s + stage * VT::BYTES;

    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      mma_ss(s, QT::kmajor(q_s, 64 * wg, kk), KT::kmajor(ks, 0, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
      mma_ss(dp, OT::kmajor(do_s, 64 * wg, kk), VT::kmajor(vs, 0, kk), kk > 0);
    wg_commit();
    wg_wait();
    fence_regs(s);
    fence_regs(dp);

    const bool full = k0 + kBK <= a.SK && mb == nullptr && (!a.causal || k0 + kBK - 1 <= a.q_start + q0) &&
                      (a.window == 0 || k0 > a.q_start + q0 + BQ - 1 - a.window);
    scale_scores(s, a.scale, a.softcap);
    if (!full) {  // a hidden score has p = 0 and ds = 0
      mask_rows(s, -INFINITY, k0, a.q_start + row0, t, a.SK, a.causal, a.window, real_keys(k0, t, a.SK, mb));
    }
    if (a.softcap > 0.f) {  // ds carries the softcap's chain factor 1 - tanh^2
      const float inv_cap = 1.f / a.softcap;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = exp2f(s[i] * kLog2e - lse2[(i / 2) & 1]);
        const float th = p > 0.f ? s[i] * inv_cap : 0.f;
        s[i] = p * (dp[i] - dl[(i / 2) & 1]) * (1.f - th * th);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = exp2f(s[i] * kLog2e - lse2[(i / 2) & 1]) * (dp[i] - dl[(i / 2) & 1]);
    }
    uint32_t ds[4][4];
    to_a_frags(s, ds);

#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(dq[nb]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) mma_rs<BW>(dq[nb], ds[kk], KT::mnmajor(ks, kk, nb));
    wg_commit();
    wg_wait();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(dq[nb]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= a.SQ) continue;
    __nv_bfloat16* dqrow = row_at<__nv_bfloat16>(a.dq, a.dq_sb, a.dq_sh, a.dq_ss, bi, hq, row);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < BW / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dqrow + nb * BW + 8 * j + 2 * t) =
            __floats2bfloat162_rn(dq[nb][4 * j + 2 * h] * a.scale, dq[nb][4 * j + 2 * h + 1] * a.scale);
  }
}

// dk/dv: two warpgroups a block. Up to d 128 each owns 64 keys; at d 256,
// where a warpgroup's dK and dV accumulators would take 256 fp32 registers a
// thread, both own the same 64 keys and split the columns of dK and dV
// (dkv_body_columns). On the card, at Gemma-3's layer (b 4, 4/1 heads,
// s 2048), this backward was faster than running the dV and dK passes as
// two blocks of one warpgroup each (S^T formed twice).
template <int D>
__host__ __device__ constexpr bool dkv_columns() {
  return D > 128;
}
template <int D>
__host__ __device__ constexpr int dkv_keys() {  // keys a block owns
  return dkv_columns<D>() ? 64 : 128;
}

template <int D, int DV>
constexpr size_t dkv_smem_bytes() {
  constexpr int BKV = dkv_keys<D>();
  constexpr size_t exchange = dkv_columns<D>() ? 2 * kBK * kBK * sizeof(float) : 0;
  return Tile<BKV, D>::BYTES + Tile<BKV, DV>::BYTES + 2 * Tile<kBK, D>::BYTES + 2 * Tile<kBK, DV>::BYTES +
         2 * 2 * kBK * sizeof(float) + exchange + kSlack;
}

// dk/dv's element step on S^T (keys along M, the query tile's rows along N):
// s becomes P^T = exp(S^T - lse) and dp becomes dS^T = P^T o (dP^T - delta)
// with the softcap's chain factor; a hidden score has p = 0 and ds = 0.
// `keys` from k0 are the block's; no_key_mask: a.key_mask is null.
__device__ __forceinline__ void dkv_scores(const BwdArgs& a, float (&s)[32], float (&dp)[32], int k0, int keys,
                                           int key0, const bool (&key_ok)[2], int qt, int t, bool no_key_mask,
                                           const float* lse_t, const float* dl_t) {
  // every key of the block real and seen by every row of the tile
  const bool full = k0 + keys <= a.SK && no_key_mask && (!a.causal || k0 + keys - 1 <= a.q_start + qt) &&
                    (a.window == 0 || k0 > a.q_start + qt + kBK - 1 - a.window);
  scale_scores(s, a.scale, a.softcap);
  if (!full) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) & 1;
      const int row = qt + 8 * (i / 4) + 2 * t + (i & 1);
      const int kpos = key0 + 8 * h, qpos = a.q_start + row;
      const bool hidden = !key_ok[h] || row >= a.SQ || (a.causal && kpos > qpos) ||
                          (a.window > 0 && kpos <= qpos - a.window);
      s[i] = hidden ? -INFINITY : s[i];
    }
  }
  const float inv_cap = a.softcap > 0.f ? 1.f / a.softcap : 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = 8 * (i / 4) + 2 * t + (i & 1);  // query row in the tile
    const float p = exp2f(s[i] * kLog2e - lse_t[c]);
    const float th = p > 0.f ? s[i] * inv_cap : 0.f;  // tanh of the capped score (0 without a cap)
    dp[i] = p * (dp[i] - dl_t[c]) * (1.f - th * th);
    s[i] = p;
  }
}

template <int D, int DV>
__device__ __forceinline__ void dkv_body(const BwdArgs& a, uint8_t* smem_raw, const CUtensorMap& tk,
                                         const CUtensorMap& tv, const CUtensorMap& tq, const CUtensorMap& tdo) {
  constexpr int NWG = 2;
  constexpr int BKV = 64 * NWG;
  using KT = Tile<BKV, D>;
  using VT = Tile<BKV, DV>;
  using QT = Tile<kBK, D>;
  using OT = Tile<kBK, DV>;
  constexpr int NBK = D / QT::BW, NBV = DV / OT::BW;
  const uint32_t base = smem_base(smem_raw);
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + KT::BYTES;
  const uint32_t q_s = v_s + VT::BYTES;        // 2 stages
  const uint32_t do_s = q_s + 2 * QT::BYTES;   // 2 stages
  const uint32_t st_off = do_s + 2 * OT::BYTES - smem_u32(smem_raw);
  float* lse_s = reinterpret_cast<float*>(smem_raw + st_off);  // 2 stages of kBK (base 2)
  float* dl_s = lse_s + 2 * kBK;                              // 2 stages of kBK
  const uint32_t bars = smem_u32(dl_s + 2 * kBK);             // K and V, then one a Q/dO stage

  const int bh = blockIdx.y;
  const int bi = bh / a.HKV, hk = bh % a.HKV;
  const int group = a.HQ / a.HKV;
  const int k0 = blockIdx.x * BKV;
  const int tid = threadIdx.x;
  const int wg = tid / kWG, warp = (tid % kWG) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int key0 = k0 + 64 * wg + 16 * warp + g;  // keys key0 and key0 + 8 of this thread

  const uint8_t* mb = a.key_mask != nullptr ? a.key_mask + bi * a.mask_sb : nullptr;
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kpos = key0 + 8 * h;
    key_ok[h] = kpos < a.SK && (mb == nullptr || mb[kpos] != 0);
  }
  // causal: query row i sees key k0 only from i = k0 - q_start on; window:
  // the block's last key leaves the window after row k0 + BKV - 1 + window - 1 - q_start
  const int i_min = a.causal ? max(0, k0 - a.q_start) : 0;
  const int i_end = a.window > 0 ? min(a.SQ, max(0, k0 + BKV - 1 + a.window - a.q_start)) : a.SQ;
  const int t0 = (i_min / kBK) * kBK;
  const int n_q = i_end > t0 ? (i_end - t0 + kBK - 1) / kBK : 0;
  const int total = group * n_q;

  // the query tile `it` of the walk (q head hk * group + it / n_q) into ring stage `stage`
  auto load_q_tile = [&](int it, int stage) {
    const int hq = hk * group + it / n_q, qt = t0 + (it % n_q) * kBK;
    if (tid == 0) {
      const uint32_t bar = bars + 8 * (1 + stage);
      mbar_expect(bar, QT::BYTES + OT::BYTES);
      QT::tma(q_s + stage * QT::BYTES, tq, bar, qt, hq, bi);
      OT::tma(do_s + stage * OT::BYTES, tdo, bar, qt, hq, bi);
    }
    const long long stat0 = ((long long)bi * a.HQ + hq) * a.SQ;
    for (int i = tid; i < kBK; i += kWG * NWG) {
      const int row = qt + i;
      const bool ok = row < a.SQ;
      lse_s[stage * kBK + i] = ok ? a.lse[stat0 + row] * kLog2e : 0.f;
      dl_s[stage * kBK + i] =
          ok ? a.delta[stat0 + row] - (a.delta_shift != nullptr ? a.delta_shift[stat0 + row] : 0.f) : 0.f;
    }
  };

  init_bars(bars, kBars, tid);
  if (tid == 0) {
    mbar_expect(bars, KT::BYTES + VT::BYTES);
    KT::tma(k_s, tk, bars, k0, hk, bi);
    VT::tma(v_s, tv, bars, k0, hk, bi);
  }
  if (total > 0) load_q_tile(0, 0);
  mbar_wait(bars, 0);

  float dk[NBK][QT::BW / 2], dv[NBV][OT::BW / 2];
#pragma unroll
  for (int nb = 0; nb < NBK; ++nb)
#pragma unroll
    for (int i = 0; i < QT::BW / 2; ++i) dk[nb][i] = 0.f;
#pragma unroll
  for (int nb = 0; nb < NBV; ++nb)
#pragma unroll
    for (int i = 0; i < OT::BW / 2; ++i) dv[nb][i] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int stage = it & 1;
    const int qt = t0 + (it % n_q) * kBK;
    mbar_wait(bars + 8 * (1 + stage), (it >> 1) & 1);
    __syncthreads();  // this tile has landed, and every warpgroup is done with the stage refilled next
    if (it + 1 < total) load_q_tile(it + 1, stage ^ 1);  // in flight while this tile is multiplied
    const uint32_t qs = q_s + stage * QT::BYTES, dos = do_s + stage * OT::BYTES;
    const float* lse_t = lse_s + stage * kBK;
    const float* dl_t = dl_s + stage * kBK;

    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      mma_ss(s, KT::kmajor(k_s, 64 * wg, kk), QT::kmajor(qs, 0, kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk) {
      mma_ss(dp, VT::kmajor(v_s, 64 * wg, kk), OT::kmajor(dos, 0, kk), kk > 0);
    }
    wg_commit();
    wg_wait();
    fence_regs(s);
    fence_regs(dp);

    dkv_scores(a, s, dp, k0, BKV, key0, key_ok, qt, t, mb == nullptr, lse_t, dl_t);
    uint32_t pf[4][4], df[4][4];
    to_a_frags(s, pf);
    to_a_frags(dp, df);
#pragma unroll
    for (int nb = 0; nb < NBV; ++nb) fence_regs(dv[nb]);
#pragma unroll
    for (int nb = 0; nb < NBK; ++nb) fence_regs(dk[nb]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int nb = 0; nb < NBV; ++nb) mma_rs<OT::BW>(dv[nb], pf[kk], OT::mnmajor(dos, kk, nb));
#pragma unroll
      for (int nb = 0; nb < NBK; ++nb) mma_rs<QT::BW>(dk[nb], df[kk], QT::mnmajor(qs, kk, nb));
    }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int nb = 0; nb < NBV; ++nb) fence_regs(dv[nb]);
#pragma unroll
    for (int nb = 0; nb < NBK; ++nb) fence_regs(dk[nb]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kpos = key0 + 8 * h;
    if (kpos >= a.SK) continue;
    {
      __nv_bfloat16* dkrow = row_at<__nv_bfloat16>(a.dk, a.dk_sb, a.dk_sh, a.dk_ss, bi, hk, kpos);
#pragma unroll
      for (int nb = 0; nb < NBK; ++nb)
#pragma unroll
        for (int j = 0; j < QT::BW / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dkrow + nb * QT::BW + 8 * j + 2 * t) =
              __floats2bfloat162_rn(dk[nb][4 * j + 2 * h] * a.scale, dk[nb][4 * j + 2 * h + 1] * a.scale);
    }
    {
      __nv_bfloat16* dvrow = row_at<__nv_bfloat16>(a.dv, a.dv_sb, a.dv_sh, a.dv_ss, bi, hk, kpos);
#pragma unroll
      for (int nb = 0; nb < NBV; ++nb)
#pragma unroll
        for (int j = 0; j < OT::BW / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dvrow + nb * OT::BW + 8 * j + 2 * t) =
              __floats2bfloat162_rn(dv[nb][4 * j + 2 * h], dv[nb][4 * j + 2 * h + 1]);
    }
  }
}

// d 256, the columns scheme: both warpgroups own the same 64 keys; warpgroup 0
// forms S^T = K Q^T, warpgroup 1 dP^T = V dO^T, both land in shared memory,
// and each warpgroup then forms P^T and dS^T for the whole tile and
// accumulates its half of the columns of dV and dK.
template <int D, int DV>
__device__ __forceinline__ void dkv_body_columns(const BwdArgs& a, uint8_t* smem_raw, const CUtensorMap& tk,
                                                 const CUtensorMap& tv, const CUtensorMap& tq,
                                                 const CUtensorMap& tdo) {
  using KT = Tile<kBK, D>;
  using VT = Tile<kBK, DV>;
  using QT = Tile<kBK, D>;
  using OT = Tile<kBK, DV>;
  constexpr int NBK = D / QT::BW / 2, NBV = DV / OT::BW / 2;  // column blocks per warpgroup
  constexpr int NT = 2 * kWG;
  const uint32_t base = smem_base(smem_raw);
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + KT::BYTES;
  const uint32_t q_s = v_s + VT::BYTES;        // 2 stages
  const uint32_t do_s = q_s + 2 * QT::BYTES;   // 2 stages
  float* lse_s = reinterpret_cast<float*>(smem_raw + (do_s + 2 * OT::BYTES - smem_u32(smem_raw)));
  float* dl_s = lse_s + 2 * kBK;
  float* x_s = dl_s + 2 * kBK;  // S^T, then dP^T: 32 fragment registers x 128 threads each
  const uint32_t bars = smem_u32(x_s + 2 * 32 * kWG);  // K and V, then one a Q/dO stage

  const int bh = blockIdx.y;
  const int bi = bh / a.HKV, hk = bh % a.HKV;
  const int group = a.HQ / a.HKV;
  const int k0 = blockIdx.x * kBK;
  const int tid = threadIdx.x;
  const int wg = tid / kWG, wt = tid % kWG, warp = wt / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int key0 = k0 + 16 * warp + g;

  const uint8_t* mb = a.key_mask != nullptr ? a.key_mask + bi * a.mask_sb : nullptr;
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kpos = key0 + 8 * h;
    key_ok[h] = kpos < a.SK && (mb == nullptr || mb[kpos] != 0);
  }
  const int i_min = a.causal ? max(0, k0 - a.q_start) : 0;
  const int i_end = a.window > 0 ? min(a.SQ, max(0, k0 + kBK - 1 + a.window - a.q_start)) : a.SQ;
  const int t0 = (i_min / kBK) * kBK;
  const int n_q = i_end > t0 ? (i_end - t0 + kBK - 1) / kBK : 0;
  const int total = group * n_q;

  auto load_q_tile = [&](int it, int stage) {
    const int hq = hk * group + it / n_q, qt = t0 + (it % n_q) * kBK;
    if (tid == 0) {
      const uint32_t bar = bars + 8 * (1 + stage);
      mbar_expect(bar, QT::BYTES + OT::BYTES);
      QT::tma(q_s + stage * QT::BYTES, tq, bar, qt, hq, bi);
      OT::tma(do_s + stage * OT::BYTES, tdo, bar, qt, hq, bi);
    }
    const long long stat0 = ((long long)bi * a.HQ + hq) * a.SQ;
    for (int i = tid; i < kBK; i += NT) {
      const int row = qt + i;
      const bool ok = row < a.SQ;
      lse_s[stage * kBK + i] = ok ? a.lse[stat0 + row] * kLog2e : 0.f;
      dl_s[stage * kBK + i] =
          ok ? a.delta[stat0 + row] - (a.delta_shift != nullptr ? a.delta_shift[stat0 + row] : 0.f) : 0.f;
    }
  };

  init_bars(bars, kBars, tid);
  if (tid == 0) {
    mbar_expect(bars, KT::BYTES + VT::BYTES);
    KT::tma(k_s, tk, bars, k0, hk, bi);
    VT::tma(v_s, tv, bars, k0, hk, bi);
  }
  if (total > 0) load_q_tile(0, 0);
  mbar_wait(bars, 0);

  float dk[NBK][QT::BW / 2], dv[NBV][OT::BW / 2];
#pragma unroll
  for (int nb = 0; nb < NBK; ++nb)
#pragma unroll
    for (int i = 0; i < QT::BW / 2; ++i) dk[nb][i] = 0.f;
#pragma unroll
  for (int nb = 0; nb < NBV; ++nb)
#pragma unroll
    for (int i = 0; i < OT::BW / 2; ++i) dv[nb][i] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int stage = it & 1;
    const int qt = t0 + (it % n_q) * kBK;
    mbar_wait(bars + 8 * (1 + stage), (it >> 1) & 1);
    __syncthreads();  // this tile has landed, and every warpgroup is done with the stage refilled next
    if (it + 1 < total) load_q_tile(it + 1, stage ^ 1);
    const uint32_t qs = q_s + stage * QT::BYTES, dos = do_s + stage * OT::BYTES;
    const float* lse_t = lse_s + stage * kBK;
    const float* dl_t = dl_s + stage * kBK;

    float x[32];
    wg_fence();
    if (wg == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) mma_ss(x, KT::kmajor(k_s, 0, kk), QT::kmajor(qs, 0, kk), kk > 0);
    } else {
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) mma_ss(x, VT::kmajor(v_s, 0, kk), OT::kmajor(dos, 0, kk), kk > 0);
    }
    wg_commit();
    wg_wait();
    fence_regs(x);
#pragma unroll
    for (int i = 0; i < 32; ++i) x_s[(wg * 32 + i) * kWG + wt] = x[i];
    __syncthreads();  // both products are in place
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = x_s[i * kWG + wt];
      dp[i] = x_s[(32 + i) * kWG + wt];
    }

    dkv_scores(a, s, dp, k0, kBK, key0, key_ok, qt, t, mb == nullptr, lse_t, dl_t);
    uint32_t pf[4][4], df[4][4];
    to_a_frags(s, pf);
    to_a_frags(dp, df);
#pragma unroll
    for (int nb = 0; nb < NBV; ++nb) fence_regs(dv[nb]);
#pragma unroll
    for (int nb = 0; nb < NBK; ++nb) fence_regs(dk[nb]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int nb = 0; nb < NBV; ++nb) mma_rs<OT::BW>(dv[nb], pf[kk], OT::mnmajor(dos, kk, wg * NBV + nb));
#pragma unroll
      for (int nb = 0; nb < NBK; ++nb) mma_rs<QT::BW>(dk[nb], df[kk], QT::mnmajor(qs, kk, wg * NBK + nb));
    }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int nb = 0; nb < NBV; ++nb) fence_regs(dv[nb]);
#pragma unroll
    for (int nb = 0; nb < NBK; ++nb) fence_regs(dk[nb]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kpos = key0 + 8 * h;
    if (kpos >= a.SK) continue;
    __nv_bfloat16* dkrow = row_at<__nv_bfloat16>(a.dk, a.dk_sb, a.dk_sh, a.dk_ss, bi, hk, kpos) + wg * NBK * QT::BW;
    __nv_bfloat16* dvrow = row_at<__nv_bfloat16>(a.dv, a.dv_sb, a.dv_sh, a.dv_ss, bi, hk, kpos) + wg * NBV * OT::BW;
#pragma unroll
    for (int nb = 0; nb < NBK; ++nb)
#pragma unroll
      for (int j = 0; j < QT::BW / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dkrow + nb * QT::BW + 8 * j + 2 * t) =
            __floats2bfloat162_rn(dk[nb][4 * j + 2 * h] * a.scale, dk[nb][4 * j + 2 * h + 1] * a.scale);
#pragma unroll
    for (int nb = 0; nb < NBV; ++nb)
#pragma unroll
      for (int j = 0; j < OT::BW / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dvrow + nb * OT::BW + 8 * j + 2 * t) =
            __floats2bfloat162_rn(dv[nb][4 * j + 2 * h], dv[nb][4 * j + 2 * h + 1]);
  }
}

// grid (ceil(sk / dkv_keys), b*hkv), block 256 threads, dynamic smem dkv_smem_bytes<D, DV>()
template <int D, int DV>
__global__ void __launch_bounds__(2 * kWG)
    attention_tc_dkv_kernel(const BwdArgs a, const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tdo) {
  extern __shared__ uint8_t smem_raw[];
  if constexpr (dkv_columns<D>()) {
    dkv_body_columns<D, DV>(a, smem_raw, tk, tv, tq, tdo);
  } else {
    dkv_body<D, DV>(a, smem_raw, tk, tv, tq, tdo);
  }
}

// ------------------------------------------------------------------ launches

template <int D, int DV>
int launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<D, DV>();
  constexpr int BQ = 64 * fwd_wgs<D>();
  CUtensorMap tq, tk, tv;
  if (!make_map<D>(&tq, a.q, a.B, a.HQ, a.SQ, a.q_sb, a.q_sh, a.q_ss, BQ) ||
      !make_map<D>(&tk, a.k, a.B, a.HKV, a.SK, a.k_sb, a.k_sh, a.k_ss, kBK) ||
      !make_map<DV>(&tv, a.v, a.B, a.HKV, a.SK, a.v_sb, a.v_sh, a.v_ss, kBK)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = attention_tc_fwd_kernel<D, DV>;
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<dim3((a.SQ + BQ - 1) / BQ, a.B * a.HQ), kWG * fwd_wgs<D>(), smem, stream>>>(a, tq, tk, tv);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t dq_smem = dq_smem_bytes<D, DV>();
  constexpr size_t kv_smem = dkv_smem_bytes<D, DV>();
  constexpr int BQ = 64 * fwd_wgs<D>(), BKV = dkv_keys<D>();
  // the dq kernel's Q and dO boxes are its BQ rows, the dk/dv kernel's K and V boxes its BKV keys
  CUtensorMap dq_q, dq_do, dq_k, dq_v, kv_k, kv_v, kv_q, kv_do;
  if (!make_map<D>(&dq_q, a.q, a.B, a.HQ, a.SQ, a.q_sb, a.q_sh, a.q_ss, BQ) ||
      !make_map<DV>(&dq_do, a.dout, a.B, a.HQ, a.SQ, a.do_sb, a.do_sh, a.do_ss, BQ) ||
      !make_map<D>(&dq_k, a.k, a.B, a.HKV, a.SK, a.k_sb, a.k_sh, a.k_ss, kBK) ||
      !make_map<DV>(&dq_v, a.v, a.B, a.HKV, a.SK, a.v_sb, a.v_sh, a.v_ss, kBK) ||
      !make_map<D>(&kv_k, a.k, a.B, a.HKV, a.SK, a.k_sb, a.k_sh, a.k_ss, BKV) ||
      !make_map<DV>(&kv_v, a.v, a.B, a.HKV, a.SK, a.v_sb, a.v_sh, a.v_ss, BKV) ||
      !make_map<D>(&kv_q, a.q, a.B, a.HQ, a.SQ, a.q_sb, a.q_sh, a.q_ss, kBK) ||
      !make_map<DV>(&kv_do, a.dout, a.B, a.HQ, a.SQ, a.do_sb, a.do_sh, a.do_ss, kBK)) {
    return (int)cudaErrorInvalidValue;
  }
  auto dq_kernel = attention_tc_dq_kernel<D, DV>;
  auto dkv_kernel = attention_tc_dkv_kernel<D, DV>;
  if (int err = set_smem(dq_kernel, dq_smem)) return err;
  if (int err = set_smem(dkv_kernel, kv_smem)) return err;
  dq_kernel<<<dim3((a.SQ + BQ - 1) / BQ, a.B * a.HQ), kWG * fwd_wgs<D>(), dq_smem, stream>>>(a, dq_q, dq_do, dq_k,
                                                                                           dq_v);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  dkv_kernel<<<dim3((a.SK + BKV - 1) / BKV, a.B * a.HKV), 2 * kWG, kv_smem, stream>>>(a, kv_k, kv_v, kv_q, kv_do);
  return (int)cudaGetLastError();
}

int dispatch_fwd(int D, int DV, const FwdArgs& a, cudaStream_t stream) {
  if (D == 64 && DV == 64) return launch_fwd<64, 64>(a, stream);
  if (D == 128 && DV == 128) return launch_fwd<128, 128>(a, stream);
  if (D == 256 && DV == 256) return launch_fwd<256, 256>(a, stream);
  if (D == 64 && DV == 32) return launch_fwd<64, 32>(a, stream);
  if (D == 96 && DV == 64) return launch_fwd<96, 64>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// (32, 32) is the short-sequence kernels' (K6 and K7 at d 32), backward only
int dispatch_bwd(int D, int DV, const BwdArgs& a, cudaStream_t stream) {
  if (D == 32 && DV == 32) return launch_bwd<32, 32>(a, stream);
  if (D == 64 && DV == 64) return launch_bwd<64, 64>(a, stream);
  if (D == 128 && DV == 128) return launch_bwd<128, 128>(a, stream);
  if (D == 256 && DV == 256) return launch_bwd<256, 256>(a, stream);
  if (D == 64 && DV == 32) return launch_bwd<64, 32>(a, stream);
  if (D == 96 && DV == 64) return launch_bwd<96, 64>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// calls that launched these kernels (a forward call one, a backward call
// with its dq and dk/dv kernels one), counted where the launch succeeded
std::atomic<int> tc_calls{0};

int counted(int err) {
  if (err == 0) tc_calls.fetch_add(1, std::memory_order_relaxed);
  return err;
}

}  // namespace

int launch_tc_fwd(int D, int DV, const FwdArgs& a, cudaStream_t stream) {
  return counted(dispatch_fwd(D, DV, a, stream));
}

int launch_tc_bwd(int D, int DV, const BwdArgs& a, cudaStream_t stream) {
  return counted(dispatch_bwd(D, DV, a, stream));
}

}  // namespace llmq

extern "C" int llmq_attention_tc_launches() { return llmq::tc_calls.load(std::memory_order_relaxed); }
