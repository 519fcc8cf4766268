// Int8-score packed attention for bf16 inputs on Hopper's tensor cores
// (sm_90a): K8 and K9, one kernel body.
//
// Replaces, for bf16 inputs:
//   llm_quest_tpu/kernels/fused_mha.py::packed_mha_int8 (_packed_mha_int8_kernel,
//     pallas_call :313, with _quantize_sym :258 outside it) and
//   llm_quest_tpu/kernels/fused_mha.py::packed_mha_int8_inkernel
//     (_packed_mha_int8_ik_kernel, pallas_call :390):
// bidirectional maskless attention on the packed (b, s, h*d) projections,
// q and k quantized to int8 per tensor (dynamic: x / s with s = max|x| / 127
// + 1e-12; static: x * (1 / s); round half to even, clip to +-127), int32
// scores times dq = q_s * k_s * scale in fp32, the exact two-pass fp32
// softmax over the true row max, p cast to bf16 for p.V (fp32 sums) and the
// fp32 sum of p as the denominator. Head dims 32, 64 and 128, 1 <= s <= 1024.
//
// JAX quantizes K8's q and k outside its kernel: on the TPU the in-kernel
// VPU round and clip cost the whole int8 gain (fused_mha.py:221-226). Here
// every mode quantizes inside the kernel, as the tiles land, so int8 q and
// k never touch device memory: K8 reads the bytes K7 reads.
//
// Bound: the bytes. At ViT-B (b 128, 12 heads, s 197, d 64) q, k, v and o
// are 155 MB, 0.046 ms at 3.35 TB/s; the score products are 7.6 G int8 ops
// a pass (two passes: 0.008 ms at 1,979 TOP/s) and p.V 7.6 GFLOP of bf16
// (0.008 ms at 989 TFLOP/s). So each head's K and V are read once and the
// scores never leave the registers.
//
// Design.
// - A block owns one (batch, head), or a share of its 64-row query tiles
//   where b*h alone would not fill the card, as fused_mha_tc.cu. Thread 0
//   starts the head's bf16 V on its way by TMA (boxes of at most 256 rows,
//   rows past s as zeros), and each warpgroup's first bf16 Q tile, while
//   every thread of the block quantizes the head's K from device memory
//   into an int8 tile in shared memory, once (rows past s as zeros; four
//   16-byte loads in flight a thread): at ViT-B 13 KB of int8 K and 26.6 KB
//   of V. Two consumer warpgroups (kConsumers) take the block's query tiles
//   in turn; each quantizes its bf16 Q tile into an int8 tile of its own,
//   which frees the bf16 tile for the next one's copy, in flight while this
//   one multiplies. The int8 tiles are K-major in the swizzle that spans one
//   row (32, 64 or 128 bytes at d 32, 64, 128), the only form the s8 wgmma
//   reads. Where V does not fit beside two warpgroups' tiles (d 128 past
//   s 464) the block is one warpgroup, and where it does not fit beside one
//   (d 128 past s 528) V passes through a ring of two 128-key slots; the
//   int8 K (at most 128 KB) always stays.
// - Quantization: clip, then a sum with 1.5 * 2^23 rounds half to even and
//   leaves the int8 value in the low byte (quant_bits): the same integers as
//   JAX's clip(round(.)), on the full-rate float units (the conversion
//   instruction runs at a quarter of their rate). x * (1 / s) is a rounded
//   product, as JAX's; x / s is a product by fl(1 / s), which rounds to the
//   same integer as JAX's exact quotient except within 2^-14 of a
//   half-integer, where the exact quotient (__fdiv_rn) is taken (quotient).
// - Scores: wgmma m64nNk32 s32.s8.s8 from the two int8 tiles (Q K^T needs no
//   transpose: both have d contiguous), 64-key pieces, the last one as wide
//   as the keys left (n16, n32, n48), 128 keys a chunk in the accumulators.
//   The int32 sums are exact (|q.k| <= 127^2 * 128 < 2^24) and convert to
//   fp32 exactly.
// - Softmax: pass 1 keeps each row's largest int32 score over every chunk.
//   Since dq > 0 and rounding is monotone, fl(max * dq) is the max of the
//   scaled row: the true row max of the TPU kernel, with no rescale. Pass 2
//   recomputes each chunk, takes p = exp(fl(fl(s * dq) - m)) in fp32 (by
//   ex2.approx: 0.045 ms faster at ViT-B than expf, and well inside p's
//   bf16 rounding), sums the unrounded p and rounds p to bf16 in registers
//   as the A operand of m64nBWk16 products with V as the MN-major operand
//   (the transpose flag), fp32 accumulators; the s32 fragment has the fp32
//   one's layout, so the p-to-A mapping is fused_mha_tc.cu's. Both passes
//   run in one loop over 2 * chunks steps, one copy of the score products:
//   two inlined copies took 252 registers (one block an SM).
// - The output is divided by the fp32 sum (__fdiv_rn) and written as bf16
//   at the packed strides.
// - Issue is synchronous (fence, issue, commit, wait for 0).
#include <algorithm>
#include <atomic>
#include <climits>

#include "packed_mha_int8.cuh"
#include "tma_wgmma.cuh"

namespace llmq {
namespace {

constexpr int kQT = 64;      // query rows a tile (one warpgroup's m64)
constexpr int kPiece = 64;   // keys of one full score product (m64n64)
constexpr int kChunk = 128;  // keys whose scores a thread holds at once (64 registers)
// consumer warpgroups a block where V is resident and the head has more
// than one query tile: they share the block's int8 K and its V
constexpr int kConsumers = 2;

// The host's choices for a call, passed by value.
struct Int8Plan {
  int resident;  // 1: the head's V is loaded once; 0: a ring of 2 slots of kChunk keys
  int kr;        // rows of one V box (at most 256, a multiple of 16): resident s rounded up to 16 over
                 // the boxes, ring kChunk
  int boxes;     // resident: boxes V takes (its tile is boxes * kr rows)
  int groups;    // blocks that share one head's query tiles
  int k_bytes;   // the int8 K tile's bytes (s rounded up to 16 rows of d bytes), rounded up to 1024
};

// y = x * s rounded, or (kDiv) a float that rounds to the same integer as
// fl(x / s), given r = fl(1 / s): fl(x * r) is within 1.5 * 2^-23 of x / s,
// relative, so within 2.3e-5 of fl(x / s) where |x / s| <= 127.01 (dynamic
// scales: s >= max|x| / 127); the two round to one integer unless a
// half-integer lies within 2^-14 of fl(x * r), and there the exact quotient
// is taken (tests/test_torch_vit.py holds the rule to the exact quotient)
template <bool kDiv>
__device__ __forceinline__ float quotient(float x, float s, float r) {
  if (!kDiv) return __fmul_rn(x, s);
  const float y = __fmul_rn(x, r);
  const float n = __fsub_rn(__fadd_rn(y, 12582912.f), 12582912.f);  // y rounded to an integer
  return fabsf(__fsub_rn(fabsf(__fsub_rn(y, n)), 0.5f)) < 6.103515625e-05f ? __fdiv_rn(x, s) : y;
}

// JAX's clip(round(y), -127, 127) of y = x / s or x * (1 / s), as the bits
// of a float whose low byte is the int8 value: the clip first (the same at
// integer bounds), then the sum with 1.5 * 2^23 rounds to the integer, half
// to even, and leaves it in the low mantissa bits (two's complement in the
// low byte). Full-rate float operations where __float2int_rn is a
// quarter-rate conversion.
template <bool kDiv>
__device__ __forceinline__ uint32_t quant_bits(float x, float s, float r) {
  const float y = quotient<kDiv>(x, s, r);
  return __float_as_uint(__fadd_rn(fminf(fmaxf(y, -127.f), 127.f), 12582912.f));
}
// four bf16 values (two words) as four int8 values, the first in the low byte
template <bool kDiv>
__device__ __forceinline__ uint32_t quant4(uint32_t lo, uint32_t hi, float s, float r) {
  const uint32_t a = __byte_perm(quant_bits<kDiv>(__uint_as_float(lo << 16), s, r),
                                 quant_bits<kDiv>(__uint_as_float(lo & 0xffff0000u), s, r), 0x0040);
  const uint32_t b = __byte_perm(quant_bits<kDiv>(__uint_as_float(hi << 16), s, r),
                                 quant_bits<kDiv>(__uint_as_float(hi & 0xffff0000u), s, r), 0x0040);
  return __byte_perm(a, b, 0x5410);
}

// The head's K (rows 0 .. rows - 1 of a (b, h, s, D) bf16 operand: head
// base x, seq stride ss) quantized into the int8 tile at tile, by `threads`
// threads (this one is `tid`), 16 values a 16-byte chunk; rows at or past S
// as zeros. Each thread has kBatch chunks' loads in flight at once.
template <int D, bool kDiv>
__device__ __forceinline__ void quantize_k_rows(uint32_t tile, const __nv_bfloat16* x, long long ss, int rows, int S,
                                                float s, float rs, int tid, int threads) {
  constexpr int CPR = D / 16;  // 16-byte chunks of an int8 row
  constexpr int kBatch = 4;
  const int n = rows * CPR;
  for (int i0 = tid; i0 < n; i0 += kBatch * threads) {
    uint4 lo[kBatch], hi[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * threads, r = i / CPR;
      lo[u] = hi[u] = make_uint4(0, 0, 0, 0);  // zeros quantize to zeros
      if (i < n && r < S) {
        const uint4* src = reinterpret_cast<const uint4*>(x + r * ss + 16 * (i % CPR));
        lo[u] = __ldg(src);
        hi[u] = __ldg(src + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * threads;
      if (i < n) {
        st_shared_v4(I8Tile<D>::at(tile, i / CPR, i % CPR),
                     make_uint4(quant4<kDiv>(lo[u].x, lo[u].y, s, rs), quant4<kDiv>(lo[u].z, lo[u].w, s, rs),
                                quant4<kDiv>(hi[u].x, hi[u].y, s, rs), quant4<kDiv>(hi[u].z, hi[u].w, s, rs)));
      }
    }
  }
}
template <int D>
__device__ __forceinline__ void quantize_k(bool div, uint32_t tile, const __nv_bfloat16* x, long long ss, int rows,
                                           int S, float s, float rs, int tid, int threads) {
  if (div) {
    quantize_k_rows<D, true>(tile, x, ss, rows, S, s, rs, tid, threads);
  } else {
    quantize_k_rows<D, false>(tile, x, ss, rows, S, s, rs, tid, threads);
  }
  fence_async_smem();  // the stores, for wgmma's reads after the caller's barrier
}

// The 16-byte chunk c8 (bf16 columns 8 * c8 ..) of row r of a bf16 Q tile
// (Tile<kQT, D>) as TMA wrote it: column block, then the swizzled chunk.
template <int D>
__device__ __forceinline__ uint32_t bf16_chunk(uint32_t base, int r, int c8) {
  using QT = Tile<kQT, D>;
  constexpr int CPB = QT::BW / 8;  // chunks of a column block's row
  const int swz = QT::MODE == 1 ? r & 7 : (r >> 1) & 3;
  return base + (c8 / CPB) * QT::BLOCKB + r * QT::ROWB + 16 * ((c8 % CPB) ^ swz);
}

// The warpgroup's bf16 Q tile at `stage` (rows past s arrived as zeros)
// quantized into its int8 tile at `dst`: D / 32 chunks of 16 values a thread.
template <int D, bool kDiv>
__device__ __forceinline__ void quantize_q_rows(uint32_t dst, uint32_t stage, float s, float rs, int tid) {
  constexpr int CPR = D / 16;  // 16-byte chunks of an int8 row
#pragma unroll
  for (int j = 0; j < kQT * CPR / kWG; ++j) {
    const int i = tid + j * kWG, r = i / CPR, c = i % CPR;
    const uint4 lo = ld_shared_v4(bf16_chunk<D>(stage, r, 2 * c));
    const uint4 hi = ld_shared_v4(bf16_chunk<D>(stage, r, 2 * c + 1));
    st_shared_v4(I8Tile<D>::at(dst, r, c), make_uint4(quant4<kDiv>(lo.x, lo.y, s, rs), quant4<kDiv>(lo.z, lo.w, s, rs),
                                                      quant4<kDiv>(hi.x, hi.y, s, rs), quant4<kDiv>(hi.z, hi.w, s, rs)));
  }
}
template <int D>
__device__ __forceinline__ void quantize_q(bool div, uint32_t dst, uint32_t stage, float s, float rs, int tid) {
  if (div) {
    quantize_q_rows<D, true>(dst, stage, s, rs, tid);
  } else {
    quantize_q_rows<D, false>(dst, stage, s, rs, tid);
  }
  fence_async_smem();
}

// S = Q K^T for one 64-key piece of N keys (K rows key0 ..): D / 32 k32 steps
template <int D, int N>
__device__ __forceinline__ void score_piece(int (&s)[32], uint32_t qs, uint32_t ks, int key0) {
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) mma_ss<N>(s, I8Tile<D>::kmajor(qs, 0, kk), I8Tile<D>::kmajor(ks, key0, kk), kk > 0);
}

// the int32 scores of the chunk of keys k0 .. k0 + 16 * n16 - 1 (n16 <= 8)
template <int D>
__device__ __forceinline__ void chunk_scores(int (&s)[kChunk / kPiece][32], uint32_t qs, uint32_t ks, int k0,
                                             int n16) {
  wg_fence();
#pragma unroll
  for (int pc = 0; pc < kChunk / kPiece; ++pc) {
    const int w = n16 - 4 * pc;  // 16-key steps in this piece
    if (w >= 4) {
      score_piece<D, 64>(s[pc], qs, ks, k0 + kPiece * pc);
    } else if (w == 3) {
      score_piece<D, 48>(s[pc], qs, ks, k0 + kPiece * pc);
    } else if (w == 2) {
      score_piece<D, 32>(s[pc], qs, ks, k0 + kPiece * pc);
    } else if (w == 1) {
      score_piece<D, 16>(s[pc], qs, ks, k0 + kPiece * pc);
    }
  }
  wg_commit();
  wg_wait();
#pragma unroll
  for (int pc = 0; pc < kChunk / kPiece; ++pc) fence_regs(s[pc]);
}

// exp(x) for x <= 0 as ex2.approx(x * log2(e)): a relative error of about
// 2^-22 plus |x| * 2^-24, far below p's bf16 rounding for p.V; denormal p
// flush to 0
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

// k16 step kk of the 64 x 64 fragment of p (fp32 bits in s) as a bf16 A operand (to_a_frag's mapping)
__device__ __forceinline__ void p_frag(const int (&s)[32], int kk, uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = pack_bf16(__int_as_float(s[8 * kk + 2 * i]), __int_as_float(s[8 * kk + 2 * i + 1]));
}

// Blocks an SM the registers must allow: two of two warpgroups (126
// registers a thread) up to d 64; at d 128 the output's 64 accumulators
// beside the chunk's 64 take more, and one block is all the V tile leaves
// room for at most lengths anyway.
template <int D, int NWG>
constexpr int min_blocks() {
  return D <= 64 ? 4 / NWG : 1;
}

// grid (b*h, groups), block NWG warpgroups, dynamic smem as launch plans it.
// Warpgroup w of block y takes the head's query tiles r, r + G, ... with
// G = groups * NWG and r = G - 1 - (y * NWG + w). The int8 K and V, resident
// or in the ring (NWG 1 only), are the block's; each warpgroup has its own
// int8 Q tile.
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * kWG, (min_blocks<D, NWG>()))
    packed_mha_int8_tc_kernel(const Int8Args a, const Int8Plan p, const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tv) {
  using QT = Tile<kQT, D>;      // a bf16 Q tile, as TMA brings it
  using VT = Tile<kPiece, D>;   // bf16 V: resident p.boxes * p.kr rows, a ring slot p.kr
  constexpr int BW = VT::BW;
  constexpr int NB = D / BW;  // output column blocks
  constexpr int NCH = kChunk / kPiece;  // score pieces a chunk
  constexpr int QB = kQT * D;           // bytes of an int8 Q tile
  extern __shared__ uint8_t smem_raw[];
  // this warpgroup, warp-uniform (a shuffle from lane 0), so that the Q
  // descriptors built from it stay in uniform registers
  const int wg = NWG == 1 ? 0 : __shfl_sync(kFullMask, (int)threadIdx.x / kWG, 0);
  const uint32_t q_s = smem_base(smem_raw) + wg * (QB + QT::BYTES);  // this warpgroup's int8 Q tile
  const uint32_t q_stage = q_s + QB;                                  // and its bf16 Q tile in flight
  const uint32_t k_s = smem_base(smem_raw) + NWG * (QB + QT::BYTES);  // the head's int8 K
  const uint32_t v_s = k_s + p.k_bytes;                 // V (resident), or its 2 ring slots
  const int v_rows = p.resident ? p.boxes * p.kr : p.kr;  // rows of the V tile (or a slot)
  const uint32_t v_bytes = v_rows * D * 2;
  const uint32_t bars = v_s + (p.resident ? 1 : 2) * v_bytes;  // V (resident) or the ring's 2 slots; the Q stages
  const uint32_t q_bar = bars + 8 * (2 + wg);

  const int bh = blockIdx.x;
  const int bi = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x % kWG, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int S = a.S;
  const int n_qt = (S + kQT - 1) / kQT;
  const int n16_all = (S + 15) / 16;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const int G = p.groups * NWG;
  const int r = G - 1 - (int)blockIdx.y * NWG - wg;
  const int n_mine = (n_qt - r + G - 1) / G;
  const bool div = a.dyn_scales != nullptr;
  // JAX's dynamic form: x / s, and qs * ks * scale in fp32, in that order
  const float sq = div ? a.dyn_scales[0] : a.inv_q, sk = div ? a.dyn_scales[1] : a.inv_k;
  const float dq = div ? __fmul_rn(__fmul_rn(sq, sk), a.scale) : a.dq_static;
  const float rq = div ? __frcp_rn(sq) : 0.f, rk = div ? __frcp_rn(sk) : 0.f;  // the divisors' reciprocals
  const __nv_bfloat16* kx = static_cast<const __nv_bfloat16*>(a.k) + bi * a.k_sb + h * a.k_sh;

  init_bars(bars, 2 + NWG, threadIdx.x);
  if (tid == 0 && n_mine > 0) {  // the first Q tile, on its way while the block quantizes K
    mbar_expect(q_bar, QT::BYTES);
    QT::tma(q_stage, tq, q_bar, r * kQT, h, bi);
  }
  // rows row0 .. row0 + p.kr - 1 of V into the tile at vs, at row `at`; completes on `bar`
  auto load_v = [&](uint32_t vs, int at, int row0, uint32_t bar) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) tma_load(vs + (nb * v_rows + at) * VT::ROWB, tv, bar, nb * BW, row0, h, bi);
  };
  // the ring's next load (NWG 1): chunk pc of tile pi into slot pj & 1, pj its step
  int pi = 0, pc = 0, pj = 0;
  auto load_next = [&]() {
    if (pi >= n_mine) return;
    if (tid == 0) {
      const uint32_t bar = bars + 8 * (pj & 1);
      mbar_expect(bar, v_bytes);
      load_v(v_s + (pj & 1) * v_bytes, 0, pc * kChunk, bar);
    }
    ++pj;
    if (++pc >= n_chunks) pc = 0, ++pi;
  };
  if (threadIdx.x == 0 && p.resident) {  // every key's V, once
    const int n = (S + p.kr - 1) / p.kr;
    mbar_expect(bars, (uint32_t)n * p.kr * D * 2);
    for (int b = 0; b < n; ++b) load_v(v_s, b * p.kr, b * p.kr, bars);
  }
  if (!p.resident) {
    load_next();
    load_next();
  }
  // the head's K, once, by the whole block, while V is on its way
  quantize_k<D>(div, k_s, kx, a.k_ss, n16_all * 16, S, sk, rk, threadIdx.x, NWG * kWG);
  __syncthreads();

  int j = 0;  // the ring's step
  for (int i = 0; i < n_mine; ++i) {
    const int q0 = (r + i * G) * kQT;
    wg_sync(wg);  // the warpgroup is done with the previous tile's int8 Q
    mbar_wait(q_bar, i & 1);
    quantize_q<D>(div, q_s, q_stage, sq, rq, tid);
    wg_sync(wg);  // the int8 tile is written, the stage read: the next tile's copy refills it
    if (tid == 0 && i + 1 < n_mine) {
      mbar_expect(q_bar, QT::BYTES);
      QT::tma(q_stage, tq, q_bar, q0 + G * kQT, h, bi);
    }
    const int row0 = q0 + 16 * warp + g;  // rows row0 and row0 + 8 of this thread

    // Two passes over the key chunks, one loop (one copy of the score
    // products, which keeps the registers at two blocks an SM): pass 1 keeps
    // each row's largest int32 score (keys past s are no candidates), pass 2
    // takes p = exp(fl(s * dq) - m), its fp32 sum, and p V with p rounded to bf16.
    int mi[2] = {INT_MIN, INT_MIN};
    float m[2] = {0.f, 0.f}, l[2] = {0.f, 0.f};
    float o[NB][BW / 2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < BW / 2; ++e) o[nb][e] = 0.f;
    for (int it = 0; it < 2 * n_chunks; ++it) {
      const bool pass2 = it >= n_chunks;
      const int k0 = (pass2 ? it - n_chunks : it) * kChunk;
      const int n16 = min(kChunk / 16, n16_all - k0 / 16);
      int s[NCH][32];  // the scores, then (pass 2) p's bits in place
      chunk_scores<D>(s, q_s, k_s, k0, n16);
      if (!pass2) {
#pragma unroll
        for (int pp = 0; pp < NCH; ++pp) {
          if (4 * pp >= n16) continue;
          const int kp0 = k0 + kPiece * pp;
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            if (e / 8 >= n16 - 4 * pp) break;  // past the piece's 16-key steps: never written
            if (kp0 + 8 * (e / 4) + 2 * t + (e & 1) < S) mi[(e / 2) & 1] = max(mi[(e / 2) & 1], s[pp][e]);
          }
        }
        if (it == n_chunks - 1) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            mi[hh] = max(mi[hh], __shfl_xor_sync(kFullMask, mi[hh], 1));
            mi[hh] = max(mi[hh], __shfl_xor_sync(kFullMask, mi[hh], 2));
            m[hh] = __fmul_rn((float)mi[hh], dq);  // the scaled row's max
          }
        }
        continue;
      }
#pragma unroll
      for (int pp = 0; pp < NCH; ++pp) {
        if (4 * pp >= n16) continue;
        const int kp0 = k0 + kPiece * pp;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          if (e / 8 >= n16 - 4 * pp) break;
          const bool key = kp0 + 8 * (e / 4) + 2 * t + (e & 1) < S;
          const float pv = key ? exp_approx(__fsub_rn(__fmul_rn((float)s[pp][e], dq), m[(e / 2) & 1])) : 0.f;
          l[(e / 2) & 1] += pv;
          s[pp][e] = __float_as_int(pv);
        }
      }
      // this chunk's V: rows k0 .. of the resident tile, or a ring slot
      const int slot = p.resident ? 0 : j & 1;
      mbar_wait(bars + 8 * slot, p.resident ? 0 : (j >> 1) & 1);
      const uint32_t vs = v_s + slot * v_bytes;
      const int vbase = p.resident ? k0 : 0;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);
      wg_fence();
#pragma unroll
      for (int pp = 0; pp < NCH; ++pp)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (4 * pp + kk >= n16) continue;
          uint32_t af[4];
          p_frag(s[pp], kk, af);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) mma_rs<BW>(o[nb], af, VT::mnmajor(vs, vbase / 16 + 4 * pp + kk, nb, v_rows));
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
      const float den = quad_sum(l[hh]);
      if (row < S) {
        __nv_bfloat16* orow = row_at<__nv_bfloat16>(a.o, a.o_sb, a.o_sh, a.o_ss, bi, h, row);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int jj = 0; jj < BW / 8; ++jj)
            *reinterpret_cast<__nv_bfloat162*>(orow + nb * BW + 8 * jj + 2 * t) = __floats2bfloat162_rn(
                __fdiv_rn(o[nb][4 * jj + 2 * hh], den), __fdiv_rn(o[nb][4 * jj + 2 * hh + 1], den));
      }
    }
  }
}

// ------------------------------------------------------------------ launches

constexpr int kNoPlan = -1;  // launch<D, 2>: V is not resident, take one warpgroup a block

template <int D, int NWG>
int launch(const Int8Args& a, cudaStream_t stream) {
  static const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  static const int smem_max = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const int s16 = (a.S + 15) / 16 * 16;
  Int8Plan p;
  p.k_bytes = (s16 * D + 1023) / 1024 * 1024;
  // each warpgroup's int8 and bf16 Q tiles, the int8 K, the slack and 2 + NWG mbarriers
  const size_t fixed = (size_t)NWG * kQT * D * 3 + p.k_bytes + kAlignSlack + 8 * (2 + NWG);
  p.boxes = (s16 + 255) / 256;  // a TMA box has at most 256 rows
  p.kr = ((s16 + p.boxes - 1) / p.boxes + 15) / 16 * 16;
  p.resident = fixed + (size_t)p.boxes * p.kr * D * 2 <= (size_t)smem_max;
  if (!p.resident && NWG > 1) return kNoPlan;
  if (!p.resident) p.kr = kChunk;  // a ring of 2 slots of one chunk each
  const size_t smem = fixed + (p.resident ? (size_t)p.boxes * p.kr : 2 * (size_t)p.kr) * D * 2;
  if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  // two blocks an SM at least, where the heads alone are fewer; each
  // warpgroup has a tile at least
  const int n_qt = (a.S + kQT - 1) / kQT, heads = a.B * a.H;
  p.groups = std::max(1, std::min(n_qt / NWG, (2 * sms + heads - 1) / heads));

  CUtensorMap tq, tv;
  if (!make_map<D>(&tq, a.q, a.B, a.H, a.S, a.q_sb, a.q_sh, a.q_ss, kQT) ||
      !make_map<D>(&tv, a.v, a.B, a.H, a.S, a.v_sb, a.v_sh, a.v_ss, p.kr)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = packed_mha_int8_tc_kernel<D, NWG>;
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<dim3(heads, p.groups), NWG * kWG, smem, stream>>>(a, p, tq, tv);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const Int8Args& a, cudaStream_t stream) {
  if (kConsumers == 2 && a.S > kQT) {
    const int err = launch<D, 2>(a, stream);
    if (err != kNoPlan) return err;
  }
  return launch<D, 1>(a, stream);
}

std::atomic<int> tc_calls{0};  // calls that launched the kernel, counted where the launch succeeded

}  // namespace

int launch_int8_tc(int D, const Int8Args& a, cudaStream_t stream) {
  int err = (int)cudaErrorInvalidValue;
  if (D == 32) err = launch_d<32>(a, stream);
  if (D == 64) err = launch_d<64>(a, stream);
  if (D == 128) err = launch_d<128>(a, stream);
  if (err == 0) tc_calls.fetch_add(1, std::memory_order_relaxed);
  return err;
}

}  // namespace llmq

extern "C" int llmq_packed_mha_int8_tc_launches() { return llmq::tc_calls.load(std::memory_order_relaxed); }
