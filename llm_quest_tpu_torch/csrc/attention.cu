// Blockwise online-softmax attention, forward and backward, for Hopper.
//
// Replaces these TPU kernels:
//   llm_quest_tpu/kernels/flash_attention.py::flash_attention, forward (_fwd /
//     _fwd_kernel) and recompute backward (_bwd_dq_kernel, _bwd_dkv_kernel,
//     the custom VJP of _flash_core): causal masking with a static query offset q_start (query
//     row i sits at absolute position q_start + i; key j is visible iff
//     j <= q_start + i), a (b, sk) key-validity mask (nonzero = real key),
//     GQA (q head h reads kv head h / (hq / hkv)), a sliding window (key j
//     is masked for query position p when j <= p - window: _score_mask),
//     score soft-capping s -> cap * tanh(s / cap) (before the mask, as in
//     _fwd_kernel / _recompute_p) and per-head sink logits (one more term
//     exp(sink[h] - m) in each row's normalizer, no value: _fwd_kernel's last
//     k step). v may have its own head dim dv (JAX takes v as (b, hkv, sk,
//     dv), out (b, hq, sq, dv)): the q/k width D and the v/out width DV are
//     two template widths. Qwen3.5 text: hq 8, hkv 2, d 256; Gemma-3-270M:
//     hq 4, hkv 1, d 256, window 512; MiMo-V2-Flash small: hq 12, hkv 4 (SWA,
//     window 128, sinks) or 2 (GA), d 64, dv 32; DeepSeek-V3 small's MLA:
//     hq = hkv = 12, causal, d 96 (the latent-up 64 and the RoPE'd
//     decoupled 32, concatenated), dv 64. At d 96, the first width that is
//     no power of two, each of a row's eight threads owns 12 q/k columns
//     and 8 v columns; no loop depends on D beyond D % 8 == 0.
//   llm_quest_tpu/kernels/fused_mha.py::packed_mha (_packed_mha_kernel):
//     bidirectional maskless attention read straight from the packed
//     (b, s, h*d) projection outputs, head dims 32, 64 and 128. ViT-B/224:
//     12 heads x 64, s 197. Its fp32 forward only: bf16 takes
//     fused_mha_tc.cu.
//   The recompute VJPs of fused_mha.py::fused_mha and ::packed_mha (XLA's in
//     JAX): the backward kernels below, fed the forward's lse, write their
//     gradients by the caller's strides (the packed layout needs no copy).
// All are one kernel each way: every operand is addressed by (batch, head,
// seq) strides with a contiguous last dim, so the packed layout needs no
// transposes and the GQA head map is a division.
//
// Design: one block of 128 threads owns BQ = 16 query rows of one
// (batch, q-head); eight threads share a row. The block walks the key blocks
// of BK = 32 in order, stages K and V in shared memory as fp32, computes its
// 16 x 32 score tile, and keeps the running max, sum and the (16, dv) fp32
// output accumulator (dv / 8 values per thread, in registers) of the online
// softmax. The flash forward also writes the row logsumexp m + log(l) (fp32)
// for the backward; with sinks the lse includes them, so the backward's
// p = exp(s - lse) needs no change. Causal blocks past the diagonal of the
// block's last row are never loaded, and neither are the key blocks below
// the window of the block's first row: the loop starts there, so a windowed
// layer costs O(s * window), not O(s^2) (the TPU kernel's clamped index
// maps skip the same blocks). Masked scores are finfo(float32).min / 2, as in the JAX package, so
// a row with no visible key averages the keys it visited instead of NaN;
// keys past sk contribute nothing.
//
// Dtypes: this file's kernels run fp32 inputs, with every product on the
// fp32 SIMT units, so they are bound by shared-memory bandwidth of the score
// and PV loops; fp32 keeps them, because the fp32 checks hold the port to
// its plain versions at 2e-4 down to 1e-6, which TF32 or bf16 operands
// would break. bf16 inputs go to the tensor-core (wgmma) kernels of
// attention_tc.cu; the C entry points at the end of this file branch on the
// dtype. At d = 256 the staged tiles take 84 KB, above the 48 KB default, so
// the launch raises the kernel's dynamic shared-memory limit first. The
// backward's design is described above its kernels below.
#include "attention.cuh"

namespace llmq {
namespace {

constexpr int kBQ = 16;       // query rows per block
constexpr int kBK = 32;       // keys per staged tile
constexpr int kThreads = 128;
constexpr int kTPR = kThreads / kBQ;  // threads per query row (8, within one warp)
constexpr int kPS = kBK + 1;          // padded row stride of the probability tile

// First key of the kBK-aligned tile that the query at absolute position
// qpos0 (a block's first row) needs: keys at or below qpos - window are
// outside every later row's window too. window 0 = none.
__device__ __forceinline__ int window_begin(int qpos0, int window) {
  return window > 0 ? (max(0, qpos0 - window + 1) / kBK) * kBK : 0;
}

// Whether a score is masked: causal, outside the window, or a padded key.
__device__ __forceinline__ bool score_masked(int kpos, int qpos, int causal, int window, const uint8_t* mb) {
  return (causal && kpos > qpos) || (window > 0 && kpos <= qpos - window) || (mb != nullptr && mb[kpos] == 0);
}

template <int D, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * DV + kBQ * kPS);
}

// grid (ceil(sq / kBQ), b*hq), block kThreads, dynamic smem smem_bytes<D, DV>().
// q/k rows are D wide, v/o rows DV wide.
template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ o, float* __restrict__ lse,
                     const uint8_t* __restrict__ key_mask, int HQ, int HKV,
                     int SQ, int SK, long long q_sb, long long q_sh, long long q_ss,
                     long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                     long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                     long long o_ss, long long mask_sb, int causal, int q_start, float scale,
                     int window, float softcap, const float* __restrict__ sink) {
  static_assert(D % kTPR == 0 && DV % kTPR == 0 && DV <= D, "head dims: multiples of 8, dv <= d");
  constexpr int DP = D + 1;      // padded stride: the 8 keys a row reads hit 8 banks
  constexpr int NC = DV / kTPR;  // output columns per thread
  constexpr int NS = kBK / kTPR; // scores per thread per tile
  extern __shared__ float smem[];
  float* q_s = smem;              // kBQ x DP, pre-scaled
  float* k_s = q_s + kBQ * DP;    // kBK x DP
  float* v_s = k_s + kBK * DP;    // kBK x DV
  float* p_s = v_s + kBK * DV;    // kBQ x kPS

  const int bh = blockIdx.y;
  const int bi = bh / HQ, hq = bh % HQ;
  const int hk = hq / (HQ / HKV);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int r = tid / kTPR, c = tid % kTPR;

  const float* qb = q + bi * q_sb + hq * q_sh;
  const float* kb = k + bi * k_sb + hk * k_sh;
  const float* vb = v + bi * v_sb + hk * v_sh;
  const uint8_t* mb = key_mask != nullptr ? key_mask + bi * mask_sb : nullptr;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    q_s[rr * DP + d] = q0 + rr < SQ ? qb[(q0 + rr) * q_ss + d] * scale : 0.f;
  }

  const int q_last = min(q0 + kBQ, SQ) - 1;
  const int k_end = causal ? min(SK, q_start + q_last + 1) : SK;
  const int qpos = q_start + q0 + r;

  float acc[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = window_begin(q_start + q0, window); k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q_s is staged)
    // K and V in one loop at DV == D, V in a loop of its own when it is narrower
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const bool ok = k0 + j < SK;
      k_s[j * DP + d] = ok ? kb[(k0 + j) * k_ss + d] : 0.f;
      if constexpr (DV == D) v_s[j * DV + d] = ok ? vb[(k0 + j) * v_ss + d] : 0.f;
    }
    if constexpr (DV < D) {
      for (int i = tid; i < kBK * DV; i += kThreads) {
        const int j = i / DV, d = i % DV;
        v_s[j * DV + d] = k0 + j < SK ? vb[(k0 + j) * v_ss + d] : 0.f;
      }
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) s[jj] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = q_s[r * DP + d];
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) s[jj] += qd * k_s[(c + kTPR * jj) * DP + d];
    }

    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      const int kpos = k0 + c + kTPR * jj;
      if (softcap > 0.f) s[jj] = softcap * tanhf(s[jj] / softcap);
      if (kpos >= SK) {
        s[jj] = -INFINITY;
      } else if (score_masked(kpos, qpos, causal, window, mb)) {
        s[jj] = kMasked;
      }
      mx = fmaxf(mx, s[jj]);
    }
#pragma unroll
    for (int off = kTPR / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);  // 0 on the first tile (m = -inf)
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      const float p = expf(s[jj] - m_new);
      p_s[r * kPS + c + kTPR * jj] = p;
      sum += p;
    }
#pragma unroll
    for (int off = kTPR / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(kFullMask, sum, off);
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[n] *= corr;
    __syncwarp();  // the row's probabilities (written by its 8 threads) are visible
    for (int j = 0; j < kBK; ++j) {
      const float p = p_s[r * kPS + j];
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[n] += p * v_s[j * DV + c + kTPR * n];
    }
  }

  if (sink != nullptr) {  // one more logit in the normalizer, with no value
    const float m_new = fmaxf(m, sink[hq]);
    const float corr = expf(m - m_new);
    l = l * corr + expf(sink[hq] - m_new);
    m = m_new;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[n] *= corr;
  }
  if (q0 + r < SQ) {
    float* orow = o + bi * o_sb + hq * o_sh + (q0 + r) * o_ss;
    const float inv = l > 0.f ? 1.f / l : 0.f;  // l = 0 only for a row with no key tile at all
#pragma unroll
    for (int n = 0; n < NC; ++n) orow[c + kTPR * n] = acc[n] * inv;
    if (lse != nullptr && c == 0) lse[(long long)bh * SQ + q0 + r] = m + logf(l);
  }
}

// ------------------------------------------------------------------ backward
//
// Recompute backward (FlashAttention-2), from the forward's row logsumexp
// lse and delta = rowsum(dO * O) (minus an optional per-row shift, the
// cotangent of lse when a caller differentiates through it):
//   p = exp(s - lse), dp = dO V^T, ds = p * (dp - delta),
//   dq = scale * ds K, dk = scale * ds^T Q, dv = p^T dO.
// With a softcap, s = cap * t, t = tanh(s_raw / cap), and ds is multiplied
// by ds/ds_raw = 1 - t^2 (JAX's _recompute_p). Sinks need nothing here: the
// forward's lse includes them, and dsink is a reduction over the rows (the
// wrapper's, as in JAX). Masked scores have p = 0 and ds = 0 (the score
// there is a constant). Both kernels skip the tiles outside the window:
// the dq kernel starts its key walk at the window of its first row, the
// dk/dv kernel stops its row walk at the last row that sees its last key
// (JAX's _q_index_map_for_dkv).
// Two kernels, no atomics, so the gradients are deterministic:
//   dq:  one block per (b*hq, 16 query rows), walking the visible key tiles;
//   dkv: one block per (b*hkv, 16 keys), walking the visible query tiles of
//        every q head of the GQA group, so dk/dv need no per-q-head buffers
//        and no group sum afterwards.
// Both keep their fp32 accumulators in registers (d/8 or dv/8 values per
// thread per accumulator, eight threads per row: dq and dk are D wide, dv is
// DV wide, and dp = dO V^T runs over DV) and stage the operand tiles as fp32 in
// shared memory with a padded row stride; at d = 256 a block stages ~100 KB,
// so each launch raises the kernel's dynamic shared-memory limit first.

// p and ds of one recomputed score s_raw (scaled); ds carries the softcap's
// chain factor.
__device__ __forceinline__ void recompute_p(const BwdArgs& a, float s_raw, float lse, float dp, float delta,
                                            float& p, float& ds) {
  float dcap = 1.f;
  if (a.softcap > 0.f) {
    const float t = tanhf(s_raw / a.softcap);
    s_raw = a.softcap * t;
    dcap = 1.f - t * t;
  }
  p = expf(s_raw - lse);
  ds = p * (dp - delta) * dcap;
}

__device__ __forceinline__ float row_delta(const BwdArgs& a, long long i) {
  return a.delta[i] - (a.delta_shift != nullptr ? a.delta_shift[i] : 0.f);
}

template <int D, int DV>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * ((kBQ + kBK) * (D + 1) + (kBQ + kBK) * (DV + 1) + kBQ * kPS);
}

// grid (ceil(sq / kBQ), b*hq), block kThreads, dynamic smem dq_smem_bytes<D, DV>().
template <int D, int DV>
__global__ void __launch_bounds__(kThreads) attention_bwd_dq_kernel(const BwdArgs a) {
  constexpr int DP = D + 1;
  constexpr int DVP = DV + 1;
  constexpr int NC = D / kTPR;
  constexpr int NS = kBK / kTPR;
  extern __shared__ float smem[];
  float* q_s = smem;              // kBQ x DP, pre-scaled as in the forward
  float* do_s = q_s + kBQ * DP;   // kBQ x DVP
  float* k_s = do_s + kBQ * DVP;  // kBK x DP
  float* v_s = k_s + kBK * DP;    // kBK x DVP
  float* ds_s = v_s + kBK * DVP;  // kBQ x kPS

  const int bh = blockIdx.y;
  const int bi = bh / a.HQ, hq = bh % a.HQ;
  const int hk = hq / (a.HQ / a.HKV);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int r = tid / kTPR, c = tid % kTPR;

  const float* qb = static_cast<const float*>(a.q) + bi * a.q_sb + hq * a.q_sh;
  const float* dob = static_cast<const float*>(a.dout) + bi * a.do_sb + hq * a.do_sh;
  const float* kb = static_cast<const float*>(a.k) + bi * a.k_sb + hk * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + bi * a.v_sb + hk * a.v_sh;
  const uint8_t* mb = a.key_mask != nullptr ? a.key_mask + bi * a.mask_sb : nullptr;

  // the D-wide and DV-wide operands in one loop at DV == D, in two below
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const bool ok = q0 + rr < a.SQ;
    q_s[rr * DP + d] = ok ? qb[(q0 + rr) * a.q_ss + d] * a.scale : 0.f;
    if constexpr (DV == D) do_s[rr * DVP + d] = ok ? dob[(q0 + rr) * a.do_ss + d] : 0.f;
  }
  if constexpr (DV < D) {
    for (int i = tid; i < kBQ * DV; i += kThreads) {
      const int rr = i / DV, d = i % DV;
      do_s[rr * DVP + d] = q0 + rr < a.SQ ? dob[(q0 + rr) * a.do_ss + d] : 0.f;
    }
  }

  const int row = q0 + r;
  const bool row_ok = row < a.SQ;
  const long long stat = (long long)bh * a.SQ + row;
  const float lse_r = row_ok ? a.lse[stat] : 0.f;
  const float delta_r = row_ok ? row_delta(a, stat) : 0.f;
  const int q_last = min(q0 + kBQ, a.SQ) - 1;
  const int k_end = a.causal ? min(a.SK, a.q_start + q_last + 1) : a.SK;
  const int qpos = a.q_start + row;

  float acc[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n] = 0.f;

  for (int k0 = window_begin(a.q_start + q0, a.window); k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q_s/do_s are staged)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const bool ok = k0 + j < a.SK;
      k_s[j * DP + d] = ok ? kb[(k0 + j) * a.k_ss + d] : 0.f;
      if constexpr (DV == D) v_s[j * DVP + d] = ok ? vb[(k0 + j) * a.v_ss + d] : 0.f;
    }
    if constexpr (DV < D) {
      for (int i = tid; i < kBK * DV; i += kThreads) {
        const int j = i / DV, d = i % DV;
        v_s[j * DVP + d] = k0 + j < a.SK ? vb[(k0 + j) * a.v_ss + d] : 0.f;
      }
    }
    __syncthreads();

    // s = q K^T over D, dp = dO V^T over DV: one loop at DV == D
    float s[NS], dp[NS];
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) s[jj] = dp[jj] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = q_s[r * DP + d], od = DV == D ? do_s[r * DVP + d] : 0.f;
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) {
        const int j = c + kTPR * jj;
        s[jj] += qd * k_s[j * DP + d];
        if constexpr (DV == D) dp[jj] += od * v_s[j * DVP + d];
      }
    }
    if constexpr (DV < D) {
      for (int d = 0; d < DV; ++d) {
        const float od = do_s[r * DVP + d];
#pragma unroll
        for (int jj = 0; jj < NS; ++jj) dp[jj] += od * v_s[(c + kTPR * jj) * DVP + d];
      }
    }
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      const int kpos = k0 + c + kTPR * jj;
      float p = 0.f, ds = 0.f;
      if (row_ok && kpos < a.SK && !score_masked(kpos, qpos, a.causal, a.window, mb)) {
        recompute_p(a, s[jj], lse_r, dp[jj], delta_r, p, ds);
      }
      ds_s[r * kPS + c + kTPR * jj] = ds;
    }
    __syncwarp();  // the row's ds (written by its 8 threads) are visible
    for (int j = 0; j < kBK; ++j) {
      const float g = ds_s[r * kPS + j];
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[n] += g * k_s[j * DP + c + kTPR * n];
    }
  }

  if (row_ok) {
    float* dqrow = row_at<float>(a.dq, a.dq_sb, a.dq_sh, a.dq_ss, bi, hq, row);
#pragma unroll
    for (int n = 0; n < NC; ++n) dqrow[c + kTPR * n] = acc[n] * a.scale;
  }
}

constexpr int kKvBK = kThreads / kTPR;  // keys per dkv block (16), eight threads per key
constexpr int kKvBQ = 32;               // query rows per staged tile
constexpr int kKvPS = kKvBQ + 1;        // padded row stride of the p / ds tiles

template <int D, int DV>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) *
         ((kKvBK + kKvBQ) * (D + 1) + (kKvBK + kKvBQ) * (DV + 1) + 2 * kKvBK * kKvPS + 2 * kKvBQ);
}

// grid (ceil(sk / kKvBK), b*hkv), block kThreads, dynamic smem dkv_smem_bytes<D, DV>().
template <int D, int DV>
__global__ void __launch_bounds__(kThreads) attention_bwd_dkv_kernel(const BwdArgs a) {
  constexpr int DP = D + 1;
  constexpr int DVP = DV + 1;
  constexpr int NC = D / kTPR;    // dk columns per thread
  constexpr int NCV = DV / kTPR;  // dv columns per thread
  constexpr int NR = kKvBQ / kTPR;  // query rows per thread per tile
  extern __shared__ float smem[];
  float* k_s = smem;                    // kKvBK x DP
  float* v_s = k_s + kKvBK * DP;        // kKvBK x DVP
  float* q_s = v_s + kKvBK * DVP;       // kKvBQ x DP
  float* do_s = q_s + kKvBQ * DP;       // kKvBQ x DVP
  float* p_s = do_s + kKvBQ * DVP;      // kKvBK x kKvPS
  float* ds_s = p_s + kKvBK * kKvPS;    // kKvBK x kKvPS
  float* lse_s = ds_s + kKvBK * kKvPS;  // kKvBQ
  float* dl_s = lse_s + kKvBQ;          // kKvBQ

  const int bh = blockIdx.y;
  const int bi = bh / a.HKV, hk = bh % a.HKV;
  const int group = a.HQ / a.HKV;
  const int k0 = blockIdx.x * kKvBK;
  const int tid = threadIdx.x;
  const int j = tid / kTPR, c = tid % kTPR;
  const int kpos = k0 + j;

  const float* kb = static_cast<const float*>(a.k) + bi * a.k_sb + hk * a.k_sh;
  const float* vb = static_cast<const float*>(a.v) + bi * a.v_sb + hk * a.v_sh;
  const uint8_t* mb = a.key_mask != nullptr ? a.key_mask + bi * a.mask_sb : nullptr;
  for (int i = tid; i < kKvBK * D; i += kThreads) {
    const int jj = i / D, d = i % D;
    const bool ok = k0 + jj < a.SK;
    k_s[jj * DP + d] = ok ? kb[(k0 + jj) * a.k_ss + d] : 0.f;
    if constexpr (DV == D) v_s[jj * DVP + d] = ok ? vb[(k0 + jj) * a.v_ss + d] : 0.f;
  }
  if constexpr (DV < D) {
    for (int i = tid; i < kKvBK * DV; i += kThreads) {
      const int jj = i / DV, d = i % DV;
      v_s[jj * DVP + d] = k0 + jj < a.SK ? vb[(k0 + jj) * a.v_ss + d] : 0.f;
    }
  }
  const bool key_ok = kpos < a.SK && (mb == nullptr || mb[kpos] != 0);
  // causal: query row i sees key k0 only from i = k0 - q_start on;
  // window: the block's last key leaves the window after row
  // k0 + kKvBK - 1 + window - 1 - q_start
  const int i_min = a.causal ? max(0, k0 - a.q_start) : 0;
  const int i_end = a.window > 0 ? min(a.SQ, max(0, k0 + kKvBK - 1 + a.window - a.q_start)) : a.SQ;
  const int t0 = (i_min / kKvBQ) * kKvBQ;

  float dk_acc[NC], dv_acc[NCV];
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    dk_acc[n] = 0.f;
    if (n < NCV) dv_acc[n] = 0.f;
  }

  for (int g = 0; g < group; ++g) {
    const int hq = hk * group + g;
    const float* qb = static_cast<const float*>(a.q) + bi * a.q_sb + hq * a.q_sh;
    const float* dob = static_cast<const float*>(a.dout) + bi * a.do_sb + hq * a.do_sh;
    const long long stat0 = ((long long)bi * a.HQ + hq) * a.SQ;
    for (int q0 = t0; q0 < i_end; q0 += kKvBQ) {
      __syncthreads();  // the previous tile is consumed (and k_s/v_s are staged)
      for (int i = tid; i < kKvBQ * D; i += kThreads) {
        const int rr = i / D, d = i % D;
        const bool ok = q0 + rr < a.SQ;
        q_s[rr * DP + d] = ok ? qb[(q0 + rr) * a.q_ss + d] : 0.f;
        if constexpr (DV == D) do_s[rr * DVP + d] = ok ? dob[(q0 + rr) * a.do_ss + d] : 0.f;
      }
      if constexpr (DV < D) {
        for (int i = tid; i < kKvBQ * DV; i += kThreads) {
          const int rr = i / DV, d = i % DV;
          do_s[rr * DVP + d] = q0 + rr < a.SQ ? dob[(q0 + rr) * a.do_ss + d] : 0.f;
        }
      }
      if (tid < kKvBQ) {
        const bool ok = q0 + tid < a.SQ;
        lse_s[tid] = ok ? a.lse[stat0 + q0 + tid] : 0.f;
        dl_s[tid] = ok ? row_delta(a, stat0 + q0 + tid) : 0.f;
      }
      __syncthreads();

      float s[NR], dp[NR];
#pragma unroll
      for (int ii = 0; ii < NR; ++ii) s[ii] = dp[ii] = 0.f;
      // s = Q k^T over D, dp = dO v^T over DV: one loop at DV == D
      for (int d = 0; d < D; ++d) {
        const float kd = k_s[j * DP + d], vd = DV == D ? v_s[j * DVP + d] : 0.f;
#pragma unroll
        for (int ii = 0; ii < NR; ++ii) {
          const int rr = c + kTPR * ii;
          s[ii] += q_s[rr * DP + d] * kd;
          if constexpr (DV == D) dp[ii] += do_s[rr * DVP + d] * vd;
        }
      }
      if constexpr (DV < D) {
        for (int d = 0; d < DV; ++d) {
          const float vd = v_s[j * DVP + d];
#pragma unroll
          for (int ii = 0; ii < NR; ++ii) dp[ii] += do_s[(c + kTPR * ii) * DVP + d] * vd;
        }
      }
#pragma unroll
      for (int ii = 0; ii < NR; ++ii) {
        const int rr = c + kTPR * ii;
        const int row = q0 + rr;
        float p = 0.f, ds = 0.f;
        if (key_ok && row < a.SQ && !score_masked(kpos, a.q_start + row, a.causal, a.window, nullptr)) {
          recompute_p(a, s[ii] * a.scale, lse_s[rr], dp[ii], dl_s[rr], p, ds);
        }
        p_s[j * kKvPS + rr] = p;
        ds_s[j * kKvPS + rr] = ds;
      }
      __syncwarp();  // the key's p / ds (written by its 8 threads) are visible
      for (int rr = 0; rr < kKvBQ; ++rr) {
        const float p = p_s[j * kKvPS + rr], gs = ds_s[j * kKvPS + rr];
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          if (n < NCV) dv_acc[n] += p * do_s[rr * DVP + c + kTPR * n];
          dk_acc[n] += gs * q_s[rr * DP + c + kTPR * n];
        }
      }
    }
  }

  if (kpos < a.SK) {
    float* dkrow = row_at<float>(a.dk, a.dk_sb, a.dk_sh, a.dk_ss, bi, hk, kpos);
    float* dvrow = row_at<float>(a.dv, a.dv_sb, a.dv_sh, a.dv_ss, bi, hk, kpos);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      dkrow[c + kTPR * n] = dk_acc[n] * a.scale;
      if (n < NCV) dvrow[c + kTPR * n] = dv_acc[n];
    }
  }
}

// ------------------------------------------------------------------ launches

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, const uint8_t* key_mask,
           int B, int HQ, int HKV, int SQ, int SK, long long q_sb, long long q_sh, long long q_ss,
           long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
           long long v_ss, long long o_sb, long long o_sh, long long o_ss, long long mask_sb,
           int causal, int q_start, float scale, int window, float softcap, const float* sink,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, DV>();
  auto kernel = attention_fwd_kernel<D, DV>;
  // above 48 KB the launch is refused unless the kernel's limit is raised
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((SQ + kBQ - 1) / kBQ, B * HQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, key_mask, HQ, HKV, SQ, SK, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
      v_sh, v_ss, o_sb, o_sh, o_ss, mask_sb, causal, q_start, scale, window, softcap, sink);
  return (int)cudaGetLastError();
}

// The (d, dv) pairs the kernels are built for: dv = d at 32 (K7's forward and
// the K6/K7 backward only; K4's wrapper takes the others), 64, 128 and 256, d 64 with dv 32
// (MiMo-V2-Flash) and d 96 with dv 64 (DeepSeek-V3's MLA; shared memory
// 28.9 KB forward, 33.2 KB dq, 35.6 KB dk/dv). A pair is one more case here
// and in launch_bwd_d.
int launch_d(int D, int DV, const void* q, const void* k, const void* v, void* o, float* lse,
             const uint8_t* key_mask, int B, int HQ, int HKV, int SQ, int SK, long long q_sb,
             long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,
             long long v_sb, long long v_sh, long long v_ss, long long o_sb, long long o_sh,
             long long o_ss, long long mask_sb, int causal, int q_start, float scale, int window,
             float softcap, const float* sink, cudaStream_t stream) {
#define LLMQ_ATTN_CASE(DIM, VDIM)                                                              \
  if (D == DIM && DV == VDIM)                                                                  \
    return launch<DIM, VDIM>(q, k, v, o, lse, key_mask, B, HQ, HKV, SQ, SK, q_sb, q_sh, q_ss, \
                                k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, mask_sb,   \
                                causal, q_start, scale, window, softcap, sink, stream);
  LLMQ_ATTN_CASE(32, 32)
  LLMQ_ATTN_CASE(64, 64)
  LLMQ_ATTN_CASE(128, 128)
  LLMQ_ATTN_CASE(256, 256)
  LLMQ_ATTN_CASE(64, 32)
  LLMQ_ATTN_CASE(96, 64)
#undef LLMQ_ATTN_CASE
  return (int)cudaErrorInvalidValue;
}

template <int D, int DV>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t dq_smem = dq_smem_bytes<D, DV>();
  constexpr size_t kv_smem = dkv_smem_bytes<D, DV>();
  auto dq_kernel = attention_bwd_dq_kernel<D, DV>;
  auto dkv_kernel = attention_bwd_dkv_kernel<D, DV>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_smem);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<<<dim3((a.SQ + kBQ - 1) / kBQ, a.B * a.HQ), kThreads, dq_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkv_kernel<<<dim3((a.SK + kKvBK - 1) / kKvBK, a.B * a.HKV), kThreads, kv_smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_bwd_d(int D, int DV, const BwdArgs& a, cudaStream_t stream) {
  if (D == 32 && DV == 32) return launch_bwd<32, 32>(a, stream);
  if (D == 64 && DV == 64) return launch_bwd<64, 64>(a, stream);
  if (D == 128 && DV == 128) return launch_bwd<128, 128>(a, stream);
  if (D == 256 && DV == 256) return launch_bwd<256, 256>(a, stream);
  if (D == 64 && DV == 32) return launch_bwd<64, 32>(a, stream);
  if (D == 96 && DV == 64) return launch_bwd<96, 64>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace llmq

using namespace llmq;

extern "C" int llmq_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                                  void* lse, const void* key_mask, int B, int HQ, int HKV, int SQ,
                                  int SK, int D, int DV, long long q_sb, long long q_sh, long long q_ss,
                                  long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                                  long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                                  long long o_ss, long long mask_sb, int causal, int q_start,
                                  float scale, int window, float softcap, const void* sink,
                                  void* stream) {
  if (HKV <= 0 || HQ % HKV != 0 || SQ <= 0 || SK <= 0 || window < 0) return (int)cudaErrorInvalidValue;
  const uint8_t* mask = static_cast<const uint8_t*>(key_mask);
  const float* sink_f = static_cast<const float*>(sink);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_d(D, DV, q, k, v, o, lse_f, mask, B, HQ, HKV, SQ, SK, q_sb, q_sh, q_ss, k_sb,
                           k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, mask_sb, causal,
                           q_start, scale, window, softcap, sink_f, st);
  }
  if (dtype == kBFloat16) {  // the tensor-core kernels of attention_tc.cu
    const FwdArgs a{q,    k,    v,    o,    lse_f, mask, sink_f, B,       HQ,     HKV,   SQ,    SK,
                    q_sb, q_sh, q_ss, k_sb, k_sh,  k_ss, v_sb,   v_sh,    v_ss,   o_sb,  o_sh,  o_ss,
                    mask_sb, causal, q_start, scale, window, softcap};
    return launch_tc_fwd(D, DV, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int llmq_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  const void* delta_shift, void* dq, void* dk, void* dv,
                                  const void* key_mask, int B, int HQ, int HKV, int SQ, int SK, int D,
                                  int DV,
                                  long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                                  long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                                  long long v_ss, long long do_sb, long long do_sh, long long do_ss,
                                  long long dq_sb, long long dq_sh, long long dq_ss, long long dk_sb,
                                  long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh,
                                  long long dv_ss, long long mask_sb, int causal, int q_start, float scale,
                                  int window, float softcap, void* stream) {
  if (HKV <= 0 || HQ % HKV != 0 || SQ <= 0 || SK <= 0 || window < 0) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.delta_shift = static_cast<const float*>(delta_shift);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.key_mask = static_cast<const uint8_t*>(key_mask);
  a.B = B;
  a.HQ = HQ;
  a.HKV = HKV;
  a.SQ = SQ;
  a.SK = SK;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.q_ss = q_ss;
  a.k_sb = k_sb;
  a.k_sh = k_sh;
  a.k_ss = k_ss;
  a.v_sb = v_sb;
  a.v_sh = v_sh;
  a.v_ss = v_ss;
  a.do_sb = do_sb;
  a.do_sh = do_sh;
  a.do_ss = do_ss;
  a.dq_sb = dq_sb;
  a.dq_sh = dq_sh;
  a.dq_ss = dq_ss;
  a.dk_sb = dk_sb;
  a.dk_sh = dk_sh;
  a.dk_ss = dk_ss;
  a.dv_sb = dv_sb;
  a.dv_sh = dv_sh;
  a.dv_ss = dv_ss;
  a.mask_sb = mask_sb;
  a.causal = causal;
  a.q_start = q_start;
  a.scale = scale;
  a.window = window;
  a.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_bwd_d(D, DV, a, st);
  if (dtype == kBFloat16) return launch_tc_bwd(D, DV, a, st);  // attention_tc.cu
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* llmq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
