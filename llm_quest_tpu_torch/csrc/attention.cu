// Blockwise online-softmax attention forward for Hopper.
//
// Replaces two TPU kernels:
//   llm_quest_tpu/kernels/flash_attention.py::flash_attention (forward, _fwd /
//     _fwd_kernel): causal masking with a static query offset q_start (query
//     row i sits at absolute position q_start + i; key j is visible iff
//     j <= q_start + i), a (b, sk) key-validity mask (nonzero = real key) and
//     GQA (q head h reads kv head h / (hq / hkv)). Qwen3.5 text: hq 8, hkv 2,
//     d 256.
//   llm_quest_tpu/kernels/fused_mha.py::packed_mha (_packed_mha_kernel):
//     bidirectional maskless attention read straight from the packed
//     (b, s, h*d) projection outputs. Qwen3.5 vision: 12 heads x 64, s 576.
// Both are one kernel: every operand is addressed by (batch, head, seq)
// strides with a contiguous last dim, so the packed layout needs no
// transposes and the GQA head map is a division.
//
// Design: one block of 128 threads owns BQ = 16 query rows of one
// (batch, q-head); eight threads share a row. The block walks the key blocks
// of BK = 32 in order, stages K and V in shared memory as fp32, computes its
// 16 x 32 score tile, and keeps the running max, sum and the (16, d) fp32
// output accumulator (d / 8 values per thread, in registers) of the online
// softmax. Causal blocks past the diagonal of the block's last row are never
// loaded. Masked scores are finfo(float32).min / 2, as in the JAX package, so
// a row with no visible key averages the keys it visited instead of NaN;
// keys past sk contribute nothing.
//
// Bound: this first version runs the products on the fp32 SIMT units, not
// the tensor cores, so it is bound by shared-memory bandwidth of the score
// and PV loops. The tensor-core (wgmma) form is later work. At d = 256 the
// staged tiles take 84 KB, above the 48 KB default, so the launch raises the
// kernel's dynamic shared-memory limit first.
#include "common.cuh"

namespace llmq {
namespace {

constexpr int kBQ = 16;       // query rows per block
constexpr int kBK = 32;       // keys per staged tile
constexpr int kThreads = 128;
constexpr int kTPR = kThreads / kBQ;  // threads per query row (8, within one warp)
constexpr int kPS = kBK + 1;          // padded row stride of the probability tile
constexpr float kMasked = -1.7014117331926443e38f;  // finfo(float32).min / 2

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * kPS);
}

// grid (ceil(sq / kBQ), b*hq), block kThreads, dynamic smem smem_bytes<D>().
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, const uint8_t* __restrict__ key_mask, int HQ, int HKV,
                     int SQ, int SK, long long q_sb, long long q_sh, long long q_ss,
                     long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                     long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                     long long o_ss, long long mask_sb, int causal, int q_start, float scale) {
  constexpr int DP = D + 1;      // padded stride: the 8 keys a row reads hit 8 banks
  constexpr int NC = D / kTPR;   // output columns per thread
  constexpr int NS = kBK / kTPR; // scores per thread per tile
  extern __shared__ float smem[];
  float* q_s = smem;              // kBQ x DP, pre-scaled
  float* k_s = q_s + kBQ * DP;    // kBK x DP
  float* v_s = k_s + kBK * DP;    // kBK x D
  float* p_s = v_s + kBK * D;     // kBQ x kPS

  const int bh = blockIdx.y;
  const int bi = bh / HQ, hq = bh % HQ;
  const int hk = hq / (HQ / HKV);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int r = tid / kTPR, c = tid % kTPR;

  const T* qb = q + bi * q_sb + hq * q_sh;
  const T* kb = k + bi * k_sb + hk * k_sh;
  const T* vb = v + bi * v_sb + hk * v_sh;
  const uint8_t* mb = key_mask != nullptr ? key_mask + bi * mask_sb : nullptr;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    q_s[rr * DP + d] = q0 + rr < SQ ? to_f(qb[(q0 + rr) * q_ss + d]) * scale : 0.f;
  }

  const int q_last = min(q0 + kBQ, SQ) - 1;
  const int k_end = causal ? min(SK, q_start + q_last + 1) : SK;
  const int qpos = q_start + q0 + r;

  float acc[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) acc[n] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q_s is staged)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D;
      const bool ok = k0 + j < SK;
      k_s[j * DP + d] = ok ? to_f(kb[(k0 + j) * k_ss + d]) : 0.f;
      v_s[j * D + d] = ok ? to_f(vb[(k0 + j) * v_ss + d]) : 0.f;
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
      if (kpos >= SK) {
        s[jj] = -INFINITY;
      } else if ((causal && kpos > qpos) || (mb != nullptr && mb[kpos] == 0)) {
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
      for (int n = 0; n < NC; ++n) acc[n] += p * v_s[j * D + c + kTPR * n];
    }
  }

  if (q0 + r < SQ) {
    T* orow = o + bi * o_sb + hq * o_sh + (q0 + r) * o_ss;
    const float inv = 1.f / l;
#pragma unroll
    for (int n = 0; n < NC; ++n) orow[c + kTPR * n] = from_f<T>(acc[n] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, const uint8_t* key_mask, int B,
           int HQ, int HKV, int SQ, int SK, long long q_sb, long long q_sh, long long q_ss,
           long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
           long long v_ss, long long o_sb, long long o_sh, long long o_ss, long long mask_sb,
           int causal, int q_start, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = attention_fwd_kernel<T, D>;
  // above 48 KB the launch is refused unless the kernel's limit is raised
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((SQ + kBQ - 1) / kBQ, B * HQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), key_mask, HQ, HKV, SQ, SK, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
      v_ss, o_sb, o_sh, o_ss, mask_sb, causal, q_start, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o, const uint8_t* key_mask,
             int B, int HQ, int HKV, int SQ, int SK, long long q_sb, long long q_sh,
             long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
             long long v_sh, long long v_ss, long long o_sb, long long o_sh, long long o_ss,
             long long mask_sb, int causal, int q_start, float scale, cudaStream_t stream) {
#define LLMQ_ATTN_CASE(DIM)                                                                      \
  case DIM:                                                                                      \
    return launch<T, DIM>(q, k, v, o, key_mask, B, HQ, HKV, SQ, SK, q_sb, q_sh, q_ss, k_sb, k_sh, \
                          k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, mask_sb, causal, q_start,     \
                          scale, stream);
  switch (D) {
    LLMQ_ATTN_CASE(64)
    LLMQ_ATTN_CASE(128)
    LLMQ_ATTN_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LLMQ_ATTN_CASE
}

}  // namespace
}  // namespace llmq

using namespace llmq;

extern "C" int llmq_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                                  const void* key_mask, int B, int HQ, int HKV, int SQ, int SK,
                                  int D, long long q_sb, long long q_sh, long long q_ss,
                                  long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                                  long long v_sh, long long v_ss, long long o_sb, long long o_sh,
                                  long long o_ss, long long mask_sb, int causal, int q_start,
                                  float scale, void* stream) {
  if (HKV <= 0 || HQ % HKV != 0 || SQ <= 0 || SK <= 0) return (int)cudaErrorInvalidValue;
  const uint8_t* mask = static_cast<const uint8_t*>(key_mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_d<float>(D, q, k, v, o, mask, B, HQ, HKV, SQ, SK, q_sb, q_sh, q_ss, k_sb, k_sh,
                           k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, mask_sb, causal, q_start,
                           scale, st);
  }
  if (dtype == kBFloat16) {
    return launch_d<__nv_bfloat16>(D, q, k, v, o, mask, B, HQ, HKV, SQ, SK, q_sb, q_sh, q_ss,
                                   k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, mask_sb,
                                   causal, q_start, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* llmq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
