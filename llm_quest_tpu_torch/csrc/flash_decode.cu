// Flash-decode over an int8 KV cache, for Hopper: the C entry point, and
// the kernel for fp32 q on the SIMT units. bf16 q takes the tensor-core
// kernel of flash_decode_tc.cu.
//
// Replaces llm_quest_tpu/kernels/flash_decode.py::flash_decode (the Pallas
// kernel _kernel): one decode step of attention, q (b, hq, 1, d) against
// k_q/v_q (b, hkv, S, d) int8 with per-(position, head) fp32 scales k_s/v_s
// (b, hkv, S) and an additive fp32 bias (b, S) (0 valid, finfo.min/2 masked).
// The dequantization is reassociated as in the TPU kernel and never written
// out: s_j = (q . k_q_j) * (k_s_j * scale) + bias_j, out = sum_j (p_j v_s_j) v_q_j
// / sum_j p_j, with p_j v_s_j rounded to q's type before the value sum.
//
// Grid: the TPU kernel walks the key blocks of one (batch, kv head) in order,
// carrying the running max, sum and output in scratch. Blocks here run in no
// order, and at b = 1 one block per (batch, kv head) would fill 2 of the 132
// SMs, so the keys are split (flash decoding): grid (b*hkv, n_splits), each
// block owning a contiguous key range, its q-head group (g = hq / hkv rows,
// loaded once) and its own online softmax. It stages tiles of kTK keys of K
// and V in shared memory with 16-byte loads (rows padded by 16 bytes, so the
// per-key reads are free of bank conflicts), writes the unnormalised (g, d)
// output and its (max, sum) per split, and a second kernel combines the splits
// in a fixed order: no atomics, so two runs give the same bits. The ragged
// tail of the last tile is masked here (scores -inf, zero rows), where the
// TPU wrapper pads S to block_k.
//
// Bound: bytes. Each step must read 2*b*hkv*S*d bytes of int8 K/V, 8*b*hkv*S
// of scales and 4*b*S of bias; the score and value products are 4*b*hq*S*d
// FLOPs, far below the card's rate for those bytes. fp32 q multiplies on the
// fp32 SIMT units with no copy/compute overlap inside a block; the splits
// give the card enough blocks in flight.
#include "flash_decode.cuh"

namespace llmq {
namespace {

constexpr int kDecThreads = 128;  // 4 warps
constexpr int kTK = 64;           // keys per staged tile
constexpr int kMaxGroup = 8;      // most q heads per kv head
constexpr int kRowPad = 16;       // bytes of padding per staged int8 row

// grid (b*hkv, n_splits), block kDecThreads. part_acc: (b*hkv, n_splits, G, D)
// fp32, the split's unnormalised output; part_ml: (b*hkv, n_splits, G, 2)
// fp32, its running max and sum.
template <typename T, int D>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_split_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                          const float* __restrict__ ks, const int8_t* __restrict__ vq,
                          const float* __restrict__ vs, const float* __restrict__ bias,
                          float* __restrict__ part_acc, float* __restrict__ part_ml, int HKV, int G,
                          int S, int split_len, long long q_sb, long long q_sh, long long k_sb,
                          long long k_sh, long long k_ss, long long ks_sb, long long ks_sh,
                          long long v_sb, long long v_sh, long long v_ss, long long vs_sb,
                          long long vs_sh, long long bias_sb, float scale) {
  constexpr int kRow = D + kRowPad;
  constexpr int kChunks = D / 16;        // 16-byte chunks per key row
  constexpr int NC = D / kDecThreads;    // output columns per thread
  constexpr int kHalf = kMaxGroup / 2;   // heads per thread in the score loop
  __shared__ __align__(16) int8_t k_t[kTK * kRow];
  __shared__ __align__(16) int8_t v_t[kTK * kRow];
  __shared__ __align__(16) float q_s[kMaxGroup][D];
  __shared__ float sc[kMaxGroup][kTK];
  __shared__ float pv[kMaxGroup][kTK];
  __shared__ float alpha_s[kMaxGroup];

  const int bh = blockIdx.x, split = blockIdx.y, n_splits = gridDim.y;
  const int bi = bh / HKV, hk = bh % HKV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int key0 = split * split_len;
  const int key1 = min(S, key0 + split_len);

  for (int i = tid; i < G * D; i += kDecThreads) {
    const int h = i / D, c = i % D;
    q_s[h][c] = to_f(q[bi * q_sb + (long long)(hk * G + h) * q_sh + c]);
  }
  const int8_t* kb = kq + bi * k_sb + hk * k_sh;
  const int8_t* vb = vq + bi * v_sb + hk * v_sh;
  const float* ksb = ks + bi * ks_sb + hk * ks_sh;
  const float* vsb = vs + bi * vs_sb + hk * vs_sh;
  const float* biasb = bias + bi * bias_sb;

  // warp w keeps the softmax state of heads w and w + 4 (warp-uniform)
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[kMaxGroup][NC];
#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[h][c] = 0.f;

  for (int t0 = key0; t0 < key1; t0 += kTK) {
    const int n = min(kTK, key1 - t0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kTK * kChunks; i += kDecThreads) {
      const int j = i / kChunks, c = (i % kChunks) * 16;
      int4 kv4 = make_int4(0, 0, 0, 0), vv4 = make_int4(0, 0, 0, 0);
      if (j < n) {
        kv4 = *reinterpret_cast<const int4*>(kb + (t0 + j) * k_ss + c);
        vv4 = *reinterpret_cast<const int4*>(vb + (t0 + j) * v_ss + c);
      }
      *reinterpret_cast<int4*>(k_t + j * kRow + c) = kv4;
      *reinterpret_cast<int4*>(v_t + j * kRow + c) = vv4;
    }
    __syncthreads();

    // scores: thread -> key j, heads h0, h0 + 2, ... (warp-uniform h0)
    {
      const int j = tid % kTK, h0 = tid / kTK;
      float dot[kHalf];
#pragma unroll
      for (int r = 0; r < kHalf; ++r) dot[r] = 0.f;
      for (int c = 0; c < D; c += 16) {
        const int4 raw = *reinterpret_cast<const int4*>(k_t + j * kRow + c);
        const int8_t* e8 = reinterpret_cast<const int8_t*>(&raw);
        float kf[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) kf[e] = (float)e8[e];
#pragma unroll
        for (int r = 0; r < kHalf; ++r) {
          const int h = h0 + 2 * r;
          if (h < G) {
#pragma unroll
            for (int e = 0; e < 16; ++e) dot[r] += q_s[h][c + e] * kf[e];
          }
        }
      }
      const bool real = j < n;
      const float kscale = real ? ksb[t0 + j] * scale : 0.f;
      const float bj = real ? biasb[t0 + j] : 0.f;
#pragma unroll
      for (int r = 0; r < kHalf; ++r) {
        const int h = h0 + 2 * r;
        if (h < G) sc[h][j] = real ? dot[r] * kscale + bj : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax over the tile, one warp per head
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int h = warp + 4 * r;
      if (h < G) {
        const float s0 = sc[h][lane], s1 = sc[h][lane + 32];
        float tmax = fmaxf(s0, s1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(kFullMask, tmax, off));
        const float m_new = fmaxf(m_run[r], tmax);
        const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
        float psum = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(kFullMask, psum, off);
        const float a = expf(m_run[r] - m_new);  // 0 on the first tile
        l_run[r] = l_run[r] * a + psum;
        m_run[r] = m_new;
        const float vs0 = lane < n ? vsb[t0 + lane] : 0.f;
        const float vs1 = lane + 32 < n ? vsb[t0 + lane + 32] : 0.f;
        pv[h][lane] = to_f(from_f<T>(p0 * vs0));  // v scales fold into p, rounded as the TPU kernel does
        pv[h][lane + 32] = to_f(from_f<T>(p1 * vs1));
        if (lane == 0) alpha_s[h] = a;
      }
    }
    __syncthreads();

    // value sum: thread -> columns tid + 128 * c, every head
#pragma unroll
    for (int h = 0; h < kMaxGroup; ++h) {
      if (h < G) {
        const float a = alpha_s[h];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[h][c] *= a;
      }
    }
    for (int j = 0; j < n; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = (float)v_t[j * kRow + tid + kDecThreads * c];
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h) {
        if (h < G) {
          const float p = pv[h][j];
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[h][c] += p * vv[c];
        }
      }
    }
  }

  const size_t part = (size_t)bh * n_splits + split;
#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h) {
    if (h < G) {
#pragma unroll
      for (int c = 0; c < NC; ++c) part_acc[(part * G + h) * D + tid + kDecThreads * c] = acc[h][c];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int h = warp + 4 * r;
    if (h < G && lane == 0) {
      part_ml[(part * G + h) * 2] = m_run[r];
      part_ml[(part * G + h) * 2 + 1] = l_run[r];
    }
  }
}

// grid (b*hkv, G), block kDecThreads: combines the splits of one q head in
// split order and writes out (b, hq, 1, D) contiguous.
template <typename T, int D>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                            T* __restrict__ out, int G, int n_splits) {
  constexpr int NC = D / kDecThreads;
  const int bh = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const size_t base = (size_t)bh * n_splits;
  float m = -INFINITY;
  for (int s = 0; s < n_splits; ++s) m = fmaxf(m, part_ml[((base + s) * G + h) * 2]);
  float l = 0.f, acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const size_t row = (base + s) * G + h;
    const float w = expf(part_ml[row * 2] - m);
    l += w * part_ml[row * 2 + 1];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] += w * part_acc[row * D + tid + kDecThreads * c];
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < NC; ++c) out[((size_t)bh * G + h) * D + tid + kDecThreads * c] = from_f<T>(acc[c] * inv);
}

template <typename T, int D>
int launch_flash_decode(const void* q, const int8_t* kq, const float* ks, const int8_t* vq,
                        const float* vs, const float* bias, float* part_acc, float* part_ml,
                        void* out, int B, int HKV, int G, int S, int n_splits, int split_len,
                        const long long (&st)[13], float scale, cudaStream_t stream) {
  flash_decode_split_kernel<T, D><<<dim3(B * HKV, n_splits), kDecThreads, 0, stream>>>(
      static_cast<const T*>(q), kq, ks, vq, vs, bias, part_acc, part_ml, HKV, G, S, split_len,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12],
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_combine_kernel<T, D><<<dim3(B * HKV, G), kDecThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), G, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace llmq

using namespace llmq;

// q (B, HQ, 1, D) by strides (last dim contiguous); k_q/v_q (B, HKV, S, D)
// int8 by strides, rows 16-byte aligned; k_s/v_s (B, HKV, S) fp32 and bias
// (B, S) fp32 by strides (last dim contiguous); out (B, HQ, 1, D) contiguous.
// D in {128, 256}, HQ = G * HKV with G <= 8. fp32 q (the SIMT kernels): the
// splits cover [0, S) in order, split_len keys each (the last one ragged),
// into part_acc/part_ml scratch. bf16 q (the tensor-core kernel): n_splits
// blocks of a cluster (1 to 16) share each (batch, kv head)'s keys; split_len
// and the scratch are unused (null).
extern "C" int llmq_flash_decode(int dtype, const void* q, const void* k_q, const float* k_s,
                                 const void* v_q, const float* v_s, const float* bias,
                                 float* part_acc, float* part_ml, void* out, int B, int HQ,
                                 int HKV, int S, int D, int n_splits, int split_len,
                                 long long q_sb, long long q_sh, long long k_sb, long long k_sh,
                                 long long k_ss, long long ks_sb, long long ks_sh, long long v_sb,
                                 long long v_sh, long long v_ss, long long vs_sb, long long vs_sh,
                                 long long bias_sb, float scale, void* stream) {
  if (B < 1 || HKV < 1 || HQ % HKV != 0 || HQ / HKV > kMaxGroup || S < 1 || n_splits < 1 ||
      (D != 128 && D != 256)) {
    return (int)cudaErrorInvalidValue;
  }
  const int8_t* kq = static_cast<const int8_t*>(k_q);
  const int8_t* vq = static_cast<const int8_t*>(v_q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    const DecodeArgs a = {q, kq, k_s, vq, v_s, bias, out, B, HQ, HKV, S, D, q_sb, q_sh, k_sb, k_sh, k_ss,
                          ks_sb, ks_sh, v_sb, v_sh, v_ss, vs_sb, vs_sh, bias_sb, scale};
    return launch_flash_decode_tc(a, n_splits, s);
  }
  if (dtype != kFloat32 || split_len < 1 || (long long)n_splits * split_len < S ||
      (long long)(n_splits - 1) * split_len >= S) {
    return (int)cudaErrorInvalidValue;
  }
  const long long st[13] = {q_sb, q_sh, k_sb, k_sh, k_ss, ks_sb, ks_sh, v_sb, v_sh, v_ss, vs_sb, vs_sh, bias_sb};
  const int G = HQ / HKV;
  return D == 128 ? launch_flash_decode<float, 128>(q, kq, k_s, vq, v_s, bias, part_acc, part_ml, out, B, HKV, G, S,
                                                    n_splits, split_len, st, scale, s)
                  : launch_flash_decode<float, 256>(q, kq, k_s, vq, v_s, bias, part_acc, part_ml, out, B, HKV, G, S,
                                                    n_splits, split_len, st, scale, s);
}
