// Gated delta rule (GatedDeltaNet) kernels for Hopper.
//
// Replaces two TPU kernels of llm_quest_tpu/kernels/gdn_pallas.py:
//   llmq_gdn_prefill           <- gated_delta_rule_pallas (forward; the chunked
//                                 _gdn_chunk_kernel with its state in VMEM)
//   llmq_gdn_step_stacked      <- gated_delta_rule_step_stacked_pallas (the
//                                 in-place one-token step on the stacked
//                                 (L, b, h, dv, dk) decode state)
//
// Math, per (batch, head), with S the fp32 (dv, dk) state:
//   S' = a*S + b*(v - a*S k) k^T,    o = S' (q * dk^-1/2)
// Row i of S updates independently of every other row:
//   S'[i,:] = a*S[i,:] + d_i k,  d_i = b*(v_i - a*S[i,:].k)
//   o_i     = (a*S[i,:].q + d_i*(k.q)) * dk^-1/2
// so one warp owns one state row in registers (dk = 128: four fp32 per lane)
// for the whole call, and the three dot products of a token are three
// interleaved warp butterflies. The prefill walks the tokens in order (the
// exact scan, any s >= 1), staging CHUNK tokens of q and k in shared memory
// for the block's ROWS warps. Padding needs no special case: beta = 0,
// alpha = 1 is a no-op step. The Newton-Schulz inverse of the TPU kernel is a
// workaround for the TPU's slow triangular solve and has no counterpart here.
//
// Bound: the prefill is latency-bound on the sequential token loop (two
// shuffle trees per token); the decode step is bound by reading and writing
// the fp32 state once (64 KB per (b, h) at dv = dk = 128), which is the
// minimum traffic: the state stays in registers between read and write.
#include "common.cuh"

namespace llmq {
namespace {

constexpr int kDK = 128;             // q/k head dim the kernels are built for
constexpr int kPerLane = kDK / 32;   // state elements each lane holds
constexpr int kRows = 8;             // warps (= state rows) per block
constexpr int kChunk = 32;           // prefill tokens staged in shared memory

// One token for one state row. st: this lane's slice of the row (updated in
// place); kv/qv: this lane's slice of k and q. Returns o_i (all lanes).
__device__ __forceinline__ float row_step(float (&st)[kPerLane], const float (&kv)[kPerLane],
                                          const float (&qv)[kPerLane], float alpha, float beta,
                                          float v, float scale) {
  float sk = 0.f, sq = 0.f, kq = 0.f;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    sk += st[e] * kv[e];
    sq += st[e] * qv[e];
    kq += kv[e] * qv[e];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sk += __shfl_xor_sync(kFullMask, sk, off);
    sq += __shfl_xor_sync(kFullMask, sq, off);
    kq += __shfl_xor_sync(kFullMask, kq, off);
  }
  const float delta = beta * (v - alpha * sk);
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) st[e] = alpha * st[e] + delta * kv[e];
  return (alpha * sq + delta * kq) * scale;
}

__device__ __forceinline__ void load_row(float (&st)[kPerLane], const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  st[0] = x.x; st[1] = x.y; st[2] = x.z; st[3] = x.w;
}

__device__ __forceinline__ void store_row(float* p, const float (&st)[kPerLane]) {
  *reinterpret_cast<float4*>(p) = make_float4(st[0], st[1], st[2], st[3]);
}

// grid (dv / kRows, b*h), block kRows warps.
// q/k: (b, h, s, dk) and v: (b, h, s, dv) by strides (last dim contiguous);
// beta/alpha: (b, h, s) fp32 contiguous; s0 (nullable) and s_out:
// (b, h, dv, dk) fp32 contiguous; out: (b, h, s, dv) contiguous.
template <typename T>
__global__ void __launch_bounds__(kRows * 32)
gdn_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ beta, const float* __restrict__ alpha,
                   const float* __restrict__ s0, float* __restrict__ s_out, T* __restrict__ out,
                   int H, int S, int DV, long long q_sb, long long q_sh, long long q_ss,
                   long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                   long long v_ss, float scale) {
  __shared__ __align__(16) float q_s[kChunk][kDK];
  __shared__ __align__(16) float k_s[kChunk][kDK];
  __shared__ float v_s[kChunk][kRows];
  __shared__ float a_s[kChunk];
  __shared__ float b_s[kChunk];

  const int bh = blockIdx.y;
  const int bi = bh / H, hi = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  const int row = row0 + warp;
  const size_t st_off = ((size_t)bh * DV + row) * kDK + lane * kPerLane;

  float st[kPerLane];
  if (s0 != nullptr) {
    load_row(st, s0 + st_off);
  } else {
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) st[e] = 0.f;
  }

  const T* qb = q + bi * q_sb + hi * q_sh;
  const T* kb = k + bi * k_sb + hi * k_sh;
  const T* vb = v + bi * v_sb + hi * v_sh;
  const float* beta_b = beta + (size_t)bh * S;
  const float* alpha_b = alpha + (size_t)bh * S;
  T* ob = out + (size_t)bh * S * DV;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();  // every warp is done with the previous chunk
    for (int i = threadIdx.x; i < n * kDK; i += blockDim.x) {
      const int t = i / kDK, d = i % kDK;
      q_s[t][d] = to_f(qb[(t0 + t) * q_ss + d]);
      k_s[t][d] = to_f(kb[(t0 + t) * k_ss + d]);
    }
    for (int i = threadIdx.x; i < n * kRows; i += blockDim.x) {
      const int t = i / kRows, r = i % kRows;
      v_s[t][r] = to_f(vb[(t0 + t) * v_ss + row0 + r]);
    }
    if (threadIdx.x < n) {
      a_s[threadIdx.x] = alpha_b[t0 + threadIdx.x];
      b_s[threadIdx.x] = beta_b[t0 + threadIdx.x];
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      float kv[kPerLane], qv[kPerLane];
      load_row(kv, &k_s[t][lane * kPerLane]);
      load_row(qv, &q_s[t][lane * kPerLane]);
      const float o = row_step(st, kv, qv, a_s[t], b_s[t], v_s[t][warp], scale);
      if (lane == 0) ob[(size_t)(t0 + t) * DV + row] = from_f<T>(o);
    }
  }
  store_row(s_out + st_off, st);
}

// grid (dv / kRows, b*h), block kRows warps. Updates layer `layer` of the
// stacked (L, b, h, dv, dk) fp32 state in place; every other layer is never
// read or written. q/k: (b, h, dk), v: (b, h, dv) by strides; beta/alpha:
// (b, h) fp32 contiguous; out: (b, h, dv) contiguous.
template <typename T>
__global__ void __launch_bounds__(kRows * 32)
gdn_step_stacked_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ beta, const float* __restrict__ alpha,
                        float* __restrict__ stacked, int layer, T* __restrict__ out, int B, int H,
                        int DV, long long q_sb, long long q_sh, long long k_sb, long long k_sh,
                        long long v_sb, long long v_sh, float scale) {
  const int bh = blockIdx.y;
  const int bi = bh / H, hi = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRows + warp;
  float* st_ptr = stacked + (((size_t)layer * B * H + bh) * DV + row) * kDK + lane * kPerLane;

  const T* qb = q + bi * q_sb + hi * q_sh + lane * kPerLane;
  const T* kb = k + bi * k_sb + hi * k_sh + lane * kPerLane;
  float st[kPerLane], kv[kPerLane], qv[kPerLane];
  load_row(st, st_ptr);
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    kv[e] = to_f(kb[e]);
    qv[e] = to_f(qb[e]);
  }
  const float vi = to_f(v[bi * v_sb + hi * v_sh + row]);
  const float o = row_step(st, kv, qv, alpha[bh], beta[bh], vi, scale);
  store_row(st_ptr, st);
  if (lane == 0) out[(size_t)bh * DV + row] = from_f<T>(o);
}

bool shape_ok(int DK, int DV) { return DK == kDK && DV > 0 && DV % kRows == 0; }

}  // namespace
}  // namespace llmq

using namespace llmq;

extern "C" int llmq_gdn_prefill(int dtype, const void* q, const void* k, const void* v,
                                const float* beta, const float* alpha, const float* s0,
                                float* s_out, void* out, int B, int H, int S, int DK, int DV,
                                long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                                long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                                long long v_ss, float scale, void* stream) {
  if (!shape_ok(DK, DV) || S < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(DV / kRows, B * H), block(kRows * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    gdn_prefill_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        beta, alpha, s0, s_out, static_cast<float*>(out), H, S, DV, q_sb, q_sh, q_ss, k_sb, k_sh,
        k_ss, v_sb, v_sh, v_ss, scale);
  } else if (dtype == kBFloat16) {
    gdn_prefill_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), beta, alpha, s0, s_out,
        static_cast<__nv_bfloat16*>(out), H, S, DV, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
        v_sh, v_ss, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int llmq_gdn_step_stacked(int dtype, const void* q, const void* k, const void* v,
                                     const float* beta, const float* alpha, float* stacked,
                                     int layer, void* out, int B, int H, int DK, int DV,
                                     long long q_sb, long long q_sh, long long k_sb,
                                     long long k_sh, long long v_sb, long long v_sh, float scale,
                                     void* stream) {
  if (!shape_ok(DK, DV)) return (int)cudaErrorInvalidValue;
  const dim3 grid(DV / kRows, B * H), block(kRows * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    gdn_step_stacked_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        beta, alpha, stacked, layer, static_cast<float*>(out), B, H, DV, q_sb, q_sh, k_sb, k_sh,
        v_sb, v_sh, scale);
  } else if (dtype == kBFloat16) {
    gdn_step_stacked_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), beta, alpha, stacked, layer,
        static_cast<__nv_bfloat16*>(out), B, H, DV, q_sb, q_sh, k_sb, k_sh, v_sb, v_sh, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
