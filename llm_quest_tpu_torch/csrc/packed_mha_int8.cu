// Int8-score packed multi-head attention: the C entry point, and the kernel
// for fp32 inputs on the SIMT units (bf16 inputs take the tensor-core kernel
// of packed_mha_int8_tc.cu).
//
// Replaces these TPU kernels:
//   llm_quest_tpu/kernels/fused_mha.py::packed_mha_int8 (_packed_mha_int8_kernel,
//     with _quantize_sym outside it): bidirectional maskless attention on the
//     packed (b, s, h*d) projection outputs, with q and k quantized to int8 per
//     tensor: dynamic scales (s = max|x| / 127 + 1e-12, x / s) or calibrated
//     static ones (x * (1 / s)); round half to even, clip to [-127, 127].
//     The kernel takes int32 dot products of the int8 rows, scales them by
//     dq = q_s * k_s * scale in fp32, runs the fp32 softmax in two passes
//     (the true row max over the whole row, then exp and the fp32 sum), casts
//     p to v's type for p.V (fp32 accumulation) and divides by the fp32 sum.
//     ViT-B/224: b 128, s 197, 12 heads x 64.
//   llm_quest_tpu/kernels/fused_mha.py::packed_mha_int8_inkernel
//     (_packed_mha_int8_ik_kernel): the same with static scales, q and k read
//     in their own type and quantized inside the kernel.
// JAX quantizes K8's q and k outside its kernel; both kernels here quantize
// them inside, in all three modes, so K8 with static scales and K9 are one
// call and agree bit for bit. The wrapper only reduces the dynamic scales.
//
// Design (fp32): one block of 256 threads owns 32 query rows of one (image,
// head); eight threads of one warp share a row. The block quantizes its 32 q
// rows once, packed four to an int32 word, and keeps each thread's row in
// registers. Pass 1 walks the keys in tiles of 64, quantized into shared
// memory as packed int8 words, and writes each scaled score of the block's
// rows into a (32, s) fp32 tile in shared memory: __dp4a gives the exact
// int32 dot product four lanes at a time. Pass 2 takes each row's true max,
// then exp and the fp32 sum, and leaves p in the tile. Pass 3 walks V in
// tiles of 32 keys and accumulates p.V in registers (d / 8 columns a thread,
// as float4). No online rescale: the whole row is held, as the TPU kernel
// holds its whole (s, s) tile. The loops stop at s, so no padded key enters
// a row (the TPU kernel pads s to 16 and masks the pad). The products that
// must round as JAX's do (the score scaling, the shift by the max, the
// quantization and the final division) use the _rn intrinsics.
//
// Bound: both products run on the SIMT units (dp4a for the scores, fp32 FMA
// for p.V); the fp32 p.V loop and its shared-memory reads bound the kernel.
// Only the fp32 checks run it; the bf16 paths run the tensor-core kernel.
#include "packed_mha_int8.cuh"

namespace llmq {
namespace {

constexpr int kRows = 32;                 // query rows per block
constexpr int kThreadsI8 = 256;
constexpr int kTPRI8 = kThreadsI8 / kRows;  // threads per row (8, within one warp)
constexpr int kKeyTile = 64;              // keys per staged int8 K tile
constexpr int kValTile = 32;              // keys per staged V tile

// JAX's clip(round(x * (1 / s)), -127, 127) and clip(round(x / s), ...):
// __float2int_rn rounds half to even, as jnp.round does; the _rn intrinsics
// keep the compiler from contracting or approximating the product and the
// quotient.
__device__ __forceinline__ int quant_mul(float x, float inv) {
  return max(-127, min(127, __float2int_rn(__fmul_rn(x, inv))));
}
__device__ __forceinline__ int quant_div(float x, float s) {
  return max(-127, min(127, __float2int_rn(__fdiv_rn(x, s))));
}

// four int8 values, the first in the low byte
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

// four fp32 values of one row, quantized and packed into a word
__device__ __forceinline__ uint32_t load_word(const float* x, bool div, float s) {
  return div ? pack4(quant_div(x[0], s), quant_div(x[1], s), quant_div(x[2], s), quant_div(x[3], s))
             : pack4(quant_mul(x[0], s), quant_mul(x[1], s), quant_mul(x[2], s), quant_mul(x[3], s));
}

// Row stride of the score tile: s rounded up to 32, plus 8, so the four rows
// a warp touches fall in four different groups of eight banks.
__host__ __device__ __forceinline__ int score_stride(int S) { return (S + 31) / 32 * 32 + 8; }

template <int D>
size_t smem_bytes_i8(int S) {
  constexpr int WP = D / 4 + 1;
  return sizeof(float) * ((size_t)kRows * score_stride(S) + kValTile * D) + sizeof(int) * (kRows + kKeyTile) * WP;
}

// grid (ceil(S / kRows), B * H), block kThreadsI8, dynamic smem smem_bytes_i8<D>(S).
template <int D>
__global__ void __launch_bounds__(kThreadsI8) packed_mha_int8_kernel(const Int8Args a) {
  constexpr int W = D / 4;                     // packed words of an int8 row
  constexpr int WP = W + 1;                    // padded word stride
  constexpr int NS = kKeyTile / kTPRI8;        // scores per thread per K tile
  constexpr int NC4 = D / (4 * kTPRI8);        // float4 output columns per thread
  const int S = a.S;
  const int SP = score_stride(S);
  extern __shared__ float smem[];
  float* p_s = smem;                           // kRows x SP: scores, then p
  float* v_s = p_s + kRows * SP;               // kValTile x D
  int* q_s = reinterpret_cast<int*>(v_s + kValTile * D);  // kRows x WP
  int* k_s = q_s + kRows * WP;                 // kKeyTile x WP

  const int bh = blockIdx.y;
  const int bi = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int r = tid / kTPRI8, c = tid % kTPRI8;
  const float* q = static_cast<const float*>(a.q) + bi * a.q_sb + h * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + bi * a.k_sb + h * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + bi * a.v_sb + h * a.v_sh;
  const bool div = a.dyn_scales != nullptr;
  // JAX's dynamic form: x / s, and qs * ks * scale in fp32, in that order
  const float sq = div ? a.dyn_scales[0] : a.inv_q, sk = div ? a.dyn_scales[1] : a.inv_k;
  const float dq = div ? __fmul_rn(__fmul_rn(sq, sk), a.scale) : a.dq_static;

  for (int i = tid; i < kRows * W; i += kThreadsI8) {
    const int rr = i / W, w = i % W;
    q_s[rr * WP + w] = q0 + rr < S ? load_word(q + (q0 + rr) * a.q_ss + 4 * w, div, sq) : 0;
  }
  __syncthreads();
  int qw[W];
#pragma unroll
  for (int w = 0; w < W; ++w) qw[w] = q_s[r * WP + w];

  // pass 1: the scaled int8 scores of the block's rows against every key
  for (int k0 = 0; k0 < S; k0 += kKeyTile) {
    __syncthreads();  // the previous K tile is consumed
    for (int i = tid; i < kKeyTile * W; i += kThreadsI8) {
      const int j = i / W, w = i % W;
      k_s[j * WP + w] = k0 + j < S ? load_word(k + (k0 + j) * a.k_ss + 4 * w, div, sk) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      const int j = c + kTPRI8 * jj;
      int acc = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) acc = __dp4a(qw[w], k_s[j * WP + w], acc);
      if (k0 + j < S) p_s[r * SP + k0 + j] = __fmul_rn((float)acc, dq);
    }
  }
  __syncwarp();  // a row's scores were written by its own eight threads

  // pass 2: the row's true max, then exp and the fp32 denominator
  float* prow = p_s + r * SP;
  float m = -INFINITY;
  for (int j = c; j < S; j += kTPRI8) m = fmaxf(m, prow[j]);
#pragma unroll
  for (int off = kTPRI8 / 2; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFullMask, m, off));
  float den = 0.f;
  for (int j = c; j < S; j += kTPRI8) {
    const float p = expf(__fsub_rn(prow[j], m));
    den += p;
    prow[j] = p;
  }
#pragma unroll
  for (int off = kTPRI8 / 2; off > 0; off >>= 1) den += __shfl_xor_sync(kFullMask, den, off);

  // pass 3: p.V over V tiles, fp32 accumulation
  float4 acc[NC4];
#pragma unroll
  for (int n = 0; n < NC4; ++n) acc[n] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < S; j0 += kValTile) {
    __syncthreads();  // the previous V tile is consumed
    for (int i = tid; i < kValTile * D; i += kThreadsI8) {
      const int j = i / D, dd = i % D;
      v_s[j * D + dd] = j0 + j < S ? v[(j0 + j) * a.v_ss + dd] : 0.f;
    }
    __syncthreads();
    const int jn = min(kValTile, S - j0);
    for (int j = 0; j < jn; ++j) {
      const float p = prow[j0 + j];
      const float4* vrow = reinterpret_cast<const float4*>(v_s + j * D);
#pragma unroll
      for (int n = 0; n < NC4; ++n) {
        const float4 vv = vrow[c + kTPRI8 * n];
        acc[n].x += p * vv.x;
        acc[n].y += p * vv.y;
        acc[n].z += p * vv.z;
        acc[n].w += p * vv.w;
      }
    }
  }
  if (q0 + r < S) {
    float* orow = row_at<float>(a.o, a.o_sb, a.o_sh, a.o_ss, bi, h, q0 + r);
#pragma unroll
    for (int n = 0; n < NC4; ++n) {
      const int col = 4 * (c + kTPRI8 * n);
      orow[col] = __fdiv_rn(acc[n].x, den);
      orow[col + 1] = __fdiv_rn(acc[n].y, den);
      orow[col + 2] = __fdiv_rn(acc[n].z, den);
      orow[col + 3] = __fdiv_rn(acc[n].w, den);
    }
  }
}

template <int D>
int launch_i8(const Int8Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes_i8<D>(a.S);
  auto kernel = packed_mha_int8_kernel<D>;
  // above 48 KB the launch is refused unless the kernel's limit is raised
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + kRows - 1) / kRows, a.B * a.H);
  kernel<<<grid, kThreadsI8, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace llmq

using namespace llmq;

// K8 and K9: q, k, v of one type (fp32 or bf16), read and o written at the
// (batch, head, seq) strides given (a contiguous last dim); q and k are
// quantized in the kernel by x / dyn_scales[0|1] (dynamic K8; dyn_scales a
// device pointer to (q_s, k_s) fp32) or, when dyn_scales is null, by
// x * inv_q|inv_k with dq_static = q_s * k_s * scale (static K8, and K9).
// fp32 runs the SIMT kernel above, bf16 the tensor-core kernel.
extern "C" int llmq_packed_mha_int8(int dtype, const void* q, const void* k, const void* v, void* o,
                                    const void* dyn_scales, float dq_static, float inv_q, float inv_k, float scale,
                                    int B, int S, int H, int D, long long q_sb, long long q_sh, long long q_ss,
                                    long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                                    long long v_ss, long long o_sb, long long o_sh, long long o_ss, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const Int8Args a{q,    k,    v,    o,    static_cast<const float*>(dyn_scales), dq_static, inv_q, inv_k, scale,
                   B,    H,    S,    q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch_int8_tc(D, a, st);
  if (dtype != kFloat32) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return launch_i8<32>(a, st);
    case 64:
      return launch_i8<64>(a, st);
    case 128:
      return launch_i8<128>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
