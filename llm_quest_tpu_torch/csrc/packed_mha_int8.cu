// Int8-score packed multi-head attention for Hopper.
//
// Replaces these TPU kernels:
//   llm_quest_tpu/kernels/fused_mha.py::packed_mha_int8 (_packed_mha_int8_kernel,
//     with _quantize_sym outside it): bidirectional maskless attention on the
//     packed (b, s, h*d) projection outputs, with q and k quantized to int8 per
//     tensor before the kernel: dynamic scales (s = max|x| / 127 + 1e-12,
//     x / s) or calibrated static ones (x * (1 / s)); round half to even,
//     clip to [-127, 127]. The kernel takes int32 dot products of the int8
//     rows, scales them by dq = q_s * k_s * scale in fp32, runs the fp32
//     softmax in two passes (the true row max over the whole row, then exp
//     and the fp32 sum), casts p to v's type for p.V (fp32 accumulation) and
//     divides by the fp32 sum. ViT-B/224: b 128, s 197, 12 heads x 64.
//   llm_quest_tpu/kernels/fused_mha.py::packed_mha_int8_inkernel
//     (_packed_mha_int8_ik_kernel): the same with static scales, q and k read
//     in their own type and quantized inside the kernel. One body serves both
//     (kQuantIn), so the two agree bit for bit at the same static scales.
//
// Design: one block of 256 threads owns 32 query rows of one (image, head);
// eight threads of one warp share a row. The block quantizes (K9) or reads
// (K8) its 32 int8 q rows once, packed four to an int32 word, and keeps each
// thread's row in registers. Pass 1 walks the keys in tiles of 64 staged in
// shared memory as packed int8 words and writes each scaled score of the
// block's rows into a (32, s) fp32 tile in shared memory: __dp4a gives the
// exact int32 dot product four lanes at a time. Pass 2 takes each row's true
// max, then exp and the fp32 sum, and leaves p rounded to v's type in the
// tile. Pass 3 walks V in tiles of 32 keys staged as fp32 and accumulates p.V
// in registers (d / 8 columns a thread, as float4). No online rescale: the
// whole row is held, as the TPU kernel holds its whole (s, s) tile, which
// the routing's s <= 512 (fused_mha_max_seq) keeps inside shared memory.
// The loops stop at s, so no padded key enters a row (the TPU kernel pads s
// to 16 and masks the pad). The products that must round as JAX's do (the
// score scaling, the shift by the max, the quantization and the final
// division) use the _rn intrinsics, so the compiler cannot contract them.
//
// Bound: both products run on the SIMT units (dp4a for the scores, fp32 FMA
// for p.V), not the tensor cores; the fp32 p.V loop and its shared-memory
// reads bound the kernel. Tensor-core int8 (mma/wgmma s8) is later work.
// Dynamic quantization is not this kernel's: the wrapper reduces max|x| with
// torch and quantizes with llmq_quantize_int8 below (XLA's work in JAX),
// passing the scales by pointer, so nothing syncs with the host.
#include "common.cuh"

namespace llmq {
namespace {

constexpr int kRows = 32;                 // query rows per block
constexpr int kThreadsI8 = 256;
constexpr int kTPRI8 = kThreadsI8 / kRows;  // threads per row (8, within one warp)
constexpr int kKeyTile = 64;              // keys per staged int8 K tile
constexpr int kValTile = 32;              // keys per staged V tile

// JAX's clip(round(x * (1 / s)), -127, 127) and clip(round(x / s), ...):
// __float2int_rn rounds half to even, as jnp.round does.
__device__ __forceinline__ int quant_mul(float x, float inv) {
  return max(-127, min(127, __float2int_rn(__fmul_rn(x, inv))));
}
__device__ __forceinline__ int quant_div(float x, float s) {
  return max(-127, min(127, __float2int_rn(__fdiv_rn(x, s))));
}

__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | ((d & 0xff) << 24);
}

// Four int8 values of one row, packed into a word: read as they are (K8), or
// quantized here from q/k in their own type with the static scale (K9).
template <typename T, bool kQuantIn>
__device__ __forceinline__ int load_word(const void* src, long long off, float inv) {
  if constexpr (kQuantIn) {
    const T* x = static_cast<const T*>(src) + off;
    return pack4(quant_mul(to_f(x[0]), inv), quant_mul(to_f(x[1]), inv), quant_mul(to_f(x[2]), inv),
                 quant_mul(to_f(x[3]), inv));
  } else {
    return *reinterpret_cast<const int*>(static_cast<const int8_t*>(src) + off);
  }
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
// q/k: int8 (K8) or T (K9), v/o: T, all packed (B, S, H * D) and contiguous.
// dyn_scales: (q_s, k_s) on the device (dynamic K8) or nullptr (static:
// dq_static is q_s * k_s * scale, folded on the host).
template <typename T, int D, bool kQuantIn>
__global__ void __launch_bounds__(kThreadsI8)
packed_mha_int8_kernel(const void* __restrict__ q, const void* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, const float* __restrict__ dyn_scales, float dq_static, float inv_q,
                       float inv_k, float scale, int H, int S) {
  constexpr int W = D / 4;                     // packed words of an int8 row
  constexpr int WP = W + 1;                    // padded word stride
  constexpr int NS = kKeyTile / kTPRI8;        // scores per thread per K tile
  constexpr int NC4 = D / (4 * kTPRI8);        // float4 output columns per thread
  const int SP = score_stride(S);
  extern __shared__ float smem[];
  float* p_s = smem;                           // kRows x SP: scores, then p
  float* v_s = p_s + kRows * SP;               // kValTile x D, fp32
  int* q_s = reinterpret_cast<int*>(v_s + kValTile * D);  // kRows x WP
  int* k_s = q_s + kRows * WP;                 // kKeyTile x WP

  const int bh = blockIdx.y;
  const int bi = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int r = tid / kTPRI8, c = tid % kTPRI8;
  const long long row = (long long)H * D;      // elements between two tokens
  const long long base = (long long)bi * S * row + (long long)h * D;

  for (int i = tid; i < kRows * W; i += kThreadsI8) {
    const int rr = i / W, w = i % W;
    q_s[rr * WP + w] = q0 + rr < S ? load_word<T, kQuantIn>(q, base + (q0 + rr) * row + 4 * w, inv_q) : 0;
  }
  __syncthreads();
  int qw[W];
#pragma unroll
  for (int w = 0; w < W; ++w) qw[w] = q_s[r * WP + w];
  // JAX's dynamic form: qs * ks * scale in fp32, in that order
  const float dq = dyn_scales != nullptr ? __fmul_rn(__fmul_rn(dyn_scales[0], dyn_scales[1]), scale) : dq_static;

  // pass 1: the scaled int8 scores of the block's rows against every key
  for (int k0 = 0; k0 < S; k0 += kKeyTile) {
    __syncthreads();  // the previous K tile is consumed
    for (int i = tid; i < kKeyTile * W; i += kThreadsI8) {
      const int j = i / W, w = i % W;
      k_s[j * WP + w] = k0 + j < S ? load_word<T, kQuantIn>(k, base + (k0 + j) * row + 4 * w, inv_k) : 0;
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

  // pass 2: the row's true max, then exp and the fp32 denominator; p is left
  // in the tile rounded to v's type, as the numerator uses it
  float* prow = p_s + r * SP;
  float m = -INFINITY;
  for (int j = c; j < S; j += kTPRI8) m = fmaxf(m, prow[j]);
#pragma unroll
  for (int off = kTPRI8 / 2; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFullMask, m, off));
  float den = 0.f;
  for (int j = c; j < S; j += kTPRI8) {
    const float p = expf(__fsub_rn(prow[j], m));
    den += p;
    prow[j] = to_f(from_f<T>(p));
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
      v_s[j * D + dd] = j0 + j < S ? to_f(v[base + (j0 + j) * row + dd]) : 0.f;
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
    T* orow = o + base + (q0 + r) * row;
#pragma unroll
    for (int n = 0; n < NC4; ++n) {
      const int col = 4 * (c + kTPRI8 * n);
      orow[col] = from_f<T>(__fdiv_rn(acc[n].x, den));
      orow[col + 1] = from_f<T>(__fdiv_rn(acc[n].y, den));
      orow[col + 2] = from_f<T>(__fdiv_rn(acc[n].z, den));
      orow[col + 3] = from_f<T>(__fdiv_rn(acc[n].w, den));
    }
  }
}

// x (n elements of T) -> int8: x / *scale (dynamic) or x * inv (static).
template <typename T>
__global__ void quantize_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ out, long long n,
                                     const float* __restrict__ scale, float inv) {
  const float s = scale != nullptr ? *scale : 0.f;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    const float xf = to_f(x[i]);
    out[i] = (int8_t)(scale != nullptr ? quant_div(xf, s) : quant_mul(xf, inv));
  }
}

template <typename T, int D, bool kQuantIn>
int launch_i8(const void* q, const void* k, const void* v, void* o, const float* dyn_scales, float dq_static,
              float inv_q, float inv_k, float scale, int B, int S, int H, cudaStream_t stream) {
  const size_t smem = smem_bytes_i8<D>(S);
  auto kernel = packed_mha_int8_kernel<T, D, kQuantIn>;
  // above 48 KB the launch is refused unless the kernel's limit is raised
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  kernel<<<grid, kThreadsI8, smem, stream>>>(q, k, static_cast<const T*>(v), static_cast<T*>(o), dyn_scales,
                                             dq_static, inv_q, inv_k, scale, H, S);
  return (int)cudaGetLastError();
}

template <typename T, bool kQuantIn>
int launch_i8_d(int D, const void* q, const void* k, const void* v, void* o, const float* dyn_scales,
                float dq_static, float inv_q, float inv_k, float scale, int B, int S, int H, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_i8<T, 32, kQuantIn>(q, k, v, o, dyn_scales, dq_static, inv_q, inv_k, scale, B, S, H, stream);
    case 64:
      return launch_i8<T, 64, kQuantIn>(q, k, v, o, dyn_scales, dq_static, inv_q, inv_k, scale, B, S, H, stream);
    case 128:
      return launch_i8<T, 128, kQuantIn>(q, k, v, o, dyn_scales, dq_static, inv_q, inv_k, scale, B, S, H, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_i8_mode(int quant_in, int D, const void* q, const void* k, const void* v, void* o,
                   const float* dyn_scales, float dq_static, float inv_q, float inv_k, float scale, int B, int S,
                   int H, cudaStream_t stream) {
  if (quant_in) {
    return launch_i8_d<T, true>(D, q, k, v, o, dyn_scales, dq_static, inv_q, inv_k, scale, B, S, H, stream);
  }
  return launch_i8_d<T, false>(D, q, k, v, o, dyn_scales, dq_static, inv_q, inv_k, scale, B, S, H, stream);
}

}  // namespace
}  // namespace llmq

using namespace llmq;

// K8 (quant_in 0: q and k are int8) and K9 (quant_in 1: q and k are of v's
// type, quantized in the kernel with inv_q / inv_k; dyn_scales must be null).
extern "C" int llmq_packed_mha_int8(int dtype, const void* q, const void* k, const void* v, void* o, int quant_in,
                                    const void* dyn_scales, float dq_static, float inv_q, float inv_k, float scale,
                                    int B, int S, int H, int D, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (quant_in && dyn_scales != nullptr)) return (int)cudaErrorInvalidValue;
  const float* ds = static_cast<const float*>(dyn_scales);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_i8_mode<float>(quant_in, D, q, k, v, o, ds, dq_static, inv_q, inv_k, scale, B, S, H, st);
  }
  if (dtype == kBFloat16) {
    return launch_i8_mode<__nv_bfloat16>(quant_in, D, q, k, v, o, ds, dq_static, inv_q, inv_k, scale, B, S, H, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Per-tensor int8 quantization of n contiguous elements: x / *scale when
// scale (a device pointer) is given, else x * inv.
extern "C" int llmq_quantize_int8(int dtype, const void* x, void* out, long long n, const void* scale, float inv,
                                  void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  int8_t* y = static_cast<int8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long tiles = (n + threads - 1) / threads;
  const int blocks = (int)(tiles < 132LL * 16 ? tiles : 132LL * 16);  // a grid-stride loop past 16 blocks an SM
  if (dtype == kFloat32) {
    quantize_int8_kernel<float><<<blocks, threads, 0, st>>>(static_cast<const float*>(x), y, n, s, inv);
  } else if (dtype == kBFloat16) {
    quantize_int8_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(static_cast<const __nv_bfloat16*>(x), y, n,
                                                                     s, inv);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
