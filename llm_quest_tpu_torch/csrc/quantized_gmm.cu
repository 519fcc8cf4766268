// Grouped matmul over int8 and int4 expert stacks (MoE serving), for Hopper: the C
// entry point, and the kernel on the SIMT units for fp32 rows and for bf16
// rows at widths the tensor-core kernel's TMA cannot address (K % 8 != 0 or
// N % 16 != 0). Other bf16 rows take the tensor-core kernel of
// quantized_gmm_tc.cu.
//
// Replaces llm_quest_tpu/kernels/quantized_gmm.py::quantized_ragged_dot (the
// Pallas kernel _qgmm_kernel): y[r] = (x[r] @ w_q[e(r)]) * scale[e(r)] for
// rows x (T, K) sorted by expert, w_q (E, K, N) int8, scale (E, N) fp32 and
// the device-side group sizes (E,) (expert e's rows follow those of experts
// 0 .. e - 1). The int8 weights are read once per row tile and converted in
// registers; the scale is the epilogue. An int4 stack (BITS 4: (E, ceil(K /
// 2), N) bytes, K rows 2i and 2i + 1 in the low and high nibbles of byte row
// i) is read packed, half the bytes, and its nibbles sign-extended into the
// same int8 shared tile (s4x4_s8); an odd K's pad nibble is zero and meets
// the zero x column past K.
//
// Grid: the TPU wrapper scatters the rows into a group-aligned layout and
// scalar-prefetches an expert id per row tile, so that one expert's whole
// int8 block stays resident in VMEM. Here grid (ceil(N / kBN), E): each block
// finds its expert's row range from the group sizes (no host sync), returns
// before reading any weight when the expert has no row (as the TPU kernel
// never fetches an empty expert), and for every tile of BM = 16 * RM rows
// walks K in chunks of kBK: the (kBK, kBN) int8 weight tile goes to shared
// memory with 16-byte loads (byte loads where N % 16 != 0) and the
// (BM, kBK) row tile as fp32, each thread
// accumulates RM x 4 outputs in fp32, and the scale multiplies once, before
// the single rounding to the rows' type (the TPU kernel rounds bf16 rows'
// product to bf16 first).
//
// Bound: at decode (T = 8 rows) bytes, the int8 weights of the experts hit
// (at most E*K*N); at prefill (T in the thousands) operations, 2*T*K*N. This
// kernel multiplies on the fp32 SIMT units, as fp32 rows need; bf16 rows
// come here only at widths no shipped configuration has.
#include "quantized_gmm.cuh"

namespace llmq {
namespace {

constexpr int kGmmThreads = 256;  // 16 x 16 threads
constexpr int kBN = 64;           // output columns per block (4 per thread)
constexpr int kBK = 64;           // contraction chunk

// rows start .. end - 1 of expert e: the sum of the sizes before it, taken
// by each warp (the lanes' partial sums, then a shuffle reduction)
__device__ __forceinline__ int2 group_rows(const void* gs, int gs64, int e) {
  const int lane = threadIdx.x % 32;
  int start = 0;
  for (int i = lane; i < e; i += 32) start += group_size(gs, gs64, i);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) start += __shfl_xor_sync(kFullMask, start, o);
  return make_int2(start, start + group_size(gs, gs64, e));
}

// grid (ceil(N / kBN), E), block kGmmThreads. x (T, K) and y (T, N) and
// w_q (E, K, N) contiguous, w_q 16-byte aligned.
template <typename T, int RM, int BITS>
__global__ void __launch_bounds__(kGmmThreads)
quantized_gmm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
                     const float* __restrict__ scale, const void* __restrict__ gs, int gs64,
                     T* __restrict__ y, int K, int N) {
  constexpr int BM = 16 * RM;
  constexpr int kRows = BITS == 8 ? kBK : kBK / 2;  // byte rows of a weight tile
  __shared__ __align__(16) float xs[BM][kBK + 1];  // padded: two row groups per warp, other banks
  __shared__ __align__(16) int8_t ws[kBK][kBN];
  const int e = blockIdx.y, n0 = blockIdx.x * kBN;
  const int2 rows = group_rows(gs, gs64, e);
  const int start = rows.x, end = rows.y;
  if (start >= end) return;  // an expert with no rows reads no weight
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int KS = stored_rows(K, BITS);
  const uint8_t* we = w + (size_t)e * KS * N;

  for (int m0 = start; m0 < end; m0 += BM) {
    float acc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kBK) {
      __syncthreads();  // the previous chunk is consumed
      if (tid < kRows * 4) {  // weight tile: thread -> byte row tid / 4, 16 bytes at column (tid % 4) * 16
        const int r = tid / 4, c = (tid % 4) * 16, kr = k0 / (8 / BITS) + r;
        uint4 raw = make_uint4(0, 0, 0, 0);
        const uint8_t* src = we + (size_t)kr * N + n0 + c;
        if (kr < KS && n0 + c < N) {
          if (N % 16 == 0) {  // 16-byte rows: one aligned load
            raw = *reinterpret_cast<const uint4*>(src);
          } else {  // the columns up to N, a byte each
            uint32_t u[4] = {0, 0, 0, 0};
#pragma unroll
            for (int j = 0; j < 16; ++j)
              if (n0 + c + j < N) u[j / 4] |= (uint32_t)src[j] << (8 * (j % 4));
            raw = make_uint4(u[0], u[1], u[2], u[3]);
          }
        }
        if constexpr (BITS == 8) {
          *reinterpret_cast<uint4*>(&ws[r][c]) = raw;
        } else {  // byte row r holds K rows 2r (low nibbles) and 2r + 1 (high)
          *reinterpret_cast<uint4*>(&ws[2 * r][c]) =
              make_uint4(s4x4_s8(raw.x, 0), s4x4_s8(raw.y, 0), s4x4_s8(raw.z, 0), s4x4_s8(raw.w, 0));
          *reinterpret_cast<uint4*>(&ws[2 * r + 1][c]) =
              make_uint4(s4x4_s8(raw.x, 1), s4x4_s8(raw.y, 1), s4x4_s8(raw.z, 1), s4x4_s8(raw.w, 1));
        }
      }
      for (int i = tid; i < BM * kBK; i += kGmmThreads) {
        const int r = i / kBK, c = i % kBK;
        const int row = m0 + r, col = k0 + c;
        xs[r][c] = (row < end && col < K) ? to_f(x[(size_t)row * K + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) {
        const char4 w4 = *reinterpret_cast<const char4*>(&ws[kk][tx * 4]);
        const float b0 = (float)w4.x, b1 = (float)w4.y, b2 = (float)w4.z, b3 = (float)w4.w;
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float a = xs[ty * RM + i][kk];
          acc[i][0] += a * b0;
          acc[i][1] += a * b1;
          acc[i][2] += a * b2;
          acc[i][3] += a * b3;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = m0 + ty * RM + i;
      if (row >= end) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        if (col < N) y[(size_t)row * N + col] = from_f<T>(acc[i][j] * scale[(size_t)e * N + col]);
      }
    }
  }
}

template <typename T, int BITS>
int launch_gmm(const QgmmArgs& a, int rm, cudaStream_t stream) {
  const dim3 grid((a.N + kBN - 1) / kBN, a.E);
  const T* x = static_cast<const T*>(a.x);
  const uint8_t* w = static_cast<const uint8_t*>(a.w);
  T* y = static_cast<T*>(a.y);
  if (rm == 1) {
    quantized_gmm_kernel<T, 1, BITS><<<grid, kGmmThreads, 0, stream>>>(x, w, a.scale, a.group_sizes, a.gs64, y, a.K,
                                                                       a.N);
  } else {
    quantized_gmm_kernel<T, 4, BITS><<<grid, kGmmThreads, 0, stream>>>(x, w, a.scale, a.group_sizes, a.gs64, y, a.K,
                                                                       a.N);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gmm_bits(const QgmmArgs& a, int rm, cudaStream_t stream) {
  return a.bits == 4 ? launch_gmm<T, 4>(a, rm, stream) : launch_gmm<T, 8>(a, rm, stream);
}

}  // namespace
}  // namespace llmq

using namespace llmq;

// x (T, K), y (T, N), w_q (E, K, N) int8 (bits 8) or (E, ceil(K / 2), N)
// packed int4 (bits 4) and scale (E, N) fp32, all contiguous and 16-byte
// aligned; group_sizes (E,) int32 (gs64 0) or int64 (gs64 1) on the device,
// summing to T. br 0: the SIMT kernel, fp32 or bf16
// rows, with rm (rows per thread) in {1, 4}. br > 0: bf16 rows on the
// tensor-core kernel with row tiles of br rows and `split` K parts
// (launch_qgmm_tc), which takes K % 8 == 0 and N % 16 == 0.
extern "C" int llmq_quantized_gmm(int dtype, const void* x, const void* w_q, const float* scale,
                                  const void* group_sizes, int gs64, void* y, int T, int E, int K, int N, int bits,
                                  int rm, int br, int split, void* stream) {
  if (T < 0 || E < 1 || K < 1 || N < 1 || (bits != 8 && bits != 4)) return (int)cudaErrorInvalidValue;
  const QgmmArgs a{x, w_q, scale, group_sizes, gs64, y, T, E, K, N, bits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (br > 0) {
    if (dtype != kBFloat16) return (int)cudaErrorInvalidValue;
    return T == 0 ? (int)cudaSuccess : launch_qgmm_tc(a, br, split, s);
  }
  if (rm != 1 && rm != 4) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  if (dtype == kFloat32) return launch_gmm_bits<float>(a, rm, s);
  if (dtype == kBFloat16) return launch_gmm_bits<__nv_bfloat16>(a, rm, s);
  return (int)cudaErrorInvalidValue;
}
