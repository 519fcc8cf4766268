// Arguments of the grouped matmul over int8 and int4 expert stacks (K11):
// quantized_gmm.cu (fp32 rows, on the SIMT units, and the C entry point) and
// quantized_gmm_tc.cu (bf16 rows, on the tensor cores), the bf16 launcher
// the C entry calls, and the group sizes as both kernels read them.
#pragma once

#include "common.cuh"

namespace llmq {

struct QgmmArgs {
  const void* x;             // (T, K) rows sorted by expert, fp32 or bf16
  const void* w;             // (E, K, N) int8, or (bits 4) (E, ceil(K / 2), N) packed int4: K rows 2i
                             // and 2i + 1 in the low and high nibbles of byte row i, two's complement
  const float* scale;        // (E, N) fp32
  const void* group_sizes;   // (E,) rows per expert, int32 or (gs64) int64, on the device
  int gs64;
  void* y;                   // (T, N) in x's type
  int T, E, K, N;
  int bits;                  // 8 or 4
};

// byte rows of an expert's stored (K, N) weight
__host__ __device__ __forceinline__ int stored_rows(int K, int bits) { return bits == 4 ? (K + 1) / 2 : K; }

// the low (hi 0) or high (hi 1) nibbles of the four bytes of u as four
// int8 bytes, sign-extended: per byte b ^ 8 is v + 8 in [0, 15], and
// ((v + 8) + 0x78) ^ 0x80 is v mod 256 (no carry crosses a byte)
__device__ __forceinline__ uint32_t s4x4_s8(uint32_t u, int hi) {
  const uint32_t b = ((hi ? u >> 4 : u) & 0x0F0F0F0Fu) ^ 0x08080808u;
  return (b + 0x78787878u) ^ 0x80808080u;
}

// rows of expert e (a negative size counts as none)
__device__ __forceinline__ int group_size(const void* gs, int gs64, int e) {
  const long long g = gs64 ? static_cast<const long long*>(gs)[e] : static_cast<const int*>(gs)[e];
  return g > 0 ? static_cast<int>(g) : 0;
}

// The bf16 tensor-core kernel (quantized_gmm_tc.cu) with row tiles of br
// rows (8, 16, 32, 64 or 128) and K cut into `split` parts (1 to 8) that a
// cluster sums in a fixed order: cudaErrorInvalidValue for an argument it
// does not take (K % 8 != 0 or N % 16 != 0 among them: TMA's 16-byte row
// strides), else the launch's error code.
// bits 8 or 4 (a.bits) takes the int8 or the packed int4 stack.
// Each call that launched adds one to llmq_quantized_gmm_tc_launches.
int launch_qgmm_tc(const QgmmArgs& a, int br, int split, cudaStream_t stream);

}  // namespace llmq
