// Arguments of the grouped matmul over int8 expert stacks (K11):
// quantized_gmm.cu (fp32 rows, on the SIMT units, and the C entry point) and
// quantized_gmm_tc.cu (bf16 rows, on the tensor cores), the bf16 launcher
// the C entry calls, and the group sizes as both kernels read them.
#pragma once

#include "common.cuh"

namespace llmq {

struct QgmmArgs {
  const void* x;             // (T, K) rows sorted by expert, fp32 or bf16
  const int8_t* w;           // (E, K, N) int8
  const float* scale;        // (E, N) fp32
  const void* group_sizes;   // (E,) rows per expert, int32 or (gs64) int64, on the device
  int gs64;
  void* y;                   // (T, N) in x's type
  int T, E, K, N;
};

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
// Each call that launched adds one to llmq_quantized_gmm_tc_launches.
int launch_qgmm_tc(const QgmmArgs& a, int br, int split, cudaStream_t stream);

}  // namespace llmq
