// Arguments of the short-sequence attention kernels: fused_mha.cu (fp32, on
// the SIMT units) and fused_mha_tc.cu (bf16, on the tensor cores), and the
// bf16 launcher that fused_mha.cu's C entry point calls.
#pragma once

#include "common.cuh"

namespace llmq {

struct ShortArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // contiguous fp32 (b, h, s), the exact softmax's row logsumexp, or nullptr
  int B, H, S;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int causal;
  // the denominator: 1 sums the fp32 p (packed_mha's), 0 the p rounded to
  // v's type, as p.V sees them (fused_mha's ones column); the same in fp32
  int fp32_den;
  float scale;
};

// The bf16 tensor-core kernel (fused_mha_tc.cu): cudaErrorInvalidValue for a
// head dim it is not built for (32, 64, 128), else the launch's error code.
// Each call that launched adds one to llmq_fused_mha_tc_launches().
int launch_short_tc(int D, const ShortArgs& a, cudaStream_t stream);

}  // namespace llmq
