// Arguments of the int8-score packed attention kernels:
// packed_mha_int8.cu (fp32 inputs, on the SIMT units) and
// packed_mha_int8_tc.cu (bf16 inputs, on the tensor cores), and the bf16
// launcher that packed_mha_int8.cu's C entry point calls. Both kernels take
// q and k in their own type and quantize them to int8 themselves.
#pragma once

#include "common.cuh"

namespace llmq {

struct Int8Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // (q_s, k_s) fp32 on the device: dynamic scales, x / s and dq = q_s * k_s * scale
  // (K8's); nullptr: static scales, x * inv_q (inv_k) and dq_static (K8's and K9's)
  const float* dyn_scales;
  float dq_static, inv_q, inv_k, scale;
  int B, H, S;
  // (batch, head, seq) strides in elements of the (b, h, s, d) views of the
  // packed (b, s, h * d) tensors; the last dim is contiguous
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
};

// The bf16 tensor-core kernel (packed_mha_int8_tc.cu): cudaErrorInvalidValue
// for a head dim it is not built for (32, 64, 128), else the launch's error
// code. Each call that launched adds one to llmq_packed_mha_int8_tc_launches().
int launch_int8_tc(int D, const Int8Args& a, cudaStream_t stream);

}  // namespace llmq
