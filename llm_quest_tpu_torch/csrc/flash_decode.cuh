// Arguments of flash-decode over an int8 KV cache (K10): flash_decode.cu
// (the C entry point, and fp32 q on the SIMT units) and flash_decode_tc.cu
// (bf16 q on the tensor cores), and the bf16 launcher the C entry calls.
#pragma once

#include "common.cuh"

namespace llmq {

struct DecodeArgs {
  const void* q;        // (B, HQ, 1, D) by (batch, head) strides, last dim contiguous
  const int8_t* kq;     // (B, HKV, S, D) int8 by strides, rows 16-byte aligned
  const float* ks;      // (B, HKV, S) fp32 by (batch, head) strides
  const int8_t* vq;     // as kq
  const float* vs;      // as ks
  const float* bias;    // (B, S) fp32 by its batch stride
  void* out;            // (B, HQ, 1, D) contiguous, q's type
  int B, HQ, HKV, S, D;
  long long q_sb, q_sh, k_sb, k_sh, k_ss, ks_sb, ks_sh, v_sb, v_sh, v_ss, vs_sb, vs_sh, bias_sb;
  float scale;
};

// The bf16 tensor-core kernel (flash_decode_tc.cu) with the keys of each
// (batch, kv head) in `split` parts (1 to 16), one block a part, which a
// cluster combines in rank order: cudaErrorInvalidValue for an argument it
// does not take, else the launch's error code. Each call that launched adds
// one to llmq_flash_decode_tc_launches.
int launch_flash_decode_tc(const DecodeArgs& a, int split, cudaStream_t stream);

}  // namespace llmq
