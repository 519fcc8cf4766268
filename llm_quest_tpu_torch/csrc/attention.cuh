// Arguments shared by the flash-attention kernels of attention.cu (fp32, on
// the SIMT units) and attention_tc.cu (bf16, on the tensor cores), and the
// bf16 launchers that attention.cu's C entry points call.
#pragma once

#include "common.cuh"

namespace llmq {

constexpr float kMasked = -1.7014117331926443e38f;  // finfo(float32).min / 2

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                // (b*hq, sq) or nullptr
  const uint8_t* key_mask;   // (b, sk) with row stride mask_sb, or nullptr
  const float* sink;         // (hq,) or nullptr
  int B, HQ, HKV, SQ, SK;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, mask_sb;
  int causal, q_start;
  float scale;
  int window;     // 0 = none
  float softcap;  // 0 = none
};

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;          // (b*hq, sq)
  const float* delta;        // (b*hq, sq)
  const float* delta_shift;  // (b*hq, sq) or nullptr
  void* dq;                  // (b, hq, sq, d) by its dq_* strides
  void* dk;                  // (b, hkv, sk, d) by its dk_* strides
  void* dv;                  // (b, hkv, sk, dv) by its dv_* strides
  const uint8_t* key_mask;   // (b, sk) with row stride mask_sb, or nullptr
  int B, HQ, HKV, SQ, SK;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss, mask_sb;
  long long dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int causal, q_start;
  float scale;
  int window;     // 0 = none
  float softcap;  // 0 = none
};

// The bf16 tensor-core kernels (attention_tc.cu): cudaErrorInvalidValue for
// a (D, DV) pair they are not built for, else the launch's error code. Each
// call that launched adds one to llmq_attention_tc_launches().
int launch_tc_fwd(int D, int DV, const FwdArgs& a, cudaStream_t stream);
int launch_tc_bwd(int D, int DV, const BwdArgs& a, cudaStream_t stream);

}  // namespace llmq
