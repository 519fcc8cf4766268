// The bf16 tensor-core path of K1 (gdn_tc.cu), called by gdn.cu's C entry
// points for bf16 inputs.
#pragma once

#include "common.cuh"

namespace llmq {

// One call of the chunked gated delta rule's forward or backward. Forward:
// q/k/v by (batch, head, seq) strides; anchors (2, n, b, h, dv, dk) and
// saved_d (2, b*h, n, dv, 64) bf16 (hi then lo) both given (kept for the
// backward) or both null (in the work buffer). Backward: q/k/v/dout
// contiguous, the forward's anchors and saved_d. n = ceil(s / 64).
struct GdnTcCall {
  const void *q, *k, *v;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  const float *beta, *alpha;  // (b, h, s) fp32
  const float* s0;            // (b, h, dv, dk) fp32 or null
  float* s_out;               // (b, h, dv, dk) fp32
  void* out;                  // (b, h, s, dv) bf16
  void* anchors;
  void* saved_d;
  void* work;                 // gdn_tc_work_bytes
  const void* dout;           // (b, h, s, dv) bf16
  const float* dstate;        // (b, h, dv, dk) fp32 or null
  void *dq, *dk, *dv;         // bf16
  float *dbeta, *dalpha, *dprev;
  int B, H, S, DK, DV;
  float scale;
};

// dk and dv in {64, 128}
bool gdn_tc_takes(int DK, int DV);
// bytes of a call's work buffer; saved: the forward's caller keeps the anchors and D^T; -1 if not taken
long long gdn_tc_work_bytes(int backward, int B, int H, int S, int DK, int DV, int saved);
int gdn_tc_prefill(const GdnTcCall& c, cudaStream_t stream);
int gdn_tc_prefill_bwd(const GdnTcCall& c, cudaStream_t stream);

}  // namespace llmq
