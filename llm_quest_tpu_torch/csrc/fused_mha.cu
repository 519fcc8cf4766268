// Short-sequence fused multi-head attention for Hopper, fp32 inputs.
//
// Replaces llm_quest_tpu/kernels/fused_mha.py::fused_mha (_fused_mha_kernel):
// maskless attention over (b, h, s, d) heads with as many k/v heads as q
// heads, s <= fused_mha_max_seq (512), optionally causal. The TPU kernel
// holds whole (s, s) fp32 score tiles of a group of heads in VMEM, takes the
// exact softmax in two passes (the row max over the whole row, then exp),
// casts the unnormalised p to v's type, and gets the denominator from a
// ones column appended to V, so it sums the rounded p; it divides the
// (s, d) output once. In fp32 the cast is the identity.
//
// Dtypes: this file's kernel runs fp32 inputs; the C entry point at its end
// sends bf16 inputs to the tensor-core kernel of fused_mha_tc.cu (which also
// serves packed_mha's bf16 forward).
//
// Design: the grid is (b*h, query tiles of 32 rows); one block of 256
// threads owns 32 query rows of one head, eight threads of one warp a row.
// Each thread keeps its row's q in fp32 registers. Pass 1 walks the keys in
// tiles of 64 staged in shared memory (row stride d + 4, so the eight rows
// a warp reads at once fall in eight different groups of four banks) and
// writes each scaled score of the block's rows into a (32, s) fp32 tile in
// shared memory: the whole score row is held, as the TPU kernel holds its
// (s, s) tile, so the softmax is exact with no online rescale. Pass 2 takes
// each row's true max, then exp, and sums p (the ones column's sum). Pass 3
// streams V in tiles of 32 keys and accumulates p.V in registers (d / 32
// float4 columns a thread), then divides by the sum; with an lse pointer the
// row's m + log(sum) is written for the backward (attention.cu's recompute
// kernels). K and V never sit in shared memory together, so d 128 at s 1024
// fits (about 186 KB). Causal rows stop at their own position and a causal
// block stops staging keys past its last row; keys past s are never read
// (the TPU kernel pads s to 16 and masks the pad).
//
// Bound: both products run on the SIMT units in fp32 (the q.k dot products
// and p.V), so fp32 FMA issue and the shared-memory reads of the K and V
// tiles bound the kernel; fp32 keeps it, because the fp32 checks hold the
// port to its plain version at 1e-5, which TF32 or bf16 operands would break.
#include "fused_mha.cuh"

namespace llmq {
namespace {

constexpr int kFRows = 32;                   // query rows per block
constexpr int kFThreads = 256;
constexpr int kFTPR = kFThreads / kFRows;    // threads per row (8, within one warp)
constexpr int kFKeyTile = 64;                // keys per staged K tile
constexpr int kFValTile = 32;                // keys per staged V tile

// Row stride of the score tile: s rounded up to 32, plus 8 (see packed_mha_int8.cu).
__host__ __device__ __forceinline__ int fused_score_stride(int S) { return (S + 31) / 32 * 32 + 8; }

template <int D>
size_t fused_smem_bytes(int S) {
  return sizeof(float) * ((size_t)kFRows * fused_score_stride(S) + kFKeyTile * (D + 4) + kFValTile * D);
}

// grid (B * H, ceil(S / kFRows)), block kFThreads, dynamic smem fused_smem_bytes<D>(S).
template <int D, bool kCausal>
__global__ void __launch_bounds__(kFThreads) fused_mha_kernel(const ShortArgs a) {
  constexpr int KP = D + 4;                   // padded K row stride (floats)
  constexpr int NS = kFKeyTile / kFTPR;       // scores per thread per K tile
  constexpr int NC4 = D / (4 * kFTPR);        // float4 output columns per thread
  const int S = a.S;
  const int SP = fused_score_stride(S);
  extern __shared__ float smem[];
  float* p_s = smem;                          // kFRows x SP: scores, then p
  float* k_s = p_s + kFRows * SP;             // kFKeyTile x KP
  float* v_s = k_s + kFKeyTile * KP;          // kFValTile x D

  const int bh = blockIdx.x;
  const int bi = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.y * kFRows;
  const int tid = threadIdx.x;
  const int r = tid / kFTPR, c = tid % kFTPR;
  const int row = q0 + r;
  const bool row_ok = row < S;
  // keys the block needs: all of them, or (causal) up to its last row
  const int k_end = kCausal ? min(S, q0 + kFRows) : S;
  // keys this row sees
  const int n_keys = row_ok ? (kCausal ? row + 1 : S) : 0;

  const float* qrow = static_cast<const float*>(a.q) + bi * a.q_sb + h * a.q_sh + (long long)min(row, S - 1) * a.q_ss;
  float qr[D];
#pragma unroll
  for (int dd = 0; dd < D; ++dd) qr[dd] = qrow[dd];

  const float* kh = static_cast<const float*>(a.k) + bi * a.k_sb + h * a.k_sh;
  const float* vh = static_cast<const float*>(a.v) + bi * a.v_sb + h * a.v_sh;

  // pass 1: the scaled scores of the block's rows against every key it needs
  float* prow = p_s + r * SP;
  for (int k0 = 0; k0 < k_end; k0 += kFKeyTile) {
    __syncthreads();  // the previous K tile is consumed
    for (int i = tid; i < kFKeyTile * D; i += kFThreads) {
      const int j = i / D, dd = i % D;
      k_s[j * KP + dd] = k0 + j < k_end ? kh[(long long)(k0 + j) * a.k_ss + dd] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      const int j = c + kFTPR * jj;
      const float4* krow = reinterpret_cast<const float4*>(k_s + j * KP);
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < D / 4; ++w) {
        const float4 kv = krow[w];
        acc += qr[4 * w] * kv.x;
        acc += qr[4 * w + 1] * kv.y;
        acc += qr[4 * w + 2] * kv.z;
        acc += qr[4 * w + 3] * kv.w;
      }
      if (k0 + j < n_keys) prow[k0 + j] = __fmul_rn(acc, a.scale);
    }
  }
  __syncwarp();  // a row's scores were written by its own eight threads

  // pass 2: the row's true max, then exp; p stays in the tile and the
  // denominator sums it
  float m = -INFINITY;
  for (int j = c; j < n_keys; j += kFTPR) m = fmaxf(m, prow[j]);
#pragma unroll
  for (int off = kFTPR / 2; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFullMask, m, off));
  float den = 0.f;
  for (int j = c; j < n_keys; j += kFTPR) {
    const float p = expf(__fsub_rn(prow[j], m));
    den += p;
    prow[j] = p;
  }
#pragma unroll
  for (int off = kFTPR / 2; off > 0; off >>= 1) den += __shfl_xor_sync(kFullMask, den, off);

  // pass 3: p.V over V tiles, fp32 accumulation
  float4 acc[NC4];
#pragma unroll
  for (int n = 0; n < NC4; ++n) acc[n] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j0 = 0; j0 < k_end; j0 += kFValTile) {
    __syncthreads();  // the previous V tile (or the last K tile) is consumed
    for (int i = tid; i < kFValTile * D; i += kFThreads) {
      const int j = i / D, dd = i % D;
      v_s[j * D + dd] = j0 + j < k_end ? vh[(long long)(j0 + j) * a.v_ss + dd] : 0.f;
    }
    __syncthreads();
    const int jn = min(kFValTile, n_keys - j0);
    for (int j = 0; j < jn; ++j) {
      const float p = prow[j0 + j];
      const float4* vrow = reinterpret_cast<const float4*>(v_s + j * D);
#pragma unroll
      for (int n = 0; n < NC4; ++n) {
        const float4 vv = vrow[c + kFTPR * n];
        acc[n].x += p * vv.x;
        acc[n].y += p * vv.y;
        acc[n].z += p * vv.z;
        acc[n].w += p * vv.w;
      }
    }
  }
  if (row_ok) {
    float* orow = row_at<float>(a.o, a.o_sb, a.o_sh, a.o_ss, bi, h, row);
#pragma unroll
    for (int n = 0; n < NC4; ++n) {
      const int col = 4 * (c + kFTPR * n);
      orow[col] = __fdiv_rn(acc[n].x, den);
      orow[col + 1] = __fdiv_rn(acc[n].y, den);
      orow[col + 2] = __fdiv_rn(acc[n].z, den);
      orow[col + 3] = __fdiv_rn(acc[n].w, den);
    }
    if (a.lse != nullptr && c == 0) a.lse[(long long)bh * S + row] = m + logf(den);
  }
}

template <int D, bool kCausal>
int launch_fused(const ShortArgs& a, cudaStream_t stream) {
  const size_t smem = fused_smem_bytes<D>(a.S);
  auto kernel = fused_mha_kernel<D, kCausal>;
  // above 48 KB the launch is refused unless the kernel's limit is raised
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.H, (a.S + kFRows - 1) / kFRows);
  kernel<<<grid, kFThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kCausal>
int launch_fused_d(int D, const ShortArgs& a, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_fused<32, kCausal>(a, stream);
    case 64:
      return launch_fused<64, kCausal>(a, stream);
    case 128:
      return launch_fused<128, kCausal>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace llmq

using namespace llmq;

// K6 (and, for bf16 with fp32_den, K7's forward): q/k/v/o (B, H, S, D) with a
// contiguous last dim and (batch, head, seq) strides in elements;
// 1 <= S <= 1024. lse: contiguous fp32 (B, H, S) or null. fp32 inputs take
// this file's SIMT kernel (where fp32_den makes no difference), bf16 inputs
// the tensor-core kernel of fused_mha_tc.cu.
extern "C" int llmq_fused_mha(int dtype, const void* q, const void* k, const void* v, void* o, void* lse, int B,
                              int H, int S, int D, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                              long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
                              long long o_sb, long long o_sh, long long o_ss, int causal, int fp32_den,
                              float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || S > 1024) return (int)cudaErrorInvalidValue;
  const ShortArgs a{q, k, v, o, static_cast<float*>(lse), B, H, S, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                    v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, causal, fp32_den, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return causal ? launch_fused_d<true>(D, a, st) : launch_fused_d<false>(D, a, st);
  if (dtype == kBFloat16) return launch_short_tc(D, a, st);
  return (int)cudaErrorInvalidValue;
}
