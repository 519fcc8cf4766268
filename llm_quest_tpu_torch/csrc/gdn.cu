// Gated delta rule (GatedDeltaNet) kernels for Hopper.
//
// Replaces these parts of llm_quest_tpu/kernels/gdn_pallas.py:
//   llmq_gdn_prefill           <- gated_delta_rule_pallas, forward (the chunked
//                                 _gdn_chunk_kernel with its state in VMEM),
//                                 optionally streaming the chunk-initial
//                                 states (save_chunk_states)
//   llmq_gdn_prefill_bwd       <- its custom VJP (_gdn_bwd: a reverse scan of
//                                 per-chunk vjps from those states)
//   llmq_gdn_step_stacked      <- gated_delta_rule_step_stacked_pallas (the
//                                 in-place one-token step on the stacked
//                                 (L, b, h, dv, dk) decode state)
//
// Math, per (batch, head), with S the fp32 (dv, dk) state:
//   S' = a*S + b*(v - a*S k) k^T,    o = S' (q * dk^-1/2)
// Row i of S updates independently of every other row:
//   S'[i,:] = a*S[i,:] + d_i k,  d_i = b*(v_i - a*S[i,:].k)
//   o_i     = (a*S[i,:].q + d_i*(k.q)) * dk^-1/2
// so one warp owns one state row in registers (DK / 32 fp32 per lane; DK is
// 64 or 128) for the whole call, and the dot products of a token are
// interleaved warp butterflies. The prefill walks the tokens in order (the
// exact scan, any s >= 1), staging kChunk tokens of q and k in shared memory
// for the block's kRows warps. Padding needs no special case: beta = 0,
// alpha = 1 is a no-op step. The Newton-Schulz inverse of the TPU kernel is a
// workaround for the TPU's slow triangular solve and has no counterpart here.
//
// Backward, per row i, walking t downward from H = dL/dS_T (the final-state
// cotangent), with G = a_t S_{t-1}, u = G k_t, d = b_t (v_t - u):
//   H += do_t q~^T;        dq~_t  = S_t^T do_t
//   dd = H k_t;            dv_t   = b_t dd,   db_t = dd.(v_t - u),  du = -b_t dd
//   dG = H + du k_t^T;     dk_t   = H^T d + G^T du;  da_t = <dG, S_{t-1}>
//   H  = a_t dG            (after t = 0, H is d_prev_state)
// dv is row-local; dq, dk, db and da are sums over the dv rows. S_{t-1} is
// not recovered by dividing by a (a underflows towards 0 in the models): the
// forward streams the state at every `chunk`-th token (the anchors), and the
// backward replays each chunk forward from its anchor into shared memory,
// then walks it in reverse. Cross-row sums are deterministic: the warps of a
// block add their rows in shared memory in a fixed order, each block writes
// its sum to a partial buffer, and a second kernel adds the blocks' partials
// in a fixed order.
//
// Bound: the prefill and its backward are latency-bound on the sequential
// token loop (one or five interleaved shuffle trees per token, and in the
// backward one block barrier per token); the decode step is bound by reading
// and writing the fp32 state once (64 KB per (b, h) at dv = dk = 128), which
// is the minimum traffic: the state stays in registers between read and write.
#include "common.cuh"

namespace llmq {
namespace {

constexpr int kRows = 8;        // forward and step: warps (= state rows) per block
constexpr int kChunk = 32;      // forward: tokens staged in shared memory
constexpr int kMaxAnchor = 32;  // backward: most tokens between two anchors (the replay window)

template <int N>
__device__ __forceinline__ void load_row(float (&st)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    st[0] = x.x; st[1] = x.y; st[2] = x.z; st[3] = x.w;
  } else {
    static_assert(N == 2, "a lane holds 2 (DK 64) or 4 (DK 128) state elements");
    const float2 x = *reinterpret_cast<const float2*>(p);
    st[0] = x.x; st[1] = x.y;
  }
}

template <int N>
__device__ __forceinline__ void store_row(float* p, const float (&st)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(st[0], st[1], st[2], st[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(st[0], st[1]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

// One token for one state row. st: this lane's slice of the row (updated in
// place); kv/qv: this lane's slice of k and q. Returns o_i (all lanes).
template <int N>
__device__ __forceinline__ float row_step(float (&st)[N], const float (&kv)[N], const float (&qv)[N],
                                          float alpha, float beta, float v, float scale) {
  float sk = 0.f, sq = 0.f, kq = 0.f;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    sk += st[e] * kv[e];
    sq += st[e] * qv[e];
    kq += kv[e] * qv[e];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sk += __shfl_xor_sync(kFullMask, sk, off);
    sq += __shfl_xor_sync(kFullMask, sq, off);
    kq += __shfl_xor_sync(kFullMask, kq, off);
  }
  const float delta = beta * (v - alpha * sk);
#pragma unroll
  for (int e = 0; e < N; ++e) st[e] = alpha * st[e] + delta * kv[e];
  return (alpha * sq + delta * kq) * scale;
}

// grid (dv / kRows, b*h), block kRows warps.
// q/k: (b, h, s, DK) and v: (b, h, s, dv) by strides (last dim contiguous);
// beta/alpha: (b, h, s) fp32 contiguous; s0 (nullable) and s_out:
// (b, h, dv, DK) fp32 contiguous; anchors (nullable): (ceil(s / chunk), b, h,
// dv, DK) fp32, the state before tokens 0, chunk, 2*chunk, ...; out: (b, h,
// s, dv) contiguous.
template <typename T, int DK>
__global__ void __launch_bounds__(kRows * 32)
gdn_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ beta, const float* __restrict__ alpha,
                   const float* __restrict__ s0, float* __restrict__ s_out,
                   float* __restrict__ anchors, T* __restrict__ out, int H, int S, int DV, int chunk,
                   long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
                   long long k_ss, long long v_sb, long long v_sh, long long v_ss, float scale) {
  constexpr int N = DK / 32;
  __shared__ __align__(16) float q_s[kChunk][DK];
  __shared__ __align__(16) float k_s[kChunk][DK];
  __shared__ float v_s[kChunk][kRows];
  __shared__ float a_s[kChunk];
  __shared__ float b_s[kChunk];

  const int bh = blockIdx.y, BH = gridDim.y;
  const int bi = bh / H, hi = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRows;
  const int row = row0 + warp;
  const size_t st_off = ((size_t)bh * DV + row) * DK + lane * N;

  float st[N];
  if (s0 != nullptr) {
    load_row(st, s0 + st_off);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) st[e] = 0.f;
  }

  const T* qb = q + bi * q_sb + hi * q_sh;
  const T* kb = k + bi * k_sb + hi * k_sh;
  const T* vb = v + bi * v_sb + hi * v_sh;
  const float* beta_b = beta + (size_t)bh * S;
  const float* alpha_b = alpha + (size_t)bh * S;
  T* ob = out + (size_t)bh * S * DV;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();  // every warp is done with the previous chunk
    for (int i = threadIdx.x; i < n * DK; i += blockDim.x) {
      const int t = i / DK, d = i % DK;
      q_s[t][d] = to_f(qb[(t0 + t) * q_ss + d]);
      k_s[t][d] = to_f(kb[(t0 + t) * k_ss + d]);
    }
    for (int i = threadIdx.x; i < n * kRows; i += blockDim.x) {
      const int t = i / kRows, r = i % kRows;
      v_s[t][r] = to_f(vb[(t0 + t) * v_ss + row0 + r]);
    }
    if (threadIdx.x < n) {
      a_s[threadIdx.x] = alpha_b[t0 + threadIdx.x];
      b_s[threadIdx.x] = beta_b[t0 + threadIdx.x];
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      if (anchors != nullptr && (t0 + t) % chunk == 0) {
        store_row(anchors + ((size_t)((t0 + t) / chunk) * BH * DV) * DK + st_off, st);
      }
      float kv[N], qv[N];
      load_row(kv, &k_s[t][lane * N]);
      load_row(qv, &q_s[t][lane * N]);
      const float o = row_step(st, kv, qv, a_s[t], b_s[t], v_s[t][warp], scale);
      if (lane == 0) ob[(size_t)(t0 + t) * DV + row] = from_f<T>(o);
    }
  }
  store_row(s_out + st_off, st);
}

// Block shape of the backward for head dim DK: kRowsB warps (= state rows)
// per block; each stores its row's states over one replay window
// (kMaxAnchor * DK fp32) in shared memory. A partial row holds a block's sums
// for one token: dq~ (DK), dk (DK), dbeta, dalpha, padded to kW.
template <int DK>
struct Bwd {
  static constexpr int kRowsB = DK == 64 ? 16 : 8;
  static constexpr int kW = 2 * DK + 4;
  static constexpr int kCols = 2 * DK + 2;
  static constexpr size_t kSmemFloats = (size_t)kRowsB * kMaxAnchor * DK  // replayed states
                                        + 2 * kMaxAnchor * DK             // q (pre-scaled), k
                                        + 2 * kRowsB * kW                 // partial rows, double-buffered
                                        + 2 * kMaxAnchor * kRowsB         // v, d_out of the block's rows
                                        + 2 * kMaxAnchor;                 // alpha, beta
};

// grid (dv / kRowsB, b*h), block kRowsB warps, Bwd<DK>::kSmemFloats * 4
// bytes of dynamic shared memory. Contiguous operands: q/k (b, h, s, DK),
// v/d_out (b, h, s, dv), beta/alpha (b, h, s) fp32, anchors (ceil(s/chunk),
// b, h, dv, DK) fp32, d_state (nullable) (b, h, dv, DK) fp32. Writes dv (b,
// h, s, dv) in T, d_prev (b, h, dv, DK) fp32, and this block's partial rows
// into part (dv / kRowsB, b*h, s, kW) fp32.
template <typename T, int DK>
__global__ void __launch_bounds__(Bwd<DK>::kRowsB * 32)
gdn_prefill_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ beta, const float* __restrict__ alpha,
                       const float* __restrict__ anchors, const T* __restrict__ dout,
                       const float* __restrict__ dstate, float* __restrict__ part,
                       T* __restrict__ dv_out, float* __restrict__ dprev, int S, int DV, int chunk,
                       float scale) {
  constexpr int N = DK / 32, R = Bwd<DK>::kRowsB, W = Bwd<DK>::kW;
  extern __shared__ __align__(16) float smem[];
  float* st_s = smem;                           // [R][kMaxAnchor][DK]
  float* q_s = st_s + R * kMaxAnchor * DK;      // [kMaxAnchor][DK]
  float* k_s = q_s + kMaxAnchor * DK;           // [kMaxAnchor][DK]
  float* red = k_s + kMaxAnchor * DK;           // [2][R][W]
  float* v_s = red + 2 * R * W;                 // [kMaxAnchor][R]
  float* do_s = v_s + kMaxAnchor * R;           // [kMaxAnchor][R]
  float* a_s = do_s + kMaxAnchor * R;           // [kMaxAnchor]
  float* b_s = a_s + kMaxAnchor;                // [kMaxAnchor]

  const int bh = blockIdx.y, BH = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * R;
  const int row = row0 + warp;
  const size_t st_off = ((size_t)bh * DV + row) * DK + lane * N;
  const T* qb = q + (size_t)bh * S * DK;
  const T* kb = k + (size_t)bh * S * DK;
  const T* vb = v + (size_t)bh * S * DV;
  const T* dob = dout + (size_t)bh * S * DV;
  const float* alpha_b = alpha + (size_t)bh * S;
  const float* beta_b = beta + (size_t)bh * S;
  T* dvb = dv_out + (size_t)bh * S * DV;
  float* pb = part + ((size_t)blockIdx.x * BH + bh) * S * W;
  float* my_st = st_s + (size_t)warp * kMaxAnchor * DK + lane * N;

  float hs[N];  // this lane's slice of dL/dS for the row
  if (dstate != nullptr) {
    load_row(hs, dstate + st_off);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) hs[e] = 0.f;
  }

  int parity = 0;
  for (int ci = (S + chunk - 1) / chunk - 1; ci >= 0; --ci) {
    const int t_lo = ci * chunk, n = min(chunk, S - t_lo);
    __syncthreads();  // every warp is done with the previous chunk's staging
    for (int i = threadIdx.x; i < n * DK; i += blockDim.x) {
      q_s[i] = to_f(qb[(size_t)t_lo * DK + i]) * scale;
      k_s[i] = to_f(kb[(size_t)t_lo * DK + i]);
    }
    for (int i = threadIdx.x; i < n * R; i += blockDim.x) {
      const int t = i / R, r = i % R;
      v_s[i] = to_f(vb[(size_t)(t_lo + t) * DV + row0 + r]);
      do_s[i] = to_f(dob[(size_t)(t_lo + t) * DV + row0 + r]);
    }
    if (threadIdx.x < n) {
      a_s[threadIdx.x] = alpha_b[t_lo + threadIdx.x];
      b_s[threadIdx.x] = beta_b[t_lo + threadIdx.x];
    }
    __syncthreads();

    // replay the chunk from its anchor; my_st[t] = S_{t-1} (the state before token t)
    float sp[N];
    load_row(sp, anchors + (size_t)ci * BH * DV * DK + st_off);
    for (int t = 0; t < n; ++t) {
      store_row(my_st + t * DK, sp);
      float kv[N];
      load_row(kv, k_s + t * DK + lane * N);
      float sk = 0.f;
#pragma unroll
      for (int e = 0; e < N; ++e) sk += sp[e] * kv[e];
      sk = warp_sum(sk);
      const float delta = b_s[t] * (v_s[t * R + warp] - a_s[t] * sk);
#pragma unroll
      for (int e = 0; e < N; ++e) sp[e] = a_s[t] * sp[e] + delta * kv[e];
    }

    // walk the chunk in reverse
    for (int t = n - 1; t >= 0; --t) {
      const float a = a_s[t], bt = b_s[t], vi = v_s[t * R + warp], doi = do_s[t * R + warp];
      float kv[N], qv[N];
      load_row(sp, my_st + t * DK);
      load_row(kv, k_s + t * DK + lane * N);
      load_row(qv, q_s + t * DK + lane * N);
      float sk = 0.f, hk = 0.f, qk = 0.f, hsp = 0.f, qsp = 0.f;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        sk += sp[e] * kv[e];
        hk += hs[e] * kv[e];
        qk += qv[e] * kv[e];
        hsp += hs[e] * sp[e];
        qsp += qv[e] * sp[e];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sk += __shfl_xor_sync(kFullMask, sk, off);
        hk += __shfl_xor_sync(kFullMask, hk, off);
        qk += __shfl_xor_sync(kFullMask, qk, off);
        hsp += __shfl_xor_sync(kFullMask, hsp, off);
        qsp += __shfl_xor_sync(kFullMask, qsp, off);
      }
      const float u = a * sk;
      const float delta = bt * (vi - u);
      const float ddelta = hk + doi * qk;           // (H + do q~^T) . k
      const float du = -bt * ddelta;
      float* rrow = red + (parity * R + warp) * W;  // this row's partial row
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float h = hs[e] + doi * qv[e];        // dL/dS_t
        rrow[lane * N + e] = doi * (a * sp[e] + delta * kv[e]);   // dq~: S_t^T do
        rrow[DK + lane * N + e] = h * delta + a * sp[e] * du;     // dk: H^T d + G^T du
        hs[e] = a * (h + du * kv[e]);               // dL/dS_{t-1} = a dG
      }
      if (lane == 0) {
        rrow[2 * DK] = ddelta * (vi - u);                       // dbeta
        rrow[2 * DK + 1] = hsp + doi * qsp + du * sk;           // dalpha = <dG, S_{t-1}>
        dvb[(size_t)(t_lo + t) * DV + row] = from_f<T>(bt * ddelta);
      }
      __syncthreads();
      // the block's rows summed in a fixed order (double-buffered by parity:
      // the next token writes the other half, so one barrier per token)
      const float* rsum = red + parity * R * W;
      for (int c = threadIdx.x; c < Bwd<DK>::kCols; c += blockDim.x) {
        float acc = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) acc += rsum[r * W + c];
        pb[(size_t)(t_lo + t) * W + c] = acc;
      }
      parity ^= 1;
    }
  }
  store_row(dprev + st_off, hs);
}

// Adds the blocks' partial rows in a fixed order: dq = scale * sum dq~ and
// dk in T (b, h, s, DK), dbeta and dalpha fp32 (b, h, s).
template <typename T, int DK>
__global__ void gdn_bwd_reduce_kernel(const float* __restrict__ part, int n_blocks, long long n_pos,
                                      T* __restrict__ dq, T* __restrict__ dk,
                                      float* __restrict__ dbeta, float* __restrict__ dalpha,
                                      float scale) {
  constexpr int W = Bwd<DK>::kW, C = Bwd<DK>::kCols;
  const long long total = n_pos * C;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long pos = i / C;
    const int c = (int)(i % C);
    float acc = 0.f;
    for (int r = 0; r < n_blocks; ++r) acc += part[((size_t)r * n_pos + pos) * W + c];
    if (c < DK) {
      dq[pos * DK + c] = from_f<T>(acc * scale);
    } else if (c < 2 * DK) {
      dk[pos * DK + c - DK] = from_f<T>(acc);
    } else if (c == 2 * DK) {
      dbeta[pos] = acc;
    } else {
      dalpha[pos] = acc;
    }
  }
}

// grid (dv / kRows, b*h), block kRows warps. Updates layer `layer` of the
// stacked (L, b, h, dv, dk) fp32 state in place; every other layer is never
// read or written. q/k: (b, h, dk), v: (b, h, dv) by strides; beta/alpha:
// (b, h) fp32 contiguous; out: (b, h, dv) contiguous.
template <typename T, int DK>
__global__ void __launch_bounds__(kRows * 32)
gdn_step_stacked_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ beta, const float* __restrict__ alpha,
                        float* __restrict__ stacked, int layer, T* __restrict__ out, int B, int H,
                        int DV, long long q_sb, long long q_sh, long long k_sb, long long k_sh,
                        long long v_sb, long long v_sh, float scale) {
  constexpr int N = DK / 32;
  const int bh = blockIdx.y;
  const int bi = bh / H, hi = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRows + warp;
  float* st_ptr = stacked + (((size_t)layer * B * H + bh) * DV + row) * DK + lane * N;

  const T* qb = q + bi * q_sb + hi * q_sh + lane * N;
  const T* kb = k + bi * k_sb + hi * k_sh + lane * N;
  float st[N], kv[N], qv[N];
  load_row(st, st_ptr);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    kv[e] = to_f(kb[e]);
    qv[e] = to_f(qb[e]);
  }
  const float vi = to_f(v[bi * v_sb + hi * v_sh + row]);
  const float o = row_step(st, kv, qv, alpha[bh], beta[bh], vi, scale);
  store_row(st_ptr, st);
  if (lane == 0) out[(size_t)bh * DV + row] = from_f<T>(o);
}

template <typename T, int DK>
int launch_prefill(const void* q, const void* k, const void* v, const float* beta,
                   const float* alpha, const float* s0, float* s_out, float* anchors, void* out,
                   int B, int H, int S, int DV, int chunk, const long long (&st)[9], float scale,
                   cudaStream_t stream) {
  const dim3 grid(DV / kRows, B * H), block(kRows * 32);
  gdn_prefill_kernel<T, DK><<<grid, block, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), beta, alpha, s0,
      s_out, anchors, static_cast<T*>(out), H, S, DV, chunk, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale);
  return (int)cudaGetLastError();
}

template <typename T, int DK>
int launch_prefill_bwd(const void* q, const void* k, const void* v, const float* beta,
                       const float* alpha, const float* anchors, const void* dout,
                       const float* dstate, float* part, void* dq, void* dk, void* dv,
                       float* dbeta, float* dalpha, float* dprev, int B, int H, int S, int DV,
                       int chunk, float scale, cudaStream_t stream) {
  constexpr int R = Bwd<DK>::kRowsB;
  if (DV % R != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = Bwd<DK>::kSmemFloats * sizeof(float);
  auto kernel = gdn_prefill_bwd_kernel<T, DK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(DV / R, B * H), R * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), beta, alpha,
      anchors, static_cast<const T*>(dout), dstate, part, static_cast<T*>(dv), dprev, S, DV, chunk,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_pos = (long long)B * H * S;
  const long long total = n_pos * Bwd<DK>::kCols;
  const long long want = (total + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  gdn_bwd_reduce_kernel<T, DK><<<blocks, 256, 0, stream>>>(
      part, DV / R, n_pos, static_cast<T*>(dq), static_cast<T*>(dk), dbeta, dalpha, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace llmq

using namespace llmq;

// DK in {64, 128}, dv % 8 == 0, s >= 1; anchors nullable, else 1 <= chunk.
extern "C" int llmq_gdn_prefill(int dtype, const void* q, const void* k, const void* v,
                                const float* beta, const float* alpha, const float* s0,
                                float* s_out, float* anchors, void* out, int B, int H, int S,
                                int DK, int DV, int chunk, long long q_sb, long long q_sh,
                                long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                                long long v_sb, long long v_sh, long long v_ss, float scale,
                                void* stream) {
  if ((DK != 64 && DK != 128) || DV <= 0 || DV % kRows != 0 || S < 1 || chunk < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return DK == 64 ? launch_prefill<float, 64>(q, k, v, beta, alpha, s0, s_out, anchors, out, B, H, S, DV, chunk, st, scale, s)
                    : launch_prefill<float, 128>(q, k, v, beta, alpha, s0, s_out, anchors, out, B, H, S, DV, chunk, st, scale, s);
  }
  if (dtype == kBFloat16) {
    return DK == 64 ? launch_prefill<__nv_bfloat16, 64>(q, k, v, beta, alpha, s0, s_out, anchors, out, B, H, S, DV, chunk, st, scale, s)
                    : launch_prefill<__nv_bfloat16, 128>(q, k, v, beta, alpha, s0, s_out, anchors, out, B, H, S, DV, chunk, st, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Contiguous operands (see gdn_prefill_bwd_kernel); part: scratch of
// llmq_gdn_prefill_bwd_blocks(DK, DV) * B * H * S * (2 * DK + 4) fp32.
// DK in {64, 128}, dv a multiple of the block's rows, 1 <= chunk <= 32.
extern "C" int llmq_gdn_prefill_bwd(int dtype, const void* q, const void* k, const void* v,
                                    const float* beta, const float* alpha, const float* anchors,
                                    const void* dout, const float* dstate, float* part, void* dq,
                                    void* dk, void* dv, float* dbeta, float* dalpha, float* dprev,
                                    int B, int H, int S, int DK, int DV, int chunk, float scale,
                                    void* stream) {
  if ((DK != 64 && DK != 128) || DV <= 0 || S < 1 || chunk < 1 || chunk > kMaxAnchor) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LLMQ_GDN_BWD(T, D)                                                                     \
  launch_prefill_bwd<T, D>(q, k, v, beta, alpha, anchors, dout, dstate, part, dq, dk, dv,     \
                           dbeta, dalpha, dprev, B, H, S, DV, chunk, scale, s)
  if (dtype == kFloat32) return DK == 64 ? LLMQ_GDN_BWD(float, 64) : LLMQ_GDN_BWD(float, 128);
  if (dtype == kBFloat16) {
    return DK == 64 ? LLMQ_GDN_BWD(__nv_bfloat16, 64) : LLMQ_GDN_BWD(__nv_bfloat16, 128);
  }
#undef LLMQ_GDN_BWD
  return (int)cudaErrorInvalidValue;
}

// Blocks (row groups) the backward splits dv into: the first dimension of
// its partial-sum scratch; 0 for an unsupported DK or dv.
extern "C" int llmq_gdn_prefill_bwd_blocks(int DK, int DV) {
  const int rows = DK == 64 ? Bwd<64>::kRowsB : DK == 128 ? Bwd<128>::kRowsB : 0;
  return rows == 0 || DV <= 0 || DV % rows != 0 ? 0 : DV / rows;
}

// DK in {64, 128} (Qwen3.5 at 128, Qwen3-Next at 64), dv % kRows == 0.
extern "C" int llmq_gdn_step_stacked(int dtype, const void* q, const void* k, const void* v,
                                     const float* beta, const float* alpha, float* stacked,
                                     int layer, void* out, int B, int H, int DK, int DV,
                                     long long q_sb, long long q_sh, long long k_sb,
                                     long long k_sh, long long v_sb, long long v_sh, float scale,
                                     void* stream) {
  if ((DK != 64 && DK != 128) || DV <= 0 || DV % kRows != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(DV / kRows, B * H), block(kRows * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LLMQ_GDN_STEP(T, D)                                                                    \
  gdn_step_stacked_kernel<T, D><<<grid, block, 0, st>>>(                                      \
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), beta,     \
      alpha, stacked, layer, static_cast<T*>(out), B, H, DV, q_sb, q_sh, k_sb, k_sh, v_sb,   \
      v_sh, scale)
  if (dtype == kFloat32) {
    if (DK == 64) LLMQ_GDN_STEP(float, 64); else LLMQ_GDN_STEP(float, 128);
  } else if (dtype == kBFloat16) {
    if (DK == 64) LLMQ_GDN_STEP(__nv_bfloat16, 64); else LLMQ_GDN_STEP(__nv_bfloat16, 128);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef LLMQ_GDN_STEP
  return (int)cudaGetLastError();
}
