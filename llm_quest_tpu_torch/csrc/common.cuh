// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel file exposes a plain C interface: pointers and the stream as
// void*, sizes as int, strides (in elements) as long long. Each entry point
// launches on the caller's stream, never synchronises, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch (too many threads, too much shared memory, an unsupported shape).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace llmq {

// element type codes shared with kernels/build.py
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// the row at (batch bi, head h, position pos) of a (b, h, s, w) tensor with
// (batch, head, seq) strides in elements
template <typename T>
__device__ __forceinline__ T* row_at(void* base, long long sb, long long sh, long long ss, int bi, int h, int pos) {
  return static_cast<T*>(base) + bi * sb + h * sh + pos * ss;
}

}  // namespace llmq
