// Shared helpers of the port's CUDA kernels (plain C interface, loaded
// with ctypes by infinistore_tpu_torch/ops/_kernels.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace istpu {

// The -1e30 mask value of the JAX package's kernels (not -inf: a fully
// masked row then stays finite, and exp(-1e30 - m) is an exact 0 once a
// real logit has been seen).
constexpr float kNegInf = -1e30f;

// The head dim a kernel is instantiated for (its compile-time capacity)
// when the tensors' own head dim is D: the least of 32, 64, 128 and 256
// at or above D; 0 for a D no kernel takes (not a multiple of 8, so that
// a row is a whole number of 16-byte vectors, or outside [8, 256]).
// Columns at or past D are loaded as zero and never stored; every
// memory stride is D's.
inline int head_dim_capacity(int D) {
    if (D < 8 || D > 256 || D % 8 != 0) return 0;
    return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);  // round to nearest even, as torch does
}

}  // namespace istpu
