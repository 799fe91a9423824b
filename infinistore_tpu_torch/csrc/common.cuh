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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);  // round to nearest even, as torch does
}

// Round through T and back: the bf16 kernels multiply P by V with P
// rounded to bf16, as the TPU kernels do (p.astype(v.dtype)).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
    return to_float(from_float<T>(x));
}

}  // namespace istpu
