// Flash prefill attention (causal GQA, rectangular diagonal, optional
// sliding window) for Hopper, sm_90a.
//
// Replaces: infinistore_tpu/ops/pallas_flash_attention.py::_kernel (the
// forward, reached through _forward_impl / flash_prefill_attention, and
// with_lse=True under _flash_with_vjp: with a non-null `lse` it also
// writes each row's logsumexp for the backward kernels).
//
// What bounds it on an H100: operations. At Sq = Skv = 2048, hd = 128,
// 32 heads, a causal pass is ~3.4e10 FLOP against ~4e7 bytes of q/k/v/o,
// far above the card's ~295 FLOP/byte balance point, so the tensor
// cores are the limit (989 TFLOP/s bf16 dense).
//
// Design. The TPU grid walks the kv blocks in order and keeps acc/m/l in
// VMEM scratch between grid steps; Hopper blocks run in no order, so one
// CTA owns one (batch*head, 64-row q tile) and loops over the kv tiles
// itself, staging each 64-row K and V tile in shared memory. Each of the
// 4 warps owns 16 query rows: S = Q K^T and P V run on the tensor cores
// (wmma bf16 16x16x16, f32 accumulation); the online softmax is f32 in
// registers, two lanes per row. Tiles past the shifted diagonal
// (kv_len - q_len) and below the window band are never loaded; only
// boundary and ragged tiles build a mask, with -1e30 as the masked logit
// (the range, interior rule and mask are flash_tile.cuh's, shared with
// the backward kernels).
// The f32 variant keeps the same structure with plain FMA loops, so f32
// stays true f32 (no TF32). The tile fold is shared with the paged verify
// kernel (flash_tile.cuh). This is the simple version: wmma over
// synchronous shared-memory loads; wgmma, TMA and a pipelined ring of
// tiles are the next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_tile.cuh"

namespace {

using istpu::from_float;
using namespace istpu::tile;

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Skv, int H, int KV,
                     int causal, int window, float scale) {
    constexpr int LD = Layout<T, HD>::LD;
    constexpr int OC = HD / 2;  // output columns held by one lane

    extern __shared__ __align__(128) unsigned char smem[];
    const Smem<T, HD> sm(smem);

    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh % H;
    const int kvh = h / (H / KV);
    const int q_start = blockIdx.x * BQ;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;

    const size_t q_stride = (size_t)H * HD;
    const size_t kv_stride = (size_t)KV * HD;
    const T* qbase = q + ((size_t)b * Sq * H + h) * HD;
    const T* kbase = k + ((size_t)b * Skv * KV + kvh) * HD;
    const T* vbase = v + ((size_t)b * Skv * KV + kvh) * HD;

    load_tile<T, HD, LD>(sm.Q, qbase, q_stride, q_start, Sq);

    int kt_begin, kt_end;
    kv_tiles(q_start, Sq, Skv, causal, window, kt_begin, kt_end);

    const int half = lane & 1;
    const int pos_q = q_start + warp * 16 + (lane >> 1);
    RowState<HD> st;

    __syncthreads();
    QFrag qf[HD / 16];
    load_q_frags<T, HD>(qf, sm.Q, warp);

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k_start = kt * BK;
        __syncthreads();  // every warp is done with the previous tile
        load_tile<T, HD, LD>(sm.K, kbase, kv_stride, k_start, Skv);
        load_tile<T, HD, LD>(sm.V, vbase, kv_stride, k_start, Skv);
        __syncthreads();

        const bool interior =
            interior_tile(q_start, k_start, Sq, Skv, causal, window);
        fold_tile<T, HD>(qf, sm, warp, lane, scale, interior,
                         [&](int col) {
                             return keeps(pos_q, k_start + col, Sq, Skv,
                                          causal, window);
                         },
                         st);
    }

    if (pos_q < Sq) {
        T* orow = o + (((size_t)b * Sq + pos_q) * H + h) * HD + half * OC;
#pragma unroll
        for (int c = 0; c < OC; ++c) orow[c] = from_float<T>(st.acc[c] / st.l);
        // The row logsumexp in the units of the scaled logits, which the
        // backward kernels recompute P = exp(S * scale - lse) in.
        if (lse != nullptr && half == 0) {
            lse[(size_t)bh * Sq + pos_q] = st.m + logf(st.l);
        }
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Skv, int H, int KV, int causal, int window,
           cudaStream_t stream) {
    const size_t smem = Layout<T, HD>::bytes();
    auto kern = flash_prefill_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Sq + BQ - 1) / BQ, B * H);
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Skv, H, KV,
        causal, window, (float)(1.0 / sqrt((double)HD)));
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int D, const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Sq, int Skv, int H, int KV, int causal,
                int window, cudaStream_t s) {
    switch (D) {
        case 32: return launch<T, 32>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, s);
        case 64: return launch<T, 64>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, s);
        case 128: return launch<T, 128>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Skv, KV, D], out [B, Sq, H, D]; all
// contiguous, bf16 (is_bf16 = 1) or f32. lse: f32 [B, H, Sq], the row
// logsumexp of the scaled logits, or null for none. Returns
// cudaGetLastError().
extern "C" int istpu_flash_prefill(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int is_bf16,
                                   int B, int Sq, int Skv, int H, int KV,
                                   int D, int causal, int window,
                                   void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
        return dispatch_hd<__nv_bfloat16>(D, q, k, v, out, lse, B, Sq, Skv,
                                          H, KV, causal, window, s);
    }
    return dispatch_hd<float>(D, q, k, v, out, lse, B, Sq, Skv, H, KV,
                              causal, window, s);
}
