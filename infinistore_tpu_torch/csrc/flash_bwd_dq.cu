// Flash attention backward, dQ (causal GQA, rectangular diagonal,
// optional sliding window) for Hopper, sm_90a.
//
// Replaces: infinistore_tpu/ops/pallas_flash_attention.py::_bwd_dq_kernel
// (kernel A of _flash_backward, reached through _flash_with_vjp's
// backward).
//
// What bounds it on an H100: operations. Each live (query, key) pair
// costs three products over hd (S = Q K^T recomputed, dP = dO V^T,
// dQ += dS K): at Sq = Skv = 2048, hd = 128, 32 heads and causal, ~5.2e10
// FLOP against ~5e7 bytes of q/k/v/dO/dq, far above the card's ~295
// FLOP/byte balance point, so the tensor cores are the limit (989
// TFLOP/s bf16 dense).
//
// Design. The TPU grid walks the kv blocks innermost with the dq sum in
// VMEM scratch; here one CTA owns one (batch*head, 64-row q tile), holds
// its Q and dO tiles in shared memory and loops over the live kv tiles
// itself, with K1's live range, interior rule and mask (flash_tile.cuh).
// Each of the 4 warps owns 16 query rows: it recomputes S on the tensor
// cores (wmma bf16, f32 accumulation), forms P = exp(S * scale - lse) in
// f32 (masked pairs exactly 0, so padded and fully masked rows add
// nothing), dP = dO V^T, dS = P (dP - D) scale rounded to bf16 as the TPU
// kernel rounds it (ds.astype(k.dtype)), and accumulates dQ += dS K in
// f32 fragments that stay in registers across tiles; dq is written once,
// in q's dtype. The q tiles are taken longest-first so the heavy CTAs of
// the causal triangle start in the first wave. The f32 variant keeps the
// structure with plain FMA loops (no TF32). This is the simple version:
// wmma over synchronous shared-memory loads; wgmma and TMA come later.
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
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec, T* __restrict__ dq,
                    int Sq, int Skv, int H, int KV, int causal, int window,
                    float scale) {
    using L = Layout<T, HD>;
    constexpr int LD = L::LD, SLD = L::SLD, PLD = L::PLD;

    extern __shared__ __align__(128) unsigned char smem[];
    const BwdSmem<T, HD> sm(smem);

    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh % H;
    const int kvh = h / (H / KV);
    const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int r = lane >> 1;
    const int half = lane & 1;

    const size_t q_stride = (size_t)H * HD;
    const size_t kv_stride = (size_t)KV * HD;
    const T* qbase = q + ((size_t)b * Sq * H + h) * HD;
    const T* dobase = dout + ((size_t)b * Sq * H + h) * HD;
    const T* kbase = k + ((size_t)b * Skv * KV + kvh) * HD;
    const T* vbase = v + ((size_t)b * Skv * KV + kvh) * HD;

    load_tile<T, HD, LD>(sm.Q, qbase, q_stride, q_start, Sq);
    load_tile<T, HD, LD>(sm.dO, dobase, q_stride, q_start, Sq);

    int kt_begin, kt_end;
    kv_tiles(q_start, Sq, Skv, causal, window, kt_begin, kt_end);

    const int pos_q = q_start + warp * 16 + r;
    const float row_lse = pos_q < Sq ? lse[(size_t)bh * Sq + pos_q] : 0.0f;
    const float row_d = pos_q < Sq ? dvec[(size_t)bh * Sq + pos_q] : 0.0f;
    float* Sw = sm.S + warp * 16 * SLD;
    T* Pw = sm.P + warp * 16 * PLD;
    const T* Qw = sm.Q + warp * 16 * LD;
    const T* dOw = sm.dO + warp * 16 * LD;
    RowAcc<T, HD> acc;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k_start = kt * BK;
        __syncthreads();  // every warp is done with the previous tile
        load_tile<T, HD, LD>(sm.K, kbase, kv_stride, k_start, Skv);
        load_tile<T, HD, LD>(sm.V, vbase, kv_stride, k_start, Skv);
        __syncthreads();
        const bool interior =
            interior_tile(q_start, k_start, Sq, Skv, causal, window);

        // P = exp(Q K^T * scale - lse), masked pairs exactly 0.
        abt<T, HD>(Qw, sm.K, Sw, lane);
        __syncwarp();
        float p[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int col = half * 32 + j;
            const bool ok = interior || keeps(pos_q, k_start + col, Sq, Skv,
                                              causal, window);
            p[j] = ok ? expf(Sw[r * SLD + col] * scale - row_lse) : 0.0f;
        }
        __syncwarp();

        // dS = P (dO V^T - D) scale, rounded to T for the product.
        abt<T, HD>(dOw, sm.V, Sw, lane);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int col = half * 32 + j;
            Pw[r * PLD + col] =
                from_float<T>(p[j] * (Sw[r * SLD + col] - row_d) * scale);
        }
        __syncwarp();

        // dQ += dS K
        acc.add_ab(Pw, sm.K, lane);
        __syncwarp();
    }

    T* dst = dq + (((size_t)b * Sq + pos_q) * H + h) * HD + half * (HD / 2);
    acc.store(dst, pos_q < Sq, Sw, lane);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* dvec, void* dq, int B, int Sq,
           int Skv, int H, int KV, int causal, int window,
           cudaStream_t stream) {
    const size_t smem = BwdLayout<T, HD>::bytes();
    auto kern = flash_bwd_dq_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Sq + BQ - 1) / BQ, B * H);
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, dvec,
        static_cast<T*>(dq), Sq, Skv, H, KV, causal, window,
        (float)(1.0 / sqrt((double)HD)));
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int D, const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* dvec,
                void* dq, int B, int Sq, int Skv, int H, int KV, int causal,
                int window, cudaStream_t s) {
    switch (D) {
        case 32: return launch<T, 32>(q, k, v, dout, lse, dvec, dq, B, Sq, Skv, H, KV, causal, window, s);
        case 64: return launch<T, 64>(q, k, v, dout, lse, dvec, dq, B, Sq, Skv, H, KV, causal, window, s);
        case 128: return launch<T, 128>(q, k, v, dout, lse, dvec, dq, B, Sq, Skv, H, KV, causal, window, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q/dout/dq [B, Sq, H, D], k/v [B, Skv, KV, D], bf16 (is_bf16 = 1) or
// f32; lse (the forward's row logsumexp of the scaled logits) and dvec
// (rowsum(dO * O)) f32 [B, H, Sq]; all contiguous. Returns
// cudaGetLastError().
extern "C" int istpu_flash_bwd_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* dvec,
                                  void* dq, int is_bf16, int B, int Sq,
                                  int Skv, int H, int KV, int D, int causal,
                                  int window, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
        return dispatch_hd<__nv_bfloat16>(D, q, k, v, dout, lse, dvec, dq, B,
                                          Sq, Skv, H, KV, causal, window, s);
    }
    return dispatch_hd<float>(D, q, k, v, dout, lse, dvec, dq, B, Sq, Skv, H,
                              KV, causal, window, s);
}
