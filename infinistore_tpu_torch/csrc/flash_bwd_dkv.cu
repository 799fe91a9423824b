// Flash attention backward, dK and dV (causal GQA, rectangular diagonal,
// optional sliding window) for Hopper, sm_90a.
//
// Replaces: infinistore_tpu/ops/pallas_flash_attention.py::_bwd_dkv_kernel
// and the GQA sum after it (kernel B of _flash_backward, reached through
// _flash_with_vjp's backward).
//
// What bounds it on an H100: operations. Each live (query, key) pair
// costs four products over hd (S^T = K Q^T recomputed, dP^T = V dO^T,
// dV += P^T dO, dK += dS^T Q): at Sq = Skv = 2048, hd = 128, 32 heads and
// causal, ~6.9e10 FLOP against ~5e7 bytes, far above the card's ~295
// FLOP/byte balance point, so the tensor cores are the limit (989
// TFLOP/s bf16 dense).
//
// Design. The TPU kernel runs one grid row per q head with the q blocks
// innermost, writes per-head [B*H, Skv, D] dk/dv and leaves the sum over
// each GQA group to XLA. Here one CTA owns one (batch*kv head, 64-row kv
// tile): it stages its K and V tiles once, then loops over the group's q
// heads and, for each, over the live q tiles (flash_tile.cuh's q_tiles,
// the mirror of K1's kv range), staging Q, dO and their lse and D rows.
// Each of the 4 warps owns 16 kv rows and works in the transposed frame:
// S^T = K Q^T on the tensor cores (wmma bf16, f32 accumulation), P^T =
// exp(S^T * scale - lse) in f32 (masked pairs exactly 0), dV += P^T dO,
// dP^T = V dO^T, dS^T = P^T (dP^T - D) scale, dK += dS^T Q. P and dS are
// rounded to bf16 before their products, as the TPU kernel rounds them.
// dK and dV sum the whole group in f32 fragments held in registers, so
// the group sum needs no atomics and no f32 intermediate in device
// memory, and each is written once per kv head, in k's dtype. A kv row no
// query sees (past a window, or a tile with no live q tile) gets exactly
// zero. The f32 variant keeps the structure with plain FMA loops (no
// TF32). This is the simple version: wmma over synchronous shared-memory
// loads; wgmma and TMA come later.
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
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Skv, int H, int KV,
                     int causal, int window, float scale) {
    using L = Layout<T, HD>;
    constexpr int LD = L::LD, SLD = L::SLD, PLD = L::PLD;

    extern __shared__ __align__(128) unsigned char smem[];
    const BwdSmem<T, HD> sm(smem);

    const int bkv = blockIdx.y;
    const int b = bkv / KV;
    const int kvh = bkv % KV;
    const int G = H / KV;
    const int k_start = blockIdx.x * BK;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int r = lane >> 1;
    const int half = lane & 1;

    const size_t q_stride = (size_t)H * HD;
    const size_t kv_stride = (size_t)KV * HD;
    const T* kbase = k + ((size_t)b * Skv * KV + kvh) * HD;
    const T* vbase = v + ((size_t)b * Skv * KV + kvh) * HD;
    load_tile<T, HD, LD>(sm.K, kbase, kv_stride, k_start, Skv);
    load_tile<T, HD, LD>(sm.V, vbase, kv_stride, k_start, Skv);

    int qt_begin, qt_end;
    q_tiles(k_start, Sq, Skv, causal, window, qt_begin, qt_end);

    const int pos_k = k_start + warp * 16 + r;
    float* Sw = sm.S + warp * 16 * SLD;
    T* Pw = sm.P + warp * 16 * PLD;
    const T* Kw = sm.K + warp * 16 * LD;
    const T* Vw = sm.V + warp * 16 * LD;
    RowAcc<T, HD> dk_acc;
    RowAcc<T, HD> dv_acc;

    for (int g = 0; g < G; ++g) {
        const int h = kvh * G + g;
        const T* qbase = q + ((size_t)b * Sq * H + h) * HD;
        const T* dobase = dout + ((size_t)b * Sq * H + h) * HD;
        const float* lse_h = lse + ((size_t)b * H + h) * Sq;
        const float* d_h = dvec + ((size_t)b * H + h) * Sq;
        for (int qt = qt_begin; qt < qt_end; ++qt) {
            const int q_start = qt * BQ;
            __syncthreads();  // every warp is done with the previous tile
            load_tile<T, HD, LD>(sm.Q, qbase, q_stride, q_start, Sq);
            load_tile<T, HD, LD>(sm.dO, dobase, q_stride, q_start, Sq);
            if (threadIdx.x < BQ) {
                const int pq = q_start + threadIdx.x;
                sm.lse[threadIdx.x] = pq < Sq ? lse_h[pq] : 0.0f;
                sm.D[threadIdx.x] = pq < Sq ? d_h[pq] : 0.0f;
            }
            __syncthreads();
            const bool interior =
                interior_tile(q_start, k_start, Sq, Skv, causal, window);

            // P^T = exp(K Q^T * scale - lse), masked pairs exactly 0.
            abt<T, HD>(Kw, sm.Q, Sw, lane);
            __syncwarp();
            float p[32];
#pragma unroll
            for (int j = 0; j < 32; ++j) {
                const int col = half * 32 + j;
                const bool ok = interior || keeps(q_start + col, pos_k, Sq,
                                                  Skv, causal, window);
                p[j] = ok ? expf(Sw[r * SLD + col] * scale - sm.lse[col])
                          : 0.0f;
                Pw[r * PLD + col] = from_float<T>(p[j]);
            }
            __syncwarp();

            // dV += P^T dO
            dv_acc.add_ab(Pw, sm.dO, lane);
            __syncwarp();

            // dS^T = P^T (V dO^T - D) scale, rounded to T for the product.
            abt<T, HD>(Vw, sm.dO, Sw, lane);
            __syncwarp();
#pragma unroll
            for (int j = 0; j < 32; ++j) {
                const int col = half * 32 + j;
                Pw[r * PLD + col] = from_float<T>(
                    p[j] * (Sw[r * SLD + col] - sm.D[col]) * scale);
            }
            __syncwarp();

            // dK += dS^T Q
            dk_acc.add_ab(Pw, sm.Q, lane);
            __syncwarp();
        }
    }

    const size_t row = (((size_t)b * Skv + pos_k) * KV + kvh) * HD +
                       half * (HD / 2);
    dk_acc.store(dk + row, pos_k < Skv, Sw, lane);
    dv_acc.store(dv + row, pos_k < Skv, Sw, lane);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* dvec, void* dk, void* dv, int B,
           int Sq, int Skv, int H, int KV, int causal, int window,
           cudaStream_t stream) {
    const size_t smem = BwdLayout<T, HD>::bytes();
    auto kern = flash_bwd_dkv_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Skv + BK - 1) / BK, B * KV);
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, dvec,
        static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, KV, causal,
        window, (float)(1.0 / sqrt((double)HD)));
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int D, const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* dvec,
                void* dk, void* dv, int B, int Sq, int Skv, int H, int KV,
                int causal, int window, cudaStream_t s) {
    switch (D) {
        case 32: return launch<T, 32>(q, k, v, dout, lse, dvec, dk, dv, B, Sq, Skv, H, KV, causal, window, s);
        case 64: return launch<T, 64>(q, k, v, dout, lse, dvec, dk, dv, B, Sq, Skv, H, KV, causal, window, s);
        case 128: return launch<T, 128>(q, k, v, dout, lse, dvec, dk, dv, B, Sq, Skv, H, KV, causal, window, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q/dout [B, Sq, H, D], k/v/dk/dv [B, Skv, KV, D], bf16 (is_bf16 = 1) or
// f32; lse and dvec f32 [B, H, Sq] (see istpu_flash_bwd_dq); all
// contiguous. dk and dv are summed over each kv head's group of q heads.
// Returns cudaGetLastError().
extern "C" int istpu_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* dvec,
                                   void* dk, void* dv, int is_bf16, int B,
                                   int Sq, int Skv, int H, int KV, int D,
                                   int causal, int window, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
        return dispatch_hd<__nv_bfloat16>(D, q, k, v, dout, lse, dvec, dk,
                                          dv, B, Sq, Skv, H, KV, causal,
                                          window, s);
    }
    return dispatch_hd<float>(D, q, k, v, dout, lse, dvec, dk, dv, B, Sq,
                              Skv, H, KV, causal, window, s);
}
