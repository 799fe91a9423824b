// Flash prefill attention (causal GQA, rectangular diagonal, optional
// sliding window) for Hopper, sm_90a.
//
// Replaces: infinistore_tpu/ops/pallas_flash_attention.py::_kernel (the
// forward, reached through _forward_impl / flash_prefill_attention).
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
// boundary and ragged tiles build a mask, with -1e30 as the masked logit.
// The f32 variant keeps the same structure with plain FMA loops, so f32
// stays true f32 (no TF32). This is the simple version: wmma over
// synchronous shared-memory loads; wgmma, TMA and a pipelined ring of
// tiles are the next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using istpu::from_float;
using istpu::kNegInf;
using istpu::to_float;

constexpr int BQ = 64;  // query rows per CTA: 4 warps x 16 rows
constexpr int BK = 64;  // kv rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

template <typename T, int HD>
struct Layout {
    // Row strides (elements) of the shared tiles, padded against bank
    // conflicts while keeping every wmma pointer 32-byte aligned.
    static constexpr int LD = HD + (sizeof(T) == 2 ? 8 : 4);
    static constexpr int SLD = (HD > BK ? HD : BK) + 4;  // f32 scratch
    static constexpr int PLD = BK + (sizeof(T) == 2 ? 8 : 4);
    static constexpr size_t kTile = sizeof(T) * BQ * LD;
    static constexpr size_t kScratch = sizeof(float) * WARPS * 16 * SLD;
    static constexpr size_t kP = sizeof(T) * WARPS * 16 * PLD;
    static constexpr size_t bytes() { return 3 * kTile + kScratch + kP; }
};

// Rows [start, start + 64) of one head, zero past `n_rows`, 16 bytes a
// thread per step. Rows are `row_stride` elements apart in global memory.
template <typename T, int HD, int LD>
__device__ void load_tile(T* dst, const T* src, size_t row_stride,
                          int start, int n_rows) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int VPR = HD / VEC;
    for (int i = threadIdx.x; i < BK * VPR; i += THREADS) {
        const int r = i / VPR;
        const int c = (i % VPR) * VEC;
        const int s = start + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (s < n_rows) {
            val = *reinterpret_cast<const uint4*>(src + (size_t)s * row_stride + c);
        }
        *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
}

// S[16 x BK] = Q[16 x HD] K^T for one warp, into its f32 scratch.
template <int HD, int LD, int SLD>
__device__ void scores_mma(
    const wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> (&qf)[HD / 16],
    const __nv_bfloat16* Ks, float* Sw) {
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
        wmma::fill_fragment(sf, 0.0f);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            // K^T as a col-major B: element (k, n) sits at K[n][k].
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major> kf;
            wmma::load_matrix_sync(kf, Ks + n * 16 * LD + kk * 16, LD);
            wmma::mma_sync(sf, qf[kk], kf, sf);
        }
        wmma::store_matrix_sync(Sw + n * 16, sf, SLD, wmma::mem_row_major);
    }
}

// O-partial[16 x HD] = P[16 x BK] V for one warp, into its f32 scratch.
template <int HD, int LD, int SLD, int PLD>
__device__ void pv_mma(const __nv_bfloat16* Pw, const __nv_bfloat16* Vs,
                       float* Sw) {
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
        wmma::fill_fragment(of, 0.0f);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> pf;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> vf;
            wmma::load_matrix_sync(pf, Pw + kk * 16, PLD);
            wmma::load_matrix_sync(vf, Vs + kk * 16 * LD + n * 16, LD);
            wmma::mma_sync(of, pf, vf, of);
        }
        wmma::store_matrix_sync(Sw + n * 16, of, SLD, wmma::mem_row_major);
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Sq,
                     int Skv, int H, int KV, int causal, int window,
                     float scale) {
    using L = Layout<T, HD>;
    constexpr int LD = L::LD, SLD = L::SLD, PLD = L::PLD;
    constexpr int OC = HD / 2;  // output columns held by one lane
    constexpr bool kBf16 = sizeof(T) == 2;

    extern __shared__ __align__(128) unsigned char smem[];
    T* Qs = reinterpret_cast<T*>(smem);
    T* Ks = Qs + BQ * LD;
    T* Vs = Ks + BK * LD;
    float* Sbuf = reinterpret_cast<float*>(Vs + BK * LD);
    T* Pbuf = reinterpret_cast<T*>(Sbuf + WARPS * 16 * SLD);

    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh % H;
    const int kvh = h / (H / KV);
    const int q_start = blockIdx.x * BQ;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int offset = Skv - Sq;  // a cached prefix shifts the diagonal

    const size_t q_stride = (size_t)H * HD;
    const size_t kv_stride = (size_t)KV * HD;
    const T* qbase = q + ((size_t)b * Sq * H + h) * HD;
    const T* kbase = k + ((size_t)b * Skv * KV + kvh) * HD;
    const T* vbase = v + ((size_t)b * Skv * KV + kvh) * HD;

    load_tile<T, HD, LD>(Qs, qbase, q_stride, q_start, Sq);

    // Live kv tiles: none past the last row's diagonal, none wholly
    // below the first row's window floor.
    const int q_last = min(q_start + BQ, Sq) - 1;
    int kt_end = (Skv + BK - 1) / BK;
    int kt_begin = 0;
    if (causal) {
        kt_end = min(kt_end, (q_last + offset) / BK + 1);
        if (window > 0) {
            kt_begin = max(q_start + offset - window + 1, 0) / BK;
        }
    }

    // Lane layout for the softmax and the output: row r of the warp's
    // 16, columns [half * 32, +32) of S and [half * OC, +OC) of O.
    const int r = lane >> 1;
    const int half = lane & 1;
    const int pos_q = q_start + warp * 16 + r;
    float* Sw = Sbuf + warp * 16 * SLD;
    T* Pw = Pbuf + warp * 16 * PLD;
    float m_i = kNegInf;
    float l_i = 0.0f;
    float acc[OC];
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[c] = 0.0f;

    __syncthreads();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
        qf[kBf16 ? HD / 16 : 1];
    if constexpr (kBf16) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            wmma::load_matrix_sync(
                qf[kk],
                reinterpret_cast<const __nv_bfloat16*>(Qs) + warp * 16 * LD + kk * 16,
                LD);
        }
    }

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k_start = kt * BK;
        __syncthreads();  // every warp is done with the previous tile
        load_tile<T, HD, LD>(Ks, kbase, kv_stride, k_start, Skv);
        load_tile<T, HD, LD>(Vs, vbase, kv_stride, k_start, Skv);
        __syncthreads();

        // ---- S = Q K^T (unscaled) into the warp's scratch ----
        if constexpr (kBf16) {
            scores_mma<HD, LD, SLD>(
                qf, reinterpret_cast<const __nv_bfloat16*>(Ks), Sw);
        } else {
            const T* qrow = Qs + (warp * 16 + r) * LD;
            for (int j = 0; j < 32; ++j) {
                const T* krow = Ks + (half * 32 + j) * LD;
                float s = 0.0f;
#pragma unroll 8
                for (int d = 0; d < HD; ++d) {
                    s = fmaf(to_float(qrow[d]), to_float(krow[d]), s);
                }
                Sw[r * SLD + half * 32 + j] = s;
            }
        }
        __syncwarp();

        // ---- online softmax over this lane's 32 columns (f32) ----
        bool interior = (k_start + BK <= Skv) && (q_start + BQ <= Sq);
        if (causal) {
            interior = interior && (k_start + BK - 1 <= q_start + offset);
            if (window > 0) {
                interior = interior &&
                           (k_start > q_start + BQ - 1 + offset - window);
            }
        }
        float s[32];
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int col = half * 32 + j;
            float x = Sw[r * SLD + col] * scale;
            if (!interior) {
                const int pos_k = k_start + col;
                bool ok = pos_k < Skv && pos_q < Sq;
                if (causal) {
                    ok = ok && pos_k <= pos_q + offset;
                    if (window > 0) ok = ok && pos_k > pos_q + offset - window;
                }
                if (!ok) x = kNegInf;
            }
            s[j] = x;
            mx = fmaxf(mx, x);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        const float m_new = fmaxf(m_i, mx);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const float p = expf(s[j] - m_new);
            sum += p;
            Pw[r * PLD + half * 32 + j] = from_float<T>(p);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        const float alpha = expf(m_i - m_new);
        l_i = l_i * alpha + sum;
        m_i = m_new;
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[c] *= alpha;
        __syncwarp();

        // ---- acc += P V ----
        if constexpr (kBf16) {
            pv_mma<HD, LD, SLD, PLD>(
                reinterpret_cast<const __nv_bfloat16*>(Pw),
                reinterpret_cast<const __nv_bfloat16*>(Vs), Sw);
            __syncwarp();
#pragma unroll
            for (int c = 0; c < OC; ++c) acc[c] += Sw[r * SLD + half * OC + c];
        } else {
            for (int j = 0; j < BK; ++j) {
                const float p = to_float(Pw[r * PLD + j]);
                const T* vrow = Vs + j * LD + half * OC;
#pragma unroll
                for (int c = 0; c < OC; ++c) {
                    acc[c] = fmaf(p, to_float(vrow[c]), acc[c]);
                }
            }
        }
        __syncwarp();
    }

    if (pos_q < Sq) {
        T* orow = o + (((size_t)b * Sq + pos_q) * H + h) * HD + half * OC;
#pragma unroll
        for (int c = 0; c < OC; ++c) orow[c] = from_float<T>(acc[c] / l_i);
    }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KV, int causal, int window,
           cudaStream_t stream) {
    const size_t smem = Layout<T, HD>::bytes();
    auto kern = flash_prefill_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Sq + BQ - 1) / BQ, B * H);
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KV,
        causal, window, (float)(1.0 / sqrt((double)HD)));
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int D, const void* q, const void* k, const void* v, void* o,
                int B, int Sq, int Skv, int H, int KV, int causal,
                int window, cudaStream_t s) {
    switch (D) {
        case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, KV, causal, window, s);
        case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, KV, causal, window, s);
        case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, KV, causal, window, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Skv, KV, D], out [B, Sq, H, D]; all
// contiguous, bf16 (is_bf16 = 1) or f32. Returns cudaGetLastError().
extern "C" int istpu_flash_prefill(const void* q, const void* k,
                                   const void* v, void* out, int is_bf16,
                                   int B, int Sq, int Skv, int H, int KV,
                                   int D, int causal, int window,
                                   void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
        return dispatch_hd<__nv_bfloat16>(D, q, k, v, out, B, Sq, Skv, H, KV,
                                          causal, window, s);
    }
    return dispatch_hd<float>(D, q, k, v, out, B, Sq, Skv, H, KV, causal,
                              window, s);
}
