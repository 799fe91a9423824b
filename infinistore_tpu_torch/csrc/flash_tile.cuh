// Tile code shared by the flash prefill (flash_prefill.cu) and paged
// verify (paged_verify.cu) kernels. A CTA of 4 warps owns 64 query rows,
// 16 per warp, staged in shared memory with the 64-row K and V tile it is
// folding. bf16 runs S = Q K^T and P V on the tensor cores (wmma
// 16x16x16, f32 accumulation); f32 runs plain FMA loops, so f32 stays
// true f32 (no TF32). The online softmax is f32 in registers, two lanes
// per row, with -1e30 as the masked logit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace istpu {
namespace tile {

constexpr int BQ = 64;  // query rows per CTA: 4 warps x 16 rows
constexpr int BK = 64;  // kv rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

using QFrag = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16,
                                     __nv_bfloat16, nvcuda::wmma::row_major>;

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

// The shared-memory regions of one CTA: Q, K and V tiles, each warp's
// f32 scratch and its P tile.
template <typename T, int HD>
struct Smem {
    T* Q;
    T* K;
    T* V;
    float* S;
    T* P;

    __device__ explicit Smem(unsigned char* base) {
        using L = Layout<T, HD>;
        Q = reinterpret_cast<T*>(base);
        K = Q + BQ * L::LD;
        V = K + BK * L::LD;
        S = reinterpret_cast<float*>(V + BK * L::LD);
        P = reinterpret_cast<T*>(S + WARPS * 16 * L::SLD);
    }
};

// S[16 x BK] = Q[16 x HD] K^T for one warp, into its f32 scratch.
template <int HD, int LD, int SLD>
__device__ __forceinline__ void scores_mma(const QFrag (&qf)[HD / 16],
                                           const __nv_bfloat16* Ks,
                                           float* Sw) {
    using namespace nvcuda;
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
__device__ __forceinline__ void pv_mma(const __nv_bfloat16* Pw,
                                       const __nv_bfloat16* Vs, float* Sw) {
    using namespace nvcuda;
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

// One warp's online-softmax state: row r = lane / 2 of its 16, columns
// [half * 32, +32) of S and [half * HD / 2, +HD / 2) of O.
template <int HD>
struct RowState {
    float m = kNegInf;
    float l = 0.0f;
    float acc[HD / 2];

    __device__ RowState() {
#pragma unroll
        for (int c = 0; c < HD / 2; ++c) acc[c] = 0.0f;
    }
};

// The bf16 Q fragments of a warp's 16 rows (unused for f32).
template <typename T, int HD>
__device__ __forceinline__ void load_q_frags(QFrag (&qf)[HD / 16],
                                             const T* Qs, int warp) {
    if constexpr (sizeof(T) == 2) {
        constexpr int LD = Layout<T, HD>::LD;
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
            nvcuda::wmma::load_matrix_sync(
                qf[kk],
                reinterpret_cast<const __nv_bfloat16*>(Qs) + warp * 16 * LD +
                    kk * 16,
                LD);
        }
    }
}

// Fold the staged K/V tile starting at kv position k_start into the
// warp's rows. ok(col) says whether this lane's row keeps kv column col
// of the tile; it is asked only when !interior.
template <typename T, int HD, typename Mask>
__device__ __forceinline__ void fold_tile(const QFrag (&qf)[HD / 16],
                                          const Smem<T, HD>& sm, int warp,
                                          int lane, float scale,
                                          bool interior, Mask ok,
                                          RowState<HD>& st) {
    using L = Layout<T, HD>;
    constexpr int LD = L::LD, SLD = L::SLD, PLD = L::PLD;
    constexpr int OC = HD / 2;  // output columns held by one lane
    const int r = lane >> 1;
    const int half = lane & 1;
    float* Sw = sm.S + warp * 16 * SLD;
    T* Pw = sm.P + warp * 16 * PLD;

    // ---- S = Q K^T (unscaled) into the warp's scratch ----
    if constexpr (sizeof(T) == 2) {
        scores_mma<HD, LD, SLD>(
            qf, reinterpret_cast<const __nv_bfloat16*>(sm.K), Sw);
    } else {
        const T* qrow = sm.Q + (warp * 16 + r) * LD;
        for (int j = 0; j < 32; ++j) {
            const T* krow = sm.K + (half * 32 + j) * LD;
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
    float s[32];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
        const int col = half * 32 + j;
        float x = Sw[r * SLD + col] * scale;
        if (!interior && !ok(col)) x = kNegInf;
        s[j] = x;
        mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(st.m, mx);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
        const float p = expf(s[j] - m_new);
        sum += p;
        Pw[r * PLD + half * 32 + j] = from_float<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(st.m - m_new);
    st.l = st.l * alpha + sum;
    st.m = m_new;
#pragma unroll
    for (int c = 0; c < OC; ++c) st.acc[c] *= alpha;
    __syncwarp();

    // ---- acc += P V ----
    if constexpr (sizeof(T) == 2) {
        pv_mma<HD, LD, SLD, PLD>(
            reinterpret_cast<const __nv_bfloat16*>(Pw),
            reinterpret_cast<const __nv_bfloat16*>(sm.V), Sw);
        __syncwarp();
#pragma unroll
        for (int c = 0; c < OC; ++c) st.acc[c] += Sw[r * SLD + half * OC + c];
    } else {
        for (int j = 0; j < BK; ++j) {
            const float p = to_float(Pw[r * PLD + j]);
            const T* vrow = sm.V + j * LD + half * OC;
#pragma unroll
            for (int c = 0; c < OC; ++c) {
                st.acc[c] = fmaf(p, to_float(vrow[c]), st.acc[c]);
            }
        }
    }
    __syncwarp();
}

}  // namespace tile
}  // namespace istpu
