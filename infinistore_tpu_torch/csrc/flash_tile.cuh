// Tile code shared by the f32 tile-loop flash prefill (flash_prefill.cu)
// and flash backward (flash_bwd_dq.cu, flash_bwd_dkv.cu) kernels; bf16
// takes the wgmma kernels at every head dim.
// A CTA of 4 warps owns 64 rows, 16 per warp, staged in shared memory
// with the tiles of TK rows it is folding (TK = 64, or 32 at hd 256, so
// that the tiles fit in the 227 KB one block may use). The tile products
// are plain FMA loops, so f32 stays true f32 (no TF32). Softmax
// arithmetic is f32 in registers, two lanes per row, with -1e30 as the
// masked logit. HD is the kernels' compile-time capacity;
// the tensors' own head dim D (a multiple of 8, at most HD) strides the
// rows in device memory, columns at or past D are staged as zero and
// never stored. The dense kernels (K1, K5, K6) share one
// live-tile range, one interior rule and one mask, so the forward and
// the backward can never disagree on which (query, key) pairs count; the
// bf16 wgmma kernels (their own TMA tiles) take the ranges and the
// interior rule at their tile sizes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace istpu {
namespace tile {

constexpr int BQ = 64;  // query rows per CTA: 4 warps x 16 rows
constexpr int BK = 64;  // kv rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

template <typename T, int HD>
struct Layout {
    static_assert(sizeof(T) == 4, "the tile loop is the f32 route");
    // Rows of the tiles a CTA walks over (keys; q rows in K6).
    static constexpr int TK = HD > 128 ? 32 : BK;
    // Row strides (elements) of the shared tiles, padded against bank
    // conflicts while keeping every row 16-byte aligned; the f32 scratch
    // holds S [16 x TK], the P / dS tile [16 x TK].
    static constexpr int LD = HD + 4;
    static constexpr int SLD = TK + 4;
    static constexpr int PLD = TK + 4;
    static constexpr size_t kTile = sizeof(T) * BQ * LD;       // 64 rows
    static constexpr size_t kWalkTile = sizeof(T) * TK * LD;   // TK rows
    static constexpr size_t kScratch = sizeof(float) * WARPS * 16 * SLD;
    static constexpr size_t kP = sizeof(T) * WARPS * 16 * PLD;
    static constexpr size_t bytes() {
        return kTile + 2 * kWalkTile + kScratch + kP;
    }
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
        V = K + L::TK * L::LD;
        S = reinterpret_cast<float*>(V + L::TK * L::LD);
        P = reinterpret_cast<T*>(S + WARPS * 16 * L::SLD);
    }
};

// One warp's online-softmax state: row r = lane / 2 of its 16, columns
// [half * TK / 2, +TK / 2) of S and [half * HD / 2, +HD / 2) of O.
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

// Fold the staged K/V tile starting at kv position k_start into the
// warp's rows, in f32 FMA loops (the f32 prefill; bf16 takes the wgmma
// kernel at every head dim). ok(col) says whether this lane's row keeps
// kv column col of the tile; it is asked only when !interior.
template <typename T, int HD, typename Mask>
__device__ __forceinline__ void fold_tile(const Smem<T, HD>& sm, int warp,
                                          int lane, float scale,
                                          bool interior, Mask ok,
                                          RowState<HD>& st) {
    using L = Layout<T, HD>;
    constexpr int TK = L::TK, LD = L::LD, SLD = L::SLD, PLD = L::PLD;
    constexpr int SC = TK / 2;  // S columns held by one lane
    constexpr int OC = HD / 2;  // output columns held by one lane
    const int r = lane >> 1;
    const int half = lane & 1;
    float* Sw = sm.S + warp * 16 * SLD;
    T* Pw = sm.P + warp * 16 * PLD;

    // ---- S = Q K^T (unscaled) into the warp's scratch ----
    const T* qrow = sm.Q + (warp * 16 + r) * LD;
    for (int j = 0; j < SC; ++j) {
        const T* krow = sm.K + (half * SC + j) * LD;
        float s = 0.0f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
            s = fmaf(to_float(qrow[d]), to_float(krow[d]), s);
        }
        Sw[r * SLD + half * SC + j] = s;
    }
    __syncwarp();

    // ---- online softmax over this lane's SC columns (f32) ----
    float s[SC];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
        const int col = half * SC + j;
        float x = Sw[r * SLD + col] * scale;
        if (!interior && !ok(col)) x = kNegInf;
        s[j] = x;
        mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(st.m, mx);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
        const float p = expf(s[j] - m_new);
        sum += p;
        Pw[r * PLD + half * SC + j] = from_float<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(st.m - m_new);
    st.l = st.l * alpha + sum;
    st.m = m_new;
#pragma unroll
    for (int c = 0; c < OC; ++c) st.acc[c] *= alpha;
    __syncwarp();

    // ---- acc += P V ----
    for (int j = 0; j < TK; ++j) {
        const float p = to_float(Pw[r * PLD + j]);
        const T* vrow = sm.V + j * LD + half * OC;
#pragma unroll
        for (int c = 0; c < OC; ++c) {
            st.acc[c] = fmaf(p, to_float(vrow[c]), st.acc[c]);
        }
    }
    __syncwarp();
}

// Rows [start, start + ROWS) of one head, zero past `n_rows` and in the
// columns at or past D, 16 bytes a thread per step. Rows are
// `row_stride` elements apart in global memory.
template <typename T, int HD, int LD, int ROWS = BK>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          size_t row_stride, int start,
                                          int n_rows, int D) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int VPR = HD / VEC;
    for (int i = threadIdx.x; i < ROWS * VPR; i += THREADS) {
        const int r = i / VPR;
        const int c = (i % VPR) * VEC;
        const int s = start + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (s < n_rows && c < D) {
            val = *reinterpret_cast<const uint4*>(src + (size_t)s * row_stride + c);
        }
        *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
}

// ---- dense attention geometry (K1, K5, K6) ----
// Query i sees key j when j <= i + (Skv - Sq) under `causal` (a cached
// prefix shifts the diagonal) and, with a window, j > i + (Skv - Sq) -
// window; padded rows and keys see nothing (the JAX package's _tile_mask).
__device__ __forceinline__ bool keeps(int pos_q, int pos_k, int Sq, int Skv,
                                      int causal, int window) {
    bool ok = pos_k < Skv && pos_q < Sq;
    if (causal) {
        const int offset = Skv - Sq;
        ok = ok && pos_k <= pos_q + offset;
        if (window > 0) ok = ok && pos_k > pos_q + offset - window;
    }
    return ok;
}

// The range and the interior rule take the tile (TQ query rows by TK
// keys) as template arguments, by default the 64 x 64 tiles above.

// The live kv tiles [begin, end) of the q tile at q_start: none past the
// last row's diagonal, none wholly below the first row's window floor.
template <int TQ = BQ, int TK = BK>
__device__ __forceinline__ void kv_tiles(int q_start, int Sq, int Skv,
                                         int causal, int window, int& begin,
                                         int& end) {
    const int offset = Skv - Sq;
    const int q_last = min(q_start + TQ, Sq) - 1;
    end = (Skv + TK - 1) / TK;
    begin = 0;
    if (causal) {
        end = min(end, (q_last + offset) / TK + 1);
        if (window > 0) {
            begin = max(q_start + offset - window + 1, 0) / TK;
        }
    }
}

// The mirror image, for the kv tile at k_start: the live q tiles
// [begin, end). None above the first one whose last row reaches the
// tile's first key, none past the last one whose first row still has the
// tile's last key inside its window (the JAX package's _q_idx and the
// dk/dv kernel's `live`).
template <int TQ = BQ, int TK = BK>
__device__ __forceinline__ void q_tiles(int k_start, int Sq, int Skv,
                                        int causal, int window, int& begin,
                                        int& end) {
    const int offset = Skv - Sq;
    end = (Sq + TQ - 1) / TQ;
    begin = 0;
    if (causal) {
        begin = max(k_start - offset, 0) / TQ;
        if (window > 0) {
            const int last = k_start + TK - 1 - offset + window - 1;
            end = last < 0 ? 0 : min(end, last / TQ + 1);
        }
    }
}

// True when every (query, key) pair of the tile is kept: no mask needed.
template <int TQ = BQ, int TK = BK>
__device__ __forceinline__ bool interior_tile(int q_start, int k_start,
                                              int Sq, int Skv, int causal,
                                              int window) {
    bool interior = (k_start + TK <= Skv) && (q_start + TQ <= Sq);
    if (causal) {
        const int offset = Skv - Sq;
        interior = interior && (k_start + TK - 1 <= q_start + offset);
        if (window > 0) {
            interior = interior &&
                       (k_start > q_start + TQ - 1 + offset - window);
        }
    }
    return interior;
}

// ---- backward tiles (K5, K6) ----

template <typename T, int HD>
struct BwdLayout {
    using L = Layout<T, HD>;
    // The CTA's own two 64-row tiles, the two TK-row tiles it walks
    // over, each warp's f32 scratch and its P / dS tile, and two row
    // vectors (lse and D) of up to 64 floats.
    static constexpr size_t bytes() {
        return 2 * L::kTile + 2 * L::kWalkTile + L::kScratch + L::kP +
               2 * sizeof(float) * BQ;
    }
};

// own: the CTA's 64-row tiles (Q and dO in K5, K and V in K6); walk: the
// TK-row tiles it loops over (K and V in K5, Q and dO in K6).
template <typename T, int HD>
struct BwdSmem {
    T* own[2];
    T* walk[2];
    float* S;
    T* P;
    float* lse;
    float* D;

    __device__ explicit BwdSmem(unsigned char* base) {
        using L = Layout<T, HD>;
        own[0] = reinterpret_cast<T*>(base);
        own[1] = own[0] + BQ * L::LD;
        walk[0] = own[1] + BQ * L::LD;
        walk[1] = walk[0] + L::TK * L::LD;
        S = reinterpret_cast<float*>(walk[1] + L::TK * L::LD);
        P = reinterpret_cast<T*>(S + WARPS * 16 * L::SLD);
        lse = reinterpret_cast<float*>(P + WARPS * 16 * L::PLD);
        D = lse + BQ;
    }
};

// Sw[16 x TK] = A[16 x HD] B^T for one warp, with FMA: A's 16 rows and
// B's TK rows both `LD` apart in shared memory (lane: row lane / 2,
// columns [half * TK / 2, +TK / 2)).
template <typename T, int HD>
__device__ __forceinline__ void abt(const T* A, const T* B, float* Sw,
                                    int lane) {
    using L = Layout<T, HD>;
    constexpr int TK = L::TK, LD = L::LD, SLD = L::SLD;
    const int r = lane >> 1, half = lane & 1;
    const T* arow = A + r * LD;
    for (int j = 0; j < TK / 2; ++j) {
        const T* brow = B + (half * TK / 2 + j) * LD;
        float s = 0.0f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
            s = fmaf(to_float(arow[d]), to_float(brow[d]), s);
        }
        Sw[r * SLD + half * TK / 2 + j] = s;
    }
}

// A warp's f32 accumulator of 16 rows x COLS columns (all HD, or one
// half of them): the lane's row lane / 2, columns [half * COLS / 2,
// +COLS / 2).
template <typename T, int HD, int COLS = HD>
struct RowAcc {
    float a[COLS / 2];

    __device__ RowAcc() {
#pragma unroll
        for (int c = 0; c < COLS / 2; ++c) a[c] = 0.0f;
    }

    // acc += Pw[16 x TK] B[TK x COLS]: Pw is the warp's P / dS tile
    // (`PLD` apart), B TK staged rows `LD` apart, from the first column
    // this accumulator holds.
    __device__ __forceinline__ void add_ab(const T* Pw, const T* B,
                                           int lane) {
        using L = Layout<T, HD>;
        constexpr int TK = L::TK, LD = L::LD, PLD = L::PLD;
        const int r = lane >> 1, half = lane & 1;
        for (int j = 0; j < TK; ++j) {
            const float pj = to_float(Pw[r * PLD + j]);
            const T* brow = B + j * LD + half * (COLS / 2);
#pragma unroll
            for (int c = 0; c < COLS / 2; ++c) {
                a[c] = fmaf(pj, to_float(brow[c]), a[c]);
            }
        }
    }

    // Write the lane's half row (row lane / 2 of the warp's 16) to `dst`
    // (its first `cols` of COLS / 2 elements, at column half * COLS / 2
    // of the accumulator's columns: the others lie at or past the
    // tensor's D) if `live`.
    __device__ __forceinline__ void store(T* dst, bool live, int cols) {
        if (live) {
#pragma unroll
            for (int c = 0; c < COLS / 2; ++c) {
                if (c < cols) dst[c] = a[c];
            }
        }
    }
};

}  // namespace tile
}  // namespace istpu
