// Paged flash verify attention (m new tokens per sequence over their KV
// pages, GQA, a causal limit per token, optional sliding window) for
// Hopper, sm_90a: speculative verify and chunked prefill.
//
// Replaces: infinistore_tpu/ops/pallas_paged_attention.py::_kernel_multi
// with its fold _attend and page map _make_page_idx(tok_offset=m)
// (reached through paged_flash_verify / verify_attention).
//
// What bounds it on an H100: it depends on m. A kv head's query rows
// are its m x group (token, group member) pairs, and each K/V element
// read serves 2 FLOPs per row. At speculative verify (m = 5, group 4:
// 20 rows) that is ~20 FLOP per byte, far below the card's ~295
// FLOP/byte balance point: bound by bytes, the K/V pages read once per
// kv head. At a 512-token chunk (2048 rows) it is ~2000 FLOP per byte:
// bound by the tensor cores.
//
// Design. The TPU kernel walks (batch, page) in order with acc/m/l in
// VMEM scratch, over query rows laid out kv-head-major and padded to its
// 128-lane tiles. Here one CTA owns one (sequence, kv head, tile of 64
// query rows) and loops over kv tiles of 64 positions (32 for f32 at hd
// 256, so that the tiles fit in shared memory) itself, reading q
// and writing the output in the public [B, m, H, D] layout. A kv head's
// rows are taken token-major (row = token * group + member), so a tile's
// rows have neighbouring causal limits and its kv range is tight: from
// the window floor of its lowest row to the limit of its highest, never
// past the table's end. Each K and V row is gathered through
// page_table[b, pos / P] (clamped into the pool, as the TPU kernel
// clamps it), 16 bytes a thread, so any page size works. Only tiles on
// a row's limit or floor build a mask. The fold (wmma bf16 S = Q K^T and
// P V with f32 accumulation, f32 online softmax; plain FMA for f32) is
// the flash prefill kernel's (flash_tile.cuh). A row with no position
// to attend (its window floor at or past the table's end: only padding
// rows of a batch can be such rows) gets finite values. At small m the
// grid is small (64 CTAs at batch 8, m = 5, 8 kv heads) and 44 of each
// tile's 64 rows are padding: split-K over pages and smaller row tiles
// are the next steps.
#include <climits>
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
paged_verify_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp,
                    const int* __restrict__ page_table,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    int m, int H, int KV, int N, int P, int max_pages,
                    int window, float scale) {
    using L = Layout<T, HD>;
    constexpr int TK = L::TK, LD = L::LD;
    constexpr int OC = HD / 2;  // output columns held by one lane
    constexpr int VEC = 16 / sizeof(T);
    constexpr int VPR = HD / VEC;  // 16-byte vectors per row

    extern __shared__ __align__(128) unsigned char smem[];
    const Smem<T, HD> sm(smem);

    const int G = H / KV;
    const int R = m * G;  // query rows of one kv head
    const int r0 = blockIdx.x * BQ;
    const int kvh = blockIdx.y;
    const int b = blockIdx.z;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int seq_len = seq_lens[b];
    const int t_end = max_pages * P;  // positions the table covers
    const int* table = page_table + (size_t)b * max_pages;
    const size_t q_tok = (size_t)H * HD;

    // Q rows: row r is token r / G, query head kvh * G + r % G; zero
    // past R.
    for (int i = threadIdx.x; i < BQ * VPR; i += THREADS) {
        const int rr = i / VPR;
        const int c = (i % VPR) * VEC;
        const int row = r0 + rr;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row < R) {
            const T* src = q + ((size_t)b * m + row / G) * q_tok +
                           (size_t)(kvh * G + row % G) * HD + c;
            val = *reinterpret_cast<const uint4*>(src);
        }
        *reinterpret_cast<uint4*>(sm.Q + rr * LD + c) = val;
    }

    // The tile's kv range: from its lowest row's window floor to its
    // highest row's limit (token j sees positions < seq_len + j + 1),
    // never past the table.
    const int j_lo = r0 / G;
    const int j_hi = (min(r0 + BQ, R) - 1) / G;
    const int hi = min(seq_len + j_hi + 1, t_end);
    const int lo = window > 0 ? max(seq_len + j_lo + 1 - window, 0) : 0;
    const int kt_begin = lo / TK;
    const int kt_end = (hi + TK - 1) / TK;
    // A tile below every row's limit and at or above every row's floor
    // needs no mask.
    const int lim_lo = min(seq_len + j_lo + 1, t_end);
    const int floor_hi = window > 0 ? seq_len + j_hi + 1 - window : INT_MIN;

    // This lane's row; rows past R (never written) act as the last one.
    const int row = r0 + warp * 16 + (lane >> 1);
    const int limit = seq_len + min(row, R - 1) / G + 1;
    const int low = window > 0 ? limit - window : 0;
    const size_t kv_tok = (size_t)KV * HD;
    RowState<HD> st;

    __syncthreads();
    QRegs<T, HD> qf;
    qf.load(sm.Q, warp);

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k_start = kt * TK;
        __syncthreads();  // every warp is done with the previous tile
        for (int i = threadIdx.x; i < TK * VPR; i += THREADS) {
            const int rr = i / VPR;
            const int c = (i % VPR) * VEC;
            const int pos = k_start + rr;
            uint4 kval = make_uint4(0u, 0u, 0u, 0u);
            uint4 vval = kval;
            if (pos < hi) {
                const int pid = min(max(table[pos / P], 0), N - 1);
                const size_t off =
                    ((size_t)pid * P + pos % P) * kv_tok + (size_t)kvh * HD + c;
                kval = *reinterpret_cast<const uint4*>(kp + off);
                vval = *reinterpret_cast<const uint4*>(vp + off);
            }
            *reinterpret_cast<uint4*>(sm.K + rr * LD + c) = kval;
            *reinterpret_cast<uint4*>(sm.V + rr * LD + c) = vval;
        }
        __syncthreads();

        const bool interior = k_start + TK <= lim_lo && k_start >= floor_hi;
        fold_tile<T, HD>(qf, sm, warp, lane, scale, interior,
                         [&](int col) {
                             const int pos = k_start + col;
                             return pos < limit && pos < t_end && pos >= low;
                         },
                         st);
    }

    if (row < R) {
        T* orow = out + ((size_t)b * m + row / G) * q_tok +
                  (size_t)(kvh * G + row % G) * HD + (lane & 1) * OC;
#pragma unroll
        for (int c = 0; c < OC; ++c) {
            orow[c] = from_float<T>(st.l > 0.0f ? st.acc[c] / st.l : 0.0f);
        }
    }
}

template <typename T, int HD>
int launch(const void* q, const void* kp, const void* vp, const int* pt,
           const int* sl, void* o, int B, int m, int H, int KV, int N,
           int P, int max_pages, int window, cudaStream_t stream) {
    const size_t smem = Layout<T, HD>::bytes();
    auto kern = paged_verify_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int rows = m * (H / KV);
    const dim3 grid((rows + BQ - 1) / BQ, KV, B);
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), pt, sl, static_cast<T*>(o), m, H, KV, N,
        P, max_pages, window, (float)(1.0 / sqrt((double)HD)));
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int D, const void* q, const void* kp, const void* vp,
                const int* pt, const int* sl, void* o, int B, int m, int H,
                int KV, int N, int P, int mp, int w, cudaStream_t s) {
    switch (D) {
        case 32: return launch<T, 32>(q, kp, vp, pt, sl, o, B, m, H, KV, N, P, mp, w, s);
        case 64: return launch<T, 64>(q, kp, vp, pt, sl, o, B, m, H, KV, N, P, mp, w, s);
        case 128: return launch<T, 128>(q, kp, vp, pt, sl, o, B, m, H, KV, N, P, mp, w, s);
        case 256: return launch<T, 256>(q, kp, vp, pt, sl, o, B, m, H, KV, N, P, mp, w, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q [B, m, H, D]; k/v pages [N, P, KV, D]; page_table int32 [B,
// max_pages]; seq_lens int32 [B] (tokens in the cache before the m new
// ones, whose KV is already in the pages); out [B, m, H, D]. All
// contiguous, bf16 (is_bf16 = 1) or f32. Returns cudaGetLastError().
extern "C" int istpu_paged_verify(const void* q, const void* k_pages,
                                  const void* v_pages, const void* page_table,
                                  const void* seq_lens, void* out,
                                  int is_bf16, int B, int m, int H, int KV,
                                  int D, int N, int P, int max_pages,
                                  int window, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* pt = static_cast<const int*>(page_table);
    const int* sl = static_cast<const int*>(seq_lens);
    if (is_bf16) {
        return dispatch_hd<__nv_bfloat16>(D, q, k_pages, v_pages, pt, sl, out,
                                          B, m, H, KV, N, P, max_pages,
                                          window, s);
    }
    return dispatch_hd<float>(D, q, k_pages, v_pages, pt, sl, out, B, m, H,
                              KV, N, P, max_pages, window, s);
}
