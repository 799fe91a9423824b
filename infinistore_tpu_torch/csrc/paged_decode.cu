// Paged flash-decode attention (one query token per sequence over its KV
// pages, GQA, optional sliding window) for Hopper, sm_90a.
//
// Replaces: infinistore_tpu/ops/pallas_paged_attention.py::_kernel with
// its fold _attend and page map _make_page_idx (reached through
// paged_flash_decode / decode_attention).
//
// What bounds it on an H100: bytes. Each K/V element read is used for
// 2 * group FLOPs (8 at a GQA group of 4), far below the ~295 FLOP/byte
// balance point, so the least time is the K/V bytes of the pages a
// sequence uses over 3.35 TB/s.
//
// Design. The TPU kernel walks (batch, page) in order with acc/m/l in
// VMEM scratch. Here one CTA owns one (sequence, kv head): it reads its
// own page ids from the table, clamps each into the pool, and walks only
// the pages that hold live tokens (up to (seq_len - 1) / page, and none
// wholly below the window floor max(seq_len - window, 0)); no other
// page is read. The GQA group's query rows stay in registers, up to 8 a
// CTA (4 at hd 256): a larger or odd group is taken in blocks of rows
// (grid.z, paged_decode.cuh's decode_block_rows), each block reading the
// kv head's pages again. Each of the
// 8 warps folds every 8th page into its own f32 online softmax, 4 tokens
// per step (their loads issued together), with warp-reduced dot products
// (each lane holds hd / 32 dims); the warps' partial states merge through
// shared memory at the end. One CTA per (sequence, kv head) fills few
// SMs at small batch (32 of 132 at batch 4 with 8 kv heads): split-K over
// pages with a second reduce pass is the first redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_decode.cuh"

namespace {

using istpu::kNegInf;
using istpu::round_to;
using istpu::to_float;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 4;  // tokens folded per step of a warp

template <typename T, int HD, int G>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp,
                    const int* __restrict__ page_table,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    int H, int KV, int group, int N, int P, int max_pages,
                    int window, float scale) {
    constexpr int EPL = HD / 32;  // head dims held by one lane

    const int kvh = blockIdx.x;
    const int b = blockIdx.y;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int d0 = lane * EPL;
    // This block's query rows: head0 .. head0 + rows - 1.
    const int g0 = blockIdx.z * G;
    const int rows = min(G, group - g0);
    const size_t head0 = (size_t)b * H + kvh * group + g0;

    float qr[G][EPL];
#pragma unroll
    for (int g = 0; g < G; ++g) {
        const T* qrow = q + (head0 + g) * HD + d0;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
            qr[g][e] = g < rows ? to_float(qrow[e]) : 0.0f;
        }
    }

    float m[G], l[G], acc[G][EPL];
#pragma unroll
    for (int g = 0; g < G; ++g) {
        m[g] = kNegInf;
        l[g] = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = 0.0f;
    }

    const int seq_len = seq_lens[b];
    const int low = window > 0 ? max(seq_len - window, 0) : 0;
    const int last_page = seq_len > 0 ? min((seq_len - 1) / P, max_pages - 1) : -1;
    const size_t tok_stride = (size_t)KV * HD;

    for (int j = low / P + warp; j <= last_page; j += WARPS) {
        const int pid = min(max(page_table[(size_t)b * max_pages + j], 0), N - 1);
        const size_t page_off = ((size_t)pid * P * KV + kvh) * HD + d0;
        const int start = j * P;
        const int t_begin = max(low - start, 0);
        const int t_end = min(P, seq_len - start);
        for (int t0 = t_begin; t0 < t_end; t0 += CHUNK) {
            // Issue the chunk's loads together, then fold the chunk with
            // one rescale per row.
            float kv[CHUNK][EPL], vv[CHUNK][EPL];
#pragma unroll
            for (int c = 0; c < CHUNK; ++c) {
                const bool live = t0 + c < t_end;
                const size_t off = page_off + (size_t)(t0 + c) * tok_stride;
#pragma unroll
                for (int e = 0; e < EPL; ++e) {
                    kv[c][e] = live ? to_float(kp[off + e]) : 0.0f;
                    vv[c][e] = live ? to_float(vp[off + e]) : 0.0f;
                }
            }
#pragma unroll
            for (int g = 0; g < G; ++g) {
                float s[CHUNK];
#pragma unroll
                for (int c = 0; c < CHUNK; ++c) {
                    float x = 0.0f;
#pragma unroll
                    for (int e = 0; e < EPL; ++e) x = fmaf(qr[g][e], kv[c][e], x);
                    s[c] = x;
                }
#pragma unroll
                for (int w = 16; w > 0; w >>= 1) {
#pragma unroll
                    for (int c = 0; c < CHUNK; ++c) {
                        s[c] += __shfl_xor_sync(0xffffffffu, s[c], w);
                    }
                }
                float mc = kNegInf;
#pragma unroll
                for (int c = 0; c < CHUNK; ++c) {
                    s[c] *= scale;
                    if (t0 + c < t_end) mc = fmaxf(mc, s[c]);
                }
                const float m_new = fmaxf(m[g], mc);
                const float alpha = expf(m[g] - m_new);
                l[g] *= alpha;
#pragma unroll
                for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
                for (int c = 0; c < CHUNK; ++c) {
                    const float p = t0 + c < t_end ? expf(s[c] - m_new) : 0.0f;
                    l[g] += p;
                    const float pv = round_to<T>(p);
#pragma unroll
                    for (int e = 0; e < EPL; ++e) {
                        acc[g][e] = fmaf(pv, vv[c][e], acc[g][e]);
                    }
                }
                m[g] = m_new;
            }
        }
    }

    istpu::merge_warps_store<T, WARPS, G, HD>(m, l, acc, rows,
                                              out + head0 * HD);
}

template <typename T, int HD, int G>
int launch(const void* q, const void* kp, const void* vp, const int* pt,
           const int* sl, void* o, int B, int H, int KV, int N, int P,
           int max_pages, int window, cudaStream_t stream) {
    const int group = H / KV;
    const dim3 grid(KV, B, (group + G - 1) / G);
    paged_decode_kernel<T, HD, G><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), pt, sl, static_cast<T*>(o), H, KV, group,
        N, P, max_pages, window, (float)(1.0 / sqrt((double)HD)));
    return (int)cudaGetLastError();
}

template <typename T, int HD>
int dispatch_g(const void* q, const void* kp, const void* vp, const int* pt,
               const int* sl, void* o, int B, int H, int KV, int N, int P,
               int mp, int w, cudaStream_t s) {
    switch (istpu::decode_block_rows(H / KV, HD)) {
        case 1: return launch<T, HD, 1>(q, kp, vp, pt, sl, o, B, H, KV, N, P, mp, w, s);
        case 2: return launch<T, HD, 2>(q, kp, vp, pt, sl, o, B, H, KV, N, P, mp, w, s);
        case 4: return launch<T, HD, 4>(q, kp, vp, pt, sl, o, B, H, KV, N, P, mp, w, s);
        default:
            if constexpr (HD <= 128) {
                return launch<T, HD, 8>(q, kp, vp, pt, sl, o, B, H, KV, N, P, mp, w, s);
            }
            return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
int dispatch_hd(int D, const void* q, const void* kp, const void* vp,
                const int* pt, const int* sl, void* o, int B, int H, int KV,
                int N, int P, int mp, int w, cudaStream_t s) {
    switch (D) {
        case 32: return dispatch_g<T, 32>(q, kp, vp, pt, sl, o, B, H, KV, N, P, mp, w, s);
        case 64: return dispatch_g<T, 64>(q, kp, vp, pt, sl, o, B, H, KV, N, P, mp, w, s);
        case 128: return dispatch_g<T, 128>(q, kp, vp, pt, sl, o, B, H, KV, N, P, mp, w, s);
        case 256: return dispatch_g<T, 256>(q, kp, vp, pt, sl, o, B, H, KV, N, P, mp, w, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q [B, H, D]; k/v pages [N, P, KV, D]; page_table int32 [B, max_pages];
// seq_lens int32 [B] (tokens including the current one); out [B, H, D].
// All contiguous, bf16 (is_bf16 = 1) or f32. Returns cudaGetLastError().
extern "C" int istpu_paged_decode(const void* q, const void* k_pages,
                                  const void* v_pages, const void* page_table,
                                  const void* seq_lens, void* out,
                                  int is_bf16, int B, int H, int KV, int D,
                                  int N, int P, int max_pages, int window,
                                  void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* pt = static_cast<const int*>(page_table);
    const int* sl = static_cast<const int*>(seq_lens);
    if (is_bf16) {
        return dispatch_hd<__nv_bfloat16>(D, q, k_pages, v_pages, pt, sl,
                                          out, B, H, KV, N, P, max_pages,
                                          window, s);
    }
    return dispatch_hd<float>(D, q, k_pages, v_pages, pt, sl, out, B, H,
                              KV, N, P, max_pages, window, s);
}
