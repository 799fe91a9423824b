// The split-K paged attention kernel's entry point over int8 pages: K4,
// one-token decode over int8 K/V pages with one f32 scale per (token, kv
// head) (ops/kv_quant.py), the TPU kernel's f32 fold (q in f32, the
// pages dequantized, P.V with P not rounded to q's type), the output in
// q's type. The kernel, its design and what it replaces are in
// paged_split.cuh.
#include "paged_split.cuh"

// q/out [B, H, D], bf16 (is_bf16 = 1) or f32, 16-byte aligned; k_q / v_q
// int8 [N, P, KV, D], 16-byte aligned, D a multiple of 8 up to 256; k_s /
// v_s f32 [N, P, KV]; page_table int32 [B, max_pages] (ids clamped into
// the pool); seq_lens int32 [B]: tokens including the current one; all
// contiguous. scale: the softmax scale (D^-0.5). The split plan and the
// workspace as for istpu_paged_decode (paged_split.cu). Returns
// cudaGetLastError().
extern "C" int istpu_paged_decode_q(const void* q, const void* k_q,
                                    const void* k_s, const void* v_q,
                                    const void* v_s, const void* page_table,
                                    const void* seq_lens, void* out,
                                    void* ws_ml, void* ws_acc, int is_bf16,
                                    int B, int H, int KV, int D, float scale,
                                    int N, int P, int max_pages, int window,
                                    int row_tile, int n_splits,
                                    int pages_per_split, void* stream) {
    Args a{q, k_q, v_q, static_cast<const float*>(k_s),
           static_cast<const float*>(v_s),
           static_cast<const int*>(page_table),
           static_cast<const int*>(seq_lens), out,
           static_cast<float2*>(ws_ml), static_cast<float*>(ws_acc),
           B, 1, H, KV, D, N, P, max_pages, window, -1, 0.0f,
           row_tile, n_splits, pages_per_split,
           static_cast<cudaStream_t>(stream)};
    return run<1>(a, is_bf16, scale);
}
