// The split-K paged attention kernel's entry points over pages of q's
// type: K2 (one-token decode) and K3 (m-token verify). The kernel, its
// design and what it replaces are in paged_split.cuh.
#include "paged_split.cuh"

// Both entry points: k/v pages [N, P, KV, D]; page_table int32 [B,
// max_pages] (ids clamped into the pool); q and out in the same type,
// bf16 (is_bf16 = 1) or f32, D a multiple of 8 up to 256, 16-byte
// aligned; all contiguous. scale: the softmax scale (D^-0.5). The split
// plan (ops/paged_split.py): row_tile (16, 32, 48 or 64) query rows a
// CTA, n_splits runs of pages_per_split pages covering window_span's
// pages; with n_splits > 1, ws_ml (float2 [B, KV, n_splits, m * H /
// KV]) and ws_acc (f32 [..., D]) are the merge's workspace. Return
// cudaGetLastError().

// q/out [B, H, D]; seq_lens int32 [B]: tokens including the current one.
extern "C" int istpu_paged_decode(const void* q, const void* k_pages,
                                  const void* v_pages, const void* page_table,
                                  const void* seq_lens, void* out,
                                  void* ws_ml, void* ws_acc, int is_bf16,
                                  int B, int H, int KV, int D, float scale,
                                  int N, int P, int max_pages, int window,
                                  int row_tile, int n_splits,
                                  int pages_per_split, void* stream) {
    Args a{q, k_pages, v_pages, nullptr, nullptr,
           static_cast<const int*>(page_table),
           static_cast<const int*>(seq_lens), out,
           static_cast<float2*>(ws_ml), static_cast<float*>(ws_acc),
           B, 1, H, KV, D, N, P, max_pages, window, -1, 0.0f,
           row_tile, n_splits, pages_per_split,
           static_cast<cudaStream_t>(stream)};
    return run<0>(a, is_bf16, scale);
}

// q/out [B, m, H, D]; seq_lens int32 [B]: tokens in the cache before the
// m new ones, whose KV is already in the pages.
extern "C" int istpu_paged_verify(const void* q, const void* k_pages,
                                  const void* v_pages, const void* page_table,
                                  const void* seq_lens, void* out,
                                  void* ws_ml, void* ws_acc, int is_bf16,
                                  int B, int m, int H, int KV, int D,
                                  float scale, int N, int P, int max_pages,
                                  int window, int row_tile, int n_splits,
                                  int pages_per_split, void* stream) {
    Args a{q, k_pages, v_pages, nullptr, nullptr,
           static_cast<const int*>(page_table),
           static_cast<const int*>(seq_lens), out,
           static_cast<float2*>(ws_ml), static_cast<float*>(ws_acc),
           B, m, H, KV, D, N, P, max_pages, window, 0, 0.0f,
           row_tile, n_splits, pages_per_split,
           static_cast<cudaStream_t>(stream)};
    return run<0>(a, is_bf16, scale);
}
