// Paged flash-decode attention over INT8 pages (one query token per
// sequence over its KV pages, GQA, optional sliding window) for Hopper,
// sm_90a.
//
// Replaces: infinistore_tpu/ops/pallas_paged_attention.py::_kernel_q with
// its fold _attend and page map _make_page_idx (reached through
// paged_flash_decode_quantized / decode_attention_quantized).
//
// Pages are int8 [N, P, KV, D] with one f32 scale per (token, kv head)
// [N, P, KV] (ops/kv_quant.py). The fold is float32 throughout, as in the
// TPU kernel (its _attend gets f32 q and dequantized f32 K/V): q in f32,
// logits (q . k_int8) * k_scale * hd^-0.5, f32 online softmax, and P . V
// with P NOT rounded to q's type (K2 rounds P to bf16 on bf16 inputs; K4
// must not, or it would compute another function). The output is cast to
// q's type.
//
// What bounds it on an H100: bytes. Each live token costs KV * (2 * D + 2
// * 4) bytes (int8 K and V plus their scales), 0.53x K2's bf16 bytes, for
// 2 * group FLOPs per K/V element: far below the ~295 FLOP/byte balance
// point, so the least time is those bytes over 3.35 TB/s.
//
// Design: the walk of K2's first port (one CTA per sequence and kv head;
// K2 now runs the split-K kernel of paged_split.cu), with int8 loads.
// HD is the compile-time capacity; the tensors' own head dim D strides
// the pages and rows, and lanes whose dims lie past D add nothing and
// store nothing. One CTA owns one (sequence, kv head, block of up to 8 query
// rows of its GQA group, 4 at hd 256) and reads its own page ids from the table, clamps each into
// the pool, and walks only the pages that hold live tokens (up to
// (seq_len - 1) / page, and none wholly below the window floor
// max(seq_len - window, 0)). Each of the 8 warps folds every 8th page,
// 4 tokens a step with their loads issued together; a lane holds HD / 32
// dims, so at HD = 128 its 4 int8 values of one token are one 32-bit load
// (converted to float without I2F, see load_i8).
// The token's scale is one f32 that every lane of the warp reads (one
// broadcast load) and multiplies in after the warp-reduced dot product
// (K) or into P (V). The warps' partial states merge through shared
// memory at the end. One CTA per (sequence, kv head) fills few SMs at
// small batch: moving onto the split-K kernel, with int8 loads, is its
// redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_decode.cuh"

namespace {

using istpu::kNegInf;
using istpu::to_float;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = 4;  // tokens folded per step of a warp

// A lane's N consecutive int8 values as floats, in one load. The
// conversion avoids I2F, a quarter-rate instruction on sm_90: each byte,
// biased by 128 (xor 0x80), is placed by one byte permute in the low
// mantissa bits of 2^23, and one add of -(2^23 + 128) gives the value
// exactly.
__device__ __forceinline__ float i8_biased_to_float(uint32_t w, uint32_t sel) {
    return __uint_as_float(__byte_perm(w, 0x4B000000u, sel)) - 8388736.0f;
}

template <int N>
__device__ __forceinline__ void load_i8(const int8_t* p, float (&out)[N]);
template <>
__device__ __forceinline__ void load_i8<4>(const int8_t* p, float (&out)[4]) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
    out[0] = i8_biased_to_float(w, 0x7650);
    out[1] = i8_biased_to_float(w, 0x7651);
    out[2] = i8_biased_to_float(w, 0x7652);
    out[3] = i8_biased_to_float(w, 0x7653);
}
template <>
__device__ __forceinline__ void load_i8<2>(const int8_t* p, float (&out)[2]) {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
    out[0] = i8_biased_to_float(w, 0x7650);
    out[1] = i8_biased_to_float(w, 0x7651);
}
template <>
__device__ __forceinline__ void load_i8<1>(const int8_t* p, float (&out)[1]) {
    out[0] = *p;
}
template <>
__device__ __forceinline__ void load_i8<8>(const int8_t* p, float (&out)[8]) {
    float lo[4], hi[4];
    load_i8<4>(p, lo);
    load_i8<4>(p + 4, hi);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        out[e] = lo[e];
        out[4 + e] = hi[e];
    }
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(THREADS)
paged_decode_q_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                      const float* __restrict__ ks,
                      const int8_t* __restrict__ vq,
                      const float* __restrict__ vs,
                      const int* __restrict__ page_table,
                      const int* __restrict__ seq_lens, T* __restrict__ out,
                      int H, int KV, int D, int group, int N, int P,
                      int max_pages, int window, float scale) {
    constexpr int EPL = HD / 32;  // head dims held by one lane

    const int kvh = blockIdx.x;
    const int b = blockIdx.y;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int d0 = lane * EPL;
    // D is a multiple of 8, so a lane's dims lie wholly below D or at or
    // past it. A lane past D reads dims [0, EPL) of each token (valid
    // memory, no branch in the walk) against a zero q, so its dot product
    // adds nothing, and its acc is never stored.
    const bool live_dims = d0 < D;
    const int d_ld = live_dims ? d0 : 0;
    // This block's query rows: head0 .. head0 + rows - 1.
    const int g0 = blockIdx.z * G;
    const int rows = min(G, group - g0);
    const size_t head0 = (size_t)b * H + kvh * group + g0;

    float qr[G][EPL];
#pragma unroll
    for (int g = 0; g < G; ++g) {
        const T* qrow = q + (head0 + g) * D + d0;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
            qr[g][e] = g < rows && live_dims ? to_float(qrow[e]) : 0.0f;
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
    const size_t tok_stride = (size_t)KV * D;

    for (int j = low / P + warp; j <= last_page; j += WARPS) {
        const int pid = min(max(page_table[(size_t)b * max_pages + j], 0), N - 1);
        const size_t tok0 = (size_t)pid * P;  // the page's first token row
        const size_t page_off = (tok0 * KV + kvh) * D + d_ld;
        const size_t scale_off = tok0 * KV + kvh;
        const int start = j * P;
        const int t_begin = max(low - start, 0);
        const int t_end = min(P, seq_len - start);
        for (int t0 = t_begin; t0 < t_end; t0 += CHUNK) {
            // Issue the chunk's loads together, then fold the chunk with
            // one rescale per row.
            float kv[CHUNK][EPL], vv[CHUNK][EPL], ksc[CHUNK], vsc[CHUNK];
#pragma unroll
            for (int c = 0; c < CHUNK; ++c) {
                const int t = t0 + c;
                if (t < t_end) {
                    load_i8<EPL>(kq + page_off + (size_t)t * tok_stride, kv[c]);
                    load_i8<EPL>(vq + page_off + (size_t)t * tok_stride, vv[c]);
                    ksc[c] = ks[scale_off + (size_t)t * KV];
                    vsc[c] = vs[scale_off + (size_t)t * KV];
                } else {
#pragma unroll
                    for (int e = 0; e < EPL; ++e) kv[c][e] = vv[c][e] = 0.0f;
                    ksc[c] = vsc[c] = 0.0f;
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
                    s[c] *= ksc[c] * scale;
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
                    const float pv = p * vsc[c];  // f32: not rounded to T
#pragma unroll
                    for (int e = 0; e < EPL; ++e) {
                        acc[g][e] = fmaf(pv, vv[c][e], acc[g][e]);
                    }
                }
                m[g] = m_new;
            }
        }
    }

    istpu::merge_warps_store<T, WARPS, G, HD>(m, l, acc, rows, D,
                                              out + head0 * D);
}

struct Args {
    const void* q;
    const int8_t* kq;
    const float* ks;
    const int8_t* vq;
    const float* vs;
    const int* pt;
    const int* sl;
    void* out;
    int B, H, KV, D, N, P, max_pages, window;
    float scale;
    cudaStream_t stream;
};

template <typename T, int HD, int G>
int launch(const Args& a) {
    const int group = a.H / a.KV;
    const dim3 grid(a.KV, a.B, (group + G - 1) / G);
    paged_decode_q_kernel<T, HD, G><<<grid, THREADS, 0, a.stream>>>(
        static_cast<const T*>(a.q), a.kq, a.ks, a.vq, a.vs, a.pt, a.sl,
        static_cast<T*>(a.out), a.H, a.KV, a.D, group, a.N, a.P,
        a.max_pages, a.window, a.scale);
    return (int)cudaGetLastError();
}

template <typename T, int HD>
int dispatch_g(const Args& a) {
    switch (istpu::decode_block_rows(a.H / a.KV, HD)) {
        case 1: return launch<T, HD, 1>(a);
        case 2: return launch<T, HD, 2>(a);
        case 4: return launch<T, HD, 4>(a);
        default:
            if constexpr (HD <= 128) return launch<T, HD, 8>(a);
            return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
int dispatch_hd(const Args& a) {
    switch (istpu::head_dim_capacity(a.D)) {
        case 32: return dispatch_g<T, 32>(a);
        case 64: return dispatch_g<T, 64>(a);
        case 128: return dispatch_g<T, 128>(a);
        case 256: return dispatch_g<T, 256>(a);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q [B, H, D] (bf16 if is_bf16, else f32); k_q / v_q int8 [N, P, KV, D],
// 4-byte aligned, D a multiple of 8 up to 256; k_s / v_s f32 [N, P, KV];
// page_table int32 [B, max_pages]; seq_lens int32 [B] (tokens including
// the current one); scale: the softmax scale (D^-0.5); out [B, H, D] in
// q's type. All contiguous. Returns cudaGetLastError().
extern "C" int istpu_paged_decode_q(const void* q, const void* k_q,
                                    const void* k_s, const void* v_q,
                                    const void* v_s, const void* page_table,
                                    const void* seq_lens, void* out,
                                    int is_bf16, int B, int H, int KV, int D,
                                    float scale, int N, int P, int max_pages,
                                    int window, void* stream) {
    const Args a{q,
                 static_cast<const int8_t*>(k_q),
                 static_cast<const float*>(k_s),
                 static_cast<const int8_t*>(v_q),
                 static_cast<const float*>(v_s),
                 static_cast<const int*>(page_table),
                 static_cast<const int*>(seq_lens),
                 out, B, H, KV, D, N, P, max_pages, window, scale,
                 static_cast<cudaStream_t>(stream)};
    if (is_bf16) return dispatch_hd<__nv_bfloat16>(a);
    return dispatch_hd<float>(a);
}
