// Paged attention split over the pages (split-K) for Hopper, sm_90a: m
// query tokens per sequence over their KV pages (decode: m = 1;
// speculative verify; a chunk of chunked prefill), GQA, a causal limit
// per token, optional sliding window; the pages in q's type, or int8 with
// one f32 scale per (token, kv head). The kernels and their launch; the
// entry points are paged_split.cu (K2, K3) and paged_split_q.cu (K4).
//
// Replaces: infinistore_tpu/ops/pallas_paged_attention.py::_kernel (K2,
// one-token decode, reached through paged_flash_decode /
// decode_attention), ::_kernel_multi (K3, m-token verify, reached
// through paged_flash_verify / verify_attention) and ::_kernel_q (K4,
// one-token decode over int8 pages, reached through
// paged_flash_decode_quantized / decode_attention_quantized), with their
// fold _attend and page map _make_page_idx. Decode is verify at m = 1
// over seq_lens - 1: K2's and K4's seq_lens count the current token,
// K3's do not, and token j of m sees the positions below seq_len + j + 1
// (and, with a window, none below that limit - window).
//
// What bounds it on an H100: bytes, at decode and speculative verify.
// A kv head's query rows are its m x group (token, group member) pairs,
// and each K/V element read serves 4 FLOPs per row: 16 FLOP per byte at
// decode with a group of 4 (32 over int8 pages), ~80 at speculative
// verify (m = 5), far below the card's ~295 FLOP/byte balance point. The
// least time is the K/V of the live pages (with int8, and their scales)
// read once per kv head over 3.35 TB/s. A 512-token chunk (2048 rows)
// does ~8000 FLOP per byte and is bound by the tensor cores.
//
// Design. The TPU kernels walk (sequence, page) in order with acc/m/l in
// VMEM scratch, one grid row per sequence; Hopper blocks run in no order,
// and one CTA per (sequence, kv head) leaves most of the 132 SMs idle at
// small batch (32 CTAs at batch 4 with 8 kv heads) while one CTA walks a
// long sequence alone. Here a CTA owns one (sequence, kv head, tile of
// query rows, split of the page table):
// - The row tile holds all m x group rows of its kv head, token-major
//   (row = token * group + member), padded to a multiple of 16 and capped
//   at 64 (a 512-token chunk takes 64-row tiles), so a kv head's pages
//   are read once per row tile: a GQA group is never read twice.
// - The splits cut the pages into runs of pages_per_split pages, sized by
//   the wrapper from values the host already has (batch, kv heads, row
//   tiles, table width, page size, window, SM count), aiming at two waves
//   of CTAs; a split starts and ends on a page boundary. Without a window
//   they cut the whole table; with one, only the pages the window can
//   span (window_span), from the page of the sequence's window floor,
//   which the CTA finds from seq_lens, so a windowed sequence's splits
//   are not spent below its floor. The CTA walks only
//   the positions of its split that some row of its tile keeps: from the
//   first row's window floor to the last row's causal limit, never past
//   the table's end. A split with no such position writes an empty
//   partial (l = 0) and returns, so splits past a short sequence's last
//   page cost one read of its length.
// - K and V rows are gathered through page_table[pos / page] (pos / page
//   by a multiply-high and one correction, where a division by the
//   run-time page size took ~20 instructions a row: up to 26% of K2's
//   time on an H100), clamped into the pool as the TPU kernel clamps them,
//   16 bytes a thread by
//   cp.async (8 for int8 rows whose head dim is not a multiple of 16)
//   into a ring of shared-memory stages, so the next tiles' loads are in
//   flight while this one folds; any page size works. With int8 pages
//   each stage also holds the tile's K and V scales, 4 bytes a position
//   by cp.async (k_s and v_s are strided by KV in memory). Positions
//   outside the CTA's range, and their scales, and columns at or past D
//   land as zero. The ring has 3 stages, or 2 where three would keep a
//   second CTA off the SM (pages of q's type: 48- and 64-row tiles, f32
//   at hd 256; int8: 128-token tiles at hd 128 with bf16 q, where a
//   third stage, or the bank-spreading pad dropped for a swizzle to make
//   room for one, measured no faster).
// - A stage holds up to kStageBytes of K and V in the page type: over
//   bf16 pages 64 tokens (32 at hd 256); over int8 pages twice as many
//   at a byte, capped at 32 tokens a warp for bf16 q (the registers of S
//   and P: 128 tokens, 4 warps of 32, at hd <= 128) and 16 for f32 q (64
//   tokens and 4 warps at hd 256, where f32 pages give 16 and one warp).
//   A tile of int8 tokens costs the fold's fixed steps (barrier, softmax,
//   shuffles) once for twice the tokens of a bf16 tile.
// - The warps split the tile: 16 rows each, and along the tile's tokens
//   when the rows are few (decode: 4 warps of 16 tokens of a 64-token
//   tile), each warp with its own f32 online softmax, merged through
//   shared memory in a fixed order at the end.
// - bf16 q folds on the tensor cores: S = Q K^T and O += P V on mma.sync
//   m16n8k16 with f32 accumulation, the softmax in exp2 of logits
//   prescaled by scale * log2(e). Over bf16 pages the operands come by
//   ldmatrix (V transposed) and P is rounded to bf16 in registers as the
//   A fragments of P V (as the TPU kernel rounds p.astype(v.dtype)). Over
//   int8 pages each lane builds its B fragments from the int8 tile:
//   widening int8 to bf16 is exact (|k| <= 127 fits bf16's 8-bit
//   significand), so each product with q is exact in f32 and S is the
//   TPU kernel's f32 HIGHEST product up to the order of the sum. For S a
//   k-step's 16 dims are taken in another order, the same in Q's A
//   fragment, so that a lane's 4 K values (2 per register) are 4 adjacent
//   bytes; for P V a lane loads 4 dims of each of its 4 tokens, transposes
//   the 16 bytes by byte permutes, and the n index of V's fragment runs
//   over dims in the order 32 dg + 4 g + j (the merge writes acc back in
//   dim order). Each token's column of S takes its k scale, and P' = p *
//   v_s (f32) goes into P V as two bf16 parts, hi = bf16(P') and lo =
//   bf16(P' - hi), two mma each: about 1e-5 of P' is lost where one
//   rounding of P to bf16 would lose 3e-3 and compute another function
//   (the TPU kernel's P V is f32). f32 q folds with FMA (no TF32), a lane
//   a token for S and a lane a column (int8: CPL adjacent columns, one
//   load) for P V, over the warp's rows in blocks of 4, skipping the
//   blocks that hold only padding: the fold is latency-bound (1-4 warps a
//   CTA, 1-2 CTAs an SM by shared memory), and a block's 4 independent
//   chains overlap where rows one at a time did not (1.3-2.2x across
//   chip_smoke's f32 cases). Int8 values are widened in registers by a
//   byte permute and one add (no I2F, a quarter-rate instruction).
// - A masked position's p is exactly 0, so a row with no position in a
//   split has l = 0 and acc = 0. Each CTA writes its rows' partial (the
//   max m in log2 units, the sum l and the unnormalised acc[D], f32) to a
//   workspace the wrapper allocates, and a second small kernel, launched
//   from the same entry point, merges the splits of each row in split
//   order (the same output on every run; four splits' loads in flight at
//   a time, since a serial walk over the splits cost 7 us a launch at
//   decode), skipping every split with l = 0; a row no split kept comes
//   out 0. With one split the CTA writes the normalised row itself and
//   no merge runs.
// HD is the compile-time capacity (32, 64, 128 or 256); the tensors' own
// head dim D, a multiple of 8, strides the pages and rows, and the
// softmax scale comes from the caller (D^-0.5 of the real D).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using istpu::from_float;
using istpu::kNegInf;

constexpr int kStageBytes = 32768;  // K and V of one tile, unpadded

// The pages' element type: q's (T), or int8 with I8.
template <typename T, int I8>
struct PageOf {
    using type = T;
};
template <typename T>
struct PageOf<T, 1> {
    using type = int8_t;
};

template <int N>
struct Int {
    static constexpr int value = N;
};

// Two CTAs fit an SM's 227 KB of shared memory at this many bytes each
// (the 1 KB each CTA reserves counted).
constexpr int kTwoCtaBytes = 232448 / 2 - 1024;

template <typename T, int HD, int RW, int I8>
struct Cfg {
    using PT = typename PageOf<T, I8>::type;
    static constexpr bool kMma = sizeof(T) == 2;
    static constexpr int RT = RW * 16;            // query rows of a CTA
    static constexpr int QVEC = 16 / sizeof(T);   // q elements in 16 bytes
    static constexpr int VEC = 16 / sizeof(PT);   // page elements in 16
    // Warps along the tile's tokens where the rows are few.
    static constexpr int WK_ROWS = RW >= 3 ? 1 : 4 / RW;
    // Tokens a tile: what kStageBytes holds of K and V in the page type,
    // capped: bf16 q at 64 over bf16 pages and at 32 a warp over int8
    // pages (the registers of S and P), f32 q at 16 a warp (a lane a
    // token).
    static constexpr int TK_FIT = kStageBytes / (2 * HD * (int)sizeof(PT));
    static constexpr int TK_CAP =
        kMma ? (I8 ? 32 * WK_ROWS : 64) : 16 * WK_ROWS;
    static constexpr int TK = TK_FIT < TK_CAP ? TK_FIT : TK_CAP;
    static constexpr int WK = WK_ROWS < TK / 16 ? WK_ROWS : TK / 16;
    static constexpr int TKW = TK / WK;  // tokens a warp folds per tile
    static_assert(kMma || TKW == 16, "f32: a lane a token");
    static constexpr int WARPS = RW * WK;
    static constexpr int THREADS = WARPS * 32;
    static constexpr int LDQ = HD + QVEC;  // smem row strides: 16-byte pad
    static constexpr int LD = HD + VEC;
    static constexpr int Q_BYTES = RT * LDQ * (int)sizeof(T);
    static constexpr int RANGE_BYTES = 2 * RT * 4;  // rows' [lo, hi)
    static constexpr int TILE = TK * LD;  // elements of a K or V tile
    // A stage: the K tile, the V tile, then (int8) k_s[TK] and v_s[TK].
    static constexpr int STAGE_BYTES =
        2 * TILE * (int)sizeof(PT) + (I8 ? 2 * TK * 4 : 0);
    // Stages of the ring: 3, or 2 where a CTA's Q or a tile is large, so
    // that two CTAs fit an SM (pages of q's type: 48- and 64-row tiles,
    // f32 at hd 256; int8: where three stages would not fit).
    static constexpr int STAGES =
        I8 ? (Q_BYTES + RANGE_BYTES + 3 * STAGE_BYTES <= kTwoCtaBytes ? 3
                                                                      : 2)
           : (RW >= 3 || (sizeof(T) == 4 && HD == 256) ? 2 : 3);
    static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
    // Each warp's m, l and acc rows for the merge, over the ring.
    static constexpr int MERGE_BYTES = WK * RT * (HD + 2) * 4;
    static constexpr int BYTES =
        Q_BYTES + RANGE_BYTES +
        (RING_BYTES > MERGE_BYTES ? RING_BYTES : MERGE_BYTES);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// N bytes (16, 8 or 4) from global to shared memory, asynchronously;
// with ok false nothing is read and N zero bytes are written.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
    if constexpr (N == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
                     : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                     :: "r"(smem_u32(dst)), "l"(src), "n"(N),
                        "r"(ok ? N : 0)
                     : "memory");
    }
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)) : "memory");
}

// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// Four int8 values (the bytes of w, lowest first) as floats, exactly and
// without I2F: each byte, biased by 128 (xor 0x80), is placed by a byte
// permute in the low mantissa bits of 2^23, and one add of -(2^23 + 128)
// gives its value.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* out) {
    w ^= 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        out[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 + i)) -
                 8388736.0f;
    }
}

// Four int8 values as two bf16 pairs (lo: values 0, 1; hi: 2, 3). A value
// below 2^8 in magnitude has at most 8 significant bits, so its f32's
// upper 16 bits are its bf16, exactly.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
    float f[4];
    i8x4_to_f32(w, f);
    lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// A 4 x 4 byte matrix, a row a word, transposed: byte i of r[j] becomes
// byte j of r[i].
__device__ __forceinline__ void transpose_bytes(uint32_t (&r)[4]) {
    const uint32_t s0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t s1 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t s2 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t s3 = __byte_perm(r[2], r[3], 0x7362);
    r[0] = __byte_perm(s0, s1, 0x5410);
    r[1] = __byte_perm(s0, s1, 0x7632);
    r[2] = __byte_perm(s2, s3, 0x5410);
    r[3] = __byte_perm(s2, s3, 0x7632);
}

// N adjacent int8 values (N = 1, 2, 4 or 8; p aligned to N) as floats.
template <int N>
__device__ __forceinline__ void load_i8(const int8_t* p, float (&out)[N]) {
    if constexpr (N == 1) {
        out[0] = *p;
    } else if constexpr (N == 2) {
        float f[4];
        i8x4_to_f32(*reinterpret_cast<const uint16_t*>(p), f);
        out[0] = f[0];
        out[1] = f[1];
    } else if constexpr (N == 4) {
        i8x4_to_f32(*reinterpret_cast<const uint32_t*>(p), out);
    } else {
        const uint2 w = *reinterpret_cast<const uint2*>(p);
        i8x4_to_f32(w.x, out);
        i8x4_to_f32(w.y, out + 4);
    }
}

// The positions [lo, hi) that query row `row` keeps within the split
// [s_lo, s_hi): token row / group sees the positions below base + token
// + 1 (base: seq_len, less one at decode), none below that limit less
// the window, none past the table's end t_end. Padding rows keep none.
__device__ __forceinline__ void row_range(int row, int R, int group,
                                          int base, int window, int t_end,
                                          int s_lo, int s_hi, int& lo,
                                          int& hi) {
    if (row >= R) {
        lo = hi = 0;
        return;
    }
    const int limit = base + row / group + 1;
    hi = min(min(limit, t_end), s_hi);
    lo = max(window > 0 ? max(limit - window, 0) : 0, s_lo);
}

struct Args {
    const void* q;
    const void* kp;
    const void* vp;
    const float* ks;  // int8 pages: f32 [N, P, KV] scales; else null
    const float* vs;
    const int* table;
    const int* seq_lens;
    void* out;
    float2* ws_ml;  // [B, KV, splits, R]: (m, l); null with one split
    float* ws_acc;  // [B, KV, splits, R, D]
    int B, m, H, KV, D, N, P, max_pages, window;
    int len_offset;  // -1 at decode (seq_lens count the current token)
    float scale_log2;
    int row_tile, n_splits, pages_per_split;
    cudaStream_t stream;
};

// One warp's online-softmax state over its 16 rows. bf16 q (mma
// layout): lane holds rows g = lane / 4 and g + 8 (h = 0, 1), and of
// each 8-column block nt the columns 8 nt + 2 (lane % 4) + {0, 1}:
// acc[nt][2 h + e]. f32 q: lane holds every row r and the columns lane +
// 32 k (int8 pages: lane * HD / 32 + k): acc[r][k].
template <typename T, int HD>
struct WarpState {
    static constexpr bool kMma = sizeof(T) == 2;
    static constexpr int NR = kMma ? 2 : 16;  // rows a lane holds
    float m[NR];
    float l[NR];  // this lane's part of the row sums
    float acc[kMma ? HD / 8 : 16][kMma ? 4 : HD / 32];
};

template <typename T, int HD, int RW, int I8>
__global__ void __launch_bounds__(Cfg<T, HD, RW, I8>::THREADS)
paged_split_kernel(const Args a) {
    using C = Cfg<T, HD, RW, I8>;
    using PT = typename C::PT;
    constexpr int RT = C::RT, TK = C::TK, TKW = C::TKW, LD = C::LD;
    constexpr int LDQ = C::LDQ, WK = C::WK, STAGES = C::STAGES;
    constexpr bool kMma = C::kMma;

    extern __shared__ __align__(16) unsigned char smem[];
    T* const sQ = reinterpret_cast<T*>(smem);
    int* const sLo = reinterpret_cast<int*>(smem + C::Q_BYTES);
    int* const sHi = sLo + RT;
    unsigned char* const ring = smem + C::Q_BYTES + C::RANGE_BYTES;

    const int split = blockIdx.x;
    const int rt = blockIdx.y % (gridDim.y / a.KV);
    const int kvh = blockIdx.y / (gridDim.y / a.KV);
    const int b = blockIdx.z;
    const int group = a.H / a.KV;
    const int R = a.m * group;
    const int r0 = rt * RT;  // the tile's first row of this kv head
    const int r_last = min(r0 + RT, R) - 1;
    const int t_end = a.max_pages * a.P;
    const int base = a.seq_lens[b] + a.len_offset;
    // The splits start at page 0, or with a window at the page of token
    // 0's window floor (the lowest of the sequence's rows).
    const int first_page =
        a.window > 0 ? max(base + 1 - a.window, 0) / a.P : 0;
    const int s_lo = (first_page + split * a.pages_per_split) * a.P;
    const int s_hi = min(s_lo + a.pages_per_split * a.P, t_end);
    const int part = (b * a.KV + kvh) * a.n_splits + split;

    int cta_lo, cta_hi, unused;
    row_range(r0, R, group, base, a.window, t_end, s_lo, s_hi, cta_lo,
              unused);
    row_range(r_last, R, group, base, a.window, t_end, s_lo, s_hi, unused,
              cta_hi);

    const size_t q_tok = (size_t)a.H * a.D;
    // Row r of this kv head in q / out: token r / group, head kvh * group
    // + r % group.
    const auto row_off = [&](int r) {
        return ((size_t)b * a.m + r / group) * q_tok +
               (size_t)(kvh * group + r % group) * a.D;
    };

    if (cta_lo >= cta_hi) {
        // Nothing of this split is kept by any row of the tile.
        for (int i = threadIdx.x; i < RT; i += C::THREADS) {
            if (r0 + i >= R) break;
            if (a.n_splits == 1) {
                T* o = static_cast<T*>(a.out) + row_off(r0 + i);
                for (int c = 0; c < a.D; ++c) o[c] = from_float<T>(0.0f);
            } else {
                a.ws_ml[(size_t)part * R + r0 + i] = make_float2(kNegInf, 0.0f);
            }
        }
        return;
    }

    // ---- Q rows (zero past R and at or past D), with tile 0's group ----
    const T* q = static_cast<const T*>(a.q);
    constexpr int QVPR = HD / C::QVEC;  // 16-byte vectors of a Q row
    for (int i = threadIdx.x; i < RT * QVPR; i += C::THREADS) {
        const int r = i / QVPR;
        const int c = (i % QVPR) * C::QVEC;
        const bool ok = r0 + r < R && c < a.D;
        cp_async<16>(sQ + r * LDQ + c, ok ? q + row_off(r0 + r) + c : q, ok);
    }

    // ---- the ring: tile t holds positions [cta_lo + t TK, + TK) ----
    const PT* kp = static_cast<const PT*>(a.kp);
    const PT* vp = static_cast<const PT*>(a.vp);
    const int* table = a.table + (size_t)b * a.max_pages;
    const size_t kv_tok = (size_t)a.KV * a.D;
    const int n_tiles = (cta_hi - cta_lo + TK - 1) / TK;
    // The pool row (page id * P + offset in the page) of position pos,
    // the page id read from the table and clamped into the pool. pos / P
    // without a division: umulhi(pos, floor((2^32 - 1) / P)) is pos / P
    // or one less.
    const unsigned p_inv = 0xffffffffu / (unsigned)a.P;
    const auto pool_row = [&](int pos) {
        int page = (int)__umulhi((unsigned)pos, p_inv);
        int off = pos - page * a.P;
        if (off >= a.P) {
            ++page;
            off -= a.P;
        }
        return (size_t)min(max(table[page], 0), a.N - 1) * a.P + off;
    };
    const auto stage = [&](int t) {
        return ring + (t % STAGES) * C::STAGE_BYTES;
    };
    const auto load = [&](int t) {
        if (t < n_tiles) {
            PT* const sK = reinterpret_cast<PT*>(stage(t));
            PT* const sV = sK + C::TILE;
            const int pos0 = cta_lo + t * TK;
            // The K and V rows in copies of VB bytes.
            const auto rows = [&](auto vb) {
                constexpr int VB = decltype(vb)::value;
                constexpr int EV = VB / (int)sizeof(PT);  // elements a copy
                constexpr int VPR = HD / EV;
                for (int i = threadIdx.x; i < TK * VPR; i += C::THREADS) {
                    const int r = i / VPR;
                    const int c = (i % VPR) * EV;
                    const int pos = pos0 + r;
                    size_t off = 0;
                    const bool ok = pos < cta_hi && c < a.D;
                    if (ok) {
                        off = pool_row(pos) * kv_tok + (size_t)kvh * a.D + c;
                    }
                    cp_async<VB>(sK + r * LD + c, kp + off, ok);
                    cp_async<VB>(sV + r * LD + c, vp + off, ok);
                }
            };
            if constexpr (I8) {
                // An int8 row is 16-byte aligned only where D is a
                // multiple of 16.
                if (a.D % 16 == 0) {
                    rows(Int<16>());
                } else {
                    rows(Int<8>());
                }
                // k_s then v_s of the tile's positions (0 outside).
                float* const sS = reinterpret_cast<float*>(sV + C::TILE);
                for (int i = threadIdx.x; i < 2 * TK; i += C::THREADS) {
                    const int pos = pos0 + i % TK;
                    size_t off = 0;
                    const bool ok = pos < cta_hi;
                    if (ok) off = pool_row(pos) * a.KV + kvh;
                    cp_async<4>(sS + i, (i < TK ? a.ks : a.vs) + off, ok);
                }
            } else {
                rows(Int<16>());
            }
        }
        cp_async_commit();
    };

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int rw = warp / WK;  // the warp's 16 rows
    const int wk = warp % WK;  // and its TKW tokens of each tile

    // The positions each row of the tile keeps (read after the loop's
    // first barrier), and, for bf16, this lane's two rows' in registers.
    for (int r = threadIdx.x; r < RT; r += C::THREADS) {
        row_range(r0 + r, R, group, base, a.window, t_end, s_lo, s_hi,
                  sLo[r], sHi[r]);
    }
    int lo[2], hi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        row_range(r0 + rw * 16 + lane / 4 + 8 * h, R, group, base, a.window,
                  t_end, s_lo, s_hi, lo[h], hi[h]);
    }
    // The warp's rows that are not padding: the f32 fold skips the rest.
    const int nr = min(max(R - r0 - rw * 16, 0), 16);

    constexpr int NR = WarpState<T, HD>::NR;
    WarpState<T, HD> st;
#pragma unroll
    for (int h = 0; h < NR; ++h) {
        st.m[h] = kNegInf;
        st.l[h] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < (kMma ? HD / 8 : 16); ++i) {
#pragma unroll
        for (int e = 0; e < (kMma ? 4 : HD / 32); ++e) st.acc[i][e] = 0.0f;
    }

    for (int t = 0; t < STAGES - 1; ++t) load(t);

    // bf16 at hd <= 128: the warp's Q fragments stay in registers.
    constexpr bool kQRegs = kMma && HD <= 128;
    uint32_t qa[kQRegs ? HD / 16 : 1][4];

    for (int t = 0; t < n_tiles; ++t) {
        cp_async_wait<STAGES - 2>();  // tile t (and Q) landed
        __syncthreads();              // for every thread; slot t - 1 free
        load(t + STAGES - 1);

        const PT* const sK = reinterpret_cast<const PT*>(stage(t));
        const PT* const sV = sK + C::TILE;
        // The warp's tokens' k scales; their v scales are TK further.
        const float* const sS =
            reinterpret_cast<const float*>(sV + C::TILE) + wk * TKW;
        const int pos0 = cta_lo + t * TK + wk * TKW;  // the warp's first

        if constexpr (kMma) {
            const __nv_bfloat16* const Qw =
                reinterpret_cast<const __nv_bfloat16*>(sQ) + rw * 16 * LDQ;
            const int g = lane / 4, c = lane % 4;
            // Q's A fragment of k-step kk. Over int8 pages the step's 16
            // dims are taken in another order, the same for K's B
            // fragment: its k 2c, 2c + 1 and 2c + 8, 2c + 9 are dims 4c ..
            // 4c + 3, so that a lane's four K values are one 4-byte load.
            const auto q_frag = [&](int kk, uint32_t (&af)[4]) {
                if constexpr (I8) {
                    const __nv_bfloat16* const q0 =
                        Qw + g * LDQ + kk * 16 + 4 * c;
                    const uint2 u0 = *reinterpret_cast<const uint2*>(q0);
                    const uint2 u1 =
                        *reinterpret_cast<const uint2*>(q0 + 8 * LDQ);
                    af[0] = u0.x;
                    af[1] = u1.x;
                    af[2] = u0.y;
                    af[3] = u1.y;
                } else {
                    ldsm_x4(af, Qw + (lane % 16) * LDQ + kk * 16 +
                                    (lane / 16) * 8);
                }
            };
            if constexpr (kQRegs) {
                if (t == 0) {
#pragma unroll
                    for (int kk = 0; kk < HD / 16; ++kk) q_frag(kk, qa[kk]);
                }
            }
            // S = Q K^T: s[nt] is the 16 x 8 block of tokens 8 nt ..
            float s[TKW / 8][4];
#pragma unroll
            for (int nt = 0; nt < TKW / 8; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
            }
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                uint32_t af[4];
                if constexpr (kQRegs) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) af[e] = qa[kk][e];
                } else {
                    q_frag(kk, af);
                }
                if constexpr (I8) {
                    // Token nt * 8 + g's 4 int8 values, widened exactly.
                    const int8_t* const K8 =
                        reinterpret_cast<const int8_t*>(sK) +
                        (wk * TKW + g) * LD + kk * 16 + 4 * c;
#pragma unroll
                    for (int nt = 0; nt < TKW / 8; ++nt) {
                        uint32_t b0, b1;
                        i8x4_to_bf16(*reinterpret_cast<const uint32_t*>(
                                         K8 + nt * 8 * LD),
                                     b0, b1);
                        mma16816(s[nt], af, b0, b1);
                    }
                } else {
                    const __nv_bfloat16* const Kw =
                        reinterpret_cast<const __nv_bfloat16*>(sK) +
                        wk * TKW * LD;
#pragma unroll
                    for (int np = 0; np < TKW / 16; ++np) {
                        uint32_t bf[4];
                        ldsm_x4(bf, Kw + (np * 16 + lane % 8 +
                                          8 * (lane / 16)) * LD +
                                        kk * 16 + 8 * ((lane / 8) % 2));
                        mma16816(s[2 * np], af, bf[0], bf[1]);
                        mma16816(s[2 * np + 1], af, bf[2], bf[3]);
                    }
                }
            }
            // Online softmax in log2 units; masked positions give p = 0.
            // Over int8 pages each token's column takes its k scale.
            float mx[2] = {kNegInf, kNegInf};
#pragma unroll
            for (int nt = 0; nt < TKW / 8; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int h = e / 2;
                    const int tok = nt * 8 + 2 * (lane % 4) + e % 2;
                    const int pos = pos0 + tok;
                    const bool keep = pos >= lo[h] && pos < hi[h];
                    float x = s[nt][e];
                    if constexpr (I8) x *= sS[tok];
                    s[nt][e] = keep ? x * a.scale_log2 : kNegInf;
                    mx[h] = fmaxf(mx[h], s[nt][e]);
                }
            }
            float alpha[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
                mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
                const float m_new = fmaxf(st.m[h], mx[h]);
                alpha[h] = exp2f(st.m[h] - m_new);
                st.m[h] = m_new;
                st.l[h] *= alpha[h];
            }
            // P's A fragments; over int8 pages P' = p v_s as hi + lo.
            uint32_t pa[TKW / 16][4];
            uint32_t pl[I8 ? TKW / 16 : 1][4];
#pragma unroll
            for (int nt = 0; nt < TKW / 8; ++nt) {
                float p[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int h = e / 2;
                    p[e] = s[nt][e] > kNegInf ? exp2f(s[nt][e] - st.m[h])
                                              : 0.0f;
                    st.l[h] += p[e];
                    if constexpr (I8) {
                        p[e] *= sS[TK + nt * 8 + 2 * (lane % 4) + e % 2];
                    }
                }
#pragma unroll
                for (int e = 0; e < 4; e += 2) {
                    const int i = (nt % 2) * 2 + e / 2;
                    pa[nt / 2][i] = pack_bf16(p[e], p[e + 1]);
                    if constexpr (I8) {
                        const float2 hf = __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(
                                &pa[nt / 2][i]));
                        pl[nt / 2][i] =
                            pack_bf16(p[e] - hf.x, p[e + 1] - hf.y);
                    }
                }
            }
#pragma unroll
            for (int nt = 0; nt < HD / 8; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) st.acc[nt][e] *= alpha[e / 2];
            }
            // acc += P V.
            if constexpr (I8) {
                // V's B fragment of n-tile 4 dg + j has its column g at
                // dim 32 dg + 4 g + j: a lane loads 4 bytes (4 dims) of
                // its 4 tokens 2c, 2c + 1, 2c + 8, 2c + 9 of the chunk,
                // transposes them by byte permutes and widens each dim's
                // 4 tokens to its b0, b1; P' goes in as hi, then lo.
                const int8_t* const V8 =
                    reinterpret_cast<const int8_t*>(sV) + wk * TKW * LD +
                    4 * g;
#pragma unroll
                for (int kc = 0; kc < TKW / 16; ++kc) {
#pragma unroll
                    for (int dg = 0; dg < HD / 32; ++dg) {
                        uint32_t r[4];
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            const int tok = kc * 16 + 2 * c + i % 2 +
                                            8 * (i / 2);
                            r[i] = *reinterpret_cast<const uint32_t*>(
                                V8 + tok * LD + dg * 32);
                        }
                        transpose_bytes(r);
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            uint32_t b0, b1;
                            i8x4_to_bf16(r[j], b0, b1);
                            mma16816(st.acc[4 * dg + j], pa[kc], b0, b1);
                            mma16816(st.acc[4 * dg + j], pl[kc], b0, b1);
                        }
                    }
                }
            } else {
                // V read transposed.
                const __nv_bfloat16* const Vw =
                    reinterpret_cast<const __nv_bfloat16*>(sV) +
                    wk * TKW * LD;
#pragma unroll
                for (int kc = 0; kc < TKW / 16; ++kc) {
#pragma unroll
                    for (int dp = 0; dp < HD / 16; ++dp) {
                        uint32_t bf[4];
                        ldsm_x4_t(bf, Vw + (kc * 16 + lane % 8 +
                                            8 * ((lane / 8) % 2)) * LD +
                                          dp * 16 + 8 * (lane / 16));
                        mma16816(st.acc[2 * dp], pa[kc], bf[0], bf[1]);
                        mma16816(st.acc[2 * dp + 1], pa[kc], bf[2], bf[3]);
                    }
                }
            }
        } else {
            // f32 q, FMA throughout, the warp's rows in blocks of RB = 4
            // (a block wholly past its nr rows that are not padding is
            // skipped), so that a block's independent chains of loads,
            // FMAs and shuffles overlap: row by row, each chain's latency
            // was paid alone. S: lane = (token lane % 16 of the warp's 16,
            // half lane / 16 of the head dim), 16 bytes of K (f32: 4
            // values; int8: 16) and of each row's Q (a broadcast) a load
            // (the 16-byte row pad keeps 8 lanes' K loads on distinct
            // banks), the halves summed by a shuffle; P V: lane = columns
            // lane + 32 k (int8: lane * CPL + k, one load), each token's
            // p taken from its lane by a shuffle. A padding row has a zero
            // Q and keeps no position: p = 0, and it is never stored.
            constexpr int HALF = HD / 2;
            constexpr int CPL = HD / 32;  // columns a lane accumulates
            constexpr int RB = 4;
            const int tok = lane % 16;
            const float4* Qw = reinterpret_cast<const float4*>(
                reinterpret_cast<const float*>(sQ) + rw * 16 * LDQ +
                (lane / 16) * HALF);
            const PT* const krow = sK + (wk * TKW + tok) * LD +
                                   (lane / 16) * HALF;
            const PT* const Vw = sV + wk * TKW * LD;
            const int pos = pos0 + tok;
            const float kscale = I8 ? sS[tok] : 1.0f;
            const float vscale = I8 ? sS[TK + tok] : 1.0f;
            float p[16];
#pragma unroll
            for (int rb = 0; rb < 16; rb += RB) {
#pragma unroll
                for (int j = 0; j < RB; ++j) p[rb + j] = 0.0f;
                if (rb < nr) {
                    float x[RB];
#pragma unroll
                    for (int j = 0; j < RB; ++j) x[j] = 0.0f;
                    if constexpr (I8) {
#pragma unroll 2
                        for (int d = 0; d < HALF / 16; ++d) {
                            const uint4 w =
                                reinterpret_cast<const uint4*>(krow)[d];
                            float kv[16];
                            i8x4_to_f32(w.x, kv);
                            i8x4_to_f32(w.y, kv + 4);
                            i8x4_to_f32(w.z, kv + 8);
                            i8x4_to_f32(w.w, kv + 12);
#pragma unroll
                            for (int j = 0; j < RB; ++j) {
#pragma unroll
                                for (int u = 0; u < 4; ++u) {
                                    const float4 qv =
                                        Qw[(rb + j) * (LDQ / 4) + 4 * d + u];
                                    x[j] = fmaf(qv.x, kv[4 * u], x[j]);
                                    x[j] = fmaf(qv.y, kv[4 * u + 1], x[j]);
                                    x[j] = fmaf(qv.z, kv[4 * u + 2], x[j]);
                                    x[j] = fmaf(qv.w, kv[4 * u + 3], x[j]);
                                }
                            }
                        }
                    } else {
                        const float4* const k4 =
                            reinterpret_cast<const float4*>(krow);
#pragma unroll 2
                        for (int d = 0; d < HALF / 4; ++d) {
                            const float4 kv = k4[d];
#pragma unroll
                            for (int j = 0; j < RB; ++j) {
                                const float4 qv = Qw[(rb + j) * (LDQ / 4) + d];
                                x[j] = fmaf(qv.x, kv.x, x[j]);
                                x[j] = fmaf(qv.y, kv.y, x[j]);
                                x[j] = fmaf(qv.z, kv.z, x[j]);
                                x[j] = fmaf(qv.w, kv.w, x[j]);
                            }
                        }
                    }
#pragma unroll
                    for (int j = 0; j < RB; ++j) {
                        const int r = rb + j;
                        x[j] += __shfl_xor_sync(0xffffffffu, x[j], 16);
                        const bool keep = pos >= sLo[rw * 16 + r] &&
                                          pos < sHi[rw * 16 + r];
                        if constexpr (I8) x[j] *= kscale;
                        x[j] = keep ? x[j] * a.scale_log2 : kNegInf;
                        float mx = x[j];
#pragma unroll
                        for (int w = 1; w < 16; w <<= 1) {
                            mx = fmaxf(mx,
                                       __shfl_xor_sync(0xffffffffu, mx, w));
                        }
                        const float m_new = fmaxf(st.m[r], mx);
                        const float alpha = exp2f(st.m[r] - m_new);
                        st.m[r] = m_new;
                        p[r] = keep ? exp2f(x[j] - m_new) : 0.0f;
                        st.l[r] = st.l[r] * alpha + (lane < 16 ? p[r] : 0.0f);
                        if constexpr (I8) p[r] *= vscale;  // P' = p v_s
#pragma unroll
                        for (int k = 0; k < CPL; ++k) st.acc[r][k] *= alpha;
                    }
                }
            }
#pragma unroll 4
            for (int t = 0; t < 16; ++t) {
                float v[CPL];
                if constexpr (I8) {
                    load_i8<CPL>(Vw + t * LD + lane * CPL, v);
                } else {
#pragma unroll
                    for (int k = 0; k < CPL; ++k) {
                        v[k] = Vw[t * LD + lane + 32 * k];
                    }
                }
#pragma unroll
                for (int rb = 0; rb < 16; rb += RB) {
                    if (rb < nr) {
#pragma unroll
                        for (int j = 0; j < RB; ++j) {
                            const float pt =
                                __shfl_sync(0xffffffffu, p[rb + j], t);
#pragma unroll
                            for (int k = 0; k < CPL; ++k) {
                                st.acc[rb + j][k] =
                                    fmaf(pt, v[k], st.acc[rb + j][k]);
                            }
                        }
                    }
                }
            }
        }
    }

    // ---- merge the WK warps of each row, in order, then write ----
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring
    float* const mb = reinterpret_cast<float*>(ring);  // [WK][RT]
    float* const lb = mb + WK * RT;                     // [WK][RT]
    float* const ab = lb + WK * RT;                     // [WK][RT][HD]
    if constexpr (kMma) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float l = st.l[h];
            l += __shfl_xor_sync(0xffffffffu, l, 1);
            l += __shfl_xor_sync(0xffffffffu, l, 2);
            const int r = rw * 16 + lane / 4 + 8 * h;
            if (lane % 4 == 0) {
                mb[wk * RT + r] = st.m[h];
                lb[wk * RT + r] = l;
            }
            // Column 2 (lane % 4) + e of n-tile nt: dim 8 nt + that, or
            // (int8) 32 (nt / 4) + 4 that + nt % 4.
            float* arow = ab + ((size_t)wk * RT + r) * HD;
#pragma unroll
            for (int nt = 0; nt < HD / 8; ++nt) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int n = 2 * (lane % 4) + e;
                    arow[I8 ? nt / 4 * 32 + 4 * n + nt % 4 : nt * 8 + n] =
                        st.acc[nt][2 * h + e];
                }
            }
        }
    } else {
        // A lane's columns: lane + 32 k, or (int8) lane * CPL + k.
        constexpr int CPL = HD / 32;
        constexpr int c0 = I8 ? CPL : 1, ck = I8 ? 1 : 32;
#pragma unroll
        for (int r = 0; r < 16; ++r) {
            if (r < nr) {
                float l = st.l[r];
#pragma unroll
                for (int w = 1; w < 32; w <<= 1) {
                    l += __shfl_xor_sync(0xffffffffu, l, w);
                }
                const int row = rw * 16 + r;
                if (lane == 0) {
                    mb[wk * RT + row] = st.m[r];
                    lb[wk * RT + row] = l;
                }
                float* arow = ab + ((size_t)wk * RT + row) * HD + lane * c0;
#pragma unroll
                for (int k = 0; k < CPL; ++k) arow[ck * k] = st.acc[r][k];
            }
        }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < RT * HD; i += C::THREADS) {
        const int r = i / HD;
        const int c = i % HD;
        if (r0 + r >= R || c >= a.D) continue;
        float M = kNegInf;
#pragma unroll
        for (int w = 0; w < WK; ++w) {
            if (lb[w * RT + r] > 0.0f) M = fmaxf(M, mb[w * RT + r]);
        }
        float L = 0.0f, A = 0.0f;
#pragma unroll
        for (int w = 0; w < WK; ++w) {
            const float lw = lb[w * RT + r];
            if (lw > 0.0f) {
                const float f = exp2f(mb[w * RT + r] - M);
                L = fmaf(lw, f, L);
                A = fmaf(ab[((size_t)w * RT + r) * HD + c], f, A);
            }
        }
        if (a.n_splits == 1) {
            static_cast<T*>(a.out)[row_off(r0 + r) + c] =
                from_float<T>(L > 0.0f ? A / L : 0.0f);
        } else {
            const size_t prow = (size_t)part * R + r0 + r;
            a.ws_acc[prow * a.D + c] = A;
            if (c == 0) a.ws_ml[prow] = make_float2(M, L);
        }
    }
}

// Merge each output row's split partials in split order: one warp a row
// of out [B, m, H, D], in its order, a lane every 32nd column, with an
// online rescale over the splits, four splits' loads issued together.
// Splits with l = 0 (nothing kept: their acc may be unwritten) are
// skipped; a row no split kept is written as 0.
template <typename T>
__global__ void __launch_bounds__(128)
paged_split_merge_kernel(const Args a) {
    constexpr int G4 = 4;  // splits whose loads are issued together
    const int n_rows = a.B * a.m * a.H;
    const int row = blockIdx.x * 4 + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (row >= n_rows) return;
    const int group = a.H / a.KV;
    const int R = a.m * group;
    const int b = row / (a.m * a.H);
    const int head = row % a.H;
    const int r = (row / a.H) % a.m * group + head % group;
    const size_t p0 =
        (size_t)(b * a.KV + head / group) * a.n_splits * R + r;
    float M = kNegInf, L = 0.0f;
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
    for (int s0 = 0; s0 < a.n_splits; s0 += G4) {
        float2 ml[G4];
        float v[G4][8];
#pragma unroll
        for (int j = 0; j < G4; ++j) {
            const size_t prow = p0 + (size_t)(s0 + j) * R;
            const bool in = s0 + j < a.n_splits;
            ml[j] = in ? a.ws_ml[prow] : make_float2(kNegInf, 0.0f);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int c = lane + 32 * i;
                v[j][i] = in && c < a.D ? a.ws_acc[prow * a.D + c] : 0.0f;
            }
        }
#pragma unroll
        for (int j = 0; j < G4; ++j) {
            if (ml[j].y > 0.0f) {
                const float m_new = fmaxf(M, ml[j].x);
                const float al = exp2f(M - m_new), f = exp2f(ml[j].x - m_new);
                M = m_new;
                L = L * al + ml[j].y * f;
#pragma unroll
                for (int i = 0; i < 8; ++i) acc[i] = acc[i] * al + v[j][i] * f;
            }
        }
    }
    const int cols = a.D;  // the row's columns: none past D is stored
    T* o = static_cast<T*>(a.out) + (size_t)row * a.D;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int c = lane + 32 * i;
        if (c < cols) o[c] = from_float<T>(L > 0.0f ? acc[i] / L : 0.0f);
    }
}

template <typename T, int HD, int RW, int I8>
int launch(const Args& a) {
    using C = Cfg<T, HD, RW, I8>;
    auto kern = paged_split_kernel<T, HD, RW, I8>;
    // Per launch: the attribute is the current device's.
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
    if (err != cudaSuccess) return (int)err;
    const int R = a.m * (a.H / a.KV);
    const int n_rt = (R + C::RT - 1) / C::RT;
    const dim3 grid(a.n_splits, n_rt * a.KV, a.B);
    kern<<<grid, C::THREADS, C::BYTES, a.stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess || a.n_splits == 1) return (int)err;
    const int n_rows = a.B * a.m * a.H;
    paged_split_merge_kernel<T><<<(n_rows + 3) / 4, 128, 0, a.stream>>>(a);
    return (int)cudaGetLastError();
}

template <typename T, int HD, int I8>
int dispatch_rows(const Args& a) {
    switch (a.row_tile) {
        case 16: return launch<T, HD, 1, I8>(a);
        case 32: return launch<T, HD, 2, I8>(a);
        case 48: return launch<T, HD, 3, I8>(a);
        case 64: return launch<T, HD, 4, I8>(a);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename T, int I8>
int dispatch_hd(const Args& a) {
    switch (istpu::head_dim_capacity(a.D)) {
        case 32: return dispatch_rows<T, 32, I8>(a);
        case 64: return dispatch_rows<T, 64, I8>(a);
        case 128: return dispatch_rows<T, 128, I8>(a);
        case 256: return dispatch_rows<T, 256, I8>(a);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The pages a sequence's m query tokens can keep: the table's width, or
// with a window the pages from the window floor's to the last token's
// (ops/paged_split.window_span computes the same).
int window_span(const Args& a) {
    if (a.window <= 0) return a.max_pages;
    return min(a.max_pages, (a.window + a.m + a.P - 2) / a.P + 1);
}

// Check the split plan, then launch over pages of q's type (I8 = 0) or
// int8 pages with their scales (I8 = 1).
template <int I8>
int run(Args& a, int is_bf16, float scale) {
    const int R = a.m * (a.H / a.KV);
    // The plan must cover every row and every page a row can keep once.
    if (a.n_splits < 1 || a.pages_per_split < 1 ||
        (long)a.n_splits * a.pages_per_split < window_span(a) ||
        (a.n_splits > 1 && (a.ws_ml == nullptr || a.ws_acc == nullptr)) ||
        a.row_tile > 64 || (R > 64 && a.row_tile != 64) ||
        (I8 && (a.ks == nullptr || a.vs == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    a.scale_log2 = scale * 1.4426950408889634f;
    if (is_bf16) return dispatch_hd<__nv_bfloat16, I8>(a);
    return dispatch_hd<float, I8>(a);
}

}  // namespace
