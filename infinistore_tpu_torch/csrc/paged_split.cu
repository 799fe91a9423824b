// Paged attention split over the pages (split-K) for Hopper, sm_90a: m
// query tokens per sequence over their KV pages (decode: m = 1;
// speculative verify; a chunk of chunked prefill), GQA, a causal limit
// per token, optional sliding window.
//
// Replaces: infinistore_tpu/ops/pallas_paged_attention.py::_kernel (K2,
// one-token decode, reached through paged_flash_decode /
// decode_attention) and ::_kernel_multi (K3, m-token verify, reached
// through paged_flash_verify / verify_attention), with their fold
// _attend and page map _make_page_idx. Decode is verify at m = 1 over
// seq_lens - 1: K2's seq_lens count the current token, K3's do not, and
// token j of m sees the positions below seq_len + j + 1 (and, with a
// window, none below that limit - window).
//
// What bounds it on an H100: bytes, at decode and speculative verify.
// A kv head's query rows are its m x group (token, group member) pairs,
// and each K/V element read serves 4 FLOPs per row: 16 FLOP per byte at
// decode with a group of 4, ~80 at speculative verify (m = 5), far below
// the card's ~295 FLOP/byte balance point. The least time is the K/V of
// the live pages read once per kv head over 3.35 TB/s. A 512-token chunk
// (2048 rows) does ~8000 FLOP per byte and is bound by the tensor cores.
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
// - K and V rows are gathered through page_table[pos / page], clamped
//   into the pool as the TPU kernel clamps them, 16 bytes a thread by
//   cp.async into a ring of shared-memory stages (3; 2 for 48- and
//   64-row tiles and f32 at hd 256, so that two CTAs fit an SM), so the
//   next tiles' loads are in flight while this one folds; any page size
//   works. Positions outside the CTA's range and columns at or past D
//   land as zero.
// - The warps split the tile: 16 rows each, and along the tile's tokens
//   when the rows are few (decode: 4 warps of 16 tokens of a 64-token
//   tile), each warp with its own f32 online softmax, merged through
//   shared memory in a fixed order at the end.
// - bf16 folds on the tensor cores: S = Q K^T and O += P V on mma.sync
//   m16n8k16 with f32 accumulation, operands by ldmatrix (V transposed),
//   P rounded to bf16 in registers as the A fragments of P V (as the TPU
//   kernel rounds p.astype(v.dtype)), the softmax in exp2 of logits
//   prescaled by scale * log2(e). f32 folds with FMA (no TF32), a lane a
//   token for S and a lane a column for P V, over the warp's rows in
//   blocks of 4, skipping the blocks that hold only padding: the fold is
//   latency-bound (1-4 warps a CTA, 1-2 CTAs an SM by shared memory), and
//   a block's 4 independent chains overlap where rows one at a time did
//   not (1.3-2.2x across chip_smoke's f32 cases).
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using istpu::from_float;
using istpu::kNegInf;

constexpr int kStageBytes = 32768;  // K and V of one tile, unpadded

template <typename T, int HD, int RW>
struct Cfg {
    static constexpr int RT = RW * 16;          // query rows of a CTA
    static constexpr int VEC = 16 / sizeof(T);  // elements in 16 bytes
    static constexpr int VPR = HD / VEC;        // 16-byte vectors a row
    // Warps along the tile's tokens where the rows are few.
    static constexpr int WK_ROWS = RW >= 3 ? 1 : 4 / RW;
    // Tokens a tile: 64 bf16 (32 at hd 256); f32 16 a warp (a lane a
    // token), and fewer where a row is wide.
    static constexpr int TK_FIT = kStageBytes / (2 * HD * (int)sizeof(T));
    static constexpr int TK_CAP = sizeof(T) == 2 ? 64 : 16 * WK_ROWS;
    static constexpr int TK = TK_FIT < TK_CAP ? TK_FIT : TK_CAP;
    static constexpr int WK = WK_ROWS < TK / 16 ? WK_ROWS : TK / 16;
    static constexpr int TKW = TK / WK;  // tokens a warp folds per tile
    static_assert(sizeof(T) == 2 || TKW == 16, "f32: a lane a token");
    static constexpr int WARPS = RW * WK;
    static constexpr int THREADS = WARPS * 32;
    // Stages of the ring: 2 where a CTA's Q or a tile is large (48- and
    // 64-row tiles; f32 at hd 256), so that two CTAs fit an SM.
    static constexpr int STAGES =
        RW >= 3 || (sizeof(T) == 4 && HD == 256) ? 2 : 3;
    static constexpr int LD = HD + VEC;  // smem row stride: 16-byte pad
    static constexpr int Q_BYTES = RT * LD * (int)sizeof(T);
    static constexpr int RANGE_BYTES = 2 * RT * 4;  // rows' [lo, hi)
    static constexpr int TILE = TK * LD;  // elements of a K or V tile
    static constexpr int RING_BYTES = STAGES * 2 * TILE * (int)sizeof(T);
    // Each warp's m, l and acc rows for the merge, over the ring.
    static constexpr int MERGE_BYTES = WK * RT * (HD + 2) * 4;
    static constexpr int BYTES = Q_BYTES + RANGE_BYTES +
                                 (RING_BYTES > MERGE_BYTES ? RING_BYTES
                                                           : MERGE_BYTES);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; the bytes past
// `src_bytes` (16 or 0) are written as zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
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

// One warp's online-softmax state over its 16 rows. bf16 (mma layout):
// lane holds rows g = lane / 4 and g + 8 (h = 0, 1), and of each
// 8-column block nt the columns 8 nt + 2 (lane % 4) + {0, 1}:
// acc[nt][2 h + e]. f32: lane holds every row r and the columns lane +
// 32 k: acc[r][k].
template <typename T, int HD>
struct WarpState {
    static constexpr bool kMma = sizeof(T) == 2;
    static constexpr int NR = kMma ? 2 : 16;  // rows a lane holds
    float m[NR];
    float l[NR];  // this lane's part of the row sums
    float acc[kMma ? HD / 8 : 16][kMma ? 4 : HD / 32];
};

template <typename T, int HD, int RW>
__global__ void __launch_bounds__(Cfg<T, HD, RW>::THREADS)
paged_split_kernel(const Args a) {
    using C = Cfg<T, HD, RW>;
    constexpr int RT = C::RT, TK = C::TK, TKW = C::TKW, LD = C::LD;
    constexpr int WK = C::WK, STAGES = C::STAGES;
    constexpr bool kMma = sizeof(T) == 2;

    extern __shared__ __align__(16) unsigned char smem[];
    T* const sQ = reinterpret_cast<T*>(smem);
    int* const sLo = reinterpret_cast<int*>(smem + C::Q_BYTES);
    int* const sHi = sLo + RT;
    T* const ring = reinterpret_cast<T*>(smem + C::Q_BYTES + C::RANGE_BYTES);

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
    for (int i = threadIdx.x; i < RT * C::VPR; i += C::THREADS) {
        const int r = i / C::VPR;
        const int c = (i % C::VPR) * C::VEC;
        const bool ok = r0 + r < R && c < a.D;
        cp_async16(sQ + r * LD + c, ok ? q + row_off(r0 + r) + c : q,
                   ok ? 16 : 0);
    }

    // ---- the ring: tile t holds positions [cta_lo + t TK, + TK) ----
    const T* kp = static_cast<const T*>(a.kp);
    const T* vp = static_cast<const T*>(a.vp);
    const int* table = a.table + (size_t)b * a.max_pages;
    const size_t kv_tok = (size_t)a.KV * a.D;
    const int n_tiles = (cta_hi - cta_lo + TK - 1) / TK;
    const auto load = [&](int t) {
        if (t < n_tiles) {
            T* const sK = ring + (t % STAGES) * 2 * C::TILE;
            T* const sV = sK + C::TILE;
            const int pos0 = cta_lo + t * TK;
            for (int i = threadIdx.x; i < TK * C::VPR; i += C::THREADS) {
                const int r = i / C::VPR;
                const int c = (i % C::VPR) * C::VEC;
                const int pos = pos0 + r;
                size_t off = 0;
                const bool ok = pos < cta_hi && c < a.D;
                if (ok) {
                    const int pid = min(max(table[pos / a.P], 0), a.N - 1);
                    off = ((size_t)pid * a.P + pos % a.P) * kv_tok +
                          (size_t)kvh * a.D + c;
                }
                cp_async16(sK + r * LD + c, kp + off, ok ? 16 : 0);
                cp_async16(sV + r * LD + c, vp + off, ok ? 16 : 0);
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

        const T* sK = ring + (t % STAGES) * 2 * C::TILE + wk * TKW * LD;
        const T* sV = sK + C::TILE;
        const int pos0 = cta_lo + t * TK + wk * TKW;  // the warp's first

        if constexpr (kMma) {
            const __nv_bfloat16* Qw =
                reinterpret_cast<const __nv_bfloat16*>(sQ) + rw * 16 * LD;
            const __nv_bfloat16* Kw =
                reinterpret_cast<const __nv_bfloat16*>(sK);
            const __nv_bfloat16* Vw =
                reinterpret_cast<const __nv_bfloat16*>(sV);
            if constexpr (kQRegs) {
                if (t == 0) {
#pragma unroll
                    for (int kk = 0; kk < HD / 16; ++kk) {
                        ldsm_x4(qa[kk], Qw + (lane % 16) * LD + kk * 16 +
                                            (lane / 16) * 8);
                    }
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
                    ldsm_x4(af, Qw + (lane % 16) * LD + kk * 16 +
                                    (lane / 16) * 8);
                }
#pragma unroll
                for (int np = 0; np < TKW / 16; ++np) {
                    uint32_t bf[4];
                    ldsm_x4(bf, Kw + (np * 16 + lane % 8 + 8 * (lane / 16)) *
                                         LD +
                                    kk * 16 + 8 * ((lane / 8) % 2));
                    mma16816(s[2 * np], af, bf[0], bf[1]);
                    mma16816(s[2 * np + 1], af, bf[2], bf[3]);
                }
            }
            // Online softmax in log2 units; masked positions give p = 0.
            float mx[2] = {kNegInf, kNegInf};
#pragma unroll
            for (int nt = 0; nt < TKW / 8; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int h = e / 2;
                    const int pos = pos0 + nt * 8 + 2 * (lane % 4) + e % 2;
                    const bool keep = pos >= lo[h] && pos < hi[h];
                    s[nt][e] = keep ? s[nt][e] * a.scale_log2 : kNegInf;
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
            uint32_t pa[TKW / 16][4];
#pragma unroll
            for (int nt = 0; nt < TKW / 8; ++nt) {
                float p[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int h = e / 2;
                    p[e] = s[nt][e] > kNegInf ? exp2f(s[nt][e] - st.m[h])
                                              : 0.0f;
                    st.l[h] += p[e];
                }
                pa[nt / 2][(nt % 2) * 2] = pack_bf16(p[0], p[1]);
                pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
            }
#pragma unroll
            for (int nt = 0; nt < HD / 8; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) st.acc[nt][e] *= alpha[e / 2];
            }
            // acc += P V, V read transposed.
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
        } else {
            // f32, FMA throughout, the warp's rows in blocks of RB = 4
            // (a block wholly past its nr rows that are not padding is
            // skipped), so that a block's independent chains of loads,
            // FMAs and shuffles overlap: row by row, each chain's latency
            // was paid alone. S: lane = (token lane % 16 of the warp's 16,
            // half lane / 16 of the head dim), 16 bytes of K and of each
            // row's Q (a broadcast) a load (the 16-byte row pad keeps 8
            // lanes' K loads on distinct banks), the halves summed by a
            // shuffle; P V: lane = columns lane + 32 k, each token's p
            // taken from its lane by a shuffle. A padding row has a zero
            // Q and keeps no position: p = 0, and it is never stored.
            constexpr int HALF = HD / 2;
            constexpr int CPL = HD / 32;  // columns a lane accumulates
            constexpr int RB = 4;
            const int tok = lane % 16;
            const float4* Qw = reinterpret_cast<const float4*>(
                reinterpret_cast<const float*>(sQ) + rw * 16 * LD +
                (lane / 16) * HALF);
            const float4* krow = reinterpret_cast<const float4*>(
                reinterpret_cast<const float*>(sK) + tok * LD +
                (lane / 16) * HALF);
            const float* Vw = reinterpret_cast<const float*>(sV);
            const int pos = pos0 + tok;
            float p[16];
#pragma unroll
            for (int rb = 0; rb < 16; rb += RB) {
#pragma unroll
                for (int j = 0; j < RB; ++j) p[rb + j] = 0.0f;
                if (rb < nr) {
                    float x[RB];
#pragma unroll
                    for (int j = 0; j < RB; ++j) x[j] = 0.0f;
#pragma unroll 2
                    for (int d = 0; d < HALF / 4; ++d) {
                        const float4 kv = krow[d];
#pragma unroll
                        for (int j = 0; j < RB; ++j) {
                            const float4 qv = Qw[(rb + j) * (LD / 4) + d];
                            x[j] = fmaf(qv.x, kv.x, x[j]);
                            x[j] = fmaf(qv.y, kv.y, x[j]);
                            x[j] = fmaf(qv.z, kv.z, x[j]);
                            x[j] = fmaf(qv.w, kv.w, x[j]);
                        }
                    }
#pragma unroll
                    for (int j = 0; j < RB; ++j) {
                        const int r = rb + j;
                        x[j] += __shfl_xor_sync(0xffffffffu, x[j], 16);
                        const bool keep = pos >= sLo[rw * 16 + r] &&
                                          pos < sHi[rw * 16 + r];
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
#pragma unroll
                        for (int k = 0; k < CPL; ++k) st.acc[r][k] *= alpha;
                    }
                }
            }
#pragma unroll 4
            for (int t = 0; t < 16; ++t) {
                float v[CPL];
#pragma unroll
                for (int k = 0; k < CPL; ++k) v[k] = Vw[t * LD + lane + 32 * k];
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
            float* arow = ab + ((size_t)wk * RT + r) * HD + 2 * (lane % 4);
#pragma unroll
            for (int nt = 0; nt < HD / 8; ++nt) {
                arow[nt * 8] = st.acc[nt][2 * h];
                arow[nt * 8 + 1] = st.acc[nt][2 * h + 1];
            }
        }
    } else {
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
                float* arow = ab + ((size_t)wk * RT + row) * HD + lane;
#pragma unroll
                for (int k = 0; k < HD / 32; ++k) arow[32 * k] = st.acc[r][k];
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

template <typename T, int HD, int RW>
int launch(const Args& a) {
    using C = Cfg<T, HD, RW>;
    auto kern = paged_split_kernel<T, HD, RW>;
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

template <typename T, int HD>
int dispatch_rows(const Args& a) {
    switch (a.row_tile) {
        case 16: return launch<T, HD, 1>(a);
        case 32: return launch<T, HD, 2>(a);
        case 48: return launch<T, HD, 3>(a);
        case 64: return launch<T, HD, 4>(a);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
int dispatch_hd(const Args& a) {
    switch (istpu::head_dim_capacity(a.D)) {
        case 32: return dispatch_rows<T, 32>(a);
        case 64: return dispatch_rows<T, 64>(a);
        case 128: return dispatch_rows<T, 128>(a);
        case 256: return dispatch_rows<T, 256>(a);
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

int run(Args& a, int is_bf16, float scale) {
    const int R = a.m * (a.H / a.KV);
    // The plan must cover every row and every page a row can keep once.
    if (a.n_splits < 1 || a.pages_per_split < 1 ||
        (long)a.n_splits * a.pages_per_split < window_span(a) ||
        (a.n_splits > 1 && (a.ws_ml == nullptr || a.ws_acc == nullptr)) ||
        a.row_tile > 64 || (R > 64 && a.row_tile != 64)) {
        return (int)cudaErrorInvalidValue;
    }
    a.scale_log2 = scale * 1.4426950408889634f;
    if (is_bf16) return dispatch_hd<__nv_bfloat16>(a);
    return dispatch_hd<float>(a);
}

}  // namespace

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
    Args a{q, k_pages, v_pages, static_cast<const int*>(page_table),
           static_cast<const int*>(seq_lens), out,
           static_cast<float2*>(ws_ml), static_cast<float*>(ws_acc),
           B, 1, H, KV, D, N, P, max_pages, window, -1, 0.0f,
           row_tile, n_splits, pages_per_split,
           static_cast<cudaStream_t>(stream)};
    return run(a, is_bf16, scale);
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
    Args a{q, k_pages, v_pages, static_cast<const int*>(page_table),
           static_cast<const int*>(seq_lens), out,
           static_cast<float2*>(ws_ml), static_cast<float*>(ws_acc),
           B, m, H, KV, D, N, P, max_pages, window, 0, 0.0f,
           row_tile, n_splits, pages_per_split,
           static_cast<cudaStream_t>(stream)};
    return run(a, is_bf16, scale);
}
