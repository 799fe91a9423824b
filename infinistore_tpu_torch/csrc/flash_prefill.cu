// Flash prefill attention (causal GQA, rectangular diagonal, optional
// sliding window) for Hopper, sm_90a.
//
// Replaces: infinistore_tpu/ops/pallas_flash_attention.py::_kernel (the
// forward, reached through _forward_impl / flash_prefill_attention, and
// with_lse=True under _flash_with_vjp: with a non-null `lse` it also
// writes each row's logsumexp for the backward kernels).
//
// What bounds it on an H100: operations. At Sq = Skv = 2048, hd = 128,
// 32 heads, a causal pass is ~3.4e10 FLOP against ~4e7 bytes of q/k/v/o,
// far above the card's ~295 FLOP/byte balance point, so the tensor
// cores are the limit (989 TFLOP/s bf16 dense), and only wgmma reaches
// their rate.
//
// Design of the bf16 kernel. The TPU grid walks the kv blocks in order
// and keeps acc/m/l in VMEM scratch between grid steps; Hopper blocks run
// in no order, so one CTA owns one (batch * head, q tile of NC * 64 rows)
// and loops over the live kv tiles itself. The CTA is NC consumer
// warpgroups (64 query rows each) and one producer warpgroup, which
// gives its registers to the consumers (setmaxnreg). One producer thread
// loads the Q tile once and the K and V tiles (BK rows) through a ring of
// STAGES shared-memory stages by TMA, each stage with a "full" barrier
// (bytes landed) and an "empty" one (every consumer warp done with it),
// so the next tiles are in flight while the consumers compute. Tensor
// maps lie over q [B, Sq, H, D] and k/v [B, Skv, KV, D] as they are (GQA
// needs no copy: a CTA's kv head is h / (H / KV)); TMA's out-of-bounds
// zero fill pads the ragged tail, and its 128-byte swizzle (64-byte at
// hd 32) is the layout the wgmma descriptors read. Per tile a consumer
// runs S = Q K^T on wgmma (Q and K from shared memory, S in the
// accumulator registers), the online softmax on that fragment in
// registers (row max and sum by shuffles in the quad that holds a row,
// exp2 of logits prescaled by log2(e), the mask built only on boundary
// tiles with -1e30 as the masked logit), then O += P V on wgmma with P
// rounded to bf16 in registers (the register-A form) and V read
// transposed from shared memory. S, P and O never pass through shared
// memory; O / l goes out through the consumer's part of the Q tile by a
// TMA store, which writes no row past Sq. Heavy q tiles (the most live kv
// tiles under the causal mask) are launched first. The live range,
// interior rule and mask are flash_tile.cuh's, at this kernel's tile
// sizes, shared with the backward kernels. Short prompts take one
// consumer per CTA (64-row q tiles), so that the grid fills the card.
// Each consumer waits for its own products (S, then P V) before it goes
// on, and the two consumers of a CTA overlap each other's softmax; a
// software pipeline inside one consumer (S of the next tile under the
// softmax) needs more than the 240 registers setmaxnreg gives it or
// makes ptxas serialise the wgmma (note C7513), and ran slower.
//
// The tile sizes per head dim (Plan). At hd <= 128 a kv tile is 128
// rows (kBK): S takes 64 registers a consumer thread and P's bf16 A
// fragments 32 beside O's hd / 2. At hd 256 O [64 x 256] in f32 alone is
// 128 registers a thread, so a kv tile is 64 rows (kBKWide): S 32 and P
// 16 registers, which fit beside O in 240. O is then two accumulators of
// 128 columns, and P V is issued as two N = 128 products over V's two
// halves of column blocks. Shared memory at hd 256: Q for two consumers
// is 64 KB and one K + V stage 64 KB, so the ring has two stages (three
// for one consumer). Every D from 136 to 256 runs here: the column
// blocks past D are zero-filled on load and not stored.
//
// The f32 variant is the 64 x 64 tile fold of flash_tile.cuh with plain
// FMA loops, so f32 stays true f32 (no TF32); at hd 256 its kv tiles are
// 32 rows, so that they fit in shared memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_tile.cuh"
#include "hopper.cuh"

namespace {

using istpu::kNegInf;
using namespace istpu::tile;
namespace hp = istpu::hopper;

// ---------------------------------------------------------------------------
// bf16: TMA ring and warp-specialised wgmma
// ---------------------------------------------------------------------------

constexpr int kRows = 64;     // query rows per consumer warpgroup
constexpr int kBK = 128;      // kv rows per tile at hd <= 128
constexpr int kBKWide = 64;   // kv rows per tile at hd 256
constexpr int kSmemLimit = 232448;  // shared memory one block may use
constexpr float kLn2 = 0.6931471805599453f;

template <int HD, int NC>
struct Plan {
    static constexpr int BQ = NC * kRows;  // query rows per CTA
    static constexpr int BK = HD > 128 ? kBKWide : kBK;  // kv rows a tile
    static constexpr int THREADS = (NC + 1) * 128;
    // Swizzle width = bytes of one row of a column block; a row of HD
    // bf16 is BLOCKS column blocks of SW / 2 elements.
    static constexpr int SW = HD * 2 >= 128 ? 128 : HD * 2;
    static constexpr int BLOCKS = HD * 2 / SW;
    // O's accumulators: OH parts of ON columns, one P V wgmma (N = ON)
    // each.
    static constexpr int OH = HD > 128 ? 2 : 1;
    static constexpr int ON = HD / OH;
    static constexpr int Q_BYTES = BQ * HD * 2;
    static constexpr int TILE_BYTES = BK * HD * 2;  // one K or V tile
    static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
    static constexpr int FIT = (kSmemLimit - 1024 - 256 - Q_BYTES) /
                               STAGE_BYTES;
    static constexpr int STAGES = FIT < 4 ? FIT : 4;
    static_assert(STAGES >= 2, "the ring needs two stages");
    // 1024 bytes of room to align the tiles, the tiles, the barriers.
    static constexpr size_t bytes() {
        return 1024 + Q_BYTES + (size_t)STAGES * STAGE_BYTES +
               8 * (1 + 2 * STAGES);
    }
};

// S[64 x BK] += Q K^T for one consumer's rows, issued but not waited
// for: 16 head-dim columns (32 bytes) a step. q: the consumer's rows of
// column block 0 (blocks `q_blk` bytes apart); k: the staged K tile.
template <int HD, int SW, int BK>
__device__ __forceinline__ void issue_scores(float (&s)[BK / 2],
                                             const unsigned char* q,
                                             int q_blk,
                                             const unsigned char* k) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
        const int blk = kk * 32 / SW, off = kk * 32 % SW;
        const uint64_t a = hp::smem_desc(q + blk * q_blk + off, 16, 8 * SW,
                                         SW);
        const uint64_t b = hp::smem_desc(k + blk * BK * SW + off, 16,
                                         8 * SW, SW);
        if constexpr (BK == 128) {
            hp::wgmma_ss_n128(s, a, b, 1);
        } else {
            hp::wgmma_ss_n64(s, a, b, 1);
        }
    }
}

// O[64 x HD] += P[64 x BK] V, issued but not waited for: 16 keys (16
// rows of the staged V tile) a step, one wgmma per part of O (part h
// reads V's column blocks from h * ON * 2 / SW on).
template <int HD, int SW, int BK, int OH, int ON>
__device__ __forceinline__ void issue_pv(float (&o)[OH][ON / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         const unsigned char* v) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < OH; ++h) {
            const uint64_t d = hp::smem_desc(
                v + h * (ON * 2 / SW) * BK * SW + kk * 16 * SW, BK * SW,
                8 * SW, SW);
            if constexpr (ON == 128) {
                hp::wgmma_rs_n128(o[h], pa[kk], d, 1);
            } else if constexpr (ON == 64) {
                hp::wgmma_rs_n64(o[h], pa[kk], d, 1);
            } else {
                hp::wgmma_rs_n32(o[h], pa[kk], d, 1);
            }
        }
    }
}

// The online softmax of one S tile, in registers and log2 units: s[4j +
// e] is row r_lo + 8 (e / 2), key k_start + 8j + 2 quad + e % 2. Masks
// unless `interior`, updates the row max m and this lane's part of the
// row sum l, returns in alpha the factor that rescales the sums so far,
// and writes P in bf16 as the A fragments of the P V steps (key pair
// (i, i + 1) to step i / 8, register (i / 2) % 4).
template <int BK>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BK / 2], uint32_t (&pa)[BK / 16][4], float (&m)[2],
    float (&l)[2], float (&alpha)[2], bool interior, int r_lo, int k_start,
    int quad, int Sq, int Skv, int causal, int window, float scale_log2) {
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
        const int hi = (i >> 1) & 1;
        float x = s[i] * scale_log2;
        if (!interior &&
            !keeps(r_lo + 8 * hi, k_start + (i >> 2) * 8 + 2 * quad + (i & 1),
                   Sq, Skv, causal, window)) {
            x = kNegInf;
        }
        s[i] = x;
        mx[hi] = fmaxf(mx[hi], x);
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
        mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
        mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
        const float m_new = fmaxf(m[hi], mx[hi]);
        alpha[hi] = exp2f(m[hi] - m_new);
        m[hi] = m_new;
        l[hi] *= alpha[hi];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
        const int hi = (i >> 1) & 1;
        const float p0 = exp2f(s[i] - m[hi]);
        const float p1 = exp2f(s[i + 1] - m[hi]);
        l[hi] += p0 + p1;
        const __nv_bfloat162 pk = __floats2bfloat162_rn(p0, p1);
        pa[i / 8][(i / 2) % 4] = *reinterpret_cast<const uint32_t*>(&pk);
    }
}

template <int HD, int NC>
__global__ void __launch_bounds__(Plan<HD, NC>::THREADS, 1)
flash_prefill_wgmma_kernel(__grid_constant__ const CUtensorMap qmap,
                           __grid_constant__ const CUtensorMap kmap,
                           __grid_constant__ const CUtensorMap vmap,
                           __grid_constant__ const CUtensorMap omap,
                           float* __restrict__ lse, int Sq, int Skv, int H,
                           int KV, int D, int causal, int window,
                           float scale_log2) {
    using P = Plan<HD, NC>;
    constexpr int SW = P::SW, BK = P::BK;

    extern __shared__ unsigned char smem_raw[];
    unsigned char* const sQ =
        smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
    // Stage s: K at sKV + s * STAGE_BYTES, V TILE_BYTES after it. Every
    // tile is [BLOCKS][rows][SW bytes], 1024-byte aligned.
    unsigned char* const sKV = sQ + P::Q_BYTES;
    uint64_t* const q_full =
        reinterpret_cast<uint64_t*>(sKV + P::STAGES * P::STAGE_BYTES);
    uint64_t* const full = q_full + 1;
    uint64_t* const empty = full + P::STAGES;

    const int bh = blockIdx.x;
    const int b = bh / H;
    const int h = bh % H;
    const int kvh = h / (H / KV);
    // Heaviest first: rank 0 is the last q tile, which has the most live
    // kv tiles under a causal mask.
    const int q_start = (gridDim.y - 1 - blockIdx.y) * P::BQ;
    int kt_begin, kt_end;
    kv_tiles<P::BQ, BK>(q_start, Sq, Skv, causal, window, kt_begin, kt_end);

    if (threadIdx.x == 0) {
        hp::mbar_init(q_full, 1);
        for (int s = 0; s < P::STAGES; ++s) {
            hp::mbar_init(&full[s], 1);
            hp::mbar_init(&empty[s], NC * 4);  // one arrival per warp
        }
        hp::fence_barrier_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == NC) {
        // ---- producer ----
        if constexpr (NC == 2) hp::regs_dealloc<24>();
        if (threadIdx.x == NC * 128) {
            hp::mbar_expect_tx(q_full, P::Q_BYTES);
            for (int c = 0; c < P::BLOCKS; ++c) {
                hp::tma_load_4d(sQ + c * P::BQ * SW, &qmap, q_full,
                                c * SW / 2, h, q_start, b);
            }
            int stage = 0;
            uint32_t phase = 0;
            for (int kt = kt_begin; kt < kt_end; ++kt) {
                hp::mbar_wait(&empty[stage], phase ^ 1);
                hp::mbar_expect_tx(&full[stage], P::STAGE_BYTES);
                unsigned char* const sK = sKV + stage * P::STAGE_BYTES;
                unsigned char* const sV = sK + P::TILE_BYTES;
                for (int c = 0; c < P::BLOCKS; ++c) {
                    hp::tma_load_4d(sK + c * BK * SW, &kmap, &full[stage],
                                    c * SW / 2, kvh, kt * BK, b);
                    hp::tma_load_4d(sV + c * BK * SW, &vmap, &full[stage],
                                    c * SW / 2, kvh, kt * BK, b);
                }
                if (++stage == P::STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
        }
    } else {
        // ---- consumer wg: query rows [row0, row0 + 64) ----
        if constexpr (NC == 2) hp::regs_alloc<240>();
        const int warp = (threadIdx.x / 32) % 4;
        const int lane = threadIdx.x % 32;
        const int quad = lane % 4;
        const int row0 = q_start + wg * kRows;
        const int r_lo = row0 + warp * 16 + lane / 4;  // and r_lo + 8
        // This consumer's Q rows in column block c: qc + c * BQ * SW.
        unsigned char* const qc = sQ + wg * kRows * SW;

        // O's column c is part c / ON, o[c / ON][4 (c % ON / 8) + ...].
        float o[P::OH][P::ON / 2];
#pragma unroll
        for (int oh = 0; oh < P::OH; ++oh) {
#pragma unroll
            for (int i = 0; i < P::ON / 2; ++i) o[oh][i] = 0.0f;
        }
        float m[2] = {kNegInf, kNegInf};
        float l[2] = {0.0f, 0.0f};  // this lane's part of the row sums

        const auto tile = [&](int st) { return sKV + st * P::STAGE_BYTES; };
        uint32_t pa[BK / 16][4];
        float alpha[2];
        int stage = 0;
        uint32_t phase = 0;
        hp::mbar_wait(q_full, 0);
        for (int kt = kt_begin; kt < kt_end; ++kt) {
            float s[BK / 2];
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
            hp::fence_regs(s);
            hp::mbar_wait(&full[stage], phase);
            hp::wgmma_fence();
            issue_scores<HD, SW, BK>(s, qc, P::BQ * SW, tile(stage));
            hp::wgmma_commit();
            hp::wgmma_wait<0>();
            hp::fence_regs(s);
            softmax_tile<BK>(s, pa, m, l, alpha,
                             interior_tile<kRows, BK>(row0, kt * BK, Sq, Skv,
                                                      causal, window),
                             r_lo, kt * BK, quad, Sq, Skv, causal, window,
                             scale_log2);
#pragma unroll
            for (int oh = 0; oh < P::OH; ++oh) {
#pragma unroll
                for (int i = 0; i < P::ON / 2; ++i) {
                    o[oh][i] *= alpha[(i >> 1) & 1];
                }
            }
            hp::fence_regs(o);
            hp::wgmma_fence();
            issue_pv<HD, SW, BK, P::OH, P::ON>(o, pa,
                                                tile(stage) + P::TILE_BYTES);
            hp::wgmma_commit();
            hp::wgmma_wait<0>();
            hp::fence_regs(o);
            if (lane == 0) hp::mbar_arrive(&empty[stage]);
            if (++stage == P::STAGES) {
                stage = 0;
                phase ^= 1;
            }
        }

        // ---- epilogue: O / l through this consumer's Q rows ----
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
            l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
            l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
        }
        const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
        hp::named_barrier(1 + wg, 128);  // every warp's wgmma has read Q
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
                const int r = warp * 16 + lane / 4 + 8 * hi;
                const int byte = (j * 8 + 2 * quad) * 2;  // in the row
                const int off = r * SW + byte % SW;
                const int swz =
                    off ^ (((off >> 7) & (SW == 128 ? 7 : 3)) << 4);
                const int part = j / (P::ON / 8);
                const int x = 4 * (j % (P::ON / 8)) + 2 * hi;
                *reinterpret_cast<__nv_bfloat162*>(
                    qc + byte / SW * P::BQ * SW + swz) =
                    __floats2bfloat162_rn(o[part][x] * inv[hi],
                                          o[part][x + 1] * inv[hi]);
            }
        }
        hp::fence_async_shared();
        hp::named_barrier(1 + wg, 128);
        if (threadIdx.x % 128 == 0) {
            // Column blocks wholly past D hold zeros: not stored.
            for (int c = 0; c < P::BLOCKS && c * SW / 2 < D; ++c) {
                hp::tma_store_4d(&omap, qc + c * P::BQ * SW, c * SW / 2, h,
                                 row0, b);
            }
            hp::tma_store_commit();
            hp::tma_store_wait_read();
        }
        // The row logsumexp in the units of the scaled natural-log
        // logits, which the backward kernels recompute P = exp(S * scale
        // - lse) in.
        if (lse != nullptr && quad == 0) {
#pragma unroll
            for (int hi = 0; hi < 2; ++hi) {
                const int row = r_lo + 8 * hi;
                if (row < Sq) {
                    lse[(size_t)bh * Sq + row] =
                        (m[hi] + log2f(l[hi])) * kLn2;
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// f32: flash_tile.cuh's tile fold
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_prefill_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ o,
                          float* __restrict__ lse, int Sq, int Skv, int H,
                          int KV, int D, int causal, int window,
                          float scale) {
    using L = Layout<T, HD>;
    constexpr int TK = L::TK, LD = L::LD;
    constexpr int OC = HD / 2;  // output columns held by one lane

    extern __shared__ __align__(128) unsigned char smem[];
    const Smem<T, HD> sm(smem);

    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh % H;
    const int kvh = h / (H / KV);
    const int q_start = blockIdx.x * BQ;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;

    const size_t q_stride = (size_t)H * D;
    const size_t kv_stride = (size_t)KV * D;
    const T* qbase = q + ((size_t)b * Sq * H + h) * D;
    const T* kbase = k + ((size_t)b * Skv * KV + kvh) * D;
    const T* vbase = v + ((size_t)b * Skv * KV + kvh) * D;

    load_tile<T, HD, LD>(sm.Q, qbase, q_stride, q_start, Sq, D);

    int kt_begin, kt_end;
    kv_tiles<BQ, TK>(q_start, Sq, Skv, causal, window, kt_begin, kt_end);

    const int half = lane & 1;
    const int pos_q = q_start + warp * 16 + (lane >> 1);
    RowState<HD> st;

    __syncthreads();

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k_start = kt * TK;
        __syncthreads();  // every warp is done with the previous tile
        load_tile<T, HD, LD, TK>(sm.K, kbase, kv_stride, k_start, Skv, D);
        load_tile<T, HD, LD, TK>(sm.V, vbase, kv_stride, k_start, Skv, D);
        __syncthreads();

        const bool interior = interior_tile<BQ, TK>(q_start, k_start, Sq,
                                                    Skv, causal, window);
        fold_tile<T, HD>(sm, warp, lane, scale, interior,
                         [&](int col) {
                             return keeps(pos_q, k_start + col, Sq, Skv,
                                          causal, window);
                         },
                         st);
    }

    if (pos_q < Sq) {
        T* orow = o + (((size_t)b * Sq + pos_q) * H + h) * D + half * OC;
#pragma unroll
        for (int c = 0; c < OC; ++c) {
            if (half * OC + c < D) {
                orow[c] = istpu::from_float<T>(st.acc[c] / st.l);
            }
        }
        if (lse != nullptr && half == 0) {
            lse[(size_t)bh * Sq + pos_q] = st.m + logf(st.l);
        }
    }
}

template <typename T, int HD>
int launch_tile(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Sq, int Skv, int H, int KV, int D,
                float scale, int causal, int window, cudaStream_t stream) {
    const size_t smem = Layout<T, HD>::bytes();
    auto kern = flash_prefill_tile_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Sq + BQ - 1) / BQ, B * H);
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Skv, H, KV,
        D, causal, window, scale);
    return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Sq, int Skv, int H, int KV, int D,
               float scale, int causal, int window, cudaStream_t s) {
    return launch_tile<float, HD>(q, k, v, o, lse, B, Sq, Skv, H, KV, D,
                                  scale, causal, window, s);
}

// The tensor maps take the tensors' own D as their innermost dim: a
// column block that reaches past D is zero-filled on load and clipped on
// store (one wholly past D is not stored), so the capacity HD needs no
// padded copy.
template <int HD, int NC>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int Sq, int Skv, int H, int KV, int D,
                 float scale, int causal, int window, cudaStream_t stream) {
    using P = Plan<HD, NC>;
    CUtensorMap qm, km, vm, om;
    if (!hp::tensor_map(&qm, q, B, Sq, H, D, P::BQ, P::SW) ||
        !hp::tensor_map(&km, k, B, Skv, KV, D, P::BK, P::SW) ||
        !hp::tensor_map(&vm, v, B, Skv, KV, D, P::BK, P::SW) ||
        !hp::tensor_map(&om, o, B, Sq, H, D, kRows, P::SW)) {
        return (int)cudaErrorInvalidValue;
    }
    auto kern = flash_prefill_wgmma_kernel<HD, NC>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::bytes());
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(B * H, (Sq + P::BQ - 1) / P::BQ);
    const double log2e = 1.4426950408889634;
    kern<<<grid, P::THREADS, P::bytes(), stream>>>(
        qm, km, vm, om, lse, Sq, Skv, H, KV, D, causal, window,
        (float)(log2e * scale));
    return (int)cudaGetLastError();
}

// Consumers per CTA: two (128-row q tiles) unless that leaves SMs idle.
int consumers(int B, int Sq, int H) {
    return hp::consumers_for((long)((Sq + 2 * kRows - 1) / (2 * kRows)) * B *
                             H);
}

// bf16: the wgmma kernel at every capacity (Plan's tiles per hd).
template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Sq, int Skv, int H, int KV, int D,
                float scale, int causal, int window, cudaStream_t s) {
    if (consumers(B, Sq, H) == 1) {
        return launch_wgmma<HD, 1>(q, k, v, o, lse, B, Sq, Skv, H, KV, D,
                                   scale, causal, window, s);
    } else {
        return launch_wgmma<HD, 2>(q, k, v, o, lse, B, Sq, Skv, H, KV, D,
                                   scale, causal, window, s);
    }
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Skv, KV, D], out [B, Sq, H, D]; all
// contiguous, bf16 (is_bf16 = 1) or f32; D a multiple of 8 up to 256.
// scale: the softmax scale of the logits (D^-0.5 for the real D). lse:
// f32 [B, H, Sq], the row logsumexp of the scaled logits, or null for
// none. Returns cudaGetLastError().
extern "C" int istpu_flash_prefill(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int is_bf16,
                                   int B, int Sq, int Skv, int H, int KV,
                                   int D, float scale, int causal,
                                   int window, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ISTPU_HD(fn)                                                        \
    switch (istpu::head_dim_capacity(D)) {                                  \
        case 32: return fn<32>(q, k, v, out, lse, B, Sq, Skv, H, KV, D,     \
                               scale, causal, window, s);                   \
        case 64: return fn<64>(q, k, v, out, lse, B, Sq, Skv, H, KV, D,     \
                               scale, causal, window, s);                   \
        case 128: return fn<128>(q, k, v, out, lse, B, Sq, Skv, H, KV, D,   \
                                 scale, causal, window, s);                 \
        case 256: return fn<256>(q, k, v, out, lse, B, Sq, Skv, H, KV, D,   \
                                 scale, causal, window, s);                 \
        default: return (int)cudaErrorInvalidValue;                         \
    }
    if (is_bf16) {
        ISTPU_HD(launch_bf16)
    }
    ISTPU_HD(launch_f32)
#undef ISTPU_HD
}
