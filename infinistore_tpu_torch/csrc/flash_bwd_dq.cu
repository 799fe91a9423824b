// Flash attention backward, dQ (causal GQA, rectangular diagonal,
// optional sliding window) for Hopper, sm_90a.
//
// Replaces: infinistore_tpu/ops/pallas_flash_attention.py::_bwd_dq_kernel
// (kernel A of _flash_backward, reached through _flash_with_vjp's
// backward).
//
// What bounds it on an H100: operations. Each live (query, key) pair
// costs three products over hd (S = Q K^T recomputed, dP = dO V^T,
// dQ += dS K): at Sq = Skv = 2048, hd = 128, 32 heads and causal, ~5.2e10
// FLOP against ~5e7 bytes of q/k/v/dO/dq, far above the card's ~295
// FLOP/byte balance point, so the tensor cores are the limit (989
// TFLOP/s bf16 dense), and only wgmma reaches their rate.
//
// Design of the bf16 kernel (every capacity: hd 32, 64, 128 and 256).
// The TPU grid walks the kv blocks innermost with the dq sum in VMEM
// scratch; Hopper blocks run in no order, so one CTA owns one (batch *
// head, q tile of NC * 64 rows) and loops over the live kv tiles itself,
// with K1's live range, interior rule and mask (flash_tile.cuh) at 64-key
// tiles. It is the flash prefill kernel's skeleton (flash_prefill.cu)
// with one more product: one producer warpgroup loads Q and dO once and
// the kv head's 64-row K and V tiles through a ring of shared-memory
// stages by TMA (full / empty mbarriers, 128-byte swizzle, 64-byte at hd
// 32, out of bounds zero fill); NC consumer warpgroups of 64 q rows each
// run S = Q K^T and dP = dO V^T on wgmma (both operands K-major in
// shared memory, issued together), form P = exp2(S * scale * log2 e -
// lse * log2 e) and dS = P (dP - D) scale on the accumulator fragments in
// registers (masked pairs exactly 0, the mask built only on boundary
// tiles), round dS to bf16 as the TPU kernel rounds it
// (ds.astype(k.dtype)) straight into the register A fragments of dQ +=
// dS K, which reads K MN-major through the transpose bit, as K1 reads V.
// S, dP, dS and dQ never pass through shared memory; a stage is released
// once the dQ products that read its K have been waited for. A consumer
// whose own rows see none of a tile skips its products. dQ goes out
// once, in q's dtype, through the consumer's part of the Q tile by TMA
// stores, which write no row past Sq and no column past D. Heavy q tiles
// (the most live kv tiles under a causal mask) launch first. Tiles of
// 64 keys, not K1's 128: dS is a third product's operand.
//
// The tile sizes per head dim (Plan). A consumer thread holds dQ's
// [64 x hd] f32 accumulator (hd / 2 registers), S and dP (32 each at
// 64-key tiles) and dS's bf16 A fragments (16), against the 240
// registers setmaxnreg gives each of two consumers (255 for a lone one);
// shared memory holds Q and dO for the CTA's rows (2 * NC * 64 * hd * 2
// bytes) and the ring of K + V stages (2 * 64 * hd * 2 bytes each) in
// 227 KB.
// - hd <= 128: dQ takes at most 64 registers. Two consumers per CTA
//   (128-row q tiles) unless the grid would leave SMs idle, then one;
//   the ring holds four stages.
// - hd 256 (every D from 136 to 256; the column blocks past D are
//   zero-filled on load and not stored): dQ [64 x 256] is 128 registers,
//   two accumulators of 128 columns, and dQ += dS K is issued as two N =
//   128 products over K's two halves of column blocks, as K1 issues P V
//   at hd 256. One consumer per CTA: a thread holds 128 + 32 + 32 + 16 =
//   208 registers, Q and dO take 64 KB and a stage 64 KB, so the ring
//   holds two stages. Two consumers would leave room for one 64-key
//   stage (128 KB of Q and dO), which is no ring; at 32-key tiles they
//   fit three, but on an H100, timed in turns, that read 0.138 against
//   this plan's 0.142 ms at Gemma-7B's 16 heads (within the spread
//   between builds) and 0.121 against 0.070 ms at Gemma-2B's 8, so it is
//   not kept. Splitting dQ's columns between two consumers of the same
//   rows, as K6 splits dK and dV, would recompute S and dP in both: five
//   products for three.
//
// The f32 variant keeps flash_tile.cuh's tile loop (plain FMA loops, so
// that f32 stays true f32): 4 warps of 16 q rows, dQ in registers across
// kv tiles of 64 rows (32 at hd 256, so that the tiles fit in shared
// memory).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "flash_tile.cuh"
#include "hopper.cuh"

namespace {

using istpu::from_float;
using namespace istpu::tile;
namespace hp = istpu::hopper;

// ---------------------------------------------------------------------------
// bf16: TMA ring and warp-specialised wgmma
// ---------------------------------------------------------------------------

constexpr int kRows = 64;  // q rows per consumer warpgroup
constexpr int kBK = 64;    // kv rows per tile
constexpr int kSmemLimit = 232448;  // shared memory one block may use
constexpr float kLog2e = 1.4426950408889634f;

template <int HD, int NC>
struct Plan {
    static constexpr int BQ = NC * kRows;  // q rows per CTA
    static constexpr int THREADS = (NC + 1) * 128;
    // Swizzle width = bytes of one row of a column block; a row of HD
    // bf16 is BLOCKS column blocks of SW / 2 elements.
    static constexpr int SW = HD * 2 >= 128 ? 128 : HD * 2;
    static constexpr int BLOCKS = HD * 2 / SW;
    // dQ's accumulators: OH parts of ON columns, one dS K wgmma (N = ON)
    // each.
    static constexpr int OH = HD > 128 ? 2 : 1;
    static constexpr int ON = HD / OH;
    static constexpr int Q_BYTES = BQ * HD * 2;      // Q, and again dO
    static constexpr int TILE_BYTES = kBK * HD * 2;  // one K or V tile
    static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
    static constexpr int FIT = (kSmemLimit - 1024 - 256 - 2 * Q_BYTES) /
                               STAGE_BYTES;
    static constexpr int STAGES = FIT < 4 ? FIT : 4;
    static_assert(STAGES >= 2, "the ring needs two stages");
    // 1024 bytes of room to align the tiles, the tiles, the barriers.
    static constexpr size_t bytes() {
        return 1024 + 2 * Q_BYTES + (size_t)STAGES * STAGE_BYTES +
               8 * (1 + 2 * STAGES);
    }
};

// D[64 x 64] += A B^T, issued but not waited for: A one consumer's 64
// rows (column block 0 at `a`, blocks `a_blk` bytes apart), B a staged
// 64-row tile, both K-major; 16 head-dim columns (32 bytes) a step.
template <int HD, int SW>
__device__ __forceinline__ void issue_abt(float (&d)[32],
                                          const unsigned char* a, int a_blk,
                                          const unsigned char* b) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
        const int blk = kk * 32 / SW, off = kk * 32 % SW;
        hp::wgmma_ss_n64(
            d, hp::smem_desc(a + blk * a_blk + off, 16, 8 * SW, SW),
            hp::smem_desc(b + blk * kBK * SW + off, 16, 8 * SW, SW), 1);
    }
}

// dQ[64 x HD] += dS[64 x 64] K, issued but not waited for: dS bf16
// register fragments, K a staged 64-row tile read MN-major (transposed),
// 16 of its rows a step, one wgmma per part of dQ (part h reads K's
// column blocks from h * ON * 2 / SW on).
template <int SW, int OH, int ON>
__device__ __forceinline__ void issue_ab(float (&d)[OH][ON / 2],
                                         const uint32_t (&a)[kBK / 16][4],
                                         const unsigned char* b) {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < OH; ++h) {
            const uint64_t desc = hp::smem_desc(
                b + h * (ON * 2 / SW) * kBK * SW + kk * 16 * SW, kBK * SW,
                8 * SW, SW);
            if constexpr (ON == 128) {
                hp::wgmma_rs_n128(d[h], a[kk], desc, 1);
            } else if constexpr (ON == 64) {
                hp::wgmma_rs_n64(d[h], a[kk], desc, 1);
            } else {
                hp::wgmma_rs_n32(d[h], a[kk], desc, 1);
            }
        }
    }
}

template <int HD, int NC>
__global__ void __launch_bounds__(Plan<HD, NC>::THREADS, 1)
flash_bwd_dq_wgmma_kernel(__grid_constant__ const CUtensorMap qmap,
                          __grid_constant__ const CUtensorMap kmap,
                          __grid_constant__ const CUtensorMap vmap,
                          __grid_constant__ const CUtensorMap domap,
                          __grid_constant__ const CUtensorMap dqmap,
                          const float* __restrict__ lse,
                          const float* __restrict__ dvec, int Sq, int Skv,
                          int H, int KV, int D, int causal, int window,
                          float scale) {
    using P = Plan<HD, NC>;
    constexpr int SW = P::SW;

    extern __shared__ unsigned char smem_raw[];
    unsigned char* const sQ =
        smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
    unsigned char* const sdO = sQ + P::Q_BYTES;
    // Stage s: K at sKV + s * STAGE_BYTES, V TILE_BYTES after it. Every
    // tile is [BLOCKS][rows][SW bytes], 1024-byte aligned.
    unsigned char* const sKV = sdO + P::Q_BYTES;
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
    kv_tiles<P::BQ, kBK>(q_start, Sq, Skv, causal, window, kt_begin, kt_end);

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
            hp::mbar_expect_tx(q_full, 2 * P::Q_BYTES);
            for (int c = 0; c < P::BLOCKS; ++c) {
                hp::tma_load_4d(sQ + c * P::BQ * SW, &qmap, q_full,
                                c * SW / 2, h, q_start, b);
                hp::tma_load_4d(sdO + c * P::BQ * SW, &domap, q_full,
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
                    hp::tma_load_4d(sK + c * kBK * SW, &kmap, &full[stage],
                                    c * SW / 2, kvh, kt * kBK, b);
                    hp::tma_load_4d(sV + c * kBK * SW, &vmap, &full[stage],
                                    c * SW / 2, kvh, kt * kBK, b);
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
        // This consumer's rows of Q and dO in column block c: + c * BQ * SW.
        unsigned char* const qc = sQ + wg * kRows * SW;
        unsigned char* const dc = sdO + wg * kRows * SW;
        const float scale_log2 = scale * kLog2e;

        // The kv tiles this consumer's own rows see (none past Sq).
        int own_begin = 0, own_end = 0;
        if (row0 < Sq) {
            kv_tiles<kRows, kBK>(row0, Sq, Skv, causal, window, own_begin,
                                 own_end);
        }
        // Its two rows' lse (in log2 units) and D.
        float lse2[2], dd[2];
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
            const int row = r_lo + 8 * hi;
            lse2[hi] = row < Sq ? lse[(size_t)bh * Sq + row] * kLog2e : 0.0f;
            dd[hi] = row < Sq ? dvec[(size_t)bh * Sq + row] : 0.0f;
        }

        // dQ's column c is part c / ON, dq[c / ON][4 (c % ON / 8) + ...].
        float dq[P::OH][P::ON / 2];
#pragma unroll
        for (int oh = 0; oh < P::OH; ++oh) {
#pragma unroll
            for (int i = 0; i < P::ON / 2; ++i) dq[oh][i] = 0.0f;
        }

        const auto tile = [&](int st) { return sKV + st * P::STAGE_BYTES; };
        int stage = 0;
        uint32_t phase = 0;
        hp::mbar_wait(q_full, 0);
        for (int kt = kt_begin; kt < kt_end; ++kt) {
            hp::mbar_wait(&full[stage], phase);
            if (kt >= own_begin && kt < own_end) {
                const int k_start = kt * kBK;
                float s[32], dp[32];
#pragma unroll
                for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
                hp::fence_regs(s);
                hp::fence_regs(dp);
                hp::wgmma_fence();
                issue_abt<HD, SW>(s, qc, P::BQ * SW, tile(stage));
                issue_abt<HD, SW>(dp, dc, P::BQ * SW,
                                  tile(stage) + P::TILE_BYTES);
                hp::wgmma_commit();
                hp::wgmma_wait<0>();
                hp::fence_regs(s);
                hp::fence_regs(dp);

                // dS = P (dP - D) scale in bf16 A fragments: s[4j + e] is
                // row r_lo + 8 (e / 2), key k_start + 8j + 2 quad + e % 2;
                // key pair (i, i + 1) goes to step i / 8, register
                // (i / 2) % 4.
                const bool interior = interior_tile<kRows, kBK>(
                    row0, k_start, Sq, Skv, causal, window);
                uint32_t da[kBK / 16][4];
#pragma unroll
                for (int i = 0; i < 32; i += 2) {
                    const int hi = (i >> 1) & 1;
                    const int key = k_start + (i >> 2) * 8 + 2 * quad;
                    float p0 = exp2f(s[i] * scale_log2 - lse2[hi]);
                    float p1 = exp2f(s[i + 1] * scale_log2 - lse2[hi]);
                    if (!interior) {
                        const int row = r_lo + 8 * hi;
                        if (!keeps(row, key, Sq, Skv, causal, window)) {
                            p0 = 0.0f;
                        }
                        if (!keeps(row, key + 1, Sq, Skv, causal, window)) {
                            p1 = 0.0f;
                        }
                    }
                    const __nv_bfloat162 pk = __floats2bfloat162_rn(
                        p0 * (dp[i] - dd[hi]) * scale,
                        p1 * (dp[i + 1] - dd[hi]) * scale);
                    da[i / 8][(i / 2) % 4] =
                        *reinterpret_cast<const uint32_t*>(&pk);
                }

                hp::fence_regs(dq);
                hp::wgmma_fence();
                issue_ab<SW, P::OH, P::ON>(dq, da, tile(stage));
                hp::wgmma_commit();
                hp::wgmma_wait<0>();
                hp::fence_regs(dq);
            }
            if (lane == 0) hp::mbar_arrive(&empty[stage]);
            if (++stage == P::STAGES) {
                stage = 0;
                phase ^= 1;
            }
        }

        // ---- epilogue: dQ through this consumer's Q rows ----
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
                    __floats2bfloat162_rn(dq[part][x], dq[part][x + 1]);
            }
        }
        hp::fence_async_shared();
        hp::named_barrier(1 + wg, 128);
        if (threadIdx.x % 128 == 0) {
            // Column blocks wholly past D hold zeros: not stored.
            for (int c = 0; c < P::BLOCKS && c * SW / 2 < D; ++c) {
                hp::tma_store_4d(&dqmap, qc + c * P::BQ * SW, c * SW / 2, h,
                                 row0, b);
            }
            hp::tma_store_commit();
            hp::tma_store_wait_read();
        }
    }
}

// The tensor maps take the tensors' own D as their innermost dim: a
// column block that reaches past D is zero-filled on load and clipped on
// store (one wholly past D is not stored), as K1's do.
template <int HD, int NC>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* dvec,
                 void* dq, int B, int Sq, int Skv, int H, int KV, int D,
                 float scale, int causal, int window, cudaStream_t stream) {
    using P = Plan<HD, NC>;
    CUtensorMap qm, km, vm, dom, dqm;
    if (!hp::tensor_map(&qm, q, B, Sq, H, D, P::BQ, P::SW) ||
        !hp::tensor_map(&km, k, B, Skv, KV, D, kBK, P::SW) ||
        !hp::tensor_map(&vm, v, B, Skv, KV, D, kBK, P::SW) ||
        !hp::tensor_map(&dom, dout, B, Sq, H, D, P::BQ, P::SW) ||
        !hp::tensor_map(&dqm, dq, B, Sq, H, D, kRows, P::SW)) {
        return (int)cudaErrorInvalidValue;
    }
    auto kern = flash_bwd_dq_wgmma_kernel<HD, NC>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::bytes());
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(B * H, (Sq + P::BQ - 1) / P::BQ);
    kern<<<grid, P::THREADS, P::bytes(), stream>>>(
        qm, km, vm, dom, dqm, lse, dvec, Sq, Skv, H, KV, D, causal, window,
        scale);
    return (int)cudaGetLastError();
}

// Consumers per CTA: two (128-row q tiles) unless that leaves SMs idle.
int consumers(int B, int Sq, int H) {
    return hp::consumers_for((long)((Sq + 2 * kRows - 1) / (2 * kRows)) * B *
                             H);
}

// ---------------------------------------------------------------------------
// f32: flash_tile.cuh's tile loop
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec, T* __restrict__ dq,
                         int Sq, int Skv, int H, int KV, int D, int causal,
                         int window, float scale) {
    using L = Layout<T, HD>;
    constexpr int TK = L::TK, LD = L::LD, SLD = L::SLD, PLD = L::PLD;
    constexpr int SC = TK / 2;  // S columns held by one lane

    extern __shared__ __align__(128) unsigned char smem[];
    const BwdSmem<T, HD> sm(smem);
    T* const sQ = sm.own[0];
    T* const sdO = sm.own[1];
    T* const sK = sm.walk[0];
    T* const sV = sm.walk[1];

    const int bh = blockIdx.y;
    const int b = bh / H;
    const int h = bh % H;
    const int kvh = h / (H / KV);
    const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int r = lane >> 1;
    const int half = lane & 1;

    const size_t q_stride = (size_t)H * D;
    const size_t kv_stride = (size_t)KV * D;
    const T* qbase = q + ((size_t)b * Sq * H + h) * D;
    const T* dobase = dout + ((size_t)b * Sq * H + h) * D;
    const T* kbase = k + ((size_t)b * Skv * KV + kvh) * D;
    const T* vbase = v + ((size_t)b * Skv * KV + kvh) * D;

    load_tile<T, HD, LD>(sQ, qbase, q_stride, q_start, Sq, D);
    load_tile<T, HD, LD>(sdO, dobase, q_stride, q_start, Sq, D);

    int kt_begin, kt_end;
    kv_tiles<BQ, TK>(q_start, Sq, Skv, causal, window, kt_begin, kt_end);

    const int pos_q = q_start + warp * 16 + r;
    const float row_lse = pos_q < Sq ? lse[(size_t)bh * Sq + pos_q] : 0.0f;
    const float row_d = pos_q < Sq ? dvec[(size_t)bh * Sq + pos_q] : 0.0f;
    float* Sw = sm.S + warp * 16 * SLD;
    T* Pw = sm.P + warp * 16 * PLD;
    const T* Qw = sQ + warp * 16 * LD;
    const T* dOw = sdO + warp * 16 * LD;
    RowAcc<T, HD> acc;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k_start = kt * TK;
        __syncthreads();  // every warp is done with the previous tile
        load_tile<T, HD, LD, TK>(sK, kbase, kv_stride, k_start, Skv, D);
        load_tile<T, HD, LD, TK>(sV, vbase, kv_stride, k_start, Skv, D);
        __syncthreads();
        const bool interior = interior_tile<BQ, TK>(q_start, k_start, Sq,
                                                    Skv, causal, window);

        // P = exp(Q K^T * scale - lse), masked pairs exactly 0.
        abt<T, HD>(Qw, sK, Sw, lane);
        __syncwarp();
        float p[SC];
#pragma unroll
        for (int j = 0; j < SC; ++j) {
            const int col = half * SC + j;
            const bool ok = interior || keeps(pos_q, k_start + col, Sq, Skv,
                                              causal, window);
            p[j] = ok ? expf(Sw[r * SLD + col] * scale - row_lse) : 0.0f;
        }
        __syncwarp();

        // dS = P (dO V^T - D) scale, rounded to T for the product.
        abt<T, HD>(dOw, sV, Sw, lane);
        __syncwarp();
#pragma unroll
        for (int j = 0; j < SC; ++j) {
            const int col = half * SC + j;
            Pw[r * PLD + col] =
                from_float<T>(p[j] * (Sw[r * SLD + col] - row_d) * scale);
        }
        __syncwarp();

        // dQ += dS K
        acc.add_ab(Pw, sK, lane);
        __syncwarp();
    }

    T* dst = dq + (((size_t)b * Sq + pos_q) * H + h) * D + half * (HD / 2);
    acc.store(dst, pos_q < Sq, D - half * (HD / 2));
}

template <typename T, int HD>
int launch_tile(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* dvec,
                void* dq, int B, int Sq, int Skv, int H, int KV, int D,
                float scale, int causal, int window, cudaStream_t stream) {
    const size_t smem = BwdLayout<T, HD>::bytes();
    auto kern = flash_bwd_dq_tile_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Sq + BQ - 1) / BQ, B * H);
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, dvec,
        static_cast<T*>(dq), Sq, Skv, H, KV, D, causal, window, scale);
    return (int)cudaGetLastError();
}

// bf16: the wgmma kernel at every capacity; one consumer per CTA at hd
// 256, else by consumers().
template <int HD>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* dvec,
                void* dq, int B, int Sq, int Skv, int H, int KV, int D,
                float scale, int causal, int window, cudaStream_t s) {
    if constexpr (HD > 128) {
        return launch_wgmma<HD, 1>(q, k, v, dout, lse, dvec, dq, B, Sq, Skv,
                                   H, KV, D, scale, causal, window, s);
    } else if (consumers(B, Sq, H) == 1) {
        return launch_wgmma<HD, 1>(q, k, v, dout, lse, dvec, dq, B, Sq, Skv,
                                   H, KV, D, scale, causal, window, s);
    } else {
        return launch_wgmma<HD, 2>(q, k, v, dout, lse, dvec, dq, B, Sq, Skv,
                                   H, KV, D, scale, causal, window, s);
    }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* dvec,
               void* dq, int B, int Sq, int Skv, int H, int KV, int D,
               float scale, int causal, int window, cudaStream_t s) {
    return launch_tile<float, HD>(q, k, v, dout, lse, dvec, dq, B, Sq, Skv,
                                  H, KV, D, scale, causal, window, s);
}

}  // namespace

// q/dout/dq [B, Sq, H, D], k/v [B, Skv, KV, D], bf16 (is_bf16 = 1) or
// f32, D a multiple of 8 up to 256; scale: the forward's softmax scale;
// lse (the forward's row logsumexp of the scaled logits) and dvec
// (rowsum(dO * O)) f32 [B, H, Sq]; all contiguous. Returns
// cudaGetLastError().
extern "C" int istpu_flash_bwd_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* dvec,
                                  void* dq, int is_bf16, int B, int Sq,
                                  int Skv, int H, int KV, int D, float scale,
                                  int causal, int window, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ISTPU_HD(fn)                                                        \
    switch (istpu::head_dim_capacity(D)) {                                  \
        case 32: return fn<32>(q, k, v, dout, lse, dvec, dq, B, Sq, Skv, H, \
                               KV, D, scale, causal, window, s);            \
        case 64: return fn<64>(q, k, v, dout, lse, dvec, dq, B, Sq, Skv, H, \
                               KV, D, scale, causal, window, s);            \
        case 128: return fn<128>(q, k, v, dout, lse, dvec, dq, B, Sq, Skv,  \
                                 H, KV, D, scale, causal, window, s);       \
        case 256: return fn<256>(q, k, v, dout, lse, dvec, dq, B, Sq, Skv,  \
                                 H, KV, D, scale, causal, window, s);       \
        default: return (int)cudaErrorInvalidValue;                         \
    }
    if (is_bf16) {
        ISTPU_HD(launch_bf16)
    }
    ISTPU_HD(launch_f32)
#undef ISTPU_HD
}
