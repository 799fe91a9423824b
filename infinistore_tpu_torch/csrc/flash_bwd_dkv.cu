// Flash attention backward, dK and dV (causal GQA, rectangular diagonal,
// optional sliding window) for Hopper, sm_90a.
//
// Replaces: infinistore_tpu/ops/pallas_flash_attention.py::_bwd_dkv_kernel
// and the GQA sum after it (kernel B of _flash_backward, reached through
// _flash_with_vjp's backward).
//
// What bounds it on an H100: operations. Each live (query, key) pair
// costs four products over hd (S^T = K Q^T recomputed, dP^T = V dO^T,
// dV += P^T dO, dK += dS^T Q): at Sq = Skv = 2048, hd = 128, 32 heads and
// causal, ~6.9e10 FLOP against ~5e7 bytes, far above the card's ~295
// FLOP/byte balance point, so the tensor cores are the limit (989
// TFLOP/s bf16 dense), and only wgmma reaches their rate.
//
// Design. The TPU kernel runs one grid row per q head with the q blocks
// innermost, writes per-head [B*H, Skv, D] dk/dv and leaves the sum over
// each GQA group to XLA. Here one CTA owns one (batch * kv head, tile of
// kv rows) and walks the group's q heads and, for each, the live q tiles
// (flash_tile.cuh's q_tiles, the mirror of K1's kv range), in the
// transposed frame: S^T = K Q^T, P^T = exp(S^T * scale - lse), dV +=
// P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - D) scale, dK += dS^T Q, with
// P and dS rounded to bf16 before their products as the TPU kernel
// rounds them. dK and dV sum the whole group in f32 registers, so the
// group sum needs no atomics, is deterministic, and each is written once
// per kv head, in k's dtype. A kv row no query sees (past a window, or in
// a tile with no live q tile) gets exactly zero.
//
// The bf16 kernel: one CTA owns 64 kv rows, with two consumer
// warpgroups and one producer warpgroup. The producer loads the CTA's K
// and V tiles once, then one (group member, live q tile) a stage
// through a ring of shared-memory stages by TMA: its 64-row Q and dO
// tiles (full / empty mbarriers, 128-byte swizzle, 64-byte at hd 32, out
// of bounds zero fill). lse and D vary along the accumulators' columns,
// so a second producer warp stages the 64 queries' values in shared
// memory with each stage (read before the stage frees, arriving on its
// full barrier): read from device memory by the consumers after each
// product instead, their latency cost K6 a third of its time. Per stage
// a consumer issues S^T = K Q^T and dP^T = V dO^T together on wgmma
// (K-major operands, N = 64), forms P^T and dS^T on the accumulator
// fragments in registers (masked pairs exactly 0, the mask built only on
// boundary tiles) and packs both into bf16 register A fragments, then
// issues dV += P^T dO and dK += dS^T Q on wgmma, reading the same
// swizzled dO and Q tiles MN-major through the transpose bit. S^T, P^T,
// dP^T and dS^T never pass through shared memory. A stage is released
// once dK's product, the last to read its Q, has been waited for. Kv
// tile 0, the heaviest under a causal mask, launches first.
//
// How the consumers share the work depends on the head dim.
// - hd 32, 64, 128: the two consumers take the stages in turn, each into
//   its own dK and dV of the whole head: under a causal mask kv tile 0
//   has 32x the stages of the last, so splitting a CTA's stages (and not
//   its rows) keeps both consumers of the heavy tiles busy, and two
//   consumers on an SM hide each other's waits. At the end consumer 1
//   hands its sums to consumer 0 through the idle ring (a fixed order,
//   so the result is the same on every run), which writes dK and dV
//   through the K and V tiles by TMA stores that write no row past Skv.
// - hd 256 (every D from 136 to 256): dK and dV of 64 rows x 256 would
//   be 256 f32 registers a thread, so each consumer owns one half of the
//   columns, dK[:, half] and dV[:, half] (128 registers), and both take
//   every stage. Each recomputes S^T and dP^T over all 256 dims (32
//   registers each): 1.5x the products of one pass, with no exchange
//   through shared memory and no barrier between the two in the loop.
//   The ring holds two stages (K and V 64 KB, a stage 64 KB). Each
//   consumer writes its half through its half of the K and V tiles.
//   Where the grid of ceil(Skv / 64) * B * KV CTAs is smaller than the
//   card (Gemma-2B's one kv head: 32 CTAs on 132 SMs), each kv head's
//   group of q heads is split into `splits` runs of heads (a divisor of
//   the group, chosen by ops/flash_attention.py's k6_splits), one CTA
//   each; the splits of one kv tile launch side by side. Each CTA then
//   writes its f32 sums into a workspace, and a second small kernel adds
//   the splits in split order and rounds to bf16: no atomics, and two
//   launches are byte-equal.
//
// The f32 variant keeps flash_tile.cuh's tile loop (plain FMA loops, so
// that f32 stays true f32): 4 warps of 16 kv rows, q tiles of 64 rows
// (32 at hd 256, so that the tiles fit in shared memory). At hd 256 two
// f32 accumulators of the whole head (128 registers each) would not fit
// beside the rest, so each CTA of a pair (grid.z) recomputes S^T and
// dP^T over all 256 dims and accumulates its own 128 columns of dK and
// dV.
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

constexpr int kRows = 64;  // kv rows per CTA
constexpr int kBQ = 64;    // q rows per stage
constexpr int kNC = 2;     // consumer warpgroups
constexpr int kSmemLimit = 232448;  // shared memory one block may use
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Plan {
    static constexpr int THREADS = (kNC + 1) * 128;
    // Swizzle width = bytes of one row of a column block; a row of HD
    // bf16 is BLOCKS column blocks of SW / 2 elements.
    static constexpr int SW = HD * 2 >= 128 ? 128 : HD * 2;
    static constexpr int BLOCKS = HD * 2 / SW;
    // hd 256: each consumer owns COLS = HD / 2 columns of dK and dV and
    // reads every stage; else both own all HD and take the stages in
    // turn.
    static constexpr bool HALVES = HD > 128;
    static constexpr int COLS = HALVES ? HD / 2 : HD;
    static constexpr int COL_BLOCKS = COLS * 2 / SW;  // of one consumer
    static constexpr int READERS = HALVES ? kNC : 1;  // consumers a stage
    static constexpr int KV_BYTES = kRows * HD * 2;   // K, and again V
    static constexpr int TILE_BYTES = kBQ * HD * 2;   // one Q or dO tile
    static constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // by TMA
    static constexpr int ROW_BYTES = 2 * kBQ * 4;       // lse and D
    static constexpr int FIT = (kSmemLimit - 1024 - 256 - 2 * KV_BYTES) /
                               (STAGE_BYTES + ROW_BYTES);
    static constexpr int STAGES = FIT < 4 ? FIT : 4;
    static_assert(STAGES >= 2, "the ring needs two stages");
    // In turns, consumer c takes the stages i with i % kNC == c, so each
    // ring slot serves one consumer.
    static_assert(HALVES || STAGES % kNC == 0,
                  "ring slots split among consumers");
    // 1024 bytes of room to align the tiles, the tiles, each stage's lse
    // and D, the barriers.
    static constexpr size_t bytes() {
        return 1024 + 2 * KV_BYTES +
               (size_t)STAGES * (STAGE_BYTES + ROW_BYTES) +
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
            hp::smem_desc(b + blk * kBQ * SW + off, 16, 8 * SW, SW), 1);
    }
}

// D[64 x N] += A[64 x 64] B, issued but not waited for: A bf16 register
// fragments, B N columns of a staged 64-row tile (from column block 0 at
// `b`) read MN-major (transposed), 16 of its rows a step.
template <int N, int SW>
__device__ __forceinline__ void issue_ab(float (&d)[N / 2],
                                         const uint32_t (&a)[kBQ / 16][4],
                                         const unsigned char* b) {
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
        const uint64_t desc = hp::smem_desc(b + kk * 16 * SW, kBQ * SW,
                                            8 * SW, SW);
        if constexpr (N == 128) {
            hp::wgmma_rs_n128(d, a[kk], desc, 1);
        } else if constexpr (N == 64) {
            hp::wgmma_rs_n64(d, a[kk], desc, 1);
        } else {
            hp::wgmma_rs_n32(d, a[kk], desc, 1);
        }
    }
}

// Write a consumer's accumulator of N columns (rows of its warpgroup, f32
// fragments) as bf16 into its 64 rows of a swizzled tile (from column
// block 0 at `rows`, blocks `blk` bytes apart).
template <int N, int SW>
__device__ __forceinline__ void stage_out(const float (&d)[N / 2],
                                          unsigned char* rows, int blk,
                                          int warp, int lane) {
    const int quad = lane % 4;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
            const int r = warp * 16 + lane / 4 + 8 * hi;
            const int byte = (j * 8 + 2 * quad) * 2;  // in the row
            const int off = r * SW + byte % SW;
            const int swz = off ^ (((off >> 7) & (SW == 128 ? 7 : 3)) << 4);
            *reinterpret_cast<__nv_bfloat162*>(rows + byte / SW * blk +
                                               swz) =
                __floats2bfloat162_rn(d[4 * j + 2 * hi],
                                      d[4 * j + 2 * hi + 1]);
        }
    }
}

// The f32 sums of a consumer's N columns (from column c0) straight to
// device memory: `out` is a [B, Skv, KV, D] f32 tensor of the workspace.
template <int N>
__device__ __forceinline__ void store_partial(const float (&d)[N / 2],
                                              float* out, int b, int kvh,
                                              int k_start, int c0, int Skv,
                                              int KV, int D, int warp,
                                              int lane) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
            const int row = k_start + warp * 16 + lane / 4 + 8 * hi;
            const int col = c0 + 8 * j + 2 * (lane % 4);
            if (row < Skv && col < D) {
                *reinterpret_cast<float2*>(
                    out + (((size_t)b * Skv + row) * KV + kvh) * D + col) =
                    make_float2(d[4 * j + 2 * hi], d[4 * j + 2 * hi + 1]);
            }
        }
    }
}

template <int HD>
__global__ void __launch_bounds__(Plan<HD>::THREADS, 1)
flash_bwd_dkv_wgmma_kernel(__grid_constant__ const CUtensorMap qmap,
                           __grid_constant__ const CUtensorMap kmap,
                           __grid_constant__ const CUtensorMap vmap,
                           __grid_constant__ const CUtensorMap domap,
                           __grid_constant__ const CUtensorMap dkmap,
                           __grid_constant__ const CUtensorMap dvmap,
                           const float* __restrict__ lse,
                           const float* __restrict__ dvec,
                           float* __restrict__ partial, int splits, int Sq,
                           int Skv, int H, int KV, int D, int causal,
                           int window, float scale) {
    using P = Plan<HD>;
    constexpr int SW = P::SW;

    extern __shared__ unsigned char smem_raw[];
    unsigned char* const sK =
        smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
    unsigned char* const sV = sK + P::KV_BYTES;
    // Stage s: Q at sQD + s * STAGE_BYTES, dO TILE_BYTES after it. Every
    // tile is [BLOCKS][rows][SW bytes], 1024-byte aligned.
    unsigned char* const sQD = sV + P::KV_BYTES;
    // Stage s's lse (log2 units) at sLseD + 2 s kBQ, its D kBQ after.
    float* const sLseD =
        reinterpret_cast<float*>(sQD + P::STAGES * P::STAGE_BYTES);
    uint64_t* const kv_full =
        reinterpret_cast<uint64_t*>(sLseD + P::STAGES * 2 * kBQ);
    uint64_t* const full = kv_full + 1;
    uint64_t* const empty = full + P::STAGES;

    // The splits of one (batch, kv head) are neighbours in x, so the
    // splits of one kv tile launch side by side.
    const int split = blockIdx.x % splits;
    const int b = blockIdx.x / splits / KV;
    const int kvh = blockIdx.x / splits % KV;
    const int group = H / KV;
    // This CTA's run of the group's q heads: members [g_lo, g_lo +
    // members).
    const int g_lo = split * group / splits;
    const int members = (split + 1) * group / splits - g_lo;
    // Kv tile 0 first: under a causal mask it sees the most q tiles.
    const int k_start = blockIdx.y * kRows;
    int qt_begin, qt_end;
    q_tiles<kBQ, kRows>(k_start, Sq, Skv, causal, window, qt_begin, qt_end);
    // The walk: stage i is member g_lo + i / n_qt, q tile qt_begin + i %
    // n_qt.
    const int n_qt = qt_end - qt_begin;
    const int stages = members * n_qt;

    if (threadIdx.x == 0) {
        hp::mbar_init(kv_full, 1);
        for (int s = 0; s < P::STAGES; ++s) {
            // The TMA thread's arrival, and one from each lane of the
            // warp that stages lse and D.
            hp::mbar_init(&full[s], 1 + 32);
            // One arrival per warp of each consumer that reads the stage.
            hp::mbar_init(&empty[s], 4 * P::READERS);
        }
        hp::fence_barrier_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == kNC) {
        // ---- producer ----
        hp::regs_dealloc<24>();
        if (threadIdx.x == kNC * 128) {
            hp::mbar_expect_tx(kv_full, 2 * P::KV_BYTES);
            for (int c = 0; c < P::BLOCKS; ++c) {
                hp::tma_load_4d(sK + c * kRows * SW, &kmap, kv_full,
                                c * SW / 2, kvh, k_start, b);
                hp::tma_load_4d(sV + c * kRows * SW, &vmap, kv_full,
                                c * SW / 2, kvh, k_start, b);
            }
            int stage = 0;
            uint32_t phase = 0;
            for (int i = 0; i < stages; ++i) {
                const int h = kvh * group + g_lo + i / n_qt;
                const int q_start = (qt_begin + i % n_qt) * kBQ;
                hp::mbar_wait(&empty[stage], phase ^ 1);
                hp::mbar_expect_tx(&full[stage], P::STAGE_BYTES);
                unsigned char* const sQ = sQD + stage * P::STAGE_BYTES;
                unsigned char* const sdO = sQ + P::TILE_BYTES;
                for (int c = 0; c < P::BLOCKS; ++c) {
                    hp::tma_load_4d(sQ + c * kBQ * SW, &qmap, &full[stage],
                                    c * SW / 2, h, q_start, b);
                    hp::tma_load_4d(sdO + c * kBQ * SW, &domap, &full[stage],
                                    c * SW / 2, h, q_start, b);
                }
                if (++stage == P::STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
        } else if (threadIdx.x / 32 == kNC * 4 + 1) {
            // The stage's lse and D: two queries a lane, read before the
            // stage is free.
            const int lane = threadIdx.x % 32;
            int stage = 0;
            uint32_t phase = 0;
            for (int i = 0; i < stages; ++i) {
                const int h = kvh * group + g_lo + i / n_qt;
                const int col = (qt_begin + i % n_qt) * kBQ + 2 * lane;
                const size_t row0 = ((size_t)b * H + h) * Sq;
                float l2[2], dd[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const bool in = col + e < Sq;
                    l2[e] = in ? lse[row0 + col + e] * kLog2e : 0.0f;
                    dd[e] = in ? dvec[row0 + col + e] : 0.0f;
                }
                hp::mbar_wait(&empty[stage], phase ^ 1);
                float* const r = sLseD + stage * 2 * kBQ;
                *reinterpret_cast<float2*>(r + 2 * lane) =
                    make_float2(l2[0], l2[1]);
                *reinterpret_cast<float2*>(r + kBQ + 2 * lane) =
                    make_float2(dd[0], dd[1]);
                hp::mbar_arrive(&full[stage]);
                if (++stage == P::STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
        }
    } else {
        // ---- consumer wg: in turns, stages wg, wg + kNC, ...; in
        // halves, every stage, into columns [c0, c0 + COLS) ----
        hp::regs_alloc<240>();
        const int warp = (threadIdx.x / 32) % 4;
        const int lane = threadIdx.x % 32;
        const int quad = lane % 4;
        const int kr_lo = k_start + warp * 16 + lane / 4;  // and kr_lo + 8
        const float scale_log2 = scale * kLog2e;
        const int c0 = P::HALVES ? wg * P::COLS : 0;
        // This consumer's column blocks of a tile start c0 * 2 / SW
        // blocks in: at byte `half` of a 64-row tile.
        const int half = c0 * 2 / SW * kBQ * SW;

        float dk[P::COLS / 2], dv[P::COLS / 2];
#pragma unroll
        for (int i = 0; i < P::COLS / 2; ++i) dk[i] = dv[i] = 0.0f;

        hp::mbar_wait(kv_full, 0);
        for (int i = P::HALVES ? 0 : wg; i < stages;
             i += P::HALVES ? 1 : kNC) {
            const int stage = i % P::STAGES;
            const uint32_t phase = (i / P::STAGES) & 1;
            const int q_start = (qt_begin + i % n_qt) * kBQ;
            unsigned char* const sQ = sQD + stage * P::STAGE_BYTES;
            unsigned char* const sdO = sQ + P::TILE_BYTES;
            hp::mbar_wait(&full[stage], phase);
            float st[32], dpt[32];
#pragma unroll
            for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.0f;
            hp::fence_regs(st);
            hp::fence_regs(dpt);
            hp::wgmma_fence();
            issue_abt<HD, SW>(st, sK, kRows * SW, sQ);
            issue_abt<HD, SW>(dpt, sV, kRows * SW, sdO);
            hp::wgmma_commit();
            hp::wgmma_wait<0>();
            hp::fence_regs(st);
            hp::fence_regs(dpt);

            // P^T and dS^T in bf16 A fragments: st[4j + e] is kv row kr_lo
            // + 8 (e / 2), query q_start + 8j + 2 quad + e % 2; query pair
            // (i, i + 1) goes to step i / 8, register (i / 2) % 4. Each
            // query's lse (log2 units) and D from the stage.
            const bool interior = interior_tile<kBQ, kRows>(
                q_start, k_start, Sq, Skv, causal, window);
            const float* const r = sLseD + stage * 2 * kBQ;
            uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int col = q_start + 8 * j + 2 * quad;
                const float2 l2 = *reinterpret_cast<const float2*>(
                    r + 8 * j + 2 * quad);
                const float2 dd = *reinterpret_cast<const float2*>(
                    r + kBQ + 8 * j + 2 * quad);
#pragma unroll
                for (int hi = 0; hi < 2; ++hi) {
                    const int x = 4 * j + 2 * hi;
                    float p0 = exp2f(st[x] * scale_log2 - l2.x);
                    float p1 = exp2f(st[x + 1] * scale_log2 - l2.y);
                    if (!interior) {
                        const int row = kr_lo + 8 * hi;
                        if (!keeps(col, row, Sq, Skv, causal, window)) {
                            p0 = 0.0f;
                        }
                        if (!keeps(col + 1, row, Sq, Skv, causal, window)) {
                            p1 = 0.0f;
                        }
                    }
                    const __nv_bfloat162 pk = __floats2bfloat162_rn(p0, p1);
                    const __nv_bfloat162 dk2 = __floats2bfloat162_rn(
                        p0 * (dpt[x] - dd.x) * scale,
                        p1 * (dpt[x + 1] - dd.y) * scale);
                    pa[x / 8][(x / 2) % 4] =
                        *reinterpret_cast<const uint32_t*>(&pk);
                    da[x / 8][(x / 2) % 4] =
                        *reinterpret_cast<const uint32_t*>(&dk2);
                }
            }

            hp::fence_regs(dv);
            hp::fence_regs(dk);
            hp::wgmma_fence();
            issue_ab<P::COLS, SW>(dv, pa, sdO + half);
            issue_ab<P::COLS, SW>(dk, da, sQ + half);
            hp::wgmma_commit();
            hp::wgmma_wait<0>();
            hp::fence_regs(dv);
            hp::fence_regs(dk);
            if (lane == 0) hp::mbar_arrive(&empty[stage]);
        }

        if constexpr (P::HALVES) {
            if (partial != nullptr) {
                // ---- epilogue of one split: f32 sums to the workspace,
                // [split][dk, dv][B, Skv, KV, D] ----
                const size_t n = (size_t)(gridDim.x / splits) * Skv * D;
                float* const pk = partial + (size_t)split * 2 * n;
                store_partial<P::COLS>(dk, pk, b, kvh, k_start, c0, Skv, KV,
                                       D, warp, lane);
                store_partial<P::COLS>(dv, pk + n, b, kvh, k_start, c0, Skv,
                                       KV, D, warp, lane);
                return;
            }
            // ---- epilogue (each consumer its half): dK and dV through
            // its half of the K and V tiles, once both consumers' wgmma
            // have read all of them ----
            hp::named_barrier(3, 256);
            const int blk0 = c0 * 2 / SW;
            stage_out<P::COLS, SW>(dk, sK + blk0 * kRows * SW, kRows * SW,
                                   warp, lane);
            stage_out<P::COLS, SW>(dv, sV + blk0 * kRows * SW, kRows * SW,
                                   warp, lane);
            hp::fence_async_shared();
            hp::named_barrier(1 + wg, 128);
            if (threadIdx.x % 128 == 0) {
                // Column blocks wholly past D hold zeros: not stored.
                for (int c = blk0;
                     c < blk0 + P::COL_BLOCKS && c * SW / 2 < D; ++c) {
                    hp::tma_store_4d(&dkmap, sK + c * kRows * SW,
                                     c * SW / 2, kvh, k_start, b);
                    hp::tma_store_4d(&dvmap, sV + c * kRows * SW,
                                     c * SW / 2, kvh, k_start, b);
                }
                hp::tma_store_commit();
                hp::tma_store_wait_read();
            }
        } else {
            // The group sum of both consumers, consumer 1's through the
            // ring, idle once both are past their last stage: same order
            // on every run.
            float* const red = reinterpret_cast<float*>(sQD);
            const int t = threadIdx.x % 128;
            hp::named_barrier(3, 256);
            if (wg == 1) {
#pragma unroll
                for (int i = 0; i < HD / 2; ++i) {
                    red[i * 128 + t] = dk[i];
                    red[(HD / 2 + i) * 128 + t] = dv[i];
                }
            }
            hp::named_barrier(3, 256);
            if (wg == 1) return;
#pragma unroll
            for (int i = 0; i < HD / 2; ++i) {
                dk[i] += red[i * 128 + t];
                dv[i] += red[(HD / 2 + i) * 128 + t];
            }

            // ---- epilogue (consumer 0): dK and dV through the K and V
            // tiles
            hp::named_barrier(1, 128);  // every warp's wgmma has read K, V
            stage_out<HD, SW>(dk, sK, kRows * SW, warp, lane);
            stage_out<HD, SW>(dv, sV, kRows * SW, warp, lane);
            hp::fence_async_shared();
            hp::named_barrier(1, 128);
            if (threadIdx.x == 0) {
                for (int c = 0; c < P::BLOCKS; ++c) {
                    hp::tma_store_4d(&dkmap, sK + c * kRows * SW, c * SW / 2,
                                     kvh, k_start, b);
                    hp::tma_store_4d(&dvmap, sV + c * kRows * SW, c * SW / 2,
                                     kvh, k_start, b);
                }
                hp::tma_store_commit();
                hp::tma_store_wait_read();
            }
        }
    }
}

// dk and dv [n elements each, bf16] = the workspace's splits [split][dk,
// dv][n] (f32) added in split order: four elements a thread a step.
__global__ void flash_bwd_dkv_sum_kernel(const float* __restrict__ partial,
                                         int splits, size_t n,
                                         __nv_bfloat16* __restrict__ dk,
                                         __nv_bfloat16* __restrict__ dv) {
    const size_t step = (size_t)gridDim.x * blockDim.x * 4;
    for (size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
         i < 2 * n; i += step) {
        float4 acc = *reinterpret_cast<const float4*>(partial + i);
        for (int p = 1; p < splits; ++p) {
            const float4 x = *reinterpret_cast<const float4*>(
                partial + (size_t)p * 2 * n + i);
            acc.x += x.x;
            acc.y += x.y;
            acc.z += x.z;
            acc.w += x.w;
        }
        __nv_bfloat16* const out = i < n ? dk + i : dv + (i - n);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x, acc.y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z, acc.w);
        *reinterpret_cast<uint2*>(out) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                       *reinterpret_cast<const uint32_t*>(&hi));
    }
}

// The tensor maps take the tensors' own D as their innermost dim (zero
// fill past it on load, clipped on store), as K1's do. `splits` > 1
// (hd 256 only) needs `partial`, f32 [splits, 2, B, Skv, KV, D].
template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* dvec,
                 void* dk, void* dv, float* partial, int splits, int B,
                 int Sq, int Skv, int H, int KV, int D, float scale,
                 int causal, int window, cudaStream_t stream) {
    using P = Plan<HD>;
    if (splits < 1 || (H / KV) % splits != 0 ||
        (splits > 1 && (!P::HALVES || partial == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    CUtensorMap qm, km, vm, dom, dkm, dvm;
    if (!hp::tensor_map(&qm, q, B, Sq, H, D, kBQ, P::SW) ||
        !hp::tensor_map(&km, k, B, Skv, KV, D, kRows, P::SW) ||
        !hp::tensor_map(&vm, v, B, Skv, KV, D, kRows, P::SW) ||
        !hp::tensor_map(&dom, dout, B, Sq, H, D, kBQ, P::SW) ||
        !hp::tensor_map(&dkm, dk, B, Skv, KV, D, kRows, P::SW) ||
        !hp::tensor_map(&dvm, dv, B, Skv, KV, D, kRows, P::SW)) {
        return (int)cudaErrorInvalidValue;
    }
    auto kern = flash_bwd_dkv_wgmma_kernel<HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::bytes());
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(B * KV * splits, (Skv + kRows - 1) / kRows);
    kern<<<grid, P::THREADS, P::bytes(), stream>>>(
        qm, km, vm, dom, dkm, dvm, lse, dvec,
        splits > 1 ? partial : nullptr, splits, Sq, Skv, H, KV, D, causal,
        window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    const size_t n = (size_t)B * Skv * KV * D;
    const size_t quads = 2 * n / 4;
    const int blocks = (int)(quads < 1024 * 256 ? (quads + 255) / 256
                                                : 1024);
    flash_bwd_dkv_sum_kernel<<<blocks, 256, 0, stream>>>(
        partial, splits, n, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv));
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: flash_tile.cuh's tile loop
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dvec, T* __restrict__ dk,
                          T* __restrict__ dv, int Sq, int Skv, int H, int KV,
                          int D, int causal, int window, float scale) {
    using L = Layout<T, HD>;
    constexpr int TQ = L::TK, LD = L::LD, SLD = L::SLD, PLD = L::PLD;
    constexpr int SC = TQ / 2;  // S^T columns held by one lane
    // dK / dV columns this CTA accumulates: all, or one half at hd 256.
    constexpr int COLS = HD > 128 ? HD / 2 : HD;

    extern __shared__ __align__(128) unsigned char smem[];
    const BwdSmem<T, HD> sm(smem);
    T* const sK = sm.own[0];
    T* const sV = sm.own[1];
    T* const sQ = sm.walk[0];
    T* const sdO = sm.walk[1];

    const int bkv = blockIdx.y;
    const int b = bkv / KV;
    const int kvh = bkv % KV;
    const int G = H / KV;
    const int k_start = blockIdx.x * BK;
    const int c0 = blockIdx.z * COLS;  // first dK / dV column
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int r = lane >> 1;
    const int half = lane & 1;

    const size_t q_stride = (size_t)H * D;
    const size_t kv_stride = (size_t)KV * D;
    const T* kbase = k + ((size_t)b * Skv * KV + kvh) * D;
    const T* vbase = v + ((size_t)b * Skv * KV + kvh) * D;
    load_tile<T, HD, LD>(sK, kbase, kv_stride, k_start, Skv, D);
    load_tile<T, HD, LD>(sV, vbase, kv_stride, k_start, Skv, D);

    int qt_begin, qt_end;
    q_tiles<TQ, BK>(k_start, Sq, Skv, causal, window, qt_begin, qt_end);

    const int pos_k = k_start + warp * 16 + r;
    float* Sw = sm.S + warp * 16 * SLD;
    T* Pw = sm.P + warp * 16 * PLD;
    const T* Kw = sK + warp * 16 * LD;
    const T* Vw = sV + warp * 16 * LD;
    RowAcc<T, HD, COLS> dk_acc;
    RowAcc<T, HD, COLS> dv_acc;

    for (int g = 0; g < G; ++g) {
        const int h = kvh * G + g;
        const T* qbase = q + ((size_t)b * Sq * H + h) * D;
        const T* dobase = dout + ((size_t)b * Sq * H + h) * D;
        const float* lse_h = lse + ((size_t)b * H + h) * Sq;
        const float* d_h = dvec + ((size_t)b * H + h) * Sq;
        for (int qt = qt_begin; qt < qt_end; ++qt) {
            const int q_start = qt * TQ;
            __syncthreads();  // every warp is done with the previous tile
            load_tile<T, HD, LD, TQ>(sQ, qbase, q_stride, q_start, Sq, D);
            load_tile<T, HD, LD, TQ>(sdO, dobase, q_stride, q_start, Sq, D);
            if (threadIdx.x < TQ) {
                const int pq = q_start + threadIdx.x;
                sm.lse[threadIdx.x] = pq < Sq ? lse_h[pq] : 0.0f;
                sm.D[threadIdx.x] = pq < Sq ? d_h[pq] : 0.0f;
            }
            __syncthreads();
            const bool interior = interior_tile<TQ, BK>(
                q_start, k_start, Sq, Skv, causal, window);

            // P^T = exp(K Q^T * scale - lse), masked pairs exactly 0.
            abt<T, HD>(Kw, sQ, Sw, lane);
            __syncwarp();
            float p[SC];
#pragma unroll
            for (int j = 0; j < SC; ++j) {
                const int col = half * SC + j;
                const bool ok = interior || keeps(q_start + col, pos_k, Sq,
                                                  Skv, causal, window);
                p[j] = ok ? expf(Sw[r * SLD + col] * scale - sm.lse[col])
                          : 0.0f;
                Pw[r * PLD + col] = from_float<T>(p[j]);
            }
            __syncwarp();

            // dV += P^T dO
            dv_acc.add_ab(Pw, sdO + c0, lane);
            __syncwarp();

            // dS^T = P^T (V dO^T - D) scale, rounded to T for the product.
            abt<T, HD>(Vw, sdO, Sw, lane);
            __syncwarp();
#pragma unroll
            for (int j = 0; j < SC; ++j) {
                const int col = half * SC + j;
                Pw[r * PLD + col] = from_float<T>(
                    p[j] * (Sw[r * SLD + col] - sm.D[col]) * scale);
            }
            __syncwarp();

            // dK += dS^T Q
            dk_acc.add_ab(Pw, sQ + c0, lane);
            __syncwarp();
        }
    }

    const size_t row = (((size_t)b * Skv + pos_k) * KV + kvh) * D + c0 +
                       half * (COLS / 2);
    const int cols = D - c0 - half * (COLS / 2);  // of this lane's columns
    dk_acc.store(dk + row, pos_k < Skv, cols);
    dv_acc.store(dv + row, pos_k < Skv, cols);
}

template <typename T, int HD>
int launch_tile(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* dvec,
                void* dk, void* dv, int B, int Sq, int Skv, int H, int KV,
                int D, float scale, int causal, int window,
                cudaStream_t stream) {
    const size_t smem = BwdLayout<T, HD>::bytes();
    auto kern = flash_bwd_dkv_tile_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Skv + BK - 1) / BK, B * KV, HD > 128 ? 2 : 1);
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, dvec,
        static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, KV, D, causal,
        window, scale);
    return (int)cudaGetLastError();
}

// bf16: the wgmma kernel at every capacity.
template <int HD>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* dvec,
                void* dk, void* dv, float* partial, int splits, int B,
                int Sq, int Skv, int H, int KV, int D, float scale,
                int causal, int window, cudaStream_t s) {
    return launch_wgmma<HD>(q, k, v, dout, lse, dvec, dk, dv, partial,
                            splits, B, Sq, Skv, H, KV, D, scale, causal,
                            window, s);
}

// f32: the tile loop, whose grid has no split of the group.
template <int HD>
int launch_f32(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* dvec,
               void* dk, void* dv, float* partial, int splits, int B,
               int Sq, int Skv, int H, int KV, int D, float scale,
               int causal, int window, cudaStream_t s) {
    (void)partial;
    if (splits != 1) return (int)cudaErrorInvalidValue;
    return launch_tile<float, HD>(q, k, v, dout, lse, dvec, dk, dv, B, Sq,
                                  Skv, H, KV, D, scale, causal, window, s);
}

}  // namespace

// q/dout [B, Sq, H, D], k/v/dk/dv [B, Skv, KV, D], bf16 (is_bf16 = 1) or
// f32, D a multiple of 8 up to 256; scale, lse and dvec as in
// istpu_flash_bwd_dq; all contiguous. dk and dv are summed over each kv
// head's group of q heads. splits: runs the group's q heads are cut into
// (a divisor of H / KV; more than 1 only for bf16 at D > 128), whose
// f32 sums go to `partial`, f32 [splits, 2, B, Skv, KV, D] (null for
// one split), and are added in split order. Returns cudaGetLastError().
extern "C" int istpu_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* dvec,
                                   void* dk, void* dv, float* partial,
                                   int splits, int is_bf16, int B, int Sq,
                                   int Skv, int H, int KV, int D,
                                   float scale, int causal, int window,
                                   void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ISTPU_HD(fn)                                                        \
    switch (istpu::head_dim_capacity(D)) {                                  \
        case 32: return fn<32>(q, k, v, dout, lse, dvec, dk, dv, partial,   \
                               splits, B, Sq, Skv, H, KV, D, scale, causal, \
                               window, s);                                  \
        case 64: return fn<64>(q, k, v, dout, lse, dvec, dk, dv, partial,   \
                               splits, B, Sq, Skv, H, KV, D, scale, causal, \
                               window, s);                                  \
        case 128: return fn<128>(q, k, v, dout, lse, dvec, dk, dv, partial, \
                                 splits, B, Sq, Skv, H, KV, D, scale,       \
                                 causal, window, s);                        \
        case 256: return fn<256>(q, k, v, dout, lse, dvec, dk, dv, partial, \
                                 splits, B, Sq, Skv, H, KV, D, scale,       \
                                 causal, window, s);                        \
        default: return (int)cudaErrorInvalidValue;                         \
    }
    if (is_bf16) {
        ISTPU_HD(launch_bf16)
    }
    ISTPU_HD(launch_f32)
#undef ISTPU_HD
}
