// The int8 paged decode kernel's (paged_decode_q.cu, K4) query rows a
// CTA takes, and the merge of the warps' partial online-softmax states at
// the end of its page walk.
#pragma once

#include "common.cuh"

namespace istpu {

// A kv head's GQA group is taken in blocks of G query rows, one CTA each
// (grid.z): G is the group itself when it is 1, 2, 4 or 8, else the
// least of those at or above it, capped at 8 (4 at hd 256, where a row's
// query and sum take 16 registers a lane). Rows past the group pad the
// last block: they are neither loaded nor stored, and each block reads
// its kv head's pages again.
inline int decode_block_rows(int group, int hd) {
    const int cap = hd > 128 ? 4 : 8;
    int g = 1;
    while (g < group && g < cap) g *= 2;
    return g;
}

// Merge the partial states of a CTA's WARPS warps and write the first
// `rows` of its G query rows (the others pad the block: never stored).
// Each lane holds, for row g, the warp's running max m[g], sum l[g] and
// acc[g][e] for dims lane * (HD / 32) + e. Row g goes to out + g * D (its
// first D of HD columns), normalised by the merged sum (0 for a row that
// saw no token).
template <typename T, int WARPS, int G, int HD>
__device__ __forceinline__ void merge_warps_store(const float (&m)[G],
                                                  const float (&l)[G],
                                                  const float (&acc)[G][HD / 32],
                                                  int rows, int D,
                                                  T* __restrict__ out) {
    constexpr int EPL = HD / 32;
    __shared__ float sm_m[WARPS][G];
    __shared__ float sm_l[WARPS][G];
    __shared__ float sm_acc[WARPS][G][HD];
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
        if (lane == 0) {
            sm_m[warp][g] = m[g];
            sm_l[warp][g] = l[g];
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * HD; i += WARPS * 32) {
        const int g = i / HD;
        const int d = i % HD;
        if (d >= D) continue;
        float mx = kNegInf;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
        float lsum = 0.0f, a = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const float f = expf(sm_m[w][g] - mx);
            lsum = fmaf(sm_l[w][g], f, lsum);
            a = fmaf(sm_acc[w][g][d], f, a);
        }
        out[(size_t)g * D + d] = from_float<T>(lsum > 0.0f ? a / lsum : 0.0f);
    }
}

}  // namespace istpu
