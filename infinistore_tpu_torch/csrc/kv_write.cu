// The decode step's KV write: each batch row's new k and v row into its
// (page, slot) of one layer's pools, with JAX's scatter mode="drop" decided
// on the device.
//
// It replaces no TPU kernel: the JAX package writes with
// `.at[page, slot].set(..., mode="drop")` and XLA's scatter. The port's eager
// path finds the rows that land with torch.nonzero (a host sync, and a shape
// that depends on the data), which a CUDA graph cannot hold; this kernel has
// a fixed shape, so the whole decode step can be captured. Its plain version
// and oracle is ops/paged_kv_write.py's kv_write_plain, itself held to
// drop_mode_rows + scatter_rows (ops/paged_attention.py).
//
// Bound: bytes, 2 x B rows read and written (2 KB a row at Mistral-7B's
// 8 kv heads x 128 in bf16). One block per batch row, 16-byte vectors.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// mode="drop" on one index: [-size, -1] wraps, anything else outside
// [0, size) is dropped (ops/paged_attention.py _drop_mode_index).
__device__ __forceinline__ bool drop_index(long long& i, long long size) {
    if (i < 0) i += size;
    return i >= 0 && i < size;
}

__global__ void kv_write_kernel(const uint4* __restrict__ k,
                                const uint4* __restrict__ v,
                                uint4* __restrict__ k_pages,
                                uint4* __restrict__ v_pages,
                                const long long* __restrict__ page,
                                const long long* __restrict__ slot, int B,
                                long long N, long long P, long long vecs) {
    const int b = blockIdx.x;
    long long pg = page[b], sl = slot[b];
    if (!drop_index(pg, N) || !drop_index(sl, P)) return;
    const long long row = pg * P + sl;
    // Rows that land on one target: the last of them writes, as a serial
    // scatter (index_copy_ on the CPU) leaves it, so two runs agree.
    for (int o = b + 1; o < B; ++o) {
        long long po = page[o], so = slot[o];
        if (drop_index(po, N) && drop_index(so, P) && po * P + so == row) {
            return;
        }
    }
    const uint4* ks = k + b * vecs;
    const uint4* vs = v + b * vecs;
    uint4* kd = k_pages + row * vecs;
    uint4* vd = v_pages + row * vecs;
    for (long long i = threadIdx.x; i < vecs; i += blockDim.x) {
        kd[i] = ks[i];
        vd[i] = vs[i];
    }
}

}  // namespace

// k, v: [B, row_bytes] (each row one token's n_kv x hd values); k_pages,
// v_pages: [N, P, row_bytes], the same type; page, slot: int64 [B]. All
// contiguous and 16-byte aligned, row_bytes a multiple of 16. Return
// cudaGetLastError().
extern "C" int istpu_kv_write(const void* k, const void* v, void* k_pages,
                              void* v_pages, const void* page,
                              const void* slot, int B, int N, int P,
                              int row_bytes, void* stream) {
    if (B > 0) {
        kv_write_kernel<<<B, 128, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint4*>(k), static_cast<const uint4*>(v),
            static_cast<uint4*>(k_pages), static_cast<uint4*>(v_pages),
            static_cast<const long long*>(page),
            static_cast<const long long*>(slot), B, N, P, row_bytes / 16);
    }
    return static_cast<int>(cudaGetLastError());
}
