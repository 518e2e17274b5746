// Shuffle histogram for Hopper (sm_90a).
//
// For n int32 keys and a validity byte per key:
//     hist[b] = #{i : valid[i] && keys[i] != 2^31-1
//                    && (uint32_t)keys[i] % n_buckets == b}
// an int32 histogram of n_buckets entries.  The distributed executor's
// repartition (repro_torch.core.distributed) counts the rows it sends to
// each rank with it: n_buckets is the number of ranks there.  The modulo
// reads the key's 32 bits as unsigned, as the shuffle routes rows, so a
// negative key (UNBOUND -1, A_NULL -3) counts where repartition sends it;
// C's signed % on the int32 key would give another answer.
//
// Replaces the TPU kernel src/repro/kernels/bucketcount.py::
// bucket_count_kernel.  That kernel walks its grid in order and carries
// the histogram in its output block from one step to the next (zeroed
// under pl.when(i == 0)).  Blocks on the GPU run in no order, so nothing
// carries over: each block keeps its own histogram in shared memory,
// counts a grid-strided share of the keys into it, and adds each
// non-zero bucket to the global histogram with one atomic.  Integer
// atomics are exact in any order, so the result equals the plain version
// (kernels/ref.py::bucket_count_ref) bit for bit.  (The TPU kernel also
// uses a signed floor-mod, which disagrees with its own reference on
// negative keys; this one follows the reference.)
//
// Contention: with few buckets (one or two ranks) every lane of a warp
// hits the same shared-memory word.  Each warp therefore groups its
// lanes by bucket (__match_any_sync) and one lane per group adds the
// group's size, so a warp makes one atomic per distinct bucket.
//
// What bounds it on the card: bytes.  The function reads 5 bytes per
// row (the key and its validity byte) and writes 4 bytes per bucket; a
// warp reads 128 contiguous key bytes and 32 validity bytes per step.
//
// Large bucket counts: the shared histogram takes 4 bytes per bucket and
// uses at most SMEM_BUCKETS of them (48 KB, the most a block gets
// without opting in to more).  Above that cut the kernel counts with
// global atomics straight into the output.

#include <cuda_runtime.h>
#include <stdint.h>

#define PROBE_PAD 0x7fffffff
#define SMEM_BUCKETS 12288

__device__ __forceinline__ uint32_t bucket_of(const int32_t* __restrict__ keys,
                                              const uint8_t* __restrict__ valid,
                                              int64_t i, int64_t n,
                                              uint32_t n_buckets) {
    // n_buckets (out of range) marks a row that counts nowhere
    if (i >= n) return n_buckets;
    const int32_t key = __ldg(keys + i);
    if (!__ldg(valid + i) || key == PROBE_PAD) return n_buckets;
    return (uint32_t)key % n_buckets;
}

__global__ void bucket_count_shared(const int32_t* __restrict__ keys,
                                    const uint8_t* __restrict__ valid,
                                    int64_t n, uint32_t n_buckets,
                                    unsigned int* __restrict__ out) {
    extern __shared__ unsigned int hist[];
    for (uint32_t b = threadIdx.x; b < n_buckets; b += blockDim.x) hist[b] = 0;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    // the loop bound is the warp's first index, so all 32 lanes run the
    // same iterations and take part in every __match_any_sync
    for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
         base < n; base += stride) {
        const uint32_t b = bucket_of(keys, valid, base + lane, n, n_buckets);
        const unsigned peers = __match_any_sync(0xffffffffu, b);
        if (b < n_buckets && lane == __ffs(peers) - 1)
            atomicAdd(&hist[b], (unsigned)__popc(peers));
    }
    __syncthreads();
    for (uint32_t b = threadIdx.x; b < n_buckets; b += blockDim.x) {
        const unsigned c = hist[b];
        if (c) atomicAdd(out + b, c);
    }
}

__global__ void bucket_count_global(const int32_t* __restrict__ keys,
                                    const uint8_t* __restrict__ valid,
                                    int64_t n, uint32_t n_buckets,
                                    unsigned int* __restrict__ out) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
        const uint32_t b = bucket_of(keys, valid, i, n, n_buckets);
        if (b < n_buckets) atomicAdd(out + b, 1u);
    }
}

// Plain C entry point, loaded with ctypes.  ``keys`` int32 (n,), ``valid``
// one byte per key (a torch.bool tensor), ``out`` int32 (n_buckets,) on
// the device and zeroed by the caller.  Launches ``n_blocks`` blocks of
// ``threads`` threads (a multiple of 32) on the caller's stream,
// allocates nothing, does not synchronise, and returns the launch status
// (cudaGetLastError) so the caller can raise.
extern "C" int bucket_count_launch(const int32_t* keys, const uint8_t* valid,
                                   int64_t n, int64_t n_buckets,
                                   int64_t n_blocks, int threads,
                                   int32_t* out, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    if (n_buckets <= 0 || n_buckets > 0xffffffffLL || n_blocks <= 0 ||
        n_blocks > 0x7fffffffLL || threads <= 0 || threads > 1024 ||
        threads % 32)
        return (int)cudaErrorInvalidConfiguration;
    cudaStream_t s = (cudaStream_t)stream;
    unsigned int* hist = (unsigned int*)out;
    if (n_buckets <= SMEM_BUCKETS) {
        const size_t smem = (size_t)n_buckets * sizeof(unsigned int);
        bucket_count_shared<<<(unsigned)n_blocks, threads, smem, s>>>(
            keys, valid, n, (uint32_t)n_buckets, hist);
    } else {
        bucket_count_global<<<(unsigned)n_blocks, threads, 0, s>>>(
            keys, valid, n, (uint32_t)n_buckets, hist);
    }
    return (int)cudaGetLastError();
}
