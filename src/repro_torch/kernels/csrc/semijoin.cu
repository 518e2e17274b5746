// Batched sorted semi-join membership for Hopper (sm_90a).
//
// For a batch of P (probe, build) pairs over two ragged int32 key arrays,
// pair j = (probe_off, probe_len, build_off, build_len, out_off):
//     mask[out_off + i] = probe[probe_off + i] ∈ build[build_off : +build_len]
//     counts[j]         = #{i : mask[out_off + i] == 1}
// with every build segment ascending.  One launch evaluates the whole
// batch: this is the ExtVP load's semi-join grid (repro_torch.core
// .extvp_build), where a probe segment is one predicate's s or o column
// in row order and a build segment another predicate's sorted unique s
// or o column.
//
// Replaces the TPU kernel src/repro/kernels/semijoin.py::
// semijoin_membership_kernel, vmapped over a padded (2, P, cap) block by
// the reference's extvp_build.batch_pair_masks.  Neither the padded
// block nor the TPU's tiled broadcast-compare with pl.when tile skips is
// carried over.  The grid is (pair, probe block) flattened to one
// dimension: pair j owns ceil(probe_len / blockDim) consecutive blocks,
// block_start[j] is the first of them, and each block finds its pair by
// a binary search over block_start (one thread, broadcast through shared
// memory).  One thread takes one probe key and binary-searches it in its
// pair's build segment.  The block's matches are summed with
// __syncthreads_count and added to the pair's count with one atomic.
//
// What bounds it on the card: bytes.  The function must read 4 bytes
// and write 1 byte per probe key (plus the build segments once), but
// each search reads log2(build_len) scattered 4-byte words, a chain of
// dependent loads, each costing a 32-byte sector.  The build segments
// (at most a few MB each) mostly stay in L2, and the top levels of each
// search tree in L1.  The design does nothing more about it yet: a
// merge over a sorted probe, or the top of the tree in shared memory,
// is later work.
//
// Sentinels need no special case: membership is equality, and the probe
// pad (2^31-1) and build pad (2^31-2) differ, so pads never match.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void semijoin_kernel(const int32_t* __restrict__ probe,
                                const int32_t* __restrict__ build,
                                const int64_t* __restrict__ pairs,
                                const int64_t* __restrict__ block_start,
                                int64_t n_pairs,
                                uint8_t* __restrict__ mask,
                                unsigned long long* __restrict__ counts) {
    __shared__ int64_t s_pair;
    const int64_t b = (int64_t)blockIdx.x;
    if (threadIdx.x == 0) {
        // the last pair whose first block is <= b (block_start[0] == 0);
        // pairs of no block share their successor's start and are skipped
        int64_t lo = 0, hi = n_pairs;
        while (hi - lo > 1) {
            const int64_t m = lo + ((hi - lo) >> 1);
            if (block_start[m] <= b) lo = m; else hi = m;
        }
        s_pair = lo;
    }
    __syncthreads();
    const int64_t j = s_pair;
    const int64_t* d = pairs + 5 * j;
    const int64_t probe_off = d[0], n_a = d[1];
    const int64_t build_off = d[2], n_b = d[3], out_off = d[4];
    const int64_t i = (b - block_start[j]) * blockDim.x + threadIdx.x;
    int hit = 0;
    if (i < n_a) {
        const int32_t key = __ldg(probe + probe_off + i);
        const int32_t* bs = build + build_off;
        int64_t l = 0, h = n_b;
        while (l < h) {                        // first b >= key
            const int64_t m = l + ((h - l) >> 1);
            if (__ldg(bs + m) < key) l = m + 1; else h = m;
        }
        hit = (l < n_b && __ldg(bs + l) == key) ? 1 : 0;
        mask[out_off + i] = (uint8_t)hit;
    }
    const int n = __syncthreads_count(hit);
    if (threadIdx.x == 0 && n > 0)
        atomicAdd(counts + j, (unsigned long long)n);
}

// Plain C entry point, loaded with ctypes.  ``pairs`` is int64 (P, 5),
// ``block_start`` int64 (P,), both on the device; ``counts`` must be
// zeroed by the caller.  Launches ``n_blocks`` blocks of ``threads``
// threads (the same block size block_start was computed with) on the
// caller's stream, allocates nothing, does not synchronise, and returns
// the launch status (cudaGetLastError) so the caller can raise.
extern "C" int semijoin_launch(const int32_t* probe, const int32_t* build,
                               const int64_t* pairs,
                               const int64_t* block_start, int64_t n_pairs,
                               int64_t n_blocks, int threads, uint8_t* mask,
                               unsigned long long* counts, void* stream) {
    if (n_pairs <= 0 || n_blocks <= 0) return (int)cudaSuccess;
    if (n_blocks > 0x7fffffffLL || threads <= 0 || threads > 1024)
        return (int)cudaErrorInvalidConfiguration;
    semijoin_kernel<<<(unsigned)n_blocks, threads, 0,
                      (cudaStream_t)stream>>>(probe, build, pairs,
                                              block_start, n_pairs, mask,
                                              counts);
    return (int)cudaGetLastError();
}
