// Batched semi-join membership for Hopper (sm_90a), through presence
// bitmaps.
//
// For a batch of P (probe, build) pairs over two ragged int32 key arrays,
// pair j = (probe_off, probe_len, build_off, build_len, out_off, ...):
//     mask[out_off + i] = probe[probe_off + i] ∈ build[build_off : +build_len]
//     counts[j]         = #{i : mask[out_off + i] == 1}
// with every build segment ascending.  One call evaluates the whole
// batch: this is the ExtVP load's semi-join grid (repro_torch.core
// .extvp_build), where a probe segment is one predicate's s or o column
// in row order and a build segment another predicate's sorted unique s
// or o column.
//
// Replaces the TPU kernel src/repro/kernels/semijoin.py::
// semijoin_membership_kernel (line 40), vmapped over a padded (2, P, cap)
// block by the reference's extvp_build.batch_pair_masks.  Neither the
// padded block nor the TPU's tiled broadcast-compare is carried over.
//
// What bounds it on the card: bytes.  The function must read 4 bytes and
// write 1 byte per probe key, and read each distinct build segment once.
// A binary search per key (this kernel's first design) read a chain of
// up to log2(build_len) = 20 dependent, scattered 4-byte words per key
// instead, and ran at 7 % of that bound on an H100 (ExtVP build of
// WatDiv at 10M triples).
//
// Why a bitmap.  Dictionary ids are dense, so a build segment (the
// sorted unique subjects or objects of one predicate) covers its id
// range [lo, hi] densely: in the WatDiv data nearly every column spans at
// most 32 ids per key, so a presence bitmap of ceil((hi - lo + 1) / 32)
// 32-bit words is no larger than the keys it replaces, and all the
// batch's bitmaps together (about 1 MB for 10M triples) stay in L2, each
// one (at most about 100 KB there) mostly in L1.  Membership is then one
// 4-byte load per key in place of a search.  The host plan
// (ops._semijoin_plan) gives a segment a bitmap when its words are at
// most max(SEMIJOIN_BITMAP_DENSITY * build_len, SEMIJOIN_BITMAP_MIN_WORDS);
// every other segment (a sparse one, such as a build holding -1 and
// 2^31-2) keeps the binary search.  The choice is made from the data
// before any launch; a failed launch raises.
//
// Two kernels, one call:
//  1. semijoin_bitmap_kernel: one thread per key of each bitmap segment
//     sets bit (key - lo) of its segment's words (zeroed by the caller).
//     Keys are sorted, so a warp's lanes mostly share a word: lanes are
//     grouped by word (__match_any_sync), each group's bits are OR-ed
//     (__reduce_or_sync), and one lane per group makes one atomicOr.
//  2. semijoin_kernel: the grid is (pair, probe tile) flattened to one
//     dimension; every thread finds its block's pair by a binary search
//     over block_start (uniform, so one broadcast load a step).  A block
//     takes THREADS * VECS 16-byte vectors of its pair's probe keys (16
//     keys a thread): all its vector loads are issued first, then all
//     its membership loads.  Probe segments start anywhere, so the
//     first few keys up to a 16-byte boundary (the head) and the last
//     few (the tail) are read one by one by block 0 of the pair.  The
//     mask goes out as one 4-byte word per vector where the output
//     offset is 4-byte aligned with it, else byte by byte.  On the
//     bitmap path a key is a member when (int64)key - lo lies in
//     [0, 32 * words) and its bit is set (a key below lo never wraps into
//     range); on the search path the 16 keys walk one branch-free binary
//     search in lock step, so their loads overlap.  A block's matches are
//     summed with __reduce_add_sync per warp and added to the pair's
//     count with one atomic.
//
// Sentinels need no special case: membership is equality, and the probe
// pad (2^31-1) and build pad (2^31-2) differ, so pads never match.  A
// bitmap's bits past its range are zero.

#include <cuda_runtime.h>
#include <stdint.h>

// 16-byte probe vectors per thread: 4 * VECS keys, which must equal
// ops.SEMIJOIN_KEYS_PER_THREAD (the wrapper's blocks per pair)
#define VECS 4
#define PAIR_FIELDS 8   // int64 fields of one pair descriptor
#define SEG_FIELDS 4    // int64 fields of one bitmap-segment descriptor

// the last index m with start[m] <= b (start[0] == 0); items of no block
// share their successor's start and are skipped
__device__ __forceinline__ int64_t owner_of(const int64_t* __restrict__ start,
                                            int64_t n, int64_t b) {
    int64_t lo = 0, hi = n;
    while (hi - lo > 1) {
        const int64_t m = lo + ((hi - lo) >> 1);
        if (__ldg(start + m) <= b) lo = m; else hi = m;
    }
    return lo;
}

// segs: int64 (S, 4) = (build_off, build_len, word_off, lo) of each
// bitmap segment; seg_start: its first block
__global__ void semijoin_bitmap_kernel(const int32_t* __restrict__ build,
                                       const int64_t* __restrict__ segs,
                                       const int64_t* __restrict__ seg_start,
                                       int64_t n_segs,
                                       unsigned int* __restrict__ words) {
    const int64_t b = (int64_t)blockIdx.x;
    const int64_t s = owner_of(seg_start, n_segs, b);
    const int64_t* d = segs + SEG_FIELDS * s;
    const int64_t off = __ldg(d), len = __ldg(d + 1);
    const int64_t word_off = __ldg(d + 2), lo = __ldg(d + 3);
    const int64_t i = (b - __ldg(seg_start + s)) * blockDim.x + threadIdx.x;
    const bool active = i < len;
    const unsigned act = __ballot_sync(0xffffffffu, active);
    if (!active) return;
    const int64_t x = (int64_t)__ldg(build + off + i) - lo;   // in range
    const unsigned w = (unsigned)(x >> 5);
    const unsigned bit = 1u << (unsigned)(x & 31);
    const unsigned peers = __match_any_sync(act, w);
    const unsigned bits = __reduce_or_sync(peers, bit);
    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
        atomicOr(words + word_off + w, bits);
}

__device__ __forceinline__ int bit_member(const unsigned int* __restrict__ bm,
                                          int64_t lo, uint64_t n_bits,
                                          int32_t key) {
    const int64_t x = (int64_t)key - lo;
    if ((uint64_t)x >= n_bits) return 0;   // below lo or past the range
    return (int)((__ldg(bm + (x >> 5)) >> (unsigned)(x & 31)) & 1u);
}

// membership of K keys in bs[0:n] (ascending, n >= 1): one branch-free
// search for the last index whose key is <= the probe key, all K keys a
// level at a time
template <int K>
__device__ __forceinline__ void search_members(const int32_t* __restrict__ bs,
                                               int64_t n, const int32_t* key,
                                               int* hit) {
    int64_t base[K];
#pragma unroll
    for (int e = 0; e < K; ++e) base[e] = 0;
    for (int64_t len = n; len > 1;) {
        const int64_t half = len >> 1;
#pragma unroll
        for (int e = 0; e < K; ++e)
            if (__ldg(bs + base[e] + half) <= key[e]) base[e] += half;
        len -= half;
    }
#pragma unroll
    for (int e = 0; e < K; ++e) hit[e] = __ldg(bs + base[e]) == key[e];
}

// pairs: int64 (P, 8) = (probe_off, probe_len, build_off, build_len,
// out_off, word_off or -1 on the search path, lo, words); block_start:
// each pair's first block
__global__ void semijoin_kernel(const int32_t* __restrict__ probe,
                                const int32_t* __restrict__ build,
                                const unsigned int* __restrict__ words,
                                const int64_t* __restrict__ pairs,
                                const int64_t* __restrict__ block_start,
                                int64_t n_pairs,
                                uint8_t* __restrict__ mask,
                                unsigned long long* __restrict__ counts) {
    __shared__ int s_hits[32];
    const int64_t b = (int64_t)blockIdx.x;
    const int64_t j = owner_of(block_start, n_pairs, b);
    const int64_t* d = pairs + PAIR_FIELDS * j;
    const int64_t probe_off = __ldg(d), n_a = __ldg(d + 1);
    const int64_t build_off = __ldg(d + 2), n_b = __ldg(d + 3);
    const int64_t out_off = __ldg(d + 4), word_off = __ldg(d + 5);
    const int64_t lo = __ldg(d + 6);
    const uint64_t n_bits = 32ull * (uint64_t)__ldg(d + 7);
    const bool bitmap = word_off >= 0;
    const unsigned int* bm = words + (bitmap ? word_off : 0);
    const int32_t* bs = build + build_off;

    const int32_t* pa = probe + probe_off;
    uint8_t* ma = mask + out_off;
    // keys before the first 16-byte boundary, whole vectors, the rest
    int64_t head = (int64_t)(((16u - ((uintptr_t)pa & 15u)) & 15u) >> 2);
    if (head > n_a) head = n_a;
    const int64_t n_vec = (n_a - head) >> 2;
    const int64_t tail_at = head + 4 * n_vec;
    const int4* pv = reinterpret_cast<const int4*>(pa + head);
    uint8_t* mv = ma + head;
    const bool store_words = ((uintptr_t)mv & 3u) == 0;
    const int64_t blk = b - __ldg(block_start + j);
    const int64_t v0 = blk * (int64_t)VECS * blockDim.x + threadIdx.x;

    int32_t key[4 * VECS];
    bool live[VECS];
#pragma unroll
    for (int q = 0; q < VECS; ++q) {
        const int64_t v = v0 + (int64_t)q * blockDim.x;
        live[q] = v < n_vec;
        int4 k = make_int4(0, 0, 0, 0);
        if (live[q]) k = __ldg(pv + v);
        key[4 * q] = k.x; key[4 * q + 1] = k.y;
        key[4 * q + 2] = k.z; key[4 * q + 3] = k.w;
    }
    int hit[4 * VECS];
    if (bitmap) {
#pragma unroll
        for (int e = 0; e < 4 * VECS; ++e)
            hit[e] = live[e >> 2] ? bit_member(bm, lo, n_bits, key[e]) : 0;
    } else if (n_b > 0) {
        search_members<4 * VECS>(bs, n_b, key, hit);
    } else {
#pragma unroll
        for (int e = 0; e < 4 * VECS; ++e) hit[e] = 0;
    }
    int n_hit = 0;
#pragma unroll
    for (int q = 0; q < VECS; ++q) {
        if (!live[q]) continue;
        const int64_t v = v0 + (int64_t)q * blockDim.x;
        const int h0 = hit[4 * q], h1 = hit[4 * q + 1];
        const int h2 = hit[4 * q + 2], h3 = hit[4 * q + 3];
        n_hit += h0 + h1 + h2 + h3;
        if (store_words) {
            reinterpret_cast<unsigned int*>(mv)[v] =
                (unsigned)h0 | ((unsigned)h1 << 8) | ((unsigned)h2 << 16) |
                ((unsigned)h3 << 24);
        } else {
            mv[4 * v] = (uint8_t)h0; mv[4 * v + 1] = (uint8_t)h1;
            mv[4 * v + 2] = (uint8_t)h2; mv[4 * v + 3] = (uint8_t)h3;
        }
    }
    // block 0 of the pair takes the head (threads 0-2) and the tail
    // (threads 4-6) one key at a time
    if (blk == 0) {
        int64_t i = -1;
        if ((int64_t)threadIdx.x < head) i = threadIdx.x;
        else if (threadIdx.x >= 4 && (int64_t)threadIdx.x - 4 < n_a - tail_at)
            i = tail_at + threadIdx.x - 4;
        if (i >= 0) {
            const int32_t k = __ldg(pa + i);
            int h = 0;
            if (bitmap) {
                h = bit_member(bm, lo, n_bits, k);
            } else if (n_b > 0) {
                search_members<1>(bs, n_b, &k, &h);
            }
            ma[i] = (uint8_t)h;
            n_hit += h;
        }
    }
    const int warp_hits = __reduce_add_sync(0xffffffffu, n_hit);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) s_hits[warp] = warp_hits;
    __syncthreads();
    if (threadIdx.x == 0) {
        int total = 0;
        for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += s_hits[w];
        if (total > 0) atomicAdd(counts + j, (unsigned long long)total);
    }
}

// Plain C entry points, loaded with ctypes.  All arrays are on the
// device.  Each launches on the caller's stream, allocates nothing, does
// not synchronise, and returns the launch status (cudaGetLastError) so
// the caller can raise.  ``threads`` must be a multiple of 32 (at most
// 1024) and equal to the block size the block starts were computed with.

// ``segs`` int64 (S, 4), ``seg_start`` int64 (S,); ``words`` zeroed by
// the caller.  One block per ``threads`` keys of each segment.
extern "C" int semijoin_bitmap_launch(const int32_t* build,
                                      const int64_t* segs,
                                      const int64_t* seg_start,
                                      int64_t n_segs, int64_t n_blocks,
                                      int threads, unsigned int* words,
                                      void* stream) {
    if (n_segs <= 0 || n_blocks <= 0) return (int)cudaSuccess;
    if (n_blocks > 0x7fffffffLL || threads <= 0 || threads > 1024 ||
        threads % 32)
        return (int)cudaErrorInvalidConfiguration;
    semijoin_bitmap_kernel<<<(unsigned)n_blocks, threads, 0,
                             (cudaStream_t)stream>>>(build, segs, seg_start,
                                                     n_segs, words);
    return (int)cudaGetLastError();
}

// ``pairs`` int64 (P, 8), ``block_start`` int64 (P,); ``counts`` zeroed by
// the caller.  One block per ``threads`` * 16 probe keys of each pair.
extern "C" int semijoin_launch(const int32_t* probe, const int32_t* build,
                               const unsigned int* words,
                               const int64_t* pairs,
                               const int64_t* block_start, int64_t n_pairs,
                               int64_t n_blocks, int threads, uint8_t* mask,
                               unsigned long long* counts, void* stream) {
    if (n_pairs <= 0 || n_blocks <= 0) return (int)cudaSuccess;
    if (n_blocks > 0x7fffffffLL || threads <= 0 || threads > 1024 ||
        threads % 32)
        return (int)cudaErrorInvalidConfiguration;
    semijoin_kernel<<<(unsigned)n_blocks, threads, 0,
                      (cudaStream_t)stream>>>(probe, build, words, pairs,
                                              block_start, n_pairs, mask,
                                              counts);
    return (int)cudaGetLastError();
}
