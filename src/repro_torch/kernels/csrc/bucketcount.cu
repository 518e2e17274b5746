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
// carries over: each block counts a grid-strided share of the keys and
// adds its counts to the global histogram with atomics.  Integer sums are
// exact in any order, so the result equals the plain version
// (kernels/ref.py::bucket_count_ref) bit for bit on every path.  (The TPU
// kernel also uses a signed floor-mod, which disagrees with its own
// reference on negative keys; this one follows the reference.)
//
// What bounds it on the card: bytes.  The function reads 5 bytes a row
// (the key and its validity byte) and writes 4 bytes a bucket; 2^28 rows
// take 0.40 ms at 3.35 TB/s.  To stream at that rate an SM needs about
// 18 KB of loads in flight (Little's law: 3.35 TB/s x ~0.7 us over 132
// SMs); one 4-byte key and one validity byte a lane, as this kernel's
// first design read them, left about 10 KB in flight and ran at half the
// bound.  So:
//  - The grid is persistent (the wrapper launches SMs x blocks per SM)
//    and its threads stride over the keys 16 at a time: four 16-byte
//    loads of keys and one 16-byte load of their 16 validity bytes, all
//    five in flight before any is used (80 bytes a thread).
//  - With few buckets (at most REG_BUCKETS, which covers the ranks a
//    deployment runs), every thread counts in registers, one counter a
//    bucket; with one bucket that is a count of live rows.  The counters
//    meet once, after the loop: __reduce_add_sync over each warp, one
//    shared add a warp a bucket, one global atomic a block a bucket.  The
//    inner loop has no shuffle and no atomic.
//  - Up to SMEM_BUCKETS buckets, a shared histogram a block: each warp
//    groups its lanes by bucket (__match_any_sync) and one lane a group
//    adds the group's size, then each non-zero bucket goes to the output
//    with one atomic.  SMEM_BUCKETS is 48 KB of counters, the most a
//    block gets without opting in to more.
//  - Above that, global atomics straight into the output.
//
// The 16-byte body starts at the first key lo where keys + lo and
// valid + lo are both 16-byte aligned and ends at hi, a whole number of
// 16-key steps later; the head [0, lo) and the tail [hi, n) are taken
// one key a thread by the same kernel.  Where no index aligns both
// pointers (a key view and a validity view at unlike offsets), the
// caller passes lo = hi = 0 and every key goes one at a time.  The
// wrapper (ops._bucket_plan) computes the path, the blocks and the body.
//
// The entry point zeroes the output in stream order (cudaMemsetAsync)
// before the launch, so the caller allocates it without a fill.
//
// A batch: B rows of n keys each (a (B, n) key matrix and its (B, n)
// validity bytes) give a (B, n_buckets) histogram in one launch, as the
// distributed executor shuffles a batch of bindings: blockIdx.y is the
// row, each block offsets the keys, the validity and the output by its
// row's stride, and the x-grid is the one-row grid above, with all rows'
// blocks together capped by what the SMs hold.  Every path counts per
// row.  Every row shares the body [lo, hi) only when each row starts at
// the same alignment, that is when n is a multiple of 16 keys; otherwise
// the caller passes lo = hi = 0.

#include <cuda_runtime.h>
#include <stdint.h>

#define PROBE_PAD 0x7fffffff
#define SMEM_BUCKETS 12288
#define REG_BUCKETS 8
#define STEP_KEYS 16
#define FULL_MASK 0xffffffffu

// the kernel's paths, as ops.BUCKET_PATH_IDS numbers them
#define PATH_REGISTERS 0
#define PATH_SHARED 1
#define PATH_GLOBAL 2

template <class Sink>
__device__ __forceinline__ void sink_word(Sink& sink, uint32_t v, int4 k) {
    sink(v & 0xffu, k.x);
    sink((v >> 8) & 0xffu, k.y);
    sink((v >> 16) & 0xffu, k.z);
    sink(v >> 24, k.w);
}

// Calls sink(validity byte, key) once for every key of [0, n): the body
// [lo, hi) 16 keys a thread a step, then the head and tail one key a
// thread.  Both loops are bounded by the warp's first index, so every
// lane of a warp makes the same calls (a lane past the end passes
// validity 0) and a sink may use warp-wide intrinsics.
template <class Sink>
__device__ __forceinline__ void walk_keys(const int32_t* __restrict__ keys,
                                          const uint8_t* __restrict__ valid,
                                          int64_t n, int64_t lo, int64_t hi,
                                          Sink& sink) {
    const int lane = threadIdx.x & 31;
    const int64_t first =
        (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31);
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t steps = (hi - lo) / STEP_KEYS;
    const int4* __restrict__ kv = reinterpret_cast<const int4*>(keys + lo);
    const uint4* __restrict__ vv = reinterpret_cast<const uint4*>(valid + lo);
    for (int64_t base = first; base < steps; base += stride) {
        const int64_t c = base + lane;
        int4 k0 = make_int4(0, 0, 0, 0), k1 = k0, k2 = k0, k3 = k0;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (c < steps) {
            k0 = __ldg(kv + 4 * c);
            k1 = __ldg(kv + 4 * c + 1);
            k2 = __ldg(kv + 4 * c + 2);
            k3 = __ldg(kv + 4 * c + 3);
            v = __ldg(vv + c);
        }
        sink_word(sink, v.x, k0);
        sink_word(sink, v.y, k1);
        sink_word(sink, v.z, k2);
        sink_word(sink, v.w, k3);
    }
    const int64_t n_scalar = lo + (n - hi);
    for (int64_t base = first; base < n_scalar; base += stride) {
        const int64_t s = base + lane;
        const int64_t i = s < lo ? s : hi + (s - lo);
        const bool in = s < n_scalar;
        sink(in ? (uint32_t)__ldg(valid + i) : 0u, in ? __ldg(keys + i) : 0);
    }
}

__device__ __forceinline__ bool live(uint32_t v, int32_t key) {
    return v != 0u && key != PROBE_PAD;
}

template <int NB>
struct RegisterCounts {
    unsigned c[NB];
    __device__ __forceinline__ void operator()(uint32_t v, int32_t key) {
        const bool on = live(v, key);
        if constexpr (NB == 1) {
            c[0] += on;
        } else {
            const uint32_t b = (uint32_t)key % NB;
#pragma unroll
            for (int j = 0; j < NB; ++j) c[j] += on && b == (uint32_t)j;
        }
    }
};

struct SharedCounts {
    unsigned* hist;
    uint32_t n_buckets;
    int lane;
    __device__ __forceinline__ void operator()(uint32_t v, int32_t key) {
        // n_buckets (out of range) marks a row that counts nowhere
        const uint32_t b = live(v, key) ? (uint32_t)key % n_buckets
                                        : n_buckets;
        const unsigned peers = __match_any_sync(FULL_MASK, b);
        if (b < n_buckets && lane == __ffs(peers) - 1)
            atomicAdd(hist + b, (unsigned)__popc(peers));
    }
};

struct GlobalCounts {
    unsigned* out;
    uint32_t n_buckets;
    __device__ __forceinline__ void operator()(uint32_t v, int32_t key) {
        if (live(v, key)) atomicAdd(out + (uint32_t)key % n_buckets, 1u);
    }
};

template <int NB>
__global__ void bucket_count_registers(const int32_t* __restrict__ keys,
                                       const uint8_t* __restrict__ valid,
                                       int64_t n, int64_t lo, int64_t hi,
                                       unsigned int* __restrict__ out) {
    __shared__ unsigned hist[NB];
    keys += (int64_t)blockIdx.y * n;
    valid += (int64_t)blockIdx.y * n;
    out += (int64_t)blockIdx.y * NB;
    if (threadIdx.x < NB) hist[threadIdx.x] = 0;
    RegisterCounts<NB> counts;
#pragma unroll
    for (int j = 0; j < NB; ++j) counts.c[j] = 0;
    walk_keys(keys, valid, n, lo, hi, counts);
    __syncthreads();   // hist zeroed (and every warp done walking)
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        const unsigned w = __reduce_add_sync(FULL_MASK, counts.c[j]);
        if ((threadIdx.x & 31) == 0 && w) atomicAdd(&hist[j], w);
    }
    __syncthreads();
    if (threadIdx.x < NB && hist[threadIdx.x])
        atomicAdd(out + threadIdx.x, hist[threadIdx.x]);
}

__global__ void bucket_count_shared(const int32_t* __restrict__ keys,
                                    const uint8_t* __restrict__ valid,
                                    int64_t n, int64_t lo, int64_t hi,
                                    uint32_t n_buckets,
                                    unsigned int* __restrict__ out) {
    extern __shared__ unsigned hist[];
    keys += (int64_t)blockIdx.y * n;
    valid += (int64_t)blockIdx.y * n;
    out += (int64_t)blockIdx.y * n_buckets;
    for (uint32_t b = threadIdx.x; b < n_buckets; b += blockDim.x) hist[b] = 0;
    __syncthreads();
    SharedCounts counts{hist, n_buckets, (int)(threadIdx.x & 31)};
    walk_keys(keys, valid, n, lo, hi, counts);
    __syncthreads();
    for (uint32_t b = threadIdx.x; b < n_buckets; b += blockDim.x) {
        const unsigned c = hist[b];
        if (c) atomicAdd(out + b, c);
    }
}

__global__ void bucket_count_global(const int32_t* __restrict__ keys,
                                    const uint8_t* __restrict__ valid,
                                    int64_t n, int64_t lo, int64_t hi,
                                    uint32_t n_buckets,
                                    unsigned int* __restrict__ out) {
    keys += (int64_t)blockIdx.y * n;
    valid += (int64_t)blockIdx.y * n;
    out += (int64_t)blockIdx.y * n_buckets;
    GlobalCounts counts{out, n_buckets};
    walk_keys(keys, valid, n, lo, hi, counts);
}

template <int NB>
static void launch_registers(const int32_t* keys, const uint8_t* valid,
                             int64_t n, int64_t lo, int64_t hi,
                             dim3 grid, int threads, unsigned int* out,
                             cudaStream_t s) {
    bucket_count_registers<NB><<<grid, threads, 0, s>>>(keys, valid, n, lo,
                                                        hi, out);
}

// Zeroes ``out`` (batch x n_buckets counts) and launches the path's
// kernel over ``batch`` rows of ``n`` keys on stream ``s``.
static int launch(const int32_t* keys, const uint8_t* valid, int64_t n,
                  int64_t batch, int64_t n_buckets, int path, int64_t lo,
                  int64_t hi, int64_t n_blocks, int threads, int32_t* out,
                  void* stream) {
    if (n < 0 || batch <= 0 || batch > 65535 || n_buckets <= 0 ||
        n_buckets > 0xffffffffLL || lo < 0 || lo > hi || hi > n ||
        (hi - lo) % STEP_KEYS || n_blocks <= 0 || n_blocks > 0x7fffffffLL ||
        threads <= 0 || threads > 1024 || threads % 32)
        return (int)cudaErrorInvalidConfiguration;
    if ((path == PATH_REGISTERS && n_buckets > REG_BUCKETS) ||
        (path == PATH_SHARED && n_buckets > SMEM_BUCKETS) ||
        path < PATH_REGISTERS || path > PATH_GLOBAL)
        return (int)cudaErrorInvalidValue;
    // every row's body starts 16-byte aligned: the first row's, and a row
    // stride of a whole number of 16-key steps
    if (hi > lo && ((((uintptr_t)(keys + lo) | (uintptr_t)(valid + lo)) & 15) ||
                    (batch > 1 && n % STEP_KEYS)))
        return (int)cudaErrorMisalignedAddress;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err =
        cudaMemsetAsync(out, 0, (size_t)batch * (size_t)n_buckets * 4, s);
    if (err != cudaSuccess) return (int)err;
    if (n == 0) return (int)cudaSuccess;
    unsigned int* hist = (unsigned int*)out;
    const dim3 grid((unsigned)n_blocks, (unsigned)batch);
    if (path == PATH_REGISTERS) {
        switch (n_buckets) {
            case 1: launch_registers<1>(keys, valid, n, lo, hi, grid, threads, hist, s); break;
            case 2: launch_registers<2>(keys, valid, n, lo, hi, grid, threads, hist, s); break;
            case 3: launch_registers<3>(keys, valid, n, lo, hi, grid, threads, hist, s); break;
            case 4: launch_registers<4>(keys, valid, n, lo, hi, grid, threads, hist, s); break;
            case 5: launch_registers<5>(keys, valid, n, lo, hi, grid, threads, hist, s); break;
            case 6: launch_registers<6>(keys, valid, n, lo, hi, grid, threads, hist, s); break;
            case 7: launch_registers<7>(keys, valid, n, lo, hi, grid, threads, hist, s); break;
            case 8: launch_registers<8>(keys, valid, n, lo, hi, grid, threads, hist, s); break;
            default: return (int)cudaErrorInvalidValue;
        }
    } else if (path == PATH_SHARED) {
        const size_t smem = (size_t)n_buckets * sizeof(unsigned int);
        bucket_count_shared<<<grid, threads, smem, s>>>(
            keys, valid, n, lo, hi, (uint32_t)n_buckets, hist);
    } else {
        bucket_count_global<<<grid, threads, 0, s>>>(
            keys, valid, n, lo, hi, (uint32_t)n_buckets, hist);
    }
    return (int)cudaGetLastError();
}

// Plain C entry points, loaded with ctypes.  ``keys`` int32, ``valid``
// one byte per key (a torch.bool tensor), ``out`` int32 on the device;
// ``path`` one of PATH_*, [lo, hi) the 16-byte body of a row (both
// pointers 16-byte aligned at lo, hi - lo a multiple of 16).  Each zeroes
// ``out`` and launches ``n_blocks`` blocks of ``threads`` threads (a
// multiple of 32) a row on the caller's stream, allocates nothing, does
// not synchronise, and returns the launch status (cudaGetLastError) so
// the caller can raise.
//
// bucket_count_launch: one row, keys and valid (n,), out (n_buckets,).
extern "C" int bucket_count_launch(const int32_t* keys, const uint8_t* valid,
                                   int64_t n, int64_t n_buckets, int path,
                                   int64_t lo, int64_t hi, int64_t n_blocks,
                                   int threads, int32_t* out, void* stream) {
    return launch(keys, valid, n, 1, n_buckets, path, lo, hi, n_blocks,
                  threads, out, stream);
}

// bucket_count_batched_launch: ``batch`` rows, keys and valid (batch, n)
// and out (batch, n_buckets), each contiguous; a body needs n a multiple
// of 16 when batch > 1.
extern "C" int bucket_count_batched_launch(
    const int32_t* keys, const uint8_t* valid, int64_t n, int64_t batch,
    int64_t n_buckets, int path, int64_t lo, int64_t hi, int64_t n_blocks,
    int threads, int32_t* out, void* stream) {
    return launch(keys, valid, n, batch, n_buckets, path, lo, hi, n_blocks,
                  threads, out, stream);
}
