// Sort-merge join probe for Hopper (sm_90a).
//
// For each probe key a_i against an ascending int32 build column b:
//     lo[i]  = #{b < a_i}     (lower-bound rank)
//     cnt[i] = #{b == a_i}    (match count)
// the two arrays the join expansion of repro_torch.core.jexec needs.
//
// Replaces the TPU kernel src/repro/kernels/mergejoin.py::join_probe_kernel
// (a tiled compare-and-reduce over a (probe tile x build tile) grid with
// sorted-tile skips).  That tiling is not carried over: here one thread
// takes one probe key, binary-searches its lower bound over [0, n_b), and
// finds the end of its run of equal keys by a galloping search from the
// lower bound (1, 2, 4, ... steps, then a binary search in the last gap),
// which reads O(log cnt) words next to the lower bound instead of a
// second full search; a key that does not match stops after one read.
//
// What bounds it on the card: bytes.  The function must read 4 (n_a + n_b)
// bytes and write 8 n_a bytes, but each lower-bound search reads log2(n_b)
// scattered 4-byte words, a chain of dependent loads, and every such read
// costs a 32-byte sector, so the kernel moves about 32 log2(n_b) bytes
// per probe key and waits on the latency of each.  The top levels of the
// search tree are shared by every thread and stay in L1/L2; the lower
// levels miss.  The design does nothing more about that yet (merge-path
// over a sorted probe, or staging the top of the tree in shared memory,
// is later work).
//
// Sentinels need no special case: probe pads are 2^31-1 and probe UNBOUND
// keys -3, build pads 2^31-2 and build UNBOUND keys -5, so they never
// match, and a probe pad's lo is n_b, exactly what searchsorted gives.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void join_probe_kernel(const int32_t* __restrict__ probe,
                                  int64_t n_a,
                                  const int32_t* __restrict__ build,
                                  int64_t n_b,
                                  int32_t* __restrict__ lo_out,
                                  int32_t* __restrict__ cnt_out) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < n_a; i += stride) {
        const int32_t key = probe[i];
        int64_t l = 0, h = n_b;
        while (l < h) {                       // first b >= key
            const int64_t m = l + ((h - l) >> 1);
            if (__ldg(build + m) < key) l = m + 1; else h = m;
        }
        const int64_t first = l;
        int64_t end = first;                  // first b > key
        if (first < n_b && __ldg(build + first) == key) {
            // gallop: every index below l holds b <= key, and h is n_b or
            // an index holding b > key
            int64_t step = 1;
            l = first + 1;
            h = first + 1;
            while (h < n_b && __ldg(build + h) <= key) {
                l = h + 1;
                step <<= 1;
                h = first + step;
            }
            if (h > n_b) h = n_b;
            while (l < h) {
                const int64_t m = l + ((h - l) >> 1);
                if (__ldg(build + m) <= key) l = m + 1; else h = m;
            }
            end = l;
        }
        lo_out[i] = (int32_t)first;
        cnt_out[i] = (int32_t)(end - first);
    }
}

// Plain C entry point, loaded with ctypes.  Launches on the caller's
// stream, allocates nothing, does not synchronise, and returns the launch
// status (cudaGetLastError) so the caller can raise on a refused launch.
extern "C" int join_probe_launch(const int32_t* probe, int64_t n_a,
                                 const int32_t* build, int64_t n_b,
                                 int32_t* lo_out, int32_t* cnt_out,
                                 void* stream) {
    if (n_a <= 0) return (int)cudaSuccess;
    const int threads = 256;
    // one thread per key; the grid-stride loop only covers keys past the
    // largest grid
    int64_t blocks = (n_a + threads - 1) / threads;
    const int64_t max_blocks = 1 << 30;
    if (blocks > max_blocks) blocks = max_blocks;
    join_probe_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(probe, n_a, build, n_b,
                                                lo_out, cnt_out);
    return (int)cudaGetLastError();
}
