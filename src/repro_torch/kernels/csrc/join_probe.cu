// Sort-merge join probe for Hopper (sm_90a).
//
// For each probe key a_i against an ascending int32 build column b:
//     lo[i]  = #{b < a_i}     (lower-bound rank)
//     cnt[i] = #{b == a_i}    (match count)
// the two arrays the join expansion of repro_torch.core.jexec needs.
//
// Replaces the TPU kernel src/repro/kernels/mergejoin.py::join_probe_kernel
// (a tiled compare-and-reduce over a (probe tile x build tile) grid with
// sorted-tile skips).  That tiling is not carried over.
//
// What bounded the first design.  One thread per key binary-searched the
// whole build column in global memory, then galloped to the end of its
// run: 19 dependent loads for the main path's largest build of 2^19 keys.
// The top levels are shared by every thread and hit L1, but each of the
// 8-9 lower levels is a scattered 4-byte read that costs a 32-byte L2
// sector, so a key moved about 256-288 bytes through L2 and waited on a
// chain of about 9 L2 latencies.  On the main path's largest input
// (268,435,456 probe keys, 524,288 build keys) it took 13.29 ms on an
// H100 (700 W) against a 0.96 ms bytes bound.
//
// This design:
//   * A persistent grid: at most (SMs x resident blocks) blocks of one key
//     a thread walk the probe, so a small probe starts a few blocks.
//   * The top of the search tree in shared memory.  Each block stages the
//     splitters s[g] = b[g * stride] (g < G = ceil(n_b / stride), stride the
//     smallest power of two that keeps G within the wrapper's SMEM_KEYS)
//     once, with plain strided loads (8 in flight a thread), in Eytzinger
//     (breadth-first) order: slot 1 is the root, slots 2k and 2k+1 its
//     children, slot 0 the largest rank, pads INT32_MAX.  A search walks
//     one level per step, k = 2k + (t[k] < key), and the leaf it ends on
//     counts the splitters below the key.  In that order the lanes of a
//     warp read neighbouring words on the top levels, where a sorted array
//     would put every lane's probe on one bank.  When n_b <= SMEM_KEYS the
//     stride is 1: the whole column is in shared memory and the search
//     reads no global memory at all.
//   * One window read per key.  The splitter search leaves the lower bound
//     in one segment of `stride` keys.  For stride <= 32 that segment (at
//     least 4 keys wide) is read whole as 16-byte vector loads (one
//     128-byte line at most) and counted in registers; above 32, a binary
//     search over every 32nd key of the segment first narrows it to 32
//     keys (log2(stride / 32) loads).  The upper end of a run needs a
//     second window only when the splitter after the lower bound equals
//     the key: then the window from that splitter on, and a second tree
//     search only for a run longer than that window.
//   * Early exits: key > b[n_b - 1] gives (n_b, 0), which covers every
//     probe pad, and key < b[0] gives (0, 0).  Both bounds sit in
//     registers.
//
// What bounds it now, on an H100 (700 W) at the main path's largest shape
// (tools/probe_ablate.py, a seeded input of that shape): 4.68 ms against a
// 0.96 ms bytes bound.  Compiled without the window reads it takes 2.68
// ms, without the tree walk 2.83 ms, without both 1.58 ms.  So reading the
// probe and writing the answers costs 1.6x the bound on its own (one key a
// thread in flight); the walk (bank conflicts of 32 lanes on random tree
// nodes below the top five levels) and the window reads (a scattered
// 64-byte line a key) cost more together than apart, since both go
// through the SM's one load/store path.  Two keys a thread, window reads
// shared by groups of lanes, and a two-stage pipeline (a window in flight
// during the next key's walk) were tried and were not faster.
//
// Sentinels need no special case: probe pads are 2^31-1 and probe UNBOUND
// keys -3, build pads 2^31-2 and build UNBOUND keys -5, so they never
// match, and a probe pad's lo is n_b, exactly what searchsorted gives.
// The build column must be 16-byte aligned (the wrapper checks it).
//
// A batch.  The executor runs B bindings of a query template at once, so
// a join probes B rows of n_a keys.  Where the B rows share one build (a
// presorted bounds-free scan), the wrapper hands the kernel the rows end
// to end as one probe of B * n_a keys, and each block stages the shared
// tree once.  Where each row has its own build of n_b keys (a build that
// depends on the binding), join_probe_batched_launch gives every row its
// blocks: blockIdx.y is the row, and a block stages its row's tree and
// walks its row's probe with the x-grid.  All rows have the same n_b (the
// build's static capacity), so they share the stride, the tree size and W.
// On the most frequent 32-row steps of the served WatDiv mix at scale 340
// (chip_smoke.py phase 7a, H100, 700 W): a build a row, 32 x 131,072 keys
// against 1,048,576 build keys a row, 0.134 ms against 1.276 ms for 32
// single launches and a 0.055 ms bytes bound (each block stages its row's
// tree, 32 trees where one build stages one); one build, 32 x 131,072
// keys against 131,072, 0.061 ms against 1.399 ms and 0.015 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t KEY_MAX = 0x7fffffff;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
    return a < b ? a : b;
}

// sorted rank held by Eytzinger slot p of a tree of 2^h slots
__device__ __forceinline__ int64_t slot_rank(int p, int h) {
    if (p == 0) return (1LL << h) - 1;
    const int d = 31 - __clz(p);
    return ((int64_t)(2 * (p - (1 << d)) + 1) << (h - 1 - d)) - 1;
}

// the slot that holds sorted rank r < 2^h
__device__ __forceinline__ int rank_slot(int r, int h) {
    if (r == (1 << h) - 1) return 0;
    const int tz = __ffs(r + 1) - 1;
    return (1 << (h - 1 - tz)) + ((r + 1) >> (tz + 1));
}

// #{ranks r < 2^h : s_r < key} (UPPER: s_r <= key); pads count only for
// UPPER and key == INT32_MAX, which the caller clamps to G
template <bool UPPER>
__device__ __forceinline__ int tree_count(const int32_t* t, int h,
                                          int32_t key) {
    int k = 1;
    for (int d = 0; d < h; ++d) {
        const int32_t v = t[k];
        k = 2 * k + (UPPER ? (v <= key) : (v < key));
    }
    int g = k - (1 << h);
    if (g == (1 << h) - 1) g += UPPER ? (t[0] <= key) : (t[0] < key);
    return g;
}

// start of the 32-key window of segment [seg, seg + len) that holds the
// key's bound: a binary search over every 32nd key of the segment
template <bool UPPER>
__device__ __forceinline__ int narrow(const int32_t* __restrict__ build,
                                      int64_t seg, int64_t len, int32_t key) {
    int l = 1, h = (int)((len + 31) >> 5);
    while (l < h) {
        const int m = (l + h) >> 1;
        const int32_t v = __ldg(build + seg + ((int64_t)m << 5));
        if (UPPER ? (v <= key) : (v < key)) l = m + 1; else h = m;
    }
    return (int)(seg + ((int64_t)(l - 1) << 5));
}

// (lt, le) counts of the key over the W keys from w, all in range: lt in
// bits 0-7, le in bits 8-15
template <int W>
__device__ __forceinline__ int window_full(const int32_t* __restrict__ build,
                                           int64_t w, int32_t key) {
    const int4* p = reinterpret_cast<const int4*>(build + w);
    int v = 0;
#pragma unroll
    for (int c = 0; c < W / 4; ++c) {
        const int4 x = __ldg(p + c);
        const int lt = (x.x < key) + (x.y < key) + (x.z < key) + (x.w < key);
        const int le = (x.x <= key) + (x.y <= key) + (x.z <= key) +
                       (x.w <= key);
        v += lt + (le << 8);
    }
    return v;
}

// the same over the part of the window before n_b
__device__ __forceinline__ int window_tail(const int32_t* __restrict__ build,
                                           int64_t n_b, int64_t w, int width,
                                           int32_t key) {
    int v = 0;
    for (int64_t e = w; e < n_b && e < w + width; ++e) {
        const int32_t x = __ldg(build + e);
        v += (x < key) + ((x <= key) << 8);
    }
    return v;
}

template <int W>
__device__ __forceinline__ int window_count(const int32_t* __restrict__ build,
                                            int64_t n_b, int64_t w,
                                            int32_t key) {
    return w + W <= n_b ? window_full<W>(build, w, key)
                        : window_tail(build, n_b, w, W, key);
}

// What one probe key carries from its search to its window reads.
struct Probe {
    int64_t w1, w2;   // windows of the lower and the upper bound (-1: none)
    int lo, hi;       // the answer when it needs no window
    bool act, eq;     // b[0] <= key <= b[n_b - 1]; splitter g1 equals key
};

// W: window width in keys, max(4, min(stride, 32)) (0: stride 1, the whole
// column is in shared memory and no key reads global memory)
template <int W>
__global__ void __launch_bounds__(1024)
join_probe_kernel(const int32_t* __restrict__ probe, int64_t n_a,
                  const int32_t* __restrict__ build, int64_t n_b,
                  int64_t build_row_stride, int log2_stride,
                  int64_t n_splitters, int h,
                  int32_t* __restrict__ lo_out, int32_t* __restrict__ cnt_out) {
    extern __shared__ int32_t tree[];
    // row blockIdx.y of a batch: its probe and answers, and its build
    // (build_row_stride keys on; 0 in a launch of one row)
    const int64_t row = blockIdx.y;
    probe += row * n_a;
    lo_out += row * n_a;
    cnt_out += row * n_a;
    build += row * build_row_stride;
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (n_b == 0) {
        for (; i < n_a; i += step) {
            lo_out[i] = 0;
            cnt_out[i] = 0;
        }
        return;
    }
    const int slots = 1 << h;
    const int G = (int)n_splitters;
    constexpr int STAGE = 8;   // staging loads in flight per thread
    for (int p0 = threadIdx.x; p0 < slots; p0 += STAGE * blockDim.x) {
        int32_t v[STAGE];
#pragma unroll
        for (int u = 0; u < STAGE; ++u) {
            const int p = p0 + u * blockDim.x;
            const int64_t r = p < slots ? slot_rank(p, h) : G;
            v[u] = r < G ? __ldg(build + (r << log2_stride)) : KEY_MAX;
        }
#pragma unroll
        for (int u = 0; u < STAGE; ++u)
            if (p0 + u * (int)blockDim.x < slots) tree[p0 + u * blockDim.x] = v[u];
    }
    __syncthreads();
    const int32_t first = __ldg(build), last = __ldg(build + n_b - 1);
    const int64_t stride = 1LL << log2_stride;

    // the splitter search of one key, and the windows it leaves
    auto search = [&](int32_t key) {
        Probe q;
        q.w1 = q.w2 = -1;
        q.act = key >= first && key <= last;
        q.eq = false;
        q.lo = q.hi = key > last ? (int)n_b : 0;
        if (!q.act) return q;
        const int g1 = tree_count<false>(tree, h, key);   // splitters < key
        q.eq = g1 < G && tree[rank_slot(g1, h)] == key;
        if constexpr (W == 0) {
            q.lo = q.hi = g1;
            if (q.eq) {
                const int g2 = tree_count<true>(tree, h, key);
                q.hi = g2 < G ? g2 : G;
            }
        } else {
            // the lower bound lies in segment g1 - 1 (or is 0: the key is
            // b[0]); the upper bound in the same segment or, when splitter
            // g1 equals the key, from position g1 * stride on
            const int64_t seg = (int64_t)(g1 - 1) << log2_stride;
            if (g1 > 0)
                q.w1 = stride > 32
                    ? narrow<false>(build, seg, min64(stride, n_b - seg), key)
                    : seg & ~(int64_t)(W - 1);
            if (q.eq)
                q.w2 = ((int64_t)g1 << log2_stride) & ~(int64_t)(W - 1);
            else if (stride > 32)
                q.w2 = narrow<true>(build, seg, min64(stride, n_b - seg), key);
            else
                q.w2 = q.w1;
        }
        return q;
    };
    // one key a thread and round; the next round's key is fetched a round
    // ahead
    int32_t next = i < n_a ? probe[i] : KEY_MAX;
    for (; i < n_a; i += step) {
        const int32_t key = next;
        next = i + step < n_a ? probe[i + step] : KEY_MAX;
        Probe q = search(key);
        if constexpr (W != 0) {
            if (q.act) {
                const int v1 = q.w1 >= 0 ? window_count<W>(build, n_b, q.w1, key)
                                         : 0;
                q.lo = q.w1 >= 0 ? (int)q.w1 + (v1 & 0xff) : 0;
                const int le = q.w2 == q.w1
                    ? v1 >> 8 : window_count<W>(build, n_b, q.w2, key) >> 8;
                q.hi = (int)q.w2 + le;
                if (q.eq && le == W && q.w2 + W < n_b) {
                    // a run longer than the window: find its segment
                    int g2 = tree_count<true>(tree, h, key);
                    if (g2 > G) g2 = G;
                    const int64_t seg = (int64_t)(g2 - 1) << log2_stride;
                    const int64_t w3 = stride > 32
                        ? narrow<true>(build, seg, min64(stride, n_b - seg), key)
                        : seg & ~(int64_t)(W - 1);
                    q.hi = (int)w3 + (window_count<W>(build, n_b, w3, key) >> 8);
                }
            }
        }
        lo_out[i] = q.lo;
        cnt_out[i] = q.hi - q.lo;
    }
}

struct LaunchArgs {
    const int32_t* probe;
    int64_t n_a;
    const int32_t* build;
    int64_t n_b;
    int64_t batch;             // rows: gridDim.y
    int64_t build_row_stride;  // keys between two rows' builds
    int log2_stride;
    int64_t n_splitters;
    int h;
    int smem;
    int64_t blocks;
    int threads;
    int sms;
    int32_t* lo_out;
    int32_t* cnt_out;
    cudaStream_t stream;
};

// Per kernel and device: the dynamic shared memory the kernel may take,
// and the blocks an SM holds at each tree size (2^h slots), so that a
// launch asks the runtime only the first time.
constexpr int MAX_DEVICES = 64;
struct Residency {
    int smem_allowed = 48 * 1024;
    int threads[17] = {};
    int resident[17] = {};
};

template <int W>
int launch(const LaunchArgs& a) {
    auto kern = join_probe_kernel<W>;
    static Residency cache[MAX_DEVICES];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES || a.h > 16) return (int)cudaErrorInvalidValue;
    Residency& c = cache[dev];
    if (a.smem > c.smem_allowed) {
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
        if (err != cudaSuccess) return (int)err;
        c.smem_allowed = a.smem;
    }
    if (c.threads[a.h] != a.threads) {
        int resident = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kern,
                                                            a.threads, a.smem);
        if (err != cudaSuccess) return (int)err;
        c.threads[a.h] = a.threads;
        c.resident[a.h] = resident;
    }
    const int resident = c.resident[a.h];
    if (resident < 1) return (int)cudaErrorInvalidConfiguration;
    // the persistent grid: a row's blocks, all rows' together at most what
    // the SMs hold at once (and at least one a row)
    int64_t blocks = a.blocks;
    const int64_t room = (int64_t)a.sms * resident / a.batch;
    if (blocks > room) blocks = room > 0 ? room : 1;
    const dim3 grid((unsigned)blocks, (unsigned)a.batch);
    kern<<<grid, a.threads, a.smem, a.stream>>>(
        a.probe, a.n_a, a.build, a.n_b, a.build_row_stride, a.log2_stride,
        a.n_splitters, a.h, a.lo_out, a.cnt_out);
    return (int)cudaGetLastError();
}

int launch_any(const LaunchArgs& a) {
    if (a.n_b == 0 || a.log2_stride == 0) return launch<0>(a);
    switch (a.log2_stride) {
        case 1: case 2: return launch<4>(a);
        case 3: return launch<8>(a);
        case 4: return launch<16>(a);
        default: return launch<32>(a);
    }
}

int smem_height(int smem_bytes) {
    int h = 0;
    while ((4 << h) < smem_bytes) ++h;
    return h;
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Each launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// the launch status (cudaGetLastError, or the error of the attribute or
// occupancy query) so the caller can raise on a refused launch.
// smem_bytes is 4 << h for a tree of 2^h slots (0 when n_b == 0); blocks
// is the caller's grid (a row's, in the batched launch), cut to what the
// SMs hold at once.

// n_a probe keys against one build column of n_b keys.
extern "C" int join_probe_launch(const int32_t* probe, int64_t n_a,
                                 const int32_t* build, int64_t n_b,
                                 int32_t* lo_out, int32_t* cnt_out,
                                 int log2_stride, int64_t n_splitters,
                                 int smem_bytes, int64_t blocks, int threads,
                                 int sms, void* stream) {
    if (n_a <= 0) return (int)cudaSuccess;
    LaunchArgs a{probe, n_a, build, n_b, 1, 0, log2_stride, n_splitters,
                 smem_height(smem_bytes), smem_bytes, blocks, threads, sms,
                 lo_out, cnt_out, (cudaStream_t)stream};
    return launch_any(a);
}

// batch rows of n_a probe keys, row r against its own build of n_b keys
// at build + r * n_b (every row 16-byte aligned: n_b a multiple of 4 when
// batch > 1); the answers row-major like the probe.
extern "C" int join_probe_batched_launch(const int32_t* probe, int64_t n_a,
                                         const int32_t* build, int64_t n_b,
                                         int64_t batch, int32_t* lo_out,
                                         int32_t* cnt_out, int log2_stride,
                                         int64_t n_splitters, int smem_bytes,
                                         int64_t blocks, int threads, int sms,
                                         void* stream) {
    if (n_a <= 0 || batch <= 0) return (int)cudaSuccess;
    if (batch > 65535) return (int)cudaErrorInvalidValue;
    LaunchArgs a{probe, n_a, build, n_b, batch, n_b, log2_stride,
                 n_splitters, smem_height(smem_bytes), smem_bytes, blocks,
                 threads, sms, lo_out, cnt_out, (cudaStream_t)stream};
    return launch_any(a);
}
