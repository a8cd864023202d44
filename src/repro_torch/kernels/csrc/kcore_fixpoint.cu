// B3 redesigned for Hopper: a whole k-core peel fixpoint as one kernel
// launch, every round on the device, written by hand for sm_90a.
//
// Replaces the reference's peel fixpoint: `kcore_fixpoint`
// (src/repro/kernels/ref.py:33, a lax.while_loop of peel rounds) over the
// Pallas kernels of src/repro/kernels/kcore_peel.py, `_degree_kernel`
// behind `degree_count` (:62, B3a) and `_threshold_kernel` behind
// `peel_round` (:117, B3b). Same function as the plain version
// `repro_torch.kernels.ref.kcore_fixpoint`, bit for bit, round count
// included. With alive_1 = alive0 (a weight: bool, int32, or every edge 1
// when alive0 is null), round r = 1, 2, ... is
//
//   deg_r[v] = sum over edges i of alive_r[i] * ([src[i] == v] + [dst[i] == v])
//   new[i]   = alive_r[i] > 0 && src[i], dst[i] in [0, n)
//              && deg_r[src[i]] >= k && deg_r[dst[i]] >= k
//   stop after round r when new == (alive_r > 0), returning new;
//   else alive_{r+1} = new (bool: later rounds count each edge once).
//
// So int32 weights count in round 1 only, a self-loop counts twice, an
// endpoint outside [0, n) counts nothing and fails the threshold, and the
// last round, where nothing dies, is counted. `rounds` receives the count.
//
// Design. The TPU loops on the host's side of the kernels: two launches
// and a flag read per round. Here one cooperative launch over the blocks
// the card holds at once runs every round, with one grid barrier a round.
// Degrees are kept by change in two buffers, D[0] and D[1]: round r reads
// deg_r from D[r & 1] and, in the same pass, adds into D[(r + 1) & 1],
// which holds deg_{r-1}, the change of rounds r - 1 and r of each edge it
// owns, so that D[(r + 1) & 1] holds deg_{r+1} at the barrier. D[1] starts
// as deg_1, counted from the weights; D[0] starts at 0 and round 1 counts
// deg_2 into it, one for each kept edge (deg_0 = 0). A round's reads and
// writes go to different buffers, so one barrier separates the rounds.
// Each edge stays with one thread, and its alive byte carries what the
// thread needs to know of round r - 1: 1 alive, 0 dead, 2 died in round
// r - 1 (r > 2; in round 2 the change is the byte minus the weight). The
// stop is a word, the last round in which an edge died (atomicMax from a
// warp with a death that finds it lower): every thread reads it after the
// barrier, and stops when it is below r. Integer adds, so the order of the atomics does not
// matter, and only edges that change touch the degrees. The atomics merge
// neighbouring lanes of a warp that hit one vertex whenever each lane adds
// the same unit (+1 to count, -1 when an edge dies): edges sorted by their
// first endpoint put a hub's edges side by side. Every barrier is reached
// by every thread: loops over edges are warp-uniform, and the round loop
// ends on the stop word, which reads the same in every thread.
//
// The operands stay in device memory: the 50 MB L2 holds them at the sizes
// served. Degrees are read with ld.cg, past L1, since the atomics of two
// rounds ago changed the buffer at L2.
//
// Never hang: each round that changes kills at least one edge, so a
// fixpoint takes at most m + 1 rounds; the kernel traps past that.
//
// Bound: memory. src and dst are read once (8 B per edge), alive0 once
// (0, 1 or 4 B) and the mask written once (1 B), 4 B of round count:
// 0.047 us at m = 17,474 over 3.35 TB/s. The loop is latency-bound: its
// serial chain is the rounds, each a pass over the edges and a grid
// barrier.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
    const int32_t* src;  // (m)
    const int32_t* dst;  // (m)
    const void* alive0;  // (m) weights of A, or null: every edge weighs 1
    uint8_t* out;        // (m) the alive bytes, bool at the end
    int32_t* deg;        // (2 n) the degree buffers D[0], D[1]
    int32_t* last;       // (1) the last round in which an edge died
    int32_t* rounds;     // (1) out: rounds run, the last included
    int64_t m, k;
    int32_t n;
};

template <typename A>
__device__ __forceinline__ int32_t weight(const A* a, int64_t i) {
    return a == nullptr ? 1 : static_cast<int32_t>(__ldg(a + i));
}

__device__ __forceinline__ bool in_range(int32_t v, int32_t n) {
    return v >= 0 && v < n;
}

// Adds x at p[v] in every lane where `on`; all 32 lanes call it together.
// UNIT: every lane that is on adds the same x, so a run of neighbouring
// lanes with one v (edges sorted by an endpoint put a hub's edges side by
// side) merges into one atomic, added by the run's first lane: a shuffle
// and a ballot find the runs.
template <bool UNIT>
__device__ __forceinline__ void add_at(int32_t* p, int32_t v, int32_t x,
                                       bool on) {
    if constexpr (!UNIT) {
        if (on) atomicAdd(p + v, x);
    } else {
        const int lane = threadIdx.x & 31;
        const int32_t key = on ? v : -1;
        const int32_t prev = __shfl_up_sync(kFull, key, 1);  // every lane
        const bool head = lane == 0 || prev != key;
        const unsigned heads = __ballot_sync(kFull, head);
        if (on && head) {
            const unsigned later = (heads >> lane) >> 1;  // heads past lane
            atomicAdd(p + v, x * (later ? __ffs(later) : 32 - lane));
        }
    }
}

template <typename A>
__global__ void __launch_bounds__(kThreads) kcore_fixpoint_kernel(Args a) {
    cg::grid_group grid = cg::this_grid();
    // bool weights are 0 or 1, and so is every later round's alive state
    constexpr bool kUnitWeights = sizeof(A) == 1;
    const int64_t m = a.m;
    const int32_t n = a.n;
    const int64_t k = a.k;  // int64: any k is compared exactly
    const A* alive0 = static_cast<const A*>(a.alive0);
    const int32_t* src = a.src;
    const int32_t* dst = a.dst;
    uint8_t* alive = a.out;
    const int lane = threadIdx.x & 31;
    const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    const int64_t warp0 = tid - lane;  // a warp walks 32 neighbouring edges
    int32_t* const D[2] = {a.deg, a.deg + n};

    for (int64_t v = tid; v < 2 * static_cast<int64_t>(n); v += stride)
        a.deg[v] = 0;
    if (tid == 0) *a.last = 0;
    grid.sync();

    // deg_1 from the weights into D[1]; round 1 counts deg_2 into D[0]
    for (int64_t b = warp0; b < m; b += stride) {
        const int64_t i = b + lane;
        const int32_t w = i < m ? weight(alive0, i) : 0;
        const int32_t s = w != 0 ? src[i] : -1;
        const int32_t d = w != 0 ? dst[i] : -1;
        add_at<kUnitWeights>(D[1], s, w, w != 0 && in_range(s, n));
        add_at<kUnitWeights>(D[1], d, w, w != 0 && in_range(d, n));
    }
    grid.sync();

    long long r = 1;
    for (;; ++r) {
        if (r > m + 1) __trap();  // a fixpoint never needs more rounds
        const int32_t* now = D[r & 1];     // deg_r
        int32_t* next = D[(r + 1) & 1];    // deg_{r-1}, becoming deg_{r+1}
                                           // (round 1: 0, becoming deg_2)
        int died = 0;
        for (int64_t b = warp0; b < m; b += stride) {
            const int64_t i = b + lane;
            const bool valid = i < m;
            const int32_t byte = valid && r > 1 ? alive[i] : 0;
            // the edge's weight in round r: alive0 in round 1, then 0 or 1
            const int32_t old = !valid ? 0
                                : r == 1 ? weight(alive0, i)
                                         : static_cast<int32_t>(byte == 1);
            // its change in round r - 1, not yet in `next`
            const int32_t before = !valid || r == 1 ? 0
                                   : r == 2 ? byte - weight(alive0, i)
                                            : -static_cast<int32_t>(byte == 2);
            int32_t s = -1, d = -1;
            if (old != 0 || before != 0) {
                s = src[i];
                d = dst[i];
            }
            const bool keep = old > 0 && in_range(s, n) && in_range(d, n) &&
                              __ldcg(now + s) >= k && __ldcg(now + d) >= k;
            const bool dies = old > 0 && !keep;
            died |= dies;
            const int32_t to = keep ? 1 : dies && r > 1 ? 2 : 0;
            if (valid && (r == 1 || to != byte)) alive[i] = to;
            const int32_t delta = before + static_cast<int32_t>(keep) - old;
            if (r == 1) {                   // deg_2: each kept edge once
                add_at<true>(next, s, 1, keep);
                add_at<true>(next, d, 1, keep);
            } else if (r == 2 && !kUnitWeights) {  // int32: any change
                add_at<false>(next, s, delta, delta != 0 && in_range(s, n));
                add_at<false>(next, d, delta, delta != 0 && in_range(d, n));
            } else {                        // 0 or 1 before: delta is 0 or -1
                add_at<true>(next, s, -1, delta != 0 && in_range(s, n));
                add_at<true>(next, d, -1, delta != 0 && in_range(d, n));
            }
        }
        // a later round's word can only follow a round in which an edge
        // died, so `last >= r` reads the same in every thread; a warp that
        // sees it set adds no atomic of its own
        if (__any_sync(kFull, died) && lane == 0 &&
            *static_cast<volatile int32_t*>(a.last) < r)
            atomicMax(a.last, static_cast<int32_t>(r));
        grid.sync();
        if (*static_cast<volatile int32_t*>(a.last) < r) break;
    }
    if (tid == 0) *a.rounds = static_cast<int32_t>(r);
}

const void* kernel_for(int alive_bytes) {
    if (alive_bytes == 0 || alive_bytes == 1)
        return reinterpret_cast<const void*>(&kcore_fixpoint_kernel<uint8_t>);
    if (alive_bytes == 4)
        return reinterpret_cast<const void*>(&kcore_fixpoint_kernel<int32_t>);
    return nullptr;
}

}  // namespace

// Blocks of 1,024 threads that the launch takes for m edges and n
// vertices: one thread per edge or vertex, capped at what the card holds
// at once (co-resident blocks per SM x SMs, as a cooperative launch
// needs), at least 1. Returns a negative CUDA error on failure.
extern "C" int kcore_fixpoint_grid_blocks(int64_t m, int64_t n,
                                          int alive_bytes) {
    const void* fn = kernel_for(alive_bytes);
    if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
    int dev = 0, sms = 0, coop = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                            kThreads, 0);
    if (err == cudaSuccess && per_sm < 1)
        err = cudaErrorCooperativeLaunchTooLarge;
    if (err != cudaSuccess) return -static_cast<int>(err);
    const int64_t work = (m > n ? m : n) + kThreads - 1;
    int64_t blocks = work / kThreads;
    const int64_t cap = static_cast<int64_t>(per_sm) * sms;
    if (blocks > cap) blocks = cap;
    return static_cast<int>(blocks < 1 ? 1 : blocks);
}

// Plain C entry for ctypes. Device pointers of contiguous tensors: int32
// src[m], dst[m]; alive0[m] of `alive_bytes` bytes per element (1: bool,
// 4: int32) or null with alive_bytes 0 (every edge alive); uint8 (bool)
// out[m]; int32 rounds[1]; an int32 scratch of 2 n + 1 (the two degree
// buffers and the stop word). Launches once on `stream` without
// synchronising and returns the first CUDA error (0 when none); a refused
// cooperative launch returns its own error.
extern "C" int kcore_fixpoint_launch(const void* src, const void* dst,
                                     const void* alive0, int alive_bytes,
                                     void* out, void* rounds, void* scratch,
                                     int64_t m, int n, int64_t k,
                                     void* stream) {
    if ((alive0 == nullptr) != (alive_bytes == 0) || scratch == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    int32_t* deg = static_cast<int32_t*>(scratch);
    Args a{static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
           alive0, static_cast<uint8_t*>(out), deg,
           deg + 2 * static_cast<int64_t>(n),
           static_cast<int32_t*>(rounds), m, k, n};
    const int blocks = kcore_fixpoint_grid_blocks(m, n, alive_bytes);
    if (blocks < 0) return -blocks;
    void* params[] = {&a};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        kernel_for(alive_bytes), dim3(blocks), dim3(kThreads), params, 0,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
