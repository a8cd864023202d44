// B2 on Hopper: the segmented count of the device construction sweep,
// written by hand for sm_90a.
//
// Replaces the Pallas kernel `_count_le_kernel` behind `segmented_count_le`
// (src/repro/kernels/segmented_select.py:117). Same function as the plain
// version `repro_torch.kernels.ref.segmented_count_le`, bit for bit:
//
//   out[v] = |{ i : seg[i] == v  and  w[i] <= thr[v] }|,   v in [0, n)
//
// `seg` need not be sorted; a slot whose id lies outside [0, n) (the pad
// id -1, or an id >= n) counts nothing.
//
// Design. The TPU kernel compares every slot block with every segment
// block (a one-hot tile, O(E * n) compares) because the TPU has no
// scatter. Here one thread takes one slot, gathers its segment's
// threshold and adds its hit into a zeroed out[n] with an integer
// atomicAdd: integer sums are exact in any order, so the output is
// bit-identical to the plain version on every run.
//
// In the sweep the slots are a CSR (seg non-decreasing), so the 32 lanes
// of a warp mostly share one or two segments, and a hub's 1,809 slots
// would put 32 same-address atomics in every warp. So a warp aggregates
// first: `__match_any_sync` groups the lanes by segment, a ballot counts
// each group's hits, and one lane per group adds the sum. A block-level
// shared-memory histogram was not chosen: at the sweep's shape (E = 35k
// slots, n = 1.9k segments) each of the ~137 blocks would zero and flush
// all n bins, about 7 times the slots' own work, where warp aggregation
// costs nothing extra for unsorted ids and cuts sorted ids' atomics to
// about one per segment run in a warp.
//
// Bound: memory. Each slot's w and seg are read once (8 B), each segment's
// threshold read and count written once (8 B): 8 * E + 8 * n bytes over
// 3.35 TB/s, about 0.1 us at the sweep's shape, so a launch there costs
// its launch overhead, not its bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segmented_count_le_kernel(const int32_t* __restrict__ w,
                          const int32_t* __restrict__ seg,
                          const int32_t* __restrict__ thr,
                          int32_t* __restrict__ out, int64_t E, int32_t n) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    // No early return: every lane joins the warp's match and ballot. Lanes
    // past E and out-of-range ids form the group of id -1, which adds
    // nothing.
    int32_t s = -1;
    bool hit = false;
    if (i < E) {
        s = seg[i];
        if (s >= 0 && s < n) {
            hit = w[i] <= thr[s];
        } else {
            s = -1;
        }
    }
    const unsigned peers = __match_any_sync(0xffffffffu, s);
    const unsigned hits = __ballot_sync(0xffffffffu, hit) & peers;
    const int lane = threadIdx.x & 31;
    if (s >= 0 && hits != 0u && lane == __ffs(peers) - 1) {
        atomicAdd(out + s, static_cast<int32_t>(__popc(hits)));
    }
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers of contiguous
// int32 tensors: w[E], seg[E], thr[n], out[n]; `stream` is the caller's
// cudaStream_t. Zeroes `out` and launches on that stream without
// synchronising; returns the first CUDA error (0 when none). The caller
// never passes E == 0 or n == 0 (it returns zeros without a launch).
extern "C" int segmented_count_le_launch(const void* w, const void* seg,
                                         const void* thr, void* out,
                                         int64_t E, int64_t n, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(n) * 4, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t blocks = (E + kThreads - 1) / kThreads;
    segmented_count_le_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                                st>>>(
        static_cast<const int32_t*>(w), static_cast<const int32_t*>(seg),
        static_cast<const int32_t*>(thr), static_cast<int32_t*>(out), E,
        static_cast<int32_t>(n));
    return static_cast<int>(cudaGetLastError());
}
