// B1 on Hopper: one masked min-label propagation round of the batched TCCS
// query plane, written by hand for sm_90a.
//
// Replaces the Pallas kernel `_label_prop_kernel` behind
// `label_prop_round` (src/repro/kernels/label_prop.py:70). Same function
// as the plain version `repro_torch.kernels.ref.label_prop_round`, bit for
// bit, for every (b, x) of the (B, N) query-by-forest-node matrix:
//
//   nb(link) = labels_in[b, link]  if link >= 0, active[b, x] and
//                                   active[b, link]        (link clipped)
//            = N                   otherwise
//   new      = min(labels_in[b, x], nb(l), nb(r), nb(p))
//   out      = min(new, labels_in[b, new])   if new < N   (pointer jump)
//
// Both gathers read the PRE-round row: the kernel reads one buffer and
// writes another, never in place, so a single round equals the plain one.
// N is the "no label" sentinel and N-1 the clip bound; the grid covers
// exactly B*N elements and masks its ragged edge, so nothing is padded.
//
// Design. The Pallas kernel keeps two full rows in VMEM; a row of the
// served index is N*4 bytes (2 MB at N = 505k), far beyond an SM's 227 KB
// of shared memory. So one thread takes one (b, x): its own label, three
// links and its active flag are contiguous, coalesced reads; the neighbour
// and jump gathers stay inside row b, and the blocks resident at any time
// cover a few rows, so those gathers hit the 50 MB L2. Links stay int32
// and `active` stays one byte (no widening to int64 as torch.gather
// needs). An inactive (b, x) gathers no neighbour, so its thread does not
// load its three links at all: a warp whose 8-element sectors hold no
// active pair fetches none of their link bytes.
//
// Bound: memory. Every element reads 4 (label) + 1 (active) bytes and
// writes 4; only an active one needs its 12 link bytes. So a round moves
// 9 * B * N + 12 * (active pairs) bytes over 3.35 TB/s, at most 21 * B * N
// (0.8 ms at B = 256, N = 505k), if the gathers hit L2.
//
// Change flag: a thread whose output differs from its input stores 1 into
// `changed` (all writers store the same value); the host fixpoint loop
// zeroes it before the round and reads it after.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int32_t clip(int32_t v, int32_t hi) {
    return v < 0 ? 0 : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
label_prop_round_kernel(const int32_t* __restrict__ labels,
                        const int32_t* __restrict__ link_l,
                        const int32_t* __restrict__ link_r,
                        const int32_t* __restrict__ link_p,
                        const uint8_t* __restrict__ active,
                        int32_t* __restrict__ out,
                        int32_t* __restrict__ changed,
                        int64_t total, int32_t N) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= total) return;
    const int64_t row = i - i % N;          // first element of row b
    const int32_t cur = labels[i];
    const bool act = active[i] != 0;

    int32_t best = min(cur, N);             // every neighbour offers >= N
    if (act) {                              // else all of them offer N
        const int32_t links[3] = {link_l[i], link_r[i], link_p[i]};
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const int32_t link = links[j];
            if (link >= 0) {
                const int64_t at = row + clip(link, N - 1);
                if (active[at]) best = min(best, labels[at]);
            }
        }
    }
    if (best < N) best = min(best, labels[row + clip(best, N - 1)]);
    out[i] = best;
    if (best != cur) *changed = 1;
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers of contiguous
// (B, N) tensors (int32 labels/links/out, uint8 active) and an int32[1]
// flag; `stream` is the caller's cudaStream_t. Launches on that
// stream without synchronising and returns cudaGetLastError().
extern "C" int label_prop_round_launch(const void* labels, const void* link_l,
                                       const void* link_r, const void* link_p,
                                       const void* active, void* out,
                                       void* changed, int64_t B, int64_t N,
                                       void* stream) {
    const int64_t total = B * N;
    if (total == 0) return 0;
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    label_prop_round_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(labels),
        static_cast<const int32_t*>(link_l),
        static_cast<const int32_t*>(link_r),
        static_cast<const int32_t*>(link_p),
        static_cast<const uint8_t*>(active),
        static_cast<int32_t*>(out), static_cast<int32_t*>(changed),
        total, static_cast<int32_t>(N));
    return static_cast<int>(cudaGetLastError());
}
