// B3a and B3b on Hopper: one k-core peel round, written by hand for sm_90a.
//
// Replaces the Pallas kernels of src/repro/kernels/kcore_peel.py:
//   B3a `_degree_kernel` behind `degree_count` (:62)
//       deg[v] = sum over edges i of alive[i] * ([src[i] == v] + [dst[i] == v])
//   B3b `_threshold_kernel` behind `peel_round` (:117)
//       out[i] = alive[i] > 0 && deg[src[i]] >= k && deg[dst[i]] >= k
// Same functions as the plain versions `repro_torch.kernels.ref.degree_count`
// and `ref.peel_threshold`, bit for bit. `alive` is a weight: bool (one
// byte, 0 or 1) or int32. An endpoint outside [0, n) counts nothing in B3a
// and fails the threshold in B3b.
//
// Design. The TPU builds the degree histogram as a one-hot compare of every
// edge block with every vertex block (O(m * n) compares, no scatter). Here
// B3a gives one thread to each edge and adds its weight at both endpoints
// with integer atomics into a zeroed deg[n]: exact in any order, so
// deterministic. Edges are not grouped by endpoint, so same-address
// collisions inside a warp are rare and nothing aggregates them. B3b gives
// one thread to each edge: it reads the edge, gathers the two degrees
// (deg[n] is 7.6 KB at n = 1.9k, so the gathers hit L1/L2) and writes a
// one-byte mask. When an edge that was alive dies it stores 1 into the
// int32 `changed` flag (every writer stores the same value); the caller
// zeroes it before a round. The peel fixpoint no longer loops over these
// two kernels: kcore_fixpoint.cu runs every round in one launch.
//
// Bound: memory, both. B3a reads src and dst (8 B) and alive (1 or 4 B) per
// edge and writes 4 B per vertex; B3b reads 8 + (1 or 4) B per edge and
// 4 B per vertex of deg, and writes 1 B per edge. Over 3.35 TB/s that is
// well under a microsecond at m = 60k, so a launch costs its overhead.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename A>
__global__ void __launch_bounds__(kThreads)
degree_count_kernel(const int32_t* __restrict__ src,
                    const int32_t* __restrict__ dst,
                    const A* __restrict__ alive, int32_t* __restrict__ deg,
                    int64_t m, int32_t n) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= m) return;
    const int32_t a = static_cast<int32_t>(alive[i]);
    if (a == 0) return;
    const int32_t s = src[i];
    const int32_t d = dst[i];
    if (s >= 0 && s < n) atomicAdd(deg + s, a);
    if (d >= 0 && d < n) atomicAdd(deg + d, a);
}

template <typename A>
__global__ void __launch_bounds__(kThreads)
peel_threshold_kernel(const int32_t* __restrict__ src,
                      const int32_t* __restrict__ dst,
                      const A* __restrict__ alive,
                      const int32_t* __restrict__ deg,
                      uint8_t* __restrict__ out, int32_t* __restrict__ changed,
                      int64_t m, int32_t n, int32_t k) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= m) return;
    const bool was = static_cast<int32_t>(alive[i]) > 0;
    bool keep = false;
    if (was) {
        const int32_t s = src[i];
        const int32_t d = dst[i];
        keep = s >= 0 && s < n && d >= 0 && d < n && deg[s] >= k && deg[d] >= k;
    }
    out[i] = keep ? 1 : 0;
    if (keep != was) *changed = 1;
}

unsigned int blocks_for(int64_t m) {
    return static_cast<unsigned int>((m + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entries for ctypes. Pointers are device pointers of contiguous
// tensors: int32 src[m], dst[m], deg[n]; alive[m] of `alive_bytes` bytes
// per element (1: bool, 4: int32); uint8 (bool) out[m]; int32 changed[1].
// `stream` is the caller's cudaStream_t. Each launches on that stream
// without synchronising and returns the first CUDA error (0 when none).
// The caller never passes m == 0 or n == 0 (no zero-sized grid).

// B3a: zeroes deg, then adds every alive edge at both endpoints.
extern "C" int degree_count_launch(const void* src, const void* dst,
                                   const void* alive, int alive_bytes,
                                   void* deg, int64_t m, int64_t n,
                                   void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(deg, 0, static_cast<size_t>(n) * 4, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto* s = static_cast<const int32_t*>(src);
    const auto* d = static_cast<const int32_t*>(dst);
    auto* out = static_cast<int32_t*>(deg);
    const int32_t nn = static_cast<int32_t>(n);
    if (alive_bytes == 1) {
        degree_count_kernel<uint8_t><<<blocks_for(m), kThreads, 0, st>>>(
            s, d, static_cast<const uint8_t*>(alive), out, m, nn);
    } else if (alive_bytes == 4) {
        degree_count_kernel<int32_t><<<blocks_for(m), kThreads, 0, st>>>(
            s, d, static_cast<const int32_t*>(alive), out, m, nn);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// B3b: the new alive mask; raises `changed` where an alive edge dies.
extern "C" int peel_threshold_launch(const void* src, const void* dst,
                                     const void* alive, int alive_bytes,
                                     const void* deg, void* out, void* changed,
                                     int64_t m, int64_t n, int64_t k,
                                     void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* s = static_cast<const int32_t*>(src);
    const auto* d = static_cast<const int32_t*>(dst);
    const auto* dg = static_cast<const int32_t*>(deg);
    auto* o = static_cast<uint8_t*>(out);
    auto* c = static_cast<int32_t*>(changed);
    const int32_t nn = static_cast<int32_t>(n);
    const int32_t kk = static_cast<int32_t>(k);
    if (alive_bytes == 1) {
        peel_threshold_kernel<uint8_t><<<blocks_for(m), kThreads, 0, st>>>(
            s, d, static_cast<const uint8_t*>(alive), dg, o, c, m, nn, kk);
    } else if (alive_bytes == 4) {
        peel_threshold_kernel<int32_t><<<blocks_for(m), kThreads, 0, st>>>(
            s, d, static_cast<const int32_t*>(alive), dg, o, c, m, nn, kk);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
