// B2 redesigned for Hopper: the k-stratified core-time sweep over one t_uv
// block of start times, as one kernel launch, written by hand for sm_90a.
//
// Replaces the device loop of the reference's `_sweep_jax`
// (src/repro/core/core_time.py:346: one jitted lax.scan over a block of
// start times, a while_loop of probes and cond-gated climbs inside) and the
// Pallas counter it drives, `_count_le_kernel` behind `segmented_count_le`
// (src/repro/kernels/segmented_select.py:117) with its counting bisection
// `kth_smallest_pallas` (:153). Same function as the plain version
// `repro_torch.kernels.ref.stratum_sweep`, bit for bit, counts included:
//
//   for stratum i (k = ks[i]), starting from c = carry[i], for each row r
//   of the block (start time ts0 + r) in order, repeat
//     w_j  = max(tuv[r, j], c[dst[j]])                   (every slot j)
//     cnt_v = |{ j in [vptr[v], vptr[v+1]) : w_j <= c_v }|   (the probe)
//     stop when every v has cnt_v >= k or c_v >= inf
//     else c_v <- min(max(c_v, kth_k(w over v's slots)), inf) for every v,
//          all from the pre-climb c (Jacobi); kth = inf when deg v < k
//   then rows[i, r] = c; c carries to the next row and out through carry.
//   stats[i] = (probes, climbs).
//
// Facts the design relies on (tests/test_torch_segmented_select.py holds
// the plain version to each):
// * Only failing vertices need a climb. A vertex that passes the probe has
//   cnt_v >= k, so kth_k <= c_v and its update is the identity (c_v >= inf
//   means c_v == inf, also fixed). A failing vertex has kth_k > c_v: it
//   rises by at least 1, to kth_k exactly (or to inf when deg v < k), which
//   is the least x in [c_v + 1, inf] with count(w <= x) >= k.
// * So the loop is bounded: every climb raises some c_v by >= 1 and no c_v
//   passes inf, so a (k, ts) fixpoint takes at most n * inf + 1 probes. The
//   kernel traps past that bound (as sm90.cuh's bounded mbarrier waits do)
//   and never hangs; the bisection halves [c_v + 1, inf] and ends.
// * Strata run independently. Each starts every ts from its own carry, not
//   from max(carry, c_{k-1}(ts)) as the host's fused sweep does; both are
//   lower bounds of the least fixpoint, so the rows are the same and only
//   the counts differ.
//
// Design. The TPU runs the scan on one core, one segmented count per probe
// and per bisection step. Here the host leaves the loop: one block per
// stratum (37 blocks at the CollegeMsg scale, so 95 of the 132 SMs idle)
// walks the whole block of start times. c is double-buffered: every warp
// reads `cur` and writes `nxt`, one __syncthreads_or per probe both
// publishes `nxt` and tells every thread whether any vertex failed, so all
// threads take the same branch, and the buffers swap. The buffers live in
// shared memory when 8 * n bytes fit a block's 227 KB (n up to 29,056:
// route "shared"), else in a global scratch (route "global"). One warp
// takes one vertex at a time: each lane takes slots lane, lane + 32, ...,
// keeps the first REG_SLOTS * 32 of them in registers, and __reduce_add_sync
// counts. A failing vertex's warp finds its kth by a counting bisection on
// those registers (a hub's slots past them are recomputed from L1/L2 on
// each step), fused into the same pass as the probe, so a probe that fails
// has already computed the climb. Rows go straight from the buffer into
// the caller's (|K|, t_max + 1, n) tensor.
//
// Bound: memory. The t_uv block is read once (4 * R * E bytes), the rows
// written once (4 * |K| * R * n), dst, vptr, ks and carry moved once:
// about 81 MB, ~24 us at 3.35 TB/s at the CollegeMsg scale. The loop is
// latency-bound: its serial chain is the longest stratum's probes, each a
// pass over the slots and a block-wide barrier.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int REG_SLOTS = 4;  // registers per lane: segments of <= 128 slots
constexpr unsigned kFull = 0xffffffffu;

struct Args {
    const int32_t* tuv;   // (R, E): row r = earliest pair time >= ts0 + r
    const int32_t* vptr;  // (n + 1): pair CSR over sources
    const int32_t* dst;   // (E)
    const int32_t* ks;    // (K)
    int32_t* carry;       // (K, n), in and out
    int32_t* rows;        // rows + i * rows_kstride + r * n + v
    int64_t* stats;       // (K, 2): probes, climbs
    int32_t* scratch;     // (K, 2, n) on the global route, else null
    int64_t E;
    int64_t rows_kstride;
    int32_t n, R, inf;
};

__device__ __forceinline__ int32_t slot_w(const int32_t* __restrict__ tuv,
                                          const int32_t* __restrict__ dst,
                                          const int32_t* c, int32_t j) {
    return max(__ldg(tuv + j), c[__ldg(dst + j)]);
}

template <bool SHARED>
__global__ void __launch_bounds__(kThreads) stratum_sweep_kernel(Args a) {
    extern __shared__ int32_t smem[];
    const int i = blockIdx.x;
    const int32_t n = a.n, inf = a.inf, k = a.ks[i];
    int32_t* cur = SHARED ? smem : a.scratch + static_cast<size_t>(i) * 2 * n;
    int32_t* nxt = cur + n;
    int32_t* carry = a.carry + static_cast<size_t>(i) * n;
    for (int v = threadIdx.x; v < n; v += kThreads) cur[v] = carry[v];
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long bound = static_cast<long long>(n) * inf + 1;
    long long probes = 0, climbs = 0;
    for (int r = 0; r < a.R; ++r) {
        const int32_t* tuv = a.tuv + static_cast<size_t>(r) * a.E;
        for (long long it = 1;; ++it) {
            if (it > bound) __trap();  // a (k, ts) fixpoint never needs more
            int failed = 0;
            for (int v = warp; v < n; v += kWarps) {
                const int32_t cv = cur[v];
                const int32_t lo = __ldg(a.vptr + v), hi = __ldg(a.vptr + v + 1);
                int32_t wr[REG_SLOTS];
                int cnt = 0;
#pragma unroll
                for (int s = 0; s < REG_SLOTS; ++s) {
                    const int32_t j = lo + s * 32 + lane;
                    wr[s] = j < hi ? slot_w(tuv, a.dst, cur, j) : INT_MAX;
                    cnt += wr[s] <= cv;
                }
                for (int32_t j = lo + REG_SLOTS * 32 + lane; j < hi; j += 32)
                    cnt += slot_w(tuv, a.dst, cur, j) <= cv;
                cnt = __reduce_add_sync(kFull, cnt);
                int32_t nv = cv;
                // warp-uniform: cv and cnt are the same in every lane
                if (cnt < k && cv < inf) {
                    failed = 1;
                    if (hi - lo < k) {
                        nv = inf;
                    } else {  // least x in [cv + 1, inf] with count >= k
                        int32_t blo = cv + 1, bhi = inf;
                        while (blo < bhi) {
                            const int32_t mid = blo + ((bhi - blo) >> 1);
                            int c2 = 0;
#pragma unroll
                            for (int s = 0; s < REG_SLOTS; ++s)
                                c2 += wr[s] <= mid;
                            for (int32_t j = lo + REG_SLOTS * 32 + lane; j < hi;
                                 j += 32)
                                c2 += slot_w(tuv, a.dst, cur, j) <= mid;
                            c2 = __reduce_add_sync(kFull, c2);
                            if (c2 >= k) bhi = mid; else blo = mid + 1;
                        }
                        nv = blo;
                    }
                }
                if (lane == 0) nxt[v] = nv;
            }
            ++probes;
            // publishes nxt; every thread gets the same answer
            if (!__syncthreads_or(failed)) break;
            ++climbs;
            int32_t* t = cur;
            cur = nxt;
            nxt = t;
        }
        int32_t* out = a.rows + static_cast<size_t>(i) * a.rows_kstride
                       + static_cast<size_t>(r) * n;
        for (int v = threadIdx.x; v < n; v += kThreads) out[v] = cur[v];
    }
    for (int v = threadIdx.x; v < n; v += kThreads) carry[v] = cur[v];
    if (threadIdx.x == 0) {
        a.stats[2 * i] = probes;
        a.stats[2 * i + 1] = climbs;
    }
}

}  // namespace

// Plain C entry for ctypes. Device pointers of contiguous int32 tensors:
// tuv (R, E), vptr (n + 1), dst (E), ks (K), carry (K, n); rows with row
// stride n and stratum stride rows_kstride; int64 stats (K, 2); scratch
// (K, 2, n) int32 for the global route, or null for the shared route.
// Launches K blocks on `stream` without synchronising; returns the first
// CUDA error (0 when none). The caller never passes K, R or n == 0.
extern "C" int stratum_sweep_launch(const void* tuv, const void* vptr,
                                    const void* dst, const void* ks,
                                    void* carry, void* rows, void* stats,
                                    void* scratch, int64_t E,
                                    int64_t rows_kstride, int n, int R, int K,
                                    int inf, void* stream) {
    Args a{static_cast<const int32_t*>(tuv), static_cast<const int32_t*>(vptr),
           static_cast<const int32_t*>(dst), static_cast<const int32_t*>(ks),
           static_cast<int32_t*>(carry), static_cast<int32_t*>(rows),
           static_cast<int64_t*>(stats), static_cast<int32_t*>(scratch), E,
           rows_kstride, n, R, inf};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (scratch != nullptr) {
        stratum_sweep_kernel<false><<<K, kThreads, 0, st>>>(a);
        return static_cast<int>(cudaGetLastError());
    }
    const int smem = 8 * n;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            stratum_sweep_kernel<true>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    stratum_sweep_kernel<true><<<K, kThreads, smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
}
