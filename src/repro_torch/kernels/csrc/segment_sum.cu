// B4 on Hopper: the segment sum, written by hand for sm_90a.
//
// Replaces the Pallas kernel `_segsum_kernel` behind `segment_sum`
// (src/repro/kernels/segment_matmul.py:104):
//     out[s, :] = sum over rows i with ids[i] == s of vals[i, :]     (f32)
// A row whose id lies outside [0, S) (the pad id -1, or an id >= S) adds
// nothing; a segment with no row is 0. Same function as the plain version
// `repro_torch.kernels.ref.segment_sum`, up to the order of the f32 sums.
//
// Design. The TPU builds a (bs, bm) one-hot tile of segment ids against a
// block of rows and contracts it with the rows on the MXU: O(E * S * d)
// multiply-adds for O(E * d) useful adds. On the card the sum is a sorted,
// load-balanced reduction with no float atomics, in one launch. The
// caller's plan (`segment_matmul.segment_plan`, built once per graph)
// holds `perm`, the stable argsort of the ids, the sorted ids `sid` and
// the offsets `off` (off[s] = the first sorted position of segment s;
// off[0] and off[S] bound the in-range ids: -1 sorts first, ids >= S last).
//
//  * Level 0 splits the sorted positions, not the segments, into chunks
//    of `tile` positions, so every chunk is the same work whatever the
//    degrees (meshgraphnet's ogb_products / 16 hub takes 2% of the rows, a
//    padded GraphSAGE batch gives node 0 most of them). A row of C
//    threads walks one chunk, each thread VEC columns (16-byte loads where
//    d % 4 == 0, 8-byte where d % 2 == 0, else 4-byte; column slices of C
//    * VEC on the grid past 32 lanes), so a row `vals[perm[p]]` is read
//    whole and coalesced, with a running f32 sum in registers, kUnroll
//    rows in flight and the next rows' ids and positions loaded meanwhile.
//    A run of one id that is a whole segment (the ids just outside the
//    chunk differ from it) is stored to `out` with a plain store. The
//    chunk's first and last runs may be parts of longer segments: they
//    become its two slots (head and tail: an id and a partial row).
//  * Level 1: a block holds F chunks; their slots go to shared memory and
//    one row of threads walks them the same way, against the ids just
//    outside the block's positions.
//  * Above, in steps: the block that finishes last among a group of a * F
//    level-1 blocks (integer arrival counters, after a fence that
//    publishes the slots; no block waits) walks the group's slots as two
//    levels, a blocks per row of threads, then the F rows' slots, through
//    L2 and shared memory; the others stop. The last step has one group,
//    where every run is whole. Which block comes last changes nothing:
//    every walk reads the same slots in the same order.
//  * Segments with no row (off[s] == off[s + 1]) are zeroed by the blocks,
//    each its share, so `out` is written once per element, no memset.
// The order of every add is fixed by (ids, vals, tile, fans), and the
// schedule by (E, d) alone (`segment_matmul.segment_tiles`): the output is
// bitwise reproducible, and equal bit for bit to the plain mirror
// `ref.segment_sum_tiled`, which repeats the walk level by level. Offsets
// into `vals` and `out` are 64-bit (E * d passes 2^31 at ogb_products'
// full scale); positions are int32, as the plan's.
//
// Bound: memory. vals read once (4 * E * d bytes), ids once (4 * E), out
// written once (4 * S * d): 1.214 ms at 3.35 TB/s for meshgraphnet's
// aggregation at ogb_products / 16 (E = 7,732,736, d = 128, S = 153,064).
// The kernel reads the plan's perm and sorted ids (8 * E bytes) in place
// of the ids, the offsets (4 * S) and the slots (two rows per chunk, most
// of them in shared memory) besides. The E * d adds are far below the f32
// peak.
//
// The gradient. With respect to vals the segment sum's gradient is a gather:
//     dvals[i, :] = dout[ids[i], :] where 0 <= ids[i] < S, else 0     (f32)
// (`segment_gather_kernel`). A block takes kGatherRows consecutive rows and
// a chunk of blockDim.x columns, one thread per column, so neighbouring
// threads read neighbouring floats of one dout row and write neighbouring
// floats of one output row. Every output element is written once, by one
// thread, with no atomics: the gather is bitwise reproducible. Bound:
// memory, the distinct dout rows read once, the ids, and E * d floats
// written (0.18 ms at 3.35 TB/s for GraphSAGE training at minibatch_lg:
// d = 128, E = 1,019,392 ids into 169,984 rows). A row is read once per
// id that names it; the 50 MB L2 keeps most repeats off device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 128;  // columns per block of the gather
constexpr int kBlock = 256;       // most threads in a block of the sum
constexpr int kMaxFan = 32;       // most chunks in a level-1 block
constexpr int kUnroll = 8;        // rows in flight per thread at level 0
constexpr int kSlotUnroll = 16;   // slots in flight per thread above
constexpr int kZeroSegs = 256;    // fewest segments a block zeroes
constexpr int kZeroRun = 8;       // segments a thread checks at once

template <int VEC>
struct alignas(4 * VEC) Vec {
    float f[VEC];
};

template <int VEC>
__device__ __forceinline__ Vec<VEC> vzero() {
    Vec<VEC> v;
#pragma unroll
    for (int i = 0; i < VEC; ++i) v.f[i] = 0.f;
    return v;
}

template <int VEC>
__device__ __forceinline__ void vadd(Vec<VEC>& a, const Vec<VEC>& b) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) a.f[i] += b.f[i];
}

__device__ __forceinline__ Vec<4> vload(const float* p, Vec<4>) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    return Vec<4>{{t.x, t.y, t.z, t.w}};
}
__device__ __forceinline__ Vec<2> vload(const float* p, Vec<2>) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    return Vec<2>{{t.x, t.y}};
}
__device__ __forceinline__ Vec<1> vload(const float* p, Vec<1>) {
    return Vec<1>{{__ldg(p)}};
}

// Loads through L2 only, for slots other blocks of this launch wrote.
__device__ __forceinline__ Vec<4> vload_l2(const float* p, Vec<4>) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    return Vec<4>{{t.x, t.y, t.z, t.w}};
}
__device__ __forceinline__ Vec<2> vload_l2(const float* p, Vec<2>) {
    const float2 t = __ldcg(reinterpret_cast<const float2*>(p));
    return Vec<2>{{t.x, t.y}};
}
__device__ __forceinline__ Vec<1> vload_l2(const float* p, Vec<1>) {
    return Vec<1>{{__ldcg(p)}};
}

template <int VEC>
__device__ __forceinline__ void vstore(float* p, const Vec<VEC>& v) {
    *reinterpret_cast<Vec<VEC>*>(p) = v;
}

// The sorted id at position p when it names a segment, else -1 (outside
// [0, E), or an id outside [0, S)): the ids just outside a chunk.
__device__ __forceinline__ int32_t key_at(const int32_t* __restrict__ sid,
                                          int64_t p, int64_t E, int32_t S) {
    if (p < 0 || p >= E) return -1;
    const int32_t k = __ldg(sid + p);
    return k >= 0 && k < S ? k : -1;
}

// A chunk's two slots: the id and partial row of its first run when that
// run began before the chunk (head), of its last run when it goes on after
// the chunk (tail); -1 for none.
template <int VEC>
struct Slots {
    int32_t hk, tk;
    Vec<VEC> hv, tv;
};

template <int VEC>
__device__ __forceinline__ Slots<VEC> no_slots() {
    return Slots<VEC>{-1, -1, vzero<VEC>(), vzero<VEC>()};
}

// One walker: a running sum over the items of one chunk, in order, for the
// columns [col, col + VEC). `lk` and `rk` are the ids just outside the
// chunk's positions; a run whose id differs from both is a whole segment.
template <int VEC>
struct Walk {
    float* out;
    int64_t d, col;
    bool active;
    int32_t lk, rk;
    int32_t cur;
    Vec<VEC> acc;
    Slots<VEC> slots;

    __device__ __forceinline__ void flush() {
        if (cur < 0) return;
        if (cur != lk && cur != rk) {
            if (active) vstore(out + static_cast<int64_t>(cur) * d + col, acc);
        } else if (cur == lk) {
            slots.hk = cur;
            slots.hv = acc;
            if (cur == rk) {       // one run through the chunk: no tail row
                slots.tk = cur;
                slots.tv = vzero<VEC>();
            }
        } else {
            slots.tk = cur;
            slots.tv = acc;
        }
    }

    // item with id k (-1: none) and row x
    __device__ __forceinline__ void step(int32_t k, const Vec<VEC>& x) {
        if (k != cur) {
            flush();
            cur = k;
            acc = vzero<VEC>();
        }
        if (k >= 0) vadd(acc, x);
    }
};

template <int VEC>
__device__ __forceinline__ Walk<VEC> walker(float* out, int64_t d,
                                            int64_t col, bool active,
                                            int32_t lk, int32_t rk) {
    return Walk<VEC>{out, d, col, active, lk, rk, -1, vzero<VEC>(),
                     no_slots<VEC>()};
}

// Store chunk j's slots for the level above: ids (once per chunk) and rows.
template <int VEC>
__device__ __forceinline__ void put_slots(const Slots<VEC>& s, int64_t j,
                                          float* __restrict__ cval,
                                          int32_t* __restrict__ ckey,
                                          int64_t d, int64_t col, bool active,
                                          bool ids) {
    if (ids) {
        ckey[2 * j] = s.hk;
        ckey[2 * j + 1] = s.tk;
    }
    if (!active) return;
    if (s.hk >= 0) vstore(cval + 2 * j * d + col, s.hv);
    if (s.tk >= 0) vstore(cval + (2 * j + 1) * d + col, s.tv);
}

// The schedule above level 1 (see segment_sum_launch): `steps` steps; step
// i takes groups of a[i] * F of the n[i] chunks below (n[0] = the level-1
// blocks), reads their slots at slot0[i] (in chunks: two slots each, laid
// out by slot_pos, whole groups) and leaves n[i + 1] chunks' slots at
// slot0[i + 1]; its arrival counters,
// one per slice, are one per a[i] chunks at cnt0[i] and one per group at
// cnt1[i]; n[steps] = 1.
constexpr int kMaxSteps = 16;

struct Levels {
    int64_t a[kMaxSteps], n[kMaxSteps + 1], slot0[kMaxSteps + 1],
        cnt0[kMaxSteps], cnt1[kMaxSteps];
    int64_t steps, span1, slices, zero_rows, blocks;
};

// Zero the segments with no row (off[s] == off[s + 1]) among [b * rows,
// (b + 1) * rows), columns [col, col + VEC): thread row y takes runs of
// kZeroRun segments, every F-th run; a run's offsets load together, then
// its stores go out.
template <int VEC>
__device__ __forceinline__ void zero_empty(const int32_t* __restrict__ off,
                                           float* __restrict__ out, int64_t d,
                                           int32_t S, int64_t col, bool active,
                                           int64_t b, int64_t rows, int row,
                                           int F) {
    if (!active) return;
    const int64_t z1 = (b + 1) * rows < S ? (b + 1) * rows : S;
    for (int64_t s0 = b * rows + row * kZeroRun; s0 < z1;
         s0 += static_cast<int64_t>(F) * kZeroRun) {
        int32_t o[kZeroRun + 1];
#pragma unroll
        for (int i = 0; i <= kZeroRun; ++i)
            o[i] = s0 + i <= z1 ? __ldg(off + s0 + i) : 0;
#pragma unroll
        for (int i = 0; i < kZeroRun; ++i)
            if (s0 + i < z1 && o[i] == o[i + 1])
                vstore(out + (s0 + i) * d + col, vzero<VEC>());
    }
}

// Release this thread's writes to the device (and acquire others'): the
// slots a block leaves for the level above.
__device__ __forceinline__ void fence_gpu() {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// Walk n slots of shared memory (n a multiple of 8), eight loads at a time.
template <int VEC>
__device__ __forceinline__ void walk_shared(Walk<VEC>& w,
                                            const int32_t* sh_key,
                                            const Vec<VEC>* sh_val, int n,
                                            int C, int lane) {
    for (int s = 0; s < n; s += 8) {
        int32_t k[8];
        Vec<VEC> x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            k[i] = sh_key[s + i];
            x[i] = sh_val[(s + i) * C + lane];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) w.step(k[i], x[i]);
    }
    w.flush();
}

// Where chunk j of a level read by a step of a * F chunks a group keeps
// its two slots: a row walks a consecutive chunks of its group, so the
// t-th chunk of every row lies side by side (position G * a * F + t * F +
// row), and the rows' loads of one step coalesce.
__device__ __forceinline__ int64_t slot_pos(int64_t j, int64_t a, int64_t F) {
    const int64_t g = a * F, G = j / g, r = j % g;
    return G * g + (r % a) * F + r / a;
}

// Walk `count` chunks' slots from the slot buffers, which other blocks of
// this launch wrote: chunk t's at positions base + t * stride, read
// through L2, kSlotUnroll / 2 chunks at a time. A slot's row is loaded
// whatever its id (every slot lies in the buffer) and added only under an
// id, so the id and row loads overlap.
template <int VEC>
__device__ __forceinline__ void walk_slots(Walk<VEC>& w,
                                           const float* __restrict__ slot_val,
                                           const int32_t* __restrict__ slot_key,
                                           int64_t base, int64_t count,
                                           int64_t stride, int64_t d,
                                           int64_t col, bool active) {
    constexpr int kChunks = kSlotUnroll / 2;
    for (int64_t t = 0; t < count; t += kChunks) {
        int32_t k[kSlotUnroll];
        Vec<VEC> x[kSlotUnroll];
#pragma unroll
        for (int i = 0; i < kSlotUnroll; ++i) {
            const bool in = t + i / 2 < count;
            const int64_t s = 2 * (base + (t + i / 2) * stride) + i % 2;
            k[i] = in ? __ldcg(slot_key + s) : -1;
            x[i] = in && active ? vload_l2(slot_val + s * d + col, Vec<VEC>{})
                                : vzero<VEC>();
        }
#pragma unroll
        for (int i = 0; i < kSlotUnroll; ++i) w.step(k[i], x[i]);
    }
}

// Every level in one launch. Block (C lanes, F rows), blockIdx.x = b *
// slices + slice: row y walks level-0 chunk b * F + y of `tile` sorted
// positions, lane x the columns of column vector slice * C + x; the
// chunks' slots go to shared memory and row 0 walks them (level 1). Then
// the block zeroes its share of the empty segments ([b * zero_rows, (b +
// 1) * zero_rows)); blocks past `blocks` do only that. Then the steps
// (see the note at the top of the file).
template <int VEC>
__global__ void __launch_bounds__(kBlock, VEC == 4 ? 2 : 3)
segsum(const float* __restrict__ vals, const int32_t* __restrict__ perm,
       const int32_t* __restrict__ sid, const int32_t* __restrict__ off,
       float* __restrict__ out, float* __restrict__ slot_val,
       int32_t* __restrict__ slot_key, int32_t* __restrict__ counters,
       int64_t E, int64_t d, int32_t S, int32_t tile, const Levels lv) {
    __shared__ int32_t sh_key[2 * kMaxFan];
    __shared__ Vec<VEC> sh_val[2 * kBlock];
    __shared__ int sh_last;
    const int C = blockDim.x, F = blockDim.y;
    const int lane = threadIdx.x, row = threadIdx.y;
    const int64_t b = blockIdx.x / lv.slices, slice = blockIdx.x % lv.slices;
    const int64_t v = slice * C + lane;
    const bool active = v < d / VEC;
    const int64_t col = v * VEC;
    if (b >= lv.blocks) {
        zero_empty<VEC>(off, out, d, S, col, active, b, lv.zero_rows, row, F);
        return;
    }

    // level 0
    const int64_t lo = __ldg(off), hi = __ldg(off + S);
    const int64_t q0 = (b * F + row) * tile;
    const int64_t q1 = q0 + tile < E ? q0 + tile : E;
    const int64_t a = q0 > lo ? q0 : lo, e = q1 < hi ? q1 : hi;
    Walk<VEC> w = walker<VEC>(out, d, col, active, key_at(sid, q0 - 1, E, S),
                              key_at(sid, q1, E, S));
    int32_t kn[kUnroll], rn[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
        const bool in = a + j < e;
        kn[j] = in ? __ldg(sid + a + j) : -1;
        rn[j] = in ? __ldg(perm + a + j) : 0;
    }
    for (int64_t p = a; p < e; p += kUnroll) {
        int32_t k[kUnroll];
        Vec<VEC> x[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
            k[j] = kn[j];
            x[j] = k[j] >= 0 && active
                       ? vload(vals + static_cast<int64_t>(rn[j]) * d + col,
                               Vec<VEC>{})
                       : vzero<VEC>();
        }
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
            const bool in = p + kUnroll + j < e;
            kn[j] = in ? __ldg(sid + p + kUnroll + j) : -1;
            rn[j] = in ? __ldg(perm + p + kUnroll + j) : 0;
        }
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) w.step(k[j], x[j]);
    }
    w.flush();
    if (lane == 0) {
        sh_key[2 * row] = w.slots.hk;
        sh_key[2 * row + 1] = w.slots.tk;
    }
    sh_val[2 * row * C + lane] = w.slots.hv;
    sh_val[(2 * row + 1) * C + lane] = w.slots.tv;
    __syncthreads();

    // level 1: the block's slots, in shared memory
    if (row == 0) {
        const int64_t Q0 = b * lv.span1;
        const int64_t Q1 = Q0 + lv.span1 < E ? Q0 + lv.span1 : E;
        Walk<VEC> up = walker<VEC>(out, d, col, active,
                                   key_at(sid, Q0 - 1, E, S),
                                   key_at(sid, Q1, E, S));
        walk_shared(up, sh_key, sh_val, 2 * F, C, lane);
        if (lv.steps > 0) {
            put_slots(up.slots, slot_pos(b, lv.a[0], F), slot_val, slot_key,
                      d, col, active, lane == 0);
            fence_gpu();
        }
    }
    zero_empty<VEC>(off, out, d, S, col, active, b, lv.zero_rows, row, F);

    // the steps above: the last block of each group of a * F chunks walks
    // them, row y the y-th a of them (level fan a), row 0 then the rows'
    // slots (level fan F)
    int64_t j = b, span = lv.span1;
    for (int st = 0; st < lv.steps; ++st) {
        const int64_t a = lv.a[st], g = a * F, nlow = lv.n[st];
        const int64_t G = j / g;
        __syncthreads();
        if (lane == 0 && row == 0) {
            // arrivals counted in two tiers (a chunks, then F of those),
            // so that no counter takes more than max(a, F) atomics
            const int64_t sub = j / a, nsub = (nlow + a - 1) / a;
            int32_t* c = counters + lv.cnt0[st] + sub * lv.slices + slice;
            const int64_t rest = nlow - sub * a;
            bool last = atomicAdd(c, 1) == (rest < a ? rest : a) - 1;
            if (last) {
                *c = 0;                // every arrival is in: ready for
                fence_gpu();           // the next launch on this stream
                c = counters + lv.cnt1[st] + G * lv.slices + slice;
                const int64_t rest2 = nsub - G * F;
                last = atomicAdd(c, 1) == (rest2 < F ? rest2 : F) - 1;
                if (last) *c = 0;
            }
            sh_last = last;
        }
        __syncthreads();
        if (!sh_last) return;
        fence_gpu();
        const int64_t c0 = G * g + row * a;
        const int64_t c1 = c0 + a < nlow ? c0 + a : nlow;
        const int64_t q0 = c0 * span;
        const int64_t q1 = q0 + a * span < E ? q0 + a * span : E;
        Walk<VEC> w = walker<VEC>(out, d, col, active,
                                  key_at(sid, q0 - 1, E, S),
                                  key_at(sid, q1, E, S));
        if (c0 < c1)
            walk_slots(w, slot_val, slot_key, lv.slot0[st] + G * g + row,
                       c1 - c0, F, d, col, active);
        w.flush();
        if (lane == 0) {
            sh_key[2 * row] = w.slots.hk;
            sh_key[2 * row + 1] = w.slots.tk;
        }
        sh_val[2 * row * C + lane] = w.slots.hv;
        sh_val[(2 * row + 1) * C + lane] = w.slots.tv;
        __syncthreads();
        if (row == 0) {
            const int64_t Q0 = G * g * span;
            const int64_t Q1 = Q0 + g * span < E ? Q0 + g * span : E;
            Walk<VEC> up = walker<VEC>(out, d, col, active,
                                       key_at(sid, Q0 - 1, E, S),
                                       key_at(sid, Q1, E, S));
            walk_shared(up, sh_key, sh_val, 2 * F, C, lane);
            if (st + 1 < lv.steps) {
                put_slots(up.slots,
                          lv.slot0[st + 1] + slot_pos(G, lv.a[st + 1], F),
                          slot_val, slot_key, d, col, active, lane == 0);
                fence_gpu();
            }
        }
        j = G;
        span *= g;
    }
}

constexpr int kGatherRows = 16;  // rows per block of the gather

__global__ void __launch_bounds__(kMaxThreads)
segment_gather_kernel(const float* __restrict__ dout,
                      const int32_t* __restrict__ ids,
                      float* __restrict__ out, int64_t E, int64_t d,
                      int32_t S) {
    const int64_t c = static_cast<int64_t>(blockIdx.y) * blockDim.x +
                      threadIdx.x;
    if (c >= d) return;
    const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kGatherRows;
#pragma unroll 4
    for (int i = 0; i < kGatherRows; ++i) {
        const int64_t e = r0 + i;
        if (e >= E) break;
        const int32_t id = __ldg(ids + e);
        out[e * d + c] = id >= 0 && id < S
                             ? __ldg(dout + static_cast<int64_t>(id) * d + c)
                             : 0.f;
    }
}

}  // namespace

// Plain C entry for ctypes: the gradient gather. f32 dout[S, d], int32
// ids[E], f32 out[E, d], contiguous device tensors; launches on `stream`
// without synchronising and returns the first CUDA error (0 when none).
// The caller never passes E or d of 0.
extern "C" int segment_gather_launch(const void* dout, const void* ids,
                                     void* out, int64_t E, int64_t d,
                                     int64_t S, void* stream) {
    const int threads = d >= kMaxThreads ? kMaxThreads
                                         : static_cast<int>((d + 31) / 32 * 32);
    const dim3 grid(
        static_cast<unsigned int>((E + kGatherRows - 1) / kGatherRows),
        static_cast<unsigned int>((d + threads - 1) / threads));
    segment_gather_kernel<<<grid, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dout), static_cast<const int32_t*>(ids),
        static_cast<float*>(out), E, d, static_cast<int32_t>(S));
    return static_cast<int>(cudaGetLastError());
}

// Plain C entry for ctypes: the sum. Device pointers of contiguous
// tensors: f32 vals[E, d]; the plan's int32 perm[E], sorted ids sid[E] and
// offsets off[S + 1]; f32 out[S, d]; the slot buffers f32 slot_val[slots,
// d] and int32 slot_key[slots] and the int32 arrival counters, as many as
// `segment_matmul._segment_slots` counts; the counters are zero on entry
// and left zero (the last arrival at each resets it), so one buffer
// serves every launch on one stream. `vec` (4, 2 or 1) floats per load,
// dividing d, every row `vec`-float aligned; `lanes` threads across a
// chunk's column vectors (ceil(d / vec / lanes) column slices); `tile`
// positions per level-0 chunk; fans = (F, a1, F, a2, F, ...): F chunks per
// level-1 block (a multiple of 4, at most 32, lanes * F <= 256), then
// steps of a * F chunks, the last leaving one. Launches one kernel on
// `stream` without synchronising; returns the first CUDA error (0 when
// none). The caller never passes E, d or S of 0.
extern "C" int segment_sum_launch(const void* vals, const void* perm,
                                  const void* sid, const void* off, void* out,
                                  void* slot_val, void* slot_key,
                                  void* counters, int64_t E, int64_t d,
                                  int64_t S, int64_t vec, int64_t lanes,
                                  int64_t tile, const int64_t* fans,
                                  int64_t nfans, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (lanes < 1 || lanes > 32 || fans[0] < 4 || fans[0] > kMaxFan ||
        fans[0] % 4 ||
        lanes * fans[0] > kBlock ||
        (vec != 4 && vec != 2 && vec != 1) || d % vec)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t F = fans[0];
    if (nfans % 2 == 0 || (nfans - 1) / 2 > kMaxSteps)
        return static_cast<int>(cudaErrorInvalidValue);
    Levels lv{};
    lv.steps = (nfans - 1) / 2;
    lv.slices = (d / vec + lanes - 1) / lanes;
    lv.span1 = tile * F;
    int64_t n = ((E + tile - 1) / tile + F - 1) / F, slot = 0, cnt = 0;
    lv.blocks = n;
    for (int64_t i = 0; i < lv.steps; ++i) {
        const int64_t a = fans[1 + 2 * i];
        if (a < 1 || fans[2 + 2 * i] != F)
            return static_cast<int>(cudaErrorInvalidValue);
        lv.a[i] = a;
        lv.n[i] = n;
        lv.slot0[i] = slot;
        slot += (n + a * F - 1) / (a * F) * (a * F);
        lv.cnt0[i] = cnt;
        cnt += (n + a - 1) / a * lv.slices;
        n = (n + a * F - 1) / (a * F);
        lv.cnt1[i] = cnt;
        cnt += n * lv.slices;
    }
    lv.n[lv.steps] = n;
    if (n != 1) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t zero_blocks = (S + kZeroSegs - 1) / kZeroSegs;
    const int64_t grid = lv.blocks > zero_blocks ? lv.blocks : zero_blocks;
    lv.zero_rows = (S + grid - 1) / grid;
    const dim3 blocks(static_cast<unsigned int>(grid * lv.slices));
    const dim3 threads(static_cast<unsigned int>(lanes),
                       static_cast<unsigned int>(fans[0]));
    float* sv = static_cast<float*>(slot_val);
    int32_t* sk = static_cast<int32_t*>(slot_key);
    int32_t* ct = static_cast<int32_t*>(counters);
    const float* x = static_cast<const float*>(vals);
    const int32_t* pm = static_cast<const int32_t*>(perm);
    const int32_t* sd = static_cast<const int32_t*>(sid);
    const int32_t* of = static_cast<const int32_t*>(off);
    float* o = static_cast<float*>(out);
    const int32_t s32 = static_cast<int32_t>(S), t32 = static_cast<int32_t>(tile);
    if (vec == 4)
        segsum<4><<<blocks, threads, 0, st>>>(x, pm, sd, of, o, sv, sk, ct, E,
                                              d, s32, t32, lv);
    else if (vec == 2)
        segsum<2><<<blocks, threads, 0, st>>>(x, pm, sd, of, o, sv, sk, ct, E,
                                              d, s32, t32, lv);
    else
        segsum<1><<<blocks, threads, 0, st>>>(x, pm, sd, of, o, sv, sk, ct, E,
                                              d, s32, t32, lv);
    return static_cast<int>(cudaGetLastError());
}
