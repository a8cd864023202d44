// B4 on Hopper: the segment sum, written by hand for sm_90a.
//
// Replaces the Pallas kernel `_segsum_kernel` behind `segment_sum`
// (src/repro/kernels/segment_matmul.py:104):
//     out[s, :] = sum over rows i with ids[i] == s of vals[i, :]     (f32)
// A row whose id lies outside [0, S) (the pad id -1, or an id >= S) adds
// nothing. Same function as the plain version
// `repro_torch.kernels.ref.segment_sum`, up to the order of the f32 sums.
//
// Design. The TPU builds a (bs, bm) one-hot tile of segment ids against a
// block of rows and contracts it with the rows on the MXU over an
// (E / bm, S / bs) grid: O(E * S * d) multiply-adds for O(E * d) useful adds,
// and no scatter. On the card it is a scatter-reduce. A block takes a tile of
// kRows consecutive rows and a chunk of blockDim.x columns, one thread per
// column; the grid's y dimension covers the columns past the first chunk.
// The tile's ids go to shared memory once. Each thread walks its column down
// the tile, keeps a running f32 sum while the id stays the same, and flushes
// it with one atomicAdd into `out` (zeroed by a memset first) when the id
// changes and at the tile's end. The GNN's sampled batches list edges grouped
// by destination (runs of 10-15) and give every padding edge id 0, so a tile
// costs one atomic per run and column, not one per element. Neighbouring
// threads load neighbouring floats of one row (coalesced); a row of 602
// floats is not 16-byte aligned, so the loads are scalar, kUnroll of them in
// flight per thread. Offsets are 64-bit: E * d passes 2^31 at
// ogb_products' scale (123.7M x 100).
//
// Float atomics commit in an order that changes from run to run, so the sums
// are not bitwise reproducible (the Pallas kernel's are).
//
// Bound: memory. vals read once (4 * E * d bytes), ids once (4 * E), out
// written once (4 * S * d): 1.22 GB, 0.365 ms at 3.35 TB/s, for GraphSAGE's
// layer-1 aggregation at minibatch_lg (E = 337,920, d = 602, S = 169,984).
// The E * d adds are far below the f32 peak.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;        // rows per tile
constexpr int kMaxThreads = 128;  // columns per block
constexpr int kUnroll = 8;        // loads in flight per thread

__global__ void __launch_bounds__(kMaxThreads)
segment_sum_kernel(const float* __restrict__ vals,
                   const int32_t* __restrict__ ids, float* __restrict__ out,
                   int64_t E, int64_t d, int32_t S) {
    __shared__ int32_t tile_ids[kRows];
    const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRows;
    const int rows = static_cast<int>(E - r0 < kRows ? E - r0 : kRows);
    for (int i = threadIdx.x; i < rows; i += blockDim.x)
        tile_ids[i] = ids[r0 + i];
    __syncthreads();
    const int64_t c = static_cast<int64_t>(blockIdx.y) * blockDim.x +
                      threadIdx.x;
    if (c >= d) return;
    const float* col = vals + r0 * d + c;
    int32_t cur = -1;
    float acc = 0.f;
    for (int i0 = 0; i0 < rows; i0 += kUnroll) {
        float x[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j)
            x[j] = i0 + j < rows ? __ldg(col + static_cast<int64_t>(i0 + j) * d)
                                 : 0.f;
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
            if (i0 + j < rows) {
                const int32_t id = tile_ids[i0 + j];
                if (id != cur) {
                    if (cur >= 0 && cur < S)
                        atomicAdd(out + static_cast<int64_t>(cur) * d + c, acc);
                    cur = id;
                    acc = 0.f;
                }
                acc += x[j];
            }
        }
    }
    if (cur >= 0 && cur < S)
        atomicAdd(out + static_cast<int64_t>(cur) * d + c, acc);
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers of contiguous
// tensors: f32 vals[E, d], int32 ids[E], f32 out[S, d]. `stream` is the
// caller's cudaStream_t. Zeroes out, then launches the kernel on that
// stream without synchronising; returns the first CUDA error (0 when none).
// The caller never passes E, d or S of 0 (no zero-sized grid or memset).
extern "C" int segment_sum_launch(const void* vals, const void* ids, void* out,
                                  int64_t E, int64_t d, int64_t S,
                                  void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(out, 0, static_cast<size_t>(S * d) * 4,
                                      st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int threads = d >= kMaxThreads ? kMaxThreads
                                         : static_cast<int>((d + 31) / 32 * 32);
    const dim3 grid(static_cast<unsigned int>((E + kRows - 1) / kRows),
                    static_cast<unsigned int>((d + threads - 1) / threads));
    segment_sum_kernel<<<grid, threads, 0, st>>>(
        static_cast<const float*>(vals), static_cast<const int32_t*>(ids),
        static_cast<float*>(out), E, d, static_cast<int32_t>(S));
    return static_cast<int>(cudaGetLastError());
}
