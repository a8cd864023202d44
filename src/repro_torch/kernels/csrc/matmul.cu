// B5: f32[M, N] = A[M, K] @ B[K, N], hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `matmul` of src/repro/kernels/segment_matmul.py:52
// (Pallas body `_matmul_kernel`, :31): a tiled GEMM over a (M/bm, N/bn,
// K/bk) grid that accumulates in the revisited f32 output tile and pads
// every dimension to a multiple of 128. Here both operands keep the
// reference's row-major layouts (A is the activation, B the (d_in, d_out)
// weight read as it is, never transposed), the output is f32, and the
// ragged edges are masked by the kernel itself (out-of-range elements load
// as zeros and are never stored), so nothing is padded in memory.
//
// What bounds it on this card. In bf16, the port's prefill GEMMs (M = 4,096
// tokens against d_model 4,096, d_ff 13,696, vocab 151,552) do ~1,000 to
// ~2,700 operations per byte: above the H100's 295 FLOP/B ridge, so the
// tensor cores bound them (989 TFLOP/s). Decode has M = 16 rows: ~16
// operations per byte, so reading the weight once bounds it (3.35 TB/s).
//
// What the design does about that, and what it leaves for later:
// * bf16 x bf16 -> f32 on the tensor cores through WMMA (m16n16k16 tiles,
//   f32 accumulators), tiles staged in shared memory by cp.async in a
//   multi-stage ring so the next tiles load while this one multiplies.
//   WMMA issues Ampere-style mma.sync, not Hopper's wgmma/TMA: a simple
//   kernel that is right, far from the 989 TFLOP/s roof (PERF.md has its
//   share). The wgmma + TMA redesign is later work.
// * two tile shapes: 128 x 128 (8 warps, each 64 x 32) for many rows, and
//   16 x 128 (4 warps, each 16 x 32) for M <= 64, where the bytes of B are
//   the cost and every block streams its own column strip of the weight.
// * split-K when the output has too few tiles to fill the 132 SMs (decode's
//   wq/wo, every wk/wv): each split writes its f32 partial to a workspace,
//   and `splitk_reduce` sums the splits in a fixed order, so the result is
//   deterministic.
// * f32 inputs take a plain FMA kernel (64 x 64 tiles, 4 x 4 outputs per
//   thread) in full f32: no TF32, since the plain version is full f32. It is
//   not on the LM path, whose weights are bf16.
// * the vectorised path (16-byte cp.async, zero-filled past the edge) needs
//   K and N to be multiples of 8 and 16-byte aligned bases; any other shape
//   loads element by element with the same masking.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One (BM x BK) tile of A and one (BK x BN) tile of B into a ring stage.
// k_end is this split's end of K (a multiple of BK, or K itself).
template <int BM, int BN, int BK, int NTHREADS, bool VEC>
__device__ __forceinline__ void load_tiles(bf16* As, bf16* Bs,
                                           const bf16* __restrict__ A,
                                           const bf16* __restrict__ B, int M,
                                           int N, int K, int m0, int n0,
                                           int k0, int k_end) {
  constexpr int LDA = BK + 8, LDB = BN + 8;
  constexpr int A_CHUNKS = BM * BK / 8, B_CHUNKS = BK * BN / 8;
  for (int c = threadIdx.x; c < A_CHUNKS; c += NTHREADS) {
    int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
    int gm = m0 + r, gk = k0 + kc;
    bf16* dst = As + r * LDA + kc;
    if (VEC) {
      bool ok = gm < M && gk < k_end;
      cp_async16(dst, ok ? A + (size_t)gm * K + gk : A, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gm < M && gk + e < k_end) ? A[(size_t)gm * K + gk + e]
                                            : __float2bfloat16(0.f);
    }
  }
  for (int c = threadIdx.x; c < B_CHUNKS; c += NTHREADS) {
    int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    int gk = k0 + r, gn = n0 + nc;
    bf16* dst = Bs + r * LDB + nc;
    if (VEC) {
      bool ok = gk < k_end && gn < N;
      cp_async16(dst, ok ? B + (size_t)gk * N + gn : B, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gk < k_end && gn + e < N) ? B[(size_t)gk * N + gn + e]
                                            : __float2bfloat16(0.f);
    }
  }
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES>
struct GemmShape {
  static constexpr int WARPS = (BM / WM) * (BN / WN);
  static constexpr int THREADS = WARPS * 32;
  static constexpr int STAGE_ELEMS = BM * (BK + 8) + BK * (BN + 8);
  static constexpr int SMEM =
      STAGES * STAGE_ELEMS * (int)sizeof(bf16) + WARPS * 256 * (int)sizeof(float);
};

// C[z] (M x N, f32, row-major) = A[:, kz] @ B[kz, :] over split z's K range
// [z * k_split, min(K, (z + 1) * k_split)); C is the output itself when
// there is one split, else a (splits, M, N) workspace.
template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool VEC>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
    gemm_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B,
              float* __restrict__ C, int M, int N, int K, int k_split) {
  typedef GemmShape<BM, BN, BK, WM, WN, STAGES> S;
  constexpr int FM = WM / 16, FN = WN / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  float* scratch = reinterpret_cast<float*>(smem_raw + STAGES * S::STAGE_ELEMS * sizeof(bf16));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int n_k = (k_end - k_begin + BK - 1) / BK;
  C += (size_t)blockIdx.z * M * N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // prologue: the first STAGES - 1 tiles in flight
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) {
      bf16* As = ring + s * S::STAGE_ELEMS;
      load_tiles<BM, BN, BK, S::THREADS, VEC>(As, As + BM * (BK + 8), A, B, M,
                                               N, K, m0, n0, k_begin + s * BK,
                                               k_end);
    }
    cp_async_commit();
  }

  for (int t = 0; t < n_k; ++t) {
    cp_async_wait<STAGES - 2>();  // tile t has landed (this thread's part)
    __syncthreads();              // ... and every thread's; stage t-1 is free
    int nt = t + STAGES - 1;      // refill the stage that tile t-1 used
    if (nt < n_k) {
      bf16* As = ring + (nt % STAGES) * S::STAGE_ELEMS;
      load_tiles<BM, BN, BK, S::THREADS, VEC>(As, As + BM * (BK + 8), A, B, M,
                                               N, K, m0, n0, k_begin + nt * BK,
                                               k_end);
    }
    cp_async_commit();

    const bf16* As = ring + (t % STAGES) * S::STAGE_ELEMS;
    const bf16* Bs = As + BM * (BK + 8);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * WM + i * 16) * (BK + 8) + kk,
                               BK + 8);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * (BN + 8) + wn * WN + j * 16,
                               BN + 8);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: each 16 x 16 fragment through the warp's scratch, then
  // masked row-wise stores (lane l writes 8 floats of row l / 2)
  float* sc = scratch + warp * 256;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      int r = lane / 2, c0 = (lane % 2) * 8;
      int gm = m0 + wm * WM + i * 16 + r;
      int gn = n0 + wn * WN + j * 16 + c0;
      if (gm < M) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (gn + e < N) C[(size_t)gm * N + gn + e] = sc[r * 16 + c0 + e];
      }
      __syncwarp();
    }
}

// out[i] = sum over z of ws[z][i], in the order z = 0, 1, ...
__global__ void splitk_reduce(const float* __restrict__ ws,
                              float* __restrict__ out, long long n,
                              int splits) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[(size_t)z * n + i];
  out[i] = s;
}

// full-f32 FMA GEMM: 64 x 64 tile per block of 256 threads, 4 x 4 outputs
// per thread, K in steps of 16, every load masked
__global__ void __launch_bounds__(256)
    gemm_f32(const float* __restrict__ A, const float* __restrict__ B,
             float* __restrict__ C, int M, int N, int K) {
  __shared__ float As[16][64 + 4];  // As[k][m]
  __shared__ float Bs[16][64 + 4];  // Bs[k][n]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += 16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int idx = threadIdx.x + i * 256;
      int r = idx / 16, kk = idx % 16;
      int gm = m0 + r, gk = k0 + kk;
      As[kk][r] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
      int kb = idx / 64, c = idx % 64;
      int gkb = k0 + kb, gn = n0 + c;
      Bs[kb][c] = (gkb < K && gn < N) ? B[(size_t)gkb * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int gn = n0 + tx * 4 + j;
      if (gn < N) C[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool VEC>
static int launch_bf16(const bf16* A, const bf16* B, float* C, int M, int N,
                       int K, int k_split, int splits, cudaStream_t stream) {
  typedef GemmShape<BM, BN, BK, WM, WN, STAGES> S;
  auto kern = gemm_bf16<BM, BN, BK, WM, WN, STAGES, VEC>;
  static bool configured = false;  // above 48 KB only after opting in
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kern<<<grid, S::THREADS, S::SMEM, stream>>>(A, B, C, M, N, K, k_split);
  return (int)cudaGetLastError();
}

extern "C" {

// bf16 A (M x K) @ bf16 B (K x N) -> f32. skinny = 1 takes the 16 x 128
// tiles (K step 64), 0 the 128 x 128 tiles (K step 32): the wrapper
// chooses, and plans the split with the same tile sizes. `out` is C when
// splits == 1, else a (splits, M, N) f32 workspace that the wrapper then
// reduces with splitk_reduce_launch. k_split is a multiple of the K step.
int matmul_bf16_launch(const void* A, const void* B, void* out, int M, int N,
                       int K, int k_split, int splits, int skinny, int vec,
                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* a = static_cast<const bf16*>(A);
  const bf16* b = static_cast<const bf16*>(B);
  float* c = static_cast<float*>(out);
  if (skinny) {
    return vec ? launch_bf16<16, 128, 64, 16, 32, 4, true>(a, b, c, M, N, K, k_split, splits, stream)
               : launch_bf16<16, 128, 64, 16, 32, 4, false>(a, b, c, M, N, K, k_split, splits, stream);
  }
  return vec ? launch_bf16<128, 128, 32, 64, 32, 3, true>(a, b, c, M, N, K, k_split, splits, stream)
             : launch_bf16<128, 128, 32, 64, 32, 3, false>(a, b, c, M, N, K, k_split, splits, stream);
}

int splitk_reduce_launch(const void* ws, void* out, long long n, int splits,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  long long blocks = (n + 255) / 256;
  splitk_reduce<<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), n, splits);
  return (int)cudaGetLastError();
}

int matmul_f32_launch(const void* A, const void* B, void* out, int M, int N,
                      int K, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  dim3 grid((N + 63) / 64, (M + 63) / 64);
  gemm_f32<<<grid, 256, 0, stream>>>(static_cast<const float*>(A),
                                     static_cast<const float*>(B),
                                     static_cast<float*>(out), M, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
