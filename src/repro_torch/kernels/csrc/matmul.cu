// B5: f32[M, N] = A[M, K] @ B[K, N], hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `matmul` of src/repro/kernels/segment_matmul.py:52
// (Pallas body `_matmul_kernel`, :31): a tiled GEMM over a (M/bm, N/bn,
// K/bk) grid that accumulates in the revisited f32 output tile and pads
// every dimension to a multiple of 128. Here both operands keep the
// reference's row-major layouts (A is the activation, B the (d_in, d_out)
// weight read as it is, never transposed), the output is f32, and the
// ragged edges are handled by the kernel (loads past the edge read zeros,
// stores past it are skipped), so nothing is padded in memory.
//
// What bounds it on this card, and what each route does about it (the
// wrapper's `plan` picks the route from the dtype and shape):
//
// * "wgmma", bf16 with M > 64 (every prefill projection and the head):
//   ~1,000 to ~2,700 operations per byte, above the H100's 295 FLOP/B
//   ridge, so the tensor cores bound it (989 TFLOP/s). Only wgmma reaches
//   that rate, and only if the operands arrive without the threads' help:
//   one producer warp keeps TMA loads of 128 x 64 A tiles and 64 x 256 B
//   tiles (four 64-column boxes, 128-byte swizzle) in a 4-stage ring of
//   mbarriers; two consumer warpgroups each run m64n256k16 wgmmas on 64
//   rows of the 128 x 256 output tile, issuing a stage's product before
//   retiring the previous one. The weight is read MN-major (wgmma's
//   transpose flag), so it is never copied. setmaxnreg moves registers
//   from the producer to the consumers' 128-float accumulators. The grid
//   is persistent (one block per SM) and walks the tiles in groups of 16
//   row tiles, so a column strip of the weight is read from device memory
//   once per group and served from L2 to the rest.
// * "skinny", bf16 with M <= 64 (decode): ~16 operations per byte, so
//   reading the weight once bounds it (3.35 TB/s). The same producer and
//   ring, 8 stages deep (128 KB of weight in flight per SM), and the
//   product swapped: C^T = B^T A^T, each consumer warpgroup taking one
//   64-column block of a 128-column weight tile as wgmma's 64-row side
//   (MN-major) and the 16 or 64 token rows as its N (m64n16k16 at M <= 16).
// * split-K on both when the output has too few tiles for the 132 SMs
//   (prefill wk/wv, decode wq/wk/wv/wo): each split writes an f32 partial
//   to a workspace and `splitk_reduce` sums the splits in a fixed order,
//   so the result is deterministic (no float atomics).
// * "masked", bf16 operands TMA cannot take (K or N not a multiple of 8,
//   or a base not 16-byte aligned): a WMMA kernel with element-wise masked
//   loads. No glm4 or codeqwen shape takes it.
// * "f32", f32 operands (GraphSAGE's projections, in full f32: no TF32,
//   since the plain version is full f32): 67 TFLOP/s of FMA bounds the
//   wide layers. 64 x 128 tiles of 128 threads (128 x 48 of 96 for a
//   narrow N, as the 41-class head), 384 threads an SM, 8 x 8 outputs per
//   thread read as four float4s from shared memory per K step, A staged
//   transposed, a double-buffered cp.async ring. A's rows need not be
//   16-byte aligned (K = 602 rows are 2,408 bytes), so A moves in 4-byte
//   copies; B in 16-byte copies where N allows. When the output has fewer
//   tiles than the card has SMs and K is long (the weight gradients, a^T
//   @ dc over every row: MIND's S at 64 x 3,276,800 @ 3,276,800 x 64),
//   K is split over the grid's z as on the TMA routes: split z's blocks
//   walk K range [z * k_split, (z + 1) * k_split) into its own f32
//   partial, and splitk_reduce adds the partials in the order z = 0, 1,
//   ... (deterministic, no float atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "sm90.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

// ---- the TMA + wgmma routes -------------------------------------------------

// A K tile is 64 bf16: one 128-byte swizzle row. B moves in boxes of 64
// columns x 64 K rows (8 KB).
constexpr int TMA_BK = 64;
constexpr int BOX_BYTES = 64 * TMA_BK * 2;
constexpr int GROUP_M = 16;  // row tiles walked together (L2 reuse of B)
constexpr int TMA_THREADS = 384;  // consumer warpgroups 0, 1; producer 2

// BM x BN output tile (BM rows of A, BN columns of B). SWAP: BM is the
// token count (16 or 64) and each consumer warpgroup owns 64 of the BN =
// 128 columns, as the M side of C^T's product; otherwise each owns 64 of
// the BM = 128 rows across all BN = 256 columns.
template <int BM, int BN, bool SWAP, int STAGES>
struct TmaCfg {
  static constexpr int A_BYTES = BM * TMA_BK * 2;
  static constexpr int B_BYTES = (BN / 64) * BOX_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + alignment
  static constexpr int ACC = SWAP ? BM / 2 : BN / 2;  // floats per thread
  static_assert(SWAP ? (BN == 128 && (BM == 16 || BM == 64))
                     : (BM == 128 && BN == 256), "tile");
};

// work unit u -> (row tile, column tile, split), tiles in groups of
// GROUP_M row tiles, the splits of a tile side by side
__device__ __forceinline__ void unit_coords(int u, int tiles_m, int tiles_n,
                                            int splits, int& tm, int& tn,
                                            int& z) {
  z = u % splits;
  int t = u / splits;
  int span = GROUP_M * tiles_n;
  int first = (t / span) * GROUP_M;
  int rows = min(tiles_m - first, GROUP_M);
  int r = t % span;
  tm = first + r % rows;
  tn = r / rows;
}

template <int ACC>
__device__ __forceinline__ void wgmma_tile(float (&acc)[ACC], uint64_t da,
                                           uint64_t db);
template <>
__device__ __forceinline__ void wgmma_tile<128>(float (&acc)[128],
                                                uint64_t da, uint64_t db) {
  sm90::wgmma_m64n256<0, 1>(acc, da, db, 1);
}
template <>
__device__ __forceinline__ void wgmma_tile<8>(float (&acc)[8], uint64_t da,
                                              uint64_t db) {
  sm90::wgmma_m64n16<1, 0>(acc, da, db, 1);
}
template <>
__device__ __forceinline__ void wgmma_tile<32>(float (&acc)[32], uint64_t da,
                                               uint64_t db) {
  sm90::wgmma_m64n64<1, 0>(acc, da, db, 1);
}

// C[z] (M x N f32) = A[:, kz] @ B[kz, :] over split z's K range
// [z * k_split, min(K, (z + 1) * k_split)), for every work unit of this
// block; C is the output itself when splits == 1, else a (splits, M, N)
// workspace. tma_a: A as (K, M) boxes of (64, BM); tma_b: B as (N, K)
// boxes of (64, 64).
template <int BM, int BN, bool SWAP, int STAGES>
__global__ void __launch_bounds__(TMA_THREADS, 1)
    gemm_tma(const __grid_constant__ CUtensorMap tma_a,
             const __grid_constant__ CUtensorMap tma_b,
             float* __restrict__ C, int M, int N, int K, int k_split,
             int splits) {
  typedef TmaCfg<BM, BN, SWAP, STAGES> S;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // B stages first (8 KB boxes), then A stages: every tile 1 KB aligned
  uint8_t* base = smem_raw + ((1024 - sm90::smem_addr(smem_raw) % 1024) % 1024);
  uint8_t* b_ring = base;
  uint8_t* a_ring = base + STAGES * S::B_BYTES;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int units = tiles_m * tiles_n * splits;

  if (wg == 2) {  // producer: one thread keeps the ring full
    sm90::regs_dealloc<40>();
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int tm, tn, z;
        unit_coords(u, tiles_m, tiles_n, splits, tm, tn, z);
        int k0 = z * k_split, k1 = min(K, k0 + k_split);
        for (int k = k0; k < k1; k += TMA_BK) {
          sm90::mbar_wait(&empty[stage], phase ^ 1);
          sm90::mbar_expect_tx(&full[stage], S::STAGE_BYTES);
          sm90::tma_load_2d(a_ring + stage * S::A_BYTES, &tma_a, &full[stage],
                            k, tm * BM);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            sm90::tma_load_2d(b_ring + stage * S::B_BYTES + j * BOX_BYTES,
                              &tma_b, &full[stage], tn * BN + j * 64, k);
          if (++stage == STAGES) stage = 0, phase ^= 1;
        }
      }
    }
  } else {  // consumers: warpgroups 0 and 1
    sm90::regs_alloc<232>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    float acc[S::ACC];
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int tm, tn, z;
      unit_coords(u, tiles_m, tiles_n, splits, tm, tn, z);
      int k0 = z * k_split, k1 = min(K, k0 + k_split);
#pragma unroll
      for (int i = 0; i < S::ACC; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int k = k0; k < k1; k += TMA_BK) {
        sm90::mbar_wait(&full[stage], phase);
        const uint8_t* a = a_ring + stage * S::A_BYTES;
        const uint8_t* b = b_ring + stage * S::B_BYTES;
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TMA_BK / 16; ++kk) {
          if constexpr (SWAP)  // weight block of this warpgroup x tokens
            wgmma_tile<S::ACC>(
                acc, sm90::desc_mnmajor(b + wg * BOX_BYTES + kk * 2048,
                                        BOX_BYTES),
                sm90::desc_kmajor(a + kk * 32));
          else  // this warpgroup's 64 rows x the 256 columns
            wgmma_tile<S::ACC>(
                acc, sm90::desc_kmajor(a + wg * 64 * 128 + kk * 32),
                sm90::desc_mnmajor(b + kk * 2048, BOX_BYTES));
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the previous stage's product is done
        sm90::fence_regs(acc);
        if (prev >= 0 && lane == 0) sm90::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (lane == 0) sm90::mbar_arrive(&empty[prev]);

      // epilogue: registers straight to C, masked at the ragged edge
      float* out = C + (size_t)z * M * N;
      const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
      if constexpr (SWAP) {  // acc row = weight column, acc column = token
#pragma unroll
        for (int i = 0; i < S::ACC; ++i) {
          int gn = tn * BN + wg * 64 + r0 + 8 * ((i / 2) % 2);
          int gm = tm * BM + 8 * (i / 4) + c0 + i % 2;
          if (gm < M && gn < N) out[(size_t)gm * N + gn] = acc[i];
        }
      } else {  // N % 8 == 0 on this route: a column pair is in or out
#pragma unroll
        for (int i = 0; i < S::ACC; i += 2) {
          int gm = tm * BM + wg * 64 + r0 + 8 * ((i / 2) % 2);
          int gn = tn * BN + 8 * (i / 4) + c0;
          if (gm < M && gn < N)
            *reinterpret_cast<float2*>(out + (size_t)gm * N + gn) =
                make_float2(acc[i], acc[i + 1]);
        }
      }
    }
  }
}

template <int BM, int BN, bool SWAP, int STAGES>
static int launch_tma(const void* A, const void* B, float* C, int M, int N,
                      int K, int k_split, int splits, int grid,
                      const long long* map_a, const long long* map_b,
                      cudaStream_t stream) {
  typedef TmaCfg<BM, BN, SWAP, STAGES> S;
  // the wrapper's tensor-map arithmetic must match this tile
  if (map_a[3] != TMA_BK || map_a[4] != BM || map_b[3] != 64 ||
      map_b[4] != TMA_BK)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int err = sm90::bf16_map_2d(&ta, A, map_a[0], map_a[1], map_a[2], map_a[3],
                              map_a[4]);
  if (err) return err;
  err = sm90::bf16_map_2d(&tb, B, map_b[0], map_b[1], map_b[2], map_b[3],
                          map_b[4]);
  if (err) return err;
  auto kern = gemm_tma<BM, BN, SWAP, STAGES>;
  static sm90::OptIn opted;  // above 48 KB only after opting in, per device
  err = sm90::smem_opt_in(kern, S::SMEM, false, opted);
  if (err) return err;
  kern<<<grid, TMA_THREADS, S::SMEM, stream>>>(ta, tb, C, M, N, K, k_split,
                                               splits);
  return (int)cudaGetLastError();
}

// One m64n128k16 wgmma from TMA-loaded tiles: A (64 x 16, K-major) and B
// (16 x 128, N-contiguous, read MN-major), the descriptors and swizzle of
// the routes above on a single tile.
__global__ void __launch_bounds__(128)
    wgmma_probe(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_b, float* C) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  uint8_t* base = smem_raw + ((1024 - sm90::smem_addr(smem_raw) % 1024) % 1024);
  uint8_t *b = base, *a = base + 2 * BOX_BYTES;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(&bar, 3 * BOX_BYTES);
    sm90::tma_load_2d(a, &tma_a, &bar, 0, 0);
    sm90::tma_load_2d(b, &tma_b, &bar, 0, 0);
    sm90::tma_load_2d(b + BOX_BYTES, &tma_b, &bar, 64, 0);
  }
  sm90::mbar_wait(&bar, 0);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  sm90::fence_regs(acc);
  sm90::wgmma_fence();
  sm90::wgmma_m64n128<0, 1>(acc, sm90::desc_kmajor(a),
                            sm90::desc_mnmajor(b, BOX_BYTES), 1);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 64; ++i)
    C[(16 * warp + lane / 4 + 8 * ((i / 2) % 2)) * 128 + 8 * (i / 4) +
      2 * (lane % 4) + i % 2] = acc[i];
}

// ---- the masked route (operands TMA cannot take) ----------------------------

// One (BM x BK) tile of A and one (BK x BN) tile of B into a ring stage,
// element by element, zeros past the edge. k_end is this split's end of K.
template <int BM, int BN, int BK, int NTHREADS>
__device__ __forceinline__ void load_tiles(bf16* As, bf16* Bs,
                                           const bf16* __restrict__ A,
                                           const bf16* __restrict__ B, int M,
                                           int N, int K, long long m0, int n0,
                                           int k0, int k_end) {
  constexpr int LDA = BK + 8, LDB = BN + 8;
  constexpr int A_CHUNKS = BM * BK / 8, B_CHUNKS = BK * BN / 8;
  for (int c = threadIdx.x; c < A_CHUNKS; c += NTHREADS) {
    int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
    long long gm = m0 + r;
    int gk = k0 + kc;
    bf16* dst = As + r * LDA + kc;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = (gm < M && gk + e < k_end) ? A[(size_t)gm * K + gk + e]
                                          : __float2bfloat16(0.f);
  }
  for (int c = threadIdx.x; c < B_CHUNKS; c += NTHREADS) {
    int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    int gk = k0 + r, gn = n0 + nc;
    bf16* dst = Bs + r * LDB + nc;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = (gk < k_end && gn + e < N) ? B[(size_t)gk * N + gn + e]
                                          : __float2bfloat16(0.f);
  }
}

// 128 x 128 tiles, 8 warps of 64 x 32 (WMMA m16n16k16), K steps of 32
constexpr int MK_BM = 128, MK_BN = 128, MK_BK = 32, MK_WM = 64, MK_WN = 32;
constexpr int MK_THREADS = (MK_BM / MK_WM) * (MK_BN / MK_WN) * 32;
constexpr int MK_TILE = MK_BM * (MK_BK + 8) + MK_BK * (MK_BN + 8);
constexpr int MK_SMEM = MK_TILE * 2 + (MK_THREADS / 32) * 256 * 4;  // 27 KB

// C[z] (M x N, f32, row-major) = A[:, kz] @ B[kz, :] over split z's K range,
// as in gemm_tma
__global__ void __launch_bounds__(MK_THREADS)
    gemm_bf16_masked(const bf16* __restrict__ A, const bf16* __restrict__ B,
                     float* __restrict__ C, int M, int N, int K,
                     int k_split) {
  constexpr int FM = MK_WM / 16, FN = MK_WN / 16;
  extern __shared__ __align__(128) unsigned char smem_mk[];
  bf16* As = reinterpret_cast<bf16*>(smem_mk);
  bf16* Bs = As + MK_BM * (MK_BK + 8);
  float* scratch = reinterpret_cast<float*>(smem_mk + MK_TILE * 2);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (MK_BN / MK_WN), wn = warp % (MK_BN / MK_WN);
  // row tiles on the grid's x (up to 2^31 - 1 of them), column tiles on y
  const long long m0 = (long long)blockIdx.x * MK_BM;
  const int n0 = blockIdx.y * MK_BN;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);
  C += (size_t)blockIdx.z * M * N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = k_begin; k0 < k_end; k0 += MK_BK) {
    load_tiles<MK_BM, MK_BN, MK_BK, MK_THREADS>(As, Bs, A, B, M, N, K, m0,
                                                n0, k0, k_end);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < MK_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(
            fa[i], As + (wm * MK_WM + i * 16) * (MK_BK + 8) + kk, MK_BK + 8);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(
            fb[j], Bs + kk * (MK_BN + 8) + wn * MK_WN + j * 16, MK_BN + 8);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

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
      long long gm = m0 + wm * MK_WM + i * 16 + r;
      int gn = n0 + wn * MK_WN + j * 16 + c0;
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

// ---- the f32 route ----------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   sm90::smem_addr(smem)), "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_addr(smem)), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int F_BK = 16;  // K step of the f32 tiles
constexpr int F_PAD = 4;  // shared rows padded by 16 bytes

// full-f32 FMA GEMM: a BM x BN tile per block of (BM / 8) x (BN / 8)
// threads, 384 threads per SM (at most 168 registers a thread), each owning
// rows {4ty + i, BM/2 + 4ty + i} and columns {4tx + j, BN/2 + 4tx + j}
// (i, j < 4), so that the float4 reads of a quarter warp cover 128
// contiguous bytes. K moves in tiles of 16 through two shared buffers: A
// transposed (As[k][m]), B as it is (Bs[k][n]). B_VEC: N % 4 == 0 and B
// 16-byte aligned, so B moves in 16-byte chunks; A always in 4 bytes.
// blockIdx.z is the K split: its blocks take K range [z * k_split, z *
// k_split + k_len) and write C[z] (M x N); one split (k_split >= K) writes
// C itself.
template <int BM, int BN, bool B_VEC>
__global__ void __launch_bounds__((BM / 8) * (BN / 8), 384 / (BM / 8 * BN / 8))
    gemm_f32(const float* __restrict__ A, const float* __restrict__ B,
             float* __restrict__ C, int M, int N, int K, int k_split) {
  constexpr int THREADS = (BM / 8) * (BN / 8), TX = BN / 8;
  constexpr int A_ELEMS = F_BK * (BM + F_PAD), B_ELEMS = F_BK * (BN + F_PAD);
  // each thread's copies: A column a_kk of rows a_r0 + i * A_STEP; B
  // columns b_c .. b_c + B_W - 1 of K rows b_k0 + i * B_STEP
  constexpr int A_STEP = THREADS / F_BK;
  constexpr int A_N = (BM * F_BK + THREADS - 1) / THREADS;
  constexpr int B_W = B_VEC ? 4 : 1, B_CH = BN / B_W;
  constexpr int B_STEP = THREADS / B_CH, B_N = F_BK * B_CH / THREADS;
  static_assert(THREADS % 32 == 0 && 384 % THREADS == 0, "whole warps");
  static_assert(THREADS % F_BK == 0 && THREADS % B_CH == 0 &&
                F_BK * B_CH % THREADS == 0, "copies tile the stage");
  static_assert(A_N <= 32, "row mask");
  __shared__ __align__(16) float As[2][A_ELEMS];
  __shared__ __align__(16) float Bs[2][B_ELEMS];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  // row tiles on the grid's x (up to 2^31 - 1 of them), column tiles on y
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  // this split's K range: A's columns and B's rows from kb, k_len of them
  const long long kb = (long long)blockIdx.z * k_split;
  const int k_len = (int)min((long long)k_split, K - kb);
  A += kb;
  B += kb * N;
  C += (size_t)blockIdx.z * M * N;
  const int n_k = (k_len + F_BK - 1) / F_BK;

  // load coordinates, fixed over the K loop
  const int a_kk = threadIdx.x % F_BK, a_r0 = threadIdx.x / F_BK;
  const int b_c = (threadIdx.x % B_CH) * B_W, b_k0 = threadIdx.x / B_CH;
  const float* a_src = A + (size_t)(m0 + a_r0) * K + a_kk;
  const float* b_src = B + (size_t)b_k0 * N + n0 + b_c;
  const bool b_col = n0 + b_c < N;  // with N % 4 == 0, the whole chunk
  unsigned a_rows = 0;              // bit i: row a_r0 + i * A_STEP is real
#pragma unroll
  for (int i = 0; i < A_N; ++i)
    if (a_r0 + i * A_STEP < BM && m0 + a_r0 + i * A_STEP < M) a_rows |= 1u << i;

  auto load = [&](int buf, int k0) {
    const bool a_k = k0 + a_kk < k_len;
#pragma unroll
    for (int i = 0; i < A_N; ++i) {
      // the last copy of a thread may fall past the tile (THREADS = 96)
      if ((i + 1) * THREADS <= BM * F_BK || a_r0 + i * A_STEP < BM) {
        bool ok = a_k && (a_rows >> i & 1);
        cp_async4(As[buf] + a_kk * (BM + F_PAD) + a_r0 + i * A_STEP,
                  ok ? a_src + k0 + (size_t)i * A_STEP * K : A, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < B_N; ++i) {
      int kr = b_k0 + i * B_STEP;
      bool ok = b_col && k0 + kr < k_len;
      const float* src = ok ? b_src + (size_t)(k0 + i * B_STEP) * N : B;
      float* dst = Bs[buf] + kr * (BN + F_PAD) + b_c;
      if constexpr (B_VEC)
        cp_async16(dst, src, ok ? 16 : 0);
      else
        cp_async4(dst, src, ok);
    }
  };

  float acc[8][8] = {};
  load(0, 0);
  cp_async_commit();
  for (int t = 0; t < n_k; ++t) {
    if (t + 1 < n_k) {  // the next tile loads while this one multiplies
      load((t + 1) % 2, (t + 1) * F_BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* as = As[t % 2];
    const float* bs = Bs[t % 2];
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(a) =
          *reinterpret_cast<const float4*>(as + kk * (BM + F_PAD) + 4 * ty);
      *reinterpret_cast<float4*>(a + 4) = *reinterpret_cast<const float4*>(
          as + kk * (BM + F_PAD) + BM / 2 + 4 * ty);
      *reinterpret_cast<float4*>(b) =
          *reinterpret_cast<const float4*>(bs + kk * (BN + F_PAD) + 4 * tx);
      *reinterpret_cast<float4*>(b + 4) = *reinterpret_cast<const float4*>(
          bs + kk * (BN + F_PAD) + BN / 2 + 4 * tx);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // this stage is refilled next iteration
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    long long gm = m0 + (i / 4) * (BM / 2) + 4 * ty + i % 4;
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int gn = n0 + h * (BN / 2) + 4 * tx;
      float* dst = C + (size_t)gm * N + gn;
      if (B_VEC && gn < N) {  // N % 4 == 0: 16-byte aligned, whole
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
      } else if (!B_VEC) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) dst[j] = acc[i][4 * h + j];
      }
    }
  }
}

template <int BM, int BN, bool B_VEC>
static int launch_f32(const float* A, const float* B, float* C, int M, int N,
                      int K, int k_split, int splits, cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  gemm_f32<BM, BN, B_VEC><<<grid, (BM / 8) * (BN / 8), 0, stream>>>(
      A, B, C, M, N, K, k_split);
  return (int)cudaGetLastError();
}

extern "C" {

// bf16 A (M x K) @ bf16 B (K x N) -> f32 through TMA and wgmma. tok = 0:
// the wide route (128 x 256 tiles); tok = 16 or 64: the skinny route (that
// many token rows x 128 columns per tile). `out` is C when splits == 1,
// else a (splits, M, N) f32 workspace that the wrapper then reduces with
// splitk_reduce_launch; k_split is a multiple of 64. map_a and map_b are
// the wrapper's tensor-map layouts {inner dim, outer dim, row bytes, box
// inner, box outer}: A as (K, M), B as (N, K). `grid` blocks walk the
// tiles x splits work units.
int matmul_tma_launch(const void* A, const void* B, void* out, int M, int N,
                      int K, int k_split, int splits, int tok, int grid,
                      const long long* map_a, const long long* map_b,
                      void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  float* c = static_cast<float*>(out);
  switch (tok) {
    case 0:
      return launch_tma<128, 256, false, 4>(A, B, c, M, N, K, k_split, splits,
                                            grid, map_a, map_b, s);
    case 16:
      return launch_tma<16, 128, true, 8>(A, B, c, M, N, K, k_split, splits,
                                          grid, map_a, map_b, s);
    case 64:
      return launch_tma<64, 128, true, 8>(A, B, c, M, N, K, k_split, splits,
                                          grid, map_a, map_b, s);
  }
  return (int)cudaErrorInvalidValue;
}

// bf16 A (M x K) @ bf16 B (K x N) -> f32 with element-wise masked loads
// (any K, N and alignment); `out` as for matmul_tma_launch, k_split a
// multiple of 32
int matmul_masked_launch(const void* A, const void* B, void* out, int M,
                         int N, int K, int k_split, int splits,
                         void* stream_ptr) {
  dim3 grid((M + MK_BM - 1) / MK_BM, (N + MK_BN - 1) / MK_BN, splits);
  gemm_bf16_masked<<<grid, MK_THREADS, MK_SMEM,
                     static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(B),
      static_cast<float*>(out), M, N, K, k_split);
  return (int)cudaGetLastError();
}

int splitk_reduce_launch(const void* ws, void* out, long long n, int splits,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  long long blocks = (n + 255) / 256;
  splitk_reduce<<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), n, splits);
  return (int)cudaGetLastError();
}

// f32 A (M x K) @ f32 B (K x N) -> f32 in full f32. bn: the tile's width,
// 128 (64 x 128 tiles, 128 threads) or 48 (128 x 48 tiles, 96 threads,
// which the wrapper takes for N <= 48); b_vec: N % 4 == 0 and B 16-byte
// aligned. `out` is C when splits == 1, else a (splits, M, N) f32
// workspace that the wrapper then reduces with splitk_reduce_launch;
// k_split is a multiple of 16 and (splits - 1) * k_split < K.
int matmul_f32_launch(const void* A, const void* B, void* out, int M, int N,
                      int K, int k_split, int splits, int bn, int b_vec,
                      void* stream_ptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  float* c = static_cast<float*>(out);
  if (splits < 1 || splits > 65535 || k_split < 1 ||
      (long long)(splits - 1) * k_split >= K)
    return (int)cudaErrorInvalidValue;
  if (bn == 128)
    return b_vec ? launch_f32<64, 128, true>(a, b, c, M, N, K, k_split,
                                             splits, s)
                 : launch_f32<64, 128, false>(a, b, c, M, N, K, k_split,
                                              splits, s);
  if (bn == 48)
    return b_vec ? launch_f32<128, 48, true>(a, b, c, M, N, K, k_split,
                                             splits, s)
                 : launch_f32<128, 48, false>(a, b, c, M, N, K, k_split,
                                              splits, s);
  return (int)cudaErrorInvalidValue;
}

// the single-tile check: A (64 x 16 bf16), B (16 x 128 bf16), C (64 x 128
// f32), all contiguous and 16-byte aligned
int wgmma_probe_launch(const void* A, const void* B, void* C,
                       void* stream_ptr) {
  CUtensorMap ta, tb;
  int err = sm90::bf16_map_2d(&ta, A, 16, 64, 32, 64, 64);
  if (err) return err;
  err = sm90::bf16_map_2d(&tb, B, 128, 16, 256, 64, 64);
  if (err) return err;
  const int smem = 3 * BOX_BYTES + 1024;
  wgmma_probe<<<1, 128, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      ta, tb, static_cast<float*>(C));
  return (int)cudaGetLastError();
}

}  // extern "C"
