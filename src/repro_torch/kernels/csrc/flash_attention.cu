// B6: blockwise online-softmax attention (FlashAttention-style), hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py:96 (Pallas body `_flash_kernel`, :35):
// a (B*H, q blocks, kv blocks) grid whose kv axis runs in order on one core,
// carrying the running max m, sum l and accumulator acc from one kv step to
// the next in revisited outputs. Its semantics are kept: scale 1/sqrt(dh);
// the causal mask qpos >= kpos aligned at position 0 (also when S != T);
// kv tiles wholly above the diagonal skipped, the diagonal tile masked; keys
// at kpos >= t_real masked and never read; l floored at 1e-30; output in
// q's dtype. Here t_real is a run-time argument (the decode mask arange(T)
// <= cache_len). m, l and acc stay in registers; given a non-null `lse`
// pointer, every route also writes each row's log-sum-exp (B, H, S) f32,
// natural log, for the backward (csrc/flash_attention_bwd.cu), and only
// then: serving passes null.
//
// Layout: q (B, S, H, dh), k and v (B, T, Hkv, dh), o (B, S, H, dh), all
// contiguous, of one dtype. Query head h reads kv head h / G, G = H / Hkv,
// from k and v directly: the GQA expansion is never built. Rows of a block
// are (position, head) pairs of one kv head: row r of (b, kv head hk) is
// position r / G of query head hk * G + r % G. A block so reads each k/v
// tile once for all G heads that share it, and under the causal mask a
// tile of M rows covers M / G positions, so only the diagonal k/v tile of
// a block is masked.
//
// What bounds it on this card. Causal prefill at S = T = 4,096 (glm4: H =
// 32, dh = 128) does 4 * S^2 / 2 * H * dh ~ 137 GFLOP per layer against
// ~100 MB of q, k, v and o: the tensor cores bound it (989 TFLOP/s), and
// only wgmma reaches that rate. Decode (S = 1) does 4 * T * H * dh per
// sequence against 2 * T * Hkv * dh * 2 bytes of cache: 8 FLOP/B for
// glm4's G = 16, far below the 295 FLOP/B ridge, so reading the cache once
// bounds it (3.35 TB/s).
//
// Routes (the wrapper's `plan` picks one from the dtype and shape):
// * "wgmma": bf16 or f16, dh = 64 or 128, more than 16 rows per (b, kv
//   head) and G dividing 128 (the LM's prefill). Warp-specialised: one
//   producer warp keeps TMA loads of 128-key K and V tiles in a 2-stage
//   ring (separate mbarriers for K and V, so QK^T starts before V lands);
//   two consumer warpgroups take 64 of the block's 128 rows each. The Q
//   tile (128 rows: 128 / G positions x G heads) is one TMA box of a 4-D
//   tensor map (dh, H, S, B), K and V boxes of (dh, Hkv, t_real, B), all
//   128-byte swizzled: keys at or past t_real and positions past S load as
//   zeros without a read. S = Q K^T is wgmma m64n128k16 with both operands
//   K-major in shared memory; the online softmax runs in f32 registers in
//   the log2 domain; P is rounded to q's dtype in registers and is wgmma's
//   A operand for O += P V (V read MN-major through the transpose flag):
//   the S accumulator's layout is the A fragment's, so there is no
//   shuffle. Blocks go heaviest first (the q tiles with the most k/v
//   tiles), so the causal tail overlaps. setmaxnreg moves registers from
//   the producer to the consumers. A consumer runs a tile's S, softmax
//   and P V in turn; the two consumers overlap each other's softmax with
//   their products. The softmax takes the max over raw scores and each p
//   as one FMA and one ex2.approx. (Overlapping a tile's softmax with the
//   previous tile's P V inside a warpgroup keeps S, O and P live at once,
//   more than the 168 registers a thread of this 384-thread block
//   compiles to: it spilled and ran slower, as did ordering the two
//   warpgroups' products with named barriers; PERF.md.)
// * "mma": the same dtypes, more than 16 rows, any dh that is a multiple of
//   8 up to 128 (dh = 16 for the smoke LMs; a G that does not divide 128).
//   Four warps of 16 rows each, mma.sync m16n8k16, 64-key k/v tiles
//   staged by cp.async in a 3-stage ring, K fragments by ldmatrix and V
//   fragments by ldmatrix.trans. dh is padded to DHP (16, 32, 64 or 128)
//   with zeros in shared memory and registers: zero columns add nothing to
//   QK^T and PV drops them.
// * "split": the same kernel for at most 16 rows per (b, kv head)
//   (decode): the 16 heads of a glm4 kv group fill one 16-row tile, so a
//   cache tile is read once per group; the 4 warps split the output
//   columns (each computes the tile's scores and softmax for the 16 rows
//   and P V for its quarter of dh), so every row walks its keys as on the
//   mma route: a decode over keys that one block takes equals the causal
//   prefill's row of the same position bit for bit. The key range is
//   split over blocks when there are too few (flash-decoding): each split
//   writes its unnormalised (acc, m, l) to an f32 workspace and
//   `flash_combine` merges the splits in a fixed order.
// * "f32": f32 q, k, v in plain f32 FMAs (never rounded to a narrower
//   type): 16 rows per block of 8 warps, 32-key k/v tiles in shared
//   memory, one key per lane for the scores and dh / 32 columns per lane
//   for PV.
// * "wide": any dtype at dh > 128, the f32 route's kernel looped over
//   128-column chunks: the scores sum over every chunk of q and k, and
//   each block writes one chunk of output columns (grid z). bf16 and f16
//   are read and converted to f32; only the output is rounded.
// The wrapper zero-pads a dh that is not a multiple of 8 and passes the
// true width for the scale 1 / sqrt(dh).
// On the tensor-core routes P is rounded to q's dtype before the PV
// product and the row sum l adds the unrounded f32 p (the Pallas kernel and
// the plain version multiply p by v in f32: the card check's tolerance
// covers this rounding).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;
typedef __half f16;

namespace {

// ---- element types ----------------------------------------------------------

template <typename T>
struct Elem;
template <>
struct Elem<bf16> {
  static constexpr bool F16 = false;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // two floats as a pair: lo in the low half (the lower column or row)
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ bf16 from(float x) {
    return __float2bfloat16(x);
  }
};
template <>
struct Elem<f16> {
  static constexpr bool F16 = true;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ f16 from(float x) {
    return __float2half_rn(x);
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_addr(smem)), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d (16 x 8, f32) += a (16 x 16, row) @ b (16 x 8, col), T operands
template <typename T>
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  if constexpr (Elem<T>::F16)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 matrices of 16-bit elements; lanes 8i .. 8i + 7 give the row
// addresses of matrix i. Without .trans lane (g, c) receives row g,
// columns 2c, 2c + 1 of each; with .trans rows 2c, 2c + 1 of column g.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_addr(p)));
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x in one instruction (max relative error 2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the row log-sum-exp (natural log) from the running max m (log2 domain)
// and sum l; +inf for a row that attended no key (l = 0: the output floors
// l at 1e-30 and the backward's P = exp(s - lse) is then 0)
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * 0.6931471805599453f : INFINITY;
}

// ---- the mma and split routes (mma.sync) -----------------------------------

constexpr int BKV = 64;      // keys per k/v tile
constexpr int MMA_THREADS = 128;
constexpr int MMA_STAGES = 3;

template <int DHP>
struct MmaCfg {
  static constexpr int KSTR = DHP + 8;  // shared row stride (elements)
  static constexpr int OSTR = DHP + 8;  // merge scratch row stride (f32)
  static constexpr int STAGE_ELEMS = 2 * BKV * KSTR;  // k and v of a tile
  static constexpr int SMEM = MMA_STAGES * STAGE_ELEMS * 2;
  static_assert(4 * 16 * OSTR * 4 + 2 * 64 * 4 <= SMEM,
                "the merge scratch must fit over the k/v ring");
};

// k and v rows [kv0, kv0 + BKV) of (b, hk) into one stage, columns past dh
// and rows at or past t_real zero-filled without a read
template <typename T, int DHP>
__device__ __forceinline__ void load_kv(T* Ks, const T* __restrict__ k,
                                        const T* __restrict__ v, int b,
                                        int hk, int T_, int Hkv, int dh,
                                        int t_real, int kv0) {
  constexpr int KSTR = MmaCfg<DHP>::KSTR;
  T* Vs = Ks + BKV * KSTR;
  for (int c = threadIdx.x; c < BKV * DHP / 8; c += MMA_THREADS) {
    int r = c / (DHP / 8), dc = (c % (DHP / 8)) * 8;
    int kp = kv0 + r;
    bool ok = kp < t_real && dc < dh;
    size_t off = ok ? (((size_t)b * T_ + kp) * Hkv + hk) * dh + dc : 0;
    cp_async16(Ks + r * KSTR + dc, k + off, ok);
    cp_async16(Vs + r * KSTR + dc, v + off, ok);
  }
}

// NWQ warps along the rows (16 each); on the split route (NWQ = 1) the
// four warps of the block's 16 rows take NWC slices of the output columns
// instead (warps past NWC only load). Every warp walks each row the same
// way: the scores of all BKV keys of a tile, their max, P rounded to T, and
// P V over the tile's four 16-key steps in ascending order, the tiles in
// ascending order; the softmax's f32 products and sums are rounded each on
// its own (no contraction), so a row's bits do not depend on the route or
// the warp that computes it. grid (q tiles, B * Hkv, splits); a split
// covers kv tiles [z * tiles_per_split, (z + 1) * tiles_per_split) of this
// block's range.
template <typename T, int DHP, int NWQ>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_mma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, float* __restrict__ part_acc,
              float* __restrict__ part_ml, int S, int H, int Hkv, int T_,
              int dh, int t_real, int causal, float scale_log2,
              int tiles_per_split) {
  typedef MmaCfg<DHP> C;
  constexpr int KSTR = C::KSTR, OSTR = C::OSTR;
  constexpr int WPR = 4 / NWQ;   // warps per 16-row group
  constexpr int ND = DHP / 8;    // output n-tiles of a row (even)
  constexpr int NWC = WPR < ND / 2 ? WPR : ND / 2;  // column slices
  constexpr int NDW = ND / NWC;  // output n-tiles per warp (even)
  constexpr int BQ = 16 * NWQ;   // rows of a block
  constexpr int NT = BKV / 8;    // score n-tiles of a tile
  constexpr int KS = BKV / 16;   // PV k-steps of a tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  const int G = H / Hkv, rows = S * G;
  const int bh = blockIdx.y, b = bh / Hkv, hk = bh % Hkv;
  const int row0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wq = warp / WPR, wc = warp % WPR;
  const bool computes = wc < NWC;
  const int nd0 = wc * NDW;      // this warp's first output n-tile
  const int g = lane >> 2, t = lane & 3;

  // this thread's two rows (g and g + 8 of the warp's 16): q fragments,
  // zero past dh
  uint32_t qa[DHP / 16][4];
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int rr = row0 + wq * 16 + g + 8 * i;
    bool ok = rr < rows;
    int s = ok ? rr / G : 0, h = hk * G + (ok ? rr % G : 0);
    qpos[i] = s;
    const T* qr = q + (((size_t)b * S + s) * H + h) * dh + 2 * t;
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      bool lo = ok && kk * 16 + 2 * t < dh;
      bool hi = ok && kk * 16 + 8 + 2 * t < dh;
      qa[kk][i] = lo ? *reinterpret_cast<const uint32_t*>(qr + kk * 16) : 0u;
      qa[kk][2 + i] =
          hi ? *reinterpret_cast<const uint32_t*>(qr + kk * 16 + 8) : 0u;
    }
  }

  // the block's key range: causal stops after the last row's position
  const int last_row = min(row0 + BQ, rows) - 1;
  const int min_qpos = row0 / G;
  int kv_limit = t_real;
  if (causal) kv_limit = min(kv_limit, last_row / G + 1);
  const int n_tiles = (kv_limit + BKV - 1) / BKV;
  const int tile_begin = blockIdx.z * tiles_per_split;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_split);

  float acc[NDW][4];
#pragma unroll
  for (int nd = 0; nd < NDW; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // the ring: tiles tile_begin .. + MMA_STAGES - 2 in flight before the loop
#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (tile_begin + s < tile_end)
      load_kv<T, DHP>(ring + s * C::STAGE_ELEMS, k, v, b, hk, T_, Hkv, dh,
                      t_real, (tile_begin + s) * BKV);
    cp_async_commit();
  }

  for (int it = tile_begin; it < tile_end; ++it) {
    const int rel = it - tile_begin;
    const int stage = rel % MMA_STAGES;
    if (it + MMA_STAGES - 1 < tile_end)
      load_kv<T, DHP>(ring + ((rel + MMA_STAGES - 1) % MMA_STAGES) *
                                 C::STAGE_ELEMS,
                      k, v, b, hk, T_, Hkv, dh, t_real,
                      (it + MMA_STAGES - 1) * BKV);
    cp_async_commit();
    cp_async_wait<MMA_STAGES - 1>();
    __syncthreads();

    if (computes) {
      const T* Ks = ring + stage * C::STAGE_ELEMS;
      const T* Vs = Ks + BKV * KSTR;
      const int kv0 = it * BKV;

      // scores of this warp's 16 rows x BKV keys; K fragments of two
      // n-tiles per ldmatrix (matrices: n-tile nt d-lo, nt d-hi, nt+1 d-lo,
      // nt+1 d-hi)
      float sc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const int mi = lane / 8;
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        const T* kr = Ks + ((nt + mi / 2) * 8 + lane % 8) * KSTR + (mi % 2) * 8;
#pragma unroll
        for (int kk = 0; kk < DHP / 16; ++kk) {
          uint32_t r[4];
          ldmatrix_x4(r, kr + kk * 16);
          mma16816<T>(sc[nt], qa[kk], r[0], r[1]);
          mma16816<T>(sc[nt + 1], qa[kk], r[2], r[3]);
        }
      }
      const bool need_mask =
          kv0 + BKV > t_real || (causal && kv0 + BKV - 1 > min_qpos);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = __fmul_rn(sc[nt][j], scale_log2);
          if (need_mask) {
            int kp = kv0 + nt * 8 + 2 * t + (j & 1);
            int qp = (j >> 1) ? qpos[1] : qpos[0];  // no indexed local array
            if (kp >= t_real || (causal && kp > qp)) s = -INFINITY;
          }
          sc[nt][j] = s;
          mx[j >> 1] = fmaxf(mx[j >> 1], s);
        }
      float mu[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        float m_new = fmaxf(m[i], mx[i]);
        mu[i] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
        alpha[i] = exp2f(__fsub_rn(m[i], mu[i]));
        m[i] = m_new;
        l[i] = __fmul_rn(l[i], alpha[i]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float p = exp2f(__fsub_rn(sc[nt][j], mu[j >> 1]));
          sc[nt][j] = p;
          // this thread's columns; the quad is summed at the end
          l[j >> 1] = __fadd_rn(l[j >> 1], p);
        }
#pragma unroll
      for (int nd = 0; nd < NDW; ++nd) {
        acc[nd][0] = __fmul_rn(acc[nd][0], alpha[0]);
        acc[nd][1] = __fmul_rn(acc[nd][1], alpha[0]);
        acc[nd][2] = __fmul_rn(acc[nd][2], alpha[1]);
        acc[nd][3] = __fmul_rn(acc[nd][3], alpha[1]);
      }
      // acc += P @ V over this warp's columns: the C fragments of two score
      // n-tiles are the A fragment of one 16-key step; V fragments of two
      // output n-tiles per ldmatrix.trans (matrices: keys lo d nd, keys hi
      // d nd, keys lo d nd+1, keys hi d nd+1)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t pa[4] = {Elem<T>::pack(sc[2 * ks][0], sc[2 * ks][1]),
                          Elem<T>::pack(sc[2 * ks][2], sc[2 * ks][3]),
                          Elem<T>::pack(sc[2 * ks + 1][0], sc[2 * ks + 1][1]),
                          Elem<T>::pack(sc[2 * ks + 1][2], sc[2 * ks + 1][3])};
        const T* vr = Vs + (ks * 16 + (mi % 2) * 8 + lane % 8) * KSTR +
                      (mi / 2) * 8 + nd0 * 8;
#pragma unroll
        for (int nd = 0; nd < NDW; nd += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, vr + nd * 8);
          mma16816<T>(acc[nd], pa, r[0], r[1]);
          mma16816<T>(acc[nd + 1], pa, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled MMA_STAGES - 1 tiles on
  }
  cp_async_wait<0>();
  __syncthreads();

  // every row's (m, l) and every warp's columns of acc into shared memory
  // (over the k/v ring) ...
  float* so = reinterpret_cast<float*>(smem_raw);
  float* sm = so + 4 * 16 * OSTR;
  float* sl = sm + 4 * 16;
  if (computes) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 1));
      l[i] = __fadd_rn(l[i], __shfl_xor_sync(0xffffffffu, l[i], 2));
      if (t == 0 && wc == 0) {
        sm[wq * 16 + g + 8 * i] = m[i];
        sl[wq * 16 + g + 8 * i] = l[i];
      }
    }
#pragma unroll
    for (int nd = 0; nd < NDW; ++nd) {
      float* r0 = so + (wq * 16 + g) * OSTR + (nd0 + nd) * 8 + 2 * t;
      *reinterpret_cast<float2*>(r0) = make_float2(acc[nd][0], acc[nd][1]);
      *reinterpret_cast<float2*>(r0 + 8 * OSTR) =
          make_float2(acc[nd][2], acc[nd][3]);
    }
  }
  __syncthreads();

  // ... written out: the splits' partials, or o = acc / l and the lse
  const bool split = gridDim.z > 1;
  for (int idx = threadIdx.x; idx < BQ * dh; idx += MMA_THREADS) {
    const int rr = idx / dh, d = idx % dh;
    const int grow = row0 + rr;
    if (grow >= rows) break;
    const float A = so[rr * OSTR + d], M = sm[rr], L = sl[rr];
    if (split) {
      size_t prow = ((size_t)blockIdx.z * gridDim.y + bh) * rows + grow;
      part_acc[prow * dh + d] = A;
      if (d == 0) {
        part_ml[prow * 2] = M;
        part_ml[prow * 2 + 1] = L;
      }
    } else {
      const int s = grow / G, h = hk * G + grow % G;
      o[(((size_t)b * S + s) * H + h) * dh + d] =
          Elem<T>::from(A / fmaxf(L, 1e-30f));
      if (lse && d == 0) lse[((size_t)b * H + h) * S + s] = row_lse(M, L);
    }
  }
}

// o = merge of the splits' (acc, m, l) of every row, in split order
template <typename T>
__global__ void flash_combine(const float* __restrict__ part_acc,
                              const float* __restrict__ part_ml,
                              T* __restrict__ o, float* __restrict__ lse,
                              int BHkv, int S, int H,
                              int Hkv, int dh, int splits) {
  const int G = H / Hkv, rows = S * G;
  const long long n = (long long)BHkv * rows * dh;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long long prow = idx / dh;
  const int d = (int)(idx % dh);
  const size_t stride = (size_t)BHkv * rows;
  float M = -INFINITY;
  for (int z = 0; z < splits; ++z)
    M = fmaxf(M, part_ml[(z * stride + prow) * 2]);
  float A = 0.f, L = 0.f;
  for (int z = 0; z < splits; ++z) {
    float mz = part_ml[(z * stride + prow) * 2];
    float e = mz == -INFINITY ? 0.f : exp2f(mz - M);
    A += e * part_acc[(z * stride + prow) * dh + d];
    L += e * part_ml[(z * stride + prow) * 2 + 1];
  }
  const int bh = (int)(prow / rows), grow = (int)(prow % rows);
  const int b = bh / Hkv, hk = bh % Hkv;
  const int s = grow / G, h = hk * G + grow % G;
  o[(((size_t)b * S + s) * H + h) * dh + d] =
      Elem<T>::from(A / fmaxf(L, 1e-30f));
  if (lse && d == 0) lse[((size_t)b * H + h) * S + s] = row_lse(M, L);
}

template <typename T, int DHP, int NWQ>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, float* part_acc, float* part_ml, int B, int S,
               int H, int Hkv,
               int T_, int dh, int t_real, int causal, int q_tiles,
               int splits, int tiles_per_split, float scale_log2,
               cudaStream_t stream) {
  auto kern = flash_mma<T, DHP, NWQ>;
  // above 48 KB only after opting in, per device; all of L1 as shared
  // memory: two 102 KB rings per SM at DHP = 128
  static sm90::OptIn opted;
  int err = sm90::smem_opt_in(kern, MmaCfg<DHP>::SMEM, true, opted);
  if (err) return err;
  dim3 grid(q_tiles, B * Hkv, splits);
  kern<<<grid, MMA_THREADS, MmaCfg<DHP>::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, part_acc, part_ml,
      S, H, Hkv, T_, dh, t_real, causal, scale_log2, tiles_per_split);
  err = (int)cudaGetLastError();
  if (err || splits == 1) return err;
  long long n = (long long)B * Hkv * S * (H / Hkv) * dh;
  flash_combine<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(o), lse, B * Hkv, S, H, Hkv, dh,
      splits);
  return (int)cudaGetLastError();
}

template <typename T, int NWQ>
int mma_by_width(int dhp, const void* q, const void* k, const void* v,
                 void* o, float* ls, float* pa, float* pm, int B, int S,
                 int H, int Hkv, int T_, int dh, int t_real, int causal,
                 int q_tiles, int splits, int per, float sl2,
                 cudaStream_t s) {
  switch (dhp) {
    case 16:
      return launch_mma<T, 16, NWQ>(q, k, v, o, ls, pa, pm, B, S, H, Hkv,
                                    T_, dh, t_real, causal, q_tiles, splits,
                                    per, sl2, s);
    case 32:
      return launch_mma<T, 32, NWQ>(q, k, v, o, ls, pa, pm, B, S, H, Hkv,
                                    T_, dh, t_real, causal, q_tiles, splits,
                                    per, sl2, s);
    case 64:
      return launch_mma<T, 64, NWQ>(q, k, v, o, ls, pa, pm, B, S, H, Hkv,
                                    T_, dh, t_real, causal, q_tiles, splits,
                                    per, sl2, s);
    case 128:
      return launch_mma<T, 128, NWQ>(q, k, v, o, ls, pa, pm, B, S, H, Hkv,
                                     T_, dh, t_real, causal, q_tiles, splits,
                                     per, sl2, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- the f32 and wide routes (SIMT) ----------------------------------------

constexpr int F_BQ = 16, F_BK = 32, F_THREADS = 256, F_DH = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(f16 x) { return __half2float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void put(f16* p, float x) { *p = __float2half_rn(x); }

// grid (ceil(rows / 16), B * Hkv, ceil(dh / 128)): block z writes output
// columns [128 z, 128 z + 128). Warp w owns rows 2w, 2w + 1 of the block's
// 16; for the scores lane j takes key j of the tile, for PV lane j columns
// j, j + 32, j + 64, j + 96 of the block's 128. Row max and sum are reduced
// over the warp each tile, so every lane holds its rows' m and l. The
// scores run over dh in 128-column chunks staged in shared memory (q once
// when dh <= 128, else with each chunk of k); inputs are read in T and
// converted to f32, everything is computed in f32, and only the output is
// rounded to T.
template <typename T>
__global__ void __launch_bounds__(F_THREADS)
    flash_simt(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int S, int H, int Hkv, int T_, int dh,
               int t_real, int causal, float scale_log2) {
  __shared__ float qs[F_BQ][F_DH];
  __shared__ float ks[F_BK][F_DH + 1];  // + 1: lane j reads row j
  __shared__ float vs[F_BK][F_DH];
  const int G = H / Hkv, rows = S * G;
  const int bh = blockIdx.y, b = bh / Hkv, hk = bh % Hkv;
  const int row0 = blockIdx.x * F_BQ;
  const int col0 = blockIdx.z * F_DH;
  const int nd = (dh + F_DH - 1) / F_DH;  // column chunks of the scores
  const int wv = min(F_DH, dh - col0);    // this block's output columns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = (row0 + 2 * warp + i) / G;
  const int last_row = min(row0 + F_BQ, rows) - 1;
  int kv_limit = t_real;
  if (causal) kv_limit = min(kv_limit, last_row / G + 1);

  float acc[2][F_DH / 32] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kv0 = 0; kv0 < kv_limit; kv0 += F_BK) {
    float dot[2] = {0.f, 0.f};
    for (int c = 0; c < nd; ++c) {
      const int d0 = c * F_DH, w = min(F_DH, dh - d0);
      __syncthreads();  // the previous chunk or tile is consumed
      if (nd > 1 || kv0 == 0) {
        for (int idx = threadIdx.x; idx < F_BQ * w; idx += F_THREADS) {
          int r = idx / w, d = idx % w, rr = row0 + r;
          float x = 0.f;
          if (rr < rows)
            x = to_f(q[(((size_t)b * S + rr / G) * H + hk * G + rr % G) * dh +
                       d0 + d]);
          qs[r][d] = x;
        }
      }
      for (int idx = threadIdx.x; idx < F_BK * w; idx += F_THREADS) {
        int r = idx / w, d = idx % w, kp = kv0 + r;
        size_t off = (((size_t)b * T_ + kp) * Hkv + hk) * dh + d0 + d;
        ks[r][d] = kp < t_real ? to_f(k[off]) : 0.f;  // past t_real: unread
      }
      if (c == nd - 1) {
        for (int idx = threadIdx.x; idx < F_BK * wv; idx += F_THREADS) {
          int r = idx / wv, d = idx % wv, kp = kv0 + r;
          size_t off = (((size_t)b * T_ + kp) * Hkv + hk) * dh + col0 + d;
          vs[r][d] = kp < t_real ? to_f(v[off]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* qr = qs[2 * warp + i];
        for (int d = 0; d < w; ++d) dot[i] = fmaf(qr[d], ks[lane][d], dot[i]);
      }
    }
    const int kp = kv0 + lane;
    float p[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float s = dot[i] * scale_log2;
      if (kp >= t_real || (causal && kp > qpos[i])) s = -INFINITY;
      float mx = s;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float m_new = fmaxf(m[i], mx);
      float mu = m_new == -INFINITY ? 0.f : m_new;
      float alpha = exp2f(m[i] - mu);
      p[i] = exp2f(s - mu);
      float ps = p[i];
#pragma unroll
      for (int off = 16; off; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      m[i] = m_new;
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int j = 0; j < F_DH / 32; ++j) acc[i][j] *= alpha;
    }
    for (int j2 = 0; j2 < F_BK; ++j2) {
      float p0 = __shfl_sync(0xffffffffu, p[0], j2);
      float p1 = __shfl_sync(0xffffffffu, p[1], j2);
#pragma unroll
      for (int j = 0; j < F_DH / 32; ++j) {
        float x = vs[j2][lane + 32 * j];  // columns past wv: never stored
        acc[0][j] = fmaf(p0, x, acc[0][j]);
        acc[1][j] = fmaf(p1, x, acc[1][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int rr = row0 + 2 * warp + i;
    if (rr >= rows) continue;
    if (lse && blockIdx.z == 0 && lane == 0)
      lse[((size_t)b * H + hk * G + rr % G) * S + rr / G] = row_lse(m[i], l[i]);
    T* orow = o + (((size_t)b * S + rr / G) * H + hk * G + rr % G) * dh + col0;
#pragma unroll
    for (int j = 0; j < F_DH / 32; ++j)
      if (lane + 32 * j < wv)
        put(orow + lane + 32 * j, acc[i][j] / fmaxf(l[i], 1e-30f));
  }
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int H, int Hkv, int T_, int dh,
                int t_real, int causal, int q_tiles, float scale_log2,
                cudaStream_t stream) {
  dim3 grid(q_tiles, B * Hkv, (dh + F_DH - 1) / F_DH);
  flash_simt<T><<<grid, F_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, Hkv, T_, dh,
      t_real, causal, scale_log2);
  return (int)cudaGetLastError();
}

// ---- the wgmma route (TMA + wgmma, warp-specialised) -----------------------

constexpr int W_BQ = 128;       // rows of a block (2 consumer warpgroups)
constexpr int W_BK = 128;       // keys of a k/v tile
constexpr int W_STAGES = 2;
constexpr int W_THREADS = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int ROW_BYTES = 128;  // one 64-column box row (128-byte swizzle)

template <int DH>
struct WgCfg {
  static constexpr int NBOX = DH / 64;                 // 64-column boxes
  static constexpr int Q_BOX = W_BQ * ROW_BYTES;       // 16 KB
  static constexpr int KV_BOX = W_BK * ROW_BYTES;      // 16 KB
  static constexpr int Q_BYTES = NBOX * Q_BOX;
  static constexpr int KV_BYTES = NBOX * KV_BOX;
  static constexpr int SMEM = Q_BYTES + 2 * W_STAGES * KV_BYTES + 1024;
  static constexpr int ACC = DH / 2;  // O floats per thread
};

template <bool F16, int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<false, 128>(float (&o)[64],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db) {
  sm90::wgmma_rs_m64n128<false, 1>(o, a, db, 1);
}
template <>
__device__ __forceinline__ void wgmma_pv<true, 128>(float (&o)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  sm90::wgmma_rs_m64n128<true, 1>(o, a, db, 1);
}
template <>
__device__ __forceinline__ void wgmma_pv<false, 64>(float (&o)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  sm90::wgmma_rs_m64n64<false, 1>(o, a, db, 1);
}
template <>
__device__ __forceinline__ void wgmma_pv<true, 64>(float (&o)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  sm90::wgmma_rs_m64n64<true, 1>(o, a, db, 1);
}

// S (64 x 128 keys) = Q rows (64 x DH, K-major, this warpgroup's half of
// the Q tile at `qw`) K^T (K tile rows along dh: K-major B)
template <bool F16, int DH>
__device__ __forceinline__ void qk_tile(float (&s)[64], const uint8_t* qw,
                                        const uint8_t* kt) {
  typedef WgCfg<DH> C;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    sm90::wgmma_ss_m64n128<F16>(
        s, sm90::desc_kmajor(qw + (kk / 4) * C::Q_BOX + (kk % 4) * 32),
        sm90::desc_kmajor(kt + (kk / 4) * C::KV_BOX + (kk % 4) * 32), kk > 0);
}

// O (64 x DH) += P (64 x 128 keys, registers) V (V tile: 128 key rows of
// DH columns in 64-column boxes, MN-major B)
template <bool F16, int DH>
__device__ __forceinline__ void pv_tile(float (&acc)[DH / 2],
                                        uint32_t (&pa)[8][4],
                                        const uint8_t* vt) {
#pragma unroll
  for (int ks = 0; ks < W_BK / 16; ++ks)
    wgmma_pv<F16, DH>(acc, pa[ks],
                      sm90::desc_mnmajor(vt + ks * 16 * ROW_BYTES,
                                         WgCfg<DH>::KV_BOX));
}

// One block per (q tile, b, kv head), heaviest q tiles first. The maps:
// q as (dh, H, S, B) boxes of (64, G, 128 / G, 1); k and v as (dh, Hkv,
// t_real, B) boxes of (64, 1, 128, 1).
template <typename T, int DH>
__global__ void __launch_bounds__(W_THREADS, 1)
    flash_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
                float* __restrict__ lse, int S, int H, int Hkv, int t_real,
                int causal, float scale_log2, int q_tiles, int BHkv) {
  typedef WgCfg<DH> C;
  constexpr bool F16 = Elem<T>::F16;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[W_STAGES],
      v_full[W_STAGES], k_empty[W_STAGES], v_empty[W_STAGES];
  uint8_t* base =
      smem_raw + ((1024 - sm90::smem_addr(smem_raw) % 1024) % 1024);
  uint8_t* qs = base;
  uint8_t* kring = base + C::Q_BYTES;
  uint8_t* vring = kring + W_STAGES * C::KV_BYTES;

  const int tile = q_tiles - 1 - (int)(blockIdx.x / BHkv);
  const int bh = blockIdx.x % BHkv, b = bh / Hkv, hk = bh % Hkv;
  const int G = H / Hkv, rows = S * G;
  const int row0 = tile * W_BQ, s0 = row0 / G;  // G divides 128
  const int last_row = min(row0 + W_BQ, rows) - 1;
  int kv_limit = t_real;
  if (causal) kv_limit = min(kv_limit, last_row / G + 1);
  const int n_tiles = (kv_limit + W_BK - 1) / W_BK;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < W_STAGES; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&k_empty[s], 8);  // lane 0 of each consumer warp
      sm90::mbar_init(&v_empty[s], 8);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer: one thread keeps the ring full
    sm90::regs_dealloc<24>();
    if (threadIdx.x == 256) {
      sm90::mbar_expect_tx(&q_full, C::Q_BYTES);
#pragma unroll
      for (int x = 0; x < C::NBOX; ++x)
        sm90::tma_load_4d(qs + x * C::Q_BOX, &tq, &q_full, x * 64, hk * G, s0,
                          b);
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % W_STAGES;
        const uint32_t phase = (it / W_STAGES) & 1;
        sm90::mbar_wait(&k_empty[stage], phase ^ 1);
        sm90::mbar_expect_tx(&k_full[stage], C::KV_BYTES);
#pragma unroll
        for (int x = 0; x < C::NBOX; ++x)
          sm90::tma_load_4d(kring + stage * C::KV_BYTES + x * C::KV_BOX, &tk,
                            &k_full[stage], x * 64, hk, it * W_BK, b);
        sm90::mbar_wait(&v_empty[stage], phase ^ 1);
        sm90::mbar_expect_tx(&v_full[stage], C::KV_BYTES);
#pragma unroll
        for (int x = 0; x < C::NBOX; ++x)
          sm90::tma_load_4d(vring + stage * C::KV_BYTES + x * C::KV_BOX, &tv,
                            &v_full[stage], x * 64, hk, it * W_BK, b);
      }
    }
  } else {  // consumers: warpgroups 0 and 1, 64 rows each
    sm90::regs_alloc<240>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, c = lane % 4;
    const int wrow0 = row0 + wg * 64 + 16 * warp + g;  // and + 8
    const int qpos[2] = {wrow0 / G, (wrow0 + 8) / G};
    const int min_qpos = s0;
    const uint8_t* qw = qs + wg * 64 * ROW_BYTES;

    float acc[C::ACC];
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    sm90::mbar_wait(&q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % W_STAGES;
      const uint32_t phase = (it / W_STAGES) & 1;
      const int kv0 = it * W_BK;

      float s[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = 0.f;  // overwritten (scale_d 0)
      sm90::fence_regs(s);
      sm90::mbar_wait(&k_full[stage], phase);
      sm90::wgmma_fence();
      qk_tile<F16, DH>(s, qw, kring + stage * C::KV_BYTES);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      if (lane == 0) sm90::mbar_arrive(&k_empty[stage]);

      // online softmax over this tile: element i of s is row g + 8 *
      // ((i / 2) % 2), key column 8 * (i / 4) + 2c + i % 2. The max is
      // taken over the raw scores (the scale is positive), p = 2^(s *
      // scale - max) in one FMA and one ex2.
      const bool need_mask =
          kv0 + W_BK > t_real || (causal && kv0 + W_BK - 1 > min_qpos);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if (need_mask) {
          int kp = kv0 + 8 * (i / 4) + 2 * c + (i % 2);
          if (kp >= t_real || (causal && kp > qpos[(i / 2) % 2]))
            s[i] = -INFINITY;
        }
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
      }
      float mu[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        float m_new = fmaxf(m[r], mx[r] * scale_log2);
        mu[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
        alpha[r] = ex2(m[r] - mu[r]);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      uint32_t pa[W_BK / 16][4];
#pragma unroll
      for (int j = 0; j < W_BK / 16; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          float p0 = ex2(fmaf(s[8 * j + 2 * h], scale_log2, -mu[h % 2]));
          float p1 = ex2(fmaf(s[8 * j + 2 * h + 1], scale_log2, -mu[h % 2]));
          l[h % 2] += p0 + p1;
          pa[j][h] = Elem<T>::pack(p0, p1);
        }
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) acc[i] *= alpha[(i / 2) % 2];

      sm90::mbar_wait(&v_full[stage], phase);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
      pv_tile<F16, DH>(acc, pa, vring + stage * C::KV_BYTES);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (lane == 0) sm90::mbar_arrive(&v_empty[stage]);
    }

    // epilogue: O / l in T, through the (position, head) packing
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int grow = wrow0 + 8 * r;
      if (lse && c == 0 && grow < rows)
        lse[((size_t)b * H + hk * G + grow % G) * S + grow / G] =
            row_lse(m[r], l[r]);
      l[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int grow = wrow0 + 8 * r;
      if (grow >= rows) continue;
      T* orow = o + (((size_t)b * S + grow / G) * H + hk * G + grow % G) * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * c) =
            Elem<T>::pack(acc[i] * l[r], acc[i + 1] * l[r]);
      }
    }
  }
}

// the 4-D maps of a wgmma launch (see flash_wgmma)
template <typename T>
int wgmma_maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv,
               const void* q, const void* k, const void* v, int B, int S,
               int H, int Hkv, int T_, int dh, int t_real) {
  const int G = H / Hkv;
  const uint64_t e = 2;
  uint64_t qd[4] = {(uint64_t)dh, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  uint64_t qs[3] = {dh * e, (uint64_t)H * dh * e, (uint64_t)S * H * dh * e};
  uint32_t qb[4] = {64, (uint32_t)G, (uint32_t)(W_BQ / G), 1};
  int err = sm90::map_sw128(tq, Elem<T>::MAP, 4, q, qd, qs, qb);
  if (err) return err;
  uint64_t kd[4] = {(uint64_t)dh, (uint64_t)Hkv, (uint64_t)t_real,
                    (uint64_t)B};
  uint64_t kstr[3] = {dh * e, (uint64_t)Hkv * dh * e,
                      (uint64_t)T_ * Hkv * dh * e};
  uint32_t kb[4] = {64, 1, W_BK, 1};
  err = sm90::map_sw128(tk, Elem<T>::MAP, 4, k, kd, kstr, kb);
  if (err) return err;
  return sm90::map_sw128(tv, Elem<T>::MAP, 4, v, kd, kstr, kb);
}

template <typename T, int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int S, int H, int Hkv, int T_, int t_real,
                 int causal, int q_tiles, float scale_log2,
                 cudaStream_t stream) {
  const int G = H / Hkv;
  if (W_BQ % G) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = wgmma_maps<T>(&tq, &tk, &tv, q, k, v, B, S, H, Hkv, T_, DH,
                          t_real);
  if (err) return err;
  auto kern = flash_wgmma<T, DH>;
  static sm90::OptIn opted;  // above 48 KB only after opting in, per device
  err = sm90::smem_opt_in(kern, WgCfg<DH>::SMEM, false, opted);
  if (err) return err;
  const long long blocks = (long long)q_tiles * B * Hkv;
  kern<<<(unsigned)blocks, W_THREADS, WgCfg<DH>::SMEM, stream>>>(
      tq, tk, tv, static_cast<T*>(o), lse, S, H, Hkv, t_real, causal,
      scale_log2, q_tiles, B * Hkv);
  return (int)cudaGetLastError();
}

// one launch of the wgmma, mma or split route (0, 1, 2) in T
template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* o,
                 float* ls, float* pa, float* pm, int route, int dhp, int B,
                 int S, int H, int Hkv, int T_, int dh, int t_real,
                 int causal, int q_tiles, int splits, int per,
                 float scale_log2, cudaStream_t s) {
  if (route == 0) {
    if (splits != 1 || dh != dhp) return (int)cudaErrorInvalidValue;
    if (dh == 128)
      return launch_wgmma<T, 128>(q, k, v, o, ls, B, S, H, Hkv, T_, t_real,
                                  causal, q_tiles, scale_log2, s);
    if (dh == 64)
      return launch_wgmma<T, 64>(q, k, v, o, ls, B, S, H, Hkv, T_, t_real,
                                 causal, q_tiles, scale_log2, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dh > dhp || dh % 8) return (int)cudaErrorInvalidValue;
  if (route == 1)
    return mma_by_width<T, 4>(dhp, q, k, v, o, ls, pa, pm, B, S, H, Hkv, T_,
                              dh, t_real, causal, q_tiles, splits, per,
                              scale_log2, s);
  if (route == 2)
    return mma_by_width<T, 1>(dhp, q, k, v, o, ls, pa, pm, B, S, H, Hkv, T_,
                              dh, t_real, causal, q_tiles, splits, per,
                              scale_log2, s);
  return (int)cudaErrorInvalidValue;
}

// ---- the single-tile check of the wgmma route -------------------------------

// One warpgroup, one tile: q (64 rows x 128), k and v (128 keys x 128), bf16,
// through the route's 4-D maps (B = H = Hkv = 1). s = Q K^T (f32, SS
// wgmma from the TMA-loaded tiles); then P = exp(scaled s - row max) in
// bf16 registers and o = P V / sum P (RS wgmma, V MN-major): the two
// products of the route on a single tile, with no ring and no online
// rescaling. s and o are (64, 128) f32, row-major.
__global__ void __launch_bounds__(128)
    flash_probe(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, float* s_out,
                float* o_out, float scale_log2) {
  typedef WgCfg<128> C;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  uint8_t* base =
      smem_raw + ((1024 - sm90::smem_addr(smem_raw) % 1024) % 1024);
  uint8_t *qs = base, *ks = qs + C::Q_BYTES, *vs = ks + C::KV_BYTES;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // the q box is 128 rows: rows 64 .. 127 lie past S = 64 and load zeros
    sm90::mbar_expect_tx(&bar, C::Q_BYTES + 2 * C::KV_BYTES);
    for (int x = 0; x < 2; ++x) {
      sm90::tma_load_4d(qs + x * C::Q_BOX, &tq, &bar, x * 64, 0, 0, 0);
      sm90::tma_load_4d(ks + x * C::KV_BOX, &tk, &bar, x * 64, 0, 0, 0);
      sm90::tma_load_4d(vs + x * C::KV_BOX, &tv, &bar, x * 64, 0, 0, 0);
    }
  }
  sm90::mbar_wait(&bar, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  float s[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  sm90::fence_regs(s);
  sm90::wgmma_fence();
  qk_tile<false, 128>(s, qs, ks);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
#pragma unroll
  for (int i = 0; i < 64; ++i)
    s_out[(16 * warp + g + 8 * ((i / 2) % 2)) * 128 + 8 * (i / 4) + 2 * c +
          i % 2] = s[i];
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] *= scale_log2;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  uint32_t pa[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      float p0 = exp2f(s[8 * j + 2 * h] - mx[h % 2]);
      float p1 = exp2f(s[8 * j + 2 * h + 1] - mx[h % 2]);
      l[h % 2] += p0 + p1;
      pa[j][h] = Elem<bf16>::pack(p0, p1);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  sm90::fence_regs(acc);
  sm90::wgmma_fence();
  pv_tile<false, 128>(acc, pa, vs);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
#pragma unroll
  for (int i = 0; i < 64; ++i)
    o_out[(16 * warp + g + 8 * ((i / 2) % 2)) * 128 + 8 * (i / 4) + 2 * c +
          i % 2] = acc[i] / l[(i / 2) % 2];
}

}  // namespace

extern "C" {

// Attention of q (B, S, H, dh) over k, v (B, T, Hkv, dh) into o, all of
// dtype `is_f16` ? f16 : bf16. route 0 "wgmma" (dh 64 or 128, 128-row tiles;
// q_tiles of them), 1 "mma" (64-row tiles) or 2 "split" (16-row tiles, the
// output columns split over the warps), the last two on a kernel of head
// width dhp (16, 32, 64 or 128, >= dh); scores scaled by 1 / sqrt(dh_scale)
// (the true head width when the wrapper padded dh). A non-null lse (B, H, S)
// f32 receives the rows' log-sum-exp. With splits > 1 (routes 1 and 2),
// part_acc (splits, B * Hkv * S * G, dh) and part_ml (splits, B * Hkv * S
// * G, 2) take the partials and flash_combine writes o.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* lse, void* part_acc, void* part_ml,
                           int is_f16,
                           int route, int dhp, int B, int S, int H, int Hkv,
                           int T_, int dh, int t_real, int causal,
                           int q_tiles, int splits, int tiles_per_split,
                           int dh_scale, void* stream_ptr) {
  auto run = is_f16 ? launch_typed<f16> : launch_typed<bf16>;
  return run(q, k, v, o, static_cast<float*>(lse),
             static_cast<float*>(part_acc),
             static_cast<float*>(part_ml), route, dhp, B, S, H, Hkv, T_, dh,
             t_real, causal, q_tiles, splits, tiles_per_split,
             LOG2E / sqrtf((float)dh_scale),
             static_cast<cudaStream_t>(stream_ptr));
}

// The SIMT kernel: q (B, S, H, dh) over k, v (B, T, Hkv, dh) into o, all of
// dtype `dtype` (0 f32, 1 bf16, 2 f16), any dh ("f32": f32 at dh <= 128;
// "wide": any dtype at dh > 128); scores scaled by 1 / sqrt(dh_scale); a
// non-null lse (B, H, S) f32 receives the rows' log-sum-exp.
int flash_attention_simt_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int dtype, int B, int S,
                                int H,
                                int Hkv, int T_, int dh, int t_real,
                                int causal, int q_tiles, int dh_scale,
                                void* stream_ptr) {
  auto run = dtype == 0 ? launch_simt<float>
             : dtype == 1 ? launch_simt<bf16> : launch_simt<f16>;
  return run(q, k, v, o, static_cast<float*>(lse), B, S, H, Hkv, T_, dh,
             t_real, causal, q_tiles,
             LOG2E / sqrtf((float)dh_scale),
             static_cast<cudaStream_t>(stream_ptr));
}

// the single-tile check: bf16 q (64 x 128), k and v (128 x 128), contiguous
// and 16-byte aligned; s and o (64 x 128) f32
int flash_probe_launch(const void* q, const void* k, const void* v,
                       void* s_out, void* o_out, void* stream_ptr) {
  CUtensorMap tq, tk, tv;
  int err = wgmma_maps<bf16>(&tq, &tk, &tv, q, k, v, 1, 64, 1, 1, 128, 128,
                             128);
  if (err) return err;
  typedef WgCfg<128> C;
  const int smem = C::Q_BYTES + 2 * C::KV_BYTES + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      flash_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  flash_probe<<<1, 128, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      tq, tk, tv, static_cast<float*>(s_out), static_cast<float*>(o_out),
      LOG2E / sqrtf(128.f));
  return (int)cudaGetLastError();
}

}  // extern "C"
