// B6's gradient: the backward pass of blockwise online-softmax attention,
// hand-written for Hopper (sm_90a).
//
// The TPU kernel `flash_attention` of src/repro/kernels/flash_attention.py:96
// has no backward: in the reference no model calls it, and jax.value_and_grad
// differentiates the inline jnp attention. In the port B6 is the LM's
// attention, so its gradient is a kernel too. Semantics are the forward's
// (csrc/flash_attention.cu): q (B, S, H, dh), k and v (B, T, Hkv, dh), query
// head h on kv head h / G (G = H / Hkv) without the expansion, the causal
// mask qpos >= kpos aligned at position 0, keys at or past t_real masked and
// never read, scale 1 / sqrt(dh). Given o, do (B, S, H, dh) and the row
// log-sum-exp lse (B, H, S) f32 that the forward kept, it writes dq
// (B, S, H, dh), dk and dv (B, T, Hkv, dh) in the inputs' dtype,
// FlashAttention-2's recurrence:
//     D   = rowsum(do * o)
//     P   = exp(s - lse),  s = scale * q k^T,  dP = do v^T,  dS = P (dP - D)
//     dq  = scale * dS k,  dk = scale * dS^T q,  dv = P^T do
// A row the forward floored (no key attended) has lse = +inf: P = 0 there.
//
// Launches on the caller's stream, in order: flash_bwd_dsum (D, 16 lanes a
// row, a fixed order), then the route's dq and dk/dv kernels, then, where a
// kv head's gradient comes in partials, flash_bwd_reduce, which sums them in
// a fixed order and rounds to the dtype. No float atomics anywhere, so a
// step's gradients, and a training run's losses, are bit-reproducible.
//
// What bounds it. Five products of the attended pairs (q k^T, do v^T,
// P^T do, dS^T q, dS k): at glm4's S = T = 4,096 causal, H = 32, dh = 128,
// 3.44e11 FLOP, 0.348 ms at 989 TFLOP/s; the tensor cores bound it, and
// only wgmma reaches that rate. Every route recomputes q k^T and do v^T in
// both its dq and its dk/dv kernel: seven products, a floor of 0.487 ms.
// One pass that adds dq from the dk/dv blocks (FlashAttention-2/3) does
// five, but only with float atomics, whose order changes from run to run.
// P and dS are rounded to the dtype before their products, as the forward
// rounds P; everything else stays f32.
//
// Routes (the wrapper's `bwd_plan` picks one):
// * "wgmma": bf16 or f16, dh 64 or 128, G dividing 128, more than 16 rows
//   per (b, kv head): the glm4 and codeqwen training path. TMA 4-D tensor
//   maps over q, do (dh, H, S, B) and k, v (dh, Hkv, t_real, B), 128-byte
//   swizzled (keys past t_real and positions past S load as zeros without
//   a read); one producer warp keeps a 2-stage ring full; wgmma with
//   register A operands and the transpose flag, as the forward's P V.
//   - flash_bwd_dkdv_wgmma: a block holds 128 keys of one kv head (K and
//     V in shared memory, wgmma's A operands; two consumer warpgroups of
//     64 keys) and streams 64-row q/do tiles in the forward's row layout,
//     restricted to a head group: rows are (position, head) pairs of Gg =
//     G / groups query heads, so one tile carries them all and dK/dV sum
//     over them inside the products. Per tile and warpgroup, four
//     products: S^T = K Q^T and dP^T = V dO^T (both operands K-major; the
//     exp of P^T overlaps dP^T), P^T and dS^T in the accumulators' layout,
//     which is the A fragment's, then dV += P^T dO and dK += dS^T Q (q and
//     do read MN-major). lse and D of the tile's rows ride in the ring
//     beside it. Blocks go heaviest first (key tiles from position 0).
//     glm4 has Hkv = 2: 128-key blocks per kv head alone would be 64, so
//     its 16 query heads split into head groups whose f32 partials
//     flash_bwd_reduce sums in group order; one group (codeqwen, G = 1)
//     writes dk and dv directly. The wrapper's BWD_KV_BLOCKS states the
//     choice of groups and its measurement.
//   - flash_bwd_dq_wgmma: a block owns a 128-row tile (two consumer
//     warpgroups of 64 rows, as the forward) and streams 64-key k/v tiles:
//     S = Q K^T, dP = dO V^T and dQ += dS K (k read MN-major), three
//     products; no partials. 168 registers a thread suffice.
//   Registers: a dK/dV consumer holds dK and dV (128 floats a thread at dh
//   128) beside S^T and dP^T (32 each): 253 registers. ptxas allocates a
//   block's registers in whole warpgroups, and setmaxnreg did not raise
//   its allocation: any block of more than 8 warps gets 168 a thread and
//   spilled 268-320 bytes. So the block is two consumer warpgroups and no
//   producer warp; its warp 0 issues the loads between its own tiles.
//   Measured at glm4's causal 4,096 on an H100 (PERF.md; the whole
//   backward, 0.96-0.97 ms with this block) and not kept: one consumer
//   warpgroup with a producer warp, one block an SM (0.98-1.02), two
//   consumer warpgroups with a producer warp or warpgroup (1.24-1.38,
//   spilling), queuing the next tile's S^T and dP^T behind the current
//   dK/dV products (1.45), 3- and 4-stage rings (within 2%), splitting a
//   64-key block's work by role over two warpgroups that pass P^T through
//   shared memory (1.07 with K and V in shared memory; 0.98, no faster,
//   with them as register operands) and the same split for dq (1.18).
//   Skipping every q/do and k/v reload moved the time by 1%: the
//   warpgroups' chain of products and softmax, not L2 or TMA latency,
//   bounds these kernels.
// * "mma": bf16 and f16 otherwise (dh padded by the wrapper to a multiple
//   of 8 and here to DHP in {16, 32, 64, 128} with zeros in shared memory,
//   which add nothing to any product): mma.sync m16n8k16 with cp.async,
//   64-row dq blocks over 32-key tiles, 64-key dk/dv blocks of ONE query
//   head over 32-row tiles, f32 partials (B, T, H, dh) summed per kv head.
// * "f32" and "wide": plain f32 FMAs (SIMT) for f32 inputs at dh <= 128 and
//   for any dtype at dh > 128: bf16 and f16 are read and converted to f32,
//   only the outputs are rounded. The scores run over dh in 128-column
//   chunks staged in shared memory; each block writes one 128-column chunk
//   of its outputs (grid z), as the forward's wide route does.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;
typedef __half f16;

namespace {

constexpr float LOG2E = 1.4426950408889634f;

using sm90::smem_addr;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(f16 x) { return __half2float(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void put(f16* p, float x) { *p = __float2half_rn(x); }

template <typename T>
struct Elem;
template <>
struct Elem<bf16> {
  static constexpr bool F16 = false;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
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
};

// 2^x in one instruction (max relative error 2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d (16 x 8, f32) += a (16 x 16, row) @ b (16 x 8, col)
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
// addresses of matrix i. Without .trans lane (g, c) receives row g, columns
// 2c, 2c + 1 of each; with .trans rows 2c, 2c + 1 of column g.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// lse (natural log, B H S) in the log2 domain, +inf for rows past S (P = 0)
__device__ __forceinline__ float lse_log2(const float* __restrict__ lse,
                                          size_t idx, bool ok) {
  return ok ? lse[idx] * LOG2E : INFINITY;
}

// ---- D = rowsum(do * o) -----------------------------------------------------

constexpr int DSUM_THREADS = 256;  // 16 rows a block, 16 lanes each

// 8 elements of T from 16 aligned bytes, as floats, into s
__device__ __forceinline__ float dot8(const float* a, const float* b,
                                      float s) {
#pragma unroll
  for (int e = 0; e < 8; ++e) s = fmaf(a[e], b[e], s);
  return s;
}
template <typename T>
__device__ __forceinline__ void load8(float (&f)[8], const T* p) {
  if constexpr (sizeof(T) == 4) {
    const float4* v = reinterpret_cast<const float4*>(p);
    float4 lo = v[0], hi = v[1];
    f[0] = lo.x, f[1] = lo.y, f[2] = lo.z, f[3] = lo.w;
    f[4] = hi.x, f[5] = hi.y, f[6] = hi.z, f[7] = hi.w;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = to_f(e[i]);
  }
}

// dsum (B, H, S) f32 of the (B * S * H) rows of o and do (dh a multiple of
// 8): 16 lanes a row, each summing its 8-column chunks in order, then the
// 16 lanes' butterfly (a fixed order)
template <typename T>
__global__ void __launch_bounds__(DSUM_THREADS)
    flash_bwd_dsum(const T* __restrict__ o, const T* __restrict__ dout,
                   float* __restrict__ dsum, long long rows, int S, int H,
                   int dh) {
  const long long row =
      (long long)blockIdx.x * (DSUM_THREADS / 16) + threadIdx.x / 16;
  const int sub = threadIdx.x % 16;
  float acc = 0.f;
  if (row < rows)
    for (int c = sub * 8; c < dh; c += 128) {
      float a[8], d[8];
      load8(a, o + row * dh + c);
      load8(d, dout + row * dh + c);
      acc = dot8(d, a, acc);
    }
#pragma unroll
  for (int off = 8; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && sub == 0) {
    const long long bs = row / H;
    const int h = (int)(row % H);
    const long long b = bs / S;
    const int s = (int)(bs % S);
    dsum[((size_t)b * H + h) * S + s] = acc;
  }
}

// ---- the mma route (bf16, f16) ---------------------------------------------

constexpr int BWD_THREADS = 128;  // 4 warps
constexpr int DQ_BQ = 64;         // positions of a dq block (16 a warp)
constexpr int DQ_BK = 32;         // keys of a dq k/v tile
constexpr int KV_BK = 64;         // keys of a dkdv block (16 a warp)
constexpr int KV_BR = 32;         // positions of a dkdv q/do tile

template <int DHP>
struct BwdCfg {
  static constexpr int STR = DHP + 8;  // shared row stride: ldmatrix without
                                       // bank conflicts
  static constexpr int DQ_STAGE = 2 * DQ_BK * STR;  // k and v of a tile
  static constexpr int DQ_SMEM = 2 * DQ_STAGE * 2;  // two stages, bytes
  static constexpr int KV_KV = 2 * KV_BK * STR;     // the block's k and v
  static constexpr int KV_STAGE = 2 * KV_BR * STR;  // q and do of a tile
  static constexpr int KV_SMEM =
      (KV_KV + 2 * KV_STAGE) * 2 + 2 * 2 * KV_BR * 4;  // + lse, D per stage
};

// rows [r0, r0 + R) of a (B, n_rows, heads, dh) tensor at head `head` into
// shared memory (row stride DHP + 8); rows at or past `limit` and columns
// past dh are zero-filled without a read
template <typename T, int DHP, int R>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          int b, int r0, int n_rows,
                                          int heads, int head, int dh,
                                          int limit) {
  constexpr int STR = DHP + 8;
  for (int c = threadIdx.x; c < R * DHP / 8; c += BWD_THREADS) {
    int r = c / (DHP / 8), dc = (c % (DHP / 8)) * 8;
    int rr = r0 + r;
    bool ok = rr < limit && dc < dh;
    size_t off = ok ? (((size_t)b * n_rows + rr) * heads + head) * dh + dc : 0;
    cp_async16(dst + r * STR + dc, src + off, ok);
  }
}

// A fragments (16 rows x DHP) of a (B, S, H, dh) tensor's rows at positions
// pos[0], pos[1] (this thread's rows g and g + 8), zero past S or dh
template <typename T, int DHP>
__device__ __forceinline__ void row_frags(uint32_t (&a)[DHP / 16][4],
                                          const T* __restrict__ x, int b,
                                          const int* pos, int S, int H, int h,
                                          int dh, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bool ok = pos[i] < S;
    const T* xr = x + (((size_t)b * S + (ok ? pos[i] : 0)) * H + h) * dh + 2 * t;
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      bool lo = ok && kk * 16 + 2 * t < dh;
      bool hi = ok && kk * 16 + 8 + 2 * t < dh;
      a[kk][i] = lo ? *reinterpret_cast<const uint32_t*>(xr + kk * 16) : 0u;
      a[kk][2 + i] =
          hi ? *reinterpret_cast<const uint32_t*>(xr + kk * 16 + 8) : 0u;
    }
  }
}

// sc (16 rows x DQ_BK keys) = rows' A fragments @ X^T, X a (key, d) tile in
// shared memory (the B fragments by ldmatrix: two key n-tiles per call)
template <typename T, int DHP>
__device__ __forceinline__ void rows_by_keys(float (&sc)[DQ_BK / 8][4],
                                             const uint32_t (&a)[DHP / 16][4],
                                             const T* Xs, int lane) {
  constexpr int STR = DHP + 8;
#pragma unroll
  for (int nt = 0; nt < DQ_BK / 8; ++nt)
    sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
  const int mi = lane / 8;
#pragma unroll
  for (int nt = 0; nt < DQ_BK / 8; nt += 2) {
    const T* xr = Xs + ((nt + mi / 2) * 8 + lane % 8) * STR + (mi % 2) * 8;
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      uint32_t r[4];
      ldmatrix_x4(r, xr + kk * 16);
      mma16816<T>(sc[nt], a[kk], r[0], r[1]);
      mma16816<T>(sc[nt + 1], a[kk], r[2], r[3]);
    }
  }
}

// grid (ceil(S / DQ_BQ), B * H). Warp w owns positions s0 + 16 w + g and
// + 8 (g = lane / 4), as the forward's mma route owns its rows. For each
// key tile at or below the diagonal: s, dS = P * (dP - D), dq += dS k.
template <typename T, int DHP>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 T* __restrict__ dq, const float* __restrict__ lse,
                 const float* __restrict__ dsum, int S, int H, int Hkv,
                 int T_, int dh, int t_real, int causal, float scale_log2,
                 float scale) {
  typedef BwdCfg<DHP> C;
  constexpr int STR = C::STR;
  constexpr int NK = DQ_BK / 8;   // score n-tiles
  constexpr int ND = DHP / 8;     // dq n-tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int s0 = blockIdx.x * DQ_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, mi = lane / 8;
  int pos[2] = {s0 + warp * 16 + g, s0 + warp * 16 + g + 8};

  uint32_t qa[DHP / 16][4], da[DHP / 16][4];
  row_frags<T, DHP>(qa, q, b, pos, S, H, h, dh, t);
  row_frags<T, DHP>(da, dout, b, pos, S, H, h, dh, t);
  float lse2[2], Dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t idx = ((size_t)b * H + h) * S + pos[i];
    lse2[i] = lse_log2(lse, idx, pos[i] < S);
    Dr[i] = pos[i] < S ? dsum[idx] : 0.f;
  }

  const int last = min(s0 + DQ_BQ, S) - 1;
  int kv_limit = t_real;
  if (causal) kv_limit = min(kv_limit, last + 1);
  const int n_tiles = (kv_limit + DQ_BK - 1) / DQ_BK;

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  if (n_tiles > 0) {
    load_rows<T, DHP, DQ_BK>(ring, k, b, 0, T_, Hkv, hk, dh, t_real);
    load_rows<T, DHP, DQ_BK>(ring + DQ_BK * STR, v, b, 0, T_, Hkv, hk, dh,
                             t_real);
  }
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      T* nxt = ring + ((it + 1) % 2) * C::DQ_STAGE;
      load_rows<T, DHP, DQ_BK>(nxt, k, b, (it + 1) * DQ_BK, T_, Hkv, hk, dh,
                               t_real);
      load_rows<T, DHP, DQ_BK>(nxt + DQ_BK * STR, v, b, (it + 1) * DQ_BK, T_,
                               Hkv, hk, dh, t_real);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Ks = ring + (it % 2) * C::DQ_STAGE;
    const T* Vs = Ks + DQ_BK * STR;
    float sc[NK][4], dp[NK][4];
    rows_by_keys<T, DHP>(sc, qa, Ks, lane);
    rows_by_keys<T, DHP>(dp, da, Vs, lane);
    const int kv0 = it * DQ_BK;
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int kp = kv0 + nt * 8 + 2 * t + (j & 1);
        int qp = (j >> 1) ? pos[1] : pos[0];
        bool keep = kp < t_real && !(causal && kp > qp);
        float p = keep ? exp2f(sc[nt][j] * scale_log2 - lse2[j >> 1]) : 0.f;
        sc[nt][j] = p * (dp[nt][j] - Dr[j >> 1]);  // dS
      }
    // dq += dS @ k: two score n-tiles are one 16-key A fragment; k's B
    // fragments by ldmatrix.trans (k is (key, d): keys are the k dimension)
#pragma unroll
    for (int ks = 0; ks < DQ_BK / 16; ++ks) {
      uint32_t pa[4] = {Elem<T>::pack(sc[2 * ks][0], sc[2 * ks][1]),
                        Elem<T>::pack(sc[2 * ks][2], sc[2 * ks][3]),
                        Elem<T>::pack(sc[2 * ks + 1][0], sc[2 * ks + 1][1]),
                        Elem<T>::pack(sc[2 * ks + 1][2], sc[2 * ks + 1][3])};
      const T* kr = Ks + (ks * 16 + (mi % 2) * 8 + lane % 8) * STR + (mi / 2) * 8;
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, kr + nd * 8);
        mma16816<T>(acc[nd], pa, r[0], r[1]);
        mma16816<T>(acc[nd + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (pos[i] >= S) continue;
    T* row = dq + (((size_t)b * S + pos[i]) * H + h) * dh;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      int c = nd * 8 + 2 * t;
      if (c < dh) {  // dh is a multiple of 8: c + 1 < dh too
        put(row + c, acc[nd][2 * i] * scale);
        put(row + c + 1, acc[nd][2 * i + 1] * scale);
      }
    }
  }
}

// grid (ceil(T / KV_BK), B * H). Warp w owns keys kv0 + 16 w + g and + 8;
// the block walks the row tiles of query head h that can attend its keys.
template <typename T, int DHP>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dsum,
                   float* __restrict__ dk_part, float* __restrict__ dv_part,
                   int S, int H, int Hkv, int T_, int dh, int t_real,
                   int causal, float scale_log2, float scale) {
  typedef BwdCfg<DHP> C;
  constexpr int STR = C::STR;
  constexpr int NR = KV_BR / 8;  // score n-tiles (positions)
  constexpr int ND = DHP / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + KV_BK * STR;
  T* ring = Vs + KV_BK * STR;
  float* stats = reinterpret_cast<float*>(ring + 2 * C::KV_STAGE);

  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int kv0 = blockIdx.x * KV_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, mi = lane / 8;
  const int key[2] = {kv0 + warp * 16 + g, kv0 + warp * 16 + g + 8};

  load_rows<T, DHP, KV_BK>(Ks, k, b, kv0, T_, Hkv, hk, dh, t_real);
  load_rows<T, DHP, KV_BK>(Vs, v, b, kv0, T_, Hkv, hk, dh, t_real);
  cp_async_commit();

  // the positions that attend a key of this block: all of [0, S), or under
  // the causal mask [kv0, S); none when every key is at or past t_real
  const int first = causal ? kv0 : 0;
  const int tile0 = first / KV_BR;
  int n_tiles = (S + KV_BR - 1) / KV_BR - tile0;
  if (kv0 >= t_real || first >= S) n_tiles = 0;

  auto load_tile = [&](int it) {
    T* Qs = ring + (it % 2) * C::KV_STAGE;
    const int r0 = (tile0 + it) * KV_BR;
    load_rows<T, DHP, KV_BR>(Qs, q, b, r0, S, H, h, dh, S);
    load_rows<T, DHP, KV_BR>(Qs + KV_BR * STR, dout, b, r0, S, H, h, dh, S);
    float* st = stats + (it % 2) * 2 * KV_BR;
    for (int r = threadIdx.x; r < KV_BR; r += BWD_THREADS) {
      const int s = r0 + r;
      const size_t idx = ((size_t)b * H + h) * S + s;
      st[r] = lse_log2(lse, idx, s < S);  // P = 0 past S
      st[KV_BR + r] = s < S ? dsum[idx] : 0.f;
    }
  };

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[nd][j] = dv[nd][j] = 0.f;

  if (n_tiles > 0) load_tile(0);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_tile(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Qs = ring + (it % 2) * C::KV_STAGE;
    const T* Ds = Qs + KV_BR * STR;
    const float* lse2 = stats + (it % 2) * 2 * KV_BR;
    const float* Dv = lse2 + KV_BR;
    const int r0 = (tile0 + it) * KV_BR;

    // S^T = k q^T and dP^T = v do^T (16 keys x KV_BR positions a warp): k
    // and v as A fragments (ldmatrix, rows = keys), q and do as B fragments
    float st[NR][4], dpt[NR][4];
#pragma unroll
    for (int nt = 0; nt < NR; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[nt][j] = dpt[nt][j] = 0.f;
    const int arow = warp * 16 + (mi % 2) * 8 + lane % 8;
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, Ks + arow * STR + kk * 16 + (mi / 2) * 8);
      ldmatrix_x4(va, Vs + arow * STR + kk * 16 + (mi / 2) * 8);
#pragma unroll
      for (int nt = 0; nt < NR; nt += 2) {
        const int brow = ((nt + mi / 2) * 8 + lane % 8) * STR + kk * 16 +
                         (mi % 2) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, Qs + brow);
        mma16816<T>(st[nt], ka, r[0], r[1]);
        mma16816<T>(st[nt + 1], ka, r[2], r[3]);
        ldmatrix_x4(r, Ds + brow);
        mma16816<T>(dpt[nt], va, r[0], r[1]);
        mma16816<T>(dpt[nt + 1], va, r[2], r[3]);
      }
    }
    // P^T and dS^T in place
#pragma unroll
    for (int nt = 0; nt < NR; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = nt * 8 + 2 * t + (j & 1);
        const int qp = r0 + col;
        const int kp = key[j >> 1];
        bool keep = kp < t_real && !(causal && kp > qp);
        float p = keep ? exp2f(st[nt][j] * scale_log2 - lse2[col]) : 0.f;
        st[nt][j] = p;
        dpt[nt][j] = p * (dpt[nt][j] - Dv[col]);
      }
    // dv += P^T do and dk += dS^T q: two position n-tiles are one 16-deep
    // A fragment; do and q as B fragments by ldmatrix.trans
#pragma unroll
    for (int ks = 0; ks < KV_BR / 16; ++ks) {
      uint32_t pa[4] = {Elem<T>::pack(st[2 * ks][0], st[2 * ks][1]),
                        Elem<T>::pack(st[2 * ks][2], st[2 * ks][3]),
                        Elem<T>::pack(st[2 * ks + 1][0], st[2 * ks + 1][1]),
                        Elem<T>::pack(st[2 * ks + 1][2], st[2 * ks + 1][3])};
      uint32_t sa[4] = {Elem<T>::pack(dpt[2 * ks][0], dpt[2 * ks][1]),
                        Elem<T>::pack(dpt[2 * ks][2], dpt[2 * ks][3]),
                        Elem<T>::pack(dpt[2 * ks + 1][0], dpt[2 * ks + 1][1]),
                        Elem<T>::pack(dpt[2 * ks + 1][2], dpt[2 * ks + 1][3])};
      const int trow = (ks * 16 + (mi % 2) * 8 + lane % 8) * STR + (mi / 2) * 8;
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Ds + trow + nd * 8);
        mma16816<T>(dv[nd], pa, r[0], r[1]);
        mma16816<T>(dv[nd + 1], pa, r[2], r[3]);
        ldmatrix_x4_trans(r, Qs + trow + nd * 8);
        mma16816<T>(dk[nd], sa, r[0], r[1]);
        mma16816<T>(dk[nd + 1], sa, r[2], r[3]);
      }
    }
    __syncthreads();  // this stage is refilled next iteration
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= T_) continue;
    const size_t row = (((size_t)b * T_ + key[i]) * H + h) * dh;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      int c = nd * 8 + 2 * t;
      if (c < dh) {
        *reinterpret_cast<float2*>(dk_part + row + c) =
            make_float2(dk[nd][2 * i] * scale, dk[nd][2 * i + 1] * scale);
        *reinterpret_cast<float2*>(dv_part + row + c) =
            make_float2(dv[nd][2 * i], dv[nd][2 * i + 1]);
      }
    }
  }
}

// dk, dv (B, T, Hkv, dh) = the partials (B, T, Hkv * P, dh) summed over the
// P partials of each kv head in the order 0 .. P - 1, rounded to T
template <typename T>
__global__ void flash_bwd_reduce(const float* __restrict__ dk_part,
                                 const float* __restrict__ dv_part,
                                 T* __restrict__ dk, T* __restrict__ dv,
                                 long long n, int P, int Hkv, int dh) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int d = (int)(idx % dh);
  const long long rest = idx / dh;  // (b * T + t) * Hkv + hk
  const size_t base = (size_t)rest * P * dh + d;
  float sk = 0.f, sv = 0.f;
  for (int pp = 0; pp < P; ++pp) {
    sk += dk_part[base + (size_t)pp * dh];
    sv += dv_part[base + (size_t)pp * dh];
  }
  put(dk + idx, sk);
  put(dv + idx, sv);
}

// ---- the f32 and wide routes (SIMT) -----------------------------------------

constexpr int F_THREADS = 256;  // 8 warps
constexpr int F_BQ = 16;        // positions of a dq block (2 a warp)
constexpr int F_BK = 32;        // keys of a dq k/v tile (one a lane)
constexpr int F_KB = 16;        // keys of a dkdv block (2 a warp)
constexpr int F_BR = 32;        // positions of a dkdv tile (one a lane)
constexpr int F_DH = 128;       // the columns of a chunk

struct FCfg {
  // dq: q, do (F_BQ x F_DH), k, v (F_BK x F_DH + 1)
  static constexpr int DQ_SMEM = (2 * F_BQ * F_DH + 2 * F_BK * (F_DH + 1)) * 4;
  // dkdv: k, v (F_KB x F_DH), q, do (F_BR x F_DH + 1), lse and D (F_BR)
  static constexpr int KV_SMEM =
      (2 * F_KB * F_DH + 2 * F_BR * (F_DH + 1) + 2 * F_BR) * 4;
};

// rows [r0, r0 + R) of x (B, n, heads, dh) at `head`, columns [d0, d0 + w),
// as f32 into dst (row stride `str`); rows at or past `limit` are zeros
template <typename T>
__device__ __forceinline__ void stage_f32(float* dst, int str,
                                          const T* __restrict__ x, int b,
                                          int n, int heads, int head, int dh,
                                          int r0, int R, int d0, int w,
                                          int limit) {
  for (int idx = threadIdx.x; idx < R * w; idx += F_THREADS) {
    const int r = idx / w, d = idx % w, rr = r0 + r;
    dst[r * str + d] =
        rr < limit ? to_f(x[(((size_t)b * n + rr) * heads + head) * dh + d0 + d])
                   : 0.f;
  }
}

// grid (ceil(S / F_BQ), B * H, ceil(dh / 128)): warp w owns positions s0 + 2
// w and + 1; for the scores lane j takes key j of a tile, summed over every
// 128-column chunk of dh; block z writes dq's columns [128 z, 128 z + 128),
// lane j columns j + 32 c of them
template <typename T>
__global__ void __launch_bounds__(F_THREADS)
    flash_bwd_dq_simt(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      T* __restrict__ dq, const float* __restrict__ lse,
                      const float* __restrict__ dsum, int S, int H, int Hkv,
                      int T_, int dh, int t_real, int causal,
                      float scale_log2, float scale) {
  extern __shared__ float fs[];
  float* qs = fs;                       // [F_BQ][F_DH]
  float* dos = qs + F_BQ * F_DH;        // [F_BQ][F_DH]
  float* ks = dos + F_BQ * F_DH;        // [F_BK][F_DH + 1]
  float* vs = ks + F_BK * (F_DH + 1);   // [F_BK][F_DH + 1]
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int s0 = blockIdx.x * F_BQ, col0 = blockIdx.z * F_DH;
  const int nd = (dh + F_DH - 1) / F_DH, wv = min(F_DH, dh - col0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  int pos[2] = {s0 + 2 * warp, s0 + 2 * warp + 1};
  float lse2[2], Dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t idx = ((size_t)b * H + h) * S + pos[i];
    lse2[i] = lse_log2(lse, idx, pos[i] < S);
    Dr[i] = pos[i] < S ? dsum[idx] : 0.f;
  }
  const int last = min(s0 + F_BQ, S) - 1;
  int kv_limit = t_real;
  if (causal) kv_limit = min(kv_limit, last + 1);

  float acc[2][F_DH / 32] = {};
  for (int kv0 = 0; kv0 < kv_limit; kv0 += F_BK) {
    float sd[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f};
    for (int c = 0; c < nd; ++c) {
      const int d0 = c * F_DH, w = min(F_DH, dh - d0);
      __syncthreads();  // the previous chunk or tile is consumed
      if (nd > 1 || kv0 == 0) {
        stage_f32(qs, F_DH, q, b, S, H, h, dh, s0, F_BQ, d0, w, S);
        stage_f32(dos, F_DH, dout, b, S, H, h, dh, s0, F_BQ, d0, w, S);
      }
      stage_f32(ks, F_DH + 1, k, b, T_, Hkv, hk, dh, kv0, F_BK, d0, w, t_real);
      stage_f32(vs, F_DH + 1, v, b, T_, Hkv, hk, dh, kv0, F_BK, d0, w, t_real);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* qr = qs + (2 * warp + i) * F_DH;
        const float* dr = dos + (2 * warp + i) * F_DH;
        const float* kr = ks + lane * (F_DH + 1);
        const float* vr = vs + lane * (F_DH + 1);
        for (int d = 0; d < w; ++d) {
          sd[i] = fmaf(qr[d], kr[d], sd[i]);
          pd[i] = fmaf(dr[d], vr[d], pd[i]);
        }
      }
    }
    if (nd > 1 && (int)blockIdx.z != nd - 1) {  // k's columns of this block
      __syncthreads();
      stage_f32(ks, F_DH + 1, k, b, T_, Hkv, hk, dh, kv0, F_BK, col0, wv,
                t_real);
      __syncthreads();
    }
    const int kp = kv0 + lane;
    float ds[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bool keep = kp < t_real && !(causal && kp > pos[i]);
      float p = keep ? exp2f(sd[i] * scale_log2 - lse2[i]) : 0.f;
      ds[i] = p * (pd[i] - Dr[i]);
    }
    for (int j = 0; j < F_BK; ++j) {
      float d0 = __shfl_sync(0xffffffffu, ds[0], j);
      float d1 = __shfl_sync(0xffffffffu, ds[1], j);
#pragma unroll
      for (int c = 0; c < F_DH / 32; ++c) {
        float x = ks[j * (F_DH + 1) + lane + 32 * c];  // past wv: never stored
        acc[0][c] = fmaf(d0, x, acc[0][c]);
        acc[1][c] = fmaf(d1, x, acc[1][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (pos[i] >= S) continue;
    T* row = dq + (((size_t)b * S + pos[i]) * H + h) * dh + col0;
#pragma unroll
    for (int c = 0; c < F_DH / 32; ++c)
      if (lane + 32 * c < wv) put(row + lane + 32 * c, acc[i][c] * scale);
  }
}

// grid (ceil(T / F_KB), B * H, ceil(dh / 128)): warp w owns keys kv0 + 2 w
// and + 1; lane j takes position j of a row tile for the scores (summed over
// every chunk), columns col0 + j + 32 c for dk, dv
template <typename T>
__global__ void __launch_bounds__(F_THREADS)
    flash_bwd_dkdv_simt(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        float* __restrict__ dk_part,
                        float* __restrict__ dv_part, int S, int H, int Hkv,
                        int T_, int dh, int t_real, int causal,
                        float scale_log2, float scale) {
  extern __shared__ float fs[];
  float* ks = fs;                        // [F_KB][F_DH]
  float* vs = ks + F_KB * F_DH;          // [F_KB][F_DH]
  float* qs = vs + F_KB * F_DH;          // [F_BR][F_DH + 1]
  float* dos = qs + F_BR * (F_DH + 1);   // [F_BR][F_DH + 1]
  float* lse2 = dos + F_BR * (F_DH + 1); // [F_BR]
  float* Dv = lse2 + F_BR;               // [F_BR]
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int kv0 = blockIdx.x * F_KB, col0 = blockIdx.z * F_DH;
  const int nd = (dh + F_DH - 1) / F_DH, wv = min(F_DH, dh - col0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int first = causal ? kv0 : 0;
  const bool any = kv0 < t_real && first < S;
  const int r_first = (first / F_BR) * F_BR;
  float dk[2][F_DH / 32] = {}, dv[2][F_DH / 32] = {};
  for (int r0 = r_first; any && r0 < S; r0 += F_BR) {
    float sd[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f};
    for (int c = 0; c < nd; ++c) {
      const int d0 = c * F_DH, w = min(F_DH, dh - d0);
      __syncthreads();  // the previous chunk or tile is consumed
      if (nd > 1 || r0 == r_first) {
        stage_f32(ks, F_DH, k, b, T_, Hkv, hk, dh, kv0, F_KB, d0, w, t_real);
        stage_f32(vs, F_DH, v, b, T_, Hkv, hk, dh, kv0, F_KB, d0, w, t_real);
      }
      stage_f32(qs, F_DH + 1, q, b, S, H, h, dh, r0, F_BR, d0, w, S);
      stage_f32(dos, F_DH + 1, dout, b, S, H, h, dh, r0, F_BR, d0, w, S);
      if (c == 0)
        for (int r = threadIdx.x; r < F_BR; r += F_THREADS) {
          const int s = r0 + r;
          const size_t idx = ((size_t)b * H + h) * S + s;
          lse2[r] = lse_log2(lse, idx, s < S);
          Dv[r] = s < S ? dsum[idx] : 0.f;
        }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* kr = ks + (2 * warp + i) * F_DH;
        const float* vr = vs + (2 * warp + i) * F_DH;
        const float* qr = qs + lane * (F_DH + 1);
        const float* dr = dos + lane * (F_DH + 1);
        for (int d = 0; d < w; ++d) {
          sd[i] = fmaf(kr[d], qr[d], sd[i]);
          pd[i] = fmaf(vr[d], dr[d], pd[i]);
        }
      }
    }
    if (nd > 1 && (int)blockIdx.z != nd - 1) {  // q's, do's columns here
      __syncthreads();
      stage_f32(qs, F_DH + 1, q, b, S, H, h, dh, r0, F_BR, col0, wv, S);
      stage_f32(dos, F_DH + 1, dout, b, S, H, h, dh, r0, F_BR, col0, wv, S);
      __syncthreads();
    }
    const int qp = r0 + lane;
    float p[2], ds[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kp = kv0 + 2 * warp + i;
      bool keep = kp < t_real && !(causal && kp > qp);
      p[i] = keep ? exp2f(sd[i] * scale_log2 - lse2[lane]) : 0.f;
      ds[i] = p[i] * (pd[i] - Dv[lane]);
    }
    for (int j = 0; j < F_BR; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float pj = __shfl_sync(0xffffffffu, p[i], j);
        float dsj = __shfl_sync(0xffffffffu, ds[i], j);
#pragma unroll
        for (int c = 0; c < F_DH / 32; ++c) {
          dv[i][c] = fmaf(pj, dos[j * (F_DH + 1) + lane + 32 * c], dv[i][c]);
          dk[i][c] = fmaf(dsj, qs[j * (F_DH + 1) + lane + 32 * c], dk[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = kv0 + 2 * warp + i;
    if (kp >= T_) continue;
    const size_t row = (((size_t)b * T_ + kp) * H + h) * dh + col0;
#pragma unroll
    for (int c = 0; c < F_DH / 32; ++c)
      if (lane + 32 * c < wv) {
        dk_part[row + lane + 32 * c] = dk[i][c] * scale;
        dv_part[row + lane + 32 * c] = dv[i][c];
      }
  }
}

// ---- the wgmma route (TMA + wgmma, warp-specialised) -----------------------

constexpr int W_ROW = 128;   // bytes of a 64-column box row (128-byte swizzle)
constexpr int W_BR = 64;     // rows of a dK/dV q/do tile
constexpr int W_BK = 64;     // keys of a consumer warpgroup; of a dq k/v tile
constexpr int W_BQ = 128;    // rows of a dq block (two consumer warpgroups)
constexpr int W_STAGES = 2;  // the q/do ring (dK/dV) and k/v ring (dq)

// D (64 x DH) += A (64 x 16, registers) B (16 x DH, shared, MN-major: DH
// columns in 64-column boxes `box` bytes apart)
template <bool F16, int DH>
__device__ __forceinline__ void rs_acc(float (&d)[DH / 2],
                                       const uint32_t (&a)[4],
                                       const uint8_t* b, uint32_t box) {
  if constexpr (DH == 128)
    sm90::wgmma_rs_m64n128<F16, 1>(d, a, sm90::desc_mnmajor(b, box), 1);
  else
    sm90::wgmma_rs_m64n64<F16, 1>(d, a, sm90::desc_mnmajor(b, box), 1);
}

// D (64 x 64) = A (64 rows x DH, K-major, boxes `abox` apart) B^T (64 rows
// x DH, K-major, boxes `bbox` apart)
template <bool F16, int DH>
__device__ __forceinline__ void ss_rows(float (&d)[32], const uint8_t* a,
                                        uint32_t abox, const uint8_t* b,
                                        uint32_t bbox) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    sm90::wgmma_ss_m64n64<F16>(
        d, sm90::desc_kmajor(a + (kk / 4) * abox + (kk % 4) * 32),
        sm90::desc_kmajor(b + (kk / 4) * bbox + (kk % 4) * 32), kk > 0);
}

// the k16 step j of a 64 x 64 accumulator as wgmma's register A operand
template <typename T>
__device__ __forceinline__ void a_frags(uint32_t (&a)[4][4],
                                        const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h)
      a[j][h] = Elem<T>::pack(x[8 * j + 2 * h], x[8 * j + 2 * h + 1]);
}

// keep `a`'s registers (an RS wgmma's A operand, read until the wgmma
// completes) out of the compiler's hands until this point
__device__ __forceinline__ void keep_regs(const uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 4; ++h) asm volatile("" ::"r"(a[j][h]) : "memory");
}

template <int DH>
struct DkvCfg {
  static constexpr int NBOX = DH / 64;
  static constexpr int THREADS = 256;  // two consumer warpgroups
  static constexpr int K_BOX = 2 * W_BK * W_ROW;  // one 64-column box of K
  static constexpr int K_BYTES = NBOX * K_BOX;
  static constexpr int Q_BOX = W_BR * W_ROW;      // 8 KB
  static constexpr int Q_BYTES = NBOX * Q_BOX;
  static constexpr int STAGE = 2 * Q_BYTES;       // q and do of a tile
  static constexpr int SMEM =
      2 * K_BYTES + W_STAGES * STAGE + W_STAGES * 2 * W_BR * 4 + 1024;
};

// One block per (128-key tile, b, kv head hk, head group grp), key tiles
// from position 0 first (the heaviest under the causal mask). Consumer
// warpgroup wg holds dK and dV of keys kv0 + 64 wg .. + 63 (64 x DH each)
// beside S^T and dP^T and runs the four products of every q/do tile, which
// both warpgroups share; warp 0 also produces: it fills the ring before
// the loop and, once both warpgroups are done with a tile, loads the tile
// W_STAGES on into its stage. There is no producer warp because ptxas
// allocates registers to a block in whole warpgroups: 256 threads give each
// consumer its 253 registers, and any ninth warp cuts every thread to 168
// (setmaxnreg did not lift that), which spilled. The maps: q, do as (dh,
// H, S, B) boxes of (64, Gg, 64 / Gg, 1); k, v as (dh, Hkv, t_real, B)
// boxes of (64, 1, 128, 1). Row r of a tile is position p0 + r / Gg of
// query head hk * G + grp * Gg + r % Gg. With one group dk and dv are
// written in T; else f32 partials (B, T, Hkv * groups, dh) at partial
// hk * groups + grp.
template <typename T, int DH>
__global__ void __launch_bounds__(DkvCfg<DH>::THREADS, 1)
    flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum, T* __restrict__ dk,
                         T* __restrict__ dv, float* __restrict__ dk_part,
                         float* __restrict__ dv_part, int S, int H, int Hkv,
                         int T_, int t_real, int causal, int groups,
                         int lg_gg, float scale_log2, float scale) {
  typedef DkvCfg<DH> C;
  constexpr bool F16 = Elem<T>::F16;
  constexpr int BK = 2 * W_BK;  // keys of a block
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, full[W_STAGES], empty[W_STAGES];
  uint8_t* base =
      smem_raw + ((1024 - sm90::smem_addr(smem_raw) % 1024) % 1024);
  uint8_t* ks = base;
  uint8_t* vs = ks + C::K_BYTES;
  uint8_t* ring = vs + C::K_BYTES;
  float* stats = reinterpret_cast<float*>(ring + W_STAGES * C::STAGE);

  const int BHG = (int)(gridDim.x / ((T_ + BK - 1) / BK));
  const int ktile = blockIdx.x / BHG, rest = blockIdx.x % BHG;
  const int b = rest / (Hkv * groups), hk = (rest / groups) % Hkv,
            grp = rest % groups;
  const int G = H / Hkv, Gg = G / groups, P = W_BR / Gg;
  const int h0 = hk * G + grp * Gg;
  const int kv0 = ktile * BK;
  const int first = causal ? kv0 : 0;
  const int t0 = first / P;
  int n_tiles = (S + P - 1) / P - t0;
  if (kv0 >= t_real || first >= S) n_tiles = 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&kv_full, 1);
#pragma unroll
    for (int s = 0; s < W_STAGES; ++s) {
      sm90::mbar_init(&full[s], 33);  // warp 0's 32 lanes + expect_tx
      sm90::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const bool producer = threadIdx.x < 32;
  // warp 0: the q/do tile `it` with its rows' lse and D into its stage,
  // each lane releasing its own stats writes
  auto produce = [&](int it) {
    const int stage = it % W_STAGES;
    const int p0 = (t0 + it) * P;
    float* st = stats + stage * 2 * W_BR;
    for (int r = lane; r < W_BR; r += 32) {
      const int s = p0 + (r >> lg_gg), h = h0 + (r & (Gg - 1));
      const size_t idx = ((size_t)b * H + h) * S + s;
      st[r] = lse_log2(lse, idx, s < S);
      st[W_BR + r] = s < S ? dsum[idx] : 0.f;
    }
    sm90::mbar_arrive(&full[stage]);
    if (lane == 0) {
      uint8_t* qt = ring + stage * C::STAGE;
      sm90::mbar_expect_tx(&full[stage], C::STAGE);
#pragma unroll
      for (int x = 0; x < C::NBOX; ++x) {
        sm90::tma_load_4d(qt + x * C::Q_BOX, &tq, &full[stage], x * 64, h0,
                          p0, b);
        sm90::tma_load_4d(qt + C::Q_BYTES + x * C::Q_BOX, &tdo, &full[stage],
                          x * 64, h0, p0, b);
      }
    }
    __syncwarp();
  };
  if (producer) {
    if (lane == 0 && n_tiles > 0) {
      sm90::mbar_expect_tx(&kv_full, 2 * C::K_BYTES);
#pragma unroll
      for (int x = 0; x < C::NBOX; ++x) {
        sm90::tma_load_4d(ks + x * C::K_BOX, &tk, &kv_full, x * 64, hk, kv0,
                          b);
        sm90::tma_load_4d(vs + x * C::K_BOX, &tv, &kv_full, x * 64, hk, kv0,
                          b);
      }
    }
    for (int it = 0; it < min(n_tiles, W_STAGES); ++it) produce(it);
  }

  // consumer warpgroup wg: keys kv0 + 64 wg .. + 63
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int g = lane / 4, c = lane % 4;
  const int key0 = kv0 + wg * W_BK + 16 * warp + g;  // and + 8
  const uint8_t* kw = ks + wg * W_BK * W_ROW;
  const uint8_t* vw = vs + wg * W_BK * W_ROW;
  float dka[DH / 2], dva[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dka[i] = dva[i] = 0.f;
  if (n_tiles > 0) sm90::mbar_wait(&kv_full, 0);
  const bool key_mask = kv0 + BK > t_real;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % W_STAGES;
    const int p0 = (t0 + it) * P;
    const uint8_t* qt = ring + stage * C::STAGE;
    const uint8_t* dot = qt + C::Q_BYTES;
    const float* lse2 = stats + stage * 2 * W_BR;
    const float* Dv = lse2 + W_BR;

    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
    sm90::mbar_wait(&full[stage], (it / W_STAGES) & 1);
    sm90::wgmma_fence();
    ss_rows<F16, DH>(st, kw, C::K_BOX, qt, C::Q_BOX);    // S^T = K Q^T
    sm90::wgmma_commit();
    ss_rows<F16, DH>(dpt, vw, C::K_BOX, dot, C::Q_BOX);  // dP^T = V dO^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_regs(st);

    // element i: key key0 + 8 ((i / 2) % 2), tile row 8 (i / 4) + 2c + i % 2
    const bool need_mask = key_mask || (causal && kv0 + BK - 1 > p0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + 2 * c + (i % 2);
      float p = ex2(fmaf(st[i], scale_log2, -lse2[col]));
      if (need_mask) {
        const int kp = key0 + 8 * ((i / 2) % 2);
        const int qp = p0 + (col >> lg_gg);
        if (kp >= t_real || (causal && kp > qp)) p = 0.f;
      }
      st[i] = p;
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dpt);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + 2 * c + (i % 2);
      dpt[i] = st[i] * (dpt[i] - Dv[col]);  // dS^T
    }
    uint32_t pa[4][4], sa[4][4];
    a_frags<T>(pa, st);
    a_frags<T>(sa, dpt);

    sm90::fence_regs(dva);
    sm90::fence_regs(dka);
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < W_BR / 16; ++j)  // dV += P^T dO
      rs_acc<F16, DH>(dva, pa[j], dot + j * 16 * W_ROW, C::Q_BOX);
#pragma unroll
    for (int j = 0; j < W_BR / 16; ++j)  // dK += dS^T Q
      rs_acc<F16, DH>(dka, sa[j], qt + j * 16 * W_ROW, C::Q_BOX);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    keep_regs(pa);
    keep_regs(sa);
    sm90::fence_regs(dva);
    sm90::fence_regs(dka);
    if (lane == 0) sm90::mbar_arrive(&empty[stage]);
    if (producer && it + W_STAGES < n_tiles) {
      // both warpgroups are done with tile it: refill its stage
      sm90::mbar_wait(&empty[stage], (it / W_STAGES) & 1);
      produce(it + W_STAGES);
    }
  }

  // element i: key key0 + 8 ((i / 2) % 2), column 8 (i / 4) + 2c + i % 2
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = key0 + 8 * r;
    if (kp >= T_) continue;
    if (groups == 1) {
      T* krow = dk + (((size_t)b * T_ + kp) * Hkv + hk) * DH;
      T* vrow = dv + (((size_t)b * T_ + kp) * Hkv + hk) * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<uint32_t*>(krow + 8 * j + 2 * c) =
            Elem<T>::pack(dka[i] * scale, dka[i + 1] * scale);
        *reinterpret_cast<uint32_t*>(vrow + 8 * j + 2 * c) =
            Elem<T>::pack(dva[i], dva[i + 1]);
      }
    } else {
      const size_t row =
          (((size_t)b * T_ + kp) * Hkv + hk) * groups + grp;
      float* krow = dk_part + row * DH;
      float* vrow = dv_part + row * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<float2*>(krow + 8 * j + 2 * c) =
            make_float2(dka[i] * scale, dka[i + 1] * scale);
        *reinterpret_cast<float2*>(vrow + 8 * j + 2 * c) =
            make_float2(dva[i], dva[i + 1]);
      }
    }
  }
}

template <int DH>
struct DqCfg {
  static constexpr int NBOX = DH / 64;
  static constexpr int Q_BOX = W_BQ * W_ROW;   // 16 KB
  static constexpr int Q_BYTES = NBOX * Q_BOX;
  static constexpr int K_BOX = W_BK * W_ROW;   // 8 KB
  static constexpr int K_BYTES = NBOX * K_BOX;
  static constexpr int STAGE = 2 * K_BYTES;    // k and v of a tile
  static constexpr int SMEM = 2 * Q_BYTES + W_STAGES * STAGE + 1024;
};

// One block per (128-row tile, b, kv head), heaviest tiles first; rows as
// the forward's (128 / G positions x G heads). The maps: q, do as (dh, H,
// S, B) boxes of (64, G, 128 / G, 1); k, v as (dh, Hkv, t_real, B) boxes of
// (64, 1, 64, 1).
template <typename T, int DH>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const float* __restrict__ lse,
                       const float* __restrict__ dsum, T* __restrict__ dq,
                       int S, int H, int Hkv, int t_real, int causal,
                       float scale_log2, float scale, int q_tiles, int BHkv) {
  typedef DqCfg<DH> C;
  constexpr bool F16 = Elem<T>::F16;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t qd_full, kv_full[W_STAGES],
      kv_empty[W_STAGES];
  uint8_t* base =
      smem_raw + ((1024 - sm90::smem_addr(smem_raw) % 1024) % 1024);
  uint8_t* qs = base;
  uint8_t* dos = qs + C::Q_BYTES;
  uint8_t* ring = dos + C::Q_BYTES;

  const int tile = q_tiles - 1 - (int)(blockIdx.x / BHkv);
  const int bh = blockIdx.x % BHkv, b = bh / Hkv, hk = bh % Hkv;
  const int G = H / Hkv, rows = S * G;
  const int row0 = tile * W_BQ, s0 = row0 / G;  // G divides 128
  const int last_row = min(row0 + W_BQ, rows) - 1;
  int kv_limit = t_real;
  if (causal) kv_limit = min(kv_limit, last_row / G + 1);
  const int n_tiles = (kv_limit + W_BK - 1) / W_BK;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&qd_full, 1);
#pragma unroll
    for (int s = 0; s < W_STAGES; ++s) {
      sm90::mbar_init(&kv_full[s], 1);
      sm90::mbar_init(&kv_empty[s], 8);  // lane 0 of each consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: one thread keeps the ring full
    if (threadIdx.x == 256) {
      sm90::mbar_expect_tx(&qd_full, 2 * C::Q_BYTES);
#pragma unroll
      for (int x = 0; x < C::NBOX; ++x) {
        sm90::tma_load_4d(qs + x * C::Q_BOX, &tq, &qd_full, x * 64, hk * G,
                          s0, b);
        sm90::tma_load_4d(dos + x * C::Q_BOX, &tdo, &qd_full, x * 64, hk * G,
                          s0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int stage = it % W_STAGES;
        const uint32_t phase = (it / W_STAGES) & 1;
        sm90::mbar_wait(&kv_empty[stage], phase ^ 1);
        uint8_t* kt = ring + stage * C::STAGE;
        sm90::mbar_expect_tx(&kv_full[stage], C::STAGE);
#pragma unroll
        for (int x = 0; x < C::NBOX; ++x) {
          sm90::tma_load_4d(kt + x * C::K_BOX, &tk, &kv_full[stage], x * 64,
                            hk, it * W_BK, b);
          sm90::tma_load_4d(kt + C::K_BYTES + x * C::K_BOX, &tv,
                            &kv_full[stage], x * 64, hk, it * W_BK, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroups 0 and 1, 64 rows each (168 registers a thread
  // suffice: dQ, S and dP are 128 floats)
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int wrow0 = row0 + wg * 64 + 16 * warp + g;  // and + 8
  int qpos[2];
  float lse2[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int grow = wrow0 + 8 * r;
    const bool ok = grow < rows;
    const int s = ok ? grow / G : 0, h = hk * G + (ok ? grow % G : 0);
    qpos[r] = grow / G;
    const size_t idx = ((size_t)b * H + h) * S + s;
    lse2[r] = lse_log2(lse, idx, ok);
    Dr[r] = ok ? dsum[idx] : 0.f;
  }
  const uint8_t* qw = qs + wg * 64 * W_ROW;
  const uint8_t* dw = dos + wg * 64 * W_ROW;

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  sm90::mbar_wait(&qd_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % W_STAGES;
    const uint32_t phase = (it / W_STAGES) & 1;
    const int kv0 = it * W_BK;
    const uint8_t* kt = ring + stage * C::STAGE;
    const uint8_t* vt = kt + C::K_BYTES;

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::mbar_wait(&kv_full[stage], phase);
    sm90::wgmma_fence();
    ss_rows<F16, DH>(s, qw, C::Q_BOX, kt, C::K_BOX);   // S = Q K^T
    sm90::wgmma_commit();
    ss_rows<F16, DH>(dp, dw, C::Q_BOX, vt, C::K_BOX);  // dP = dO V^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_regs(s);

    // element i: row g + 8 ((i / 2) % 2), key kv0 + 8 (i / 4) + 2c + i % 2
    const bool need_mask =
        kv0 + W_BK > t_real || (causal && kv0 + W_BK - 1 > s0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float p = ex2(fmaf(s[i], scale_log2, -lse2[(i / 2) % 2]));
      if (need_mask) {
        const int kp = kv0 + 8 * (i / 4) + 2 * c + (i % 2);
        if (kp >= t_real || (causal && kp > qpos[(i / 2) % 2])) p = 0.f;
      }
      s[i] = p;
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - Dr[(i / 2) % 2]);
    uint32_t da[4][4];
    a_frags<T>(da, dp);

    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < W_BK / 16; ++j)  // dQ += dS K
      rs_acc<F16, DH>(acc, da[j], kt + j * 16 * W_ROW, C::K_BOX);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if (lane == 0) sm90::mbar_arrive(&kv_empty[stage]);
  }

  // epilogue: dq = scale * acc in T, through the (position, head) packing
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int grow = wrow0 + 8 * r;
    if (grow >= rows) continue;
    T* row = dq + (((size_t)b * S + grow / G) * H + hk * G + grow % G) * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int i = 4 * j + 2 * r;
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * c) =
          Elem<T>::pack(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

// ---- launches ----------------------------------------------------------------

template <typename T>
int launch_reduce(const float* dk_part, const float* dv_part, void* dk,
                  void* dv, int B, int P, int Hkv, int T_, int dh,
                  cudaStream_t st) {
  long long n = (long long)B * T_ * Hkv * dh;
  flash_bwd_reduce<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      dk_part, dv_part, static_cast<T*>(dk), static_cast<T*>(dv), n, P, Hkv,
      dh);
  return (int)cudaGetLastError();
}

// opt a kernel into `bytes` of dynamic shared memory and all of L1 as
// shared memory, once per device
template <typename K>
int smem_opt_in(K kern, int bytes, sm90::OptIn& rec) {
  return sm90::smem_opt_in(kern, bytes, true, rec);
}

template <typename T, int DHP>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, const float* lse,
               const float* dsum, float* dk_part, float* dv_part, int B,
               int S, int H, int Hkv, int T_, int dh, int t_real, int causal,
               float scale_log2, float scale, cudaStream_t st) {
  typedef BwdCfg<DHP> C;
  auto kdq = flash_bwd_dq<T, DHP>;
  auto kkv = flash_bwd_dkdv<T, DHP>;
  static sm90::OptIn dq_done, kv_done;
  int err = smem_opt_in(kdq, C::DQ_SMEM, dq_done);
  if (!err) err = smem_opt_in(kkv, C::KV_SMEM, kv_done);
  if (err) return err;
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *td = static_cast<const T*>(dout);
  dim3 gq((S + DQ_BQ - 1) / DQ_BQ, B * H);
  kdq<<<gq, BWD_THREADS, C::DQ_SMEM, st>>>(tq, tk, tv, td,
                                           static_cast<T*>(dq), lse, dsum, S,
                                           H, Hkv, T_, dh, t_real, causal,
                                           scale_log2, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  dim3 gk((T_ + KV_BK - 1) / KV_BK, B * H);
  kkv<<<gk, BWD_THREADS, C::KV_SMEM, st>>>(tq, tk, tv, td, lse, dsum, dk_part,
                                           dv_part, S, H, Hkv, T_, dh, t_real,
                                           causal, scale_log2, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_reduce<T>(dk_part, dv_part, dk, dv, B, H / Hkv, Hkv, T_, dh,
                          st);
}

template <typename T>
int mma_by_width(int dhp, const void* q, const void* k, const void* v,
                 const void* dout, void* dq, void* dk, void* dv,
                 const float* lse, const float* dsum, float* dkp, float* dvp,
                 int B, int S, int H, int Hkv, int T_, int dh, int t_real,
                 int causal, float sl2, float sc, cudaStream_t st) {
  switch (dhp) {
    case 16:
      return launch_mma<T, 16>(q, k, v, dout, dq, dk, dv, lse, dsum, dkp, dvp,
                               B, S, H, Hkv, T_, dh, t_real, causal, sl2, sc,
                               st);
    case 32:
      return launch_mma<T, 32>(q, k, v, dout, dq, dk, dv, lse, dsum, dkp, dvp,
                               B, S, H, Hkv, T_, dh, t_real, causal, sl2, sc,
                               st);
    case 64:
      return launch_mma<T, 64>(q, k, v, dout, dq, dk, dv, lse, dsum, dkp, dvp,
                               B, S, H, Hkv, T_, dh, t_real, causal, sl2, sc,
                               st);
    case 128:
      return launch_mma<T, 128>(q, k, v, dout, dq, dk, dv, lse, dsum, dkp,
                                dvp, B, S, H, Hkv, T_, dh, t_real, causal,
                                sl2, sc, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* v,
                const void* dout, void* dq, void* dk, void* dv,
                const float* lse, const float* dsum, float* dk_part,
                float* dv_part, int B, int S, int H, int Hkv, int T_, int dh,
                int t_real, int causal, float scale_log2, float scale,
                cudaStream_t st) {
  static sm90::OptIn dq_done, kv_done;
  int err = smem_opt_in(flash_bwd_dq_simt<T>, FCfg::DQ_SMEM, dq_done);
  if (!err) err = smem_opt_in(flash_bwd_dkdv_simt<T>, FCfg::KV_SMEM, kv_done);
  if (err) return err;
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *td = static_cast<const T*>(dout);
  const int nd = (dh + F_DH - 1) / F_DH;
  dim3 gq((S + F_BQ - 1) / F_BQ, B * H, nd);
  flash_bwd_dq_simt<T><<<gq, F_THREADS, FCfg::DQ_SMEM, st>>>(
      tq, tk, tv, td, static_cast<T*>(dq), lse, dsum, S, H, Hkv, T_, dh,
      t_real, causal, scale_log2, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  dim3 gk((T_ + F_KB - 1) / F_KB, B * H, nd);
  flash_bwd_dkdv_simt<T><<<gk, F_THREADS, FCfg::KV_SMEM, st>>>(
      tq, tk, tv, td, lse, dsum, dk_part, dv_part, S, H, Hkv, T_, dh, t_real,
      causal, scale_log2, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_reduce<T>(dk_part, dv_part, dk, dv, B, H / Hkv, Hkv, T_, dh,
                          st);
}

// a 4-D map over (dh, heads, n, B) with boxes of (64, bh, bn, 1)
template <typename T>
int map4(CUtensorMap* m, const void* p, int dh, int heads, int n, int n_all,
         int B, int bh, int bn) {
  const uint64_t e = 2;
  const uint64_t dims[4] = {(uint64_t)dh, (uint64_t)heads, (uint64_t)n,
                            (uint64_t)B};
  const uint64_t str[3] = {dh * e, (uint64_t)heads * dh * e,
                           (uint64_t)n_all * heads * dh * e};
  const uint32_t box[4] = {64, (uint32_t)bh, (uint32_t)bn, 1};
  return sm90::map_sw128(m, Elem<T>::MAP, 4, p, dims, str, box);
}

template <typename T, int DH>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, void* dq, void* dk, void* dv,
                 const float* lse, const float* dsum, float* dk_part,
                 float* dv_part, int B, int S, int H, int Hkv, int T_,
                 int t_real, int causal, int groups, float scale_log2,
                 float scale, cudaStream_t st) {
  const int G = H / Hkv;
  if (W_BQ % G || groups < 1 || G % groups || W_BR % (G / groups))
    return (int)cudaErrorInvalidValue;
  const int Gg = G / groups;
  int lg_gg = 0;
  while ((1 << lg_gg) < Gg) ++lg_gg;
  // dq: q, do in 128-row tiles, k, v in 64-key tiles
  CUtensorMap mq, mdo, mk, mv;
  int err = map4<T>(&mq, q, DH, H, S, S, B, G, W_BQ / G);
  if (!err) err = map4<T>(&mdo, dout, DH, H, S, S, B, G, W_BQ / G);
  if (!err) err = map4<T>(&mk, k, DH, Hkv, t_real, T_, B, 1, W_BK);
  if (!err) err = map4<T>(&mv, v, DH, Hkv, t_real, T_, B, 1, W_BK);
  if (err) return err;
  auto kdq = flash_bwd_dq_wgmma<T, DH>;
  static sm90::OptIn dq_done;
  err = smem_opt_in(kdq, DqCfg<DH>::SMEM, dq_done);
  if (err) return err;
  const int q_tiles = (S * G + W_BQ - 1) / W_BQ;
  kdq<<<(unsigned)((long long)q_tiles * B * Hkv), 384, DqCfg<DH>::SMEM,
        st>>>(mq, mdo, mk, mv, lse, dsum, static_cast<T*>(dq), S, H, Hkv,
              t_real, causal, scale_log2, scale, q_tiles, B * Hkv);
  err = (int)cudaGetLastError();
  if (err) return err;

  // dK/dV: q, do in 64-row tiles of a head group, k, v in 128-key tiles
  err = map4<T>(&mq, q, DH, H, S, S, B, Gg, W_BR / Gg);
  if (!err) err = map4<T>(&mdo, dout, DH, H, S, S, B, Gg, W_BR / Gg);
  if (!err) err = map4<T>(&mk, k, DH, Hkv, t_real, T_, B, 1, 2 * W_BK);
  if (!err) err = map4<T>(&mv, v, DH, Hkv, t_real, T_, B, 1, 2 * W_BK);
  if (err) return err;
  typedef DkvCfg<DH> KC;
  auto kkv = flash_bwd_dkdv_wgmma<T, DH>;
  static sm90::OptIn kv_done;
  err = smem_opt_in(kkv, KC::SMEM, kv_done);
  if (err) return err;
  const int k_tiles = (T_ + 2 * W_BK - 1) / (2 * W_BK);
  kkv<<<(unsigned)((long long)k_tiles * B * Hkv * groups), KC::THREADS,
        KC::SMEM, st>>>(mq, mdo, mk, mv, lse, dsum, static_cast<T*>(dk),
                        static_cast<T*>(dv), dk_part, dv_part, S, H, Hkv, T_,
                        t_real, causal, groups, lg_gg, scale_log2, scale);
  err = (int)cudaGetLastError();
  if (err || groups == 1) return err;
  return launch_reduce<T>(dk_part, dv_part, dk, dv, B, groups, Hkv, T_, DH,
                          st);
}

template <typename T>
int launch_dsum(const void* o, const void* dout, float* dsum, int B, int S,
                int H, int dh, cudaStream_t st) {
  const long long rows = (long long)B * S * H;
  const int per = DSUM_THREADS / 16;
  flash_bwd_dsum<T><<<(unsigned)((rows + per - 1) / per), DSUM_THREADS, 0,
                      st>>>(static_cast<const T*>(o),
                            static_cast<const T*>(dout), dsum, rows, S, H, dh);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(int route, int dhp, int groups, const void* q,
                 const void* k, const void* v, const void* o,
                 const void* dout, void* dq, void* dk, void* dv,
                 const float* lse, float* dsum, float* dkp, float* dvp,
                 int B, int S, int H, int Hkv, int T_, int dh, int t_real,
                 int causal, float sl2, float sc, cudaStream_t st) {
  int err = launch_dsum<T>(o, dout, dsum, B, S, H, dh, st);
  if (err) return err;
  if (route == 2)
    return launch_simt<T>(q, k, v, dout, dq, dk, dv, lse, dsum, dkp, dvp, B,
                          S, H, Hkv, T_, dh, t_real, causal, sl2, sc, st);
  if constexpr (sizeof(T) == 2) {
    if (route == 0) {
      if (dh != dhp) return (int)cudaErrorInvalidValue;
      if (dh == 128)
        return launch_wgmma<T, 128>(q, k, v, dout, dq, dk, dv, lse, dsum, dkp,
                                    dvp, B, S, H, Hkv, T_, t_real, causal,
                                    groups, sl2, sc, st);
      if (dh == 64)
        return launch_wgmma<T, 64>(q, k, v, dout, dq, dk, dv, lse, dsum, dkp,
                                   dvp, B, S, H, Hkv, T_, t_real, causal,
                                   groups, sl2, sc, st);
    }
    if (route == 1) {
      if (dh > dhp || dh % 8) return (int)cudaErrorInvalidValue;
      return mma_by_width<T>(dhp, q, k, v, dout, dq, dk, dv, lse, dsum, dkp,
                             dvp, B, S, H, Hkv, T_, dh, t_real, causal, sl2,
                             sc, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The gradient of attention of q (B, S, H, dh) over k, v (B, T, Hkv, dh)
// with output o, given do (B, S, H, dh) and the forward's row log-sum-exp
// lse (B, H, S) f32: dq (B, S, H, dh), dk and dv (B, T, Hkv, dh), all
// contiguous and of one dtype (0 f32, 1 bf16, 2 f16). route 0 "wgmma" (bf16
// or f16, dh = dhp in {64, 128}; `groups` head groups of the dK/dV
// blocks), 1 "mma" (bf16 or f16, kernels of
// head width dhp in {16, 32, 64, 128}, >= dh), 2 SIMT ("f32" at dh <= 128
// and "wide" above, any dtype). dsum (B, H, S) f32 receives rowsum(do * o).
// dk_part and dv_part are f32 scratch: (B, T, H, dh) on routes 1 and 2,
// (B, T, Hkv * groups, dh) on route 0 with groups > 1 (else unused). dh is a
// multiple of 8; scores scaled by 1 / sqrt(dh_scale). Returns the first
// CUDA error of its launches (0 when none).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout, void* dq,
                               void* dk, void* dv, const void* lse,
                               void* dsum, void* dk_part, void* dv_part,
                               int dtype, int route, int dhp, int groups,
                               int B, int S, int H, int Hkv, int T_,
                               int dh, int t_real, int causal, int dh_scale,
                               void* stream_ptr) {
  const float scale = 1.f / sqrtf((float)dh_scale);
  const float scale_log2 = LOG2E * scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  const float* l = static_cast<const float*>(lse);
  float *ds = static_cast<float*>(dsum), *kp = static_cast<float*>(dk_part),
        *vp = static_cast<float*>(dv_part);
  auto run = dtype == 0   ? launch_typed<float>
             : dtype == 1 ? launch_typed<bf16>
                          : launch_typed<f16>;
  return run(route, dhp, groups, q, k, v, o, dout, dq, dk, dv, l, ds, kp,
             vp, B, S, H, Hkv, T_, dh, t_real, causal, scale_log2, scale, st);
}

}  // extern "C"
