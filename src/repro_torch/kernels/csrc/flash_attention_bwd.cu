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
// never read, scale 1 / sqrt(dh). Given o and do (B, S, H, dh) it writes dq
// (B, S, H, dh), dk and dv (B, T, Hkv, dh) in the inputs' dtype, and the row
// log-sum-exp lse (B, H, S) in f32, FlashAttention-2's recurrence:
//     lse = log sum_t exp(s_t),  s = scale * q k^T
//     D   = rowsum(do * o)
//     P   = exp(s - lse),  dP = do v^T,  dS = P * (dP - D)
//     dq  = scale * dS k,  dk = scale * dS^T q,  dv = P^T do
// The forward does not keep lse (serving never needs it), so the dq kernel
// recomputes it in a first pass over its keys: one more q k^T product.
//
// Three launches on the caller's stream, in order:
// * flash_bwd_dq, one block per (64-position row tile, b * H + h): pass 1
//   runs the online max and sum over the block's key tiles and writes lse,
//   D is summed from do and o, pass 2 recomputes s, forms dS and
//   accumulates dq over the key tiles at or below the diagonal. glm4 at
//   S = 4,096 gives 64 x 32 = 2,048 blocks.
// * flash_bwd_dkdv, one block per (64-key tile, b * H + h): the block loads
//   its keys and values once and walks the row tiles of ONE query head from
//   the diagonal down, accumulating dk and dv in registers. Splitting the G
//   query heads of a kv head over blocks is what fills the card: glm4 has
//   Hkv = 2, so blocks per kv head alone would be 64 x 2 = 128; per query
//   head they are 2,048. Each block writes its f32 partial (B, T, H, dh).
// * flash_bwd_reduce sums the G partials of each kv head in a fixed order
//   (g = 0 .. G - 1) and rounds to the dtype. No float atomics anywhere, so
//   a step's gradients, and a training run's losses, are bit-reproducible.
//
// What bounds it. Five products of the attended pairs (q k^T, do v^T,
// P^T do, dS^T q, dS k): at glm4's S = T = 4,096 causal, H = 32, dh = 128,
// 3.44e11 FLOP, 0.348 ms at 989 TFLOP/s; the tensor cores bound it. This
// design does eight (q k^T three times: lse pass, dq pass, dkdv; do v^T
// twice), on mma.sync m16n8k16 with f32 accumulation (wgmma and TMA are a
// later redesign). P and dS are rounded to the dtype before their products,
// as the forward rounds P; everything else stays f32.
//
// Routes: "mma" (bf16, f16; dh padded by the wrapper to a multiple of 8 and
// here to DHP in {16, 32, 64, 128} with zeros in shared memory, which add
// nothing to any product) and "f32" (f32 inputs in plain f32 FMAs, dh <=
// 128, never rounded to a narrower type). Wider heads have no backward yet.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
typedef __half f16;

namespace {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <>
struct Elem<f16> {
  static constexpr bool F16 = true;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

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

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
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
// + 8 (g = lane / 4), as the forward's mma route owns its rows.
template <typename T, int DHP>
__global__ void __launch_bounds__(BWD_THREADS)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, T* __restrict__ dq,
                 float* __restrict__ lse_out, float* __restrict__ d_out,
                 int S, int H, int Hkv, int T_, int dh, int t_real,
                 int causal, float scale_log2, float scale) {
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

  // D = rowsum(do * o) of the warp's 16 rows, each summed over the warp
  float Dr[2] = {0.f, 0.f};
  for (int r = 0; r < 16; ++r) {
    const int s = s0 + warp * 16 + r;
    float acc = 0.f;
    if (s < S) {
      const size_t base = (((size_t)b * S + s) * H + h) * dh;
      for (int d = lane; d < dh; d += 32)
        acc = fmaf(to_f(dout[base + d]), to_f(o[base + d]), acc);
    }
    acc = warp_sum(acc);
    if (r == g) Dr[0] = acc;
    if (r == g + 8) Dr[1] = acc;
  }

  const int last = min(s0 + DQ_BQ, S) - 1;
  int kv_limit = t_real;
  if (causal) kv_limit = min(kv_limit, last + 1);
  const int n_tiles = (kv_limit + DQ_BK - 1) / DQ_BK;

  // ---- pass 1: the row max and sum over the keys (k only) ----
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (n_tiles > 0)
    load_rows<T, DHP, DQ_BK>(ring, k, b, 0, T_, Hkv, hk, dh, t_real);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles)
      load_rows<T, DHP, DQ_BK>(ring + ((it + 1) % 2) * C::DQ_STAGE, k, b,
                               (it + 1) * DQ_BK, T_, Hkv, hk, dh, t_real);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Ks = ring + (it % 2) * C::DQ_STAGE;
    float sc[NK][4];
    rows_by_keys<T, DHP>(sc, qa, Ks, lane);
    const int kv0 = it * DQ_BK;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = sc[nt][j] * scale_log2;
        int kp = kv0 + nt * 8 + 2 * t + (j & 1);
        int qp = (j >> 1) ? pos[1] : pos[0];
        if (kp >= t_real || (causal && kp > qp)) s = -INFINITY;
        sc[nt][j] = s;
        mx[j >> 1] = fmaxf(mx[j >> 1], s);
      }
    float mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float m_new = fmaxf(m[i], quad_max(mx[i]));
      mu[i] = m_new == -INFINITY ? 0.f : m_new;
      l[i] *= exp2f(m[i] - mu[i]);
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) l[j >> 1] += exp2f(sc[nt][j] - mu[j >> 1]);
    __syncthreads();  // this stage is refilled next iteration
  }
  cp_async_wait<0>();
  __syncthreads();
  float lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = quad_sum(l[i]);
    lse2[i] = li > 0.f ? m[i] + log2f(li) : INFINITY;
    if (t == 0 && pos[i] < S) {
      const size_t idx = ((size_t)b * H + h) * S + pos[i];
      lse_out[idx] = lse2[i] / LOG2E;
      d_out[idx] = Dr[i];
    }
  }

  // ---- pass 2: dS = P * (dP - D), dq += dS k ----
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
      st[r] = s < S ? lse[idx] * LOG2E : INFINITY;  // P = 0 past S
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

// dk, dv (B, T, Hkv, dh) = the partials (B, T, H, dh) summed over the G
// query heads of each kv head in the order g = 0 .. G - 1, rounded to T
template <typename T>
__global__ void flash_bwd_reduce(const float* __restrict__ dk_part,
                                 const float* __restrict__ dv_part,
                                 T* __restrict__ dk, T* __restrict__ dv,
                                 long long n, int H, int Hkv, int dh) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int G = H / Hkv;
  const int d = (int)(idx % dh);
  const long long rest = idx / dh;
  const int hk = (int)(rest % Hkv);
  const long long bt = rest / Hkv;
  const size_t base = ((size_t)bt * H + (size_t)hk * G) * dh + d;
  float sk = 0.f, sv = 0.f;
  for (int gg = 0; gg < G; ++gg) {
    sk += dk_part[base + (size_t)gg * dh];
    sv += dv_part[base + (size_t)gg * dh];
  }
  put(dk + idx, sk);
  put(dv + idx, sv);
}

// ---- the f32 route (SIMT) --------------------------------------------------

constexpr int F_THREADS = 256;  // 8 warps
constexpr int F_BQ = 16;        // positions of a dq block (2 a warp)
constexpr int F_BK = 32;        // keys of a dq k/v tile (one a lane)
constexpr int F_KB = 16;        // keys of a dkdv block (2 a warp)
constexpr int F_BR = 32;        // positions of a dkdv tile (one a lane)
constexpr int F_DH = 128;       // the widest head

struct FCfg {
  // dq: q, do (F_BQ x F_DH), k, v (F_BK x F_DH + 1)
  static constexpr int DQ_SMEM = (2 * F_BQ * F_DH + 2 * F_BK * (F_DH + 1)) * 4;
  // dkdv: k, v (F_KB x F_DH), q, do (F_BR x F_DH + 1), lse and D (F_BR)
  static constexpr int KV_SMEM =
      (2 * F_KB * F_DH + 2 * F_BR * (F_DH + 1) + 2 * F_BR) * 4;
};

// grid (ceil(S / F_BQ), B * H): warp w owns positions s0 + 2 w and + 1; for
// the scores lane j takes key j of a tile, for dq lane j columns j + 32 c
__global__ void __launch_bounds__(F_THREADS)
    flash_bwd_dq_simt(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ o,
                      const float* __restrict__ dout, float* __restrict__ dq,
                      float* __restrict__ lse_out, float* __restrict__ d_out,
                      int S, int H, int Hkv, int T_, int dh, int t_real,
                      int causal, float scale_log2, float scale) {
  extern __shared__ float fs[];
  float* qs = fs;                       // [F_BQ][F_DH]
  float* dos = qs + F_BQ * F_DH;        // [F_BQ][F_DH]
  float* ks = dos + F_BQ * F_DH;        // [F_BK][F_DH + 1]
  float* vs = ks + F_BK * (F_DH + 1);   // [F_BK][F_DH + 1]
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int s0 = blockIdx.x * F_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int idx = threadIdx.x; idx < F_BQ * F_DH; idx += F_THREADS) {
    int r = idx / F_DH, d = idx % F_DH, s = s0 + r;
    bool ok = s < S && d < dh;
    size_t off = (((size_t)b * S + s) * H + h) * dh + d;
    qs[idx] = ok ? q[off] : 0.f;
    dos[idx] = ok ? dout[off] : 0.f;
  }
  int pos[2] = {s0 + 2 * warp, s0 + 2 * warp + 1};
  float Dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float acc = 0.f;
    if (pos[i] < S) {
      const size_t base = (((size_t)b * S + pos[i]) * H + h) * dh;
      for (int d = lane; d < dh; d += 32)
        acc = fmaf(dout[base + d], o[base + d], acc);
    }
    Dr[i] = warp_sum(acc);
  }
  const int last = min(s0 + F_BQ, S) - 1;
  int kv_limit = t_real;
  if (causal) kv_limit = min(kv_limit, last + 1);

  auto scores = [&](const float* mat, const float* rows, int i) {
    const float* qr = rows + (2 * warp + i) * F_DH;
    const float* kr = mat + lane * (F_DH + 1);
    float dot = 0.f;
    for (int d = 0; d < dh; ++d) dot = fmaf(qr[d], kr[d], dot);
    return dot;
  };
  auto load = [&](float* dst, const float* src, int kv0) {
    for (int idx = threadIdx.x; idx < F_BK * dh; idx += F_THREADS) {
      int r = idx / dh, d = idx % dh, kp = kv0 + r;
      dst[r * (F_DH + 1) + d] =
          kp < t_real ? src[(((size_t)b * T_ + kp) * Hkv + hk) * dh + d] : 0.f;
    }
  };

  // pass 1: row max and sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kv0 = 0; kv0 < kv_limit; kv0 += F_BK) {
    __syncthreads();
    load(ks, k, kv0);
    __syncthreads();
    const int kp = kv0 + lane;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float s = scores(ks, qs, i) * scale_log2;
      if (kp >= t_real || (causal && kp > pos[i])) s = -INFINITY;
      float mx = s;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float m_new = fmaxf(m[i], mx);
      float mu = m_new == -INFINITY ? 0.f : m_new;
      l[i] = l[i] * exp2f(m[i] - mu) + warp_sum(exp2f(s - mu));
      m[i] = m_new;
    }
  }
  float lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = l[i] > 0.f ? m[i] + log2f(l[i]) : INFINITY;
    if (lane == 0 && pos[i] < S) {
      const size_t idx = ((size_t)b * H + h) * S + pos[i];
      lse_out[idx] = lse2[i] / LOG2E;
      d_out[idx] = Dr[i];
    }
  }

  // pass 2: dS and dq
  float acc[2][F_DH / 32] = {};
  for (int kv0 = 0; kv0 < kv_limit; kv0 += F_BK) {
    __syncthreads();
    load(ks, k, kv0);
    load(vs, v, kv0);
    __syncthreads();
    const int kp = kv0 + lane;
    float ds[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bool keep = kp < t_real && !(causal && kp > pos[i]);
      float p = keep ? exp2f(scores(ks, qs, i) * scale_log2 - lse2[i]) : 0.f;
      ds[i] = p * (scores(vs, dos, i) - Dr[i]);
    }
    for (int j = 0; j < F_BK; ++j) {
      float d0 = __shfl_sync(0xffffffffu, ds[0], j);
      float d1 = __shfl_sync(0xffffffffu, ds[1], j);
#pragma unroll
      for (int c = 0; c < F_DH / 32; ++c) {
        float x = ks[j * (F_DH + 1) + lane + 32 * c];
        acc[0][c] = fmaf(d0, x, acc[0][c]);
        acc[1][c] = fmaf(d1, x, acc[1][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (pos[i] >= S) continue;
    float* row = dq + (((size_t)b * S + pos[i]) * H + h) * dh;
#pragma unroll
    for (int c = 0; c < F_DH / 32; ++c)
      if (lane + 32 * c < dh) row[lane + 32 * c] = acc[i][c] * scale;
  }
}

// grid (ceil(T / F_KB), B * H): warp w owns keys kv0 + 2 w and + 1; lane j
// takes position j of a row tile for the scores, columns j + 32 c for dk, dv
__global__ void __launch_bounds__(F_THREADS)
    flash_bwd_dkdv_simt(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
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
  const int kv0 = blockIdx.x * F_KB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int idx = threadIdx.x; idx < F_KB * F_DH; idx += F_THREADS) {
    int r = idx / F_DH, d = idx % F_DH, kp = kv0 + r;
    bool ok = kp < t_real && d < dh;
    size_t off = (((size_t)b * T_ + kp) * Hkv + hk) * dh + d;
    ks[idx] = ok ? k[off] : 0.f;
    vs[idx] = ok ? v[off] : 0.f;
  }
  const int first = causal ? kv0 : 0;
  const bool any = kv0 < t_real && first < S;
  float dk[2][F_DH / 32] = {}, dv[2][F_DH / 32] = {};
  for (int r0 = (first / F_BR) * F_BR; any && r0 < S; r0 += F_BR) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < F_BR * dh; idx += F_THREADS) {
      int r = idx / dh, d = idx % dh, s = r0 + r;
      size_t off = (((size_t)b * S + s) * H + h) * dh + d;
      qs[r * (F_DH + 1) + d] = s < S ? q[off] : 0.f;
      dos[r * (F_DH + 1) + d] = s < S ? dout[off] : 0.f;
    }
    for (int r = threadIdx.x; r < F_BR; r += F_THREADS) {
      const int s = r0 + r;
      const size_t idx = ((size_t)b * H + h) * S + s;
      lse2[r] = s < S ? lse[idx] * LOG2E : INFINITY;
      Dv[r] = s < S ? dsum[idx] : 0.f;
    }
    __syncthreads();
    const int qp = r0 + lane;
    float p[2], ds[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kp = kv0 + 2 * warp + i;
      const float* kr = ks + (2 * warp + i) * F_DH;
      const float* vr = vs + (2 * warp + i) * F_DH;
      const float* qr = qs + lane * (F_DH + 1);
      const float* dr = dos + lane * (F_DH + 1);
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < dh; ++d) {
        s = fmaf(kr[d], qr[d], s);
        dp = fmaf(vr[d], dr[d], dp);
      }
      bool keep = kp < t_real && !(causal && kp > qp);
      p[i] = keep ? exp2f(s * scale_log2 - lse2[lane]) : 0.f;
      ds[i] = p[i] * (dp - Dv[lane]);
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
    const size_t row = (((size_t)b * T_ + kp) * H + h) * dh;
#pragma unroll
    for (int c = 0; c < F_DH / 32; ++c)
      if (lane + 32 * c < dh) {
        dk_part[row + lane + 32 * c] = dk[i][c] * scale;
        dv_part[row + lane + 32 * c] = dv[i][c];
      }
  }
}

// ---- launches ----------------------------------------------------------------

template <typename T>
int launch_reduce(const float* dk_part, const float* dv_part, void* dk,
                  void* dv, int B, int H, int Hkv, int T_, int dh,
                  cudaStream_t st) {
  long long n = (long long)B * T_ * Hkv * dh;
  flash_bwd_reduce<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      dk_part, dv_part, static_cast<T*>(dk), static_cast<T*>(dv), n, H, Hkv,
      dh);
  return (int)cudaGetLastError();
}

template <typename T, int DHP>
int launch_mma(const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* dq, void* dk, void* dv, float* lse,
               float* dsum, float* dk_part, float* dv_part, int B, int S,
               int H, int Hkv, int T_, int dh, int t_real, int causal,
               float scale_log2, float scale, cudaStream_t st) {
  typedef BwdCfg<DHP> C;
  auto kdq = flash_bwd_dq<T, DHP>;
  auto kkv = flash_bwd_dkdv<T, DHP>;
  static bool configured = false;  // above 48 KB only after opting in
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, C::DQ_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, C::KV_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *to = static_cast<const T*>(o),
          *td = static_cast<const T*>(dout);
  dim3 gq((S + DQ_BQ - 1) / DQ_BQ, B * H);
  kdq<<<gq, BWD_THREADS, C::DQ_SMEM, st>>>(
      tq, tk, tv, to, td, static_cast<T*>(dq), lse, dsum, S, H, Hkv, T_, dh,
      t_real, causal, scale_log2, scale);
  int err = (int)cudaGetLastError();
  if (err) return err;
  dim3 gk((T_ + KV_BK - 1) / KV_BK, B * H);
  kkv<<<gk, BWD_THREADS, C::KV_SMEM, st>>>(tq, tk, tv, td, lse, dsum, dk_part,
                                           dv_part, S, H, Hkv, T_, dh, t_real,
                                           causal, scale_log2, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_reduce<T>(dk_part, dv_part, dk, dv, B, H, Hkv, T_, dh, st);
}

template <typename T>
int mma_by_width(int dhp, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, void* dq, void* dk,
                 void* dv, float* lse, float* dsum, float* dkp, float* dvp,
                 int B, int S, int H, int Hkv, int T_, int dh, int t_real,
                 int causal, float sl2, float sc, cudaStream_t st) {
  switch (dhp) {
    case 16:
      return launch_mma<T, 16>(q, k, v, o, dout, dq, dk, dv, lse, dsum, dkp,
                               dvp, B, S, H, Hkv, T_, dh, t_real, causal, sl2,
                               sc, st);
    case 32:
      return launch_mma<T, 32>(q, k, v, o, dout, dq, dk, dv, lse, dsum, dkp,
                               dvp, B, S, H, Hkv, T_, dh, t_real, causal, sl2,
                               sc, st);
    case 64:
      return launch_mma<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, dsum, dkp,
                               dvp, B, S, H, Hkv, T_, dh, t_real, causal, sl2,
                               sc, st);
    case 128:
      return launch_mma<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, dsum, dkp,
                                dvp, B, S, H, Hkv, T_, dh, t_real, causal, sl2,
                                sc, st);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_simt(const void* q, const void* k, const void* v, const void* o,
                const void* dout, void* dq, void* dk, void* dv, float* lse,
                float* dsum, float* dk_part, float* dv_part, int B, int S,
                int H, int Hkv, int T_, int dh, int t_real, int causal,
                float scale_log2, float scale, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_simt, cudaFuncAttributeMaxDynamicSharedMemorySize,
        FCfg::DQ_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dkdv_simt,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 FCfg::KV_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const float *tq = static_cast<const float*>(q),
              *tk = static_cast<const float*>(k),
              *tv = static_cast<const float*>(v),
              *td = static_cast<const float*>(dout);
  dim3 gq((S + F_BQ - 1) / F_BQ, B * H);
  flash_bwd_dq_simt<<<gq, F_THREADS, FCfg::DQ_SMEM, st>>>(
      tq, tk, tv, static_cast<const float*>(o), td, static_cast<float*>(dq),
      lse, dsum, S, H, Hkv, T_, dh, t_real, causal, scale_log2, scale);
  int err = (int)cudaGetLastError();
  if (err) return err;
  dim3 gk((T_ + F_KB - 1) / F_KB, B * H);
  flash_bwd_dkdv_simt<<<gk, F_THREADS, FCfg::KV_SMEM, st>>>(
      tq, tk, tv, td, lse, dsum, dk_part, dv_part, S, H, Hkv, T_, dh, t_real,
      causal, scale_log2, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_reduce<float>(dk_part, dv_part, dk, dv, B, H, Hkv, T_, dh, st);
}

}  // namespace

extern "C" {

// The gradient of attention of q (B, S, H, dh) over k, v (B, T, Hkv, dh)
// with output o, given do (B, S, H, dh): dq (B, S, H, dh), dk and dv
// (B, T, Hkv, dh), all contiguous and of one dtype (0 f32 on the SIMT
// kernels, 1 bf16 or 2 f16 on the mma kernels of head width dhp in {16,
// 32, 64, 128}, >= dh); lse and dsum (B, H, S) f32 receive the rows'
// log-sum-exp and rowsum(do * o); dk_part and dv_part (B, T, H, dh) f32 are
// scratch. dh is a multiple of 8 (at most 128); scores scaled by
// 1 / sqrt(dh_scale). Three launches on `stream`; returns the first CUDA
// error (0 when none).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout, void* dq,
                               void* dk, void* dv, void* lse, void* dsum,
                               void* dk_part, void* dv_part, int dtype,
                               int dhp, int B, int S, int H, int Hkv, int T_,
                               int dh, int t_real, int causal, int dh_scale,
                               void* stream_ptr) {
  const float scale = 1.f / sqrtf((float)dh_scale);
  const float scale_log2 = LOG2E * scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  float *l = static_cast<float*>(lse), *ds = static_cast<float*>(dsum),
        *kp = static_cast<float*>(dk_part), *vp = static_cast<float*>(dv_part);
  if (dtype == 0)
    return launch_simt(q, k, v, o, dout, dq, dk, dv, l, ds, kp, vp, B, S, H,
                       Hkv, T_, dh, t_real, causal, scale_log2, scale, st);
  auto run = dtype == 2 ? mma_by_width<f16> : mma_by_width<bf16>;
  return run(dhp, q, k, v, o, dout, dq, dk, dv, l, ds, kp, vp, B, S, H, Hkv,
             T_, dh, t_real, causal, scale_log2, scale, st);
}

}  // extern "C"
