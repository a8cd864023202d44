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
// at kpos >= t_real masked; l floored at 1e-30; output in q's dtype. Here
// t_real is a run-time argument (the decode mask arange(T) <= cache_len),
// and only o is returned: m, l and acc stay in registers.
//
// Layout: q (B, S, H, 128), k and v (B, T, Hkv, 128), o (B, S, H, 128), all
// bf16 and contiguous. Query head h reads kv head h / G, G = H / Hkv, from
// k and v directly: the GQA expansion is never built.
//
// What bounds it on this card. Causal prefill at S = T = 4,096 does
// 4 * S^2 / 2 * H * dh ~ 275 GFLOP per layer against ~100 MB of q, k, v and
// o: the tensor cores bound it. Decode (S = 1) does 4 * T * H * dh per
// sequence against 2 * T * Hkv * dh * 2 bytes of cache: 8 FLOP/B for glm4's
// G = 16, far below the 295 FLOP/B ridge, so reading the cache once bounds
// it (3.35 TB/s).
//
// What the design does about that.
// * Rows of a block are (position, head) pairs of one kv head: row r of
//   (b, kv head hk) is position r / G of query head hk * G + r % G. One
//   block reads each k/v tile once for all G heads that share it. At
//   decode the 16 heads of a glm4 kv group fill one 16-row mma tile, so a
//   cache tile is read once per group, not 16 times. At prefill a 64-row q
//   tile holds 64 / G positions, the same work and k/v traffic as the usual
//   one-head-per-block layout.
// * A block is 4 warps. With more than 16 rows per (b, kv head) (prefill)
//   each warp owns 16 rows and all 64 keys of a tile; with at most 16 rows
//   (decode) the 4 warps share the rows and each takes 16 keys of the
//   tile, and the 4 partial (m, l, acc) are merged in shared memory at the
//   end.
// * k/v tiles of 64 keys are staged in shared memory by cp.async, double
//   buffered; keys at or past t_real load as zeros and are never read from
//   memory.
// * QK^T and PV run on the tensor cores (mma.sync m16n8k16, bf16 operands,
//   f32 accumulators), the online softmax in f32 registers in the log2
//   domain (exp2f of scores pre-scaled by log2(e) / sqrt(dh)).
//   P is rounded to bf16 before the PV product; the row sum l adds the
//   unrounded f32 p. (The Pallas kernel and the plain version multiply p by
//   v in f32: the card check's tolerance covers this rounding.)
// * Decode has only B * Hkv blocks (32 for glm4 at batch 16), so the key
//   range is split over blocks (flash-decoding): each split writes its
//   unnormalised (acc, m, l) to an f32 workspace and `flash_combine` merges
//   the splits in a fixed order.
// Not done here (later work): wgmma/TMA, warp specialisation, a q tile
// larger than 64 rows, fp8 caches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int DH = 128;      // head width the kernel takes
constexpr int BKV = 64;      // keys per k/v tile
constexpr int KSTR = DH + 8; // shared-memory row stride of a k/v tile (bf16)
constexpr int OSTR = DH + 8; // row stride of the merge scratch (f32)
constexpr int THREADS = 128;
constexpr int STAGE_ELEMS = 2 * BKV * KSTR;  // k and v of one tile
constexpr int SMEM = 2 * STAGE_ELEMS * (int)sizeof(bf16);

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

// d (16 x 8, f32) += a (16 x 16, bf16, row) @ b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair: lo in the low half (the lower column/row)
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// k and v rows [kv0, kv0 + BKV) of (b, hk) into one stage; rows at or past
// t_real are zero-filled without a read
__device__ __forceinline__ void load_kv(bf16* Ks, const bf16* __restrict__ k,
                                        const bf16* __restrict__ v, int b,
                                        int hk, int T, int Hkv, int t_real,
                                        int kv0) {
  bf16* Vs = Ks + BKV * KSTR;
  for (int c = threadIdx.x; c < BKV * DH / 8; c += THREADS) {
    int r = c / (DH / 8), dc = (c % (DH / 8)) * 8;
    int kp = kv0 + r;
    bool ok = kp < t_real;
    size_t off = ok ? (((size_t)b * T + kp) * Hkv + hk) * DH + dc : 0;
    cp_async16(Ks + r * KSTR + dc, k + off, ok);
    cp_async16(Vs + r * KSTR + dc, v + off, ok);
  }
}

// NWQ warps along the rows (16 each), 4 / NWQ along the keys of a tile.
// grid (q tiles, B * Hkv, splits); a split covers kv tiles
// [z * tiles_per_split, (z + 1) * tiles_per_split) of this block's range.
template <int NWQ>
__global__ void __launch_bounds__(THREADS)
    flash_attn_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int S, int H, int Hkv, int T, int t_real, int causal,
                    float scale_log2, int tiles_per_split) {
  constexpr int NWK = 4 / NWQ;
  constexpr int BQ = 16 * NWQ;   // rows of a block
  constexpr int KW = BKV / NWK;  // keys of a tile per warp
  constexpr int NT = KW / 8;     // score n-tiles per warp
  constexpr int KS = KW / 16;    // PV k-steps per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);

  const int G = H / Hkv, rows = S * G;
  const int bh = blockIdx.y, b = bh / Hkv, hk = bh % Hkv;
  const int row0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wq = warp / NWK, wk = warp % NWK;
  const int g = lane >> 2, t = lane & 3;

  // this thread's two rows (g and g + 8 of the warp's 16): q fragments
  uint32_t qa[DH / 16][4];
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int rr = row0 + wq * 16 + g + 8 * i;
    bool ok = rr < rows;
    int s = ok ? rr / G : 0, h = hk * G + (ok ? rr % G : 0);
    qpos[i] = s;
    const bf16* qr = q + (((size_t)b * S + s) * H + h) * DH + 2 * t;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      qa[kk][i] = ok ? *reinterpret_cast<const uint32_t*>(qr + kk * 16) : 0u;
      qa[kk][2 + i] =
          ok ? *reinterpret_cast<const uint32_t*>(qr + kk * 16 + 8) : 0u;
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

  float acc[DH / 8][4];
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  if (tile_begin < tile_end)
    load_kv(ring, k, v, b, hk, T, Hkv, t_real, tile_begin * BKV);
  cp_async_commit();

  for (int it = tile_begin; it < tile_end; ++it) {
    const int stage = (it - tile_begin) & 1;
    if (it + 1 < tile_end)
      load_kv(ring + (stage ^ 1) * STAGE_ELEMS, k, v, b, hk, T, Hkv, t_real,
              (it + 1) * BKV);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* Ks = ring + stage * STAGE_ELEMS;
    const bf16* Vs = Ks + BKV * KSTR;
    const int kv0 = it * BKV;
    const int kw0 = wk * KW;

    // scores of this warp's 16 rows x KW keys
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const bf16* kr = Ks + (kw0 + nt * 8 + g) * KSTR + 2 * t;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma16816(sc[nt], qa[kk], b0, b1);
      }
    }
    const bool need_mask =
        kv0 + BKV > t_real || (causal && kv0 + BKV - 1 > min_qpos);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = sc[nt][j] * scale_log2;
        if (need_mask) {
          int kp = kv0 + kw0 + nt * 8 + 2 * t + (j & 1);
          if (kp >= t_real || (causal && kp > qpos[j >> 1])) s = -INFINITY;
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
      alpha[i] = exp2f(m[i] - mu[i]);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = exp2f(sc[nt][j] - mu[j >> 1]);
        sc[nt][j] = p;
        l[j >> 1] += p;  // this thread's columns; the quad is summed at the end
      }
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }
    // acc += P (bf16) @ V: the C fragments of two score n-tiles are the A
    // fragment of one 16-key step
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t pa[4] = {pack_f32(sc[2 * ks][0], sc[2 * ks][1]),
                        pack_f32(sc[2 * ks][2], sc[2 * ks][3]),
                        pack_f32(sc[2 * ks + 1][0], sc[2 * ks + 1][1]),
                        pack_f32(sc[2 * ks + 1][2], sc[2 * ks + 1][3])};
      const bf16* vr = Vs + (kw0 + ks * 16 + 2 * t) * KSTR + g;
#pragma unroll
      for (int nd = 0; nd < DH / 8; ++nd) {
        const bf16* c = vr + nd * 8;
        uint32_t b0 = pack_bf16(c[0], c[KSTR]);
        uint32_t b1 = pack_bf16(c[8 * KSTR], c[9 * KSTR]);
        mma16816(acc[nd], pa, b0, b1);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }
  cp_async_wait<0>();
  __syncthreads();

  // every warp's (m, l, acc) into shared memory (over the k/v ring) ...
  float* so = reinterpret_cast<float*>(smem_raw);
  float* sm = so + 4 * 16 * OSTR;
  float* sl = sm + 4 * 16;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (t == 0) {
      sm[warp * 16 + g + 8 * i] = m[i];
      sl[warp * 16 + g + 8 * i] = l[i];
    }
  }
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd) {
    float* r0 = so + (warp * 16 + g) * OSTR + nd * 8 + 2 * t;
    *reinterpret_cast<float2*>(r0) = make_float2(acc[nd][0], acc[nd][1]);
    *reinterpret_cast<float2*>(r0 + 8 * OSTR) =
        make_float2(acc[nd][2], acc[nd][3]);
  }
  __syncthreads();

  // ... merged over the NWK warps that share a row, and written out
  const bool split = gridDim.z > 1;
  for (int idx = threadIdx.x; idx < BQ * DH; idx += THREADS) {
    const int rr = idx / DH, d = idx % DH;
    const int grow = row0 + rr;
    if (grow >= rows) break;
    const int w0 = (rr / 16) * NWK, lr = rr % 16;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWK; ++w) M = fmaxf(M, sm[(w0 + w) * 16 + lr]);
    float A = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < NWK; ++w) {
      float mw = sm[(w0 + w) * 16 + lr];
      float e = mw == -INFINITY ? 0.f : exp2f(mw - M);
      A += e * so[((w0 + w) * 16 + lr) * OSTR + d];
      L += e * sl[(w0 + w) * 16 + lr];
    }
    if (split) {
      size_t prow = ((size_t)blockIdx.z * gridDim.y + bh) * rows + grow;
      part_acc[prow * DH + d] = A;
      if (d == 0) {
        part_ml[prow * 2] = M;
        part_ml[prow * 2 + 1] = L;
      }
    } else {
      const int s = grow / G, h = hk * G + grow % G;
      o[(((size_t)b * S + s) * H + h) * DH + d] =
          __float2bfloat16(A / fmaxf(L, 1e-30f));
    }
  }
}

// o = merge of the splits' (acc, m, l) of every row, in split order
__global__ void flash_combine(const float* __restrict__ part_acc,
                              const float* __restrict__ part_ml,
                              bf16* __restrict__ o, int BHkv, int S, int H,
                              int Hkv, int splits) {
  const int G = H / Hkv, rows = S * G;
  const long long n = (long long)BHkv * rows * DH;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long long prow = idx / DH;
  const int d = (int)(idx % DH);
  const size_t stride = (size_t)BHkv * rows;
  float M = -INFINITY;
  for (int z = 0; z < splits; ++z)
    M = fmaxf(M, part_ml[(z * stride + prow) * 2]);
  float A = 0.f, L = 0.f;
  for (int z = 0; z < splits; ++z) {
    float mz = part_ml[(z * stride + prow) * 2];
    float e = mz == -INFINITY ? 0.f : exp2f(mz - M);
    A += e * part_acc[(z * stride + prow) * DH + d];
    L += e * part_ml[(z * stride + prow) * 2 + 1];
  }
  const int bh = (int)(prow / rows), grow = (int)(prow % rows);
  const int b = bh / Hkv, hk = bh % Hkv;
  const int s = grow / G, h = hk * G + grow % G;
  o[(((size_t)b * S + s) * H + h) * DH + d] =
      __float2bfloat16(A / fmaxf(L, 1e-30f));
}

template <int NWQ>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
           float* part_acc, float* part_ml, int B, int S, int H, int Hkv,
           int T, int t_real, int causal, int q_tiles, int splits,
           int tiles_per_split, cudaStream_t stream) {
  static bool configured = false;  // above 48 KB only after opting in
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attn_bf16<NWQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)DH);
  dim3 grid(q_tiles, B * Hkv, splits);
  flash_attn_bf16<NWQ><<<grid, THREADS, SMEM, stream>>>(
      q, k, v, o, part_acc, part_ml, S, H, Hkv, T, t_real, causal,
      scale_log2, tiles_per_split);
  return (int)cudaGetLastError();
}

static_assert(4 * 16 * OSTR * sizeof(float) + 2 * 64 * sizeof(float) <=
                  (size_t)SMEM,
              "the merge scratch must fit over the k/v ring");

}  // namespace

extern "C" {

// Attention of bf16 q (B, S, H, 128) over k, v (B, T, Hkv, 128) into o.
// nwq = 4 (16-row warps, 64-row tiles) or 1 (16-row tiles, keys split over
// the warps); with splits > 1, part_acc (splits, B * Hkv * S * G, 128) and
// part_ml (splits, B * Hkv * S * G, 2) take the partials, and
// flash_combine_launch writes o.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* part_acc, void* part_ml, int B,
                           int S, int H, int Hkv, int T, int t_real,
                           int causal, int nwq, int q_tiles, int splits,
                           int tiles_per_split, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(o);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (nwq == 4)
    return launch<4>(qq, kk, vv, oo, pa, pm, B, S, H, Hkv, T, t_real, causal,
                     q_tiles, splits, tiles_per_split, stream);
  if (nwq == 1)
    return launch<1>(qq, kk, vv, oo, pa, pm, B, S, H, Hkv, T, t_real, causal,
                     q_tiles, splits, tiles_per_split, stream);
  return (int)cudaErrorInvalidValue;
}

int flash_combine_launch(const void* part_acc, const void* part_ml, void* o,
                         int B, int S, int H, int Hkv, int splits,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  long long n = (long long)B * Hkv * S * (H / Hkv) * DH;
  flash_combine<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<bf16*>(o), B * Hkv, S, H, Hkv, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
