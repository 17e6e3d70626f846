// Fused attention for Hopper (sm_90a): a forward kernel and a backward in
// two kernels. Scores and probabilities never reach device memory.
//
// A1: attn_fwd_kernel, attn_dq_kernel, attn_dkdv_kernel. They replace no
// Pallas kernel: the JAX package's attention (repro/models/attention.py)
// is plain jnp, a lax.scan over query blocks that XLA fuses on the TPU.
// The port's plain version (models/attention.py, the query-block loop
// around _sdpa) makes float32 copies of bf16 q and k, runs their product
// as a float32 SIMT GEMM over every key (the causal mask then throws half
// away), and writes the (B, H, block, S) float32 scores, scaled and biased
// scores and probabilities to device memory; under remat twice, and
// autograd's backward walks the same float32 tensors again.
//
// What bounds these kernels on this card: tensor-core FLOPs. At the
// training shapes (S = 4,096, head dim 64) a (query, key) pair costs
// 6 x hd FLOPs forward (QK^T twice, PV) and 18 x hd backward against a
// few bytes of q, k, v, o and dO per row, far above the card's 295 FLOPs
// a byte. The design:
//   * every product is a bf16 x bf16 mma.sync (m16n8k16) with float32
//     accumulation, its operands from shared memory by ldmatrix (rows
//     padded by 16 bytes, so the eight row addresses of one ldmatrix fall
//     on distinct banks) or, for P and dS, straight from the registers the
//     previous product left them in;
//   * a CTA of four warps owns 64 rows (queries in the forward and the dQ
//     kernel, keys in the dK/dV kernel), each warp 16; the other side
//     streams through a two-stage cp.async ring, one tile ahead; the
//     backward's output columns go in chunks of 64, a CTA each;
//   * tiles wholly above the diagonal or wholly outside the window are
//     never visited (they add exactly 0 in the plain version:
//     exp(-1e30 - max) = 0), and only the tiles that cut the diagonal, the
//     window's edge or a ragged end test each (row, column);
//   * the grid takes the heaviest causal tiles first.
// This first version keeps mma.sync, the simpler instruction; wgmma fed
// by a TMA ring, with the softmax in warps of its own, is the next step.
//
// Precision, against the plain version:
//   * S = QK^T: bf16 products are exact in float32, so this is its float32
//     product of bf16 copies up to the order of the sums. S is scaled by
//     hd^-0.5 in float32 and masked (causal j <= i, and i - j < window).
//   * The softmax is the plain version's, in float32, in two passes over
//     the key tiles: the first finds each row's max and its sum of
//     exponentials (online), the second computes P = exp(S - max) / sum
//     (the special function unit's 2^x and the sum's reciprocal, an ulp or
//     two from torch.softmax's expf and division) and rounds it to bf16
//     before the PV product, as the plain version's .to(bf16) does.
//     Rounding the unnormalised P in one pass (FlashAttention's order)
//     saves the second QK^T but moved the smoke configs' bf16 logits on
//     the card by up to 0.24 of the largest against the CPU, past the
//     2e-2 that holds the plain version: at the reference's init their
//     dynamics grow one rounding's change. PV accumulates in float32 and
//     is rounded to bf16 once; the forward saves the float32 log-sum-exp
//     for the backward.
//   * Backward: P = exp(S - lse) in float32, dP = dO V^T accumulates in
//     float32 (the plain version has it in bf16), dS = P (dP - delta) with
//     delta = rowsum(dO o O), times hd^-0.5, in float32. dS enters dQ and
//     dK as a two-term bf16 split, hi + lo, each product two MMAs with
//     float32 accumulation (about 16 significant bits of dS, its relative
//     residual ~2^-17, 256x below the bf16 rounding of dQ and dK). dV =
//     P^T dO with P rounded to bf16, as in the plain version.
//   * No atomics: dQ is its own pass over key tiles (which also computes
//     delta), dK and dV a pass over query tiles per key tile, summed over
//     the query heads of a shared kv head inside the CTA. Repeat runs give
//     the same bits.
//
// Layouts: q, out, dO and dQ are (B, Sq, H, hd), k, v, dK and dV (B, Sk,
// Hkv, hd), contiguous, hd one of 64, 128, 256 (the wrapper pads others);
// query head h reads kv head h / (H / Hkv), repeat_interleave's order. The
// log-sum-exp and delta are float32 (B, H, Sq). The mask is by index: key
// j is visible to query i iff i < Sq, j < Sk and, with causal set (Sq ==
// Sk), j <= i and, with window > 0, i - j < window.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // a CTA's own rows, 16 per warp
constexpr int kTile = 64;           // the other side's rows per backward step
constexpr int kChunk = 64;          // output columns per backward pass
constexpr int kPad = 8;             // bf16 of padding per shared-memory row
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  bf16* out;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* lse;
  float* delta;
  int h, hkv, sq, sk, causal, window;
  float scale;
};

// ------------------------------------------------------------ masks

__device__ __forceinline__ bool visible(const Args& a, int i, int j) {
  if (i >= a.sq || j >= a.sk) return false;
  if (!a.causal) return true;
  return j <= i && (a.window <= 0 || i - j < a.window);
}

// every (query, key) of [i0, i0 + ni) x [j0, j0 + nj) is visible
__device__ __forceinline__ bool whole(const Args& a, int i0, int ni, int j0,
                                      int nj) {
  if (i0 + ni > a.sq || j0 + nj > a.sk) return false;
  if (!a.causal) return true;
  return j0 + nj - 1 <= i0 && (a.window <= 0 || i0 + ni - 1 - j0 < a.window);
}

// the keys [k0, k1) that queries [i0, i1) see
__device__ __forceinline__ void key_range(const Args& a, int i0, int i1,
                                          int& k0, int& k1) {
  k0 = 0;
  k1 = a.sk;
  if (a.causal) {
    k1 = min(a.sk, i1);
    if (a.window > 0) k0 = max(0, i0 - a.window + 1);
  }
}

// the queries [i0, i1) that see keys [j0, j1)
__device__ __forceinline__ void query_range(const Args& a, int j0, int j1,
                                            int& i0, int& i1) {
  i0 = 0;
  i1 = a.sq;
  if (a.causal) {
    i0 = j0;
    if (a.window > 0) i1 = min(a.sq, j1 - 1 + a.window);
  }
}

// ------------------------------------------------- copies and fragments

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, global to shared; zeros where !ok
__device__ __forceinline__ void cp16(bf16* dst, const bf16* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes, global to shared; zero where !ok
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [0, R) of a (R, HD) tile into shared memory (row stride HD + kPad)
// from global rows of stride ld, of which the first n exist (the rest
// read as zeros)
template <int R, int HD>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g, int64_t ld,
                                          int n) {
  constexpr int kPerRow = HD / 8;
  static_assert((R * kPerRow) % kThreads == 0, "tile/threads");
#pragma unroll
  for (int it = 0; it < R * kPerRow / kThreads; ++it) {
    const int c = it * kThreads + threadIdx.x;
    const int r = c / kPerRow, col = (c % kPerRow) * 8;
    const bool ok = r < n;
    cp16(s + r * (HD + kPad) + col, ok ? g + r * ld + col : g, ok);
  }
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16) b (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack(float x, float y) {
  return bits(__floats2bfloat162_rn(x, y));
}

// (x, y) = hi + lo, each a bf16 pair; hi is pack(x, y)
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack(x - f.x, y - f.y);
}

// acc (16 x N) += A B^T: A the 16 rows from r0 of sA (16 x K), B the N
// rows of sB (N x K), both row-major in shared memory
template <int N, int K>
__device__ __forceinline__ void mm_nk(float (&acc)[N / 8][4], const bf16* sA,
                                      int lda, int r0, const bf16* sB,
                                      int ldb) {
  const int l = threadIdx.x & 31;
  const bf16* pa = sA + (r0 + (l & 7) + ((l >> 3) & 1) * 8) * lda + (l >> 4) * 8;
  const bf16* pb = sB + ((l & 7) + (l >> 4) * 8) * ldb + ((l >> 3) & 1) * 8;
#pragma unroll
  for (int k = 0; k < K; k += 16) {
    uint32_t a[4];
    ldsm4(a, pa + k);
#pragma unroll
    for (int n = 0; n < N; n += 16) {
      uint32_t b[4];
      ldsm4(b, pb + n * ldb + k);
      mma(acc[n / 8], a, b[0], b[1]);
      mma(acc[n / 8 + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x NC) += A B: A (16 x K) in registers as m16k16 fragments, B
// the K rows of sB (row-major K x *) from column c0
template <int NC, int K>
__device__ __forceinline__ void mm_kn(float (&acc)[NC / 8][4],
                                      const uint32_t (&a)[K / 16][4],
                                      const bf16* sB, int ldb, int c0) {
  const int l = threadIdx.x & 31;
  const bf16* pb = sB + ((l & 7) + ((l >> 3) & 1) * 8) * ldb + c0 + (l >> 4) * 8;
#pragma unroll
  for (int k = 0; k < K / 16; ++k) {
#pragma unroll
    for (int n = 0; n < NC; n += 16) {
      uint32_t b[4];
      ldsm4t(b, pb + k * 16 * ldb + n);
      mma(acc[n / 8], a[k], b[0], b[1]);
      mma(acc[n / 8 + 1], a[k], b[2], b[3]);
    }
  }
}

// a 16 x K float32 accumulator tile as bf16 A fragments
template <int K>
__device__ __forceinline__ void to_a(uint32_t (&a)[K / 16][4],
                                     const float (&c)[K / 8][4]) {
#pragma unroll
  for (int k = 0; k < K / 16; ++k) {
    a[k][0] = pack(c[2 * k][0], c[2 * k][1]);
    a[k][1] = pack(c[2 * k][2], c[2 * k][3]);
    a[k][2] = pack(c[2 * k + 1][0], c[2 * k + 1][1]);
    a[k][3] = pack(c[2 * k + 1][2], c[2 * k + 1][3]);
  }
}

// the same as a hi + lo pair of bf16 A fragments
template <int K>
__device__ __forceinline__ void to_a_split(uint32_t (&hi)[K / 16][4],
                                           uint32_t (&lo)[K / 16][4],
                                           const float (&c)[K / 8][4]) {
#pragma unroll
  for (int k = 0; k < K / 16; ++k) {
    split(c[2 * k][0], c[2 * k][1], hi[k][0], lo[k][0]);
    split(c[2 * k][2], c[2 * k][3], hi[k][1], lo[k][1]);
    split(c[2 * k + 1][0], c[2 * k + 1][1], hi[k][2], lo[k][2]);
    split(c[2 * k + 1][2], c[2 * k + 1][3], hi[k][3], lo[k][3]);
  }
}

// a 16 x N float32 tile of a warp, rounded to bf16, into rows from r0 of
// a row-major global array (row stride ld) from column c0; rows at or
// past n are not written
template <int N>
__device__ __forceinline__ void store_rows(bf16* g, int64_t ld, int r0, int n,
                                           int c0, const float (&c)[N / 8][4]) {
  const int l = threadIdx.x & 31;
  const int ra = r0 + (l >> 2), rb = ra + 8;
#pragma unroll
  for (int t = 0; t < N / 8; ++t) {
    const int col = c0 + t * 8 + 2 * (l & 3);
    if (ra < n)
      *reinterpret_cast<__nv_bfloat162*>(g + ra * ld + col) =
          __floats2bfloat162_rn(c[t][0], c[t][1]);
    if (rb < n)
      *reinterpret_cast<__nv_bfloat162*>(g + rb * ld + col) =
          __floats2bfloat162_rn(c[t][2], c[t][3]);
  }
}

// 2^x by the special function unit (about 2 ulp; results under 2^-126
// flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------ forward

// s (a warp's 16 rows x BC keys from j0) = QK^T x scale, -inf where a
// key is not visible to the row
template <int HD, int BC>
__device__ __forceinline__ void scores(float (&s)[BC / 8][4], const Args& a,
                                       const bf16* sQ, const bf16* cK, int r0,
                                       const int (&row)[2], int q0, int j0) {
  constexpr int LD = HD + kPad;
  mm_nk<BC, HD>(s, sQ, LD, r0, cK, LD);
  const bool edge = !whole(a, q0, kRows, j0, BC);
  const int c = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int n = 0; n < BC / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] *= a.scale;
      if (edge && !visible(a, row[e >> 1], j0 + n * 8 + c + (e & 1)))
        s[n][e] = -INFINITY;
    }
  }
}

// one CTA: kRows queries of one (batch, head) against their key tiles
template <int HD, int BC>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_kernel(const Args a) {
  constexpr int LD = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kRows * LD;      // two stages of BC rows
  bf16* sV = sK + 2 * BC * LD;     // two stages of BC rows
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int nq = (a.sq + kRows - 1) / kRows;
  const int q0 = (nq - 1 - blockIdx.x) * kRows;  // the longest rows first
  const int b = blockIdx.y / a.h, h = blockIdx.y % a.h;
  const int g = h / (a.h / a.hkv);
  const int64_t ldq = (int64_t)a.h * HD, ldk = (int64_t)a.hkv * HD;
  const bf16* Q = a.q + ((int64_t)b * a.sq * a.h + h) * HD + q0 * ldq;
  const bf16* K = a.k + ((int64_t)b * a.sk * a.hkv + g) * HD;
  const bf16* V = a.v + ((int64_t)b * a.sk * a.hkv + g) * HD;
  int k0, k1;
  key_range(a, q0, min(q0 + kRows, a.sq), k0, k1);
  const int t0 = k0 / BC, t1 = (k1 + BC - 1) / BC;

  load_rows<kRows, HD>(sQ, Q, ldq, a.sq - q0);
  if (t0 < t1) load_rows<BC, HD>(sK, K + t0 * BC * ldk, ldk, a.sk - t0 * BC);
  cp_commit();

  // pass 1: each row's max and sum of exponentials, online over the key
  // tiles (K alone)
  const int row[2] = {q0 + r0 + (lane >> 2), q0 + r0 + (lane >> 2) + 8};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < t1) {
      const int j = (t + 1) * BC;
      load_rows<BC, HD>(sK + (st ^ 1) * BC * LD, K + j * ldk, ldk, a.sk - j);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float s[BC / 8][4] = {};
    scores<HD, BC>(s, a, sQ, sK + st * BC * LD, r0, row, q0, t * BC);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    float base[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      l[r] *= ex2((m[r] - base[r]) * kLog2e);
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rs[e >> 1] += ex2((s[n][e] - base[e >> 1]) * kLog2e);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] += rs[r];
    __syncthreads();
  }

  // pass 2: P = exp(x - max) / sum in float32 (the plain version's
  // softmax, to an ulp or two), rounded to bf16, times V
  float base[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    base[r] = m[r] == -INFINITY ? 0.f : m[r] * kLog2e;
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  if (t0 < t1) {
    load_rows<BC, HD>(sK, K + t0 * BC * ldk, ldk, a.sk - t0 * BC);
    load_rows<BC, HD>(sV, V + t0 * BC * ldk, ldk, a.sk - t0 * BC);
  }
  cp_commit();
  float o[HD / 8][4] = {};
  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < t1) {
      const int j = (t + 1) * BC;
      load_rows<BC, HD>(sK + (st ^ 1) * BC * LD, K + j * ldk, ldk, a.sk - j);
      load_rows<BC, HD>(sV + (st ^ 1) * BC * LD, V + j * ldk, ldk, a.sk - j);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float s[BC / 8][4] = {};
    scores<HD, BC>(s, a, sQ, sK + st * BC * LD, r0, row, q0, t * BC);
#pragma unroll
    for (int n = 0; n < BC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = ex2(fmaf(s[n][e], kLog2e, -base[e >> 1])) * inv[e >> 1];
    uint32_t p[BC / 16][4];
    to_a<BC>(p, s);
    mm_kn<HD, BC>(o, p, sV + st * BC * LD, LD, 0);
    __syncthreads();
  }

  store_rows<HD>(a.out + ((int64_t)b * a.sq * a.h + h) * HD + q0 * ldq, ldq,
                 r0, a.sq - q0, 0, o);
  if ((lane & 3) == 0) {
    float* lse = a.lse + ((int64_t)b * a.h + h) * a.sq;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row[r] < a.sq) lse[row[r]] = m[r] + logf(l[r]);
  }
}

// ----------------------------------------------------------- backward

// one CTA: kChunk columns (blockIdx.z) of dQ of kRows queries of one
// (batch, head), a pass over their key tiles; first delta = rowsum(dO o O)
// of its rows (written by the CTA of the first columns)
template <int HD>
__global__ void __launch_bounds__(kThreads) attn_dq_kernel(const Args a) {
  constexpr int LD = HD + kPad, BC = kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + kRows * LD;      // dO
  bf16* sK = sO + kRows * LD;      // two stages of BC rows
  bf16* sV = sK + 2 * BC * LD;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int nq = (a.sq + kRows - 1) / kRows;
  const int q0 = (nq - 1 - blockIdx.x) * kRows;
  const int b = blockIdx.y / a.h, h = blockIdx.y % a.h;
  const int g = h / (a.h / a.hkv);
  const int64_t ldq = (int64_t)a.h * HD, ldk = (int64_t)a.hkv * HD;
  const int64_t qoff = ((int64_t)b * a.sq * a.h + h) * HD + q0 * ldq;
  const bf16* K = a.k + ((int64_t)b * a.sk * a.hkv + g) * HD;
  const bf16* V = a.v + ((int64_t)b * a.sk * a.hkv + g) * HD;
  const int64_t lrow = ((int64_t)b * a.h + h) * a.sq;
  int k0, k1;
  key_range(a, q0, min(q0 + kRows, a.sq), k0, k1);
  const int t0 = k0 / BC, t1 = (k1 + BC - 1) / BC;

  load_rows<kRows, HD>(sQ, a.q + qoff, ldq, a.sq - q0);
  load_rows<kRows, HD>(sO, a.dout + qoff, ldq, a.sq - q0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // delta of the warp's 16 rows, each by the whole warp
  float dl[2] = {0.f, 0.f};
  for (int rr = 0; rr < 16; ++rr) {
    const int i = r0 + rr;
    float acc = 0.f;
    if (q0 + i < a.sq) {
      const bf16* orow = a.o + qoff + i * ldq;
      for (int d = 2 * lane; d < HD; d += 64) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sO + i * LD + d));
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(orow + d));
        acc += x.x * y.x + x.y * y.y;
      }
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (rr == (lane >> 2)) dl[0] = acc;
    if (rr == (lane >> 2) + 8) dl[1] = acc;
    if (lane == 0 && blockIdx.z == 0 && q0 + i < a.sq)
      a.delta[lrow + q0 + i] = acc;
  }
  const int row[2] = {q0 + r0 + (lane >> 2), q0 + r0 + (lane >> 2) + 8};
  const float ls[2] = {row[0] < a.sq ? a.lse[lrow + row[0]] : 0.f,
                       row[1] < a.sq ? a.lse[lrow + row[1]] : 0.f};

  const int c0 = blockIdx.z * kChunk;  // this CTA's output columns
  if (t0 < t1) {
    load_rows<BC, HD>(sK, K + t0 * BC * ldk, ldk, a.sk - t0 * BC);
    load_rows<BC, HD>(sV, V + t0 * BC * ldk, ldk, a.sk - t0 * BC);
  }
  cp_commit();
  float dq[kChunk / 8][4] = {};
  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < t1) {
      const int j = (t + 1) * BC;
      load_rows<BC, HD>(sK + (st ^ 1) * BC * LD, K + j * ldk, ldk, a.sk - j);
      load_rows<BC, HD>(sV + (st ^ 1) * BC * LD, V + j * ldk, ldk, a.sk - j);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + st * BC * LD;
    const bf16* cV = sV + st * BC * LD;
    float s[BC / 8][4] = {}, dp[BC / 8][4] = {};
    mm_nk<BC, HD>(s, sQ, LD, r0, cK, LD);
    mm_nk<BC, HD>(dp, sO, LD, r0, cV, LD);
    const int j0 = t * BC;
    const bool edge = !whole(a, q0, kRows, j0, BC);
#pragma unroll
    for (int n = 0; n < BC / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = ex2((s[n][e] * a.scale - ls[r]) * kLog2e);
        if (edge && !visible(a, row[r], j0 + n * 8 + 2 * (lane & 3) + (e & 1)))
          p = 0.f;
        s[n][e] = p * (dp[n][e] - dl[r]) * a.scale;
      }
    }
    uint32_t hi[BC / 16][4], lo[BC / 16][4];
    to_a_split<BC>(hi, lo, s);
    mm_kn<kChunk, BC>(dq, hi, cK, LD, c0);
    mm_kn<kChunk, BC>(dq, lo, cK, LD, c0);
    __syncthreads();
  }
  store_rows<kChunk>(a.dq + qoff, ldq, r0, a.sq - q0, c0, dq);
}

// one CTA: kChunk columns (blockIdx.z) of dK and dV of kRows keys of one
// (batch, kv head), a pass over the query tiles of every query head that
// reads them. The column chunks of a backward are CTAs of their own: each
// recomputes S and dP over the whole head dim (a 16 x (64 + 64) float32
// accumulator pair a warp fits its registers; hd 256's would not), and
// an MQA call (one kv head) still fills the card.
template <int HD>
__global__ void __launch_bounds__(kThreads) attn_dkdv_kernel(const Args a) {
  constexpr int LD = HD + kPad, BR = kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kRows * LD;
  bf16* sQ = sV + kRows * LD;      // two stages of BR rows
  bf16* sO = sQ + 2 * BR * LD;     // dO, two stages of BR rows
  float* sL = reinterpret_cast<float*>(sO + 2 * BR * LD);  // lse, 2 x BR
  float* sD = sL + 2 * BR;                                  // delta, 2 x BR
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const int j0 = blockIdx.x * kRows;  // causal: the most query tiles first
  const int b = blockIdx.y / a.hkv, g = blockIdx.y % a.hkv;
  const int nrep = a.h / a.hkv;
  const int64_t ldq = (int64_t)a.h * HD, ldk = (int64_t)a.hkv * HD;
  const int64_t koff = ((int64_t)b * a.sk * a.hkv + g) * HD + j0 * ldk;
  int i0, i1;
  query_range(a, j0, min(j0 + kRows, a.sk), i0, i1);
  const int t0 = i0 / BR, nt = max(0, (i1 + BR - 1) / BR - t0);
  const int steps = nrep * nt;  // (query head, query tile) pairs

  load_rows<kRows, HD>(sK, a.k + koff, ldk, a.sk - j0);
  load_rows<kRows, HD>(sV, a.v + koff, ldk, a.sk - j0);
  cp_commit();

  // step s: query head g * nrep + s / nt, query tile t0 + s % nt
  auto load_step = [&](int s, int st) {
    const int hh = g * nrep + s / nt, q = (t0 + s % nt) * BR;
    const int64_t off = ((int64_t)b * a.sq * a.h + hh) * HD + q * ldq;
    load_rows<BR, HD>(sQ + st * BR * LD, a.q + off, ldq, a.sq - q);
    load_rows<BR, HD>(sO + st * BR * LD, a.dout + off, ldq, a.sq - q);
    if (threadIdx.x < BR) {
      const int64_t li = ((int64_t)b * a.h + hh) * a.sq + q + threadIdx.x;
      const bool ok = q + (int)threadIdx.x < a.sq;
      cp4(sL + st * BR + threadIdx.x, ok ? a.lse + li : a.lse, ok);
      cp4(sD + st * BR + threadIdx.x, ok ? a.delta + li : a.delta, ok);
    }
  };

  const int key[2] = {j0 + r0 + (lane >> 2), j0 + r0 + (lane >> 2) + 8};
  const int c0 = blockIdx.z * kChunk;  // this CTA's output columns
  if (steps > 0) load_step(0, 0);
  cp_commit();
  float dk[kChunk / 8][4] = {}, dv[kChunk / 8][4] = {};
  for (int s = 0; s < steps; ++s) {
    const int st = s & 1;
    if (s + 1 < steps) {
      load_step(s + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* cQ = sQ + st * BR * LD;
    const bf16* cO = sO + st * BR * LD;
    const float* cL = sL + st * BR;
    const float* cD = sD + st * BR;
    float p[BR / 8][4] = {}, ds[BR / 8][4] = {};
    mm_nk<BR, HD>(p, sK, LD, r0, cQ, LD);   // S^T
    mm_nk<BR, HD>(ds, sV, LD, r0, cO, LD);  // dP^T
    const int q = (t0 + s % nt) * BR;
    const bool edge = !whole(a, q, BR, j0, kRows);
#pragma unroll
    for (int n = 0; n < BR / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * (lane & 3) + (e & 1);
        float x = ex2((p[n][e] * a.scale - cL[c]) * kLog2e);
        if (edge && !visible(a, q + c, key[e >> 1])) x = 0.f;
        p[n][e] = x;
        ds[n][e] = x * (ds[n][e] - cD[c]) * a.scale;
      }
    }
    uint32_t pa[BR / 16][4];
    to_a<BR>(pa, p);
    mm_kn<kChunk, BR>(dv, pa, cO, LD, c0);
    uint32_t hi[BR / 16][4], lo[BR / 16][4];
    to_a_split<BR>(hi, lo, ds);
    mm_kn<kChunk, BR>(dk, hi, cQ, LD, c0);
    mm_kn<kChunk, BR>(dk, lo, cQ, LD, c0);
    __syncthreads();
  }
  store_rows<kChunk>(a.dk + koff, ldk, r0, a.sk - j0, c0, dk);
  store_rows<kChunk>(a.dv + koff, ldk, r0, a.sk - j0, c0, dv);
}

// ------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t run(Kernel kernel, dim3 grid, size_t smem, cudaStream_t st,
                const Args& a) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t forward(const Args& a, int batch, cudaStream_t st) {
  constexpr int BC = HD == 256 ? 32 : 64;
  const size_t smem = (size_t)(kRows + 4 * BC) * (HD + kPad) * sizeof(bf16);
  const dim3 grid((a.sq + kRows - 1) / kRows, batch * a.h);
  return run(attn_fwd_kernel<HD, BC>, grid, smem, st, a);
}

template <int HD>
cudaError_t backward(const Args& a, int batch, cudaStream_t st) {
  const size_t tiles =
      (size_t)(2 * kRows + 4 * kTile) * (HD + kPad) * sizeof(bf16);
  cudaError_t err = run(attn_dq_kernel<HD>,
                        dim3((a.sq + kRows - 1) / kRows, batch * a.h,
                             HD / kChunk),
                        tiles, st, a);
  if (err != cudaSuccess) return err;
  return run(attn_dkdv_kernel<HD>,
             dim3((a.sk + kRows - 1) / kRows, batch * a.hkv, HD / kChunk),
             tiles + 4 * kTile * sizeof(float), st, a);
}

Args make_args(int32_t heads, int32_t kv_heads, int32_t sq, int32_t sk,
               int32_t causal, int32_t window, float scale) {
  Args a = {};
  a.h = heads;
  a.hkv = kv_heads;
  a.sq = sq;
  a.sk = sk;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  return a;
}

bool shapes_ok(int32_t batch, int32_t heads, int32_t kv_heads, int32_t sq,
               int32_t sk, int32_t causal) {
  return batch > 0 && heads > 0 && kv_heads > 0 && heads % kv_heads == 0 &&
         sq > 0 && sk > 0 && (!causal || sq == sk);
}

}  // namespace

extern "C" {

// out (B, Sq, H, hd) bf16 and lse (B, H, Sq) float32 from q (B, Sq, H,
// hd), k and v (B, Sk, Hkv, hd), bf16, contiguous; hd 64, 128 or 256;
// window 0: none
int attn_fwd(const void* q, const void* k, const void* v, void* out,
             void* lse, int32_t batch, int32_t heads, int32_t kv_heads,
             int32_t sq, int32_t sk, int32_t hd, int32_t causal,
             int32_t window, float scale, int32_t device, void* stream) {
  if (!shapes_ok(batch, heads, kv_heads, sq, sk, causal))
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  Args a = make_args(heads, kv_heads, sq, sk, causal, window, scale);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.out = static_cast<bf16*>(out);
  a.lse = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return forward<64>(a, batch, st);
    case 128: return forward<128>(a, batch, st);
    case 256: return forward<256>(a, batch, st);
    default: return cudaErrorInvalidValue;
  }
}

// dq, dk, dv (the layouts of q, k, v) from the forward's inputs, its out
// and lse, and dout (out's layout); delta (B, H, Sq) float32 is scratch
int attn_bwd(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const void* lse, void* delta, void* dq,
             void* dk, void* dv, int32_t batch, int32_t heads,
             int32_t kv_heads, int32_t sq, int32_t sk, int32_t hd,
             int32_t causal, int32_t window, float scale, int32_t device,
             void* stream) {
  if (!shapes_ok(batch, heads, kv_heads, sq, sk, causal))
    return cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  Args a = make_args(heads, kv_heads, sq, sk, causal, window, scale);
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<const bf16*>(out);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = const_cast<float*>(static_cast<const float*>(lse));
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return backward<64>(a, batch, st);
    case 128: return backward<128>(a, batch, st);
    case 256: return backward<256>(a, batch, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
