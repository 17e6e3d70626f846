// The exact three-piece bf16 split of a float32 cotangent, for the
// backward of a product whose forward multiplies bf16 operands into a
// float32 result (models/layers.py, dot(f32=True) on the card).
//
// G1: bf16x3_split_vec4_kernel (bf16x3_split_kernel where a row or its
// stride is not a multiple of four). It replaces no Pallas kernel: the
// JAX package leaves such products to XLA (preferred_element_type), whose
// transpose rule (jax/_src/lax/lax.py, _dot_general_transpose_lhs and
// _rhs) multiplies the float32 cotangent by the bf16 operand and rounds
// only the product to bf16. Rounding the cotangent to bf16 first would be
// a lower precision than the reference's. The port's backward instead
// writes each cotangent value g as hi + mid + lo, three bf16 values taken
// by round-to-nearest from what is left of g:
//   hi = bf16(g), mid = bf16(g - hi), lo = bf16(g - hi - mid).
// Each difference is exact in float32 (the pieces share g's leading bits),
// and three pieces of 8 significant bits, each signed, hold all 24 bits of
// g's significand: the sum is g exactly, unless a piece falls below bf16's
// smallest normal (|g| under about 2^-110), where bf16's subnormals keep
// fewer bits. bf16 has float32's exponent range, so nothing else can
// overflow or underflow; a g past bf16's largest finite value (it rounds
// hi to inf) takes hi by truncation instead, and a non-finite g is hi
// alone. The pieces then enter bf16 tensor-core GEMMs against the saved
// bf16 operand, accumulated in float32 over all three pieces at once.
//
// What bounds it on this card: bytes. It reads 4 bytes of g and writes 6
// of pieces an element, and does a handful of flops on them. The design:
// each thread takes four consecutive values of a row (one 16-byte load)
// and writes them straight into the (rows, 3, n) layout that the GEMMs
// read, one 8-byte store a piece; the grid's x runs over a row's columns
// and its y over the rows (a loop past 65,535 of them), with 64-bit
// offsets (the head's cotangent has 8.2e8 values). The input
// may be a column block of a wider matrix (its row stride ld >= n). A row
// length or stride that is not a multiple of four, or a pointer that is
// not aligned to the vector width, takes the one-value-a-thread variant.

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Pieces {
  bf16 hi, mid, lo;
};

__device__ __forceinline__ Pieces split3(float x) {
  const bf16 zero = __float2bfloat16_rn(0.0f);
  if (!isfinite(x)) return {__float2bfloat16_rn(x), zero, zero};
  bf16 hi = __float2bfloat16_rn(x);
  if (isinf(__bfloat162float(hi))) hi = __float2bfloat16_rz(x);
  const float r = __fsub_rn(x, __bfloat162float(hi));
  const bf16 mid = __float2bfloat16_rn(r);
  const bf16 lo = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mid)));
  return {hi, mid, lo};
}

// four bf16 values as one 8-byte word, the lowest address first
__device__ __forceinline__ uint2 pack4(bf16 a, bf16 b, bf16 c, bf16 d) {
  uint2 w;
  w.x = static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
        (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
  w.y = static_cast<uint32_t>(__bfloat16_as_ushort(c)) |
        (static_cast<uint32_t>(__bfloat16_as_ushort(d)) << 16);
  return w;
}

// g (rows, n) at row stride ld, float32 -> out (rows, 3, n) bf16; n and
// ld multiples of 4, both pointers aligned to 16 and 8 bytes. A block
// takes kThreads x 4 columns (blockIdx.x) of every gridDim.y-th row.
__global__ void bf16x3_split_vec4_kernel(const float* __restrict__ g,
                                         bf16* __restrict__ out,
                                         int64_t rows, int64_t n,
                                         int64_t ld) {
  const int64_t c = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) * 4;
  if (c >= n) return;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const float4 v = *reinterpret_cast<const float4*>(g + r * ld + c);
    const Pieces p0 = split3(v.x), p1 = split3(v.y), p2 = split3(v.z),
                 p3 = split3(v.w);
    bf16* o = out + r * 3 * n + c;
    *reinterpret_cast<uint2*>(o) = pack4(p0.hi, p1.hi, p2.hi, p3.hi);
    *reinterpret_cast<uint2*>(o + n) =
        pack4(p0.mid, p1.mid, p2.mid, p3.mid);
    *reinterpret_cast<uint2*>(o + 2 * n) =
        pack4(p0.lo, p1.lo, p2.lo, p3.lo);
  }
}

// the same, one value a thread, for any n, ld and alignment
__global__ void bf16x3_split_kernel(const float* __restrict__ g,
                                    bf16* __restrict__ out, int64_t rows,
                                    int64_t n, int64_t ld) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (c >= n) return;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const Pieces p = split3(g[r * ld + c]);
    bf16* o = out + r * 3 * n + c;
    o[0] = p.hi;
    o[n] = p.mid;
    o[2 * n] = p.lo;
  }
}

constexpr int kThreads = 256;
// rows a launch spreads over its grid's y (the rest loop): CUDA's limit
constexpr int64_t kMaxRowBlocks = 65535;

}  // namespace

extern "C" {

// out (rows, 3, n) bf16, contiguous, the pieces hi, mid, lo of each row of
// g (rows, n) float32 at row stride ld (ld >= n)
int bf16x3_split(const void* g, void* out, int64_t rows, int64_t n,
                 int64_t ld, int32_t device, void* stream) {
  if (rows < 0 || n < 0 || ld < n) return cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return cudaSuccess;
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  bf16* op = static_cast<bf16*>(out);
  const bool vec = n % 4 == 0 && ld % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const int64_t per_block = vec ? kThreads * 4 : kThreads;
  const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block),
                  static_cast<unsigned>(std::min(rows, kMaxRowBlocks)));
  if (vec)
    bf16x3_split_vec4_kernel<<<grid, kThreads, 0, st>>>(gp, op, rows, n,
                                                        ld);
  else
    bf16x3_split_kernel<<<grid, kThreads, 0, st>>>(gp, op, rows, n, ld);
  return cudaGetLastError();
}

}  // extern "C"
