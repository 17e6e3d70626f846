// Father-son XOR-delta codec and bitfield kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/:
//   B6 fpdelta_kernel.encode_groups (fpdelta_kernel.py:60) -> encode_groups_kernel
//   B7 fpdelta_kernel.decode_groups (fpdelta_kernel.py:96) -> decode_groups_kernel
//   B8 bitpack_kernel.pack          (bitpack_kernel.py:26) -> bitpack_kernel
//   B9 bitpack_kernel.unpack        (bitpack_kernel.py:49) -> bitunpack_kernel
//
// Words are 32-bit patterns (the wrappers hand int32 tensors over as
// unsigned int). All four kernels do a few integer instructions per word
// moved, so each is bound by memory bytes: the designs read every input
// word once, write every output word once, in coalesced order, and need
// no padding of the ragged edge (the TPU kernels' (8, 1024) and (32, 1024)
// tiles exist for its sublanes and lanes; here each thread masks itself).
//   * B6: one thread per group g. The (S, G) layout puts neighbouring
//     groups on neighbouring words of each son row, so a warp's loads of
//     one row are coalesced. The thread XORs its S sons with their
//     predictors, writes both residue rows, ORs the residues in registers
//     and takes the hardware __clz (32 for 0, as ref.clz32_ref's bit-smear
//     and popcount give) — no shared memory, no second pass.
//   * B7: an elementwise XOR over both word arrays, 16 bytes a thread
//     (uint4 loads) when every pointer is 16-byte aligned, else words.
//   * B8: one warp per output word. Lane i reads flag 32w + i of the flat
//     byte array and __ballot_sync gives the word in one instruction; flags
//     past n read as 0, so the ragged last word is exact.
//   * B9: one thread per output flag, (words[i >> 5] >> (i & 31)) & 1.
//
// B7's whole cost is its call: its device time sits under the HBM bound,
// so its wrapper does the least host work a launch allows (one output
// allocation, no copies of contiguous inputs; cudalib.launch).
//
// Plain C interface (loaded with ctypes); every entry takes the tensors'
// device index (see device_guard.cuh), launches on the given stream, never
// synchronizes, and returns cudaGetLastError(). Sizes are positive: the
// wrappers launch nothing for empty inputs.

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// ------------------------------------------------------------- B6 encode

__global__ void encode_groups_kernel(const uint32_t* __restrict__ pred_hi,
                                     const uint32_t* __restrict__ pred_lo,
                                     const uint32_t* __restrict__ son_hi,
                                     const uint32_t* __restrict__ son_lo,
                                     int32_t s, int64_t g, int32_t width,
                                     int32_t cap,
                                     uint32_t* __restrict__ res_hi,
                                     uint32_t* __restrict__ res_lo,
                                     int32_t* __restrict__ nlz) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= g) return;
  uint32_t m_hi = 0, m_lo = 0;
#pragma unroll 8
  for (int32_t i = 0; i < s; ++i) {
    const int64_t k = (int64_t)i * g + j;
    const uint32_t rh = son_hi[k] ^ pred_hi[k];
    const uint32_t rl = son_lo[k] ^ pred_lo[k];
    res_hi[k] = rh;
    res_lo[k] = rl;
    m_hi |= rh;
    m_lo |= rl;
  }
  int32_t z;
  if (width == 64) {
    z = m_hi != 0 ? __clz((int)m_hi) : 32 + __clz((int)m_lo);
  } else if (width == 32) {
    z = __clz((int)m_lo);
  } else {  // 16-bit payloads in the low word
    z = __clz((int)m_lo) - 16;
  }
  nlz[j] = min(z, cap);
}

// ------------------------------------------------------------- B7 decode

// Thread t owns words [4t, 4t + 4); kVec: one uint4 load per array.
template <bool kVec>
__global__ void decode_groups_kernel(const uint32_t* __restrict__ res_hi,
                                     const uint32_t* __restrict__ res_lo,
                                     const uint32_t* __restrict__ pred_hi,
                                     const uint32_t* __restrict__ pred_lo,
                                     int64_t n,
                                     uint32_t* __restrict__ son_hi,
                                     uint32_t* __restrict__ son_lo) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t i = 4 * t;
  if (kVec && i + 4 <= n) {
    const uint4 rh = reinterpret_cast<const uint4*>(res_hi)[t];
    const uint4 ph = reinterpret_cast<const uint4*>(pred_hi)[t];
    const uint4 rl = reinterpret_cast<const uint4*>(res_lo)[t];
    const uint4 pl = reinterpret_cast<const uint4*>(pred_lo)[t];
    reinterpret_cast<uint4*>(son_hi)[t] =
        make_uint4(rh.x ^ ph.x, rh.y ^ ph.y, rh.z ^ ph.z, rh.w ^ ph.w);
    reinterpret_cast<uint4*>(son_lo)[t] =
        make_uint4(rl.x ^ pl.x, rl.y ^ pl.y, rl.z ^ pl.z, rl.w ^ pl.w);
    return;
  }
  for (int64_t k = i; k < i + 4 && k < n; ++k) {
    son_hi[k] = res_hi[k] ^ pred_hi[k];
    son_lo[k] = res_lo[k] ^ pred_lo[k];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ------------------------------------------------------- B8/B9 bitfields

// Thread i is flag i; every lane of a warp reaches the ballot.
__global__ void bitpack_kernel(const uint8_t* __restrict__ bits, int64_t n,
                               int64_t n_words,
                               uint32_t* __restrict__ words) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = i < n && bits[i] != 0;
  const uint32_t word = __ballot_sync(0xffffffffu, on);
  if ((threadIdx.x & 31) == 0 && (i >> 5) < n_words) words[i >> 5] = word;
}

__global__ void bitunpack_kernel(const uint32_t* __restrict__ words,
                                 int64_t n, uint8_t* __restrict__ bits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) bits[i] = (words[i >> 5] >> (i & 31)) & 1u;
}

}  // namespace

extern "C" {

int codec_encode_groups(const uint32_t* pred_hi, const uint32_t* pred_lo,
                        const uint32_t* son_hi, const uint32_t* son_lo,
                        int32_t s, int64_t g, int32_t width, int32_t cap,
                        uint32_t* res_hi, uint32_t* res_lo, int32_t* nlz,
                        int32_t device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  encode_groups_kernel<<<ceil_div(g, kThreads), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      pred_hi, pred_lo, son_hi, son_lo, s, g, width, cap, res_hi, res_lo,
      nlz);
  return cudaGetLastError();
}

int codec_decode_groups(const uint32_t* res_hi, const uint32_t* res_lo,
                        const uint32_t* pred_hi, const uint32_t* pred_lo,
                        int64_t n, uint32_t* son_hi, uint32_t* son_lo,
                        int32_t device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t blocks = ceil_div(ceil_div(n, 4), kThreads);
  if (aligned16(res_hi) && aligned16(res_lo) && aligned16(pred_hi) &&
      aligned16(pred_lo) && aligned16(son_hi) && aligned16(son_lo)) {
    decode_groups_kernel<true><<<blocks, kThreads, 0, st>>>(
        res_hi, res_lo, pred_hi, pred_lo, n, son_hi, son_lo);
  } else {
    decode_groups_kernel<false><<<blocks, kThreads, 0, st>>>(
        res_hi, res_lo, pred_hi, pred_lo, n, son_hi, son_lo);
  }
  return cudaGetLastError();
}

int codec_bitpack(const uint8_t* bits, int64_t n, uint32_t* words,
                  int32_t device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  const int64_t n_words = ceil_div(n, 32);
  bitpack_kernel<<<ceil_div(32 * n_words, kThreads), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(bits, n, n_words,
                                                        words);
  return cudaGetLastError();
}

int codec_bitunpack(const uint32_t* words, int64_t n, uint8_t* bits,
                    int32_t device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  bitunpack_kernel<<<ceil_div(n, kThreads), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(words, n, bits);
  return cudaGetLastError();
}

}  // extern "C"
