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
//     predictors, ORs the residues in registers and takes the hardware
//     __clz (32 for 0, as ref.clz32_ref's bit-smear and popcount give) —
//     no shared memory, no second pass. It writes its group's residues in
//     the order compress_bits packs them, into one buffer that also holds
//     nlz (codec.encode_block): at width 64 the (G, S, 2) block, son by
//     son, the lo word before the hi word; at widths 32 and 16 the lo
//     words (G, S), then the hi words (G, S). So the payload values need
//     no interleave copy. A block stages its groups' words in shared
//     memory and writes their contiguous run with coalesced 16-byte uint4
//     stores when every group's run is a whole number of them (S even at
//     width 64, S % 4 == 0 else; four uint4s a group at S = 8).
//   * B7: an elementwise XOR over both word arrays, 16 bytes a thread
//     (uint4 loads) when every pointer is 16-byte aligned, else words.
//   * B8: one warp per output word. Lane i reads flag 32w + i of the flat
//     byte array and __ballot_sync gives the word in one instruction; flags
//     past n read as 0, so the ragged last word is exact.
//   * B9: one thread per output flag, (words[i >> 5] >> (i & 31)) & 1.
//
// B6's and B7's whole cost is their call: their device time sits at the
// HBM bound, so each wrapper does the least host work a launch allows (one
// output allocation, no copies of contiguous inputs; cudalib.launch).
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
// largest dynamic shared-memory request that needs no opt-in attribute
constexpr size_t kSmemNoOptIn = 48 * 1024;

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ------------------------------------------------------------- B6 encode

// Son i of group j's residue words: x the lo word, y the hi word.
__device__ __forceinline__ uint2 residue(const uint32_t* __restrict__ pred_hi,
                                         const uint32_t* __restrict__ pred_lo,
                                         const uint32_t* __restrict__ son_hi,
                                         const uint32_t* __restrict__ son_lo,
                                         int64_t g, int32_t i, int64_t j) {
  const int64_t k = (int64_t)i * g + j;
  return make_uint2(son_lo[k] ^ pred_lo[k], son_hi[k] ^ pred_hi[k]);
}

// Staged (kStaged): each thread puts its group's residue words in shared
// memory, one row per group (uint4 stores; rows padded by 4 words, so the
// 8 threads of a quarter-warp hit distinct banks), then the block writes
// its groups' contiguous run of the output, 16 bytes a thread, coalesced:
// a thread's own words lie 2S words apart from its neighbour's, so storing
// them directly touches 32 segments per warp store. Needs every row a
// whole number of uint4s and the output 16-byte aligned; otherwise
// (!kStaged) each thread stores its words directly, a word at a time.
template <bool kStaged>
__global__ void encode_groups_kernel(const uint32_t* __restrict__ pred_hi,
                                     const uint32_t* __restrict__ pred_lo,
                                     const uint32_t* __restrict__ son_hi,
                                     const uint32_t* __restrict__ son_lo,
                                     int32_t s, int64_t g, int32_t width,
                                     int32_t cap, uint32_t* __restrict__ res,
                                     int32_t* __restrict__ nlz) {
  extern __shared__ uint4 staged[];
  const bool pairs = width == 64;
  // words per group in each of the output's planes: (lo, hi) pairs in one
  // plane at width 64; the lo plane, then the hi plane, otherwise
  const int32_t row = pairs ? 2 * s : s;
  const int32_t row4 = row / 4 + 1;                    // padded, in uint4s
  const int64_t g0 = (int64_t)blockIdx.x * blockDim.x;
  const int64_t j = g0 + threadIdx.x;
  uint32_t m_hi = 0, m_lo = 0;
  if (j < g) {
    uint4* lo4 = staged + threadIdx.x * row4;
    uint4* hi4 = staged + (blockDim.x + threadIdx.x) * row4;
    uint32_t* lo = pairs ? res + 2 * (int64_t)s * j : res + (int64_t)s * j;
    uint32_t* hi = lo + (int64_t)s * g;
    for (int32_t i = 0; i < s; i += (kStaged ? (pairs ? 2 : 4) : 1)) {
      if (!kStaged) {
        const uint2 a = residue(pred_hi, pred_lo, son_hi, son_lo, g, i, j);
        if (pairs) {
          lo[2 * i] = a.x;
          lo[2 * i + 1] = a.y;
        } else {
          lo[i] = a.x;
          hi[i] = a.y;
        }
        m_lo |= a.x;
        m_hi |= a.y;
      } else if (pairs) {
        const uint2 a = residue(pred_hi, pred_lo, son_hi, son_lo, g, i, j);
        const uint2 b = residue(pred_hi, pred_lo, son_hi, son_lo, g, i + 1, j);
        lo4[i / 2] = make_uint4(a.x, a.y, b.x, b.y);
        m_lo |= a.x | b.x;
        m_hi |= a.y | b.y;
      } else {
        uint2 r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          r[q] = residue(pred_hi, pred_lo, son_hi, son_lo, g, i + q, j);
          m_lo |= r[q].x;
          m_hi |= r[q].y;
        }
        lo4[i / 4] = make_uint4(r[0].x, r[1].x, r[2].x, r[3].x);
        hi4[i / 4] = make_uint4(r[0].y, r[1].y, r[2].y, r[3].y);
      }
    }
    int32_t z;
    if (pairs) {
      z = m_hi != 0 ? __clz((int)m_hi) : 32 + __clz((int)m_lo);
    } else if (width == 32) {
      z = __clz((int)m_lo);
    } else {  // 16-bit payloads in the low word
      z = __clz((int)m_lo) - 16;
    }
    nlz[j] = min(z, cap);
  }
  if (!kStaged) return;
  __syncthreads();
  const int32_t groups = (int32_t)min((int64_t)blockDim.x, g - g0);
  const int32_t per = row / 4;                         // uint4s of a group
  uint4* out_lo = reinterpret_cast<uint4*>(res + g0 * row);
  uint4* out_hi = reinterpret_cast<uint4*>(res + (int64_t)s * g + g0 * row);
  for (int32_t t = threadIdx.x; t < groups * per; t += blockDim.x) {
    const int32_t grp = t / per, c = t % per;
    out_lo[t] = staged[grp * row4 + c];
    if (!pairs) out_hi[t] = staged[(blockDim.x + grp) * row4 + c];
  }
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

// ``out`` holds 2 * s * g residue words (see encode_groups_kernel), then
// the g nlz.
int codec_encode_groups(const uint32_t* pred_hi, const uint32_t* pred_lo,
                        const uint32_t* son_hi, const uint32_t* son_lo,
                        int32_t s, int64_t g, int32_t width, int32_t cap,
                        uint32_t* out, int32_t device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* nlz = reinterpret_cast<int32_t*>(out + 2 * (int64_t)s * g);
  const int64_t blocks = ceil_div(g, kThreads);
  // the staged rows: one plane of 2S words at width 64, two of S else
  const bool pairs = width == 64;
  const int32_t row = pairs ? 2 * s : s;
  const size_t smem = (pairs ? 1 : 2) * kThreads * (size_t)(row / 4 + 1)
                      * sizeof(uint4);
  if (aligned16(out) && row % 4 == 0 && smem <= kSmemNoOptIn) {
    encode_groups_kernel<true><<<blocks, kThreads, smem, st>>>(
        pred_hi, pred_lo, son_hi, son_lo, s, g, width, cap, out, nlz);
  } else {
    encode_groups_kernel<false><<<blocks, kThreads, 0, st>>>(
        pred_hi, pred_lo, son_hi, son_lo, s, g, width, cap, out, nlz);
  }
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
