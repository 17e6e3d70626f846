// In-transit AMR rasterization kernels for Hopper (sm_90a), float64.
//
// Replaces the Pallas TPU kernels of repro/kernels/raster_kernel.py:
//   B1 slice_raster       (raster_kernel.py:136)  -> slice_key_kernel + slice_resolve_kernel
//   B2 projection_raster  (raster_kernel.py:240)  -> projection_kernel
//   B3 level_hist         (raster_kernel.py:320)  -> level_hist_kernel
//   B4 slice_raster_carry (raster_kernel.py:166)  -> slice_carry_paint_kernel + slice_carry_resolve_kernel
//   B5 projection_raster_carry (raster_kernel.py:267) -> projection_kernel seeded from img0
//
// The TPU kernels keep the whole (R, R) image in VMEM and test every leaf
// against every pixel (O(N * R^2) mask work). Here the work is
// O(sum of leaf-rectangle areas): each leaf touches only its own pixels.
// All three are bound by memory traffic (a few integer ops and at most one
// f64 multiply-add per byte); the designs keep every result bit-identical
// to the host numpy reducers:
//   * slice: order-free. The host painter leaves at each pixel the covering
//     valid leaf with the largest (level, row); pass 1 atomicMax-es the
//     64-bit key ((level + 1) << 32 | row) over each rectangle, pass 2 reads
//     the winner's value. No float arithmetic touches the values.
//   * projection: order matters (f64 adds in BFS leaf order per pixel), so
//     no float atomics. The wrapper groups the valid leaves by (level, cell)
//     with a stable sort (CSR); one thread per pixel walks the levels in
//     ascending order and adds its cell's leaves in row order. Explicit
//     __dmul_rn/__dadd_rn keep nvcc from fusing the multiply into the add.
//   * histogram: integer counts are order-free: a shared-memory (L, B)
//     histogram per block, then integer atomicAdd into global memory.
//   * carries (B4/B5): one leaf-table tile painted over the partial image of
//     the earlier tiles. B4 resolves each pixel's tile winner against the
//     seed depth: the sequential rule ``lvl >= depth`` lets the tile win at
//     equal level (its rows come later in BFS order), so the tile's key wins
//     iff its level >= depth0. B5 starts each pixel's sum at img0 instead of
//     0.0; the tile's CSR keeps the adds in row order after it. Both read
//     the seed once and write the outputs once (24 resp. 16 bytes a pixel).
//   * B4's leaf table is computed inside its paint kernel from the tile's
//     raw columns (coords, the strided slice-axis column, levels, ok): a
//     tile's device work is a few us, so the ~15 torch launches that built
//     the table on the host cost far more than the kernel did. Its key
//     scratch is kept by the wrapper and stays all zero between calls (the
//     resolve clears every key it finds set), so one C call launches just
//     the paint and the resolve: no allocation, no memset.
//
// Plain C interface (loaded with ctypes); every entry takes the tensors'
// device index (see device_guard.cuh), launches on the given stream, never
// synchronizes, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kSliceWarpsPerBlock = 8;
constexpr int kThreads = 256;
// largest dynamic shared-memory request that needs no opt-in attribute
constexpr size_t kSmemNoOptIn = 48 * 1024;

// ---------------------------------------------------------------- B1 slice

// One warp per leaf; its lanes stride over the leaf's px * px rectangle.
__global__ void slice_key_kernel(const int32_t* __restrict__ u0,
                                 const int32_t* __restrict__ v0,
                                 const int32_t* __restrict__ px,
                                 const int32_t* __restrict__ lvl,
                                 const uint8_t* __restrict__ good,
                                 int64_t n, int32_t res,
                                 unsigned long long* __restrict__ keys) {
  const int64_t leaf = (int64_t)blockIdx.x * kSliceWarpsPerBlock
                       + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (leaf >= n || !good[leaf]) return;
  const int64_t u = u0[leaf], v = v0[leaf], p = px[leaf];
  const unsigned long long key =
      ((unsigned long long)(lvl[leaf] + 1) << 32) | (unsigned long long)leaf;
  const int64_t area = p * p;
  for (int64_t t = lane; t < area; t += kWarp) {
    const int64_t i = u + t / p, j = v + t % p;
    if (i < res && j < res) atomicMax(&keys[i * res + j], key);
  }
}

__global__ void slice_resolve_kernel(const unsigned long long* __restrict__ keys,
                                     const double* __restrict__ val,
                                     int64_t npix, double* __restrict__ img) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const unsigned long long key = keys[p];
  img[p] = key == 0ull ? __longlong_as_double(0x7ff8000000000000ll)
                       : val[key & 0xffffffffull];
}

// B4 pass 1: B1's paint with the leaf table made per leaf from the raw
// columns, exactly as raster.py's _slice_table makes it: leaf_table's
// integer geometry, the level range 0 <= lvl < n_levels, and plane_hit's
// float64 test lo <= position < lo + size with size = 2^-lvl and
// lo = c * size (exact dyadic rationals; __dmul_rn/__dadd_rn keep nvcc
// from contracting the add). ``c_axis`` is read with its element stride.
__global__ void slice_carry_paint_kernel(const int32_t* __restrict__ coords2,
                                         const int32_t* __restrict__ c_axis,
                                         int64_t c_stride,
                                         const int32_t* __restrict__ lvl,
                                         const uint8_t* __restrict__ ok,
                                         int64_t n, int32_t res,
                                         int32_t n_levels, double position,
                                         unsigned long long* __restrict__ keys) {
  const int64_t leaf = (int64_t)blockIdx.x * kSliceWarpsPerBlock
                       + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (leaf >= n || !ok[leaf]) return;
  const int32_t l = lvl[leaf];
  if (l < 0 || l >= n_levels) return;
  const double size = ldexp(1.0, -l);
  const double lo = __dmul_rn((double)c_axis[leaf * c_stride], size);
  if (!(lo <= position && position < __dadd_rn(lo, size))) return;
  const int32_t k = 31 - __clz(res);
  const int32_t up = max(k - l, 0), dn = max(l - k, 0);
  // int32 shifts as torch's: left as unsigned (no overflow), right arithmetic
  const int64_t u = (int32_t)((uint32_t)coords2[2 * leaf] << up) >> dn;
  const int64_t v = (int32_t)((uint32_t)coords2[2 * leaf + 1] << up) >> dn;
  const int64_t p = max(res >> min(l, 30), 1);
  const unsigned long long key =
      ((unsigned long long)(l + 1) << 32) | (unsigned long long)leaf;
  const int64_t area = p * p;
  for (int64_t t = lane; t < area; t += kWarp) {
    const int64_t i = u + t / p, j = v + t % p;
    if (i < res && j < res) atomicMax(&keys[i * res + j], key);
  }
}

// B4 pass 2: the tile's winner against the carried (img0, depth0) seed;
// clears the key, so the scratch is all zero again for the next call.
__global__ void slice_carry_resolve_kernel(
    unsigned long long* __restrict__ keys,
    const double* __restrict__ val, const double* __restrict__ img0,
    const int32_t* __restrict__ depth0, int64_t npix,
    double* __restrict__ img, int32_t* __restrict__ depth) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  const unsigned long long key = keys[p];
  if (key != 0ull) keys[p] = 0ull;
  const int32_t d0 = depth0[p];
  const int32_t lvl = (int32_t)(key >> 32) - 1;
  if (key != 0ull && lvl >= d0) {
    img[p] = val[key & 0xffffffffull];
    depth[p] = lvl;
  } else {
    img[p] = img0[p];
    depth[p] = d0;
  }
}

// ------------------------------------------------------ B2/B5 projection

// One thread per pixel; the sum starts at ``img0[p]`` (B5) or 0.0 (B2,
// ``img0`` null). ``offsets`` is the CSR over buckets base[l] + cell,
// cell = (i >> sh) * g + (j >> sh), sh = k - min(l, k), g = res >> sh;
// ``order`` lists the rows of each bucket in row order.
__global__ void projection_kernel(const double* __restrict__ val,
                                  const int32_t* __restrict__ order,
                                  const int64_t* __restrict__ offsets,
                                  const double* __restrict__ img0,
                                  int32_t res, int32_t k, int32_t n_levels,
                                  double* __restrict__ img) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t npix = (int64_t)res * res;
  if (p >= npix) return;
  const int64_t i = p / res, j = p % res;
  double acc = img0 ? img0[p] : 0.0;
  int64_t base = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int sh = k - (l < k ? l : k);
    const int64_t g = (int64_t)res >> sh;
    const int64_t cell = base + (i >> sh) * g + (j >> sh);
    const double scale = ldexp(1.0, -l);      // exact path length 2^-l
    const int64_t end = offsets[cell + 1];
    for (int64_t e = offsets[cell]; e < end; ++e)
      acc = __dadd_rn(acc, __dmul_rn(val[order[e]], scale));
    base += g * g;
  }
  img[p] = acc;
}

// ------------------------------------------------------------ B3 histogram

// Grid-stride over rows; np.histogram bins: right-open, top edge inclusive,
// out-of-range / NaN / invalid / bad-level rows dropped.
__global__ void level_hist_kernel(const double* __restrict__ val,
                                  const int32_t* __restrict__ lvl,
                                  const uint8_t* __restrict__ ok,
                                  const double* __restrict__ edges,
                                  int64_t n, int32_t n_levels, int32_t bins,
                                  int32_t use_smem, int32_t* __restrict__ hist) {
  extern __shared__ double s_edges[];    // (bins + 1) edges, then (L, B)
  int32_t* s_hist = reinterpret_cast<int32_t*>(s_edges + bins + 1);
  const int cells = n_levels * bins;
  const double* e = edges;
  int32_t* h = hist;
  if (use_smem) {
    for (int t = threadIdx.x; t <= bins; t += blockDim.x) s_edges[t] = edges[t];
    for (int t = threadIdx.x; t < cells; t += blockDim.x) s_hist[t] = 0;
    __syncthreads();
    e = s_edges;
    h = s_hist;
  }
  const double lo = e[0], hi = e[bins];
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += (int64_t)gridDim.x * blockDim.x) {
    const double v = val[r];
    const int l = lvl[r];
    if (!ok[r] || !(v >= lo) || !(v <= hi) || l < 0 || l >= n_levels) continue;
    int b;
    if (v == hi) {
      b = bins - 1;
    } else {          // (count of edges <= v) - 1, by binary search
      int a = 0, z = bins + 1;
      while (a < z) {
        const int m = (a + z) >> 1;
        if (e[m] <= v) a = m + 1; else z = m;
      }
      b = a - 1;
    }
    atomicAdd(&h[l * bins + b], 1);
  }
  if (use_smem) {
    __syncthreads();
    for (int t = threadIdx.x; t < cells; t += blockDim.x)
      if (s_hist[t]) atomicAdd(&hist[t], s_hist[t]);
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Pass 1 of B1: zero the (R, R) keys, then atomicMax each valid leaf's key
// over its rectangle.
cudaError_t paint_keys(const int32_t* u0, const int32_t* v0,
                       const int32_t* px, const int32_t* lvl,
                       const uint8_t* good, int64_t n, int32_t res,
                       unsigned long long* keys, cudaStream_t s) {
  const int64_t npix = (int64_t)res * res;
  cudaError_t err = cudaMemsetAsync(keys, 0, npix * sizeof(unsigned long long), s);
  if (err != cudaSuccess || n == 0) return err;
  slice_key_kernel<<<ceil_div(n, kSliceWarpsPerBlock),
                     kSliceWarpsPerBlock * kWarp, 0, s>>>(
      u0, v0, px, lvl, good, n, res, keys);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int raster_slice_f64(const int32_t* u0, const int32_t* v0, const int32_t* px,
                     const int32_t* lvl, const uint8_t* good, const double* val,
                     int64_t n, int32_t res, void* keys_scratch, double* img,
                     int32_t device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t npix = (int64_t)res * res;
  auto* keys = static_cast<unsigned long long*>(keys_scratch);
  const cudaError_t err = paint_keys(u0, v0, px, lvl, good, n, res, keys, s);
  if (err != cudaSuccess) return err;
  slice_resolve_kernel<<<ceil_div(npix, kThreads), kThreads, 0, s>>>(
      keys, val, npix, img);
  return cudaGetLastError();
}

int raster_slice_carry_f64(const int32_t* coords2, const int32_t* c_axis,
                           int64_t c_stride, const int32_t* lvl,
                           const uint8_t* ok, const double* val, int64_t n,
                           int32_t res, int32_t n_levels, double position,
                           void* keys_scratch, const double* img0,
                           const int32_t* depth0, double* img, int32_t* depth,
                           int32_t device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t npix = (int64_t)res * res;
  // all zero on entry (see slice_carry_resolve_kernel)
  auto* keys = static_cast<unsigned long long*>(keys_scratch);
  if (n > 0) {
    slice_carry_paint_kernel<<<ceil_div(n, kSliceWarpsPerBlock),
                               kSliceWarpsPerBlock * kWarp, 0, s>>>(
        coords2, c_axis, c_stride, lvl, ok, n, res, n_levels, position, keys);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  slice_carry_resolve_kernel<<<ceil_div(npix, kThreads), kThreads, 0, s>>>(
      keys, val, img0, depth0, npix, img, depth);
  return cudaGetLastError();
}

int raster_projection_f64(const double* val, const int32_t* order,
                          const int64_t* offsets, int32_t res, int32_t k,
                          int32_t n_levels, double* img, int32_t device,
                          void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t npix = (int64_t)res * res;
  projection_kernel<<<ceil_div(npix, kThreads), kThreads, 0, s>>>(
      val, order, offsets, nullptr, res, k, n_levels, img);
  return cudaGetLastError();
}

int raster_projection_carry_f64(const double* val, const int32_t* order,
                                const int64_t* offsets, const double* img0,
                                int32_t res, int32_t k, int32_t n_levels,
                                double* img, int32_t device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t npix = (int64_t)res * res;
  projection_kernel<<<ceil_div(npix, kThreads), kThreads, 0, s>>>(
      val, order, offsets, img0, res, k, n_levels, img);
  return cudaGetLastError();
}

int raster_level_hist_f64(const double* val, const int32_t* lvl,
                          const uint8_t* ok, const double* edges, int64_t n,
                          int32_t n_levels, int32_t bins, int32_t* hist,
                          int32_t device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      hist, 0, (size_t)n_levels * bins * sizeof(int32_t), s);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaGetLastError();
  const size_t smem = (size_t)(bins + 1) * sizeof(double)
                      + (size_t)n_levels * bins * sizeof(int32_t);
  const int use_smem = smem <= kSmemNoOptIn;
  int64_t blocks = ceil_div(n, kThreads);
  if (blocks > 1056) blocks = 1056;           // 8 blocks per SM on 132 SMs
  level_hist_kernel<<<blocks, kThreads, use_smem ? smem : 0, s>>>(
      val, lvl, ok, edges, n, n_levels, bins, use_smem, hist);
  return cudaGetLastError();
}

}  // extern "C"
