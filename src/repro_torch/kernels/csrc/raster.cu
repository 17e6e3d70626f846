// In-transit AMR rasterization kernels for Hopper (sm_90a), float64.
//
// Replaces the Pallas TPU kernels of repro/kernels/raster_kernel.py:
//   B1 slice_raster       (raster_kernel.py:136)  -> slice_key_kernel + slice_resolve_kernel
//   B2 projection_raster  (raster_kernel.py:240)  -> projection_kernel
//   B3 level_hist         (raster_kernel.py:320)  -> level_hist_kernel
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
//
// Plain C interface (loaded with ctypes); every entry launches on the given
// stream, never synchronizes, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

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

// ----------------------------------------------------------- B2 projection

// One thread per pixel. ``offsets`` is the CSR over buckets
// base[l] + cell, cell = (i >> sh) * g + (j >> sh), sh = k - min(l, k),
// g = res >> sh; ``order`` lists the rows of each bucket in row order.
__global__ void projection_kernel(const double* __restrict__ val,
                                  const int32_t* __restrict__ order,
                                  const int64_t* __restrict__ offsets,
                                  int32_t res, int32_t k, int32_t n_levels,
                                  double* __restrict__ img) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t npix = (int64_t)res * res;
  if (p >= npix) return;
  const int64_t i = p / res, j = p % res;
  double acc = 0.0;
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

}  // namespace

extern "C" {

int raster_slice_f64(const int32_t* u0, const int32_t* v0, const int32_t* px,
                     const int32_t* lvl, const uint8_t* good, const double* val,
                     int64_t n, int32_t res, void* keys_scratch, double* img,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t npix = (int64_t)res * res;
  auto* keys = static_cast<unsigned long long*>(keys_scratch);
  cudaError_t err = cudaMemsetAsync(keys, 0, npix * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return err;
  if (n > 0) {
    slice_key_kernel<<<ceil_div(n, kSliceWarpsPerBlock),
                       kSliceWarpsPerBlock * kWarp, 0, s>>>(
        u0, v0, px, lvl, good, n, res, keys);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  slice_resolve_kernel<<<ceil_div(npix, kThreads), kThreads, 0, s>>>(
      keys, val, npix, img);
  return cudaGetLastError();
}

int raster_projection_f64(const double* val, const int32_t* order,
                          const int64_t* offsets, int32_t res, int32_t k,
                          int32_t n_levels, double* img, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t npix = (int64_t)res * res;
  projection_kernel<<<ceil_div(npix, kThreads), kThreads, 0, s>>>(
      val, order, offsets, res, k, n_levels, img);
  return cudaGetLastError();
}

int raster_level_hist_f64(const double* val, const int32_t* lvl,
                          const uint8_t* ok, const double* edges, int64_t n,
                          int32_t n_levels, int32_t bins, int32_t* hist,
                          void* stream) {
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
