// In-transit AMR rasterization kernels for Hopper (sm_90a), float64, and
// float32 instantiations of B3-B5 for the mesh path's float32 tables.
//
// Replaces the Pallas TPU kernels of repro/kernels/raster_kernel.py:
//   B1 slice_raster       (raster_kernel.py:136)  -> slice_paint_kernel<double> + slice_resolve_kernel
//   B2 projection_raster  (raster_kernel.py:240)  -> proj_key_kernel, proj_scan_kernel,
//                                                    proj_place_kernel, proj_order_kernel,
//                                                    projection_kernel
//   B3 level_hist         (raster_kernel.py:320)  -> level_hist_kernel
//   B4 slice_raster_carry (raster_kernel.py:166)  -> slice_paint_kernel<T> + slice_carry_resolve_kernel
//   B5 projection_raster_carry (raster_kernel.py:267) -> B2's five, seeded from img0
//
// B3, B4 and B5 are templates over the value type T (double, float): the
// Pallas kernels take their value dtype from their input, and the JAX
// package's MeshDAGRunner(dtype="float32") runs them at float32. Only the
// reads of the values, the arithmetic on them and the image type change;
// the int32 geometry, the slice key scratch and B2/B5's (level, cell) CSR
// are shared by both types. In float32 every step rounds as the reference's
// float32 XLA ops do (Arith<float>): B4's plane test c * 2^-l and
// lo + 2^-l, B5's value * 2^-l and each add, all round-to-nearest-even
// with no FMA contraction and subnormals kept (no -ftz); B3 widens the
// value to double (exact) and bins it against the float64 edges, as the
// reference's float64 edge compare promotes it.
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
//     the winner's value. No float arithmetic touches the values. Pass 1 is
//     one thread per row: a warp reads 32 consecutive rows' columns
//     coalesced, and most rows leave after the plane test (only the leaves
//     the plane hits paint). A hit rectangle of at most kSliceOwnArea
//     pixels (px <= 4, every leaf of level >= k - 2) is painted by its own
//     thread. A larger one (a coarse leaf: level l < k - 2) is not painted
//     pixel by pixel: its thread atomicMax-es the key into the leaf's cell
//     of a per-level grid (4^l cells at level l, 5,461 in all at R = 512),
//     and pass 2 takes each pixel's key as the max of its own and of its
//     coarse ancestors' cells, on the levels the paint marked as keyed (a
//     tile with no coarse leaf reads no cell). Painting coarse leaves per pixel put the
//     work where the rows are: on the Orion table 49 level-3 leaves cover
//     77 % of the image and sit in a few warps, which painted up to 49,152
//     pixels each, one leaf after another. B1 and B4 share this paint and
//     the key resolve; the last block of pass 2 clears the cell grid.
//   * projection: order matters (f64 adds in BFS leaf order per pixel), so
//     no float atomics. The valid leaves are grouped by (level, cell) in a
//     CSR; one thread per pixel walks the levels in ascending order and
//     adds its cell's leaves in row order. Explicit __dmul_rn/__dadd_rn
//     keep nvcc from fusing the multiply into the add.
//   * histogram: integer counts are order-free, so integer atomics. One
//     launch and no memset: one wave of blocks counts in shared memory and
//     adds its cells into the output, which the previous call on the
//     stream left zeroed; the launch zeroes the next call's output. The bin
//     is a guess from the uniform spacing corrected against the edges (no
//     binary search); up to 257 edges cross by value as a kernel
//     parameter, so the caller uploads nothing.
//   * carries (B4/B5): a leaf table painted over a partial image. The mesh
//     path makes one call per shard; the twins chain the same shard in BFS
//     tiles, and the one call gives the chain's bits. B4 resolves each
//     pixel's winner against the seed depth: the chain's rule ``lvl >=
//     depth`` lets a later tile win at equal level, so the winner is the
//     largest (level, row), which the global row in the key gives. B5 starts
//     each pixel's sum at img0 instead of 0.0; the chain adds in (tile,
//     level, row) order, the CSR walk in (level, row) order, and the two
//     agree on every level-sorted table (see projection_kernel, which keeps
//     the chain's order on any other). Both read the seed once and write
//     the outputs once (24 resp. 16 bytes a pixel).
//   * B1/B4's leaf table and B2/B5's CSR are built on the card from the
//     raw columns (coords, levels, ok; B1/B4 also the strided slice-axis
//     column): a call's device work is a few us, so the ~10-15 torch ops
//     that built them on the host (for B2/B5 a radix sort and a
//     searchsorted over every pyramid cell) cost far more than the kernels
//     did. One C call launches every step on the stream; the scratch is
//     kept by the wrapper and left all zero where the next call needs zeros
//     (B1/B4's resolve clears every key it finds set; B2/B5's scan zeroes
//     the cell counts it has read), so no call allocates scratch or
//     memsets.
//   * B2/B5's CSR in five launches: key/count (one thread per row, the
//     cell base[l] + (c0 >> dn) * g + (c1 >> dn) with base[l] in closed
//     form, an integer atomic whose old value is the row's arrival index
//     in its cell, warp-aggregated counts per 4096-cell chunk); an
//     exclusive scan of the cell counts (each block adds the chunk counts
//     before it, then scans its chunk); place (offset plus arrival index,
//     no atomics); order (each row's rank in its cell = the rows of the
//     cell below it, so the segment is in row order, exactly the stable
//     sort's permutation; ranked segment-major in shared memory, with the
//     row's value * 2^-l written beside it, see proj_order_kernel); the
//     projection, which reads those contributions contiguously.
//
// Plain C interface (loaded with ctypes); every entry takes the tensors'
// device index (see device_guard.cuh), launches on the given stream, never
// synchronizes, and returns cudaGetLastError().

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

// The value type's IEEE arithmetic, each op rounded to nearest even on its
// own: the _rn intrinsics keep nvcc from contracting a multiply into an add.
template <typename T> struct Arith;

template <> struct Arith<double> {
  static __device__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ double pow2(int e) { return ldexp(1.0, e); }       // exact
  static __device__ double of_int(int32_t c) { return (double)c; }     // exact
  static __device__ double nan() {
    return __longlong_as_double(0x7ff8000000000000ll);
  }
};

template <> struct Arith<float> {
  static __device__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ float pow2(int e) { return ldexpf(1.0f, e); }      // exact
  // |c| > 2^24 rounds, to nearest even, as the reference's int32 -> float32
  static __device__ float of_int(int32_t c) { return __int2float_rn(c); }
};

constexpr int kWarp = 32;
constexpr int kThreads = 256;
// largest dynamic shared-memory request that needs no opt-in attribute
constexpr size_t kSmemNoOptIn = 48 * 1024;
// slice rectangles of at most this many pixels are painted by their row's
// own thread, larger ones keyed into their level's cell grid (raster.py's
// SLICE_OWN_AREA)
constexpr int kSliceOwnArea = 16;

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// ------------------------------------------------------------- B1/B4 slice

// The slice key scratch (raster.py's _slice_keys): the (R, R) pixel keys,
// then the coarse cell grids of levels 0 .. coarse_levels(res) - 1 (level l
// at offset (4^l - 1) / 3 of the grids, row-major), then one 64-bit slot
// holding the counter of the resolve's finished blocks and the mask of
// the coarse levels the paint keyed a cell of. All zero between calls.
struct SliceScratch {
  unsigned long long* pixel;
  unsigned long long* coarse;
  unsigned int* done;
  unsigned int* hit_levels;
  int32_t levels;    // coarse levels: (res >> l)^2 > kSliceOwnArea
  int64_t cells;     // their cells, (4^levels - 1) / 3
};

// First cell of coarse level l's grid: (4^l - 1) / 3.
__host__ __device__ int64_t coarse_base(int32_t l) {
  return ((1ll << (2 * l)) - 1) / 3;
}

// Levels whose px * px rectangle exceeds kSliceOwnArea at resolution res.
int32_t coarse_levels(int32_t res) {
  int32_t l = 0;
  while ((int64_t)(res >> l) * (res >> l) > kSliceOwnArea) ++l;
  return l;
}

SliceScratch slice_scratch(void* keys_scratch, int32_t res) {
  SliceScratch sc;
  sc.pixel = static_cast<unsigned long long*>(keys_scratch);
  sc.coarse = sc.pixel + (int64_t)res * res;
  sc.levels = coarse_levels(res);
  sc.cells = coarse_base(sc.levels);
  sc.done = reinterpret_cast<unsigned int*>(sc.coarse + sc.cells);
  sc.hit_levels = sc.done + 1;
  return sc;
}

// Pass 1 of B1 and B4, one thread per row: the leaf table made per row from
// the raw columns, exactly as raster.py's _slice_table makes it: leaf_table's
// integer geometry, the level range 0 <= lvl < n_levels, and the reference's
// plane test lo <= position < lo + size in the value type T
// (ref.slice_raster_depth_ref): size = 2^-lvl and lo = T(c) * size, then
// lo + size rounded to T; ``position`` comes already rounded to T. In
// float64 both bounds are exact dyadic rationals; in float32 a c above 2^24
// and lo + size may round. ``c_axis`` is read with its element stride. A
// coarse leaf's rectangle is its own cell (c0, c1) of the level grid, inside
// the image iff 0 <= c0, c1 < 2^l; the pixel paint keeps only pixels inside
// (a leaf outside the domain paints nothing). Returns the bit of the coarse
// level whose cell it keyed, else 0.
template <typename T>
__device__ __forceinline__ unsigned paint_row(
    const int32_t* __restrict__ coords2, const int32_t* __restrict__ c_axis,
    int64_t c_stride, const int32_t* __restrict__ lvl, int64_t row,
    int32_t res, int32_t n_levels, T position, const SliceScratch& sc) {
  const int32_t l = lvl[row];
  if (l < 0 || l >= n_levels) return 0u;
  const T size = Arith<T>::pow2(-l);
  const T lo = Arith<T>::mul(Arith<T>::of_int(c_axis[row * c_stride]), size);
  if (!(lo <= position && position < Arith<T>::add(lo, size))) return 0u;
  const unsigned long long key =
      ((unsigned long long)(l + 1) << 32) | (unsigned long long)row;
  const int32_t c0 = coords2[2 * row], c1 = coords2[2 * row + 1];
  if (l < sc.levels) {
    const int32_t side = 1 << l;
    if (c0 < 0 || c0 >= side || c1 < 0 || c1 >= side) return 0u;
    atomicMax(&sc.coarse[coarse_base(l) + (int64_t)c0 * side + c1], key);
    return 1u << l;
  }
  const int32_t k = 31 - __clz(res);
  const int32_t up = max(k - l, 0), dn = max(l - k, 0);
  // int32 shifts as torch's: left as unsigned (no overflow), right arithmetic
  const int64_t u = (int32_t)((uint32_t)c0 << up) >> dn;
  const int64_t v = (int32_t)((uint32_t)c1 << up) >> dn;
  const int32_t p = max(res >> min(l, 30), 1);      // at most 4 here
  if (u < 0 || v < 0) return 0u;                     // outside the image
  for (int32_t di = 0; di < p; ++di)
    for (int32_t dj = 0; dj < p; ++dj)
      if (u + di < res && v + dj < res)
        atomicMax(&sc.pixel[(u + di) * res + v + dj], key);
  return 0u;
}

// Every lane reaches the warp's OR of the coarse levels its rows keyed (rows
// past n and misses bring 0); one lane sets them in the scratch's mask.
template <typename T>
__global__ void slice_paint_kernel(const int32_t* __restrict__ coords2,
                                   const int32_t* __restrict__ c_axis,
                                   int64_t c_stride,
                                   const int32_t* __restrict__ lvl,
                                   const uint8_t* __restrict__ ok,
                                   int64_t n, int32_t res, int32_t n_levels,
                                   T position, SliceScratch sc) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned keyed = row < n && ok[row]
      ? paint_row<T>(coords2, c_axis, c_stride, lvl, row, res, n_levels,
                     position, sc)
      : 0u;
  const unsigned levels = __reduce_or_sync(0xffffffffu, keyed);
  if (levels != 0u && threadIdx.x % kWarp == 0) atomicOr(sc.hit_levels, levels);
}

// Pass 2's key of pixel p = (i, j): the max of its own key, which it
// clears, and of its coarse ancestors' cells on the levels of ``hit``
// (level l's cell (i >> (k - l), j >> (k - l)); 32-bit index arithmetic:
// the coarse grids hold (4^levels - 1) / 3 < 2^31 cells for R < 2^16).
__device__ __forceinline__ unsigned long long resolve_key(
    const SliceScratch& sc, unsigned hit, int64_t p, int32_t res) {
  unsigned long long key = sc.pixel[p];
  if (key != 0ull) sc.pixel[p] = 0ull;
  const int32_t k = 31 - __clz(res);                  // res = 2^k
  const uint32_t i = (uint32_t)(p >> k), j = (uint32_t)p & (res - 1);
  for (unsigned m = hit; m; m &= m - 1) {
    const int32_t l = __ffs(m) - 1;
    const uint32_t cell = ((1u << (2 * l)) - 1u) / 3u
                          + ((i >> (k - l)) << l) + (j >> (k - l));
    const unsigned long long c = sc.coarse[cell];
    key = c > key ? c : key;
  }
  return key;
}

// Pass 2's blocks: 1,024 threads, one pixel each (coalesced), so a quarter
// as many blocks meet at clear_coarse's counter as at kThreads.
constexpr int kResolveThreads = 1024;

int64_t resolve_blocks(int32_t res) {
  return ceil_div((int64_t)res * res, kResolveThreads);
}

// The end of pass 2, reached by every thread of every block. With no coarse
// level hit there is nothing to clear; else the last block to finish (every
// other block has read its cells) clears the hit levels' cells, the mask
// and the counter, so the scratch is all zero for the next call.
__device__ __forceinline__ void clear_coarse(const SliceScratch& sc,
                                             unsigned hit) {
  if (hit == 0u) return;
  __shared__ bool last;
  __syncthreads();        // the block's cell reads have all returned
  if (threadIdx.x == 0) last = atomicAdd(sc.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  for (unsigned m = hit; m; m &= m - 1) {
    const int32_t l = __ffs(m) - 1;
    for (int64_t c = threadIdx.x; c < (1ll << (2 * l)); c += blockDim.x)
      sc.coarse[coarse_base(l) + c] = 0ull;
  }
  if (threadIdx.x == 0) {
    *sc.hit_levels = 0u;
    *sc.done = 0u;
  }
}

// Pass 2 of B1: the winner's value, NaN where no leaf painted.
__global__ void slice_resolve_kernel(SliceScratch sc,
                                     const double* __restrict__ val,
                                     int32_t res, double* __restrict__ img) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned hit = *sc.hit_levels;
  if (p < (int64_t)res * res) {
    const unsigned long long key = resolve_key(sc, hit, p, res);
    img[p] = key == 0ull ? Arith<double>::nan() : val[key & 0xffffffffull];
  }
  clear_coarse(sc, hit);
}

// B4 pass 2: the tile's winner against the carried (img0, depth0) seed.
template <typename T>
__global__ void slice_carry_resolve_kernel(
    SliceScratch sc, const T* __restrict__ val, const T* __restrict__ img0,
    const int32_t* __restrict__ depth0, int32_t res, T* __restrict__ img,
    int32_t* __restrict__ depth) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned hit = *sc.hit_levels;
  if (p < (int64_t)res * res) {
    const unsigned long long key = resolve_key(sc, hit, p, res);
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
  clear_coarse(sc, hit);
}

// ------------------------------------------------------ B2/B5 projection

// cells of the (level, cell) CSR one scan block owns; the wrapper pads the
// count scratch to a multiple of it (raster.py's SCAN_CHUNK)
constexpr int kScanChunk = 4096;
constexpr int kScanItems = kScanChunk / kThreads;

// First cell of level l's grid in the pyramid: sum over j < l of
// 4^min(j, k) (ref.level_bases), in closed form.
__host__ __device__ int64_t level_base(int l, int k) {
  if (l <= k + 1) return ((1ll << (2 * l)) - 1) / 3;
  return ((1ll << (2 * (k + 1))) - 1) / 3 + (int64_t)(l - k - 1) * (1ll << (2 * k));
}

// Cells of the count / offsets scratch for a pyramid of ``total`` cells:
// every cell plus the end cell, rounded up to whole scan chunks.
int64_t scan_cells(int64_t total) { return (total / kScanChunk + 1) * kScanChunk; }

// Step 1, one thread per row: the row's pyramid cell (ref.level_cells), or
// -1 for a row that is not ok, of a level outside [0, n_levels) or of a
// cell outside the pyramid; the cell's count, counted once per warp and
// cell, gives each row its arrival index in the cell (``sub``); and the
// rows per kScanChunk-cell chunk counted once per warp and chunk.
__global__ void proj_key_kernel(const int32_t* __restrict__ coords2,
                                const int32_t* __restrict__ lvl,
                                const uint8_t* __restrict__ ok, int64_t n,
                                int32_t k, int32_t n_levels, int64_t total,
                                int32_t* __restrict__ key,
                                int32_t* __restrict__ sub,
                                int32_t* __restrict__ count,
                                int32_t* __restrict__ chunk_count) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int32_t cell = -1;
  if (row < n) {
    // the row's loads issued together, not one behind the other's test
    const bool good = ok[row];
    const int32_t l = lvl[row];
    const int32_t c0 = coords2[2 * row], c1 = coords2[2 * row + 1];
    if (good && l >= 0 && l < n_levels) {
      const int dn = max(l - k, 0);
      const int64_t g = 1ll << min(l, k);
      const int64_t c = level_base(l, k) + (int64_t)(c0 >> dn) * g
                        + (c1 >> dn);
      if (c >= 0 && c < total) cell = (int32_t)c;
    }
  }
  if (row < n) key[row] = cell;
  // the warp's rows of one cell take one atomic: the first adds their
  // number, and each gets the old count plus its rank among them
  const unsigned same = __match_any_sync(0xffffffffu, cell);
  const int lane = threadIdx.x % kWarp, head = __ffs(same) - 1;
  int32_t at = 0;
  if (cell >= 0 && lane == head) at = atomicAdd(&count[cell], __popc(same));
  at = __shfl_sync(0xffffffffu, at, head);
  if (cell >= 0) sub[row] = at + __popc(same & ((1u << lane) - 1u));
  const int chunk = cell >= 0 ? cell / kScanChunk : -1;
  const unsigned peers = __match_any_sync(0xffffffffu, chunk);
  if (chunk >= 0 && threadIdx.x % kWarp == __ffs(peers) - 1)
    atomicAdd(&chunk_count[chunk], __popc(peers));
}

// Exclusive prefix of ``x`` over the block (kThreads threads); ``*sum``
// gets the block's total. ``s_warp`` holds kThreads / kWarp ints.
__device__ int32_t block_exclusive_scan(int32_t x, int32_t* s_warp,
                                        int32_t* sum) {
  constexpr int kWarps = kThreads / kWarp;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  int32_t inc = x;
  for (int d = 1; d < kWarp; d <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == kWarp - 1) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < kWarps ? s_warp[lane] : 0;
    for (int d = 1; d < kWarps; d <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  const int32_t before = warp ? s_warp[warp - 1] : 0;
  *sum = s_warp[kWarps - 1];
  __syncthreads();                 // s_warp free for the next scan
  return before + inc - x;
}

// Step 2, one block per chunk: offsets[c] = the rows of every cell < c.
// The block first adds the chunk counts of the chunks before its own,
// then scans its chunk's kScanItems cells a thread, and zeroes the counts
// it read (no later step reads them), so the count scratch is all zero for
// the next call. The scratch is padded with zero cells past the pyramid,
// so offsets[total] is the valid rows.
__global__ void proj_scan_kernel(int32_t* __restrict__ count,
                                 const int32_t* __restrict__ chunk_count,
                                 int64_t* __restrict__ offsets) {
  __shared__ int32_t s_warp[kThreads / kWarp];
  const int32_t chunk = blockIdx.x;
  int32_t before = 0;
  for (int32_t c = threadIdx.x; c < chunk; c += kThreads)
    before += chunk_count[c];
  int32_t base;
  block_exclusive_scan(before, s_warp, &base);
  const int64_t first = (int64_t)chunk * kScanChunk
                        + (int64_t)threadIdx.x * kScanItems;
  int32_t v[kScanItems];
  int32_t mine = 0;
  int4* c4 = reinterpret_cast<int4*>(count + first);
#pragma unroll
  for (int i = 0; i < kScanItems / 4; ++i) {
    const int4 q = c4[i];
    v[4 * i] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z; v[4 * i + 3] = q.w;
    mine += q.x + q.y + q.z + q.w;
    if (q.x | q.y | q.z | q.w) c4[i] = make_int4(0, 0, 0, 0);
  }
  int32_t block_sum;
  int64_t run = base + block_exclusive_scan(mine, s_warp, &block_sum);
  longlong2* o2 = reinterpret_cast<longlong2*>(offsets + first);
#pragma unroll
  for (int i = 0; i < kScanItems / 2; ++i) {
    longlong2 q;
    q.x = run; run += v[2 * i];
    q.y = run; run += v[2 * i + 1];
    o2[i] = q;
  }
}

// Step 3, one thread per row: its slot in its cell's segment is the
// cell's offset plus the row's arrival index from step 1; block 0 zeroes
// the chunk counts, which the scan has read.
__global__ void proj_place_kernel(const int32_t* __restrict__ key,
                                  const int32_t* __restrict__ sub, int64_t n,
                                  const int64_t* __restrict__ offsets,
                                  int32_t* __restrict__ chunk_count,
                                  int32_t n_chunks,
                                  int32_t* __restrict__ slot_row) {
  if (blockIdx.x == 0)
    for (int32_t c = threadIdx.x; c < n_chunks; c += blockDim.x)
      chunk_count[c] = 0;
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int32_t cell = key[row], at = sub[row];
  if (cell < 0) return;
  slot_row[offsets[cell] + at] = (int32_t)row;
}

// Step 4, segment-major. Block b ranks the placed entries [b * kThreads,
// (b + 1) * kThreads) of ``slot_row``, one a thread (a warp holds 32
// consecutive entries, mostly of one segment, since ``slot_row`` is
// grouped by cell). An entry's rank in its segment is the number of the
// segment's rows below its row (rows are unique), so the entry goes to
// ``lo + rank``: each segment in row order, exactly the stable sort's
// permutation, whatever order the rows arrived in. The block's window is
// its entries widened to whole segments (from the start of the first
// entry's segment to the end of the last one's); it is staged in shared
// memory kOrderStage entries at a time with coalesced loads, and each
// thread counts its entry's rank against the staged part of its own
// segment. The compares stay O(sum of seg^2) but read shared memory;
// global memory is read once per window entry, plus a key and two offsets
// per entry. A segment longer than a stage takes several stages of the
// same loop, so any segment length is ranked exactly. Besides the row, the
// entry's contribution value * 2^-l is written in the same order, rounded
// to T as the reference's ``contrib`` (one multiply per row, not per
// pixel), for the projection to read contiguously. (Four entries a thread
// measured 1.5 us slower on the Orion shard, PERF.md.)
constexpr int kOrderStage = 4096;

template <typename T>
__global__ void __launch_bounds__(kThreads)
proj_order_kernel(const int32_t* __restrict__ key,
                  const int64_t* __restrict__ offsets, int64_t total,
                  const int32_t* __restrict__ slot_row,
                  const int32_t* __restrict__ lvl, const T* __restrict__ val,
                  int32_t* __restrict__ order, T* __restrict__ contrib) {
  __shared__ int32_t s_row[kOrderStage];
  __shared__ int32_t s_window[2];
  // entries and offsets are below 2^31 (raster.py bounds the rows)
  const int32_t valid = (int32_t)offsets[total];   // placed entries
  const int32_t first = blockIdx.x * kThreads;
  if (first >= valid) return;                      // the whole block
  const int32_t last = min(first + kThreads, valid);
  const int32_t e = first + threadIdx.x;
  int32_t row = 0, lo = 0, hi = 0, rank = 0;       // no entry: empty range
  if (e < last) {
    row = slot_row[e];
    const int32_t cell = key[row];
    lo = (int32_t)offsets[cell];
    hi = (int32_t)offsets[cell + 1];
    if (e == first) s_window[0] = lo;
    if (e == last - 1) s_window[1] = hi;
  }
  __syncthreads();
  const int32_t w_lo = s_window[0], w_hi = s_window[1];
  for (int32_t c = w_lo; c < w_hi; c += kOrderStage) {
    const int32_t m = min(kOrderStage, w_hi - c);
    if (c != w_lo) __syncthreads();                // the last stage is read
    for (int32_t t = threadIdx.x; t < m; t += kThreads) s_row[t] = slot_row[c + t];
    __syncthreads();
    const int32_t a = max(lo, c) - c, b = min(hi, c + m) - c;
    for (int32_t x = a; x < b; ++x) rank += s_row[x] < row;
  }
  if (e < last) {
    order[lo + rank] = row;
    contrib[lo + rank] = Arith<T>::mul(val[row], Arith<T>::pow2(-lvl[row]));
  }
}

// A pixel's sum in the chain's order when its (level, row) walk meets a row
// of an earlier tile (a table whose kept rows are not level-sorted): from
// the seed, tile by tile in ascending order, each tile's rows in (level,
// row) order, as the per-tile calls add them. Each pass finds the next tile
// present at the pixel (each segment is in row order, so its first row past
// the done tiles is its least) and adds that tile's rows.
template <typename T>
__device__ __noinline__ T chain_sum(const T* __restrict__ contrib,
                                    const int32_t* __restrict__ order,
                                    const int64_t* __restrict__ offsets,
                                    T acc, int32_t i, int32_t j, int32_t k,
                                    int32_t n_levels, int64_t tile) {
  for (int64_t done = -1;;) {
    int64_t next = INT64_MAX, base = 0;
    for (int l = 0; l < n_levels; ++l) {
      const int sh = k - min(l, k);
      const int64_t g = (int64_t)1 << (k - sh);
      const int64_t cell = base + (i >> sh) * g + (j >> sh);
      const int64_t end = offsets[cell + 1];
      for (int64_t e = offsets[cell]; e < end; ++e) {
        const int64_t t = order[e] / tile;
        if (t > done) {
          next = min(next, t);
          break;
        }
      }
      base += g * g;
    }
    if (next == INT64_MAX) return acc;
    base = 0;
    for (int l = 0; l < n_levels; ++l) {
      const int sh = k - min(l, k);
      const int64_t g = (int64_t)1 << (k - sh);
      const int64_t cell = base + (i >> sh) * g + (j >> sh);
      const int64_t end = offsets[cell + 1];
      for (int64_t e = offsets[cell]; e < end; ++e) {
        const int64_t t = order[e] / tile;
        if (t > next) break;
        if (t == next) acc = Arith<T>::add(acc, contrib[e]);
      }
      base += g * g;
    }
    done = next;
  }
}

// Step 5, one thread per pixel; the sum starts at ``img0[p]`` (B5) or 0
// (B2, ``img0`` null) and runs in T: each add rounds to T, as the
// reference's float32 or float64 adds do (no wider accumulator, no float
// atomics). ``offsets`` is the CSR over buckets base[l] + cell, cell =
// (i >> sh) * g + (j >> sh), sh = k - min(l, k), g = res >> sh; ``contrib``
// holds each bucket's value * 2^-l in row order, so a pixel reads its
// segments contiguously: no gather through the rows. Cells, offsets and
// rows fit int32 (raster.py bounds the pyramid and the rows).
//
// ``tile`` > 0 (below the rows, so below 2^31): the twins chain this
// table in tiles of ``tile`` rows and add in (tile, level, row) order. The
// walk's (level, row) order is that order while the rows' tiles never
// decrease along it, which holds on every table whose kept rows are
// level-sorted (an AMR tree's BFS rows, every MeshTable shard). A segment
// is in row order, so the walk checks only each segment's first row
// against the tile of the last row before it; a pixel that meets a row of
// an earlier tile starts again from its seed in chain_sum, so no table
// gives other bits.
template <typename T>
__global__ void projection_kernel(const T* __restrict__ contrib,
                                  const int32_t* __restrict__ order,
                                  const int64_t* __restrict__ offsets,
                                  const T* __restrict__ img0,
                                  int32_t res, int32_t k, int32_t n_levels,
                                  int64_t tile, T* __restrict__ img) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (int64_t)res * res) return;
  const int32_t i = (int32_t)(p >> k), j = (int32_t)(p & (res - 1));
  const int32_t rows = (int32_t)tile;
  const T seed = img0 ? img0[p] : T(0);
  T acc = seed;
  int32_t base = 0, tile_lo = 0;       // first row of the last row's tile
  bool again = false;
  for (int l = 0; l < n_levels; ++l) {
    const int sh = k - min(l, k);
    const int32_t g = res >> sh;
    const int32_t cell = base + (i >> sh) * g + (j >> sh);
    base += g * g;
    const int32_t end = (int32_t)offsets[cell + 1];
    int32_t e = (int32_t)offsets[cell];
    if (e == end) continue;
    if (rows > 0) {
      if (order[e] < tile_lo) {
        again = true;
        break;
      }
      const int32_t r = order[end - 1];
      tile_lo = r - r % rows;
    }
    for (; e < end; ++e) acc = Arith<T>::add(acc, contrib[e]);
  }
  img[p] = again ? chain_sum<T>(contrib, order, offsets, seed, i, j, k,
                                n_levels, tile)
                 : acc;
}

// ------------------------------------------------------------ B3 histogram

// Edges up to this many cross by value as a kernel parameter (2,056 bytes,
// under the 4 KB parameter limit): the caller's host copy is read by the C
// entry, so no host-to-device copy is made (raster.py's HIST_PARAM_EDGES).
constexpr int kParamEdges = 257;
struct HistEdges {
  double e[kParamEdges];
};

constexpr int kHistThreads = 256;

// level_hist_kernel's route, fixed per call by the C entry.
enum HistFlags : int32_t {
  kHistSmemEdges = 1,    // the edges copied into shared memory
  kHistVector = 2,       // 4 rows a unit, 16-byte loads (aligned columns)
};

// Row r's (L, B) cell, or -1 for a row np.histogram drops: not ok, NaN, out
// of [lo, hi], or a level outside [0, n_levels). v is the value widened to
// double. The bin is searchsorted(edges, v, side="right") - 1 (v == hi: the
// last bin): a guess from the uniform spacing, then corrected against the
// real edges; for any ascending edges (duplicates too) the walk ends at the
// largest g with e[g] <= v, and for np.linspace edges it takes at most one
// step. The guess is clamped before its conversion (NaN and inf included).
__device__ __forceinline__ int32_t hist_cell(double v, int32_t l, bool good,
                                             const double* e, int32_t bins,
                                             int32_t n_levels, double lo,
                                             double hi, double scale) {
  if (!good || !(v >= lo) || !(v <= hi) || l < 0 || l >= n_levels) return -1;
  int32_t g = bins - 1;
  if (v != hi) {
    const double t = (v - lo) * scale;
    g = t >= 1.0 ? (t < (double)(bins - 1) ? (int32_t)t : bins - 1) : 0;
    while (g > 0 && v < e[g]) --g;
    while (g < bins - 1 && v >= e[g + 1]) ++g;
  }
  return l * bins + g;
}

// Four consecutive values in 16-byte loads (two for double).
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void load4(const float* p, double (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// B3 in one launch, np.histogram's bins, into ``hist``, which is all zero
// on entry (the previous call on the stream zeroed it). One wave of blocks,
// grid-strided over units of rows: 4 rows on the vector route (16-byte
// value and level loads, the 4 ok bytes as one word; the last n % 4 rows go
// to block 0), else 1. A block counts into shared memory (kSharedCounts)
// and adds its non-zero cells into ``hist``, or, when L * B does not fit
// there, adds each row straight into ``hist``. The same launch zeroes
// ``next``, the output of the next call on the stream, so no call memsets
// and none waits for a last block. The edges come from ``edges`` on the
// device, or, when it is null, from the by-value ``pe``. A float32 value
// widens to double exactly and is binned against the float64 edges. The
// shared atomics are not warp-aggregated: __match_any_sync or a ballot loop
// before them measured slower on an H100, where the plain atomics cost
// little (PERF.md).
template <typename T, bool kSharedCounts>
__global__ void __launch_bounds__(kHistThreads)
level_hist_kernel(const T* __restrict__ val, const int32_t* __restrict__ lvl,
                  const uint8_t* __restrict__ ok,
                  const double* __restrict__ edges,
                  const __grid_constant__ HistEdges pe, int64_t n,
                  int32_t n_levels, int32_t bins, int32_t flags,
                  int32_t* __restrict__ hist, int32_t* __restrict__ next) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  const int32_t cells = n_levels * bins;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = first; t < cells; t += stride) next[t] = 0;
  const double* e = edges ? edges : pe.e;
  if (flags & kHistSmemEdges) {
    double* s_edges = reinterpret_cast<double*>(s_raw);
    for (int32_t t = threadIdx.x; t <= bins; t += blockDim.x) s_edges[t] = e[t];
    e = s_edges;
  }
  int32_t* h = hist;
  if (kSharedCounts) {
    h = reinterpret_cast<int32_t*>(
        s_raw + (flags & kHistSmemEdges ? (bins + 1) * sizeof(double) : 0));
    for (int32_t t = threadIdx.x; t < cells; t += blockDim.x) h[t] = 0;
  }
  __syncthreads();
  const double lo = e[0], hi = e[bins];
  const double scale = (double)bins / (hi - lo);
  if (flags & kHistVector) {
    const int64_t units = n / 4;
    for (int64_t u = first; u < units; u += stride) {
      double v[4];
      load4(val + 4 * u, v);
      const int4 l4 = reinterpret_cast<const int4*>(lvl)[u];
      const uint32_t o4 = reinterpret_cast<const uint32_t*>(ok)[u];
      const int32_t l[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int32_t c = hist_cell(v[j], l[j], (o4 >> (8 * j)) & 0xffu, e,
                                    bins, n_levels, lo, hi, scale);
        if (c >= 0) atomicAdd(&h[c], 1);
      }
    }
    if (blockIdx.x == 0 && threadIdx.x < n % 4) {
      const int64_t r = n - n % 4 + threadIdx.x;
      const int32_t c = hist_cell((double)val[r], lvl[r], ok[r], e, bins,
                                  n_levels, lo, hi, scale);
      if (c >= 0) atomicAdd(&h[c], 1);
    }
  } else {
    for (int64_t r = first; r < n; r += stride) {
      const int32_t c = hist_cell((double)val[r], lvl[r], ok[r], e, bins,
                                  n_levels, lo, hi, scale);
      if (c >= 0) atomicAdd(&h[c], 1);
    }
  }
  if (kSharedCounts) {
    __syncthreads();
    for (int32_t t = threadIdx.x; t < cells; t += blockDim.x)
      if (h[t]) atomicAdd(&hist[t], h[t]);
  }
}

// Pass 1 of B1 and B4: every row's plane test, and the hit leaves' keys
// over their pixels or into their cells. The scratch is all zero on entry.
template <typename T>
cudaError_t paint_slice(const int32_t* coords2, const int32_t* c_axis,
                        int64_t c_stride, const int32_t* lvl,
                        const uint8_t* ok, int64_t n, int32_t res,
                        int32_t n_levels, T position, const SliceScratch& sc,
                        cudaStream_t s) {
  if (n > 0)
    slice_paint_kernel<T><<<ceil_div(n, kThreads), kThreads, 0, s>>>(
        coords2, c_axis, c_stride, lvl, ok, n, res, n_levels, position, sc);
  return cudaGetLastError();
}

// B2/B5: the five steps on ``s``. ``zero_scratch`` holds scan_cells()
// int32 counts then their chunk counts, all zero on entry and on return;
// ``offsets_scratch`` scan_cells() int64; ``row_scratch`` five int32 words
// per table row: the ordered contributions (T, at the start, so aligned),
// then the key, the placed row and the ordered row (which holds the
// arrival indices until the order step writes it). The order step reads
// the values of type T. ``tile``: the twins' tile rows (0: one tile; see
// projection_kernel).
template <typename T>
cudaError_t projection(const int32_t* coords2, const int32_t* lvl,
                       const uint8_t* ok, const T* val, int64_t n,
                       int32_t res, int32_t n_levels, void* zero_scratch,
                       void* offsets_scratch, void* row_scratch,
                       const T* img0, int64_t tile, T* img, cudaStream_t s) {
  const int k = 31 - __builtin_clz(res);
  const int64_t total = level_base(n_levels, k);
  const int64_t cells = scan_cells(total);
  const int32_t n_chunks = (int32_t)(cells / kScanChunk);
  auto* count = static_cast<int32_t*>(zero_scratch);
  int32_t* chunk_count = count + cells;
  auto* offsets = static_cast<int64_t*>(offsets_scratch);
  T* contrib = static_cast<T*>(row_scratch);
  auto* key = reinterpret_cast<int32_t*>(contrib + n);
  int32_t* slot_row = key + n;
  int32_t* order = slot_row + n;
  const int64_t row_blocks = ceil_div(n, kThreads);
  if (n > 0) {
    proj_key_kernel<<<row_blocks, kThreads, 0, s>>>(
        coords2, lvl, ok, n, k, n_levels, total, key, order, count,
        chunk_count);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  proj_scan_kernel<<<n_chunks, kThreads, 0, s>>>(count, chunk_count, offsets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n > 0) {
    proj_place_kernel<<<row_blocks, kThreads, 0, s>>>(
        key, order, n, offsets, chunk_count, n_chunks, slot_row);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    proj_order_kernel<T><<<row_blocks, kThreads, 0, s>>>(
        key, offsets, total, slot_row, lvl, val, order, contrib);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int64_t npix = (int64_t)res * res;
  projection_kernel<T><<<ceil_div(npix, kThreads), kThreads, 0, s>>>(
      contrib, order, offsets, img0, res, k, n_levels, tile < n ? tile : 0,
      img);
  return cudaGetLastError();
}

// B4: one tile painted over (img0, depth0). ``keys_scratch`` (see
// SliceScratch) is all zero on entry and on return.
template <typename T>
cudaError_t slice_carry(const int32_t* coords2, const int32_t* c_axis,
                        int64_t c_stride, const int32_t* lvl,
                        const uint8_t* ok, const T* val, int64_t n,
                        int32_t res, int32_t n_levels, T position,
                        void* keys_scratch, const T* img0,
                        const int32_t* depth0, T* img, int32_t* depth,
                        cudaStream_t s) {
  const SliceScratch sc = slice_scratch(keys_scratch, res);
  const cudaError_t err = paint_slice<T>(coords2, c_axis, c_stride, lvl, ok,
                                         n, res, n_levels, position, sc, s);
  if (err != cudaSuccess) return err;
  slice_carry_resolve_kernel<T><<<resolve_blocks(res), kResolveThreads, 0, s>>>(
      sc, val, img0, depth0, res, img, depth);
  return cudaGetLastError();
}

// B3's wave: the blocks of level_hist_kernel<T, kSharedCounts> that are
// resident on the card at once with ``smem`` bytes of shared memory each.
// The occupancy query costs host time, so the last answer is kept per
// instantiation (the library's calls hold the interpreter lock: one at a
// time).
template <typename T, bool kSharedCounts>
cudaError_t hist_wave(int32_t device, size_t smem, int64_t* blocks) {
  static int32_t cached_device = -1;
  static size_t cached_smem = 0;
  static int64_t cached_blocks = 0;
  if (device != cached_device || smem != cached_smem) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, level_hist_kernel<T, kSharedCounts>, kHistThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    cached_device = device;
    cached_smem = smem;
    cached_blocks = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  }
  *blocks = cached_blocks;
  return cudaSuccess;
}

// B3: one launch that adds the counts into the all-zero ``hist`` and zeroes
// ``next`` (both (L, B) int32). ``edges`` is a host pointer when
// ``edges_on_host`` (at most kParamEdges edges, copied here into the
// kernel's parameters: no copy to the device), else a device pointer.
template <typename T>
cudaError_t level_hist(const T* val, const int32_t* lvl, const uint8_t* ok,
                       const double* edges, int32_t edges_on_host, int64_t n,
                       int32_t n_levels, int32_t bins, int32_t* hist,
                       int32_t* next, int32_t device, cudaStream_t s) {
  HistEdges pe;
  if (edges_on_host) {
    if (bins + 1 > kParamEdges) return cudaErrorInvalidValue;
    std::memcpy(pe.e, edges, (size_t)(bins + 1) * sizeof(double));
    edges = nullptr;
  }
  const size_t edge_bytes = (size_t)(bins + 1) * sizeof(double);
  const size_t count_bytes = (size_t)n_levels * bins * sizeof(int32_t);
  int32_t flags = 0;
  size_t smem = 0;
  if (edge_bytes <= kSmemNoOptIn) {
    flags |= kHistSmemEdges;
    smem = edge_bytes;
  }
  const bool shared_counts = smem + count_bytes <= kSmemNoOptIn;
  if (shared_counts) smem += count_bytes;
  if (((uintptr_t)val | (uintptr_t)lvl) % 16 == 0 && (uintptr_t)ok % 4 == 0)
    flags |= kHistVector;
  int64_t wave = 0;
  cudaError_t err = shared_counts ? hist_wave<T, true>(device, smem, &wave)
                                  : hist_wave<T, false>(device, smem, &wave);
  if (err != cudaSuccess) return err;
  // enough threads for every unit and every cell of ``next``, within a wave
  const int64_t units = flags & kHistVector ? n / 4 : n;
  const int64_t cells = (int64_t)n_levels * bins;
  int64_t blocks = ceil_div(units > cells ? units : cells, kHistThreads);
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  if (shared_counts)
    level_hist_kernel<T, true><<<blocks, kHistThreads, smem, s>>>(
        val, lvl, ok, edges, pe, n, n_levels, bins, flags, hist, next);
  else
    level_hist_kernel<T, false><<<blocks, kHistThreads, smem, s>>>(
        val, lvl, ok, edges, pe, n, n_levels, bins, flags, hist, next);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B1: the slice from the raw columns over an all-zero ``keys_scratch``
// (see SliceScratch), left all zero.
int raster_slice_f64(const int32_t* coords2, const int32_t* c_axis,
                     int64_t c_stride, const int32_t* lvl, const uint8_t* ok,
                     const double* val, int64_t n, int32_t res,
                     int32_t n_levels, double position, void* keys_scratch,
                     double* img, int32_t device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SliceScratch sc = slice_scratch(keys_scratch, res);
  const cudaError_t err = paint_slice<double>(
      coords2, c_axis, c_stride, lvl, ok, n, res, n_levels, position, sc, s);
  if (err != cudaSuccess) return err;
  slice_resolve_kernel<<<resolve_blocks(res), kResolveThreads, 0, s>>>(
      sc, val, res, img);
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
  return slice_carry<double>(coords2, c_axis, c_stride, lvl, ok, val, n,
                            res, n_levels, position, keys_scratch, img0,
                            depth0, img, depth,
                            static_cast<cudaStream_t>(stream));
}

// ``position`` is the slice position rounded to float32 by the caller.
int raster_slice_carry_f32(const int32_t* coords2, const int32_t* c_axis,
                           int64_t c_stride, const int32_t* lvl,
                           const uint8_t* ok, const float* val, int64_t n,
                           int32_t res, int32_t n_levels, float position,
                           void* keys_scratch, const float* img0,
                           const int32_t* depth0, float* img, int32_t* depth,
                           int32_t device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  return slice_carry<float>(coords2, c_axis, c_stride, lvl, ok, val, n,
                            res, n_levels, position, keys_scratch, img0,
                            depth0, img, depth,
                            static_cast<cudaStream_t>(stream));
}

int raster_projection_f64(const int32_t* coords2, const int32_t* lvl,
                          const uint8_t* ok, const double* val, int64_t n,
                          int32_t res, int32_t n_levels, void* zero_scratch,
                          void* offsets_scratch, void* row_scratch,
                          double* img, int32_t device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  return projection<double>(coords2, lvl, ok, val, n, res, n_levels,
                           zero_scratch, offsets_scratch, row_scratch, nullptr,
                           0, img, static_cast<cudaStream_t>(stream));
}

// B5 over ``img0``: ``tile`` is the twins' tile rows (0: one tile), whose
// chain order the projection keeps on any table (projection_kernel).
int raster_projection_carry_f64(const int32_t* coords2, const int32_t* lvl,
                                const uint8_t* ok, const double* val,
                                int64_t n, int32_t res, int32_t n_levels,
                                void* zero_scratch, void* offsets_scratch,
                                void* row_scratch, const double* img0,
                                int64_t tile, double* img, int32_t device,
                                void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  return projection<double>(coords2, lvl, ok, val, n, res, n_levels,
                           zero_scratch, offsets_scratch, row_scratch, img0,
                           tile, img, static_cast<cudaStream_t>(stream));
}

int raster_projection_carry_f32(const int32_t* coords2, const int32_t* lvl,
                                const uint8_t* ok, const float* val,
                                int64_t n, int32_t res, int32_t n_levels,
                                void* zero_scratch, void* offsets_scratch,
                                void* row_scratch, const float* img0,
                                int64_t tile, float* img, int32_t device,
                                void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  return projection<float>(coords2, lvl, ok, val, n, res, n_levels,
                           zero_scratch, offsets_scratch, row_scratch, img0,
                           tile, img, static_cast<cudaStream_t>(stream));
}

// B3 (see level_hist above): ``hist`` is the output the previous call
// zeroed, ``next`` the next call's.
int raster_level_hist_f64(const double* val, const int32_t* lvl,
                          const uint8_t* ok, const double* edges,
                          int32_t edges_on_host, int64_t n, int32_t n_levels,
                          int32_t bins, int32_t* hist, int32_t* next,
                          int32_t device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  return level_hist<double>(val, lvl, ok, edges, edges_on_host, n, n_levels,
                            bins, hist, next, device,
                            static_cast<cudaStream_t>(stream));
}

int raster_level_hist_f32(const float* val, const int32_t* lvl,
                          const uint8_t* ok, const double* edges,
                          int32_t edges_on_host, int64_t n, int32_t n_levels,
                          int32_t bins, int32_t* hist, int32_t* next,
                          int32_t device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return guard.error();
  return level_hist<float>(val, lvl, ok, edges, edges_on_host, n, n_levels,
                           bins, hist, next, device,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
