// K4: disparity extraction maps from the aggregated SGM total, with K5's
// left-right check fused in,
// K5: the standalone left-right gather on (H, W) maps, and
// K6: standalone extraction over an int8, int16 or float32 volume.
//
// K4 replaces the extraction half of
// stereovisionarray_tpu/ops/sgm_pallas.py::_rl_extract_kernel (via
// _rl_extract_wdh), whose math is extract_pallas.py::extract_row_maps /
// _wta_row / _subpixel. The TPU fused it into the last horizontal sweep and
// built the right view as a streaming anti-diagonal reduction, to avoid lane
// barrels; the reference's own tests prove that fusion bit-identical to
// extracting from the finished total, so here extraction reads the total.
// Each thread emits five maps of a pixel: left subpixel disparity, winning
// cost, uniqueness validity, second-best cost outside winner±1 (PKRN) and the
// right-view subpixel disparity, whose candidates are total[y, x + d, d]
// (BIG = 16000 past the right border). WTA ties go to the smallest d (the
// reference packs cost << lg | d); the parabola is float32 with an IEEE
// division, applied where 1 <= d <= D - 2 and clipped to ±0.5.
//
// K5 replaces stereovisionarray_tpu/ops/extract_pallas.py::_lr_check_kernel
// (via lr_gather_maps), which built d_R(x - d) for every d with a barrel and
// reduced it with a one-hot: here it is one gather per pixel,
// at = d_R(x - clip(rint(d_L), 0, D - 1)), 1e9 where that column is < 0. The
// caller's test |d_L - at| <= lr_max_diff & at < 1e9 (sgm_pallas.py:1093-1095)
// runs inside the extraction kernel: every input it needs is a right-view
// disparity of the same image row, which the kernel has just computed. A row
// is one thread block cluster of up to 8 CTAs of 128 columns each (a row per
// CTA would balance rows, not pixels, over the 132 SMs: 540 rows put 5 on some
// SMs and 4.09 on average). Each CTA keeps its columns' d_R in shared memory;
// after a cluster barrier each thread reads at from the CTA that owns column
// x - d through distributed shared memory, and writes the final validity.
// d_R goes to HBM only when the caller asks for the right map.
//
// K6 replaces stereovisionarray_tpu/ops/extract_pallas.py::_extract_kernel
// (via extract_maps_hdw / extract_disparity_hdw), the same extract_row_maps
// math over any aggregated or raw volume, with the LR check done in-volume by
// barrel shifts. Here it is the K4 kernel templated on the volume type: int8
// widens to int before anything (the reference widens to int16 before its
// BIG fill), integer volumes use BIG = 16000, float32 volumes compare and
// fill in float with BIG = 1e9 and keep the smallest d on ties. Its LR check
// is K4's fused one; without a check the right view is skipped.
//
// The tiled kernel. A CTA of C threads (C = 128, 64 or 32: the widest whose
// shared memory fits, ops/extract_cuda._tile_plan) walks its columns of a
// row a tile at a time: it copies columns [t0, t0 + C + R) of the row into
// shared memory, coalesced (R = D - 1 halo columns when the right view is
// computed, else 0), then thread i runs the per-pixel loop of column t0 + i
// on the staged copy. A staged column takes P words, P = ceil(D * size / 4)
// | 1: P odd puts the 32 lanes of a warp, which read 32 consecutive columns
// at one d, on 32 banks, for the left view (column i) and the right view
// (column i + d) alike. The staging copies 16 bytes a thread, kBatch loads
// in flight before the first store (four 32-bit shared stores each: a column
// starts at 4P bytes, 4 mod 8), where D * size is a multiple of 16 and the
// row aligned, else one element a thread. The per-pixel arithmetic is the
// untiled kernel's, so the maps are bit for bit.
//
// The split form, for an integer volume's right view whose halo would leave
// the SM one CTA (ops/extract_cuda._tile_plan). A row is one cluster of up
// to 8 CTAs of 4C threads (C = 32); CTA c stages only its own columns, C at
// a time, into a ring of kRing tiles filled by cp.async (16 bytes a lane, a
// warp a column), so tile t + 1 lands while tile t is computed. Threads
// [0, 2C) run the left view, two lanes a column (l and l ^ 16 of a warp),
// each over half of the column's 16-byte chunks, joined by a shuffle: the
// WTA is the min of packed keys (cost + 32768) << 16 | d, whose unsigned
// min keeps the smallest cost and, on ties, the smallest d (extract_pixel's
// strict <), then the second best outside winner±1. A staged column takes
// P = 4 * odd words, so the 8 lanes of a 16-byte load's wavefront (8
// consecutive columns) fall on 32 different banks. Threads [2C, 4C) fold
// every candidate total[y, xr + d, d] the tile holds into the CTA's partial
// key for right pixel xr, in shared memory; a warp folds 32 consecutive
// right pixels in step, so its lanes read one staged column at 32
// consecutive d: no bank conflict at any stride. After a cluster barrier
// each CTA finishes its own right pixels: the min over the partials of the
// CTAs that xr's window [xr, xr + D) spans (distributed shared memory), BIG
// at the first candidate past the border, and the parabola's two
// neighbours read from the volume (L2 hits). Every column of the volume is
// staged once.
//
// What bounds it on the H100. The volume is read once (the bound: 53 MB at
// 540x768x64 int16, 16 us at 3.35 TB/s; 238 MB at KITTI's 375x1242x256, 71
// us); a pixel makes ~3D shared loads (WTA, second best, right view), one
// wavefront each a warp in the tiled form. The tiled form at 540x768x64
// int16 with the LR check takes 25.7 KB of shared memory and 62 registers a
// thread (8 CTAs, 32 warps an SM, one CTA's staging overlapping another's
// loop), stages the halo, R / C ~ 0.5 more, mostly from L2, and runs at
// 0.050 ms; the split form there takes 0.071 ms. The halo grows with D: at
// D = 256 int16 the tiled form takes 198 KB, one CTA of 4 warps an SM whose
// staging and loop never overlap, and stages each column 4.3 times at
// KITTI's width: 1.021 ms against a 0.073 ms bound. The split form there
// takes 36 KB a CTA (six CTAs, 24 warps an SM) and 0.168 ms, of which its
// staging, barriers and right-view joins alone take ~0.10 ms (both views
// off). float32 volumes keep the tiled form (4 CTAs an SM at D = 64) and,
// where even C = 32 does not fit (D = 256 with a right view: 295 KB), the
// generic kernel, the untiled one, which reads the volume in place (every
// warp load touches 32 cache lines, D * size apart); no main path runs it.
// The fused LR check adds one shared store and one distributed
// shared-memory load a pixel. K5 standalone moves 3 * H*W floats (~5 MB): a
// few microseconds of device time, less than its wrapper's host time.

#include "common.cuh"

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // the standalone gather
constexpr int kColumns = 128;  // columns a CTA aims for with the LR check, and the generic form's
constexpr int kMaxCluster = 8;  // CTAs per row with the LR check (portable cluster size)
constexpr int kMaxTile = 128;  // the tiled kernel's widest tile (threads a CTA)
constexpr int kBatch = 8;  // 16-byte staging loads a thread keeps in flight
constexpr int kSplitTile = 32;  // the split form's columns a ring slot (a quarter of its threads)
constexpr int kRing = 2;  // tiles a split CTA keeps in shared memory
constexpr size_t kMaxSmem = 232448;  // the 227 KB of shared memory a block can use

// reference: extract_pallas.py::_subpixel
__device__ __forceinline__ float subpixel(int d_int, int n_disp, float fm, float f0, float fp) {
  const int d_c = min(max(d_int, 1), n_disp - 2);
  const float denom = fm - 2.0f * f0 + fp;
  const bool nonflat = fabsf(denom) > 1e-9f;
  float delta = nonflat ? (fm - fp) / (2.0f * denom) : 0.0f;
  delta = fminf(fmaxf(delta, -0.5f), 0.5f);
  return (d_int >= 1 && d_int <= n_disp - 2) ? static_cast<float>(d_c) + delta
                                             : static_cast<float>(d_int);
}

// the compute type and out-of-image sentinel of a volume's extraction: int8
// widens (as int16 does) to int with BIG = 16000, float32 stays float with
// BIG = 1e9 (extract_pallas.py::_big_for)
template <typename T>
struct Extract {
  using type = int;
  static constexpr int big = svt::kBigInt;
};
template <>
struct Extract<float> {
  using type = float;
  static constexpr float big = svt::kBigFloat;
};

// The maps of pixel (y, x), whose D values start at `a`, the next column's
// `stride` elements later (a staged tile, or the volume itself); returns its
// right-view disparity when `right`.
template <typename T>
__device__ __forceinline__ float extract_pixel(const T* __restrict__ a, int stride, size_t pix,
                                               int x, int w, int n_disp, int use_subpixel,
                                               float uniqueness, bool right,
                                               float* __restrict__ disp_l,
                                               float* __restrict__ cost_out,
                                               bool* __restrict__ valid,
                                               float* __restrict__ second_out) {
  using C = typename Extract<T>::type;
  constexpr C kBig = Extract<T>::big;
  // right view: candidate d of right pixel x is total[y, x + d, d]
  const T* ar = a;  // + d * (stride + 1) for candidate d
  const int n_right = min(n_disp, w - x);  // candidates inside the image, >= 1

  // d = 0 is every view's first candidate (the right view's is a[0] itself);
  // strict < keeps the smallest d on ties
  C best = static_cast<C>(a[0]), rbest = best;
  int bd = 0, rbd = 0;
  for (int d = 1; d < n_disp; ++d) {
    const C v = static_cast<C>(a[d]);
    if (v < best) { best = v; bd = d; }
    if (right) {
      const C r = d < n_right ? static_cast<C>(ar[d * (stride + 1)]) : kBig;
      if (r < rbest) { rbest = r; rbd = d; }
    }
  }
  C second = kBig;
  for (int d = 0; d < n_disp; ++d) {
    const C v = static_cast<C>(a[d]);
    if (abs(d - bd) > 1 && v < second) second = v;
  }

  const int dc = min(max(bd, 1), n_disp - 2);
  const float cost = static_cast<float>(best);
  const float sec = static_cast<float>(second);
  disp_l[pix] = use_subpixel ? subpixel(bd, n_disp, static_cast<float>(a[dc - 1]), cost,
                                        static_cast<float>(a[dc + 1]))
                             : static_cast<float>(bd);
  cost_out[pix] = cost;
  second_out[pix] = sec;
  valid[pix] = uniqueness > 0.0f ? cost < uniqueness * sec : true;
  if (!right) return 0.0f;
  const int rdc = min(max(rbd, 1), n_disp - 2);
  auto right_at = [&](int d) {
    return static_cast<float>(d < n_right ? static_cast<C>(ar[d * (stride + 1)]) : kBig);
  };
  return use_subpixel ? subpixel(rbd, n_disp, right_at(rdc - 1), static_cast<float>(rbest),
                                 right_at(rdc + 1))
                      : static_cast<float>(rbd);
}

// The fused LR check of a CTA's columns [x0, x1) of its row, once the CTA
// has its columns' d_R in `row_r`: each thread reads at = d_R(x - rint d_L)
// from the CTA of the row's cluster that owns that column, through
// distributed shared memory, and writes the final validity.
__device__ __forceinline__ void lr_check(float* row_r, size_t row, int x0, int x1, int cols,
                                         int n_disp, float lr_max_diff,
                                         float* __restrict__ disp_l, bool* __restrict__ valid) {
  cg::cluster_group cluster = cg::this_cluster();  // the CTAs of this row
  cluster.sync();
  for (int x = x0 + threadIdx.x; x < x1; x += blockDim.x) {
    // this thread's own stores of d_L and the uniqueness validity
    const float dl = disp_l[row + x];
    const int src = x - min(max(__float2int_rn(dl), 0), n_disp - 1);
    float at = svt::kBigFloat;
    if (src >= 0) {
      const unsigned owner = src / cols;
      at = cluster.map_shared_rank(row_r, owner)[src - static_cast<int>(owner) * cols];
    }
    valid[row + x] = valid[row + x] && fabsf(dl - at) <= lr_max_diff && at < svt::kBigFloat;
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// The tiled form: grid (CTAs per row, H), blockDim.x = C threads; CTA c owns
// columns [c * cols, (c + 1) * cols) and walks them C at a time. Dynamic
// shared memory: (C + halo) columns of stride_words words each, then, with
// lr_max_diff > 0 (each row one cluster), the CTA's `cols` floats of d_R.
template <typename T>
__global__ void __launch_bounds__(kMaxTile)
extract_maps_tiled(const T* __restrict__ total, int h, int w, int n_disp, int cols, int halo,
                   int stride_words, int use_subpixel, float uniqueness, float lr_max_diff,
                   float* __restrict__ disp_l, float* __restrict__ cost_out,
                   bool* __restrict__ valid, float* __restrict__ second_out,
                   float* __restrict__ disp_r) {
  extern __shared__ __align__(16) uint32_t staged_words[];
  const int tile = blockDim.x;
  const bool lr = lr_max_diff > 0.0f;  // uniform over the launch
  const bool right = lr || disp_r != nullptr;
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * cols;
  const int x1 = min(x0 + cols, w);
  const size_t row = static_cast<size_t>(y) * w;
  const int stride = stride_words * 4 / static_cast<int>(sizeof(T));  // elements a column
  const int col_bytes = n_disp * static_cast<int>(sizeof(T));
  T* staged = reinterpret_cast<T*>(staged_words);
  float* row_r = reinterpret_cast<float*>(staged_words + static_cast<size_t>(tile + halo) *
                                                             stride_words);
  for (int t0 = x0; t0 < x1; t0 += tile) {
    const int n_cols = min(min(t0 + tile, x1) + halo, w) - t0;  // the tile and its halo
    const T* src = total + (row + t0) * n_disp;
    __syncthreads();  // every thread is done with the previous tile
    if (col_bytes % 16 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      // 16 bytes a thread, consecutive threads on consecutive 16 bytes, kBatch
      // loads in flight before the first store; four 32-bit stores each (a
      // column starts at 4P bytes, P odd)
      const int chunks = col_bytes / 16;  // a column's
      const int n_chunks = n_cols * chunks;
      const uint4* src4 = reinterpret_cast<const uint4*>(src);
      for (int q0 = threadIdx.x; q0 < n_chunks; q0 += kBatch * tile) {
        uint4 v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (q0 + k * tile < n_chunks) v[k] = __ldg(src4 + q0 + k * tile);
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int q = q0 + k * tile;
          if (q < n_chunks) {
            const int j = q / chunks;
            uint32_t* dst = staged_words + j * stride_words + (q - j * chunks) * 4;
            dst[0] = v[k].x;
            dst[1] = v[k].y;
            dst[2] = v[k].z;
            dst[3] = v[k].w;
          }
        }
      }
    } else {  // an element a thread: D * size not a multiple of 16, or an offset view
      for (int e = threadIdx.x; e < n_cols * n_disp; e += tile) {
        const int j = e / n_disp;
        staged[j * stride + (e - j * n_disp)] = __ldg(src + e);
      }
    }
    __syncthreads();
    const int x = t0 + threadIdx.x;
    if (x < x1) {
      const float dr = extract_pixel(staged + threadIdx.x * stride, stride, row + x, x, w, n_disp,
                                     use_subpixel, uniqueness, right, disp_l, cost_out, valid,
                                     second_out);
      if (lr) row_r[x - x0] = dr;
      if (disp_r != nullptr) disp_r[row + x] = dr;
    }
  }
  if (lr) lr_check(row_r, row, x0, x1, cols, n_disp, lr_max_diff, disp_l, valid);
}

// A candidate of the split form, packed: the unsigned min of two keys is the
// smaller cost and, on equal costs, the smaller d.
__device__ __forceinline__ uint32_t cost_key(int cost, int d) {
  return (static_cast<uint32_t>(cost + 32768) << 16) | static_cast<uint32_t>(d);
}
constexpr uint32_t kNoKey = 0xFFFFFFFFu;  // no candidate yet

// 16 staged bytes of a column
template <typename T>
union Chunk {
  uint4 bits;
  T v[16 / sizeof(T)];
};

// The left view of the split form: lanes l and l ^ 16 of a warp share a
// column of `n_disp` staged values at `col` (16-byte aligned), each taking
// half of its 16-byte chunks (`half` 0 or 1), and join their minima with one
// shuffle; every lane of the warp calls it. The arithmetic is
// extract_pixel's: the WTA as the min of packed keys (the smallest d on
// ties), the second best outside winner±1 from BIG, the parabola in float32.
// The lane of half 0 writes the maps when `write`.
template <typename T>
__device__ __forceinline__ void left_view_shared(const T* col, int n_disp, int half, bool write,
                                                 size_t pix, int use_subpixel, float uniqueness,
                                                 float* __restrict__ disp_l,
                                                 float* __restrict__ cost_out,
                                                 bool* __restrict__ valid,
                                                 float* __restrict__ second_out) {
  constexpr int kVals = 16 / sizeof(T);
  const Chunk<T>* chunks = reinterpret_cast<const Chunk<T>*>(col);
  const int q_full = n_disp / kVals;  // whole chunks; the rest, one value at a time
  const int q_mid = (q_full + 1) / 2;
  const int qa = half ? q_mid : 0, qb = half ? q_full : q_mid;
  uint32_t best = kNoKey;
  for (int q = qa; q < qb; ++q) {
    const Chunk<T> c = chunks[q];
#pragma unroll
    for (int k = 0; k < kVals; ++k) best = min(best, cost_key(c.v[k], q * kVals + k));
  }
  for (int d = q_full * kVals + half; d < n_disp; d += 2) best = min(best, cost_key(col[d], d));
  best = min(best, __shfl_xor_sync(0xFFFFFFFFu, best, 16));
  const int bd = best & 0xFFFF;
  int second = svt::kBigInt;
  for (int q = qa; q < qb; ++q) {
    const Chunk<T> c = chunks[q];
#pragma unroll
    for (int k = 0; k < kVals; ++k) {
      if (static_cast<unsigned>(q * kVals + k - bd + 1) > 2u) second = min(second, int{c.v[k]});
    }
  }
  for (int d = q_full * kVals + half; d < n_disp; d += 2) {
    if (static_cast<unsigned>(d - bd + 1) > 2u) second = min(second, int{col[d]});
  }
  second = min(second, __shfl_xor_sync(0xFFFFFFFFu, second, 16));
  if (!write) return;
  const float cost = static_cast<float>(static_cast<int>(best >> 16) - 32768);
  const float sec = static_cast<float>(second);
  const int dc = min(max(bd, 1), n_disp - 2);
  disp_l[pix] = use_subpixel ? subpixel(bd, n_disp, static_cast<float>(col[dc - 1]), cost,
                                        static_cast<float>(col[dc + 1]))
                             : static_cast<float>(bd);
  cost_out[pix] = cost;
  second_out[pix] = sec;
  valid[pix] = uniqueness > 0.0f ? cost < uniqueness * sec : true;
}

// The split form over an int8 or int16 volume (the comment at the top):
// grid (per_row, H), each row one cluster; blockDim.x = 4C. CTA c owns
// columns [c * cols, (c + 1) * cols). Threads [0, 2C) run the left view,
// two a column; threads [2C, 4C) fold the right view. Dynamic shared memory:
// the ring (kRing tiles of C columns of stride_words words, a multiple of
// 4), with lr_max_diff > 0 the CTA's `cols` floats of d_R, then the partial
// keys of right pixels [max(0, x0 - D + 1), x1).
template <typename T>
__global__ void __launch_bounds__(4 * kSplitTile)
extract_maps_split(const T* __restrict__ total, int h, int w, int n_disp, int cols,
                   int stride_words, int use_subpixel, float uniqueness, float lr_max_diff,
                   float* __restrict__ disp_l, float* __restrict__ cost_out,
                   bool* __restrict__ valid, float* __restrict__ second_out,
                   float* __restrict__ disp_r) {
  static_assert(std::is_integral<T>::value, "the split form packs integer costs");
  constexpr int kBig = svt::kBigInt;
  extern __shared__ __align__(16) uint32_t ring_words[];
  const int tile = blockDim.x / 4;
  const int tid = threadIdx.x;
  const bool lr = lr_max_diff > 0.0f;  // uniform over the launch
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * cols;
  const int x1 = min(x0 + cols, w);
  const size_t row = static_cast<size_t>(y) * w;
  const int stride = stride_words * 4 / static_cast<int>(sizeof(T));  // elements a column
  const int tile_words = tile * stride_words;
  float* row_r = reinterpret_cast<float*>(ring_words + kRing * tile_words);
  uint32_t* part = reinterpret_cast<uint32_t*>(row_r + (lr ? cols : 0));
  const int xlo = max(0, x0 - n_disp + 1);  // the first right pixel the CTA's columns reach
  for (int i = tid; i < x1 - xlo; i += blockDim.x) part[i] = kNoKey;

  // tile t: columns [x0 + t * C, min(x0 + (t + 1) * C, x1)) into ring slot t % kRing
  const int n_tiles = (x1 - x0 + tile - 1) / tile;
  const int col_chunks = n_disp * static_cast<int>(sizeof(T)) / 16;
  const bool by_chunks =
      n_disp * sizeof(T) % 16 == 0 && (reinterpret_cast<uintptr_t>(total) & 15) == 0;
  auto stage = [&](int t) {
    if (t >= n_tiles) return;
    const int t0 = x0 + t * tile;
    const int n = min(tile, x1 - t0);
    uint32_t* slot = ring_words + (t % kRing) * tile_words;
    if (by_chunks) {  // a warp a column, 16 bytes a lane
      const uint4* src = reinterpret_cast<const uint4*>(total + (row + t0) * n_disp);
      for (int j = tid / 32; j < n; j += blockDim.x / 32)
        for (int k = tid % 32; k < col_chunks; k += 32)
          svt::cp_async<16>(slot + j * stride_words + 4 * k, src + j * col_chunks + k);
    } else {  // an element a thread: D * size not a multiple of 16, or an offset view
      const T* src = total + (row + t0) * n_disp;
      T* st = reinterpret_cast<T*>(slot);
      for (int e = tid; e < n * n_disp; e += blockDim.x) {
        const int j = e / n_disp;
        st[j * stride + (e - j * n_disp)] = __ldg(src + e);
      }
    }
  };

  for (int t = 0; t < kRing - 1; ++t) {
    stage(t);
    svt::cp_async_commit();
  }
  const int lane = tid % 32;
  for (int t = 0; t < n_tiles; ++t) {
    stage(t + kRing - 1);  // into the slot of tile t - 1, which every thread is done with
    svt::cp_async_commit();
    svt::cp_async_wait<kRing - 1>();  // this thread's copies of tile t have landed
    __syncthreads();  // and every thread's
    const int t0 = x0 + t * tile;
    const int n = min(tile, x1 - t0);
    const T* st = reinterpret_cast<const T*>(ring_words + (t % kRing) * tile_words);
    if (tid < 2 * tile) {  // the left view: column i, lanes l and l ^ 16 of a warp
      const int i = tid / 32 * 16 + lane % 16;
      left_view_shared(st + i * stride, n_disp, lane / 16, i < n && lane < 16, row + t0 + i,
                       use_subpixel, uniqueness, disp_l, cost_out, valid, second_out);
    } else {
      // the right pixels whose window meets the tile, [a, b), 32 consecutive
      // a warp; column j holds candidate d = t0 + j - xr of pixel xr (a
      // pixel past b finds no d in range: it loads nothing and stores nothing)
      const int a = max(xlo, t0 - n_disp + 1), b = t0 + n;
      for (int xr = a + tid - 2 * tile; xr - lane < b; xr += 2 * tile) {
        const int first = xr - lane, last = min(first + 31, b - 1);
        const int j0 = max(0, first - t0), j1 = min(n, last + n_disp - t0);
        uint32_t key = xr < b ? part[xr - xlo] : kNoKey;
        int d = t0 + j0 - xr;
#pragma unroll 4
        for (int j = j0; j < j1; ++j, ++d) {
          if (static_cast<unsigned>(d) < static_cast<unsigned>(n_disp))
            key = min(key, cost_key(st[j * stride + d], d));
        }
        if (xr < b) part[xr - xlo] = key;
      }
    }
    __syncthreads();  // tile t's slot is free, its partials written
  }

  // the right view of the CTA's own pixels, from the partials of the CTAs
  // whose columns xr's candidates lie in
  cg::cluster_group cluster = cg::this_cluster();  // the CTAs of this row
  cluster.sync();
  for (int xr = x0 + tid; xr < x1; xr += blockDim.x) {
    const int n_right = min(n_disp, w - xr);  // candidates inside the image
    uint32_t key = n_right < n_disp ? cost_key(kBig, n_right) : kNoKey;
    for (int c = blockIdx.x; c * cols < xr + n_right; ++c) {
      const int xlo_c = max(0, c * cols - n_disp + 1);
      key = min(key, cluster.map_shared_rank(part, c)[xr - xlo_c]);
    }
    const int rbd = key & 0xFFFF;
    float dr = static_cast<float>(rbd);
    if (use_subpixel) {
      auto right_at = [&](int d) {
        return static_cast<float>(d < n_right ? int{total[(row + xr + d) * n_disp + d]} : kBig);
      };
      const int rdc = min(max(rbd, 1), n_disp - 2);
      const float rbest = static_cast<float>(static_cast<int>(key >> 16) - 32768);
      dr = subpixel(rbd, n_disp, right_at(rdc - 1), rbest, right_at(rdc + 1));
    }
    if (lr) row_r[xr - x0] = dr;
    if (disp_r != nullptr) disp_r[row + xr] = dr;
  }
  if (lr) {
    lr_check(row_r, row, x0, x1, cols, n_disp, lr_max_diff, disp_l, valid);
  } else {
    cluster.sync();  // no CTA leaves while another reads its partials
  }
}

// The generic form, for volumes whose smallest tile does not fit in shared
// memory: each thread reads its pixel's values from the volume in place.
// Grid (CTAs per row, H); CTA c covers columns [c * cols, (c + 1) * cols);
// with lr_max_diff > 0 each row is one cluster and every CTA has `cols`
// floats of dynamic shared memory for its columns' d_R.
template <typename T>
__global__ void __launch_bounds__(1024)
extract_maps_generic(const T* __restrict__ total, int h, int w, int n_disp, int cols,
                     int use_subpixel, float uniqueness, float lr_max_diff,
                     float* __restrict__ disp_l, float* __restrict__ cost_out,
                     bool* __restrict__ valid, float* __restrict__ second_out,
                     float* __restrict__ disp_r) {
  extern __shared__ float row_r[];
  const bool lr = lr_max_diff > 0.0f;  // uniform over the launch
  const bool right = lr || disp_r != nullptr;
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * cols;
  const int x1 = min(x0 + cols, w);
  const size_t row = static_cast<size_t>(y) * w;
  for (int x = x0 + threadIdx.x; x < x1; x += blockDim.x) {
    const float dr = extract_pixel(total + (row + x) * n_disp, n_disp, row + x, x, w, n_disp,
                                   use_subpixel, uniqueness, right, disp_l, cost_out, valid,
                                   second_out);
    if (lr) row_r[x - x0] = dr;
    if (disp_r != nullptr) disp_r[row + x] = dr;
  }
  if (lr) lr_check(row_r, row, x0, x1, cols, n_disp, lr_max_diff, disp_l, valid);
}

__global__ void __launch_bounds__(kThreads)
lr_gather_kernel(const float* __restrict__ disp_l, const float* __restrict__ disp_r,
                 float* __restrict__ at, int h, int w, int n_disp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const size_t pix = static_cast<size_t>(y) * w + x;
  const int d = min(max(__float2int_rn(disp_l[pix]), 0), n_disp - 1);
  at[pix] = x - d >= 0 ? disp_r[pix - d] : svt::kBigFloat;
}

// Lets `kernel` take up to kMaxSmem of dynamic shared memory on the current
// device: set once a device (`raised`, a bit a device) for each kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, uint64_t& raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && ((raised >> dev) & 1)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
  if (err == cudaSuccess && dev < 64) raised |= uint64_t{1} << dev;
  return err;
}

// the forms of svt_extract_maps (ops/extract_cuda.FORMS)
enum Form { kGeneric = 0, kTiled = 1, kSplit = 2 };

template <typename T>
cudaError_t launch_extract(const void* total, int h, int w, int n_disp, int use_subpixel,
                           float uniqueness, float lr_max_diff, int form, int tile,
                           int stride_words, void* disp_l, void* cost, void* valid, void* second,
                           void* disp_r, cudaStream_t stream) {
  const bool lr = lr_max_diff > 0.0f;
  const bool right = lr || disp_r != nullptr;
  const int halo = right ? n_disp - 1 : 0;
  // with the LR check, and in the split form, a row is one cluster of up to
  // 8 CTAs (the same rule in ops/extract_cuda._tile_plan)
  const int cluster_cols = std::min(kMaxCluster, (w + kColumns - 1) / kColumns);
  const bool clustered = lr || form == kSplit;
  int per_row, cols;
  size_t smem;
  if (form == kGeneric) {
    per_row = lr ? cluster_cols : (w + kColumns - 1) / kColumns;
    cols = (w + per_row - 1) / per_row;
    smem = lr ? cols * sizeof(float) : 0;
  } else {
    if (static_cast<long long>(stride_words) * 4 <
        static_cast<long long>(n_disp) * static_cast<long long>(sizeof(T)))
      return cudaErrorInvalidValue;  // a staged column would overlap the next
    const size_t row_r = lr ? ((w + cluster_cols - 1) / cluster_cols) * sizeof(float) : 0;
    if (form == kTiled) {
      if (tile != 32 && tile != 64 && tile != kMaxTile) return cudaErrorInvalidValue;
      per_row = lr ? cluster_cols : (w + tile - 1) / tile;
      cols = lr ? (w + per_row - 1) / per_row : tile;
      smem = static_cast<size_t>(tile + halo) * 4 * stride_words + row_r;
    } else if (form == kSplit && std::is_integral<T>::value && right && n_disp < 65536) {
      if (tile != kSplitTile || stride_words % 4 != 0)
        return cudaErrorInvalidValue;  // a staged column starts on 16 bytes
      per_row = cluster_cols;
      cols = (w + per_row - 1) / per_row;
      smem = static_cast<size_t>(kRing) * tile * 4 * stride_words + row_r +
             (cols + n_disp - 1) * sizeof(uint32_t);
    } else {
      return cudaErrorInvalidValue;
    }
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
  }
  if (lr && cols * sizeof(float) > 48 * 1024) return cudaErrorInvalidValue;  // W > 8 * 12288
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = per_row;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(per_row, h);
  cfg.blockDim = dim3(form == kGeneric ? std::min(1024, (cols + 31) / 32 * 32)
                                       : (form == kSplit ? 4 * tile : tile));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = clustered ? 1 : 0;
  const T* vol = static_cast<const T*>(total);
  float* dl = static_cast<float*>(disp_l);
  float* c = static_cast<float*>(cost);
  bool* v = static_cast<bool*>(valid);
  float* sec = static_cast<float*>(second);
  float* dr = static_cast<float*>(disp_r);
  cudaError_t err = cudaSuccess;
  if (form == kGeneric) {
    err = cudaLaunchKernelEx(&cfg, extract_maps_generic<T>, vol, h, w, n_disp, cols, use_subpixel,
                             uniqueness, lr_max_diff, dl, c, v, sec, dr);
  } else if (form == kTiled) {
    static uint64_t raised = 0;
    if (smem > 48 * 1024) err = allow_smem(extract_maps_tiled<T>, raised);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, extract_maps_tiled<T>, vol, h, w, n_disp, cols, halo,
                               stride_words, use_subpixel, uniqueness, lr_max_diff, dl, c, v, sec,
                               dr);
  } else if constexpr (std::is_integral<T>::value) {  // instantiated for integer volumes only
    static uint64_t raised = 0;
    if (smem > 48 * 1024) err = allow_smem(extract_maps_split<T>, raised);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, extract_maps_split<T>, vol, h, w, n_disp, cols,
                               stride_words, use_subpixel, uniqueness, lr_max_diff, dl, c, v, sec,
                               dr);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// total: (H, W, D) int8 (total_bytes 1), int16 (2) or float32 (4); outputs
// (H, W): disp_l, cost, second, disp_r f32, valid bool. uniqueness <= 0
// disables the ratio test; lr_max_diff > 0 applies the left-right check to
// valid (W at most 8 * 12288); disp_r null leaves the right map out of HBM
// (and, without the LR check, skips the right view). form: 0 the generic
// form; 1 the tiled form, `tile` columns a tile (32, 64 or 128); 2 the
// split form (integer volumes with a right view), `tile` columns a ring
// slot (32); stride_words: the 32-bit words of a staged column, at
// least D * size / 4, a multiple of 4 in the split form
// (ops/extract_cuda._tile_plan). A plan that does not fit is refused.
SVT_API int svt_extract_maps(const void* total, int total_bytes, int h, int w, int n_disp,
                             int use_subpixel, float uniqueness, float lr_max_diff, int form,
                             int tile, int stride_words, void* disp_l, void* cost, void* valid,
                             void* second, void* disp_r, void* stream) {
  if (h <= 0 || w <= 0 || n_disp < 3 || form < kGeneric || form > kSplit)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (total_bytes) {
    case 1:
      return launch_extract<int8_t>(total, h, w, n_disp, use_subpixel, uniqueness, lr_max_diff,
                                    form, tile, stride_words, disp_l, cost, valid, second, disp_r,
                                    s);
    case 2:
      return launch_extract<int16_t>(total, h, w, n_disp, use_subpixel, uniqueness, lr_max_diff,
                                     form, tile, stride_words, disp_l, cost, valid, second,
                                     disp_r, s);
    case 4:
      return launch_extract<float>(total, h, w, n_disp, use_subpixel, uniqueness, lr_max_diff,
                                   form, tile, stride_words, disp_l, cost, valid, second, disp_r,
                                   s);
    default:
      return cudaErrorInvalidValue;
  }
}

// disp_l/disp_r: (H, W) f32 left/right subpixel maps; at: (H, W) f32.
SVT_API int svt_lr_gather(const void* disp_l, const void* disp_r, void* at, int h, int w,
                          int n_disp, void* stream) {
  if (h <= 0 || w <= 0 || n_disp < 1) return cudaErrorInvalidValue;
  const dim3 grid((w + kThreads - 1) / kThreads, h);
  lr_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(disp_l), static_cast<const float*>(disp_r),
      static_cast<float*>(at), h, w, n_disp);
  return cudaGetLastError();
}
