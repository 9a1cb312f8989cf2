// K1: census + Birchfield-Tomasi matching cost, stored as an (H, W, D)
// int8, int16 or float32 volume.
//
// Replaces stereovisionarray_tpu/ops/cost_pallas.py::_wdh_kernel (via
// fused_cost_volume_pallas_wdh) and ::_cost_kernel (via
// fused_cost_volume_pallas_hdw): the TPU built the same costs in two layouts,
// with barrel rolls and reversed operand stacks because Mosaic could neither
// gather along lanes nor slice at a dynamic sublane offset. Here one kernel
// writes the (H, W, D) layout directly and reads shifted pixels by index.
//
// cost[y, x, d] = popcount(census_L(y, x) ^ census_R(y, x - d))
//               + bt_weight * min(BT_lr, BT_rl, bt_clip),
// x < d -> worst = n_bits + bt_weight * bt_clip; stored round(cost * scale)
// (half to even), or as it is in a float32 volume (the reference builds that
// one in XLA; no TPU kernel stands behind it, but without this store the
// float route would run the plain PyTorch cost volume, tens of milliseconds
// on an H100 at 540x768x64). The census clamps at the image edges; the
// half-pixel BT bounds wrap around the row (x = 0 reads x = W - 1), as the
// reference's jnp.roll does. Built with -fmad=false so
// `ham + bt_weight * bt` rounds twice, as the reference does.
//
// What bounds it on the H100: at 540x768x64 int8 the volume write is 26.5 MB
// (~8 us at 3.35 TB/s). The work the function needs is ~25 instructions an
// output (a 64-bit XOR and popcount, a conversion, ~14 float operations of
// BT, the store's share), four of them on the quarter-rate unit (two POPC,
// the two conversions): 26.5 M outputs put that floor at 20-30 us. So
// instructions, not memory, are the bound, and the design spends none that
// the function does not need.
//
// The tiled kernel (cost_volume_tiled_kernel). A CTA of C threads (C = 256,
// 128 or 64, ops/cost_cuda._tile_plan) owns C consecutive left pixels of one
// row:
//  1. it stages the census window's rows around y, edge-clamped, into
//     shared memory as float32, 16 bytes a thread where the image rows are
//     aligned: the left image over [x0 - m, x0 + C + m), the right one over
//     [x0 - (D - 1) - m, x0 + C + m), m = max(pw, 1), each span widened to
//     start at a multiple of 4 columns;
//  2. its threads build the census code (up to four 64-bit words, in the
//     bit order of the untiled kernel) and the BT triple (value, min, max) of
//     its C left and C + D - 1 right pixels once each, into shared memory:
//     word k of pixel i at codes[k][i], so a warp's 32 lanes read 32
//     consecutive words, conflict-free. A BT neighbour across a row end is
//     read from the image itself (the wrap), not from the clamped stage. The
//     census windows of the main paths (7x9, and 5x7 in the two-view
//     cascade's coarse pass) are unrolled at compile time; any other is read
//     at run time over four guarded words, at about twice the time;
//  3. after one barrier, thread i sweeps pixel x0 + i over all D disparities
//     in runs of V (V * size = 16 bytes, or 8 where D * size is not a
//     multiple of 16): the left code and triple stay in registers, only the
//     right operands are read a disparity. The 32 lanes of a warp cover 32
//     consecutive pixels; each puts K runs of its pixel into the warp's out
//     buffer (the staged rows' space, at an XOR swizzle or an odd stride, so
//     conflict-free), and the warp writes them out as whole chunks of up to
//     128 bytes of each pixel's row, 32 vector stores an instruction. A
//     thread storing its own runs straight to memory left each line of the
//     volume written in pieces over its whole sweep: that took the float32
//     volume 0.196 ms against 0.049 without the stores, and 0.059 this way
//     (540x768x64 on an H100 80GB HBM3 at 700 W, scripts/perf_k1_phases.py).
//
// The generic form (cost_volume_generic_kernel) is the untiled kernel this
// one replaced: a CTA per (row, 64 pixels) builds every census from device
// memory, then sweeps (x, d) with d fastest, a byte a thread. It serves the
// shapes no tile can (D * size not a multiple of 8, or a stage larger than
// shared memory); no path of the port gives it one.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxWords = 4;   // census codes up to 256 bits
constexpr size_t kMaxSmem = 232448;  // what an H100 block can use

// ---- the generic form ------------------------------------------------------

constexpr int kGenericTile = 64;  // left pixels per block
constexpr int kGenericThreads = 256;

// Census code of pixel (y, x): bit b (row-major over the window, centre
// skipped) is set when that neighbour < the centre; edge-clamped neighbours.
__device__ void census_at(const float* __restrict__ img, int h, int w, int y, int x,
                          int ph, int pw, uint64_t* code) {
  const float c = img[y * w + x];
  uint64_t cur = 0;
  int bit = 0;
  for (int dy = -ph; dy <= ph; ++dy) {
    const float* row = img + min(max(y + dy, 0), h - 1) * w;
    for (int dx = -pw; dx <= pw; ++dx) {
      if (dy == 0 && dx == 0) continue;
      if (row[min(max(x + dx, 0), w - 1)] < c) cur |= 1ull << (bit & 63);
      if ((++bit & 63) == 0) {
        code[(bit >> 6) - 1] = cur;
        cur = 0;
      }
    }
  }
  if (bit & 63) code[bit >> 6] = cur;
}

// value, min and max of a pixel and its two half-pixel neighbours (wrapping)
__device__ void half_pixel_bounds(const float* __restrict__ row, int w, int x, float* v,
                                  float* mn, float* mx) {
  const float c = row[x];
  const float lh = 0.5f * (c + row[x == 0 ? w - 1 : x - 1]);
  const float rh = 0.5f * (c + row[x == w - 1 ? 0 : x + 1]);
  *v = c;
  *mn = fminf(fminf(lh, rh), c);
  *mx = fmaxf(fmaxf(lh, rh), c);
}

// the stored cost: round(cost * scale) for integer volumes, the cost itself
// (scale 1, no rounding) for float32 ones
template <typename OutT>
__device__ __forceinline__ OutT store_cost(float cost, float scale) {
  return static_cast<OutT>(__float2int_rn(cost * scale));
}
template <>
__device__ __forceinline__ float store_cost<float>(float cost, float) {
  return cost;
}

template <typename OutT>
__global__ void __launch_bounds__(kGenericThreads)
cost_volume_generic_kernel(const float* __restrict__ left, const float* __restrict__ right,
                           OutT* __restrict__ out, int h, int w, int n_disp, int ph, int pw,
                           int n_words, float bt_weight, float bt_clip, float worst,
                           float scale) {
  extern __shared__ uint64_t smem[];
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kGenericTile;
  const int n_right = kGenericTile + n_disp - 1;  // right pixels x0 - D + 1 .. x0 + 63
  const int r0 = x0 - (n_disp - 1);
  uint64_t* cl = smem;                          // [kGenericTile][n_words]
  uint64_t* cr = cl + kGenericTile * n_words;   // [n_right][n_words]
  float* lv = reinterpret_cast<float*>(cr + n_right * n_words);  // [3][kGenericTile]
  float* rv = lv + 3 * kGenericTile;            // [3][n_right]
  const bool use_bt = bt_weight > 0.0f;

  for (int i = threadIdx.x; i < kGenericTile + n_right; i += blockDim.x) {
    if (i < kGenericTile) {
      const int x = x0 + i;
      if (x >= w) continue;
      census_at(left, h, w, y, x, ph, pw, cl + i * n_words);
      if (use_bt)
        half_pixel_bounds(left + y * w, w, x, &lv[i], &lv[kGenericTile + i],
                          &lv[2 * kGenericTile + i]);
    } else {
      const int j = i - kGenericTile;
      const int x = r0 + j;
      if (x < 0 || x >= w) continue;
      census_at(right, h, w, y, x, ph, pw, cr + j * n_words);
      if (use_bt)
        half_pixel_bounds(right + y * w, w, x, &rv[j], &rv[n_right + j], &rv[2 * n_right + j]);
    }
  }
  __syncthreads();

  OutT* out_row = out + static_cast<size_t>(y) * w * n_disp;
  for (int i = threadIdx.x; i < kGenericTile * n_disp; i += blockDim.x) {
    const int xl = i / n_disp;
    const int d = i - xl * n_disp;
    const int x = x0 + xl;
    if (x >= w) break;  // i only grows, so every later (x, d) is past the edge too
    float cost = worst;
    if (x >= d) {
      const int j = xl + (n_disp - 1) - d;  // right pixel x - d
      int ham = 0;
      for (int k = 0; k < n_words; ++k)
        ham += __popcll(cl[xl * n_words + k] ^ cr[j * n_words + k]);
      cost = static_cast<float>(ham);
      if (use_bt) {
        const float lt = lv[xl], l_mn = lv[kGenericTile + xl], l_mx = lv[2 * kGenericTile + xl];
        const float rs = rv[j], r_mn = rv[n_right + j], r_mx = rv[2 * n_right + j];
        const float d_lr = fmaxf(0.0f, fmaxf(lt - r_mx, r_mn - lt));
        const float d_rl = fmaxf(0.0f, fmaxf(rs - l_mx, l_mn - rs));
        cost = cost + bt_weight * fminf(fminf(d_lr, d_rl), bt_clip);
      }
    }
    out_row[static_cast<size_t>(x) * n_disp + d] = store_cost<OutT>(cost, scale);
  }
}

template <typename OutT>
cudaError_t launch_generic(const float* left, const float* right, void* out, int h, int w,
                           int n_disp, int ph, int pw, int n_words, float bt_weight,
                           float bt_clip, float worst, float scale, cudaStream_t stream) {
  const int n_right = kGenericTile + n_disp - 1;
  const size_t smem = static_cast<size_t>(kGenericTile + n_right) * n_words * sizeof(uint64_t) +
                      static_cast<size_t>(3 * (kGenericTile + n_right)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cost_volume_generic_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((w + kGenericTile - 1) / kGenericTile, h);
  cost_volume_generic_kernel<OutT><<<grid, kGenericThreads, smem, stream>>>(
      left, right, static_cast<OutT*>(out), h, w, n_disp, ph, pw, n_words, bt_weight, bt_clip,
      worst, scale);
  return cudaGetLastError();
}

// ---- the tiled kernel --------------------------------------------------------

constexpr int kChunkMax = 128;  // bytes of a pixel's volume a warp writes out at once

// The shared-memory layout of one tile, as ops/cost_cuda._tile_plan computes
// it. Region 0 holds the staged rows (win_h rows of `left_cols` then
// `right_cols` floats, each part starting at a column that is a multiple of
// 4) until the codes are built, then the warps' out buffers (a warp's 32
// pixels x K runs); after it the census codes ([n_words][n_px] 64-bit words)
// and the BT triples ([3][n_px] floats) of the C left pixels, then the
// C + D - 1 right ones.
struct TileShape {
  int margin;      // m: staged columns each side of a pixel (>= 1 for BT)
  int lead_left;   // columns staged before x0 - m to start at a multiple of 4
  int lead_right;  // the same before x0 - (D - 1) - m
  int left_cols;   // staged columns of the left image, a multiple of 4
  int right_cols;  // staged columns of the right image, a multiple of 4
  int n_px;        // pixels with a code: C left, C + D - 1 right
  int run_bytes;   // a run's store: 16, or 8 where D * size is not a multiple of 16
  int chunk_runs;  // K: runs of a pixel a warp buffers before writing them out
  size_t codes_offset, bt_offset, smem_bytes;
};

__host__ __device__ inline int round_up4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline size_t larger(size_t a, size_t b) { return a > b ? a : b; }

__host__ __device__ inline TileShape tile_shape(int tile, int n_disp, int win_h, int win_w,
                                                int n_words, int out_bytes) {
  TileShape s;
  s.margin = win_w / 2 > 1 ? win_w / 2 : 1;
  s.lead_left = (4 - s.margin % 4) % 4;  // x0 is a multiple of 4
  s.lead_right = (4 - (n_disp - 1 + s.margin) % 4) % 4;
  s.left_cols = round_up4(s.lead_left + tile + 2 * s.margin);
  s.right_cols = round_up4(s.lead_right + tile + n_disp - 1 + 2 * s.margin);
  s.n_px = 2 * tile + n_disp - 1;
  const int row_bytes = n_disp * out_bytes;
  s.run_bytes = row_bytes % 16 == 0 ? 16 : 8;
  // a chunk: the widest power of two up to kChunkMax bytes dividing a
  // pixel's row (16-byte runs: K = 1, 2, 4 or 8), or the whole row when its
  // 8-byte runs make at most kChunkMax bytes (K odd)
  int chunk = s.run_bytes;
  if (s.run_bytes == 16) {
    while (chunk < kChunkMax && row_bytes % (2 * chunk) == 0) chunk *= 2;
  } else if (row_bytes <= kChunkMax) {
    chunk = row_bytes;
  }
  s.chunk_runs = chunk / s.run_bytes;
  const size_t stage = static_cast<size_t>(win_h) * (s.left_cols + s.right_cols) * sizeof(float);
  const size_t buffers = static_cast<size_t>(tile) * chunk;
  s.codes_offset = larger(stage, buffers);
  s.bt_offset = s.codes_offset + static_cast<size_t>(n_words) * s.n_px * sizeof(uint64_t);
  s.smem_bytes = s.bt_offset + static_cast<size_t>(3) * s.n_px * sizeof(float);
  return s;
}

// Float4 `item` of the staged rows: row r = item / (sw / 4) of the window,
// then 4 columns of the left span or of the right one, edge-clamped; a
// vector load where the four columns lie inside the row and the rows are
// 16-byte aligned.
__device__ __forceinline__ float4 staged_item(const float* __restrict__ left,
                                              const float* __restrict__ right, int h, int w,
                                              int y0, int row_items, int left_items,
                                              int xs_left, int xs_right, bool vec_ok,
                                              int item) {
  const int r = item / row_items;
  const int c = item - r * row_items;
  const bool is_left = c < left_items;
  const float* row = (is_left ? left : right) +
                     static_cast<size_t>(min(max(y0 + r, 0), h - 1)) * w;
  const int x = is_left ? xs_left + 4 * c : xs_right + 4 * (c - left_items);
  if (vec_ok && x >= 0 && x + 4 <= w) return __ldg(reinterpret_cast<const float4*>(row + x));
  return make_float4(__ldg(row + min(max(x, 0), w - 1)), __ldg(row + min(max(x + 1, 0), w - 1)),
                     __ldg(row + min(max(x + 2, 0), w - 1)),
                     __ldg(row + min(max(x + 3, 0), w - 1)));
}

// The census code of the staged pixel at column `col` of `part` (row stride
// `sw`), bit b row-major over the window with the centre skipped, written to
// word k at codes[k * n_px + idx]. WH, WW > 0: a window known at compile time.
template <int WH, int WW>
__device__ __forceinline__ void census_staged(const float* __restrict__ part, int sw, int col,
                                              int win_h, int win_w, uint64_t* codes, int n_px,
                                              int idx) {
  const int wh = WH > 0 ? WH : win_h, ww = WW > 0 ? WW : win_w;
  const int ph = wh / 2, pw = ww / 2;
  const float c = part[ph * sw + col];
  uint64_t cur = 0;
  int bit = 0;
#pragma unroll
  for (int dy = 0; dy < wh; ++dy) {
    const float* row = part + dy * sw + col - pw;
#pragma unroll
    for (int dx = 0; dx < ww; ++dx) {
      if (dy == ph && dx == pw) continue;
      if (row[dx] < c) cur |= 1ull << (bit & 63);
      if ((++bit & 63) == 0) {
        codes[((bit >> 6) - 1) * n_px + idx] = cur;
        cur = 0;
      }
    }
  }
  if (bit & 63) codes[(bit >> 6) * n_px + idx] = cur;
}

// V values of one run, packed into kRunBytes for one vector store
template <typename OutT, int kRunBytes>
struct Run {
  static constexpr int V = kRunBytes / sizeof(OutT);
  using Vec = typename std::conditional<kRunBytes == 16, uint4, uint2>::type;
  float cost[V];

  __device__ __forceinline__ Vec pack(float scale) const {
    uint32_t word[kRunBytes / 4];
    if constexpr (sizeof(OutT) == 4) {
#pragma unroll
      for (int k = 0; k < kRunBytes / 4; ++k) word[k] = __float_as_uint(cost[k]);
    } else if constexpr (sizeof(OutT) == 2) {
#pragma unroll
      for (int k = 0; k < kRunBytes / 4; ++k)
        word[k] = __byte_perm(__float2int_rn(cost[2 * k] * scale),
                              __float2int_rn(cost[2 * k + 1] * scale), 0x5410);
    } else {
#pragma unroll
      for (int k = 0; k < kRunBytes / 4; ++k) {
        const uint32_t lo = __byte_perm(__float2int_rn(cost[4 * k] * scale),
                                        __float2int_rn(cost[4 * k + 1] * scale), 0x0040);
        const uint32_t hi = __byte_perm(__float2int_rn(cost[4 * k + 2] * scale),
                                        __float2int_rn(cost[4 * k + 3] * scale), 0x0040);
        word[k] = __byte_perm(lo, hi, 0x5410);
      }
    }
    Vec v;
    if constexpr (kRunBytes == 16) {
      v.x = word[0], v.y = word[1], v.z = word[2], v.w = word[3];
    } else {
      v.x = word[0], v.y = word[1];
    }
    return v;
  }
};

// Where run q of the warp's pixel p sits in the warp's out buffer: K runs a
// pixel, the runs of a power-of-two K XOR-swizzled so that the 8 lanes of a
// 128-byte phase land on distinct banks when they write the same run of 8
// pixels; an odd K needs none (an odd stride).
__device__ __forceinline__ int buffer_slot(int p, int q, int k_runs) {
  const int swizzle = (k_runs & (k_runs - 1)) == 0 ? ((p * k_runs) >> 3) & (k_runs - 1) : 0;
  return p * k_runs + (q ^ swizzle);
}

// The warp's 32 pixels (lane i: pixel x0 + xl) over all D disparities: a
// run of V at a time, the left code and BT triple in registers, the right
// ones read at index C + xl + D - 1 - d of the shared arrays. K runs of each
// pixel go to the warp's out buffer, then leave it as 16- (8-) byte stores
// that cover whole chunks of each pixel's row, 32 pieces a store.
template <typename OutT, int kRunBytes, int NW, bool kFixed, bool kBt>
__device__ __forceinline__ void sweep_warp(const uint64_t* __restrict__ codes,
                                           const float* __restrict__ bt, int n_px, int n_words,
                                           int tile, int xl, int x, int w, int n_disp,
                                           int k_runs, float bt_weight, float bt_clip,
                                           float worst, float scale, void* warp_buffer,
                                           OutT* __restrict__ warp_out) {
  using R = Run<OutT, kRunBytes>;
  using Vec = typename R::Vec;
  Vec* buf = static_cast<Vec*>(warp_buffer);
  const int lane = xl & 31;
  uint64_t lw[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) lw[k] = (kFixed || k < n_words) ? codes[k * n_px + xl] : 0;
  float lt = 0.0f, l_mn = 0.0f, l_mx = 0.0f;
  if (kBt) lt = bt[xl], l_mn = bt[n_px + xl], l_mx = bt[2 * n_px + xl];
  const int j0 = tile + xl + n_disp - 1;  // right pixel x - 0
  // the write-out: piece lane + 32 i is run q of pixel p, stepped without a division
  const int p0 = lane / k_runs, q0 = lane - p0 * k_runs;
  const int dp = 32 / k_runs, dq = 32 - dp * k_runs;
  const int n_valid = min(32, w - (x - lane));  // the warp's pixels inside the row
  for (int c0 = 0; c0 < n_disp; c0 += k_runs * R::V) {
    for (int q = 0; q < k_runs; ++q) {
      const int d0 = c0 + q * R::V;
      R run;
#pragma unroll
      for (int v = 0; v < R::V; ++v) {
        const int j = j0 - d0 - v;
        int ham = 0;
#pragma unroll
        for (int k = 0; k < NW; ++k)
          if (kFixed || k < n_words) ham += __popcll(lw[k] ^ codes[k * n_px + j]);
        float cost = static_cast<float>(ham);
        if (kBt) {
          const float rs = bt[j], r_mn = bt[n_px + j], r_mx = bt[2 * n_px + j];
          const float d_lr = fmaxf(0.0f, fmaxf(lt - r_mx, r_mn - lt));
          const float d_rl = fmaxf(0.0f, fmaxf(rs - l_mx, l_mn - rs));
          cost = cost + bt_weight * fminf(fminf(d_lr, d_rl), bt_clip);
        }
        run.cost[v] = cost;
      }
      if (x < d0 + R::V - 1) {  // the row's first D pixels: candidates left of the image
#pragma unroll
        for (int v = 0; v < R::V; ++v)
          if (x < d0 + v) run.cost[v] = worst;
      }
      buf[buffer_slot(lane, q, k_runs)] = run.pack(scale);
    }
    __syncwarp();
    int p = p0, q = q0;
    for (int i = 0; i < k_runs; ++i) {
      if (p < n_valid)
        *reinterpret_cast<Vec*>(warp_out + static_cast<size_t>(p) * n_disp + c0 + q * R::V) =
            buf[buffer_slot(p, q, k_runs)];
      p += dp, q += dq;
      if (q >= k_runs) q -= k_runs, ++p;
    }
    __syncwarp();
  }
}

template <typename OutT, int kRunBytes, int WH, int WW>
__global__ void __launch_bounds__(256)
cost_volume_tiled_kernel(const float* __restrict__ left, const float* __restrict__ right,
                         OutT* __restrict__ out, int h, int w, int n_disp, int win_h, int win_w,
                         float bt_weight, float bt_clip, float worst, float scale) {
  constexpr bool kFixed = WH > 0;
  constexpr int NW = kFixed ? (WH * WW - 1 + 63) / 64 : kMaxWords;
  extern __shared__ float4 tile_smem[];
  const int tile = blockDim.x;
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * tile;
  const int n_words = kFixed ? NW : (win_h * win_w - 1 + 63) / 64;
  const TileShape s = tile_shape(tile, n_disp, win_h, win_w, n_words, sizeof(OutT));
  const int sw = s.left_cols + s.right_cols;
  float* stage = reinterpret_cast<float*>(tile_smem);
  auto* smem_bytes = reinterpret_cast<unsigned char*>(tile_smem);
  uint64_t* codes = reinterpret_cast<uint64_t*>(smem_bytes + s.codes_offset);
  float* bt = reinterpret_cast<float*>(smem_bytes + s.bt_offset);
  const bool use_bt = bt_weight > 0.0f;
  const int ph = win_h / 2;
  const int xs_left = x0 - s.margin - s.lead_left;
  const int xs_right = x0 - (n_disp - 1) - s.margin - s.lead_right;

  // 1. the window's rows, edge-clamped, a float4 a thread at a time
  const bool vec_ok = (w % 4 == 0) &&
      ((reinterpret_cast<uintptr_t>(left) | reinterpret_cast<uintptr_t>(right)) % 16 == 0);
  const int row_items = sw / 4, left_items = s.left_cols / 4;
  const int n_items = win_h * row_items;
  for (int item = threadIdx.x; item < n_items; item += tile)
    tile_smem[item] = staged_item(left, right, h, w, y - ph, row_items, left_items, xs_left,
                                  xs_right, vec_ok, item);
  __syncthreads();  // the rows are staged

  // 2. each pixel's census code and BT triple, once
  for (int i = threadIdx.x; i < s.n_px; i += tile) {
    const bool is_left = i < tile;
    const int x = is_left ? x0 + i : x0 - (n_disp - 1) + (i - tile);
    if (x < 0 || x >= w) continue;
    const float* part = is_left ? stage : stage + s.left_cols;
    const int col = x - (is_left ? xs_left : xs_right);
    census_staged<WH, WW>(part, sw, col, win_h, win_w, codes, s.n_px, i);
    if (use_bt) {
      const float* row = part + ph * sw;
      const float* img = (is_left ? left : right) + static_cast<size_t>(y) * w;
      const float c = row[col];
      const float lh = 0.5f * (c + (x == 0 ? img[w - 1] : row[col - 1]));  // BT wraps
      const float rh = 0.5f * (c + (x == w - 1 ? img[0] : row[col + 1]));
      bt[i] = c;
      bt[s.n_px + i] = fminf(fminf(lh, rh), c);
      bt[2 * s.n_px + i] = fmaxf(fmaxf(lh, rh), c);
    }
  }
  __syncthreads();  // the codes are built

  // 3. the sweep: a warp owns 32 consecutive pixels, lane i pixel x0 + xl
  const int xl = threadIdx.x;
  const int x = x0 + xl;
  const int warp_x0 = x - (xl & 31);
  if (warp_x0 >= w) return;  // the whole warp is past the row's end
  void* warp_buffer = smem_bytes + static_cast<size_t>(xl & ~31) * s.chunk_runs * s.run_bytes;
  OutT* warp_out = out + (static_cast<size_t>(y) * w + warp_x0) * n_disp;
  if (use_bt)
    sweep_warp<OutT, kRunBytes, NW, kFixed, true>(codes, bt, s.n_px, n_words, tile, xl, x, w,
                                                  n_disp, s.chunk_runs, bt_weight, bt_clip,
                                                  worst, scale, warp_buffer, warp_out);
  else
    sweep_warp<OutT, kRunBytes, NW, kFixed, false>(codes, bt, s.n_px, n_words, tile, xl, x, w,
                                                   n_disp, s.chunk_runs, bt_weight, bt_clip,
                                                   worst, scale, warp_buffer, warp_out);
}

// Lets a tiled instantiation take up to kMaxSmem of dynamic shared memory on
// the current device: set once a device.
template <typename OutT, int kRunBytes, int WH, int WW>
cudaError_t allow_tiled_smem() {
  static uint64_t raised = 0;  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && ((raised >> dev) & 1)) return cudaSuccess;
  err = cudaFuncSetAttribute(cost_volume_tiled_kernel<OutT, kRunBytes, WH, WW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
  if (err == cudaSuccess && dev < 64) raised |= uint64_t{1} << dev;
  return err;
}

template <typename OutT, int kRunBytes, int WH, int WW>
cudaError_t launch_tiled_window(const float* left, const float* right, void* out, int h, int w,
                                int n_disp, int win_h, int win_w, float bt_weight, float bt_clip,
                                float worst, float scale, int tile, size_t smem,
                                cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_tiled_smem<OutT, kRunBytes, WH, WW>();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((w + tile - 1) / tile, h);
  cost_volume_tiled_kernel<OutT, kRunBytes, WH, WW><<<grid, tile, smem, stream>>>(
      left, right, static_cast<OutT*>(out), h, w, n_disp, win_h, win_w, bt_weight, bt_clip,
      worst, scale);
  return cudaGetLastError();
}

// the census windows of the main paths run unrolled (7x9 the two-view one,
// 5x7 the two-view cascade's coarse pass); any other at run time
template <typename OutT, int kRunBytes>
cudaError_t launch_tiled(const float* left, const float* right, void* out, int h, int w,
                         int n_disp, int win_h, int win_w, float bt_weight, float bt_clip,
                         float worst, float scale, int tile, size_t smem, cudaStream_t stream) {
  if (win_h == 7 && win_w == 9)
    return launch_tiled_window<OutT, kRunBytes, 7, 9>(left, right, out, h, w, n_disp, win_h,
                                                       win_w, bt_weight, bt_clip, worst, scale,
                                                       tile, smem, stream);
  if (win_h == 5 && win_w == 7)
    return launch_tiled_window<OutT, kRunBytes, 5, 7>(left, right, out, h, w, n_disp, win_h,
                                                       win_w, bt_weight, bt_clip, worst, scale,
                                                       tile, smem, stream);
  return launch_tiled_window<OutT, kRunBytes, 0, 0>(left, right, out, h, w, n_disp, win_h, win_w,
                                                     bt_weight, bt_clip, worst, scale, tile, smem,
                                                     stream);
}

template <typename OutT>
cudaError_t launch(const float* left, const float* right, void* out, int h, int w, int n_disp,
                   int win_h, int win_w, int n_words, float bt_weight, float bt_clip, float worst,
                   float scale, int tile, cudaStream_t stream) {
  if (tile == 0)
    return launch_generic<OutT>(left, right, out, h, w, n_disp, win_h / 2, win_w / 2, n_words,
                                bt_weight, bt_clip, worst, scale, stream);
  const int row_bytes = n_disp * static_cast<int>(sizeof(OutT));
  const int run_bytes = row_bytes % 16 == 0 ? 16 : 8;
  const size_t smem =
      tile_shape(tile, n_disp, win_h, win_w, n_words, sizeof(OutT)).smem_bytes;
  if ((tile != 64 && tile != 128 && tile != 256) || row_bytes % 8 != 0 || smem > kMaxSmem ||
      reinterpret_cast<uintptr_t>(out) % run_bytes != 0)
    return cudaErrorInvalidValue;
  if (run_bytes == 16)
    return launch_tiled<OutT, 16>(left, right, out, h, w, n_disp, win_h, win_w, bt_weight,
                                  bt_clip, worst, scale, tile, smem, stream);
  return launch_tiled<OutT, 8>(left, right, out, h, w, n_disp, win_h, win_w, bt_weight, bt_clip,
                               worst, scale, tile, smem, stream);
}

}  // namespace

SVT_API const char* svt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// left/right: (H, W) float32; out: (H, W, D) int8 (out_bytes 1), int16 (2)
// or float32 (4, stored unscaled). tile: C (64, 128 or 256) for the tiled
// kernel, as ops/cost_cuda._tile_plan gives it; 0 for the generic form.
SVT_API int svt_cost_volume(const void* left, const void* right, void* out, int out_bytes,
                            int h, int w, int n_disp, int win_h, int win_w, float bt_weight,
                            float bt_clip, float worst, float scale, int tile, void* stream) {
  const int n_words = (win_h * win_w - 1 + 63) / 64;
  if (h <= 0 || w <= 0 || n_disp <= 0 || win_h % 2 == 0 || win_w % 2 == 0 ||
      n_words > kMaxWords || (out_bytes != 1 && out_bytes != 2 && out_bytes != 4))
    return cudaErrorInvalidValue;
  const auto* l = static_cast<const float*>(left);
  const auto* r = static_cast<const float*>(right);
  auto s = static_cast<cudaStream_t>(stream);
  if (out_bytes == 1)
    return launch<int8_t>(l, r, out, h, w, n_disp, win_h, win_w, n_words, bt_weight, bt_clip,
                          worst, scale, tile, s);
  if (out_bytes == 4)
    return launch<float>(l, r, out, h, w, n_disp, win_h, win_w, n_words, bt_weight, bt_clip,
                         worst, scale, tile, s);
  return launch<int16_t>(l, r, out, h, w, n_disp, win_h, win_w, n_words, bt_weight, bt_clip,
                         worst, scale, tile, s);
}
