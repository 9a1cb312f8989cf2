// K2/K3: the integer SGM path scans, all 4 or 8 paths in one launch.
// K7 (float costs): the same scans in float32, each path into a partial of
// its own, then an ordered combine (see "Float aggregation" below).
//
// Replaces stereovisionarray_tpu/ops/sgm_pallas.py::_sweep_kernel_hdw_stacked
// (via _sweep_hdw_stacked: the vertical path group, axis path + both
// diagonals, down or up), ::_sweep_kernel_hdw (via _sweep_hdw: one
// horizontal sweep, or a vertical one with 4 paths) and the sweep half of
// ::_rl_extract_kernel. On the TPU the grid ran in order, so a (3D, N) carry
// in VMEM relayed each row to the next, diagonals shifted that carry by a lane
// roll, and the horizontal sweeps needed a transposed (W, D, H) twin volume.
//
// Here every path is what it is mathematically: a set of independent 1-D
// lines (W columns for the vertical paths, H rows for the horizontal ones,
// H + W - 1 lines for each diagonal). One warp owns one line and walks it;
// the D costs of a pixel lie across the lanes (K = ceil(D / 32) values a
// lane, contiguous in d), so
//   min_d' L(p - r, d')  is a register min + a __shfl_xor_sync butterfly,
//   L(p - r, d -/+ 1)    is a register neighbour or __shfl_up/down_sync,
// with the reference's BIG = 16000 at d = -1 and d = D. A line's first pixel
// starts fresh with L = C, which is exactly what the reference's BIG-filled
// shifted carry and first-row 3*C produce. P2 is the map value at the pixel
// being updated: p2_y on vertical and diagonal paths, p2_x on horizontal ones.
// All arithmetic is int32; each path adds its L into an int32 total with
// atomicAdd (integer sums, so the order of the adds does not matter; the
// caller narrows the total to the int16 storage dtype, which wraps exactly as
// the reference's int16 partial sums do).
//
// What bounds it on the H100: each step of a line depends on the previous
// one, so a warp spends most of a step waiting for its cost load and the
// shuffles; the work is latency-bound, hidden only by the number of lines in
// flight (~7,800 warps at 540x768 with 8 paths, about one full H100 of
// resident warps). Bytes are small: D costs read and D atomic adds per pixel
// and path, ~1.1 GB at 540x768x64 int8 with 8 paths.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// path id -> step (dy, dx); ids as in the reference's ops/sgm.py:
// 0 down, 1 up, 2 left->right, 3 right->left, 4 down-right, 5 down-left,
// 6 up-right, 7 up-left
__constant__ int kDy[8] = {1, -1, 0, 0, 1, 1, -1, -1};
__constant__ int kDx[8] = {0, 0, 1, -1, 1, -1, 1, -1};

__device__ __forceinline__ int num_lines(int path, int h, int w) {
  if (kDx[path] == 0) return w;
  if (kDy[path] == 0) return h;
  return h + w - 1;
}

// first pixel (y, x) of line `line` of path `path`
__device__ __forceinline__ void line_start(int path, int line, int h, int w, int* y, int* x) {
  const int dy = kDy[path], dx = kDx[path];
  const int y_edge = dy > 0 ? 0 : h - 1;
  const int x_edge = dx > 0 ? 0 : w - 1;
  if (dx == 0) {
    *y = y_edge; *x = line;
  } else if (dy == 0) {
    *y = line; *x = x_edge;
  } else if (line < w) {
    *y = y_edge; *x = line;
  } else {
    *y = y_edge + dy * (line - w + 1); *x = x_edge;
  }
}

template <int K, typename CostT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sgm_paths_kernel(const CostT* __restrict__ cost, const int16_t* __restrict__ p2_y,
                 const int16_t* __restrict__ p2_x, int* __restrict__ total, int h, int w,
                 int n_disp, int p1, int num_paths) {
  const int lane = threadIdx.x & 31;
  int line = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  int path = 0;
  for (; path < num_paths; ++path) {
    const int n = num_lines(path, h, w);
    if (line < n) break;
    line -= n;
  }
  if (path == num_paths) return;  // whole warp: past the last line

  const int dy = kDy[path], dx = kDx[path];
  const int16_t* p2_map = dy != 0 ? p2_y : p2_x;
  int y, x;
  line_start(path, line, h, w, &y, &x);

  int prev[K];
  bool first = true;
  for (; y >= 0 && y < h && x >= 0 && x < w; y += dy, x += dx) {
    const size_t pix = static_cast<size_t>(y) * w + x;
    const CostT* c = cost + pix * n_disp;
    int cur[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane * K + k;
      cur[k] = d < n_disp ? static_cast<int>(c[d]) : 0;
    }
    if (!first) {
      int m = INT_MAX;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (lane * K + k < n_disp) m = min(m, prev[k]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = min(m, __shfl_xor_sync(kFull, m, off));
      const int below = __shfl_up_sync(kFull, prev[K - 1], 1);  // d = lane*K - 1
      const int above = __shfl_down_sync(kFull, prev[0], 1);    // d = lane*K + K
      const int jump = m + static_cast<int>(p2_map[pix]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = lane * K + k;
        const int lo = d == 0 ? svt::kBigInt : (k > 0 ? prev[k - 1] : below);
        const int hi = d == n_disp - 1 ? svt::kBigInt : (k < K - 1 ? prev[k + 1] : above);
        const int best = min(min(prev[k], jump), min(lo, hi) + p1);
        cur[k] += best - m;
      }
    }
    int* t = total + pix * n_disp;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane * K + k;
      if (d < n_disp) atomicAdd(t + d, cur[k]);
      prev[k] = cur[k];
    }
    first = false;
  }
}

template <int K>
cudaError_t launch_k(const void* cost, int cost_bytes, const int16_t* p2_y, const int16_t* p2_x,
                     int* total, int h, int w, int n_disp, int p1, int num_paths,
                     cudaStream_t stream) {
  const int lines = 2 * w + 2 * h + (num_paths == 8 ? 4 * (h + w - 1) : 0);
  const int blocks = (lines + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (cost_bytes == 1)
    sgm_paths_kernel<K, int8_t><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        static_cast<const int8_t*>(cost), p2_y, p2_x, total, h, w, n_disp, p1, num_paths);
  else
    sgm_paths_kernel<K, int16_t><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        static_cast<const int16_t*>(cost), p2_y, p2_x, total, h, w, n_disp, p1, num_paths);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Float aggregation (K7; replaces the float use of the sweep kernels through
// stereovisionarray_tpu/ops/sgm_pallas.py::sgm_aggregate_pallas_sweeps /
// sgm_aggregate_pallas_hdw, and serves the twins of sgm_aggregate_pallas,
// _sweep_hdw_bidir and sgm_extract_fused_hdw/_wdh).
//
// Float sums are not associative, and every reference route sums the paths
// in its own order, so the integer design (atomicAdd of each path into one
// total) cannot serve them: float atomics land in a different order on every
// run. Here sgm_paths_f32_kernel runs the same warp-per-line scans in
// float32, with the reference's float recurrence evaluated in its order,
//   L = C + (min(prev, m + P2, min(lo, hi) + P1) - m),  m = min_d' prev,
// BIG = 1e9 at d = -1 and d = D, and writes each path into a partial of its
// own (one writer per element, nothing atomic). sgm_combine_f32_kernel then
// sums the partials per element in the route's order, with a fused
// multiply-add (__fmaf_rn; the library is built with -fmad=false, so nothing
// else contracts) where the reference's compiled kernel contracts
// `acc + 3 * row`:
//   k7, k10: (down + up) + (lr + rl)   (k7: y = H-1 of down + up fused)
//   wdh:     ((down + up) + lr) + rl   (y = H-1 of down + up fused)
//   k12:     ((lr + rl) + down) + up   (y = 0 and y = H-1 fused)
// where a sweep's group is (axis + diag+1) + diag-1 and fusing happens with 8
// paths only (4 paths add 1 * row, which is exact either way).
//
// What bounds it on the H100: the scans as the integer kernel (latency of
// the serial steps), plus memory: 8 partials of H*W*D floats are written and
// read back once, 2 * 8 * 106 MB at 540x768x64, about 0.5 ms of HBM time
// against the 212 MB (0.06 ms) that reading the costs and writing the sum
// need. Memory for the partials is P * H*W*D * 4 bytes (3.4 GB at
// 540x768x256 with 8 paths); a fused design keeping the groups in registers
// is later work.

template <int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sgm_paths_f32_kernel(const float* __restrict__ cost, const float* __restrict__ p2_y,
                     const float* __restrict__ p2_x, float* __restrict__ partial, int h, int w,
                     int n_disp, float p1, int path_mask) {
  const int lane = threadIdx.x & 31;
  int line = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  int path = 0, slot = 0;
  for (; path < 8; ++path) {
    if (!((path_mask >> path) & 1)) continue;
    const int n = num_lines(path, h, w);
    if (line < n) break;
    line -= n;
    ++slot;
  }
  if (path == 8) return;  // whole warp: past the last line

  const int dy = kDy[path], dx = kDx[path];
  const float* p2_map = dy != 0 ? p2_y : p2_x;
  float* out = partial + static_cast<size_t>(slot) * h * w * n_disp;
  int y, x;
  line_start(path, line, h, w, &y, &x);

  float prev[K];
  bool first = true;
  for (; y >= 0 && y < h && x >= 0 && x < w; y += dy, x += dx) {
    const size_t pix = static_cast<size_t>(y) * w + x;
    const float* c = cost + pix * n_disp;
    float cur[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane * K + k;
      cur[k] = d < n_disp ? c[d] : 0.0f;
    }
    if (!first) {
      float m = __int_as_float(0x7f800000);  // +inf
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (lane * K + k < n_disp) m = fminf(m, prev[k]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(kFull, m, off));
      const float below = __shfl_up_sync(kFull, prev[K - 1], 1);  // d = lane*K - 1
      const float above = __shfl_down_sync(kFull, prev[0], 1);    // d = lane*K + K
      const float jump = m + p2_map[pix];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = lane * K + k;
        const float lo = d == 0 ? svt::kBigFloat : (k > 0 ? prev[k - 1] : below);
        const float hi = d == n_disp - 1 ? svt::kBigFloat : (k < K - 1 ? prev[k + 1] : above);
        const float best = fminf(fminf(prev[k], jump), fminf(lo, hi) + p1);
        cur[k] = cur[k] + (best - m);
      }
    }
    float* o = out + pix * n_disp;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane * K + k;
      if (d < n_disp) o[d] = cur[k];
      prev[k] = cur[k];
    }
    first = false;
  }
}

enum Order { kOrderK7 = 0, kOrderWdh = 1, kOrderK10 = 2, kOrderK12 = 3 };
enum Sweep { kDown = 1, kUp = 2, kLr = 4, kRl = 8 };

struct Slots {
  int of[8];  // partial slot of each path id, -1 when the path was not scanned
};

__global__ void __launch_bounds__(256)
sgm_combine_f32_kernel(const float* __restrict__ partial, float* __restrict__ out, int h, int w,
                       int n_disp, Slots slots, int sweep_mask, int diagonals, int order) {
  const size_t n = static_cast<size_t>(h) * w * n_disp;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int y = static_cast<int>(i / (static_cast<size_t>(w) * n_disp));
  auto P = [&](int pid) { return partial[static_cast<size_t>(slots.of[pid]) * n + i]; };
  // a sweep's group: (axis + diag+1) + diag-1
  auto down = [&]() { return diagonals ? (P(0) + P(4)) + P(5) : P(0); };
  auto up = [&]() { return diagonals ? (P(1) + P(6)) + P(7) : P(1); };
  // the first row of a fused group is L = C on each of its three paths
  const bool fused = diagonals && order != kOrderK10;
  float total;
  if (order == kOrderK12) {
    const float horiz = P(2) + P(3);
    const float acc = fused && y == 0 ? __fmaf_rn(3.0f, P(0), horiz) : horiz + down();
    total = fused && y == h - 1 ? __fmaf_rn(3.0f, P(1), acc) : acc + up();
  } else {
    const bool has_v = sweep_mask & (kDown | kUp), has_h = sweep_mask & (kLr | kRl);
    float vert = 0.0f, horiz = 0.0f;
    if ((sweep_mask & (kDown | kUp)) == (kDown | kUp)) {
      const float dn = down();
      vert = fused && y == h - 1 ? __fmaf_rn(3.0f, P(1), dn) : dn + up();
    } else if (sweep_mask & kDown) {
      vert = down();
    } else if (sweep_mask & kUp) {
      vert = up();
    }
    if (order == kOrderWdh) {
      total = (vert + P(2)) + P(3);
    } else {
      if ((sweep_mask & (kLr | kRl)) == (kLr | kRl))
        horiz = P(2) + P(3);
      else if (sweep_mask & kLr)
        horiz = P(2);
      else if (sweep_mask & kRl)
        horiz = P(3);
      total = has_v && has_h ? vert + horiz : (has_v ? vert : horiz);
    }
  }
  out[i] = total;
}

template <int K>
cudaError_t launch_f32(const float* cost, const float* p2_y, const float* p2_x, float* partial,
                       int h, int w, int n_disp, float p1, int path_mask, cudaStream_t stream) {
  int lines = 0;
  for (int p = 0; p < 8; ++p) {
    if (!((path_mask >> p) & 1)) continue;
    lines += p == 0 || p == 1 ? w : (p == 2 || p == 3 ? h : h + w - 1);
  }
  const int blocks = (lines + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sgm_paths_f32_kernel<K><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      cost, p2_y, p2_x, partial, h, w, n_disp, p1, path_mask);
  return cudaGetLastError();
}

}  // namespace

// cost: (H, W, D) float32; p2_y/p2_x: (H, W) float32; partial: (P, H, W, D)
// float32 with P = the number of bits set in path_mask (bit p: path id p);
// receives each selected path's L in ascending path id.
SVT_API int svt_sgm_paths_f32(const void* cost, const void* p2_y, const void* p2_x,
                              void* partial, int h, int w, int n_disp, float p1, int path_mask,
                              void* stream) {
  if (h <= 0 || w <= 0 || n_disp < 1 || n_disp > 256 || path_mask <= 0 || path_mask > 255)
    return cudaErrorInvalidValue;
  const auto* c = static_cast<const float*>(cost);
  const auto* py = static_cast<const float*>(p2_y);
  const auto* px = static_cast<const float*>(p2_x);
  auto* out = static_cast<float*>(partial);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_disp <= 32) return launch_f32<1>(c, py, px, out, h, w, n_disp, p1, path_mask, s);
  if (n_disp <= 64) return launch_f32<2>(c, py, px, out, h, w, n_disp, p1, path_mask, s);
  if (n_disp <= 128) return launch_f32<4>(c, py, px, out, h, w, n_disp, p1, path_mask, s);
  return launch_f32<8>(c, py, px, out, h, w, n_disp, p1, path_mask, s);
}

// partial: the (P, H, W, D) float32 output of svt_sgm_paths_f32 over the
// paths of `path_mask`; out: (H, W, D) float32, the sum over the sweeps of
// `sweep_mask` (1 down, 2 up, 4 left->right, 8 right->left) with 4 or 8
// paths in `order` (0 k7, 1 wdh, 2 k10, 3 k12; wdh, k10 and k12 take all
// four sweeps). Every path the sweeps need must be in path_mask.
SVT_API int svt_sgm_combine_f32(const void* partial, void* out, int h, int w, int n_disp,
                                int path_mask, int num_paths, int sweep_mask, int order,
                                void* stream) {
  if (h <= 0 || w <= 0 || n_disp < 1 || (num_paths != 4 && num_paths != 8) || sweep_mask <= 0 ||
      sweep_mask > 15 || order < kOrderK7 || order > kOrderK12 ||
      (order != kOrderK7 && sweep_mask != 15))
    return cudaErrorInvalidValue;
  // sweep -> path ids, as the reference's SWEEP_PATHS_8 / SWEEP_PATHS_4
  const int groups8[4] = {(1 << 0) | (1 << 4) | (1 << 5), (1 << 1) | (1 << 6) | (1 << 7),
                          1 << 2, 1 << 3};
  int needed = 0;
  for (int s = 0; s < 4; ++s)
    if ((sweep_mask >> s) & 1) needed |= num_paths == 8 ? groups8[s] : 1 << s;
  if ((needed & path_mask) != needed) return cudaErrorInvalidValue;
  Slots slots;
  for (int p = 0, slot = 0; p < 8; ++p) slots.of[p] = ((path_mask >> p) & 1) ? slot++ : -1;
  const size_t n = static_cast<size_t>(h) * w * n_disp;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  sgm_combine_f32_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), h, w, n_disp, slots,
      sweep_mask, num_paths == 8, order);
  return cudaGetLastError();
}

// cost: (H, W, D) int8 (cost_bytes 1) or int16 (2); p2_y/p2_x: (H, W) int16;
// total32: (H, W, D) int32, zero on entry, receives the sum over the paths.
SVT_API int svt_sgm_paths(const void* cost, int cost_bytes, const void* p2_y, const void* p2_x,
                          void* total32, int h, int w, int n_disp, int p1, int num_paths,
                          void* stream) {
  if (h <= 0 || w <= 0 || n_disp < 1 || n_disp > 256 || (num_paths != 4 && num_paths != 8) ||
      (cost_bytes != 1 && cost_bytes != 2))
    return cudaErrorInvalidValue;
  const auto* py = static_cast<const int16_t*>(p2_y);
  const auto* px = static_cast<const int16_t*>(p2_x);
  auto* t = static_cast<int*>(total32);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_disp <= 32) return launch_k<1>(cost, cost_bytes, py, px, t, h, w, n_disp, p1, num_paths, s);
  if (n_disp <= 64) return launch_k<2>(cost, cost_bytes, py, px, t, h, w, n_disp, p1, num_paths, s);
  if (n_disp <= 128) return launch_k<4>(cost, cost_bytes, py, px, t, h, w, n_disp, p1, num_paths, s);
  return launch_k<8>(cost, cost_bytes, py, px, t, h, w, n_disp, p1, num_paths, s);
}
