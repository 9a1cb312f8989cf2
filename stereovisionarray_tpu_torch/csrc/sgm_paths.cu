// K2/K3: the integer SGM path scans, all 4 or 8 paths in one launch.
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
  // first pixel of the line
  const int y_edge = dy > 0 ? 0 : h - 1;
  const int x_edge = dx > 0 ? 0 : w - 1;
  int y, x;
  if (dx == 0) {
    y = y_edge; x = line;
  } else if (dy == 0) {
    y = line; x = x_edge;
  } else if (line < w) {
    y = y_edge; x = line;
  } else {
    y = y_edge + dy * (line - w + 1); x = x_edge;
  }

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

}  // namespace

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
