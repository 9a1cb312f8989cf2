// K4: disparity extraction maps from the aggregated SGM total, and
// K5: the left-right gather on (H, W) maps.
//
// K4 replaces the extraction half of
// stereovisionarray_tpu/ops/sgm_pallas.py::_rl_extract_kernel (via
// _rl_extract_wdh), whose math is extract_pallas.py::extract_row_maps /
// _wta_row / _subpixel. The TPU fused it into the last horizontal sweep and
// built the right view as a streaming anti-diagonal reduction, to avoid lane
// barrels; the reference's own tests prove that fusion bit-identical to
// extracting from the finished total, so here extraction reads the total.
// One thread per pixel emits five maps: left subpixel disparity, winning cost,
// uniqueness validity, second-best cost outside winner±1 (PKRN) and the
// right-view subpixel disparity, whose candidates are total[y, x + d, d]
// (BIG = 16000 past the right border). WTA ties go to the smallest d (the
// reference packs cost << lg | d); the parabola is float32 with an IEEE
// division, applied where 1 <= d <= D - 2 and clipped to ±0.5.
//
// K5 replaces stereovisionarray_tpu/ops/extract_pallas.py::_lr_check_kernel
// (via lr_gather_maps), which built d_R(x - d) for every d with a barrel and
// reduced it with a one-hot: here it is one gather per pixel,
// at = d_R(x - clip(rint(d_L), 0, D - 1)), 1e9 where that column is < 0.
//
// What bounds them on the H100: K4 reads the total twice per view (WTA, then
// second best / neighbours), 2 * 2 * H*W*D int16 = 212 MB at 540x768x64, with
// a thread's D values contiguous but neighbouring threads D * 2 bytes apart,
// so the reads go through L1 lines rather than coalesced transactions; it is
// bound by memory traffic through the cache. K5 moves 3 * H*W floats (~5 MB):
// it is launch-latency bound.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

// reference: extract_pallas.py::_subpixel
__device__ __forceinline__ float subpixel(int d_int, int n_disp, int cm, int c0, int cp) {
  const int d_c = min(max(d_int, 1), n_disp - 2);
  const float fm = static_cast<float>(cm), f0 = static_cast<float>(c0);
  const float fp = static_cast<float>(cp);
  const float denom = fm - 2.0f * f0 + fp;
  const bool nonflat = fabsf(denom) > 1e-9f;
  float delta = nonflat ? (fm - fp) / (2.0f * denom) : 0.0f;
  delta = fminf(fmaxf(delta, -0.5f), 0.5f);
  return (d_int >= 1 && d_int <= n_disp - 2) ? static_cast<float>(d_c) + delta
                                             : static_cast<float>(d_int);
}

__global__ void __launch_bounds__(kThreads)
extract_maps_kernel(const int16_t* __restrict__ total, int h, int w, int n_disp, int use_subpixel,
                    float uniqueness, float* __restrict__ disp_l, float* __restrict__ cost_out,
                    bool* __restrict__ valid, float* __restrict__ second_out,
                    float* __restrict__ disp_r) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const size_t pix = static_cast<size_t>(y) * w + x;
  const int16_t* a = total + pix * n_disp;
  // right view: candidate d of right pixel x is total[y, x + d, d]
  const int16_t* ar = a;  // + d * (n_disp + 1) for candidate d
  const int n_right = min(n_disp, w - x);  // candidates inside the image

  int best = INT_MAX, bd = 0, rbest = INT_MAX, rbd = 0;
  for (int d = 0; d < n_disp; ++d) {
    const int v = a[d];
    if (v < best) { best = v; bd = d; }
    const int r = d < n_right ? ar[d * (n_disp + 1)] : svt::kBigInt;
    if (r < rbest) { rbest = r; rbd = d; }
  }
  int second = svt::kBigInt;
  for (int d = 0; d < n_disp; ++d)
    if (abs(d - bd) > 1) second = min(second, static_cast<int>(a[d]));

  const int dc = min(max(bd, 1), n_disp - 2);
  const int rdc = min(max(rbd, 1), n_disp - 2);
  auto right_at = [&](int d) {
    return d < n_right ? static_cast<int>(ar[d * (n_disp + 1)]) : svt::kBigInt;
  };
  const float cost = static_cast<float>(best);
  const float sec = static_cast<float>(second);
  disp_l[pix] = use_subpixel ? subpixel(bd, n_disp, a[dc - 1], best, a[dc + 1])
                             : static_cast<float>(bd);
  disp_r[pix] = use_subpixel ? subpixel(rbd, n_disp, right_at(rdc - 1), rbest, right_at(rdc + 1))
                             : static_cast<float>(rbd);
  cost_out[pix] = cost;
  second_out[pix] = sec;
  valid[pix] = uniqueness > 0.0f ? cost < uniqueness * sec : true;
}

__global__ void __launch_bounds__(kThreads)
lr_gather_kernel(const float* __restrict__ disp_l, const float* __restrict__ disp_r,
                 float* __restrict__ at, int h, int w, int n_disp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const size_t pix = static_cast<size_t>(y) * w + x;
  const int d = min(max(__float2int_rn(disp_l[pix]), 0), n_disp - 1);
  const int src = x - d;
  at[pix] = src >= 0 ? disp_r[pix - d] : svt::kBigFloat;
}

}  // namespace

// total: (H, W, D) int16; outputs (H, W): disp_l, cost, second, disp_r f32,
// valid bool. uniqueness <= 0 disables the ratio test.
SVT_API int svt_extract_maps(const void* total, int h, int w, int n_disp, int use_subpixel,
                             float uniqueness, void* disp_l, void* cost, void* valid,
                             void* second, void* disp_r, void* stream) {
  if (h <= 0 || w <= 0 || n_disp < 3) return cudaErrorInvalidValue;
  const dim3 grid((w + kThreads - 1) / kThreads, h);
  extract_maps_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(total), h, w, n_disp, use_subpixel, uniqueness,
      static_cast<float*>(disp_l), static_cast<float*>(cost), static_cast<bool*>(valid),
      static_cast<float*>(second), static_cast<float*>(disp_r));
  return cudaGetLastError();
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
