// K4: disparity extraction maps from the aggregated SGM total,
// K5: the left-right gather on (H, W) maps, and
// K6: standalone extraction over an int8, int16 or float32 volume.
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
// K6 replaces stereovisionarray_tpu/ops/extract_pallas.py::_extract_kernel
// (via extract_maps_hdw / extract_disparity_hdw), the same extract_row_maps
// math over any aggregated or raw volume, with the LR check done in-volume by
// barrel shifts. Here it is the K4 kernel templated on the volume type: int8
// widens to int before anything (the reference widens to int16 before its
// BIG fill), integer volumes use BIG = 16000, float32 volumes compare and
// fill in float with BIG = 1e9 and keep the smallest d on ties. Without an LR
// check the right view is skipped (disp_r == nullptr). With one, K5's gather
// (the reference's in-volume one-hot select of d_R(x - d) at d = round(d_L))
// also applies |d_L - at| <= lr_max_diff & at < BIG to the validity in place.
//
// What bounds them on the H100: K4 reads the total twice per view (WTA, then
// second best / neighbours), 2 * 2 * H*W*D int16 = 212 MB at 540x768x64, with
// a thread's D values contiguous but neighbouring threads D * 2 bytes apart,
// so the reads go through L1 lines rather than coalesced transactions; it is
// bound by memory traffic through the cache. K5 moves 3 * H*W floats (~5 MB):
// it is launch-latency bound. K6 on a float32 volume reads twice the bytes of
// K4 on int16.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
extract_maps_kernel(const T* __restrict__ total, int h, int w, int n_disp, int use_subpixel,
                    float uniqueness, float* __restrict__ disp_l, float* __restrict__ cost_out,
                    bool* __restrict__ valid, float* __restrict__ second_out,
                    float* __restrict__ disp_r) {
  using C = typename Extract<T>::type;
  constexpr C kBig = Extract<T>::big;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const size_t pix = static_cast<size_t>(y) * w + x;
  const T* a = total + pix * n_disp;
  // right view: candidate d of right pixel x is total[y, x + d, d]
  const T* ar = a;  // + d * (n_disp + 1) for candidate d
  const int n_right = min(n_disp, w - x);  // candidates inside the image, >= 1
  const bool right = disp_r != nullptr;  // uniform over the launch

  // d = 0 is every view's first candidate (the right view's is a[0] itself);
  // strict < keeps the smallest d on ties
  C best = static_cast<C>(a[0]), rbest = best;
  int bd = 0, rbd = 0;
  for (int d = 1; d < n_disp; ++d) {
    const C v = static_cast<C>(a[d]);
    if (v < best) { best = v; bd = d; }
    if (right) {
      const C r = d < n_right ? static_cast<C>(ar[d * (n_disp + 1)]) : kBig;
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
  if (right) {
    const int rdc = min(max(rbd, 1), n_disp - 2);
    auto right_at = [&](int d) {
      return static_cast<float>(d < n_right ? static_cast<C>(ar[d * (n_disp + 1)]) : kBig);
    };
    disp_r[pix] = use_subpixel ? subpixel(rbd, n_disp, right_at(rdc - 1),
                                          static_cast<float>(rbest), right_at(rdc + 1))
                               : static_cast<float>(rbd);
  }
  cost_out[pix] = cost;
  second_out[pix] = sec;
  valid[pix] = uniqueness > 0.0f ? cost < uniqueness * sec : true;
}

// kCheck false: write at (K5); true: and the LR test into valid in place (K6)
template <bool kCheck>
__global__ void __launch_bounds__(kThreads)
lr_gather_kernel(const float* __restrict__ disp_l, const float* __restrict__ disp_r,
                 float* __restrict__ at, bool* __restrict__ valid, float lr_max_diff, int h,
                 int w, int n_disp) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const size_t pix = static_cast<size_t>(y) * w + x;
  const float dl = disp_l[pix];
  const int d = min(max(__float2int_rn(dl), 0), n_disp - 1);
  const float a = x - d >= 0 ? disp_r[pix - d] : svt::kBigFloat;
  if (kCheck) {
    valid[pix] = valid[pix] && fabsf(dl - a) <= lr_max_diff && a < svt::kBigFloat;
  } else {
    at[pix] = a;
  }
}

template <typename T>
cudaError_t launch_extract(const void* total, int h, int w, int n_disp, int use_subpixel,
                           float uniqueness, void* disp_l, void* cost, void* valid, void* second,
                           void* disp_r, cudaStream_t stream) {
  const dim3 grid((w + kThreads - 1) / kThreads, h);
  extract_maps_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(total), h, w, n_disp, use_subpixel, uniqueness,
      static_cast<float*>(disp_l), static_cast<float*>(cost), static_cast<bool*>(valid),
      static_cast<float*>(second), static_cast<float*>(disp_r));
  return cudaGetLastError();
}

}  // namespace

// total: (H, W, D) int8 (total_bytes 1), int16 (2) or float32 (4); outputs
// (H, W): disp_l, cost, second, disp_r f32, valid bool. uniqueness <= 0
// disables the ratio test; disp_r null skips the right view.
SVT_API int svt_extract_maps(const void* total, int total_bytes, int h, int w, int n_disp,
                             int use_subpixel, float uniqueness, void* disp_l, void* cost,
                             void* valid, void* second, void* disp_r, void* stream) {
  if (h <= 0 || w <= 0 || n_disp < 3) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (total_bytes) {
    case 1:
      return launch_extract<int8_t>(total, h, w, n_disp, use_subpixel, uniqueness, disp_l, cost,
                                    valid, second, disp_r, s);
    case 2:
      return launch_extract<int16_t>(total, h, w, n_disp, use_subpixel, uniqueness, disp_l, cost,
                                     valid, second, disp_r, s);
    case 4:
      return launch_extract<float>(total, h, w, n_disp, use_subpixel, uniqueness, disp_l, cost,
                                   valid, second, disp_r, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// disp_l/disp_r: (H, W) f32 left/right subpixel maps; at: (H, W) f32.
SVT_API int svt_lr_gather(const void* disp_l, const void* disp_r, void* at, int h, int w,
                          int n_disp, void* stream) {
  if (h <= 0 || w <= 0 || n_disp < 1) return cudaErrorInvalidValue;
  const dim3 grid((w + kThreads - 1) / kThreads, h);
  lr_gather_kernel<false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(disp_l), static_cast<const float*>(disp_r),
      static_cast<float*>(at), nullptr, 0.0f, h, w, n_disp);
  return cudaGetLastError();
}

// disp_l/disp_r: (H, W) f32 left/right subpixel maps; valid: (H, W) bool,
// and-ed in place with |d_L - at| <= lr_max_diff & at < 1e9.
SVT_API int svt_lr_check(const void* disp_l, const void* disp_r, void* valid, float lr_max_diff,
                         int h, int w, int n_disp, void* stream) {
  if (h <= 0 || w <= 0 || n_disp < 1) return cudaErrorInvalidValue;
  const dim3 grid((w + kThreads - 1) / kThreads, h);
  lr_gather_kernel<true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(disp_l), static_cast<const float*>(disp_r), nullptr,
      static_cast<bool*>(valid), lr_max_diff, h, w, n_disp);
  return cudaGetLastError();
}
