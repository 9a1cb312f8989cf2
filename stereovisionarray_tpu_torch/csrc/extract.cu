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
// What bounds them on the H100: K4's loads. A thread reads its pixel's D
// values three times (WTA, second best, right view), and neighbouring threads
// read addresses D * size apart, so every warp load touches 32 cache lines:
// 192 x 32 L1 wavefronts per warp at D = 64, ~600 k per SM at 540x768, about
// its measured 0.35 ms at one wavefront a clock. The fused LR check adds one
// shared-memory store and one distributed shared-memory load per pixel. K5
// standalone moves 3 * H*W floats (~5 MB): its device time is a few
// microseconds, and a wrapper call costs more on the host.

#include "common.cuh"

#include <cooperative_groups.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // the standalone gather
constexpr int kColumns = 128;  // columns per CTA of the extraction kernel
constexpr int kMaxCluster = 8;  // CTAs per row with the LR check (portable cluster size)

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

// The maps of pixel (y, x); returns its right-view disparity when `right`.
template <typename T>
__device__ __forceinline__ float extract_pixel(const T* __restrict__ total, size_t pix, int x, int w,
                                               int n_disp, int use_subpixel, float uniqueness,
                                               bool right, float* __restrict__ disp_l,
                                               float* __restrict__ cost_out,
                                               bool* __restrict__ valid,
                                               float* __restrict__ second_out) {
  using C = typename Extract<T>::type;
  constexpr C kBig = Extract<T>::big;
  const T* a = total + pix * n_disp;
  // right view: candidate d of right pixel x is total[y, x + d, d]
  const T* ar = a;  // + d * (n_disp + 1) for candidate d
  const int n_right = min(n_disp, w - x);  // candidates inside the image, >= 1

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
  cost_out[pix] = cost;
  second_out[pix] = sec;
  valid[pix] = uniqueness > 0.0f ? cost < uniqueness * sec : true;
  if (!right) return 0.0f;
  const int rdc = min(max(rbd, 1), n_disp - 2);
  auto right_at = [&](int d) {
    return static_cast<float>(d < n_right ? static_cast<C>(ar[d * (n_disp + 1)]) : kBig);
  };
  return use_subpixel ? subpixel(rbd, n_disp, right_at(rdc - 1), static_cast<float>(rbest),
                                 right_at(rdc + 1))
                      : static_cast<float>(rbd);
}

// grid (CTAs per row, H); CTA c covers columns [c * cols, (c + 1) * cols).
// With lr_max_diff > 0 the launch makes each row one cluster and gives every
// CTA `cols` floats of dynamic shared memory for its columns' d_R.
template <typename T>
__global__ void __launch_bounds__(1024)
extract_maps_kernel(const T* __restrict__ total, int h, int w, int n_disp, int cols,
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
    const float dr = extract_pixel(total, row + x, x, w, n_disp, use_subpixel, uniqueness, right,
                                   disp_l, cost_out, valid, second_out);
    if (lr) row_r[x - x0] = dr;
    if (disp_r != nullptr) disp_r[row + x] = dr;
  }
  if (!lr) return;

  cg::cluster_group cluster = cg::this_cluster();  // the CTAs of this row
  cluster.sync();
  for (int x = x0 + threadIdx.x; x < x1; x += blockDim.x) {
    // this thread's own stores of d_L and the uniqueness validity above
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

template <typename T>
cudaError_t launch_extract(const void* total, int h, int w, int n_disp, int use_subpixel,
                           float uniqueness, float lr_max_diff, void* disp_l, void* cost,
                           void* valid, void* second, void* disp_r, cudaStream_t stream) {
  const bool lr = lr_max_diff > 0.0f;
  const int per_row = lr ? std::min(kMaxCluster, (w + kColumns - 1) / kColumns)
                         : (w + kColumns - 1) / kColumns;
  const int cols = (w + per_row - 1) / per_row;
  const size_t smem = lr ? cols * sizeof(float) : 0;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;  // W > 8 * 12288 with the LR check
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = per_row;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(per_row, h);
  cfg.blockDim = dim3(std::min(1024, (cols + 31) / 32 * 32));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = lr ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, extract_maps_kernel<T>, static_cast<const T*>(total), h, w, n_disp, cols,
      use_subpixel, uniqueness, lr_max_diff, static_cast<float*>(disp_l),
      static_cast<float*>(cost), static_cast<bool*>(valid), static_cast<float*>(second),
      static_cast<float*>(disp_r));
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// total: (H, W, D) int8 (total_bytes 1), int16 (2) or float32 (4); outputs
// (H, W): disp_l, cost, second, disp_r f32, valid bool. uniqueness <= 0
// disables the ratio test; lr_max_diff > 0 applies the left-right check to
// valid (W at most 8 * 12288); disp_r null leaves the right map out of HBM
// (and, without the LR check, skips the right view).
SVT_API int svt_extract_maps(const void* total, int total_bytes, int h, int w, int n_disp,
                             int use_subpixel, float uniqueness, float lr_max_diff, void* disp_l,
                             void* cost, void* valid, void* second, void* disp_r, void* stream) {
  if (h <= 0 || w <= 0 || n_disp < 3) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (total_bytes) {
    case 1:
      return launch_extract<int8_t>(total, h, w, n_disp, use_subpixel, uniqueness, lr_max_diff,
                                    disp_l, cost, valid, second, disp_r, s);
    case 2:
      return launch_extract<int16_t>(total, h, w, n_disp, use_subpixel, uniqueness, lr_max_diff,
                                     disp_l, cost, valid, second, disp_r, s);
    case 4:
      return launch_extract<float>(total, h, w, n_disp, use_subpixel, uniqueness, lr_max_diff,
                                   disp_l, cost, valid, second, disp_r, s);
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
