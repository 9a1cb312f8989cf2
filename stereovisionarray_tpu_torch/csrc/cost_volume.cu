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
// (half to even: __float2int_rn), or as it is in a float32 volume (the
// reference builds that one in XLA; no TPU kernel stands behind it, but
// without this store the float route would run the plain PyTorch cost
// volume, tens of milliseconds on an H100 at 540x768x64). The half-pixel BT
// bounds wrap around the row (x = 0 reads x = W - 1), as the reference's
// jnp.roll does. Built with
// -fmad=false so `ham + bt_weight * bt` rounds twice, as the reference does.
//
// What bounds it on the H100: at 540x768x64 int8 the volume write is 26.5 MB
// (~8 us at 3.35 TB/s), while the arithmetic is ~25 instructions per output
// (popcount, ~12 float ops of BT, conversion): ~0.7 G instructions, tens of
// microseconds at the SMs' instruction rate. So instructions, not memory,
// are the bound.
// Design: one block per (row, 64-pixel tile). The block first computes the
// census codes (packed into up to four 64-bit words) and the BT bounds of its
// 64 left pixels and of the 64 + D - 1 right pixels its candidates reach,
// into shared memory, so each census is built once per block instead of once
// per (x, d); then its threads sweep (x, d) with d fastest, so neighbouring
// threads write neighbouring bytes of the volume.

#include "common.cuh"

namespace {

constexpr int kTile = 64;      // left pixels per block
constexpr int kMaxWords = 4;   // census codes up to 256 bits
constexpr int kThreads = 256;

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
__global__ void __launch_bounds__(kThreads)
cost_volume_kernel(const float* __restrict__ left, const float* __restrict__ right,
                   OutT* __restrict__ out, int h, int w, int n_disp, int ph, int pw,
                   int n_words, float bt_weight, float bt_clip, float worst, float scale) {
  extern __shared__ uint64_t smem[];
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kTile;
  const int n_right = kTile + n_disp - 1;  // right pixels x0 - D + 1 .. x0 + kTile - 1
  const int r0 = x0 - (n_disp - 1);
  uint64_t* cl = smem;                          // [kTile][n_words]
  uint64_t* cr = cl + kTile * n_words;          // [n_right][n_words]
  float* lv = reinterpret_cast<float*>(cr + n_right * n_words);  // [3][kTile]
  float* rv = lv + 3 * kTile;                   // [3][n_right]
  const bool use_bt = bt_weight > 0.0f;

  for (int i = threadIdx.x; i < kTile + n_right; i += blockDim.x) {
    if (i < kTile) {
      const int x = x0 + i;
      if (x >= w) continue;
      census_at(left, h, w, y, x, ph, pw, cl + i * n_words);
      if (use_bt)
        half_pixel_bounds(left + y * w, w, x, &lv[i], &lv[kTile + i], &lv[2 * kTile + i]);
    } else {
      const int j = i - kTile;
      const int x = r0 + j;
      if (x < 0 || x >= w) continue;
      census_at(right, h, w, y, x, ph, pw, cr + j * n_words);
      if (use_bt)
        half_pixel_bounds(right + y * w, w, x, &rv[j], &rv[n_right + j], &rv[2 * n_right + j]);
    }
  }
  __syncthreads();

  OutT* out_row = out + static_cast<size_t>(y) * w * n_disp;
  for (int i = threadIdx.x; i < kTile * n_disp; i += blockDim.x) {
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
        const float lt = lv[xl], l_mn = lv[kTile + xl], l_mx = lv[2 * kTile + xl];
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
cudaError_t launch(const float* left, const float* right, void* out, int h, int w, int n_disp,
                   int ph, int pw, int n_words, float bt_weight, float bt_clip, float worst,
                   float scale, cudaStream_t stream) {
  const int n_right = kTile + n_disp - 1;
  const size_t smem = static_cast<size_t>(kTile + n_right) * n_words * sizeof(uint64_t) +
                      static_cast<size_t>(3 * (kTile + n_right)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cost_volume_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((w + kTile - 1) / kTile, h);
  cost_volume_kernel<OutT><<<grid, kThreads, smem, stream>>>(
      left, right, static_cast<OutT*>(out), h, w, n_disp, ph, pw, n_words, bt_weight, bt_clip,
      worst, scale);
  return cudaGetLastError();
}

}  // namespace

SVT_API const char* svt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// left/right: (H, W) float32; out: (H, W, D) int8 (out_bytes 1), int16 (2)
// or float32 (4, stored unscaled).
SVT_API int svt_cost_volume(const void* left, const void* right, void* out, int out_bytes,
                            int h, int w, int n_disp, int win_h, int win_w, float bt_weight,
                            float bt_clip, float worst, float scale, void* stream) {
  const int n_words = (win_h * win_w - 1 + 63) / 64;
  if (h <= 0 || w <= 0 || n_disp <= 0 || win_h % 2 == 0 || win_w % 2 == 0 ||
      n_words > kMaxWords || (out_bytes != 1 && out_bytes != 2 && out_bytes != 4))
    return cudaErrorInvalidValue;
  const auto* l = static_cast<const float*>(left);
  const auto* r = static_cast<const float*>(right);
  auto s = static_cast<cudaStream_t>(stream);
  if (out_bytes == 1)
    return launch<int8_t>(l, r, out, h, w, n_disp, win_h / 2, win_w / 2, n_words, bt_weight,
                          bt_clip, worst, scale, s);
  if (out_bytes == 4)
    return launch<float>(l, r, out, h, w, n_disp, win_h / 2, win_w / 2, n_words, bt_weight,
                         bt_clip, worst, scale, s);
  return launch<int16_t>(l, r, out, h, w, n_disp, win_h / 2, win_w / 2, n_words, bt_weight,
                         bt_clip, worst, scale, s);
}
