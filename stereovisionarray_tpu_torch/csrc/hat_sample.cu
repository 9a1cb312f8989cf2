// K9: hat-weighted sampling along one axis of a batch of (H, W) maps,
//   out(b, y, x) = sum_{k=k0..k1} max(0, 1 - |t(b,y,x) - k|) * values(b, y, clamp(x - k))
// (or along rows: values(b, clamp(y - k), x)), and with a per-column table
// aux (W,) the same weights applied to aux(clamp(x - k)); and its separable
// 2-D form, a pass along rows and then one along columns in one launch.
//
// Replaces stereovisionarray_tpu/ops/hatsample.py::_kernel and ::_kernel_aux.
// The TPU kernel sums every tap of [k0, k1] as a static lane slice of a
// VMEM block because a per-pixel gather does not lower there. On the GPU a
// gather is a plain load, and of the hat weights only those of the two taps
// floor(t) and floor(t) + 1 can be non-zero (|t - k| >= 1 for every other k,
// and rounding keeps it >= 1), so each element reads two values. Each weight
// is computed as the reference computes it, fmaxf(0, 1 - fabsf(t - k)),
// and added from +0.0f in ascending k, which is the reference's sum:
// every other tap adds a signed zero and changes nothing. A tap outside
// [k0, k1] is left out, so t outside the range keeps its partial weight.
// (The reference pads by max(k1, 0) on the left, so for k1 < 0 it reads
// values(x + k1 - k); this kernel follows the formula above.)
//
// What bounds it on the H100: memory. Per element it reads t and two values
// (from cache: they lie near the element) and writes one or two floats:
// 12-20 bytes, 5-8 MB at 540x768, ~2 microseconds of HBM time. Design: each
// thread samples 4 consecutive elements, with one 128-bit load of t and one
// 128-bit store of out (and aux_out) where W % 4 == 0 and those pointers are
// 16-byte aligned; otherwise each of the 4 is loaded and stored alone. Built
// with -fmad=false: `acc + w * v` stays two roundings, as in the plain twin.
//
// The 2-D form replaces the array cascade's pre-warp, the reference's
// transpose + hat_sample along rows, then hat_sample along columns
// (stereovisionarray_tpu/models/cascade_sweep.py:318-321). One CTA per
// (map, row) computes the row's vertical samples into shared memory, then
// the horizontal samples from there: each element with the arithmetic of
// the two 1-D passes, so the result is theirs bit for bit, and the
// intermediate (B x H x W floats) never reaches HBM.

#include "common.cuh"

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // consecutive elements per thread

// The sum over the taps floor(tv) and floor(tv) + 1 inside [k0, k1] of their
// hat weights times load(src), src = clamp(pos - k, 0, len - 1), from +0 in
// ascending k; with kAux the same weights times load_aux(src) as .y.
template <bool kAux, typename Load, typename LoadAux>
__device__ __forceinline__ float2 hat_taps(float tv, int pos, int len, int k0, int k1, Load load,
                                           LoadAux load_aux) {
  const float f = floorf(tv);
  float acc = 0.0f, aacc = 0.0f;
#pragma unroll
  for (int tap = 0; tap < 2; ++tap) {
    const float kf = f + static_cast<float>(tap);
    if (!(kf >= static_cast<float>(k0) && kf <= static_cast<float>(k1))) continue;
    const float wgt = fmaxf(0.0f, 1.0f - fabsf(tv - kf));
    const int src = min(max(pos - static_cast<int>(kf), 0), len - 1);
    acc = acc + wgt * load(src);
    if (kAux) aacc = aacc + wgt * load_aux(src);
  }
  return make_float2(acc, aacc);
}

// element (plane, y, x) of the 1-D sampler: along x (a row, stride 1) or
// along y (a column, stride w)
template <bool kAux>
__device__ __forceinline__ float2 sample(const float* __restrict__ values,
                                         const float* __restrict__ aux, size_t plane, int y,
                                         int x, float tv, int h, int w, int k0, int k1,
                                         int along_rows) {
  const float* line = values + plane + (along_rows ? x : static_cast<size_t>(y) * w);
  const size_t stride = along_rows ? static_cast<size_t>(w) : 1;
  return hat_taps<kAux>(
      tv, along_rows ? y : x, along_rows ? h : w, k0, k1,
      [&](int s) { return __ldg(line + s * stride); }, [&](int s) { return __ldg(aux + s); });
}

template <bool kAux>
__global__ void __launch_bounds__(kThreads)
hat_sample_kernel(const float* __restrict__ values, const float* __restrict__ t,
                  const float* __restrict__ aux, float* __restrict__ out,
                  float* __restrict__ aux_out, size_t n, int h, int w, int k0, int k1,
                  int along_rows, int vec) {
  const size_t i0 = (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (i0 >= n) return;
  if (vec) {  // w % 4 == 0: the four elements share a row
    const int x0 = static_cast<int>(i0 % w);
    const size_t row = i0 / w;
    const int y = static_cast<int>(row % h);
    const size_t plane = (row / h) * static_cast<size_t>(h) * w;
    const float4 tv = *reinterpret_cast<const float4*>(t + i0);
    const float2 s0 = sample<kAux>(values, aux, plane, y, x0, tv.x, h, w, k0, k1, along_rows);
    const float2 s1 = sample<kAux>(values, aux, plane, y, x0 + 1, tv.y, h, w, k0, k1, along_rows);
    const float2 s2 = sample<kAux>(values, aux, plane, y, x0 + 2, tv.z, h, w, k0, k1, along_rows);
    const float2 s3 = sample<kAux>(values, aux, plane, y, x0 + 3, tv.w, h, w, k0, k1, along_rows);
    *reinterpret_cast<float4*>(out + i0) = make_float4(s0.x, s1.x, s2.x, s3.x);
    if (kAux) *reinterpret_cast<float4*>(aux_out + i0) = make_float4(s0.y, s1.y, s2.y, s3.y);
    return;
  }
  for (size_t i = i0; i < i0 + kVec && i < n; ++i) {
    const int x = static_cast<int>(i % w);
    const size_t row = i / w;
    const float2 s = sample<kAux>(values, aux, (row / h) * static_cast<size_t>(h) * w,
                                  static_cast<int>(row % h), x, t[i], h, w, k0, k1, along_rows);
    out[i] = s.x;
    if (kAux) aux_out[i] = s.y;
  }
}

// grid (H, B): CTA (y, b) samples row y of map b along rows into shared
// memory (W floats), then that row along columns
__global__ void __launch_bounds__(1024)
hat_sample_2d_kernel(const float* __restrict__ values, const float* __restrict__ t_rows,
                     const float* __restrict__ t_cols, float* __restrict__ out, int h, int w,
                     int k0, int k1) {
  extern __shared__ float tmp[];
  const int y = blockIdx.x;
  const size_t plane = static_cast<size_t>(blockIdx.y) * h * w;
  const size_t row = plane + static_cast<size_t>(y) * w;
  const auto none = [](int) { return 0.0f; };
  for (int x = threadIdx.x; x < w; x += blockDim.x) {
    const float* column = values + plane + x;
    tmp[x] = hat_taps<false>(
                 t_rows[row + x], y, h, k0, k1,
                 [&](int s) { return __ldg(column + static_cast<size_t>(s) * w); }, none)
                 .x;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < w; x += blockDim.x)
    out[row + x] = hat_taps<false>(t_cols[row + x], x, w, k0, k1, [&](int s) { return tmp[s]; },
                                   none)
                       .x;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// values, t, out: (B, H, W) f32; aux: (W,) f32 or null (then aux_out is
// null too; aux needs along_rows == 0). along_rows: 0 samples along x
// (columns of a row), 1 along y.
SVT_API int svt_hat_sample(const void* values, const void* t, const void* aux, void* out,
                           void* aux_out, int batch, int h, int w, int k0, int k1,
                           int along_rows, void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || k0 > k1 || (aux != nullptr) != (aux_out != nullptr) ||
      (aux != nullptr && along_rows))
    return cudaErrorInvalidValue;
  const size_t n = static_cast<size_t>(batch) * h * w;
  const unsigned blocks = static_cast<unsigned>((n + kThreads * kVec - 1) / (kThreads * kVec));
  const int vec = w % kVec == 0 && aligned16(t) && aligned16(out) &&
                  (aux_out == nullptr || aligned16(aux_out));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto v = static_cast<const float*>(values);
  const auto tt = static_cast<const float*>(t);
  if (aux != nullptr)
    hat_sample_kernel<true><<<blocks, kThreads, 0, s>>>(
        v, tt, static_cast<const float*>(aux), static_cast<float*>(out),
        static_cast<float*>(aux_out), n, h, w, k0, k1, along_rows, vec);
  else
    hat_sample_kernel<false><<<blocks, kThreads, 0, s>>>(
        v, tt, nullptr, static_cast<float*>(out), nullptr, n, h, w, k0, k1, along_rows, vec);
  return cudaGetLastError();
}

// values, t_rows, t_cols, out: (B, H, W) f32. out = the column pass (t_cols)
// of the row pass (t_rows) of values, both over the taps [k0, k1]. W floats
// of shared memory per CTA, opted in above 48 KB.
SVT_API int svt_hat_sample_2d(const void* values, const void* t_rows, const void* t_cols,
                              void* out, int batch, int h, int w, int k0, int k1, void* stream) {
  if (batch <= 0 || batch > 65535 || h <= 0 || w <= 0 || k0 > k1) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(w) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hat_sample_2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = std::min(1024, (w + 31) / 32 * 32);
  hat_sample_2d_kernel<<<dim3(h, batch), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const float*>(t_rows),
      static_cast<const float*>(t_cols), static_cast<float*>(out), h, w, k0, k1);
  return cudaGetLastError();
}
