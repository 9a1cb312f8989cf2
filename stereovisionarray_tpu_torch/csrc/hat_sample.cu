// K9: hat-weighted sampling along one axis of a batch of (H, W) maps,
//   out(b, y, x) = sum_{k=k0..k1} max(0, 1 - |t(b,y,x) - k|) * values(b, y, clamp(x - k))
// (or along rows: values(b, clamp(y - k), x)), and with a per-column table
// aux (W,) the same weights applied to aux(clamp(x - k)).
//
// Replaces stereovisionarray_tpu/ops/hatsample.py::_kernel and ::_kernel_aux.
// The TPU kernel sums every tap of [k0, k1] as a static lane slice of a
// VMEM block because a per-pixel gather does not lower there. On the GPU a
// gather is a plain load, and of the hat weights only those of the two taps
// floor(t) and floor(t) + 1 can be non-zero (|t - k| >= 1 for every other k,
// and rounding keeps it >= 1), so each thread reads two values. Each weight
// is computed as the reference computes it, fmaxf(0, 1 - fabsf(t - k)),
// and added from +0.0f in ascending k, which is the reference's sum:
// every other tap adds a signed zero and changes nothing. A tap outside
// [k0, k1] is left out, so t outside the range keeps its partial weight.
// (The reference pads by max(k1, 0) on the left, so for k1 < 0 it reads
// values(x + k1 - k); this kernel follows the formula above.)
//
// What bounds it on the H100: memory. Per pixel it reads t and two values
// (three with the row axis's stride, all near the pixel, so from cache) and
// writes one or two floats: 12-20 bytes, 5-8 MB at 540x768, a few
// microseconds of HBM time; at these sizes the launch dominates.
// Design: one thread per output pixel, consecutive threads on consecutive x,
// so t, out and the values of both axes are read coalesced. Built with
// -fmad=false: `acc + w * v` stays two roundings, as in the plain twin.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hat_sample_kernel(const float* __restrict__ values, const float* __restrict__ t,
                  const float* __restrict__ aux, float* __restrict__ out,
                  float* __restrict__ aux_out, size_t n, int h, int w, int k0, int k1,
                  int along_rows) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int x = static_cast<int>(i % w);
  const size_t row = i / w;
  const int y = static_cast<int>(row % h);
  const size_t plane = (row / h) * static_cast<size_t>(h) * w;
  // the sampled line: a row of the map (stride 1) or a column (stride w)
  const float* line = values + plane + (along_rows ? x : static_cast<size_t>(y) * w);
  const int len = along_rows ? h : w;
  const int pos = along_rows ? y : x;
  const size_t stride = along_rows ? static_cast<size_t>(w) : 1;

  const float tv = t[i];
  const float f = floorf(tv);
  float acc = 0.0f, aacc = 0.0f;
#pragma unroll
  for (int tap = 0; tap < 2; ++tap) {
    const float kf = f + static_cast<float>(tap);
    if (!(kf >= static_cast<float>(k0) && kf <= static_cast<float>(k1))) continue;
    const float wgt = fmaxf(0.0f, 1.0f - fabsf(tv - kf));
    const int src = min(max(pos - static_cast<int>(kf), 0), len - 1);
    acc = acc + wgt * __ldg(line + src * stride);
    if (aux != nullptr) aacc = aacc + wgt * __ldg(aux + src);
  }
  out[i] = acc;
  if (aux_out != nullptr) aux_out[i] = aacc;
}

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
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  hat_sample_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const float*>(t),
      static_cast<const float*>(aux), static_cast<float*>(out), static_cast<float*>(aux_out), n,
      h, w, k0, k1, along_rows);
  return cudaGetLastError();
}
