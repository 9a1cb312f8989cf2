// K8: fused translation plane sweep with census cost and view fusion,
// written as an (H, W, D) float32 cost volume and an (H, W, D) int32 count
// of in-view sources.
//
// Replaces stereovisionarray_tpu/ops/sweep_pallas.py::_sweep_kernel (up to 8
// views), ::_sweep_kernel_grid_chunk (more views) and the unreached
// ::_sweep_kernel_grid_views. Their split by view count, the one-hot MXU
// warp, the hi/lo bf16 split of the sources and the per-bit signed-select
// Hamming were answers to the TPU's VMEM size, its lack of dynamic offsets
// and a packing miscompile; none applies here. One kernel serves every view
// count and reads the float32 sources directly, which is exact.
//
// For plane d and source s with shift (su, sv):
//   i0 = floor(su), fu = su - i0 (and j0, fv from sv);
//   warped(y, x) = bilinear of the zero-padded source at (y + j0, x + i0)
//                  with weights fu, fv, in the reference's operation order
//                  top = a*(1-fu) + b*fu, bot = c*(1-fu) + e*fu,
//                  top*(1-fv) + bot*fv (built with -fmad=false);
//   the census of warped(y, x) compares its patch^2 - 1 neighbours with
//   warped(y, x) itself, the neighbours taken from real shifted content
//   beyond the image border too (not edge-clamped);
//   cost = popcount(census_warped ^ census_ref), the reference census taken
//   with edge-clamped neighbours;
//   ok = the float test u + (i0 + fu) in [0, W-1] and v + (j0 + fv) in
//   [0, H-1]; an out-of-view source contributes the ceiling patch^2 - 1.
// Fusion over the S sources (mode): 0 = ceiling-padded mean (sum * (1/S)),
// 1 = valid mean (sum of in-view costs / max(nv, 1)), 2 = top-k mean (k
// ascending slots kept by insertion, their sum * (1/k)). The constant
// divisors are float32 reciprocals because the reference's compiler turns
// its division by a constant into that product. Every cost is a small
// integer, so each fused value is fixed whatever the order of the sums.
//
// What bounds it on the H100: at 270x360, 128 planes, the work is
// D * S * H * W pixel-views of ~100 instructions (lerp, patch^2 compares,
// popcount), 0.5 G instructions for 4 sources and 3 G for 24, against a
// 100 MB volume write; instructions, not memory, are the bound.
// Design: one block per (32x8 pixel tile, chunk of planes). The block packs
// its pixels' reference census into shared memory once, then for each plane
// and source stages the warped (tile + 2M)^2 window in shared memory
// (each element read from the source through the cache), and each thread
// builds its pixel's census from that window and accumulates the fusion in
// registers (top-k slots in shared memory, so k has no compile-time cap).

#include "common.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kPlanesPerBlock = 8;

__device__ __forceinline__ float sample(const float* __restrict__ img, int h, int w, int y,
                                        int x) {
  return (y >= 0 && y < h && x >= 0 && x < w) ? __ldg(img + static_cast<size_t>(y) * w + x)
                                              : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
plane_sweep_kernel(const float* __restrict__ ref, const float* __restrict__ src,
                   const float* __restrict__ shifts, float* __restrict__ fused,
                   int* __restrict__ nviews, int n_src, int h, int w, int n_planes, int patch,
                   int n_words, int mode, int topk) {
  extern __shared__ uint64_t smem[];
  const int M = patch / 2;
  const int wm = kTileW + 2 * M;  // warped window width (census margin both sides)
  const int hm = kTileH + 2 * M;
  uint64_t* refc = smem;                                          // [n_words][kThreads]
  float* win = reinterpret_cast<float*>(refc + n_words * kThreads);  // [hm][wm]
  float* slots = win + hm * wm;                                   // [topk][kThreads]

  const int tid = threadIdx.x;
  const int lx = tid % kTileW, ly = tid / kTileW;
  const int tx0 = blockIdx.x * kTileW, ty0 = blockIdx.y * kTileH;
  const int x = tx0 + lx, y = ty0 + ly;
  const bool inside = x < w && y < h;
  const float ceiling = static_cast<float>(patch * patch - 1);

  // reference census of this thread's pixel, edge-clamped neighbours
  if (inside) {
    const float c = ref[y * w + x];
    uint64_t cur = 0;
    int bit = 0;
    for (int dy = -M; dy <= M; ++dy) {
      const float* row = ref + min(max(y + dy, 0), h - 1) * w;
      for (int dx = -M; dx <= M; ++dx) {
        if (dy == 0 && dx == 0) continue;
        if (row[min(max(x + dx, 0), w - 1)] < c) cur |= 1ull << (bit & 63);
        if ((++bit & 63) == 0) {
          refc[((bit >> 6) - 1) * kThreads + tid] = cur;
          cur = 0;
        }
      }
    }
    if (bit & 63) refc[(bit >> 6) * kThreads + tid] = cur;
  }

  const int d_end = min(n_planes, (blockIdx.z + 1) * kPlanesPerBlock);
  for (int d = blockIdx.z * kPlanesPerBlock; d < d_end; ++d) {
    float acc = 0.0f;
    int nv = 0;
    for (int i = 0; i < topk; ++i) slots[i * kThreads + tid] = 1e30f;
    for (int s = 0; s < n_src; ++s) {
      const float su = shifts[(d * n_src + s) * 2];
      const float sv = shifts[(d * n_src + s) * 2 + 1];
      const float i0f = floorf(su), j0f = floorf(sv);
      const float fu = su - i0f, fv = sv - j0f;
      const int i0 = static_cast<int>(i0f), j0 = static_cast<int>(j0f);
      const float* img = src + static_cast<size_t>(s) * h * w;

      __syncthreads();  // the previous source's window is no longer read
      for (int i = tid; i < hm * wm; i += kThreads) {
        const int r = i / wm, c = i - r * wm;
        const int sy = ty0 - M + r + j0, sx = tx0 - M + c + i0;
        const float top = sample(img, h, w, sy, sx) * (1.0f - fu) +
                          sample(img, h, w, sy, sx + 1) * fu;
        const float bot = sample(img, h, w, sy + 1, sx) * (1.0f - fu) +
                          sample(img, h, w, sy + 1, sx + 1) * fu;
        win[i] = top * (1.0f - fv) + bot * fv;
      }
      __syncthreads();
      if (!inside) continue;

      const float* wc = win + (ly + M) * wm + (lx + M);
      const float center = *wc;
      int ham = 0;
      uint64_t cur = 0;
      int bit = 0;
      for (int dy = -M; dy <= M; ++dy) {
        for (int dx = -M; dx <= M; ++dx) {
          if (dy == 0 && dx == 0) continue;
          if (wc[dy * wm + dx] < center) cur |= 1ull << (bit & 63);
          if ((++bit & 63) == 0) {
            ham += __popcll(cur ^ refc[((bit >> 6) - 1) * kThreads + tid]);
            cur = 0;
          }
        }
      }
      if (bit & 63) ham += __popcll(cur ^ refc[(bit >> 6) * kThreads + tid]);

      const float su2 = i0f + fu, sv2 = j0f + fv;
      const float u = static_cast<float>(x), v = static_cast<float>(y);
      const bool ok = u + su2 >= 0.0f && u + su2 <= static_cast<float>(w - 1) &&
                      v + sv2 >= 0.0f && v + sv2 <= static_cast<float>(h - 1);
      nv += ok;
      const float cost = static_cast<float>(ham);
      if (mode == 2) {
        float val = ok ? cost : ceiling;
        for (int i = 0; i < topk; ++i) {
          const float t = slots[i * kThreads + tid];
          slots[i * kThreads + tid] = fminf(t, val);
          val = fmaxf(t, val);
        }
      } else if (mode == 1) {
        acc = acc + (ok ? cost : 0.0f);
      } else {
        acc = acc + (ok ? cost : ceiling);
      }
    }
    if (!inside) continue;
    float out;
    if (mode == 2) {
      acc = slots[tid];
      for (int i = 1; i < topk; ++i) acc = acc + slots[i * kThreads + tid];
      out = acc * (1.0f / static_cast<float>(topk));
    } else if (mode == 1) {
      out = acc / static_cast<float>(max(nv, 1));
    } else {
      out = acc * (1.0f / static_cast<float>(n_src));
    }
    const size_t o = (static_cast<size_t>(y) * w + x) * n_planes + d;
    fused[o] = out;
    nviews[o] = nv;
  }
}

}  // namespace

// ref: (H, W) f32; src: (S, H, W) f32; shifts: (D, S, 2) f32 (su, sv);
// fused: (H, W, D) f32; nviews: (H, W, D) int32. mode: 0 mean, 1 valid mean,
// 2 top-k mean (1 <= topk < S).
SVT_API int svt_plane_sweep(const void* ref, const void* src, const void* shifts, void* fused,
                            void* nviews, int n_src, int h, int w, int n_planes, int patch,
                            int mode, int topk, void* stream) {
  if (h <= 0 || w <= 0 || n_planes <= 0 || n_src <= 0 || patch < 3 || patch % 2 == 0 ||
      mode < 0 || mode > 2 || (mode == 2 && (topk < 1 || topk >= n_src)))
    return cudaErrorInvalidValue;
  if (mode != 2) topk = 0;
  const int M = patch / 2;
  const int n_words = (patch * patch - 1 + 63) / 64;
  const size_t smem = static_cast<size_t>(n_words) * kThreads * sizeof(uint64_t) +
                      static_cast<size_t>(kTileH + 2 * M) * (kTileW + 2 * M) * sizeof(float) +
                      static_cast<size_t>(topk) * kThreads * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        plane_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                  (n_planes + kPlanesPerBlock - 1) / kPlanesPerBlock);
  plane_sweep_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ref), static_cast<const float*>(src),
      static_cast<const float*>(shifts), static_cast<float*>(fused), static_cast<int*>(nviews),
      n_src, h, w, n_planes, patch, n_words, mode, topk);
  return cudaGetLastError();
}
