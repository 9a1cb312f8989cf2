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
// D * S * H * W pixel-views of a bilinear sample, patch^2 - 1 compares, a
// popcount and the fusion, 50 M pixel-views for 4 sources and 300 M for 24,
// against a 100 MB volume write; instructions, not memory, are the bound.
// Two kernels:
//  - plane_sweep_fast_kernel (patch 3, 5, 7, top-k <= 8, <= 255 sources:
//    every array path) keeps everything in registers and shuffles, with no
//    barrier (see its comment below);
//  - plane_sweep_kernel, the generic one (any patch, top-k up to 200): one
//    block per (32x8 pixel tile, chunk of planes) packs its pixels' reference
//    census into shared memory once, then for each plane and source stages
//    the warped (tile + 2M)^2 window in shared memory (each element read from
//    the source through the cache), and each thread builds its pixel's census
//    from that window and accumulates the fusion in registers (top-k slots in
//    shared memory, so k has no compile-time cap); each pixel's chunk of
//    planes goes out as 16-byte stores from shared memory at the end.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kPlanesPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sample(const float* __restrict__ img, int h, int w, int y,
                                        int x) {
  return (y >= 0 && y < h && x >= 0 && x < w) ? __ldg(img + static_cast<size_t>(y) * w + x)
                                              : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
plane_sweep_kernel(const float* __restrict__ ref, const float* __restrict__ src,
                   const float* __restrict__ shifts, float* __restrict__ fused,
                   int* __restrict__ nviews, int n_src, int h, int w, int n_planes, int patch,
                   int n_words, int mode, int topk, int staged) {
  extern __shared__ uint64_t smem[];
  const int M = patch / 2;
  const int wm = kTileW + 2 * M;  // warped window width (census margin both sides)
  const int hm = kTileH + 2 * M;
  uint64_t* refc = smem;                                          // [n_words][kThreads]
  float* win = reinterpret_cast<float*>(refc + n_words * kThreads);  // [hm][wm]
  float* slots = win + hm * wm;                                   // [topk][kThreads]
  // the chunk's results (`staged`), each thread's own column, written out at
  // the end; without room for them (top-k near 200 with a large patch) each
  // plane's result goes straight out
  float* chunk_out = slots + topk * kThreads;                     // [kPlanesPerBlock][kThreads]
  int* chunk_nv = reinterpret_cast<int*>(chunk_out + kPlanesPerBlock * kThreads);

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

  const int d_first = blockIdx.z * kPlanesPerBlock;
  const int d_end = min(n_planes, d_first + kPlanesPerBlock);
  for (int d = d_first; d < d_end; ++d) {
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
    if (staged) {
      chunk_out[(d - d_first) * kThreads + tid] = out;
      chunk_nv[(d - d_first) * kThreads + tid] = nv;
    } else {
      const size_t o = (static_cast<size_t>(y) * w + x) * n_planes + d;
      fused[o] = out;
      nviews[o] = nv;
    }
  }
  if (!inside || !staged) return;
  // each pixel's chunk of planes as two 16-byte stores of each output
  const size_t o = (static_cast<size_t>(y) * w + x) * n_planes + d_first;
  if (d_end - d_first == kPlanesPerBlock && n_planes % 4 == 0) {
    const float* f = chunk_out + tid;
    const int* c = chunk_nv + tid;
    constexpr int T = kThreads;
    reinterpret_cast<float4*>(fused + o)[0] = make_float4(f[0], f[T], f[2 * T], f[3 * T]);
    reinterpret_cast<float4*>(fused + o)[1] = make_float4(f[4 * T], f[5 * T], f[6 * T], f[7 * T]);
    reinterpret_cast<int4*>(nviews + o)[0] = make_int4(c[0], c[T], c[2 * T], c[3 * T]);
    reinterpret_cast<int4*>(nviews + o)[1] = make_int4(c[4 * T], c[5 * T], c[6 * T], c[7 * T]);
  } else {
    for (int dd = 0; dd < d_end - d_first; ++dd) {
      fused[o + dd] = chunk_out[dd * kThreads + tid];
      nviews[o + dd] = chunk_nv[dd * kThreads + tid];
    }
  }
}

// ---------------------------------------------------------------------------
// The specialised kernel (patch 3, 5, 7; top-k up to kMaxRegTopk; at most 255
// sources), the one the array paths run. A warp owns a strip of 32 columns by
// kRows output rows, and each lane one column of it: the lane computes the
// warped values of its column for the kRows + 2M rows the census needs
// (bilinear from the source through the L1 cache, each row's horizontal lerp
// shared by the two warped rows that use it), and takes the values of the
// columns beside it from the neighbouring lanes with __shfl_up/down_sync.
// The M lanes at each edge of the warp only feed their neighbours, so a warp
// writes 32 - 2M columns. No warp waits for another: no barrier. The census
// is a 32-bit word (patch 3 and 5) or a 64-bit one (patch 7) built in
// registers with the bit positions fixed at compile time; the reference
// census of each pixel is built once a block, from the edge-clamped
// reference the same way. Top-k keeps its k slots in registers (unrolled
// insertion). Each lane keeps its pixels' results for the block's
// kPlanesPerBlock planes in shared memory (slots only it reads, so no
// barrier; registers would cost occupancy) and writes each pixel's chunk as
// two 16-byte stores of `fused` and two of `nviews` (scalar stores where
// D % 4 != 0 or the chunk is cut short). What bounds it: the instructions of
// the per-pixel work (~2 per census bit, the lerps, the fusion) and the
// latency of the 2 * (kRows + 2M + 1) cached source loads a lane makes for
// each plane and source; the generic kernel spends about 8 SM cycles a
// pixel-view on two block barriers and bounds-checked gathers.

constexpr int kRows = 4;          // output rows a lane owns
constexpr int kFastWarps = 4;     // warps a block, stacked vertically
constexpr int kMaxRegTopk = 8;    // top-k slots held in registers

template <int PATCH>
using CensusWord = typename std::conditional<(PATCH * PATCH - 1 > 32), uint64_t, uint32_t>::type;

// census bit of neighbour (dy, dx): row-major over the patch, centre skipped
template <int PATCH>
__host__ __device__ constexpr int census_bit(int dy, int dx) {
  return (dy + PATCH / 2) * PATCH + (dx + PATCH / 2) - ((dy > 0 || (dy == 0 && dx > 0)) ? 1 : 0);
}

// value of lane (lane + dx) of the warp (dx in [-M, M])
__device__ __forceinline__ float lane_at(float v, int dx) {
  if (dx > 0) return __shfl_down_sync(kFull, v, dx);
  if (dx < 0) return __shfl_up_sync(kFull, v, -dx);
  return v;
}

// census of the kRows pixels of a lane from its column's kRows + 2M values
template <int PATCH>
__device__ __forceinline__ void census_rows(const float (&col)[kRows + PATCH - 1],
                                            CensusWord<PATCH> (&bits)[kRows]) {
  constexpr int M = PATCH / 2;
#pragma unroll
  for (int r = 0; r < kRows; ++r) bits[r] = 0;
#pragma unroll
  for (int i = 0; i < kRows + 2 * M; ++i) {
#pragma unroll
    for (int dx = -M; dx <= M; ++dx) {
      const float nb = lane_at(col[i], dx);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int dy = i - M - r;
        if (dy < -M || dy > M || (dy == 0 && dx == 0)) continue;
        if (nb < col[r + M])
          bits[r] |= static_cast<CensusWord<PATCH>>(1) << census_bit<PATCH>(dy, dx);
      }
    }
  }
}

__device__ __forceinline__ int popc_word(uint32_t v) { return __popc(v); }
__device__ __forceinline__ int popc_word(uint64_t v) { return __popcll(v); }

template <int PATCH, bool TOPK>
__global__ void __launch_bounds__(kFastWarps * 32)
plane_sweep_fast_kernel(const float* __restrict__ ref, const float* __restrict__ src,
                        const float* __restrict__ shifts, float* __restrict__ fused,
                        int* __restrict__ nviews, int n_src, int h, int w, int n_planes,
                        int mode, int topk) {
  constexpr int M = PATCH / 2;
  constexpr int kCol = kRows + 2 * M;
  using Word = CensusWord<PATCH>;
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.x * (32 - 2 * M) + lane - M;  // this lane's column
  const int y0 = (blockIdx.y * kFastWarps + (threadIdx.x >> 5)) * kRows;  // first output row
  if (y0 >= h) return;  // whole warp: below the image (warps share nothing)
  const bool out_lane = lane >= M && lane < 32 - M && x < w;
  const int xc = min(max(x, 0), w - 1);
  const float ceiling = static_cast<float>(PATCH * PATCH - 1);
  const float u = static_cast<float>(x);

  // reference census, edge-clamped neighbours
  Word ref_bits[kRows];
  {
    float col[kCol];
#pragma unroll
    for (int i = 0; i < kCol; ++i)
      col[i] = __ldg(ref + static_cast<size_t>(min(max(y0 - M + i, 0), h - 1)) * w + xc);
    census_rows<PATCH>(col, ref_bits);
  }

  const int d_first = blockIdx.z * kPlanesPerBlock;
  // each lane's results for the chunk, read back by the same lane at the end
  // (so registers do not hold them across the planes)
  __shared__ float s_out[kFastWarps][kRows][kPlanesPerBlock][32];
  __shared__ uint8_t s_nv[kFastWarps][kRows][kPlanesPerBlock][32];
  const int warp = threadIdx.x >> 5;

  for (int dd = 0; dd < kPlanesPerBlock; ++dd) {
    const int d = d_first + dd;
    if (d >= n_planes) break;  // uniform across the block
    float acc[kRows];
    int nv[kRows];
    float slot[kRows][TOPK ? kMaxRegTopk : 1];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      acc[r] = 0.0f;
      nv[r] = 0;
#pragma unroll
      for (int i = 0; i < (TOPK ? kMaxRegTopk : 1); ++i) slot[r][i] = 1e30f;
    }
    for (int s = 0; s < n_src; ++s) {
      const float su = __ldg(shifts + (d * n_src + s) * 2);
      const float sv = __ldg(shifts + (d * n_src + s) * 2 + 1);
      const float i0f = floorf(su), j0f = floorf(sv);
      const float fu = su - i0f, fv = sv - j0f;
      const int xs = x + static_cast<int>(i0f);
      const int ys = y0 - M + static_cast<int>(j0f);
      const float* img = src + static_cast<size_t>(s) * h * w;
      const bool c0 = xs >= 0 && xs < w, c1 = xs + 1 >= 0 && xs + 1 < w;
      // horizontal lerps of the kCol + 1 source rows, then the vertical ones,
      // in the reference's order: top * (1 - fv) + bot * fv
      float lerp[kCol + 1];
#pragma unroll
      for (int i = 0; i < kCol + 1; ++i) {
        const int yy = ys + i;
        const bool rv = yy >= 0 && yy < h;
        const size_t at = static_cast<size_t>(rv ? yy : 0) * w + xs;
        const float a = rv && c0 ? __ldg(img + at) : 0.0f;
        const float b = rv && c1 ? __ldg(img + at + 1) : 0.0f;
        lerp[i] = a * (1.0f - fu) + b * fu;
      }
      float col[kCol];
#pragma unroll
      for (int i = 0; i < kCol; ++i) col[i] = lerp[i] * (1.0f - fv) + lerp[i + 1] * fv;
      Word bits[kRows];
      census_rows<PATCH>(col, bits);

      const float su2 = i0f + fu, sv2 = j0f + fv;
      const bool ok_u = u + su2 >= 0.0f && u + su2 <= static_cast<float>(w - 1);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float v = static_cast<float>(y0 + r);
        const bool ok = ok_u && v + sv2 >= 0.0f && v + sv2 <= static_cast<float>(h - 1);
        nv[r] += ok;
        const float cost = static_cast<float>(popc_word(bits[r] ^ ref_bits[r]));
        if (TOPK) {
          float val = ok ? cost : ceiling;
#pragma unroll
          for (int i = 0; i < kMaxRegTopk; ++i) {
            if (i < topk) {
              const float t = slot[r][i];
              slot[r][i] = fminf(t, val);
              val = fmaxf(t, val);
            }
          }
        } else if (mode == 1) {
          acc[r] = acc[r] + (ok ? cost : 0.0f);
        } else {
          acc[r] = acc[r] + (ok ? cost : ceiling);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float o;
      if (TOPK) {
        float a = slot[r][0];
#pragma unroll
        for (int i = 1; i < kMaxRegTopk; ++i)
          if (i < topk) a = a + slot[r][i];
        o = a * (1.0f / static_cast<float>(topk));
      } else if (mode == 1) {
        o = acc[r] / static_cast<float>(max(nv[r], 1));
      } else {
        o = acc[r] * (1.0f / static_cast<float>(n_src));
      }
      s_out[warp][r][dd][lane] = o;
      s_nv[warp][r][dd][lane] = static_cast<uint8_t>(nv[r]);
    }
  }

  if (!out_lane) return;
  const int n_here = min(kPlanesPerBlock, n_planes - d_first);
  const bool vec = n_here == kPlanesPerBlock && n_planes % 4 == 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = y0 + r;
    if (y >= h) break;
    const size_t o = (static_cast<size_t>(y) * w + x) * n_planes + d_first;
    float out[kPlanesPerBlock];
    int cnt[kPlanesPerBlock];
#pragma unroll
    for (int dd = 0; dd < kPlanesPerBlock; ++dd) {
      out[dd] = s_out[warp][r][dd][lane];
      cnt[dd] = s_nv[warp][r][dd][lane];
    }
    if (vec) {
      float4* f = reinterpret_cast<float4*>(fused + o);
      f[0] = make_float4(out[0], out[1], out[2], out[3]);
      f[1] = make_float4(out[4], out[5], out[6], out[7]);
      int4* n = reinterpret_cast<int4*>(nviews + o);
      n[0] = make_int4(cnt[0], cnt[1], cnt[2], cnt[3]);
      n[1] = make_int4(cnt[4], cnt[5], cnt[6], cnt[7]);
    } else {
#pragma unroll
      for (int dd = 0; dd < kPlanesPerBlock; ++dd) {
        if (dd < n_here) {
          fused[o + dd] = out[dd];
          nviews[o + dd] = cnt[dd];
        }
      }
    }
  }
}

template <int PATCH>
cudaError_t launch_fast(const float* ref, const float* src, const float* shifts, float* fused,
                        int* nviews, int n_src, int h, int w, int n_planes, int mode, int topk,
                        cudaStream_t stream) {
  constexpr int M = PATCH / 2;
  const dim3 grid((w + 31 - 2 * M) / (32 - 2 * M),
                  (h + kFastWarps * kRows - 1) / (kFastWarps * kRows),
                  (n_planes + kPlanesPerBlock - 1) / kPlanesPerBlock);
  if (mode == 2)
    plane_sweep_fast_kernel<PATCH, true><<<grid, kFastWarps * 32, 0, stream>>>(
        ref, src, shifts, fused, nviews, n_src, h, w, n_planes, mode, topk);
  else
    plane_sweep_fast_kernel<PATCH, false><<<grid, kFastWarps * 32, 0, stream>>>(
        ref, src, shifts, fused, nviews, n_src, h, w, n_planes, mode, topk);
  return cudaGetLastError();
}

}  // namespace

// ref: (H, W) f32; src: (S, H, W) f32; shifts: (D, S, 2) f32 (su, sv);
// fused: (H, W, D) f32; nviews: (H, W, D) int32. mode: 0 mean, 1 valid mean,
// 2 top-k mean (1 <= topk < S). Patch 3, 5 and 7 with top-k up to 8 and at
// most 255 sources run the specialised kernel; every other case the generic
// one.
SVT_API int svt_plane_sweep(const void* ref, const void* src, const void* shifts, void* fused,
                            void* nviews, int n_src, int h, int w, int n_planes, int patch,
                            int mode, int topk, void* stream) {
  if (h <= 0 || w <= 0 || n_planes <= 0 || n_src <= 0 || patch < 3 || patch % 2 == 0 ||
      mode < 0 || mode > 2 || (mode == 2 && (topk < 1 || topk >= n_src)))
    return cudaErrorInvalidValue;
  if (mode != 2) topk = 0;
  const auto* r = static_cast<const float*>(ref);
  const auto* sr = static_cast<const float*>(src);
  const auto* sh = static_cast<const float*>(shifts);
  auto* f = static_cast<float*>(fused);
  auto* nv = static_cast<int*>(nviews);
  auto st = static_cast<cudaStream_t>(stream);
  if (n_src <= 255 && topk <= kMaxRegTopk) {
    if (patch == 3) return launch_fast<3>(r, sr, sh, f, nv, n_src, h, w, n_planes, mode, topk, st);
    if (patch == 5) return launch_fast<5>(r, sr, sh, f, nv, n_src, h, w, n_planes, mode, topk, st);
    if (patch == 7) return launch_fast<7>(r, sr, sh, f, nv, n_src, h, w, n_planes, mode, topk, st);
  }
  const int M = patch / 2;
  const int n_words = (patch * patch - 1 + 63) / 64;
  const size_t chunk = 2 * kPlanesPerBlock * kThreads * sizeof(float);  // the chunk's results
  size_t smem = static_cast<size_t>(n_words) * kThreads * sizeof(uint64_t) +
                static_cast<size_t>(kTileH + 2 * M) * (kTileW + 2 * M) * sizeof(float) +
                static_cast<size_t>(topk) * kThreads * sizeof(float);
  const int staged = smem + chunk <= 227 * 1024;
  if (staged) smem += chunk;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        plane_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                  (n_planes + kPlanesPerBlock - 1) / kPlanesPerBlock);
  plane_sweep_kernel<<<grid, kThreads, smem, st>>>(r, sr, sh, f, nv, n_src, h, w, n_planes,
                                                   patch, n_words, mode, topk, staged);
  return cudaGetLastError();
}
