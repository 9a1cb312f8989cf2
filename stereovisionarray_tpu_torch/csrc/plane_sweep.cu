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
// D * S * H * W pixel-views of a bilinear sample, patch^2 - 1 census bits, a
// popcount and the fusion, 50 M pixel-views for 4 sources and 300 M for 24,
// against a 100 MB volume write; the instructions issued, not memory, are
// the bound. Measured at patch 5 (the SASS of one plane and source of a
// warp, cuobjdump; CUDA events at the array paths' shapes, SM clock 1980
// MHz; scripts/perf_sweep.py):
//  - its earlier form (a lane a column, each census bit an FSETP and a
//    predicated insert, float top-k slots): 725 instructions for 112
//    pixel-views at top-6 (6.5 a pixel-view), 72 registers; 2.04 SM cycles
//    a pixel-view at 24 sources (2.33 ms), 1.85 at 4 (0.352 ms);
//  - this one: 1,026 instructions for 360 pixel-views at top-6 (2.85; 961
//    for the mean), an FADD and a funnel shift a census bit being 56% of
//    them; 126 registers at top-6, 96 for the mean (4 and 5 blocks of 4
//    warps an SM); 1.08 SM cycles a pixel-view at 24 sources (1.24 ms), 1.28
//    at 4 (0.244 ms).
// Two kernels:
//  - plane_sweep_fast_kernel (patch 3, 5, 7, top-k <= 8, <= 255 sources:
//    every array path) keeps everything in registers and shuffles, with no
//    barrier (see its comment below). Its tile: 64 columns by 6 rows a warp
//    (4 rows at patch 7, whose two census words a pixel cost registers), 4
//    warps a block, and 8 planes a block, or 4 where a plane has 16 sources
//    or more: a block's fixed work (the reference census, the write-out) is
//    then small beside its views, and the smaller blocks shorten the last
//    wave (at 8 rows, 24 sources: 1.28 ms at 4 planes against 1.32 at 8; at
//    6 rows, 4 sources: 0.244 at 8 planes against 0.278 at 4);
//  - plane_sweep_kernel, the generic one (any patch, top-k up to 200): one
//    block per (32x8 pixel tile, chunk of planes) packs its pixels' reference
//    census into shared memory once, then for each plane and source stages
//    the warped (tile + 2M)^2 window in shared memory (each element read from
//    the source through the cache), and each thread builds its pixel's census
//    from that window and accumulates the fusion in registers (top-k slots in
//    shared memory, so k has no compile-time cap); each pixel's chunk of
//    planes goes out as 16-byte stores from shared memory at the end.

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
// sources), the one the array paths run. A warp owns a strip of 64 columns by
// kRows output rows, and each lane two neighbouring columns of it: the lane
// computes the warped values of its two columns for the kRows + 2M rows the
// census needs (bilinear from the source through the L1 cache, three source
// columns a row; each row's horizontal lerps shared by the two warped rows
// that use them) and takes the 2M columns beside them from the neighbouring
// lanes with __shfl_up/down_sync. The M columns at each edge of the strip
// only feed their neighbours, so a warp writes 64 - 2M columns. No warp waits
// for another: no barrier.
//
// The census bit of a neighbour is the sign bit of the float difference
// nb - centre, shifted into a 32-bit word with one funnel shift: a full-rate
// FADD and one shift a bit, where a compare and a predicated insert take two
// half-rate instructions. The sign bit of nb - centre is nb < centre for any
// two float32 values of which neither is -0 (a NaN difference is the
// positive canonical NaN, as nb < centre is false), so every warped and
// reference value is normalised by adding +0 first, which turns -0 into +0
// and changes no comparison. The reference census is built once a block by
// the same function, so both take the same bit order. The cost of a view is
// kept as its popcount; the two pixels of a lane's row travel packed as two
// 16-bit halves of one register: an out-of-view source's ceiling is merged
// in with one LOP3, the mean forms add the halves with one IADD, and the
// top-k form keeps NK ascending slots of such pairs and inserts a value with
// Hopper's 16x2 minimum and maximum (2 NK - 1 instructions for two pixels).
// The sums are integers until the write-out, where the one conversion and
// the product with the float32 reciprocal (or the IEEE division of the valid
// mean) give the reference's float value exactly. Each lane keeps its
// pixels' integer numerators and view counts for the block's planes (8, or
// 4 from 16 sources up) in shared memory (slots only it reads, so no
// barrier) and writes each pixel's chunk as 16-byte stores of `fused` and
// `nviews`, one a 4 planes (scalar stores where D % 4 != 0 or the chunk is
// cut short). The next
// view's shift is loaded one iteration ahead, and a warp whose source window
// lies inside the image loads it without bounds tests.

constexpr int kFastWarps = 4;     // warps a block, stacked vertically
constexpr int kFastPlanes = 8;    // most planes a block
constexpr int kMaxRegTopk = 8;    // top-k slots held in registers

template <int PATCH>
struct Fast {
  static constexpr int M = PATCH / 2;
  static constexpr int kRows = PATCH == 7 ? 4 : 6;   // output rows a lane owns
  static constexpr int kCol = kRows + 2 * M;         // warped rows a lane computes
  static constexpr int kWords = (PATCH * PATCH + 30) / 32;  // census words a pixel
  static constexpr int kOut = 64 - 2 * M;            // columns a warp writes
  static constexpr uint32_t kCeiling2 = (PATCH * PATCH - 1) * 0x00010001u;  // both halves
};

// census bit of neighbour (dy, dx): row-major over the patch, centre skipped
template <int PATCH>
__host__ __device__ constexpr int census_bit(int dy, int dx) {
  return (dy + PATCH / 2) * PATCH + (dx + PATCH / 2) - ((dy > 0 || (dy == 0 && dx > 0)) ? 1 : 0);
}

// value of lane (lane + dl) of the warp
__device__ __forceinline__ float lane_at(float v, int dl) {
  if (dl > 0) return __shfl_down_sync(kFull, v, dl);
  if (dl < 0) return __shfl_up_sync(kFull, v, -dl);
  return v;
}

__device__ __forceinline__ uint32_t min_u16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("min.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t max_u16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Census words of the lane's kRows x 2 pixels from its two columns' values
// v[c][i] (rows y0 - M + i; normalised, no -0). Bit census_bit(dy, dx) of a
// pixel is shifted in at its turn, so the first neighbour ends highest in
// word 0; patch 7's bits 32-47 go to word 1.
template <int PATCH>
__device__ __forceinline__ void census(const float (&v)[2][Fast<PATCH>::kCol],
                                       uint32_t (&bits)[Fast<PATCH>::kRows][2][Fast<PATCH>::kWords]) {
  using F = Fast<PATCH>;
  constexpr int M = F::M;
#pragma unroll
  for (int r = 0; r < F::kRows; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int k = 0; k < F::kWords; ++k) bits[r][c][k] = 0;
#pragma unroll
  for (int i = 0; i < F::kCol; ++i) {
    // the row's values at columns x0 - M .. x0 + 1 + M (x0: the lane's first)
    float row[2 + 2 * M];
#pragma unroll
    for (int j = 0; j < 2 + 2 * M; ++j) {
      const int col = j - M;
      const int dl = col >= 0 ? col / 2 : -((1 - col) / 2);  // floor(col / 2)
      row[j] = lane_at(v[col - 2 * dl][i], dl);
    }
#pragma unroll
    for (int r = 0; r < F::kRows; ++r) {
      const int dy = i - M - r;
      if (dy < -M || dy > M) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float centre = v[c][r + M];
#pragma unroll
        for (int dx = -M; dx <= M; ++dx) {
          if (dy == 0 && dx == 0) continue;
          uint32_t& word = bits[r][c][census_bit<PATCH>(dy, dx) / 32];
          word = __funnelshift_l(__float_as_uint(row[c + dx + M] - centre), word, 1);
        }
      }
    }
  }
}

// NK: top-k slots (k rounded up to even); 0 for the two mean forms
template <int PATCH, int NK>
__global__ void __launch_bounds__(kFastWarps * 32)
plane_sweep_fast_kernel(const float* __restrict__ ref, const float* __restrict__ src,
                        const float* __restrict__ shifts, float* __restrict__ fused,
                        int* __restrict__ nviews, int n_src, int h, int w, int n_planes,
                        int mode, int topk, int planes) {
  using F = Fast<PATCH>;
  constexpr int M = F::M;
  constexpr int R = F::kRows;
  constexpr int C = F::kCol;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = blockIdx.y * F::kOut - M + 2 * lane;  // this lane's first column
  const int y0 = (blockIdx.z * kFastWarps + warp) * R;  // first output row
  if (y0 >= h) return;  // whole warp: below the image (warps share nothing)

  // reference census, edge-clamped neighbours
  uint32_t ref_bits[R][2][F::kWords];
  {
    float v[2][C];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int xc = min(max(x0 + c, 0), w - 1);
#pragma unroll
      for (int i = 0; i < C; ++i)
        v[c][i] = __ldg(ref + static_cast<size_t>(min(max(y0 - M + i, 0), h - 1)) * w + xc) + 0.0f;
    }
    census<PATCH>(v, ref_bits);
  }

  const int d_first = blockIdx.x * planes;
  const int n_here = min(planes, n_planes - d_first);
  // each lane's results for the chunk, read back by the same lane at the end
  // (so registers do not hold them across the planes): the two pixels'
  // integer numerators (16 bits each) and view counts (8 bits each)
  __shared__ uint32_t s_num[kFastWarps][R][kFastPlanes][32];
  __shared__ uint16_t s_nv[kFastWarps][R][kFastPlanes][32];
  // what an out-of-view source adds: the ceiling, or nothing to the valid mean
  const uint32_t fill = (NK > 0 || mode == 0) ? F::kCeiling2 : 0u;
  const float u0 = static_cast<float>(x0), u1 = static_cast<float>(x0 + 1);
  const float v_lane = static_cast<float>(y0 + lane);  // lane r tests row y0 + r
  const float* sh = shifts + static_cast<size_t>(d_first) * n_src * 2;
  const int n_iter = n_here * n_src;
  float su = __ldg(sh), sv = __ldg(sh + 1);

  for (int dd = 0; dd < n_here; ++dd) {
    uint32_t acc[R];                     // mean forms: the cost sums
    uint32_t slot[R][NK > 0 ? NK : 1];  // top-k: ascending slots
    uint32_t nv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r] = 0;
      nv[r] = 0;
#pragma unroll
      for (int i = 0; i < (NK > 0 ? NK : 1); ++i) slot[r][i] = 0xffffffffu;
    }
    for (int s = 0; s < n_src; ++s) {
      const int e = min(dd * n_src + s + 1, n_iter - 1);  // the next view's shift, ahead
      const float su_next = __ldg(sh + 2 * e), sv_next = __ldg(sh + 2 * e + 1);
      const float i0f = floorf(su), j0f = floorf(sv);
      const float fu = su - i0f, fv = sv - j0f;
      const float gu = 1.0f - fu, gv = 1.0f - fv;
      const int xs = x0 + static_cast<int>(i0f);
      const int ys = y0 - M + static_cast<int>(j0f);
      const float* img = src + static_cast<size_t>(s) * h * w;
      // horizontal lerps of the C + 1 source rows at the lane's two columns,
      // then the vertical ones, in the reference's order: a * (1 - fu) +
      // b * fu, top * (1 - fv) + bot * fv
      float ha[C + 1], hb[C + 1];
      if (__all_sync(kFull, xs >= 0 && xs + 2 < w && ys >= 0 && ys + C < h)) {
        const float* p = img + static_cast<size_t>(ys) * w + xs;
#pragma unroll
        for (int i = 0; i < C + 1; ++i) {
          const float a = __ldg(p + static_cast<size_t>(i) * w);
          const float b = __ldg(p + static_cast<size_t>(i) * w + 1);
          const float c = __ldg(p + static_cast<size_t>(i) * w + 2);
          ha[i] = a * gu + b * fu;
          hb[i] = b * gu + c * fu;
        }
      } else {
        const bool c0 = static_cast<unsigned>(xs) < static_cast<unsigned>(w);
        const bool c1 = static_cast<unsigned>(xs + 1) < static_cast<unsigned>(w);
        const bool c2 = static_cast<unsigned>(xs + 2) < static_cast<unsigned>(w);
#pragma unroll
        for (int i = 0; i < C + 1; ++i) {
          const int yy = ys + i;
          const bool rv = static_cast<unsigned>(yy) < static_cast<unsigned>(h);
          const size_t at = static_cast<size_t>(rv ? yy : 0) * w + xs;
          const float a = rv && c0 ? __ldg(img + at) : 0.0f;
          const float b = rv && c1 ? __ldg(img + at + 1) : 0.0f;
          const float c = rv && c2 ? __ldg(img + at + 2) : 0.0f;
          ha[i] = a * gu + b * fu;
          hb[i] = b * gu + c * fu;
        }
      }
      float v[2][C];
#pragma unroll
      for (int i = 0; i < C; ++i) {
        v[0][i] = (ha[i] * gv + ha[i + 1] * fv) + 0.0f;
        v[1][i] = (hb[i] * gv + hb[i + 1] * fv) + 0.0f;
      }
      uint32_t bits[R][2][F::kWords];
      census<PATCH>(v, bits);

      // in view: the reference kernel's float test of u + su2 and v + sv2
      const float su2 = i0f + fu, sv2 = j0f + fv;
      const bool ok0 = u0 + su2 >= 0.0f && u0 + su2 <= static_cast<float>(w - 1);
      const bool ok1 = u1 + su2 >= 0.0f && u1 + su2 <= static_cast<float>(w - 1);
      const uint32_t cols_in = (ok0 ? 0x0000ffffu : 0u) | (ok1 ? 0xffff0000u : 0u);
      const unsigned rows_in = __ballot_sync(
          kFull, v_lane + sv2 >= 0.0f && v_lane + sv2 <= static_cast<float>(h - 1));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t in = (rows_in >> r) & 1u ? cols_in : 0u;
        uint32_t cost = 0;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          int p = 0;
#pragma unroll
          for (int k = 0; k < F::kWords; ++k) p += __popc(bits[r][c][k] ^ ref_bits[r][c][k]);
          cost |= static_cast<uint32_t>(p) << (16 * c);
        }
        const uint32_t val = (cost & in) | (fill & ~in);
        nv[r] += in & 0x00010001u;
        if (NK > 0) {
#pragma unroll
          for (int i = (NK > 0 ? NK : 1) - 1; i > 0; --i)
            slot[r][i] = min_u16x2(slot[r][i], max_u16x2(slot[r][i - 1], val));
          slot[r][0] = min_u16x2(slot[r][0], val);
        } else {
          acc[r] += val;
        }
      }
      su = su_next;
      sv = sv_next;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      uint32_t num = acc[r];
      if (NK > 0) {
        num = slot[r][0];
#pragma unroll
        for (int i = 1; i < (NK > 0 ? NK : 1); ++i)
          if (i < topk) num += slot[r][i];
      }
      s_num[warp][r][dd][lane] = num;
      s_nv[warp][r][dd][lane] = static_cast<uint16_t>(nv[r] | (nv[r] >> 8));
    }
  }

  const float inv = 1.0f / static_cast<float>(NK > 0 ? topk : n_src);
  const bool vec = n_here % 4 == 0 && n_planes % 4 == 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int y = y0 + r;
    if (y >= h) break;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int x = x0 + c;
      if (2 * lane + c < M || 2 * lane + c >= 64 - M || x >= w) continue;
      float out[kFastPlanes];
      int cnt[kFastPlanes];
#pragma unroll
      for (int dd = 0; dd < kFastPlanes; ++dd) {  // past n_here: never stored
        const float num = static_cast<float>((s_num[warp][r][dd][lane] >> (16 * c)) & 0xffffu);
        cnt[dd] = (s_nv[warp][r][dd][lane] >> (8 * c)) & 0xff;
        out[dd] = (NK == 0 && mode == 1) ? num / static_cast<float>(max(cnt[dd], 1)) : num * inv;
      }
      const size_t o = (static_cast<size_t>(y) * w + x) * n_planes + d_first;
      if (vec) {
#pragma unroll
        for (int q = 0; q < kFastPlanes / 4; ++q) {
          if (4 * q >= n_here) break;
          reinterpret_cast<float4*>(fused + o)[q] =
              make_float4(out[4 * q], out[4 * q + 1], out[4 * q + 2], out[4 * q + 3]);
          reinterpret_cast<int4*>(nviews + o)[q] =
              make_int4(cnt[4 * q], cnt[4 * q + 1], cnt[4 * q + 2], cnt[4 * q + 3]);
        }
      } else {
#pragma unroll
        for (int dd = 0; dd < kFastPlanes; ++dd) {
          if (dd < n_here) {
            fused[o + dd] = out[dd];
            nviews[o + dd] = cnt[dd];
          }
        }
      }
    }
  }
}

template <int PATCH>
cudaError_t launch_fast(const float* ref, const float* src, const float* shifts, float* fused,
                        int* nviews, int n_src, int h, int w, int n_planes, int mode, int topk,
                        cudaStream_t stream) {
  using F = Fast<PATCH>;
  // planes a block: 4 where a plane has many sources to sweep (a block's
  // fixed work, the reference census and the write-out, is then small beside
  // its 4 * n_src views, and the smaller blocks shorten the last wave), else 8
  const int planes = n_src >= 16 ? 4 : 8;
  // the chunks of planes first, so that a pixel's chunks run side by side and
  // their stores meet in L2 sector by sector
  const dim3 grid((n_planes + planes - 1) / planes, (w + F::kOut - 1) / F::kOut,
                  (h + kFastWarps * F::kRows - 1) / (kFastWarps * F::kRows));
  const dim3 block(kFastWarps * 32);
#define SVT_FAST(NK)                                                                \
  plane_sweep_fast_kernel<PATCH, NK><<<grid, block, 0, stream>>>(                  \
      ref, src, shifts, fused, nviews, n_src, h, w, n_planes, mode, topk, planes)
  // top-k slots: k rounded up to even (the sum takes the first k)
  switch (mode == 2 ? (topk + 1) & ~1 : 0) {
    case 0: SVT_FAST(0); break;
    case 2: SVT_FAST(2); break;
    case 4: SVT_FAST(4); break;
    case 6: SVT_FAST(6); break;
    default: SVT_FAST(8); break;
  }
#undef SVT_FAST
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
