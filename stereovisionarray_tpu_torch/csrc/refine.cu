// The multi-view refinement's static-candidate-stack pass: every candidate
// offset of one pass scored, the winner picked and refined, in two entry
// points of three kernels instead of the plain route's ~2,300 PyTorch
// launches (ops/refine.py::_stack_costs and _select_best).
//
// The reference (stereovisionarray_tpu/ops/refine.py) has no Pallas kernel
// here: this file replaces a plain PyTorch route, and its contract is that
// route's bits on the card. Every float32 operation the plain route performs
// is performed here, rounded where PyTorch rounds (__fadd_rn, __fmul_rn,
// __fsub_rn, __fdiv_rn; built with -fmad=false), and every sum is taken in
// the order PyTorch's CUDA kernels take it:
//  - the sum over views (diffs.sum(dim=0) of a (V, H, W) stack): one thread
//    an output, four accumulators (Reduce.cuh's vt0 = 4): view v goes to
//    accumulator v % 4, each from +0 in ascending v, then
//    ((a0 + a1) + a2) + a3. That holds while one thread sums all V values,
//    V < 64 at every output vector width (kMaxViews);
//  - the cumulative sum along W (tensor_kernel_scan_innermost_dim in
//    ATen/native/cuda/ScanUtils.cuh): chunks of 2 * nx elements, the running
//    total added to each chunk's first element, then a Sklansky scan of the
//    chunk; nx = 2^log_nx from get_log_num_threads_x_inner_scan(H, W)
//    (log_scan_width below). A single row or column is scanned by another
//    algorithm (cub's), so a box window needs H, W >= 2;
//  - the cumulative sum along H (tensor_kernel_scan_outer_dim): sequential
//    down each column from +0;
//  - each box sum's window difference hi - (lo or 0), one rounding.
// The in-view counts are small integers: their sums are exact in any order
// and are taken in int32.
//
// The candidates are never staged as a stack: each stack entry s of view v
// is the plain route's _static_shift, sampled where it is needed from the
// view itself (zero outside it, as the padded view reads), with the host's
// float32 weights. The table (ops/refine.py::_kernel_table) holds, as int32:
//   [0, num)            the offsets' float32 bits
//   [num, num + 8V)     per view: s_lo, s_hi, first entry, q, bu, bv, blen
//                       (float32 bits), 0
//   entries, from a multiple of 8: per stack step, i0, j0, exact, 0,
//                       1 - fu, fu, 1 - fv, fv (float32 bits)
//
// Kernels:
//  - refine_rows_kernel: up to 8 (offset, row) rows a block of 256 threads;
//    the rows' data terms (views, candidate lerp or hat blend, in-view
//    test, |ref - warped|, the sums) computed at once into shared memory,
//    each row scanned there (PyTorch's chunked Sklansky additions, regrouped
//    so that only each chunk's spine waits for the chunk before it), then
//    its window differences written out (for a window of 1, the data terms
//    alone);
//  - refine_cols_kernel: one (offset, column) a thread: the sequential scan
//    down the column, each batch of 32 rows loaded while the one before it
//    is added;
//  - refine_select_kernel: one pixel a thread: the column window's
//    difference, the fused cost of every offset, the first minimum
//    (torch.min's tie rule, a NaN first), the parabola and the outputs.
//
// What bounds it on the H100: instruction issue and latency, far from
// either roofline. A CROSS pass at 270x360 (11 offsets, 4 views) is ~4 M
// view terms of ~30 flops (~2 us at 67 TFLOP/s) and ~3.6 MB of inputs and
// outputs (~1 us of HBM); its intermediates (4 planes of 11 x 97,200 words)
// stay in L2. Each view term takes ~100 instructions (the table lookups,
// bounds tests and two cached reads of the view besides the flops), and the
// order the sums must keep is serial in two places: the column scan walks H
// rows one after another in only O x W threads, and each chunk of a row
// scan waits for the chunk before it. The design keeps those chains short:
// every data term of a row is computed before its scan starts, the scan's
// serial part is the chunks' spines alone, and the column walk loads a
// batch of rows ahead.

#include "common.cuh"

#include <cmath>

namespace {

constexpr int kSelectThreads = 256;
constexpr int kColThreads = 128;
constexpr int kColBatch = 32;  // rows of a column loaded ahead of its scan
constexpr int kRowThreads = 256;
constexpr int kRowsPerBlock = 8;
constexpr size_t kStaticSmem = 48 * 1024;
// PyTorch's CUDA sum over the view axis keeps one thread on an output, in
// the order data_term follows, while there are fewer views than 16 times the
// reduction block's height (Reduce.cuh's setReduceConfig: 64 at the widest
// output vectors)
constexpr int kMaxViews = 63;

// log2 of the threads torch.cumsum along the last axis gives each row on
// CUDA: ATen's get_log_num_threads_x_inner_scan in its uint32 arithmetic
// (a difference that wraps gives 9). Each scanned chunk is twice that wide.
int log_scan_width(unsigned num_rows, unsigned row_size) {
  unsigned lx = 0, ly = 0;
  while ((1u << lx) < row_size) ++lx;
  while ((1u << ly) < num_rows) ++ly;
  const unsigned l = (9u + (lx - ly)) / 2u;
  return static_cast<int>(l < 4u ? 4u : (l > 9u ? 9u : l));
}

// How refine_rows_kernel runs a pass: PyTorch's chunk width (log2), the
// (offset, row) rows a block and its dynamic shared memory (the views'
// headers, then each row's W floats, W ints and their chunks' spines: as
// many rows as fit in 48 KB, else one, opted in). refusal is 0 when
// svt_refine_costs takes the pass: else 1 (views outside 1..kMaxViews), 2 (a
// box window on fewer than two rows or columns), 3 (one row's scan is more
// shared memory than a block of the current device can opt into).
struct RowPlan {
  int log_nx, rows;
  size_t smem;
  int refusal;
};

RowPlan row_plan(int views, int h, int w, int box) {
  RowPlan p{0, kRowsPerBlock, 0, 0};
  if (views < 1 || views > kMaxViews) {
    p.refusal = 1;
    return p;
  }
  if (box && (h < 2 || w < 2)) {
    p.refusal = 2;
    return p;
  }
  p.log_nx = log_scan_width(static_cast<unsigned>(h), static_cast<unsigned>(w));
  const size_t head = static_cast<size_t>(views) * 8 * sizeof(int);
  const int chunk = 2 << p.log_nx, nchunks = (w + chunk - 1) / chunk;
  const size_t row_bytes =
      (static_cast<size_t>(w) + static_cast<size_t>(nchunks) * (p.log_nx + 2)) *
      (sizeof(float) + sizeof(int));
  while (p.rows > 1 && head + p.rows * row_bytes > kStaticSmem) p.rows /= 2;
  p.smem = head + (box ? p.rows * row_bytes : 0);
  if (p.smem > kStaticSmem) {
    int dev = 0, optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) {
      cudaGetLastError();  // leave no error behind for the next launch to report
      optin = static_cast<int>(kStaticSmem);
    }
    if (p.smem > static_cast<size_t>(optin)) p.refusal = 3;
  }
  return p;
}

struct View {
  int s_lo, s_hi, off, q;
  float bu, bv, blen;
};

// view v's header, from the block's shared copy of the table's headers
__device__ __forceinline__ View load_view(const int* hdr, int v) {
  const int* p = hdr + 8 * v;
  View r;
  r.s_lo = p[0];
  r.s_hi = p[1];
  r.off = p[2];
  r.q = p[3];
  r.bu = __int_as_float(p[4]);
  r.bv = __int_as_float(p[5]);
  r.blen = __int_as_float(p[6]);
  return r;
}

// torch.clamp_min(v, 0.0): NaN passes through
__device__ __forceinline__ float clamp_min0(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }

// torch.clamp(v, lo, hi): NaN passes through
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// Stack entry s of a view (clipped to [s_lo, s_hi], as the plain route's
// gather index is) at pixel (y, x): _static_shift of the zero-padded view.
__device__ __forceinline__ float stack_entry(const float* __restrict__ img,
                                             const int* __restrict__ table, const View& vw,
                                             long long s, int y, int x, int h, int w) {
  s = s < vw.s_lo ? vw.s_lo : (s > vw.s_hi ? vw.s_hi : s);
  const int4* e = reinterpret_cast<const int4*>(table + vw.off + 8 * static_cast<int>(s - vw.s_lo));
  const int4 a = __ldg(e);
  const int yy = y + a.y, xx = x + a.x;
  auto px = [&](int dy, int dx) {
    const int yi = yy + dy, xi = xx + dx;
    return (yi >= 0 && yi < h && xi >= 0 && xi < w) ? __ldg(img + static_cast<size_t>(yi) * w + xi)
                                                    : 0.0f;
  };
  if (a.z) return px(0, 0);
  const int4 b = __ldg(e + 1);
  const float wu0 = __int_as_float(b.x), wu1 = __int_as_float(b.y);
  const float wv0 = __int_as_float(b.z), wv1 = __int_as_float(b.w);
  const float top = __fadd_rn(__fmul_rn(px(0, 0), wu0), __fmul_rn(px(0, 1), wu1));
  const float bot = __fadd_rn(__fmul_rn(px(1, 0), wu0), __fmul_rn(px(1, 1), wu1));
  return __fadd_rn(__fmul_rn(top, wv0), __fmul_rn(bot, wv1));
}

struct CostArgs {
  const float* ref;   // (H, W)
  const float* aux;   // (V, H, W)
  const float* disp;  // (H, W)
  const int* table;
  int views, num, h, w, integer;
  float rs;  // float32(radius * step)
};

// One view's |ref - warped| where the candidate is in view (0 elsewhere),
// and whether it is.
__device__ __forceinline__ float view_term(const CostArgs& a, const int* hdr, int v, int o,
                                           int y, int x, float d, float dn, float ref, bool& ok) {
  const View vw = load_view(hdr, v);
  const float ua = __fadd_rn(static_cast<float>(x), __fmul_rn(dn, vw.bu));
  const float va = __fadd_rn(static_cast<float>(y), __fmul_rn(dn, vw.bv));
  ok = ua >= 0.0f && ua <= static_cast<float>(a.w - 1) && va >= 0.0f &&
       va <= static_cast<float>(a.h - 1) && dn > 0.0f;
  const float* img = a.aux + static_cast<size_t>(v) * a.h * a.w;
  float warped;
  if (a.integer) {
    // candidate o: the lerp of entries i0 + o*q and i0 + o*q + 1, where
    // t0 = (d - radius*step) * blen
    const float t0 = __fmul_rn(__fsub_rn(d, a.rs), vw.blen);
    const float i0f = floorf(t0);
    const float f = __fsub_rn(t0, i0f);
    const long long j = static_cast<long long>(i0f) + static_cast<long long>(o) * vw.q;
    warped = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, f), stack_entry(img, a.table, vw, j, y, x, a.h, a.w)),
                       __fmul_rn(f, stack_entry(img, a.table, vw, j + 1, y, x, a.h, a.w)));
  } else {
    // hat blend at t = clamp((d + delta) * blen, s_lo, s_hi)
    const float t = clamp_nan(__fmul_rn(dn, vw.blen), static_cast<float>(vw.s_lo),
                              static_cast<float>(vw.s_hi));
    const float s0 = floorf(t);
    const float w0 = clamp_min0(__fsub_rn(1.0f, fabsf(__fsub_rn(t, s0))));
    const float w1 = clamp_min0(__fsub_rn(1.0f, fabsf(__fsub_rn(t, __fadd_rn(s0, 1.0f)))));
    const long long j = static_cast<long long>(s0);
    warped = __fadd_rn(__fmul_rn(w0, stack_entry(img, a.table, vw, j, y, x, a.h, a.w)),
                       __fmul_rn(w1, stack_entry(img, a.table, vw, j + 1, y, x, a.h, a.w)));
  }
  return ok ? fabsf(__fsub_rn(ref, warped)) : 0.0f;
}

// The data term of offset o at pixel (y, x): the views' differences summed
// in the order of PyTorch's reduction over the view axis, and the in-view
// count.
__device__ __forceinline__ void data_term(const CostArgs& a, const int* hdr, int o, int y, int x,
                                          float& sum, int& count) {
  const int pix = y * a.w + x;
  const float d = __ldg(a.disp + pix);
  const float ref = __ldg(a.ref + pix);
  const float dn = __fadd_rn(d, __int_as_float(__ldg(a.table + o)));
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int n = 0;
  for (int v0 = 0; v0 < a.views; v0 += 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (v0 + k < a.views) {
        bool ok;
        acc[k] = __fadd_rn(acc[k], view_term(a, hdr, v0 + k, o, y, x, d, dn, ref, ok));
        n += ok;
      }
    }
  }
  sum = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
  count = n;
}

// `rows` (offset, row) rows of num * H a block of kRowThreads. With kScan:
// the rows' data terms, all at once into shared memory; each row scanned in
// place in PyTorch's chunked Sklansky order; then the window differences
// hi - (lo or 0) written out (b1, nb1). Without: the data terms themselves.
// Shared memory: the views' headers, then `rows` rows of W floats, of W
// ints, and of each chunk's spine (L + 2 floats, L + 2 ints).
template <bool kScan>
__global__ void __launch_bounds__(kRowThreads)
    refine_rows_kernel(CostArgs a, float* __restrict__ b1, int* __restrict__ nb1, int r,
                       int log_nx, int rows) {
  extern __shared__ int smem_i[];
  const int nx = 1 << log_nx, chunk = 2 * nx, w = a.w;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, a.num * a.h - row0);
  const int nchunks = (w + chunk - 1) / chunk, spine_len = log_nx + 2;
  int* hdr = smem_i;
  float* rb = reinterpret_cast<float*>(hdr + 8 * a.views);
  int* nrb = reinterpret_cast<int*>(rb + rows * w);
  float* spine = reinterpret_cast<float*>(nrb + rows * w);
  int* nspine = reinterpret_cast<int*>(spine + rows * nchunks * spine_len);
  for (int i = tid; i < 8 * a.views; i += kRowThreads) hdr[i] = __ldg(a.table + a.num + i);
  __syncthreads();
  for (int e = tid; e < nrows * w; e += kRowThreads) {
    const int rr = e / w, x = e % w, row = row0 + rr;
    float sum;
    int n;
    data_term(a, hdr, row / a.h, row % a.h, x, sum, n);
    if (kScan) {
      rb[e] = sum;
      nrb[e] = n;
    } else {
      b1[static_cast<size_t>(row0) * w + e] = sum;
      nb1[static_cast<size_t>(row0) * w + e] = n;
    }
  }
  if (!kScan) return;
  __syncthreads();
  // tensor_kernel_scan_innermost_dim's chunked Sklansky scan, its own
  // additions regrouped but not reordered. In a chunk of 2^(L+1) elements,
  // step m adds to each element i of an upper half the last element of the
  // lower half of its 2^(m+1)-block. Only the first block's additions (i in
  // [2^m, 2^(m+1)), which add final(2^m - 1)) depend on the previous chunk's
  // total, which PyTorch adds to element 0 first. So:
  //  1. every other addition of every chunk, all at once: each element then
  //     holds pre(i), its value before its own first-block step;
  //  2. one thread a row walks the spine chunk by chunk: final(0) = pre(0) +
  //     total, final(2^(m+1) - 1) = pre(2^(m+1) - 1) + final(2^m - 1);
  //  3. every element i in [2^m, 2^(m+1)): final(i) = pre(i) + final(2^m - 1).
  // An element past the row's end is never read by one inside it, so the
  // last chunk's zero padding is left out.
  for (int m = 0; m <= log_nx; ++m) {
    const int s = 1 << m, upper = nx - s;  // the steps' threads t in [s, nx)
    for (int vt = tid; vt < nrows * nchunks * upper; vt += kRowThreads) {
      const int t = s + vt % upper, rc = vt / upper;
      const int rr = rc / nchunks, bc = (rc % nchunks) * chunk;
      const int base = ((t >> m) << (m + 1)) | s;
      const int ti = bc + base + (t % s), si = bc + base - 1;
      if (ti < w) {
        rb[rr * w + ti] = __fadd_rn(rb[rr * w + ti], rb[rr * w + si]);
        nrb[rr * w + ti] += nrb[rr * w + si];
      }
    }
    __syncthreads();
  }
  // the spine, final(2^k - 1) for k = 0..L+1, of each (row, chunk)
  for (int rr = tid; rr < nrows; rr += kRowThreads) {
    float total = 0.0f;
    int ntotal = 0;
    const float* line = rb + rr * w;
    const int* nline = nrb + rr * w;
    for (int c = 0; c < nchunks; ++c) {
      const int bc = c * chunk;
      float* sp = spine + (rr * nchunks + c) * spine_len;
      int* nsp = nspine + (rr * nchunks + c) * spine_len;
      total = __fadd_rn(line[bc], total);
      ntotal += nline[bc];
      sp[0] = total;
      nsp[0] = ntotal;
      for (int k = 1; k <= log_nx + 1 && bc + (1 << k) - 1 < w; ++k) {
        total = __fadd_rn(line[bc + (1 << k) - 1], total);
        ntotal += nline[bc + (1 << k) - 1];
        sp[k] = total;
        nsp[k] = ntotal;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < nrows * w; e += kRowThreads) {
    const int rr = e / w, x = e % w, c = x / chunk, i = x % chunk;
    const int at = (rr * nchunks + c) * spine_len + (i ? 31 - __clz(i) : 0);
    rb[e] = i ? __fadd_rn(rb[e], spine[at]) : spine[at];
    nrb[e] = i ? nrb[e] + nspine[at] : nspine[at];
  }
  __syncthreads();
  for (int e = tid; e < nrows * w; e += kRowThreads) {
    const int x = e % w, line = e - x;
    const int hi = line + min(x + r, w - 1), lo = x - r - 1;
    b1[static_cast<size_t>(row0) * w + e] = __fsub_rn(rb[hi], lo >= 0 ? rb[line + lo] : 0.0f);
    nb1[static_cast<size_t>(row0) * w + e] = nrb[hi] - (lo >= 0 ? nrb[line + lo] : 0);
  }
}

// (offset, column) of num * W: the sequential scan down the column of the
// row windows, each batch of kColBatch rows loaded while the one before it
// is added.
__global__ void __launch_bounds__(kColThreads)
    refine_cols_kernel(const float* __restrict__ b1, const int* __restrict__ nb1,
                       float* __restrict__ c2, int* __restrict__ n2, int num, int h, int w) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= num * w) return;
  const int o = idx / w, x = idx % w;
  const size_t col = static_cast<size_t>(o) * h * w + x;
  float b[kColBatch], next_b[kColBatch];
  int nb[kColBatch], next_nb[kColBatch];
  auto load = [&](int y0, float* vb, int* vnb) {
#pragma unroll
    for (int k = 0; k < kColBatch; ++k) {
      if (y0 + k < h) {
        vb[k] = __ldg(b1 + col + static_cast<size_t>(y0 + k) * w);
        vnb[k] = __ldg(nb1 + col + static_cast<size_t>(y0 + k) * w);
      }
    }
  };
  load(0, b, nb);
  float acc = 0.0f;
  int nacc = 0;
  for (int y0 = 0; y0 < h; y0 += kColBatch) {
    if (y0 + kColBatch < h) load(y0 + kColBatch, next_b, next_nb);
#pragma unroll
    for (int k = 0; k < kColBatch; ++k) {
      if (y0 + k < h) {
        acc = __fadd_rn(acc, b[k]);
        nacc += nb[k];
        c2[col + static_cast<size_t>(y0 + k) * w] = acc;
        n2[col + static_cast<size_t>(y0 + k) * w] = nacc;
      }
      b[k] = next_b[k];
      nb[k] = next_nb[k];
    }
  }
}

struct SelectArgs {
  const float* c2;  // (num, H, W): column scans, or the totals themselves (box 0)
  const int* n2;
  const float* disp;
  const unsigned char* mask;  // (H, W) bool or null
  float* out_disp;
  float* out_delta;
  float* out_cost;
  unsigned char* out_valid;
  int num, h, w, r, box, subpixel;
  float step;
};

// fused cost of offset o at (y, x), and whether any view was in bounds
__device__ __forceinline__ float fused_cost(const SelectArgs& a, int o, int y, int x, bool& any) {
  const size_t plane = static_cast<size_t>(o) * a.h * a.w;
  float tc;
  int tn;
  if (a.box) {
    const size_t hi = plane + static_cast<size_t>(min(y + a.r, a.h - 1)) * a.w + x;
    const int lo_y = y - a.r - 1;
    const size_t lo = plane + static_cast<size_t>(lo_y >= 0 ? lo_y : 0) * a.w + x;
    tc = __fsub_rn(__ldg(a.c2 + hi), lo_y >= 0 ? __ldg(a.c2 + lo) : 0.0f);
    tn = __ldg(a.n2 + hi) - (lo_y >= 0 ? __ldg(a.n2 + lo) : 0);
  } else {
    const size_t p = plane + static_cast<size_t>(y) * a.w + x;
    tc = __ldg(a.c2 + p);
    tn = __ldg(a.n2 + p);
  }
  const float fn = static_cast<float>(tn);
  any = fn > 0.0f;
  const float fused = __fdiv_rn(tc, isnan(fn) ? fn : fmaxf(fn, 1.0f));
  return any ? fused : svt::kBigFloat;
}

__global__ void __launch_bounds__(kSelectThreads) refine_select_kernel(SelectArgs a) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= a.h * a.w) return;
  const int y = pix / a.w, x = pix % a.w;
  // torch.min over offsets: the first minimum, a NaN before any number
  int best = 0;
  bool valid;
  float best_cost = fused_cost(a, 0, y, x, valid);
  for (int o = 1; o < a.num; ++o) {
    bool any;
    const float c = fused_cost(a, o, y, x, any);
    const bool take = isnan(c) ? !isnan(best_cost) : (!isnan(best_cost) && c < best_cost);
    if (take) {
      best = o;
      best_cost = c;
      valid = any;
    }
  }
  const int radius = (a.num - 1) / 2;
  float delta = __fmul_rn(__fsub_rn(static_cast<float>(best), static_cast<float>(radius)), a.step);
  if (a.subpixel && a.num >= 3) {
    const int bm = min(max(best, 1), a.num - 2);
    bool unused;
    const float cm1 = fused_cost(a, bm - 1, y, x, unused);
    const float c0 = fused_cost(a, bm, y, x, unused);
    const float cp1 = fused_cost(a, bm + 1, y, x, unused);
    const float denom = __fadd_rn(__fsub_rn(cm1, __fmul_rn(2.0f, c0)), cp1);
    const bool nonflat = fabsf(denom) > static_cast<float>(1e-9);
    float frac = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(cm1, cp1)), nonflat ? denom : 1.0f);
    frac = clamp_nan(nonflat ? frac : 0.0f, -0.5f, 0.5f);
    const bool interior = best >= 1 && best <= a.num - 2;
    delta = __fadd_rn(delta, __fmul_rn(interior ? frac : 0.0f, a.step));
  }
  const bool apply = valid && (a.mask == nullptr || a.mask[pix] != 0);
  const float d = __ldg(a.disp + pix);
  a.out_disp[pix] = clamp_min0(apply ? __fadd_rn(d, delta) : d);
  a.out_delta[pix] = apply ? delta : 0.0f;
  a.out_cost[pix] = best_cost;
  a.out_valid[pix] = valid ? 1 : 0;
}

}  // namespace

// ref (H, W), aux (V, H, W), disp (H, W) f32; table as above (int32); c1, n1
// (num, H, W) f32 / int32 scratch for the row windows; c2, n2 the same for
// the column scans (unused when box == 0, where c1 and n1 receive the data
// terms themselves). r: the window's half width. integer: the candidates are
// lerps of stack entries q apart (else the hat blend); rs =
// float32(radius * step). A pass svt_refine_refusal refuses is
// cudaErrorInvalidValue.
SVT_API int svt_refine_costs(const void* ref, const void* aux, const void* disp,
                             const void* table, void* c1, void* n1, void* c2, void* n2, int views,
                             int num, int h, int w, int r, int box, int integer, float rs,
                             void* stream) {
  if (num <= 0 || h <= 0 || w <= 0 || r < 0 ||
      static_cast<long long>(num) * h * w > 0x7fffffffLL ||
      (reinterpret_cast<uintptr_t>(table) & 15) != 0)
    return cudaErrorInvalidValue;
  const RowPlan p = row_plan(views, h, w, box);
  if (p.refusal) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  CostArgs a{static_cast<const float*>(ref), static_cast<const float*>(aux),
             static_cast<const float*>(disp), static_cast<const int*>(table),
             views, num, h, w, integer, rs};
  const unsigned blocks = static_cast<unsigned>((num * h + p.rows - 1) / p.rows);
  if (!box) {
    refine_rows_kernel<false><<<blocks, kRowThreads, p.smem, s>>>(
        a, static_cast<float*>(c1), static_cast<int*>(n1), 0, p.log_nx, p.rows);
    return cudaGetLastError();
  }
  if (p.smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        refine_rows_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem));
    if (err != cudaSuccess) return err;
  }
  refine_rows_kernel<true><<<blocks, kRowThreads, p.smem, s>>>(
      a, static_cast<float*>(c1), static_cast<int*>(n1), r, p.log_nx, p.rows);
  refine_cols_kernel<<<(num * w + kColThreads - 1) / kColThreads, kColThreads, 0, s>>>(
      static_cast<const float*>(c1), static_cast<const int*>(n1), static_cast<float*>(c2),
      static_cast<int*>(n2), num, h, w);
  return cudaGetLastError();
}

// Whether svt_refine_costs takes a pass of `views` views on (h, w), with a
// box window (box 1) or without, on the current device: 0, or the reason it
// does not (RowPlan's refusal). The stream is not used.
SVT_API int svt_refine_refusal(int views, int h, int w, int box, void* stream) {
  (void)stream;
  return row_plan(views, h, w, box).refusal;
}

// c2, n2: svt_refine_costs' column scans (box 1) or data terms (box 0);
// disp (H, W) f32; mask (H, W) bool or null; outputs (H, W): disparity,
// delta, cost (f32) and valid (bool). step = float32(step).
SVT_API int svt_refine_select(const void* c2, const void* n2, const void* disp, const void* mask,
                              void* out_disp, void* out_delta, void* out_cost, void* out_valid,
                              int num, int h, int w, int r, int box, int subpixel, float step,
                              void* stream) {
  if (num <= 0 || h <= 0 || w <= 0 || r < 0) return cudaErrorInvalidValue;
  SelectArgs a{static_cast<const float*>(c2), static_cast<const int*>(n2),
               static_cast<const float*>(disp), static_cast<const unsigned char*>(mask),
               static_cast<float*>(out_disp), static_cast<float*>(out_delta),
               static_cast<float*>(out_cost), static_cast<unsigned char*>(out_valid),
               num, h, w, r, box, subpixel, step};
  const unsigned blocks = static_cast<unsigned>((h * w + kSelectThreads - 1) / kSelectThreads);
  refine_select_kernel<<<blocks, kSelectThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
