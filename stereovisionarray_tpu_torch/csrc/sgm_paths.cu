// K2/K3: the integer SGM path scans, 4 or 8 paths summed into the int16
// total by one entry point (svt_sgm_paths).
// K7 (float costs): the same scans in float32, summed in each reference
// route's order: the strip route over all four sweeps (see "K7's strip
// route" below), else the generic form, each path into a partial of its own
// then an ordered combine (see "Float aggregation" below).
//
// Replaces stereovisionarray_tpu/ops/sgm_pallas.py::_sweep_kernel_hdw_stacked
// (via _sweep_hdw_stacked: the vertical path group, axis path + both
// diagonals, down or up), ::_sweep_kernel_hdw (via _sweep_hdw: one
// horizontal sweep, or a vertical one with 4 paths) and the sweep half of
// ::_rl_extract_kernel. On the TPU the grid ran in order, so a (3D, N) carry
// in VMEM relayed each row to the next, diagonals shifted that carry by a lane
// roll, and the horizontal sweeps needed a transposed (W, D, H) twin volume.
//
// Here every path is what it is mathematically: a set of independent 1-D
// lines (W columns for the vertical paths, H rows for the horizontal ones,
// H + W - 1 lines for each diagonal). A line's first pixel starts fresh with
// L = C, which is exactly what the reference's BIG-filled shifted carry and
// first-row 3*C produce; the recurrence
//   L = C + min(prev, min(prev[d-1], prev[d+1]) + P1, m + P2) - m,
//   m = min_d' prev,
// runs in int32 with the reference's BIG = 16000 at d = -1 and d = D. P2 is
// the map value at the pixel being updated: p2_y on vertical and diagonal
// paths, p2_x on horizontal ones.
//
// Integer design (sgm_family_staged_kernel, sgm_family_scalar_kernel). The
// paths pair up into four families of the same lines walked both ways:
// down/up, left->right/right->left, down-right/up-left, down-left/up-right.
// One group of L lanes owns one line of a family: it walks the line forward,
// adding that path's L into an int16 buffer, then walks it back adding the
// reverse path's. Every pixel lies on exactly one line of a family, so each
// element of a family's buffer has one owner: no atomics. Every walk runs in one launch, each into a buffer of
// its own (the vertical family into the total; left->right, right->left and
// each diagonal family into int16 partials), and a sum pass adds the
// partials into the total. Nothing is zero-filled and there is no int32
// total to narrow: each path's L is int32 arithmetic, added into the int16
// storage with wrap, which equals the int32 sum narrowed to int16
// (two's-complement addition is modular; the order of integer adds is free).
// A lane holds 8 consecutive d of a pixel, so a line takes L = D / 8 lanes
// rounded up to a power of two (32 / L lines a warp). min_d' is a register
// min and a log2(L)-step __shfl_xor_sync butterfly within the line's lanes;
// the neighbours d -/+ 1 across lanes are __shfl_up/down_sync. Loads leave
// the serial chain: where D % 8 == 0 and the buffers align (every main
// path), each lane stages its 8 costs, on the way back its 8 values of the
// buffer, and its P2 for the next kStages steps in shared memory with
// cp.async, and writes its 8 sums with one 128-bit store; a scalar form of
// the same walk (any D, any alignment) loads each value on its own a step
// ahead.
//
// What bounds it on the H100: each step of a line depends on the one before,
// so the walks take their longest chain of steps times a step's latency (the
// shuffles and mins), and the bytes: the costs read by every walk, each
// buffer written, re-read by the way back, summed (~1.1 GB at 540x768x64 with
// 8 paths, near what HBM gives in the time the chain takes; 4.4 GB at
// D = 256). (All paths at once
// into an int32 total with atomicAdd is bound instead by its 212 M scattered
// atomics at 540x768x64, plus a zero-fill and a narrowing pass.)

#include <climits>
#include <type_traits>

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// path id -> step (dy, dx); ids as in the reference's ops/sgm.py:
// 0 down, 1 up, 2 left->right, 3 right->left, 4 down-right, 5 down-left,
// 6 up-right, 7 up-left
__constant__ int kDy[8] = {1, -1, 0, 0, 1, 1, -1, -1};
__constant__ int kDx[8] = {0, 0, 1, -1, 1, -1, 1, -1};

__device__ __forceinline__ int num_lines(int path, int h, int w) {
  if (kDx[path] == 0) return w;
  if (kDy[path] == 0) return h;
  return h + w - 1;
}

// first pixel (y, x) of line `line` of path `path`
__device__ __forceinline__ void line_start(int path, int line, int h, int w, int* y, int* x) {
  const int dy = kDy[path], dx = kDx[path];
  const int y_edge = dy > 0 ? 0 : h - 1;
  const int x_edge = dx > 0 ? 0 : w - 1;
  if (dx == 0) {
    *y = y_edge; *x = line;
  } else if (dy == 0) {
    *y = line; *x = x_edge;
  } else if (line < w) {
    *y = y_edge; *x = line;
  } else {
    *y = y_edge + dy * (line - w + 1); *x = x_edge;
  }
}

// ---------------------------------------------------------------------------
// Integer path scans (K2/K3): the family kernels, see the top of the file.

constexpr int kFamilies = 4;
// family -> its forward path id; the backward path walks the same lines in
// reverse (0 down/1 up, 2 lr/3 rl, 4 down-right/7 up-left, 5 down-left/6 up-right)
__constant__ int kFamilyPath[kFamilies] = {0, 2, 4, 5};

__host__ __device__ __forceinline__ int family_lines(int fam, int h, int w) {
  return fam == 0 ? w : (fam == 1 ? h : h + w - 1);
}

// forward start pixel and length of line `line` of family `fam`
__device__ __forceinline__ void family_line(int fam, int line, int h, int w, int* y, int* x,
                                            int* len) {
  const int path = kFamilyPath[fam];
  line_start(path, line, h, w, y, x);
  if (fam == 0) {
    *len = h;
  } else if (fam == 1) {
    *len = w;
  } else {
    const int cols = kDx[path] > 0 ? w - *x : *x + 1;  // columns left in the step direction
    *len = min(h - *y, cols);
  }
}

// sign-extended field j (bits 8j or 16j) of a packed word
__device__ __forceinline__ int field8(uint32_t word, int j) {
  return static_cast<int>(word << (24 - 8 * j)) >> 24;
}
__device__ __forceinline__ int field16(uint32_t word, int j) {
  return static_cast<int>(word << (16 - 16 * j)) >> 16;
}

// The walks of the launch, each into a buffer of its own (so that no element
// has two writers), the launch's blocks split among them in order. A walk is
// a family's lines walked forward (pass 0), back (pass 1) or both; its first
// pass writes its L into `out`, its second reads `out`, adds, writes back.
constexpr int kMaxWalks = 5;
struct Launch {
  int n;  // walks
  int fam[kMaxWalks];
  int first_pass[kMaxWalks], last_pass[kMaxWalks];
  int16_t* out[kMaxWalks];
  int block_end[kMaxWalks];  // running block counts: walk j takes [block_end[j-1], block_end[j])
};

// Shared by both forms: the walk of this block, and this lane's line.
struct LineSetup {
  int16_t* out;
  const int16_t* p2m;
  long long first_pix, stride;
  int len, steps, first_pass, last_pass;
};

template <int L>
__device__ __forceinline__ LineSetup line_setup(const Launch& job, int h, int w,
                                                const int16_t* p2_y, const int16_t* p2_x) {
  int j = 0;
  while (j < job.n - 1 && static_cast<int>(blockIdx.x) >= job.block_end[j]) ++j;
  const int fam = job.fam[j];
  const int block = blockIdx.x - (j > 0 ? job.block_end[j - 1] : 0);
  const int lane = threadIdx.x & 31;
  const int line = (block * kWarpsPerBlock + (threadIdx.x >> 5)) * (32 / L) + lane / L;
  int y = 0, x = 0, len = 0;
  if (line < family_lines(fam, h, w)) family_line(fam, line, h, w, &y, &x, &len);
  const int path = kFamilyPath[fam];
  LineSetup ls;
  ls.out = job.out[j];
  ls.p2m = fam == 1 ? p2_x : p2_y;
  ls.stride = static_cast<long long>(kDy[path]) * w + kDx[path];
  ls.first_pix = static_cast<long long>(y) * w + x;
  ls.len = len;
  ls.steps = __reduce_max_sync(kFull, len);
  ls.first_pass = job.first_pass[j];
  ls.last_pass = job.last_pass[j];
  return ls;
}

constexpr int kVals = 8;  // consecutive d a lane holds

// --- the vector form: D % 8 == 0 and aligned buffers ------------------------
// Each lane stages its own 8 costs, on the second pass its 8 values of `out`,
// and the 32-bit word holding its P2 for the next kStages steps of its line
// in shared memory with cp.async (a ring of kStages steps a warp), so the
// loads run kStages steps ahead without holding registers or scoreboards.
// The buffer stays packed: its values and the step's L are added two int16
// at a time (__vadd2, which wraps each half as the int16 storage does).
constexpr int kStages = 8;
constexpr int kFieldBytes = 32 * 16;                  // a 16-byte slot a lane
constexpr int kStageBytes = 2 * kFieldBytes + 32 * 4;  // cost, out, P2 words
constexpr int kStagedSmem = kWarpsPerBlock * kStages * kStageBytes;  // 36 KB: no opt-in

template <int N>
struct alignas(4 * N) Words {
  uint32_t w[N];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)  // through L2 only: the buffers are written by these kernels
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int L, typename CostT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sgm_family_staged_kernel(const CostT* __restrict__ cost, const int16_t* __restrict__ p2_y,
                         const int16_t* __restrict__ p2_x, Launch job, int h, int w, int n_disp,
                         int p1) {
  using CostChunk = Words<kVals * static_cast<int>(sizeof(CostT)) / 4>;
  using BufChunk = Words<kVals / 2>;  // 8 int16
  extern __shared__ __align__(16) unsigned char smem[];
  const LineSetup ls = line_setup<L>(job, h, w, p2_y, p2_x);
  if (ls.steps == 0) return;  // whole warp: past the last line
  const int lane = threadIdx.x & 31;
  const int d0 = (lane & (L - 1)) * kVals;
  const bool has = d0 < n_disp;  // D % 8 == 0: a lane's 8 values are all in range or none
  unsigned char* ring = smem + (threadIdx.x >> 5) * kStages * kStageBytes;

  for (int pass = ls.first_pass; pass <= ls.last_pass; ++pass) {
    // the second pass adds to what the first wrote
    const bool adds = pass != ls.first_pass;
    if (adds) __threadfence_block();  // the first pass's stores, then their copies
    const long long start = pass == 0 ? ls.first_pix : ls.first_pix + (ls.len - 1) * ls.stride;
    const long long step = pass == 0 ? ls.stride : -ls.stride;
    auto issue = [&](int i) {  // the copies of step i into its stage; one group a step
      if (i < ls.len) {
        unsigned char* st = ring + (i % kStages) * kStageBytes;
        const long long pix = start + i * step;
        const long long e = pix * n_disp + d0;
        if (has) {
          cp_async<sizeof(CostChunk)>(st + lane * 16, cost + e);
          if (adds) cp_async<16>(st + kFieldBytes + lane * 16, ls.out + e);
        }
        const uintptr_t p2a = reinterpret_cast<uintptr_t>(ls.p2m + pix);
        cp_async<4>(st + 2 * kFieldBytes + lane * 4, reinterpret_cast<const void*>(p2a & ~3ull));
      }
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < kStages; ++i) issue(i);
    int prev[kVals];
    for (int i = 0; i < ls.steps; ++i) {
      cp_async_wait<kStages - 1>();  // step i's group has landed
      const unsigned char* st = ring + (i % kStages) * kStageBytes;
      const long long pix = start + i * step;
      const CostChunk cw = *reinterpret_cast<const CostChunk*>(st + lane * 16);
      int cur[kVals];
#pragma unroll
      for (int k = 0; k < kVals; ++k) {
        if constexpr (sizeof(CostT) == 1)
          cur[k] = field8(cw.w[k / 4], k % 4);
        else
          cur[k] = field16(cw.w[k / 2], k % 2);
      }
      BufChunk base;
      if (adds) {
        base = *reinterpret_cast<const BufChunk*>(st + kFieldBytes + lane * 16);
      } else {
#pragma unroll
        for (int q = 0; q < kVals / 2; ++q) base.w[q] = 0;
      }
      const uint32_t p2w = *reinterpret_cast<const uint32_t*>(st + 2 * kFieldBytes + lane * 4);
      const int p2 = field16(p2w, (reinterpret_cast<uintptr_t>(ls.p2m + pix) >> 1) & 1);
      issue(i + kStages);  // refill this stage: its values are in registers now
      if (i > 0) {
        int m = INT_MAX;
        if (has) {
#pragma unroll
          for (int k = 0; k < kVals; ++k) m = min(m, prev[k]);
        }
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1) m = min(m, __shfl_xor_sync(kFull, m, off, L));
        int below = __shfl_up_sync(kFull, prev[kVals - 1], 1, L);  // d = d0 - 1
        int above = __shfl_down_sync(kFull, prev[0], 1, L);        // d = d0 + 8
        if (d0 == 0) below = svt::kBigInt;
        if (d0 + kVals == n_disp) above = svt::kBigInt;
        const int jump = m + p2;
#pragma unroll
        for (int k = 0; k < kVals; ++k) {
          const int lo = k > 0 ? prev[k - 1] : below;
          const int hi = k < kVals - 1 ? prev[k + 1] : above;
          cur[k] += min(min(prev[k], jump), min(lo, hi) + p1) - m;
        }
      }
      if (has && i < ls.len) {
        BufChunk o;
#pragma unroll
        for (int q = 0; q < kVals / 2; ++q)
          o.w[q] = __vadd2(base.w[q], (static_cast<uint32_t>(cur[2 * q]) & 0xffffu) |
                                          (static_cast<uint32_t>(cur[2 * q + 1]) << 16));
        *reinterpret_cast<BufChunk*>(ls.out + pix * n_disp + d0) = o;
      }
#pragma unroll
      for (int k = 0; k < kVals; ++k) prev[k] = cur[k];
    }
    cp_async_wait<0>();
  }
}

// --- the scalar form: any D, any alignment ----------------------------------
// A register ring of kScalarRing steps; each value is loaded on its own with
// d < D checks, the buffers through L2 (__ldcg: these kernels write them).
constexpr int kScalarRing = 2;

template <typename CostT>
struct ScalarSlot {
  int c[kVals];
  int t[kVals];
  int p2;
  // `own`: the buffer the second pass adds to (nullptr on the first pass)
  __device__ __forceinline__ void load(const CostT* cost, const int16_t* p2m, long long pix,
                                       int n_disp, int d0, const int16_t* own) {
#pragma unroll
    for (int k = 0; k < kVals; ++k) {
      const int d = d0 + k;
      const long long e = pix * n_disp + d;
      c[k] = d < n_disp ? static_cast<int>(__ldg(cost + e)) : 0;
      t[k] = d < n_disp && own != nullptr ? static_cast<int>(__ldcg(own + e)) : 0;
    }
    p2 = __ldg(p2m + pix);
  }
};

template <int L, typename CostT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sgm_family_scalar_kernel(const CostT* __restrict__ cost, const int16_t* __restrict__ p2_y,
                         const int16_t* __restrict__ p2_x, Launch job, int h, int w, int n_disp,
                         int p1) {
  const LineSetup ls = line_setup<L>(job, h, w, p2_y, p2_x);
  if (ls.steps == 0) return;  // whole warp: past the last line
  const int lane = threadIdx.x & 31;
  const int d0 = (lane & (L - 1)) * kVals;

  for (int pass = ls.first_pass; pass <= ls.last_pass; ++pass) {
    const long long start = pass == 0 ? ls.first_pix : ls.first_pix + (ls.len - 1) * ls.stride;
    const long long step = pass == 0 ? ls.stride : -ls.stride;
    const int16_t* own = pass == ls.first_pass ? nullptr : ls.out;
    ScalarSlot<CostT> ring[kScalarRing];
#pragma unroll
    for (int r = 0; r < kScalarRing; ++r)
      if (r < ls.len) ring[r].load(cost, ls.p2m, start + r * step, n_disp, d0, own);
    int prev[kVals];
    for (int i0 = 0; i0 < ls.steps; i0 += kScalarRing) {
#pragma unroll
      for (int r = 0; r < kScalarRing; ++r) {
        const int i = i0 + r;
        if (i >= ls.steps) break;  // uniform across the warp
        int cur[kVals];
#pragma unroll
        for (int k = 0; k < kVals; ++k) cur[k] = ring[r].c[k];
        if (i > 0) {
          int m = INT_MAX;
#pragma unroll
          for (int k = 0; k < kVals; ++k)
            if (d0 + k < n_disp) m = min(m, prev[k]);
          int below = __shfl_up_sync(kFull, prev[kVals - 1], 1, L);
          int above = __shfl_down_sync(kFull, prev[0], 1, L);
          if (d0 == 0) below = svt::kBigInt;
          // d = D - 1 has BIG above it, whether d + 1 is in this lane or the next
          int nxt[kVals];
#pragma unroll
          for (int k = 0; k < kVals; ++k)
            nxt[k] = d0 + k == n_disp - 1 ? svt::kBigInt : (k < kVals - 1 ? prev[k + 1] : above);
#pragma unroll
          for (int off = L / 2; off > 0; off >>= 1) m = min(m, __shfl_xor_sync(kFull, m, off, L));
          const int jump = m + ring[r].p2;
#pragma unroll
          for (int k = 0; k < kVals; ++k) {
            const int lo = k > 0 ? prev[k - 1] : below;
            cur[k] += min(min(prev[k], jump), min(lo, nxt[k]) + p1) - m;
          }
        }
        if (i < ls.len) {
          const long long pix = start + i * step;
#pragma unroll
          for (int k = 0; k < kVals; ++k)
            if (d0 + k < n_disp)
              ls.out[pix * n_disp + d0 + k] = static_cast<int16_t>(ring[r].t[k] + cur[k]);
          if (i + kScalarRing < ls.len)
            ring[r].load(cost, ls.p2m, start + (i + kScalarRing) * step, n_disp, d0, own);
        }
#pragma unroll
        for (int k = 0; k < kVals; ++k) prev[k] = cur[k];
      }
    }
  }
}

// total += the sum of `n_parts` (n,) int16 partials laid end to end, with
// wrap: 8 elements a thread in 128-bit words (vec), else one.
__global__ void __launch_bounds__(256)
sgm_sum_partials_kernel(int16_t* __restrict__ total, const int16_t* __restrict__ parts,
                        int n_parts, size_t n, int vec) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vec) {
    if (i * 8 >= n) return;
    uint4 acc = reinterpret_cast<const uint4*>(total)[i];
    for (int j = 0; j < n_parts; ++j) {
      const uint4 t = __ldcs(reinterpret_cast<const uint4*>(parts + j * n) + i);
      acc = make_uint4(__vadd2(acc.x, t.x), __vadd2(acc.y, t.y), __vadd2(acc.z, t.z),
                       __vadd2(acc.w, t.w));
    }
    reinterpret_cast<uint4*>(total)[i] = acc;
  } else {
    if (i >= n) return;
    int acc = total[i];
    for (int j = 0; j < n_parts; ++j) acc += parts[j * n + i];
    total[i] = static_cast<int16_t>(acc);
  }
}

// One launch of the walks in `job`: the staged form (vec), else the scalar
// one; L lanes a line.
template <int L, typename CostT>
cudaError_t launch_job(const CostT* cost, const int16_t* p2_y, const int16_t* p2_x, Launch job,
                       int h, int w, int n_disp, int p1, bool vec, cudaStream_t stream) {
  int blocks = 0;
  for (int j = 0; j < job.n; ++j) {
    const int warps = (family_lines(job.fam[j], h, w) + 32 / L - 1) / (32 / L);
    blocks += (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    job.block_end[j] = blocks;
  }
  if (vec) {
    sgm_family_staged_kernel<L, CostT><<<blocks, kWarpsPerBlock * 32, kStagedSmem, stream>>>(
        cost, p2_y, p2_x, job, h, w, n_disp, p1);
  } else {
    sgm_family_scalar_kernel<L, CostT><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        cost, p2_y, p2_x, job, h, w, n_disp, p1);
  }
  return cudaGetLastError();
}

// int16 partial buffers beside the total (ops/sgm_cuda.py allocates them)
__host__ __device__ constexpr int scratch_partials(int num_paths) { return num_paths == 8 ? 4 : 2; }

void add_walk(Launch* job, int fam, int first_pass, int last_pass, int16_t* out) {
  const int j = job->n++;
  job->fam[j] = fam;
  job->first_pass[j] = first_pass;
  job->last_pass[j] = last_pass;
  job->out[j] = out;
}

// The schedule: every walk in one launch, each into a buffer of its own (the
// vertical family both ways into the total; left->right and right->left each
// into a partial, a line of W steps each rather than one walk of 2W; with 8
// paths each diagonal family both ways into a partial), then a sum pass adds
// the partials into the total. The launch takes the chain of its longest
// walk, 2 * max(H, min(H, W)) or W steps, and the buffers' traffic.
template <int L, typename CostT>
cudaError_t launch_families(const CostT* cost, const int16_t* p2_y, const int16_t* p2_x,
                            int16_t* total, int16_t* scratch, int h, int w, int n_disp, int p1,
                            int num_paths, bool vec, cudaStream_t stream) {
  const size_t n = static_cast<size_t>(h) * w * n_disp;
  Launch all{};
  add_walk(&all, 0, 0, 1, total);
  add_walk(&all, 1, 0, 0, scratch);
  add_walk(&all, 1, 1, 1, scratch + n);
  if (num_paths == 8) {
    add_walk(&all, 2, 0, 1, scratch + 2 * n);
    add_walk(&all, 3, 0, 1, scratch + 3 * n);
  }
  const cudaError_t err = launch_job<L>(cost, p2_y, p2_x, all, h, w, n_disp, p1, vec, stream);
  if (err != cudaSuccess) return err;
  const size_t threads = vec ? n / 8 : n;
  sgm_sum_partials_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      total, scratch, scratch_partials(num_paths), n, vec);
  return cudaGetLastError();
}

// The staged form where D % 8 == 0 and every buffer is 16-byte aligned (the
// costs to their 8-value chunk), else the scalar one.
template <typename CostT>
cudaError_t launch_int(const void* cost, const int16_t* p2_y, const int16_t* p2_x,
                       int16_t* total, int16_t* scratch, int h, int w, int n_disp, int p1,
                       int num_paths, cudaStream_t s) {
  const auto* c = static_cast<const CostT*>(cost);
  const uintptr_t align = reinterpret_cast<uintptr_t>(cost) % (kVals * sizeof(CostT)) |
                          reinterpret_cast<uintptr_t>(total) % 16 |
                          reinterpret_cast<uintptr_t>(scratch) % 16;
  const bool vec = n_disp % kVals == 0 && align == 0;
  const int lanes = (n_disp + kVals - 1) / kVals;
#define SVT_LAUNCH(L) \
  launch_families<L>(c, p2_y, p2_x, total, scratch, h, w, n_disp, p1, num_paths, vec, s)
  if (lanes <= 1) return SVT_LAUNCH(1);
  if (lanes <= 2) return SVT_LAUNCH(2);
  if (lanes <= 4) return SVT_LAUNCH(4);
  if (lanes <= 8) return SVT_LAUNCH(8);
  if (lanes <= 16) return SVT_LAUNCH(16);
  return SVT_LAUNCH(32);
#undef SVT_LAUNCH
}

// ---------------------------------------------------------------------------
// Float aggregation (K7's generic form: sweep subsets, D % 8 != 0, unaligned
// costs; replaces the float use of the sweep kernels through
// stereovisionarray_tpu/ops/sgm_pallas.py::sgm_aggregate_pallas_sweeps /
// sgm_aggregate_pallas_hdw, and serves the twin of _sweep_hdw_bidir).
//
// Float sums are not associative, and every reference route sums the paths
// in its own order, so the integer design (each pair of opposite paths
// adding into a buffer, in whatever order the schedule picks) cannot serve
// them. Here sgm_paths_f32_kernel runs the same warp-per-line scans in
// float32, with the reference's float recurrence evaluated in its order,
//   L = C + (min(prev, m + P2, min(lo, hi) + P1) - m),  m = min_d' prev,
// BIG = 1e9 at d = -1 and d = D, and writes each path into a partial of its
// own (one writer per element, nothing atomic). sgm_combine_f32_kernel then
// sums the partials per element in the route's order, with a fused
// multiply-add (__fmaf_rn; the library is built with -fmad=false, so nothing
// else contracts) where the reference's compiled kernel contracts
// `acc + 3 * row`:
//   k7, k10: (down + up) + (lr + rl)   (k7: y = H-1 of down + up fused)
//   wdh:     ((down + up) + lr) + rl   (y = H-1 of down + up fused)
//   k12:     ((lr + rl) + down) + up   (y = 0 and y = H-1 fused)
// where a sweep's group is (axis + diag+1) + diag-1 and fusing happens with 8
// paths only (4 paths add 1 * row, which is exact either way).
//
// What bounds it on the H100: the scans as the integer kernel (latency of
// the serial steps), plus memory: 8 partials of H*W*D floats are written and
// read back once, 2 * 8 * 106 MB at 540x768x64, about 0.5 ms of HBM time
// against the 212 MB (0.06 ms) that reading the costs and writing the sum
// need. Memory for the partials is P * H*W*D * 4 bytes (3.4 GB at
// 540x768x256 with 8 paths); the strip route below moves 11 H*W*D floats.

template <int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sgm_paths_f32_kernel(const float* __restrict__ cost, const float* __restrict__ p2_y,
                     const float* __restrict__ p2_x, float* __restrict__ partial, int h, int w,
                     int n_disp, float p1, int path_mask) {
  const int lane = threadIdx.x & 31;
  int line = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  int path = 0, slot = 0;
  for (; path < 8; ++path) {
    if (!((path_mask >> path) & 1)) continue;
    const int n = num_lines(path, h, w);
    if (line < n) break;
    line -= n;
    ++slot;
  }
  if (path == 8) return;  // whole warp: past the last line

  const int dy = kDy[path], dx = kDx[path];
  const float* p2_map = dy != 0 ? p2_y : p2_x;
  float* out = partial + static_cast<size_t>(slot) * h * w * n_disp;
  int y, x;
  line_start(path, line, h, w, &y, &x);

  float prev[K];
  bool first = true;
  for (; y >= 0 && y < h && x >= 0 && x < w; y += dy, x += dx) {
    const size_t pix = static_cast<size_t>(y) * w + x;
    const float* c = cost + pix * n_disp;
    float cur[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane * K + k;
      cur[k] = d < n_disp ? c[d] : 0.0f;
    }
    if (!first) {
      float m = __int_as_float(0x7f800000);  // +inf
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (lane * K + k < n_disp) m = fminf(m, prev[k]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(kFull, m, off));
      const float below = __shfl_up_sync(kFull, prev[K - 1], 1);  // d = lane*K - 1
      const float above = __shfl_down_sync(kFull, prev[0], 1);    // d = lane*K + K
      const float jump = m + p2_map[pix];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = lane * K + k;
        const float lo = d == 0 ? svt::kBigFloat : (k > 0 ? prev[k - 1] : below);
        const float hi = d == n_disp - 1 ? svt::kBigFloat : (k < K - 1 ? prev[k + 1] : above);
        const float best = fminf(fminf(prev[k], jump), fminf(lo, hi) + p1);
        cur[k] = cur[k] + (best - m);
      }
    }
    float* o = out + pix * n_disp;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int d = lane * K + k;
      if (d < n_disp) o[d] = cur[k];
      prev[k] = cur[k];
    }
    first = false;
  }
}

enum Order { kOrderK7 = 0, kOrderWdh = 1, kOrderK10 = 2, kOrderK12 = 3 };
enum Sweep { kDown = 1, kUp = 2, kLr = 4, kRl = 8 };

struct Slots {
  int of[8];  // partial slot of each path id, -1 when the path was not scanned
};

__global__ void __launch_bounds__(256)
sgm_combine_f32_kernel(const float* __restrict__ partial, float* __restrict__ out, int h, int w,
                       int n_disp, Slots slots, int sweep_mask, int diagonals, int order) {
  const size_t n = static_cast<size_t>(h) * w * n_disp;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int y = static_cast<int>(i / (static_cast<size_t>(w) * n_disp));
  auto P = [&](int pid) { return partial[static_cast<size_t>(slots.of[pid]) * n + i]; };
  // a sweep's group: (axis + diag+1) + diag-1
  auto down = [&]() { return diagonals ? (P(0) + P(4)) + P(5) : P(0); };
  auto up = [&]() { return diagonals ? (P(1) + P(6)) + P(7) : P(1); };
  // the first row of a fused group is L = C on each of its three paths
  const bool fused = diagonals && order != kOrderK10;
  float total;
  if (order == kOrderK12) {
    const float horiz = P(2) + P(3);
    const float acc = fused && y == 0 ? __fmaf_rn(3.0f, P(0), horiz) : horiz + down();
    total = fused && y == h - 1 ? __fmaf_rn(3.0f, P(1), acc) : acc + up();
  } else {
    const bool has_v = sweep_mask & (kDown | kUp), has_h = sweep_mask & (kLr | kRl);
    float vert = 0.0f, horiz = 0.0f;
    if ((sweep_mask & (kDown | kUp)) == (kDown | kUp)) {
      const float dn = down();
      vert = fused && y == h - 1 ? __fmaf_rn(3.0f, P(1), dn) : dn + up();
    } else if (sweep_mask & kDown) {
      vert = down();
    } else if (sweep_mask & kUp) {
      vert = up();
    }
    if (order == kOrderWdh) {
      total = (vert + P(2)) + P(3);
    } else {
      if ((sweep_mask & (kLr | kRl)) == (kLr | kRl))
        horiz = P(2) + P(3);
      else if (sweep_mask & kLr)
        horiz = P(2);
      else if (sweep_mask & kRl)
        horiz = P(3);
      total = has_v && has_h ? vert + horiz : (has_v ? vert : horiz);
    }
  }
  out[i] = total;
}

template <int K>
cudaError_t launch_f32(const float* cost, const float* p2_y, const float* p2_x, float* partial,
                       int h, int w, int n_disp, float p1, int path_mask, cudaStream_t stream) {
  int lines = 0;
  for (int p = 0; p < 8; ++p) {
    if (!((path_mask >> p) & 1)) continue;
    lines += p == 0 || p == 1 ? w : (p == 2 || p == 3 ? h : h + w - 1);
  }
  const int blocks = (lines + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sgm_paths_f32_kernel<K><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      cost, p2_y, p2_x, partial, h, w, n_disp, p1, path_mask);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K7's strip route (svt_sgm_float_strips): every full-sweep float sum where
// D % 8 == 0 and the buffers are 16-byte aligned (ops/sgm_cuda._strip_plan).
//
// The generic form above moves 25U (U = H*W*D*4 bytes: 8 walks read the
// costs and write a partial each, the combine reads the 8 back and writes
// the total) and runs at HBM's rate (3.06 TB/s for the walks, 2.91 for the
// combine at 540x768x64, PERF.md): only fewer bytes make it faster.
// The reference kept its path intermediates in VMEM: the TPU walked a whole
// row at a time with a stacked carry of the three same-direction paths
// (sgm_pallas.py:466-471, _sweep_hdw_stacked) and accumulated the up sweep
// into the down sweep's volume (:478-499). Here a row-serial sweep would
// hand data between SMs on every row, so the vertical groups walk the image
// in strips of S rows and keep their partials in L2:
//  1. sgm_rows_f32_kernel: the left->right and right->left walks, a row a
//     line, each into a buffer of its own (P2, P3): a chain of W steps.
//  2. sgm_strips_f32_kernel, down: a cooperative persistent kernel. Phase k
//     walks strip k of the down group (paths 0, 4, 5) into slot k % 2 of a
//     ring of [2][3][S][W][D] floats (18 MiB at 540x768x64: it stays in
//     L2), each segment carried from the strip before's slot or fresh, and
//     its other warps sum strip k - 1, A = (P0 + P4) + P5, into HBM; one
//     grid barrier a phase. The walk of strip k + 1 overwrites slot
//     (k - 1) % 2 only after the barrier that ends the combine of k - 1.
//  3. the same kernel, up: the up group (1, 6, 7) from the bottom strip up;
//     its combine forms B = (P1 + P6) + P7 and the route's total from A,
//     P2, P3 and, on the rows the reference fuses, the costs (P1 = C at
//     y = H-1, and for k12 P0 = C at y = 0), exactly as
//     sgm_combine_f32_kernel: each + adds the same two float32 operands.
// Bytes: 2U + 2U, then 1U + 1U, then 4U + 1U: 11U of HBM traffic in all.
// The ring is written and read in L2, and the three paths of a strip read
// the same cost rows in the same phase, so the second and third reads hit L2.
//
// Walks: as the integer staged form, L lanes a line, V consecutive d a lane
// (V = 4, one float4, up to D = 128; 8 above), costs and P2 staged
// kStripStages steps ahead with cp.async, the next step's stage read before
// this step's chain; the float recurrence of sgm_paths_f32_kernel, evaluated
// in its order. What bounds it on the H100 (PERF.md, K7's phase timing): a
// phase's walk takes ~0.28 us a step whatever its loads or its chain (a
// warp's instruction latency: 16 steps of ~90 dependent instructions), so
// 70 phases cost ~0.35 ms of walks beside ~0.12 ms of grid barriers, and
// the up pass's combine (4U from HBM) runs beside its walks.

constexpr int kRowWarps = 1;     // launch 1: a block a warp, spread over every SM
constexpr int kStripWarps = 16;  // launches 2 and 3: 2 blocks an SM, a cheaper grid barrier
constexpr int kStripStages = 8;
constexpr long long kStripRingBytes = 24ll << 20;  // ops/sgm_cuda.STRIP_RING_BYTES
constexpr int kMaxStripRows = 32;

// ops/sgm_cuda._strip_plan's strip height at width w and n_disp
int strip_rows_for(int w, int n_disp) {
  int rows = kMaxStripRows;
  while (rows > 1 && 2ll * 3 * rows * w * n_disp * 4 > kStripRingBytes) rows >>= 1;
  return rows;
}

// Shared memory of a warp: kStripStages stages of V costs a lane and a P2
// word a lane, then (strip walks) a lane's V floats of the carried L.
template <int V>
__host__ __device__ constexpr int stage_bytes() { return 32 * V * 4 + 32 * 4; }
template <int V>
__host__ __device__ constexpr int row_warp_bytes() { return kStripStages * stage_bytes<V>(); }
template <int V>
__host__ __device__ constexpr int strip_warp_bytes() {
  return kStripStages * stage_bytes<V>() + 32 * V * 4;
}

template <int V>
__device__ __forceinline__ void load_v(float (&v)[V], const unsigned char* p) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const float4 a = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = a.x;
    v[4 * q + 1] = a.y;
    v[4 * q + 2] = a.z;
    v[4 * q + 3] = a.w;
  }
}
template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q)
    reinterpret_cast<float4*>(p)[q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}
template <int V>
__device__ __forceinline__ void store_v_streaming(float* p, const float (&v)[V]) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q)
    __stcs(reinterpret_cast<float4*>(p) + q,
           make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
}
// a lane's V values from global memory into shared memory (16-byte aligned)
template <int V>
__device__ __forceinline__ void cp_async_v(unsigned char* dst, const float* src) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q) cp_async<16>(dst + 16 * q, src + 4 * q);
}

// One float step of a line's L lanes, uniform across the warp (shuffles):
// cur = C + (min(prev, m + P2, min(lo, hi) + P1) - m), m = min_d' prev, in
// sgm_paths_f32_kernel's order; lanes past D (has == false) add nothing.
template <int L, int V>
__device__ __forceinline__ void f32_step(float (&cur)[V], const float (&prev)[V], float p2,
                                         float p1, bool has, int d0, int n_disp) {
  float m = __int_as_float(0x7f800000);  // +inf
  if (has) {
#pragma unroll
    for (int k = 0; k < V; ++k) m = fminf(m, prev[k]);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(kFull, m, off, L));
  float below = __shfl_up_sync(kFull, prev[V - 1], 1, L);  // d = d0 - 1
  float above = __shfl_down_sync(kFull, prev[0], 1, L);    // d = d0 + V
  if (d0 == 0) below = svt::kBigFloat;
  if (d0 + V == n_disp) above = svt::kBigFloat;
  const float jump = m + p2;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float lo = k > 0 ? prev[k - 1] : below;
    const float hi = k < V - 1 ? prev[k + 1] : above;
    const float best = fminf(fminf(prev[k], jump), fminf(lo, hi) + p1);
    cur[k] = cur[k] + (best - m);
  }
}

// Launch 1, the horizontal walks: lines [0, H) walk rows left->right into
// p2_buf, [H, 2H) right->left into p3_buf, W steps each; L lanes a line,
// 32 / L lines a warp, a warp a block (spread over every SM). The next
// step's stage is read before this step's chain, so that the reads overlap it.
template <int L, int V>
__global__ void __launch_bounds__(kRowWarps * 32)
sgm_rows_f32_kernel(const float* __restrict__ cost, const float* __restrict__ p2_x,
                    float* __restrict__ p2_buf, float* __restrict__ p3_buf, int h, int w,
                    int n_disp, float p1) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int first_line = (blockIdx.x * kRowWarps + (threadIdx.x >> 5)) * (32 / L);
  if (first_line >= 2 * h) return;  // whole warp: past the last line
  const int line = first_line + lane / L;
  const bool live = line < 2 * h;
  const bool rl = line >= h;
  const int row = live ? (rl ? line - h : line) : 0;
  const long long step = rl ? -1 : 1;
  const long long start = static_cast<long long>(row) * w + (rl ? w - 1 : 0);
  const int d0 = (lane & (L - 1)) * V;
  const bool has = live && d0 < n_disp;  // V divides D: all V values or none
  unsigned char* ring = smem + (threadIdx.x >> 5) * row_warp_bytes<V>();
  int staged = 0;  // steps whose copies were issued, one group a step
  auto issue = [&]() {
    if (staged < w) {
      unsigned char* st = ring + (staged % kStripStages) * stage_bytes<V>();
      const long long pix = start + staged * step;
      if (has) cp_async_v<V>(st + lane * V * 4, cost + pix * n_disp + d0);
      if (live) cp_async<4>(st + 32 * V * 4 + lane * 4, p2_x + pix);
    }
    ++staged;
    cp_async_commit();
  };
  auto read = [&](int i, float (&c)[V], float& q) {  // step i's stage into registers
    const unsigned char* st = ring + (i % kStripStages) * stage_bytes<V>();
    load_v<V>(c, st + lane * V * 4);
    q = *reinterpret_cast<const float*>(st + 32 * V * 4 + lane * 4);
  };
#pragma unroll
  for (int i = 0; i < kStripStages; ++i) issue();
  cp_async_wait<kStripStages - 1>();
  float prev[V], cur[V], p2;
  read(0, cur, p2);
  issue();  // refill step 0's stage
  float* out = (rl ? p3_buf : p2_buf) + start * n_disp + d0;
  for (int i = 0; i < w; ++i) {
    cp_async_wait<kStripStages - 1>();  // step i + 1's group has landed
    float nxt[V], p2n;
    read(i + 1, nxt, p2n);
    issue();
    if (i > 0) f32_step<L, V>(cur, prev, p2, p1, has, d0, n_disp);
    if (has) store_v_streaming<V>(out, cur);
    out += step * n_disp;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      prev[k] = cur[k];
      cur[k] = nxt[k];
    }
    p2 = p2n;
  }
  cp_async_wait<0>();
}

struct StripArgs {
  const float* cost;
  const float* p2_y;
  const float* p2_x;
  float* p2_buf;  // left->right L (launch 1, read by the up pass)
  float* p3_buf;  // right->left L
  float* a_buf;   // the down group's sum (the down pass, read by the up pass)
  float* out;     // the route's total (the up pass)
  float* ring;    // [2][paths][S][W][D]
  int h, w, n_disp, paths, order, up, strip_rows;
  float p1;
};

// A segment walk of the strip route: 32 / L segments of the pass's group
// of paths, one a line of L lanes. Path j of the group steps (dy, dx) with
// dy = -1 on the up pass and dx = 0, +1, -1 for j = 0, 1, 2 (down 0, 4, 5;
// up 1, 6, 7). Segment i < W starts at column i of the strip's first row in
// the walking direction and is carried from the pixel one step back, in the
// strip walked before, where that lies in the image; a diagonal's segment
// W - 1 + j' (j' >= 1) enters from the side edge j' rows in, fresh (the
// integer kernels' family_line, restricted to the strip).
struct Segment {
  long long pix, pix_step;  // the next step's pixel to stage, pixels a step
  int y, x, j, len, steps, staged;
  bool carried, has;
};

// Walk item `item` of strip `strip` (rows [y0, y0 + n)): this lane's segment.
template <int L, int V>
__device__ __forceinline__ Segment plan_segment(const StripArgs& a, int strip, int n, int item) {
  const int lane = threadIdx.x & 31;
  const int w = a.w;
  const int diag_segs = w + n - 1;
  int g = item * (32 / L) + lane / L;
  Segment sg;
  sg.j = 0;
  if (g >= w) {
    g -= w;
    sg.j = 1 + g / diag_segs;
    g -= (sg.j - 1) * diag_segs;
  }
  const int dy = a.up ? -1 : 1;
  const int dx = sg.j == 1 ? 1 : (sg.j == 2 ? -1 : 0);
  const int y0 = strip * a.strip_rows;
  const int ys = a.up ? y0 + n - 1 : y0;
  sg.y = ys;
  sg.x = g;
  sg.len = 0;
  sg.carried = false;
  if (sg.j < a.paths) {
    if (g < w) {
      sg.len = dx > 0 ? min(n, w - g) : (dx < 0 ? min(n, g + 1) : n);
      const int py = sg.y - dy, px = sg.x - dx;
      sg.carried = py >= 0 && py < a.h && px >= 0 && px < w;
    } else {  // enters from the side edge, fresh
      const int jj = g - w + 1;
      sg.y = ys + dy * jj;
      sg.x = dx > 0 ? 0 : w - 1;
      sg.len = min(n - jj, w);
    }
  }
  sg.steps = __reduce_max_sync(kFull, sg.len);
  sg.has = sg.len > 0 && (lane & (L - 1)) * V < a.n_disp;
  sg.pix_step = static_cast<long long>(dy) * w + dx;
  sg.pix = static_cast<long long>(sg.y) * w + sg.x;
  sg.staged = 0;
  return sg;
}

// The next step's copies (costs, P2) into its stage: one group a step.
template <int L, int V>
__device__ __forceinline__ void stage_step(const StripArgs& a, Segment& sg,
                                           unsigned char* warp_smem) {
  const int lane = threadIdx.x & 31;
  if (sg.staged < sg.len) {
    unsigned char* st = warp_smem + (sg.staged % kStripStages) * stage_bytes<V>();
    if (sg.has)
      cp_async_v<V>(st + lane * V * 4, a.cost + sg.pix * a.n_disp + (lane & (L - 1)) * V);
    cp_async<4>(st + 32 * V * 4 + lane * 4, a.p2_y + sg.pix);
  }
  sg.pix += sg.pix_step;
  ++sg.staged;
  cp_async_commit();
}

// The walk of one segment: the first kStripStages steps' copies and the
// carry from the strip before's ring slot (L2), then the steps; each L goes
// to this strip's slot at row y - y0. The next step's stage is read before
// this step's chain.
template <int L, int V>
__device__ __forceinline__ void walk_segment(const StripArgs& a, int strip, Segment& sg,
                                             unsigned char* warp_smem) {
  if (sg.steps == 0) return;  // whole warp: past the last segment
  const int lane = threadIdx.x & 31;
  const int w = a.w, n_disp = a.n_disp, S = a.strip_rows;
  const int d0 = (lane & (L - 1)) * V;
  const int dy = a.up ? -1 : 1;
  const int dx = sg.j == 1 ? 1 : (sg.j == 2 ? -1 : 0);
  const long long plane = static_cast<long long>(w) * n_disp;  // floats a row
  const long long path_floats = static_cast<long long>(S) * plane;
  float* const ring = a.ring;
  unsigned char* carry = warp_smem + kStripStages * stage_bytes<V>();
  if (sg.carried && sg.has) {
    const int py = sg.y - dy, px = sg.x - dx;
    cp_async_v<V>(carry + lane * V * 4, ring + path_floats * (a.paths * ((py / S) & 1) + sg.j) +
                                            static_cast<long long>(py % S) * plane +
                                            static_cast<long long>(px) * n_disp + d0);
  }
#pragma unroll
  for (int t = 0; t < kStripStages; ++t) stage_step<L, V>(a, sg, warp_smem);  // carry: group 0
  cp_async_wait<kStripStages - 1>();  // step 0 and the carry have landed
  float* out = ring + path_floats * (a.paths * (strip & 1) + sg.j) +
               static_cast<long long>(sg.y - strip * S) * plane +
               static_cast<long long>(sg.x) * n_disp + d0;
  const long long out_step = dy * plane + dx * n_disp;
  auto read = [&](int t, float (&c)[V], float& q) {  // step t's stage into registers
    const unsigned char* st = warp_smem + (t % kStripStages) * stage_bytes<V>();
    load_v<V>(c, st + lane * V * 4);
    q = *reinterpret_cast<const float*>(st + 32 * V * 4 + lane * 4);
  };
  float prev[V], cur[V], p2;
  read(0, cur, p2);
#pragma unroll
  for (int k = 0; k < V; ++k) prev[k] = cur[k];
  if (sg.carried && sg.has) load_v<V>(prev, carry + lane * V * 4);
  float first[V];
#pragma unroll
  for (int k = 0; k < V; ++k) first[k] = cur[k];
  f32_step<L, V>(first, prev, p2, a.p1, sg.has, d0, n_disp);
  stage_step<L, V>(a, sg, warp_smem);  // refill step 0's stage
#pragma unroll
  for (int k = 0; k < V; ++k) cur[k] = sg.carried ? first[k] : cur[k];  // fresh: L = C
  for (int t = 0;;) {
    if (sg.has && t < sg.len) store_v<V>(out, cur);
    out += out_step;
    if (++t == sg.steps) break;
    cp_async_wait<kStripStages - 1>();  // step t's group has landed
    float nxt[V];
    read(t, nxt, p2);
    stage_step<L, V>(a, sg, warp_smem);
    f32_step<L, V>(nxt, cur, p2, a.p1, sg.has, d0, n_disp);
#pragma unroll
    for (int k = 0; k < V; ++k) cur[k] = nxt[k];
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The route's total of one element from the group sums dn (down) and up,
// the horizontal walks' L p2 and p3, and the cost c on the fused rows, as
// sgm_combine_f32_kernel sums it.
__device__ __forceinline__ float route_total(float dn, float up, float p2, float p3, float c,
                                             int order, bool first, bool last) {
  if (order == kOrderK12) {
    const float horiz = p2 + p3;
    const float acc = first ? __fmaf_rn(3.0f, c, horiz) : horiz + dn;
    return last ? __fmaf_rn(3.0f, c, acc) : acc + up;
  }
  const float vert = last ? __fmaf_rn(3.0f, c, dn) : dn + up;
  return order == kOrderWdh ? (vert + p2) + p3 : vert + (p2 + p3);
}

// The combine of strip `strip` (n rows) by thread `tid` of `nthreads`, four
// elements a step: the group sum (axis + diag+1) + diag-1 from the ring; the
// down pass writes it to A, the up pass the route's total.
__device__ __forceinline__ void combine_strip(const StripArgs& a, int strip, int n, long long tid,
                                              long long nthreads) {
  const long long plane = static_cast<long long>(a.w) * a.n_disp;
  const long long path_floats = static_cast<long long>(a.strip_rows) * plane;
  const float* slot = a.ring + a.paths * path_floats * (strip & 1);
  const long long first = static_cast<long long>(strip) * a.strip_rows * plane;  // element offset
  const long long quads = n * plane / 4;
  const bool fused = a.paths == 3 && a.order != kOrderK10;
  for (long long q = tid; q < quads; q += nthreads) {
    float4 g = ldcg4(slot + 4 * q);
    if (a.paths == 3)
      g = add4(add4(g, ldcg4(slot + path_floats + 4 * q)), ldcg4(slot + 2 * path_floats + 4 * q));
    const long long e = first + 4 * q;
    if (!a.up) {
      __stcs(reinterpret_cast<float4*>(a.a_buf + e), g);
      continue;
    }
    const int y = static_cast<int>(e / plane);
    const bool first_row = fused && a.order == kOrderK12 && y == 0;
    const bool last_row = fused && y == a.h - 1;
    const float4 dn = __ldcs(reinterpret_cast<const float4*>(a.a_buf + e));
    const float4 p2 = __ldcs(reinterpret_cast<const float4*>(a.p2_buf + e));
    const float4 p3 = __ldcs(reinterpret_cast<const float4*>(a.p3_buf + e));
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (first_row || last_row) c = __ldg(reinterpret_cast<const float4*>(a.cost + e));
    float4 t;
    t.x = route_total(dn.x, g.x, p2.x, p3.x, c.x, a.order, first_row, last_row);
    t.y = route_total(dn.y, g.y, p2.y, p3.y, c.y, a.order, first_row, last_row);
    t.z = route_total(dn.z, g.z, p2.z, p3.z, c.z, a.order, first_row, last_row);
    t.w = route_total(dn.w, g.w, p2.w, p3.w, c.w, a.order, first_row, last_row);
    __stcs(reinterpret_cast<float4*>(a.out + e), t);
  }
}

// Launches 2 and 3: phases k = 0 .. n_strips, each the walk of strip k (in
// the pass's order) and the combine of strip k - 1, then a grid barrier.
// Walk items go to warps spread over the blocks first (warp rank = warp in
// block * blocks + block); the warps past the walkers combine, or all warps
// combine after their walks when every warp walks.
template <int L, int V>
__global__ void __launch_bounds__(kStripWarps * 32)
sgm_strips_f32_kernel(StripArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  unsigned char* warp_smem = smem + (threadIdx.x >> 5) * strip_warp_bytes<V>();
  const int S = a.strip_rows;
  const int n_strips = (a.h + S - 1) / S;
  const int blocks = gridDim.x;
  const int warps = blocks * kStripWarps;
  const int rank = (threadIdx.x >> 5) * blocks + blockIdx.x;
  const int lane = threadIdx.x & 31;
  for (int k = 0; k <= n_strips; ++k) {
    int walkers = 0;
    if (k < n_strips) {
      const int strip = a.up ? n_strips - 1 - k : k;
      const int n = min(S, a.h - strip * S);
      walkers = (a.w + (a.paths == 3 ? 2 * (a.w + n - 1) : 0) + 32 / L - 1) / (32 / L);
      for (int item = rank; item < walkers; item += warps) {
        Segment sg = plan_segment<L, V>(a, strip, n, item);
        walk_segment<L, V>(a, strip, sg, warp_smem);
      }
    }
    if (k > 0) {
      const int strip = a.up ? n_strips - k : k - 1;
      const int n = min(S, a.h - strip * S);
      const bool all = walkers >= warps;
      const int crank = all ? rank : rank - walkers;
      if (crank >= 0)
        combine_strip(a, strip, n, static_cast<long long>(crank) * 32 + lane,
                      static_cast<long long>(all ? warps : warps - walkers) * 32);
    }
    if (k < n_strips) grid.sync();
  }
}

// The cooperative grid of sgm_strips_f32_kernel<L, V> on the current device:
// every block co-resident (SMs x blocks an SM). The first call on a device
// opts the kernel into its shared memory (above 48 KB).
template <int L, int V>
cudaError_t strips_grid(int* blocks) {
  static int cached[8];  // blocks on each device, 0 until first asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 8 && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  const int smem = kStripWarps * strip_warp_bytes<V>();
  err = cudaFuncSetAttribute(sgm_strips_f32_kernel<L, V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sgm_strips_f32_kernel<L, V>,
                                                      kStripWarps * 32, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = sms * per_sm;
  if (dev < 8) cached[dev] = *blocks;
  return cudaSuccess;
}

template <int L, int V>
cudaError_t launch_strips(StripArgs a, cudaStream_t stream) {
  const int row_warps = (2 * a.h + 32 / L - 1) / (32 / L);
  sgm_rows_f32_kernel<L, V><<<(row_warps + kRowWarps - 1) / kRowWarps, kRowWarps * 32,
                              kRowWarps * row_warp_bytes<V>(), stream>>>(
      a.cost, a.p2_x, a.p2_buf, a.p3_buf, a.h, a.w, a.n_disp, a.p1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = strips_grid<L, V>(&blocks);
  if (err != cudaSuccess) return err;
  for (int up = 0; up < 2; ++up) {  // the down pass, then the up pass
    a.up = up;
    void* params[] = {&a};
    err = cudaLaunchCooperativeKernel((void*)sgm_strips_f32_kernel<L, V>, dim3(blocks),
                                      dim3(kStripWarps * 32), params,
                                      kStripWarps * strip_warp_bytes<V>(), stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// cost: (H, W, D) float32; p2_y/p2_x: (H, W) float32; partial: (P, H, W, D)
// float32 with P = the number of bits set in path_mask (bit p: path id p);
// receives each selected path's L in ascending path id.
SVT_API int svt_sgm_paths_f32(const void* cost, const void* p2_y, const void* p2_x,
                              void* partial, int h, int w, int n_disp, float p1, int path_mask,
                              void* stream) {
  if (h <= 0 || w <= 0 || n_disp < 1 || n_disp > 256 || path_mask <= 0 || path_mask > 255)
    return cudaErrorInvalidValue;
  const auto* c = static_cast<const float*>(cost);
  const auto* py = static_cast<const float*>(p2_y);
  const auto* px = static_cast<const float*>(p2_x);
  auto* out = static_cast<float*>(partial);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_disp <= 32) return launch_f32<1>(c, py, px, out, h, w, n_disp, p1, path_mask, s);
  if (n_disp <= 64) return launch_f32<2>(c, py, px, out, h, w, n_disp, p1, path_mask, s);
  if (n_disp <= 128) return launch_f32<4>(c, py, px, out, h, w, n_disp, p1, path_mask, s);
  return launch_f32<8>(c, py, px, out, h, w, n_disp, p1, path_mask, s);
}

// partial: the (P, H, W, D) float32 output of svt_sgm_paths_f32 over the
// paths of `path_mask`; out: (H, W, D) float32, the sum over the sweeps of
// `sweep_mask` (1 down, 2 up, 4 left->right, 8 right->left) with 4 or 8
// paths in `order` (0 k7, 1 wdh, 2 k10, 3 k12; wdh, k10 and k12 take all
// four sweeps). Every path the sweeps need must be in path_mask.
SVT_API int svt_sgm_combine_f32(const void* partial, void* out, int h, int w, int n_disp,
                                int path_mask, int num_paths, int sweep_mask, int order,
                                void* stream) {
  if (h <= 0 || w <= 0 || n_disp < 1 || (num_paths != 4 && num_paths != 8) || sweep_mask <= 0 ||
      sweep_mask > 15 || order < kOrderK7 || order > kOrderK12 ||
      (order != kOrderK7 && sweep_mask != 15))
    return cudaErrorInvalidValue;
  // sweep -> path ids, as the reference's SWEEP_PATHS_8 / SWEEP_PATHS_4
  const int groups8[4] = {(1 << 0) | (1 << 4) | (1 << 5), (1 << 1) | (1 << 6) | (1 << 7),
                          1 << 2, 1 << 3};
  int needed = 0;
  for (int s = 0; s < 4; ++s)
    if ((sweep_mask >> s) & 1) needed |= num_paths == 8 ? groups8[s] : 1 << s;
  if ((needed & path_mask) != needed) return cudaErrorInvalidValue;
  Slots slots;
  for (int p = 0, slot = 0; p < 8; ++p) slots.of[p] = ((path_mask >> p) & 1) ? slot++ : -1;
  const size_t n = static_cast<size_t>(h) * w * n_disp;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  sgm_combine_f32_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), h, w, n_disp, slots,
      sweep_mask, num_paths == 8, order);
  return cudaGetLastError();
}

// cost: (H, W, D) int8 (cost_bytes 1) or int16 (2); p2_y/p2_x: (H, W) int16;
// total: (H, W, D) int16, written (its contents on entry are never read):
// the sum over the 4 or 8 paths, wrapped into int16; scratch: (P, H, W, D)
// int16 partials, clobbered, P = 4 (8 paths) or 2 (4 paths). Two launches in
// stream order: the walks, then the sum of the partials.
SVT_API int svt_sgm_paths(const void* cost, int cost_bytes, const void* p2_y, const void* p2_x,
                          void* total, void* scratch, int h, int w, int n_disp, int p1,
                          int num_paths, void* stream) {
  if (h <= 0 || w <= 0 || n_disp < 1 || n_disp > 256 || (num_paths != 4 && num_paths != 8) ||
      (cost_bytes != 1 && cost_bytes != 2) ||
      scratch == nullptr)
    return cudaErrorInvalidValue;
  const auto* py = static_cast<const int16_t*>(p2_y);
  const auto* px = static_cast<const int16_t*>(p2_x);
  auto* t = static_cast<int16_t*>(total);
  auto* sc = static_cast<int16_t*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  if (cost_bytes == 1)
    return launch_int<int8_t>(cost, py, px, t, sc, h, w, n_disp, p1, num_paths, s);
  return launch_int<int16_t>(cost, py, px, t, sc, h, w, n_disp, p1, num_paths, s);
}

// K7's strip route (see "K7's strip route" above): the float32 SGM sum over
// all four sweeps, 4 or 8 paths, in `order` (0 k7, 1 wdh, 2 k10, 3 k12).
// cost: (H, W, D) float32; p2_y/p2_x: (H, W) float32; out: (H, W, D) float32,
// written; p2_buf, p3_buf, a_buf: (H, W, D) float32 scratch; ring: (2, P, S,
// W, D) float32 scratch, P = 3 (8 paths) or 1. Three launches in stream
// order: the horizontal walks, the down pass, the up pass (both
// cooperative). Refuses, before any launch, D % 8 != 0, D > 256, buffers not
// 16-byte aligned and a strip height other than ops/sgm_cuda._strip_plan's;
// an error of the cooperative launch is returned.
SVT_API int svt_sgm_float_strips(const void* cost, const void* p2_y, const void* p2_x, void* out,
                                 void* p2_buf, void* p3_buf, void* a_buf, void* ring, int h,
                                 int w, int n_disp, float p1, int num_paths, int order,
                                 int strip_rows, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(cost) | reinterpret_cast<uintptr_t>(out) |
                          reinterpret_cast<uintptr_t>(p2_buf) |
                          reinterpret_cast<uintptr_t>(p3_buf) |
                          reinterpret_cast<uintptr_t>(a_buf) | reinterpret_cast<uintptr_t>(ring);
  if (h <= 0 || w <= 0 || n_disp < kVals || n_disp > 256 || n_disp % kVals != 0 ||
      (num_paths != 4 && num_paths != 8) || order < kOrderK7 || order > kOrderK12 ||
      strip_rows != strip_rows_for(w, n_disp) || align % 16 != 0 || p2_y == nullptr ||
      p2_x == nullptr)
    return cudaErrorInvalidValue;
  StripArgs a;
  a.cost = static_cast<const float*>(cost);
  a.p2_y = static_cast<const float*>(p2_y);
  a.p2_x = static_cast<const float*>(p2_x);
  a.p2_buf = static_cast<float*>(p2_buf);
  a.p3_buf = static_cast<float*>(p3_buf);
  a.a_buf = static_cast<float*>(a_buf);
  a.out = static_cast<float*>(out);
  a.ring = static_cast<float*>(ring);
  a.h = h;
  a.w = w;
  a.n_disp = n_disp;
  a.paths = num_paths == 8 ? 3 : 1;
  a.order = order;
  a.up = 0;
  a.strip_rows = strip_rows;
  a.p1 = p1;
  auto s = static_cast<cudaStream_t>(stream);
  // 4 values a lane (one float4) up to D = 128, 8 above: L = D / V lanes a
  // line, rounded up to a power of two
#define SVT_STRIPS(L, V) launch_strips<L, V>(a, s)
  if (n_disp > 128) return SVT_STRIPS(32, 8);
  const int lanes = n_disp / 4;
  if (lanes <= 2) return SVT_STRIPS(2, 4);
  if (lanes <= 4) return SVT_STRIPS(4, 4);
  if (lanes <= 8) return SVT_STRIPS(8, 4);
  if (lanes <= 16) return SVT_STRIPS(16, 4);
  return SVT_STRIPS(32, 4);
#undef SVT_STRIPS
}
