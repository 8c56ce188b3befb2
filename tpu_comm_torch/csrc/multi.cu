// Hand-written Hopper (sm_90a) kernels for temporal blocking: t fused
// Jacobi steps in one pass over the field (the single-device `multi` arm).
// The port of the TPU kernels
//   tpu_comm/kernels/jacobi1d.py _jacobi1d_multi_kernel (step_pallas_multi)
//   tpu_comm/kernels/jacobi2d.py _jacobi2d_multi_kernel (step_pallas_multi)
//   tpu_comm/kernels/stencil9.py _stencil9_multi_kernel (step_pallas_multi)
//   tpu_comm/kernels/jacobi3d.py _jacobi3d_wave_kernel (step_pallas_multi,
//     the 3.5D wavefront; dirichlet only, as the TPU arm)
// and of the edge fixes those wrappers run outside their kernels
// (_edge_cone_fix_multi, _edge_band_fix_multi_2d, _box_edge_band_fix_multi):
// here every cell, the global edges included, is computed in the kernel.
//
// Built by tpu_comm_torch/kernels/_build.py with
//   nvcc -O3 -gencode=arch=compute_90a,code=sm_90a -fmad=false -shared
// into a shared library with a plain C interface, loaded with ctypes. No
// PyTorch header is included: the Python wrappers pass raw device
// pointers and the current CUDA stream, and raise on a non-zero return.
//
// Numerical contract (shared with step_multi_plain in kernels/jacobi1d.py,
// kernels/jacobi2d.py, kernels/stencil9.py and kernels/jacobi3d.py): the
// input is widened to f32 once, t steps run in f32 in the golden's
// association, each step exactly the single-step kernels' arithmetic:
//   1D        (left + right) * 0.5f
//   2D star   ((up + down) + (left + right)) * 0.25f
//   9-point   (((up + down) + (left + right)) + ((ul + dr) + (ur + dl)))
//             * 0.125f
//   3D star   (((zm + zp) + (ym + yp)) + (xm + xp)) * (float)(1.0 / 6.0)
// and the result is narrowed once, round-to-nearest-even (the TPU kernel's
// f32_compute / one narrow store per pass). The explicit __fadd_rn and
// __fmul_rn are never contracted into an FMA, and -fmad=false guards the
// rest, so f32 results are bitwise equal to t serial golden steps.
// Periodic neighbours wrap modulo the extents; under dirichlet a cell on the
// global ring keeps its input value every step, which makes the ring an
// information barrier: the junk a tile's window holds beyond the field's
// edge never crosses it.
//
// Design (1D, 2D; the 3D wavefront's is set out at its kernel):
// overlapped (trapezoid) tiling. Each block owns one output tile,
// loads the tile plus a t-cell halo on every side (wrapped modulo the
// extents) into shared memory as f32, and runs the t steps ping-pong
// between two shared buffers, the valid region shrinking by one cell a
// side a step, with a barrier between steps; then it stores the tile's
// centre. No block depends on another or on the order of the grid. The
// TPU kernels keep full rows of a strip in VMEM and fix the global edge
// bands outside the kernel; a full f32 row at 8192 is 32 KB, so the 2D
// kernels take square-ish tiles with halos on all four sides instead.
//
// What bounds these on this card: a pass must read and write the field
// once, 2 * N * itemsize bytes, for t steps of 2 (1D), 4 (2D) or 8
// (9-point) operations a cell, which for t = 8 is still below the card's
// ratio of f32 operations to bytes. The trapezoid's recomputed halo (a
// 64 x 64 tile's window is 1.56 times its area at t = 8) and the
// instructions of each cell's step come on top, and they, not DRAM,
// bound these kernels: so a block whose window holds no cell of the
// global dirichlet ring skips the ring test (kFreeze), and a full work
// item runs without bound tests (kFull).
//
// Steps beyond kTMax1 / kTMax2 / kTMax3 are chained by the wrapper into
// sub-passes through an f32 scratch field: a launch can read and write
// either the field's dtype or f32 (Tin, Tout), so the chain narrows only
// once.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// dtype codes shared with tpu_comm_torch/kernels/tiling.py
// KERNEL_DTYPE_CODES
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kFloat16 = 2;

// the most steps one launch runs (the wrappers' T_MAX): 1D from the
// default tile's halo, 2D from the shared memory of a 64 x 64 tile's
// window (96 x 96 f32, two buffers: 72 KB)
constexpr int kTMax1 = 256;
constexpr int kTMax2 = 16;
// the dynamic shared memory one block may use on sm_90
constexpr int kMaxSmem = 232448;

// widen/narrow as in jacobi_stream.cu: each source builds into a library
// of its own, named by a hash of that one file
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float v) {
  return __float2half_rn(v);
}

// i wrapped into [0, n), for any i (a window's halo may exceed n when the
// field is narrower than t)
__device__ __forceinline__ int64_t wrap_any(int64_t i, int64_t n) {
  if (i >= 0 && i < n) return i;
  i %= n;
  return i < 0 ? i + n : i;
}

// kV elements moved as one access: 16 bytes when kV = 16 / sizeof(T)
template <typename T, int kV>
struct alignas(sizeof(T) * kV) Vec {
  T e[kV];
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// global loads a thread issues before it writes the first of them to
// shared memory: the window's fill is bounded by DRAM latency otherwise
constexpr int kBatch = 8;

// ---------------------------------------------------------------------------
// 1D: replaces _jacobi1d_multi_kernel and _edge_cone_fix_multi.
//
// A block owns `tile` consecutive outputs; its window is the tile plus t
// cells each side. The tile's body is loaded and stored as 16-byte vectors
// when the pointers, the tile and the field's end allow it (vec_in /
// vec_out, decided per block), the halos as scalars. A step gives each
// thread kUnroll1 cells a round (256 apart: conflict-free), loading all
// their neighbours before it stores the first.
// ---------------------------------------------------------------------------
constexpr int kThreads1 = 256;
constexpr int kUnroll1 = 4;

// One step of the window: src -> dst over [s, w - s); under kFreeze the
// cells f0 and f1 (the global ends, or -1) keep their value. kUnroll1
// cells a thread a round, all loads before any store.
template <bool kFreeze>
__device__ __forceinline__ void line_step(const float* src, float* dst,
                                          int w, int s, int f0, int f1) {
  for (int i0 = s + threadIdx.x; i0 < w - s; i0 += kUnroll1 * kThreads1) {
    float left[kUnroll1];
    float right[kUnroll1];
#pragma unroll
    for (int k = 0; k < kUnroll1; ++k) {
      const int i = min(i0 + k * kThreads1, w - 2);
      left[k] = src[i - 1];
      right[k] = src[i + 1];
    }
#pragma unroll
    for (int k = 0; k < kUnroll1; ++k) {
      const int i = i0 + k * kThreads1;
      if (i < w - s) {
        dst[i] = (kFreeze && (i == f0 || i == f1))
                     ? src[i]
                     : __fmul_rn(__fadd_rn(left[k], right[k]), 0.5f);
      }
    }
  }
}

template <typename Tin, typename Tout, bool kPeriodic>
__global__ void __launch_bounds__(kThreads1)
    jacobi1d_multi_kernel(const Tin* __restrict__ u, Tout* __restrict__ out,
                          int64_t n, int tile, int t, bool vec_in,
                          bool vec_out) {
  extern __shared__ float smem[];
  constexpr int kVi = 16 / sizeof(Tin);
  constexpr int kVo = 16 / sizeof(Tout);
  const int w = tile + 2 * t;
  float* a = smem;
  float* b = smem + w;
  const int64_t x0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t g0 = x0 - t;  // global index of window cell 0
  const bool whole = x0 + tile <= n;
  if (vec_in && whole) {
    for (int i = threadIdx.x; i < 2 * t; i += kThreads1) {
      const int j = i < t ? i : i + tile;
      a[j] = widen(u[wrap_any(g0 + j, n)]);
    }
    const auto* src = reinterpret_cast<const Vec<Tin, kVi>*>(u + x0);
    const int nv = tile / kVi;
    for (int v0 = threadIdx.x; v0 < nv; v0 += kBatch * kThreads1) {
      Vec<Tin, kVi> c[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (v0 + j * kThreads1 < nv) c[j] = src[v0 + j * kThreads1];
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int v = v0 + j * kThreads1;
        if (v < nv) {
#pragma unroll
          for (int k = 0; k < kVi; ++k) a[t + v * kVi + k] = widen(c[j].e[k]);
        }
      }
    }
  } else {
    for (int i0 = threadIdx.x; i0 < w; i0 += kBatch * kThreads1) {
      float c[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * kThreads1;
        if (i < w) c[j] = widen(u[wrap_any(g0 + i, n)]);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (i0 + j * kThreads1 < w) a[i0 + j * kThreads1] = c[j];
      }
    }
  }
  __syncthreads();
  // the window indices of the two global ends (-1 where the window does
  // not hold one): the cells a dirichlet step keeps
  const int f0 = !kPeriodic && g0 <= 0 && -g0 < w ? static_cast<int>(-g0)
                                                  : -1;
  const int f1 = !kPeriodic && n - 1 - g0 < w ? static_cast<int>(n - 1 - g0)
                                              : -1;
  for (int s = 1; s <= t; ++s) {
    if (f0 >= 0 || f1 >= 0) {
      line_step<true>(a, b, w, s, f0, f1);
    } else {
      line_step<false>(a, b, w, s, f0, f1);
    }
    __syncthreads();
    float* tmp = a;
    a = b;
    b = tmp;
  }
  if (vec_out && whole) {
    auto* dst = reinterpret_cast<Vec<Tout, kVo>*>(out + x0);
    for (int v = threadIdx.x; v < tile / kVo; v += kThreads1) {
      Vec<Tout, kVo> r;
#pragma unroll
      for (int k = 0; k < kVo; ++k) r.e[k] = narrow<Tout>(a[t + v * kVo + k]);
      dst[v] = r;
    }
  } else {
    for (int i = threadIdx.x; i < tile && x0 + i < n; i += kThreads1) {
      out[x0 + i] = narrow<Tout>(a[t + i]);
    }
  }
}

// ---------------------------------------------------------------------------
// 2D star and 9-point box: replace _jacobi2d_multi_kernel /
// _edge_band_fix_multi_2d and _stencil9_multi_kernel /
// _box_edge_band_fix_multi.
//
// A block of 256 threads owns a tile of tile_y x tile_x outputs; its
// window is the tile plus t cells on all four sides, row-major in shared
// memory with a row stride of tile_x + 2t. A step's valid region is cut
// into work items of one column by kSeg rows; consecutive threads take
// consecutive columns, so a warp's shared accesses are conflict-free (a
// warp that straddles two row segments pays at most two-way). An item
// loads its rows and the two rows around them, three columns wide, into
// registers first (3.25 loads a cell for the star, 3.75 for the box,
// where a cell read straight from shared memory would take 4 and 8),
// then computes and stores its kSeg cells: the loads of an item do not
// wait on its stores.
// ---------------------------------------------------------------------------
constexpr int kThreads2 = 256;
constexpr int kSeg = 8;

// the 8-neighbour sum of the golden (box.cu's box8)
__device__ __forceinline__ float box8(float up, float down, float left,
                                      float right, float ul, float ur,
                                      float dl, float dr) {
  return __fadd_rn(__fadd_rn(__fadd_rn(up, down), __fadd_rn(left, right)),
                   __fadd_rn(__fadd_rn(ul, dr), __fadd_rn(ur, dl)));
}

// One work item: column c, rows [rs, re) of a step, src -> dst. w[k] holds
// row rs - 1 + k, columns c - 1, c, c + 1. kFull: the item has all kSeg
// rows (re == rs + kSeg), so no row is past the window's last and no
// output needs a bound test; otherwise rows past the last are clamped
// onto it (they feed no output). kFreeze: cells of the global dirichlet
// ring (edge_col, or row gy == 0 or ny - 1) keep their value.
template <bool kFreeze, bool kBox, bool kFull>
__device__ __forceinline__ void column_item(const float* src, float* dst,
                                            int wy, int wx, int c, int rs,
                                            int re, int y0, int ny,
                                            bool edge_col) {
  float w[kSeg + 2][3];
#pragma unroll
  for (int k = 0; k < kSeg + 2; ++k) {
    const float* p =
        src + (kFull ? rs - 1 + k : min(rs - 1 + k, wy - 1)) * wx + c;
    w[k][1] = p[0];
    if (kBox || (k > 0 && k < kSeg + 1)) {
      w[k][0] = p[-1];
      w[k][2] = p[1];
    }
  }
#pragma unroll
  for (int k = 1; k <= kSeg; ++k) {
    const int r = rs - 1 + k;
    if (kFull || r < re) {
      const int gy = y0 + r;
      float v;
      if (kFreeze && (edge_col || gy == 0 || gy == ny - 1)) {
        v = w[k][1];
      } else if (kBox) {
        v = __fmul_rn(box8(w[k - 1][1], w[k + 1][1], w[k][0], w[k][2],
                           w[k - 1][0], w[k - 1][2], w[k + 1][0],
                           w[k + 1][2]),
                      0.125f);
      } else {
        v = __fmul_rn(__fadd_rn(__fadd_rn(w[k - 1][1], w[k + 1][1]),
                                __fadd_rn(w[k][0], w[k][2])),
                      0.25f);
      }
      dst[r * wx + c] = v;
    }
  }
}

// One step of the window: src -> dst over rows and columns [s, w - s).
// (y0, x0) is the global cell of window cell (0, 0). kFreeze: the window
// holds a cell of the global dirichlet ring (block-uniform; the other
// blocks skip the test).
template <bool kFreeze, bool kBox>
__device__ __forceinline__ void window_step(const float* src, float* dst,
                                            int wy, int wx, int s, int y0,
                                            int x0, int ny, int nx) {
  const int ncols = wx - 2 * s;
  const int nrows = wy - 2 * s;
  const int items = ncols * ((nrows + kSeg - 1) / kSeg);
  // item = seg * ncols + col, advanced by kThreads2 without a division
  const int dseg = kThreads2 / ncols;
  const int dcol = kThreads2 % ncols;
  int seg = threadIdx.x / ncols;
  int col = threadIdx.x % ncols;
  for (int item = threadIdx.x; item < items; item += kThreads2) {
    const int c = s + col;
    const int rs = s + seg * kSeg;  // first row of the item
    const int re = min(rs + kSeg, wy - s);
    col += dcol;
    seg += dseg;
    if (col >= ncols) {
      col -= ncols;
      ++seg;
    }
    const int gx = x0 + c;
    const bool edge_col = kFreeze && (gx == 0 || gx == nx - 1);
    if (re == rs + kSeg) {
      column_item<kFreeze, kBox, true>(src, dst, wy, wx, c, rs, re, y0, ny,
                                       edge_col);
    } else {
      column_item<kFreeze, kBox, false>(src, dst, wy, wx, c, rs, re, y0, ny,
                                        edge_col);
    }
  }
}

template <typename Tin, typename Tout, bool kPeriodic, bool kBox>
__global__ void __launch_bounds__(kThreads2)
    multi2d_kernel(const Tin* __restrict__ u, Tout* __restrict__ out, int ny,
                   int nx, int tile_y, int tile_x, int t) {
  extern __shared__ float smem[];
  const int wy = tile_y + 2 * t;
  const int wx = tile_x + 2 * t;
  float* a = smem;
  float* b = smem + wy * wx;
  // global row and column of window cell (0, 0)
  const int y0 = static_cast<int>(blockIdx.y) * tile_y - t;
  const int x0 = static_cast<int>(blockIdx.x) * tile_x - t;
  const int cells = wy * wx;
  for (int i0 = threadIdx.x; i0 < cells; i0 += kBatch * kThreads2) {
    float c[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kThreads2;
      if (i < cells) {
        const int r = i / wx;
        c[j] = widen(
            u[wrap_any(y0 + r, ny) * nx + wrap_any(x0 + i - r * wx, nx)]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (i0 + j * kThreads2 < cells) a[i0 + j * kThreads2] = c[j];
    }
  }
  __syncthreads();
  // does the window hold a cell of the global dirichlet ring?
  const bool freeze = !kPeriodic && (y0 <= 0 || y0 + wy >= ny || x0 <= 0 ||
                                     x0 + wx >= nx);
  for (int s = 1; s <= t; ++s) {
    if (freeze) {
      window_step<true, kBox>(a, b, wy, wx, s, y0, x0, ny, nx);
    } else {
      window_step<false, kBox>(a, b, wy, wx, s, y0, x0, ny, nx);
    }
    __syncthreads();
    float* tmp = a;
    a = b;
    b = tmp;
  }
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
  for (int r = ty; r < tile_y; r += kThreads2 / 32) {
    const int gy = y0 + t + r;
    if (gy >= ny) break;
    Tout* row = out + static_cast<int64_t>(gy) * nx;
    for (int c = tx; c < tile_x; c += 32) {
      const int gx = x0 + t + c;
      if (gx >= nx) break;
      row[gx] = narrow<Tout>(a[(r + t) * wx + c + t]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3D 7-point: the 3.5D wavefront, replaces tpu_comm/kernels/jacobi3d.py
// _jacobi3d_wave_kernel (step_pallas_multi).
//
// The TPU kernel runs its grid over z in order and keeps, for each of its
// t levels, a two-plane f32 ring of whole planes in VMEM that persists
// across grid steps; at step k it receives plane k and advances level v to
// plane k - v. CUDA blocks run at once and in no order (ROADMAP Trap 1),
// and a whole f32 plane at 512^2 is 1 MiB, so here a block owns a (y, x)
// tile of outputs and a z range, and marches z over a window of the tile
// plus a kT-cell apron on every side (and kT planes more at each end of
// the range). A thread owns kRows3 consecutive window rows of one column.
// Level v of plane j needs level v - 1 of planes j - 1, j and j + 1: the
// thread keeps, per level, its cells' last two planes in registers (the z
// neighbours, and the y neighbours inside its rows), and the block keeps,
// per level, the window's two newest planes in shared memory, plane j at
// parity j & 1 (the x neighbours, and the y neighbours across two
// threads' rows). At march step k the thread loads level 0 of plane k + 1
// ahead (its latency hides behind the step), and for v = 1..kT publishes
// level v - 1 of plane k - v + 1 and computes level v of plane k - v from
// level v - 1 of plane k - v, which the step before published in the other
// parity: one barrier a step, where a single plane a level would need one
// a level. Level v is valid on the window shrunk by v cells a side
// and on the planes of the range widened by kT - v; the rest of the window
// computes nothing. Every level keeps the global shell (the y/x ring and
// the planes 0 and nz - 1) at its previous level's value, as the TPU
// kernel re-freezes it each level: a frozen cell is an information
// barrier, so no cell outside the field is ever read. kT levels a launch;
// the wrapper chains more through an f32 scratch field.
//
// What bounds it: a pass reads and writes the field once (2 * N * itemsize
// bytes) for t steps of 6 operations a cell. The apron costs on top: the
// window's (1 + 2t / tile)^2 of the tile's loads (from L2 mostly: the
// neighbouring tiles read the same cells), and levels below t computed on
// the wider windows; and the block's barrier a plane. On the H100 a level
// costs most (PERF.md), so the default tile is the largest window a block
// holds: 56 x 56 outputs, 64 x 64 cells at t = 4.
// ---------------------------------------------------------------------------
// the most steps one launch runs (the wrapper's T_MAX for 3D): one kernel
// instantiation each
constexpr int kTMax3 = 4;
// the window rows a thread owns, and the most threads a block has
constexpr int kRows3 = 4;
constexpr int kMaxThreads3 = 1024;

template <typename Tin, typename Tout, int kT>
__global__ void __launch_bounds__(kMaxThreads3)
    jacobi3d_multi_kernel(const Tin* __restrict__ u, Tout* __restrict__ out,
                          int nz, int ny, int nx, int tile_y, int tile_x) {
  // plane j of level v (0 .. kT - 1) of the window at
  // lev + (2 * v + (j & 1)) * cells
  extern __shared__ float lev[];
  const float sixth = static_cast<float>(1.0 / 6.0);
  const int wx = blockDim.x;
  const int wy = tile_y + 2 * kT;
  const int cells = wx * blockDim.y * kRows3;
  const int tx = threadIdx.x;
  const int r0 = threadIdx.y * kRows3;  // this thread's first window row
  const int gx = static_cast<int>(blockIdx.x) * tile_x - kT + tx;
  const int gy0 = static_cast<int>(blockIdx.y) * tile_y - kT + r0;
  const int dx = min(tx, wx - 1 - tx);
  // per row: the levels the cell takes part in (v <= dep; -1: none, the
  // cell lies outside the field or the window), and whether it is on the
  // global y/x ring (bit i)
  int dep[kRows3];
  unsigned ring = 0;
#pragma unroll
  for (int i = 0; i < kRows3; ++i) {
    const int r = r0 + i;
    const int gy = gy0 + i;
    const bool in = gx >= 0 && gx < nx && gy >= 0 && gy < ny && r < wy;
    dep[i] = in ? min(dx, min(r, wy - 1 - r)) : -1;
    if (gy == 0 || gy == ny - 1 || gx == 0 || gx == nx - 1) ring |= 1u << i;
  }
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t col = static_cast<int64_t>(gy0) * nx + gx;  // row r0's cell
  const int z0 = static_cast<int>(int64_t{nz} * blockIdx.z / gridDim.z);
  const int z1 = static_cast<int>(int64_t{nz} * (blockIdx.z + 1) / gridDim.z);
  // level v is computed on the planes [lo(v), hi(v))
  auto lo = [&](int v) { return max(z0 - kT + v, 0); };
  auto hi = [&](int v) { return min(z1 + kT - v, nz); };
  auto load = [&](int p, float (&dst)[kRows3]) {
#pragma unroll
    for (int i = 0; i < kRows3; ++i) {
      if (dep[i] >= 0) dst[i] = widen(u[p * plane + col + i * nx]);
    }
  };
  // per level below kT: this thread's cells' last two planes (prev the
  // older)
  float prev[kT][kRows3];
  float cur[kT][kRows3];
  float ahead[kRows3];
#pragma unroll
  for (int i = 0; i < kRows3; ++i) {
    ahead[i] = 0.0f;
#pragma unroll
    for (int v = 0; v < kT; ++v) prev[v][i] = cur[v][i] = 0.0f;
  }
  if (lo(0) < hi(0)) load(lo(0), ahead);
  for (int k = lo(0); k < z1 + kT; ++k) {
    // level 0 of plane k, and the load of plane k + 1
    float fresh[kRows3];
#pragma unroll
    for (int i = 0; i < kRows3; ++i) fresh[i] = ahead[i];
    bool have = k < hi(0);
    if (k + 1 < hi(0)) load(k + 1, ahead);
#pragma unroll
    for (int v = 1; v <= kT; ++v) {
      const int j = k - v;
      const bool act = j >= lo(v) && j < hi(v);
      const bool face = j == 0 || j == nz - 1;
      // level v - 1 of plane j + 1 (just computed) is published, and of
      // plane j (published the step before) read, at this thread's first
      // cell
      const int at = r0 * wx + tx;
      float* newer = lev + (2 * (v - 1) + ((j + 1) & 1)) * cells + at;
      const float* below = lev + (2 * (v - 1) + (j & 1)) * cells + at;
      if (have) {
#pragma unroll
        for (int i = 0; i < kRows3; ++i) newer[i * wx] = fresh[i];
      }
      float res[kRows3];
#pragma unroll
      for (int i = 0; i < kRows3; ++i) {
        res[i] = 0.0f;
        if (act && dep[i] >= v) {
          if (face || (ring >> i & 1u)) {
            res[i] = cur[v - 1][i];
          } else {
            const float ym = i > 0 ? cur[v - 1][i - 1] : below[-wx];
            const float yp =
                i < kRows3 - 1 ? cur[v - 1][i + 1] : below[kRows3 * wx];
            res[i] = __fmul_rn(
                __fadd_rn(__fadd_rn(__fadd_rn(prev[v - 1][i], fresh[i]),
                                    __fadd_rn(ym, yp)),
                          __fadd_rn(below[i * wx - 1], below[i * wx + 1])),
                sixth);
          }
        }
      }
      if (have) {
#pragma unroll
        for (int i = 0; i < kRows3; ++i) {
          prev[v - 1][i] = cur[v - 1][i];
          cur[v - 1][i] = fresh[i];
        }
      }
#pragma unroll
      for (int i = 0; i < kRows3; ++i) fresh[i] = res[i];
      have = act;
    }
    const int j = k - kT;
    if (j >= z0 && j < z1) {
#pragma unroll
      for (int i = 0; i < kRows3; ++i) {
        if (dep[i] >= kT) {
          out[j * plane + col + i * nx] = narrow<Tout>(fresh[i]);
        }
      }
    }
    // this step's publications are visible, and its reads done before the
    // next step overwrites their parity
    __syncthreads();
  }
}

// grid.y is limited to 65535 blocks
constexpr int kMaxGridY = 65535;

// Opt a kernel into more than 48 KB of dynamic shared memory, once.
template <typename K>
int allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
}

template <typename Tin, typename Tout, bool kPeriodic>
int launch1d_bc(const void* u, void* out, int64_t n, int tile, int t,
                cudaStream_t stream) {
  auto kernel = jacobi1d_multi_kernel<Tin, Tout, kPeriodic>;
  static const int opted = allow_smem(kernel);
  if (opted != 0) return opted;
  const size_t smem = 2 * static_cast<size_t>(tile + 2 * t) * sizeof(float);
  const bool vec_in = aligned16(u) && tile % (16 / sizeof(Tin)) == 0;
  const bool vec_out = aligned16(out) && tile % (16 / sizeof(Tout)) == 0;
  const int64_t blocks = (n + tile - 1) / tile;
  kernel<<<static_cast<unsigned>(blocks), kThreads1, smem, stream>>>(
      static_cast<const Tin*>(u), static_cast<Tout*>(out), n, tile, t, vec_in,
      vec_out);
  return cudaGetLastError();
}

template <typename Tin, typename Tout, bool kBox, bool kPeriodic>
int launch2d_bc(const void* u, void* out, int ny, int nx, int tile_y,
                int tile_x, int t, cudaStream_t stream) {
  auto kernel = multi2d_kernel<Tin, Tout, kPeriodic, kBox>;
  static const int opted = allow_smem(kernel);
  if (opted != 0) return opted;
  const size_t smem = 2 * static_cast<size_t>(tile_y + 2 * t) *
                      (tile_x + 2 * t) * sizeof(float);
  const dim3 grid((nx + tile_x - 1) / tile_x, (ny + tile_y - 1) / tile_y);
  kernel<<<grid, kThreads2, smem, stream>>>(
      static_cast<const Tin*>(u), static_cast<Tout*>(out), ny, nx, tile_y,
      tile_x, t);
  return cudaGetLastError();
}

template <typename T>
struct Tag {
  using type = T;
};

// Call f(Tag<Tin>, Tag<Tout>) for the dtype codes of a launch: the same
// dtype in and out (one pass), or one of the two f32 (a sub-pass of a
// chain through the f32 scratch field).
template <typename F>
int with_dtypes(int in, int out, F&& f) {
  switch (in * 3 + out) {
    case kFloat32 * 3 + kFloat32:
      return f(Tag<float>{}, Tag<float>{});
    case kBFloat16 * 3 + kBFloat16:
      return f(Tag<__nv_bfloat16>{}, Tag<__nv_bfloat16>{});
    case kFloat16 * 3 + kFloat16:
      return f(Tag<__half>{}, Tag<__half>{});
    case kBFloat16 * 3 + kFloat32:
      return f(Tag<__nv_bfloat16>{}, Tag<float>{});
    case kFloat32 * 3 + kBFloat16:
      return f(Tag<float>{}, Tag<__nv_bfloat16>{});
    case kFloat16 * 3 + kFloat32:
      return f(Tag<__half>{}, Tag<float>{});
    case kFloat32 * 3 + kFloat16:
      return f(Tag<float>{}, Tag<__half>{});
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kBox>
int launch2d(const void* u, void* out, int ny, int nx, int in_dtype,
             int out_dtype, int periodic, int tile_y, int tile_x, int t,
             void* stream) {
  const int64_t smem = 2LL * (tile_y + 2 * t) * (tile_x + 2 * t) * 4;
  if (ny < 3 || nx < 3 || t < 1 || t > kTMax2 || tile_y < 1 || tile_x < 1 ||
      smem > kMaxSmem || (ny + tile_y - 1) / tile_y > kMaxGridY) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  return with_dtypes(in_dtype, out_dtype, [&](auto ti, auto to) {
    using Tin = typename decltype(ti)::type;
    using Tout = typename decltype(to)::type;
    return periodic ? launch2d_bc<Tin, Tout, kBox, true>(u, out, ny, nx,
                                                         tile_y, tile_x, t, s)
                    : launch2d_bc<Tin, Tout, kBox, false>(
                          u, out, ny, nx, tile_y, tile_x, t, s);
  });
}

template <typename Tin, typename Tout, int kT>
int launch3d_t(const void* u, void* out, int nz, int ny, int nx, int tile_y,
               int tile_x, cudaStream_t stream) {
  auto kernel = jacobi3d_multi_kernel<Tin, Tout, kT>;
  static const int opted = allow_smem(kernel);
  if (opted != 0) return opted;
  const dim3 block(tile_x + 2 * kT, (tile_y + 2 * kT + kRows3 - 1) / kRows3);
  const size_t smem = static_cast<size_t>(2 * kT) * block.x * block.y *
                      kRows3 * sizeof(float);
  const int tiles_x = (nx + tile_x - 1) / tile_x;
  const int tiles_y = (ny + tile_y - 1) / tile_y;
  // z ranges: enough for four waves of resident blocks (one leaves SMs
  // idle behind the blocks' barriers); each adds 2 * kT planes of apron
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, static_cast<int>(block.x * block.y), smem);
  }
  if (err != cudaSuccess) return err;
  const int64_t tiles = static_cast<int64_t>(tiles_x) * tiles_y;
  const int64_t resident =
      static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  int64_t ranges = (4 * resident + tiles - 1) / tiles;
  const int64_t most = nz < kMaxGridY ? nz : kMaxGridY;
  ranges = ranges < 1 ? 1 : (ranges > most ? most : ranges);
  const dim3 grid(tiles_x, tiles_y, static_cast<unsigned>(ranges));
  kernel<<<grid, block, smem, stream>>>(static_cast<const Tin*>(u),
                                        static_cast<Tout*>(out), nz, ny, nx,
                                        tile_y, tile_x);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
int launch3d(const void* u, void* out, int nz, int ny, int nx, int tile_y,
             int tile_x, int t, cudaStream_t stream) {
  switch (t) {
    case 1:
      return launch3d_t<Tin, Tout, 1>(u, out, nz, ny, nx, tile_y, tile_x,
                                      stream);
    case 2:
      return launch3d_t<Tin, Tout, 2>(u, out, nz, ny, nx, tile_y, tile_x,
                                      stream);
    case 3:
      return launch3d_t<Tin, Tout, 3>(u, out, nz, ny, nx, tile_y, tile_x,
                                      stream);
    case 4:
      return launch3d_t<Tin, Tout, 4>(u, out, nz, ny, nx, tile_y, tile_x,
                                      stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface. Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched), so a refused launch is reported to
// the wrapper instead of vanishing; cudaErrorInvalidValue for arguments
// the kernels do not take. in_dtype / out_dtype are the dtype codes of u
// and out: equal, or one of them f32 (a sub-pass of a chained pass).
extern "C" {

int tc_jacobi1d_multi(const void* u, void* out, int64_t n, int in_dtype,
                      int out_dtype, int periodic, int tile, int t,
                      void* stream) {
  const int64_t smem = 2LL * (tile + 2 * t) * 4;
  if (n < 3 || t < 1 || t > kTMax1 || tile < 1 || smem > kMaxSmem ||
      (n + tile - 1) / tile > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  return with_dtypes(in_dtype, out_dtype, [&](auto ti, auto to) {
    using Tin = typename decltype(ti)::type;
    using Tout = typename decltype(to)::type;
    return periodic ? launch1d_bc<Tin, Tout, true>(u, out, n, tile, t, s)
                    : launch1d_bc<Tin, Tout, false>(u, out, n, tile, t, s);
  });
}

int tc_jacobi2d_multi(const void* u, void* out, int ny, int nx, int in_dtype,
                      int out_dtype, int periodic, int tile_y, int tile_x,
                      int t, void* stream) {
  return launch2d<false>(u, out, ny, nx, in_dtype, out_dtype, periodic,
                         tile_y, tile_x, t, stream);
}

int tc_stencil9_multi(const void* u, void* out, int ny, int nx, int in_dtype,
                      int out_dtype, int periodic, int tile_y, int tile_x,
                      int t, void* stream) {
  return launch2d<true>(u, out, ny, nx, in_dtype, out_dtype, periodic,
                        tile_y, tile_x, t, stream);
}

int tc_jacobi3d_multi(const void* u, void* out, int nz, int ny, int nx,
                      int in_dtype, int out_dtype, int periodic, int tile_y,
                      int tile_x, int t, void* stream) {
  // dirichlet only, as the TPU arm: the frozen shell is the barrier
  if (nz < 2 || ny < 3 || nx < 3 || periodic || t < 1 || t > kTMax3 ||
      tile_y < 1 || tile_x < 1 ||
      static_cast<int64_t>(tile_x + 2 * t) *
              ((tile_y + 2 * t + kRows3 - 1) / kRows3) >
          kMaxThreads3 ||
      (ny + tile_y - 1) / tile_y > kMaxGridY) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  return with_dtypes(in_dtype, out_dtype, [&](auto ti, auto to) {
    using Tin = typename decltype(ti)::type;
    using Tout = typename decltype(to)::type;
    return launch3d<Tin, Tout>(u, out, nz, ny, nx, tile_y, tile_x, t, s);
  });
}

const char* tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
