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
// Design (1D; the 2D and 3D kernels' are set out at their kernels):
// overlapped (trapezoid) tiling. Each block owns one output tile,
// loads the tile plus a t-cell halo on every side (wrapped modulo the
// extents) into shared memory as f32, and runs the t steps ping-pong
// between two shared buffers, the valid region shrinking by one cell a
// side a step, with a barrier between steps; then it stores the tile's
// centre. No block depends on another or on the order of the grid. The
// TPU kernels keep full rows of a strip in VMEM and fix the global edge
// bands outside the kernel; here every cell is computed in the kernel.
//
// What bounds these on this card: a pass must read and write the field
// once, 2 * N * itemsize bytes, for t steps of 2 (1D), 4 (2D), 8
// (9-point) or 6 (3D) operations a cell, which for t = 8 is still below
// the card's ratio of f32 operations to bytes. The trapezoid's recomputed
// halo and the instructions of each cell's step come on top, and they,
// not DRAM, bound these kernels: so a block whose window holds no cell of
// the global dirichlet ring skips the ring test (kFreeze, kEdge).
//
// Steps beyond kTMax1 / kTMax2 / kTMax3 are chained by the wrapper into
// sub-passes through an f32 scratch field: a launch can read and write
// either the field's dtype or f32 (Tin, Tout), so the chain narrows only
// once.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

// dtype codes shared with tpu_comm_torch/kernels/tiling.py
// KERNEL_DTYPE_CODES
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kFloat16 = 2;

// the most steps one launch runs (the wrappers' T_MAX): 1D from the
// default tile's halo, 2D from the registers of a lane's level rings
// (kTMax2 levels of three rows of kCols2 columns)
constexpr int kTMax1 = 256;
constexpr int kTMax2 = 8;
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

bool aligned_to(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
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
// A register-streamed wavefront, one warp a block and no shared memory.
// The warp owns a strip of 32 * kCols2 window columns (each lane kCols2
// neighbouring columns) and marches down the rows of its tile plus
// a t-row apron above and below; the strip's outputs are its window less
// t columns a side (112 of 128 at t = 8). Level v of row j needs level
// v - 1 of rows j - 1, j and j + 1: each lane keeps, per level below t,
// its columns' last three rows in registers (a three-slot ring, the slot
// a row lands in fixed by its march step modulo 3, so no value moves), and
// the columns beside its own come from the lanes beside it by warp
// shuffles. At march step s the warp receives row s of level 0 (loaded
// three steps ahead into registers) and for v = 1..t computes level v of
// row s - v; level t is stored. Lanes at the strip's two ends read junk
// through the shuffles, as the columns past the window: the valid region
// of level v is the window less v columns a side, and the trapezoid keeps
// junk out of it. Rows above and below the field wrap (periodic) or are
// read wrapped and never cross the frozen dirichlet ring. Only the strips
// whose march holds a ring cell test for it (kFreeze), by selects; their
// tiles are dealt out first (edge_first), so that these slower blocks do
// not trail the last wave.
//
// What bounds it: a pass reads and writes the field once, for t steps of
// 4 (star) or 8 (box) operations a cell; the card's f32 rate is far
// above that, and the instructions a cell (the operations, 1/2 or 3/2
// shuffles, no shared memory, no barrier) are what is left. The apron
// costs 2t of 32 * kCols2 columns and 2t rows of a tile's march.
// ---------------------------------------------------------------------------
constexpr int kWarp = 32;
// the columns a lane holds: one 16-byte f32 vector
constexpr int kCols2 = 4;
constexpr unsigned kFullMask = 0xffffffffu;
// the warps (blocks) of the 2D kernel an SM holds at least: its
// registers capped to fit them (168; ptxas then spills a few words in the
// dirichlet forms; uncapped, the box form ran slower and the star no
// faster)
constexpr int kWarps2 = 12;

// a rounded down to a multiple of k (k > 0), for any sign of a
__host__ __device__ __forceinline__ int floor_to(int a, int k) {
  return (a >= 0 ? a / k : -((-a + k - 1) / k)) * k;
}

// the 8-neighbour sum of the golden (box.cu's box8)
__device__ __forceinline__ float box8(float up, float down, float left,
                                      float right, float ul, float ur,
                                      float dl, float dr) {
  return __fadd_rn(__fadd_rn(__fadd_rn(up, down), __fadd_rn(left, right)),
                   __fadd_rn(__fadd_rn(ul, dr), __fadd_rn(ur, dl)));
}

// The neighbours of a lane's kC cells in a row held across the warp: the
// column left of its first and right of its last, from the lanes beside.
template <int kC>
__device__ __forceinline__ void sides(const float (&r)[kC], float& left,
                                      float& right) {
  left = __shfl_up_sync(kFullMask, r[kC - 1], 1);
  right = __shfl_down_sync(kFullMask, r[0], 1);
}

// One strip of a tile: window columns [xw, xw + 32 * kC), outputs
// [xo, xs) of the rows [yb, ye). kFreeze: the march holds a cell of the
// global dirichlet ring (warp-uniform; the other strips skip the tests).
template <typename Tin, typename Tout, bool kBox, bool kFreeze>
__device__ __forceinline__ void multi2d_strip(const Tin* __restrict__ u,
                                              Tout* __restrict__ out, int ny,
                                              int nx, int t, int yb, int ye,
                                              int xw, int xo, int xs,
                                              bool vec_in, bool vec_out) {
  constexpr int kC = kCols2;
  constexpr int kL = kTMax2;
  using VecIn = Vec<Tin, kC>;
  using VecOut = Vec<Tout, kC>;
  const int gx0 = xw + static_cast<int>(threadIdx.x) * kC;
  // a lane whose columns all lie in the field loads them as one vector;
  // the others load kC scalars at their wrapped columns
  const bool vload = vec_in && gx0 >= 0 && gx0 + kC <= nx;
  int gc[kC];
  unsigned ring = 0;  // bit c: column gx0 + c is on the ring
  unsigned own = 0;   // bit c: column gx0 + c is an output of the strip
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int gx = gx0 + c;
    gc[c] = static_cast<int>(wrap_any(gx, nx));
    if (kFreeze && (gx == 0 || gx == nx - 1)) ring |= 1u << c;
    if (gx >= xo && gx < xs) own |= 1u << c;
  }
  const bool vstore = vec_out && own == (1u << kC) - 1;
  const int r_lo = yb - t;  // the row of level 0 at march step 0
  const int steps = ye - yb + 2 * t;
  auto load = [&](int s, VecIn& dst) {
    if (s >= steps) return;
    // the row wrapped into the field (a loop: the march's rows lie at most
    // t beyond it, and a field may be fewer rows than t)
    int gy = r_lo + s;
    while (gy < 0) gy += ny;
    while (gy >= ny) gy -= ny;
    const Tin* row = u + static_cast<int64_t>(gy) * nx;
    if (vload) {
      dst = *reinterpret_cast<const VecIn*>(row + gx0);
    } else {
#pragma unroll
      for (int c = 0; c < kC; ++c) dst.e[c] = row[gc[c]];
    }
  };
  auto store = [&](int gy, const float (&res)[kC]) {
    Tout* row = out + static_cast<int64_t>(gy) * nx + gx0;
    if (vstore) {
      VecOut r;
#pragma unroll
      for (int c = 0; c < kC; ++c) r.e[c] = narrow<Tout>(res[c]);
      *reinterpret_cast<VecOut*>(row) = r;
    } else {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (own >> c & 1u) row[c] = narrow<Tout>(res[c]);
      }
    }
  };
  // rows of level 0 ahead, by march step modulo 3
  VecIn ahead[3];
  load(0, ahead[0]);
  load(1, ahead[1]);
  load(2, ahead[2]);
  // h[v][k]: level v of the row of march step k modulo 3 (level 0 the
  // input); a level's rows lag its step by v
  float h[kL][3][kC];
#pragma unroll
  for (int v = 0; v < kL; ++v) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int c = 0; c < kC; ++c) h[v][k][c] = 0.0f;
    }
  }
  auto step = [&](auto slot, int s) {
    constexpr int kP = decltype(slot)::value;  // s modulo 3
    constexpr int kOld = (kP + 1) % 3;         // two steps back
    constexpr int kMid = (kP + 2) % 3;         // one step back
#pragma unroll
    for (int c = 0; c < kC; ++c) h[0][kP][c] = widen(ahead[kP].e[c]);
    load(s + 3, ahead[kP]);
#pragma unroll
    for (int v = 1; v <= kL; ++v) {
      if (v > t) break;
      // level v of row gy from level v - 1 of rows gy - 1, gy, gy + 1
      const int gy = r_lo + s - v;
      const float(&up)[kC] = h[v - 1][kOld];
      const float(&mid)[kC] = h[v - 1][kMid];
      const float(&down)[kC] = h[v - 1][kP];
      float ml, mr;
      sides(mid, ml, mr);
      float ul = 0.0f, ur = 0.0f, dl = 0.0f, dr = 0.0f;
      if (kBox) {
        sides(up, ul, ur);
        sides(down, dl, dr);
      }
      // a ring cell keeps its value: a select, not a branch, so that the
      // levels' chain has no reconvergence point
      const bool ring_row = kFreeze && (gy == 0 || gy == ny - 1);
      float res[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float left = c > 0 ? mid[c - 1] : ml;
        const float right = c < kC - 1 ? mid[c + 1] : mr;
        if (kBox) {
          res[c] = __fmul_rn(
              box8(up[c], down[c], left, right, c > 0 ? up[c - 1] : ul,
                   c < kC - 1 ? up[c + 1] : ur, c > 0 ? down[c - 1] : dl,
                   c < kC - 1 ? down[c + 1] : dr),
              0.125f);
        } else {
          res[c] = __fmul_rn(__fadd_rn(__fadd_rn(up[c], down[c]),
                                       __fadd_rn(left, right)),
                             0.25f);
        }
        if (kFreeze && (ring_row || (ring >> c & 1u))) res[c] = mid[c];
      }
      if (v == t) {
        if (gy >= yb && gy < ye) store(gy, res);
      } else {
#pragma unroll
        for (int c = 0; c < kC; ++c) h[v < kL ? v : kL - 1][kP][c] = res[c];
      }
    }
  };
  // whole rounds of three steps: a step past the last loads nothing and
  // stores no row
  for (int s = 0; s < steps; s += 3) {
    step(std::integral_constant<int, 0>{}, s);
    step(std::integral_constant<int, 1>{}, s + 1);
    step(std::integral_constant<int, 2>{}, s + 2);
  }
}

// The tile (bx, by) of the block numbered (bx, by) in the grid, so that
// the tiles of the outermost ring of tiles, whose strips hold the
// dirichlet ring and take longer, are dealt out first and not left to
// the last wave: first the top and bottom rows of tiles, then the left and
// right columns, then the rest by rows.
__device__ __forceinline__ void edge_first(int& bx, int& by) {
  const int nx = gridDim.x;
  const int ny = gridDim.y;
  if (nx <= 2 || ny <= 2) return;
  int i = by * nx + bx;
  if (i < 2 * nx) {
    by = i < nx ? 0 : ny - 1;
    bx = i % nx;
    return;
  }
  i -= 2 * nx;
  if (i < 2 * (ny - 2)) {
    by = 1 + i / 2;
    bx = i % 2 == 0 ? 0 : nx - 1;
    return;
  }
  i -= 2 * (ny - 2);
  by = 1 + i / (nx - 2);
  bx = 1 + i % (nx - 2);
}

// A block (one warp) owns a tile of tile_y x tile_x outputs and covers it
// in strips of at most 32 * kC - 2t columns, their windows starting on a
// multiple of kC columns so that the lanes' vectors are aligned.
template <typename Tin, typename Tout, bool kPeriodic, bool kBox>
__global__ void __launch_bounds__(kWarp, kWarps2)
    multi2d_kernel(const Tin* __restrict__ u, Tout* __restrict__ out, int ny,
                   int nx, int tile_y, int tile_x, int t, bool vec_in,
                   bool vec_out) {
  constexpr int kW = kWarp * kCols2;
  int bx = blockIdx.x;
  int by = blockIdx.y;
  if (!kPeriodic) edge_first(bx, by);
  const int yb = by * tile_y;
  const int ye = min(yb + tile_y, ny);
  const int xb = bx * tile_x;
  const int xe = min(xb + tile_x, nx);
  const bool rows_ring = !kPeriodic && (yb - t <= 0 || ye + t >= ny);
  for (int xo = xb; xo < xe;) {
    const int xw = floor_to(xo - t, kCols2);
    const int xs = min(xe, xw + kW - t);
    if (!kPeriodic && (rows_ring || xw <= 0 || xw + kW >= nx)) {
      multi2d_strip<Tin, Tout, kBox, true>(
          u, out, ny, nx, t, yb, ye, xw, xo, xs, vec_in, vec_out);
    } else {
      multi2d_strip<Tin, Tout, kBox, false>(
          u, out, ny, nx, t, yb, ye, xw, xo, xs, vec_in, vec_out);
    }
    xo = xs;
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
// thread keeps, per level, its cells of the newest complete plane in
// registers (the y neighbours inside its rows and the cells' own value),
// and the block keeps, per level, the window's two newest planes in
// shared memory (the x neighbours, the y neighbours across two threads'
// rows, and, read back by the thread that wrote them, the cells' own
// older plane). The planes lie at a fixed row stride (kWinX) with a spare
// row above and below, so that every shared offset is a constant and
// every cell's neighbours are in bounds. At march step k the thread
// receives level 0 of plane k (loaded one step ahead, two at t = 1), and
// for v = 1..kT publishes level v - 1 of plane k - v + 1 and computes
// level v of plane k - v from level v - 1 of plane k - v, which the step
// before published in the other parity: one barrier a step. Every cell of
// the window computes every level: level v is valid on the window shrunk
// by v cells a side and on the planes of the range widened by kT - v, and
// the trapezoid keeps the rest out of it. Every level keeps the global
// shell (the y/x ring and the planes 0 and nz - 1) at its previous
// level's value, as the TPU kernel re-freezes it each level: a frozen
// cell is an information barrier, so no cell outside the field is read.
// Blocks whose window holds no cell of the y/x shell and none outside the
// field (kEdge false) skip the per-cell ring and field tests; the others
// freeze their ring cells and never load a cell outside the field. kT
// levels a launch; the wrapper chains more through an f32 scratch field.
//
// What bounds it: a pass reads and writes the field once (2 * N * itemsize
// bytes) for t steps of 6 operations a cell. On top: the window's cells
// beyond the tile, computed at every level and loaded (from L2 mostly:
// the neighbouring tiles read the same cells); the shared-memory traffic
// of a cell a level (a store, its older plane, its x neighbours); and the
// block's barrier a plane. A block's barrier stalls all its warps, so two
// blocks share an SM (kMaxThreads3 threads of at most 64 registers each):
// while one waits, the other computes. That bounds the window, 32 x 64
// cells (a 24 x 56 tile at t = 4), and the per-thread state, kT * kRows3
// floats. The z ranges are chosen so that the blocks fill whole waves of
// the SMs.
// ---------------------------------------------------------------------------
// the most steps one launch runs (the wrapper's T_MAX for 3D): one kernel
// instantiation each
constexpr int kTMax3 = 4;
// the window rows a thread owns; the most window a block holds, kWinX
// columns by kWinY rows, whose planes lie in shared memory at a fixed row
// stride (every shared offset a constant); the threads that makes, two
// blocks to an SM (64 registers a thread)
constexpr int kRows3 = 4;
constexpr int kWinX = 64;
constexpr int kWinY = 32;
constexpr int kMaxThreads3 = kWinX * kWinY / kRows3;
// a plane of the window with a spare row above and below
constexpr int kPlane3 = kWinX * (kWinY + 2);

// The march of one block; kEdge: its window holds a cell of the y/x ring
// or one outside the field (block-uniform).
template <typename Tin, typename Tout, int kT, bool kEdge>
__device__ __forceinline__ void multi3d_march(const Tin* __restrict__ u,
                                              Tout* __restrict__ out,
                                              float* lev, int nz, int ny,
                                              int nx, int tile_y,
                                              int tile_x) {
  const float sixth = static_cast<float>(1.0 / 6.0);
  const int tx = threadIdx.x;
  const int r0 = threadIdx.y * kRows3;  // this thread's first window row
  const int gx = static_cast<int>(blockIdx.x) * tile_x - kT + tx;
  const int gy0 = static_cast<int>(blockIdx.y) * tile_y - kT + r0;
  // per row (bit i): the cell lies in the field (it is loaded), on the
  // global y/x ring (it keeps its value), in the tile (it is stored)
  unsigned inside = 0;
  unsigned ring = 0;
  unsigned own = 0;
  const bool col_own = tx >= kT && tx < kT + tile_x;
#pragma unroll
  for (int i = 0; i < kRows3; ++i) {
    const int r = r0 + i;
    const int gy = gy0 + i;
    if (gx >= 0 && gx < nx && gy >= 0 && gy < ny) {
      inside |= 1u << i;
      if (gy == 0 || gy == ny - 1 || gx == 0 || gx == nx - 1) {
        ring |= 1u << i;
      }
      if (col_own && r >= kT && r < kT + tile_y) own |= 1u << i;
    }
  }
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int64_t col = static_cast<int64_t>(gy0) * nx + gx;  // row r0's cell
  const int z0 = static_cast<int>(int64_t{nz} * blockIdx.z / gridDim.z);
  const int z1 = static_cast<int>(int64_t{nz} * (blockIdx.z + 1) / gridDim.z);
  const int k0 = max(z0 - kT, 0);      // the first plane of level 0
  const int k1 = min(z1 + kT, nz);     // and one past its last
  auto load = [&](int p, float (&dst)[kRows3]) {
    if (p >= k1) return;
    const Tin* src = u + p * plane + col;
#pragma unroll
    for (int i = 0; i < kRows3; ++i) {
      if (!kEdge || (inside >> i & 1u)) dst[i] = widen(src[i * nx]);
    }
  };
  // level 0 of the planes ahead, by march step modulo kAhead: two at
  // t = 1, where a step is short beside the loads' latency, one above
  constexpr int kAhead = kT == 1 ? 2 : 1;
  float ahead[kAhead][kRows3];
#pragma unroll
  for (int d = 0; d < kAhead; ++d) {
#pragma unroll
    for (int i = 0; i < kRows3; ++i) ahead[d][i] = 0.0f;
    load(k0 + d, ahead[d]);
  }
  // per level below kT: this thread's cells of the level's newest
  // complete plane (plane j when level v + 1 computes plane j)
  float cur[kT][kRows3];
#pragma unroll
  for (int v = 0; v < kT; ++v) {
#pragma unroll
    for (int i = 0; i < kRows3; ++i) cur[v][i] = 0.0f;
  }
  float* const at = lev + (r0 + 1) * kWinX + tx;  // this thread's first cell
  auto step = [&](auto parity, int s) {
    constexpr int kQ = decltype(parity)::value;  // s modulo 2
    const int k = k0 + s;
    float fresh[kRows3];
#pragma unroll
    for (int i = 0; i < kRows3; ++i) fresh[i] = ahead[kQ % kAhead][i];
    load(k + kAhead, ahead[kQ % kAhead]);
#pragma unroll
    for (int v = 1; v <= kT; ++v) {
      const int j = k - v;
      // level v - 1 of plane j + 1 is published now, of plane j was the
      // step before: parities by march step, (s - v + 1) and (s - v).
      // Until now the first buffer held plane j - 1: each thread reads its
      // own cells back (its z neighbours below) before it overwrites them.
      float* newer = at + (2 * (v - 1) + ((kQ - v + 1) & 1)) * kPlane3;
      const float* below = at + (2 * (v - 1) + ((kQ - v) & 1)) * kPlane3;
      float(&mid)[kRows3] = cur[v - 1];
      float older[kRows3];
#pragma unroll
      for (int i = 0; i < kRows3; ++i) {
        older[i] = newer[i * kWinX];
        newer[i * kWinX] = fresh[i];
      }
      const bool face = j == 0 || j == nz - 1;
      float res[kRows3];
#pragma unroll
      for (int i = 0; i < kRows3; ++i) {
        res[i] = mid[i];
        if (!face && !(kEdge && (ring >> i & 1u))) {
          const float ym = i > 0 ? mid[i - 1] : below[-kWinX];
          const float yp =
              i < kRows3 - 1 ? mid[i + 1] : below[kRows3 * kWinX];
          res[i] = __fmul_rn(
              __fadd_rn(__fadd_rn(__fadd_rn(older[i], fresh[i]),
                                  __fadd_rn(ym, yp)),
                        __fadd_rn(below[i * kWinX - 1],
                                  below[i * kWinX + 1])),
              sixth);
        }
      }
      // plane j + 1 is the newest complete plane of level v - 1 next step
#pragma unroll
      for (int i = 0; i < kRows3; ++i) {
        mid[i] = fresh[i];
        fresh[i] = res[i];
      }
    }
    const int j = k - kT;
    if (j >= z0 && j < z1) {
      Tout* dst = out + j * plane + col;
#pragma unroll
      for (int i = 0; i < kRows3; ++i) {
        if (own >> i & 1u) dst[i * nx] = narrow<Tout>(fresh[i]);
      }
    }
    // this step's publications are visible, and its reads done before the
    // next step overwrites their parity
    __syncthreads();
  };
  // whole pairs of steps (the parities' offsets constant in each): a step
  // past the last loads nothing and stores no plane
  for (int s = 0; s < z1 + kT - k0; s += 2) {
    step(std::integral_constant<int, 0>{}, s);
    step(std::integral_constant<int, 1>{}, s + 1);
  }
}

template <typename Tin, typename Tout, int kT>
__global__ void __launch_bounds__(kMaxThreads3, 2)
    jacobi3d_multi_kernel(const Tin* __restrict__ u, Tout* __restrict__ out,
                          int nz, int ny, int nx, int tile_y, int tile_x) {
  // plane j of level v (0 .. kT - 1) of the window at
  // lev + (2 * v + parity(j)) * kPlane3
  extern __shared__ float lev[];
  const int gx = static_cast<int>(blockIdx.x) * tile_x - kT;
  const int gy = static_cast<int>(blockIdx.y) * tile_y - kT;
  const int rows = static_cast<int>(blockDim.y) * kRows3;
  if (gx >= 1 && gx + static_cast<int>(blockDim.x) <= nx - 1 && gy >= 1 &&
      gy + rows <= ny - 1) {
    multi3d_march<Tin, Tout, kT, false>(u, out, lev, nz, ny, nx, tile_y,
                                        tile_x);
  } else {
    multi3d_march<Tin, Tout, kT, true>(u, out, lev, nz, ny, nx, tile_y,
                                       tile_x);
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
  const bool vec_in = aligned_to(u, 16) && tile % (16 / sizeof(Tin)) == 0;
  const bool vec_out =
      aligned_to(out, 16) && tile % (16 / sizeof(Tout)) == 0;
  const int64_t blocks = (n + tile - 1) / tile;
  kernel<<<static_cast<unsigned>(blocks), kThreads1, smem, stream>>>(
      static_cast<const Tin*>(u), static_cast<Tout*>(out), n, tile, t, vec_in,
      vec_out);
  return cudaGetLastError();
}

template <typename Tin, typename Tout, bool kBox, bool kPeriodic>
int launch2d_bc(const void* u, void* out, int ny, int nx, int tile_y,
                int tile_x, int t, cudaStream_t stream) {
  const bool vec_in =
      aligned_to(u, kCols2 * sizeof(Tin)) && nx % kCols2 == 0;
  const bool vec_out =
      aligned_to(out, kCols2 * sizeof(Tout)) && nx % kCols2 == 0;
  const dim3 grid((nx + tile_x - 1) / tile_x, (ny + tile_y - 1) / tile_y);
  multi2d_kernel<Tin, Tout, kPeriodic, kBox><<<grid, kWarp, 0, stream>>>(
      static_cast<const Tin*>(u), static_cast<Tout*>(out), ny, nx, tile_y,
      tile_x, t, vec_in, vec_out);
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
  if (ny < 3 || nx < 3 || t < 1 || t > kTMax2 || tile_y < 1 || tile_x < 1) {
    return cudaErrorInvalidValue;
  }
  // a tile larger than the field covers the same cells
  tile_y = tile_y < ny ? tile_y : ny;
  tile_x = tile_x < nx ? tile_x : nx;
  if ((ny + tile_y - 1) / tile_y > kMaxGridY) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return with_dtypes(in_dtype, out_dtype, [&](auto ti, auto to) {
    using Tin = typename decltype(ti)::type;
    using Tout = typename decltype(to)::type;
    return periodic ? launch2d_bc<Tin, Tout, kBox, true>(
                          u, out, ny, nx, tile_y, tile_x, t, s)
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
  // the window's columns, and its rows in whole thread rows
  const dim3 block(tile_x + 2 * kT, (tile_y + 2 * kT + kRows3 - 1) / kRows3);
  const size_t smem = static_cast<size_t>(2 * kT) * kPlane3 * sizeof(float);
  const int tiles_x = (nx + tile_x - 1) / tile_x;
  const int tiles_y = (ny + tile_y - 1) / tile_y;
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
  // z ranges: each adds 2 kT planes of apron, and the blocks run in waves
  // of `resident`; take the count whose waves times planes a block is
  // least (the first such, the fewest ranges)
  const int64_t tiles = static_cast<int64_t>(tiles_x) * tiles_y;
  const int64_t resident =
      static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t most = nz < kMaxGridY ? nz : kMaxGridY;
  int64_t ranges = 1;
  int64_t best = -1;
  for (int64_t r = 1; r <= most && r <= 4 * resident; ++r) {
    const int64_t waves = (tiles * r + resident - 1) / resident;
    const int64_t cost = waves * ((nz + r - 1) / r + 2 * kT);
    if (best < 0 || cost < best) {
      best = cost;
      ranges = r;
    }
  }
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
      tile_y < 1 || tile_x < 1) {
    return cudaErrorInvalidValue;
  }
  // a tile larger than the field covers the same cells
  tile_y = tile_y < ny ? tile_y : ny;
  tile_x = tile_x < nx ? tile_x : nx;
  if (tile_x + 2 * t > kWinX || tile_y + 2 * t > kWinY ||
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
