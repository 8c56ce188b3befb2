// Hand-written Hopper (sm_90a) kernels for one Jacobi step of the box
// stencils: the 2D 9-point stencil (mean of the 8 box neighbours) and the
// 3D 27-point stencil (mean of the 26). The port of the whole-field and
// stream TPU kernels of tpu_comm/kernels/stencil9.py (_stencil9_kernel,
// _stencil9_stream_kernel) and tpu_comm/kernels/stencil27.py
// (_stencil27_kernel, _stencil27_stream_kernel). The `block` kernels are
// the single-device `block` arm and the distributed step's `block` local
// update; the `stream` kernels the `stream` arm (what `auto` runs on one
// device) and the distributed `stream` update.
//
// Built by tpu_comm_torch/kernels/_build.py with
//   nvcc -O3 -gencode=arch=compute_90a,code=sm_90a -fmad=false -shared
// into a shared library with a plain C interface, loaded with ctypes. No
// PyTorch header is included: the Python wrappers pass raw device
// pointers and the current CUDA stream, and raise on a non-zero return.
//
// Numerical contract (shared with the plain PyTorch versions in
// kernels/stencil9.py and kernels/stencil27.py and the NumPy golden): every
// element is widened to f32 and the sums are taken in the golden's
// association, then narrowed once with round-to-nearest-even:
//   box8 = ((up + down) + (left + right)) + ((ul + dr) + (ur + dl))
//   9-point   box8 * 0.125f
//   27-point  ((full9(z-1) + full9(z+1)) + box8(z)) * (float)(1.0 / 26.0)
//             where full9(p) = box8(p) + p
// 1/26 is not a power of two: the result is a product with the f32
// constant, never a division by 26.0f, which rounds differently. The
// explicit __fadd_rn/__fmul_rn intrinsics are never contracted into an
// FMA, and -fmad=false guards the rest, so f32 results are bitwise equal to
// the golden. Periodic neighbours wrap modulo the extent in the kernel
// (the TPU stream arm recomputes the 2D edge rows outside, in the field's
// dtype); dirichlet boundary cells keep their input value.
//
// What bounds all four on this card: memory. A step must read the field
// once and write it once, 2 * N * itemsize bytes, against 9 (2D) or 27
// (3D) operations per point, at most 3.4 operations per byte. The TPU
// kernels hold the whole field or whole planes in VMEM and build the
// diagonals from in-register rolls; nothing of that size fits the 227 KB
// of shared memory. So the block kernels stage nothing (a thread owns a
// 16-byte vector of a row and loads the rows above and below straight from
// global memory, leaving the reuse to L1 and L2, as jacobi_block.cu does),
// and the stream kernels stage one tile per row slab or plane in shared
// memory (as jacobi_stream.cu does). The 27-point kernels compute each
// plane's box8 and full9 once and keep a three-plane window of them in
// registers, where the TPU kernels recompute box8 of all three planes for
// every output plane.

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

// Index i in [-1, 2n) wrapped into [0, n). Cells past a ragged tile edge
// (i >= 2n when n is smaller than the tile) feed no output and are
// clamped only to stay inside the allocation.
__device__ __forceinline__ int wrap(int i, int n) {
  if (i < 0) {
    i += n;
  } else if (i >= n) {
    i -= n;
  }
  return i < n ? i : n - 1;
}

// The 8-neighbour sum of the golden, from the three rows around a cell:
// up/down/left/right, then the diagonals ul/dr and ur/dl.
__device__ __forceinline__ float box8(float up, float down, float left,
                                      float right, float ul, float ur,
                                      float dl, float dr) {
  return __fadd_rn(__fadd_rn(__fadd_rn(up, down), __fadd_rn(left, right)),
                   __fadd_rn(__fadd_rn(ul, dr), __fadd_rn(ur, dl)));
}

// kV elements moved as one access: 16 bytes when kV = 16 / sizeof(T)
template <typename T, int kV>
struct alignas(sizeof(T) * kV) Vec {
  T e[kV];
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A row's window for a thread's kV outputs starting at column x0: w[1..kV]
// its own vector, w[0] and w[kV + 1] the cells left and right of it
// (wrapped). Returns the raw vector (the dirichlet freeze keeps it).
template <typename T, int kV>
__device__ __forceinline__ Vec<T, kV> load_window(const T* row, int x0,
                                                  int nx, float (&w)[kV + 2]) {
  const Vec<T, kV> c = *reinterpret_cast<const Vec<T, kV>*>(row + x0);
  w[0] = widen(row[x0 == 0 ? nx - 1 : x0 - 1]);
  w[kV + 1] = widen(row[x0 + kV == nx ? 0 : x0 + kV]);
#pragma unroll
  for (int k = 0; k < kV; ++k) w[k + 1] = widen(c.e[k]);
  return c;
}

// box8 of output k from the windows of the rows above (a), own (w) and
// below (b)
template <int kV>
__device__ __forceinline__ float box8_of(const float (&a)[kV + 2],
                                         const float (&w)[kV + 2],
                                         const float (&b)[kV + 2], int k) {
  return box8(a[k + 1], b[k + 1], w[k], w[k + 2], a[k], a[k + 2], b[k],
              b[k + 2]);
}

// ---------------------------------------------------------------------------
// 9-point, whole field: replaces tpu_comm/kernels/stencil9.py
// _stencil9_kernel (and the ring restore _freeze_ring that step_pallas runs
// outside it).
//
// jacobi2d_block_kernel's form: a thread owns kV consecutive outputs of one
// row and loads its own vector and the vectors of the same columns in the
// rows above and below (wrapped), plus one scalar past each end of each of
// the three rows. A block is 32 vectors wide and 8 rows tall, so the rows a
// thread reads as "above" and "below" are other threads' own rows: L1
// serves them. kV is 16 bytes' worth when the pointers are 16-byte aligned
// and nx is a multiple of it, else 1, which takes any nx.
// ---------------------------------------------------------------------------
constexpr int kBX2 = 32;
constexpr int kBY2 = 8;

template <typename T, bool kPeriodic, int kV>
__global__ void __launch_bounds__(kBX2* kBY2)
    stencil9_block_kernel(const T* __restrict__ u, T* __restrict__ out,
                          int ny, int nx) {
  const int x0 = (blockIdx.x * kBX2 + threadIdx.x) * kV;
  if (x0 >= nx) return;
  for (int y = blockIdx.y * kBY2 + threadIdx.y; y < ny;
       y += gridDim.y * kBY2) {
    const T* row = u + static_cast<int64_t>(y) * nx;
    const T* up = u + static_cast<int64_t>(y == 0 ? ny - 1 : y - 1) * nx;
    const T* down = u + static_cast<int64_t>(y == ny - 1 ? 0 : y + 1) * nx;
    float a[kV + 2];
    float w[kV + 2];
    float b[kV + 2];
    load_window<T, kV>(up, x0, nx, a);
    const Vec<T, kV> c = load_window<T, kV>(row, x0, nx, w);
    load_window<T, kV>(down, x0, nx, b);
    const bool edge_row = !kPeriodic && (y == 0 || y == ny - 1);
    Vec<T, kV> r;
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      const int x = x0 + k;
      if (edge_row || (!kPeriodic && (x == 0 || x == nx - 1))) {
        r.e[k] = c.e[k];
      } else {
        r.e[k] = narrow<T>(__fmul_rn(box8_of<kV>(a, w, b, k), 0.125f));
      }
    }
    *reinterpret_cast<Vec<T, kV>*>(out + static_cast<int64_t>(y) * nx + x0) =
        r;
  }
}

// ---------------------------------------------------------------------------
// 9-point, stream: replaces tpu_comm/kernels/stencil9.py
// _stencil9_stream_kernel (and the top/bottom row recompute _edge_row and
// the ring freeze that step_pallas_stream runs outside it).
//
// jacobi2d_kernel's form: a block of 32 x 8 threads owns a strip 32 columns
// wide and `rows` rows tall (the chunk). It walks down its strip kSlab2 rows
// at a time, staging each slab plus a one-cell halo (rows and columns
// wrapped modulo the extents) in shared memory, so all eight neighbours,
// the diagonals included, come from shared memory: the TPU kernel's seam
// patch of up/down has no counterpart, since the staged halo rows are the
// true neighbour rows. The global edge rows are computed here like every
// other row.
// ---------------------------------------------------------------------------
constexpr int kTX2 = 32;
constexpr int kTY2 = 8;
constexpr int kSlab2 = 64;

template <typename T, bool kPeriodic>
__global__ void __launch_bounds__(kTX2* kTY2)
    stencil9_stream_kernel(const T* __restrict__ u, T* __restrict__ out,
                           int ny, int nx, int rows) {
  __shared__ float tile[kSlab2 + 2][kTX2 + 2];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTX2 + tx;
  const int x0 = blockIdx.x * kTX2;
  const int y_begin = blockIdx.y * rows;
  const int y_end = min(y_begin + rows, ny);
  const int x = x0 + tx;
  for (int y0 = y_begin; y0 < y_end; y0 += kSlab2) {
    for (int k = tid; k < (kSlab2 + 2) * (kTX2 + 2); k += kTX2 * kTY2) {
      const int r = k / (kTX2 + 2);
      const int c = k % (kTX2 + 2);
      const int gy = wrap(y0 - 1 + r, ny);
      const int gx = wrap(x0 - 1 + c, nx);
      tile[r][c] = widen(u[static_cast<int64_t>(gy) * nx + gx]);
    }
    __syncthreads();
    for (int r = ty; r < kSlab2 && x < nx; r += kTY2) {
      const int y = y0 + r;
      if (y >= y_end) break;
      float v;
      if (!kPeriodic && (y == 0 || y == ny - 1 || x == 0 || x == nx - 1)) {
        v = tile[r + 1][tx + 1];
      } else {
        v = __fmul_rn(box8(tile[r][tx + 1], tile[r + 2][tx + 1],
                           tile[r + 1][tx], tile[r + 1][tx + 2], tile[r][tx],
                           tile[r][tx + 2], tile[r + 2][tx],
                           tile[r + 2][tx + 2]),
                      0.125f);
      }
      out[static_cast<int64_t>(y) * nx + x] = narrow<T>(v);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// 27-point, whole field: replaces tpu_comm/kernels/stencil27.py
// _stencil27_kernel (and the shell restore freeze_shell that step_pallas
// runs outside it).
//
// The TPU kernel is a grid over z-planes that is handed planes k-1, k and
// k+1 and builds box8 of all three for every output plane. Here a thread
// owns kV consecutive outputs of one row, as in the 9-point block kernel,
// and marches over a range of z-planes. Each plane it reaches is read once
// (its own row's vector and the rows above and below, plus a scalar past
// each end of the three) and turned into box8 and full9 = box8 + centre
// once; a window of full9(z-1), box8(z), full9(z) and box8/full9(z+1) stays
// in registers, and
//   out[z] = ((full9[z-1] + full9[z+1]) + box8[z]) * inv26
// is _accum27's association exactly. Blocks do not depend on each other:
// each re-reads the planes just before and after its range, and the
// launcher splits z only as far as the card needs blocks to stay busy.
// ---------------------------------------------------------------------------
constexpr int kBX3 = 32;
constexpr int kBY3 = 8;
// blocks the launcher aims for before it stops splitting z: 132 SMs, each
// holding 8 blocks of 256 threads
constexpr int kTargetBlocks3 = 132 * 8;

// box8 and full9 of a thread's kV cells in plane p; returns the raw centre
// vector
template <typename T, int kV>
__device__ __forceinline__ Vec<T, kV> plane_sums(
    const T* p, int64_t up, int64_t own, int64_t down, int x0, int nx,
    float (&b8)[kV], float (&f9)[kV]) {
  float a[kV + 2];
  float w[kV + 2];
  float b[kV + 2];
  load_window<T, kV>(p + up, x0, nx, a);
  const Vec<T, kV> c = load_window<T, kV>(p + own, x0, nx, w);
  load_window<T, kV>(p + down, x0, nx, b);
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    b8[k] = box8_of<kV>(a, w, b, k);
    f9[k] = __fadd_rn(b8[k], w[k + 1]);
  }
  return c;
}

template <typename T, bool kPeriodic, int kV>
__global__ void __launch_bounds__(kBX3* kBY3)
    stencil27_block_kernel(const T* __restrict__ u, T* __restrict__ out,
                           int nz, int ny, int nx, int planes) {
  using V = Vec<T, kV>;
  const float inv26 = static_cast<float>(1.0 / 26.0);
  const int x0 = (blockIdx.x * kBX3 + threadIdx.x) * kV;
  const int y = blockIdx.y * kBY3 + threadIdx.y;
  if (x0 >= nx || y >= ny) return;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int z_begin = blockIdx.z * planes;
  const int z_end = min(z_begin + planes, nz);
  // row starts inside a plane: this thread's row and the rows above and
  // below (wrapped)
  const int64_t own = static_cast<int64_t>(y) * nx;
  const int64_t up = static_cast<int64_t>(y == 0 ? ny - 1 : y - 1) * nx;
  const int64_t down = static_cast<int64_t>(y == ny - 1 ? 0 : y + 1) * nx;
  const bool edge_row = !kPeriodic && (y == 0 || y == ny - 1);

  float f9m[kV];
  float b8c[kV];
  float f9c[kV];
  float unused[kV];
  plane_sums<T, kV>(u + wrap(z_begin - 1, nz) * plane, up, own, down, x0, nx,
                    unused, f9m);
  V c = plane_sums<T, kV>(u + z_begin * plane, up, own, down, x0, nx, b8c,
                          f9c);
  for (int z = z_begin; z < z_end; ++z) {
    float b8p[kV];
    float f9p[kV];
    const V cp = plane_sums<T, kV>(u + wrap(z + 1, nz) * plane, up, own,
                                   down, x0, nx, b8p, f9p);
    const bool edge_plane =
        edge_row || (!kPeriodic && (z == 0 || z == nz - 1));
    V r;
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      const int x = x0 + k;
      if (edge_plane || (!kPeriodic && (x == 0 || x == nx - 1))) {
        r.e[k] = c.e[k];
      } else {
        r.e[k] = narrow<T>(
            __fmul_rn(__fadd_rn(__fadd_rn(f9m[k], f9p[k]), b8c[k]), inv26));
      }
    }
    *reinterpret_cast<V*>(out + z * plane + own + x0) = r;
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      f9m[k] = f9c[k];
      b8c[k] = b8p[k];
      f9c[k] = f9p[k];
    }
    c = cp;
  }
}

// ---------------------------------------------------------------------------
// 27-point, stream: replaces tpu_comm/kernels/stencil27.py
// _stencil27_stream_kernel (and the shell freeze step_pallas_stream runs
// outside it).
//
// The TPU kernel's structure: a block owns a chunk of `planes` consecutive
// z-planes (its zb) of a (y, x) tile and re-reads one flanking plane on
// each side, wrapped modulo nz. A block of 32 x 4 threads owns a tile of 32
// columns and kTH3 rows; each thread owns kRows3 cells of the tile's column
// (rows ty, ty + 4, ...). Each plane is staged once in shared memory with a
// one-cell ring (wrapped modulo ny and nx), so the eight in-plane
// neighbours come from shared memory, and turned into box8 and full9 once;
// the same three-plane register window as the block kernel gives the
// output. A plane crosses DRAM (planes + 2) / planes times per step.
// ---------------------------------------------------------------------------
constexpr int kTX3 = 32;
constexpr int kTY3 = 4;
constexpr int kRows3 = 4;
constexpr int kTH3 = kTY3 * kRows3;
constexpr int kRing3 = 2 * (kTX3 + 2) + 2 * kTH3;

// Stage plane p (a block's tile of it plus a one-cell ring, wrapped) in
// shared memory, then take box8, full9 and the centre of this thread's
// cells (at col[i] in the plane) from it. Every thread of the block calls
// it: it holds two barriers.
template <typename T>
__device__ __forceinline__ void stage_sums(
    const T* __restrict__ p, float (&tile)[kTH3 + 2][kTX3 + 2],
    const int64_t (&col)[kRows3], int x0, int y0, int ny, int nx,
    float (&b8)[kRows3], float (&f9)[kRows3], float (&ctr)[kRows3]) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
#pragma unroll
  for (int i = 0; i < kRows3; ++i) {
    tile[ty + i * kTY3 + 1][tx + 1] = widen(p[col[i]]);
  }
  for (int k = ty * kTX3 + tx; k < kRing3; k += kTX3 * kTY3) {
    int r;
    int c;
    if (k < kTX3 + 2) {
      r = 0;
      c = k;
    } else if (k < 2 * (kTX3 + 2)) {
      r = kTH3 + 1;
      c = k - (kTX3 + 2);
    } else {
      const int j = k - 2 * (kTX3 + 2);
      r = 1 + (j >> 1);
      c = (j & 1) ? kTX3 + 1 : 0;
    }
    const int gy = wrap(y0 - 1 + r, ny);
    const int gx = wrap(x0 - 1 + c, nx);
    tile[r][c] = widen(p[static_cast<int64_t>(gy) * nx + gx]);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRows3; ++i) {
    const int r = ty + i * kTY3;
    b8[i] = box8(tile[r][tx + 1], tile[r + 2][tx + 1], tile[r + 1][tx],
                 tile[r + 1][tx + 2], tile[r][tx], tile[r][tx + 2],
                 tile[r + 2][tx], tile[r + 2][tx + 2]);
    ctr[i] = tile[r + 1][tx + 1];
    f9[i] = __fadd_rn(b8[i], ctr[i]);
  }
  __syncthreads();
}

template <typename T, bool kPeriodic>
__global__ void __launch_bounds__(kTX3* kTY3)
    stencil27_stream_kernel(const T* __restrict__ u, T* __restrict__ out,
                            int nz, int ny, int nx, int planes) {
  __shared__ float tile[kTH3 + 2][kTX3 + 2];
  const float inv26 = static_cast<float>(1.0 / 26.0);
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int x0 = blockIdx.x * kTX3;
  const int y0 = blockIdx.y * kTH3;
  const int x = x0 + tx;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int z_begin = blockIdx.z * planes;
  const int z_end = min(z_begin + planes, nz);

  // threads past the edge hold the wrapped cell: it is a real neighbour
  // of the last active column or row in the periodic case
  int64_t col[kRows3];
#pragma unroll
  for (int i = 0; i < kRows3; ++i) {
    col[i] = static_cast<int64_t>(wrap(y0 + ty + i * kTY3, ny)) * nx +
             wrap(x, nx);
  }

  float f9m[kRows3];
  float b8c[kRows3];
  float f9c[kRows3];
  float cc[kRows3];
  float unused[kRows3];
  float unused_ctr[kRows3];
  stage_sums<T>(u + wrap(z_begin - 1, nz) * plane, tile, col, x0, y0, ny, nx,
                unused, f9m, unused_ctr);
  stage_sums<T>(u + z_begin * plane, tile, col, x0, y0, ny, nx, b8c, f9c,
                cc);
  for (int z = z_begin; z < z_end; ++z) {
    float b8p[kRows3];
    float f9p[kRows3];
    float cp[kRows3];
    stage_sums<T>(u + wrap(z + 1, nz) * plane, tile, col, x0, y0, ny, nx,
                  b8p, f9p, cp);
#pragma unroll
    for (int i = 0; i < kRows3; ++i) {
      const int y = y0 + ty + i * kTY3;
      if (x < nx && y < ny) {
        float v;
        if (!kPeriodic && (z == 0 || z == nz - 1 || y == 0 || y == ny - 1 ||
                           x == 0 || x == nx - 1)) {
          v = cc[i];
        } else {
          v = __fmul_rn(__fadd_rn(__fadd_rn(f9m[i], f9p[i]), b8c[i]), inv26);
        }
        out[z * plane + static_cast<int64_t>(y) * nx + x] = narrow<T>(v);
      }
      f9m[i] = f9c[i];
      b8c[i] = b8p[i];
      f9c[i] = f9p[i];
      cc[i] = cp[i];
    }
  }
}

// grid.y and grid.z are limited to 65535 blocks
constexpr int kMaxGridYZ = 65535;

template <typename T>
int launch9_block(const void* u, void* out, int ny, int nx, bool periodic,
                  cudaStream_t stream) {
  constexpr int kW = 16 / sizeof(T);
  const bool vec = aligned16(u) && aligned16(out) && nx % kW == 0;
  const int vectors = vec ? nx / kW : nx;
  const int rows = (ny + kBY2 - 1) / kBY2;
  const dim3 block(kBX2, kBY2);
  const dim3 grid((vectors + kBX2 - 1) / kBX2,
                  rows < kMaxGridYZ ? rows : kMaxGridYZ);
  auto* src = static_cast<const T*>(u);
  auto* dst = static_cast<T*>(out);
  if (vec) {
    if (periodic) {
      stencil9_block_kernel<T, true, kW><<<grid, block, 0, stream>>>(
          src, dst, ny, nx);
    } else {
      stencil9_block_kernel<T, false, kW><<<grid, block, 0, stream>>>(
          src, dst, ny, nx);
    }
  } else if (periodic) {
    stencil9_block_kernel<T, true, 1><<<grid, block, 0, stream>>>(src, dst,
                                                                  ny, nx);
  } else {
    stencil9_block_kernel<T, false, 1><<<grid, block, 0, stream>>>(src, dst,
                                                                   ny, nx);
  }
  return cudaGetLastError();
}

template <typename T>
int launch9_stream(const void* u, void* out, int ny, int nx, bool periodic,
                   int rows, cudaStream_t stream) {
  const dim3 block(kTX2, kTY2);
  const dim3 grid((nx + kTX2 - 1) / kTX2, (ny + rows - 1) / rows);
  auto* src = static_cast<const T*>(u);
  auto* dst = static_cast<T*>(out);
  if (periodic) {
    stencil9_stream_kernel<T, true><<<grid, block, 0, stream>>>(src, dst, ny,
                                                                nx, rows);
  } else {
    stencil9_stream_kernel<T, false><<<grid, block, 0, stream>>>(src, dst, ny,
                                                                 nx, rows);
  }
  return cudaGetLastError();
}

template <typename T>
int launch27_block(const void* u, void* out, int nz, int ny, int nx,
                   bool periodic, cudaStream_t stream) {
  constexpr int kW = 16 / sizeof(T);
  const bool vec = aligned16(u) && aligned16(out) && nx % kW == 0;
  const int vectors = vec ? nx / kW : nx;
  const int gx = (vectors + kBX3 - 1) / kBX3;
  const int gy = (ny + kBY3 - 1) / kBY3;
  if (gy > kMaxGridYZ) return cudaErrorInvalidValue;
  const int64_t tiles = static_cast<int64_t>(gx) * gy;
  int64_t parts = (kTargetBlocks3 + tiles - 1) / tiles;
  if (parts > nz) parts = nz;
  if (parts > kMaxGridYZ) parts = kMaxGridYZ;
  const int planes = static_cast<int>((nz + parts - 1) / parts);
  const dim3 block(kBX3, kBY3);
  const dim3 grid(gx, gy, (nz + planes - 1) / planes);
  auto* src = static_cast<const T*>(u);
  auto* dst = static_cast<T*>(out);
  if (vec) {
    if (periodic) {
      stencil27_block_kernel<T, true, kW><<<grid, block, 0, stream>>>(
          src, dst, nz, ny, nx, planes);
    } else {
      stencil27_block_kernel<T, false, kW><<<grid, block, 0, stream>>>(
          src, dst, nz, ny, nx, planes);
    }
  } else if (periodic) {
    stencil27_block_kernel<T, true, 1><<<grid, block, 0, stream>>>(
        src, dst, nz, ny, nx, planes);
  } else {
    stencil27_block_kernel<T, false, 1><<<grid, block, 0, stream>>>(
        src, dst, nz, ny, nx, planes);
  }
  return cudaGetLastError();
}

template <typename T>
int launch27_stream(const void* u, void* out, int nz, int ny, int nx,
                    bool periodic, int planes, cudaStream_t stream) {
  const dim3 block(kTX3, kTY3);
  const dim3 grid((nx + kTX3 - 1) / kTX3, (ny + kTH3 - 1) / kTH3,
                  (nz + planes - 1) / planes);
  auto* src = static_cast<const T*>(u);
  auto* dst = static_cast<T*>(out);
  if (periodic) {
    stencil27_stream_kernel<T, true><<<grid, block, 0, stream>>>(
        src, dst, nz, ny, nx, planes);
  } else {
    stencil27_stream_kernel<T, false><<<grid, block, 0, stream>>>(
        src, dst, nz, ny, nx, planes);
  }
  return cudaGetLastError();
}

}  // namespace

// C interface. Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched), so a refused launch is reported to
// the wrapper instead of vanishing; cudaErrorInvalidValue for arguments
// the kernels do not take.
extern "C" {

int tc_stencil9_block(const void* u, void* out, int ny, int nx, int dtype,
                      int periodic, void* stream) {
  if (ny < 3 || nx < 3) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch9_block<float>(u, out, ny, nx, periodic, s);
    case kBFloat16:
      return launch9_block<__nv_bfloat16>(u, out, ny, nx, periodic, s);
    case kFloat16:
      return launch9_block<__half>(u, out, ny, nx, periodic, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int tc_stencil9_stream(const void* u, void* out, int ny, int nx, int dtype,
                       int periodic, int rows, void* stream) {
  if (ny < 3 || nx < 3 || rows < 1 || (ny + rows - 1) / rows > kMaxGridYZ) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch9_stream<float>(u, out, ny, nx, periodic, rows, s);
    case kBFloat16:
      return launch9_stream<__nv_bfloat16>(u, out, ny, nx, periodic, rows, s);
    case kFloat16:
      return launch9_stream<__half>(u, out, ny, nx, periodic, rows, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int tc_stencil27_block(const void* u, void* out, int nz, int ny, int nx,
                       int dtype, int periodic, void* stream) {
  if (nz < 2 || ny < 3 || nx < 3) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch27_block<float>(u, out, nz, ny, nx, periodic, s);
    case kBFloat16:
      return launch27_block<__nv_bfloat16>(u, out, nz, ny, nx, periodic, s);
    case kFloat16:
      return launch27_block<__half>(u, out, nz, ny, nx, periodic, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int tc_stencil27_stream(const void* u, void* out, int nz, int ny, int nx,
                        int dtype, int periodic, int planes, void* stream) {
  if (nz < 2 || ny < 3 || nx < 3 || planes < 1 ||
      (ny + kTH3 - 1) / kTH3 > kMaxGridYZ ||
      (nz + planes - 1) / planes > kMaxGridYZ) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch27_stream<float>(u, out, nz, ny, nx, periodic, planes, s);
    case kBFloat16:
      return launch27_stream<__nv_bfloat16>(u, out, nz, ny, nx, periodic,
                                            planes, s);
    case kFloat16:
      return launch27_stream<__half>(u, out, nz, ny, nx, periodic, planes,
                                     s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
