// Hand-written Hopper (sm_90a) kernels for one Jacobi step of the star
// stencils in 1D, 2D and 3D on a whole field: the port of the three
// whole-field TPU kernels of tpu_comm/kernels/jacobi{1,2,3}d.py
// (_jacobi1d_kernel, _jacobi2d_kernel, _jacobi3d_kernel, run by each
// module's step_pallas). They are the `block` arm: the local update of the
// distributed step, and a single-device arm beside `stream`.
//
// Built by tpu_comm_torch/kernels/_build.py with
//   nvcc -O3 -gencode=arch=compute_90a,code=sm_90a -fmad=false -shared
// into a shared library with a plain C interface, loaded with ctypes. No
// PyTorch header is included: the Python wrappers pass raw device
// pointers and the current CUDA stream, and raise on a non-zero return.
//
// Numerical contract (shared with the plain PyTorch versions, the stream
// kernels of jacobi_stream.cu and the NumPy golden): every element is
// widened to f32, neighbour pairs are summed axis by axis, then across
// axes, then multiplied by an f32 constant, and the result is narrowed
// once with round-to-nearest-even:
//   1D  (prev + next) * 0.5f
//   2D  ((up + down) + (left + right)) * 0.25f
//   3D  (((zm + zp) + (ym + yp)) + (xm + xp)) * (float)(1.0 / 6.0)
// The explicit __fadd_rn/__fmul_rn intrinsics are never contracted into
// an FMA, and -fmad=false guards the rest, so f32 results are bitwise
// equal to the golden. Periodic neighbours wrap modulo the extent;
// dirichlet boundary cells keep their input value (the TPU arms restore
// them outside the kernel; here it is the same single pass).
//
// What bounds all three on this card: memory, 2 * N * itemsize bytes per
// step against at most 0.75 operations per byte. The TPU kernels hold the
// whole field (1D, 2D) or three planes (3D) in VMEM, which has no
// counterpart above 227 KB of shared memory. So the 1D and 2D kernels
// stage nothing: each thread owns one 16-byte vector of outputs, loads
// the vectors it needs straight from global memory with wrapped indices
// (its own and, in 2D, the rows above and below, plus one scalar past
// each end for the x neighbours), and leaves the reuse between
// neighbouring threads and rows to L1 and L2. The 3D kernel does the same
// in each plane and marches along z with its previous, current and next
// vectors in registers.

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

// Plane index i in [-1, n] wrapped into [0, n).
__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// kV elements moved as one access: 16 bytes when kV = 16 / sizeof(T)
template <typename T, int kV>
struct alignas(sizeof(T) * kV) Vec {
  T e[kV];
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// 1D: replaces tpu_comm/kernels/jacobi1d.py _jacobi1d_kernel (and the two
// endpoint writes step_pallas makes outside it).
//
// A thread owns kV consecutive outputs: one vector load of its own
// elements and one scalar load past each end (wrapped). kV is 16 bytes'
// worth when both pointers are 16-byte aligned, else 1; the last thread
// of a ragged field walks its tail one element at a time.
// ---------------------------------------------------------------------------
template <typename T, bool kPeriodic>
__device__ __forceinline__ T point1d(const T* __restrict__ u, int64_t i,
                                     int64_t n) {
  if (!kPeriodic && (i == 0 || i == n - 1)) return u[i];
  const int64_t ip = (i == 0) ? n - 1 : i - 1;
  const int64_t in = (i == n - 1) ? 0 : i + 1;
  return narrow<T>(__fmul_rn(__fadd_rn(widen(u[ip]), widen(u[in])), 0.5f));
}

template <typename T, bool kPeriodic, int kV>
__global__ void __launch_bounds__(256)
    jacobi1d_block_kernel(const T* __restrict__ u, T* __restrict__ out,
                          int64_t n) {
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kV;
  if (i0 >= n) return;
  if (i0 + kV > n) {
    for (int64_t i = i0; i < n; ++i) out[i] = point1d<T, kPeriodic>(u, i, n);
    return;
  }
  const Vec<T, kV> c = *reinterpret_cast<const Vec<T, kV>*>(u + i0);
  float w[kV + 2];
  w[0] = widen(u[i0 == 0 ? n - 1 : i0 - 1]);
  w[kV + 1] = widen(u[i0 + kV == n ? 0 : i0 + kV]);
#pragma unroll
  for (int k = 0; k < kV; ++k) w[k + 1] = widen(c.e[k]);
  Vec<T, kV> r;
#pragma unroll
  for (int k = 0; k < kV; ++k) {
    r.e[k] = narrow<T>(__fmul_rn(__fadd_rn(w[k], w[k + 2]), 0.5f));
  }
  if (!kPeriodic) {
    if (i0 == 0) r.e[0] = c.e[0];
    if (i0 + kV == n) r.e[kV - 1] = c.e[kV - 1];
  }
  *reinterpret_cast<Vec<T, kV>*>(out + i0) = r;
}

// ---------------------------------------------------------------------------
// 2D: replaces tpu_comm/kernels/jacobi2d.py _jacobi2d_kernel (and the ring
// restore _freeze_ring that step_pallas runs outside it).
//
// A thread owns kV consecutive outputs of one row: vector loads of its own
// elements and of the same columns in the rows above and below (wrapped),
// one scalar load past each end of its own row (wrapped). A block is 32
// vectors wide and 8 rows tall, so the row a block reads as "below" is the
// row its next thread row reads as "own": L1 serves it. kV is 16 bytes'
// worth when the pointers are 16-byte aligned and nx is a multiple of it
// (every row then starts aligned), else 1, which takes any nx.
// ---------------------------------------------------------------------------
constexpr int kBX2 = 32;
constexpr int kBY2 = 8;

template <typename T, bool kPeriodic, int kV>
__global__ void __launch_bounds__(kBX2* kBY2)
    jacobi2d_block_kernel(const T* __restrict__ u, T* __restrict__ out,
                          int ny, int nx) {
  const int x0 = (blockIdx.x * kBX2 + threadIdx.x) * kV;
  if (x0 >= nx) return;
  for (int y = blockIdx.y * kBY2 + threadIdx.y; y < ny;
       y += gridDim.y * kBY2) {
    const T* row = u + static_cast<int64_t>(y) * nx;
    const T* up = u + static_cast<int64_t>(y == 0 ? ny - 1 : y - 1) * nx;
    const T* down = u + static_cast<int64_t>(y == ny - 1 ? 0 : y + 1) * nx;
    const Vec<T, kV> c = *reinterpret_cast<const Vec<T, kV>*>(row + x0);
    const Vec<T, kV> a = *reinterpret_cast<const Vec<T, kV>*>(up + x0);
    const Vec<T, kV> b = *reinterpret_cast<const Vec<T, kV>*>(down + x0);
    float w[kV + 2];
    w[0] = widen(row[x0 == 0 ? nx - 1 : x0 - 1]);
    w[kV + 1] = widen(row[x0 + kV == nx ? 0 : x0 + kV]);
#pragma unroll
    for (int k = 0; k < kV; ++k) w[k + 1] = widen(c.e[k]);
    const bool edge_row = !kPeriodic && (y == 0 || y == ny - 1);
    Vec<T, kV> r;
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      const int x = x0 + k;
      if (edge_row || (!kPeriodic && (x == 0 || x == nx - 1))) {
        r.e[k] = c.e[k];
      } else {
        r.e[k] = narrow<T>(__fmul_rn(
            __fadd_rn(__fadd_rn(widen(a.e[k]), widen(b.e[k])),
                      __fadd_rn(w[k], w[k + 2])),
            0.25f));
      }
    }
    *reinterpret_cast<Vec<T, kV>*>(out + static_cast<int64_t>(y) * nx + x0) =
        r;
  }
}

// ---------------------------------------------------------------------------
// 3D: replaces tpu_comm/kernels/jacobi3d.py _jacobi3d_kernel (and the shell
// restore freeze_shell that step_pallas runs outside it).
//
// The TPU kernel is a grid over z-planes that is handed the previous,
// current and next plane (mod nz) at each step. Here a thread owns kV
// consecutive outputs of one row, as in 2D, and marches over a range of
// z-planes with its z-1, z and z+1 vectors in registers, so a plane is
// read from DRAM once per block that needs it: per plane one vector load
// of the next plane, vector loads of the rows above and below in the
// current plane (wrapped; the block next door, or this block one plane
// ago, has just read them, so L1 and L2 serve them) and one scalar past
// each end of its own row. Blocks do not depend on each other: each
// re-reads the planes just before and after its range, and the launcher
// splits z only as far as the card needs blocks to stay busy. kV as in 2D.
// A first draft that staged each plane's tile in shared memory, one cell
// per thread with the tile's rim loaded by its edge threads, ran a third
// slower than the stream kernel and was replaced by this form.
// ---------------------------------------------------------------------------
constexpr int kBX3 = 32;
constexpr int kBY3 = 8;
// blocks the launcher aims for before it stops splitting z: 132 SMs, each
// holding 8 blocks of 256 threads
constexpr int kTargetBlocks3 = 132 * 8;

template <typename T, bool kPeriodic, int kV>
__global__ void __launch_bounds__(kBX3* kBY3)
    jacobi3d_block_kernel(const T* __restrict__ u, T* __restrict__ out,
                          int nz, int ny, int nx, int planes) {
  using V = Vec<T, kV>;
  const float sixth = static_cast<float>(1.0 / 6.0);
  const int x0 = (blockIdx.x * kBX3 + threadIdx.x) * kV;
  const int y = blockIdx.y * kBY3 + threadIdx.y;
  if (x0 >= nx || y >= ny) return;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int z_begin = blockIdx.z * planes;
  const int z_end = min(z_begin + planes, nz);
  // offsets inside a plane: this thread's vector, the same columns one
  // row up and down, the cells left and right of the vector
  const int64_t row = static_cast<int64_t>(y) * nx;
  const int64_t own = row + x0;
  const int64_t up = static_cast<int64_t>(y == 0 ? ny - 1 : y - 1) * nx + x0;
  const int64_t down =
      static_cast<int64_t>(y == ny - 1 ? 0 : y + 1) * nx + x0;
  const int64_t left = row + (x0 == 0 ? nx - 1 : x0 - 1);
  const int64_t right = row + (x0 + kV == nx ? 0 : x0 + kV);
  const bool edge_row = !kPeriodic && (y == 0 || y == ny - 1);

  V zm = *reinterpret_cast<const V*>(u + wrap(z_begin - 1, nz) * plane + own);
  V c = *reinterpret_cast<const V*>(u + z_begin * plane + own);
  for (int z = z_begin; z < z_end; ++z) {
    const T* p = u + z * plane;
    const V zp =
        *reinterpret_cast<const V*>(u + wrap(z + 1, nz) * plane + own);
    const V a = *reinterpret_cast<const V*>(p + up);
    const V b = *reinterpret_cast<const V*>(p + down);
    float w[kV + 2];
    w[0] = widen(p[left]);
    w[kV + 1] = widen(p[right]);
#pragma unroll
    for (int k = 0; k < kV; ++k) w[k + 1] = widen(c.e[k]);
    const bool edge_plane =
        edge_row || (!kPeriodic && (z == 0 || z == nz - 1));
    V r;
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      const int x = x0 + k;
      if (edge_plane || (!kPeriodic && (x == 0 || x == nx - 1))) {
        r.e[k] = c.e[k];
      } else {
        r.e[k] = narrow<T>(__fmul_rn(
            __fadd_rn(__fadd_rn(__fadd_rn(widen(zm.e[k]), widen(zp.e[k])),
                                __fadd_rn(widen(a.e[k]), widen(b.e[k]))),
                      __fadd_rn(w[k], w[k + 2])),
            sixth));
      }
    }
    *reinterpret_cast<V*>(out + z * plane + own) = r;
    zm = c;
    c = zp;
  }
}

// grid.y and grid.z are limited to 65535 blocks
constexpr int kMaxGridYZ = 65535;

template <typename T>
int launch1d(const void* u, void* out, int64_t n, bool periodic,
             cudaStream_t stream) {
  constexpr int kW = 16 / sizeof(T);
  const bool vec = aligned16(u) && aligned16(out);
  const int threads = 256;
  const int64_t per_block = static_cast<int64_t>(threads) * (vec ? kW : 1);
  const int64_t blocks64 = (n + per_block - 1) / per_block;
  if (blocks64 > 0x7fffffff) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(blocks64);
  auto* src = static_cast<const T*>(u);
  auto* dst = static_cast<T*>(out);
  if (vec) {
    if (periodic) {
      jacobi1d_block_kernel<T, true, kW><<<blocks, threads, 0, stream>>>(
          src, dst, n);
    } else {
      jacobi1d_block_kernel<T, false, kW><<<blocks, threads, 0, stream>>>(
          src, dst, n);
    }
  } else if (periodic) {
    jacobi1d_block_kernel<T, true, 1><<<blocks, threads, 0, stream>>>(
        src, dst, n);
  } else {
    jacobi1d_block_kernel<T, false, 1><<<blocks, threads, 0, stream>>>(
        src, dst, n);
  }
  return cudaGetLastError();
}

template <typename T>
int launch2d(const void* u, void* out, int ny, int nx, bool periodic,
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
      jacobi2d_block_kernel<T, true, kW><<<grid, block, 0, stream>>>(
          src, dst, ny, nx);
    } else {
      jacobi2d_block_kernel<T, false, kW><<<grid, block, 0, stream>>>(
          src, dst, ny, nx);
    }
  } else if (periodic) {
    jacobi2d_block_kernel<T, true, 1><<<grid, block, 0, stream>>>(src, dst,
                                                                  ny, nx);
  } else {
    jacobi2d_block_kernel<T, false, 1><<<grid, block, 0, stream>>>(src, dst,
                                                                   ny, nx);
  }
  return cudaGetLastError();
}

template <typename T>
int launch3d(const void* u, void* out, int nz, int ny, int nx, bool periodic,
             cudaStream_t stream) {
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
      jacobi3d_block_kernel<T, true, kW><<<grid, block, 0, stream>>>(
          src, dst, nz, ny, nx, planes);
    } else {
      jacobi3d_block_kernel<T, false, kW><<<grid, block, 0, stream>>>(
          src, dst, nz, ny, nx, planes);
    }
  } else if (periodic) {
    jacobi3d_block_kernel<T, true, 1><<<grid, block, 0, stream>>>(
        src, dst, nz, ny, nx, planes);
  } else {
    jacobi3d_block_kernel<T, false, 1><<<grid, block, 0, stream>>>(
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

int tc_jacobi1d_block(const void* u, void* out, int64_t n, int dtype,
                      int periodic, void* stream) {
  if (n < 3) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch1d<float>(u, out, n, periodic, s);
    case kBFloat16:
      return launch1d<__nv_bfloat16>(u, out, n, periodic, s);
    case kFloat16:
      return launch1d<__half>(u, out, n, periodic, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int tc_jacobi2d_block(const void* u, void* out, int ny, int nx, int dtype,
                      int periodic, void* stream) {
  if (ny < 3 || nx < 3) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch2d<float>(u, out, ny, nx, periodic, s);
    case kBFloat16:
      return launch2d<__nv_bfloat16>(u, out, ny, nx, periodic, s);
    case kFloat16:
      return launch2d<__half>(u, out, ny, nx, periodic, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int tc_jacobi3d_block(const void* u, void* out, int nz, int ny, int nx,
                      int dtype, int periodic, void* stream) {
  if (nz < 2 || ny < 3 || nx < 3) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch3d<float>(u, out, nz, ny, nx, periodic, s);
    case kBFloat16:
      return launch3d<__nv_bfloat16>(u, out, nz, ny, nx, periodic, s);
    case kFloat16:
      return launch3d<__half>(u, out, nz, ny, nx, periodic, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
