// Hand-written Hopper (sm_90a) kernels for one Jacobi step of the star
// stencils in 1D, 2D and 3D: the port of the three `pallas-stream` TPU
// kernels of tpu_comm/kernels/jacobi{1,2,3}d.py.
//
// Built by tpu_comm_torch/kernels/_build.py with
//   nvcc -O3 -gencode=arch=compute_90a,code=sm_90a -fmad=false -shared
// into a shared library with a plain C interface, loaded with ctypes. No
// PyTorch header is included: the Python wrappers pass raw device
// pointers and the current CUDA stream, and raise on a non-zero return.
//
// Numerical contract (shared with the plain PyTorch versions and the
// NumPy golden): every element is widened to f32, neighbour pairs are
// summed axis by axis, then across axes, then multiplied by an f32
// constant, and the result is narrowed once with round-to-nearest-even:
//   1D  (prev + next) * 0.5f
//   2D  ((up + down) + (left + right)) * 0.25f
//   3D  (((zm + zp) + (ym + yp)) + (xm + xp)) * (float)(1.0 / 6.0)
// The explicit __fadd_rn/__fmul_rn intrinsics are never contracted into
// an FMA, and -fmad=false guards the rest, so f32 results are bitwise
// equal to the golden. Boundaries are computed in-kernel in one pass:
// periodic neighbours wrap modulo the extent, dirichlet boundary cells
// keep their input value.
//
// What bounds all three on this card: memory. A step must read the field
// once and write it once, 2 * N * itemsize bytes of DRAM traffic, against
// 0.25-0.75 operations per byte. Each design below keeps every element's
// DRAM reads near one per step by taking neighbour values from L1/L2,
// shared memory or registers instead of re-reading DRAM. The tile shapes
// (kSlab2, kTY3 x kRows3) and the wrappers' default chunks were picked by
// a short sweep on an H100; a shape changes the speed, never the result.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// dtype codes shared with tpu_comm_torch/kernels/_build.py DTYPE_CODES
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kFloat16 = 2;

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

// ---------------------------------------------------------------------------
// 1D: replaces tpu_comm/kernels/jacobi1d.py _jacobi1d_stream_kernel (and the
// endpoint fix-up _fix_global_endpoints the TPU arm runs outside it).
//
// Grid-stride over the flat field; the grid size is set by the chunk
// (rows of 128 elements per block, the counterpart of rows_per_chunk).
//   kCarry = false (`stream`): each thread reads its two neighbours;
//     neighbouring threads read neighbouring addresses, so a warp's loads
//     fall on the same few cache lines and DRAM sees each element about
//     once per step.
//   kCarry = true (`stream2`): the TPU arm's column-strip carry
//     (colfix=True: _flat_shift_prev_colfix / _flat_shift_next_colfix, which
//     roll the whole block once by lanes and only the edge column by
//     sublanes). A warp holds runs of 32 consecutive cells; each thread
//     loads its own cell once, its neighbours come from the lanes beside
//     it (__shfl_up_sync / __shfl_down_sync, the lane roll), and only a
//     run's two edge carries, lane 0's previous cell and lane 31's next,
//     are read from memory (the strip). One load a cell instead of two;
//     the result is bitwise the same.
// ---------------------------------------------------------------------------
// runs of 32 cells a warp of the carry form loads before it computes
constexpr int kCarryRuns = 4;

template <typename T, bool kPeriodic, bool kCarry>
__global__ void __launch_bounds__(256)
    jacobi1d_kernel(const T* __restrict__ u, T* __restrict__ out,
                    int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if constexpr (!kCarry) {
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
         i < n; i += stride) {
      if (!kPeriodic && (i == 0 || i == n - 1)) {
        out[i] = u[i];
        continue;
      }
      const int64_t ip = (i == 0) ? n - 1 : i - 1;
      const int64_t in = (i == n - 1) ? 0 : i + 1;
      out[i] = narrow<T>(
          __fmul_rn(__fadd_rn(widen(u[ip]), widen(u[in])), 0.5f));
    }
  } else {
    // a warp takes kCarryRuns runs of 32 consecutive cells an iteration,
    // their loads in flight together; the loop bound is the same for
    // every lane, so the warp stays whole for the shuffles
    const int lane = threadIdx.x % 32;
    for (int64_t w = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x - lane) * kCarryRuns;
         w < n; w += stride * kCarryRuns) {
      float self[kCarryRuns];
#pragma unroll
      for (int r = 0; r < kCarryRuns; ++r) {
        const int64_t i = w + r * 32 + lane;
        self[r] = i < n ? widen(u[i]) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kCarryRuns; ++r) {
        const int64_t i = w + r * 32 + lane;
        float prev = __shfl_up_sync(0xffffffffu, self[r], 1);
        float next = __shfl_down_sync(0xffffffffu, self[r], 1);
        if (i >= n) continue;
        if (!kPeriodic && (i == 0 || i == n - 1)) {
          out[i] = narrow<T>(self[r]);
          continue;
        }
        // the strip: the run's two edge carries come from memory
        if (lane == 0 || i == 0) prev = widen(u[i == 0 ? n - 1 : i - 1]);
        if (lane == 31 || i == n - 1) next = widen(u[i == n - 1 ? 0 : i + 1]);
        out[i] = narrow<T>(__fmul_rn(__fadd_rn(prev, next), 0.5f));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2D: replaces tpu_comm/kernels/jacobi2d.py _jacobi2d_stream_kernel (and the
// top/bottom row recompute and ring freeze the TPU arm runs outside it).
//
// A block of 32 x 8 threads owns a strip 32 columns wide and `rows` rows
// tall (the chunk). It walks down its strip kSlab2 rows at a time, staging
// each slab plus a one-cell halo (rows and columns wrapped modulo the
// extents) in shared memory, so the four neighbours come from shared
// memory; each thread then computes every 8th row of the slab. Halo cells
// are the only re-reads and mostly hit L2. A tall slab keeps several
// loads in flight per thread between the two barriers.
// ---------------------------------------------------------------------------
constexpr int kTX2 = 32;
constexpr int kTY2 = 8;
constexpr int kSlab2 = 64;

template <typename T, bool kPeriodic>
__global__ void __launch_bounds__(kTX2* kTY2)
    jacobi2d_kernel(const T* __restrict__ u, T* __restrict__ out, int ny,
                    int nx, int rows) {
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
        v = __fmul_rn(
            __fadd_rn(__fadd_rn(tile[r][tx + 1], tile[r + 2][tx + 1]),
                      __fadd_rn(tile[r + 1][tx], tile[r + 1][tx + 2])),
            0.25f);
      }
      out[static_cast<int64_t>(y) * nx + x] = narrow<T>(v);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// 3D: replaces tpu_comm/kernels/jacobi3d.py _jacobi3d_stream_kernel (and the
// shell freeze the TPU arm runs outside it).
//
// A block of 32 x 4 threads owns a (y, x) tile of 32 columns and kTH3 rows
// and marches over a chunk of `planes` z-planes (the counterpart of the TPU
// kernel's zb). Each thread owns kRows3 cells of the tile's column (rows
// ty, ty + 4, ...) and keeps their z-1, z and z+1 values in registers; the
// current plane's tile plus a one-cell ring (wrapped modulo ny and nx) is
// staged in shared memory for the four in-plane neighbours. Only the planes
// just before and after the chunk are read twice, so each plane crosses
// DRAM about (planes + 2) / planes times per step: the TPU kernel's own
// economy.
// ---------------------------------------------------------------------------
constexpr int kTX3 = 32;
constexpr int kTY3 = 4;
constexpr int kRows3 = 4;
constexpr int kTH3 = kTY3 * kRows3;
constexpr int kRing3 = 2 * (kTX3 + 2) + 2 * kTH3;

template <typename T, bool kPeriodic>
__global__ void __launch_bounds__(kTX3* kTY3)
    jacobi3d_kernel(const T* __restrict__ u, T* __restrict__ out, int nz,
                    int ny, int nx, int planes) {
  __shared__ float tile[kTH3 + 2][kTX3 + 2];
  const float sixth = static_cast<float>(1.0 / 6.0);
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTX3 + tx;
  const int x0 = blockIdx.x * kTX3;
  const int y0 = blockIdx.y * kTH3;
  const int x = x0 + tx;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int z_begin = blockIdx.z * planes;
  const int z_end = min(z_begin + planes, nz);

  // threads past the edge hold the wrapped cell: it is a real neighbour
  // of the last active column or row in the periodic case
  int64_t col[kRows3];
  float zm[kRows3];
  float zc[kRows3];
#pragma unroll
  for (int i = 0; i < kRows3; ++i) {
    col[i] = static_cast<int64_t>(wrap(y0 + ty + i * kTY3, ny)) * nx +
             wrap(x, nx);
    zm[i] = widen(u[wrap(z_begin - 1, nz) * plane + col[i]]);
    zc[i] = widen(u[z_begin * plane + col[i]]);
  }
  for (int z = z_begin; z < z_end; ++z) {
    float zp[kRows3];
#pragma unroll
    for (int i = 0; i < kRows3; ++i) {
      zp[i] = widen(u[wrap(z + 1, nz) * plane + col[i]]);
      tile[ty + i * kTY3 + 1][tx + 1] = zc[i];
    }
    const T* p = u + z * plane;
    for (int k = tid; k < kRing3; k += kTX3 * kTY3) {
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
      const int y = y0 + r;
      if (x < nx && y < ny) {
        float v;
        if (!kPeriodic && (z == 0 || z == nz - 1 || y == 0 || y == ny - 1 ||
                           x == 0 || x == nx - 1)) {
          v = zc[i];
        } else {
          v = __fmul_rn(
              __fadd_rn(__fadd_rn(__fadd_rn(zm[i], zp[i]),
                                  __fadd_rn(tile[r][tx + 1],
                                            tile[r + 2][tx + 1])),
                        __fadd_rn(tile[r + 1][tx], tile[r + 1][tx + 2])),
              sixth);
        }
        out[z * plane + static_cast<int64_t>(y) * nx + x] = narrow<T>(v);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows3; ++i) {
      zm[i] = zc[i];
      zc[i] = zp[i];
    }
  }
}

template <typename T, bool kCarry>
void launch1d(const void* u, void* out, int64_t n, bool periodic,
              int rows_per_chunk, cudaStream_t stream) {
  const int threads = 256;
  const int64_t per_block = static_cast<int64_t>(rows_per_chunk) * 128;
  const int64_t blocks64 = (n + per_block - 1) / per_block;
  const unsigned blocks =
      static_cast<unsigned>(blocks64 < 0x7fffffff ? blocks64 : 0x7fffffff);
  auto* src = static_cast<const T*>(u);
  auto* dst = static_cast<T*>(out);
  if (periodic) {
    jacobi1d_kernel<T, true, kCarry>
        <<<blocks, threads, 0, stream>>>(src, dst, n);
  } else {
    jacobi1d_kernel<T, false, kCarry>
        <<<blocks, threads, 0, stream>>>(src, dst, n);
  }
}

template <typename T>
void launch2d(const void* u, void* out, int ny, int nx, bool periodic,
              int rows, cudaStream_t stream) {
  const dim3 block(kTX2, kTY2);
  const dim3 grid((nx + kTX2 - 1) / kTX2, (ny + rows - 1) / rows);
  auto* src = static_cast<const T*>(u);
  auto* dst = static_cast<T*>(out);
  if (periodic) {
    jacobi2d_kernel<T, true><<<grid, block, 0, stream>>>(src, dst, ny, nx,
                                                         rows);
  } else {
    jacobi2d_kernel<T, false><<<grid, block, 0, stream>>>(src, dst, ny, nx,
                                                          rows);
  }
}

template <typename T>
void launch3d(const void* u, void* out, int nz, int ny, int nx,
              bool periodic, int planes, cudaStream_t stream) {
  const dim3 block(kTX3, kTY3);
  const dim3 grid((nx + kTX3 - 1) / kTX3, (ny + kTH3 - 1) / kTH3,
                  (nz + planes - 1) / planes);
  auto* src = static_cast<const T*>(u);
  auto* dst = static_cast<T*>(out);
  if (periodic) {
    jacobi3d_kernel<T, true><<<grid, block, 0, stream>>>(src, dst, nz, ny,
                                                         nx, planes);
  } else {
    jacobi3d_kernel<T, false><<<grid, block, 0, stream>>>(src, dst, nz, ny,
                                                          nx, planes);
  }
}

// grid.y and grid.z are limited to 65535 blocks
constexpr int kMaxGridYZ = 65535;

template <bool kCarry>
int jacobi1d_launch(const void* u, void* out, int64_t n, int dtype,
                    int periodic, int rows_per_chunk, void* stream) {
  if (n < 3 || rows_per_chunk < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      launch1d<float, kCarry>(u, out, n, periodic, rows_per_chunk, s);
      break;
    case kBFloat16:
      launch1d<__nv_bfloat16, kCarry>(u, out, n, periodic, rows_per_chunk,
                                      s);
      break;
    case kFloat16:
      launch1d<__half, kCarry>(u, out, n, periodic, rows_per_chunk, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// C interface. Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched), so a refused launch is reported to
// the wrapper instead of vanishing; cudaErrorInvalidValue for arguments
// the kernels do not take.
extern "C" {

int tc_jacobi1d_stream(const void* u, void* out, int64_t n, int dtype,
                       int periodic, int rows_per_chunk, void* stream) {
  return jacobi1d_launch<false>(u, out, n, dtype, periodic, rows_per_chunk,
                                stream);
}

int tc_jacobi1d_stream2(const void* u, void* out, int64_t n, int dtype,
                        int periodic, int rows_per_chunk, void* stream) {
  return jacobi1d_launch<true>(u, out, n, dtype, periodic, rows_per_chunk,
                               stream);
}

int tc_jacobi2d_stream(const void* u, void* out, int ny, int nx, int dtype,
                       int periodic, int rows, void* stream) {
  if (ny < 3 || nx < 3 || rows < 1 || (ny + rows - 1) / rows > kMaxGridYZ) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      launch2d<float>(u, out, ny, nx, periodic, rows, s);
      break;
    case kBFloat16:
      launch2d<__nv_bfloat16>(u, out, ny, nx, periodic, rows, s);
      break;
    case kFloat16:
      launch2d<__half>(u, out, ny, nx, periodic, rows, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int tc_jacobi3d_stream(const void* u, void* out, int nz, int ny, int nx,
                       int dtype, int periodic, int planes, void* stream) {
  if (nz < 3 || ny < 3 || nx < 3 || planes < 1 ||
      (ny + kTH3 - 1) / kTH3 > kMaxGridYZ ||
      (nz + planes - 1) / planes > kMaxGridYZ) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      launch3d<float>(u, out, nz, ny, nx, periodic, planes, s);
      break;
    case kBFloat16:
      launch3d<__nv_bfloat16>(u, out, nz, ny, nx, periodic, planes, s);
      break;
    case kFloat16:
      launch3d<__half>(u, out, nz, ny, nx, periodic, planes, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
