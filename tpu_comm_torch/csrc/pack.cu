// Hand-written Hopper (sm_90a) kernel that packs the four strided boundary
// faces of a 3D block u[nz, ny, nx] into contiguous send buffers: the port
// of the TPU face-pack kernel of tpu_comm/kernels/pack.py (_pack_kernel, run
// by pack_faces_3d_pallas).
//
// Built by tpu_comm_torch/kernels/_build.py with
//   nvcc -O3 -gencode=arch=compute_90a,code=sm_90a -fmad=false -shared
// into a shared library with a plain C interface, loaded with ctypes. No
// PyTorch header is included: the Python wrapper
// (tpu_comm_torch/kernels/pack.py) passes raw device pointers, the grid of
// its pack_plan and the current CUDA stream, and raises on a non-zero
// return.
//
//   y_lo[z, x] = u[z, 0, x]       y_hi[z, x] = u[z, ny-1, x]     (nz, nx)
//   x_lo[z, y] = u[z, y, 0]       x_hi[z, y] = u[z, y, nx-1]     (nz, ny)
//
// The two z faces u[0] and u[nz-1] are contiguous slabs already and are not
// produced here (the TPU kernel leaves them to slices too). A pack moves
// bits, so the kernel is typed by element size only.
//
// What bounds it on this card: DRAM serving scattered accesses. The TPU
// kernel streams the WHOLE block through VMEM because its DMA engine moves
// tiles; a GPU thread can address any cell, so this kernel reads face
// cells only. The y faces are contiguous rows. The x faces are one element
// per row of nx: seen as nz * ny flat rows, x_lo[r] = u[r * nx] and
// x_hi[r] = u[r * nx + nx - 1], so each element costs at least a DRAM
// sector (32 bytes; the H100's L2 fetches up to 64 for a miss,
// cudaLimitMaxL2FetchGranularity) and the least traffic is
//   2 * nz * ny * 32  +  2 * nz * nx * itemsize   bytes read
// plus the four faces written. At 512^3 that is 524288 accesses 2 KiB
// apart, and their time is what DRAM takes to serve them: on the H100
// the same count of x-face cells packs faster the closer they lie
// (chip_smoke.py phase 5's measure_pack_spacing), and more rows a lane in
// flight (2-8, at 1-16 blocks an SM) packed slower than one (PERF.md).
//
// The design: one launch, a grid of a few blocks an SM (pack_plan) whose
// warps stride over work items, each a warp's whole job:
// - an x chunk: 32 consecutive flat rows, one a lane: every lane issues
//   its two face loads (read-only, no L1 allocation) before its first
//   store, and each store instruction writes 32 consecutive cells of
//   x_lo or x_hi. Lane l's x_hi and lane l + 1's x_lo are neighbours in
//   memory and leave in consecutive instructions; the warps sweep the
//   block in address order;
// - a y row: one of the 2 * nz rows of y_lo, y_hi, copied with 16-byte
//   loads and stores where u, the y faces and the row length nx * itemsize
//   allow it (kVec), cell by cell elsewhere; kYUnroll accesses a lane in
//   flight.
// x chunks come first, so the scattered loads start with the launch. The
// older form (one thread a face cell: 4096 blocks at 512^3, each making
// one load a thread and exiting, x_lo and x_hi of a slab in different
// blocks) paid a block launch for every 256 cells. Not levers here: TMA
// (a tile copy; the x faces are single cells 2 KiB apart, and the y rows
// are 2 MB at 512^3), wgmma (no arithmetic) and clusters (no data shared
// between blocks).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// y-row accesses a lane issues before it stores them
constexpr int kYUnroll = 4;

// Read-only loads that do not allocate in L1: no face cell is read twice.
__device__ __forceinline__ uint32_t load_nc(const uint32_t* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint16_t load_nc(const uint16_t* p) {
  uint16_t v;
  asm("ld.global.nc.L1::no_allocate.b16 %0, [%1];" : "=h"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint4 load_nc(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.b32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// One y row, `n` accesses of type A (a 16-byte vector or a cell), lanes
// striding over it with kYUnroll accesses in flight.
template <typename A>
__device__ __forceinline__ void copy_row(const A* __restrict__ src,
                                         A* __restrict__ dst, int64_t n,
                                         int lane) {
  for (int64_t c = lane; c < n; c += 32 * kYUnroll) {
    A v[kYUnroll];
#pragma unroll
    for (int k = 0; k < kYUnroll; ++k) {
      if (c + 32 * k < n) v[k] = load_nc(src + c + 32 * k);
    }
#pragma unroll
    for (int k = 0; k < kYUnroll; ++k) {
      if (c + 32 * k < n) dst[c + 32 * k] = v[k];
    }
  }
}

// T: the cell's bits (uint32_t, uint16_t); kVec: the y rows as 16-byte
// vectors.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    pack_faces_kernel(const T* __restrict__ u, T* __restrict__ y_lo,
                      T* __restrict__ y_hi, T* __restrict__ x_lo,
                      T* __restrict__ x_hi, int64_t nz, int64_t ny,
                      int64_t nx) {
  const int lane = threadIdx.x % 32;
  const int64_t rows = nz * ny;
  const int64_t x_chunks = (rows + 31) / 32;
  const int64_t items = x_chunks + 2 * nz;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarps +
                        threadIdx.x / 32;
  for (int64_t w = first; w < items; w += warps) {
    if (w < x_chunks) {
      const int64_t r = w * 32 + lane;
      if (r < rows) {
        const T lo = load_nc(u + r * nx);
        const T hi = load_nc(u + r * nx + nx - 1);
        x_lo[r] = lo;
        x_hi[r] = hi;
      }
    } else {
      const int64_t row = w - x_chunks;
      const int64_t z = row / 2;
      const T* src = u + (z * ny + (row % 2 ? ny - 1 : 0)) * nx;
      T* dst = (row % 2 ? y_hi : y_lo) + z * nx;
      if constexpr (kVec) {
        constexpr int kPer = sizeof(uint4) / sizeof(T);
        copy_row(reinterpret_cast<const uint4*>(src),
                 reinterpret_cast<uint4*>(dst), nx / kPer, lane);
      } else {
        copy_row(src, dst, nx, lane);
      }
    }
  }
}

template <typename T>
void launch_pack(const void* u, void* y_lo, void* y_hi, void* x_lo,
                 void* x_hi, int64_t nz, int64_t ny, int64_t nx, int blocks,
                 cudaStream_t stream) {
  const auto* src = static_cast<const T*>(u);
  auto* ylo = static_cast<T*>(y_lo);
  auto* yhi = static_cast<T*>(y_hi);
  auto* xlo = static_cast<T*>(x_lo);
  auto* xhi = static_cast<T*>(x_hi);
  // 16-byte y rows: u and the y faces on the 16-byte grid, and whole
  // vectors a row (then every row starts on it too)
  const auto addr = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p);
  };
  if ((addr(u) | addr(y_lo) | addr(y_hi)) % 16 == 0 &&
      (nx * static_cast<int64_t>(sizeof(T))) % 16 == 0) {
    pack_faces_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        src, ylo, yhi, xlo, xhi, nz, ny, nx);
  } else {
    pack_faces_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        src, ylo, yhi, xlo, xhi, nz, ny, nx);
  }
}

}  // namespace

// C interface. The launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched); cudaErrorInvalidValue for arguments
// the kernel does not take. `blocks` comes from kernels/pack.py
// pack_plan.
extern "C" {

int tc_pack_faces(const void* u, void* y_lo, void* y_hi, void* x_lo,
                  void* x_hi, int64_t nz, int64_t ny, int64_t nx,
                  int itemsize, int blocks, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || blocks < 1) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 4:
      launch_pack<uint32_t>(u, y_lo, y_hi, x_lo, x_hi, nz, ny, nx, blocks,
                            s);
      break;
    case 2:
      launch_pack<uint16_t>(u, y_lo, y_hi, x_lo, x_hi, nz, ny, nx, blocks,
                            s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The most bytes the L2 fetches from DRAM for one missed access
// (cudaLimitMaxL2FetchGranularity), read and never set: what one x-face
// cell may cost.
int tc_l2_fetch_granularity(size_t* bytes) {
  return cudaDeviceGetLimit(bytes, cudaLimitMaxL2FetchGranularity);
}

const char* tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
