// Hand-written Hopper (sm_90a) kernel that packs the four strided boundary
// faces of a 3D block u[nz, ny, nx] into contiguous send buffers: the port
// of the TPU face-pack kernel of tpu_comm/kernels/pack.py (_pack_kernel, run
// by pack_faces_3d_pallas).
//
// Built by tpu_comm_torch/kernels/_build.py with
//   nvcc -O3 -gencode=arch=compute_90a,code=sm_90a -fmad=false -shared
// into a shared library with a plain C interface, loaded with ctypes. No
// PyTorch header is included: the Python wrapper
// (tpu_comm_torch/kernels/pack.py) passes raw device pointers and the
// current CUDA stream, and raises on a non-zero return.
//
//   y_lo[z, x] = u[z, 0, x]       y_hi[z, x] = u[z, ny-1, x]     (nz, nx)
//   x_lo[z, y] = u[z, y, 0]       x_hi[z, y] = u[z, y, nx-1]     (nz, ny)
//
// The two z faces u[0] and u[nz-1] are contiguous slabs already and are not
// produced here (the TPU kernel leaves them to slices too). A pack moves
// bits, so the kernel is typed by element size only.
//
// What bounds it on this card: memory, and at these sizes the launch. The
// TPU kernel streams the WHOLE block through VMEM because its DMA engine
// moves tiles; a GPU thread can address any cell, so this kernel reads face
// cells only. The y faces are contiguous rows (neighbouring threads on
// neighbouring addresses). The x faces are one element per row of nx, so
// each element costs a 32-byte DRAM sector; the least traffic is therefore
//   2 * nz * ny * 32  +  2 * nz * nx * itemsize   bytes read
// plus the four faces written. One launch serves all four faces: grid.y
// walks the z-slabs, and within a slab a flat index runs over its 2*nx + 2*ny
// output elements, y faces first, so a warp stays inside one face except at
// the three seams and no thread divides.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
    pack_faces_kernel(const T* __restrict__ u, T* __restrict__ y_lo,
                      T* __restrict__ y_hi, T* __restrict__ x_lo,
                      T* __restrict__ x_hi, int nz, int ny, int nx) {
  // position in one z-slab's share of the output: nx of y_lo, nx of y_hi,
  // ny of x_lo, ny of x_hi
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= 2 * nx + 2 * ny) return;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  for (int z = blockIdx.y; z < nz; z += gridDim.y) {
    const T* slab = u + z * plane;
    if (j < nx) {
      y_lo[static_cast<int64_t>(z) * nx + j] = slab[j];
    } else if (j < 2 * nx) {
      const int x = j - nx;
      y_hi[static_cast<int64_t>(z) * nx + x] =
          slab[static_cast<int64_t>(ny - 1) * nx + x];
    } else if (j < 2 * nx + ny) {
      const int y = j - 2 * nx;
      x_lo[static_cast<int64_t>(z) * ny + y] =
          slab[static_cast<int64_t>(y) * nx];
    } else {
      const int y = j - 2 * nx - ny;
      x_hi[static_cast<int64_t>(z) * ny + y] =
          slab[static_cast<int64_t>(y) * nx + nx - 1];
    }
  }
}

// grid.y is limited to 65535 blocks; deeper blocks stride over z
constexpr int kMaxGridY = 65535;

template <typename T>
void launch_pack(const void* u, void* y_lo, void* y_hi, void* x_lo,
                 void* x_hi, int nz, int ny, int nx, cudaStream_t stream) {
  const int threads = 256;
  const int64_t per_slab = 2 * static_cast<int64_t>(nx) + 2 * ny;
  const dim3 grid(static_cast<unsigned>((per_slab + threads - 1) / threads),
                  nz < kMaxGridY ? nz : kMaxGridY);
  pack_faces_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<T*>(y_lo), static_cast<T*>(y_hi),
      static_cast<T*>(x_lo), static_cast<T*>(x_hi), nz, ny, nx);
}

}  // namespace

// C interface. The launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched); cudaErrorInvalidValue for arguments
// the kernel does not take.
extern "C" {

int tc_pack_faces(const void* u, void* y_lo, void* y_hi, void* x_lo,
                  void* x_hi, int nz, int ny, int nx, int itemsize,
                  void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || nx > (1 << 28) || ny > (1 << 28)) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 4:
      launch_pack<uint32_t>(u, y_lo, y_hi, x_lo, x_hi, nz, ny, nx, s);
      break;
    case 2:
      launch_pack<uint16_t>(u, y_lo, y_hi, x_lo, x_hi, nz, ny, nx, s);
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
