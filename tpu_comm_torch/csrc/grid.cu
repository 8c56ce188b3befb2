// Hand-written Hopper (sm_90a) kernels for one Jacobi step of the 1D and 2D
// star by whole windows: the port of the TPU `pallas-grid` kernels
//   tpu_comm/kernels/jacobi1d.py _jacobi1d_grid_kernel (step_pallas_grid)
//   tpu_comm/kernels/jacobi2d.py _jacobi2d_grid_kernel (step_pallas_grid)
// and of the edge fixes those wrappers run outside their kernels
// (_fix_global_endpoints in 1D, the top and bottom rows in 2D): here every
// cell, the global edges included, is computed in the kernel.
//
// Built by tpu_comm_torch/kernels/_build.py with
//   nvcc -O3 -gencode=arch=compute_90a,code=sm_90a -fmad=false -shared
// into a shared library with a plain C interface, loaded with ctypes. No
// PyTorch header is included: the Python wrappers pass raw device
// pointers and the current CUDA stream, and raise on a non-zero return.
//
// Numerical contract (shared with step_plain in kernels/jacobi1d.py and
// kernels/jacobi2d.py): every element is widened to f32 and
//   1D  (prev + next) * 0.5f
//   2D  ((up + down) + (left + right)) * 0.25f
// is narrowed once, round-to-nearest-even. __fadd_rn/__fmul_rn are never
// contracted into an FMA, and -fmad=false guards the rest, so f32 results
// are bitwise equal to the golden. Periodic neighbours wrap modulo the
// extents; under dirichlet a boundary cell keeps its input value.
//
// Design: the TPU kernel's own. Each program (here: each CTA) owns one
// chunk, starts one asynchronous copy of its window (the chunk plus a
// one-cell halo) into scratch, waits for it, then computes the chunk and
// writes it. The copy is a TMA bulk copy completing on an mbarrier (the
// make_async_copy + DMA semaphore analog), staged as csrc/staging.cuh
// sets out, with plain loads for the wrapped halo and the field's
// unaligned ends. The TPU's 8-row halo was tile alignment only: one cell
// is enough. In 2D a full f32 row at 8192 is 32 KB, so the window is a
// tile of rows x kTileX columns, not a band of full rows.
//
// What bounds both on this card: memory, 2 * N * itemsize bytes a step.
// Nothing inside a CTA overlaps its load with its compute: only the other
// resident CTAs (the default chunk sizes a window to ~36 KB, 6 a SM) keep
// DRAM busy while one computes.

#include "staging.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the 2D window's interior width: one column a thread
constexpr int kTileX = kThreads;
// grid.y is limited to 65535 blocks
constexpr int kMaxGridY = 65535;

// ---------------------------------------------------------------------------
// 1D: CTA b owns the outputs [b * chunk, min((b + 1) * chunk, n)); its
// window is those cells plus one on each side, wrapped.
// ---------------------------------------------------------------------------
template <typename T, bool kPeriodic>
__global__ void __launch_bounds__(kThreads)
    jacobi1d_grid_kernel(const T* __restrict__ u, T* __restrict__ out,
                         int64_t n, int64_t chunk) {
  extern __shared__ __align__(16) uint8_t win[];
  __shared__ __align__(8) uint64_t bar;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t i1 = i0 + chunk < n ? i0 + chunk : n;
  const int64_t c0 = i0 - 1;
  const int64_t c1 = i1 + 1;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const RowPlan<T> p = plan_row(u, n, c0, c1, field_of(u, n));
    if (threadIdx.x == 0) {
      mbar_arrive(&bar, bulk_bytes(p));
      issue_bulk(p, win, &bar);
    }
    load_plain(p, u, n, c0, c1, win, threadIdx.x, 32);
  }
  mbar_wait(&bar, 0);
  __syncthreads();  // the plain loads
  const T* s = staged(win, u, c0);  // cell i at s[i - c0]
  for (int64_t i = i0 + threadIdx.x; i < i1; i += kThreads) {
    const int64_t k = i - c0;
    float v;
    if (!kPeriodic && (i == 0 || i == n - 1)) {
      v = widen(s[k]);
    } else {
      v = __fmul_rn(__fadd_rn(widen(s[k - 1]), widen(s[k + 1])), 0.5f);
    }
    out[i] = narrow<T>(v);
  }
}

// ---------------------------------------------------------------------------
// 2D: CTA (bx, by) owns the rows [by * rows, ...) x the columns
// [bx * kTileX, ...); its window is rows + 2 staged row ranges of
// kTileX + 2 columns (rows and columns wrapped). Warp w stages the window
// rows w, w + kWarps, ...: its lane 0 issues their bulk copies and arrives
// once on the barrier, its lanes load their plain columns. Thread x then
// walks down column x of the tile.
// ---------------------------------------------------------------------------
template <typename T>
__host__ __device__ constexpr int64_t pitch2d() {
  return staged_bytes(kTileX + 2, sizeof(T));
}

template <typename T, bool kPeriodic>
__global__ void __launch_bounds__(kThreads)
    jacobi2d_grid_kernel(const T* __restrict__ u, T* __restrict__ out,
                         int ny, int nx, int rows) {
  extern __shared__ __align__(16) uint8_t win[];
  __shared__ __align__(8) uint64_t bar;
  constexpr int64_t kPitch = pitch2d<T>();
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * rows;
  const int y1 = y0 + rows < ny ? y0 + rows : ny;
  const int64_t c0 = x0 - 1;
  const int64_t c1 = (x0 + kTileX < nx ? x0 + kTileX : nx) + 1;
  const int wrows = y1 - y0 + 2;  // the rows y0 - 1 .. y1, wrapped
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const Field f = field_of(u, static_cast<int64_t>(ny) * nx);
  if (threadIdx.x == 0) {
    mbar_init(&bar, kWarps);
    mbar_fence_init();
  }
  __syncthreads();
  auto row_of = [&](int wr) {
    int gy = y0 - 1 + wr;
    gy = gy < 0 ? gy + ny : (gy >= ny ? gy - ny : gy);
    return u + static_cast<int64_t>(gy) * nx;
  };
  if (lane == 0) {
    uint32_t bytes = 0;
    for (int wr = warp; wr < wrows; wr += kWarps) {
      bytes += bulk_bytes(plan_row(row_of(wr), nx, c0, c1, f));
    }
    mbar_arrive(&bar, bytes);
  }
  for (int wr = warp; wr < wrows; wr += kWarps) {
    const T* row = row_of(wr);
    const RowPlan<T> p = plan_row(row, nx, c0, c1, f);
    uint8_t* dst = win + wr * kPitch;
    if (lane == 0) issue_bulk(p, dst, &bar);
    load_plain(p, row, nx, c0, c1, dst, lane, 32);
  }
  mbar_wait(&bar, 0);
  __syncthreads();  // the plain loads
  const int x = x0 + static_cast<int>(threadIdx.x);
  if (x >= nx) return;
  const int k = x - x0 + 1;  // column x in a staged row
  const T* up = staged(win, row_of(0), c0);
  const T* mid = staged(win + kPitch, row_of(1), c0);
  for (int r = 0; r < y1 - y0; ++r) {
    const T* down = staged(win + (r + 2) * kPitch, row_of(r + 2), c0);
    const int y = y0 + r;
    float v;
    if (!kPeriodic && (y == 0 || y == ny - 1 || x == 0 || x == nx - 1)) {
      v = widen(mid[k]);
    } else {
      v = __fmul_rn(__fadd_rn(__fadd_rn(widen(up[k]), widen(down[k])),
                              __fadd_rn(widen(mid[k - 1]), widen(mid[k + 1]))),
                    0.25f);
    }
    out[static_cast<int64_t>(y) * nx + x] = narrow<T>(v);
    up = mid;
    mid = down;
  }
}

template <typename T, bool kPeriodic>
int launch1d(const void* u, void* out, int64_t n, int rows,
             cudaStream_t stream) {
  auto kernel = jacobi1d_grid_kernel<T, kPeriodic>;
  static const int opted = allow_smem(kernel);
  if (opted != 0) return opted;
  const int64_t chunk = static_cast<int64_t>(rows) * 128;
  const int64_t smem = staged_bytes(chunk + 2, sizeof(T));
  const int64_t blocks = (n + chunk - 1) / chunk;
  if (smem > kMaxSmem || blocks > 0x7fffffff) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<T*>(out), n, chunk);
  return cudaGetLastError();
}

template <typename T, bool kPeriodic>
int launch2d(const void* u, void* out, int ny, int nx, int rows,
             cudaStream_t stream) {
  auto kernel = jacobi2d_grid_kernel<T, kPeriodic>;
  static const int opted = allow_smem(kernel);
  if (opted != 0) return opted;
  const int64_t smem = (rows + 2) * pitch2d<T>();
  if (smem > kMaxSmem || (ny + rows - 1) / rows > kMaxGridY) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((nx + kTileX - 1) / kTileX, (ny + rows - 1) / rows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<T*>(out), ny, nx, rows);
  return cudaGetLastError();
}

template <typename T>
int launch1d_bc(const void* u, void* out, int64_t n, bool periodic, int rows,
                cudaStream_t s) {
  return periodic ? launch1d<T, true>(u, out, n, rows, s)
                  : launch1d<T, false>(u, out, n, rows, s);
}

template <typename T>
int launch2d_bc(const void* u, void* out, int ny, int nx, bool periodic,
                int rows, cudaStream_t s) {
  return periodic ? launch2d<T, true>(u, out, ny, nx, rows, s)
                  : launch2d<T, false>(u, out, ny, nx, rows, s);
}

}  // namespace

// C interface. Each launcher enqueues one kernel on `stream` and returns
// the launch's cudaError_t (0 = launched); cudaErrorInvalidValue for
// arguments the kernels do not take (a chunk whose window exceeds shared
// memory among them).
extern "C" {

int tc_jacobi1d_grid(const void* u, void* out, int64_t n, int dtype,
                     int periodic, int rows_per_chunk, void* stream) {
  if (n < 3 || rows_per_chunk < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch1d_bc<float>(u, out, n, periodic, rows_per_chunk, s);
    case kBFloat16:
      return launch1d_bc<__nv_bfloat16>(u, out, n, periodic, rows_per_chunk,
                                        s);
    case kFloat16:
      return launch1d_bc<__half>(u, out, n, periodic, rows_per_chunk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int tc_jacobi2d_grid(const void* u, void* out, int ny, int nx, int dtype,
                     int periodic, int rows, void* stream) {
  if (ny < 3 || nx < 3 || rows < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch2d_bc<float>(u, out, ny, nx, periodic, rows, s);
    case kBFloat16:
      return launch2d_bc<__nv_bfloat16>(u, out, ny, nx, periodic, rows, s);
    case kFloat16:
      return launch2d_bc<__half>(u, out, ny, nx, periodic, rows, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
