// Hand-written Hopper (sm_90a) kernels for one Jacobi step of the 1D and 2D
// star as ring-buffered block streams: the port of the TPU `pallas-wave`
// kernels
//   tpu_comm/kernels/jacobi1d.py _jacobi1d_wave_kernel (step_pallas_wave)
//   tpu_comm/kernels/jacobi2d.py _jacobi2d_wave_kernel (step_pallas_wave)
// Dirichlet only, as the TPU arm: the launchers refuse periodic.
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
// is narrowed once, round-to-nearest-even; a cell on the boundary ring
// keeps its input value. __fadd_rn/__fmul_rn are never contracted into an
// FMA, and -fmad=false guards the rest, so f32 results are bitwise equal
// to the golden.
//
// Design. The TPU kernel runs its grid in order on one core: at grid step
// k it receives block k while it advances block k - 1 from a two-block f32
// scratch ring that persists across steps, so each block crosses HBM once;
// the uninitialised ring at k = 0 and the clamped self-read at the tail
// produce junk that only the frozen global edge cells would see, and the
// freeze overwrites it. CUDA CTAs run at once and in no order (ROADMAP
// Trap 1), so here each CTA streams a contiguous range of blocks of its
// own (1D: a range of the flat field; 2D: a column strip of kStripX
// columns x a range of rows) through a ring of kSlots shared-memory slots,
// with one producer warp and kConsumers computing threads:
//   - the producer fills a slot (a TMA bulk copy per row, completing on
//     the slot's `full` mbarrier, staged as csrc/staging.cuh sets out) as
//     soon as every consumer warp has handed it back on its `empty`
//     mbarrier, so it runs up to kSlots - 2 blocks ahead;
//   - the consumers compute block j from blocks j - 1 (its last row or
//     cell), j and j + 1 (its first), then hand back block j - 1's slot;
//     no barrier spans the CTA inside the loop;
//   - the cells just outside the range (1D: one cell each side; 2D: one
//     halo row each side) are loaded once at the start and the ring holds
//     only real data: nothing is junk, so no freeze is needed to mask a
//     warmup, and the arm stays dirichlet only because the TPU arm is;
//   - in 2D the strip's two halo columns ride in every staged row.
// Each block crosses DRAM once; the re-reads are the two halo rows (or
// cells) per range and, in 2D, the halo columns (in L2 mostly: the
// neighbouring strip reads them as its own). The slots hold the field's
// dtype as the copies land it; widening on read is exact, so the values
// are an f32 ring's. The launcher sizes the grid to one wave of resident
// CTAs, which makes the ranges as long as the card allows.
//
// What bounds both on this card: memory, 2 * N * itemsize bytes a step.

#include "staging.cuh"

namespace {

// the computing threads: one column (2D) a thread; and one producer warp
constexpr int kConsumers = 256;
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;
// the ring's slots: blocks j - 1 and j, and up to kSlots - 2 ahead
constexpr int kSlots = 4;
// the 2D strip's width
constexpr int kStripX = kConsumers;

// the ring slot of block j in a range that starts at block j0, and the
// parity of the slot's barrier phase that block j's fill (`full`) or
// hand-back (`empty`) completes
__device__ __forceinline__ int slot_of(int64_t j, int64_t j0) {
  return static_cast<int>((j - j0) % kSlots);
}
__device__ __forceinline__ uint32_t parity_of(int64_t j, int64_t j0) {
  return static_cast<uint32_t>(((j - j0) / kSlots) & 1);
}

// The consumers are done with block j - 1 once block j is computed: each
// consumer warp hands its slot back.
__device__ __forceinline__ void hand_back(uint64_t* empty, int64_t j,
                                          int64_t j0) {
  __syncwarp();
  if (j > j0 && threadIdx.x % 32 == 0) {
    mbar_arrive(&empty[slot_of(j - 1, j0)], 0);
  }
}

// The producer waits until block j's slot is free: the consumers handed
// back the block kSlots earlier.
__device__ __forceinline__ void wait_free(uint64_t* empty, int64_t j,
                                          int64_t j0) {
  if (j - j0 >= kSlots) {
    mbar_wait(&empty[slot_of(j, j0)], parity_of(j - kSlots, j0));
  }
}

// ---------------------------------------------------------------------------
// 1D: a block is `block` consecutive cells; CTA b streams the blocks
// [nb * b / G, nb * (b + 1) / G). The producer's lane 0 copies each block
// (its lanes load the plain cells).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    jacobi1d_wave_kernel(const T* __restrict__ u, T* __restrict__ out,
                         int64_t n, int64_t block, int64_t nb,
                         int64_t slot_bytes) {
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ __align__(8) uint64_t full[kSlots];
  __shared__ __align__(8) uint64_t empty[kSlots];
  __shared__ float halo[2];
  const int64_t j0 = nb * blockIdx.x / gridDim.x;
  const int64_t j1 = nb * (blockIdx.x + 1) / gridDim.x;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
    // the cells just outside the range, read a second time; a frozen end
    // of the field needs none
    halo[0] = j0 > 0 ? widen(u[j0 * block - 1]) : 0.0f;
    halo[1] = j1 * block < n ? widen(u[j1 * block]) : 0.0f;
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {  // the producer warp
    const int lane = threadIdx.x - kConsumers;
    const Field f = field_of(u, n);
    for (int64_t j = j0; j < j1; ++j) {
      wait_free(empty, j, j0);
      const int64_t c0 = j * block;
      const int64_t c1 = c0 + block < n ? c0 + block : n;
      const RowPlan<T> p = plan_row(u, n, c0, c1, f);
      uint64_t* bar = &full[slot_of(j, j0)];
      uint8_t* dst = ring + slot_of(j, j0) * slot_bytes;
      load_plain(p, u, n, c0, c1, dst, lane, 32);
      __syncwarp();  // lane 0's arrival releases the warp's plain loads
      if (lane == 0) {
        mbar_arrive(bar, bulk_bytes(p));
        issue_bulk(p, dst, bar);
      }
    }
    return;
  }
  for (int64_t j = j0; j < j1; ++j) {
    mbar_wait(&full[slot_of(j, j0)], parity_of(j, j0));
    if (j + 1 < j1) mbar_wait(&full[slot_of(j + 1, j0)], parity_of(j + 1, j0));
    const int64_t c0 = j * block;
    const int64_t c1 = c0 + block < n ? c0 + block : n;
    const T* cur = staged(ring + slot_of(j, j0) * slot_bytes, u, c0);
    const T* prv = j > j0 ? staged(ring + slot_of(j - 1, j0) * slot_bytes,
                                   u, c0 - block)
                          : nullptr;
    const T* nxt = j + 1 < j1 ? staged(ring + slot_of(j + 1, j0) * slot_bytes,
                                       u, c0 + block)
                              : nullptr;
    // 32-bit offsets inside the block; the field's two ends are frozen
    const int len = static_cast<int>(c1 - c0);
    const int frozen_lo = c0 == 0 ? 0 : -1;
    const int frozen_hi = c1 == n ? len - 1 : -1;
    T* o = out + c0;
    for (int k = threadIdx.x; k < len; k += kConsumers) {
      float v;
      if (k == frozen_lo || k == frozen_hi) {
        v = widen(cur[k]);
      } else {
        const float left = k > 0 ? widen(cur[k - 1])
                                 : (prv ? widen(prv[block - 1]) : halo[0]);
        const float right = k + 1 < len ? widen(cur[k + 1])
                                        : (nxt ? widen(nxt[0]) : halo[1]);
        v = __fmul_rn(__fadd_rn(left, right), 0.5f);
      }
      o[k] = narrow<T>(v);
    }
    hand_back(empty, j, j0);
  }
}

// ---------------------------------------------------------------------------
// 2D: a block is `rb` rows of a strip of kStripX columns; CTA (s, b)
// streams strip s's blocks [nb * b / G, nb * (b + 1) / G) (G = gridDim.y).
// A staged row holds the strip and its halo columns. Producer lane r
// stages the block's rows r, r + 32, ... and arrives once on the slot's
// barrier; consumer x computes column x of every row.
// ---------------------------------------------------------------------------
template <typename T>
__host__ __device__ constexpr int64_t pitch2d() {
  return staged_bytes(kStripX + 2, sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    jacobi2d_wave_kernel(const T* __restrict__ u, T* __restrict__ out,
                         int ny, int nx, int rb) {
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ __align__(8) uint64_t full[kSlots + 1];  // the last: halo rows
  __shared__ __align__(8) uint64_t empty[kSlots];
  constexpr int64_t kPitch = pitch2d<T>();
  const int64_t slot_bytes = rb * kPitch;
  uint8_t* halo_rows = ring + kSlots * slot_bytes;  // rows y0 - 1 and y1
  uint64_t* halo_bar = &full[kSlots];
  const int64_t nb = (ny + rb - 1) / rb;
  const int64_t j0 = nb * blockIdx.y / gridDim.y;
  const int64_t j1 = nb * (blockIdx.y + 1) / gridDim.y;
  const int y0 = static_cast<int>(j0 * rb);
  const int y1 = static_cast<int>(j1 * rb < ny ? j1 * rb : ny);
  const int x0 = blockIdx.x * kStripX;
  const int64_t c0 = x0 > 0 ? x0 - 1 : 0;
  const int64_t c1 = x0 + kStripX + 1 < nx ? x0 + kStripX + 1 : nx;
  auto row = [&](int y) { return u + static_cast<int64_t>(y) * nx; };
  if (threadIdx.x == 0) {
    for (int s = 0; s <= kSlots; ++s) mbar_init(&full[s], 32);
    for (int s = 0; s < kSlots; ++s) mbar_init(&empty[s], kConsumerWarps);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {  // the producer warp
    const int lane = threadIdx.x - kConsumers;
    const Field f = field_of(u, static_cast<int64_t>(ny) * nx);
    // stage the rows y of [ya, yb) with y % 32 == lane % 32 into `dst`
    // (row y at dst + (y - ya) * kPitch) on `bar`: plain loads and the
    // arrival first, then the copies
    auto stage = [&](int ya, int yb, const int* ys, uint8_t* dst,
                     uint64_t* bar) {
      uint32_t bytes = 0;
      for (int r = lane; r < yb - ya; r += 32) {
        const int y = ys ? ys[r] : ya + r;
        const RowPlan<T> p = plan_row(row(y), nx, c0, c1, f);
        load_plain(p, row(y), nx, c0, c1, dst + r * kPitch, 0, 1);
        bytes += bulk_bytes(p);
      }
      mbar_arrive(bar, bytes);
      for (int r = lane; r < yb - ya; r += 32) {
        const int y = ys ? ys[r] : ya + r;
        issue_bulk(plan_row(row(y), nx, c0, c1, f), dst + r * kPitch, bar);
      }
    };
    // the halo rows, read a second time (a frozen edge row needs none)
    const int hy[2] = {y0 > 0 ? y0 - 1 : -1, y1 < ny ? y1 : -1};
    int ys[2];
    int nh = 0;
    for (int h = 0; h < 2; ++h) {
      if (hy[h] >= 0) ys[nh++] = hy[h];
    }
    // a missing low halo row leaves its buffer row unused
    stage(0, nh, ys, halo_rows + (y0 > 0 ? 0 : kPitch), halo_bar);
    for (int64_t j = j0; j < j1; ++j) {
      wait_free(empty, j, j0);
      const int yb = static_cast<int>(j * rb);
      const int ye = yb + rb < ny ? yb + rb : ny;
      stage(yb, ye, nullptr, ring + slot_of(j, j0) * slot_bytes,
            &full[slot_of(j, j0)]);
    }
    return;
  }
  mbar_wait(halo_bar, 0);
  const int x = x0 + static_cast<int>(threadIdx.x);
  const int64_t k = x - c0;  // column x in a staged row
  auto srow = [&](const uint8_t* d, int y) { return staged(d, row(y), c0); };
  for (int64_t j = j0; j < j1; ++j) {
    mbar_wait(&full[slot_of(j, j0)], parity_of(j, j0));
    if (j + 1 < j1) mbar_wait(&full[slot_of(j + 1, j0)], parity_of(j + 1, j0));
    const int yb = static_cast<int>(j * rb);
    const int ye = yb + rb < ny ? yb + rb : ny;
    const uint8_t* cur = ring + slot_of(j, j0) * slot_bytes;
    if (x < nx) {
      // row yb - 1: the last row of block j - 1, or the low halo row
      const T* up = nullptr;
      if (j > j0) {
        up = srow(ring + slot_of(j - 1, j0) * slot_bytes + (rb - 1) * kPitch,
                  yb - 1);
      } else if (yb > 0) {
        up = srow(halo_rows, yb - 1);
      }
      const T* mid = srow(cur, yb);
      for (int y = yb; y < ye; ++y) {
        // row y + 1: in block j, the first row of block j + 1, or the high
        // halo row
        const T* down = nullptr;
        if (y + 1 < ye) {
          down = srow(cur + (y + 1 - yb) * kPitch, y + 1);
        } else if (j + 1 < j1) {
          down = srow(ring + slot_of(j + 1, j0) * slot_bytes, y + 1);
        } else if (y + 1 < ny) {
          down = srow(halo_rows + kPitch, y + 1);
        }
        float v;
        if (y == 0 || y == ny - 1 || x == 0 || x == nx - 1) {
          v = widen(mid[k]);
        } else {
          v = __fmul_rn(
              __fadd_rn(__fadd_rn(widen(up[k]), widen(down[k])),
                        __fadd_rn(widen(mid[k - 1]), widen(mid[k + 1]))),
              0.25f);
        }
        out[static_cast<int64_t>(y) * nx + x] = narrow<T>(v);
        up = mid;
        mid = down;
      }
    }
    hand_back(empty, j, j0);
  }
}

// The CTAs of `kernel` the card holds at once with `smem` bytes each.
template <typename K>
int resident_ctas(K kernel, int64_t smem, int* count) {
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, static_cast<size_t>(smem));
  }
  *count = sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

template <typename T>
int launch1d(const void* u, void* out, int64_t n, int rows,
             cudaStream_t stream) {
  auto kernel = jacobi1d_wave_kernel<T>;
  static const int opted = allow_smem(kernel);
  if (opted != 0) return opted;
  const int64_t block = static_cast<int64_t>(rows) * 128;
  const int64_t slot_bytes = staged_bytes(block, sizeof(T));
  const int64_t smem = kSlots * slot_bytes;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  int resident = 0;
  const int err = resident_ctas(kernel, smem, &resident);
  if (err != 0) return err;
  const int64_t nb = (n + block - 1) / block;
  const int64_t grid = nb < resident ? nb : resident;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<T*>(out), n, block, nb,
      slot_bytes);
  return cudaGetLastError();
}

template <typename T>
int launch2d(const void* u, void* out, int ny, int nx, int rb,
             cudaStream_t stream) {
  auto kernel = jacobi2d_wave_kernel<T>;
  static const int opted = allow_smem(kernel);
  if (opted != 0) return opted;
  const int64_t smem = (kSlots * static_cast<int64_t>(rb) + 2) * pitch2d<T>();
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  int resident = 0;
  const int err = resident_ctas(kernel, smem, &resident);
  if (err != 0) return err;
  const int strips = (nx + kStripX - 1) / kStripX;
  const int64_t nb = (ny + rb - 1) / rb;
  int64_t ranges = resident / strips;
  ranges = ranges < 1 ? 1 : (ranges > nb ? nb : ranges);
  const dim3 grid(strips, static_cast<unsigned>(ranges));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<T*>(out), ny, nx, rb);
  return cudaGetLastError();
}

}  // namespace

// C interface. Each launcher enqueues one kernel on `stream` and returns
// the launch's cudaError_t (0 = launched); cudaErrorInvalidValue for
// arguments the kernels do not take: periodic (the arm is dirichlet only)
// and a block whose ring exceeds shared memory among them.
extern "C" {

int tc_jacobi1d_wave(const void* u, void* out, int64_t n, int dtype,
                     int periodic, int rows_per_chunk, void* stream) {
  if (n < 3 || periodic || rows_per_chunk < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch1d<float>(u, out, n, rows_per_chunk, s);
    case kBFloat16:
      return launch1d<__nv_bfloat16>(u, out, n, rows_per_chunk, s);
    case kFloat16:
      return launch1d<__half>(u, out, n, rows_per_chunk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int tc_jacobi2d_wave(const void* u, void* out, int ny, int nx, int dtype,
                     int periodic, int rows, void* stream) {
  if (ny < 3 || nx < 3 || periodic || rows < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch2d<float>(u, out, ny, nx, rows, s);
    case kBFloat16:
      return launch2d<__nv_bfloat16>(u, out, ny, nx, rows, s);
    case kFloat16:
      return launch2d<__half>(u, out, ny, nx, rows, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
