// Hand-written Hopper (sm_90a) kernels for one Jacobi step of the 1D and 2D
// star and of the 9-point and 27-point box as ring-buffered block streams:
// the port of the TPU `pallas-wave` kernels
//   tpu_comm/kernels/jacobi1d.py _jacobi1d_wave_kernel (step_pallas_wave)
//   tpu_comm/kernels/jacobi2d.py _jacobi2d_wave_kernel (step_pallas_wave)
//   tpu_comm/kernels/stencil9.py _stencil9_wave_kernel (step_pallas_wave)
//   tpu_comm/kernels/stencil27.py _stencil27_wave_kernel (step_pallas_wave)
// Dirichlet only, as the TPU arm: the launchers refuse periodic. And the
// ghost-fed forms of the 1D and 2D star, the mesh arm's local update
//   tpu_comm/kernels/jacobi1d.py _jacobi1d_wave_ghost_kernel
//                                (step_pallas_wave_ghost)
//   tpu_comm/kernels/jacobi2d.py _jacobi2d_wave_ghost_kernel
//                                (step_pallas_wave_ghost)
// which take a rank's block and its exchanged ghost cells and freeze
// nothing: the caller applies the boundary condition.
//
// Built by tpu_comm_torch/kernels/_build.py with
//   nvcc -O3 -gencode=arch=compute_90a,code=sm_90a -fmad=false -shared
// into a shared library with a plain C interface, loaded with ctypes. No
// PyTorch header is included: the Python wrappers pass raw device
// pointers and the current CUDA stream, and raise on a non-zero return.
//
// Numerical contract (shared with step_plain in kernels/jacobi1d.py,
// kernels/jacobi2d.py, kernels/stencil9.py and kernels/stencil27.py):
// every element is widened to f32 and
//   1D        (prev + next) * 0.5f
//   2D star   ((up + down) + (left + right)) * 0.25f
//   9-point   box8 * 0.125f, box8 = ((up + down) + (left + right))
//             + ((ul + dr) + (ur + dl))
//   27-point  ((full9(z-1) + full9(z+1)) + box8(z)) * (float)(1.0 / 26.0),
//             full9(p) = box8(p) + p (csrc/box.cu's association)
// is narrowed once, round-to-nearest-even; a cell on the boundary ring
// keeps its input value (the ghost-fed forms: the neighbours past the
// block's edges are its ghost cells, and every cell is computed).
// __fadd_rn/__fmul_rn are never contracted into an FMA, and -fmad=false
// guards the rest, so f32 results are bitwise equal to the golden.
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
// The ghost-fed forms change where a range's outer halo comes from when
// the range touches the block's end: from the ghost tensors instead of
// the field, and in 2D the strips at the block's sides read their outer
// column from the ghost columns (the TPU kernel's grid order, where the
// warmup step writes junk into out block 0 and the next step writes it
// again, has no counterpart: nothing is written twice). The ghost tensors
// are device memory that the exchange has just written on the
// communication stream; the kernel runs on the stream that the exchange's
// wait has ordered after it, and reads them through pointers.
// Each block crosses DRAM once; the re-reads are the two halo rows (or
// cells) per range and, in 2D, the halo columns (in L2 mostly: the
// neighbouring strip reads them as its own). The slots hold the field's
// dtype as the copies land it; widening on read is exact, so the values
// are an f32 ring's. The launcher sizes the grid to one wave of resident
// CTAs, which makes the ranges as long as the card allows.
//
// The 9-point box is the 2D strip ring with the box sum: the diagonals come
// from the same staged rows. The 27-point box cannot keep whole planes (an
// f32 plane at 512^2 is 1 MiB, a CTA has 227 KB of shared memory), so a
// CTA owns a tile of ty rows of a strip and streams a z range of it: a
// ring entry is one plane of the tile with a halo row above and below (and
// the strip's halo columns in every row), and the planes just outside the
// range are two more entries of the same stream, read once more. Its
// consumers take each plane's sums into registers at once, so a ring of
// kSlots27 entries keeps the producer two planes ahead.
//
// What bounds them on this card: memory, 2 * N * itemsize bytes a step.

#include "staging.cuh"

namespace {

// the computing threads: one column (2D) a thread; and one producer warp
constexpr int kConsumers = 256;
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;
// the ring's slots: blocks j - 1 and j, and up to kSlots - 2 ahead
constexpr int kSlots = 4;
// the 27-point ring's: its consumers hold one plane at a time, so the
// producer runs up to kSlots27 - 1 ahead
constexpr int kSlots27 = 3;
// the 2D strip's width
constexpr int kStripX = kConsumers;
// grid.y and grid.z are limited to 65535 blocks
constexpr int kMaxGrid = 65535;

// the ring slot of block j in a range that starts at block j0, and the
// parity of the slot's barrier phase that block j's fill (`full`) or
// hand-back (`empty`) completes, in a ring of kN slots
template <int kN = kSlots>
__device__ __forceinline__ int slot_of(int64_t j, int64_t j0) {
  return static_cast<int>((j - j0) % kN);
}
template <int kN = kSlots>
__device__ __forceinline__ uint32_t parity_of(int64_t j, int64_t j0) {
  return static_cast<uint32_t>(((j - j0) / kN) & 1);
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
// back the block kN earlier.
template <int kN = kSlots>
__device__ __forceinline__ void wait_free(uint64_t* empty, int64_t j,
                                          int64_t j0) {
  if (j - j0 >= kN) {
    mbar_wait(&empty[slot_of<kN>(j, j0)], parity_of<kN>(j - kN, j0));
  }
}

// ---------------------------------------------------------------------------
// 1D: a block is `block` consecutive cells; CTA b streams the blocks
// [nb * b / G, nb * (b + 1) / G). The producer's lane 0 copies each block
// (its lanes load the plain cells). kGhost: the field is a rank's block of
// a mesh, and the cells just outside its two ends are the exchanged ghost
// cells `lo` and `hi` (device pointers, one cell each); no cell is frozen.
// ---------------------------------------------------------------------------
template <typename T, bool kGhost>
__global__ void __launch_bounds__(kThreads)
    jacobi1d_wave_kernel(const T* __restrict__ u, T* __restrict__ out,
                         int64_t n, int64_t block, int64_t nb,
                         int64_t slot_bytes, const T* __restrict__ lo,
                         const T* __restrict__ hi) {
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
    // the cells just outside the range, read a second time; at an end of
    // the field a ghost cell, or none (a frozen end)
    halo[0] = j0 > 0 ? widen(u[j0 * block - 1])
                     : (kGhost ? widen(*lo) : 0.0f);
    halo[1] = j1 * block < n ? widen(u[j1 * block])
                             : (kGhost ? widen(*hi) : 0.0f);
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
    // unless ghost cells feed them
    const int len = static_cast<int>(c1 - c0);
    const int frozen_lo = !kGhost && c0 == 0 ? 0 : -1;
    const int frozen_hi = !kGhost && c1 == n ? len - 1 : -1;
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
// 2D star and 9-point box (kBox): a block is `rb` rows of a strip of
// kStripX columns; CTA (s, b) streams strip s's blocks
// [nb * b / G, nb * (b + 1) / G) (G = gridDim.y). A staged row holds the
// strip and its halo columns. Producer lane r stages the block's rows r,
// r + 32, ... and arrives once on the slot's barrier; consumer x computes
// column x of every row, the box's diagonals from columns x - 1 and x + 1
// of the rows above and below.
//
// kGhost (the star): the field is a rank's block of a mesh, fed by the four
// exchanged ghost lines (device pointers): `up` and `down` are the rows
// just above and below it (nx cells each), `left` and `right` the columns
// just left and right of it (ny cells each). The halo row of a range that
// starts at row 0 (ends at row ny - 1) is staged from `up` (`down`); the
// first strip's column 0 and the last strip's column nx - 1 read their
// outer neighbour from `left` (`right`) by a plain load. No cell is
// frozen: every cell is computed in f32 and narrowed once.
// ---------------------------------------------------------------------------
template <typename T>
__host__ __device__ constexpr int64_t pitch2d() {
  return staged_bytes(kStripX + 2, sizeof(T));
}

// the 8-neighbour sum of the golden (csrc/box.cu's box8)
__device__ __forceinline__ float box8(float up, float down, float left,
                                      float right, float ul, float ur,
                                      float dl, float dr) {
  return __fadd_rn(__fadd_rn(__fadd_rn(up, down), __fadd_rn(left, right)),
                   __fadd_rn(__fadd_rn(ul, dr), __fadd_rn(ur, dl)));
}

// the four ghost lines of a kGhost launch
template <typename T>
struct Ghosts2d {
  const T* up;
  const T* down;
  const T* left;
  const T* right;
};

template <typename T, bool kBox, bool kGhost>
__global__ void __launch_bounds__(kThreads)
    wave2d_kernel(const T* __restrict__ u, T* __restrict__ out, int ny,
                  int nx, int rb, Ghosts2d<T> g) {
  static_assert(!(kBox && kGhost), "the ghost-fed form is the star's");
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
  // the halo row above (below) the range: inside the field, a ghost row,
  // or none (a frozen edge row)
  const bool has_lo = y0 > 0 || kGhost;
  const bool has_hi = y1 < ny || kGhost;
  // row y of the field, or the ghost row y = -1 or y = ny
  auto row = [&](int y) {
    if (kGhost && y < 0) return g.up;
    if (kGhost && y >= ny) return g.down;
    return u + static_cast<int64_t>(y) * nx;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s <= kSlots; ++s) mbar_init(&full[s], 32);
    for (int s = 0; s < kSlots; ++s) mbar_init(&empty[s], kConsumerWarps);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {  // the producer warp
    const int lane = threadIdx.x - kConsumers;
    const Field f = field_of(u, static_cast<int64_t>(ny) * nx);
    // a row's bulk copy stays inside its own tensor
    auto field = [&](int y) {
      return kGhost && (y < 0 || y >= ny) ? field_of(row(y), nx) : f;
    };
    // stage the rows y of [ya, yb) with y % 32 == lane % 32 into `dst`
    // (row y at dst + (y - ya) * kPitch) on `bar`: plain loads and the
    // arrival first, then the copies
    auto stage = [&](int ya, int yb, const int* ys, uint8_t* dst,
                     uint64_t* bar) {
      uint32_t bytes = 0;
      for (int r = lane; r < yb - ya; r += 32) {
        const int y = ys ? ys[r] : ya + r;
        const RowPlan<T> p = plan_row(row(y), nx, c0, c1, field(y));
        load_plain(p, row(y), nx, c0, c1, dst + r * kPitch, 0, 1);
        bytes += bulk_bytes(p);
      }
      mbar_arrive(bar, bytes);
      for (int r = lane; r < yb - ya; r += 32) {
        const int y = ys ? ys[r] : ya + r;
        issue_bulk(plan_row(row(y), nx, c0, c1, field(y)), dst + r * kPitch,
                   bar);
      }
    };
    // the halo rows, read a second time
    int ys[2];
    int nh = 0;
    if (has_lo) ys[nh++] = y0 - 1;
    if (has_hi) ys[nh++] = y1;
    // a missing low halo row leaves its buffer row unused
    stage(0, nh, ys, halo_rows + (has_lo ? 0 : kPitch), halo_bar);
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
  // the column of the thread whose left (right) neighbour is a ghost cell
  const T* ghost_l = kGhost && x == 0 ? g.left : nullptr;
  const T* ghost_r = kGhost && x == nx - 1 ? g.right : nullptr;
  // field row y staged at d, and a halo row, which may be a ghost row
  auto srow = [&](const uint8_t* d, int y) {
    return staged(d, u + static_cast<int64_t>(y) * nx, c0);
  };
  auto shalo = [&](const uint8_t* d, int y) { return staged(d, row(y), c0); };
  for (int64_t j = j0; j < j1; ++j) {
    mbar_wait(&full[slot_of(j, j0)], parity_of(j, j0));
    if (j + 1 < j1) mbar_wait(&full[slot_of(j + 1, j0)], parity_of(j + 1, j0));
    const uint8_t* cur = ring + slot_of(j, j0) * slot_bytes;
    const int yb = static_cast<int>(j * rb);
    const int ye = yb + rb < ny ? yb + rb : ny;
    if (x < nx) {
      // row y - 1: the last row of block j - 1, or the low halo row
      const T* up = nullptr;
      if (j > j0) {
        up = srow(ring + slot_of(j - 1, j0) * slot_bytes + (rb - 1) * kPitch,
                  yb - 1);
      } else if (has_lo) {
        up = shalo(halo_rows, yb - 1);
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
        } else if (has_hi) {
          down = shalo(halo_rows + kPitch, y + 1);
        }
        float v;
        if (!kGhost && (y == 0 || y == ny - 1 || x == 0 || x == nx - 1)) {
          v = widen(mid[k]);
        } else if (kBox) {
          v = __fmul_rn(
              box8(widen(up[k]), widen(down[k]), widen(mid[k - 1]),
                   widen(mid[k + 1]), widen(up[k - 1]), widen(up[k + 1]),
                   widen(down[k - 1]), widen(down[k + 1])),
              0.125f);
        } else {
          const float left = ghost_l ? widen(ghost_l[y]) : widen(mid[k - 1]);
          const float right = ghost_r ? widen(ghost_r[y]) : widen(mid[k + 1]);
          v = __fmul_rn(__fadd_rn(__fadd_rn(widen(up[k]), widen(down[k])),
                                  __fadd_rn(left, right)),
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

// ---------------------------------------------------------------------------
// 27-point box: CTA (s, b, r) owns the tile of rows [b * ty, (b + 1) * ty)
// of strip s and the z range r of [nz * r / G, nz * (r + 1) / G)
// (G = gridDim.z). It streams the planes of its range and the one just
// outside each end, each as one ring entry: the tile's rows and a halo row
// above and below (buffer row y - y0 + 1 holds row y), staged as the 2D
// rows are. Consumer x owns column x of the tile's rows. When plane p
// lands it slides a 3 x 3 window down the entry (three shared loads a
// row), takes box8 and full9 = box8 + centre of each row once and hands
// the slot back at once; from the registers it keeps a row (full9 of
// p - 2, box8 and full9 of p - 1, the centre of p - 1) it emits plane
// p - 1:
//   out = ((full9(p - 2) + full9(p)) + box8(p - 1)) * inv26
// _accum27's association, each plane's sums taken once where the TPU
// kernel takes box8 of all three planes for every output plane. So the
// producer runs up to kSlots27 - 1 planes ahead. kRows bounds ty: the per-row
// registers are indexed at compile time. A frozen cell (the shell) emits
// its centre, so the rows and columns past the field's edge, read as
// whatever the buffer holds, never reach an output.
// ---------------------------------------------------------------------------
template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads)
    stencil27_wave_kernel(const T* __restrict__ u, T* __restrict__ out,
                          int nz, int ny, int nx, int ty) {
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ __align__(8) uint64_t full[kSlots27];
  __shared__ __align__(8) uint64_t empty[kSlots27];
  constexpr int64_t kPitch = pitch2d<T>();
  const float inv26 = static_cast<float>(1.0 / 26.0);
  const int64_t slot_bytes = (ty + 2) * kPitch;
  const int64_t plane = static_cast<int64_t>(ny) * nx;
  const int z0 = static_cast<int>(int64_t{nz} * blockIdx.z / gridDim.z);
  const int z1 = static_cast<int>(int64_t{nz} * (blockIdx.z + 1) / gridDim.z);
  // the planes streamed: the range and one more each side
  const int64_t pa = z0 > 0 ? z0 - 1 : 0;
  const int64_t pb = z1 < nz ? z1 + 1 : nz;
  const int y0 = blockIdx.y * ty;
  const int y1 = y0 + ty < ny ? y0 + ty : ny;
  const int x0 = blockIdx.x * kStripX;
  const int64_t c0 = x0 > 0 ? x0 - 1 : 0;
  const int64_t c1 = x0 + kStripX + 1 < nx ? x0 + kStripX + 1 : nx;
  auto entry = [&](int64_t p) {
    return ring + slot_of<kSlots27>(p, pa) * slot_bytes;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots27; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {  // the producer warp
    const int lane = threadIdx.x - kConsumers;
    const Field f = field_of(u, nz * plane);
    // the staged rows: the tile's and its halo rows inside the field
    const int ya = y0 > 0 ? y0 - 1 : 0;
    const int yb = y1 < ny ? y1 + 1 : ny;
    for (int64_t p = pa; p < pb; ++p) {
      wait_free<kSlots27>(empty, p, pa);
      uint8_t* dst = entry(p);
      uint64_t* bar = &full[slot_of<kSlots27>(p, pa)];
      uint32_t bytes = 0;
      for (int y = ya + lane; y < yb; y += 32) {
        const T* row = u + p * plane + static_cast<int64_t>(y) * nx;
        const RowPlan<T> pl = plan_row(row, nx, c0, c1, f);
        load_plain(pl, row, nx, c0, c1, dst + (y - y0 + 1) * kPitch, 0, 1);
        bytes += bulk_bytes(pl);
      }
      mbar_arrive(bar, bytes);
      for (int y = ya + lane; y < yb; y += 32) {
        const T* row = u + p * plane + static_cast<int64_t>(y) * nx;
        issue_bulk(plan_row(row, nx, c0, c1, f), dst + (y - y0 + 1) * kPitch,
                   bar);
      }
    }
    return;
  }
  const int x = x0 + static_cast<int>(threadIdx.x);
  const bool live = x < nx;
  const bool edge_col = x == 0 || x == nx - 1;
  const int rows = y1 - y0;
  // column x and its neighbours in a staged row (a frozen column reads
  // only its own)
  const int64_t k = x - c0;
  const int64_t kl = edge_col ? k : k - 1;
  const int64_t kr = edge_col ? k : k + 1;
  // a row's bytes in global memory: a staged row lies at its global
  // address modulo 16, which moves by this much a row
  const uintptr_t row_bytes = static_cast<uintptr_t>(nx) * sizeof(T);
  // the three cells around column x of the staged row at `srow`, whose
  // column c0 lies at global address `ga`
  auto cells = [&](const uint8_t* srow, uintptr_t ga, float (&w)[3]) {
    const T* r = reinterpret_cast<const T*>(srow + (ga & 15));
    w[0] = widen(r[kl]);
    w[1] = widen(r[k]);
    w[2] = widen(r[kr]);
  };
  // per tile row: full9 of plane p - 2, box8, full9 and the centre of p - 1
  float f9m[kRows];
  float b8c[kRows];
  float f9c[kRows];
  float cen[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) f9m[r] = b8c[r] = f9c[r] = cen[r] = 0.0f;
  for (int64_t p = pa; p < pb; ++p) {
    mbar_wait(&full[slot_of<kSlots27>(p, pa)], parity_of<kSlots27>(p, pa));
    const int64_t z = p - 1;  // the plane this one completes
    const bool emit = z >= z0 && z < z1;
    const bool face = z == 0 || z == nz - 1;
    if (live) {
      // buffer row 0 and the global address of its column c0: row y0 - 1
      const uint8_t* srow = entry(p);
      uintptr_t ga = reinterpret_cast<uintptr_t>(u) +
                     static_cast<uintptr_t>(
                         (p * plane + static_cast<int64_t>(y0 - 1) * nx + c0) *
                         static_cast<int64_t>(sizeof(T)));
      float a[3];  // rows y - 1, y and y + 1
      float c[3];
      float b[3];
      cells(srow, ga, a);
      cells(srow + kPitch, ga + row_bytes, c);
      srow += 2 * kPitch;
      ga += 2 * row_bytes;
      T* o = out + z * plane + static_cast<int64_t>(y0) * nx + x;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          cells(srow, ga, b);
          srow += kPitch;
          ga += row_bytes;
          const float b8 =
              box8(a[1], b[1], c[0], c[2], a[0], a[2], b[0], b[2]);
          const float f9 = __fadd_rn(b8, c[1]);
          if (emit) {
            const int y = y0 + r;
            const float v =
                (face || edge_col || y == 0 || y == ny - 1)
                    ? cen[r]
                    : __fmul_rn(__fadd_rn(__fadd_rn(f9m[r], f9), b8c[r]),
                                inv26);
            o[static_cast<int64_t>(r) * nx] = narrow<T>(v);
          }
          f9m[r] = f9c[r];
          b8c[r] = b8;
          f9c[r] = f9;
          cen[r] = c[1];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            a[i] = c[i];
            c[i] = b[i];
          }
        }
      }
    }
    // plane p is done with: each consumer warp hands its slot back
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[slot_of<kSlots27>(p, pa)], 0);
  }
  // the field's last plane, a frozen face, has no plane after it
  if (live && z1 == nz) {
    T* o = out + (nz - 1) * plane + static_cast<int64_t>(y0) * nx + x;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) o[static_cast<int64_t>(r) * nx] = narrow<T>(cen[r]);
    }
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

template <typename T, bool kGhost>
int launch1d(const void* u, void* out, int64_t n, int rows, const void* lo,
             const void* hi, cudaStream_t stream) {
  auto kernel = jacobi1d_wave_kernel<T, kGhost>;
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
      slot_bytes, static_cast<const T*>(lo), static_cast<const T*>(hi));
  return cudaGetLastError();
}

template <typename T, bool kBox, bool kGhost>
int launch2d(const void* u, void* out, int ny, int nx, int rb,
             const void* const* ghosts, cudaStream_t stream) {
  auto kernel = wave2d_kernel<T, kBox, kGhost>;
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
  Ghosts2d<T> g{};
  if (kGhost) {
    g = {static_cast<const T*>(ghosts[0]), static_cast<const T*>(ghosts[1]),
         static_cast<const T*>(ghosts[2]), static_cast<const T*>(ghosts[3])};
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<T*>(out), ny, nx, rb, g);
  return cudaGetLastError();
}

template <typename T, int kRows>
int launch27_rows(const void* u, void* out, int nz, int ny, int nx, int ty,
                  cudaStream_t stream) {
  auto kernel = stencil27_wave_kernel<T, kRows>;
  static const int opted = allow_smem(kernel);
  if (opted != 0) return opted;
  const int64_t smem =
      kSlots27 * (static_cast<int64_t>(ty) + 2) * pitch2d<T>();
  const int64_t tiles = (ny + static_cast<int64_t>(ty) - 1) / ty;
  if (smem > kMaxSmem || tiles > kMaxGrid) return cudaErrorInvalidValue;
  int resident = 0;
  const int err = resident_ctas(kernel, smem, &resident);
  if (err != 0) return err;
  const int strips = (nx + kStripX - 1) / kStripX;
  // z ranges: as many as two waves of resident CTAs leave room for (one
  // wave leaves SMs idle where the tiles do not divide it)
  int64_t ranges = 2 * resident / (strips * tiles);
  const int64_t most = nz < kMaxGrid ? nz : kMaxGrid;
  ranges = ranges < 1 ? 1 : (ranges > most ? most : ranges);
  const dim3 grid(strips, static_cast<unsigned>(tiles),
                  static_cast<unsigned>(ranges));
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(u),
                                           static_cast<T*>(out), nz, ny, nx,
                                           ty);
  return cudaGetLastError();
}

// the most tile rows of the 27-point wave (tiling.py WAVE3D_MAX_ROWS)
constexpr int kMaxRows27 = 16;

template <typename T>
int launch27(const void* u, void* out, int nz, int ny, int nx, int ty,
             cudaStream_t stream) {
  if (ty <= 8) return launch27_rows<T, 8>(u, out, nz, ny, nx, ty, stream);
  if (ty <= kMaxRows27) {
    return launch27_rows<T, kMaxRows27>(u, out, nz, ny, nx, ty, stream);
  }
  return cudaErrorInvalidValue;
}

// `ghosts`: up, down, left, right of a kGhost launch
template <bool kBox, bool kGhost>
int wave2d(const void* u, void* out, int ny, int nx, int dtype, int rows,
           const void* const* ghosts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch2d<float, kBox, kGhost>(u, out, ny, nx, rows, ghosts, s);
    case kBFloat16:
      return launch2d<__nv_bfloat16, kBox, kGhost>(u, out, ny, nx, rows,
                                                   ghosts, s);
    case kFloat16:
      return launch2d<__half, kBox, kGhost>(u, out, ny, nx, rows, ghosts, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kGhost>
int wave1d(const void* u, void* out, int64_t n, int dtype, int rows,
           const void* lo, const void* hi, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch1d<float, kGhost>(u, out, n, rows, lo, hi, s);
    case kBFloat16:
      return launch1d<__nv_bfloat16, kGhost>(u, out, n, rows, lo, hi, s);
    case kFloat16:
      return launch1d<__half, kGhost>(u, out, n, rows, lo, hi, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface. Each launcher enqueues one kernel on `stream` and returns
// the launch's cudaError_t (0 = launched); cudaErrorInvalidValue for
// arguments the kernels do not take: periodic (the single-device arm is
// dirichlet only), a missing ghost and a block whose ring exceeds shared
// memory among them.
extern "C" {

int tc_jacobi1d_wave(const void* u, void* out, int64_t n, int dtype,
                     int periodic, int rows_per_chunk, void* stream) {
  if (n < 3 || periodic || rows_per_chunk < 1) return cudaErrorInvalidValue;
  return wave1d<false>(u, out, n, dtype, rows_per_chunk, nullptr, nullptr,
                       stream);
}

// One step of a rank's 1D block of n >= 1 cells fed by its ghost cells
// `lo` and `hi` (one cell each, of the block's dtype, on its device).
int tc_jacobi1d_wave_ghost(const void* u, void* out, const void* lo,
                           const void* hi, int64_t n, int dtype,
                           int rows_per_chunk, void* stream) {
  if (n < 1 || rows_per_chunk < 1 || !lo || !hi) {
    return cudaErrorInvalidValue;
  }
  return wave1d<true>(u, out, n, dtype, rows_per_chunk, lo, hi, stream);
}

int tc_jacobi2d_wave(const void* u, void* out, int ny, int nx, int dtype,
                     int periodic, int rows, void* stream) {
  if (ny < 3 || nx < 3 || periodic || rows < 1) return cudaErrorInvalidValue;
  return wave2d<false, false>(u, out, ny, nx, dtype, rows, nullptr, stream);
}

// One star step of a rank's (ny, nx) block fed by its four ghost lines:
// the rows `up` and `down` (nx cells each) and the columns `left` and
// `right` (ny cells each), contiguous, of the block's dtype, on its device.
int tc_jacobi2d_wave_ghost(const void* u, void* out, const void* up,
                           const void* down, const void* left,
                           const void* right, int ny, int nx, int dtype,
                           int rows, void* stream) {
  if (ny < 1 || nx < 1 || rows < 1 || !up || !down || !left || !right) {
    return cudaErrorInvalidValue;
  }
  const void* ghosts[4] = {up, down, left, right};
  return wave2d<false, true>(u, out, ny, nx, dtype, rows, ghosts, stream);
}

int tc_stencil9_wave(const void* u, void* out, int ny, int nx, int dtype,
                     int periodic, int rows, void* stream) {
  if (ny < 3 || nx < 3 || periodic || rows < 1) return cudaErrorInvalidValue;
  return wave2d<true, false>(u, out, ny, nx, dtype, rows, nullptr, stream);
}

int tc_stencil27_wave(const void* u, void* out, int nz, int ny, int nx,
                      int dtype, int periodic, int rows, void* stream) {
  if (nz < 2 || ny < 3 || nx < 3 || periodic || rows < 1) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch27<float>(u, out, nz, ny, nx, rows, s);
    case kBFloat16:
      return launch27<__nv_bfloat16>(u, out, nz, ny, nx, rows, s);
    case kFloat16:
      return launch27<__half>(u, out, nz, ny, nx, rows, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
