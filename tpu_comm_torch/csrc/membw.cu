// Hand-written Hopper (sm_90a) kernels for the STREAM quartet (copy, scale,
// add, triad): the port of the four membw TPU kernels of
// tpu_comm/bench/membw.py.
//
// Built by tpu_comm_torch/kernels/_build.py with
//   nvcc -O3 -gencode=arch=compute_90a,code=sm_90a -fmad=false -shared
// into a shared library with a plain C interface, loaded with ctypes. No
// PyTorch header is included: the Python wrappers
// (tpu_comm_torch/kernels/membw.py) pass raw device pointers and the
// current CUDA stream, and raise on a non-zero return.
//
// Arrays are flat, N a multiple of 128 (the TPU kernels' (rows, 128) view);
// a chunk is `rows_per_chunk` rows of 128 elements and sets the grid, never
// the result.
//
// Numerical contract (shared with the plain PyTorch versions): copy moves
// bits. scale, add and triad widen to f32, compute with __fmul_rn/__fadd_rn
// (never contracted into an FMA; the build also has -fmad=false), and
// narrow once with round-to-nearest-even:
//   scale  x * s          add  x + b          triad  b + (x * s)
// The scalar s is first narrowed to the field dtype and widened again, as
// the TPU bodies' s.astype(x.dtype) does.
//
// What bounds all four on this card: memory. Each moves TRAFFIC[op] * N *
// itemsize bytes (2 for copy and scale, 3 for add and triad) and does at
// most two operations per element, so at N = 2^26 float32 the least time is
// 536,870,912 B / 3.35 TB/s = 0.1603 ms (copy, scale) and 805,306,368 B /
// 3.35 TB/s = 0.2404 ms (add, triad). The designs below keep many bytes in
// flight per SM and touch every byte once.

#include <cstring>

// the dtype codes, widen/narrow, and the mbarrier and TMA bulk-copy
// primitives (shared with grid.cu and wave.cu)
#include "staging.cuh"

namespace {

// op codes shared with tpu_comm_torch/kernels/membw.py OP_CODES
constexpr int kCopy = 0;
constexpr int kScale = 1;
constexpr int kAdd = 2;
constexpr int kTriad = 3;

constexpr int64_t kLanes = 128;
constexpr int kThreads = 256;
// 16-byte vectors a thread of the chunked kernels loads before it stores
constexpr int kBatch = 4;

template <typename T, int kOp>
__device__ __forceinline__ T apply(T x, T b, float s) {
  if constexpr (kOp == kScale) {
    return narrow<T>(__fmul_rn(widen(x), s));
  } else if constexpr (kOp == kAdd) {
    return narrow<T>(__fadd_rn(widen(x), widen(b)));
  } else {
    return narrow<T>(__fadd_rn(widen(b), __fmul_rn(widen(x), s)));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// chunked: replaces tpu_comm/bench/membw.py _membw_kernel1 (copy, scale) and
// _membw_kernel2 (add, triad), run by _pallas_once.
//
// One CUDA block per chunk (the counterpart of one BlockSpec grid step);
// each of its 256 threads walks the chunk 16 bytes at a time, neighbouring
// threads on neighbouring addresses, so every load and store is a full,
// coalesced 128-bit access. Where a pointer is not 16-byte aligned (an
// offset view) the same walk runs one element at a time. `out` may be `x`
// (the aliased knob, input_output_aliases on the TPU): each element is read
// by the thread that writes it, before it writes it, so no pointer here is
// __restrict__ and no load takes the non-coherent path. Without it the
// compiler keeps each store before the next load, so a thread loads kBatch
// vectors of each operand first to keep that many in flight.
//
// What sets their speed on this card is the chunk: a fixed number of bytes
// of each operand a CTA, the same in every dtype (kernels/membw.py
// CHUNKED_DEFAULT_CHUNK_BYTES): 8 KiB for copy, 4 KiB for scale, add and
// triad, two and one vectors a thread. The first form took a fixed 32
// rows a CTA (16 KiB in float32, 8 KiB in bfloat16). Measured on an
// H100 and not kept, as none paid beyond the spreads (PERF.md §6):
// __restrict__ pointers with non-coherent loads out of place and separate
// in-place forms, non-coherent loads, batches of 2 and 8, evict-first
// loads (slower alone), streaming stores, both, and an L2 evict-first
// policy.
// ---------------------------------------------------------------------------
template <typename T, int kOp, bool kVec>
__device__ __forceinline__ void chunk_pass(const T* x, const T* b, T* out,
                                           float s, int64_t n,
                                           int64_t per_block) {
  const float sv = widen(narrow<T>(s));
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t end = begin + per_block < n ? begin + per_block : n;
  if constexpr (kVec) {
    constexpr int kW = 16 / sizeof(T);
    constexpr int64_t kStep = static_cast<int64_t>(kThreads) * kW;
    for (int64_t i0 = begin + threadIdx.x * kW; i0 < end;
         i0 += kStep * kBatch) {
      // all of a batch's loads are issued before its first store
      uint4 xr[kBatch];
      uint4 br[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int64_t i = i0 + u * kStep;
        if (i < end) {
          xr[u] = *reinterpret_cast<const uint4*>(x + i);
          br[u] = xr[u];  // scale reads no second operand
          if constexpr (kOp == kAdd || kOp == kTriad) {
            br[u] = *reinterpret_cast<const uint4*>(b + i);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int64_t i = i0 + u * kStep;
        if (i >= end) break;
        uint4 orr = xr[u];
        if constexpr (kOp != kCopy) {
          T xv[kW];
          T bv[kW];
          T ov[kW];
          memcpy(xv, &xr[u], 16);
          memcpy(bv, &br[u], 16);
#pragma unroll
          for (int k = 0; k < kW; ++k) {
            ov[k] = apply<T, kOp>(xv[k], bv[k], sv);
          }
          memcpy(&orr, ov, 16);
        }
        *reinterpret_cast<uint4*>(out + i) = orr;
      }
    }
  } else {
    for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
      if constexpr (kOp == kCopy) {
        out[i] = x[i];
      } else if constexpr (kOp == kScale) {
        out[i] = apply<T, kOp>(x[i], x[i], sv);
      } else {
        out[i] = apply<T, kOp>(x[i], b[i], sv);
      }
    }
  }
}

template <typename T, int kOp, bool kVec>
__global__ void __launch_bounds__(kThreads)
    membw_unary(const T* x, T* out, float s, int64_t n, int64_t per_block) {
  chunk_pass<T, kOp, kVec>(x, nullptr, out, s, n, per_block);
}

template <typename T, int kOp, bool kVec>
__global__ void __launch_bounds__(kThreads)
    membw_binary(const T* x, const T* b, T* out, float s, int64_t n,
                 int64_t per_block) {
  chunk_pass<T, kOp, kVec>(x, b, out, s, n, per_block);
}

unsigned grid_for(int64_t n, int64_t per_block) {
  const int64_t blocks = (n + per_block - 1) / per_block;
  return static_cast<unsigned>(blocks < 0x7fffffff ? blocks : 0x7fffffff);
}

template <typename T, int kOp>
void launch_op(const T* x, const T* b, T* out, float s, int64_t n,
               int64_t per_block, bool vec, cudaStream_t st) {
  const unsigned blocks = grid_for(n, per_block);
  if constexpr (kOp == kCopy || kOp == kScale) {
    if (vec) {
      membw_unary<T, kOp, true><<<blocks, kThreads, 0, st>>>(x, out, s, n,
                                                             per_block);
    } else {
      membw_unary<T, kOp, false><<<blocks, kThreads, 0, st>>>(x, out, s, n,
                                                              per_block);
    }
  } else {
    if (vec) {
      membw_binary<T, kOp, true><<<blocks, kThreads, 0, st>>>(x, b, out, s, n,
                                                              per_block);
    } else {
      membw_binary<T, kOp, false><<<blocks, kThreads, 0, st>>>(x, b, out, s,
                                                               n, per_block);
    }
  }
}

template <typename T>
void launch_chunked(const void* x, const void* b, void* out, int64_t n,
                    int op, float s, int rows, cudaStream_t st) {
  const int64_t per_block = static_cast<int64_t>(rows) * kLanes;
  const bool binary = op == kAdd || op == kTriad;
  const bool vec = aligned16(x) && aligned16(out) && (!binary || aligned16(b));
  auto* xs = static_cast<const T*>(x);
  auto* bs = static_cast<const T*>(b);
  auto* os = static_cast<T*>(out);
  switch (op) {
    case kCopy:
      launch_op<T, kCopy>(xs, bs, os, s, n, per_block, vec, st);
      break;
    case kScale:
      launch_op<T, kScale>(xs, bs, os, s, n, per_block, vec, st);
      break;
    case kAdd:
      launch_op<T, kAdd>(xs, bs, os, s, n, per_block, vec, st);
      break;
    default:
      launch_op<T, kTriad>(xs, bs, os, s, n, per_block, vec, st);
      break;
  }
}

// ---------------------------------------------------------------------------
// stream: replaces tpu_comm/bench/membw.py _stream_copy_kernel, run by
// _stream_once: the copy expressed as a degenerate stencil, so that copy
// and stencil compare on the same pipeline code.
//
// Every cell still reads both of its neighbours, as the 1D stencil does
// (the TPU kernel's neighbour fetches are DMAs driven by its BlockSpecs and
// cannot be removed), and folds them into the stored bits under `keep`, a
// mask the launcher always passes as 0: the compiler cannot know it, so
// the loads stay (chip_smoke.py counts them in the machine code), and the
// stored value is u[i] bit for bit.
//
// What bounds it: bytes, 2 N itemsize (536,870,912 B at N = 2^26 float32:
// 0.1603 ms at 3.35 TB/s). The first form (one cell a thread an iteration, three 4-byte loads,
// no __restrict__, so each store was kept ahead of the next cell's loads:
// one cell's loads in flight a thread) took 0.2303 ms on an H100, 1.29
// times copy_.
// This design keeps many bytes in flight a thread:
//   - vector form (both pointers 16-byte aligned): a thread takes 16-byte
//     vectors and issues kBatch of them before its first store, as
//     chunk_pass does. A warp holds runs of 32 consecutive vectors. Inside
//     a vector a cell's neighbours are the vector's own cells; the
//     vector's two outer neighbours come from the lanes beside it
//     (__shfl_up_sync / __shfl_down_sync, the lane roll of the carry form
//     in jacobi_stream.cu), and only at a run's two edges (lane 0's
//     previous cell, the last lane's next) are they loaded from memory,
//     wrapped at the ends, together with the vectors. Cells are handled
//     as 32-bit words: in 2-byte dtypes a word holds two cells and its
//     neighbour words are funnel shifts of the words beside it;
//   - scalar form (an offset view off the 16-byte grid): kCells cells a
//     thread, each cell's three loads issued before the first store;
//   - out != u: __restrict__ pointers and non-coherent loads
//     (membw_stream). In place (the aliased knob, u == out): neither
//     (membw_stream_inplace): a neighbour load may race another thread's
//     store, value-safe only because that store writes the bits already
//     there.
// The copy moves bits, so the kernels are instantiated on the cell's
// width (uint32_t for float32, uint16_t for bfloat16 and float16). A CTA
// takes one chunk of rows_per_chunk rows of 128 cells: the chunk sets the
// grid, never the result.
// ---------------------------------------------------------------------------
// cells a thread of the scalar form loads before it stores
constexpr int kCells = 4;

template <bool kNc, typename B>
__device__ __forceinline__ B ld(const B* p) {
  if constexpr (kNc) {
    return __ldg(p);
  } else {
    return *p;
  }
}

template <typename B, bool kVec, bool kNc>
__device__ __forceinline__ void stream_pass(const B* u, B* out, int64_t n,
                                            uint32_t keep,
                                            int64_t per_block) {
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t end = begin + per_block < n ? begin + per_block : n;
  if constexpr (kVec) {
    constexpr int kW = 16 / sizeof(B);  // cells a vector
    constexpr int64_t kStep = static_cast<int64_t>(kThreads) * kW;
    const uint32_t mask = sizeof(B) == 4 ? keep : (keep & 0xffffu) * 0x10001u;
    const int lane = threadIdx.x % 32;
    // the loop bound is the same for a warp's lanes, so the warp stays
    // whole for the shuffles
    for (int64_t w0 = begin + static_cast<int64_t>(threadIdx.x - lane) * kW;
         w0 < end; w0 += kStep * kBatch) {
      uint4 v[kBatch];
      uint32_t prev_cell[kBatch];
      uint32_t next_cell[kBatch];
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int64_t i = w0 + r * kStep + lane * kW;
        v[r] = make_uint4(0u, 0u, 0u, 0u);
        prev_cell[r] = 0u;
        next_cell[r] = 0u;
        if (i < end) {
          v[r] = ld<kNc>(reinterpret_cast<const uint4*>(u + i));
          // the run's edges: from memory, wrapped at the ends
          if (lane == 0) prev_cell[r] = ld<kNc>(u + (i == 0 ? n - 1 : i - 1));
          if (lane == 31 || i + kW >= end) {
            next_cell[r] = ld<kNc>(u + (i + kW == n ? 0 : i + kW));
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int64_t i = w0 + r * kStep + lane * kW;
        // w[0] the word before the vector, w[1..4] its words, w[5] the
        // word after; only the cell beside the vector is read of each
        uint32_t w[6] = {0u, v[r].x, v[r].y, v[r].z, v[r].w, 0u};
        w[0] = __shfl_up_sync(0xffffffffu, w[4], 1);
        w[5] = __shfl_down_sync(0xffffffffu, w[1], 1);
        if (i >= end) continue;
        if (lane == 0) {
          w[0] = sizeof(B) == 4 ? prev_cell[r] : prev_cell[r] << 16;
        }
        if (lane == 31 || i + kW >= end) w[5] = next_cell[r];
        uint32_t o[4];
#pragma unroll
        for (int j = 1; j <= 4; ++j) {
          uint32_t nb;
          if constexpr (sizeof(B) == 4) {
            nb = w[j - 1] ^ w[j + 1];
          } else {
            // the words of the cells' left and right neighbours
            nb = __funnelshift_r(w[j - 1], w[j], 16) ^
                 __funnelshift_r(w[j], w[j + 1], 16);
          }
          o[j - 1] = w[j] ^ (nb & mask);
        }
        *reinterpret_cast<uint4*>(out + i) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  } else {
    const B mask = static_cast<B>(keep);
    for (int64_t i0 = begin + threadIdx.x; i0 < end;
         i0 += static_cast<int64_t>(kThreads) * kCells) {
      B self[kCells];
      B prev[kCells];
      B next[kCells];
#pragma unroll
      for (int r = 0; r < kCells; ++r) {
        const int64_t i = i0 + r * kThreads;
        if (i < end) {
          self[r] = ld<kNc>(u + i);
          prev[r] = ld<kNc>(u + (i == 0 ? n - 1 : i - 1));
          next[r] = ld<kNc>(u + (i == n - 1 ? 0 : i + 1));
        }
      }
#pragma unroll
      for (int r = 0; r < kCells; ++r) {
        const int64_t i = i0 + r * kThreads;
        if (i < end) out[i] = self[r] ^ ((prev[r] ^ next[r]) & mask);
      }
    }
  }
}

template <typename B, bool kVec>
__global__ void __launch_bounds__(kThreads)
    membw_stream(const B* __restrict__ u, B* __restrict__ out, int64_t n,
                 uint32_t keep, int64_t per_block) {
  stream_pass<B, kVec, true>(u, out, n, keep, per_block);
}

template <typename B, bool kVec>
__global__ void __launch_bounds__(kThreads)
    membw_stream_inplace(const B* u, B* out, int64_t n, uint32_t keep,
                         int64_t per_block) {
  stream_pass<B, kVec, false>(u, out, n, keep, per_block);
}

template <typename B>
void launch_stream(const void* u, void* out, int64_t n, int rows,
                   cudaStream_t st) {
  const int64_t per_block = static_cast<int64_t>(rows) * kLanes;
  const unsigned blocks = grid_for(n, per_block);
  auto* us = static_cast<const B*>(u);
  auto* os = static_cast<B*>(out);
  const bool vec = aligned16(u) && aligned16(out);
  if (u == out) {
    if (vec) {
      membw_stream_inplace<B, true><<<blocks, kThreads, 0, st>>>(
          us, os, n, 0u, per_block);
    } else {
      membw_stream_inplace<B, false><<<blocks, kThreads, 0, st>>>(
          us, os, n, 0u, per_block);
    }
  } else if (vec) {
    membw_stream<B, true><<<blocks, kThreads, 0, st>>>(us, os, n, 0u,
                                                       per_block);
  } else {
    membw_stream<B, false><<<blocks, kThreads, 0, st>>>(us, os, n, 0u,
                                                        per_block);
  }
}

// ---------------------------------------------------------------------------
// dma: replaces tpu_comm/bench/membw.py _dma_copy_kernel, run by
// _dma_copy_once: the copy pipelined by hand through `depth` buffer slots.
//
// Every byte moves device memory -> a shared-memory slot (a TMA bulk copy,
// cp.async.bulk global -> shared, completing on the slot's `full`
// mbarrier) -> device memory (a bulk store, shared -> global, in its own
// bulk group), through a ring of `depth` slots a CTA.
//
// What bounds it: bytes, 2 N itemsize (536,870,912 B at N = 2^26 float32:
// 0.1603 ms at 3.35 TB/s). The first form drove the ring from one thread, which waited for chunk
// k's load, issued its store, waited for chunk k-1's store to read its
// slot and only then refilled that slot: at depth 2 at most one load was
// in flight a CTA, with a gap at each turn of the ring (0.1940 ms on an
// H100, 1.08 times copy_). This design decouples the two sides:
//   - a producer lane (warp 0) issues a slot's load as soon as the slot is
//     free (its `empty` mbarrier), so up to `depth` loads are in flight;
//   - a consumer lane (warp 1) waits on `full`, issues the store, waits
//     until that store has READ the slot (cp.async.bulk.wait_group.read:
//     the race the TPU kernel's docstring guards against) and frees it on
//     `empty`. Neither side blocks a load behind a store or a store
//     behind a load of another slot.
// Chunks go to CTAs in turn (CTA b takes chunks b, b + grid, ...), so
// CTAs differ by at most one chunk and the last chunks spread over the
// SMs. The wrapper's launch plan (kernels/membw.py dma_plan) sets the
// grid: as many CTAs as the ring's shared memory lets reside at once.
// Measured on an H100 against this form and not kept (PERF.md §6):
// contiguous ranges a CTA (slower by 4-11%), L2 evict-first hints, a
// prefetch to L2 one ring ahead (35% slower), a slot freed one store
// later, a chunk moved by four bulk copies, pieces sized so every CTA
// takes as many, fewer CTAs an SM. What is left against copy_ is a fixed
// ~3 us a launch (the ring's fill and drain) and ~3.6% of rate.
// Bulk copies need 16-byte aligned addresses and sizes that are multiples
// of 16 B: a chunk is rows x 256 B or more, and misaligned pointers are
// refused.
// ---------------------------------------------------------------------------
constexpr int kMaxDepth = 8;
constexpr int kDmaThreads = 64;

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kDmaThreads)
    membw_dma(const uint8_t* x, uint8_t* out, int64_t nbytes,
              int64_t chunk_bytes, int64_t n_chunks, int depth) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t full[kMaxDepth];
  __shared__ __align__(8) uint64_t empty[kMaxDepth];
  if (threadIdx.x == 0) {
    for (int slot = 0; slot < depth; ++slot) {
      mbar_init(&full[slot], 1);
      mbar_init(&empty[slot], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  auto bytes_of = [&](int64_t c) {
    const int64_t left = nbytes - c * chunk_bytes;
    return static_cast<uint32_t>(left < chunk_bytes ? left : chunk_bytes);
  };
  // the CTA's k-th chunk, c = blockIdx.x + k * gridDim.x, goes into slot
  // k % depth: the (k / depth)-th phase of its barriers
  if (threadIdx.x == 0) {  // producer
    int64_t k = 0;
    for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x, ++k) {
      const int slot = static_cast<int>(k % depth);
      if (k >= depth) {  // the slot's previous chunk has been stored
        mbar_wait(&empty[slot], static_cast<uint32_t>((k / depth - 1) & 1));
      }
      const uint32_t bytes = bytes_of(c);
      mbar_arrive(&full[slot], bytes);
      bulk_load(ring + slot * chunk_bytes,
                reinterpret_cast<uintptr_t>(x + c * chunk_bytes), bytes,
                &full[slot]);
    }
  } else if (threadIdx.x == 32) {  // consumer
    int64_t k = 0;
    for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x, ++k) {
      const int slot = static_cast<int>(k % depth);
      mbar_wait(&full[slot], static_cast<uint32_t>((k / depth) & 1));
      bulk_store(out + c * chunk_bytes, ring + slot * chunk_bytes,
                 bytes_of(c));
      // the store has read the slot: it may be refilled
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      mbar_arrive(&empty[slot], 0);
    }
    // every store complete before the CTA's shared memory is freed
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

int itemsize_of(int dtype) {
  switch (dtype) {
    case kFloat32:
      return 4;
    case kBFloat16:
    case kFloat16:
      return 2;
    default:
      return 0;
  }
}

}  // namespace

// C interface. Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 = launched), so a refused launch is reported to
// the wrapper instead of vanishing; cudaErrorInvalidValue for arguments
// the kernels do not take.
extern "C" {

int tc_membw_chunked(const void* x, const void* b, void* out, int64_t n,
                     int dtype, int op, float s, int rows_per_chunk,
                     void* stream) {
  if (n < kLanes || n % kLanes != 0 || rows_per_chunk < 1 || op < kCopy ||
      op > kTriad || ((op == kAdd || op == kTriad) && b == nullptr)) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      launch_chunked<float>(x, b, out, n, op, s, rows_per_chunk, st);
      break;
    case kBFloat16:
      launch_chunked<__nv_bfloat16>(x, b, out, n, op, s, rows_per_chunk, st);
      break;
    case kFloat16:
      launch_chunked<__half>(x, b, out, n, op, s, rows_per_chunk, st);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int tc_membw_stream(const void* x, void* out, int64_t n, int dtype,
                    int rows_per_chunk, void* stream) {
  const int itemsize = itemsize_of(dtype);
  if (itemsize == 0 || n < kLanes || n % kLanes != 0 || rows_per_chunk < 1) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  if (itemsize == 4) {
    launch_stream<uint32_t>(x, out, n, rows_per_chunk, st);
  } else {
    launch_stream<uint16_t>(x, out, n, rows_per_chunk, st);
  }
  return cudaGetLastError();
}

int tc_membw_dma(const void* x, void* out, int64_t n, int dtype,
                 int rows_per_chunk, int depth, int ctas, void* stream) {
  const int itemsize = itemsize_of(dtype);
  if (itemsize == 0 || n < kLanes || n % kLanes != 0 || rows_per_chunk < 1 ||
      depth < 2 || depth > kMaxDepth || ctas < 1) {
    return cudaErrorInvalidValue;
  }
  if (!aligned16(x) || !aligned16(out)) return cudaErrorMisalignedAddress;
  const int64_t chunk_bytes =
      static_cast<int64_t>(rows_per_chunk) * kLanes * itemsize;
  const int64_t ring_bytes = chunk_bytes * depth;
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  if (ring_bytes + static_cast<int64_t>(2 * sizeof(uint64_t)) * kMaxDepth >
      optin) {
    return cudaErrorInvalidValue;
  }
  const int smem = static_cast<int>(ring_bytes);
  err = cudaFuncSetAttribute(membw_dma,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t nbytes = n * itemsize;
  membw_dma<<<ctas, kDmaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), nbytes,
      chunk_bytes, (nbytes + chunk_bytes - 1) / chunk_bytes, depth);
  return cudaGetLastError();
}

const char* tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
