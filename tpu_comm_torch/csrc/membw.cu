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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

// dtype codes shared with tpu_comm_torch/kernels/tiling.py
// KERNEL_DTYPE_CODES
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;
constexpr int kFloat16 = 2;
// op codes shared with tpu_comm_torch/kernels/membw.py OP_CODES
constexpr int kCopy = 0;
constexpr int kScale = 1;
constexpr int kAdd = 2;
constexpr int kTriad = 3;

constexpr int64_t kLanes = 128;
constexpr int kThreads = 256;
// 16-byte vectors a thread of the chunked kernels loads before it stores
constexpr int kBatch = 4;

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
// __restrict__. Without it the compiler keeps each store before the next
// load, so a thread loads kBatch vectors first to keep that many in
// flight: the loads a copy needs to fill DRAM's pipe.
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
// This is the port's own 1D stencil kernel (jacobi1d_kernel in
// jacobi_stream.cu) with the arithmetic removed: the same 256 threads, the
// same grid derived from the chunk, the same grid-stride loop, the same
// loads of u[i-1] and u[i+1] (wrapped at the ends), and out[i] = u[i].
//
// The TPU kernel's neighbour fetches are DMAs driven by its BlockSpecs and
// cannot be removed; a load whose value is unused here would be deleted by
// the compiler. So both neighbour values are folded into the stored bits
// under `keep`, a mask the launcher always passes as 0: the compiler cannot
// know it, so both loads stay, and the stored value is u[i] bit for bit.
// ---------------------------------------------------------------------------
template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using type = uint32_t;
};
template <>
struct Bits<__nv_bfloat16> {
  using type = uint16_t;
};
template <>
struct Bits<__half> {
  using type = uint16_t;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    membw_stream(const T* u, T* out, int64_t n, uint32_t keep) {
  using B = typename Bits<T>::type;
  const B* ub = reinterpret_cast<const B*>(u);
  B* ob = reinterpret_cast<B*>(out);
  const B mask = static_cast<B>(keep);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int64_t ip = (i == 0) ? n - 1 : i - 1;
    const int64_t in = (i == n - 1) ? 0 : i + 1;
    ob[i] = ub[i] ^ ((ub[ip] ^ ub[in]) & mask);
  }
}

template <typename T>
void launch_stream(const void* u, void* out, int64_t n, int rows,
                   cudaStream_t st) {
  // launch1d's grid in jacobi_stream.cu
  const unsigned blocks = grid_for(n, static_cast<int64_t>(rows) * kLanes);
  membw_stream<T><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(u), static_cast<T*>(out), n, 0u);
}

// ---------------------------------------------------------------------------
// dma: replaces tpu_comm/bench/membw.py _dma_copy_kernel, run by
// _dma_copy_once: the copy pipelined by hand through `depth` buffer slots.
//
// The TPU kernel is one sequential loop over every chunk (its grid runs in
// order on one core). Here each CTA streams its own contiguous range of
// chunks through its own ring of `depth` shared-memory slots, and the grid
// holds as many CTAs as fit on the card at once, so every SM keeps
// depth x chunk bytes in flight. One thread drives the ring:
//   - a slot is filled by a TMA bulk copy (cp.async.bulk global -> shared),
//     which completes on the slot's mbarrier (expect_tx bytes, phase bit
//     (k / depth) & 1 for the k-th chunk of the CTA);
//   - it is drained by a bulk store (cp.async.bulk shared -> global) in its
//     own bulk group;
//   - it is refilled only after that store has finished READING shared
//     memory (cp.async.bulk.wait_group.read): the race the TPU kernel's
//     docstring guards against. The refill of chunk k-1's slot waits for
//     all stores but chunk k's, so chunk k's store stays in flight while
//     the next load is issued.
// The prologue fills min(depth, chunks of the CTA) slots; the epilogue waits
// for every store to complete before the CTA (and its shared memory) ends.
// Bulk copies need 16-byte aligned addresses and sizes that are multiples of
// 16 B: a chunk is rows x 256 B or more, and the launcher refuses a
// misaligned pointer.
// ---------------------------------------------------------------------------
constexpr int kMaxDepth = 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(32)
    membw_dma(const uint8_t* x, uint8_t* out, int64_t nbytes,
              int64_t chunk_bytes, int64_t n_chunks, int depth) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t bars[kMaxDepth];
  if (threadIdx.x != 0) return;
  const int64_t c0 = n_chunks * blockIdx.x / gridDim.x;
  const int64_t m = n_chunks * (blockIdx.x + 1) / gridDim.x - c0;
  for (int slot = 0; slot < depth; ++slot) {
    mbar_init(smem_u32(&bars[slot]), 1);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  auto bytes_of = [&](int64_t k) {
    const int64_t left = nbytes - (c0 + k) * chunk_bytes;
    return static_cast<uint32_t>(left < chunk_bytes ? left : chunk_bytes);
  };
  auto load = [&](int64_t k) {
    const int slot = static_cast<int>(k % depth);
    const uint32_t bar = smem_u32(&bars[slot]);
    const uint32_t bytes = bytes_of(k);
    mbar_expect_tx(bar, bytes);
    bulk_load(smem_u32(ring + slot * chunk_bytes),
              x + (c0 + k) * chunk_bytes, bytes, bar);
  };

  for (int64_t k = 0; k < depth && k < m; ++k) {  // prologue
    load(k);
  }
  for (int64_t k = 0; k < m; ++k) {
    const int slot = static_cast<int>(k % depth);
    mbar_wait(smem_u32(&bars[slot]), static_cast<uint32_t>((k / depth) & 1));
    bulk_store(out + (c0 + k) * chunk_bytes,
               smem_u32(ring + slot * chunk_bytes), bytes_of(k));
    const int64_t next = k - 1 + depth;  // goes into chunk k-1's slot
    if (k >= 1 && next < m) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(next);
    }
  }
  // epilogue: every store complete before the CTA's shared memory is freed
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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
  if (n < kLanes || n % kLanes != 0 || rows_per_chunk < 1) {
    return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      launch_stream<float>(x, out, n, rows_per_chunk, st);
      break;
    case kBFloat16:
      launch_stream<__nv_bfloat16>(x, out, n, rows_per_chunk, st);
      break;
    case kFloat16:
      launch_stream<__half>(x, out, n, rows_per_chunk, st);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int tc_membw_dma(const void* x, void* out, int64_t n, int dtype,
                 int rows_per_chunk, int depth, void* stream) {
  const int itemsize = itemsize_of(dtype);
  if (itemsize == 0 || n < kLanes || n % kLanes != 0 || rows_per_chunk < 1 ||
      depth < 2 || depth > kMaxDepth) {
    return cudaErrorInvalidValue;
  }
  if (!aligned16(x) || !aligned16(out)) return cudaErrorMisalignedAddress;
  const int64_t chunk_bytes =
      static_cast<int64_t>(rows_per_chunk) * kLanes * itemsize;
  const int64_t ring_bytes = chunk_bytes * depth;
  int dev = 0;
  int optin = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  if (ring_bytes + static_cast<int64_t>(sizeof(uint64_t)) * kMaxDepth >
      optin) {
    return cudaErrorInvalidValue;
  }
  const int smem = static_cast<int>(ring_bytes);
  err = cudaFuncSetAttribute(membw_dma,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, membw_dma, 32,
                                                      smem);
  if (err != cudaSuccess) return err;
  const int64_t nbytes = n * itemsize;
  const int64_t n_chunks = (nbytes + chunk_bytes - 1) / chunk_bytes;
  const int64_t resident = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid =
      static_cast<unsigned>(n_chunks < resident ? n_chunks : resident);
  membw_dma<<<grid, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), nbytes,
      chunk_bytes, n_chunks, depth);
  return cudaGetLastError();
}

const char* tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
