// Shared by csrc/grid.cu and csrc/wave.cu: the dtype helpers, the mbarrier
// and TMA bulk-copy primitives, and the staging of one row range of the
// field into shared memory (csrc/membw.cu takes the helpers and the
// primitives). tpu_comm_torch/kernels/_build.py hashes every csrc/*.cuh
// into each library's name, so an edit here rebuilds them all.
//
// Staging a row range. The TPU kernels copy a window with
// pltpu.make_async_copy and wait on its DMA semaphore; here the copy is a
// TMA bulk copy (cp.async.bulk global -> shared) that completes on an
// mbarrier. A bulk copy needs 16-byte aligned addresses and a size that is
// a multiple of 16 bytes, and the port takes every shape (a row of 301
// floats, a field of 1000001) and views off the 16-byte grid. So a row
// range is staged at the same address modulo 16 as it has in global
// memory: column c of the range [c0, c1) lands at byte
//   (addr(row + c0) & 15) + (c - c0) * sizeof(T)
// of its 16-byte aligned shared buffer, and the bulk copy moves the range
// widened to 16-byte boundaries (the extra bytes are never read). What the
// bulk copy cannot move is loaded by plain loads in the same kernel: the
// part of the range outside the field's 16-byte aligned interior (only at
// the field's two ends), and a column outside [0, n), which wraps to the
// other end of the row (the periodic halo). An aligned interior range
// needs no plain load at all.

#pragma once

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Make the barriers' initialisation visible to the async proxy (the bulk
// copies) and, after the caller's __syncthreads, to every thread.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival that also expects `bytes` more bytes of bulk copies in the
// current phase (none: a plain arrival).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, uint32_t bytes) {
  if (bytes == 0) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_u32(bar))
                 : "memory");
  } else {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(bar)),
        "r"(bytes)
        : "memory");
  }
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, uintptr_t src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__host__ __device__ __forceinline__ uintptr_t align_down16(uintptr_t a) {
  return a & ~static_cast<uintptr_t>(15);
}
__host__ __device__ __forceinline__ uintptr_t align_up16(uintptr_t a) {
  return align_down16(a + 15);
}

// The bytes a shared buffer needs to stage `cols` columns of T.
__host__ __device__ constexpr int64_t staged_bytes(int64_t cols,
                                                   int64_t itemsize) {
  return (cols * itemsize + 32 + 15) / 16 * 16;
}

// The 16-byte aligned interior of the field: the bytes a bulk copy may
// read, [lo, hi).
struct Field {
  uintptr_t lo;
  uintptr_t hi;
};

template <typename T>
__host__ __device__ __forceinline__ Field field_of(const T* u, int64_t n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(u);
  return {align_up16(a), align_down16(a + static_cast<uintptr_t>(n) *
                                              sizeof(T))};
}

// How the columns [c0, c1) of a row of n elements are staged (-1 <= c0,
// c1 <= n + 1): a bulk copy of the bytes [blo, bhi), and plain loads of
// the columns [c0, clo) and [chi, c1).
template <typename T>
struct RowPlan {
  uintptr_t base;  // addr(row + c0) rounded down to 16: the buffer's byte 0
  uintptr_t blo;
  uintptr_t bhi;
  int64_t clo;
  int64_t chi;
};

template <typename T>
__device__ __forceinline__ RowPlan<T> plan_row(const T* row, int64_t n,
                                               int64_t c0, int64_t c1,
                                               Field f) {
  const int64_t sz = sizeof(T);
  const uintptr_t a = reinterpret_cast<uintptr_t>(row);
  // two's complement: a column -1 is the address one element before
  const uintptr_t lo_addr = a + static_cast<uintptr_t>(c0 * sz);
  const uintptr_t hi_addr = a + static_cast<uintptr_t>(c1 * sz);
  RowPlan<T> p;
  p.base = align_down16(lo_addr);
  // a wrapped column comes by a plain load, so the copy stops short of it
  uintptr_t lo = c0 >= 0 ? p.base : align_up16(a);
  uintptr_t hi = c1 <= n ? align_up16(hi_addr)
                         : align_down16(a + static_cast<uintptr_t>(n * sz));
  lo = lo > f.lo ? lo : f.lo;
  hi = hi < f.hi ? hi : f.hi;
  if (hi <= lo) {
    p.blo = p.bhi = 0;
    p.clo = p.chi = c1;
    return p;
  }
  p.blo = lo;
  p.bhi = hi;
  // both differences are multiples of sz (sz divides 16)
  const int64_t dlo = static_cast<int64_t>(lo - lo_addr) / sz;
  const int64_t dhi = static_cast<int64_t>(hi - lo_addr) / sz;
  p.clo = c0 + (dlo > 0 ? dlo : 0);
  if (p.clo > c1) p.clo = c1;
  p.chi = c0 + dhi;
  if (p.chi > c1) p.chi = c1;
  if (p.chi < p.clo) p.chi = p.clo;
  return p;
}

template <typename T>
__device__ __forceinline__ uint32_t bulk_bytes(const RowPlan<T>& p) {
  return static_cast<uint32_t>(p.bhi - p.blo);
}

// Issue the plan's bulk copy into `dst` (one thread; the caller has
// counted its bytes into the barrier's phase).
template <typename T>
__device__ __forceinline__ void issue_bulk(const RowPlan<T>& p, uint8_t* dst,
                                           uint64_t* bar) {
  if (p.bhi > p.blo) {
    bulk_load(dst + (p.blo - p.base), p.blo, bulk_bytes(p), bar);
  }
}

__device__ __forceinline__ int64_t wrap_col(int64_t c, int64_t n) {
  return c < 0 ? c + n : (c >= n ? c - n : c);
}

// Where column c0 of a row staged by plan_row lies in its buffer (its
// address modulo 16): the staged column c is at [c - c0] from there.
template <typename T>
__device__ __forceinline__ uint32_t staged_offset(const T* row, int64_t c0) {
  return static_cast<uint32_t>((reinterpret_cast<uintptr_t>(row) +
                                static_cast<uintptr_t>(c0 * sizeof(T))) &
                               15);
}

template <typename T>
__device__ __forceinline__ const T* staged(const uint8_t* dst, const T* row,
                                           int64_t c0) {
  return reinterpret_cast<const T*>(dst + staged_offset(row, c0));
}

// The plan's plain loads into `dst`, by the `lanes` threads numbered
// `lane` (the bytes they write are disjoint from the bulk copy's).
template <typename T>
__device__ __forceinline__ void load_plain(const RowPlan<T>& p, const T* row,
                                           int64_t n, int64_t c0, int64_t c1,
                                           uint8_t* dst, int lane,
                                           int lanes) {
  T* s = reinterpret_cast<T*>(dst + staged_offset(row, c0));
  for (int64_t c = c0 + lane; c < p.clo; c += lanes) {
    s[c - c0] = row[wrap_col(c, n)];
  }
  for (int64_t c = p.chi + lane; c < c1; c += lanes) {
    s[c - c0] = row[wrap_col(c, n)];
  }
}

// The dynamic shared memory a block of these kernels may use on sm_90: a
// block's 232448 bytes, less room for their static barriers.
constexpr int kMaxSmem = 232448 - 1024;

// Opt a kernel into more than 48 KB of dynamic shared memory, once.
template <typename K>
int allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
}

}  // namespace
