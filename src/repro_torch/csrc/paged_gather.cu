// Paged KV-cache gather for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/paged_gather/paged_gather_kernel.py
// (`_kernel` / `paged_gather_pallas`): the page store (N, psz, ...) and
// the page table (S, P) give the dense per-slot view (S, P*psz, ...), in
// which block (i, j) is page table[i, j].  Page ids are clamped to
// [0, N-1], as the reference's `jnp.take(..., mode="clip")` does.  A
// pure copy: the result is bit-exact for any dtype.
//
// Bound on an H100: each page of the view is read once and written once,
// 2 * S * P * page_bytes at 3.35 TB/s; there is no arithmetic.
//
// Design: one block per (slot, page) reads its page id, clamps it, and
// copies the page's contiguous bytes with 16-byte vector loads and
// stores (neighbouring threads on neighbouring addresses); a page whose
// size or base is not a 16-byte multiple takes a byte copy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename V>
__global__ void __launch_bounds__(kThreads)
paged_gather_kernel(const V* __restrict__ pages,
                    const int32_t* __restrict__ table, V* __restrict__ out,
                    int n_pages, int64_t page_elems) {
  const int64_t blk = blockIdx.x;                   // slot * P + j
  const int id = min(max(table[blk], 0), n_pages - 1);
  const V* src = pages + static_cast<int64_t>(id) * page_elems;
  V* dst = out + blk * page_elems;
  for (int64_t e = threadIdx.x; e < page_elems; e += kThreads) dst[e] = src[e];
}

}  // namespace

// pages: contiguous (n_pages, page_bytes) bytes; table: contiguous
// (blocks,) int32 with blocks = S * P; out: contiguous (blocks,
// page_bytes).  Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_gather_launch(const void* pages, const void* table,
                                   void* out, int n_pages, int blocks,
                                   int64_t page_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks);
  const bool vec = page_bytes % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(pages) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (vec) {
    paged_gather_kernel<uint4><<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(pages),
        static_cast<const int32_t*>(table), static_cast<uint4*>(out),
        n_pages, page_bytes / 16);
  } else {
    paged_gather_kernel<unsigned char><<<grid, kThreads, 0, s>>>(
        static_cast<const unsigned char*>(pages),
        static_cast<const int32_t*>(table),
        static_cast<unsigned char*>(out), n_pages, page_bytes);
  }
  return static_cast<int>(cudaGetLastError());
}
