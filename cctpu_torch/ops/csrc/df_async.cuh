// Asynchronous copies into shared memory for the FP64 tensor-core kernels
// (sm_90a): cp.async, the mbarrier and tensor-copy (TMA) primitives, the
// 128- and 64-byte swizzles that tensor copies write tiles with, the row
// order in which a warp's fragments read such a tile without bank
// conflicts, and the tensor maps. df_wk.cuh (wk_mma) and df_k_dm.cu use
// them.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

namespace dfc {

__device__ __forceinline__ void cp_async16(double* smem, const double* g,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(g), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async8(double* smem, const double* g,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(g), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n of the committed groups are pending (n < 3).
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0) {
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else if (n == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::);
  } else {
    asm volatile("cp.async.wait_group 2;\n" ::);
  }
}

// mbarrier and tensor-copy (TMA) primitives. A tensor copy brings a box of
// a tensor in device memory into shared memory; one thread issues it, the
// copy engine runs it (zeros where the box leaves the tensor) and reports
// its bytes to an mbarrier. Unlike cp.async, its issue does not wait for
// the memory system, and it does not queue with the products' loads.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE_%=;\n"
      "bra WAIT_%=;\n"
      "DONE_%=:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(double* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(double* dst, const CUtensorMap* map,
                                            int c0, int c1,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) of contiguous
// device memory, by the same engine.
__device__ __forceinline__ void bulk_load(double* dst, const double* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's earlier shared-memory accesses before later tensor
// copies into the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Where element (row, k) of a tile of kt = 8 or 16 columns lies that a
// tensor copy wrote with the 64- or 128-byte swizzle (rows of kt doubles,
// the 16-byte chunks of a row exchanged by bits of the row number).
__device__ __forceinline__ int swizzled(int row, int k, int kt) {
  const int off = row * kt + k;  // in doubles: bits 1.. are the chunk
  return off ^ (((off >> 4) & (kt == 16 ? 7 : 3)) << 1);
}

// Which row of its 8 (and, 8 further on, of its other 8) lane group g of
// an mma reads from such a tile, and so which output row it computes: the
// rows of a 16-row tile may go to the fragment's rows in any order, and in
// this one the four rows that a half-warp reads together fall into
// different banks under the swizzle (rows 0, 2, 4, 6 with 128 bytes, 0, 1,
// 4, 5 with 64), where rows 0-3 collide two by two.
__device__ __forceinline__ int tile_row(int g, int kt) {
  return kt == 16 ? ((g & 3) << 1) | (g >> 2)
                  : (g & 1) | ((g & 2) << 1) | ((g & 4) >> 1);
}

// The tensor map of a row-major f64 tensor of rank 2 or 3 (dims fastest
// first: columns, rows, slices) for boxes of box_cols x box_rows (x 1) with
// the swizzle of box_cols * 8 bytes (64 or 128).
inline cudaError_t make_tensor_map(CUtensorMap* map, const double* base,
                                   int rank, int ncols, int nrows, int nslices,
                                   int box_cols, int box_rows) {
  typedef CUresult (*Encode)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  // cuTensorMapEncodeTiled lives in libcuda, which the library is not
  // linked against: looked up once in the copy the process has loaded
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    void* fn = lib != nullptr ? dlsym(lib, "cuTensorMapEncodeTiled") : nullptr;
    if (fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(ncols),
                              static_cast<cuuint64_t>(nrows),
                              static_cast<cuuint64_t>(nslices)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(ncols) * 8,
      static_cast<cuuint64_t>(ncols) * static_cast<cuuint64_t>(nrows) * 8};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, static_cast<cuuint32_t>(rank),
      const_cast<double*>(base), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      box_cols == 16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace dfc
