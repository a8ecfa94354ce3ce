// Fused density-fitted J/K build for Hopper (sm_90a), FP64 and FP32.
//
// Replaces the TPU Pallas kernel cctpu/ops/df_jk_pallas.py::_fused_jk_kernel
// (entry df_jk_fused). For B [naux, nao, nao], D [nao, nao] and
// C = Cocc [nao, nocc] (columns carry sqrt(occupation)) it computes
//     jp[p] = sum_ij B[p,i,j] D[i,j]        J = sum_p jp[p] B[p]
//     W_p   = (B[p] C)^T  ([nocc, nao])    K = sum_p W_p^T W_p
// streaming B through shared memory, without ever writing the full
// W [naux, nocc, nao] to device memory.
//
// Bound: B is naux*nao^2*8 bytes per call in FP64 (171 MB at phenol
// 6-31G*, 4.1 GB at C16H34), which makes the call bound by device-memory
// bandwidth at small nocc; the W and K products add 3*nocc flops per B
// element (2 for W, 1 for the symmetric K), so from nocc ~ 25 on the FP64
// rate, which only the tensor cores reach, is the other bound.
//
// Design: df_wk.cuh's device code with WITH_J = true (its head has the
// details). In FP64, wk_mma: each block owns a contiguous aux range; B[p]
// arrives in column tiles by tensor copies (TMA; cp.async where nao is
// odd), a ring of tiles deep; W_p^T is accumulated on FP64 tensor-core
// tiles held in registers over the whole k range and goes to shared memory
// once per aux row; K adds
// W_p^T W_p on tensor-core tiles of the upper triangle, kept in registers
// for the block's whole aux range at phenol's size and in a per-block
// partial in device memory at C16H34's; jp[p] is summed from the tiles as
// they land. At phenol's size jp[p] B[p] is added into a partial J in
// shared memory; at C16H34's, where that does not fit, the kernel stores
// jp and a second pass over B (j_pass) adds jp[p] B[p] with no partials.
// The per-block partials are summed in block order (wk_sum). No float
// atomics: two calls on the same inputs give bitwise-equal J and K. FP32,
// and FP64 shapes whose W_p does not fit in shared memory, run wk_partial
// (FMA loops).
//
// C interface (bound with ctypes): pointers and the stream are void*; the
// plan integers are those of ops/plan.py::PLAN_INTS, then vec16 (B, and D,
// 16-byte aligned and nao even: else no tensor copies); Wslab is the
// scratch of the plan (the FMA kernel's W_p slab, or room for the packed
// C); the return value is cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a plan that is inconsistent or over the
// shared-memory cap.

#include "df_wk.cuh"

extern "C" {

int df_jk_fused_f64(const void* B, const void* D, const void* C, int naux,
                    int nao, int nocc, int nblk, int rows_per_blk,
                    int kind, int variant, int kt, int stages, int wm,
                    int mt_panel, int w_in_smem, int j_in_smem, int alias,
                    int tma, int smem_bytes, int vec16,
                    void* Jw, void* Kw, void* Wslab, void* J, void* K,
                    void* stream) {
  return dfk::launch_wk<double, true>(
      B, D, C, naux, nao, nocc, nblk, rows_per_blk,
      {kind, variant, kt, stages, wm, mt_panel, w_in_smem, j_in_smem,
       alias, tma, smem_bytes},
      vec16, Jw, Kw, Wslab, J, K, stream);
}

int df_jk_fused_f32(const void* B, const void* D, const void* C, int naux,
                    int nao, int nocc, int nblk, int rows_per_blk,
                    int kind, int variant, int kt, int stages, int wm,
                    int mt_panel, int w_in_smem, int j_in_smem, int alias,
                    int tma, int smem_bytes, int vec16,
                    void* Jw, void* Kw, void* Wslab, void* J, void* K,
                    void* stream) {
  return dfk::launch_wk<float, true>(
      B, D, C, naux, nao, nocc, nblk, rows_per_blk,
      {kind, variant, kt, stages, wm, mt_panel, w_in_smem, j_in_smem,
       alias, tma, smem_bytes},
      vec16, Jw, Kw, Wslab, J, K, stream);
}

}  // extern "C"
