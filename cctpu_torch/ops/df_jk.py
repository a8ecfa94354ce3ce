"""Fused density-fitted J/K: the hand-written Hopper kernel and its twin.

Replaces the TPU kernel ``cctpu/ops/df_jk_pallas.py::_fused_jk_kernel``
(entry ``df_jk_fused``), which streams B through VMEM once per SCF cycle.
The CUDA C++ kernel is ``csrc/df_jk_fused.cu`` (sm_90a, FP64 and FP32).

What bounds it on the card: B is naux*nao^2*8 bytes per call in FP64, 171
MB at phenol/6-31G* and 4.1 GB at C16H34/6-31G*, read every SCF cycle, so
the call is bound by device-memory bandwidth at small nocc; the
W_p = (B[p] C)^T and W_p^T W_p products add 3*nocc flops per element of B
(2 for W, 1 for the symmetric K), which makes the FP64 tensor-core rate
the bound at C16H34 (nocc 65). What the design does about it (``csrc/
df_wk.cuh``, shared with ``df_k``): one streaming pass over B by
asynchronous copies into a ring of tiles; both products on the FP64 tensor
cores (``mma.sync.m16n8k4``), W_p^T accumulated in registers over the
whole k range and written to shared memory once per aux row, never to
device memory; K on tiles of the upper triangle, in registers for a
block's whole aux range where it fits (phenol); the partial J in shared
memory where it fits, else jp stored and J added in a second pass over B;
per-block partials summed in block order (no float atomics: repeat calls
are bitwise equal). ``ops/plan.py::wk_plan`` chooses the tile sizes, the
ring and where W, J and K partials live; f32 calls, and f64 shapes whose
W_p does not fit in shared memory, run the FMA kernel of the same file.

Dispatch: a CPU tensor takes ``df_jk_reference`` (plain torch); a CUDA
tensor launches the kernel or raises. The kernel is built by
``ops/build.py`` with nvcc at first use and bound with ctypes; a build
failure raises.
"""

from __future__ import annotations

import torch

from cctpu_torch.ops import build as _build
from cctpu_torch.ops import plan as _plan

# kernel launches on the card since import (one per df_jk_fused call that
# reached the kernel); chip_smoke.py resets and reads it
LAUNCHES = 0
# the plan (ops/plan.py::wk_plan) of the last launch
LAST_PLAN = None
_LIB = None


def df_jk_reference(B, D, Cocc):
    """Plain torch: the same four einsums as cctpu's df_jk_reference."""
    Jp = torch.einsum("pij,ij->p", B, D)
    J = torch.einsum("p,pij->ij", Jp, B)
    W = torch.einsum("pik,ka->pia", B, Cocc)
    K = torch.einsum("pia,pja->ij", W, W)
    return J, K


def build():
    """Compile (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = _build.load("df_jk_fused")
        _build.bind(lib, ("df_jk_fused_f64", "df_jk_fused_f32"), 3,
                    5 + len(_plan.PLAN_INTS) + 1, 6)
        _LIB = lib
    return _LIB


def _check(B, D, Cocc):
    _build.check_inputs("df_jk_fused", {"B": B, "D": D, "Cocc": Cocc})
    if B.ndim != 3 or B.shape[1] != B.shape[2] or D.shape != B.shape[1:] \
            or Cocc.ndim != 2 or Cocc.shape[0] != B.shape[1] \
            or Cocc.shape[1] < 1 or B.shape[0] < 1:
        raise ValueError(f"df_jk_fused: shapes B {tuple(B.shape)}, "
                         f"D {tuple(D.shape)}, Cocc {tuple(Cocc.shape)} "
                         "are not [naux,nao,nao], [nao,nao], [nao,nocc>=1]")


def df_jk_fused(B, D, Cocc):
    """J, K of the DF factor B [naux, nao, nao] for density D [nao, nao]
    and occupied factor Cocc [nao, nocc] (columns carry sqrt(occupation)).
    CPU tensors: plain torch. CUDA tensors: the Hopper kernel, or raise."""
    global LAUNCHES, LAST_PLAN
    if B.device.type == "cpu" and D.device.type == "cpu" \
            and Cocc.device.type == "cpu":
        return df_jk_reference(B, D, Cocc)
    _check(B, D, Cocc)
    lib = build()
    naux, nao, _ = B.shape
    nocc = Cocc.shape[1]
    nblk, rows = _build.blocks(naux, B.device)
    plan = _plan.wk_plan(nao, nocc, B.element_size(),
                         _build.smem_cap(B.device), True)
    Jw, Kw, Ws = _plan.workspaces(plan, nblk, naux, B)
    J = torch.empty((nao, nao), dtype=B.dtype, device=B.device)
    K = torch.empty_like(J)
    fn = lib.df_jk_fused_f64 if B.dtype == torch.float64 \
        else lib.df_jk_fused_f32
    vec16 = int(nao % 2 == 0 and B.data_ptr() % 16 == 0
                and D.data_ptr() % 16 == 0)      # D's tiles are copied as B's
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = fn(B.data_ptr(), D.data_ptr(), Cocc.data_ptr(), naux, nao,
                 nocc, nblk, rows, *_plan.plan_ints(plan), vec16,
                 Jw.data_ptr(), Kw.data_ptr(), _plan.ptr(Ws), J.data_ptr(),
                 K.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("df_jk_fused launch failed: "
                           + lib.df_error_string(err).decode())
    LAUNCHES += 1
    LAST_PLAN = plan
    return J, K
