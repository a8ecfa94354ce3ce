"""Density-fitted exchange of general densities: the hand-written Hopper
kernel and its twin.

K[s] = sum_p B[p] D[s] B[p]^T for B [naux, nao, nao] and D [nao, nao] or
[nset, nao, nao], no symmetry of B[p] or D[s] assumed: the exchange of a
density that has no occupied factor (the TDDFT transition densities). No
TPU kernel of cctpu computes it: it replaces the XLA einsum of
``cctpu/ints/df.py::DFJK._k_of`` with ``cocc=None``. The CUDA C++ kernel is
``csrc/df_k_dm.cu`` (sm_90a, FP64 on the tensor cores). It takes float64
only: the FP64 tensor-core product (``mma.sync...f64``) has no FP32 form,
and the port's response code runs in float64.

What bounds it on the card: one read of B (171 MB at phenol/6-31G* in
FP64) against 4*nao flops per element of B and density: compute-bound
from one density on (phenol: 0.051 ms of bytes, 0.141 ms of FP64 at 67
TFLOP/s per density; ``utils/measure.py::work``). What the design does
about it (``csrc/df_k_dm.cu``, plan ``ops/plan.py::k_dm_plan``): a block
owns a column panel of one density's K for a contiguous aux range and
keeps it in registers over the whole range, writing it once; per aux row
it forms V = D[s] B[p][J, :]^T on the FP64 tensor cores (m16n8k16;
registers, then shared memory) and adds B[p] V, so no partial K moves per
aux row. The tiles run over 16-row, 8-column and 16-deep mma tiles of the
whole matrix (5 % padding at nao 110, 10 % at 198); B's tiles (and D's,
where D does not stay in shared memory for the block's range) arrive
through a ring of asynchronous copies (tensor copies for even nao,
cp.async for odd); the blocks of one aux group run together, so B comes
from device memory about once; one barrier per two tiles where the ring
fits. What still holds it back (the fixed cost of each job, the tensor
cores' balance): see the note in ``csrc/df_k_dm.cu``. The groups'
partials are summed in group order (no float atomics: repeat calls are
bitwise equal), and nothing that sets the order of a density's sum
depends on the batch: a density's K is bitwise the same in any batch. A
large batch is split into launches whose partials fit
``WS_BUDGET_BYTES``.

Dispatch: CPU tensors take ``df_k_dm_reference`` (plain torch); CUDA
tensors launch the kernel or raise. Built by ``ops/build.py`` at first use.
"""

from __future__ import annotations

import torch

from cctpu_torch.ops import build as _build
from cctpu_torch.ops import plan as _plan

# kernel launches on the card since import (one per batch of densities
# that reached the kernel); chip_smoke.py resets and reads it
LAUNCHES = 0
# the plan (ops/plan.py::k_dm_plan) of the last launch
LAST_PLAN = None
# bytes of the groups' partials [groups, nset, nao, nao] one launch may take
WS_BUDGET_BYTES = 2 << 30
_LIB = None


def df_k_dm_reference(B, D):
    """Plain torch: cctpu's einsum "pik,...kl,pjl->...ij"."""
    return torch.einsum("pik,...kl,pjl->...ij", B, D, B)


def build():
    """Compile (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = _build.load("df_k_dm")
        _build.bind(lib, ("df_k_dm_f64",), 2,
                    3 + len(_plan.KDM_PLAN_INTS), 3)
        _LIB = lib
    return _LIB


def batch_size(groups: int, nao: int, nset: int) -> int:
    """Densities one launch takes: as many as the groups' partials of
    ``WS_BUDGET_BYTES`` hold, at least one."""
    return max(1, min(nset, WS_BUDGET_BYTES // (groups * nao * nao * 8)))


def df_k_dm(B, D):
    """Exchange matrices K[s] = sum_p B[p] D[s] B[p]^T of the DF factor B
    [naux, nao, nao] for D [nao, nao] or [nset, nao, nao]; K has D's shape.
    CPU tensors: plain torch. CUDA tensors: the Hopper kernel, or raise."""
    global LAUNCHES, LAST_PLAN
    if B.device.type == "cpu" and D.device.type == "cpu":
        return df_k_dm_reference(B, D)
    D3 = (D[None] if D.ndim == 2 else D).contiguous()
    _build.check_inputs("df_k_dm", {"B": B, "D": D3})
    if B.dtype != torch.float64:
        raise ValueError("df_k_dm takes float64 only: its products run on "
                         "the FP64 tensor cores, which have no FP32 form")
    if B.ndim != 3 or B.shape[1] != B.shape[2] or B.shape[0] < 1 \
            or D.ndim not in (2, 3) or D.shape[-2:] != B.shape[1:] \
            or D3.shape[0] < 1:
        raise ValueError(f"df_k_dm: shapes B {tuple(B.shape)}, "
                         f"D {tuple(D.shape)} are not [naux,nao,nao], "
                         "[nao,nao] or [nset>=1,nao,nao]")
    lib = build()
    naux, nao, _ = B.shape
    nset = D3.shape[0]
    plan = _plan.k_dm_plan(
        naux, nao,
        torch.cuda.get_device_properties(B.device).multi_processor_count,
        _build.smem_cap(B.device))
    per = batch_size(plan["groups"], nao, nset)
    K = torch.empty_like(D3)
    Kw = torch.empty((plan["groups"], per, nao, nao), dtype=B.dtype,
                     device=B.device)
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        for s0 in range(0, nset, per):
            nb = min(per, nset - s0)
            err = lib.df_k_dm_f64(B.data_ptr(), D3[s0].data_ptr(), naux,
                                  nao, nb, *_plan.k_dm_plan_ints(plan),
                                  Kw.data_ptr(), K[s0].data_ptr(), stream)
            if err != 0:
                raise RuntimeError("df_k_dm launch failed: "
                                   + lib.df_error_string(err).decode())
            LAUNCHES += 1
    LAST_PLAN = plan
    return K if D.ndim == 3 else K[0]
