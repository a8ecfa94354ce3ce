"""Fused density-fitted J/K: the hand-written Hopper kernel and its twin.

Replaces the TPU kernel ``cctpu/ops/df_jk_pallas.py::_fused_jk_kernel``
(entry ``df_jk_fused``), which streams B through VMEM once per SCF cycle.
The CUDA C++ kernel is ``csrc/df_jk_fused.cu`` (sm_90a, FP64 and FP32).

What bounds it on the card: B is naux*nao^2*8 bytes per call in FP64, 171
MB at phenol/6-31G* and 4.1 GB at C16H34/6-31G*, read every SCF cycle, so
the call is bound by device-memory bandwidth; the W_p = (B[p] C)^T and
W_p^T W_p products add 4*nocc flops per element of B (3*nocc with K's
symmetry), which makes FP64 FMA throughput the second bound from nocc ~ 25
on. What the design does
about it: one streaming pass over B per call, W_p kept in shared memory
(or a one-row slab per block), never the full W [naux, nocc, nao] in
device memory, and per-block partial J/K summed in a fixed order by a
second kernel (no float atomics: repeat calls are bitwise equal).

Dispatch: a CPU tensor takes ``df_jk_reference`` (plain torch); a CUDA
tensor launches the kernel or raises. The kernel (``csrc/df_jk_fused.cu``
with the device code of ``csrc/df_wk.cuh``, shared with ``df_k``) is built
by ``ops/build.py`` with nvcc at first use and bound with ctypes; a build
failure raises.
"""

from __future__ import annotations

import torch

from cctpu_torch.ops import build as _build

# kernel launches on the card since import (one per df_jk_fused call that
# reached the kernel); chip_smoke.py resets and reads it
LAUNCHES = 0
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
        _build.bind(lib, ("df_jk_fused_f64", "df_jk_fused_f32"), 3, 5, 6)
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
    global LAUNCHES
    if B.device.type == "cpu" and D.device.type == "cpu" \
            and Cocc.device.type == "cpu":
        return df_jk_reference(B, D, Cocc)
    _check(B, D, Cocc)
    lib = build()
    naux, nao, _ = B.shape
    nocc = Cocc.shape[1]
    nblk, rows = _build.blocks(naux, B.device)
    Jw = torch.empty((nblk, nao, nao), dtype=B.dtype, device=B.device)
    Kw = torch.empty_like(Jw)
    # one aux row's W_p per block, padded to the kernel's 4x4 micro-tiles
    Ws = torch.empty((nblk, -(-nocc // 4) * 4, -(-nao // 4) * 4),
                     dtype=B.dtype, device=B.device)
    J = torch.empty((nao, nao), dtype=B.dtype, device=B.device)
    K = torch.empty_like(J)
    fn = lib.df_jk_fused_f64 if B.dtype == torch.float64 \
        else lib.df_jk_fused_f32
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = fn(B.data_ptr(), D.data_ptr(), Cocc.data_ptr(), naux, nao,
                 nocc, nblk, rows, Jw.data_ptr(), Kw.data_ptr(),
                 Ws.data_ptr(), J.data_ptr(), K.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("df_jk_fused launch failed: "
                           + lib.df_error_string(err).decode())
    LAUNCHES += 1
    return J, K
