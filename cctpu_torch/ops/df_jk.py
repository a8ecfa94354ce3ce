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
tensor launches the kernel or raises. The kernel is built with nvcc at
first use into ``build/cctpu_torch/`` (keyed by a hash of the source and
flags) and bound with ctypes; a build failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

# kernel launches on the card since import (one per df_jk_fused call that
# reached the kernel); chip_smoke.py resets and reads it
LAUNCHES = 0
# compiler output of the last build (ptxas register/spill report)
BUILD_LOG = ""

_SRC = Path(__file__).resolve().parent / "csrc" / "df_jk_fused.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cctpu_torch"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LIB = None


def df_jk_reference(B, D, Cocc):
    """Plain torch: the same four einsums as cctpu's df_jk_reference."""
    Jp = torch.einsum("pij,ij->p", B, D)
    J = torch.einsum("p,pij->ij", Jp, B)
    W = torch.einsum("pik,ka->pia", B, Cocc)
    K = torch.einsum("pia,pja->ij", W, W)
    return J, K


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc")):
        if cand:
            return cand
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME)")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    src = _SRC.read_bytes()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    so = _BUILD_DIR / f"df_jk_fused-{key[:16]}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
                               str(_SRC)], capture_output=True, text=True)
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{BUILD_LOG}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    args = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
            + [ctypes.c_void_p] * 6)
    for name in ("df_jk_fused_f64", "df_jk_fused_f32"):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.df_jk_error_string.argtypes = [ctypes.c_int]
    lib.df_jk_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def _check(B, D, Cocc):
    if not (B.is_cuda and D.device == B.device and Cocc.device == B.device):
        raise ValueError("df_jk_fused: B, D and Cocc must be on one CUDA "
                         f"device (got {B.device}, {D.device}, "
                         f"{Cocc.device})")
    if B.dtype not in (torch.float64, torch.float32) or \
            D.dtype != B.dtype or Cocc.dtype != B.dtype:
        raise ValueError(f"df_jk_fused: dtypes must be one of float64/"
                         f"float32 (got {B.dtype}, {D.dtype}, {Cocc.dtype})")
    if B.ndim != 3 or B.shape[1] != B.shape[2] or D.shape != B.shape[1:] \
            or Cocc.ndim != 2 or Cocc.shape[0] != B.shape[1] \
            or Cocc.shape[1] < 1 or B.shape[0] < 1:
        raise ValueError(f"df_jk_fused: shapes B {tuple(B.shape)}, "
                         f"D {tuple(D.shape)}, Cocc {tuple(Cocc.shape)} "
                         "are not [naux,nao,nao], [nao,nao], [nao,nocc>=1]")
    for name, t in (("B", B), ("D", D), ("Cocc", Cocc)):
        if not t.is_contiguous():
            raise ValueError(f"df_jk_fused: {name} must be contiguous")


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
    sms = torch.cuda.get_device_properties(B.device).multi_processor_count
    rows = -(-naux // min(naux, sms))
    nblk = -(-naux // rows)
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
                           + lib.df_jk_error_string(err).decode())
    LAUNCHES += 1
    return J, K
