"""Build the port's CUDA kernels with nvcc into shared libraries.

Each ``csrc/<name>.cu`` (with the ``csrc/*.cuh`` headers it may include)
is compiled at first use into ``build/cctpu_torch/<name>-<hash>.so``,
keyed by a hash of the sources and flags, and loaded with ctypes. No
PyTorch header is included, so a build takes seconds. ``compile_all``
starts one nvcc per source at once and waits for all of them; every build
failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from cctpu_torch.ops import plan as _plan

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cctpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-ldl"]
KERNELS = ("df_jk_fused", "df_j", "df_k", "df_k_dm")

# compiler output of each build made by this process (ptxas register and
# spill report), by kernel name
BUILD_LOGS: dict = {}


def nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc")):
        if cand:
            return cand
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME)")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the source, every
    header in csrc/ and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def compile_all(names=KERNELS) -> None:
    """Build every library of ``names`` that is not built yet, one nvcc
    process per source, all started together."""
    todo = [(n, library_path(n)) for n in names]
    todo = [(n, so) for n, so in todo if not so.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for name, so in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        procs.append((name, so, tmp, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOGS[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n"
                          f"{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    compile_all([name])
    return ctypes.CDLL(str(library_path(name)))


def bind(lib: ctypes.CDLL, names, nptr_in: int, nint: int,
         nptr_out: int) -> None:
    """Set argtypes of the C entries ``names``: ``nptr_in`` pointers,
    ``nint`` ints, ``nptr_out`` pointers (the stream last among them),
    returning int; and of ``df_error_string`` (csrc/df_common.cuh), which
    every library exports."""
    args = ([ctypes.c_void_p] * nptr_in + [ctypes.c_int] * nint
            + [ctypes.c_void_p] * nptr_out)
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.df_error_string.argtypes = [ctypes.c_int]
    lib.df_error_string.restype = ctypes.c_char_p


def smem_cap(device) -> int:
    """Bytes of shared memory a block may opt in to on ``device`` (what the
    launch plans of ops/plan.py are made for)."""
    import torch
    return torch.cuda.get_device_properties(
        device).shared_memory_per_block_optin


def sass_count(name: str, opcode: str) -> int:
    """How many instructions of the built library ``name`` start with
    ``opcode`` (``cuobjdump -sass``, from nvcc's directory)."""
    exe = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    out = subprocess.run([exe, "-sass", str(library_path(name))],
                         capture_output=True, text=True, check=True).stdout
    return sum(1 for ln in out.splitlines()
               if f" {opcode}" in ln and ln.lstrip().startswith("/*"))


def ptxas_report(name: str, match: str) -> list:
    """Registers and spills of the entry functions of library ``name``
    whose mangled name contains ``match``: from this process's build log,
    or, where the library was built before, its registers and stack bytes
    from ``cuobjdump -res-usage``."""
    out, fn = [], None
    for ln in BUILD_LOGS.get(name, "").splitlines():
        if "Compiling entry function" in ln or "Function properties" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln.split()[-1]
        elif fn and match in fn and ("registers" in ln or "spill" in ln):
            out.append(f"{fn}: {ln.split(':', 1)[-1].strip()}")
    if out or name in BUILD_LOGS:
        return out
    exe = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    res = subprocess.run([exe, "-res-usage", str(library_path(name))],
                         capture_output=True, text=True, check=True).stdout
    for ln in res.splitlines():
        ln = ln.strip()
        if ln.startswith("Function "):
            fn = ln[len("Function "):].rstrip(":")
        elif fn and match in fn and ln.startswith("REG:"):
            out.append(f"{fn}: {' '.join(ln.split()[:2])}")
    return out


def blocks(naux: int, device) -> tuple:
    """(nblk, rows per block): one contiguous aux range per SM at most."""
    import torch
    return _plan.blocks(
        naux, torch.cuda.get_device_properties(device).multi_processor_count)


def check_inputs(fn: str, tensors: dict) -> None:
    """Raise ValueError unless the tensors are on one CUDA device, of one
    dtype among float64/float32, and contiguous."""
    import torch
    ts = list(tensors.values())
    dev = ts[0].device
    if not (dev.type == "cuda" and all(t.device == dev for t in ts)):
        got = ", ".join(str(t.device) for t in ts)
        raise ValueError(f"{fn}: {', '.join(tensors)} must be on one CUDA "
                         f"device (got {got})")
    if ts[0].dtype not in (torch.float64, torch.float32) \
            or any(t.dtype != ts[0].dtype for t in ts):
        raise ValueError(f"{fn}: dtypes must be one of float64/float32 "
                         f"(got {', '.join(str(t.dtype) for t in ts)})")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
