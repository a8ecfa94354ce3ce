"""What ``chip_smoke.py`` and the card profilers (``ops/bench_wk.py``,
``ops/bench_mma.py``, ``grad/profile_grad.py``) share: the molecules they
run, the kernel shapes and tolerances, the card's name line, CUDA-event
timing, and the work and bound of a DF J/K kernel call.
"""

import json
import subprocess

import numpy as np
import torch

# bench.py's phenol geometry (Angstrom)
PHENOL = ("C 0.0000 1.3970 0.0000; C 1.2098 0.6985 0.0000; "
          "C 1.2098 -0.6985 0.0000; C 0.0000 -1.3970 0.0000; "
          "C -1.2098 -0.6985 0.0000; C -1.2098 0.6985 0.0000; "
          "O 0.0000 2.7650 0.0000; H 0.9300 3.1000 0.0000; "
          "H 2.1500 1.2400 0.0000; H 2.1500 -1.2400 0.0000; "
          "H 0.0000 -2.4800 0.0000; H -2.1500 -1.2400 0.0000; "
          "H -2.1500 1.2400 0.0000")
# the phenoxyl radical and the hydroxyl H atom it lost
H_ATOM = "H 0.9300 3.1000 0.0000"
PHENOXYL = PHENOL.replace(H_ATOM + "; ", "")
# the small gradient cases (chip_smoke.py phase 6, tests/test_torch_grad.py)
WATER = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
NH2 = "N 0 0 0; H 0 0.8036 0.6347; H 0 -0.8036 0.6347"
# the uv CLI's drug-sized molecule (chip_smoke.py phase 11c): nao 198 at
# 6-31G*, so the energy/uv route takes density fitting
ASPIRIN = "CC(=O)Oc1ccccc1C(=O)O"
# distorted starts of the optimizations (chip_smoke.py phases 8, 8b;
# water's is cctpu's tests/test_geomopt.py start)
WATER_START = "O 0 0 0; H 0 0 1.05; H 0 1.02 -0.3"
NH2_START = "N 0 0 0; H 0 0 1.10; H 0 1.00 -0.35"

# (naux, nao, nocc): cctpu's tests/test_pallas_ops.py shapes (unaligned on
# purpose) and phenol/6-31G*; the J and K kernels also at C16H34/6-31G*
KERNEL_SHAPES = [(96, 32, 8), (37, 16, 3), (83, 24, 5), (1770, 110, 25)]
C16H34_SHAPE = (6038, 292, 65)
# f64 only: an odd nao (8-byte copies), and a C32H66-sized row with few aux
# rows (neither B[p] nor W_p fits in shared memory: the FMA plan)
F64_SHAPES = [(61, 15, 4), (150, 600, 129)]
TOL = {"float64": 1e-12, "float32": 1e-5}

# the card's peaks for the f64 bounds (NVIDIA H100 SXM data sheet, dense
# rates): device memory 3.35 TB/s; FP64 67 TFLOP/s (the FP64 tensor-core
# rate, the card's highest for FP64; FMA outside the tensor cores peaks at
# 34)
PEAK_BYTES_S = 3.35e12
PEAK_FP64_FLOP_S = 67e12


def alkane(n_carbon: int) -> str:
    """Zig-zag all-anti n-alkane C_nH_{2n+2} (bench.py's geometry)."""
    cc, ch = 1.526, 1.090
    ang = np.deg2rad(111.0)
    dx = cc * np.sin(ang / 2)
    dz = cc * np.cos(ang / 2)
    atoms = []
    carbons = []
    for i in range(n_carbon):
        x = i * dx
        z = (i % 2) * dz
        carbons.append((x, 0.0, z))
        atoms.append(f"C {x:.4f} 0.0 {z:.4f}")
    for i, (x, y, z) in enumerate(carbons):
        up = 1.0 if i % 2 == 0 else -1.0
        atoms.append(f"H {x:.4f} {ch * 0.816:.4f} {z + up * ch * 0.577:.4f}")
        atoms.append(f"H {x:.4f} {-ch * 0.816:.4f} {z + up * ch * 0.577:.4f}")
        if i == 0 or i == n_carbon - 1:
            sgn = -1.0 if i == 0 else 1.0
            atoms.append(f"H {x + sgn * ch:.4f} 0.0 {z:.4f}")
    return "; ".join(atoms)


def emit(obj):
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() over reps runs, CUDA events."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def alternated_ms(kernel, plain, reps: int, library=None) -> dict:
    """Kernel and plain (and a library call) timed in turns: plain,
    kernel, kernel, plain; medians of the two rounds each."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    out = {"ms": float(np.median([k1, k2])),
           "plain_ms": float(np.median([p1, p2])),
           "kernel_ms_rounds": [k1, k2], "plain_ms_rounds": [p1, p2],
           "library_ms": None}
    if library is not None:
        out["library_ms"] = cuda_ms(library, reps)
    return out


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take for an f64 call: the larger of
    bytes over the memory rate and flops over the FP64 peak."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FP64_FLOP_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def work(name, naux, nao, nocc=0, nset=1):
    """(bytes, flops) of one f64 call: each input read once, each output
    written once; the contractions' multiply-adds counted as 2 flops. K
    costs 3*nocc flops per element of B: 2 for W_p = (B[p] C)^T and 1 for
    the symmetric K = sum_p W_p^T W_p (half of the square). The exchange of
    ``nset`` general densities (``df_k_dm``) costs 4*nao flops per element
    of B and density: 2 for W = B[p] D[s], 2 for W B[p]^T."""
    b, n2 = naux * nao * nao, nao * nao
    if name == "df_k_dm":
        return (b + 2 * nset * n2) * 8, 4.0 * b * nao * nset
    if name == "df_jk_fused":
        return (b + n2 + nao * nocc + 2 * n2) * 8, 4.0 * b + 3.0 * b * nocc
    if name == "df_j":
        return (b + 2 * nset * n2) * 8, 4.0 * nset * b
    return (b + nao * nocc + n2) * 8, 3.0 * b * nocc           # df_k


def k_library(B, C):
    """K of B and Cocc in one PyTorch call (timed beside df_k; the port
    never calls it). torch orders the contraction with opt_einsum where
    that package is installed, else left to right."""
    return torch.einsum("pik,ka,pjl,la->ij", B, C, B, C)


def device_inputs(naux, nao, nocc, seed, dtype, dev):
    """Large random inputs, made on the card from a seed."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    B = torch.randn((naux, nao, nao), generator=g, dtype=dtype, device=dev)
    C = torch.randn((nao, nocc), generator=g, dtype=dtype, device=dev)
    return B, 2 * C @ C.T, C


def rel_err(x, ref):
    return float((x - ref).abs().max() / ref.abs().max())
