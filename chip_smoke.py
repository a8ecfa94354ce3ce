#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port ``cctpu_torch`` on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one printed line or more each:

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
1. build the three hand-written CUDA kernels (one nvcc per source, all
   started together, into build/cctpu_torch/), and count the FP64
   tensor-core instructions (DMMA) in the SASS of the two W/K libraries;
2. the fused DF-J/K kernel against its plain torch version on the card at
   cctpu's three Pallas test shapes and at phenol's shape, in f64 (<= 1e-12
   relative max error) and f32 (<= 1e-5), and in f64 at an odd nao and at a
   C32H66-sized row (the plan whose W_p fits no shared memory), repeat
   calls bitwise equal, and kernel vs plain median times at phenol's shape
   (f64, CUDA events) with the launch plan (ops/plan.py) and the ptxas
   report of the f64 tensor-core instantiations;
2a. the DF-J kernels (one and two densities) and the DF-K kernel against
   their plain versions at the same shapes and at C16H34's, f64 (<= 1e-12)
   and f32 (<= 1e-5), repeats bitwise equal, a zero Cocc column giving
   K = 0, df_j's plan (ops/plan.py::j_plan: one pass, or at C16H34 two),
   kernel and plain times (alternated) at phenol's shape;
3. phenol DF-B3LYP/6-31G* (grid level 2, conv_tol 1e-10) through the Python
   API, against cctpu's host-f64 oracle (|dE| <= 1e-8 Ha), with the
   kernels' launch counts reset before and read after the SCF;
3b. the phenoxyl radical DF-UB3LYP/6-31G* (phenol without the hydroxyl H,
   spin 1) against its oracle (<= 1e-8 Ha), <S^2>, DF-J launched every
   cycle (its one-pass plan), DF-K twice a cycle, the fused kernel never;
   DF-J and DF-K timed at this SCF's own tensors;
3c. the H atom UB3LYP/6-31G* at the removed H's position (nbeta 0)
   against its oracle, and the phenol O-H bond dissociation energy;
3d. phenol DF-BLYP/6-31G* (pure GGA: J without K) against its oracle;
4. C16H34/6-31G*: energy of the unrelaxed SAD density from one Fock build
   against cctpu's oracle (<= 1e-6 Ha); J/K, J (two densities and one,
   DF-J's two-pass plan) and K call times at this shape;
5. the ``energy`` CLI on phenol's SMILES with ``--density-fit``;
5b. the ``energy`` CLI on the phenoxyl radical with ``--spin 1``.

Any failure raises: the script then exits non-zero without its last line.
The line before the last lists each kernel with its launches on the main
path, its error, its time beside its plain version's and its bound; the
last line is ``{"ok": true, "device": {...}}``. Needs no network and
imports nothing of JAX or of the JAX package.
"""

import json
import os
import subprocess
import tempfile
import time

import numpy as np

# cctpu's host-f64 oracles (scripts/sad_oracles.json)
PHENOL_E_CONV = -307.45793638428           # DF-B3LYP/6-31G*, grid level 2
C16H34_E_SAD = -649.7264470874134          # SAD density, one Fock build
# cctpu's host-f64 oracles of the open-shell slice, made on the CPU with
# cctpu's f64 path (JAX on the CPU, x64 on), all DF, 6-31G*, grid level 2,
# conv_tol 1e-10, with the geometries below:
#   cctpu.dft.rks.UKS(Molecule.from_atoms(PHENOXYL, spin=1,
#       basis="6-31g*"), xc="b3lyp", density_fit=True, grid_level=2,
#       conv_tol=1e-10).kernel()        (19 cycles, <S^2> 0.78362916)
#   the same with H_ATOM                (8 cycles, <S^2> 0.75)
#   cctpu.dft.rks.RKS(Molecule.from_atoms(PHENOL, basis="6-31g*"),
#       xc="blyp", density_fit=True, grid_level=2,
#       conv_tol=1e-10).kernel()        (13 cycles)
PHENOXYL_E_CONV = -306.8112830449618       # DF-UB3LYP, spin 1
H_ATOM_E_CONV = -0.5002727849165448        # DF-UB3LYP, spin 1 (nbeta 0)
PHENOL_BLYP_E_CONV = -307.3327949020669    # DF-BLYP (RKS, pure GGA)
HARTREE2KCAL = 627.5094740631

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


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() over reps runs, CUDA events."""
    import torch
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
    the symmetric K = sum_p W_p^T W_p (half of the square)."""
    b, n2 = naux * nao * nao, nao * nao
    if name == "df_jk_fused":
        return (b + n2 + nao * nocc + 2 * n2) * 8, 4.0 * b + 3.0 * b * nocc
    if name == "df_j":
        return (b + 2 * nset * n2) * 8, 4.0 * nset * b
    return (b + nao * nocc + n2) * 8, 3.0 * b * nocc           # df_k


def k_library(B, C):
    """K of B and Cocc in one PyTorch call (timed beside df_k; the port
    never calls it). torch orders the contraction with opt_einsum where
    that package is installed, else left to right."""
    import torch
    return torch.einsum("pik,ka,pjl,la->ij", B, C, B, C)


def jk_inputs(naux, nao, nocc, seed, dtype, dev):
    import torch
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((naux, nao, nao))
    C = rng.standard_normal((nao, nocc))
    D = 2 * C @ C.T
    return tuple(torch.as_tensor(x, dtype=dtype, device=dev)
                 for x in (B, D, C))


def device_inputs(naux, nao, nocc, seed, dtype, dev):
    """Large random inputs, made on the card from a seed."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    B = torch.randn((naux, nao, nao), generator=g, dtype=dtype, device=dev)
    C = torch.randn((nao, nocc), generator=g, dtype=dtype, device=dev)
    return B, 2 * C @ C.T, C


def rel_err(x, ref):
    return float((x - ref).abs().max() / ref.abs().max())


def wk_report(module, lib: str) -> dict:
    """The plan of ``module``'s last launch and the ptxas registers and
    spills of the f64 tensor-core instantiations of library ``lib``."""
    from cctpu_torch.ops import build
    return {"plan": module.LAST_PLAN,
            "ptxas_f64": build.ptxas_report(lib, "wk_mma")}


def ops():
    from cctpu_torch.ops import df_j, df_jk, df_k
    return {"df_jk_fused": df_jk, "df_j": df_j, "df_k": df_k}


def reset_counts():
    for m in ops().values():
        m.LAUNCHES = 0


def counts() -> dict:
    return {name: m.LAUNCHES for name, m in ops().items()}


def phase_kernel(df_jk, dev):
    """Kernel vs plain torch at the four shapes; returns phenol numbers."""
    import torch
    out = {}
    for naux, nao, nocc in KERNEL_SHAPES + F64_SHAPES:
        for dtype in (torch.float64, torch.float32):
            if (naux, nao, nocc) in F64_SHAPES and dtype != torch.float64:
                continue
            make = device_inputs if nao >= 600 else jk_inputs
            B, D, C = make(naux, nao, nocc, naux, dtype, dev)
            J, K = df_jk.df_jk_fused(B, D, C)
            J2, K2 = df_jk.df_jk_fused(B, D, C)
            Jr, Kr = df_jk.df_jk_reference(B, D, C)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[-1]
            ej, ek = rel_err(J, Jr), rel_err(K, Kr)
            bitwise = bool(torch.equal(J, J2) and torch.equal(K, K2))
            max_abs = float(max((J - Jr).abs().max(), (K - Kr).abs().max()))
            emit({"phase": "kernel", "shape": [naux, nao, nocc],
                  "dtype": name, "rel_err_J": ej, "rel_err_K": ek,
                  "max_abs_err": max_abs, "bitwise_repeat": bitwise,
                  "tol": TOL[name], "plan": df_jk.LAST_PLAN["kind"]})
            check(max(ej, ek) <= TOL[name],
                  f"kernel disagrees at {naux}/{nao}/{nocc} {name}")
            check(bitwise, f"repeat calls differ at {naux}/{nao}/{nocc}")
            if (naux, nao, nocc) == KERNEL_SHAPES[-1] \
                    and dtype == torch.float64:
                out["max_abs_err"] = max_abs
                out.update(alternated_ms(
                    lambda: df_jk.df_jk_fused(B, D, C),
                    lambda: df_jk.df_jk_reference(B, D, C), 10))
                out.update(bound(*work("df_jk_fused", naux, nao, nocc)))
                emit({"phase": "kernel_time", "shape": [naux, nao, nocc],
                      "dtype": name, "kernel_ms": out["kernel_ms_rounds"],
                      "plain_ms": out["plain_ms_rounds"],
                      "bound_ms": out["bound_ms"],
                      **wk_report(df_jk, "df_jk_fused")})
            del B, D, C, J, K, J2, K2, Jr, Kr
            torch.cuda.empty_cache()
    return out


def phase_kernel_j_k(dev):
    """DF-J (nset 1 and 2) and DF-K vs their plain versions at the five
    shapes, f64 and f32; kernel vs plain times at phenol's shape (f64)."""
    import torch
    from cctpu_torch.ops import df_j, df_k
    for shape in KERNEL_SHAPES + F64_SHAPES + [C16H34_SHAPE]:
        naux, nao, nocc = shape
        for dtype in (torch.float64, torch.float32):
            if shape in F64_SHAPES and dtype != torch.float64:
                continue
            name = str(dtype).split(".")[-1]
            make = device_inputs if nao >= 292 else jk_inputs
            B, D, C = make(naux, nao, nocc, naux + 7, dtype, dev)
            D2 = torch.stack([D, D @ D / D.abs().max()])
            J1 = df_j.df_j_fast(B, D)
            plan_j = [df_j.LAST_PLAN["kind"]]
            J2 = df_j.df_j_fast(B, D2)
            plan_j.append(df_j.LAST_PLAN["kind"])
            K = df_k.df_k_fast(B, C)
            bitwise = bool(torch.equal(J1, df_j.df_j_fast(B, D))
                           and torch.equal(J2, df_j.df_j_fast(B, D2))
                           and torch.equal(K, df_k.df_k_fast(B, C)))
            zero = torch.zeros((nao, 1), dtype=dtype, device=dev)
            k_zero = int(torch.count_nonzero(df_k.df_k_fast(B, zero)))
            J1r = df_j.df_j_reference(B, D)
            J2r = df_j.df_j_reference(B, D2)
            Kr = df_k.df_k_reference(B, C)
            torch.cuda.synchronize()
            errs = {"rel_err_J1": rel_err(J1, J1r),
                    "rel_err_J2": max(rel_err(J2[s], J2r[s])
                                      for s in range(2)),
                    "rel_err_K": rel_err(K, Kr)}
            emit({"phase": "kernel_j_k", "shape": list(shape),
                  "dtype": name, **errs, "bitwise_repeat": bitwise,
                  "k_of_zero_cocc_nonzeros": k_zero, "tol": TOL[name],
                  "plan": df_k.LAST_PLAN["kind"], "plan_df_j": plan_j})
            check(max(errs.values()) <= TOL[name],
                  f"df_j/df_k disagree at {shape} {name}: {errs}")
            check(bitwise, f"df_j/df_k repeat calls differ at {shape}")
            check(k_zero == 0, "df_k of a zero Cocc column is not 0")
            if shape == KERNEL_SHAPES[-1] and dtype == torch.float64:
                tj = alternated_ms(lambda: df_j.df_j_fast(B, D2),
                                   lambda: df_j.df_j_reference(B, D2), 10)
                tk = alternated_ms(lambda: df_k.df_k_fast(B, C),
                                   lambda: df_k.df_k_reference(B, C), 10)
                emit({"phase": "kernel_j_k_time", "shape": list(shape),
                      "dtype": name, "df_j_nset2_ms": tj,
                      "df_k_ms": tk, **wk_report(df_k, "df_k")})
            del B, D, C, D2, J1, J2, K, J1r, J2r, Kr
            torch.cuda.empty_cache()


def run_scf(cls, atoms, dev, spin=0, **kw):
    """One SCF through the Python API with the kernels' launch counts reset
    just before and read just after; returns (mf, E, seconds, counts)."""
    import torch
    from cctpu_torch.core.molecule import Molecule
    mol = Molecule.from_atoms(atoms, spin=spin, basis="6-31g*")
    t0 = time.time()
    mf = cls(mol, density_fit=True, grid_level=2, conv_tol=1e-10,
             max_cycle=60, device=dev, **kw)
    t_grid = time.time() - t0
    t0 = time.time()
    mf.get_jk_builder()
    torch.cuda.synchronize()
    t_df = time.time() - t0
    t0 = time.time()
    mf._prepare_xc_f64()
    torch.cuda.synchronize()
    t_ao = time.time() - t0
    reset_counts()
    t0 = time.time()
    e = mf.kernel()
    torch.cuda.synchronize()
    t_scf = time.time() - t0
    launches = counts()
    info = {"E": e, "converged": mf.converged, "cycles": mf.n_cycles,
            "s_per_cycle": t_scf / mf.n_cycles, "scf_s": t_scf,
            "grids_s": t_grid, "df_build_s": t_df, "ao_cache_s": t_ao,
            "nao": mol.nao, "naux": int(mf._jk.B.shape[0]),
            "launches": launches}
    return mf, e, info


def phase_phenol(dev):
    from cctpu_torch.dft.rks import RKS
    mf, e, info = run_scf(RKS, PHENOL, dev, xc="b3lyp")
    de = abs(e - PHENOL_E_CONV)
    launches = info["launches"]
    emit({"phase": "phenol_b3lyp_631gs", "abs_dE_vs_oracle": de, **info})
    check(mf.converged, "phenol SCF did not converge")
    check(de <= 1e-8, f"phenol |dE| {de:.3e} > 1e-8 Ha")
    check(launches["df_jk_fused"] >= mf.n_cycles,
          f"fused kernel launched {launches} in {mf.n_cycles} cycles")
    return e, launches["df_jk_fused"]


def phase_phenoxyl(dev):
    """DF-UB3LYP of the phenoxyl radical; then the J and K kernels timed
    and checked at this SCF's own B, densities and occupied factors."""
    import torch
    from cctpu_torch.dft.rks import UKS
    from cctpu_torch.ops import df_j, df_k
    mf, e, info = run_scf(UKS, PHENOXYL, dev, spin=1, xc="b3lyp")
    de = abs(e - PHENOXYL_E_CONV)
    s2 = mf.spin_square()[0]
    n = info["launches"]
    emit({"phase": "phenoxyl_ub3lyp_631gs", "abs_dE_vs_oracle": de,
          "S2": s2, "nalpha": mf.mol.nalpha, "nbeta": mf.mol.nbeta, **info})
    check(mf.converged, "phenoxyl SCF did not converge")
    check(de <= 1e-8, f"phenoxyl |dE| {de:.3e} > 1e-8 Ha")
    check(n["df_j"] >= mf.n_cycles and n["df_k"] >= 2 * mf.n_cycles
          and n["df_jk_fused"] == 0,
          f"phenoxyl launches {n} in {mf.n_cycles} cycles")
    check(df_j.LAST_PLAN["kind"] == "one_pass",
          f"phenoxyl's SCF ran df_j's {df_j.LAST_PLAN['kind']} plan")

    B = mf._jk.B
    dm = mf.dm.contiguous()
    cocc = mf._factor_cocc(dm)
    naux, nao = int(B.shape[0]), int(B.shape[1])
    J, Jr = df_j.df_j_fast(B, dm), df_j.df_j_reference(B, dm)
    K, Kr = df_k.df_k_fast(B, cocc[0]), df_k.df_k_reference(B, cocc[0])
    torch.cuda.synchronize()
    out = {
        "df_j": {"max_abs_err": float((J - Jr).abs().max()),
                 "rel_err": rel_err(J, Jr),
                 **alternated_ms(
                     lambda: df_j.df_j_fast(B, dm),
                     lambda: df_j.df_j_reference(B, dm), 20,
                     library=lambda: torch.einsum("pij,sij,pkl->skl",
                                                  B, dm, B)),
                 **bound(*work("df_j", naux, nao, nset=2))},
        "df_k": {"max_abs_err": float((K - Kr).abs().max()),
                 "rel_err": rel_err(K, Kr),
                 **alternated_ms(
                     lambda: df_k.df_k_fast(B, cocc[0]),
                     lambda: df_k.df_k_reference(B, cocc[0]), 20,
                     library=lambda: k_library(B, cocc[0])),
                 **bound(*work("df_k", naux, nao, int(cocc[0].shape[1])))}}
    for name in ("df_j", "df_k"):
        out[name]["launches"] = n[name]
    emit({"phase": "phenoxyl_kernel_time", "naux": naux, "nao": nao,
          "nocc": [int(c.shape[1]) for c in cocc],
          "opt_einsum": torch.backends.opt_einsum.is_available(),
          "rel_err_K_library": rel_err(k_library(B, cocc[0]), Kr),
          "rel_err_J_per_spin": [rel_err(J[s], Jr[s]) for s in range(2)],
          "max_abs_J": float(Jr.abs().max()), **out,
          **wk_report(df_k, "df_k")})
    for name in ("df_j", "df_k"):
        check(out[name]["rel_err"] <= TOL["float64"],
              f"{name} disagrees at phenoxyl's tensors")
    return e, out


def phase_h_atom(dev, e_phenol, e_phenoxyl):
    from cctpu_torch.dft.rks import UKS
    mf, e, info = run_scf(UKS, H_ATOM, dev, spin=1, xc="b3lyp")
    de = abs(e - H_ATOM_E_CONV)
    bde = (e_phenoxyl + e - e_phenol) * HARTREE2KCAL
    emit({"phase": "h_atom_ub3lyp_631gs", "abs_dE_vs_oracle": de,
          "S2": mf.spin_square()[0], "nbeta": mf.mol.nbeta, **info})
    emit({"phase": "phenol_OH_bde", "kcal_mol": bde,
          "E_phenol": e_phenol, "E_phenoxyl": e_phenoxyl, "E_H": e})
    check(mf.converged, "H atom SCF did not converge")
    check(de <= 1e-8, f"H atom |dE| {de:.3e} > 1e-8 Ha")
    check(np.isfinite(bde) and 50.0 < bde < 120.0,
          f"phenol O-H BDE {bde:.2f} kcal/mol is not physical")


def phase_phenol_blyp(dev):
    from cctpu_torch.dft.rks import RKS
    from cctpu_torch.ops import df_j
    mf, e, info = run_scf(RKS, PHENOL, dev, xc="blyp")
    de = abs(e - PHENOL_BLYP_E_CONV)
    n = info["launches"]
    emit({"phase": "phenol_blyp_631gs", "abs_dE_vs_oracle": de, **info})
    check(mf.converged, "phenol BLYP SCF did not converge")
    check(de <= 1e-8, f"phenol BLYP |dE| {de:.3e} > 1e-8 Ha")
    check(n["df_j"] >= mf.n_cycles and n["df_k"] == 0
          and n["df_jk_fused"] == 0,
          f"phenol BLYP launches {n} in {mf.n_cycles} cycles")
    check(df_j.LAST_PLAN["kind"] == "one_pass",
          f"phenol BLYP's SCF ran df_j's {df_j.LAST_PLAN['kind']} plan")


def phase_c16h34(dev):
    import torch
    from cctpu_torch.core.molecule import Molecule
    from cctpu_torch.dft.rks import RKS
    from cctpu_torch.ops import df_j, df_jk, df_k
    mol = Molecule.from_atoms(alkane(16), basis="6-31g*")
    t0 = time.time()
    mf = RKS(mol, xc="b3lyp", density_fit=True, grid_level=2, device=dev)
    mf.get_jk_builder()
    mf._prepare_xc_f64()
    torch.cuda.synchronize()
    t_build = time.time() - t0
    dm = mf.init_guess_dm()
    cocc = mf._factor_cocc(dm)
    veff, e2 = mf.get_veff(dm, cocc=cocc)
    ints = mf.build_ints()
    e1 = float(torch.einsum("ij,ij->", dm, ints["T"] + ints["V"]))
    e = e1 + float(e2) + mol.energy_nuc()
    de = abs(e - C16H34_E_SAD)
    B = mf._jk.B
    J, K = df_jk.df_jk_fused(B, dm, cocc)
    Jr, Kr = df_jk.df_jk_reference(B, dm, cocc)
    ej, ek = rel_err(J, Jr), rel_err(K, Kr)
    plan_fused = df_jk.LAST_PLAN
    ej1 = rel_err(df_j.df_j_fast(B, dm), Jr)
    plan_j = df_j.LAST_PLAN
    ek1 = rel_err(df_k.df_k_fast(B, cocc), Kr)
    del J, K, Jr, Kr
    k1 = cuda_ms(lambda: df_jk.df_jk_fused(B, dm, cocc), 3)
    p1 = cuda_ms(lambda: df_jk.df_jk_reference(B, dm, cocc), 3)
    dm2 = torch.stack([dm, dm]) * 0.5
    tj = alternated_ms(lambda: df_j.df_j_fast(B, dm2),
                       lambda: df_j.df_j_reference(B, dm2), 3,
                       library=lambda: torch.einsum("pij,sij,pkl->skl",
                                                    B, dm2, B))
    plan_j2 = df_j.LAST_PLAN
    tj1 = alternated_ms(lambda: df_j.df_j_fast(B, dm),
                        lambda: df_j.df_j_reference(B, dm), 3,
                        library=lambda: torch.einsum("pij,ij,pkl->kl",
                                                     B, dm, B))
    tk = alternated_ms(lambda: df_k.df_k_fast(B, cocc),
                       lambda: df_k.df_k_reference(B, cocc), 3,
                       library=lambda: k_library(B, cocc))
    naux, nao, nocc = int(B.shape[0]), mol.nao, int(cocc.shape[1])
    emit({"phase": "c16h34_sad", "E_sad": e, "abs_dE_vs_oracle": de,
          "nao": nao, "naux": naux, "nocc": nocc, "build_s": t_build,
          "jk_kernel_ms": k1, "jk_plain_ms": p1,
          "jk_bound_ms": bound(*work("df_jk_fused", naux, nao,
                                     nocc))["bound_ms"],
          "kernel_rel_err_J": ej, "kernel_rel_err_K": ek,
          "df_j_nset2": {**tj, **bound(*work("df_j", naux, nao, nset=2))},
          "df_j_nset1": {**tj1, **bound(*work("df_j", naux, nao, nset=1))},
          "plan_df_j": plan_j2, "plan_df_j_nset1": plan_j,
          "df_k": {**tk, **bound(*work("df_k", naux, nao, nocc))},
          "df_j_rel_err": ej1, "df_k_rel_err": ek1,
          "plan_fused": plan_fused, "plan_df_k": df_k.LAST_PLAN,
          "ptxas_f64": wk_report(df_jk, "df_jk_fused")["ptxas_f64"],
          "peak_mem_GB": torch.cuda.max_memory_allocated(dev) / 1e9})
    check(np.isfinite(e) and de <= 1e-6, f"C16H34 SAD |dE| {de:.3e} > 1e-6")
    check(max(ej, ek, ej1, ek1) <= 1e-12,
          "a kernel disagrees at the C16H34 shape")
    check(plan_j["kind"] == plan_j2["kind"] == "two_pass",
          f"C16H34 ran df_j's {plan_j['kind']}/{plan_j2['kind']} plans")


def phase_cli(smiles, extra, tag, need):
    """The ``energy`` CLI through cli.main; ``need`` names the kernel that
    must have launched."""
    from cctpu_torch.workflows import cli
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        rc = cli.main(["energy", "--smiles", smiles, "--method", "b3lyp",
                       "--basis", "6-31g*", "--density-fit",
                       "--grid-level", "2", *extra, "--output-dir", tmp])
        wall = time.time() - t0
        reports = [f for f in os.listdir(tmp)
                   if f.endswith("_short_report.txt")]
        check(len(reports) == 1, f"{tag}: energy CLI wrote no short report")
        with open(os.path.join(tmp, reports[0])) as f:
            text = f.read()
    converged = "converged: True" in text
    n = counts()
    emit({"phase": tag, "rc": rc, "converged": converged, "launches": n,
          "wall_s": wall})
    check(rc == 0 and converged, f"{tag}: energy CLI did not converge")
    check(n[need] > 0, f"{tag}: energy CLI never reached {need}")


def main():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device")
    from cctpu_torch.ops import build, df_jk     # fails outside a checkout
    card = card_line()
    emit(card)
    emit({"phase": "card", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    dev = torch.device("cuda", 0)

    t0 = time.time()
    build.compile_all()
    for m in ops().values():
        m.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in build.BUILD_LOGS.items()}
    # the W and K products of the f64 W/K kernels issue the FP64 tensor-core
    # instruction (DMMA in the SASS of both libraries)
    dmma = {name: build.sass_count(name, "DMMA")
            for name in ("df_jk_fused", "df_k")}
    emit({"phase": "build", "seconds": time.time() - t0, "ptxas": ptxas,
          "sass_dmma": dmma})
    check(min(dmma.values()) > 0, f"no DMMA in a W/K library: {dmma}")

    fused = phase_kernel(df_jk, dev)
    phase_kernel_j_k(dev)
    e_phenol, fused["launches"] = phase_phenol(dev)
    torch.cuda.empty_cache()
    e_phenoxyl, jk = phase_phenoxyl(dev)
    torch.cuda.empty_cache()
    phase_h_atom(dev, e_phenol, e_phenoxyl)
    phase_phenol_blyp(dev)
    torch.cuda.empty_cache()
    phase_c16h34(dev)
    torch.cuda.empty_cache()
    phase_cli("Oc1ccccc1", [], "cli_energy", "df_jk_fused")
    phase_cli("[O]c1ccccc1", ["--spin", "1"], "cli_energy_spin1", "df_k")

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    rows = [("df_jk_fused", "cctpu_torch/ops/csrc/df_jk_fused.cu",
             "cctpu/ops/df_jk_pallas.py:167", fused),
            ("df_j", "cctpu_torch/ops/csrc/df_j.cu",
             "cctpu/ops/df_jk_pallas.py:46,53", jk["df_j"]),
            ("df_k", "cctpu_torch/ops/csrc/df_k.cu",
             "cctpu/ops/df_jk_pallas.py:66", jk["df_k"])]
    emit(card)
    emit({"kernels": [{"name": name, "route": "cuda", "source": src,
                       "replaces": rep, **{k: d[k] for k in keys}}
                      for name, src, rep, d in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
