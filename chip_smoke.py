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
3e. the DF nuclear gradient of phase 3's SCF, continued to conv_tol 1e-12
   and an orbital gradient <= 1e-8 (``cctpu_torch.grad.scf_grad``): two
   calls bitwise equal, the seconds of each call and of each term (1e, W/Z,
   3c, 2c, XC, nuclear), peak device memory, s/iter (phase 3's cycles x
   s/cycle + the second call's seconds, as ``bench.py`` defines it),
   translational invariance (<= 1e-8 Ha/bohr), central differences of the
   port's own energy (h = 1e-3 bohr, three components, <= 1e-6), cctpu's
   CPU-f64 gradient (<= 1e-7), and no J/K kernel launched by the
   gradient;
3f. the same for phase 3b's phenoxyl DF-UB3LYP (two FD components);
4. C16H34/6-31G*: energy of the unrelaxed SAD density from one Fock build
   against cctpu's oracle (<= 1e-6 Ha); J/K, J (two densities and one,
   DF-J's two-pass plan) and K call times at this shape;
5. the ``energy`` CLI on phenol's SMILES with ``--density-fit``;
5b. the ``energy`` CLI on the phenoxyl radical with ``--spin 1``;
6. water DF-RHF, water DF-B3LYP and NH2 DF-UB3LYP (6-31G*, grid level 2):
   SCF and gradient against cctpu's CPU-f64 gradients (<= 1e-7 Ha/bohr);
7. the 1e-8 Ha contract: water RHF/6-31G with Cholesky J/K
   (``density_fit="cd"``) at conv_tol 1e-12 against cctpu's host-f64
   oracle, the fused kernel every cycle; NH2 UB3LYP/6-31G* with Cholesky
   J/K (DF-J every cycle, DF-K twice) against its in-core SCF (<= 1e-8);
7b. phenol B3LYP/6-31G* in-core (grid level 2, conv_tol 1e-10) against
   cctpu's CPU-f64 in-core oracle (<= 1e-8 Ha): the ERI build's seconds
   and bytes, peak memory, s/cycle, no J/K kernel launched, and the DF
   fitting error |E_incore - E_DF| (printed, not gated);
7c. the same SCF with Cholesky J/K against 7b (<= 1e-8 Ha), the number
   of Cholesky vectors K, the fused kernel every cycle; the fused, DF-J
   (one and two densities) and DF-K kernels against their plain versions
   at this SCF's factor [K, nao, nao] (f64 <= 1e-12, repeats bitwise) with
   kernel, plain, library and bound times;
7d. the direct nuclear gradient of 7b's SCF, as 3e (no oracle: central
   differences, invariance, bitwise repeat, s/iter), and that of 7c's
   Cholesky SCF against it (<= 1e-7 Ha/bohr);
7e. phase 6's three cases in-core against cctpu's CPU-f64 in-core
   gradients (<= 1e-7 Ha/bohr; ``scripts/make_incore_oracles.py``);
7f. the ``energy`` CLI without ``--density-fit`` (the default route,
   in-core: no J/K kernel) on phenol and the phenoxyl radical, then on
   phenol twice with ``--scf-cache``: the second run warm-starts, takes
   fewer cycles and agrees (<= 1e-10 Ha).

Any failure raises: the script then exits non-zero without its last line.
The line before the last lists each kernel with its launches on the main
path, its error, its time beside its plain version's and its bound, and
its launches on the Cholesky phases (7, 7c) and its numbers at 7c's
factor; a ``clock`` line after each group of phases gives the seconds
since the start. The last line is ``{"ok": true, "device": {...}}``.
Needs no network and imports nothing of JAX or of the JAX package.
"""

import os
import tempfile
import time

import numpy as np

from cctpu_torch.utils.measure import (C16H34_SHAPE, F64_SHAPES, H_ATOM,
                                       KERNEL_SHAPES, NH2, PHENOL, PHENOXYL,
                                       TOL, WATER, alkane, alternated_ms,
                                       bound, card_line, cuda_ms,
                                       device_inputs, emit, k_library,
                                       rel_err, work)

# cctpu's host-f64 oracles (scripts/sad_oracles.json)
PHENOL_E_CONV = -307.45793638428           # DF-B3LYP/6-31G*, grid level 2
C16H34_E_SAD = -649.7264470874134          # SAD density, one Fock build
# cctpu's host-f64 oracles of the open-shell slice, made on the CPU with
# cctpu's f64 path (JAX on the CPU, x64 on), all DF, 6-31G*, grid level 2,
# conv_tol 1e-10, with the geometries of cctpu_torch/utils/measure.py:
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
# cctpu's host-f64 water RHF/6-31G energy with Cholesky J/K (tol 1e-9) at
# conv_tol 1e-12 (scripts/sad_oracles.json, make_oracles.py --cd)
WATER_CD_631G_E = -75.98397447271235

# cctpu's CPU-f64 DF nuclear gradients (Ha/bohr, atoms in the order of
# the geometries of cctpu_torch/utils/measure.py), as
# scripts/make_grad_oracles.py prints them: cctpu's own SCF on the CPU, f64,
# 6-31G*, DF, grid level 2, conv_tol 1e-12 and conv_tol_grad 1e-8
#   cctpu.scf.hf.RHF(Molecule.from_atoms(WATER, basis="6-31g*"),
#       density_fit=True, conv_tol=1e-12, conv_tol_grad=1e-8).kernel()
#   cctpu.dft.rks.RKS(..., xc="b3lyp", grid_level=2, ...) for water and
#   phenol, cctpu.dft.rks.UKS(..., spin=1, ...) for NH2 and phenoxyl
# then cctpu's gradient terms on that state with the W/Z assembly in f64
# (tests/test_torch_grad.py::cctpu_gradient_terms: jax.grad of the 1e
# Lagrangian, df_grad._wz_fn, _grad_3c, _grad_2c, jax.grad of
# exc_of_coords and of energy_nuc).
GRAD_ORACLES = {
    "water_rhf": [  # E -76.00910724668111, 17 cycles
        [-1.300118072847e-15, -7.605959387095e-15, 1.533059763857e-02],
        [3.610124625890e-16, 7.549648962516e-03, -7.665298819289e-03],
        [9.391056102516e-16, -7.549648962507e-03, -7.665298819284e-03],
    ],
    "water_b3lyp": [  # E -76.40680895083193, 11 cycles
        [-1.695622886898e-15, -6.508946484266e-15, -1.334129928567e-02],
        [4.918640799434e-16, -8.075329095749e-03, 6.670649642828e-03],
        [9.322041531722e-16, 8.075329095760e-03, 6.670649642835e-03],
    ],
    "nh2_ub3lyp": [  # E -55.87099329938432, 13 cycles
        [9.339794694304e-16, -2.837753140487e-15, 1.051084907173e-02],
        [-3.371703865472e-16, -4.967647857019e-03, -5.255424535868e-03],
        [-3.308915293584e-16, 4.967647857018e-03, -5.255424535868e-03],
    ],
    "phenol_b3lyp": [  # E -307.4579363842764, 28 cycles
        [-1.018994204228e-02, -2.581698375805e-03, 8.271790139666e-16],
        [-3.665335851295e-04, 9.471976053186e-03, -2.458738201980e-15],
        [3.926002036542e-03, -2.421311207539e-03, 1.519661523331e-15],
        [-5.506845270997e-04, 1.664537105594e-03, -6.329518923870e-16],
        [-6.596055348907e-03, -4.257392298044e-03, -1.148741616590e-15],
        [6.383750075623e-03, 1.457060415189e-04, -7.868266487555e-16],
        [-5.411729583405e-03, -8.406784474742e-03, -8.201750286209e-17],
        [1.583461286211e-02, 8.707278880831e-03, -2.871180615716e-16],
        [-2.105424047995e-03, -1.904117267316e-03, 4.236041959063e-16],
        [-1.224265621893e-03, 8.267799524253e-05, -1.846844719162e-16],
        [-1.725298385953e-04, 2.439917793365e-03, 1.221903678751e-16],
        [1.185871784454e-03, -3.878735231395e-04, -2.064647238408e-16],
        [-7.130721635820e-04, -2.552916723191e-03, 1.646705984085e-16],
    ],
    "phenoxyl_ub3lyp": [  # E -306.8112830449596, 38 cycles
        [-2.490626359290e-14, -8.668874262455e-02, 1.511485861179e-15],
        [-2.140875416551e-02, 2.281653153176e-02, -1.445921906585e-15],
        [-5.053817671882e-03, -1.048776882051e-02, -3.527424918998e-16],
        [9.103559789532e-14, 1.894213986636e-03, -1.864792459099e-15],
        [5.053817671842e-03, -1.048776882064e-02, 2.127959066856e-15],
        [2.140875416553e-02, 2.281653153174e-02, -4.021560814882e-16],
        [1.014899638455e-14, 6.278018882143e-02, -1.645638010138e-15],
        [1.764181194068e-03, -2.959050883822e-03, 9.549206603493e-17],
        [-8.656971850147e-04, 3.707586080817e-04, 1.150757638468e-16],
        [-5.999852481841e-14, 2.533398945537e-03, -1.599865692949e-16],
        [8.656971849588e-04, 3.707586081474e-04, -1.714855791982e-17],
        [-1.764181194071e-03, -2.959050883824e-03, 2.001100869891e-16],
    ],
}

# cctpu's CPU-f64 in-core energies and gradients (Ha, Ha/bohr; atoms in the
# order of the geometries of cctpu_torch/utils/measure.py), as
# scripts/make_incore_oracles.py prints them: cctpu's own in-core SCF
# (density_fit=False) on the CPU, f64, 6-31G*, grid level 2; the phenol
# energy at conv_tol 1e-10, the gradients at conv_tol 1e-12 and
# conv_tol_grad 1e-8 with the direct 2e term (energy_2e_grad_eager)
INCORE_ORACLES = {
    "phenol_b3lyp_e": -307.4579388407727,  # 13 cycles
    "water_rhf": [  # E -76.00910803237772, 13 cycles
        [6.069051815553e-18, -5.593012500372e-16, 1.533057327717e-02],
        [-1.670947013622e-16, 7.549448002473e-03, -7.665286638586e-03],
        [1.610256495467e-16, -7.549448002474e-03, -7.665286638585e-03],
    ],
    "water_b3lyp": [  # E -76.40680806839366, 12 cycles
        [1.593011044092e-16, -8.558997566528e-16, -1.334051657107e-02],
        [1.547310024151e-16, -8.075190183554e-03, 6.670258285535e-03],
        [-1.112955319600e-16, 8.075190183554e-03, 6.670258285535e-03],
    ],
    "nh2_ub3lyp": [  # E -55.87099286186214, 11 cycles
        [-4.989477434641e-16, -9.008847994253e-16, 1.051038136688e-02],
        [-2.406550481914e-17, -4.967530979394e-03, -5.255190683439e-03],
        [-1.949822515900e-17, 4.967530979396e-03, -5.255190683440e-03],
    ],
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def jk_inputs(naux, nao, nocc, seed, dtype, dev):
    import torch
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((naux, nao, nao))
    C = rng.standard_normal((nao, nocc))
    D = 2 * C @ C.T
    return tuple(torch.as_tensor(x, dtype=dtype, device=dev)
                 for x in (B, D, C))


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


def run_scf(cls, atoms, dev, spin=0, density_fit=True, basis="6-31g*",
            conv_tol=1e-10, **kw):
    """One SCF through the Python API with the kernels' launch counts reset
    just before and read just after; returns (mf, E, info). ``df_build_s``
    is the J/K builder's build (DF tensors, the in-core tensor or the
    Cholesky factor); ``peak_mem_GB`` the card's peak over set-up and
    SCF."""
    import torch
    from cctpu_torch.core.molecule import Molecule
    mol = Molecule.from_atoms(atoms, spin=spin, basis=basis)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    mf = cls(mol, density_fit=density_fit, grid_level=2, conv_tol=conv_tol,
             max_cycle=60, device=dev, **kw)
    t_grid = time.time() - t0
    t0 = time.time()
    mf.get_jk_builder()
    torch.cuda.synchronize()
    t_df = time.time() - t0
    t0 = time.time()
    if hasattr(mf, "_prepare_xc_f64"):                 # RKS, UKS
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
            "nao": mol.nao, "density_fit": density_fit,
            "launches": launches,
            "peak_mem_GB": torch.cuda.max_memory_allocated(dev) / 1e9}
    if hasattr(mf._jk, "B"):
        info["naux"] = int(mf._jk.B.shape[0])
    return mf, e, info


def scf_kernels(mf, names) -> dict:
    """The named kernels against their plain versions at an SCF's own
    factor B [naux, nao, nao], density and occupied factor (f64, <= 1e-12
    relative, repeats bitwise equal), with kernel / plain / library /
    bound times. ``df_j`` takes two densities: an open-shell SCF's two
    spins, else the density and a second one made from it; ``df_j_nset1``
    the (alpha) density alone; ``df_k`` the (alpha) occupied factor."""
    import torch
    from cctpu_torch.ops import df_j, df_jk, df_k
    B = mf._jk.B
    dm = mf.dm.contiguous()
    C = mf._factor_cocc(dm)
    if dm.dim() == 3:
        D1, D2, C = dm[0], dm, C[0]
    else:
        D1, D2 = dm, torch.stack([dm, dm @ dm / dm.abs().max()]).contiguous()
    naux, nao, nocc = int(B.shape[0]), int(B.shape[1]), int(C.shape[1])
    calls = {
        "df_jk_fused": (lambda: df_jk.df_jk_fused(B, D1, C),
                        lambda: df_jk.df_jk_reference(B, D1, C), None,
                        work("df_jk_fused", naux, nao, nocc)),
        "df_j": (lambda: df_j.df_j_fast(B, D2),
                 lambda: df_j.df_j_reference(B, D2),
                 lambda: torch.einsum("pij,sij,pkl->skl", B, D2, B),
                 work("df_j", naux, nao, nset=2)),
        "df_j_nset1": (lambda: df_j.df_j_fast(B, D1),
                       lambda: df_j.df_j_reference(B, D1),
                       lambda: torch.einsum("pij,ij,pkl->kl", B, D1, B),
                       work("df_j", naux, nao, nset=1)),
        "df_k": (lambda: df_k.df_k_fast(B, C),
                 lambda: df_k.df_k_reference(B, C), lambda: k_library(B, C),
                 work("df_k", naux, nao, nocc))}
    out = {}
    for name in names:
        kern, plain, lib, wk = calls[name]
        got, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        got, again, ref = (x if isinstance(x, tuple) else (x,)
                           for x in (got, again, ref))
        rel = max(rel_err(a, b) for a, b in zip(got, ref))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        out[name] = {"max_abs_err": max(float((a - b).abs().max())
                                        for a, b in zip(got, ref)),
                     "rel_err": rel, "bitwise_repeat": bitwise,
                     **alternated_ms(kern, plain, 20, library=lib),
                     **bound(*wk)}
        if name.startswith("df_j"):
            out[name]["plan"] = df_j.LAST_PLAN["kind"]
        check(rel <= TOL["float64"] and bitwise,
              f"{name} at {mf.__class__.__name__}'s [{naux}, {nao}, {nocc}] "
              f"factor: rel {rel:.2e}, bitwise {bitwise}")
    return out


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
    return e, launches["df_jk_fused"], mf, info


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

    out = scf_kernels(mf, ("df_j", "df_k"))
    for name in ("df_j", "df_k"):
        out[name]["launches"] = n[name]
    B, dm = mf._jk.B, mf.dm.contiguous()
    cocc = mf._factor_cocc(dm)
    J, Jr = df_j.df_j_fast(B, dm), df_j.df_j_reference(B, dm)
    Kr = df_k.df_k_reference(B, cocc[0])
    emit({"phase": "phenoxyl_kernel_time", "naux": int(B.shape[0]),
          "nao": int(B.shape[1]), "nocc": [int(c.shape[1]) for c in cocc],
          "opt_einsum": torch.backends.opt_einsum.is_available(),
          "rel_err_K_library": rel_err(k_library(B, cocc[0]), Kr),
          "rel_err_J_per_spin": [rel_err(J[s], Jr[s]) for s in range(2)],
          "max_abs_J": float(Jr.abs().max()), **out,
          **wk_report(df_k, "df_k")})
    return e, out, mf, info


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


def fd_gradient(mf, comps, h=1e-3):
    """Central differences of the port's card energy at components
    ``comps`` [(atom, axis)]: SCFs of ``mf``'s kind at +-h bohr, warm
    started from ``mf.dm``, at conv_tol 1e-12."""
    mol = mf.mol
    kw = {} if getattr(mf, "func", None) is None else dict(xc=mf.xc)
    out = []
    for ia, ax in comps:
        e = []
        for sgn in (1.0, -1.0):
            c = mol.coords.copy()
            c[ia, ax] += sgn * h
            m2 = type(mf)(mol.with_coords(c), density_fit=mf.density_fit,
                          grid_level=2, conv_tol=1e-12, max_cycle=60,
                          device=mf.device, **kw)
            e.append(m2.kernel(dm0=mf.dm))
            check(m2.converged, f"FD SCF at {ia},{ax} did not converge")
        out.append((e[0] - e[1]) / (2 * h))
    return out


def phase_gradient(tag, mf, info, fd_comps, oracle):
    """The DF nuclear gradient of phase ``info``'s SCF ``mf``, continued
    from its density to conv_tol 1e-12 and an orbital gradient <= 1e-8:
    two calls (bitwise equal), per-term seconds, peak device memory,
    s/iter, translational invariance, central differences at ``fd_comps``
    and cctpu's oracle. The J/K kernels' launch counts are
    reset before the gradient and must stay 0: it launches none of them."""
    import torch
    from cctpu_torch.grad.scf_grad import gradient
    from cctpu_torch.utils.profiling import PhaseTimer
    dev = mf.device
    mf.opts.conv_tol, mf.opts.conv_tol_grad = 1e-12, 1e-8
    mf.kernel(dm0=mf.dm)
    check(mf.converged, f"{tag}: the SCF did not converge to 1e-12")
    reset_counts()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    calls = []
    for _ in range(2):
        timer = PhaseTimer(dev)
        t0 = time.time()
        g = gradient(mf, timer)
        torch.cuda.synchronize(dev)
        calls.append((g, time.time() - t0, timer.phases))
    peak = torch.cuda.max_memory_allocated(dev)
    launches = counts()
    (g1, s1, terms1), (g2, s2, terms2) = calls
    bitwise = bool(torch.equal(g1, g2))
    g = g1.cpu().numpy()
    inv = float(np.abs(g.sum(0)).max())
    fd = fd_gradient(mf, fd_comps) if fd_comps else []
    fd_err = [abs(float(g[ia, ax]) - f) for (ia, ax), f in zip(fd_comps, fd)]
    orc_err = None if oracle is None \
        else float(np.abs(g - np.asarray(oracle)).max())
    res = {"phase": tag, "card": card_line(), "E": mf.e_tot,
           "cycles_to_1e-12": mf.n_cycles, "grad_s_first": s1,
           "grad_s": s2, "terms_s_first": terms1, "terms_s": terms2,
           "peak_mem_GB": peak / 1e9, "bitwise_repeat": bitwise,
           "max_abs_sum_g": inv, "fd_components": fd_comps,
           "fd": fd, "abs_err_fd": fd_err, "abs_err_vs_cctpu": orc_err,
           "launches_in_gradient": launches, "gradient": g.tolist()}
    if info is not None:
        res["s_per_iter"] = info["cycles"] * info["s_per_cycle"] + s2
        res["scf_cycles"], res["scf_s_per_cycle"] = \
            info["cycles"], info["s_per_cycle"]
    emit(res)
    check(np.isfinite(g).all() and g.shape == (mf.mol.natm, 3),
          f"{tag}: gradient not finite or of the wrong shape")
    check(bitwise, f"{tag}: two gradient calls differ")
    check(inv <= 1e-8, f"{tag}: max |sum_A g_A| {inv:.2e} > 1e-8")
    check(max(fd_err, default=0.0) <= 1e-6,
          f"{tag}: |g - FD| {fd_err} > 1e-6")
    check(orc_err is None or orc_err <= 1e-7,
          f"{tag}: |g - cctpu| {orc_err} > 1e-7")
    check(not any(launches.values()),
          f"{tag}: the gradient launched J/K kernels {launches}")
    return res


def phase_small_gradients(dev, density_fit=True):
    """Water RHF, water B3LYP and NH2 UB3LYP (6-31G*, grid level 2), DF or
    in-core: SCF and gradient on the card against cctpu's CPU-f64
    gradients."""
    from cctpu_torch.dft.rks import RKS, UKS
    from cctpu_torch.scf.hf import RHF
    route, oracles = ("", GRAD_ORACLES) if density_fit \
        else ("incore_", INCORE_ORACLES)
    for tag, cls, atoms, spin, kw in (
            ("water_rhf", RHF, WATER, 0, {}),
            ("water_b3lyp", RKS, WATER, 0, dict(xc="b3lyp")),
            ("nh2_ub3lyp", UKS, NH2, 1, dict(xc="b3lyp"))):
        mf, _, _ = run_scf(cls, atoms, dev, spin=spin,
                           density_fit=density_fit, **kw)
        phase_gradient(f"gradient_{route}{tag}", mf, None, [], oracles[tag])


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
    must have launched, or is None where none may (the in-core route)."""
    from cctpu_torch.workflows import cli
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        rc = cli.main(["energy", "--smiles", smiles, "--method", "b3lyp",
                       "--basis", "6-31g*", "--grid-level", "2", *extra,
                       "--output-dir", tmp])
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
    if need is None:
        check(not any(n.values()), f"{tag}: in-core CLI launched {n}")
    else:
        check(n[need] > 0, f"{tag}: energy CLI never reached {need}")


def phase_contract(dev):
    """7. The 1e-8 Ha contract on the card: water RHF/6-31G with Cholesky
    J/K at conv_tol 1e-12 against cctpu's host-f64 oracle, the fused kernel
    launched every cycle; NH2 UB3LYP/6-31G* with Cholesky J/K (DF-J and
    DF-K on the factor) against the in-core SCF (<= 1e-8 Ha). Returns the
    launches of the two Cholesky SCFs."""
    from cctpu_torch.dft.rks import UKS
    from cctpu_torch.scf.hf import RHF
    mf, e, info = run_scf(RHF, WATER, dev, density_fit="cd", basis="6-31g",
                          conv_tol=1e-12)
    de = abs(e - WATER_CD_631G_E)
    n = info["launches"]
    emit({"phase": "water_rhf_631g_cd", "abs_dE_vs_oracle": de, **info})
    check(mf.converged and de <= 1e-8, f"water Cholesky |dE| {de:.3e}")
    check(n["df_jk_fused"] >= mf.n_cycles and n["df_j"] == n["df_k"] == 0,
          f"water Cholesky launches {n} in {mf.n_cycles} cycles")
    mf_cd, e_cd, info_cd = run_scf(UKS, NH2, dev, spin=1, density_fit="cd",
                                   xc="b3lyp")
    mf_in, e_in, info_in = run_scf(UKS, NH2, dev, spin=1, density_fit=False,
                                   xc="b3lyp")
    n_cd, n_in = info_cd["launches"], info_in["launches"]
    emit({"phase": "nh2_ub3lyp_cd_vs_incore", "abs_dE": abs(e_cd - e_in),
          "cd": info_cd, "incore": info_in})
    check(mf_cd.converged and mf_in.converged and abs(e_cd - e_in) <= 1e-8,
          f"NH2 |E_cd - E_incore| {abs(e_cd - e_in):.3e} > 1e-8")
    check(n_cd["df_j"] >= mf_cd.n_cycles and n_cd["df_k"] >= 2 *
          mf_cd.n_cycles and n_cd["df_jk_fused"] == 0 and
          not any(n_in.values()), f"NH2 launches {n_cd} / {n_in}")
    return {k: n[k] + n_cd[k] for k in n}


def phase_incore_phenol(dev, e_df):
    """7b. Phenol B3LYP/6-31G* in-core (grid level 2, conv_tol 1e-10)
    against cctpu's CPU-f64 in-core oracle (<= 1e-8 Ha): the tensor's
    build seconds and bytes, peak memory, s/cycle, no J/K kernel launched,
    and the DF fitting error |E_incore - E_DF| (printed, not gated)."""
    from cctpu_torch.dft.rks import RKS
    mf, e, info = run_scf(RKS, PHENOL, dev, density_fit=False, xc="b3lyp")
    de = abs(e - INCORE_ORACLES["phenol_b3lyp_e"])
    n = mf.mol.nao
    emit({"phase": "phenol_b3lyp_631gs_incore", "abs_dE_vs_oracle": de,
          "eri_GB": n ** 4 * 8 / 1e9, "eri_and_exchange_copy_GB":
          2 * n ** 4 * 8 / 1e9, "abs_E_incore_minus_E_df": abs(e - e_df),
          **info})
    check(mf.converged and de <= 1e-8, f"phenol in-core |dE| {de:.3e}")
    check(not any(info["launches"].values()),
          f"phenol in-core launched {info['launches']}")
    return mf, info


def phase_cholesky_phenol(dev, e_incore):
    """7c. The phenol SCF of 7b with Cholesky J/K: |E_cd - E_incore| <=
    1e-8 Ha (the contract at the north star's molecule), K, the fused
    kernel launched every cycle; then the kernels at its factor."""
    from cctpu_torch.dft.rks import RKS
    mf, e, info = run_scf(RKS, PHENOL, dev, density_fit="cd", xc="b3lyp")
    de = abs(e - e_incore)
    n = info["launches"]
    emit({"phase": "phenol_b3lyp_631gs_cd", "abs_E_cd_minus_E_incore": de,
          "cholesky_K": info["naux"], "cholesky_build_s": info["df_build_s"],
          **info})
    check(mf.converged and de <= 1e-8, f"phenol |E_cd - E_incore| {de:.3e}")
    check(n["df_jk_fused"] >= mf.n_cycles and n["df_j"] == n["df_k"] == 0,
          f"phenol Cholesky launches {n} in {mf.n_cycles} cycles")
    out = scf_kernels(mf, ("df_jk_fused", "df_j", "df_j_nset1", "df_k"))
    B, C = mf._jk.B, mf._factor_cocc(mf.dm)
    emit({"phase": "cholesky_kernel_time",
          "shape": [int(B.shape[0]), int(B.shape[1]), int(C.shape[1])],
          **out})
    return mf, n, out


def phase_cd_gradient(mf, g_incore):
    """7d, second part: the direct gradient of the Cholesky SCF of 7c at
    conv_tol 1e-12 agrees with the in-core SCF's (<= 1e-7 Ha/bohr)."""
    import torch
    from cctpu_torch.grad.scf_grad import gradient
    mf.opts.conv_tol, mf.opts.conv_tol_grad = 1e-12, 1e-8
    mf.kernel(dm0=mf.dm)
    check(mf.converged, "phenol Cholesky SCF did not converge to 1e-12")
    reset_counts()
    t0 = time.time()
    g = gradient(mf)
    torch.cuda.synchronize()
    err = float(np.abs(g.cpu().numpy() - np.asarray(g_incore)).max())
    emit({"phase": "gradient_cd_phenol_b3lyp", "grad_s": time.time() - t0,
          "abs_err_vs_incore": err, "launches_in_gradient": counts()})
    check(err <= 1e-7, f"phenol |g_cd - g_incore| {err:.2e} > 1e-7")
    check(not any(counts().values()), "the Cholesky gradient launched J/K")


def phase_cli_cache():
    """7f, second part: the ``energy`` CLI's code on phenol with
    ``--scf-cache`` twice: the second run warm-starts from the first one's
    checkpoint, takes fewer cycles and agrees (<= 1e-10 Ha)."""
    from cctpu_torch.workflows import calculate_energy
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for k in range(2):
            out = os.path.join(tmp, f"out{k}")
            t0 = time.time()
            e = calculate_energy.main(
                ["--smiles", "Oc1ccccc1", "--method", "b3lyp", "--basis",
                 "6-31g*", "--grid-level", "2", "--scf-cache",
                 os.path.join(tmp, "cache"), "--output-dir", out])
            wall = time.time() - t0
            report, = [f for f in os.listdir(out)
                       if f.endswith("_short_report.txt")]
            with open(os.path.join(out, report)) as f:
                text = f.read()
            runs.append({"E": e, "wall_s": wall,
                         "converged": "converged: True" in text,
                         "cycles": int(text.split("cycles:")[1].split()[0]),
                         "warm_start": "warm start" in text})
    (r1, r2), de = runs, abs(runs[1]["E"] - runs[0]["E"])
    emit({"phase": "cli_energy_scf_cache", "runs": runs, "abs_dE": de})
    check(r1["converged"] and r2["converged"] and not r1["warm_start"]
          and r2["warm_start"] and r2["cycles"] < r1["cycles"]
          and de <= 1e-10, f"--scf-cache runs {runs}")


def mark(t0, after):
    emit({"phase": "clock", "after": after, "s": time.time() - t0})


def main():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device")
    from cctpu_torch.ops import build, df_jk     # fails outside a checkout
    t_start = time.time()
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
    mark(t_start, "2a")
    e_phenol, fused["launches"], mf, info = phase_phenol(dev)
    # O y, the hydroxyl H x, C1 y (the molecule lies in z = 0)
    fd_comps = [(6, 1), (7, 0), (0, 1)]
    phase_gradient("gradient_phenol_b3lyp", mf, info, fd_comps,
                   GRAD_ORACLES["phenol_b3lyp"])
    del mf
    torch.cuda.empty_cache()
    mark(t_start, "3e")
    e_phenoxyl, jk, mf, info = phase_phenoxyl(dev)
    phase_gradient("gradient_phenoxyl_ub3lyp", mf, info, [(6, 1), (1, 0)],
                   GRAD_ORACLES["phenoxyl_ub3lyp"])
    del mf
    torch.cuda.empty_cache()
    mark(t_start, "3f")
    phase_h_atom(dev, e_phenol, e_phenoxyl)
    phase_phenol_blyp(dev)
    torch.cuda.empty_cache()
    mark(t_start, "3d")
    phase_c16h34(dev)
    torch.cuda.empty_cache()
    mark(t_start, "4")
    phase_cli("Oc1ccccc1", ["--density-fit"], "cli_energy", "df_jk_fused")
    phase_cli("[O]c1ccccc1", ["--density-fit", "--spin", "1"],
              "cli_energy_spin1", "df_k")
    mark(t_start, "5b")
    phase_small_gradients(dev)
    mark(t_start, "6")

    n_cd = phase_contract(dev)
    mark(t_start, "7")
    mf_in, info_in = phase_incore_phenol(dev, e_phenol)
    mark(t_start, "7b")
    mf_cd, n_phenol_cd, cd_kernels = phase_cholesky_phenol(dev, mf_in.e_tot)
    n_cd = {k: n_cd[k] + n_phenol_cd[k] for k in n_cd}
    mark(t_start, "7c")
    res = phase_gradient("gradient_incore_phenol_b3lyp", mf_in, info_in,
                         fd_comps, None)
    del mf_in
    torch.cuda.empty_cache()
    phase_cd_gradient(mf_cd, res["gradient"])
    del mf_cd
    torch.cuda.empty_cache()
    mark(t_start, "7d")
    phase_small_gradients(dev, density_fit=False)
    mark(t_start, "7e")
    phase_cli("Oc1ccccc1", [], "cli_energy_incore", None)
    phase_cli("[O]c1ccccc1", ["--spin", "1"], "cli_energy_incore_spin1",
              None)
    phase_cli_cache()
    mark(t_start, "7f")

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    cd_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")
    rows = [("df_jk_fused", "cctpu_torch/ops/csrc/df_jk_fused.cu",
             "cctpu/ops/df_jk_pallas.py:167", fused),
            ("df_j", "cctpu_torch/ops/csrc/df_j.cu",
             "cctpu/ops/df_jk_pallas.py:46,53", jk["df_j"]),
            ("df_k", "cctpu_torch/ops/csrc/df_k.cu",
             "cctpu/ops/df_jk_pallas.py:66", jk["df_k"])]
    emit(card)
    emit({"kernels": [{"name": name, "route": "cuda", "source": src,
                       "replaces": rep, **{k: d[k] for k in keys},
                       "launches_cholesky": n_cd[name],
                       "cholesky_shape": {k: cd_kernels[name][k]
                                          for k in cd_keys}}
                      for name, src, rep, d in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
