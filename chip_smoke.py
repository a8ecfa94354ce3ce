#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port ``cctpu_torch`` on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one printed line or more each:

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
1. build the hand-written CUDA kernel (nvcc, into build/cctpu_torch/);
2. the fused DF-J/K kernel against its plain torch version on the card at
   cctpu's three Pallas test shapes and at phenol's shape, in f64 (<= 1e-12
   relative max error) and f32 (<= 1e-5), repeat calls bitwise equal, and
   kernel vs plain median times at phenol's shape (f64, CUDA events);
3. phenol DF-B3LYP/6-31G* (grid level 2, conv_tol 1e-10) through the Python
   API, against cctpu's host-f64 oracle (|dE| <= 1e-8 Ha), with the kernel's
   launch count reset before and read after the SCF;
4. C16H34/6-31G*: energy of the unrelaxed SAD density from one Fock build
   against cctpu's oracle (<= 1e-6 Ha); J/K call time at this shape;
5. the ``energy`` CLI on phenol's SMILES with ``--density-fit``.

Any failure raises: the script then exits non-zero without its last line.
The last line is ``{"ok": true, "device": {...}}``. Needs no network and
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

# bench.py's phenol geometry (Angstrom)
PHENOL = ("C 0.0000 1.3970 0.0000; C 1.2098 0.6985 0.0000; "
          "C 1.2098 -0.6985 0.0000; C 0.0000 -1.3970 0.0000; "
          "C -1.2098 -0.6985 0.0000; C -1.2098 0.6985 0.0000; "
          "O 0.0000 2.7650 0.0000; H 0.9300 3.1000 0.0000; "
          "H 2.1500 1.2400 0.0000; H 2.1500 -1.2400 0.0000; "
          "H 0.0000 -2.4800 0.0000; H -2.1500 -1.2400 0.0000; "
          "H -2.1500 1.2400 0.0000")

# (naux, nao, nocc): cctpu's tests/test_pallas_ops.py shapes (unaligned on
# purpose) and phenol/6-31G*
KERNEL_SHAPES = [(96, 32, 8), (37, 16, 3), (83, 24, 5), (1770, 110, 25)]
TOL = {"float64": 1e-12, "float32": 1e-5}


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


def jk_inputs(naux, nao, nocc, seed, dtype, dev):
    import torch
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((naux, nao, nao))
    C = rng.standard_normal((nao, nocc))
    D = 2 * C @ C.T
    return tuple(torch.as_tensor(x, dtype=dtype, device=dev)
                 for x in (B, D, C))


def rel_err(x, ref):
    return float((x - ref).abs().max() / ref.abs().max())


def phase_kernel(df_jk, dev):
    """Kernel vs plain torch at the four shapes; returns phenol numbers."""
    import torch
    out = {}
    for naux, nao, nocc in KERNEL_SHAPES:
        for dtype in (torch.float64, torch.float32):
            B, D, C = jk_inputs(naux, nao, nocc, naux, dtype, dev)
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
                  "tol": TOL[name]})
            check(max(ej, ek) <= TOL[name],
                  f"kernel disagrees at {naux}/{nao}/{nocc} {name}")
            check(bitwise, f"repeat calls differ at {naux}/{nao}/{nocc}")
            if (naux, nao, nocc) == KERNEL_SHAPES[-1] \
                    and dtype == torch.float64:
                out["max_abs_err"] = max_abs
                # plain, kernel, kernel, plain
                p1 = cuda_ms(lambda: df_jk.df_jk_reference(B, D, C), 10)
                k1 = cuda_ms(lambda: df_jk.df_jk_fused(B, D, C), 10)
                k2 = cuda_ms(lambda: df_jk.df_jk_fused(B, D, C), 10)
                p2 = cuda_ms(lambda: df_jk.df_jk_reference(B, D, C), 10)
                out["ms"] = float(np.median([k1, k2]))
                out["plain_ms"] = float(np.median([p1, p2]))
                emit({"phase": "kernel_time", "shape": [naux, nao, nocc],
                      "dtype": name, "kernel_ms": [k1, k2],
                      "plain_ms": [p1, p2]})
    return out


def phase_phenol(df_jk, dev):
    import torch
    from cctpu_torch.core.molecule import Molecule
    from cctpu_torch.dft.rks import RKS
    mol = Molecule.from_atoms(PHENOL, basis="6-31g*")
    t0 = time.time()
    mf = RKS(mol, xc="b3lyp", density_fit=True, grid_level=2,
             conv_tol=1e-10, max_cycle=60, device=dev)
    t_grid = time.time() - t0
    t0 = time.time()
    mf.get_jk_builder()
    torch.cuda.synchronize()
    t_df = time.time() - t0
    t0 = time.time()
    mf._prepare_xc_f64()
    torch.cuda.synchronize()
    t_ao = time.time() - t0
    df_jk.LAUNCHES = 0
    t0 = time.time()
    e = mf.kernel()
    torch.cuda.synchronize()
    t_scf = time.time() - t0
    launches = df_jk.LAUNCHES
    de = abs(e - PHENOL_E_CONV)
    emit({"phase": "phenol_b3lyp_631gs", "E": e, "abs_dE_vs_oracle": de,
          "converged": mf.converged, "cycles": mf.n_cycles,
          "s_per_cycle": t_scf / mf.n_cycles, "scf_s": t_scf,
          "grids_s": t_grid, "df_build_s": t_df, "ao_cache_s": t_ao,
          "nao": mol.nao, "naux": int(mf._jk.B.shape[0]),
          "kernel_launches": launches})
    check(mf.converged, "phenol SCF did not converge")
    check(de <= 1e-8, f"phenol |dE| {de:.3e} > 1e-8 Ha")
    check(launches >= mf.n_cycles,
          f"kernel launched {launches} times in {mf.n_cycles} cycles")
    return launches


def phase_c16h34(df_jk, dev):
    import torch
    from cctpu_torch.core.molecule import Molecule
    from cctpu_torch.dft.rks import RKS
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
    del J, K, Jr, Kr
    k1 = cuda_ms(lambda: df_jk.df_jk_fused(B, dm, cocc), 3)
    p1 = cuda_ms(lambda: df_jk.df_jk_reference(B, dm, cocc), 3)
    emit({"phase": "c16h34_sad", "E_sad": e, "abs_dE_vs_oracle": de,
          "nao": mol.nao, "naux": int(B.shape[0]),
          "nocc": int(cocc.shape[1]), "build_s": t_build,
          "jk_kernel_ms": k1, "jk_plain_ms": p1,
          "kernel_rel_err_J": ej, "kernel_rel_err_K": ek,
          "peak_mem_GB": torch.cuda.max_memory_allocated(dev) / 1e9})
    check(np.isfinite(e) and de <= 1e-6, f"C16H34 SAD |dE| {de:.3e} > 1e-6")
    check(max(ej, ek) <= 1e-12, "kernel disagrees at the C16H34 shape")


def phase_cli(df_jk):
    from cctpu_torch.workflows import cli
    df_jk.LAUNCHES = 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        rc = cli.main(["energy", "--smiles", "Oc1ccccc1", "--method",
                       "b3lyp", "--basis", "6-31g*", "--density-fit",
                       "--grid-level", "2", "--output-dir", tmp])
        wall = time.time() - t0
        reports = [f for f in os.listdir(tmp)
                   if f.endswith("_short_report.txt")]
        check(len(reports) == 1, "energy CLI wrote no short report")
        with open(os.path.join(tmp, reports[0])) as f:
            text = f.read()
    converged = "converged: True" in text
    emit({"phase": "cli_energy", "rc": rc, "converged": converged,
          "kernel_launches": df_jk.LAUNCHES, "wall_s": wall})
    check(rc == 0 and converged, "energy CLI did not converge")
    check(df_jk.LAUNCHES > 0, "energy CLI never reached the kernel")


def main():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device")
    from cctpu_torch.ops import df_jk     # fails outside a checkout
    card = card_line()
    emit(card)
    emit({"phase": "card", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    dev = torch.device("cuda", 0)

    t0 = time.time()
    df_jk.build()
    ptxas = [ln.strip() for ln in df_jk.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.time() - t0, "ptxas": ptxas})

    kern = phase_kernel(df_jk, dev)
    launches = phase_phenol(df_jk, dev)
    torch.cuda.empty_cache()
    phase_c16h34(df_jk, dev)
    torch.cuda.empty_cache()
    phase_cli(df_jk)

    emit(card)
    emit({"kernels": [{
        "name": "df_jk_fused", "route": "cuda",
        "source": "cctpu_torch/ops/csrc/df_jk_fused.cu",
        "replaces": "cctpu/ops/df_jk_pallas.py:167",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
