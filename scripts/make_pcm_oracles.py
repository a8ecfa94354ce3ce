"""cctpu's CPU-f64 PCM results: the oracles of tests/test_torch_pcm.py
(the ``t_`` cases, STO-3G) and of chip_smoke.py's phase 13 (6-31G*).

Every SCF is cctpu's own on the CPU in f64, wrapped by
``cctpu.solvent.pcm.PCM`` (IEF-PCM water unless the case says C-PCM).
The cases:

  t_<scf>        the PCM SCF's energy (conv_tol 1e-12, orbital gradient
                 <= 1e-9, ``SCF_OPTS``), its whole nuclear gradient, PCM
                 term included (``gradient``), and the PCM term alone
                 (jitted jax.grad of ``PCMModel.energy`` at the SCF's
                 density);
  t_<scf>_hess   cctpu's analytic (CPHF) Hessian with dipole derivatives
                 of the same SCF, PCM term included;
  t_cli_water    cctpu's ``solvent`` CLI as tests/test_workflows.py runs
                 it (water HF/STO-3G, water), on the port's embedded
                 coordinates (the two embeddings agree to 1e-12 A here);
  phenol_df_b3lyp     phenol DF-B3LYP/6-31G*, grid level 2, conv_tol 1e-10
                      (phase 13a's SCF): the energy;
  phenol_df_b3lyp_grad  the same SCF at conv_tol 1e-12 and orbital
                      gradient <= 1e-8, then its gradient;
  nh2_df_ub3lyp  NH2 DF-UB3LYP/6-31G*, grid level 2 (``SCF_OPTS``):
                 energy and gradient (phase 13d);
  cli_phenol     ``solvent --smiles Oc1ccccc1`` at its defaults (B3LYP/
                 6-31G*, in core, water, IEF-PCM; phase 13b);
  cli_water_cpcm_opt  ``solvent --smiles O --pcm-method c-pcm
                 --compare-solvents --opt`` at its defaults (phase 13c).

A CLI case runs cctpu's own ``main`` and records, besides its report, the
SCF objects it made: E_gas, E_sol, the dipole norms (Debye) and HOMO-LUMO
gaps (Ha) of the gas and solvated SCFs, the in-solvent optimization's
energies and final coordinates, and the solvent table's energies.

Prints each case's entry, a Python literal, for the test file's
``ORACLES`` (the ``t_`` cases) or chip_smoke.py's ``PCM_ORACLES``.

Usage:  python scripts/make_pcm_oracles.py <case>
        Run one case per process: XLA's CPU compiler has crashed processes
        that compiled several cases (ROADMAP.md queue 3 item 2).
"""

import os
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests"),
                os.path.join(_ROOT, "scripts")]

import conftest  # noqa: E402,F401  (the CPU platform, x64, shape knobs)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cctpu.core.molecule import Molecule  # noqa: E402
from cctpu.solvent.pcm import PCM  # noqa: E402
from cctpu_torch.utils.measure import NH2, PHENOL, WATER  # noqa: E402
from make_opt_oracles import _entry  # noqa: E402

SCF_OPTS = dict(conv_tol=1e-12, conv_tol_grad=1e-9, max_cycle=200)
# name: (atoms, spin, basis, SCF class, its options, PCM method)
SCFS = {
    "water_rhf": (WATER, 0, "sto-3g", "RHF", {}, "ief-pcm"),
    "water_rhf_cpcm": (WATER, 0, "sto-3g", "RHF", {}, "c-pcm"),
    "water_b3lyp": (WATER, 0, "sto-3g", "RKS",
                    dict(xc="b3lyp", grid_level=1), "ief-pcm"),
    "water_df_b3lyp": (WATER, 0, "sto-3g", "RKS",
                       dict(xc="b3lyp", grid_level=1, density_fit=True),
                       "ief-pcm"),
    "nh2_uhf": (NH2, 1, "sto-3g", "UHF", {}, "ief-pcm"),
    "nh2_df_ub3lyp": (NH2, 1, "6-31g*", "UKS",
                      dict(xc="b3lyp", grid_level=2, density_fit=True),
                      "ief-pcm"),
}
PHENOL_SCF = dict(xc="b3lyp", grid_level=2, density_fit=True)


def scf_class(name):
    from cctpu.dft import rks
    from cctpu.scf import hf
    return {"RHF": hf.RHF, "UHF": hf.UHF, "RKS": rks.RKS,
            "UKS": rks.UKS}[name]


def pcm_scf(atoms, spin, basis, cls_name, opts, method, scf_opts):
    mol = Molecule.from_atoms(atoms, spin=spin, basis=basis).build()
    mf = PCM(scf_class(cls_name)(mol, **opts, **scf_opts), solvent="water",
             method=method)
    e = float(mf.kernel())
    assert mf.converged
    return mf, e


def gradient(mf, opts):
    """cctpu's whole gradient and its PCM term (Ha/bohr). In core
    ``scf_gradient_eager``; density fitted its terms in f64
    (tests/test_torch_grad.py's ``cctpu_gradient_terms``, as
    scripts/make_grad_oracles.py: ``scf_gradient_eager`` assembles the DF
    weights W, Z in f32, 4.6e-7 Ha/bohr off at water/STO-3G) plus the PCM
    term."""
    dm = jnp.asarray(mf.dm)
    g_pcm = np.asarray(jax.jit(jax.grad(lambda R: mf._pcm.energy(R, dm)))(
        jnp.asarray(mf.mol.coords)))
    if mf.density_fit in (False, None, "cd"):
        from cctpu.grad.scf_grad import scf_gradient_eager
        return np.asarray(scf_gradient_eager(mf)), g_pcm
    from test_torch_grad import cctpu_gradient_terms
    g = cctpu_gradient_terms(
        mf.mol, mf._jk, *(np.asarray(x) for x in (mf.dm, mf.mo_coeff,
                                                  mf.mo_occ, mf.mo_energy)),
        xc=opts.get("xc"), grid_level=opts.get("grid_level", 1))["total"]
    return g + g_pcm, g_pcm


def scf_case(name):
    mf, e = pcm_scf(*SCFS[name], SCF_OPTS)
    g, g_pcm = gradient(mf, SCFS[name][4])
    return {"E": e, "cycles": int(mf.n_cycles), "gradient": g,
            "pcm_term": g_pcm}


def hessian_case(name):
    from cctpu.hessian.cphf import analytic_hessian
    mf, e = pcm_scf(*SCFS[name], SCF_OPTS)
    H, dmu = analytic_hessian(mf, with_dipole=True)
    return {"E": e, "hessian": np.asarray(H), "dmu_dR": np.asarray(dmu)}


def phenol(with_gradient):
    opts = (dict(conv_tol=1e-12, conv_tol_grad=1e-8, max_cycle=100)
            if with_gradient else dict(conv_tol=1e-10))
    mf, e = pcm_scf(PHENOL, 0, "6-31g*", "RKS", PHENOL_SCF, "ief-pcm",
                    opts)
    out = {"E": e, "cycles": int(mf.n_cycles)}
    if with_gradient:
        out["gradient"], out["pcm_term"] = gradient(mf, PHENOL_SCF)
    return out


def cli(argv):
    """cctpu's ``solvent`` main on the port's embedded coordinates, with
    the SCF objects it made recorded."""
    import cctpu.geomopt.optimizer as jopt
    import cctpu.workflows.calculate_solvent_effect as cs
    import cctpu.workflows.common as cc
    from make_workflow_oracles import _port_smiles_to_molecule
    cc.smiles_to_molecule = _port_smiles_to_molecule
    seen = {"gas": None, "pcm": [], "opt": None, "in_opt": False}
    run_scf, pcm, optimize = cs.run_scf, cs.PCM, jopt.optimize

    def rec_run_scf(*a, **k):
        mf, e = run_scf(*a, **k)
        seen["gas"] = mf
        return mf, e

    def rec_pcm(mf, **k):
        mf = pcm(mf, **k)
        if not seen["in_opt"]:
            seen["pcm"].append(mf)
        return mf

    def rec_optimize(*a, **k):
        seen["in_opt"] = True
        try:
            seen["opt"] = optimize(*a, **k)
        finally:
            seen["in_opt"] = False
        return seen["opt"]

    cs.run_scf, cs.PCM, jopt.optimize = rec_run_scf, rec_pcm, rec_optimize
    with tempfile.TemporaryDirectory() as tmp:
        e_gas, e_sol = cs.main(argv + ["--output-dir", tmp])

    def props(mf):
        h, l = cc.homo_lumo(mf)
        return float(np.linalg.norm(mf.dip_moment())), l - h
    mf_sol = seen["pcm"][0] if seen["opt"] is None else seen["opt"].mf
    out = {"e_gas": float(e_gas), "e_sol": float(e_sol)}
    out["mu_gas"], out["gap_gas"] = props(seen["gas"])
    out["mu_sol"], out["gap_sol"] = props(mf_sol)
    if seen["opt"] is not None:
        out["opt_energies"] = [float(x) for x in seen["opt"].energies]
        out["opt_coords"] = np.asarray(seen["opt"].mol.coords)
    if len(seen["pcm"]) > 1:
        out["table"] = [float(m.e_tot) for m in seen["pcm"][1:]]
    return out


CASES = {
    **{f"t_{n}": (lambda n=n: scf_case(n)) for n in (
        "water_rhf", "water_rhf_cpcm", "water_b3lyp", "water_df_b3lyp",
        "nh2_uhf")},
    **{f"t_{n}_hess": (lambda n=n: hessian_case(n)) for n in (
        "water_rhf", "water_df_b3lyp", "nh2_uhf")},
    "t_cli_water": lambda: cli(["--smiles", "O", "--method", "hf",
                                "--basis", "sto-3g", "--solvent",
                                "water"]),
    "phenol_df_b3lyp": lambda: phenol(False),
    "phenol_df_b3lyp_grad": lambda: phenol(True),
    "nh2_df_ub3lyp": lambda: scf_case("nh2_df_ub3lyp"),
    "cli_phenol": lambda: cli(["--smiles", "Oc1ccccc1"]),
    "cli_water_cpcm_opt": lambda: cli(["--smiles", "O", "--pcm-method",
                                       "c-pcm", "--compare-solvents",
                                       "--opt"]),
}


def main(argv):
    for name in argv:
        if name not in CASES:
            raise SystemExit(f"unknown case {name!r}")
        t0 = time.time()
        print(_entry(name, CASES[name]()), flush=True)
        print(f"# {name}: {time.time() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main(sys.argv[1:])
