"""cctpu's CPU-f64 TDDFT results: the oracles of tests/test_torch_tddft.py
(the ``t_`` cases) and of chip_smoke.py's phases 11a-11b.

Each case runs in a process of its own, on the CPU in f64:

- ``t_`` cases: the port's SCF on the CPU as the test file builds it
  (``test_torch_tddft.port_scf``), its converged state copied into cctpu's
  SCF object (whose J/K builder and grid cctpu builds; its DF factor read
  once before the TDDFT), then cctpu's TDDFT or TDA: cctpu's numbers from
  the port's orbitals. ``t_uv_cli`` runs
  cctpu's ``uv`` main at the port's embedded coordinates.
- ``uv_acrolein`` and ``uv_acrolein_df``: cctpu's ``uv`` main at its
  defaults (B3LYP/6-31G*, grid level 3, full TDDFT, 6 states; in core,
  and with ``--density-fit``) on acrolein's SMILES (nao 64, 735 single
  excitations: the paired Davidson) at the port's embedded coordinates
  (the two embeddings can stop at different points of a flat valley for
  larger molecules: ROADMAP.md queue 3); ~23 min and ~14 GB each. The
  same run on phenol (nao 110) did not finish within an hour in one
  process (killed after 60 min at 32 GB).
- ``uv_water_camb3lyp_tda_df``: cctpu's ``uv`` main on water with
  ``--method cam-b3lyp --tda --density-fit`` (6-31G*, grid level 3, 6
  states) at the port's embedded coordinates.
- ``nh2_ub3lyp_df`` and ``water_camb3lyp_df``: cctpu's SCF (6-31G*, DF,
  grid level 2, conv_tol 1e-12, orbital gradient <= 1e-9) at the
  geometries of ``cctpu_torch/utils/measure.py``, then its TDDFT (6
  states).

Prints each case's entry, a Python literal, for chip_smoke.py's
``UV_ORACLES`` (or the test file's ``ORACLES``, for the ``t_`` cases):
excitation energies in Ha and oscillator strengths.

Usage:  python scripts/make_uv_oracles.py <case>   (see ``CASES``)
"""

import os
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]

import conftest  # noqa: E402,F401  (the CPU platform, x64, shape knobs)
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import cctpu.workflows.calculate_uv_spectrum as cuv  # noqa: E402
import cctpu.workflows.common as cc  # noqa: E402
from cctpu.core.molecule import Molecule  # noqa: E402
from cctpu.dft.rks import RKS, UKS  # noqa: E402
from cctpu.response.tddft import TDDFT  # noqa: E402
from cctpu.scf.hf import RHF, UHF  # noqa: E402
from cctpu_torch.utils.measure import NH2, WATER  # noqa: E402
from make_workflow_oracles import _port_smiles_to_molecule  # noqa: E402
from test_torch_tddft import CLI_ARGS, SCF_CASES, port_scf  # noqa: E402


def _result(td):
    return {"e": [float(x) for x in td.e],
            "f": [float(x) for x in td.oscillator_strength()],
            "converged": bool(td.converged)}


def from_port_state(key):
    """cctpu's TDDFT (and TDA) on the port's converged SCF of case
    ``key``, built with one torch thread as the test file builds it (the
    same arithmetic, so the same orbitals: OH's near-zero root moves by
    1e-6 Ha with the SCF's last 1e-6 of orbital gradient)."""
    spec = SCF_CASES[key]
    torch.set_num_threads(1)
    mf_t = port_scf(key)
    jmol = Molecule.from_atoms(spec["atoms"], spin=spec["spin"],
                               basis=spec["basis"])
    if spec["xc"] == "hf":
        mf = (UHF if spec["spin"] else RHF)(
            jmol, density_fit=spec["df"])
    else:
        mf = (UKS if spec["spin"] else RKS)(
            jmol, xc=spec["xc"], density_fit=spec["df"],
            grid_level=spec["grid_level"])
    for name in ("dm", "mo_coeff", "mo_energy", "mo_occ"):
        setattr(mf, name, jnp.asarray(getattr(mf_t, name).numpy()))
    jk = mf.get_jk_builder()
    # cctpu's DF factor is made lazily at its first read; a first read
    # inside the TDDFT's jitted matvec leaks a tracer (its SCF reads it
    # first: ROADMAP.md queue 3), so it is read here
    getattr(jk, "B", None)
    out = {}
    for tda in spec["modes"]:
        td = TDDFT(mf, nstates=spec["nstates"], tda=tda)
        td.kernel()
        out["tda" if tda else "rpa"] = _result(td)
    return out


def uv_cli(argv):
    """cctpu's ``uv`` main on ``argv`` at the port's coordinates; the SCF
    energy and the states."""
    cc.smiles_to_molecule = _port_smiles_to_molecule
    with tempfile.TemporaryDirectory() as tmp:
        td = cuv.main([*argv, "--output-dir", tmp])
    return {"e_scf": float(td.mf.e_tot), **_result(td)}


def api(atoms, spin, xc, tda, nstates):
    mol = Molecule.from_atoms(atoms, spin=spin, basis="6-31g*")
    mf = (UKS if spin else RKS)(mol, xc=xc, density_fit=True, grid_level=2,
                                conv_tol=1e-12, conv_tol_grad=1e-9)
    e = mf.kernel()
    assert mf.converged
    td = TDDFT(mf, nstates=nstates, tda=tda)
    td.kernel()
    return {"e_scf": float(e), **_result(td)}


CASES = {
    **{key: (lambda key=key: from_port_state(key)) for key in SCF_CASES},
    "t_uv_cli": lambda: uv_cli(CLI_ARGS),
    # chip_smoke.py phase 11a: the uv CLI at its defaults on acrolein
    "uv_acrolein": lambda: uv_cli(["--smiles", "C=CC=O"]),
    "uv_acrolein_df": lambda: uv_cli(["--smiles", "C=CC=O",
                                      "--density-fit"]),
    # phase 11b: df_k_dm on spin pairs and on B_lr. Full TDDFT (dense
    # Casida at nov 121), not TDA: with a GGA the TDA operator of cctpu's
    # formulation is not symmetric (ROADMAP.md queue 3), and its Davidson
    # then converges or not by the roundoff of its start
    "nh2_ub3lyp_df": lambda: api(NH2, 1, "b3lyp", False, 6),
    "water_camb3lyp_df": lambda: api(WATER, 0, "cam-b3lyp", False, 6),
    # phase 11b: the uv CLI's --tda path (the Hermitian Davidson) on B and
    # B_lr, on water, whose TDA converges from any roundoff of its start
    # (scripts/tda_asymmetry.py)
    "uv_water_camb3lyp_tda_df": lambda: uv_cli(
        ["--smiles", "O", "--method", "cam-b3lyp", "--tda",
         "--density-fit"]),
}


def main(argv):
    name, = argv
    t0 = time.time()
    print(f'    "{name}": {CASES[name]()!r},', flush=True)
    print(f"# {name}: {time.time() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main(sys.argv[1:])
