"""cctpu's CPU-f64 results of the bde, reaction, ir and interaction
workflows and of MP2: the oracles of chip_smoke.py's phases 10-10f and of
tests/test_torch_workflows.py.

Each case runs cctpu's own workflow functions on the CPU in f64, one case
per process. Inside this script's process, and only there:

- cctpu's ``embed_molecule`` / ``smiles_to_molecule`` names in the
  workflow modules return the port's embedded coordinates, so both
  packages compute the same molecule (the two embeddings draw the same
  start, but their second L-BFGS stage can stop at different points of a
  flat valley for larger molecules: ROADMAP.md queue 3);
- ``calculate_bde._bde_batched`` and ``calculate_interaction.
  scan_batched`` return None, which is cctpu's own serial path (its
  batched paths fail on the CPU: ROADMAP.md queue 3);
- ``hessian_auto`` in the reaction and IR workflows is cctpu's
  ``hessian_fd`` route, the one the port takes (cctpu's analytic B3LYP
  Hessian did not finish on the CPU);
- reactions are split into species by the port's ``parse_side``: cctpu's
  splits at the '+' of a charge such as '[H+]' (ROADMAP.md queue 3);
- ``calculate_bde.run_scf`` drops the sweep's ``max_cycle=100``, which is
  cctpu's default, so that the SCF retry can set its own 200: cctpu's
  retry passes ``max_cycle`` twice and raises (ROADMAP.md queue 3), where
  the port's retry replaces the caller's settings.

MP2 cases: cctpu's SCF at conv_tol 1e-12 and an orbital gradient
<= 1e-9 (6-31G*), then cctpu's ``MP2``.

Prints each case's entry, a Python literal, for chip_smoke.py's
``WORKFLOW_ORACLES`` (or the test file's, for the ``t_`` cases).

Usage:  python scripts/make_workflow_oracles.py <case>   (see ``CASES``;
        a reaction case runs each species in a process of its own)
"""

import ast
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]

import conftest  # noqa: E402,F401  (the CPU platform, x64, shape knobs)

import cctpu.workflows.calculate_bde as cb  # noqa: E402
import cctpu.workflows.calculate_interaction as ci  # noqa: E402
import cctpu.workflows.calculate_ir_spectrum as cir  # noqa: E402
import cctpu.workflows.calculate_reaction_energy as cr  # noqa: E402
import cctpu.workflows.common as cc  # noqa: E402
from cctpu.core.molecule import Molecule  # noqa: E402
from cctpu.grad import df_grad  # noqa: E402
from cctpu.hessian import frequencies as jfreq  # noqa: E402
from cctpu.mp.mp2 import MP2  # noqa: E402
from cctpu.scf.hf import RHF, UHF  # noqa: E402
from cctpu_torch.io import embed3d as tembed  # noqa: E402
from cctpu_torch.io.smiles import parse_smiles as tparse  # noqa: E402
from cctpu_torch.utils.measure import NH2, PHENOL, WATER  # noqa: E402
from cctpu_torch.workflows.calculate_reaction_energy import \
    parse_side  # noqa: E402


def _port_smiles_to_molecule(smiles, charge=None, spin=0, basis="sto-3g",
                             seed=42):
    tm = tembed.smiles_to_molecule(smiles, charge=charge, spin=spin,
                                   basis=basis, seed=seed)
    return Molecule(symbols=list(tm.symbols), coords=tm.coords.copy(),
                    charge=tm.charge, spin=tm.spin, basis=basis)


def _hessian_fd_route(mf, factory, mol, dm0=None, with_dipole=True,
                      log=None, step=1e-3):
    return jfreq.hessian_fd(factory, mol, dm0=dm0, step=step,
                            with_dipole=with_dipole)


def _run_scf_retry_repaired(*args, max_cycle=100, **kw):
    if max_cycle != 100:
        raise ValueError("only cctpu's default max_cycle can be dropped")
    return _CCTPU_RUN_SCF(*args, **kw)


_CCTPU_RUN_SCF = cc.run_scf


def _rebind(smiles=None):
    """The rebinding described above; ``smiles`` is the bde case's
    molecule (cctpu's ``embed_molecule`` takes its graph)."""
    if smiles is not None:
        cb.embed_molecule = lambda g, seed=42: tembed.embed_molecule(
            tparse(smiles), seed=seed)
    cb._bde_batched = lambda *a, **k: None
    cb.run_scf = _run_scf_retry_repaired
    ci.scan_batched = lambda *a, **k: None
    for mod in (ci, cr, cc):
        mod.smiles_to_molecule = _port_smiles_to_molecule
    cr.hessian_auto = cir.hessian_auto = _hessian_fd_route


def bde(smiles, method, basis, tier, density_fit, limit):
    _rebind(smiles)
    e_parent, results = cb.bde_sweep(smiles, method, basis, tier,
                                     density_fit, limit=limit)
    return {"e_parent": e_parent,
            "bde": {lbl: b for lbl, _, _, b in results}}


def species(smi, method, basis, density_fit, grid_level, skip_freq):
    """cctpu's ``species_thermo`` of one species (Ha)."""
    _rebind()
    return {k: float(v) for k, v in cr.species_thermo(
        smi, method, basis, density_fit, grid_level, skip_freq).items()}


def reaction(text, method, basis, density_fit, grid_level, skip_freq):
    """Per species cctpu's ``species_thermo``, each in a process of its own
    (one process that optimized and FD-differentiated two species ran out
    of memory maps in XLA's CPU compiler: ROADMAP.md queue 3 item 2); dE,
    dE0, dH, dG as its ``main`` sums them (Ha)."""
    lhs, rhs = text.split("->")
    reactants, products = parse_side(lhs), parse_side(rhs)
    table = {}
    for _, smi in reactants + products:
        if smi not in table:
            args = [smi, method, basis, density_fit, grid_level, skip_freq]
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--species",
                 repr(args)], check=True, capture_output=True, text=True)
            last = out.stdout.strip().splitlines()[-1]
            table[smi] = ast.literal_eval(last)

    def tot(side, key):
        return sum(c * table[s][key] for c, s in side)
    out = {f"d{k}": tot(products, k) - tot(reactants, k)
           for k in ("E", "E0", "H", "G")}
    out["species"] = table
    return out


def ir(smiles, method, basis, grid_level):
    """cctpu's IR workflow body: optimize, the FD Hessian with dipoles,
    the harmonic analysis."""
    _rebind()
    mol = cc.smiles_to_molecule(smiles, basis=basis)

    def factory(m):
        mf, _ = cc.make_scf(m, method, None, grid_level=grid_level)
        return mf
    res = cir.optimize(factory, mol, maxsteps=50)
    H, dmu = cir.hessian_auto(res.mf, factory, res.mol, dm0=res.mf.dm)
    ha = cir.harmonic_analysis(res.mol, H, dmu)
    return {"e_opt": float(res.e_tot), "nsteps": int(res.nsteps),
            "freq": [float(x) for x in ha.freq_wavenumber],
            "ir": [float(x) for x in ha.ir_intensity]}


def interaction(a, b, distance, basis, method, scan=None):
    """One point (E_int CP, raw, BSSE; Ha) at ``distance``, or with
    ``scan`` the CLI's serial warm-start loop's E_int CP at each R."""
    _rebind()
    if scan is None:
        e_cp, e_raw, corr = ci.interaction_energy(a, b, distance, basis,
                                                  method)
        return {"e_cp": e_cp, "e_raw": e_raw, "bsse": corr}
    warm = {}
    return {"scan": [ci.interaction_energy(a, b, float(r), basis, method,
                                           log=lambda *x: None,
                                           warm=warm)[0] for r in scan]}


def mp2(atoms, spin, density_fit):
    mol = Molecule.from_atoms(atoms, spin=spin, basis="6-31g*")
    mf = (UHF if spin else RHF)(mol, density_fit=density_fit,
                                conv_tol=1e-12, conv_tol_grad=1e-9)
    mf.kernel()
    assert mf.converged
    e_corr, _ = MP2(mf).kernel()
    return {"e_scf": float(mf.e_tot), "e_corr": float(e_corr),
            "cycles": int(mf.n_cycles)}


CASES = {
    # tests/test_torch_workflows.py (HF/STO-3G)
    "t_bde_ethane": lambda: bde("CC", "hf", "sto-3g", "mmff", None, 1),
    "t_interaction_water": lambda: interaction("O", "O", 3.0, "sto-3g",
                                               "hf"),
    "t_reaction_h3o": lambda: reaction("O + [H+] -> [OH3+]", "hf",
                                       "sto-3g", None, 3, True),
    # chip_smoke.py phase 10: MP2 at 6-31G*
    "mp2_water_incore": lambda: mp2(WATER, 0, False),
    "mp2_water_cd": lambda: mp2(WATER, 0, "cd"),
    "mp2_nh2_incore": lambda: mp2(NH2, 1, False),
    "mp2_phenol_df": lambda: mp2(PHENOL, 0, True),
    # phase 10b
    "bde_hydrazine_b3lyp_tier": lambda: bde("NN", "b3lyp", "6-31g*",
                                            "b3lyp", None, 1),
    "bde_phenol_b3lyp": lambda: bde("Oc1ccccc1", "b3lyp", "6-31g*", "mmff",
                                    True, 2),
    # phase 10d (the CLI's defaults: B3LYP/6-31+G*, grid level 3)
    "reaction_h3o": lambda: reaction("O + [H+] -> [OH3+]", "b3lyp",
                                     "6-31+g*", None, 3, False),
    "reaction_h_df": lambda: reaction("OO + 2[H] -> 2O", "b3lyp",
                                      "6-31+g*", True, 3, True),
    # phase 10e (defaults: B3LYP/6-31G*, grid level 3)
    "ir_water": lambda: ir("O", "b3lyp", "6-31g*", 3),
    # phase 10f (defaults: MP2/6-31+G*, 3.5 A, counterpoise)
    "interaction_water": lambda: interaction("O", "O", 3.5, "6-31+g*",
                                             "mp2"),
    "interaction_scan": lambda: interaction("O", "O", None, "6-31+g*",
                                            "mp2", scan=(3.0, 3.5, 4.0)),
}


def main(argv):
    df_grad._GVAL_ON = False         # a TPU guard, not math
    if argv[0] == "--species":
        print(repr(species(*ast.literal_eval(argv[1]))), flush=True)
        return
    name, = argv
    t0 = time.time()
    print(f'    "{name}": {CASES[name]()!r},', flush=True)
    print(f"# {name}: {time.time() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main(sys.argv[1:])
