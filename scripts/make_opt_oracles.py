"""cctpu's CPU-f64 geometry optimizations and water Hessians: the oracles
of chip_smoke.py's phases 8, 8b and 8d.

Every SCF is cctpu's own on the CPU in f64: DF, 6-31G*, grid level 2,
conv_tol 1e-12 and orbital gradient <= 1e-8 (``FACTORY_OPTS``). The cases:

  water_b3lyp     cctpu.geomopt.optimizer.optimize of water RKS/B3LYP from
                  the distorted start of tests/test_geomopt.py
                  (``WATER_START``): the steps, every step's energy and the
                  final coordinates (bohr);
  nh2_ub3lyp      the same for the NH2 radical, UKS/B3LYP (``NH2_START``);
  water_b3lyp_fd  at water_b3lyp's final coordinates (read from
                  chip_smoke.py's ``OPT_ORACLES``, so run water_b3lyp and
                  paste its entry first): one SCF, then the sweep of
                  cctpu.hessian.frequencies.hessian_fd warm-started from its
                  density, with dipole derivatives, one row (two displaced
                  SCFs and gradients) per process; harmonic_analysis
                  (frequencies, IR intensities) and thermo (ZPE, E_0K, H, G
                  at 298.15 K and 101325 Pa);
  water_rhf_analytic  at the same coordinates: cctpu's analytic (CPHF)
                  Hessian of the in-core RHF SCF there (``RHF_OPTS``) and
                  its harmonic frequencies. The B3LYP and the DF-RHF ones
                  ran 24-25 min on an 8-core CPU and died unfinished (XLA's
                  CPU compiler ran out of memory maps), so the analytic
                  comparison is made at in-core RHF.

Prints each case's entry of chip_smoke.py's ``OPT_ORACLES`` literal, which
is pasted there: chip_smoke.py is the one home of the numbers.

Usage:  python scripts/make_opt_oracles.py <case>
        Run one case per process: XLA's CPU compiler has crashed processes
        that compiled several cases (ROADMAP.md queue 3 item 2).
"""

import json
import os
import subprocess
import sys
import textwrap
import time
from concurrent.futures import ThreadPoolExecutor

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]

import conftest  # noqa: E402,F401  (the CPU platform, x64, shape knobs)
import numpy as np  # noqa: E402

from cctpu.core.molecule import Molecule  # noqa: E402
from cctpu.dft.rks import RKS, UKS  # noqa: E402
from cctpu_torch.utils.measure import NH2_START, WATER_START  # noqa: E402

FACTORY_OPTS = dict(xc="b3lyp", density_fit=True, grid_level=2,
                    conv_tol=1e-12, conv_tol_grad=1e-8, max_cycle=100)
RHF_OPTS = dict(density_fit=False, conv_tol=1e-12, conv_tol_grad=1e-8,
                max_cycle=100)
FD_STEP = 1e-3     # cctpu's hessian_fd default (bohr)
CASES = {"water_b3lyp": (WATER_START, 0, RKS),
         "nh2_ub3lyp": (NH2_START, 1, UKS)}


def _vec(a, indent: int) -> str:
    """A flat list of floats as a literal wrapped at 79 columns."""
    items = ", ".join(repr(float(x)) for x in np.asarray(a).ravel())
    pad = " " * (indent + 1)
    return "[" + ("\n" + pad).join(
        textwrap.wrap(items, 76 - indent, break_on_hyphens=False)) + "]"


def _entry(name: str, fields: dict) -> str:
    """``name``'s entry of the ``OPT_ORACLES`` literal: scalars and flat
    lists as they are, matrices as lists of rows."""
    out = [f'    "{name}": {{']
    for k, v in fields.items():
        v = np.asarray(v)
        if v.ndim == 2:
            out.append(f'        "{k}": [')
            out += ["            " + _vec(row, 12) + "," for row in v]
            out.append("        ],")
        elif v.ndim == 1:
            out.append(f'        "{k}": ' + _vec(v, 12 + len(k)) + ",")
        else:
            out.append(f'        "{k}": {v.item()!r},')
    return "\n".join(out + ["    },"])


def opt_case(name) -> str:
    from cctpu.geomopt.optimizer import optimize
    atoms, spin, cls = CASES[name]
    mol = Molecule.from_atoms(atoms, spin=spin, basis="6-31g*")
    res = optimize(lambda m: cls(m, **FACTORY_OPTS), mol)
    assert res.converged, name
    return _entry(name, {"nsteps": res.nsteps, "energies": res.energies,
                         "coords": res.mol.coords})


def _water_scf(rhf=False):
    """cctpu's water SCF (RKS, or in-core RHF: ``RHF_OPTS``) at the
    water_b3lyp optimization's final coordinates."""
    from chip_smoke import OPT_ORACLES
    coords = np.asarray(OPT_ORACLES["water_b3lyp"]["coords"])
    mol = Molecule.from_atoms(WATER_START, basis="6-31g*").with_coords(
        coords)
    mol = mol.build()
    if rhf:
        from cctpu.scf.hf import RHF
        mf = RHF(mol, **RHF_OPTS)
    else:
        mf = RKS(mol, **FACTORY_OPTS)
    e = float(mf.kernel())
    assert mf.converged
    return mol, mf, e


def fd_row(k: int) -> str:
    """Row k of cctpu's ``hessian_fd`` sweep (the loop body of
    cctpu/hessian/frequencies.py::hessian_fd: cctpu's SCF at +-FD_STEP
    along coordinate k, warm-started from the reference density, its
    gradient and dipole), as one JSON line."""
    from cctpu.hessian.frequencies import scf_gradient
    mol, mf0, _ = _water_scf()
    ia, d = divmod(k, 3)
    gs, mus = [], []
    for sgn in (+1, -1):
        c = mol.coords.copy()
        c[ia, d] += sgn * FD_STEP
        mf = RKS(mol.with_coords(c), **FACTORY_OPTS)
        mf.opts.verbose = 0
        mf.kernel(dm0=mf0.dm)
        gs.append(np.array(scf_gradient(mf)).ravel().tolist())
        mus.append(np.asarray(mf.dip_moment(unit="au")).tolist())
    return json.dumps({"k": k, "g": gs, "mu": mus})


def fd_case() -> str:
    """cctpu's ``hessian_fd`` with dipoles, one row per process (XLA's CPU
    compiler runs out of memory maps within the 18 SCFs and gradients of
    one process: ROADMAP.md queue 3 item 2), assembled as hessian_fd does;
    then cctpu's harmonic_analysis and thermo."""
    from cctpu.hessian.frequencies import harmonic_analysis
    from cctpu.hessian.thermo import thermo
    mol, _, e = _water_scf()
    n3 = 3 * mol.natm
    H, dmu = np.zeros((n3, n3)), np.zeros((n3, 3))

    def row(k):
        out = subprocess.run([sys.executable, __file__, "_fd_row", str(k)],
                             capture_output=True, text=True, check=True)
        return json.loads(out.stdout.strip().splitlines()[-1])

    with ThreadPoolExecutor(3) as pool:      # three row processes at once
        for r in pool.map(row, range(n3)):
            gs, mus = np.asarray(r["g"]), np.asarray(r["mu"])
            H[r["k"]] = (gs[0] - gs[1]) / (2 * FD_STEP)
            dmu[r["k"]] = (mus[0] - mus[1]) / (2 * FD_STEP)
    H = 0.5 * (H + H.T)
    ha = harmonic_analysis(mol, H, dmu)
    th = thermo(mol, ha.freq_au, e)
    return _entry("water_b3lyp_fd", {
        "E": e, "freq_cm": ha.freq_wavenumber, "ir_km_mol": ha.ir_intensity,
        **{k: th[k][0] for k in ("ZPE", "E_0K", "H_tot", "G_tot")},
        "hessian": H})


def analytic_case() -> str:
    from cctpu.hessian.cphf import analytic_hessian
    from cctpu.hessian.frequencies import harmonic_analysis
    mol, mf, _ = _water_scf(rhf=True)
    H = np.asarray(analytic_hessian(mf))
    ha = harmonic_analysis(mol, H)
    return _entry("water_rhf_analytic", {"freq_cm": ha.freq_wavenumber,
                                         "hessian": H})


def main(argv):
    for name in argv:
        t0 = time.time()
        if name in CASES:
            entry = opt_case(name)
        elif name == "water_b3lyp_fd":
            entry = fd_case()
        elif name == "_fd_row":
            print(fd_row(int(argv[1])), flush=True)
            return
        elif name == "water_rhf_analytic":
            entry = analytic_case()
        else:
            raise SystemExit(f"unknown case {name!r}")
        print(entry, flush=True)
        print(f"# {name}: {time.time() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main(sys.argv[1:])
