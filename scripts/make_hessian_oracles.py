"""cctpu's CPU-f64 analytic (CPHF) Hessians: the oracles of
tests/test_torch_hessian.py.

Every case is cctpu's own SCF on the CPU in f64 at STO-3G (conv_tol 1e-12,
orbital gradient <= 1e-9, ``SCF_OPTS``), then
cctpu.hessian.cphf.analytic_hessian(mf, with_dipole=True): the Cartesian
Hessian (Ha/bohr^2) and the dipole derivatives dmu/dR (a.u.). The cases
(geometries in Angstrom, cctpu_torch/utils/measure.py and cctpu's
tests/test_analytic_hessian.py):

  water_rhf          water RHF in core
  oh_uhf             the OH radical UHF in core (spin 1, O-H 0.97 A)
  water_lda          water LDA in core, grid level 2
  h2_camb3lyp        H2 CAM-B3LYP in core (H-H 0.74 A), grid level 2
  water_df_rhf       water DF-RHF
  water_df_b3lyp     water DF-B3LYP, grid level 1
  nh2_df_ulda        the NH2 radical DF-ULDA (spin 1), grid level 1

``<case>_fd`` gives cctpu's hessian_fd (with dipoles, warm-started from
the SCF's density) of a case instead: the route for a case whose analytic
Hessian does not finish on the CPU. Every case above finished; the times
are printed on stderr.

Prints each case's entry of tests/test_torch_hessian.py's ``ORACLES``
literal, which is pasted there: the test file is the one home of the
numbers.

Usage:  python scripts/make_hessian_oracles.py <case>
        Run one case per process: XLA's CPU compiler has crashed processes
        that compiled several cases (ROADMAP.md queue 3 item 2).
"""

import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests"),
                os.path.join(_ROOT, "scripts")]

import conftest  # noqa: E402,F401  (the CPU platform, x64, shape knobs)
import numpy as np  # noqa: E402

from cctpu.core.molecule import Molecule  # noqa: E402
from cctpu_torch.utils.measure import NH2, WATER  # noqa: E402
from make_opt_oracles import _entry  # noqa: E402

OH = "O 0 0 0; H 0 0 0.97"
H2 = "H 0 0 0; H 0 0 0.74"
SCF_OPTS = dict(conv_tol=1e-12, conv_tol_grad=1e-9, max_cycle=200)
# name: (atoms, spin, SCF class, its options)
CASES = {
    "water_rhf": (WATER, 0, "RHF", {}),
    "oh_uhf": (OH, 1, "UHF", {}),
    "water_lda": (WATER, 0, "RKS", dict(xc="lda", grid_level=2)),
    "h2_camb3lyp": (H2, 0, "RKS", dict(xc="cam-b3lyp", grid_level=2)),
    "water_df_rhf": (WATER, 0, "RHF", dict(density_fit=True)),
    "water_df_b3lyp": (WATER, 0, "RKS",
                       dict(xc="b3lyp", grid_level=1, density_fit=True)),
    "nh2_df_ulda": (NH2, 1, "UKS",
                    dict(xc="lda", grid_level=1, density_fit=True)),
}


def scf_class(name):
    from cctpu.dft import rks
    from cctpu.scf import hf
    return {"RHF": hf.RHF, "UHF": hf.UHF, "RKS": rks.RKS,
            "UKS": rks.UKS}[name]


def case(name: str, fd: bool) -> str:
    atoms, spin, cls_name, opts = CASES[name]
    cls = scf_class(cls_name)
    mol = Molecule.from_atoms(atoms, spin=spin, basis="sto-3g").build()

    def factory(m):
        return cls(m, **opts, **SCF_OPTS)

    mf = factory(mol)
    e = float(mf.kernel())
    assert mf.converged, name
    if fd:
        from cctpu.hessian.frequencies import hessian_fd
        H, dmu = hessian_fd(factory, mol, dm0=mf.dm, with_dipole=True)
    else:
        from cctpu.hessian.cphf import analytic_hessian
        H, dmu = analytic_hessian(mf, with_dipole=True)
    return _entry(name, {"route": "fd" if fd else "analytic", "E": e,
                         "hessian": np.asarray(H),
                         "dmu_dR": np.asarray(dmu)})


def main(argv):
    for arg in argv:
        t0 = time.time()
        name = arg[:-3] if arg.endswith("_fd") else arg
        if name not in CASES:
            raise SystemExit(f"unknown case {arg!r}")
        print(case(name, arg.endswith("_fd")), flush=True)
        print(f"# {arg}: {time.time() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main(sys.argv[1:])
