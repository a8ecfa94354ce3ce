"""cctpu's CPU-f64 in-core energies and gradients: the oracles of
chip_smoke.py's in-core phases (7b, 7e).

For each case: cctpu's own in-core SCF (``density_fit=False``, 6-31G*,
grid level 2) on the CPU in f64; for the gradient cases (conv_tol 1e-12,
orbital gradient <= 1e-8) then cctpu's gradient terms on its converged
state, the two-electron term by ``energy_2e_grad_eager`` (the assembly of
``tests/test_torch_grad.py::cctpu_gradient_terms`` with ``jk=None``).
Prints each case's entry of chip_smoke.py's ``INCORE_ORACLES`` literal,
which is pasted there: chip_smoke.py is the one home of the numbers.

Usage:  python scripts/make_incore_oracles.py <case>
        (cases: phenol_b3lyp_e, the energy at conv_tol 1e-10;
         water_rhf water_b3lyp nh2_ub3lyp, the gradients). Run one case per
        process: XLA's CPU compiler has crashed processes that compiled
        several cases (ROADMAP.md queue 3 item 2).
"""

import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]

import conftest  # noqa: E402,F401  (the CPU platform, x64, shape knobs)
import numpy as np  # noqa: E402

from cctpu.core.molecule import Molecule  # noqa: E402
from cctpu.dft.rks import RKS, UKS  # noqa: E402
from cctpu.scf.hf import RHF  # noqa: E402
from cctpu_torch.utils.measure import NH2, PHENOL, WATER  # noqa: E402
from test_torch_grad import cctpu_gradient_terms  # noqa: E402

CASES = {
    "phenol_b3lyp_e": (PHENOL, 0, RKS, "b3lyp"),
    "water_rhf": (WATER, 0, RHF, None),
    "water_b3lyp": (WATER, 0, RKS, "b3lyp"),
    "nh2_ub3lyp": (NH2, 1, UKS, "b3lyp"),
}


def oracle(name) -> str:
    """The case's entry of ``INCORE_ORACLES``: the energy, or the gradient
    (Ha/bohr) with cctpu's energy and cycle count in a comment."""
    atoms, spin, cls, xc = CASES[name]
    mol = Molecule.from_atoms(atoms, spin=spin, basis="6-31g*")
    kw = {} if xc is None else dict(xc=xc, grid_level=2)
    energy_only = name.endswith("_e")
    tol = dict(conv_tol=1e-10) if energy_only else \
        dict(conv_tol=1e-12, conv_tol_grad=1e-8)
    mf = cls(mol, density_fit=False, max_cycle=100, **tol, **kw)
    e = float(mf.kernel())
    assert mf.converged, name
    if energy_only:
        return (f'    "{name}": {e!r},  # {int(mf.n_cycles)} cycles')
    g = cctpu_gradient_terms(
        mol, None, *(np.asarray(x) for x in (mf.dm, mf.mo_coeff,
                                             mf.mo_occ, mf.mo_energy)),
        xc=xc, grid_level=2)["total"]
    rows = "".join("        [" + ", ".join(f"{x:.12e}" for x in row)
                   + "],\n" for row in g)
    return (f'    "{name}": [  # E {e!r}, {int(mf.n_cycles)} cycles\n'
            f"{rows}    ],")


def main(argv):
    for name in argv:
        t0 = time.time()
        print(oracle(name), flush=True)
        print(f"# {name}: {time.time() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main(sys.argv[1:])
