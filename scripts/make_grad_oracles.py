"""cctpu's CPU-f64 DF nuclear gradients: the oracles of chip_smoke.py's
gradient phases.

For each case: cctpu's own SCF (DF, 6-31G*, grid level 2, conv_tol 1e-12,
orbital gradient <= 1e-8) on the CPU in f64, then cctpu's gradient terms on
its converged state with the W/Z assembly in f64 (the assembly of
``tests/test_torch_grad.py::cctpu_gradient_terms``). Prints each case's
entry of chip_smoke.py's ``GRAD_ORACLES`` literal, which is pasted there:
chip_smoke.py is the one home of the numbers.

Usage:  python scripts/make_grad_oracles.py [case ...]
        (cases: water_rhf water_b3lyp nh2_ub3lyp phenol_b3lyp
         phenoxyl_ub3lyp; default: the first three). Give each of the two
        large cases a process of its own: XLA's CPU compiler ran out of
        memory maps with both in one (ROADMAP.md queue 3 item 2).
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
from cctpu.grad import df_grad  # noqa: E402
from cctpu.scf.hf import RHF  # noqa: E402
from cctpu_torch.utils.measure import NH2, PHENOL, PHENOXYL, WATER  # noqa
from test_torch_grad import cctpu_gradient_terms  # noqa: E402

CASES = {
    "water_rhf": (WATER, 0, RHF, None),
    "water_b3lyp": (WATER, 0, RKS, "b3lyp"),
    "nh2_ub3lyp": (NH2, 1, UKS, "b3lyp"),
    "phenol_b3lyp": (PHENOL, 0, RKS, "b3lyp"),
    "phenoxyl_ub3lyp": (PHENOXYL, 1, UKS, "b3lyp"),
}


def oracle(name) -> str:
    """The case's entry of ``GRAD_ORACLES``: its gradient (Ha/bohr), with
    cctpu's energy and cycle count in a comment."""
    atoms, spin, cls, xc = CASES[name]
    mol = Molecule.from_atoms(atoms, spin=spin, basis="6-31g*")
    kw = {} if xc is None else dict(xc=xc, grid_level=2)
    mf = cls(mol, density_fit=True, conv_tol=1e-12, conv_tol_grad=1e-8,
             max_cycle=100, **kw)
    e = float(mf.kernel())
    assert mf.converged, name
    g = cctpu_gradient_terms(
        mol, mf._jk, *(np.asarray(x) for x in (mf.dm, mf.mo_coeff,
                                               mf.mo_occ, mf.mo_energy)),
        xc=xc, grid_level=2)["total"]
    rows = "".join("        [" + ", ".join(f"{x:.12e}" for x in row)
                   + "],\n" for row in g)
    return (f'    "{name}": [  # E {e!r}, {int(mf.n_cycles)} cycles\n'
            f"{rows}    ],")


def main(argv):
    df_grad._GVAL_ON = False         # a TPU guard, not math
    for name in argv or ["water_rhf", "water_b3lyp", "nh2_ub3lyp"]:
        t0 = time.time()
        entry = oracle(name)
        print(entry, flush=True)
        print(f"# {name}: {time.time() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main(sys.argv[1:])
