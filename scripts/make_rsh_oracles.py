"""cctpu's CPU-f64 energies and gradients with the functionals of the
range-separated slice: the oracles of chip_smoke.py's phases 9a-9e.

For each case: cctpu's own SCF on the CPU in f64 (6-31G*, grid level 2;
DF unless the name says ``incore`` or ``cd``); energy cases (``_e``) at
conv_tol 1e-10, gradient cases at conv_tol 1e-12 and an orbital gradient
<= 1e-8, then cctpu's gradient terms on its converged state with every
contraction in f64: those of
``tests/test_torch_grad.py::cctpu_gradient_terms``, and the long-range
exchange and dispersion terms of ``cctpu_lr_disp_terms``. A gradient
case runs in three processes of this script (``--part scf``, ``terms``,
``lr``), which pass the SCF state and the terms through files in a
temporary directory: one process that compiled the SCF and both sets of
terms ran out of memory maps in XLA's CPU compiler (ROADMAP.md queue 3
item 2).
Prints each case's entry of chip_smoke.py's ``RSH_ORACLES`` literal,
which is pasted there: chip_smoke.py is the one home of the numbers.

Usage:  python scripts/make_rsh_oracles.py <case> [case ...]
        (cases: see ``CASES``). Give each phenol case a process of its own.
"""

import os
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]

import conftest  # noqa: E402,F401  (the CPU platform, x64, shape knobs)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cctpu.core.molecule import Molecule  # noqa: E402
from cctpu.dft.dispersion import dispersion_energy  # noqa: E402
from cctpu.dft.rks import RKS, UKS  # noqa: E402
from cctpu.dft.xc import get_functional  # noqa: E402
from cctpu.grad import df_grad  # noqa: E402
from cctpu.ints.two_electron import energy_2e_grad_eager  # noqa: E402
from cctpu_torch.utils.measure import NH2, PHENOL, WATER  # noqa: E402
from test_torch_grad import cctpu_gradient_terms  # noqa: E402

# name: (atoms, spin, xc, density_fit); NH2 starts from its converged
# UB3LYP density (``START``): the minao guess's occupied factor cuts a
# degenerate eigenspace there, so the first Fock build, and with
# wB97X-D's full long-range exchange the state reached, would depend on
# the eigensolver (ROADMAP.md queue 3 item 4)
CASES = {
    "phenol_wb97xd_e": (PHENOL, 0, "wb97x-d", True),
    "phenol_wb97xd": (PHENOL, 0, "wb97x-d", True),
    "phenol_m062x_e": (PHENOL, 0, "m06-2x", True),
    "water_m062x": (WATER, 0, "m06-2x", True),
    "nh2_uwb97xd": (NH2, 1, "wb97x-d", True),
    "water_wb97xd_incore": (WATER, 0, "wb97x-d", False),
    "water_wb97xd_cd_e": (WATER, 0, "wb97x-d", "cd"),
    "water_wb97xd_cd": (WATER, 0, "wb97x-d", "cd"),
    "water_camb3lyp": (WATER, 0, "cam-b3lyp", True),
}
# water DF energies of the rest of the registry
WATER_XC = ("lda", "lda,vwn3", "pw92", "pbe", "pbe0", "b3lyp5", "m06",
            "cam-b3lyp", "b3lyp-d")
for _xc in WATER_XC:
    CASES[f"water_{_xc.replace(',', '_').replace('-', '')}_e"] = (
        WATER, 0, _xc, True)
START = {"nh2_uwb97xd": "b3lyp"}
STATE = ("dm", "mo_coeff", "mo_occ", "mo_energy")


def cctpu_lr_disp_terms(jmol, jk, dm, xc):
    """cctpu's gradient terms beyond ``cctpu_gradient_terms`` in f64 at a
    density (numpy): the long-range exchange term of a range-separated
    functional (key ``lr``: DF, the 3c and 2c terms at omega on W/Z from
    B_lr and Linv_lr at weight beta minus the same at weight 0; in core
    (``jk`` None), ``energy_2e_grad_eager`` at omega with k_weight beta
    minus 0) and the dispersion gradient (key ``disp``: jax.grad of
    ``dispersion_energy``)."""
    out = {}
    func = get_functional(xc)
    basis, coords = jmol.basis_set, jnp.asarray(jmol.coords)
    if func.rsh is not None:
        omega, _, beta = func.rsh
        if jk is None:
            out["lr"] = (
                energy_2e_grad_eager(basis, coords, jnp.asarray(dm),
                                     k_weight=beta, omega=omega)
                - energy_2e_grad_eager(basis, coords, jnp.asarray(dm),
                                       k_weight=0.0, omega=omega))
        else:
            jk.prepare_lr(omega)
            args = (jnp.asarray(np.asarray(jk._B_lr[omega], np.float64)),
                    jnp.asarray(np.asarray(jk._Linv_lr[omega])),
                    jnp.asarray(dm.sum(0) if dm.ndim == 3 else dm),
                    jnp.asarray(dm if dm.ndim == 3
                                else np.stack([dm / 2, dm / 2])))
            Wb, Zb = df_grad._wz_fn(float(beta))(*args)
            W0, Z0 = df_grad._wz_fn(0.0)(*args)
            out["lr"] = (
                np.asarray(df_grad._grad_3c(basis, jk.aux, coords,
                                             df_grad._pad3(Wb - W0),
                                             omega))
                + np.asarray(df_grad._grad_2c(
                    jk.aux, coords, jnp.pad(Zb - Z0, ((0, 1), (0, 1))),
                    omega)))
    if func.dispersion:
        out["disp"] = np.asarray(jax.grad(
            lambda R: dispersion_energy(func, jmol, R))(coords))
    return out


def _scf(name, xc=None):
    atoms, spin, xc_case, df = CASES[name]
    mol = Molecule.from_atoms(atoms, spin=spin, basis="6-31g*")
    tol = dict(conv_tol=1e-10) if name.endswith("_e") or xc else \
        dict(conv_tol=1e-12, conv_tol_grad=1e-8)
    return (UKS if spin else RKS)(mol, xc=xc or xc_case, density_fit=df,
                                  grid_level=2, max_cycle=100, **tol)


def _converge(name):
    """The case's SCF, converged from ``START``'s density where it has
    one."""
    dm0 = None
    if name in START:
        mf0 = _scf(name, START[name])
        mf0.kernel()
        assert mf0.converged, name
        dm0 = mf0.dm
    mf = _scf(name)
    mf.kernel(dm0=dm0)
    assert mf.converged, name
    return mf


def part(name, which, tmp):
    """One process's part of a gradient case: ``scf`` (the converged state
    to tmp/scf.npz), ``terms`` (cctpu_gradient_terms to tmp/terms.npy) or
    ``lr`` (the long-range and dispersion terms to tmp/lr.npy)."""
    atoms, spin, xc, df = CASES[name]
    if which == "scf":
        mf = _converge(name)
        np.savez(os.path.join(tmp, "scf.npz"), e=float(mf.e_tot),
                 cycles=mf.n_cycles,
                 e_disp=float(dispersion_energy(mf.func, mf.mol)),
                 **{k: np.asarray(getattr(mf, k)) for k in STATE})
        return
    mf = _scf(name)
    st = np.load(os.path.join(tmp, "scf.npz"))
    # a Cholesky SCF's gradient goes direct, as an in-core one's
    jk = mf.get_jk_builder() if df is True else None
    if which == "terms":
        g = cctpu_gradient_terms(mf.mol, jk, *(st[k] for k in STATE), xc=xc,
                                 grid_level=2)["total"]
    else:
        g = sum(cctpu_lr_disp_terms(mf.mol, jk, st["dm"], xc).values(),
                np.zeros((mf.mol.natm, 3)))
    np.save(os.path.join(tmp, f"{which}.npy"), g)


def oracle(name) -> str:
    """The case's entry of ``RSH_ORACLES``: the energy, or {"E", "grad"}
    (Ha, Ha/bohr), with the cycle count and the dispersion energy in a
    comment."""
    if name.endswith("_e"):
        mf = _converge(name)
        e = float(mf.e_tot)
        return (f'    "{name}": {e!r},  # {int(mf.n_cycles)} cycles, '
                f"E_disp {float(dispersion_energy(mf.func, mf.mol)):.6e}")
    with tempfile.TemporaryDirectory() as tmp:
        for which in ("scf", "terms", "lr"):
            subprocess.run([sys.executable, os.path.abspath(__file__), name,
                            "--part", which, tmp], check=True)
        st = np.load(os.path.join(tmp, "scf.npz"))
        g = np.load(os.path.join(tmp, "terms.npy")) \
            + np.load(os.path.join(tmp, "lr.npy"))
        e, cycles, e_disp = float(st["e"]), int(st["cycles"]), \
            float(st["e_disp"])
    rows = "".join("            [" + ", ".join(f"{x:.12e}" for x in row)
                   + "],\n" for row in g)
    return (f'    "{name}": {{  # {cycles} cycles, E_disp {e_disp:.6e}\n'
            f'        "E": {e!r},\n        "grad": [\n{rows}        ],\n'
            "    },")


def main(argv):
    df_grad._GVAL_ON = False         # a TPU guard, not math
    if len(argv) == 4 and argv[1] == "--part":
        part(argv[0], argv[2], argv[3])
        return
    for name in argv:
        t0 = time.time()
        print(oracle(name), flush=True)
        print(f"# {name}: {time.time() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main(sys.argv[1:])
