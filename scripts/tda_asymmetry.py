"""How far the TDA operator of cctpu's formulation is from symmetric, and
whether its Davidson converges from a start moved by roundoff.

    python scripts/tda_asymmetry.py [cpu|cuda] [nh2|water] [nstates]

``nh2``: NH2 DF-UB3LYP/6-31G* (grid level 2); ``water``: water
DF-CAM-B3LYP/6-31G* (grid level 3, as ``uv --method cam-b3lyp --tda
--density-fit`` runs it). Both SCFs at conv_tol 1e-12 and an orbital
gradient <= 1e-9. Builds the dense TDA matrix A from the port's matvec
(``response/tddft.py``, which is cctpu's function) and prints |A - A^T|
and the asymmetry of each piece in the MO basis: J, K and the XC kernel.
With a GGA the XC piece is not symmetric: the kernel acts on P = Co X
Cv^T, which is not symmetric, and the GGA term of E_xc[D] depends on P's
antisymmetric part (ROADMAP.md queue 3).

Then the TDA's Davidson (``nstates`` states, 6 by default as in ``uv``;
tol 1e-6) from the converged orbitals as they are, and from the orbitals
times (1 + 1e-13 * z), z drawn from a standard normal by numpy's
``default_rng(seed)`` for seeds 0, 1, 2: an SCF that differs in its last
digits, as the card's does from the CPU's; then from the orbitals as they
are with every product of the operator times (1 + 1e-14 * z), z drawn
afresh for each product from ``default_rng(seed)``: the roundoff of
another summation order (the card's kernels and grid sums). Prints each
run's convergence, vectors and its largest excitation-energy move from
the unperturbed run (eV).
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cctpu_torch.core.molecule import Molecule  # noqa: E402
from cctpu_torch.dft.rks import RKS, UKS  # noqa: E402
from cctpu_torch.response.tddft import TDDFT  # noqa: E402
from cctpu_torch.utils.measure import NH2, WATER  # noqa: E402

HARTREE2EV = 27.211386024367243
CASES = {"nh2": (UKS, NH2, 1, "b3lyp", 2),
         "water": (RKS, WATER, 0, "cam-b3lyp", 3)}


def asymmetry(mf, device):
    td = TDDFT(mf, tda=True)
    td._setup()
    if not td.unrestricted:
        A = td._mv_flat(td._a_mv)(np.eye(td.nocc * td.nvir))
        print(f"{device}: nov {len(A)}, max |A| {np.abs(A).max():.6g}, "
              f"max |A - A^T| {np.abs(A - A.T).max():.6g}")
        return
    n, sa = sum(td._sizes), td._sizes[0]
    A = td._mv_flat(td._a_mv)(np.eye(n))
    print(f"{device}: nov {n}, max |A| {np.abs(A).max():.6g}, "
          f"max |A - A^T| {np.abs(A - A.T).max():.6g}")
    Co, Cv = td.Co_s, td.Cv_s
    eye = torch.eye(n, dtype=torch.float64, device=mf.device)
    X = [eye[:, :sa], eye[:, sa:]]
    X = [x.reshape(n, Co[s].shape[1], Cv[s].shape[1])
         for s, x in enumerate(X)]
    P = torch.stack([Co[s] @ X[s] @ Cv[s].T for s in range(2)], 1)
    f = mf.fxc_operator(mf.dm)(P)
    pieces = {"J": td.jk.j(P[:, 0] + P[:, 1])[:, None].expand_as(P),
              "K": td.jk.k(P.reshape(-1, *P.shape[-2:])).reshape(P.shape),
              "fxc": 0.5 * (f + f.transpose(-1, -2))}
    for name, V in pieces.items():
        M = torch.cat([(Co[s].T @ V[:, s] @ Cv[s]).flatten(1)
                       for s in range(2)], 1).cpu().numpy()
        print(f"  {name}: max |M - M^T| {np.abs(M - M.T).max():.6g}, "
              f"max |M| {np.abs(M).max():.6g}")


def davidson_starts(mf, nstates):
    C0 = mf.mo_coeff.clone()
    e0 = None
    for seed in (None, 0, 1, 2):
        if seed is not None:
            z = np.random.default_rng(seed).standard_normal(C0.shape)
            mf.mo_coeff = C0 * (1 + 1e-13 * torch.as_tensor(
                z, dtype=C0.dtype, device=C0.device))
        td = TDDFT(mf, nstates=nstates, tda=True)
        e = np.asarray(td.kernel()) * HARTREE2EV
        e0 = e if e0 is None else e0
        report(f"orbitals seed {seed}", td, e, e0)
    mf.mo_coeff = C0
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        td = TDDFT(mf, nstates=nstates, tda=True)
        flat = td._mv_flat

        def noisy(mv, flat=flat, rng=rng):
            f = flat(mv)

            def g(X):
                Y = f(X)
                return Y * (1 + 1e-14 * rng.standard_normal(Y.shape))
            return g
        td._mv_flat = noisy
        e = np.asarray(td.kernel()) * HARTREE2EV
        report(f"operator seed {seed}", td, e, e0)


def report(tag, td, e, e0):
    print(f"  {tag}: converged {td.converged}, vectors {td.n_matvec}, "
          f"max |dE| {np.abs(e - e0).max():.3g} eV, "
          f"E {np.round(e, 6).tolist()}", flush=True)


def main(device="cpu", case="nh2", nstates="6"):
    cls, atoms, spin, xc, grid = CASES[case]
    mol = Molecule.from_atoms(atoms, spin=spin, basis="6-31g*")
    mf = cls(mol, xc=xc, density_fit=True, grid_level=grid,
             conv_tol=1e-12, conv_tol_grad=1e-9, max_cycle=100,
             device=device)
    mf.kernel()
    print(f"{case} {xc}: E {mf.e_tot!r}, converged {mf.converged}")
    asymmetry(mf, device)
    davidson_starts(mf, int(nstates))


if __name__ == "__main__":
    main(*sys.argv[1:])
