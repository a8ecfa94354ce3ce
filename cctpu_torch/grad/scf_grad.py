"""Analytic nuclear gradient of a converged density-fitted SCF.

Port of ``cctpu/grad/scf_grad.py::scf_gradient_eager(mf, df=True)``: the
standard analytic-gradient expression

  dE/dR = Tr[D dH/dR] - Tr[W dS/dR] + dE_2e/dR|_DF + dExc/dR|_D + dEnuc/dR

assembled term by term on the SCF's device in f64. The 1e and nuclear
terms are autograd of the integral builders; the DF two-electron term is
``grad/df_grad.py``; the XC term, with the grid-weight derivatives, is the
functional's ``exc_of_coords``. No CPHF is needed for SCF gradients.

PyTorch runs one eager path, so cctpu's single traced ``scf_gradient`` and
its platform dispatch (both there for a whole-program compiler) have no
counterpart here.
"""

from __future__ import annotations

import torch

from cctpu_torch.grad.df_grad import df_e2_gradient
from cctpu_torch.ints.one_electron import build_int1e_eager
from cctpu_torch.utils.profiling import phase


def _energy_weighted_dm(mf) -> torch.Tensor:
    """W = sum_i n_i e_i C_i C_i^T, summed over both spins for UHF/UKS."""
    C, occ, e = mf.mo_coeff, mf.mo_occ, mf.mo_energy
    if C.ndim == 3:
        return sum((C[s] * (occ[s] * e[s])[None, :]) @ C[s].T
                   for s in range(2))
    return (C * (occ * e)[None, :]) @ C.T


def _check_supported(mf):
    func = getattr(mf, "func", None)
    if getattr(func, "dispersion", None):
        raise NotImplementedError(
            f"{func.name}: the dispersion correction and its gradient are "
            "not ported (ROADMAP.md queue 1 item 10)")
    if getattr(mf, "_pcm", None) is not None:
        raise NotImplementedError(
            "the PCM solvation gradient is not ported (ROADMAP.md queue 1 "
            "item 14)")
    if mf.density_fit is not True:
        raise NotImplementedError(
            f"density_fit={mf.density_fit!r}: only the dense density-fitted "
            "gradient is ported; in-core and Cholesky J/K are ROADMAP.md "
            "queue 1 item 9")


def gradient(mf, timer=None) -> torch.Tensor:
    """dE/dR [natm, 3] (Ha/bohr, f64, on the SCF's device) of a converged
    density-fitted RHF, UHF, RKS or UKS ``mf`` at ``mf.mol``'s geometry.

    ``timer``, a ``utils.profiling.PhaseTimer``, receives the seconds of
    each term: ``1e``, ``wz``, ``3c``, ``2c``, ``xc`` and ``nuc``."""
    _check_supported(mf)
    if mf.dm is None or mf.mo_coeff is None:
        raise ValueError("gradient needs a converged SCF: run kernel() "
                         "first")
    mol = mf.mol
    dm = mf.dm
    Dt = dm.sum(0) if dm.ndim == 3 else dm
    charges = torch.as_tensor(mol.charges, dtype=dm.dtype, device=dm.device)

    with phase(timer, "1e"):
        W = _energy_weighted_dm(mf)
        leaf = mf.coords.detach().requires_grad_(True)
        with torch.enable_grad():
            ints = build_int1e_eager(mol.basis_set, leaf, charges)
            e1 = (torch.einsum("ij,ij->", Dt, ints["T"] + ints["V"])
                  - torch.einsum("ij,ij->", W, ints["S"]))
            g, = torch.autograd.grad(e1, leaf)
        del ints
    g = g + df_e2_gradient(mf, timer)
    func = getattr(mf, "func", None)
    if func is not None and func.exc is not None:
        with phase(timer, "xc"):
            g = g + mf.exc_of_coords(mf.coords, dm)[1]
    with phase(timer, "nuc"):
        leaf = mf.coords.detach().requires_grad_(True)
        with torch.enable_grad():
            gn, = torch.autograd.grad(mol.energy_nuc_t(leaf), leaf)
        g = g + gn
    return g
