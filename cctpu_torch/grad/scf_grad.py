"""Analytic nuclear gradient of a converged SCF.

Port of ``cctpu/grad/scf_grad.py::scf_gradient_eager``: the standard
analytic-gradient expression

  dE/dR = Tr[D dH/dR] - Tr[W dS/dR] + dE_2e/dR + dExc/dR|_D + dEnuc/dR

assembled term by term on the SCF's device in f64. The 1e and nuclear
terms are autograd of the integral builders; the XC term, with the
grid-weight derivatives, is the functional's ``exc_of_coords``. The
two-electron term of a density-fitted SCF is ``grad/df_grad.py``; that of
an in-core or Cholesky SCF is the direct term, autograd of the exact
E_2e through the quartet kernel (as in cctpu, a Cholesky SCF's gradient
goes direct). A range-separated functional adds its long-range exchange
term (the attenuated operator) on either route, and a dispersion
correction its gradient by autograd. No CPHF is needed for SCF
gradients.

PyTorch runs one eager path, so cctpu's single traced ``scf_gradient`` and
its platform dispatch (both there for a whole-program compiler) have no
counterpart here.
"""

from __future__ import annotations

import torch

from cctpu_torch.dft.dispersion import dispersion_energy
from cctpu_torch.grad.df_grad import _GRAD_BUDGET, df_e2_gradient, \
    grad_of_walk
from cctpu_torch.ints.one_electron import build_int1e_eager
from cctpu_torch.ints.two_electron import chunk_energy_2e, e2_densities, \
    walk_4c
from cctpu_torch.utils.profiling import phase


def _energy_weighted_dm(mf) -> torch.Tensor:
    """W = sum_i n_i e_i C_i C_i^T, summed over both spins for UHF/UKS."""
    C, occ, e = mf.mo_coeff, mf.mo_occ, mf.mo_energy
    if C.ndim == 3:
        return sum((C[s] * (occ[s] * e[s])[None, :]) @ C[s].T
                   for s in range(2))
    return (C * (occ * e)[None, :]) @ C.T


def _check_supported(mf):
    if getattr(mf, "_pcm", None) is not None:
        raise NotImplementedError(
            "the PCM solvation gradient is not ported (ROADMAP.md queue 1 "
            "item 14)")
    if mf.density_fit == "compressed":
        raise NotImplementedError(
            "the pair-compressed DF gradient is not ported (ROADMAP.md "
            "queue 1 item 19)")


def direct_e2_gradient(mf, timer=None) -> torch.Tensor:
    """d(E_2e)/dR [natm, 3] of the exact two-electron energy at ``mf.dm``
    (``energy_2e_direct`` with the functional's exchange weight):
    autograd through the quartet kernel, one ``walk_4c`` chunk at a time.
    A range-separated functional adds its long-range exchange, the
    exchange part alone of the attenuated operator at weight beta (cctpu:
    E_2e at beta minus at 0, where the J parts cancel). ``timer``
    receives the phases ``2e`` and ``2e_lr``."""
    func = getattr(mf, "func", None)

    def walk(Dt, Dks, kw, omega=None):
        return grad_of_walk(
            walk_4c(mf.mol.basis_set, mf.coords, budget=_GRAD_BUDGET),
            mf.coords, lambda blocks, rows, mult: chunk_energy_2e(
                blocks, rows, mult, Dt, Dks, kw), omega)

    with phase(timer, "2e"):
        g = walk(*e2_densities(mf.dm, 1.0 if func is None else func.hyb))
    rsh = getattr(func, "rsh", None)
    if rsh is not None:
        omega, _, beta = rsh
        _, Dks, kw = e2_densities(mf.dm, beta)
        with phase(timer, "2e_lr"):
            g = g + walk(None, Dks, kw, omega)
    return g


def gradient(mf, timer=None) -> torch.Tensor:
    """dE/dR [natm, 3] (Ha/bohr, f64, on the SCF's device) of a converged
    RHF, UHF, RKS or UKS ``mf`` (density-fitted, in-core or Cholesky) at
    ``mf.mol``'s geometry.

    ``timer``, a ``utils.profiling.PhaseTimer``, receives the seconds of
    each term: ``1e``, ``xc``, ``nuc`` and ``wz``, ``3c``, ``2c`` (DF) or
    ``2e`` (in-core, Cholesky); with a range-separated functional also
    ``3c_lr`` and ``2c_lr`` (DF) or ``2e_lr``, with a dispersion
    correction ``disp``."""
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
    if mf.density_fit in (False, None, "cd"):
        g = g + direct_e2_gradient(mf, timer)
    else:
        g = g + df_e2_gradient(mf, timer)
    func = getattr(mf, "func", None)
    if func is not None and func.exc is not None:
        with phase(timer, "xc"):
            g = g + mf.exc_of_coords(mf.coords, dm)[1]
    if getattr(func, "dispersion", None):
        with phase(timer, "disp"):
            leaf = mf.coords.detach().requires_grad_(True)
            with torch.enable_grad():
                gd, = torch.autograd.grad(
                    dispersion_energy(func, mol, leaf), leaf)
            g = g + gd
    with phase(timer, "nuc"):
        leaf = mf.coords.detach().requires_grad_(True)
        with torch.enable_grad():
            gn, = torch.autograd.grad(mol.energy_nuc_t(leaf), leaf)
        g = g + gn
    return g
