"""Empirical dispersion corrections (DFT-D2, two damping forms).

Port of ``cctpu/dft/dispersion.py``. Grimme's D2 (J. Comput. Chem. 27,
1787 (2006)):
  E_disp = -s6 * sum_{i<j} C6_ij / R_ij^6 * f_damp(R_ij),
  C6_ij = sqrt(C6_i C6_j), Fermi damping f = 1/(1 + exp(-d (R/Rr - 1))),
  d = 20.
Chai-Head-Gordon damping (wB97X-D, PCCP 10, 6615 (2008)):
  f = 1/(1 + a (R/Rr)^{-12}), a = 6.0, s6 = 1.

The energy is a torch function of the nuclear coordinates, so the SCF's
energy and, by autograd, the nuclear gradient come from the same code.
Dispatch follows ``XCFunctional.dispersion`` ('d2' | 'd2-chg').
Parameters: the published D2 tables (C6 in J nm^6/mol, R_r in Angstrom).
"""

from __future__ import annotations

import numpy as np
import torch

from cctpu_torch.core.constants import ANG2BOHR

# C6 (J nm^6 mol^-1) and vdW radii (Angstrom), Grimme 2006 Table 1
_C6 = {1: 0.14, 2: 0.08, 3: 1.61, 4: 1.61, 5: 3.13, 6: 1.75, 7: 1.23,
       8: 0.70, 9: 0.75, 10: 0.63, 11: 5.71, 12: 5.71, 13: 10.79,
       14: 9.23, 15: 7.84, 16: 5.57, 17: 5.07, 18: 4.61,
       19: 10.80, 20: 10.80, 35: 12.47, 53: 31.50}
_R0 = {1: 1.001, 2: 1.012, 3: 0.825, 4: 1.408, 5: 1.485, 6: 1.452,
       7: 1.397, 8: 1.342, 9: 1.287, 10: 1.243, 11: 1.144, 12: 1.364,
       13: 1.639, 14: 1.716, 15: 1.705, 16: 1.683, 17: 1.639, 18: 1.595,
       19: 1.485, 20: 1.474, 35: 1.749, 53: 1.892}

S6 = {"blyp": 1.2, "b3lyp": 1.05, "b3lyp5": 1.05, "pbe": 0.75,
      "pbe0": 0.6, "cam-b3lyp": 1.0, "wb97x-d": 1.0, "m06-2x": 0.06,
      "m06": 0.25}

_JNM6_TO_AU = 17.34527758637742   # J nm^6/mol -> Ha bohr^6


def _pair_tables(Z, like: torch.Tensor):
    """(C6_ij on the upper triangle, Rr_ij) [natm, natm] as tensors of
    ``like``'s dtype and device; ghost atoms (Z = 0) carry no dispersion."""
    Z = np.asarray(Z).astype(int)
    c6 = np.array([_C6.get(int(z), 1.75) for z in Z]) * _JNM6_TO_AU
    r0 = np.array([_R0.get(int(z), 1.5) for z in Z]) * ANG2BOHR
    real = (Z > 0).astype(float)
    c6ij = np.sqrt(np.outer(c6, c6)) * np.outer(real, real)
    rrij = r0[:, None] + r0[None, :]
    mask = np.triu(np.ones((len(Z), len(Z))), k=1)
    return (like.new_tensor(c6ij * mask), like.new_tensor(rrij))


# Fermi damping steepness d (D2) and the Chai-Head-Gordon constant a
_D = 20.0
_A = 6.0


def dispersion_energy(func, mol, coords=None):
    """The dispersion term of an XCFunctional (0 without
    ``func.dispersion``): D2 with the functional's s6, CHG damping for
    'd2-chg', Fermi damping for 'd2'. In Hartree: a 0-d tensor
    differentiable in ``coords`` [natm, 3] (bohr) when they are given, else
    a float at ``mol.coords``."""
    kind = getattr(func, "dispersion", None)
    if not kind:
        return 0.0 if coords is None else torch.zeros(
            (), dtype=coords.dtype, device=coords.device)
    s6key = func.name.lower()
    if s6key not in S6:
        for suf in ("-d2", "-d"):
            if s6key.endswith(suf):
                s6key = s6key[:-len(suf)]
                break
    s6 = S6.get(s6key, 1.0)
    R = torch.as_tensor(mol.coords if coords is None else coords,
                        dtype=torch.float64)
    c6ij, rrij = _pair_tables(mol.charges, R)
    diff = R[:, None, :] - R[None, :, :]
    r2 = torch.sum(diff * diff, -1) + torch.eye(R.shape[0], dtype=R.dtype,
                                                device=R.device)
    rij = torch.sqrt(r2)
    x = rij / rrij
    if kind == "d2-chg":
        fd = 1.0 / (1.0 + _A * x ** (-12))
    else:
        fd = 1.0 / (1.0 + torch.exp(-_D * (x - 1.0)))
    e = -s6 * torch.sum(c6ij / rij ** 6 * fd)
    return e if coords is not None else float(e)
