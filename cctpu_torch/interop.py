"""State carried across from cctpu as plain numpy: basis, molecule,
density-fitting tensors, the in-core ERI tensor and a converged SCF
state.

The state of this system is the basis and the density, not weights. These
helpers build the port's objects from numpy data (as exported from the
JAX package's ``BasisSet.shells``, ``Molecule``, ``DFJK`` and a converged
SCF), so both packages can be fed exactly the same inputs.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from cctpu_torch.core.basis import BasisSet, Shell
from cctpu_torch.core.molecule import Molecule
from cctpu_torch.device import DTYPE, default_device
from cctpu_torch.ints.df import DFJK
from cctpu_torch.scf.hf import IncoreJK


def basis_from_numpy(shells: Iterable, coords_bohr: np.ndarray) -> BasisSet:
    """BasisSet from shell data: each shell is (atom, l, exps, coefs) or an
    object with those attributes; ``coefs`` are the normalized contraction
    coefficients as stored on cctpu's shells."""
    out: List[Shell] = []
    for sh in shells:
        if isinstance(sh, (tuple, list)):
            atom, l, exps, coefs = sh
        else:
            atom, l, exps, coefs = sh.atom, sh.l, sh.exps, sh.coefs
        out.append(Shell(atom=int(atom), l=int(l),
                         exps=np.array(exps, dtype=np.float64),
                         coefs=np.array(coefs, dtype=np.float64)))
    return BasisSet(out, np.asarray(coords_bohr, dtype=np.float64))


def molecule_from_numpy(symbols: Sequence[str], coords_bohr: np.ndarray,
                        charge: int = 0, spin: int = 0,
                        basis="sto-3g") -> Molecule:
    """Molecule at the given Bohr coordinates. ``basis`` is a basis name
    or a prebuilt BasisSet (e.g. from ``basis_from_numpy``)."""
    coords = np.array(coords_bohr, dtype=np.float64).reshape(-1, 3)
    if isinstance(basis, BasisSet):
        mol = Molecule(symbols=list(symbols), coords=coords, charge=charge,
                       spin=spin, basis="custom")
        mol._basis_set = basis
        return mol
    return Molecule(symbols=list(symbols), coords=coords, charge=charge,
                    spin=spin, basis=basis)


def dm_from_numpy(dm: np.ndarray,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """A density matrix as an f64 tensor on ``device`` (default: the
    card)."""
    return torch.tensor(np.asarray(dm, dtype=np.float64), dtype=DTYPE,
                        device=default_device(device))


def dfjk_from_numpy(aux_shells: Iterable, coords_bohr: np.ndarray,
                    B: np.ndarray, Linv: np.ndarray,
                    device: Optional[torch.device] = None) -> DFJK:
    """The port's DF-J/K builder on given tensors: the aux basis from shell
    data (as ``basis_from_numpy``), B [nkeep, nao, nao] and the metric
    factor Linv [nkeep, naux] (M^+ = Linv^T Linv). Set it as an SCF's
    ``_jk`` before ``kernel()`` to run the SCF and its gradient on them."""
    return DFJK.from_tensors(basis_from_numpy(aux_shells, coords_bohr),
                             dm_from_numpy(B, device), dm_from_numpy(Linv,
                                                                     device))


def eri_from_numpy(eri: np.ndarray,
                   device: Optional[torch.device] = None) -> IncoreJK:
    """The port's in-core J/K builder on a given (ij|kl) tensor [nao, nao,
    nao, nao] (cctpu's ``build_eri_incore``, say). Set it as an SCF's
    ``_jk`` before ``kernel()`` to run the SCF on those integrals."""
    return IncoreJK.from_eri(dm_from_numpy(eri, device))


def set_scf_state(mf, dm: np.ndarray, mo_coeff: np.ndarray,
                  mo_occ: np.ndarray, mo_energy: np.ndarray):
    """Put a converged SCF state on the port's SCF object ``mf`` (on its
    device): the density, orbitals, occupations and orbital energies that
    the gradient reads. [2, ...] arrays for UHF/UKS."""
    for name, x in (("dm", dm), ("mo_coeff", mo_coeff), ("mo_occ", mo_occ),
                    ("mo_energy", mo_energy)):
        setattr(mf, name, dm_from_numpy(x, mf.device))
    mf.converged = True
    return mf
