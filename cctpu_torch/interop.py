"""State carried across from cctpu as plain numpy: basis, molecule, density.

The state of this system is the basis and the density, not weights. These
helpers build the port's objects from numpy data (as exported from the
JAX package's ``BasisSet.shells``, ``Molecule`` and converged ``dm``), so
the same basis, coordinates and starting density can be fed to both.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from cctpu_torch.core.basis import BasisSet, Shell
from cctpu_torch.core.molecule import Molecule
from cctpu_torch.device import DTYPE, default_device


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
    """A density matrix as an f64 tensor on the port's device."""
    return torch.tensor(np.asarray(dm, dtype=np.float64), dtype=DTYPE,
                        device=default_device() if device is None
                        else device)
