"""Molecule: the central structure object (PySCF ``gto.Mole`` analog).

Mirrors the behavioral contract the reference templates rely on
(reference templates/calculate_energy.py:83-103 ``create_pyscf_mol``):
atoms given in Angstrom, ``charge``, ``spin`` = 2S = nalpha - nbeta,
basis by name, and ghost atoms via a ``Ghost:`` symbol prefix for
counterpoise BSSE (reference templates/calculate_interaction.py:136-156).

Coordinates are stored in Bohr as float64 numpy on the host; compute layers
lift what they need to torch tensors on their device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cctpu_torch.core import elements as elem
from cctpu_torch.core.basis import BasisSet, build_basis
from cctpu_torch.core.constants import ANG2BOHR, BOHR


AtomSpec = Union[str, Sequence[Tuple[str, Sequence[float]]]]


def _parse_atom_spec(atom: AtomSpec) -> Tuple[List[str], np.ndarray]:
    if isinstance(atom, str):
        entries = []
        for chunk in atom.replace("\n", ";").split(";"):
            toks = chunk.split()
            if not toks:
                continue
            entries.append((toks[0], [float(x) for x in toks[1:4]]))
    else:
        entries = [(s, list(c)) for s, c in atom]
    symbols = [s for s, _ in entries]
    coords = np.array([c for _, c in entries], dtype=np.float64)
    if coords.size == 0:
        coords = coords.reshape(0, 3)
    return symbols, coords


@dataclasses.dataclass
class Molecule:
    """A molecule + basis. ``spin`` is nalpha - nbeta (PySCF convention)."""

    symbols: List[str]
    coords: np.ndarray                 # [natm, 3] Bohr
    charge: int = 0
    spin: int = 0
    basis: str = "sto-3g"
    _basis_set: Optional[BasisSet] = dataclasses.field(
        default=None, repr=False, compare=False)

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_atoms(cls, atom: AtomSpec, charge: int = 0, spin: int = 0,
                   basis: str = "sto-3g", unit: str = "angstrom") -> "Molecule":
        symbols, coords = _parse_atom_spec(atom)
        if unit.lower().startswith("ang"):
            coords = coords * ANG2BOHR
        return cls(symbols=symbols, coords=coords, charge=charge, spin=spin,
                   basis=basis)

    @classmethod
    def from_xyz_file(cls, path: str, charge: int = 0, spin: int = 0,
                      basis: str = "sto-3g") -> "Molecule":
        with open(path) as f:
            lines = f.read().strip().splitlines()
        n = int(lines[0].split()[0])
        atoms = []
        for ln in lines[2:2 + n]:
            toks = ln.split()
            atoms.append((toks[0], [float(x) for x in toks[1:4]]))
        return cls.from_atoms(atoms, charge=charge, spin=spin, basis=basis)

    # -- basic properties ----------------------------------------------------
    @property
    def natm(self) -> int:
        return len(self.symbols)

    @property
    def charges(self) -> np.ndarray:
        """Nuclear charges; ghosts (symbol 'Ghost:X' or 'X:ghost') are 0."""
        zs = []
        for s in self.symbols:
            if s.lower().startswith("ghost"):
                zs.append(0)
            else:
                zs.append(elem.symbol_to_z(s))
        return np.array(zs, dtype=np.float64)

    @property
    def element_symbols(self) -> List[str]:
        """Bare element symbols (ghost prefix stripped) for basis lookup."""
        out = []
        for s in self.symbols:
            if s.lower().startswith("ghost") and ":" in s:
                out.append(s.split(":")[-1].capitalize())
            else:
                out.append(s.capitalize())
        return out

    @property
    def masses(self) -> np.ndarray:
        return np.array([elem.ISOTOPE_MASSES[int(elem.symbol_to_z(s))]
                         for s in self.element_symbols])

    @property
    def nelectron(self) -> int:
        ne = int(self.charges.sum()) - self.charge
        if (ne + self.spin) % 2 != 0:
            raise ValueError(
                f"electron number {ne} and spin {self.spin} inconsistent")
        return ne

    @property
    def nalpha(self) -> int:
        return (self.nelectron + self.spin) // 2

    @property
    def nbeta(self) -> int:
        return (self.nelectron - self.spin) // 2

    # -- derived -------------------------------------------------------------
    def energy_nuc(self, coords: Optional[np.ndarray] = None) -> float:
        """Nuclear repulsion (numpy coords; a host float)."""
        R = self.coords if coords is None else coords
        return float(self.energy_nuc_t(torch.as_tensor(R,
                                                       dtype=torch.float64)))

    def energy_nuc_t(self, coords: torch.Tensor) -> torch.Tensor:
        """Nuclear repulsion as a 0-d tensor of ``coords`` [natm, 3] (Bohr),
        differentiable by autograd. The identity inside the sqrt keeps the
        zero diagonal away from sqrt's infinite derivative at 0."""
        eye = torch.eye(self.natm, dtype=coords.dtype, device=coords.device)
        Z = torch.as_tensor(self.charges, dtype=coords.dtype,
                            device=coords.device)
        diff = coords[:, None, :] - coords[None, :, :]
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + eye)
        return 0.5 * torch.einsum("i,j,ij->", Z, Z, (1.0 - eye) / dist)

    def build(self) -> "Molecule":
        self._basis_set = build_basis(self.element_symbols, self.coords,
                                      self.basis)
        return self

    @property
    def basis_set(self) -> BasisSet:
        if self._basis_set is None:
            self.build()
        return self._basis_set

    @property
    def nao(self) -> int:
        return self.basis_set.nao

    def with_coords(self, coords_bohr: np.ndarray) -> "Molecule":
        """New Molecule at different geometry (basis rebuilt lazily)."""
        return Molecule(symbols=list(self.symbols),
                        coords=np.asarray(coords_bohr, dtype=np.float64),
                        charge=self.charge, spin=self.spin, basis=self.basis)

    def to_xyz(self, comment: str = "") -> str:
        lines = [str(self.natm), comment]
        for s, r in zip(self.symbols, self.coords * BOHR):
            lines.append(f"{s:4s} {r[0]:14.8f} {r[1]:14.8f} {r[2]:14.8f}")
        return "\n".join(lines) + "\n"
