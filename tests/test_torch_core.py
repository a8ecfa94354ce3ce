"""The port's copied core (basis tables, BasisSet) pinned to cctpu's: exact
equality, since both are the same numpy code on the same data."""

import numpy as np
import pytest

from cctpu.core import basis_data as j_bd
from cctpu.core.molecule import Molecule as JMolecule
from cctpu_torch.core import basis_data as t_bd
from cctpu_torch.core.molecule import Molecule as TMolecule

WATER = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
PHENOL = ("C 0.0000 1.3970 0.0000; C 1.2098 0.6985 0.0000; "
          "C 1.2098 -0.6985 0.0000; C 0.0000 -1.3970 0.0000; "
          "C -1.2098 -0.6985 0.0000; C -1.2098 0.6985 0.0000; "
          "O 0.0000 2.7650 0.0000; H 0.9300 3.1000 0.0000; "
          "H 2.1500 1.2400 0.0000; H 2.1500 -1.2400 0.0000; "
          "H 0.0000 -2.4800 0.0000; H -2.1500 -1.2400 0.0000; "
          "H -2.1500 1.2400 0.0000")

BASES = ["sto-3g", "6-31g", "6-31g*", "6-31g**", "6-31+g*", "6-31+g**",
         "6-311g**", "cc-pvdz", "def2-tzvp"]


@pytest.mark.parametrize("name", BASES)
def test_basis_table_identical(name):
    assert t_bd.get_basis_text(name) == j_bd.get_basis_text(name)


def test_fallback_chain_identical():
    assert t_bd.FALLBACK_CHAIN == j_bd.FALLBACK_CHAIN


@pytest.mark.parametrize("atoms,basis,nao", [
    (WATER, "sto-3g", 7), (WATER, "6-31g*", 18), (PHENOL, "6-31g*", 110)])
def test_basis_set_identical(atoms, basis, nao):
    bj = JMolecule.from_atoms(atoms, basis=basis).basis_set
    bt = TMolecule.from_atoms(atoms, basis=basis).basis_set
    assert bt.nao == bj.nao == nao
    assert len(bt.shells) == len(bj.shells)
    for sj, st in zip(bj.shells, bt.shells):
        assert (st.atom, st.l, st.ao_start) == (sj.atom, sj.l, sj.ao_start)
        assert np.array_equal(st.exps, sj.exps)
        assert np.array_equal(st.coefs, sj.coefs)
    assert sorted(bt.groups) == sorted(bj.groups)
    for l, gj in bj.groups.items():
        gt = bt.groups[l]
        for f in ("shell_idx", "atom_idx", "exps", "coefs", "centers",
                  "ao_start"):
            assert np.array_equal(getattr(gt, f), getattr(gj, f)), (l, f)


def test_molecule_scalars_identical():
    mj = JMolecule.from_atoms(PHENOL, basis="6-31g*")
    mt = TMolecule.from_atoms(PHENOL, basis="6-31g*")
    assert np.array_equal(mt.coords, mj.coords)
    assert mt.nelectron == mj.nelectron == 50
    assert mt.energy_nuc() == pytest.approx(float(mj.energy_nuc()),
                                            rel=1e-15)
