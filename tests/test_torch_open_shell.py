"""The port's open-shell DF path (UHF, UKS) and pure-GGA RKS (BLYP) on the
CPU, held against cctpu.

Tolerances: energies |dE| <= 1e-9 Ha against cctpu's CPU-f64 SCF at
conv_tol 1e-10 (the same equations converged to the same gates; the two
packages differ by summation order and eigensolver only); <S^2> to 1e-8
(a quadratic function of the orbitals, converged to ~1e-5 in the DIIS
error). The references are built once per module, at STO-3G, grid level 1.

UKS is held on the NH2 radical, not OH: OH's beta guess density cuts
through a three-fold degenerate eigenspace, so the occupied factor of the
first Fock build depends on the eigensolver (numpy's in cctpu, torch's
here), and the grid, which breaks OH's cylindrical symmetry, then pins the
beta pi hole at an orientation that differs between the two (ROADMAP.md
queue 3). UHF has no grid, so OH stays its test.
"""

import numpy as np
import pytest
import torch

from cctpu.core.molecule import Molecule as JMolecule
from cctpu.dft.rks import RKS as JRKS
from cctpu.dft.rks import UKS as JUKS
from cctpu.scf.hf import UHF as JUHF
from cctpu_torch.core.molecule import Molecule as TMolecule
from cctpu_torch.dft.rks import RKS as TRKS
from cctpu_torch.dft.rks import UKS as TUKS
from cctpu_torch.scf import hf as t_hf
from cctpu_torch.scf.hf import UHF as TUHF
from cctpu_torch.workflows import cli
from cctpu_torch.workflows.common import homo_lumo, make_scf
from test_torch_threads import one_torch_thread  # noqa: F401

OH = "O 0 0 0; H 0 0 0.97"
NH2 = "N 0 0 0; H 0 0.8036 0.6347; H 0 -0.8036 0.6347"
H_ATOM = "H 0 0 0"
WATER = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
OPTS = dict(density_fit=True, conv_tol=1e-10)


def _cctpu(cls, atoms, spin=0, **kw):
    mf = cls(JMolecule.from_atoms(atoms, spin=spin, basis="sto-3g"), **kw,
             **OPTS)
    e = float(mf.kernel())
    assert mf.converged
    s2 = mf.spin_square()[0] if spin else None
    return e, s2


def _port(cls, atoms, spin=0, **kw):
    mf = cls(TMolecule.from_atoms(atoms, spin=spin, basis="sto-3g"), **kw,
             device="cpu", **OPTS)
    e = mf.kernel()
    assert mf.converged
    return mf, e


@pytest.fixture(scope="module")
def cctpu_uhf_oh():
    return _cctpu(JUHF, OH, spin=1)


@pytest.fixture(scope="module")
def cctpu_uks_nh2():
    return _cctpu(JUKS, NH2, spin=1, xc="b3lyp", grid_level=1)


@pytest.fixture(scope="module")
def cctpu_uks_h_atom():
    return _cctpu(JUKS, H_ATOM, spin=1, xc="b3lyp", grid_level=1)


@pytest.fixture(scope="module")
def cctpu_blyp_water():
    return _cctpu(JRKS, WATER, xc="blyp", grid_level=1)


def test_uhf_oh_matches_cctpu(cctpu_uhf_oh):
    e_ref, s2_ref = cctpu_uhf_oh
    mf, e = _port(TUHF, OH, spin=1)
    assert abs(e - e_ref) <= 1e-9
    assert abs(mf.spin_square()[0] - s2_ref) <= 1e-8
    assert mf.dm.shape == (2, mf.mol.nao, mf.mol.nao)


def test_uks_b3lyp_nh2_matches_cctpu(cctpu_uks_nh2):
    e_ref, s2_ref = cctpu_uks_nh2
    mf, e = _port(TUKS, NH2, spin=1, xc="b3lyp", grid_level=1)
    assert abs(e - e_ref) <= 1e-9
    assert abs(mf.spin_square()[0] - s2_ref) <= 1e-8


def test_uks_h_atom_matches_cctpu(cctpu_uks_h_atom):
    """nbeta = 0: the beta occupied factor is one zero column."""
    e_ref, _ = cctpu_uks_h_atom
    mf, e = _port(TUKS, H_ATOM, spin=1, xc="b3lyp", grid_level=1)
    assert abs(e - e_ref) <= 1e-9
    assert mf.spin_square()[0] == pytest.approx(0.75, abs=1e-12)


def test_blyp_water_matches_cctpu(cctpu_blyp_water):
    """Pure GGA: J without K (the df_j_fast branch on the card)."""
    e_ref, _ = cctpu_blyp_water
    _, e = _port(TRKS, WATER, xc="blyp", grid_level=1)
    assert abs(e - e_ref) <= 1e-9


def test_uks_closed_shell_equals_rks():
    """Water, spin 0: UKS from the rotated natural-orbital guess lands on
    the RKS energy (as cctpu's tests/test_dft.py holds for LDA)."""
    _, e_r = _port(TRKS, WATER, xc="b3lyp", grid_level=1)
    mf, e_u = _port(TUKS, WATER, xc="b3lyp", grid_level=1)
    assert abs(e_u - e_r) <= 1e-9
    assert mf.spin_square()[0] == pytest.approx(0.0, abs=1e-8)


def test_open_shell_guess_and_dispatch(monkeypatch):
    """minao guess split by spin; the core-Hamiltonian guess for elements
    without an STO-3G table; make_scf picks UHF/UKS for spin != 0, and
    homo_lumo reads the alpha spin."""
    mol = TMolecule.from_atoms(OH, spin=1, basis="sto-3g")
    mf = make_scf(mol, "hf", density_fit=True, device="cpu")
    assert type(mf) is TUHF
    assert type(make_scf(mol, "blyp", density_fit=True,
                         grid_level=1, device="cpu")) is TUKS
    S = mf.build_ints()["S"]
    for covers in (True, False):
        monkeypatch.setattr(t_hf, "_minao_covers", lambda m, c=covers: c)
        dm = mf.init_guess_dm()
        monkeypatch.undo()
        ne = torch.einsum("sij,ij->s", dm, S)
        assert torch.allclose(ne, torch.tensor([5.0, 4.0],
                                               dtype=torch.float64))
    assert t_hf._minao_covers(mol)
    assert not t_hf._minao_covers(TMolecule.from_atoms("Zn 0 0 0",
                                                       basis="sto-3g"))
    mf.mo_energy = torch.tensor([[-1.0, -0.5, 0.25], [-0.9, 0.1, 0.3]])
    mf.mol = TMolecule.from_atoms("H 0 0 0; H 0 0 1.4", spin=2,
                                  basis="sto-3g")
    assert homo_lumo(mf) == (-0.5, 0.25)


def test_cli_energy_oh_radical(tmp_path):
    rc = cli.main(["energy", "--smiles", "[OH]", "--spin", "1",
                   "--method", "b3lyp", "--basis", "sto-3g",
                   "--grid-level", "1", "--density-fit",
                   "--device", "cpu", "--output-dir", str(tmp_path)])
    assert rc == 0
    short = [p for p in tmp_path.iterdir()
             if p.name.endswith("_short_report.txt")]
    assert len(short) == 1
    text = short[0].read_text()
    assert "converged: True" in text and "spin: 1" in text
    e = float(text.split("Total energy:")[1].split()[0])
    assert -74.8 < e < -74.5                   # UB3LYP/STO-3G OH radical
    assert np.isfinite(e)


def test_guess_factor_cuts_degenerate_space_for_oh():
    """The minao guess's beta density of OH (STO-3G) has a three-fold
    degenerate eigenvalue that nbeta = 4 cuts through, so the first
    occupied factor, and the first Fock build, depend on the eigensolver
    (ROADMAP.md queue 3)."""
    mf = TUHF(TMolecule.from_atoms(OH, spin=1, basis="sto-3g"),
              density_fit=True, device="cpu")
    w = torch.linalg.eigvalsh(mf.init_guess_dm()[1]).flip(0)
    nb = mf.mol.nbeta
    assert float(w[nb - 1] - w[nb]) < 1e-12
    assert float(w[nb - 2] - w[nb - 1]) < 1e-12
