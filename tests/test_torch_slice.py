"""The port's main path end to end on the CPU, held against cctpu.

Water/STO-3G DF-B3LYP (grid level 1) and DF-RHF at conv_tol 1e-10 through
both packages: |dE| <= 1e-9 Ha. The references are built once per module.
Also: the port's ``energy`` CLI, warm start from cctpu's density through
``cctpu_torch.interop``, and that no module of the port imports JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cctpu.core.molecule import Molecule as JMolecule
from cctpu.dft.rks import RKS as JRKS
from cctpu.scf.hf import RHF as JRHF
from cctpu_torch.core.molecule import Molecule as TMolecule
from cctpu_torch.dft.rks import RKS as TRKS
from cctpu_torch.interop import basis_from_numpy, dm_from_numpy, \
    molecule_from_numpy
from cctpu_torch.scf.hf import RHF as TRHF
from cctpu_torch.scf.hf import IncoreJK
from cctpu_torch.workflows import cli
from cctpu_torch.workflows.common import make_scf

WATER = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cctpu_b3lyp():
    mf = JRKS(JMolecule.from_atoms(WATER, basis="sto-3g"), xc="b3lyp",
              density_fit=True, grid_level=1, conv_tol=1e-10)
    e = float(mf.kernel())
    assert mf.converged
    return e, np.asarray(mf.dm)


def test_b3lyp_water_matches_cctpu(cctpu_b3lyp):
    e_ref, _ = cctpu_b3lyp
    mf = TRKS(TMolecule.from_atoms(WATER, basis="sto-3g"), xc="b3lyp",
              density_fit=True, grid_level=1, conv_tol=1e-10, device="cpu")
    e = mf.kernel()
    assert mf.converged
    assert abs(e - e_ref) <= 1e-9


def test_warm_start_from_cctpu_state(cctpu_b3lyp):
    """Basis, coordinates and the converged density carried across as
    numpy: the port restarts at cctpu's fixed point."""
    e_ref, dm = cctpu_b3lyp
    mj = JMolecule.from_atoms(WATER, basis="sto-3g")
    shells = [(s.atom, s.l, s.exps, s.coefs) for s in mj.basis_set.shells]
    mol = molecule_from_numpy(mj.symbols, mj.coords,
                              basis=basis_from_numpy(shells, mj.coords))
    assert mol.nao == mj.nao
    mf = TRKS(mol, xc="b3lyp", density_fit=True, grid_level=1,
              conv_tol=1e-10, device="cpu")
    e = mf.kernel(dm0=dm_from_numpy(dm, device="cpu"))
    assert mf.converged and mf.n_cycles <= 4
    assert abs(e - e_ref) <= 1e-9


def test_rhf_water_df_matches_cctpu():
    mf_j = JRHF(JMolecule.from_atoms(WATER, basis="sto-3g"),
                density_fit=True, conv_tol=1e-10)
    e_ref = float(mf_j.kernel())
    mf = TRHF(TMolecule.from_atoms(WATER, basis="sto-3g"), density_fit=True,
              conv_tol=1e-10, device="cpu")
    e = mf.kernel()
    assert mf.converged and mf_j.converged
    assert abs(e - e_ref) <= 1e-9
    mu = mf.dip_moment()
    assert np.allclose(mu, np.asarray(mf_j.dip_moment()), atol=1e-8)


def test_cli_energy_water(tmp_path):
    rc = cli.main(["energy", "--smiles", "O", "--method", "b3lyp",
                   "--basis", "sto-3g", "--grid-level", "1",
                   "--density-fit", "--device", "cpu",
                   "--output-dir", str(tmp_path)])
    assert rc == 0
    reports = sorted(p.name for p in tmp_path.iterdir())
    short = [p for p in reports if p.endswith("_short_report.txt")]
    assert len(short) == 1 and any(p.endswith("_config.json")
                                   for p in reports)
    text = (tmp_path / short[0]).read_text()
    assert "converged: True" in text
    e = float(text.split("Total energy:")[1].split()[0])
    assert -75.4 < e < -75.2                   # B3LYP/STO-3G water


def test_cli_unported_paths_say_so(capsys, tmp_path):
    assert cli.main(["uv", "--smiles", "O"]) == 1
    assert "not ported" in capsys.readouterr().out
    mol = TMolecule.from_atoms(WATER, basis="sto-3g")
    mf = make_scf(mol, "b3lyp", grid_level=1, device="cpu")
    assert isinstance(mf.get_jk_builder(), IncoreJK)  # nao <= 160: in-core
    mf.kernel()
    assert mf.converged and -75.4 < mf.e_tot < -75.2
    with pytest.raises(NotImplementedError):
        make_scf(mol, "pbe0", density_fit=True, device="cpu")
    if not torch.cuda.is_available():
        # the card unless the caller asks for the CPU: no silent fallback
        for build in (lambda: make_scf(mol, "b3lyp", grid_level=1),
                      lambda: TRHF(mol, density_fit=True),
                      lambda: dm_from_numpy(np.eye(mol.nao))):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["energy", "--smiles", "O", "--method", "hf",
                      "--basis", "sto-3g", "--output-dir", str(tmp_path)])


def test_port_imports_no_jax():
    """Every module of cctpu_torch imports without JAX or cctpu (checked
    in a fresh interpreter: this test process has both loaded)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cctpu_torch\n"
        "for m in pkgutil.walk_packages(cctpu_torch.__path__, "
        "'cctpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'cctpu' or k.startswith('cctpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules "
        "if k.startswith('cctpu_torch')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
