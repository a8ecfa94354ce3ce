"""The port's in-core and pivoted-Cholesky J/K routes, their SCFs and the
direct nuclear gradient on the CPU, held against cctpu on identical inputs.

Inputs are water and NH2 at STO-3G (s and p shells: every cctpu function
called here compiles per class, and d classes would multiply the lane's
compile time), random densities from a numpy seed, and water 6-31G* for
the d-shell blocks, held against cctpu's pure-numpy quartet oracle (no
compile). Tolerances: integrals, 2e energies and the direct 2e gradient
<= 1e-12 Ha (1e-10 Ha/bohr for the gradient: the same equations,
summation order apart); converged SCF energies <= 1e-10 Ha against cctpu
and <= 1e-9 against the golden value; the Cholesky route <= 1e-8 Ha (its
decomposition tolerance is 1e-9 per diagonal element); finite differences
(h = 1e-3 bohr, conv_tol 1e-12) <= 1e-6 Ha/bohr.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cctpu.core.molecule import Molecule as JMolecule
from cctpu.dft.rks import RKS as JRKS
from cctpu.ints import two_electron as jte
from cctpu.ints.host_oracle import eri_bra_ket_np
from cctpu.scf.hf import UHF as JUHF
from cctpu.utils import chkfile as jchk
from cctpu_torch.core.molecule import Molecule as TMolecule
from cctpu_torch.dft.rks import RKS as TRKS
from cctpu_torch.dft.rks import UKS as TUKS
from cctpu_torch.grad.scf_grad import direct_e2_gradient, gradient
from cctpu_torch.interop import eri_from_numpy
from cctpu_torch.ints.df import CholeskyJK
from cctpu_torch.ints.two_electron import (build_eri_incore,
                                           energy_2e_direct,
                                           eri_quartet_kernel, walk_4c)
from cctpu_torch.scf.hf import RHF as TRHF
from cctpu_torch.scf.hf import UHF as TUHF
from cctpu_torch.scf.hf import IncoreJK
from cctpu_torch.utils import chkfile as tchk
from cctpu_torch.utils.measure import NH2, WATER
from cctpu_torch.workflows import calculate_energy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu", conv_tol=1e-12)
WATER_STO3G_E = -74.9630231385          # RHF, the PySCF-doc golden value
with open(os.path.join(ROOT, "scripts", "sad_oracles.json")) as _f:
    WATER_CD_631G_E = json.load(_f)["water_cd_631g_e"]


@pytest.fixture(scope="module")
def water():
    """cctpu's in-core tensor of water/STO-3G (its compiles are shared by
    every cctpu call below) and the port's molecule and tensor."""
    jmol = JMolecule.from_atoms(WATER, basis="sto-3g")
    mol = TMolecule.from_atoms(WATER, basis="sto-3g")
    coords = torch.as_tensor(mol.coords)
    return SimpleNamespace(
        jmol=jmol, jeri=np.asarray(jte.build_eri_incore(jmol.basis_set,
                                                        jmol.coords)),
        mol=mol, coords=coords, eri=build_eri_incore(mol.basis_set, coords))


def _random_dms(n, seed=7):
    """A symmetric closed-shell density and a pair of spin densities."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((3, n, n)) * 0.3
    d = a + a.transpose(0, 2, 1)
    return d[0], d[1:]


def test_eri_incore_matches_cctpu_and_oracle(water):
    """Water/STO-3G against cctpu's in-core tensor (<= 1e-12) with the
    8-fold symmetry; one quartet of each of the 21 classes of water/6-31G*
    (d shells) against cctpu's numpy oracle, read from the built tensor
    where its block was scattered (<= 1e-12)."""
    eri = water.eri.numpy()
    assert eri.shape == water.jeri.shape
    assert np.abs(eri - water.jeri).max() <= 1e-12
    for perm in ((1, 0, 2, 3), (0, 1, 3, 2), (2, 3, 0, 1), (3, 2, 1, 0)):
        assert np.abs(eri - eri.transpose(perm)).max() <= 1e-14, perm

    mol = TMolecule.from_atoms(WATER, basis="6-31g*")
    coords = torch.as_tensor(mol.coords)
    eri = build_eri_incore(mol.basis_set, coords).numpy()
    classes = set()
    for ls, args, rows, _ in walk_4c(mol.basis_set, coords, screen=False):
        if ls in classes:
            continue
        classes.add(ls)
        a = [x[-1].numpy() for x in args(coords)]   # the chunk's last
        ref = eri_bra_ket_np(ls[0], ls[1], *a[0:2], *a[3:5], a[2], a[5],
                             ls[2], ls[3], *a[6:8], *a[9:11], a[8], a[11])
        A, B, C, D = (r[-1].numpy() for r in rows)
        got = eri[np.ix_(A, B, C, D)]
        assert np.abs(got - ref).max() <= 1e-12, ls
        blk = eri_quartet_kernel(ls, *(x[-1:] for x in args(coords)))[0]
        assert np.abs(blk.numpy() - ref).max() <= 1e-12, ls
    assert len(classes) == 21 and max(map(max, classes)) == 2


def test_energy_2e_direct_matches_cctpu_and_tensor(water):
    """E_2e of random densities: against cctpu's ``energy_2e_direct`` and
    against 1/2 Tr[D J] - 1/4 Tr[D K] (closed shell) and 1/2 Tr[D J] - 1/2
    sum_s Tr[D_s K_s] (spin densities) from the port's own tensor, k_weight
    1 and 0.2 (<= 1e-12 Ha)."""
    n = water.mol.nao
    eri = water.eri
    dm, dms = _random_dms(n)
    for kw in (1.0, 0.2):
        for d in (dm, dms):
            D = torch.as_tensor(d)
            Dt = D.sum(0) if D.ndim == 3 else D
            J = torch.einsum("ijkl,kl->ij", eri, Dt)
            Ks = torch.einsum("ikjl,...kl->...ij", eri, D)
            ex = 0.5 * float((D * Ks).sum()) if D.ndim == 3 \
                else 0.25 * float((D * Ks).sum())
            ref = 0.5 * float((Dt * J).sum()) - kw * ex
            e = float(energy_2e_direct(water.mol.basis_set, water.coords, D,
                                       kw))
            e_j = float(jte.energy_2e_direct(water.jmol.basis_set,
                                             water.jmol.coords, d,
                                             k_weight=kw))
            assert abs(e - ref) <= 1e-12, (kw, D.ndim)
            assert abs(e - e_j) <= 1e-12, (kw, D.ndim)


def test_incore_scf_matches_cctpu(water):
    """In-core RHF water/STO-3G against the golden value (<= 1e-9), on the
    port's tensor and on cctpu's carried across; RKS B3LYP water and UHF
    NH2 (STO-3G) against cctpu's in-core SCFs (<= 1e-10 Ha)."""
    for jk in (None, eri_from_numpy(water.jeri, device="cpu")):
        mf = TRHF(water.mol, **CPU)
        mf._jk = jk
        e = mf.kernel()
        assert mf.converged and abs(e - WATER_STO3G_E) <= 1e-9
        assert isinstance(mf._jk, IncoreJK)

    jmf = JRKS(water.jmol, xc="b3lyp", grid_level=1, conv_tol=1e-12)
    e_ref = float(jmf.kernel())
    mf = TRKS(water.mol, xc="b3lyp", grid_level=1, **CPU)
    e = mf.kernel()
    assert mf.converged and jmf.converged and abs(e - e_ref) <= 1e-10

    jmf = JUHF(JMolecule.from_atoms(NH2, spin=1, basis="sto-3g"),
               conv_tol=1e-12)
    e_ref = float(jmf.kernel())
    mf = TUHF(TMolecule.from_atoms(NH2, spin=1, basis="sto-3g"), **CPU)
    e = mf.kernel()
    assert mf.converged and jmf.converged and abs(e - e_ref) <= 1e-10


def test_cholesky_route():
    """Water RHF/6-31G with density_fit="cd" against cctpu's host-f64
    oracle and the port's in-core energy (<= 1e-8 Ha, the contract), its
    factor against the tensor (max |M - B^T B| <= 1e-9, the decomposition
    tolerance), and its direct gradient against the in-core SCF's (<= 1e-7
    Ha/bohr); NH2 UHF/STO-3G (the per-spin J and K of the factor) against
    in-core (<= 1e-8 Ha)."""
    mol = TMolecule.from_atoms(WATER, basis="6-31g")
    mf = TRHF(mol, density_fit="cd", **CPU)
    e = mf.kernel()
    ref = TRHF(mol, **CPU)
    e_ref = ref.kernel()
    assert isinstance(mf._jk, CholeskyJK) and mf.converged
    assert abs(e - WATER_CD_631G_E) <= 1e-8
    assert abs(e - e_ref) <= 1e-8
    B = mf._jk.B
    n = mol.nao
    M = ref._jk.eri
    res = (M - B.reshape(-1, n * n).T @ B.reshape(-1, n * n)).abs().max()
    assert B.shape[0] < n * n and float(res) <= 1e-9
    assert float((gradient(mf) - gradient(ref)).abs().max()) <= 1e-7

    mol = TMolecule.from_atoms(NH2, spin=1, basis="sto-3g")
    e_cd = TUHF(mol, density_fit="cd", **CPU).kernel()
    assert abs(e_cd - TUHF(mol, **CPU).kernel()) <= 1e-8


def test_direct_gradient_matches_cctpu_and_fd(water):
    """The direct 2e gradient of random densities (closed shell, k_weight
    1; spin densities, k_weight 0.2) against cctpu's
    ``energy_2e_grad_eager`` (<= 1e-10 Ha/bohr); the whole gradient of
    in-core RHF water and UKS B3LYP NH2 (STO-3G) against central
    differences of the port's energy (<= 1e-6) and its translational
    invariance (<= 1e-8)."""
    dm, dms = _random_dms(water.mol.nao, seed=11)
    for d, kw in ((dm, 1.0), (dms, 0.2)):
        mf = SimpleNamespace(dm=torch.as_tensor(d), mol=water.mol,
                             coords=water.coords,
                             func=SimpleNamespace(hyb=kw))
        g = direct_e2_gradient(mf).numpy()
        g_ref = jte.energy_2e_grad_eager(water.jmol.basis_set,
                                         water.jmol.coords, d, k_weight=kw)
        assert np.abs(g - g_ref).max() <= 1e-10, kw

    h = 1e-3
    for cls, atoms, spin, kw in ((TRHF, WATER, 0, {}),
                                 (TUKS, NH2, 1, dict(xc="b3lyp",
                                                     grid_level=1))):
        mol = TMolecule.from_atoms(atoms, spin=spin, basis="sto-3g")
        mf = cls(mol, **kw, **CPU)
        mf.kernel()
        g = gradient(mf).numpy()
        assert np.abs(g.sum(0)).max() <= 1e-8, cls.__name__
        for ia, ax in ((0, 2), (1, 1)):
            e = []
            for sgn in (1.0, -1.0):
                c = mol.coords.copy()
                c[ia, ax] += sgn * h
                m2 = cls(mol.with_coords(c), **kw, **CPU)
                e.append(m2.kernel(dm0=mf.dm))
                assert m2.converged
            fd = (e[0] - e[1]) / (2 * h)
            assert abs(g[ia, ax] - fd) <= 1e-6, (cls.__name__, ia, ax)


def test_scf_cache_files_cross_packages(water, tmp_path):
    """An ``--scf-cache`` checkpoint written by the port loads in cctpu and
    one written by cctpu loads in the port: one key, one .npz layout."""
    mf = TRHF(water.mol, **CPU)
    mf.kernel()
    assert tchk.geometry_key(water.mol, "hf") == \
        jchk.geometry_key(water.jmol, "hf")
    tchk.SCFCache(str(tmp_path)).put(mf, "hf")
    dm = jchk.SCFCache(str(tmp_path)).get(water.jmol, "hf")
    assert dm is not None and np.array_equal(dm, mf.dm.numpy())

    state = SimpleNamespace(
        e_tot=mf.e_tot, mol=water.jmol, converged=True,
        **{k: getattr(mf, k).numpy() * 0.5
           for k in ("mo_coeff", "mo_energy", "mo_occ", "dm")})
    jchk.save_scf(str(tmp_path / "j.npz"), state, "hf")
    dm = tchk.load_dm0(str(tmp_path / "j.npz"), water.mol, "hf")
    assert np.array_equal(dm, state.dm)
    other = TMolecule.from_atoms(WATER, basis="6-31g")
    assert tchk.load_dm0(str(tmp_path / "j.npz"), other, "hf") is None


def test_cli_default_route_and_scf_cache(tmp_path):
    """The ``energy`` CLI without ``--density-fit`` (nao 7: in-core), then
    twice with ``--scf-cache``: the second run warm-starts from the first
    one's checkpoint, converges in fewer cycles and agrees (<= 1e-10 Ha)."""
    def run(*extra):
        out = tmp_path / f"out{len(list(tmp_path.iterdir()))}"
        e = calculate_energy.main(["--smiles", "O", "--method", "hf",
                                   "--basis", "sto-3g", "--device", "cpu",
                                   *extra, "--output-dir", str(out)])
        short, = [p for p in out.iterdir()
                  if p.name.endswith("_short_report.txt")]
        text = short.read_text()
        assert "converged: True" in text
        return (e, int(text.split("cycles:")[1].split()[0]),
                "warm start" in text)

    e0, _, warm0 = run()
    cache = str(tmp_path / "cache")
    e1, n1, warm1 = run("--scf-cache", cache)
    e2, n2, warm2 = run("--scf-cache", cache)
    assert not (warm0 or warm1) and warm2 and n2 < n1
    assert -75.1 < e0 < -74.9 and abs(e1 - e0) <= 1e-10
    assert abs(e2 - e1) <= 1e-10
