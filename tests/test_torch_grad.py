"""The port's DF nuclear gradient (``cctpu_torch.grad``) on the CPU, held
against cctpu's gradient terms on identical inputs, and against finite
differences of its own energy.

cctpu's DF tensors (aux basis up to l = 2, B, Linv) are built once per
molecule and carried into the port through ``cctpu_torch.interop``; the
port's SCF converges on them, and its converged state goes, as numpy, to
cctpu's term functions with the W/Z assembly in f64. Tolerances: W/Z <=
1e-12 relative; the 3c and 2c terms and the whole gradient <= 1e-10
Ha/bohr (the same equations, summation order apart); finite differences
(h = 1e-3 bohr, SCFs at conv_tol 1e-12) <= 1e-6 Ha/bohr (the O(h^2)
truncation); translational invariance <= 1e-8 Ha/bohr (exact at any
density: the grid moves with the atoms).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cctpu.core.molecule import Molecule as JMolecule
from cctpu.dft.rks import RKS as JRKS
from cctpu.dft.rks import UKS as JUKS
from cctpu.grad import df_grad as jdf_grad
from cctpu.grad.scf_grad import _energy_weighted_dm as j_energy_weighted_dm
from cctpu.ints.df import DFJK as JDFJK
from cctpu.ints.one_electron import build_int1e as j_build_int1e
from cctpu.ints.two_electron import energy_2e_grad_eager
from cctpu_torch.core.molecule import Molecule as TMolecule
from cctpu_torch.dft.rks import RKS as TRKS
from cctpu_torch.dft.rks import UKS as TUKS
from cctpu_torch.grad import df_grad as tdf_grad
from cctpu_torch.grad.scf_grad import gradient
from cctpu_torch.interop import (basis_from_numpy, dfjk_from_numpy,
                                 molecule_from_numpy, set_scf_state)
from cctpu_torch.scf.hf import RHF as TRHF
from cctpu_torch.scf.hf import UHF as TUHF
from cctpu_torch.utils.measure import NH2, WATER
from test_torch_threads import one_torch_thread  # noqa: F401

SCF_OPTS = dict(density_fit=True, conv_tol=1e-12, device="cpu")
# the aux sets held against cctpu stop at l = 2 (the default is 4): cctpu
# compiles one gradient function per aux class, and l = 3-4 would add ~160
# s to the lane; the port's l = 3-4 classes are held by the finite
# differences below (default aux) and by chip_smoke.py's cctpu oracles
AUX_LMAX = 2


def cctpu_gradient_terms(jmol, jk, dm, mo_coeff, mo_occ, mo_energy,
                         xc=None, grid_level=1):
    """cctpu's DF gradient terms in f64 on a given state (numpy arrays):
    the 1e Lagrangian by jax.grad through ``build_int1e``, ``_wz_fn`` in
    f64, ``_grad_3c`` and ``_grad_2c``, jax.grad of an RKS/UKS object's
    ``exc_of_coords`` (its constructor sets up the grid; no SCF runs) and
    of ``energy_nuc``. ``jk`` is cctpu's DFJK (``aux``, ``_Bh``,
    ``_Linv``), or None for an in-core state: then the two-electron term
    is ``energy_2e_grad_eager`` (key ``2e``). Returns a dict of numpy
    arrays, ``total`` included."""
    basis = jmol.basis_set
    coords = jnp.asarray(jmol.coords)
    spin = dm.ndim == 3
    Dt = dm.sum(0) if spin else dm
    dms = dm if spin else np.stack([dm / 2, dm / 2])
    if xc is None:
        ax, jmf = 1.0, None
    else:
        jmf = (JUKS if spin else JRKS)(jmol, xc=xc, density_fit=True,
                                       grid_level=grid_level)
        ax = jmf.func.hyb
    W = np.asarray(j_energy_weighted_dm(SimpleNamespace(
        mo_coeff=mo_coeff, mo_occ=mo_occ, mo_energy=mo_energy)))
    charges = jnp.asarray(jmol.charges)

    def one_e(R):
        ints = j_build_int1e(basis, R, charges)
        return (jnp.einsum("ij,ij->", Dt, ints["T"] + ints["V"])
                - jnp.einsum("ij,ij->", W, ints["S"]))

    # jitted: one compile each, where eager autodiff compiles op by op
    out = {"1e": np.asarray(jax.jit(jax.grad(one_e))(coords))}
    if jk is None:
        out["2e"] = energy_2e_grad_eager(basis, coords, jnp.asarray(dm),
                                         k_weight=ax)
        terms = ("1e", "2e", "xc", "nuc")
    else:
        Ws, Zs = jdf_grad._wz_fn(float(ax))(
            jnp.asarray(jk._Bh), jnp.asarray(np.asarray(jk._Linv)),
            jnp.asarray(Dt), jnp.asarray(dms))
        out["Ws"], out["Zs"] = np.asarray(Ws), np.asarray(Zs)
        out["3c"] = np.asarray(jdf_grad._grad_3c(
            basis, jk.aux, coords, jdf_grad._pad3(Ws), None))
        out["2c"] = np.asarray(jdf_grad._grad_2c(
            jk.aux, coords, jnp.pad(Zs, ((0, 1), (0, 1))), None))
        terms = ("1e", "3c", "2c", "xc", "nuc")
    out["xc"] = np.zeros_like(out["1e"]) if jmf is None else np.asarray(
        jax.jit(jax.grad(lambda R: jmf.exc_of_coords(R, jnp.asarray(dm))))(
            coords))
    out["nuc"] = np.asarray(jax.grad(jmol.energy_nuc)(coords))
    out["total"] = sum(out[k] for k in terms)
    return out


def _shells(bs):
    return [(s.atom, s.l, s.exps, s.coefs) for s in bs.shells]


def _carried(atoms, spin):
    """cctpu's molecule and DFJK, and a maker of port SCFs on the same
    basis and DF tensors."""
    jmol = JMolecule.from_atoms(atoms, spin=spin, basis="sto-3g")
    jk = JDFJK(jmol, lmax_cap=AUX_LMAX)
    assert jk._Bh is not None

    def port_scf(cls, state=None, **kw):
        """A port SCF on cctpu's basis and DF tensors: converged by its own
        kernel(), or carrying ``state`` (dm, mo_coeff, mo_occ, mo_energy)."""
        mol = molecule_from_numpy(
            jmol.symbols, jmol.coords, spin=spin,
            basis=basis_from_numpy(_shells(jmol.basis_set), jmol.coords))
        mf = cls(mol, **kw, **SCF_OPTS)
        mf._jk = dfjk_from_numpy(_shells(jk.aux), jmol.coords, jk._Bh,
                                 np.asarray(jk._Linv), device="cpu")
        if state is not None:
            return set_scf_state(mf, *state)
        mf.kernel()
        assert mf.converged
        return mf

    return SimpleNamespace(jmol=jmol, jk=jk, port_scf=port_scf)


@pytest.fixture(scope="module")
def water():
    return _carried(WATER, 0)


@pytest.fixture(scope="module")
def nh2():
    return _carried(NH2, 1)


def _state(mf):
    return tuple(x.numpy() for x in (mf.dm, mf.mo_coeff, mf.mo_occ,
                                     mf.mo_energy))


def _rel(x, ref):
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def test_wz_and_2e_terms_match_cctpu(water, nh2, monkeypatch):
    """W/Z (ax = 1 and 0) and the 3c/2c terms on the same state and the
    same weights; water RHF and NH2 UHF."""
    # cctpu's host-FD spot check of its gradient executables is a TPU
    # guard, not math
    monkeypatch.setattr(jdf_grad, "_GVAL_ON", False)
    for mol, cls in ((water, TRHF), (nh2, TUHF)):
        mf = mol.port_scf(cls)
        dm = mf.dm.numpy()
        Dt = dm.sum(0) if dm.ndim == 3 else dm
        dms = dm if dm.ndim == 3 else np.stack([dm / 2, dm / 2])
        jk = mol.jk
        B, Linv = jk._Bh, np.asarray(jk._Linv)
        for ax in (1.0, 0.0):
            Wj, Zj = jdf_grad._wz_fn(ax)(jnp.asarray(B), jnp.asarray(Linv),
                                         jnp.asarray(Dt), jnp.asarray(dms))
            Wj, Zj = np.asarray(Wj), np.asarray(Zj)
            Wt, Zt = tdf_grad._wz(mf._jk.B, mf._jk._Linv, torch.tensor(Dt),
                                  tdf_grad.occupied_factors(mf), ax)
            assert _rel(Wt.numpy(), Wj) <= 1e-12, (cls.__name__, ax)
            assert _rel(Zt.numpy(), Zj) <= 1e-12, (cls.__name__, ax)
        coords = jnp.asarray(mol.jmol.coords)
        g3j = np.asarray(jdf_grad._grad_3c(mol.jmol.basis_set, jk.aux,
                                           coords, jdf_grad._pad3(Wj), None))
        g2j = np.asarray(jdf_grad._grad_2c(jk.aux, coords,
                                           jnp.pad(Zj, ((0, 1), (0, 1))),
                                           None))
        g3t = tdf_grad._grad_3c(mf.mol.basis_set, mf._jk.aux, mf.coords,
                                torch.tensor(Wj)).numpy()
        g2t = tdf_grad._grad_2c(mf._jk.aux, mf.coords,
                                torch.tensor(Zj)).numpy()
        assert np.abs(g3j).max() > 1e-3 and np.abs(g2j).max() > 1e-3
        assert np.abs(g3t - g3j).max() <= 1e-10, cls.__name__
        assert np.abs(g2t - g2j).max() <= 1e-10, cls.__name__


def test_gradient_matches_cctpu(water, nh2, monkeypatch):
    """The whole gradient against cctpu's terms assembled in f64 on the
    same state: water RHF, water RKS B3LYP and NH2 UKS B3LYP."""
    monkeypatch.setattr(jdf_grad, "_GVAL_ON", False)
    cases = ((water, TRHF, {}), (water, TRKS, dict(xc="b3lyp")),
             (nh2, TUKS, dict(xc="b3lyp")))
    for mol, cls, kw in cases:
        if kw:
            kw = dict(kw, grid_level=1)
        state = _state(mol.port_scf(cls, **kw))
        # the gradient of a fresh SCF object that carries the state over
        g = gradient(mol.port_scf(cls, state=state, **kw))
        assert g.dtype == torch.float64 and g.shape == (3, 3)
        ref = cctpu_gradient_terms(mol.jmol, mol.jk, *state,
                                   xc=kw.get("xc"), grid_level=1)
        err = float(np.abs(g.numpy() - ref["total"]).max())
        assert err <= 1e-10, (cls.__name__, err)


def test_gradient_fd_and_invariance():
    """The port alone (its own DF build at every geometry): central
    differences and translational invariance, water RHF and NH2 UKS
    B3LYP; an in-core SCF's gradient runs and is invariant."""
    h = 1e-3
    cases = ((TRHF, WATER, 0, {}),
             (TUKS, NH2, 1, dict(xc="b3lyp", grid_level=1)))
    for cls, atoms, spin, kw in cases:
        mol = TMolecule.from_atoms(atoms, spin=spin, basis="sto-3g")
        mf = cls(mol, **kw, **SCF_OPTS)
        mf.kernel()
        g = gradient(mf).numpy()
        assert np.isfinite(g).all()
        assert np.abs(g.sum(0)).max() <= 1e-8, cls.__name__
        for ia, d in ((0, 2), (1, 1)):
            e = []
            for sgn in (1.0, -1.0):
                c = mol.coords.copy()
                c[ia, d] += sgn * h
                m2 = cls(mol.with_coords(c), **kw, **SCF_OPTS)
                e.append(m2.kernel(dm0=mf.dm))
                assert m2.converged
            fd = (e[0] - e[1]) / (2 * h)
            assert abs(g[ia, d] - fd) <= 1e-6, (cls.__name__, ia, d)
    mf = TRHF(TMolecule.from_atoms(WATER, basis="sto-3g"), device="cpu")
    mf.kernel()
    g = gradient(mf).numpy()
    assert np.isfinite(g).all() and np.abs(g.sum(0)).max() <= 1e-8
