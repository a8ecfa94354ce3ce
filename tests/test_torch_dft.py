"""Grids, AO evaluation and B3LYP XC of the port against cctpu on the CPU
(water/STO-3G, grid level 1), to 1e-10: the same formulas in f64, summed
in another order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cctpu.core.molecule import Molecule as JMolecule
from cctpu.dft import xc as j_xc
from cctpu.dft.grids import Grids as JGrids
from cctpu.dft.numint import eval_ao as j_eval_ao
from cctpu.dft.rks import RKS as JRKS
from cctpu_torch.core.molecule import Molecule as TMolecule
from cctpu_torch.dft import xc as t_xc
from cctpu_torch.dft.grids import Grids as TGrids
from cctpu_torch.dft.numint import eval_ao as t_eval_ao
from cctpu_torch.dft.rks import RKS as TRKS
from test_torch_threads import one_torch_thread  # noqa: F401

WATER = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


@pytest.fixture(scope="module")
def mols():
    return (JMolecule.from_atoms(WATER, basis="sto-3g"),
            TMolecule.from_atoms(WATER, basis="sto-3g"))


def test_grid_points_and_weights_match_cctpu(mols):
    mj, mt = mols
    pj, wj = JGrids(mj, level=1).build(jnp.asarray(mj.coords))
    pt, wt = TGrids(mt, level=1).build(_t(mt.coords))
    assert pt.shape == pj.shape and wt.shape == wj.shape
    assert np.abs(pt.numpy() - np.asarray(pj)).max() < 1e-10
    assert np.abs(wt.numpy() - np.asarray(wj)).max() < 1e-10 * \
        np.abs(np.asarray(wj)).max()


def test_eval_ao_matches_cctpu_and_padding_is_zero(mols):
    mj, mt = mols
    pts, _ = TGrids(mt, level=1).build(_t(mt.coords))
    pts = torch.cat([pts[:500], torch.full((3, 3), 1e6,
                                           dtype=torch.float64)])
    ref = np.asarray(j_eval_ao(mj.basis_set, jnp.asarray(mj.coords),
                               jnp.asarray(pts.numpy()), deriv=1))
    got = t_eval_ao(mt.basis_set, _t(mt.coords), pts, deriv=1)
    assert got.shape == ref.shape == (4, 503, mt.nao)
    assert np.abs(got.numpy() - ref).max() < 1e-10
    assert torch.all(got[:, -3:] == 0.0)        # exact zeros, no NaN


@pytest.mark.parametrize("name", ["e_x_slater", "e_c_vwn3", "e_x_b88",
                                  "e_c_lyp"])
def test_xc_energy_densities_match_cctpu(name):
    rng = np.random.default_rng(4)
    n = 400
    ra = 10.0 ** rng.uniform(-13, 2, n)
    ra[:5] = 0.0
    rb = ra.copy()
    saa = (10.0 ** rng.uniform(-26, 2, n)) * (ra > 0)
    args = (ra, rb, saa, saa, saa, np.zeros(n), np.zeros(n))
    ref = np.asarray(getattr(j_xc, name)(*map(jnp.asarray, args)))
    got = getattr(t_xc, name)(*map(_t, args)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() < 1e-12 * max(1.0, np.abs(ref).max())


def test_functional_registry():
    b3 = t_xc.get_functional("B3LYP")
    assert b3.hyb == pytest.approx(0.20) and b3.xctype == "GGA"
    assert t_xc.get_functional("hf").exc is None
    with pytest.raises(ValueError, match="unknown XC functional"):
        t_xc.get_functional("b3lyp-x")
    assert t_xc.get_functional("pbe0").hyb == pytest.approx(0.25)


def test_b3lyp_exc_vxc_match_cctpu(mols):
    mj, mt = mols
    fj = JRKS(mj, xc="b3lyp", density_fit=True, grid_level=1)
    ft = TRKS(mt, xc="b3lyp", density_fit=True, grid_level=1,
              device="cpu")
    # the SAD guess: a non-idempotent density
    dm = np.asarray(fj.init_guess_dm())
    fj._prepare_xc_f64()
    ej, vj = jax.value_and_grad(fj._exc_total)(jnp.asarray(dm))
    vj = 0.5 * (np.asarray(vj) + np.asarray(vj).T)
    et, vt = ft._exc_vxc(_t(dm))
    vt = 0.5 * (vt + vt.T)
    assert abs(float(et) - float(ej)) < 1e-10
    assert np.abs(vt.numpy() - vj).max() < 1e-10
