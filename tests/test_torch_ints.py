"""Integrals of the port against cctpu on the CPU, same numpy inputs.

Tolerances: the Boys function to 1e-14 relative (the same branchy
formulation); 1e integrals, quartet classes, 2c2e and 3c2e to 1e-12
(max abs, f64 sums taken in another order); the metric factor through
Linv^T Linv (Linv itself is unique only up to eigenvector signs and
rotations), see test_metric_factor_matches_cctpu.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cctpu.core.molecule import Molecule as JMolecule
from cctpu.ints import boys as j_boys
from cctpu.ints import md as j_md
from cctpu.ints import two_electron as j_te
from cctpu.ints.df import autoaux as j_autoaux
from cctpu.ints.df import build_2c2e_hostassemble, build_3c2e_hostassemble
from cctpu.ints.df import metric_factor as j_metric_factor
from cctpu.ints.one_electron import build_int1e_eager as j_int1e
from cctpu_torch.core.molecule import Molecule as TMolecule
from cctpu_torch.ints import boys as t_boys
from cctpu_torch.ints import md as t_md
from cctpu_torch.ints import two_electron as t_te
from cctpu_torch.ints.df import autoaux as t_autoaux
from cctpu_torch.ints.df import build_2c2e, build_3c2e
from cctpu_torch.ints.df import metric_factor as t_metric_factor
from cctpu_torch.ints.one_electron import build_int1e_eager as t_int1e
from test_torch_threads import one_torch_thread  # noqa: F401

WATER = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def test_boys_matches_cctpu():
    T = np.concatenate([[0.0, 1e-12, 1e-3, 0.05, 0.0999, 0.1, 0.1001],
                        np.linspace(0.0, 200.0, 4001), [129.99, 130.0,
                                                        130.01, 200.0]])
    for mmax in range(9):
        ref = np.asarray(j_boys.boys(jnp.asarray(T), mmax))
        got = t_boys.boys(_t(T), mmax).numpy()
        assert got.shape == ref.shape
        rel = np.abs(got - ref) / np.abs(ref)
        assert rel.max() < 1e-14, (mmax, rel.max())


def test_md_e3_and_r_box_match_cctpu():
    rng = np.random.default_rng(3)
    a = rng.uniform(0.2, 5.0, (3, 1))
    b = rng.uniform(0.2, 5.0, (1, 2))
    A, B = rng.normal(size=3), rng.normal(size=3)
    for la, lb in [(0, 0), (1, 0), (2, 1), (2, 2)]:
        ref = np.asarray(j_md.e3_components(la, lb, jnp.asarray(a),
                                            jnp.asarray(b), jnp.asarray(A),
                                            jnp.asarray(B)))
        got = t_md.e3_components(la, lb, _t(a), _t(b), _t(A), _t(B)).numpy()
        assert np.abs(got - ref).max() < 1e-12 * max(1.0, np.abs(ref).max())
    alpha = rng.uniform(0.1, 3.0, (4, 5))
    PQ = rng.normal(size=(4, 5, 3))
    for ltot in (0, 3, 6):
        ref = np.asarray(j_md.r_box(ltot, jnp.asarray(alpha),
                                    jnp.asarray(PQ)))
        got = t_md.r_box(ltot, _t(alpha), _t(PQ)).numpy()
        assert np.abs(got - ref).max() < 1e-12 * max(1.0, np.abs(ref).max())


def test_int1e_water_631gs_matches_cctpu():
    mj = JMolecule.from_atoms(WATER, basis="6-31g*")
    mt = TMolecule.from_atoms(WATER, basis="6-31g*")
    ref = j_int1e(mj.basis_set, jnp.asarray(mj.coords),
                  jnp.asarray(mj.charges), with_dipole=True)
    got = t_int1e(mt.basis_set, _t(mt.coords), _t(mt.charges),
                  with_dipole=True)
    for k in ("S", "T", "V", "dipole"):
        r, g = np.asarray(ref[k]), got[k].numpy()
        assert g.shape == r.shape
        assert np.abs(g - r).max() < 1e-12, k


# one class per angular momentum up to (d,p|d,s), primitive axes padded
# like the production tables (pad exponent 1, coefficient 0)
@pytest.mark.parametrize("ls", [(0, 0, 0, 0), (1, 0, 0, 0), (1, 1, 1, 0),
                                (2, 0, 1, 1), (2, 1, 2, 0)])
def test_quartet_class_matches_cctpu(ls):
    rng = np.random.default_rng(sum(ls) + 7 * ls[0])
    nq, nprim = 6, (3, 2, 1, 3)
    args = []
    for k in range(4):
        e = rng.uniform(0.1, 8.0, (nq, nprim[k]))
        c = rng.uniform(-1.0, 1.0, (nq, nprim[k]))
        e[:, -1:] = np.where(k == 3, 1.0, e[:, -1:])       # a padded slot
        c[:, -1:] = np.where(k == 3, 0.0, c[:, -1:])
        xyz = rng.normal(size=(nq, 3))
        args += [e, c, xyz]
    ref = np.asarray(jax.vmap(lambda *a: j_te.eri_quartet_kernel(ls, *a))(
        *map(jnp.asarray, args)))
    got = t_te.eri_quartet_kernel(ls, *map(_t, args)).numpy()
    assert got.shape == ref.shape == (nq, 2 * ls[0] + 1, 2 * ls[1] + 1,
                                      2 * ls[2] + 1, 2 * ls[3] + 1)
    assert np.abs(got - ref).max() < 1e-12 * max(1.0, np.abs(ref).max())


@pytest.fixture(scope="module")
def water_sto3g():
    mj = JMolecule.from_atoms(WATER, basis="sto-3g")
    mt = TMolecule.from_atoms(WATER, basis="sto-3g")
    aj, at = j_autoaux(mj.basis_set), t_autoaux(mt.basis_set)
    c = jnp.asarray(mj.coords)
    ref = {"M": np.asarray(build_2c2e_hostassemble(aj, c)),
           "X": np.asarray(build_3c2e_hostassemble(mj.basis_set, aj, c))}
    return mt, aj, at, ref


def test_autoaux_identical(water_sto3g):
    _, aj, at, _ = water_sto3g
    assert at.nao == aj.nao
    for sj, st in zip(aj.shells, at.shells):
        assert (st.atom, st.l) == (sj.atom, sj.l)
        assert np.array_equal(st.exps, sj.exps)
        assert np.array_equal(st.coefs, sj.coefs)


def test_2c2e_water_sto3g_matches_cctpu(water_sto3g):
    mt, _, at, ref = water_sto3g
    M = build_2c2e(at, _t(mt.coords)).numpy()
    assert M.shape == ref["M"].shape
    assert np.abs(M - ref["M"]).max() < 1e-12


def test_3c2e_water_sto3g_matches_cctpu(water_sto3g):
    mt, _, at, ref = water_sto3g
    X = build_3c2e(mt.basis_set, at, _t(mt.coords)).numpy()
    assert X.shape == ref["X"].shape
    assert np.abs(X - ref["X"]).max() < 1e-12


@pytest.mark.parametrize("method", ["eigh", "pivot"])
def test_metric_factor_matches_cctpu(water_sto3g, method):
    """Linv^T Linv = M^+ against cctpu's, and the fitted ERIs X^T M^+ X.

    The pivot path runs the same host LAPACK code on the same numbers:
    1e-10 relative. The eigh path compares torch's eigh with numpy's on a
    metric of condition ~1e8, where two eigh implementations legitimately
    differ by ~eps * cond in the near-null directions (7e-10 relative
    measured on the fitted ERIs): 1e-8 relative there."""
    _, _, _, ref = water_sto3g
    M, X = ref["M"], ref["X"].reshape(ref["X"].shape[0], -1)
    Lj = np.asarray(j_metric_factor(M, method=method))
    Lt = t_metric_factor(_t(M), method=method).numpy()
    assert Lt.shape == Lj.shape
    Pj, Pt = Lj.T @ Lj, Lt.T @ Lt
    Ej, Et = X.T @ Pj @ X, X.T @ Pt @ X
    tol = 1e-10 if method == "pivot" else 1e-8
    assert np.abs(Et - Ej).max() < tol * np.abs(Ej).max()
    assert np.abs(Pt - Pj).max() < tol * np.abs(Pj).max()
