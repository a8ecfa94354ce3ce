"""The fused DF-J/K of the port against cctpu's, and DFJK on the CPU.

Tolerances: 1e-12 relative (max error over max value) against cctpu's f64
einsum reference; 1e-5 relative against the f32 Pallas kernel run in
interpret mode (cctpu's own Pallas tolerance, tests/test_pallas_ops.py);
1e-10 for DFJK's J/K, whose B comes from another eigh implementation.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cctpu.core.molecule import Molecule as JMolecule
from cctpu.ints.df import DFJK as JDFJK
from cctpu.ops.df_jk_pallas import df_jk_fused as j_fused
from cctpu.ops.df_jk_pallas import df_jk_reference as j_reference
from cctpu_torch.core.molecule import Molecule as TMolecule
from cctpu_torch.ints.df import DFJK as TDFJK
from cctpu_torch.ops import df_jk
from test_torch_threads import one_torch_thread  # noqa: F401

WATER = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
# cctpu's tests/test_pallas_ops.py shapes (naux, nao, nocc), unaligned
SHAPES = [(96, 32, 8), (37, 16, 3), (83, 24, 5)]


def _inputs(naux, nao, nocc, seed):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((naux, nao, nao))
    C = rng.standard_normal((nao, nocc))
    return B, 2 * C @ C.T, C


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return np.abs(x - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("shape", SHAPES)
def test_df_jk_reference_matches_cctpu(shape):
    B, D, C = _inputs(*shape, seed=shape[0])
    Jr, Kr = j_reference(*map(jnp.asarray, (B, D, C)))
    Jt, Kt = df_jk.df_jk_reference(*map(torch.as_tensor, (B, D, C)))
    assert _rel(Jt.numpy(), Jr) < 1e-12
    assert _rel(Kt.numpy(), Kr) < 1e-12


@pytest.mark.parametrize("shape", SHAPES)
def test_df_jk_matches_cctpu_pallas_interpret(shape):
    B, D, C = _inputs(*shape, seed=shape[0] + 1)
    Jp, Kp = j_fused(*map(jnp.asarray, (B, D, C)), interpret=True)
    Jt, Kt = df_jk.df_jk_fused(*map(torch.as_tensor, (B, D, C)))
    assert _rel(Jt.numpy(), Jp) < 1e-5
    assert _rel(Kt.numpy(), Kp) < 1e-5


def test_plain_versions_at_padding_shapes():
    """An odd nao and nocc not a multiple of 8 (what the tensor-core tiles
    pad), with a B that is not symmetric: the plain J/K and the plain K
    against the four sums written out, W contracted over B's column index.
    (One test for the three shapes: see ROADMAP queue 3 on the number of
    collected tests.)"""
    from cctpu_torch.ops import df_k
    for shape in [(9, 61, 15), (7, 13, 5), (5, 24, 9)]:
        B, D, C = _inputs(*shape, seed=shape[1])
        tB, tD, tC = (torch.as_tensor(x) for x in (B, D, C))
        J, K = df_jk.df_jk_reference(tB, tD, tC)
        jp = (B * D[None]).sum(axis=(1, 2))
        Kref = sum((B[p] @ C) @ (B[p] @ C).T for p in range(shape[0]))
        assert not np.allclose(B[0], B[0].T)
        assert _rel(J.numpy(), (jp[:, None, None] * B).sum(axis=0)) < 1e-13
        assert _rel(K.numpy(), Kref) < 1e-13
        assert _rel(df_k.df_k_reference(tB, tC).numpy(), Kref) < 1e-13


def test_df_jk_fused_cpu_takes_plain_version():
    B, D, C = map(torch.as_tensor, _inputs(37, 16, 3, seed=5))
    before = df_jk.LAUNCHES
    J, K = df_jk.df_jk_fused(B, D, C)
    Jr, Kr = df_jk.df_jk_reference(B, D, C)
    assert torch.equal(J, Jr) and torch.equal(K, Kr)
    assert df_jk.LAUNCHES == before          # no kernel launch on the CPU


def test_df_jk_fused_rejects_mixed_devices():
    B, D, C = map(torch.as_tensor, _inputs(8, 4, 2, seed=6))
    with pytest.raises(ValueError):
        df_jk.df_jk_fused(B, D.to("meta"), C)


@pytest.fixture(scope="module")
def water_dfjk():
    mj = JMolecule.from_atoms(WATER, basis="sto-3g")
    mt = TMolecule.from_atoms(WATER, basis="sto-3g")
    jj = JDFJK(mj)
    jt = TDFJK(mt, torch.as_tensor(mt.coords))
    return jj, jt


def test_dfjk_fitted_eri_matches_cctpu(water_dfjk):
    jj, jt = water_dfjk
    Bj = np.asarray(jj.B)
    Bt = jt.B.numpy()
    n = Bt.shape[1]
    assert Bt.shape == Bj.shape
    Ej = np.einsum("pij,pkl->ijkl", Bj, Bj).reshape(n * n, n * n)
    Et = np.einsum("pij,pkl->ijkl", Bt, Bt).reshape(n * n, n * n)
    assert np.abs(Et - Ej).max() < 1e-10 * np.abs(Ej).max()


def test_dfjk_cpu_jk_matches_cctpu(water_dfjk):
    jj, jt = water_dfjk
    rng = np.random.default_rng(11)
    C = rng.standard_normal((jt.B.shape[1], 5)) * 0.5
    D = C @ C.T
    Jj, Kj = jj(jnp.asarray(D), cocc=jnp.asarray(C))
    Jt, Kt = jt(torch.as_tensor(D), cocc=torch.as_tensor(C))
    assert _rel(Jt.numpy(), Jj) < 1e-10
    assert _rel(Kt.numpy(), Kj) < 1e-10
    # the other branches (dm-contracted K; J alone) on the CPU
    J2, K2 = jt(torch.as_tensor(D), with_k=True, cocc=None)
    J3, K3 = jt(torch.as_tensor(D), with_k=False, cocc=torch.as_tensor(C))
    assert K3 is None
    assert torch.allclose(J2, Jt, rtol=1e-12, atol=1e-12)
    assert torch.allclose(J3, Jt, rtol=1e-12, atol=1e-12)
    assert torch.allclose(K2, Kt, rtol=1e-10, atol=1e-10)
