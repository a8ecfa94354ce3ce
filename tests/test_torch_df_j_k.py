"""DF-J and DF-K of the port (``ops/df_j.py``, ``ops/df_k.py``) against
cctpu's ``df_j_fast`` / ``df_k_fast``, and the J/K dispatch on the CPU.

On the CPU the wrappers take their plain torch twins. Tolerances: 1e-5
relative (max error over max value) against the f32 Pallas kernels run in
interpret mode (cctpu's own Pallas tolerance, tests/test_pallas_ops.py);
1e-12 relative against cctpu's f64 einsums (the same contractions in f64,
summed in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cctpu.ops.df_jk_pallas import df_j_fast as j_df_j_fast
from cctpu.ops.df_jk_pallas import df_jk_reference as j_reference
from cctpu.ops.df_jk_pallas import df_k_fast as j_df_k_fast
from cctpu_torch.ints.df import _BContractions
from cctpu_torch.ops import df_j, df_k

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
def test_df_j_k_match_cctpu_pallas_interpret(shape):
    B, D, C = _inputs(*shape, seed=shape[0] + 2)
    Jp = j_df_j_fast(jnp.asarray(B), jnp.asarray(D), interpret=True)
    Kp = j_df_k_fast(jnp.asarray(B), jnp.asarray(C), interpret=True)
    Bt, Dt, Ct = map(torch.as_tensor, (B, D, C))
    assert _rel(df_j.df_j_fast(Bt, Dt).numpy(), Jp) < 1e-5
    assert _rel(df_k.df_k_fast(Bt, Ct).numpy(), Kp) < 1e-5


@pytest.mark.parametrize("shape", SHAPES)
def test_df_j_k_reference_match_cctpu_f64(shape):
    B, D, C = _inputs(*shape, seed=shape[0] + 3)
    Jr, Kr = j_reference(*map(jnp.asarray, (B, D, C)))
    Bt, Dt, Ct = map(torch.as_tensor, (B, D, C))
    assert _rel(df_j.df_j_reference(Bt, Dt).numpy(), Jr) < 1e-12
    assert _rel(df_k.df_k_reference(Bt, Ct).numpy(), Kr) < 1e-12


def test_df_j_two_sets_equal_two_calls():
    B, D, _ = map(torch.as_tensor, _inputs(37, 16, 3, seed=7))
    D2 = torch.stack([D, 0.5 * D.T @ D])
    J2 = df_j.df_j_fast(B, D2)
    assert J2.shape == D2.shape
    for s in range(2):
        assert torch.allclose(J2[s], df_j.df_j_fast(B, D2[s]),
                              rtol=1e-13, atol=1e-13)


def test_df_k_zero_column_and_cpu_dispatch():
    """A Cocc of zeros (the beta spin of a one-electron system) gives
    K = 0; CPU tensors never count a launch."""
    B, D, C = map(torch.as_tensor, _inputs(37, 16, 3, seed=8))
    before = (df_j.LAUNCHES, df_k.LAUNCHES)
    zero = torch.zeros(16, 1, dtype=B.dtype)
    assert torch.count_nonzero(df_k.df_k_fast(B, zero)) == 0
    assert torch.equal(df_k.df_k_fast(B, C), df_k.df_k_reference(B, C))
    assert torch.equal(df_j.df_j_fast(B, D), df_j.df_j_reference(B, D))
    assert (df_j.LAUNCHES, df_k.LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA"):
        df_k.df_k_fast(B, C.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        df_j.df_j_fast(B, D.to("meta"))


def test_bcontractions_spin_branches_on_cpu():
    """The open-shell and pure-functional branches: J of a [2, n, n] dm,
    K per spin of a tuple cocc with different nocc (one of them a zero
    column), J alone for with_k=False."""
    B, _, _ = _inputs(37, 16, 3, seed=9)
    rng = np.random.default_rng(10)
    Ca, Cb = rng.standard_normal((16, 4)), np.zeros((16, 1))
    jk = _BContractions()
    jk.B = torch.as_tensor(B)
    dm = torch.as_tensor(np.stack([Ca @ Ca.T, Cb @ Cb.T]))
    J, K = jk(dm, cocc=(torch.as_tensor(Ca), torch.as_tensor(Cb)))
    Jr, Kr = j_reference(jnp.asarray(B), jnp.asarray(Ca @ Ca.T),
                         jnp.asarray(Ca))
    assert J.shape == K.shape == (2, 16, 16)
    assert _rel(J[0].numpy(), Jr) < 1e-12 and _rel(K[0].numpy(), Kr) < 1e-12
    assert torch.count_nonzero(J[1]) == 0 and torch.count_nonzero(K[1]) == 0
    J1, K1 = jk(dm[0], with_k=False, cocc=torch.as_tensor(Ca))
    assert K1 is None and _rel(J1.numpy(), Jr) < 1e-12
