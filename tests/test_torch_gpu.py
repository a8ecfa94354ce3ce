"""Tests of the port that need the card: the CUDA kernels (fused J+K, J,
K) against their plain versions, the CUDA dispatch (launch or raise), and
the in-core and Cholesky SCFs and the direct gradient on the card against
the CPU. They skip without a CUDA device. This file imports neither JAX nor cctpu,
so it also runs on a machine without them:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
"""

import json
import os

import numpy as np
import pytest
import torch

from cctpu_torch.core.molecule import Molecule
from cctpu_torch.ints.df import DFJK
from cctpu_torch.ops import df_j, df_jk, df_k

pytestmark = pytest.mark.gpu

with open(os.path.join(os.path.dirname(__file__), "..", "scripts",
                       "sad_oracles.json")) as _f:
    WATER_CD_631G_E = json.load(_f)["water_cd_631g_e"]

WATER = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
# cctpu's tests/test_pallas_ops.py shapes (naux, nao, nocc), unaligned,
# and a C32H66-sized row (nao 580 -> 600, nocc 129) with few aux rows: the
# path where neither B[p] nor W_p fits in shared memory
SHAPES = [(96, 32, 8), (37, 16, 3), (83, 24, 5), (150, 600, 129)]
# an odd nao (8-byte copies), and both sides of each boundary of
# ops/plan.py::wk_plan: K in registers or in device memory (nao 112 | 120),
# the partial J in shared memory or J by a second pass (150 | 180), the
# ring of tiles beside W_p or in its place (180 | 292), the tensor-core
# kernel or the FMA one (292 | 330), one row panel or two (112/100, 360);
# and of ops/plan.py::j_plan, df_j's one pass or two (f64: nao 118 | 119
# for two densities, 168 | 169 for one; f32: 168 | 169 for two, 240 | 241
# for one), with an aux count that leaves partial row groups
PLAN_SHAPES = [(61, 15, 4), (40, 112, 20), (40, 120, 20), (30, 150, 20),
               (30, 180, 40), (20, 292, 65), (20, 330, 80), (30, 112, 100),
               (20, 360, 60), (133, 118, 20), (133, 119, 20), (21, 168, 30),
               (21, 169, 30), (13, 240, 40), (13, 241, 40)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(naux, nao, nocc, seed, dtype, dev):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((naux, nao, nao))
    C = rng.standard_normal((nao, nocc))
    return tuple(torch.as_tensor(x, dtype=dtype, device=dev)
                 for x in (B, 2 * C @ C.T, C))


def _rel(x, ref):
    return float((x - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_kernel_matches_plain_on_card(dev, shape, dtype, tol):
    _check_fused(dev, shape, dtype, tol)


def _check_fused(dev, shape, dtype, tol):
    B, D, C = _inputs(*shape, shape[0], dtype, dev)
    before = df_jk.LAUNCHES
    J, K = df_jk.df_jk_fused(B, D, C)
    J2, K2 = df_jk.df_jk_fused(B, D, C)
    Jr, Kr = df_jk.df_jk_reference(B, D, C)
    assert df_jk.LAUNCHES == before + 2
    assert _rel(J, Jr) < tol and _rel(K, Kr) < tol
    assert torch.equal(J, J2) and torch.equal(K, K2)     # deterministic


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_df_j_k_match_plain_on_card(dev, shape, dtype, tol):
    """df_j_fast for one and two densities, df_k_fast, each against its
    plain twin; repeat calls bitwise equal; one launch per call."""
    _check_j_k(dev, shape, dtype, tol)


def test_kernels_match_plain_at_plan_boundaries(dev):
    """The same checks at PLAN_SHAPES, f64 and f32, in one test (the number
    of collected tests steers the CPU run's scheduling: ROADMAP queue 3);
    and the FP64 tensor-core instructions' lane -> (row, column) layouts,
    as csrc/mma_layout.cu documents them (m16n8k4 through df_wk.cuh's
    mma1684), against torch.matmul."""
    from pathlib import Path

    from cctpu_torch.ops import bench_mma
    src = Path(df_j.__file__).parent / "csrc" / "df_j.cu"
    assert "atomicAdd" not in src.read_text()       # no float atomics
    lib = bench_mma.load()
    for mma_shape in bench_mma.SHAPES:
        assert bench_mma.layout_error(lib, mma_shape, dev) < 1e-14
    for shape in PLAN_SHAPES:
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            _check_fused(dev, shape, dtype, tol)
            _check_j_k(dev, shape, dtype, tol)


def _check_j_k(dev, shape, dtype, tol):
    B, D, C = _inputs(*shape, shape[0] + 1, dtype, dev)
    D2 = torch.stack([D, D @ D / D.abs().max()])
    before = (df_j.LAUNCHES, df_k.LAUNCHES)
    cap = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    J = df_j.df_j_fast(B, D)
    kinds = [df_j.LAST_PLAN["kind"]]
    J2 = df_j.df_j_fast(B, D2)
    kinds.append(df_j.LAST_PLAN["kind"])
    # one pass exactly where the partial J of nset densities fits on chip
    assert kinds == ["one_pass" if B.element_size() * nset * (
        512 + shape[1] ** 2) <= cap else "two_pass" for nset in (1, 2)]
    K = df_k.df_k_fast(B, C)
    assert torch.equal(J2, df_j.df_j_fast(B, D2))
    assert torch.equal(K, df_k.df_k_fast(B, C))
    assert (df_j.LAUNCHES, df_k.LAUNCHES) == (before[0] + 3, before[1] + 2)
    assert _rel(J, df_j.df_j_reference(B, D)) < tol
    for s in range(2):
        assert _rel(J2[s], df_j.df_j_reference(B, D2[s])) < tol
    assert _rel(K, df_k.df_k_reference(B, C)) < tol
    zero = torch.zeros((shape[1], 1), dtype=dtype, device=dev)
    assert torch.count_nonzero(df_k.df_k_fast(B, zero)) == 0


def test_kernel_rejects_what_it_does_not_take(dev):
    B, D, C = _inputs(8, 6, 2, 0, torch.float64, dev)
    with pytest.raises(ValueError, match="contiguous"):
        df_jk.df_jk_fused(B, D, C.T.contiguous().T)
    with pytest.raises(ValueError, match="dtypes"):
        df_jk.df_jk_fused(B, D.float(), C)
    with pytest.raises(ValueError, match="CUDA"):
        df_jk.df_jk_fused(B, D.cpu(), C)
    with pytest.raises(ValueError, match="nset"):
        df_j.df_j_fast(B, torch.stack([D, D, D]))
    with pytest.raises(ValueError, match="contiguous"):
        df_k.df_k_fast(B, C.T.contiguous().T)


def test_dfjk_on_card_launches_or_raises(dev):
    """Every branch of the DF J/K dispatch launches its kernel on the card,
    except the dm-contracted K (cocc=None), which raises before any
    launch."""
    mol = Molecule.from_atoms(WATER, basis="sto-3g")
    jk = DFJK(mol, torch.as_tensor(mol.coords, dtype=torch.float64,
                                   device=dev))
    rng = np.random.default_rng(1)
    C = torch.as_tensor(rng.standard_normal((7, 5)), device=dev)
    Cb = torch.as_tensor(rng.standard_normal((7, 4)), device=dev)
    D, Db = C @ C.T, Cb @ Cb.T

    def counts():
        return df_jk.LAUNCHES, df_j.LAUNCHES, df_k.LAUNCHES

    before = counts()
    J, K = jk(D, cocc=C)
    assert counts() == (before[0] + 1, before[1], before[2])
    Jr, Kr = df_jk.df_jk_reference(jk.B, D, C)
    assert _rel(J, Jr) < 1e-12 and _rel(K, Kr) < 1e-12

    before = counts()
    J1, K1 = jk(D, with_k=False, cocc=C)            # pure functional
    assert counts() == (before[0], before[1] + 1, before[2])
    assert K1 is None and _rel(J1, Jr) < 1e-12

    before = counts()
    J2, K2 = jk(torch.stack([D, Db]), cocc=(C, Cb))   # UHF / UKS
    assert counts() == (before[0], before[1] + 1, before[2] + 2)
    Jbr, Kbr = df_jk.df_jk_reference(jk.B, Db, Cb)
    assert _rel(J2[0], Jr) < 1e-12 and _rel(K2[0], Kr) < 1e-12
    assert _rel(J2[1], Jbr) < 1e-12 and _rel(K2[1], Kbr) < 1e-12

    before = counts()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        jk(D, cocc=None)
    assert counts() == before


def test_incore_and_cholesky_scf_on_card(dev):
    """Water RHF/6-31G on the card: in-core against the same SCF on the CPU
    (<= 1e-10 Ha), with no J/K kernel launched; Cholesky J/K against
    cctpu's host-f64 oracle (<= 1e-8 Ha, the contract), the fused kernel
    launched every cycle."""
    from cctpu_torch.scf.hf import RHF
    mol = Molecule.from_atoms(WATER, basis="6-31g")
    e_cpu = RHF(mol, conv_tol=1e-12, device="cpu").kernel()
    before = df_jk.LAUNCHES, df_j.LAUNCHES, df_k.LAUNCHES
    mf = RHF(mol, conv_tol=1e-12, device=dev)
    e = mf.kernel()
    assert (df_jk.LAUNCHES, df_j.LAUNCHES, df_k.LAUNCHES) == before
    assert mf.converged and abs(e - e_cpu) <= 1e-10
    before = df_jk.LAUNCHES
    mf = RHF(mol, density_fit="cd", conv_tol=1e-12, device=dev)
    e = mf.kernel()
    assert mf._jk.B.is_cuda and df_jk.LAUNCHES - before >= mf.n_cycles
    assert mf.converged and abs(e - WATER_CD_631G_E) <= 1e-8


def test_direct_gradient_on_card(dev):
    """The in-core UHF gradient of NH2/STO-3G on the card against the CPU's
    (<= 1e-10 Ha/bohr), two card calls bitwise equal."""
    from cctpu_torch.grad.scf_grad import gradient
    from cctpu_torch.scf.hf import UHF
    nh2 = "N 0 0 0; H 0 0.8036 0.6347; H 0 -0.8036 0.6347"
    mol = Molecule.from_atoms(nh2, spin=1, basis="sto-3g")
    grads = []
    for d in ("cpu", dev):
        mf = UHF(mol, conv_tol=1e-12, device=d)
        mf.kernel()
        grads.append(gradient(mf))
    g2 = gradient(mf)
    assert torch.equal(grads[1], g2)
    assert float((grads[1].cpu() - grads[0]).abs().max()) <= 1e-10
