"""The port's TDDFT/TDA and the ``uv`` CLI on the CPU, held against cctpu.

(a) ``df_k_dm``'s plain twin and the DF builders' K of general densities
    (on B and on B_lr) against cctpu's ``DFJK._k_of`` einsum, on random
    non-symmetric batches at an odd nao (<= 1e-12 relative);
(b) the Davidson solvers against cctpu's on a synthetic diagonally
    dominant operator (numpy only; eigenvalues <= 1e-10);
(c) the XC kernel's action ``fxc_operator`` against cctpu's
    ``jax.jvp(jax.grad(mf._exc_total))`` from the same dm0: B3LYP
    (restricted, non-symmetric P), UB3LYP on OH (stacked P) and M06-2X
    (<= 1e-10 relative);
(d) TDDFT/TDA against cctpu's from the same converged orbitals: H2
    CIS/TDHF against the analytic values of cctpu's tests/test_tddft.py;
    water HF and B3LYP (RPA and TDA), OH UB3LYP TDA and water
    DF-CAM-B3LYP TDA (B_lr) against ``ORACLES``. The dense Casida path:
    excitation energies <= 1e-9 Ha, f <= 1e-8. The TDA goes through the
    Davidson (residual 1e-6 in both packages): energies <= 1e-9 Ha, f <=
    1e-6, summed over each degenerate set (the amplitudes of a
    degenerate set are not unique);
(e) ``cli uv --device cpu`` on water (B3LYP/STO-3G, grid level 1) against
    cctpu's CLI numbers, and ``uv`` without ``--device cpu`` raising here
    (no card).

cctpu's TDDFT compiles its matvec per batch shape (tens of seconds a
case), so (d) and (e) read cctpu's numbers from ``ORACLES``: cctpu's TDDFT
on the port's converged SCF state, and its CLI at the port's embedded
coordinates, as ``python scripts/make_uv_oracles.py <case>`` prints them
(one case a process; the script builds the port's SCFs with
``port_scf`` below).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cctpu.ints.df import DFJK as JDFJK
from cctpu.response import davidson as j_davidson
from cctpu_torch.core.molecule import Molecule
from cctpu_torch.dft.rks import RKS, UKS
from cctpu_torch.ints.df import DFJK
from cctpu_torch.ints.two_electron import build_eri_incore
from cctpu_torch.ops.df_k_dm import df_k_dm, df_k_dm_reference
from cctpu_torch.response import davidson as t_davidson
from cctpu_torch.response.tddft import TDA, TDDFT
from cctpu_torch.scf.hf import RHF, UHF
from cctpu_torch.utils.measure import WATER
from cctpu_torch.workflows import cli
from test_torch_threads import one_torch_thread  # noqa: F401

OH = "O 0 0 0; H 0 0 0.97"
# the SCFs of (d), as the port builds them (conv_tol 1e-12, on the CPU)
# and cctpu's oracles read their state;
# ``modes``: full TDDFT (False) and/or TDA (True)
SCF_CASES = {
    "t_water_hf": dict(atoms=WATER, spin=0, basis="sto-3g", xc="hf",
                       df=False, grid_level=1, nstates=3,
                       modes=(False, True)),
    "t_water_b3lyp": dict(atoms=WATER, spin=0, basis="sto-3g", xc="b3lyp",
                          df=False, grid_level=1, nstates=3,
                          modes=(False, True)),
    # grid level 3: at level 1 neither package's SCF converges
    "t_oh_ub3lyp": dict(atoms=OH, spin=1, basis="sto-3g", xc="b3lyp",
                        df=False, grid_level=3, nstates=4, modes=(True,)),
    "t_water_camb3lyp_df": dict(atoms=WATER, spin=0, basis="sto-3g",
                                xc="cam-b3lyp", df=True, grid_level=1,
                                nstates=3, modes=(True,)),
}
# (e): the uv CLI's arguments
CLI_ARGS = ["--smiles", "O", "--method", "b3lyp", "--basis", "sto-3g",
            "--grid-level", "1", "--nstates", "3"]

# cctpu's numbers (Ha; f dimensionless), from
#   python scripts/make_uv_oracles.py <case>
ORACLES = {
    "t_water_hf": {
        "rpa": {
            "e": [0.4831013682114194, 0.5560179347748855, 0.6122596019384472],
            "f": [
                0.00326030921841382, 2.572044385287147e-31,
                0.06646058514713268],
            "converged": True,
        },
        "tda": {
            "e": [0.4846401886311583, 0.5565508965567256, 0.6163121487610748],
            "f": [
                0.0035423738507956025, 3.319183171493987e-29,
                0.07721854784555947],
            "converged": True,
        },
    },
    "t_water_b3lyp": {
        "rpa": {
            "e": [0.42848510846976173, 0.5132955062721455, 0.5331316955534858],
            "f": [
                0.0023388912621910667, 9.964301139570018e-32,
                0.06389495041988137],
            "converged": True,
        },
        "tda": {
            "e": [0.430142340797791, 0.5139652451760697, 0.5384866069775092],
            "f": [
                0.0025851329493352883, 1.1291904905206855e-31,
                0.07501601236223353],
            "converged": True,
        },
    },
    "t_oh_ub3lyp": {
        "tda": {
            "e": [
                0.00839104333120036, 0.2159203784534787, 0.3921514405757637,
                0.4517331587383543],
            "f": [
                1.5430613452145403e-34, 0.005732045913659278,
                6.070822886319388e-05, 0.0009263189794496801],
            "converged": True,
        },
    },
    "t_water_camb3lyp_df": {
        "tda": {
            "e": [0.43390597680787574, 0.5172610170294456, 0.5416849453154838],
            "f": [
                0.002794493156996995, 1.3397758932428253e-29,
                0.07389910570476742],
            "converged": True,
        },
    },
    "t_uv_cli": {
        "e_scf": -75.30737659694532,
        "e": [0.42692762884947516, 0.5155017045111359, 0.5300358163451327],
        "f": [
            0.0026896552531204877, 0.05302530321467026,
            6.6917448165805355e-12],
        "converged": True,
    },
}


@functools.lru_cache(maxsize=None)
def port_scf(key):
    """The port's converged SCF of ``SCF_CASES[key]`` on the CPU."""
    spec = SCF_CASES[key]
    mol = Molecule.from_atoms(spec["atoms"], spin=spec["spin"],
                              basis=spec["basis"])
    opts = dict(density_fit=spec["df"], device="cpu", conv_tol=1e-12)
    if spec["xc"] == "hf":
        mf = (UHF if spec["spin"] else RHF)(mol, **opts)
    else:
        mf = (UKS if spec["spin"] else RKS)(mol, xc=spec["xc"],
                                            grid_level=spec["grid_level"],
                                            **opts)
    mf.kernel()
    assert mf.converged
    return mf


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def test_df_k_dm_twin_and_builders_match_cctpu():
    """(a) K[s] = sum_p B[p] D[s] B[p]^T: the plain twin on a B whose rows
    are not symmetric, and the DF builder's ``k`` (on B) and ``k_lr`` (on
    B_lr) of water/STO-3G (nao 7), for non-symmetric batches, against
    cctpu's ``DFJK._k_of(B, D, None)``."""
    rng = np.random.default_rng(5)
    j_k_of = JDFJK.__new__(JDFJK)._k_of
    B = rng.standard_normal((23, 9, 9))
    D = rng.standard_normal((3, 9, 9))
    for d in (D, D[1]):
        ref = np.asarray(j_k_of(jnp.asarray(B), jnp.asarray(d), None))
        got = df_k_dm(torch.as_tensor(B), torch.as_tensor(d)).numpy()
        assert got.shape == d.shape and _rel(got, ref) <= 1e-12
        assert _rel(df_k_dm_reference(torch.as_tensor(B),
                                      torch.as_tensor(d)).numpy(), ref) \
            <= 1e-12
    mol = Molecule.from_atoms(WATER, basis="sto-3g")
    jk = DFJK(mol, torch.as_tensor(mol.coords), lmax_cap=1)
    P = rng.standard_normal((5, 2, mol.nao, mol.nao))
    for Bt, got in ((jk.B, jk.k(torch.as_tensor(P))),
                    (jk.prepare_lr(0.2)[0],
                     jk.k_lr(torch.as_tensor(P), 0.2))):
        ref = np.asarray(j_k_of(jnp.asarray(Bt.numpy()), jnp.asarray(P),
                                None))
        assert _rel(got.numpy(), ref) <= 1e-12
    # J of a batch of general densities: two densities a df_j_fast call
    J = jk.j(torch.as_tensor(P[:, 0])).numpy()
    Bn = jk.B.numpy()
    assert _rel(J, np.einsum("pij,skl,pkl->sij", Bn, P[:, 0], Bn)) <= 1e-12


def _operator(n, seed):
    """A symmetric diagonally dominant matrix with a spread diagonal."""
    rng = np.random.default_rng(seed)
    A = 1e-2 * rng.standard_normal((n, n))
    return 0.5 * (A + A.T) + np.diag(np.linspace(0.3, 3.0, n))


def test_davidson_matches_cctpu():
    """(b) ``davidson`` (TDA-like A) and ``rpa_davidson`` (A+B, A-B both
    positive definite) against cctpu's on the same operator: eigenvalues
    <= 1e-10, and against the dense eigenvalues <= 1e-8."""
    n, k = 160, 5
    A, Bm = _operator(n, 0), 0.2 * _operator(n, 1)
    Bm -= np.diag(np.diag(Bm))
    diag = np.diag(A).copy()
    w_t, _, conv_t = t_davidson.davidson(lambda V: A @ V, diag, k)
    w_j, _, conv_j = j_davidson.davidson(lambda V: A @ V, diag, k)
    assert conv_t and conv_j and np.abs(w_t - w_j).max() <= 1e-10
    assert np.abs(w_t - np.linalg.eigvalsh(A)[:k]).max() <= 1e-8
    apb, amb = A + Bm, A - Bm
    out_t = t_davidson.rpa_davidson(lambda V: apb @ V, lambda V: amb @ V,
                                    diag, k)
    out_j = j_davidson.rpa_davidson(lambda V: apb @ V, lambda V: amb @ V,
                                    diag, k)
    assert out_t[3] and out_j[3]
    assert np.abs(out_t[0] - out_j[0]).max() <= 1e-10
    exact = np.sqrt(np.sort(np.linalg.eigvals(amb @ apb).real)[:k])
    assert np.abs(out_t[0] - exact).max() <= 1e-8


def test_fxc_action_matches_cctpu_jvp():
    """(c) The Hessian-vector products of E_xc at the port's converged dm0
    against cctpu's forward-over-reverse jvp on the same grid (level 1):
    B3LYP and M06-2X on water (restricted, random non-symmetric P), UB3LYP
    on OH (P stacked over the spins)."""
    from cctpu.core.molecule import Molecule as JMolecule
    from cctpu.dft.rks import RKS as JRKS
    from cctpu.dft.rks import UKS as JUKS
    rng = np.random.default_rng(3)
    for key, xc in (("t_water_b3lyp", "b3lyp"), ("t_water_b3lyp", "m06-2x"),
                    ("t_oh_ub3lyp", "b3lyp")):
        spec = SCF_CASES[key]
        mf = port_scf(key)
        if xc != spec["xc"]:
            mf = RKS(mf.mol, xc=xc, grid_level=spec["grid_level"],
                     device="cpu")
        dm0 = port_scf(key).dm
        jmol = JMolecule.from_atoms(spec["atoms"], spin=spec["spin"],
                                    basis=spec["basis"])
        jmf = (JUKS if spec["spin"] else JRKS)(
            jmol, xc=xc, grid_level=spec["grid_level"])
        P = rng.standard_normal((3, *dm0.shape))
        got = mf.fxc_operator(dm0)(torch.as_tensor(P)).numpy()
        d0 = jnp.asarray(dm0.numpy())
        ref = jax.jit(jax.vmap(lambda p: jax.jvp(
            jax.grad(jmf._exc_total), (d0,), (p,))[1]))(jnp.asarray(P))
        assert _rel(got, np.asarray(ref)) <= 1e-10, (key, xc)


def _h2_analytic():
    """H2/STO-3G (one occupied, one virtual orbital): the CIS and TDHF
    excitation energies from the port's in-core MO integrals, as cctpu's
    tests/test_tddft.py builds them."""
    mol = Molecule(symbols=["H", "H"],
                   coords=np.array([[0, 0, 0], [0, 0, 1.4]]), basis="sto-3g")
    mf = RHF(mol, device="cpu", conv_tol=1e-12)
    mf.kernel()
    eri = build_eri_incore(mol.basis_set, torch.as_tensor(mol.coords))
    C = mf.mo_coeff.numpy()
    mo = np.einsum("pi,qj,rk,sl,pqrs->ijkl", C, C, C, C, eri.numpy())
    e = mf.mo_energy.numpy()
    A = e[1] - e[0] + 2 * mo[0, 1, 0, 1] - mo[0, 0, 1, 1]
    Bv = mo[0, 1, 0, 1]
    return mf, A, np.sqrt((A - Bv) * (A + Bv))


def _states_match(e, f, ref, e_tol, f_tol):
    """Energies state by state; oscillator strengths summed over each set
    of states degenerate within 1e-6 Ha."""
    e, f = np.asarray(e), np.asarray(f)
    assert np.abs(e - ref["e"]).max() <= e_tol, (e, ref["e"])
    cuts = np.flatnonzero(np.diff(ref["e"]) > 1e-6) + 1
    for idx in np.split(np.arange(len(e)), cuts):
        assert abs(f[idx].sum() - np.sum(np.asarray(ref["f"])[idx])) \
            <= f_tol, (f, ref["f"])


def test_tddft_matches_cctpu():
    """(d) H2 CIS/TDHF against the analytic values (<= 1e-10 Ha); the
    ``SCF_CASES`` against cctpu's TDDFT/TDA on the same orbitals: dense
    Casida (RPA) energies <= 1e-9 Ha and f <= 1e-8, Davidson (TDA)
    energies <= 1e-9 Ha and f <= 1e-6 (its residual is 1e-6)."""
    mf, w_cis, w_tdhf = _h2_analytic()
    assert abs(TDA(mf, nstates=1).kernel()[0] - w_cis) <= 1e-10
    td = TDDFT(mf, nstates=1)
    assert abs(td.kernel()[0] - w_tdhf) <= 1e-10
    assert td.oscillator_strength()[0] > 0.1   # sigma -> sigma*, allowed
    for key, spec in SCF_CASES.items():
        mf = port_scf(key)
        for tda in spec["modes"]:
            td = TDDFT(mf, nstates=spec["nstates"], tda=tda)
            td.kernel()
            assert td.converged
            ref = ORACLES[key]["tda" if tda else "rpa"]
            _states_match(td.e, td.oscillator_strength(), ref, 1e-9,
                          1e-6 if tda else 1e-8)


def test_uv_cli_matches_cctpu(tmp_path):
    """(e) ``cli uv --device cpu`` on water against cctpu's CLI (SCF energy
    <= 1e-9 Ha, states as (d)'s dense path); ``uv`` is listed as ported,
    and without ``--device cpu`` it raises here (no card)."""
    from cctpu_torch.workflows import calculate_uv_spectrum
    assert "uv" in cli._WORKFLOWS and "uv" not in cli._NOT_PORTED
    td = calculate_uv_spectrum.main([*CLI_ARGS, "--device", "cpu",
                                     "--output-dir", str(tmp_path)])
    ref = ORACLES["t_uv_cli"]
    assert abs(td.mf.e_tot - ref["e_scf"]) <= 1e-9
    _states_match(td.e, td.oscillator_strength(), ref, 1e-9, 1e-8)
    report = next(tmp_path.glob("*_short_report.txt")).read_text()
    assert "strongest absorption" in report and "TDDFT: converged True" \
        in report
    assert cli._WORKFLOWS["uv"][0] == calculate_uv_spectrum.__name__
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["uv", *CLI_ARGS, "--output-dir", str(tmp_path)])
