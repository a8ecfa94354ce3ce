"""The port's functionals beyond B3LYP on the CPU, held against cctpu on
identical inputs: every registry name, meta-GGA kinetic-energy densities,
D2 dispersion, the erf-attenuated integrals and long-range exchange on the
three J/K routes, SCF energies and nuclear gradients.

Inputs are water and NH2 at STO-3G with grid level 1 and an aux basis up
to l = 1 (every cctpu function called here compiles per integral class,
and its compiles set the file's time); the d-shell classes of the
attenuated kernel are held on water 6-31G* against cctpu's pure-numpy
quartet oracle (no compile). The port builds the DF tensors (B, Linv,
B_lr, Linv_lr) and the in-core tensors; their blocks are held against the
numpy oracle, and both packages then run on them: cctpu's energy at the
port's converged density from its 1e integrals, functional, grid,
nuclear repulsion and dispersion. The gradient terms this slice adds are
held against cctpu's on states made from a numpy seed: the long-range
3c, 2c and direct terms against central differences of cctpu's numpy
oracle tensors, the meta-GGA XC term against jax.grad of cctpu's
``exc_of_coords`` (cctpu's own long-range 3c/2c gradient functions
compile per integral class, too slow for this lane; chip_smoke.py holds
the whole gradients against cctpu's CPU-f64 ones). Tolerances: exc and D2
<= 1e-12 (relative for exc); attenuated integrals and K_lr <= 1e-10
relative; SCF energies <= 1e-10 Ha; gradients <= 1e-8 Ha/bohr.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cctpu.core.molecule import Molecule as JMolecule
from cctpu.dft import xc as j_xc
from cctpu.dft.dispersion import dispersion_energy as j_dispersion_energy
from cctpu.dft.rks import RKS as JRKS
from cctpu.dft.rks import UKS as JUKS
from cctpu.ints.df import autoaux as j_autoaux
from cctpu.ints.host_oracle import eri_2c2e_np, eri_3c2e_np, eri_bra_ket_np
from cctpu_torch.core.molecule import Molecule as TMolecule
from cctpu_torch.dft import dispersion as t_disp
from cctpu_torch.dft import xc as t_xc
from cctpu_torch.dft.rks import RKS as TRKS
from cctpu_torch.dft.rks import UKS as TUKS
from cctpu_torch.grad import df_grad as tdf_grad
from cctpu_torch.grad.scf_grad import gradient
from cctpu_torch.interop import (dfjk_from_numpy, eri_from_numpy,
                                 set_scf_state)
from cctpu_torch.ints.df import DFJK, CholeskyJK, walk_2c2e, walk_3c2e
from cctpu_torch.ints.two_electron import (build_eri_incore,
                                           eri_quartet_kernel, walk_4c)
from cctpu_torch.scf.hf import IncoreJK
from cctpu_torch.utils.measure import NH2, PHENOL, WATER
from cctpu_torch.utils.profiling import PhaseTimer
from cctpu_torch.workflows import cli
from test_torch_threads import one_torch_thread  # noqa: F401

CPU = dict(device="cpu", conv_tol=1e-12, grid_level=1)
AUX_LMAX = 1
OMEGA = 0.2                          # wB97X-D's


def _shells(bs):
    return [(s.atom, s.l, s.exps, s.coefs) for s in bs.shells]


def _system(atoms, spin):
    """cctpu's molecule and the port's, the port's DF builder (aux up to
    ``AUX_LMAX``, B_lr at ``OMEGA``), in-core and Cholesky builders
    (attenuated tensor at ``OMEGA``), and the DF tensors as cctpu's
    gradient code reads them (its own aux basis, the port's B and
    Linv)."""
    jmol = JMolecule.from_atoms(atoms, spin=spin, basis="sto-3g")
    mol = TMolecule.from_atoms(atoms, spin=spin, basis="sto-3g")
    coords = torch.as_tensor(mol.coords)
    df = DFJK(mol, coords, lmax_cap=AUX_LMAX)
    df.prepare_lr(OMEGA)
    incore = IncoreJK(mol, coords)
    incore.prepare_lr(OMEGA)
    cd = CholeskyJK(mol, coords)
    aux = j_autoaux(jmol.basis_set, lmax_cap=AUX_LMAX)
    assert aux.nao == df.aux.nao
    jk = SimpleNamespace(
        aux=aux, _Bh=df.B.numpy(), _Linv=df._Linv.numpy(),
        _B_lr={OMEGA: df.prepare_lr(OMEGA)[0].numpy()},
        _Linv_lr={OMEGA: df.prepare_lr(OMEGA)[1].numpy()},
        prepare_lr=lambda omega: None)
    return SimpleNamespace(jmol=jmol, mol=mol, coords=coords, df=df,
                           incore=incore, cd=cd, jk=jk)


@pytest.fixture(scope="module")
def water():
    return _system(WATER, 0)


@pytest.fixture(scope="module")
def nh2():
    return _system(NH2, 1)


def _core_guess(mf):
    """The core-Hamiltonian density of ``mf``'s molecule (numpy): an
    idempotent start whose occupied factor is unique. The minao guess of
    NH2 at STO-3G cuts a degenerate eigenspace, so its first Fock build
    depends on the eigensolver (ROADMAP.md queue 3 item 4)."""
    ints = {k: v.numpy() for k, v in mf.build_ints().items()}
    s, U = np.linalg.eigh(ints["S"])
    X = U / np.sqrt(s)
    _, C = np.linalg.eigh(X.T @ (ints["T"] + ints["V"]) @ X)
    C = X @ C
    return np.stack([C[:, :n] @ C[:, :n].T
                     for n in (mf.mol.nalpha, mf.mol.nbeta)])


def _k(route, sys_, d, omega=None):
    """K of a density on the port's tensors, plain numpy: DF from B (or
    B_lr at ``omega``), Cholesky from its factor, in core from the
    (attenuated) tensor; K_lr of the Cholesky route from its attenuated
    in-core tensor."""
    if route == "df" or (route == "cd" and omega is None):
        jk = getattr(sys_, route)
        B = (jk.B if omega is None else jk.prepare_lr(omega)[0]).numpy()
        return np.einsum("pik,kl,pjl->ij", B, d, B)
    jk = sys_.cd if route == "cd" else sys_.incore
    view = jk.eri_k if omega is None else jk.prepare_lr(omega)
    return (view.numpy() @ d.reshape(-1)).reshape(d.shape)


def _jmf(sys_, xc):
    """cctpu's RKS/UKS object of a system at grid level 1 with functional
    ``xc``: one per system, so its grid and AO cache compile once; the
    functional is swapped in."""
    if not hasattr(sys_, "jmf"):
        sys_.jmf = (JUKS if sys_.mol.spin else JRKS)(sys_.jmol, xc=xc,
                                                     grid_level=1)
        sys_.jmf._prepare_xc_f64()
    sys_.jmf.func = j_xc.get_functional(xc)
    return sys_.jmf


def cctpu_energy(sys_, xc, route, dm, H):
    """cctpu's energy at a density (numpy) on the port's tensors, with
    cctpu's weights (``RKS/UKS.get_veff``): Tr[D H] with the core
    Hamiltonian ``H`` (the port's, held against cctpu's in
    tests/test_torch_ints.py: cctpu's takes seconds to compile), J, K and
    K_lr contracted from the tensors, E_xc from cctpu's functional on its
    grid (``_exc_total``), its nuclear repulsion and dispersion."""
    spin = dm.ndim == 3
    jmf = _jmf(sys_, xc)
    func = jmf.func
    dms = dm if spin else 0.5 * np.stack([dm, dm])
    Dt = dms.sum(0)
    if route != "incore":
        B = getattr(sys_, route).B.numpy()
        J = np.einsum("pij,pkl,kl->ij", B, B, Dt)
    else:
        J = (sys_.incore.eri.numpy() @ Dt.reshape(-1)).reshape(Dt.shape)
    e = float(np.sum(Dt * H))
    e += 0.5 * np.sum(Dt * J) - 0.5 * func.hyb * sum(
        np.sum(d * _k(route, sys_, d)) for d in dms)
    if func.rsh is not None:
        omega, _, beta = func.rsh
        e -= 0.5 * beta * sum(np.sum(d * _k(route, sys_, d, omega))
                              for d in dms)
    e += float(jmf._exc_total(jnp.asarray(dm)))
    return e + float(sys_.jmol.energy_nuc()) + float(
        j_dispersion_energy(func, sys_.jmol))


# (system, xc, route): the SCF cases held against cctpu
CASES = (("water", "wb97x-d", "df"), ("water", "wb97x-d", "incore"),
         ("water", "wb97x-d", "cd"), ("water", "cam-b3lyp", "df"),
         ("water", "m06-2x", "df"), ("nh2", "wb97x-d", "df"))
FIT = {"df": True, "incore": False, "cd": "cd"}


def _converged(sys_, xc, route):
    """The port's converged SCF on the fixture's builder (NH2 from the
    core-Hamiltonian density)."""
    spin = sys_.mol.spin
    mf = (TUKS if spin else TRKS)(sys_.mol, xc=xc, density_fit=FIT[route],
                                  **CPU)
    mf._jk = getattr(sys_, route)
    mf.kernel(dm0=_core_guess(mf) if spin else None)
    assert mf.converged, (xc, route)
    return mf


def test_registry_and_exc_match_cctpu():
    """Every name, alias and suffix resolves as in cctpu (xctype, hyb, rsh,
    dispersion, name), an unknown name raises ValueError in both; each
    functional's exc on seeded densities (tiny, spin-polarized, zero beta,
    meta-GGA tau near and above von Weizsaecker) within 1e-12 relative of
    cctpu's, with finite autograd derivatives."""
    names = sorted(j_xc._REGISTRY)
    spelled = names + ["SVWN", "M06-2X", "m062x", "wB97X-D", "wb97xd",
                       "CAM-B3LYP", "camb3lyp", "b3lyp-d", "b3lyp-d2",
                       "pbe-d", "m06-2x-d2", " BLYP "]
    for name in spelled:
        fj, ft = j_xc.get_functional(name), t_xc.get_functional(name)
        assert (ft.name, ft.xctype, ft.hyb, ft.rsh, ft.dispersion) == \
            (fj.name, fj.xctype, fj.hyb, fj.rsh, fj.dispersion), name
    for bad in ("b3lyp-x", "pbe1", "wb97x-d2"):
        for mod in (j_xc, t_xc):
            with pytest.raises(ValueError, match="unknown XC functional"):
                mod.get_functional(bad)

    rng = np.random.default_rng(4)
    n = 600
    ra = 10.0 ** rng.uniform(-13, 2, n)
    ra[:5] = 0.0
    rb = ra * rng.uniform(0.0, 1.5, n)
    rb[5:10] = 0.0                                  # zero beta
    rb[10:20] = ra[10:20]                           # closed shell
    saa = 10.0 ** rng.uniform(-26, 2, n) * (ra > 0)
    sbb = 10.0 ** rng.uniform(-26, 2, n) * (rb > 0)
    sab = np.sqrt(saa * sbb) * rng.uniform(-1, 1, n)
    tw = [s / (8 * np.maximum(r, 1e-300)) * rng.uniform(1, 3, n)
          + 10.0 ** rng.uniform(-14, 1, n) * (r > 0)
          for r, s in ((ra, saa), (rb, sbb))]
    args = (ra, rb, saa, sab, sbb, *tw)
    for name in names:
        if name == "hf":
            continue
        ref = np.asarray(j_xc.get_functional(name).exc(
            *map(jnp.asarray, args)))
        leaves = [torch.tensor(a, requires_grad=True) for a in args]
        got = t_xc.get_functional(name).exc(*leaves)
        grads = torch.autograd.grad(got.sum(), leaves, allow_unused=True)
        assert np.abs(got.detach().numpy() - ref).max() \
            <= 1e-12 * np.abs(ref).max(), name
        assert all(g is None or torch.isfinite(g).all() for g in grads), name


def test_dispersion_matches_cctpu():
    """D2 (Fermi damping, the -d/-d2 suffixes) and D2-CHG (wB97X-D)
    energies against cctpu's, and one gradient of each damping form
    against jax.grad of cctpu's (<= 1e-12), phenol and NH2; a functional
    without dispersion gives 0."""
    for atoms in (PHENOL, NH2):
        jmol = JMolecule.from_atoms(atoms, basis="sto-3g")
        names = ("wb97x-d", "b3lyp-d") if atoms == PHENOL \
            else ("m06-2x-d2",)
        mol = TMolecule.from_atoms(atoms, basis="sto-3g")
        for name in names:
            fj, ft = j_xc.get_functional(name), t_xc.get_functional(name)
            e_ref = float(j_dispersion_energy(fj, jmol))
            leaf = torch.tensor(mol.coords, requires_grad=True)
            e = t_disp.dispersion_energy(ft, mol, leaf)
            assert e_ref < 0 and abs(float(e.detach()) - e_ref) <= 1e-12
            assert abs(t_disp.dispersion_energy(ft, mol) - e_ref) <= 1e-12
            if name != "b3lyp-d":     # one gradient per damping form
                g_ref = np.asarray(jax.jit(jax.grad(
                    lambda R: j_dispersion_energy(fj, jmol, R)))(
                        jnp.asarray(jmol.coords)))
                g, = torch.autograd.grad(e, leaf)
                assert np.abs(g.numpy() - g_ref).max() <= 1e-12, name
    assert t_disp.dispersion_energy(t_xc.get_functional("b3lyp"), mol) == 0


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def _quartet(ls, a, omega):
    """cctpu's numpy oracle on a quartet-kernel argument tuple ``a``."""
    return eri_bra_ket_np(ls[0], ls[1], *a[0:2], *a[3:5], a[2], a[5],
                          ls[2], ls[3], *a[6:8], *a[9:11], a[8], a[11],
                          omega=omega)


def _starts(shells):
    return np.cumsum([0] + [2 * t.l + 1 for t in shells])


def _skip(atom, *shells):
    return atom is not None and all(t.atom != atom for t in shells)


def np_3c(basis, aux, R, omega, atom=None):
    """The (P|ab) tensor [naux, nao, nao] from cctpu's numpy oracle on the
    port's shell data at coordinates ``R`` (numpy); with ``atom`` only the
    blocks with a center on it (the others cancel in a difference along
    its coordinates)."""
    sP, sa = _starts(aux.shells), _starts(basis.shells)
    out = np.zeros((aux.nao, basis.nao, basis.nao))
    for p, P in enumerate(aux.shells):
        for i, a in enumerate(basis.shells):
            for j, b in enumerate(basis.shells[:i + 1]):
                if _skip(atom, P, a, b):
                    continue
                blk = eri_3c2e_np(P.l, P.exps, P.coefs, R[P.atom], a.l,
                                  a.exps, a.coefs, R[a.atom], b.l, b.exps,
                                  b.coefs, R[b.atom], omega=omega)
                I, A, B = (slice(s[k], s[k + 1])
                           for s, k in ((sP, p), (sa, i), (sa, j)))
                out[I, A, B] = blk
                out[I, B, A] = blk.transpose(0, 2, 1)
    return out


def np_2c(aux, R, omega, atom=None):
    """The (P|Q) metric [naux, naux] from cctpu's numpy oracle (``atom`` as
    in ``np_3c``)."""
    s = _starts(aux.shells)
    out = np.zeros((aux.nao, aux.nao))
    for p, P in enumerate(aux.shells):
        for q, Q in enumerate(aux.shells[:p + 1]):
            if _skip(atom, P, Q):
                continue
            blk = eri_2c2e_np(P.l, P.exps, P.coefs, R[P.atom], Q.l, Q.exps,
                              Q.coefs, R[Q.atom], omega=omega)
            I, J = slice(s[p], s[p + 1]), slice(s[q], s[q + 1])
            out[I, J], out[J, I] = blk, blk.T
    return out


def np_4c(basis, R, omega, atom=None):
    """The (ij|kl) tensor [nao]*4 from cctpu's numpy oracle: each unique
    quartet once, written to its 8 symmetric places (``atom`` as in
    ``np_3c``)."""
    sh, s = basis.shells, _starts(basis.shells)
    out = np.zeros((basis.nao,) * 4)
    pairs = [(i, j) for i in range(len(sh)) for j in range(i + 1)]
    for x, (i, j) in enumerate(pairs):
        for k, m in pairs[:x + 1]:
            a, b, c, d = sh[i], sh[j], sh[k], sh[m]
            if _skip(atom, a, b, c, d):
                continue
            blk = eri_bra_ket_np(
                a.l, b.l, a.exps, a.coefs, b.exps, b.coefs, R[a.atom],
                R[b.atom], c.l, d.l, c.exps, c.coefs, d.exps, d.coefs,
                R[c.atom], R[d.atom], omega=omega)
            I, J, K, L = (slice(s[u], s[u + 1]) for u in (i, j, k, m))
            for A, B, ab in ((I, J, blk),
                             (J, I, blk.transpose(1, 0, 2, 3))):
                for C, D, abcd in ((K, L, ab),
                                   (L, K, ab.transpose(0, 1, 3, 2))):
                    out[A, B, C, D] = abcd
                    out[C, D, A, B] = abcd.transpose(2, 3, 0, 1)
    return out


def test_attenuated_integrals_and_k_lr_match_cctpu(water, nh2):
    """At omega 0.2, against cctpu's numpy quartet oracle: the attenuated
    kernel on four quartets of each of the 21 classes of water/6-31G* (up
    to d) and of each class of the DF walks (3c2e, metric) of
    water/STO-3G; the whole attenuated in-core tensor of water/STO-3G
    (each unique quartet, <= 1e-12). K_lr of random densities, closed
    shell and per
    spin (the DF route through its occupied factors, water and NH2), on
    the DF, in-core and Cholesky routes, and on builders of the same
    tensors carried in as numpy (``interop``, the way cctpu's reach the
    port), against the same contraction of the tensors. All <= 1e-10
    relative."""
    def check_walk(walk, coords):
        done = set()
        for ls, args, _, _ in walk:
            if ls in done:
                continue
            done.add(ls)
            x = args(coords)
            pick = [0, 1, -2, -1] if len(x[0]) > 1 else [0]
            ref = np.stack([_quartet(ls, [t[q].numpy() for t in x], OMEGA)
                            for q in pick])
            blk = eri_quartet_kernel(ls, *(t[pick] for t in x), omega=OMEGA)
            assert _rel(blk, ref) <= 1e-10, ls
        return done

    mol = TMolecule.from_atoms(WATER, basis="6-31g*")
    coords = torch.as_tensor(mol.coords)
    classes = check_walk(walk_4c(mol.basis_set, coords, screen=False),
                         coords)
    assert len(classes) == 21 and max(map(max, classes)) == 2
    aux, basis, coords = water.df.aux, water.mol.basis_set, water.coords
    assert len(check_walk(walk_3c2e(basis, aux, coords), coords)) == 6
    assert len(check_walk(walk_2c2e(aux, coords), coords)) == 3

    eri = build_eri_incore(basis, coords, omega=OMEGA).numpy()
    assert np.abs(eri - np_4c(basis, water.jmol.coords, OMEGA)).max() \
        <= 1e-12
    ref_in = lambda d: np.einsum("ikjl,...kl->...ij", eri, d)  # noqa: E731

    rng = np.random.default_rng(9)
    for sys_ in (water, nh2):
        n = sys_.mol.nao
        C = rng.standard_normal((2, n, 3)) * 0.4
        dms = np.einsum("sia,sja->sij", C, C)
        cocc = tuple(torch.tensor(c) for c in C)
        B = sys_.jk._B_lr[OMEGA]
        ref = np.einsum("pik,...kl,pjl->...ij", B, dms, B)
        assert _rel(sys_.df.k_lr(torch.tensor(dms), OMEGA, cocc=cocc),
                    ref) <= 1e-10
        assert _rel(sys_.df.k_lr(torch.tensor(dms.sum(0)), OMEGA),
                    ref.sum(0)) <= 1e-10
        carried = dfjk_from_numpy(
            _shells(sys_.jk.aux), sys_.jmol.coords, sys_.jk._Bh,
            sys_.jk._Linv, device="cpu",
            lr={OMEGA: (B, sys_.jk._Linv_lr[OMEGA])})
        assert _rel(carried.k_lr(torch.tensor(dms), OMEGA, cocc=cocc),
                    ref) <= 1e-10
        if sys_ is water:
            carried = eri_from_numpy(water.incore.eri.numpy().reshape(
                (n,) * 4), device="cpu", lr={OMEGA: eri})
            for jk in (water.incore, water.cd, carried):
                assert _rel(jk.k_lr(torch.tensor(dms), OMEGA),
                            ref_in(dms)) <= 1e-10


def test_rsh_scf_energies_match_cctpu(water, nh2):
    """Converged energies (conv_tol 1e-12) against cctpu's energy at the
    port's converged density on the same tensors (<= 1e-10 Ha; at a
    stationary point the energy is second order in the density): water
    wB97X-D DF, in core and with Cholesky J/K, CAM-B3LYP DF (short- and
    long-range exchange), M06-2X DF (meta-GGA), NH2 UKS wB97X-D DF."""
    for name, xc, route in CASES:
        sys_ = water if name == "water" else nh2
        mf = _converged(sys_, xc, route)
        ints = mf.build_ints()
        e_ref = cctpu_energy(sys_, xc, route, mf.dm.numpy(),
                             (ints["T"] + ints["V"]).numpy())
        assert abs(mf.e_tot - e_ref) <= 1e-10, (name, xc, route)


def _random_state(mf, seed):
    """Put a state made from a numpy seed on ``mf``: orbitals orthonormal
    in the overlap metric, the first ones occupied (so the occupied
    factors reproduce the density), sorted random orbital energies."""
    S = mf.build_ints()["S"].numpy()
    n = S.shape[0]
    rng = np.random.default_rng(seed)
    s, U = np.linalg.eigh(S)
    X = U / np.sqrt(s)
    nocc = (mf.mol.nalpha, mf.mol.nbeta) if mf.mol.spin else \
        (mf.mol.nelectron // 2,)
    C = np.stack([X @ np.linalg.qr(rng.standard_normal((n, n)))[0]
                  for _ in nocc])
    occ = np.stack([(np.arange(n) < k) * (1.0 if mf.mol.spin else 2.0)
                    for k in nocc])
    dm = np.einsum("sia,sa,sja->sij", C, occ, C)
    e = np.sort(rng.standard_normal((len(nocc), n)), axis=1)
    if not mf.mol.spin:
        dm, C, occ, e = dm[0], C[0], occ[0], e[0]
    return set_scf_state(mf, dm, C, occ, e)


def _fd(f, x0, comps, h=1e-4):
    """Central differences of ``f(R, atom)`` at ``x0`` [natm, 3] (numpy)
    along ``comps`` [(atom, axis)]."""
    out = []
    for ia, ax in comps:
        vals = []
        for k in (-1, 1):
            x = x0.copy()
            x[ia, ax] += k * h
            vals.append(float(f(x, ia)))
        out.append((vals[1] - vals[0]) / (2 * h))
    return np.array(out)


def test_rsh_gradient_terms(water, nh2):
    """The gradient terms this slice adds, held against cctpu on states
    made from a numpy seed (<= 1e-8 Ha/bohr unless named): the DF
    long-range 3c and 2c terms and the direct long-range term (in core,
    Cholesky) against central differences of the same weights contracted
    with cctpu's numpy oracle tensors at omega (water); the long-range W/Z
    on B_lr (exchange part alone) equal to W/Z at beta less W/Z at 0 (the
    assembly tests/test_torch_grad.py holds against cctpu's; <= 1e-12
    relative; closed shell and per spin); the M06-2X XC term (meta-GGA:
    tau through the grid derivatives) against jax.grad of cctpu's
    ``exc_of_coords``; and ``gradient`` less ``gradient`` without range
    separation and dispersion equal to those terms plus the D2 gradient
    (DF water RKS and NH2 UKS, in-core water; <= 1e-10)."""
    func = t_xc.get_functional("wb97x-d")
    omega, _, beta = func.rsh
    comps = [(0, 2), (1, 1)]
    xyz = water.mol.coords
    basis, aux = water.mol.basis_set, water.df.aux
    for sys_, seed in ((water, 3), (nh2, 4)):
        mf = (TUKS if sys_.mol.spin else TRKS)(
            sys_.mol, xc="wb97x-d", density_fit=True, **CPU)
        mf._jk = sys_.df
        _random_state(mf, seed)
        dm = mf.dm.numpy()
        Dt = torch.tensor(dm.sum(0) if dm.ndim == 3 else dm)
        facs = tdf_grad.occupied_factors(mf)
        B, Linv = sys_.df.prepare_lr(omega)
        Ws, Zs = tdf_grad._wz(B, Linv, Dt, facs, beta, with_j=False)
        Wb, Zb = tdf_grad._wz(B, Linv, Dt, facs, beta)
        W0, Z0 = tdf_grad._wz(B, Linv, Dt, facs, 0.0)
        assert _rel(Ws, Wb - W0) <= 1e-12 and _rel(Zs, Zb - Z0) <= 1e-12
        g3 = tdf_grad._grad_3c(sys_.mol.basis_set, sys_.df.aux,
                               sys_.coords, Ws, omega).numpy()
        g2 = tdf_grad._grad_2c(sys_.df.aux, sys_.coords, Zs,
                               omega).numpy()
        if sys_ is water:
            fd3 = _fd(lambda R, a: 0.5 * np.sum(Ws.numpy() * np_3c(
                basis, aux, R, omega, a)), xyz, comps)
            fd2 = _fd(lambda R, a: 0.5 * np.sum(Zs.numpy() * np_2c(
                aux, R, omega, a)), xyz, comps)
            assert np.abs([g3[c] for c in comps] - fd3).max() <= 1e-8
            assert np.abs([g2[c] for c in comps] - fd2).max() <= 1e-8
        leaf = sys_.coords.clone().requires_grad_(True)
        g_disp, = torch.autograd.grad(
            t_disp.dispersion_energy(func, sys_.mol, leaf), leaf)
        timer = PhaseTimer()
        g = gradient(mf, timer)
        assert {"3c_lr", "2c_lr", "disp"} <= set(timer.phases)
        mf.func = dataclasses.replace(func, rsh=None, dispersion=None)
        g_rest = gradient(mf)
        assert np.abs((g - g_rest).numpy() - g3 - g2
                      - g_disp.numpy()).max() <= 1e-10

    # the direct long-range term: -beta/4 Tr[D K_lr(D)] differentiated
    mf = TRKS(water.mol, xc="wb97x-d", **CPU)
    mf._jk = water.incore
    _random_state(mf, 5)
    D = mf.dm.numpy()
    timer = PhaseTimer()
    g = gradient(mf, timer)
    assert "2e_lr" in timer.phases
    mf.func = dataclasses.replace(func, rsh=None)
    g_lr = (g - gradient(mf)).numpy()
    fd = _fd(lambda R, a: -0.25 * beta * np.einsum(
        "ij,ikjl,kl->", D, np_4c(basis, R, omega, a), D), xyz, comps)
    assert np.abs(g_lr).max() > 1e-3
    assert np.abs([g_lr[c] for c in comps] - fd).max() <= 1e-8

    mf = TRKS(water.mol, xc="m06-2x", density_fit=True, **CPU)
    _random_state(mf, 6)
    got = mf.exc_of_coords(mf.coords, mf.dm)[1].numpy()
    jmf = _jmf(water, "m06-2x")
    ref = np.asarray(jax.jit(jax.grad(lambda R: jmf.exc_of_coords(
        R, jnp.asarray(mf.dm.numpy()))))(jnp.asarray(xyz)))
    assert np.abs(got - ref).max() <= 1e-8


def test_cli_energy_wb97xd(tmp_path):
    """``energy --method wb97x-d --density-fit --device cpu`` on water:
    converged, its energy in the wB97X-D/STO-3G range."""
    rc = cli.main(["energy", "--smiles", "O", "--method", "wb97x-d",
                   "--basis", "sto-3g", "--grid-level", "1",
                   "--density-fit", "--device", "cpu", "--output-dir",
                   str(tmp_path)])
    assert rc == 0
    short, = [p for p in tmp_path.iterdir()
              if p.name.endswith("_short_report.txt")]
    text = short.read_text()
    assert "converged: True" in text
    e = float(text.split("Total energy:")[1].split()[0])
    assert -75.25 < e < -75.05             # wB97X-D/STO-3G water
