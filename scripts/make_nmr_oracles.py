"""cctpu's CPU-f64 NMR results: the oracles of tests/test_torch_nmr.py
(the ``t_`` cases) and of chip_smoke.py's phases 14a-14d.

Every SCF is cctpu's own on the CPU in f64 (conv_tol 1e-12, orbital
gradient <= 1e-9, ``SCF_OPTS``), then ``cctpu.response.giao_nmr.GIAONMR``
(or ``cctpu.response.nmr.NMR``, the common gauge origin at each nucleus).
Shielding tensors are in ppm, one row of 9 per atom. The cases:

  t_water_rhf     water RHF/STO-3G in core: GIAO and CGO tensors;
  t_water_df_rhf  water DF-RHF/6-31G: GIAO;
  t_water_<xc>    water B3LYP, CAM-B3LYP, M06-2X/STO-3G in core, grid
                  level 1: GIAO;
  t_hf_uhf        hydrogen fluoride UHF/STO-3G from the RHF density halved
                  (a symmetric start): GIAO, with the RHF one beside it;
  t_nh2_ub3lyp    the NH2 radical UB3LYP/STO-3G, grid level 1: GIAO;
  t_he            He/6-31G: GIAO and CGO;
  t_h2_cgo        H2/6-31G** (cctpu's test_nmr_h2_isotropic): CGO with
                  the gauge origin at 0;
  t_skeletons     ``GIAONMR._range_skeleton`` at a seeded symmetric
                  density: water/6-31G on its autoaux basis (the DF
                  branch) and water/STO-3G in core, each at the full range
                  and at omega 0.33; the seeded projections of mJ and Kg;
  t_ints_<part>   seeded projections of water/6-31G*'s integrals, in five
                  processes (one ran out of XLA's memory maps): ``mag`` the
                  magnetic ones (nucleus 0, gauge origin (0.1, -0.2,
                  0.3)), ``mom`` the moment ones, ``meri`` and ``meri_lr``
                  the moment ERIs (full range, omega 0.33), ``m3c`` the
                  moment 3c2e on the autoaux basis;
  card_phenol_b3lyp  phenol DF-B3LYP/6-31G*, grid level 2, conv_tol 1e-12,
                  orbital gradient <= 1e-8 (chip_smoke.py phase 14a): GIAO
                  (its process ran out of XLA's memory maps after ~22 min
                  on an 8-core CPU, so 14a holds phenol by translation
                  invariance);
  card_water_<xc> water DF-B3LYP, DF-CAM-B3LYP, DF-M06-2X/6-31G*, grid
                  level 2 (phase 14b): GIAO; CAM-B3LYP's SCF and the 2e
                  skeleton of each range in child processes
                  (``card_split``: one and two processes ran out of XLA's
                  memory maps);
  card_nh2_ub3lyp NH2 DF-UB3LYP/6-31G*, grid level 2 (phase 14b): GIAO;
  cli_methane     cctpu's ``nmr --smiles C --method hf --basis sto-3g``
                  (the geometry optimization, then the TMS reference
                  computed in a fresh HOME, so no memo is read) on the
                  port's embedded coordinates: sigma_iso, the reference,
                  delta, the optimization's energies and final coordinates.

A seeded projection of an array X is sum(X * R_k) for R_k standard normal
of X's shape from ``np.random.default_rng(k)``, k = 0, 1, 2
(``project``).

Prints each case's entry, a Python literal, for the test file's
``ORACLES`` (the ``t_`` cases) or chip_smoke.py's ``NMR_ORACLES``.

Usage:  python scripts/make_nmr_oracles.py <case>
        Run one case per process: XLA's CPU compiler has crashed processes
        that compiled several cases (ROADMAP.md queue 3 item 2).
"""

import contextlib
import os
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests"),
                os.path.join(_ROOT, "scripts")]

import conftest  # noqa: E402,F401  (the CPU platform, x64, shape knobs)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from cctpu.core.molecule import Molecule  # noqa: E402
from cctpu.response.giao_nmr import GIAONMR  # noqa: E402
from cctpu.response.nmr import NMR  # noqa: E402
from cctpu_torch.utils.measure import NH2, PHENOL, WATER  # noqa: E402
from make_opt_oracles import _entry  # noqa: E402

SCF_OPTS = dict(conv_tol=1e-12, conv_tol_grad=1e-9, max_cycle=200)
HF_MOL = "H 0 0 0; F 0 0 0.92"
# cctpu's tests/test_pcm_nmr.py::test_nmr_h2_isotropic (bohr)
H2_BOHR = [[0.0, 0.0, -0.7], [0.0, 0.0, 0.7]]
# the gauge origin and nucleus of the t_ints projections
ORIGIN = (0.1, -0.2, 0.3)
OMEGA = 0.33


def project(X, n: int = 3) -> list:
    """The seeded projections sum(X * R_k), k < n."""
    X = np.asarray(X)
    return [float(np.sum(X * np.random.default_rng(k).standard_normal(
        X.shape))) for k in range(n)]


def seeded_density(nao: int) -> np.ndarray:
    """A symmetric [nao, nao] density from seed 7."""
    A = np.random.default_rng(7).standard_normal((nao, nao))
    return 0.1 * (A + A.T)


def scf(atoms, basis, cls, spin=0, dm0=None, **opts):
    """cctpu's SCF of ``atoms`` (a string in Angstrom, or a Molecule)."""
    from cctpu.dft import rks
    from cctpu.scf import hf
    klass = {"RHF": hf.RHF, "UHF": hf.UHF, "RKS": rks.RKS,
             "UKS": rks.UKS}[cls]
    mol = (atoms if isinstance(atoms, Molecule) else Molecule.from_atoms(
        atoms, spin=spin, basis=basis)).build()
    mf = klass(mol, **opts, **SCF_OPTS)
    e = float(mf.kernel() if dm0 is None else mf.kernel(dm0=dm0))
    assert mf.converged
    return mf, e


def giao(mf) -> np.ndarray:
    return np.asarray(GIAONMR(mf).kernel()).reshape(-1, 9)


def cgo(mf, origin="nucleus") -> np.ndarray:
    return np.asarray(NMR(mf, gauge_origin=origin).kernel()).reshape(-1, 9)


def shielding_case(atoms, basis, cls, spin=0, **opts):
    mf, e = scf(atoms, basis, cls, spin=spin, **opts)
    return {"E": e, "giao": giao(mf)}


def water_rhf():
    mf, e = scf(WATER, "sto-3g", "RHF")
    return {"E": e, "giao": giao(mf), "cgo": cgo(mf)}


def hf_uhf():
    mf_r, e = scf(HF_MOL, "sto-3g", "RHF")
    dm = np.asarray(mf_r.dm)
    mf_u, e_u = scf(HF_MOL, "sto-3g", "UHF",
                    dm0=np.stack([0.5 * dm, 0.5 * dm]))
    return {"E": e_u, "giao": giao(mf_u), "giao_rhf": giao(mf_r)}


def he():
    mf, e = scf("He 0 0 0", "6-31g", "RHF")
    return {"E": e, "giao": giao(mf), "cgo": cgo(mf)}


def h2_cgo():
    mol = Molecule(symbols=["H", "H"], coords=np.array(H2_BOHR),
                   basis="6-31g**")
    mf, e = scf(mol, "6-31g**", "RHF")
    return {"E": e, "cgo": cgo(mf, origin=np.zeros(3))}


def skeletons():
    from cctpu.ints.df import autoaux
    from cctpu.ints.giao import ao_centers
    from cctpu.scf.hf import RHF
    out = {}
    for tag, basis, df in (("df", "6-31g", True), ("incore", "sto-3g",
                                                    False)):
        mol = Molecule.from_atoms(WATER, basis=basis).build()
        nmr = GIAONMR(RHF(mol))
        D = seeded_density(mol.nao)
        Rc = ao_centers(mol.basis_set, mol.coords)
        aux = autoaux(mol.basis_set) if df else None
        for om_tag, om in (("", None), ("_lr", OMEGA)):
            mJ, Kg = nmr._range_skeleton(D, Rc, aux, om, True, True)
            out[f"{tag}{om_tag}_mJ"] = project(mJ)
            out[f"{tag}{om_tag}_Kg"] = project(Kg)
    return out


def ints(part):
    """One part of water/6-31G*'s integrals (a process compiling all of
    them ran out of XLA's memory maps)."""
    from cctpu.ints import giao as g
    from cctpu.ints import magnetic as m
    from cctpu.ints.df import autoaux
    mol = Molecule.from_atoms(WATER, basis="6-31g*").build()
    basis = mol.basis_set
    coords = jnp.asarray(mol.coords)
    R = coords[0]
    G = jnp.asarray(ORIGIN)
    parts = {
        "mag": lambda: {
            "angmom": m.angmom_integrals(basis, coords, G),
            "w": m.w_integrals(basis, coords, R),
            "m": m.m_integrals(basis, coords, R, G),
            "h01": m.h01_integrals(basis, coords, R),
            "dia": m.dia_integrals(basis, coords, R, G)},
        "mom": lambda: dict(zip(("mS", "mT"),
                                g.moment_st_integrals(basis, coords)), **{
            "mV": g.moment_v_integrals(basis, coords,
                                       jnp.asarray(mol.charges)),
            "nabla": g.nabla_integrals(basis, coords),
            "mw": g.moment_w_integrals(basis, coords, R),
            "mh01": g.mh01_integrals(basis, coords, R)}),
        "meri": lambda: {"meri": g.build_moment_eri_incore(basis, coords)},
        "meri_lr": lambda: {"meri_lr": g.build_moment_eri_incore(
            basis, coords, omega=OMEGA)},
        "m3c": lambda: {"m3c": g.build_moment_3c2e_eager(
            basis, autoaux(basis), coords)},
    }
    return {k: project(v) for k, v in parts[part]().items()}


def card_case(atoms, cls, spin=0, **opts):
    return shielding_case(atoms, "6-31g*", cls, spin=spin, density_fit=True,
                          grid_level=2, **opts)


def _water_rks(xc, path=None):
    """cctpu's water DF-RKS/6-31G* (grid level 2) with ``xc``, its
    orbitals read from ``path`` when given (no SCF run)."""
    from cctpu.dft.rks import RKS
    mol = Molecule.from_atoms(WATER, basis="6-31g*").build()
    mf = RKS(mol, xc=xc, density_fit=True, grid_level=2, **SCF_OPTS)
    if path is None:
        mf.kernel()
        assert mf.converged
        return mf
    z = np.load(path)
    mf.get_jk_builder()
    for k in ("dm", "mo_coeff", "mo_energy", "mo_occ"):
        setattr(mf, k, jnp.asarray(z[k]))
    mf.e_tot, mf.converged = float(z["e_tot"]), True
    return mf


def card_split(xc):
    """A card case in four processes (one, then two, compiling the SCF and
    the GIAO ran out of XLA's memory maps): children run the SCF (saving
    its orbitals) and the 2e skeleton of each interaction range; this
    process rebuilds the SCF object on the orbitals (its DF builder, its
    grid) and runs the rest of the GIAO with the saved skeletons."""
    import subprocess
    with tempfile.TemporaryDirectory() as tmp:
        paths = {p: os.path.join(tmp, p + ".npz")
                 for p in ("_scf", "_full", "_lr")}
        for part in paths:
            subprocess.run([sys.executable, os.path.abspath(__file__), part,
                            xc, paths["_scf"], paths[part]], check=True)
        mf = _water_rks(xc, paths["_scf"])
        nmr = GIAONMR(mf)
        full, lr = np.load(paths["_full"]), np.load(paths["_lr"])
        nmr._skeleton_2e = lambda D, Rc: (full["mJ"], full["Kg"],
                                          mf.func.hyb, lr["Kg"],
                                          mf.func.rsh[2])
        return {"E": mf.e_tot,
                "giao": np.asarray(nmr.kernel()).reshape(-1, 9)}


def save_part(part, xc, scf_path, path):
    """A child of ``card_split``: the SCF, or one range's 2e skeleton
    (``GIAONMR._range_skeleton``, as ``_skeleton_2e`` calls it) at its
    density on the DF builder's autoaux basis."""
    from cctpu.dft.xc import get_functional
    from cctpu.ints.df import autoaux
    from cctpu.ints.giao import ao_centers
    from cctpu.scf.hf import RHF
    if part == "_scf":
        mf = _water_rks(xc)
        np.savez(path, e_tot=float(mf.e_tot), **{
            k: np.asarray(getattr(mf, k)) for k in ("dm", "mo_coeff",
                                                     "mo_energy", "mo_occ")})
        return
    mol = Molecule.from_atoms(WATER, basis="6-31g*").build()
    D = np.load(scf_path)["dm"]
    Rc = ao_centers(mol.basis_set, mol.coords)
    omega = None if part == "_full" else get_functional(xc).rsh[0]
    mJ, Kg = GIAONMR(RHF(mol))._range_skeleton(
        D, Rc, autoaux(mol.basis_set), omega, omega is None, True)
    np.savez(path, Kg=Kg, **({} if mJ is None else {"mJ": mJ}))


def card_phenol():
    from cctpu.dft.rks import RKS
    mol = Molecule.from_atoms(PHENOL, basis="6-31g*").build()
    mf = RKS(mol, xc="b3lyp", density_fit=True, grid_level=2,
             conv_tol=1e-12, conv_tol_grad=1e-8, max_cycle=100)
    e = float(mf.kernel())
    assert mf.converged
    t0 = time.time()
    sig = giao(mf)
    return {"E": e, "giao": sig, "giao_s": time.time() - t0}


def cli_methane():
    """cctpu's ``nmr`` main on the port's embedded coordinates in a fresh
    HOME (its TMS memo lives under ~/.cache), with the optimization and
    the reference recorded."""
    import cctpu.workflows.calculate_nmr as cn
    import cctpu.workflows.common as cc
    from make_workflow_oracles import _port_smiles_to_molecule
    cc.smiles_to_molecule = _port_smiles_to_molecule
    seen = {}
    optimize, tms = cn.optimize, cn.tms_reference

    def rec_optimize(*a, **k):
        seen["opt"] = optimize(*a, **k)
        return seen["opt"]

    def rec_tms(*a, **k):
        seen["ref"] = tms(*a, **k)
        return seen["ref"]

    cn.optimize, cn.tms_reference = rec_optimize, rec_tms
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(sys.stderr):
        os.environ["HOME"] = tmp
        iso = np.asarray(cn.main(["--smiles", "C", "--method", "hf",
                                  "--basis", "sto-3g", "--output-dir",
                                  tmp]))
    opt, ref = seen["opt"], seen["ref"]
    syms = list(opt.mol.element_symbols)
    return {"sigma": iso, "ref_H": ref["H"], "ref_C": ref["C"],
            "delta": [ref[s] - x for s, x in zip(syms, iso)],
            "opt_energies": [float(x) for x in opt.energies],
            "opt_coords": np.asarray(opt.mol.coords)}


CASES = {
    "t_water_rhf": water_rhf,
    "t_water_df_rhf": lambda: shielding_case(WATER, "6-31g", "RHF",
                                             density_fit=True),
    **{f"t_water_{tag}": (lambda xc=xc: shielding_case(
        WATER, "sto-3g", "RKS", xc=xc, grid_level=1))
       for tag, xc in (("b3lyp", "b3lyp"), ("camb3lyp", "cam-b3lyp"),
                       ("m062x", "m06-2x"))},
    "t_hf_uhf": hf_uhf,
    "t_nh2_ub3lyp": lambda: shielding_case(NH2, "sto-3g", "UKS", spin=1,
                                           xc="b3lyp", grid_level=1),
    "t_he": he,
    "t_h2_cgo": h2_cgo,
    "t_skeletons": skeletons,
    **{f"t_ints_{p}": (lambda p=p: ints(p))
       for p in ("mag", "mom", "meri", "meri_lr", "m3c")},
    "card_phenol_b3lyp": card_phenol,
    **{f"card_water_{tag}": (lambda xc=xc: card_case(WATER, "RKS", xc=xc))
       for tag, xc in (("b3lyp", "b3lyp"), ("m062x", "m06-2x"))},
    "card_water_camb3lyp": lambda: card_split("cam-b3lyp"),
    "card_nh2_ub3lyp": lambda: card_case(NH2, "UKS", spin=1, xc="b3lyp"),
    "cli_methane": cli_methane,
}


def main(argv):
    if argv[:1] in (["_scf"], ["_full"], ["_lr"]):
        return save_part(*argv)
    for name in argv:
        if name not in CASES:
            raise SystemExit(f"unknown case {name!r}")
        t0 = time.time()
        print(_entry(name, CASES[name]()), flush=True)
        print(f"# {name}: {time.time() - t0:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    main(sys.argv[1:])
