"""The port's geometry optimizer and FD frequencies on the CPU, held against
cctpu on identical inputs.

Internal coordinates: the index lists equal cctpu's (water, phenol at
bench.py's geometry, and a bent triatomic straightened to the arccos
clip), q and B within 1e-12 of cctpu's (B times 1/sin(angle) at an angle
0.1 degree short of linear, where arccos' derivative amplifies rounding). The optimizer's host helpers
within 1e-13 on inputs from a numpy seed. Water HF/STO-3G optimized from
cctpu's tests/test_geomopt.py start by both packages: the same steps,
energies within 1e-9 Ha, final coordinates within 1e-6 bohr. The FD
Hessian with dipole derivatives of water HF/STO-3G: H and dmu/dR within
1e-7 of cctpu's, ``hessian_auto``'s analytic one within 5e-5 of it, then
harmonic analysis and thermochemistry of one H through both packages
within 1e-10 relative. Then the ``opt`` and ``opt-freq`` CLIs with
``--device cpu`` (the analytic Hessian route).
"""

import numpy as np

from cctpu.core.molecule import Molecule as JMolecule
from cctpu.geomopt import internal as jint
from cctpu.geomopt import optimizer as jopt
from cctpu.hessian import frequencies as jfreq
from cctpu.hessian import thermo as jthermo
from cctpu.scf.hf import RHF as JRHF
from cctpu_torch.core.molecule import Molecule as TMolecule
from cctpu_torch.geomopt import internal as tint
from cctpu_torch.geomopt import optimizer as topt
from cctpu_torch.hessian import frequencies as tfreq
from cctpu_torch.hessian import thermo as tthermo
from cctpu_torch.scf.hf import RHF as TRHF
from cctpu_torch.utils.measure import PHENOL, WATER, WATER_START
from cctpu_torch.workflows import cli
from test_torch_threads import one_torch_thread  # noqa: F401


def _mols(atoms):
    return (JMolecule.from_atoms(atoms, basis="sto-3g"),
            TMolecule.from_atoms(atoms, basis="sto-3g"))


def test_internals_match_cctpu():
    """Index lists equal, q and B within 1e-12, also at a clipped angle."""
    bent = "O 0 0 0; H 0 0 0.96; H 0 0.93 -0.24"
    for atoms in (WATER, PHENOL, bent):
        jm, tm = _mols(atoms)
        jic = jint.InternalCoords(jm.charges, jm.coords)
        tic = tint.InternalCoords(tm.charges, tm.coords)
        assert (tic.bonds, tic.angles, tic.dihedrals) == \
            (jic.bonds, jic.angles, jic.dihedrals), atoms
        assert tic.nq == jic.nq > 0
        rng = np.random.default_rng(tic.nq)
        # (geometry, the conditioning of B's angle rows: 1 / sin(angle))
        geoms = [(tm.coords, 1.0), (tm.coords + 0.05 * rng.standard_normal(
            tm.coords.shape), 1.0)]
        if atoms == bent:
            # H-O-H straightened: the cosine is -1, past the clip (the B
            # row of the angle is 0 in both), and one 0.1 degree short,
            # where d(arccos c)/dc = -1/sin(angle) multiplies the
            # rounding of c in either package by 573
            lin = np.array([[0, 0, 0], [0, 0, 1.8], [0, 0, -1.8]], float)
            near = lin.copy()
            near[2, 1] = 1.8 * np.tan(np.radians(0.1))
            geoms += [(lin, 1.0), (near, 1 / np.sin(np.radians(0.1)))]
        for x, cond in geoms:
            q_t, q_j = tic.q(x), np.asarray(jic.q(x))
            B_t, B_j = tic.B(x), np.asarray(jic.B(x))
            assert np.abs(q_t - q_j).max() <= 1e-12
            assert np.abs(B_t - B_j).max() <= 1e-12 * cond * max(
                1.0, np.abs(B_j).max())
        if atoms == bent:
            assert np.all(tic.B(lin)[2] == 0.0)


def test_optimizer_helpers_match_cctpu():
    """_rfo_step (trust cap off and on), _project_tr and diff."""
    rng = np.random.default_rng(7)
    for n, trust in ((6, 10.0), (6, 0.05), (9, 10.0), (9, 0.02)):
        A = rng.standard_normal((n, n))
        H = A @ A.T + 0.1 * np.eye(n)
        g = rng.standard_normal(n)
        t, j = topt._rfo_step(H, g, trust), jopt._rfo_step(H, g, trust)
        assert np.abs(t - j).max() <= 1e-13
        assert np.linalg.norm(t) <= trust + 1e-13
    for natm in (2, 4, 7):
        coords = rng.standard_normal((natm, 3))
        gx = rng.standard_normal(3 * natm)
        assert np.abs(topt._project_tr(gx, coords)
                      - jopt._project_tr(gx, coords)).max() <= 1e-13
    jm, tm = _mols(PHENOL)
    jic = jint.InternalCoords(jm.charges, jm.coords)
    tic = tint.InternalCoords(tm.charges, tm.coords)
    q0 = tic.q(tm.coords)
    q1 = q0 + rng.uniform(-7.0, 7.0, q0.shape)
    assert np.abs(tic.diff(q1.copy(), q0)
                  - jic.diff(q1.copy(), q0)).max() <= 1e-13


def test_water_rhf_optimize_matches_cctpu():
    jm, tm = _mols(WATER_START)
    jres = jopt.optimize(lambda m: JRHF(m), jm, maxsteps=25)
    tres = topt.optimize(lambda m: TRHF(m, device="cpu"), tm, maxsteps=25)
    assert tres.converged and jres.converged
    assert tres.nsteps == jres.nsteps
    assert np.abs(np.subtract(tres.energies, jres.energies)).max() <= 1e-9
    assert np.abs(tres.mol.coords - jres.mol.coords).max() <= 1e-6
    assert tres.cycles and len(tres.cycles) == tres.nsteps


def test_hessian_fd_harmonic_thermo_match_cctpu():
    jm, tm = _mols(WATER)
    jmf, tmf = JRHF(jm), TRHF(tm, device="cpu")
    jmf.kernel()
    tmf.kernel()
    Hj, dj = jfreq.hessian_fd(lambda m: JRHF(m), jm, dm0=jmf.dm)
    Ht, dt = tfreq.hessian_fd(lambda m: TRHF(m, device="cpu"), tm,
                              dm0=tmf.make_rdm1())
    assert np.abs(Ht - Hj).max() <= 1e-7
    assert np.abs(dt - dj).max() <= 1e-7
    # hessian_auto takes the analytic (CPHF) route here: within cctpu's
    # own bound of its analytic Hessian against FD
    # (tests/test_analytic_hessian.py)
    log = []
    Ha, da = tfreq.hessian_auto(tmf, lambda m: TRHF(m, device="cpu"), tm,
                                dm0=tmf.make_rdm1(), log=log.append)
    assert log == ["  Hessian: analytic (AD-native CPHF)"]
    assert np.abs(Ha - Ht).max() <= 5e-5
    ht = tfreq.harmonic_analysis(tm, Ht, dt)
    hj = jfreq.harmonic_analysis(jm, Ht, dt)
    assert ht.n_imaginary == hj.n_imaginary == 0
    for a, b in ((ht.freq_wavenumber, hj.freq_wavenumber),
                 (ht.ir_intensity, hj.ir_intensity),
                 (ht.freq_au, hj.freq_au)):
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max()
    assert np.abs(np.abs(ht.modes) - np.abs(hj.modes)).max() <= 1e-10 * \
        np.abs(hj.modes).max()
    tt = tthermo.thermo(tm, ht.freq_au, tmf.e_tot)
    tj = jthermo.thermo(jm, ht.freq_au, tmf.e_tot)
    assert tt.keys() == tj.keys()
    for k in tt:
        assert tt[k][1] == tj[k][1]
        assert abs(tt[k][0] - tj[k][0]) <= 1e-10 * max(abs(tj[k][0]), 1.0)


def test_cli_opt_and_opt_freq(tmp_path, capsys):
    common = ["--method", "hf", "--basis", "sto-3g", "--device", "cpu"]
    assert cli.main(["opt", "--smiles", "O", *common,
                     "--output-dir", str(tmp_path / "opt")]) == 0
    assert cli.main(["opt-freq", "--smiles", "[H][H]", *common,
                     "--output-dir", str(tmp_path / "optfreq")]) == 0
    log = capsys.readouterr().out
    assert log.count("Hessian: analytic (AD-native CPHF)") == 2
    for sub, suffixes in (("opt", ("_optimized.xyz", "_short_report.txt",
                                   "_log_report.txt", "_config.json")),
                          ("optfreq", ("_optimized.xyz", "_ir.csv",
                                       "_short_report.txt",
                                       "_log_report.txt", "_config.json"))):
        names = [p.name for p in (tmp_path / sub).iterdir()]
        for s in suffixes:
            assert sum(n.endswith(s) for n in names) == 1, (sub, s, names)
    opt = next((tmp_path / "opt").glob("*_short_report.txt")).read_text()
    assert "optimization converged" in opt
    assert "no imaginary frequencies" in opt
    csv = next((tmp_path / "optfreq").glob("*_ir.csv")).read_text()
    rows = csv.strip().splitlines()
    # H2 is linear (5 rigid modes): one stretch, HF/STO-3G ~5.4e3 cm^-1,
    # although SMILES embedding leaves the bond off the axes
    assert len(rows) == 2 and 5000 < float(rows[1].split(",")[0]) < 5800
