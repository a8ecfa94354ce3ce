"""The port's bde, reaction, ir and interaction workflows, MP2 and the
SMILES embedding's random start on the CPU, held against cctpu.

1. The numpy threefry draw against ``jax.random.normal`` and the port's
   embedded coordinates against cctpu's.
2. ``MP2`` against cctpu's ``MP2`` on the port's converged SCFs (cctpu's
   gets a stand-in object with the port's orbitals and tensors as numpy
   arrays: no cctpu SCF); the ``energy --method mp2`` CLI.
3. The workflows' host helpers against cctpu's on identical inputs.
4. The four CLIs with ``--device cpu`` against cctpu's workflow results,
   made by ``python scripts/make_workflow_oracles.py <case>`` (the ``t_``
   cases, HF/STO-3G); without a CPU request and without a card, each
   raises.
"""

import numpy as np
import pytest
import torch

import jax
from cctpu.core.molecule import Molecule as JMolecule
from cctpu.io.embed3d import smiles_to_xyz as j_smiles_to_xyz
from cctpu.io.smiles import parse_smiles as j_parse
from cctpu.mp.mp2 import MP2 as JMP2
from cctpu.workflows import calculate_bde as jbde
from cctpu.workflows import calculate_interaction as jint
from cctpu.workflows import calculate_ir_spectrum as jir
from cctpu.workflows import calculate_reaction_energy as jrx
from cctpu_torch.core.molecule import Molecule as TMolecule
from cctpu_torch.io import jax_prng
from cctpu_torch.io.embed3d import smiles_to_xyz as t_smiles_to_xyz
from cctpu_torch.io.smiles import parse_smiles as t_parse
from cctpu_torch.mp.mp2 import MP2
from cctpu_torch.scf.hf import RHF, UHF
from cctpu_torch.utils.measure import NH2, WATER
from cctpu_torch.workflows import calculate_bde as tbde
from cctpu_torch.workflows import calculate_energy, cli
from cctpu_torch.workflows import calculate_interaction as tint
from cctpu_torch.workflows import calculate_ir_spectrum as tir
from cctpu_torch.workflows import calculate_reaction_energy as trx
from test_torch_threads import one_torch_thread  # noqa: F401

HARTREE2KCAL = 627.5094740631

# cctpu's workflow results on the CPU in f64, at the port's embedded
# coordinates, on cctpu's serial paths (HF/STO-3G), as printed by
#   python scripts/make_workflow_oracles.py t_bde_ethane
#       (cctpu bde_sweep("CC", "hf", "sto-3g", "mmff", limit=1))
#   python scripts/make_workflow_oracles.py t_interaction_water
#       (cctpu interaction_energy("O", "O", 3.0, "sto-3g", "hf"))
#   python scripts/make_workflow_oracles.py t_reaction_h3o
#       (cctpu species_thermo of O, [H+], [OH3+], skip_freq; dX in Ha)
ORACLES = {
    "t_bde_ethane": {'e_parent': -78.30286822229425,
                     'bde': {'C0-C1': 103.44332676648965}},
    "t_interaction_water": {'e_cp': 0.0028723625783868556,
                            'e_raw': 0.0024031761300307153,
                            'bsse': 0.0004691864483561403},
    "t_reaction_h3o": {'dE': -0.3645383419496824,
                       'dE0': -0.3645383419496824,
                       'dH': -0.36689880333725,
                       'dG': -0.3545265134971203},
}


def test_threefry_draw_and_embedding_match_cctpu():
    for seed in (0, 7, 42):
        for n in range(1, 51):
            ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                               (n, 3)))
            assert np.abs(jax_prng.normal(seed, (n, 3)) - ref).max() \
                <= 1e-14
    for smi in ("CC", "CCO", "O", "[OH3+]", "C[CH2]", "Oc1ccccc1"):
        sj, cj = j_smiles_to_xyz(smi)
        st, ct = t_smiles_to_xyz(smi)
        assert sj == st
        # the same start gives the same molecule; for phenol the second
        # L-BFGS stage (ftol 1e-10) stops at different points of a flat
        # valley of the force field (cctpu 214 iterations to 6.2e-7, the
        # port 276 to 1.0e-9), 0.015 A apart
        tol = 0.05 if smi == "Oc1ccccc1" else 1e-10
        assert np.abs(np.asarray(cj) - ct).max() <= tol, smi


class _Stub:
    pass


def _cctpu_view(mf):
    """cctpu's MP2 input: the port's converged state as numpy arrays."""
    s, jk = _Stub(), _Stub()
    s.mo_coeff = mf.mo_coeff.numpy()
    s.mo_energy = mf.mo_energy.numpy()
    s.e_tot, s.mol, s.density_fit = mf.e_tot, mf.mol, mf.density_fit
    if mf.density_fit:
        jk.B = mf._jk.B.numpy()
    else:
        n = mf.mol.nao
        jk.eri = mf._jk.eri.reshape(n, n, n, n).numpy()
    s._jk = jk
    return s


def test_mp2_matches_cctpu(tmp_path):
    cases = [(RHF, WATER, 0, df) for df in (False, True, "cd")]
    cases.append((UHF, NH2, 1, False))
    for cls, atoms, spin, df in cases:
        mol = TMolecule.from_atoms(atoms, spin=spin, basis="sto-3g")
        mf = cls(mol, density_fit=df, device="cpu")
        mf.kernel()
        assert mf.converged
        e_corr, e_tot = MP2(mf).kernel()
        j_corr, j_tot = JMP2(_cctpu_view(mf)).kernel()
        assert abs(e_corr - j_corr) <= 1e-12, (cls.__name__, df)
        assert abs(e_tot - mf.e_tot - e_corr) <= 1e-12
    mf = UHF(TMolecule.from_atoms(NH2, spin=1, basis="sto-3g"),
             density_fit=True, device="cpu")
    mf.kernel()
    with pytest.raises(NotImplementedError, match="DF-UMP2"):
        MP2(mf).kernel()
    e = calculate_energy.main(["--smiles", "O", "--method", "mp2",
                               "--basis", "sto-3g", "--device", "cpu",
                               "--output-dir", str(tmp_path)])
    short, = tmp_path.glob("*_short_report.txt")
    text = short.read_text()
    e_scf = float(text.split("SCF energy:")[1].split()[0])
    e_corr = float(text.split("MP2 corr:")[1].split()[0])
    assert abs(e - e_scf - e_corr) <= 1e-9 and -0.05 < e_corr < -0.02


def _h_owner(g):
    h_owner, k = {}, g.natoms
    for a in g.atoms:
        for _ in range(a.n_h):
            h_owner[k] = a.idx
            k += 1
    return h_owner, k


def test_workflow_helpers_match_cctpu():
    for smi in ("CCO", "Oc1ccccc1"):
        gj, gt = j_parse(smi), t_parse(smi)
        (hj, natm), (ht, _) = _h_owner(gj), _h_owner(gt)
        assert hj == ht
        bonds = tbde.enumerate_bonds(gt, ht)
        assert bonds == jbde.enumerate_bonds(gj, hj)
        assert tbde.single_bonds(gt) == jbde.single_bonds(gj)
        for b in bonds + [(b.i, b.j) for b in gt.bonds]:
            assert tbde.fragment_atoms(gt, ht, natm, b) == \
                jbde.fragment_atoms(gj, hj, natm, b)
            assert tbde.fragment_graphs(gt, b) == jbde.fragment_graphs(gj, b)
    for side in ("2CCO + O", "CC=O + 2 O", " C ", "3[H]"):
        assert trx.parse_side(side) == jrx.parse_side(side)
    # a '+' inside brackets is a charge: cctpu splits there
    assert trx.parse_side("O + [H+] ") == [(1, "O"), (1, "[H+]")]
    assert jrx.parse_side("O + [H+] ") == [(1, "O"), (1, "[H"), (1, "]")]
    assert trx.species_thermo("[H+]", "hf", "sto-3g", None, 3) == \
        jrx.species_thermo("[H+]", "hf", "sto-3g", None, 3)
    for f in np.linspace(-100.0, 4000.0, 411):
        assert tir.assign_mode(f) == jir.assign_mode(f)
    for e in np.linspace(-8.0, 2.0, 101):
        for polar in (True, False):
            assert tint.classify(e, polar) == jint.classify(e, polar)
    rng = np.random.default_rng(11)
    a = [("O", rng.normal(size=3)), ("H", rng.normal(size=3)),
         ("H", rng.normal(size=3))]
    b = [("N", rng.normal(size=3)), ("H", rng.normal(size=3))]
    for orient in ("aligned", "parallel", "perpendicular"):
        dims = []
        for M, mod in ((JMolecule, jint), (TMolecule, tint)):
            ma = M.from_atoms(a, basis="sto-3g")
            mb = M.from_atoms(b, charge=1, spin=1, basis="sto-3g")
            d = mod.make_dimer(ma, mb, 3.7, orient)
            d._monomer_split = ma.natm
            d._charges_ab = (ma.charge, mb.charge)
            d._spins_ab = (ma.spin, mb.spin)
            dims.append([d, mod.ghosted(d, "A"), mod.ghosted(d, "B")])
        for dj, dt in zip(*dims):
            assert dj.symbols == dt.symbols
            assert (dj.charge, dj.spin) == (dt.charge, dt.spin)
            assert np.abs(np.asarray(dj.coords) - dt.coords).max() <= 1e-14


def test_workflow_clis_match_cctpu(tmp_path, capsys):
    common = ["--method", "hf", "--basis", "sto-3g"]
    cpu = ["--device", "cpu"]

    def out(tag):
        return ["--output-dir", str(tmp_path / tag)]

    if not torch.cuda.is_available():
        # the card unless the caller asks for the CPU: no silent fallback
        for argv in (["bde", "--smiles", "CC", *common, "--limit", "1"],
                     ["interaction", "--smiles", "O", "--smiles2", "O",
                      *common],
                     ["reaction", "--reaction", "O -> O", *common,
                      "--skip-freq"],
                     ["ir", "--smiles", "O", *common]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main([*argv, *out("nocard")])
    capsys.readouterr()

    ref = ORACLES["t_bde_ethane"]
    res = tbde.main(["--smiles", "CC", *common, "--limit", "1", *cpu,
                     *out("bde")])
    assert [(r[0], r[1], r[2]) for r in res] == [("C0-C1", 0, 1)]
    assert abs(res[0][3] - ref["bde"]["C0-C1"]) <= 1e-6
    csv, = (tmp_path / "bde").glob("*_bde.csv")
    assert csv.read_text().splitlines()[1].startswith("C0-C1,0,1,103.44")
    assert "using the serial path" in capsys.readouterr().out

    ref = ORACLES["t_interaction_water"]
    e_cp = tint.main(["--smiles", "O", "--smiles2", "O", *common,
                      "--distance", "3.0", *cpu, *out("int")])
    assert abs(e_cp - ref["e_cp"]) <= 1e-9
    text = capsys.readouterr().out
    for key, label in (("e_raw", "E_int (raw)"), ("bsse", "BSSE corr")):
        got = float(text.split(label)[1].split("=")[1].split()[0])
        assert abs(got - ref[key] * HARTREE2KCAL) <= 6e-4

    ref = ORACLES["t_reaction_h3o"]
    dE, dH, dG, _ = trx.main(["--reaction", "O + [H+] -> [OH3+]", *common,
                              "--skip-freq", *cpu, *out("rx")])
    for got, key in ((dE, "dE"), (dH, "dH"), (dG, "dG")):
        assert abs(got - ref[key]) <= 1e-9, key

    # H2 is linear: no cctpu comparison (ROADMAP.md queue 3 item 7); one
    # stretch, HF/STO-3G ~5.4e3 cm^-1
    ha = tir.main(["--smiles", "[H][H]", *common, *cpu, *out("ir")])
    assert len(ha.freq_wavenumber) == 1
    assert 5000 < ha.freq_wavenumber[0] < 5800 and ha.ir_intensity[0] >= 0
    text = capsys.readouterr().out
    assert "Hessian: FD of analytic gradients" in text
    assert "assignment" in text and ("IR plot ->" in text
                                     or "IR plot skipped" in text)
