"""The port's NMR shieldings on the CPU, held against cctpu's.

Against cctpu's stored CPU-f64 results (``ORACLES``, made by ``python
scripts/make_nmr_oracles.py <case>``, one case a process; cctpu's GIAO
takes minutes a case on the CPU, so no test re-runs it): seeded
projections of water/6-31G*'s magnetic and moment integrals, moment ERIs
and moment 3c2e (<= 1e-12 relative); the 2e skeletons at a seeded density
on the DF, in-core and erf-attenuated branches (<= 1e-10); GIAO shielding
tensors of in-core, DF, GGA, range-separated, meta-GGA and unrestricted
SCFs (<= 1e-5 ppm), and the common-gauge-origin class (water, He, H2).
Live against cctpu where its call is plain numpy: the raise maps, the AO
centers, the TMS geometry and the shift assignment. Then the port alone:
GIAO equals CGO for an atom (<= 1e-6 ppm), the H-atom Lamb value
(cctpu's test_nmr_h_atom_lamb gate), the batched CG, and the ``nmr`` CLI
with ``--device cpu`` (its TMS reference from a memo file, so that the
17-atom GIAO does not run here).
"""

import json

import numpy as np
import pytest
import torch

from cctpu_torch.core.constants import LIGHT_SPEED_AU
from cctpu_torch.core.molecule import Molecule
from cctpu_torch.dft.rks import RKS, UKS
from cctpu_torch.ints import giao, magnetic
from cctpu_torch.ints.df import autoaux
from cctpu_torch.ints.one_electron import build_int1e_eager
from cctpu_torch.response.giao_nmr import GIAONMR, cg_solve, make_nmr
from cctpu_torch.response.nmr import NMR
from cctpu_torch.scf.hf import RHF, UHF
from cctpu_torch.utils.measure import NH2, WATER
from cctpu_torch.workflows import calculate_nmr, cli
from test_torch_threads import one_torch_thread  # noqa: F401

# the oracle script's SCF settings and inputs
SCF_OPTS = dict(conv_tol=1e-12, conv_tol_grad=1e-9, max_cycle=200)
HF_MOL = "H 0 0 0; F 0 0 0.92"
H2_BOHR = [[0.0, 0.0, -0.7], [0.0, 0.0, 0.7]]
ORIGIN = (0.1, -0.2, 0.3)
OMEGA = 0.33
TOL_PPM = 1e-5
# name: (atoms, basis, SCF class, spin, its options)
CASES = {
    "t_water_rhf": (WATER, "sto-3g", RHF, 0, {}),
    "t_water_df_rhf": (WATER, "6-31g", RHF, 0, dict(density_fit=True)),
    "t_water_b3lyp": (WATER, "sto-3g", RKS, 0,
                      dict(xc="b3lyp", grid_level=1)),
    "t_water_camb3lyp": (WATER, "sto-3g", RKS, 0,
                         dict(xc="cam-b3lyp", grid_level=1)),
    "t_water_m062x": (WATER, "sto-3g", RKS, 0,
                      dict(xc="m06-2x", grid_level=1)),
    "t_nh2_ub3lyp": (NH2, "sto-3g", UKS, 1, dict(xc="b3lyp", grid_level=1)),
    "t_hf_uhf": (HF_MOL, "sto-3g", UHF, 0, {}),
}

# cctpu's CPU-f64 results, as ``python scripts/make_nmr_oracles.py
# <case>`` prints them
ORACLES = {
    "cli_methane": {
        "sigma": [236.18309147528464, 32.860714483447545, 32.86071448377199,
                  32.86071448321577, 32.86071448339963],
        "ref_H": 33.38386403157914,
        "ref_C": 244.4602912051525,
        "delta": [8.277199729867846, 0.5231495481315918, 0.5231495478071437,
                  0.5231495483633637, 0.5231495481795037],
        "opt_energies": [-39.726278420412754, -39.726863351993565,
                         -39.72686367954746],
        "opt_coords": [
            [0.5339978863625127, -0.8662968544383772, -1.0616168350857798],
            [1.400238152274779, -1.8015676904716522, 0.5394342845234452],
            [1.8968784290129657, -0.7113425263977615, -2.580502678479698],
            [-1.0767072563151925, -1.956245903310379, -1.6988832133667877],
            [-0.08441777904040003, 1.0039687026364916, -0.5065157331038462],
        ],
    },
    "t_h2_cgo": {
        "E": -1.1312843493005862,
        "cgo": [
            [25.872252678602273, -5.962328288827918e-16,
             -5.8343064731654154e-15, 1.8850000573801476e-17,
             25.872252678602276, 1.3700533042609766e-15,
             -2.361632709161056e-15, -4.130651970631581e-16,
             27.72300433677126],
            [25.87225267860225, 3.560213309297169e-16,
             -4.3993315409950464e-15, -2.6660953616448535e-16,
             25.87225267860225, -6.881599388249727e-15,
             -2.088505211254576e-15, -1.9836523919836714e-15,
             27.723004336771233],
        ],
    },
    "t_he": {
        "E": -2.855160426154448,
        "giao": [
            [59.795878909707554, 0.0, 0.0, 0.0, 59.795878909707554, 0.0, 0.0,
             0.0, 59.795878909707554],
        ],
        "cgo": [
            [59.795878909707554, 0.0, 0.0, 0.0, 59.795878909707554, 0.0, 0.0,
             0.0, 59.795878909707554],
        ],
    },
    "t_hf_uhf": {
        "E": -98.57110044414931,
        "giao": [
            [30.085455930917387, 2.887841519312111e-15,
             -3.4296840972037873e-15, 2.0901814362295246e-15,
             30.08545593091737, -1.7876912341978612e-15,
             7.834051954250304e-15, 1.7188171917805645e-15,
             44.222434183095174],
            [380.6280749188908, -1.2822201379873468e-13,
             -5.875112829381968e-16, -1.1061173172142969e-13,
             380.62807491889123, -1.734638773051911e-14,
             -1.9595997212583072e-13, -2.617055576839594e-14,
             478.42927386587525],
        ],
        "giao_rhf": [
            [30.08545593192528, -1.9341650036267736e-15,
             1.0550950598900748e-15, -1.7047744693466818e-15,
             30.085455931925274, -2.455787910938618e-16,
             -9.70838904814816e-16, -2.1868945157478792e-16,
             44.22243418237809],
            [380.6280749394374, 4.55747495257382e-14, -2.445636551054269e-14,
             3.760565149327083e-14, 380.62807493943757,
             1.6867372546377584e-15, 9.992127859846541e-14,
             -2.823180199022487e-14, 478.4292738647733],
        ],
    },
    "t_ints_m3c": {
        "m3c": [33.09221573721955, 22.699782497163316, 0.17960141675878097],
    },
    "t_ints_mag": {
        "angmom": [-2.2385029121073865, -6.768752500938255,
                   -2.1396151906822523],
        "w": [-2.33269795539256, 22.092163024571033, 29.778967804654943],
        "m": [0.26952295828639616, -10.014326176085182, -2.605456328632769],
        "h01": [-1.8904852073322038, -26.959382593204612, -18.136035331409794],
        "dia": [-0.6588426388214002, 15.805623116136804, -0.3910172466288486],
    },
    "t_ints_meri": {
        "meri": [-18.65140363474242, -30.765244856013478, 41.73354085784655],
    },
    "t_ints_meri_lr": {
        "meri_lr": [-7.62012070977272, -20.506374698253378,
                    16.892850874418755],
    },
    "t_ints_mom": {
        "mS": [-1.2139584284025058, -12.408086805866915, -5.95243271209142],
        "mT": [-1.2057656615671943, -11.483943792965317, 3.7235241162491004],
        "mV": [-2.463561401428901, 95.04973854486416, 8.34450147558885],
        "nabla": [-8.57696021188253, 12.478240249905667, 8.790990766817062],
        "mw": [-9.325875384898827, -1.7110851286249495, 13.774048968960647],
        "mh01": [5.721093901707047, 4.431749013634594, 15.226027111252558],
    },
    "t_nh2_ub3lyp": {
        "E": -55.12284692450422,
        "giao": [
            [287.2822007589154, 7.268577560474725e-14,
             2.1925387451134492e-14, -9.594755890064291e-15,
             -602.9870518676184, 1.0273829672460012e-12,
             1.4366290063619545e-14, 4.86731221186437e-14, 86.84215924627426],
            [28.842454951185143, 1.6767449685805557e-13,
             -2.0197035005132627e-13, 7.654006180179455e-14,
             -4.273786702265972, -12.204682295424124, -1.58084558496421e-14,
             -0.728229610218812, 26.307317008387347],
            [28.842454951185626, 1.655767347257988e-13,
             2.0457073215722816e-13, 1.3632789372974218e-13,
             -4.2737867022660465, 12.204682295424133,
             -1.2285267768946352e-14, 0.7282296102217783, 26.307317008391088],
        ],
    },
    "t_skeletons": {
        "df_mJ": [-3.463695105865276, -0.7356479015226869, -4.085376923430892],
        "df_Kg": [-1.2866188669689804, 4.13678779178621, -2.1435527429057126],
        "df_lr_mJ": [-2.879333014485505, -0.13385947985357538,
                     -2.4816053637081774],
        "df_lr_Kg": [-0.6555651237305928, 2.0532932930843826,
                     -1.4804706857701173],
        "incore_mJ": [-0.0009288022271099483, -0.020042374591242005,
                      -0.22135383049227242],
        "incore_Kg": [0.2766687754107913, -0.14273653175950224,
                      -0.29307841347472763],
        "incore_lr_mJ": [-0.44447739665244423, -0.28509625008311956,
                         -0.08940836554715126],
        "incore_lr_Kg": [0.1296782730091334, -0.07835265041000045,
                         -0.20387605813725307],
    },
    "t_water_b3lyp": {
        "E": -75.31252079980307,
        "giao": [
            [344.54719985451743, -5.706141579199974e-14,
             8.242895943516161e-17, 8.019514675492129e-14, 339.860010173725,
             -9.358450998136922e-13, -8.146691623144434e-15,
             -1.1171398632980208e-13, 337.9159122570279],
            [27.53192987055702, -1.2772579845295152e-15,
             -9.352064638921262e-16, -6.054464079856801e-15,
             40.86613606777091, -2.7198910097905924, -5.2192568287144075e-16,
             -6.215377748412182, 33.54991499714674],
            [27.53192987055694, -1.7305104753928177e-15,
             -2.9302651160702506e-15, -3.056368432478074e-16,
             40.86613606777085, 2.7198910097906053, -1.3096543662000376e-16,
             6.215377748412161, 33.549914997146715],
        ],
    },
    "t_water_camb3lyp": {
        "E": -75.31835574578191,
        "giao": [
            [347.86829495131707, 1.0675993944418928e-14,
             -3.3350874319754434e-15, -8.17268602248538e-14,
             343.4339807917869, 1.3399055450606793e-12,
             -2.7284900104126894e-14, -4.935634337476304e-14,
             340.96687575917286],
            [27.454977612865186, 5.294880779300302e-16,
             -2.241292639479919e-15, -8.582798470098234e-16,
             40.858169834694216, -2.8832729028813304, 1.3620753731688556e-16,
             -6.309934153190501, 33.516859091664834],
            [27.454977612865186, -1.893960922054792e-16,
             -3.3243421758922584e-15, 6.39558595962052e-15,
             40.85816983469437, 2.883272902881294, 2.831440648398428e-16,
             6.309934153190527, 33.516859091664884],
        ],
    },
    "t_water_df_rhf": {
        "E": -75.98397338698938,
        "giao": [
            [307.4244709206917, -1.3490187631110003e-13,
             -1.2319719521230479e-12, 3.213446674077533e-14,
             354.9554686803772, -3.674454609663229e-14,
             -5.382891451178112e-13, -6.70269443459749e-13,
             318.16876142048136],
            [25.928506978393944, 5.1782701388186664e-14,
             3.286038009157695e-14, 4.224267921875979e-12, 39.79826168639517,
             -6.855880532277706, -2.7514846955069825e-12, -8.358094828812504,
             32.409585835042215],
            [25.92850697836045, -3.813496977951695e-14,
             2.3363921035053647e-15, -3.407074043456306e-12,
             39.79826168639519, 6.855880532277676, -2.4727624123644977e-12,
             8.358094828812504, 32.40958583504224],
        ],
    },
    "t_water_m062x": {
        "E": -75.31292995258872,
        "giao": [
            [341.32618433386045, -1.9125034182333388e-13,
             -1.3160905875076312e-14, -2.499869675401967e-13,
             337.68019549338317, -1.3997604910916063e-12,
             -1.8252418767731314e-14, -2.5690598447362002e-14,
             332.46072065300376],
            [27.6412439370717, -4.551628532704036e-15, 7.050087444645884e-15,
             5.009554092893934e-15, 40.87983608294606, -2.5520855001595826,
             -8.168374053259295e-16, -6.001595835620693, 33.55915742045701],
            [27.64124393707171, -5.761260083785975e-15,
             -6.3704934450527985e-15, 3.0855943740081712e-15,
             40.87983608294595, 2.5520855001596088, 1.008517989431289e-15,
             6.001595835620659, 33.55915742045698],
        ],
    },
    "t_water_rhf": {
        "E": -74.96302313846302,
        "giao": [
            [365.02436923403616, -5.677548593524645e-14,
             7.145662639384725e-16, -1.0918937918813345e-13,
             368.3736750178687, -3.622806402504755e-13,
             -1.3064580688666835e-15, 8.793192300146522e-14,
             363.6775426661067],
            [27.009240562844017, -5.712494991145293e-16,
             1.8277385535085455e-15, 2.410040269056882e-15,
             40.72764376871514, -4.271703981802037, 5.709124295428048e-16,
             -7.059205811217742, 33.284203344536124],
            [27.00924056284409, -5.746083028845259e-16,
             -1.2086030990702258e-15, 1.6304033314879581e-15,
             40.72764376871513, 4.271703981802035, 1.0962495016364959e-17,
             7.059205811217715, 33.284203344536145],
        ],
        "cgo": [
            [177.04129738966557, -3.178818834124612e-14,
             -7.130320579929759e-15, -9.886343254609197e-14,
             215.00664784794438, -3.0029249781531145e-13,
             -9.063587376634807e-15, -1.137845986876905e-13,
             123.65413919934937],
            [120.77857660706108, -4.017761462470885e-15,
             3.237932622848336e-15, -6.398998828715909e-15,
             77.89562034286818, 48.022943944399216, 3.6725915655106977e-13,
             49.69257609074481, 100.09781471176196],
            [120.77857660707792, -5.054202588726239e-15,
             -3.252646246962556e-15, -8.182359766153972e-15,
             77.89562034286813, -48.022943944399216, -4.025011905315892e-13,
             -49.6925760907448, 100.097814711762],
        ],
    },
}


def project(X, n: int = 3) -> np.ndarray:
    """The seeded projections sum(X * R_k), R_k standard normal of X's
    shape from ``np.random.default_rng(k)``, k < n (the oracle script's)."""
    X = np.asarray(X)
    return np.array([np.sum(X * np.random.default_rng(k).standard_normal(
        X.shape)) for k in range(n)])


def seeded_density(nao: int) -> torch.Tensor:
    A = np.random.default_rng(7).standard_normal((nao, nao))
    return torch.as_tensor(0.1 * (A + A.T))


def scf(atoms, basis, cls, spin=0, dm0=None, **opts):
    mol = (atoms if isinstance(atoms, Molecule) else Molecule.from_atoms(
        atoms, spin=spin, basis=basis)).build()
    mf = cls(mol, device="cpu", **opts, **SCF_OPTS)
    mf.kernel(dm0=dm0)
    assert mf.converged
    return mf


def tensors(nmr) -> np.ndarray:
    return nmr.kernel().reshape(-1, 9)


def test_integrals_against_cctpu():
    """Water/6-31G* (d shells, raised to f; autoaux up to g): every
    magnetic and moment integral, the moment ERIs at the full range and at
    omega, and the moment 3c2e, through the oracle's seeded projections."""
    mol = Molecule.from_atoms(WATER, basis="6-31g*").build()
    basis = mol.basis_set
    c = torch.as_tensor(mol.coords)
    R, G = c[0], torch.as_tensor(ORIGIN, dtype=torch.float64)
    mS, mT = giao.moment_st_integrals(basis, c)
    arrays = {
        "angmom": magnetic.angmom_integrals(basis, c, G),
        "w": magnetic.w_integrals(basis, c, R),
        "m": magnetic.m_integrals(basis, c, R, G),
        "h01": magnetic.h01_integrals(basis, c, R),
        "dia": magnetic.dia_integrals(basis, c, R, G),
        "mS": mS, "mT": mT,
        "mV": giao.moment_v_integrals(basis, c, mol.charges),
        "nabla": giao.nabla_integrals(basis, c),
        "mw": giao.moment_w_integrals(basis, c, R),
        "mh01": giao.mh01_integrals(basis, c, R),
        "meri": giao.build_moment_eri_incore(basis, c),
        "meri_lr": giao.build_moment_eri_incore(basis, c, omega=OMEGA),
        "m3c": giao.build_moment_3c2e_eager(basis, autoaux(basis), c),
    }
    orc = {k: v for part in ("mag", "mom", "meri", "meri_lr", "m3c")
           for k, v in ORACLES[f"t_ints_{part}"].items()}
    for k, X in arrays.items():
        ref = np.asarray(orc[k])
        err = np.abs(project(X.numpy()) - ref).max() / np.abs(ref).max()
        assert err <= 1e-12, (k, err)
    # the nuclei batch: one call for all three nuclei agrees with one call
    # for nucleus 0 (to rounding: the batch changes the sums' order)
    h01 = arrays["h01"]
    hb = magnetic.h01_integrals(basis, c, c)
    assert torch.abs(hb[0] - h01).max() <= 1e-14 * torch.abs(h01).max()

    # live against cctpu's numpy helpers
    from cctpu.core.molecule import Molecule as JMolecule
    from cctpu.ints import giao as jgiao
    for l in range(4):
        for d in range(3):
            assert np.array_equal(giao._raise_map(l, d),
                                  jgiao._raise_map(l, d))
    jmol = JMolecule.from_atoms(WATER, basis="6-31g*").build()
    assert np.array_equal(giao.ao_centers(basis, c).numpy(),
                          jgiao.ao_centers(jmol.basis_set, jmol.coords))


def test_skeletons_against_cctpu():
    """``_range_skeleton`` at a seeded density: DF (water/6-31G* on its
    autoaux basis, cctpu's own whitening) and in core (water/STO-3G), at
    the full range and at omega 0.33, <= 1e-10 in every projection."""
    orc = ORACLES["t_skeletons"]
    for tag, basis, df in (("df", "6-31g", True),
                           ("incore", "sto-3g", False)):
        mol = Molecule.from_atoms(WATER, basis=basis).build()
        nmr = GIAONMR(RHF(mol, device="cpu"))
        D = seeded_density(mol.nao)
        Rc = giao.ao_centers(mol.basis_set, torch.as_tensor(mol.coords))
        aux = autoaux(mol.basis_set) if df else None
        for om_tag, om in (("", None), ("_lr", OMEGA)):
            mJ, Kg = nmr._range_skeleton(D, Rc, aux, om, True, True)
            for k, X in (("mJ", mJ), ("Kg", Kg)):
                err = np.abs(project(X.numpy())
                             - np.asarray(orc[f"{tag}{om_tag}_{k}"])).max()
                assert err <= 1e-10, (tag + om_tag, k, err)


@pytest.mark.parametrize("case", list(CASES))
def test_giao_shieldings_against_cctpu(case):
    """GIAO shielding tensors <= 1e-5 ppm from cctpu's on the same SCF
    settings: in core (water RHF, with the CGO tensors too), DF (water
    DF-RHF/6-31G), GGA hybrid, range-separated (both skeletons), meta-GGA
    (tau in the probe), UKS (the spin path), and UHF on a closed shell
    from a symmetric start, which reproduces the RHF shieldings."""
    atoms, basis, cls, spin, opts = CASES[case]
    orc = ORACLES[case]
    dm0 = None
    if case == "t_hf_uhf":
        mf_r = scf(atoms, basis, RHF)
        sig_r = tensors(GIAONMR(mf_r))
        assert np.abs(sig_r - np.asarray(orc["giao_rhf"])).max() <= TOL_PPM
        dm0 = torch.stack([0.5 * mf_r.dm, 0.5 * mf_r.dm])
    mf = scf(atoms, basis, cls, spin=spin, dm0=dm0, **opts)
    assert abs(mf.e_tot - orc["E"]) <= 1e-9
    nmr = make_nmr(mf)
    assert isinstance(nmr, GIAONMR)
    sig = tensors(nmr)
    assert np.abs(sig - np.asarray(orc["giao"])).max() <= TOL_PPM
    assert max(nmr.stats["cg_iterations"]) < 400
    if case == "t_hf_uhf":
        assert np.abs(sig - sig_r).max() <= 1e-4
    if "cgo" in orc:
        assert np.abs(tensors(NMR(mf)) - np.asarray(orc["cgo"])).max() \
            <= TOL_PPM


def test_atoms_cgo_and_solver():
    """He/6-31G: GIAO and CGO against cctpu's, and GIAO = CGO at the
    nucleus (<= 1e-6 ppm); H2/6-31G** CGO with the origin at 0 against
    cctpu's; the H atom's Lamb value sigma = <1/r>/(3 c^2) from the
    diamagnetic integrals (cctpu's gate, 1e-15); the batched CG against a
    dense solve; and a TDDFT's (A-B) matvec builds no XC kernel."""
    orc = ORACLES["t_he"]
    mf = scf("He 0 0 0", "6-31g", RHF)
    s_giao, s_cgo = tensors(GIAONMR(mf)), tensors(NMR(mf))
    assert np.abs(s_giao - np.asarray(orc["giao"])).max() <= TOL_PPM
    assert np.abs(s_cgo - np.asarray(orc["cgo"])).max() <= TOL_PPM
    assert np.abs(s_giao - s_cgo).max() <= 1e-6

    mol = Molecule(symbols=["H", "H"], coords=np.array(H2_BOHR),
                   basis="6-31g**")
    nmr = NMR(scf(mol, None, RHF), gauge_origin=np.zeros(3))
    assert np.abs(tensors(nmr) - np.asarray(ORACLES["t_h2_cgo"]["cgo"])) \
        .max() <= TOL_PPM
    assert abs(nmr.isotropic()[0] - nmr.isotropic()[1]) < 1e-6

    h = Molecule(symbols=["H"], coords=np.zeros((1, 3)), spin=1,
                 basis="sto-3g").build()
    c = torch.as_tensor(h.coords)
    inv_r = -float(build_int1e_eager(h.basis_set, c, torch.as_tensor(
        h.charges))["V"][0, 0])
    dia = magnetic.dia_integrals(h.basis_set, c, torch.zeros(3),
                                 torch.zeros(3))
    sd = (0.5 / LIGHT_SPEED_AU ** 2) * float(
        torch.trace(dia[:, :, 0, 0])) / 3
    assert abs(sd - inv_r / (3 * LIGHT_SPEED_AU ** 2)) < 1e-15

    rng = np.random.default_rng(3)
    Q = rng.standard_normal((40, 40))
    A = torch.as_tensor(Q @ Q.T + 40 * np.eye(40))
    b = torch.as_tensor(rng.standard_normal((3, 40)))
    x, its = cg_solve(lambda v: v @ A, b, torch.diagonal(A), 1e-10, 400)
    assert max(its) < 400
    assert torch.allclose(x, torch.linalg.solve(A, b.T).T, rtol=0,
                          atol=1e-9)

    from cctpu_torch.response.tddft import TDDFT
    mf = scf(WATER, "sto-3g", RKS, xc="b3lyp", grid_level=1)
    GIAONMR(mf).kernel()
    td = TDDFT(mf, nstates=1)
    td._setup()
    td._amb_mv(torch.zeros((1, td.nocc, td.nvir), dtype=torch.float64))
    assert td._fxc is None


def test_cli_nmr_methane_cpu(tmp_path, monkeypatch):
    """``nmr --smiles C --method hf --basis sto-3g --device cpu``: the
    optimization and the shieldings against cctpu's CLI on the same
    coordinates (<= 1e-5 ppm), with its TMS reference read from the memo
    file ``--tms-memo`` names (cctpu's computed reference; the port
    computes its own on the card, chip_smoke.py phase 14d), the shifts
    from it; the memo's default path is the port's own file, not cctpu's;
    the dispatcher lists ``nmr`` as ported."""
    assert "nmr" in cli._WORKFLOWS and "nmr" not in cli._NOT_PORTED
    assert calculate_nmr.TMS_MEMO.endswith("cctpu_torch_tms_ref.json")
    orc = ORACLES["cli_methane"]
    memo = tmp_path / "memo.json"
    memo.write_text(json.dumps({"hf/sto-3g": {"H": orc["ref_H"],
                                              "C": orc["ref_C"]}}))
    rec = []
    main = calculate_nmr.main
    monkeypatch.setattr(calculate_nmr, "main",
                        lambda argv: rec.append(main(argv)) or rec[-1])
    rc = cli.main(["nmr", "--smiles", "C", "--method", "hf", "--basis",
                   "sto-3g", "--device", "cpu", "--tms-memo", str(memo),
                   "--output-dir", str(tmp_path)])
    assert rc == 0
    out, = rec
    assert np.abs(out["mol"].coords - np.asarray(orc["opt_coords"])).max() \
        <= 1e-5
    assert np.abs(out["sigma"] - np.asarray(orc["sigma"])).max() <= TOL_PPM
    assert np.abs(out["delta"] - np.asarray(orc["delta"])).max() <= TOL_PPM
    report = next(tmp_path.glob("*_short_report.txt")).read_text()
    assert "TMS reference computed" in report

    # cctpu's TMS geometry and shift assignment, live
    from cctpu.workflows import calculate_nmr as jnmr
    jm, tm = jnmr._tms_molecule("sto-3g"), \
        calculate_nmr._tms_molecule("sto-3g")
    assert list(jm.symbols) == list(tm.symbols)
    assert np.abs(np.asarray(jm.coords) - tm.coords).max() <= 1e-14
    for sym in ("H", "C", "O"):
        for d in np.linspace(-20.0, 240.0, 131):
            assert calculate_nmr.assign_env(sym, d) == jnmr.assign_env(sym, d)
    assert calculate_nmr.EMPIRICAL_REF == jnmr.EMPIRICAL_REF
