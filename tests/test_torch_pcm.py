"""The port's PCM solvation on the CPU, held against cctpu's.

Live against cctpu on the same inputs: the potential integrals (water/
6-31G* at random points, <= 1e-12 relative), the cavity's K and R and
E_solv for IEF- and C-PCM at a random symmetric density (<= 1e-12
relative), and the gradient's PCM term against jitted jax.grad of cctpu's
``PCMModel.energy`` at the port's density (<= 1e-9 Ha/bohr). Against
cctpu's stored CPU-f64 results (``ORACLES``, made by
``python scripts/make_pcm_oracles.py <case>``, one case a process): PCM
SCF energies (<= 1e-10 Ha) and whole gradients (<= 1e-8 Ha/bohr) of water
RHF (IEF and C-PCM), B3LYP in core and density fitted and NH2 UHF at
STO-3G; the PCM analytic Hessians with dipole derivatives (<= 1e-8
Ha/bohr^2, symmetric before the final symmetrization); the ``solvent``
CLI as cctpu's tests/test_workflows.py runs it. And ``torch.maximum``,
the cavity's area floor, splitting the gradient at a tie as
``jnp.maximum`` does.
"""

import numpy as np
import torch

from cctpu_torch.core.molecule import Molecule
from cctpu_torch.dft.rks import RKS
from cctpu_torch.grad.scf_grad import gradient
from cctpu_torch.hessian import cphf
from cctpu_torch.hessian.frequencies import hessian_auto
from cctpu_torch.scf.hf import RHF, UHF
from cctpu_torch.solvent import pcm
from cctpu_torch.utils.measure import NH2, WATER
from test_torch_threads import one_torch_thread  # noqa: F401

SCF_OPTS = dict(conv_tol=1e-12, conv_tol_grad=1e-9, max_cycle=200)
# name: (atoms, spin, SCF class, its options, PCM method), as the oracle
# script's
CASES = {
    "water_rhf": (WATER, 0, RHF, {}, "ief-pcm"),
    "water_rhf_cpcm": (WATER, 0, RHF, {}, "c-pcm"),
    "water_b3lyp": (WATER, 0, RKS, dict(xc="b3lyp", grid_level=1),
                    "ief-pcm"),
    "water_df_b3lyp": (WATER, 0, RKS,
                       dict(xc="b3lyp", grid_level=1, density_fit=True),
                       "ief-pcm"),
    "nh2_uhf": (NH2, 1, UHF, {}, "ief-pcm"),
}

# cctpu's CPU-f64 results, as ``python scripts/make_pcm_oracles.py t_<case>``
# prints them
ORACLES = {
    "t_water_rhf": {
        "E": -74.96940210067774,
        "cycles": 10,
        "gradient": [
            [-1.4896696155503939e-16, -1.1199940473587303e-15,
             -0.05940647580646141],
            [5.750337682043556e-17, -0.02157985794513584, 0.02970323790323004],
            [8.963682153039714e-17, 0.021579857945137615,
             0.029703237903230484],
        ],
        "pcm_term": [
            [-4.051490935615327e-18, 1.0152505142054522e-16,
             -0.011087973708988619],
            [2.455232117505915e-18, -0.0028765270533403966,
             0.00554398685449451],
            [1.4655522872071515e-18, 0.0028765270533402934,
             0.005543986854494115],
        ],
    },
    "t_water_rhf_cpcm": {
        "E": -74.96988420617652,
        "cycles": 10,
        "gradient": [
            [-1.117290235677751e-16, 6.378929426096581e-16,
             -0.059594707439569294],
            [5.865273364175656e-17, -0.021731673880025948,
             0.029797353719785757],
            [5.5386679278125704e-17, 0.021731673880025504,
             0.02979735371978398],
        ],
        "pcm_term": [
            [4.470851653845011e-18, -1.9497957291965146e-17,
             -0.011947950700863854],
            [1.8719428134320037e-19, -0.0032708755267188056,
             0.005973975350431902],
            [-2.0468551170400168e-18, 0.0032708755267188247,
             0.005973975350431938],
        ],
    },
    "t_water_b3lyp": {
        "E": -75.31862355545636,
        "cycles": 11,
        "gradient": [
            [1.6080414954646806e-17, 1.0278867385034544e-15,
             -0.10462430302643888],
            [-1.8175955829719892e-17, -0.04533314562996349,
             0.05231215151321811],
            [-4.1354177101067046e-17, 0.045333145629963045, 0.052312151513217],
        ],
        "pcm_term": [
            [7.9679330557027965e-19, 6.213844288969388e-17,
             -0.010885041054447053],
            [-1.4114732867099659e-18, -0.0028894577514097606,
             0.005442520527223529],
            [3.1565104641543904e-18, 0.0028894577514096895,
             0.005442520527223508],
        ],
    },
    "t_water_df_b3lyp": {
        "E": -75.31862370501216,
        "cycles": 11,
        "gradient": [
            [5.429734845180434e-16, 2.5559800366181617e-15,
             -0.10462492926556544],
            [-7.090504287094158e-17, -0.04533348001983563,
             0.05231246463278283],
            [-2.9721799278999064e-16, 0.04533348001983217,
             0.052312464632781275],
        ],
        "pcm_term": [
            [-2.8773709218228583e-18, -9.379995212290839e-17,
             -0.01088505290043585],
            [3.899479954446457e-18, -0.002889459108136889,
             0.005442526450217814],
            [-7.381139400963804e-19, 0.0028894591081369807,
             0.005442526450218031],
        ],
    },
    "t_nh2_uhf": {
        "E": -54.84294680996641,
        "cycles": 25,
        "gradient": [
            [-7.3944653669655e-17, 2.3197838578391984e-16, 0.0478490686824955],
            [1.0219466534704846e-16, -0.02124258298104742,
             -0.02392453434124664],
            [-2.635084745777688e-17, 0.021242582981047198,
             -0.02392453434124686],
        ],
        "pcm_term": [
            [-9.953346520331354e-17, 8.777484795041094e-18,
             0.010064063704039394],
            [5.1926931314951255e-17, -0.0032524509563267947,
             -0.005032031852019709],
            [4.8702912159464574e-17, 0.00325245095632678,
             -0.005032031852019665],
        ],
    },
    "t_cli_water": {
        "e_gas": -74.95929230324731,
        "e_sol": -74.96579517281786,
        "mu_gas": 1.7010132153441015,
        "gap_gas": 0.9907544584260002,
        "mu_sol": 1.7821841127368594,
        "gap_sol": 1.0022006395032275,
    },
    "t_water_rhf_hess": {
        "E": -74.9694021006778,
        "hessian": [
            [-0.05312130167433185, -1.3739594264106397e-16,
             1.5458059859929097e-17, 0.026560650837165023,
             5.976296954204018e-17, -8.33669082871153e-17,
             0.02656065083716567, 7.486387253586444e-17,
             7.011851643121245e-17],
            [-1.3739594264106397e-16, 0.9846791356696685,
             1.889793009579588e-12, 5.742140051348259e-17,
             -0.4923395678387667, 0.4019719460443263, 7.56880655376451e-17,
             -0.49233956783090776, -0.401971946046213],
            [1.5458059859929097e-17, 1.889793009579588e-12,
             0.6623016024674675, -1.346899789141552e-16, 0.27419834495817386,
             -0.33115080123519647, 1.251819372579258e-16,
             -0.27419834496006407, -0.3311508012322721],
            [0.026560650837165023, 5.742140051348259e-17,
             -1.346899789141552e-16, -0.021962743157811798,
             -1.1914141762754605e-15, 1.0145532450169521e-16,
             -0.0045979076793541945, 1.139021137078857e-15,
             2.703092761632031e-17],
            [5.976296954204018e-17, -0.4923395678387667, 0.27419834495817386,
             -1.1914141762754605e-15, 0.5222602823375446,
             -0.33808514549843616, 1.1487803042053805e-15,
             -0.029920714498776667, 0.06388680054025922],
            [-8.33669082871153e-17, 0.4019719460443263, -0.33115080123519647,
             1.0145532450169521e-16, -0.33808514549843616,
             0.3140353321640294, -2.6386600149030636e-17,
             -0.06388680054589121, 0.017115469071169107],
            [0.02656065083716567, 7.56880655376451e-17,
             1.251819372579258e-16, -0.0045979076793541945,
             1.1487803042053805e-15, -2.6386600149030636e-17,
             -0.021962743157812728, -1.2254038649806503e-15,
             -9.859658903854503e-17],
            [7.486387253586444e-17, -0.49233956783090776,
             -0.27419834496006407, 1.139021137078857e-15,
             -0.029920714498776667, -0.06388680054589121,
             -1.2254038649806503e-15, 0.5222602823296878, 0.3380851455059551],
            [7.011851643121245e-17, -0.401971946046213, -0.3311508012322721,
             2.703092761632031e-17, 0.06388680054025922,
             0.017115469071169107, -9.859658903854503e-17,
             0.3380851455059551, 0.31403533216110324],
        ],
        "dmu_dR": [
            [-0.6451970700520884, -1.5750082146683974e-17,
             -1.3513234686309357e-18],
            [1.573227333392826e-17, -0.10768092352877945,
             5.568010179390115e-16],
            [-1.3160386243682753e-18, 3.2324837251351823e-12,
             -0.020850460436702356],
            [0.3225985350260414, -7.581136532344581e-18,
             4.202635470491794e-17],
            [-8.488891197455908e-18, 0.05384046175785717, 0.16013391132314148],
            [6.378183714003424e-18, 0.2091511099972927, 0.010425230218345738],
            [0.32259853502603963, 2.4973059575922188e-17,
             -5.736892963201727e-17],
            [-7.010387082419188e-18, 0.053840461770912285,
             -0.16013391132314247],
            [-4.822318953306385e-18, -0.20915111000052355,
             0.010425230218345072],
        ],
    },
    "t_nh2_uhf_hess": {
        "E": -54.84294680996641,
        "hessian": [
            [-0.05962865026220529, 1.2433037827497692e-15,
             -2.474402770710908e-13, 0.02981432513113097,
             9.196500238226364e-14, 1.3167867700571287e-13,
             0.02981432513107725, -1.0437159506706384e-13,
             9.074006680186396e-14],
            [1.2433037827497692e-15, 0.7661656994876413,
             -1.8254356359825863e-12, -2.894264936714929e-15,
             -0.3830828497680247, -0.32254932242558154,
             1.6581552522421403e-15, -0.38308284976894896,
             0.32254932242600054],
            [-2.474402770710908e-13, -1.8254356359825863e-12,
             0.5445623145301655, 1.2136728952553423e-13,
             -0.22589869312869315, -0.27228115721151935,
             1.2611589854234502e-13, 0.22589869312776656,
             -0.27228115721023116],
            [0.02981432513113097, -2.894264936714929e-15,
             1.2136728952553423e-13, -0.030933273955590507,
             -4.492338566470463e-14, -6.219559620986142e-14,
             0.0011189488244587893, 5.3475154869391876e-14,
             -4.662642150737859e-14],
            [9.196500238226364e-14, -0.3830828497680247,
             -0.22589869312869315, -4.492338566470463e-14,
             0.4128071657568856, 0.2742240077672155, -4.7053579512272254e-14,
             -0.02972431596378229, -0.04832531466453527],
            [1.3167867700571287e-13, -0.32254932242558154,
             -0.27228115721151935, -6.219559620986142e-14,
             0.2742240077672155, 0.25682946654635475, -6.957381351276195e-14,
             0.048325314655841896, 0.015451690610372243],
            [0.02981432513107725, 1.6581552522421403e-15,
             1.2611589854234502e-13, 0.0011189488244587893,
             -4.7053579512272254e-14, -6.957381351276195e-14,
             -0.030933273955535828, 5.09093486424898e-14,
             -4.406565773457018e-14],
            [-1.0437159506706384e-13, -0.38308284976894896,
             0.22589869312776656, 5.3475154869391876e-14,
             -0.02972431596378229, 0.048325314655841896,
             5.09093486424898e-14, 0.41280716575698406, -0.274224007756191],
            [9.074006680186396e-14, 0.32254932242600054,
             -0.27228115721023116, -4.662642150737859e-14,
             -0.04832531466453527, 0.015451690610372243,
             -4.406565773457018e-14, -0.274224007756191, 0.2568294665462381],
        ],
        "dmu_dR": [
            [-0.6211893428297427, -1.1645307721424084e-15,
             3.059939441351984e-16],
            [3.4713164934119305e-16, -0.12240687170722597,
             4.047526549446253e-16],
            [5.208039447713967e-12, -2.455915158738886e-11,
             0.02202939180834118],
            [0.310594671414872, 5.825948528719914e-16,
             -2.5689812584317944e-16],
            [-1.951747250868999e-12, 0.06120343564563635,
             -0.12563077886249058],
            [-2.8116550878779284e-12, -0.196114049170931,
             -0.011014696116234846],
            [0.3105946714148716, 2.802644737734766e-16,
             -5.185323899681174e-17],
            [2.183768624917861e-12, 0.06120343557993502, 0.12563077887230972],
            [-1.8800665845233253e-12, 0.1961140491813454,
             -0.011014696107337407],
        ],
    },
    "t_water_df_b3lyp_hess": {
        "E": -75.31862370501216,
        "hessian": [
            [-0.09391870273334176, 1.455486223747797e-15,
             1.8035382012596756e-15, 0.04695935136691854,
             -3.0327934049081016e-16, -6.359083804035538e-16,
             0.046959351366447404, -1.1672556563472351e-15,
             -1.1771412057006706e-15],
            [1.455486223747797e-15, 0.918976251310867,
             -3.8010671563407095e-10, -2.1421520173654183e-16,
             -0.45948812581910764, 0.3925071902788902, -1.22048233230033e-15,
             -0.4594881256034112, -0.3925071897812345],
            [1.8035382012596756e-15, -3.8010671563407095e-10,
             0.583423465302098, -4.1138220855839583e-16, 0.2678936514195619,
             -0.29171173279672913, -1.3935605578004783e-15,
             -0.267893651034034, -0.291711732502009],
            [0.04695935136691854, -2.1421520173654183e-16,
             -4.1138220855839583e-16, -0.04040697352140138,
             9.363894750834196e-16, 3.4227293574905775e-16,
             -0.0065523778455274075, -7.127283264307601e-16,
             8.149269962148044e-17],
            [-3.0327934049081016e-16, -0.45948812581910764,
             0.2678936514195619, 9.363894750834196e-16, 0.4866724990279617,
             -0.3302004208118647, -6.34300498248815e-16,
             -0.02718437315464494, 0.062306769335931565],
            [-6.359083804035538e-16, 0.3925071902788902,
             -0.29171173279672913, 3.4227293574905775e-16,
             -0.3302004208118647, 0.28230600153955776,
             2.9121353382401217e-16, -0.06230676951132017,
             0.009405731299546742],
            [0.046959351366447404, -1.22048233230033e-15,
             -1.3935605578004783e-15, -0.0065523778455274075,
             -6.34300498248815e-16, 2.9121353382401217e-16,
             -0.040406973520909786, 1.8611552893724435e-15,
             1.104185771747574e-15],
            [-1.1672556563472351e-15, -0.4594881256034112,
             -0.267893651034034, -7.127283264307601e-16,
             -0.02718437315464494, -0.06230676951132017,
             1.8611552893724435e-15, 0.48667249881553043, 0.3302004204841973],
            [-1.1771412057006706e-15, -0.3925071897812345,
             -0.291711732502009, 8.149269962148044e-17, 0.062306769335931565,
             0.009405731299546742, 1.104185771747574e-15, 0.3302004204841973,
             0.28230600115674115],
        ],
        "dmu_dR": [
            [-0.6287632696950143, 9.623725014510955e-17,
             4.650948841224823e-16],
            [1.572333236915646e-16, -0.04376311086831408,
             -2.5734276147333923e-13],
            [1.840622554496822e-16, -2.034811555362559e-12,
             0.04870746304931961],
            [0.3143816348475017, 3.054889734623988e-16,
             -5.486826365533174e-16],
            [-5.642910272773491e-17, 0.021881555438354905,
             0.18128314779998672],
            [-1.5143294665882991e-16, 0.2274763574037975,
             -0.024353731524997868],
            [0.31438163484751624, -4.2376903980971783e-16,
             8.889321967015151e-17],
            [-1.0636821560989758e-16, 0.021881555430385946,
             -0.18128314779977006],
            [-3.2744113448378764e-17, -0.22747635740145028,
             -0.024353731524344613],
        ],
    },
}


def _scf(name):
    atoms, spin, cls, opts, method = CASES[name]
    mol = Molecule.from_atoms(atoms, spin=spin, basis="sto-3g")
    mf = pcm.PCM(cls(mol, device="cpu", **opts, **SCF_OPTS),
                 solvent="water", method=method)
    mf.kernel()
    assert mf.converged, name
    return mf


def test_potential_integrals_and_cavity_match_cctpu():
    import jax
    import jax.numpy as jnp
    from cctpu.core.molecule import Molecule as JMolecule
    from cctpu.solvent import pcm as jpcm
    jm = JMolecule.from_atoms(WATER, basis="6-31g*").build()
    mol = Molecule.from_atoms(WATER, basis="6-31g*").build()
    coords = torch.as_tensor(mol.coords)
    rng = np.random.default_rng(5)
    P = rng.standard_normal((20, 3)) * 2.5
    ref = np.asarray(jax.jit(lambda c, p: jpcm.potential_integrals(
        jm.basis_set, c, p))(jnp.asarray(jm.coords), jnp.asarray(P)))
    # chunks of 7 points: a class's points in three calls
    got = pcm.potential_integrals(mol.basis_set, coords, torch.as_tensor(P),
                                  chunk=7).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    D = rng.standard_normal((mol.nao, mol.nao))
    D = D + D.T
    for method in ("ief-pcm", "c-pcm"):
        jmod = jpcm.PCMModel(jm, method=method)
        tmod = pcm.PCMModel(mol, method=method)
        refs = jax.jit(jmod.kernel_matrices)(jnp.asarray(jm.coords))
        outs = tmod.kernel_matrices(coords)
        for name, a, b in zip(("pts", "areas", "K", "R"), refs, outs):
            a = np.asarray(a)
            assert np.abs(b.numpy() - a).max() <= 1e-12 * np.abs(a).max(), \
                (method, name)
        v = pcm.potential_integrals(mol.basis_set, coords, outs[0])
        e_ref = float(jax.jit(jmod.energy)(
            jnp.asarray(jm.coords), jnp.asarray(D), jnp.asarray(v.numpy())))
        e = float(tmod.energy(coords, torch.as_tensor(D), v))
        assert abs(e - e_ref) <= 1e-12 * abs(e_ref), method


def test_pcm_scf_energies_and_gradients_match_cctpu():
    """The PCM SCF energies (<= 1e-10 Ha) and whole gradients (<= 1e-8
    Ha/bohr) against cctpu's; the gradient's ``pcm`` phase against
    cctpu's PCM term; every route's gradient translationally invariant."""
    from cctpu_torch.utils.profiling import PhaseTimer
    for name in CASES:
        mf = _scf(name)
        ref = ORACLES[f"t_{name}"]
        assert abs(mf.e_tot - ref["E"]) <= 1e-10, name
        timer = PhaseTimer()
        g = gradient(mf, timer=timer).numpy()
        assert "pcm" in timer.phases, name
        assert np.abs(g - np.asarray(ref["gradient"])).max() <= 1e-8, name
        assert np.abs(g.sum(0)).max() <= 1e-8, name
        g_pcm = mf._pcm.nuclear_gradient(mf.coords, mf.dm).numpy()
        assert np.abs(g_pcm - np.asarray(ref["pcm_term"])).max() <= 1e-9, \
            name


def test_pcm_gradient_term_matches_jax_grad():
    """The walked PCM term at a random symmetric density against jitted
    jax.grad of cctpu's ``PCMModel.energy`` (IEF-PCM, water/STO-3G; the
    same function by autograd of the port's whole-graph ``energy``), and
    the model's solvent response (``PCMModel.response``) against the
    double backward of ``energy`` in D."""
    import jax
    import jax.numpy as jnp
    from cctpu.core.molecule import Molecule as JMolecule
    from cctpu.solvent.pcm import PCMModel
    mf = _scf("water_rhf")
    model = mf._pcm
    rng = np.random.default_rng(11)
    D = rng.standard_normal((mf.mol.nao,) * 2)
    D = torch.as_tensor(0.1 * (D + D.T)) + mf.dm
    jm = JMolecule.from_atoms(WATER, basis="sto-3g").build()
    ref = np.asarray(jax.jit(jax.grad(lambda R: PCMModel(jm).energy(
        R, jnp.asarray(D.numpy()))))(jnp.asarray(jm.coords)))
    got = model.nuclear_gradient(mf.coords, D).numpy()
    assert np.abs(got - ref).max() <= 1e-9
    R = mf.coords.detach().requires_grad_(True)
    g, = torch.autograd.grad(model.energy(R, D), R)
    assert np.abs(g.numpy() - got).max() <= 1e-12
    D1 = torch.as_tensor(rng.standard_normal((2, mf.mol.nao, mf.mol.nao)))
    D1 = D1 + D1.transpose(1, 2)
    Dl = D.clone().requires_grad_(True)
    gD, = torch.autograd.grad(model.energy(mf.coords, Dl, model.v_ints), Dl,
                              create_graph=True)
    for d1, r in zip(D1, model.response(D1)):
        h, = torch.autograd.grad(gD, Dl, d1, retain_graph=True)
        assert float((r - h).abs().max()) <= 1e-12 * float(h.abs().max())


def test_pcm_analytic_hessian_matches_cctpu():
    """cctpu's CPHF Hessians with the PCM term and dipole derivatives
    against the port's (<= 1e-8 Ha/bohr^2, 1e-8 a.u.): in core RHF
    through ``hessian_auto`` (the analytic route, and its log line), UHF,
    and DF-B3LYP; |H - H^T| before the symmetrization <= 1e-9."""
    for name in ("water_rhf", "nh2_uhf", "water_df_b3lyp"):
        mf = _scf(name)
        ref = ORACLES[f"t_{name}_hess"]
        stats = {}
        if name == "water_rhf":
            log = []
            H, dmu = hessian_auto(mf, None, mf.mol, log=log.append)
            assert log == ["  Hessian: analytic (AD-native CPHF)"]
        else:
            H, dmu = cphf.analytic_hessian(mf, with_dipole=True, stats=stats)
            assert stats["max_abs_asymmetry"] <= 1e-9, name
        assert np.abs(H - np.asarray(ref["hessian"])).max() <= 1e-8, name
        assert np.abs(dmu - np.asarray(ref["dmu_dR"])).max() <= 1e-8, name


def test_solvent_cli_matches_cctpu(tmp_path):
    """``solvent --smiles O --method hf --basis sto-3g --solvent water``
    (cctpu's tests/test_workflows.py case) with ``--device cpu`` against
    cctpu's CLI on the same coordinates: energies <= 1e-8 Ha (the CLI's
    conv_tol 1e-10), dipoles <= 1e-6 D, gaps <= 1e-6 Ha."""
    from cctpu_torch.workflows import cli
    from cctpu_torch.workflows.calculate_solvent_effect import main
    assert "solvent" in cli._WORKFLOWS and "solvent" not in cli._NOT_PORTED
    out = main(["--smiles", "O", "--method", "hf", "--basis", "sto-3g",
                "--solvent", "water", "--device", "cpu", "--output-dir",
                str(tmp_path)])
    ref = ORACLES["t_cli_water"]
    assert out["e_sol"] < out["e_gas"]
    for k, tol in (("e_gas", 1e-8), ("e_sol", 1e-8), ("mu_gas", 1e-6),
                   ("mu_sol", 1e-6), ("gap_gas", 1e-6), ("gap_sol", 1e-6)):
        assert abs(out[k] - ref[k]) <= tol, k
    short = [p for p in tmp_path.iterdir()
             if p.name.endswith("_short_report.txt")]
    assert len(short) == 1 and "dG_solv" in short[0].read_text()


def test_area_floor_splits_the_gradient_at_a_tie():
    """The cavity clips its areas with ``torch.maximum`` against a tensor,
    which, as cctpu's ``jnp.maximum``, gives half the gradient to each
    side at a tie (``torch.clamp`` would pass it all)."""
    import jax
    import jax.numpy as jnp
    x = torch.tensor([1e-10, 2e-10, 5e-11], dtype=torch.float64,
                     requires_grad=True)
    floor = torch.tensor(1e-10, dtype=torch.float64, requires_grad=True)
    gx, gf = torch.autograd.grad(torch.maximum(x, floor).sum(), [x, floor])
    jx, jf = jax.grad(lambda a, f: jnp.maximum(a, f).sum(), (0, 1))(
        jnp.asarray(x.detach().numpy()), jnp.asarray(1e-10))
    assert gx.tolist() == [0.5, 1.0, 0.0] == np.asarray(jx).tolist()
    assert float(gf) == 1.5 == float(jf)
