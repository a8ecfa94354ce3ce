#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port ``cctpu_torch`` on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one printed line or more each:

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
1. build the three hand-written CUDA kernels (one nvcc per source, all
   started together, into build/cctpu_torch/), and count the FP64
   tensor-core instructions (DMMA) in the SASS of the two W/K libraries;
2. the fused DF-J/K kernel against its plain torch version on the card at
   cctpu's three Pallas test shapes and at phenol's shape, in f64 (<= 1e-12
   relative max error) and f32 (<= 1e-5), and in f64 at an odd nao and at a
   C32H66-sized row (the plan whose W_p fits no shared memory), repeat
   calls bitwise equal, and kernel vs plain median times at phenol's shape
   (f64, CUDA events) with the launch plan (ops/plan.py) and the ptxas
   report of the f64 tensor-core instantiations;
2a. the DF-J kernels (one and two densities) and the DF-K kernel against
   their plain versions at the same shapes and at C16H34's, f64 (<= 1e-12)
   and f32 (<= 1e-5), repeats bitwise equal, a zero Cocc column giving
   K = 0, df_j's plan (ops/plan.py::j_plan: one pass, or at C16H34 two),
   kernel and plain times (alternated) at phenol's shape;
3. phenol DF-B3LYP/6-31G* (grid level 2, conv_tol 1e-10) through the Python
   API, against cctpu's host-f64 oracle (|dE| <= 1e-8 Ha), with the
   kernels' launch counts reset before and read after the SCF;
3b. the phenoxyl radical DF-UB3LYP/6-31G* (phenol without the hydroxyl H,
   spin 1) against its oracle (<= 1e-8 Ha), <S^2>, DF-J launched every
   cycle (its one-pass plan), DF-K twice a cycle, the fused kernel never;
   DF-J and DF-K timed at this SCF's own tensors;
3c. the H atom UB3LYP/6-31G* at the removed H's position (nbeta 0)
   against its oracle, and the phenol O-H bond dissociation energy;
3d. phenol DF-BLYP/6-31G* (pure GGA: J without K) against its oracle;
3e. the DF nuclear gradient of phase 3's SCF, continued to conv_tol 1e-12
   and an orbital gradient <= 1e-8 (``cctpu_torch.grad.scf_grad``): two
   calls bitwise equal, the seconds of each call and of each term (1e, W/Z,
   3c, 2c, XC, nuclear), peak device memory, s/iter (phase 3's cycles x
   s/cycle + the second call's seconds, as ``bench.py`` defines it),
   translational invariance (<= 1e-8 Ha/bohr), central differences of the
   port's own energy (h = 1e-3 bohr, three components, <= 1e-6), cctpu's
   CPU-f64 gradient (<= 1e-7), and no J/K kernel launched by the
   gradient;
3f. the same for phase 3b's phenoxyl DF-UB3LYP (two FD components);
4. C16H34/6-31G*: energy of the unrelaxed SAD density from one Fock build
   against cctpu's oracle (<= 1e-6 Ha); J/K, J (two densities and one,
   DF-J's two-pass plan) and K call times at this shape;
5. the ``energy`` CLI on phenol's SMILES with ``--density-fit``;
5b. the ``energy`` CLI on the phenoxyl radical with ``--spin 1``;
6. water DF-RHF, water DF-B3LYP and NH2 DF-UB3LYP (6-31G*, grid level 2):
   SCF and gradient against cctpu's CPU-f64 gradients (<= 1e-7 Ha/bohr);
7. the 1e-8 Ha contract: water RHF/6-31G with Cholesky J/K
   (``density_fit="cd"``) at conv_tol 1e-12 against cctpu's host-f64
   oracle, the fused kernel every cycle; NH2 UB3LYP/6-31G* with Cholesky
   J/K (DF-J every cycle, DF-K twice) against its in-core SCF (<= 1e-8);
7b. phenol B3LYP/6-31G* in-core (grid level 2, conv_tol 1e-10) against
   cctpu's CPU-f64 in-core oracle (<= 1e-8 Ha): the ERI build's seconds
   and bytes, peak memory, s/cycle, no J/K kernel launched, and the DF
   fitting error |E_incore - E_DF| (printed, not gated);
7c. the same SCF with Cholesky J/K against 7b (<= 1e-8 Ha), the number
   of Cholesky vectors K, the fused kernel every cycle; the fused, DF-J
   (one and two densities) and DF-K kernels against their plain versions
   at this SCF's factor [K, nao, nao] (f64 <= 1e-12, repeats bitwise) with
   kernel, plain, library and bound times;
7d. the direct nuclear gradient of 7b's SCF, as 3e (no oracle: a central
   difference at O y, invariance, bitwise repeat, s/iter), and that of 7c's
   Cholesky SCF against it (<= 1e-7 Ha/bohr);
7e. phase 6's three cases in-core against cctpu's CPU-f64 in-core
   gradients (<= 1e-7 Ha/bohr; ``scripts/make_incore_oracles.py``);
7f. the ``energy`` CLI without ``--density-fit`` (the default route,
   in-core: no J/K kernel) on phenol and the phenoxyl radical, then on
   phenol twice with ``--scf-cache``: the second run warm-starts, takes
   fewer cycles and agrees (<= 1e-10 Ha);
8. geometry optimization (``cctpu_torch.geomopt.optimizer.optimize``):
   water DF-B3LYP/6-31G* (grid level 2, conv_tol 1e-12, orbital gradient
   <= 1e-8) from cctpu's tests/test_geomopt.py start, twice: against
   cctpu's CPU-f64 ``optimize`` on the same inputs (the same steps, every
   step's energy <= 1e-8 Ha, final coordinates <= 1e-5 bohr), the two
   runs' final coordinates bitwise equal, the fused kernel every cycle;
8b. the same for the NH2 radical, DF-UB3LYP (DF-J every cycle, DF-K
   twice a cycle);
8c. phenol DF-B3LYP/6-31G* from bench.py's geometry (grid level 2,
   phase 3e's conv_tol): step 0's energy against ``PHENOL_E_CONV``
   (<= 1e-8 Ha) and gradient against cctpu's (<= 1e-7 Ha/bohr),
   converged within 30 steps, the final projected gmax < 4.5e-4 and the
   energy below the start; steps, SCF cycles, s/step and its split into
   ``setup``, ``scf``, ``gradient`` and ``step``, fused launches equal
   to the cycles, and the peak device memory of each step (no growth);
8d. water FD Hessians with dipole derivatives (``hessian_auto``) at 8's
   final coordinates as cctpu reached them: B3LYP frequencies <= 0.05
   cm^-1 and IR intensities <= 1e-3 relative from cctpu's ``hessian_fd``,
   ZPE, E_0K, H and G <= 1e-6 Ha from cctpu's ``thermo``; in-core RHF
   the Hessian <= 5e-5 Ha/bohr^2 and real frequencies <= 1 cm^-1 from
   cctpu's analytic (CPHF) Hessian (cctpu's B3LYP and DF analytic
   Hessians did not finish on the CPU: see scripts/make_opt_oracles.py);
8e. the ``opt`` (``--skip-freq``: its frequencies are 10e's) and
   ``opt-freq`` CLIs on water on their default routes (in-core): rc 0,
   the xyz, csv and report files, converged, no imaginary mode.

9. ``df_k`` at phenol's B_lr (9a's SCF; wB97X-D, omega 0.2, the
   attenuated metric factored at rcond 1e-10) against its plain version
   (f64 <= 1e-12 relative, repeats bitwise equal), kernel / plain /
   library / bound times, B_lr's rows, bytes and build seconds;
9a. phenol DF-wB97X-D/6-31G* (grid level 2, conv_tol 1e-10) against
   cctpu's oracle (<= 1e-8 Ha), its dispersion energy, the fused kernel
   and ``df_k`` (K_lr) each once a cycle, s/cycle beside phase 3's B3LYP;
9b. its gradient as 3e (conv_tol 1e-12): cctpu's CPU-f64 gradient
   (<= 1e-7), three central differences (<= 1e-6), invariance, bitwise
   repeat, no J/K launch, the seconds of each term (``3c_lr``, ``2c_lr``
   and ``disp`` among them), peak memory and s/iter;
9c. phenol DF-M06-2X/6-31G* (meta-GGA) against its oracle, water
   DF-M06-2X's energy and gradient against cctpu's;
9d. NH2 DF-UwB97X-D/6-31G* from its UB3LYP density: energy and gradient
   against cctpu's (the same start), ``df_j`` once and ``df_k`` four times
   a cycle;
9e. water/6-31G* DF energies of LDA, ``lda,vwn3``, PW92, PBE, PBE0,
   B3LYP5, M06, CAM-B3LYP and ``b3lyp-d`` against their oracles, and
   CAM-B3LYP's gradient against cctpu's; wB97X-D in core (no kernel) and
   with Cholesky J/K against theirs, and both gradients against cctpu's;
9f. the ``energy`` CLI with ``--method wb97x-d`` on phenol in core and
   with ``--density-fit`` (against the Python API's SCF at the CLI's own
   geometry, <= 1e-10 Ha), and the ``opt`` CLI on water with CAM-B3LYP.

10. MP2 (6-31G*, SCFs at conv_tol 1e-12): water RMP2 in core and on its
   Cholesky factor, NH2 UMP2 in core, phenol DF-RHF then MP2 on its B;
   e_corr against cctpu's CPU-f64 MP2 (<= 1e-8 Ha), MP2 seconds and peak
   memory;
10a. ``energy --method mp2 --density-fit`` on phenol: the printed
   correlation energy against the Python API's at the CLI's geometry
   (<= 1e-10 Ha);
10b. the ``bde`` CLI on ethane (HF/STO-3G, --limit 1), on hydrazine
   (B3LYP/6-31G* at --tier b3lyp: the parent and both NH2 optimized;
   ethane's methyl radical makes the optimizer diverge in both packages)
   and on phenol
   (B3LYP/6-31G*, --density-fit, --limit 2: C-O and O-H): every BDE
   against cctpu's serial path (<= 1e-3 kcal/mol);
10c. ``bde --smiles Oc1ccccc1 --limit 2`` at its defaults (M06-2X/
   def2-TZVP, DF by size, nao 253): rc 0, the CSV, both bonds, all three
   kernels launched, s per SCF, peak memory (no oracle: cctpu's CPU cost
   is out of reach); then the kernels against their plain versions at the
   parent SCF's own factor, as 7c;
10d. the ``reaction`` CLI on "O + [H+] -> [OH3+]" at its defaults (with
   FD frequencies, in core) and on "OO + 2[H] -> 2O" with --density-fit
   --skip-freq: dE, dE0, dH and dG against cctpu's (<= 0.01 kcal/mol);
10e. ``ir --smiles O`` at its defaults: frequencies <= 0.05 cm^-1 and
   intensities <= 1e-3 relative from cctpu's FD route, the table written,
   the PNG written or skipped (no matplotlib);
10f. ``interaction --smiles O --smiles2 O`` at its defaults (MP2/6-31+G*,
   3.5 A, counterpoise) and with --scan over 3.0-4.0 A: E_int (CP), raw
   and BSSE against cctpu's serial path (<= 1e-4 kcal/mol).

The oracles of 8, 8b and 8d (``OPT_ORACLES``) come from
``python scripts/make_opt_oracles.py <case>``, those of 9a-9e
(``RSH_ORACLES``) from ``python scripts/make_rsh_oracles.py <case>``,
those of 10-10f (``WORKFLOW_ORACLES``) from
``python scripts/make_workflow_oracles.py <case>``.

Any failure raises: the script then exits non-zero without its last line.
The line before the last lists each kernel with its launches on the main
path, its error, its time beside its plain version's and its bound, and
its launches on the Cholesky phases (7, 7c) and its numbers at 7c's
factor, its launches in the optimizations (8-8c), the FD Hessian (8d)
and the range-separated SCFs (9a, 9c-9e), its launches in the
workflows (10-10f) and its numbers at 10c's def2-TZVP factor, and
``df_k``'s numbers at B_lr (9); a ``clock`` line after each group of
phases gives the seconds since the start. The last line is
``{"ok": true, "device": {...}}``. Needs no network and imports nothing
of JAX or of the JAX package.
"""

import os
import tempfile
import time

import numpy as np

from cctpu_torch.utils.measure import (C16H34_SHAPE, F64_SHAPES, H_ATOM,
                                       KERNEL_SHAPES, NH2, NH2_START,
                                       PHENOL, PHENOXYL, TOL, WATER,
                                       WATER_START, alkane, alternated_ms,
                                       bound, card_line, cuda_ms,
                                       device_inputs, emit, k_library,
                                       rel_err, work)

# cctpu's host-f64 oracles (scripts/sad_oracles.json)
PHENOL_E_CONV = -307.45793638428           # DF-B3LYP/6-31G*, grid level 2
C16H34_E_SAD = -649.7264470874134          # SAD density, one Fock build
# cctpu's host-f64 oracles of the open-shell slice, made on the CPU with
# cctpu's f64 path (JAX on the CPU, x64 on), all DF, 6-31G*, grid level 2,
# conv_tol 1e-10, with the geometries of cctpu_torch/utils/measure.py:
#   cctpu.dft.rks.UKS(Molecule.from_atoms(PHENOXYL, spin=1,
#       basis="6-31g*"), xc="b3lyp", density_fit=True, grid_level=2,
#       conv_tol=1e-10).kernel()        (19 cycles, <S^2> 0.78362916)
#   the same with H_ATOM                (8 cycles, <S^2> 0.75)
#   cctpu.dft.rks.RKS(Molecule.from_atoms(PHENOL, basis="6-31g*"),
#       xc="blyp", density_fit=True, grid_level=2,
#       conv_tol=1e-10).kernel()        (13 cycles)
PHENOXYL_E_CONV = -306.8112830449618       # DF-UB3LYP, spin 1
H_ATOM_E_CONV = -0.5002727849165448        # DF-UB3LYP, spin 1 (nbeta 0)
PHENOL_BLYP_E_CONV = -307.3327949020669    # DF-BLYP (RKS, pure GGA)
HARTREE2KCAL = 627.5094740631
# cctpu's host-f64 water RHF/6-31G energy with Cholesky J/K (tol 1e-9) at
# conv_tol 1e-12 (scripts/sad_oracles.json, make_oracles.py --cd)
WATER_CD_631G_E = -75.98397447271235

# cctpu's CPU-f64 DF nuclear gradients (Ha/bohr, atoms in the order of
# the geometries of cctpu_torch/utils/measure.py), as
# scripts/make_grad_oracles.py prints them: cctpu's own SCF on the CPU, f64,
# 6-31G*, DF, grid level 2, conv_tol 1e-12 and conv_tol_grad 1e-8
#   cctpu.scf.hf.RHF(Molecule.from_atoms(WATER, basis="6-31g*"),
#       density_fit=True, conv_tol=1e-12, conv_tol_grad=1e-8).kernel()
#   cctpu.dft.rks.RKS(..., xc="b3lyp", grid_level=2, ...) for water and
#   phenol, cctpu.dft.rks.UKS(..., spin=1, ...) for NH2 and phenoxyl
# then cctpu's gradient terms on that state with the W/Z assembly in f64
# (tests/test_torch_grad.py::cctpu_gradient_terms: jax.grad of the 1e
# Lagrangian, df_grad._wz_fn, _grad_3c, _grad_2c, jax.grad of
# exc_of_coords and of energy_nuc).
GRAD_ORACLES = {
    "water_rhf": [  # E -76.00910724668111, 17 cycles
        [-1.300118072847e-15, -7.605959387095e-15, 1.533059763857e-02],
        [3.610124625890e-16, 7.549648962516e-03, -7.665298819289e-03],
        [9.391056102516e-16, -7.549648962507e-03, -7.665298819284e-03],
    ],
    "water_b3lyp": [  # E -76.40680895083193, 11 cycles
        [-1.695622886898e-15, -6.508946484266e-15, -1.334129928567e-02],
        [4.918640799434e-16, -8.075329095749e-03, 6.670649642828e-03],
        [9.322041531722e-16, 8.075329095760e-03, 6.670649642835e-03],
    ],
    "nh2_ub3lyp": [  # E -55.87099329938432, 13 cycles
        [9.339794694304e-16, -2.837753140487e-15, 1.051084907173e-02],
        [-3.371703865472e-16, -4.967647857019e-03, -5.255424535868e-03],
        [-3.308915293584e-16, 4.967647857018e-03, -5.255424535868e-03],
    ],
    "phenol_b3lyp": [  # E -307.4579363842764, 28 cycles
        [-1.018994204228e-02, -2.581698375805e-03, 8.271790139666e-16],
        [-3.665335851295e-04, 9.471976053186e-03, -2.458738201980e-15],
        [3.926002036542e-03, -2.421311207539e-03, 1.519661523331e-15],
        [-5.506845270997e-04, 1.664537105594e-03, -6.329518923870e-16],
        [-6.596055348907e-03, -4.257392298044e-03, -1.148741616590e-15],
        [6.383750075623e-03, 1.457060415189e-04, -7.868266487555e-16],
        [-5.411729583405e-03, -8.406784474742e-03, -8.201750286209e-17],
        [1.583461286211e-02, 8.707278880831e-03, -2.871180615716e-16],
        [-2.105424047995e-03, -1.904117267316e-03, 4.236041959063e-16],
        [-1.224265621893e-03, 8.267799524253e-05, -1.846844719162e-16],
        [-1.725298385953e-04, 2.439917793365e-03, 1.221903678751e-16],
        [1.185871784454e-03, -3.878735231395e-04, -2.064647238408e-16],
        [-7.130721635820e-04, -2.552916723191e-03, 1.646705984085e-16],
    ],
    "phenoxyl_ub3lyp": [  # E -306.8112830449596, 38 cycles
        [-2.490626359290e-14, -8.668874262455e-02, 1.511485861179e-15],
        [-2.140875416551e-02, 2.281653153176e-02, -1.445921906585e-15],
        [-5.053817671882e-03, -1.048776882051e-02, -3.527424918998e-16],
        [9.103559789532e-14, 1.894213986636e-03, -1.864792459099e-15],
        [5.053817671842e-03, -1.048776882064e-02, 2.127959066856e-15],
        [2.140875416553e-02, 2.281653153174e-02, -4.021560814882e-16],
        [1.014899638455e-14, 6.278018882143e-02, -1.645638010138e-15],
        [1.764181194068e-03, -2.959050883822e-03, 9.549206603493e-17],
        [-8.656971850147e-04, 3.707586080817e-04, 1.150757638468e-16],
        [-5.999852481841e-14, 2.533398945537e-03, -1.599865692949e-16],
        [8.656971849588e-04, 3.707586081474e-04, -1.714855791982e-17],
        [-1.764181194071e-03, -2.959050883824e-03, 2.001100869891e-16],
    ],
}

# cctpu's CPU-f64 in-core energies and gradients (Ha, Ha/bohr; atoms in the
# order of the geometries of cctpu_torch/utils/measure.py), as
# scripts/make_incore_oracles.py prints them: cctpu's own in-core SCF
# (density_fit=False) on the CPU, f64, 6-31G*, grid level 2; the phenol
# energy at conv_tol 1e-10, the gradients at conv_tol 1e-12 and
# conv_tol_grad 1e-8 with the direct 2e term (energy_2e_grad_eager)
INCORE_ORACLES = {
    "phenol_b3lyp_e": -307.4579388407727,  # 13 cycles
    "water_rhf": [  # E -76.00910803237772, 13 cycles
        [6.069051815553e-18, -5.593012500372e-16, 1.533057327717e-02],
        [-1.670947013622e-16, 7.549448002473e-03, -7.665286638586e-03],
        [1.610256495467e-16, -7.549448002474e-03, -7.665286638585e-03],
    ],
    "water_b3lyp": [  # E -76.40680806839366, 12 cycles
        [1.593011044092e-16, -8.558997566528e-16, -1.334051657107e-02],
        [1.547310024151e-16, -8.075190183554e-03, 6.670258285535e-03],
        [-1.112955319600e-16, 8.075190183554e-03, 6.670258285535e-03],
    ],
    "nh2_ub3lyp": [  # E -55.87099286186214, 11 cycles
        [-4.989477434641e-16, -9.008847994253e-16, 1.051038136688e-02],
        [-2.406550481914e-17, -4.967530979394e-03, -5.255190683439e-03],
        [-1.949822515900e-17, 4.967530979396e-03, -5.255190683440e-03],
    ],
}

# cctpu's CPU-f64 optimizations and water Hessians (Ha, bohr, cm^-1,
# km/mol), as scripts/make_opt_oracles.py prints them: cctpu's own SCFs on
# the CPU, f64, DF, 6-31G*, grid level 2, conv_tol 1e-12 and conv_tol_grad
# 1e-8 (``OPT_SCF``); cctpu.geomopt.optimizer.optimize from WATER_START
# (RKS) and NH2_START (UKS) of cctpu_torch/utils/measure.py; at water's
# final coordinates cctpu.hessian.frequencies.hessian_fd (dipoles on),
# harmonic_analysis and thermo, and cctpu.hessian.cphf.analytic_hessian of
# the in-core RHF SCF there (conv_tol 1e-12, conv_tol_grad 1e-8)
OPT_SCF = dict(xc="b3lyp", density_fit=True, grid_level=2, conv_tol=1e-12,
               conv_tol_grad=1e-8, max_cycle=100)
OPT_ORACLES = {
    "water_b3lyp": {
        "nsteps": 6,
        "energies": [-76.39498399463405, -76.40607177575679,
                     -76.40692225353472, -76.40702432744916,
                     -76.40702553976907, -76.40702555932097],
        "coords": [
            [-3.349349095144368e-17, 0.04112477427631786,
             0.020181576577490087],
            [-4.596034594498731e-19, 0.07703664113527638, 1.850330579996156],
            [-5.441026998952019e-19, 1.8093592316447682, -0.4532175631498499],
        ],
    },
    "nh2_ub3lyp": {
        "nsteps": 5,
        "energies": [-55.86616305552145, -55.87084779854199,
                     -55.87113451265882, -55.871145285639656,
                     -55.87114586541877],
        "coords": [
            [-1.7365737527252144e-19, -0.03931405552624576,
             0.004332804176407204],
            [4.332596434255811e-21, 0.09191991483922714, 1.9538259896868166],
            [-2.6713292398098765e-21, 1.8371202652520806, -0.540864200439427],
        ],
    },
    "water_rhf_analytic": {
        "freq_cm": [1885.9509766554227, 3776.862548060629, 3876.191403977385],
        "hessian": [
            [0.02613642703070229, -1.0640466591440739e-16,
             6.194585270395218e-17, -0.013067252779336402,
             2.282722250490238e-16, -3.0997065121290935e-16,
             -0.013069174251365473, -1.3363058530472914e-16,
             2.1022064513667634e-16],
            [-1.0640466591440739e-16, 0.5558577935603561,
             -0.08556409175915788, -7.285826749178911e-17,
             -0.0689723304169785, 0.01691819625244459,
             1.7527692062454754e-16, -0.48688546314477354,
             0.06864589567474999],
            [6.194585270395218e-17, -0.08556409175915788, 0.6053058104607884,
             -2.054377122811975e-16, -0.05207411065484811,
             -0.5116153154404506, 1.463958565850445e-16, 0.1376382026821866,
             -0.09369049524017198],
            [-0.013067252779336402, -7.285826749178911e-17,
             -2.054377122811975e-16, 0.011990851829617899,
             -1.427573667542622e-17, 2.7570366125618467e-16,
             0.001076400949724294, 1.0162819624247438e-16,
             -5.773382340058218e-17],
            [2.282722250490238e-16, -0.0689723304169785,
             -0.05207411065484811, -1.427573667542622e-17,
             0.06931284634399004, -0.007792613949399188,
             -2.1304051006420673e-16, -0.00034051598979774854,
             0.059866724565250676],
            [-3.0997065121290935e-16, 0.01691819625244459,
             -0.5116153154404506, 2.7570366125618467e-16,
             -0.007792613949399188, 0.526612937266814, 3.235829663529393e-17,
             -0.009125582429060891, -0.014997621778827658],
            [-0.013069174251365473, 1.7527692062454754e-16,
             1.463958565850445e-16, 0.001076400949724294,
             -2.1304051006420673e-16, 3.235829663529393e-17,
             0.011992773301641613, 3.50324235345107e-17,
             -1.5348212542246286e-16],
            [-1.3363058530472914e-16, -0.48688546314477354,
             0.1376382026821866, 1.0162819624247438e-16,
             -0.00034051598979774854, -0.009125582429060891,
             3.50324235345107e-17, 0.4872259791987483, -0.1285126203821657],
            [2.1022064513667634e-16, 0.06864589567474999,
             -0.09369049524017198, -5.773382340058218e-17,
             0.059866724565250676, -0.014997621778827658,
             -1.5348212542246286e-16, -0.1285126203821657,
             0.10868811719129429],
        ],
    },
    "water_b3lyp_fd": {
        "E": -76.40702555932104,
        "freq_cm": [1710.7837712149158, 3721.04774789716, 3844.932113587724],
        "ir_km_mol": [3.449389274119287, 0.07645731666437187,
                      0.8719469596467951],
        "ZPE": 0.021134022586300753,
        "E_0K": -76.38589153673475,
        "H_tot": -76.38211277265498,
        "G_tot": -76.404212284457,
        "hessian": [
            [7.778279343534367e-06, -8.058891040143071e-10,
             -4.936910147489003e-10, -3.790738700056571e-06,
             2.5766568790698545e-10, 3.8598827762853276e-10,
             -3.952798229968986e-06, 5.468223610697194e-10,
             1.1029921386401996e-10],
            [-8.058891040143071e-10, 0.5209975766340968,
             -0.09579492000401368, 3.765692949032843e-09,
             -0.0493315074902613, 0.02091897276260135, 4.078008185741034e-11,
             -0.4716659306719384, 0.07487619520354927],
            [-4.936910147489003e-10, -0.09579492000401368,
             0.5763767171824974, 2.5674447132225497e-09,
             -0.047139958763816464, -0.4993503732151766,
             1.041434088248586e-10, 0.14293454111874437, -0.0770263883635991],
            [-3.790738700056571e-06, 3.765692949032843e-09,
             2.5674447132225497e-09, 4.7197282911206955e-06,
             -1.2031048293036179e-09, -2.0633386010157737e-09,
             -9.466908656469485e-07, -2.5614585358471994e-09,
             -5.054201864466756e-10],
            [2.5766568790698545e-10, -0.0493315074902613,
             -0.047139958763816464, -1.2031048293036179e-09,
             0.05248151403695195, -0.00811127869865258,
             -3.121978479184098e-11, -0.003149977874560006,
             0.055251141766056444],
            [3.8598827762853276e-10, 0.02091897276260135,
             -0.4993503732151766, -2.0633386010157737e-09,
             -0.00811127869865258, 0.5147604674223261,
             -7.916966093484417e-11, -0.012807425673194706,
             -0.015410103341835513],
            [-3.952798229968986e-06, 4.078008185741034e-11,
             1.041434088248586e-10, -9.466908656469485e-07,
             -3.121978479184098e-11, -7.916966093484417e-11,
             4.882448397620573e-06, -9.320920255494792e-12,
             -2.7588732564690907e-11],
            [5.468223610697194e-10, -0.4716659306719384, 0.14293454111874437,
             -2.5614585358471994e-09, -0.003149977874560006,
             -0.012807425673194706, -9.320920255494792e-12,
             0.4748157414060372, -0.1301272677120477],
            [1.1029921386401996e-10, 0.07487619520354927,
             -0.0770263883635991, -5.054201864466756e-10,
             0.055251141766056444, -0.015410103341835513,
             -2.7588732564690907e-11, -0.1301272677120477,
             0.09243654524702938],
        ],
    },
}

# cctpu's CPU-f64 energies and gradients of the range-separated slice (Ha,
# Ha/bohr; atoms in the order of the geometries of
# cctpu_torch/utils/measure.py), as scripts/make_rsh_oracles.py prints
# them: cctpu's own SCFs on the CPU, f64, 6-31G*, grid level 2, DF unless
# named in-core or Cholesky (cd); energies (_e) at conv_tol 1e-10,
# gradients at conv_tol 1e-12 and conv_tol_grad 1e-8 with every term in
# f64 (the long-range 3c/2c terms on B_lr, the direct long-range term in
# core, the dispersion gradient); NH2 from its converged UB3LYP density
RSH_ORACLES = {
    "phenol_wb97xd_e": -306.8784916717092,  # 13 cycles, E_disp -4.840316e-03
    "phenol_wb97xd": {  # 22 cycles, E_disp -4.840316e-03
        "E": -306.87849167172055,
        "grad": [
            [-9.935144470656e-03, -3.707765995541e-03, 1.191634960731e-15],
            [1.635537691398e-02, 1.734343529414e-02, -8.618930010596e-16],
            [2.039164866519e-02, -1.193567927349e-02, 3.078053504809e-15],
            [-6.860229237869e-04, -1.744600464901e-02, 2.156322166536e-16],
            [-2.288268414399e-02, -1.377725810577e-02, 1.503550385188e-15],
            [-1.076956949471e-02, 9.040578151487e-03, -3.478040983713e-16],
            [-9.015325996884e-03, 1.587859627126e-02, 2.575270529149e-15],
            [1.939448867825e-02, 1.090943360088e-02, -3.744328231551e-16],
            [8.107661191667e-04, -6.372133168918e-04, 6.104869884496e-16],
            [1.526096225721e-03, -1.482252263590e-03, -4.829745758818e-16],
            [-1.662506394084e-04, -8.195670972361e-04, 2.456698651413e-16],
            [-1.509428470753e-03, -1.866366074340e-03, 2.116262271246e-16],
            [-3.513950462035e-03, -1.499936541810e-03, 9.735894040315e-18],
        ],
    },
    "phenol_m062x_e": -307.3248754910387,  # 13 cycles, E_disp 0.000000e+00
    "water_m062x": {  # 11 cycles, E_disp 0.000000e+00
        "E": -76.37212643113494,
        "grad": [
            [-1.351846176375e-15, -7.202294275280e-15, -9.245053725354e-03],
            [4.079807363979e-16, -6.508136301330e-03, 4.622526862675e-03],
            [1.022188682029e-15, 6.508136301339e-03, 4.622526862681e-03],
        ],
    },
    "nh2_uwb97xd": {  # 14 cycles, E_disp -3.819412e-05
        "E": -55.750457357168294,
        "grad": [
            [5.179394601029e-16, -1.462750787905e-15, 4.501253447141e-03],
            [-3.729723318507e-16, -2.440744248751e-03, -2.250626723570e-03],
            [-2.539509819925e-16, 2.440744248753e-03, -2.250626723569e-03],
        ],
    },
    "water_wb97xd_incore": {  # 12 cycles, E_disp -2.683122e-05
        "E": -76.2944557739467,
        "grad": [
            [-1.642029028340e-16, -2.835021709446e-16, -7.106807340151e-03],
            [8.911606420611e-17, -4.981121353423e-03, 3.553403670079e-03],
            [-1.209324986366e-16, 4.981121353424e-03, 3.553403670079e-03],
        ],
    },
    "water_wb97xd_cd_e": -76.29445577394547,  # 10 cycles, E_disp -2.683122e-05
    "water_wb97xd_cd": {  # 11 cycles, E_disp -2.683122e-05
        "E": -76.29445577394546,
        "grad": [
            [2.859107335939e-16, 2.046423762564e-16, -7.106807199747e-03],
            [-3.346220564143e-17, -4.981121281965e-03, 3.553403599880e-03],
            [2.853358996734e-17, 4.981121281967e-03, 3.553403599880e-03],
        ],
    },
    "water_lda_e": -75.84095356567761,  # 9 cycles, E_disp 0.000000e+00
    "water_lda_vwn3_e": -76.03637556091951,  # 9 cycles, E_disp 0.000000e+00
    "water_pw92_e": -75.83814239447301,  # 9 cycles, E_disp 0.000000e+00
    "water_pbe_e": -76.31981083667148,  # 9 cycles, E_disp 0.000000e+00
    "water_pbe0_e": -76.32384215779321,  # 8 cycles, E_disp 0.000000e+00
    "water_b3lyp5_e": -76.36966955924855,  # 8 cycles, E_disp 0.000000e+00
    "water_m06_e": -76.37377358996682,  # 8 cycles, E_disp 0.000000e+00
    "water_camb3lyp_e": -76.41520246399854,  # 9 cycles, E_disp 0.000000e+00
    "water_camb3lyp": {  # 12 cycles, E_disp 0.000000e+00
        "E": -76.41520246399877,
        "grad": [
            [-2.030806152599e-15, -1.020565943843e-14, -1.030190234410e-02],
            [4.948045064059e-16, -6.903555144173e-03, 5.150951172047e-03],
            [9.357436114512e-16, 6.903555144183e-03, 5.150951172057e-03],
        ],
    },
    "water_b3lypd_e": -76.40684663187416,  # 8 cycles, E_disp -3.768104e-05
}
WATER_XC = ("lda", "lda,vwn3", "pw92", "pbe", "pbe0", "b3lyp5", "m06",
            "cam-b3lyp", "b3lyp-d")

# cctpu's CPU-f64 results of the workflows of phases 10-10f, as
# ``python scripts/make_workflow_oracles.py <case>`` prints them (one
# process a case): cctpu's own workflow functions on the CPU, at the
# port's embedded coordinates, on cctpu's serial paths, with its FD
# Hessian route; energies in Ha, BDEs in kcal/mol. MP2: cctpu's SCF at
# conv_tol 1e-12 and conv_tol_grad 1e-9 (6-31G*, the geometries of
# cctpu_torch/utils/measure.py), then cctpu.mp.mp2.MP2.
WORKFLOW_ORACLES = {
    "mp2_water_incore": {  # cctpu on the CPU: 32.9 s
        "e_scf": -76.00910803237767,
        "e_corr": -0.18622962344910443,
        "cycles": 22,
    },
    "mp2_water_cd": {  # cctpu on the CPU: 37.7 s
        "e_scf": -76.00910803237353,
        "e_corr": -0.18622962345110483,
        "cycles": 26,
    },
    "mp2_nh2_incore": {  # cctpu on the CPU: 44.9 s
        "e_scf": -55.55673345103358,
        "e_corr": -0.1334634041577333,
        "cycles": 41,
    },
    "mp2_phenol_df": {  # cctpu on the CPU: 318.1 s
        "e_scf": -305.55312738246016,
        "e_corr": -0.9426783514796734,
        "cycles": 62,
    },
    "t_bde_ethane": {  # cctpu on the CPU: 12.6 s
        "e_parent": -78.30286822229425,
        "bde": {"C0-C1": 103.44332676648965},
    },
    "bde_hydrazine_b3lyp_tier": {  # cctpu on the CPU: 897.8 s
        "e_parent": -111.85412829630233,
        "bde": {"N0-N1": 70.18019224552494},
    },
    "bde_phenol_b3lyp": {  # cctpu on the CPU: 813.0 s
        "e_parent": -307.42144313991565,
        "bde": {"O0-C1": 110.22830513799325, "O0-H7": 89.42266796188699},
    },
    "reaction_h3o": {  # cctpu on the CPU: 1601.1 s
        "dE": -0.2686412183248592,
        "dE0": -0.25548713986979976,
        "dH": -0.2577932962145155,
        "dG": -0.24631846857515427,
    },
    "reaction_h_df": {  # cctpu on the CPU: ~13 min a species
        "dE": -0.29809579570033407,
        "dE0": -0.29809579570033407,
        "dH": -0.3028167184754409,
        "dG": -0.2780964329312212,
    },
    "ir_water": {  # cctpu on the CPU: 1106.0 s
        "e_opt": -76.40702410755149,
        "nsteps": 4,
        "freq": [1710.8169854546622, 3721.147681980161, 3844.9547669428225],
        "ir": [3.4497343764841957, 0.07649826862737599, 0.8717895016239301],
    },
    "interaction_water": {  # cctpu on the CPU: 119.8 s
        "e_cp": 0.003214608982887057,
        "e_raw": 0.0024280348249305916,
        "bsse": 0.0007865741579564656,
    },
    "interaction_scan": {  # cctpu on the CPU: 162.2 s
        "scan": [0.006736831635407725, 0.0032145803596392852,
            0.0018821844157770329],
    },
}


def water_key(xc: str) -> str:
    """The ``RSH_ORACLES`` key of water's DF energy with ``xc``."""
    return f"water_{xc.replace(',', '_').replace('-', '')}_e"



def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def jk_inputs(naux, nao, nocc, seed, dtype, dev):
    import torch
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((naux, nao, nao))
    C = rng.standard_normal((nao, nocc))
    D = 2 * C @ C.T
    return tuple(torch.as_tensor(x, dtype=dtype, device=dev)
                 for x in (B, D, C))


def wk_report(module, lib: str) -> dict:
    """The plan of ``module``'s last launch and the ptxas registers and
    spills of the f64 tensor-core instantiations of library ``lib``."""
    from cctpu_torch.ops import build
    return {"plan": module.LAST_PLAN,
            "ptxas_f64": build.ptxas_report(lib, "wk_mma")}


def ops():
    from cctpu_torch.ops import df_j, df_jk, df_k
    return {"df_jk_fused": df_jk, "df_j": df_j, "df_k": df_k}


def reset_counts():
    for m in ops().values():
        m.LAUNCHES = 0


def counts() -> dict:
    return {name: m.LAUNCHES for name, m in ops().items()}


def phase_kernel(df_jk, dev):
    """Kernel vs plain torch at the four shapes; returns phenol numbers."""
    import torch
    out = {}
    for naux, nao, nocc in KERNEL_SHAPES + F64_SHAPES:
        for dtype in (torch.float64, torch.float32):
            if (naux, nao, nocc) in F64_SHAPES and dtype != torch.float64:
                continue
            make = device_inputs if nao >= 600 else jk_inputs
            B, D, C = make(naux, nao, nocc, naux, dtype, dev)
            J, K = df_jk.df_jk_fused(B, D, C)
            J2, K2 = df_jk.df_jk_fused(B, D, C)
            Jr, Kr = df_jk.df_jk_reference(B, D, C)
            torch.cuda.synchronize()
            name = str(dtype).split(".")[-1]
            ej, ek = rel_err(J, Jr), rel_err(K, Kr)
            bitwise = bool(torch.equal(J, J2) and torch.equal(K, K2))
            max_abs = float(max((J - Jr).abs().max(), (K - Kr).abs().max()))
            emit({"phase": "kernel", "shape": [naux, nao, nocc],
                  "dtype": name, "rel_err_J": ej, "rel_err_K": ek,
                  "max_abs_err": max_abs, "bitwise_repeat": bitwise,
                  "tol": TOL[name], "plan": df_jk.LAST_PLAN["kind"]})
            check(max(ej, ek) <= TOL[name],
                  f"kernel disagrees at {naux}/{nao}/{nocc} {name}")
            check(bitwise, f"repeat calls differ at {naux}/{nao}/{nocc}")
            if (naux, nao, nocc) == KERNEL_SHAPES[-1] \
                    and dtype == torch.float64:
                out["max_abs_err"] = max_abs
                out.update(alternated_ms(
                    lambda: df_jk.df_jk_fused(B, D, C),
                    lambda: df_jk.df_jk_reference(B, D, C), 10))
                out.update(bound(*work("df_jk_fused", naux, nao, nocc)))
                emit({"phase": "kernel_time", "shape": [naux, nao, nocc],
                      "dtype": name, "kernel_ms": out["kernel_ms_rounds"],
                      "plain_ms": out["plain_ms_rounds"],
                      "bound_ms": out["bound_ms"],
                      **wk_report(df_jk, "df_jk_fused")})
            del B, D, C, J, K, J2, K2, Jr, Kr
            torch.cuda.empty_cache()
    return out


def phase_kernel_j_k(dev):
    """DF-J (nset 1 and 2) and DF-K vs their plain versions at the five
    shapes, f64 and f32; kernel vs plain times at phenol's shape (f64)."""
    import torch
    from cctpu_torch.ops import df_j, df_k
    for shape in KERNEL_SHAPES + F64_SHAPES + [C16H34_SHAPE]:
        naux, nao, nocc = shape
        for dtype in (torch.float64, torch.float32):
            if shape in F64_SHAPES and dtype != torch.float64:
                continue
            name = str(dtype).split(".")[-1]
            make = device_inputs if nao >= 292 else jk_inputs
            B, D, C = make(naux, nao, nocc, naux + 7, dtype, dev)
            D2 = torch.stack([D, D @ D / D.abs().max()])
            J1 = df_j.df_j_fast(B, D)
            plan_j = [df_j.LAST_PLAN["kind"]]
            J2 = df_j.df_j_fast(B, D2)
            plan_j.append(df_j.LAST_PLAN["kind"])
            K = df_k.df_k_fast(B, C)
            bitwise = bool(torch.equal(J1, df_j.df_j_fast(B, D))
                           and torch.equal(J2, df_j.df_j_fast(B, D2))
                           and torch.equal(K, df_k.df_k_fast(B, C)))
            zero = torch.zeros((nao, 1), dtype=dtype, device=dev)
            k_zero = int(torch.count_nonzero(df_k.df_k_fast(B, zero)))
            J1r = df_j.df_j_reference(B, D)
            J2r = df_j.df_j_reference(B, D2)
            Kr = df_k.df_k_reference(B, C)
            torch.cuda.synchronize()
            errs = {"rel_err_J1": rel_err(J1, J1r),
                    "rel_err_J2": max(rel_err(J2[s], J2r[s])
                                      for s in range(2)),
                    "rel_err_K": rel_err(K, Kr)}
            emit({"phase": "kernel_j_k", "shape": list(shape),
                  "dtype": name, **errs, "bitwise_repeat": bitwise,
                  "k_of_zero_cocc_nonzeros": k_zero, "tol": TOL[name],
                  "plan": df_k.LAST_PLAN["kind"], "plan_df_j": plan_j})
            check(max(errs.values()) <= TOL[name],
                  f"df_j/df_k disagree at {shape} {name}: {errs}")
            check(bitwise, f"df_j/df_k repeat calls differ at {shape}")
            check(k_zero == 0, "df_k of a zero Cocc column is not 0")
            if shape == KERNEL_SHAPES[-1] and dtype == torch.float64:
                tj = alternated_ms(lambda: df_j.df_j_fast(B, D2),
                                   lambda: df_j.df_j_reference(B, D2), 10)
                tk = alternated_ms(lambda: df_k.df_k_fast(B, C),
                                   lambda: df_k.df_k_reference(B, C), 10)
                emit({"phase": "kernel_j_k_time", "shape": list(shape),
                      "dtype": name, "df_j_nset2_ms": tj,
                      "df_k_ms": tk, **wk_report(df_k, "df_k")})
            del B, D, C, D2, J1, J2, K, J1r, J2r, Kr
            torch.cuda.empty_cache()


def run_scf(cls, atoms, dev, spin=0, density_fit=True, basis="6-31g*",
            conv_tol=1e-10, dm0=None, max_cycle=60, **kw):
    """One SCF through the Python API (from ``dm0`` when given) with the
    kernels' launch counts reset just before and read just after; returns
    (mf, E, info). ``df_build_s`` is the J/K builder's build (DF tensors,
    the in-core tensor or the Cholesky factor), ``lr_build_s`` that of a
    range-separated functional's attenuated tensors (B_lr, or the
    attenuated in-core tensor); ``peak_mem_GB`` the card's peak over
    set-up and SCF."""
    import torch
    from cctpu_torch.core.molecule import Molecule
    mol = Molecule.from_atoms(atoms, spin=spin, basis=basis)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    mf = cls(mol, density_fit=density_fit, grid_level=2, conv_tol=conv_tol,
             max_cycle=max_cycle, device=dev, **kw)
    t_grid = time.time() - t0
    t0 = time.time()
    mf.get_jk_builder()
    torch.cuda.synchronize()
    t_df = time.time() - t0
    t0 = time.time()
    rsh = getattr(getattr(mf, "func", None), "rsh", None)
    if rsh is not None:
        mf._jk.prepare_lr(rsh[0])
    torch.cuda.synchronize()
    t_lr = time.time() - t0
    t0 = time.time()
    if hasattr(mf, "_prepare_xc_f64"):                 # RKS, UKS
        mf._prepare_xc_f64()
    torch.cuda.synchronize()
    t_ao = time.time() - t0
    reset_counts()
    t0 = time.time()
    e = mf.kernel(dm0=dm0)
    torch.cuda.synchronize()
    t_scf = time.time() - t0
    launches = counts()
    info = {"E": e, "converged": mf.converged, "cycles": mf.n_cycles,
            "s_per_cycle": t_scf / mf.n_cycles, "scf_s": t_scf,
            "grids_s": t_grid, "df_build_s": t_df, "lr_build_s": t_lr,
            "ao_cache_s": t_ao,
            "nao": mol.nao, "density_fit": density_fit,
            "launches": launches,
            "peak_mem_GB": torch.cuda.max_memory_allocated(dev) / 1e9}
    if hasattr(mf._jk, "B"):
        info["naux"] = int(mf._jk.B.shape[0])
    return mf, e, info


def scf_kernels(mf, names, B=None) -> dict:
    """The named kernels against their plain versions at an SCF's own
    factor B [naux, nao, nao] (or the given ``B``, such as its B_lr),
    density and occupied factor (f64, <= 1e-12 relative, repeats bitwise
    equal), with kernel / plain / library / bound times. ``df_j`` takes
    two densities: an open-shell SCF's two spins, else the density and a
    second one made from it; ``df_j_nset1`` the (alpha) density alone;
    ``df_k`` the (alpha) occupied factor."""
    import torch
    from cctpu_torch.ops import df_j, df_jk, df_k
    B = mf._jk.B if B is None else B
    dm = mf.dm.contiguous()
    C = mf._factor_cocc(dm)
    if dm.dim() == 3:
        D1, D2, C = dm[0], dm, C[0]
    else:
        D1, D2 = dm, torch.stack([dm, dm @ dm / dm.abs().max()]).contiguous()
    naux, nao, nocc = int(B.shape[0]), int(B.shape[1]), int(C.shape[1])
    calls = {
        "df_jk_fused": (lambda: df_jk.df_jk_fused(B, D1, C),
                        lambda: df_jk.df_jk_reference(B, D1, C), None,
                        work("df_jk_fused", naux, nao, nocc)),
        "df_j": (lambda: df_j.df_j_fast(B, D2),
                 lambda: df_j.df_j_reference(B, D2),
                 lambda: torch.einsum("pij,sij,pkl->skl", B, D2, B),
                 work("df_j", naux, nao, nset=2)),
        "df_j_nset1": (lambda: df_j.df_j_fast(B, D1),
                       lambda: df_j.df_j_reference(B, D1),
                       lambda: torch.einsum("pij,ij,pkl->kl", B, D1, B),
                       work("df_j", naux, nao, nset=1)),
        "df_k": (lambda: df_k.df_k_fast(B, C),
                 lambda: df_k.df_k_reference(B, C), lambda: k_library(B, C),
                 work("df_k", naux, nao, nocc))}
    out = {}
    for name in names:
        kern, plain, lib, wk = calls[name]
        got, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        got, again, ref = (x if isinstance(x, tuple) else (x,)
                           for x in (got, again, ref))
        rel = max(rel_err(a, b) for a, b in zip(got, ref))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        out[name] = {"max_abs_err": max(float((a - b).abs().max())
                                        for a, b in zip(got, ref)),
                     "rel_err": rel, "bitwise_repeat": bitwise,
                     **alternated_ms(kern, plain, 20, library=lib),
                     **bound(*wk)}
        if name in ("df_j", "df_j_nset1"):
            out[name]["plan"] = df_j.LAST_PLAN["kind"]
        check(rel <= TOL["float64"] and bitwise,
              f"{name} at {mf.__class__.__name__}'s [{naux}, {nao}, {nocc}] "
              f"factor: rel {rel:.2e}, bitwise {bitwise}")
    return out


def phase_phenol(dev):
    from cctpu_torch.dft.rks import RKS
    mf, e, info = run_scf(RKS, PHENOL, dev, xc="b3lyp")
    de = abs(e - PHENOL_E_CONV)
    launches = info["launches"]
    emit({"phase": "phenol_b3lyp_631gs", "abs_dE_vs_oracle": de, **info})
    check(mf.converged, "phenol SCF did not converge")
    check(de <= 1e-8, f"phenol |dE| {de:.3e} > 1e-8 Ha")
    check(launches["df_jk_fused"] >= mf.n_cycles,
          f"fused kernel launched {launches} in {mf.n_cycles} cycles")
    return e, launches["df_jk_fused"], mf, info


def phase_phenoxyl(dev):
    """DF-UB3LYP of the phenoxyl radical; then the J and K kernels timed
    and checked at this SCF's own B, densities and occupied factors."""
    import torch
    from cctpu_torch.dft.rks import UKS
    from cctpu_torch.ops import df_j, df_k
    mf, e, info = run_scf(UKS, PHENOXYL, dev, spin=1, xc="b3lyp")
    de = abs(e - PHENOXYL_E_CONV)
    s2 = mf.spin_square()[0]
    n = info["launches"]
    emit({"phase": "phenoxyl_ub3lyp_631gs", "abs_dE_vs_oracle": de,
          "S2": s2, "nalpha": mf.mol.nalpha, "nbeta": mf.mol.nbeta, **info})
    check(mf.converged, "phenoxyl SCF did not converge")
    check(de <= 1e-8, f"phenoxyl |dE| {de:.3e} > 1e-8 Ha")
    check(n["df_j"] >= mf.n_cycles and n["df_k"] >= 2 * mf.n_cycles
          and n["df_jk_fused"] == 0,
          f"phenoxyl launches {n} in {mf.n_cycles} cycles")
    check(df_j.LAST_PLAN["kind"] == "one_pass",
          f"phenoxyl's SCF ran df_j's {df_j.LAST_PLAN['kind']} plan")

    out = scf_kernels(mf, ("df_j", "df_k"))
    for name in ("df_j", "df_k"):
        out[name]["launches"] = n[name]
    B, dm = mf._jk.B, mf.dm.contiguous()
    cocc = mf._factor_cocc(dm)
    J, Jr = df_j.df_j_fast(B, dm), df_j.df_j_reference(B, dm)
    Kr = df_k.df_k_reference(B, cocc[0])
    emit({"phase": "phenoxyl_kernel_time", "naux": int(B.shape[0]),
          "nao": int(B.shape[1]), "nocc": [int(c.shape[1]) for c in cocc],
          "opt_einsum": torch.backends.opt_einsum.is_available(),
          "rel_err_K_library": rel_err(k_library(B, cocc[0]), Kr),
          "rel_err_J_per_spin": [rel_err(J[s], Jr[s]) for s in range(2)],
          "max_abs_J": float(Jr.abs().max()), **out,
          **wk_report(df_k, "df_k")})
    return e, out, mf, info


def phase_h_atom(dev, e_phenol, e_phenoxyl):
    from cctpu_torch.dft.rks import UKS
    mf, e, info = run_scf(UKS, H_ATOM, dev, spin=1, xc="b3lyp")
    de = abs(e - H_ATOM_E_CONV)
    bde = (e_phenoxyl + e - e_phenol) * HARTREE2KCAL
    emit({"phase": "h_atom_ub3lyp_631gs", "abs_dE_vs_oracle": de,
          "S2": mf.spin_square()[0], "nbeta": mf.mol.nbeta, **info})
    emit({"phase": "phenol_OH_bde", "kcal_mol": bde,
          "E_phenol": e_phenol, "E_phenoxyl": e_phenoxyl, "E_H": e})
    check(mf.converged, "H atom SCF did not converge")
    check(de <= 1e-8, f"H atom |dE| {de:.3e} > 1e-8 Ha")
    check(np.isfinite(bde) and 50.0 < bde < 120.0,
          f"phenol O-H BDE {bde:.2f} kcal/mol is not physical")


def phase_phenol_blyp(dev):
    from cctpu_torch.dft.rks import RKS
    from cctpu_torch.ops import df_j
    mf, e, info = run_scf(RKS, PHENOL, dev, xc="blyp")
    de = abs(e - PHENOL_BLYP_E_CONV)
    n = info["launches"]
    emit({"phase": "phenol_blyp_631gs", "abs_dE_vs_oracle": de, **info})
    check(mf.converged, "phenol BLYP SCF did not converge")
    check(de <= 1e-8, f"phenol BLYP |dE| {de:.3e} > 1e-8 Ha")
    check(n["df_j"] >= mf.n_cycles and n["df_k"] == 0
          and n["df_jk_fused"] == 0,
          f"phenol BLYP launches {n} in {mf.n_cycles} cycles")
    check(df_j.LAST_PLAN["kind"] == "one_pass",
          f"phenol BLYP's SCF ran df_j's {df_j.LAST_PLAN['kind']} plan")


def fd_gradient(mf, comps, h=1e-3):
    """Central differences of the port's card energy at components
    ``comps`` [(atom, axis)]: SCFs of ``mf``'s kind at +-h bohr, warm
    started from ``mf.dm``, at conv_tol 1e-12."""
    mol = mf.mol
    kw = {} if getattr(mf, "func", None) is None else dict(xc=mf.xc)
    out = []
    for ia, ax in comps:
        e = []
        for sgn in (1.0, -1.0):
            c = mol.coords.copy()
            c[ia, ax] += sgn * h
            m2 = type(mf)(mol.with_coords(c), density_fit=mf.density_fit,
                          grid_level=2, conv_tol=1e-12, max_cycle=60,
                          device=mf.device, **kw)
            e.append(m2.kernel(dm0=mf.dm))
            check(m2.converged, f"FD SCF at {ia},{ax} did not converge")
        out.append((e[0] - e[1]) / (2 * h))
    return out


def phase_gradient(tag, mf, info, fd_comps, oracle):
    """The DF nuclear gradient of phase ``info``'s SCF ``mf``, continued
    from its density to conv_tol 1e-12 and an orbital gradient <= 1e-8:
    two calls (bitwise equal), per-term seconds, peak device memory,
    s/iter, translational invariance, central differences at ``fd_comps``
    and cctpu's oracle. The J/K kernels' launch counts are
    reset before the gradient and must stay 0: it launches none of them."""
    import torch
    from cctpu_torch.grad.scf_grad import gradient
    from cctpu_torch.utils.profiling import PhaseTimer
    dev = mf.device
    mf.opts.conv_tol, mf.opts.conv_tol_grad = 1e-12, 1e-8
    mf.kernel(dm0=mf.dm)
    check(mf.converged, f"{tag}: the SCF did not converge to 1e-12")
    reset_counts()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    calls = []
    for _ in range(2):
        timer = PhaseTimer(dev)
        t0 = time.time()
        g = gradient(mf, timer)
        torch.cuda.synchronize(dev)
        calls.append((g, time.time() - t0, timer.phases))
    peak = torch.cuda.max_memory_allocated(dev)
    launches = counts()
    (g1, s1, terms1), (g2, s2, terms2) = calls
    bitwise = bool(torch.equal(g1, g2))
    g = g1.cpu().numpy()
    inv = float(np.abs(g.sum(0)).max())
    fd = fd_gradient(mf, fd_comps) if fd_comps else []
    fd_err = [abs(float(g[ia, ax]) - f) for (ia, ax), f in zip(fd_comps, fd)]
    orc_err = None if oracle is None \
        else float(np.abs(g - np.asarray(oracle)).max())
    res = {"phase": tag, "card": card_line(), "E": mf.e_tot,
           "cycles_to_1e-12": mf.n_cycles, "grad_s_first": s1,
           "grad_s": s2, "terms_s_first": terms1, "terms_s": terms2,
           "peak_mem_GB": peak / 1e9, "bitwise_repeat": bitwise,
           "max_abs_sum_g": inv, "fd_components": fd_comps,
           "fd": fd, "abs_err_fd": fd_err, "abs_err_vs_cctpu": orc_err,
           "launches_in_gradient": launches, "gradient": g.tolist()}
    if info is not None:
        res["s_per_iter"] = info["cycles"] * info["s_per_cycle"] + s2
        res["scf_cycles"], res["scf_s_per_cycle"] = \
            info["cycles"], info["s_per_cycle"]
    emit(res)
    check(np.isfinite(g).all() and g.shape == (mf.mol.natm, 3),
          f"{tag}: gradient not finite or of the wrong shape")
    check(bitwise, f"{tag}: two gradient calls differ")
    check(inv <= 1e-8, f"{tag}: max |sum_A g_A| {inv:.2e} > 1e-8")
    check(max(fd_err, default=0.0) <= 1e-6,
          f"{tag}: |g - FD| {fd_err} > 1e-6")
    check(orc_err is None or orc_err <= 1e-7,
          f"{tag}: |g - cctpu| {orc_err} > 1e-7")
    check(not any(launches.values()),
          f"{tag}: the gradient launched J/K kernels {launches}")
    return res


def phase_small_gradients(dev, density_fit=True):
    """Water RHF, water B3LYP and NH2 UB3LYP (6-31G*, grid level 2), DF or
    in-core: SCF and gradient on the card against cctpu's CPU-f64
    gradients."""
    from cctpu_torch.dft.rks import RKS, UKS
    from cctpu_torch.scf.hf import RHF
    route, oracles = ("", GRAD_ORACLES) if density_fit \
        else ("incore_", INCORE_ORACLES)
    for tag, cls, atoms, spin, kw in (
            ("water_rhf", RHF, WATER, 0, {}),
            ("water_b3lyp", RKS, WATER, 0, dict(xc="b3lyp")),
            ("nh2_ub3lyp", UKS, NH2, 1, dict(xc="b3lyp"))):
        mf, _, _ = run_scf(cls, atoms, dev, spin=spin,
                           density_fit=density_fit, **kw)
        phase_gradient(f"gradient_{route}{tag}", mf, None, [], oracles[tag])


def phase_c16h34(dev):
    import torch
    from cctpu_torch.core.molecule import Molecule
    from cctpu_torch.dft.rks import RKS
    from cctpu_torch.ops import df_j, df_jk, df_k
    mol = Molecule.from_atoms(alkane(16), basis="6-31g*")
    t0 = time.time()
    mf = RKS(mol, xc="b3lyp", density_fit=True, grid_level=2, device=dev)
    mf.get_jk_builder()
    mf._prepare_xc_f64()
    torch.cuda.synchronize()
    t_build = time.time() - t0
    dm = mf.init_guess_dm()
    cocc = mf._factor_cocc(dm)
    veff, e2 = mf.get_veff(dm, cocc=cocc)
    ints = mf.build_ints()
    e1 = float(torch.einsum("ij,ij->", dm, ints["T"] + ints["V"]))
    e = e1 + float(e2) + mol.energy_nuc()
    de = abs(e - C16H34_E_SAD)
    B = mf._jk.B
    J, K = df_jk.df_jk_fused(B, dm, cocc)
    Jr, Kr = df_jk.df_jk_reference(B, dm, cocc)
    ej, ek = rel_err(J, Jr), rel_err(K, Kr)
    plan_fused = df_jk.LAST_PLAN
    ej1 = rel_err(df_j.df_j_fast(B, dm), Jr)
    plan_j = df_j.LAST_PLAN
    ek1 = rel_err(df_k.df_k_fast(B, cocc), Kr)
    del J, K, Jr, Kr
    k1 = cuda_ms(lambda: df_jk.df_jk_fused(B, dm, cocc), 3)
    p1 = cuda_ms(lambda: df_jk.df_jk_reference(B, dm, cocc), 3)
    dm2 = torch.stack([dm, dm]) * 0.5
    tj = alternated_ms(lambda: df_j.df_j_fast(B, dm2),
                       lambda: df_j.df_j_reference(B, dm2), 3,
                       library=lambda: torch.einsum("pij,sij,pkl->skl",
                                                    B, dm2, B))
    plan_j2 = df_j.LAST_PLAN
    tj1 = alternated_ms(lambda: df_j.df_j_fast(B, dm),
                        lambda: df_j.df_j_reference(B, dm), 3,
                        library=lambda: torch.einsum("pij,ij,pkl->kl",
                                                     B, dm, B))
    tk = alternated_ms(lambda: df_k.df_k_fast(B, cocc),
                       lambda: df_k.df_k_reference(B, cocc), 3,
                       library=lambda: k_library(B, cocc))
    naux, nao, nocc = int(B.shape[0]), mol.nao, int(cocc.shape[1])
    emit({"phase": "c16h34_sad", "E_sad": e, "abs_dE_vs_oracle": de,
          "nao": nao, "naux": naux, "nocc": nocc, "build_s": t_build,
          "jk_kernel_ms": k1, "jk_plain_ms": p1,
          "jk_bound_ms": bound(*work("df_jk_fused", naux, nao,
                                     nocc))["bound_ms"],
          "kernel_rel_err_J": ej, "kernel_rel_err_K": ek,
          "df_j_nset2": {**tj, **bound(*work("df_j", naux, nao, nset=2))},
          "df_j_nset1": {**tj1, **bound(*work("df_j", naux, nao, nset=1))},
          "plan_df_j": plan_j2, "plan_df_j_nset1": plan_j,
          "df_k": {**tk, **bound(*work("df_k", naux, nao, nocc))},
          "df_j_rel_err": ej1, "df_k_rel_err": ek1,
          "plan_fused": plan_fused, "plan_df_k": df_k.LAST_PLAN,
          "ptxas_f64": wk_report(df_jk, "df_jk_fused")["ptxas_f64"],
          "peak_mem_GB": torch.cuda.max_memory_allocated(dev) / 1e9})
    check(np.isfinite(e) and de <= 1e-6, f"C16H34 SAD |dE| {de:.3e} > 1e-6")
    check(max(ej, ek, ej1, ek1) <= 1e-12,
          "a kernel disagrees at the C16H34 shape")
    check(plan_j["kind"] == plan_j2["kind"] == "two_pass",
          f"C16H34 ran df_j's {plan_j['kind']}/{plan_j2['kind']} plans")


def phase_cli(smiles, extra, tag, need, method="b3lyp"):
    """The ``energy`` CLI through cli.main; ``need`` names the kernel that
    must have launched, or is None where none may (the in-core route)."""
    from cctpu_torch.workflows import cli
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        rc = cli.main(["energy", "--smiles", smiles, "--method", method,
                       "--basis", "6-31g*", "--grid-level", "2", *extra,
                       "--output-dir", tmp])
        wall = time.time() - t0
        reports = [f for f in os.listdir(tmp)
                   if f.endswith("_short_report.txt")]
        check(len(reports) == 1, f"{tag}: energy CLI wrote no short report")
        with open(os.path.join(tmp, reports[0])) as f:
            text = f.read()
    converged = "converged: True" in text
    n = counts()
    emit({"phase": tag, "rc": rc, "converged": converged, "launches": n,
          "wall_s": wall})
    check(rc == 0 and converged, f"{tag}: energy CLI did not converge")
    if need is None:
        check(not any(n.values()), f"{tag}: in-core CLI launched {n}")
    else:
        check(n[need] > 0, f"{tag}: energy CLI never reached {need}")


def phase_contract(dev):
    """7. The 1e-8 Ha contract on the card: water RHF/6-31G with Cholesky
    J/K at conv_tol 1e-12 against cctpu's host-f64 oracle, the fused kernel
    launched every cycle; NH2 UB3LYP/6-31G* with Cholesky J/K (DF-J and
    DF-K on the factor) against the in-core SCF (<= 1e-8 Ha). Returns the
    launches of the two Cholesky SCFs."""
    from cctpu_torch.dft.rks import UKS
    from cctpu_torch.scf.hf import RHF
    mf, e, info = run_scf(RHF, WATER, dev, density_fit="cd", basis="6-31g",
                          conv_tol=1e-12)
    de = abs(e - WATER_CD_631G_E)
    n = info["launches"]
    emit({"phase": "water_rhf_631g_cd", "abs_dE_vs_oracle": de, **info})
    check(mf.converged and de <= 1e-8, f"water Cholesky |dE| {de:.3e}")
    check(n["df_jk_fused"] >= mf.n_cycles and n["df_j"] == n["df_k"] == 0,
          f"water Cholesky launches {n} in {mf.n_cycles} cycles")
    mf_cd, e_cd, info_cd = run_scf(UKS, NH2, dev, spin=1, density_fit="cd",
                                   xc="b3lyp")
    mf_in, e_in, info_in = run_scf(UKS, NH2, dev, spin=1, density_fit=False,
                                   xc="b3lyp")
    n_cd, n_in = info_cd["launches"], info_in["launches"]
    emit({"phase": "nh2_ub3lyp_cd_vs_incore", "abs_dE": abs(e_cd - e_in),
          "cd": info_cd, "incore": info_in})
    check(mf_cd.converged and mf_in.converged and abs(e_cd - e_in) <= 1e-8,
          f"NH2 |E_cd - E_incore| {abs(e_cd - e_in):.3e} > 1e-8")
    check(n_cd["df_j"] >= mf_cd.n_cycles and n_cd["df_k"] >= 2 *
          mf_cd.n_cycles and n_cd["df_jk_fused"] == 0 and
          not any(n_in.values()), f"NH2 launches {n_cd} / {n_in}")
    return {k: n[k] + n_cd[k] for k in n}


def phase_incore_phenol(dev, e_df):
    """7b. Phenol B3LYP/6-31G* in-core (grid level 2, conv_tol 1e-10)
    against cctpu's CPU-f64 in-core oracle (<= 1e-8 Ha): the tensor's
    build seconds and bytes, peak memory, s/cycle, no J/K kernel launched,
    and the DF fitting error |E_incore - E_DF| (printed, not gated)."""
    from cctpu_torch.dft.rks import RKS
    mf, e, info = run_scf(RKS, PHENOL, dev, density_fit=False, xc="b3lyp")
    de = abs(e - INCORE_ORACLES["phenol_b3lyp_e"])
    n = mf.mol.nao
    emit({"phase": "phenol_b3lyp_631gs_incore", "abs_dE_vs_oracle": de,
          "eri_GB": n ** 4 * 8 / 1e9, "eri_and_exchange_copy_GB":
          2 * n ** 4 * 8 / 1e9, "abs_E_incore_minus_E_df": abs(e - e_df),
          **info})
    check(mf.converged and de <= 1e-8, f"phenol in-core |dE| {de:.3e}")
    check(not any(info["launches"].values()),
          f"phenol in-core launched {info['launches']}")
    return mf, info


def phase_cholesky_phenol(dev, e_incore):
    """7c. The phenol SCF of 7b with Cholesky J/K: |E_cd - E_incore| <=
    1e-8 Ha (the contract at the north star's molecule), K, the fused
    kernel launched every cycle; then the kernels at its factor."""
    from cctpu_torch.dft.rks import RKS
    mf, e, info = run_scf(RKS, PHENOL, dev, density_fit="cd", xc="b3lyp")
    de = abs(e - e_incore)
    n = info["launches"]
    emit({"phase": "phenol_b3lyp_631gs_cd", "abs_E_cd_minus_E_incore": de,
          "cholesky_K": info["naux"], "cholesky_build_s": info["df_build_s"],
          **info})
    check(mf.converged and de <= 1e-8, f"phenol |E_cd - E_incore| {de:.3e}")
    check(n["df_jk_fused"] >= mf.n_cycles and n["df_j"] == n["df_k"] == 0,
          f"phenol Cholesky launches {n} in {mf.n_cycles} cycles")
    out = scf_kernels(mf, ("df_jk_fused", "df_j", "df_j_nset1", "df_k"))
    B, C = mf._jk.B, mf._factor_cocc(mf.dm)
    emit({"phase": "cholesky_kernel_time",
          "shape": [int(B.shape[0]), int(B.shape[1]), int(C.shape[1])],
          **out})
    return mf, n, out


def phase_cd_gradient(mf, g_incore):
    """7d, second part: the direct gradient of the Cholesky SCF of 7c at
    conv_tol 1e-12 agrees with the in-core SCF's (<= 1e-7 Ha/bohr)."""
    import torch
    from cctpu_torch.grad.scf_grad import gradient
    mf.opts.conv_tol, mf.opts.conv_tol_grad = 1e-12, 1e-8
    mf.kernel(dm0=mf.dm)
    check(mf.converged, "phenol Cholesky SCF did not converge to 1e-12")
    reset_counts()
    t0 = time.time()
    g = gradient(mf)
    torch.cuda.synchronize()
    err = float(np.abs(g.cpu().numpy() - np.asarray(g_incore)).max())
    emit({"phase": "gradient_cd_phenol_b3lyp", "grad_s": time.time() - t0,
          "abs_err_vs_incore": err, "launches_in_gradient": counts()})
    check(err <= 1e-7, f"phenol |g_cd - g_incore| {err:.2e} > 1e-7")
    check(not any(counts().values()), "the Cholesky gradient launched J/K")


def phase_cli_cache():
    """7f, second part: the ``energy`` CLI's code on phenol with
    ``--scf-cache`` twice: the second run warm-starts from the first one's
    checkpoint, takes fewer cycles and agrees (<= 1e-10 Ha)."""
    from cctpu_torch.workflows import calculate_energy
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for k in range(2):
            out = os.path.join(tmp, f"out{k}")
            t0 = time.time()
            e = calculate_energy.main(
                ["--smiles", "Oc1ccccc1", "--method", "b3lyp", "--basis",
                 "6-31g*", "--grid-level", "2", "--scf-cache",
                 os.path.join(tmp, "cache"), "--output-dir", out])
            wall = time.time() - t0
            report, = [f for f in os.listdir(out)
                       if f.endswith("_short_report.txt")]
            with open(os.path.join(out, report)) as f:
                text = f.read()
            runs.append({"E": e, "wall_s": wall,
                         "converged": "converged: True" in text,
                         "cycles": int(text.split("cycles:")[1].split()[0]),
                         "warm_start": "warm start" in text})
    (r1, r2), de = runs, abs(runs[1]["E"] - runs[0]["E"])
    emit({"phase": "cli_energy_scf_cache", "runs": runs, "abs_dE": de})
    check(r1["converged"] and r2["converged"] and not r1["warm_start"]
          and r2["warm_start"] and r2["cycles"] < r1["cycles"]
          and de <= 1e-10, f"--scf-cache runs {runs}")


def opt_factory(cls, dev):
    return lambda m: cls(m, device=dev, **OPT_SCF)


def launches_per_cycle(tag, n, cycles, open_shell):
    """The DF kernels of a run of SCFs with ``cycles`` cycles in all: the
    fused kernel once a cycle (closed shell), else DF-J once and DF-K twice
    a cycle."""
    want = ({"df_jk_fused": 0, "df_j": cycles, "df_k": 2 * cycles}
            if open_shell else
            {"df_jk_fused": cycles, "df_j": 0, "df_k": 0})
    check(n == want, f"{tag}: launches {n}, expected {want}")


def phase_opt(tag, cls, atoms, spin, dev):
    """8, 8b. ``optimize`` twice from ``atoms``, held against cctpu's
    CPU-f64 optimization (``OPT_ORACLES[tag]``): the same steps, every
    step's energy <= 1e-8 Ha, final coordinates <= 1e-5 bohr; the two runs
    bitwise equal; the DF kernels every cycle. Returns the first run's
    result and launches."""
    import torch
    from cctpu_torch.core.molecule import Molecule
    from cctpu_torch.geomopt.optimizer import optimize
    from cctpu_torch.utils.profiling import PhaseTimer
    orc = OPT_ORACLES[tag]
    mol = Molecule.from_atoms(atoms, spin=spin, basis="6-31g*")
    runs = []
    for _ in range(2):
        timer = PhaseTimer(dev)
        reset_counts()
        t0 = time.time()
        res = optimize(opt_factory(cls, dev), mol, timer=timer)
        torch.cuda.synchronize(dev)
        runs.append((res, counts(), time.time() - t0, timer.phases))
    (res, n, wall, phases), (res2, n2, _, _) = runs
    k = min(res.nsteps, orc["nsteps"])
    de = float(np.abs(np.subtract(res.energies[:k],
                                  orc["energies"][:k])).max())
    dx = float(np.abs(res.mol.coords - np.asarray(orc["coords"])).max())
    bitwise = bool(np.array_equal(res.mol.coords, res2.mol.coords))
    emit({"phase": f"opt_{tag}", "converged": res.converged,
          "steps": res.nsteps, "steps_cctpu": orc["nsteps"],
          "cycles": res.cycles, "energies": res.energies,
          "max_abs_dE_vs_cctpu": de, "max_abs_dx_vs_cctpu_bohr": dx,
          "bitwise_repeat": bitwise, "wall_s": wall, "phases_s": phases,
          "launches": n})
    check(res.converged and res.nsteps == orc["nsteps"],
          f"{tag}: {res.nsteps} steps (converged {res.converged}), cctpu "
          f"{orc['nsteps']}")
    check(de <= 1e-8, f"{tag}: step energies {de:.2e} Ha from cctpu's")
    check(dx <= 1e-5, f"{tag}: final coordinates {dx:.2e} bohr off")
    check(bitwise and n == n2, f"{tag}: the two runs differ")
    launches_per_cycle(tag, n, sum(res.cycles), spin != 0)
    return res, n


def phase_opt_phenol(dev):
    """8c. Phenol through ``optimize``: step 0 against the phenol oracles,
    convergence, s/step and its split, launches and peak memory per step."""
    import torch
    from cctpu_torch.core.molecule import Molecule
    from cctpu_torch.dft.rks import RKS
    from cctpu_torch.geomopt.optimizer import _project_tr, optimize
    from cctpu_torch.utils.profiling import PhaseTimer
    mol = Molecule.from_atoms(PHENOL, basis="6-31g*")
    timer = PhaseTimer(dev)
    steps = []

    def callback(step, m, e, g):
        torch.cuda.synchronize(dev)
        steps.append({"E": e, "g": g, "t": time.time(),
                      "phases": dict(timer.phases),
                      "peak_mem_GB": torch.cuda.max_memory_allocated(dev)
                      / 1e9})
        torch.cuda.reset_peak_memory_stats(dev)

    reset_counts()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    res = optimize(opt_factory(RKS, dev), mol, maxsteps=30, timer=timer,
                   callback=callback)
    torch.cuda.synchronize(dev)
    wall = time.time() - t0
    n = counts()
    split = {k: timer.phases[k] / res.nsteps
             for k in ("setup", "scf", "gradient", "step")}
    per_step, last = [], {"t": t0, "phases": {}}
    for st in steps:
        per_step.append({"s": st["t"] - last["t"], **{
            k: st["phases"].get(k, 0.0) - last["phases"].get(k, 0.0)
            for k in ("setup", "scf", "gradient", "step")},
            "peak_mem_GB": st["peak_mem_GB"]})
        last = st
    e0_err = abs(steps[0]["E"] - PHENOL_E_CONV)
    g0_err = float(np.abs(steps[0]["g"]
                          - np.asarray(GRAD_ORACLES["phenol_b3lyp"])).max())
    gp = _project_tr(steps[-1]["g"].ravel(), res.mol.coords)
    gmax = float(np.abs(gp).max())
    peaks = [st["peak_mem_GB"] for st in steps]
    emit({"phase": "opt_phenol_b3lyp", "card": card_line(),
          "converged": res.converged, "steps": res.nsteps,
          "scf_cycles": res.cycles, "scf_cycles_total": sum(res.cycles),
          "energies": res.energies, "abs_dE0_vs_oracle": e0_err,
          "abs_dg0_vs_cctpu": g0_err, "final_projected_gmax": gmax,
          "wall_s": wall, "s_per_step": wall / res.nsteps,
          "s_per_step_split": split, "phases_s": timer.phases,
          "per_step": per_step, "launches": n})
    check(e0_err <= 1e-8, f"phenol opt step 0 |dE| {e0_err:.2e}")
    check(g0_err <= 1e-7, f"phenol opt step 0 |dg| {g0_err:.2e}")
    check(res.converged and gmax < 4.5e-4
          and res.energies[-1] < res.energies[0],
          f"phenol opt: converged {res.converged} in {res.nsteps} steps, "
          f"gmax {gmax:.2e}")
    launches_per_cycle("opt_phenol_b3lyp", n, sum(res.cycles), False)
    # a step's set-up builds its grid and DF tensors at its own geometry:
    # their sizes move a little with it, a leak of the last step would not
    check(max(peaks) <= 1.05 * peaks[0],
          f"phenol opt: peak memory grows over the steps {peaks}")
    return n


def phase_hessian(dev):
    """8d. Water FD Hessians with dipoles at cctpu's optimized water
    geometry, through ``hessian_auto`` from an SCF there: DF-B3LYP against
    cctpu's FD Hessian, harmonic analysis and thermo; in-core RHF against
    cctpu's analytic (CPHF) Hessian (its B3LYP and DF ones did not finish
    on the CPU)."""
    from cctpu_torch.core.molecule import Molecule
    from cctpu_torch.dft.rks import RKS
    from cctpu_torch.hessian.frequencies import harmonic_analysis, \
        hessian_auto
    from cctpu_torch.hessian.thermo import thermo
    from cctpu_torch.scf.hf import RHF
    fd, an = OPT_ORACLES["water_b3lyp_fd"], OPT_ORACLES["water_rhf_analytic"]
    mol = Molecule.from_atoms(WATER_START, basis="6-31g*").with_coords(
        np.asarray(OPT_ORACLES["water_b3lyp"]["coords"]))
    out, n_all = {}, {}
    for tag, factory in (
            ("b3lyp", opt_factory(RKS, dev)),
            ("rhf", lambda m: RHF(m, device=dev, density_fit=False,
                                  conv_tol=1e-12, conv_tol_grad=1e-8,
                                  max_cycle=100))):
        mf = factory(mol)
        e = mf.kernel()
        reset_counts()
        t0 = time.time()
        log = []
        H, dmu = hessian_auto(mf, factory, mol, dm0=mf.make_rdm1(),
                              log=log.append)
        n = counts()
        ha = harmonic_analysis(mol, H, dmu)
        out[tag] = {"E": e, "wall_s": time.time() - t0, "log": log,
                    "freq_cm": ha.freq_wavenumber.tolist(),
                    "ir_km_mol": ha.ir_intensity.tolist(),
                    "n_imaginary": ha.n_imaginary, "launches": n}
        n_all = {k: n_all.get(k, 0) + n[k] for k in n}
        check(log and "FD of analytic gradients" in log[0],
              f"hessian_auto did not name its FD route: {log}")
        check(ha.n_imaginary == 0, f"water {tag} has an imaginary mode")
        # B3LYP runs DF (the fused kernel in every SCF), RHF in core (none)
        check(n["df_j"] == n["df_k"] == 0 and (
            n["df_jk_fused"] >= 6 * mol.natm if tag == "b3lyp"
            else n["df_jk_fused"] == 0),
            f"water {tag} FD Hessian launches {n}")
        if tag == "b3lyp":
            th = thermo(mol, ha.freq_au, e)
            res = out[tag]
            res["max_abs_dfreq_vs_cctpu_fd"] = float(np.abs(
                ha.freq_wavenumber - np.asarray(fd["freq_cm"])).max())
            res["max_rel_dIR_vs_cctpu_fd"] = float(np.max(
                np.abs(ha.ir_intensity - np.asarray(fd["ir_km_mol"]))
                / np.abs(fd["ir_km_mol"])))
            res["max_abs_dH_vs_cctpu_fd"] = float(np.abs(
                H - np.asarray(fd["hessian"])).max())
            res["abs_dthermo_vs_cctpu"] = {
                k: abs(th[k][0] - fd[k]) for k in ("ZPE", "E_0K", "H_tot",
                                                   "G_tot")}
            check(res["max_abs_dfreq_vs_cctpu_fd"] <= 0.05,
                  f"water frequencies {res['max_abs_dfreq_vs_cctpu_fd']:.3f}"
                  " cm^-1 off cctpu's FD")
            check(res["max_rel_dIR_vs_cctpu_fd"] <= 1e-3,
                  f"water IR intensities {res['max_rel_dIR_vs_cctpu_fd']:.2e}"
                  " relative off cctpu's")
            check(max(res["abs_dthermo_vs_cctpu"].values()) <= 1e-6,
                  f"water thermo off cctpu's: {res['abs_dthermo_vs_cctpu']}")
        else:
            freq = ha.freq_wavenumber
            real = freq > 0
            res = out[tag]
            res["max_abs_dH_vs_cctpu_analytic"] = float(np.abs(
                H - np.asarray(an["hessian"])).max())
            res["max_abs_dfreq_vs_cctpu_analytic"] = float(np.abs(
                freq[real] - np.asarray(an["freq_cm"])[real]).max())
            check(res["max_abs_dH_vs_cctpu_analytic"] <= 5e-5,
                  f"water RHF |H - H_analytic| "
                  f"{res['max_abs_dH_vs_cctpu_analytic']:.2e}")
            check(res["max_abs_dfreq_vs_cctpu_analytic"] <= 1.0,
                  f"water RHF frequencies "
                  f"{res['max_abs_dfreq_vs_cctpu_analytic']:.3f} cm^-1 off "
                  "the analytic Hessian's")
    emit({"phase": "hessian_fd_water", **out})
    return n_all


def phase_cli_opt(runs=(("opt", ("_optimized.xyz",), ("--skip-freq",)),
                        ("opt-freq", ("_optimized.xyz", "_ir.csv"), ())),
                  extra=(), tag="cli"):
    """8e. The ``opt`` and ``opt-freq`` CLIs on water, default routes (in
    core: no J/K kernel), on the card; ``extra`` arguments for all. The
    ``opt`` run skips its frequencies: they are the same optimization and
    FD Hessian as 10e's ``ir`` CLI (B3LYP/6-31G*, in core), which holds
    them against cctpu's."""
    from cctpu_torch.workflows import cli
    for name, files, args in runs:
        reset_counts()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            rc = cli.main([name, "--smiles", "O", *extra, *args,
                           "--output-dir", tmp])
            wall = time.time() - t0
            names = os.listdir(tmp)
            report = [f for f in names if f.endswith("_short_report.txt")]
            text = ""
            if report:
                with open(os.path.join(tmp, report[0])) as f:
                    text = f.read()
        missing = [sfx for sfx in files + ("_short_report.txt",
                                           "_log_report.txt")
                   if not any(f.endswith(sfx) for f in names)]
        converged = ("optimization converged" in text if name == "opt"
                     else "converged=True" in text)
        no_imag = ("--skip-freq" in args
                   or ("no imaginary frequencies" in text if name == "opt"
                       else "imaginary: 0" in text))
        emit({"phase": f"{tag}_{name}", "rc": rc, "wall_s": wall,
              "files": sorted(names), "converged": converged,
              "no_imaginary_mode": no_imag, "launches": counts()})
        check(rc == 0 and not missing and converged and no_imag,
              f"{name} CLI: rc {rc}, missing {missing}, converged "
              f"{converged}, no imaginary mode {no_imag}")
        check(not any(counts().values()),
              f"{name} CLI's in-core route launched {counts()}")


def rsh_launches(tag, n, cycles, open_shell):
    """The DF kernels of a range-separated SCF with ``cycles`` cycles: the
    fused J/K and ``df_k`` (K_lr on B_lr) once a cycle (closed shell), else
    ``df_j`` once and ``df_k`` four times a cycle (K and K_lr per spin)."""
    want = ({"df_jk_fused": 0, "df_j": cycles, "df_k": 4 * cycles}
            if open_shell else
            {"df_jk_fused": cycles, "df_j": 0, "df_k": cycles})
    check(n == want, f"{tag}: launches {n}, expected {want}")


def rsh_gradient(tag, mf, info, fd_comps, oracle):
    """``phase_gradient`` of a range-separated or dispersion-corrected SCF,
    whose per-term seconds must include the long-range terms (``3c_lr`` and
    ``2c_lr`` on the DF route, ``2e_lr`` in core and with Cholesky J/K)
    and ``disp``."""
    res = phase_gradient(tag, mf, info, fd_comps, oracle)
    want = {"disp"} if mf.func.dispersion else set()
    if mf.func.rsh is not None:
        direct = mf.density_fit in (False, None, "cd")
        want |= {"2e_lr"} if direct else {"3c_lr", "2c_lr"}
    check(want <= set(res["terms_s"]),
          f"{tag}: terms {sorted(res['terms_s'])} lack {sorted(want)}")
    return res


def phase_rsh_phenol(dev, info_b3lyp):
    """9a. Phenol DF-wB97X-D/6-31G* against cctpu's oracle, with the
    dispersion energy, B_lr's rows, bytes and build seconds, the launches
    (the fused kernel and df_k once a cycle) and s/cycle beside phase 3's
    B3LYP; 9. df_k at this SCF's B_lr against its plain version."""
    from cctpu_torch.dft.dispersion import dispersion_energy
    from cctpu_torch.dft.rks import RKS
    mf, e, info = run_scf(RKS, PHENOL, dev, xc="wb97x-d")
    de = abs(e - RSH_ORACLES["phenol_wb97xd_e"])
    B_lr = mf._jk.prepare_lr(mf.func.rsh[0])[0]
    emit({"phase": "phenol_wb97xd_631gs", "abs_dE_vs_oracle": de,
          "E_disp": dispersion_energy(mf.func, mf.mol),
          "naux_lr": int(B_lr.shape[0]), "B_lr_GB": B_lr.numel() * 8 / 1e9,
          "s_per_cycle_b3lyp_phase3": info_b3lyp["s_per_cycle"], **info})
    check(mf.converged and de <= 1e-8, f"phenol wB97X-D |dE| {de:.3e}")
    rsh_launches("phenol_wb97xd", info["launches"], mf.n_cycles, False)
    out = scf_kernels(mf, ("df_k",), B=B_lr)["df_k"]
    C = mf._factor_cocc(mf.dm)
    emit({"phase": "df_k_at_b_lr", "shape": [int(B_lr.shape[0]),
                                             int(B_lr.shape[1]),
                                             int(C.shape[1])], **out})
    return mf, info, out


def phase_rsh_m062x(dev):
    """9c. Phenol DF-M06-2X/6-31G* (meta-GGA, 54 % exact exchange) against
    its oracle; water DF-M06-2X's energy and gradient against cctpu's."""
    from cctpu_torch.dft.rks import RKS
    mf, e, info = run_scf(RKS, PHENOL, dev, xc="m06-2x")
    de = abs(e - RSH_ORACLES["phenol_m062x_e"])
    emit({"phase": "phenol_m062x_631gs", "abs_dE_vs_oracle": de, **info})
    check(mf.converged and de <= 1e-8, f"phenol M06-2X |dE| {de:.3e}")
    launches_per_cycle("phenol_m062x", info["launches"], mf.n_cycles, False)
    n = info["launches"]
    del mf
    orc = RSH_ORACLES["water_m062x"]
    mf, _, _ = run_scf(RKS, WATER, dev, xc="m06-2x")
    rsh_gradient("gradient_water_m062x", mf, None, [], orc["grad"])
    de = abs(mf.e_tot - orc["E"])
    check(de <= 1e-8, f"water M06-2X |dE| {de:.3e}")
    return n


def phase_rsh_nh2(dev):
    """9d. NH2 DF-UwB97X-D/6-31G* from its converged UB3LYP density, SCF
    and gradient against cctpu's (the same start); df_j once and df_k four
    times a cycle."""
    from cctpu_torch.dft.rks import UKS
    orc = RSH_ORACLES["nh2_uwb97xd"]
    mf0, _, _ = run_scf(UKS, NH2, dev, spin=1, xc="b3lyp")
    mf, e, info = run_scf(UKS, NH2, dev, spin=1, xc="wb97x-d", dm0=mf0.dm)
    del mf0
    de = abs(e - orc["E"])
    emit({"phase": "nh2_uwb97xd_631gs", "abs_dE_vs_oracle": de,
          "S2": mf.spin_square()[0], **info})
    check(mf.converged and de <= 1e-8, f"NH2 wB97X-D |dE| {de:.3e}")
    rsh_launches("nh2_uwb97xd", info["launches"], mf.n_cycles, True)
    rsh_gradient("gradient_nh2_uwb97xd", mf, None, [], orc["grad"])
    return info["launches"]


def phase_rsh_water(dev):
    """9e. Water/6-31G*: every other registry functional's DF energy
    against its oracle, and CAM-B3LYP's gradient (a short-range hybrid
    fraction beside the long-range one) against cctpu's; wB97X-D on the
    in-core route (no kernel) and with Cholesky J/K (the fused kernel a
    cycle; K_lr from the attenuated in-core tensor) against theirs, and
    both routes' gradients against cctpu's."""
    from cctpu_torch.dft.rks import RKS
    errs, n_all = {}, {}
    for xc in WATER_XC:
        mf, e, info = run_scf(RKS, WATER, dev, xc=xc)
        errs[xc] = abs(e - RSH_ORACLES[water_key(xc)])
        check(mf.converged, f"water {xc} did not converge")
        n = info["launches"]
        n_all = {k: n_all.get(k, 0) + n[k] for k in n}
        if xc == "cam-b3lyp":
            mf_cam = mf
    emit({"phase": "water_functionals_631gs", "abs_dE_vs_oracle": errs,
          "launches": n_all})
    check(max(errs.values()) <= 1e-8, f"water functionals |dE| {errs}")
    rsh_gradient("gradient_water_camb3lyp", mf_cam, None, [],
                 RSH_ORACLES["water_camb3lyp"]["grad"])
    del mf_cam
    orc = RSH_ORACLES["water_wb97xd_incore"]
    mf_cd, e_cd, info_cd = run_scf(RKS, WATER, dev, density_fit="cd",
                                   xc="wb97x-d")
    mf, e, info = run_scf(RKS, WATER, dev, density_fit=False, xc="wb97x-d")
    de_cd = abs(e_cd - RSH_ORACLES["water_wb97xd_cd_e"])
    de = abs(e - orc["E"])
    emit({"phase": "water_wb97xd_incore_cd", "abs_dE_incore": de,
          "abs_dE_cd": de_cd, "incore": info, "cd": info_cd})
    check(de <= 1e-8 and de_cd <= 1e-8, f"water wB97X-D in-core {de:.2e}, "
          f"Cholesky {de_cd:.2e}")
    check(not any(info["launches"].values()),
          f"in-core wB97X-D launched {info['launches']}")
    launches_per_cycle("water_wb97xd_cd", info_cd["launches"],
                       mf_cd.n_cycles, False)
    rsh_gradient("gradient_incore_water_wb97xd", mf, None, [], orc["grad"])
    rsh_gradient("gradient_cd_water_wb97xd", mf_cd, None, [],
                 RSH_ORACLES["water_wb97xd_cd"]["grad"])
    return {k: n_all[k] + info_cd["launches"][k] for k in n_all}


def phase_rsh_cli():
    """9f. The ``energy`` CLI with ``--method wb97x-d`` on phenol, on the
    default (in-core) route and with ``--density-fit``; the second against
    the Python API's SCF at the CLI's own geometry (<= 1e-10 Ha). The
    ``opt`` CLI on water with CAM-B3LYP/6-31G*: converged, no imaginary
    mode."""
    from cctpu_torch.io.embed3d import smiles_to_molecule
    from cctpu_torch.workflows import calculate_energy
    from cctpu_torch.workflows.common import make_scf
    phase_cli("Oc1ccccc1", [], "cli_energy_wb97xd_incore", None,
              method="wb97x-d")
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        e_cli = calculate_energy.main(
            ["--smiles", "Oc1ccccc1", "--method", "wb97x-d", "--basis",
             "6-31g*", "--grid-level", "2", "--density-fit", "--output-dir",
             tmp])
        wall = time.time() - t0
    n = counts()
    mol = smiles_to_molecule("Oc1ccccc1", charge=None, spin=0,
                             basis="6-31g*")
    mf = make_scf(mol, "wb97x-d", True, grid_level=2)
    e_api = mf.kernel()
    de = abs(e_cli - e_api)
    emit({"phase": "cli_energy_wb97xd_df", "E": e_cli, "wall_s": wall,
          "abs_dE_vs_api": de, "launches": n})
    check(mf.converged and de <= 1e-10, f"wB97X-D CLI vs API |dE| {de:.2e}")
    check(n["df_jk_fused"] > 0 and n["df_k"] == n["df_jk_fused"],
          f"wB97X-D DF CLI launches {n}")
    phase_cli_opt(runs=(("opt", ("_optimized.xyz",), ()),),
                  extra=("--method", "cam-b3lyp", "--basis", "6-31g*"),
                  tag="cli_cam_b3lyp")


def _short_report(tmp) -> str:
    reports = [f for f in os.listdir(tmp) if f.endswith("_short_report.txt")]
    check(len(reports) == 1, f"no short report in {os.listdir(tmp)}")
    with open(os.path.join(tmp, reports[0])) as f:
        return f.read()


def _recording(module, name):
    """Wrap ``module.name`` so that each call's arguments and result are
    kept (the workflows' mains print rounded numbers); returns the record
    list and a function that restores the original."""
    orig = getattr(module, name)
    rec = []

    def wrapped(*a, **k):
        t0 = time.time()
        out = orig(*a, **k)
        rec.append((a, k, out, time.time() - t0))
        return out
    setattr(module, name, wrapped)
    return rec, lambda: setattr(module, name, orig)


def phase_mp2(dev):
    """10. MP2 (``cctpu_torch.mp.mp2``) on SCFs at conv_tol 1e-12 and an
    orbital gradient <= 1e-9 (6-31G*): water RHF in core and with Cholesky
    J/K, NH2 UHF in core, phenol DF-RHF (MP2 on its B); e_corr against
    cctpu's CPU-f64 MP2 at the same settings (<= 1e-8 Ha), the MP2
    seconds and peak memory."""
    import torch
    from cctpu_torch.mp.mp2 import MP2
    from cctpu_torch.scf.hf import RHF, UHF
    n_all = {}
    for key, cls, atoms, spin, df in (
            ("mp2_water_incore", RHF, WATER, 0, False),
            ("mp2_water_cd", RHF, WATER, 0, "cd"),
            ("mp2_nh2_incore", UHF, NH2, 1, False),
            ("mp2_phenol_df", RHF, PHENOL, 0, True)):
        mf, e, info = run_scf(cls, atoms, dev, spin=spin, density_fit=df,
                              conv_tol=1e-12, conv_tol_grad=1e-9,
                              max_cycle=100)
        n_all = {k: n_all.get(k, 0) + v for k, v in info["launches"].items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        e_corr, e_tot = MP2(mf).kernel()
        t_mp2 = time.time() - t0
        orc = WORKFLOW_ORACLES[key]
        de = abs(e_corr - orc["e_corr"])
        emit({"phase": key, "e_corr": e_corr, "E_mp2": e_tot,
              "abs_dEcorr_vs_cctpu": de,
              "abs_dEscf_vs_cctpu": abs(e - orc["e_scf"]),
              "mp2_s": t_mp2,
              "mp2_peak_mem_GB": torch.cuda.max_memory_allocated(dev) / 1e9,
              **info})
        check(mf.converged and de <= 1e-8,
              f"{key}: |dE_corr| {de:.2e} Ha from cctpu's")
        del mf
    return n_all


def phase_cli_mp2():
    """10a. ``energy --method mp2 --density-fit`` on phenol (6-31G*): the
    printed correlation energy against the Python API's MP2 at the CLI's
    own geometry (<= 1e-10 Ha)."""
    from cctpu_torch.io.embed3d import smiles_to_molecule
    from cctpu_torch.mp.mp2 import MP2
    from cctpu_torch.workflows import cli
    from cctpu_torch.workflows.common import make_scf
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        rc = cli.main(["energy", "--smiles", "Oc1ccccc1", "--method", "mp2",
                       "--basis", "6-31g*", "--density-fit", "--output-dir",
                       tmp])
        wall = time.time() - t0
        text = _short_report(tmp)
    n = counts()
    e_corr_cli = float(text.split("MP2 corr:")[1].split()[0])
    mol = smiles_to_molecule("Oc1ccccc1", basis="6-31g*")
    mf = make_scf(mol, "mp2", True)
    mf.kernel()
    e_corr_api, _ = MP2(mf).kernel()
    de = abs(e_corr_cli - e_corr_api)
    emit({"phase": "cli_energy_mp2_df", "rc": rc, "e_corr": e_corr_cli,
          "abs_dEcorr_vs_api": de, "wall_s": wall, "launches": n})
    check(rc == 0 and "converged: True" in text and de <= 1e-10,
          f"energy --method mp2: rc {rc}, |dE_corr| vs API {de:.2e}")
    check(n["df_jk_fused"] > 0, f"MP2 CLI's DF-RHF launches {n}")
    return n


def run_bde(args):
    """The ``bde`` CLI through cli.main; returns (rc, wall, report, the
    CSV's rows, launches, each single point's size, cycles and seconds,
    the parent's SCF)."""
    from cctpu_torch.workflows import calculate_bde, cli
    reset_counts()
    orig = calculate_bde._serial_frag_sp
    sps, parent = [], []

    def single_point(*a, **k):
        t0 = time.time()
        mf, e = orig(*a, **k)
        sps.append({"natm": mf.mol.natm, "nao": mf.mol.nao,
                    "spin": mf.mol.spin, "cycles": mf.n_cycles,
                    "converged": mf.converged, "s": time.time() - t0})
        if not parent:
            parent.append(mf)
        return mf, e
    calculate_bde._serial_frag_sp = single_point
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            rc = cli.main(["bde", *args, "--output-dir", tmp])
            wall = time.time() - t0
            text = _short_report(tmp)
            csvs = [f for f in os.listdir(tmp) if f.endswith("_bde.csv")]
            check(len(csvs) == 1, f"bde {args}: no CSV")
            with open(os.path.join(tmp, csvs[0])) as f:
                rows = [ln.split(",") for ln in f.read().split()[1:]]
    finally:
        calculate_bde._serial_frag_sp = orig
    return rc, wall, text, rows, counts(), sps, parent[0]


def phase_bde():
    """10b. The ``bde`` CLI: ethane HF/STO-3G (--limit 1), hydrazine
    B3LYP/6-31G* at --tier b3lyp (parent and fragments optimized), phenol
    B3LYP/6-31G* --density-fit --limit 2 (C-O: phenyl + OH; O-H: phenoxyl +
    H); every BDE against cctpu's serial path (<= 1e-3 kcal/mol)."""
    from cctpu_torch.workflows import calculate_bde
    n_all = {}
    for key, args in (
            ("t_bde_ethane", ["--smiles", "CC", "--method", "hf", "--basis",
                              "sto-3g", "--limit", "1"]),
            ("bde_hydrazine_b3lyp_tier", ["--smiles", "NN", "--method",
                                          "b3lyp", "--basis", "6-31g*",
                                          "--tier", "b3lyp", "--limit",
                                          "1"]),
            ("bde_phenol_b3lyp", ["--smiles", "Oc1ccccc1", "--method",
                                  "b3lyp", "--basis", "6-31g*",
                                  "--density-fit", "--limit", "2"])):
        # bde's main returns its results: call it for the full precision
        rec, restore = _recording(calculate_bde, "bde_sweep")
        try:
            rc, wall, text, rows, n, sps, _ = run_bde(args)
        finally:
            restore()
        (_, _, (e_parent, results), _), = rec
        orc = WORKFLOW_ORACLES[key]
        got = {lbl: b for lbl, _, _, b in results}
        dev_kcal = max(abs(got[lbl] - b) for lbl, b in orc["bde"].items()) \
            if set(got) == set(orc["bde"]) else float("inf")
        emit({"phase": key, "rc": rc, "bde_kcal": got,
              "max_abs_dBDE_vs_cctpu_kcal": dev_kcal,
              "abs_dEparent_vs_cctpu": abs(e_parent - orc["e_parent"]),
              "wall_s": wall, "single_points": len(sps), "launches": n})
        check(rc == 0 and len(rows) == len(orc["bde"]) and dev_kcal <= 1e-3,
              f"{key}: rc {rc}, BDEs {got} vs cctpu {orc['bde']}")
        check("tier=b3lyp" in text or "batched sweep not ported" in text,
              f"{key}: the serial path was not logged")
        n_all = {k: n_all.get(k, 0) + v for k, v in n.items()}
    check(all(n_all.values()), f"10b's DF phenol never ran a kernel: {n_all}")
    return n_all


def phase_bde_default(dev):
    """10c. ``bde --smiles Oc1ccccc1 --limit 2`` at the CLI's defaults
    (M06-2X/def2-TZVP, density fitted by size: nao 253): rc 0, the CSV,
    both bonds, the fused kernel (the parent) and ``df_j``/``df_k`` (the
    UKS fragments) launched; s per SCF, peak memory. No oracle (cctpu's
    CPU cost at nao 253 is out of reach). Then the three kernels against
    their plain versions at the parent SCF's own factor [naux, 253,
    nocc], as 7c at the Cholesky factor."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    rc, wall, text, rows, n, per_scf, parent = run_bde(
        ["--smiles", "Oc1ccccc1", "--limit", "2"])
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    emit({"phase": "bde_phenol_default", "rc": rc, "wall_s": wall,
          "bde_kcal": {r[0]: float(r[3]) for r in rows},
          "weakest": text.split("weakest bond:")[1].split("\n")[0].strip()
          if "weakest bond:" in text else None,
          "naux": int(parent._jk.B.shape[0]) if parent.density_fit
          else None, "nao": parent.mol.nao,
          "scfs": per_scf,
          "s_per_scf": sum(p["s"] for p in per_scf) / len(per_scf),
          "peak_mem_GB": peak, "launches": n})
    check(rc == 0 and len(rows) == 2 and len(per_scf) == 5
          and all(p["converged"] for p in per_scf),
          f"default bde on phenol: rc {rc}, rows {rows}, SCFs {per_scf}")
    check(parent.density_fit and all(n.values()),
          f"default bde on phenol: launches {n}")
    kern = scf_kernels(parent, ("df_jk_fused", "df_j", "df_j_nset1",
                                "df_k"))
    emit({"phase": "kernels_def2tzvp_phenol",
          "shape": [int(parent._jk.B.shape[0]), parent.mol.nao,
                    parent.mol.nelectron // 2], **kern})
    del parent
    torch.cuda.empty_cache()
    return n, kern


def run_reaction(text, args, key):
    """The ``reaction`` CLI through cli.main, against cctpu's oracle: dE,
    dE0, dH and dG from the species' full-precision values (<= 0.01
    kcal/mol)."""
    from cctpu_torch.workflows import calculate_reaction_energy as rx
    from cctpu_torch.workflows import cli
    reset_counts()
    rec, restore = _recording(rx, "species_thermo")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            rc = cli.main(["reaction", "--reaction", text, *args,
                           "--output-dir", tmp])
            wall = time.time() - t0
            report = _short_report(tmp)
    finally:
        restore()
    n = counts()
    table = {a[0]: out for a, _, out, _ in rec}
    lhs, rhs = text.split("->")
    sides = rx.parse_side(lhs), rx.parse_side(rhs)

    def d(key_):
        return (sum(c * table[s][key_] for c, s in sides[1])
                - sum(c * table[s][key_] for c, s in sides[0]))
    orc = WORKFLOW_ORACLES[key]
    dev_kcal = {f"d{k}": abs(d(k) - orc[f"d{k}"]) * HARTREE2KCAL
                for k in ("E", "E0", "H", "G")}
    emit({"phase": key, "rc": rc, "wall_s": wall,
          **{f"d{k}_kcal": d(k) * HARTREE2KCAL for k in ("E", "E0", "H",
                                                          "G")},
          "abs_vs_cctpu_kcal": dev_kcal,
          "species_s": {a[0]: s for a, _, _, s in rec}, "launches": n})
    check(rc == 0 and "K_eq" in report and max(dev_kcal.values()) <= 0.01,
          f"{key}: rc {rc}, deviations from cctpu {dev_kcal} kcal/mol")
    return n


def phase_reaction():
    """10d. ``reaction "O + [H+] -> [OH3+]"`` at its defaults (B3LYP/
    6-31+G*, grid level 3, in core, with FD frequencies: no J/K kernel);
    ``reaction "OO + 2[H] -> 2O" --density-fit --skip-freq`` (the H atom's
    one-atom UKS path and the closed-shell optimizations on DF)."""
    n = run_reaction("O + [H+] -> [OH3+]", [], "reaction_h3o")
    check(not any(n.values()), f"in-core reaction launched {n}")
    n_df = run_reaction("OO + 2[H] -> 2O", ["--density-fit", "--skip-freq"],
                        "reaction_h_df")
    check(all(n_df.values()), f"DF reaction launches {n_df}")
    return n_df


def phase_ir():
    """10e. ``ir --smiles O`` at its defaults (B3LYP/6-31G*, grid level 3,
    in core): frequencies <= 0.05 cm^-1 and intensities <= 1e-3 relative
    from cctpu's FD route; the table written; the PNG written, or skipped
    where matplotlib is missing."""
    from cctpu_torch.workflows import calculate_ir_spectrum
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        ha = calculate_ir_spectrum.main(["--smiles", "O", "--output-dir",
                                         tmp])
        wall = time.time() - t0
        text = _short_report(tmp)
        png = any(f.endswith("_ir.png") for f in os.listdir(tmp))
    orc = WORKFLOW_ORACLES["ir_water"]
    dfreq = float(np.abs(ha.freq_wavenumber - orc["freq"]).max())
    dir_rel = float(np.max(np.abs(ha.ir_intensity - orc["ir"])
                           / np.abs(orc["ir"])))
    skipped = "IR plot skipped" in text
    emit({"phase": "cli_ir_water", "wall_s": wall,
          "freq_cm": ha.freq_wavenumber.tolist(),
          "ir_km_mol": ha.ir_intensity.tolist(),
          "max_abs_dfreq_vs_cctpu": dfreq, "max_rel_dIR_vs_cctpu": dir_rel,
          "png": png, "png_skipped": skipped, "launches": counts()})
    check(dfreq <= 0.05 and dir_rel <= 1e-3,
          f"ir: frequencies {dfreq:.3f} cm^-1, IR {dir_rel:.2e} off cctpu")
    rows = [f"{f:12.1f} {i:12.2f}  " for f, i in zip(ha.freq_wavenumber,
                                                      ha.ir_intensity)]
    check("assignment" in text and all(r in text for r in rows)
          and png != skipped, f"ir: table or plot missing, png {png}")
    check(not any(counts().values()), f"in-core ir launched {counts()}")


def phase_interaction():
    """10f. ``interaction --smiles O --smiles2 O`` at its defaults (MP2/
    6-31+G*, 3.5 A, counterpoise), then with ``--scan --scan-range 3.0 4.0
    --scan-step 0.5`` (the serial warm-start loop): E_int (CP), raw and
    BSSE against cctpu's serial path (<= 1e-4 kcal/mol)."""
    from cctpu_torch.workflows import calculate_interaction, cli
    out = {}
    for tag, extra in (("interaction_water", []),
                       ("interaction_scan", ["--scan", "--scan-range", "3.0",
                                             "4.0", "--scan-step", "0.5"])):
        reset_counts()
        rec, restore = _recording(calculate_interaction,
                                  "interaction_energy")
        try:
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.time()
                rc = cli.main(["interaction", "--smiles", "O", "--smiles2",
                               "O", *extra, "--output-dir", tmp])
                wall = time.time() - t0
                text = _short_report(tmp)
        finally:
            restore()
        orc = WORKFLOW_ORACLES["interaction_water"]
        e_cp, e_raw, corr = rec[0][2]
        devs = [abs(e_cp - orc["e_cp"]), abs(e_raw - orc["e_raw"]),
                abs(corr - orc["bsse"])]
        if extra:
            scan = [r[2][0] for r in rec[1:]]
            devs += [abs(a - b) for a, b in
                     zip(scan, WORKFLOW_ORACLES["interaction_scan"]["scan"])]
            out["scan_kcal"] = [e * HARTREE2KCAL for e in scan]
            check(len(scan) == 3 and "serial warm-start loop" in text,
                  f"interaction scan: {len(scan)} points")
        worst = max(devs) * HARTREE2KCAL
        emit({"phase": f"cli_{tag}", "rc": rc, "wall_s": wall,
              "E_int_cp_kcal": e_cp * HARTREE2KCAL,
              "E_int_raw_kcal": e_raw * HARTREE2KCAL,
              "bsse_kcal": corr * HARTREE2KCAL,
              "max_abs_vs_cctpu_kcal": worst, "launches": counts(), **out})
        check(rc == 0 and worst <= 1e-4,
              f"{tag}: {worst:.2e} kcal/mol from cctpu's")
        check(not any(counts().values()),
              f"in-core interaction launched {counts()}")


def mark(t0, after):
    emit({"phase": "clock", "after": after, "s": time.time() - t0})


def main():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device")
    from cctpu_torch.ops import build, df_jk     # fails outside a checkout
    t_start = time.time()
    card = card_line()
    emit(card)
    emit({"phase": "card", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    dev = torch.device("cuda", 0)
    from cctpu_torch.dft.rks import RKS, UKS

    t0 = time.time()
    build.compile_all()
    for m in ops().values():
        m.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in build.BUILD_LOGS.items()}
    # the W and K products of the f64 W/K kernels issue the FP64 tensor-core
    # instruction (DMMA in the SASS of both libraries)
    dmma = {name: build.sass_count(name, "DMMA")
            for name in ("df_jk_fused", "df_k")}
    emit({"phase": "build", "seconds": time.time() - t0, "ptxas": ptxas,
          "sass_dmma": dmma})
    check(min(dmma.values()) > 0, f"no DMMA in a W/K library: {dmma}")

    fused = phase_kernel(df_jk, dev)
    phase_kernel_j_k(dev)
    mark(t_start, "2a")
    e_phenol, fused["launches"], mf, info = phase_phenol(dev)
    info_phenol = info
    # O y, the hydroxyl H x, C1 y (the molecule lies in z = 0)
    fd_comps = [(6, 1), (7, 0), (0, 1)]
    phase_gradient("gradient_phenol_b3lyp", mf, info, fd_comps,
                   GRAD_ORACLES["phenol_b3lyp"])
    del mf
    torch.cuda.empty_cache()
    mark(t_start, "3e")
    e_phenoxyl, jk, mf, info = phase_phenoxyl(dev)
    phase_gradient("gradient_phenoxyl_ub3lyp", mf, info, [(6, 1), (1, 0)],
                   GRAD_ORACLES["phenoxyl_ub3lyp"])
    del mf
    torch.cuda.empty_cache()
    mark(t_start, "3f")
    phase_h_atom(dev, e_phenol, e_phenoxyl)
    phase_phenol_blyp(dev)
    torch.cuda.empty_cache()
    mark(t_start, "3d")
    phase_c16h34(dev)
    torch.cuda.empty_cache()
    mark(t_start, "4")
    phase_cli("Oc1ccccc1", ["--density-fit"], "cli_energy", "df_jk_fused")
    phase_cli("[O]c1ccccc1", ["--density-fit", "--spin", "1"],
              "cli_energy_spin1", "df_k")
    mark(t_start, "5b")
    phase_small_gradients(dev)
    mark(t_start, "6")

    n_cd = phase_contract(dev)
    mark(t_start, "7")
    mf_in, info_in = phase_incore_phenol(dev, e_phenol)
    mark(t_start, "7b")
    mf_cd, n_phenol_cd, cd_kernels = phase_cholesky_phenol(dev, mf_in.e_tot)
    n_cd = {k: n_cd[k] + n_phenol_cd[k] for k in n_cd}
    mark(t_start, "7c")
    # one central difference (O y): each FD point rebuilds the in-core
    # tensor; the DF gradient of 3e keeps three
    res = phase_gradient("gradient_incore_phenol_b3lyp", mf_in, info_in,
                         fd_comps[:1], None)
    del mf_in
    torch.cuda.empty_cache()
    phase_cd_gradient(mf_cd, res["gradient"])
    del mf_cd
    torch.cuda.empty_cache()
    mark(t_start, "7d")
    phase_small_gradients(dev, density_fit=False)
    mark(t_start, "7e")
    phase_cli("Oc1ccccc1", [], "cli_energy_incore", None)
    phase_cli("[O]c1ccccc1", ["--spin", "1"], "cli_energy_incore_spin1",
              None)
    phase_cli_cache()
    mark(t_start, "7f")

    _, n_opt = phase_opt("water_b3lyp", RKS, WATER_START, 0, dev)
    mark(t_start, "8")
    _, n_nh2 = phase_opt("nh2_ub3lyp", UKS, NH2_START, 1, dev)
    n_opt = {k: n_opt[k] + n_nh2[k] for k in n_opt}
    mark(t_start, "8b")
    n_phenol = phase_opt_phenol(dev)
    n_opt = {k: n_opt[k] + n_phenol[k] for k in n_opt}
    torch.cuda.empty_cache()
    mark(t_start, "8c")
    n_hess = phase_hessian(dev)
    mark(t_start, "8d")
    phase_cli_opt()
    mark(t_start, "8e")
    check(all(n_opt.values()), f"a kernel never ran in 8-8c: {n_opt}")

    mf, info, k_lr = phase_rsh_phenol(dev, info_phenol)
    n_rsh = dict(info["launches"])
    rsh_gradient("gradient_phenol_wb97xd", mf, info, fd_comps,
                 RSH_ORACLES["phenol_wb97xd"]["grad"])
    del mf
    torch.cuda.empty_cache()
    mark(t_start, "9b")
    for n in (phase_rsh_m062x(dev), phase_rsh_nh2(dev),
              phase_rsh_water(dev)):
        n_rsh = {k: n_rsh[k] + n[k] for k in n_rsh}
    torch.cuda.empty_cache()
    mark(t_start, "9e")
    phase_rsh_cli()
    mark(t_start, "9f")
    check(all(n_rsh.values()), f"a kernel never ran in 9-9e: {n_rsh}")

    n_wf = phase_mp2(dev)
    mark(t_start, "10")
    for phase, after in ((phase_cli_mp2, "10a"), (phase_bde, "10b")):
        n = phase()
        n_wf = {k: n_wf[k] + n[k] for k in n_wf}
        mark(t_start, after)
    n, tzvp = phase_bde_default(dev)
    n_wf = {k: n_wf[k] + n[k] for k in n_wf}
    mark(t_start, "10c")
    n = phase_reaction()
    n_wf = {k: n_wf[k] + n[k] for k in n_wf}
    mark(t_start, "10d")
    phase_ir()
    mark(t_start, "10e")
    phase_interaction()
    mark(t_start, "10f")
    check(all(n_wf.values()), f"a kernel never ran in 10-10f: {n_wf}")

    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    cd_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")
    rows = [("df_jk_fused", "cctpu_torch/ops/csrc/df_jk_fused.cu",
             "cctpu/ops/df_jk_pallas.py:167", fused),
            ("df_j", "cctpu_torch/ops/csrc/df_j.cu",
             "cctpu/ops/df_jk_pallas.py:46,53", jk["df_j"]),
            ("df_k", "cctpu_torch/ops/csrc/df_k.cu",
             "cctpu/ops/df_jk_pallas.py:66", jk["df_k"])]
    emit(card)
    emit({"kernels": [{"name": name, "route": "cuda", "source": src,
                       "replaces": rep, **{k: d[k] for k in keys},
                       "launches_cholesky": n_cd[name],
                       "launches_opt": n_opt[name],
                       "launches_hessian": n_hess[name],
                       "launches_rsh": n_rsh[name],
                       "launches_workflows": n_wf[name],
                       "cholesky_shape": {k: cd_kernels[name][k]
                                          for k in cd_keys},
                       "def2tzvp_shape": {k: tzvp[name][k]
                                          for k in cd_keys},
                       **({"b_lr_shape": {k: k_lr[k] for k in cd_keys}}
                          if name == "df_k" else {})}
                      for name, src, rep, d in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
