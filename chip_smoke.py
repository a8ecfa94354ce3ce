#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port ``cctpu_torch`` on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one printed line or more each:

0. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
1. build the four hand-written CUDA kernels (one nvcc per source, all
   started together, into build/cctpu_torch/), and count the FP64
   tensor-core instructions (DMMA) in the SASS of the two W/K libraries
   and of ``df_k_dm``;
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
7d. the direct nuclear gradient of 7b's SCF, as 3e (no oracle and, for
   the script's time limit, no central difference: invariance, bitwise
   repeat, s/iter), and
   that of 7c's Cholesky SCF against it (<= 1e-7 Ha/bohr);
7e. phase 6's three cases in-core against cctpu's CPU-f64 in-core
   gradients (<= 1e-7 Ha/bohr; ``scripts/make_incore_oracles.py``);
7f. the ``energy`` CLI without ``--density-fit`` (the default route,
   in-core: no J/K kernel) on phenol and the phenoxyl radical, then on
   phenol twice with ``--scf-cache``: the second run warm-starts, takes
   fewer cycles and agrees (<= 1e-10 Ha);
8. geometry optimization (``cctpu_torch.geomopt.optimizer.optimize``):
   water DF-B3LYP/6-31G* (grid level 2, conv_tol 1e-12, orbital gradient
   <= 1e-8) from cctpu's tests/test_geomopt.py start, once (no repeat,
   for the script's time limit; 3e-3f, 7d and 9b repeat their gradients
   bitwise): against
   cctpu's CPU-f64 ``optimize`` on the same inputs (the same steps, every
   step's energy <= 1e-8 Ha, final coordinates <= 1e-5 bohr), the fused
   kernel every cycle;
8b. the same for the NH2 radical, DF-UB3LYP (DF-J every cycle, DF-K
   twice a cycle);
8c. phenol DF-B3LYP/6-31G* from bench.py's geometry (grid level 2,
   phase 3e's conv_tol): step 0's energy against ``PHENOL_E_CONV``
   (<= 1e-8 Ha) and gradient against cctpu's (<= 1e-7 Ha/bohr),
   converged within 30 steps, the final projected gmax < 4.5e-4 and the
   energy below the start; steps, SCF cycles, s/step and its split into
   ``setup``, ``scf``, ``gradient`` and ``step``, fused launches equal
   to the cycles, and the peak device memory of each step (no growth);
8d. water Hessians with dipole derivatives at 8's final coordinates as
   cctpu reached them. FD (``hessian_fd``): B3LYP frequencies <= 0.05
   cm^-1 and IR intensities <= 1e-3 relative from cctpu's ``hessian_fd``,
   ZPE, E_0K, H and G <= 1e-6 Ha from cctpu's ``thermo`` (in-core RHF's
   FD sweep is not run: no ``hessian_auto`` route takes it). Analytic
   (``hessian_auto``, its log line) on the B3LYP SCF and an in-core RHF
   one: in-core RHF <= 1e-6 from cctpu's analytic
   Hessian; DF-B3LYP <= 1e-4 and frequencies <= 1 cm^-1 from cctpu's FD
   Hessian and the port's (cctpu's B3LYP and DF analytic Hessians did not
   finish on the CPU: see scripts/make_opt_oracles.py), ``df_j`` and
   ``df_k_dm`` launched by its CG;
8e. the ``opt`` CLI on water (``--skip-freq``: its frequencies are 10e's)
   and the ``opt-freq`` CLI at its defaults (B3LYP/6-31+G**, in core, the
   analytic Hessian, named in its report) on H2 (the smallest molecule,
   for the script's time limit): rc 0, the xyz, csv and report files,
   converged, no imaginary mode, no J/K kernel (in core).

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
9f. the ``energy`` CLI with ``--method wb97x-d`` on its default route
   (in core) on water, and on phenol with ``--density-fit`` (against the
   Python API's SCF at the CLI's own geometry, <= 1e-10 Ha), and the
   ``opt`` CLI with CAM-B3LYP/6-31G* and its frequencies (the analytic
   Hessian with the long-range terms, named in its report) on H2:
   converged, no imaginary mode (water and H2, for the script's time
   limit).

10. MP2 (6-31G*, SCFs at conv_tol 1e-12): water RMP2 in core and on its
   Cholesky factor, NH2 UMP2 in core, phenol DF-RHF then MP2 on its B;
   e_corr against cctpu's CPU-f64 MP2 (<= 1e-8 Ha), MP2 seconds and peak
   memory;
10a. ``energy --method mp2 --density-fit`` on phenol: the printed
   correlation energy against the Python API's at the CLI's geometry
   (<= 1e-10 Ha);
10b. the ``bde`` CLI on ethane (HF/STO-3G, --limit 1), on hydrazine
   (HF/STO-3G, --tier same, --limit 1: the parent and both radicals
   re-optimized on the card) and on phenol (B3LYP/6-31G*, --density-fit,
   --limit 2: C-O and O-H): every BDE against cctpu's serial path
   (<= 1e-3 kcal/mol);
10c. ``bde --smiles Oc1ccccc1 --limit 2`` at its defaults (M06-2X/
   def2-TZVP, DF by size, nao 253): rc 0, the CSV, both bonds, all three
   kernels launched, s per SCF, peak memory (no oracle: cctpu's CPU cost
   is out of reach); then the kernels against their plain versions at the
   parent SCF's own factor, as 7c;
10d. the ``reaction`` CLI on "O + [H+] -> [OH3+]" at its defaults (with
   frequencies from the analytic Hessian, named in its report; in core)
   and on "OO + 2[H] -> 2O" with --density-fit --skip-freq: dE, dE0, dH
   and dG against cctpu's FD-route oracle (<= 0.01 kcal/mol);
10e. ``ir --smiles O`` at its defaults (the analytic Hessian, named in its
   report): the optimized energy <= 1e-6 Ha from cctpu's, frequencies <=
   0.05 cm^-1 and intensities <= 2e-3 relative from cctpu's FD route and
   from the port's FD Hessian of the CLI's own SCF (cctpu's analytic one
   of this case is out of its CPU's reach), the table written, the PNG
   written or skipped (no matplotlib);
10f. ``interaction --smiles O --smiles2 O`` at its defaults (MP2/6-31+G*,
   3.5 A, counterpoise) and with --scan over 3.0-4.0 A: E_int (CP), raw
   and BSSE against cctpu's serial path (<= 1e-4 kcal/mol).

11a. ``uv --smiles C=CC=O`` (acrolein) at its defaults (B3LYP/6-31G*,
   grid level 3, full TDDFT by the paired Davidson, 6 states; in core) and
   with ``--density-fit`` (``df_j`` and ``df_k_dm`` in every matvec):
   excitation energies <= 1e-6 eV and f <= 1e-4 from cctpu's CLI at the
   same coordinates (not phenol: cctpu's CPU run of it did not finish
   within an hour); then ``uv --smiles Oc1ccccc1 --density-fit`` with no
   oracle;
11b. NH2 DF-UB3LYP TDDFT (``df_k_dm`` on the spin pairs) and water
   DF-CAM-B3LYP TDDFT (``df_k_dm`` on B and B_lr), 6 states each, through
   the Python API, and ``uv --smiles O --method cam-b3lyp --tda
   --density-fit`` (the TDA's Hermitian Davidson), against cctpu's (the
   same tolerances);
11c. ``uv --smiles CC(=O)Oc1ccccc1C(=O)O`` at its defaults (aspirin, nao
   198: DF by size; no oracle, cctpu's CPU cost is out of reach): wall
   time, matvecs, the TDDFT's seconds in J, K, fxc and host, launches,
   peak memory;
11. ``df_k_dm`` against its plain twin (its library call too) at phenol's
   B, phenol's B_lr (wB97X-D) and aspirin's factor, one density and a
   Davidson block of 12: f64 <= 1e-12 relative, repeats, a density alone
   and a split batch bitwise equal; kernel / plain / bound times, the
   launch plan (``ops/plan.py::k_dm_plan``), the share of its DMMA work
   on padding, the achieved FP64 TFLOP/s and the share of the bound.

12a. the analytic (CPHF) Hessian with dipoles
   (``cctpu_torch.hessian.cphf.analytic_hessian``) of phenol
   DF-B3LYP/6-31G* (grid level 2, conv_tol 1e-12) at 8c's optimized
   geometry, two calls bitwise equal: the wall time split into L_RR/L_kR,
   CG and dipole, the CG iterations, each kernel's launches (``df_j`` and
   ``df_k_dm`` in the CG), the peak memory, |H - H^T| before the
   symmetrization (<= 1e-5), one column against central differences of
   the port's gradients (h = 1e-3 bohr, <= 1e-4 Ha/bohr^2), no imaginary
   mode, its dX/dR within ``cphf.DF_DX_BYTES_MAX`` (``hessian_auto``'s
   analytic route);
12b. NH2 DF-UB3LYP/6-31G* at 8b's optimized geometry (the whole
   unrestricted Hessian) against four of the port's FD columns (<= 1e-4);
12c. water DF-CAM-B3LYP/6-31G* at 8's optimized geometry (K_lr on B_lr
   in the CG, the long-range DF terms) against one of the port's FD
   columns (O z; <= 1e-4).

13a. phenol DF-B3LYP/6-31G* with IEF-PCM water (2,106 surface points;
   grid level 2, conv_tol 1e-10) through the Python API against cctpu's
   CPU-f64 energy (<= 1e-8 Ha): the fused kernel every cycle, the PCM
   set-up's seconds and bytes, s/cycle, peak memory; then its gradient as
   3e (the ``pcm`` phase among the terms; two central differences of the
   port's PCM energy at h = 1e-4 bohr; cctpu's gradient <= 1e-7);
13b. the ``solvent`` CLI on phenol at its defaults (B3LYP/6-31G*, grid
   level 3, in core: no J/K kernel; water, IEF-PCM): E_gas, E_sol,
   dG_solv, both dipoles and both gaps against cctpu's CLI on the same
   coordinates;
13c. ``solvent --smiles O --pcm-method c-pcm --compare-solvents --opt``:
   the same, the in-solvent optimization step by step and the 7-solvent
   table against cctpu's;
13d. NH2 DF-UB3LYP/6-31G* with PCM: energy and gradient against cctpu's
   (``df_j`` every cycle, ``df_k`` twice);
13e. ``hessian_auto`` on water DF-B3LYP/6-31G* with PCM at phase 6's
   geometry: the analytic route (``df_j`` and ``df_k_dm`` in its CG)
   against two of the port's FD columns of PCM gradients (h = 1e-4 bohr;
   <= 1e-4).

14a. phenol DF-B3LYP/6-31G* (grid level 2, conv_tol 1e-12, orbital
   gradient <= 1e-8) GIAO shieldings (``cctpu_torch.response.giao_nmr``):
   the wall time split into 1e integrals, 2e skeleton, XC skeleton, CG
   (its iterations per field direction) and assembly, ``df_k_dm``
   launches (the CPHF's matvecs), peak memory; against cctpu's CPU-f64
   shieldings where ``NMR_ORACLES`` holds them, else by translation
   invariance (cctpu's CPU run of phenol died of XLA's memory maps; <=
   1e-4 ppm);
14b. water DF-B3LYP, DF-CAM-B3LYP (``df_k_dm`` on B_lr; and its
   translation invariance), DF-M06-2X and NH2 DF-UB3LYP (``df_j``/``df_k``
   in its SCF), 6-31G*, against cctpu's shieldings (<= 1e-4 ppm);
14c. ``nmr --smiles Oc1ccccc1 --skip-opt`` at its defaults (B3LYP/
   6-311G**, DF by size), the TMS reference computed on the card into a
   fresh memo: rc 0, a sigma and a delta for every H and C, the memo under
   the port's name, the wall time split into SCF, GIAO and TMS, launches,
   peak memory (no oracle: cctpu's CPU cost is out of reach);
14d. ``nmr --smiles C --method hf --basis sto-3g`` (in core) with its
   optimization and its computed TMS reference: sigma, sigma_ref and
   delta against cctpu's CLI on the same coordinates (<= 1e-4 ppm).

The oracles of 8, 8b and 8d (``OPT_ORACLES``) come from
``python scripts/make_opt_oracles.py <case>``, those of 9a-9e
(``RSH_ORACLES``) from ``python scripts/make_rsh_oracles.py <case>``,
those of 10-10f (``WORKFLOW_ORACLES``) from
``python scripts/make_workflow_oracles.py <case>``, those of 11a-11b
(``UV_ORACLES``) from ``python scripts/make_uv_oracles.py <case>``,
those of 13a-13d (``PCM_ORACLES``) from
``python scripts/make_pcm_oracles.py <case>``, those of 14a-14d
(``NMR_ORACLES``) from ``python scripts/make_nmr_oracles.py <case>``.

Any failure raises: the script then exits non-zero without its last line.
The line before the last lists each kernel with its launches on the main
path, its error, its time beside its plain version's and its bound, and
its launches on the Cholesky phases (7, 7c) and its numbers at 7c's
factor, its launches in the optimizations (8-8c), the FD Hessian (8d)
and the range-separated SCFs (9a, 9c-9e), its launches in the
workflows (10-10f) and its numbers at 10c's def2-TZVP factor, and
``df_k``'s numbers at B_lr (9), and its launches in the TDDFT phases
(11a-11c), in the analytic Hessians (12a-12c), in the solvent
phases (13a-13e) and in the NMR phases (14a-14d); ``df_k_dm``'s row has
its launches in the TDDFT phases, the Hessians of 8d and of 12, the
solvent and the NMR phases, its
numbers at phenol's B with 12 densities (with the plan, padded share,
TFLOP/s and share of the bound) and at every shape of phase 11, and the
seconds of aspirin's TDDFT in K (11c) and of 12a's two CGs.
A ``clock``
line after each group of
phases gives the seconds since the start. The last line is
``{"ok": true, "device": {...}}``. Needs no network and imports nothing
of JAX or of the JAX package.
"""

import os
import tempfile
import time

import numpy as np

from cctpu_torch.utils.measure import (ASPIRIN, C16H34_SHAPE, F64_SHAPES,
                                       H_ATOM,
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
HARTREE2EV = 27.211386024367243
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
    "bde_hydrazine_hf_same": {  # cctpu on the CPU: 168.9 s
        "e_parent": -109.74805699190998,
        "bde": {"N0-N1": 43.58772665814778},
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


# cctpu's CPU-f64 TDDFT results of phases 11a-11b, as
# ``python scripts/make_uv_oracles.py <case>`` prints them (one process a
# case): excitation energies (Ha) and oscillator strengths. uv_acrolein
# (_df): cctpu's uv CLI at its defaults on acrolein's SMILES at the port's
# embedded coordinates (in core, and with --density-fit; phenol's did not
# finish within an hour on the CPU); the others cctpu's SCF
# (6-31G*, DF, grid level 2, conv_tol 1e-12, conv_tol_grad 1e-9) at the
# geometries of cctpu_torch/utils/measure.py, then its TDDFT with 6
# states; uv_water_camb3lyp_tda_df: cctpu's uv CLI with --method cam-b3lyp
# --tda --density-fit on water at the port's embedded coordinates. cctpu
# on the CPU: uv_acrolein 1,379 s, uv_acrolein_df 1,551 s, nh2_ub3lyp_df
# 207 s, water_camb3lyp_df 319 s, uv_water_camb3lyp_tda_df 425 s.
UV_ORACLES = {
    "uv_acrolein": {
        "e_scf": -191.7408371273715,
        "e": [
            0.029697814326577, 0.10513175266942698, 0.14094741102175296,
            0.17747802719479805, 0.23248367300910477, 0.26097909048023127],
        "f": [
            0.0010518958488269108, 0.005712687110152588, 0.0535633477766729,
            0.02451282782601522, 0.002961445679305789, 0.0336488098587678],
        "converged": True,
    },
    "uv_acrolein_df": {
        "e_scf": -191.74083783166407,
        "e": [
            0.029702100656638027, 0.10513329083297157, 0.14094788662546498,
            0.17747777934608328, 0.23248463688912266, 0.2609798216365691],
        "f": [
            0.0010521910395558261, 0.005712878139016657, 0.053563023211482576,
            0.02451339489896471, 0.00296141102446487, 0.03364811511763131],
        "converged": True,
    },
    "nh2_ub3lyp_df": {
        "e_scf": -55.87099329938427,
        "e": [
            0.0878007601624062, 0.25443744527716694, 0.30398344524527315,
            0.3162104282544573, 0.34316802786717027, 0.3580994300955667],
        "f": [
            0.002971942685589923, 2.876295721201214e-30, 0.0032108007835401227,
            0.008997554270426278, 0.09484296805268384, 0.0030275034003339075],
        "converged": True,
    },
    "water_camb3lyp_df": {
        "e_scf": -76.41520246399878,
        "e": [
            0.3003227190220948, 0.3750476354014928, 0.3927629075491846,
            0.4745924139927436, 0.5457413080785564, 0.666404653445512],
        "f": [
            0.01587153161975355, 1.2727782437168717e-28, 0.09029033306935313,
            0.07011556956874201, 0.3859295928058789, 0.20118950421781331],
        "converged": True,
    },
    "uv_water_camb3lyp_tda_df": {
        "e_scf": -76.41428003484049,
        "e": [
            0.3029494527114689, 0.37834277376767, 0.3860975113597084,
            0.4695581174052868, 0.5597214423887629, 0.6855454973589346],
        "f": [
            0.01551174666223788, 3.1920776368629337e-12, 0.08911742295061172,
            0.08922114163332372, 0.42666365419293495, 0.20605647182626935],
        "converged": True,
    },
}


# cctpu's CPU-f64 PCM results (IEF-PCM water unless named; ``python
# scripts/make_pcm_oracles.py <case>``, one case a process)
PCM_ORACLES = {
    "phenol_df_b3lyp": {
        "E": -307.46847244331195,
        "cycles": 12,
    },
    "phenol_df_b3lyp_grad": {
        "E": -307.46847244331775,
        "cycles": 26,
        "gradient": [
            [-0.006210704820042241, -0.004527601171360529,
             -1.0552621487038543e-15],
            [-0.00512714764030396, 0.010538529870016751,
             3.9048606119493147e-16],
            [0.004107343579083494, -0.002734200232458431,
             -8.689293242582087e-16],
            [8.849620405485025e-07, 0.002191941532971367,
             -2.93554324070117e-16],
            [-0.0061095844180999725, -0.003146443705270892,
             2.087178241791008e-15],
            [0.005611959559855251, -0.000558940332247934,
             -1.875444609044991e-16],
            [-0.0031937302365970498, -0.006823098781716692,
             1.2025440839942829e-15],
            [0.012254059561343704, 0.006629668854928554, -7.0276098750179e-16],
            [-0.0020012829261731443, -0.001965008328552845,
             -9.228806359049087e-17],
            [-0.0019364378688790933, 4.851062395141558e-05,
             -2.2160856081850603e-16],
            [-4.293046391295521e-05, 0.002989528989405437,
             5.2384560054176445e-17],
            [0.0019267961098659962, -0.0002987919814943338,
             4.991684958784392e-16],
            [0.0007207746017687644, -0.002344095338127246,
             2.474212245738307e-16],
        ],
        "pcm_term": [
            [0.004841132518978024, -0.0007919015455780661,
             -6.700566361120654e-16],
            [0.004379837854983208, 0.006998648833441097,
             9.188115779958138e-16],
            [0.006010909350886667, -0.0011379957556983094,
             -2.5274277299942166e-16],
            [0.0008357774037379531, -0.005155428026955508,
             4.060320195299269e-16],
            [-0.0054172966324158855, -0.0036431549772393784,
             -9.175907917605836e-16],
            [-0.004233704080152023, 0.0011142691536556145,
             2.136225563304818e-16],
            [0.01435948182584693, 0.006019496135883844,
             -3.373435767382339e-17],
            [-0.013181062426751352, -0.004211545480155228,
             2.5075986886989934e-17],
            [-0.006013714375948955, -0.0035132682091735287,
             -3.431525816300631e-16],
            [-0.0030603754338094373, 0.0010803278692313135,
             -1.4504089262970207e-16],
            [-0.00010713302256101376, 0.0016228589658910102,
             5.0530809259639355e-18],
            [0.001581084200311316, 0.0007128428780520282,
             5.001996633612825e-16],
            [5.062816894590885e-06, 0.0009048501586451027,
             2.8553271788837795e-16],
        ],
    },
    "nh2_df_ub3lyp": {
        "E": -55.87924406975607,
        "cycles": 24,
        "gradient": [
            [-1.4010413908729907e-16, -1.1736762870196764e-16,
             0.010982870351439876],
            [1.9379930288441245e-16, -0.003956498594261894,
             -0.005491435175720583],
            [-6.31004268070654e-17, 0.003956498594260678,
             -0.00549143517572191],
        ],
        "pcm_term": [
            [3.6674832550216696e-17, 1.0744898809540498e-16,
             0.01607273462852301],
            [1.6852683985601807e-16, -0.004593718375468904,
             -0.008036367314261484],
            [-2.043723212717544e-16, 0.0045937183754687985,
             -0.008036367314261479],
        ],
    },
    "cli_phenol": {
        "e_gas": -307.42144476114566,
        "e_sol": -307.43093002822974,
        "mu_gas": 1.5988337606095517,
        "gap_gas": 0.2464153934940498,
        "mu_sol": 1.8773234991826215,
        "gap_sol": 0.24655050899659028,
    },
    "cli_water_cpcm_opt": {
        "e_gas": -76.40575891515272,
        "e_sol": -76.41863489488068,
        "mu_gas": 1.9896349197985699,
        "gap_gas": 0.36091003852368764,
        "mu_sol": 2.4044867031789674,
        "gap_sol": 0.378082695459051,
        "opt_energies": [-76.41679863870473, -76.41848700870565,
                         -76.41863250334963, -76.41863465331707,
                         -76.41863489488068],
        "opt_coords": [
            [0.6790010222378641, -2.2973914116718865, -0.014786770686630864],
            [1.2379234053930743, -0.9721395999013951, 1.1223826753751402],
            [0.6799271017226006, -1.4298503130602664, -1.6311076424920168],
        ],
        "table": [-76.4167986387047, -76.41669290869403, -76.41662119811004,
                  -76.41658112297714, -76.41559698489651, -76.41200301796968,
                  -76.41074908803182],
    },
}

# cctpu's CPU-f64 NMR results (scripts/make_nmr_oracles.py <case>): GIAO
# shielding tensors (ppm, one row of 9 per atom) of phases 14a-14b's SCFs,
# and its ``nmr`` CLI on methane (14d)
NMR_ORACLES = {
    "card_nh2_ub3lyp": {
        "E": -55.87099329938427,
        "giao": [
            [250.87121152127224, 1.9713529723693768e-13,
             -1.358171199526118e-13, -9.988563776667963e-13,
             -794.4837343482372, 1.1545430164793405e-12,
             -1.6921621295276197e-15, 3.423006538966813e-13,
             -69.78117517608423],
            [28.14260551866469, -7.329660673012696e-12,
             9.287690819241752e-12, 4.53896429112596e-12,
             -2.9256120657831985, -19.22716280678464,
             -1.8389239395991726e-13, -2.2508822807197273, 24.992478142193118],
            [28.14260551867905, -7.093390274204798e-12,
             -8.997864858449797e-12, 4.740229849648886e-12,
             -2.9256120657836457, 19.22716280678392, -8.593699220451438e-15,
             2.250882280719029, 24.99247814219221],
        ],
    },
    "card_water_b3lyp": {
        "E": -76.40680895083187,
        "giao": [
            [301.56940761955, -6.026040330047356e-13, 2.43382616305045e-13,
             1.9002628142369992e-13, 350.6354711750296,
             1.267403851426924e-12, 1.5162686964316037e-13,
             -4.115021050774535e-13, 319.93423796225085],
            [25.50824214009328, -9.446984394493414e-15,
             1.0311766021062245e-14, -9.046824441795533e-12,
             39.66738982987995, -6.485063354448509, -3.422930699815582e-12,
             -8.819595085817124, 31.91856033134697],
            [25.50824214009399, 1.0128553637614925e-13,
             -1.0674139296736943e-13, -3.945395100581284e-12,
             39.667389829879696, 6.4850633544489575, 1.3323395169702275e-12,
             8.819595085817124, 31.91856033134706],
        ],
    },
    "card_water_camb3lyp": {
        "E": -76.41520246399878,
        "giao": [
            [305.0484143625963, -6.304074821523979e-13,
             2.468299571304498e-13, -1.2907754676088264e-13,
             353.71575522920284, 1.1794153551817239e-12,
             1.2137118475759009e-13, -3.689512377987708e-13,
             322.30142491641607],
            [25.347466950725167, 3.84119089134878e-14, 7.427180500481876e-14,
             2.6889431324660183e-13, 39.57998570229518, -6.695155064174096,
             -2.1344919929037876e-11, -8.900025679332428, 31.82887269849487],
            [25.347466950726954, 7.983037705109076e-14,
             -6.935681828284522e-14, -3.168259271692615e-13,
             39.57998570229524, 6.6951550641741, 2.015108663821344e-11,
             8.900025679329753, 31.828872698498373],
        ],
    },
    "card_water_m062x": {
        "E": -76.37212643113504,
        "giao": [
            [293.03175732104705, -6.108818896163422e-13,
             2.07500581605934e-13, 2.317222900615115e-13, 345.0640986763226,
             1.4354942109861601e-12, 6.673573323680177e-14,
             -1.0058632425091042e-13, 307.51942464135067],
            [25.603241710624037, 1.9954150157482409e-13,
             2.759035097461079e-13, -3.0089848304383506e-12,
             39.68330501540622, -6.399579164561324, -3.4421961996786293e-12,
             -8.532575305230603, 31.893690512319335],
            [25.603241710621777, 2.291644510391415e-13,
             -2.625736655776197e-13, -1.0571909015049414e-11,
             39.68330501540788, 6.399579164559285, 4.722706473679637e-12,
             8.53257530523117, 31.893690512318685],
        ],
    },
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
    from cctpu_torch.ops import df_j, df_jk, df_k, df_k_dm
    return {"df_jk_fused": df_jk, "df_j": df_j, "df_k": df_k,
            "df_k_dm": df_k_dm}


def reset_counts():
    for m in ops().values():
        m.LAUNCHES = 0


def counts() -> dict:
    return {name: m.LAUNCHES for name, m in ops().items()}


def scf_kernels_ran(n) -> bool:
    """Every kernel an SCF runs (all but the response's ``df_k_dm``) was
    launched in the launch counts ``n``."""
    return all(v for k, v in n.items() if k != "df_k_dm")


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
            conv_tol=1e-10, dm0=None, max_cycle=60, wrap=None, **kw):
    """One SCF through the Python API (from ``dm0`` when given) with the
    kernels' launch counts reset just before and read just after; returns
    (mf, E, info). ``df_build_s`` is the J/K builder's build (DF tensors,
    the in-core tensor or the Cholesky factor), ``lr_build_s`` that of a
    range-separated functional's attenuated tensors (B_lr, or the
    attenuated in-core tensor), ``wrap_s`` that of ``wrap(mf)`` (a solvent
    model's set-up); ``peak_mem_GB`` the card's peak over set-up and
    SCF."""
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
    if wrap is not None:
        mf = wrap(mf)
    torch.cuda.synchronize()
    t_wrap = time.time() - t0
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
            "ao_cache_s": t_ao, "wrap_s": t_wrap,
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


def fd_gradient(mf, comps, h=1e-3, wrap=None):
    """Central differences of the port's card energy at components
    ``comps`` [(atom, axis)]: SCFs of ``mf``'s kind (each passed through
    ``wrap``, a solvent model, when given) at +-h bohr, warm started from
    ``mf.dm``, at conv_tol 1e-12."""
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
            if wrap is not None:
                m2 = wrap(m2)
            e.append(m2.kernel(dm0=mf.dm))
            check(m2.converged, f"FD SCF at {ia},{ax} did not converge")
        out.append((e[0] - e[1]) / (2 * h))
    return out


def phase_gradient(tag, mf, info, fd_comps, oracle, wrap=None, h=1e-3):
    """The DF nuclear gradient of phase ``info``'s SCF ``mf``, continued
    from its density to conv_tol 1e-12 and an orbital gradient <= 1e-8:
    two calls (bitwise equal), per-term seconds, peak device memory,
    s/iter, translational invariance, central differences at ``fd_comps``
    (step ``h`` bohr; SCFs passed through ``wrap``, as ``fd_gradient``)
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
    fd = fd_gradient(mf, fd_comps, h=h, wrap=wrap) if fd_comps else []
    fd_err = [abs(float(g[ia, ax]) - f) for (ia, ax), f in zip(fd_comps, fd)]
    orc_err = None if oracle is None \
        else float(np.abs(g - np.asarray(oracle)).max())
    res = {"phase": tag, "card": card_line(), "E": mf.e_tot,
           "cycles_to_1e-12": mf.n_cycles, "grad_s_first": s1,
           "grad_s": s2, "terms_s_first": terms1, "terms_s": terms2,
           "peak_mem_GB": peak / 1e9, "bitwise_repeat": bitwise,
           "max_abs_sum_g": inv, "fd_components": fd_comps,
           "fd": fd, "fd_step": h, "abs_err_fd": fd_err,
           "abs_err_vs_cctpu": orc_err,
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
    want["df_k_dm"] = 0
    check(n == want, f"{tag}: launches {n}, expected {want}")


def phase_opt(tag, cls, atoms, spin, dev):
    """8, 8b. ``optimize`` from ``atoms`` once, held against cctpu's
    CPU-f64 optimization (``OPT_ORACLES[tag]``): the same steps, every
    step's energy <= 1e-8 Ha, final coordinates <= 1e-5 bohr; the DF
    kernels every cycle. One run, no repeat, for the script's time limit.
    Returns the result and launches."""
    import torch
    from cctpu_torch.core.molecule import Molecule
    from cctpu_torch.geomopt.optimizer import optimize
    from cctpu_torch.utils.profiling import PhaseTimer
    orc = OPT_ORACLES[tag]
    mol = Molecule.from_atoms(atoms, spin=spin, basis="6-31g*")
    timer = PhaseTimer(dev)
    reset_counts()
    t0 = time.time()
    res = optimize(opt_factory(cls, dev), mol, timer=timer)
    torch.cuda.synchronize(dev)
    n, wall, phases = counts(), time.time() - t0, timer.phases
    k = min(res.nsteps, orc["nsteps"])
    de = float(np.abs(np.subtract(res.energies[:k],
                                  orc["energies"][:k])).max())
    dx = float(np.abs(res.mol.coords - np.asarray(orc["coords"])).max())
    emit({"phase": f"opt_{tag}", "converged": res.converged,
          "steps": res.nsteps, "steps_cctpu": orc["nsteps"],
          "cycles": res.cycles, "energies": res.energies,
          "max_abs_dE_vs_cctpu": de, "max_abs_dx_vs_cctpu_bohr": dx,
          "wall_s": wall, "phases_s": phases,
          "launches": n})
    check(res.converged and res.nsteps == orc["nsteps"],
          f"{tag}: {res.nsteps} steps (converged {res.converged}), cctpu "
          f"{orc['nsteps']}")
    check(de <= 1e-8, f"{tag}: step energies {de:.2e} Ha from cctpu's")
    check(dx <= 1e-5, f"{tag}: final coordinates {dx:.2e} bohr off")
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
    return n, res.mol


def phase_hessian(dev):
    """8d. Water Hessians with dipoles at cctpu's optimized water geometry,
    from one SCF each there. The FD route (``hessian_fd``): DF-B3LYP
    against cctpu's FD Hessian, harmonic analysis and thermo. The analytic
    route (``hessian_auto``): in-core RHF against cctpu's analytic
    Hessian (<= 1e-6); DF-B3LYP against cctpu's FD Hessian and the port's
    (<= 1e-4, frequencies <= 1 cm^-1: FD error; cctpu's B3LYP and DF
    analytic Hessians did not finish on the CPU). (In-core RHF's FD sweep
    is not run: no ``hessian_auto`` route takes it, and the script's time
    limit.) Returns the launches of both routes."""
    from cctpu_torch.core.molecule import Molecule
    from cctpu_torch.dft.rks import RKS
    from cctpu_torch.hessian.frequencies import harmonic_analysis, \
        hessian_auto, hessian_fd
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
        res = out[tag] = {"E": mf.kernel()}
        if tag == "b3lyp":
            reset_counts()
            t0 = time.time()
            H, dmu = hessian_fd(factory, mol, dm0=mf.make_rdm1())
            n = counts()
            ha = harmonic_analysis(mol, H, dmu)
            n_all = dict(n)
            th = thermo(mol, ha.freq_au, res["E"])
            res.update({
                "wall_s": time.time() - t0,
                "freq_cm": ha.freq_wavenumber.tolist(),
                "ir_km_mol": ha.ir_intensity.tolist(),
                "n_imaginary": ha.n_imaginary, "launches": n,
                "max_abs_dfreq_vs_cctpu_fd": float(np.abs(
                    ha.freq_wavenumber - np.asarray(fd["freq_cm"])).max()),
                "max_rel_dIR_vs_cctpu_fd": float(np.max(
                    np.abs(ha.ir_intensity - np.asarray(fd["ir_km_mol"]))
                    / np.abs(fd["ir_km_mol"]))),
                "max_abs_dH_vs_cctpu_fd": float(np.abs(
                    H - np.asarray(fd["hessian"])).max()),
                "abs_dthermo_vs_cctpu": {
                    k: abs(th[k][0] - fd[k]) for k in ("ZPE", "E_0K",
                                                       "H_tot", "G_tot")}})
            check(ha.n_imaginary == 0, "water b3lyp has an imaginary mode")
            # DF: the fused kernel in every SCF
            check(n["df_j"] == n["df_k"] == 0
                  and n["df_jk_fused"] >= 6 * mol.natm,
                  f"water b3lyp FD Hessian launches {n}")
            check(res["max_abs_dfreq_vs_cctpu_fd"] <= 0.05,
                  f"water frequencies {res['max_abs_dfreq_vs_cctpu_fd']:.3f}"
                  " cm^-1 off cctpu's FD")
            check(res["max_rel_dIR_vs_cctpu_fd"] <= 1e-3,
                  f"water IR intensities {res['max_rel_dIR_vs_cctpu_fd']:.2e}"
                  " relative off cctpu's")
            check(max(res["abs_dthermo_vs_cctpu"].values()) <= 1e-6,
                  f"water thermo off cctpu's: {res['abs_dthermo_vs_cctpu']}")
        # the analytic route on the same SCF
        reset_counts()
        t0 = time.time()
        log = []
        Ha, dmua = hessian_auto(mf, factory, mol, dm0=mf.make_rdm1(),
                                log=log.append)
        na = counts()
        n_all = {k: n_all.get(k, 0) + na[k] for k in na}
        hb = harmonic_analysis(mol, Ha, dmua)
        ana = {"wall_s": time.time() - t0, "log": log,
               "freq_cm": hb.freq_wavenumber.tolist(),
               "ir_km_mol": hb.ir_intensity.tolist(), "launches": na}
        check(log == ["  Hessian: analytic (AD-native CPHF)"],
              f"hessian_auto did not take the analytic route: {log}")
        check(hb.n_imaginary == 0, f"water {tag} analytic: imaginary mode")
        if tag == "b3lyp":
            ana["max_abs_dH_vs_port_fd"] = float(np.abs(Ha - H).max())
            ana["max_abs_dfreq_vs_port_fd"] = float(np.abs(
                hb.freq_wavenumber - ha.freq_wavenumber).max())
            ana["max_abs_dH_vs_cctpu_fd"] = float(np.abs(
                Ha - np.asarray(fd["hessian"])).max())
            ana["max_abs_dfreq_vs_cctpu_fd"] = float(np.abs(
                hb.freq_wavenumber - np.asarray(fd["freq_cm"])).max())
            check(max(ana["max_abs_dH_vs_cctpu_fd"],
                      ana["max_abs_dH_vs_port_fd"]) <= 1e-4
                  and max(ana["max_abs_dfreq_vs_cctpu_fd"],
                          ana["max_abs_dfreq_vs_port_fd"]) <= 1.0,
                  f"water B3LYP analytic Hessian off the FD ones: {ana}")
            check(na["df_j"] > 0 and na["df_k_dm"] > 0
                  and na["df_jk_fused"] == 0 and na["df_k"] == 0,
                  f"water B3LYP analytic Hessian launches {na}")
        else:
            real = hb.freq_wavenumber > 0
            ana["max_abs_dH_vs_cctpu_analytic"] = float(np.abs(
                Ha - np.asarray(an["hessian"])).max())
            ana["max_abs_dfreq_vs_cctpu_analytic"] = float(np.abs(
                hb.freq_wavenumber[real]
                - np.asarray(an["freq_cm"])[real]).max())
            check(ana["max_abs_dH_vs_cctpu_analytic"] <= 1e-6,
                  f"water RHF analytic |H - H_cctpu| "
                  f"{ana['max_abs_dH_vs_cctpu_analytic']:.2e}")
            check(not any(na.values()), f"in-core Hessian launched {na}")
        res["analytic"] = ana
    emit({"phase": "hessian_water", **out})
    return n_all


def phase_cli_opt(runs=(("opt", "O", ("_optimized.xyz",), ("--skip-freq",)),
                        ("opt-freq", "[H][H]", ("_optimized.xyz", "_ir.csv"),
                         ())),
                  extra=(), tag="cli"):
    """8e. The ``opt`` CLI on water and the ``opt-freq`` CLI on H2, default
    routes (in core: no J/K kernel), on the card; ``extra`` arguments for
    all. The ``opt`` run skips its frequencies: they are the same
    optimization and FD Hessian as 10e's ``ir`` CLI (B3LYP/6-31G*, in
    core), which holds them against cctpu's. ``opt-freq`` runs at its
    defaults (B3LYP/6-31+G**, FD frequencies) on H2, the smallest
    molecule, for the script's time limit."""
    from cctpu_torch.workflows import cli
    for name, smiles, files, args in runs:
        reset_counts()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            rc = cli.main([name, "--smiles", smiles, *extra, *args,
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
        analytic = ("--skip-freq" in args
                    or "Hessian: analytic (AD-native CPHF)" in text)
        emit({"phase": f"{tag}_{name}", "rc": rc, "wall_s": wall,
              "files": sorted(names), "converged": converged,
              "no_imaginary_mode": no_imag, "analytic_hessian": analytic,
              "launches": counts()})
        check(rc == 0 and not missing and converged and no_imag
              and analytic,
              f"{name} CLI: rc {rc}, missing {missing}, converged "
              f"{converged}, no imaginary mode {no_imag}, analytic "
              f"Hessian logged {analytic}")
        check(not any(counts().values()),
              f"{name} CLI's in-core route launched {counts()}")


def rsh_launches(tag, n, cycles, open_shell):
    """The DF kernels of a range-separated SCF with ``cycles`` cycles: the
    fused J/K and ``df_k`` (K_lr on B_lr) once a cycle (closed shell), else
    ``df_j`` once and ``df_k`` four times a cycle (K and K_lr per spin)."""
    want = ({"df_jk_fused": 0, "df_j": cycles, "df_k": 4 * cycles}
            if open_shell else
            {"df_jk_fused": cycles, "df_j": 0, "df_k": cycles})
    want["df_k_dm"] = 0
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
    """9f. The ``energy`` CLI with ``--method wb97x-d`` on its default
    route (in core: no kernel) on water, and on phenol with
    ``--density-fit``, against the Python API's SCF at the CLI's own
    geometry (<= 1e-10 Ha). The ``opt`` CLI with CAM-B3LYP/6-31G* and its
    FD frequencies (the long-range gradient at each displacement) on H2:
    converged, no imaginary mode. Water and H2, for the script's time
    limit."""
    from cctpu_torch.io.embed3d import smiles_to_molecule
    from cctpu_torch.workflows import calculate_energy
    from cctpu_torch.workflows.common import make_scf
    phase_cli("O", [], "cli_energy_wb97xd_incore", None, method="wb97x-d")
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
    phase_cli_opt(runs=(("opt", "[H][H]", ("_optimized.xyz",), ()),),
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
    HF/STO-3G --tier same --limit 1 (the fragment-geometry tier: parent and
    radicals optimized), phenol B3LYP/6-31G* --density-fit --limit 2 (C-O:
    phenyl + OH; O-H: phenoxyl + H); every BDE against cctpu's serial path
    (<= 1e-3 kcal/mol)."""
    from cctpu_torch.workflows import calculate_bde
    n_all = {}
    for key, args in (
            ("t_bde_ethane", ["--smiles", "CC", "--method", "hf", "--basis",
                              "sto-3g", "--limit", "1"]),
            ("bde_hydrazine_hf_same", ["--smiles", "NN", "--method", "hf",
                                       "--basis", "sto-3g", "--tier",
                                       "same", "--limit", "1"]),
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
        check("tier=same" in text or "batched sweep not ported" in text,
              f"{key}: the serial path was not logged")
        n_all = {k: n_all.get(k, 0) + v for k, v in n.items()}
    check(scf_kernels_ran(n_all),
          f"10b's DF phenol never ran a kernel: {n_all}")
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
    check(parent.density_fit and scf_kernels_ran(n),
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
    check("--skip-freq" in args
          or "Hessian: analytic (AD-native CPHF)" in report,
          f"{key}: the analytic Hessian route is not in the report")
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
    check(scf_kernels_ran(n_df), f"DF reaction launches {n_df}")
    return n_df


def phase_ir():
    """10e. ``ir --smiles O`` at its defaults (B3LYP/6-31G*, grid level 3,
    in core; the analytic Hessian, named in its report): the optimization
    against cctpu's (energy <= 1e-6 Ha), the frequencies and intensities
    against cctpu's FD route and against the port's FD Hessian of the
    CLI's own SCF (``hessian_fd``, the factory and geometry the CLI
    passed on), each <= 0.05 cm^-1 and 2e-3 relative (3 and 2 times the
    0.016 cm^-1 and 9.9e-4 measured against both: the FD error); the table
    written; the PNG written, or skipped where matplotlib is missing."""
    from cctpu_torch.hessian.frequencies import harmonic_analysis, hessian_fd
    from cctpu_torch.workflows import calculate_ir_spectrum
    reset_counts()
    rec, restore = _recording(calculate_ir_spectrum, "hessian_auto")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            ha = calculate_ir_spectrum.main(["--smiles", "O", "--output-dir",
                                             tmp])
            wall = time.time() - t0
            text = _short_report(tmp)
            png = any(f.endswith("_ir.png") for f in os.listdir(tmp))
    finally:
        restore()
    n = counts()
    (mf, factory, mol), kw, _, hess_s = rec[0]
    t0 = time.time()
    ha_fd = harmonic_analysis(mol, *hessian_fd(factory, mol, dm0=kw["dm0"]))
    fd_s = time.time() - t0
    orc = WORKFLOW_ORACLES["ir_water"]
    de = abs(mf.e_tot - orc["e_opt"])
    dev = {"port_fd": (float(np.abs(ha.freq_wavenumber
                                    - ha_fd.freq_wavenumber).max()),
                       float(np.max(np.abs(ha.ir_intensity
                                           - ha_fd.ir_intensity)
                                    / np.abs(ha_fd.ir_intensity)))),
           "cctpu_fd": (float(np.abs(ha.freq_wavenumber
                                     - orc["freq"]).max()),
                        float(np.max(np.abs(ha.ir_intensity - orc["ir"])
                                     / np.abs(orc["ir"]))))}
    skipped = "IR plot skipped" in text
    emit({"phase": "cli_ir_water", "wall_s": wall, "hessian_s": hess_s,
          "port_fd_hessian_s": fd_s,
          "freq_cm": ha.freq_wavenumber.tolist(),
          "ir_km_mol": ha.ir_intensity.tolist(),
          "abs_dE_opt_vs_cctpu": de,
          "max_abs_dfreq_vs_port_fd": dev["port_fd"][0],
          "max_rel_dIR_vs_port_fd": dev["port_fd"][1],
          "max_abs_dfreq_vs_cctpu_fd": dev["cctpu_fd"][0],
          "max_rel_dIR_vs_cctpu_fd": dev["cctpu_fd"][1],
          "png": png, "png_skipped": skipped, "launches": n})
    check(de <= 1e-6, f"ir: optimized energy {de:.2e} Ha off cctpu's")
    for ref, (dfreq, dir_rel) in dev.items():
        check(dfreq <= 0.05 and dir_rel <= 2e-3,
              f"ir: frequencies {dfreq:.3f} cm^-1, IR {dir_rel:.2e} off "
              f"the {ref} Hessian")
    check("Hessian: analytic (AD-native CPHF)" in text,
          "ir: the analytic Hessian route is not in the report")
    rows = [f"{f:12.1f} {i:12.2f}  " for f, i in zip(ha.freq_wavenumber,
                                                      ha.ir_intensity)]
    check("assignment" in text and all(r in text for r in rows)
          and png != skipped, f"ir: table or plot missing, png {png}")
    check(not any(n.values()), f"in-core ir launched {n}")


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


def uv_match(td, ref) -> tuple:
    """(max |dE| in eV, max |df|) of a TDDFT result against cctpu's; f
    summed over each set of states degenerate within 1e-6 Ha (their
    amplitudes are not unique)."""
    e, f = np.asarray(td.e), td.oscillator_strength()
    de = float(np.abs(e - ref["e"]).max()) * HARTREE2EV
    cuts = np.flatnonzero(np.diff(ref["e"]) > 1e-6) + 1
    df = max(abs(f[i].sum() - np.asarray(ref["f"])[i].sum())
             for i in np.split(np.arange(len(e)), cuts))
    return de, float(df)


def td_seconds(td) -> dict:
    """The TDDFT's seconds by part (its PhaseTimer) and its matvecs."""
    sec = td.timer.phases
    return {"tddft_s": td.wall_s, "matvecs": td.n_matvec,
            "J_s": sec.get("J", 0.0),
            "K_s": sec.get("K", 0.0) + sec.get("K_lr", 0.0),
            "fxc_s": sec.get("fxc", 0.0),
            "matvec_other_s": sec.get("matvec", 0.0) - sum(
                sec.get(k, 0.0) for k in ("J", "K", "K_lr", "fxc")),
            "host_s": td.wall_s - sec.get("matvec", 0.0)}


def run_uv(argv):
    """The ``uv`` CLI through its main on the card, the launch counts reset
    just before and read just after; (td, wall s, report, launches, peak
    device GB)."""
    import torch
    from cctpu_torch.workflows import calculate_uv_spectrum
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        td = calculate_uv_spectrum.main([*argv, "--output-dir", tmp])
        wall = time.time() - t0
        text = _short_report(tmp)
    return (td, wall, text, counts(),
            torch.cuda.max_memory_allocated() / 1e9)


def phase_uv_acrolein_phenol():
    """11a. ``uv --smiles C=CC=O`` at its defaults (B3LYP/6-31G*, grid
    level 3, full TDDFT by the paired Davidson: 735 single excitations, 6
    states; in core, no J/K kernel) and with ``--density-fit`` (``df_j``
    and ``df_k_dm`` in every matvec) against cctpu's CLI at the same
    coordinates: excitation energies <= 1e-6 eV, f <= 1e-4. Acrolein, not
    phenol: cctpu's CPU run of phenol's ``uv`` did not finish within an
    hour. Then ``uv --smiles Oc1ccccc1 --density-fit`` (nao 110, 2,125
    single excitations; no oracle): its seconds, states and launches.
    Returns phenol's TDDFT and the launches."""
    n_all = {}
    for key, smiles, extra in (
            ("uv_acrolein", "C=CC=O", []),
            ("uv_acrolein_df", "C=CC=O", ["--density-fit"]),
            ("uv_phenol_df", "Oc1ccccc1", ["--density-fit"])):
        td, wall, text, n, peak = run_uv(["--smiles", smiles, *extra])
        n_all = {k: n_all.get(k, 0) + v for k, v in n.items()}
        ref = UV_ORACLES.get(key)
        cmp = {}
        if ref is not None:
            de, df = uv_match(td, ref)
            cmp = {"max_abs_dE_eV_vs_cctpu": de, "max_abs_df_vs_cctpu": df,
                   "abs_dEscf_vs_cctpu": abs(td.mf.e_tot - ref["e_scf"])}
        emit({"phase": f"cli_{key}", "wall_s": wall, **td_seconds(td),
              "nao": td.mf.mol.nao, "nov": len(td.ediff),
              "e_eV": (np.asarray(td.e) * HARTREE2EV).tolist(),
              "f": td.oscillator_strength().tolist(), **cmp,
              "launches": n, "peak_mem_GB": peak})
        check(td.converged and "strongest absorption" in text,
              f"{key}: not converged")
        if ref is not None:
            check(cmp["max_abs_dE_eV_vs_cctpu"] <= 1e-6
                  and cmp["max_abs_df_vs_cctpu"] <= 1e-4,
                  f"{key}: {cmp} from cctpu's")
        if extra:
            check(n["df_k_dm"] > 0 and n["df_j"] > 0,
                  f"{key} never reached df_k_dm/df_j: {n}")
        else:
            check(not any(n.values()), f"in-core {key} launched {n}")
    return td, n_all


def phase_uv_api(dev):
    """11b. NH2 DF-UB3LYP TDDFT (``df_k_dm`` on the spin pairs) and water
    DF-CAM-B3LYP TDDFT (``df_k_dm`` on B and B_lr), 6 states each (dense
    Casida), through the Python API, SCFs at conv_tol 1e-12 and an orbital
    gradient <= 1e-9 (6-31G*, grid level 2); then the ``uv`` CLI's TDA
    (the Hermitian Davidson) on water, ``--method cam-b3lyp --tda
    --density-fit``; all against cctpu's (<= 1e-6 eV, f <= 1e-4). Not
    NH2's TDA: with a GGA the TDA operator of cctpu's formulation is not
    symmetric, and NH2's Davidson moves by 1e-4 eV with the SCF's last
    digits (``scripts/tda_asymmetry.py``; ROADMAP.md queue 3); water's
    converges to the same states from any of them."""
    from cctpu_torch.dft.rks import RKS, UKS
    from cctpu_torch.response.tddft import TDDFT
    from cctpu_torch.utils.profiling import PhaseTimer
    n_all = {}
    for key, cls, atoms, spin, xc in (
            ("nh2_ub3lyp_df", UKS, NH2, 1, "b3lyp"),
            ("water_camb3lyp_df", RKS, WATER, 0, "cam-b3lyp")):
        mf, e, info = run_scf(cls, atoms, dev, spin=spin, xc=xc,
                              conv_tol=1e-12, conv_tol_grad=1e-9,
                              max_cycle=100)
        reset_counts()
        td = TDDFT(mf, nstates=6, timer=PhaseTimer(dev))
        td.kernel()
        n = counts()
        n_all = {k: n_all.get(k, 0) + v for k, v in n.items()}
        ref = UV_ORACLES[key]
        de, df = uv_match(td, ref)
        emit({"phase": key, **td_seconds(td), "nov": len(td.ediff),
              "e_eV": (np.asarray(td.e) * HARTREE2EV).tolist(),
              "max_abs_dE_eV_vs_cctpu": de, "max_abs_df_vs_cctpu": df,
              "abs_dEscf_vs_cctpu": abs(e - ref["e_scf"]),
              "launches_tddft": n, "scf": info})
        check(mf.converged and td.converged and de <= 1e-6 and df <= 1e-4,
              f"{key}: {de:.2e} eV, f {df:.2e} from cctpu's")
        check(n["df_k_dm"] > 0, f"{key} never reached df_k_dm: {n}")
        del mf, td
    key = "uv_water_camb3lyp_tda_df"
    td, wall, text, n, peak = run_uv(["--smiles", "O", "--method",
                                      "cam-b3lyp", "--tda", "--density-fit"])
    n_all = {k: n_all[k] + v for k, v in n.items()}
    ref = UV_ORACLES[key]
    de, df = uv_match(td, ref)
    emit({"phase": f"cli_{key}", "wall_s": wall, **td_seconds(td),
          "nov": len(td.ediff),
          "e_eV": (np.asarray(td.e) * HARTREE2EV).tolist(),
          "max_abs_dE_eV_vs_cctpu": de, "max_abs_df_vs_cctpu": df,
          "abs_dEscf_vs_cctpu": abs(td.mf.e_tot - ref["e_scf"]),
          "launches": n, "peak_mem_GB": peak})
    check(td.tda and td.converged and "strongest absorption" in text
          and de <= 1e-6 and df <= 1e-4,
          f"{key}: converged {td.converged}, {de:.2e} eV, f {df:.2e} from "
          "cctpu's")
    check(n["df_k_dm"] > 0 and n["df_j"] > 0,
          f"{key} never reached df_k_dm/df_j: {n}")
    return n_all


def phase_uv_aspirin():
    """11c. ``uv --smiles CC(=O)Oc1ccccc1C(=O)O`` at its defaults (B3LYP/
    6-31G*, grid level 3, nao 198: DF by size, full TDDFT, 6 states; no
    oracle, cctpu's CPU cost is out of reach): wall time, matvecs, the
    TDDFT's seconds split into J, K, fxc and host, the launches, peak
    device memory; six converged, finite, ascending states with f >= 0.
    Returns the TDDFT and the launches."""
    td, wall, text, n, peak = run_uv(["--smiles", ASPIRIN])
    e, f = np.asarray(td.e), td.oscillator_strength()
    emit({"phase": "cli_uv_aspirin", "wall_s": wall, **td_seconds(td),
          "nao": td.mf.mol.nao, "naux": int(td.mf._jk.B.shape[0]),
          "nov": len(td.ediff), "scf_cycles": td.mf.n_cycles,
          "e_eV": (e * HARTREE2EV).tolist(), "f": f.tolist(),
          "launches": n, "peak_mem_GB": peak})
    check(td.converged and len(e) == 6 and np.all(np.isfinite(e))
          and np.all(np.diff(e) >= 0) and e[0] > 0 and np.all(f >= 0)
          and td.mf.density_fit is True, "aspirin uv: states not right")
    check(n["df_k_dm"] > 0 and n["df_j"] > 0,
          f"aspirin uv never reached df_k_dm/df_j: {n}")
    return td, n


def phase_k_dm(factors, batch=12):
    """11. ``df_k_dm`` against its plain twin (the einsum, which is also
    its library call) at the given factors B, with ``batch`` random
    non-symmetric densities and with one, through
    ``ops/bench_k_dm.measure``: f64 <= 1e-12 relative, repeats bitwise
    equal, a density alone and the batch split in two calls bitwise equal
    to the whole batch's; kernel / plain / bound times, the plan, its
    padded share, the achieved TFLOP/s and the share of the bound.
    Returns the numbers by factor and batch."""
    import torch
    from cctpu_torch.ops.bench_k_dm import measure
    out = {}
    for name, B in factors.items():
        naux, nao = int(B.shape[0]), int(B.shape[1])
        g = torch.Generator(device=B.device)
        g.manual_seed(nao)
        D = torch.randn((batch, nao, nao), generator=g, dtype=B.dtype,
                        device=B.device)
        for nset in (1, batch):
            row = measure(B, D[:nset])
            out[f"{name}_nset{nset}"] = row
            emit({"phase": "df_k_dm", "factor": name, "shape": [naux, nao],
                  "nset": nset, **row})
            check(row["rel_err"] <= TOL["float64"] and row["bitwise_repeat"]
                  and row["batch_invariant"],
                  f"df_k_dm at {name} nset {nset}: {row}")
            torch.cuda.empty_cache()
    return out


HESSIAN_SCF = dict(xc="b3lyp", density_fit=True, grid_level=2,
                   conv_tol=1e-12, conv_tol_grad=1e-8, max_cycle=100)
# phase 12's bounds against central differences of the port's gradients
# (h = 1e-3 bohr): their truncation and SCF noise, ~1e-6 measured
FD_HESSIAN_TOL = 1e-4
# the FD step (bohr) of 13a and 13e: the PCM cavity is stiff (exposed
# points of two spheres 0.079 bohr apart at phase 6's water, 0.072 at 8's
# optimized one), so FD Hessians converge to the analytic one as C h^2
# with a large C: water DF-B3LYP/6-31G* with PCM on the CPU, phase 6's
# geometry, h = 1e-3 4.7e-4 Ha/bohr^2 and 5.7 cm^-1 off, h = 1e-4 7.3e-6
# and 0.049 cm^-1; 8's geometry, h = 1e-4 2.07e-3 (the card's the same),
# h = 3e-5 1.84e-4 (SCFs to an orbital gradient <= 1e-10)
PCM_FD_STEP = 1e-4


def hessian_run(mf, dev):
    """One ``analytic_hessian`` call with dipoles, the kernels' launch
    counts reset just before and read just after: (H, dmu, record of the
    wall time, its split, CG iterations, launches, peak memory)."""
    import torch
    from cctpu_torch.hessian.cphf import analytic_hessian
    from cctpu_torch.utils.profiling import PhaseTimer
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    timer, stats = PhaseTimer(dev), {}
    reset_counts()
    t0 = time.time()
    H, dmu = analytic_hessian(mf, with_dipole=True, timer=timer,
                              stats=stats)
    torch.cuda.synchronize(dev)
    ph = timer.phases
    return H, dmu, {
        "wall_s": time.time() - t0,
        "L_RR_L_kR_s": sum(ph.get(k, 0.0) for k in ("transport", "1e", "2e",
                                                     "xc", "pcm", "nuc")),
        "cg_s": ph.get("cg", 0.0), "dipole_s": ph.get("dipole", 0.0),
        "phases_s": ph, **stats, "launches": counts(),
        "peak_mem_GB": torch.cuda.max_memory_allocated(dev) / 1e9}


def fd_hessian_columns(mf, comps, opts, h=1e-3, factory=None):
    """Rows 3 atom + axis of the Hessian by central differences of the
    port's gradients: SCFs of ``mf``'s kind with ``opts`` (or
    ``factory(mol)``) at +-h bohr along each of ``comps`` [(atom, axis)],
    warm started from ``mf.dm``."""
    from cctpu_torch.grad.scf_grad import gradient
    make = factory or (lambda m: type(mf)(m, device=mf.device, **opts))
    out = {}
    for ia, ax in comps:
        g = []
        for sgn in (1.0, -1.0):
            c = mf.mol.coords.copy()
            c[ia, ax] += sgn * h
            m2 = make(mf.mol.with_coords(c))
            m2.kernel(dm0=mf.dm)
            check(m2.converged, f"FD SCF at {ia},{ax} did not converge")
            g.append(gradient(m2).cpu().numpy().ravel())
        out[3 * ia + ax] = (g[0] - g[1]) / (2 * h)
    return out


def phase_hessian_phenol(dev, mol):
    """12a. The analytic Hessian of phenol DF-B3LYP/6-31G* (grid level 2,
    conv_tol 1e-12) at phase 8c's optimized geometry, twice: bitwise
    equal, |H - H^T| before the symmetrization, the wall time split into
    L_RR/L_kR, CG and dipole, the CG iterations, the launches of each
    kernel, the peak memory; one column against central differences of
    the port's gradients (<= ``FD_HESSIAN_TOL``); no imaginary mode."""
    from cctpu_torch.dft.rks import RKS
    from cctpu_torch.hessian.frequencies import harmonic_analysis
    mf = RKS(mol, device=dev, **HESSIAN_SCF)
    t0 = time.time()
    mf.kernel()
    scf_s = time.time() - t0
    check(mf.converged, "phenol SCF at the optimized geometry")
    runs = [hessian_run(mf, dev) for _ in range(2)]
    (H, dmu, rec), (H2, dmu2, rec2) = runs
    bitwise = bool(np.array_equal(H, H2) and np.array_equal(dmu, dmu2))
    # O y (one of phase 3e's components, for the script's time limit)
    t0 = time.time()
    cols = fd_hessian_columns(mf, [(6, 1)], HESSIAN_SCF)
    dcol = max(float(np.abs(H[k] - c).max()) for k, c in cols.items())
    ha = harmonic_analysis(mol, H, dmu)
    from cctpu_torch.hessian import cphf
    dx = cphf.df_dx_bytes(mf)
    emit({"phase": "hessian_phenol_b3lyp", "card": card_line(),
          "natm": mol.natm, "scf_s": scf_s, "scf_cycles": mf.n_cycles,
          "df_dx_GB": dx / 1e9,
          "runs": [rec, rec2], "bitwise_repeat": bitwise,
          "max_abs_dH_vs_port_fd_columns": dcol,
          "fd_columns_s": time.time() - t0,
          "freq_cm": ha.freq_wavenumber.tolist(),
          "n_imaginary": ha.n_imaginary})
    check(bitwise, "phenol analytic Hessian: two calls differ")
    check(dx <= cphf.DF_DX_BYTES_MAX,
          f"phenol's dX/dR {dx / 1e9:.1f} GB: hessian_auto would take FD")
    check(dcol <= FD_HESSIAN_TOL,
          f"phenol Hessian columns {dcol:.2e} off the port's FD")
    check(ha.n_imaginary == 0, "phenol at 8c's geometry: imaginary mode")
    check(rec["max_abs_asymmetry"] <= 1e-5,
          f"phenol |H - H^T| {rec['max_abs_asymmetry']:.2e}")
    n = rec["launches"]
    check(n["df_j"] > 0 and n["df_k_dm"] > 0,
          f"phenol analytic Hessian launches {n}")
    return ({k: rec["launches"][k] + rec2["launches"][k] for k in n},
            [rec["cg_s"], rec2["cg_s"]])


def phase_hessian_small(dev):
    """12b-c. NH2 DF-UB3LYP/6-31G* at 8b's optimized geometry (the whole
    unrestricted analytic Hessian with dipoles) against four of the port's
    FD columns, N y and z, H y and z (8 of the whole FD Hessian's 18 SCFs,
    for the script's time limit); water DF-CAM-B3LYP/6-31G* at 8's
    optimized geometry (K_lr's response and the long-range terms) against
    one of the port's FD columns: <= ``FD_HESSIAN_TOL``."""
    from cctpu_torch.core.molecule import Molecule
    from cctpu_torch.dft.rks import RKS, UKS
    from cctpu_torch.hessian.frequencies import harmonic_analysis
    n_all = {}
    mol = Molecule.from_atoms(NH2_START, spin=1, basis="6-31g*").with_coords(
        np.asarray(OPT_ORACLES["nh2_ub3lyp"]["coords"]))
    mf = UKS(mol, device=dev, **HESSIAN_SCF)
    mf.kernel()
    check(mf.converged, "NH2 SCF at the optimized geometry")
    H, dmu, rec = hessian_run(mf, dev)
    n_all = dict(rec["launches"])
    t0 = time.time()
    # the molecule lies in x = 0
    cols = fd_hessian_columns(mf, [(0, 1), (0, 2), (1, 1), (1, 2)],
                              HESSIAN_SCF)
    ha = harmonic_analysis(mol, H, dmu)
    res = {"max_abs_dH_vs_port_fd_columns": max(
        float(np.abs(H[k] - c).max()) for k, c in cols.items())}
    emit({"phase": "hessian_nh2_ub3lyp", **rec, "fd_s": time.time() - t0,
          "freq_cm": ha.freq_wavenumber.tolist(),
          "n_imaginary": ha.n_imaginary, **res})
    check(res["max_abs_dH_vs_port_fd_columns"] <= FD_HESSIAN_TOL,
          f"NH2 analytic Hessian off the port's FD columns: {res}")
    # water CAM-B3LYP: FD columns
    mol = Molecule.from_atoms(WATER_START, basis="6-31g*").with_coords(
        np.asarray(OPT_ORACLES["water_b3lyp"]["coords"]))
    opts = {**HESSIAN_SCF, "xc": "cam-b3lyp"}
    mf = RKS(mol, device=dev, **opts)
    mf.kernel()
    check(mf.converged, "water CAM-B3LYP SCF")
    H, dmu, rec = hessian_run(mf, dev)
    n_all = {k: n_all[k] + rec["launches"][k] for k in n_all}
    t0 = time.time()
    # O z (the molecule lies in x = 0; one column, for the script's time
    # limit)
    cols = fd_hessian_columns(mf, [(0, 2)], opts)
    dcol = max(float(np.abs(H[k] - c).max()) for k, c in cols.items())
    emit({"phase": "hessian_water_camb3lyp", **rec,
          "fd_s": time.time() - t0, "max_abs_dH_vs_port_fd_columns": dcol,
          "freq_cm": harmonic_analysis(mol, H, dmu).freq_wavenumber
          .tolist()})
    check(dcol <= FD_HESSIAN_TOL,
          f"water CAM-B3LYP Hessian columns {dcol:.2e} off the port's FD")
    check(rec["launches"]["df_k_dm"] > 0, "water CAM-B3LYP: no df_k_dm")
    return n_all


# ---------------------------------------------------------------------------
# 13: PCM solvation
# ---------------------------------------------------------------------------

def pcm_wrap(timer=None):
    """The SCF wrapped by an IEF-PCM water model."""
    from cctpu_torch.solvent.pcm import PCM
    return lambda mf: PCM(mf, solvent="water", timer=timer)


def phase_solvent_phenol(dev):
    """13a. Phenol DF-B3LYP/6-31G* with IEF-PCM water (grid level 2,
    conv_tol 1e-10) through the Python API against cctpu's CPU-f64 energy
    (<= 1e-8 Ha): the fused kernel every cycle, the PCM set-up's seconds
    (points, K, R and Q; the potential integrals) and bytes, s/cycle and
    peak memory; then its gradient as 3e (two calls bitwise equal, the
    ``pcm`` phase's seconds, invariance, two central differences of the
    port's own energy <= 1e-6 at ``PCM_FD_STEP``, cctpu's gradient <=
    1e-7)."""
    from cctpu_torch.dft.rks import RKS
    from cctpu_torch.utils.profiling import PhaseTimer
    timer = PhaseTimer(dev)
    mf, e, info = run_scf(RKS, PHENOL, dev, xc="b3lyp",
                          wrap=pcm_wrap(timer=timer))
    m = mf._pcm
    de = abs(e - PCM_ORACLES["phenol_df_b3lyp"]["E"])
    n = info["launches"]
    emit({"phase": "solvent_phenol_b3lyp_631gs", "abs_dE_vs_cctpu": de,
          "npts": int(m.pts.shape[0]), "pcm_setup_s": timer.phases,
          "v_ints_GB": m.v_ints.numel() * 8 / 1e9,
          "Q_GB": m.Q.numel() * 8 / 1e9, **info})
    check(mf.converged, "phenol PCM SCF did not converge")
    check(de <= 1e-8, f"phenol PCM |dE| {de:.3e} > 1e-8 Ha")
    check(n["df_jk_fused"] >= mf.n_cycles,
          f"phenol PCM launches {n} in {mf.n_cycles} cycles")
    res = phase_gradient("gradient_solvent_phenol_b3lyp", mf, info,
                         [(6, 1), (7, 0)],
                         PCM_ORACLES["phenol_df_b3lyp_grad"]["gradient"],
                         wrap=pcm_wrap(), h=PCM_FD_STEP)
    check("pcm" in res["terms_s"], "phenol PCM gradient: no pcm phase")
    return n


def _solvent_cli(argv, key):
    """The ``solvent`` CLI through cli.main against cctpu's CLI
    (``PCM_ORACLES[key]``, the same coordinates): E_gas and E_sol <= 1e-8
    Ha, dG_solv <= 1e-5 kcal/mol, both dipoles <= 1e-4 D and both gaps <=
    1e-5 Ha (the CLI's conv_tol 1e-10); the in-solvent optimization's
    energies step by step and the solvent table's energies <= 1e-8 Ha."""
    from cctpu_torch.workflows import calculate_solvent_effect as cs
    from cctpu_torch.workflows import cli
    reset_counts()
    rec, restore = _recording(cs, "main")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            rc = cli.main(["solvent", *argv, "--output-dir", tmp])
            wall = time.time() - t0
            report = _short_report(tmp)
    finally:
        restore()
    (_, _, out, _), = rec
    orc = PCM_ORACLES[key]
    dev = {k: abs(out[k] - orc[k]) for k in ("e_gas", "e_sol", "mu_gas",
                                             "mu_sol", "gap_gas", "gap_sol")}
    dev["dg_kcal"] = abs(out["dg"] - (orc["e_sol"] - orc["e_gas"])
                         * HARTREE2KCAL)
    tol = {"e_gas": 1e-8, "e_sol": 1e-8, "mu_gas": 1e-4, "mu_sol": 1e-4,
           "gap_gas": 1e-5, "gap_sol": 1e-5, "dg_kcal": 1e-5}
    res = {"phase": key, "rc": rc, "wall_s": wall,
           **{k: out[k] for k in ("e_gas", "e_sol", "dg", "mu_gas",
                                  "mu_sol", "gap_gas", "gap_sol")},
           "abs_vs_cctpu": dev, "launches": counts()}
    if "opt_energies" in orc:
        opt = out["opt"]
        res["opt_steps"] = len(opt.energies)
        res["opt_converged"] = opt.converged
        same = len(opt.energies) == len(orc["opt_energies"])
        dev["opt_energies"] = float(np.abs(
            np.asarray(opt.energies) - orc["opt_energies"]).max()) \
            if same else float("inf")
        dev["opt_coords_bohr"] = float(np.abs(
            opt.mol.coords - np.asarray(orc["opt_coords"])).max())
        tol.update(opt_energies=1e-8, opt_coords_bohr=1e-5)
    if "table" in orc:
        res["table"] = out["table"]
        dev["table"] = float(np.abs(np.asarray(list(out["table"].values()))
                                    - orc["table"]).max())
        tol["table"] = 1e-8
    emit(res)
    check(rc == 0 and "dG_solv" in report,
          f"{key}: rc {rc}, no dG_solv in the report")
    check(all(dev[k] <= tol[k] for k in tol),
          f"{key}: deviations from cctpu {dev}, tolerances {tol}")
    return res["launches"]


def phase_solvent_cli():
    """13b-c. ``solvent --smiles Oc1ccccc1`` at its defaults (B3LYP/6-31G*,
    grid level 3, in core at nao 110: no J/K kernel, water, IEF-PCM) and
    ``solvent --smiles O --pcm-method c-pcm --compare-solvents --opt`` (the
    in-solvent optimization, PCM gradients every step, and the 7-solvent
    table) against cctpu's CLI on the same coordinates."""
    n = _solvent_cli(["--smiles", "Oc1ccccc1"], "cli_phenol")
    n2 = _solvent_cli(["--smiles", "O", "--pcm-method", "c-pcm",
                       "--compare-solvents", "--opt"], "cli_water_cpcm_opt")
    n = {k: n[k] + n2[k] for k in n}
    check(not any(n.values()), f"the in-core solvent CLIs launched {n}")
    return n


def phase_solvent_nh2(dev):
    """13d. NH2 DF-UB3LYP/6-31G* with IEF-PCM water (conv_tol 1e-12,
    orbital gradient <= 1e-9): energy (<= 1e-8 Ha) and gradient (<= 1e-7
    Ha/bohr) against cctpu's; ``df_j`` every cycle, ``df_k`` twice."""
    from cctpu_torch.dft.rks import UKS
    mf, e, info = run_scf(UKS, NH2, dev, spin=1, xc="b3lyp",
                          conv_tol=1e-12, conv_tol_grad=1e-9, max_cycle=100,
                          wrap=pcm_wrap())
    orc = PCM_ORACLES["nh2_df_ub3lyp"]
    de = abs(e - orc["E"])
    n = info["launches"]
    emit({"phase": "solvent_nh2_ub3lyp_631gs", "abs_dE_vs_cctpu": de,
          **info})
    check(mf.converged and de <= 1e-8, f"NH2 PCM |dE| {de:.3e} > 1e-8 Ha")
    check(n["df_j"] >= mf.n_cycles and n["df_k"] >= 2 * mf.n_cycles,
          f"NH2 PCM launches {n} in {mf.n_cycles} cycles")
    phase_gradient("gradient_solvent_nh2_ub3lyp", mf, None, [],
                   orc["gradient"])
    return n


def phase_solvent_hessian(dev):
    """13e. ``hessian_auto`` on water DF-B3LYP/6-31G* with IEF-PCM water
    at phase 6's geometry takes the analytic route (its log line);
    against two columns of the port's FD Hessian of PCM gradients, O z and
    H y (``PCM_FD_STEP``, SCFs to an orbital gradient <= 1e-10; 4 of the
    whole FD Hessian's 18 SCFs, for the script's time limit): <=
    ``FD_HESSIAN_TOL``; ``df_j`` and ``df_k_dm`` in its CG. (At 8's optimized geometry the FD Hessian
    converges to the analytic one as C h^2 with C = 2.1e5 Ha/bohr^4: two
    exposed points of the O and H spheres lie 0.072 bohr apart there; see
    ``PCM_FD_STEP``.)"""
    from cctpu_torch.core.molecule import Molecule
    from cctpu_torch.dft.rks import RKS
    from cctpu_torch.hessian.frequencies import harmonic_analysis, \
        hessian_auto
    mol = Molecule.from_atoms(WATER, basis="6-31g*")
    opts = {**HESSIAN_SCF, "conv_tol_grad": 1e-10}

    def factory(m):
        return pcm_wrap()(RKS(m, device=dev, **opts))
    mf = factory(mol)
    mf.kernel()
    check(mf.converged, "water PCM SCF")
    reset_counts()
    log = []
    t0 = time.time()
    H, dmu = hessian_auto(mf, factory, mol, dm0=mf.dm, log=log.append)
    wall = time.time() - t0
    n = counts()
    t0 = time.time()
    # O z and H y (the molecule lies in x = 0; two columns of the whole FD
    # Hessian, for the script's time limit)
    cols = fd_hessian_columns(mf, [(0, 2), (1, 1)], None, h=PCM_FD_STEP,
                              factory=factory)
    ha = harmonic_analysis(mol, H, dmu)
    res = {"max_abs_dH_vs_port_fd_columns": max(
        float(np.abs(H[k] - c).max()) for k, c in cols.items())}
    emit({"phase": "solvent_hessian_water_b3lyp", "log": log,
          "analytic_s": wall, "fd_s": time.time() - t0, "launches": n,
          "freq_cm": ha.freq_wavenumber.tolist(),
          "n_imaginary": ha.n_imaginary, **res})
    check(log == ["  Hessian: analytic (AD-native CPHF)"],
          f"hessian_auto did not take the analytic route: {log}")
    check(res["max_abs_dH_vs_port_fd_columns"] <= FD_HESSIAN_TOL,
          f"water PCM analytic Hessian off the port's FD columns: {res}")
    check(n["df_j"] > 0 and n["df_k_dm"] > 0,
          f"water PCM analytic Hessian launches {n}")
    return n


# ---------------------------------------------------------------------------
# 14: NMR shieldings (GIAO) and the nmr CLI
# ---------------------------------------------------------------------------

NMR_SCF = dict(xc="b3lyp", conv_tol=1e-12, conv_tol_grad=1e-9,
               max_cycle=200)
# 14a-14b's bound on |sigma - sigma_cctpu| (ppm) and on the shift of the
# shieldings under a translation (cctpu's own gate)
NMR_TOL_PPM = 1e-4
NMR_SHIFT_BOHR = (0.8, 1.6, -1.1)


def shifted(atoms: str, by_bohr) -> str:
    """``atoms`` (Angstrom) moved by the vector ``by_bohr``."""
    from cctpu_torch.core.constants import BOHR
    out = []
    for item in atoms.split(";"):
        sym, *xyz = item.split()
        out.append(" ".join([sym] + [f"{float(x) + d * BOHR:.10f}"
                                     for x, d in zip(xyz, by_bohr)]))
    return "; ".join(out)


def giao_run(mf, dev):
    """One ``GIAONMR(mf).kernel()``, the kernels' launch counts reset just
    before and read just after: (shielding [natm, 3, 3] ppm, record of the
    wall time, its split into 1e, 2e skeleton, XC skeleton, CG and
    assembly, the CG's iterations per field direction, launches and peak
    memory)."""
    import torch
    from cctpu_torch.response.giao_nmr import GIAONMR
    from cctpu_torch.utils.profiling import PhaseTimer
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    timer = PhaseTimer(dev)
    nmr = GIAONMR(mf, timer=timer)
    reset_counts()
    t0 = time.time()
    sig = nmr.kernel()
    torch.cuda.synchronize(dev)
    return sig, {"giao_s": time.time() - t0, "phases_s": timer.phases,
                 "cg_iterations": nmr.stats["cg_iterations"],
                 "launches": counts(),
                 "peak_mem_GB": torch.cuda.max_memory_allocated(dev) / 1e9}


def nmr_case(tag, cls, atoms, dev, spin=0, xc="b3lyp", shift=None,
             **scf_kw):
    """14a-b. An SCF (6-31G*, DF, grid level 2) and its GIAO shieldings
    against ``NMR_ORACLES[tag]`` where it holds one (<= ``NMR_TOL_PPM``),
    and, with ``shift``, the same at the molecule moved by it (<=
    ``NMR_TOL_PPM``); the record's launch counts are the GIAO's."""
    opts = {**NMR_SCF, "xc": xc, **scf_kw}
    mf, e, info = run_scf(cls, atoms, dev, spin=spin, **opts)
    check(mf.converged, f"{tag}: the SCF did not converge")
    sig, rec = giao_run(mf, dev)
    iso = np.trace(sig, axis1=1, axis2=2) / 3
    res = {"phase": tag, "card": card_line(), "E": e,
           "scf_s": info["scf_s"], "scf_launches": info["launches"], **rec,
           "sigma_iso": iso.tolist()}
    orc = NMR_ORACLES.get(tag)
    if orc is None:
        res["vs_cctpu"] = ("no oracle: cctpu's CPU process died of XLA's "
                           "memory maps (scripts/make_nmr_oracles.py)")
    else:
        res["abs_dE_vs_cctpu"] = abs(e - orc["E"])
        res["max_abs_dsigma_vs_cctpu"] = float(np.abs(
            sig.reshape(-1, 9) - np.asarray(orc["giao"])).max())
    if shift is not None:
        mf2, _, _ = run_scf(cls, shifted(atoms, shift), dev, spin=spin,
                            dm0=mf.dm, **opts)
        sig2, rec2 = giao_run(mf2, dev)
        res["max_abs_dsigma_shifted"] = float(np.abs(sig2 - sig).max())
        res["giao_s_shifted"] = rec2["giao_s"]
        rec["launches"] = {k: rec["launches"][k] + rec2["launches"][k]
                           for k in rec["launches"]}
    emit(res)
    check(np.isfinite(sig).all() and sig.shape == (mf.mol.natm, 3, 3),
          f"{tag}: shielding not finite or of the wrong shape")
    for k in ("max_abs_dsigma_vs_cctpu", "max_abs_dsigma_shifted"):
        check(res.get(k, 0.0) <= NMR_TOL_PPM,
              f"{tag}: {k} {res.get(k, 0.0):.2e} > {NMR_TOL_PPM} ppm")
    check(rec["launches"]["df_k_dm"] > 0 or not mf.func.hyb,
          f"{tag}: the CPHF launched no df_k_dm {rec['launches']}")
    return {k: info["launches"][k] + rec["launches"][k]
            for k in rec["launches"]}


def phase_nmr_phenol(dev):
    """14a. Phenol DF-B3LYP/6-31G* (phase 3e's SCF: grid level 2,
    conv_tol 1e-12, orbital gradient <= 1e-8): GIAO shieldings with the
    wall time split into 1e integrals, 2e skeleton, XC skeleton, CG (its
    iterations per direction) and assembly, ``df_k_dm`` launches and peak
    memory; against cctpu's oracle where there is one, else by translation
    invariance (<= ``NMR_TOL_PPM``)."""
    from cctpu_torch.dft.rks import RKS
    shift = None if "card_phenol_b3lyp" in NMR_ORACLES else NMR_SHIFT_BOHR
    n = nmr_case("card_phenol_b3lyp", RKS, PHENOL, dev, shift=shift,
                 conv_tol_grad=1e-8, max_cycle=100)
    check(n["df_jk_fused"] > 0, f"phenol NMR launches {n}")
    return n


def phase_nmr_small(dev):
    """14b. Water DF-B3LYP, DF-CAM-B3LYP (``df_k_dm`` on B_lr too; and
    its translation invariance), DF-M06-2X and NH2 DF-UB3LYP (the spin
    path; ``df_j``/``df_k`` in its SCF), 6-31G*, against cctpu's oracles
    (<= ``NMR_TOL_PPM``)."""
    from cctpu_torch.dft.rks import RKS, UKS
    n_all = None
    for tag, cls, atoms, spin, xc, shift in (
            ("card_water_b3lyp", RKS, WATER, 0, "b3lyp", None),
            ("card_water_camb3lyp", RKS, WATER, 0, "cam-b3lyp",
             NMR_SHIFT_BOHR),
            ("card_water_m062x", RKS, WATER, 0, "m06-2x", None),
            ("card_nh2_ub3lyp", UKS, NH2, 1, "b3lyp", None)):
        n = nmr_case(tag, cls, atoms, dev, spin=spin, xc=xc, shift=shift)
        n_all = n if n_all is None else {k: n_all[k] + n[k] for k in n}
    check(n_all["df_j"] > 0 and n_all["df_k"] > 0,
          f"water/NH2 NMR launches {n_all}")
    return n_all


def run_nmr_cli(argv, tag, memo):
    """The ``nmr`` CLI through cli.main with the TMS memo ``memo``: (rc,
    main's result, the phases' seconds, wall, launches, peak memory, the
    report)."""
    import torch
    from cctpu_torch.workflows import calculate_nmr as cn
    from cctpu_torch.workflows import cli, common
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec, restore = _recording(cn, "main")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            rc = cli.main(["nmr", *argv, "--tms-memo", memo,
                           "--output-dir", tmp])
            wall = time.time() - t0
            report = _short_report(tmp)
    finally:
        restore()
    (_, _, out, _), = rec
    return rc, out, dict(common.PHASES.phases), {
        "phase": tag, "rc": rc, "wall_s": wall, "launches": counts(),
        "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9}, report


def phase_nmr_cli():
    """14c-d. ``nmr --smiles Oc1ccccc1 --skip-opt`` at its defaults
    (B3LYP/6-311G**, DF by size: nao 162, and the TMS reference's 170),
    the TMS reference computed on the card into a fresh memo: rc 0, a sigma
    and a delta for every H and C, the memo written under the port's name,
    the wall time split into SCF, GIAO and TMS, launches, peak memory (no
    oracle: cctpu's CPU cost is out of reach). Then ``nmr --smiles C
    --method hf --basis sto-3g`` (in core: no J/K kernel) with its
    optimization and its computed TMS reference: sigma, sigma_ref and
    delta against cctpu's CLI on the same coordinates
    (<= ``NMR_TOL_PPM``)."""
    import json
    n_all = {}
    with tempfile.TemporaryDirectory() as tmp:
        memo = os.path.join(tmp, "cctpu_torch_tms_ref.json")
        rc, out, ph, res, report = run_nmr_cli(
            ["--smiles", "Oc1ccccc1", "--skip-opt"], "cli_nmr_phenol", memo)
        with open(memo) as f:
            disk = json.load(f)
        syms = out["symbols"]
        hc = [i for i, s in enumerate(syms) if s in ("H", "C")]
        res.update(scf_s=ph.get("scf", 0.0), giao_s=ph.get("giao", 0.0),
                   tms_s=ph.get("tms", 0.0), memo=disk,
                   giao_phases_s=out["nmr"].timer.phases,
                   cg_iterations=out["nmr"].stats["cg_iterations"],
                   nao=out["mol"].nao, symbols=syms,
                   sigma_iso=out["sigma"].tolist(),
                   delta=out["delta"].tolist())
        emit(res)
        n_all = dict(res["launches"])
        check(rc == 0 and "TMS reference computed" in report,
              f"nmr phenol CLI: rc {rc}")
        check(list(disk) == ["b3lyp/6-311g**"]
              and out["ref"] == disk["b3lyp/6-311g**"],
              f"nmr phenol CLI: the TMS memo holds {disk}")
        check(all(np.isfinite(out["sigma"][i]) and np.isfinite(
            out["delta"][i]) for i in hc) and len(hc) == 12,
              "nmr phenol CLI: a sigma or delta of H/C is missing")
        check(res["launches"]["df_jk_fused"] > 0
              and res["launches"]["df_k_dm"] > 0,
              f"nmr phenol CLI launches {res['launches']}")

        memo = os.path.join(tmp, "cctpu_torch_tms_ref_hf.json")
        rc, out, ph, res, report = run_nmr_cli(
            ["--smiles", "C", "--method", "hf", "--basis", "sto-3g"],
            "cli_nmr_methane_hf", memo)
    orc = NMR_ORACLES["cli_methane"]
    ref = out["ref"]
    dev = {"sigma": float(np.abs(out["sigma"] - orc["sigma"]).max()),
           "delta": float(np.abs(out["delta"] - orc["delta"]).max()),
           "ref": max(abs(ref["H"] - orc["ref_H"]),
                      abs(ref["C"] - orc["ref_C"])),
           "opt_coords_bohr": float(np.abs(
               out["mol"].coords - np.asarray(orc["opt_coords"])).max())}
    res.update(sigma_iso=out["sigma"].tolist(), ref=ref,
               delta=out["delta"].tolist(), phases_s=ph,
               abs_vs_cctpu=dev)
    emit(res)
    n_all = {k: n_all[k] + res["launches"][k] for k in n_all}
    check(rc == 0, f"nmr methane CLI: rc {rc}")
    check(max(dev["sigma"], dev["delta"], dev["ref"]) <= NMR_TOL_PPM,
          f"nmr methane CLI off cctpu's: {dev}")
    return n_all


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
    # the W and K products of the f64 W/K kernels and of df_k_dm issue the
    # FP64 tensor-core instruction (DMMA in the SASS of the libraries)
    dmma = {name: build.sass_count(name, "DMMA")
            for name in ("df_jk_fused", "df_k", "df_k_dm")}
    emit({"phase": "build", "seconds": time.time() - t0, "ptxas": ptxas,
          "sass_dmma": dmma})
    check(min(dmma.values()) > 0, f"no DMMA in a library: {dmma}")

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
    # no central difference (each FD point rebuilds the in-core tensor;
    # the script's time limit): held against the Cholesky gradient and,
    # on water and NH2, against cctpu's (7e)
    res = phase_gradient("gradient_incore_phenol_b3lyp", mf_in, info_in,
                         [], None)
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
    n_phenol, phenol_opt = phase_opt_phenol(dev)
    n_opt = {k: n_opt[k] + n_phenol[k] for k in n_opt}
    torch.cuda.empty_cache()
    mark(t_start, "8c")
    n_hess = phase_hessian(dev)
    mark(t_start, "8d")
    phase_cli_opt()
    mark(t_start, "8e")
    check(scf_kernels_ran(n_opt), f"a kernel never ran in 8-8c: {n_opt}")

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
    check(scf_kernels_ran(n_rsh), f"a kernel never ran in 9-9e: {n_rsh}")

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
    check(scf_kernels_ran(n_wf), f"a kernel never ran in 10-10f: {n_wf}")

    td_df, n_uv = phase_uv_acrolein_phenol()
    mark(t_start, "11a")
    n = phase_uv_api(dev)
    n_uv = {k: n_uv[k] + n[k] for k in n_uv}
    mark(t_start, "11b")
    td_asp, n = phase_uv_aspirin()
    n_uv = {k: n_uv[k] + n[k] for k in n_uv}
    mark(t_start, "11c")
    check(all(n_uv[k] for k in ("df_jk_fused", "df_j", "df_k_dm")),
          f"a kernel of the uv path never ran in 11a-11c: {n_uv}")
    from cctpu_torch.dft.xc import get_functional
    omega = get_functional("wb97x-d").rsh[0]
    asp_k_s = td_seconds(td_asp)["K_s"]
    k_dm = phase_k_dm({"phenol": td_df.mf._jk.B,
                       "phenol_b_lr": td_df.mf._jk.prepare_lr(omega)[0],
                       "aspirin": td_asp.mf._jk.B})
    del td_df, td_asp
    torch.cuda.empty_cache()
    mark(t_start, "11")

    n_h12, cg_s = phase_hessian_phenol(dev, phenol_opt)
    torch.cuda.empty_cache()
    mark(t_start, "12a")
    n = phase_hessian_small(dev)
    n_h12 = {k: n_h12[k] + n[k] for k in n_h12}
    mark(t_start, "12c")

    n_sol = phase_solvent_phenol(dev)
    torch.cuda.empty_cache()
    mark(t_start, "13a")
    for phase, after in ((phase_solvent_cli, "13c"),
                         (lambda: phase_solvent_nh2(dev), "13d"),
                         (lambda: phase_solvent_hessian(dev), "13e")):
        n = phase()
        n_sol = {k: n_sol[k] + n[k] for k in n_sol}
        mark(t_start, after)
    check(all(n_sol.values()),
          f"a kernel of the solvent path never ran in 13a-13e: {n_sol}")

    n_nmr = phase_nmr_phenol(dev)
    torch.cuda.empty_cache()
    mark(t_start, "14a")
    for phase, after in ((lambda: phase_nmr_small(dev), "14b"),
                         (phase_nmr_cli, "14d")):
        n = phase()
        n_nmr = {k: n_nmr[k] + n[k] for k in n_nmr}
        torch.cuda.empty_cache()
        mark(t_start, after)
    check(all(n_nmr.values()),
          f"a kernel of the NMR path never ran in 14a-14d: {n_nmr}")

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
    main_k_dm = k_dm["phenol_nset12"]
    emit(card)
    emit({"kernels": [{"name": name, "route": "cuda", "source": src,
                       "replaces": rep, **{k: d[k] for k in keys},
                       "launches_cholesky": n_cd[name],
                       "launches_opt": n_opt[name],
                       "launches_hessian": n_hess[name],
                       "launches_rsh": n_rsh[name],
                       "launches_workflows": n_wf[name],
                       "launches_uv": n_uv[name],
                       "launches_hessian_analytic": n_h12[name],
                       "launches_solvent": n_sol[name],
                       "launches_nmr": n_nmr[name],
                       "cholesky_shape": {k: cd_kernels[name][k]
                                          for k in cd_keys},
                       "def2tzvp_shape": {k: tzvp[name][k]
                                          for k in cd_keys},
                       **({"b_lr_shape": {k: k_lr[k] for k in cd_keys}}
                          if name == "df_k" else {})}
                      for name, src, rep, d in rows]
             + [{"name": "df_k_dm", "route": "cuda",
                 "source": "cctpu_torch/ops/csrc/df_k_dm.cu",
                 "replaces": "cctpu/ints/df.py:1359-1360 (an XLA einsum: "
                             "no TPU kernel)",
                 "launches": n_uv["df_k_dm"],
                 "launches_hessian": n_hess["df_k_dm"],
                 "launches_hessian_analytic": n_h12["df_k_dm"],
                 "launches_solvent": n_sol["df_k_dm"],
                 "launches_nmr": n_nmr["df_k_dm"],
                 **{k: main_k_dm[k] for k in keys if k != "launches"},
                 **{k: main_k_dm[k] for k in ("plan", "padded_share",
                                              "tflops", "bound_share")},
                 "uv_aspirin_K_s": asp_k_s, "hessian_phenol_cg_s": cg_s,
                 "shapes": {name: {k: row[k] for k in (
                     *cd_keys, "tflops", "bound_share")}
                            for name, row in k_dm.items()}}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
