"""Geometry optimization in redundant internal coordinates.

Port of ``cctpu/geomopt/optimizer.py``: a host quasi-Newton loop (BFGS
update, RFO step, trust radius) in redundant internals, as cctpu and
geomeTRIC run it. At each step the SCF and its analytic gradient run on
the SCF's device (the card unless the factory asked for the CPU); the
gradient is moved to the host only for the quasi-Newton algebra. The
converged density of one step warm-starts the next (the reference's
``dm0`` idiom), staying a tensor on the SCF's device.

Convergence criteria follow geomeTRIC/Gaussian defaults:
  grad_max < 4.5e-4, grad_rms < 3e-4 and |dE| < 1e-6; a step converges
  only once dE exists (from the second step on). The first trust radius
  is 0.3; it grows by 1.2 (to 0.5 at most) after a downhill step and
  shrinks by 0.4 (to 0.02 at least) after an uphill one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from cctpu_torch.core.molecule import Molecule
from cctpu_torch.geomopt.internal import InternalCoords
from cctpu_torch.grad.scf_grad import gradient as scf_gradient
from cctpu_torch.utils.profiling import phase

CONV_E, CONV_GMAX, CONV_GRMS = 1e-6, 4.5e-4, 3e-4
TRUST0 = 0.3


@dataclasses.dataclass
class OptResult:
    mol: Molecule
    e_tot: float
    converged: bool
    nsteps: int
    trajectory: List[Molecule]
    energies: List[float]
    mf: object = None
    cycles: List[int] = dataclasses.field(default_factory=list)


def _rfo_step(H, g, trust):
    """Rational-function-optimization step, capped at trust radius."""
    n = len(g)
    aug = np.zeros((n + 1, n + 1))
    aug[:n, :n] = H
    aug[:n, n] = g
    aug[n, :n] = g
    w, V = np.linalg.eigh(aug)
    v = V[:, 0]
    if abs(v[n]) < 1e-12:
        step = -np.linalg.pinv(H) @ g
    else:
        step = v[:n] / v[n]
    norm = np.linalg.norm(step)
    if norm > trust:
        step = step * (trust / norm)
    return step


def _project_tr(gx: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Remove rigid-body translation/rotation components of a Cartesian
    gradient [3N]; convergence is judged on the projected gradient, as
    geomeTRIC does in its internal space."""
    natm = coords.shape[0]
    com = coords.mean(axis=0)
    basis = []
    for d in range(3):
        t = np.zeros((natm, 3))
        t[:, d] = 1.0
        basis.append(t.ravel())
    rel = coords - com
    for d in range(3):
        ax = np.zeros(3)
        ax[d] = 1.0
        basis.append(np.cross(rel, ax).ravel())
    A = np.stack(basis, axis=1)                      # [3N, 6]
    # SVD keeps only genuine rigid modes (linear molecules: 5, not 6)
    U, s, _ = np.linalg.svd(A, full_matrices=False)
    Q = U[:, s > 1e-8 * s.max()]
    return gx - Q @ (Q.T @ gx)


def optimize(mf_factory: Callable[[Molecule], object], mol: Molecule,
             maxsteps: int = 50, verbose: int = 0,
             callback: Optional[Callable] = None,
             timer=None) -> OptResult:
    """Minimize the SCF energy over geometry.

    mf_factory(mol) -> SCF object with .kernel(dm0=) and gradient support.
    ``timer``, a ``utils.profiling.PhaseTimer``, receives the seconds of
    each step's ``setup`` (the factory and the J/K builder), ``scf``,
    ``gradient`` (with the gradient's own terms) and ``step`` (the host
    algebra). ``callback(step, mol, e, g)`` runs after each gradient.
    """
    mol = mol.build() if mol._basis_set is None else mol
    coords = mol.coords.copy()
    ic = InternalCoords(mol.charges, coords)

    dm = None
    traj, energies, cycles = [], [], []
    e_last = None
    H = ic.guess_hessian()
    trust = TRUST0
    q_last = g_last = None
    converged = False
    mf = None

    for step_i in range(maxsteps):
        m = mol.with_coords(coords)
        with phase(timer, "setup"):
            mf = None                    # free the last step's SCF first
            mf = mf_factory(m)
            mf.get_jk_builder()
            if hasattr(mf, "_prepare_xc_f64"):           # RKS, UKS
                mf._prepare_xc_f64()
        with phase(timer, "scf"):
            e = mf.kernel(dm0=dm)
        dm = mf.make_rdm1()
        with phase(timer, "gradient"):
            gx = scf_gradient(mf, timer).cpu().numpy().ravel()
        traj.append(m)
        energies.append(float(e))
        cycles.append(mf.n_cycles)

        with phase(timer, "step"):
            B = ic.B(coords)                       # [nq, 3N]
            Binv = np.linalg.pinv(B, rcond=1e-8)   # [3N, nq]
            gq = Binv.T @ gx
            q_now = ic.q(coords)

            gp = _project_tr(gx, coords)
            gmax = np.abs(gp).max()
            grms = np.sqrt(np.mean(gp ** 2))
            de = None if e_last is None else e - e_last
        if verbose:
            print(f"opt step {step_i:3d}  E = {e:.10f}  "
                  f"dE = {0.0 if de is None else de: .3e}  "
                  f"gmax = {gmax:.2e}  grms = {grms:.2e}  trust={trust:.3f}")
        if callback:
            callback(step_i, m, float(e), gx.reshape(-1, 3))

        if (gmax < CONV_GMAX and grms < CONV_GRMS
                and de is not None and abs(de) < CONV_E):
            converged = True
            break

        with phase(timer, "step"):
            # BFGS update
            if q_last is not None:
                s = ic.diff(q_now, q_last)
                y = gq - g_last
                sy = s @ y
                if sy > 1e-10:
                    Hs = H @ s
                    H = (H + np.outer(y, y) / sy
                         - np.outer(Hs, Hs) / (s @ Hs))
            # trust-radius heuristic on energy change
            if de is not None:
                if de < 0:
                    trust = min(trust * 1.2, 0.5)
                else:
                    trust = max(trust * 0.4, 0.02)
            q_last, g_last, e_last = q_now, gq, e

            dq = _rfo_step(H, gq, trust)

            # iterative backtransform dq -> dx
            x = coords.ravel().copy()
            q_target = q_now + dq
            for _ in range(20):
                B = ic.B(x.reshape(-1, 3))
                Binv = np.linalg.pinv(B, rcond=1e-8)
                dq_res = ic.diff(q_target, ic.q(x.reshape(-1, 3)))
                dx = Binv @ dq_res
                x = x + dx
                if np.linalg.norm(dx) < 1e-10:
                    break
            step_x = x - coords.ravel()
            coords = (coords.ravel() + step_x).reshape(-1, 3)

    result_mol = mol.with_coords(coords if not converged else traj[-1].coords)
    return OptResult(mol=result_mol, e_tot=float(energies[-1]),
                     converged=converged, nsteps=step_i + 1,
                     trajectory=traj, energies=energies, mf=mf,
                     cycles=cycles)
