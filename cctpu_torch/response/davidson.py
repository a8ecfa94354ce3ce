"""Block Davidson eigensolvers for symmetric operators given as matvecs.

Port of ``cctpu/response/davidson.py`` (host numpy in both packages, the
same subspace management, defaults and convergence tests): the matvec,
an orbital-Hessian contraction, runs batched on the SCF's device; the
small subspace eigenproblem is solved on the host.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np


def rpa_davidson(apb_mv: Callable, amb_mv: Callable, diag: np.ndarray,
                 nroots: int, tol: float = 1e-6, max_cycle: int = 60,
                 max_space: Optional[int] = None, verbose: int = 0):
    """Paired Davidson for the RPA/Casida problem (A-B)(A+B)|X+Y> =
    w^2 |X+Y> with symmetric positive-definite (A+B), (A-B).

    Subspace V; W+ = (A+B)V, W- = (A-B)V; reduced Mp = V'W+, Mm = V'W-;
    small eigenproblem Mm Mp z = w^2 z. Returns (w [nroots],
    xpy [n, nroots], xmy [n, nroots], converged).
    """
    n = diag.shape[0]
    nroots = min(nroots, n)
    max_space = max_space or max(8 * nroots, 32)

    order = np.argsort(diag)
    V = np.zeros((n, nroots))
    for i in range(nroots):
        V[order[i], i] = 1.0
    V, _ = np.linalg.qr(V)
    Wp = np.asarray(apb_mv(V))
    Wm = np.asarray(amb_mv(V))

    conv = False
    for it in range(max_cycle):
        Mp = V.T @ Wp
        Mm = V.T @ Wm
        Mp = 0.5 * (Mp + Mp.T)
        Mm = 0.5 * (Mm + Mm.T)
        # Hermitian product form in the subspace: Mm^{1/2} Mp Mm^{1/2}
        wm, um = np.linalg.eigh(Mm)
        wm = np.maximum(wm, 1e-14)
        Sm = (um * np.sqrt(wm)) @ um.T
        Smi = (um / np.sqrt(wm)) @ um.T
        Mh = Sm @ Mp @ Sm
        w2, Z = np.linalg.eigh(0.5 * (Mh + Mh.T))
        idx = np.argsort(w2)[:nroots]
        omegas = np.sqrt(np.maximum(w2[idx], 1e-14))
        # |X+Y> (subspace) = Sm z / sqrt(w); |X-Y> = Smi z sqrt(w)
        news = []
        xpy_list, xmy_list = [], []
        rnorms = []
        for k, i in enumerate(idx):
            wv = omegas[k]
            zp = Sm @ Z[:, i] / np.sqrt(wv)
            zm = Smi @ Z[:, i] * np.sqrt(wv)
            xpy = V @ zp
            xmy = V @ zm
            # residuals of the paired equations:
            #   (A+B)(X+Y) - w (X-Y) = 0 ; (A-B)(X-Y) - w (X+Y) = 0
            r1 = Wp @ zp - wv * xmy
            r2 = Wm @ zm - wv * xpy
            rn = np.sqrt(np.linalg.norm(r1) ** 2 + np.linalg.norm(r2) ** 2)
            rnorms.append(rn)
            xpy_list.append(xpy)
            xmy_list.append(xmy)
            if rn > tol:
                for r in (r1, r2):
                    denom = diag - wv
                    denom = np.where(np.abs(denom) < 1e-8, 1e-8, denom)
                    t = r / denom
                    t = t - V @ (V.T @ t)
                    nrm = np.linalg.norm(t)
                    if nrm > 1e-6:
                        news.append(t / nrm)
        if verbose:
            print(f"rpa_davidson it {it}: w={omegas} |r|={rnorms}")
        if not news:
            conv = True
            break
        T = np.stack(news, axis=1)
        T = T - V @ (V.T @ T)
        T, _ = np.linalg.qr(T)
        keepcols = [c for c in range(T.shape[1])
                    if np.linalg.norm(T[:, c]) > 0.5]
        T = T[:, keepcols]
        if T.shape[1] == 0:
            conv = True
            break
        if V.shape[1] + T.shape[1] > max_space:
            # collapse to current Ritz space (both paired components)
            V = np.concatenate(
                [np.stack(xpy_list, 1), np.stack(xmy_list, 1)], axis=1)
            V, _ = np.linalg.qr(V)
            Wp = np.asarray(apb_mv(V))
            Wm = np.asarray(amb_mv(V))
            T = T - V @ (V.T @ T)
            T, _ = np.linalg.qr(T)
        Wp = np.concatenate([Wp, np.asarray(apb_mv(T))], axis=1)
        Wm = np.concatenate([Wm, np.asarray(amb_mv(T))], axis=1)
        V = np.concatenate([V, T], axis=1)

    xpy = np.stack(xpy_list, axis=1)
    xmy = np.stack(xmy_list, axis=1)
    # normalize <X+Y|X-Y> = 1
    for k in range(xpy.shape[1]):
        s = xpy[:, k] @ xmy[:, k]
        if abs(s) > 1e-12:
            f = 1.0 / np.sqrt(abs(s))
            xpy[:, k] *= f
            xmy[:, k] *= f
    return omegas, xpy, xmy, conv


def davidson(matvec: Callable, diag: np.ndarray, nroots: int,
             x0: Optional[np.ndarray] = None, tol: float = 1e-6,
             max_cycle: int = 60, max_space: Optional[int] = None,
             verbose: int = 0) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Lowest eigenpairs of a symmetric operator.

    matvec: (n, k) -> (n, k) batched; diag: [n] diagonal approximation.
    Returns (eigenvalues [nroots], eigenvectors [n, nroots], converged).
    """
    n = diag.shape[0]
    nroots = min(nroots, n)
    max_space = max_space or max(6 * nroots, 24)

    if x0 is None:
        order = np.argsort(diag)
        x0 = np.zeros((n, nroots))
        for i in range(nroots):
            x0[order[i], i] = 1.0
    V = np.array(x0, dtype=np.float64)
    V, _ = np.linalg.qr(V)
    AV = np.asarray(matvec(V))

    conv = False
    theta = np.zeros(nroots)
    for it in range(max_cycle):
        H = V.T @ AV
        H = 0.5 * (H + H.T)
        w, U = np.linalg.eigh(H)
        theta = w[:nroots]
        Y = V @ U[:, :nroots]
        AY = AV @ U[:, :nroots]
        R = AY - Y * theta[None, :]
        rnorm = np.linalg.norm(R, axis=0)
        if verbose:
            print(f"davidson it {it}: theta={theta} |r|={rnorm}")
        if (rnorm < tol).all():
            conv = True
            break
        # preconditioned new directions
        news = []
        for k in range(nroots):
            if rnorm[k] < tol:
                continue
            denom = diag - theta[k]
            denom = np.where(np.abs(denom) < 1e-8,
                             np.sign(denom + 1e-30) * 1e-8, denom)
            t = R[:, k] / denom
            t = t - V @ (V.T @ t)
            nrm = np.linalg.norm(t)
            if nrm > 1e-6:
                news.append(t / nrm)
        if not news:
            conv = True
            break
        T = np.stack(news, axis=1)
        # re-orthogonalize against V
        T = T - V @ (V.T @ T)
        T, _ = np.linalg.qr(T)
        if V.shape[1] + T.shape[1] > max_space:
            # collapse to current Ritz vectors
            V = Y
            AV = AY
            V, rmat = np.linalg.qr(V)
            AV = AV @ np.linalg.inv(rmat)
            T = T - V @ (V.T @ T)
            T, _ = np.linalg.qr(T)
        AT = np.asarray(matvec(T))
        V = np.concatenate([V, T], axis=1)
        AV = np.concatenate([AV, AT], axis=1)

    return theta, Y, conv
