"""SCF checkpoints: the converged state of an SCF in an ``.npz`` file, keyed
by (geometry, method, basis), so a workflow run warm-starts from a density
it has already converged (the ``--scf-cache`` flag).

The port's own copy of ``cctpu/utils/chkfile.py``, with the same key and
``.npz`` layout: a file written by either package loads in the other.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from typing import Optional

import numpy as np


def _numpy(x) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)


def geometry_key(mol, method: str) -> str:
    h = hashlib.sha256()
    h.update(np.asarray(mol.coords).round(10).tobytes())
    h.update(",".join(mol.symbols).encode())
    h.update(f"{mol.charge}|{mol.spin}|{mol.basis}|{method}".encode())
    return h.hexdigest()[:20]


def save_scf(path: str, mf, method: str = ""):
    np.savez_compressed(
        path,
        e_tot=mf.e_tot,
        mo_coeff=_numpy(mf.mo_coeff),
        mo_energy=_numpy(mf.mo_energy),
        mo_occ=_numpy(mf.mo_occ),
        dm=_numpy(mf.dm),
        converged=mf.converged,
        coords=np.asarray(mf.mol.coords),
        key=geometry_key(mf.mol, method),
        basis=str(mf.mol.basis),
        nao=int(mf.mol.nao),
    )


def load_dm0(path: str, mol, method: str = "") -> Optional[np.ndarray]:
    """The stored density if it is usable as a warm start, else None.

    The same basis and nao returns the stored dm (at the same geometry the
    converged one; at another geometry still a good start); a basis or nao
    mismatch, or a file that is missing or unreadable, returns None."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if "nao" in z and int(z["nao"]) != int(mol.nao):
                return None
            if "basis" in z and str(z["basis"]) != str(mol.basis):
                return None
            dm = z["dm"]
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None
    return dm if dm.shape[-1] == int(mol.nao) else None


class SCFCache:
    """Directory-backed dm cache for sweep workflows (BDE bonds, scans)."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def path(self, mol, method: str) -> str:
        return os.path.join(self.dir, geometry_key(mol, method) + ".npz")

    def get(self, mol, method: str):
        return load_dm0(self.path(mol, method), mol, method)

    def put(self, mf, method: str):
        save_scf(self.path(mf.mol, method), mf, method)
