"""Kohn–Sham DFT: closed-shell RKS and open-shell UKS.

Port of ``cctpu/dft/rks.py``:
 - the grid is padded into fixed-size chunks; AO values and gradients are
   evaluated once per geometry into an f64 cache [nchunk, 4, chunk, nao]
   when it fits the device, else recomputed chunk by chunk;
 - E_xc[D] is a Python loop over the chunks (cctpu's ``lax.scan``);
 - the XC Fock matrix is ``torch.autograd.grad`` of E_xc with respect to
   the density matrix, taken chunk by chunk (the sum of the chunk
   gradients is the gradient of the sum) and made symmetric;
 - the hybrid's exact exchange comes from the same J/K builder as HF,
   and a range-separated functional's long-range exchange from the
   builder's ``k_lr`` (B_lr on the DF route);
 - meta-GGAs get the kinetic-energy densities from the AO gradients the
   cache already holds;
 - UKS keeps both spin densities stacked as [2, nao, nao].
"""

from __future__ import annotations

import torch

from cctpu_torch.dft.grids import Grids
from cctpu_torch.dft.numint import eval_ao, eval_tau
from cctpu_torch.dft.xc import get_functional
from cctpu_torch.scf.hf import RHF, UHF

# padding points sit this far away (bohr): every AO is exactly 0 there
_PAD_AT = 1e6


def _chunk_pts(pts, w, chunk: int):
    """Pad and reshape grid points/weights into fixed-size chunks (padding
    points go far away with zero weight)."""
    npts = pts.shape[0]
    npad = (-npts) % chunk
    pts = torch.cat([pts, torch.full((npad, 3), _PAD_AT, dtype=pts.dtype,
                                     device=pts.device)])
    w = torch.cat([w, torch.zeros(npad, dtype=w.dtype, device=w.device)])
    return pts.reshape(-1, chunk, 3), w.reshape(-1, chunk)


def _ao_cache_budget(device) -> float:
    """Bytes the f64 AO cache may take: a quarter of the free device
    memory on the card, 3 GB on the host."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return 0.25 * free
    return 3e9


class _XCMixin:
    """Shared XC machinery of RKS and UKS: the functional ``xc`` and its
    grid (``grid_level``) are set up at construction."""

    xc: str = "b3lyp"
    grid_level: int = 3
    grid_chunk: int = 8192

    def __init__(self, mol, xc: str = "b3lyp", **opts):
        super().__init__(mol, **opts)
        self.xc = xc
        self.grid_level = opts.get("grid_level", 3)
        self._setup_xc()

    def _setup_xc(self):
        self.func = get_functional(self.xc)
        for attr in ("_ao_chunks64", "_pts_chunks", "_w_chunks"):
            self.__dict__.pop(attr, None)
        if self.func.xctype == "HF":
            return
        self.grids = Grids(self.mol, level=self.grid_level)
        # on the card the per-chunk XC is launch-bound (hundreds of small
        # elementwise kernels per chunk): 8x larger chunks there
        self._chunk = self.grid_chunk * (8 if self.device.type == "cuda"
                                         else 1)
        chunks = [self._grid_chunk(self.coords, k)
                  for k in range(-(-self.grids.npts // self._chunk))]
        self._pts_chunks = torch.stack([p for p, _ in chunks])
        self._w_chunks = torch.stack([w for _, w in chunks])

    def _grid_chunk(self, coords, k: int):
        """Points [chunk, 3] and weights [chunk] of grid chunk ``k`` at
        ``coords``; the last chunk is padded. The SCF's chunks and the
        gradient's are built here alike, so at the SCF's geometry they
        agree bit for bit."""
        pts, w = self.grids.build(coords, k * self._chunk,
                                  (k + 1) * self._chunk)
        pts, w = _chunk_pts(pts, w, self._chunk)
        return pts[0], w[0]

    def _prepare_xc_f64(self):
        """Per-geometry f64 AO-value cache, when it fits (else each E_xc
        evaluation recomputes the chunk's AOs)."""
        if self.func.xctype == "HF" or hasattr(self, "_ao_chunks64"):
            return
        nchunk, chunk = self._w_chunks.shape
        nao = self.mol.nao
        if nchunk * 4 * chunk * nao * 8 > _ao_cache_budget(self.device):
            return
        cache = torch.empty((nchunk, 4, chunk, nao), dtype=self.coords.dtype,
                            device=self.device)
        for k in range(nchunk):
            cache[k] = eval_ao(self.mol.basis_set, self.coords,
                               self._pts_chunks[k], deriv=1)
        self._ao_chunks64 = cache

    def _chunk_ao(self, k):
        cache = getattr(self, "_ao_chunks64", None)
        if cache is not None:
            return cache[k]
        return eval_ao(self.mol.basis_set, self.coords, self._pts_chunks[k],
                       deriv=1)

    @staticmethod
    def _chunk_exc_from_ao(func, dm, ao, w):
        """Integrated XC energy of one grid chunk given AO values
        ao [4, chunk, nao] (value + 3 gradients); a [nao, nao] dm is the
        restricted total density, a [2, nao, nao] one the two spins. The
        kinetic-energy densities (``eval_tau``) are formed for meta-GGAs
        only, else passed as zeros."""
        a0 = ao[0]
        mgga = func.xctype == "MGGA"
        if dm.ndim == 2:
            da = (0.5 * dm) @ a0.T                       # [nao, chunk]
            ra = torch.einsum("pi,ip->p", a0, da)
            ga = torch.stack([2 * torch.einsum("pi,ip->p", ao[1 + d], da)
                              for d in range(3)], -1)
            saa = torch.einsum("pd,pd->p", ga, ga)
            ta = eval_tau(ao, 0.5 * dm) if mgga else torch.zeros_like(ra)
            e = func.exc(ra, ra, saa, saa, saa, ta, ta)
            return torch.sum(w * e)
        dab = dm @ a0.T                                  # [2, nao, chunk]
        r = torch.einsum("pi,sip->sp", a0, dab)
        g = torch.stack([2 * torch.einsum("pi,sip->sp", ao[1 + d], dab)
                         for d in range(3)], -1)         # [2, chunk, 3]
        saa = torch.einsum("pd,pd->p", g[0], g[0])
        sab = torch.einsum("pd,pd->p", g[0], g[1])
        sbb = torch.einsum("pd,pd->p", g[1], g[1])
        if mgga:
            ta, tb = eval_tau(ao, dm[0]), eval_tau(ao, dm[1])
        else:
            ta = tb = torch.zeros_like(r[0])
        e = func.exc(r[0], r[1], saa, sab, sbb, ta, tb)
        return torch.sum(w * e)

    def exc_of_coords(self, coords, dm):
        """(E_xc[dm], dE_xc/dR [natm, 3]) with the grid rebuilt at
        ``coords``: the derivatives of the grid points and of the Becke
        weights are included (cctpu's ``exc_of_coords`` under
        ``jax.grad``). The backward is taken chunk by chunk, each chunk's
        points, weights and AO values built from the leaf ``coords``, so
        memory stays at one chunk; the AO cache has no graph to the
        coordinates and is not used."""
        basis = self.mol.basis_set
        dm = dm.detach()
        leaf = coords.detach().requires_grad_(True)
        exc = torch.zeros((), dtype=dm.dtype, device=dm.device)
        grad = torch.zeros_like(leaf)
        with torch.enable_grad():
            for k in range(self._w_chunks.shape[0]):
                pts, w = self._grid_chunk(leaf, k)
                ao = eval_ao(basis, leaf, pts, deriv=1)
                e = self._chunk_exc_from_ao(self.func, dm, ao, w)
                g, = torch.autograd.grad(e, leaf)
                exc = exc + e.detach()
                grad = grad + g
        return exc, grad

    def _exc_vxc(self, dm):
        """(E_xc, dE_xc/dD) by autograd, one chunk at a time; dm is
        [nao, nao] or [2, nao, nao]. The gradient is projected onto
        matrices symmetric in the last two axes: D is constrained
        symmetric, and the GGA terms make the raw gradient asymmetric."""
        self._prepare_xc_f64()
        dm_leaf = dm.detach().requires_grad_(True)
        exc = torch.zeros((), dtype=dm.dtype, device=dm.device)
        vxc = torch.zeros_like(dm)
        with torch.enable_grad():
            for k in range(self._w_chunks.shape[0]):
                e = self._chunk_exc_from_ao(self.func, dm_leaf,
                                            self._chunk_ao(k),
                                            self._w_chunks[k])
                g, = torch.autograd.grad(e, dm_leaf)
                exc = exc + e.detach()
                vxc = vxc + g
        return exc, 0.5 * (vxc + vxc.transpose(-1, -2))


class RKS(_XCMixin, RHF):
    def get_veff(self, dm, cocc=None):
        func = self.func
        J, K = self._jk(dm, with_k=bool(func.hyb), cocc=cocc)
        veff = J
        e2 = 0.5 * torch.einsum("ij,ij->", dm, J)
        if func.hyb:
            veff = veff - 0.5 * func.hyb * K
            e2 = e2 - 0.25 * func.hyb * torch.einsum("ij,ij->", dm, K)
        if func.rsh is not None:
            omega, _, beta = func.rsh
            Klr = self._jk.k_lr(dm, omega, cocc=cocc)
            veff = veff - 0.5 * beta * Klr
            e2 = e2 - 0.25 * beta * torch.einsum("ij,ij->", dm, Klr)
        if func.exc is not None:
            exc, vxc = self._exc_vxc(dm)
            veff = veff + vxc
            e2 = e2 + exc
        return veff, e2


class UKS(_XCMixin, UHF):
    def get_veff(self, dm, cocc=None):
        func = self.func
        J, K = self._jk(dm, with_k=bool(func.hyb), cocc=cocc)
        Jtot = J[0] + J[1]
        veff = torch.stack([Jtot, Jtot])
        e2 = 0.5 * torch.einsum("sij,ij->", dm, Jtot)
        if func.hyb:
            veff = veff - func.hyb * K
            e2 = e2 - 0.5 * func.hyb * torch.einsum("sij,sij->", dm, K)
        if func.rsh is not None:
            omega, _, beta = func.rsh
            Klr = self._jk.k_lr(dm, omega, cocc=cocc)
            veff = veff - beta * Klr
            e2 = e2 - 0.5 * beta * torch.einsum("sij,sij->", dm, Klr)
        if func.exc is not None:
            exc, vxc = self._exc_vxc(dm)
            veff = veff + vxc
            e2 = e2 + exc
        return veff, e2
