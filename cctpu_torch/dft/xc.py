"""Exchange-correlation functionals in torch: what HF, BLYP and B3LYP need.

Port of the B3LYP pieces of ``cctpu/dft/xc.py``: each functional is an
energy density e(rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb, tau_a, tau_b)
in Ha/bohr^3, written from the published forms. Potentials are never hand
coded: the XC Fock matrix is the autograd gradient of the integrated energy
(``dft/rks.py``). All branches are NaN-safe under autograd (double-where
low-density guards), as in the reference.

Ported: Slater X, VWN3 C, B88 X, LYP C, and the composites ``hf``,
``blyp`` (pure GGA) and ``b3lyp`` (VWN3, Gaussian/libxc convention). Every other functional of the
reference is a later slice; ``get_functional`` says so.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

_TINY = 1e-11


def _safe(rho):
    mask = rho > _TINY
    return mask, torch.where(mask, rho, torch.ones_like(rho))


def _where0(mask, x):
    return torch.where(mask, x, torch.zeros_like(x))


# ----------------------------------------------------------------------------
# LDA exchange
# ----------------------------------------------------------------------------

_CX = (3.0 / 4.0) * (3.0 / math.pi) ** (1.0 / 3.0)


def e_x_slater(ra, rb, *_):
    out = 0.0
    for r in (ra, rb):
        r = torch.clamp(r, min=0.0)
        m, rs = _safe(r)
        out = out + _where0(m, -0.5 * _CX * (2.0 * rs) ** (4.0 / 3.0))
    return out


# ----------------------------------------------------------------------------
# VWN correlation — Vosko, Wilk, Nusair 1980 (VWN3 parameterization)
# ----------------------------------------------------------------------------

_VWN3 = {
    "P": (0.0310907, 13.0720, 42.7198, -0.409286),
    "F": (0.01554535, 20.1231, 101.578, -0.743294),
    "A": (-1.0 / (6.0 * math.pi ** 2), 1.06835, 11.4813, -0.228344),
}


def _vwn_eps(x, A, b, c, x0):
    X = x * x + b * x + c
    X0 = x0 * x0 + b * x0 + c
    Q = math.sqrt(4 * c - b * b)
    atn = torch.atan(Q / (2 * x + b))
    return A * (torch.log(x * x / X) + 2 * b / Q * atn
                - b * x0 / X0 * (torch.log((x - x0) ** 2 / X)
                                 + 2 * (b + 2 * x0) / Q * atn))


def _f_zeta(z):
    zp = torch.clamp(z, -1.0, 1.0)
    up = torch.clamp(1.0 + zp, min=1e-15)
    dn = torch.clamp(1.0 - zp, min=1e-15)
    return ((up ** (4.0 / 3.0) + dn ** (4.0 / 3.0) - 2.0)
            / (2.0 ** (4.0 / 3.0) - 2.0))


_FPP0 = 4.0 / (9.0 * (2.0 ** (1.0 / 3.0) - 1.0))   # f''(0)


def _e_c_vwn(params):
    def fn(ra, rb, *_):
        rho = ra + rb
        m, r = _safe(rho)
        z = _where0(m, (ra - rb) / r)
        rs = (3.0 / (4.0 * math.pi * r)) ** (1.0 / 3.0)
        x = torch.sqrt(rs)
        eP = _vwn_eps(x, *params["P"])
        eF = _vwn_eps(x, *params["F"])
        eA = _vwn_eps(x, *params["A"])
        f = _f_zeta(z)
        z4 = z ** 4
        eps = eP + eA * f / _FPP0 * (1 - z4) + (eF - eP) * f * z4
        return _where0(m, r * eps)
    return fn


e_c_vwn3 = _e_c_vwn(_VWN3)


# ----------------------------------------------------------------------------
# B88 exchange (Becke 1988)
# ----------------------------------------------------------------------------

_B88_BETA = 0.0042


def e_x_b88(ra, rb, saa, sab, sbb, *_):
    out = 0.0
    for r, s in ((ra, saa), (rb, sbb)):
        m, rs = _safe(r)
        ms = s > 1e-24           # double-where: sqrt(0) has NaN gradient
        ss = torch.where(ms, s, torch.ones_like(s))
        r43 = rs ** (4.0 / 3.0)
        x = torch.sqrt(ss) / r43
        lda = -_CX * 2.0 ** (1.0 / 3.0) * r43
        corr = _where0(ms, -_B88_BETA * r43 * x * x / (
            1.0 + 6.0 * _B88_BETA * x * torch.asinh(x)))
        out = out + _where0(m, lda + corr)
    return out


# ----------------------------------------------------------------------------
# LYP correlation (Lee-Yang-Parr via Miehlich et al. CPL 157, 200 (1989))
# ----------------------------------------------------------------------------

_LYP_A, _LYP_B, _LYP_C, _LYP_D = 0.04918, 0.132, 0.2533, 0.349
_CF = 0.3 * (3.0 * math.pi ** 2) ** (2.0 / 3.0)


def e_c_lyp(ra, rb, saa, sab, sbb, *_):
    # clamp: grid roundoff can give tiny negative spin densities
    ra = torch.clamp(ra, min=0.0)
    rb = torch.clamp(rb, min=0.0)
    rho = ra + rb
    m, r = _safe(rho)
    sigma = saa + 2 * sab + sbb
    r13 = r ** (-1.0 / 3.0)
    denom = 1.0 + _LYP_D * r13
    # fused exponent: exp(-c r^-1/3) r^-11/3 stays finite for all densities
    omega = torch.exp(-_LYP_C * r13 - (11.0 / 3.0) * torch.log(r)) / denom
    delta = _LYP_C * r13 + _LYP_D * r13 / denom
    term1 = -_LYP_A * 4.0 / denom * ra * rb / r
    inner = (ra * rb * (2.0 ** (11.0 / 3.0) * _CF *
                        (ra ** (8.0 / 3.0) + rb ** (8.0 / 3.0))
                        + (47.0 / 18.0 - 7.0 * delta / 18.0) * sigma
                        - (2.5 - delta / 18.0) * (saa + sbb)
                        - (delta - 11.0) / 9.0 *
                        (ra / r * saa + rb / r * sbb))
             - 2.0 / 3.0 * r * r * sigma
             + (2.0 / 3.0 * r * r - ra * ra) * sbb
             + (2.0 / 3.0 * r * r - rb * rb) * saa)
    term2 = -_LYP_A * _LYP_B * omega * inner
    return _where0(m, term1 + term2)


# ----------------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class XCFunctional:
    name: str
    xctype: str                      # 'LDA' | 'GGA' | 'MGGA' | 'HF'
    exc: Optional[Callable]          # e(ra, rb, saa, sab, sbb, ta, tb)
    hyb: float = 0.0                 # exact-exchange fraction (alpha)


def _combine(terms):
    def fn(*args):
        out = 0.0
        for coef, f in terms:
            out = out + coef * f(*args)
        return out
    return fn


def _make_registry() -> Dict[str, XCFunctional]:
    reg = {}

    def add(name, xctype, exc, **kw):
        reg[name] = XCFunctional(name=name, xctype=xctype, exc=exc, **kw)

    add("hf", "HF", None, hyb=1.0)
    add("blyp", "GGA", _combine([(1, e_x_b88), (1, e_c_lyp)]))
    # B3LYP (Gaussian/libxc convention, VWN3):
    #   Exc = 0.08 E_x^LSDA + 0.72 E_x^B88 + 0.20 E_x^HF
    #       + 0.19 E_c^VWN3 + 0.81 E_c^LYP
    add("b3lyp", "GGA",
        _combine([(0.08, e_x_slater), (0.72, e_x_b88),
                  (0.19, e_c_vwn3), (0.81, e_c_lyp)]), hyb=0.20)
    return reg


_REGISTRY = _make_registry()


def get_functional(name: str) -> XCFunctional:
    key = name.strip().lower().replace("-", "").replace(" ", "")
    if key in _REGISTRY:
        return _REGISTRY[key]
    raise NotImplementedError(
        f"XC functional {name!r} is not in the PyTorch port yet (ported: "
        f"{sorted(_REGISTRY)}; the rest of cctpu's functionals are "
        "ROADMAP.md queue 1 item 10)")
