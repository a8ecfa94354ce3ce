"""Exchange-correlation functionals in torch.

Port of ``cctpu/dft/xc.py``: each functional is an energy density
e(rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb, tau_a, tau_b) in Ha/bohr^3,
written from the published forms. Potentials are never hand coded: the XC
Fock matrix is the autograd gradient of the integrated energy
(``dft/rks.py``). Every guarded branch is NaN-safe under autograd: the
unselected branch is evaluated at a harmless value and then masked
(``_safe`` + ``_where0``, the double where), since a NaN or inf in the
unselected branch of ``torch.where`` poisons the gradient.

Implemented: Slater X, VWN3/VWN5 C, PW92 C, B88 X, LYP C, PBE X/C, the M06
family (M06, M06-2X), B97-type wB97X exchange and correlation, the CAM
short-range attenuation, and the registry of cctpu: HF, LDA/SVWN,
``lda,vwn3``, PW92, BLYP, PBE, PBE0, B3LYP (VWN3, Gaussian/libxc
convention), B3LYP5, M06-2X, M06, CAM-B3LYP and wB97X-D, with the
``-d``/``-d2`` suffix for Grimme's D2 (``dft/dispersion.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

_TINY = 1e-11


def _safe(rho):
    mask = rho > _TINY
    return mask, torch.where(mask, rho, torch.ones_like(rho))


def _where0(mask, x):
    return torch.where(mask, x, torch.zeros_like(x))


def _clip(x, lo, hi=None):
    """``jnp.clip`` (``jnp.maximum`` without ``hi``) as cctpu computes it:
    at a tie the gradient is split evenly between the two arguments, where
    ``torch.clamp`` passes it whole, so vxc agrees with cctpu's where a
    density sits on a bound (zeta = +-1, the M06 factor D = 1)."""
    x = torch.maximum(x, x.new_tensor(lo))
    return x if hi is None else torch.minimum(x, x.new_tensor(hi))


# ----------------------------------------------------------------------------
# LDA exchange
# ----------------------------------------------------------------------------

_CX = (3.0 / 4.0) * (3.0 / math.pi) ** (1.0 / 3.0)


def e_x_slater(ra, rb, *_):
    out = 0.0
    for r in (ra, rb):
        r = _clip(r, 0.0)
        m, rs = _safe(r)
        out = out + _where0(m, -0.5 * _CX * (2.0 * rs) ** (4.0 / 3.0))
    return out


# ----------------------------------------------------------------------------
# VWN correlation (both parameterizations) — Vosko, Wilk, Nusair 1980
# ----------------------------------------------------------------------------

_VWN5 = {  # (A, b, c, x0) for para / ferro / spin stiffness
    "P": (0.0310907, 3.72744, 12.9352, -0.10498),
    "F": (0.01554535, 7.06042, 18.0578, -0.32500),
    "A": (-1.0 / (6.0 * math.pi ** 2), 1.13107, 13.0045, -0.0047584),
}
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
    # the clamps keep the fractional power off a zero base at zeta = +-1
    zp = _clip(z, -1.0, 1.0)
    up = _clip(1.0 + zp, 1e-15)
    dn = _clip(1.0 - zp, 1e-15)
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


e_c_vwn5 = _e_c_vwn(_VWN5)
e_c_vwn3 = _e_c_vwn(_VWN3)


# ----------------------------------------------------------------------------
# PW92 correlation (Perdew & Wang 1992)
# ----------------------------------------------------------------------------

_PW92 = {
    "P": (0.031091, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294),
    "F": (0.015545, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517),
    "A": (0.016887, 0.11125, 10.357, 3.6231, 0.88026, 0.49671),
}


def _pw92_G(rs, A, a1, b1, b2, b3, b4):
    s = torch.sqrt(rs)
    den = 2 * A * (b1 * s + b2 * rs + b3 * rs * s + b4 * rs * rs)
    return -2 * A * (1 + a1 * rs) * torch.log(1 + 1.0 / den)


def pw92_eps(rs, z):
    eP = _pw92_G(rs, *_PW92["P"])
    eF = _pw92_G(rs, *_PW92["F"])
    eA = -_pw92_G(rs, *_PW92["A"])
    f = _f_zeta(z)
    z4 = z ** 4
    return eP + eA * f / _FPP0 * (1 - z4) + (eF - eP) * f * z4


def e_c_pw92(ra, rb, *_):
    rho = ra + rb
    m, r = _safe(rho)
    z = _where0(m, (ra - rb) / r)
    rs = (3.0 / (4.0 * math.pi * r)) ** (1.0 / 3.0)
    return _where0(m, r * pw92_eps(rs, z))


# ----------------------------------------------------------------------------
# B88 exchange (Becke 1988)
# ----------------------------------------------------------------------------

_B88_BETA = 0.0042


def _b88_spin(rs, s):
    """(LSDA, gradient correction) of B88 for one spin at the safe density
    ``rs`` and sigma ``s``; the correction is 0 where s <= 1e-24
    (double where: sqrt(0) has a NaN gradient)."""
    ms = s > 1e-24
    ss = torch.where(ms, s, torch.ones_like(s))
    r43 = rs ** (4.0 / 3.0)
    x = torch.sqrt(ss) / r43
    lda = -_CX * 2.0 ** (1.0 / 3.0) * r43
    corr = _where0(ms, -_B88_BETA * r43 * x * x / (
        1.0 + 6.0 * _B88_BETA * x * torch.asinh(x)))
    return lda, corr


def e_x_b88(ra, rb, saa, sab, sbb, *_):
    out = 0.0
    for r, s in ((ra, saa), (rb, sbb)):
        m, rs = _safe(r)
        lda, corr = _b88_spin(rs, s)
        out = out + _where0(m, lda + corr)
    return out


# ----------------------------------------------------------------------------
# LYP correlation (Lee-Yang-Parr via Miehlich et al. CPL 157, 200 (1989))
# ----------------------------------------------------------------------------

_LYP_A, _LYP_B, _LYP_C, _LYP_D = 0.04918, 0.132, 0.2533, 0.349
_CF = 0.3 * (3.0 * math.pi ** 2) ** (2.0 / 3.0)


def e_c_lyp(ra, rb, saa, sab, sbb, *_):
    # clamp: grid roundoff can give tiny negative spin densities
    ra = _clip(ra, 0.0)
    rb = _clip(rb, 0.0)
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
# PBE exchange & correlation (Perdew, Burke, Ernzerhof 1996)
# ----------------------------------------------------------------------------

_PBE_KAPPA = 0.804
_PBE_MU = 0.2195149727645171
_PBE_BETA = 0.06672455060314922
_PBE_GAMMA = (1.0 - math.log(2.0)) / math.pi ** 2


def _pbe_fx(rs, s):
    """PBE exchange enhancement F(s^2) of one spin at the safe density
    ``rs``; below rho_s 1e-7 the enhancement is 1 (LDA), as in cctpu."""
    mg = rs > 1e-7
    rg = torch.where(mg, rs, torch.ones_like(rs))
    r2 = 2.0 * rg
    kf = (3.0 * math.pi ** 2 * r2) ** (1.0 / 3.0)
    # s^2 = 4 sigma / (2 kf 2 rho)^2: no sqrt needed
    s2 = _where0(mg, 4.0 * _where0(s > 0, s) / (2.0 * kf * r2) ** 2)
    return 1.0 + _PBE_KAPPA - _PBE_KAPPA / (1.0 + _PBE_MU * s2 / _PBE_KAPPA)


def e_x_pbe(ra, rb, saa, sab, sbb, *_):
    out = 0.0
    for r, s in ((ra, saa), (rb, sbb)):
        m, rs = _safe(r)
        lda = -_CX * (2.0 * rs) ** (4.0 / 3.0)
        out = out + _where0(m, 0.5 * lda * _pbe_fx(rs, s))
    return out


def e_c_pbe(ra, rb, saa, sab, sbb, *_):
    rho = ra + rb
    m, r = _safe(rho)
    z = _clip(_where0(m, (ra - rb) / r), -1 + 1e-12, 1 - 1e-12)
    rs = (3.0 / (4.0 * math.pi * r)) ** (1.0 / 3.0)
    eps_lda = pw92_eps(rs, z)
    phi = 0.5 * (_clip(1.0 + z, 1e-15) ** (2.0 / 3.0)
                 + _clip(1.0 - z, 1e-15) ** (2.0 / 3.0))
    # below rho 1e-7 the gradient correction H is dropped (t^2 = 0)
    mg = r > 1e-7
    rg = torch.where(mg, r, torch.ones_like(r))
    kf = (3.0 * math.pi ** 2 * rg) ** (1.0 / 3.0)
    ks = torch.sqrt(4.0 * kf / math.pi)
    sigma = saa + 2 * sab + sbb
    t2 = _where0(mg, _where0(sigma > 0, sigma)
                 / (4.0 * phi * phi * ks * ks * rg * rg))
    expo = torch.exp(-eps_lda / (_PBE_GAMMA * phi ** 3))
    A = _PBE_BETA / _PBE_GAMMA / _clip(expo - 1.0, 1e-30)
    num = 1.0 + A * t2
    den = 1.0 + A * t2 + A * A * t2 * t2
    H = _PBE_GAMMA * phi ** 3 * torch.log(
        1.0 + _PBE_BETA / _PBE_GAMMA * t2 * num / den)
    return _where0(m, r * (eps_lda + H))


# ----------------------------------------------------------------------------
# M06 family meta-GGAs (Zhao & Truhlar, Theor. Chem. Acc. 120, 215 (2008);
# M06-L form: J. Chem. Phys. 125, 194101 (2006); VS98 ingredients:
# Van Voorhis & Scuseria, J. Chem. Phys. 109, 400 (1998))
# ----------------------------------------------------------------------------
# Working equations (per spin; x^2 = sigma_ss/rho^(8/3),
# z = 2 tau/rho^(5/3) - C_F, C_F = (3/5)(6 pi^2)^(2/3)):
#   E_x    = sum_s int e_x^LSDA(rho_s) [F_PBE(s^2) f(w_s) + h_x(x_s, z_s)]
#   E_c^ss = int e_ss^UEG [g_ss(x_s) + h_ss(x_s, z_s)] D_s
#   E_c^ab = int e_ab^UEG [g_ab(xbar) + h_ab(xbar, zbar)],
#            xbar^2 = x_a^2 + x_b^2, zbar = z_a + z_b
# with f(w) = sum a_i w^i, g(u) = sum c_i u^i (u = gamma x^2/(1+gamma x^2)),
# and the VS98-type h(x,z) = d0/G + (d1 x^2 + d2 z)/G^2
# + (d3 x^4 + d4 x^2 z + d5 z^2)/G^3, G = 1 + alpha (x^2 + z).
# Each parameter set satisfies the UEG sum rules (exchange: a0 + d0 + X_HF
# = 1; correlation: c0 + d0 = 1 per channel).

_M062X_A = (4.600000e-01, -2.206052e-01, -9.431788e-02, 2.164494e+00,
            -2.556466e+00, -1.422133e+01, 1.555044e+01, 3.598078e+01,
            -2.722754e+01, -3.924093e+01, 1.522808e+01, 1.522227e+01)
_M062X_CSS = (3.097855e-01, -5.528642e+00, 1.347420e+01, -3.213623e+01,
              2.846742e+01)
_M062X_CAB = (8.833596e-01, 3.357972e+01, -7.043548e+01, 4.978271e+01,
              -1.852891e+01)
_M062X_DSS = (6.902145e-01, 9.847204e-02, 2.214797e-01, -1.968264e-03,
              -6.775479e-03, 0.0)
_M062X_DAB = (1.166404e-01, -9.120847e-02, -6.726189e-02, 6.720580e-05,
              8.448011e-04, 0.0)

_M06_A = (5.877943e-01, -1.371776e-01, 2.682367e-01, -2.515898e+00,
          -2.978892e+00, 8.710679e+00, 1.688195e+01, -4.489724e+00,
          -3.299983e+01, -1.449050e+01, 2.043747e+01, 1.256504e+01)
_M06_DX = (1.422057e-01, 7.370319e-04, -1.601373e-02, 0.0, 0.0, 0.0)
_M06_CSS = (5.094055e-01, -1.491085e+00, 1.723922e+01, -3.859018e+01,
            2.845044e+01)
_M06_DSS = (4.905945e-01, -1.437348e-01, 2.357824e-01, 1.871015e-03,
            -3.788963e-03, 0.0)
_M06_CAB = (3.741539e+00, 2.187098e+02, -4.531252e+02, 2.936479e+02,
            -6.287470e+01)
_M06_DAB = (-2.741539e+00, -6.720113e-01, -7.932688e-02, 1.918681e-03,
            -2.032902e-03, 0.0)

# VS98-part inhomogeneity parameters (shared across the M06 family)
_VS98_ALPHA_X = 0.00186726
_VS98_ALPHA_SS = 0.00515088
_VS98_ALPHA_AB = 0.00304966

_CF_TAU = 0.3 * (6.0 * math.pi ** 2) ** (2.0 / 3.0)   # tau_LSDA coefficient
_CF_M06 = 2.0 * _CF_TAU                               # the papers' C_F


def _m06_fw(rho, tau, coeffs):
    tau_ueg = _CF_TAU * rho ** (5.0 / 3.0)
    t = tau_ueg / _clip(tau, 1e-12)
    w = _clip((t - 1.0) / (t + 1.0), -1.0, 1.0)
    f = 0.0
    wp = 1.0
    for a in coeffs:
        f = f + a * wp
        wp = wp * w
    return f


# density floor of the B97/VS98/M06 inhomogeneity variables: below it x^2
# and z are taken as 0 (the UEG limit), as in cctpu
_TINY_X2 = 1e-7


def _x2_of(sigma, rho_safe):
    """x^2 = sigma/rho^(8/3) above the density floor, else 0."""
    mx = rho_safe > _TINY_X2
    r = torch.where(mx, rho_safe, torch.ones_like(rho_safe))
    return _where0(mx, sigma / r ** (8.0 / 3.0))


def _z_of(tau, rho_safe):
    """z = 2 tau/rho^(5/3) - C_F above the density floor, else 0."""
    mx = rho_safe > _TINY_X2
    r = torch.where(mx, rho_safe, torch.ones_like(rho_safe))
    return _where0(mx, 2.0 * tau / r ** (5.0 / 3.0) - _CF_M06)


def _vs98_h(x2, z, alpha, d):
    """VS98-type inhomogeneity series h(x^2, z)."""
    G = 1.0 + alpha * (x2 + z)
    G = torch.where(torch.abs(G) > 1e-10, G, torch.full_like(G, 1e-10))
    return (d[0] / G + (d[1] * x2 + d[2] * z) / G ** 2
            + (d[3] * x2 * x2 + d[4] * x2 * z + d[5] * z * z) / G ** 3)


def _make_m06_x(a_coeffs, d_coeffs):
    """M06-family exchange: e_x^LSDA [F_PBE f(w) + h_x(x,z)] per spin."""
    def fn(ra, rb, saa, sab, sbb, ta, tb):
        out = 0.0
        for r, s, tau in ((ra, saa, ta), (rb, sbb, tb)):
            m, rs = _safe(r)
            ss = _where0(s > 1e-24, s)
            lda = -_CX * (2.0 * rs) ** (4.0 / 3.0)
            tau_s = _clip(tau, 1e-12)
            enh = _pbe_fx(rs, ss) * _m06_fw(rs, tau_s, a_coeffs)
            if any(d_coeffs):
                x2 = _where0(m, _x2_of(ss, rs))
                z = _where0(m, _z_of(tau_s, rs))
                enh = enh + _vs98_h(x2, z, _VS98_ALPHA_X, d_coeffs)
            out = out + _where0(m, 0.5 * lda * enh)
        return out
    return fn


e_x_m062x = _make_m06_x(_M062X_A, (0.0,) * 6)
e_x_m06 = _make_m06_x(_M06_A, _M06_DX)


def _b97_g(x2, gamma, coeffs):
    """The B97/M06 power series g(u) = sum_i c_i u^i, u = gamma x^2/(1 +
    gamma x^2)."""
    u = gamma * x2 / (1.0 + gamma * x2)
    g = 0.0
    up = 1.0
    for c in coeffs:
        g = g + c * up
        up = up * u
    return g



def _ueg_c_spin(ra, rb):
    """UEG correlation split into (e_ab, e_aa, e_bb) via the standard
    spin decomposition e_ss(r) = e_c(r, r -> fully polarized)."""
    e_tot = e_c_pw92(ra, rb)
    e_aa = e_c_pw92(ra, torch.zeros_like(ra))
    e_bb = e_c_pw92(torch.zeros_like(rb), rb)
    return e_tot - e_aa - e_bb, e_aa, e_bb


def _dfac(rho, sigma, tau):
    """Self-interaction factor of the M05/M06 same-spin correlation:
    D = 1 - x^2/(4(z + C_F)) = 1 - sigma/(8 tau rho); 0 for a one-electron
    density (tau = sigma/(8 rho), von Weizsaecker)."""
    m, r = _safe(rho)
    D = 1.0 - _where0(m, sigma) / (
        8.0 * _clip(tau, 0.0) * r + 1e-15)
    return _clip(D, 0.0, 1.0)


def _make_m06_c(css, dss, cab, dab):
    """M06-family correlation: UEG channels scaled by [g + h] (same-spin
    additionally by the self-interaction factor D)."""
    def fn(ra, rb, saa, sab, sbb, ta, tb):
        e_ab, e_aa, e_bb = _ueg_c_spin(ra, rb)
        ma, rsa = _safe(ra)
        mb, rsb = _safe(rb)
        xa2 = _where0(ma, _x2_of(_clip(saa, 0.0), rsa))
        xb2 = _where0(mb, _x2_of(_clip(sbb, 0.0), rsb))
        za = _where0(ma, _z_of(_clip(ta, 0.0), rsa))
        zb = _where0(mb, _z_of(_clip(tb, 0.0), rsb))
        f_ab = (_b97_g(xa2 + xb2, 0.0031, cab)
                + _vs98_h(xa2 + xb2, za + zb, _VS98_ALPHA_AB, dab))
        f_aa = (_b97_g(xa2, 0.06, css)
                + _vs98_h(xa2, za, _VS98_ALPHA_SS, dss))
        f_bb = (_b97_g(xb2, 0.06, css)
                + _vs98_h(xb2, zb, _VS98_ALPHA_SS, dss))
        Daa = _dfac(ra, saa, ta)
        Dbb = _dfac(rb, sbb, tb)
        return e_ab * f_ab + e_aa * f_aa * Daa + e_bb * f_bb * Dbb
    return fn


e_c_m062x = _make_m06_c(_M062X_CSS, _M062X_DSS, _M062X_CAB, _M062X_DAB)
e_c_m06 = _make_m06_c(_M06_CSS, _M06_DSS, _M06_CAB, _M06_DAB)


# ----------------------------------------------------------------------------
# Range-separation attenuation (Iikura/Hirao short-range factor)
# ----------------------------------------------------------------------------

def _sr_factor(rho_s, mu):
    """Fraction of the LSDA exchange hole of one spin kept below range
    ``mu``; 1 where the density is below the floor."""
    m, r = _safe(rho_s)
    kf = (6.0 * math.pi ** 2 * r) ** (1.0 / 3.0)
    a = _clip(mu / (2.0 * kf), 1e-8, 50.0)
    exp_term = torch.exp(-1.0 / (4.0 * a * a))
    f = 1.0 - (8.0 / 3.0) * a * (
        math.sqrt(math.pi) * torch.erf(1.0 / (2.0 * a))
        + (2.0 * a - 4.0 * a ** 3) * exp_term - 3.0 * a + 4.0 * a ** 3)
    return torch.where(m, _clip(f, 0.0, 1.0), torch.ones_like(f))


# ----------------------------------------------------------------------------
# wB97X-D (Chai & Head-Gordon, Phys. Chem. Chem. Phys. 10, 6615 (2008))
# ----------------------------------------------------------------------------
# B97-type series g(u) on x^2 = sigma_ss/rho_s^(8/3); short-range DFT
# exchange via the attenuated LSDA hole (the same _sr_factor as
# CAM-B3LYP); 100% long-range HF exchange, c_x = 0.222036 short-range HF;
# CHG-damped D2 dispersion. Parameters from Table 1 of the paper.

_WB97XD_OMEGA = 0.2
_WB97XD_CXHF = 0.222036
_WB97XD_CX = (7.77964e-01, 6.61160e-01, 5.74541e-01, -5.25671e+00,
              -6.33469e+00)
_WB97XD_CSS = (1.00000e+00, -6.90539e+00, 3.13343e+01, -5.10533e+01,
               2.64423e+01)
_WB97XD_CAB = (1.00000e+00, 1.79413e+00, -1.22661e+01, 2.33481e+01,
               -1.19890e+01)
_B97_GAMMA_X = 0.004
_B97_GAMMA_SS = 0.2
_B97_GAMMA_AB = 0.006


def make_wb97_x(cx=_WB97XD_CX, omega=_WB97XD_OMEGA):
    """Short-range B97 exchange: e_x^SR-LSDA(rho_s; omega) g_x(u)."""
    def fn(ra, rb, saa, sab, sbb, *_):
        out = 0.0
        for r, s in ((ra, saa), (rb, sbb)):
            m, rs = _safe(r)
            x2 = _where0(m, _x2_of(_clip(s, 0.0), rs))
            lda = -0.5 * _CX * (2.0 * rs) ** (4.0 / 3.0)
            g = _b97_g(x2, _B97_GAMMA_X, cx)
            fsr = _sr_factor(rs, omega)
            out = out + _where0(m, lda * fsr * g)
        return out
    return fn


def make_b97_c(css=_WB97XD_CSS, cab=_WB97XD_CAB):
    """B97 correlation: UEG channels scaled by the g(u) series (same-spin
    gamma 0.2; opposite-spin on the average x^2, gamma 0.006)."""
    def fn(ra, rb, saa, sab, sbb, *_):
        e_ab, e_aa, e_bb = _ueg_c_spin(ra, rb)
        ma, rsa = _safe(ra)
        mb, rsb = _safe(rb)
        xa2 = _where0(ma, _x2_of(_clip(saa, 0.0), rsa))
        xb2 = _where0(mb, _x2_of(_clip(sbb, 0.0), rsb))
        xavg2 = 0.5 * (xa2 + xb2)
        return (e_ab * _b97_g(xavg2, _B97_GAMMA_AB, cab)
                + e_aa * _b97_g(xa2, _B97_GAMMA_SS, css)
                + e_bb * _b97_g(xb2, _B97_GAMMA_SS, css))
    return fn


def make_camb3lyp_x(alpha=0.19, beta=0.46, mu=0.33):
    """B88 exchange with CAM attenuation: local weight
    (1 - alpha - beta) + beta * f_sr(a)."""
    def fn(ra, rb, saa, sab, sbb, *_):
        out = 0.0
        for r, s in ((ra, saa), (rb, sbb)):
            m, rs = _safe(r)
            lda, corr = _b88_spin(rs, s)
            wloc = (1.0 - alpha - beta) + beta * _sr_factor(r, mu)
            out = out + _where0(m, (lda + corr) * wloc)
        return out
    return fn


# ----------------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class XCFunctional:
    name: str
    xctype: str                      # 'LDA' | 'GGA' | 'MGGA' | 'HF'
    exc: Optional[Callable]          # e(ra, rb, saa, sab, sbb, ta, tb)
    hyb: float = 0.0                 # exact-exchange fraction (alpha)
    rsh: Optional[Tuple[float, float, float]] = None  # (omega, alpha, beta)
    dispersion: Optional[str] = None  # 'd2' | 'd2-chg'


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
    add("lda", "LDA", _combine([(1, e_x_slater), (1, e_c_vwn5)]))
    reg["svwn"] = reg["lda"]
    add("lda,vwn3", "LDA", _combine([(1, e_x_slater), (1, e_c_vwn3)]))
    add("pw92", "LDA", _combine([(1, e_x_slater), (1, e_c_pw92)]))
    add("blyp", "GGA", _combine([(1, e_x_b88), (1, e_c_lyp)]))
    add("pbe", "GGA", _combine([(1, e_x_pbe), (1, e_c_pbe)]))
    add("pbe0", "GGA", _combine([(0.75, e_x_pbe), (1, e_c_pbe)]), hyb=0.25)
    # B3LYP (Gaussian/libxc convention, VWN3):
    #   Exc = 0.08 E_x^LSDA + 0.72 E_x^B88 + 0.20 E_x^HF
    #       + 0.19 E_c^VWN3 + 0.81 E_c^LYP
    add("b3lyp", "GGA",
        _combine([(0.08, e_x_slater), (0.72, e_x_b88),
                  (0.19, e_c_vwn3), (0.81, e_c_lyp)]), hyb=0.20)
    add("b3lyp5", "GGA",
        _combine([(0.08, e_x_slater), (0.72, e_x_b88),
                  (0.19, e_c_vwn5), (0.81, e_c_lyp)]), hyb=0.20)
    # M06-2X: 54% exact exchange; the series carry the fitted scaling
    add("m06-2x", "MGGA",
        _combine([(1.0, e_x_m062x), (1.0, e_c_m062x)]), hyb=0.54)
    # M06: 27% exact exchange; exchange carries the VS98 part h_x
    add("m06", "MGGA",
        _combine([(1.0, e_x_m06), (1.0, e_c_m06)]), hyb=0.27)
    # CAM-B3LYP: alpha = 0.19 SR-HF, alpha + beta = 0.65 LR-HF, mu = 0.33
    add("cam-b3lyp", "GGA",
        _combine([(1.0, make_camb3lyp_x()), (0.19, e_c_vwn5),
                  (0.81, e_c_lyp)]),
        hyb=0.19, rsh=(0.33, 0.19, 0.46))
    # wB97X-D: SR-B97 exchange + B97 correlation, 22.2036% SR-HF, 100%
    # LR-HF at omega = 0.2, CHG-damped D2 dispersion
    add("wb97x-d", "GGA",
        _combine([(1.0, make_wb97_x()), (1.0, make_b97_c())]),
        hyb=_WB97XD_CXHF,
        rsh=(_WB97XD_OMEGA, _WB97XD_CXHF, 1.0 - _WB97XD_CXHF),
        dispersion="d2-chg")
    return reg


_REGISTRY = _make_registry()
_ALIASES = {"m062x": "m06-2x", "wb97xd": "wb97x-d", "camb3lyp": "cam-b3lyp"}


def get_functional(name: str) -> XCFunctional:
    """The registry's functional of ``name`` (case, spaces and dashes
    ignored, aliases resolved); a ``-d``/``-d2`` suffix adds Grimme's D2
    with Fermi damping to the base functional. Raises ValueError for an
    unknown name."""
    key = name.strip().lower().replace("-", "").replace(" ", "")
    key = _ALIASES.get(key, key)
    if key in _REGISTRY:
        return _REGISTRY[key]
    for suf in ("d2", "d"):
        if key.endswith(suf):
            base_key = _ALIASES.get(key[:-len(suf)], key[:-len(suf)])
            if base_key in _REGISTRY:
                base = _REGISTRY[base_key]
                return dataclasses.replace(base, name=base.name + "-d2",
                                           dispersion="d2")
    raise ValueError(f"unknown XC functional {name!r}; "
                     f"available: {sorted(_REGISTRY)}")


def register_functional(func: XCFunctional):
    _REGISTRY[func.name] = func
