"""Boys function F_m(T), the scalar core of all Coulomb-type integrals.

F_m(T) = int_0^1 t^{2m} exp(-T t^2) dt.

Branchless evaluation over three regimes blended with ``torch.where`` (all
paths evaluated; each is made NaN-safe, also under autograd):

 - small T:  Taylor series  F_m(T) = sum_k (-T)^k / (k! (2m+2k+1))
 - mid T:    tabulated Taylor expansion around grid nodes T_i = i*h:
             F_m(T) = sum_k F_{m+k}(T_i) (-(T-T_i))^k / k!   (8 terms,
             h = 0.05 -> |T-T_i| <= 0.025, error < 1e-16). The table is
             built once on the host with scipy's incomplete gamma and then
             moved to the device.
 - large T:  asymptotic      F_m(T) = (2m-1)!! / 2^{m+1} * sqrt(pi / T^{2m+1}),
             evaluated in log space so that T^{2m+1} never overflows (the
             f32 mode) and its derivative stays finite.

then a single *downward* recursion (stable for all T)
 F_{m-1}(T) = (2 T F_m(T) + exp(-T)) / (2m - 1)
fills every lower order. Same formulation as ``cctpu/ints/boys.py``.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

_TAB_H = 0.05          # node spacing; Taylor radius h/2
_TAB_K = 7             # Taylor order (terms k = 0..7)
_T_SMALL = 1e-1
# The asymptotic form drops the int_1^inf tail, of relative size
# ~ T^{m+1/2} e^{-T} / Gamma(m+1/2): < 1e-30 at T = 130 even for m = 20.
_T_LARGE = 130.0


@lru_cache(maxsize=None)
def _boys_table_np(mtop: int, h: float = _TAB_H, tmax: float = 130.0):
    """Host table F_m(T_i) for m = 0..mtop, T_i = 0, h, 2h, ... tmax,
    from scipy's regularized incomplete gamma; numpy [mtop+1, ntab]."""
    from scipy.special import gammainc

    T = np.arange(0.0, tmax + 2 * h, h)
    out = np.empty((mtop + 1, len(T)))
    Tm = np.where(T > 0, T, 1.0)
    for m in range(mtop + 1):
        a = m + 0.5
        out[m] = math.gamma(a) * gammainc(a, Tm) / (2.0 * Tm ** a)
        out[m, T == 0.0] = 1.0 / (2 * m + 1)
    return out


_TABLES = {}


def _boys_table(mtop: int, device, dtype) -> torch.Tensor:
    key = (mtop, str(device), dtype)
    tab = _TABLES.get(key)
    if tab is None:
        tab = torch.as_tensor(_boys_table_np(mtop), dtype=dtype,
                              device=device)
        _TABLES[key] = tab
    return tab


def _double_factorial(n: int) -> float:
    out = 1.0
    while n > 1:
        out *= n
        n -= 2
    return out


def boys(T: torch.Tensor, mmax: int) -> torch.Tensor:
    """F_m(T) for m = 0..mmax. T: any shape; returns (mmax+1,) + T.shape."""
    m = mmax
    in_small = T < _T_SMALL
    in_large = T > _T_LARGE
    # Double-where: every branch sees a safe argument so that autograd of
    # the *unselected* branch cannot produce NaN/Inf.
    zero = torch.zeros_like(T)
    one = torch.ones_like(T)
    T_ser = torch.where(in_small, T, zero)
    T_gam = torch.where(in_small | in_large, one, T)
    T_asy = torch.where(in_large, T, torch.full_like(T, 2.0 * _T_LARGE))

    # Series branch (exact near 0). 12 terms: error < T^12/12! ~ 1e-20.
    acc = torch.zeros_like(T)
    term = torch.ones_like(T)
    for k in range(12):
        acc = acc + term / (2 * m + 2 * k + 1)
        term = term * (-T_ser) / (k + 1)
    f_series = acc

    # Mid branch: tabulated Taylor expansion, Horner form from the top.
    tab = _boys_table(m + _TAB_K, T.device, T.dtype)
    idx = torch.clamp(torch.round(T_gam / _TAB_H).long(), 0,
                      tab.shape[1] - 1)
    dT = T_gam - idx.to(T.dtype) * _TAB_H
    f_gamma = tab[m + _TAB_K][idx]
    for k in range(_TAB_K - 1, -1, -1):
        f_gamma = tab[m + k][idx] - f_gamma * dT / (k + 1)

    # Asymptotic branch in log space (finite value and derivative for all
    # T: exp(-(m+1/2) log T) underflows to 0 harmlessly).
    f_asym = (_double_factorial(2 * m - 1) / (2.0 ** (m + 1))
              * math.sqrt(math.pi)
              * torch.exp(-(m + 0.5) * torch.log(T_asy)))

    f_m = torch.where(in_small, f_series,
                      torch.where(in_large, f_asym, f_gamma))

    out = [f_m]
    expT = torch.exp(-T)
    for mm in range(m, 0, -1):
        f_m = (2.0 * T * f_m + expT) / (2 * mm - 1)
        out.append(f_m)
    return torch.stack(out[::-1], dim=0)
