"""Host-side static schedules for the multilevel Picard recursion.

Port of ``scasml_gp_tpu/picard/schedule.py`` (its Python path; the JAX
package's optional C++ builder is not carried over).  Tables are float64
numpy, built once per (rho, T): the recursion tree of a given (n, rho) is
static.  Also the analytic evaluation counters of the reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
from scipy.special import lambertw


def inverse_gamma(x: np.ndarray) -> np.ndarray:
    """Approximate inverse of the Gamma function."""
    c = 0.036534
    L = np.log((np.asarray(x, np.float64) + c) / np.sqrt(2 * np.pi))
    return np.real(L / np.real(lambertw(L / np.e)) + 0.5)


def leggauss(npts: int, a: float, b: float):
    """Gauss-Legendre nodes (ascending) and weights on [a, b]."""
    y, w = np.polynomial.legendre.leggauss(npts)
    x = 0.5 * (b - a) * y + 0.5 * (b + a)
    return x, 0.5 * (b - a) * w


class PicardTables(NamedTuple):
    """Static level tables for the quadrature variant."""

    Mf: np.ndarray   # (rhomax, rhomax) int: MC counts for interior f terms
    Mg: np.ndarray   # (rhomax, rhomax+1) int: MC counts for terminal g terms
    Q: np.ndarray    # (rhomax, rhomax) int: quadrature point counts
    c: np.ndarray    # (qmax, qmax) float64: nodes on [0, T], column k-1 has k
    w: np.ndarray    # (qmax, qmax) float64: weights


@functools.lru_cache(maxsize=None)
def approx_parameters(rhomax: int, T: float) -> PicardTables:
    rhomax = int(rhomax)
    Q = np.zeros((rhomax, rhomax), dtype=np.int64)
    Mf = np.zeros((rhomax, rhomax), dtype=np.int64)
    Mg = np.zeros((rhomax, rhomax + 1), dtype=np.int64)
    for rho in range(1, rhomax + 1):
        for k in range(1, rho + 1):
            Q[rho - 1, k - 1] = int(np.round(inverse_gamma(rho ** (k / 2.0))))
            Mf[rho - 1, k - 1] = int(np.round(rho ** (k / 2.0)))
            Mg[rho - 1, k - 1] = int(np.round(float(rho ** (k - 1))))
        Mg[rho - 1, rho] = rho**rho
    qmax = max(int(Q.max()) if Q.size else 0, 1)
    c = np.zeros((qmax, qmax))
    w = np.zeros((qmax, qmax))
    for k in range(1, qmax + 1):
        ck, wk = leggauss(k, 0.0, T)
        c[:k, k - 1] = ck
        w[:k, k - 1] = wk
    return PicardTables(Mf=Mf, Mg=Mg, Q=Q, c=c, w=w)


@functools.lru_cache(maxsize=None)
def count_evaluations_quadrature(n: int, rho: int, T: float,
                                 count_fg: bool = False) -> int:
    """Per-call evaluation count of the quadrature recursion (+= MC_g per
    call, += MC_f per f evaluation; with ``count_fg`` +1 per f/g call)."""
    tables = approx_parameters(rho, T)
    Mf, Mg, Q = tables.Mf, tables.Mg, tables.Q

    @functools.lru_cache(maxsize=None)
    def rec(lvl: int) -> int:
        total = int(Mg[rho - 1, lvl]) + (1 if count_fg else 0)
        if lvl == 0:
            return total
        for l in range(lvl):
            q = int(Q[rho - 1, lvl - l - 1])
            mf = int(Mf[rho - 1, lvl - l - 1])
            for _ in range(q):
                total += rec(l) + mf + (1 if count_fg else 0)
                if l:
                    total += rec(l - 1) + mf + (1 if count_fg else 0)
        return total

    return rec(n)


@functools.lru_cache(maxsize=None)
def count_evaluations_full_history(n: int, M: int, scasml_variant: bool = False,
                                   count_fg: bool = False) -> int:
    """Per-call evaluation count of the full-history recursion (the ScaSML
    variant increments MC_g in the loop instead of MC_f)."""

    @functools.lru_cache(maxsize=None)
    def rec(lvl: int) -> int:
        mc_g = M**lvl
        total = mc_g + (1 if count_fg else 0)
        if lvl == 0:
            return total
        for l in range(lvl):
            inc = mc_g if scasml_variant else M ** (lvl - l)
            total += rec(l) + inc + (1 if count_fg else 0)
            if l:
                total += rec(l - 1) + inc + (1 if count_fg else 0)
        return total

    return rec(n)
