"""Frozen yardsticks: the chip's peaks and the work a request or a train
needs.

Everything here is counted from the algorithm's shapes, never from what the
program launches, so a later change to the program cannot move it.

- ``pair_flops`` and ``bound`` are copies of ``scasml_gp_torch/measure.py``
  (the posterior's operations per (x, y) pair in the norm form, and the
  least time one posterior call can take on an H100);
- ``quadrature_tables`` is the quadrature recursion's static schedule
  (``picard/schedule.py approx_parameters``: the reference's
  ``approx_parameters``);
- ``posterior_rows`` counts the posterior rows of each kind that the
  ScaSML recursion evaluates for a batch of rows;
- ``train_flops`` counts the least float32 operations of one dense GP train.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np

# NVIDIA H100 SXM, dense, at the 700 W power limit (NVIDIA's data sheet)
FP32_PEAK = 67e12    # float32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12   # device memory, bytes/s

# the posterior kinds: (want_grad, want_ops)
KINDS = {"u": (False, False), "grad": (True, False), "ops": (False, True)}


def pair_flops(F: int, want_grad: bool, want_ops: bool) -> int:
    """Float32 operations per (x, y) pair of the posterior at width F = d + 1,
    in the norm form (an FMA as 2, an exp as 1): x.y and kappa with the mean
    polynomial 2F + 25; the gradient 20 + 2F more (A_sp . Y and A_t . y_t);
    dt/div/lap 52 more."""
    return (2 * F + 25 + (20 + 2 * F if want_grad else 0)
            + (52 if want_ops else 0))


def bound(n: int, m: int, F: int, want_grad: bool, want_ops: bool) -> Tuple[float, str]:
    """(ms, 'operations' or 'bytes'): the least time an H100 could take for
    one posterior call of n rows against m training rows, the larger of its
    operations over the float32 peak and its bytes (x, the training rows and
    their four weights read once, the outputs written once) over the memory
    rate."""
    ops_ms = n * m * pair_flops(F, want_grad, want_ops) / FP32_PEAK * 1e3
    outs = 1 + (F if want_grad else 0) + (3 if want_ops else 0)
    nbytes = 4 * (n * F + m * (F + 4) + n * outs)
    bytes_ms = nbytes / HBM_RATE * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _inverse_gamma(x: float) -> float:
    """Approximate inverse of the Gamma function."""
    from scipy.special import lambertw

    c = 0.036534
    L = np.log((float(x) + c) / np.sqrt(2 * np.pi))
    return float(np.real(L / np.real(lambertw(L / np.e)) + 0.5))


@functools.lru_cache(maxsize=None)
def quadrature_tables(rhomax: int, T: float):
    """(Mf, Mg, Q, nodes, weights): MC counts of the interior f terms
    (rhomax, rhomax) and of the terminal terms (rhomax, rhomax + 1), the
    quadrature point counts (rhomax, rhomax), and per point count q the
    Gauss-Legendre nodes and weights on [0, T] (a dict q -> (q,), (q,))."""
    Q = np.zeros((rhomax, rhomax), dtype=np.int64)
    Mf = np.zeros((rhomax, rhomax), dtype=np.int64)
    Mg = np.zeros((rhomax, rhomax + 1), dtype=np.int64)
    for rho in range(1, rhomax + 1):
        for k in range(1, rho + 1):
            Q[rho - 1, k - 1] = int(np.round(_inverse_gamma(rho ** (k / 2.0))))
            Mf[rho - 1, k - 1] = int(np.round(rho ** (k / 2.0)))
            Mg[rho - 1, k - 1] = int(np.round(float(rho ** (k - 1))))
        Mg[rho - 1, rho] = rho**rho
    rules = {}
    for q in range(1, max(int(Q.max()), 1) + 1):
        y, w = np.polynomial.legendre.leggauss(q)
        rules[q] = (0.5 * T * y + 0.5 * T, 0.5 * T * w)
    return Mf, Mg, Q, rules


def posterior_rows(solver: str, n: int, rows: int, rho: int = 2, M: int = 3,
                   T: float = 0.5) -> Dict[str, int]:
    """Posterior rows of each kind ('u', 'grad', 'ops') that one ScaSML
    u_solve of depth ``n`` evaluates for ``rows`` rows: the terminal passes
    (u), the f terms (u and gradient), the leaf residuals (u and dt, div,
    lap), and the surrogate's own value at the rows (u).  f at the level-0
    estimate is zero and is not evaluated."""
    count = {"u": rows, "grad": 0, "ops": 0}   # u_hat at the rows

    def quad(lvl: int, B: int):
        if lvl <= 0:
            return
        Mf, Mg, Q, _ = quadrature_tables(rho, T)
        count["u"] += B * int(Mg[rho - 1, lvl])
        for l in range(lvl):
            q, mf = int(Q[rho - 1, lvl - l - 1]), int(Mf[rho - 1, lvl - l - 1])
            for _ in range(q):
                if l > 0:
                    quad(l, B * mf)
                    count["grad"] += B * mf
                if l:
                    if l - 1 > 0:
                        quad(l - 1, B * mf)
                        count["grad"] += B * mf
                else:
                    count["ops"] += B * mf

    def full_history(lvl: int, B: int):
        if lvl <= 0:
            return
        count["u"] += B * M**lvl
        for l in range(lvl):
            mf = M ** (lvl - l)
            if l > 0:
                full_history(l, B * mf)
                count["grad"] += B * mf
            if l:
                if l - 1 > 0:
                    full_history(l - 1, B * mf)
                    count["grad"] += B * mf
            else:
                count["ops"] += B * mf

    if solver == "quadrature":
        quad(n, rows)
    elif solver == "full_history":
        full_history(n, rows)
    elif solver != "predict":
        raise ValueError(f"unknown solver {solver!r}")
    return count


def request_work(solver: str, rows: int, F: int, m: int, **schedule) -> Tuple[float, float]:
    """(FLOPs, bound seconds) of the posterior work of one request of
    ``rows`` real rows against ``m`` training rows: ``posterior_rows`` of
    each kind at ``pair_flops``, and the sum of each kind's ``bound``."""
    flops = bound_s = 0.0
    for kind, n_rows in posterior_rows(solver, rows=rows, **schedule).items():
        if n_rows:
            g, o = KINDS[kind]
            flops += n_rows * m * pair_flops(F, g, o)
            bound_s += bound(n_rows, m, F, g, o)[0] / 1e3
    return flops, bound_s


def train_flops(N: int, Nb: int, F: int, steps: int) -> float:
    """The least float32 operations of one dense GP train on N interior and
    Nb boundary rows at width F with ``steps`` Newton steps:

    - the Gram's pair products, 2 F (N + Nb)^2;
    - (K + nugget I)^{-1} of the phi x phi Gram, phi = 4N + Nb: a Cholesky
      factorization, phi^3 / 3, and the inverse from it, 2 phi^3 / 3;
    - per Newton step, the LU solve of the 3N x 3N Newton matrix,
      2 (3N)^3 / 3, and the products of C with b and with the 8 line-search
      candidates, 9 x 2 phi^2.

    The elementwise work (kernel values, the Hessian's blocks) is left out."""
    phi, n3 = 4 * N + Nb, 3 * N
    gram = 2.0 * F * (N + Nb) ** 2
    inverse = phi**3 / 3.0 + 2.0 * phi**3 / 3.0
    newton = steps * (2.0 * n3**3 / 3.0 + 9 * 2.0 * phi**2)
    return gram + inverse + newton


def served_work(config: dict, endpoint: str, rows) -> Tuple[float, float]:
    """(FLOPs, bound seconds) of the posterior work of requests of ``rows``
    real rows each, to /solve (the configuration's solver) or /predict,
    against the configuration's N + Nb training rows."""
    solver = config["solver"] if endpoint == "solve" else "predict"
    m = int(config["num_domain"]) + int(config["num_boundary"])
    flops = bound_s = 0.0
    for r in rows:
        f, b = request_work(solver, int(r), int(config["dim"]) + 1, m, n=int(config["n"]),
                            rho=int(config.get("rho") or 2), M=int(config.get("M") or 3))
        flops, bound_s = flops + f, bound_s + b
    return flops, bound_s
