"""Metric definitions shared by the harnesses (a copy of
``scasml_gp_tpu/harness/metrics.py`` on numpy and scipy).

NaN-mask the union of all solver outputs, then absolute errors, squared
errors, relative L2 = ||err||_2 / ||exact||_2, and paired t-tests.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
from scipy import stats


def mc_reference_solution(equation, x_t, n: int = 3, M: int = 8, seed: int = 123):
    """High-accuracy multilevel-Picard reference for PDEs without a closed
    form: a deep full-history run, on the device of ``x_t``, whose own error
    is far below the solvers under test."""
    from scasml_gp_torch.picard.mlp import MLPFullHistory

    solver = MLPFullHistory(equation, batch_chunk=256, device=x_t.device,
                            seed=seed)
    u = solver.u_solve(n, None, x_t, M=M)
    return u.detach().cpu().numpy().astype(np.float64)


def valid_mask(*solutions: np.ndarray) -> np.ndarray:
    """Mask of rows where every solution is finite
    (reference tests/SimpleUniform.py:109-113)."""
    mask = np.ones(solutions[0].reshape(-1).shape, dtype=bool)
    for sol in solutions:
        mask &= np.isfinite(np.asarray(sol, np.float64).reshape(-1))
    if not mask.any():
        raise ValueError("All predictions are NaN; cannot evaluate metrics.")
    return mask


def error_metrics(sol: np.ndarray, exact: np.ndarray) -> Dict[str, float]:
    """L1 / L2 / relative-L2 errors (reference tests/SimpleUniform.py:121-141)."""
    sol = np.asarray(sol, np.float64).reshape(-1)
    exact = np.asarray(exact, np.float64).reshape(-1)
    diff = sol - exact
    return {
        "L1": float(np.mean(np.abs(diff))),
        "L2": float(np.linalg.norm(diff) / np.sqrt(diff.shape[0])),
        "rel_L2": float(np.linalg.norm(diff) / np.linalg.norm(exact)),
    }


def paired_t_tests(
    errors: Dict[str, np.ndarray], pairs: Sequence = (("GP", "SCaSML"), ("MLP", "SCaSML"))
) -> Dict[str, Dict[str, float]]:
    """Paired t-tests on absolute errors (reference tests/SimpleUniform.py:441-449)."""
    out = {}
    for a, b in pairs:
        t, p = stats.ttest_rel(np.abs(errors[a]), np.abs(errors[b]))
        out[f"{a}_vs_{b}"] = {"t": float(t), "p": float(p)}
    return out


def summarize(
    solutions: Dict[str, np.ndarray], exact: np.ndarray
) -> Dict[str, object]:
    """Full metric block for one run over one test set."""
    mask = valid_mask(exact, *solutions.values())
    exact_v = np.asarray(exact, np.float64).reshape(-1)[mask]
    errors = {}
    metrics = {}
    for name, sol in solutions.items():
        sol_v = np.asarray(sol, np.float64).reshape(-1)[mask]
        errors[name] = sol_v - exact_v
        metrics[name] = error_metrics(sol_v, exact_v)
    return {
        "metrics": metrics,
        "t_tests": paired_t_tests(
            errors,
            pairs=[
                (a, b)
                for a in solutions
                for b in solutions
                if a != b and b == list(solutions)[-1]
            ],
        ),
        "real_sol_L2": float(
            np.linalg.norm(exact_v) / np.sqrt(exact_v.shape[0])
        ),
        "valid_count": int(mask.sum()),
        "mask": mask,
        "errors": errors,
    }
