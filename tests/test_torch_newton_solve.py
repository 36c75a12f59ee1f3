"""The dense trainer's Newton solve (scasml_gp_torch.gp.solver
``spd_first_solve``) on the CPU.

A positive definite matrix is solved by Cholesky and agrees with pivoted LU
(``torch.linalg.solve_ex``) to float32 rounding; a matrix that is not falls
back to LU without pivoting of its Jacobi-scaled form (``nopivot_solve``),
whose answer is kept where the gate accepts it (getrf's info 0, finite, a
backward error of at most ``NOPIVOT_BACKWARD_ERROR``) and is close to
``solve_ex``'s; a matrix the gate rejects gets ``solve_ex``'s answer bit for
bit, in a batch only in its own slot.  ``GP.newton_solves``,
``GP.newton_lu_fallbacks`` and their split into ``newton_nopivot_solves`` and
``newton_pivoted_solves`` count what a train solved, and the parity modes
solve every step by pivoted LU, never by the Cholesky-first route.  A step's
gradient and Newton matrix (``_newton_system``) are the loss's own
derivatives.
"""

import pytest
import torch

import scasml_gp_torch as port
from scasml_gp_torch.gp import solver

torch.set_num_threads(2)

D, N_DOM, N_BDY, STEPS = 3, 40, 10, 3
D_PARITY = 5  # the least d with a frozen Laplacian subset (gp/parity.py)
n = 60


def _symmetric(eigenvalues, seed):
    gen = torch.Generator().manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((n, n), generator=gen))
    A = (q * eigenvalues) @ q.T
    return 0.5 * (A + A.T)


def _spd(seed):
    return _symmetric(torch.linspace(1.0, 10.0, n), seed)


def _indefinite(seed):
    ev = torch.linspace(1.0, 10.0, n)
    ev[n // 2] = -3.0
    return _symmetric(ev, seed)


def _rhs(seed, batch=()):
    return torch.randn(batch + (n, 1), generator=torch.Generator().manual_seed(seed))


def _backward_error(A, X, B):
    norm = torch.linalg.vector_norm
    return float(norm(A @ X - B) / (norm(A) * norm(X) + norm(B)))


def _held_to_the_gate(A, B, X, pivoted, rtol):
    """The fallback's contract for one matrix whose potrf failed: where
    ``nopivot_solve``'s gate accepts, X is its answer, within the gate's
    backward error and within ``rtol`` of ``solve_ex``'s (relative, in
    norm); where the gate rejects, X is ``solve_ex``'s bit for bit."""
    mine, ok = solver.nopivot_solve(A, B)
    gepp = torch.linalg.solve_ex(A, B)[0]
    assert pivoted == (not bool(ok))
    if pivoted:
        assert torch.equal(X, gepp)
    else:
        assert torch.equal(X, mine)
        assert _backward_error(A, X, B) <= solver.NOPIVOT_BACKWARD_ERROR
        assert float(torch.linalg.vector_norm(X - gepp) / torch.linalg.vector_norm(gepp)) < rtol


@pytest.mark.parametrize("case", ["spd", "indefinite", "batch_one_indefinite"])
def test_spd_first_solve_routes(case):
    if case == "spd":
        A, B = _spd(0), _rhs(1)
        X, n_lu, pivoted = solver.spd_first_solve(A, B)
        assert (n_lu, pivoted) == (0, 0)
        assert torch.equal(X, torch.cholesky_solve(B, torch.linalg.cholesky(A)))
        torch.testing.assert_close(X, torch.linalg.solve_ex(A, B)[0], rtol=1e-5, atol=1e-6)
    elif case == "indefinite":
        A, B = _indefinite(0), _rhs(1)
        assert int(torch.linalg.cholesky_ex(A)[1]) != 0
        X, n_lu, pivoted = solver.spd_first_solve(A, B)
        assert n_lu == 1
        _held_to_the_gate(A, B, X, pivoted, rtol=1e-4)
    else:
        A = torch.stack([_spd(0), _indefinite(1), _spd(2)])
        B = _rhs(3, (3,))
        X, n_lu, pivoted = solver.spd_first_solve(A, B)
        assert n_lu == 1
        for i in range(3):
            one, lu, piv = solver.spd_first_solve(A[i], B[i])
            assert (lu, piv) == (i == 1, pivoted if i == 1 else 0)
            assert torch.equal(X[i], one)
        _held_to_the_gate(A[1], B[1], X[1], pivoted, rtol=1e-4)
        assert torch.equal(X[0], torch.cholesky_solve(B[0], torch.linalg.cholesky(A[0])))


# six indefinite matrices whose eigenvalues lie in [1, 10] but one at -3:
# LU without pivoting meets small leading pivots on some of them, and the
# gate sends those to pivoted LU
@pytest.mark.parametrize("seed", range(6))
def test_nopivot_solve_on_indefinite_matrices_is_held_to_the_gate(seed):
    A, B = _indefinite(seed), _rhs(seed + 1)
    X, n_lu, pivoted = solver.spd_first_solve(A, B)
    assert n_lu == 1
    _held_to_the_gate(A, B, X, pivoted, rtol=1e-4)
    if seed in (0, 1):
        assert pivoted == 0


@pytest.mark.parametrize("pivot", ["zero", "tiny"])
def test_planted_breakdown_is_solved_by_pivoted_lu(pivot):
    """A leading pivot of 0, or scaled by 1e-12, breaks LU without
    pivoting (after Jacobi scaling that row and column are ~1e6 or more
    times the rest): the gate rejects it, and the answer is ``solve_ex``'s
    bit for bit, alone and in its slot of a batch."""
    A, B = _indefinite(0), _rhs(1)
    A[0, 0] = 0.0 if pivot == "zero" else A[0, 0] * 1e-12
    assert not bool(solver.nopivot_solve(A, B)[1])
    X, n_lu, pivoted = solver.spd_first_solve(A, B)
    assert (n_lu, pivoted) == (1, 1)
    assert torch.equal(X, torch.linalg.solve_ex(A, B)[0])

    As = torch.stack([_spd(2), A, _indefinite(1)])
    Bs = torch.stack([_rhs(3), B, _rhs(4)])
    X, n_lu, pivoted = solver.spd_first_solve(As, Bs)
    assert (n_lu, pivoted) == (2, 1)
    assert torch.equal(X[1], torch.linalg.solve_ex(A, B)[0])
    assert torch.equal(X[2], solver.nopivot_solve(As[2], Bs[2])[0])
    assert torch.equal(X[0], solver.spd_first_solve(As[0], Bs[0])[0])


def _problem(d):
    eq = port.GradDependentNonlinear(n_input=d + 1)
    return eq, eq.generate_data(N_DOM, N_BDY, torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def problem():
    return _problem(D)


def _large_start():
    """An initial point 3 000 times the default's scale, whose residual's
    second-order term makes some Newton matrices indefinite."""
    return 3.0 * torch.randn((3 * N_DOM,), generator=torch.Generator().manual_seed(1))


def _counters(gp):
    return (gp.newton_solves, gp.newton_lu_fallbacks, gp.newton_nopivot_solves,
            gp.newton_pivoted_solves)


def _batch_train(gp, x_dom, x_bdy, sol0=None, steps=STEPS):
    eq = gp.equation
    gamma = torch.tensor([gp.gamma, gp.gamma], dtype=torch.float32)
    return gp._train(x_dom, x_bdy, eq.g(x_bdy)[:, 0], gp.form.rhs_f(x_dom), gamma,
                     torch.tensor([gp.nugget, 10 * gp.nugget]), steps,
                     gp.config.damping, gp.config.grad_tol, sol0)


@pytest.mark.parametrize("start", ["default", "large", "batch", "batch_large"])
def test_train_counts_its_newton_solves(problem, start):
    eq, (x_dom, x_bdy) = problem
    gp = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=STEPS), device="cpu")
    assert _counters(gp) == (0, 0, 0, 0)
    sol0 = _large_start() if start.endswith("large") else None
    if start.startswith("batch"):
        out = _batch_train(gp, x_dom, x_bdy, sol0)
        assert out.sol.shape == (2, 3 * N_DOM)
        assert gp.newton_solves == 2 * STEPS
    else:
        gp.GPsolver(x_dom, x_bdy, sol0=sol0)
        assert gp.newton_solves == STEPS
        gp.GPsolver(x_dom, x_bdy, sol0=sol0)
        assert gp.newton_solves == 2 * STEPS
    assert 0 <= gp.newton_lu_fallbacks <= gp.newton_solves
    assert gp.newton_nopivot_solves + gp.newton_pivoted_solves == gp.newton_lu_fallbacks
    if sol0 is not None:
        assert gp.newton_lu_fallbacks > 0 and gp.newton_nopivot_solves > 0


def _newton_matrices(eq, x_dom, x_bdy, cfg, sol0):
    """Every (H, B) that the Newton steps of a train at ``cfg`` from
    ``sol0`` hand to the Cholesky-first solve."""
    seen = []
    gp = port.GPGradDependentNonlinear(eq, cfg, device="cpu")

    def solve(H, B):
        seen.append((H.clone(), B.clone()))
        return solver.spd_first_solve(H, B)[0]

    gp._newton_solve = solve
    gp.GPsolver(x_dom, x_bdy, sol0=sol0)
    return seen


def test_nopivot_solve_on_the_newton_matrices_of_a_ridge_300_kernel(problem):
    """The Newton matrices of a wide-ridge kernel (ridge 300, gamma 0.3, as
    the flagless tune's) that potrf refuses: symmetric indefinite, of the
    step's block structure.  The gate accepts every one, each within its
    backward error and close to ``solve_ex``'s answer."""
    eq, (x_dom, x_bdy) = problem
    cfg = port.GPConfig(ridge_scale=300.0, gamma_scale=0.3)
    refused = [(H, B) for H, B in _newton_matrices(eq, x_dom, x_bdy, cfg, _large_start())
               if int(torch.linalg.cholesky_ex(H)[1])]
    assert len(refused) >= 10
    for H, B in refused:
        X, n_lu, pivoted = solver.spd_first_solve(H, B)
        assert (n_lu, pivoted) == (1, 0)
        _held_to_the_gate(H, B, X, pivoted, rtol=5e-3)


def _pivoted_at_once(H, B):
    """The Newton solve of a gate that rejects every fallback: Cholesky,
    and ``solve_ex`` for each matrix potrf refused, its flags read at
    once."""
    L, info = solver.per_matrix(torch.linalg.cholesky_ex, H)
    X = solver.per_matrix(torch.cholesky_solve, B, L)
    for i, flag in enumerate(info.reshape(-1).tolist()):
        if flag and H.dim() == 2:
            X = torch.linalg.solve_ex(H, B)[0]
        elif flag:
            X[i] = torch.linalg.solve_ex(H[i], B[i])[0]
    return X


@pytest.mark.parametrize("start", ["large", "batch_large"])
def test_trains_whose_fallbacks_the_gate_rejects_are_pivoted_lu_trains(
        problem, monkeypatch, start):
    """With the gate shut, every fallback goes to ``solve_ex`` and the
    train, its flags read late or (a batch) at once, is bitwise the train
    of Cholesky with ``solve_ex`` fallbacks."""
    eq, (x_dom, x_bdy) = problem
    cfg = port.GPConfig(gn_steps=STEPS)
    gp, want_gp = (port.GPGradDependentNonlinear(eq, cfg, device="cpu") for _ in range(2))
    want_gp._newton_solve = _pivoted_at_once
    monkeypatch.setattr(solver, "NOPIVOT_BACKWARD_ERROR", -1.0)
    if start == "batch_large":
        got, want = (_batch_train(g, x_dom, x_bdy, _large_start()) for g in (gp, want_gp))
    else:
        for g in (gp, want_gp):
            g.GPsolver(x_dom, x_bdy, sol0=_large_start())
        got, want = gp.state, want_gp.state
    for name in ("sol", "right_vector", "loss_history"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert gp.newton_lu_fallbacks > 0
    assert (gp.newton_nopivot_solves, gp.newton_pivoted_solves) == (0, gp.newton_lu_fallbacks)


@pytest.mark.parametrize("mode", [dict(laplacian="subset"), dict(parity_fp16=True)],
                         ids=["subset", "fp16"])
def test_parity_train_solves_by_lu(monkeypatch, mode):
    eq, (x_dom, x_bdy) = _problem(D_PARITY)
    cfg = port.GPConfig(gn_steps=STEPS, **mode)

    def train():
        gp = port.GPGradDependentNonlinear(eq, cfg, device="cpu")
        gp.GPsolver(x_dom, x_bdy)
        return gp

    def refuse(*a):
        raise AssertionError("a parity train called the Cholesky-first or no-pivot solve")

    with monkeypatch.context() as m:
        m.setattr(solver, "spd_first_solve", refuse)
        m.setattr(solver, "nopivot_solve", refuse)
        gp = train()
    assert _counters(gp) == (0, 0, 0, 0)
    # every step's direction as the Newton step computed it before the
    # Cholesky-first solve: solve_ex, one call per matrix
    with monkeypatch.context() as m:
        m.setattr(solver, "_lu_solve", lambda H, B: solver.per_matrix(
            torch.linalg.solve_ex, H, B)[0])
        want = train()
    for name in ("sol", "right_vector", "loss_history"):
        assert torch.equal(getattr(gp.state, name), getattr(want.state, name)), name


# (start, potrf failures forced as (step, restart), steps redone): the
# Newton loop that reads each step's flags behind the next step's Hessian
# against the one that reads them at once.  The "large" start's failures
# are its own; the synchronous loop says at which steps.  A batch reads
# every step's flags at once, so it defers and redoes nothing.
LATE_STEPS = 4
DEFERRED_CASES = {
    "default": (None, (), 0),
    "large": ("large", (), None),
    "batch_one_restart_fails": ("batch", ((1, 1),), 0),
    "fails_at_step_0": (None, ((0, 0),), 1),
    "fails_twice_in_a_row": (None, ((1, 0), (2, 0)), 2),
    "fails_at_the_last_step": (None, ((LATE_STEPS - 1, 0),), 0),
}


@pytest.mark.parametrize("case", list(DEFERRED_CASES))
def test_deferred_flag_reads_train_as_the_synchronous_loop(problem, monkeypatch, case):
    from scasml_gp_torch.gp.gram import gram_matrix, regularized_factorization

    start, forced, redos = DEFERRED_CASES[case]
    eq, (x_dom, x_bdy) = problem
    cfg = port.GPConfig(gn_steps=LATE_STEPS)
    gp, sync_gp = (port.GPGradDependentNonlinear(eq, cfg, device="cpu") for _ in range(2))
    R = 2 if start == "batch" else 1
    gamma = torch.tensor([gp.gamma] * R, dtype=torch.float32)
    nugget = torch.tensor([gp.nugget, 10 * gp.nugget][:R])
    if R == 1:
        gamma, nugget = gamma[0], float(nugget[0])
    _, C = regularized_factorization(gram_matrix(x_dom, x_bdy, gamma, D), nugget)
    sol0 = None
    if start == "large":
        sol0 = _large_start()
    sol0 = gp._initial_point(N_DOM, x_dom.device, sol0)
    args = (C, eq.g(x_bdy)[:, 0], gp.form.rhs_f(x_dom), LATE_STEPS, cfg.damping,
            cfg.grad_tol, sol0)

    # potrf reports a failure on the chosen calls: one call per matrix, step
    # by step, in the same order on both routes
    fail_calls = {step * R + r for step, r in forced}
    cholesky_ex = torch.linalg.cholesky_ex

    def train(target, solve):
        calls = iter(range(10**6))

        def flagged(A):
            L, info = cholesky_ex(A)
            return L, (torch.ones_like(info) if next(calls) in fail_calls else info)

        with monkeypatch.context() as m:
            m.setattr(torch.linalg, "cholesky_ex", flagged)
            return target._newton_body(*args, solve)

    lu_steps = []  # matrices each step of the synchronous loop solved by LU

    def at_once(H, B):
        X, n_lu, _ = solver.spd_first_solve(H, B)
        lu_steps.append(n_lu)
        return X

    want = train(sync_gp, at_once)
    got = train(gp, gp._newton_solve)
    for name in ("sol", "right_vector", "loss_history", "grad_norm"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name

    assert len(lu_steps) == LATE_STEPS
    if forced:
        assert lu_steps == [sum(s == step for s, _ in forced) for step in range(LATE_STEPS)]
    if redos is None:
        redos = sum(1 for n_lu in lu_steps[:-1] if n_lu)
        assert redos > 0
    assert gp.newton_solves == R * LATE_STEPS
    assert gp.newton_lu_fallbacks == sum(lu_steps)
    assert gp.newton_nopivot_solves + gp.newton_pivoted_solves == gp.newton_lu_fallbacks
    assert gp.newton_deferred_reads == (LATE_STEPS - 1 if R == 1 else 0)
    assert gp.newton_redos == redos
    assert (sync_gp.newton_solves, sync_gp.newton_lu_fallbacks,
            sync_gp.newton_deferred_reads, sync_gp.newton_redos) == (0, 0, 0, 0)


@pytest.mark.parametrize("mode", [dict(laplacian="subset"), dict(parity_fp16=True)],
                         ids=["subset", "fp16"])
def test_parity_train_reads_no_flags_late(mode):
    eq, (x_dom, x_bdy) = _problem(D_PARITY)
    gp = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=STEPS, **mode), device="cpu")
    gp.GPsolver(x_dom, x_bdy)
    assert (gp.newton_deferred_reads, gp.newton_redos) == (0, 0)


# the three forms' F, dF and d2F_contraction against autograd, in float64
FORMS = {
    "grad_dependent": (solver.GradDependentForm, port.GradDependentNonlinear),
    "allen_cahn": (solver.AllenCahnForm, port.AllenCahn),
    "sine": (solver.SineForm, port.SineNonlinear),
}


@pytest.mark.parametrize("R", [None, 2], ids=["single", "batch"])
@pytest.mark.parametrize("family", list(FORMS))
def test_newton_system_is_the_loss_gradient_and_hessian(family, R):
    form_cls, eq_cls = FORMS[family]
    form = form_cls(eq_cls(n_input=D + 1))
    N, Nb = 12, 4
    phi = 4 * N + Nb
    gen = torch.Generator().manual_seed(0)
    batch = () if R is None else (R,)
    A = torch.randn(batch + (phi, phi), generator=gen, dtype=torch.float64)
    C = A @ A.mT / phi + torch.eye(phi, dtype=torch.float64)
    sol = torch.randn(batch + (3 * N,), generator=gen, dtype=torch.float64)
    bdy_g = torch.randn((Nb,), generator=gen, dtype=torch.float64)
    rhs = torch.randn((N,), generator=gen, dtype=torch.float64)

    def b_of(s):
        z1, z3, z5 = s[:N], s[N:2 * N], s[2 * N:]
        return torch.cat([z1, bdy_g, z3, form.F(z1, z3, z5, rhs), z5])

    Cb = torch.stack([C_r @ b_of(s) for C_r, s in zip(C.reshape(-1, phi, phi),
                                                      sol.reshape(-1, 3 * N))])
    grad, H = solver._newton_system(form, solver._unknowns_rows(C, N, Nb), sol,
                                    Cb.reshape(batch + (phi,)))
    assert grad.shape == batch + (3 * N,) and H.shape == batch + (3 * N, 3 * N)
    for r, (C_r, s) in enumerate(zip(C.reshape(-1, phi, phi), sol.reshape(-1, 3 * N))):
        def loss(x):
            b = b_of(x)
            return b @ C_r @ b

        want_grad = torch.autograd.functional.jacobian(loss, s)
        want_H = torch.autograd.functional.hessian(loss, s)
        torch.testing.assert_close(grad.reshape(-1, 3 * N)[r], want_grad, rtol=1e-10, atol=1e-12)
        torch.testing.assert_close(H.reshape(-1, 3 * N, 3 * N)[r], want_H, rtol=1e-10, atol=1e-12)
