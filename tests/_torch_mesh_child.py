"""One rank of a gloo CPU world for tests/test_torch_mesh.py.

    python tests/_torch_mesh_child.py RANK WORLD PORT OUTDIR

Joins a world of WORLD processes through
``scasml_gp_torch.parallel.mesh.initialize_distributed`` and runs that
world's checks in order, every rank issuing the same collectives.  Each
check holds a sharded run against the same run without a mesh, computed in
this process: the 'data' axis at rtol 1e-4, atol 1e-5 (the rollouts are the
same numbers, gathered), the 'model' axis at rtol 2e-3, atol 2e-4 (partial
sums added in another order; tests/test_precision.py's bar).  After each
check it prints ``CHECK <name> OK``; any failure prints its traceback and
exits non-zero.  Imports neither JAX nor the JAX package.
"""

import os
import sys
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import scasml_gp_torch as port  # noqa: E402
from scasml_gp_torch.gp.gram import gram_matrix, sharded_gram_matrix  # noqa: E402
from scasml_gp_torch.gp.posterior import posterior_eval  # noqa: E402
from scasml_gp_torch.parallel import mesh as pm  # noqa: E402
from scasml_gp_torch.parallel.sharded import (  # noqa: E402
    make_sharded_picard_solve,
    make_sharded_train_and_solve,
)

D = 4
N_DOM, N_BDY, B = 48, 12, 48
DATA = dict(rtol=1e-4, atol=1e-5)
MODEL = dict(rtol=2e-3, atol=2e-4)


def close(a, b, tol, what):
    torch.testing.assert_close(a, b, **tol, msg=lambda m: f"{what}: {m}")


def problem():
    eq = port.GradDependentNonlinear(n_input=D + 1)
    x_dom, x_bdy = eq.generate_data(N_DOM, N_BDY, torch.Generator().manual_seed(0))
    x_test = eq.geometry().sample_domain(torch.Generator().manual_seed(1), B)
    return eq, x_dom, x_bdy, x_test


def trained(eq, x_dom, x_bdy, mesh=None, **cfg):
    gp = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=8, **cfg),
                                       device="cpu", mesh=mesh)
    gp.GPsolver(x_dom, x_bdy)
    return gp


def check_mesh_shapes(world, rank, out):
    for (d, m), shape in (((world, 1), (world, 1)), ((1, world), (1, world)),
                          ((-1, 1), (world, 1)), ((-1, world), (1, world))):
        mesh = pm.make_mesh(d, m)
        assert (mesh.shape["data"], mesh.shape["model"]) == shape, (d, m, mesh.shape)
        assert (mesh.data_index, mesh.model_index) == divmod(rank, mesh.model)
    for args, msg in (((world + 2, 1), f"needs {world + 2} > {world} devices"),
                      ((-1, world + 1), f"{world} devices not divisible by model={world + 1}"),
                      ((1, 1), "leaves")):
        try:
            pm.make_mesh(*args)
        except ValueError as e:
            assert msg in str(e), (args, str(e))
        else:
            raise AssertionError(f"make_mesh{args} did not raise")
    mesh = pm.make_mesh(world, 1)
    x = torch.arange(8.0 * world).reshape(4 * world, 2)
    assert torch.equal(pm.shard_batch(x, mesh), x[4 * rank:4 * rank + 4])
    assert pm.batch_sharding(mesh, 4 * world + 1) == (0, 4 * world + 1)  # replicated
    padded, n = pm.pad_to_multiple(x[:5], world)
    assert n == 5 and padded.shape[0] % world == 0 and torch.equal(padded[:5], x[:5])
    got = pm.all_gather_rows(pm.shard_batch(x, mesh), mesh.data_group, [4] * world)
    assert torch.equal(got, x)


def check_data_solve(world, rank, out):
    """Every solver's u_solve on a ('data' = world) mesh against the same
    solve without a mesh at the same seed: MLP and ScaSML, both variants,
    the variance guard's probes and ladder (its lambda is the whole batch's),
    batch chunks, and make_sharded_picard_solve."""
    eq, x_dom, x_bdy, x_test = problem()
    gp = trained(eq, x_dom, x_bdy)
    mesh = pm.make_mesh(world, 1)
    cases = [
        ("MLPFullHistory", lambda m: port.MLPFullHistory(eq, device="cpu", seed=3, mesh=m),
         dict(M=3)),
        ("MLP", lambda m: port.MLP(eq, device="cpu", seed=3, mesh=m), {}),
        ("ScaSMLFullHistory+guard", lambda m: port.ScaSMLFullHistory(
            eq, gp, seed=3, mesh=m, variance_guard=True), dict(M=4)),
        ("ScaSML+guard", lambda m: port.ScaSML(eq, gp, seed=3, mesh=m,
                                                variance_guard=True), {}),
        ("ScaSMLFullHistory+chunks", lambda m: port.ScaSMLFullHistory(
            eq, gp, seed=3, mesh=m, batch_chunk=16), dict(M=3)),
    ]
    for name, make, kw in cases:
        single, sharded = make(None), make(mesh)
        for _ in range(2):  # the second solve continues each generator
            want = single.u_solve(2, 2, x_test, **kw)
            got = sharded.u_solve(2, 2, x_test, **kw)
            close(got, want, DATA, name)
        if "guard" in name:
            assert got.shape == (B, 1)
            assert abs(sharded.last_lambda - single.last_lambda) <= 1e-4, name
    solver = port.MLPFullHistory(eq, device="cpu")
    fn = solver._build((2, 3))
    want = fn(x_test, torch.Generator().manual_seed(7), None)
    got = make_sharded_picard_solve(fn, mesh)(x_test, torch.Generator().manual_seed(7), None)
    close(got, want, DATA, "make_sharded_picard_solve")


def check_model_posterior(world, rank, out):
    """posterior_eval with shard_dom (float32 and bf16, every
    specialisation) and a GP on a ('model' = world) mesh against the
    unsharded posterior."""
    eq, x_dom, x_bdy, x_test = problem()
    gp = trained(eq, x_dom, x_bdy)
    st = gp.state
    mesh = pm.make_mesh(1, world)
    for od in ("float32", "bfloat16"):
        for flags in ((False, False), (True, False), (False, True), (True, True)):
            args = (x_test, st.x_dom, st.x_bdy, st.right_vector, st.gamma, D) + flags
            want = posterior_eval(*args, operand_dtype=od)
            got = posterior_eval(*args, operand_dtype=od, shard_dom=mesh, chunk=20)
            got2 = posterior_eval(*args, operand_dtype=od, shard_dom=mesh,
                                  fused=st.fused_inputs(od, mesh))
            for name, a, a2, b in zip(want._fields, got, got2, want):
                if b is not None:
                    close(a, b, MODEL, f"{od} {flags} {name}")
                    close(a2, b, MODEL, f"{od} {flags} {name} (cached)")
    lo, hi = pm.train_point_sharding(mesh, N_DOM + N_BDY)
    assert st.fused_inputs("float32", mesh).y.shape[0] == hi - lo
    gp_m = port.GPGradDependentNonlinear(eq, gp.config, device="cpu", mesh=mesh)
    gp_m.state = st
    for what in ("predict", "compute_gradient", "compute_PDE_loss"):
        close(getattr(gp_m, what)(x_test), getattr(gp, what)(x_test), MODEL, what)


def check_model_dense_train(world, rank, out):
    """The dense train with the Gram's rows over 'model' against the
    unsharded train: the gathered Gram is gram_matrix's bit for bit (float32
    and bf16 operands), so the trained state is too; the predictions split
    the training rows and meet the model bar."""
    eq, x_dom, x_bdy, x_test = problem()
    mesh = pm.make_mesh(1, world)
    gamma = torch.tensor((0.3, 0.3, 0.01))
    for od in (torch.float32, torch.bfloat16):
        assert torch.equal(sharded_gram_matrix(x_dom, x_bdy, gamma, D, mesh, od),
                           gram_matrix(x_dom, x_bdy, gamma, D, od)), od
    gp1 = trained(eq, x_dom, x_bdy)
    gpm = trained(eq, x_dom, x_bdy, mesh=mesh)
    assert torch.equal(gpm.state.right_vector, gp1.state.right_vector)
    close(gpm.predict(x_test), gp1.predict(x_test), MODEL, "predict")


def check_model_dual_cg(world, rank, out):
    """The dual-CG trainer with K row-sharded over 'model' against the
    trainer with K whole: the same CG iterations (every rank takes the same
    stop decisions) and the same fixed point."""
    from scasml_gp_torch.gp.distributed import distributed_gpsolver

    eq, x_dom, x_bdy, x_test = problem()
    mesh = pm.make_mesh(1, world)
    outs, preds = {}, {}
    for key, m in (("whole", None), ("sharded", mesh)):
        gp = port.GPGradDependentNonlinear(eq, port.GPConfig(), device="cpu")
        outs[key] = distributed_gpsolver(gp, x_dom, x_bdy, m, gn_steps=8)
        preds[key] = gp.predict(x_test)
    close(outs["sharded"].loss_history, outs["whole"].loss_history, MODEL, "loss")
    close(preds["sharded"], preds["whole"], MODEL, "predict")
    assert float(outs["sharded"].final_residual) < 1e-3
    it = outs["sharded"].cg_iterations
    gathered = pm.all_gather_rows(it[None, :], pm.make_mesh(1, world).model_group,
                                  [1] * world)
    assert bool((gathered == it).all()), gathered
    gp = port.GPGradDependentNonlinear(eq, port.GPConfig(train_backend="distributed",
                                                         dist_gn_steps=8),
                                       device="cpu", mesh=mesh)
    gp.GPsolver(x_dom, x_bdy)
    close(gp.predict(x_test), preds["whole"], MODEL, "GP._gpsolver_distributed")


def _metrics(path):
    import json

    with open(path) as fh:
        return json.load(fh)


def check_runner(world, rank, out):
    """runner.main with --mesh-data and with --mesh-model against the same
    run without a mesh (each rank's own, into its own directory); rank 0
    alone writes the mesh run's files."""
    from scasml_gp_torch.harness import runner

    def argv(save, *extra):
        return ["--dim", "3", "--num-domain", "40", "--num-boundary", "10",
                "--test-domain", "40", "--test-boundary", "8", "--device", "cpu",
                "--no-tune", "--no-plots", "--variant", "full_history", "--M", "2",
                "--save-path", os.path.join(out, save), *extra]

    single = runner.main(argv(f"single{rank}"))
    for flag, tol in (("--mesh-data", DATA), ("--mesh-model", MODEL)):
        res = runner.main(argv(flag[2:], flag, str(world)))
        for k in ("GP", "MLP", "SCaSML"):
            np.testing.assert_allclose(res["metrics"][k]["rel_L2"],
                                       single["metrics"][k]["rel_L2"], **tol,
                                       err_msg=f"{flag} {k}")
        path = os.path.join(out, flag[2:], "GradDependentNonlinear", "3d", "full_history",
                            "SimpleUniform", "metrics.json")
        torch.distributed.barrier()
        assert os.path.exists(path), path
        if rank == 0:
            assert _metrics(path)["metrics"] == res["metrics"]


def check_serve(world, rank, out):
    """load_surrogate(mesh=) on a ('model' = world) mesh serves what the
    surrogate without a mesh does."""
    from scasml_gp_torch.serve import SurrogateServer, load_surrogate, save_surrogate

    eq, x_dom, x_bdy, x_test = problem()
    path = os.path.join(out, "ckpt")
    if rank == 0:
        save_surrogate(path, trained(eq, x_dom, x_bdy))
    torch.distributed.barrier()
    mesh = pm.make_mesh(1, world)
    gp1 = load_surrogate(path, device="cpu")
    gpm = load_surrogate(path, device="cpu", mesh=mesh)
    assert gpm.mesh is mesh
    close(gpm.predict(x_test), gp1.predict(x_test), MODEL, "predict")
    close(gpm.compute_gradient(x_test), gp1.compute_gradient(x_test), MODEL, "gradient")
    server = SurrogateServer(gpm, buckets=(16, 64))
    close(torch.as_tensor(server.predict(x_test.numpy())), gp1.predict(x_test), MODEL,
          "server predict")


def check_sharded_step(world, rank, out):
    """make_sharded_train_and_solve on a 2 x (world / 2) mesh, the GP
    carrying it: against the same step on a 1 x 1 mesh, and, with n = 0
    (u_hat alone), saved for the test to hold against the JAX package's."""
    eq, x_dom, x_bdy, x_test = problem()
    mesh = pm.make_mesh(2, world // 2)
    one = pm.Mesh(1, 1)
    results = {}
    for key, m in (("mesh", mesh), ("one", one)):
        gp = port.GPGradDependentNonlinear(eq, port.GPConfig(gn_steps=8), device="cpu",
                                           mesh=m)
        sca = port.ScaSMLFullHistory(eq, gp)
        for n in (0, 2):
            step = make_sharded_train_and_solve(eq, gp, sca, m, n=n, M=3, gn_steps=8)
            results[key, n] = step(x_dom, x_bdy, x_test, torch.Generator().manual_seed(2))
    for n in (0, 2):
        close(results["mesh", n], results["one", n], MODEL, f"step n={n}")
    exact = eq.exact_solution(x_test)
    rel = float((results["mesh", 2] - exact).norm() / exact.norm())
    assert rel < 0.5, rel
    if rank == 0:
        np.savez(os.path.join(out, "sharded_step.npz"), x_dom=x_dom.numpy(),
                 x_bdy=x_bdy.numpy(), x_test=x_test.numpy(),
                 u_hat=results["mesh", 0].numpy(), u=results["mesh", 2].numpy())


CHECKS = {
    2: (check_mesh_shapes, check_data_solve, check_model_posterior,
        check_model_dense_train, check_model_dual_cg, check_runner, check_serve),
    4: (check_mesh_shapes, check_data_solve, check_model_posterior, check_sharded_step),
}


def main():
    rank, world, port_, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    pm.initialize_distributed(f"localhost:{port_}", world, rank, backend="gloo")
    try:
        for check in CHECKS[world]:
            check(world, rank, out)
            print(f"CHECK {check.__name__[6:]} OK", flush=True)
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # the other ranks may wait in a collective: do not join them
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
