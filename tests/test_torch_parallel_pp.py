"""The DiT pipeline (``uurg_torch/parallel/pipeline.py``) on gloo ranks
(CPU, float32) against the JAX package's ``dit_apply_pipelined`` on the
virtual CPU devices and against one process: the forward on ``stage=2``
(2 and 4 microbatches, and with cond dropout) and ``stage=4``, every
parameter's gradient, ``data=2,stage=2``; the placement; JAX's refusals;
``dit_forget`` under ``pp`` for two steps (a dense mask, its train state
and ``final.pt`` written whole; a packed mask at 4 microbatches).

The weights are JAX's DiT at ``tests/test_pipeline.py``'s config, every
leaf perturbed from a seed (a fresh DiT's adaLN-Zero layers make its
output exactly 0), handed to the port through ``jax_dit_params_to_torch``.
``dit_forget`` runs the depth-2 DiT-S/2 of the other multi-rank tests from
its own init, as they do."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests import torch_parallel_ranks as PR  # noqa: E402
from uurg_torch.io.dit_interop import load_dit_reference_checkpoint  # noqa: E402
from uurg_torch.io.jax_interop import jax_dit_params_to_torch  # noqa: E402
from uurg_torch.parallel.pipeline import dit_apply_pipelined  # noqa: E402
from uurg_tpu.models.dit import DiTConfig as JConfig, init_dit  # noqa: E402
from uurg_tpu.parallel import dit_apply_pipelined as j_pipelined  # noqa: E402
from uurg_tpu.parallel import make_mesh as j_mesh  # noqa: E402

# tests/test_pipeline.py's bounds: the forward, the gradients
FWD_TOL, GRAD_ATOL, GRAD_RTOL = 2e-5, 5e-5, 5e-4
# tests/test_parallel.py's bounds for a sharded DiT step
RTOL, ATOL, LOSS_REL = 2e-4, 2e-5, 1e-5
JCFG = JConfig(**PR.PP_DIT, dtype=jnp.float32)
DEPTH = PR.PP_DIT["depth"]
RUNS_2 = [("stage=2", 2, False), ("stage=2", 4, False), ("stage=2", 2, True)]
RUNS_4 = [("stage=4", 4, False), ("data=2,stage=2", 2, False)]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _dit_batch(rng, n=8):
    return (torch.from_numpy(rng.standard_normal((n, 8, 8, 4))
                             .astype(np.float32)),
            torch.from_numpy(rng.integers(0, 10, n)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's perturbed params, the port's inputs (written for the ranks),
    the one-process runs and both spawns' results."""
    tmp = tmp_path_factory.mktemp("pp")
    rng = np.random.default_rng(0)
    _, params = init_dit(jax.random.key(0), JCFG)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        params)
    x = rng.standard_normal((8, 8, 8, 4)).astype(np.float32)
    t, y = np.arange(8, dtype=np.int32) * 10, np.arange(8, dtype=np.int32) % 10
    keep = np.asarray([True, False] * 4)
    target = rng.standard_normal((8, 8, 8, 8)).astype(np.float32)
    data = {"state": jax_dit_params_to_torch(params, DEPTH),
            "x": torch.from_numpy(x), "t": torch.from_numpy(t).long(),
            "y": torch.from_numpy(y).long(), "keep": torch.from_numpy(keep),
            "target": torch.from_numpy(target)}
    torch.save(data, tmp / "in.pt")
    dit = PR.dit_workload().init_params(0)
    forget = {"state": {k: v.detach().clone()
                        for k, v in dit.state_dict().items()},
              "mask": {n: torch.from_numpy(rng.random(tuple(p.shape)) < 0.6)
                       for n, p in dit.named_parameters()},
              "batches_f": [_dit_batch(rng) for _ in range(2)],
              "batches_r": [_dit_batch(rng) for _ in range(2)]}
    torch.save(forget, tmp / "forget.pt")
    ranks = tmp / "ranks"
    ranks.mkdir()
    PR.spawn("pp", 2, tmp, str(tmp / "in.pt"), RUNS_2, str(tmp / "forget.pt"),
             str(ranks))
    two = [torch.load(tmp / f"pp_rank{r}.pt", weights_only=False)
           for r in range(2)]
    PR.spawn("pp", 4, tmp, str(tmp / "in.pt"), RUNS_4, None, None)
    four = [torch.load(tmp / f"pp_rank{r}.pt", weights_only=False)
            for r in range(4)]
    one = {keep: PR.pp_apply_run(data, None, keep=keep)
           for keep in (False, True)}
    arrays = {"params": params, "x": jnp.asarray(x), "t": jnp.asarray(t),
              "y": jnp.asarray(y), "keep": jnp.asarray(keep),
              "target": jnp.asarray(target)}
    return types.SimpleNamespace(tmp=tmp, data=data, forget=forget, two=two,
                                 four=four, one=one, jax=arrays)


def _jax_forward_and_grads(a, stages: int, n_mb: int, keep: bool,
                           data: int = 1):
    """JAX's pipelined forward and its gradients of every leaf, on the
    first data * stages virtual devices."""
    axes = {"data": data, "stage": stages} if data > 1 else {"stage": stages}
    mesh = j_mesh(axes, devices=jax.devices()[:data * stages])
    ck = a["keep"] if keep else None

    def apply(p):
        return j_pipelined(p, JCFG, a["x"], a["t"], a["y"], mesh=mesh,
                           n_microbatches=n_mb, cond_keep=ck)

    def loss(p):
        return jnp.mean((apply(p) - a["target"]) ** 2)

    out = jax.jit(apply)(a["params"])
    grads = jax.jit(jax.grad(loss))(a["params"])
    return (torch.from_numpy(np.array(out)),
            jax_dit_params_to_torch(grads, DEPTH))


def _check(got: dict, out, grads, what: str) -> None:
    np.testing.assert_allclose(got["out"].numpy(), out.numpy(),
                               atol=FWD_TOL, rtol=FWD_TOL, err_msg=what)
    assert got["grads"].keys() == grads.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(got["grads"][k].numpy(), g.numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("run", RUNS_2 + RUNS_4)
def test_pipelined_forward_and_grads_match_jax_and_one_process(setup, run):
    spec, n_mb, keep = run
    axes = dict(p.split("=") for p in spec.split(","))
    stages, data = int(axes["stage"]), int(axes.get("data", 1))
    out, grads = _jax_forward_and_grads(setup.jax, stages, n_mb, keep, data)
    # the gradients move: the perturbed model attends, every block learns
    assert all(float(g.abs().max()) > 0 for g in grads.values())
    ranks = setup.two if stages * data == 2 else setup.four
    one = setup.one[keep]
    _check(one, out, grads, "one process")
    for r, got in enumerate(ranks):
        _check(got[tuple(run)], out, grads, f"{spec} rank {r}")
        _check(got[tuple(run)], one["out"], one["grads"],
               f"{spec} rank {r} vs one process")


def test_placement_each_stage_holds_its_blocks(setup):
    """Stage s holds blocks [s d / S, (s + 1) d / S), every block
    parameter marked with its whole shape on every stage."""
    shapes = {k: tuple(v.shape) for k, v in setup.data["state"].items()}
    cases = [(setup.two, ("stage=2", 2, False), 2, lambda r: r),
             (setup.four, ("stage=4", 4, False), 4, lambda r: r),
             (setup.four, ("data=2,stage=2", 2, False), 2, lambda r: r % 2)]
    for ranks, run, stages, stage_of in cases:
        per = DEPTH // stages
        for r, got in enumerate(ranks):
            res = got[run]
            s = stage_of(r)
            assert res["held"] == list(range(s * per, (s + 1) * per)), (run,
                                                                         r)
            assert res["shapes"] == {k: v for k, v in shapes.items()
                                     if k.startswith("blocks.")}


def test_pipeline_refusals():
    """JAX's ValueErrors, before any process group is touched."""
    from uurg_torch.models.dit import DiTConfig

    cfg = DiTConfig(**PR.PP_DIT, dtype=torch.float32)
    x, t, y = torch.zeros(8, 8, 8, 4), torch.zeros(8), torch.zeros(8)

    def mesh(**axes):
        return types.SimpleNamespace(mesh_dim_names=tuple(axes),
                                     shape=tuple(axes.values()))

    with pytest.raises(ValueError, match="microbatches"):
        dit_apply_pipelined(None, cfg, x, t, y, mesh=mesh(stage=8),
                            n_microbatches=3)
    with pytest.raises(ValueError, match="divisible"):
        dit_apply_pipelined(None, cfg, x, t, y, mesh=mesh(stage=3),
                            n_microbatches=4)
    # a global batch of 8 rows on data=4: microbatches of 2 rows do not
    # split over the data axis (each rank holds 2 rows)
    with pytest.raises(ValueError, match="data axis"):
        dit_apply_pipelined(None, cfg, x[:2], t[:2], y[:2],
                            mesh=mesh(data=4, stage=2), n_microbatches=4)
    import dataclasses

    with pytest.raises(ValueError, match="scan"):
        dit_apply_pipelined(None, dataclasses.replace(cfg, scan_blocks=False),
                            x, t, y, mesh=mesh(stage=2), n_microbatches=2)


def test_dit_forget_pp_two_ranks_equals_one_process(setup):
    """dit_forget under pp on stage=2 (2 microbatches, a dense mask), at
    4 microbatches with a packed mask, and cut after one step and resumed
    from its train state: parameters, EMA, Adam moments and metrics equal
    one process's; each stage holds its block's parameter, moment, shadow
    and mask and nothing of the other's; rank 0 alone writes the train
    state and final.pt whole."""
    data = setup.forget
    one_dir = str(setup.tmp / "one")
    ref = PR.dit_runner_run(data, one_dir, 2, None, pack=False)
    # a resumed run reads the batch iterators from their start again, on
    # one process as on the ranks
    one_cut = str(setup.tmp / "one_cut")
    PR.dit_runner_run(data, one_cut, 1, None, pack=False)
    refs = {"forget": ref, "forget_packed": ref,
            "forget_resumed": PR.dit_runner_run(data, one_cut, 2, None,
                                                pack=False)}
    for r, got in enumerate(setup.two):
        for kind, ref in refs.items():
            g = got[kind]
            for part in ("params", "ema"):
                for k, w in ref[part].items():
                    np.testing.assert_allclose(g[part][k].numpy(), w.numpy(),
                                               rtol=RTOL, atol=ATOL,
                                               err_msg=f"{kind} {part} {k}")
            for i, st in ref["opt"]["state"].items():
                for m in ("exp_avg", "exp_avg_sq"):
                    np.testing.assert_allclose(
                        g["opt"]["state"][i][m].numpy(), st[m].numpy(),
                        rtol=RTOL, atol=ATOL, err_msg=f"{kind} {m} {i}")
            assert len(g["metrics"]) == len(ref["metrics"])
            for a, b in zip(g["metrics"], ref["metrics"]):
                for k in a:
                    np.testing.assert_allclose(a[k], b[k], rtol=LOSS_REL,
                                               err_msg=k)
        ref = refs["forget"]
        for name, sizes in got["forget"]["sizes"].items():
            numel = ref["params"][name].numel()
            if name.startswith("blocks."):
                mine = int(name.split(".")[1]) == r
                assert sizes == ((numel,) * 4 if mine else (0,) * 4), name
            else:
                assert sizes == (numel,) * 4, name
        writers = {w for w, _ in got["forget"]["writes"]}
        assert writers == ({0} if r == 0 else set())
    ranks_dir = setup.tmp / "ranks" / "pp_ckpt"
    full = torch.load(ranks_dir / "train_state.pt", weights_only=True)
    assert full["step"] == 2
    # the Adam state whole, each step count a scalar as on one device
    for i, st in ref["opt"]["state"].items():
        saved = full["optimizer"]["state"][i]
        assert saved["step"].shape == st["step"].shape == ()
        np.testing.assert_allclose(saved["exp_avg"].numpy(),
                                   st["exp_avg"].numpy(), rtol=RTOL,
                                   atol=ATOL)
    for k, v in full["model"].items():
        np.testing.assert_allclose(v.numpy(), ref["params"][k].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for part, ema in (("params", False), ("ema", True)):
        model = load_dit_reference_checkpoint(
            str(ranks_dir / "final.pt"), PR.dit_model(data["state"]),
            prefer_ema=ema)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       ref[part][k].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{part} {k}")


def test_microbatches_move_a_bf16_update_within_the_chip_gate():
    """chip_smoke.py holds dit_forget in PP_MICROBATCHES microbatches on
    one stage to PP_UPDATE_REL of one device's update (bf16 on the card:
    the microbatches change the rows of every GEMM, and Adam turns the
    reordered sums of gradients near zero into moves of either sign). The
    same bf16 run here, a narrow perturbed DiT at chip_smoke's optimizer,
    loss and step count, lands within it, one microbatch at zero; an
    update that leaves one block of four unchanged lands outside it."""
    import chip_smoke as CS
    from tests.torch_parallel_ranks import one_rank_group
    from uurg_torch.parallel.mesh import make_mesh
    from uurg_torch.workloads import dit_runner
    from uurg_torch.workloads.dit import DiTWorkload

    wl = DiTWorkload.build("DiT-S/2", image_size=128, num_classes=10,
                           device="cpu", depth=4, hidden_size=128,
                           num_heads=4)
    rng = np.random.default_rng(0)

    def batch(low):
        return (torch.from_numpy(rng.standard_normal((8, 16, 16, 4))
                                 .astype(np.float32)),
                torch.from_numpy(rng.integers(low, 10, 8)))

    steps = CS.DP_DIT_STEPS
    fbs = [batch(9) for _ in range(steps)]
    rbs = [batch(1) for _ in range(steps)]
    start = {n: p.detach().double() for n, p in
             CS.perturb_dit_(wl.init_params(0)).named_parameters()}
    gen = torch.Generator().manual_seed(0)
    mask = {n: torch.rand(p.shape, generator=gen) < 0.5
            for n, p in wl.init_params(0).named_parameters()}

    def run(**place):
        state = dit_runner.dit_forget(
            wl, CS.perturb_dit_(wl.init_params(0)), iter(fbs), iter(rbs),
            n_iters=steps, lr=1e-4, forget_alpha=1e-3, unlearn_loss="adaga",
            mask=mask, seed=0, log_freq=10 ** 6, **place)
        return {n: p.detach().double()
                for n, p in state.model.named_parameters()}

    def update_rel(got, one):
        num = sum(float((got[n] - one[n]).square().sum()) for n in one)
        den = sum(float((one[n] - start[n]).square().sum()) for n in one)
        return (num / den) ** 0.5

    one = run()
    with one_rank_group():
        mesh = make_mesh({"stage": 1})
        got = {m: run(mesh=mesh, parallelism="pp", pp_microbatches=m)
               for m in (1, CS.PP_MICROBATCHES)}
    assert update_rel(got[1], one) == 0.0
    assert 0.0 < update_rel(got[CS.PP_MICROBATCHES], one) < CS.PP_UPDATE_REL
    frozen = {n: start[n] if n.startswith("blocks.1.") else p
              for n, p in one.items()}
    assert update_rel(frozen, one) > CS.PP_UPDATE_REL
