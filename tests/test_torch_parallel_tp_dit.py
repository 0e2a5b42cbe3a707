"""Tensor parallel on gloo ranks for the DiT workload (CPU, float32): the
depth-2 DiT-S/2 SFR-on step (AdamW, forget clip 1.0, EMA, a dense mask)
on a ``model=2`` mesh and on a ``data=2,model=2`` mesh against one
process, and the four-rank step against the JAX package's own
``data=2,model=2`` tensor-parallel step on the virtual CPU devices.

Every run takes the JAX step's t and noise (drawn from its keys, injected
into the port's workload and cut to each rank's rows), so the three sides
see the same draws. The model is DiT's own init (adaLN-Zero), as
``tests/test_tensor_parallel.py`` takes it: the first phase moves the
final layer alone, the later ones open the gates, so after two steps every
column-parallel layer has passed gradients to the parameters upstream of
it (the embedders), which a missing backward all-reduce would leave
wrong."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from tests import torch_parallel_ranks as PR  # noqa: E402
from uurg_torch.io.jax_interop import jax_dit_params_to_torch  # noqa: E402
from uurg_tpu.diffusion import gaussian as JG  # noqa: E402
from uurg_tpu.models import dit as JD  # noqa: E402
from uurg_tpu.parallel import mesh as JM  # noqa: E402
from uurg_tpu.train import optim as JO  # noqa: E402
from uurg_tpu.unlearn import sfron as JS  # noqa: E402
from uurg_tpu.workloads.dit import DiTWorkload as JW  # noqa: E402

# tests/test_tensor_parallel.py's bounds for the tensor-parallel DiT step
RTOL, ATOL, LOSS_REL = 2e-4, 2e-5, 1e-5
UPSTREAM = ("x_embedder.proj.weight", "t_embedder.mlp.0.weight",
            "t_embedder.mlp.2.weight", "y_embedder.embedding_table.weight")
QKV = "blocks.0.attn.qkv.weight"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_workload():
    cfg = JD.DiTConfig(input_size=8, patch_size=2, in_channels=4,
                       hidden_size=384, depth=2, num_heads=6,
                       num_classes=10, dtype=jnp.float32)
    return JW(model=JD.DiT(cfg), cfg=cfg,
              diffusion=JG.make_diffusion("", 1000, learn_sigma=True))


def _jax_draw(key, x):
    """What the JAX workload's ``_per_sample_loss`` draws from ``key``."""
    k_t, k_n = jax.random.split(key)
    t = jax.random.randint(k_t, (x.shape[0],), 0, 1000)
    noise = jax.random.normal(k_n, x.shape, x.dtype)
    return (torch.from_numpy(np.asarray(t)).long(),
            torch.from_numpy(np.asarray(noise)))


def _batch(rng, n=8):
    return (rng.standard_normal((n, 8, 8, 4)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The JAX params and mask, the port's inputs (the same start, mask,
    batches and the JAX step's draws) and the one-process run."""
    tmp = tmp_path_factory.mktemp("dit_tp")
    rng = np.random.default_rng(0)
    _, params = JD.init_dit(jax.random.key(0), _jax_workload().cfg)
    mask_j = jax.tree_util.tree_map(lambda p: rng.random(p.shape) < 0.6,
                                    params)
    batches = [(_batch(rng), _batch(rng)) for _ in range(2)]
    draws = []
    for i, (fb, rb) in enumerate(batches):
        # the JAX step's keys: split(fold_in(key, step)) into forget, remain
        k_f, k_r = jax.random.split(jax.random.fold_in(jax.random.key(7 + i),
                                                       i))
        draws += [_jax_draw(k_f, fb[0]), _jax_draw(k_r, rb[0])]
    tb = [tuple(tuple(torch.from_numpy(a).long() if a.dtype == np.int32
                      else torch.from_numpy(a) for a in b) for b in pair)
          for pair in batches]
    data = {"state": jax_dit_params_to_torch(params, 2),
            "mask": {k: v.bool() for k, v in jax_dit_params_to_torch(
                jax.tree_util.tree_map(lambda m: m.astype(np.float32),
                                       mask_j), 2).items()},
            "batches": tb, "draws": draws}
    torch.save(data, tmp / "in.pt")
    return tmp, data, params, mask_j, batches, PR.dit_step_run(data, None)


def _close(got, want, names=None):
    for k in names or want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def _check_against_one_process(got, ref, start):
    _close(got["params"], ref["params"])
    _close(got["ema"], ref["ema"])
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_REL)
    for have, want in zip(got["exp_avg"], ref["exp_avg"]):
        np.testing.assert_allclose(have.numpy(), want.numpy(), rtol=RTOL,
                                   atol=ATOL)
    # the parameters upstream of the column-parallel layers moved, by one
    # process's update
    for k in UPSTREAM:
        assert (ref["params"][k] - start[k]).abs().max() > 1e-5, k
    _close(got["params"], ref["params"], UPSTREAM)


def _heads_of_rank(t, r, n=2):
    """Rank r's heads of q, k and v in a one-device qkv tensor."""
    return torch.cat([p.chunk(n)[r] for p in t.chunk(3)])


def test_dit_tp_step_model2_matches_one_process(inputs):
    tmp, data, *_, ref = inputs
    PR.spawn("dit_tp_step", 2, tmp, str(tmp / "in.pt"), "model=2")
    qkv_i = list(ref["params"]).index(QKV)
    for r in range(2):
        got = torch.load(tmp / f"dit_tp_step_rank{r}.pt", weights_only=False)
        _check_against_one_process(got, ref, data["state"])
        # the sharded parameters, their Adam moments, shadows and dense
        # masks hold half the elements on each rank
        assert got["sizes"][QKV] == (ref["params"][QKV].numel() // 2,) * 4
        assert got["sizes"]["y_embedder.embedding_table.weight"][0] == \
            ref["params"]["y_embedder.embedding_table.weight"].numel()
        # rank r's shards of qkv hold its heads of q, k and v: the weight,
        # its Adam moment and its mask
        loc = got["qkv_local"]
        assert torch.equal(loc["mask"], _heads_of_rank(data["mask"][QKV], r))
        np.testing.assert_allclose(
            loc["param"].numpy(),
            _heads_of_rank(ref["params"][QKV], r).numpy(), rtol=RTOL,
            atol=ATOL)
        np.testing.assert_allclose(
            loc["exp_avg"].numpy(),
            _heads_of_rank(ref["exp_avg"][qkv_i], r).numpy(), rtol=RTOL,
            atol=ATOL)


@pytest.fixture(scope="module")
def four_ranks(inputs):
    tmp = inputs[0]
    PR.spawn("dit_tp_step", 4, tmp, str(tmp / "in.pt"), "data=2,model=2")
    return [torch.load(tmp / f"dit_tp_step_rank{r}.pt", weights_only=False)
            for r in range(4)]


def test_dit_tp_step_data2_model2_matches_one_process(inputs, four_ranks):
    _, data, *_, ref = inputs
    for got in four_ranks:
        _check_against_one_process(got, ref, data["state"])


def test_dit_tp_step_data2_model2_matches_jax(inputs, four_ranks):
    """JAX's data=2,model=2 step (shard_params_tp over params, EMA and
    Adam state, pjit's collectives) on four of the virtual CPU devices."""
    _, data, params, mask_j, batches, _ = inputs
    jwl = _jax_workload()
    opt = JO.make_optimizer("adamw", 1e-3)
    cfg = JS.SFRonConfig(n_iters=10, forget_alpha=0.5, alpha_sched="const",
                         forget_clip=1.0, remain_clip=None, ema_mu=0.999)
    step = JS.make_sfron_step(cfg, opt, jwl.forget_loss_fn("ga", 0),
                              jwl.train_loss_fn(), donate=False)
    mesh = JM.make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    state = JS.init_state(params, opt, ema=True, mask=mask_j)
    state = jax.device_put(state, NamedSharding(mesh, P()))
    state.params = JM.shard_params_tp(state.params, mesh)
    state.ema_params = JM.shard_params_tp(state.ema_params, mesh)
    state.opt_state = JM.shard_params_tp(state.opt_state, mesh)
    state.mask = JM.shard_params_tp(state.mask, mesh)
    losses = []
    for i, (fb, rb) in enumerate(batches):
        state, m = step(state, JM.shard_batch(fb, mesh),
                        JM.shard_batch(rb, mesh), jax.random.key(7 + i))
        losses.append([float(m["forget_loss"]), float(m["remain_loss"])])
    want = {"params": jax_dit_params_to_torch(state.params, 2),
            "ema": jax_dit_params_to_torch(state.ema_params, 2)}
    for got in four_ranks:
        _close(got["params"], want["params"])
        _close(got["ema"], want["ema"])
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_REL)
