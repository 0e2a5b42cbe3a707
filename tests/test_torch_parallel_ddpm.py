"""Data parallel on two gloo ranks for the DDPM workload (CPU, float32
steps): the tiny CondUNet's SFR-on step against one process and against
the JAX package's own ``data=2`` sharded step, the adaga sum taken per
rank shown to fail, and ``sfron_forget`` (written once, resumed) and
``sample_images`` under two ranks against one process.

The ranks run ``tests/torch_parallel_ranks.py`` (no JAX) and hand back
whole tensors through files; the one-process runs call the same functions
here, without a group."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests import torch_parallel_ranks as PR  # noqa: E402
from uurg_torch.io.jax_interop import jax_unet_params_to_torch  # noqa: E402
from uurg_tpu.diffusion import adaptive_loss, make_schedule  # noqa: E402
from uurg_tpu.diffusion import losses as JL  # noqa: E402
from uurg_tpu.models import unet_cond as JU  # noqa: E402
from uurg_tpu.parallel import make_mesh, replicate, shard_batch  # noqa: E402
from uurg_tpu.train import optim as JO  # noqa: E402
from uurg_tpu.unlearn import sfron as JS  # noqa: E402

# one process against two ranks: the same float32 ops on half the rows,
# the gradients averaged (tests/test_parallel.py's bound); the update
# (params - start) also held to its norm, which the per-rank adaga sum
# misses by ~7x (its abs error stays under PARAM_ABS: the halves' losses
# are alike at init, so the two normalizers differ by a few percent)
PARAM_ABS, LOSS_REL, DP_UPDATE_REL = 2e-6, 1e-4, 2e-4
# the port against JAX (test_three_sfron_steps_match_jax's bounds)
UPDATE_REL, PARAM_ATOL = 1e-3, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(seed, n=16, injected=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)
    c = rng.integers(0, 10, n).astype(np.int64)
    if not injected:
        return x, c
    t = rng.integers(0, 1000, n).astype(np.int64)
    noise = rng.standard_normal((n, 32, 32, 3), dtype=np.float32)
    keep = rng.random(n) >= 0.3
    return x, c, t, noise, keep


def _tb(batch):
    return tuple(torch.from_numpy(np.asarray(a)) for a in batch)


def _max_abs(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def _update_rel(have, want, start):
    """|(have - start) - (want - start)| / |want - start| over every
    tensor."""
    d = torch.cat([(have[k] - want[k]).reshape(-1) for k in want])
    u = torch.cat([(want[k] - start[k]).reshape(-1) for k in want])
    return float(d.norm() / u.norm())


@pytest.fixture(scope="module")
def ddpm_step(tmp_path_factory):
    """The JAX params, the inputs, the one-process and the rank-0 results
    (rank 1 must hold the same whole tensors)."""
    tmp = tmp_path_factory.mktemp("ddpm_step")
    cfg = JU.UNetConfig(dtype=jnp.float32, **PR.TINY_UNET)
    _, params = JU.init_unet(jax.random.key(0), cfg)
    state = jax_unet_params_to_torch(params)
    injected = {"tmp": str(tmp), "state": state, "lr": 1e-2,
                "batches": [(_tb(_batch(100 + i, injected=True)),
                             _tb(_batch(200 + i, injected=True)))
                            for i in range(2)]}
    inputs = {"tmp": str(tmp), "state": state, "lr": 1e-3,
              "batches": [(_tb(_batch(1 + i)), _tb(_batch(11 + i)))
                          for i in range(2)],
              "injected": injected}
    torch.save(inputs, tmp / "in.pt")
    PR.spawn("ddpm_step", 2, tmp, str(tmp / "in.pt"))
    got = [torch.load(tmp / f"ddpm_step_rank{r}.pt", weights_only=False)
           for r in range(2)]
    for kind in got[0]:
        assert _max_abs(got[0][kind]["params"], got[1][kind]["params"]) == 0
    ref = {"draws": PR.ddpm_step_run(inputs, None, "draws"),
           "injected": PR.ddpm_step_run(injected, None, "injected")}
    return params, injected, ref, got[0]


def test_ddpm_dp_step_matches_one_process(ddpm_step):
    _, _, ref, got = ddpm_step
    start = ddpm_step[1]["state"]
    assert _max_abs(ref["draws"]["params"], start) > 1e-5
    assert _max_abs(got["draws"]["params"], ref["draws"]["params"]) \
        < PARAM_ABS
    assert _update_rel(got["draws"]["params"], ref["draws"]["params"],
                       start) < DP_UPDATE_REL
    for m_got, m_ref in zip(got["draws"]["metrics"], ref["draws"]["metrics"]):
        for k in m_ref:
            np.testing.assert_allclose(m_got[k], m_ref[k], rtol=LOSS_REL,
                                       err_msg=k)


def test_ddpm_dp_per_rank_adaga_sum_fails(ddpm_step):
    # the adaptive weights normalized over each rank's rows alone: the
    # update misses one process's by several times the bound
    _, inputs, ref, got = ddpm_step
    assert _update_rel(got["local_adaga"]["params"], ref["draws"]["params"],
                       inputs["state"]) > 4 * DP_UPDATE_REL


def test_ddpm_dp_step_matches_jax_data2(ddpm_step):
    params, injected, ref, got = ddpm_step
    jmodel = JU.CondUNet(JU.UNetConfig(dtype=jnp.float32, **PR.TINY_UNET))
    sched = make_schedule()

    def per(p, batch):
        x, c, t, noise, keep = batch
        return JL.noise_estimation_loss(
            lambda x_t, tv: jmodel.apply({"params": p}, x_t, tv, c, keep),
            sched, x, t, noise, keepdim=True)

    opt = JO.make_optimizer("sgd", injected["lr"], momentum=0.9)
    step = JS.make_sfron_step(
        JS.SFRonConfig(n_iters=10, forget_alpha=1.0, alpha_sched="cosine",
                       forget_clip=1.0, remain_clip=1.0), opt,
        lambda p, b, k: -adaptive_loss(per(p, b), 0.5, eps=1e-8),
        lambda p, b, k: per(p, b).mean(), donate=False)
    mesh = make_mesh({"data": 2}, devices=jax.devices()[:2])
    state = replicate(JS.init_state(params, opt), mesh)
    for i, (fb, rb) in enumerate(injected["batches"]):
        fb, rb = (shard_batch(tuple(np.asarray(a) for a in b), mesh)
                  for b in (fb, rb))
        state, m = step(state, fb, rb, jax.random.key(i))
        for k in ("forget_loss", "remain_loss", "remain_grad_norm"):
            np.testing.assert_allclose(got["injected"]["metrics"][i][k],
                                       float(m[k]), rtol=1e-4, err_msg=k)
    want = jax_unet_params_to_torch(state.params)
    start = injected["state"]
    names = list(want)
    for have in (got["injected"]["params"], ref["injected"]["params"]):
        d_t = torch.cat([(have[k] - start[k]).reshape(-1) for k in names])
        d_j = torch.cat([(want[k] - start[k]).reshape(-1) for k in names])
        assert d_j.norm() > 0
        assert (d_t - d_j).norm() / d_j.norm() < UPDATE_REL
        for k in names:
            np.testing.assert_allclose(have[k].numpy(), want[k].numpy(),
                                       atol=PARAM_ATOL, err_msg=k)


def test_sfron_forget_and_sample_images_two_ranks(tmp_path):
    """sfron_forget under two ranks (auto data parallel, no flag) equals
    one process, straight and cut after one step and resumed from its
    ckpt.pth, which rank 0 alone writes; sample_images returns the whole
    one-process array on both ranks within one level; make_mesh's rules
    on two ranks."""
    PR.spawn("ddpm_runner", 2, tmp_path, str(tmp_path / "ranks"))
    got = [torch.load(tmp_path / f"ddpm_runner_rank{r}.pt",
                      weights_only=False) for r in range(2)]
    one = str(tmp_path / "one")
    ref = {"straight": PR.ddpm_runner_run(one, "straight", 2),
           "first": PR.ddpm_runner_run(one, "resumed", 1),
           "resumed": PR.ddpm_runner_run(one, "resumed", 2)}
    images = PR.ddpm_sample_run(one)
    assert _max_abs(ref["resumed"]["params"], ref["first"]["params"]) > 1e-5
    for r in range(2):
        for run in ref:
            for k in ("params", "ema"):
                assert _max_abs(got[r][run][k], ref[run][k]) < PARAM_ABS, \
                    (run, k)
            assert got[r][run]["step"] == ref[run]["step"]
        # a write at each step's snapshot and one at the end, rank 0's
        assert got[r]["straight"]["writes"] == ([0] * 3 if r == 0 else [])
        assert got[r]["resumed"]["writes"] == ([0] * 2 if r == 0 else [])
        rules = got[r]["mesh_rules"]
        assert rules["fill"] == {"data": 1, "model": 2}
        assert rules["small"] == {"data": 1}
        assert rules["warned"] == ["mesh axes {'data': 1} use 1 of 2 ranks; "
                                   "use -1 on one axis to fill the rest"]
        assert rules["error"] == ("mesh axes {'data': 4} need 4 ranks, only "
                                  "2 available")
        assert got[r]["images"].shape == images.shape == (6, 32, 32, 3)
        diff = np.abs(got[r]["images"].astype(np.int16)
                      - images.astype(np.int16))
        assert diff.max() <= 1
