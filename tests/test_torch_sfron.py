"""The port's training slice vs the JAX package (CPU, fp32): RNG helpers,
losses, mask packing, clipping, EMA, optimizers, the per-sample eps loss,
three SFR-on steps, the data pipeline, and the runner and CLI end to end."""
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from uurg_torch.core import rng as TRng  # noqa: E402
from uurg_torch.core import tree as TT  # noqa: E402
from uurg_torch.core.config import load_config  # noqa: E402
from uurg_torch.data import arrays as TA  # noqa: E402
from uurg_torch.data import datasets as TD  # noqa: E402
from uurg_torch.data.splits import class_forget_split  # noqa: E402
from uurg_torch.diffusion import losses as TL  # noqa: E402
from uurg_torch.io.jax_interop import jax_unet_params_to_torch  # noqa: E402
from uurg_torch.models import unet_cond as TU  # noqa: E402
from uurg_torch.train import optim as TO  # noqa: E402
from uurg_torch.unlearn import ema as TE  # noqa: E402
from uurg_torch.unlearn import sfron as TS  # noqa: E402
from uurg_torch.workloads import ddpm_runner as TR  # noqa: E402
from uurg_torch.workloads.ddpm import DDPMWorkload  # noqa: E402
from uurg_tpu.core import tree as JT  # noqa: E402
from uurg_tpu.core.rng import antithetic_timesteps as jax_antithetic  # noqa: E402
from uurg_tpu.data import arrays as JA  # noqa: E402
from uurg_tpu.data import datasets as JD  # noqa: E402
from uurg_tpu.data.splits import class_forget_split as jax_split  # noqa: E402
from uurg_tpu.diffusion import adaptive_loss, make_schedule  # noqa: E402
from uurg_tpu.diffusion import losses as JL  # noqa: E402
from uurg_tpu.models import unet_cond as JU  # noqa: E402
from uurg_tpu.train import optim as JO  # noqa: E402
from uurg_tpu.unlearn import ema as JE  # noqa: E402
from uurg_tpu.unlearn import sfron as JS  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SFRON = os.path.join(ROOT, "configs", "cifar10_sfron.yml")
TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
            dropout=0.0, resolution=32)
# fp32 on both sides, sums in another order: elementwise ops agree to a few
# ulp, reductions over ~1e3 terms to ~1e-6 relative
F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: under pytest-xdist the
    suite runs several worker processes on one host, and torch's default
    of one thread a core in each oversubscribes the cores several times
    over (a torch-heavy file ran 3-10x slower beside another one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny_config(tmp_path, **training):
    cfg = load_config(SFRON)
    model = {**cfg.model.to_dict(), "ch": 32, "ch_mult": [1, 2],
             "num_res_blocks": 1}
    train = {**cfg.training.to_dict(), "batch_size": 4, "n_iters": 3,
             "snapshot_freq": 2, "log_freq": 1, **training}
    data = {**cfg.data.to_dict(), "path": str(tmp_path / "no_cifar"),
            "synthetic_n": 64}
    return cfg.merged({"model": model, "training": train, "data": data,
                       "sampling": {"batch_size": 4}})


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- leaf modules ----------------------------------------------------------

def test_antithetic_timesteps_and_keep_mask():
    gen = torch.Generator().manual_seed(0)
    for n in (1, 6, 7):
        t = TRng.antithetic_timesteps(gen, n, 1000)
        half = n // 2 + 1
        assert t.shape == (n,) and t.dtype == torch.int64
        assert ((0 <= t) & (t < 1000)).all()
        # the second part mirrors the first, as the JAX helper does
        assert torch.equal(t[half:], 999 - t[:n - half])
        j = np.asarray(jax_antithetic(jax.random.key(0), n, 1000))
        assert j.shape == (n,) and np.array_equal(j[half:], 999 - j[:n - half])
    assert TRng.cond_keep_mask(gen, 5, 0.0).all()
    assert not TRng.cond_keep_mask(gen, 5, 1.0).any()
    keep = TRng.cond_keep_mask(gen, 20000, 0.1)
    assert keep.dtype == torch.bool and abs(keep.float().mean() - 0.9) < 0.01


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    x0, noise = (rng.standard_normal((6, 4, 4, 3), dtype=np.float32)
                 for _ in range(2))
    t = rng.integers(0, 1000, 6)
    w = rng.standard_normal((4, 4, 3), dtype=np.float32)

    def apply_np(x_t, tv, lib):
        return x_t * w + lib.reshape(tv, (-1, 1, 1, 1)) / 1000.0

    sched_j = make_schedule()
    wl = DDPMWorkload.from_config(load_config(SFRON), torch.float32, "cpu")
    for keepdim in (True, False):
        got = TL.noise_estimation_loss(
            lambda a, b: a * _t(w) + b.reshape(-1, 1, 1, 1) / 1000.0,
            wl.schedule, _t(x0), _t(t), _t(noise), keepdim=keepdim)
        want = JL.noise_estimation_loss(
            lambda a, b: apply_np(a, b, jnp), sched_j, x0, t, noise,
            keepdim=keepdim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    per = np.abs(rng.standard_normal(8).astype(np.float32)) * 100
    for lambd, eps in ((0.5, 1e-8), (1.0, 1e-15)):
        np.testing.assert_allclose(
            TL.adaptive_weights(_t(per), lambd, eps).numpy(),
            np.asarray(JL.adaptive_weights(per, lambd, eps)), **F32)
        np.testing.assert_allclose(
            TL.adaptive_loss(_t(per), lambd, eps).numpy(),
            np.asarray(adaptive_loss(per, lambd, eps)), rtol=1e-5)
    # the weights are detached: the gradient is the weights over the batch
    pt = _t(per).requires_grad_()
    TL.adaptive_loss(pt, 0.5).backward()
    np.testing.assert_allclose(pt.grad.numpy(),
                               TL.adaptive_weights(_t(per), 0.5).numpy() / 8,
                               **F32)
    for step in (0, 7, 150):
        np.testing.assert_allclose(
            TL.cosine_alpha_decay(10.0, step, 150),
            float(JL.cosine_alpha_decay(10.0, step, 150)), rtol=1e-6)
        for p in (1.0, 2.0):
            np.testing.assert_allclose(
                TL.linear_alpha_decay(10.0, step, 150, p),
                float(JL.linear_alpha_decay(10.0, step, 150, p)), rtol=1e-6)


def _mask_pair(seed, shapes=((3, 5), (17,), (2, 3, 4, 7), (1,))):
    rng = np.random.default_rng(seed)
    masks = {f"m{i}": rng.random(s) < 0.5 for i, s in enumerate(shapes)}
    return masks, {k: torch.from_numpy(v) for k, v in masks.items()}


def test_pack_mask_is_byte_identical_to_jax():
    masks_np, masks_t = _mask_pair(0)
    mine = TT.pack_mask(masks_t)
    ref = JT.pack_mask({k: jnp.asarray(v) for k, v in masks_np.items()})
    for k in masks_np:
        assert mine[k].shape == ref[k].shape
        np.testing.assert_array_equal(mine[k].bits.numpy(),
                                      np.asarray(ref[k].bits))
        np.testing.assert_array_equal(mine[k].unpack(torch.bool).numpy(),
                                      masks_np[k])
    assert TT.sparsity(mine) == pytest.approx(float(JT.sparsity(ref)))
    assert TT.sparsity(masks_t) == pytest.approx(float(JT.sparsity(ref)))
    rng = np.random.default_rng(1)
    grads_np = {k: rng.standard_normal(v.shape, dtype=np.float32)
                for k, v in masks_np.items()}
    want = JT.tree_mul(grads_np, ref)
    for mask in (mine, masks_t):
        grads = {k: torch.from_numpy(v.copy()) for k, v in grads_np.items()}
        TT.tree_mul_(grads, mask)
        for k in grads:
            np.testing.assert_array_equal(grads[k].numpy(),
                                          np.asarray(want[k]))


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(2)
    grads_np = {"a": rng.standard_normal((40, 30), dtype=np.float32),
                "b": rng.standard_normal(7, dtype=np.float32)}
    want, want_norm = JT.clip_by_global_norm(grads_np, max_norm)
    grads = {k: torch.from_numpy(v.copy()) for k, v in grads_np.items()}
    norm = TT.clip_by_global_norm_(grads, max_norm)
    np.testing.assert_allclose(norm.numpy(), np.asarray(want_norm), **F32)
    np.testing.assert_allclose(TT.global_norm(grads).numpy(),
                               np.asarray(JT.global_norm(want)), **F32)
    for k in grads:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(want[k]),
                                   **F32)


def test_ema_update_and_fast_slow_mix_match_jax():
    rng = np.random.default_rng(3)
    p, s = ([rng.standard_normal((5, 4), dtype=np.float32) for _ in range(2)]
            for _ in range(2))
    shadow = [torch.from_numpy(a.copy()) for a in s]
    TE.ema_update(shadow, [torch.from_numpy(a) for a in p], 1e-4)
    for got, want in zip(shadow, JE.ema_update(s, p, 1e-4)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    new = [torch.from_numpy(a.copy()) for a in p]
    TE.fast_slow_mix(new, [torch.from_numpy(a) for a in s], 0.3)
    for got, want in zip(new, JE.fast_slow_mix(p, s, 0.3)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    bf16 = [torch.from_numpy(a).to(torch.bfloat16) for a in s]
    TE.ema_update(bf16, [torch.from_numpy(a) for a in p], 0.5)
    assert all(t.dtype == torch.bfloat16 for t in bf16)   # stays in its dtype


def _optax_state(state, kind):
    leaves = jax.tree_util.tree_leaves(
        state, is_leaf=lambda n: isinstance(n, kind))
    return next(n for n in leaves if isinstance(n, kind))


@pytest.mark.parametrize("name,wd", [("adam", 0.0), ("adam", 0.05),
                                     ("adamw", 0.05), ("sgd", 0.05)])
def test_optimizers_match_optax(name, wd):
    rng = np.random.default_rng(4)
    params_np = {"w": rng.standard_normal((6, 5), dtype=np.float32),
                 "b": rng.standard_normal(5, dtype=np.float32)}
    opt_j = JO.make_optimizer(name, 1e-2, weight_decay=wd, eps=1e-8)
    state_j = opt_j.init(params_np)
    params_j = params_np
    params_t = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                for k, v in params_np.items()}
    opt_t = TO.make_optimizer(name, params_t.values(), 1e-2, weight_decay=wd,
                              eps=1e-8)
    sched = TO.cosine_annealing(1e-2, 5)
    for step in range(5):
        grads = {k: rng.standard_normal(v.shape, dtype=np.float32)
                 for k, v in params_np.items()}
        state_j.hyperparams["learning_rate"] = JO.cosine_annealing(1e-2, 5)(step)
        upd, state_j = opt_j.update(grads, state_j, params_j)
        params_j = optax.apply_updates(params_j, upd)
        TO.set_lr(opt_t, sched(step))
        for k, p in params_t.items():
            p.grad = torch.from_numpy(grads[k])
        opt_t.step()
        for k, p in params_t.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params_j[k]), **F32)
    if name == "sgd":
        trace = _optax_state(state_j, optax.TraceState).trace
        for k, p in params_t.items():
            np.testing.assert_allclose(opt_t.state[p]["momentum_buffer"],
                                       np.asarray(trace[k]), **F32)
    else:
        adam = _optax_state(state_j, optax.ScaleByAdamState)
        for k, p in params_t.items():
            np.testing.assert_allclose(opt_t.state[p]["exp_avg"],
                                       np.asarray(adam.mu[k]), **F32)
            np.testing.assert_allclose(opt_t.state[p]["exp_avg_sq"],
                                       np.asarray(adam.nu[k]), **F32)
            assert int(opt_t.state[p]["step"]) == int(adam.count) == 5


def test_optimizer_refuses_unported_knobs():
    # mu_dtype, nu_dtype and amsgrad are ported (tests/test_torch_optim.py
    # holds them against optax); what the JAX package refuses stays
    # refused: amsgrad with a reduced-precision second moment, and an
    # optimizer it does not build
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(NotImplementedError, match="nu_dtype"):
        TO.make_optimizer("adam", p, 1e-3, amsgrad=True,
                          nu_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="rmsprop"):
        TO.make_optimizer("rmsprop", p, 1e-3)


# -- the step on the tiny CondUNet -----------------------------------------

@pytest.fixture(scope="module")
def tiny():
    _, params = JU.init_unet(jax.random.key(0),
                             JU.UNetConfig(dtype=jnp.float32, **TINY))
    jmodel = JU.CondUNet(JU.UNetConfig(dtype=jnp.float32, **TINY))
    return params, jmodel


def _port_model(params):
    model = TU.CondUNet(TU.UNetConfig(dtype=torch.float32, **TINY))
    model.load_state_dict(jax_unet_params_to_torch(params), strict=True)
    return model


def _batch(seed, n=4, keep_all=False):
    """(x, c, t, noise, keep) made with numpy: both packages read them."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)
    c = rng.integers(0, 10, n).astype(np.int64)
    t = rng.integers(0, 1000, n).astype(np.int64)
    noise = rng.standard_normal((n, 32, 32, 3), dtype=np.float32)
    keep = np.ones(n, bool) if keep_all else rng.random(n) >= 0.3
    return x, c, t, noise, keep


def _jax_per_sample(jmodel, sched):
    def per(params, batch):
        x, c, t, noise, keep = batch
        return JL.noise_estimation_loss(
            lambda x_t, tv: jmodel.apply({"params": params}, x_t, tv, c,
                                         keep),
            sched, x, t, noise, keepdim=True)
    return per


def _torch_per_sample(wl):
    def per(model, batch):
        x, c, t, noise, keep = batch
        return wl.per_sample_eps_loss(model, x, c, t, noise, keep)
    return per


def test_per_sample_eps_loss_and_adaga_match_jax(tiny, tmp_path):
    params, jmodel = tiny
    batch = _batch(7)
    want = np.asarray(_jax_per_sample(jmodel, make_schedule())(params, batch))
    wl = DDPMWorkload.from_config(_tiny_config(tmp_path), torch.float32, "cpu")
    got = _torch_per_sample(wl)(_port_model(params).eval(),
                                tuple(_t(a) for a in batch))
    # fp32 forward of ~20 layers (the UNet test's tolerance), then a sum of
    # 3072 squares per sample
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4)
    np.testing.assert_allclose(
        -TL.adaptive_loss(got, wl.lambd, eps=1e-8).item(),
        float(-adaptive_loss(want, 0.5, eps=1e-8)), rtol=1e-4)


@pytest.mark.parametrize("method", ["ron", "joint"])
def test_three_sfron_steps_match_jax(tiny, tmp_path, method):
    # SGD with momentum: Adam would turn the gradients that are zero in
    # exact arithmetic (conv biases before a GroupNorm, the attention k
    # bias: ~1e-9 of rounding noise) into +-lr updates of random sign on
    # both sides; Adam itself is held to optax above
    params, jmodel = tiny
    rng = np.random.default_rng(11)
    mask_j = jax.tree_util.tree_map(
        lambda p: (rng.random(p.shape) < 0.6).astype(np.float32), params)
    cfg_kw = dict(n_iters=3, forget_alpha=2.0, alpha_sched="cosine",
                  method=method, ema_mu=0.5, forget_clip=1.0, remain_clip=1.0)
    lr = 1e-2
    sched = make_schedule()
    per_j = _jax_per_sample(jmodel, sched)
    opt_j = JO.make_optimizer("sgd", lr, momentum=0.9)
    step_j = JS.make_sfron_step(
        JS.SFRonConfig(**cfg_kw), opt_j,
        lambda p, b, k: -adaptive_loss(per_j(p, b), 0.5, eps=1e-8),
        lambda p, b, k: per_j(p, b).mean(), donate=False)
    state_j = JS.init_state(params, opt_j, ema=True, mask=mask_j)

    wl = DDPMWorkload.from_config(_tiny_config(tmp_path), torch.float32, "cpu")
    per_t = _torch_per_sample(wl)
    model = _port_model(params).train()
    opt_t = TO.make_optimizer("sgd", model.parameters(), lr, momentum=0.9)
    step_t = TS.make_sfron_step(
        TS.SFRonConfig(**cfg_kw),
        lambda m, b, g: -TL.adaptive_loss(per_t(m, b), 0.5, eps=1e-8),
        lambda m, b, g: per_t(m, b).mean())
    state_t = TS.init_state(model, opt_t, ema=True,
                            mask=jax_unet_params_to_torch(mask_j))
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        fb, rb = _batch(100 + i, keep_all=i == 0), _batch(200 + i)
        state_j, mj = step_j(state_j, fb, rb, jax.random.key(0))
        mt = step_t(state_t, tuple(_t(a) for a in fb),
                    tuple(_t(a) for a in rb), gen)
        for k in ("forget_loss", "remain_loss", "remain_grad_norm"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-4,
                                       err_msg=k)
        np.testing.assert_allclose(mt["forget_alpha"],
                                   float(mj["forget_alpha"]), rtol=1e-6)
    assert state_t.step == int(state_j.step) == 3

    def flat(tree):
        return torch.cat([v.reshape(-1) for v in tree.values()])

    names = list(start)
    want_p = jax_unet_params_to_torch(state_j.params)
    want_ema = jax_unet_params_to_torch(state_j.ema_params)
    trace = jax_unet_params_to_torch(
        _optax_state(state_j.opt_state, optax.TraceState).trace)
    got_p = dict(model.named_parameters())
    got_ema = dict(state_t.ema_model.named_parameters())
    # the update (params - start) is held to its norm: 3 steps of fp32
    # gradients through ~20 layers, each differing at ~1e-5 relative
    for got, want in ((got_p, want_p), (got_ema, want_ema)):
        delta_t = flat({k: got[k].detach() - start[k] for k in names})
        delta_j = flat({k: want[k] - start[k] for k in names})
        assert delta_j.norm() > 0
        assert ((delta_t - delta_j).norm() / delta_j.norm()) < 1e-3
        for k in names:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       want[k].numpy(), atol=1e-5, err_msg=k)
    buf = flat({k: opt_t.state[got_p[k]]["momentum_buffer"] for k in names})
    ref = flat({k: trace[k] for k in names})
    assert ((buf - ref).norm() / ref.norm()) < 1e-3
    # the forget gradient is masked: entries the mask zeroes get only the
    # remain phase's updates, so the forget step moved masked-off entries
    # of no parameter (ron); joint masks the combined gradient
    if method == "joint":
        mask_t = jax_unet_params_to_torch(mask_j)
        for k in names:
            off = mask_t[k] == 0
            assert torch.equal(got_p[k].detach()[off], start[k][off]), k


def test_stack_microbatches_and_grad_accum(tiny, tmp_path):
    # two microbatches of 2 give the step of one batch of 4 (mean losses)
    params, _ = tiny
    wl = DDPMWorkload.from_config(_tiny_config(tmp_path), torch.float32, "cpu")
    per_t = _torch_per_sample(wl)
    b4 = tuple(_t(a) for a in _batch(5))
    halves = [tuple(a[:2] for a in b4), tuple(a[2:] for a in b4)]
    stacked = next(TS.stack_microbatches(iter(halves), 2))
    assert stacked[0].shape == (2, 2, 32, 32, 3)
    out = []
    for accum, batch in ((1, b4), (2, stacked)):
        model = _port_model(params).train()
        opt = TO.make_optimizer("sgd", model.parameters(), 1e-2, momentum=0.0)
        step = TS.make_sfron_step(
            TS.SFRonConfig(n_iters=1, forget_alpha=0.0, alpha_sched="const",
                           remain_clip=None, grad_accum=accum),
            None, lambda m, b, g: per_t(m, b).mean())
        state = TS.init_state(model, opt)
        m = step(state, batch, batch, torch.Generator())
        out.append((m["remain_loss"].item(), m["remain_grad_norm"].item()))
    np.testing.assert_allclose(out[0], out[1], rtol=1e-5)
    assert list(TS.stack_microbatches(iter(halves[:1]), 2)) == []


# -- data ------------------------------------------------------------------

def test_data_pipeline_matches_jax():
    mine = TD.synthetic_dataset(96, base_seed=0)
    ref = JD.synthetic_dataset(96, base_seed=0)
    np.testing.assert_array_equal(mine.images, ref.images)
    np.testing.assert_array_equal(mine.labels, ref.labels)
    mine_legacy, ref_legacy = (f(40, seed=3, class_affinity=0.4)
                               for f in (TD.synthetic_dataset,
                                         JD.synthetic_dataset))
    np.testing.assert_array_equal(mine_legacy.images, ref_legacy.images)
    (mr, mf), (jr, jf) = class_forget_split(mine, 0), jax_split(ref, 0)
    for a, b in ((mr, jr), (mf, jf)):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
    assert len(mf) < 32                              # exercises the wrap
    for ds_m, ds_j in ((mr, jr), (mf, jf)):
        it_m = TA.infinite_batches(ds_m, 32, seed=5,
                                   transform=TA.random_flip_batch)
        it_j = JA.infinite_batches(ds_j, 32, seed=5,
                                   transform=JA.random_flip_batch)
        for _ in range(4):
            (xm, cm), (xj, cj) = next(it_m), next(it_j)
            assert xm.shape == (32, 32, 32, 3)
            np.testing.assert_array_equal(xm, xj)
            np.testing.assert_array_equal(cm, cj)
    for (xm, cm), (xj, cj) in zip(
            TA.epoch_batches(mine, 40, shuffle=True, seed=1),
            JA.epoch_batches(ref, 40, shuffle=True, seed=1)):
        np.testing.assert_array_equal(xm, xj)
        np.testing.assert_array_equal(cm, cj)


# -- runner and CLI ---------------------------------------------------------

class _Args:
    seed = 0
    ckpt_folder = None
    label_to_forget = 0
    forget_alpha = 10.0
    method = "ron"
    unlearn_loss = "adaga"


def _adam_steps(state):
    return {int(s["step"]) for s in state.optimizer.state.values()}


def test_sfron_forget_and_pretrain_on_cpu_with_resume(tmp_path):
    cfg = _tiny_config(tmp_path)
    wl = DDPMWorkload.from_config(cfg, device="cpu")
    init = wl.init_params(_Args.seed)
    rng = np.random.default_rng(0)
    mask = TT.pack_mask({k: torch.from_numpy(rng.random(p.shape) < 0.5)
                         for k, p in init.named_parameters()})
    ckpt = tmp_path / "run" / "ckpts"
    state = TR.sfron_forget(_Args, cfg, str(ckpt), mask=mask, device="cpu")
    assert state.step == 3 and _adam_steps(state) == {6}   # two phases a step
    for (k, p), e, p0 in zip(state.model.named_parameters(),
                             state.ema_model.parameters(), init.parameters()):
        assert torch.isfinite(p).all(), k
    moved = [not torch.equal(p, p0) for p, p0 in
             zip(state.model.parameters(), init.parameters())]
    assert sum(moved) > len(moved) // 2
    assert not all(torch.equal(e, p0) for e, p0 in
                   zip(state.ema_model.parameters(), init.parameters()))
    assert (ckpt / "ckpt.pth").exists()

    # resume: the same run with more iterations starts at step 3
    state2 = TR.sfron_forget(_Args, cfg.merged({"training": {"n_iters": 5}}),
                             str(ckpt), mask=mask, device="cpu")
    assert state2.step == 5 and _adam_steps(state2) == {10}

    # the trainer's checkpoint serves the sampler (EMA shadow)
    class Run:
        ckpt_folder = str(tmp_path / "run")
        seed = 0

    model = TR.load_params(Run, cfg, wl, use_ema=True)
    for a, b in zip(model.parameters(), state2.ema_model.parameters()):
        assert torch.equal(a, b)
    imgs = TR.sample_images(Run, cfg, model, np.arange(3), num_steps=1)
    assert imgs.shape == (3, 32, 32, 3) and imgs.dtype == np.uint8

    # pretrain skips the forget phase: one Adam step per iteration
    pre = TR.pretrain(_Args, cfg, str(tmp_path / "pre"), device="cpu")
    assert pre.step == 3 and _adam_steps(pre) == {3}


def test_train_cli_sfron_on_cpu(tmp_path):
    pytest.importorskip("yaml")
    pytest.importorskip("PIL")
    import yaml

    from uurg_torch.cli import train as cli

    cfg = _tiny_config(tmp_path, n_iters=2, visualization_samples=10)
    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))
    common = ["--config", str(cfg_path), "--exp", str(tmp_path / "exp"),
              "--device", "cpu", "--timesteps", "1"]
    cli.main(common + ["--mode", "sfron", "--forget_alpha", "5"])
    runs = list((tmp_path / "exp").rglob("ckpt.pth"))
    assert len(runs) == 1 and "forget_0" in str(runs[0])
    assert list((tmp_path / "exp").rglob("samples_step00001.png"))
    # the Fisher mode runs (it raised before its slice) and writes the
    # JAX runner's file names under the run directory
    cli.main(common + ["--mode", "generate_fisher"])
    assert {p.name for p in (tmp_path / "exp").rglob("mask_0/*")} == {
        "forget_fisher", "remain_fisher", "fisher_1.0"}
    # the SA mode runs (it raised before its slice) from a fisher_dict in
    # --ckpt_folder and writes its ckpt.pth under a run directory of its own
    from uurg_torch.io.checkpoint import save_checkpoint

    wl = DDPMWorkload.from_config(cfg, device="cpu")
    save_checkpoint(str(tmp_path / "sa" / "fisher_dict"), {
        k: torch.rand(p.shape) for k, p in
        wl.init_params(0).named_parameters()})
    cli.main(common + ["--mode", "sa", "--ckpt_folder", str(tmp_path / "sa")])
    after = list((tmp_path / "exp").rglob("ckpt.pth"))
    assert len(after) == 2 and runs[0] in after


@pytest.mark.parametrize("grid_fails", [False, True])
def test_train_cli_sfron_without_ema_writes_its_grid(tmp_path, monkeypatch,
                                                     caplog, grid_fails):
    """With ``model.ema: false`` the snapshot grid samples the model being
    trained: in eval mode (training-mode dropout would need a generator),
    and back in training mode after. A grid that fails is logged as a
    warning and the run still finishes, as in the JAX package's CLI."""
    pytest.importorskip("yaml")
    pytest.importorskip("PIL")
    import logging

    import yaml

    from uurg_torch.cli import train as cli
    from uurg_torch.workloads import ddpm_runner as R

    cfg = _tiny_config(tmp_path, n_iters=2, visualization_samples=10)
    cfg = cfg.merged({"model": {"ema": False}})
    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))
    modes = []
    sample = R.sample_images

    def spy(args, config, model, *a, **k):
        modes.append(model.training)
        if grid_fails:
            raise RuntimeError("injected grid failure")
        return sample(args, config, model, *a, **k)

    monkeypatch.setattr(R, "sample_images", spy)
    with caplog.at_level(logging.WARNING, logger="uurg_torch.train"):
        cli.main(["--config", str(cfg_path), "--exp", str(tmp_path / "exp"),
                  "--device", "cpu", "--timesteps", "1", "--mode", "sfron",
                  "--n_iters", "2"])
    assert modes == [True]                 # the trained model, mid-run
    assert len(list((tmp_path / "exp").rglob("ckpt.pth"))) == 1
    grids = list((tmp_path / "exp").rglob("samples_step00001.png"))
    warned = [r for r in caplog.records if "snapshot grid" in r.getMessage()]
    if grid_fails:
        assert not grids and len(warned) == 1
        assert "injected grid failure" in caplog.text
    else:
        assert len(grids) == 1 and not warned


def test_sample_images_runs_in_eval_mode_and_restores_training(tmp_path):
    cfg = _tiny_config(tmp_path)
    wl = DDPMWorkload.from_config(cfg, device="cpu")
    model = wl.init_params(0).train()
    imgs = TR.sample_images(_Args, cfg, model, np.arange(2), num_steps=1,
                            batch_size=2)
    assert imgs.shape == (2, 32, 32, 3) and model.training
    model.eval()
    TR.sample_images(_Args, cfg, model, np.arange(2), num_steps=1,
                     batch_size=2)
    assert not model.training


@pytest.mark.parametrize("flag", [["--skip_type", "quad"], ["--eta", "1"],
                                  ["--uc", "false"],
                                  ["--negative_guidance", "2"],
                                  ["--sparse", "true"]])
def test_train_cli_unread_flag_raises(flag):
    """A parity flag that no mode reads raises at a value other than its
    default instead of being ignored."""
    from uurg_torch.cli import train as cli

    with pytest.raises(NotImplementedError, match=flag[0]):
        cli.main(["--config", "unused.yml", "--mode", "sfron",
                  "--device", "cpu"] + flag)


@pytest.mark.parametrize("mode,flag,names", [
    ("generate_fisher", ["--threshold", "0.5", "2.0"],
     {"forget_fisher", "remain_fisher", "fisher_0.5", "fisher_2.0"}),
    ("generate_mask", ["--mask_ratio", "0.3", "0.5"],
     {"with_0.3", "with_0.5"})])
def test_train_cli_mask_flags_are_read(tmp_path, mode, flag, names):
    """--threshold and --mask_ratio (raised as unread before the Fisher
    slice) give one mask file each, under the JAX runner's names."""
    pytest.importorskip("yaml")
    import yaml

    from uurg_torch.cli import train as cli

    cfg = _tiny_config(tmp_path, batch_size=16)
    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))
    folder = tmp_path / "pre"
    cli.main(["--config", str(cfg_path), "--exp", str(tmp_path / "exp"),
              "--device", "cpu", "--ckpt_folder", str(folder),
              "--mode", mode] + flag)
    sub = "mask_0" if mode == "generate_fisher" else "salun_mask_0"
    assert set(os.listdir(folder / sub)) == names
