"""The port's Selective Amnesia slice vs the JAX package (CPU, fp32): the SA
loss and its gradients, the per-sample Fisher, one SA step, the image-folder
loader, and the fim CLI and ``--mode sa`` end to end.

Each parity test gives the JAX function its real key, recomputes that key's
draws with the same ``jax.random`` calls the function makes, and hands the
draws to the port."""
import logging
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from uurg_torch.core.config import load_config  # noqa: E402
from uurg_torch.core.rng import antithetic_timesteps  # noqa: E402
from uurg_torch.data import datasets as TD  # noqa: E402
from uurg_torch.io import checkpoint as CK  # noqa: E402
from uurg_torch.io.jax_interop import (jax_unet_params_to_torch,  # noqa: E402
                                       load_reference_checkpoint)
from uurg_torch.models import unet_cond as TU  # noqa: E402
from uurg_torch.train import optim as TO  # noqa: E402
from uurg_torch.unlearn import fisher as TF  # noqa: E402
from uurg_torch.unlearn import sfron as TS  # noqa: E402
from uurg_torch.workloads import ddpm as TW  # noqa: E402
from uurg_torch.workloads import ddpm_runner as TR  # noqa: E402
from uurg_tpu.core import tree as JT  # noqa: E402
from uurg_tpu.core.config import Config as JConfig  # noqa: E402
from uurg_tpu.core.rng import antithetic_timesteps as jax_antithetic  # noqa: E402
from uurg_tpu.data import datasets as JD  # noqa: E402
from uurg_tpu.train import optim as JO  # noqa: E402
from uurg_tpu.unlearn import fisher as JF  # noqa: E402
from uurg_tpu.workloads import ddpm as JW  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SA = os.path.join(ROOT, "configs", "cifar10_sa.yml")
LABEL, GAMMA, LMBDA = 3, 0.7, 10.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: under pytest-xdist the
    suite runs several worker processes on one host, and torch's default
    of one thread a core in each oversubscribes the cores several times
    over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny_config(tmp_path, timesteps=1000, **training):
    """configs/cifar10_sa.yml cut to the tiny CondUNet (ch 32, ch_mult 1-2,
    one res block, attention at 16x16) and the synthetic stand-in."""
    cfg = load_config(SA)
    model = {**cfg.model.to_dict(), "ch": 32, "ch_mult": [1, 2],
             "num_res_blocks": 1}
    train = {**cfg.training.to_dict(), "batch_size": 4, "n_iters": 2,
             "snapshot_freq": 10, "log_freq": 1, **training}
    data = {**cfg.data.to_dict(), "path": str(tmp_path / "no_cifar"),
            "synthetic_n": 64}
    diffusion = {**cfg.diffusion.to_dict(),
                 "num_diffusion_timesteps": timesteps}
    return cfg.merged({"model": model, "training": train, "data": data,
                       "diffusion": diffusion})


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The JAX workload and its seeded params, the port's workload (fp32,
    CPU) on the same config, and the JAX SA loss's value and gradient."""
    cfg = _tiny_config(tmp_path_factory.mktemp("cfg"))
    jwl = JW.DDPMWorkload.from_config(JConfig(cfg.to_dict()),
                                      dtype=jnp.float32)
    params = jwl.init_params(jax.random.key(0))
    wl = TW.DDPMWorkload.from_config(cfg, torch.float32, "cpu")
    # one compiled program for both tests that hold the SA loss
    sa_grad = jax.jit(jax.value_and_grad(jwl.sa_loss_fn(LABEL, GAMMA, LMBDA)))
    return jwl, params, wl, sa_grad


def _port_model(wl, params):
    model = TU.CondUNet(wl.unet_cfg)
    model.load_state_dict(jax_unet_params_to_torch(params), strict=True)
    return model.eval()


def _aux(params, seed=1):
    """A non-trivial Fisher (entries over four decades) and MLE params
    perturbed off ``params``: at ``params_mle == params`` the EWC pull and
    its gradient would be exactly zero and test nothing."""
    rng = np.random.default_rng(seed)
    fisher = jax.tree_util.tree_map(
        lambda p: (10.0 ** rng.uniform(-3, 1, p.shape)).astype(np.float32),
        params)
    mle = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.02 * rng.standard_normal(p.shape)
                   ).astype(np.float32), params)
    return fisher, mle


def _remember_batch(seed, n=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)
    c = rng.integers(0, 10, n).astype(np.int64)
    return x, c


def _jax_sa_draws(key, shape, T=1000):
    """The draws of the JAX sa_loss_fn (uurg_tpu/workloads/ddpm.py:
    159-175), recomputed from its key by the same calls."""
    k_u, k_t, k_ef, k_er = jax.random.split(key, 4)
    x_forget = jax.random.uniform(k_u, shape, jnp.float32, -1.0, 1.0)
    t = jax_antithetic(k_t, shape[0], T)
    noise_f = jax.random.normal(k_ef, shape, jnp.float32)
    noise_r = jax.random.normal(k_er, shape, jnp.float32)
    return tuple(torch.from_numpy(np.array(a)) for a in
                 (x_forget, t, noise_f, noise_r))


def _torch_tree(tree):
    return jax_unet_params_to_torch(tree)


def _flat(tree, names):
    return torch.cat([tree[k].reshape(-1).float() for k in names])


def _hold_tree(got, want, tol):
    """Relative L2 of all leaves concatenated within ``tol``; per leaf the
    same bound on leaves above the noise floor (leaves whose exact gradient
    is zero hold only rounding noise on both sides)."""
    names = list(want)
    g, w = _flat(got, names), _flat(want, names)
    assert w.norm() > 0
    assert ((g - w).norm() / w.norm()).item() <= tol
    floor = 1e-6 * w.norm()
    held = 0
    for k in names:
        wk = want[k].float()
        if wk.norm() > floor:
            held += 1
            assert ((got[k].float() - wk).norm() / wk.norm()).item() <= tol, k
    assert held > len(names) // 2


# -- the SA loss --------------------------------------------------------------

def test_sa_loss_value_and_gradients_match_jax(tiny):
    jwl, params, wl, sa_grad = tiny
    fisher_j, mle_j = _aux(params)
    x, c = _remember_batch(2)
    key = jax.random.key(5)
    want, want_g = sa_grad(params, (x, c.astype(np.int32)), key,
                           (fisher_j, mle_j))
    draws = _jax_sa_draws(key, x.shape)
    model = _port_model(wl, params)
    fisher, mle = _torch_tree(fisher_j), _torch_tree(mle_j)
    batch = (torch.from_numpy(x), torch.from_numpy(c))
    got = wl.sa_loss(model, batch, *draws, fisher, mle, LABEL, GAMMA, LMBDA)
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(got, leaves)))
    # fp32 forwards of ~20 layers (the UNet test's tolerance), sums of
    # 3072 squares a sample and of ~1e6 EWC terms
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    _hold_tree(grads, _torch_tree(want_g), 1e-4)

    # the EWC pull alone: its value in float64, its gradient 2 F (p - m)
    ewc = TW.ewc_penalty(model, fisher, mle)
    ref = sum(float((fisher[k].double() * (p.detach().double() - mle[k])
                     ** 2).sum()) for k, p in model.named_parameters())
    assert ewc.item() > 0
    np.testing.assert_allclose(ewc.item(), ref, rtol=1e-5)
    g_ewc = torch.autograd.grad(LMBDA * ewc, leaves)
    for k, p, g in zip(names, leaves, g_ewc):
        torch.testing.assert_close(
            g, 2 * LMBDA * fisher[k] * (p.detach() - mle[k]))

    # sa_loss_fn draws, in order: forget images, t, forget noise, remember
    # noise, from the generator it is given
    gen = torch.Generator().manual_seed(9)
    twin = torch.Generator().manual_seed(9)
    x_forget = torch.rand(x.shape, generator=twin) * 2 - 1
    t = antithetic_timesteps(twin, 4, 1000)
    nf, nr = (torch.randn(x.shape, generator=twin) for _ in range(2))
    with torch.no_grad():
        drawn = wl.sa_loss_fn(LABEL, GAMMA, LMBDA, fisher, mle)(model, batch,
                                                                gen)
        given = wl.sa_loss(model, batch, x_forget, t, nf, nr, fisher, mle,
                           LABEL, GAMMA, LMBDA)
    assert torch.equal(drawn, given)
    assert x_forget.min() >= -1 and x_forget.max() < 1


# -- the per-sample Fisher ----------------------------------------------------

def test_per_sample_fisher_matches_jax(tiny):
    # 2 timestep chunks of 8 x 2 batches (sizes 2 and 1, ragged), the JAX
    # fim CLI's key flow; squared gradients agree to twice the gradients'
    # fp32 rounding
    jwl, params, wl, _ = tiny
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    c = rng.integers(0, 10, 3).astype(np.int64)
    jstep = JF.make_per_sample_fisher_step(jwl.elbo_chunk_loss_fn())
    fisher_j = JT.tree_zeros_like(params)
    key = jax.random.key(7)
    model = _port_model(wl, params)
    tstep = TF.make_per_sample_fisher_step(
        lambda m, ex, g: wl.elbo_chunk_loss(m, *ex))
    fisher_t = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    for ci in range(2):
        ts = np.arange(ci * 8, (ci + 1) * 8, dtype=np.int32)
        for sl in (slice(0, 2), slice(2, 3)):
            xb, cb = x[sl], c[sl]
            n = len(xb)
            rngs = jax.random.split(key, n)
            key = jax.random.fold_in(key, 1)
            ts_b = np.broadcast_to(ts, (n, 8))
            fisher_j = jstep(fisher_j, params,
                             (xb, cb.astype(np.int32), ts_b), rngs)
            noise = np.stack([np.asarray(jax.random.normal(
                rngs[i], (8,) + xb.shape[1:])) for i in range(n)])
            tstep(fisher_t, model,
                  tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                        (xb, cb, ts_b.astype(np.int64), noise)), seed=0)
    fisher_j = JT.tree_scale(fisher_j, 0.5)
    torch._foreach_mul_(list(fisher_t.values()), 0.5)
    assert all(p.grad is None for p in model.parameters())
    _hold_tree(fisher_t, _torch_tree(fisher_j), 1e-4)


def test_elbo_chunk_loss_fn_draws_per_example(tiny):
    # the integrand draws its (chunk, H, W, C) noise from the generator;
    # the step seeds example i from step_seed(seed, i), so a batch is a
    # function of (seed, batch) alone
    jwl, params, wl, _ = tiny
    model = _port_model(wl, params)
    x = torch.rand(2, 32, 32, 3) * 2 - 1
    c = torch.tensor([1, 4])
    ts = torch.arange(4, 8).expand(2, 4)
    gen = torch.Generator().manual_seed(3)
    twin = torch.Generator().manual_seed(3)
    with torch.no_grad():
        drawn = wl.elbo_chunk_loss_fn()(model, (x[0], c[0], ts[0]), gen)
        given = wl.elbo_chunk_loss(model, x[0], c[0], ts[0],
                                   torch.randn((4, 32, 32, 3), generator=twin))
    assert torch.equal(drawn, given)
    step = TF.make_per_sample_fisher_step(wl.elbo_chunk_loss_fn())

    def run(seed):
        f = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        step(f, model, (x, c, ts), seed)
        return f

    a, b, other = run(11), run(11), run(12)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], other[k]) for k in a)


# -- one SA step --------------------------------------------------------------

def test_one_sa_step_under_sgd_matches_jax(tiny):
    # clip, update and EMA lerp of one step, against the same step
    # assembled from the JAX package's parts (uurg_tpu/workloads/
    # ddpm_runner.py:372-382). SGD: Adam would turn the ~1e-9 rounding noise
    # of gradients that are zero in exact arithmetic into +-lr updates
    jwl, params, wl, sa_grad = tiny
    fisher_j, mle_j = _aux(params, seed=3)
    x, c = _remember_batch(6)
    key = jax.random.key(8)
    lr, mu, clip = 1e-2, 0.9, 1.0
    want_loss, grads = sa_grad(params, (x, c.astype(np.int32)), key,
                               (fisher_j, mle_j))
    grads, want_norm = JT.clip_by_global_norm(grads, clip)
    opt_j = JO.make_optimizer("sgd", lr, momentum=0.9)
    updates, _ = opt_j.update(grads, opt_j.init(params), params)
    new_j = jax.tree_util.tree_map(jnp.add, params, updates)
    ema_j = JT.tree_lerp(new_j, params, mu)

    draws = _jax_sa_draws(key, x.shape)
    model = _port_model(wl, params)
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt_t = TO.make_optimizer("sgd", model.parameters(), lr, momentum=0.9)
    state = TS.init_state(model, opt_t, ema=True)
    # sa_forget's step: the SFR-on engine with forgetting off
    cfg = TS.SFRonConfig(n_iters=1, forget_alpha=0.0, alpha_sched="const",
                         forget_clip=None, remain_clip=clip, ema_mu=mu)
    fisher, mle = _torch_tree(fisher_j), _torch_tree(mle_j)
    step = TS.make_sfron_step(
        cfg, None, lambda m, b, g: wl.sa_loss(m, b, *draws, fisher, mle,
                                              LABEL, GAMMA, LMBDA))
    batch = (torch.from_numpy(x), torch.from_numpy(c))
    metrics = step(state, batch, batch, torch.Generator())
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["remain_loss"]),
                               float(want_loss), rtol=1e-4)
    np.testing.assert_allclose(float(metrics["remain_grad_norm"]),
                               float(want_norm), rtol=1e-4)
    assert float(want_norm) > clip              # the clip bites
    names = list(start)
    got_p = dict(model.named_parameters())
    got_ema = dict(state.ema_model.named_parameters())
    for got, want in ((got_p, _torch_tree(new_j)),
                      (got_ema, _torch_tree(ema_j))):
        delta_t = torch.cat([(got[k].detach() - start[k]).reshape(-1)
                             for k in names])
        delta_j = torch.cat([(want[k] - start[k]).reshape(-1)
                             for k in names])
        assert delta_j.norm() > 0
        assert ((delta_t - delta_j).norm() / delta_j.norm()) < 1e-3
        for k in names:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       want[k].numpy(), atol=1e-5, err_msg=k)


# -- the image-folder loader --------------------------------------------------

def _png_folder(root, sizes):
    """Class subdirectories of RGB PNGs (and a JPEG), with a stray file at
    the top and a non-image file in a class: ``sizes`` maps a class name to
    (width, height) of each of its images."""
    from PIL import Image

    rng = np.random.default_rng(12)
    root.mkdir(parents=True, exist_ok=True)
    (root / "README.txt").write_text("not a class")
    for cname, whs in sizes.items():
        d = root / cname
        d.mkdir()
        (d / "labels.csv").write_text("skip me")
        for i, (w, h) in enumerate(whs):
            img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
            img.save(d / (f"{i:03d}.jpg" if i == 2 else f"{i:03d}.png"))


@pytest.mark.parametrize("class_names,center_crop", [
    (None, True), (["2", "0"], True), (["1"], False)])
def test_load_image_folder_matches_jax(tmp_path, class_names, center_crop):
    pytest.importorskip("PIL")
    # 32x32 as is; 80x50 resized; 140x70 halved once by the box filter
    # first (short side >= 64); 300x300 halved three times
    _png_folder(tmp_path / "f", {"0": [(32, 32), (80, 50)],
                                 "1": [(140, 70), (300, 300), (33, 47)],
                                 "2": [(50, 80)]})
    got = TD.load_image_folder(str(tmp_path / "f"), 32, class_names,
                               center_crop)
    want = JD.load_image_folder(str(tmp_path / "f"), 32, class_names,
                                center_crop)
    assert got.images.dtype == np.uint8 and got.images.shape[1:] == (32, 32, 3)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    if class_names == ["2", "0"]:
        # the global class map: "2" keeps index 2
        assert got.labels.tolist() == [2, 0, 0]


def test_load_image_folder_raises_on_an_empty_folder(tmp_path):
    pytest.importorskip("PIL")
    (tmp_path / "empty" / "0").mkdir(parents=True)
    for loader in (TD.load_image_folder, JD.load_image_folder):
        with pytest.raises(FileNotFoundError, match="no images"):
            loader(str(tmp_path / "empty"), 32)


# -- the fim CLI and --mode sa ------------------------------------------------

def _write_config(tmp_path, cfg):
    yaml = pytest.importorskip("yaml")
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    return str(path)


def test_fim_cli_overshoot_and_scale(tmp_path, monkeypatch):
    # T 16 in 2 chunks of 8; n_samples 3 at batch 2: the check before each
    # batch lets a second batch of 2 run (4 examples a chunk), and the file
    # is the sum of the 4 batch means divided by n_chunks (not by 4)
    from uurg_torch.cli import fim

    cfg_path = _write_config(tmp_path, _tiny_config(tmp_path, timesteps=16))
    folder = tmp_path / "run"
    calls, acc = [], {}
    make = TF.make_per_sample_fisher_step

    def spy(loss_fn):
        inner = make(loss_fn)

        def step(fisher, model, batch, seed):
            calls.append((model.training, batch[0].shape[0],
                          batch[2][0].tolist(), seed))
            inner(fisher, model, batch, seed)
            acc.update({k: v.clone() for k, v in fisher.items()})

        return step

    monkeypatch.setattr(TF, "make_per_sample_fisher_step", spy)
    argv = ["--config", cfg_path, "--ckpt_folder", str(folder),
            "--n_chunks", "2", "--n_samples", "3", "--batch_size", "2",
            "--seed", "5"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fim.main(argv)                           # CUDA unless asked for
    fim.main(argv + ["--device", "cpu"])
    assert [(tr, n, ts) for tr, n, ts, _ in calls] == (
        [(False, 2, list(range(8)))] * 2 + [(False, 2, list(range(8, 16)))] * 2)
    assert len({s for *_, s in calls}) == 4     # a seed a (chunk, batch)
    got = CK.restore_checkpoint(str(folder / "fisher_dict"))
    assert list(got) == list(acc)
    for k, v in acc.items():
        assert torch.equal(got[k], v * 0.5), k
    flat = torch.cat([v.reshape(-1) for v in got.values()])
    assert torch.isfinite(flat).all() and (flat >= 0).all() and flat.max() > 0


class _Args:
    seed = 0
    label_to_forget = 0


def test_sa_forget_reads_class_samples_and_writes_ckpt(tmp_path, monkeypatch):
    pytest.importorskip("PIL")
    cfg = _tiny_config(tmp_path, n_iters=3, snapshot_freq=2)
    cfg = cfg.merged({"model": {"ema_rate": 0.5}})
    wl = TW.DDPMWorkload.from_config(cfg, device="cpu")
    model = wl.init_params(_Args.seed)
    rng = np.random.default_rng(13)
    CK.save_checkpoint(str(tmp_path / "run" / "fisher_dict"), {
        k: torch.from_numpy(rng.random(p.shape, dtype=np.float32))
        for k, p in model.named_parameters()})
    _png_folder(tmp_path / "run" / "class_samples",
                {"0": [(32, 32)] * 2, "1": [(32, 32)] * 3, "2": [(40, 32)]})

    class Args(_Args):
        ckpt_folder = str(tmp_path / "run")

    seen = []
    batches = TR.infinite_batches

    def spy(ds, bs, *, seed=0, transform=None):
        seen.append((ds, bs, seed, transform))
        return batches(ds, bs, seed=seed, transform=transform)

    monkeypatch.setattr(TR, "infinite_batches", spy)
    losses = []
    make = TR.make_sfron_step

    def recording(*a, **k):
        step = make(*a, **k)

        def run(state, *b):
            assert not state.model.training    # eval mode: no dropout
            m = step(state, *b)
            losses.append(float(m["remain_loss"]))
            return m

        return run

    monkeypatch.setattr(TR, "make_sfron_step", recording)
    ckpt = tmp_path / "out"
    state = TR.sa_forget(Args, cfg, str(ckpt), device="cpu")
    # the remember data: class_samples without class 0, the global labels,
    # no flip transform, the run's seed
    (ds, bs, seed, transform), = seen
    assert sorted(ds.labels.tolist()) == [1, 1, 1, 2]
    assert (bs, seed, transform) == (4, 0, None)
    assert state.step == 3 and len(losses) == 3
    assert np.isfinite(losses).all()
    moved = [not torch.equal(p, q) for p, q in
             zip(state.model.parameters(), model.parameters())]
    assert sum(moved) > len(moved) // 2
    assert not all(torch.equal(e, q) for e, q in
                   zip(state.ema_model.parameters(), model.parameters()))
    # Adam ticked every parameter on every step
    assert {int(s["step"]) for s in state.optimizer.state.values()} == {3}
    back = TU.CondUNet(wl.unet_cfg)
    assert load_reference_checkpoint(str(ckpt / "ckpt.pth"), back,
                                     use_ema=True) == 3
    for a, b in zip(back.parameters(), state.ema_model.parameters()):
        assert torch.equal(a, b)


def test_train_cli_sa_on_cpu(tmp_path, caplog):
    # the port's fim CLI writes fisher_dict; --mode sa reads it, falls back
    # to the remain split without class_samples, and writes ckpt.pth
    from uurg_torch.cli import fim
    from uurg_torch.cli import train as cli

    cfg_path = _write_config(tmp_path, _tiny_config(tmp_path, timesteps=20,
                                                    n_iters=2))
    folder = tmp_path / "pre"
    fim.main(["--config", cfg_path, "--ckpt_folder", str(folder),
              "--n_chunks", "4", "--n_samples", "1", "--batch_size", "1",
              "--device", "cpu"])
    assert os.listdir(folder) == ["fisher_dict"]
    common = ["--config", cfg_path, "--exp", str(tmp_path / "exp"),
              "--mode", "sa"]
    with pytest.raises(FileNotFoundError, match="uurg_torch.cli.fim"):
        cli.main(common + ["--device", "cpu", "--ckpt_folder",
                           str(tmp_path / "no_fisher")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(common + ["--ckpt_folder", str(folder)])
    with caplog.at_level(logging.WARNING, logger="uurg_torch.ddpm"):
        cli.main(common + ["--device", "cpu", "--ckpt_folder", str(folder)])
    assert "no class_samples" in caplog.text
    runs = list((tmp_path / "exp").rglob("ckpt.pth"))
    assert len(runs) == 1


def test_chip_smoke_carries_the_sa_config():
    # chip_smoke.py runs without PyYAML: it reads the SA config with the
    # port's reader, which must give what PyYAML gives
    import chip_smoke

    yaml = pytest.importorskip("yaml")
    with open(SA) as f:
        want = yaml.safe_load(f)
    assert chip_smoke.sa_config().to_dict() == want
    assert load_config(SA).to_dict() == want
    assert chip_smoke.SA_YML == SA
