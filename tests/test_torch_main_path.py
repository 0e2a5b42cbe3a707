"""The rest of the north-star path in the port (CPU): the two helper CLIs
against the JAX ones (``save_base_dataset``, ``train_classifier`` feeding
``classifier_evaluation``), the UNet's ``remat`` against no remat with
dropout on, and ``resamp_with_conv=False`` against the JAX model."""
import importlib.util
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from uurg_torch.cli import save_base_dataset as TSB  # noqa: E402
from uurg_torch.cli import train_classifier as TTC  # noqa: E402
from uurg_torch.io.jax_interop import (  # noqa: E402
    jax_resnet_variables_to_torch, jax_unet_params_to_torch)
from uurg_torch.models import unet_cond as TU  # noqa: E402
from uurg_tpu.models import unet_cond as JU  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
            resolution=32)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs (the suite's workers share
    the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_cli(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "cli", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- save_base_dataset ------------------------------------------------------

@pytest.mark.parametrize("as_npz", [True, False])
def test_save_base_dataset_matches_jax_cli(tmp_path, monkeypatch, as_npz):
    """On the stand-in (no CIFAR-10 under --data_path): the npz's arr_0 bit
    for bit, or the same PNG names with the same pixels."""
    from PIL import Image

    jax_cli = _jax_cli("save_base_dataset")
    flags = ["--data_path", str(tmp_path / "none"), "--label_to_forget", "3"]
    flags += ["--as_npz"] if as_npz else []
    monkeypatch.setattr(sys, "argv", ["save_base_dataset.py", *flags,
                                      "--out", str(tmp_path / "jax")])
    jax_cli.main()
    TSB.main([*flags, "--out", str(tmp_path / "port")])
    if as_npz:
        got = np.load(tmp_path / "port.npz")["arr_0"]
        want = np.load(tmp_path / "jax.npz")["arr_0"]
        assert got.dtype == np.uint8 and got.shape[1:] == (32, 32, 3)
        np.testing.assert_array_equal(got, want)
        return
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and names
    assert not any(n.startswith("3_") for n in names)
    for n in names[::97]:
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "port" / n)),
            np.asarray(Image.open(tmp_path / "jax" / n)))


# -- train_classifier -------------------------------------------------------

def _args(tmp_path, *extra):
    return TTC.parse_args(["--data_path", str(tmp_path / "none"),
                           "--image_size", "32", "--device", "cpu",
                           "--save_path", str(tmp_path / "probe"), *extra])


def test_train_classifier_writes_a_pth_classifier_evaluation_reads(
        tmp_path, capsys):
    from uurg_torch.cli import classifier_evaluation

    path = TTC.main(["--data_path", str(tmp_path / "none"), "--image_size",
                     "32", "--epochs", "1", "--batch_size", "256",
                     "--device", "cpu", "--save_path",
                     str(tmp_path / "probe")])
    assert path == str(tmp_path / "probe" / "cifar10_resnet34.pth")
    imgs = np.random.default_rng(0).integers(0, 256, (6, 32, 32, 3),
                                             dtype=np.uint8)
    np.savez(tmp_path / "samples.npz", arr_0=imgs)
    capsys.readouterr()
    classifier_evaluation.main([
        str(tmp_path / "samples.npz"), "--classifier_ckpt", path,
        "--image_size", "32", "--csv", str(tmp_path / "r.csv"),
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Forget accuracy (UA):" in out
    assert os.path.isfile(tmp_path / "r.csv")


# float32 gradients of one train-mode ResNet-34 step, port against JAX, per
# leaf: relative L2. Both sides' float32 sums run in other orders through 36
# layers and 36 train-mode BatchNorm backwards, which subtract the
# gradient's projections on 1 and on x_hat and so cancel. The test measures
# each side's distance from a float64 run of the same step (the port's
# model in float64): on the CPU at 1, 2 and 8 torch threads the port read
# at most 5.9e-3 and JAX 6.2e-3 (both at layer1.1.bn2.bias; medians 2.9e-5
# and 9.7e-5), and the two sides at most 2.1e-3 apart (layer2.2.bn2.bias,
# median 9.4e-5). Their sum bounds the distance between the sides; the
# limit sits under it, at about five times the reading
TC_GRAD_REL = 1e-2
# each side's float32 gradients against the float64 run, per leaf: about
# three times the highest reading
TC_F64_REL = 2e-2


def _rel_leaf(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_classifier_batches_and_step_match_jax_cli(tmp_path,
                                                         monkeypatch, dtype):
    """The first batch of epoch 0 (flip, pixel noise, uint8 truncation,
    resize) equals the JAX CLI's; one AdamW step of the CLI's model from the
    same weights against the JAX ``Classifier.make_train_step``. In float32
    (the model's dtype switched on both sides) the step is held on the
    gradients it consumes (each leaf against JAX's and both against a
    float64 run) and on AdamW's move from the port's own gradient; in the
    CLI's bf16 the loss is held to bf16 rounding."""
    from uurg_torch.models import resnet as TR
    from uurg_torch.workloads.classification import cross_entropy
    from uurg_tpu.data.arrays import infinite_batches, random_flip_batch
    from uurg_tpu.eval.classifier_eval import resize_batch
    from uurg_tpu.models.resnet import BasicBlock, ResNet, init_classifier
    from uurg_tpu.train import make_optimizer
    from uurg_tpu.workloads.classification import Classifier

    args = _args(tmp_path, "--batch_size", "8", "--noise_std", "0.05")
    train_ds = TTC.load_train_data(args)
    x, y = next(TTC.epoch_stream(args, train_ds, 0, torch.device("cpu")))

    def aug(xx, rng):
        xx = random_flip_batch(xx, rng)
        return np.clip(xx + rng.normal(0, 0.05, xx.shape)
                       .astype(np.float32), 0.0, 1.0)

    jx, jy = next(infinite_batches(train_ds, 8, seed=0, transform=aug))
    jx = np.asarray(resize_batch((jx * 255).astype(np.uint8), 32))
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_allclose(x.numpy(), jx, atol=1e-6)

    jm = ResNet([3, 4, 6, 3], BasicBlock, 10, imagenet_stem=True,
                dtype=getattr(jnp, dtype))
    params, stats = init_classifier(jax.random.key(0), jm, resolution=32)
    opt = make_optimizer("adamw", 1e-3, weight_decay=1e-4)
    start = jax_resnet_variables_to_torch(params, stats)   # the step donates
    jbatch = (jnp.asarray(jx), jnp.asarray(jy))
    if dtype == "float32":
        # the gradients JAX's step takes, at the same weights and batch
        (_, _), jgrads = jax.value_and_grad(
            Classifier(jm).ce_loss_fn(), has_aux=True)(
                params, stats, jbatch, jax.random.key(1))
        jgrads = jax_resnet_variables_to_torch(jgrads, {})
    carry = (params, stats, opt.init(params), jnp.zeros((), jnp.int32))
    (p2, s2, _, _), jmet = Classifier(jm).make_train_step(opt)(
        carry, jbatch, jax.random.key(1))
    want = jax_resnet_variables_to_torch(p2, s2)

    if dtype == "float32":
        resnet34 = TR.ResNet34
        monkeypatch.setattr(TR, "ResNet34", lambda n, dtype, imagenet_stem:
                            resnet34(n, torch.float32, imagenet_stem))
    model, cls, opt_t, step = TTC.build(args, torch.device("cpu"))
    assert type(opt_t) is torch.optim.AdamW
    assert opt_t.defaults["weight_decay"] == 1e-4
    assert model.conv1.compute_dtype == getattr(torch, dtype)
    model.load_state_dict(start, strict=False)
    met = step(model, cls.batch(x, y), 0)
    if dtype == "bfloat16":
        # bf16 activations through 36 layers, batch statistics over 8
        # samples at 1x1 in the last stage: the loss to a few roundings
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=5e-2)
        return
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    sd = model.state_dict()
    for k, w in want.items():
        if "running" in k:
            # float32 sums in another order, through up to 36 layers
            assert ((sd[k] - w).norm() <= 1e-4 * w.norm()), k

    # the float64 run of the same step: the port's model in float64
    m64 = resnet34(10, torch.float64, True).double()
    m64.load_state_dict({k: v.double() for k, v in start.items()},
                        strict=False)
    xb, yb = cls.batch(x, y)
    cross_entropy(cls.train_apply(m64, xb.double()), yb).backward()
    g64 = dict(m64.named_parameters())
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads.keys() == jgrads.keys() == g64.keys()
    for n, g in grads.items():
        ref = g64[n].grad
        assert _rel_leaf(g, jgrads[n]) <= TC_GRAD_REL, n
        assert _rel_leaf(g, ref) <= TC_F64_REL, n
        assert _rel_leaf(jgrads[n], ref) <= TC_F64_REL, n

    # AdamW's first step from the port's own gradient, in float64: the
    # decay w (1 - lr wd) first, then m_hat / (sqrt(v_hat) + eps) with
    # m_hat = g and v_hat = g^2. The port rounds each of the two updates to
    # float32 once (half an ulp of w each) and its moments to float32
    hp = opt_t.defaults
    lr, wd, eps = hp["lr"], hp["weight_decay"], hp["eps"]
    for n, p in model.named_parameters():
        w0, g = start[n].double(), grads[n].double()
        move = -lr * g / (g.abs() + eps)
        new = w0 * (1 - lr * wd) + move
        err = (p.detach().double() - new).abs()
        assert (err <= 2 ** -23 * new.abs() + 1e-6 * lr).all(), n


# -- remat and resamp_with_conv=False ---------------------------------------

def _unet_inputs(n=4, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, 32, 32, 3), dtype=np.float32))
    t = torch.from_numpy(rng.integers(0, 1000, n))
    c = torch.from_numpy(rng.integers(0, 10, n))
    keep = torch.arange(n) % 2 == 0
    w = torch.from_numpy(rng.standard_normal((n, 32, 32, 3),
                                             dtype=np.float32))
    return x, t, c, keep, w


def _train_grads(remat: bool, seed: int = 0):
    """Loss and gradients of one train-mode call (dropout 0.3) of the ch=32
    UNet with and without remat, from the same weights and generator."""
    cfg = TU.UNetConfig(dtype=torch.float32, dropout=0.3, remat=remat,
                        **TINY)
    model = TU.init_unet(seed, cfg).train()
    x, t, c, keep, w = _unet_inputs()
    gen = torch.Generator().manual_seed(7)
    out = model(x, t, c, keep, generator=gen)
    loss = (out * w).sum()
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}, \
        gen.get_state()


def test_remat_equals_no_remat_with_dropout():
    """Same loss and gradients bit for bit, and the generator left where
    the forward left it: the recompute replays the forward's dropout
    masks."""
    loss0, g0, s0 = _train_grads(False)
    loss1, g1, s1 = _train_grads(True)
    assert torch.equal(loss0, loss1)
    assert torch.equal(s0, s1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


def test_remat_without_the_replay_would_differ(monkeypatch):
    """The check above is sensitive: a checkpoint that lets the recompute
    draw fresh masks from the generator gives other gradients."""
    from torch.utils.checkpoint import checkpoint

    def naive(blk, x, emb, generator):
        return checkpoint(blk, x, emb, generator, use_reentrant=False)

    _, g0, _ = _train_grads(False)
    monkeypatch.setattr(TU.CondUNet, "_remat", staticmethod(naive))
    _, g1, _ = _train_grads(True)
    assert not all(torch.equal(g0[n], g1[n]) for n in g0)


def test_remat_is_off_without_grad():
    """Without grad (sampling) nothing is recomputed: the forward equals the
    plain one and builds no checkpoint."""
    cfg = TU.UNetConfig(dtype=torch.float32, remat=True, **TINY)
    model = TU.init_unet(0, cfg)
    plain = TU.init_unet(0, TU.UNetConfig(dtype=torch.float32, **TINY))
    x, t, c, keep, _ = _unet_inputs(2)
    with torch.no_grad():
        assert torch.equal(model(x, t, c, keep), plain(x, t, c, keep))


def test_resample_without_conv_matches_jax():
    cfg = dict(TINY, resamp_with_conv=False, dropout=0.0)
    jcfg = JU.UNetConfig(dtype=jnp.float32, **cfg)
    _, params = JU.init_unet(jax.random.key(2), jcfg)
    assert not any("sample" in k for k in params)     # no resampling convs
    model = TU.CondUNet(TU.UNetConfig(dtype=torch.float32, **cfg))
    model.load_state_dict(jax_unet_params_to_torch(params), strict=True)
    x, t, c, keep, w = _unet_inputs(3, seed=5)
    jm = JU.CondUNet(jcfg)

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x.numpy()),
                       jnp.asarray(t.numpy()), jnp.asarray(c.numpy()),
                       jnp.asarray(keep.numpy()))
        return jnp.sum(out * w.numpy()), out

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    out = model.eval()(x, t, c.long(), keep)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    (out * w).sum().backward()
    tgrads = jax_unet_params_to_torch(jax.tree_util.tree_map(np.asarray,
                                                             jgrads))
    # fp32, sums in another order: relative L2 of all gradients together
    # (not per leaf: a conv bias ahead of a one-channel GroupNorm group has
    # an exact gradient of zero, so its leaf holds rounding noise only)
    names = [n for n, _ in model.named_parameters()]
    g = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    r = torch.cat([tgrads[n].reshape(-1) for n in names])
    assert ((g - r).norm() / r.norm()).item() <= 1e-4
