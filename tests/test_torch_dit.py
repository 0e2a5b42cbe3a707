"""The port's DiT model, Gaussian diffusion, timestep sampler, checkpoint
interop and latent shards vs the JAX package (CPU): the same numpy-seeded
inputs and weights through both. The weights are perturbed from the JAX
init, so that every adaLN gate is O(0.1-1): a fresh DiT's adaLN-Zero layers
make its output exactly 0 and its attention invisible."""
import dataclasses
import os
import socket

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from uurg_torch.data import lazy as TLazy  # noqa: E402
from uurg_torch.diffusion import gaussian as TG  # noqa: E402
from uurg_torch.diffusion import timestep_sampler as TTS  # noqa: E402
from uurg_torch.io.dit_interop import (load_dit_reference_checkpoint,  # noqa: E402
                                       save_dit_checkpoint)
from uurg_torch.io.jax_interop import jax_dit_params_to_torch  # noqa: E402
from uurg_torch.models import dit as TD  # noqa: E402
from uurg_tpu.data import lazy as JLazy  # noqa: E402
from uurg_tpu.diffusion import gaussian as JG  # noqa: E402
from uurg_tpu.diffusion import timestep_sampler as JTS  # noqa: E402
from uurg_tpu.io import dit_interop as JI  # noqa: E402
from uurg_tpu.models import dit as JD  # noqa: E402

# input 8, patch 2, depth 2 (tests/test_dit.py's tiny config), at head
# width 16 and at DiT-XL/2's head width 72 (hidden 144, 2 heads)
WIDTHS = {"d16": (32, 2), "d72": (144, 2)}
# fp32 on both sides: LayerNorm variance two-pass (torch) vs E[x^2] -
# E[x]^2 (flax), sums in another order: ~1e-6 relative
F32_REL = 1e-5
# bf16 compute on both sides: one to two bf16 roundings (2**-8) per layer
BF16_REL = 2e-2
GRAD_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: under pytest-xdist the
    suite runs several worker processes on one host, and torch's default
    of one thread a core in each oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(width: str, dtype: str = "f32", scan: bool = True, **kw):
    hidden, heads = WIDTHS[width]
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    common = dict(input_size=8, patch_size=2, in_channels=4,
                  hidden_size=hidden, depth=2, num_heads=heads,
                  num_classes=10)
    jnd = jnp.bfloat16 if kw.pop("norm_bf16", False) else jnp.float32
    tnd = torch.bfloat16 if jnd == jnp.bfloat16 else torch.float32
    jc = JD.DiTConfig(**common, dtype=jdt, scan_blocks=scan, norm_dtype=jnd)
    tc = TD.DiTConfig(**common, dtype=tdt, scan_blocks=scan, norm_dtype=tnd,
                      **kw)
    return jc, tc


def perturb(params, seed: int = 0):
    """The JAX params plus a seeded normal draw: kernels by 0.5 /
    sqrt(fan_in), vectors by 0.05, so every adaLN gate is O(0.1-1)."""
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a, np.float32)
        std = 0.5 / np.sqrt(a.shape[-2]) if a.ndim >= 2 else 0.05
        return a + (rng.standard_normal(a.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map(one, params)


_PARAMS: dict = {}


def jax_params(width: str, scan: bool = True):
    """Perturbed JAX params of the width's config (cached)."""
    key = (width, scan)
    if key not in _PARAMS:
        jc, _ = _cfgs(width, scan=scan)
        _, p = JD.init_dit(jax.random.key(0), jc)
        _PARAMS[key] = perturb(p)
    return _PARAMS[key]


def port_model(tc, params):
    model = TD.DiT(tc)
    model.load_state_dict(jax_dit_params_to_torch(params, tc.depth),
                          strict=True)
    return model


def inputs(seed: int = 1, n: int = 3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8, 8, 4)).astype(np.float32)
    t = np.array([0, 500, 999][:n] + [7] * max(0, n - 3))
    y = rng.integers(0, 10, n)
    keep = np.arange(n) % 2 == 0
    return x, t, y, keep


def _t(a):
    return torch.from_numpy(np.asarray(a))


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -- registry, embeddings ------------------------------------------------

def test_registry_and_config_defaults_match_jax():
    assert set(TD.DiT_configs) == set(JD.DiT_configs)
    for name in TD.DiT_configs:
        t, j = TD.DiT_configs[name](), JD.DiT_configs[name]()
        for f in dataclasses.fields(JD.DiTConfig):
            if f.name not in ("dtype", "norm_dtype"):
                assert getattr(t, f.name) == getattr(j, f.name), (name, f)
        assert (t.dtype, t.norm_dtype) == (torch.bfloat16, torch.float32)
    model, cfg = TD.build_dit("DiT-S/8", input_size=16, num_classes=3)
    assert (cfg.depth, cfg.hidden_size, cfg.num_heads) == (12, 384, 6)
    assert model.pos_embed.shape == (4, 384)
    with pytest.raises(ValueError, match="remat_policy"):
        TD.DiT(dataclasses.replace(cfg, remat_policy="everything"))


@pytest.mark.parametrize("dim", [256, 64])
def test_embeddings_match_jax(dim):
    t = np.array([0, 1, 17, 500, 999])
    got = TD.dit_timestep_embedding(_t(t), dim).numpy()
    want = np.asarray(JD.dit_timestep_embedding(jnp.asarray(t), dim))
    # exp, sin and cos of float32 arguments up to 999: a few ulp of the
    # argument's magnitude
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    for d, grid in ((dim, 4), (1152, 16)):
        np.testing.assert_array_equal(TD.sincos_2d_pos_embed(d, grid),
                                      JD.sincos_2d_pos_embed(d, grid))


# -- forward, gradients, remat --------------------------------------------

CASES = [("f32", True, False), ("f32", False, False), ("bf16", True, False),
         ("bf16", True, True)]


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype,scan,norm_bf16", CASES)
def test_forward_matches_jax(width, dtype, scan, norm_bf16):
    jc, tc = _cfgs(width, dtype, scan, norm_bf16=norm_bf16)
    params = jax_params(width, scan)
    x, t, y, keep = inputs()
    want = np.asarray(JD.DiT(jc).apply({"params": params}, x, t, y, keep),
                      np.float32)
    with torch.no_grad():
        got = port_model(tc, params)(_t(x), _t(t), _t(y), _t(keep))
    assert got.shape == (3, 8, 8, 8) and got.dtype == torch.float32
    tol = F32_REL if dtype == "f32" and not norm_bf16 else BF16_REL
    assert rel(got.numpy(), want) <= tol


@pytest.mark.parametrize("width", list(WIDTHS))
def test_forward_f32_both_sides_near_float64(width):
    # flax's LayerNorm takes E[x^2] - E[x]^2, torch's two passes: each fp32
    # side held to the port's model run in float64 (both measured ~2e-6)
    jc, tc = _cfgs(width)
    params = jax_params(width)
    x, t, y, keep = inputs()
    want_j = np.asarray(JD.DiT(jc).apply({"params": params}, x, t, y, keep))
    m32 = port_model(tc, params)
    m64 = TD.DiT(dataclasses.replace(tc, dtype=torch.float64,
                                     norm_dtype=torch.float64)).double()
    m64.load_state_dict(m32.state_dict())
    with torch.no_grad():
        got = m32(_t(x), _t(t), _t(y), _t(keep))
        ref = m64(_t(x).double(), _t(t), _t(y), _t(keep))
    assert ref.dtype == torch.float64
    assert rel(got.numpy(), ref.numpy()) <= F32_REL
    assert rel(want_j, ref.numpy()) <= F32_REL


def _jax_grads(jc, params, x, t, y, keep, w):
    model = JD.DiT(jc)

    def loss(p):
        return jnp.sum(model.apply({"params": p}, x, t, y, keep) * w)

    return jax.grad(loss)(params)


def _torch_loss(model, x, t, y, keep, w):
    return (model(_t(x), _t(t), _t(y), _t(keep)) * _t(w)).sum()


@pytest.mark.parametrize("width", list(WIDTHS))
def test_gradients_match_jax(width):
    jc, tc = _cfgs(width)
    params = jax_params(width)
    x, t, y, keep = inputs(2)
    w = np.random.default_rng(3).standard_normal((3, 8, 8, 8)).astype(
        np.float32)
    want = jax_dit_params_to_torch(_jax_grads(jc, params, x, t, y, keep, w))
    model = port_model(tc, params)
    _torch_loss(model, x, t, y, keep, w).backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k in got:
        assert want[k].norm() > 0, k
        assert rel(got[k].numpy(), want[k].numpy()) <= GRAD_REL, k


def _counting_attention(monkeypatch):
    calls = []
    real = TD.attention

    def counted(q, k, v):
        calls.append(torch.is_grad_enabled())
        return real(q, k, v)

    monkeypatch.setattr(TD, "attention", counted)
    return calls


@pytest.mark.parametrize("policy", TD.REMAT_POLICIES)
def test_remat_policies_equal_no_remat(policy, monkeypatch):
    # bit-equal on the CPU, and the attention run again in the backward
    # only where the policy does not keep its output (None, dots: one a
    # block; attn, attn+dots: none)
    _, plain_cfg = _cfgs("d72", remat=False)
    params = jax_params("d72")
    x, t, y, keep = inputs(4)
    w = np.random.default_rng(5).standard_normal((3, 8, 8, 8)).astype(
        np.float32)
    out = {}
    for tag, cfg in (("plain", plain_cfg),
                     ("remat", dataclasses.replace(plain_cfg, remat=True,
                                                   remat_policy=policy))):
        model = port_model(cfg, params)
        calls = _counting_attention(monkeypatch)
        loss = _torch_loss(model, x, t, y, keep, w)
        n_fwd = len(calls)
        loss.backward()
        out[tag] = (loss.detach(), [p.grad for p in model.parameters()],
                    n_fwd, len(calls))
    assert torch.equal(out["plain"][0], out["remat"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["plain"][1],
                                                 out["remat"][1]))
    depth = plain_cfg.depth
    again = depth if policy in (None, "dots") else 0
    assert out["plain"][2:] == (depth, depth)
    assert out["remat"][2:] == (depth, depth + again)


def test_zero_init_null_label_and_attention_matter():
    _, tc = _cfgs("d16")
    x, t, y, keep = inputs(6)
    fresh = TD.init_dit(0, tc)
    with torch.no_grad():
        assert torch.equal(fresh(_t(x), _t(t), _t(y)),
                           torch.zeros(3, 8, 8, 8))
        model = port_model(tc, jax_params("d16"))
        kept = model(_t(x), _t(t), _t(y), torch.ones(3, dtype=torch.bool))
        null = model(_t(x), _t(t), _t(y), torch.zeros(3, dtype=torch.bool))
        assert (kept - null).abs().amax(dim=(1, 2, 3)).min() > 1e-3
        # the null row is the label num_classes
        assert torch.equal(null, model(_t(x), _t(t), torch.full((3,), 10)))
        # the attention output moves the result: a zeroed attention changes
        # it (so a kernel-vs-plain check of this model sees the kernel)
        orig = TD.attention
        try:
            TD.attention = lambda q, k, v: torch.zeros_like(q)
            blind = model(_t(x), _t(t), _t(y), torch.ones(3,
                                                          dtype=torch.bool))
        finally:
            TD.attention = orig
        assert rel(blind.numpy(), kept.numpy()) > 1e-2


# -- interop ----------------------------------------------------------------

@pytest.mark.parametrize("scan", [True, False])
def test_converter_round_trip(scan):
    jc, tc = _cfgs("d72", scan=scan)
    params = jax_params("d72", scan)
    sd = jax_dit_params_to_torch(params, tc.depth)
    back = JI.torch_dit_state_to_flax(sd, jc)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(flat_b[path]))
    with pytest.raises(ValueError, match="blocks"):
        jax_dit_params_to_torch(params, tc.depth + 1)


def test_checkpoint_files_read_both_ways(tmp_path):
    jc, tc = _cfgs("d72")
    params = jax_params("d72")
    model = port_model(tc, params)
    ema = port_model(tc, perturb(params, seed=9))
    path = str(tmp_path / "final.pt")
    save_dit_checkpoint(path, model, ema)
    ck = torch.load(path, weights_only=True)
    assert set(ck) == {"model", "ema"}
    assert ck["model"]["pos_embed"].shape == (1, 16, 144)
    # the JAX package reads the port's file (EMA preferred, then model)
    for prefer_ema, src in ((True, ema), (False, model)):
        back = JI.load_dit_reference_checkpoint(path, jc,
                                                prefer_ema=prefer_ema)
        again = jax_dit_params_to_torch(back, tc.depth)
        for k, v in src.state_dict().items():
            assert torch.equal(again[k], v), k
    # and the port reads it back, and a reference-style file with args
    other = TD.DiT(tc)
    load_dit_reference_checkpoint(path, other)
    assert all(torch.equal(a, b) for a, b in zip(ema.parameters(),
                                                 other.parameters()))
    import argparse
    ref = str(tmp_path / "ref.pt")
    torch.save({"model": ck["model"], "args": argparse.Namespace(a=1)}, ref)
    load_dit_reference_checkpoint(ref, other)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 other.parameters()))
    bad = dict(ck["model"], pos_embed=torch.zeros(1, 4, 144))
    torch.save(bad, str(tmp_path / "bad.pt"))
    with pytest.raises(ValueError, match="pos_embed"):
        load_dit_reference_checkpoint(str(tmp_path / "bad.pt"), other)


# -- Gaussian diffusion -----------------------------------------------------

@pytest.mark.parametrize("spec", ["", "250", "50", "ddim25"])
def test_gaussian_constants_are_bit_equal(spec):
    jd = JG.make_diffusion(spec, 1000, learn_sigma=True)
    td = TG.make_diffusion(spec, 1000, learn_sigma=True)
    np.testing.assert_array_equal(td.betas, jd.betas)
    np.testing.assert_array_equal(td.timestep_map, jd.timestep_map)
    assert td.num_timesteps == jd.num_timesteps
    assert set(td._c) == set(jd._c)
    for k in jd._c:
        assert td._c[k].dtype == torch.float32
        np.testing.assert_array_equal(td._c[k].numpy(), np.asarray(jd._c[k]))
    cos_t = TG.make_diffusion("", 100, schedule="cosine")
    cos_j = JG.make_diffusion("", 100, schedule="cosine")
    np.testing.assert_array_equal(cos_t.betas, cos_j.betas)


@pytest.mark.parametrize("spec", ["250", "50", "ddim25", "10,20,30", 25, 1000,
                                  ""])
def test_space_timesteps_matches_jax(spec):
    assert TG.space_timesteps(1000, spec) == JG.space_timesteps(1000, spec)
    with pytest.raises(ValueError):
        TG.space_timesteps(1000, "ddim999")
    with pytest.raises(ValueError):
        TG.space_timesteps(10, "20")


def _linear_model(seed: int = 0):
    """A learned-sigma model fn with two parameters, one per channel group,
    written for both packages: eps = a * x + t / 1000, var = tanh(c * x)."""
    rng = np.random.default_rng(seed)
    a, c = (rng.standard_normal((4, 4, 4)).astype(np.float32) * 0.5
            for _ in range(2))

    def fn(lib, cat, tanh, pa, pc):
        def model(x, t, **kw):
            tt = t.reshape(-1, 1, 1, 1) / 1000.0
            return cat([pa * x + tt, tanh(pc * x)])
        return model

    jfn = fn(jnp, lambda z: jnp.concatenate(z, -1), jnp.tanh, a, c)
    return a, c, jfn, fn


def test_training_losses_match_jax_and_vb_trains_variance_only():
    a, c, jfn, fn = _linear_model()
    rng = np.random.default_rng(1)
    x0 = np.clip(rng.standard_normal((5, 4, 4, 4)), -1, 1).astype(np.float32)
    t = np.array([0, 1, 10, 500, 999])            # t = 0: the decoder NLL
    jd, td = JG.make_diffusion(""), TG.make_diffusion("")
    # JAX draws its noise from the key: reproduce that draw and inject it
    key = jax.random.key(0)
    jnoise = np.asarray(jax.random.normal(key, x0.shape, jnp.float32))
    want = np.asarray(jd.training_losses(jfn, x0, t, key, keepdim=True))
    pa, pc = (_t(v).clone().requires_grad_() for v in (a, c))
    tfn = fn(torch, lambda z: torch.cat(z, -1), torch.tanh, pa, pc)
    got = td.training_losses(tfn, _t(x0), _t(t), _t(jnoise), keepdim=True)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    # frozen-mean trick: the VB term's gradient reaches the variance
    # parameter only; the eps parameter's gradient is the MSE's alone
    total = got.sum()
    g_a, g_c = torch.autograd.grad(total, (pa, pc))
    x_t = td.q_sample(_t(x0), _t(t), _t(jnoise))
    eps_only = ((tfn(x_t, _t(t))[..., :4] - _t(jnoise)) ** 2).mean(
        dim=(1, 2, 3)).sum()
    (g_a_mse,) = torch.autograd.grad(eps_only, pa)
    torch.testing.assert_close(g_a, g_a_mse, rtol=1e-6, atol=1e-7)
    assert g_c.abs().sum() > 0
    # a generator draws the noise when none is given
    gen = torch.Generator().manual_seed(0)
    drawn = td.training_losses(tfn, _t(x0), _t(t), generator=gen)
    gen.manual_seed(0)
    noise = torch.randn(x0.shape, generator=gen)
    assert torch.equal(drawn, td.training_losses(tfn, _t(x0), _t(t), noise))


@pytest.mark.parametrize("clip", [True, False])
def test_p_mean_variance_and_sampler_match_jax(clip):
    a, c, jfn, fn = _linear_model(2)
    tfn = fn(torch, lambda z: torch.cat(z, -1), torch.tanh, _t(a), _t(c))
    jd, td = JG.make_diffusion("5"), TG.make_diffusion("5")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    step_noise = rng.standard_normal((5, 2, 4, 4, 4)).astype(np.float32)
    for ts in (4, 2, 0):
        t = np.full((2,), ts)
        want = jd.p_mean_variance(jfn, x, t, clip)
        got = td.p_mean_variance(tfn, _t(x), _t(t), clip)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)
    # the ancestral loop from injected x_T and step noise, against the same
    # loop over JAX's p_mean_variance
    xj = x
    for i, ts in enumerate(range(4, -1, -1)):
        t = np.full((2,), ts)
        mean, logvar, _, _ = jd.p_mean_variance(jfn, xj, t, clip)
        xj = np.asarray(mean + (ts > 0) * jnp.exp(0.5 * logvar)
                        * step_noise[i])
    got = td.p_sample_loop(tfn, (2, 4, 4, 4), x_T=_t(x),
                           step_noise=_t(step_noise), clip_denoised=clip)
    np.testing.assert_allclose(got.numpy(), xj, rtol=1e-5, atol=1e-5)
    ddim = td.ddim_sample_loop(tfn, (2, 4, 4, 4), x_T=_t(x),
                               step_noise=_t(step_noise), eta=0.5)
    assert torch.isfinite(ddim).all()


# -- timestep sampler -------------------------------------------------------

def test_timestep_sampler_matches_jax():
    T, K = 6, 3
    ts, js = (TTS.init_loss_second_moment(T, K),
              JTS.init_loss_second_moment(T, K))
    np.testing.assert_array_equal(TTS.sampler_weights(ts).numpy(),
                                  np.asarray(JTS.sampler_weights(js)))
    rng = np.random.default_rng(0)
    for _ in range(6):                 # duplicates shift the ring in order
        t = rng.integers(0, T, 5)
        t[1] = t[0]
        losses = rng.random(5).astype(np.float32)
        ts = TTS.update_with_all_losses(ts, _t(t), _t(losses))
        js = JTS.update_with_all_losses(js, jnp.asarray(t),
                                        jnp.asarray(losses))
        np.testing.assert_array_equal(ts.history.numpy(),
                                      np.asarray(js.history))
        np.testing.assert_array_equal(ts.counts.numpy(),
                                      np.asarray(js.counts))
    full = TTS.LossSecondMomentState(_t(rng.random((T, K), np.float32)),
                                     torch.full((T,), K, dtype=torch.int32))
    jfull = JTS.LossSecondMomentState(jnp.asarray(full.history.numpy()),
                                      jnp.asarray(full.counts.numpy()))
    p = TTS.sampler_weights(full, 0.01)
    np.testing.assert_allclose(p.numpy(),
                               np.asarray(JTS.sampler_weights(jfull, 0.01)),
                               rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    t, w = TTS.sample_timesteps(full, gen, 4000, 0.01)
    torch.testing.assert_close(w, 1.0 / (T * p[t]))
    freq = torch.bincount(t, minlength=T).float() / 4000
    assert (freq - p).abs().max() < 0.03
    t, w = TTS.uniform_timesteps(gen, 7, 1000)
    assert t.shape == (7,) and torch.equal(w, torch.ones(7))


def test_update_with_local_losses_gathers_over_the_group():
    import torch.distributed as dist

    t, losses = torch.tensor([1, 1, 3]), torch.tensor([0.5, 0.25, 2.0])
    state = TTS.init_loss_second_moment(4, 2)
    with pytest.raises(RuntimeError, match="process group"):
        TTS.update_with_local_losses(state, t, losses)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        got = TTS.update_with_local_losses(state, t, losses)
    finally:
        dist.destroy_process_group()
    want = TTS.update_with_all_losses(state, t, losses)
    assert torch.equal(got.history, want.history)
    assert torch.equal(got.counts, want.counts)


# -- latent shards ------------------------------------------------------------

def _latent_batches(seed: int, n_batches: int = 5, bs: int = 37):
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        yield (rng.standard_normal((bs, 4, 4, 4)).astype(np.float32),
               rng.integers(0, 5, bs))


@pytest.mark.parametrize("label,keep", [(None, None), (2, "eq"), (2, "ne")])
def test_latent_shards_match_jax(tmp_path, label, keep):
    tp = TLazy.write_latent_shards(str(tmp_path / "t" / "lat"),
                                   _latent_batches(0), 60)
    jp = JLazy.write_latent_shards(str(tmp_path / "j" / "lat"),
                                   _latent_batches(0), 60)
    assert [os.path.basename(p) for p in tp] == \
        [os.path.basename(p) for p in jp]
    for a, b in zip(tp, jp):
        with np.load(a) as da, np.load(b) as db:
            np.testing.assert_array_equal(da["latents"], db["latents"])
            np.testing.assert_array_equal(da["labels"], db["labels"])
    paths = TLazy.list_latent_shards(str(tmp_path / "t"))
    assert paths == JLazy.list_latent_shards(str(tmp_path / "t")) == tp
    assert TLazy.list_latent_shards(str(tmp_path / "t" / "lat")) == tp
    assert TLazy.list_latent_shards(tp[0]) == [tp[0]]
    filt = (None if keep is None else
            (lambda y: y == label) if keep == "eq" else (lambda y: y != label))
    kw = dict(seed=3, keep_label=filt)
    t_it = TLazy.sharded_latent_batches(paths, 16, **kw)
    j_it = JLazy.sharded_latent_batches(paths, 16, **kw)
    for _ in range(12):
        (tx, ty), (jx, jy) = next(t_it), next(j_it)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        assert tx.dtype == np.float32 and ty.dtype == np.int32
    one = list(TLazy.sharded_latent_batches(paths, 16, infinite=False,
                                            process_index=1,
                                            process_count=2, seed=1))
    want = list(JLazy.sharded_latent_batches(paths, 16, infinite=False,
                                             process_index=1,
                                             process_count=2, seed=1))
    assert len(one) == len(want) > 0
    for (a, b), (c, d) in zip(one, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    with pytest.raises(FileNotFoundError):
        next(TLazy.sharded_latent_batches([], 4))
