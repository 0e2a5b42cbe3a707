"""The port's SD workload vs the JAX package's (CPU): every loss function
with t and noise injected (the port's ``SDWorkload.draw`` replaced by the
JAX functions' own draws from their keys), the proximal operator, the three
samplers of ``make_sampler`` and the quick sampler with an injected x_T,
``get_learned_conditioning`` and ``get_input``. The JAX workload's UNet
apply is jitted once; its losses and samplers run as they are around it.
TINY_UNET at 8 x 8 latents, TINY_TEXT (context 16 x 8)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from uurg_torch.io.jax_interop import (jax_clip_text_params_to_torch,  # noqa: E402
                                       jax_sd_unet_params_to_torch,
                                       jax_vae_params_to_torch)
from tests.test_torch_sd_unet import jax_unet_params  # noqa: E402
from uurg_torch.models import clip_text as TC  # noqa: E402
from uurg_torch.models.autoencoder_kl import AutoencoderKL, init_vae  # noqa: E402
from uurg_torch.models.autoencoder_kl import VAEConfig as TVAEConfig  # noqa: E402
from uurg_torch.models.clip_text import CLIPTextConfig as TTextConfig  # noqa: E402
from uurg_torch.models.clip_text import CLIPTextEncoder  # noqa: E402
from uurg_torch.models.sd_unet import SDUNet, SDUNetConfig  # noqa: E402
from uurg_torch.workloads.sd import SDWorkload  # noqa: E402
from uurg_tpu.io.vae_clip_interop import compvis_vae_to_flax  # noqa: E402
from uurg_tpu.models import autoencoder_kl as JV  # noqa: E402
from uurg_tpu.models import clip_text as JC  # noqa: E402
from uurg_tpu.models import sd_unet as JU  # noqa: E402
from uurg_tpu.workloads import sd as JW  # noqa: E402

UNET = dict(model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
            attention_ds=(1, 2), num_heads=2, context_dim=16)
TEXT = dict(vocab_size=49408, max_length=8, hidden_size=16, depth=2,
            num_heads=2)
VAE = dict(base_channels=8, channel_mult=(1, 1), num_res_blocks=1)
LATENT, B = 8, 2
# float32 on both sides: the UNet's own 1e-5, through a mean of squares
LOSS_REL = 1e-5
GRAD_REL = 1e-4
SAMPLE_REL = 1e-5
PROMPTS = ["a photo of a nude person", "a person wearing clothes"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _crc32_tier():
    """Both packages on the crc32 tokenizer tier (the CLIP tests hold the
    tiers and their resolution; resolving one here would import
    ``transformers`` twice, ~7 s each)."""
    tier = ("crc32-fallback", JC.hash_tokenize)
    saved = TC._resolve_tokenizer, JC._resolve_tokenizer
    TC._resolve_tokenizer = JC._resolve_tokenizer = lambda: tier
    yield
    TC._resolve_tokenizer, JC._resolve_tokenizer = saved


@pytest.fixture(scope="module")
def pair():
    """(JAX workload, JAX UNet params, JAX frozen params, port workload,
    port UNet, port frozen UNet)."""
    jcfg = JU.SDUNetConfig(**UNET, dtype=jnp.float32, remat=False)
    jwl = JW.SDWorkload.build(jcfg, JV.VAEConfig(**VAE),
                              JC.CLIPTextConfig(**TEXT))
    params = jax_unet_params(UNET, perturb_seed=1)
    frozen = jax_unet_params(UNET, perturb_seed=2)
    _, jwl.text_params = JC.init_clip_text(jax.random.key(2), jwl.text.cfg)
    # the port's seeded VAE through the JAX package's CompVis map (the JAX
    # init's jitted trace costs seconds)
    vae = init_vae(1, TVAEConfig(**VAE))
    jwl.vae_params = compvis_vae_to_flax(
        {f"first_stage_model.{k}": v for k, v in vae.state_dict().items()},
        jwl.vae.cfg)
    apply = jax.jit(lambda p, z, t, c: jwl.unet.apply({"params": p}, z, t,
                                                       c))
    jwl.apply_model = apply

    twl = SDWorkload.build(SDUNetConfig(**UNET, dtype=torch.float32,
                                        remat=False),
                           TVAEConfig(**VAE), TTextConfig(**TEXT),
                           device="cpu")
    twl.text = CLIPTextEncoder(twl.text_cfg)
    twl.text.load_state_dict(jax_clip_text_params_to_torch(jwl.text_params))
    twl.vae = AutoencoderKL(twl.vae_cfg)
    twl.vae.load_state_dict(jax_vae_params_to_torch(jwl.vae_params))

    def unet(p):
        m = SDUNet(twl.unet_cfg)
        m.load_state_dict(jax_sd_unet_params_to_torch(p), strict=True)
        return m

    return jwl, params, frozen, twl, unet(params), unet(frozen)


def _jax_draw(key, z):
    """The draws of one JAX loss term from its key."""
    k_t, k_n = jax.random.split(key)
    t = jax.random.randint(k_t, (z.shape[0],), 0, 1000)
    return t, jax.random.normal(k_n, z.shape, z.dtype)


def _inject(monkeypatch, twl, draws):
    """Replace the port workload's draws by ``draws`` (numpy), in order."""
    queue = [(torch.tensor(np.asarray(t)).long(),
              torch.tensor(np.asarray(n))) for t, n in draws]
    monkeypatch.setattr(twl, "draw", lambda z, gen: queue.pop(0))
    return queue


def _batch(seed, n_ctx):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, LATENT, LATENT, 4)).astype(np.float32)
    return (z, *(rng.standard_normal((B, TEXT["max_length"], 16))
                 .astype(np.float32) for _ in range(n_ctx)))


def _t(batch):
    return tuple(torch.from_numpy(np.asarray(a)) for a in batch)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


LOSSES = {
    # name: (JAX factory, port factory, contexts in the batch)
    "shared_step": (lambda w: w.shared_step_loss,
                    lambda w: w.shared_step_loss, 1),
    "nsfw_forget": (lambda w: w.nsfw_forget_loss_fn(),
                    lambda w: w.nsfw_forget_loss_fn(), 2),
    "rl_forget": (lambda w: w.rl_forget_loss_fn(),
                  lambda w: w.rl_forget_loss_fn(), 2),
    "fisher": (lambda w: w.fisher_loss_fn(3.0),
               lambda w: w.fisher_loss_fn(3.0), 2),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_matches_jax(pair, monkeypatch, name):
    jwl, params, _, twl, model, _ = pair
    jfac, tfac, n_ctx = LOSSES[name]
    batch = _batch(3, n_ctx)
    key = jax.random.key(11)
    want = float(jfac(jwl)(params, tuple(map(jnp.asarray, batch)), key))
    left = _inject(monkeypatch, twl, [_jax_draw(key, batch[0])])
    got = tfac(twl)(model, _t(batch), None)
    assert not left
    assert abs(got.item() - want) <= LOSS_REL * abs(want)


def test_ga_loss_matches_jax(pair, monkeypatch):
    jwl, params, _, twl, model, _ = pair
    fb, rb = _batch(4, 1), _batch(5, 1)
    key = jax.random.key(12)
    want = float(jwl.ga_loss_fn(0.7)(
        params, (tuple(map(jnp.asarray, fb)), tuple(map(jnp.asarray, rb))),
        key))
    k1, k2 = jax.random.split(key)
    _inject(monkeypatch, twl, [_jax_draw(k1, fb[0]), _jax_draw(k2, rb[0])])
    got = twl.ga_loss_fn(0.7)(model, (_t(fb), _t(rb)), None)
    assert abs(got.item() - want) <= LOSS_REL * abs(want)


def test_esd_loss_matches_jax(pair):
    jwl, params, frozen, twl, model, frozen_model = pair
    z_t, c, c0 = _batch(6, 2)
    t = np.array([17, 640], np.int32)
    want = float(jwl.esd_loss_fn(1.5)(
        params, (jnp.asarray(z_t), jnp.asarray(t), jnp.asarray(c),
                 jnp.asarray(c0)), None, frozen))
    frozen_model.requires_grad_(False)
    loss = twl.esd_loss_fn(frozen_model, 1.5)(
        model, _t((z_t, t, c, c0)), None)
    assert abs(loss.item() - want) <= LOSS_REL * abs(want)
    # the frozen twin gets no gradient, the model does
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert all(p.grad is None for p in frozen_model.parameters())
    assert sum(g.norm() for g in grads) > 0


def test_fisher_gradients_match_jax(pair, monkeypatch):
    jwl, params, _, twl, model, _ = pair
    batch = _batch(7, 2)
    key = jax.random.key(13)
    fn = jwl.fisher_loss_fn(3.0)
    grads = jax.grad(lambda p: fn(p, tuple(map(jnp.asarray, batch)),
                                  key))(params)
    want = jax_sd_unet_params_to_torch(grads)
    _inject(monkeypatch, twl, [_jax_draw(key, batch[0])])
    got = dict(zip(dict(model.named_parameters()), torch.autograd.grad(
        twl.fisher_loss_fn(3.0)(model, _t(batch), None),
        list(model.parameters()))))
    flat = [torch.cat([d[k].reshape(-1) for k in want]) for d in (got, want)]
    assert rel(flat[0].numpy(), flat[1].numpy()) <= GRAD_REL


def test_draw_is_seeded(pair):
    twl = pair[3]
    z = torch.zeros(3, 4, 4, 4)
    a = twl.draw(z, torch.Generator().manual_seed(5))
    b = twl.draw(z, torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].min() >= 0 and a[0].max() < 1000


@pytest.mark.parametrize("top_ratio", [0.05])
def test_prox_operator_matches_jax(pair, top_ratio):
    jwl, params, frozen, twl, _, _ = pair
    want = jax_sd_unet_params_to_torch(
        jwl.make_prox_operator(frozen, top_ratio)(params))
    deltas = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        jnp.subtract, params, frozen))
    flat = jnp.concatenate([jnp.abs(d).ravel() for d in deltas])
    thresh = jnp.sort(flat)[-max(1, int(flat.size * top_ratio))]
    init, model = (SDUNet(twl.unet_cfg) for _ in range(2))
    init.load_state_dict(jax_sd_unet_params_to_torch(frozen))
    model.load_state_dict(jax_sd_unet_params_to_torch(params))
    got = twl.make_prox_operator(init, top_ratio)(model)
    assert got.item() == float(thresh)
    sd = model.state_dict()
    assert all(torch.equal(sd[k], want[k]) for k in want)


def test_learned_conditioning_matches_jax(pair):
    jwl, _, _, twl, _, _ = pair
    want = np.asarray(jwl.get_learned_conditioning(PROMPTS + [""]))
    got = twl.get_learned_conditioning(PROMPTS + [""])
    assert got.shape == (3, TEXT["max_length"], 16)
    assert rel(got.numpy(), want) <= 1e-5


def test_get_input_matches_jax(pair):
    jwl, _, _, twl, _, _ = pair
    images = np.random.default_rng(8).uniform(
        -1, 1, (B, 8, 8, 3)).astype(np.float32)
    key = jax.random.key(14)
    z, ctx = jwl.get_input(jnp.asarray(images), PROMPTS, key)
    noise = jax.random.normal(key, z.shape, jnp.float32)
    got_z, got_ctx = twl.get_input(torch.from_numpy(images), PROMPTS,
                                   noise=torch.from_numpy(np.asarray(noise)))
    assert got_z.shape == (B, 4, 4, 4)
    assert rel(got_z.numpy(), np.asarray(z)) <= 1e-5
    assert rel(got_ctx.numpy(), np.asarray(ctx)) <= 1e-5


@pytest.mark.parametrize("method", ["ddim", "plms", "lms"])
def test_make_sampler_matches_jax(pair, method):
    jwl, params, _, twl, model, _ = pair
    ctx = _batch(9, 1)[1]
    key = jax.random.key(15)
    kw = dict(num_steps=2, guidance_scale=7.5, latent_size=LATENT,
              method=method)
    want = np.asarray(jwl.make_sampler(**kw)(params, jnp.asarray(ctx), key))
    x_T = jax.random.normal(jax.random.split(key)[0], (B, LATENT, LATENT, 4))
    got = twl.make_sampler(**kw)(model, torch.from_numpy(ctx),
                                 x_T=torch.from_numpy(np.asarray(x_T)))
    assert got.shape == (B, LATENT, LATENT, 4)
    assert rel(got.numpy(), want) <= SAMPLE_REL


def test_make_sampler_rejects_unknown_method(pair):
    with pytest.raises(ValueError, match="method"):
        pair[3].make_sampler(method="euler")


def test_quick_sampler_matches_jax(pair):
    jwl, params, _, twl, model, _ = pair
    _, ctx, ctx0 = _batch(10, 2)
    x_T = _batch(11, 0)[0]
    want = np.asarray(jwl.make_quick_sampler(ddim_steps=5)(
        params, jnp.asarray(ctx), jnp.asarray(ctx0), jnp.asarray(x_T), 3))
    got = twl.make_quick_sampler(ddim_steps=5)(
        model, *_t((ctx, ctx0, x_T)), 3)
    assert rel(got.numpy(), want) <= SAMPLE_REL


def test_build_defaults():
    wl = SDWorkload.build(device="cpu")
    assert wl.unet_cfg == SDUNetConfig() and wl.schedule.num_timesteps == 1000
    assert dataclasses.asdict(wl.text_cfg)["max_length"] == 77
    np.testing.assert_allclose(
        wl.schedule.betas.numpy(),
        np.asarray(JW.SDWorkload.build().schedule.betas), rtol=1e-7)
