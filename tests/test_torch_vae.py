"""The port's AutoencoderKL against the JAX package's (CPU, fp32): the
moments, a posterior draw with the same noise and the decoder at the JAX
tests' tiny configuration, on weights carried across by
``jax_vae_params_to_torch``; the CompVis key map against the JAX one; the
port's own VAE file; the float32 attention at the VAE's head width 512
against the Pallas kernel in interpret mode; and the float32 kernels' plan
for widths above 256 (a forward only; the backward and bfloat16 raise).
The width-512 kernel itself is held on the card (``chip_smoke.py`` phase
19)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tests.test_vae_clip_interop import TINY_VAE, fake_compvis_vae  # noqa: E402
from uurg_torch.io import vae_interop as VI  # noqa: E402
from uurg_torch.io.jax_interop import jax_vae_params_to_torch  # noqa: E402
from uurg_torch.models import autoencoder_kl as TV  # noqa: E402
from uurg_torch.ops import flash_attention as FA  # noqa: E402
from uurg_tpu.io.vae_clip_interop import compvis_vae_to_flax  # noqa: E402
from uurg_tpu.models import autoencoder_kl as JV  # noqa: E402
from uurg_tpu.ops.flash_attention import (_reference_attention,  # noqa: E402
                                          fused_attention)

# fp32 on both sides, the convolutions and GroupNorm sums in another order
VAE_REL = 1e-5
ATTN_REL = 1e-5
TINY = TV.VAEConfig(base_channels=16, channel_mult=(1, 2), num_res_blocks=1)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs (several pytest-xdist
    workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX params, the port's model with those weights)."""
    jm, jp = JV.init_vae(jax.random.key(0), TINY_VAE, resolution=16)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    tm = TV.AutoencoderKL(TINY).eval()
    tm.load_state_dict(jax_vae_params_to_torch(jp), strict=True)
    return jm, jp, tm


def _images(n, size, seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, size, size, 3)).astype(np.float32)


def test_config_is_the_jax_default():
    j, t = JV.VAEConfig(), TV.VAEConfig()
    for f in ("in_channels", "latent_channels", "base_channels",
              "channel_mult", "num_res_blocks", "scale_factor"):
        assert getattr(j, f) == getattr(t, f), f
    with torch.device("meta"):
        n = sum(p.numel() for p in TV.AutoencoderKL().parameters())
    assert n == 83_653_863


@pytest.mark.parametrize("size", [16, 32])
def test_encode_moments_match_jax(tiny, size):
    jm, jp, tm = tiny
    x = _images(2, size, size)
    want = jm.apply({"params": jp}, jnp.asarray(x),
                    method=JV.AutoencoderKL.encode_moments)
    with torch.no_grad():
        got = tm.encode_moments(torch.from_numpy(x))
    assert got.shape == (2, size // 2, size // 2, 8)
    assert _rel(got.numpy(), want) <= VAE_REL


def test_encode_with_the_same_noise_and_the_mean_match_jax(tiny):
    jm, jp, tm = tiny
    x = _images(3, 16, 1)
    key = jax.random.key(5)
    want = jm.apply({"params": jp}, jnp.asarray(x), key,
                    method=JV.AutoencoderKL.encode)
    # the draw JAX's encode makes from its key, injected into the port
    noise = np.array(jax.random.normal(key, (3, 8, 8, 4), jnp.float32))
    want_mean = jm.apply({"params": jp}, jnp.asarray(x),
                         method=JV.AutoencoderKL.encode)
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(x), noise=torch.from_numpy(noise))
        got_mean = tm.encode(torch.from_numpy(x))
    assert _rel(got.numpy(), want) <= VAE_REL
    assert _rel(got_mean.numpy(), want_mean) <= VAE_REL
    assert _rel(got.numpy(), want_mean) > 1e-3        # the draw is seen
    # a generator draws the noise: the same seed, the same latents
    g = [torch.Generator().manual_seed(3) for _ in range(2)]
    with torch.no_grad():
        a, b = (tm.encode(torch.from_numpy(x), generator=gi) for gi in g)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_logvar_is_clipped_as_in_jax(tiny):
    jm, jp, tm = tiny
    # a quant_conv bias that pushes the log-variance far past 20 and -30
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    sd["quant_conv.bias"][4:] = torch.tensor([90.0, -90.0, 60.0, -60.0])
    jp2 = jax.tree_util.tree_map(lambda a: a, jp)
    jp2["quant_conv"] = dict(jp["quant_conv"],
                             bias=sd["quant_conv.bias"].numpy())
    tm2 = TV.AutoencoderKL(TINY)
    tm2.load_state_dict(sd)
    x = _images(1, 16, 2)
    key = jax.random.key(1)
    want = jm.apply({"params": jp2}, jnp.asarray(x), key,
                    method=JV.AutoencoderKL.encode)
    noise = np.array(jax.random.normal(key, (1, 8, 8, 4), jnp.float32))
    with torch.no_grad():
        got = tm2.encode(torch.from_numpy(x), noise=torch.from_numpy(noise))
    assert np.isfinite(got.numpy()).all()
    assert _rel(got.numpy(), want) <= VAE_REL


@pytest.mark.parametrize("size", [8, 16])
def test_decode_matches_jax(tiny, size):
    jm, jp, tm = tiny
    z = np.random.default_rng(size).standard_normal(
        (2, size, size, 4)).astype(np.float32)
    want = jm.apply({"params": jp}, jnp.asarray(z),
                    method=JV.AutoencoderKL.decode)
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(z))
    assert got.shape == (2, 2 * size, 2 * size, 3)
    assert _rel(got.numpy(), want) <= VAE_REL


def test_round_trip_matches_jax(tiny):
    jm, jp, tm = tiny
    x = _images(2, 32, 7)
    want = jm.apply({"params": jp}, jnp.asarray(x))        # the mean path
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert _rel(got.numpy(), want) <= VAE_REL


def test_init_vae_is_seeded_and_frozen():
    a, b = TV.init_vae(3, TINY), TV.init_vae(3, TINY)
    c = TV.init_vae(4, TINY)
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not all(torch.equal(va, vc) for va, vc in
                   zip(a.state_dict().values(), c.state_dict().values()))
    assert not a.training
    assert not any(p.requires_grad for p in a.parameters())
    # flax's LeCun-normal kernels and zero biases
    w = a.encoder.down[1].block[0].conv1.weight
    assert abs(w.std().item() * (w[0].numel() ** 0.5) - 1.0) < 0.1
    assert torch.equal(a.encoder.conv_in.bias, torch.zeros(16))


# -- checkpoints ------------------------------------------------------------

def test_compvis_map_equals_the_jax_map_then_jax_vae_params_to_torch():
    sd = fake_compvis_vae(TINY_VAE)
    want = jax_vae_params_to_torch(compvis_vae_to_flax(sd, TINY_VAE))
    got = VI.compvis_vae_to_torch(sd, TINY)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


def test_compvis_map_reads_vae_files_and_linear_attention():
    # a standalone VAE file (no prefix, the training loss's keys beside
    # the model's) with Linear attention weights maps to the same dict
    sd = fake_compvis_vae(TINY_VAE)
    want = VI.compvis_vae_to_torch(sd, TINY)
    bare = {k.removeprefix("first_stage_model."): v for k, v in sd.items()}
    bare["loss.logvar"] = np.zeros(())
    for k in list(bare):
        if ".attn_1." in k and k.endswith(".weight") and "norm" not in k:
            bare[k] = bare[k][:, :, 0, 0]
    got = VI.compvis_vae_to_torch(bare, TINY)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    del bare["decoder.conv_out.bias"]
    with pytest.raises(KeyError, match="decoder.conv_out.bias"):
        VI.compvis_vae_to_torch(bare, TINY)


def test_load_vae_reads_a_compvis_ckpt_and_the_ports_file(tiny, tmp_path):
    _, _, tm = tiny
    sd = fake_compvis_vae(TINY_VAE)
    ckpt = tmp_path / "sd.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()},
                "global_step": 7}, ckpt)
    model = VI.load_vae(str(ckpt), cfg=TINY)
    want = VI.compvis_vae_to_torch(sd, TINY)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert not model.training
    assert not any(p.requires_grad for p in model.parameters())
    own = tmp_path / "vae.pt"
    VI.save_vae(str(own), tm)
    back = VI.load_vae(str(own))
    assert back.cfg == TINY
    for (k, v), w in zip(back.state_dict().items(), tm.state_dict().values()):
        assert torch.equal(v, w), k


@pytest.mark.parametrize("path", ["orbax_dir", "vae.npz"])
def test_vae_checkpoint_refuses_orbax_and_other_files(tmp_path, path):
    target = tmp_path / path
    if path == "orbax_dir":
        target.mkdir()
    with pytest.raises(ValueError, match="Orbax"):
        VI.load_vae(str(target))


# -- the attention at the VAE's head width ----------------------------------

@pytest.mark.parametrize("T", [128, 100])
def test_plain_attention_at_width_512_matches_pallas_interpret(T):
    """One head of width 512, as the VAE's mid blocks: the Pallas
    ``_attn_kernel`` in interpret mode (the JAX dispatcher's kernel at T %
    128 == 0; one block of T rows at the ragged T) against the plain
    version, and at the ragged T the JAX dispatcher's own XLA route."""
    rng = np.random.default_rng(T)
    q, k, v = (rng.standard_normal((2, 1, T, 512), dtype=np.float32)
               for _ in range(3))
    want = fused_attention(*(jnp.asarray(a) for a in (q, k, v)), T, True)
    got = FA.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    assert _rel(got.numpy(), want) <= ATTN_REL
    if T % 128:
        xla = _reference_attention(*(jnp.asarray(a) for a in (q, k, v)))
        assert _rel(got.numpy(), xla) <= ATTN_REL


@pytest.mark.parametrize("D,Dp", [(512, 512), (320, 320), (300, 320),
                                  (448, 448), (260, 320)])
def test_f32_plan_sends_widths_above_256_to_the_xwide_forward(D, Dp):
    assert FA._f32_plan(32, 1, 1024, D) == ("xwide", None)
    assert FA._kernel_width(torch.empty(1, 1, 4, D)) == Dp
    assert "xwide" in FA._F32_ROUTES


def test_width_512_backward_and_bf16_raise_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        FA._f32_plan(32, 1, 1024, 512, backward=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        FA._kernel_width(torch.empty(1, 1, 4, 512, dtype=torch.bfloat16))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        FA._bf16_plan(*(torch.empty(1, 1, 4, 512, dtype=torch.bfloat16)
                        for _ in range(3)))
    # the backward up to 256 keeps its routes
    assert FA._f32_plan(2, 3, 197, 256, backward=True).route == "wide"
    with pytest.raises(ValueError, match="512"):
        FA._f32_plan(1, 1, 16, 576)


def test_vae_attention_on_the_cpu_is_the_plain_version(tiny):
    # the dispatcher on CPU tensors runs the plain version and counts no
    # launch
    _, _, tm = tiny
    h = torch.randn(1, 32, 8, 8, generator=torch.Generator().manual_seed(0))
    before = (FA.attention.launches_f32, FA.attention_bwd.launches_f32)
    with torch.no_grad():
        out = tm.encoder.mid.attn_1(h)
    assert out.shape == h.shape and torch.isfinite(out).all()
    assert (FA.attention.launches_f32,
            FA.attention_bwd.launches_f32) == before
