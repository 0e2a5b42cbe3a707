"""The port's SD checkpoint maps vs the JAX package's (CPU), and the SD
Fisher CLI.

- ``compvis_unet_to_torch`` and ``hf_clip_text_to_torch`` bit-equal to the
  JAX maps followed by ``jax_interop``'s; ``torch_unet_to_compvis`` an exact
  round trip; ``load_compvis_sd_checkpoint`` on a tiny ``.ckpt``;
- ``sd_generate_fisher`` at tiny configs on seeded PNG folders: its three
  files equal to ``accumulate_fisher`` and ``fisher_ratio_mask`` called
  directly; ``--ckpt_path``;
- the JAX CLI's batch stream, which drops the empty prompt's context that
  its Fisher loss unpacks (the port keeps it)."""
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tests.test_vae_clip_interop import fake_hf_clip  # noqa: E402
from uurg_torch.io import sd_interop as TSI  # noqa: E402
from uurg_torch.io import vae_clip_interop as TVC  # noqa: E402
from uurg_torch.io.jax_interop import (jax_clip_text_params_to_torch,  # noqa: E402
                                       jax_sd_unet_params_to_torch,
                                       jax_vae_params_to_torch)
from uurg_torch.models import clip_text as TC  # noqa: E402
from uurg_torch.models import sd_unet as TU  # noqa: E402
from uurg_torch.models.autoencoder_kl import VAEConfig, init_vae  # noqa: E402
from uurg_tpu.io import sd_interop as JSI  # noqa: E402
from uurg_tpu.io import vae_clip_interop as JVC  # noqa: E402
from uurg_tpu.models import autoencoder_kl as JV  # noqa: E402
from uurg_tpu.models import clip_text as JC  # noqa: E402
from uurg_tpu.models import sd_unet as JU  # noqa: E402

UNET = dict(model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
            attention_ds=(1, 2), num_heads=2, context_dim=16)
TEXT = dict(vocab_size=64, max_length=8, hidden_size=16, depth=2,
            num_heads=2)
VAE = dict(base_channels=8, channel_mult=(1, 1), num_res_blocks=1)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _unet(seed: int = 0, **kw) -> TU.SDUNet:
    return TU.init_sd_unet(seed, TU.SDUNetConfig(**UNET, **kw))


def _equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("shape", ["tiny", "full"])
def test_key_maps_match_jax(shape):
    kw = UNET if shape == "tiny" else {}
    want = [ck for ck, _ in JSI.sd_unet_key_map(JU.SDUNetConfig(**kw))]
    got = [ck for ck, _ in TSI.sd_unet_key_map(TU.SDUNetConfig(**kw))]
    assert got == want
    # every parameter of the model is named once (skips where they exist)
    with torch.device("meta"):
        names = set(TU.SDUNet(TU.SDUNetConfig(**kw)).state_dict())
    mapped = [ours for _, ours in TSI.sd_unet_key_map(TU.SDUNetConfig(**kw))]
    assert len(mapped) == len(set(mapped)) and names <= set(mapped)
    assert all(".skip." in n for n in set(mapped) - names)


def test_compvis_unet_map_is_jax_bit_for_bit():
    model = _unet(1)
    compvis = TSI.torch_unet_to_compvis(model, model.cfg)
    assert all(k.startswith("model.diffusion_model.") for k in compvis)
    compvis["model.diffusion_model.aux.weight"] = torch.zeros(3)   # ignored
    got = TSI.compvis_unet_to_torch(compvis, model.cfg)
    want = jax_sd_unet_params_to_torch(
        JSI.compvis_unet_to_flax(compvis, JU.SDUNetConfig(**UNET)))
    assert _equal(got, want)
    # the round trip is exact
    assert _equal(got, model.state_dict())
    # and the JAX export of those params reads back the same
    back = JSI.flax_unet_to_compvis(
        JSI.compvis_unet_to_flax(compvis, JU.SDUNetConfig(**UNET)),
        JU.SDUNetConfig(**UNET))
    assert _equal(TSI.compvis_unet_to_torch(back, model.cfg), got)


def test_compvis_unet_map_refuses_a_missing_key():
    model = _unet(2)
    compvis = TSI.torch_unet_to_compvis(model, model.cfg)
    del compvis["model.diffusion_model.middle_block.1.proj_in.weight"]
    with pytest.raises(KeyError, match="proj_in"):
        TSI.compvis_unet_to_torch(compvis, model.cfg)


def test_hf_clip_map_is_jax_bit_for_bit():
    sd = fake_hf_clip(JC.CLIPTextConfig(**TEXT))
    for prefix in ("", "text_model."):
        hf = {prefix + k: torch.from_numpy(v) for k, v in sd.items()}
        got = TVC.hf_clip_text_to_torch(hf, TC.CLIPTextConfig(**TEXT))
        want = jax_clip_text_params_to_torch(
            JVC.hf_clip_text_to_flax(hf, JC.CLIPTextConfig(**TEXT)))
        assert _equal(got, want)
    model = TC.CLIPTextEncoder(TC.CLIPTextConfig(**TEXT))
    model.load_state_dict(got, strict=True)


def _tiny_ckpt(path: str) -> dict:
    """A CompVis sd-v1 ``.ckpt`` of the tiny models: the UNet, the first
    stage, the HF CLIP text model, and keys no model reads."""
    unet = _unet(3)
    vae = init_vae(4, VAEConfig(**VAE))
    clip = fake_hf_clip(JC.CLIPTextConfig(**TEXT))
    sd = {**TSI.torch_unet_to_compvis(unet, unet.cfg),
          **{f"first_stage_model.{k}": v for k, v in vae.state_dict().items()},
          **{f"cond_stage_model.transformer.text_model.{k}":
             torch.from_numpy(v) for k, v in clip.items()},
          "betas": torch.linspace(0, 1, 10), "model_ema.decay": torch.ones(())}
    torch.save({"state_dict": sd, "global_step": 7}, path)
    return {"unet": unet.state_dict(), "vae": vae.state_dict()}


def test_load_compvis_sd_checkpoint_matches_jax(tmp_path):
    path = str(tmp_path / "sd-tiny.ckpt")
    ref = _tiny_ckpt(path)
    got = TVC.load_compvis_sd_checkpoint(
        path, TU.SDUNetConfig(**UNET), VAEConfig(**VAE),
        TC.CLIPTextConfig(**TEXT))
    assert _equal(got["unet"], ref["unet"])
    assert _equal(got["vae"], ref["vae"])
    want = JVC.load_compvis_sd_checkpoint(
        path, JU.SDUNetConfig(**UNET), JV.VAEConfig(**VAE),
        JC.CLIPTextConfig(**TEXT))
    assert _equal(got["unet"], jax_sd_unet_params_to_torch(want["unet"]))
    assert _equal(got["vae"], jax_vae_params_to_torch(want["vae"]))
    assert _equal(got["text"], jax_clip_text_params_to_torch(want["text"]))
    TC.CLIPTextEncoder(TC.CLIPTextConfig(**TEXT)).load_state_dict(
        got["text"], strict=True)


# -- sd_generate_fisher ---------------------------------------------------

@pytest.fixture
def tiny_cli(monkeypatch):
    """The SD CLIs on tiny models: the workload's configurations, and the
    crc32 tokenizer tier (resolving one would import ``transformers``)."""
    from uurg_torch.models.clip_text import CLIPTextConfig
    from uurg_torch.workloads.sd import SDWorkload

    build = SDWorkload.build.__func__
    monkeypatch.setattr(SDWorkload, "build", classmethod(
        lambda cls, device=None: build(
            cls, TU.SDUNetConfig(**UNET, dtype=torch.float32),
            VAEConfig(**VAE), CLIPTextConfig(**dict(TEXT, vocab_size=49408)),
            device)))
    monkeypatch.setattr(TC, "_resolve_tokenizer",
                        lambda: ("crc32-fallback", TC.hash_tokenize))


def _png_folder(root, n: int, seed: int) -> str:
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "c0"))
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (20, 18, 3), dtype=np.uint8)) \
            .save(os.path.join(root, "c0", f"{i}.png"))
    return str(root)


def test_sd_generate_fisher_writes_the_fisher_and_masks(tmp_path, tiny_cli):
    from uurg_torch.cli import sd_common, sd_generate_fisher
    from uurg_torch.io.checkpoint import restore_checkpoint
    from uurg_torch.unlearn.fisher import accumulate_fisher
    from uurg_torch.unlearn.saliency import fisher_ratio_mask

    nsfw = _png_folder(tmp_path / "nsfw", 5, 0)
    clothed = _png_folder(tmp_path / "clothed", 3, 1)
    out = str(tmp_path / "out")
    argv = ["--nsfw_data", nsfw, "--not_nsfw_data", clothed, "--n_batches",
            "2", "--batch_size", "2", "--image_size", "16", "--threshold",
            "0.5", "1.0", "--seed", "3", "--save_path", out, "--device",
            "cpu"]
    sd_generate_fisher.main(argv)
    assert sorted(os.listdir(out)) == ["nude_forget", "nude_mask_0.5",
                                       "nude_mask_1.0", "nude_remain"]
    args = sd_generate_fisher.parse_args(argv)
    wl, unet = sd_common.setup_workload(args, "cpu")
    loss = wl.fisher_loss_fn(args.guidance_scale)
    want = {}
    for name, folder, prompt in (("forget", nsfw, args.forget_prompt),
                                 ("remain", clothed, args.remain_prompt)):
        it = sd_common.latent_prompt_batches(
            wl, sd_common.load_images_or_synthetic(folder, 16, 3), prompt, 2,
            3, extra_prompt="")
        z, ctx, ctx0 = next(sd_common.latent_prompt_batches(
            wl, sd_common.load_images_or_synthetic(folder, 16, 3), prompt, 2,
            3, extra_prompt=""))
        assert z.shape == (2, 8, 8, 4) and ctx.shape == ctx0.shape
        assert not torch.equal(ctx, ctx0)            # "" has its own context
        want[name] = accumulate_fisher(loss, unet, it, 3, num_batches=2)
        got = restore_checkpoint(os.path.join(out, f"nude_{name}"), unet)
        assert _equal(got, want[name])
        assert all(torch.isfinite(v).all() for v in got.values())
        assert sum(v.sum() for v in got.values()) > 0
    for th in (0.5, 1.0):
        got = restore_checkpoint(os.path.join(out, f"nude_mask_{th}"), unet)
        assert _equal(got, fisher_ratio_mask(want["forget"], want["remain"],
                                             th))


def test_sd_ckpt_path(tmp_path, tiny_cli):
    from uurg_torch.cli import sd_common

    path = str(tmp_path / "sd.ckpt")
    ref = _tiny_ckpt(path)

    class Args:
        ckpt_path = path

    _, unet = sd_common.setup_workload(Args, "cpu")
    assert _equal(unet.state_dict(), ref["unet"])
    for bad in (str(tmp_path), str(tmp_path / "orbax_step_100")):
        Args.ckpt_path = bad
        with pytest.raises(ValueError, match="Orbax"):
            sd_common.setup_workload(Args, "cpu")


def test_jax_cli_stream_drops_the_empty_prompt(monkeypatch):
    # cli/sd_common.py tests ``if extra_prompt`` and so yields (z, ctx)
    # for sd_generate_fisher's extra_prompt="", which its Fisher loss
    # unpacks as (z, ctx, ctx0): the JAX CLI cannot run its Fisher pass.
    # The port tests ``is not None`` and yields three (the test above).
    from cli import sd_common as JSC

    import uurg_tpu.workloads.sd_runner as JR

    monkeypatch.setattr(JR, "encode_image_folder", lambda wl, imgs, p, key: (
        np.zeros((3, 2, 2, 4), np.float32), np.zeros((1, 8, 16), np.float32)))

    class FakeWorkload:
        def get_learned_conditioning(self, prompts):
            return jnp.ones((1, 8, 16))

    batch = next(JSC.latent_prompt_batches(FakeWorkload(), None, "p", 2, 0,
                                           extra_prompt=""))
    assert len(batch) == 2
