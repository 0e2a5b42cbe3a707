"""uurg_torch schedules, samplers, runner and sampling CLI vs the JAX package
(CPU, fp32)."""
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from uurg_torch.core.config import load_config  # noqa: E402
from uurg_torch.diffusion import sampling as TS  # noqa: E402
from uurg_torch.diffusion.schedules import make_schedule  # noqa: E402
from uurg_torch.io.jax_interop import jax_unet_params_to_torch  # noqa: E402
from uurg_torch.models import unet_cond as TU  # noqa: E402
from uurg_torch.workloads import ddpm_runner as TR  # noqa: E402
from uurg_torch.workloads.ddpm import DDPMWorkload  # noqa: E402
from uurg_tpu.core.config import load_config as jax_load_config  # noqa: E402
from uurg_tpu.data.transforms import inverse_data_transform  # noqa: E402
from uurg_tpu.diffusion import sampling as JS  # noqa: E402
from uurg_tpu.diffusion import schedules as JSch  # noqa: E402
from uurg_tpu.models import unet_cond as JU  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SFRON = os.path.join(ROOT, "configs", "cifar10_sfron.yml")
TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
            dropout=0.0, resolution=32)


def _tiny_config(batch_size=4):
    cfg = load_config(SFRON)
    model = {**cfg.model.to_dict(), "ch": 32, "ch_mult": [1, 2],
             "num_res_blocks": 1}
    return cfg.merged({"model": model, "sampling": {"batch_size": batch_size}})


@pytest.mark.parametrize("kind,var_type", [
    ("linear", "fixedlarge"), ("quad", "fixedsmall"), ("sigmoid", "fixedlarge"),
    ("const", "fixedsmall"), ("jsd", "fixedlarge")])
def test_schedules_equal(kind, var_type):
    args = (kind, 1e-4, 2e-2, 1000)
    mine = make_schedule(*args, var_type=var_type)
    ref = JSch.make_schedule(*args, var_type=var_type)
    for name in ("betas", "alphas_cumprod", "logvar"):
        np.testing.assert_array_equal(getattr(mine, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    t = np.array([-1, 0, 17, 999])
    np.testing.assert_array_equal(mine.alpha_bar_padded(torch.from_numpy(t)),
                                  np.asarray(ref.alpha_bar_padded(t)))
    rng = np.random.default_rng(0)
    x0, noise = (rng.standard_normal((4, 2, 2, 3), dtype=np.float32)
                 for _ in range(2))
    np.testing.assert_allclose(
        mine.q_sample(torch.from_numpy(x0), torch.from_numpy(t[1:].repeat(2)[:4]),
                      torch.from_numpy(noise)).numpy(),
        np.asarray(ref.q_sample(x0, t[1:].repeat(2)[:4], noise)), rtol=1e-6)


@pytest.mark.parametrize("kind,steps,offset", [
    ("uniform", 50, 0), ("uniform", 7, 0), ("uniform", 50, 1), ("quad", 20, 0)])
def test_step_sequence_equal(kind, steps, offset):
    mine = TS.make_step_sequence(1000, steps, kind, offset)
    ref = JS.make_step_sequence(1000, steps, kind, offset)
    np.testing.assert_array_equal(mine, ref)
    for a, b in zip(TS._seq_pairs(mine), JS._seq_pairs(ref)):
        np.testing.assert_array_equal(a, b)


def test_ddim_cfg_10_steps_matches_jax():
    _, params = JU.init_unet(jax.random.key(0),
                             JU.UNetConfig(dtype=jnp.float32, **TINY))
    rng = np.random.default_rng(3)
    x_T = rng.standard_normal((3, 32, 32, 3), dtype=np.float32)
    labels = np.array([1, 4, 9], np.int32)
    seq = JS.make_step_sequence(1000, 10)

    jmodel = JU.CondUNet(JU.UNetConfig(dtype=jnp.float32, **TINY))
    jfn = JS.cfg_model_fn(
        lambda x, t, c, k: jmodel.apply({"params": params}, x, t, c, k),
        jnp.asarray(labels), 2.0)
    want = np.asarray(JS.ddim_sample(jfn, JSch.make_schedule(), x_T, seq))

    model = TU.CondUNet(TU.UNetConfig(dtype=torch.float32, **TINY)).eval()
    model.load_state_dict(jax_unet_params_to_torch(params), strict=True)
    tfn = TS.cfg_model_fn(model, torch.from_numpy(labels).long(), 2.0)
    with torch.inference_mode():
        got = TS.ddim_sample(tfn, make_schedule(), torch.from_numpy(x_T),
                             TS.make_step_sequence(1000, 10)).numpy()
    # fp32; the first step divides by sqrt(alpha_bar_900) ~ 0.06, which
    # scales the forward's 1e-5-level differences up
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_ddpm_step_with_injected_noise_matches_numpy():
    sched = make_schedule()
    seq = TS.make_step_sequence(1000, 4)          # [0, 250, 500, 750]
    rng = np.random.default_rng(5)
    x_T = rng.standard_normal((2, 4, 4, 3), dtype=np.float32)
    noise = rng.standard_normal((4, 2, 4, 4, 3), dtype=np.float32)

    def model_fn(x, t):
        return 0.1 * x + (t.float() / 1000.0)[:, None, None, None]

    got = TS.ddpm_sample(model_fn, sched, torch.from_numpy(x_T), seq,
                         noise=torch.from_numpy(noise)).numpy()

    ab = np.concatenate([[1.0], sched.alphas_cumprod.numpy().astype(np.float64)])
    x = x_T.astype(np.float64)
    for i, (t, tn) in enumerate([(750, 500), (500, 250), (250, 0), (0, -1)]):
        at, atm1 = ab[t + 1], ab[tn + 1]
        beta = 1.0 - at / atm1
        e = 0.1 * x + t / 1000.0
        x0 = np.clip(np.sqrt(1.0 / at) * x - np.sqrt(1.0 / at - 1.0) * e, -1, 1)
        mean = (np.sqrt(atm1) * beta * x0
                + np.sqrt(1.0 - beta) * (1.0 - atm1) * x) / (1.0 - at)
        x = mean + (t > 0) * np.exp(0.5 * np.log(beta)) * noise[i]
    np.testing.assert_allclose(got, x, rtol=1e-5, atol=1e-5)


def test_uint8_conversion_equal():
    cfg = load_config(SFRON)
    rng = np.random.default_rng(7)
    x = rng.uniform(-1.2, 1.2, (6, 4, 4, 3)).astype(np.float32)
    x[0, 0, 0] = [-1.0, 1.0, 0.0]                 # both clamp edges and a mid value
    x[0, 0, 1] = [1.0 / 255 - 1, 2.5 / 255 - 1, 0.5 / 255 - 1]   # .5 ties
    mine = TR.to_uint8(cfg, torch.from_numpy(x)).numpy()
    ref = (np.asarray(inverse_data_transform(jax_load_config(SFRON), x))
           * 255.0).round().astype(np.uint8)
    np.testing.assert_array_equal(mine, ref)


def test_sample_images_pads_last_batch_and_returns_uint8():
    cfg = _tiny_config(batch_size=4)
    wl = DDPMWorkload.from_config(cfg, dtype=torch.float32, device="cpu")
    model = wl.init_params(0)
    labels = np.array([0, 1, 2, 3, 4])
    imgs = TR.sample_images(None, cfg, model, labels, num_steps=2, seed=11)
    assert imgs.dtype == np.uint8 and imgs.shape == (5, 32, 32, 3)
    # the first batch is what the sampler gives for the first four labels
    sampler = wl.make_sampler(num_steps=2)
    gen = torch.Generator().manual_seed(11)
    x = sampler(model, torch.arange(4), gen)
    np.testing.assert_array_equal(TR.to_uint8(cfg, x).numpy(), imgs[:4])


def test_unet_config_defaults_equal_sfron_yaml():
    cfg = load_config(SFRON)
    assert TU.UNetConfig.from_config(cfg) == TU.UNetConfig()
    jax_cfg = JU.UNetConfig.from_config(jax_load_config(SFRON))
    for f in ("in_channels", "out_channels", "ch", "ch_mult", "num_res_blocks",
              "attn_resolutions", "dropout", "resamp_with_conv", "resolution",
              "n_classes", "cond_drop_prob"):
        assert getattr(TU.UNetConfig(), f) == getattr(jax_cfg, f), f
    # chip_smoke.py reads the file with the port's reader (the card's
    # machine has no PyYAML): what it loads is PyYAML's reading of it
    yaml = pytest.importorskip("yaml")
    with open(SFRON) as f:
        assert chip_smoke.sfron_config().to_dict() == yaml.safe_load(f)
    assert chip_smoke.SFRON_YML == SFRON


def test_load_params_reads_reference_checkpoint(tmp_path):
    cfg = _tiny_config()
    wl = DDPMWorkload.from_config(cfg, dtype=torch.float32, device="cpu")
    raw, ema = wl.init_params(1), wl.init_params(2)
    ckpt = tmp_path / "ckpts" / "ckpt.pth"
    ckpt.parent.mkdir()

    def sd(m):
        return {f"module.{k}": v for k, v in m.state_dict().items()}

    torch.save([sd(raw), {}, 7, sd(ema)], ckpt)

    class Args:
        ckpt_folder = str(tmp_path)
        seed = 0

    for use_ema, src in ((False, raw), (True, ema)):
        got = TR.load_params(Args, cfg, wl, use_ema=use_ema)
        for (k, a), b in zip(got.state_dict().items(), src.state_dict().values()):
            assert torch.equal(a, b), k


def test_sample_cli_visualization_on_cpu(tmp_path):
    pytest.importorskip("yaml")
    pytest.importorskip("PIL")
    import yaml

    from uurg_torch.cli import sample as cli

    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(yaml.safe_dump(_tiny_config(batch_size=10).to_dict()))
    out = tmp_path / "out"
    cli.main(["--config", str(cfg_path), "--ckpt_folder", str(tmp_path),
              "--mode", "visualization", "--sample_steps", "1",
              "--device", "cpu", "--out", str(out)])
    assert (out / "grid.png").exists()
