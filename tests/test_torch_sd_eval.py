"""SD's evaluation CLIs (``generate_images``, ``imageclassify``,
``compute_fid``) against the JAX CLIs, run in this process on the CPU:

- the prompt CSV as the JAX CLI reads it with pandas (``pd.read_csv``,
  ``row.get("evaluation_seed", 42)``): the column absent, an empty cell
  (both raise), quoted prompts with commas, ``--from_case``;
- ``generate_images`` at tiny configs, on the same weights carried across
  (the UNet as a CompVis ``--ckpt_path``, the VAE and the text encoder
  through the packages' maps) and each case's x_T the JAX CLI's own draw
  (``jax.random.split(jax.random.key(seed))[0]``) handed to the port: the
  same PNG files within one level (both sample in float32; the uint8
  truncation turns a 1e-6 difference at a level's edge into one level), for
  lms and ddim at 2 steps;
- ``imageclassify`` with ResNet18: the JAX CLI's seed-0 init carried into a
  ``.pth``, the same top-k entries wherever the logits around them are
  further apart than the two packages' float32 difference;
- ``compute_fid`` with both extractors replaced by one numpy stand-in: the
  same images in the same batches as uint8, the same class dropped, FID
  within 1e-6 relative; then once through the port's InceptionV3;
- the three CLIs default to CUDA and raise without it."""
import csv
import importlib.util
import os
import sys

import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from tests.test_torch_sd_interop import TEXT, UNET, VAE, tiny_cli  # noqa: E402,F401
from tests.test_torch_sd_unet import jax_unet_params  # noqa: E402
from uurg_torch.cli import compute_fid as TFID  # noqa: E402
from uurg_torch.cli import generate_images as TGEN  # noqa: E402
from uurg_torch.cli import imageclassify as TCLS  # noqa: E402
from uurg_torch.io.jax_interop import (jax_clip_text_params_to_torch,  # noqa: E402
                                       jax_resnet_variables_to_torch)
from uurg_torch.models import clip_text as TC  # noqa: E402
from uurg_torch.models.autoencoder_kl import VAEConfig as TVAEConfig  # noqa: E402
from uurg_torch.models.autoencoder_kl import init_vae  # noqa: E402
from uurg_torch.workloads import sd as TW  # noqa: E402
from uurg_tpu.io import sd_interop as JSI  # noqa: E402
from uurg_tpu.io.vae_clip_interop import compvis_vae_to_flax  # noqa: E402
from uurg_tpu.models import autoencoder_kl as JV  # noqa: E402
from uurg_tpu.models import clip_text as JC  # noqa: E402
from uurg_tpu.models import sd_unet as JU  # noqa: E402
from uurg_tpu.workloads import sd as JW  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT_CFG = dict(TEXT, vocab_size=49408)
# PNG pixels: float32 samples on both sides, truncated to uint8
PNG_LEVELS = 1
# float32 ResNet18 logits, port against JAX (tests/test_torch_eval.py holds
# them at 1e-4 relative L2); entries closer than this share of the largest
# logit may swap places
LOGIT_GAP = 1e-3
FID_REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
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


def _write(path, text: str) -> str:
    with open(path, "w", newline="") as f:
        f.write(text)
    return str(path)


# -- the prompt CSV ---------------------------------------------------------

def _pandas_rows(path: str, from_case: int):
    """What the JAX CLI's loop reads (cli/generate_images.py:73-77)."""
    out = []
    for _, row in pd.read_csv(path).iterrows():
        case = int(row.case_number)
        if case < from_case:
            continue
        out.append((case, str(row.prompt),
                    int(row.get("evaluation_seed", 42))))
    return out


@pytest.mark.parametrize("text,from_case", [
    ("case_number,prompt,evaluation_seed\n0,a church,5\n1,a dog,7\n", 0),
    ("case_number,prompt,evaluation_seed\n0,a church,5\n1,a dog,7\n"
     "2,a cat,9\n", 1),
    ("case_number,prompt\n3,a church\n4,a dog\n", 0),          # no seed
    ('case_number,prompt,evaluation_seed\n0,"a photo, of a church",5\n'
     '1,"a ""quoted"" dog, two",3\n', 0),
    ("case_number,prompt,evaluation_seed,evaluation_guidance\n"
     "10,x,11,7.5\n12,y,13,7.5\n", 11),
    ("case_number,prompt,evaluation_seed\n0,,5\n1,NA,6\n2,None,7.0\n", 0),
])
def test_prompt_csv_reads_as_pandas(tmp_path, text, from_case):
    path = _write(tmp_path / "p.csv", text)
    assert TGEN.read_prompts(path, from_case) == _pandas_rows(path, from_case)


@pytest.mark.parametrize("name", ["nsfw.csv", "not-nsfw.csv",
                                  "unsafe-prompts4703.csv"])
def test_reference_prompt_csvs_read_as_pandas(name):
    """The reference's prompt files in ``prompts/``: a byte-order mark and a
    trailing empty column (nsfw.csv), an unnamed index column, prompts
    with commas, quotes and line breaks, seeds above 2**31 and an empty
    prompt, which pandas reads as NaN and the JAX CLI samples as "nan"
    (I2P, 4,703 rows)."""
    path = os.path.join(ROOT, "prompts", name)
    assert TGEN.read_prompts(path) == _pandas_rows(path, 0)


@pytest.mark.parametrize("text", [
    "case_number,prompt,evaluation_seed\n0,a church,5\n1,a dog,\n",
    "case_number,prompt,evaluation_seed\n0,a church,5\n,a dog,3\n",
])
def test_prompt_csv_empty_cell_raises_as_pandas(tmp_path, text):
    path = _write(tmp_path / "p.csv", text)
    with pytest.raises(ValueError):
        _pandas_rows(path, 0)
    with pytest.raises(ValueError):
        TGEN.read_prompts(path, 0)


# -- generate_images --------------------------------------------------------

PROMPTS = ('case_number,prompt,evaluation_seed\n0,"a church, at night",5\n'
           "1,a dog,7\n2,a dog,7\n")


@pytest.fixture(scope="module")
def sd_weights(tmp_path_factory):
    """(JAX workload with a jitted UNet apply, JAX UNet params, the port's
    CompVis UNet file, JAX text params). The VAE is the port's seeded one
    carried into flax; the text encoder the JAX seed-2 init carried into
    the port."""
    jwl = JW.SDWorkload.build(
        JU.SDUNetConfig(**UNET, dtype=jnp.float32, remat=False),
        JV.VAEConfig(**VAE), JC.CLIPTextConfig(**TEXT_CFG))
    params = jax_unet_params(UNET, perturb_seed=1)
    _, jwl.text_params = JC.init_clip_text(jax.random.key(2), jwl.text.cfg)
    vae = init_vae(1, TVAEConfig(**VAE))
    jwl.vae_params = compvis_vae_to_flax(
        {f"first_stage_model.{k}": v for k, v in vae.state_dict().items()},
        jwl.vae.cfg)
    jwl.apply_model = jax.jit(
        lambda p, z, t, c: jwl.unet.apply({"params": p}, z, t, c))
    ckpt = str(tmp_path_factory.mktemp("sd") / "unet.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in
                               JSI.flax_unet_to_compvis(
                                   params, jwl.unet.cfg).items()}}, ckpt)
    return jwl, params, ckpt, jwl.text_params


def _eager(monkeypatch, *files):
    """``jax.jit`` of functions defined in ``files`` lifted: the sampler
    runs op by op around the jitted UNet apply, compiled once for the
    module (a jitted sampler compiles the UNet again for every run)."""
    real = jax.jit

    def jit(f=None, **kw):
        if f is None:
            return lambda g: jit(g, **kw)
        code = getattr(f, "__code__", None)
        return f if code and code.co_filename in files else real(f, **kw)

    monkeypatch.setattr(jax, "jit", jit)


def _pngs(folder):
    return {f: np.asarray(Image.open(os.path.join(folder, f)))
            for f in sorted(os.listdir(folder))}


@pytest.mark.parametrize("sampler", ["lms", "ddim"])
def test_generate_images_matches_jax_cli(tmp_path, monkeypatch, tiny_cli,  # noqa: F811
                                         sd_weights, sampler):
    jwl, params, ckpt, text_params = sd_weights
    monkeypatch.setattr(JC, "_resolve_tokenizer",
                        lambda: ("crc32-fallback", JC.hash_tokenize))
    # the port's text encoder from the JAX init's weights
    monkeypatch.setattr(TC, "init_clip_text", lambda seed, cfg, device: (
        _text(cfg, device, text_params)))
    n, size = 2, 64
    seen = []

    make_sampler = TW.SDWorkload.make_sampler

    def jax_draw(self, **kw):
        """The sampler with x_T drawn as the JAX CLI draws it from the
        seed of the generator the port's CLI passes."""
        sample = make_sampler(self, **kw)

        def drawn(model, ctx, generator):
            seed = generator.initial_seed()
            seen.append(seed)
            key = jax.random.split(jax.random.key(seed))[0]
            shape = (ctx.shape[0], kw["latent_size"], kw["latent_size"],
                     self.unet_cfg.in_channels)
            x_T = torch.from_numpy(np.array(
                jax.random.normal(key, shape, jnp.float32)))
            return sample(model, ctx, x_T=x_T.to(ctx.device))

        return drawn

    monkeypatch.setattr(TW.SDWorkload, "make_sampler", jax_draw)
    prompts = _write(tmp_path / "prompts.csv", PROMPTS)
    flags = ["--prompts_path", prompts, "--sampler", sampler,
             "--num_samples", str(n), "--ddim_steps", "2", "--image_size",
             str(size), "--from_case", "1"]
    TGEN.main([*flags, "--save_path", str(tmp_path / "port"),
               "--ckpt_path", ckpt, "--device", "cpu"])
    assert seen == [7, 7]

    jax_cli = _jax_cli("generate_images")
    monkeypatch.setattr(jax_cli, "setup_workload",
                        lambda args: (jwl, params))
    _eager(monkeypatch, JW.__file__, jax_cli.__file__)
    monkeypatch.setattr(sys, "argv", ["generate_images.py", *flags,
                                      "--save_path", str(tmp_path / "jax")])
    jax_cli.main()

    got, want = _pngs(tmp_path / "port"), _pngs(tmp_path / "jax")
    assert list(got) == ["1_0.png", "1_1.png", "2_0.png", "2_1.png"]
    assert list(want) == list(got)
    for name in got:
        # the tiny VAE halves once: latents of size // 8, images of size // 4
        assert got[name].shape == (size // 4, size // 4, 3)
        assert got[name].dtype == np.uint8 and got[name].std() > 0
        diff = np.abs(got[name].astype(int) - want[name].astype(int))
        assert diff.max() <= PNG_LEVELS, (name, diff.max())
    # cases 1 and 2 share prompt and seed; a case's two samples differ
    assert np.array_equal(got["1_0.png"], got["2_0.png"])
    assert not np.array_equal(got["1_0.png"], got["1_1.png"])


def _text(cfg, device, text_params):
    model = TC.CLIPTextEncoder(cfg)
    model.load_state_dict(jax_clip_text_params_to_torch(text_params),
                          strict=True)
    return model.to(device).eval().requires_grad_(False)


def test_generate_images_writes_truncated_pixels_of_the_sampler(
        tmp_path, monkeypatch, tiny_cli):  # noqa: F811
    """One case's PNGs are ``make_sampler`` + ``decode`` from the case's
    seed, truncated to uint8, bit for bit; the seed defaults to 42."""
    from uurg_torch.cli.sd_common import setup_workload

    prompts = _write(tmp_path / "p.csv", 'case_number,prompt\n4,"a, b"\n')
    TGEN.main(["--prompts_path", prompts, "--save_path", str(tmp_path / "o"),
               "--num_samples", "2", "--ddim_steps", "4", "--image_size",
               "64", "--device", "cpu"])

    class Args:
        ckpt_path = ""

    wl, unet = setup_workload(Args, "cpu")
    ctx = wl.get_learned_conditioning(["a, b"]).repeat(2, 1, 1)
    g = torch.Generator().manual_seed(42)
    z = wl.make_sampler(num_steps=4, latent_size=8)(unet, ctx, generator=g)
    with torch.inference_mode():
        want = TGEN.to_uint8(wl.vae.decode(z).numpy())
    for i in range(2):
        got = np.asarray(Image.open(tmp_path / "o" / f"4_{i}.png"))
        np.testing.assert_array_equal(got, want[i])


# -- imageclassify ----------------------------------------------------------

def _png_dir(folder, sizes, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
            os.path.join(folder, f"{i}.png"))
    return str(folder)


def test_imageclassify_matches_jax_cli(tmp_path, monkeypatch):
    from uurg_torch import models as TM
    from uurg_tpu.models import create_model as j_create_model
    from uurg_tpu.models import resnet as JR

    folder = _png_dir(tmp_path / "imgs", [(24, 24)] * 2, 4)
    # the JAX CLI's seed-0 init, drawn once here (jitted: the same bits in
    # half the time of the eager init)
    model = j_create_model("ResNet18", 10)
    params, stats = jax.jit(lambda k: JR.init_classifier(k, model))(
        jax.random.key(0))
    pth = str(tmp_path / "resnet18.pth")
    torch.save(jax_resnet_variables_to_torch(params, stats), pth)
    flags = ["--folder_path", folder, "--model", "ResNet18", "--topk", "4",
             "--batch_size", "1"]
    # the logits that decide the port's order, kept as the CLI runs
    logits, create = [], TM.create_model

    def kept(*a, **kw):
        model = create(*a, **kw)
        model.register_forward_hook(
            lambda mod, args, out: logits.append(out.numpy().copy()))
        return model

    monkeypatch.setattr(TM, "create_model", kept)
    TCLS.main([*flags, "--save_path", str(tmp_path / "t.csv"),
               "--classifier_ckpt", pth, "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["imageclassify.py", *flags,
                                      "--save_path", str(tmp_path / "j.csv")])

    def jax_init(key, model):
        assert np.array_equal(jax.random.key_data(key),
                              jax.random.key_data(jax.random.key(0)))
        return params, stats

    monkeypatch.setattr(JR, "init_classifier", jax_init)
    _jax_cli("imageclassify").main()

    def rows(path):
        with open(path, newline="") as f:
            return list(csv.reader(f))

    got, want = rows(tmp_path / "t.csv"), rows(tmp_path / "j.csv")
    assert got[0] == want[0] == ["image", "top1", "top2", "top3", "top4"]
    assert [r[0] for r in got[1:]] == [r[0] for r in want[1:]] == [
        "0.png", "1.png"]
    z = np.concatenate(logits)
    tol = LOGIT_GAP * np.abs(z).max()
    compared = 0
    for zi, g, w in zip(z, got[1:], want[1:]):
        assert [int(c) for c in g[1:]] == list(np.argsort(-zi)[:4])
        s = np.sort(zi)[::-1]
        for r in range(4):
            if (r == 0 or s[r - 1] - s[r] > tol) and s[r] - s[r + 1] > tol:
                assert g[1 + r] == w[1 + r]
                compared += 1
    assert compared >= 6


def test_imageclassify_refuses_torchvision_resnet50(tmp_path):
    """The default model has the CIFAR stem, as the JAX CLI's: torchvision's
    ImageNet ResNet-50 layout (7x7 stem, 1,000 classes), which the
    reference's script runs, does not load."""
    from uurg_torch.models import create_model

    pth = str(tmp_path / "resnet50_imagenet.pth")
    torch.save(create_model("ResNet50", 1000, imagenet_stem=True)
               .state_dict(), pth)
    folder = _png_dir(tmp_path / "imgs", [(24, 24)], 5)
    with pytest.raises(RuntimeError, match="size mismatch"):
        TCLS.main(["--folder_path", folder, "--save_path",
                   str(tmp_path / "t.csv"), "--classifier_ckpt", pth,
                   "--num_classes", "1000", "--device", "cpu"])


# -- compute_fid ------------------------------------------------------------

def _stand_in(log):
    """An extractor factory whose features are numpy statistics of the
    uint8 batches it is handed, which it records."""

    def make_extractor(*_):
        def extract(images_uint8):
            assert images_uint8.dtype == np.uint8
            log.append(images_uint8.copy())
            x = images_uint8.astype(np.float64) / 255.0
            feats = np.stack([x.mean((1, 2, 3)), x.std((1, 2, 3)),
                              x[..., 0].mean((1, 2)) - x[..., 2].mean((1, 2)),
                              (x > 0.5).mean((1, 2, 3))], 1)
            return feats, None, None
        return extract

    return make_extractor


def _fid_folders(tmp_path):
    real = tmp_path / "real"
    for c, (n, seed) in enumerate([(4, 1), (3, 2), (4, 3)]):
        _png_dir(real / f"class{c}", [(40 + 2 * i, 36 + 4 * i)
                                       for i in range(n)], seed)
    fake = _png_dir(tmp_path / "fake", [(40, 40)] * 6, 9)
    (tmp_path / "fake" / "notes.txt").write_text("not an image")
    return str(real), fake


def test_compute_fid_matches_jax_cli(tmp_path, monkeypatch, capsys):
    from uurg_torch.eval import inception as TI
    from uurg_tpu.eval import inception as JI

    real, fake = _fid_folders(tmp_path)
    flags = ["--folder_path", fake, "--real_path", real, "--class_to_forget",
             "1", "--image_size", "32", "--batch_size", "3"]
    got_log, want_log = [], []
    monkeypatch.setattr(TI, "make_extractor", _stand_in(got_log))
    monkeypatch.setattr(TI, "init_inception", lambda seed: torch.nn.Identity())
    TFID.main([*flags, "--device", "cpu"])
    got = capsys.readouterr().out
    monkeypatch.setattr(JI, "make_extractor", _stand_in(want_log))
    monkeypatch.setattr(JI, "init_inception", lambda key: (None, None))
    monkeypatch.setattr(sys, "argv", ["compute_fid.py", *flags])
    _jax_cli("compute_fid").main()
    want = capsys.readouterr().out

    # real: classes 0 and 2 (8 images) in batches 3, 3, 2; fake: 6 in 3, 3
    assert [len(b) for b in got_log] == [3, 3, 2, 3, 3]
    assert len(want_log) == len(got_log)
    for g, w in zip(got_log, want_log):
        np.testing.assert_array_equal(g, w)
    fid = {s: float(out.split("FID:")[1]) for s, out in
           (("port", got), ("jax", want))}
    assert np.isfinite(fid["port"]) and fid["port"] >= 0
    np.testing.assert_allclose(fid["port"], fid["jax"], rtol=FID_REL)


def test_compute_fid_through_inception(tmp_path, monkeypatch, capsys):
    """The port's seeded InceptionV3: the printed FID is ``compute_fid`` of
    the pool features the extractor gives the same batches."""
    from uurg_torch.eval import generative as TG
    from uurg_torch.eval.inception import init_inception, make_extractor

    real = tmp_path / "real"
    _png_dir(real / "a", [(40, 40)] * 2, 1)
    _png_dir(real / "b", [(40, 40)] * 2, 2)
    fake = _png_dir(tmp_path / "fake", [(40, 40)] * 2, 3)
    seen = {}
    fid_fn = TG.compute_fid

    def kept(a, b):
        seen["feats"] = (a, b)
        return fid_fn(a, b)

    monkeypatch.setattr(TG, "compute_fid", kept)
    TFID.main(["--folder_path", fake, "--real_path", str(real),
               "--class_to_forget", "0", "--image_size", "32",
               "--device", "cpu"])
    fid = float(capsys.readouterr().out.split("FID:")[1])
    real_f, fake_f = seen["feats"]
    assert real_f.shape == fake_f.shape == (2, 2048)
    assert np.isfinite(fid) and fid >= 0
    from uurg_torch.data.lazy import LazyImageFolder

    paths = np.asarray(sorted(os.path.join(fake, f) for f in os.listdir(fake)))
    x, _ = LazyImageFolder("", 32, paths=paths,
                           labels=np.zeros(2, np.int64)).get_batch(
        np.arange(2))
    want = make_extractor(init_inception(0))((x * 255).astype(np.uint8))[0]
    np.testing.assert_array_equal(fake_f, want)


# -- the default device -----------------------------------------------------

@pytest.mark.parametrize("cli,argv", [
    (TGEN, ["--prompts_path", "p.csv", "--save_path", "out"]),
    (TCLS, ["--folder_path", ".", "--save_path", "out.csv"]),
    (TFID, ["--folder_path", ".", "--real_path", "."]),
])
def test_clis_default_to_cuda(cli, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)
