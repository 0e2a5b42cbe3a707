"""The port's evaluation slice vs the JAX package (CPU, fp32): InceptionV3
and its weight loaders, the bilinear resize, the ResNet probe and its
checkpoint loaders, the FID/IS/P-R functions, the classifier probe, and
the two evaluation CLIs end to end."""
import csv
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from uurg_torch.cli import classifier_evaluation as TCE  # noqa: E402
from uurg_torch.cli import evaluator as TEV  # noqa: E402
from uurg_torch.eval import classifier_eval as TC  # noqa: E402
from uurg_torch.eval import generative as TG  # noqa: E402
from uurg_torch.eval import inception as TI  # noqa: E402
from uurg_torch.io.inception_interop import flax_inception_to_torch  # noqa: E402
from uurg_torch.io.jax_interop import jax_resnet_variables_to_torch  # noqa: E402
from uurg_torch.io.tv_resnet_interop import load_torch_resnet_checkpoint  # noqa: E402
from uurg_torch.models import resnet as TR  # noqa: E402
from uurg_torch.utils.images import resize_bilinear  # noqa: E402
from uurg_tpu.eval import classifier_eval as JC  # noqa: E402
from uurg_tpu.eval import generative as JG  # noqa: E402
from uurg_tpu.eval import inception as JI  # noqa: E402
from uurg_tpu.io import inception_interop as JII  # noqa: E402
from uurg_tpu.io import tv_resnet_interop as JTV  # noqa: E402
from uurg_tpu.models import resnet as JR  # noqa: E402

# features and logits: relative error against the max magnitude, the JAX
# package's own bound for its InceptionV3 against a torch replica
# (tests/test_inception_parity.py)
FEAT_REL = 2e-3
# the resize on the [0, 255] scale: two float32 ulps at 255. The port's
# weights are XLA's bit for bit and one axis resizes bit-equal (tested);
# across both axes XLA's fused products round differently in the last bit
RESIZE_ATOL = 2 * 2.0 ** -16
RESNET_REL_L2 = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs (as tests/
    test_torch_fisher.py): the suite's workers share one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _perturb(flat, seed):
    """BatchNorm statistics and scales away from identity, so a swapped
    mean/var or scale/bias shows."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[-1]
        if leaf == "mean":
            v = rng.normal(0.0, 0.05, v.shape)
        elif leaf == "var":
            v = rng.uniform(0.7, 1.3, v.shape)
        elif leaf == "scale":
            v = rng.uniform(0.8, 1.2, v.shape)
        elif leaf == "bias" and "/bn" in k:
            v = rng.normal(0.0, 0.05, v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def _images(n, size=32, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3)).astype(np.uint8)


def _close(got, want, name, rel=FEAT_REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err < rel, f"{name}: rel err {err}"


@pytest.fixture(scope="module")
def inception():
    """(flat perturbed flax variables, JAX variables, port model)."""
    _, variables = JI.init_inception(jax.random.key(0))
    flat = _perturb(_flatten(jax.device_get(variables)), seed=1)
    model = TI.InceptionV3()
    model.load_state_dict(flax_inception_to_torch(flat), strict=True)
    return flat, JII.unflatten_variables(flat), model.eval()


# -- InceptionV3 ---------------------------------------------------------

def test_inception_matches_jax(inception):
    flat, variables, model = inception
    x = _images(2)
    want = JI.make_extractor(variables)(x)
    got = TI.make_extractor(model)(x)
    for name, g, w in zip(("pool", "spatial", "logits"), got, want):
        # spatial element by element: a flattening in another order than
        # the JAX package's (H, W, 7) would leave FID blind to it
        _close(g, w, name)


def test_inception_loaders(inception, tmp_path):
    flat, variables, model = inception
    x = _images(1, seed=3)
    ref = TI.make_extractor(model)(x)
    jref = JI.make_extractor(variables)(x)
    # pt_inception layout: the port's names plus what the file also holds
    sd = dict(model.state_dict())
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    sd["AuxLogits.conv0.bn.num_batches_tracked"] = torch.tensor(0)
    torch.save(sd, tmp_path / "pt_inception.pth")
    via_pth = TI.make_extractor(TI.load_inception_pth(
        str(tmp_path / "pt_inception.pth")))(x)
    jax_pth = JI.make_extractor(JII.unflatten_variables(
        JII.convert_inception_state_dict(sd)))(x)
    np.savez(tmp_path / "w.npz", **flat)
    via_npz = TI.make_extractor(TI.load_inception_npz(
        str(tmp_path / "w.npz")))(x)
    jax_npz = JI.make_extractor(JI.load_inception_npz(
        str(tmp_path / "w.npz")))(x)
    for a, b, c, d, e, f in zip(ref, via_pth, via_npz, jref, jax_pth,
                                jax_npz):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c, a)
        np.testing.assert_array_equal(e, d)
        np.testing.assert_array_equal(f, d)
    sd["Mixed_5b.branch_extra.conv.weight"] = torch.zeros(1)
    torch.save(sd, tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        TI.load_inception_pth(str(tmp_path / "bad.pth"))
    with pytest.raises(KeyError):
        flax_inception_to_torch({"params/Mixed_5b/b9/conv/kernel":
                                 np.zeros((1, 1, 1, 1))})


# -- resize --------------------------------------------------------------

@pytest.mark.parametrize("src,size", [(32, 299), (32, 224), (64, 48)])
def test_resize_matches_jax(src, size):
    x = _images(2, src, seed=src + size)
    if size == 299:
        got = TI.preprocess(torch.from_numpy(x), size)
        want = JI.preprocess(jnp.asarray(x), size)
        scale = 127.5                      # back to the [0, 255] scale
    else:
        got = TC.resize_batch(x, size, device="cpu")
        want = JC.resize_batch(x, size)
        scale = 255.0
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, size, size, 3)
    assert np.abs(got - np.asarray(want)).max() * scale <= RESIZE_ATOL


@pytest.mark.parametrize("src,size", [(32, 299), (64, 48)])
def test_resize_one_axis_bit_equal(src, size):
    # images already ``size`` wide: the JAX package resizes the height
    # alone, the port multiplies the width by an identity
    x = np.random.default_rng(0).uniform(0, 255, (2, src, size, 3)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, size, size, 3), "bilinear")
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), size)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


# -- ResNet probe --------------------------------------------------------

def _jax_resnet(model, resolution, seed):
    params, stats = JR.init_classifier(jax.random.key(seed), model,
                                       resolution=resolution)
    flat = _perturb(_flatten({"params": jax.device_get(params),
                              "batch_stats": jax.device_get(stats)}), seed)
    nested = JII.unflatten_variables(flat)
    return nested["params"], nested["batch_stats"]


@pytest.fixture(scope="module")
def resnets():
    """{name: (JAX model, params, batch_stats, port model, resolution)}."""
    out = {}
    for name, jm, tm, res in (
            ("imagenet34", JR.ResNet34(10, imagenet_stem=True),
             TR.ResNet34(10, imagenet_stem=True), 64),
            ("cifar18", JR.ResNet18(10), TR.ResNet18(10), 32),
            # a narrow Bottleneck network (the ResNet-50/101/152 block)
            ("bottleneck", JR.ResNet([1, 2], JR.Bottleneck, 10, width=8),
             TR.ResNet([1, 2], TR.Bottleneck, 10, width=8), 32)):
        p, s = _jax_resnet(jm, res, seed=len(out) + 2)
        tm.load_state_dict(jax_resnet_variables_to_torch(p, s), strict=True)
        out[name] = (jm, p, s, tm.eval(), res)
    return out


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("name", ["imagenet34", "cifar18", "bottleneck"])
def test_resnet_matches_jax(resnets, name):
    jm, p, s, tm, res = resnets[name]
    x = np.random.default_rng(5).uniform(0, 1, (3, res, res, 3)).astype(
        np.float32)
    want = jm.apply({"params": p, "batch_stats": s}, jnp.asarray(x),
                    train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert _rel_l2(got.numpy(), want) <= RESNET_REL_L2


def test_resnet_checkpoint_layouts(resnets, tmp_path):
    x = np.random.default_rng(6).uniform(0, 1, (2, 32, 32, 3)).astype(
        np.float32)
    for name, layout in (("imagenet34", "torchvision"),
                         ("cifar18", "cifar")):
        jm, _, _, tm, _ = resnets[name]
        sd = tm.state_dict()
        if layout == "cifar":
            # the reference CIFAR names, DataParallel prefix, wrapped
            obj = {"state_dict": {
                "module." + k.replace("downsample", "shortcut")
                .replace("fc.", "linear."): v for k, v in sd.items()}}
        else:
            obj = sd
        path = str(tmp_path / f"{name}.pth")
        torch.save(obj, path)
        loaded = load_torch_resnet_checkpoint(path)
        assert set(loaded) == set(sd)
        for k, v in sd.items():
            torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)
        fresh = (TR.ResNet34(10, imagenet_stem=True) if name == "imagenet34"
                 else TR.ResNet18(10))
        fresh.load_state_dict(loaded, strict=True)
        jp, js = JTV.load_torch_resnet_checkpoint(path)
        want = jm.apply({"params": jp, "batch_stats": js}, jnp.asarray(x),
                        train=False)
        with torch.no_grad():
            got = fresh.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert _rel_l2(got.numpy(), want) <= RESNET_REL_L2
    torch.save({"conv1.weight": torch.zeros(1), "head.weight": torch.zeros(1)},
               tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="unrecognized"):
        load_torch_resnet_checkpoint(str(tmp_path / "bad.pth"))


# -- metric functions ----------------------------------------------------

def _feats(n, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (n, d)) @ rng.normal(0, 1, (d, d))


def test_metric_functions_match_jax():
    a, b = _feats(40, seed=1), _feats(33, seed=2) + 0.3
    assert abs(TG.compute_fid(a, b) - JG.compute_fid(a, b)) <= 1e-10
    logits = _feats(37, d=10, seed=3)
    assert abs(TG.inception_score(logits, split_size=16)
               - JG.inception_score(logits, split_size=16)) <= 1e-10
    for blocks in ((4096, 4096), (7, 5)):
        np.testing.assert_array_equal(TG.knn_radii(a, 3, *blocks),
                                      JG.knn_radii(a, 3, *blocks))
        assert (TG.precision_recall(a, b, 3, *blocks)
                == JG.precision_recall(a, b, 3, *blocks))


def _stub_extractor(as_tensor):
    def extract(images):
        x = images.reshape(len(images), -1).astype(np.float64) / 255.0
        out = (x[:, :16] + x[:, 16:32] ** 2, x[:, 32:48] - x[:, :16],
               3 * x[:, 48:58])
        return tuple(torch.from_numpy(o) for o in out) if as_tensor else out
    return extract


@pytest.mark.parametrize("as_tensor", [False, True])
def test_featurize_and_evaluate_all_match_jax(as_tensor):
    ref, sam = _images(23, 8, seed=7), _images(19, 8, seed=8)
    stub = _stub_extractor(as_tensor)
    got = TG.featurize(stub, ref, batch_size=5, columns=(0, 1))
    want = JG.featurize(_stub_extractor(False), ref, batch_size=5,
                        columns=(0, 1))
    assert got[2] is None and want[2] is None
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == (23, 16)
        np.testing.assert_array_equal(g, w)
    got = TG.evaluate_all(stub, ref, sam, batch_size=6)
    want = JG.evaluate_all(_stub_extractor(False), ref, sam, batch_size=6)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-10, k


# -- classifier probe ----------------------------------------------------

@pytest.mark.parametrize("name,resize", [("imagenet34", 224),
                                         ("cifar18", None)])
def test_classifier_probe_matches_jax(resnets, name, resize):
    jm, p, s, tm, _ = resnets[name]
    imgs = _images(5, seed=9)
    got = TC.classifier_probe(tm, imgs, 3, batch_size=3, resize_to=resize,
                              device="cpu")
    want = JC.classifier_probe(
        lambda x: jm.apply({"params": p, "batch_stats": s}, x, train=False),
        imgs, 3, batch_size=3, resize_to=resize)
    assert got["n"] == want["n"] == 5
    assert got["forget_accuracy"] == want["forget_accuracy"]
    for k in ("avg_entropy", "avg_prob_forgotten"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    top = TC.topk_classification(tm, imgs, k=3, batch_size=3,
                                 resize_to=resize, device="cpu")
    assert top.shape == (5, 3)


# -- the two CLIs --------------------------------------------------------

# FID and sFID from 12 references and 10 samples: with fewer samples than
# feature dimensions (2048, 2023) both covariances are singular and sqrtm's
# result amplifies the features' fp32 differences; IS and P/R read
# softmaxes and distances of the same features
CLI_FID_REL = 1e-2
CLI_IS_REL = 1e-4


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_evaluator_cli_matches_jax(inception, tmp_path, capsys):
    flat, variables, _ = inception
    ref, sam = _images(12, seed=10), _images(10, seed=11)
    np.savez(tmp_path / "ref.npz", arr_0=ref)
    np.savez(tmp_path / "sam.npz", arr_0=sam)
    np.savez(tmp_path / "inception.npz", **flat)
    out_csv = str(tmp_path / "res" / "result.csv")
    argv = [str(tmp_path / "ref.npz"), str(tmp_path / "sam.npz"),
            "--inception_weights", str(tmp_path / "inception.npz"),
            "--batch_size", "8", "--csv", out_csv, "--device", "cpu"]
    TEV.main(argv)
    printed = dict(line.rsplit(": ", 1)
                   for line in capsys.readouterr().out.strip().splitlines())
    want = JG.evaluate_all(JI.make_extractor(variables), ref, sam, 8)
    got = {"inception_score": float(printed["Inception Score"]),
           "fid": float(printed["FID"]), "sfid": float(printed["sFID"]),
           "precision": float(printed["Precision"]),
           "recall": float(printed["Recall"])}
    np.testing.assert_allclose(got["inception_score"],
                               want["inception_score"], rtol=CLI_IS_REL)
    for k in ("fid", "sfid"):
        np.testing.assert_allclose(got[k], want[k], rtol=CLI_FID_REL)
    for k in ("precision", "recall"):
        assert got[k] == want[k], k
    rows = _read_csv(out_csv)
    assert len(rows) == 1 and list(rows[0]) == [
        "ref", "sample", "inception_score", "fid", "sfid", "precision",
        "recall"]
    assert float(rows[0]["fid"]) == got["fid"]


def test_classifier_evaluation_cli_matches_jax(resnets, tmp_path, capsys):
    jm, p, s, tm, _ = resnets["imagenet34"]
    imgs = _images(4, seed=12)
    np.savez(tmp_path / "probe.npz", arr_0=imgs)
    torch.save(tm.state_dict(), tmp_path / "probe.pth")
    out_csv = str(tmp_path / "result.csv")
    TCE.main([str(tmp_path / "probe.npz"), "--classifier_ckpt",
              str(tmp_path / "probe.pth"), "--label_of_forgotten_class",
              "2", "--batch_size", "3", "--csv", out_csv,
              "--device", "cpu"])
    printed = dict(line.rsplit(": ", 1)
                   for line in capsys.readouterr().out.strip().splitlines())
    # the JAX CLI's model: bf16 convolutions, fp32 BatchNorm and fc
    jb = JR.ResNet34(10, dtype=jnp.bfloat16, imagenet_stem=True)
    want = JC.classifier_probe(
        lambda x: jb.apply({"params": p, "batch_stats": s}, x, train=False),
        imgs, 2, batch_size=3, resize_to=224)
    # bf16 activations on both sides, rounded after convolutions summed in
    # another order
    np.testing.assert_allclose(float(printed["Average entropy"]),
                               want["avg_entropy"], rtol=2e-2)
    np.testing.assert_allclose(
        float(printed["Average prob of forgotten class"]),
        want["avg_prob_forgotten"], rtol=5e-2)
    assert float(printed["Forget accuracy (UA)"]) == want["forget_accuracy"]
    rows = _read_csv(out_csv)
    assert list(rows[0]) == ["sample", "avg_entropy", "avg_prob_forgotten",
                             "forget_accuracy", "n"]
    assert rows[0]["n"] == "4"
    os.makedirs(tmp_path / "orbax_ckpt")
    with pytest.raises(ValueError, match="Orbax"):
        TCE.main([str(tmp_path / "probe.npz"), "--classifier_ckpt",
                  str(tmp_path / "orbax_ckpt"), "--device", "cpu"])
