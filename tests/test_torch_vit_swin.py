"""The port's ViT and Swin classifiers against the JAX package's (CPU):
tiny configurations carried across with ``jax_*_params_to_torch``, logits
and parameter gradients in float32 and logits in bfloat16; the window
helpers; the torchvision converters against the JAX converters; the
registry, the initialisation's token count, RandAugment, and a tiny ViT
through the ``main_random`` CLI."""
import csv
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from test_tv_vit_swin_interop import TorchSwin, TorchViT  # noqa: E402
from uurg_torch.data import arrays as TA  # noqa: E402
from uurg_torch.io import tv_vit_swin_interop as TI  # noqa: E402
from uurg_torch.io.jax_interop import (jax_swin_params_to_torch,  # noqa: E402
                                       jax_vit_params_to_torch)
from uurg_torch.models import swin as TS  # noqa: E402
from uurg_torch.models import vit as TV  # noqa: E402
from uurg_tpu.data import arrays as JA  # noqa: E402
from uurg_tpu.io import tv_vit_swin_interop as JI  # noqa: E402
from uurg_tpu.models import swin as JS  # noqa: E402
from uurg_tpu.models import vit as JV  # noqa: E402

# float32 on both sides, sums in another order: relative L2 of the logits
# and of each parameter's gradient
FWD_REL, GRAD_REL = 1e-5, 1e-4
# bf16 activations on both sides, rounded after products summed in another
# order and at other places (XLA rounds every elementwise op)
BF16_REL = 2e-2

VIT = dict(patch_size=4, hidden_size=32, depth=2, num_heads=2,
           num_classes=5)
# tests/test_vit_swin.py's Swin (one block a stage, no shift) and the same
# with two blocks a stage: the second block of the 8x8 stage is shifted
SWINS = {"unshifted": dict(patch_size=2, embed_dim=16, depths=(1, 1),
                           num_heads=(2, 2), window=4, num_classes=5),
         "shifted": dict(patch_size=2, embed_dim=16, depths=(2, 2),
                         num_heads=(2, 4), window=4, num_classes=5)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs (the suite's workers share
    the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _pair(kind, jdtype=jnp.float32, tdtype=torch.float32, **cfg):
    """(jax model, params, torch model) from one seeded init, 16 px."""
    x = np.zeros((1, 16, 16, 3), np.float32)
    if kind == "vit":
        jm = JV.ViT(JV.ViTConfig(image_size=16, dtype=jdtype, **cfg))
        params = jm.init({"params": jax.random.key(0)}, x)["params"]
        tm = TV.ViT(TV.ViTConfig(image_size=16, dtype=tdtype, **cfg))
        sd = jax_vit_params_to_torch(params)
    else:
        jm = JS.Swin(JS.SwinConfig(dtype=jdtype, **cfg))
        params = jm.init({"params": jax.random.key(0)}, x)["params"]
        tm = TS.Swin(TS.SwinConfig(dtype=tdtype, **cfg))
        sd = jax_swin_params_to_torch(params)
    # the class token is zero at init: draw it so it counts in the check
    if kind == "vit":
        params = dict(params)
        params["cls_token"] = jnp.asarray(np.random.default_rng(3).normal(
            0, 0.5, (1, 1, cfg["hidden_size"])).astype(np.float32))
        sd["cls_token"] = torch.tensor(np.asarray(params["cls_token"]))
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm


def _images(n=2, seed=1):
    return np.random.default_rng(seed).random((n, 16, 16, 3),
                                              dtype=np.float32)


def _check_f32(kind, cfg):
    jm, params, tm = _pair(kind, **cfg)
    x = _images()
    w = np.random.default_rng(2).standard_normal((2, 5)).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * w)

    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    jgrads_tree = jax.grad(loss)(params)
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    assert _rel(got.detach().numpy(), want) <= FWD_REL
    (got * torch.from_numpy(w)).sum().backward()
    # the JAX gradients under the port's names, by the weight converter
    conv = jax_vit_params_to_torch if kind == "vit" else \
        jax_swin_params_to_torch
    tgrads = conv(jax.tree_util.tree_map(np.asarray, jgrads_tree))
    named = dict(tm.named_parameters())
    assert set(tgrads) == set(named)
    for name, g in tgrads.items():
        assert _rel(named[name].grad.numpy(), g.numpy()) <= GRAD_REL, name


def test_vit_matches_jax_f32():
    _check_f32("vit", VIT)


@pytest.mark.parametrize("name", list(SWINS))
def test_swin_matches_jax_f32(name):
    _check_f32("swin", SWINS[name])


@pytest.mark.parametrize("kind,cfg", [("vit", VIT),
                                      ("swin", SWINS["shifted"])])
def test_bf16_matches_jax(kind, cfg):
    jm, params, tm = _pair(kind, jnp.bfloat16, torch.bfloat16, **cfg)
    x = _images(seed=4)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)),
                      np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32        # the head is float32
    assert _rel(got.numpy(), want) <= BF16_REL


@pytest.mark.parametrize("H,w,shift", [(8, 4, 2), (14, 7, 3), (12, 4, 2)])
def test_window_helpers_equal_jax(H, w, shift):
    np.testing.assert_array_equal(TS.shift_attn_mask(H, H, w, shift),
                                  JS.shift_attn_mask(H, H, w, shift))
    np.testing.assert_array_equal(TS.relative_position_index(w),
                                  JS.relative_position_index(w))
    x = np.random.default_rng(H).standard_normal((2, H, H, 3)).astype(
        np.float32)
    got = TS.window_partition(torch.from_numpy(x), w)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JS.window_partition(jnp.asarray(x), w)))
    np.testing.assert_array_equal(
        TS.window_unpartition(got, w, H, H).numpy(), x)


def _converted_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in got:
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_vit_converter_matches_jax_converter():
    torch.manual_seed(0)
    tm = TorchViT(image_size=16, patch=4, dim=32, depth=2, heads=4,
                  mlp_dim=128, ncls=5).eval()
    with torch.no_grad():
        tm.class_token.normal_(0, 0.5)
    sd = dict(tm.state_dict())
    sd["head.weight"], sd["head.bias"] = torch.zeros(3, 32), torch.zeros(3)
    got, dropped = TI.torch_vit_to_port(sd)
    params, jdropped = JI.torch_vit_to_flax(sd)
    assert sorted(dropped) == sorted(jdropped) == ["head.bias", "head.weight"]
    _converted_equal(got, jax_vit_params_to_torch(params))
    port = TV.ViT(TV.ViTConfig(image_size=16, patch_size=4, hidden_size=32,
                               depth=2, num_heads=4, num_classes=5))
    port.load_state_dict(got, strict=True)
    x = torch.from_numpy(_images(seed=5)).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        np.testing.assert_allclose(port(x).numpy(), tm(x).numpy(),
                                   atol=2e-5, rtol=1e-4)


def _swin_port(tm_cfg):
    return TS.Swin(TS.SwinConfig(patch_size=4, embed_dim=16,
                                 num_heads=(2, 4), window=2, num_classes=5,
                                 depths=tm_cfg))


def test_swin_converter_matches_jax_converter():
    torch.manual_seed(0)
    tm = TorchSwin(patch=4, embed=16, depths=(2, 2), heads=(2, 4), window=2,
                   ncls=5).eval()
    got, dropped = TI.torch_swin_to_port(tm.state_dict())
    params, jdropped = JI.torch_swin_to_flax(tm.state_dict())
    assert dropped == jdropped and all("relative_position_index" in k
                                       for k in dropped)
    _converted_equal(got, jax_swin_params_to_torch(params))
    port = _swin_port((2, 2))
    port.load_state_dict(got, strict=True)
    x = torch.from_numpy(_images(seed=6)).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        np.testing.assert_allclose(port(x).numpy(), tm(x).numpy(),
                                   atol=3e-5, rtol=1e-4)


def test_swin_merge_permutation_is_loadbearing():
    """Undoing the merge-axis block permutation must break the forward (the
    [0, 2, 1, 3] map is not an identity in disguise)."""
    torch.manual_seed(3)
    tm = TorchSwin(4, 16, (1, 1), (2, 4), 2, 5).eval()
    got, _ = TI.torch_swin_to_port(tm.state_dict())
    x = torch.from_numpy(_images(1, seed=7)).permute(0, 3, 1, 2).contiguous()
    port = _swin_port((1, 1))
    with torch.no_grad():
        ref = tm(x).numpy()
        port.load_state_dict(got, strict=True)
        np.testing.assert_allclose(port(x).numpy(), ref, atol=3e-5,
                                   rtol=1e-4)
        bad = dict(got)
        w = got["merge0.reduction.weight"]
        bad["merge0.reduction.weight"] = TI._merge_perm(w, 1)
        port.load_state_dict(bad, strict=True)
        assert not np.allclose(port(x).numpy(), ref, atol=1e-3)


def test_vit_and_swin_checkpoints_load_through_torch_classifier(tmp_path):
    from uurg_torch.io.torch_classifier import (load_torch_classifier,
                                                overlay_pretrained)

    torch.manual_seed(1)
    tv = TorchViT(16, 4, 32, 1, 4, 64, ncls=1000)
    torch.save({"model": tv.state_dict()}, tmp_path / "vit.pth")
    loaded = load_torch_classifier(str(tmp_path / "vit.pth"), "ViT_B")
    port = TV.ViT(TV.ViTConfig(image_size=16, patch_size=4, hidden_size=32,
                               depth=1, num_heads=4, num_classes=10))
    overlay_pretrained(port, loaded)
    assert torch.equal(port.block_0.attn.qkv.weight,
                       tv.encoder.layers.encoder_layer_0.self_attention
                       .in_proj_weight)
    assert port.head.weight.shape == (10, 32)       # the 1000-way head kept
    sw = TorchSwin(4, 16, (1, 1), (2, 4), 2, 5)
    torch.save(sw.state_dict(), tmp_path / "swin.pth")
    loaded = load_torch_classifier(str(tmp_path / "swin.pth"), "Swin_T")
    assert "stage1_block0.attn.rel_pos_bias" in loaded


def test_registry_builds_all_four_and_init_sets_tokens():
    from uurg_torch.models import create_model, init_classifier

    sizes = {}
    for name in ("ViT_B", "Swin_T", "Swin_S", "Swin_B"):
        m = create_model(name, 10)
        sizes[name] = sum(p.numel() for p in m.parameters())
    # torchvision's parameter counts less their 1000-way heads plus ours
    assert sizes["ViT_B"] == 86_567_656 - 769_000 + 7_690
    assert sizes["Swin_T"] == 28_288_354 - 769_000 + 7_690
    vit = create_model("ViT_B", 10)
    assert vit.pos_embed.shape == (1, 197, 768)
    gen = torch.Generator().manual_seed(0)
    init_classifier(gen, vit)
    assert vit.pos_embed.shape == (1, 5, 768)          # the JAX default, 32
    assert not vit.cls_token.detach().any()
    assert 0.015 < float(vit.pos_embed.detach().std()) < 0.025
    init_classifier(gen, vit, resolution=224)
    assert vit.pos_embed.shape == (1, 197, 768)
    assert vit.head.bias.abs().sum() == 0
    assert vit.block_0.ln1.weight.eq(1).all()


def test_swin_at_32_px_fails_as_in_jax():
    m = TS.Swin(TS.SwinConfig(depths=(2, 2, 2, 2), embed_dim=8,
                              num_heads=(1, 1, 1, 1)))
    with pytest.raises(RuntimeError):
        m(torch.zeros(1, 3, 32, 32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rand_augment_equal_to_jax(seed):
    x = np.random.default_rng(10 + seed).random((16, 12, 12, 3),
                                                dtype=np.float32)
    got = TA.rand_augment_batch(x, np.random.default_rng(seed))
    want = JA.rand_augment_batch(x, np.random.default_rng(seed))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_tiny_vit_main_random_on_cpu(monkeypatch, tmp_path):
    """main_random with a registered tiny ViT (patch 8 at the stand-in's 32
    px: 17 tokens) runs SFR-on and writes its CSV row."""
    from uurg_torch.cli import main_random
    from uurg_torch.data.datasets import dataset_registry, synthetic_dataset
    from uurg_torch.models import model_registry

    def tiny(num_classes=4, dtype=torch.float32):
        return TV.ViT(TV.ViTConfig(image_size=224, patch_size=8,
                                   hidden_size=16, depth=1, num_heads=2,
                                   num_classes=num_classes, dtype=dtype))

    def data(root, train=True):
        return synthetic_dataset(64 if train else 32, 32, 3, 4,
                                 seed=0 if train else 1, base_seed=0)

    monkeypatch.setitem(model_registry._entries, "TinyViT", tiny)
    monkeypatch.setitem(dataset_registry._entries, "TINY32", data)
    out = str(tmp_path / "out")
    res = main_random.main([
        "--dataset", "TINY32", "--model", "TinyViT", "--num_classes", "4",
        "--batch_size", "32", "--device", "cpu", "--unlearn_method",
        "SFRon", "--save_path", out])
    rows = list(csv.DictReader(open(os.path.join(out, "results.csv"))))
    assert rows[0]["method"] == "SFRon"
    assert all(0.0 <= res[k] <= 100.0
               for k in ("retain_acc", "forget_acc", "test_acc"))
    assert os.path.isfile(os.path.join(out, "SFRon_unlearned"))
