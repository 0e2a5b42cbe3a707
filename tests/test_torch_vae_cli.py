"""The VAE's entry points in the port (CPU): ``LazyImageFolder`` against
the JAX one, ``encode_latents`` against the JAX CLI and the port's own
``encode``, ``forget`` and ``dit_generate_fisher`` on an image folder,
``dit_sample_fid``'s rules against the JAX function (stub samplers and
decoders: the two samplers' random draws cannot be matched, and the sampler
itself is held by ``tests/test_torch_dit_runner.py``), and ``dit_sample``
in both modes. The CLIs run a VAE of the SD / DiT layout narrowed to 8
channels (``TINY8``: four levels, so latents are 1/8 of the image as DiT
needs), read from the port's own VAE file through ``--vae_ckpt``."""
import os
import shutil
import sys

import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from uurg_torch.data import lazy as TL  # noqa: E402
from uurg_torch.data.arrays import infinite_batches  # noqa: E402
from uurg_torch.data.splits import class_forget_split  # noqa: E402
from uurg_torch.io import vae_interop as VI  # noqa: E402
from uurg_torch.models import autoencoder_kl as TV  # noqa: E402
from uurg_torch.workloads import dit_runner as TR  # noqa: E402
from uurg_tpu.data import class_forget_split as j_split  # noqa: E402
from uurg_tpu.data import lazy as JL  # noqa: E402
from uurg_tpu.data.arrays import infinite_batches as j_batches  # noqa: E402
from uurg_tpu.models import autoencoder_kl as JV  # noqa: E402
from uurg_tpu.workloads import dit_runner as JR  # noqa: E402

TINY8 = dict(base_channels=8, channel_mult=(1, 1, 1, 1), num_res_blocks=1)
DIT = ["--model", "DiT-S/8", "--num-classes", "4", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs (several pytest-xdist
    workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _folder(root, classes=("c0", "c1", "c2", "c3"), n=3, ext="png",
            size=(44, 30)):
    """Seeded noise images, ``n`` a class, sizes varying about ``size``
    (landscape and portrait, so the center crop cuts both ways)."""
    rng = np.random.default_rng(0)
    for ci, c in enumerate(classes):
        os.makedirs(os.path.join(root, c), exist_ok=True)
        for i in range(n):
            w, h = (size if i % 2 == 0 else size[::-1])
            arr = rng.integers(0, 256, (h + ci, w + i, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(root, c, f"{i}.{ext}"))
    # not an image: skipped by both readers
    with open(os.path.join(root, classes[0], "notes.txt"), "w") as f:
        f.write("x")
    return str(root)


@pytest.fixture(scope="module")
def vae_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("vae") / "tiny8.pt"
    VI.save_vae(str(path), TV.init_vae(0, TV.VAEConfig(**TINY8)))
    return str(path)


# -- LazyImageFolder ----------------------------------------------------------

@pytest.mark.parametrize("ext,center_crop", [("png", True), ("jpg", True),
                                             ("png", False)])
def test_lazy_image_folder_matches_jax(tmp_path, ext, center_crop):
    root = _folder(tmp_path, ext=ext)
    got = TL.LazyImageFolder(root, 24, center_crop=center_crop)
    want = JL.LazyImageFolder(root, 24, center_crop=center_crop)
    assert len(got) == len(want) == 12
    np.testing.assert_array_equal(got.paths, want.paths)
    np.testing.assert_array_equal(got.labels, want.labels)
    idx = np.asarray([11, 0, 5, 6])
    (gx, gy), (wx, wy) = got.get_batch(idx), want.get_batch(idx)
    assert gx.dtype == np.float32 and gx.shape == (4, 24, 24, 3)
    assert gy.dtype == wy.dtype == np.int32
    np.testing.assert_array_equal(gx, wx)
    np.testing.assert_array_equal(gy, wy)
    sub, jsub = got.subset(idx[1:]), want.subset(idx[1:])
    np.testing.assert_array_equal(sub.get_batch(np.arange(3))[0],
                                  jsub.get_batch(np.arange(3))[0])


def test_lazy_image_folder_restricted_classes_and_empty_folder(tmp_path):
    root = _folder(tmp_path / "img")
    got = TL.LazyImageFolder(root, 16, class_names=["c2", "c0"])
    want = JL.LazyImageFolder(root, 16, class_names=["c2", "c0"])
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.tolist() == [2, 2, 2, 0, 0, 0]  # the global index
    np.testing.assert_array_equal(got.paths, want.paths)
    empty = tmp_path / "empty"
    (empty / "c0").mkdir(parents=True)
    for cls in (TL.LazyImageFolder, JL.LazyImageFolder):
        with pytest.raises(FileNotFoundError, match="no images"):
            cls(str(empty), 16)


def test_lazy_image_folder_feeds_the_split_and_batcher_as_in_jax(tmp_path):
    root = _folder(tmp_path)
    remain, forget = class_forget_split(TL.LazyImageFolder(root, 16), 1)
    jremain, jforget = j_split(JL.LazyImageFolder(root, 16), 1)
    assert len(forget) == 3 and len(remain) == 9
    for ds, jds in ((remain, jremain), (forget, jforget)):
        it, jit = infinite_batches(ds, 4, seed=3), j_batches(jds, 4, seed=3)
        for _ in range(3):
            (x, y), (jx, jy) = next(it), next(jit)
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)


# -- encode_latents -----------------------------------------------------------

def _shards(prefix):
    paths = TL.list_latent_shards(prefix)
    data = [np.load(p) for p in paths]
    return paths, [(d["latents"], d["labels"]) for d in data]


def test_encode_latents_matches_jax_and_the_ports_encode(tmp_path,
                                                         monkeypatch,
                                                         vae_file):
    from cli import encode_latents as JE

    from uurg_torch.cli import encode_latents as TE

    root = _folder(tmp_path / "img")
    flags = ["--image_folder", root, "--image_size", "32", "--batch_size",
             "4", "--shard_size", "5", "--seed", "3", "--classes", "c3",
             "c1", "c2"]
    TE.main([*flags, "--out", str(tmp_path / "port" / "lat"), "--vae_ckpt",
             vae_file, "--device", "cpu"])
    # the JAX CLI with a JAX VAE of the same layout (its own seeded init)
    jcfg = JV.VAEConfig(**TINY8)
    init = JV.init_vae
    monkeypatch.setattr(JV, "init_vae",
                        lambda key, cfg=None, resolution=32:
                        init(key, jcfg, resolution))
    monkeypatch.setattr(sys, "argv", ["encode_latents.py", *flags, "--out",
                                      str(tmp_path / "jax" / "lat")])
    JE.main()
    paths, got = _shards(str(tmp_path / "port" / "lat"))
    jpaths, want = _shards(str(tmp_path / "jax" / "lat"))
    assert [os.path.basename(p) for p in paths] == \
        [os.path.basename(p) for p in jpaths] == \
        ["lat-00000.npz", "lat-00001.npz"]
    for (z, y), (jz, jy) in zip(got, want):
        assert z.shape == jz.shape and z.dtype == jz.dtype == np.float32
        np.testing.assert_array_equal(y, jy)
    labels = np.concatenate([y for _, y in got])
    assert labels.tolist() == [3, 3, 3, 1, 1, 1, 2, 2, 2]
    assert got[0][0].shape == (8, 4, 4, 4)
    # the latents are the port's own encode of the same batches, drawn
    # from one generator seeded with --seed
    vae = VI.load_vae(vae_file)
    ds = TL.LazyImageFolder(root, 32, class_names=["c3", "c1", "c2"])
    gen = torch.Generator().manual_seed(3)
    ref = []
    with torch.inference_mode():
        for i in range(0, 9, 4):
            x, _ = ds.get_batch(np.arange(i, min(i + 4, 9)))
            ref.append(vae.encode(torch.from_numpy(x * 2.0 - 1.0),
                                  generator=gen).numpy())
    np.testing.assert_array_equal(np.concatenate([z for z, _ in got]),
                                  np.concatenate(ref))
    # one npz without --shard_size
    one = str(tmp_path / "one.npz")
    TE.main([a for a in flags if a not in ("--shard_size", "5")]
            + ["--out", one, "--vae_ckpt", vae_file, "--device", "cpu"])
    with np.load(one) as d:
        np.testing.assert_array_equal(d["latents"], np.concatenate(ref))
        np.testing.assert_array_equal(d["labels"], labels)


# -- the DiT CLIs on an image folder ------------------------------------------

def test_forget_and_fisher_take_an_image_folder(tmp_path, vae_file):
    from uurg_torch.cli import dit_generate_fisher, forget
    from uurg_torch.cli.dit_common import forget_remain_iterators

    root = _folder(tmp_path / "img", size=(300, 270))
    masks = str(tmp_path / "masks")
    dit_generate_fisher.main([*DIT, "--data-path", root, "--vae_ckpt",
                              vae_file, "--forget-class", "1", "--n-iters",
                              "1", "--mask-path", masks])
    from uurg_torch.io.checkpoint import restore_checkpoint

    for name in ("forget_fisher", "remain_fisher"):
        f = restore_checkpoint(os.path.join(masks, "1", name))
        assert all(torch.isfinite(v).all() and (v >= 0).all()
                   for v in f.values())
        assert sum(float(v.sum()) for v in f.values()) > 0
    results = str(tmp_path / "res")
    forget.main([*DIT, "--data-path", root, "--vae_ckpt", vae_file,
                 "--n-iters", "1", "--global-batch-size", "2",
                 "--label-to-forget", "1", "--snapshot-every", "5",
                 "--ckpt-every", "5", "--results-dir", results])
    assert os.listdir(os.path.join(results, "forget_1")) == ["final.pt"]
    # the streams: the split's batches (seeded --global-seed and + 1), each
    # mapped to [-1, 1] and encoded by the VAE from a generator of that seed
    args = forget.parse_args([*DIT, "--data-path", root, "--vae_ckpt",
                              vae_file, "--global-batch-size", "2",
                              "--label-to-forget", "1", "--global-seed",
                              "4"])
    f_it, r_it = forget_remain_iterators(args, "cpu")
    vae = VI.load_vae(vae_file)
    remain, fset = class_forget_split(TL.LazyImageFolder(root, 256), 1)
    for it, ds, seed in ((f_it, fset, 4), (r_it, remain, 5)):
        gen = torch.Generator().manual_seed(seed)
        want = infinite_batches(ds, 2, seed=seed)
        for _ in range(2):
            (z, y), (x, wy) = next(it), next(want)
            with torch.inference_mode():
                wz = vae.encode(torch.from_numpy(x * 2.0 - 1.0),
                                generator=gen)
            assert z.shape == (2, 32, 32, 4) and not z.is_inference()
            torch.testing.assert_close(z, wz, rtol=0, atol=0)
            np.testing.assert_array_equal(y, wy)
            assert (y == 1).all() if seed == 4 else (y != 1).all()
    shutil.rmtree(tmp_path)       # checkpoints and Fishers of ~0.4 GB


# -- dit_sample_fid and dit_sample ------------------------------------------

class _StubWorkload:
    """A workload whose sampler returns latents that are exact multiples of
    1/64 in [-1.25, 1.23], a function of each row's label and position, so
    every step of the uint8 conversion is exact on both sides."""

    def __init__(self, torch_side: bool):
        self.torch_side = torch_side
        self.device = torch.device("cpu")
        self.calls = []

    def make_sampler(self, respacing, cond_scale):
        self.calls.append((respacing, cond_scale))
        h = np.arange(4)[:, None, None]
        w = np.arange(4)[None, :, None]
        c = np.arange(4)[None, None, :]
        pattern = (3 * h + w + 5 * c).astype(np.float32)

        def lat(labels):
            v = (labels[:, None, None, None] * 37 + pattern) % 160
            return (v - 80) / 64

        if self.torch_side:
            def sample(model, labels, gen):
                self.calls.append(labels.tolist())
                return lat(labels.float()).float()
        else:
            def sample(params, labels, key):
                return lat(labels.astype(jnp.float32))
        if self.torch_side:
            pattern = torch.from_numpy(pattern)
        else:
            pattern = jnp.asarray(pattern)
        return sample


@pytest.mark.parametrize("decode", [True, False])
def test_dit_sample_fid_follows_the_jax_rules(decode):
    labels = np.asarray([3, 0, 2, 2, 1, 3, 0])
    twl, jwl = _StubWorkload(True), _StubWorkload(False)
    kw = dict(respacing="7", cond_scale=2.5, batch_size=3, seed=1)
    got = TR.dit_sample_fid(
        twl, None, labels,
        decode_fn=(lambda z: 1.25 * z[..., :3]) if decode else None, **kw)
    want = JR.dit_sample_fid(
        jwl, None, labels,
        decode_fn=(lambda z: 1.25 * z[..., :3]) if decode else None, **kw)
    want = np.asarray(want)
    assert got.dtype == want.dtype == (np.uint8 if decode else np.float32)
    assert got.shape == want.shape == ((7, 4, 4, 3) if decode
                                       else (7, 4, 4, 4))
    np.testing.assert_array_equal(got, want)
    if decode:
        assert got.min() == 0 and got.max() == 255      # clipped both ways
    # the label order in batches of 3, the last padded with label 0
    assert twl.calls == [("7", 2.5), [3, 0, 2], [2, 1, 3], [0, 0, 0]]


def test_dit_sample_cli_writes_a_grid_and_an_fid_npz(tmp_path, vae_file):
    from uurg_torch.cli import dit_sample

    out = str(tmp_path / "fid")
    dit_sample.main([*DIT, "--mode", "fid_npz", "--num-fid-samples", "6",
                     "--num-sampling-steps", "2", "--per-proc-batch-size",
                     "4", "--vae-ckpt", vae_file, "--sample-dir", out])
    with np.load(os.path.join(out, "samples_0.npz")) as d:
        imgs, labels = d["arr_0"], d["labels"]
    assert imgs.dtype == np.uint8 and imgs.shape == (6, 256, 256, 3)
    assert imgs.std() > 0
    np.testing.assert_array_equal(labels, [0, 1, 2, 3, 0, 1])
    grid = str(tmp_path / "grid")
    dit_sample.main([*DIT, "--mode", "grid", "--class-labels", "1", "3",
                     "--num-sampling-steps", "2", "--vae-ckpt", vae_file,
                     "--sample-dir", grid])
    with Image.open(os.path.join(grid, "sample.png")) as im:
        assert im.size == (512, 256) and im.mode == "RGB"
    for flag in ("--ckpt", "--vae-ckpt"):
        with pytest.raises(ValueError, match="Orbax"):
            dit_sample.main([*DIT, flag, str(tmp_path), "--sample-dir",
                             grid])


def test_dit_sample_cli_on_two_ranks(tmp_path, vae_file):
    """Under two gloo ranks rank r samples labels[r::2] from seed r, in
    both modes; the grid that rank 0 writes holds every label's sample in
    label order: the tiles are the fid_npz files' samples of the same
    labels, interleaved."""
    from tests import torch_parallel_ranks as PR

    common = [*DIT, "--num-sampling-steps", "2", "--per-proc-batch-size",
              "2", "--vae-ckpt", vae_file, "--sample-dir", str(tmp_path)]
    PR.spawn("dit_sample_cli", 2, tmp_path,
             [*common, "--mode", "grid", "--class-labels", "0", "1", "2"],
             [*common, "--mode", "fid_npz", "--num-fid-samples", "3"])
    parts = []
    for r in range(2):
        with np.load(tmp_path / f"samples_{r}.npz") as d:
            np.testing.assert_array_equal(d["labels"], [0, 1, 2][r::2])
            parts.append(d["arr_0"])
    with Image.open(tmp_path / "sample.png") as im:
        grid = np.asarray(im)
    assert grid.shape == (256, 3 * 256, 3)
    tiles = [grid[:, 256 * i:256 * (i + 1)] for i in range(3)]
    for tile, want in zip(tiles, (parts[0][0], parts[1][0], parts[0][1])):
        np.testing.assert_array_equal(tile, want)
    assert not np.array_equal(tiles[0], tiles[1])
