"""The SD method CLIs end to end with ``--device cpu`` at tiny configs, the
SD layout of ``generate_fisher_mask``, and ``data/sd_data.py`` against the
JAX package (CPU):

- ``generate_fisher_mask`` on a folder of ``nude_forget`` and
  ``nude_remain`` writes ``nude_mask_<th>`` equal to JAX's
  ``fisher_ratio_mask`` of the same Fishers;
- ``nsfw_removal`` under a packed mask writes its snapshot (a CompVis
  ``step_<i>.pt`` and the Diffusers ``.npz``) and ``final.pt``, which
  ``train_esd``, ``gradient_ascent``, ``proximal_gradient`` and
  ``random_label`` read back with ``--ckpt_path``; each writes a finite
  ``final.pt`` that moved;
- ``--profile_dir`` writes a trace, the default device is CUDA;
  ``--parallelism sp`` reaches the runner; ``--mesh`` with
  ``--parallelism`` fsdp, tp or sp on one rank writes the default run's
  weights;
- the ``sd_data`` streams equal the JAX package's on a seeded PNG tree."""
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from tests.test_torch_sd_interop import _png_folder, tiny_cli  # noqa: E402,F401
from uurg_torch.io.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from uurg_torch.io.diffusers_interop import diffusers_key_map  # noqa: E402
from uurg_torch.io.sd_interop import PREFIX, sd_unet_key_map  # noqa: E402
from uurg_torch.models import sd_unet as TU  # noqa: E402

UNET = dict(model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
            attention_ds=(1, 2), num_heads=2, context_dim=16)
# the tiny VAE halves 16 px to the UNet's 8 x 8 latents; ESD draws latents
# of image_size // 8 itself
COMMON = ["--image_size", "16", "--batch_size", "2", "--seed", "3",
          "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _names():
    with torch.device("meta"):
        return {k: v.shape for k, v in
                TU.SDUNet(TU.SDUNetConfig(**UNET)).named_parameters()}


def test_generate_fisher_mask_sd_layout_matches_jax(tmp_path):
    from uurg_torch.cli import generate_fisher_mask
    from uurg_tpu.unlearn.saliency import fisher_ratio_mask

    rng = np.random.default_rng(0)
    fishers = {name: {k: torch.from_numpy(rng.exponential(
        1e-6, s).astype(np.float32)) for k, s in _names().items()}
        for name in ("nude_forget", "nude_remain")}
    for name, tree in fishers.items():
        save_checkpoint(str(tmp_path / name), tree)
    generate_fisher_mask.main(["--ckpt_folder", str(tmp_path), "--threshold",
                               "0.5", "2.0", "--device", "cpu"])
    assert sorted(os.listdir(tmp_path)) == [
        "nude_forget", "nude_mask_0.5", "nude_mask_2.0", "nude_remain"]
    np_f, np_r = ({k: v.numpy() for k, v in fishers[n].items()}
                  for n in ("nude_forget", "nude_remain"))
    for th in (0.5, 2.0):
        got = restore_checkpoint(str(tmp_path / f"nude_mask_{th}"))
        want = fisher_ratio_mask(np_f, np_r, th)
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == torch.bool, k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                          err_msg=k)
        assert 0 < sum(int(v.sum()) for v in got.values()) < sum(
            v.numel() for v in got.values())


def _weights(path):
    return torch.load(path, map_location="cpu",
                      weights_only=True)["state_dict"]


def _moved(a: dict, b: dict) -> bool:
    return any(not torch.equal(a[k], b[k]) for k in a)


def test_the_five_clis_end_to_end(tmp_path, tiny_cli):  # noqa: F811
    from uurg_torch.cli import (gradient_ascent, nsfw_removal,
                                proximal_gradient, random_label, sd_common,
                                train_esd)

    nsfw = _png_folder(tmp_path / "nsfw", 5, 0)
    clothed = _png_folder(tmp_path / "clothed", 3, 1)
    rng = np.random.default_rng(1)
    mask = {k: torch.from_numpy(rng.random(s) < 0.5)
            for k, s in _names().items()}
    save_checkpoint(str(tmp_path / "nude_mask_0.5"), mask)

    class Start:
        ckpt_path = ""

    _, unet = sd_common.setup_workload(Start, "cpu")
    start = {f"{PREFIX}{ck}": unet.state_dict()[ours]
             for ck, ours in sd_unet_key_map(unet.cfg)
             if ours in unet.state_dict()}

    out = tmp_path / "nsfw_removal"
    nsfw_removal.main([*COMMON, "--nsfw_data", nsfw, "--not_nsfw_data",
                       clothed, "--mask_path", str(tmp_path / "nude_mask_0.5"),
                       "--pack_mask", "--n_iters", "2", "--snapshot_freq", "2",
                       "--lr", "1e-3", "--save_path", str(out)])
    assert sorted(os.listdir(out)) == ["final.pt", "step_1.pt",
                                       "step_1_diffusers.npz"]
    final = str(out / "final.pt")
    weights = _weights(final)
    assert set(weights) == set(start) and _moved(weights, start)
    # the snapshot is the last step's weights, in both layouts
    snap = _weights(str(out / "step_1.pt"))
    assert not _moved(snap, weights)
    by_name = dict(sd_unet_key_map(unet.cfg))
    to_compvis = {ours: f"{PREFIX}{ck}" for ck, ours in by_name.items()}
    with np.load(out / "step_1_diffusers.npz") as d:
        keys = {k for k, ours in diffusers_key_map(unet.cfg)
                if ours in unet.state_dict()}
        assert set(d.files) == keys
        for k, ours in diffusers_key_map(unet.cfg):
            if k in keys:
                np.testing.assert_array_equal(
                    d[k], snap[to_compvis[ours]].numpy(), err_msg=k)
    # --ckpt_path reads the file back into the model
    Start.ckpt_path = final
    _, back = sd_common.setup_workload(Start, "cpu")
    assert all(torch.equal(back.state_dict()[ours], weights[ck])
               for ck, ours in ((f"{PREFIX}{c}", o) for c, o in
                                by_name.items()) if ours in back.state_dict())

    runs = {
        "train_esd": (train_esd, ["--iterations", "2", "--ddim_steps", "4",
                                  "--image_size", "64", "--seed", "3",
                                  "--mask_path",
                                  str(tmp_path / "nude_mask_0.5"),
                                  "--device", "cpu"]),
        "gradient_ascent": (gradient_ascent, [*COMMON, "--n_iters", "2"]),
        "proximal_gradient": (proximal_gradient, [*COMMON, "--n_iters", "2",
                                                  "--top_ratio", "0.05"]),
        "random_label": (random_label, [*COMMON, "--n_iters", "2"]),
    }
    for name, (cli, argv) in runs.items():
        data = [] if name == "train_esd" else [
            "--forget_data", nsfw, "--remain_data", clothed]
        save = tmp_path / name
        cli.main([*argv, *data, "--ckpt_path", final, "--lr", "1e-3",
                  "--save_path", str(save)])
        assert os.listdir(save) == ["final.pt"], name
        got = _weights(str(save / "final.pt"))
        assert set(got) == set(weights), name
        assert all(torch.isfinite(v).all() for v in got.values()), name
        assert _moved(got, weights), name
        if name == "train_esd":           # xattn: only attn2 trains
            assert all(torch.equal(got[k], weights[k]) for k in got
                       if ".attn2." not in k)


def test_nsfw_removal_cli_passes_sp_to_the_runner(monkeypatch, tmp_path,
                                                  tiny_cli):  # noqa: F811
    from uurg_torch.cli import nsfw_removal
    from uurg_torch.workloads import sd_runner

    seen = {}

    def recorded(wl, unet, fb, rb, **kw):
        seen.update(kw)

    monkeypatch.setattr(sd_runner, "nsfw_removal", recorded)
    nsfw_removal.main([*COMMON, "--parallelism", "sp", "--n_iters", "1",
                       "--nsfw_data", str(tmp_path / "none"),
                       "--not_nsfw_data", str(tmp_path / "none"),
                       "--save_path", str(tmp_path / "out")])
    assert seen["parallelism"] == "sp" and seen["mesh"] is None


@pytest.mark.parametrize("flags,match", [
    (["--profile_dir", "trace"], "profile_dir"),
])
def test_nsfw_removal_refuses_what_the_port_cannot_do(
        flags, match, monkeypatch, tmp_path, tiny_cli):  # noqa: F811
    """The flag the port refused until it had its own profiler
    (``uurg_torch/utils/profiling.py``): ``--profile_dir`` now reaches the
    runner inside a trace and writes ``trace.json``."""
    from uurg_torch.cli import nsfw_removal
    from uurg_torch.workloads import sd_runner

    seen = {}
    monkeypatch.setattr(sd_runner, "nsfw_removal",
                        lambda wl, unet, fb, rb, **kw: seen.update(kw))
    monkeypatch.chdir(tmp_path)
    nsfw_removal.main([*COMMON, *flags, "--n_iters", "1",
                       "--nsfw_data", str(tmp_path / "none"),
                       "--not_nsfw_data", str(tmp_path / "none"),
                       "--save_path", str(tmp_path / "out")])
    assert seen["n_iters"] == 1
    assert (tmp_path / flags[flags.index(f"--{match}") + 1]
            / "trace.json").is_file()


@pytest.mark.parametrize("cli", ["nsfw_removal", "train_esd",
                                 "gradient_ascent", "proximal_gradient",
                                 "random_label"])
def test_sd_method_clis_default_to_cuda(cli, tmp_path):
    import importlib

    main = importlib.import_module(f"uurg_torch.cli.{cli}").main
    if not torch.cuda.is_available():     # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--save_path", str(tmp_path)])


def test_sd_data_streams_match_jax(tmp_path):
    from PIL import Image

    from uurg_torch.data import sd_data as T
    from uurg_tpu.data import sd_data as J

    rng = np.random.default_rng(2)
    root = tmp_path / "imagenette"
    for c in ("church", "parachute", "tench"):
        (root / c).mkdir(parents=True)
        for i in range(5):
            Image.fromarray(rng.integers(0, 256, (20, 18, 3), np.uint8)) \
                .save(root / c / f"{i}.png")
    for d in ("nsfw", "not-nsfw"):
        (tmp_path / d).mkdir()
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (12, 14, 3), np.uint8)) \
                .save(tmp_path / d / f"{i}.png")
    assert T.IMAGENETTE_CLASSES == J.IMAGENETTE_CLASSES
    streams = [
        (T.setup_data(1, 4, 16, root=str(root)),
         J.setup_data(1, 4, 16, root=str(root))),
        (T.setup_forget_data(1, 2, 16, root=str(root), seed=3),
         J.setup_forget_data(1, 2, 16, root=str(root), seed=3)),
        (T.setup_ga_data(2, 2, 16, root=str(root)),
         J.setup_ga_data(2, 2, 16, root=str(root))),
        (T.setup_remain_data(1, 4, 16, root=str(root), seed=4),
         J.setup_remain_data(1, 4, 16, root=str(root), seed=4)),
    ]
    for (got_it, got_desc), (want_it, want_desc) in streams:
        assert got_desc == want_desc
        for _ in range(3):
            (x, y), (wx, wy) = next(got_it), next(want_it)
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(y, wy)
            assert x.dtype == np.float32 and x.min() >= -1 and x.max() <= 1
    nsfw = dict(nsfw_root=str(tmp_path / "nsfw"),
                remain_root=str(tmp_path / "not-nsfw"), seed=5)
    for got, want in zip(T.setup_forget_nsfw_data(2, 8, **nsfw),
                         J.setup_forget_nsfw_data(2, 8, **nsfw)):
        for _ in range(3):
            (x, y), (wx, wy) = next(got), next(want)
            np.testing.assert_array_equal(x, wx)
            np.testing.assert_array_equal(y, wy)
    with pytest.raises(FileNotFoundError, match="no images"):
        T.setup_forget_nsfw_data(2, 8, nsfw_root=str(root),
                                 remain_root=str(root))


@pytest.mark.parametrize("parallelism,spec", [("fsdp", "data=1,model=1"),
                                              ("tp", "data=1,model=1"),
                                              ("sp", "data=1,seq=1")])
def test_nsfw_removal_cli_on_a_one_rank_mesh(tmp_path, tiny_cli,  # noqa: F811
                                             parallelism, spec):
    """--mesh data=1,model=1 --parallelism fsdp or tp (the UNet sharded
    over one rank, the gradients all-reduced over it), and --mesh
    data=1,seq=1 --parallelism sp, write the default run's final.pt bit
    for bit."""
    from tests.torch_parallel_ranks import one_rank_group
    from uurg_torch.cli import nsfw_removal

    nsfw = _png_folder(tmp_path / "nsfw", 4, 0)
    clothed = _png_folder(tmp_path / "clothed", 2, 1)
    rng = np.random.default_rng(1)
    save_checkpoint(str(tmp_path / "mask"),
                    {k: torch.from_numpy(rng.random(s) < 0.5)
                     for k, s in _names().items()})
    argv = [*COMMON, "--nsfw_data", nsfw, "--not_nsfw_data", clothed,
            "--mask_path", str(tmp_path / "mask"), "--pack_mask",
            "--n_iters", "1", "--lr", "1e-3"]
    nsfw_removal.main([*argv, "--save_path", str(tmp_path / "a")])
    with one_rank_group():
        nsfw_removal.main([*argv, "--save_path", str(tmp_path / "b"),
                           "--mesh", spec, "--parallelism", parallelism])
    a, b = (_weights(str(tmp_path / d / "final.pt")) for d in ("a", "b"))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
