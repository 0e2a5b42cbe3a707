"""The port's DiT workload and runner vs the JAX package (CPU, fp32): the
losses, three SFR-on steps of ``dit_forget`` (ron and joint), resume, the
checkpoint the JAX loader reads, the Fisher and mask files, the CFG sample
grid, and the three CLIs end to end with ``--device cpu``.

The JAX functions draw t and noise from their keys; each test reproduces
those draws with ``jax.random`` and injects them into the port (its
workload's ``_draw``), so both sides see the same t and noise. Multi-step
comparisons run SGD with momentum: Adam turns gradients that are zero in
exact arithmetic into +-lr moves of random sign on both sides."""
import os
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from uurg_torch.core import tree as TT  # noqa: E402
from uurg_torch.diffusion import gaussian as TG  # noqa: E402
from uurg_torch.diffusion import losses as TL  # noqa: E402
from uurg_torch.io import checkpoint as CK  # noqa: E402
from uurg_torch.io.jax_interop import jax_dit_params_to_torch  # noqa: E402
from uurg_torch.models import dit as TD  # noqa: E402
from uurg_torch.train import optim as TO  # noqa: E402
from uurg_torch.workloads import dit_runner as TR  # noqa: E402
from uurg_torch.workloads.dit import DiTWorkload as TW  # noqa: E402
from uurg_tpu.diffusion import gaussian as JG  # noqa: E402
from uurg_tpu.diffusion.losses import adaptive_loss  # noqa: E402
from uurg_tpu.io import dit_interop as JI  # noqa: E402
from uurg_tpu.models import dit as JD  # noqa: E402
from uurg_tpu.train import optim as JO  # noqa: E402
from uurg_tpu.unlearn import fisher as JF  # noqa: E402
from uurg_tpu.unlearn import saliency as JSal  # noqa: E402
from uurg_tpu.workloads import dit_runner as JR  # noqa: E402
from uurg_tpu.workloads.dit import DiTWorkload as JW  # noqa: E402

COMMON = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=144,
              depth=2, num_heads=2, num_classes=10)
# fp32 forward of the 2-block DiT, then means over 256 elements a sample
LOSS_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs (several pytest-xdist
    workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _perturb(params, seed=0):
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a, np.float32)
        std = 0.5 / np.sqrt(a.shape[-2]) if a.ndim >= 2 else 0.05
        return a + (rng.standard_normal(a.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map(one, params)


@pytest.fixture(scope="module")
def tiny():
    """(JAX workload, port workload, perturbed JAX params)."""
    jc = JD.DiTConfig(**COMMON, dtype=jnp.float32)
    jwl = JW(model=JD.DiT(jc), cfg=jc,
             diffusion=JG.make_diffusion("", 1000, learn_sigma=True))
    _, params = JD.init_dit(jax.random.key(0), jc)
    tc = TD.DiTConfig(**COMMON, dtype=torch.float32)
    twl = TW(cfg=tc, diffusion=TG.make_diffusion("", 1000), device=torch.device("cpu"))
    return jwl, twl, _perturb(params)


def _model(twl, params):
    model = TD.DiT(twl.cfg)
    model.load_state_dict(jax_dit_params_to_torch(params, twl.cfg.depth))
    return model


def _batch(seed, n=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 8, 8, 4)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _tb(batch):
    return tuple(torch.from_numpy(np.asarray(a)) for a in batch)


def _jax_draw(rng, x):
    """What the JAX workload's ``_per_sample_loss`` draws from ``rng``."""
    k_t, k_n = jax.random.split(rng)
    t = jax.random.randint(k_t, (x.shape[0],), 0, 1000)
    noise = jax.random.normal(k_n, x.shape, x.dtype)
    return (torch.from_numpy(np.asarray(t)).long(),
            torch.from_numpy(np.asarray(noise)))


def _inject(monkeypatch, twl, draws):
    """The port's workload takes its draws from ``draws`` in order."""
    queue = list(draws)
    monkeypatch.setattr(twl, "_draw", lambda x, g: queue.pop(0))
    return queue


def test_losses_match_jax(tiny, monkeypatch):
    jwl, twl, params = tiny
    model = _model(twl, params)
    batch = _batch(1)
    key = jax.random.key(3)
    per_j = np.asarray(jwl._per_sample_loss(params, batch, key))
    t, noise = _jax_draw(key, batch[0])
    x, y = _tb(batch)
    per_t = twl.per_sample_loss(model, x, y.long(), t, noise)
    np.testing.assert_allclose(per_t.detach().numpy(), per_j, rtol=LOSS_REL)
    for kind, want in (
            ("ga", jwl.ga_forget_loss_fn()(params, batch, key)),
            ("adaga", jwl.adaga_forget_loss_fn()(params, batch, key)),
            ("rl", jwl.rl_forget_loss_fn(3)(params, batch, key))):
        _inject(monkeypatch, twl, [(t, noise)])
        got = twl.forget_loss_fn(kind, 3)(model, (x, y.long()), None)
        np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_REL,
                                   err_msg=kind)
    np.testing.assert_allclose(
        -TL.adaptive_loss(per_t, 0.5, eps=1e-15).item(),
        float(-adaptive_loss(per_j, 0.5, eps=1e-15)), rtol=LOSS_REL)
    # the sampler-weighted loss: importance-weighted mean, ring updated
    from uurg_torch.diffusion import timestep_sampler as TTS
    state = TTS.init_loss_second_moment(1000)
    gen = torch.Generator().manual_seed(0)
    loss, new = twl.train_loss_with_sampler_fn()(model, (x, y.long()), gen,
                                                 state)
    assert torch.isfinite(loss) and int(new.counts.sum()) == 4


def _cfg_output(monkeypatch, jwl, twl, params, cfg_channels):
    """Each package's CFG model output at one (x, t): its sampler's loop is
    replaced by one call of the guided model function."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 8, 8, 4)).astype(np.float32)
    t = np.array([999, 500, 3])
    labels = np.array([1, 4, 7])
    monkeypatch.setattr(JG.GaussianDiffusion, "p_sample_loop",
                        lambda self, fn, shape, key, **kw: fn(x, t))
    monkeypatch.setattr(TG.GaussianDiffusion, "p_sample_loop",
                        lambda self, fn, shape, gen=None, **kw:
                        fn(torch.from_numpy(x), torch.from_numpy(t)))
    want = np.asarray(jwl.make_sampler(
        respacing="4", cond_scale=4.0, cfg_channels=cfg_channels)(
        params, jnp.asarray(labels), jax.random.key(0)))
    got = twl.make_sampler(respacing="4", cond_scale=4.0,
                           cfg_channels=cfg_channels)(
        _model(twl, params), torch.from_numpy(labels))
    return got, want, x, t, labels


@pytest.mark.parametrize("cfg_channels", [3, None])
def test_cfg_guidance_matches_jax(tiny, monkeypatch, cfg_channels):
    jwl, twl, params = tiny
    got, want, x, t, labels = _cfg_output(monkeypatch, jwl, twl, params,
                                          cfg_channels)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        cond = _model(twl, params)(torch.from_numpy(x), torch.from_numpy(t),
                                   torch.from_numpy(labels))
    # the unguided channels: the 4th eps channel under the 3-channel quirk,
    # and the variance channels always, are the conditional output's
    first = 3 if cfg_channels == 3 else 4
    torch.testing.assert_close(got[..., first:], cond[..., first:],
                               rtol=1e-6, atol=1e-6)
    assert not torch.allclose(got[..., :3], cond[..., :3], atol=1e-3)


def test_sample_grid_writes_latents_and_images(tiny, tmp_path):
    _, twl, params = tiny
    model = _model(twl, params)
    out = TR.dit_sample_grid(twl, model, str(tmp_path / "grid.npz"),
                             n_per_class=2, classes=[0, 3], respacing="3")
    with np.load(out) as d:
        assert d["latents"].shape == (4, 8, 8, 4)
        assert np.isfinite(d["latents"]).all() and d["latents"].std() > 0
        np.testing.assert_array_equal(d["labels"], [0, 0, 3, 3])
    # the same seed gives the same sheet; a decoder gives uint8 images
    again = TR.dit_sample_grid(twl, model, str(tmp_path / "again.npz"),
                               n_per_class=2, classes=[0, 3], respacing="3")
    with np.load(out) as a, np.load(again) as b:
        np.testing.assert_array_equal(a["latents"], b["latents"])
    img = TR.dit_sample_grid(twl, model, str(tmp_path / "img.npz"),
                             n_per_class=1, classes=[1], respacing="2",
                             decode_fn=lambda z: torch.tanh(z[..., :3]))
    with np.load(img) as d:
        assert d["images"].dtype == np.uint8 and d["images"].shape == (
            1, 8, 8, 3)


def _sgd(monkeypatch):
    monkeypatch.setattr(JR, "make_optimizer",
                        lambda name, lr, **kw: JO.make_optimizer(
                            "sgd", lr, momentum=0.9))
    monkeypatch.setattr(TR, "make_optimizer",
                        lambda name, params, lr, **kw: TO.make_optimizer(
                            "sgd", params, lr, momentum=0.9))


def _flat(tree, names):
    return torch.cat([tree[k].reshape(-1) for k in names])


@pytest.mark.parametrize("method,pack", [("ron", True), ("joint", False)])
def test_three_sgd_steps_of_dit_forget_match_jax(tiny, monkeypatch, method,
                                                 pack):
    jwl, twl, params = tiny
    _sgd(monkeypatch)
    rng = np.random.default_rng(11)
    mask_j = jax.tree_util.tree_map(
        lambda p: rng.random(p.shape) < 0.6, params)
    fbs = [_batch(100 + i) for i in range(3)]
    rbs = [_batch(200 + i) for i in range(3)]
    kw = dict(n_iters=3, lr=1e-2, forget_alpha=0.5, unlearn_loss="adaga",
              method=method, ema_decay=0.5, decay_forget_alpha=True,
              grad_clip=1.0, seed=4, log_freq=1)
    state_j = JR.dit_forget(jwl, params, iter(fbs), iter(rbs),
                            mask=mask_j, pack_mask=pack, **kw)
    key = jax.random.key(4)
    draws = []
    for i in range(3):
        k_f, k_r = jax.random.split(jax.random.fold_in(key, i))
        draws += [_jax_draw(k_f, fbs[i][0]), _jax_draw(k_r, rbs[i][0])]
    queue = _inject(monkeypatch, twl, draws)
    model = _model(twl, params)
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    mask_t = {k: v.bool() for k, v in jax_dit_params_to_torch(
        jax.tree_util.tree_map(lambda m: m.astype(np.float32),
                               mask_j)).items()}
    state_t = TR.dit_forget(twl, model, iter(fbs), iter(rbs), mask=mask_t,
                            pack_mask=pack, **kw)
    assert not queue and state_t.step == int(state_j.step) == 3
    if pack:
        assert all(isinstance(m, TT.PackedMask)
                   for m in state_t.mask.values())
    names = list(start)
    want_p = jax_dit_params_to_torch(state_j.params)
    want_e = jax_dit_params_to_torch(state_j.ema_params)
    got_p = dict(model.named_parameters())
    got_e = dict(state_t.ema_model.named_parameters())
    # the update (params - start) held to its norm: 3 steps of fp32
    # gradients through the 2-block DiT, each within ~1e-5
    for got, want in ((got_p, want_p), (got_e, want_e)):
        d_t = _flat({k: got[k].detach() - start[k] for k in names}, names)
        d_j = _flat({k: want[k] - start[k] for k in names}, names)
        assert d_j.norm() > 0
        assert (d_t - d_j).norm() / d_j.norm() < 1e-3
        for k in names:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       want[k].numpy(), atol=1e-5,
                                       err_msg=k)
    if method == "joint":       # the combined gradient is masked
        for k in names:
            off = ~mask_t[k]
            assert torch.equal(got_p[k].detach()[off], start[k][off]), k


def test_dit_forget_resumes_and_writes_reference_files(tiny, tmp_path):
    jwl, twl, params = tiny
    batch = _batch(7)

    def same():
        while True:
            yield batch

    kw = dict(lr=1e-3, forget_alpha=0.5, unlearn_loss="ga", seed=2,
              ckpt_freq=2, snapshot_freq=3)
    shots = []
    hook = lambda state, i: shots.append(i)  # noqa: E731
    whole = TR.dit_forget(twl, _model(twl, params), same(), same(),
                          n_iters=4, ckpt_dir=str(tmp_path / "a"),
                          sample_hook=hook, **kw)
    assert shots == [2]
    names = sorted(os.listdir(tmp_path / "a"))
    assert names == ["ckpt_0000001.pt", "ckpt_0000003.pt", "final.pt",
                     "train_state.pt"]
    TR.dit_forget(twl, _model(twl, params), same(), same(), n_iters=2,
                  ckpt_dir=str(tmp_path / "b"), **kw)
    resumed = TR.dit_forget(twl, _model(twl, params), same(), same(),
                            n_iters=4, ckpt_dir=str(tmp_path / "b"), **kw)
    assert resumed.step == whole.step == 4
    for a, b in zip(whole.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(whole.ema_model.parameters(),
                    resumed.ema_model.parameters()):
        assert torch.equal(a, b)
    # the JAX package reads the port's final.pt (its EMA)
    back = JI.load_dit_reference_checkpoint(str(tmp_path / "a" / "final.pt"),
                                            jwl.cfg)
    again = jax_dit_params_to_torch(back, twl.cfg.depth)
    for k, v in whole.ema_model.state_dict().items():
        assert torch.equal(again[k], v), k


def test_fisher_and_mask_files_match_jax(tiny, monkeypatch, tmp_path):
    jwl, twl, params = tiny
    fbs = [_batch(300 + i) for i in range(2)]
    rbs = [_batch(400 + i) for i in range(2)]
    want = {}
    draws = []
    for name, bs in (("forget", fbs), ("remain", rbs)):
        want[name] = jax_dit_params_to_torch(JF.accumulate_fisher(
            jwl.train_loss_fn(), params, iter(bs), jax.random.key(6)))
        key = jax.random.key(6)
        for b in bs:
            key, sub = jax.random.split(key)
            draws.append(_jax_draw(sub, b[0]))
    queue = _inject(monkeypatch, twl, draws)
    out = TR.dit_generate_fisher(twl, _model(twl, params), iter(fbs),
                                 iter(rbs), n_iters=2,
                                 out_dir=str(tmp_path / "0"), seed=6)
    assert not queue
    model = _model(twl, params)
    for name in ("forget", "remain"):
        got = CK.restore_checkpoint(os.path.join(out, f"{name}_fisher"),
                                    model)
        # squared batch gradients: twice the gradients' relative error
        g, w = _flat(got, sorted(got)), _flat(want[name], sorted(got))
        assert w.norm() > 0 and (g - w).norm() / w.norm() < 2e-4, name
    # masks bit-equal where both threshold the same Fisher: JAX's, written
    # as the port's files
    same = tmp_path / "same"
    for name in ("forget", "remain"):
        CK.save_checkpoint(str(same / f"{name}_fisher"), want[name])
    masks = TR.dit_generate_mask(str(same), [1.0, 0.5], params_like=model,
                                 device="cpu")
    jf = {n: jax.tree_util.tree_map(
        jnp.asarray, JI.torch_dit_state_to_flax(want[n], jwl.cfg))
        for n in ("forget", "remain")}
    for th in (1.0, 0.5):
        ref = jax_dit_params_to_torch(jax.tree_util.tree_map(
            lambda m: np.asarray(m, np.float32),
            JSal.fisher_ratio_mask(jf["forget"], jf["remain"], th)))
        on_disk = CK.restore_checkpoint(str(same / f"fisher_{th}"), model)
        for k in ref:
            assert torch.equal(masks[th][k], ref[k].bool()), (th, k)
            assert torch.equal(on_disk[k], ref[k].bool()), (th, k)


@pytest.mark.parametrize("parallelism,axis", [("pp", "stage"),
                                               ("sp", "seq")])
def test_dit_forget_needs_the_mode_axis(tiny, parallelism, axis):
    # JAX's ValueError for a mesh without the mode's axis, before any
    # placement (the pipeline and the ring run on gloo ranks in
    # tests/test_torch_parallel_pp.py and _sp.py)
    import types

    _, twl, params = tiny
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(1, 1))
    with pytest.raises(ValueError, match=f"'{axis}' mesh axis"):
        TR.dit_forget(twl, _model(twl, params), iter([]), iter([]),
                      mesh=mesh, parallelism=parallelism, pp_microbatches=2)


@pytest.mark.parametrize("parallelism", ["pp", "sp"])
def test_dit_forget_pp_and_sp_without_a_mesh_run_as_one_device(
        tiny, parallelism):
    """As in JAX, the mode (and the microbatches) is read only under a
    mesh: without one the run is the default run, bit for bit."""
    _, twl, params = tiny
    fbs, rbs = [_batch(60 + i) for i in range(2)], [_batch(70 + i)
                                                   for i in range(2)]
    kw = dict(n_iters=2, lr=1e-3, forget_alpha=0.5, unlearn_loss="ga",
              seed=2)
    want = TR.dit_forget(twl, _model(twl, params), iter(fbs), iter(rbs), **kw)
    got = TR.dit_forget(twl, _model(twl, params), iter(fbs), iter(rbs),
                        parallelism=parallelism, pp_microbatches=2, **kw)
    for m_got, m_want in ((got.model, want.model),
                          (got.ema_model, want.ema_model)):
        for (k, v), w in zip(m_got.state_dict().items(),
                             m_want.state_dict().values()):
            assert torch.equal(v, w), k


@pytest.mark.parametrize("spec,parallelism", [
    ("data=1", "dp"), ("data=1", "fsdp"), ("data=1,model=1", "fsdp"),
    ("data=1,model=1", "tp"), ("data=1,stage=1", "pp")])
def test_dit_forget_on_a_one_rank_mesh_equals_the_default(tiny, spec,
                                                          parallelism):
    """The one-rank mesh runs the group's path (the batch split, the
    gradient all-reduce, FSDP2's sharding over one rank, tensor parallel's
    placement and paired operators or the pipeline's one stage in one
    microbatch, the shard-wise mask, clip, Adam and EMA) to the default
    run's weights, bit for bit."""
    from tests.torch_parallel_ranks import one_rank_group
    from uurg_torch.parallel import make_mesh, parse_mesh_spec

    _, twl, params = tiny
    # two steps of two microbatches each
    fbs, rbs = [_batch(40 + i) for i in range(4)], [_batch(50 + i)
                                                   for i in range(4)]
    rng = np.random.default_rng(3)
    model = _model(twl, params)
    mask = {n: torch.from_numpy(rng.random(tuple(p.shape)) < 0.6)
            for n, p in model.named_parameters()}
    kw = dict(n_iters=2, lr=1e-3, forget_alpha=0.5, unlearn_loss="adaga",
              mask=mask, seed=6, grad_accum=2)
    want = TR.dit_forget(twl, model, iter(fbs), iter(rbs), **kw)
    with one_rank_group():
        got = TR.dit_forget(twl, _model(twl, params), iter(fbs), iter(rbs),
                            mesh=make_mesh(parse_mesh_spec(spec)),
                            parallelism=parallelism, **kw)
        sharded = [n for n, p in got.model.named_parameters()
                   if type(p).__name__ == "DTensor"]
        # fsdp shards over "model", else over the largest axis when it is
        # larger than 1 (JAX's rule): data=1 alone shards nothing; tp
        # places the rules' parameters over "model"
        assert bool(sharded) == ("model" in spec)
        if parallelism == "tp":
            assert "blocks.0.attn.qkv.weight" in sharded
            assert "final_layer.adaLN_modulation.1.weight" not in sharded
        for m_got, m_want in ((got.model, want.model),
                              (got.ema_model, want.ema_model)):
            have = {k: v.full_tensor() if type(v).__name__ == "DTensor"
                    else v for k, v in m_got.state_dict().items()}
            for k, v in m_want.state_dict().items():
                assert torch.equal(have[k], v), k


# -- the three CLIs ---------------------------------------------------------

CLI = ["--model", "DiT-S/8", "--num-classes", "4", "--device", "cpu"]


def _shards(tmp_path):
    from uurg_torch.data.lazy import write_latent_shards

    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((24, 32, 32, 4)).astype(np.float32),
                rng.integers(0, 4, 24)) for _ in range(2)]
    write_latent_shards(str(tmp_path / "lat" / "shard"), iter(batches), 24)
    return str(tmp_path / "lat")


def test_the_three_clis_end_to_end(tmp_path, capsys):
    from uurg_torch.cli import dit_generate_fisher, dit_generate_mask, forget
    from uurg_torch.workloads import ddpm_runner

    data = _shards(tmp_path)
    masks = str(tmp_path / "masks")
    dit_generate_fisher.main([*CLI, "--data-path", data, "--forget-class",
                              "1", "--n-iters", "1", "--mask-path", masks])
    dit_generate_mask.main(["--mask-path", masks, "--forget-class", "1",
                            "--thresholds", "1.0", "--device", "cpu"])
    files = sorted(os.listdir(os.path.join(masks, "1")))
    assert files == ["fisher_1.0", "forget_fisher", "remain_fisher"]
    results = str(tmp_path / "res")
    forget.main([*CLI, "--data-path", data, "--mask-path",
                 os.path.join(masks, "1", "fisher_1.0"), "--pack_mask",
                 "--unlearn-loss", "adaga", "--n-iters", "2",
                 "--snapshot-every", "3", "--ckpt-every", "2",
                 "--log-every", "1", "--global-batch-size", "2",
                 "--label-to-forget", "1", "--results-dir", results])
    run = os.path.join(results, "forget_1")
    assert sorted(os.listdir(run)) == ["ckpt_0000001.pt", "final.pt",
                                       "train_state.pt"]
    assert "done:" in capsys.readouterr().out
    # the mask the CLI read is the model's, and the checkpoint the port's
    # loader reads
    model, _ = TD.build_dit("DiT-S/8", num_classes=4)
    mask = ddpm_runner.load_mask(os.path.join(masks, "1", "fisher_1.0"),
                                 model)
    assert 0.0 < TT.sparsity(mask) < 1.0
    from uurg_torch.io.dit_interop import load_dit_reference_checkpoint
    load_dit_reference_checkpoint(os.path.join(run, "final.pt"), model)
    assert all(torch.isfinite(p).all() for p in model.parameters())
    # the synthetic tier (no --data-path) feeds the same CLI
    forget.main([*CLI, "--n-iters", "1", "--snapshot-every", "1",
                 "--global-batch-size", "2", "--results-dir",
                 str(tmp_path / "syn")])
    with np.load(tmp_path / "syn" / "forget_0" / "vis_step000000.npz") as d:
        assert d["latents"].shape == (8, 32, 32, 4)
        assert np.isfinite(d["latents"]).all()
    # ~1 GB of checkpoints and Fishers: not kept with pytest's tmp dirs
    shutil.rmtree(tmp_path)


@pytest.mark.parametrize("flags,match", [
    (["--vae_ckpt", "orbax_vae_dir"], "Orbax"),
])
def test_forget_cli_refuses_what_the_port_cannot_do(flags, match):
    # a --vae_ckpt that is not a CompVis or port VAE file (an Orbax
    # directory) cannot be read
    from uurg_torch.cli import forget

    with pytest.raises(ValueError, match=match):
        forget.main([*CLI, *flags, "--n-iters", "1"])


@pytest.mark.parametrize("flags,want", [
    (["--parallelism", "pp", "--pp_microbatches", "2"],
     {"parallelism": "pp", "pp_microbatches": 2}),
    (["--parallelism", "sp"], {"parallelism": "sp", "pp_microbatches": None}),
])
def test_forget_cli_passes_pp_and_sp_to_the_runner(monkeypatch, tmp_path,
                                                   flags, want):
    """--parallelism pp|sp and --pp_microbatches reach dit_forget as the
    JAX CLI passes them (0 microbatches: None, the stage count)."""
    from uurg_torch.cli import forget
    from uurg_torch.workloads import dit_runner

    seen = {}

    def recorded(wl, model, f, r, **kw):
        seen.update(kw)

    monkeypatch.setattr(dit_runner, "dit_forget", recorded)
    forget.main([*CLI, *flags, "--n-iters", "1", "--results-dir",
                 str(tmp_path)])
    assert {k: seen[k] for k in want} == want
    assert seen["mesh"] is None


@pytest.mark.parametrize("spec,parallelism", [("data=1", "fsdp"),
                                              ("data=1,model=1", "tp"),
                                              ("stage=1", "pp")])
def test_forget_cli_on_a_one_rank_mesh(tmp_path, spec, parallelism):
    """--mesh and --parallelism fsdp, tp or pp on one rank give the
    default run's final.pt."""
    from tests.torch_parallel_ranks import one_rank_group
    from uurg_torch.cli import forget

    base = [*CLI, "--n-iters", "1", "--global-batch-size", "2",
            "--snapshot-every", "5"]
    forget.main([*base, "--results-dir", str(tmp_path / "a")])
    with one_rank_group():
        forget.main([*base, "--results-dir", str(tmp_path / "b"), "--mesh",
                     spec, "--parallelism", parallelism])
    a, b = (torch.load(tmp_path / d / "forget_0" / "final.pt",
                       weights_only=True) for d in ("a", "b"))
    for part in ("model", "ema"):
        assert a[part].keys() == b[part].keys()
        for k, v in a[part].items():
            assert torch.equal(b[part][k], v), (part, k)


def test_cli_data_and_checkpoint_tiers_refuse(tmp_path):
    # an image folder is read (tests/test_torch_vae_cli.py runs the CLIs on
    # one); here one without images and an Orbax --vae_ckpt directory raise
    from PIL import Image

    from uurg_torch.cli import dit_generate_fisher

    folder = tmp_path / "images" / "n01"
    folder.mkdir(parents=True)
    base = [*CLI, "--forget-class", "0", "--mask-path", str(tmp_path / "m"),
            "--n-iters", "1"]
    with pytest.raises(FileNotFoundError, match="no images"):
        dit_generate_fisher.main([*base, "--data-path",
                                  str(tmp_path / "images")])
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(folder / "a.png")
    with pytest.raises(ValueError, match="Orbax"):
        dit_generate_fisher.main([*base, "--data-path",
                                  str(tmp_path / "images"), "--vae_ckpt",
                                  str(tmp_path)])
    with pytest.raises(ValueError, match="Orbax"):
        dit_generate_fisher.main([*base, "--ckpt", str(tmp_path / "orbax")])
    if not torch.cuda.is_available():    # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            dit_generate_fisher.main([a for a in base
                                      if a not in ("--device", "cpu")])
