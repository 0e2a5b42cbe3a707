"""The port's Fisher and saliency-mask slice vs the JAX package (CPU, fp32):
the ratio and top-k masks, the Fisher loss, Fisher accumulation and the
SalUn gradient sums on the tiny CondUNet, the mask and Fisher files, and
the runner and both CLIs end to end."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from uurg_torch.core import tree as TT  # noqa: E402
from uurg_torch.core.config import load_config  # noqa: E402
from uurg_torch.io import checkpoint as CK  # noqa: E402
from uurg_torch.io.jax_interop import jax_unet_params_to_torch  # noqa: E402
from uurg_torch.models import unet_cond as TU  # noqa: E402
from uurg_torch.unlearn import fisher as TF  # noqa: E402
from uurg_torch.unlearn import saliency as TS  # noqa: E402
from uurg_torch.workloads import ddpm_runner as TR  # noqa: E402
from uurg_torch.workloads.ddpm import DDPMWorkload  # noqa: E402
from uurg_tpu.diffusion import losses as JL  # noqa: E402
from uurg_tpu.diffusion import make_schedule  # noqa: E402
from uurg_tpu.diffusion import sampling as JSamp  # noqa: E402
from uurg_tpu.models import unet_cond as JU  # noqa: E402
from uurg_tpu.unlearn import fisher as JF  # noqa: E402
from uurg_tpu.unlearn import saliency as JSal  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SFRON = os.path.join(ROOT, "configs", "cifar10_sfron.yml")
TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
            dropout=0.0, resolution=32)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs: under pytest-xdist the
    suite runs several worker processes on one host, and torch's default
    of one thread a core in each oversubscribes the cores several times
    over (a torch-heavy file ran 3-10x slower beside another one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny_config(tmp_path, **training):
    cfg = load_config(SFRON)
    model = {**cfg.model.to_dict(), "ch": 32, "ch_mult": [1, 2],
             "num_res_blocks": 1}
    train = {**cfg.training.to_dict(), "batch_size": 16, "n_iters": 2,
             "snapshot_freq": 10, "log_freq": 1, **training}
    data = {**cfg.data.to_dict(), "path": str(tmp_path / "no_cifar"),
            "synthetic_n": 64}
    return cfg.merged({"model": model, "training": train, "data": data,
                       "sampling": {"batch_size": 4}})


def _jax_tree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


# -- masks -----------------------------------------------------------------

def _fisher_pair():
    """Forget and remain Fishers with planted cases: zeros on both sides
    (ratio 1 through eps), 1e-18 entries (below eps, as the leaves whose
    exact gradient is zero give), ratios of exactly 0.5, 1 and 2, and a
    zero remain under a non-zero forget."""
    rng = np.random.default_rng(0)
    shapes = {"a": (6, 5), "b": (40,), "c": (2, 3, 4, 4)}
    f = {k: (rng.random(s) ** 4).astype(np.float32) for k, s in shapes.items()}
    r = {k: (rng.random(s) ** 4).astype(np.float32) for k, s in shapes.items()}
    f["a"][0], r["a"][0] = 0.0, 0.0
    f["a"][1], r["a"][1] = 1e-18, 3e-18
    f["a"][2], r["a"][2] = 4e-18, 1e-18
    f["b"][:10] = r["b"][:10]
    f["b"][10:20] = 2 * r["b"][10:20]
    f["b"][20:30] = 0.5 * r["b"][20:30]
    r["c"][0, 0] = 0.0
    return f, r


@pytest.mark.parametrize("threshold", [0.5, 1.0, 2.0])
def test_fisher_ratio_mask_is_bit_equal_to_jax(threshold):
    # the same fp32 arithmetic on the same trees: bits, not a tolerance
    f, r = _fisher_pair()
    want = JSal.fisher_ratio_mask(_jax_tree(f), _jax_tree(r), threshold)
    got = TS.fisher_ratio_mask({k: torch.from_numpy(v) for k, v in f.items()},
                               {k: torch.from_numpy(v) for k, v in r.items()},
                               threshold)
    for k in f:
        assert got[k].dtype == torch.bool and got[k].shape == f[k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # JAX counts in fp32, the port in float64
    assert TS.mask_sparsity(got) == pytest.approx(JSal.mask_sparsity(want),
                                                  rel=1e-6)
    floats = TS.fisher_ratio_mask(
        {k: torch.from_numpy(v) for k, v in f.items()},
        {k: torch.from_numpy(v) for k, v in r.items()}, threshold,
        dtype=torch.float32)
    assert all(torch.equal(floats[k], got[k].float()) for k in f)


def _grad_tree():
    """Gradients on a grid of 1/8 steps, signs mixed: every |g| is tied
    with many others, at whatever rank the threshold falls."""
    rng = np.random.default_rng(1)
    shapes = {"w": (7, 9), "b": (9,), "k": (3, 3, 2, 4)}
    return {k: (rng.integers(-12, 13, s) / 8).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("ratio", [0.0, 1e-9, 0.3, 0.5, 1.0])
def test_topk_saliency_mask_is_bit_equal_to_jax(ratio):
    g = _grad_tree()
    want = JSal.topk_saliency_mask(_jax_tree(g), ratio)
    got = TS.topk_saliency_mask({k: torch.from_numpy(v) for k, v in g.items()},
                                ratio)
    for k in g:
        assert got[k].dtype == torch.bool
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    total = sum(v.size for v in g.values())
    kept = TT.tree_count_nonzero(got)
    # ties at the threshold are kept: at least k, never fewer
    assert kept >= int(total * ratio)
    assert TS.mask_sparsity(got) == pytest.approx(JSal.mask_sparsity(want),
                                                  rel=1e-6)


# -- the Fisher loss and its accumulation on the tiny CondUNet --------------

@pytest.fixture(scope="module")
def tiny():
    cfg = JU.UNetConfig(dtype=jnp.float32, **TINY)
    _, params = JU.init_unet(jax.random.key(0), cfg)
    return params, JU.CondUNet(cfg)


def _port_model(params):
    model = TU.CondUNet(TU.UNetConfig(dtype=torch.float32, **TINY))
    model.load_state_dict(jax_unet_params_to_torch(params), strict=True)
    return model


def _batch(seed, n=4):
    """(x, c, t, noise) made with numpy: both packages read them."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)
    c = rng.integers(0, 10, n).astype(np.int64)
    t = rng.integers(0, 1000, n).astype(np.int64)
    noise = rng.standard_normal((n, 32, 32, 3), dtype=np.float32)
    return x, c, t, noise


def _torch_batch(b):
    return tuple(torch.from_numpy(a) for a in b)


def _jax_fisher_loss(jmodel, cond_scale):
    """The JAX workload's fisher_loss_fn at injected t and noise
    (uurg_tpu/workloads/ddpm.py:249-274)."""
    sched = make_schedule()

    def loss(params, batch, rng=None):
        x, c, t, noise = batch

        def apply_fn(x_t, t_vec, labels, keep):
            return jmodel.apply({"params": params}, x_t, t_vec, labels, keep,
                                train=False)

        eps_hat = JSamp.cfg_model_fn(apply_fn, c, cond_scale)(
            sched.q_sample(x, t, noise), t)
        return jnp.sum(jnp.square(noise - eps_hat), axis=(1, 2, 3)).mean()

    return loss


def _wl(tmp_path):
    return DDPMWorkload.from_config(_tiny_config(tmp_path), torch.float32,
                                    "cpu")


@pytest.mark.parametrize("cond_scale", [2.0, 0.0])
def test_fisher_loss_matches_jax(tiny, tmp_path, cond_scale):
    # fp32 forward of ~20 layers (the UNet test's tolerance), then a sum of
    # 3072 squares a sample
    params, jmodel = tiny
    batch = _batch(3)
    want = float(jax.jit(_jax_fisher_loss(jmodel, cond_scale))(params, batch))
    got = _wl(tmp_path).fisher_loss(_port_model(params).eval(),
                                    *_torch_batch(batch), cond_scale)
    np.testing.assert_allclose(got.item(), want, rtol=1e-4)


def _flat(tree, names):
    return torch.cat([tree[k].reshape(-1).float() for k in names])


def _hold_tree(got, want, tol):
    """Relative L2 of all leaves concatenated within ``tol``; per leaf the
    same bound on leaves above the noise floor. Leaves whose exact gradient
    is zero (conv biases before a GroupNorm, the attention k bias) hold
    only rounding noise on both sides (ratio ~1e-16 of the whole), so they
    are held by the concatenated norm alone."""
    names = list(want)
    g, w = _flat(got, names), _flat(want, names)
    assert w.norm() > 0
    assert ((g - w).norm() / w.norm()).item() <= tol
    floor = 1e-6 * w.norm()
    held = 0
    for k in names:
        wk = want[k].float()
        if wk.norm() > floor:
            held += 1
            assert ((got[k].float() - wk).norm() / wk.norm()).item() <= tol, k
    assert held > len(names) // 2


def test_accumulate_fisher_matches_jax(tiny, tmp_path):
    # three batches of 4, 4 and 3 (ragged) with injected draws. The
    # squared batch gradients agree to fp32 rounding through ~20 layers
    # (relative ~1e-5 a gradient, doubled by the square)
    params, jmodel = tiny
    batches = [_batch(10), _batch(11), _batch(12, n=3)]
    want = JF.accumulate_fisher(_jax_fisher_loss(jmodel, 2.0), params,
                                iter(batches), jax.random.key(0))
    want = jax_unet_params_to_torch(want)
    wl = _wl(tmp_path)
    model = _port_model(params).eval()

    def loss(m, b, g):
        return wl.fisher_loss(m, *b, 2.0)

    tb = [_torch_batch(b) for b in batches]
    got = TF.accumulate_fisher(loss, model, iter(tb), seed=0)
    assert list(got) == [n for n, _ in model.named_parameters()]
    assert all(v.dtype == torch.float32 for v in got.values())
    assert all(p.grad is None for p in model.parameters())   # .grad bypassed
    _hold_tree(got, want, 1e-4)
    # num_batches cuts the stream: two batches are the mean of those two
    two = TF.accumulate_fisher(loss, model, iter(tb), seed=0, num_batches=2)
    again = TF.accumulate_fisher(loss, model, iter(tb[:2]), seed=0)
    assert all(torch.equal(two[k], again[k]) for k in two)
    assert not all(torch.equal(two[k], got[k]) for k in two)
    with pytest.raises(ValueError, match="no batches"):
        TF.accumulate_fisher(loss, model, iter([]), seed=0)


def test_fisher_loss_fn_draws_per_batch_from_the_seed(tiny, tmp_path):
    # the drawn t and noise are a function of (seed, batch index) alone
    params, _ = tiny
    wl = _wl(tmp_path)
    model = _port_model(params).eval()
    x, c, _, _ = _batch(20)
    b = (torch.from_numpy(x), torch.from_numpy(c))
    fn = wl.fisher_loss_fn()
    run = [TF.accumulate_fisher(fn, model, iter([b, b]), seed=s)
           for s in (5, 5, 6)]
    assert all(torch.equal(run[0][k], run[1][k]) for k in run[0])
    assert not all(torch.equal(run[0][k], run[2][k]) for k in run[0])
    # the two batches drew differently: the mean differs from one batch's
    one = TF.accumulate_fisher(fn, model, iter([b]), seed=5)
    assert not all(torch.equal(run[0][k], one[k]) for k in one)


def test_step_seed_mixes_seed_and_step_into_the_low_bits():
    # the CPU generator keeps only the low 32 bits of its seed: every
    # (seed, step) pair must differ there, or the seed would not count
    from uurg_torch.core.rng import step_seed

    seeds = [step_seed(s, i) for s in (0, 1, 5, 1234, 2**31 + 7)
             for i in range(200)]
    assert all(0 <= x < 2**63 for x in seeds)
    assert len({x % 2**32 for x in seeds}) == len(seeds)
    assert step_seed(3, 4) == step_seed(3, 4)


def test_salun_gradient_sums_match_jax(tiny, tmp_path):
    # the JAX runner's grad_step (a sum of jax.grad of the negated eps loss
    # over the forget batches) at injected t, noise and keep; the tiny
    # model has no dropout. Same fp32 tolerance as the Fisher
    params, jmodel = tiny
    rng = np.random.default_rng(30)
    batches = [_batch(31), _batch(32)]
    keeps = [rng.random(len(b[0])) >= 0.3 for b in batches]
    sched = make_schedule()

    def neg_loss(p, b, keep):
        x, c, t, noise = b
        return -JL.noise_estimation_loss(
            lambda x_t, tv: jmodel.apply({"params": p}, x_t, tv, c, keep),
            sched, x, t, noise, keepdim=True).mean()

    grad = jax.jit(jax.grad(neg_loss))
    acc = jax.tree_util.tree_map(jnp.zeros_like, params)
    for b, keep in zip(batches, keeps):
        acc = jax.tree_util.tree_map(jnp.add, acc, grad(params, b, keep))
    want = jax_unet_params_to_torch(acc)
    wl = _wl(tmp_path)
    model = _port_model(params).train()

    def loss(m, b, g):
        x, c, t, noise, keep = b
        return -wl.per_sample_eps_loss(m, x, c, t, noise, keep, g).mean()

    tb = [_torch_batch(b) + (torch.from_numpy(k),)
          for b, k in zip(batches, keeps)]
    got = TF.sum_gradients(loss, model, iter(tb), seed=0)
    assert all(p.grad is None for p in model.parameters())
    _hold_tree(got, want, 1e-4)


# -- files ------------------------------------------------------------------

def test_mask_and_fisher_files_round_trip(tmp_path):
    model = TU.CondUNet(TU.UNetConfig(dtype=torch.float32, **TINY))
    named = dict(model.named_parameters())
    rng = np.random.default_rng(40)
    fisher = {k: torch.from_numpy(rng.random(p.shape, dtype=np.float32))
              for k, p in named.items()}
    mask = {k: v > 0.5 for k, v in fisher.items()}
    for name, tree in (("fisher", fisher), ("mask", mask),
                       ("packed", TT.pack_mask(mask))):
        path = str(tmp_path / "sub" / name)
        CK.save_checkpoint(path, tree)
        # tensors and plain containers only: the safe loader reads it
        raw = torch.load(path, weights_only=True)
        assert set(raw) == set(named)
        back = CK.restore_checkpoint(path, like=model)
        assert list(back) == list(tree)
        for k, v in tree.items():
            if name == "packed":
                assert isinstance(back[k], TT.PackedMask)
                assert back[k].shape == v.shape
                assert torch.equal(back[k].bits, v.bits)
                assert torch.equal(back[k].unpack(torch.bool), mask[k])
            else:
                assert back[k].dtype == v.dtype and torch.equal(back[k], v)
    path = str(tmp_path / "sub" / "mask")
    with pytest.raises(ValueError, match="keys"):
        CK.restore_checkpoint(path, like={k: v for k, v in
                                          list(named.items())[1:]})
    bad = dict(named)
    first = next(iter(bad))
    bad[first] = torch.zeros(3)
    with pytest.raises(ValueError, match="shapes"):
        CK.restore_checkpoint(path, like=bad)
    orbax = tmp_path / "orbax_tree"
    orbax.mkdir()
    with pytest.raises(ValueError, match="Orbax"):
        CK.restore_checkpoint(str(orbax))


# -- runner and CLIs ----------------------------------------------------------

class _Args:
    seed = 0
    ckpt_folder = None
    label_to_forget = 0
    forget_alpha = 10.0
    method = "ron"
    unlearn_loss = "adaga"


def test_sfron_forget_reads_the_mask_file(tmp_path):
    cfg = _tiny_config(tmp_path, batch_size=4)
    wl = DDPMWorkload.from_config(cfg, device="cpu")
    rng = np.random.default_rng(50)
    mask = {k: torch.from_numpy(rng.random(p.shape) < 0.5)
            for k, p in wl.init_params(_Args.seed).named_parameters()}
    path = str(tmp_path / "mask_0" / "fisher_1.0")
    CK.save_checkpoint(path, mask)

    class FromFile(_Args):
        mask_path = path

    class Packed(FromFile):
        pack_mask = True

    runs = {}
    for name, args, kw in (("given", _Args, {"mask": mask}),
                           ("file", FromFile, {}), ("packed", Packed, {})):
        runs[name] = TR.sfron_forget(args, cfg, str(tmp_path / name),
                                     device="cpu", **kw)
    assert all(v.dtype == torch.bool for v in runs["file"].mask.values())
    assert all(torch.equal(runs["file"].mask[k], mask[k]) for k in mask)
    assert all(isinstance(v, TT.PackedMask)
               for v in runs["packed"].mask.values())
    for name in ("file", "packed"):
        for a, b in zip(runs[name].model.parameters(),
                        runs["given"].model.parameters()):
            assert torch.equal(a, b), name


def test_runner_fisher_masks_and_salun_on_cpu(tmp_path, monkeypatch):
    cfg = _tiny_config(tmp_path)
    out = str(tmp_path / "mask_0")
    modes = []
    wl_model = TR.load_params

    def spy(args, config, wl, use_ema=False):
        model = wl_model(args, config, wl, use_ema)
        model.train()                 # the caller's mode, restored after
        modes.append(model)
        return model

    monkeypatch.setattr(TR, "load_params", spy)
    calls = []
    step = TF.make_fisher_batch_step

    def counting(loss_fn):
        inner = step(loss_fn)

        def run(fisher, model, batch, gen):
            calls.append((model.training, batch[0].shape[0]))
            return inner(fisher, model, batch, gen)

        return run

    monkeypatch.setattr(TF, "make_fisher_batch_step", counting)
    TR.generate_fisher(_Args, cfg, out, device="cpu")
    # synthetic_n 64: class 0 holds 11 samples, the rest 53; batch 16, the
    # last batch of each split kept ragged; every batch in eval mode
    assert calls == [(False, 11)] + [(False, 16)] * 3 + [(False, 5)]
    assert modes[-1].training
    model = modes[-1]
    fishers = [CK.restore_checkpoint(os.path.join(out, f"{n}_fisher"), model)
               for n in ("forget", "remain")]
    for f in fishers:
        flat = torch.cat([v.reshape(-1) for v in f.values()])
        assert torch.isfinite(flat).all() and (flat >= 0).all()
        assert flat.max() > 0
    masks = TR.generate_fisher_mask(out, [0.5, 1.0, 2.0], like=model,
                                    device="cpu")
    assert sorted(masks) == [0.5, 1.0, 2.0]
    for th in ("0.5", "1.0", "2.0"):
        back = CK.restore_checkpoint(os.path.join(out, f"fisher_{th}"), model)
        assert all(v.dtype == torch.bool for v in back.values())
        want = TS.fisher_ratio_mask(*fishers, float(th))
        assert all(torch.equal(back[k], want[k]) for k in want)
    # a higher threshold keeps fewer weights
    dens = [TT.tree_count_nonzero(masks[t]) for t in (0.5, 1.0, 2.0)]
    assert dens[0] >= dens[1] >= dens[2]

    salun = str(tmp_path / "salun_mask_0")
    TR.generate_salun_mask(_Args, cfg, salun, [0.3, 0.5], device="cpu")
    assert modes[-1].training                  # restored after train mode
    total = sum(p.numel() for p in model.parameters())
    for ratio in ("0.3", "0.5"):
        back = CK.restore_checkpoint(os.path.join(salun, f"with_{ratio}"),
                                     model)
        assert TT.tree_count_nonzero(back) >= int(total * float(ratio))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TR.generate_fisher_mask(out, [1.0])      # CUDA unless asked for CPU


def test_train_cli_fisher_mask_salun_and_sfron_on_cpu(tmp_path):
    pytest.importorskip("yaml")
    import yaml

    from uurg_torch.cli import train as cli

    cfg = _tiny_config(tmp_path, n_iters=1)
    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(yaml.safe_dump(cfg.to_dict()))
    folder = tmp_path / "pre"
    common = ["--config", str(cfg_path), "--exp", str(tmp_path / "exp"),
              "--device", "cpu", "--ckpt_folder", str(folder)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([a for a in common if a not in ("--device", "cpu")]
                 + ["--mode", "generate_fisher"])    # CUDA unless asked
    cli.main(common + ["--mode", "generate_fisher"])
    mask_dir = folder / "mask_0"
    assert sorted(os.listdir(mask_dir)) == ["fisher_1.0", "forget_fisher",
                                            "remain_fisher"]
    cli.main(common + ["--mode", "generate_mask"])
    assert os.listdir(folder / "salun_mask_0") == ["with_0.5"]
    cli.main(common + ["--mode", "salun", "--mask_path",
                       str(folder / "salun_mask_0" / "with_0.5")])
    cli.main(common + ["--mode", "sfron", "--mask_path",
                       str(mask_dir / "fisher_1.0")])
    runs = sorted(str(p) for p in (tmp_path / "exp").rglob("ckpt.pth"))
    assert len(runs) == 2
    assert any("salun" in r for r in runs) and any("ron_" in r for r in runs)

    # the standalone CLI re-thresholds the saved Fishers in a new process
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run(
        [sys.executable, "-m", "uurg_torch.cli.generate_fisher_mask",
         "--ckpt_folder", str(mask_dir), "--threshold", "0.25", "4.0",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "threshold 0.25 -> sparsity" in out.stderr
    assert {"fisher_0.25", "fisher_4.0"} <= set(os.listdir(mask_dir))


def test_generate_fisher_mask_cli_refuses_other_layouts(tmp_path):
    from uurg_torch.cli import generate_fisher_mask as gfm

    # the SD layout is read (tests/test_torch_sd_methods_cli.py), on the
    # card unless the CPU is asked for
    (tmp_path / "nude_forget").write_bytes(b"")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gfm.main(["--ckpt_folder", str(tmp_path)])
    with pytest.raises(SystemExit, match="no Fisher files"):
        gfm.main(["--ckpt_folder", str(tmp_path / "empty")])
    (tmp_path / "ddpm").mkdir()
    (tmp_path / "ddpm" / "forget_fisher").write_bytes(b"")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gfm.main(["--ckpt_folder", str(tmp_path / "ddpm")])  # CUDA by default
