"""The port's classification slice vs the JAX package (CPU, fp32): the
ResNet in train and eval mode with flax's BatchNorm update, the three loss
builders, one SFR-on iteration with BatchNorm state on both sides of the
forget ``cond``, all nine unlearning methods on the host stream, the
splits and the pad-crop augmentation, the device batcher, pretraining,
``evaluate`` and ``run_comparison``, and the classifier checkpoint file.

The model is the JAX tests' tiny ResNet (stages [1, 1], width 8, 4
classes) on 8x8 images at batch 32, its weights carried across with
``jax_resnet_variables_to_torch``; data come from the same numpy seeds.
"""
import copy
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from uurg_torch.data import arrays as TA  # noqa: E402
from uurg_torch.data import splits as TSp  # noqa: E402
from uurg_torch.data.datasets import synthetic_dataset  # noqa: E402
from uurg_torch.io import checkpoint as CK  # noqa: E402
from uurg_torch.io.jax_interop import jax_resnet_variables_to_torch  # noqa: E402
from uurg_torch.models import resnet as TR  # noqa: E402
from uurg_torch.models.init import init_classifier  # noqa: E402
from uurg_torch.train.optim import cosine_annealing, make_optimizer  # noqa: E402
from uurg_torch.unlearn import protocol as TP  # noqa: E402
from uurg_torch.unlearn import sfron as TS  # noqa: E402
from uurg_torch.unlearn.methods import classification as TM  # noqa: E402
from uurg_torch.workloads import classification as TW  # noqa: E402
from uurg_tpu.data import arrays as JA  # noqa: E402
from uurg_tpu.data import splits as JSp  # noqa: E402
from uurg_tpu.models import resnet as JR  # noqa: E402
from uurg_tpu.train import cosine_annealing as j_cosine  # noqa: E402
from uurg_tpu.train import make_optimizer as j_make_optimizer  # noqa: E402
from uurg_tpu.unlearn import protocol as JP  # noqa: E402
from uurg_tpu.unlearn import sfron as JS  # noqa: E402
from uurg_tpu.unlearn.methods import classification as JM  # noqa: E402
from uurg_tpu.workloads import classification as JW  # noqa: E402

CPU = torch.device("cpu")
# fp32 on both sides; only the order of the sums differs
FWD_TOL = 1e-5
# after several optimizer steps (and the sign of adaga's ascent), rounding
# differences grow through the updates
METHOD_TOL = 1e-4
OVERRIDES = {"epochs": 1, "n_iters": 6, "forget_freq": 2, "sgda_epochs": 1,
             "msteps": 1}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs (several pytest-xdist
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_tiny():
    return JR.ResNet(stage_sizes=[1, 1], block=JR.BasicBlock, num_classes=4,
                     width=8)


def torch_tiny():
    return TR.ResNet([1, 1], TR.BasicBlock, num_classes=4, width=8)


def jax_init(seed: int):
    p, s = JR.init_classifier(jax.random.key(seed), jax_tiny(), resolution=8)
    return jax.tree_util.tree_map(np.asarray, (p, s))


def to_torch(params, batch_stats) -> torch.nn.Module:
    model = torch_tiny()
    model.load_state_dict(jax_resnet_variables_to_torch(params, batch_stats),
                          strict=True)
    return model


def rel_l2(got, want) -> float:
    got, want = (torch.from_numpy(np.array(v, np.float64))
                 for v in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def state_errors(model, params, batch_stats) -> dict:
    """Relative L2 error of the parameters, running means and running
    variances, each group concatenated."""
    want = jax_resnet_variables_to_torch(params, batch_stats)
    got = model.state_dict()
    out = {}
    for group, pick in (("params", lambda k: "running" not in k),
                        ("running_mean", lambda k: "running_mean" in k),
                        ("running_var", lambda k: "running_var" in k)):
        keys = sorted(k for k in want if pick(k))
        out[group] = rel_l2(torch.cat([got[k].reshape(-1) for k in keys]),
                            torch.cat([want[k].reshape(-1) for k in keys]))
    return out


def assert_state(model, params, batch_stats, tol, what=""):
    errs = state_errors(model, params, batch_stats)
    assert all(e <= tol for e in errs.values()), (what, errs)


def torch_grads(model) -> dict:
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def assert_grads(got: dict, jax_grads, tol):
    want = jax_resnet_variables_to_torch(jax_grads, {})
    keys = sorted(want)
    err = rel_l2(torch.cat([got[k].reshape(-1) for k in keys]),
                 torch.cat([want[k].reshape(-1) for k in keys]))
    assert err <= tol, err


@pytest.fixture(scope="module")
def init0():
    return jax_init(0)


@pytest.fixture(scope="module")
def data():
    full = synthetic_dataset(96, 8, 3, 4, seed=0)
    return full.subset(np.arange(64)), full.subset(np.arange(64, 96))


def _batch(seed: int, n: int = 32, hw: int = 8):
    rng = np.random.default_rng(seed)
    return (rng.random((n, hw, hw, 3)).astype(np.float32),
            rng.integers(0, 4, n).astype(np.int32))


# -- (a) forward, one CE step, BatchNorm running statistics -----------------

@pytest.mark.parametrize("n,hw", [(32, 8), (4, 4)])
def test_forward_and_ce_step_match_jax(init0, n, hw):
    params, bs = init0
    jcls, tcls = JW.Classifier(jax_tiny()), TW.Classifier(CPU)
    x, y = _batch(1, n, hw)
    model = to_torch(params, bs)
    tx, ty = tcls.batch(x, y)

    j_eval = jcls.eval_apply(params, bs, jnp.asarray(x))
    assert rel_l2(tcls.eval_apply(model, tx).detach(), j_eval) <= FWD_TOL

    def loss(p):
        logits, new_bs = jcls.train_apply(p, bs, jnp.asarray(x))
        return JW.cross_entropy(logits, jnp.asarray(y)), (logits, new_bs)

    (j_loss, (j_logits, j_bs)), j_grads = jax.value_and_grad(
        loss, has_aux=True)(params)
    t_logits = tcls.train_apply(model, tx)
    t_loss = TW.cross_entropy(t_logits, ty)
    t_loss.backward()
    assert rel_l2(t_logits.detach(), j_logits) <= FWD_TOL
    assert abs(t_loss.item() - float(j_loss)) <= FWD_TOL * abs(float(j_loss))
    assert_grads(torch_grads(model), j_grads, FWD_TOL)
    assert_state(model, params, j_bs, FWD_TOL)


def test_running_var_is_flax_biased_update(init0):
    """At batch 4 on 4x4 images a BatchNorm sees n = 64 values a channel
    (16 after the stride-2 stage): the stock layer's unbiased running
    variance misses flax's by 1.6-6% of the batch term, far outside the
    tolerance the port's layer meets."""
    params, bs = init0
    x, _ = _batch(2, 4, 4)
    _, j_bs = JW.Classifier(jax_tiny()).train_apply(params, bs,
                                                    jnp.asarray(x))
    model = to_torch(params, bs)
    stock = copy.deepcopy(model)
    for mod in stock.modules():
        if isinstance(mod, TR.BatchNorm2d):
            mod.__class__ = torch.nn.BatchNorm2d
    tx = torch.from_numpy(x)
    for m in (model, stock):
        with torch.no_grad():
            TW.Classifier.train_apply(m, tx)
    assert state_errors(model, params, j_bs)["running_var"] <= FWD_TOL
    assert state_errors(stock, params, j_bs)["running_var"] > 100 * FWD_TOL
    # eval mode reads the statistics and leaves them
    before = copy.deepcopy(model.state_dict())
    with torch.no_grad():
        TW.Classifier.eval_apply(model, tx)
    assert all(torch.equal(before[k], v)
               for k, v in model.state_dict().items())


# -- (b) the three loss builders -------------------------------------------

@pytest.mark.parametrize("name", ["ce", "neg_adaga", "neg_ce"])
def test_loss_builders_match_jax(init0, name):
    params, bs = init0
    jcls, tcls = JW.Classifier(jax_tiny()), TW.Classifier(CPU)
    builders = {"ce": lambda c: c.ce_loss_fn(),
                "neg_adaga": lambda c: c.neg_adaptive_ce_loss_fn(0.5),
                "neg_ce": lambda c: c.neg_ce_loss_fn()}
    x, y = _batch(3)
    (j_loss, j_bs), j_grads = jax.value_and_grad(
        builders[name](jcls), has_aux=True)(
        params, bs, (jnp.asarray(x), jnp.asarray(y)), None)
    model = to_torch(params, bs)
    t_loss = builders[name](tcls)(model, tcls.batch(x, y), None)
    t_loss.backward()
    assert abs(t_loss.item() - float(j_loss)) <= FWD_TOL * abs(float(j_loss))
    assert_grads(torch_grads(model), j_grads, FWD_TOL)
    assert_state(model, params, j_bs, FWD_TOL)


# -- (c) one SFR-on iteration with BatchNorm state --------------------------

def test_sfron_step_with_model_state_matches_jax(init0):
    """forget_freq 2 under a random mask: step 0 runs the forget phase
    (BatchNorm statistics move in both phases), step 1 skips it."""
    params, bs = init0
    jcls, tcls = JW.Classifier(jax_tiny()), TW.Classifier(CPU)
    rng = np.random.default_rng(4)
    j_mask = jax.tree_util.tree_map(
        lambda p: (rng.random(p.shape) < 0.5).astype(np.float32), params)
    t_mask = {k: v.bool() for k, v in
              jax_resnet_variables_to_torch(j_mask, {}).items()}
    kw = dict(n_iters=6, forget_alpha=25.0, forget_freq=2, forget_clip=7.0,
              remain_clip=None, fast_slow_beta=1.0)
    j_opt = j_make_optimizer("sgd", 0.01, momentum=0.9, weight_decay=5e-4)
    j_step = JS.make_sfron_step(
        JS.SFRonConfig(**kw), j_opt, jcls.neg_adaptive_ce_loss_fn(0.5),
        jcls.ce_loss_fn(), lr_schedule=j_cosine(0.01, 6), donate=False,
        has_model_state=True)
    j_state = JS.init_state(jax.tree_util.tree_map(jnp.asarray, params),
                            j_opt, model_state=bs, mask=j_mask)
    model = to_torch(params, bs)
    t_opt = make_optimizer("sgd", model.parameters(), 0.01, momentum=0.9,
                           weight_decay=5e-4)
    t_step = TS.make_sfron_step(
        TS.SFRonConfig(**kw), tcls.neg_adaptive_ce_loss_fn(0.5),
        tcls.ce_loss_fn(), lr_schedule=cosine_annealing(0.01, 6))
    t_state = TS.init_state(model, t_opt, mask=t_mask)
    for step in range(2):
        fb, rb = _batch(10 + step), _batch(20 + step)
        j_state, j_m = j_step(j_state, tuple(map(jnp.asarray, fb)),
                              tuple(map(jnp.asarray, rb)), jax.random.key(0))
        t_m = t_step(t_state, tcls.batch(*fb), tcls.batch(*rb), None)
        for k in ("forget_loss", "remain_loss"):
            assert abs(float(t_m[k]) - float(j_m[k])) <= \
                FWD_TOL * max(abs(float(j_m[k])), 1e-6), (step, k)
        assert (float(t_m["forget_loss"]) == 0.0) == (step == 1)
        assert_state(model, j_state.params, j_state.model_state, FWD_TOL,
                     f"step {step}")


# -- (d) the nine methods ---------------------------------------------------

def _jax_aug(x, rng):
    return JA.random_flip_batch(JA.pad_crop_batch(x, 4, rng), rng)


def _torch_aug(x, rng):
    return TA.random_flip_batch(TA.pad_crop_batch(x, 4, rng), rng)


@pytest.fixture(scope="module")
def contexts(init0, data):
    """The JAX test's context (tiny model, 64 retain + 32 forget, batch 32,
    its overrides) on both sides, the host augmentation on, SFR-on on the
    host stream; ``init_fn`` carries the JAX init across."""
    params, bs = init0
    retain, forget = data
    j_retain, j_forget = (JA.ArrayDataset(d.images, d.labels)
                          for d in (retain, forget))
    j_ctx = JM.UnlearnContext(
        classifier=JW.Classifier(jax_tiny()),
        params=jax.tree_util.tree_map(jnp.asarray, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, bs),
        retain_train=j_retain, forget_train=j_forget, num_classes=4,
        batch_size=32, seed=0, transform=_jax_aug,
        init_fn=lambda k: JR.init_classifier(k, jax_tiny(), resolution=8),
        overrides={**OVERRIDES, "device_data": False})
    t_ctx = TM.UnlearnContext(
        classifier=TW.Classifier(CPU), model=to_torch(params, bs),
        retain_train=retain, forget_train=forget, num_classes=4,
        batch_size=32, seed=0, transform=_torch_aug,
        init_fn=lambda s: to_torch(*jax_init(s)),
        overrides={**OVERRIDES, "device_data": False})
    return j_ctx, t_ctx


def test_registry_has_all_nine():
    assert set(TM.unlearn_method_registry.names()) == set(
        JM.unlearn_method_registry.names())
    assert len(TM.unlearn_method_registry.names()) == 9


@pytest.mark.parametrize("name", ["Baseline", "Finetune", "Retrain",
                                  "GradAscent", "RandomLabel", "SalUn",
                                  "BadTeacher", "SCRUB", "SFRon"])
def test_method_matches_jax(contexts, name):
    j_ctx, t_ctx = contexts
    if name in ("GradAscent", "SCRUB"):
        # at their default lr (1e-4, 8e-5) one epoch moves the weights by
        # ~1e-6 / 1e-5 of their norm, which the state comparison could not
        # see
        extra = {**t_ctx.overrides, "lr": 1.0, "sgda_learning_rate": 0.01}
        j_ctx = dataclasses.replace(j_ctx, overrides=extra)
        t_ctx = dataclasses.replace(t_ctx, overrides=extra)
    before = copy.deepcopy(t_ctx.model.state_dict())
    j_params, j_bs = JM.unlearn_method_registry.get(name)(j_ctx)
    model = TM.unlearn_method_registry.get(name)(t_ctx)
    assert_state(model, j_params, j_bs, METHOD_TOL, name)
    # the context's model is left as it was
    assert all(torch.equal(before[k], v)
               for k, v in t_ctx.model.state_dict().items())
    moved = state_errors(model, *jax.tree_util.tree_map(
        np.asarray, (j_ctx.params, j_ctx.batch_stats)))
    if name == "Baseline":
        assert max(moved.values()) == 0.0
    else:
        assert moved["params"] > 1e-4, (name, moved)
    if name != "GradAscent":         # eval-mode ascent freezes the stats
        assert moved["running_var"] > 0 or name == "Baseline", name


def test_sfron_fisher_cache_tag_and_files(contexts, tmp_path):
    """The Fisher files are written under the JAX names, keyed by the tag,
    and a rerun reads them instead of recomputing."""
    _, t_ctx = contexts
    ctx = dataclasses.replace(t_ctx, save_path=str(tmp_path),
                              overrides={**t_ctx.overrides, "n_iters": 2})
    first = TM.unlearn_method_registry.get("SFRon")(ctx)
    tag = TM._fisher_cache_tag(ctx)
    assert (tmp_path / f"forget_fisher_{tag}").is_file()
    assert (tmp_path / f"remain_fisher_{tag}").is_file()
    other = dataclasses.replace(ctx, seed=1)
    assert TM._fisher_cache_tag(other) != tag

    def boom(*a, **k):
        raise AssertionError("the Fisher was recomputed")

    orig = TM.accumulate_fisher
    TM.accumulate_fisher = boom
    try:
        again = TM.unlearn_method_registry.get("SFRon")(ctx)
    finally:
        TM.accumulate_fisher = orig
    for k, v in first.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k


# -- (e) splits and augmentation ------------------------------------------

def test_splits_and_pad_crop_bit_equal(tmp_path):
    ds = synthetic_dataset(101, 8, 3, 4, seed=3)
    j_ds = JA.ArrayDataset(ds.images, ds.labels)
    for (tr_, tf_), (jr, jf) in (
            (TSp.random_forget_split(ds, 0.1, 5, str(tmp_path / "t")),
             JSp.random_forget_split(j_ds, 0.1, 5, str(tmp_path / "j"))),):
        assert np.array_equal(tr_.images, jr.images)
        assert np.array_equal(tf_.labels, jf.labels)
    # the persisted indices are reused (another seed, the same split)
    again = TSp.random_forget_split(ds, 0.1, 99, str(tmp_path / "t"))
    assert np.array_equal(again[1].images, tf_.images)
    t_st = TSp.incremental_random_split(ds, 0.3, 3, 7, str(tmp_path / "ti"))
    j_st = JSp.incremental_random_split(j_ds, 0.3, 3, 7, str(tmp_path / "ji"))
    assert [len(f) for _, f in t_st] == [10, 20, 30]
    for (a, b), (c, d) in zip(t_st, j_st):
        assert np.array_equal(a.images, c.images)
        assert np.array_equal(b.labels, d.labels)
    x = np.random.default_rng(0).random((16, 8, 8, 3)).astype(np.float32)
    assert np.array_equal(
        TA.pad_crop_batch(x, 4, np.random.default_rng(1)),
        JA.pad_crop_batch(x, 4, np.random.default_rng(1)))
    assert np.array_equal(ds.images_f32(), j_ds.images_f32())
    u8 = (x * 255).astype(np.uint8)
    assert np.array_equal(TA.ArrayDataset(u8, np.zeros(16)).images_f32(),
                          JA.ArrayDataset(u8, np.zeros(16)).images_f32())


# -- (f) the device batcher on the CPU generator ---------------------------

def test_device_batcher_draws():
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 255, (6, 8, 8, 3), np.uint8))
    labels = torch.arange(6)
    gen = torch.Generator().manual_seed(3)
    x, y = TM.device_batcher(64, augment=True)((images, labels), gen)
    assert x.shape == (64, 8, 8, 3) and x.dtype == torch.float32
    assert int(y.min()) >= 0 and int(y.max()) < 6
    pad, flips, offsets = 4, 0, set()
    for b in range(64):
        src = images[y[b]].numpy().astype(np.float32) / 255.0
        found = None
        for flip in (False, True):
            sp = np.pad(src[:, ::-1] if flip else src,
                        ((pad, pad), (pad, pad), (0, 0)))
            for oy in range(2 * pad + 1):
                for ox in range(2 * pad + 1):
                    if np.array_equal(x[b].numpy(), sp[oy:oy + 8, ox:ox + 8]):
                        found = (flip, oy - pad, ox - pad)
        assert found is not None, f"sample {b} is no crop of its source"
        flips += found[0]
        offsets.add(found[1:])
    assert 16 <= flips <= 48                    # a fair coin over 64 draws
    assert all(abs(o) <= pad for off in offsets for o in off)
    assert len(offsets) > 20
    # without augmentation: the source images, uint8 / 255; float kept
    x, y = TM.device_batcher(5, augment=False)((images, labels), gen)
    assert torch.equal(x, images[y].float() / 255.0)
    xf, yf = TM.device_batcher(5, augment=False)((images.float(), labels),
                                                  gen)
    assert torch.equal(xf, images[yf].float())


# -- (g) pretrain, evaluate, run_comparison --------------------------------

@pytest.fixture(scope="module")
def pretrained(init0):
    """Two epochs of the protocol's pretrain on both sides."""
    params, bs = init0
    train = synthetic_dataset(128, 8, 3, 4, seed=5, base_seed=5,
                              noise_sigma=0.5)
    j_train = JA.ArrayDataset(train.images, train.labels)
    jp, jb = JP.pretrain(JW.Classifier(jax_tiny()),
                         jax.tree_util.tree_map(jnp.asarray, params),
                         jax.tree_util.tree_map(jnp.asarray, bs), j_train,
                         epochs=2, lr=0.05, batch_size=32, seed=0,
                         transform=_jax_aug)
    model = TP.pretrain(TW.Classifier(CPU), to_torch(params, bs), train,
                        epochs=2, lr=0.05, batch_size=32, seed=0,
                        transform=_torch_aug)
    jp, jb = jax.tree_util.tree_map(np.asarray, (jp, jb))
    return train, jp, jb, model


def test_pretrain_matches_jax(pretrained):
    _, jp, jb, model = pretrained
    assert_state(model, jp, jb, METHOD_TOL)


def _assert_rows(t_row, j_row):
    assert set(t_row) == set(j_row)
    for k, v in j_row.items():
        if k in ("method", "unlearn_time"):
            continue
        if k.startswith("svc_"):
            assert abs(t_row[k] - v) <= 0.005, (k, t_row[k], v)
        elif k == "js_div":
            assert abs(t_row[k] - v) <= 1e-6, (k, t_row[k], v)
        else:                                    # accuracies and MIA
            assert t_row[k] == pytest.approx(v, abs=1e-9), (k, t_row[k], v)


def test_evaluate_matches_jax(pretrained):
    train, jp, jb, _ = pretrained
    retain, forget = TSp.random_forget_split(train, 0.25, 0)
    test = synthetic_dataset(64, 8, 3, 4, seed=6, base_seed=5,
                             noise_sigma=0.5)
    j_sets = [JA.ArrayDataset(d.images, d.labels)
              for d in (retain, forget, test)]
    j_row = JP.evaluate(JW.Classifier(jax_tiny()), jp, jb, *j_sets,
                        batch_size=32, label_to_forget=1)
    t_row = TP.evaluate(TW.Classifier(CPU), to_torch(jp, jb), retain, forget,
                        test, batch_size=32, label_to_forget=1)
    _assert_rows(t_row, j_row)


def test_run_comparison_matches_jax(pretrained, tmp_path, monkeypatch):
    """Baseline, Retrain (from the JAX init, carried) and Finetune at one
    epoch each in class mode: the rows, the JS divergence to Retrain and
    the CSV columns. Retrain takes the pretrain recipe's lr (0.05), as
    ``main_random --compare`` passes ``--pretrain_lr`` to it: at its
    default 0.1 the JAX package's own gradients part from float64 by
    ~2e-2 on this data (the next test)."""
    train, jp, jb, model = pretrained
    test = synthetic_dataset(64, 8, 3, 4, seed=6, base_seed=5,
                             noise_sigma=0.5)
    methods = ("Baseline", "Retrain", "Finetune")
    over = {"Retrain": {"epochs": 1, "lr": 0.05}, "Finetune": {"epochs": 1}}
    j_rows = JP.run_comparison(
        jax_tiny(), JA.ArrayDataset(train.images, train.labels),
        JA.ArrayDataset(test.images, test.labels), methods=methods,
        label_to_forget=2, batch_size=32, num_classes=4,
        pretrained=tuple(jax.tree_util.tree_map(jnp.asarray, (jp, jb))),
        transform=_jax_aug, overrides=over,
        csv_path=str(tmp_path / "j.csv"))

    def carried_init(generator, fresh, resolution=32):
        # the protocol passes the data's resolution, as the JAX one does
        assert resolution == train.images.shape[1]
        fresh.load_state_dict(to_torch(*jax_init(
            generator.initial_seed())).state_dict())
        return fresh

    monkeypatch.setattr(TP, "init_classifier", carried_init)
    t_rows = TP.run_comparison(
        to_torch(jp, jb), train, test, methods=methods, label_to_forget=2,
        batch_size=32, num_classes=4, pretrained=True, transform=_torch_aug,
        overrides=over, csv_path=str(tmp_path / "t.csv"))
    for t_row, j_row in zip(t_rows, j_rows):
        _assert_rows(t_row, j_row)
    heads = [open(tmp_path / f"{s}.csv").readline() for s in "tj"]
    assert heads[0] == heads[1]


def test_retrain_parts_from_jax_only_through_flax_fast_variance(
        pretrained, monkeypatch):
    """Known difference by design. flax's BatchNorm takes the batch
    variance as E[x^2] - E[x]^2 (``use_fast_variance``); the port takes
    torch's two-pass variance. Retrain at lr 0.1 on the class split of the
    comparison's data reaches, after one SGD step, weights where the JAX
    package's fp32 gradients part from a float64 evaluation (the port's
    model in float64) by more than 1e-2, while the port's fp32 gradients
    and the JAX package's with the two-pass variance stay within 1e-4 of
    it; after one epoch the two packages' weights differ by more than
    1e-4, and with the two-pass variance they agree within the methods'
    tolerance."""
    import flax.linen as nn

    class TwoPassBatchNorm(nn.BatchNorm):
        use_fast_variance: bool = False

    train = pretrained[0]
    retain, forget = TSp.class_forget_split(train, 2)
    it = TA.infinite_batches(retain, 32, seed=0, transform=_torch_aug)
    (x0, y0), (x1, y1) = next(it), next(it)
    jcls = JW.Classifier(jax_tiny())
    opt = j_make_optimizer("sgd", 0.1, momentum=0.9, weight_decay=5e-4)
    params, bs = jax_init(0)
    carry = (jax.tree_util.tree_map(jnp.asarray, params),
             jax.tree_util.tree_map(jnp.asarray, bs), opt.init(params),
             jnp.zeros((), jnp.int32))
    carry, _ = jcls.make_train_step(opt)(
        carry, (jnp.asarray(x0), jnp.asarray(y0)), jax.random.key(0))
    p1, b1 = jax.tree_util.tree_map(np.asarray, (carry[0], carry[1]))

    def jax_grads():
        def loss(p):
            logits, _ = jcls.train_apply(p, b1, jnp.asarray(x1))
            return JW.cross_entropy(logits, jnp.asarray(y1))
        return jax_resnet_variables_to_torch(jax.grad(loss)(p1), {})

    def port_grads(dtype):
        model = TR.ResNet([1, 1], TR.BasicBlock, 4, width=8, dtype=dtype)
        model.load_state_dict(jax_resnet_variables_to_torch(p1, b1))
        model.to(dtype)
        tcls = TW.Classifier(CPU)
        xb, yb = tcls.batch(x1, y1)
        torch.nn.functional.cross_entropy(
            tcls.train_apply(model, xb), yb).backward()
        return torch_grads(model)

    def flat(g):
        return torch.cat([g[k].double().reshape(-1) for k in sorted(g)])

    truth = flat(port_grads(torch.float64))
    fast = rel_l2(flat(jax_grads()), truth)
    with monkeypatch.context() as mp:
        mp.setattr(nn, "BatchNorm", TwoPassBatchNorm)
        two_pass = rel_l2(flat(jax_grads()), truth)
    port = rel_l2(flat(port_grads(torch.float32)), truth)
    assert fast > 1e-2 and two_pass <= 1e-4 and port <= 1e-4, \
        (fast, two_pass, port)

    def run_both():
        j_ctx = JM.UnlearnContext(
            classifier=jcls, params=None, batch_stats=None,
            retain_train=JA.ArrayDataset(retain.images, retain.labels),
            forget_train=JA.ArrayDataset(forget.images, forget.labels),
            num_classes=4, batch_size=32, seed=0, transform=_jax_aug,
            init_fn=lambda k: JR.init_classifier(k, jax_tiny(), resolution=8),
            overrides={"epochs": 1})
        t_ctx = TM.UnlearnContext(
            classifier=TW.Classifier(CPU), model=None, retain_train=retain,
            forget_train=forget, num_classes=4, batch_size=32, seed=0,
            transform=_torch_aug, init_fn=lambda s: to_torch(*jax_init(s)),
            overrides={"epochs": 1})
        return state_errors(TM.retrain(t_ctx), *JM.retrain(j_ctx))

    assert run_both()["params"] > 1e-4
    monkeypatch.setattr(nn, "BatchNorm", TwoPassBatchNorm)
    assert max(run_both().values()) <= METHOD_TOL


def test_csv_merge_and_efficacy_gate_match_jax(tmp_path):
    """``_append_rows_csv`` (a later run adding columns rewrites the file
    under the merged header) and ``assert_efficacy`` (which rows pass and
    which raise) against the JAX package's."""
    first = [{"method": "Baseline", "retain_acc": 99.0}]
    second = [{"method": "SFRon", "retain_acc": 95.0, "js_div": 0.1}]
    for mod, name in ((TP, "t.csv"), (JP, "j.csv")):
        mod._append_rows_csv(str(tmp_path / name), first)
        mod._append_rows_csv(str(tmp_path / name), second)
        mod._append_rows_csv(str(tmp_path / name), first)
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()

    base = {"method": "Baseline", "forget_acc": 99.0, "retain_acc": 99.0,
            "mia": 0.6, "svc_mia_confidence": 0.2, "js_div": 0.5}
    good = {"method": "SFRon", "forget_acc": 10.0, "retain_acc": 95.0,
            "mia": 0.3, "svc_mia_confidence": 0.9, "js_div": 0.1}
    cases = [[base, good], [base, {**good, "forget_acc": 40.0}],
             [base, {**good, "retain_acc": 80.0}],
             [base, {**good, "mia": 0.7}],
             [base, {**good, "svc_mia_confidence": 0.1}],
             [base, {**good, "js_div": 0.45}],
             [{**base, "forget_acc": 50.0}, good]]
    passed = []
    for rows in cases:
        outcome = []
        for mod in (TP, JP):
            try:
                mod.assert_efficacy([dict(r) for r in rows], js_margin=0.2)
                outcome.append("pass")
            except AssertionError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], outcome
        passed.append(outcome[0] == "pass")
    assert passed == [True] + [False] * (len(cases) - 1)


# -- the classifier checkpoint file -------------------------------------------

def test_checkpoint_round_trips_a_trained_classifier(pretrained, tmp_path):
    """Parameters and BatchNorm buffers (``num_batches_tracked`` included)
    through one file; a parameter-only tree is checked against the
    parameters; a wrong model is refused."""
    _, _, _, model = pretrained
    path = str(tmp_path / "ResNet18_best")
    CK.save_checkpoint(path, model.state_dict())
    fresh = torch_tiny()
    fresh.load_state_dict(CK.restore_checkpoint(path, like=fresh))
    for k, v in model.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k
    assert int(fresh.bn1.num_batches_tracked) > 0
    names = dict(model.named_parameters())
    CK.save_checkpoint(str(tmp_path / "fisher"), names)
    CK.restore_checkpoint(str(tmp_path / "fisher"), like=names)
    with pytest.raises(ValueError, match="keys differ"):
        CK.restore_checkpoint(str(tmp_path / "fisher"), like=model)
    with pytest.raises(ValueError, match="shapes differ"):
        CK.restore_checkpoint(path, like=TR.ResNet([1, 1], TR.BasicBlock,
                                                   num_classes=5, width=8))


def test_init_classifier_is_flax_in_distribution():
    """LeCun-normal truncated at two sigma: per-layer variance 1 / fan_in
    and no draw beyond 2 sigma; BatchNorm at identity."""
    model = init_classifier(torch.Generator().manual_seed(0),
                            TR.ResNet18(10))
    again = init_classifier(torch.Generator().manual_seed(0),
                            TR.ResNet18(10))
    assert all(torch.equal(v, again.state_dict()[k])
               for k, v in model.state_dict().items())
    n = sum(p.numel() for p in model.parameters())
    assert n == 11_173_962                        # ResNet-18, CIFAR stem
    w = model.layer3[0].conv2.weight.detach()
    fan_in = w[0].numel()
    assert abs(float(w.var()) * fan_in - 1.0) < 0.02
    assert float(w.abs().max()) <= 2 * (1 / fan_in) ** 0.5 / 0.8796256610
    assert torch.equal(model.bn1.running_var, torch.ones(64))
    assert torch.count_nonzero(model.fc.bias) == 0
