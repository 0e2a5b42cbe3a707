"""The chunked SFR-on scan (``uurg_torch/unlearn/sfron.py::make_sfron_scan``)
and the capture-safe optimizers it takes, on the CPU, where the scan runs
its plain loop (the card replays a CUDA graph of the same loop and
``chip_smoke.py`` holds the two equal):

- stacked chunks bit-equal to ``make_sfron_step`` called step by step
  (Adam, EMA, mask, clips; ``forget_freq`` dividing the chunk and not),
  the port's twin of ``tests/test_unlearn_engine.py::
  test_scan_chunk_matches_per_step``;
- the scan against the JAX package's ``make_sfron_scan`` on the JAX tests'
  tiny ResNet with BatchNorm state, the same stacked batches and weights;
- the resident mode, and classification's SFRon through it, bit-equal to
  the per-step loop fed the same draws;
- ``scan_chunk``'s cut against the JAX method's own;
- ``CapturableSGD`` / ``CapturableAdam`` against torch.optim's ``foreach``
  forms (the card's branch) over several steps;
- the refusals: a process group, an optimizer a graph cannot replay.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tests.test_torch_classification import (_batch, assert_state, jax_init,  # noqa: E402
                                             jax_tiny, to_torch)
from uurg_torch.core.rng import step_seed  # noqa: E402
from uurg_torch.data.datasets import synthetic_dataset  # noqa: E402
from uurg_torch.train import optim as TO  # noqa: E402
from uurg_torch.unlearn import sfron as TS  # noqa: E402
from uurg_torch.unlearn.methods import classification as TM  # noqa: E402
from uurg_torch.workloads import classification as TW  # noqa: E402
from uurg_tpu.data import arrays as JA  # noqa: E402
from uurg_tpu.train import cosine_annealing as j_cosine  # noqa: E402
from uurg_tpu.train import make_optimizer as j_make_optimizer  # noqa: E402
from uurg_tpu.unlearn import sfron as JS  # noqa: E402
from uurg_tpu.unlearn.methods import classification as JM  # noqa: E402
from uurg_tpu.workloads import classification as JW  # noqa: E402

CPU = torch.device("cpu")
# the JAX scan against the port's, both fp32 after 8 SGD steps: only the
# order of the sums (and the rounding of lr * update) differs; the tiny
# classification tests' METHOD_TOL
JAX_TOL = 1e-4
# a capture-safe optimizer against torch's foreach form over six steps:
# ``p - fl(lr * u)`` where torch rounds ``p + (-lr) * u`` once (SGD), and
# torch's capturable Adam arithmetic against its host-scalar one, each a
# rounding or two of float32 (2**-24) a step
OPT_REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs (several pytest-xdist
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class Affine(torch.nn.Module):
    """The JAX test's ``x @ w + b``, from its initial weights."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(4, 4))
        self.b = torch.nn.Parameter(torch.zeros(4))

    def forward(self, x):
        return x @ self.w + self.b


def rloss(model, batch, generator):
    x, y = batch
    return torch.mean((model(x) - y) ** 2)


def floss(model, batch, generator):
    return -rloss(model, batch, generator)


def _affine_batches(n: int):
    rng = np.random.default_rng(0)
    fb = [(torch.from_numpy(rng.standard_normal((6, 4), np.float32)),
           torch.ones(6, 4)) for _ in range(n)]
    rb = [(torch.from_numpy(rng.standard_normal((6, 4), np.float32)),
           -torch.ones(6, 4)) for _ in range(n)]
    return fb, rb


def _affine_state():
    model = Affine()
    opt = TO.make_optimizer("adam", model.parameters(), 1e-2,
                            capturable=True)
    mask = {"w": torch.rand(4, 4, generator=torch.Generator().manual_seed(1))
            < 0.5, "b": torch.ones(4, dtype=torch.bool)}
    return TS.init_state(model, opt, ema=True, mask=mask)


def _stack(batches):
    return tuple(torch.stack(leaves) for leaves in zip(*batches))


def _tensors(state) -> dict:
    """Every tensor the state carries: parameters, buffers, gradients, EMA,
    optimizer state and learning rates."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"grad.{k}": p.grad for k, p in
                state.model.named_parameters()})
    if state.ema_model is not None:
        out.update({f"ema.{k}": v for k, v in
                    state.ema_model.state_dict().items()})
    sd = state.optimizer.state_dict()
    for i, st in sd["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in st.items()
                    if torch.is_tensor(v)})
    for j, g in enumerate(state.optimizer.param_groups):
        out[f"lr.{j}"] = g["lr"]
    return out


def _assert_bits(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert a.step == b.step


@pytest.mark.parametrize("forget_freq", [2, 3])
def test_scan_chunks_equal_per_step_calls(forget_freq):
    """Two chunks of 4 against eight make_sfron_step calls, to the bit:
    Adam, EMA, a mask, both clips and the cosine alpha; forget_freq 2
    divides the chunk, 3 does not (the chunks' patterns then differ)."""
    cfg = TS.SFRonConfig(n_iters=8, forget_alpha=0.5, alpha_sched="cosine",
                         forget_freq=forget_freq, forget_clip=1.0,
                         remain_clip=1.0, ema_mu=0.99)
    sched = TO.cosine_annealing(1e-2, 8)
    fb, rb = _affine_batches(8)
    one = _affine_state()
    step = TS.make_sfron_step(cfg, floss, rloss, lr_schedule=sched)
    per_step = [step(one, fb[i], rb[i], None) for i in range(8)]

    two = _affine_state()
    run = TS.make_sfron_scan(cfg, floss, rloss, 4, lr_schedule=sched)
    chunks = [run(two, _stack(fb[c * 4:c * 4 + 4]),
                  _stack(rb[c * 4:c * 4 + 4]), None) for c in range(2)]
    _assert_bits(one, two)
    assert run._pattern(4) == tuple((4 + k) % forget_freq == 0
                                    for k in range(4))
    for k in ("forget_loss", "remain_loss", "remain_grad_norm",
              "forget_alpha"):
        got = torch.cat([m[k] for m in chunks])
        assert got.shape == (8,), k
        want = torch.tensor([float(m[k]) for m in per_step])
        assert torch.equal(got, want), k
    assert all((float(m["forget_loss"]) != 0.0) == (i % forget_freq == 0)
               for i, m in enumerate(per_step))


def test_scan_matches_jax_scan_on_tiny_resnet():
    """The port's scan against JAX's make_sfron_scan with BatchNorm state:
    two chunks of 4, forget every 2 under a random mask, SGD, cosine lr,
    the same stacked batches and weights."""
    params, bs = jax_init(0)
    jcls, tcls = JW.Classifier(jax_tiny()), TW.Classifier(CPU)
    rng = np.random.default_rng(4)
    j_mask = jax.tree_util.tree_map(
        lambda p: (rng.random(p.shape) < 0.5).astype(np.float32), params)
    from uurg_torch.io.jax_interop import jax_resnet_variables_to_torch

    t_mask = {k: v.bool() for k, v in
              jax_resnet_variables_to_torch(j_mask, {}).items()}
    kw = dict(n_iters=8, forget_alpha=25.0, forget_freq=2, forget_clip=7.0,
              remain_clip=None, fast_slow_beta=1.0)
    chunks = [[(_batch(10 + 4 * c + i), _batch(40 + 4 * c + i))
               for i in range(4)] for c in range(2)]

    j_opt = j_make_optimizer("sgd", 0.01, momentum=0.9, weight_decay=5e-4)
    j_run = JS.make_sfron_scan(
        JS.SFRonConfig(**kw), j_opt, jcls.neg_adaptive_ce_loss_fn(0.5),
        jcls.ce_loss_fn(), 4, lr_schedule=j_cosine(0.01, 8),
        has_model_state=True)
    j_state = JS.init_state(jax.tree_util.tree_map(jnp.asarray, params),
                            j_opt, model_state=bs, mask=j_mask)
    model = to_torch(params, bs)
    t_opt = TO.make_optimizer("sgd", model.parameters(), 0.01, momentum=0.9,
                              weight_decay=5e-4, capturable=True)
    t_run = TS.make_sfron_scan(
        TS.SFRonConfig(**kw), tcls.neg_adaptive_ce_loss_fn(0.5),
        tcls.ce_loss_fn(), 4, lr_schedule=TO.cosine_annealing(0.01, 8))
    t_state = TS.init_state(model, t_opt, mask=t_mask)
    for c, chunk in enumerate(chunks):
        stacked = [tuple(np.stack(leaves) for leaves in zip(*half))
                   for half in zip(*chunk)]
        j_state, j_m = j_run(j_state, *(tuple(map(jnp.asarray, b))
                                        for b in stacked), jax.random.key(0))
        t_m = t_run(t_state, *(tcls.batch(*b) for b in stacked), None)
        for k in ("forget_loss", "remain_loss"):
            want = np.asarray(j_m[k])
            got = t_m[k].numpy()
            assert np.allclose(got, want, rtol=JAX_TOL, atol=1e-6), (c, k)
        assert np.array_equal(t_m["forget_loss"].numpy() == 0.0,
                              np.arange(4) % 2 == 1)
        assert_state(model, j_state.params, j_state.model_state, JAX_TOL,
                     f"chunk {c}")
    assert t_state.step == int(j_state.step) == 8


def _tiny_ctx(**overrides):
    retain = synthetic_dataset(64, 8, 3, 4, seed=0)
    forget = synthetic_dataset(32, 8, 3, 4, seed=1)
    return TM.UnlearnContext(
        classifier=TW.Classifier(CPU), model=to_torch(*jax_init(0)),
        retain_train=retain, forget_train=forget, num_classes=4,
        batch_size=16, seed=3, transform=lambda x, rng: x,
        overrides={"mask": False, "forget_freq": 2, **overrides})


def _per_step_resident(ctx, n_iters: int, chunk: int):
    """The resident stream step by step: the generator seeded at each
    chunk's first step from step_seed(seed, step), each step drawing its
    forget batch, then its remain batch, into make_sfron_step."""
    cls = ctx.classifier
    model = TM._copy(ctx.model)
    opt = TO.make_optimizer("sgd", model.parameters(), 0.01, momentum=0.9,
                            weight_decay=5e-4, capturable=True)
    cfg = TS.SFRonConfig(n_iters=n_iters, forget_alpha=25.0, forget_freq=2,
                         forget_clip=7.0, remain_clip=None,
                         fast_slow_beta=1.0)
    step = TS.make_sfron_step(cfg, cls.neg_adaptive_ce_loss_fn(0.5),
                              cls.ce_loss_fn(),
                              lr_schedule=TO.cosine_annealing(0.01, n_iters))
    state = TS.init_state(model, opt)
    draw = TM.device_batcher(ctx.batch_size, augment=True)
    f, r = ((torch.as_tensor(ds.images), torch.as_tensor(ds.labels).long())
            for ds in (ctx.forget_train, ctx.retain_train))
    gen = torch.Generator()
    for i in range(n_iters):
        if i % chunk == 0:
            gen.manual_seed(step_seed(ctx.seed, i))
        step(state, draw(f, gen), draw(r, gen), gen)
    return state


def test_resident_scan_and_sfron_equal_the_per_step_stream():
    """The resident mode (chunk 3, two chunks) and classification's SFRon
    under scan_chunk 3 both equal the per-step loop fed the same draws, to
    the bit; scan_chunk 1 keeps the per-step stream, seeded every step."""
    ctx = _tiny_ctx(n_iters=6, scan_chunk=3)
    want = _per_step_resident(ctx, 6, 3)
    got = TM.unlearn_method_registry.get("SFRon")(ctx)
    for k, v in want.model.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k

    cls = ctx.classifier
    model = TM._copy(ctx.model)
    opt = TO.make_optimizer("sgd", model.parameters(), 0.01, momentum=0.9,
                            weight_decay=5e-4, capturable=True)
    state = TS.init_state(model, opt)
    cfg = TS.SFRonConfig(n_iters=6, forget_alpha=25.0, forget_freq=2,
                         forget_clip=7.0, remain_clip=None,
                         fast_slow_beta=1.0)
    run = TS.make_sfron_scan(cfg, cls.neg_adaptive_ce_loss_fn(0.5),
                             cls.ce_loss_fn(), 3,
                             device_batcher=TM.device_batcher(16),
                             lr_schedule=TO.cosine_annealing(0.01, 6),
                             seed=ctx.seed)
    f, r = ((torch.as_tensor(ds.images), torch.as_tensor(ds.labels).long())
            for ds in (ctx.forget_train, ctx.retain_train))
    gen = torch.Generator()
    for _ in range(2):
        metrics = run(state, f, r, gen)
    _assert_bits(want, state)
    assert metrics["remain_loss"].shape == (3,)

    # scan_chunk 1: the per-step stream (seeded every step), torch's SGD
    one = TM.unlearn_method_registry.get("SFRon")(
        _tiny_ctx(n_iters=6, scan_chunk=1))
    assert any(not torch.equal(one.state_dict()[k], v)
               for k, v in got.state_dict().items())


class _Stop(Exception):
    pass


@pytest.mark.parametrize("n_iters,scan_chunk", [(12, 5), (1500, 50),
                                                 (60, 50), (7, 5), (6, 1)])
def test_scan_chunk_cut_matches_jax(monkeypatch, n_iters, scan_chunk):
    """The chunk each method takes (1: the per-step path), read where it
    builds its scan or its step, for the same overrides."""
    import uurg_tpu.unlearn.sfron as j_sfron

    seen = {}

    def spy(side, scan):
        def fn(*a, **k):
            seen[side] = a[4] if side == "jax" and scan else (
                a[3] if scan else 1)
            raise _Stop
        return fn

    monkeypatch.setattr(j_sfron, "make_sfron_scan", spy("jax", True))
    monkeypatch.setattr(JM, "make_sfron_step", spy("jax", False))
    monkeypatch.setattr(TM, "make_sfron_scan", spy("torch", True))
    monkeypatch.setattr(TM, "make_sfron_step", spy("torch", False))
    over = {"n_iters": n_iters, "scan_chunk": scan_chunk}
    t_ctx = _tiny_ctx(**over)
    params, bs = jax_init(0)
    j_ctx = JM.UnlearnContext(
        classifier=JW.Classifier(jax_tiny()),
        params=jax.tree_util.tree_map(jnp.asarray, params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, bs),
        retain_train=JA.ArrayDataset(t_ctx.retain_train.images,
                                     t_ctx.retain_train.labels),
        forget_train=JA.ArrayDataset(t_ctx.forget_train.images,
                                     t_ctx.forget_train.labels),
        num_classes=4, batch_size=16, seed=3,
        overrides=dict(t_ctx.overrides))
    for fn, ctx in ((JM.unlearn_method_registry.get("SFRon"), j_ctx),
                    (TM.unlearn_method_registry.get("SFRon"), t_ctx)):
        with pytest.raises(_Stop):
            fn(ctx)
    want = scan_chunk
    while want > 1 and n_iters % want:
        want -= 1
    assert seen == {"jax": want, "torch": want}


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(momentum=0.9, weight_decay=5e-4)),
    ("sgd", dict(momentum=0.0, weight_decay=0.0)),
    ("adam", dict(weight_decay=1e-2)),
    ("adamw", dict(weight_decay=1e-2)),
])
def test_capturable_optimizers_match_torch_foreach(name, kw):
    """Six steps at a changing learning rate against torch.optim's
    ``foreach`` form, the branch the card takes; the learning rate is a
    float32 device tensor that set_lr writes in place."""
    gen = torch.Generator().manual_seed(0)
    start = [torch.randn(37, 5, generator=gen), torch.randn(11, generator=gen)]
    a = [torch.nn.Parameter(p.clone()) for p in start]
    b = [torch.nn.Parameter(p.clone()) for p in start]
    cap = TO.make_optimizer(name, a, 0.01, capturable=True, **kw)
    cls = {"sgd": torch.optim.SGD, "adam": torch.optim.Adam,
           "adamw": torch.optim.AdamW}[name]
    ref = cls(b, lr=0.01, foreach=True, **kw)
    assert TO.is_capturable(cap) and not TO.is_capturable(ref)
    lr_t = cap.param_groups[0]["lr"]
    assert lr_t.dtype == torch.float32 and lr_t.shape == ()
    for i in range(6):
        for x, y in zip(a, b):
            g = torch.randn(x.shape, generator=gen)
            x.grad, y.grad = g.clone(), g.clone()
        lr = 0.01 * (i + 1) / 3
        TO.set_lr(cap, lr if i % 2 else torch.tensor(lr))
        TO.set_lr(ref, lr)
        assert cap.param_groups[0]["lr"] is lr_t
        assert float(lr_t) == float(np.float32(lr))
        cap.step()
        ref.step()
    for x, y in zip(a, b):
        rel = float((x - y).detach().norm() / y.detach().norm())
        assert rel <= OPT_REL, (name, rel)
    if name != "sgd" or kw["momentum"]:
        moments = [v for st in cap.state.values() for k, v in st.items()
                   if k != "step"]
        assert moments and all(v.device == x.device for v in moments)


def test_refusals():
    """A process group, torch.optim's and OptaxAdam's optimizers and a
    capture-safe OptaxAdam each raise; so does a resident scan with
    gradient accumulation."""
    cfg = TS.SFRonConfig(n_iters=4, forget_alpha=0.5)
    fb, rb = _affine_batches(2)
    run = TS.make_sfron_scan(cfg, floss, rloss, 2)
    state = _affine_state()
    grouped = dataclasses.replace(state, group=object())
    with pytest.raises(ValueError, match="one device"):
        run(grouped, _stack(fb), _stack(rb), None)
    for opt in (torch.optim.SGD(state.model.parameters(), lr=0.1),
                TO.make_optimizer("adam", state.model.parameters(), 0.1,
                                  nu_dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match=type(opt).__name__):
            run(dataclasses.replace(state, optimizer=opt), _stack(fb),
                _stack(rb), None)
    with pytest.raises(ValueError, match="OptaxAdam"):
        TO.make_optimizer("adam", state.model.parameters(), 0.1,
                          amsgrad=True, capturable=True)
    with pytest.raises(ValueError, match="grad_accum"):
        TS.make_sfron_scan(dataclasses.replace(cfg, grad_accum=2), floss,
                           rloss, 2, device_batcher=TM.device_batcher(4))
    assert state.step == 0
