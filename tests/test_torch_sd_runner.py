"""The port's SD runners vs the JAX package's (CPU, float32, TINY_UNET at
8 x 8 latents): three SGD steps of ``nsfw_removal`` (ron, the saliency
mask dense and packed, under ``train_method`` full and xattn, with the
remain gradient norms the steps report), ``train_esd`` through
``esd_batch_builder``, ``certain_label``, ``gradient_ascent`` and
``proximal_gradient`` (its prox thresholds too), and the SD Adam (bf16
first moment, ``nu_dtype``, no state for frozen parameters; against optax
on the xattn and selfattn subsets).

The JAX functions draw from their keys; each test reproduces those draws
with ``jax.random`` and injects them into the port (``SDWorkload.draw``, the
ESD builder's ``draw``). Multi-step comparisons run SGD with momentum,
swapped into both runner modules: Adam turns gradients that are zero in
exact arithmetic into +-lr moves of random sign on both sides. The JAX
UNet apply is jitted once for the module and the runners' own ``jax.jit``
is lifted while they run, so that one compile of the tiny UNet's forward
and backward serves every test."""
import contextlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tests.test_torch_sd_unet import jax_unet_params  # noqa: E402
from uurg_torch.core.tree import PackedMask  # noqa: E402
from uurg_torch.io.jax_interop import jax_sd_unet_params_to_torch  # noqa: E402
from uurg_torch.models.autoencoder_kl import VAEConfig as TVAEConfig  # noqa: E402
from uurg_torch.models.clip_text import CLIPTextConfig as TTextConfig  # noqa: E402
from uurg_torch.models.sd_unet import SDUNet, SDUNetConfig  # noqa: E402
from uurg_torch.train import optim as TO  # noqa: E402
from uurg_torch.workloads import sd_runner as TR  # noqa: E402
from uurg_torch.workloads.sd import SDWorkload  # noqa: E402
from uurg_tpu.models import autoencoder_kl as JV  # noqa: E402
from uurg_tpu.models import clip_text as JC  # noqa: E402
from uurg_tpu.models import sd_unet as JU  # noqa: E402
from uurg_tpu.train import optim as JO  # noqa: E402
from uurg_tpu.unlearn import sfron as JS  # noqa: E402
from uurg_tpu.workloads import sd as JW  # noqa: E402
from uurg_tpu.workloads import sd_runner as JR  # noqa: E402

UNET = dict(model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
            attention_ds=(1, 2), num_heads=2, context_dim=16)
TEXT = dict(vocab_size=49408, max_length=8, hidden_size=16, depth=2,
            num_heads=2)
VAE = dict(base_channels=8, channel_mult=(1, 1), num_res_blocks=1)
LATENT, B, CTX = 8, 2, (8, 16)
LR, STEPS = 1e-2, 3
# the update (params - start) held to its norm, each parameter to atol: a
# few steps of float32 gradients through the tiny UNet, each within ~1e-5
UPDATE_REL, PARAM_ATOL = 1e-3, 1e-5
# the reported remain gradient norm: float32 gradients, summed in another
# order (the UNet's gradient tolerance)
NORM_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(JAX workload with a jitted UNet apply, JAX params, port
    workload)."""
    jcfg = JU.SDUNetConfig(**UNET, dtype=jnp.float32, remat=False)
    jwl = JW.SDWorkload.build(jcfg, JV.VAEConfig(**VAE),
                              JC.CLIPTextConfig(**TEXT))
    jwl.apply_model = jax.jit(
        lambda p, z, t, c: jwl.unet.apply({"params": p}, z, t, c))
    twl = SDWorkload.build(SDUNetConfig(**UNET, dtype=torch.float32,
                                        remat=False),
                           TVAEConfig(**VAE), TTextConfig(**TEXT),
                           device="cpu")
    return jwl, jax_unet_params(UNET, perturb_seed=1), twl


@contextlib.contextmanager
def _eager_jax():
    """The ``jax.jit`` of functions defined in the JAX runner and engine
    modules lifted: their steps run op by op around the jitted UNet apply,
    whose compiles every test shares (a jitted step would compile the UNet
    again each call). Other functions (the prox, the optimizer's init)
    stay jitted."""
    real = jax.jit
    eager = (JR.__file__, JS.__file__)

    def jit(f=None, **kw):
        if f is None:
            return lambda g: jit(g, **kw)
        code = getattr(f, "__code__", None)
        return f if code and code.co_filename in eager else real(f, **kw)

    jax.jit = jit
    try:
        yield
    finally:
        jax.jit = real


def _sgd(monkeypatch):
    monkeypatch.setattr(JR, "make_optimizer",
                        lambda name, lr, **kw: JO.make_optimizer(
                            "sgd", lr, momentum=0.9))
    monkeypatch.setattr(TR, "make_optimizer",
                        lambda name, params, lr, **kw: TO.make_optimizer(
                            "sgd", params, lr, momentum=0.9))


def _model(twl, params) -> SDUNet:
    m = SDUNet(twl.unet_cfg)
    m.load_state_dict(jax_sd_unet_params_to_torch(params), strict=True)
    return m


def _jax_draw(key, z):
    """What one JAX loss term draws from its key: (t, noise)."""
    k_t, k_n = jax.random.split(key)
    return (torch.tensor(np.asarray(jax.random.randint(
        k_t, (z.shape[0],), 0, 1000))).long(),
        torch.tensor(np.asarray(jax.random.normal(k_n, z.shape,
                                                  jnp.float32))))


def _inject(monkeypatch, twl, draws):
    queue = list(draws)
    monkeypatch.setattr(twl, "draw", lambda z, gen: queue.pop(0))
    return queue


def _batches(seed, n_ctx, n=STEPS):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, LATENT, LATENT, 4)).astype(np.float32),
             *(rng.standard_normal((B, *CTX)).astype(np.float32)
               for _ in range(n_ctx))) for _ in range(n)]


def _single_loop_keys(seed, n=STEPS):
    """(k_b, k_s) of each step of the JAX ``_single_loss_loop``."""
    key, out = jax.random.key(seed), []
    for _ in range(n):
        key, k_b, k_s = jax.random.split(key, 3)
        out.append((k_b, k_s))
    return out


def _assert_same_update(model, start, want_params):
    """The port's trained model against the JAX run's params: the update
    to UPDATE_REL of its norm, each parameter to PARAM_ATOL."""
    want = jax_sd_unet_params_to_torch(want_params)
    got = dict(model.named_parameters())
    names = list(start)
    d_t = torch.cat([(got[k].detach() - start[k]).reshape(-1) for k in names])
    d_j = torch.cat([(want[k] - start[k]).reshape(-1) for k in names])
    assert d_j.norm() > 0
    assert (d_t - d_j).norm() / d_j.norm() < UPDATE_REL
    for k in names:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                   atol=PARAM_ATOL, err_msg=k)


def _start(model):
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _record_norms(monkeypatch, module, store):
    """Keep the remain gradient norm of every step the module's SFR-on
    steps report (the JAX step returns (state, metrics))."""
    real = module.make_sfron_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def run(*a):
            out = step(*a)
            metrics = out[1] if isinstance(out, tuple) else out
            store.append(float(metrics["remain_grad_norm"]))
            return out

        return run

    monkeypatch.setattr(module, "make_sfron_step", make)


@pytest.mark.parametrize("train_method", ["full", "xattn"])
def test_nsfw_removal_matches_jax(pair, monkeypatch, train_method):
    """One JAX run under a dense 0/1 mask; the port with the mask dense and
    bit-packed against it."""
    jwl, params, twl = pair
    _sgd(monkeypatch)
    norms_j = []
    _record_norms(monkeypatch, JR, norms_j)
    rng = np.random.default_rng(21)
    mask_j = jax.tree_util.tree_map(
        lambda p: (rng.random(p.shape) < 0.6).astype(np.float32), params)
    fbs, rbs = _batches(31, 2), _batches(32, 1)
    kw = dict(n_iters=STEPS, lr=LR, train_method=train_method, seed=5,
              forget_alpha=0.7, remain_alpha=1.3)
    with _eager_jax():
        want = JR.nsfw_removal(jwl, params, iter(fbs), iter(rbs),
                               saliency_mask=mask_j, **kw)
    key, draws = jax.random.key(5), []
    for i in range(STEPS):
        k_f, k_r = jax.random.split(jax.random.fold_in(key, i))
        draws += [_jax_draw(k_f, fbs[i][0]), _jax_draw(k_r, rbs[i][0])]
    mask_t = {k: v.bool() for k, v in
              jax_sd_unet_params_to_torch(mask_j).items()}
    for pack in (False, True):
        norms_t = []
        _record_norms(monkeypatch, TR, norms_t)
        queue = _inject(monkeypatch, twl, draws)
        model = _model(twl, params)
        start = _start(model)
        shots = []
        state = TR.nsfw_removal(twl, model, iter(fbs), iter(rbs),
                                saliency_mask=mask_t, pack_mask=pack,
                                snapshot_freq=2,
                                snapshot_hook=lambda m, i: shots.append(i),
                                **kw)
        assert not queue and state.step == STEPS and shots == [1]
        assert all(isinstance(m, PackedMask)
                   for m in state.mask.values()) == pack
        _assert_same_update(model, start, want)
        # the norm runs over every gradient, the frozen parameters' too
        np.testing.assert_allclose(norms_t, norms_j, rtol=NORM_REL)
        assert all(p.requires_grad for p in model.parameters())
        if train_method == "xattn":
            trained = {n for n, p in model.named_parameters()
                       if any(p is q for g in state.optimizer.param_groups
                              for q in g["params"])}
            assert trained and all(".attn2." in n for n in trained)
            for n, p in model.named_parameters():
                if n not in trained:
                    assert torch.equal(p.detach(), start[n]), n


def test_train_esd_matches_jax(pair, monkeypatch):
    jwl, params, twl = pair
    _sgd(monkeypatch)
    rng = np.random.default_rng(41)
    ctx_c, ctx_0 = (rng.standard_normal((1, *CTX)).astype(np.float32)
                    for _ in range(2))
    steps, S = 2, 4
    bkw = dict(ddim_steps=S, start_guidance=3.0, latent_size=LATENT,
               batch_size=B)
    kw = dict(n_iters=steps, lr=LR, train_method="xattn",
              negative_guidance=1.5, seed=6)
    with _eager_jax():
        builder = JR.esd_batch_builder(jwl, jnp.asarray(ctx_c),
                                       jnp.asarray(ctx_0), **bkw)
        want = JR.train_esd(jwl, params, builder, **kw)
    draws = []
    for k_b, _ in _single_loop_keys(6, steps):
        k_enc, k_t, k_code = jax.random.split(k_b, 3)
        t_enc = int(jax.random.randint(k_enc, (), 0, S))
        lo, hi = t_enc * 1000 // S, (t_enc + 1) * 1000 // S
        t = jax.random.randint(k_t, (B,), 0, hi - lo) + lo
        x_T = jax.random.normal(k_code, (B, LATENT, LATENT, 4), jnp.float32)
        draws.append((t_enc, torch.tensor(np.asarray(t)).long(),
                      torch.tensor(np.asarray(x_T))))
    model = _model(twl, params)
    start = _start(model)
    built = TR.esd_batch_builder(twl, torch.from_numpy(ctx_c),
                                 torch.from_numpy(ctx_0), **bkw)
    seen = []

    def draw(gen):
        seen.append(_start(model))        # the model the denoise will use
        return draws[len(seen) - 1]

    monkeypatch.setattr(built, "draw", draw)
    TR.train_esd(twl, model, built, **kw)
    assert len(seen) == steps
    # the second batch is denoised by the model after the first update
    assert not all(torch.equal(seen[1][k], start[k]) for k in start)
    _assert_same_update(model, start, want)
    for n, p in model.named_parameters():
        if ".attn2." not in n:
            assert torch.equal(p.detach(), start[n]), n
        assert p.requires_grad, n                  # restored after the run


def _paired(monkeypatch, twl, fbs, rbs, seed):
    """Inject the draws of a JAX single-loss loop whose loss splits its
    key into a forget and a remain term."""
    draws = []
    for i, (_, k_s) in enumerate(_single_loop_keys(seed)):
        k1, k2 = jax.random.split(k_s)
        draws += [_jax_draw(k1, fbs[i][0]), _jax_draw(k2, rbs[i][0])]
    return _inject(monkeypatch, twl, draws)


@pytest.mark.parametrize("method", ["certain_label", "gradient_ascent"])
def test_single_loss_methods_match_jax(pair, monkeypatch, method):
    jwl, params, twl = pair
    _sgd(monkeypatch)
    fbs = _batches(51, 2 if method == "certain_label" else 1)
    rbs = _batches(52, 1)
    kw = dict(n_iters=STEPS, lr=LR, remain_alpha=0.8, seed=7)
    with _eager_jax():
        want = getattr(JR, method)(jwl, params, iter(fbs), iter(rbs), **kw)
    queue = _paired(monkeypatch, twl, fbs, rbs, 7)
    model = _model(twl, params)
    start = _start(model)
    getattr(TR, method)(twl, model, iter(fbs), iter(rbs), **kw)
    assert not queue
    _assert_same_update(model, start, want)


def _record_prox(monkeypatch, wl, store, jax_side: bool):
    """Keep the threshold of every prox call: the port's prox returns it;
    the JAX one is recomputed from its input as its docstring defines it,
    the k-th largest |params - init|."""
    real = wl.make_prox_operator

    def make(init, top_ratio):
        prox = real(init, top_ratio)
        if not jax_side:
            return lambda m: store.append(float(prox(m))) or None

        def run(p):
            d = jnp.concatenate([jnp.abs(a - b).ravel() for a, b in zip(
                jax.tree_util.tree_leaves(p),
                jax.tree_util.tree_leaves(init))])
            store.append(float(jnp.sort(d)[-max(1, int(d.size * top_ratio))]))
            return prox(p)

        return run

    monkeypatch.setattr(wl, "make_prox_operator", make)


def test_proximal_gradient_matches_jax(pair, monkeypatch):
    jwl, params, twl = pair
    _sgd(monkeypatch)
    fbs, rbs = _batches(61, 1), _batches(62, 1)
    kw = dict(n_iters=STEPS, lr=LR, remain_alpha=0.9, top_ratio=0.05,
              seed=8)
    th_j, th_t = [], []
    _record_prox(monkeypatch, jwl, th_j, True)
    _record_prox(monkeypatch, twl, th_t, False)
    with _eager_jax():
        want = JR.proximal_gradient(jwl, params, iter(fbs), iter(rbs), **kw)
    _paired(monkeypatch, twl, fbs, rbs, 8)
    model = _model(twl, params)
    start = _start(model)
    TR.proximal_gradient(twl, model, iter(fbs), iter(rbs), **kw)
    assert len(th_t) == len(th_j) == STEPS and min(th_j) > 0
    # the thresholds are order statistics of the deltas, which carry the
    # update's relative error
    np.testing.assert_allclose(th_t, th_j, rtol=UPDATE_REL)
    _assert_same_update(model, start, want)
    # the prox zeroes every move below the threshold
    moved = torch.cat([(p.detach() - start[n]).reshape(-1)
                       for n, p in model.named_parameters()])
    assert 0 < int((moved != 0).sum()) <= int(0.05 * moved.numel()) + 1


@pytest.mark.parametrize("train_method,nu", [("xattn", "bf16"),
                                             ("selfattn", None)])
def test_sd_adam_matches_optax(pair, train_method, nu):
    """Two steps of the SD Adam on fixed gradients against JAX's
    ``_method_optimizer``: the first moment stored in bf16, the second in
    ``nu_dtype``, no state and no move for the frozen parameters."""
    _, params, twl = pair
    nu_t = torch.bfloat16 if nu else None
    opt_j = JR._method_optimizer(params, train_method, 1e-3,
                                 nu_dtype=jnp.bfloat16 if nu else None)
    rng = np.random.default_rng(71)
    grads = [jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        for _ in range(2)]
    state, p_j = opt_j.init(params), params
    model = _model(twl, params)
    start = _start(model)
    opt_t = TR._method_optimizer(model, train_method, 1e-3, nu_dtype=nu_t)
    named = dict(model.named_parameters())
    for g in grads:
        upd, state = opt_j.update(g, state, p_j)
        p_j = jax.tree_util.tree_map(jnp.add, p_j, upd)
        for k, v in jax_sd_unet_params_to_torch(g).items():
            named[k].grad = v
        opt_t.step()
    want = jax_sd_unet_params_to_torch(p_j)
    # float32 moment math; with nu stored in bf16, a value at a rounding
    # edge may round one bf16 step (2**-7 relative at most) the other way
    # on the other side, which moves that step's update by up to 2**-8 of
    # its ~lr size: up to 2 lr 2**-8 over two steps
    atol = 2 * 1e-3 * 2 ** -8 if nu else 1e-6
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=atol, err_msg=k)
    held = {n for n, p in named.items() if opt_t.state.get(p)}
    part = ".attn2." if train_method == "xattn" else ".attn1."
    assert held == {n for n in named if part in n}
    for n in set(named) - held:
        assert torch.equal(named[n].detach(), start[n]), n
    for n in held:
        st = opt_t.state[named[n]]
        assert st["mu"].dtype == torch.bfloat16
        assert st["nu"].dtype == (nu_t or torch.float32)


def test_sd_adam_full_holds_every_parameter(pair):
    _, params, twl = pair
    model = _model(twl, params)
    opt = TR._method_optimizer(model, "full", 1e-3)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    assert len(opt.state) == len(list(model.parameters()))
    assert all(st["mu"].dtype == torch.bfloat16
               and st["nu"].dtype == torch.float32
               for st in opt.state.values())


def test_esd_builder_draws_and_denoises_with_the_current_model(pair):
    _, params, twl = pair
    ctx = torch.randn(1, *CTX, generator=torch.Generator().manual_seed(0))
    built = TR.esd_batch_builder(twl, ctx, torch.zeros(1, *CTX),
                                 ddim_steps=5, latent_size=LATENT,
                                 batch_size=3)
    gen = torch.Generator().manual_seed(9)
    t_enc, t, x_T = built.draw(gen)
    assert 0 <= t_enc < 5 and x_T.shape == (3, LATENT, LATENT, 4)
    assert (t >= t_enc * 200).all() and (t < (t_enc + 1) * 200).all()
    a, b = _model(twl, params), _model(twl, jax_unet_params(UNET, 0, 3))
    za, ta, ca, c0 = built(a, torch.Generator().manual_seed(9))
    zb, tb, _, _ = built(b, torch.Generator().manual_seed(9))
    assert torch.equal(ta, tb) and not torch.equal(za, zb)
    assert not za.requires_grad and ca.shape == c0.shape == (3, *CTX)


@pytest.mark.parametrize("parallelism,match", [
    ("sp", "'seq' mesh axis"), ("pp", "unknown parallelism 'pp'")])
def test_nsfw_removal_needs_a_seq_axis(pair, parallelism, match):
    # JAX's ValueErrors under a mesh: sp without a 'seq' axis, and pp,
    # which the JAX runner has no branch for (ring attention on gloo
    # ranks: tests/test_torch_parallel_sp.py)
    import types

    _, params, twl = pair
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(1, 1))
    with pytest.raises(ValueError, match=match):
        TR.nsfw_removal(twl, _model(twl, params), iter([]), iter([]),
                        mesh=mesh, parallelism=parallelism)


def test_nsfw_removal_sp_without_a_mesh_runs_as_one_device(pair):
    """As in JAX, ``parallelism`` is read only under a mesh."""
    _, params, twl = pair
    rng = np.random.default_rng(4)

    def batch(n_ctx):
        return (torch.from_numpy(rng.standard_normal(
            (2, LATENT, LATENT, 4)).astype(np.float32)),
            *(torch.from_numpy(rng.standard_normal((2, *CTX))
                               .astype(np.float32)) for _ in range(n_ctx)))

    fbs, rbs = [batch(2)], [batch(1)]
    want = TR.nsfw_removal(twl, _model(twl, params), iter(fbs), iter(rbs),
                           n_iters=1, lr=1e-3, seed=1).model
    got = TR.nsfw_removal(twl, _model(twl, params), iter(fbs), iter(rbs),
                          n_iters=1, lr=1e-3, seed=1, parallelism="sp").model
    for (k, v), w in zip(got.state_dict().items(), want.state_dict().values()):
        assert torch.equal(v, w), k


@pytest.mark.parametrize("spec,parallelism", [("data=1", "dp"),
                                              ("data=1,model=1", "fsdp"),
                                              ("data=1,model=1", "tp")])
def test_nsfw_removal_on_a_one_rank_mesh_equals_the_default(pair, spec,
                                                            parallelism):
    """Two steps of the runner's own Adam under a dense mask on a one-rank
    mesh give the default run's weights bit for bit."""
    from tests.torch_parallel_ranks import one_rank_group
    from uurg_torch.parallel import make_mesh, parse_mesh_spec
    from uurg_torch.parallel.mesh import full_state_dict

    _, params, twl = pair
    fbs, rbs = _batches(41, 2, 2), _batches(42, 1, 2)
    rng = np.random.default_rng(4)
    mask = {k: torch.from_numpy(rng.random(tuple(v.shape)) < 0.6)
            for k, v in _model(twl, params).named_parameters()}
    kw = dict(n_iters=2, lr=1e-3, saliency_mask=mask, seed=7)
    want = _model(twl, params)
    TR.nsfw_removal(twl, want, iter(fbs), iter(rbs), **kw)
    with one_rank_group():
        got = _model(twl, params)
        TR.nsfw_removal(twl, got, iter(fbs), iter(rbs),
                        mesh=make_mesh(parse_mesh_spec(spec)),
                        parallelism=parallelism, **kw)
        have = full_state_dict(got)
    for k, v in want.state_dict().items():
        assert torch.equal(have[k], v), k


@pytest.mark.parametrize("remat", [False, True])
def test_nsfw_removal_fsdp_units_keep_one_devices_bits(pair, remat,
                                                       monkeypatch):
    """Under fsdp on a one-rank mesh with FSDP's floor at 64 elements (130
    parameters sharded, in the UNet's own units, nested in the recomputed
    blocks under remat) two steps give the default run's weights bit for
    bit: no unit's input feeds a skip path beside it."""
    import dataclasses

    from tests.torch_parallel_ranks import one_rank_group
    from uurg_torch.parallel import make_mesh
    from uurg_torch.parallel import mesh as M

    monkeypatch.setattr(M.shard_params_fsdp, "__defaults__", ("model", 64))
    _, params, twl = pair
    twl = dataclasses.replace(twl, unet_cfg=dataclasses.replace(
        twl.unet_cfg, remat=remat))
    fbs, rbs = _batches(41, 2, 2), _batches(42, 1, 2)
    rng = np.random.default_rng(4)
    mask = {k: torch.from_numpy(rng.random(tuple(v.shape)) < 0.6)
            for k, v in _model(twl, params).named_parameters()}
    kw = dict(n_iters=2, lr=1e-3, saliency_mask=mask, seed=7)
    want = _model(twl, params)
    TR.nsfw_removal(twl, want, iter(fbs), iter(rbs), **kw)
    with one_rank_group():
        got = _model(twl, params)
        TR.nsfw_removal(twl, got, iter(fbs), iter(rbs),
                        mesh=make_mesh({"data": 1, "model": 1}),
                        parallelism="fsdp", **kw)
        assert sum(M.is_sharded(p) for p in got.parameters()) == 130
        have = M.full_state_dict(got)
    for k, v in want.state_dict().items():
        assert torch.equal(have[k], v), k
