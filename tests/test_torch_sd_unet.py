"""The port's SD UNet vs the JAX package's (CPU): the same numpy-seeded
inputs and weights through both, the weights carried across with
``jax_sd_unet_params_to_torch``. The JAX tests' TINY_UNET shape at 16 x 16
latents: the T = 256 self-attention at ds 1 reaches both dispatchers (their
plain versions on the CPU), the T = 64 sites at ds 2 and cross-attention
take the plain einsum path. The weights are the JAX init plus a seeded
draw, so that every bias is non-zero and a mis-wired one shows."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from uurg_torch.io import sd_interop as TSI  # noqa: E402
from uurg_torch.io.jax_interop import (jax_sd_unet_params_to_torch,  # noqa: E402
                                       sd_unet_torch_name)
from uurg_torch.models import sd_unet as TU  # noqa: E402
from uurg_tpu.io import sd_interop as JSI  # noqa: E402
from uurg_tpu.models import sd_unet as JU  # noqa: E402

TINY = dict(model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
            attention_ds=(1, 2), num_heads=2, context_dim=16)
LATENT, CTX_LEN = 16, 8
# TINY's GroupNorms have groups of one channel (16 and 32 channels in 32
# groups, halved to fit), which remove the per-channel timestep shift that
# every residual block adds: its timestep path is invisible there (exact
# gradient zero). WIDE (64 channels: groups of 2 and 4) carries it.
WIDE = dict(model_channels=64, channel_mult=(1,), num_res_blocks=1,
            attention_ds=(), num_heads=2, context_dim=16)
WIDE_LATENT = 8
TIME_PATH = ("time_embed_", ".emb_proj.")
# fp32 on both sides: LayerNorm's two-pass variance (torch) against
# E[x^2] - E[x]^2 (flax), sums in another order
F32_REL = 1e-5
GRAD_REL = 1e-4
# bf16 compute: one to two bf16 roundings (2**-8) a layer. On these
# perturbed weights JAX's own bf16 forward lies 1.7-2.2e-2 from its float32
# forward (the port's 1.7-1.8e-2), each in its own rounding order: the port
# must be as close to float32 as JAX is (BF16_SLACK) and the two bf16
# forwards within two such distances of each other
BF16_REL, BF16_SLACK = 3e-2, 1.25
METHODS = ("full", "noxattn", "selfattn", "xattn", "notime", "xlayer",
           "selflayer")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads while this file runs (several xdist workers
    share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def perturb(params, seed: int = 0):
    """The JAX params plus a seeded normal draw: kernels by 0.5 /
    sqrt(fan_in), vectors by 0.05."""
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a, np.float32)
        std = 0.5 / np.sqrt(np.prod(a.shape[:-1])) if a.ndim >= 2 else 0.05
        return a + (rng.standard_normal(a.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map(one, params)


def jax_unet_params(shape: dict, seed: int = 0, perturb_seed: int = 0):
    """Flax params of the JAX SDUNet of ``shape``: the port's seeded init
    carried over by both packages' CompVis maps
    (``torch_unet_to_compvis``, then the JAX ``compvis_unet_to_flax``; the
    JAX init's jitted trace costs ~14 s on the CPU), then perturbed."""
    model = TU.init_sd_unet(seed, TU.SDUNetConfig(**shape))
    return perturb(JSI.compvis_unet_to_flax(
        TSI.torch_unet_to_compvis(model, model.cfg),
        JU.SDUNetConfig(**shape)), perturb_seed)


def _jax_unet(shape: dict, latent: int):
    """(JAX model without remat, perturbed params, jitted apply)."""
    model = JU.SDUNet(JU.SDUNetConfig(**shape, dtype=jnp.float32,
                                      remat=False))
    return model, jax_unet_params(shape), jax.jit(
        lambda p, x, t, c: model.apply({"params": p}, x, t, c))


@pytest.fixture(scope="module")
def jax_unet():
    return _jax_unet(TINY, LATENT)


def port_model(params, shape: dict = TINY, **kw):
    cfg = TU.SDUNetConfig(**shape, dtype=kw.pop("dtype", torch.float32),
                          **kw)
    model = TU.SDUNet(cfg)
    model.load_state_dict(jax_sd_unet_params_to_torch(params), strict=True)
    return model


def inputs(seed: int = 1, n: int = 2, latent: int = LATENT):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, latent, latent, 4)).astype(np.float32)
    t = np.array([3, 999][:n] + [500] * max(0, n - 2), np.int32)
    ctx = rng.standard_normal((n, CTX_LEN, 16)).astype(np.float32)
    return x, t, ctx


def _t(a):
    return torch.from_numpy(np.asarray(a))


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("shape", [TINY, WIDE])
def test_parameter_names_and_shapes_match_jax(shape):
    # against the JAX init's own tree (shapes only, no compile)
    model = JU.SDUNet(JU.SDUNetConfig(**shape))
    latent = 8
    tree = jax.eval_shape(model.init, {"params": jax.random.key(0)},
                          jnp.zeros((1, latent, latent, 4)),
                          jnp.zeros((1,), jnp.int32),
                          jnp.zeros((1, CTX_LEN, 16)))["params"]
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = tuple(str(k.key) for k in path)
        shp = leaf.shape
        if keys[-1] == "kernel":
            shp = (shp[3], shp[2], *shp[:2]) if len(shp) == 4 else shp[::-1]
        want[sd_unet_torch_name(keys)] = tuple(shp)
    sd = TU.SDUNet(TU.SDUNetConfig(**shape)).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == want


def test_full_width_parameter_count():
    # the CompVis v1 UNet (configs/stable-diffusion/v1-inference.yaml)
    with torch.device("meta"):
        model = TU.SDUNet()
    assert sum(p.numel() for p in model.parameters()) == 859_520_964


def test_forward_f32_matches_jax(jax_unet):
    _, params, apply = jax_unet
    x, t, ctx = inputs()
    want = np.asarray(apply(params, x, t, ctx))
    with torch.no_grad():
        got = port_model(params)(_t(x), _t(t), _t(ctx))
    assert got.shape == (2, LATENT, LATENT, 4) and got.dtype == torch.float32
    assert rel(got.numpy(), want) <= F32_REL


def test_forward_bf16_matches_jax(jax_unet):
    # the port's bf16 forward as close to JAX's float32 forward as JAX's
    # own bf16 forward is, and within two such distances of it
    _, params, apply = jax_unet
    cfg = JU.SDUNetConfig(**TINY, dtype=jnp.bfloat16, remat=False)
    x, t, ctx = inputs(2)
    exact = np.asarray(apply(params, x, t, ctx))
    want = np.asarray(jax.jit(JU.SDUNet(cfg).apply)(
        {"params": params}, x, t, ctx), np.float32)
    with torch.no_grad():
        got = port_model(params, dtype=torch.bfloat16)(_t(x), _t(t), _t(ctx))
    assert got.dtype == torch.float32          # conv_out runs in float32
    jax_err, port_err = rel(want, exact), rel(got.numpy(), exact)
    assert jax_err <= BF16_REL and port_err <= BF16_REL
    assert port_err <= BF16_SLACK * jax_err
    assert rel(got.numpy(), want) <= 2 * jax_err


def _loss(out, w):
    return (out * w).sum()


def _grads(jax_model, shape: dict, latent: int, seed: int):
    """(port, JAX) parameter gradients of sum(eps * w), by name."""
    model_j, params, _ = jax_model
    x, t, ctx = inputs(seed, latent=latent)
    w = np.random.default_rng(seed + 1).standard_normal(
        (2, latent, latent, 4)).astype(np.float32)
    grads = jax.jit(jax.grad(lambda p: _loss(
        model_j.apply({"params": p}, x, t, ctx), w)))(params)
    model = port_model(params, shape, remat=False)
    _loss(model(_t(x), _t(t), _t(ctx)), _t(w)).backward()
    return ({k: p.grad for k, p in model.named_parameters()},
            jax_sd_unet_params_to_torch(grads))


def test_gradients_match_jax(jax_unet):
    # leaves whose exact gradient is 0 in TINY (see WIDE: the timestep path,
    # and the biases a one-channel GroupNorm group removes whole) hold
    # rounding noise on both sides; the rest agree leaf by leaf
    got, want = _grads(jax_unet, TINY, LATENT, 3)
    assert set(got) == set(want)
    total = torch.cat([g.reshape(-1) for g in want.values()]).norm()
    for k in got:
        if want[k].norm() < 1e-5 * total:
            assert any(p in k for p in TIME_PATH) or k.endswith(".bias"), k
            assert got[k].norm() < 1e-5 * total, k
            continue
        assert want[k].norm() > 0, k
        assert rel(got[k].numpy(), want[k].numpy()) <= GRAD_REL, k


def test_timestep_path_matches_jax():
    # WIDE's GroupNorm groups of 2 and 4 channels keep the timestep shift:
    # forward and every gradient, the time MLP's and emb_proj's included
    jax_model = _jax_unet(WIDE, WIDE_LATENT)
    _, params, apply = jax_model
    x, t, ctx = inputs(8, latent=WIDE_LATENT)
    model = port_model(params, WIDE)
    with torch.no_grad():
        got = model(_t(x), _t(t), _t(ctx))
        moved = model(_t(x), _t(t + 7), _t(ctx))
    assert rel(got.numpy(), np.asarray(apply(params, x, t, ctx))) <= F32_REL
    assert rel(moved.numpy(), got.numpy()) > 1e-3
    got, want = _grads(jax_model, WIDE, WIDE_LATENT, 9)
    assert any(p in k for k in got for p in TIME_PATH)
    for k in got:
        assert want[k].norm() > 0, k
        assert rel(got[k].numpy(), want[k].numpy()) <= GRAD_REL, k


def _counting_attention(monkeypatch):
    calls = []
    real = TU.attention

    def counted(q, k, v):
        calls.append(q.shape[2])
        return real(q, k, v)

    monkeypatch.setattr(TU, "attention", counted)
    return calls


@pytest.mark.parametrize("policy", TU.REMAT_POLICIES)
def test_remat_policies_equal_no_remat(jax_unet, policy, monkeypatch):
    # bit-equal, and the dispatcher (the T = 256 site only; the T = 64
    # sites take the plain path) run again in the backward: the attention
    # autograd.Function is invisible to the dots policy
    _, params, _ = jax_unet
    x, t, ctx = inputs(5)
    w = _t(np.random.default_rng(6).standard_normal(
        (2, LATENT, LATENT, 4)).astype(np.float32))
    out = {}
    for tag, kw in (("plain", dict(remat=False)),
                    ("remat", dict(remat=True, remat_policy=policy))):
        model = port_model(params, **kw)
        calls = _counting_attention(monkeypatch)
        loss = _loss(model(_t(x), _t(t), _t(ctx)), w)
        n_fwd = len(calls)
        loss.backward()
        out[tag] = (loss.detach(), [p.grad for p in model.parameters()],
                    n_fwd, len(calls), set(calls))
    assert torch.equal(out["plain"][0], out["remat"][0])
    assert all(torch.equal(a, b) for a, b in zip(out["plain"][1],
                                                 out["remat"][1]))
    # TINY: one self-attention site at ds 1 down, two up
    assert out["plain"][2:] == (3, 3, {256})
    assert out["remat"][2:] == (3, 6, {256})


def test_remat_policy_is_checked():
    with pytest.raises(ValueError, match="remat_policy"):
        TU.SDUNet(TU.SDUNetConfig(**TINY, remat_policy="attn"))


def test_context_reaches_the_output(jax_unet):
    _, params, _ = jax_unet
    model = port_model(params)
    x, t, ctx = inputs(7)
    with torch.no_grad():
        a = model(_t(x), _t(t), _t(ctx))
        b = model(_t(x), _t(t), _t(ctx) + 1.0)
    assert rel(a.numpy(), b.numpy()) > 1e-3


@pytest.mark.parametrize("method", METHODS)
def test_train_method_masks_match_jax(jax_unet, method):
    _, params, _ = jax_unet
    jmask = JU.train_method_mask(params, method)
    want = {sd_unet_torch_name(tuple(str(k.key) for k in path)):
            float(np.asarray(leaf).max())
            for path, leaf in jax.tree_util.tree_leaves_with_path(jmask)}
    model = port_model(params)
    got = TU.train_method_mask(model, method)
    leaf = TU.train_method_leaf_mask(model, method)
    assert set(got) == set(want) == set(leaf)
    for k, m in got.items():
        assert m.shape == dict(model.named_parameters())[k].shape
        assert torch.all(m == want[k]), k
        assert leaf[k] == bool(want[k]), k
    if method not in ("full", "xlayer", "selflayer"):     # TINY has no
        assert 0 < sum(leaf.values()) < len(leaf)         # blocks 4-8


def test_train_method_rejects_unknown_method(jax_unet):
    _, params, _ = jax_unet
    with pytest.raises(ValueError, match="train_method"):
        TU.train_method_mask(port_model(params), "everything")


def test_full_width_train_method_layers():
    # xlayer and selflayer name CompVis blocks that exist only at full
    # depth: output_blocks.6 / .8 (cross-attention at 32 x 32) and
    # input_blocks.4 / .7 (self-attention at 32 and 16)
    with torch.device("meta"):
        model = TU.SDUNet()
    chosen = {m: sorted({n.split(".")[0] for n, on in
                         TU.train_method_leaf_mask(model, m).items() if on})
              for m in ("xlayer", "selflayer")}
    assert chosen == {"xlayer": ["up_1_attn_0", "up_1_attn_2"],
                      "selflayer": ["down_1_attn_0", "down_2_attn_0"]}
